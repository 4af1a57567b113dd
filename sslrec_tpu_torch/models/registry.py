"""Model registry: name → class (port of ``sslrec_tpu/models/registry.py``,
all 31 models).  Lookup is case-insensitive."""

from __future__ import annotations

import importlib

_GENERAL_CF = "sslrec_tpu_torch.models.general_cf."
_SOCIAL = "sslrec_tpu_torch.models.social."
_KG = "sslrec_tpu_torch.models.kg."
_SEQ = "sslrec_tpu_torch.models.sequential."
_MB = "sslrec_tpu_torch.models.multi_behavior."

# name -> (module path, class name). Populated as model families land.
_REGISTRY: dict[str, tuple[str, str]] = {
    "lightgcn": (_GENERAL_CF + "lightgcn", "LightGCN"),
    "sgl": (_GENERAL_CF + "sgl", "SGL"),
    "simgcl": (_GENERAL_CF + "simgcl", "SimGCL"),
    "directau": (_GENERAL_CF + "directau", "DirectAU"),
    "ncl": (_GENERAL_CF + "ncl", "NCL"),
    "lightgcl": (_GENERAL_CF + "lightgcl", "LightGCL"),
    "hccf": (_GENERAL_CF + "hccf", "HCCF"),
    "dccf": (_GENERAL_CF + "dccf", "DCCF"),
    "autocf": (_GENERAL_CF + "autocf", "AutoCF"),
    "gformer": (_GENERAL_CF + "gformer", "GFormer"),
    "adagcl": (_GENERAL_CF + "adagcl", "AdaGCL"),
    "kgcl": (_KG + "kgcl", "KGCL"),
    "kgin": (_KG + "kgin", "KGIN"),
    "kgrec": (_KG + "kgrec", "KGRec"),
    "diffkg": (_KG + "diffkg", "DiffKG"),
    "dcrec": (_SOCIAL + "dcrec", "DcRec"),
    "mhcn": (_SOCIAL + "mhcn", "MHCN"),
    "dsl": (_SOCIAL + "dsl", "DSL"),
    "kcgn": (_SOCIAL + "kcgn", "KCGN"),
    "smin": (_SOCIAL + "smin", "SMIN"),
    "bert4rec": (_SEQ + "bert4rec", "BERT4Rec"),
    "cl4srec": (_SEQ + "cl4srec", "CL4SRec"),
    "duorec": (_SEQ + "duorec", "DuoRec"),
    "iclrec": (_SEQ + "iclrec", "ICLRec"),
    "dcrec_seq": (_SEQ + "dcrec", "DCRecSeq"),
    "maerec": (_SEQ + "maerec", "MAERec"),
    "mbgmn": (_MB + "mbgmn", "MBGMN"),
    "hmgcr": (_MB + "hmgcr", "HMGCR"),
    "smbrec": (_MB + "smbrec", "SMBRec"),
    "cml": (_MB + "cml", "CML"),
    "kmclr": (_MB + "kmclr", "KMCLR"),
}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def model_class(name: str) -> type:
    """The class of model ``name``."""
    name = name.lower()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {available_models()}")
    module_path, cls_name = _REGISTRY[name]
    return getattr(importlib.import_module(module_path), cls_name)


def build_model(cfg, data):
    """The model named by ``cfg.model.name``, with its parameters on the data's
    device, not yet initialised: call ``init_params``."""
    return model_class(cfg.model.name)(cfg, data)
