"""Data-handler registry: scenario type → loader (port of
``sslrec_tpu/data/registry.py``; the ``general_cf``, ``kg``, ``social``,
``sequential`` and ``multi_behavior`` scenarios, and ``multi_behavior_mf``,
a multi-behavior dataset's target behavior alone)."""

from __future__ import annotations

import importlib

_HANDLERS = {
    "general_cf": "sslrec_tpu_torch.data.general_cf",
    "kg": "sslrec_tpu_torch.data.kg",
    "social": "sslrec_tpu_torch.data.social",
    "sequential": "sslrec_tpu_torch.data.sequential",
    "multi_behavior": "sslrec_tpu_torch.data.multi_behavior",
}


def load_data(cfg, device="cpu"):
    dtype = cfg.data.type
    if dtype == "multi_behavior_mf":
        from sslrec_tpu_torch.data import multi_behavior
        return multi_behavior.load_mf(cfg, device)
    if dtype not in _HANDLERS:
        raise KeyError(f"unknown data type {dtype!r}; available: {sorted(_HANDLERS)}")
    module = importlib.import_module(_HANDLERS[dtype])
    return module.load(cfg, device)
