"""Weights carried across from the JAX package's parameter pytrees."""

from __future__ import annotations

import numpy as np
import torch


def lightgcn_params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX ``LightGCN.init_params`` output (numpy arrays) → a state dict for the
    port's :class:`~sslrec_tpu_torch.models.general_cf.lightgcn.LightGCN`.

    Both tables are ``[n, embedding_size]`` float32 under the same names.
    """
    out = {}
    for name in ("user_embeds", "item_embeds"):
        a = np.asarray(params[name])
        if a.ndim != 2 or a.dtype != np.float32:
            raise ValueError(f"{name}: want a 2-D float32 table, got {a.dtype} {a.shape}")
        out[name] = torch.from_numpy(a.copy())
    return out


def kgcl_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``KGCL.init_params`` output (numpy arrays) → a state dict for the
    port's :class:`~sslrec_tpu_torch.models.kg.kgcl.KGCL`.

    The nested ``rgat_fc`` becomes ``rgat_fc.w`` / ``rgat_fc.b``; ``w`` keeps
    its ``[2d, d]`` layout, since the port computes ``a_in @ w + b`` as JAX
    does.
    """
    flat = {k: params[k] for k in ("all_embed", "relation_embed", "rgat_w", "rgat_a")}
    flat.update({f"rgat_fc.{k}": params["rgat_fc"][k] for k in ("w", "b")})
    out = {}
    for name, a in flat.items():
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise ValueError(f"{name}: want float32, got {a.dtype}")
        out[name] = torch.from_numpy(a.copy())
    return out
