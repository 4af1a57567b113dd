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
