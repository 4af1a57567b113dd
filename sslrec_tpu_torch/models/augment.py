"""Edge dropout (port of ``sslrec_tpu/models/augment.py``: ``edge_drop_mask``
and ``edge_drop``).

Dropout keeps static shapes: a 0/1 multiplier per edge instead of a smaller
edge list, so dropped edges contribute exactly zero to the propagation.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sslrec_tpu_torch.ops.spmm_kernel import CsrGraph, PrfMask, prf_mask


def edge_drop_mask(gen: torch.Generator, nnz: int, keep_rate: float,
                   resize_val: bool = False) -> torch.Tensor:
    """Bernoulli(keep_rate) edge mask ``[nnz]`` from ``gen``:
    ``floor(U + keep_rate)``, optionally rescaled by 1/keep_rate."""
    if keep_rate >= 1.0:
        return torch.ones(nnz, device=gen.device)
    keep = torch.floor(torch.rand(nnz, generator=gen, device=gen.device) + keep_rate)
    return keep / keep_rate if resize_val else keep


def edge_drop(key: torch.Tensor, g: CsrGraph, keep_rate: float,
              resize_val: bool = False,
              salts: int | Sequence[int] = 0) -> PrfMask | None:
    """Edge-dropout multiplier for :func:`ops.spmm.spmm`: the counter-mode PRF
    mask of the original edge id under ``key`` (two uint32 values), the one the
    JAX package's accelerator path uses, as a :class:`PrfMask` that B1
    evaluates inside the kernel (``.w`` materialises it).  ``salts``: an int,
    or a sequence for a leading per-view/per-layer dimension.  ``None`` when
    ``keep_rate >= 1``.
    """
    if keep_rate >= 1.0:
        return None
    return prf_mask(key, g, keep_rate, salts=salts, resize_val=resize_val)
