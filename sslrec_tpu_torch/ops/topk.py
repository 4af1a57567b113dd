"""Top-k for full-sort evaluation (port of ``sslrec_tpu/ops/topk.py``).

The JAX package uses ``lax.top_k``, whose ties go to the lower index.
``torch.topk`` does not promise any order among ties, so a stable descending
sort gives the same answer as ``lax.top_k`` on every input.
"""

from __future__ import annotations

import torch


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k column indices per row, ties broken toward the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def masked_topk_indices(scores: torch.Tensor, mask_cols: torch.Tensor,
                        mask_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k after ``scores = min(scores, -1e8)`` at per-row masked columns.

    ``mask_cols``/``mask_valid`` are ``[B, W]`` padded history columns (see
    ``PaddedRows``); padding entries change nothing.
    """
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    rows = rows.expand_as(mask_cols)[mask_valid]
    cols = mask_cols[mask_valid].long()
    masked = scores.clone()
    masked[rows, cols] = torch.clamp(masked[rows, cols], max=-1e8)
    return topk_indices(masked, k)
