"""Top-k for full-sort evaluation (port of ``sslrec_tpu/ops/topk.py``).

The JAX package uses ``lax.top_k``, whose ties go to the lower index.
``torch.topk`` does not promise any order among ties, so a stable descending
sort gives the same answer as ``lax.top_k`` on every input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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


def sharded_topk(scores_local: torch.Tensor, item_offset: int, k: int, group) -> torch.Tensor:
    """Two-stage global top-k over an item-sharded score matrix (port of
    ``sharded_topk``): each rank of ``group`` holds ``scores_local`` ``[B,
    n_items/P]``, the items from ``item_offset`` on; returns the global ``[B,
    k]`` indices on every rank.  Each shard's top-k, then an ``all_gather`` of
    the ``[B, k]`` candidates in rank order, then their top-k; both stages
    keep the lower index on ties, as ``lax.top_k`` does.  A library function:
    the evaluator scores whole item tables."""
    k_local = min(k, scores_local.shape[-1])
    order = torch.sort(scores_local, dim=-1, descending=True, stable=True)
    vals, gidx = order.values[..., :k_local], order.indices[..., :k_local] + int(item_offset)
    if group is not None:
        n = dist.get_world_size(group)
        parts_v = [torch.empty_like(vals) for _ in range(n)]
        parts_i = [torch.empty_like(gidx) for _ in range(n)]
        dist.all_gather(parts_v, vals.contiguous(), group=group)
        dist.all_gather(parts_i, gidx.contiguous(), group=group)
        vals, gidx = torch.cat(parts_v, dim=-1), torch.cat(parts_i, dim=-1)
    pos = topk_indices(vals, k)
    return torch.gather(gidx, -1, pos)
