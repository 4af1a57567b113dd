"""Plain segment reductions (port of ``sslrec_tpu/ops/segment.py``).

``jax.ops.segment_*`` become ``index_add_`` / ``scatter_reduce_`` over an
unsorted id array.  These are the plain versions: the CPU path of
:mod:`sslrec_tpu_torch.ops.segment_kernel` runs them, and the tests hold the
kernels' composites to them.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids[i]=s} data[i]``; ``data`` is [n] or [n, d]."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    return s / cnt.clamp(min=1.0)[(...,) + (None,) * (data.dim() - 1)]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max_{i: ids[i]=s} data[i]``, −inf for an empty segment (as
    ``jax.ops.segment_max``); ``data`` is [n].  No gradient flows through it."""
    out = torch.full((num_segments,), float("-inf"), dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data.detach(), "amax",
                               include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within segments; ``logits`` is [n].  The
    shift is a constant: empty segments' −inf maxima become 0."""
    maxes = segment_max(logits, segment_ids, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    shifted = torch.exp(logits - maxes[segment_ids])
    denom = segment_sum(shifted, segment_ids, num_segments)
    return shifted / (denom[segment_ids] + 1e-16)
