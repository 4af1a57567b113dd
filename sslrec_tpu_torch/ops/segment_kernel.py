"""Segment ops over a constant id array: the B2 segment-max kernel's wrapper,
and the sum / gather / softmax / attention composites on B1 (port of
``sslrec_tpu/ops/pallas_segment.py``).

The JAX package padded the stable argsort of the ids into the TPU's blocked
chunks; here it is one CSR layout (:class:`SegmentLayout`), whose rows are
the sorted ids, whose columns are the original positions and whose values
are 1.  On it

    segment sum   = ``csr_spmm`` (B1, ``csrc/csr_spmm.cu``)     backward: gather ``g[ids]``
    gather x[ids] = a plain index                               backward: segment sum (B1)
    segment max   = ``csrc/segment_max.cu`` (B2)                no gradient (a softmax shift)

so a message-passing hop has no scatter in either direction.  B1's uses:
the RGAT's fused attention sum (d + 1 columns), degree counts (d = 1), the
backward of every endpoint gather, and the backward of KGCL's relation take
(:class:`OneHotTake`: ~300,000 rows into 41 segments, whose rows B1 splits
into chunks).  Dispatch as for
B1: a CPU tensor takes the plain version (:mod:`sslrec_tpu_torch.ops.segment`,
``csr_spmm_plain``), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from sslrec_tpu_torch.ops import segment as plain
from sslrec_tpu_torch.ops.cuda_build import load_kernel
from sslrec_tpu_torch.ops.spmm_kernel import (CsrLayout, PlanCache, compact, csr_layout,
                                               csr_spmm, lane_of, stable_order, vmap_lanes)


class SegmentLayout(NamedTuple):
    """Reductions over one constant id array (counterpart of
    ``BlockedSegments``): ``csr`` sums ``data[perm[j]]`` over the slots of each
    segment, ``perm`` (``csr.cols``) being the stable argsort of the ids;
    ``ids`` int32 [n] in the original order drives the gathers.  B2 gives
    each segment ``group_width`` lanes, and a whole warp to each of
    ``long_segments`` (int32), those of more than ``LONG_STRIDES ·
    group_width`` slots."""

    csr: CsrLayout
    ids: torch.Tensor
    num_segments: int
    n: int
    group_width: int
    long_segments: torch.Tensor


LONG_STRIDES = 4    # a B2 group takes a segment of at most this many strides


def segmax_group_width(lengths: np.ndarray) -> int:
    """B2's lanes per segment: a quarter of the mean segment length rounded
    up to a power of two, from 4 to 32, so a group strides a typical segment
    a few times and many segments share a warp (PERF.md has the sweep over
    widths that chose this)."""
    return _group_width_of_mean(float(np.mean(lengths)) if lengths.size else 0.0)


def _group_width_of_mean(mean: float) -> int:
    return min(32, max(4, 1 << max(0, int(np.ceil(mean / 4)) - 1).bit_length()))


def long_segments(lengths: np.ndarray, group_width: int, device="cpu") -> torch.Tensor:
    """The segments B2 gives a whole warp, int32: more than ``LONG_STRIDES``
    strides of their group."""
    longs = np.flatnonzero(lengths > LONG_STRIDES * group_width)
    return torch.from_numpy(longs.astype(np.int32)).to(device)


def build_segment_layout(segment_ids, num_segments: int, device="cpu") -> SegmentLayout:
    """Host-side build, once per constant id array (any order; sorted stably)."""
    ids = np.asarray(segment_ids.cpu() if torch.is_tensor(segment_ids) else segment_ids,
                     np.int64)
    n = ids.shape[0]
    if n and (ids.min() < 0 or ids.max() >= num_segments):
        raise ValueError(f"segment ids must lie in [0, {num_segments})")
    order = np.argsort(ids, kind="stable")
    csr = csr_layout(ids[order], order, np.ones(n, np.float32), np.arange(n),
                     num_segments, n, device)
    lengths = np.bincount(ids, minlength=num_segments)
    width = segmax_group_width(lengths)
    return SegmentLayout(csr=csr, ids=torch.from_numpy(ids.astype(np.int32)).to(device),
                         num_segments=int(num_segments), n=int(n), group_width=width,
                         long_segments=long_segments(lengths, width, device))


def segment_layout_from_ids(ids: torch.Tensor, num_segments: int) -> SegmentLayout:
    """:func:`build_segment_layout` of int ``ids`` (any order) built on their
    own device, field for field equal to the host build: a stable sort, the
    segment offsets by a search of the sorted ids, the long segments
    compacted on the device.  One host read: the number of long segments and
    the ids' range, which is checked."""
    n = ids.shape[0]
    keys, order, indptr = stable_order(ids, num_segments)
    lengths = indptr[1:] - indptr[:-1]
    # the host takes the mean of the lengths, which is n / num_segments
    width = _group_width_of_mean(n / num_segments if num_segments else 0.0)
    is_long = lengths > LONG_STRIDES * width
    n_long = 0
    if n:
        n_long, lo, hi = torch.stack([is_long.sum(), ids.min().long(),
                                      ids.max().long()]).tolist()
        if lo < 0 or hi >= num_segments:
            raise ValueError(f"segment ids must lie in [0, {num_segments})")
    csr = CsrLayout(indptr=indptr.int(), rows=keys.int(), cols=order.int(),
                    vals=torch.ones(n, dtype=torch.float32, device=ids.device),
                    edge_ids=torch.arange(n, dtype=torch.int32, device=ids.device),
                    n_rows=int(num_segments), n_cols=int(n), ids_identity=True,
                    vals_ones=True, plans=PlanCache())
    longs = compact(is_long, torch.arange(num_segments, device=ids.device), n_long)
    return SegmentLayout(csr=csr, ids=ids.int(), num_segments=int(num_segments), n=int(n),
                         group_width=width, long_segments=longs.int())


# ---------------------------------------------------------------------------
# B2: segment max
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return load_kernel("segment_max", "segment_max_f32", [p, p, p, p, i, p, i, i, i, p])


def segment_max_plain(lay: SegmentLayout, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``scatter_reduce_`` amax."""
    return plain.segment_max(data, lay.ids, lay.num_segments)


def segment_max(lay: SegmentLayout, data: torch.Tensor) -> torch.Tensor:
    """``out[s] = max_{i: ids[i]=s} data[i]``, −inf for an empty segment;
    ``data`` float32 [n].  Its input is detached: the op has no gradient, as
    ``segment_max_blocked`` (a softmax shift, where a constant is exact); a
    strided view (one head's column of ``[n, heads]`` logits) is copied.

    A CPU ``data`` takes :func:`segment_max_plain`; a CUDA ``data`` launches
    the kernel on the current stream with the layout's group width
    (``segment_max.launches`` counts those launches) or raises.
    """
    data = data.detach().contiguous()
    if data.device.type == "cpu":
        return segment_max_plain(lay, data)
    if data.device.type != "cuda":
        raise ValueError(f"segment_max: no kernel for device {data.device}")
    csr, longs = lay.csr, lay.long_segments
    if data.shape != (lay.n,) or data.dtype != torch.float32:
        raise ValueError(f"segment_max: data must be float32 [{lay.n}], "
                         f"got {data.dtype} {tuple(data.shape)}")
    for name, t in (("indptr", csr.indptr), ("perm", csr.cols), ("long_segments", longs)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != data.device:
            raise ValueError(f"segment_max: {name} must be contiguous int32 on {data.device}")
    out = torch.empty(lay.num_segments, dtype=torch.float32, device=data.device)
    if lay.num_segments == 0:
        return out
    width = lay.group_width
    err = _kernel()(csr.indptr.data_ptr(), csr.cols.data_ptr(), data.data_ptr(),
                    out.data_ptr(), lay.num_segments, longs.data_ptr(), longs.shape[0],
                    width.bit_length() - 1, LONG_STRIDES * width,
                    torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_max: launch of libsegment_max.so's kernel failed: "
                           f"cudaError {err}")
    segment_max.launches += 1
    return out


segment_max.launches = 0


# ---------------------------------------------------------------------------
# Composites on B1
# ---------------------------------------------------------------------------

def _segment_sum(lay: SegmentLayout, data: torch.Tensor) -> torch.Tensor:
    d2 = data[:, None] if data.dim() == 1 else data
    out = csr_spmm(lay.csr, d2.contiguous())
    return out[:, 0] if data.dim() == 1 else out


class SegmentSumFn(torch.autograd.Function):
    """``out[s] = Σ_{i: ids[i]=s} data[i]`` through B1; ``data`` [n] or [n, d].
    Backward: the gather ``g[ids]``, the transpose of a segment sum.  Under
    ``torch.func.vmap`` the lanes fold into the feature dimension
    (:func:`~sslrec_tpu_torch.ops.spmm_kernel.vmap_lanes`): one B1 call."""

    @staticmethod
    def forward(lay: SegmentLayout, data: torch.Tensor):
        return _segment_sum(lay, data)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ids = inputs[0].ids

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.ids]

    @staticmethod
    def vmap(info, in_dims, lay, data):
        return vmap_lanes(SegmentSumFn, info, in_dims, lay, data)


class TakeFn(torch.autograd.Function):
    """``x[ids]`` whose backward is the B1 segment sum rather than the
    scatter-add autograd derives for an index; ``x`` [num_segments, d].
    Under ``torch.func.vmap`` the lanes fold into the feature dimension, so
    the backward is one B1 call."""

    @staticmethod
    def forward(lay: SegmentLayout, x: torch.Tensor):
        return x[lay.ids]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.lay = inputs[0]

    @staticmethod
    def backward(ctx, g):
        return None, _segment_sum(ctx.lay, g)

    @staticmethod
    def vmap(info, in_dims, lay, x):
        return vmap_lanes(TakeFn, info, in_dims, lay, x)


class SegmentSoftmaxFn(torch.autograd.Function):
    """Softmax within segments, shifted by B2's max; closed-form backward
    ``s ⊙ (g − Σ_seg(g ⊙ s))``, whose only reduction is another B1 sum.
    Under ``torch.func.vmap`` each lane takes its own call: B2 reduces one
    [n] column, so the lanes' logits cannot share a launch."""

    @staticmethod
    def forward(lay: SegmentLayout, logits: torch.Tensor):
        mx = segment_max(lay, logits)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)     # empty segments
        shifted = torch.exp(logits - mx[lay.ids])
        return shifted / (_segment_sum(lay, shifted)[lay.ids] + 1e-16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.lay = inputs[0]
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        dot = _segment_sum(ctx.lay, s * g)
        return None, s * (g - dot[ctx.lay.ids])

    @staticmethod
    def vmap(info, in_dims, lay, logits):
        outs = [SegmentSoftmaxFn.apply(lay, lane_of(logits, in_dims[1], i))
                for i in range(info.batch_size)]
        return torch.stack(outs), 0


def attn_aggregate(lay: SegmentLayout, logits: torch.Tensor, values: torch.Tensor,
                   edge_mask: torch.Tensor | None = None):
    """Softmax(logits within segments) · values in ONE B1 reduction: the
    numerator and the denominator ride the same ``[n, d+1]`` sum.  Returns
    ``(aggregated [S, d], e [n])``, ``e`` the masked, unnormalised exp weights.
    Gradients reach ``logits`` and ``values``; the B2 shift is a constant."""
    mx = segment_max(lay, logits)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp(logits - mx[lay.ids])
    if edge_mask is not None:
        e = e * edge_mask
    stacked = torch.cat([values * e[:, None], e[:, None]], dim=-1)
    num_den = SegmentSumFn.apply(lay, stacked)
    return num_den[:, :-1] / (num_den[:, -1:] + 1e-16), e


class OneHotTake:
    """``table[ids]`` for a small vocabulary (port of the JAX package's
    ``OneHotTake``).  There it is a one-hot matmul, whose transpose
    ``onehotᵀ @ g`` is a scatter-free backward; here the forward is a plain
    index and the backward is :class:`TakeFn`'s: one B1 segment sum of ``g``
    over the ids' :class:`SegmentLayout`, each vocabulary row of thousands of
    ids split by B1 into chunks.  No one-hot and no scatter exist."""

    def __init__(self, ids, vocab: int, device="cpu"):
        self.layout = build_segment_layout(ids, vocab, device)

    def take(self, table: torch.Tensor) -> torch.Tensor:
        return TakeFn.apply(self.layout, table)


class SegmentOps:
    """take / sum / softmax / mean / attention bound to ONE constant id array,
    for the endpoint gathers and reductions of message passing."""

    def __init__(self, segment_ids, num_segments: int, device="cpu"):
        self.layout = build_segment_layout(segment_ids, num_segments, device)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """``x[ids]`` with a B1 segment-sum backward."""
        return TakeFn.apply(self.layout, x)

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        return SegmentSumFn.apply(self.layout, data)

    def softmax(self, logits: torch.Tensor) -> torch.Tensor:
        return SegmentSoftmaxFn.apply(self.layout, logits)

    def mean(self, data: torch.Tensor) -> torch.Tensor:
        s = self.sum(data)
        cnt = self.sum(data.new_ones(data.shape[:1]))
        return s / cnt.clamp(min=1.0)[(...,) + (None,) * (data.dim() - 1)]

    def attn(self, logits: torch.Tensor, values: torch.Tensor,
             edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Segment-softmax-weighted aggregation of ``values`` (fused)."""
        return attn_aggregate(self.layout, logits, values, edge_mask)[0]
