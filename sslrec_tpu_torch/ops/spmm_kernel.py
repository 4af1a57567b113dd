"""CSR SpMM: host layout, the CUDA kernel's wrapper, autograd, edge-dropout PRF.

Port of ``sslrec_tpu/ops/pallas_spmm.py``.  The TPU kernel there reduced
padded edge chunks (R-row blocks, M-edge chunks) with one-hot matmuls; that
tiling is the TPU's and is dropped.  Here each propagation direction is a
plain CSR layout (:class:`CsrLayout`), and ``csrc/csr_spmm.cu`` computes the
whole operator ``out[r] = Σ_e vals[e]·w(e)·x[cols[e]]`` in one launch.

Dispatch: a tensor on the CPU goes to :func:`csr_spmm_plain`; a CUDA tensor
launches the kernel or raises.  The backward pass of every hop is the same
kernel on the transposed layout, which is always built: A need not be
symmetric.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from sslrec_tpu_torch.ops.cuda_build import load_kernel
from sslrec_tpu_torch.ops.sparse import CooGraph


class CsrLayout(NamedTuple):
    """One propagation direction: destination rows over source columns.

    ``indptr`` int32 [n_rows+1]; ``rows`` int32 [nnz] (the destination row
    of each slot, read only by the plain version); ``cols`` int32 [nnz];
    ``vals`` float32 [nnz]; ``edge_ids`` int32 [nnz], the original edge index
    of each slot, through which a per-edge multiplier held in the original
    edge order is read.
    """

    indptr: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    edge_ids: torch.Tensor
    n_rows: int
    n_cols: int


class CsrGraph(NamedTuple):
    """Forward and transposed layouts of a sparse operator A, plus its
    row-sorted COO arrays in the original edge order (for edge-weight
    gradients)."""

    fwd: CsrLayout
    bwd: CsrLayout  # Aᵀ, for dx = Aᵀ g
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def t(self) -> "CsrGraph":
        """Aᵀ, sharing the layouts; edge ids keep A's original order."""
        return CsrGraph(fwd=self.bwd, bwd=self.fwd, rows=self.cols,
                        cols=self.rows, vals=self.vals,
                        n_rows=self.n_cols, n_cols=self.n_rows)


def csr_layout(rows, cols, vals, edge_ids, n_rows, n_cols, device) -> CsrLayout:
    """Layout from host arrays already sorted by destination row."""
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return CsrLayout(indptr=t(indptr, np.int32), rows=t(rows, np.int32),
                     cols=t(cols, np.int32), vals=t(vals, np.float32),
                     edge_ids=t(edge_ids, np.int32),
                     n_rows=int(n_rows), n_cols=int(n_cols))


def build_csr_graph(g: CooGraph, device="cpu") -> CsrGraph:
    """Both layouts of ``g`` on ``device``, built on the host.

    The original edge order is ``g``'s (row-sorted, then column-sorted), so
    the forward layout's edge ids are the identity.  The transposed layout
    sorts by (col, row); its edge ids are that permutation.
    """
    rows = g.rows.cpu().numpy().astype(np.int64)
    cols = g.cols.cpu().numpy().astype(np.int64)
    vals = g.vals.cpu().numpy()
    if g.nnz and (np.diff(rows) < 0).any():
        raise ValueError("edges must be sorted by destination row")
    fwd = csr_layout(rows, cols, vals, np.arange(g.nnz), g.n_rows, g.n_cols, device)
    order = np.lexsort((rows, cols))
    bwd = csr_layout(cols[order], rows[order], vals[order], order, g.n_cols,
                     g.n_rows, device)
    return CsrGraph(fwd=fwd, bwd=bwd, rows=fwd.rows, cols=fwd.cols,
                    vals=fwd.vals, n_rows=g.n_rows, n_cols=g.n_cols)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    p = ctypes.c_void_p
    return load_kernel("csr_spmm", "csr_spmm_f32",
                       [p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, p])


def csr_spmm_plain(layout: CsrLayout, x: torch.Tensor,
                   ew: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same sum through ``index_add_``."""
    v = layout.vals if ew is None else layout.vals * ew[layout.edge_ids]
    out = torch.zeros(layout.n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, layout.rows, v[:, None] * x[layout.cols])


def _check(layout: CsrLayout, x: torch.Tensor, ew: torch.Tensor | None):
    def need(cond, what):
        if not cond:
            raise ValueError(f"csr_spmm: {what}")

    need(x.dim() == 2 and x.shape[0] == layout.n_cols,
         f"x must be [{layout.n_cols}, d], got {tuple(x.shape)}")
    need(x.dtype == torch.float32 and x.is_contiguous(), "x must be contiguous float32")
    need(layout.indptr.shape == (layout.n_rows + 1,), "indptr must be [n_rows+1]")
    nnz = layout.cols.shape[0]
    for name in ("indptr", "cols", "edge_ids"):
        t = getattr(layout, name)
        need(t.dtype == torch.int32 and t.is_contiguous(), f"{name} must be contiguous int32")
        need(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
    need(layout.vals.dtype == torch.float32 and layout.vals.is_contiguous()
         and layout.vals.shape == (nnz,), "vals must be contiguous float32 [nnz]")
    need(layout.vals.device == x.device, "vals must be on x's device")
    if ew is not None:
        need(ew.shape == (nnz,) and ew.dtype == torch.float32 and ew.is_contiguous(),
             f"edge weight must be contiguous float32 [{nnz}]")
        need(ew.device == x.device, "edge weight must be on x's device")


def csr_spmm(layout: CsrLayout, x: torch.Tensor,
             ew: torch.Tensor | None = None) -> torch.Tensor:
    """``out[r] = Σ_e vals[e]·w(e)·x[cols[e]]`` over ``layout``'s row ``r``,
    with ``w(e) = ew[edge_ids[e]]`` when ``ew`` is given, else 1.

    A CPU ``x`` takes :func:`csr_spmm_plain`; a CUDA ``x`` launches the kernel
    on the current stream (``csr_spmm.launches`` counts those launches) or
    raises.
    """
    if x.device.type == "cpu":
        return csr_spmm_plain(layout, x, ew)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm: no kernel for device {x.device}")
    _check(layout, x, ew)
    d = x.shape[1]
    out = torch.empty(layout.n_rows, d, dtype=torch.float32, device=x.device)
    if layout.n_rows == 0 or d == 0:
        return out
    eids = None if ew is None else layout.edge_ids.data_ptr()
    err = _kernel()(
        layout.indptr.data_ptr(), layout.cols.data_ptr(), layout.vals.data_ptr(),
        eids, None if ew is None else ew.data_ptr(), x.data_ptr(), out.data_ptr(),
        layout.n_rows, d, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"csr_spmm: launch of libcsr_spmm.so's kernel failed: "
                           f"cudaError {err}")
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class SpmmFn(torch.autograd.Function):
    """``A @ x`` with an optional learned per-edge weight (port of
    ``pallas_spmm``).  dx = Aᵀ(ew) g is the same kernel on the transposed
    layout; d ew[e] = vals[e]·⟨g[row_e], x[col_e]⟩ is a gather-dot in plain
    torch, computed only when the weight needs a gradient."""

    @staticmethod
    def forward(ctx, g: CsrGraph, x: torch.Tensor, ew: torch.Tensor | None):
        ctx.graph = g
        ctx.save_for_backward(x, ew)
        return csr_spmm(g.fwd, x.contiguous(), ew)

    @staticmethod
    def backward(ctx, grad):
        x, ew = ctx.saved_tensors
        g = ctx.graph
        grad = grad.contiguous()
        dx = csr_spmm(g.bwd, grad, ew) if ctx.needs_input_grad[1] else None
        dew = None
        if ew is not None and ctx.needs_input_grad[2]:
            dew = g.vals * (grad[g.rows] * x[g.cols]).sum(-1)
        return None, dx, dew


class SpmmPvFn(SpmmFn):
    """``(W∘A) @ x`` with a constant multiplier ``W`` such as a dropout mask
    (port of ``pallas_spmm_pv``): the multiplier gets no cotangent."""

    @staticmethod
    def backward(ctx, grad):
        _, dx, _ = SpmmFn.backward(ctx, grad)
        return None, dx, None


# ---------------------------------------------------------------------------
# Edge dropout from a counter-mode PRF, bit-exact with the JAX package
# ---------------------------------------------------------------------------
#
# uint32 arithmetic is held in int64 tensors, masked to 32 bits after every
# add and shift (torch's uint32 support is incomplete).

_U32 = 0xFFFFFFFF


def _rotl32(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _U32


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds, the schedule of jax.random's bit generator,
    at counter arrays ``c0``/``c1`` (int64 tensors holding uint32 values)."""
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _U32
    x1 = (c1 + ks[1]) & _U32
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _prf_uniform(key: torch.Tensor, counts: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform [0, 1) float32 at ``counts`` from a ``key`` of two uint32 values
    (an int64 tensor [2]); equal to the JAX package's ``_prf_uniform``."""
    key = key.to(device=counts.device, dtype=torch.int64)
    c0 = counts.to(torch.int64) & _U32
    c1 = torch.full_like(c0, int(salt) & _U32)
    bits, _ = _threefry2x32(key[0], key[1], c0, c1)
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


class EdgeMask(NamedTuple):
    """A constant per-edge multiplier in the original edge order (port of
    ``PaddedEdgeWeight``).  :func:`~sslrec_tpu_torch.ops.spmm.spmm` routes it
    to :class:`SpmmPvFn`, and each layout reads it through its ``edge_ids``."""

    w: torch.Tensor

    @property
    def ndim(self) -> int:
        return self.w.dim()


def dropout_mask(key: torch.Tensor, g: CsrGraph, keep_rate: float,
                 salts: int | Sequence[int] = 0,
                 resize_val: bool = False) -> EdgeMask:
    """Bernoulli(keep_rate) edge mask ``floor(U + keep_rate)`` with ``U`` the PRF
    of the original edge id (port of ``dropout_padded``).  Both layouts read
    the one mask through their edge ids, so an edge is kept or dropped alike in
    the forward and the transposed hop.  A sequence of ``salts`` stacks one
    mask per salt along a leading dimension."""
    eids = torch.arange(g.nnz, device=g.vals.device)
    kr = torch.tensor(keep_rate, dtype=torch.float32, device=eids.device)

    def one(salt):
        keep = torch.floor(_prf_uniform(key, eids, salt) + kr)
        return keep / kr if resize_val else keep

    if isinstance(salts, int):
        return EdgeMask(one(salts))
    return EdgeMask(torch.stack([one(int(s)) for s in salts]))
