"""Sparse × dense products for graph propagation (port of ``sslrec_tpu/ops/spmm.py``).

Every product goes through the CSR kernel of
:mod:`sslrec_tpu_torch.ops.spmm_kernel`; ``spmm_dense_ref`` is the dense
reference for tests.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.ops.spmm_kernel import CsrGraph, EdgeMask, PrfMask, SpmmFn, SpmmPvFn

EdgeWeight = torch.Tensor | EdgeMask | PrfMask | None


def spmm(g: CsrGraph, x: torch.Tensor, edge_weight: EdgeWeight = None) -> torch.Tensor:
    """``A @ x``; ``x`` is ``[n_cols, d]``.

    ``edge_weight``: ``None``; a ``[nnz]`` multiplier on ``g.vals`` in the
    original edge order, differentiable (learned edge gates); or a constant
    multiplier: an :class:`EdgeMask` (a materialised tensor) or a
    :class:`PrfMask` (edge dropout, evaluated inside the kernel).
    """
    if isinstance(edge_weight, EdgeMask):
        return SpmmPvFn.apply(g, x, edge_weight.w)
    if isinstance(edge_weight, PrfMask):
        return SpmmPvFn.apply(g, x, edge_weight)
    return SpmmFn.apply(g, x, edge_weight)


def _pick(edge_weight: EdgeWeight, i: int) -> EdgeWeight:
    """Index ``i`` of a multiplier's leading (view or layer) dimension."""
    if isinstance(edge_weight, (EdgeMask, PrfMask)):
        return edge_weight.layer(i)
    return edge_weight[i]


def spmm_layers(g: CsrGraph, x0: torch.Tensor, n_layers: int,
                edge_weight: EdgeWeight = None, post=None, keys=None) -> torch.Tensor:
    """``n_layers`` repeated hops ``x ← A @ x``; returns ``[n_layers, n_rows, d]``.

    ``edge_weight``: as for :func:`spmm`, the same every hop, or with a leading
    ``[n_layers]`` dimension for one multiplier per hop.  ``post``: an optional
    ``fn(keys[layer], x) -> x`` applied after each hop (SimGCL's per-layer
    noise, where ``keys`` holds each layer's draws).  The JAX package scans
    the hops so that they share one Mosaic kernel instance; here the loop is
    eager.
    """
    per_layer = edge_weight is not None and edge_weight.ndim == 2
    ys, x = [], x0
    for layer in range(n_layers):
        ew = _pick(edge_weight, layer) if per_layer else edge_weight
        x = spmm(g, x, edge_weight=ew)
        if post is not None:
            x = post(keys[layer], x)
        ys.append(x)
    return torch.stack(ys)


def spmm_views(g: CsrGraph, x0s, n_layers: int, edge_weights: EdgeWeight = None,
               post=None, keys=None) -> torch.Tensor:
    """``V`` independent :func:`spmm_layers` stacks; returns ``[V, n_layers, N, d]``.

    ``x0s``: ``[V, N, d]`` or a sequence of ``V`` ``[N, d]`` inputs;
    ``edge_weights``: ``None`` or stacked per view (``[V, nnz]``,
    ``[V, n_layers, nnz]``, an :class:`EdgeMask`, or a :class:`PrfMask` with
    one key per view), each view's picked in turn; ``keys``: ``[V, n_layers,
    ...]`` when ``post`` is set.
    """
    return torch.stack([
        spmm_layers(g, x0, n_layers,
                    None if edge_weights is None else _pick(edge_weights, v),
                    post, None if keys is None else keys[v])
        for v, x0 in enumerate(x0s)])


def spmm_t(g: CsrGraph, x: torch.Tensor, edge_weight: EdgeWeight = None) -> torch.Tensor:
    """``Aᵀ @ x`` through the transposed layout; ``x`` is ``[n_rows, d]``."""
    return spmm(g.t(), x, edge_weight)


def sddmm(g, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product: per-edge ``⟨a[row], b[col]⟩`` → ``[nnz]``."""
    return (a[g.rows] * b[g.cols]).sum(-1)


def spmm_dense_ref(g, x: torch.Tensor) -> torch.Tensor:
    """Dense reference (tests only)."""
    dense = torch.zeros(g.n_rows, g.n_cols, dtype=x.dtype, device=x.device)
    dense.index_put_((g.rows.long(), g.cols.long()), g.vals.to(x.dtype),
                     accumulate=True)
    return dense @ x
