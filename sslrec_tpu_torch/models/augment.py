"""Graph and embedding augmentations (port of ``sslrec_tpu/models/augment.py``).

Dropout keeps static shapes: a 0/1 multiplier per edge instead of a smaller
edge list, so dropped edges contribute exactly zero to the propagation.

The JAX functions take a PRNG key; these take their draws instead (a
uniform tensor, a keep mask), which a model's draw method makes from a
``torch.Generator`` and a test can inject.  Edge dropout is the exception:
its PRF mask is a function of the key, evaluated inside B1.  ``kmeans`` and
``svd_decompose`` draw from an optional generator unless the initial pick /
``omega`` is given.
"""

from __future__ import annotations

from typing import Sequence

import torch

from sslrec_tpu_torch.ops.spmm import spmm, spmm_t
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
    mask of the original edge id under ``key`` (two uint32 values, or ``[V,
    2]`` for one mask per view), the one the JAX package's accelerator path
    uses, as a :class:`PrfMask` that B1 evaluates inside the kernel (``.w``
    materialises it).  ``salts``: an int, or a sequence for a per-layer
    dimension.  ``None`` when ``keep_rate >= 1``.
    """
    if keep_rate >= 1.0:
        return None
    return prf_mask(key, g, keep_rate, salts=salts, resize_val=resize_val)


def node_drop(u: torch.Tensor, embeds: torch.Tensor, keep_rate: float) -> torch.Tensor:
    """Zero whole rows with probability 1 - keep_rate: ``floor(u + keep_rate)``
    per row, ``u`` uniform ``[N, 1]``."""
    if keep_rate >= 1.0:
        return embeds
    return embeds * torch.floor(u + keep_rate)


def embed_dropout(keep: torch.Tensor, embeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout: ``embeds / (1 - rate)`` where ``keep`` (a bool mask of
    ``embeds``' shape, true with probability 1 - rate), else 0."""
    if rate <= 0.0:
        return embeds
    return torch.where(keep, embeds / (1.0 - rate), 0.0)


def embed_perturb(noise: torch.Tensor, embeds: torch.Tensor, eps: float) -> torch.Tensor:
    """SimGCL's sign-aligned noise: ``noise`` (uniform [0, 1) of ``embeds``'
    shape) row-L2-normalised, signed like ``embeds``, scaled by ``eps``."""
    noise = noise / torch.sqrt((noise * noise).sum(dim=-1, keepdim=True) + 1e-12)
    return embeds + noise * torch.sign(embeds) * eps


def adaptive_mask(g: CsrGraph, head_embeds: torch.Tensor,
                  tail_embeds: torch.Tensor) -> torch.Tensor:
    """DCCF's learned edge values ``[nnz]`` on ``g``'s edges, in its original
    order: alpha = (cos(head[row], tail[col]) + 1) / 2, divided by the alpha
    degree of the row.

    The degree's row sum runs on B1 (a d = 1 hop over ``ones`` with alpha as
    the learned weight, whose gradient is SpmmFn's gather), not a float-atomic
    ``index_add_``, so the step repeats bit for bit on the card.  ``g``'s
    values must all be 1, as DCCF's plain adjacency's are.
    """
    if not g.fwd.vals_ones:
        raise ValueError("adaptive_mask: the graph's edge values must all be 1")
    hn = head_embeds / torch.sqrt((head_embeds * head_embeds).sum(-1, keepdim=True) + 1e-12)
    tn = tail_embeds / torch.sqrt((tail_embeds * tail_embeds).sum(-1, keepdim=True) + 1e-12)
    alpha = ((hn[g.rows] * tn[g.cols]).sum(dim=-1) + 1.0) / 2.0
    ones = torch.ones(g.n_cols, 1, dtype=alpha.dtype, device=alpha.device)
    deg = spmm(g, ones, alpha)[:, 0]
    d_inv = torch.where(deg > 0, 1.0 / deg, 0.0)
    return d_inv[g.rows] * alpha


def kmeans(embeds: torch.Tensor, cluster_num: int, iters: int = 100,
           gen: torch.Generator | None = None, pick: torch.Tensor | None = None):
    """Lloyd's k-means (NCL's prototypes), from ``cluster_num`` sampled rows:
    ``pick`` (else drawn from ``gen``: distinct rows, or with replacement when
    there are fewer rows than clusters), then ``iters`` steps; an empty
    cluster keeps its centroid.  The cluster sums are a one-hot matmul, which
    repeats bit for bit on the card, where ``index_add_``'s atomics would not.
    Returns (centroids [C, d], assignment [N] int64, cluster sizes [C, 1]).
    """
    n = embeds.shape[0]
    if pick is None:
        if n >= cluster_num:
            pick = torch.randperm(n, generator=gen, device=gen.device)[:cluster_num]
        else:
            pick = torch.randint(0, n, (cluster_num,), generator=gen, device=gen.device)
    cents = embeds[pick.to(embeds.device)]

    def assign(cents):
        # ‖x - c‖² = ‖x‖² - 2x·c + ‖c‖²; argmin over c
        return torch.argmin((cents * cents).sum(-1)[None, :] - 2.0 * (embeds @ cents.T), dim=-1)

    def counts_sums(idx):
        onehot = torch.nn.functional.one_hot(idx, cluster_num).to(embeds.dtype)
        return onehot.sum(0)[:, None], onehot.T @ embeds

    for _ in range(iters):
        cnts, sums = counts_sums(assign(cents))
        cents = torch.where(cnts > 0, sums / cnts.clamp(min=1.0), cents)
    idx = assign(cents)
    return cents, idx, counts_sums(idx)[0]


def svd_decompose(g: CsrGraph, q: int, n_iter: int = 4, gen: torch.Generator | None = None,
                  omega: torch.Tensor | None = None):
    """Rank-``q`` randomised SVD of the sparse ``g`` (LightGCL): Halko's
    subspace iteration at width q + 8, every product through :func:`spmm` /
    :func:`spmm_t`, then ``torch.linalg.qr`` / ``svd``.  ``omega``: the
    ``[n_cols, q + 8]`` Gaussian start (else drawn from ``gen``).
    Returns (ut [q, m], vt [q, n], u_mul_s [m, q], v_mul_s [n, q]).
    """
    if omega is None:
        omega = torch.randn(g.n_cols, q + 8, generator=gen, device=gen.device)
    y = spmm(g, omega.to(g.vals.device))
    for _ in range(n_iter):
        y = torch.linalg.qr(y).Q
        z = torch.linalg.qr(spmm_t(g, y)).Q
        y = spmm(g, z)
    qmat = torch.linalg.qr(y).Q                  # [m, q+8]
    b = spmm_t(g, qmat).T                        # [q+8, n]
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = (qmat @ ub)[:, :q]
    s = s[:q]
    v = vt[:q, :].T
    return u.T, v.T, u * s[None, :], v * s[None, :]
