"""Sparse graph containers and host-side builders (port of ``sslrec_tpu/ops/sparse.py``).

Graph construction (normalisation, bidirectionalisation) is host-side scipy,
run once at load time; the results land as torch tensors on the run's device.
The on-device format is row-sorted COO (:class:`CooGraph`); the CSR layouts the
SpMM kernel reads are built from it in :mod:`sslrec_tpu_torch.ops.spmm_kernel`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch


class CooGraph(NamedTuple):
    """Row-sorted COO sparse matrix: ``rows``/``cols`` int32, ``vals`` float32."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]


def from_scipy(mat: sp.spmatrix, device="cpu") -> CooGraph:
    """Any scipy sparse matrix as a row-sorted (then column-sorted) CooGraph."""
    coo = mat.tocoo()
    order = np.lexsort((coo.col, coo.row))

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a[order], dtype)).to(device)

    return CooGraph(rows=t(coo.row, np.int32), cols=t(coo.col, np.int32),
                    vals=t(coo.data, np.float32),
                    n_rows=int(coo.shape[0]), n_cols=int(coo.shape[1]))


def normalize_adj_sym(mat: sp.spmatrix, eps: float = 1e-10) -> sp.coo_matrix:
    """Symmetric normalisation D^-1/2 A D^-1/2, degrees over rows, with the
    reference's degree epsilon and inf-zeroing."""
    mat = mat.tocoo()
    degree = np.asarray(mat.sum(axis=-1)).reshape(-1) + eps
    d_inv_sqrt = np.power(degree, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    return (d @ mat @ d).tocoo()


def normalize_adj_left(mat: sp.spmatrix, eps: float = 1e-10) -> sp.coo_matrix:
    """Row (random-walk) normalisation D^-1 A, degrees over rows plus ``eps``;
    a row whose degree is then 0 (``eps=0``, an empty row) stays zero."""
    mat = mat.tocoo()
    degree = np.asarray(mat.sum(axis=-1)).reshape(-1) + eps
    with np.errstate(divide="ignore"):
        d_inv = 1.0 / degree
    d_inv[np.isinf(d_inv)] = 0.0
    return (sp.diags(d_inv) @ mat).tocoo()


def make_bi_adj(ui_mat: sp.spmatrix, n_users: int, n_items: int,
                self_loop: bool = False) -> sp.coo_matrix:
    """Bidirectional [[0, R], [R^T, 0]] adjacency, binarised then sym-normalised."""
    a = sp.csr_matrix((n_users, n_users))
    b = sp.csr_matrix((n_items, n_items))
    mat = sp.vstack([sp.hstack([a, ui_mat]), sp.hstack([ui_mat.transpose(), b])])
    mat = (mat != 0) * 1.0
    if self_loop:
        mat = mat + sp.eye(mat.shape[0])
    return normalize_adj_sym(mat)


class EdgeSet:
    """Set of (row, col) pairs with O(log nnz) membership tests.

    The JAX package packs ``row * n_cols + col`` into int32 codes when that
    fits and binary-searches CSR rows when it does not.  Here the codes are
    int64, which fits every shape either mode takes, so one sorted array and
    one ``torch.searchsorted`` answer both.
    """

    def __init__(self, codes: torch.Tensor, n_cols: int):
        self.codes = codes    # int64 [nnz], sorted
        self.n_cols = n_cols

    def contains(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Vectorised membership test; any shape, returns bool of the same shape."""
        q = rows.to(torch.int64) * self.n_cols + cols.to(torch.int64)
        if self.codes.numel() == 0:
            return torch.zeros_like(q, dtype=torch.bool)
        idx = torch.searchsorted(self.codes, q.reshape(-1))
        idx = idx.clamp_(max=self.codes.shape[0] - 1)
        return (self.codes[idx] == q.reshape(-1)).reshape(q.shape)


def build_edge_set(mat: sp.spmatrix, device="cpu") -> EdgeSet:
    coo = mat.tocoo()
    codes = np.unique(coo.row.astype(np.int64) * coo.shape[1]
                      + coo.col.astype(np.int64))
    return EdgeSet(torch.from_numpy(codes).to(device), int(coo.shape[1]))


class PaddedRows(NamedTuple):
    """Per-row column lists padded to a fixed width: ``cols`` int32
    ``[n_rows, width]`` (0 in padding), ``mask`` bool, ``lengths`` int32."""

    cols: torch.Tensor
    mask: torch.Tensor
    lengths: torch.Tensor


def padded_rows(indptr: np.ndarray, indices: np.ndarray, width: int):
    """CSR rows → (cols, mask, lengths), rows longer than ``width`` cut."""
    indptr = np.asarray(indptr, np.int64)
    lengths = np.diff(indptr)
    keep = np.minimum(lengths, width)
    mask = np.arange(width)[None, :] < keep[:, None]
    # position of each kept entry within its row, then its index in ``indices``
    starts = np.repeat(indptr[:-1], keep)
    within = np.arange(int(keep.sum())) - np.repeat(np.cumsum(keep) - keep, keep)
    cols = np.zeros((lengths.shape[0], width), np.int32)
    cols[mask] = np.asarray(indices, np.int32)[starts + within]
    return cols, mask, lengths.astype(np.int32)


def build_padded_rows(mat: sp.spmatrix, width: int | None = None,
                      device="cpu") -> PaddedRows:
    csr = mat.tocsr()
    lengths = np.diff(csr.indptr)
    if width is None:
        width = max(int(lengths.max(initial=0)), 1)
    cols, mask, lengths = padded_rows(csr.indptr, csr.indices, width)
    return PaddedRows(*(torch.from_numpy(a).to(device)
                        for a in (cols, mask, lengths)))
