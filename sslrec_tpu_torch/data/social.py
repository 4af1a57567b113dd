"""Social-recommendation data handler (port of ``sslrec_tpu/data/social.py``,
for DcRec, MHCN and DSL).

Reads the pickled ``trn_mat`` / ``tst_mat`` / ``trust_mat`` of
``<data.dir>/social/<name>/`` and builds what each model needs, host-side
scipy once at load:

- MHCN: the motif-induced hypergraph adjacencies ``H_s``, ``H_j``, ``H_p``
  (row-normalised) and the joint ``v / √(du·di)`` user × item matrix ``R``;
- DcRec and DSL: the symmetric-normalised bi-adjacency ``bi_adj`` and the
  symmetric-normalised trust graph ``uu_adj``; DcRec also the raw trust edges
  (row-sorted, the order its edge weights follow);
- DSL: the paired CF + social stream (``train_arrays``, each side wrapped
  modulo its own length up to the longer) and the trust edge set that its
  social negatives are rejected against.

Every graph lands as a :class:`CsrGraph` on the run's device.  There is no
validation split (the trainer then early-stops on test, as the JAX package
does), and no fallback directory: a missing pickle raises.  KCGN's and
SMIN's structures are not ported yet.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch.data.base import DataBundle
from sslrec_tpu_torch.data.general_cf import _eval_data
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.spmm_kernel import build_csr_graph

_DEFAULT_DATA_ROOT = "datasets"


def build_motif_adjacencies(trust_mat: sp.spmatrix, trn_mat: sp.spmatrix):
    """MHCN's motif-induced adjacencies over users, row-normalised:
    ``[H_s, H_j, H_p]`` as COO matrices."""
    s = trust_mat.tocsr()
    y = trn_mat.tocsr()
    b = s.multiply(s.T)
    u = s - b
    c1 = (u @ u).multiply(u.T)
    a1 = c1 + c1.T
    c2 = (b @ u).multiply(u.T) + (u @ b).multiply(u.T) + (u @ u).multiply(b)
    a2 = c2 + c2.T
    c3 = (b @ b).multiply(u) + (b @ u).multiply(b) + (u @ b).multiply(b)
    a3 = c3 + c3.T
    a4 = (b @ b).multiply(b)
    c5 = (u @ u).multiply(u) + (u @ u.T).multiply(u) + (u.T @ u).multiply(u)
    a5 = c5 + c5.T
    a6 = (u @ b).multiply(u) + (b @ u.T).multiply(u.T) + (u.T @ u).multiply(b)
    a7 = (u.T @ b).multiply(u.T) + (b @ u).multiply(u) + (u @ u.T).multiply(b)
    a8 = (y @ y.T).multiply(b)
    a9 = (y @ y.T).multiply(u)
    a9 = a9 + a9.T
    a10 = y @ y.T - a8 - a9

    def row_norm(h):
        h = sp.csr_matrix(h)
        deg = np.asarray(h.sum(axis=1)).reshape(-1)
        inv = np.divide(1.0, deg, out=np.zeros_like(deg, dtype=np.float64), where=deg != 0)
        return sp.diags(inv) @ h

    h_s = row_norm(a1 + a2 + a3 + a4 + a5 + a6 + a7)
    h_j = row_norm(a8 + a9)
    h_p = sp.csr_matrix(a10)
    h_p = row_norm(h_p.multiply(h_p > 1))
    return [h_s.tocoo(), h_j.tocoo(), h_p.tocoo()]


def build_joint_adjacency(trn_mat: sp.spmatrix) -> sp.coo_matrix:
    """The user × item matrix with values ``v / √(du·di)``."""
    coo = trn_mat.tocoo()
    udeg = np.asarray(coo.sum(axis=-1)).reshape(-1)
    ideg = np.asarray(coo.sum(axis=0)).reshape(-1)
    vals = coo.data / np.sqrt(udeg[coo.row] * ideg[coo.col])
    return sp.coo_matrix((vals, (coo.row, coo.col)), coo.shape)


def _dataset_dir(cfg) -> str:
    return os.path.join(cfg.data.get("dir") or _DEFAULT_DATA_ROOT, "social", cfg.data.name)


def _load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def load(cfg, device="cpu") -> DataBundle:
    d = _dataset_dir(cfg)
    return bundle_from_matrices(cfg, _load_pkl(os.path.join(d, "trn_mat.pkl")),
                                _load_pkl(os.path.join(d, "tst_mat.pkl")),
                                _load_pkl(os.path.join(d, "trust_mat.pkl")), device)


def bundle_from_matrices(cfg, trn_mat, tst_mat, trust_mat, device="cpu") -> DataBundle:
    """Assemble the bundle of ``cfg.model.name`` from scipy matrices (also
    used by tests)."""
    model_name = cfg.model.name.lower()
    if model_name in ("kcgn", "smin"):
        raise NotImplementedError(
            f"{model_name}: the social handler's metapath and KCGN structures are not "
            f"ported yet (ROADMAP Queue A)")
    n_users, n_items = trn_mat.shape
    trn_bin = (trn_mat != 0).astype(np.float32).tocoo()
    trust_mat = sp.csr_matrix(trust_mat)
    order = np.lexsort((trn_bin.col, trn_bin.row))
    train_users = trn_bin.row[order].astype(np.int32)
    train_items = trn_bin.col[order].astype(np.int32)

    def graph(mat):
        return build_csr_graph(sparse_ops.from_scipy(mat), device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    extras = {"trust_mat_scipy": trust_mat, "train_mat_scipy": trn_bin}
    if model_name == "mhcn":
        h_s, h_j, h_p = build_motif_adjacencies(trust_mat, trn_bin)
        extras.update(mhcn_h_s=graph(h_s), mhcn_h_j=graph(h_j), mhcn_h_p=graph(h_p),
                      mhcn_r=graph(build_joint_adjacency(trn_bin)))
    if model_name in ("dsl", "dcrec"):
        extras["bi_adj"] = graph(sparse_ops.make_bi_adj(trn_bin, n_users, n_items))
        extras["uu_adj"] = graph(sparse_ops.normalize_adj_sym((trust_mat != 0) * 1.0))
    if model_name == "dcrec":
        tcoo = sparse_ops.from_scipy((trust_mat != 0).astype(np.float32))
        extras["trust_edges"] = (tcoo.rows.to(device), tcoo.cols.to(device))
    if model_name == "dsl":
        # the paired CF + social stream: as long as the longer side, each side
        # wrapped modulo its own length
        tcoo = trust_mat.tocoo()
        n = max(len(train_users), tcoo.nnz)

        def wrap(a):
            return a[np.arange(n) % len(a)]

        extras["trust_edge_set"] = sparse_ops.build_edge_set(trust_mat, device=device)
        train_users, train_items = wrap(train_users), wrap(train_items)
        extras["train_arrays"] = {"user": t(train_users), "pos": t(train_items),
                                  "suser": t(wrap(tcoo.row)), "spos": t(wrap(tcoo.col))}

    return DataBundle(
        user_num=int(n_users),
        item_num=int(n_items),
        train_users=t(train_users),
        train_items=t(train_items),
        train_edge_set=sparse_ops.build_edge_set(trn_bin, device=device),
        valid=None,
        test=_eval_data(tst_mat, trn_bin, device),
        extras=extras,
    )
