"""General collaborative-filtering data handler (port of
``sslrec_tpu/data/general_cf.py``).

Loads the pickled COO train/valid/test matrices, or the ``u i1 i2 ...`` txt
splits under the ``kg/`` layout, binarises them and builds the bidirectional
symmetric-normalised ``[U+I, U+I]`` adjacency.  Everything lands as tensors on
the requested device; the adjacency as a :class:`CsrGraph`, the layout the
SpMM kernel reads.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch.data.base import DataBundle, EvalData
from sslrec_tpu_torch.data.kg import read_cf
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.spmm_kernel import build_csr_graph

_DEFAULT_DATA_ROOT = "datasets"


def _dataset_dir(cfg) -> str:
    root = cfg.data.get("dir") or _DEFAULT_DATA_ROOT
    name = cfg.data.name
    sub = {"yelp": "sparse_yelp", "gowalla": "sparse_gowalla", "amazon": "sparse_amazon"}
    return os.path.join(root, "general_cf", sub.get(name, name))


def load_one_mat(path: str) -> sp.coo_matrix:
    """Load + binarise one pickled sparse matrix."""
    with open(path, "rb") as f:
        mat = pickle.load(f)
    mat = (mat != 0).astype(np.float32)
    if not isinstance(mat, sp.coo_matrix):
        mat = sp.coo_matrix(mat)
    return mat


def _eval_data(split_mat: sp.spmatrix, trn_mat: sp.spmatrix, device) -> EvalData:
    csr = split_mat.tocsr()
    counts = np.diff(csr.indptr)
    test_users = np.where(counts > 0)[0].astype(np.int32)
    return EvalData(
        test_users=torch.from_numpy(test_users).to(device),
        ground_truth=sparse_ops.build_padded_rows(split_mat, device=device),
        history=sparse_ops.build_padded_rows(trn_mat, device=device),
        n_test_users=int(test_users.shape[0]),
    )


def bundle_from_matrices(trn_mat: sp.spmatrix, val_mat: sp.spmatrix | None,
                         tst_mat: sp.spmatrix, device="cpu") -> DataBundle:
    """Assemble a DataBundle from scipy matrices (also used by tests)."""
    n_users, n_items = trn_mat.shape
    coo = trn_mat.tocoo()
    order = np.lexsort((coo.col, coo.row))
    bi_adj = sparse_ops.make_bi_adj(trn_mat, n_users, n_items)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return DataBundle(
        user_num=int(n_users),
        item_num=int(n_items),
        train_users=t(coo.row[order]),
        train_items=t(coo.col[order]),
        train_edge_set=sparse_ops.build_edge_set(trn_mat, device=device),
        valid=_eval_data(val_mat, trn_mat, device) if val_mat is not None else None,
        test=_eval_data(tst_mat, trn_mat, device),
        extras={
            # normalised bidirectional adjacency over [U+I] nodes, the input to
            # every general-CF propagation, in both CSR directions
            "bi_adj": build_csr_graph(sparse_ops.from_scipy(bi_adj), device),
            # raw train matrix kept host-side for models needing graph algebra
            "train_mat_scipy": trn_mat.tocoo(),
        },
    )


def _mats_from_txt(d: str):
    """CF splits in the KG line format (``u i1 i2 ...``) → scipy matrices, so
    CF models train on a KG dataset's derived interaction splits."""

    def mat(pairs, shape):
        return sp.coo_matrix((np.ones(len(pairs), np.float32),
                              (pairs[:, 0], pairs[:, 1])), shape=shape)

    trn = read_cf(os.path.join(d, "train.txt"))
    tst = read_cf(os.path.join(d, "test.txt"))
    vp = os.path.join(d, "valid.txt")
    val = read_cf(vp) if os.path.exists(vp) else None
    splits = [trn, tst] + ([val] if val is not None else [])
    n_users = int(max(s[:, 0].max() for s in splits) + 1)
    n_items = int(max(s[:, 1].max() for s in splits) + 1)
    shape = (n_users, n_items)
    return (mat(trn, shape), mat(val, shape) if val is not None else None,
            mat(tst, shape))


def load(cfg, device="cpu") -> DataBundle:
    d = _dataset_dir(cfg)
    if not os.path.exists(os.path.join(d, "train_mat.pkl")):
        # derived txt splits live under the kg/ layout
        root = cfg.data.get("dir") or _DEFAULT_DATA_ROOT
        kg_dir = os.path.join(root, "kg", f"{cfg.data.name}_kg")
        if os.path.exists(os.path.join(kg_dir, "train.txt")):
            trn, val, tst = _mats_from_txt(kg_dir)
            return bundle_from_matrices(trn, val, tst, device)
    trn = load_one_mat(os.path.join(d, "train_mat.pkl"))
    tst = load_one_mat(os.path.join(d, "test_mat.pkl"))
    val_path = os.path.join(d, "valid_mat.pkl")
    val = load_one_mat(val_path) if os.path.exists(val_path) else None
    return bundle_from_matrices(trn, val, tst, device)
