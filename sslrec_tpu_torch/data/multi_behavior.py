"""Multi-behavior data handler (port of ``sslrec_tpu/data/multi_behavior.py``:
MBGMN, HMGCR, SMBRec, CML and KMCLR, and the plain MF view ``load_mf``).

Reads ``<data.dir>/multi_behavior/<name>/``: one pickled
``train_mat_<behavior>.pkl`` per behavior of ``BEHAVIORS[name]``, binarised,
and ``test_mat.pkl``.  Tmall's ``pv`` and ijcai_15's ``click`` may be absent
(the reference snapshot omits them); any other missing behavior, the target
above all, raises.  The target behavior (``model.target``, else the last)
gives the pairwise training stream and the evaluation's history; there is no
validation split.

Per behavior, ``behavior_graphs`` holds two B1 operators, A (user → item) and
AT (item → user), each ``D_r^-1/2 · M · D_c^-1/2`` with 1e-8 added to the
degrees, of the binarised matrix and of its transpose.  HMGCR also gets the
meta-path matrices ``train_mat_<meta path>.pkl`` (``META_PATHS``) as graphs
of the same form; SMBRec each behavior's user degrees and the user
co-interaction CSR of the target behavior (``M Mᵀ``, diagonal removed).
CML reads its meta users, the pickled index list
``meta_multi_single_beh_user_index_shuffle`` (a missing file raises, as in
the JAX package); KMCLR the triplets of ``kg.txt`` (``h r t`` lines) where
the file is there.  Files are read from ``data.dir`` only.
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

BEHAVIORS = {
    "ijcai_15": ["click", "fav", "cart", "buy"],
    "tmall": ["pv", "fav", "cart", "buy"],
    "retail_rocket": ["view", "cart", "buy"],
}
META_PATHS = {
    "ijcai_15": ["buy", "click_buy", "click_fav_buy", "click_fav_cart_buy"],
    "tmall": ["buy", "pv_buy", "pv_fav_buy", "pv_fav_cart_buy"],
    "retail_rocket": ["buy", "view_buy", "view_cart_buy"],
}
KNOWN_MISSING = {"tmall": {"pv"}, "ijcai_15": {"click"}}


def normalize_rect(adj: sp.spmatrix) -> sp.coo_matrix:
    """D_r^-1/2 A D_c^-1/2 with +1e-8 on both degrees."""
    adj = sp.coo_matrix(adj)
    rowsum = np.asarray(adj.sum(1)).reshape(-1)
    colsum = np.asarray(adj.sum(0)).reshape(-1)
    dr = sp.diags(np.power(rowsum + 1e-8, -0.5))
    dc = sp.diags(np.power(colsum + 1e-8, -0.5))
    return (dr @ adj @ dc).tocoo()


def behavior_graphs(mat: sp.spmatrix, device="cpu"):
    """(A, AT): the normalised user → item and item → user operators of one
    behavior, each in both CSR layouts on ``device``."""
    binm = (mat != 0) * 1.0
    return tuple(build_csr_graph(sparse_ops.from_scipy(normalize_rect(m)), device)
                 for m in (binm, binm.T))


def _read(path: str) -> sp.csr_matrix:
    with open(path, "rb") as f:
        return sp.csr_matrix((pickle.load(f) != 0).astype(np.float32))


def load(cfg, device="cpu") -> DataBundle:
    name = cfg.data.name
    d = os.path.join(cfg.data.get("dir") or _DEFAULT_DATA_ROOT, "multi_behavior", name)
    if name not in BEHAVIORS:
        raise KeyError(f"multi_behavior: unknown dataset {name!r}; known: {sorted(BEHAVIORS)}")
    behaviors = []
    for b in BEHAVIORS[name]:
        path = os.path.join(d, f"train_mat_{b}.pkl")
        if os.path.exists(path):
            behaviors.append(b)
        elif b not in KNOWN_MISSING.get(name, set()):
            raise FileNotFoundError(
                f"multi_behavior/{name}: required behavior matrix missing: {path}")
    mats = [_read(os.path.join(d, f"train_mat_{b}.pkl")) for b in behaviors]
    tst = _read(os.path.join(d, "test_mat.pkl"))
    model = cfg.model.name.lower()
    meta_mats = meta_users = kg_triplets = None
    if model == "hmgcr":
        meta_mats = [_read(os.path.join(d, f"train_mat_{mp}.pkl")) for mp in META_PATHS[name]]
    if model == "kmclr":
        kg_path = os.path.join(d, "kg.txt")
        if os.path.exists(kg_path):
            kg_triplets = np.loadtxt(kg_path, dtype=np.int64, ndmin=2)
    if model == "cml":
        with open(os.path.join(d, "meta_multi_single_beh_user_index_shuffle"), "rb") as f:
            meta_users = np.asarray(pickle.load(f), np.int32)
    return bundle_from_behaviors(cfg, behaviors, mats, tst, meta_mats=meta_mats,
                                 meta_users=meta_users, kg_triplets=kg_triplets,
                                 device=device)


def load_mf(cfg, device="cpu") -> DataBundle:
    """The plain matrix-factorisation view of a multi-behavior dataset (the
    ``multi_behavior_mf`` type): the target behavior's train matrix (the last
    behavior where ``model.target`` is not one) and the test split, no
    propagation graphs."""
    name = cfg.data.name
    d = os.path.join(cfg.data.get("dir") or _DEFAULT_DATA_ROOT, "multi_behavior", name)
    behaviors = BEHAVIORS[name]
    target = cfg.model.get("target", "buy")
    beh = target if target in behaviors else behaviors[-1]
    trn = _read(os.path.join(d, f"train_mat_{beh}.pkl")).tocoo()
    tst = _read(os.path.join(d, "test_mat.pkl"))
    order = np.lexsort((trn.col, trn.row))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return DataBundle(
        user_num=int(trn.shape[0]), item_num=int(trn.shape[1]),
        train_users=t(trn.row[order]), train_items=t(trn.col[order]),
        train_edge_set=sparse_ops.build_edge_set(trn, device=device),
        valid=None, test=_eval_data(tst.tocoo(), trn, device),
        extras={"train_mat_scipy": trn})


def bundle_from_behaviors(cfg, behaviors, mats, tst_mat, meta_mats=None, meta_users=None,
                          kg_triplets=None, device="cpu") -> DataBundle:
    target = cfg.model.get("target", "buy")
    t_idx = behaviors.index(target) if target in behaviors else len(behaviors) - 1
    trn = (mats[t_idx] != 0).astype(np.float32).tocoo()
    n_users, n_items = trn.shape
    order = np.lexsort((trn.col, trn.row))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    extras = {
        "behaviors": list(behaviors),
        "behavior_graphs": [behavior_graphs(m, device) for m in mats],
        "behavior_mats_scipy": [sp.coo_matrix(m) for m in mats],
        "train_mat_scipy": trn,
    }
    if meta_mats is not None:
        extras["meta_path_graphs"] = [behavior_graphs(m, device) for m in meta_mats]
    if meta_users is not None:
        extras["meta_users"] = t(meta_users)
    if kg_triplets is not None:
        extras["kg_triplets"] = kg_triplets
    if cfg.model.name.lower() == "smbrec":
        extras["beh_degrees"] = torch.from_numpy(np.stack(
            [np.asarray((m != 0).sum(axis=1)).reshape(-1) for m in mats]
        ).astype(np.float32)).to(device)
        # the target behavior's user co-interaction rows, the positives' pool
        lbl = (mats[t_idx] != 0) * 1.0
        co = sp.csr_matrix(lbl @ lbl.T)
        co.setdiag(0)
        co.eliminate_zeros()
        extras["co_user_indptr"] = t(co.indptr)
        extras["co_user_indices"] = t(co.indices)
    return DataBundle(
        user_num=int(n_users), item_num=int(n_items),
        train_users=t(trn.row[order]), train_items=t(trn.col[order]),
        train_edge_set=sparse_ops.build_edge_set(trn, device=device),
        valid=None, test=_eval_data(tst_mat.tocoo(), trn, device), extras=extras)
