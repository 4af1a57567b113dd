"""Knowledge-graph data handler (port of ``sslrec_tpu/data/kg.py``).

CF files are ``u i1 i2 ...`` lines; KG triples from ``kg_final.txt`` get
inverse relations appended, relation ids shifted by +1 to reserve the
'interact' relation.  Entity, node and relation counts land on the bundle.

Device artifacts: the KG edge arrays (head, relation, tail), capped per head
at ``triplet_num`` with numpy's generator in the JAX package's order (the same
edges, bit for bit); the square UI adjacency as a :class:`MaskableBiAdj`,
whose normalised values are recomputed on the device from a mask over the
rectangular UI edges; padded eval structures.

Files are read from ``data.dir`` only (``<dir>/kg/<name>_kg/``); a missing
file raises, naming it.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch.data.base import DataBundle, EvalData
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.segment_kernel import SegmentOps
from sslrec_tpu_torch.ops.spmm_kernel import build_csr_graph

_DEFAULT_DATA_ROOT = "datasets"


def read_cf(path: str) -> np.ndarray:
    """u i1 i2 ... lines → unique [n, 2] (u, i) pairs (order per reference)."""
    pairs = []
    with open(path) as f:
        for line in f:
            toks = [int(x) for x in line.strip().split(" ")]
            u, items = toks[0], sorted(set(toks[1:]))
            for i in items:
                pairs.append((u, i))
    return np.asarray(pairs, dtype=np.int64)


def read_triplets(path: str):
    """kg_final.txt (h r t) → inverse-augmented triples + stats: inverse
    relations offset by max+1, then every relation shifted +1."""
    can = np.loadtxt(path, dtype=np.int64, ndmin=2)
    can = np.unique(can, axis=0)
    inv = can.copy()
    inv[:, 0] = can[:, 2]
    inv[:, 2] = can[:, 0]
    inv[:, 1] = can[:, 1] + can[:, 1].max() + 1
    can = can.copy()
    can[:, 1] = can[:, 1] + 1
    inv[:, 1] = inv[:, 1] + 1
    triplets = np.concatenate([can, inv], axis=0)
    n_entities = int(max(triplets[:, 0].max(), triplets[:, 2].max()) + 1)
    n_relations = int(triplets[:, 1].max() + 1)
    return triplets, n_entities, n_relations


def cap_edges_per_head(triplets: np.ndarray, cap: int, seed: int = 0):
    """≤cap random triples per head, heads in first-seen order (KGCL
    ``_samp_edge_from_dict``); the same draws as the JAX package."""
    rng = np.random.default_rng(seed)
    by_head = defaultdict(list)
    for h, r, t in triplets:
        by_head[int(h)].append((int(r), int(t)))
    heads, rels, tails = [], [], []
    for h, lst in by_head.items():
        if len(lst) > cap:
            idx = rng.choice(len(lst), cap, replace=False)
            lst = [lst[i] for i in idx]
        for r, t in lst:
            heads.append(h)
            rels.append(r)
            tails.append(t)
    return (np.asarray(heads, np.int32), np.asarray(rels, np.int32),
            np.asarray(tails, np.int32))


class MaskableBiAdj:
    """Square [U+I, U+I] adjacency whose per-view normalised values are a
    function of a 0/1 mask over the *rectangular* UI edges.

    ``graph``: a :class:`CsrGraph` with base values 1, edges lexsorted by
    (row, col); ``rect_id``: [nnz_bi] map from bi-edge to its rect edge;
    ``view_vals(mask)``: D^-1/2 A D^-1/2 values of the masked graph in the
    graph's edge order, computed on the device.
    """

    def __init__(self, ui_mat: sp.coo_matrix, n_users: int, n_items: int, device="cpu"):
        coo = ui_mat.tocoo()
        nnz = coo.nnz
        rows = np.concatenate([coo.row, coo.col + n_users])
        cols = np.concatenate([coo.col + n_users, coo.row])
        rect = np.concatenate([np.arange(nnz), np.arange(nnz)])
        order = np.lexsort((cols, rows))
        rows, cols, rect = rows[order], cols[order], rect[order]
        self.n_nodes = n_users + n_items

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

        self.graph = build_csr_graph(sparse_ops.CooGraph(
            rows=t(rows), cols=t(cols), vals=torch.ones(2 * nnz, device=device),
            n_rows=self.n_nodes, n_cols=self.n_nodes), device)
        self._seg_rows = SegmentOps(rows, self.n_nodes, device)
        self.rect_id = t(rect)
        self.rect_item_ids = t(coo.col)     # [nnz_rect]
        self.nnz_rect = nnz

    def view_vals(self, rect_mask: torch.Tensor) -> torch.Tensor:
        """[nnz_rect] 0/1 mask → [nnz_bi] normalised edge values (eps 1e-7)."""
        me = rect_mask[self.rect_id]
        deg = self._seg_rows.sum(me) + 1e-7
        dinv = deg ** -0.5
        return me * dinv[self.graph.rows] * dinv[self.graph.cols]


def _eval_from_dicts(train_dict, test_dict, n_users, n_items, device):
    def to_mat(d):
        rows, cols = [], []
        for u, items in d.items():
            rows.extend([u] * len(items))
            cols.extend(items)
        return sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                             shape=(n_users, n_items))

    trn = to_mat(train_dict)
    tst = to_mat(test_dict)
    csr = tst.tocsr()
    test_users = np.where(np.diff(csr.indptr) > 0)[0].astype(np.int32)
    return EvalData(
        test_users=torch.from_numpy(test_users).to(device),
        ground_truth=sparse_ops.build_padded_rows(tst, device=device),
        history=sparse_ops.build_padded_rows(trn, device=device),
        n_test_users=int(test_users.shape[0]),
    ), trn


def _dataset_dir(cfg) -> str:
    root = cfg.data.get("dir") or _DEFAULT_DATA_ROOT
    return os.path.join(root, "kg", f"{cfg.data.name}_kg")


def _need(d: str, fname: str) -> str:
    p = os.path.join(d, fname)
    if not os.path.exists(p):
        raise FileNotFoundError(f"KG dataset file missing: {p}")
    return p


def load(cfg, device="cpu") -> DataBundle:
    d = _dataset_dir(cfg)
    train_cf = read_cf(_need(d, "train.txt"))
    test_cf = read_cf(_need(d, "test.txt"))
    vp = os.path.join(d, "valid.txt")  # only derived splits have one
    valid_cf = read_cf(vp) if os.path.exists(vp) else None
    triplets, n_entities, n_relations = read_triplets(_need(d, "kg_final.txt"))
    return bundle_from_kg(cfg, train_cf, test_cf, triplets, n_entities,
                          n_relations, valid_cf=valid_cf, device=device)


def bundle_from_kg(cfg, train_cf, test_cf, triplets, n_entities, n_relations,
                   valid_cf=None, device="cpu") -> DataBundle:
    n_users = int(max(train_cf[:, 0].max(), test_cf[:, 0].max()) + 1)
    n_items = int(max(train_cf[:, 1].max(), test_cf[:, 1].max()) + 1)
    if valid_cf is not None and len(valid_cf):
        n_users = max(n_users, int(valid_cf[:, 0].max() + 1))
        n_items = max(n_items, int(valid_cf[:, 1].max() + 1))

    train_dict = defaultdict(list)
    for u, i in train_cf:
        train_dict[int(u)].append(int(i))
    test_dict = defaultdict(list)
    for u, i in test_cf:
        test_dict[int(u)].append(int(i))

    test_eval, trn_mat = _eval_from_dicts(train_dict, test_dict, n_users, n_items, device)
    valid_eval = None
    if valid_cf is not None and len(valid_cf):
        valid_dict = defaultdict(list)
        for u, i in valid_cf:
            valid_dict[int(u)].append(int(i))
        valid_eval, _ = _eval_from_dicts(train_dict, valid_dict, n_users, n_items, device)
    trn_coo = trn_mat.tocoo()
    order = np.lexsort((trn_coo.col, trn_coo.row))

    cap = int(cfg.model.get("triplet_num", 15))
    heads, rels, tails = cap_edges_per_head(triplets, cap, seed=int(cfg.train.seed))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    extras = {
        "kg_heads": t(heads),
        "kg_rels": t(rels),
        "kg_tails": t(tails),
        "kg_triplets_full": triplets,  # host, for TransE batches
        "bi_adj_maskable": MaskableBiAdj(trn_coo, n_users, n_items, device),
        "entity_num": n_entities,
        "relation_num": n_relations,
        "node_num": n_entities + n_users,
        "train_mat_scipy": trn_coo,
    }
    return DataBundle(
        user_num=n_users,
        item_num=n_items,
        train_users=t(trn_coo.row[order]),
        train_items=t(trn_coo.col[order]),
        train_edge_set=sparse_ops.build_edge_set(trn_mat, device=device),
        valid=valid_eval,
        test=test_eval,
        extras=extras,
    )
