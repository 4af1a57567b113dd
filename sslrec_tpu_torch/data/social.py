"""Social-recommendation data handler (port of ``sslrec_tpu/data/social.py``:
DcRec, MHCN, DSL, SMIN and KCGN).

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
  social negatives are rejected against;
- SMIN: the five metapath graphs (UU, UIU, UITIU, ITI, IUI: sampled
  co-occurrence closures, sym-normalised), the one-hop UI + UU + ITI graph
  with its destination-normalised DGI form and edge list, and its 2-hop
  closure with row counts;
- KCGN: the (user, item × rating) expanded graph's edges sorted by
  destination, with bucketed edge times; the uu and ii DGI graphs and their
  connected-component structures.

The co-occurrence sampler is this package's own vectorised numpy sampler
(:func:`sample_row_subsets`) with the JAX package's rule, not its native
code's draws: at rate 1 both are the exact closure.  ``category.pkl`` and
``trn_time.pkl`` are read where they exist, else the JAX package's fallbacks
(one category holding every item, unit times) are taken and logged.

Every graph lands as a :class:`CsrGraph` on the run's device.  There is no
validation split (the trainer then early-stops on test, as the JAX package
does), and no fallback directory: a missing ``trn``/``tst``/``trust``
pickle raises.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

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


COOC_BUDGET = 3e7    # multiplies of one row chunk of the co-occurrence product


def sample_row_subsets(indptr: np.ndarray, indices: np.ndarray, rate: float,
                       rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Per CSR row of degree ``deg``, ``floor(deg · rate)`` distinct members
    drawn uniformly without replacement; returns ``(rows, cols)``.

    Vectorised over rows.  Where the draws keep a quarter or more of the
    entries, each entry gets a uniform key and a row keeps its smallest;
    otherwise each row draws positions with replacement and keeps the first
    ``k`` distinct ones in draw order (a row whose draws held fewer draws
    again, with more), so a sparse sample never sorts the whole row set.
    Either way a row's sample is a uniform ``k``-subset."""
    indptr = np.asarray(indptr, np.int64)
    deg = np.diff(indptr)
    k = np.minimum((deg * rate).astype(np.int64), deg)
    n_rows, nnz, total = deg.size, int(indptr[-1]), int(k.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if 4 * total >= nnz:
        row_of = np.repeat(np.arange(n_rows), deg)
        order = np.lexsort((rng.random(nnz), row_of))
        rank = np.arange(nnz) - indptr[row_of]
        pos = order[rank < k[row_of]]
        return row_of[pos], np.asarray(indices)[pos].astype(np.int64)
    picked, pending, margin = [], np.flatnonzero(k > 0), 1.25
    while pending.size:
        n_draw = np.ceil(k[pending] * margin).astype(np.int64) + 8
        r = np.repeat(pending, n_draw)
        g = indptr[r] + rng.integers(0, deg[r])
        _, first = np.unique(g, return_index=True)
        first.sort()                       # grouped by row, in draw order
        fr = r[first]
        starts = np.searchsorted(fr, pending)
        got = np.diff(np.append(starts, first.size))
        rank = np.arange(first.size) - np.repeat(starts, got)
        done = got >= k[pending]
        keep = (rank < k[fr]) & np.repeat(done, got)
        picked.append(g[first[keep]])
        pending, margin = pending[~done], 2 * margin
    pos = np.sort(np.concatenate(picked))
    row_of = np.searchsorted(indptr, pos, side="right") - 1
    return row_of, np.asarray(indices)[pos].astype(np.int64)


def _sampled_cooc(mat, rate: float, rng: np.random.Generator) -> sp.csr_matrix:
    """The rows sharing a column with row ``i`` (row ``i`` included),
    ``floor(size · rate)`` of them per row drawn by
    :func:`sample_row_subsets`, closed as ``out + outᵀ + I`` and binarised.

    The co-occurrence product ``m @ mᵀ`` is formed and sampled in row chunks
    cut by each row's exact multiply count, ``COOC_BUDGET`` a chunk (the
    JAX package's chunks; one draw of ``rng`` seeds each chunk's sampler, as
    there): whole, it is quadratic in a large category's row set."""
    m = mat.tocsr().astype(np.float32)
    mt = m.T.tocsr()
    n = m.shape[0]
    mt_deg = np.diff(mt.indptr).astype(np.float64)
    mb = m.copy()
    mb.data = np.ones_like(mb.data)
    contrib = np.asarray(mb @ mt_deg).reshape(-1)
    cum = np.concatenate([[0.0], np.cumsum(np.maximum(contrib, 1.0))])
    rows_out, cols_out = [], []
    s = 0
    while s < n:
        e = max(int(np.searchsorted(cum, cum[s] + COOC_BUDGET, side="right")) - 1, s + 1)
        cooc = (m[s:e] @ mt).tocsr()
        chunk_rng = np.random.default_rng(int(rng.integers(1 << 31)))
        r, c = sample_row_subsets(cooc.indptr, cooc.indices, rate, chunk_rng)
        rows_out.append(r + s)
        cols_out.append(c)
        s = e
    r = np.concatenate(rows_out) if rows_out else np.zeros(0, np.int64)
    c = np.concatenate(cols_out) if cols_out else np.zeros(0, np.int64)
    out = sp.coo_matrix((np.ones(len(r), np.float32), (r, c)), shape=(n, n)).tocsr()
    return (out + out.T + sp.eye(n, format="csr")) != 0


def gen_metapaths(trn_mat, trust_mat, category_mat, rng=None) -> dict:
    """SMIN's metapath graphs UU, UIU, UITIU, ITI and IUI: sampled
    co-occurrence closures with self loops, binarised (UU: the symmetrised
    trust graph)."""
    rng = rng or np.random.default_rng(0)
    trn = trn_mat.tocsr()
    n_users = trn.shape[0]
    cat = sp.csr_matrix(category_mat)
    uu = ((trust_mat.T + trust_mat) + sp.eye(n_users, format="csr")) != 0
    uiu = _sampled_cooc(trn, 0.3, rng)
    iui = _sampled_cooc(trn.T, 0.25, rng)
    iti = _sampled_cooc(cat, 0.002 if cat.shape[0] > 500 else 0.3, rng)
    uitiu = _sampled_cooc(trn @ cat, 0.0003 if n_users > 2000 else 0.2, rng)
    return {"UU": uu.tocsr(), "UIU": uiu, "UITIU": uitiu, "ITI": iti, "IUI": iui}


def gen_ui_subgraph(trn_mat, metapath: dict, k_hop: int = 2):
    """SMIN's one-hop graph over users and items (UI both ways, UU, and 2% of
    ITI's edges drawn by ``default_rng(0)``) and its ``k_hop`` closure: the
    node pairs joined by more than 10 paths of each length added, binarised.
    Returns ``(one_hop, sub)``, CSR."""
    rng = np.random.default_rng(0)
    n_users, n_items = trn_mat.shape
    n = n_users + n_items
    g = sp.dok_matrix((n, n))
    coo = trn_mat.tocoo()
    g[coo.row, n_users + coo.col] = 1
    g[n_users + coo.col, coo.row] = 1
    uu = metapath["UU"].tocoo()
    g[uu.row, uu.col] = 1
    iti = metapath["ITI"].tocoo()
    if iti.nnz:
        k = max(int(iti.nnz * 0.02), 1)
        r = rng.choice(iti.row, size=k, replace=False)
        c = rng.choice(iti.col, size=k, replace=False)
        g[n_users + r, n_users + c] = 1
    one_hop = g.tocsr()
    sub = one_hop.copy()
    if k_hop == 2:
        # the reach product in row chunks: whole, it is dense at scale
        chunk, strong = 4096, []
        for s in range(0, n, chunk):
            sc = ((one_hop[s:s + chunk] @ one_hop) > 10).tocoo()
            if sc.nnz:
                strong.append(sp.coo_matrix((np.ones(sc.nnz, np.float32), (sc.row + s, sc.col)),
                                            shape=one_hop.shape))
        if strong:
            sub = sub + sum(strong[1:], strong[0])
    elif k_hop > 2:
        reach, subl = one_hop, sub.tolil()
        for _ in range(k_hop - 1):
            reach = reach @ one_hop
            subl[(reach > 10).nonzero()] = 1
        sub = subl.tocsr()
    return one_hop, (sub.tocsr() != 0)


def connected_component_structs(mat, subnode: int):
    """Connected components of ``mat`` (undirected): each node's component,
    the ``[n_comp, n]`` membership matrix (CSR, ones), the components' sizes
    and the mask of nodes in components of more than ``subnode`` nodes."""
    n = mat.shape[0]
    n_comp, labels = connected_components(mat, directed=False)
    adj = sp.coo_matrix((np.ones(n, np.float32), (labels, np.arange(n))),
                        shape=(n_comp, n)).tocsr()
    sizes = np.asarray(adj.sum(1)).reshape(-1)
    node_mask = (sizes[labels] > subnode).astype(np.float32)
    return labels, adj, sizes, node_mask


def build_kcgn_structs(cfg, trn_rated, trn_time, trust_mat, category_mat) -> dict:
    """KCGN's host structures (numpy and scipy): the expanded graph over
    users and (item, rating) nodes with bucketed edge times and a self loop
    per node (time 1), sorted by destination; the uu (symmetrised trust) and
    ii (sampled category co-membership, ``model.ii_sample_rate``, default
    0.002 over 500 items, else exact) graphs, their DGI forms (rows scaled
    by ``deg^-1/2``), components and masks."""
    n_users, n_items = trn_rated.shape
    coo = trn_rated.tocoo()
    ratings = np.unique(coo.data)
    r_idx = np.searchsorted(ratings, coo.data)
    rating_class = len(ratings)
    tvals = np.asarray(sp.csr_matrix(trn_time)[coo.row, coo.col]).reshape(-1)
    # bucket ids from 2 up: 0 and 1 are reserved, 1 for the self loops
    time_step = 3600 * float(cfg.model.get("time_step", 360))
    buckets = ((tvals - tvals.min()) / time_step).astype(np.int64) + 2
    n = n_users + rating_class * n_items
    src = np.concatenate([coo.row, n_users + coo.col * rating_class + r_idx, np.arange(n)])
    dst = np.concatenate([n_users + coo.col * rating_class + r_idx, coo.row, np.arange(n)])
    times = np.concatenate([buckets, buckets, np.ones(n, np.int64)])
    order = np.lexsort((src, dst))

    uu = ((trust_mat.T + trust_mat) + sp.eye(n_users, format="csr")) != 0
    cat = sp.csr_matrix(category_mat)
    rng = np.random.default_rng(int(cfg.train.get("seed", 0)))
    ii_rate = float(cfg.model.get("ii_sample_rate", 0.002 if cat.shape[0] > 500 else 1.0))
    ii = _sampled_cooc(cat, ii_rate, rng)
    print(f"[data/social] KCGN item-item graph: rate={ii_rate} nnz={int(ii.nnz)} "
          f"(exact cat@cat.T when rate=1.0)", flush=True)

    def dgi_graph(m):
        dinv = np.power(np.maximum(np.asarray(m.sum(1)).reshape(-1), 1.0), -0.5)
        return (sp.diags(dinv) @ (m * 1.0)).tocoo()

    subnode = int(cfg.model.get("subnode", 10))
    uu_lbl, uu_adj, _, uu_mask = connected_component_structs(uu, subnode)
    ii_lbl, ii_adj, _, ii_mask = connected_component_structs(ii, subnode)

    def norm(adj):
        return np.maximum(np.asarray(adj.sum(1)).reshape(-1), 1e-8).astype(np.float32)

    return {"kcgn_src": src[order], "kcgn_dst": dst[order], "kcgn_time": times[order],
            "kcgn_n_nodes": n, "rating_class": rating_class, "max_time": int(times.max()) + 1,
            "uu_dgi_graph": dgi_graph(uu), "ii_dgi_graph": dgi_graph(ii),
            "uu_labels": uu_lbl, "ii_labels": ii_lbl,
            "uu_sub_adj": uu_adj.tocoo(), "ii_sub_adj": ii_adj.tocoo(),
            "uu_sub_norm": norm(uu_adj), "ii_sub_norm": norm(ii_adj),
            "uu_dgi_mask": uu_mask, "ii_dgi_mask": ii_mask}


def _dataset_dir(cfg) -> str:
    return os.path.join(cfg.data.get("dir") or _DEFAULT_DATA_ROOT, "social", cfg.data.name)


def _load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _load_optional(d: str, fname: str, fallback: str):
    p = os.path.join(d, fname)
    if os.path.exists(p):
        return _load_pkl(p)
    print(f"[data/social] no {p}: {fallback}", flush=True)
    return None


def load(cfg, device="cpu") -> DataBundle:
    d = _dataset_dir(cfg)
    mats = [_load_pkl(os.path.join(d, f"{f}.pkl")) for f in ("trn_mat", "tst_mat", "trust_mat")]
    category_mat = trn_time = None
    if cfg.model.name.lower() in ("smin", "kcgn"):
        category_mat = _load_optional(d, "category.pkl", "one category holding every item")
    if cfg.model.name.lower() == "kcgn":
        trn_time = _load_optional(d, "trn_time.pkl", "unit timestamps")
    return bundle_from_matrices(cfg, *mats, device, category_mat=category_mat,
                                trn_time=trn_time)


def bundle_from_matrices(cfg, trn_mat, tst_mat, trust_mat, device="cpu",
                         category_mat=None, trn_time=None) -> DataBundle:
    """Assemble the bundle of ``cfg.model.name`` from scipy matrices (also
    used by tests); SMIN and KCGN take one category holding every item
    where ``category_mat`` is None, KCGN unit times where ``trn_time`` is."""
    model_name = cfg.model.name.lower()
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
    if model_name in ("smin", "kcgn") and category_mat is None:
        category_mat = sp.csr_matrix(np.ones((n_items, 1), np.float32))
    if model_name == "smin":
        metapath = gen_metapaths(trn_bin, trust_mat, category_mat)
        extras["metapath_graphs"] = {k: graph(sparse_ops.normalize_adj_sym(v))
                                     for k, v in metapath.items()}
        one_hop, sub = gen_ui_subgraph(trn_bin, metapath, int(cfg.model.get("k_hop_num", 2)))
        # the DGI encoder's graph: rows scaled by deg^-1/2
        dinv = np.power(np.maximum(np.asarray(one_hop.sum(1)).reshape(-1), 1.0), -0.5)
        extras["dgi_graph"] = graph(sp.diags(dinv) @ one_hop)
        oh = one_hop.tocoo()
        extras["dgi_edges"] = (t(oh.row), t(oh.col))
        extras["subgraph_adj"] = graph(sub.tocoo().astype(np.float32))
        extras["subgraph_norm"] = torch.from_numpy(np.maximum(
            np.asarray(sub.sum(1)).reshape(-1), 1e-8).astype(np.float32)).to(device)
    if model_name == "kcgn":
        if trn_time is None:
            trn_time = (trn_mat != 0).astype(np.float64)
        ks = build_kcgn_structs(cfg, sp.csr_matrix(trn_mat), trn_time, trust_mat,
                                category_mat)
        for k in ("kcgn_src", "kcgn_dst", "kcgn_time", "uu_labels", "ii_labels"):
            extras[k] = t(ks[k])
        for k in ("uu_dgi_graph", "ii_dgi_graph", "uu_sub_adj", "ii_sub_adj"):
            extras[k] = graph(ks[k])
        for k in ("uu_sub_norm", "ii_sub_norm", "uu_dgi_mask", "ii_dgi_mask"):
            extras[k] = torch.from_numpy(np.asarray(ks[k], np.float32)).to(device)
        extras.update({k: ks[k] for k in ("kcgn_n_nodes", "rating_class", "max_time")})

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
