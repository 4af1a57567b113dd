"""DCRec (sequential): debiased contrastive learning over a transformer and
two item-graph GCNs (port of ``sslrec_tpu/models/sequential/dcrec.py``).

Graphs (:func:`build_graphs`, numpy, array for array the JAX package's):
the item transition graph (symmetric consecutive-pair counts, unit
diagonal, D^-1/2 A D^-1/2 values), each train row's edge ids (both
directions of its consecutive pairs), and the cosine top-(k+1) similarity
graph, row-normalised; built from the train rows, and again from the test
rows for evaluation.

Each graph is one all-ones :class:`CsrGraph` over its (rows, cols), and its
values change every call, so every sum is B1 with the call's values as a
constant multiplier: a GCN hop ``Σ_e we[e]·x[col_e]`` (its gradient the
transposed hop), the in- and out-degree sums at d 1, and the loss's civil
and foreign readouts and their counts.  The GCN appends weight-1 self loops
and renormalises by the structural degrees of the (augmented) graph, as
``dgl``'s ``GraphConv(norm='both')`` does, then takes LayerNorm(eps 1e-12)
of the layer mean plus the (dropped) token table.

The loss: the batch users' own transition edges removed (a scatter-max),
three GCN views, two tower passes, agreement weights from three cosine
views, KL to sorted N(weight_mean, 0.1) draws, NCE contrasts weighted by
mainstream / personalisation weights, and an attention-fused cross entropy.

Draws: ``{adj,sim,aug}.emb_keep`` [n, d], ``.edge_keep`` [nnz],
``.loop_keep`` [n]; ``drop`` and ``drop_aug`` (the two tower passes);
``kl_normal`` [B].

On a mesh only the two tower passes run on the rank's slice of the batch.
The batch's users, last items, targets and lengths, and both passes'
outputs (with autograd), are gathered over ``data``; the removed edges are
the whole batch's users', and the three GCN views run on the whole item
graphs in every rank, so the whole loss (the scaled agreement and its
mean, the KL term's sort, ``personal``'s max, the in-batch NCE sums, the
cross entropy) is computed alike on every ``data`` rank, its ``kl_normal``
drawn whole.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from sslrec_tpu_torch.models import layers
from sslrec_tpu_torch.models.base import linear_layer
from sslrec_tpu_torch.models.sequential.base_seq import SequentialModel
from sslrec_tpu_torch.ops.sparse import CooGraph
from sslrec_tpu_torch.ops.spmm import spmm, spmm_t
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, build_csr_graph
from sslrec_tpu_torch.utils.initializers import linear_params, normal_init


def _l2rows(x, eps=1e-12):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


def build_graphs(seq_table: np.ndarray, n_items1: int, sim_k: int):
    """Host: ``((rows, cols, vals), (user_eids, user_emask), (sim_rows,
    sim_cols, sim_vals))``, numpy, the transition graph sorted by (row, col)."""
    seqs = np.asarray(seq_table)
    a = seqs[:, 1:].reshape(-1)
    b = seqs[:, :-1].reshape(-1)
    live = (a > 0) & (b > 0)
    pa = np.concatenate([a[live], b[live]])
    pb = np.concatenate([b[live], a[live]])
    adj = sp.coo_matrix((np.ones(len(pa)), (pa, pb)),
                        shape=(n_items1, n_items1)).tocsr()    # sums duplicates
    adj = adj.tolil()
    adj.setdiag(1.0)
    adj = adj.tocsr()
    deg = np.asarray(adj.sum(1)).reshape(-1)
    dinv = np.power(np.maximum(deg, 1e-12), -0.5)
    dinv[np.isinf(dinv)] = 0.0
    norm = (sp.diags(dinv) @ adj @ sp.diags(dinv)).tocoo()
    order = np.lexsort((norm.col, norm.row))
    rows, cols, vals = norm.row[order], norm.col[order], norm.data[order]
    codes = rows.astype(np.int64) * n_items1 + cols
    # each row's edge ids: both directions of every consecutive pair
    n_rows_seq = seqs.shape[0]
    ua, ub = seqs[:, 1:], seqs[:, :-1]
    pair_live = (ua > 0) & (ub > 0)
    user_eids = np.zeros((n_rows_seq, 2 * (seqs.shape[1] - 1)), np.int32)
    flat_codes = np.concatenate(
        [ua.astype(np.int64) * n_items1 + ub, ub.astype(np.int64) * n_items1 + ua], axis=1)
    flat_live = np.concatenate([pair_live, pair_live], axis=1)
    idx = np.clip(np.searchsorted(codes, flat_codes), 0, len(codes) - 1)
    found = (codes[idx] == flat_codes) & flat_live
    user_eids[found] = idx[found]

    # similarity: cosine of the item columns of the row-item incidence, the
    # top k+1 of each row's nonzeros (a zero can never enter with weight)
    ur = np.repeat(np.arange(n_rows_seq), seqs.shape[1])
    ic = seqs.reshape(-1)
    live2 = ic > 0
    inc = sp.coo_matrix((np.ones(live2.sum()), (ur[live2], ic[live2])),
                        shape=(n_rows_seq, n_items1)).tocsc()
    inc.data[:] = 1.0
    col_norm = np.sqrt(np.asarray(inc.multiply(inc).sum(0))).reshape(-1)
    simm = (inc.T @ inc).tocsr()
    nnz_rows = np.repeat(np.arange(n_items1), np.diff(simm.indptr))
    denom = col_norm[nnz_rows] * col_norm[simm.indices]
    simm.data = np.where(denom > 0, simm.data / np.maximum(denom, 1e-12), 0.0)
    k = min(sim_k + 1, n_items1)
    sim_rows_l, sim_cols_l, sim_vals_l = [], [], []
    indptr, indices, data = simm.indptr, simm.indices, simm.data
    for r in range(n_items1):
        lo, hi = indptr[r], indptr[r + 1]
        if lo == hi:
            continue
        d = data[lo:hi]
        keep = np.argpartition(-d, k - 1)[:k] if hi - lo > k else np.arange(hi - lo)
        w = d[keep]
        w = w / max(w.sum(), 1e-12)
        sim_rows_l.append(np.full(len(keep), r, np.int32))
        sim_cols_l.append(indices[lo:hi][keep])
        sim_vals_l.append(w)
    sim_rows = np.concatenate(sim_rows_l) if sim_rows_l else np.zeros(0, np.int32)
    sim_cols = np.concatenate(sim_cols_l) if sim_cols_l else np.zeros(0, np.int32)
    sim_vals = np.concatenate(sim_vals_l) if sim_vals_l else np.zeros(0)
    return ((rows.astype(np.int32), cols.astype(np.int32), vals.astype(np.float32)),
            (user_eids, found),
            (sim_rows.astype(np.int32), sim_cols.astype(np.int32),
             sim_vals.astype(np.float32)))


class ItemGraph:
    """One graph's edges on the device and its all-ones CSR layouts; the
    edges stay in the JAX package's order (sorted by row, then, where the
    builder sorts, by column), which is the layout's original edge order."""

    def __init__(self, triple, n: int, device):
        rows, cols, vals = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                            for a in triple)
        self.rows, self.cols, self.vals = rows.long(), cols.long(), vals
        self.g = build_csr_graph(CooGraph(rows=rows, cols=cols, vals=torch.ones_like(vals),
                                          n_rows=n, n_cols=n), device)
        self.nnz = int(vals.shape[0])

    def hop(self, x, w):
        """``out[r] = Σ_{row(e)=r} w[e]·x[col(e)]``, ``w`` constant."""
        return spmm(self.g, x, EdgeMask(w))

    def row_sum(self, w):
        """``Σ_{row(e)=r} w[e]`` (a d 1 hop of ones)."""
        return spmm(self.g, w.new_ones(self.g.n_cols, 1), EdgeMask(w))[:, 0]

    def col_sum(self, w):
        """``Σ_{col(e)=c} w[e]`` (the transposed layout)."""
        return spmm_t(self.g, w.new_ones(self.g.n_rows, 1), EdgeMask(w))[:, 0]


class DCRecSeq(SequentialModel):
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.weight_mean = float(m.weight_mean)
        self.kl_weight = float(m.kl_weight)
        self.cl_lambda = float(m.cl_lambda)
        self.cl_temp = float(m.cl_temp)
        self.graph_dropout = float(m.graph_dropout_prob)
        self.sim_k = int(m.sim_group_k)
        self.n_items1 = self.item_num + 1
        dev, n = self.device, self.n_items1
        adj, (eids, emask), sim = build_graphs(
            data.extras["user_seq_table"].cpu().numpy(), n, self.sim_k)
        self.adj, self.sim = ItemGraph(adj, n, dev), ItemGraph(sim, n, dev)
        self.user_eids = torch.from_numpy(eids).to(dev).long()
        self.user_emask = torch.from_numpy(emask).to(dev)
        uid_of_row = data.extras["user_seq_uids"].cpu().numpy()
        row_of_uid = np.zeros((self.user_num,), np.int64)
        row_of_uid[uid_of_row] = np.arange(uid_of_row.shape[0])   # the last row wins
        self.row_of_uid = torch.from_numpy(row_of_uid).to(dev)
        adj_t, _, sim_t = build_graphs(data.extras["test_seqs"].cpu().numpy(), n, self.sim_k)
        self.adj_test, self.sim_test = ItemGraph(adj_t, n, dev), ItemGraph(sim_t, n, dev)

        d = self.emb_size
        self.emb, self.layers = layers.tower_params(n, d, self.max_len, self.n_layers, dev)
        self.cl_fc1, self.cl_fc2 = linear_layer(d, d, dev), linear_layer(d, d, dev)
        self.attn_weights = nn.Parameter(torch.empty(d, d, device=dev))
        self.attn = nn.Parameter(torch.empty(1, d, device=dev))
        self.gcn_ln = layers.layer_norm_params(d, dev)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        layers.init_tower(gen, self.emb, self.layers)
        for lin in (self.cl_fc1, self.cl_fc2):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)
        for p in (self.attn_weights, self.attn):
            p.copy_(normal_init(gen, tuple(p.shape)))
        self.gcn_ln["scale"].fill_(1.0)
        self.gcn_ln["bias"].zero_()

    def hparams(self) -> dict:
        """The tune grid's scalars, which a batch's ``hp`` may override."""
        return {"cl_lambda": self.cl_lambda, "weight_mean": self.weight_mean}

    # -- the GCN ---------------------------------------------------------------
    def gcn(self, graph: ItemGraph, edge_scale=None, dr=None, name: str = ""):
        """Two weightless hops with self loops over ``graph`` (values times
        ``edge_scale`` where given), renormalised by the structural degrees;
        ``dr`` (training) drops the token table, edges and loops."""
        item_emb = self.emb["token"]
        if dr is not None:
            keep = dr.keep(f"{name}.emb_keep", 1.0 - self.dropout_rate, tuple(item_emb.shape))
            item_emb = layers.dropout_keep(item_emb, keep, self.dropout_rate)
        w, live = graph.vals, torch.ones_like(graph.vals)
        if edge_scale is not None:
            w, live = w * edge_scale, live * edge_scale
        dinv_in = (graph.row_sum(live) + 1.0) ** -0.5
        dinv_out = (graph.col_sum(live) + 1.0) ** -0.5
        we = w * dinv_out[graph.cols] * dinv_in[graph.rows]
        loop_w = dinv_out * dinv_in
        if dr is not None and self.graph_dropout > 0:
            p = 1.0 - self.graph_dropout
            we = torch.where(dr.keep(f"{name}.edge_keep", p, (graph.nnz,)), we, 0.0)
            loop_w = torch.where(dr.keep(f"{name}.loop_keep", p, (self.n_items1,)), loop_w, 0.0)
        x, acc = item_emb, item_emb
        for _ in range(2):
            x = graph.hop(x, we) + loop_w[:, None] * x
            acc = acc + x
        return layers.apply_layer_norm(self.gcn_ln, acc / 3.0 + item_emb, eps=1e-12)

    def _tower_last(self, seqs, drop=None):
        return layers.apply_transformer_tower(self.emb, self.layers, seqs, self.n_heads,
                                              drop)[:, -1]

    def _fuse(self, h, adj_last, sim_last):
        mixed = torch.stack([h, adj_last, sim_last], 0)
        weights = ((mixed @ self.attn_weights) * self.attn).sum(-1)
        return (mixed * torch.softmax(weights, dim=0)[:, :, None]).sum(0)

    def _vanilla_nce(self, z1, z2):
        s = torch.exp((_l2rows(z1) @ _l2rows(z2).T) / self.cl_temp)
        return -torch.log(1e-8 + torch.diagonal(s) / s.sum(1))

    # -- the objective -----------------------------------------------------------
    def loss(self, batch: dict, gen, draws: dict | None = None):
        hp = batch.get("hp", {})
        cl_lambda = hp.get("cl_lambda", self.cl_lambda)
        weight_mean = hp.get("weight_mean", self.weight_mean)
        seqs = batch["seq"]
        dr = self.step_draws(gen, draws, batch)
        # the whole batch's users, last items, targets and lengths
        cols = torch.stack([batch["user"].long(), seqs[:, -1].long(), batch["pos"].long(),
                            (seqs > 0).sum(1).long()], 1)
        uids, last, pos, lens = self.whole(cols, batch).unbind(1)

        srow = self.row_of_uid[uids]
        removed = torch.zeros(self.adj.nnz, device=seqs.device).scatter_reduce(
            0, self.user_eids[srow].reshape(-1), self.user_emask[srow].reshape(-1).float(),
            "amax")
        adj_emb = self.gcn(self.adj, None, dr, "adj")
        sim_emb = self.gcn(self.sim, None, dr, "sim")
        aug_emb = self.gcn(self.adj, 1.0 - removed, dr, "aug")
        adj_last, sim_last = layers.take_rows(adj_emb, last), layers.take_rows(sim_emb, last)
        h = self.whole(self._tower_last(seqs, dr.dropout("drop", self.dropout_rate)), batch)
        h_aug = self.whole(self._tower_last(seqs, dr.dropout("drop_aug", self.dropout_rate)),
                           batch)

        # neighbour readouts of the last items over the transition graph
        own = torch.zeros(self.n_items1, device=seqs.device)
        own[last] = 1.0
        edge_sel = own[self.adj.rows]

        def readout(w):
            summed = self.adj.hop(adj_emb, w)
            return layers.take_rows(summed / self.adj.row_sum(w).clamp(min=1.0)[:, None], last)

        civil_ro = readout(edge_sel * removed)
        foreign_ro = readout(edge_sel * (1.0 - removed))

        def cos(a, b):
            return (_l2rows(a) * _l2rows(b)).sum(-1)

        agreement = torch.sigmoid((cos(adj_last, layers.take_rows(aug_emb, last))
                                   + cos(adj_last, foreign_ro)
                                   + cos(civil_ro, foreign_ro)) / 3.0)
        agreement = (agreement - agreement.amin()) / (agreement.amax() - agreement.amin()
                                                      + 1e-12)
        agreement = (weight_mean / (agreement.mean() + 1e-12)) * agreement
        mainstream = torch.where(lens == 1, 0.5, agreement)

        expected = weight_mean + 0.1 * dr.normal("kl_normal", tuple(mainstream.shape))
        tgt = torch.log(torch.sort(expected).values.clamp(min=1e-8) + 1e-8)
        inp = torch.log_softmax(torch.sort(mainstream).values + 1e-8, dim=0)
        kl = self.kl_weight * (torch.exp(tgt) * (tgt - inp)).sum() / mainstream.shape[0]

        personal = mainstream.amax() - mainstream
        cl = (cl_lambda * (mainstream * self._vanilla_nce(h_aug, adj_last)
                           + personal * self._vanilla_nce(adj_last, sim_last))).mean()

        logits = self._fuse(h, adj_last, sim_last) @ self.emb["token"].T
        logp = torch.log_softmax(logits + 1e-8, -1)
        ce = -torch.gather(logp, 1, pos[:, None])[:, 0].mean()
        return ce + cl + kl, {"loss": ce, "cl_loss": cl, "kl_loss": kl}

    # -- evaluation ------------------------------------------------------------------
    def predict_context(self):
        return self.gcn(self.adj_test), self.gcn(self.sim_test)

    def encode_for_predict(self, seqs, ctx):
        adj_emb, sim_emb = ctx
        last = seqs[:, -1].long()
        return self._fuse(self._tower_last(seqs), adj_emb[last], sim_emb[last])

    def item_logits_params(self, ctx):
        w = self.emb["token"]
        return w, w.new_zeros(w.shape[0])
