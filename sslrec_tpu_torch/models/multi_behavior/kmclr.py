"""KMCLR: CML's multi-behavior GCN coupled with a knowledge-graph LightGCN
whose items come from a relation-aware GAT, and KG-guided contrastive views
(port of ``sslrec_tpu/models/multi_behavior/kmclr.py``).

- MB side: CML's :class:`~sslrec_tpu_torch.models.multi_behavior.cml.BehaviorGCN`
  and :class:`~sslrec_tpu_torch.models.multi_behavior.cml.BehaviorSampler`;
  two rounds a batch under one Adam (clip 20 on the global norm, then Adam
  at ``optimizer.lr``): BPR per behavior + ``weight_decay``·L2 +
  ``beta``·CML's InfoNCE (user side, no NaN guard), the second round on
  ``0.9·MB users + 0.1·`` the KG side's users, held constant.  The Adam
  holds the MB side alone: optax's holds the KG side too, but takes only
  zero gradients there, so its moments stay zero and its updates are
  exactly zero.
- KG side (``kg``): two item, entity and relation tables, ``transR_W``,
  ``TATEC_W`` and the GAT's layers.  An item's embedding is a relation GAT
  over its padded entity list (the first 32 of its triplets in file order;
  pad entity and relation index = their count; an item with no triplet
  attends uniformly to the pad entity's row, as in the JAX package); the
  lists' entity and relation gathers are :class:`TakeFn`s over the lists'
  segment layouts, so their backward is a B1 segment sum (the pad row
  takes most of the lists' slots; autograd's scatter of an index spent
  over half of the epoch's device time on it); the
  users and the mean of both GATs' items go through LightGCN (3 layers,
  the mean of the layers) over the buy matrix's :class:`MaskableBiAdj`
  under a view's values, its hops B1 with the values as a constant.
- :meth:`KMCLR.epoch_state` trains the KG side with its own Adam (kept
  across epochs, like the JAX package's, outside the train state), in four
  parts, each timed on the host clock into ``hook_s``:

  1. ``trans_epoch``: ``n_triplets // 4096`` batches (of ``min(4096,
     n_triplets)`` triplets drawn with replacement and one rejected
     negative tail each), each one TransR step then one TATEC step;
  2. ``make_views``: per view a keep mask over the buy edges with
     probabilities in [0.6, 1] from the users' softmax over the items times
     the items' stability under two entity dropouts (rate ``kg_p_drop``);
     the ``[U × I]`` logits and softmax are made without gradient and
     freed at once;
  3. ``bpr_contrast``: ``n_buy // bpr_batch_size`` steps of BPR over the buy
     pairs plus the two views' contrast, stepping the KG side with the KG
     Adam (the JAX package's stated deviation from the reference's no-op);
  4. ``get_all``: the KG users, which the steps mix in.

  The Adam steps every KG parameter, a zero gradient where a loss does not
  reach one, as optax does (``TATEC_W`` moves during a TransR step once it
  has momentum).  The hook updates the KG parameters in place, so the steps
  use them as the JAX ``train_step`` adopts the hook's.

Under ``train.mesh`` (the JAX package's ``kmclr.py:121-144`` and
``:244-256``), on a ``model`` axis of M > 1: the MB side runs as CML's
(row-sharded ``mb.user_emb`` and ``mb.item_emb``, one partitioned
bidirectional hop a behavior and layer, the outputs read whole); the two
rounds gather the whole batch over ``data`` and run it as CML's rounds do
(the InfoNCE's sampled users cross the batch), each round's gradients
summed (``sync_model_grads`` of ``mb.``) before the clip, whose norm is
``dist_train.global_norm`` over the ranks' row shards; ``kg_user`` is whole
on every rank.  The KG side's ``user``, ``item`` and ``entity`` tables are
row-sharded too, the relation tables, ``transR_W``, ``TATEC_W`` and the GAT
replicated.  The epoch hook runs alike on every rank, with the epoch
generator's draws, over the whole KG side (:meth:`KMCLR.kg_tables`, a gather
with autograd): TransR/TATEC, the relation GAT (its entity lists' gather
whole), the views' ``[U × I]`` softmax; the buy bi-adjacency's LightGCN
runs graph-partitioned (``dist_train.maybe_partition_bi``, a view's values
through ``view_vals_partitioned``, ``combine="mean"``) from the rank's
users and its rows of the GAT's items, which pass ``share_cotangent``
(every rank computes them alike), and its outputs are read whole.  Each KG
step backpropagates the loss over ``M`` and sums the replicated
gradients over ``model`` (``sync_model_grads(..., data=False)``: every
``data`` rank runs the same steps), so that the KG tables and the KG
Adam's moments, row shards for the sharded tables, are the single run's.

Draws by name (:class:`StepDraws`; a test gives them): a step's sampler
draws as CML's and ``perm``; the hook's ``trip{s}`` and ``trip_neg{s}``
(TransR/TATEC batch ``s``), ``view{v}.m1`` / ``view{v}.m2`` (entity keep
masks ``[I, cap]``) and ``view{v}.keep_u`` (uniforms over the buy edges,
kept below their probability), ``bpr{s}`` and ``bpr_neg{s}``.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.data.kg import MaskableBiAdj
from sslrec_tpu_torch.data.sampling import sample_negatives
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.models.multi_behavior.cml import (BehaviorGCN, BehaviorSampler,
                                                        partition_behaviors, ssl_terms,
                                                        ssl_users)
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.segment_kernel import TakeFn, build_segment_layout
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.trainer.trainer import clip_grad_global_norm
from sslrec_tpu_torch.utils.initializers import linear_params, normal_init, xavier_uniform

KG_BATCH = 4096
ENTITY_CAP = 32


def _l2rows(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def item_entity_lists(trip: np.ndarray, item_num: int, n_entities: int, n_relations: int):
    """Each item's first ``cap`` (tail, relation) pairs in file order, padded
    with ``n_entities`` / ``n_relations``: ``cap`` is the longest head's count
    (heads past the items included), at most ``ENTITY_CAP``."""
    h = trip[:, 0]
    order = np.argsort(h, kind="stable")
    hs = h[order]
    starts = np.searchsorted(hs, hs, side="left")
    rank = np.arange(hs.size) - starts
    cap = min(int(np.bincount(hs).max()) if hs.size else 1, ENTITY_CAP)
    keep = (rank < cap) & (hs < item_num)
    ents = np.full((item_num, cap), n_entities, np.int64)
    rels = np.full((item_num, cap), n_relations, np.int64)
    ents[hs[keep], rank[keep]] = trip[order[keep], 2]
    rels[hs[keep], rank[keep]] = trip[order[keep], 1]
    return ents, rels, cap


class KGParams(nn.Module):
    """The KG side's parameters under the JAX package's names (on a
    model-sharded ``mesh`` this rank's row shards of ``user``, ``item`` and
    ``entity``)."""

    def __init__(self, n_users, n_items, n_entities, n_relations, d, device, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.rows = {"user": n_users, "item": n_items, "entity": n_entities + 1}

        def table(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        def shard(n):
            return table(dist_train.shard_rows(n, mesh), d)

        self.user = shard(n_users)
        self.item = nn.ParameterList([shard(n_items) for _ in range(2)])
        self.entity = nn.ParameterList([shard(n_entities + 1) for _ in range(2)])
        self.relation = nn.ParameterList([table(n_relations + 1, d) for _ in range(2)])
        self.transR_W = table(n_relations + 1, d, d)
        self.TATEC_W = table(n_relations + 1, d, d)
        self.gat_fc = linear_layer(3 * d, 1, device)
        self.gat_out = linear_layer(d, d, device)

    def row_shards(self, prefix: str) -> dict:
        """The sharded tables' whole rows by parameter name under ``prefix``."""
        return {f"{prefix}user": self.rows["user"],
                **{f"{prefix}{k}.{i}": self.rows[k] for k in ("item", "entity") for i in range(2)}}

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        for k, ps in (("user", [self.user]), ("item", self.item), ("entity", self.entity)):
            for p in ps:
                p.copy_(dist_train.own_rows(normal_init(gen, (self.rows[k], p.shape[1]), 0.1),
                                            p.shape[0], self.mesh))
        for p in self.relation:
            p.copy_(normal_init(gen, tuple(p.shape), 0.1))
        for p in (self.transR_W, self.TATEC_W):
            p.copy_(xavier_uniform(gen, tuple(p.shape)) * np.sqrt(2.0))
        for lin in (self.gat_fc, self.gat_out):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)


class KMCLR(RecModel):
    mesh_todo = None
    step_generator = True
    batch_fields = ("user", "pos")

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m, t, dev = cfg.model, cfg.train, data.device
        self.device = dev
        graphs = data.extras["behavior_graphs"]
        mats = data.extras["behavior_mats_scipy"]
        self.n_beh = len(graphs)
        self.emb = int(m.embedding_size)
        self.beta = float(m.get("beta", 0.005))
        self.ipm = float(m.get("inner_product_mult", 1.0))
        self.ssl_batch = int(t.get("SSL_batch", 30))
        self.batch_size = int(t.batch_size)
        self.wd = float(cfg.optimizer.get("weight_decay", 0) or 1e-4)
        latent = int(m.get("latent_dim_rec", self.emb))
        self.kg_layers = int(m.get("lightGCN_n_layers", 3))
        self.kg_p_drop = float(m.get("kg_p_drop", 0.5))
        self.kgc_temp = float(m.get("kgc_temp", 0.2))
        self.kg_lr = float(m.get("kg_lr", 1e-3))
        self.bpr_bsz = int(m.get("bpr_batch_size", 2048))
        self.kg_decay = float(m.get("decay", 1e-4))
        self.ssl_reg = 0.1

        trip = data.extras.get("kg_triplets")
        if trip is None:
            trip = np.zeros((1, 3), np.int64)
        trip = np.asarray(trip, np.int64)
        self.n_entities = int(max(trip[:, 2].max(initial=0), trip[:, 0].max(initial=0)) + 1)
        self.n_relations = int(trip[:, 1].max(initial=0) + 1)
        ents, rels, self.kg_cap = item_entity_lists(trip, self.item_num, self.n_entities,
                                                    self.n_relations)
        self.item_ents = torch.from_numpy(ents).to(dev)
        self.item_rels = torch.from_numpy(rels).to(dev)
        self.ent_lay = build_segment_layout(ents.reshape(-1), self.n_entities + 1, dev)
        self.rel_lay = build_segment_layout(rels.reshape(-1), self.n_relations + 1, dev)
        self.kg_trip = torch.from_numpy(trip).to(dev)
        ht = sp.coo_matrix((np.ones(len(trip), np.float32), (trip[:, 0], trip[:, 2])),
                           shape=(max(self.n_entities, self.item_num), self.n_entities))
        self.kg_edge_set = sparse_ops.build_edge_set(ht, device=dev)
        n_trip = trip.shape[0]
        self.kg_bsz = min(KG_BATCH, max(n_trip, 1))
        self.n_trans = max(n_trip // self.kg_bsz, 1)

        buy = mats[-1].tocoo()
        self.buy_rows = torch.from_numpy(buy.row.astype(np.int64)).to(dev)
        self.buy_cols = torch.from_numpy(buy.col.astype(np.int64)).to(dev)
        self.n_buy = int(buy.nnz)
        self.n_bpr = max(self.n_buy // self.bpr_bsz, 1)
        self.bi = MaskableBiAdj(buy, self.user_num, self.item_num, dev)
        self._ones_vals: dict = {}
        self.buy_edge_set = sparse_ops.build_edge_set(buy, device=dev)

        self.mesh, sgs = partition_behaviors(cfg, graphs, self.user_num, self.item_num, dev)
        self.sg_bi = None
        if sgs is not None:
            g = self.bi.graph
            self.sg_bi = dist_train.maybe_partition_bi(cfg, g.rows, g.cols, self.user_num,
                                                       self.item_num, device=dev)[1]
        self.mb = BehaviorGCN(graphs, self.user_num, self.item_num, self.emb,
                              int(m.layer_num), dev, self.mesh, sgs)
        self.kg = KGParams(self.user_num, self.item_num, self.n_entities, self.n_relations,
                           latent, dev, self.mesh)
        if sgs is not None:
            self.row_shards = {"mb.user_emb": self.user_num, "mb.item_emb": self.item_num,
                               **self.kg.row_shards("kg.")}
        self.sampler = BehaviorSampler(mats, self.item_num, dev)
        self.opt_model = torch.optim.Adam(self.mb.parameters(), lr=float(cfg.optimizer.lr),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.opt_kg = None          # the KG Adam, made by the first epoch_state
        self.hook_s: dict[str, float] = {}

    def optimizers(self) -> dict:
        """The MB side's Adam, which checkpoints save (the KG Adam is not in
        the train state, as in the JAX package)."""
        return {"model": self.opt_model}

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        self.mb.init(gen)
        self.kg.init(gen)
        self.opt_kg = None

    # -- the KG side ----------------------------------------------------------
    def kg_whole(self, name: str) -> torch.Tensor:
        """The KG side's table ``name`` (``user``, ``item.0`` … ``entity.1``),
        whole, with autograd (gathered from the row shards on a model-sharded
        mesh)."""
        return dist_train.whole_table(self.kg.get_parameter(name),
                                      self.kg.rows[name.split(".")[0]], self.mesh)

    def kg_tables(self, *names: str) -> dict:
        """:meth:`kg_whole` of ``names`` (default every sharded table) by name."""
        return {n: self.kg_whole(n)
                for n in names or ("user", "item.0", "item.1", "entity.0", "entity.1")}

    def rgat_items(self, index: int, ent_mask: torch.Tensor | None = None,
                   tables: dict | None = None) -> torch.Tensor:
        """Items through the relation GAT of table set ``index`` (0 or 1) over
        their entity lists, ``ent_mask`` [I, cap] dropping entities;
        ``tables``: :meth:`kg_tables` where the caller has them."""
        kg = self.kg
        if tables is None:
            tables = self.kg_tables(f"item.{index}", f"entity.{index}")
        item_embs = tables[f"item.{index}"]
        shape = (*self.item_ents.shape, item_embs.shape[1])
        ents = TakeFn.apply(self.ent_lay, tables[f"entity.{index}"]).view(shape)   # [I, cap, d]
        rels = TakeFn.apply(self.rel_lay, kg.relation[index]).view(shape)
        live = self.item_ents != self.n_entities
        if ent_mask is not None:
            live = live & ent_mask
        wh = item_embs[:, None, :].expand_as(ents)
        e = F.leaky_relu(apply_linear(kg.gat_fc, torch.cat([wh, rels, ents], -1))[..., 0], 0.2)
        e = torch.where(live, e, torch.full_like(e, -9e15))
        att = torch.softmax(e, dim=1)
        agg = (att[..., None] * ents).sum(1)
        return F.relu(apply_linear(kg.gat_out, agg + item_embs))

    def bi_propagate(self, items, adj_vals):
        """The mean of LightGCN's layers from the KG users and ``items`` over
        the buy bi-adjacency under the constant values ``adj_vals``; returns
        (users, items), whole.  On a model-sharded mesh the hops are
        partitioned, from this rank's users and its rows of ``items`` (which
        every rank computes alike: ``share_cotangent``), and their outputs
        gathered."""
        if self.sg_bi is not None:
            sg, mesh = self.sg_bi, self.mesh
            users, its = dist_train.mesh_partitioned_propagate(
                mesh, sg, self.kg.user,
                dist_train.own_rows(dist_train.share_cotangent(items, mesh), sg.i_loc, mesh),
                dist_train.view_vals_partitioned(sg, adj_vals), self.kg_layers, "mean")
            return (dist_train.whole_table(users, self.user_num, mesh),
                    dist_train.whole_table(its, self.item_num, mesh))
        acc = [torch.cat([self.kg.user, items], 0)]
        for _ in range(self.kg_layers):
            acc.append(spmm(self.bi.graph, acc[-1], EdgeMask(adj_vals)))
        out = sum(acc) / (self.kg_layers + 1)
        return out[: self.user_num], out[self.user_num:]

    def ones_vals(self) -> torch.Tensor:
        """The all-ones view's values, in the parameters' dtype, made once (a
        segment sum on B1)."""
        dtype = self.kg.user.dtype
        if dtype not in self._ones_vals:
            with torch.no_grad():
                self._ones_vals[dtype] = self.bi.view_vals(
                    torch.ones(self.bi.nnz_rect, dtype=dtype, device=self.device))
        return self._ones_vals[dtype]

    def kg_computer(self, tables: dict | None = None):
        tables = self.kg_tables() if tables is None else tables
        items = (self.rgat_items(0, tables=tables) + self.rgat_items(1, tables=tables)) / 2.0
        return self.bi_propagate(items, self.ones_vals())

    def trans_loss(self, h, r, pos_t, neg_t, index: int, mode: str):
        """TransR (``mode == "transR"``) or TATEC on one batch of triplets with
        negative tails, with table set ``index``, + 1e-3·L2."""
        kg = self.kg
        items, ents = self.kg_whole(f"item.{index}"), self.kg_whole(f"entity.{index}")
        r_e = F.embedding(r, kg.relation[index])[:, :, None]
        h_e = F.embedding(h.clamp(0, self.item_num - 1), items)[:, :, None]
        p_e = F.embedding(pos_t, ents)[:, :, None]
        n_e = F.embedding(neg_t, ents)[:, :, None]
        d = r_e.shape[1]
        if mode == "transR":
            w = F.embedding(r, kg.transR_W.view(-1, d * d)).view(-1, d, d)
            hh, pp, nn_ = w @ h_e, w @ p_e, w @ n_e
            pos = ((hh + r_e - pp) ** 2).sum(1)
            neg = ((hh + r_e - nn_) ** 2).sum(1)
            extra = torch.sqrt((kg.transR_W ** 2).sum() + 1e-12)
        else:
            w = F.embedding(r, kg.TATEC_W.view(-1, d * d)).view(-1, d, d)
            pos = ((h_e * (w @ p_e)).sum(1) + (h_e * r_e).sum(1) + (p_e * r_e).sum(1)
                   + (h_e * p_e).sum(1))
            neg = ((h_e * (w @ n_e)).sum(1) + (h_e * r_e).sum(1) + (n_e * r_e).sum(1)
                   + (h_e * n_e).sum(1))
            extra = torch.sqrt((kg.TATEC_W ** 2).sum() + 1e-12)
        kg_l = (-F.logsigmoid((neg - pos)[:, 0])).mean()
        l2 = sum(((x[..., 0] ** 2).sum(1) / 2.0).mean() for x in (h_e, r_e, p_e, n_e)) + extra
        return kg_l + 1e-3 * l2

    def _kg_step(self, loss) -> torch.Tensor:
        """One KG Adam step on ``loss``; every KG parameter steps.  On a mesh
        every rank computes the same ``loss`` (the module's docstring): it is
        backpropagated over the ``model`` axis, and the replicated
        parameters' gradients summed over ``model``."""
        params = list(self.kg.parameters())
        for p in params:
            p.grad = None
        if self.mesh is None:
            loss.backward()
        else:
            dist_train.mesh_backward(loss, self.mesh, 1.0)
            dist_train.sync_model_grads(self, self.mesh, "kg.", data=False)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt_kg.step()
        return loss.detach()

    def trans_epoch(self, dr: StepDraws) -> None:
        n_trip = self.kg_trip.shape[0]
        for s in range(self.n_trans):
            idx = dr.randint(f"trip{s}", 0, n_trip, (self.kg_bsz,)).long()
            h, r, t = self.kg_trip[idx].unbind(1)
            negs = dr.draw(f"trip_neg{s}", lambda: sample_negatives(
                dr.gen, h, self.kg_edge_set, self.n_entities)).long()
            for index, mode in enumerate(("transR", "TATEC")):
                self._kg_step(self.trans_loss(h, r, t, negs, index, mode))

    @torch.no_grad()
    def make_views(self, dr: StepDraws) -> list[torch.Tensor]:
        """The two views' values over the bi-adjacency."""
        views = []
        p_keep = 1 - self.kg_p_drop
        shape = tuple(self.item_ents.shape)
        tables = self.kg_tables()
        for index in range(2):
            v1 = self.rgat_items(index, dr.keep(f"view{index}.m1", p_keep, shape), tables)
            v2 = self.rgat_items(index, dr.keep(f"view{index}.m2", p_keep, shape), tables)
            stability = (_l2rows(v1) * _l2rows(v2)).sum(-1)
            sm = torch.softmax(tables["user"] @ tables[f"item.{index}"].T, dim=-1)    # [U, I]
            w = sm[self.buy_rows, self.buy_cols] * stability[self.buy_cols]
            del sm
            k = (1 - 0.6) / (w.max() - w.min() + 1e-12)
            probs = 0.6 + k * (w - w.min())
            # float32 whatever the parameters' dtype, as the JAX package's mask
            keep = (dr.uniform(f"view{index}.keep_u", (self.n_buy,)) < probs).float()
            views.append(self.bi.view_vals(keep))
        return views

    def contrast_loss(self, users, poss, negs, views):
        kg = self.kg_tables()
        au, ai = self.kg_computer(kg)
        pos_s = (F.embedding(users, au) * F.embedding(poss, ai)).sum(1)
        neg_s = (F.embedding(users, au) * F.embedding(negs, ai)).sum(1)
        main = F.softplus(-(pos_s - neg_s)).sum()
        reg = 0.5 * ((F.embedding(users, kg["user"]) ** 2).sum()
                     + (F.embedding(poss, kg["item.0"]) ** 2).sum()
                     + (F.embedding(poss, kg["item.1"]) ** 2).sum()
                     + (F.embedding(negs, kg["item.0"]) ** 2).sum()
                     + (F.embedding(negs, kg["item.1"]) ** 2).sum()) \
            / users.shape[0] * self.kg_decay
        u1, i1 = self.bi_propagate(self.rgat_items(0, tables=kg), views[0])
        u2, i2 = self.bi_propagate(self.rgat_items(1, tables=kg), views[1])

        def semi(z1, z2):
            f = torch.exp(_l2rows(z1) @ _l2rows(z2).T / self.kgc_temp)
            diag = torch.diagonal(f)
            return (-torch.log(diag / (f.sum(1) - diag) + 1e-12)).sum()

        ssl = (semi(F.embedding(users, u1), F.embedding(users, u2))
               + semi(F.embedding(poss, i1), F.embedding(poss, i2))) * self.ssl_reg
        return main + reg + ssl

    def bpr_contrast(self, dr: StepDraws, views) -> None:
        for s in range(self.n_bpr):
            idx = dr.randint(f"bpr{s}", 0, self.n_buy, (self.bpr_bsz,)).long()
            users, poss = self.buy_rows[idx], self.buy_cols[idx]
            negs = dr.draw(f"bpr_neg{s}", lambda: sample_negatives(
                dr.gen, users, self.buy_edge_set, self.item_num)).long()
            self._kg_step(self.contrast_loss(users, poss, negs, views))

    def epoch_state(self, gen, epoch: int, draws: dict | None = None) -> dict:
        """Train the KG side (TransR/TATEC, views, BPR + contrast) and return
        the KG users ``{"kg_user": [U, d]}`` the epoch's steps mix in."""
        dr = StepDraws(gen, draws, self.device)
        if self.opt_kg is None:
            self.opt_kg = torch.optim.Adam(self.kg.parameters(), lr=self.kg_lr,
                                           betas=(0.9, 0.999), eps=1e-8)
        t0 = time.perf_counter()
        marks = []

        def mark():
            if self.item_ents.is_cuda:
                torch.cuda.synchronize()
            marks.append(time.perf_counter())

        self.trans_epoch(dr)
        mark()
        views = self.make_views(dr)
        mark()
        self.bpr_contrast(dr, views)
        mark()
        with torch.no_grad():
            kg_user = self.kg_computer()[0]
        mark()
        self.hook_s = {k: b - a for k, a, b in zip(
            ("trans_epoch", "make_views", "bpr_contrast", "get_all"), [t0, *marks], marks)}
        return {"kg_user": kg_user}

    # -- the two-round step -----------------------------------------------------------
    def _round(self, users, pos_l, neg_l, valid_l, perm, user_mix=None):
        ue, ie, ues = self.mb()
        if user_mix is not None:
            ue = 0.9 * ue + 0.1 * user_mix
        ue_u = F.embedding(users, ue)
        beh = []
        for pos, neg, valid in zip(pos_l, neg_l, valid_l):
            pi = (ue_u * F.embedding(pos, ie)).sum(1) * self.ipm
            pj = (ue_u * F.embedding(neg, ie)).sum(1) * self.ipm
            beh.append((-torch.log(torch.sigmoid(pi - pj) + 1e-8) * valid).sum())
        info = [c.sum() for c in ssl_terms(ssl_users(perm, users), ues, self.emb,
                                            self.ssl_batch)]
        bpr = sum(beh) / self.n_beh
        nce = sum(info) / self.n_beh
        reg = ((ue_u ** 2).sum() + (F.embedding(pos_l[-1], ie) ** 2).sum()
               + (F.embedding(neg_l[-1], ie) ** 2).sum())
        return (bpr + self.wd * reg + self.beta * nce) / self.batch_size, bpr, nce

    def train_step(self, batch: dict, gen, draws: dict | None = None) -> dict:
        dr = StepDraws(gen, draws, self.device)
        # on a data slice, the whole batch (the module's docstring)
        n = batch.get("n_whole", batch["user"].shape[0])
        users, pos = (dist_train.gather_batch(batch[k].long(), n, self.mesh)
                      for k in ("user", "pos"))
        pos_l, neg_l, valid_l = self.sampler.sample(dr, "", users, pos)
        perm = dr.permutation("perm", users.shape[0])
        out = []
        for mix in (None, batch["aux"]["kg_user"]):
            self.opt_model.zero_grad(set_to_none=True)
            loss, bpr, nce = self._round(users, pos_l, neg_l, valid_l, perm, mix)
            if self.mesh is None:
                loss.backward()
            else:
                dist_train.mesh_backward(loss, self.mesh, batch["share"])
                dist_train.sync_model_grads(self, self.mesh, "mb.")
            clip_grad_global_norm(self.mb.parameters(), 20.0,
                                  dist_train.global_norm(self, self.mesh, "mb."))
            self.opt_model.step()
            out.append((loss.detach(), bpr.detach(), nce.detach()))
        (l1, b1, n1), (l2, b2, n2) = out
        return {"loss": l1 + l2, "bpr_loss": b1 + b2, "infonce_loss": n1 + n2}

    def generate(self):
        ue, ie, _ = self.mb()
        return ue, ie
