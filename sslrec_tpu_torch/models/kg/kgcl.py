"""KGCL — knowledge-graph contrastive learning with KG-stability-guided
UI-graph augmentation (port of ``sslrec_tpu/models/kg/kgcl.py``).

- RGAT over (head, relation, tail) edges: per-edge logit
  ``leaky_relu(⟨fc([h;t]), rel⟩)`` → per-head segment softmax → weighted tail
  aggregation (:meth:`SegmentOps.attn`: B2's max, then one B1 sum of
  ``[d+1]`` columns), message dropout, L2-normalised rows; the last hop is
  the entity embedding.
- UI propagation: ``layer_num`` B1 hops over the normalised bi-adjacency
  whose per-view values ride as a constant :class:`EdgeMask`; the mean of the
  layers.
- Per epoch (:meth:`epoch_state`): two 50% KG edge samples → entity
  stability (cosine) → per-item keep weights → two Bernoulli UI-edge views.
- Loss: BPR (sum) + decay·½L2/B + InfoNCE over the two views' forwards.
- ``model.train_trans``: the trainer's TransE sub-loop after each epoch
  (:meth:`KGCL.kg_loss` on batches of the full triplets, an Adam of its own).

Every random draw is a method of its own (:meth:`step_draws`,
:meth:`epoch_draws`) apart from the arithmetic, which takes the draws as
inputs, so tests can inject them.  Draws come from a ``torch.Generator`` on
the run's device.

Under ``train.mesh`` with a ``model`` axis of M > 1 each rank holds a
contiguous row shard of ``all_embed`` (``dist_train``'s fused-table
layout).  Every rank gathers the whole table with autograd and runs the
RGAT over the whole KG with the single run's draws (they are over whole
tables); the UI propagation runs graph-partitioned
(``mesh_partitioned_propagate``, the views' values through
``view_vals_partitioned``) from the rank's user and item rows cut out of
the gathered table (the RGAT's through ``share_cotangent``, so that its
backward takes the whole cotangent), and gives this rank's rows.  The
batch's rows come through ``owned_lookup``; InfoNCE's denominators read
the second view's whole tables, gathered back with autograd.  The relation
table and the RGAT's weights are replicated (the trainer sums their
gradients over ``model``).  Its BPR and InfoNCE are sums over the batch, so
a ``data`` slice scales them by the whole batch over the slice, which its
share then cancels; the L2 term is already a mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.models.layers import take_rows
from sslrec_tpu_torch.ops.segment_kernel import OneHotTake, SegmentOps
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.utils.initializers import normal_init, xavier_uniform


def _l2norm_rows(x):
    # sqrt(sum + eps), not F.normalize's clamped norm: keeps the gradient
    # finite at exactly-zero rows, as the JAX package does
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-12)


class KGCL(RecModel):
    mesh_todo = None
    step_generator = True       # the trainer hands loss() a device generator

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.train_trans = bool(m.get("train_trans", False))
        self.n_relations = data.extras["relation_num"]
        self.n_entities = data.extras["entity_num"]
        self.n_nodes = data.extras["node_num"]
        self.heads = data.extras["kg_heads"]
        self.bi = data.extras["bi_adj_maskable"]

        self.tau = float(m.get("tau", 0.2))
        self.cl_weight = float(m.get("cl_weight", 0.1))
        self.mu = float(m.get("mu", 0.95))
        self.decay = float(m.decay_weight)
        self.context_hops = int(m.layer_num_kg)
        self.layer_num = int(m.layer_num)
        self.node_dropout = bool(m.node_dropout)
        self.node_dropout_rate = float(m.node_dropout_rate)
        self.mess_dropout = bool(m.mess_dropout)
        self.mess_dropout_rate = float(m.mess_dropout_rate)
        device = data.device
        self.seg_h = SegmentOps(self.heads, self.n_entities, device)
        self.seg_t = SegmentOps(data.extras["kg_tails"], self.n_entities, device)
        self.rel_take = OneHotTake(data.extras["kg_rels"], self.n_relations, device)

        self.mesh = mesh_from_config(cfg, device)
        self.sg = None
        if dist_train.model_sharded(self.mesh):
            self.row_shards = {"all_embed": self.n_nodes}
            g = self.bi.graph
            _, self.sg = dist_train.maybe_partition_bi(cfg, g.rows, g.cols, self.user_num,
                                                       self.item_num, device=device)
        d = self.embedding_size

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.all_embed = param(dist_train.shard_rows(self.n_nodes, self.mesh), d)
        self.relation_embed = param(self.n_relations, d)
        self.rgat_w = param(d, d)           # unused by the forward, as in JAX
        self.rgat_a = param(2 * d, 1)       # unused by the forward, as in JAX
        self.rgat_fc = nn.ParameterDict({"w": param(2 * d, d), "b": param(d)})

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """The JAX package's initialisers, drawn in its order from ``gen``."""
        self.all_embed.copy_(dist_train.own_rows(
            normal_init(gen, (self.n_nodes, self.embedding_size), 0.1),
            self.all_embed.shape[0], self.mesh))
        self.relation_embed.copy_(normal_init(gen, tuple(self.relation_embed.shape), 0.1))
        self.rgat_w.copy_(xavier_uniform(gen, tuple(self.rgat_w.shape)) * 1.414)
        self.rgat_a.copy_(xavier_uniform(gen, tuple(self.rgat_a.shape)) * 1.414)
        self.rgat_fc["w"].copy_(xavier_uniform(gen, tuple(self.rgat_fc["w"].shape)))
        self.rgat_fc["b"].zero_()

    # -- random draws -------------------------------------------------------
    def step_draws(self, gen: torch.Generator) -> dict:
        """One training step's draws on ``gen``'s device: node-dropout keeps
        over the rect UI edges and the KG edges, and per-hop message-dropout
        keeps ``[hops, n_entities, d]``."""
        draws = {}
        if self.node_dropout:
            keep = 1 - self.node_dropout_rate
            draws["rect_keep"] = (torch.rand(self.bi.nnz_rect, generator=gen,
                                             device=gen.device) < keep).float()
            draws["kg_keep"] = (torch.rand(self.heads.shape[0], generator=gen,
                                           device=gen.device) < keep).float()
        if self.mess_dropout:
            shape = (self.context_hops, self.n_entities, self.embedding_size)
            draws["mess_keep"] = torch.rand(shape, generator=gen, device=gen.device) \
                < 1 - self.mess_dropout_rate
        return draws

    def epoch_draws(self, gen: torch.Generator) -> dict:
        """One epoch's view draws: two 50% KG edge masks and the uniforms
        that decide each rect UI edge's Bernoulli keep in the two views."""
        n_kg, n_rect, dev = self.heads.shape[0], self.bi.nnz_rect, gen.device
        return {"kg_mask1": (torch.rand(n_kg, generator=gen, device=dev) < 0.5).float(),
                "kg_mask2": (torch.rand(n_kg, generator=gen, device=dev) < 0.5).float(),
                "view_u1": torch.rand(n_rect, generator=gen, device=dev),
                "view_u2": torch.rand(n_rect, generator=gen, device=dev)}

    # -- RGAT ---------------------------------------------------------------
    def _hop_inputs(self, x):
        """A hop's tail embeddings and raw logits from node embeddings ``x``.
        Hop 0's depend only on the entity table, so the loss's three forwards
        share them (``hop0``)."""
        out_t = self.seg_t.take(x)
        a_in = torch.cat([self.seg_h.take(x), out_t], dim=-1)
        proj = a_in @ self.rgat_fc["w"] + self.rgat_fc["b"]
        rel = self.rel_take.take(self.relation_embed)
        return out_t, F.leaky_relu((proj * rel).sum(dim=-1), 0.2)

    def _rgat(self, entity_emb, edge_mask=None, mess_keep=None, hop0=None):
        out = entity_emb
        for hop in range(self.context_hops):
            out_t, logits = hop0 if hop == 0 and hop0 is not None else self._hop_inputs(out)
            if edge_mask is not None:
                logits = torch.where(edge_mask > 0, logits, -1e9)
            # the mask multiplies numerator and denominator: a fully masked
            # head aggregates to exact zeros
            agg = self.seg_h.attn(logits, out_t, edge_mask)
            if mess_keep is not None:
                agg = torch.where(mess_keep[hop], agg / (1 - self.mess_dropout_rate), 0.0)
            out = _l2norm_rows(agg)
        return out

    # -- UI propagation -----------------------------------------------------
    def embed(self) -> torch.Tensor:
        """The whole ``all_embed`` with autograd (gathered from the row shards
        on a model-sharded mesh)."""
        return dist_train.whole_table(self.all_embed, self.n_nodes, self.mesh)

    def _ui_prop(self, users, entity_emb, adj_vals):
        if self.sg is not None:
            sg, mesh = self.sg, self.mesh
            return dist_train.mesh_partitioned_propagate(
                mesh, sg, dist_train.own_rows(users, sg.u_loc, mesh),
                dist_train.own_rows(dist_train.share_cotangent(entity_emb[: self.item_num], mesh),
                                    sg.i_loc, mesh),
                dist_train.view_vals_partitioned(sg, adj_vals), self.layer_num, "mean")
        all_emb = torch.cat([users, entity_emb[: self.item_num]])
        acc = all_emb
        for _ in range(self.layer_num):
            all_emb = spmm(self.bi.graph, all_emb, EdgeMask(adj_vals))
            acc = acc + all_emb
        mean = acc / (self.layer_num + 1)
        return mean[: self.user_num], mean[self.user_num:]

    def forward(self, kg_mask=None, adj_vals=None, mess_keep=None, hop0=None, emb=None):
        """The users' and items' tables (this rank's rows of them on a
        model-sharded mesh); ``emb`` the whole ``all_embed`` where the caller
        has it (:meth:`embed`)."""
        emb = self.embed() if emb is None else emb
        entity_emb = self._rgat(emb[self.user_num:], edge_mask=kg_mask, mess_keep=mess_keep,
                                hop0=hop0)
        if adj_vals is None:
            adj_vals = self.bi.view_vals(torch.ones(self.bi.nnz_rect, device=emb.device))
        return self._ui_prop(emb[: self.user_num], entity_emb, adj_vals)

    def _rows(self, table, idx, n_loc):
        """Rows ``idx`` of a :meth:`forward` table (through ``owned_lookup``
        from the shards on a model-sharded mesh)."""
        if self.sg is None:
            return table[idx]
        return dist_train.owned_lookup(table, idx, n_loc, self.mesh)

    # -- per-epoch view generation (trainer hook) ---------------------------
    @torch.no_grad()
    def keep_probs(self, kg_mask1, kg_mask2):
        """Per-rect-edge keep probability: the stability weight of its item."""
        entity_emb = self.embed()[self.user_num:]
        v1 = _l2norm_rows(self._rgat(entity_emb, edge_mask=kg_mask1)[: self.item_num])
        v2 = _l2norm_rows(self._rgat(entity_emb, edge_mask=kg_mask2)[: self.item_num])
        s = torch.exp((v1 * v2).sum(dim=-1))
        w = (s - s.min()) / (s.max() - s.min() + 1e-12)
        w = w.clamp(min=0.3)
        w = (self.mu / w.mean() * w).clamp(max=0.95)
        return w[self.bi.rect_item_ids]

    @torch.no_grad()
    def epoch_state(self, gen: torch.Generator | None, epoch: int = 0,
                    draws: dict | None = None) -> dict:
        """The epoch's two augmented views, passed to :meth:`loss` as
        ``batch["aux"]``, new every epoch; ``draws`` (else drawn from ``gen``)
        as :meth:`epoch_draws` returns them."""
        draws = self.epoch_draws(gen) if draws is None else draws
        p = self.keep_probs(draws["kg_mask1"], draws["kg_mask2"])
        return {"kg_mask1": draws["kg_mask1"], "kg_mask2": draws["kg_mask2"],
                "ui_vals1": self.bi.view_vals((draws["view_u1"] < p).float()),
                "ui_vals2": self.bi.view_vals((draws["view_u2"] < p).float())}

    # -- loss ---------------------------------------------------------------
    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """``draws`` (else drawn from ``gen``) as :meth:`step_draws` returns them."""
        draws = self.step_draws(gen) if draws is None else draws
        aux = batch["aux"]
        user, pos, neg = batch["user"], batch["pos"], batch["neg"]
        adj_vals = kg_keep = None
        if self.node_dropout:
            adj_vals = self.bi.view_vals(draws["rect_keep"]) / (1 - self.node_dropout_rate)
            kg_keep = draws["kg_keep"]

        emb = self.embed()
        hop0 = self._hop_inputs(emb[self.user_num:])
        user_emb, item_emb = self.forward(kg_mask=kg_keep, adj_vals=adj_vals,
                                          mess_keep=draws.get("mess_keep"), hop0=hop0, emb=emb)
        u_loc, i_loc = (None, None) if self.sg is None else (self.sg.u_loc, self.sg.i_loc)
        u_e = self._rows(user_emb, user, u_loc)
        pos_e, neg_e = self._rows(item_emb, pos, i_loc), self._rows(item_emb, neg, i_loc)
        # the sums over a data slice, scaled to the whole batch (1 off a mesh)
        scale = batch.get("n_whole", u_e.shape[0]) / u_e.shape[0]
        rec = losses.bpr_loss(u_e, pos_e, neg_e) * scale
        reg = 0.5 * ((u_e ** 2).sum() + (pos_e ** 2).sum() + (neg_e ** 2).sum()) \
            / u_e.shape[0]

        u1, i1 = self.forward(kg_mask=aux["kg_mask1"], adj_vals=aux["ui_vals1"], hop0=hop0,
                              emb=emb)
        u2, i2 = self.forward(kg_mask=aux["kg_mask2"], adj_vals=aux["ui_vals2"], hop0=hop0,
                              emb=emb)
        u2 = dist_train.whole_table(u2, self.user_num, self.mesh)
        i2 = dist_train.whole_table(i2, self.item_num, self.mesh)
        cl = self.cl_weight * scale * (
            self._infonce_overall(self._rows(u1, user, u_loc), u2[user], u2)
            + self._infonce_overall(self._rows(i1, pos, i_loc), i2[pos], i2))
        loss = rec + self.decay * reg + cl
        return loss, {"rec_loss": rec, "cl_loss": cl}

    def _infonce_overall(self, z1, z2, z_all):
        """Cosine-similarity InfoNCE, sum-reduced."""
        z1n, z2n, zan = _l2norm_rows(z1), _l2norm_rows(z2), _l2norm_rows(z_all)
        between = torch.exp((z1n * z2n).sum(dim=-1) / self.tau)
        denom = torch.exp(z1n @ zan.T / self.tau).sum(dim=1)
        return (-torch.log(between / denom + 1e-12)).sum()

    # -- TransE objective (the trainer's sub-loop when train_trans) ----------
    def kg_loss(self, h, r, pos_t, neg_t):
        """Squared TransE distances on the entity rows of ``all_embed``:
        mean ``-log σ(neg - pos)`` plus 1e-3 × the four mean half-squared norms."""
        ent = self.embed()[self.user_num:]
        r_e = take_rows(self.relation_embed, r)
        h_e, p_e, n_e = take_rows(ent, h), take_rows(ent, pos_t), take_rows(ent, neg_t)
        pos_score = ((h_e + r_e - p_e) ** 2).sum(1)
        neg_score = ((h_e + r_e - n_e) ** 2).sum(1)
        kg = (-F.logsigmoid(neg_score - pos_score)).mean()
        l2 = sum(((x ** 2).sum(1) / 2.0).mean() for x in (h_e, r_e, p_e, n_e))
        return kg + 1e-3 * l2

    def generate(self):
        users, items = self.forward()
        if self.sg is None:
            return users, items
        return (dist_train.whole_rows(users, self.user_num, self.mesh),
                dist_train.whole_rows(items, self.item_num, self.mesh))
