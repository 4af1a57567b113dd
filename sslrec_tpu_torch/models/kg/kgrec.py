"""KGRec: rationale-aware KG recommendation, an attentive KG GNN with
attention-guided MAE edge masking and a cross-view contrast (port of
``sslrec_tpu/models/kg/kgrec.py``).

- The shared hop: two-head edge attention ``q·(k ⊙ rel) / √d_k`` between a
  head's and a tail's projected embeddings, a segment softmax per head over
  the heads' edges and the attention-weighted sum of ``tail ⊙ rel``; users
  sum their interacted entities through the row-normalised interact edges;
  each hop's L2-normalised output adds to the ego tables.
- Per step: half the KG edges live; rationale scores from the live edges'
  (detached) mean-head attention, a masked segment softmax rescaled by the
  heads' live degree; the MAE mask is the Gumbel top-``mae_msize`` of the
  live scores plus as many uniform edge ids, and the encoder runs on the
  live edges outside it; the MAE decoder scores the masked edges.  The
  contrast compares a UI tower over a Gumbel top-k of the interactions by
  their items' mean attention with a KG tower over the top-attention edges.

B2 (the segment max) shifts the rationale softmax and each head's fused
attention; B1 carries every segment sum and the backward of every endpoint
gather (:class:`SegmentOps` over the heads, the tails and the interact
edges' users and items, :class:`OneHotTake` over the relations).  The
uncapped KG triplets are used, as in the JAX package.

Ties: the top-k is a stable descending sort, so equal scores (−inf among
them) keep the lower edge id first, as ``lax.top_k``; the thresholds are
values of a sort, which ties do not change.

Draws: the model sets ``step_generator``; :meth:`step_draws` draws every
mask, uniform, edge id and permutation of a step from the epoch's device
generator; a test injects JAX's through ``loss``'s ``draws``.

Under ``train.mesh`` with a ``model`` axis of M > 1 each rank holds a
contiguous row shard of ``all_embed`` (``dist_train``'s fused-table
layout) and gathers the whole table with autograd.  The encoder, the
rationale scores, their top-k and the KG tower run over the whole KG on
every rank, as one device runs them, with the single run's draws; the UI
tower runs graph-partitioned over the bidirectional interact edges (the
rationale weights as ``[ui_w; ui_w]`` through ``view_vals_partitioned``,
one ``combine="last"`` hop at a time), and its item rows are gathered back
whole for the contrast.  ``relation_emb``, ``w_q`` and the contrast's MLPs
are replicated.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.segment_kernel import OneHotTake, SegmentOps
from sslrec_tpu_torch.ops.sparse import normalize_adj_left
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform


def _l2norm_rows(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms, with the JAX package's epsilons."""
    return -torch.log(-torch.log(u + 1e-12))


def top_k_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """The ids of the ``k`` largest entries, largest first and, among equal
    values, the lower id first (``lax.top_k``'s order)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """``sort(x)[-k]``: the ``k``-th largest value."""
    return torch.sort(x).values[-k]


class KGRec(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        ex, device = data.extras, data.device
        self.n_relations = ex["relation_num"]
        self.n_entities = ex["entity_num"]
        self.n_nodes = ex["node_num"]
        self.decay = float(m.decay_weight)
        self.context_hops = int(m.layer_num)
        self.node_dropout_rate = float(m.node_dropout_rate)
        self.mess_dropout = bool(m.mess_dropout)
        self.mess_dropout_rate = float(m.mess_dropout_rate)
        self.mae_coef = float(m.mae_coef)
        self.mae_msize = int(m.mae_msize)
        self.cl_coef = float(m.cl_coef)
        self.tau = float(m.tau)
        self.cl_drop = float(m.cl_drop_ratio)
        self.n_heads = 2

        trip = ex["kg_triplets_full"]
        self.n_kg = int(len(trip))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

        self.kg_heads, self.kg_rels, self.kg_tails = t(trip[:, 0]), t(trip[:, 1]), t(trip[:, 2])
        # the row-normalised interact edges, sorted by (user, item)
        ui = normalize_adj_left(ex["train_mat_scipy"]).tocoo()
        order = np.lexsort((ui.col, ui.row))
        ie_u, ie_i = ui.row[order], ui.col[order]
        self.ie_w = torch.from_numpy(ui.data[order].astype(np.float32)).to(device)
        self.ie_i = t(ie_i)
        self.n_ui = int(ui.nnz)

        self.rel_take = OneHotTake(trip[:, 1] - 1, self.n_relations - 1, device)
        self.seg_h = SegmentOps(trip[:, 0], self.n_entities, device)
        self.seg_t = SegmentOps(trip[:, 2], self.n_entities, device)
        self.seg_ieu = SegmentOps(ie_u, self.user_num, device)
        self.seg_iei = SegmentOps(ie_i, self.item_num, device)
        self.seg_ie_ent = SegmentOps(ie_i, self.n_entities, device)
        self.mesh = mesh_from_config(cfg, device)
        self.sg = None
        if dist_train.model_sharded(self.mesh):
            self.row_shards = {"all_embed": self.n_nodes}
            u = self.user_num
            _, self.sg = dist_train.maybe_partition_bi(
                cfg, np.concatenate([ie_u, u + ie_i]), np.concatenate([u + ie_i, ie_u]), u,
                self.item_num, device=device)

        d = self.embedding_size

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.all_embed = param(dist_train.shard_rows(self.n_nodes, self.mesh), d)
        self.relation_emb = param(self.n_relations - 1, d)
        self.w_q = param(d, d)
        self.cl_mlp1 = nn.ModuleList([linear_layer(d, d, device) for _ in range(2)])
        self.cl_mlp2 = nn.ModuleList([linear_layer(d, d, device) for _ in range(2)])

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and query weight, ``nn.Linear``-default MLPs, from ``gen``."""
        d = self.embedding_size
        self.all_embed.copy_(dist_train.own_rows(xavier_uniform(gen, (self.n_nodes, d)),
                                                 self.all_embed.shape[0], self.mesh))
        for p in (self.relation_emb, self.w_q):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))
        for lin in (*self.cl_mlp1, *self.cl_mlp2):
            for k, v in linear_params(gen, d, d).items():
                lin[k].copy_(v)

    # -- draws ---------------------------------------------------------------
    def step_draws(self, gen: torch.Generator) -> dict:
        """One step's draws: the live KG edges (float), the MAE's Gumbel
        uniforms and random edge ids, the interact keeps (float), per hop the
        entity and user message-dropout keeps (bool), the UI view's Gumbel
        uniforms, and the contrast's permutation of the items."""
        dev, d = gen.device, self.embedding_size
        keep = 1 - self.node_dropout_rate

        def rand(*shape):
            return torch.rand(*shape, generator=gen, device=dev)

        draws = {"live": (rand(self.n_kg) < keep).float(),
                 "mae_u": rand(self.n_kg),
                 "rand_ids": torch.randint(0, self.n_kg, (self.mae_msize,), generator=gen,
                                           device=dev),
                 "ie_mask": (rand(self.n_ui) < keep).float()}
        if self.mess_dropout:
            mkeep = 1 - self.mess_dropout_rate
            draws["mess_keep"] = [(rand(self.n_entities, d) < mkeep, rand(self.user_num, d) < mkeep)
                                  for _ in range(self.context_hops)]
        draws["ui_u"] = rand(self.n_ui)
        draws["perm"] = torch.randperm(self.item_num, generator=gen, device=dev)
        return draws

    # -- attention -----------------------------------------------------------
    def _attn_logits(self, head_emb, tail_emb, rel_emb):
        dk = self.embedding_size // self.n_heads
        q = (head_emb @ self.w_q).reshape(-1, self.n_heads, dk)
        k = (tail_emb @ self.w_q).reshape(-1, self.n_heads, dk)
        k = k * rel_emb.reshape(-1, self.n_heads, dk)
        return (q * k).sum(-1) / dk ** 0.5                   # [n_kg, heads]

    def _norm_attn(self, entity_emb, rel_emb, live, head_live):
        """Rationale scores: the mean-head logits, a segment softmax over the
        live edges, times the live edge and its head's live degree."""
        logits = self._attn_logits(self.seg_h.take(entity_emb), self.seg_t.take(entity_emb),
                                   rel_emb).mean(-1)
        masked = torch.where(live > 0, logits, -1e9)
        return self.seg_h.softmax(masked) * live * head_live[self.kg_heads]

    def _shared_agg(self, entity_emb, rel_emb, kg_mask, ie_w):
        dk = self.embedding_size // self.n_heads
        tail_emb = self.seg_t.take(entity_emb)
        logits = self._attn_logits(self.seg_h.take(entity_emb), tail_emb, rel_emb)
        logits = torch.where((kg_mask > 0)[:, None], logits, -1e9)
        value = (tail_emb * rel_emb).reshape(-1, self.n_heads, dk)
        entity_agg = torch.cat([self.seg_h.attn(logits[:, i], value[:, i, :], kg_mask)
                                for i in range(self.n_heads)], -1)
        user_agg = self.seg_ieu.sum(ie_w[:, None] * self.seg_ie_ent.take(entity_emb))
        return entity_agg, user_agg

    def embed(self) -> torch.Tensor:
        """The whole ``all_embed`` with autograd (gathered from the row shards
        on a model-sharded mesh)."""
        return dist_train.whole_table(self.all_embed, self.n_nodes, self.mesh)

    def _gcn(self, emb, rel_emb, kg_mask, ie_mask, mess_keep=None):
        user_emb = emb[: self.user_num]
        entity_emb = emb[self.user_num:]
        ie_w = self.ie_w * ie_mask / (1 - self.node_dropout_rate)
        ent_res, usr_res = entity_emb, user_emb
        for hop in range(self.context_hops):
            entity_emb, user_emb = self._shared_agg(entity_emb, rel_emb, kg_mask, ie_w)
            if mess_keep is not None:
                keep_e, keep_u = mess_keep[hop]
                scale = 1 - self.mess_dropout_rate
                entity_emb = torch.where(keep_e, entity_emb / scale, 0.0)
                user_emb = torch.where(keep_u, user_emb / scale, 0.0)
            entity_emb, user_emb = _l2norm_rows(entity_emb), _l2norm_rows(user_emb)
            ent_res = ent_res + entity_emb
            usr_res = usr_res + user_emb
        return ent_res, usr_res

    # -- auxiliary towers ----------------------------------------------------
    def _forward_ui(self, emb, ui_w):
        user_emb = emb[: self.user_num]
        item_emb = emb[self.user_num: self.user_num + self.item_num]
        if self.sg is not None:
            sg, mesh = self.sg, self.mesh
            user_emb = dist_train.own_rows(user_emb, sg.u_loc, mesh)
            item_emb = item_res = dist_train.own_rows(item_emb, sg.i_loc, mesh)
            pv = dist_train.view_vals_partitioned(sg, torch.cat([ui_w, ui_w]))
            for _ in range(self.context_hops):
                u_agg, i_agg = dist_train.mesh_partitioned_propagate(
                    mesh, sg, user_emb, item_emb, pv, 1, "last")
                user_emb, item_emb = _l2norm_rows(u_agg), _l2norm_rows(i_agg)
                item_res = item_res + item_emb
            return dist_train.gather_whole(item_res, self.item_num, mesh)
        item_res = item_emb
        for _ in range(self.context_hops):
            u_agg = self.seg_ieu.sum(ui_w[:, None] * self.seg_iei.take(item_emb))
            i_agg = self.seg_iei.sum(ui_w[:, None] * self.seg_ieu.take(user_emb))
            user_emb, item_emb = _l2norm_rows(u_agg), _l2norm_rows(i_agg)
            item_res = item_res + item_emb
        return item_res

    def _forward_kg(self, emb, rel_emb, kg_mask):
        entity_emb = emb[self.user_num:]
        res = entity_emb
        cnt = self.seg_h.sum(kg_mask).clamp(min=1.0)[:, None]
        for _ in range(self.context_hops):
            agg = self.seg_h.sum(self.seg_t.take(entity_emb) * rel_emb * kg_mask[:, None]) / cnt
            entity_emb = _l2norm_rows(agg)
            res = res + entity_emb
        return res[: self.item_num]

    def _contrast(self, z1, z2, perm):
        def mlp(ps, x):
            return apply_linear(ps[1], F.relu(apply_linear(ps[0], x)))

        h1 = _l2norm_rows(mlp(self.cl_mlp1, z1))
        h2 = _l2norm_rows(mlp(self.cl_mlp2, z2))

        def f(x):
            return torch.exp(x / self.tau)

        between = f((h1 * h2).sum(-1))
        neg = f((h1 * h2[perm]).sum(-1)) + f((h2 * h1[perm]).sum(-1))
        return (-torch.log(between / (2 * between + neg) + 1e-12)).mean()

    # -- loss ----------------------------------------------------------------
    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """Rec (mean −logσ) + ½L2 / B + MAE + contrast; ``draws`` (else from
        ``gen``) as :meth:`step_draws` returns them."""
        draws = self.step_draws(gen) if draws is None else draws
        user, pos, neg = batch["user"], batch["pos"], batch["neg"]
        live = draws["live"]
        # one relation take serves every use: its backward is one B1 sum
        rel_emb = self.rel_take.take(self.relation_emb)
        emb = self.embed()

        with torch.no_grad():
            head_live = self.seg_h.sum(live)
            attn_score = self._norm_attn(emb[self.user_num:], rel_emb, live, head_live)
            am1 = self.seg_h.sum(attn_score) / head_live.clamp(min=1.0)
            am2 = self.seg_t.sum(attn_score) / self.seg_t.sum(live).clamp(min=1.0)
            am1 = torch.where(am1 == 0.0, 1.0, am1)
            am2 = torch.where(am2 == 0.0, 1.0, am2)
            item_attn_mean = (0.5 * am1 + 0.5 * am2)[: self.item_num]

            noisy = torch.where(live > 0, attn_score + gumbel(draws["mae_u"]), float("-inf"))
            mae_ids = torch.cat([top_k_ids(noisy, self.mae_msize), draws["rand_ids"].long()])
            mae_mask = torch.zeros(self.n_kg, device=live.device)
            mae_mask[mae_ids] = 1.0
            enc_mask = live * (1.0 - mae_mask)

        ent_emb, usr_emb = self._gcn(emb, rel_emb, enc_mask, draws["ie_mask"],
                                     draws.get("mess_keep"))
        u_e, p_e, n_e = usr_emb[user], ent_emb[pos], ent_emb[neg]
        mf = -F.logsigmoid((u_e * p_e).sum(1) - (u_e * n_e).sum(1)).mean()
        reg = self.decay * ((u_e ** 2).sum() + (p_e ** 2).sum() + (n_e ** 2).sum()) \
            / 2.0 / u_e.shape[0]

        # MAE reconstruction of the masked edges
        mh, mt = self.kg_heads[mae_ids], self.kg_tails[mae_ids]
        mrel = self.relation_emb[self.kg_rels[mae_ids] - 1]
        mae = self.mae_coef * (-torch.log(torch.sigmoid(
            (ent_emb[mt] * mrel * ent_emb[mh]).sum(1)) + 1e-12)).mean()

        # contrast: the top-attention KG view against a Gumbel top-k UI view
        with torch.no_grad():
            k_keep = int((1 - self.cl_drop) * self.n_kg)
            thresh = kth_largest(torch.where(live > 0, attn_score, float("-inf")), k_keep)
            cl_kg_mask = ((attn_score >= thresh) & (live > 0)).float()
            ui_logits = item_attn_mean[self.ie_i] + gumbel(draws["ui_u"])
            ui_th = kth_largest(ui_logits, int((1 - self.cl_drop) * self.n_ui))
            cl_ui_mask = (ui_logits >= ui_th).float()
            ui_w = self.ie_w * draws["ie_mask"] / (1 - self.node_dropout_rate)
            ui_w = ui_w * cl_ui_mask / (1 - self.cl_drop)
        item_ui = self._forward_ui(emb, ui_w)
        item_kg = self._forward_kg(emb, rel_emb, cl_kg_mask)
        cl = self.cl_coef * self._contrast(item_ui, item_kg, draws["perm"])
        return mf + reg + mae + cl, {"rec_loss": mf, "mae_loss": mae, "cl_loss": cl}

    @torch.no_grad()
    def generate(self):
        ones = torch.ones(self.n_kg, device=self.all_embed.device)
        ie_mask = torch.ones(self.n_ui, device=self.all_embed.device) * (1 - self.node_dropout_rate)
        ent, usr = self._gcn(self.embed(), self.rel_take.take(self.relation_emb), ones, ie_mask)
        return usr, ent[: self.item_num]
