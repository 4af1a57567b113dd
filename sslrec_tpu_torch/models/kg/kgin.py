"""KGIN: intent-disentangled relational path aggregation over the KG (port
of ``sslrec_tpu/models/kg/kgin.py``).

A hop takes, per KG edge, the tail's embedding times its relation's weight
and averages those into the heads (a masked segment mean); users sum their
interacted entities' embeddings through the row-normalised interact matrix,
modulated by the user → intent attention against ``softmax(disen_att) @
weight``.  The hops' L2-normalised outputs add to the ego tables.  Loss:
BPR as mean −logσ, ½L2 / B of the picked rows, and the intents'
independence term (distance correlation, cosine or mutual information).

Every reduction and endpoint gather's backward is B1, through
:class:`SegmentOps` over the heads, tails and the interact edges' rows and
columns, and :class:`OneHotTake` over the relations.  The uncapped KG
triplets are used, as in the JAX package.

Draws: the model sets ``step_generator``; :meth:`step_draws` draws node
dropout's masks (the KG edges kept with probability ``node_dropout_rate``,
as in the JAX package; the interact edges with ``1 - rate``) and each hop's
message-dropout masks from the epoch's device generator; a test injects
JAX's through ``loss``'s ``draws``.

Under ``train.mesh`` with a ``model`` axis of M > 1 each rank holds a
contiguous row shard of ``all_embed`` (``dist_train``'s fused-table
layout) and gathers the whole table with autograd.  The entities' KG mean
runs on the whole tables on every rank; the users' side is row-wise, so a
rank keeps only its users' rows (``U_loc``, cut out of the gathered
table), and the user ← entity interact hop runs graph-partitioned over the
``[users; entities]`` space (only user-destination edges, the node-dropped
values through ``view_vals_partitioned``, JAX's ``combine="last"``; the
entities through ``share_cotangent``).  The
batch's user rows come through ``owned_lookup``; ``latent_emb``,
``weight`` and ``disen_weight_att`` are replicated.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.segment_kernel import OneHotTake, SegmentOps
from sslrec_tpu_torch.ops.sparse import normalize_adj_left
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.utils.initializers import xavier_uniform


def _l2norm_rows(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def _relu0(x):
    """``max(x, 0)`` whose gradient at a tie is a half, as ``jnp.maximum``'s."""
    return torch.maximum(x, torch.zeros_like(x))


def distance_cor_sum(att: torch.Tensor) -> torch.Tensor:
    """``Σ_{i<j} dCor(att[i], att[j])``: the JAX package's per-pair distance
    correlation of the rows, computed for every pair at once (each row's
    double-centred distance matrix once, their pairwise sums as one
    contraction).  The distances' diagonal is exactly 0, where ``max(·, 0)``
    ties."""
    f, c = att.shape
    t = att[:, :, None]                                          # [F, c, 1]
    sq = t ** 2
    a = torch.sqrt(_relu0(sq - t @ t.transpose(1, 2) * 2 + sq.transpose(1, 2)) + 1e-8)
    A = a - a.mean(1, keepdim=True) - a.mean(2, keepdim=True) + a.mean((1, 2), keepdim=True)
    d = torch.sqrt(_relu0(torch.einsum("irs,jrs->ij", A, A) / c ** 2) + 1e-8)   # [F, F]
    diag = d.diagonal()
    i, j = torch.triu_indices(f, f, 1, device=att.device)
    return (d[i, j] / torch.sqrt(diag[i] * diag[j] + 1e-8)).sum()


def interact_edges(train_mat: sp.spmatrix, n_users: int, n_nodes: int):
    """The user → entity interact edges ``(rows, cols, vals)``, sorted by
    (row, col), of ``normalize_adj_left`` (no degree epsilon) taken over the
    ``[n_nodes, n_nodes]`` graph of the train pairs and cut to its user ×
    entity block."""
    trn = train_mat.tocoo()
    adj = sp.coo_matrix((np.ones(trn.nnz, np.float32), (trn.row, trn.col + n_users)),
                        shape=(n_nodes, n_nodes))
    norm = normalize_adj_left(adj, eps=0.0).tocsr()[:n_users, n_users:].tocoo()
    order = np.lexsort((norm.col, norm.row))
    return (norm.row[order].astype(np.int32), norm.col[order].astype(np.int32),
            norm.data[order].astype(np.float32))


class KGIN(RecModel):
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
        self.node_dropout = bool(m.node_dropout)
        self.node_dropout_rate = float(m.node_dropout_rate)
        self.mess_dropout = bool(m.mess_dropout)
        self.mess_dropout_rate = float(m.mess_dropout_rate)
        self.n_factors = int(m.n_factors)
        self.ind = str(m.ind)
        self.sim_decay = float(m.sim_regularity)
        self.temperature = 0.2

        trip = ex["kg_triplets_full"]
        self.n_kg = int(len(trip))
        self.rel_take = OneHotTake(trip[:, 1] - 1, self.n_relations - 1, device)
        self.seg_h = SegmentOps(trip[:, 0], self.n_entities, device)
        self.seg_t = SegmentOps(trip[:, 2], self.n_entities, device)
        rows, cols, vals = interact_edges(ex["train_mat_scipy"], self.user_num, self.n_nodes)
        self.seg_iu = SegmentOps(rows, self.user_num, device)
        self.seg_ic = SegmentOps(cols, self.n_entities, device)
        self.im_vals = torch.from_numpy(vals).to(device)
        self.mesh = mesh_from_config(cfg, device)
        self.sg = None
        if dist_train.model_sharded(self.mesh):
            self.row_shards = {"all_embed": self.n_nodes}
            _, self.sg = dist_train.maybe_partition_bi(
                cfg, rows.astype(np.int64), self.user_num + cols.astype(np.int64),
                self.user_num, self.n_entities, vals=vals, device=device)

        d = self.embedding_size

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.all_embed = param(dist_train.shard_rows(self.n_nodes, self.mesh), d)
        self.latent_emb = param(self.n_factors, d)
        self.weight = param(self.n_relations - 1, d)
        self.disen_weight_att = param(self.n_factors, self.n_relations - 1)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier for every parameter, from ``gen``."""
        self.all_embed.copy_(dist_train.own_rows(
            xavier_uniform(gen, (self.n_nodes, self.embedding_size)), self.all_embed.shape[0],
            self.mesh))
        for p in (self.latent_emb, self.weight, self.disen_weight_att):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def step_draws(self, gen: torch.Generator) -> dict:
        """Node dropout's KG edge mask (float) and interact keeps (bool), and
        per hop the entity and user message-dropout keeps (bool)."""
        dev, d = gen.device, self.embedding_size
        draws = {}
        if self.node_dropout:
            rate = self.node_dropout_rate
            draws["kg_mask"] = (torch.rand(self.n_kg, generator=gen, device=dev) < rate).float()
            draws["im_keep"] = torch.rand(self.im_vals.shape[0], generator=gen,
                                          device=dev) < 1 - rate
        if self.mess_dropout:
            keep = 1 - self.mess_dropout_rate
            draws["mess_keep"] = [
                (torch.rand(self.n_entities, d, generator=gen, device=dev) < keep,
                 torch.rand(self.user_num, d, generator=gen, device=dev) < keep)
                for _ in range(self.context_hops)]
        return draws

    def _hop(self, entity_emb, user_emb, rel_emb, cnt, kg_mask, im_vals):
        contrib = self.seg_t.take(entity_emb) * rel_emb
        if kg_mask is not None:
            contrib = contrib * kg_mask[:, None]
        entity_agg = self.seg_h.sum(contrib) / cnt[:, None]
        score = torch.softmax(user_emb @ self.latent_emb.T, dim=1)             # [U, F]
        if self.sg is not None:       # im_vals: the partitioned layout's [P, E_pad]
            sg, mesh = self.sg, self.mesh
            ents = dist_train.own_rows(dist_train.share_cotangent(entity_emb, mesh), sg.i_loc,
                                       mesh)
            user_agg, _ = dist_train.mesh_partitioned_propagate(
                mesh, sg, torch.zeros_like(user_emb), ents, im_vals, 1, "last")
        else:
            user_agg = self.seg_iu.sum(self.seg_ic.take(entity_emb) * im_vals[:, None])
        disen_w = torch.softmax(self.disen_weight_att, dim=-1) @ self.weight   # [F, d]
        user_agg = user_agg * (score @ disen_w) + user_agg
        return entity_agg, user_agg

    def _gcn(self, draws: dict | None):
        """Entity and user tables after the hops (this rank's users on a
        model-sharded mesh); ``draws`` None in evaluation."""
        draws = draws or {}
        emb = dist_train.whole_table(self.all_embed, self.n_nodes, self.mesh)
        user_emb = emb[: self.user_num]
        entity_emb = emb[self.user_num:]
        kg_mask, im_vals = None, self.im_vals
        if "kg_mask" in draws:
            kg_mask = draws["kg_mask"]
            im_vals = torch.where(draws["im_keep"], self.im_vals / (1 - self.node_dropout_rate),
                                  0.0)
        if self.sg is not None:
            user_emb = dist_train.own_rows(user_emb, self.sg.u_loc, self.mesh)
            im_vals = dist_train.view_vals_partitioned(self.sg, im_vals)
        # the relation rows and the heads' counts are the same every hop
        rel_emb = self.rel_take.take(self.weight)
        ones = torch.ones(self.n_kg, device=entity_emb.device)
        cnt = self.seg_h.sum(ones if kg_mask is None else kg_mask).clamp(min=1.0)
        ent_res, user_res = entity_emb, user_emb
        for hop in range(self.context_hops):
            entity_emb, user_emb = self._hop(entity_emb, user_emb, rel_emb, cnt, kg_mask, im_vals)
            if "mess_keep" in draws:
                keep_e, keep_u = draws["mess_keep"][hop]
                if self.sg is not None:
                    keep_u = dist_train.own_rows(keep_u, self.sg.u_loc, self.mesh)
                scale = 1 - self.mess_dropout_rate
                entity_emb = torch.where(keep_e, entity_emb / scale, 0.0)
                user_emb = torch.where(keep_u, user_emb / scale, 0.0)
            entity_emb, user_emb = _l2norm_rows(entity_emb), _l2norm_rows(user_emb)
            ent_res = ent_res + entity_emb
            user_res = user_res + user_emb
        return ent_res, user_res

    def _cor(self):
        att = self.disen_weight_att
        if self.ind == "mi":
            disen_t = att.T
            nt = disen_t / torch.sqrt((disen_t ** 2).sum(1, keepdim=True) + 1e-12)
            pos = torch.exp((nt * nt).sum(1) / self.temperature)
            ttl = torch.exp((disen_t @ att).sum(1) / self.temperature)
            return -torch.log(pos / ttl).sum()
        if self.ind == "distance":
            return distance_cor_sum(att)
        n = att / torch.sqrt((att ** 2).sum(1, keepdim=True) + 1e-12)
        i, j = torch.triu_indices(self.n_factors, self.n_factors, 1, device=att.device)
        return ((n @ n.T)[i, j] ** 2).sum()

    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """``draws`` (else from ``gen``) as :meth:`step_draws` returns them."""
        draws = self.step_draws(gen) if draws is None else draws
        ent, usr = self._gcn(draws)
        if self.sg is None:
            u_e = usr[batch["user"]]
        else:
            u_e = dist_train.owned_lookup(usr, batch["user"], self.sg.u_loc, self.mesh)
        p_e, n_e = ent[batch["pos"]], ent[batch["neg"]]
        mf = -F.logsigmoid((u_e * p_e).sum(1) - (u_e * n_e).sum(1)).mean()
        reg = self.decay * ((u_e ** 2).sum() + (p_e ** 2).sum() + (n_e ** 2).sum()) \
            / 2.0 / u_e.shape[0]
        cor = self.sim_decay * self._cor()
        return mf + reg + cor, {"rec_loss": mf, "reg_loss": reg, "cor": cor}

    def generate(self):
        ent, usr = self._gcn(None)
        if self.sg is not None:
            usr = dist_train.whole_rows(usr, self.user_num, self.mesh)
        return usr, ent[: self.item_num]
