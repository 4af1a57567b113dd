"""SMBRec: per-behavior GCN towers with a contrast over co-interacting users
(port of ``sslrec_tpu/models/multi_behavior/smbrec.py``).

- One :class:`~sslrec_tpu_torch.models.multi_behavior.hmgcr.GCNTower` per
  behavior (two B1 hops a layer); users fused by a softmax over behaviors
  of ``beh_weights · degree``, then ``user_trans``; items by ``cat_trans``
  over the towers side by side.
- Loss: BPR (sum) + ``cl_weight``·CL + ``reg_weight``·L2 of the picked
  rows; both weights ride ``tune.parallel``'s lanes (``hparams()``).  CL,
  per behavior: every user in blocks of 128 anchors (the last block
  wrapping to the first users, as the JAX package pads), each anchor
  ``sample_num_pos`` co-interacting users drawn with replacement from its
  row of the target behavior's ``M Mᵀ`` (itself where the row is empty); a
  block's term is the sum of ``-log(exp(sim/τ) + 1e-8)`` over its
  [640 × 640] anchor × positive matrix less that of the anchor × anchor
  one.  All blocks run as one batched product.

Draws by name (:class:`StepDraws`): per behavior ``b`` ``co_u{b}`` [users
padded to 128, sample_num_pos] uniforms, the offsets into the co-rows.

Under ``train.mesh`` with a ``model`` axis of M > 1 the towers run as
HMGCR's (row-sharded tables, graph-partitioned chained pairs, outputs read
whole through ``dist_train.whole_table``); the fusion runs on this rank's
rows (``user_trans``, ``cat_trans`` and ``beh_weights`` are replicated), and
the prediction tables are read whole.  Every rank computes each
behavior's contrast whole, alike, with the single run's co-user draws: it
sums some 10^7 terms of either sign to a total thousands of times smaller,
so that splitting its blocks over the ``model`` group, whose ranks' parts
then meet in other float sums, moved an item table by twice Adam's step
after one epoch of a small Tmall-shaped split (a near-zero gradient entry
flipping its sign), where the alike computation stays within the single
run's float rounding; its
backward reaches the gathered tables whole on every rank, and
``mesh_backward``'s division by ``M`` undoes the gather's sum of their
cotangents.  BPR and the L2 of the picked rows are sums over the batch,
scaled on a ``data`` slice to the whole batch (the share cancels it); every
``data`` rank computes the whole contrast, weighted by its share.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.data.sampling import sample_from_rows
from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.models.multi_behavior.hmgcr import GCNTower, mesh_towers, tower_shards
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params

BLOCK = 128


class SMBRec(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m, ex, dev = cfg.model, data.extras, data.device
        self.device = dev
        self.graphs = ex["behavior_graphs"]
        self.n_beh = len(self.graphs)
        self.layer_num = int(m.layer_num)
        self.tau = float(m.tau)
        self.cl_weight = float(m.cl_weight)
        self.reg_weight = float(m.reg_weight)
        self.samp_pos = int(m.sample_num_pos)
        self.co_indptr = ex["co_user_indptr"].long()
        self.co_indices = ex["co_user_indices"].long()
        self.mesh, self.sgs = mesh_towers(cfg, self.graphs, self.user_num, self.item_num, dev)
        if self.sgs is not None:
            self.row_shards = tower_shards(self.n_beh, self.user_num, self.item_num)
        # [n_beh, users]: this rank's users on a model-sharded mesh
        self.beh_degrees = dist_train.own_rows(
            ex["beh_degrees"].T, dist_train.shard_rows(self.user_num, self.mesh), self.mesh).T
        d = self.embedding_size
        self.towers = nn.ModuleList([GCNTower(self.user_num, self.item_num, d, self.layer_num, dev,
                                              self.mesh)
                                     for _ in self.graphs])
        self.cat_trans = linear_layer(self.n_beh * d, d, dev)
        self.user_trans = linear_layer(d, d, dev)
        self.beh_weights = nn.Parameter(torch.empty(self.n_beh, device=dev))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """The towers, then ``cat_trans`` and ``user_trans`` (``nn.Linear``'s
        default), in the JAX package's order; ``beh_weights`` ones."""
        for tower in self.towers:
            tower.init(gen)
        for lin in (self.cat_trans, self.user_trans):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)
        self.beh_weights.fill_(1.0)

    def forward(self):
        """The prediction tables and each behavior's users, whole (gathered
        with autograd from this rank's rows on a model-sharded mesh)."""
        sgs = self.sgs or [None] * self.n_beh
        embeds = [tower(a, at, sg) for tower, (a, at), sg in zip(self.towers, self.graphs, sgs)]
        users = torch.stack([u for u, _ in embeds])         # [n_beh, U, d]
        items = torch.cat([i for _, i in embeds], 1)
        w = torch.softmax(self.beh_weights[:, None, None] * self.beh_degrees[:, :, None], 0)
        user_emb = apply_linear(self.user_trans, (w * users).sum(0))
        item_emb = apply_linear(self.cat_trans, items)
        whole = [dist_train.whole_table(t, n, self.mesh) for t, n in
                 ((user_emb, self.user_num), (item_emb, self.item_num),
                  *((u, self.user_num) for u, _ in embeds))]
        return whole[0], whole[1], whole[2:]

    def sample_co_users(self, u: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        """Each anchor's co-users at the uniform offsets ``u`` [n, S]; an
        empty co-row gives the anchor itself."""
        cols, deg = sample_from_rows(self.co_indptr, self.co_indices, anchors, u)
        return torch.where((deg > 0)[:, None], cols, anchors[:, None])

    def contrast(self, u: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        n = embed.shape[0]
        en = embed / torch.sqrt((embed * embed).sum(-1, keepdim=True) + 1e-12)
        anchors = torch.arange(n + (-n) % BLOCK, device=embed.device) % n
        pos = self.sample_co_users(u, anchors).reshape(-1, BLOCK * self.samp_pos)
        rows = anchors.repeat_interleave(self.samp_pos).reshape(-1, BLOCK * self.samp_pos)
        er = en[rows]

        def neglog_sim(a, b):
            return -torch.log(torch.exp(a @ b.transpose(1, 2) / self.tau) + 1e-8)

        return (neglog_sim(er, en[pos]) - neglog_sim(er, er)).sum()

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight, "cl_weight": self.cl_weight}

    def loss(self, batch: dict, gen, draws: dict | None = None):
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        cl_w = hp.get("cl_weight", self.cl_weight)
        dr = StepDraws(gen, draws, self.device)
        ancs, poss, negs = batch["user"].long(), batch["pos"].long(), batch["neg"].long()
        user_emb, item_emb, beh_users = self.forward()
        anc_e, pos_e, neg_e = user_emb[ancs], item_emb[poss], item_emb[negs]
        # sums over the batch: on a data slice, scaled to the whole batch
        scale = batch.get("n_whole", ancs.shape[0]) / ancs.shape[0]
        bpr = losses.bpr_loss(anc_e, pos_e, neg_e) * scale
        reg = losses.reg_pick_embeds([anc_e, pos_e, neg_e]) * scale
        n_pad = self.user_num + (-self.user_num) % BLOCK
        cl = sum(self.contrast(dr.uniform(f"co_u{b}", (n_pad, self.samp_pos)), u)
                 for b, u in enumerate(beh_users))
        loss = bpr + cl_w * cl + reg_w * reg
        return loss, {"bpr_loss": bpr, "cl_loss": cl}

    def generate(self):
        u, i, _ = self.forward()
        return u, i
