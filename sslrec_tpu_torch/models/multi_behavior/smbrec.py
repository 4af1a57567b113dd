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
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.data.sampling import sample_from_rows
from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import MESH_PARTITIONED, RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.models.multi_behavior.hmgcr import GCNTower
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.utils.initializers import linear_params

BLOCK = 128


class SMBRec(RecModel):
    mesh_todo = MESH_PARTITIONED
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
        self.beh_degrees = ex["beh_degrees"]                 # [n_beh, n_users]
        self.co_indptr = ex["co_user_indptr"].long()
        self.co_indices = ex["co_user_indices"].long()
        d = self.embedding_size
        self.towers = nn.ModuleList([GCNTower(self.user_num, self.item_num, d, self.layer_num, dev)
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
        embeds = [tower(a, at) for tower, (a, at) in zip(self.towers, self.graphs)]
        users = torch.stack([u for u, _ in embeds])         # [n_beh, U, d]
        items = torch.cat([i for _, i in embeds], 1)
        w = torch.softmax(self.beh_weights[:, None, None] * self.beh_degrees[:, :, None], 0)
        user_emb = apply_linear(self.user_trans, (w * users).sum(0))
        return user_emb, apply_linear(self.cat_trans, items), [u for u, _ in embeds]

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
        bpr = losses.bpr_loss(anc_e, pos_e, neg_e)
        reg = losses.reg_pick_embeds([anc_e, pos_e, neg_e])
        n_pad = self.user_num + (-self.user_num) % BLOCK
        cl = sum(self.contrast(dr.uniform(f"co_u{b}", (n_pad, self.samp_pos)), u)
                 for b, u in enumerate(beh_users))
        loss = bpr + cl_w * cl + reg_w * reg
        return loss, {"bpr_loss": bpr, "cl_loss": cl}

    def generate(self):
        u, i, _ = self.forward()
        return u, i
