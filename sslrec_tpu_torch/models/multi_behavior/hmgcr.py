"""HMGCR: a GCN tower per meta-path level with a GRACE contrast between
consecutive levels (port of ``sslrec_tpu/models/multi_behavior/hmgcr.py``).

- :class:`GCNTower` (shared with SMBRec): per layer ``u' = A·i``, then
  ``i' = AT·u'`` (the new users), ``u = σ(u' W_u)``, ``i = σ(i' W_i)``; the
  mean over layers.  Each layer is two B1 hops.
- The prediction embeddings are the mean over the meta-path towers.
- Loss: ``beta·BPR + (1 − beta)·CL``, CL the full-graph GRACE semi-loss
  (:func:`~sslrec_tpu_torch.models.losses.grace_loss`) of each level
  against the one before it, users and items.  ``model.reg_weight`` is read
  by nothing, as in the reference (a documented no-op of the tune grid).
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import MESH_PARTITIONED, RecModel
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class GCNTower(nn.Module):
    """One tower's tables and per-layer weights (Xavier, drawn user table,
    item table, then the user and the item layers' weights)."""

    def __init__(self, n_users: int, n_items: int, dim: int, layer_num: int, device):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.user_emb = param(n_users, dim)
        self.item_emb = param(n_items, dim)
        self.u_w = nn.ParameterList([param(dim, dim) for _ in range(layer_num)])
        self.i_w = nn.ParameterList([param(dim, dim) for _ in range(layer_num)])

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        for p in (self.user_emb, self.item_emb, *self.u_w, *self.i_w):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def forward(self, a, at):
        u, i = self.user_emb, self.item_emb
        us, is_ = [], []
        for u_w, i_w in zip(self.u_w, self.i_w):
            u_new = spmm(a, i)
            i_new = spmm(at, u_new)
            u, i = torch.sigmoid(u_new @ u_w), torch.sigmoid(i_new @ i_w)
            us.append(u)
            is_.append(i)
        return sum(us) / len(us), sum(is_) / len(is_)


class HMGCR(RecModel):
    mesh_todo = MESH_PARTITIONED
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.graphs = data.extras["meta_path_graphs"]
        self.layer_num = int(m.layer_num)
        self.hidden_dim = int(m.get("hidden_dim", m.embedding_size))
        self.beta = float(m.beta_loss)
        self.tau = float(m.tau)
        self.towers = nn.ModuleList([
            GCNTower(self.user_num, self.item_num, self.hidden_dim, self.layer_num, data.device)
            for _ in self.graphs])

    def init_params(self, gen: torch.Generator) -> None:
        for tower in self.towers:
            tower.init(gen)

    def forward(self):
        embeds = [tower(a, at) for tower, (a, at) in zip(self.towers, self.graphs)]
        users = [u for u, _ in embeds]
        items = [i for _, i in embeds]
        return sum(users) / len(users), sum(items) / len(items), users, items

    def hparams(self) -> dict:
        """The lane scalar of ``tune.parallel``: ``model.reg_weight``, inert
        (the module's docstring); it folds the shipped 9-trial grid into 3
        structural groups (layer_num), as in the JAX package."""
        return {"reg_weight": float(self.cfg.model.get("reg_weight", 0.0))}

    def loss(self, batch: dict, key=None):
        ancs, poss, negs = batch["user"].long(), batch["pos"].long(), batch["neg"].long()
        user_emb, item_emb, users, items = self.forward()
        bpr = losses.bpr_loss(user_emb[ancs], item_emb[poss], item_emb[negs])
        cl = 0.0
        for i in range(1, len(users)):
            cl = cl + losses.grace_loss(users[i], users[i - 1], self.tau)
            cl = cl + losses.grace_loss(items[i], items[i - 1], self.tau)
        loss = self.beta * bpr + (1.0 - self.beta) * cl
        return loss, {"bpr_loss": bpr, "cl_loss": cl}

    def generate(self):
        user_emb, item_emb, *_ = self.forward()
        return user_emb, item_emb
