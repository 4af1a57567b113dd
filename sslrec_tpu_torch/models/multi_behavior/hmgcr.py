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

Under ``train.mesh`` with a ``model`` axis of M > 1 (the JAX package's
``GCNTower.apply(..., mesh_sgs=...)``) each tower's ``user_emb`` and
``item_emb`` are row-sharded (``row_shards``); its weights ``u_w`` and
``i_w`` are replicated.  Each layer's chained pair runs graph-partitioned
(``dist_train.maybe_partition_rect_pair``): A's hop gives this rank's rows
of the new users, and AT's hop reads them.  The towers' outputs are read
whole (``dist_train.whole_table``, a gather with autograd): the batch's rows
from the prediction tables, and the GRACE contrasts, which every rank
computes whole, alike.  GRACE is a sum of one term a row of its first view,
and the rows could be split over the ``model`` group (each rank its own
rows' terms against the whole other tables, half the dominant cost at M =
2); but Adam at ``lr`` 1e-2 carries the float sums of that split into the
tables: one epoch on an NVIDIA H100 of a Tmall-shaped split (1/8 of its
pairs) moved an item table 5.3e-5 from the single run, beyond the mesh's
tolerance, against 1.6e-5 for the alike computation (the single run itself
moves 3.5e-5 under another GEMM order).  The gather's sum of the ranks' equal cotangents is undone by
``mesh_backward``'s division by ``M``.  BPR is a sum over the batch: on a
``data`` slice it is scaled by the whole batch over the slice, which the
slice's share then cancels; every ``data`` rank computes the whole GRACE
term, weighted by its share.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class GCNTower(nn.Module):
    """One tower's tables and per-layer weights (Xavier, drawn user table,
    item table, then the user and the item layers' weights).  On a
    model-sharded ``mesh`` the tables are this rank's row shards (the whole
    tables drawn, the rank's rows kept)."""

    def __init__(self, n_users: int, n_items: int, dim: int, layer_num: int, device,
                 mesh=None):
        super().__init__()
        self.n_users, self.n_items, self.mesh = n_users, n_items, mesh

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.user_emb = param(dist_train.shard_rows(n_users, mesh), dim)
        self.item_emb = param(dist_train.shard_rows(n_items, mesh), dim)
        self.u_w = nn.ParameterList([param(dim, dim) for _ in range(layer_num)])
        self.i_w = nn.ParameterList([param(dim, dim) for _ in range(layer_num)])

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        for p, n in ((self.user_emb, self.n_users), (self.item_emb, self.n_items)):
            p.copy_(dist_train.own_rows(xavier_uniform(gen, (n, p.shape[1])), p.shape[0],
                                        self.mesh))
        for p in (*self.u_w, *self.i_w):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def forward(self, a, at, sgs=None):
        """The mean over layers of the users and items (this rank's rows of
        them where ``sgs``, the pair's two ``ShardedGraph`` s, is given)."""
        u, i = self.user_emb, self.item_emb
        us, is_ = [], []
        for u_w, i_w in zip(self.u_w, self.i_w):
            if sgs is None:
                u_new = spmm(a, i)
                i_new = spmm(at, u_new)
            else:
                sg_a, sg_at = sgs
                u_new, _ = dist_train.mesh_partitioned_propagate(
                    self.mesh, sg_a, torch.zeros_like(u), i, None, 1, "last")
                _, i_new = dist_train.mesh_partitioned_propagate(
                    self.mesh, sg_at, u_new, torch.zeros_like(i), None, 1, "last")
            u, i = torch.sigmoid(u_new @ u_w), torch.sigmoid(i_new @ i_w)
            us.append(u)
            is_.append(i)
        return sum(us) / len(us), sum(is_) / len(is_)


def mesh_towers(cfg, graphs, n_users: int, n_items: int, device):
    """The mesh of ``train.mesh`` and, on a model-sharded one, each tower's
    ``(sg_a, sg_at)`` partition of its chained pair (else None)."""
    mesh, sgs = mesh_from_config(cfg, device), None
    if dist_train.model_sharded(mesh):
        sgs = [dist_train.maybe_partition_rect_pair(cfg, a, at, n_users, n_items, device)[1]
               for a, at in graphs]
    return mesh, sgs


def tower_shards(n_towers: int, n_users: int, n_items: int, prefix: str = "towers") -> dict:
    """``row_shards`` of ``n_towers`` :class:`GCNTower` s under ``prefix``."""
    return {f"{prefix}.{t}.{k}": n for t in range(n_towers)
            for k, n in (("user_emb", n_users), ("item_emb", n_items))}


class HMGCR(RecModel):
    mesh_todo = None

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.graphs = data.extras["meta_path_graphs"]
        self.layer_num = int(m.layer_num)
        self.hidden_dim = int(m.get("hidden_dim", m.embedding_size))
        self.beta = float(m.beta_loss)
        self.tau = float(m.tau)
        self.mesh, self.sgs = mesh_towers(cfg, self.graphs, self.user_num, self.item_num,
                                          data.device)
        if self.sgs is not None:
            self.row_shards = tower_shards(len(self.graphs), self.user_num, self.item_num)
        self.towers = nn.ModuleList([
            GCNTower(self.user_num, self.item_num, self.hidden_dim, self.layer_num, data.device,
                     self.mesh)
            for _ in self.graphs])

    def init_params(self, gen: torch.Generator) -> None:
        for tower in self.towers:
            tower.init(gen)

    def forward(self):
        """The prediction tables and each tower's users and items, whole (on a
        model-sharded mesh gathered from the shards with autograd)."""
        sgs = self.sgs or [None] * len(self.graphs)
        embeds = [tower(a, at, sg) for tower, (a, at), sg in zip(self.towers, self.graphs, sgs)]
        users = [dist_train.whole_table(u, self.user_num, self.mesh) for u, _ in embeds]
        items = [dist_train.whole_table(i, self.item_num, self.mesh) for _, i in embeds]
        return sum(users) / len(users), sum(items) / len(items), users, items


    def hparams(self) -> dict:
        """The lane scalar of ``tune.parallel``: ``model.reg_weight``, inert
        (the module's docstring); it folds the shipped 9-trial grid into 3
        structural groups (layer_num), as in the JAX package."""
        return {"reg_weight": float(self.cfg.model.get("reg_weight", 0.0))}

    def loss(self, batch: dict, key=None):
        ancs, poss, negs = batch["user"].long(), batch["pos"].long(), batch["neg"].long()
        user_emb, item_emb, users, items = self.forward()
        # a sum over the batch: on a data slice, scaled to the whole batch
        scale = batch.get("n_whole", ancs.shape[0]) / ancs.shape[0]
        bpr = losses.bpr_loss(user_emb[ancs], item_emb[poss], item_emb[negs]) * scale
        cl = 0.0
        for i in range(1, len(users)):
            cl = cl + losses.grace_loss(users[i], users[i - 1], self.tau)
            cl = cl + losses.grace_loss(items[i], items[i - 1], self.tau)
        loss = self.beta * bpr + (1.0 - self.beta) * cl
        return loss, {"bpr_loss": bpr, "cl_loss": cl}

    def generate(self):
        user_emb, item_emb, *_ = self.forward()
        return user_emb, item_emb
