"""LightGCN: k-layer linear propagation over the normalised bipartite adjacency
(port of ``sslrec_tpu/models/general_cf/lightgcn.py``).

Sum of layer embeddings, per-batch edge dropout at ``keep_rate``, BPR (mean
over the batch) plus L2 of all parameters.  Every hop is one CSR SpMM
(:mod:`sslrec_tpu_torch.ops.spmm`), a CUDA kernel on the card.

Under ``train.mesh`` with a ``model`` axis of M > 1 the model is this rank's
shard (:mod:`~sslrec_tpu_torch.parallel.dist_train`): it holds rows
``[p·U_loc, (p+1)·U_loc)`` of the user table and ``[p·I_loc, (p+1)·I_loc)`` of
the item table (zero rows past the last), each hop gathers the whole table
over the ``model`` group and runs B1 on the shard's edges, and a batch's rows
come from the shards through ``owned_lookup``.  The dropout PRF is keyed by
the original edge id, so a mesh run drops the edges its single-device run
drops.  With ``model`` 1 the model is the single-device one, and the
trainer splits the batch over ``data``.  Subclasses whose hops run on the
whole graph read the tables whole through :meth:`nodes`; one that runs no
partitioned hop (``partitioned_hops`` False: NCL) holds its row shards
without the partition.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.spmm import spmm_layers
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class LightGCN(RecModel):
    mesh_todo = None
    partitioned_hops = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.adj = data.extras["bi_adj"]
        self.layer_num = int(cfg.model.layer_num)
        self.reg_weight = float(cfg.model.reg_weight)
        self.keep_rate = float(cfg.model.keep_rate)
        d, device = self.embedding_size, data.device
        n_users, n_items = self.user_num, self.item_num
        self.mesh = mesh_from_config(cfg, device)
        self.sharded = dist_train.model_sharded(self.mesh)
        self.sg = None
        if self.sharded:
            self.row_shards = {"user_embeds": n_users, "item_embeds": n_items}
            if self.partitioned_hops:
                g = self.adj
                _, self.sg = dist_train.maybe_partition_bi(
                    cfg, g.rows, g.cols, n_users, n_items, vals=g.vals, device=device)
                self.shard = dist_train.shard_graph(self.sg, self.mesh.model_index, device)
        self.user_embeds = nn.Parameter(
            torch.empty(dist_train.shard_rows(n_users, self.mesh), d, device=device))
        self.item_embeds = nn.Parameter(
            torch.empty(dist_train.shard_rows(n_items, self.mesh), d, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables, drawn user table first from ``gen`` (whole
        tables on every rank of a mesh, each keeping its own rows)."""
        for p, n in ((self.user_embeds, self.user_num), (self.item_embeds, self.item_num)):
            p.copy_(dist_train.own_rows(xavier_uniform(gen, (n, p.shape[1])), p.shape[0],
                                        self.mesh))

    def nodes(self) -> torch.Tensor:
        """``[users; items]``, the whole tables with autograd (gathered from
        the shards on a model-sharded mesh: ``dist_train.whole_nodes``)."""
        return dist_train.whole_nodes(self.user_embeds, self.item_embeds, self.user_num,
                                      self.item_num, self.mesh)

    def propagate_local(self, edge_weight=None):
        """This shard's rows of the propagation (a mesh's ``model`` axis > 1)."""
        return dist_train.partitioned_propagate(
            self.sg, self.user_embeds, self.item_embeds, self.shard.graph, self.layer_num,
            self.mesh, "sum", edge_weight)

    def propagate(self, edge_weight=None):
        """Sum-of-layers propagation: ``E + Σ_l A^l E`` split into user/item
        (whole tables; on a mesh, gathered from the shards)."""
        if self.sg is not None:
            u, i = self.propagate_local(edge_weight)
            return (dist_train.whole_rows(u, self.user_num, self.mesh),
                    dist_train.whole_rows(i, self.item_num, self.mesh))
        embeds = torch.cat([self.user_embeds, self.item_embeds], dim=0)
        ys = spmm_layers(self.adj, embeds, self.layer_num, edge_weight)
        acc = embeds + ys.sum(dim=0)
        return acc[: self.user_num], acc[self.user_num:]

    def train_tables(self, edge_weight=None):
        """The propagation that a loss reads with autograd: this shard's rows
        on a model-sharded mesh (:meth:`propagate` there detaches), else the
        whole tables."""
        if self.sg is not None:
            return self.propagate_local(edge_weight)
        return self.propagate(edge_weight=edge_weight)

    def forward_train(self, key: torch.Tensor):
        return self.train_tables(augment.edge_drop(key, self.adj, self.keep_rate))

    def batch_rows(self, user_embeds, item_embeds, batch: dict):
        """The batch's anchor, positive and negative rows of
        :meth:`train_tables`' output (through ``owned_lookup`` from the
        shards)."""
        users, poss, negs = batch["user"], batch["pos"], batch["neg"]
        if self.sg is None:
            return user_embeds[users], item_embeds[poss], item_embeds[negs]
        mesh, u_loc, i_loc = self.mesh, self.sg.u_loc, self.sg.i_loc
        return (dist_train.owned_lookup(user_embeds, users, u_loc, mesh),
                dist_train.owned_lookup(item_embeds, poss, i_loc, mesh),
                dist_train.owned_lookup(item_embeds, negs, i_loc, mesh))

    def l2(self) -> torch.Tensor:
        """L2² of every parameter (summed over the ``model`` group on a
        model-sharded mesh, whose ranks hold a shard each)."""
        reg = losses.reg_params(dict(self.named_parameters()))
        return dist_train.all_reduce_sum(reg, self.mesh.model_group) if self.sharded else reg

    def hparams(self) -> dict:
        """The tuned loss scalars that ride a lane of ``tune.parallel``
        (:mod:`~sslrec_tpu_torch.trainer.lanes`); ``loss`` reads them from
        ``batch["hp"]`` where it is set.  A tuned key outside it (layer_num)
        is structural."""
        return {"reg_weight": self.reg_weight}

    def loss(self, batch: dict, key: torch.Tensor):
        reg_w = batch.get("hp", {}).get("reg_weight", self.reg_weight)
        anc, pos, neg = self.batch_rows(*self.forward_train(key), batch)
        bpr = losses.bpr_loss(anc, pos, neg) / anc.shape[0]
        reg = reg_w * self.l2()
        return bpr + reg, {"bpr_loss": bpr, "reg_loss": reg}

    def generate(self):
        return self.propagate(edge_weight=None)
