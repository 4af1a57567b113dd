"""NCL — neighbourhood-enriched contrastive learning: structural InfoNCE
between layer 0 and layer 2·high_order, prototype InfoNCE against k-means
centroids (port of ``sslrec_tpu/models/general_cf/ncl.py``).

No edge dropout.  Training propagates ``max(layer_num, 2·high_order)`` hops
but the prediction sums only the first ``layer_num + 1`` layers (so
:meth:`generate` runs ``layer_num`` hops).  :meth:`epoch_state` re-clusters
the current tables every ``epoch_period`` epochs (the JAX trainer's hook)
through :meth:`epoch_state_fn`, which the tuner's lanes call once a lane;
the prototype loss holds the centroids constant.

On a device mesh every hop runs on the whole graph over the whole tables
(:meth:`~.LightGCN.nodes`, gathered from the row shards with autograd), so
NCL holds its row shards without LightGCN's partition
(``partitioned_hops``), and k-means reads the whole tables, so that every
rank gets the single run's clusters.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.general_cf.lightgcn import LightGCN
from sslrec_tpu_torch.ops.spmm import spmm_layers
from sslrec_tpu_torch.parallel import dist_train


class NCL(LightGCN):
    partitioned_hops = False

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.proto_weight = float(m.proto_weight)
        self.struct_weight = float(m.struct_weight)
        self.temperature = float(m.temperature)
        self.high_order = int(m.high_order)
        self.cluster_num = int(m.cluster_num)
        self.epoch_period = int(m.epoch_period)
        self.epoch_state_period = self.epoch_period     # the lanes' refresh period
        self.n_hops = max(self.layer_num, 2 * self.high_order)
        self._clusters = None

    @torch.no_grad()
    def epoch_state_fn(self, gen: torch.Generator | None, draws: dict | None = None) -> dict:
        """Centroids and assignments of both tables from the current
        parameters; ``draws`` (``{"user", "item"}``: each table's initial
        k-means rows) else drawn from ``gen``.  A pure function of the
        parameters and the draws, so the tuner's lanes call it once a lane
        (the JAX model's ``epoch_state_fn``)."""
        draws = draws or {}
        users, items = self.user_embeds, self.item_embeds
        if self.sharded:
            users = dist_train.whole_rows(users, self.user_num, self.mesh)
            items = dist_train.whole_rows(items, self.item_num, self.mesh)
        ucent, u2c, _ = augment.kmeans(users, self.cluster_num, gen=gen, pick=draws.get("user"))
        icent, i2c, _ = augment.kmeans(items, self.cluster_num, gen=gen, pick=draws.get("item"))
        return {"user_centroids": ucent, "user2cluster": u2c,
                "item_centroids": icent, "item2cluster": i2c}

    def epoch_state(self, gen: torch.Generator | None, epoch: int = 0,
                    draws: dict | None = None) -> dict:
        """:meth:`epoch_state_fn`'s clusters, new at the first call and every
        ``epoch_period`` epochs, else the last ones."""
        if self._clusters is None or epoch % self.epoch_period == 0:
            self._clusters = self.epoch_state_fn(gen, draws)
        return self._clusters

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel``."""
        return {"temperature": self.temperature, "proto_weight": self.proto_weight,
                "struct_weight": self.struct_weight}

    def _propagate_list(self, n_hops: int):
        embeds = self.nodes()
        return [embeds, *spmm_layers(self.adj, embeds, n_hops).unbind(0)]

    def loss(self, batch: dict, key=None):
        hp = batch.get("hp", {})
        t = hp.get("temperature", self.temperature)
        proto_w = hp.get("proto_weight", self.proto_weight)
        struct_w = hp.get("struct_weight", self.struct_weight)
        aux = batch["aux"]
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        embeds_list = self._propagate_list(self.n_hops)
        final = sum(embeds_list[: self.layer_num + 1])
        ego, context = embeds_list[0], embeds_list[2 * self.high_order]
        u = self.user_num
        u_fin, i_fin = final[:u], final[u:]
        bpr = losses.bpr_loss(u_fin[ancs], i_fin[poss], i_fin[negs]) / ancs.shape[0]

        u_ego, i_ego, u_ctx, i_ctx = ego[:u], ego[u:], context[:u], context[u:]
        struct = (losses.infonce_loss(u_ctx[ancs], u_ego[ancs], u_ego, t)
                  + losses.infonce_loss(i_ctx[poss], i_ego[poss], i_ego, t)
                  ) / ancs.shape[0] * struct_w

        ucent, icent = aux["user_centroids"].detach(), aux["item_centroids"].detach()
        proto = (losses.infonce_loss(u_ego[ancs], ucent[aux["user2cluster"][ancs]], ucent, t)
                 + losses.infonce_loss(i_ego[poss], icent[aux["item2cluster"][poss]], icent, t)
                 ) / ancs.shape[0] * proto_w

        reg = self.reg_weight * self.l2()
        loss = bpr + struct + proto + reg
        return loss, {"bpr_loss": bpr, "reg_loss": reg,
                      "struct_loss": struct, "proto_loss": proto}

    @torch.no_grad()
    def generate(self):
        final = sum(self._propagate_list(self.layer_num))
        return final[: self.user_num], final[self.user_num:]
