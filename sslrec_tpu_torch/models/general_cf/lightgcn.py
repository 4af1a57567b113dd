"""LightGCN: k-layer linear propagation over the normalised bipartite adjacency
(port of ``sslrec_tpu/models/general_cf/lightgcn.py``, without the
``train.mesh`` partitioned branch).

Sum of layer embeddings, per-batch edge dropout at ``keep_rate``, BPR (mean
over the batch) plus L2 of all parameters.  Every hop is one CSR SpMM
(:mod:`sslrec_tpu_torch.ops.spmm`), a CUDA kernel on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.spmm import spmm_layers
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class LightGCN(RecModel):
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.adj = data.extras["bi_adj"]
        self.layer_num = int(cfg.model.layer_num)
        self.reg_weight = float(cfg.model.reg_weight)
        self.keep_rate = float(cfg.model.keep_rate)
        d, device = self.embedding_size, data.device
        self.user_embeds = nn.Parameter(torch.empty(self.user_num, d, device=device))
        self.item_embeds = nn.Parameter(torch.empty(self.item_num, d, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables, drawn user table first from ``gen``."""
        for p in (self.user_embeds, self.item_embeds):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def propagate(self, edge_weight=None):
        """Sum-of-layers propagation: ``E + Σ_l A^l E`` split into user/item."""
        embeds = torch.cat([self.user_embeds, self.item_embeds], dim=0)
        ys = spmm_layers(self.adj, embeds, self.layer_num, edge_weight)
        acc = embeds + ys.sum(dim=0)
        return acc[: self.user_num], acc[self.user_num:]

    def forward_train(self, key: torch.Tensor):
        ew = augment.edge_drop(key, self.adj, self.keep_rate)
        return self.propagate(edge_weight=ew)

    def hparams(self) -> dict:
        """The tuned loss scalars that ride a lane of ``tune.parallel``
        (:mod:`~sslrec_tpu_torch.trainer.lanes`); ``loss`` reads them from
        ``batch["hp"]`` where it is set.  A tuned key outside it (layer_num)
        is structural."""
        return {"reg_weight": self.reg_weight}

    def loss(self, batch: dict, key: torch.Tensor):
        reg_w = batch.get("hp", {}).get("reg_weight", self.reg_weight)
        user_embeds, item_embeds = self.forward_train(key)
        anc = user_embeds[batch["user"]]
        pos = item_embeds[batch["pos"]]
        neg = item_embeds[batch["neg"]]
        bpr = losses.bpr_loss(anc, pos, neg) / anc.shape[0]
        reg = reg_w * losses.reg_params(dict(self.named_parameters()))
        return bpr + reg, {"bpr_loss": bpr, "reg_loss": reg}

    def generate(self):
        return self.propagate(edge_weight=None)
