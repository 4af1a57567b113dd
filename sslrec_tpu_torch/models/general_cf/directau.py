"""DirectAU — alignment and uniformity losses, no negatives (port of
``sslrec_tpu/models/general_cf/directau.py``).

LightGCN propagation with the *mean* of the layers, alignment on (anchor,
positive), the gamma-weighted mean of the two uniformity terms; no edge
dropout and no L2 term (the config's Adam ``weight_decay`` adds it to the
gradient, in ``build_optimizer``).
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import MESH_CONTRASTIVE, RecModel
from sslrec_tpu_torch.ops.spmm import spmm_layers
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class DirectAU(RecModel):
    mesh_todo = MESH_CONTRASTIVE
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.adj = data.extras["bi_adj"]
        self.layer_num = int(cfg.model.layer_num)
        self.gamma = float(cfg.model.gamma)
        d, device = self.embedding_size, data.device
        self.user_embeds = nn.Parameter(torch.empty(self.user_num, d, device=device))
        self.item_embeds = nn.Parameter(torch.empty(self.item_num, d, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables, drawn user table first from ``gen``."""
        for p in (self.user_embeds, self.item_embeds):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def propagate(self):
        embeds = torch.cat([self.user_embeds, self.item_embeds], dim=0)
        acc = (embeds + spmm_layers(self.adj, embeds, self.layer_num).sum(dim=0)) \
            / (self.layer_num + 1)
        return acc[: self.user_num], acc[self.user_num:]

    def hparams(self) -> dict:
        """The lane scalar of ``tune.parallel`` (layer_num is structural)."""
        return {"gamma": self.gamma}

    def loss(self, batch: dict, key=None):
        gamma = batch.get("hp", {}).get("gamma", self.gamma)
        user_embeds, item_embeds = self.propagate()
        anc, pos = user_embeds[batch["user"]], item_embeds[batch["pos"]]
        align = losses.alignment_loss(anc, pos)
        uniform = gamma * (losses.uniformity_loss(anc) + losses.uniformity_loss(pos)) / 2.0
        return align + uniform, {"align_loss": align, "uniform_loss": uniform}

    def generate(self):
        return self.propagate()
