"""DirectAU — alignment and uniformity losses, no negatives (port of
``sslrec_tpu/models/general_cf/directau.py``).

LightGCN propagation with the *mean* of the layers, alignment on (anchor,
positive), the gamma-weighted mean of the two uniformity terms; no edge
dropout and no L2 term (the config's Adam ``weight_decay`` adds it to the
gradient, in ``build_optimizer``).

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
both tables (``row_shards``, as LightGCN's), and the hops run on the whole
graph over the whole tables, gathered from the shards with autograd
(``dist_train.whole_nodes``).  Alignment is a mean over the batch's rows, so
a ``data`` rank takes it over its slice; uniformity, a log-mean over all
pairs of the batch's rows, is the one term that crosses the batch: every
``data`` rank computes it on the whole batch's rows
(``dist_train.gather_batch``).
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.spmm import spmm_layers
from sslrec_tpu_torch.parallel import dist_train


class DirectAU(RecModel):
    mesh_todo = None

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.adj = data.extras["bi_adj"]
        self.layer_num = int(cfg.model.layer_num)
        self.gamma = float(cfg.model.gamma)
        dist_train.ui_tables(self, cfg, self.embedding_size, data.device)

    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables, drawn user table first from ``gen`` (whole
        tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)

    def propagate(self):
        embeds = dist_train.ui_nodes(self)
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
        if self.mesh is not None:       # the whole batch's rows
            d = anc.shape[1]
            both = dist_train.gather_batch(torch.cat([anc, pos], 1), batch["n_whole"], self.mesh)
            anc, pos = both[:, :d], both[:, d:]
        uniform = gamma * (losses.uniformity_loss(anc) + losses.uniformity_loss(pos)) / 2.0
        return align + uniform, {"align_loss": align, "uniform_loss": uniform}

    @torch.no_grad()
    def generate(self):
        return self.propagate()
