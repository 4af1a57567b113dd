"""SGL — self-supervised graph learning: two augmented propagation views and
InfoNCE against the whole embedding table (port of
``sslrec_tpu/models/general_cf/sgl.py``).

``model.augmentation``: ``edge_drop`` (the default; one PRF edge mask per
view), ``random_walk`` (a fresh PRF mask per view and layer, salted by the
layer) or ``node_drop`` (rows zeroed per view).  The step's PRF key is split
into the two views' keys as ``jax.random.split`` splits it, so each view's
mask equals the JAX accelerator path's; ``node_drop`` draws its row uniforms
from the epoch's device generator instead (``step_generator``,
:meth:`step_draws`).  BPR runs on the clean view; the three InfoNCE terms
(anchors, positives, negatives, each against the whole view table) are
divided by the batch size.

On a device mesh the clean view runs graph-partitioned, as LightGCN's
forward does, and both views run on the whole graph over the whole tables
(:meth:`~.LightGCN.nodes`, gathered from the row shards with autograd).  The
PRF masks come from the step key and the original edge ids, and node drop's
uniforms from the epoch's generator, whole, so every rank draws the single
run's masks.  Each term is a sum of per-row terms over the rank's slice of
the batch (InfoNCE's denominators read the whole view tables, not the
batch), so the slice's loss over its own size, weighted by its share,
sums to the whole batch's.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.general_cf.lightgcn import LightGCN
from sslrec_tpu_torch.ops.spmm import spmm_views
from sslrec_tpu_torch.ops.spmm_kernel import split

AUGMENTATIONS = ("edge_drop", "node_drop", "random_walk")


class SGL(LightGCN):
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.augmentation = cfg.model.augmentation
        if self.augmentation not in AUGMENTATIONS:
            raise ValueError(f"SGL augmentation {self.augmentation!r}; one of {AUGMENTATIONS}")
        self.cl_weight = float(cfg.model.cl_weight)
        self.temperature = float(cfg.model.temperature)
        self.step_generator = self.augmentation == "node_drop"

    def step_draws(self, gen: torch.Generator) -> dict:
        """``node_drop``'s draws: each view's row uniforms ``[2, N, 1]``."""
        n = self.user_num + self.item_num
        return {"node_u": torch.rand(2, n, 1, generator=gen, device=gen.device)}

    def _two_views(self, key, draws: dict | None):
        """Both augmented views' ``[N, d]`` sums of layers."""
        x0 = self.nodes()
        ews = None
        if self.augmentation == "node_drop":
            x0s = [augment.node_drop(draws["node_u"][v], x0, self.keep_rate) for v in (0, 1)]
        else:
            x0s = [x0, x0]
            salts = range(self.layer_num) if self.augmentation == "random_walk" else 0
            ews = augment.edge_drop(split(key), self.adj, self.keep_rate, salts=salts)
        out = spmm_views(self.adj, x0s, self.layer_num, ews)      # [2, L, N, d]
        return x0s[0] + out[0].sum(dim=0), x0s[1] + out[1].sum(dim=0)

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight, "cl_weight": self.cl_weight,
                "temperature": self.temperature}

    def loss(self, batch: dict, key, draws: dict | None = None):
        """``key``: the step's PRF key, or for ``node_drop`` the epoch's device
        generator; ``draws`` (else drawn from it) as :meth:`step_draws`."""
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        cl_w = hp.get("cl_weight", self.cl_weight)
        t = hp.get("temperature", self.temperature)
        if self.step_generator and draws is None:
            draws = self.step_draws(key)
        v1, v2 = self._two_views(key, draws)
        u = self.user_num
        u1, i1, u2, i2 = v1[:u], v1[u:], v2[:u], v2[u:]
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        anc, pos, neg = self.batch_rows(*self.train_tables(), batch)   # the clean view
        bpr = losses.bpr_loss(anc, pos, neg) / ancs.shape[0]
        cl = (losses.infonce_loss(u1[ancs], u2[ancs], u2, t)
              + losses.infonce_loss(i1[poss], i2[poss], i2, t)
              + losses.infonce_loss(i1[negs], i2[negs], i2, t))
        cl = cl / ancs.shape[0] * cl_w
        reg = reg_w * self.l2()
        return bpr + cl + reg, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}
