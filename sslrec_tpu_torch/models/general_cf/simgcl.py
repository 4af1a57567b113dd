"""SimGCL — noise-perturbed propagation views and InfoNCE (port of
``sslrec_tpu/models/general_cf/simgcl.py``).

Both views add sign-aligned, L2-normalised uniform noise after every hop;
BPR runs on the clean view; CL on anchors and positives only (no negatives'
term, unlike SGL).  The noise is drawn from the epoch's device generator
(``step_generator``, :meth:`step_draws`), so tests can inject it.

On a device mesh the clean view runs graph-partitioned, as SGL's does, and
every rank perturbs both views of the whole tables (gathered from the row
shards with autograd) with the whole ``[2, L, U+I, d]`` noise, drawn from
the same seed on every rank.
"""

from __future__ import annotations

import torch

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.general_cf.lightgcn import LightGCN
from sslrec_tpu_torch.ops.spmm import spmm_views


class SimGCL(LightGCN):
    step_generator = True       # the trainer hands loss() a device generator

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        self.cl_weight = float(cfg.model.cl_weight)
        self.temperature = float(cfg.model.temperature)
        self.eps = float(cfg.model.eps)

    def step_draws(self, gen: torch.Generator) -> dict:
        """Each view's and hop's uniform noise ``[2, L, N, d]``."""
        shape = (2, self.layer_num, self.user_num + self.item_num, self.embedding_size)
        return {"noise": torch.rand(shape, generator=gen, device=gen.device)}

    def _two_perturbed(self, noise, eps):
        x0 = self.nodes()
        out = spmm_views(self.adj, [x0, x0], self.layer_num,
                         post=lambda u, x: augment.embed_perturb(u, x, eps),
                         keys=noise)
        return x0 + out[0].sum(dim=0), x0 + out[1].sum(dim=0)

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural; eps
        only scales the noise, so it rides a lane too)."""
        return {"reg_weight": self.reg_weight, "cl_weight": self.cl_weight,
                "temperature": self.temperature, "eps": self.eps}

    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """``draws`` (else drawn from ``gen``) as :meth:`step_draws` returns them."""
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        cl_w = hp.get("cl_weight", self.cl_weight)
        t = hp.get("temperature", self.temperature)
        draws = self.step_draws(gen) if draws is None else draws
        v1, v2 = self._two_perturbed(draws["noise"], hp.get("eps", self.eps))
        u = self.user_num
        u1, i1, u2, i2 = v1[:u], v1[u:], v2[:u], v2[u:]
        ancs, poss = batch["user"], batch["pos"]
        anc, pos, neg = self.batch_rows(*self.train_tables(), batch)   # the clean view
        bpr = losses.bpr_loss(anc, pos, neg) / ancs.shape[0]
        cl = (losses.infonce_loss(u1[ancs], u2[ancs], u2, t)
              + losses.infonce_loss(i1[poss], i2[poss], i2, t))
        cl = cl / ancs.shape[0] * cl_w
        reg = reg_w * self.l2()
        return bpr + cl + reg, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}
