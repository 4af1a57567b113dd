"""HCCF — hypergraph-enhanced CF: a local GCN branch and a learned
hypergraph branch, with layer-wise cross-view InfoNCE (port of
``sslrec_tpu/models/general_cf/hccf.py``).

- Per layer a fresh PRF edge dropout with 1/keep rescaling on the GCN hop
  (B1, the mask inside the kernel), and the hypergraph layer
  leaky(adj·leaky(adjᵀ·E)) with adj = E·H·mult under inverted
  ``embed_dropout``.
- BPR as mean −log σ(diff); CL by ``infonce_loss_spec_nodes`` between the
  GCN branch (held constant) and the hypergraph branch per layer, on the
  batch's raw (not de-duplicated) node ids, as the JAX model does.

Draws: the model sets ``step_generator``; :meth:`step_draws` takes every
draw of a step from the epoch's device generator: the dropout masks of the
hyper tables and, from the same generator, one PRF key per layer for the
edge dropout (the JAX model splits the step key per layer instead; a test
injects those split keys to hold the two alike).

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
both tables (``row_shards``) and reads them whole with autograd
(``dist_train.whole_nodes``), so the GCN hops and the hypergraph layers run
whole in every rank with the single run's draws (every rank's generator
is the epoch's); the hyperedge weights are replicated.  BPR and the CL
(``infonce_loss_spec_nodes``: a mean over the batch's rows, its
denominators over the whole tables) are per-row terms, taken over a
``data`` rank's slice; the L2 of the row shards is summed over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import xavier_uniform


class HCCF(RecModel):
    mesh_todo = None
    step_generator = True       # the trainer hands loss() a device generator

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.adj = data.extras["bi_adj"]
        self.layer_num = int(m.layer_num)
        self.reg_weight = float(m.reg_weight)
        self.cl_weight = float(m.cl_weight)
        self.hyper_num = int(m.hyper_num)
        self.mult = float(m.mult)
        self.keep_rate = float(m.keep_rate)
        self.temperature = float(m.temperature)
        self.leaky = float(m.leaky)
        d, h, device = self.embedding_size, self.hyper_num, data.device

        dist_train.ui_tables(self, cfg, d, device)
        self.user_hyper = nn.Parameter(torch.empty(d, h, device=device))
        self.item_hyper = nn.Parameter(torch.empty(d, h, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables, drawn in the JAX model's order from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in (self.user_hyper, self.item_hyper):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def step_draws(self, gen: torch.Generator) -> dict:
        """One step's draws on ``gen``'s device: per layer an edge-dropout
        PRF key ``[L, 2]`` and the keep masks of the two hyper tables
        ``[L, n, hyper_num]``; none when ``keep_rate >= 1``."""
        if self.keep_rate >= 1.0:
            return {}
        L, h, dev = self.layer_num, self.hyper_num, gen.device
        return {"edge_keys": torch.randint(0, 2**32, (L, 2), generator=gen, device=dev,
                                           dtype=torch.int64),
                "keep_u": torch.rand(L, self.user_num, h, generator=gen, device=dev)
                < self.keep_rate,
                "keep_i": torch.rand(L, self.item_num, h, generator=gen, device=dev)
                < self.keep_rate}

    def _hgnn(self, adj, embeds):
        hids = F.leaky_relu(adj.T @ embeds, self.leaky)
        return F.leaky_relu(adj @ hids, self.leaky)

    def forward(self, draws: dict | None = None):
        """(sum of all layers, GCN layers, hypergraph layers); ``draws`` as
        :meth:`step_draws` returns them, none for the evaluation forward."""
        draws = draws or {}
        rate = 1.0 - self.keep_rate
        embeds = dist_train.ui_nodes(self)
        uu_hyper = embeds[: self.user_num] @ self.user_hyper * self.mult
        ii_hyper = embeds[self.user_num:] @ self.item_hyper * self.mult
        prev, gcn, hyper = embeds, [], []
        for layer in range(self.layer_num):
            ew, hu, hi = None, uu_hyper, ii_hyper
            if draws:
                ew = augment.edge_drop(draws["edge_keys"][layer], self.adj, self.keep_rate,
                                       resize_val=True)
                hu = augment.embed_dropout(draws["keep_u"][layer], uu_hyper, rate)
                hi = augment.embed_dropout(draws["keep_i"][layer], ii_hyper, rate)
            tem = spmm(self.adj, prev, ew)
            h = torch.cat([self._hgnn(hu, prev[: self.user_num]),
                           self._hgnn(hi, prev[self.user_num:])], dim=0)
            gcn.append(tem)
            hyper.append(h)
            prev = tem + h
        total = embeds + torch.stack(gcn).sum(0) + torch.stack(hyper).sum(0)
        return total, gcn, hyper

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (the shipped grid's
        layer_num is structural)."""
        return {"cl_weight": self.cl_weight, "temperature": self.temperature}

    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """``draws`` (else drawn from ``gen``) as :meth:`step_draws` returns them."""
        hp = batch.get("hp", {})
        cl_w = hp.get("cl_weight", self.cl_weight)
        t = hp.get("temperature", self.temperature)
        draws = self.step_draws(gen) if draws is None else draws
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        embeds, gcn, hyper = self.forward(draws)
        u = self.user_num
        u_emb, i_emb = embeds[:u], embeds[u:]
        diff = (u_emb[ancs] * i_emb[poss]).sum(-1) - (u_emb[ancs] * i_emb[negs]).sum(-1)
        bpr = -torch.log(torch.sigmoid(diff) + 1e-12).mean()
        cl = 0.0
        for e1, e2 in zip(gcn, hyper):
            e1 = e1.detach()
            cl = cl + losses.infonce_loss_spec_nodes(e1[:u], e2[:u], ancs, t)
            cl = cl + losses.infonce_loss_spec_nodes(e1[u:], e2[u:], poss, t)
        cl = cl * cl_w
        reg = self.reg_weight * dist_train.reg_params(self, self.mesh)
        return bpr + cl + reg, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}

    def generate(self):
        embeds, _, _ = self.forward()
        return embeds[: self.user_num], embeds[self.user_num:]
