"""DSL: denoised self-augmented learning (port of
``sslrec_tpu/models/social/dsl.py``).

A LightGCN tower on the UI bi-adjacency (``gnn_layer`` hops) and a second on
the symmetric-normalised trust graph (``uugnn_layer`` hops) share the user
table; BPR (summed) on UI triples and on social (user, friend, negative
user) triples; the self-augmented term hinges the sigmoid-scored UI-space
label of random user pairs against their social-space dot product.  Every
hop is B1.  The trainer clips the gradients' global norm at ``grad_clip``
(10) and draws the social negatives through :meth:`extra_negatives`,
rejected against the trust edges.

Draws: the model sets ``step_generator``; :meth:`step_draws` draws a step's
random user pairs and the label's two dropout masks from the epoch's device
generator, which a test injects through ``loss``'s ``draws``.

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
the user and item tables (``row_shards``) and reads them whole with
autograd (``dist_train.ui_nodes``), so both towers run on the whole graphs
in every rank; the label's layers are replicated.  A ``data`` rank draws
the self-augmented pairs and masks for the whole batch (``n_whole``), as the
single run does, so that every rank takes the generator's draws alike, and
keeps its slice's rows; the UI and social BPR and the hinge are sums over
the slice's rows (the social stream is sliced with the batch), scaled by
``n_whole / b``, and the L2 of every parameter
(``dist_train.reg_params``) is whole.  The trainer's clip then takes the
norm over the ranks' row shards (``dist_train.global_norm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sslrec_tpu_torch.data.sampling import sample_negatives
from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params


class DSL(RecModel):
    mesh_todo = None
    step_generator = True
    batch_fields = ("user", "pos", "neg", "suser", "spos", "sneg")
    grad_clip = 10.0

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.adj = data.extras["bi_adj"]
        self.uu_adj = data.extras["uu_adj"]
        self.trust_edge_set = data.extras["trust_edge_set"]
        self.gnn_layer = int(m.gnn_layer)
        self.uugnn_layer = int(m.uugnn_layer)
        self.leaky = float(m.leaky)
        self.reg_weight = float(m.reg_weight)
        self.soc_weight = float(m.soc_weight)
        self.sal_weight = float(m.sal_weight)
        self.dropout_rate = float(m.dropout_rate)
        d, device = self.embedding_size, data.device
        dist_train.ui_tables(self, cfg, d, device)
        self.linear1 = linear_layer(2 * d, d, device)
        self.linear2 = linear_layer(d, 1, device)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and ``nn.Linear``-default layers, drawn from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for lin in (self.linear1, self.linear2):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)

    def extra_negatives(self, gen: torch.Generator, arrays: dict) -> dict:
        """One negative user per social pair, rejected against the trust edges."""
        return {"sneg": sample_negatives(gen, arrays["suser"], self.trust_edge_set,
                                         self.user_num)}

    def _ui_tower(self, embeds):
        acc = embeds
        for _ in range(self.gnn_layer):
            embeds = spmm(self.adj, embeds)
            acc = acc + embeds
        return acc[: self.user_num], acc[self.user_num:]

    def _social_tower(self, users):
        u = acc = users
        for _ in range(self.uugnn_layer):
            u = spmm(self.uu_adj, u)
            acc = acc + u
        return acc

    def step_draws(self, gen: torch.Generator, n: int) -> dict:
        """``n`` random user pairs (``sal_u1``, ``sal_u2``) and the label's
        dropout keep masks (``keep1`` [n, d], ``keep2`` [n, 1])."""
        dev, keep = gen.device, 1.0 - self.dropout_rate

        def users():
            return torch.randint(0, self.user_num, (n,), generator=gen, device=dev)

        def mask(*shape):
            return torch.rand(shape, generator=gen, device=dev) < keep

        return {"sal_u1": users(), "sal_u2": users(),
                "keep1": mask(n, self.embedding_size), "keep2": mask(n, 1)}

    def _dropout(self, x, keep):
        if self.dropout_rate <= 0.0:
            return x
        return torch.where(keep, x / (1.0 - self.dropout_rate), x.new_zeros(()))

    def _label(self, lat1, lat2, draws: dict):
        """Sigmoid-scored pair labels in UI space, dropout in training."""
        lat = torch.cat([lat1, lat2], -1)
        h = self._dropout(apply_linear(self.linear1, lat), draws["keep1"])
        lat = F.leaky_relu(h, self.leaky) + lat1 + lat2
        out = self._dropout(apply_linear(self.linear2, lat), draws["keep2"])
        return torch.sigmoid(out).reshape(-1)

    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """BPR (summed) on UI triples, L2 of every parameter, the social BPR
        and the self-augmented hinge; ``draws`` (else from ``gen``) as
        :meth:`step_draws`.  On a mesh the batch is a ``data`` slice: the
        draws are the whole batch's (``draws`` given so too), its rows kept,
        and the sums scale by ``n_whole / b``."""
        ancs = batch["user"]
        n = batch.get("n_whole", ancs.shape[0])
        draws = self.step_draws(gen, n) if draws is None else draws
        if self.mesh is not None:
            sl = dist_train.batch_slice(n, self.mesh)
            draws = {k: v[sl] for k, v in draws.items()}
        nodes = dist_train.ui_nodes(self)
        user_embeds, item_embeds = self._ui_tower(nodes)
        user_embeds2 = self._social_tower(nodes[: self.user_num])
        rec = losses.bpr_loss(user_embeds[ancs], item_embeds[batch["pos"]],
                              item_embeds[batch["neg"]])
        reg = self.reg_weight * dist_train.reg_params(self, self.mesh)
        soc = self.soc_weight * losses.bpr_loss(
            user_embeds2[batch["suser"]], user_embeds2[batch["spos"]],
            user_embeds2[batch["sneg"]])
        u1, u2 = draws["sal_u1"], draws["sal_u2"]
        scores = self._label(user_embeds[u1], user_embeds[u2], draws)
        preds = (user_embeds2[u1] * user_embeds2[u2]).sum(-1)
        sal = self.sal_weight * torch.clamp(1.0 - scores * preds, min=0.0).sum()
        if self.mesh is not None:
            scale = n / ancs.shape[0]
            rec, soc, sal = rec * scale, soc * scale, sal * scale
        loss = rec + reg + soc + sal
        return loss, {"rec_loss": rec, "reg_loss": reg, "soc_loss": soc, "sal_loss": sal}

    def generate(self):
        return self._ui_tower(dist_train.ui_nodes(self))
