"""MHCN: multi-channel hypergraph convolution with self-gating, channel
attention and hierarchical mutual-information SSL (port of
``sslrec_tpu/models/social/mhcn.py``).

Three motif channels (``H_s``, ``H_j``, ``H_p``) propagate self-gated user
embeddings with per-layer L2 row normalisation; the joint user × item
matrix ``R`` carries the channel-attention mix to the items (``Rᵀ``) and the
items back to a simple user channel (``R``).  BPR is sum-reduced; the SSL
term scores node against hyperedge and hyperedge against graph, with a row
shuffle and row-and-column shuffles.  Every product is B1, ``R`` both ways.

Draws: the model sets ``step_generator``; :meth:`ssl_draws` draws a step's
permutations from the epoch's device generator, which a test injects through
``loss``'s ``draws`` (JAX's permutations).

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
the user and item tables (``row_shards``) and reads them whole with
autograd (``dist_train.ui_nodes``), so every channel and ``R`` hop runs on
the whole graphs in every rank; the gates and the attention are
replicated.  BPR is a sum over the batch, which a ``data`` slice scales by
``n_whole / b``; the SSL term is a sum over every user under permutations
of the whole table, which every rank draws alike from the epoch's
generator, and the L2 of every parameter (``dist_train.reg_params``) is
whole too: both are computed alike on every rank and counted once.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.spmm import spmm, spmm_t
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform


def _l2norm_rows(x):
    return x / torch.sqrt((x * x).sum(1, keepdim=True) + 1e-12)


class MHCN(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.layer_num = int(m.layer_num)
        self.reg_weight = float(m.reg_weight)
        self.ss_rate = float(m.ss_rate)
        ex = data.extras
        self.h_s, self.h_j, self.h_p, self.r = (ex["mhcn_h_s"], ex["mhcn_h_j"], ex["mhcn_h_p"],
                                                ex["mhcn_r"])
        d, device = self.embedding_size, data.device
        dist_train.ui_tables(self, cfg, d, device)
        self.gating = nn.ModuleList([linear_layer(d, d, device) for _ in range(4)])
        self.sgating = nn.ModuleList([linear_layer(d, d, device) for _ in range(3)])
        self.attn = nn.Parameter(torch.empty(1, d, device=device))
        self.attn_mat = nn.Parameter(torch.empty(d, d, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and attention, ``nn.Linear``-default gates, from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in (self.attn, self.attn_mat):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))
        for lin in (*self.gating, *self.sgating):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)

    @staticmethod
    def _gate(p, x):
        return x * torch.sigmoid(apply_linear(p, x))

    def _channel_attention(self, *channels):
        weights = torch.stack([(self.attn * (c @ self.attn_mat)).sum(1) for c in channels])
        score = torch.softmax(weights.T, dim=-1)                   # [n, C]
        return sum(score[:, i:i + 1] * c for i, c in enumerate(channels))

    def forward(self):
        nodes = dist_train.ui_nodes(self)
        g, u = self.gating, nodes[: self.user_num]
        uc1, uc2, uc3 = self._gate(g[0], u), self._gate(g[1], u), self._gate(g[2], u)
        simp = self._gate(g[3], u)
        acc1, acc2, acc3, acc_s = [uc1], [uc2], [uc3], [simp]
        item_embeds = nodes[self.user_num:]
        acc_i = [item_embeds]
        for _ in range(self.layer_num):
            mixed = self._channel_attention(uc1, uc2, uc3) + simp / 2.0
            uc1 = spmm(self.h_s, uc1)
            acc1.append(_l2norm_rows(uc1))
            uc2 = spmm(self.h_j, uc2)
            acc2.append(_l2norm_rows(uc2))
            uc3 = spmm(self.h_p, uc3)
            acc3.append(_l2norm_rows(uc3))
            new_item = spmm_t(self.r, mixed)
            acc_i.append(_l2norm_rows(new_item))
            simp = spmm(self.r, item_embeds)
            acc_s.append(_l2norm_rows(simp))
            item_embeds = new_item
        ret_user = self._channel_attention(sum(acc1), sum(acc2), sum(acc3)) + sum(acc_s) / 2.0
        return ret_user, sum(acc_i)

    def ssl_draws(self, gen: torch.Generator) -> list:
        """Per channel: the row shuffle of the node embeddings (``row1``) and two
        row-and-column shuffles of the hyperedge embeddings (``col2`` then
        ``row2``; ``col3`` then ``row3``)."""
        n, d, dev = self.user_num, self.embedding_size, gen.device

        def perm(k):
            return torch.randperm(k, generator=gen, device=dev)

        return [{"row1": perm(n), "col2": perm(d), "row2": perm(n), "col3": perm(d),
                 "row3": perm(n)} for _ in range(3)]

    def _hierarchical_ssl(self, em, adj, p: dict):
        """Local node ↔ hyperedge and global hyperedge ↔ graph terms."""
        edge = spmm(adj, em)

        def score(a, b):
            return (a * b).sum(1)

        pos = score(em, edge)
        neg1 = score(em[p["row1"]], edge)
        neg2 = score(edge[:, p["col2"]][p["row2"]], em)
        local = -(torch.log(torch.sigmoid(pos - neg1) + 1e-12)
                  + torch.log(torch.sigmoid(neg1 - neg2) + 1e-12)).sum()
        graph = edge.mean(0)
        pos_g = score(edge, graph[None, :])
        neg_g = score(edge[:, p["col3"]][p["row3"]], graph[None, :])
        return local - torch.log(torch.sigmoid(pos_g - neg_g) + 1e-12).sum()

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight, "ss_rate": self.ss_rate}

    def loss(self, batch: dict, gen: torch.Generator | None, draws: list | None = None):
        """BPR (summed) + L2 of every parameter + ``ss_rate`` × the three
        channels' SSL terms; ``draws`` (else from ``gen``) as :meth:`ssl_draws`.
        On a mesh the batch is a ``data`` slice, whose BPR scales by
        ``n_whole / b``."""
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        ss_rate = hp.get("ss_rate", self.ss_rate)
        draws = self.ssl_draws(gen) if draws is None else draws
        user_embeds, item_embeds = self.forward()
        ancs = batch["user"]
        bpr = losses.bpr_loss(user_embeds[ancs], item_embeds[batch["pos"]],
                              item_embeds[batch["neg"]])
        if self.mesh is not None:
            bpr = bpr * (batch["n_whole"] / ancs.shape[0])
        reg = reg_w * dist_train.reg_params(self, self.mesh)
        sg = self.sgating
        ss = sum(self._hierarchical_ssl(self._gate(sg[c], user_embeds), adj, draws[c])
                 for c, adj in enumerate((self.h_s, self.h_j, self.h_p))) * ss_rate
        return bpr + reg + ss, {"bpr_loss": bpr, "reg_loss": reg, "ss_loss": ss}

    def generate(self):
        return self.forward()
