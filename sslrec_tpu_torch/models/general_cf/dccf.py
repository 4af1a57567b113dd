"""DCCF — disentangled contrastive CF: intent prototypes and adaptive edge
re-weighting, with a six-way layer-wise InfoNCE (port of
``sslrec_tpu/models/general_cf/dccf.py``).

- Two graphs over the same edges in the same order (:func:`plain_and_norm_adj`):
  the plain bidirectional adjacency, all ones (so B1 reads no values there),
  and its D^-1/2 A D^-1/2 twin, which drives the GNN hop.
- Per layer: the GNN hop; intent attention softmax(E·P)·Pᵀ; two hops over
  the plain graph whose edge weights :func:`augment.adaptive_mask` learns
  from the GNN and the intent view, back-propagated through B1's learned
  weight (``SpmmFn``'s ``dew``); the layer adds the four to its input, and
  the prediction sums every layer's state.
- CL between the GNN view and each other view, per layer, over the batch's
  raw (not de-duplicated) users and items, with denominators over the picked
  rows; every term divided by the batch size.

No random draws.

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
both tables (``row_shards``) and reads them whole with autograd
(``dist_train.whole_nodes``): every layer, the learned weights' ``dew``
included, runs on the whole graph in every rank; the intents are
replicated.  BPR is a mean over the batch's rows, taken over a ``data``
rank's slice; the CL crosses the batch (``infonce_loss(a, b, b, t)``: the
negatives are the batch's own rows, and each term is divided by the batch
size), so every ``data`` rank gathers the batch's ids
(``dist_train.gather_batch``) and computes the whole batch's term; the L2
of the row shards is summed over ``model``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from sslrec_tpu_torch.models import augment, losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.sparse import from_scipy, normalize_adj_sym
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import CsrGraph, build_csr_graph
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import xavier_uniform


def plain_and_norm_adj(train_mat: sp.spmatrix, n_users: int, n_items: int,
                       device) -> tuple[CsrGraph, CsrGraph]:
    """The [U+I] bidirectional adjacency with values 1, and with values
    D^-1/2 A D^-1/2 (no degree epsilon), both in the same row-sorted edge
    order, both layouts on ``device``."""
    trn = train_mat.tocoo()
    rows = np.concatenate([trn.row, trn.col + n_users])
    cols = np.concatenate([trn.col + n_users, trn.row])
    n = n_users + n_items
    plain = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                          shape=(n, n)).tocsr().tocoo()
    norm = normalize_adj_sym(plain, eps=0.0)
    return (build_csr_graph(from_scipy(plain), device),
            build_csr_graph(from_scipy(norm), device))


class DCCF(RecModel):
    mesh_todo = None

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.layer_num = int(m.layer_num)
        self.intent_num = int(m.intent_num)
        self.reg_weight = float(m.reg_weight)
        self.cl_weight = float(m.cl_weight)
        self.temperature = float(m.temperature)
        device = data.device
        self.plain_adj, self.norm_adj = plain_and_norm_adj(
            data.extras["train_mat_scipy"], self.user_num, self.item_num, device)
        d = self.embedding_size
        dist_train.ui_tables(self, cfg, d, device)
        self.user_intent = nn.Parameter(torch.empty(d, self.intent_num, device=device))
        self.item_intent = nn.Parameter(torch.empty(d, self.intent_num, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables and intents, drawn in the JAX model's order
        from ``gen`` (whole tables on every rank of a mesh, each keeping its
        own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in (self.user_intent, self.item_intent):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def forward(self):
        """(user and item sums of every layer's state, then per layer the
        GNN, intent, GNN-masked and intent-masked views ``[U+I, d]``)."""
        u = self.user_num
        prev = dist_train.ui_nodes(self)
        final, views = prev, ([], [], [], [])
        for _ in range(self.layer_num):
            gnn = spmm(self.norm_adj, prev)
            u_int = torch.softmax(prev[:u] @ self.user_intent, dim=1) @ self.user_intent.T
            i_int = torch.softmax(prev[u:] @ self.item_intent, dim=1) @ self.item_intent.T
            intent = torch.cat([u_int, i_int], dim=0)
            gaa = spmm(self.plain_adj, prev, augment.adaptive_mask(self.plain_adj, gnn, gnn))
            iaa = spmm(self.plain_adj, prev,
                       augment.adaptive_mask(self.plain_adj, intent, intent))
            prev = gnn + intent + gaa + iaa + prev
            final = final + prev
            for acc, v in zip(views, (gnn, intent, gaa, iaa)):
                acc.append(v)
        return final[:u], final[u:], views

    def _cl_loss(self, users, items, views, t):
        u, n = self.user_num, users.shape[0]
        cl = 0.0
        for gnn, inte, gaa, iaa in zip(*views):
            ug, ui, ua, uia = (v[:u][users] for v in (gnn, inte, gaa, iaa))
            ig, ii, ia, iia = (v[u:][items] for v in (gnn, inte, gaa, iaa))
            for a, b in ((ug, ui), (ug, ua), (ug, uia), (ig, ii), (ig, ia), (ig, iia)):
                cl = cl + losses.infonce_loss(a, b, b, t) / n
        return cl

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight, "cl_weight": self.cl_weight,
                "temperature": self.temperature}

    def loss(self, batch: dict, key=None):
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        cl_w = hp.get("cl_weight", self.cl_weight)
        t = hp.get("temperature", self.temperature)
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        u_emb, i_emb, views = self.forward()
        bpr = losses.bpr_loss(u_emb[ancs], i_emb[poss], i_emb[negs]) / ancs.shape[0]
        reg = reg_w * dist_train.reg_params(self, self.mesh)
        if self.mesh is not None:       # the CL's negatives are the whole batch's rows
            n = batch["n_whole"]
            ancs, poss, negs = (dist_train.gather_batch(x, n, self.mesh)
                                for x in (ancs, poss, negs))
        cl = cl_w * self._cl_loss(ancs, torch.cat([poss, negs]), views, t)
        return bpr + reg + cl, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}

    def generate(self):
        u_emb, i_emb, _ = self.forward()
        return u_emb, i_emb
