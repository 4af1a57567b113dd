"""LightGCL — a GCN branch contrasted with a rank-q SVD-reconstructed branch
(port of ``sslrec_tpu/models/general_cf/lightgcl.py``).

- The user × item adjacency normalised by 1/√(rowD·colD)
  (:func:`rect_norm_adj`); per layer Z_u = Â·E_i and Z_i = Âᵀ·E_u, both on B1
  (Âᵀ is ``adj.t()``, the transposed layouts of the same graph), with an
  independent rescaled PRF edge dropout per call when ``model.dropout > 0``.
  The step key is split as the JAX model splits it (``split(key, L)``, then
  each layer's in two); the transposed call numbers the edges in Â's order,
  a relabelling of the JAX draw on its own Âᵀ graph.
- The SVD branch G = (U·S)(Vᵀ·E) from :func:`augment.svd_decompose`, run once
  at construction at width q + 8 on B1, from a Gaussian drawn on the CPU
  from a fixed seed, so the card and the CPU start from the same ``omega``.
- Every layer sum includes layer 0; BPR as mean −log σ; CL = the
  ``logsumexp`` of the negatives minus the clamped positives.
- ``ws`` are unused by the forward, as in the reference; they count in the
  L2 term.

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
both tables (``row_shards``) and reads them whole with autograd
(``dist_train.whole_nodes``): every hop runs on the whole graph in every
rank, with the single run's dropout draws, and the SVD factors are
constants every rank holds whole.  ``ws`` are replicated.  BPR and both CL
terms are means of per-row terms (the CL's ``logsumexp`` reads the whole
tables), so a ``data`` rank takes them over its slice; the L2 of the row
shards is summed over the ``model`` group (``dist_train.reg_params``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from sslrec_tpu_torch.models import augment
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.sparse import from_scipy
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import CsrGraph, build_csr_graph, split
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import xavier_uniform

SVD_SEED = 2023     # the JAX model's PRNGKey for its SVD start


def rect_norm_adj(train_mat: sp.spmatrix, device) -> CsrGraph:
    """The user × item train matrix with values 1/√(rowD[u]·colD[i]), both
    layouts on ``device``."""
    train_mat = train_mat.tocoo().astype(np.float32)
    row_d = np.asarray(train_mat.sum(1)).squeeze()
    col_d = np.asarray(train_mat.sum(0)).squeeze()
    vals = train_mat.data / np.sqrt(row_d[train_mat.row] * col_d[train_mat.col])
    norm = sp.coo_matrix((vals, (train_mat.row, train_mat.col)), train_mat.shape)
    return build_csr_graph(from_scipy(norm), device)


class LightGCL(RecModel):
    mesh_todo = None

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.temp = float(m.temp)
        self.dropout = float(m.dropout)
        self.layer_num = int(m.layer_num)
        self.cl_weight = float(m.cl_weight)
        self.reg_weight = float(m.reg_weight)
        self.svd_q = int(m.svd_q)
        device = data.device
        self.adj = rect_norm_adj(data.extras["train_mat_scipy"], device)
        self.adj_t = self.adj.t()
        with torch.no_grad():
            self.ut, self.vt, self.u_mul_s, self.v_mul_s = augment.svd_decompose(
                self.adj, self.svd_q, gen=torch.Generator().manual_seed(SVD_SEED))
        d = self.embedding_size
        dist_train.ui_tables(self, cfg, d, device)
        self.ws = nn.ParameterList([nn.Parameter(torch.empty(d, d, device=device))
                                    for _ in range(self.layer_num)])

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables and ``ws``, drawn in that order from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in self.ws:
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def forward(self, key=None):
        """(E_u, E_i, G_u, G_i); edge dropout under the step ``key`` when
        given and ``dropout > 0``."""
        keys = split(key, self.layer_num) if key is not None and self.dropout > 0 else None
        embeds = dist_train.ui_nodes(self)
        eu, ei = embeds[: self.user_num], embeds[self.user_num:]
        pu, pi = eu, ei
        zu, zi, gu, gi = [], [], [], []
        for layer in range(self.layer_num):
            ew_u = ew_i = None
            if keys is not None:
                k1, k2 = split(keys[layer])
                ew_u = augment.edge_drop(k1, self.adj, 1 - self.dropout, resize_val=True)
                ew_i = augment.edge_drop(k2, self.adj_t, 1 - self.dropout, resize_val=True)
            z_u, z_i = spmm(self.adj, pi, ew_u), spmm(self.adj_t, pu, ew_i)
            gu.append(self.u_mul_s @ (self.vt @ pi))
            gi.append(self.v_mul_s @ (self.ut @ pu))
            zu.append(z_u)
            zi.append(z_i)
            pu, pi = z_u, z_i
        return (eu + torch.stack(zu).sum(0), ei + torch.stack(zi).sum(0),
                eu + torch.stack(gu).sum(0), ei + torch.stack(gi).sum(0))

    def loss(self, batch: dict, key):
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        eu, ei, gu, gi = self.forward(key)
        pos_s = (eu[ancs] * ei[poss]).sum(-1)
        neg_s = (eu[ancs] * ei[negs]).sum(-1)
        bpr = -torch.log(torch.sigmoid(pos_s - neg_s) + 1e-12).mean()

        t = self.temp
        neg_score = torch.logsumexp(gu[ancs] @ eu.T / t, dim=1).mean()
        neg_score = neg_score + torch.logsumexp(gi[poss] @ ei.T / t, dim=1).mean()
        pos_score = ((gu[ancs] * eu[ancs]).sum(1) / t).clamp(-5.0, 5.0).mean()
        pos_score = pos_score + ((gi[poss] * ei[poss]).sum(1) / t).clamp(-5.0, 5.0).mean()
        cl = self.cl_weight * (neg_score - pos_score)

        reg = self.reg_weight * dist_train.reg_params(self, self.mesh)
        return bpr + cl + reg, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}

    def generate(self):
        eu, ei, _, _ = self.forward()
        return eu, ei
