"""KCGN: knowledge-coupled social rec over a (rating × time)-expanded graph
with DGI on the social (uu) and item (ii) graphs (port of
``sslrec_tpu/models/social/kcgn.py``).

Items are replicated per rating class; the square user / (item, rating)
graph's edges carry a fixed sinusoidal time table's rows through a trained
projection.  A hop transforms users and items by their own weights, scales
by the source side's ``outdeg^-1/2``, adds the edge feature to each source
row gathered along the edges, sums into the destinations, scales by
``indeg^-1/2`` and applies a leaky ReLU; the hops' L2-normalised outputs
concatenate with the ego tables, and the rating copies of an item fuse by
their mean or a learned softmax weight.  DGI per graph scores the encoding
of the node table and of a row shuffle of it against its component's
summary, batch-masked.

B1 carries the hop's destination sum (:class:`SegmentOps` over the sorted
destinations) and the backward of its source gather (over the unsorted
sources), the DGI hops and component sums, and the backward of the
summaries' gathers over the component labels.

Draws: the model sets ``step_generator``; :meth:`step_draws` draws the
step's two row shuffles from the epoch's device generator, which a test
injects through ``loss``'s ``draws`` (JAX's permutations).

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
the tables whose rows JAX's rule shards (the user table; the item copies'
table where it has one rating class, so that its rows count items; the
fusion weights) and reads them whole with autograd
(``dist_train.whole_param``), so the expanded graph's hops and both DGI
graphs run whole in every rank; every other parameter is replicated, and
the host-sampled structures are constants every rank holds whole.  BPR and
the picked rows' L2 are sums over the batch, which a ``data`` slice scales
by ``n_whole / b``.  The DGI terms are not: their masks are the union of the
whole batch's ids, and their denominators count it, so every ``data`` rank
gathers the batch's ids (``dist_train.gather_batch``) and computes the
terms whole, alike on every rank, under row shuffles of the whole tables.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.segment_kernel import SegmentOps
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform


def _l2norm_rows(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def time_table(max_time: int, d: int) -> np.ndarray:
    """The fixed ``[max_time, 2d]`` sinusoidal table, rows 0 and 1 zero.  The
    frequencies keep the JAX package's expression as it stands, whose float64
    power overflows for most columns (their ``div`` is then 0)."""
    pos = np.arange(max_time, dtype=np.float64)[:, None]
    with np.errstate(over="ignore"):
        div = 1.0 / (10000 ** (np.arange(0, 2 * d, 2.0)) / d / 2.0)
    tab = np.zeros((max_time, 2 * d), np.float32)
    tab[:, 0::2] = np.sin(pos * div) / math.sqrt(d)
    tab[:, 1::2] = np.cos(pos * div) / math.sqrt(d)
    tab[0] = 0.0
    tab[1] = 0.0
    return tab


def degree_norms(src: np.ndarray, dst: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``max(outdeg, 1)^-1/2`` and ``max(indeg, 1)^-1/2`` over ``n`` nodes, float32."""
    deg_out = np.zeros(n, np.float32)
    deg_in = np.zeros(n, np.float32)
    np.add.at(deg_out, src, 1.0)
    np.add.at(deg_in, dst, 1.0)
    return np.power(np.maximum(deg_out, 1.0), -0.5), np.power(np.maximum(deg_in, 1.0), -0.5)


class KCGN(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.layer_num = int(m.layer_num)
        self.reg_weight = float(m.reg_weight)
        self.fuse = str(m.fuse)
        self.lam = [float(x) for x in m.lam]
        self.slope = float(m.slope)
        ex, device = data.extras, data.device
        self.n_nodes = int(ex["kcgn_n_nodes"])
        self.r_class = int(ex["rating_class"])
        self.max_time = int(ex["max_time"])
        src, dst = ex["kcgn_src"], ex["kcgn_dst"]
        self.seg_src = SegmentOps(src, self.n_nodes, device)
        self.seg_dst = SegmentOps(dst, self.n_nodes, device)
        self.uu_g, self.ii_g = ex["uu_dgi_graph"], ex["ii_dgi_graph"]
        self.uu_sub_adj, self.ii_sub_adj = ex["uu_sub_adj"], ex["ii_sub_adj"]
        self.uu_sub_norm, self.ii_sub_norm = ex["uu_sub_norm"], ex["ii_sub_norm"]
        self.uu_labels = SegmentOps(ex["uu_labels"], self.uu_sub_adj.n_rows, device)
        self.ii_labels = SegmentOps(ex["ii_labels"], self.ii_sub_adj.n_rows, device)
        self.uu_mask, self.ii_mask = ex["uu_dgi_mask"], ex["ii_dgi_mask"]
        d = self.embedding_size
        self.out_dim = d * self.layer_num
        # the edges' rows of the time table: a constant
        tab = torch.from_numpy(time_table(self.max_time, d)).to(device)
        self.edge_time = tab[ex["kcgn_time"].long()]
        out_n, in_n = degree_norms(src.cpu().numpy(), dst.cpu().numpy(), self.n_nodes)
        self.out_n = torch.from_numpy(out_n).to(device)
        self.in_n = torch.from_numpy(in_n).to(device)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        hops = max(self.layer_num - 1, 0)
        # JAX's row spaces (``sslrec_tpu/models/base.py``'s ``sharded_row_dims``)
        rows = {self.user_num, self.item_num, self.user_num + self.item_num, self.n_nodes}
        tables = {"user_embeds": (self.user_num, d),
                  "item_embeds": (self.item_num * self.r_class, d)}
        dist_train.row_tables(self, cfg, device, {k: s for k, s in tables.items()
                                                  if s[0] in rows})
        for k, s in tables.items():
            if s[0] not in rows:
                setattr(self, k, param(*s))
        self.time_lin = linear_layer(2 * d, d, device)
        self.u_w = nn.ParameterList([param(d, d) for _ in range(hops)])
        self.v_w = nn.ParameterList([param(d, d) for _ in range(hops)])
        self.prelu = param()
        if self.fuse == "weight":
            dist_train.row_tables(self, cfg, device, {"fuse_w": (self.item_num, self.r_class, 1)})

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and hop weights, an ``nn.Linear``-default time
        projection, PReLU slope 0.25, from ``gen`` (whole tables on every rank
        of a mesh, each keeping its own rows)."""
        dist_train.init_rows(self, gen, ("user_embeds", "item_embeds"))
        for p in (*self.u_w, *self.v_w):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))
        for k, v in linear_params(gen, 2 * self.embedding_size, self.embedding_size).items():
            self.time_lin[k].copy_(v)
        self.prelu.fill_(0.25)
        if self.fuse == "weight":
            dist_train.init_rows(self, gen, ("fuse_w",))

    def _hop(self, layer, u_f, v_f, edge_feat):
        node = torch.cat([u_f @ self.u_w[layer], v_f @ self.v_w[layer]], 0)
        node = node * self.out_n[:, None]
        agg = self.seg_dst.sum(self.seg_src.take(node) + edge_feat) * self.in_n[:, None]
        return F.leaky_relu(agg, self.slope)

    def forward(self):
        edge_feat = apply_linear(self.time_lin, self.edge_time)
        users, items = (dist_train.whole_param(self, k) for k in ("user_embeds", "item_embeds"))
        all_u, all_i = [users], [items]
        u_f, v_f = users, items
        for layer in range(self.layer_num - 1):
            embeds = self._hop(layer, u_f, v_f, edge_feat)
            u_f, v_f = embeds[: self.user_num], embeds[self.user_num:]
            ne = _l2norm_rows(embeds)
            all_u.append(ne[: self.user_num])
            all_i.append(ne[self.user_num:])
        user_embeds, item_embeds = torch.cat(all_u, 1), torch.cat(all_i, 1)
        if self.r_class == 1:
            return user_embeds, item_embeds.reshape(self.item_num, -1)
        item_embeds = item_embeds.reshape(self.item_num, self.r_class, -1)
        if self.fuse == "weight":
            fuse_w = dist_train.whole_param(self, "fuse_w")
            return user_embeds, (item_embeds * torch.softmax(fuse_w, dim=1)).sum(1)
        return user_embeds, item_embeds.sum(1) / self.r_class

    def step_draws(self, gen: torch.Generator) -> dict:
        """The row shuffles of the user and item tables for DGI's negatives."""
        return {"perm_u": torch.randperm(self.user_num, generator=gen, device=gen.device),
                "perm_i": torch.randperm(self.item_num, generator=gen, device=gen.device)}

    def _prelu(self, x):
        return torch.where(x >= 0, x, self.prelu * x)

    def _dgi(self, graph, features, perm, sub_adj, sub_norm, labels):
        pos = self._prelu(spmm(graph, features))
        neg = self._prelu(spmm(graph, features[perm]))
        graph_embeds = torch.sigmoid(spmm(sub_adj, pos) / sub_norm[:, None])
        summary = labels.take(graph_embeds)
        # the reference's bilinear weight is defined but never applied
        return (losses.bce_logits((pos * summary).sum(1), 1.0),
                losses.bce_logits((neg * summary).sum(1), 0.0))

    def hparams(self) -> dict:
        """The lane scalar of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight}

    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """BPR (summed) + reg · L2 of the picked rows + the uu and ii DGI terms
        over the batch's users and items in components of more than
        ``subnode`` nodes; ``draws`` (else from ``gen``) as :meth:`step_draws`.
        On a mesh the batch is a ``data`` slice: BPR and L2 scale by ``n_whole
        / b``, and the DGI masks take the whole batch's ids."""
        reg_w = batch.get("hp", {}).get("reg_weight", self.reg_weight)
        draws = self.step_draws(gen) if draws is None else draws
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        user_embeds, item_embeds = self.forward()
        anc_e, pos_e, neg_e = user_embeds[ancs], item_embeds[poss], item_embeds[negs]
        bpr = losses.bpr_loss(anc_e, pos_e, neg_e)
        reg = reg_w * losses.reg_pick_embeds([anc_e, pos_e, neg_e])
        if self.mesh is not None:
            n = batch["n_whole"]
            bpr, reg = bpr * (n / ancs.shape[0]), reg * (n / ancs.shape[0])
            ancs, poss, negs = (dist_train.gather_batch(x, n, self.mesh)
                                for x in (ancs, poss, negs))
        up, un = self._dgi(self.uu_g, user_embeds, draws["perm_u"], self.uu_sub_adj,
                           self.uu_sub_norm, self.uu_labels)
        umask = user_embeds.new_zeros(self.user_num)
        umask[ancs.long()] = 1.0
        umask = umask * self.uu_mask
        uu_loss = self.lam[0] * (((up * umask).sum() + (un * umask).sum())
                                 / umask.sum().clamp(min=1.0))
        ip, in_ = self._dgi(self.ii_g, item_embeds, draws["perm_i"], self.ii_sub_adj,
                            self.ii_sub_norm, self.ii_labels)
        imask = item_embeds.new_zeros(self.item_num)
        imask[poss.long()] = 1.0
        imask[negs.long()] = 1.0
        imask = imask * self.ii_mask
        ii_loss = self.lam[1] * (((ip * imask).sum() + (in_ * imask).sum())
                                 / imask.sum().clamp(min=1.0))
        loss = bpr + reg + uu_loss + ii_loss
        return loss, {"bpr_loss": bpr, "reg_loss": reg, "uu_dgi_loss": uu_loss,
                      "ii_dgi_loss": ii_loss}

    def generate(self):
        return self.forward()
