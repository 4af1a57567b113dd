"""SMIN: metapath GCNs with semantic attention and graph-infomax SSL (port
of ``sslrec_tpu/models/social/smin.py``).

Per selected metapath graph, ``layer_num - 1`` weighted hops with a shared
PReLU, whose L2-normalised outputs concatenate with the ego embedding;
semantic attention fuses the metapath channels.  Informax scores the DGI
encodings (the destination-normalised one-hop graph, no weight) of the
node table and of a row shuffle of it against the 2-hop subgraph's mean
embeddings and against the nodes themselves, and reconstructs the one-hop
edges from the encodings' endpoint gathers, batch-node-masked.

Every hop is B1, and so is the backward of the endpoint gathers
(:class:`SegmentOps` over the one-hop edges' rows and columns).

Draws: the model sets ``step_generator``; :meth:`step_draws` draws the
step's row shuffle from the epoch's device generator, which a test injects
through ``loss``'s ``draws`` (JAX's permutation).

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
the user and item tables (``row_shards``) and reads them whole with
autograd (``dist_train.ui_nodes``), so every metapath tower and Informax
runs on the whole graphs in every rank; the hop weights, PReLU and the
attention are replicated, and the host-sampled metapaths are constants
every rank holds whole.  BPR and the picked rows' L2 are sums over the
batch, which a ``data`` slice scales by ``n_whole / b``.  Informax is not:
its mask is the union of the whole batch's nodes and its denominator counts
it, so every ``data`` rank gathers the batch's ids
(``dist_train.gather_batch``) and computes it whole, alike on every rank,
under a row shuffle of the whole node table; its edge reconstruction is
over every one-hop edge and counted once.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.segment_kernel import SegmentOps
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform


def _l2norm_rows(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class SMIN(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.layer_num = int(m.layer_num)
        self.reg_weight = float(m.reg_weight)
        self.lambda1 = float(m.lambda1)
        self.lambda2 = float(m.lambda2)
        ex, device = data.extras, data.device
        graphs = ex["metapath_graphs"]
        self.user_paths = [graphs[k.upper()] for k in m.user_graph_indx.split("_")]
        self.item_paths = [graphs[k.upper()] for k in m.item_graph_indx.split("_")]
        self.dgi_graph = ex["dgi_graph"]
        self.sub_adj = ex["subgraph_adj"]
        self.sub_norm = ex["subgraph_norm"]
        n = self.user_num + self.item_num
        rows, cols = ex["dgi_edges"]
        self.edge_rows = SegmentOps(rows, n, device)
        self.edge_cols = SegmentOps(cols, n, device)
        self.in_size = self.layer_num * self.embedding_size

        d = self.embedding_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        hops = self.layer_num - 1
        dist_train.ui_tables(self, cfg, d, device)
        self.u_conv_w = nn.ParameterList([param(d, d) for _ in range(len(self.user_paths) * hops)])
        self.i_conv_w = nn.ParameterList([param(d, d) for _ in range(len(self.item_paths) * hops)])
        self.prelu = param()

        def attention():
            return nn.ModuleDict({"l1": linear_layer(self.in_size, 128, device),
                                  "l2": nn.ParameterDict({"w": param(128, 1)})})

        self.attn_u = attention()
        self.attn_i = attention()

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables, hop weights and attention outputs, ``nn.Linear``-default
        attention inputs, PReLU slope 0.25, from ``gen`` (whole tables on every
        rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in (*self.u_conv_w, *self.i_conv_w):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))
        self.prelu.fill_(0.25)
        for a in (self.attn_u, self.attn_i):
            for k, v in linear_params(gen, self.in_size, 128).items():
                a["l1"][k].copy_(v)
            a["l2"]["w"].copy_(xavier_uniform(gen, (128, 1)))

    def _prelu(self, x):
        return torch.where(x >= 0, x, self.prelu * x)

    def _metapath_tower(self, embeds, paths, conv_ws):
        outs, wi = [], 0
        for g in paths:
            acc, h = [embeds], embeds
            for _ in range(self.layer_num - 1):
                h = self._prelu(spmm(g, h) @ conv_ws[wi])
                wi += 1
                acc.append(_l2norm_rows(h))
            outs.append(torch.cat(acc, 1))              # [n, layer_num * d]
        return torch.stack(outs, 1)                     # [n, paths, in_size]

    @staticmethod
    def _semantic_attention(ap, z):
        w = torch.tanh(apply_linear(ap["l1"], z)) @ ap["l2"]["w"]
        beta = torch.softmax(w.mean(0), dim=0)          # [paths, 1]
        return (beta[None] * z).sum(1)

    def forward(self):
        nodes = dist_train.ui_nodes(self)
        su = self._metapath_tower(nodes[: self.user_num], self.user_paths, self.u_conv_w)
        si = self._metapath_tower(nodes[self.user_num:], self.item_paths, self.i_conv_w)
        return self._semantic_attention(self.attn_u, su), self._semantic_attention(self.attn_i, si)

    def step_draws(self, gen: torch.Generator) -> dict:
        """The row shuffle of the node table for DGI's negatives."""
        n = self.user_num + self.item_num
        return {"perm": torch.randperm(n, generator=gen, device=gen.device)}

    def _informax(self, features, perm):
        pos = self._prelu(spmm(self.dgi_graph, features))
        neg = self._prelu(spmm(self.dgi_graph, features[perm]))
        graph_embeds = torch.sigmoid(spmm(self.sub_adj, features) / self.sub_norm[:, None])

        def disc(node, ref, label):
            # the reference's bilinear weight is defined but never applied
            return losses.bce_logits((node * ref).sum(1), label)

        tmp = torch.sigmoid((self.edge_rows.take(pos) * self.edge_cols.take(pos)).sum(1))
        rebuilt = ((tmp - 1.0) ** 2).sum() / features.shape[0]
        return (disc(pos, graph_embeds, 1.0), disc(neg, graph_embeds, 0.0),
                disc(pos, features, 1.0), disc(neg, features, 0.0), rebuilt)

    def hparams(self) -> dict:
        """The lane scalars of ``tune.parallel`` (layer_num is structural)."""
        return {"reg_weight": self.reg_weight, "lambda1": self.lambda1,
                "lambda2": self.lambda2}

    def loss(self, batch: dict, gen: torch.Generator | None, draws: dict | None = None):
        """BPR (summed) + reg · L2 of the picked rows + Informax over the batch's
        nodes; ``draws`` (else from ``gen``) as :meth:`step_draws` returns them.
        On a mesh the batch is a ``data`` slice: BPR and L2 scale by ``n_whole
        / b``, and Informax's mask takes the whole batch's ids."""
        hp = batch.get("hp", {})
        reg_w = hp.get("reg_weight", self.reg_weight)
        lam1 = hp.get("lambda1", self.lambda1)
        lam2 = hp.get("lambda2", self.lambda2)
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
        feats = torch.cat([user_embeds, item_embeds], 0)
        p_xj, n_xj, p_xi, n_xi, rebuilt = self._informax(feats, draws["perm"])
        mask = feats.new_zeros(feats.shape[0])
        mask[ancs.long()] = 1.0
        mask[self.user_num + poss.long()] = 1.0
        mask[self.user_num + negs.long()] = 1.0
        denom = mask.sum()
        informax = (lam1 * (((mask * p_xj).sum() + (mask * n_xj).sum()) / denom)
                    + lam2 * (((mask * p_xi).sum() + (mask * n_xi).sum()) / denom
                                      + rebuilt))
        loss = bpr + reg + informax
        return loss, {"bpr_loss": bpr, "reg_loss": reg, "informax_loss": informax}

    def generate(self):
        return self.forward()
