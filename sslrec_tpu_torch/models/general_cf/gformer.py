"""GFormer — graph transformer with anchor-set positional encoding and
rationale-guided masking (port of ``sslrec_tpu/models/general_cf/gformer.py``).

Once an epoch, from the epoch-start parameters, one view per ``fix_steps``
steps:

- anchors: ``anchor_set_num`` nodes drawn without replacement; node-to-anchor
  hop distances by 8 min-plus relaxations over the bi-adjacency (a
  ``scatter_reduce`` amin: a min does not depend on the order it is taken
  in), weighted ``1/(d+1)`` where reached, else 0;
- the PNN encoding in closed form ``((D·E_anchor)/A)·W₁ + E·W₂ + b``;
- the augmented edge space: ``addRate·nnz`` random edges both ways, self
  loops and the bi-adjacency; the summed clipped attention logits of the
  PNN encodings on it (``att_edge``) score three Gumbel top-k masks (keep;
  ``sub`` and ``cmp``), each made into values ``live·d⁻½[r]·d⁻½[c]`` with
  self loops always live;
- the decoder: ``reRate·nnz`` inverse-CDF draws from the dropped edges, both
  ways, and self loops.

Training propagates over the augmented edges under the three value vectors,
with the graph-transformer layer on the ``sub`` and ``cmp`` supports and on
the decoder; evaluation is the plain GCN over the normalised bi-adjacency.

Every propagation and segment sum is B1: the hops on a :class:`CsrGraph`
of each view's augmented edges, built on the device, with the values as
:class:`EdgeMask`; the degrees as d 1 hops; the attention's gathers and sums
(:func:`~sslrec_tpu_torch.models.general_cf.autocf.gt_attention`) over
device-built segment layouts of the augmented and the decoder edges.

Draws: :meth:`view_draws` takes one view's draws from the epoch's device
generator (anchors, the random edges, three Gumbel uniforms, the decoder's
uniforms), which a test injects through ``epoch_state``'s ``draws``.

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
both tables (``row_shards``) and reads them whole (``dist_train.whole_nodes``:
with autograd in the loss, without in ``epoch_state``), so every rank
builds the single run's view bank (anchors, PNN, masks, decoder) from the
same generator and runs every hop on the whole graph; the attention and
PNN layers are replicated.  The BPR terms, the contrasts and ``nce`` are
per-row terms over the batch (the second BPR a sum over the configured
batch size, which a ``data`` slice scales by ``n_whole / b`` so that its
share makes it whole again); the L2 of the row shards is summed over
``model``.
"""

from __future__ import annotations

import torch
from torch import nn

from sslrec_tpu_torch.models.base import RecModel, linear_layer
from sslrec_tpu_torch.models.general_cf.autocf import gt_attention
from sslrec_tpu_torch.ops.segment_kernel import segment_layout_from_ids
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, csr_graph_from_edges
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform

ANCHOR_ITERS = 8    # min-plus relaxations: hop distances up to 8


class GFormer(RecModel):
    mesh_todo = None

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.layer_num = int(m.layer_num)
        self.pnn_layer = int(m.pnn_layer)
        self.reg_weight = float(m.reg_weight)
        self.keep_rate = float(m.keep_rate)
        self.gtw = float(m.gtw)
        self.anchor_num = int(m.anchor_set_num)
        self.ctra = float(m.ctra)
        self.ssl_reg = float(m.ssl_reg)
        self.b2 = float(m.b2)
        self.head = int(m.head)
        self.add_rate = float(m.addRate)
        self.re_rate = float(m.reRate)
        self.sub_rate = float(m.sub)
        self.fix_steps = int(m.fix_steps)
        self.batch_train = int(cfg.train.batch_size)
        device, d = data.device, self.embedding_size
        bi = data.extras["bi_adj"]
        self.n_nodes, self.nnz = bi.n_rows, bi.nnz
        self.rows, self.cols, self.norm_vals = bi.rows, bi.cols, bi.vals
        self.adj = csr_graph_from_edges(bi.rows, bi.cols, bi.n_rows, bi.n_cols)
        # static sizes of the augmented edge space
        self.n_add = int(self.nnz * self.add_rate)
        self.nnz_aug = self.nnz + 2 * self.n_add + self.n_nodes
        self.k_keep = int(self.nnz_aug * self.keep_rate)
        self.k_sub = int(self.nnz_aug * self.sub_rate)
        self.n_re = int(self.nnz * self.re_rate)

        dist_train.ui_tables(self, cfg, d, device)
        self.gt = nn.ParameterDict({k: nn.Parameter(torch.empty(d, d, device=device))
                                    for k in ("q", "k", "v")})
        self.pnn_hidden = linear_layer(2 * d, d, device)
        # never applied (as in the JAX model), but a parameter under L2
        self.pnn_out = linear_layer(d, d, device)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and attention matrices, ``nn.Linear``-default PNN
        layers, drawn from ``gen`` (whole tables on every rank of a mesh, each
        keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in self.gt.values():
            p.copy_(xavier_uniform(gen, tuple(p.shape)))
        for lin in (self.pnn_hidden, self.pnn_out):
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)

    def _embeds(self):
        """``[users; items]``, whole (gathered from the row shards on a mesh)."""
        return dist_train.ui_nodes(self)

    # -- anchors and the PNN -----------------------------------------------------
    def _anchor_dists(self, anchors: torch.Tensor) -> torch.Tensor:
        """``[N, A]`` weights ``1/(d+1)`` of each node's hop distance ``d`` to
        each anchor, 0 where it is not reached within 8 hops."""
        a = self.anchor_num
        dist = torch.full((self.n_nodes, a), 1e9, device=anchors.device,
                          dtype=self.user_embeds.dtype)
        dist[anchors, torch.arange(a, device=anchors.device)] = 0.0
        idx = self.rows.long()[:, None].expand(-1, a).contiguous()
        cols = self.cols.long()
        for _ in range(ANCHOR_ITERS):
            dist = dist.scatter_reduce(0, idx, dist[cols] + 1.0, "amin", include_self=True)
        return torch.where(dist < 1e8, 1.0 / (dist + 1.0), 0.0)

    def _pnn(self, embeds, anchors, dist_w):
        d = self.embedding_size
        w = self.pnn_hidden["w"]
        msg = (dist_w @ (embeds[anchors] @ w[:d])) / self.anchor_num
        return msg + embeds @ w[d:] + self.pnn_hidden["b"]

    def _att_edge(self, x, rows, cols):
        """The attention logits of the edges, clipped to ±10 and summed over
        the heads (no gradient needed)."""
        h = self.head
        q = (x[rows] @ self.gt["q"]).view(rows.shape[0], h, -1)
        k = (x[cols] @ self.gt["k"]).view(rows.shape[0], h, -1)
        return torch.clamp((q * k).sum(-1), -10.0, 10.0).sum(-1)

    # -- the view bank -------------------------------------------------------------
    def view_draws(self, gen: torch.Generator) -> dict:
        """One view's draws on ``gen``'s device: the anchors (distinct), the
        random edges' indices into the bi-adjacency, the three masks'
        uniforms in [1e-9, 1) and the decoder's uniforms."""
        dev, n_aug = gen.device, self.nnz_aug

        def gumbel_u():
            return torch.rand(n_aug, generator=gen, device=dev) * (1.0 - 1e-9) + 1e-9

        return {"anchors": torch.randperm(self.n_nodes, generator=gen, device=dev)[
                    : self.anchor_num],
                "add_rows": torch.randint(0, self.nnz, (self.n_add,), generator=gen, device=dev),
                "add_cols": torch.randint(0, self.nnz, (self.n_add,), generator=gen, device=dev),
                "keep_u": gumbel_u(), "sub_u": gumbel_u(), "cmp_u": gumbel_u(),
                "dec_u": torch.rand(self.n_re, generator=gen, device=dev)}

    def augment(self, draws: dict) -> dict:
        """The view's anchors, their distance weights, the PNN encodings and
        the augmented edges (with their layouts) from ``draws``."""
        anchors = draws["anchors"]
        dist_w = self._anchor_dists(anchors)
        loops = torch.arange(self.n_nodes, device=anchors.device)
        ar = self.rows.long()[draws["add_rows"]]
        ac = self.cols.long()[draws["add_cols"]]
        aug_rows = torch.cat([ar, ac, loops, self.rows.long()])
        aug_cols = torch.cat([ac, ar, loops, self.cols.long()])
        return {"anchors": anchors, "dist_w": dist_w,
                "pnn": self._pnn(self._embeds(), anchors, dist_w),
                "aug_rows": aug_rows, "aug_cols": aug_cols,
                "aug": csr_graph_from_edges(aug_rows, aug_cols, self.n_nodes, self.n_nodes),
                "aug_seg": (segment_layout_from_ids(aug_rows, self.n_nodes),
                            segment_layout_from_ids(aug_cols, self.n_nodes))}

    def _norm_vals(self, view, mask):
        live = torch.clamp(mask + (view["aug_rows"] == view["aug_cols"]).float(), 0.0, 1.0)
        deg = spmm(view["aug"], torch.ones(self.n_nodes, 1, device=mask.device, dtype=mask.dtype),
                   live)[:, 0]
        dinv = torch.where(deg > 0, deg ** -0.5, 0.0)
        return live * dinv[view["aug_rows"]] * dinv[view["aug_cols"]]

    def masks(self, view: dict, att_edge: torch.Tensor, draws: dict) -> dict:
        """The keep / sub / cmp masks (Gumbel top-k over ``att_edge``), their
        values, and the decoder edges with their layouts, added to ``view``."""

        def topk_mask(k, logp, u):
            idx = torch.topk(logp - torch.log(-torch.log(u)), k).indices
            return torch.zeros_like(logp).index_fill_(0, idx, 1.0)

        inv_logp = -torch.clamp(att_edge, max=3.0)
        pos_logp = torch.log(att_edge - att_edge.min() + 1.001)
        keep = topk_mask(self.k_keep, inv_logp, draws["keep_u"])
        sub = topk_mask(self.k_sub, pos_logp, draws["sub_u"])
        cmp = topk_mask(self.k_sub, inv_logp, draws["cmp_u"])
        cdf = torch.cumsum(1.0 - keep, 0)
        total = torch.clamp(cdf[-1], min=1.0)
        eidx = torch.clamp(torch.searchsorted(cdf, draws["dec_u"] * total), 0, self.nnz_aug - 1)
        er, ec = view["aug_rows"][eidx], view["aug_cols"][eidx]
        loops = torch.arange(self.n_nodes, device=att_edge.device)
        dec_rows, dec_cols = torch.cat([er, ec, loops]), torch.cat([ec, er, loops])
        return {**view, "keep": keep, "sub_mask": sub, "cmp_mask": cmp,
                "enc_vals": self._norm_vals(view, keep), "sub_vals": self._norm_vals(view, sub),
                "cmp_vals": self._norm_vals(view, cmp), "dec_rows": dec_rows,
                "dec_cols": dec_cols,
                "dec_seg": (segment_layout_from_ids(dec_rows, self.n_nodes),
                            segment_layout_from_ids(dec_cols, self.n_nodes))}

    def one_view(self, draws: dict) -> dict:
        view = self.augment(draws)
        att_edge = self._att_edge(view["pnn"], view["aug_rows"], view["aug_cols"])
        return self.masks(view, att_edge, draws)

    @torch.no_grad()
    def epoch_state(self, gen: torch.Generator | None, epoch: int,
                    draws: list | None = None) -> dict:
        """The epoch's ⌈steps / fix_steps⌉ views from the epoch-start
        parameters; ``draws`` (else drawn from ``gen``), one dict per view."""
        n_views = -(-self._n_batches_hint // self.fix_steps)
        draws = [self.view_draws(gen) for _ in range(n_views)] if draws is None else draws
        return {"views": [self.one_view(d) for d in draws]}

    # -- forward and loss ------------------------------------------------------------
    def forward_train(self, view: dict):
        """(user and item sums, the cmp list's sum, the sub list's sum)."""
        embeds = self._embeds()
        aug, (seg_r, seg_c) = view["aug"], view["aug_seg"]
        gt_cmp = gt_attention(self.gt, seg_r, seg_c, (view["cmp_vals"] > 0).float(), embeds,
                              self.head)
        gt_sub = gt_attention(self.gt, seg_r, seg_c, (view["sub_vals"] > 0).float(), embeds,
                              self.head)
        acc, c_list, sub_list = [embeds], [embeds, self.gtw * gt_cmp], [embeds, self.gtw * gt_sub]
        for _ in range(self.layer_num):
            prev = acc[-1]
            acc.append(spmm(aug, prev, EdgeMask(view["enc_vals"])))
            sub_list.append(spmm(aug, prev, EdgeMask(view["sub_vals"])))
            c_list.append(spmm(aug, prev, EdgeMask(view["cmp_vals"])))
        for _ in range(self.pnn_layer):
            acc.append(self._pnn(acc[-1], view["anchors"], view["dist_w"]))
        acc.append(gt_attention(self.gt, *view["dec_seg"], None, acc[-1], self.head))
        total = sum(acc)
        return total[: self.user_num], total[self.user_num:], sum(c_list), sum(sub_list)

    @staticmethod
    def _contrast(nodes, e1, e2=None):
        e2 = e1 if e2 is None else e2
        return torch.logsumexp(e1[nodes] @ e2.T, dim=-1).mean()

    def loss(self, batch: dict, key=None):
        view = batch["aux"]["views"][int(batch["step"]) // self.fix_steps]
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        u_emb, i_emb, c_all, s_all = self.forward_train(view)
        bpr = -(u_emb[ancs] * i_emb[poss]).sum(-1).mean()
        su, si = s_all[: self.user_num], s_all[self.user_num:]
        diff = (su[ancs] * si[poss]).sum(-1) - (su[ancs] * i_emb[negs]).sum(-1)
        bpr2 = -torch.log(torch.sigmoid(diff) + 1e-12).sum() / self.batch_train
        if self.mesh is not None:       # a data slice's sum, scaled to the whole batch's
            bpr2 = bpr2 * (batch["n_whole"] / ancs.shape[0])
        reg = self.reg_weight * dist_train.reg_params(self, self.mesh)
        nce = torch.log(torch.exp(s_all[ancs] * c_all[ancs]).sum(-1) + 1e-12).mean()
        cl = ((self._contrast(ancs, u_emb) + self._contrast(poss, i_emb)) * self.ssl_reg
              + self._contrast(ancs, u_emb, i_emb) + self.ctra * nce)
        return bpr + reg + cl + self.b2 * bpr2, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}

    def generate(self):
        """The plain GCN over the normalised bi-adjacency."""
        embeds = self._embeds()
        acc = [embeds]
        for _ in range(self.layer_num):
            acc.append(spmm(self.adj, acc[-1], EdgeMask(self.norm_vals)))
        total = sum(acc)
        return total[: self.user_num], total[self.user_num:]
