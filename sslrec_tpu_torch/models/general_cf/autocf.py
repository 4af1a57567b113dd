"""AutoCF — masked graph autoencoder: seed-sampled subgraph masking, a GCN
encoder, a graph-transformer decoder and an infomax seed objective (port of
``sslrec_tpu/models/general_cf/autocf.py``).

- Seed scores (differentiable): first- and second-order aggregates over the
  all-ones bi-adjacency, cosine to the node's own embedding, sigmoid.
- The view bank: once an epoch, from the epoch-start parameters, one view per
  ``fix_steps`` steps: the top-``seed_num`` Gumbel-noised seeds, their
  depth-``mask_depth - 1`` closure, the edges that touch it dropped
  (``keep``), the encoder values ``keep · d⁻½[r] · d⁻½[c]``, and a decoder
  edge list: ``nnz`` random pairs of masked-or-sampled nodes both ways
  (inverse-CDF draws), self loops and the bi-adjacency weighted by ``keep``.
- Loss: −⟨anchor, positive⟩ + L2 + log-sum-exp contrasts over the raw batch
  (no de-duplication); on a step where the views regenerate, −mean(seed
  scores) as well.

Every propagation is B1: the encoder hops and the seed aggregates on the
fixed all-ones layout (the encoder values as an :class:`EdgeMask`); the
decoder's attention takes its endpoint gathers through ``TakeFn`` and its
two segment sums through ``SegmentSumFn`` over segment layouts of each
view's decoder rows and cols, which are built on the device
(``segment_layout_from_ids``).  The attention clips its logits to ±10 and
normalises with a 1e-8 floor and no max shift, as the JAX model does.

Draws: :meth:`view_draws` takes one view's draws from the epoch's device
generator (the seed noise, the node sample's uniforms, the pair draws'
uniforms), which a test injects through ``epoch_state``'s ``draws``.

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
both tables (``row_shards``) and reads them whole (``dist_train.whole_nodes``:
with autograd in the loss, without in ``epoch_state``), so every rank
builds the single run's view bank from the same generator, its layouts on
the card, and runs every hop and the decoder on the whole graph; the
attention matrices are replicated.  The reconstruction and the contrasts
are means of per-row terms (their ``logsumexp`` over the whole tables),
taken over a ``data`` rank's slice; the infomax term is whole and alike on
every rank; the L2 of the row shards is summed over ``model``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.ops.segment_kernel import SegmentSumFn, TakeFn, segment_layout_from_ids
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, csr_graph_from_edges
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import xavier_uniform


def gt_attention(p, lay_r, lay_c, valid, embeds, heads: int) -> torch.Tensor:
    """One graph-transformer layer over the edges (``lay_r.ids`` → ``lay_c.ids``):
    per head, ``exp(clip(q·k, ±10)) · valid`` normalised over each row's
    edges (+1e-8, no max shift), then the weighted values summed per row.
    Gathers through ``TakeFn``, sums through ``SegmentSumFn``: B1 both ways."""
    d = embeds.shape[1]
    e_r, e_c = TakeFn.apply(lay_r, embeds), TakeFn.apply(lay_c, embeds)
    q = (e_r @ p["q"]).view(-1, heads, d // heads)
    k = (e_c @ p["k"]).view(-1, heads, d // heads)
    v = (e_c @ p["v"]).view(-1, heads, d // heads)
    att = torch.clamp((q * k).sum(-1), -10.0, 10.0)
    exp_att = torch.exp(att)
    if valid is not None:
        exp_att = exp_att * valid[:, None]
    norm = TakeFn.apply(lay_r, SegmentSumFn.apply(lay_r, exp_att))
    res = (exp_att / (norm + 1e-8))[:, :, None] * v
    return SegmentSumFn.apply(lay_r, res.reshape(-1, d))


class AutoCF(RecModel):
    mesh_todo = None
    batch_fields = ("user", "pos")      # no negatives

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.gcn_layer = int(m.gcn_layer)
        self.gt_layer = int(m.gt_layer)
        self.reg_weight = float(m.reg_weight)
        self.ssl_reg = float(m.ssl_reg)
        self.head_num = int(m.head_num)
        self.seed_num = int(m.seed_num)
        self.mask_depth = int(m.mask_depth)
        self.keep_rate = float(m.keep_rate)
        self.fix_steps = int(m.fix_steps)
        device, d = data.device, self.embedding_size
        bi = data.extras["bi_adj"]
        n = self.n_nodes = bi.n_rows
        self.nnz = bi.nnz
        self.rows, self.cols = bi.rows, bi.cols          # row-sorted
        self.norm_vals = bi.vals
        self.adj = csr_graph_from_edges(bi.rows, bi.cols, n, n)
        # the seed scores' constant counts: the degree and the second-order
        # count A·deg − 2·deg, integers, exact in float32 as in the JAX model
        r, c = bi.rows.cpu().numpy(), bi.cols.cpu().numpy()
        deg = np.bincount(r, minlength=n).astype(np.float64)
        second = np.bincount(r, weights=deg[c], minlength=n) - 2 * deg
        self.order = torch.from_numpy(deg.astype(np.float32)[:, None]).to(device)
        self.seed_count = torch.from_numpy((deg + second).astype(np.float32)[:, None]).to(device)
        # the fixed decoder of generate(): the bi-adjacency, validity 1
        self.fixed_dec = (segment_layout_from_ids(bi.rows, n), segment_layout_from_ids(bi.cols, n),
                          torch.ones(self.nnz, device=device))

        dist_train.ui_tables(self, cfg, d, device)
        self.gt = nn.ModuleList([nn.ParameterDict({
            k: nn.Parameter(torch.empty(d, d, device=device)) for k in ("q", "k", "v")})
            for _ in range(self.gt_layer)])

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier-uniform tables and attention matrices, drawn from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for p in (lay[k] for lay in self.gt for k in ("q", "k", "v")):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def _embeds(self):
        """``[users; items]``, whole (gathered from the row shards on a mesh)."""
        return dist_train.ui_nodes(self)

    # -- seed scores (differentiable) ------------------------------------------
    def _seed_scores(self) -> torch.Tensor:
        embeds = self._embeds()
        fst = spmm(self.adj, embeds) - embeds
        scd = (spmm(self.adj, fst) - fst) - self.order * embeds
        sub = (fst + scd) / (self.seed_count + 1e-8)
        sub = sub / torch.sqrt((sub * sub).sum(-1, keepdim=True) + 1e-12)
        emb = embeds / torch.sqrt((embeds * embeds).sum(-1, keepdim=True) + 1e-12)
        return torch.sigmoid((sub * emb).sum(-1))

    # -- the view bank -------------------------------------------------------------
    def view_draws(self, gen: torch.Generator) -> dict:
        """One view's uniforms on ``gen``'s device: the seeds' Gumbel noise in
        [1e-8, 1) ``[N]``, the node sample's ``[N]``, and the pair draws'
        ``[nnz]`` for the rows and for the cols."""
        dev, n = gen.device, self.n_nodes
        return {"noise": torch.rand(n, generator=gen, device=dev) * (1.0 - 1e-8) + 1e-8,
                "sample_u": torch.rand(n, generator=gen, device=dev),
                "rows_u": torch.rand(self.nnz, generator=gen, device=dev),
                "cols_u": torch.rand(self.nnz, generator=gen, device=dev)}

    def one_view(self, draws: dict) -> dict:
        """The encoder values and decoder edges of one view, from the current
        parameters and ``draws`` (as :meth:`view_draws` gives them)."""
        n, dev = self.n_nodes, self.rows.device
        noisy = (torch.log(self._seed_scores() + 1e-12)
                 - torch.log(-torch.log(draws["noise"])))
        closure = torch.zeros(n, device=dev)
        closure[torch.topk(noisy, self.seed_num).indices] = 1.0
        for _ in range(self.mask_depth - 1):
            closure = torch.clamp(closure + spmm(self.adj, closure[:, None])[:, 0], 0.0, 1.0)
        keep = ((closure[self.rows] == 0) & (closure[self.cols] == 0)).to(self.user_embeds.dtype)
        mask_nodes = torch.clamp(closure + (draws["sample_u"] < self.keep_rate).float(),
                                 0.0, 1.0)
        cdf = torch.cumsum(mask_nodes, 0)

        def draw(u):
            return torch.clamp(torch.searchsorted(cdf, u * cdf[-1]), 0, n - 1)

        rand_rows, rand_cols = draw(draws["rows_u"]), draw(draws["cols_u"])
        deg = spmm(self.adj, torch.ones(n, 1, device=dev, dtype=keep.dtype), keep)[:, 0]
        dinv = (deg + 1e-12) ** -0.5
        loops = torch.arange(n, device=dev)
        dec_rows = torch.cat([rand_rows, rand_cols, loops, self.rows.long()])
        dec_cols = torch.cat([rand_cols, rand_rows, loops, self.cols.long()])
        return {"enc_vals": keep * dinv[self.rows] * dinv[self.cols], "keep": keep,
                "rand_rows": rand_rows, "rand_cols": rand_cols,
                "dec": (segment_layout_from_ids(dec_rows, n),
                        segment_layout_from_ids(dec_cols, n),
                        torch.cat([torch.ones(2 * self.nnz + n, device=dev, dtype=keep.dtype),
                                   keep]))}

    @torch.no_grad()
    def epoch_state(self, gen: torch.Generator | None, epoch: int,
                    draws: list | None = None) -> dict:
        """The epoch's ⌈steps / fix_steps⌉ views from the epoch-start
        parameters; ``draws`` (else drawn from ``gen``), one dict per view."""
        n_views = -(-self._n_batches_hint // self.fix_steps)
        draws = [self.view_draws(gen) for _ in range(n_views)] if draws is None else draws
        return {"views": [self.one_view(d) for d in draws]}

    # -- forward and loss ------------------------------------------------------------
    def forward(self, enc_vals, dec=None):
        embeds = self._embeds()
        acc, x = [embeds], embeds
        for _ in range(self.gcn_layer):
            x = spmm(self.adj, x, EdgeMask(enc_vals))
            acc.append(x)
        if dec is not None:
            for p in self.gt:
                acc.append(gt_attention(p, *dec, acc[-1], self.head_num))
        total = sum(acc)
        return total[: self.user_num], total[self.user_num:]

    @staticmethod
    def _contrast(nodes, e1, e2=None):
        e2 = e1 if e2 is None else e2
        return torch.logsumexp(e1[nodes] @ e2.T, dim=-1).mean()

    def loss(self, batch: dict, key=None):
        step = int(batch["step"])
        view = batch["aux"]["views"][step // self.fix_steps]
        user_embeds, item_embeds = self.forward(view["enc_vals"], view["dec"])
        ancs, poss = batch["user"], batch["pos"]
        rec = -(user_embeds[ancs] * item_embeds[poss]).sum(-1).mean()
        reg = self.reg_weight * dist_train.reg_params(self, self.mesh)
        cl = ((self._contrast(ancs, user_embeds) + self._contrast(poss, item_embeds))
              * self.ssl_reg + self._contrast(ancs, user_embeds, item_embeds))
        # the infomax term only where the views regenerate: elsewhere JAX's
        # where() gives it value 0 and no gradient
        infomax = (-self._seed_scores().mean() if step % self.fix_steps == 0
                   else rec.new_zeros(()))
        return rec + reg + cl + infomax, {"rec_loss": rec, "reg_loss": reg, "cl_loss": cl,
                                          "infomax_loss": infomax}

    def generate(self):
        return self.forward(self.norm_vals, self.fixed_dec)
