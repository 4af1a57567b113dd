"""MAERec: a graph masked autoencoder over the item transition graph that
drives a sequential transformer (port of
``sslrec_tpu/models/sequential/maerec.py``).

- The item graph: pairs at distance 1–3 in the (expanded) train rows, both
  directions, self loops, binarised and D^-1/2 A D^-1/2 normalised.
- Its B1 layout is all ones over (rows, cols); every sum takes the call's
  values as a constant multiplier: the encoder's hops (the epoch's masked
  values, d 64), the path scores' hops (d 64 and d 1) and degree sums (d 1),
  the mask closure's spread (d 1).
- ``epoch_state`` builds the epoch's mask bank, one view per ``mask_steps``
  steps: Gumbel-noised path scores → the top ``num_mask_cand`` seeds
  (ties toward the lower id) → a closure spread ``mask_depth − 1`` times with
  ``path_prob^i`` thinning → the edges touching it masked, the rest
  renormalised.
- :meth:`MAERec.train_step` is the model's own step: ``con_batch`` masked
  edges drawn by inverse CDF, negatives in [1, n) rejected against the
  item-item edge set (half corrupt each end), the decoder's NCE, L2 over
  every parameter, and on each mask step −mean(path scores)·reward, the
  reward from the main-loss history the model carries (and a train state
  saves, through ``extra_state``); then its own Adam
  (weight decay first where set, as ``optax.chain`` orders it).  The path
  scores' term is 0 off the mask steps, so it is computed only on them.

On a mesh the step's batch is a ``data`` slice: the tower runs on it (its
dropout masks the whole batch's, sliced) and ``loss_main`` is its mean; the
decoder's contrast, the L2 and the mask step's path-score term read no
batch and are computed alike on every rank, so under ``mesh_backward``'s
shares (summing to 1) they count once.  The step sums the gradients over
the mesh (``sync_model_grads``) before its Adam, and records the whole
batch's ``loss_main`` (its shares summed over ``data``) in the history, so
that the reward and ``extra_state()`` are the single run's on every rank.

Draws (:class:`StepDraws`): per view ``path_keep<i>`` [nnz] for i <
mask_depth, ``path_u`` [n] and ``thin<i>`` [n] for i < mask_depth − 1; per
step ``edge_u`` [con_batch], ``vneg`` / ``uneg`` candidate rounds [6,
con_batch·half], ``drop`` (the tower), and on a mask step ``path_keep<i>``
and ``path_u``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from sslrec_tpu_torch.data.sampling import pick_negatives
from sslrec_tpu_torch.models import layers, losses
from sslrec_tpu_torch.models.base import apply_linear, linear_layer
from sslrec_tpu_torch.models.sequential.base_seq import SequentialModel
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.sparse import CooGraph
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, build_csr_graph
from sslrec_tpu_torch.ops.topk import topk_indices
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.trainer.trainer import build_optimizer
from sslrec_tpu_torch.utils.initializers import xavier_uniform

NEG_ROUNDS = 6


def transition_graph(seqs: np.ndarray, n_items1: int):
    """Host: the binarised distance-≤3 graph with self loops (scipy) and its
    normalised values ``(rows, cols, vals)`` sorted by (row, col)."""
    r, c = [], []
    for dist in range(1, 4):
        a = seqs[:, dist:].reshape(-1)
        b = seqs[:, :-dist].reshape(-1)
        live = (a > 0) & (b > 0)
        r.extend([a[live], b[live]])
        c.extend([b[live], a[live]])
    pairs = np.unique(np.stack([np.concatenate(r), np.concatenate(c)], 1), axis=0)
    ii = sp.coo_matrix((np.ones(len(pairs), np.float32), (pairs[:, 0], pairs[:, 1])),
                       shape=(n_items1, n_items1))
    ii = ((ii + sp.eye(n_items1)) != 0) * 1.0
    norm = sparse_ops.normalize_adj_sym(ii, eps=0.0).tocoo()
    order = np.lexsort((norm.col, norm.row))
    return ii, (norm.row[order].astype(np.int32), norm.col[order].astype(np.int32),
                norm.data[order].astype(np.float32))


class MAERec(SequentialModel):
    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.con_batch = int(m.con_batch)
        self.num_reco_neg = int(m.num_reco_neg)
        self.reg = float(m.reg)
        self.ssl_reg = float(m.ssl_reg)
        self.mask_depth = int(m.mask_depth)
        self.path_prob = float(m.path_prob)
        self.num_gcn_layers = int(m.num_gcn_layers)
        self.num_trm_layers = int(m.num_trm_layers)
        self.num_mask_cand = int(m.num_mask_cand)
        self.mask_steps = int(m.mask_steps)
        self.eps = float(m.eps)
        self.n_items1 = self.item_num + 1
        dev, n = self.device, self.n_items1

        ii, (rows, cols, vals) = transition_graph(
            data.extras["train_arrays"]["seq"].cpu().numpy(), n)
        rows_t, cols_t = torch.from_numpy(rows), torch.from_numpy(cols)
        self.graph = build_csr_graph(CooGraph(rows=rows_t, cols=cols_t,
                                              vals=torch.ones(rows.shape[0]), n_rows=n,
                                              n_cols=n), dev)
        self.rows, self.cols = rows_t.long().to(dev), cols_t.long().to(dev)
        self.norm_vals = torch.from_numpy(vals).to(dev)
        self.nnz = int(rows.shape[0])
        self.ii_edge_set = sparse_ops.build_edge_set(ii, device=dev)

        d, g = self.emb_size, self.num_gcn_layers
        self.emb, self.layers = layers.tower_params(None, d, self.max_len,
                                                    self.num_trm_layers, dev)
        self.item_emb = nn.Parameter(torch.empty(n, d, device=dev))
        self.dec = nn.ModuleDict({"l1": linear_layer(d * g * g, d * g, dev),
                                  "l2": linear_layer(d * g, d, dev),
                                  "l3": linear_layer(d, 1, dev)})
        self.opt = build_optimizer(cfg, self.parameters())
        # the main loss of the last three steps and how many there were
        self.loss_hist = torch.zeros(3, device=dev)
        self.hist_len = 0

    def optimizers(self) -> dict:
        return {"adam": self.opt}

    def extra_state(self) -> dict:
        """The loss history the reward reads, for the train state: the JAX
        package carries it in its optimizer state, so a checkpoint saves it."""
        return {"loss_hist": self.loss_hist.detach().cpu().clone(), "hist_len": int(self.hist_len)}

    def load_extra_state(self, state: dict) -> None:
        self.loss_hist = state["loss_hist"].to(self.loss_hist.device)
        self.hist_len = int(state["hist_len"])

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """The tower as BERT4Rec's (no token table), Xavier items and decoder
        weights, zero decoder biases; the loss history emptied."""
        layers.init_tower(gen, self.emb, self.layers)
        self.item_emb.copy_(xavier_uniform(gen, tuple(self.item_emb.shape)))
        for lin in self.dec.values():
            lin["w"].copy_(xavier_uniform(gen, tuple(lin["w"].shape)))
            lin["b"].zero_()
        self.loss_hist.zero_()
        self.hist_len = 0

    # -- sums over the item graph ---------------------------------------------
    def _hop(self, x, vals=None):
        """``Σ_e vals[e]·x[col_e]`` into each row (all ones where ``vals`` is None)."""
        return spmm(self.graph, x, None if vals is None else EdgeMask(vals))

    def _ones(self):
        return self.item_emb.new_ones(self.n_items1, 1)

    def encode_items(self, enc_vals):
        embeds = [self.item_emb]
        for _ in range(self.num_gcn_layers):
            embeds.append(self._hop(embeds[-1], enc_vals))
        return sum(embeds), embeds

    def _seq_tower(self, seqs, item_emb, drop=None):
        x = layers.take_rows(item_emb, seqs) + self.emb["pos"][None, : seqs.shape[1], :]
        x = x if drop is None else drop(x)
        return layers.apply_layers(self.layers, x, seqs, self.n_heads, drop)[:, -1, :]

    def path_scores(self, dr):
        """``(scores, scores + Gumbel noise)`` of every item: its embedding's
        cosine with the path-probability-decayed mean of its neighbourhood."""
        embeds = self.item_emb
        order = self._hop(self._ones())
        emb, num = [self._hop(embeds) - embeds], [order]
        vals = None
        for i in range(self.mask_depth):
            keep = dr.keep(f"path_keep{i}", self.path_prob ** (i + 1), (self.nnz,)).float()
            vals = keep if vals is None else vals * keep
            emb.append((self._hop(emb[-1], vals) - emb[-1]) - order * emb[-1])
            num.append((self._hop(num[-1], vals) - num[-1]) - order)
            order = self._hop(self._ones(), vals)
        sub = sum(emb) / (sum(num) + 1e-8)
        sub = sub / torch.sqrt((sub * sub).sum(-1, keepdim=True) + 1e-12)
        en = embeds / torch.sqrt((embeds * embeds).sum(-1, keepdim=True) + 1e-12)
        scores = (sub * en).sum(-1)
        u = dr.uniform("path_u", (self.n_items1,), low=1e-8)
        return scores, scores - torch.log(-torch.log(u))

    # -- the epoch's mask bank --------------------------------------------------
    @torch.no_grad()
    def one_view(self, dr) -> dict:
        _, noisy = self.path_scores(dr)
        closure = torch.zeros(self.n_items1, device=self.item_emb.device)
        closure[topk_indices(noisy, self.num_mask_cand)] = 1.0
        for i in range(self.mask_depth - 1):
            spread = self._hop(closure[:, None])[:, 0] > 0
            thin = dr.keep(f"thin{i}", self.path_prob ** (i + 1), (self.n_items1,))
            closure = (closure + spread.float() * thin.float()).clamp(0.0, 1.0)
        masked = (closure[self.rows] > 0) | (closure[self.cols] > 0)
        keep = (~masked).float()
        dinv = (self._hop(self._ones(), keep)[:, 0] + 1e-12) ** -0.5
        return {"enc_vals": keep * dinv[self.rows] * dinv[self.cols],
                "masked": masked.float()}

    @torch.no_grad()
    def epoch_state(self, gen, epoch: int, draws: list | None = None) -> dict:
        """``ceil(steps / mask_steps)`` views, stacked: ``enc_vals`` and
        ``masked`` [V, nnz]; ``draws`` gives each view's (tests)."""
        n_views = -(-self._n_batches_hint // self.mask_steps)
        views = [self.one_view(self.draws(gen, None if draws is None else draws[v]))
                 for v in range(n_views)]
        return {k: torch.stack([v[k] for v in views]) for k in views[0]}

    # -- the decoder's NCE -------------------------------------------------------
    def decoder_loss(self, emb_list, pos, neg):
        g = self.num_gcn_layers

        def pair_feat(a, b):
            return torch.cat([layers.take_rows(emb_list[i], a) * layers.take_rows(emb_list[j], b)
                              for i in range(g) for j in range(g)], -1)

        def mlp(x):
            h = torch.relu(apply_linear(self.dec["l1"], x))
            h = torch.relu(apply_linear(self.dec["l2"], h))
            return torch.sigmoid(apply_linear(self.dec["l3"], h)[..., 0])

        pos_scr = torch.exp(mlp(pair_feat(pos[:, 0], pos[:, 1])))
        neg_scr = torch.exp(mlp(pair_feat(neg[:, :, 0], neg[:, :, 1])))
        denom = neg_scr.sum(-1) + pos_scr
        return -torch.log(pos_scr / (denom + 1e-8) + 1e-8).sum()

    def _negatives(self, dr, name, anchors):
        cands = dr.randint(name, 1, self.n_items1, (NEG_ROUNDS, anchors.shape[0]))
        return pick_negatives(cands.to(anchors.device).to(torch.int32), anchors,
                              self.ii_edge_set).long()

    # -- the model's own step ---------------------------------------------------------
    def train_step(self, batch: dict, gen, draws: dict | None = None) -> dict:
        dr = self.step_draws(gen, draws, batch)
        step = int(batch["step"])
        mask_step = step % self.mask_steps == 0
        view = {k: v[step // self.mask_steps] for k, v in batch["aux"].items()}

        cdf = torch.cumsum(view["masked"], 0)
        u = dr.uniform("edge_u", (self.con_batch,)) * cdf[-1].clamp(min=1.0)
        eidx = torch.searchsorted(cdf, u).clamp(0, self.nnz - 1)
        pos = torch.stack([self.rows[eidx], self.cols[eidx]], 1)
        half = self.num_reco_neg // 2
        anc_v, anc_u = pos[:, 0].repeat_interleave(half), pos[:, 1].repeat_interleave(half)
        vneg = self._negatives(dr, "vneg", anc_v)
        uneg = self._negatives(dr, "uneg", anc_u)
        neg = torch.cat([torch.stack([anc_v, vneg], 1).reshape(self.con_batch, half, 2),
                         torch.stack([uneg, anc_u], 1).reshape(self.con_batch, half, 2)], 1)

        hist = self.loss_hist
        reward = (1.0 if self.hist_len < 3 else
                  torch.where(hist[1] - hist[2] > hist[0] - hist[1], 1.0, self.eps))

        item_emb, emb_list = self.encode_items(view["enc_vals"])
        h = self._seq_tower(batch["seq"], item_emb, dr.dropout("drop", self.dropout_rate))
        loss_main = losses.next_item_ce(h @ item_emb.T, batch["pos"])
        loss_reco = self.decoder_loss(emb_list, pos, neg) * self.ssl_reg
        loss_regu = losses.reg_params(dict(self.named_parameters())) * self.reg
        if mask_step:
            scores, _ = self.path_scores(dr)
            loss_mask = -scores.mean() * reward
        else:
            loss_mask = torch.zeros((), device=hist.device)
        total = loss_main + loss_reco + loss_regu + loss_mask
        self.opt.zero_grad(set_to_none=True)
        lm = loss_main.detach()
        if self.mesh is None:
            total.backward()
        else:
            dist_train.mesh_backward(total, self.mesh, batch["share"])
            dist_train.sync_model_grads(self, self.mesh)
            lm = dist_train.reduce_terms({"lm": lm}, self.mesh, batch["share"])["lm"]
        self.opt.step()

        self.loss_hist = torch.stack([hist[2] if mask_step else hist[1], hist[2], lm])
        self.hist_len = min(self.hist_len + 1, 3)
        return {"loss": total.detach(), "loss_main": loss_main.detach(),
                "loss_reco": loss_reco.detach(),
                "loss_regu": loss_regu.detach(), "loss_mask": loss_mask.detach()}

    # -- evaluation -----------------------------------------------------------------
    def predict_context(self):
        return self.encode_items(self.norm_vals)[0]

    def encode_for_predict(self, seqs, ctx):
        return self._seq_tower(seqs, ctx)

    def item_logits_params(self, ctx):
        return ctx, ctx.new_zeros(ctx.shape[0])
