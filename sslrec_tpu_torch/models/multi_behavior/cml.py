"""CML: contrastive meta learning over behaviors, with a meta-weight network
and three rounds of updates a batch (port of
``sslrec_tpu/models/multi_behavior/cml.py``).

- GCN (:class:`BehaviorGCN`, shared with KMCLR): per layer, every behavior's
  A·items and AT·users (B1), their mean through ``sigmoid(· W_l)``, and each
  behavior's user side through the same ``W_l`` kept apart; the layers side
  by side, projected by ``u_cat_w`` / ``i_cat_w``.
- Sampling (:class:`BehaviorSampler`, shared with KMCLR), per behavior: a
  global item kept where it is one of the user's edges, else a draw from
  the user's own row, else invalid (masked out of the loss); the target
  behavior takes the batch's positive; a negative rejected against the
  behavior's edges.
- ``_ssl``: 10% of the batch's users; per behavior the InfoNCE between the
  target behavior's and the behavior's user embeddings, whose negatives
  leave out the user's own ``SSL_batch`` chunk; NaN becomes 1e-8.
- The meta-weight net (:class:`MetaWeightNet`) weighs each behavior's
  per-user SSL and BPR terms through PReLU, dropout (rate 0.5) and a batch
  norm over the whole vector (population variance, + 1e-5).
- :meth:`CML.train_step`, three rounds a batch:
  1. the weighted loss; one AdamW step from fresh state on a clone of the
     GCN (the clone only), then a step of the meta AdamW on the meta net's
     gradient;
  2. the clone's GCN (a constant: ``torch.func.functional_call`` over the
     clone's tables, without gradient, so its hops have no dx) for
     ``meta_batch`` meta users with their own behavior draws, at half
     weight; a second meta step;
  3. the weighted loss under the meta net's weights held constant
     (``functional_call`` over detached copies); a step of the model AdamW.

  Both AdamWs (clip 20 on the global norm, then AdamW) are built over every
  parameter, as optax's states cover the whole tree, and each step fills
  the other half's gradient with zeros: optax decays every leaf, so the
  meta steps shrink the GCN's tables by ``lr·wd`` and the model step the
  meta net's.  Their learning rates follow the cyclic schedules of
  :func:`cyclic_lr` on the epoch (model: up 5, down 10 epochs; meta: up 2,
  down 3), computed in float32 as the JAX package computes them.

Under ``train.mesh`` (the JAX package's ``cml.py:121-147``): on a
``model`` axis of M > 1 the GCN's ``user_emb`` and ``item_emb`` are
row-sharded (``row_shards``) and its weights and the meta net replicated;
each behavior's A and AT run as one graph-partitioned bidirectional hop a
layer (``dist_train.maybe_partition_bi``, A's and AT's values in the
partition), and the GCN's outputs are read whole
(``dist_train.whole_table``, a gather with autograd).  Every term of a
round either crosses the batch (the meta net's batch norm over the whole
weight vector, the InfoNCE's sampled tenth of the batch and its chunks,
round 2's meta users, whom the whole batch's draws pick) or costs little
beside the hops (the BPR rows), so a ``data`` rank gathers the batch's
users and positives (``dist_train.gather_batch``) and computes the whole
batch's rounds, with the single run's draws; its slice's share weights its
backward (``dist_train.mesh_backward``), so that the ``data`` sum is the
whole batch's gradient.  Each round's gradients are summed
(``sync_model_grads``: replicated ones over ``model``, all over ``data``)
before the clip, whose norm is ``dist_train.global_norm`` over the ranks'
row shards, and the AdamW steps; the clone's tables stay row shards, as do
both AdamWs' moments of the sharded tables.

Draws by name (:class:`StepDraws`; a test gives them): the sampler's
``glob{b}`` (indices into the behavior's items), ``off{b}`` (uniforms, the
row offsets) and ``neg{b}``, the meta users' under the prefix ``m``, and
``meta_idx``; per round ``r`` (1, 2, 3) ``r{r}.perm`` and the meta net's
keep masks ``r{r}.ssl_in{b}`` [s, 3d/2], ``r{r}.ssl_out{b}`` [s],
``r{r}.ssl3{b}`` [s, 1], ``r{r}.rs_in{b}`` [n, 3d/2], ``r{r}.rs_out{b}`` [n]
and ``r{r}.rs3{b}`` [n, 1].  The JAX package draws the BPR side's three
masks from one key (so they share its random bits); the port draws them
apart, as the reference's three dropouts are.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.data.sampling import sample_from_rows, sample_negatives
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.trainer.trainer import clip_grad_global_norm
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform


def cyclic_lr(epoch: int, base: float, mx: float, up: int = 5, down: int = 10) -> float:
    """The triangular schedule: ``base`` to ``mx`` over ``up`` epochs, back
    over ``down``, in float32 as the JAX package's jitted step computes it
    (``base + (mx - base) · frac`` fused, rounded to float32 once)."""
    f32 = np.float32
    pos = f32(epoch) % f32(up + down)
    frac = pos / f32(up) if pos < up else f32(1.0) - (pos - f32(up)) / f32(down)
    return float(f32(np.float64(f32(mx - base)) * np.float64(frac) + np.float64(f32(base))))


def partition_behaviors(cfg, graphs, n_users: int, n_items: int, device):
    """The mesh of ``train.mesh`` and, on a model-sharded one, each behavior's
    A (users ← items) and AT (items ← users) as one bidirectional
    ``ShardedGraph`` over ``[users; items]`` with their values (else None)."""
    mesh, sgs = mesh_from_config(cfg, device), None
    if dist_train.model_sharded(mesh):
        sgs = []
        for a, at in graphs:
            rows = torch.cat([a.rows.long(), n_users + at.rows.long()])
            cols = torch.cat([n_users + a.cols.long(), at.cols.long()])
            vals = torch.cat([a.vals, at.vals])
            sgs.append(dist_train.maybe_partition_bi(cfg, rows, cols, n_users, n_items, vals,
                                                     device)[1])
    return mesh, sgs


class BehaviorGCN(nn.Module):
    """The multi-behavior GCN of CML and KMCLR: ``forward()`` gives the user
    and item embeddings and the per-behavior user embeddings ``[n_beh, U, d]``.

    On a model-sharded ``mesh`` (``sgs``: :func:`partition_behaviors`' graphs)
    the tables are this rank's row shards, each behavior's two hops a layer
    are one partitioned hop, and ``forward()`` gathers its outputs whole."""

    def __init__(self, graphs, n_users: int, n_items: int, d: int, n_layers: int, device,
                 mesh=None, sgs=None):
        super().__init__()
        self.graphs = graphs
        self.n_users, self.n_items, self.mesh, self.sgs = n_users, n_items, mesh, sgs
        self.user_emb = nn.Parameter(torch.empty(dist_train.shard_rows(n_users, mesh), d,
                                                 device=device))
        self.item_emb = nn.Parameter(torch.empty(dist_train.shard_rows(n_items, mesh), d,
                                                 device=device))
        self.u_cat_w = nn.Parameter(torch.empty(n_layers * d, d, device=device))
        self.i_cat_w = nn.Parameter(torch.empty(n_layers * d, d, device=device))
        self.u_w = nn.ParameterList([nn.Parameter(torch.empty(d, d, device=device))
                                     for _ in range(n_layers)])
        self.i_w = nn.ParameterList([nn.Parameter(torch.empty(d, d, device=device))
                                     for _ in range(n_layers)])

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        """Xavier everywhere, in the JAX package's order (the whole tables
        drawn, a rank's rows kept)."""
        for p, n in ((self.user_emb, self.n_users), (self.item_emb, self.n_items)):
            p.copy_(dist_train.own_rows(xavier_uniform(gen, (n, p.shape[1])), p.shape[0],
                                        self.mesh))
        for p in (self.u_cat_w, self.i_cat_w, *self.u_w, *self.i_w):
            p.copy_(xavier_uniform(gen, tuple(p.shape)))

    def forward(self):
        u, i = self.user_emb, self.item_emb
        n_beh = len(self.graphs)
        cat_u, cat_i, cat_us = [], [], []
        for uw, iw in zip(self.u_w, self.i_w):
            if self.sgs is None:
                us = [spmm(a, i) for a, _ in self.graphs]
                is_ = [spmm(at, u) for _, at in self.graphs]
            else:
                hops = [dist_train.mesh_partitioned_propagate(self.mesh, sg, u, i, None, 1, "last")
                        for sg in self.sgs]
                us, is_ = [h[0] for h in hops], [h[1] for h in hops]
            u = torch.sigmoid(sum(us) / n_beh @ uw)
            i = torch.sigmoid(sum(is_) / n_beh @ iw)
            cat_u.append(u)
            cat_i.append(i)
            cat_us.append(torch.stack([torch.sigmoid(x @ uw) for x in us]))
        ue = torch.cat(cat_u, -1) @ self.u_cat_w
        ie = torch.cat(cat_i, -1) @ self.i_cat_w
        ues = torch.cat(cat_us, -1) @ self.u_cat_w
        if self.sgs is None:
            return ue, ie, ues
        whole = dist_train.whole_table
        return (whole(ue, self.n_users, self.mesh), whole(ie, self.n_items, self.mesh),
                whole(ues.transpose(0, 1), self.n_users, self.mesh).transpose(0, 1))


class BehaviorSampler:
    """Per-behavior positives and negatives of CML and KMCLR (``CMLData.ng_sample``)."""

    def __init__(self, mats, item_num: int, device):
        self.item_num = item_num
        self.csr, self.edges, self.items = [], [], []
        for m in mats:
            csr = m.tocsr()
            self.csr.append((torch.from_numpy(csr.indptr.astype(np.int64)).to(device),
                             torch.from_numpy(csr.indices.astype(np.int64)).to(device)))
            self.edges.append(sparse_ops.build_edge_set(m, device=device))
            self.items.append(torch.from_numpy(
                np.unique(m.tocoo().col).astype(np.int64)).to(device))

    def sample(self, dr: StepDraws, prefix: str, users: torch.Tensor,
               target_pos: torch.Tensor | None):
        """Per behavior the positives (0 where invalid), the negatives and the
        validity as float; the last behavior takes ``target_pos`` where given."""
        pos_l, neg_l, valid_l = [], [], []
        n, last = users.shape[0], len(self.csr) - 1
        for b, ((indptr, indices), edges, items) in enumerate(
                zip(self.csr, self.edges, self.items)):
            if b == last and target_pos is not None:
                pos, valid = target_pos, torch.ones_like(users, dtype=torch.bool)
            else:
                glob = items[dr.randint(f"{prefix}glob{b}", 0, items.shape[0], (n,)).long()]
                own, deg = sample_from_rows(indptr, indices, users,
                                            dr.uniform(f"{prefix}off{b}", (n,))[:, None])
                is_edge = edges.contains(users, glob)
                pos = torch.where(is_edge, glob, own[:, 0])
                valid = is_edge | (deg > 0)
            negs = dr.draw(f"{prefix}neg{b}", lambda: sample_negatives(
                dr.gen, users, edges, self.item_num)).long()
            pos_l.append(torch.where(valid, pos, torch.zeros_like(pos)))
            neg_l.append(negs)
            valid_l.append(valid.float())
        return pos_l, neg_l, valid_l


def ssl_terms(sub: torch.Tensor, user_embeds: torch.Tensor, d: int, ssl_batch: int):
    """Per behavior ``-log(1e-8 + pos / (neg + 1e-8))`` for the users ``sub``:
    the target behavior's embedding against the behavior's, the negatives
    every other user outside one's own ``ssl_batch`` chunk."""
    s = sub.shape[0]
    chunk = torch.arange(s, device=sub.device) // ssl_batch
    same = chunk[:, None] == chunk[None, :]
    e1 = F.embedding(sub, user_embeds[-1])
    out = []
    for b in range(user_embeds.shape[0]):
        e2 = F.embedding(sub, user_embeds[b])
        scores = torch.exp(e1 @ e2.T / (d + 1e-8))
        pos = torch.exp((e1 * e2).sum(-1) / (d + 1e-8))
        neg = torch.where(same, torch.zeros_like(scores), scores).sum(-1)
        out.append(-torch.log(1e-8 + pos / (neg + 1e-8)))
    return out


def ssl_users(perm: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
    """The first tenth (at least one) of ``users`` under ``perm``."""
    return users[perm[: max(users.shape[0] // 10, 1)].long()]


class MetaWeightNet(nn.Module):
    """Per-behavior weights of the SSL and BPR terms (``MetaWeightNet``)."""

    _LINEARS = ("ssl1", "ssl2", "ssl3", "rs1", "rs2", "rs3")

    def __init__(self, d: int, n_beh: int, ipm: float, device):
        super().__init__()
        self.d, self.ipm = d, ipm
        shapes = {"ssl1": (3 * d, 3 * d // 2), "ssl2": (3 * d // 2, 1), "ssl3": (2 * d, 1),
                  "rs1": (3 * d, 3 * d // 2), "rs2": (3 * d // 2, 1), "rs3": (d, 1)}
        for k in self._LINEARS:
            setattr(self, k, linear_layer(*shapes[k], device))
        self.prelu = nn.Parameter(torch.empty((), device=device))
        self.beh_emb = nn.Parameter(torch.empty(n_beh, d, device=device))

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> None:
        for k in self._LINEARS:
            lin = getattr(self, k)
            for name, v in linear_params(gen, *lin["w"].shape).items():
                lin[name].copy_(v)
        self.prelu.fill_(0.25)
        self.beh_emb.copy_(xavier_uniform(gen, tuple(self.beh_emb.shape)))

    def forward(self, dr: StepDraws, tag: str, info_list, beh_list, sub, users,
                user_embeds, user_embed):
        d, ipm = self.d, self.ipm

        def prelu(x):
            return torch.where(x >= 0, x, self.prelu * x)

        def bnorm(x):
            return (x - x.mean()) / torch.sqrt(x.var(correction=0) + 1e-5)

        def drop(name, x):
            keep = dr.keep(name, 0.5, tuple(x.shape))
            return torch.where(keep, x / 0.5, torch.zeros_like(x))

        ue_sub = F.embedding(sub, user_embed)
        ue_users = F.embedding(users, user_embed)
        info_w, beh_w = [], []
        for b, (il, bl) in enumerate(zip(info_list, beh_list)):
            ue_b = F.embedding(sub, user_embeds[b])
            ssl_in = ipm * torch.cat([ipm * torch.cat([il[:, None].expand(-1, d) * ipm, ue_b], 1),
                                      ue_sub], 1)
            ssl_in3 = ipm * (il[:, None].expand(-1, 2 * d) * torch.cat([ue_b, ue_sub], 1))
            h = drop(f"{tag}.ssl_in{b}", prelu(apply_linear(self.ssl1, ssl_in)))
            o = drop(f"{tag}.ssl_out{b}", apply_linear(self.ssl2, h)[:, 0])
            w1 = ipm * torch.sigmoid(bnorm(math.sqrt(ssl_in.shape[1]) * o))
            w3 = ipm * torch.sigmoid(bnorm(drop(f"{tag}.ssl3{b}", prelu(
                apply_linear(self.ssl3, ssl_in3)))[:, 0]))
            info_w.append((w1 + w3) / 2.0)

            ueb_users = F.embedding(users, user_embeds[b])
            rs_in = ipm * torch.cat([ipm * torch.cat([bl[:, None].expand(-1, d) * ipm, ue_users],
                                                     1), ueb_users], 1)
            rs_in3 = ipm * (bl[:, None].expand(-1, d) * ue_users)
            h = drop(f"{tag}.rs_in{b}", prelu(apply_linear(self.rs1, rs_in)))
            o = drop(f"{tag}.rs_out{b}", apply_linear(self.rs2, h)[:, 0])
            rw1 = ipm * torch.sigmoid(bnorm(math.sqrt(rs_in.shape[1]) * o))
            rw3 = ipm * torch.sigmoid(bnorm(drop(f"{tag}.rs3{b}", prelu(
                apply_linear(self.rs3, rs_in3)))[:, 0]))
            beh_w.append(rw1 + rw3)
        return info_w, beh_w


def adamw_first_step(p, g, lr: float, wd: float, b1=0.9, b2=0.999, eps=1e-8):
    """``p`` after one step of a fresh optax AdamW on ``g``, as optax
    computes it (moments from zero, bias-corrected at count 1)."""
    mu = (1 - b1) * g
    nu = (1 - b2) * g * g
    upd = (mu / (1 - b1)) / (torch.sqrt(nu / (1 - b2)) + eps)
    return p + (-lr) * (upd + wd * p)


class CML(RecModel):
    mesh_todo = None
    step_generator = True
    batch_fields = ("user", "pos")

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m, t, o, dev = cfg.model, cfg.train, cfg.optimizer, data.device
        self.device = dev
        graphs = data.extras["behavior_graphs"]
        self.n_beh = len(graphs)
        self.hidden = int(m.hidden_dim)
        self.ipm = float(m.get("inner_product_mult", 1.0))
        self.meta_batch = int(t.get("meta_batch", 128))
        self.ssl_batch = int(t.get("SSL_batch", 30))
        self.reg = float(t.get("reg", 1e-3))
        self.beta = float(t.get("beta", 5e-3))
        self.batch_size = int(t.batch_size)
        meta_users = data.extras.get("meta_users")
        self.meta_users = (torch.arange(self.user_num, device=dev) if meta_users is None
                           else meta_users.long())
        self.mesh, sgs = partition_behaviors(cfg, graphs, self.user_num, self.item_num, dev)
        if sgs is not None:
            self.row_shards = {"gcn.user_emb": self.user_num, "gcn.item_emb": self.item_num}
        self.gcn = BehaviorGCN(graphs, self.user_num, self.item_num, self.hidden,
                               int(m.gnn_layer), dev, self.mesh, sgs)
        self.meta_net = MetaWeightNet(self.hidden, self.n_beh, self.ipm, dev)
        self.sampler = BehaviorSampler(data.extras["behavior_mats_scipy"], self.item_num, dev)
        wd = float(o.get("opt_weight_decay", 1e-4) or 1e-4)
        self.clone_lr, self.clone_wd = float(o.lr), wd
        self.lr_base, self.lr_max = float(o.get("opt_base_lr", 1e-3)), float(o.get("opt_max_lr", 5e-3))
        self.mlr_base = float(o.get("meta_opt_base_lr", 1e-4))
        self.mlr_max = float(o.get("meta_opt_max_lr", 1e-3))
        self.opt_model = torch.optim.AdamW(self.parameters(), lr=self.lr_base, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=wd)
        self.opt_meta = torch.optim.AdamW(
            self.parameters(), lr=self.mlr_base, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(o.get("meta_opt_weight_decay", 1e-4) or 1e-4))

    def optimizers(self) -> dict:
        """The model's and the meta net's AdamWs, which checkpoints save."""
        return {"model": self.opt_model, "meta": self.opt_meta}

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        self.gcn.init(gen)
        self.meta_net.init(gen)

    def epoch_state(self, gen, epoch: int) -> dict:
        return {"epoch": int(epoch)}

    # -- one weighted loss --------------------------------------------------------
    def _total(self, dr: StepDraws, tag: str, gcn_out, users, pos_l, neg_l, valid_l,
               meta: dict | None = None):
        """The meta-weighted loss of one round (``meta``: the meta net's
        tensors to use in place of its parameters), and its BPR and SSL parts."""
        ue, ie, ues = gcn_out
        ue_u = F.embedding(users, ue)
        beh_list = []
        for pos, neg, valid in zip(pos_l, neg_l, valid_l):
            pi = (ue_u * F.embedding(pos, ie)).sum(1) * self.ipm
            pj = (ue_u * F.embedding(neg, ie)).sum(1) * self.ipm
            beh_list.append(-torch.log(torch.sigmoid(pi - pj) + 1e-8) * valid)
        sub = ssl_users(dr.permutation(f"{tag}.perm", users.shape[0]), users)
        info_list = [torch.where(torch.isnan(c), torch.full_like(c, 1e-8), c)
                     for c in ssl_terms(sub, ues, self.hidden, self.ssl_batch)]
        args = (dr, tag, info_list, beh_list, sub, users, ues, ue)
        iw, bw = (self.meta_net(*args) if meta is None
                  else torch.func.functional_call(self.meta_net, meta, args))
        info_t = sum((il * w).sum() for il, w in zip(info_list, iw)) / self.n_beh
        beh_t = sum((bl * w).sum() for bl, w in zip(beh_list, bw)) / self.n_beh
        reg = ((ue_u ** 2).sum() + (F.embedding(pos_l[-1], ie) ** 2).sum()
               + (F.embedding(neg_l[-1], ie) ** 2).sum())
        return (beh_t + self.reg * reg + self.beta * info_t) / self.batch_size, beh_t, info_t

    def _backward(self, loss: torch.Tensor, batch: dict) -> None:
        """Backpropagate a round's ``loss`` (the whole batch's); on a mesh
        weighted by this ``data`` rank's share, and the gradients summed
        (``sync_model_grads``)."""
        if self.mesh is None:
            loss.backward()
            return
        dist_train.mesh_backward(loss, self.mesh, batch["share"])
        dist_train.sync_model_grads(self, self.mesh)

    def _step(self, opt, lr: float) -> None:
        """Clip the global norm over every parameter (a missing gradient is
        zero; over the ranks' row shards on a mesh) to 20, then one step of
        ``opt`` at ``lr``."""
        params = list(self.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_grad_global_norm(params, 20.0, dist_train.global_norm(self, self.mesh))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    # -- the three rounds -------------------------------------------------------------
    def train_step(self, batch: dict, gen, draws: dict | None = None) -> dict:
        dr = StepDraws(gen, draws, self.device)
        # on a data slice, the whole batch (the rounds cross it: the module's docstring)
        n = batch.get("n_whole", batch["user"].shape[0])
        users, pos = (dist_train.gather_batch(batch[k].long(), n, self.mesh)
                      for k in ("user", "pos"))
        epoch = batch["aux"]["epoch"]
        pos_l, neg_l, valid_l = self.sampler.sample(dr, "", users, pos)
        mlr = cyclic_lr(epoch, self.mlr_base, self.mlr_max, up=2, down=3)

        # round 1: a clone of the GCN one fresh AdamW step on, then a meta step
        self.zero_grad(set_to_none=True)
        total, _, _ = self._total(dr, "r1", self.gcn(), users, pos_l, neg_l, valid_l)
        self._backward(total, batch)
        with torch.no_grad():
            named = list(self.gcn.named_parameters())
            grads = [p.grad for _, p in named]
            norm = dist_train.global_norm(self, self.mesh, "gcn.")
            clip = norm >= 20.0
            clone = {k: adamw_first_step(p, torch.where(clip, g / norm * 20.0, g),
                                         self.clone_lr, self.clone_wd)
                     for (k, p), g in zip(named, grads)}
        for p in self.gcn.parameters():
            p.grad = None
        self._step(self.opt_meta, mlr)

        # round 2: meta users through the clone (a constant), a second meta step
        mu = self.meta_users[dr.randint("meta_idx", 0, self.meta_users.shape[0],
                                        (self.meta_batch,)).long()]
        mpos, mneg, mval = self.sampler.sample(dr, "m", mu, None)
        with torch.no_grad():
            clone_out = torch.func.functional_call(self.gcn, clone, ())
        self.zero_grad(set_to_none=True)
        total, _, _ = self._total(dr, "r2", clone_out, mu, mpos, mneg, mval)
        self._backward(0.5 * total, batch)
        self._step(self.opt_meta, mlr)

        # round 3: the model under the meta net's weights held constant
        self.zero_grad(set_to_none=True)
        meta = {k: v.detach() for k, v in self.meta_net.named_parameters()}
        total, beh_t, info_t = self._total(dr, "r3", self.gcn(), users, pos_l, neg_l, valid_l,
                                           meta=meta)
        self._backward(total, batch)
        self._step(self.opt_model, cyclic_lr(epoch, self.lr_base, self.lr_max))
        return {"loss": total.detach(), "bpr_loss": beh_t.detach(),
                "infonce_loss": info_t.detach()}

    def generate(self):
        ue, ie, _ = self.gcn()
        return ue, ie
