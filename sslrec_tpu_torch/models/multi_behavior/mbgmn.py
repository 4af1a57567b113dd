"""MBGMN: a meta graph network over behaviors (port of
``sslrec_tpu/models/multi_behavior/mbgmn.py``).

- Half-width user and item tables, specialised per behavior by a
  rank-factored meta transform of ``[behavior; self; neighbours]``
  (concatenated back to full width); per behavior ``layer_num`` leaky-relu
  hops, user ← A·items and item ← AT·users, residual; a final tower over
  every behavior fused by a light self-attention across behaviors.  Every
  hop is B1 on a behavior's A or AT.
- The loss samples in itself: ``batch_size`` random users, per behavior
  ``sampNum`` positives by CSR offset and negatives rejected against that
  behavior's edges, a shared random item for users without one; a hinge over
  every (source, target) behavior pair scored by a meta-generated 2-layer
  MLP.  ``detach_pre_loss`` (default on, as the reference) keeps the hinge
  out of the gradient: it is computed without one, and only the L2 of the
  final tower (``train.reg``) trains.
- ``epoch_schedule``: ``trnNum`` users an epoch, in ``ceil(trnNum / batch)``
  equal steps.

Draws by name (:class:`StepDraws`): ``users`` [B], per behavior ``b``
``pos_u{b}`` [B, sampNum] uniforms, ``neg{b}`` [B, sampNum] negatives,
``fallback{b}`` [B, 1]; a test gives them.

On a device mesh with a ``model`` axis > 1 each rank holds a row shard of
the user and item tables (``row_shards``) and reads them whole with
autograd (``dist_train.whole_nodes``), so every tower runs on the whole
behavior graphs in every rank; the behavior embeddings, the dense layers
and ``q`` are replicated.  A ``data`` rank draws the hinge's users and items
for the whole batch (``n_whole``), as the single run does, so that every
rank takes the generator's draws alike, and keeps its slice's rows
(``dist_train.batch_slice``); the hinge is a mean over them, and the L2 of
the final tower's whole latents a whole term, alike on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.data.sampling import sample_from_rows, sample_negatives
from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.utils.initializers import linear_params, xavier_uniform

TABLES = ("u_embed", "i_embed")      # the user and item tables (half width)
# the dense layers, in the JAX package's init order
_LINEARS = ("spec_u", "spec_i", "spec_u1", "spec_i1", "spec_u2", "spec_i2",
            "pred_fc1", "pred_fc2", "pred_fc3", "pred_fc4", "pred_fc5")


class MBGMN(RecModel):
    mesh_todo = None
    step_generator = True
    batch_fields = ("user", "pos")      # the loss samples its own users and items

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m, dev = cfg.model, data.device
        self.device = dev
        self.graphs = data.extras["behavior_graphs"]
        self.n_beh = len(self.graphs)
        self.layer_num = int(m.layer_num)
        self.rank = int(m.rank)
        self.att_head = int(m.att_head)
        self.samp_num = int(m.sampNum)
        self.trn_num = int(m.get("trnNum", 100))
        self.mult = float(m.mult)
        self.detach_pre = bool(m.get("detach_pre_loss", True))
        self.reg = float(cfg.train.get("reg", 1e-2))
        self.slope = float(m.get("slope", 0.1))
        self._beh_csr, self._beh_edges = [], []
        for coo in data.extras["behavior_mats_scipy"]:
            csr = coo.tocsr()
            self._beh_csr.append((torch.from_numpy(csr.indptr.astype("int64")).to(dev),
                                  torch.from_numpy(csr.indices.astype("int64")).to(dev)))
            self._beh_edges.append(sparse_ops.build_edge_set(coo, device=dev))

        d, r = self.embedding_size, self.rank
        h = d // 2
        shapes = {"spec_u": (3 * h, h), "spec_i": (3 * h, h), "spec_u1": (h, r * h),
                  "spec_i1": (h, r * h), "spec_u2": (h, r * h), "spec_i2": (h, r * h),
                  "pred_fc1": (3 * d, d), "pred_fc2": (3 * d, 3 * d),
                  "pred_fc3": (3 * d, 3 * d * d), "pred_fc4": (3 * d, d),
                  "pred_fc5": (3 * d, d)}
        dist_train.ui_tables(self, cfg, h, dev, TABLES)
        self.beh_embeds = nn.Parameter(torch.empty(self.n_beh + 1, h, device=dev))
        for name in _LINEARS:
            setattr(self, name, linear_layer(*shapes[name], dev))
        self.q = nn.Parameter(torch.empty(d, d, device=dev))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and ``q``, ``nn.Linear``-default dense layers, in the
        JAX package's order (whole tables on every rank of a mesh, each
        keeping its own rows)."""
        dist_train.init_ui_tables(self, gen, TABLES)
        self.beh_embeds.copy_(xavier_uniform(gen, tuple(self.beh_embeds.shape)))
        for name in _LINEARS:
            lin = getattr(self, name)
            for k, v in linear_params(gen, *lin["w"].shape).items():
                lin[k].copy_(v)
        self.q.copy_(xavier_uniform(gen, tuple(self.q.shape)))

    def epoch_schedule(self, n_train: int, batch_size: int) -> tuple[int, int]:
        """``trnNum`` users an epoch: ``ceil(trnNum / batch)`` steps of
        ``ceil(trnNum / steps)`` users (one step of 100 at the shipped
        config)."""
        n_steps = -(-self.trn_num // batch_size)
        return n_steps, -(-self.trn_num // n_steps)

    def _act(self, x):
        return F.leaky_relu(x, self.slope)

    # -- towers ---------------------------------------------------------------
    def _specialize(self, beh_embed, adjs, u0, i0):
        h = self.embedding_size // 2
        u_nb = sum(spmm(a, i0) for a, _ in adjs)
        i_nb = sum(spmm(at, u0) for _, at in adjs)
        u_meta = self._act(apply_linear(self.spec_u, torch.cat(
            [beh_embed.expand(u0.shape[0], h), u0, u_nb], -1)))
        i_meta = self._act(apply_linear(self.spec_i, torch.cat(
            [beh_embed.expand(i0.shape[0], h), i0, i_nb], -1)))
        uw1 = self._act(apply_linear(self.spec_u1, u_meta)).reshape(-1, h, self.rank)
        uw2 = self._act(apply_linear(self.spec_u2, u_meta)).reshape(-1, self.rank, h)
        iw1 = self._act(apply_linear(self.spec_i1, i_meta)).reshape(-1, h, self.rank)
        iw2 = self._act(apply_linear(self.spec_i2, i_meta)).reshape(-1, self.rank, h)
        ru = torch.einsum("nr,nrh->nh", torch.einsum("nh,nhr->nr", u0, uw1), uw2)
        ri = torch.einsum("nr,nrh->nh", torch.einsum("nh,nhr->nr", i0, iw1), iw2)
        return torch.cat([ru, u0], -1), torch.cat([ri, i0], -1)

    def _light_attention(self, reps):
        d, nh, n = self.embedding_size, self.att_head, len(reps)
        stacked = torch.stack(reps, 1)                       # [N, n, d]
        tem = stacked @ self.q
        q = tem.reshape(-1, n, 1, nh, d // nh)
        k = tem.reshape(-1, 1, n, nh, d // nh)
        v = stacked.reshape(-1, 1, n, nh, d // nh)
        att = torch.softmax((q * k).sum(-1, keepdim=True) / math.sqrt(d / nh), dim=2)
        attval = (att * v).sum(2).reshape(-1, n, d)
        return [attval[:, i] + reps[i] for i in range(n)]

    def forward(self):
        tables = dist_train.ui_nodes(self, TABLES)
        u0, i0 = tables[: self.user_num], tables[self.user_num:]
        ulat, ilat = [], []
        for b, (a, at) in enumerate(self.graphs):
            bu, bi = self._specialize(self.beh_embeds[b], [(a, at)], u0, i0)
            us, is_ = [bu], [bi]
            for _ in range(self.layer_num):
                u = self._act(spmm(a, is_[-1]))
                i = self._act(spmm(at, us[-1]))
                us.append(u + us[-1])
                is_.append(i + is_[-1])
            ulat.append(sum(us))
            ilat.append(sum(is_))
        bu, bi = self._specialize(self.beh_embeds[-1], self.graphs, u0, i0)
        us, is_ = [bu], [bi]
        for _ in range(self.layer_num):
            ub = [self._act(spmm(a, is_[-1])) for a, _ in self.graphs]
            ib = [self._act(spmm(at, us[-1])) for _, at in self.graphs]
            us.append(sum(self._light_attention(ub)))
            is_.append(sum(self._light_attention(ib)))
        ulat.append(sum(us))
        ilat.append(sum(is_))
        return ulat, ilat

    # -- the per-pair meta prediction --------------------------------------------
    def _meta_predict(self, su, si, tu, ti):
        d = self.embedding_size
        src_ui = self._act(apply_linear(self.pred_fc1, torch.cat([su * si, su, si], -1)))
        tgt_ui = self._act(apply_linear(self.pred_fc1, torch.cat([tu * ti, tu, ti], -1)))
        metalat = self._act(apply_linear(self.pred_fc2, torch.cat(
            [src_ui * tgt_ui, src_ui, tgt_ui], -1)))
        w1 = self._act(apply_linear(self.pred_fc3, metalat)).reshape(-1, 3 * d, d)
        b1 = self._act(apply_linear(self.pred_fc4, metalat)).reshape(-1, 1, d)
        w2 = self._act(apply_linear(self.pred_fc5, metalat)).reshape(-1, d, 1)
        pe = torch.cat([su * si, su, si], -1)[:, None, :]
        return (self._act(pe @ w1 + b1) @ w2).reshape(-1)

    def sample(self, dr: StepDraws, b: int, rows: slice = slice(None)):
        """Per behavior the (user, item) ids of the hinge: ``sampNum``
        positives then as many negatives for each of ``b`` random users,
        drawn for all ``b`` and kept for the users ``rows`` (a ``data``
        rank's slice of the batch)."""
        users = dr.randint("users", 0, self.user_num, (b,)).long()
        uids, iids = [], []
        for beh, ((indptr, indices), edges) in enumerate(zip(self._beh_csr, self._beh_edges)):
            pos, deg = sample_from_rows(indptr, indices, users,
                                        dr.uniform(f"pos_u{beh}", (b, self.samp_num)))
            rep = users.repeat_interleave(self.samp_num)
            negs = dr.draw(f"neg{beh}", lambda: sample_negatives(
                dr.gen, rep, edges, self.item_num).view(b, self.samp_num)).long()
            fallback = dr.randint(f"fallback{beh}", 0, self.item_num, (b, 1)).long()
            has = (deg > 0)[:, None]
            pos, negs = torch.where(has, pos, fallback), torch.where(has, negs, fallback)
            uids.append(users[rows].repeat_interleave(self.samp_num).repeat(2))
            iids.append(torch.cat([pos[rows].reshape(-1), negs[rows].reshape(-1)]))
        return uids, iids

    def hparams(self) -> dict:
        """The lane scalar of ``tune.parallel``: ``model.reg_weight``, which
        nothing reads (a documented no-op, as in the JAX package: the loss
        regularises with ``train.reg``, as the reference MBGMN does).  As an
        inert lane it folds the shipped 9-trial grid into 3 structural groups
        (layer_num) without changing any trial."""
        return {"reg_weight": float(self.cfg.model.get("reg_weight", 0.0))}

    def loss(self, batch: dict, gen, draws: dict | None = None):
        dr = StepDraws(gen, draws, self.device)
        if self.mesh is None:
            uids, iids = self.sample(dr, batch["user"].shape[0])
        else:       # the whole batch's draws, this rank's rows
            n = batch["n_whole"]
            uids, iids = self.sample(dr, n, dist_train.batch_slice(n, self.mesh))
        ulat, ilat = self.forward()
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.detach_pre):
            pre_loss = 0.0
            for src in range(self.n_beh + 1):
                for tgt in range(self.n_beh):
                    uu, ii = uids[tgt], iids[tgt]
                    preds = self._meta_predict(ulat[src][uu], ilat[src][ii],
                                               ulat[tgt][uu], ilat[tgt][ii]) * self.mult
                    half = uu.shape[0] // 2
                    hinge = 1.0 - (preds[:half] - preds[half:])
                    # torch.maximum: a tie takes half the gradient, as jnp.maximum
                    pre_loss = pre_loss + torch.maximum(hinge, torch.zeros_like(hinge)).mean()
        reg = self.reg * losses.reg_pick_embeds([ulat[-1], ilat[-1]])
        return pre_loss + reg, {"pre_loss": pre_loss, "reg_loss": reg}

    def generate(self):
        ulat, ilat = self.forward()
        return ulat[-1], ilat[-1]
