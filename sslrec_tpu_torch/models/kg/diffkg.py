"""DiffKG: Gaussian diffusion over the KG's adjacency rows; the denoised KG
feeds an RGAT + LightGCN recommender with a cross-view InfoNCE (port of
``sslrec_tpu/models/kg/diffkg.py``).

- The recommender: a residual RGAT over (head, relation, tail) edges, each
  hop a segment softmax per head of ``leaky_relu(⟨[h; t] W, rel⟩)`` and the
  attention-weighted sum of tails, L2-normalised rows, ``res_lambda`` decay;
  then ``layer_num`` hops of the UI bi-adjacency with the all-ones view's
  values, summed.  The RGAT runs on :class:`KgEdges`: segment layouts over
  the heads, tails and relations, so B2 shifts the softmax and B1 carries
  its sums and the gathers' backward (the JAX package's plain segment ops
  there compute the same function).
- Per epoch (:meth:`epoch_state`, the denoiser's own Adam): one pass of the
  SNR-weighted MSE plus the user-KG consistency term over the permuted
  entities' dense KG rows, then the rebuild: every entity's row denoised by
  reverse sampling, its top ``rebuild_k`` tails (ties to the lower id, as
  ``lax.top_k``) and the reversed copy, each edge valid where its
  ``(h, t)`` is in the KG and a Bernoulli ``keepRate`` keeps it; the
  denoised KG's layouts are built on the device (``segment_layout_from_ids``).
- Loss: BPR over the main view, L2 over every parameter, InfoNCE between the
  main and the KG view (``cl_pattern`` 1: the capped KG is the main view and
  the denoised one the KG view; 0: the other way, and evaluation on the
  last denoised KG).

The denoiser and its Adam are model state outside the parameters, as the
JAX package keeps them outside its train state (a resumed run rebuilds them).
Draws by name (:class:`StepDraws`): per step ``mess_main`` / ``mess_kg``
[hops, n_entities, d] message-dropout keeps; per epoch ``perm``, per
diffusion step ``s`` ``ts{s}``, ``noise{s}``, ``drop{s}``, and the rebuild's
``keep``; a test gives them.

Under ``train.mesh`` with a ``model`` axis of M > 1 each rank holds row
shards of ``u_embeds`` (the partition's ``U_loc`` rows) and ``e_embeds``.
The RGAT reads the whole entity table with autograd and runs on every rank
over the whole KG; the fixed-weight UI propagation runs graph-partitioned
(``combine="sum"``, the RGAT's item rows through ``share_cotangent``) and
gives the rank's rows; the batch's rows come
through ``owned_lookup`` and InfoNCE's denominators read the KG view's
whole tables, gathered back with autograd.  L2 sums the row shards' part
over ``model``; ``r_embeds`` and ``rgat_w`` are replicated.  The denoiser
reads the whole detached tables and draws from the epoch's generator, so
every rank trains the same denoiser and rebuilds the same denoised KG as
the single run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.ops import sparse as sparse_ops
from sslrec_tpu_torch.ops.segment_kernel import (SegmentLayout, SegmentSoftmaxFn, SegmentSumFn,
                                                 TakeFn, build_segment_layout,
                                                 segment_layout_from_ids)
from sslrec_tpu_torch.ops.spmm import spmm, spmm_t
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, build_csr_graph
from sslrec_tpu_torch.ops.topk import topk_indices
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import mesh_from_config
from sslrec_tpu_torch.trainer.trainer import generator
from sslrec_tpu_torch.utils.initializers import xavier_uniform


def _l2rows(x):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)


class KgEdges(NamedTuple):
    """A KG edge list as segment layouts over its heads, tails and relations
    (ids in the edges' order), and a float validity mask (None: all valid)."""

    h: SegmentLayout
    t: SegmentLayout
    r: SegmentLayout
    valid: torch.Tensor | None


class DiffKG(RecModel):
    mesh_todo = None
    step_generator = True

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m, ex, dev = cfg.model, data.extras, data.device
        self.device = dev
        self.n_relations = ex["relation_num"]
        self.n_entities = ex["entity_num"]
        self.context_hops = int(m.layer_num_kg)
        self.layer_num = int(m.layer_num)
        self.mess_dropout_rate = float(m.mess_dropout_rate)
        self.reg_weight = float(m.reg_weight)
        self.temperature = float(m.temperature)
        self.cl_weight = float(m.cl_weight)
        self.res_lambda = float(m.res_lambda)
        self.cl_pattern = int(m.cl_pattern)
        self.rebuild_k = int(m.rebuild_k)
        self.keep_rate = float(m.keepRate)
        self.steps = int(m.steps)
        self.noise_scale = float(m.noise_scale)
        self.sampling_steps = int(m.sampling_steps)
        self.e_loss = float(m.e_loss)
        self.d_emb_size = int(m.d_emb_size)
        self.dims = list(m.get("dims_list", (1000,)))
        self.diff_lr = float(cfg.optimizer.lr)
        n = self.n_entities

        # the capped KG (triplet_num a head) of the base RGAT
        self.kg = KgEdges(*(build_segment_layout(ex[k], size, dev) for k, size in (
            ("kg_heads", n), ("kg_tails", n), ("kg_rels", self.n_relations))), None)
        self.bi = ex["bi_adj_maskable"]
        self.adj_vals = self.bi.view_vals(torch.ones(self.bi.nnz_rect, device=dev))
        self.mesh = mesh_from_config(cfg, dev)
        self.sg = None
        if dist_train.model_sharded(self.mesh):
            self.row_shards = {"u_embeds": self.user_num, "e_embeds": n}
            g = self.bi.graph
            _, self.sg = dist_train.maybe_partition_bi(cfg, g.rows, g.cols, self.user_num,
                                                       self.item_num, device=dev)
            self.adj_vals_part = dist_train.view_vals_partitioned(self.sg, self.adj_vals)

        # the (h, t) → relation map, h-major then t, as codes h·n + t
        trip = ex["kg_triplets_full"]
        st = trip[np.lexsort((trip[:, 2], trip[:, 0]))]
        self._map_codes = torch.from_numpy(st[:, 0].astype(np.int64) * n + st[:, 2]).to(dev)
        self._map_r = torch.from_numpy(st[:, 1].astype(np.int64)).to(dev)
        # each entity's tail set (uncapped), padded, for the dense rows
        kg_mat = sp.coo_matrix((np.ones(len(trip), np.float32), (trip[:, 0], trip[:, 2])),
                               shape=(n, n)).tocsr()
        self.kg_rows = sparse_ops.build_padded_rows(kg_mat, device=dev)
        # the rectangular UI matrix of the ukgc term
        self.ui = build_csr_graph(sparse_ops.from_scipy(ex["train_mat_scipy"]), dev)

        # diffusion tables in float64, stored as float32; the SNR from
        # ac / (1 - ac) in float64 (1 - ac cancels in float32 near t = 0)
        var = np.linspace(self.noise_scale * float(m.noise_min),
                          self.noise_scale * float(m.noise_max), self.steps, dtype=np.float64)
        alpha_bar = 1 - var
        betas = [1 - alpha_bar[0]]
        for i in range(1, self.steps):
            betas.append(min(1 - alpha_bar[i] / alpha_bar[i - 1], 0.999))
        betas = np.asarray(betas)
        betas[0] = 1e-4
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

        self._sqrt_ac, self._sqrt_1mac, self._snr = f32(np.sqrt(ac)), f32(np.sqrt(1 - ac)), \
            f32(ac / (1 - ac))
        self._pm_c1 = f32(betas * np.sqrt(ac_prev) / (1.0 - ac))
        self._pm_c2 = f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))

        d = self.embedding_size

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=dev))

        self.u_embeds = param(dist_train.shard_rows(self.user_num, self.mesh), d)
        self.e_embeds = param(dist_train.shard_rows(n, self.mesh), d)
        self.r_embeds = param(self.n_relations, d)
        self.rgat_w = param(2 * d, d)
        self._dn = self._dn_opt = self._last_dkg = None

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and RGAT weight (× √2, ``calculate_gain('relu')``)."""
        d = self.embedding_size
        for p, n in ((self.u_embeds, self.user_num), (self.e_embeds, self.n_entities)):
            p.copy_(dist_train.own_rows(xavier_uniform(gen, (n, d)), p.shape[0], self.mesh))
        self.r_embeds.copy_(xavier_uniform(gen, tuple(self.r_embeds.shape)))
        self.rgat_w.copy_(xavier_uniform(gen, tuple(self.rgat_w.shape)) * math.sqrt(2.0))
        self._dn = self._dn_opt = self._last_dkg = None

    # -- the recommender ---------------------------------------------------------
    def kg_edges(self, h, t, r, valid=None) -> KgEdges:
        """:class:`KgEdges` of int edge arrays, the layouts built on their device."""
        return KgEdges(segment_layout_from_ids(h, self.n_entities),
                       segment_layout_from_ids(t, self.n_entities),
                       segment_layout_from_ids(r, self.n_relations), valid)

    def entities(self) -> torch.Tensor:
        """The whole entity table with autograd (gathered from the row shards
        on a model-sharded mesh)."""
        return dist_train.whole_table(self.e_embeds, self.n_entities, self.mesh)

    def _rgat(self, kg: KgEdges, mess_keep=None, ent=None):
        ent = res = self.entities() if ent is None else ent
        rel = TakeFn.apply(kg.r, self.r_embeds)          # the same every hop
        for hop in range(self.context_hops):
            out_t = TakeFn.apply(kg.t, ent)
            a_in = torch.cat([TakeFn.apply(kg.h, ent), out_t], -1)
            logits = F.leaky_relu(((a_in @ self.rgat_w) * rel).sum(-1), 0.2)
            if kg.valid is not None:
                logits = torch.where(kg.valid > 0, logits, -1e9)
            e = SegmentSoftmaxFn.apply(kg.h, logits)
            if kg.valid is not None:
                e = e * kg.valid
            agg = SegmentSumFn.apply(kg.h, out_t * e[:, None]) + ent
            if mess_keep is not None:
                agg = torch.where(mess_keep[hop], agg / (1 - self.mess_dropout_rate), 0.0)
            ent = _l2rows(agg)
            res = self.res_lambda * res + ent
        return res

    def forward(self, kg: KgEdges | None = None, mess_keep=None, ent=None):
        """The users' and items' tables (this rank's rows of them on a
        model-sharded mesh); ``ent`` the whole entity table where the caller
        has it (:meth:`entities`)."""
        hids = self._rgat(self.kg if kg is None else kg, mess_keep, ent)
        if self.sg is not None:
            sg, mesh = self.sg, self.mesh
            items = dist_train.share_cotangent(hids[: self.item_num], mesh)
            return dist_train.mesh_partitioned_propagate(
                mesh, sg, self.u_embeds, dist_train.own_rows(items, sg.i_loc, mesh),
                self.adj_vals_part, self.layer_num, "sum")
        embeds = torch.cat([self.u_embeds, hids[: self.item_num]])
        acc = embeds
        for _ in range(self.layer_num):
            embeds = spmm(self.bi.graph, embeds, EdgeMask(self.adj_vals))
            acc = acc + embeds
        return acc[: self.user_num], acc[self.user_num:]

    # -- the denoiser --------------------------------------------------------------
    def init_denoiser(self) -> None:
        """The MLP (time embedding concatenated to the first layer's input;
        ``dims_list`` + [n_entities] out, reversed in) drawn N(0, 2/(in+out))
        with N(0, 1e-6) biases from a generator seeded by ``train.seed + 77``,
        and its Adam at ``optimizer.lr``."""
        gen = generator(int(self.cfg.train.seed) + 77, device=self.device)
        out_dims = list(self.dims) + [self.n_entities]
        in_dims = list(reversed(out_dims))
        in_dims[0] += self.d_emb_size
        pairs = ([(f"in.{j}", i, o) for j, (i, o) in enumerate(zip(in_dims[:-1], in_dims[1:]))]
                 + [(f"out.{j}", i, o) for j, (i, o) in enumerate(zip(out_dims[:-1],
                                                                       out_dims[1:]))]
                 + [("emb", self.d_emb_size, self.d_emb_size)])
        dn = {}
        for name, i, o in pairs:
            dn[f"{name}.w"] = torch.randn(i, o, generator=gen, device=gen.device) \
                * math.sqrt(2.0 / (i + o))
            dn[f"{name}.b"] = torch.randn(o, generator=gen, device=gen.device) * 0.001
        self.load_denoiser(dn)

    def load_denoiser(self, state: dict) -> None:
        """Set the denoiser's tensors (names ``in.j.w``, ``out.j.b``, ``emb.w``
        …) and give it a fresh Adam."""
        self._dn = {k: v.detach().to(self.device).clone().requires_grad_()
                    for k, v in state.items()}
        self._dn_opt = torch.optim.Adam(list(self._dn.values()), lr=self.diff_lr,
                                        betas=(0.9, 0.999), eps=1e-8)

    def _n_layers(self, part: str) -> int:
        return sum(1 for k in self._dn if k.startswith(part + ".") and k.endswith(".w"))

    def denoise(self, x, t, keep=None):
        dn, half = self._dn, self.d_emb_size // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                          device=x.device) / half)
        temp = t[:, None].float() * freqs[None]
        time_emb = torch.cat([torch.cos(temp), torch.sin(temp)], -1)
        if self.d_emb_size % 2:
            time_emb = torch.cat([time_emb, torch.zeros_like(time_emb[:, :1])], -1)
        emb = time_emb @ dn["emb.w"] + dn["emb.b"]
        x = _l2rows(x)
        if keep is not None:
            x = torch.where(keep, x / 0.5, 0.0)
        h = torch.cat([x, emb], -1)
        for j in range(self._n_layers("in")):
            h = torch.tanh(h @ dn[f"in.{j}.w"] + dn[f"in.{j}.b"])
        n_out = self._n_layers("out")
        for j in range(n_out):
            h = h @ dn[f"out.{j}.w"] + dn[f"out.{j}.b"]
            if j != n_out - 1:
                h = torch.tanh(h)
        return h

    def _q_sample(self, x0, t, noise):
        return self._sqrt_ac[t][:, None] * x0 + self._sqrt_1mac[t][:, None] * noise

    @torch.no_grad()
    def p_sample(self, x0):
        """Reverse sampling from ``x0`` (``sampling_steps`` noising steps first)."""
        b = x0.shape[0]
        x_t = x0 if self.sampling_steps == 0 else self._q_sample(
            x0, torch.full((b,), self.sampling_steps - 1, device=x0.device),
            torch.zeros_like(x0))
        for i in reversed(range(self.steps)):
            out = self.denoise(x_t, torch.full((b,), i, device=x0.device))
            x_t = self._pm_c1[i] * out + self._pm_c2[i] * x_t
        return x_t

    def dense_rows(self, idx):
        """Rows ``idx`` of the KG's 0/1 adjacency, dense ``[b, n_entities]``."""
        cols, mask = self.kg_rows.cols[idx].long(), self.kg_rows.mask[idx].float()
        rows = mask.new_zeros(idx.shape[0], self.n_entities)
        return rows.scatter_reduce_(1, cols, mask, "amax")

    def lookup_rel(self, h, t):
        """``(relation, found)`` of each ``(h, t)``: the relation at the first
        position of the sorted map holding the pair (a lower-bound search)."""
        q = h.long() * self.n_entities + t.long()
        pos = torch.searchsorted(self._map_codes, q)
        at = pos.clamp(max=self._map_codes.shape[0] - 1)
        return self._map_r[at], (pos < self._map_codes.shape[0]) & (self._map_codes[at] == q)

    def _batches(self, dr):
        n = self.n_entities
        bsz = min(1024, n)
        n_batches = -(-n // bsz)
        perm = dr.permutation("perm", n)
        return torch.cat([perm, perm[: n_batches * bsz - n]]).view(n_batches, bsz)

    def diffusion_epoch(self, dr: StepDraws) -> torch.Tensor:
        """One pass of the denoiser over the permuted entities' rows, an Adam
        step a batch; returns the mean loss.  The recommender is a constant:
        ``iu_emb = Rᵀ u`` is one transposed B1 hop of the UI matrix."""
        with torch.no_grad():
            u_emb = dist_train.whole_table(self.u_embeds.detach(), self.user_num, self.mesh)
            iu_emb = spmm_t(self.ui, u_emb)
            e_emb, losses_ = self.entities().detach(), []
        for s, bidx in enumerate(self._batches(dr)):
            x0 = self.dense_rows(bidx)
            b, n = x0.shape
            ts = dr.randint(f"ts{s}", 0, self.steps, (b,))
            noise = dr.normal(f"noise{s}", (b, n))
            x_t = self._q_sample(x0, ts, noise) if self.noise_scale != 0 else x0
            keep = dr.keep(f"drop{s}", 0.5, (b, n))
            with torch.enable_grad():
                out = self.denoise(x_t, ts, keep)
                mse = ((x0 - out) ** 2).mean(1)
                w = torch.where(ts == 0, 1.0, self._snr[(ts - 1).clamp(min=0)] - self._snr[ts])
                ukgc = ((out[:, : self.item_num] @ iu_emb - e_emb[bidx]) ** 2).mean()
                loss = (w * mse).mean() * (1 - self.e_loss) + ukgc * self.e_loss
                self._dn_opt.zero_grad(set_to_none=True)
                loss.backward()
            self._dn_opt.step()
            losses_.append(loss.detach())
        return torch.stack(losses_).mean()

    @torch.no_grad()
    def rebuild(self, dr: StepDraws) -> KgEdges:
        """The denoised KG: each entity's top ``rebuild_k`` denoised tails and
        the reversed edges, valid where the pair is in the KG and kept."""
        n, k = self.n_entities, self.rebuild_k
        bsz = min(1024, n)
        all_idx = torch.arange(-(-n // bsz) * bsz, device=self.device) % n
        tops = [topk_indices(self.p_sample(self.dense_rows(c)), k) for c in all_idx.view(-1, bsz)]
        tails = torch.cat(tops)[:n].reshape(-1)
        heads = torch.arange(n, device=self.device).repeat_interleave(k)
        h2, t2 = torch.cat([heads, tails]), torch.cat([tails, heads])
        r2, found = self.lookup_rel(h2, t2)
        valid = (found & dr.keep("keep", self.keep_rate, h2.shape)).float()
        return self.kg_edges(h2, t2, torch.where(found, r2, 0), valid)

    def epoch_state(self, gen, epoch: int = 0, draws: dict | None = None) -> dict:
        """Train the denoiser one pass, then rebuild the denoised KG, which
        reaches :meth:`loss` as ``batch["aux"]["dkg"]``."""
        if self._dn is None:
            self.init_denoiser()
        dr = StepDraws(gen, draws, self.device)
        self.diff_loss = float(self.diffusion_epoch(dr))
        self._last_dkg = self.rebuild(dr)
        return {"dkg": self._last_dkg}

    # -- loss --------------------------------------------------------------------------
    def step_draws(self, gen) -> dict:
        if self.mess_dropout_rate <= 0:
            return {}
        shape = (self.context_hops, self.n_entities, self.embedding_size)
        return {k: torch.rand(shape, generator=gen, device=gen.device)
                < 1 - self.mess_dropout_rate for k in ("mess_main", "mess_kg")}

    def loss(self, batch: dict, gen, draws: dict | None = None):
        draws = self.step_draws(gen) if draws is None else draws
        dkg = batch["aux"]["dkg"]
        main_kg, view_kg = (dkg, None) if self.cl_pattern == 0 else (None, dkg)
        ent = self.entities()
        u_main, i_main = self.forward(main_kg, draws.get("mess_main"), ent)
        u_kg, i_kg = self.forward(view_kg, draws.get("mess_kg"), ent)
        ancs, poss, negs = batch["user"].long(), batch["pos"].long(), batch["neg"].long()
        b = ancs.shape[0]
        if self.sg is None:
            anc, pos, neg = u_main[ancs], i_main[poss], i_main[negs]
        else:
            sg, mesh = self.sg, self.mesh
            anc = dist_train.owned_lookup(u_main, ancs, sg.u_loc, mesh)
            pos = dist_train.owned_lookup(i_main, poss, sg.i_loc, mesh)
            neg = dist_train.owned_lookup(i_main, negs, sg.i_loc, mesh)
            u_kg = dist_train.gather_whole(u_kg, self.user_num, mesh)
            i_kg = dist_train.gather_whole(i_kg, self.item_num, mesh)
        bpr = losses.bpr_loss(anc, pos, neg) / b
        reg = self.reg_weight * self._l2()
        cl = (losses.infonce_loss(anc, u_kg[ancs], u_kg, self.temperature)
              + losses.infonce_loss(pos, i_kg[poss], i_kg, self.temperature)
              ) / b * self.cl_weight
        return bpr + reg + cl, {"bpr_loss": bpr, "reg_loss": reg, "cl_loss": cl}

    def _l2(self) -> torch.Tensor:
        """L2² of every parameter; on a model-sharded mesh the row shards'
        part summed over the ``model`` group."""
        params = dict(self.named_parameters())
        if self.sg is None:
            return losses.reg_params(params)
        shards = losses.reg_params({k: params.pop(k) for k in self.row_shards})
        return dist_train.all_reduce_sum(shards, self.mesh.model_group) \
            + losses.reg_params(params)

    def generate(self):
        users, items = self.forward(self._last_dkg if self.cl_pattern == 0 else None)
        if self.sg is None:
            return users, items
        return (dist_train.whole_rows(users, self.user_num, self.mesh),
                dist_train.whole_rows(items, self.item_num, self.mesh))
