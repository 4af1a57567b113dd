"""AdaGCL — adaptive contrastive learning with two learned view generators
(a VGAE and an L0-gated denoising net) and a four-phase step (port of
``sslrec_tpu/models/general_cf/adagcl.py``).

Per batch, in the JAX order, each phase starting from the parameters the
previous update left: (1) CL between the VGAE view and the denoised
propagation → a recommender update; (2) information-bottleneck CL against
phase 1's detached outputs → a recommender update; (3) BPR + L2 → a
recommender update; (4) the VGAE's loss → its own Adam, then the denoise
net's BPR + λ₀·L0 → its own Adam.  The recommender's Adam is stepped three
times a batch, as optax's ``opt_rec`` is (its zero gradients on the other
partitions leave those untouched at ``weight_decay`` 0).  The model owns the
three optimizers; the trainer calls :meth:`train_step`.

Every propagation is B1 on the all-ones bi-adjacency with the values as the
edge weight: constant ones (the normalised values, the VGAE view, the gates
of the view forward) as an :class:`EdgeMask`, the denoise net's gates, which
need a gradient, as ``SpmmFn``'s learned weight.  The endpoint gathers of
the gate logits and the gate normaliser take ``TakeFn`` over segment layouts
of the rows and the cols, and the gate degree is ``SegmentSumFn``, so their
backward is B1 too.

Draws: the model sets ``step_generator``; :meth:`step_draws` takes a step's
draws from the epoch's device generator (the VGAE view's and the VGAE loss's
Gaussian noise, the hard-concrete uniforms), which a test injects.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sslrec_tpu_torch.models import losses
from sslrec_tpu_torch.models.base import RecModel, apply_linear, linear_layer
from sslrec_tpu_torch.ops.segment_kernel import SegmentSumFn, TakeFn, build_segment_layout
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask, csr_graph_from_edges
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.trainer.trainer import build_optimizer
from sslrec_tpu_torch.utils.initializers import linear_params


def _mlp(layers, x, acts):
    for p, act in zip(layers, acts):
        x = apply_linear(p, x)
        if act == "relu":
            x = F.relu(x)
        elif act == "softplus":
            x = F.softplus(x)
    return x


class AdaGCL(RecModel):
    mesh_todo = None
    step_generator = True       # train_step gets the epoch's device generator
    TABLES = ("user_embeds", "item_embeds")

    def __init__(self, cfg, data):
        super().__init__(cfg, data)
        m = cfg.model
        self.cl_weight = float(m.cl_weight)
        self.ib_weight = float(m.ib_weight)
        self.temperature = float(m.temperature)
        self.layer_num = int(m.layer_num)
        self.reg_weight = float(m.reg_weight)
        self.gamma = float(m.gamma)
        self.zeta = float(m.zeta)
        self.init_temp = float(m.init_temperature)
        self.temp_decay = float(m.temperature_decay)
        self.lambda0 = float(m.lambda0)
        device, d = data.device, self.embedding_size
        bi = data.extras["bi_adj"]
        self.n_nodes, self.nnz = bi.n_rows, bi.nnz
        self.adj = csr_graph_from_edges(bi.rows, bi.cols, bi.n_rows, bi.n_cols)
        self.norm_vals = bi.vals                    # in the same (row-sorted) edge order
        self.rows_seg = build_segment_layout(bi.rows, self.n_nodes, device)
        self.cols_seg = build_segment_layout(bi.cols, self.n_nodes, device)

        def linears(*shapes):
            return nn.ModuleList([linear_layer(i, o, device) for i, o in shapes])

        dist_train.ui_tables(self, cfg, d, device)
        self.vgae = nn.ModuleDict({"enc_mean": linears((d, d), (d, d)),
                                   "enc_std": linears((d, d), (d, d)),
                                   "dec": linears((d, d), (d, 1))})
        self.dn = nn.ModuleDict({"nb": linears((d, d), (d, d)),
                                 "self": linears((d, d), (d, d)),
                                 "attn": linears((2 * d, 1), (2 * d, 1))})
        self.opt_rec = build_optimizer(cfg, [self.user_embeds, self.item_embeds])
        self.opt_vgae = build_optimizer(cfg, self.vgae.parameters())
        self.opt_dn = build_optimizer(cfg, self.dn.parameters())

    def optimizers(self) -> dict:
        """The three Adams by name, which checkpoints save and restore."""
        return {"rec": self.opt_rec, "vgae": self.opt_vgae, "dn": self.opt_dn}

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        """Xavier tables and ``nn.Linear``-default layers, drawn from ``gen``
        (whole tables on every rank of a mesh, each keeping its own rows)."""
        dist_train.init_ui_tables(self, gen)
        for part in (self.vgae, self.dn):
            for layers in part.values():
                for lin in layers:
                    for k, v in linear_params(gen, *lin["w"].shape).items():
                        lin[k].copy_(v)

    def step_draws(self, gen: torch.Generator) -> dict:
        """One step's draws on ``gen``'s device: the VGAE view's and the VGAE
        loss's standard normals ``[N, d]`` and the hard-concrete uniforms
        ``[min(layer_num, 2), nnz]`` in (1e-7, 1 - 1e-7)."""
        dev, n, d = gen.device, self.n_nodes, self.embedding_size
        gates = min(self.layer_num, 2)
        return {"view_noise": torch.randn(n, d, generator=gen, device=dev),
                "vgae_noise": torch.randn(n, d, generator=gen, device=dev),
                "gate_u": torch.rand(gates, self.nnz, generator=gen, device=dev)
                * (1.0 - 2e-7) + 1e-7}

    # -- propagation over a value vector ---------------------------------------
    def _embeds(self):
        """``[users; items]``, whole (gathered from the row shards on a mesh)."""
        return dist_train.ui_nodes(self)

    def _forward(self, vals):
        embeds = self._embeds()
        ys, x = [], embeds
        for _ in range(self.layer_num):
            x = spmm(self.adj, x, EdgeMask(vals))
            ys.append(x)
        return embeds + torch.stack(ys).sum(0)

    # -- VGAE -------------------------------------------------------------------
    def _vgae_encode(self, noise):
        with torch.no_grad():
            x = self._forward(self.norm_vals)
        mean = _mlp(self.vgae["enc_mean"], x, ["relu", None])
        std = _mlp(self.vgae["enc_std"], x, ["relu", "softplus"])
        return noise * std + mean, mean, std

    def _vgae_decode(self, z_src, z_dst):
        h = F.relu(z_src * z_dst)
        h = F.relu(apply_linear(self.vgae["dec"][0], h))
        return apply_linear(self.vgae["dec"][1], h)[..., 0]

    @torch.no_grad()
    def _vgae_view(self, noise):
        """Edges kept where σ(score) ≥ 0.5, values rescaled by nnz / kept."""
        z, _, _ = self._vgae_encode(noise)
        pred = torch.sigmoid(self._vgae_decode(TakeFn.apply(self.rows_seg, z),
                                               TakeFn.apply(self.cols_seg, z)))
        mask = torch.floor(pred + 0.5)
        kept = torch.clamp(mask.sum(), min=1.0)
        return self.norm_vals * mask * (self.nnz / kept)

    # -- DenoiseNet ---------------------------------------------------------------
    def _dn_logit(self, x, layer):
        f1 = F.relu(apply_linear(self.dn["nb"][layer], TakeFn.apply(self.rows_seg, x)))
        f2 = F.relu(apply_linear(self.dn["self"][layer], TakeFn.apply(self.cols_seg, x)))
        return apply_linear(self.dn["attn"][layer], torch.cat([f1, f2], -1))[..., 0]

    def _stretch(self, gate):
        return torch.clamp(gate * (self.zeta - self.gamma) + self.gamma, 0.0, 1.0)

    def _dn_normalize(self, mask):
        deg = SegmentSumFn.apply(self.rows_seg, mask)
        dinv = torch.clamp((deg + 1e-6) ** -0.5, 0.0, 10.0)
        return mask * TakeFn.apply(self.rows_seg, dinv) * TakeFn.apply(self.cols_seg, dinv)

    def _dn_forward(self, gate_u, temperature):
        """The denoise net's training forward: hard-concrete gates from the
        uniforms ``gate_u`` at ``temperature``, over the detached embeddings;
        returns (the layer sum, the L0 penalty)."""
        acc, l0 = [self._embeds().detach()], 0.0
        shift = temperature * math.log(-self.gamma / self.zeta)
        for layer in range(min(self.layer_num, 2)):
            log_alpha = self._dn_logit(acc[-1], layer)
            u = gate_u[layer]
            gate = torch.sigmoid((torch.log(u) - torch.log(1 - u) + log_alpha) / temperature)
            l0 = l0 + torch.sigmoid(log_alpha - shift).mean()
            vals = self._dn_normalize(self._stretch(gate))
            acc.append(spmm(self.adj, acc[-1], vals))
        return sum(acc), l0

    def _dn_view_forward(self):
        """The denoised propagation of the recommender's embeddings, its gates
        (σ(logit), stretched) made without gradient."""
        acc = [self._embeds()]
        for layer in range(min(self.layer_num, 2)):
            with torch.no_grad():
                vals = self._dn_normalize(self._stretch(torch.sigmoid(
                    self._dn_logit(acc[-1], layer))))
            acc.append(spmm(self.adj, acc[-1], EdgeMask(vals)))
        return sum(acc)

    # -- losses ---------------------------------------------------------------------
    def _graphcl(self, x1, x2, users, items):
        u = self.user_num

        def norm(e):
            return e / torch.sqrt((e * e).sum(-1, keepdim=True) + 1e-12)

        a1 = torch.cat([norm(x1[:u])[users], norm(x1[u:])[items]], 0)
        a2 = torch.cat([norm(x2[:u])[users], norm(x2[u:])[items]], 0)
        n1 = torch.sqrt((a1 * a1).sum(-1) + 1e-12)
        n2 = torch.sqrt((a2 * a2).sum(-1) + 1e-12)
        sim = torch.exp((a1 @ a2.T) / (n1[:, None] * n2[None, :]) / self.temperature)
        pos = torch.diagonal(sim)
        return -torch.log(pos / (sim.sum(1) - pos) + 1e-12)

    def _bpr(self, x, ancs, poss, negs):
        u, i = x[: self.user_num], x[self.user_num:]
        return losses.bpr_loss(u[ancs], i[poss], i[negs]) / ancs.shape[0]

    def _vgae_loss(self, noise, ancs, poss, negs):
        z, mean, std = self._vgae_encode(noise)
        zu, zi = z[: self.user_num], z[self.user_num:]
        pos_pred = torch.sigmoid(self._vgae_decode(zu[ancs], zi[poss]))
        neg_pred = torch.sigmoid(self._vgae_decode(zu[ancs], zi[negs]))
        bce = -torch.log(pos_pred + 1e-12) - torch.log(1 - neg_pred + 1e-12)
        kl = -0.5 * (1 + 2 * torch.log(std + 1e-12) - mean ** 2 - std ** 2).sum(1)
        bpr = losses.bpr_loss(zu[ancs], zi[poss], zi[negs]) / ancs.shape[0]
        return bce.mean() + 0.1 * kl.mean() + bpr

    # -- the four-phase step ----------------------------------------------------------
    def train_step(self, batch: dict, gen: torch.Generator | None,
                   draws: dict | None = None) -> dict:
        """One batch's four phases; ``draws`` (else drawn from ``gen``) as
        :meth:`step_draws` returns them.  Returns the losses, detached."""
        draws = self.step_draws(gen) if draws is None else draws
        ancs, poss, negs = batch["user"], batch["pos"], batch["neg"]
        temperature = batch["aux"]["temperature"]
        vgae_vals = self._vgae_view(draws["view_noise"])
        mesh = self.mesh
        # the graphcl phases' rows: the whole batch's (they compare its rows)
        cl_u, cl_i = ((dist_train.gather_batch(x, batch["n_whole"], mesh) for x in (ancs, poss))
                      if mesh is not None else (ancs, poss))

        def update(opt, loss, owner):
            """One update of ``opt`` by ``loss``; ``owner``: the names of the
            parameters it owns (their gradients' mesh sums)."""
            opt.zero_grad(set_to_none=True)
            if mesh is None:
                loss.backward()
            else:
                dist_train.mesh_backward(loss, mesh, batch["share"])
                dist_train.sync_model_grads(self, mesh, owner)
            opt.step()
            return loss.detach()

        out1, out2 = self._forward(vgae_vals), self._dn_view_forward()
        cl = update(self.opt_rec, self._graphcl(out1, out2, cl_u, cl_i).mean() * self.cl_weight,
                    self.TABLES)
        out1, out2 = out1.detach(), out2.detach()
        ib = update(self.opt_rec, (self._graphcl(self._forward(vgae_vals), out1, cl_u, cl_i)
                                   + self._graphcl(self._dn_view_forward(), out2, cl_u, cl_i)
                                   ).mean() * self.ib_weight, self.TABLES)
        bpr = self._bpr(self._forward(self.norm_vals), ancs, poss, negs)
        reg = self.reg_weight * dist_train.reg_params(self, mesh, self.TABLES)
        main = update(self.opt_rec, bpr + reg, self.TABLES)
        vg = update(self.opt_vgae, self._vgae_loss(draws["vgae_noise"], ancs, poss, negs),
                    "vgae.")
        x, l0 = self._dn_forward(draws["gate_u"], temperature)
        dn = update(self.opt_dn, self._bpr(x, ancs, poss, negs) + l0 * self.lambda0, "dn.")
        return {"loss": cl + ib + main + vg + dn, "cl_loss": cl, "ib_loss": ib,
                "bpr_loss": bpr.detach(), "reg_loss": reg.detach(), "generate_loss": vg,
                "denoise_loss": dn}

    @torch.no_grad()
    def epoch_state(self, gen, epoch: int) -> dict:
        """The hard-concrete temperature ``max(0.05, init · decay^epoch)``."""
        t = max(0.05, self.init_temp * (self.temp_decay ** epoch))
        return {"temperature": torch.tensor(t, dtype=torch.float32,
                                            device=self.user_embeds.device)}

    def generate(self):
        x = self._forward(self.norm_vals)
        return x[: self.user_num], x[self.user_num:]
