"""The ``tune.parallel`` lanes: K trials of one structural group of a tune
grid trained as one stacked model (port of the vmapped half of
``sslrec_tpu/trainer/tuner.py``, whose ``jax.vmap`` becomes
``torch.func.vmap``).

Every parameter is stacked K times along a leading lane dimension.  A step
runs the model's ``loss`` once under ``torch.func.vmap`` over (parameters,
``batch["hp"]``, the per-lane epoch state), with ``functional_call``
swapping the lane's tensors into the probe model, then one backward of the
lanes' summed losses and one Adam step over the stacked leaves.  Adam and
``build_optimizer``'s weight decay are elementwise, so each lane's update is
its own trial's; a model's ``grad_clip`` clips each lane's global norm.

An epoch is the serial trainer's ``Trainer.train_epoch`` with this step in
place of its own, so the draws and diagnostics are a single run's: the
epoch's batches, negatives and PRF keys are made once and shared, and random ops
inside ``loss`` draw once for all lanes (``randomness="same"``) from the
epoch's device generator, so every lane consumes the key sequence of a
single run with its trial's overrides, as JAX's lanes do.  B1's Functions
fold the lanes into the feature dimension (``ops/spmm_kernel.py``,
``vmap_lanes``): a hop of K lanes of width d is one launch at width K·d.

A model with ``epoch_state_fn`` (NCL's k-means) gets its per-epoch state one
lane at a time, outside the vmap, each lane from the same generator state;
the state reaches ``loss`` as a batched ``batch["aux"]``.

Each lane keeps the serial trainer's bookkeeping (``BestOnValid`` over K
runs): its best valid score, its patience and the snapshot of its best
parameters; a lane that stopped trains
on as dead weight (its snapshot and score frozen) until every lane has
stopped.  Evaluations load a lane's parameters into the probe and run the
serial :class:`~sslrec_tpu_torch.trainer.metrics.Evaluator`, so a lane's
numbers are computed exactly as a single run's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap

from sslrec_tpu_torch.trainer.metrics import Evaluator
from sslrec_tpu_torch.trainer.trainer import (INIT_STREAM, BestOnValid, Trainer,
                                              build_optimizer, generator)


class _LossCall(nn.Module):
    """``model.loss`` as a module's ``forward``, so that ``functional_call``
    can swap one lane's parameters into ``model`` for the call."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, key, hp: dict, aux):
        batch = {**batch, "hp": hp}
        if aux is not None:
            batch["aux"] = aux
        return self.model.loss(batch, key)[0]


def clip_lanes_global_norm(params, max_norm: float) -> None:
    """:func:`~sslrec_tpu_torch.trainer.trainer.clip_grad_global_norm` for
    each lane on its own: the global norm over every leaf's lane slice."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).flatten(1).sum(1) for g in grads))     # [K]
    clip = norm >= max_norm
    for g in grads:
        shape = (-1,) + (1,) * (g.dim() - 1)
        g.copy_(torch.where(clip.view(shape), g / norm.view(shape) * max_norm, g))


class Lanes:
    """One structural group's machinery, built once and reused by each of its
    chunks: the probe model (whose parameters the lanes' stacks replace in
    every call), the :class:`Trainer` whose epoch loop the lanes run, and the
    evaluators."""

    def __init__(self, cfg, probe, data):
        self.cfg, self.probe, self.data = cfg, probe, data
        self.trainer = Trainer(cfg, probe, data)
        self.call = _LossCall(probe)
        self.device = data.device
        self.seed = int(cfg.train.seed)
        self.grad_clip = float(getattr(probe, "grad_clip", 0.0) or 0.0)
        self.period = int(getattr(probe, "epoch_state_period", 1) or 1)
        self.has_aux = hasattr(probe, "epoch_state_fn")
        self._aux = None        # the lanes' last epoch state
        self.valid = Evaluator(data.valid if data.valid is not None else data.test, cfg)
        self.test = Evaluator(data.test, cfg)
        self.metric0 = cfg.test.metrics[0]

    # -- parameters ----------------------------------------------------------
    def init_lanes(self, k: int) -> dict[str, torch.Tensor]:
        """The probe's initial parameters (drawn as ``Trainer.train`` draws
        them) repeated ``k`` times along a leading lane dimension, as leaves
        that take gradients, keyed by their names in :class:`_LossCall`."""
        self.probe.init_params(generator(self.seed, INIT_STREAM))
        self._aux = None
        return {"model." + n: p.detach().unsqueeze(0).repeat(k, *(1,) * p.dim())
                .requires_grad_() for n, p in self.probe.named_parameters()}

    @torch.no_grad()
    def load_lane(self, params: dict, i: int) -> None:
        """Copy lane ``i``'s parameters into the probe."""
        for n, p in self.probe.named_parameters():
            p.copy_(params["model." + n][i])

    def lane_scores(self, params: dict, evaluator: Evaluator, lanes) -> np.ndarray:
        """``metrics[0]@k[0]`` of each lane in ``lanes`` (else NaN)."""
        k = next(iter(params.values())).shape[0]
        out = np.full((k,), np.nan)
        for i in lanes:
            self.load_lane(params, i)
            out[i] = float(evaluator(self.probe)[self.metric0][0])
        return out

    def epoch_state(self, params: dict, gen: torch.Generator) -> dict:
        """Each lane's ``epoch_state_fn`` from its own parameters, every lane
        from ``gen``'s state on entry (left, as a single run leaves it, after
        one lane's draws), stacked along a leading lane dimension."""
        k = next(iter(params.values())).shape[0]
        state = gen.get_state()
        per_lane = []
        for i in range(k):
            gen.set_state(state)
            self.load_lane(params, i)
            per_lane.append(self.probe.epoch_state_fn(gen))
        return {key: torch.stack([s[key] for s in per_lane]) for key in per_lane[0]}

    # -- training --------------------------------------------------------------
    def step(self, params: dict, optimizer, batch: dict, key, hp: dict, aux) -> torch.Tensor:
        """One Adam step of every lane; returns the lanes' losses ``[K]``."""
        optimizer.zero_grad(set_to_none=True)

        def lane(p, h, a):
            return functional_call(self.call, p, (batch, key, h, a))

        loss = vmap(lane, in_dims=(0, 0, None if aux is None else 0),
                    randomness="same")(params, hp, aux)
        self.trainer._check_finite(loss, batch)
        loss.sum().backward()
        if self.grad_clip:
            clip_lanes_global_norm(params.values(), self.grad_clip)
        optimizer.step()
        return loss.detach()

    def lanes_epoch_state(self, params: dict, gen: torch.Generator, epoch: int) -> dict:
        """The lanes' epoch state: :meth:`epoch_state`, new at a chunk's first
        epoch and every ``epoch_state_period`` epochs, else the last one."""
        if self._aux is None or epoch % self.period == 0:
            self._aux = self.epoch_state(params, gen)
        return self._aux

    def train_epoch(self, params: dict, optimizer, epoch: int, hp: dict) -> dict:
        """Epoch ``epoch`` of every lane through the serial trainer's
        :meth:`~sslrec_tpu_torch.trainer.trainer.Trainer.train_epoch` (its
        draws, generators and diagnostics) with the lanes' step; returns the
        lanes' mean losses (``{"loss": [K floats]}``)."""
        def step(batch, key):
            aux = batch.pop("aux", None)
            return {"loss": self.step(params, optimizer, batch, key, hp, aux)}

        state = None
        if self.has_aux:
            def state(gen, e):
                return self.lanes_epoch_state(params, gen, e)
        return self.trainer.train_epoch(epoch, step=step, epoch_state=state)

    def train(self, hp: dict, logger) -> np.ndarray:
        """Train every lane of ``hp`` (``{name: [K] float32}``) to the end of
        the serial trainer's schedule, each lane with its own
        :class:`~sslrec_tpu_torch.trainer.trainer.BestOnValid` bookkeeping;
        returns each lane's test score from its best-on-valid parameters,
        which stay in ``self.best_params``."""
        k = next(iter(hp.values())).shape[0]
        params = self.init_lanes(k)
        optimizer = build_optimizer(self.cfg, list(params.values()))
        track = BestOnValid(self.cfg, k)
        best_params = {n: p.detach().clone() for n, p in params.items()}

        def keep_best(count=True):
            active = track.active()
            improved = track.update(self.lane_scores(params, self.valid, active), active,
                                    count=count)
            with torch.no_grad():
                for n, p in params.items():
                    for i in np.flatnonzero(improved):
                        best_params[n][i].copy_(p[i])

        n_epochs = int(self.cfg.train.epoch)
        for epoch in range(n_epochs):
            self.train_epoch(params, optimizer, epoch, hp)
            if not track.due(epoch):
                continue
            keep_best()
            newly = track.stop()
            if newly.any():
                logger.log(f"tune epoch {epoch}: lanes {np.nonzero(newly)[0].tolist()} "
                           f"hit patience (active {len(track.active())}/{k})")
            if track.stopped.all():
                break
        else:
            if track.final_due(0, n_epochs):
                keep_best(count=False)
        self.best_params = best_params
        return self.lane_scores(best_params, self.test, range(k))
