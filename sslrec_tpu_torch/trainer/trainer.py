"""Training loop with early stopping (port of ``sslrec_tpu/trainer/trainer.py``).

Each epoch: shuffle, wrap-pad the permutation to full batches, draw one
negative per interaction, then one Adam step per batch.  Evaluate every
``test_step`` epochs on valid (else test), stop early after ``patience``
evaluations without a gain in ``metrics[0]@k[0]``, keep the best parameters,
and finish with the best-valid and test evaluations.

The JAX package compiles a whole epoch into one ``lax.scan``; here the steps
are an eager Python loop.  Randomness comes from explicit generators: epoch
``e`` draws its permutation, negatives and per-step dropout keys from a CPU
generator seeded by ``(seed, e)`` (the counterpart of
``fold_in(root, epoch)``), so an epoch's draws do not depend on the device or
on the epochs before it.

A model with ``step_generator`` set draws its own per-step masks, and a
model with an ``epoch_state`` hook its per-epoch state: the trainer seeds one
generator on the run's device from ``(seed, epoch)`` and hands it, with the
epoch, to ``epoch_state(gen, epoch)``, whose result reaches every step's
``loss`` as ``batch["aux"]``; a ``step_generator`` model then gets it in
``loss`` in place of the PRF key.  Such draws are made on the device, never
copied from the host.

Every batch carries its step's index in the epoch as ``batch["step"]``; a
model whose ``batch_fields`` lack ``"neg"`` gets no negatives drawn; and a
model with its own ``train_step`` (AdaGCL) owns its optimizers, so the
trainer builds none and calls that method for each batch.

The other hooks, as in the JAX trainer: a handler's
``extras["train_arrays"]`` (DSL's paired CF and social stream) replaces the
``(user, pos)`` arrays that batches index; a model's ``extra_negatives(gen,
arrays)`` adds full-epoch streams drawn from the epoch's generator after the
negatives and sliced per batch like them; a model's ``grad_clip`` clips the
gradients' global norm before weight decay and Adam, as
``optax.chain(clip_by_global_norm, …)`` does.

A model's ``epoch_schedule(n_train, batch_size)`` sets the epoch's number of
steps and batch size in place of one pass over the interactions (MBGMN's
``trnNum`` users an epoch).  A model with ``train_trans`` set and a
``kg_loss`` (KGCL) runs the TransE sub-loop after each epoch's steps
(:meth:`Trainer.kg_trans_epoch`), with an Adam of its own kept across epochs.

Checkpoints (``utils/checkpoint.py``): ``train.save_model`` writes the best
parameters after the final test; ``train.save_state_every`` writes the train
state (parameters, optimizer state, epoch, best snapshot, ``best_metric``,
``wait``, and a model's ``extra_state()`` where it has one: MAERec's loss
history) after the evaluation of every that-many epochs; and
``train.resume_path`` restores such a state (``load_extra_state`` for the
model's part) and goes on from the next epoch.  Since each epoch's draws
depend only on ``(seed, epoch)``, a resumed run repeats the uninterrupted one
bit for bit on the same device.

On a device mesh (``train.mesh``, :mod:`~sslrec_tpu_torch.parallel.mesh`)
each rank draws the epoch's batches as every other rank does, takes its
``data`` slice of each, and backpropagates its loss scaled by
:func:`~sslrec_tpu_torch.parallel.dist_train.mesh_backward`; the ``data``
group then sums the gradients (weighted by each slice's share of the batch,
their mean for equal slices) before the clip (its norm
``dist_train.global_norm``, over the ranks' row shards), weight decay and
Adam; the gradients of a model's replicated parameters (those outside its
``row_shards``) are first summed over the ``model`` group.  The TransE
sub-loop splits its batches over ``data`` the same way.  A model with its
own ``train_step`` gets its slice the same way and does its own sums; the
trainer reduces the terms it returns over ``data``.  A
model sharded over ``model`` holds its own rows and their Adam moments; the
best snapshot, the returned parameters and every checkpoint are whole
tables, so that a checkpoint moves between a mesh run and a single-device
run.  Only rank 0 logs and writes the results artifact and checkpoints.

Diagnostics: the dispatch trace (``utils/dispatch_trace.py``) brackets an
epoch's steps, the loss sync, each evaluation and each state save, as the
JAX trainer does; ``train.trace_sync`` synchronizes the card after every
step; ``train.debug_nans`` raises ``FloatingPointError`` at the first step
whose loss is not finite (the CLI also turns on autograd's anomaly mode).
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from sslrec_tpu_torch.data.base import DataBundle
from sslrec_tpu_torch.data.sampling import sample_negatives
from sslrec_tpu_torch.ops.sparse import build_edge_set
from sslrec_tpu_torch.parallel import dist_train
from sslrec_tpu_torch.parallel.mesh import check_model, is_main_process, mesh_from_config
from sslrec_tpu_torch.trainer.logger import Logger, log_exceptions, rank_logger
from sslrec_tpu_torch.trainer.metrics import Evaluator
from sslrec_tpu_torch.utils import checkpoint as ckpt
from sslrec_tpu_torch.utils import dispatch_trace as trace
from sslrec_tpu_torch.utils.results import RunRecorder
from sslrec_tpu_torch.utils.summary import DisabledScalarWriter, make_writer


def build_optimizer(cfg, params) -> torch.optim.Optimizer:
    """Adam; ``weight_decay > 0`` adds L2 to the gradient before Adam, as
    optax's ``add_decayed_weights`` before ``adam`` does (not AdamW)."""
    name = cfg.optimizer.get("name", "adam").lower()
    if name != "adam":
        raise NotImplementedError(f"optimizer {name}")
    lr = float(cfg.optimizer.lr)
    wd = float(cfg.optimizer.get("weight_decay", 0.0) or 0.0)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)


def clip_grad_global_norm(params, max_norm: float, norm: torch.Tensor | None = None) -> None:
    """``optax.clip_by_global_norm``: where the gradients' global L2 norm is at
    least ``max_norm``, scale each by ``max_norm / norm`` (divided, then
    multiplied, as optax does), in place.  ``norm``: the norm where the
    caller has it (on a mesh, :func:`~sslrec_tpu_torch.parallel.dist_train.
    global_norm`'s, over the ranks' row shards), else that of ``params``."""
    grads = [p.grad for p in params if p.grad is not None]
    if norm is None:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


INIT_STREAM = 2**32    # generator path of the parameter draw, apart from epochs
DEVICE_STREAM = 1      # generator path of a model's own per-epoch device draws
KG_STREAM = 2          # generator path of the TransE sub-loop's batches


def generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, *path)`` through numpy's
    SeedSequence, so distinct paths give independent streams."""
    state = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & (2**63 - 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Default pairwise trainer for a :class:`~sslrec_tpu_torch.models.base.RecModel`."""

    def __init__(self, cfg, model, data: DataBundle, logger: Logger | None = None):
        self.cfg = cfg
        self.model = model
        self.data = data
        self.logger = logger    # made by train() when None
        self.device = data.device
        self.mesh = mesh_from_config(cfg, self.device)
        if self.mesh is not None:
            check_model(type(model), (self.mesh.n_data, self.mesh.n_model))
        self.optimizer = (None if hasattr(model, "train_step")
                          else build_optimizer(cfg, model.parameters()))
        self.grad_clip = float(getattr(model, "grad_clip", 0.0) or 0.0)
        # the per-interaction arrays that batches index (a handler may pair
        # other streams with them, as DSL's social pairs)
        self.arrays = dict(data.extras.get("train_arrays")
                           or {"user": data.train_users, "pos": data.train_items})
        self.batch_size = int(cfg.train.batch_size)
        if hasattr(model, "epoch_schedule"):
            self.n_batches, self.batch_size = model.epoch_schedule(data.n_train,
                                                                    self.batch_size)
        else:
            self.n_batches = -(-data.n_train // self.batch_size)
        self.trace_sync = bool(cfg.train.get("trace_sync", False))
        self.debug_nans = bool(cfg.train.get("debug_nans", False))
        self.kg_trans = bool(getattr(model, "train_trans", False)) and hasattr(model, "kg_loss")
        self.kg_optimizer = None
        if self.kg_trans:
            self._kg = self._kg_structures()
        # models with per-fix_steps view banks size them from the batch count
        model._n_batches_hint = self.n_batches

    # ------------------------------------------------------------------
    def train_step(self, batch: dict, key) -> dict:
        """One Adam step on ``batch`` (user/pos/neg index tensors) with the
        dropout PRF ``key``, or the epoch's device generator for a model with
        ``step_generator``; returns the loss terms as detached tensors.  A
        model with its own ``train_step`` takes the step instead."""
        if self.optimizer is None:
            aux = self.model.train_step(batch, key)
            self._check_finite(aux["loss"], batch)
            if self.mesh is not None:
                aux = dist_train.reduce_terms(aux, self.mesh, batch["share"])
            return aux
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.model.loss(batch, key)
        self._check_finite(loss, batch)
        terms = {**{k: v.detach() for k, v in aux.items()}, "loss": loss.detach()}
        if self.mesh is None:
            loss.backward()
        else:
            share = batch["share"]
            dist_train.mesh_backward(loss, self.mesh, share)
            dist_train.sync_model_grads(self.model, self.mesh)
            terms = dist_train.reduce_terms(terms, self.mesh, share)
        if self.grad_clip:
            clip_grad_global_norm(self.model.parameters(), self.grad_clip,
                                  dist_train.global_norm(self.model, self.mesh))
        self.optimizer.step()
        return terms

    def _check_finite(self, loss: torch.Tensor, batch: dict) -> None:
        """Under ``train.debug_nans``, ``FloatingPointError`` where ``loss`` (a
        scalar, or the tuner's lanes' ``[K]``) is not finite (before its
        backward, whose NaNs autograd's anomaly mode reports)."""
        if self.debug_nans and not bool(torch.isfinite(loss).all()):
            raise FloatingPointError(f"train.debug_nans: step {batch.get('step')}: "
                                     f"loss {loss.tolist()}")

    def epoch_draws(self, epoch: int):
        """Epoch ``epoch``'s batches ``[n_batches, B]`` (indices into the train
        interactions), the full-epoch sampled streams (``"neg"``, one negative
        per interaction, from ``[extras["neg_low"], item_num)`` (``neg_low`` 0
        unless the handler sets it: 1 for the sequential models' 1-based
        ids), unless the model's ``batch_fields`` lack it, and the
        model's ``extra_negatives``), and per-step PRF keys ``[n_batches, 2]``
        (uint32 values in int64), all on the data's device."""
        data, bsz, n_batches = self.data, self.batch_size, self.n_batches
        gen = generator(int(self.cfg.train.seed), epoch)
        perm = torch.randperm(data.n_train, generator=gen)
        rows = n_batches * bsz      # fewer than n_train under a model's epoch_schedule
        pad = max(rows - data.n_train, 0)
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        idx = perm[:rows].view(n_batches, bsz).to(self.device)
        sampled = {}
        if "neg" in self.model.batch_fields:
            sampled["neg"] = sample_negatives(gen, self.arrays["user"], data.train_edge_set,
                                              data.item_num,
                                              low=int(data.extras.get("neg_low", 0)))
        if hasattr(self.model, "extra_negatives"):
            sampled.update(self.model.extra_negatives(gen, self.arrays))
        keys = torch.randint(0, 2**32, (n_batches, 2), generator=gen,
                             dtype=torch.int64).to(self.device)
        return idx, sampled, keys

    def make_batch(self, bidx: torch.Tensor, sampled: dict, step: int) -> dict:
        """Step ``step``'s batch from its indices ``bidx`` into the epoch's
        arrays and ``sampled`` streams; on a mesh, this rank's ``data`` slice
        of it, with its ``"share"`` of the whole batch and the whole batch's
        size ``"n_whole"``."""
        mesh_keys = {}
        if self.mesh is not None:
            n = bidx.shape[0]
            bidx = bidx[dist_train.batch_slice(n, self.mesh)]
            mesh_keys = {"share": bidx.shape[0] / self.batch_size, "n_whole": n}
        batch = {k: v[bidx] for k, v in (*self.arrays.items(), *sampled.items())}
        batch["step"] = step
        return {**batch, **mesh_keys}

    def train_epoch(self, epoch: int, step=None, epoch_state=None) -> dict:
        """Epoch ``epoch``'s steps on :meth:`epoch_draws`; returns each loss
        term's mean over the steps.  ``step(batch, key) -> {name: loss}``
        takes each batch (:meth:`train_step` by default) and ``epoch_state(gen,
        epoch)`` makes the state that reaches it as ``batch["aux"]`` (the
        model's hook by default): the tuner's lanes pass their vmapped step,
        whose losses are ``[K]`` (their means then lists), and their lanes'
        states."""
        idx, sampled, keys = self.epoch_draws(epoch)
        model = self.model
        step = step or self.train_step
        if epoch_state is None and hasattr(model, "epoch_state"):
            epoch_state = model.epoch_state
        gen = aux_state = None
        if model.step_generator or epoch_state is not None:
            gen = generator(int(self.cfg.train.seed), epoch, DEVICE_STREAM,
                            device=self.device)
        if model.step_generator:
            keys = [gen] * self.n_batches
        if epoch_state is not None:
            aux_state = epoch_state(gen, epoch)
        sums = None
        tag = f"ep{epoch}.whole_epoch"
        trace.mark(tag, steps=self.n_batches, model=self.cfg.model.name)
        for i, (bidx, key) in enumerate(zip(idx, keys)):
            batch = self.make_batch(bidx, sampled, i)
            if aux_state is not None:
                batch["aux"] = aux_state
            aux = step(batch, key)
            if self.trace_sync:
                _sync(self.device)
            sums = aux if sums is None else {k: sums[k] + v for k, v in aux.items()}
        trace.done(tag)
        trace.mark(f"ep{epoch}.losses_sync")
        losses = {k: _mean(v, self.n_batches) for k, v in sums.items()}
        trace.done(f"ep{epoch}.losses_sync")
        if self.kg_trans:
            losses["kg_loss"] = self.kg_trans_epoch(*self.kg_trans_draws(epoch))
        return losses

    # -- the TransE sub-loop (KGCL's train_trans) -------------------------
    def _kg_structures(self) -> dict:
        """The full triplets on the device, the (head, tail) edge set over the
        entities, the batch size and the number of steps an epoch."""
        trip = self.data.extras["kg_triplets_full"]
        n_ent = int(self.data.extras["entity_num"])
        ht = sp.coo_matrix((np.ones(len(trip), np.float32), (trip[:, 0], trip[:, 2])),
                           shape=(n_ent, n_ent))
        bsz = int(self.cfg.train.get("kg_batch_size", 4096))
        return {"trip": torch.from_numpy(trip.astype(np.int64)).to(self.device),
                "edges": build_edge_set(ht, device=self.device), "n_ent": n_ent,
                "bsz": bsz, "steps": max(len(trip) // bsz, 1)}

    def kg_trans_draws(self, epoch: int):
        """Epoch ``epoch``'s TransE batches: triplet indices drawn with
        replacement ``[steps, kg_batch_size]`` and one negative tail per
        triplet, rejected against the (head, tail) edge set, from a CPU
        generator seeded by ``(seed, epoch, KG_STREAM)``."""
        kg = self._kg
        gen = generator(int(self.cfg.train.seed), epoch, KG_STREAM)
        idx = torch.randint(0, kg["trip"].shape[0], (kg["steps"], kg["bsz"]),
                            generator=gen).to(self.device)
        negs = sample_negatives(gen, kg["trip"][idx.reshape(-1), 0], kg["edges"], kg["n_ent"])
        return idx, negs.view(kg["steps"], kg["bsz"])

    def kg_trans_epoch(self, idx: torch.Tensor, negs: torch.Tensor) -> float:
        """One TransE pass (``kg_loss`` on each batch, then the sub-loop's
        Adam, built from the ``optimizer`` config on first use and kept
        across epochs); returns the mean loss.  Every parameter steps, as
        optax updates the whole tree: one that ``kg_loss`` does not reach
        takes a zero gradient.

        On a mesh the batch splits over ``data`` as the main step's does
        (``kg_loss`` is a mean over the batch's triplets, so a slice's mean
        weighted by its share sums to the whole batch's), and the gradients
        go through the main step's ``mesh_backward`` and gradient sums."""
        kg, mesh = self._kg, self.mesh
        params = list(self.model.parameters())
        if self.kg_optimizer is None:
            self.kg_optimizer = build_optimizer(self.cfg, params)
        total = 0.0
        for bidx, neg in zip(idx, negs):
            share = 1.0
            if mesh is not None:
                sl = dist_train.batch_slice(bidx.shape[0], mesh)
                share = (sl.stop - sl.start) / bidx.shape[0]
                bidx, neg = bidx[sl], neg[sl]
            h, r, t = kg["trip"][bidx].unbind(1)
            self.kg_optimizer.zero_grad(set_to_none=True)
            loss = self.model.kg_loss(h, r, t, neg)
            if mesh is None:
                loss.backward()
            else:
                dist_train.mesh_backward(loss, mesh, share)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if mesh is not None:
                dist_train.sync_model_grads(self.model, mesh)
                loss = dist_train.reduce_terms({"loss": loss.detach()}, mesh, share)["loss"]
            self.kg_optimizer.step()
            total = total + loss.detach()
        return float(total) / idx.shape[0]

    # ------------------------------------------------------------------
    def optimizers(self) -> dict:
        """The run's optimizers by name: the trainer's Adam, or those of a
        model with its own ``train_step`` (its ``optimizers()``)."""
        if self.optimizer is None:
            return self.model.optimizers()
        return {"adam": self.optimizer}

    def _extra(self) -> dict:
        """The model's own train state (``extra_state()``), if it has one."""
        if hasattr(self.model, "extra_state"):
            return {"extra": self.model.extra_state()}
        return {}

    def _state_template(self) -> dict:
        params = self._whole(self.model.state_dict(), template=True)
        return {"params": params,
                "opt_state": self._whole_optim(ckpt.optim_template(self.optimizers()),
                                               template=True),
                "epoch": 0, "best_params": params, "best_metric": 0.0, "wait": 0,
                **self._extra()}

    def _restore(self, path: str):
        """Load the train state at ``path``; returns (best snapshot on the
        run's device, best_metric, wait, the next epoch)."""
        state = ckpt.load(path, self._state_template())
        self.load_whole(state["params"])
        ckpt.load_optim_state(self.optimizers(), self._whole_optim(state["opt_state"],
                                                                   local=True))
        if "extra" in state:
            self.model.load_extra_state(state["extra"])
        best = {k: v.to(self.device) for k, v in state["best_params"].items()}
        return best, float(state["best_metric"]), int(state["wait"]), int(state["epoch"]) + 1

    # -- whole tables on a mesh ------------------------------------------
    def _shards(self) -> dict:
        return getattr(self.model, "row_shards", {}) if self.mesh is not None else {}

    def snapshot(self) -> dict[str, torch.Tensor]:
        """A copy of the parameters as whole tables (gathered on a mesh: every
        rank of the ``model`` group takes part)."""
        return dist_train.whole_state(self.model, self.mesh)

    def load_params(self, path: str) -> None:
        """Load a parameter checkpoint (whole tables, as ``train.save_model``
        writes it, on one device or a mesh) into the model."""
        self.load_whole(ckpt.load(path, self._whole(self.model.state_dict(), template=True)))

    def load_whole(self, state: dict) -> None:
        """Load whole-table parameters (this rank's rows of them on a mesh)."""
        self.model.load_state_dict(dist_train.local_state(self.model, state, self.mesh))

    def _whole(self, tensors: dict, template: bool = False) -> dict:
        """``{name: tensor}`` of the model's parameters with the row-sharded
        ones whole (zeros of the whole shape for a ``template``)."""
        shards = self._shards()
        out = {}
        for k, v in tensors.items():
            if k in shards:
                v = (torch.zeros((shards[k], *v.shape[1:]), dtype=v.dtype) if template
                     else dist_train.whole_rows(v, shards[k], self.mesh))
            out[k] = v
        return out

    def _whole_optim(self, state: dict, template: bool = False, local: bool = False) -> dict:
        """The optimizers' per-parameter state with the moments of row-sharded
        parameters whole (``local``: the inverse, this rank's rows).  An
        optimizer's state is keyed by the parameter's index in that
        optimizer's own groups (AdaGCL's three Adams each own a part)."""
        shards = self._shards()
        if not shards:
            return state
        by_id = {id(p): n for n, p in self.model.named_parameters()}
        opts = self.optimizers()
        own = dict(self.model.named_parameters())
        out = {}
        for opt, per in state.items():
            names = [by_id[id(p)] for g in opts[opt].param_groups for p in g["params"]]
            out[opt] = type(per)()
            for i, st in per.items():
                name = names[i]
                if name not in shards:
                    out[opt][i] = st
                    continue
                moved = {}
                for k, v in st.items():
                    if k == "step":
                        moved[k] = v
                    elif local:
                        moved[k] = dist_train.own_rows(v, own[name].shape[0], self.mesh)
                    else:
                        moved[k] = self._whole({name: v}, template)[name]
                out[opt][i] = moved
        return out

    @log_exceptions
    def train(self) -> dict[str, torch.Tensor]:
        """Initialise (or resume), train, evaluate; returns the best parameters
        (a state dict), also left loaded in the model."""
        cfg, model = self.cfg, self.model
        main = is_main_process()
        if self.logger is None:
            self.logger = rank_logger(cfg)
        if self.mesh is not None:
            self.logger.log(f"mesh: {self.mesh.shape}")
        model.init_params(generator(int(cfg.train.seed), INIT_STREAM))
        track = BestOnValid(cfg)
        best_state = self.snapshot()
        start_epoch = 0
        resume = cfg.train.get("resume_path")
        if resume:
            best_state, track.best[0], track.wait[0], start_epoch = self._restore(resume)
            self.logger.log(f"resumed from {resume} at epoch {start_epoch}")

        eval_split = self.data.valid if self.data.valid is not None else self.data.test
        evaluator = Evaluator(eval_split, cfg, mesh=self.mesh)
        test_evaluator = Evaluator(self.data.test, cfg, mesh=self.mesh)

        metric0 = cfg.test.metrics[0]
        n_epochs = int(cfg.train.epoch)
        save_every = int(cfg.train.get("save_state_every", 0) or 0)

        writer = make_writer(cfg) if main else DisabledScalarWriter()
        recorder = RunRecorder(cfg, out_dir=None if main else "")
        recorder.note(device=_device_name(self.device))
        if self.mesh is not None:
            recorder.note(mesh=self.mesh.shape)
        self.recorder = recorder
        self.state_path = self.ckpt_path = None

        for epoch in range(start_epoch, n_epochs):
            _sync(self.device)
            t0 = time.perf_counter()
            losses = self.train_epoch(epoch)        # reading the losses syncs
            timing = {"train_s": time.perf_counter() - t0,
                      "train_examples": self.n_batches * self.batch_size}
            if cfg.train.get("log_loss", True):
                self.logger.log_loss(epoch, losses)
            writer.add_scalar("Loss/train", losses["loss"], epoch)
            epoch_valid = None
            if track.due(epoch):
                t0 = time.perf_counter()
                trace.mark(f"ep{epoch}.eval")
                results = evaluator(model)          # reading the metrics syncs
                trace.done(f"ep{epoch}.eval")
                timing.update(eval_s=time.perf_counter() - t0,
                              eval_users=eval_split.n_test_users)
                epoch_valid = results
                writer.add_scalar("HR/test", float(results[metric0][0]), epoch)
                self.logger.log_eval(results, cfg.test.k, epoch=epoch,
                                     name=f"(valid, {timing['eval_s']:.1f}s)")
                if track.update([float(results[metric0][0])])[0]:
                    best_state = self.snapshot()
                if track.stop()[0]:
                    self.logger.log(f"Early stop at epoch {epoch} "
                                    f"(best {metric0}@{cfg.test.k[0]}={track.best[0]:.5f})")
                    recorder.record_epoch(epoch, losses, epoch_valid, **timing)
                    break
            recorder.record_epoch(epoch, losses, epoch_valid, **timing)
            # after the evaluation and the best snapshot's update, so that a
            # resumed run carries the bookkeeping the uninterrupted run had here
            if save_every and (epoch + 1) % save_every == 0:
                state = {"params": self.snapshot(),
                         "opt_state": self._whole_optim(ckpt.optim_state(self.optimizers())),
                         "epoch": epoch, "best_params": best_state,
                         "best_metric": float(track.best[0]), "wait": int(track.wait[0]),
                         **self._extra()}
                if main:
                    self.state_path = ckpt.checkpoint_path(cfg.model.name, cfg.data.name,
                                                           ".state")
                    trace.mark(f"ep{epoch}.save_state", path=self.state_path)
                    ckpt.save(self.state_path, state)
                    trace.done(f"ep{epoch}.save_state")
                    self.logger.log(f"saved train state to {self.state_path}")
        else:
            # fixed-epoch run without early stop: when the final epoch is off
            # the test_step grid it was never scored; score it so the run does
            # not report a stale earlier snapshot as "best"
            if track.final_due(start_epoch, n_epochs):
                if track.update([float(evaluator(model)[metric0][0])], count=False)[0]:
                    best_state = self.snapshot()

        writer.close()
        self.load_whole(best_state)
        final_valid = evaluator(model)
        self.logger.log_eval(final_valid, cfg.test.k, name="(best valid)")
        test_results = test_evaluator(model)
        self.logger.log_eval(test_results, cfg.test.k, name="(test)")
        rpath = recorder.finalize(best_valid=final_valid, test=test_results)
        if rpath:
            self.logger.log(f"wrote results artifact {rpath}")
        if cfg.train.get("save_model", False) and main:
            self.ckpt_path = ckpt.checkpoint_path(cfg.model.name, cfg.data.name)
            ckpt.save(self.ckpt_path, best_state)
            self.logger.log(f"saved checkpoint to {self.ckpt_path}")
        self.best_state = best_state
        self.test_results = test_results
        return best_state

    def test(self) -> dict:
        """The test split's metrics of the model's current parameters."""
        return Evaluator(self.data.test, self.cfg, mesh=self.mesh)(self.model)


class BestOnValid:
    """The best-on-valid bookkeeping of ``k`` runs at once (a single run is
    ``k = 1``; the tuner's lanes are one a lane): every ``test_step`` epochs
    each running run's valid score either beats its best, or adds one to its
    ``wait``; under ``early_stop`` a run whose ``wait`` reaches ``patience``
    stops.  A fixed-epoch run whose last epoch is off the ``test_step`` grid
    scores that epoch too (without counting it), so that it does not report
    a stale earlier snapshot as its best."""

    def __init__(self, cfg, k: int = 1):
        self.test_step = int(cfg.train.get("test_step", 1))
        self.patience = int(cfg.train.get("patience", 0) or 0)
        self.early_stop = bool(cfg.train.get("early_stop", False))
        self.best = np.full((k,), -1.0)
        self.wait = np.zeros((k,), np.int64)
        self.stopped = np.zeros((k,), bool)

    def due(self, epoch: int) -> bool:
        """Whether epoch ``epoch`` is evaluated."""
        return epoch % self.test_step == 0

    def final_due(self, start_epoch: int, n_epochs: int) -> bool:
        """Whether a run of epochs ``[start_epoch, n_epochs)`` that did not
        stop early scores its last epoch after the loop."""
        return n_epochs > start_epoch and (n_epochs - 1) % self.test_step != 0

    def active(self) -> np.ndarray:
        """The runs that have not stopped."""
        return np.flatnonzero(~self.stopped)

    def update(self, scores, runs=None, count: bool = True) -> np.ndarray:
        """Take ``scores[i]`` for each run ``i`` of ``runs`` (default: every
        run); returns the mask ``[k]`` of the runs whose best it beat, whose
        ``wait`` goes back to 0 (the others' up by one, where ``count``)."""
        scores = np.asarray(scores, np.float64)
        runs = np.arange(len(self.best)) if runs is None else np.asarray(runs, np.int64)
        improved = np.zeros(self.best.shape, bool)
        improved[runs] = scores[runs] > self.best[runs]
        self.best[improved] = scores[improved]
        if count:
            self.wait[runs] = np.where(improved[runs], 0, self.wait[runs] + 1)
        return improved

    def stop(self) -> np.ndarray:
        """Stop the running runs that hit ``patience`` under ``early_stop``;
        returns the mask ``[k]`` of the runs that stopped now."""
        newly = ~self.stopped & (self.wait >= self.patience) & self.early_stop
        self.stopped |= newly
        return newly


def _mean(v, n: int):
    """A loss term's sum over ``n`` steps as its mean: a float, or a list of
    floats for the lanes' ``[K]``."""
    if torch.is_tensor(v) and v.dim() > 0:
        return (v.double() / n).tolist()
    return float(v) / n


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)
