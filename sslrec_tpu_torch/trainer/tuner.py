"""Grid-search tuner (port of ``sslrec_tpu/trainer/tuner.py``).

The product over the lists in ``cfg.tune`` in the order of
``tune.hyperparameters``; each trial gets its own frozen config, a fresh
model and a fresh :class:`Trainer` (so the same initial parameters and the
same epoch draws as a single run with those overrides), and the grid's
trials and best score go into ``<results_dir>/<model>_<dataset>_tune.json``.

``tune.parallel: K`` trains K trials at once as lanes of one stacked model
(:mod:`~sslrec_tpu_torch.trainer.lanes`), where the model has an
``hparams()`` hook whose scalars its ``loss`` reads from ``batch["hp"]``:
LightGCN, SGL, SimGCL, DirectAU, DCCF, HCCF, NCL, MHCN, DcRec, KCGN, SMIN,
MBGMN, HMGCR, SMBRec, CL4SRec, DuoRec and DCRec_seq (MBGMN's and HMGCR's
``reg_weight`` an inert lane, as in the JAX package).  Tuned keys outside
``hparams()`` are structural: the trials are grouped by them and each group
runs its chunks of K lanes, the tail chunk padded with its last trial.  Each
key of ``hparams()`` is the ``cfg.model`` key it reads, so a lane's scalars
come from its trial's config.  The rest falls back to the serial loop with the JAX package's conditions and log
lines (:func:`lanes_refusal`: no ``hparams()``, KGCL with ``train_trans``, an
``epoch_state`` without an ``epoch_state_fn``, a ``train.mesh``), as does a
grid whose groups are all single trials.
"""

from __future__ import annotations

import itertools
import json
import os
import time

import torch

from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.parallel.mesh import is_main_process
from sslrec_tpu_torch.trainer.lanes import Lanes
from sslrec_tpu_torch.trainer.trainer import Trainer


def trial_configs(cfg):
    """Yield ``(cfg_variant, assignment dict)`` over the tune grid."""
    hypers = list(cfg.tune.get("hyperparameters", ()))
    spaces = [list(cfg.tune[h]) for h in hypers]
    for combo in itertools.product(*spaces):
        assignment = dict(zip(hypers, combo))
        yield cfg.replace(model=assignment), assignment


def grid_search(cfg, data, logger):
    """Train every trial of the grid; returns ``(best test score, assignment)``."""
    n_parallel = int(cfg.tune.get("parallel", 0) or 0)
    if n_parallel > 1:
        best = vmapped_grid_search(cfg, data, logger, n_parallel)
        if best is not None:
            return best
        logger.log("tune.parallel unsupported for this model/config; "
                   "falling back to serial grid search")
    return _serial_grid_search(cfg, data, logger)


def _write_grid_artifact(cfg, results, best, mode):
    """Every trial's assignment and test score, beside the run artifacts
    (rank 0's alone in a group)."""
    out_dir = str(cfg.train.get("results_dir", "") or "")
    if not out_dir or not is_main_process():
        return None
    os.makedirs(out_dir, exist_ok=True)
    p = os.path.join(out_dir, f"{cfg.model.name}_{cfg.data.name}_tune.json")
    with open(p, "w") as f:
        json.dump({
            "model": cfg.model.name, "dataset": cfg.data.name, "mode": mode,
            "seed": int(cfg.train.seed),
            "metric": f"{cfg.test.metrics[0]}@{cfg.test.k[0]}",
            "grid": {h: list(cfg.tune[h]) for h in cfg.tune.get("hyperparameters", ())},
            "trials": [{"assignment": a, "score": s} for s, a in results],
            "best": {"assignment": best[1], "score": best[0]},
            "written_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        }, f, indent=1)
    return p


def _serial_grid_search(cfg, data, logger):
    best = None
    results = []
    metric0 = cfg.test.metrics[0]
    for trial_cfg, assignment in trial_configs(cfg):
        logger.log(f"tune trial: {assignment}")
        model = build_model(trial_cfg, data)
        # per-trial run artifacts would overwrite each other (one file name);
        # the grid artifact is the tune's record instead
        trainer = Trainer(trial_cfg.set_path("train.results_dir", ""), model, data, logger)
        trainer.train()
        score = float(trainer.test_results[metric0][0])
        logger.log(f"tune trial {assignment} -> {metric0}@{trial_cfg.test.k[0]} = {score:.5f}")
        results.append((score, assignment))
        if best is None or score > best[0]:
            best = (score, assignment)
        del trainer, model
    logger.log(f"tune best: {best[1]} ({metric0}@{cfg.test.k[0]}={best[0]:.5f})")
    p = _write_grid_artifact(cfg, results, best, mode="serial")
    if p:
        logger.log(f"wrote tune artifact {p}")
    return best


def lanes_refusal(probe, cfg) -> str | None:
    """Why a grid of ``probe``'s model under ``cfg`` cannot run as lanes (the
    JAX package's conditions), or None where it can."""
    if not hasattr(probe, "hparams"):
        return "no hparams() hook"
    if getattr(probe, "train_trans", False) and hasattr(probe, "kg_loss"):
        return "KGCL's TransE sub-loop"
    if hasattr(probe, "epoch_state") and not hasattr(probe, "epoch_state_fn"):
        return "an epoch_state without an epoch_state_fn"
    if cfg.train.get("mesh"):
        return "a train.mesh"
    return None


def vmapped_grid_search(cfg, data, logger, n_parallel):
    """K trials at once as lanes; returns ``(score, assignment)``, or None
    where the grid cannot run as lanes (the caller then runs it serially)."""
    trials = list(trial_configs(cfg))
    if not trials:
        return None
    tuned = set(cfg.tune.get("hyperparameters", ()))
    probe0 = build_model(trials[0][0], data)
    if lanes_refusal(probe0, cfg) is not None:
        return None
    # tuned keys outside hparams() are structural (layer counts): the trials
    # are grouped by them, and the lanes run within each group
    structural = sorted(tuned - set(probe0.hparams()))
    del probe0
    groups: dict = {}
    for t in trials:
        groups.setdefault(tuple((h, t[1][h]) for h in structural), []).append(t)
    if len(groups) >= len(trials):
        return None     # every trial its own group: the lanes buy nothing

    metric0 = cfg.test.metrics[0]
    k0 = int(cfg.test.k[0])
    logger.log(f"tune: vmapped grid search, {len(trials)} trials in "
               f"{len(groups)} structural group(s) x {n_parallel} lanes")

    results = []    # (test score, assignment)
    for gkey, gtrials in groups.items():
        # one probe and one set of evaluators a group, shared by its chunks
        lanes = Lanes(gtrials[0][0], build_model(gtrials[0][0], data), data)
        if gkey:
            logger.log(f"tune group {dict(gkey)}: {len(gtrials)} trials")
        k_eff = n_parallel
        lo = 0
        while lo < len(gtrials):
            chunk = gtrials[lo:lo + k_eff]
            real = len(chunk)
            # the tail chunk repeats its last trial, so every chunk has K
            # lanes; the padded lanes are dropped
            chunk = chunk + [chunk[-1]] * (k_eff - real)
            try:
                scores = _run_vmapped_chunk(lanes, chunk, logger)
            except torch.OutOfMemoryError as e:
                # K lanes can exceed the card's memory (DcRec's and HCCF's
                # per-lane similarity matrices): halve them and retry
                if k_eff == 1:
                    raise
                torch.cuda.empty_cache()
                k_eff = max(1, k_eff // 2)
                logger.log(f"tune chunk failed ({str(e).splitlines()[0][:120]}); "
                           f"retrying this group at {k_eff} lanes")
                continue
            for i in range(real):
                assignment = chunk[i][1]
                score = float(scores[i])
                logger.log(f"tune trial {assignment} -> {metric0}@{k0} = {score:.5f}")
                results.append((score, assignment))
            lo += real
        del lanes

    best = max(results, key=lambda t: t[0])
    logger.log(f"tune best: {best[1]} ({metric0}@{k0}={best[0]:.5f})")
    p = _write_grid_artifact(cfg, results, best, mode="vmapped")
    if p:
        logger.log(f"wrote tune artifact {p}")
    return best


def _run_vmapped_chunk(lanes: Lanes, chunk, logger):
    """Train the chunk's trials as lanes; returns their test scores.  Each
    lane's scalars are its trial config's values of the probe's
    ``hparams()`` keys."""
    hp = {k: torch.tensor([float(tc.model[k]) for tc, _ in chunk], dtype=torch.float32,
                          device=lanes.device)
          for k in lanes.probe.hparams()}
    return lanes.train(hp, logger)
