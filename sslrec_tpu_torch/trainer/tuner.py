"""Grid-search tuner (port of ``sslrec_tpu/trainer/tuner.py``, the serial loop).

The product over the lists in ``cfg.tune`` in the order of
``tune.hyperparameters``; each trial gets its own frozen config, a fresh
model and a fresh :class:`Trainer` (so the same initial parameters and the
same epoch draws as a single run with those overrides), and the grid's
trials and best score go into ``<results_dir>/<model>_<dataset>_tune.json``.

The JAX package's ``tune.parallel`` lanes (K trials in one vmapped program)
are not ported: ``tune.parallel > 1`` raises.
"""

from __future__ import annotations

import itertools
import json
import os
import time

from sslrec_tpu_torch.models.registry import build_model
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
        raise NotImplementedError(
            "tune.parallel > 1: the parallel tune lanes are not ported yet (ROADMAP "
            "Queue A, the tune.parallel lanes as a batch dimension); set tune.parallel "
            "to 0 for the serial grid")
    return _serial_grid_search(cfg, data, logger)


def _write_grid_artifact(cfg, results, best, mode):
    """Every trial's assignment and test score, beside the run artifacts."""
    out_dir = str(cfg.train.get("results_dir", "") or "")
    if not out_dir:
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
