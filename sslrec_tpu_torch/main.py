"""CLI entry: train, tune or test from a checkpoint (port of ``sslrec_tpu/main.py``).

Usage::

    python -m sslrec_tpu_torch.main --model lightgcn [--dataset yelp] \
        [--data_dir datasets] [--device cuda|cpu] [--set k=v ...]

With ``tune.enable`` set the run is the config's grid search
(:func:`~sslrec_tpu_torch.trainer.tuner.grid_search`), which writes the grid
artifact and no run artifact; with ``train.pretrain_path`` it loads that
checkpoint and evaluates it on the test split, training nothing; else it
trains and evaluates.  The run computes on the card (``--device cuda``, the
default) unless the CPU is asked for; it never falls back from one to the
other.

Before the data loads, ``train.mesh`` and ``train.distributed`` are checked
(:mod:`~sslrec_tpu_torch.parallel.mesh`): a mesh that cannot be laid out on
the devices raises ``ValueError``, and a model whose mesh branch is not
ported ``NotImplementedError``.  A mesh of more than one device then runs
one rank a device: with no process group running, the CLI starts the ranks
itself (:func:`~sslrec_tpu_torch.parallel.launch.spawn`; NCCL on the card,
gloo processes on ``--device cpu``) and returns a
:class:`~sslrec_tpu_torch.parallel.launch.MeshRun`; under
``train.distributed`` or ``SSLREC_DISTRIBUTED=1`` (``torchrun``) it joins the
group those describe (:func:`~sslrec_tpu_torch.parallel.mesh.maybe_distributed_init`).
In a group, only rank 0 logs and writes files.  The diagnostics of the JAX
package's CLI are set up too:

- ``train.debug_nans``: autograd's anomaly mode, and a check of every
  step's loss that raises ``FloatingPointError`` where it is not finite
  (the type ``jax_debug_nans`` raises);
- ``train.profile: <dir>``: a ``torch.profiler`` trace of the whole run, the
  data load included, exported to ``<dir>`` as a Chrome trace when the run
  ends, whether it ends well or not;
- the dispatch trace (:mod:`~sslrec_tpu_torch.utils.dispatch_trace`):
  ``SSLREC_TRACE_FILE``, ``runs_torch/dispatch_trace_<pid>.log`` unless it
  is set already; the CLI leaves the variable as it found it.
"""

from __future__ import annotations

import os
import sys

import torch

from sslrec_tpu_torch.config import parse_cli
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.registry import build_model, model_class
from sslrec_tpu_torch.parallel import launch
from sslrec_tpu_torch.parallel.mesh import check_model, config_shape, maybe_distributed_init
from sslrec_tpu_torch.trainer.logger import rank_logger
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.trainer.tuner import grid_search
from sslrec_tpu_torch.utils import dispatch_trace


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; raises when ``cuda`` is asked for and absent."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        local = os.environ.get("LOCAL_RANK")
        if local is not None:
            torch.cuda.set_device(int(local))       # a torchrun rank's card
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")


def start_profile(profile_dir: str, device: torch.device):
    """A running ``torch.profiler`` trace of the host and, on the card, the
    device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, profile_dir: str, name: str) -> str:
    """Stop ``prof`` and export its Chrome trace into ``profile_dir``."""
    prof.stop()
    path = os.path.join(profile_dir, f"{name}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    """Run the CLI; returns the :class:`Trainer` (a tune returns ``(best test
    score, assignment)``, and a mesh whose ranks it started a
    :class:`~sslrec_tpu_torch.parallel.launch.MeshRun`)."""
    cfg = parse_cli(argv)
    device = resolve_device(cfg.train.device)
    maybe_distributed_init(cfg, device)
    shape = config_shape(cfg, device)
    check_model(model_class(cfg.model.name), shape)
    if shape is not None and not torch.distributed.is_initialized():
        # one process a device: start the ranks, each running this CLI
        world = shape[0] * shape[1]
        argv = list(sys.argv[1:] if argv is None else argv)
        return launch.MeshRun(launch.spawn(launch.cli_rank, (argv,), world, device.type))
    # full float32 in the rating matmul: TF32 would add ~1e-3 to the scores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if "results_dir" not in cfg.train:
        # CLI runs write a results artifact; the JAX package's results/ stays
        # its own
        cfg = cfg.set_path("train.results_dir", "results_torch")
    set_trace = "SSLREC_TRACE_FILE" not in os.environ
    if set_trace:
        os.environ["SSLREC_TRACE_FILE"] = f"runs_torch/dispatch_trace_{os.getpid()}.log"
    debug_nans = bool(cfg.train.get("debug_nans", False))
    profile_dir = str(cfg.train.get("profile", "") or "")
    logger = rank_logger(cfg)
    prof = None
    try:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        logger.log(f"device: {device} ({name})")
        if debug_nans:
            torch.autograd.set_detect_anomaly(True)
            logger.log("autograd anomaly mode and the loss check enabled (train.debug_nans)")
        if profile_dir:
            prof = start_profile(profile_dir, device)
            logger.log(f"capturing profiler trace to {profile_dir}")
        data = load_data(cfg, device)
        logger.log(f"data loaded: {data.user_num} users x {data.item_num} items, "
                   f"{data.n_train} train interactions")
        if cfg.tune.get("enable", False):
            return grid_search(cfg, data, logger)
        model = build_model(cfg, data)
        trainer = Trainer(cfg, model, data, logger)
        pretrain = cfg.train.get("pretrain_path")
        if pretrain:
            trainer.load_params(pretrain)
            trainer.test_results = trainer.test()
            logger.log_eval(trainer.test_results, cfg.test.k, name="(test from checkpoint)")
            return trainer
        trainer.train()
        return trainer
    finally:
        if prof is not None:
            path = stop_profile(prof, profile_dir, f"{cfg.model.name}_{cfg.data.name}")
            logger.log(f"profiler trace written to {path}")
        if debug_nans:
            torch.autograd.set_detect_anomaly(False)
        if set_trace:
            del os.environ["SSLREC_TRACE_FILE"]
            dispatch_trace.reset()
        logger.close()


if __name__ == "__main__":
    main(sys.argv[1:])
