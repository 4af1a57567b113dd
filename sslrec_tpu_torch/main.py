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
"""

from __future__ import annotations

import sys

import torch

from sslrec_tpu_torch.config import parse_cli
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.trainer.logger import Logger
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.trainer.tuner import grid_search
from sslrec_tpu_torch.utils import checkpoint as ckpt


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu``; raises when ``cuda`` is asked for and absent."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")


def main(argv=None):
    """Run the CLI; returns the :class:`Trainer` (a tune returns ``(best test
    score, assignment)``)."""
    cfg = parse_cli(argv)
    device = resolve_device(cfg.train.device)
    # full float32 in the rating matmul: TF32 would add ~1e-3 to the scores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if "results_dir" not in cfg.train:
        # CLI runs write a results artifact; the JAX package's results/ stays
        # its own
        cfg = cfg.set_path("train.results_dir", "results_torch")
    logger = Logger(cfg)
    try:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        logger.log(f"device: {device} ({name})")
        data = load_data(cfg, device)
        logger.log(f"data loaded: {data.user_num} users x {data.item_num} items, "
                   f"{data.n_train} train interactions")
        if cfg.tune.get("enable", False):
            return grid_search(cfg, data, logger)
        model = build_model(cfg, data)
        trainer = Trainer(cfg, model, data, logger)
        pretrain = cfg.train.get("pretrain_path")
        if pretrain:
            model.load_state_dict(ckpt.load(pretrain, model.state_dict()))
            trainer.test_results = trainer.test()
            logger.log_eval(trainer.test_results, cfg.test.k, name="(test from checkpoint)")
            return trainer
        trainer.train()
        return trainer
    finally:
        logger.close()


if __name__ == "__main__":
    main(sys.argv[1:])
