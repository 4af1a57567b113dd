"""Where a training epoch and an evaluation spend their time on the card.

    python -m sslrec_tpu_torch.profile_epoch --model sgl --data_dir datasets \
        --dataset alibaba-fashion [--out chiprun_out/profile]
    python -m sslrec_tpu_torch.profile_epoch --model lightgcn --lanes 3 ...

Takes the CLI's flags (``--device`` must be ``cuda``); ``--model`` is any
registered model, each epoch driven by the trainer the CLI uses (a model's
per-epoch hook and device generator included).  Loads the data,
trains epoch 0 as a warm-up, then times epochs 1-3 and three evaluations of
the valid split with the host clock, and traces epoch 4 and a fourth
evaluation with ``torch.profiler``.  Prints the untraced wall times, the
device's busy share of their median, device time by kernel, and the copies
among them (kernels and transfers whose name says copy); writes a Chrome
trace per window under ``--out``.

``--lanes K`` profiles an epoch of ``tune.parallel``'s K lanes instead
(:class:`~sslrec_tpu_torch.trainer.lanes.Lanes`, a model with an
``hparams()`` hook), every lane at the config's scalars, and an evaluation
of every lane.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sslrec_tpu_torch.config import parse_cli
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.main import resolve_device
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.trainer.lanes import Lanes
from sslrec_tpu_torch.trainer.metrics import Evaluator
from sslrec_tpu_torch.trainer.trainer import INIT_STREAM, Trainer, build_optimizer, generator


def device_us(evt) -> float:
    """Device time of a profiler event (the attribute's name varies by torch version)."""
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def report(name: str, prof, wall_s: float, top: int = 25) -> None:
    """Busy share = traced device kernel time over the untraced wall time of
    the same window (one stream, so kernels do not overlap).  Only kernels and
    copies count: an operator's row, or a ``record_function`` range such as
    ``Optimizer.step``, repeats the time of the kernels inside it."""
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(device_us(e) for e in rows)
    print(f"-- {name}: median wall {wall_s * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / (wall_s * 1e6):.1f}%), idle "
          f"{100 - 100 * busy_us / (wall_s * 1e6):.1f}%, "
          f"{sum(e.count for e in rows)} kernels and copies")
    for e in sorted(rows, key=device_us, reverse=True)[:top]:
        print(f"   {device_us(e) / 1e3:9.3f} ms {100 * device_us(e) / busy_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}")
    copies = [e for e in rows if "copy" in e.key.lower()]
    copy_us = sum(device_us(e) for e in copies)
    print(f"-- copies: {sum(e.count for e in copies)} kernels and transfers, "
          f"{copy_us / 1e3:.3f} ms ({100 * copy_us / max(busy_us, 1e-9):.1f}% of device busy)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out", default=os.path.join("chiprun_out", "profile"))
    p.add_argument("--lanes", type=int, default=0)
    args, rest = p.parse_known_args(argv)
    cfg = parse_cli(rest)
    device = resolve_device(cfg.train.device)
    if device.type != "cuda":
        raise SystemExit("profile_epoch: needs --device cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    os.makedirs(args.out, exist_ok=True)
    data = load_data(cfg, device)
    model = build_model(cfg, data)
    split = data.valid if data.valid is not None else data.test
    if args.lanes:
        train_epoch, evaluate, n_batches = lanes_windows(cfg, model, data, args.lanes)
    else:
        model.init_params(generator(int(cfg.train.seed), INIT_STREAM))
        trainer = Trainer(cfg, model, data)
        evaluator = Evaluator(split, cfg)
        train_epoch, n_batches = trainer.train_epoch, trainer.n_batches

        def evaluate(_):
            evaluator(model)
    train_epoch(0)                  # warm-up: allocator, library load, kernel build
    evaluate(0)
    torch.cuda.synchronize()
    lanes = f" x {args.lanes} lanes" if args.lanes else ""
    windows = (("train epoch", f"{n_batches} steps{lanes}", train_epoch),
               ("evaluation", f"{split.n_test_users} users{lanes}", evaluate))
    for name, what, fn in windows:
        walls = []
        for rep in range(1, 4):     # untraced: the profiler's own cost left out
            t0 = time.perf_counter()
            fn(rep)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"-- {name}: untraced wall " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
              + " ms")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(4)
            torch.cuda.synchronize()
        report(f"{name} ({what}), traced once", prof, sorted(walls)[1])
        prof.export_chrome_trace(os.path.join(args.out, name.replace(" ", "_") + ".json"))


def lanes_windows(cfg, model, data, k: int):
    """An epoch of ``k`` lanes and an evaluation of every lane, as callables
    of the epoch: each lane at the config's ``hparams()`` scalars."""
    lanes = Lanes(cfg, model, data)
    params = lanes.init_lanes(k)
    optimizer = build_optimizer(cfg, list(params.values()))
    hp = {n: torch.full((k,), float(v), device=lanes.device)
          for n, v in model.hparams().items()}

    def train_epoch(epoch):
        lanes.train_epoch(params, optimizer, epoch, hp)

    def evaluate(_):
        lanes.lane_scores(params, lanes.valid, range(k))

    return train_epoch, evaluate, lanes.trainer.n_batches


if __name__ == "__main__":
    main(sys.argv[1:])
