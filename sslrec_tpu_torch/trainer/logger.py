"""Run logger: file + stdout (port of ``sslrec_tpu/trainer/logger.py``):
``log``, ``log_loss`` (epoch loss dict), ``log_eval`` (metric@k grid)."""

from __future__ import annotations

import datetime
import functools
import logging
import os

from sslrec_tpu_torch.parallel.mesh import is_main_process


class Logger:
    def __init__(self, cfg, log_dir: str = "./log"):
        self.cfg = cfg
        name = cfg.model.name
        self._logger = logging.getLogger(f"sslrec_tpu_torch.{name}.{id(self)}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        d = os.path.join(log_dir, name)
        os.makedirs(d, exist_ok=True)
        fmt = logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S")
        for h in (logging.FileHandler(os.path.join(d, f"{cfg.data.name}_{ts}.log")),
                  logging.StreamHandler()):
            h.setFormatter(fmt)
            self._logger.addHandler(h)
        self.log(f"config: {cfg.to_dict()}")

    def log(self, msg: str):
        self._logger.info(msg)

    def close(self):
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)

    def log_loss(self, epoch: int, losses: dict):
        parts = ", ".join(f"{k}: {float(v):.4f}" for k, v in losses.items())
        self.log(f"[Epoch {epoch:3d}] {parts}")

    def log_eval(self, results: dict, ks, epoch: int | None = None, name: str = ""):
        head = f"[Epoch {epoch:3d}] " if epoch is not None else ""
        parts = []
        for metric, vals in results.items():
            for k, v in zip(ks, vals):
                parts.append(f"{metric}@{k}: {float(v):.5f}")
        self.log(f"{head}{name} {' '.join(parts)}")


class NullLogger:
    """The logger of a mesh rank other than 0, which logs nothing."""

    def __init__(self, cfg=None):
        self.cfg = cfg

    def log(self, msg: str):
        pass

    def log_loss(self, epoch: int, losses: dict):
        pass

    def log_eval(self, results: dict, ks, epoch: int | None = None, name: str = ""):
        pass

    def close(self):
        pass


def rank_logger(cfg):
    """A :class:`Logger` in the process that logs (rank 0 of a group, or the
    only process), a :class:`NullLogger` in every other rank."""
    return Logger(cfg) if is_main_process() else NullLogger(cfg)


def log_exceptions(fn):
    """Decorator: log any exception through the instance's logger, then
    re-raise."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except Exception as e:  # noqa: BLE001 — log-and-reraise by design
            logger = getattr(self, "logger", None)
            if logger is not None:
                logger.log(f"exception in {fn.__name__}: {e!r}")
            raise
    return wrapper
