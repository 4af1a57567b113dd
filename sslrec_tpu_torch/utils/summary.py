"""Scalar summaries (port of ``sslrec_tpu/utils/summary.py``, without its
``jax.profiler`` context; ``profile_epoch`` traces the card).

A CSV-backed scalar writer (``tag,step,value,wall_time``; TensorBoard is not
a dependency) that is live when ``train.tensorboard`` is set, else a no-op.
The port writes under ``runs_torch/``, apart from the JAX package's ``runs/``.
"""

from __future__ import annotations

import os
import time


class ScalarWriter:
    """Append-only ``tag,step,value,wall_time`` CSV per run."""

    def __init__(self, log_dir: str = "runs_torch"):
        os.makedirs(log_dir, exist_ok=True)
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.path = os.path.join(log_dir, f"scalars_{ts}.csv")
        self._f = open(self.path, "a")
        self._f.write("tag,step,value,wall_time\n")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(f"{tag},{step},{float(value)},{time.time()}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class DisabledScalarWriter:
    """No-op writer."""

    def add_scalar(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        pass


def make_writer(cfg):
    if cfg.train.get("tensorboard", False):
        return ScalarWriter()
    return DisabledScalarWriter()
