"""Results artifact for every CLI run (port of ``sslrec_tpu/utils/results.py``).

Records the full config, seed, per-epoch loss + valid-metric trajectory, final
valid/test metric vectors and wall time as one JSON file.  Disabled for
library use (``train.results_dir`` empty); the port's CLI writes to
``results_torch/``, never to the JAX package's ``results/``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


def _jsonable(v: Any) -> Any:
    """Best-effort conversion of numpy/torch scalars and arrays."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, Mapping):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class RunRecorder:
    """Accumulates one run's trajectory; ``finalize`` writes the JSON file.

    Filename is deterministic (``<model>_<dataset>[_<run_tag>].json``) so
    regenerating a run overwrites its artifact instead of piling up copies.
    """

    def __init__(self, cfg, out_dir: str | None = None):
        self.cfg = cfg
        self.out_dir = out_dir if out_dir is not None else str(
            cfg.train.get("results_dir", "") or "")
        self.epochs: list[dict] = []
        self.t0 = time.time()
        self.extra: dict = {}

    @property
    def enabled(self) -> bool:
        return bool(self.out_dir)

    def record_epoch(self, epoch: int, losses: Mapping | None = None,
                     valid: Mapping | None = None, **timing) -> None:
        if not self.enabled:
            return
        row: dict[str, Any] = {"epoch": int(epoch)}
        if losses is not None:
            row["loss"] = _jsonable(losses)
        if valid is not None:
            row["valid"] = _jsonable(valid)
        row.update(_jsonable(timing))
        self.epochs.append(row)
        # periodic partial flush: a run killed mid-train still leaves an
        # auditable trajectory on disk
        if valid is not None or len(self.epochs) % 25 == 0:
            self._write(partial=True)

    def note(self, **kv) -> None:
        """Attach run-level annotations (device, data provenance)."""
        self.extra.update({k: _jsonable(v) for k, v in kv.items()})

    def path(self) -> str:
        tag = str(self.cfg.train.get("run_tag", "") or "")
        name = f"{self.cfg.model.name}_{self.cfg.data.name}"
        if tag:
            name += f"_{tag}"
        return os.path.join(self.out_dir, name + ".json")

    def finalize(self, best_valid: Mapping | None = None,
                 test: Mapping | None = None) -> str | None:
        return self._write(best_valid=best_valid, test=test, partial=False)

    def _write(self, best_valid: Mapping | None = None,
               test: Mapping | None = None, partial: bool = False) -> str | None:
        if not self.enabled:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        doc = {
            "model": self.cfg.model.name,
            "dataset": self.cfg.data.name,
            "seed": int(self.cfg.train.seed),
            "k": _jsonable(self.cfg.test.k),
            "metrics": _jsonable(self.cfg.test.metrics),
            "wall_s": round(time.time() - self.t0, 2),
            "written_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "best_valid": _jsonable(best_valid) if best_valid is not None else None,
            "test": _jsonable(test) if test is not None else None,
            "config": _jsonable(self.cfg.to_dict()),
            "trajectory": self.epochs,
        }
        if partial:
            doc["partial"] = True
        doc.update(self.extra)
        p = self.path()
        with open(p, "w") as f:
            json.dump(doc, f, indent=1)
        return p
