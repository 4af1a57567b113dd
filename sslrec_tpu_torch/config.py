"""Immutable configuration tree for sslrec_tpu_torch.

A copy of ``sslrec_tpu/config.py`` (the port imports nothing from the JAX
package), plus the ``--device`` flag.

The reference framework (SSLRec) keeps a *global mutable dict* singleton that every
layer imports and mutates (``config/configurator.py:5-57``; data handlers write
discovered stats back into it, ``data_utils/data_handler_general_cf.py:81``).  Here we
replace that with a frozen, hashable config tree that is loaded once from YAML + CLI
and threaded explicitly through constructors.  Dataset statistics discovered at load
time live on the :class:`~sslrec_tpu_torch.data.base.DataBundle`, not in the config.

YAML schema mirrors the reference's per-model files (``config/modelconf/*.yml``):
sections ``optimizer / train / test / data / model / tune``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Iterator, Mapping

import yaml


class Config(Mapping):
    """Immutable nested mapping with attribute access.

    ``cfg.model.layer_num`` and ``cfg['model']['layer_num']`` both work.  Nested
    dicts are recursively wrapped.  Hashable, so it can key a cache.
    """

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Mapping[str, Any]):
        wrapped = {}
        for k, v in data.items():
            if isinstance(v, Mapping) and not isinstance(v, Config):
                v = Config(v)
            elif isinstance(v, list):
                v = tuple(Config(x) if isinstance(x, Mapping) else x for x in v)
            wrapped[k] = v
        object.__setattr__(self, "_data", wrapped)
        object.__setattr__(self, "_hash", None)

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(f"Config has no key {key!r}; keys={list(self._data)}")

    def __setattr__(self, key: str, value: Any):
        raise TypeError("Config is immutable; use .replace(...)")

    # -- functional update --------------------------------------------------
    def replace(self, **updates: Any) -> "Config":
        """Return a new Config with top-level keys replaced/merged.

        Mapping values are *merged* one level deep into existing Config values so
        ``cfg.replace(model={'layer_num': 3})`` keeps other model keys.
        """
        data = dict(self._data)
        for k, v in updates.items():
            if isinstance(v, Mapping) and isinstance(data.get(k), Config):
                merged = dict(data[k]._data)
                merged.update(v)
                data[k] = Config(merged)
            else:
                data[k] = v
        return Config(data)

    def set_path(self, path: str, value: Any) -> "Config":
        """Return a new Config with a dotted path (e.g. 'model.layer_num') replaced."""
        head, _, rest = path.partition(".")
        if rest:
            sub = self._data.get(head, Config({}))
            if not isinstance(sub, Config):
                raise KeyError(f"{head} is not a section")
            return self.replace(**{head: dict(sub.set_path(rest, value)._data)})
        return self.replace(**{head: value})

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = [x.to_dict() if isinstance(x, Config) else x for x in v]
            out[k] = v
        return out

    def __hash__(self) -> int:
        h = object.__getattribute__(self, "_hash")
        if h is None:
            h = hash(tuple(sorted((k, _hashable(v)) for k, v in self._data.items())))
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self._data == other._data

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _hashable(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(v)
    return v


_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

# Defaults applied like the reference's inline normalisation
# (config/configurator.py:36-55): tune disabled unless present, log_loss on,
# patience>0 implies early stopping.
_DEFAULTS = {
    "optimizer": {"name": "adam", "lr": 1.0e-3, "weight_decay": 0.0},
    "train": {
        "epoch": 100,
        "batch_size": 4096,
        "save_model": False,
        "loss": "pairwise",
        "log_loss": True,
        "test_step": 1,
        "reproducible": True,
        "seed": 2023,
        "tensorboard": False,
        "trainer": "",
    },
    "test": {"metrics": ["recall", "ndcg"], "k": [10, 20, 40], "batch_size": 1024},
    "data": {"dir": "", "type": "general_cf", "name": "yelp"},
    "model": {},
    "tune": {"enable": False},
}


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    model: str,
    dataset: str | None = None,
    overrides: Mapping[str, Any] | None = None,
    config_dir: str | None = None,
) -> Config:
    """Load ``<config_dir>/<model>.yml``, apply defaults and overrides.

    ``overrides`` maps dotted paths ('train.epoch') or section dicts to values.
    """
    config_dir = config_dir or _CONFIG_DIR
    path = os.path.join(config_dir, f"{model.lower()}.yml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No config for model {model!r} at {path}. Available: "
            f"{sorted(f[:-4] for f in os.listdir(config_dir) if f.endswith('.yml'))}"
        )
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    merged = _deep_merge(_DEFAULTS, raw)
    if dataset is not None:
        merged["data"] = _deep_merge(merged["data"], {"name": dataset})
    cfg = Config(merged)
    if overrides:
        for k, v in overrides.items():
            if isinstance(v, Mapping) and "." not in k:
                cfg = cfg.replace(**{k: v})
            else:
                cfg = cfg.set_path(k, v)
    # early_stop derived from patience (reference: configurator.py:47-51) —
    # AFTER overrides so `--set train.patience=5` enables early stopping on a
    # config that ships without one; an explicit early_stop override wins
    explicit = "train.early_stop" in (overrides or {}) or \
        "early_stop" in (raw.get("train") or {})
    if not explicit:
        patience = cfg.train.get("patience", 0)
        cfg = cfg.set_path("train.early_stop", bool(patience and patience > 0))
    return cfg


def parse_cli(argv: list[str] | None = None) -> Config:
    """CLI mirroring the reference entry (``main.py`` / ``config/configurator.py``)."""
    p = argparse.ArgumentParser(description="sslrec_tpu_torch: SSL recommendation on PyTorch")
    p.add_argument("--model", type=str, required=True, help="model name (case-insensitive)")
    p.add_argument("--dataset", type=str, default=None, help="dataset name override")
    p.add_argument("--data_dir", type=str, default=None, help="root dir holding datasets/")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the run computes; never falls back to the CPU")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="PATH=VALUE",
        help="dotted config override, e.g. --set model.layer_num=3",
    )
    args = p.parse_args(argv)
    overrides: dict[str, Any] = {"train.device": args.device}
    if args.data_dir is not None:
        overrides["data.dir"] = args.data_dir
    if args.seed is not None:
        overrides["train.seed"] = args.seed
    if args.epoch is not None:
        overrides["train.epoch"] = args.epoch
    for item in args.set:
        path, _, val = item.partition("=")
        parsed = yaml.safe_load(val)
        if isinstance(parsed, str):
            # pyyaml follows YAML 1.1: "1e12" (no dot) is a string; users mean
            # the number — coerce strings that fully parse as int/float
            try:
                parsed = int(parsed)
            except ValueError:
                try:
                    parsed = float(parsed)
                except ValueError:
                    pass
        overrides[path] = parsed
    return load_config(args.model, dataset=args.dataset, overrides=overrides)
