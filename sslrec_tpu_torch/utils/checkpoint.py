"""Checkpoints: parameters and train states (port of
``sslrec_tpu/utils/checkpoint.py``, in the port's own format).

One file written by ``torch.save``: ``{"format": FORMAT, "payload": obj}``
with ``obj`` nested dicts, lists and tuples of tensors, ints, floats and
strings.  :func:`load` reads it back with ``torch.load(weights_only=True)``
on the CPU and checks every name, shape and dtype against a template (a
pytree of the same structure, such as a fresh ``state_dict()``); a mismatch
raises.  The JAX package's flax msgpack files are not this format, and
:func:`load` says so rather than misreading them.

The port writes under ``checkpoint_torch/<model>/`` (see
:func:`checkpoint_path`), never into the JAX package's ``checkpoint/``.
"""

from __future__ import annotations

import datetime
import os

import torch

FORMAT = "sslrec_tpu_torch.checkpoint/1"
CHECKPOINT_DIR = "checkpoint_torch"


class Partial(dict):
    """A template dict whose saved counterpart may hold a subset of its keys
    (an optimizer's per-parameter state, absent for a parameter that has not
    been stepped)."""


def save(path: str, obj) -> None:
    """Write ``obj`` to ``path`` (tensors as they are; :func:`load` maps
    them to the CPU)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"format": FORMAT, "payload": obj}, path)


def load(path: str, template):
    """The object saved at ``path``, on the CPU, checked against ``template``."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head != b"PK\x03\x04":          # torch.save writes a zip archive
        jax_like = head[:1] and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
        raise ValueError(
            f"{path} is not a checkpoint of sslrec_tpu_torch (a torch.save archive)"
            + ("; it looks like the JAX package's flax msgpack format, which this "
               "package does not read" if jax_like else ""))
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    obj = blob["payload"]
    _match(obj, template, "checkpoint")
    return obj


def _match(got, want, where: str) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{where}: want a dict, got {type(got).__name__}")
        extra, missing = set(got) - set(want), set(want) - set(got)
        if extra or (missing and not isinstance(want, Partial)):
            raise ValueError(f"{where}: names differ; unexpected {sorted(map(str, extra))}, "
                             f"missing {sorted(map(str, missing))}")
        for k in got:
            _match(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{where}: want a sequence of {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _match(g, w, f"{where}[{i}]")
    elif torch.is_tensor(want):
        if not torch.is_tensor(got) or got.shape != want.shape or got.dtype != want.dtype:
            desc = (f"{tuple(got.shape)} {got.dtype}" if torch.is_tensor(got)
                    else type(got).__name__)
            raise ValueError(f"{where}: want {tuple(want.shape)} {want.dtype}, got {desc}")
    elif type(got) is not type(want):
        raise ValueError(f"{where}: want {type(want).__name__}, got {type(got).__name__}")


def optim_state(opts: dict) -> dict:
    """The per-parameter state of each optimizer in ``opts`` (name → torch
    optimizer); hyperparameters are not saved, they come from the config."""
    return {name: opt.state_dict()["state"] for name, opt in opts.items()}


def optim_template(opts: dict) -> dict:
    """The template of :func:`optim_state` for Adam optimizers: per parameter
    (by its index) a float32 ``step`` and two moments shaped as the parameter."""
    out = {}
    for name, opt in opts.items():
        params = [p for g in opt.param_groups for p in g["params"]]
        out[name] = Partial({i: {"step": torch.zeros((), dtype=torch.float32),
                                 "exp_avg": torch.zeros_like(p, device="cpu"),
                                 "exp_avg_sq": torch.zeros_like(p, device="cpu")}
                             for i, p in enumerate(params)})
    return out


def load_optim_state(opts: dict, state: dict) -> None:
    """Restore :func:`optim_state` into ``opts``, keeping their hyperparameters."""
    for name, opt in opts.items():
        opt.load_state_dict({"state": state[name],
                             "param_groups": opt.state_dict()["param_groups"]})


def checkpoint_path(model: str, dataset: str, suffix: str = "") -> str:
    """``checkpoint_torch/<model>/<model>-<dataset>-<timestamp>.ckpt<suffix>``
    (the JAX package's name under its own root), with ``-1``, ``-2`` … added
    before ``.ckpt`` where that file exists, so that two saves in one second
    do not overwrite each other."""
    d = os.path.join(CHECKPOINT_DIR, model)
    os.makedirs(d, exist_ok=True)
    stem = os.path.join(d, f"{model}-{dataset}-"
                           f"{datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}")
    path, n = f"{stem}.ckpt{suffix}", 0
    while os.path.exists(path):
        n += 1
        path = f"{stem}-{n}.ckpt{suffix}"
    return path
