"""The ``train.mesh`` and ``train.distributed`` keys (the counterpart of
``sslrec_tpu/parallel/mesh.py``'s ``mesh_from_config`` and
``maybe_distributed_init``), refused until the port has a mesh.

The port trains on one device.  A mesh of one device (``train.mesh`` absent,
empty, or with axes whose product is 1) is that device, and is accepted.  A
mesh of more than one device, ``train.distributed``, and the variables that
start a multi-host run (``SSLREC_COORDINATOR``, ``SSLREC_DISTRIBUTED=1``)
raise ``NotImplementedError``: data-parallel batches, row-sharded tables and
partitioned propagation are not ported yet (ROADMAP Queue A, item 6).

The mesh's size is reckoned as the JAX package's ``make_mesh`` reckons it:
an axis left out fills the devices there are (``torch.cuda.device_count()``
on the card, 1 on the CPU).
"""

from __future__ import annotations

import os

import torch

_NOT_PORTED = ("the device mesh and multi-host training are not ported yet (ROADMAP "
               "Queue A item 6, parallelism); the port trains on one device")


def device_count(device: torch.device | str = "cpu") -> int:
    """The devices a mesh could span: the cards on the card, 1 on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def mesh_shape(cfg, n_devices: int) -> tuple[int, int] | None:
    """``(data, model)`` of ``train.mesh`` over ``n_devices`` devices, as
    ``make_mesh`` sizes it (an axis left out fills the rest); None where the
    key is absent or empty."""
    spec = cfg.train.get("mesh")
    if not spec:
        return None
    n_data, n_model = spec.get("data"), spec.get("model")
    n_data = int(n_data) if n_data else None
    n_model = int(n_model) if n_model else None
    if n_data is None and n_model is None:
        return None
    if n_model is None:
        n_model = n_devices // n_data
    elif n_data is None:
        n_data = n_devices // n_model
    return n_data, n_model


def mesh_from_config(cfg, device: torch.device | str = "cpu") -> None:
    """Check ``train.mesh``: None for a mesh of one device (the only one the
    port runs); ``NotImplementedError`` for any other (an axis larger than
    the devices leaves the other at 0 devices, which ``make_mesh`` cannot
    lay out either)."""
    shape = mesh_shape(cfg, device_count(device))
    if shape is not None and shape[0] * shape[1] != 1:
        raise NotImplementedError(f"train.mesh {dict(cfg.train.mesh)} is a "
                                  f"{shape[0]}x{shape[1]} mesh: {_NOT_PORTED}")
    return None


def maybe_distributed_init(cfg=None) -> bool:
    """False where nothing asks for a multi-host run; ``NotImplementedError``
    where ``train.distributed`` or the environment does."""
    spec = dict(cfg.train.get("distributed") or {}) if cfg is not None else {}
    coord = os.environ.get("SSLREC_COORDINATOR", spec.get("coordinator"))
    auto = os.environ.get("SSLREC_DISTRIBUTED", "") == "1" or spec.get("enable")
    if spec or coord or auto:
        raise NotImplementedError(f"train.distributed / SSLREC_COORDINATOR / "
                                  f"SSLREC_DISTRIBUTED: {_NOT_PORTED}")
    return False
