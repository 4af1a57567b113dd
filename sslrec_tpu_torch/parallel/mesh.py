"""Device mesh on ``torch.distributed`` (port of ``sslrec_tpu/parallel/mesh.py``).

One mesh with axes ``('data', 'model')``:

- ``data``: the batch dimension (interaction batches, eval users);
- ``model``: embedding-table rows and the graph's destination-row partitions.

The JAX package drives every device from one process and lets XLA insert the
collectives.  Here a process drives one device: a mesh of ``N × M`` devices is
a process group of ``N·M`` ranks, rank ``r`` at coordinates ``(r // M, r %
M)`` (``make_mesh``'s row-major order), and each rank holds the process
groups of its ``data`` row (the ``M`` ranks that share its batch slice and
split the tables' rows) and of its ``model`` column (the ``N`` ranks that
hold the same rows and split the batch).  Every rank makes every group, in
the same order, as ``dist.new_group`` asks.

Sizing is ``make_mesh``'s: an axis left out fills the devices there are, and
a mesh larger than the devices raises ``ValueError``.  The devices there are:
the world size of a started process group; else ``torch.cuda.device_count()``
on the card; else, on the CPU, one for an axis left out, while a mesh whose
axes are both given gets as many gloo processes as it names (the CPU stands
in for devices, as the JAX package's virtual CPU devices do in its tests).

:func:`maybe_distributed_init` starts a multi-process run from
``train.distributed`` or the ``SSLREC_*`` variables.  Since a process drives
one device, ``num_processes`` counts devices, not hosts.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place in a ``(data, model)`` mesh: its coordinates, its
    device, and the groups of its ``data`` row (``model_group``: the ranks
    that differ only in the model coordinate) and ``model`` column
    (``data_group``)."""

    def __init__(self, n_data: int, n_model: int, rank: int, device, model_group,
                 data_group):
        self.n_data, self.n_model = int(n_data), int(n_model)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.model_group, self.data_group = model_group, data_group

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def mesh_dims(n_data: int | None, n_model: int | None, n_devices: int | None) -> tuple[int, int]:
    """``(data, model)`` over ``n_devices`` as ``make_mesh`` sizes them: all
    devices on ``data`` when neither is given, else the axis left out fills
    the rest.  ``n_devices`` None: the CPU, one device for an axis left out
    and as many as two given axes name.  ``ValueError`` where the mesh
    cannot be laid out on the devices."""
    n = 1 if n_devices is None else int(n_devices)
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_model is None:
        n_model = n // n_data
    elif n_data is None:
        n_data = n // n_model
    if n_devices is None and min(n_data, n_model) >= 1:
        n = n_data * n_model
    if min(n_data, n_model) < 1 or n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {n} devices")
    return int(n_data), int(n_model)


def device_count(device: torch.device | str = "cpu") -> int | None:
    """The devices a mesh may span: a started group's world size, else the
    cards on the card, else None (the CPU; see :func:`mesh_dims`)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return None


def mesh_shape(cfg, n_devices: int | None) -> tuple[int, int] | None:
    """``(data, model)`` of ``train.mesh`` over ``n_devices``
    (:func:`mesh_dims`); None where the key is absent or empty."""
    spec = cfg.train.get("mesh")
    if not spec:
        return None
    n_data, n_model = spec.get("data"), spec.get("model")
    if not n_data and not n_model:
        return None
    return mesh_dims(int(n_data) if n_data else None, int(n_model) if n_model else None,
                     n_devices)


def config_shape(cfg, device) -> tuple[int, int] | None:
    """``train.mesh``'s ``(data, model)`` on ``device``'s devices, or None for
    a run on one device (no key, or a 1×1 mesh)."""
    shape = mesh_shape(cfg, device_count(device))
    return None if shape is None or shape == (1, 1) else shape


def check_model(model_cls, shape) -> None:
    """``NotImplementedError`` where a mesh of more than one device asks for
    a model class that still sets ``mesh_todo`` (it has no mesh branch); no
    model runs replicated in silence.  All 31 models of the registry train
    on a mesh."""
    todo = getattr(model_cls, "mesh_todo", None)
    if shape is not None and todo is not None:
        raise NotImplementedError(
            f"train.mesh {shape[0]}x{shape[1]}: {model_cls.__name__} does not run on a "
            f"device mesh ({todo}); all 31 models of the registry do")


_MESHES: dict = {}


def make_mesh(n_data: int | None = None, n_model: int | None = None, devices=None,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` over the started process group (or a world of
    one).  ``devices``: the devices the mesh may span (its length sizes an
    axis left out; default the world's ranks); ``device``: this rank's
    (default the card it has set, else the CPU).  The group's world size
    must be the mesh's size.  Made once per process and shape."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    n_data, n_model = mesh_dims(n_data, n_model, world if devices is None else len(devices))
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs a process group of "
                         f"{n_data * n_model} ranks, one a device; this one has {world}")
    rank = dist.get_rank() if started else 0
    if device is None:
        device = (devices[rank] if devices is not None else
                  torch.device("cuda", torch.cuda.current_device())
                  if started and dist.get_backend() == "nccl" else "cpu")
    key = (n_data, n_model, world, rank)
    if key not in _MESHES:
        model_groups = [_group([d * n_model + m for m in range(n_model)], started)
                        for d in range(n_data)]
        data_groups = [_group([d * n_model + m for d in range(n_data)], started)
                       for m in range(n_model)]
        _MESHES[key] = (model_groups[rank // n_model], data_groups[rank % n_model])
    model_group, data_group = _MESHES[key]
    return Mesh(n_data, n_model, rank, device, model_group, data_group)


def _group(ranks: list[int], started: bool):
    """A process group of ``ranks`` (every rank makes every group, one of a
    single rank too), or None outside a started group, where collectives are
    no-ops."""
    return dist.new_group(ranks) if started else None


def reset() -> None:
    """Forget the meshes made (their groups die with the process group)."""
    _MESHES.clear()


def mesh_from_config(cfg, device: torch.device | str = "cpu") -> Mesh | None:
    """``train.mesh: {data: N, model: M}`` as this rank's :class:`Mesh`, or
    None for a run on one device (no key, an empty one, or 1×1: the
    single-device path, unchanged).  Either axis may be left out
    (:func:`mesh_dims`)."""
    shape = config_shape(cfg, device)
    if shape is None:
        return None
    return make_mesh(*shape, device=torch.device(device))


def is_main_process() -> bool:
    """Rank 0 of a started group, or the only process: the one that logs and
    writes the run's files."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def maybe_distributed_init(cfg=None, device: torch.device | str = "cpu") -> bool:
    """Gated ``torch.distributed.init_process_group`` for a multi-process run.

    Enable with the variables (a process drives one device, so
    ``SSLREC_NUM_PROCESSES`` counts devices)::

        SSLREC_COORDINATOR=host0:1234 SSLREC_NUM_PROCESSES=2 SSLREC_PROCESS_ID=0

    or ``train.distributed: {coordinator: ..., num_processes: N, process_id:
    K}``: ``init_method="tcp://<coordinator>"`` with that world size and
    rank.  ``SSLREC_DISTRIBUTED=1`` (or ``train.distributed.enable``) joins a
    group that ``torchrun`` describes (``env://``).  The backend is NCCL on
    ``cuda``, gloo on the CPU.  Returns True where a group is running after
    the call (idempotent), False where nothing asks for one.
    """
    if dist.is_initialized():
        return True
    spec = dict(cfg.train.get("distributed") or {}) if cfg is not None else {}
    coord = os.environ.get("SSLREC_COORDINATOR", spec.get("coordinator"))
    n_proc = os.environ.get("SSLREC_NUM_PROCESSES", spec.get("num_processes"))
    proc_id = os.environ.get("SSLREC_PROCESS_ID", spec.get("process_id"))
    auto = os.environ.get("SSLREC_DISTRIBUTED", "") == "1" or spec.get("enable")
    if not (auto or coord):
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coord:
        if n_proc is None or proc_id is None:
            raise ValueError(
                "distributed init: a coordinator address requires num_processes "
                "and process_id (SSLREC_NUM_PROCESSES / SSLREC_PROCESS_ID or "
                "train.distributed.{num_processes,process_id})")
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(n_proc), rank=int(proc_id))
    else:
        dist.init_process_group(backend, init_method="env://")
    return True
