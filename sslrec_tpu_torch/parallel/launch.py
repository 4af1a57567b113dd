"""Start the ranks of a mesh without a launcher: one process per device.

The JAX package drives a mesh from one process; torch's idiom is one process
a device.  :func:`spawn` starts ``world`` ranks with ``torch.multiprocessing``
(start method ``spawn``), joined through a ``FileStore`` in a fresh
temporary directory, runs ``fn(*args)`` in each and returns each rank's
result (saved with ``torch.save``, read back on the CPU).  A rank that fails
fails the call: ``torch.multiprocessing`` ends the others and raises.

The backend is NCCL on the card and gloo on the CPU unless the caller names
one: ``device="cuda"`` puts rank ``r`` on card ``r``, ``device="cuda:0"``
every rank on card 0 (which only gloo allows).  On the CPU each rank keeps
one thread.  The functions that ranks run live in this package, so that a
child imports torch and the port, whatever started it.
"""

from __future__ import annotations

import os
import tempfile
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda`` without an index spreads the ranks over
    the cards, anything else is every rank's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def spawn(fn, args: tuple, world: int, device: str = "cpu", backend: str | None = None,
          root: str | None = None) -> list:
    """``[fn(*args) on rank r for r in range(world)]``, each rank in a process
    of its own inside a started process group (see the module); the
    rendezvous file and the results live in a temporary directory under
    ``root`` (default the system's)."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    with tempfile.TemporaryDirectory(prefix="sslrec_mesh_", dir=root) as tmp:
        mp.spawn(_worker, args=(world, tmp, backend, str(device), fn, args), nprocs=world,
                 join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]


def _worker(rank: int, world: int, tmp: str, backend: str, device: str, fn, args) -> None:
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    warnings.filterwarnings("ignore", category=FutureWarning, module="torch.distributed")
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        from sslrec_tpu_torch.parallel import mesh
        mesh.reset()
        dist.destroy_process_group()


def cli_rank(argv: list[str], probe=None) -> dict:
    """A rank of a CLI run (``sslrec_tpu_torch.main``) in a started group:
    what the parent returns from it (see :class:`MeshRun`); ``probe(trainer)``,
    where given, runs after the launch counts are read and adds its result
    under ``"probe"``."""
    from sslrec_tpu_torch import main as cli
    from sslrec_tpu_torch.ops import segment_kernel, spmm_kernel

    spmm_kernel.csr_spmm.launches = spmm_kernel.csr_spmm.combine_launches = 0
    spmm_kernel.csr_spmm.by_shape = {}
    segment_kernel.segment_max.launches = 0
    trainer = cli.main(argv)
    out = {"rank": dist.get_rank(), "launches": spmm_kernel.csr_spmm.launches,
           "combine_launches": spmm_kernel.csr_spmm.combine_launches,
           "launches_by_shape": {k: list(c) for k, c in spmm_kernel.csr_spmm.by_shape.items()},
           "b2_launches": segment_kernel.segment_max.launches}
    if hasattr(trainer, "best_state"):
        out.update(best_state={k: v.cpu() for k, v in trainer.best_state.items()},
                   test_results=trainer.test_results, epochs=trainer.recorder.epochs,
                   n_batches=trainer.n_batches, mesh=trainer.mesh.shape,
                   local_shapes={k: tuple(v.shape) for k, v in trainer.model.state_dict().items()})
    elif hasattr(trainer, "test_results"):
        out.update(test_results=trainer.test_results)
    if probe is not None:
        out["probe"] = probe(trainer)
    return out


class MeshRun:
    """What the CLI returns for a mesh it started: each rank's summary
    (``ranks``: B1's and B2's launches in that rank, B1's also by layout
    shape, and the parameter shapes it held), and rank 0's ``best_state`` (whole tables),
    ``test_results``, epochs and steps an epoch."""

    def __init__(self, ranks: list[dict]):
        self.ranks = ranks
        main = ranks[0]
        self.best_state = main.get("best_state")
        self.test_results = main.get("test_results")
        self.epochs = main.get("epochs")
        self.n_batches = main.get("n_batches")
        self.mesh = main.get("mesh")
