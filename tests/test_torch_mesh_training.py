"""``train.mesh`` through the port's CLI on gloo processes against the
single-device run: the counterparts of ``tests/test_mesh_training.py``.

``python -m sslrec_tpu_torch.main --device cpu`` with ``train.mesh`` starts
one gloo process a device and returns rank 0's whole tables and metrics.
LightGCN's dropout PRF is keyed by the original edge id, so a mesh run draws
the single run's masks, and the runs differ only in the order of float32
sums: parameters within rtol 2e-4 / atol 2e-5 and test metrics within rtol
1e-4, JAX's tolerances.  Checkpoints are whole tables, so a train state
moves between a mesh run and a single-device run (the same tolerances).
"""

import json
import os

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.parallel import mesh as mesh_mod
from test_torch_main import _toy_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2


def _run(root, cwd, *sets):
    """A CLI run on the toy split with ``cwd`` as the working directory
    (its ``log/`` and ``checkpoint_torch/``)."""
    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return tmain.main(["--model", "lightgcn", "--data_dir", str(root), "--dataset", "toy",
                           "--device", "cpu", "--epoch", str(EPOCHS),
                           "--set", "train.batch_size=128", "--set", "train.test_step=1",
                           "--set", "train.results_dir=res",
                           *[a for s in sets for a in ("--set", s)]])
    finally:
        os.chdir(old)


def _mesh(d, m):
    return (f"train.mesh.data={d}", f"train.mesh.model={m}")


def _saved(cwd, suffix=".ckpt.state"):
    """The files a run in ``cwd`` saved with ``suffix``, oldest first (the
    train states: one an epoch)."""
    d = cwd / "checkpoint_torch" / "lightgcn"
    files = [p for p in d.iterdir() if p.name.endswith(suffix)] if d.is_dir() else []
    return sorted(files, key=lambda p: p.stat().st_mtime_ns)


def _assert_same(single, state, results):
    for k, v in single.best_state.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)
    for m, v in single.test_results.items():
        np.testing.assert_allclose(results[m], v, rtol=1e-4, atol=1e-6, err_msg=m)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The toy split, a single run and a {data: 2, model: 2} run, both
    writing a train state each epoch."""
    root = tmp_path_factory.mktemp("mesh_cli")
    _toy_split(root)
    every = "train.save_state_every=1"
    single = _run(root, root / "single", every, "train.save_model=true")
    mesh = _run(root, root / "mesh22", every, *_mesh(2, 2))
    return root, single, mesh


def test_mesh_run_equals_single_and_rank0_writes(runs):
    root, single, mesh = runs
    assert mesh.mesh == {"data": 2, "model": 2}
    _assert_same(single, mesh.best_state, mesh.test_results)
    cwd = root / "mesh22"
    assert os.listdir(cwd / "res") == ["lightgcn_toy.json"]
    doc = json.loads((cwd / "res" / "lightgcn_toy.json").read_text())
    assert doc["mesh"] == {"data": 2, "model": 2} and len(doc["trajectory"]) == EPOCHS
    assert len(os.listdir(cwd / "log" / "lightgcn")) == 1
    assert len(_saved(cwd)) == EPOCHS       # rank 0's train states only
    for a, b in zip(single.recorder.epochs, mesh.epochs):
        np.testing.assert_allclose(b["loss"]["loss"], a["loss"]["loss"], rtol=1e-5)


def test_mesh_rows_are_split(runs):
    """Each rank of the {2, 2} mesh holds U_loc = 40 of the 80 user rows and
    I_loc = 25 of the 50 item rows, and gets whole tables back."""
    _, _, mesh = runs
    assert [r["local_shapes"] for r in mesh.ranks] == [
        {"user_embeds": (40, 32), "item_embeds": (25, 32)}] * 4
    assert mesh.best_state["user_embeds"].shape == (80, 32)


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_mesh_parity_degenerate_axes(runs, shape):
    root, single, _ = runs
    run = _run(root, root / f"mesh{shape[0]}{shape[1]}", *_mesh(*shape))
    assert run.mesh == {"data": shape[0], "model": shape[1]}
    _assert_same(single, run.best_state, run.test_results)


def test_checkpoints_move_between_mesh_and_single(runs):
    """The mesh run's state after epoch 0 resumed on one device, and the
    single run's resumed on a {1, 2} mesh, each equal to the uninterrupted
    single run."""
    root, single, _ = runs
    mesh_state = _saved(root / "mesh22")[0]
    on_one = _run(root, root / "resume1", f"train.resume_path={mesh_state}")
    assert [r["epoch"] for r in on_one.recorder.epochs] == [1]
    _assert_same(single, on_one.best_state, on_one.test_results)
    single_state = _saved(root / "single")[0]
    on_mesh = _run(root, root / "resume12", f"train.resume_path={single_state}", *_mesh(1, 2))
    assert [r["epoch"] for r in on_mesh.epochs] == [1]
    _assert_same(single, on_mesh.best_state, on_mesh.test_results)


def test_saved_model_tests_on_a_mesh(runs):
    """``train.pretrain_path``: the single run's saved best tables tested on
    a {1, 2} mesh give the single run's test metrics."""
    root, single, _ = runs
    saved = _saved(root / "single", ".ckpt")
    assert len(saved) == 1
    tested = _run(root, root / "pretrain12", f"train.pretrain_path={saved[0]}", *_mesh(1, 2))
    assert tested.best_state is None
    for m, v in single.test_results.items():
        np.testing.assert_allclose(tested.test_results[m], v, rtol=1e-4, atol=1e-6, err_msg=m)


@pytest.fixture
def gate(monkeypatch):
    """``init_process_group`` recorded; the variables cleared."""
    for var in ("SSLREC_COORDINATOR", "SSLREC_NUM_PROCESSES", "SSLREC_PROCESS_ID",
                "SSLREC_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_distributed_init_gate(gate, monkeypatch):
    """A no-op unless asked; the cluster spec forwarded to
    ``init_process_group`` when it is; a running group makes it a no-op."""
    cfg = load_config("lightgcn")
    assert mesh_mod.maybe_distributed_init(cfg) is False and gate == []
    monkeypatch.setenv("SSLREC_COORDINATOR", "host0:1234")
    monkeypatch.setenv("SSLREC_NUM_PROCESSES", "2")
    monkeypatch.setenv("SSLREC_PROCESS_ID", "1")
    assert mesh_mod.maybe_distributed_init(cfg) is True
    assert gate == [(("gloo",), {"init_method": "tcp://host0:1234", "world_size": 2,
                                 "rank": 1})]
    gate.clear()
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    assert mesh_mod.maybe_distributed_init(cfg) is True and gate == []


def test_distributed_init_requires_full_spec(gate, monkeypatch):
    monkeypatch.setenv("SSLREC_COORDINATOR", "host0:1234")
    with pytest.raises(ValueError, match="num_processes"):
        mesh_mod.maybe_distributed_init(load_config("lightgcn"))
    assert gate == []


def test_torchrun_and_card_backends(gate, monkeypatch):
    """``SSLREC_DISTRIBUTED=1`` joins torchrun's group (``env://``); NCCL is
    the backend on ``cuda``."""
    monkeypatch.setenv("SSLREC_DISTRIBUTED", "1")
    assert mesh_mod.maybe_distributed_init(load_config("lightgcn"), torch.device("cuda"))
    assert gate == [(("nccl",), {"init_method": "env://"})]
