"""BERT4Rec, CL4SRec, DuoRec, ICLRec, DCRec_seq and MAERec through the
port's CLI on device meshes of gloo processes against their single-device
runs (2 epochs on a toy sequential split of 53 users × 37 items,
``test_torch_seq_data.write_seq_dir``, at batch 31, so that the two ``data``
slices of a batch differ by a row).

The six run on {data: 2, model: 2} in one spawn of four ranks
(``parallel.checks.cli_runs``, each run followed by
``checks.layout_probe``), with a seventh: MAERec resumed on the mesh from
the single run's train state after epoch 0 (and, after the spawn, the single
run resumed from the mesh run's).  Every draw is the single run's on every
rank (the batch-sized ones drawn for the whole batch and sliced, the others
alike), and every term that crosses the batch is computed whole on every
rank, so the runs differ only in the order of float32 sums: the tables
within ``chip_smoke.MESH_PARAM_TOL``, the test metrics within
``MESH_METRIC_TOL``, each epoch's loss terms within its rtol, with an atol
of that rtol times the epoch's loss.  Each rank's B1 calls, counted on the
CPU where the card counts launches, equal ``chip_smoke.MESH_SEQ``'s count
(DCRec_seq's and MAERec's item graphs; the other four launch none), and
each rank's ``layout_probe`` finds those graphs (DCRec_seq's behind
``ItemGraph.g``).

The six also run on {data: 1, model: 2} in a second spawn of two ranks:
there every rank does the single run's work on the same inputs and the two
halved gradients sum exactly, so their tables and loss terms equal the
single run's bit for bit.

MAERec's train state holds its loss history (``extra_state``), which the
mesh run records whole on every rank: the state written by the mesh run
after epoch 0 carries the single run's history, and each resumed run's
state after epoch 1 (tables, Adam moments, history) is the uninterrupted
single run's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.parallel import checks, launch
from test_torch_seq_data import write_seq_dir

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2
MODELS = ("bert4rec", "cl4srec", "duorec", "iclrec", "dcrec_seq", "maerec")
COMMON = ("model.embedding_size=16", "model.max_seq_len=10", "model.n_layers=1",
          "train.batch_size=31", "train.test_step=1", "train.save_model=false",
          "train.results_dir=res", "tune.enable=false", "test.batch_size=64")
SETS = {"iclrec": ("model.num_intent_clusters=4",),
        "dcrec_seq": ("model.sim_group_k=2",),
        "maerec": ("model.con_batch=8", "model.num_reco_neg=4", "model.num_mask_cand=5",
                   "model.mask_steps=2", "model.num_trm_layers=1", "train.save_state_every=1")}
GRAPHS = {"dcrec_seq": {"adj", "sim", "adj_test", "sim_test"}, "maerec": {"graph"}}


def _argv(root, model, *sets):
    return ["--model", model, "--data_dir", str(root), "--dataset", "toy", "--device", "cpu",
            "--epoch", str(EPOCHS),
            *[a for s in (*COMMON, *SETS.get(model, ()), *sets) for a in ("--set", s)]]


def _mesh(data, model):
    return (f"train.mesh.data={data}", f"train.mesh.model={model}")


def _in(cwd, fn, *args):
    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


def _spawn(cwd, argvs, world, probe):
    ranks = _in(cwd, launch.spawn, checks.run,
                ([("cli", "cli_runs", {"argvs": argvs, "probe": probe})],), world)
    return [launch.MeshRun([x["cli"]["runs"][k] for x in ranks]) for k in range(len(argvs))]


def _states(cwd):
    """MAERec's train states written in ``cwd``, oldest first (one an epoch)."""
    d = cwd / "checkpoint_torch" / "maerec"
    return sorted((p for p in d.iterdir() if p.name.endswith(".ckpt.state")),
                  key=lambda p: p.stat().st_mtime_ns)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each model's single run, its {2, 2} and {1, 2} ``launch.MeshRun``;
    MAERec's mesh run resumed from the single run's state after epoch 0, and
    its single run resumed from the mesh run's."""
    root = tmp_path_factory.mktemp("mesh_seq_cli")
    write_seq_dir(root, n_users=53, n_items=37, seed=2)
    single = {m: _in(root / "single", tmain.main, _argv(root, m)) for m in MODELS}
    single_state = _states(root / "single")[0]
    argvs = [_argv(root, m, *_mesh(2, 2)) for m in MODELS]
    argvs.append(_argv(root, "maerec", *_mesh(2, 2), f"train.resume_path={single_state}"))
    mesh = _spawn(root / "mesh", argvs, 4, [True] * len(MODELS) + [False])
    mesh_state = _states(root / "mesh")[0]
    _in(root / "resume1", tmain.main, _argv(root, "maerec", f"train.resume_path={mesh_state}"))
    alike = _spawn(root / "alike", [_argv(root, m, *_mesh(1, 2)) for m in MODELS], 2, False)
    after = [_states(root / "single")[1], _states(root / "mesh")[-1],
             _states(root / "resume1")[-1]]
    return {"single": single, "mesh": dict(zip(MODELS, mesh)), "on_mesh": mesh[-1],
            "alike": dict(zip(MODELS, alike)), "states": (single_state, mesh_state),
            "after": after}


@pytest.mark.parametrize("model", MODELS)
def test_mesh_run_equals_single(runs, model):
    got, want = runs["mesh"][model], runs["single"][model]
    assert got.mesh == {"data": 2, "model": 2}
    assert set(got.best_state) == set(want.best_state)
    for k, v in want.best_state.items():
        np.testing.assert_allclose(got.best_state[k].numpy(), v.numpy(), **cs.MESH_PARAM_TOL,
                                   err_msg=f"{model}: {k}")
    for m, v in want.test_results.items():
        np.testing.assert_allclose(got.test_results[m], v, **cs.MESH_METRIC_TOL,
                                   err_msg=f"{model}: {m}")
    assert len(got.epochs) == EPOCHS
    rtol = cs.MESH_METRIC_TOL["rtol"]
    for a, b in zip(want.recorder.epochs, got.epochs):
        assert set(a["loss"]) == set(b["loss"])
        for term, v in a["loss"].items():
            np.testing.assert_allclose(b["loss"][term], v, rtol=rtol,
                                       atol=rtol * abs(a["loss"]["loss"]),
                                       err_msg=f"{model}: {term}")
    for r in got.ranks:     # every parameter whole in every rank
        assert r["local_shapes"] == {k: tuple(v.shape) for k, v in want.best_state.items()}


@pytest.mark.parametrize("model", MODELS)
def test_mesh_launches_by_layout(runs, model):
    """Each rank's B1 calls by layout (every layout a whole item graph's)
    against ``chip_smoke.MESH_SEQ``, with ``EPOCHS + 2`` evaluations (one an
    epoch, the best on valid, the test) and MAERec's mask steps and views
    (one every ``mask_steps`` steps)."""
    single, got = runs["single"][model], runs["mesh"][model]
    tm = single.model
    views = EPOCHS * -(-single.n_batches // getattr(tm, "mask_steps", 1))
    want = cs.mesh_table_want(cs.MESH_SEQ, model, single.n_batches * EPOCHS, EPOCHS + 2,
                              EPOCHS, views=views, mask=views)
    assert cs.mesh_kg_launches(got, tm.user_num, tm.item_num) == [want] * 4
    assert bool(want) == (model in GRAPHS)


@pytest.mark.parametrize("model", MODELS)
def test_layout_probe_in_each_rank(runs, model):
    """``checks.layout_probe`` after each run, the kernel check phase 37(h)
    makes in its ranks: B1 on each whole item graph's layouts the model holds
    (``checks.whole_layouts``, DCRec_seq's behind ``ItemGraph.g``), with and
    without values, at the model's embedding size (on the CPU the kernel's
    call is its plain version, so the errors are 0); no graph for the four
    without one, and no B2."""
    for r in runs["mesh"][model].ranks:
        probe = r["probe"]
        assert {k.split(":")[0] for k in probe["b1"]} == GRAPHS.get(model, set())
        assert all(v == 0.0 for v in probe["b1"].values()) and probe["b2"] == {}


@pytest.mark.parametrize("model", MODELS)
def test_alike_on_a_model_axis(runs, model):
    """On {1, 2} every rank computes the single run's terms whole: the tables
    and the loss terms equal the single run's bit for bit."""
    got, want = runs["alike"][model], runs["single"][model]
    assert got.mesh == {"data": 1, "model": 2}
    for k, v in want.best_state.items():
        assert torch.equal(got.best_state[k], v), f"{model}: {k}"
    for a, b in zip(want.recorder.epochs, got.epochs):
        assert b["loss"] == a["loss"], model


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)["payload"]


def test_maerec_train_state_moves_between_mesh_and_single(runs):
    """MAERec's train state after epoch 0, written by the mesh run (rank 0)
    and by the single run: the same loss history; the mesh run's resumed on
    one device and the single run's on the {2, 2} mesh write after epoch 1
    the uninterrupted single run's state (tables within ``MESH_PARAM_TOL``,
    the Adam moments within its rtol and an atol of 1e-5 of the largest
    moment of the kind, the loss history within ``MESH_METRIC_TOL``)."""
    single_state, mesh_state = (_payload(p) for p in runs["states"])
    for state in (single_state, mesh_state):
        assert state["epoch"] == 0 and state["extra"]["hist_len"] == 3
    np.testing.assert_allclose(mesh_state["extra"]["loss_hist"].numpy(),
                               single_state["extra"]["loss_hist"].numpy(),
                               **cs.MESH_METRIC_TOL)
    assert runs["on_mesh"].mesh == {"data": 2, "model": 2}
    assert [r["epoch"] for r in runs["on_mesh"].epochs] == [1]
    want, *resumed = (_payload(p) for p in runs["after"])
    for got in resumed:
        assert got["epoch"] == 1 and got["extra"]["hist_len"] == want["extra"]["hist_len"]
        np.testing.assert_allclose(got["extra"]["loss_hist"].numpy(),
                                   want["extra"]["loss_hist"].numpy(), **cs.MESH_METRIC_TOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       **cs.MESH_PARAM_TOL, err_msg=k)
        for opt, per in want["opt_state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                top = max(float(st[k].abs().max()) for st in per.values())
                for i, st in per.items():
                    assert float(got["opt_state"][opt][i]["step"]) == float(st["step"])
                    np.testing.assert_allclose(got["opt_state"][opt][i][k].numpy(),
                                               st[k].numpy(), rtol=cs.MESH_PARAM_TOL["rtol"],
                                               atol=1e-5 * top, err_msg=f"{opt} {i} {k}")
