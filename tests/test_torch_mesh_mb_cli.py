"""HMGCR, SMBRec, CML and KMCLR through the port's CLI on a {data: 2,
model: 2} mesh of gloo processes against their single-device runs (2
epochs on the Tmall-named split of ``test_torch_mb_data.write_mb_dir``,
300 users × 200 items, with CML's meta users and KMCLR's KG beside it):
the counterparts of JAX's ``test_mesh_parity_mb_cml``.

The mesh runs share one spawn of four ranks (``parallel.checks.cli_runs``,
each run followed by ``checks.layout_probe``), with a fifth: CML resumed on
the mesh from the single run's train state after epoch 0 (and, after the
spawn, the single run resumed from the mesh run's).  Every draw is the
single run's on every rank (the models' draws come from the epoch's
generator over the whole batch), so the runs differ only in the order of
float32 sums: the whole tables within
``chip_smoke.MESH_PARAM_TOL``, test metrics within ``MESH_METRIC_TOL``, each
epoch's loss terms within its rtol, with an atol of that rtol times the
epoch's loss: SMBRec's contrast sums terms of either sign to a total
thousands of times smaller than them (``test_torch_mb_models.py``), and a
{2, 1} run, which changes only the order in which the batch's gradient is
summed, moves it by 3.0e-4 of itself by the second epoch on this split
(the {2, 2} run by 2.3e-4; the loss it makes up by 1.9e-6 and 1.4e-6).
Each rank's B1 calls by layout, counted on the CPU where the card counts
launches, equal ``chip_smoke.MESH_MB``'s count.  Train states are whole
tables and whole moments of both of CML's AdamWs, so they move between a
mesh run and a single run: each resumed run's state after epoch 1 is held
to the uninterrupted run's (the best snapshots are not compared there: a
tie of two epochs' valid metrics, which this split has, is broken by the
last bit of the saved best metric).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.parallel import checks, launch
from test_torch_cml import META_FILE, meta_users
from test_torch_kmclr import kg_triplets
from test_torch_mb_data import write_mb_dir

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2
COMMON = ("train.batch_size=256", "test.k=[3,5]", "test.batch_size=64", "train.test_step=1",
          "train.save_model=false", "train.results_dir=res")
RUNS = {"hmgcr": ("model.hidden_dim=8",),
        "smbrec": ("model.embedding_size=8",),
        "cml": ("model.hidden_dim=8", "train.meta_batch=32", "train.SSL_batch=2",
                "train.save_state_every=1"),
        "kmclr": ("model.embedding_size=8", "model.latent_dim_rec=8", "train.SSL_batch=2",
                  "model.bpr_batch_size=900")}
MESH = ("train.mesh.data=2", "train.mesh.model=2")


def _argv(root, model, *sets):
    return ["--model", model, "--data_dir", str(root), "--dataset", "tmall", "--device", "cpu",
            "--epoch", str(EPOCHS),
            *[a for s in (*COMMON, *RUNS[model], *sets) for a in ("--set", s)]]


def _in(cwd, fn, *args):
    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


def _states(cwd):
    """CML's train states written in ``cwd``, oldest first (one an epoch)."""
    d = cwd / "checkpoint_torch" / "cml"
    return sorted((p for p in d.iterdir() if p.name.endswith(".ckpt.state")),
                  key=lambda p: p.stat().st_mtime_ns)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each model's single run and its {2, 2} ``launch.MeshRun``; CML's
    single run resumed from the mesh run's state after epoch 0, and its mesh
    run resumed from the single run's."""
    root = tmp_path_factory.mktemp("mesh_mb_cli")
    d = write_mb_dir(root)
    with open(os.path.join(d, META_FILE), "wb") as f:
        pickle.dump(meta_users().tolist(), f)
    np.savetxt(os.path.join(d, "kg.txt"), kg_triplets(4096), fmt="%d")   # one TransR batch
    single = {m: _in(root / "single", tmain.main, _argv(root, m)) for m in RUNS}
    single_state = _states(root / "single")[0]
    argvs = [_argv(root, m, *MESH) for m in RUNS]
    argvs.append(_argv(root, "cml", *MESH, f"train.resume_path={single_state}"))
    ranks = _in(root / "mesh", launch.spawn, checks.run,
                ([("cli", "cli_runs", {"argvs": argvs, "probe": True})],), 4)
    meshes = [launch.MeshRun([x["cli"]["runs"][k] for x in ranks]) for k in range(len(argvs))]
    mesh_state = _states(root / "mesh")[0]
    _in(root / "resume1", tmain.main, _argv(root, "cml", f"train.resume_path={mesh_state}"))
    # the train states after epoch 1: the single run's, the mesh run resumed
    # from the single run's epoch 0 (the mesh directory's last) and the single
    # run resumed from the mesh run's
    after = [_states(root / "single")[1], _states(root / "mesh")[-1],
             _states(root / "resume1")[-1]]
    return {"single": single, "mesh": dict(zip(RUNS, meshes)), "on_mesh": meshes[-1],
            "states": (single_state, mesh_state), "after": after}


def _held(single, best_state, test_results):
    for k, v in single.best_state.items():
        np.testing.assert_allclose(best_state[k].numpy(), v.numpy(), **cs.MESH_PARAM_TOL,
                                   err_msg=k)
    for m, v in single.test_results.items():
        np.testing.assert_allclose(test_results[m], v, **cs.MESH_METRIC_TOL, err_msg=m)


@pytest.mark.parametrize("model", list(RUNS))
def test_mesh_run_equals_single(runs, model):
    got, want = runs["mesh"][model], runs["single"][model]
    assert got.mesh == {"data": 2, "model": 2}
    _held(want, got.best_state, got.test_results)
    assert len(got.epochs) == EPOCHS
    rtol = cs.MESH_METRIC_TOL["rtol"]
    for a, b in zip(want.recorder.epochs, got.epochs):
        assert set(a["loss"]) == set(b["loss"])
        for term, v in a["loss"].items():
            np.testing.assert_allclose(b["loss"][term], v, rtol=rtol,
                                       atol=rtol * abs(a["loss"]["loss"]),
                                       err_msg=f"{model}: {term}")
    shards = want.model.row_shards if hasattr(want.model, "row_shards") else {}
    assert not shards       # one device: nothing sharded
    for r in got.ranks:
        for k, shape in r["local_shapes"].items():
            if k.endswith(("user_emb", "item_emb", "kg.user")) or ".item." in k \
                    or ".entity." in k:
                assert shape[0] < want.best_state[k].shape[0], (k, shape)


@pytest.mark.parametrize("model", list(RUNS))
def test_mesh_launches_by_layout(runs, model):
    """Each rank's B1 calls by layout (the partition's shard layouts of the
    [users; items] node space, every other layout "whole") against
    ``chip_smoke.MESH_MB``, with ``EPOCHS + 2`` evaluations (one an epoch,
    the best on valid, the test)."""
    single, got = runs["single"][model], runs["mesh"][model]
    tm = single.model
    want = cs.mesh_table_want(cs.MESH_MB, model, single.n_batches * EPOCHS, EPOCHS + 2, EPOCHS,
                              getattr(tm, "n_bpr", 0) * EPOCHS)
    assert cs.mesh_kg_launches(got, tm.user_num, tm.item_num) == [want] * 4


@pytest.mark.parametrize("model", list(RUNS))
def test_layout_probe_in_each_rank(runs, model):
    """``checks.layout_probe`` after each run, the kernel check phase 37(e)
    makes in its ranks: B1 on the rank's two shard layouts of every graph
    the model partitions (HMGCR's 4 towers' A and AT, SMBRec's 4 behaviors'
    A and AT, CML's 4 behaviors' bidirectional hops, and KMCLR's with its buy
    bi-adjacency), with and without values (on the CPU the kernel's call is
    its plain version, so the errors are 0), and no B2."""
    graphs = {"hmgcr": [f"t{t}.{d}" for t in range(4) for d in ("a", "at")],
              "smbrec": [f"t{t}.{d}" for t in range(4) for d in ("a", "at")],
              "cml": [f"beh{b}" for b in range(4)],
              "kmclr": [f"beh{b}" for b in range(4)] + ["buy"]}[model]
    layouts = [f"{lay}{tag}" for lay in ("forward", "transposed") for tag in ("", ".vals")]
    for r in runs["mesh"][model].ranks:
        probe = r["probe"]
        assert sorted(probe["b1"]) == sorted(f"{g}:{lay}" for g in graphs for lay in layouts)
        assert max(probe["b1"].values()) == 0.0 and probe["b2"] == {}


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)["payload"]


def test_cml_train_state_moves_between_mesh_and_single(runs):
    """CML's train state after epoch 0, written by the mesh run (rank 0, whole
    tables and both AdamWs' whole moments), resumed on one device, and the
    single run's resumed on the {2, 2} mesh: the states each writes after
    epoch 1 (tables and both AdamWs' moments and steps) equal the
    uninterrupted single run's (the tables within ``MESH_PARAM_TOL``, the
    moments within its rtol and an atol of 1e-5 of the optimizer's largest
    moment of the kind: a bias's gradient sums the batch's terms of either
    sign)."""
    single = runs["single"]["cml"]
    for path in runs["states"]:
        state = _payload(path)
        assert state["epoch"] == 0 and set(state["opt_state"]) == {"model", "meta"}
        for opt in state["opt_state"].values():
            assert tuple(opt[0]["exp_avg"].shape) == (single.data.user_num, 8)   # gcn.user_emb
            assert tuple(opt[1]["exp_avg_sq"].shape) == (single.data.item_num, 8)
        assert tuple(state["params"]["gcn.user_emb"].shape) == (single.data.user_num, 8)
    assert runs["on_mesh"].mesh == {"data": 2, "model": 2}
    assert [r["epoch"] for r in runs["on_mesh"].epochs] == [1]
    want, *resumed = (_payload(p) for p in runs["after"])
    for got in resumed:
        assert got["epoch"] == 1
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
