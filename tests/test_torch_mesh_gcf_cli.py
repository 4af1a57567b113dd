"""DCCF, HCCF, LightGCL, AutoCF, GFormer, AdaGCL and MBGMN through the
port's CLI on a {data: 2, model: 2} mesh of gloo processes against their
single-device runs (2 epochs; the six general_cf models on the toy split of
``test_torch_main.py``, 80 users × 50 items, MBGMN on the Tmall-named split
of ``test_torch_mb_data.write_mb_dir``, 300 × 200).

The mesh runs share one spawn of four ranks (``parallel.checks.cli_runs``,
each run followed by ``checks.layout_probe``), with an eighth: AdaGCL
resumed on the mesh from the single run's train state after epoch 0 (and,
after the spawn, the single run resumed from the mesh run's).  Every draw is
the single run's on every rank (the dropout PRF, HCCF's masks, the view
banks and AdaGCL's noise come from the epoch's generator, over whole
tables; MBGMN draws its hinge's users for the whole batch), so the runs
differ only in the order of float32 sums: the whole tables within
``chip_smoke.MESH_PARAM_TOL``, the test metrics within ``MESH_METRIC_TOL``,
each epoch's loss terms within its rtol, with an atol of that rtol times
the epoch's loss.  Each rank's B1 calls, counted on the CPU where the card
counts launches, equal ``chip_smoke.MESH_GSPMD_A``'s count, all on the
whole graphs' layouts.  AdaGCL's train state holds its three Adams, each
with its own parameters' whole moments, so it moves between a mesh run and
a single run: each resumed run's state after epoch 1 is held to the
uninterrupted run's.  MBGMN drawing its slice's users alone fails these.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.parallel import checks, launch
from test_torch_main import _toy_split
from test_torch_mb_data import write_mb_dir

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2
COMMON = ("train.batch_size=128", "train.test_step=1", "train.save_model=false",
          "train.results_dir=res", "tune.enable=false")
RUNS = {"lightgcl": ("model.embedding_size=16",),
        "hccf": ("model.embedding_size=16", "model.hyper_num=8"),
        "dccf": ("model.embedding_size=16", "model.intent_num=8"),
        "autocf": ("model.embedding_size=16", "model.seed_num=5", "model.fix_steps=2"),
        "gformer": ("model.embedding_size=16", "model.fix_steps=2"),
        "adagcl": ("model.embedding_size=16", "train.save_state_every=1"),
        "mbgmn": ("model.embedding_size=8", "model.sampNum=8", "test.k=[3,5]",
                  "test.batch_size=64")}
MESH = ("train.mesh.data=2", "train.mesh.model=2")


def _argv(root, model, *sets):
    dataset = "tmall" if model == "mbgmn" else "toy"
    return ["--model", model, "--data_dir", str(root), "--dataset", dataset, "--device", "cpu",
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
    """AdaGCL's train states written in ``cwd``, oldest first (one an epoch)."""
    d = cwd / "checkpoint_torch" / "adagcl"
    return sorted((p for p in d.iterdir() if p.name.endswith(".ckpt.state")),
                  key=lambda p: p.stat().st_mtime_ns)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each model's single run and its {2, 2} ``launch.MeshRun``; AdaGCL's
    single run resumed from the mesh run's state after epoch 0, and its mesh
    run resumed from the single run's."""
    root = tmp_path_factory.mktemp("mesh_gcf_cli")
    _toy_split(root)
    write_mb_dir(root)
    single = {m: _in(root / "single", tmain.main, _argv(root, m)) for m in RUNS}
    single_state = _states(root / "single")[0]
    argvs = [_argv(root, m, *MESH) for m in RUNS]
    argvs.append(_argv(root, "adagcl", *MESH, f"train.resume_path={single_state}"))
    ranks = _in(root / "mesh", launch.spawn, checks.run,
                ([("cli", "cli_runs", {"argvs": argvs, "probe": True})],), 4)
    meshes = [launch.MeshRun([x["cli"]["runs"][k] for x in ranks]) for k in range(len(argvs))]
    mesh_state = _states(root / "mesh")[0]
    _in(root / "resume1", tmain.main, _argv(root, "adagcl", f"train.resume_path={mesh_state}"))
    after = [_states(root / "single")[1], _states(root / "mesh")[-1],
             _states(root / "resume1")[-1]]
    return {"single": single, "mesh": dict(zip(RUNS, meshes)), "on_mesh": meshes[-1],
            "states": (single_state, mesh_state), "after": after}


@pytest.mark.parametrize("model", list(RUNS))
def test_mesh_run_equals_single(runs, model):
    got, want = runs["mesh"][model], runs["single"][model]
    assert got.mesh == {"data": 2, "model": 2}
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
    tables = {"u_embed", "i_embed"} if model == "mbgmn" else {"user_embeds", "item_embeds"}
    for r in got.ranks:
        assert {k: s[0] for k, s in r["local_shapes"].items() if k in tables} == {
            k: want.best_state[k].shape[0] // 2 for k in tables}


@pytest.mark.parametrize("model", list(RUNS))
def test_mesh_launches_by_layout(runs, model):
    """Each rank's B1 calls by layout (every layout the whole graph's, none a
    shard's) against ``chip_smoke.MESH_GSPMD_A``, with ``EPOCHS + 2``
    evaluations (one an epoch, the best on valid, the test) and AutoCF's and
    GFormer's views (one every ``fix_steps`` steps)."""
    single, got = runs["single"][model], runs["mesh"][model]
    tm = single.model
    views = EPOCHS * -(-single.n_batches // getattr(tm, "fix_steps", 1))
    want = cs.mesh_table_want(cs.MESH_GSPMD_A, model, single.n_batches * EPOCHS, EPOCHS + 2,
                              EPOCHS, views=views)
    assert cs.mesh_kg_launches(got, tm.user_num, tm.item_num) == [want] * 4


@pytest.mark.parametrize("model", list(RUNS))
def test_layout_probe_in_each_rank(runs, model):
    """``checks.layout_probe`` after each run, the kernel check phase 37(f)
    makes in its ranks: B1 on each whole graph's layouts the model holds
    (``checks.whole_layouts``), with and without values (on the CPU the
    kernel's call is its plain version, so the errors are 0), and no B2."""
    graphs = {"lightgcl": ["adj"], "hccf": ["adj"], "dccf": ["plain_adj", "norm_adj"],
              "autocf": ["adj"], "gformer": ["adj"], "adagcl": ["adj"],
              "mbgmn": [f"graphs.{b}.{d}" for b in range(4) for d in (0, 1)]}[model]
    for r in runs["mesh"][model].ranks:
        probe = r["probe"]
        names = {k.split(":")[0] for k in probe["b1"]}
        assert names == set(graphs), names
        assert max(probe["b1"].values()) == 0.0 and probe["b2"] == {}


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)["payload"]


def test_adagcl_train_state_moves_between_mesh_and_single(runs):
    """AdaGCL's train state after epoch 0, written by the mesh run (rank 0:
    whole tables, and its three Adams, ``rec``'s moments of the tables whole
    and ``vgae``'s and ``dn``'s of their layers), resumed on one device, and
    the single run's resumed on the {2, 2} mesh: the states each writes
    after epoch 1 equal the uninterrupted single run's (the tables and
    layers within ``MESH_PARAM_TOL``, the moments within its rtol and an atol
    of 1e-5 of the optimizer's largest moment of the kind)."""
    single = runs["single"]["adagcl"]
    n_u, n_i = single.data.user_num, single.data.item_num
    for path in runs["states"]:
        state = _payload(path)
        assert state["epoch"] == 0 and set(state["opt_state"]) == {"rec", "vgae", "dn"}
        rec = state["opt_state"]["rec"]
        assert tuple(rec[0]["exp_avg"].shape) == (n_u, 16)
        assert tuple(rec[1]["exp_avg_sq"].shape) == (n_i, 16)
        for part in ("vgae", "dn"):
            assert sorted(tuple(st["exp_avg"].shape) for st in state["opt_state"][part].values()
                          ) == sorted(tuple(p.shape) for p in getattr(single.model, part)
                                      .parameters())
        assert tuple(state["params"]["user_embeds"].shape) == (n_u, 16)
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
