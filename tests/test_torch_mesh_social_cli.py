"""DcRec, DSL, KCGN, MHCN and SMIN through the port's CLI on device meshes of
gloo processes against their single-device runs (2 epochs on a toy social
split of 51 users × 31 items, ``test_torch_social_data.write_social_dir``).

The five run on {data: 2, model: 2} in one spawn of four ranks
(``parallel.checks.cli_runs``, each run followed by
``checks.layout_probe``).  Every draw is the single run's on every rank
(DcRec's views, MHCN's, KCGN's and SMIN's permutations over whole tables,
DSL's pairs and masks drawn for the whole batch), KCGN's and SMIN's DGI
masks take the whole batch's ids, so the runs differ only in the order of
float32 sums: the whole tables within ``chip_smoke.MESH_PARAM_TOL``, the
test metrics within ``MESH_METRIC_TOL``, each epoch's loss terms within its
rtol, with an atol of that rtol times the epoch's loss.  DSL runs at batch
256, at which its summed BPR's gradient passes the clip (10) in its steps,
so its clip on the mesh takes ``dist_train.global_norm``.  Each rank's B1
calls, counted on the CPU where the card counts launches, equal
``chip_smoke.MESH_SOCIAL``'s count (DcRec's views with added edges as the
single run drew them), all on the whole graphs' and segment layouts.

DcRec, KCGN, MHCN and SMIN also run on {data: 1, model: 2} in a second
spawn of two ranks, as phase 37(g) runs them on the card: there every rank
does the single run's work on the same inputs, the gather is exact and the
two halved cotangents sum exactly, so their tables equal the single run's
bit for bit; a term split over the ``model`` ranks sums in another order
and fails this.  DcRec runs with its GRACE terms weighted 1 (its published
weights, 1e-2 and 1e-3, leave their float sums below the BPR gradient's
last bit, where a GRACE split over the ``model`` ranks passed unseen).
"""

import os
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.parallel import checks, launch
from test_torch_social_data import write_social_dir

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2
COMMON = ("model.embedding_size=8", "train.batch_size=64", "train.test_step=1",
          "train.save_model=false", "train.results_dir=res", "tune.enable=false",
          "test.k=[3,5]", "test.batch_size=64")
MODELS = ("dcrec", "dsl", "kcgn", "mhcn", "smin")
# DSL at a batch whose summed BPR's gradient passes the clip; DcRec with its
# GRACE terms weighted as its BPR, so that their float sums reach the tables
SETS = {"dsl": ("train.batch_size=256",),
        "dcrec": ("model.domain_weight=1.0", "model.cross_weight=1.0")}
ALIKE = ("dcrec", "kcgn", "mhcn", "smin")       # also on {1, 2}, bit-equal
TABLES = {"dcrec": ("ui_user_embeds", "uu_user_embeds", "ui_item_embeds")}


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each model's single run, its {2, 2} ``launch.MeshRun`` and, for
    ``ALIKE``, its {1, 2} one."""
    root = tmp_path_factory.mktemp("mesh_social_cli")
    write_social_dir(root, n_users=51, n_items=31, seed=2)
    single = {m: _in(root / "single", tmain.main, _argv(root, m)) for m in MODELS}
    mesh = _spawn(root / "mesh", [_argv(root, m, *_mesh(2, 2)) for m in MODELS], 4, True)
    alike = _spawn(root / "alike", [_argv(root, m, *_mesh(1, 2)) for m in ALIKE], 2, False)
    return {"single": single, "mesh": dict(zip(MODELS, mesh)), "alike": dict(zip(ALIKE, alike))}


@pytest.mark.parametrize("model", MODELS)
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
    tables = TABLES.get(model, ("user_embeds", "item_embeds"))
    for r in got.ranks:
        assert {k: s[0] for k, s in r["local_shapes"].items() if k in tables} == {
            k: -(-want.best_state[k].shape[0] // 2) for k in tables}


@pytest.mark.parametrize("model", MODELS)
def test_mesh_launches_by_layout(runs, model):
    """Each rank's B1 calls by layout (every layout a whole graph's or a
    segment layout, none a shard's) against ``chip_smoke.MESH_SOCIAL``, with
    ``EPOCHS + 2`` evaluations (one an epoch, the best on valid, the test)
    and DcRec's views with added edges as the single run drew them."""
    single, got = runs["single"][model], runs["mesh"][model]
    tm = single.model
    want = cs.mesh_table_want(cs.MESH_SOCIAL, model, single.n_batches * EPOCHS, EPOCHS + 2,
                              EPOCHS, added=getattr(tm, "added_views", None))
    assert cs.mesh_kg_launches(got, tm.user_num, tm.item_num) == [want] * 4


@pytest.mark.parametrize("model", MODELS)
def test_layout_probe_in_each_rank(runs, model):
    """``checks.layout_probe`` after each run, the kernel check phase 37(g)
    makes in its ranks: B1 on each whole graph's layouts and segment layouts
    the model holds (``checks.whole_layouts``), with and without values (on
    the CPU the kernel's call is its plain version, so the errors are 0),
    and no B2."""
    graphs = {"dcrec": ["adj", "ui", "trust"], "dsl": ["adj", "uu_adj"],
              "mhcn": ["h_s", "h_j", "h_p", "r"],
              "kcgn": ["seg_src", "seg_dst", "uu_g", "ii_g", "uu_sub_adj", "ii_sub_adj",
                       "uu_labels", "ii_labels"],
              "smin": ["user_paths.0", "user_paths.1", "user_paths.2", "item_paths.0",
                       "item_paths.1", "dgi_graph", "sub_adj", "edge_rows", "edge_cols"]}[model]
    for r in runs["mesh"][model].ranks:
        probe = r["probe"]
        names = {k.split(":")[0] for k in probe["b1"]}
        assert names == set(graphs), names
        assert max(probe["b1"].values()) == 0.0 and probe["b2"] == {}


@pytest.mark.parametrize("model", ALIKE)
def test_alike_on_a_model_axis(runs, model):
    """On {1, 2} every rank computes the single run's terms whole: the tables
    equal the single run's bit for bit, and so do the loss terms."""
    got, want = runs["alike"][model], runs["single"][model]
    assert got.mesh == {"data": 1, "model": 2}
    for k, v in want.best_state.items():
        assert torch.equal(got.best_state[k], v), f"{model}: {k}"
    for a, b in zip(want.recorder.epochs, got.epochs):
        for term in ("bpr_loss", "loss"):
            assert b["loss"][term] == a["loss"][term], f"{model}: {term}"
