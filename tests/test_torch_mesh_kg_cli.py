"""KGCL (with and without its TransE sub-loop), KGIN, KGRec and DiffKG
through the port's CLI on a {data: 2, model: 2} mesh of gloo processes
against their single-device runs (2 epochs on the tiny KG of
``test_torch_kg_data.write_kg_dir``): the counterparts of JAX's
``test_mesh_parity_kg``.

The five mesh runs share one spawn of four ranks
(``parallel.checks.cli_runs``, each run as the CLI's own spawn runs it,
then ``checks.layout_probe``, the kernel checks phase 37(d) makes in its
ranks).
Every draw is the single run's on every rank (the models' step and epoch
draws come from the epoch's generator over whole tables, the TransE
batches from the KG stream's), so the runs differ only in the order of
float32 sums: the whole tables within rtol 2e-4 / atol 2e-5, test metrics
within rtol 1e-4 / atol 1e-6 (JAX's tolerances), each epoch's loss terms
within rtol 1e-5.  Each rank's B1 calls by layout and B2 calls, counted on
the CPU where the card counts launches, equal ``chip_smoke.MESH_KG``'s
count, the table phase 37(d) holds the card's runs to.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.parallel import checks, launch
from test_torch_kg_data import write_kg_dir

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2
SMALL = ("model.embedding_size=8", "model.triplet_num=5", "train.batch_size=32",
         "test.k=[3,5]", "test.batch_size=16", "train.test_step=1", "train.results_dir=res")
RUNS = {"kgcl": ("kgcl", ()),
        "kgcl_trans": ("kgcl", ("model.train_trans=true", "train.kg_batch_size=32")),
        "kgin": ("kgin", ()),
        "kgrec": ("kgrec", ("model.mae_msize=16",)),
        "diffkg": ("diffkg", ("model.dims_list=[16]", "model.d_emb_size=4"))}


def _argv(root, run):
    model, sets = RUNS[run]
    return ["--model", model, "--data_dir", str(root), "--dataset", "toy", "--device", "cpu",
            "--epoch", str(EPOCHS), *[a for s in (*SMALL, *sets) for a in ("--set", s)]]


def _in(cwd, fn, *args):
    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run's single-device trainer and its {2, 2} ``launch.MeshRun``."""
    root = tmp_path_factory.mktemp("mesh_kg_cli")
    write_kg_dir(root)
    single = {r: _in(root / "single", tmain.main, _argv(root, r)) for r in RUNS}
    mesh = ("train.mesh.data=2", "train.mesh.model=2")
    argvs = [_argv(root, r) + [a for s in mesh for a in ("--set", s)] for r in RUNS]
    ranks = _in(root / "mesh", launch.spawn, checks.run,
                ([("cli", "cli_runs", {"argvs": argvs, "probe": True})],), 4)
    meshes = {r: launch.MeshRun([x["cli"]["runs"][k] for x in ranks])
              for k, r in enumerate(RUNS)}
    return single, meshes


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_run_equals_single(runs, run):
    single, meshes = runs
    got, want = meshes[run], single[run]
    assert got.mesh == {"data": 2, "model": 2}
    for k, v in want.best_state.items():
        np.testing.assert_allclose(got.best_state[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{run}: {k}")
    for m, v in want.test_results.items():
        np.testing.assert_allclose(got.test_results[m], v, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{run}: {m}")
    assert len(got.epochs) == EPOCHS
    for a, b in zip(want.recorder.epochs, got.epochs):
        assert set(a["loss"]) == set(b["loss"])
        for term, v in a["loss"].items():
            np.testing.assert_allclose(b["loss"][term], v, rtol=1e-5, err_msg=f"{run}: {term}")
    if run == "kgcl_trans":
        assert "kg_loss" in got.epochs[0]["loss"]


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_launches_by_layout(runs, run):
    """Each rank's B1 calls by layout (the partition's shard layouts, every
    other layout "whole") and B2 calls against ``chip_smoke.mesh_kg_want``,
    with ``EPOCHS + 2`` evaluations (one an epoch, the best on valid, the
    test)."""
    single, meshes = runs
    got, model = meshes[run], single[run].model
    n_side = model.n_entities if RUNS[run][0] == "kgin" else model.item_num
    want = cs.mesh_kg_want(RUNS[run][0], single[run].n_batches * EPOCHS, EPOCHS + 2, EPOCHS)
    assert cs.mesh_kg_launches(got, model.user_num, n_side) == [want] * 4
    row = "all_embed" if RUNS[run][0] != "diffkg" else "e_embeds"
    assert all(r["local_shapes"][row][0] < single[run].best_state[row].shape[0]
               for r in got.ranks)


@pytest.mark.parametrize("run", list(RUNS))
def test_layout_probe_in_each_rank(runs, run):
    """``checks.layout_probe`` after each run: B1 on the rank's two shard
    layouts, with and without values (on the CPU the kernel's call is its
    plain version, so the errors are 0), and B2 on the head layouts whose
    softmax it shifts (none for KGIN; DiffKG's capped and denoised KGs)."""
    _, meshes = runs
    b2 = {"kgcl": ["kg_heads"], "kgin": [], "kgrec": ["kg_full_heads"],
          "diffkg": ["dkg_heads", "kg_heads"]}[RUNS[run][0]]
    for r in meshes[run].ranks:
        probe = r["probe"]
        assert sorted(probe["b1"]) == ["forward", "forward.vals", "transposed",
                                       "transposed.vals"]
        assert max(probe["b1"].values()) == 0.0
        assert sorted(probe["b2"]) == b2 and all(probe["b2"].values())
