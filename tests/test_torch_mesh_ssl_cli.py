"""SGL, SimGCL, NCL and DirectAU through the port's CLI on a {data: 2,
model: 2} mesh of gloo processes against their single-device runs (2
epochs on the toy split): the counterparts of JAX's
``test_mesh_parity_cf``.

The four mesh runs share one spawn of four ranks
(``parallel.checks.cli_runs``, each run as the CLI's own spawn runs it).
Every draw is the single run's on every rank (the PRF masks keyed by the
original edge ids, SimGCL's noise and NCL's k-means from the epoch's
generator, over whole tables), so the runs differ only in the order of
float32 sums: parameters within rtol 2e-4 / atol 2e-5, test metrics within
rtol 1e-4 / atol 1e-6, JAX's tolerances, and each epoch's loss within rtol
1e-5.  DirectAU's batch of 127 rows splits 63 / 64 over ``data``, so its
uniformity gathers padded slices; NCL re-clusters every epoch.  Each rank's
B1 calls, counted on the CPU where the card counts launches, equal
``chip_smoke.MESH_B1``'s count by layout, the count phase 37 holds the
card's SGL run to.
"""

import os
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.parallel import checks, launch
from test_torch_main import _toy_split

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

EPOCHS = 2
MODELS = {"sgl": (), "simgcl": (),
          "ncl": ("tune.enable=false", "model.epoch_period=1", "model.cluster_num=8"),
          "directau": ("train.batch_size=127",)}


def _argv(root, model):
    sets = ("train.batch_size=128", "train.test_step=1", "train.results_dir=res",
            *MODELS[model])
    return ["--model", model, "--data_dir", str(root), "--dataset", "toy", "--device", "cpu",
            "--epoch", str(EPOCHS), *[a for s in sets for a in ("--set", s)]]


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
    """Each model's single run and its {2, 2} run."""
    root = tmp_path_factory.mktemp("mesh_ssl_cli")
    _toy_split(root)
    single = {m: _in(root / "single", tmain.main, _argv(root, m)) for m in MODELS}
    mesh = ("train.mesh.data=2", "train.mesh.model=2")
    argvs = [_argv(root, m) + [a for s in mesh for a in ("--set", s)] for m in MODELS]
    ranks = _in(root / "mesh", launch.spawn, checks.run,
                ([("cli", "cli_runs", {"argvs": argvs})],), 4)
    meshes = {m: launch.MeshRun([r["cli"]["runs"][k] for r in ranks])
              for k, m in enumerate(MODELS)}
    return single, meshes


@pytest.mark.parametrize("model", list(MODELS))
def test_mesh_run_equals_single(runs, model):
    single, meshes = runs
    run = meshes[model]
    assert run.mesh == {"data": 2, "model": 2}
    assert [r["local_shapes"] for r in run.ranks] == [
        {"user_embeds": (40, 32), "item_embeds": (25, 32)}] * 4
    for k, v in single[model].best_state.items():
        np.testing.assert_allclose(run.best_state[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{model}: {k}")
    for m, v in single[model].test_results.items():
        np.testing.assert_allclose(run.test_results[m], v, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{model}: {m}")
    assert len(run.epochs) == EPOCHS
    for a, b in zip(single[model].recorder.epochs, run.epochs):
        for term, v in a["loss"].items():
            np.testing.assert_allclose(b["loss"][term], v, rtol=1e-5, err_msg=f"{model}: {term}")


@pytest.mark.parametrize("model", list(MODELS))
def test_mesh_b1_calls_by_layout(runs, model):
    """Each rank's B1 calls by layout (a shard's forward and transposed
    layouts, the whole graph's) against ``chip_smoke.mesh_b1_want``, with
    ``EPOCHS + 2`` evaluations (one an epoch, the best on valid, the test)."""
    single, meshes = runs
    run = meshes[model]
    want = {k: [c, 0] for k, c in
            cs.mesh_b1_want(model, single[model].n_batches * EPOCHS, EPOCHS + 2).items()}
    assert cs.mesh_launches(run, 80, 50) == [want] * 4
    assert all(r["b2_launches"] == 0 for r in run.ranks)
