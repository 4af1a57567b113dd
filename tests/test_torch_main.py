"""The port's CLI end to end on the CPU, and its import isolation from JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sslrec_tpu_torch import main as tmain

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy_split(root, n_users=80, n_items=50, seed=0):
    d = root / "kg" / "toy_kg"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", 6), ("valid", 1), ("test", 2)):
        with open(d / f"{split}.txt", "w") as f:
            for u in range(n_users):
                items = rng.choice(n_items, n, replace=False)
                f.write(" ".join(map(str, [u, *items])) + "\n")


def test_cli_trains_and_writes_artifact_on_cpu(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)     # the logger writes ./log
    res = tmp_path / "res"
    trainer = tmain.main(["--model", "lightgcn", "--data_dir", str(tmp_path),
                          "--dataset", "toy", "--device", "cpu", "--epoch", "2",
                          "--set", "train.test_step=1", "--set", "train.batch_size=128",
                          "--set", f"train.results_dir={res}"])
    doc = json.loads((res / "lightgcn_toy.json").read_text())
    assert "partial" not in doc and doc["device"] == "cpu"
    assert doc["config"]["train"]["device"] == "cpu"
    assert [r["epoch"] for r in doc["trajectory"]] == [0, 1]
    for r in doc["trajectory"]:
        assert np.isfinite(r["loss"]["loss"]) and r["train_examples"] == 512
        assert len(r["valid"]["recall"]) == 3 and r["eval_users"] == 80
    assert len(doc["test"]["recall"]) == 3 and len(doc["best_valid"]["ndcg"]) == 3
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
    assert (tmp_path / "log" / "lightgcn").is_dir()


def test_cli_cuda_without_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--model", "lightgcn", "--data_dir", str(tmp_path),
                    "--dataset", "toy", "--epoch", "1"])
    assert not (tmp_path / "results_torch").exists()


_ISOLATION = """
import importlib, pkgutil, sys
import sslrec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sslrec_tpu_torch.__path__, "sslrec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import chip_compare
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "optax", "flax") or k.startswith(("jax.", "optax.", "flax."))
             or k == "sslrec_tpu" or k.startswith("sslrec_tpu."))
# the modules of the tuner, checkpoints, the social family, KGIN/KGRec, the
# sequential family, DiffKG, the multi-behavior family (CML and KMCLR too),
# the preprocessing CLI, the dispatch trace, the tuner's lanes and the
# device mesh among them
want = {"sslrec_tpu_torch." + m for m in (
    "trainer.tuner", "utils.checkpoint", "utils.summary", "data.social",
    "models.social.dcrec", "models.social.mhcn", "models.social.dsl",
    "models.social.kcgn", "models.social.smin", "models.kg.kgin", "models.kg.kgrec",
    "data.sequential", "models.layers", "models.seq_augment",
    "models.sequential.base_seq", "models.sequential.bert4rec",
    "models.sequential.cl4srec", "models.sequential.duorec", "models.sequential.iclrec",
    "models.sequential.dcrec", "models.sequential.maerec", "models.kg.diffkg",
    "data.multi_behavior", "models.multi_behavior.mbgmn", "models.multi_behavior.hmgcr",
    "models.multi_behavior.smbrec", "models.multi_behavior.cml",
    "models.multi_behavior.kmclr", "tools.preprocess", "utils.dispatch_trace",
    "parallel.mesh", "trainer.lanes", "parallel.dist_train", "parallel.launch",
    "parallel.checks")}
missing = sorted(want - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 80 else 0)   # the package's module count
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
