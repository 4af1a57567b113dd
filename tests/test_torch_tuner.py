"""The port's serial grid search against the JAX package's tuner: the trial
configs of the shipped grids, per-trial scores equal to single runs with the
same overrides, the tune artifact's fields, the CLI's tune branch (no run
artifact), and ``tune.parallel``'s lanes through the CLI."""

import json

import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.trainer import tuner as jtuner
from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.trainer import tuner as ttuner
from test_torch_main import _toy_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

GRID = ["--set", "tune.enable=true", "--set", "tune.hyperparameters=[layer_num, reg_weight]",
        "--set", "tune.layer_num=[1, 2]", "--set", "tune.reg_weight=[1.0e-7, 1.0e-3]"]


def _argv(root, res, model="lightgcn", *more):
    return ["--model", model, "--data_dir", str(root), "--dataset", "toy", "--device", "cpu",
            "--epoch", "2", "--set", "train.test_step=1", "--set", "train.batch_size=128",
            "--set", "model.embedding_size=8", "--set", f"train.results_dir={res}", *more]


@pytest.mark.parametrize("model", ["ncl", "lightgcn", "dcrec"])
def test_trial_configs_match_jax(model):
    jtrials = list(jtuner.trial_configs(jload_config(model)))
    ttrials = list(ttuner.trial_configs(tload_config(model)))
    assert len(ttrials) == len(jtrials) > 1
    assert [a for _, a in ttrials] == [a for _, a in jtrials]
    for (tcfg, _), (jcfg, _) in zip(ttrials, jtrials):
        assert tcfg.model.to_dict() == jcfg.model.to_dict()
        assert tcfg.tune.to_dict() == jcfg.tune.to_dict()


def test_grid_trials_equal_single_runs(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    best = tmain.main(_argv(tmp_path, tmp_path / "tune", "lightgcn", *GRID))
    doc = json.loads((tmp_path / "tune" / "lightgcn_toy_tune.json").read_text())
    assert sorted(p.name for p in (tmp_path / "tune").iterdir()) == ["lightgcn_toy_tune.json"]
    # the JAX package's fields, from its own writer
    jdoc_path = jtuner._write_grid_artifact(
        jload_config("lightgcn", dataset="toy", overrides={
            "train.results_dir": str(tmp_path / "jax"), "tune.hyperparameters":
            ["layer_num", "reg_weight"], "tune.layer_num": [1, 2],
            "tune.reg_weight": [1e-7, 1e-3]}),
        [(0.5, {"layer_num": 1, "reg_weight": 1e-7})], (0.5, {"layer_num": 1,
                                                            "reg_weight": 1e-7}), "serial")
    jdoc = json.loads(open(jdoc_path).read())
    assert set(doc) == set(jdoc) and doc["mode"] == "serial"
    assert doc["grid"] == {"layer_num": [1, 2], "reg_weight": [1e-7, 1e-3]}
    assigned = [t["assignment"] for t in doc["trials"]]
    assert assigned == [{"layer_num": n, "reg_weight": r} for n in (1, 2) for r in (1e-7, 1e-3)]
    for trial in doc["trials"]:
        a = trial["assignment"]
        single = tmain.main(_argv(tmp_path, tmp_path / "single", "lightgcn",
                                  "--set", f"model.layer_num={a['layer_num']}",
                                  "--set", f"model.reg_weight={a['reg_weight']}"))
        assert float(single.test_results["recall"][0]) == trial["score"], a
    scores = [t["score"] for t in doc["trials"]]
    assert best == (max(scores), doc["trials"][int(np.argmax(scores))]["assignment"])
    assert doc["best"] == {"assignment": best[1], "score": best[0]}


def test_cli_runs_ncl_grid_and_writes_no_run_artifact(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    res = tmp_path / "res"
    score, assignment = tmain.main(_argv(
        tmp_path, res, "ncl", "--set", "tune.hyperparameters=[temperature]",
        "--set", "tune.temperature=[0.1, 0.2]", "--set", "train.epoch=1"))
    assert sorted(p.name for p in res.iterdir()) == ["ncl_toy_tune.json"]
    doc = json.loads((res / "ncl_toy_tune.json").read_text())
    assert [t["assignment"] for t in doc["trials"]] == [{"temperature": 0.1},
                                                        {"temperature": 0.2}]
    assert np.isfinite(score) and assignment in ({"temperature": 0.1}, {"temperature": 0.2})


def test_cli_parallel_lanes_write_a_vmapped_artifact(tmp_path, monkeypatch):
    """``tune.parallel=2`` through the CLI: the grid's two structural groups
    (layer_num) run as two lanes each; the tune artifact says ``vmapped``,
    no run artifact is written, and every trial's score is the serial
    grid's."""
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    best = tmain.main(_argv(tmp_path, tmp_path / "lanes", "lightgcn", *GRID,
                            "--set", "tune.parallel=2"))
    assert sorted(p.name for p in (tmp_path / "lanes").iterdir()) == ["lightgcn_toy_tune.json"]
    doc = json.loads((tmp_path / "lanes" / "lightgcn_toy_tune.json").read_text())
    assert doc["mode"] == "vmapped" and doc["best"] == {"assignment": best[1], "score": best[0]}
    tmain.main(_argv(tmp_path, tmp_path / "serial", "lightgcn", *GRID))
    serial = json.loads((tmp_path / "serial" / "lightgcn_toy_tune.json").read_text())
    assert serial["mode"] == "serial"
    assert [t["assignment"] for t in doc["trials"]] == [t["assignment"] for t in serial["trials"]]
    for got, want in zip(doc["trials"], serial["trials"]):
        assert abs(got["score"] - want["score"]) <= 1e-4, (got, want)
