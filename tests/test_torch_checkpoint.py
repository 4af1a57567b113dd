"""The port's checkpoints: the file round trip with every name, shape and
dtype checked against a template, a JAX (flax msgpack) file refused, resume
bit-equal on the CPU (4 epochs straight against 2 and a resumed 2, for
LightGCN, for AdaGCL with its three Adams, and for MAERec with its Adam and
the loss history its reward reads), ``save_model`` under
``checkpoint_torch/``, the test-from-checkpoint mode, and the CSV scalar
writer of ``train.tensorboard``."""

import glob
import os

import numpy as np
import pytest
import torch
from flax import serialization

from sslrec_tpu_torch import main as tmain
from sslrec_tpu_torch.utils import checkpoint as ckpt
from test_torch_main import _toy_split
from test_torch_seq_cli import PER_MODEL as SEQ_PER_MODEL, SMALL as SEQ_SMALL
from test_torch_seq_data import write_seq_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


def _argv(root, model, *more):
    return ["--model", model, "--data_dir", str(root), "--dataset", "toy", "--device", "cpu",
            "--set", "train.test_step=1", "--set", "train.batch_size=128",
            "--set", "model.embedding_size=8", "--set", "train.early_stop=false",
            "--set", f"train.results_dir={root / 'res'}", *more]


def test_round_trip_and_mismatches(tmp_path):
    state = {"params": {"a": torch.randn(3, 4), "b": torch.arange(5)},
             "opt": {0: {"step": torch.tensor(2.0), "m": torch.randn(3, 4)}},
             "epoch": 7, "best_metric": 0.25}
    path = str(tmp_path / "x.ckpt")
    ckpt.save(path, state)
    got = ckpt.load(path, state)
    assert got["epoch"] == 7 and got["best_metric"] == 0.25
    assert torch.equal(got["params"]["a"], state["params"]["a"])
    assert torch.equal(got["opt"][0]["m"], state["opt"][0]["m"])
    bad = [({**state, "params": {"a": torch.randn(3, 4), "c": torch.arange(5)}}, "names"),
           ({**state, "params": {"a": torch.randn(4, 3), "b": torch.arange(5)}}, r"\(4, 3\)"),
           ({**state, "params": {"a": torch.randn(3, 4), "b": torch.zeros(5)}}, "float32"),
           ({**state, "epoch": 7.0}, "want float"),
           ({**state, "extra": 1}, "unexpected")]
    for template, match in bad:
        with pytest.raises(ValueError, match=match):
            ckpt.load(path, template)
    partial = {**state, "opt": ckpt.Partial({0: state["opt"][0], 1: state["opt"][0]})}
    assert ckpt.load(path, partial)["epoch"] == 7       # a subset is allowed there only


def test_jax_checkpoint_is_refused(tmp_path):
    path = tmp_path / "jax.ckpt"
    path.write_bytes(serialization.to_bytes({"user_embeds": np.zeros((3, 2), np.float32)}))
    with pytest.raises(ValueError, match="flax msgpack"):
        ckpt.load(str(path), {"user_embeds": torch.zeros(3, 2)})


@pytest.mark.parametrize("model", ["lightgcn", "adagcl", "maerec"])
def test_resume_is_bit_equal(model, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    every = ["--set", "train.save_state_every=2"]
    if model == "maerec":       # a sequential split, MAERec at a small width
        write_seq_dir(tmp_path)
        every += [*SEQ_SMALL, *SEQ_PER_MODEL["maerec"], "--set", "train.batch_size=64"]
    else:
        _toy_split(tmp_path)
    straight = tmain.main(_argv(tmp_path, model, "--epoch", "4", *every))
    first = tmain.main(_argv(tmp_path, model, "--epoch", "2", *every))
    resumed = tmain.main(_argv(tmp_path, model, "--epoch", "4", *every,
                               "--set", f"train.resume_path={first.state_path}"))
    paths = {straight.state_path, first.state_path, resumed.state_path}
    assert len(paths) == 3 and all(p.startswith(f"checkpoint_torch/{model}/") and
                                   p.endswith(".ckpt.state") for p in paths)
    template = straight._state_template()
    a, b = ckpt.load(straight.state_path, template), ckpt.load(resumed.state_path, template)
    assert a["epoch"] == b["epoch"] == 3 and ckpt.load(first.state_path, template)["epoch"] == 1
    assert (a["best_metric"], a["wait"]) == (b["best_metric"], b["wait"])
    for part in ("params", "best_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{part}.{k}"
    if model == "maerec":
        assert a["extra"]["hist_len"] == b["extra"]["hist_len"] == 3
        assert torch.equal(a["extra"]["loss_hist"], b["extra"]["loss_hist"])
    else:
        assert "extra" not in a
    names = set(a["opt_state"])
    assert names == ({"rec", "vgae", "dn"} if model == "adagcl" else {"adam"})
    for name in names:
        sa, sb = a["opt_state"][name], b["opt_state"][name]
        assert set(sa) == set(sb) and sa
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), f"{name}[{i}].{k}"
    for k, v in straight.test_results.items():
        np.testing.assert_array_equal(v, resumed.test_results[k])
    assert [r["loss"] for r in straight.recorder.epochs[2:]] == \
        [r["loss"] for r in resumed.recorder.epochs]
    assert [r["epoch"] for r in resumed.recorder.epochs] == [2, 3]


def test_save_model_and_test_from_checkpoint(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    trained = tmain.main(_argv(tmp_path, "lightgcn", "--epoch", "2",
                               "--set", "train.save_model=true"))
    path = trained.ckpt_path
    assert path.startswith("checkpoint_torch/lightgcn/lightgcn-toy-") and path.endswith(".ckpt")
    assert glob.glob("checkpoint_torch/lightgcn/*.ckpt") == [path]
    os.rename(tmp_path / "res", tmp_path / "trained")
    tested = tmain.main(_argv(tmp_path, "lightgcn", "--set", f"train.pretrain_path={path}"))
    assert not (tmp_path / "res").exists() and not hasattr(tested, "recorder")
    for k, v in trained.best_state.items():
        assert torch.equal(tested.model.state_dict()[k], v), k
    for k, v in trained.test_results.items():
        np.testing.assert_array_equal(tested.test_results[k], v)


def test_scalar_writer(tmp_path, monkeypatch):
    _toy_split(tmp_path)
    monkeypatch.chdir(tmp_path)
    tmain.main(_argv(tmp_path, "lightgcn", "--epoch", "2", "--set", "train.tensorboard=true"))
    (path,) = glob.glob("runs_torch/scalars_*.csv")
    lines = open(path).read().splitlines()
    assert lines[0] == "tag,step,value,wall_time"
    assert [ln.split(",")[:2] for ln in lines[1:]] == [["Loss/train", "0"], ["HR/test", "0"],
                                                        ["Loss/train", "1"], ["HR/test", "1"]]
