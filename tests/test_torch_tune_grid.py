"""The port's ``tune.parallel`` grid search against its serial grid search:
the cases of the JAX package's ``tests/test_tuner.py`` (NCL's padded tail
chunk, SimGCL's eps lane, HCCF's structural groups, DCCF's three lane
scalars, the fall-backs without benefit, for a structural-only KGIN grid
and for AutoCF's ``epoch_state``), and HMGCR's and CL4SRec's grids, each
trial's lanes score equal to its serial score within 1e-4 (JAX's own test
allows 5e-3); the structural groups of the shipped grids of the six
multi-behavior and sequential lanes models; a lane's best parameters
against a single run's; and the OOM halving."""

import numpy as np
import pytest
import torch

from conftest import random_ui_matrix
from sslrec_tpu_torch.config import load_config
from sslrec_tpu_torch.data import kg as tkg
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.data import sequential as tseq
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models.registry import build_model, model_class
from sslrec_tpu_torch.trainer import lanes as tlanes
from sslrec_tpu_torch.trainer import tuner
from sslrec_tpu_torch.trainer.trainer import Trainer
from test_torch_kg_data import write_kg_dir
from test_torch_mb_data import mb_split
from test_torch_seq_data import synthetic_seqs

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

SCORE_TOL = 1e-4


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, msg, *a, **k):
        self.lines.append(str(msg))

    def log_loss(self, *a, **k):
        pass

    log_eval = log_loss


def _data(seed):
    return tbundle(random_ui_matrix(seed=seed), random_ui_matrix(density=0.02, seed=seed + 10),
                   random_ui_matrix(density=0.02, seed=seed + 20))


def _scores(lines):
    out = {}
    for ln in lines:
        if ln.startswith("tune trial {") and "->" in ln:
            a, s = ln.split("->")
            out[a.replace("tune trial ", "").strip()] = float(s.split("=")[-1])
    return out


def _both(name, over, data, parallel):
    """The serial and the lanes grid's logs and best results."""
    slog, vlog = _Log(), _Log()
    best_s = tuner.grid_search(load_config(name, overrides=over), data, slog)
    best_v = tuner.grid_search(load_config(name, overrides={**over, "tune.parallel": parallel}),
                               data, vlog)
    return slog, vlog, best_s, best_v


def _same_scores(slog, vlog, n):
    assert not any("falling back" in ln for ln in vlog.lines)
    ser, par = _scores(slog.lines), _scores(vlog.lines)
    assert set(ser) == set(par) and len(ser) == n
    for a in ser:
        assert abs(ser[a] - par[a]) <= SCORE_TOL, (a, ser[a], par[a])
    return ser


BASE = {"train.batch_size": 128, "train.test_step": 1, "test.batch_size": 16,
        "test.k": [5], "model.embedding_size": 8, "optimizer.lr": 1e-2, "tune.enable": True}


def test_ncl_lanes_with_a_padded_tail_chunk():
    over = {**BASE, "train.epoch": 4, "train.patience": 2, "train.early_stop": True,
            "model.cluster_num": 4, "model.epoch_period": 2, "model.layer_num": 2,
            "model.high_order": 1, "tune.hyperparameters": ["temperature", "proto_weight"],
            "tune.temperature": [0.1, 1.0], "tune.proto_weight": [1.0e-6, 1.0e-2]}
    slog, vlog, best_s, best_v = _both("ncl", over, _data(3), 3)
    _same_scores(slog, vlog, 4)
    assert any("4 trials in 1 structural group(s) x 3 lanes" in ln for ln in vlog.lines)
    assert abs(best_s[0] - best_v[0]) <= SCORE_TOL


def test_simgcl_eps_rides_a_lane():
    over = {**BASE, "train.epoch": 3, "train.patience": 2, "model.layer_num": 2,
            "tune.hyperparameters": ["cl_weight", "eps"], "tune.cl_weight": [1.0e-2, 1.0e-1],
            "tune.eps": [0.1, 0.9]}
    slog, vlog, best_s, best_v = _both("simgcl", over, _data(6), 4)
    _same_scores(slog, vlog, 4)
    assert abs(best_s[0] - best_v[0]) <= SCORE_TOL


def test_hccf_structural_groups():
    over = {**BASE, "train.epoch": 3, "model.hyper_num": 8,
            "tune.hyperparameters": ["layer_num", "cl_weight"], "tune.layer_num": [1, 2],
            "tune.cl_weight": [0.01, 1.0]}
    slog, vlog, _, _ = _both("hccf", over, _data(4), 2)
    _same_scores(slog, vlog, 4)
    assert sum("structural group" in ln for ln in vlog.lines) == 1
    assert [ln for ln in vlog.lines if ln.startswith("tune group")] == [
        "tune group {'layer_num': 1}: 2 trials", "tune group {'layer_num': 2}: 2 trials"]


def test_dccf_three_lane_scalars():
    over = {**BASE, "train.epoch": 3, "train.patience": 3, "model.intent_num": 4,
            "tune.hyperparameters": ["layer_num", "cl_weight", "temperature"],
            "tune.layer_num": [1, 2], "tune.cl_weight": [1.0e-3, 1.0e-1],
            "tune.temperature": [0.2]}
    slog, vlog, best_s, best_v = _both("dccf", over, _data(7), 2)
    _same_scores(slog, vlog, 4)
    assert any("2 structural group(s)" in ln for ln in vlog.lines)
    assert abs(best_s[0] - best_v[0]) <= SCORE_TOL


def test_lane_best_parameters_equal_a_single_run():
    """Each lane's best-on-valid parameters against a single run's
    ``best_state`` with its trial's overrides, after early stopping."""
    data = _data(5)
    over = {**BASE, "train.epoch": 5, "train.patience": 1, "train.early_stop": True,
            "model.layer_num": 2}
    cfg = load_config("lightgcn", overrides=over)
    regs = [1e-4, 1e-1, 3.0]
    lanes = tlanes.Lanes(cfg, build_model(cfg, data), data)
    log = _Log()
    scores = lanes.train({"reg_weight": torch.tensor(regs)}, log)
    for i, reg in enumerate(regs):
        tcfg = cfg.replace(model={"reg_weight": reg})
        trainer = Trainer(tcfg.set_path("train.results_dir", ""), build_model(tcfg, data),
                          data, _Log())
        trainer.train()
        assert abs(float(trainer.test_results["recall"][0]) - scores[i]) <= SCORE_TOL
        for n, p in trainer.best_state.items():
            torch.testing.assert_close(lanes.best_params["model." + n][i], p,
                                       rtol=1e-5, atol=1e-6)


def test_falls_back_without_benefit():
    """Every trial its own structural group: the serial loop runs."""
    over = {**BASE, "train.epoch": 2, "tune.parallel": 2,
            "tune.hyperparameters": ["layer_num", "reg_weight"], "tune.layer_num": [1, 2],
            "tune.reg_weight": [1e-7]}
    log = _Log()
    score, _ = tuner.grid_search(load_config("lightgcn", overrides=over), _data(5), log)
    assert np.isfinite(score)
    assert "tune.parallel unsupported for this model/config; falling back to serial " \
           "grid search" in log.lines
    assert not any(ln.startswith("tune: vmapped") for ln in log.lines)


def test_structural_only_kgin_grid_falls_back(tmp_path):
    write_kg_dir(tmp_path)
    over = {"model.embedding_size": 8, "train.batch_size": 32, "test.k": [3],
            "test.batch_size": 8, "train.epoch": 1, "data.dir": str(tmp_path),
            "data.name": "toy", "tune.enable": True, "tune.parallel": 2,
            "tune.hyperparameters": ["layer_num"], "tune.layer_num": [1, 2]}
    cfg = load_config("kgin", overrides=over)
    log = _Log()
    best = tuner.grid_search(cfg, tkg.load(cfg), log)
    assert best is not None and np.isfinite(best[0])
    assert any("falling back" in ln for ln in log.lines)


@pytest.mark.parametrize("name", ["autocf", "gformer"])
def test_autocf_falls_back_for_its_epoch_state(name, monkeypatch):
    """An ``epoch_state`` without an ``epoch_state_fn`` sends the grid to the
    serial loop.  The JAX models have an ``hparams()`` hook and the port's do
    not, so one is stood in here, so that this condition is the one met."""
    cls = model_class(name)
    monkeypatch.setattr(cls, "hparams", lambda self: {"reg_weight": 1e-7}, raising=False)
    over = {**BASE, "train.epoch": 1, "tune.parallel": 2,
            "tune.hyperparameters": ["reg_weight"], "tune.reg_weight": [1e-7, 1e-5]}
    cfg = load_config(name, overrides=over)
    data = _data(5)
    probe = build_model(cfg, data)
    assert tuner.lanes_refusal(probe, cfg) == "an epoch_state without an epoch_state_fn"
    assert tuner.vmapped_grid_search(cfg, data, _Log(), 2) is None
    monkeypatch.setattr(cls, "epoch_state_fn", lambda self, gen: {}, raising=False)
    assert tuner.lanes_refusal(probe, cfg) is None


def _mb_data(name, cfg):
    behaviors, mats, metas, tst = mb_split()
    return tmb.bundle_from_behaviors(cfg, behaviors, mats, tst,
                                     meta_mats=metas if name == "hmgcr" else None)


def test_hmgcr_shipped_grid_shape():
    """HMGCR's shipped 9-trial grid (layer_num x reg_weight): 3 structural
    groups of 3 lanes, each trial's score the serial one; ``reg_weight`` is
    an inert lane, so the trials of a group score alike."""
    over = {**BASE, "train.epoch": 2, "train.batch_size": 1024, "model.hidden_dim": 8,
            "tune.hyperparameters":
            ["layer_num", "reg_weight"], "tune.layer_num": [1, 2, 3],
            "tune.reg_weight": [1.0e-1, 1.0e-2, 1.0e-3]}
    data = _mb_data("hmgcr", load_config("hmgcr", overrides=over))
    slog, vlog, best_s, best_v = _both("hmgcr", over, data, 3)
    ser = _same_scores(slog, vlog, 9)
    assert any("9 trials in 3 structural group(s) x 3 lanes" in ln for ln in vlog.lines)
    for layers in (1, 2, 3):
        group = {s for a, s in ser.items() if f"'layer_num': {layers}," in a}
        assert len(group) == 1, (layers, group)
    assert abs(best_s[0] - best_v[0]) <= SCORE_TOL


def test_cl4srec_dropout_rate_is_structural():
    """CL4SRec's grid with ``dropout_rate`` structural (it sizes the tower's
    dropout calls) and ``lmd`` and ``tau`` on lanes: 2 groups of 4 trials in
    chunks of 3 lanes, the tail chunk padded."""
    over = {**BASE, "train.epoch": 2, "train.batch_size": 16, "model.max_seq_len": 10,
            "model.n_layers": 1, "model.n_heads": 2,
            "tune.hyperparameters": ["dropout_rate", "lmd", "tau"],
            "tune.dropout_rate": [0.1, 0.3], "tune.lmd": [0.05, 0.2], "tune.tau": [0.5, 0.9]}
    data = tseq.bundle_from_seqs(load_config("cl4srec", overrides=over), *synthetic_seqs())
    slog, vlog, best_s, best_v = _both("cl4srec", over, data, 3)
    _same_scores(slog, vlog, 8)
    assert any("8 trials in 2 structural group(s) x 3 lanes" in ln for ln in vlog.lines)
    assert [ln for ln in vlog.lines if ln.startswith("tune group")] == [
        "tune group {'dropout_rate': 0.1}: 4 trials", "tune group {'dropout_rate': 0.3}: 4 trials"]
    assert abs(best_s[0] - best_v[0]) <= SCORE_TOL


# the shipped grids of the six multi-behavior and sequential lanes models:
# the structural groups JAX forms and the trials in each
SHIPPED_GROUPS = {"mbgmn": (3, 3), "hmgcr": (3, 3), "smbrec": (2, 3), "cl4srec": (3, 9),
                  "duorec": (1, 9), "dcrec_seq": (1, 9)}


@pytest.mark.parametrize("name", list(SHIPPED_GROUPS))
def test_shipped_grid_groups(name, tmp_path, monkeypatch):
    """The shipped grid runs as lanes in JAX's structural groups and writes a
    ``"vmapped"`` artifact (each chunk's training stood in for: its trials'
    scores are their order in the grid)."""
    import json
    n_groups, per_group = SHIPPED_GROUPS[name]
    chunks = []

    def run(lanes, chunk, logger):
        chunks.append([a for _, a in chunk])
        return np.arange(len(chunk), dtype=float)

    monkeypatch.setattr(tuner, "_run_vmapped_chunk", run)
    seq = name in ("cl4srec", "duorec", "dcrec_seq")
    small = ({"model.max_seq_len": 10, "model.n_layers": 1, "model.n_heads": 2,
              "model.sim_group_k": 2} if seq else {"model.hidden_dim": 8})
    cfg = load_config(name, overrides={**small, "model.embedding_size": 8, "tune.enable": True,
                                       "tune.parallel": per_group,
                                       "train.results_dir": str(tmp_path)})
    data = tseq.bundle_from_seqs(cfg, *synthetic_seqs()) if seq else _mb_data(name, cfg)
    log = _Log()
    assert tuner.grid_search(cfg, data, log) is not None
    assert any(f"{n_groups * per_group} trials in {n_groups} structural group(s) x "
               f"{per_group} lanes" in ln for ln in log.lines), log.lines
    assert [len(c) for c in chunks] == [per_group] * n_groups
    structural = set(cfg.tune.hyperparameters) - set(build_model(cfg, data).hparams())
    for c in chunks:
        assert len({tuple(a[h] for h in structural) for a in c}) == 1
    doc = json.loads((tmp_path / f"{name}_{cfg.data.name}_tune.json").read_text())
    assert doc["mode"] == "vmapped" and len(doc["trials"]) == n_groups * per_group


def test_out_of_memory_halves_the_lanes(monkeypatch):
    """A chunk that runs out of memory is retried at half the lanes; any
    other error propagates."""
    real = tlanes.Lanes.train
    widths = []

    def train(self, hp, logger):
        k = next(iter(hp.values())).shape[0]
        widths.append(k)
        if k > 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1 GiB")
        return real(self, hp, logger)

    monkeypatch.setattr(tlanes.Lanes, "train", train)
    over = {**BASE, "train.epoch": 1, "tune.hyperparameters": ["reg_weight"],
            "tune.reg_weight": [1e-7, 1e-5, 1e-3, 1e-1]}
    slog, vlog, _, _ = _both("lightgcn", over, _data(8), 4)
    _same_scores(slog, vlog, 4)
    assert widths == [4, 2, 2]
    assert any(ln.startswith("tune chunk failed (CUDA out of memory") and
               ln.endswith("retrying this group at 2 lanes") for ln in vlog.lines)

    def broken(self, hp, logger):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(tlanes.Lanes, "train", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        tuner.grid_search(load_config("lightgcn", overrides={**over, "tune.parallel": 2}),
                          _data(8), _Log())
