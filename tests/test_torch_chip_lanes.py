"""``chip_smoke.py``'s lanes rules (phases 35-36), on the CPU: which lanes
score stands for its trial, the B1 counts of phase 36's models against the
serial paths' counts, each lane's scalars from the shipped grids, and phase
36's grids run here on toy splits, where the plain versions stand in for the
kernels and B1's calls are counted.  (The on-card step check,
``lanes_step_check``, is ``tests/test_torch_tune_lanes.py``'s.)"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from sslrec_tpu_torch import main as port_main  # noqa: E402
from sslrec_tpu_torch.data.registry import load_data  # noqa: E402
from sslrec_tpu_torch.models.registry import build_model  # noqa: E402
from test_torch_mb_data import write_mb_dir  # noqa: E402
from test_torch_seq_data import write_seq_dir  # noqa: E402

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


@pytest.mark.parametrize("lanes,want", [
    ({"a": 0.5, "b": 0.4}, True),                 # equal
    ({"a": 0.50004, "b": 0.4}, True),             # a drift well inside half the gap
    ({"a": 0.4, "b": 0.5}, False),                # the lanes swapped the trials
    ({"a": 0.44, "b": 0.4}, False),               # past half the gap
])
def test_lane_is_its_trial(lanes, want):
    serial = {"a": 0.5, "b": 0.4}
    assert all(cs.lane_is_its_trial(t, lanes, serial) for t in serial) is want


def test_lane_is_its_trial_with_tied_trials():
    """Trials of an inert lane score alike: only the tolerance applies."""
    serial = {"a": 0.3, "b": 0.3}
    assert cs.lane_is_its_trial("a", {"a": 0.30001, "b": 0.3}, serial)


@pytest.mark.parametrize("name,layers", [("mbgmn", 2), ("smbrec", 2), ("dcrec_seq", None)])
def test_last_lanes_b1_counts_fold_every_call(name, layers):
    """Every B1 call of these three folds its lanes: a step launches as many
    as a single step (the serial paths' counts, MB_B1 and SEQ_B1), at any K."""
    serial = cs.MB_B1[name] if name in cs.MB_B1 else (cs.SEQ_B1[name][0], cs.SEQ_B1[name][3])
    for k in (1, 2, 4):
        assert cs.LANES_B1[name](layers, k) == serial


@pytest.mark.parametrize("name", list(cs.LAST_LANES))
def test_lane_hp_takes_the_shipped_grid(name):
    cfg = port_main.parse_cli(["--model", name, "--device", "cpu"])
    probe = type("Probe", (), {"hparams": lambda self: _jax_keys(name)})()
    hp = cs.lane_hp(cfg, probe, 2, "cpu")
    for h, v in hp.items():
        want = (list(cfg.tune[h])[:2] if h in cfg.tune.hyperparameters
                else [cfg.model[h]] * 2)
        assert v.dtype == torch.float32 and v.tolist() == pytest.approx(want)


def _jax_keys(name):
    from test_torch_tune_lanes import JAX_HPARAM_KEYS
    return dict.fromkeys(JAX_HPARAM_KEYS[name], 0.0)


@pytest.mark.parametrize("name", list(cs.LAST_LANE_GRIDS))
def test_last_lanes_grids_on_toy_splits(name, tmp_path, monkeypatch):
    """Phase 36's grids (``grids_both_ways``) at the published configs on toy
    splits, through the CLI both ways on the CPU, B1's and B2's calls counted
    where the card counts launches: B1's equal to ``LANES_B1``'s count (which
    ``grids_both_ways`` asserts), none of B2, each lanes score held as on the
    card."""
    from sslrec_tpu_torch.ops import segment_kernel as skn

    def counter(fn):
        def call(*a, **k):
            call.launches += 1
            return fn(*a, **k)
        call.launches = call.combine_launches = 0
        return call

    b1 = counter(cs.sk.csr_spmm)
    monkeypatch.setattr(cs.sk, "csr_spmm", b1)
    monkeypatch.setattr(skn, "csr_spmm", b1)
    monkeypatch.setattr(skn, "segment_max", counter(skn.segment_max))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cs, "SMOKE_RESULTS", str(tmp_path / "smoke"))
    write_mb_dir(tmp_path)
    write_seq_dir(tmp_path, name="toy", n_users=600)
    dataset = "toy" if name == "dcrec_seq" else "tmall"
    spec = {**cs.LAST_LANE_GRIDS[name], "data": (str(tmp_path), dataset)}
    cfg = port_main.parse_cli(["--model", name, "--data_dir", str(tmp_path), "--dataset",
                               dataset, "--device", "cpu"])
    data = load_data(cfg, "cpu")
    n_batches = cs.Lanes(cfg, build_model(cfg, data), data).trainer.n_batches
    grid = cs.grids_both_ways({name: spec}, {name: n_batches}, {name: cs.swap_unit(data)},
                              device="cpu")[name]
    assert grid["lanes"]["launches"] > 0 and grid["lanes"]["b2_launches"] == 0
    assert grid["score_tol"] == (4 / 600 if name == "dcrec_seq" else 0.0)


@pytest.mark.parametrize("weight", ["none", "prf", "tensor"])
def test_fold_check(weight, monkeypatch):
    """Phases 35-36's check of B1 under the lanes' vmap rule, on the CPU with
    the calls counted where the card counts launches: one for a hop of K
    lanes and one for its dx, each lane against the plain version."""
    from conftest import random_ui_matrix
    from sslrec_tpu_torch.ops import segment_kernel as skn
    from sslrec_tpu_torch.ops.sparse import from_scipy
    real = cs.sk.csr_spmm

    def counted(*a, **k):
        counted.launches += 1
        return real(*a, **k)

    counted.launches = 0
    monkeypatch.setattr(cs.sk, "csr_spmm", counted)
    monkeypatch.setattr(skn, "csr_spmm", counted)
    g = cs.sk.build_csr_graph(from_scipy(random_ui_matrix(30, 25, 0.15, seed=4)))
    w = {"none": None, "prf": cs.sk.prf_mask(torch.tensor([7, 11]), g, 0.6),
         "tensor": torch.rand(g.nnz)}[weight]
    errs = cs.ErrTrack()
    cs.fold_check(errs, weight, g, w, 5, 3, torch.Generator().manual_seed(0))
    assert counted.launches == 2 and errs.rel <= 1e-6
