"""The port's preprocessing CLI (``sslrec_tpu_torch/tools/preprocess.py``)
against the JAX package's on the matrices of ``tests/test_tools.py``:
``build_cooc_kg`` equal triplet for triplet (and to the naive co-count),
the ``kg`` subcommand's file and printed lines and the ``stats``
subcommand's printout equal to JAX's CLI on the same directory."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu.tools.preprocess import build_cooc_kg as jbuild_cooc_kg
from sslrec_tpu_torch.tools import preprocess

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _beh_mats(seed=0):
    rng = np.random.default_rng(seed)
    return {beh: sp.csr_matrix((rng.random((40, 20)) < density).astype(np.float32))
            for beh, density in [("view", 0.25), ("cart", 0.12), ("buy", 0.06)]}


@pytest.mark.parametrize("threshold", [0, 1, 2, 3])
def test_build_cooc_kg_matches_jax(threshold):
    mats = list(_beh_mats().values())
    got = preprocess.build_cooc_kg(mats, threshold=threshold)
    np.testing.assert_array_equal(got, jbuild_cooc_kg(mats, threshold=threshold))
    assert got.dtype == np.int64 and got.shape[1] == 3
    dense = mats[0].toarray()
    expect = {(i, 0, j) for i, j in zip(*np.nonzero(dense.T @ dense > threshold))}
    assert {tuple(t) for t in got[got[:, 1] == 0]} == expect


def test_build_cooc_kg_of_no_matrix():
    assert preprocess.build_cooc_kg([]).shape == (0, 3)


def _cli(package, *args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", f"{package}.tools.preprocess", *args],
                          capture_output=True, text=True, check=True, cwd=cwd,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout


def test_cli_round_trip_equals_jax(tmp_path):
    d = str(tmp_path)
    for beh, m in _beh_mats().items():
        with open(os.path.join(d, f"train_mat_{beh}.pkl"), "wb") as f:
            pickle.dump(m, f)
    outs = {}
    for package, name in (("sslrec_tpu", "kg_jax.txt"), ("sslrec_tpu_torch", "kg_torch.txt")):
        out = _cli(package, "kg", "--dir", d, "--behaviors", "view,cart,buy", "--threshold", "1",
                   "--out", name)
        outs[package] = out.replace(name, "kg.txt")
    assert outs["sslrec_tpu"] == outs["sslrec_tpu_torch"]
    assert "wrote" in outs["sslrec_tpu_torch"] and "relation 2" in outs["sslrec_tpu_torch"]
    with open(os.path.join(d, "kg_jax.txt")) as a, open(os.path.join(d, "kg_torch.txt")) as b:
        assert a.read() == b.read()
    kg = np.loadtxt(os.path.join(d, "kg_torch.txt"), dtype=np.int64, ndmin=2)
    np.testing.assert_array_equal(kg, preprocess.build_cooc_kg(list(_beh_mats().values()), 1))
    with open(os.path.join(d, "extra.tsv"), "w") as f:
        f.write("a\tb\n1\t2\n")
    stats = _cli("sslrec_tpu_torch", "stats", "--dir", d)
    assert stats == _cli("sslrec_tpu", "stats", "--dir", d)
    assert "train_mat_buy.pkl" in stats and "nnz=" in stats and "extra.tsv: 2 rows" in stats
