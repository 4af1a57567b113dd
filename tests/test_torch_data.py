"""The port's host-side graph algebra, data loading and negative sampling
against the JAX package.  All of it is integer or scipy work done the same
way in both, so every comparison is exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu import config as jconfig
from sslrec_tpu.data import base as jbase
from sslrec_tpu.data import general_cf as jgcf
from sslrec_tpu.data import sampling as jsampling
from sslrec_tpu.ops import sparse as jsparse
from sslrec_tpu_torch import config as tconfig
from sslrec_tpu_torch.data import base as tbase
from sslrec_tpu_torch.data import general_cf as tgcf
from sslrec_tpu_torch.data import sampling as tsampling
from sslrec_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

ALIBABA = os.path.join(os.path.dirname(__file__), "..", "datasets", "kg",
                       "alibaba-fashion_kg")


def _same_coo(a, b):
    a, b = sp.coo_matrix(a), sp.coo_matrix(b)
    assert a.shape == b.shape
    assert (a != b).nnz == 0


def test_make_bi_adj_and_normalize_match_jax(tiny_ui):
    _same_coo(tsparse.make_bi_adj(tiny_ui, *tiny_ui.shape),
              jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape))
    _same_coo(tsparse.make_bi_adj(tiny_ui, *tiny_ui.shape, self_loop=True),
              jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape, self_loop=True))
    asym = sp.random(30, 30, density=0.1, random_state=np.random.default_rng(0))
    _same_coo(tsparse.normalize_adj_sym(asym), jsparse.normalize_adj_sym(asym))
    bi = jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape)
    jg, tg = jsparse.from_scipy(bi), tsparse.from_scipy(bi)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert (tg.n_rows, tg.n_cols) == (jg.n_rows, jg.n_cols)


@pytest.mark.parametrize("shape", [(60, 40), (50_000, 50_000)],
                         ids=["codes_mode", "csr_mode"])
def test_edge_set_contains_matches_jax(shape):
    rng = np.random.default_rng(1)
    n = 2000
    rows = rng.integers(0, shape[0], n)
    cols = rng.integers(0, shape[1], n)
    if shape[0] < 1000:  # dense enough that random queries hit
        rows, cols = rows % shape[0], cols % shape[1]
    mat = sp.coo_matrix((np.ones(n, np.float32), (rows, cols)), shape=shape)
    jset = jsparse.build_edge_set(mat)
    assert (jset.codes is None) == (shape[0] * shape[1] >= 2**31)
    tset = tsparse.build_edge_set(mat)
    # true pairs, random pairs, and same-row neighbours of true pairs
    qr = np.concatenate([rows, rng.integers(0, shape[0], n), rows])
    qc = np.concatenate([cols, rng.integers(0, shape[1], n), (cols + 1) % shape[1]])
    qr, qc = qr.reshape(3, n), qc.reshape(3, n)
    want = np.asarray(jset.contains(jnp.asarray(qr, jnp.int32), jnp.asarray(qc, jnp.int32)))
    got = tset.contains(torch.from_numpy(qr), torch.from_numpy(qc)).numpy()
    assert got.shape == want.shape and got[0].all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [None, 3], ids=["full", "cut"])
def test_build_padded_rows_matches_jax(tiny_ui, width):
    mat = sp.vstack([tiny_ui.tocsr(), sp.csr_matrix((2, tiny_ui.shape[1]))])  # empty rows
    j = jsparse.build_padded_rows(mat, width)
    t = tsparse.build_padded_rows(mat, width)
    for name in ("cols", "mask", "lengths"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


def test_pad_to_batches_matches_jax():
    for n, b in ((10, 4), (12, 4), (3, 8)):
        np.testing.assert_array_equal(tbase.pad_to_batches(n, b), jbase.pad_to_batches(n, b))


def test_sample_negatives_matches_jax(monkeypatch):
    """The same candidate matrix fed to both samplers picks the same negatives,
    including the fallback for a user who has every item."""
    n_users, n_items, rounds = 30, 12, 6
    rng = np.random.default_rng(2)
    mat = (sp.random(n_users, n_items, density=0.5, random_state=rng) != 0)
    mat = sp.coo_matrix(mat.astype(np.float32).toarray()
                        + np.eye(n_users, n_items, dtype=np.float32))
    dense = (mat.toarray() != 0).astype(np.float32)
    dense[0] = 1.0  # user 0 has every item
    mat = sp.coo_matrix(dense)
    users = np.repeat(np.arange(n_users), 4).astype(np.int32)
    cands = rng.integers(0, n_items, (rounds, users.size)).astype(np.int32)

    def fake_randint(key, shape, low, high, dtype=None):
        assert tuple(shape) == cands.shape and (low, high) == (0, n_items)
        return jnp.asarray(cands)

    monkeypatch.setattr(jsampling.jax.random, "randint", fake_randint)
    want = np.asarray(jsampling.sample_negatives.__wrapped__(
        jax.random.PRNGKey(0), jnp.asarray(users), jsparse.build_edge_set(mat), n_items))
    got = tsampling.pick_negatives(torch.from_numpy(cands), torch.from_numpy(users),
                                   tsparse.build_edge_set(mat)).numpy()
    np.testing.assert_array_equal(got, want)
    ok = dense[users[None, :], cands] == 0
    assert (got[~ok.any(0)] == cands[-1][~ok.any(0)]).all() and (~ok[:, users == 0]).all()
    assert not dense[users, got][ok.any(0)].any()


def test_sample_negatives_draws_in_range():
    mat = sp.coo_matrix(np.eye(5, 7, dtype=np.float32))
    users = torch.arange(5, dtype=torch.int32).repeat(20)
    negs = tsampling.sample_negatives(torch.Generator().manual_seed(0), users,
                                      tsparse.build_edge_set(mat), 7)
    assert negs.dtype == torch.int32 and negs.shape == users.shape
    assert ((negs >= 0) & (negs < 7)).all() and (negs != users).all()


def test_config_matches_jax():
    for model in ("lightgcn",):
        assert tconfig.load_config(model).to_dict() == jconfig.load_config(model).to_dict()
    argv = ["--model", "lightgcn", "--dataset", "alibaba-fashion", "--epoch", "7",
            "--set", "train.test_step=2", "--set", "model.reg_weight=1e-6",
            "--set", "train.patience=0"]
    t = tconfig.parse_cli(argv + ["--device", "cpu"]).to_dict()
    assert t["train"].pop("device") == "cpu"
    assert t == jconfig.parse_cli(argv).to_dict()
    assert t["model"]["reg_weight"] == 1e-6 and t["train"]["early_stop"] is False


def test_alibaba_split_loads_identically():
    """The repo's alibaba-fashion txt split through both packages' loaders."""
    jmats = jgcf._mats_from_txt(ALIBABA)
    tmats = tgcf._mats_from_txt(ALIBABA)
    for jm, tm in zip(jmats, tmats):
        _same_coo(tm, jm)
    trn, val, tst = tmats
    assert trn.shape == (114_737, 30_040)
    jb = jgcf.bundle_from_matrices(*jmats, use_pallas=False)
    tb = tgcf.bundle_from_matrices(*tmats)
    assert (tb.user_num, tb.item_num, tb.n_train) == (jb.user_num, jb.item_num, jb.n_train)
    np.testing.assert_array_equal(tb.train_users.numpy(), np.asarray(jb.train_users))
    np.testing.assert_array_equal(tb.train_items.numpy(), np.asarray(jb.train_items))
    for tsplit, jsplit in ((tb.valid, jb.valid), (tb.test, jb.test)):
        assert tsplit.n_test_users == jsplit.n_test_users
        np.testing.assert_array_equal(tsplit.test_users.numpy(),
                                      np.asarray(jsplit.test_users))
        for pr in ("ground_truth", "history"):
            for name in ("cols", "mask", "lengths"):
                np.testing.assert_array_equal(
                    getattr(getattr(tsplit, pr), name).numpy(),
                    np.asarray(getattr(getattr(jsplit, pr), name)))
    assert (jb.valid.n_test_users, jb.test.n_test_users) == (34_278, 114_737)
    jadj, tadj = jb.extras["bi_adj"], tb.extras["bi_adj"]
    assert tadj.n_rows == tadj.n_cols == 144_777
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tadj, name).numpy(),
                                      np.asarray(getattr(jadj, name)))
