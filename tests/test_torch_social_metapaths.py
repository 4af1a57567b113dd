"""The port's SMIN and KCGN structures against the JAX package's on tiny
seeded inputs: ``normalize_adj_left``; the co-occurrence sampler, exact at
rate 1 (the JAX package's native sampler is then exact too) and, below it,
``floor(deg · rate)`` distinct members of each row's co-occurrence set, at
about uniform frequencies; the one-hop graph and its 2-hop closure, the
component structures and the KCGN structures bit-equal given the JAX
package's metapaths; KCGN's time table and degree norms equal to the JAX
model's; the handler's SMIN and KCGN bundles against JAX's, and its file
fallbacks."""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import social as jsocial
from sslrec_tpu.models.social.kcgn import KCGN as JKCGN
from sslrec_tpu.ops import sparse as jsparse
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import social as tsocial
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.social import kcgn as tkcgn
from sslrec_tpu_torch.ops import sparse as tsparse
from test_torch_social_data import _dense_j, _dense_t, social_split, write_social_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


def _same(a, b, what):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape, what
    assert (a != b).nnz == 0, what


def rated_split(seed=0, ratings=(1.0, 2.0, 4.0)):
    """``social_split`` with ``ratings`` drawn on the train pairs, and train
    times (seconds) on the same pattern."""
    trn, tst, trust = social_split(seed=seed)
    rng = np.random.default_rng(seed + 1)
    trn = trn.tocoo()
    rated = sp.csr_matrix((rng.choice(ratings, trn.nnz), (trn.row, trn.col)),
                          shape=trn.shape)
    times = sp.csr_matrix((rng.integers(10**9, 10**9 + 3600 * 360 * 5, trn.nnz).astype(
        np.float64), (trn.row, trn.col)), shape=trn.shape)
    return rated, tst, trust, times


@pytest.mark.parametrize("eps", [1e-10, 0.0])
def test_normalize_adj_left_matches_jax(eps):
    m = sp.random(12, 9, density=0.3, random_state=np.random.default_rng(1), format="csr")
    m[3] = 0.0                                     # an empty row: 1/0 set to 0 at eps 0
    t, j = tsparse.normalize_adj_left(m, eps), jsparse.normalize_adj_left(m, eps)
    np.testing.assert_array_equal(t.toarray(), j.toarray())


@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_cooc_exact_at_rate_one(seed):
    trn, _, _ = social_split(seed=seed)
    cat = sp.csr_matrix((np.random.default_rng(seed).random((30, 4)) < 0.4).astype(np.float32))
    for mat in (trn, trn.T, cat, trn @ cat):
        t = tsocial._sampled_cooc(mat, 1.0, np.random.default_rng(3))
        j = jsocial._sampled_cooc(mat, 1.0, np.random.default_rng(3))
        _same(t, j, "rate 1")
        m = sp.csr_matrix(mat)
        _same(t, (m @ m.T + sp.eye(m.shape[0])) != 0, "the exact closure")


def _rows_csr(n_rows, width, n_cols, rng):
    """A CSR of rows of sizes 0..width, each a sorted distinct subset of n_cols."""
    sizes = rng.integers(0, width + 1, n_rows)
    sizes[:3] = [0, 1, width]
    indices = np.concatenate([np.sort(rng.choice(n_cols, s, replace=False)) for s in sizes])
    return np.concatenate([[0], np.cumsum(sizes)]), indices.astype(np.int32)


@pytest.mark.parametrize("rate", [0.02, 0.1, 0.3, 0.6])
def test_sampler_draws_floor_of_each_row_distinct(rate):
    """Each row keeps floor(deg · rate) distinct members of its own set; the
    rejection branch (rates 0.02, 0.1) and the key branch (0.3, 0.6) both."""
    rng = np.random.default_rng(int(rate * 100))
    indptr, indices = _rows_csr(400, 300, 1000, rng)
    rows, cols = tsocial.sample_row_subsets(indptr, indices, rate, rng)
    deg = np.diff(indptr)
    want = (deg * rate).astype(np.int64)
    np.testing.assert_array_equal(np.bincount(rows, minlength=deg.size), want)
    for r in range(deg.size):
        got = cols[rows == r]
        assert np.unique(got).size == got.size == want[r]
        assert np.isin(got, indices[indptr[r]:indptr[r + 1]]).all()


@pytest.mark.parametrize("rate,width", [(0.25, 20), (0.05, 200)])
def test_sampler_frequencies_near_uniform(rate, width):
    """Over 2,000 copies of one row, each member is drawn about rate · 2000
    times (within 5 standard deviations of the binomial)."""
    n = 2000
    indptr = np.arange(n + 1) * width
    indices = np.tile(np.arange(width), n).astype(np.int32)
    _, cols = tsocial.sample_row_subsets(indptr, indices, rate, np.random.default_rng(9))
    p = int(width * rate) / width
    counts = np.bincount(cols, minlength=width)
    assert np.abs(counts - n * p).max() < 5 * np.sqrt(n * p * (1 - p))


def test_sampled_cooc_below_rate_one_is_a_closed_subset():
    trn, _, _ = social_split(n_users=200, n_items=120, seed=4)
    m = sp.csr_matrix(trn.T)
    got = tsocial._sampled_cooc(m, 0.25, np.random.default_rng(0))
    full = (m @ m.T + sp.eye(m.shape[0])) != 0
    assert (got > full).nnz == 0                    # within the co-occurrence sets
    _same(got, got.T, "symmetric")
    assert (got.diagonal() == 1).all()
    assert 0 < got.nnz < full.nnz


def _jax_metapaths(seed=0):
    trn, tst, trust = social_split(seed=seed)
    trn_bin = (trn != 0).astype(np.float32).tocoo()
    cat = sp.csr_matrix(np.ones((trn.shape[1], 1), np.float32))
    return trn_bin, trust, cat, jsocial.gen_metapaths(trn_bin, trust, cat)


@pytest.mark.parametrize("k_hop", [2, 3])
def test_ui_subgraph_bit_equal_given_jax_metapaths(k_hop):
    trn_bin, trust, cat, meta = _jax_metapaths()
    _same(tsocial.gen_metapaths(trn_bin, trust, cat)["UU"], meta["UU"], "UU")
    t_one, t_sub = tsocial.gen_ui_subgraph(trn_bin, meta, k_hop)
    j_one, j_sub = jsocial.gen_ui_subgraph(trn_bin, meta, k_hop)
    _same(t_one, j_one, "one hop")
    _same(t_sub, j_sub, "subgraph")
    assert t_sub.nnz > t_one.nnz


def test_component_structs_bit_equal():
    trn_bin, trust, _, meta = _jax_metapaths(seed=2)
    for m in (meta["UU"], meta["IUI"], sp.csr_matrix(trust)):
        for t, j in zip(tsocial.connected_component_structs(m, 3),
                        jsocial.connected_component_structs(m, 3)):
            if sp.issparse(t):
                _same(t, j, "membership")
            else:
                np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("time_step", [360, 24])
def test_kcgn_structs_bit_equal(time_step):
    rated, _, trust, times = rated_split()
    cat = sp.csr_matrix((np.random.default_rng(0).random((30, 3)) < 0.5).astype(np.float32))
    over = {"model.time_step": time_step}
    t = tsocial.build_kcgn_structs(tload_config("kcgn", overrides=over), rated, times, trust, cat)
    j = jsocial.build_kcgn_structs(jload_config("kcgn", overrides=over), rated, times, trust, cat)
    assert set(t) == set(j)
    assert t["rating_class"] == 3 and t["max_time"] > 3
    for k in t:
        if isinstance(t[k], int):
            assert t[k] == j[k], k
        elif sp.issparse(t[k]):
            # the JAX package holds the values in float32 on the device
            np.testing.assert_array_equal(t[k].toarray().astype(np.float32),
                                          _dense_j(j[k]).astype(np.float32), err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], np.asarray(j[k]), err_msg=k)


def test_kcgn_time_table_and_degrees_equal_jax():
    rated, tst, trust, times = rated_split(seed=5)
    jcfg = jload_config("kcgn", overrides={"model.embedding_size": 16})
    jdata = jsocial.bundle_from_matrices(jcfg, rated, tst, trust, trn_time=times)
    jm = JKCGN(jcfg, jdata)
    tab = tkcgn.time_table(jm.max_time, 16)
    assert np.isfinite(tab).all()
    np.testing.assert_array_equal(tab, np.asarray(jm._time_table))
    out_n, in_n = tkcgn.degree_norms(np.asarray(jm.src), np.asarray(jm.dst), jm.n_nodes)
    np.testing.assert_array_equal(out_n, np.asarray(jm._out_n))
    np.testing.assert_array_equal(in_n, np.asarray(jm._in_n))


def test_smin_bundle_matches_jax_given_its_metapaths(monkeypatch):
    trn, tst, trust = social_split()
    monkeypatch.setattr(tsocial, "gen_metapaths", jsocial.gen_metapaths)
    cfg = {"model.embedding_size": 16}
    tdata = tsocial.bundle_from_matrices(tload_config("smin", overrides=cfg), trn, tst, trust)
    jdata = jsocial.bundle_from_matrices(jload_config("smin", overrides=cfg), trn, tst, trust)
    tg, jg = tdata.extras["metapath_graphs"], jdata.extras["metapath_graphs"]
    assert set(tg) == set(jg) == {"UU", "UIU", "UITIU", "ITI", "IUI"}
    for k in tg:
        np.testing.assert_allclose(_dense_t(tg[k]), _dense_j(jg[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in ("dgi_graph", "subgraph_adj"):
        np.testing.assert_allclose(_dense_t(tdata.extras[k]), _dense_j(jdata.extras[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    for t, j in zip(tdata.extras["dgi_edges"], jdata.extras["dgi_edges"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tdata.extras["subgraph_norm"].numpy(),
                                  np.asarray(jdata.extras["subgraph_norm"]))


def test_kcgn_bundle_matches_jax():
    rated, tst, trust, times = rated_split(seed=1)
    tdata = tsocial.bundle_from_matrices(tload_config("kcgn"), rated, tst, trust,
                                         trn_time=times)
    jdata = jsocial.bundle_from_matrices(jload_config("kcgn"), rated, tst, trust,
                                         trn_time=times)
    te, je = tdata.extras, jdata.extras
    for k in ("kcgn_n_nodes", "rating_class", "max_time"):
        assert te[k] == je[k], k
    for k in ("kcgn_src", "kcgn_dst", "kcgn_time", "uu_labels", "ii_labels", "uu_sub_norm",
              "ii_sub_norm", "uu_dgi_mask", "ii_dgi_mask"):
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]), err_msg=k)
    for k in ("uu_dgi_graph", "ii_dgi_graph", "uu_sub_adj", "ii_sub_adj"):
        np.testing.assert_allclose(_dense_t(te[k]), _dense_j(je[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_load_reads_category_and_times_else_falls_back(tmp_path, capsys):
    write_social_dir(tmp_path)
    over = {"data.dir": str(tmp_path)}
    data = load_data(tload_config("kcgn", dataset="toy", overrides=over))
    out = capsys.readouterr().out
    assert "one category holding every item" in out and "unit timestamps" in out
    assert data.extras["max_time"] == 3 and data.extras["rating_class"] == 1
    d = tmp_path / "social" / "toy"
    rated, _, _, times = rated_split()
    cat = sp.csr_matrix((np.random.default_rng(0).random((30, 3)) < 0.5).astype(np.float32))
    for name, m in (("trn_mat", rated), ("trn_time", times), ("category", cat)):
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(m, f)
    data = load_data(tload_config("kcgn", dataset="toy", overrides=over))
    assert "no " not in capsys.readouterr().out
    want = jsocial.build_kcgn_structs(jload_config("kcgn", dataset="toy", overrides=over),
                                      rated, times, sp.csr_matrix(pickle.load(open(
                                          d / "trust_mat.pkl", "rb"))), cat)
    assert data.extras["rating_class"] == 3
    np.testing.assert_array_equal(data.extras["kcgn_time"].numpy(), np.asarray(want["kcgn_time"]))
    np.testing.assert_array_equal(data.extras["ii_labels"].numpy(), np.asarray(want["ii_labels"]))
    assert torch.is_tensor(data.extras["kcgn_src"]) and os.path.exists(d / "category.pkl")
