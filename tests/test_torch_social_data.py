"""The port's social data handler against the JAX package's
``bundle_from_matrices`` on a tiny synthetic social split (pickles written
to ``tmp_path`` from a numpy seed), for DcRec, MHCN and DSL: every graph as
a dense matrix within 1e-6 (the motif adjacencies, the joint ``R``,
``bi_adj``, ``uu_adj``), and exactly the train arrays, DcRec's raw trust
edges, DSL's wrapped paired stream and edge sets, and the test split.  Also
the shapes of the repo's ``yelp_sub`` split, the absent-file error and the
error for a model the port lacks (SMIN's and KCGN's structures:
``test_torch_social_metapaths.py``)."""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import social as jsocial
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import social as tsocial
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.registry import build_model

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def social_split(n_users=50, n_items=30, seed=0):
    """Train, test and trust matrices (CSR, float32) from a numpy seed: every
    user with a train item, trust edges directed, some reciprocal, no self
    loops, one user without any."""
    rng = np.random.default_rng(seed)

    def mat(r, c, dens):
        return (rng.random((r, c)) < dens).astype(np.float32)

    trn = mat(n_users, n_items, 0.12)
    trn[np.arange(n_users), rng.integers(0, n_items, n_users)] = 1.0
    tst = mat(n_users, n_items, 0.05) * (1 - trn)
    trust = mat(n_users, n_users, 0.1)
    trust = np.maximum(trust, trust.T * (rng.random((n_users, n_users)) < 0.5))
    np.fill_diagonal(trust, 0.0)
    trust[n_users - 1] = trust[:, n_users - 1] = 0.0
    return tuple(sp.csr_matrix(a) for a in (trn, tst, trust))


def write_social_dir(root, name="toy", **kw) -> tuple:
    """The handler's layout, ``<root>/social/<name>/{trn,tst,trust}_mat.pkl``."""
    mats = social_split(**kw)
    d = root / "social" / name
    d.mkdir(parents=True)
    for fname, m in zip(("trn_mat", "tst_mat", "trust_mat"), mats):
        with open(d / f"{fname}.pkl", "wb") as f:
            pickle.dump(m, f)
    return mats


def _dense_t(g):
    out = np.zeros((g.n_rows, g.n_cols), np.float64)
    np.add.at(out, (g.rows.numpy(), g.cols.numpy()), g.vals.numpy().astype(np.float64))
    return out


def _dense_j(g):
    out = np.zeros((g.n_rows, g.n_cols), np.float64)
    np.add.at(out, (np.asarray(g.rows), np.asarray(g.cols)),
              np.asarray(g.vals).astype(np.float64))
    return out


@pytest.mark.parametrize("model", ["dcrec", "mhcn", "dsl"])
def test_handler_matches_jax(model, tmp_path):
    trn, tst, trust = write_social_dir(tmp_path)
    over = {"data.dir": str(tmp_path)}
    tcfg = tload_config(model, dataset="toy", overrides=over)
    tdata = load_data(tcfg)                                       # through the registry
    jdata = jsocial.bundle_from_matrices(jload_config(model, dataset="toy", overrides=over),
                                         trn, tst, trust)
    assert (tdata.user_num, tdata.item_num) == (jdata.user_num, jdata.item_num)
    for name in ("train_users", "train_items"):
        np.testing.assert_array_equal(getattr(tdata, name).numpy(),
                                      np.asarray(getattr(jdata, name)), err_msg=name)
    assert tdata.valid is None and jdata.valid is None
    np.testing.assert_array_equal(tdata.test.test_users.numpy(),
                                  np.asarray(jdata.test.test_users))
    assert tdata.test.n_test_users == jdata.test.n_test_users
    codes = tdata.train_edge_set.codes.numpy()
    np.testing.assert_array_equal(codes, np.asarray(jdata.train_edge_set.codes))
    graphs = {"mhcn": ("mhcn_h_s", "mhcn_h_j", "mhcn_h_p", "mhcn_r"),
              "dcrec": ("bi_adj", "uu_adj"), "dsl": ("bi_adj", "uu_adj")}[model]
    for name in graphs:
        tg, jg = tdata.extras[name], jdata.extras[name]
        want = _dense_j(jg)
        assert want.any(), name
        np.testing.assert_allclose(_dense_t(tg), want, rtol=0, atol=1e-6, err_msg=name)
        # the transposed layout holds the same operator
        np.testing.assert_allclose(_dense_t(tg.t()), want.T, rtol=0, atol=1e-6)
    if model == "dcrec":
        for t_arr, j_arr in zip(tdata.extras["trust_edges"], jdata.extras["trust_edges"]):
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    if model == "dsl":
        ta, ja = tdata.extras["train_arrays"], jdata.extras["train_arrays"]
        assert set(ta) == set(ja) == {"user", "pos", "suser", "spos"}
        for k in ta:
            np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), err_msg=k)
        assert ta["user"].shape[0] == max(trn.nnz, trust.nnz) == tdata.n_train
        np.testing.assert_array_equal(tdata.extras["trust_edge_set"].codes.numpy(),
                                      np.asarray(jdata.extras["trust_edge_set"].codes))
        np.testing.assert_array_equal(tdata.train_users.numpy(), ta["user"].numpy())


def test_motif_builders_match_jax():
    trn, _, trust = social_split(seed=3)
    for t, j in zip(tsocial.build_motif_adjacencies(trust, trn),
                    jsocial.build_motif_adjacencies(trust, trn)):
        np.testing.assert_allclose(t.toarray(), j.toarray(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tsocial.build_joint_adjacency(trn).toarray(),
                               jsocial.build_joint_adjacency(trn.tocoo()).toarray(),
                               rtol=0, atol=1e-12)


def test_yelp_sub_shapes():
    cfg = tload_config("dcrec", dataset="yelp_sub",
                       overrides={"data.dir": os.path.join(REPO, "datasets")})
    data = load_data(cfg)
    assert (data.user_num, data.item_num, data.n_train) == (9000, 29422, 61539)
    assert data.extras["trust_edges"][0].shape[0] == 71564
    assert data.extras["bi_adj"].nnz == 2 * 61539
    assert data.extras["bi_adj"].n_rows == 9000 + 29422


def test_missing_file_and_unported_models_raise(tmp_path):
    write_social_dir(tmp_path)
    os.remove(tmp_path / "social" / "toy" / "tst_mat.pkl")
    cfg = tload_config("dcrec", dataset="toy", overrides={"data.dir": str(tmp_path)})
    with pytest.raises(FileNotFoundError, match="tst_mat.pkl"):
        load_data(cfg)
    # every model is ported; a name the registry lacks raises at build
    trn, tst, trust = social_split()
    cfg = tload_config("dcrec").set_path("model.name", "no_such_model")
    data = tsocial.bundle_from_matrices(cfg, trn, tst, trust)
    with pytest.raises(KeyError, match="no_such_model"):
        build_model(cfg, data)


def test_tensors_land_on_the_device_asked():
    trn, tst, trust = social_split()
    data = tsocial.bundle_from_matrices(tload_config("dsl"), trn, tst, trust, device="cpu")
    assert all(t.device == torch.device("cpu")
               for t in data.extras["train_arrays"].values())
    assert data.extras["bi_adj"].fwd.indptr.device == torch.device("cpu")
