"""The multi-behavior handler's extras for CML and KMCLR and the plain MF view
(``multi_behavior_mf``) against the JAX package's loaders on written
directories: CML's meta users read from
``meta_multi_single_beh_user_index_shuffle`` (a missing file raises in both,
and a bundle built without them falls back to every user), KMCLR's triplets
from ``kg.txt`` where it is there (and a model built without them on the
one-triplet placeholder, as JAX's), and ``load_mf`` with
``tests/test_tools.py::test_load_mf_variant``'s expectations."""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu.data.registry import load_data as jload_data
from sslrec_tpu.models.registry import build_model as jbuild_model
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.data.registry import load_data
from sslrec_tpu_torch.models.registry import build_model
from test_torch_mb_data import N_USERS, mb_split, write_mb_dir

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

META_FILE = "meta_multi_single_beh_user_index_shuffle"


def _cfgs(name, root, **over):
    over = {"data.dir": str(root), "data.name": "tmall", **over}
    return jload_config(name, overrides=over), tload_config(name, overrides=over)


def test_cml_meta_users_read_as_jax(tmp_path):
    d = write_mb_dir(tmp_path)
    jcfg, tcfg = _cfgs("cml", tmp_path)
    for cfg, load in ((jcfg, jmb.load), (tcfg, load_data)):
        with pytest.raises(FileNotFoundError, match=META_FILE):
            load(cfg)
    users = np.random.default_rng(0).permutation(N_USERS)[:120]
    with open(os.path.join(d, META_FILE), "wb") as f:
        pickle.dump(users.tolist(), f)
    got = load_data(tcfg).extras["meta_users"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmb.load(jcfg).extras["meta_users"]))
    np.testing.assert_array_equal(got.numpy(), users)
    assert "kg_triplets" not in load_data(tcfg).extras


def test_cml_without_meta_users_takes_every_user(tmp_path):
    behaviors, mats, _, tst = mb_split()
    jcfg, tcfg = _cfgs("cml", tmp_path)
    tdata = tmb.bundle_from_behaviors(tcfg, behaviors, mats, tst)
    jdata = jmb.bundle_from_behaviors(jcfg, behaviors, mats, tst)
    assert "meta_users" not in tdata.extras and "meta_users" not in jdata.extras
    np.testing.assert_array_equal(build_model(tcfg, tdata).meta_users.numpy(),
                                  np.asarray(jbuild_model(jcfg, jdata).meta_users))


def test_kmclr_triplets_read_as_jax(tmp_path):
    d = write_mb_dir(tmp_path)
    jcfg, tcfg = _cfgs("kmclr", tmp_path)
    tdata, jdata = load_data(tcfg), jmb.load(jcfg)
    assert "kg_triplets" not in tdata.extras and "kg_triplets" not in jdata.extras
    tm, jm = build_model(tcfg, tdata), jbuild_model(jcfg, jdata)     # the placeholder triplet
    assert (tm.n_entities, tm.n_relations, tm.kg_cap) == (jm.n_entities, jm.n_relations,
                                                          jm.kg_cap) == (1, 1, 1)
    np.testing.assert_array_equal(tm.item_ents.numpy(), np.asarray(jm.item_ents))
    rng = np.random.default_rng(2)
    trip = np.stack([rng.integers(0, 260, 900), rng.integers(0, 3, 900),
                     rng.integers(0, 500, 900)], 1)           # heads past the items too
    np.savetxt(os.path.join(d, "kg.txt"), trip, fmt="%d")
    tdata, jdata = load_data(tcfg), jmb.load(jcfg)
    np.testing.assert_array_equal(tdata.extras["kg_triplets"], jdata.extras["kg_triplets"])
    np.testing.assert_array_equal(tdata.extras["kg_triplets"], trip)
    assert "meta_users" not in tdata.extras
    tm, jm = build_model(tcfg, tdata), jbuild_model(jcfg, jdata)
    assert (tm.n_entities, tm.n_relations, tm.kg_cap) == (jm.n_entities, jm.n_relations,
                                                          jm.kg_cap)
    np.testing.assert_array_equal(tm.item_ents.numpy(), np.asarray(jm.item_ents))
    np.testing.assert_array_equal(tm.item_rels.numpy(), np.asarray(jm.item_rels))
    for tt, jt in zip(tm.kg_trip.unbind(1), jm.kg_trip):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _beh_mats(seed=0):
    rng = np.random.default_rng(seed)
    return {beh: sp.csr_matrix((rng.random((40, 20)) < density).astype(np.float32))
            for beh, density in [("view", 0.25), ("cart", 0.12), ("buy", 0.06)]}


def test_load_mf_as_jax(tmp_path):
    """``tests/test_tools.py::test_load_mf_variant``'s split and expectations,
    and the bundle equal to JAX's."""
    d = tmp_path / "multi_behavior" / "retail_rocket"
    d.mkdir(parents=True)
    mats = _beh_mats(1)
    for beh, m in mats.items():
        with open(d / f"train_mat_{beh}.pkl", "wb") as f:
            pickle.dump(m, f)
    rng = np.random.default_rng(2)
    tst = sp.csr_matrix((rng.random((40, 20)) < 0.05).astype(np.float32))
    with open(d / "test_mat.pkl", "wb") as f:
        pickle.dump(tst, f)
    over = {"data.dir": str(tmp_path), "data.type": "multi_behavior_mf"}
    data = load_data(tload_config("smbrec", dataset="retail_rocket", overrides=over))
    assert data.user_num == 40 and data.item_num == 20
    assert int(data.n_train) == mats["buy"].nnz
    assert "behavior_graphs" not in data.extras
    jdata = jload_data(jload_config("smbrec", dataset="retail_rocket", overrides=over))
    for k in ("train_users", "train_items"):
        np.testing.assert_array_equal(getattr(data, k).numpy(), np.asarray(getattr(jdata, k)))
    np.testing.assert_array_equal(data.test.test_users.numpy(), np.asarray(jdata.test.test_users))
    for part in ("ground_truth", "history"):
        for k in ("cols", "mask", "lengths"):
            np.testing.assert_array_equal(getattr(getattr(data.test, part), k).numpy(),
                                          np.asarray(getattr(getattr(jdata.test, part), k)))
    assert (data.extras["train_mat_scipy"] != jdata.extras["train_mat_scipy"]).nnz == 0
