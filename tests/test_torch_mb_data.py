"""The port's multi-behavior handler (``sslrec_tpu_torch/data/multi_behavior.py``)
against the JAX package's on small random matrices built as
``tests/test_models_multi_behavior.py`` builds them (Tmall's four behaviors,
300 users × 200 items): ``normalize_rect``, every behavior's and meta path's
A and AT, the training stream, edge set and evaluation data, SMBRec's
degrees and co-user CSR, all exactly; the reader on a written directory,
with Tmall's ``pv`` allowed to be absent and a missing target refused.
Helpers here (the split, its writer) serve ``test_torch_mb_models.py``."""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import multi_behavior as tmb
from sslrec_tpu_torch.data.registry import load_data
from tests.conftest import random_ui_matrix

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

MODELS = ("mbgmn", "hmgcr", "smbrec")
N_USERS, N_ITEMS = 300, 200


def mb_split(seed=0, n_users=N_USERS, n_items=N_ITEMS):
    """Tmall-named behaviors (pv densest, buy sparsest, buy implying pv), the
    meta-path intersections of HMGCR and a test matrix."""
    behaviors = list(tmb.BEHAVIORS["tmall"])
    mats = [random_ui_matrix(n_users, n_items, density=d, seed=seed + i).tocsr()
            for i, d in enumerate([0.12, 0.05, 0.04, 0.03])]
    mats[0] = ((mats[0] + mats[3]) != 0).astype(np.float32).tocsr()
    pv, fav, cart, buy = mats
    metas = [buy, pv.multiply(buy), pv.multiply(fav).multiply(buy),
             pv.multiply(fav).multiply(cart).multiply(buy)]
    tst = random_ui_matrix(n_users, n_items, density=0.01, seed=seed + 9)
    return behaviors, mats, [sp.csr_matrix(m) for m in metas], tst


def write_mb_dir(root, name="tmall", seed=0, drop=()):
    """The split as the handler reads it, ``root/multi_behavior/<name>/``."""
    behaviors, mats, metas, tst = mb_split(seed)
    d = os.path.join(root, "multi_behavior", name)
    os.makedirs(d, exist_ok=True)
    files = {**{f"train_mat_{b}.pkl": m for b, m in zip(behaviors, mats)},
             **{f"train_mat_{mp}.pkl": m for mp, m in zip(tmb.META_PATHS["tmall"], metas)},
             "test_mat.pkl": tst}
    for fname, m in files.items():
        if fname not in drop:
            with open(os.path.join(d, fname), "wb") as f:
                pickle.dump(m, f)
    return d


def _cfgs(name, **over):
    return jload_config(name, overrides=over), tload_config(name, overrides=over)


def _coo_equal(got, want):
    """A port CsrGraph against a JAX CooGraph: the same edges, exactly."""
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, k).cpu().numpy(), np.asarray(getattr(want, k)))
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)


@pytest.mark.parametrize("name", MODELS)
def test_configs_match_jax(name):
    assert tload_config(name).to_dict() == jload_config(name).to_dict()


def test_normalize_rect_matches_jax():
    _, mats, _, _ = mb_split()
    for m in mats:
        got, want = tmb.normalize_rect(m), jmb.normalize_rect(m)
        assert (got != want).nnz == 0 and got.dtype == want.dtype


@pytest.mark.parametrize("name", MODELS)
def test_bundle_matches_jax(name):
    behaviors, mats, metas, tst = mb_split()
    jcfg, tcfg = _cfgs(name)
    meta = metas if name == "hmgcr" else None
    jb = jmb.bundle_from_behaviors(jcfg, behaviors, mats, tst, meta_mats=meta)
    tb = tmb.bundle_from_behaviors(tcfg, behaviors, mats, tst, meta_mats=meta)
    assert (tb.user_num, tb.item_num) == (jb.user_num, jb.item_num) == (N_USERS, N_ITEMS)
    for k in ("train_users", "train_items"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)))
    np.testing.assert_array_equal(tb.test.test_users.numpy(), np.asarray(jb.test.test_users))
    for part in ("ground_truth", "history"):
        for k in ("cols", "mask", "lengths"):
            np.testing.assert_array_equal(getattr(getattr(tb.test, part), k).numpy(),
                                          np.asarray(getattr(getattr(jb.test, part), k)))
    rng = np.random.default_rng(1)
    u, i = rng.integers(0, N_USERS, 4000), rng.integers(0, N_ITEMS, 4000)
    np.testing.assert_array_equal(
        tb.train_edge_set.contains(torch.from_numpy(u), torch.from_numpy(i)).numpy(),
        np.asarray(jb.train_edge_set.contains(u, i)))
    graphs = [("behavior_graphs", len(behaviors))]
    if name == "hmgcr":
        graphs.append(("meta_path_graphs", 4))
    for key, n in graphs:
        assert len(tb.extras[key]) == len(jb.extras[key]) == n
        for (ta, tat), (ja, jat) in zip(tb.extras[key], jb.extras[key]):
            _coo_equal(ta, ja)
            _coo_equal(tat, jat)
    if name == "smbrec":
        np.testing.assert_array_equal(tb.extras["beh_degrees"].numpy(),
                                      np.asarray(jb.extras["beh_degrees"]))
        for k in ("co_user_indptr", "co_user_indices"):
            np.testing.assert_array_equal(tb.extras[k].numpy(), np.asarray(jb.extras[k]))
        assert tb.extras["co_user_indices"].numel() > N_USERS
    else:
        assert "co_user_indptr" not in tb.extras


def test_reader_on_a_written_directory(tmp_path):
    write_mb_dir(tmp_path)
    write_mb_dir(tmp_path, name="ijcai_15")
    over = {"data.dir": str(tmp_path), "data.name": "tmall"}
    _, tcfg = _cfgs("hmgcr", **over)
    data = load_data(tcfg)
    assert data.extras["behaviors"] == ["pv", "fav", "cart", "buy"]
    assert len(data.extras["meta_path_graphs"]) == 4
    jdata = jmb.load(jload_config("hmgcr", overrides=over))
    np.testing.assert_array_equal(data.train_items.numpy(), np.asarray(jdata.train_items))
    # ijcai_15's densest behavior is "click", which may be absent, as here
    ij = load_data(_cfgs("smbrec", **{**over, "data.name": "ijcai_15"})[1])
    assert ij.extras["behaviors"] == ["fav", "cart", "buy"]


def test_known_missing_and_required_behaviors(tmp_path):
    write_mb_dir(tmp_path, drop=("train_mat_pv.pkl",))
    over = {"data.dir": str(tmp_path), "data.name": "tmall"}
    data = load_data(_cfgs("smbrec", **over)[1])
    assert data.extras["behaviors"] == ["fav", "cart", "buy"]
    assert data.extras["beh_degrees"].shape == (3, N_USERS)
    os.remove(os.path.join(tmp_path, "multi_behavior", "tmall", "train_mat_buy.pkl"))
    with pytest.raises(FileNotFoundError, match="train_mat_buy"):
        load_data(_cfgs("mbgmn", **over)[1])
    with pytest.raises(KeyError, match="unknown dataset"):
        load_data(_cfgs("mbgmn", **{**over, "data.name": "nowhere"})[1])
