"""The port's KG data handler (``sslrec_tpu_torch/data/kg.py``) against the
JAX package's (``sslrec_tpu/data/kg.py``): triplet expansion, the per-head
cap, the maskable bi-adjacency's view values and the bundle's eval
structures.  Integer work is compared exactly; the view values (float
products of the same factors, degree sums in another order) at rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu import config as jconfig
from sslrec_tpu.data import kg as jkg
from sslrec_tpu_torch import config as tconfig
from sslrec_tpu_torch.data import kg as tkg
from sslrec_tpu_torch.ops.spmm import spmm
from sslrec_tpu_torch.ops.spmm_kernel import EdgeMask

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


def write_kg_dir(root, name="toy", n_users=30, n_items=20, n_ents=35, n_rels=3,
                 n_raw=160, seed=0):
    """A tiny KG dataset in the handler's layout, ``<root>/kg/<name>_kg/``:
    train/test ``u i1 i2 ...`` lines and raw ``h r t`` triples, from a seeded
    numpy generator.  Entity 0 heads many triples, so the per-head cap draws."""
    d = root / "kg" / f"{name}_kg"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    with open(d / "train.txt", "w") as ftr, open(d / "test.txt", "w") as fte:
        for u in range(n_users):
            items = rng.choice(n_items, 6, replace=False)
            ftr.write(" ".join(map(str, [u, *items[:4]])) + "\n")
            fte.write(" ".join(map(str, [u, *items[4:]])) + "\n")
    raw = np.stack([rng.integers(0, n_ents, n_raw), rng.integers(0, n_rels, n_raw),
                    rng.integers(0, n_ents, n_raw)], 1)
    raw[:40, 0] = 0
    np.savetxt(d / "kg_final.txt", raw, fmt="%d")
    return d


def _cfgs(**overrides):
    ov = {"model.triplet_num": 5, **overrides}
    return jconfig.load_config("kgcl", overrides=ov), tconfig.load_config("kgcl", overrides=ov)


def test_config_matches_jax():
    assert tconfig.load_config("kgcl").to_dict() == jconfig.load_config("kgcl").to_dict()


def test_read_cf_and_triplets_match_jax(tmp_path):
    d = write_kg_dir(tmp_path)
    np.testing.assert_array_equal(tkg.read_cf(str(d / "train.txt")),
                                  jkg.read_cf(str(d / "train.txt")))
    t_trip, t_ne, t_nr = tkg.read_triplets(str(d / "kg_final.txt"))
    j_trip, j_ne, j_nr = jkg.read_triplets(str(d / "kg_final.txt"))
    np.testing.assert_array_equal(t_trip, j_trip)
    assert (t_ne, t_nr) == (j_ne, j_nr)


@pytest.mark.parametrize("seed", [0, 2020])
def test_cap_edges_per_head_bit_for_bit(tmp_path, seed):
    d = write_kg_dir(tmp_path)
    trip, *_ = jkg.read_triplets(str(d / "kg_final.txt"))
    got = tkg.cap_edges_per_head(trip, 5, seed)
    want = jkg.cap_edges_per_head(trip, 5, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert np.bincount(got[0]).max() == 5 and got[0].size < trip.shape[0]


def test_view_vals_match_jax(tmp_path):
    d = write_kg_dir(tmp_path)
    jcfg, tcfg = _cfgs(**{"data.dir": str(tmp_path), "data.name": "toy"})
    jb, tb = jkg.load(jcfg), tkg.load(tcfg)
    jbi, tbi = jb.extras["bi_adj_maskable"], tb.extras["bi_adj_maskable"]
    assert tbi.nnz_rect == jbi.nnz_rect and tbi.n_nodes == jbi.n_nodes
    np.testing.assert_array_equal(tbi.graph.rows.numpy(), np.asarray(jbi._rows))
    np.testing.assert_array_equal(tbi.graph.cols.numpy(), np.asarray(jbi._cols))
    np.testing.assert_array_equal(tbi.rect_id.numpy(), np.asarray(jbi.rect_id))
    np.testing.assert_array_equal(tbi.rect_item_ids.numpy(), np.asarray(jbi.rect_item_ids))
    for mask in (np.ones(tbi.nnz_rect, np.float32),
                 (np.random.default_rng(1).random(tbi.nnz_rect) < 0.6).astype(np.float32)):
        got = tbi.view_vals(torch.from_numpy(mask)).numpy()
        want = np.asarray(jbi.view_vals(jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert (got[mask[tbi.rect_id.numpy()] == 0] == 0).all()
    # propagation with the view values as a constant edge mask equals the
    # dense normalised matrix built from them
    x = np.random.default_rng(2).normal(size=(tbi.n_nodes, 4)).astype(np.float32)
    vals = tbi.view_vals(torch.ones(tbi.nnz_rect))
    dense = np.zeros((tbi.n_nodes, tbi.n_nodes), np.float32)
    dense[tbi.graph.rows.numpy(), tbi.graph.cols.numpy()] = vals.numpy()
    np.testing.assert_allclose(spmm(tbi.graph, torch.from_numpy(x), EdgeMask(vals)).numpy(),
                               dense @ x, rtol=1e-5, atol=1e-6)


def test_bundle_from_kg_matches_jax(tmp_path):
    d = write_kg_dir(tmp_path)
    (d / "valid.txt").write_text((d / "test.txt").read_text())
    jcfg, tcfg = _cfgs(**{"data.dir": str(tmp_path), "data.name": "toy"})
    jb, tb = jkg.load(jcfg), tkg.load(tcfg)
    assert (tb.user_num, tb.item_num, tb.n_train) == (jb.user_num, jb.item_num, jb.n_train)
    np.testing.assert_array_equal(tb.train_users.numpy(), np.asarray(jb.train_users))
    np.testing.assert_array_equal(tb.train_items.numpy(), np.asarray(jb.train_items))
    for k in ("kg_heads", "kg_rels", "kg_tails"):
        np.testing.assert_array_equal(tb.extras[k].numpy(), np.asarray(jb.extras[k]))
    np.testing.assert_array_equal(tb.extras["kg_triplets_full"], jb.extras["kg_triplets_full"])
    for k in ("entity_num", "relation_num", "node_num"):
        assert tb.extras[k] == jb.extras[k]
    for tsplit, jsplit in ((tb.valid, jb.valid), (tb.test, jb.test)):
        assert tsplit.n_test_users == jsplit.n_test_users
        np.testing.assert_array_equal(tsplit.test_users.numpy(), np.asarray(jsplit.test_users))
        for pr in ("ground_truth", "history"):
            for name in ("cols", "mask", "lengths"):
                np.testing.assert_array_equal(
                    getattr(getattr(tsplit, pr), name).numpy(),
                    np.asarray(getattr(getattr(jsplit, pr), name)))
    q = np.random.default_rng(3).integers(0, [tb.user_num, tb.item_num], (200, 2))
    np.testing.assert_array_equal(
        tb.train_edge_set.contains(torch.from_numpy(q[:, 0]), torch.from_numpy(q[:, 1])).numpy(),
        np.asarray(jb.train_edge_set.contains(jnp.asarray(q[:, 0], jnp.int32),
                                              jnp.asarray(q[:, 1], jnp.int32))))


def test_load_reads_data_dir_only(tmp_path):
    d = write_kg_dir(tmp_path)
    (d / "kg_final.txt").unlink()
    _, tcfg = _cfgs(**{"data.dir": str(tmp_path), "data.name": "toy"})
    with pytest.raises(FileNotFoundError, match="kg_final.txt"):
        tkg.load(tcfg)
