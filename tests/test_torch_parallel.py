"""The port's device mesh (``sslrec_tpu_torch/parallel``) against the JAX
package's on the 8 virtual CPU devices: the counterparts of
``tests/test_parallel.py``.

The port's side runs in gloo processes, one a device
(``parallel.launch.spawn``, rendezvous under ``tmp_path_factory``), which run
the rank programs of ``parallel.checks`` on the same numpy inputs; two
spawns (8 ranks, 4 ranks) hold every check.

Tolerances: the partition's arrays and ``sharded_topk`` are equal; a lookup
sums one row with zeros, so it is equal too; propagation sums in another
order (one B1 call a shard against JAX's segment sum): rtol 2e-5, atol
2e-6, the JAX package's own; one Adam step: rtol 2e-4, atol 2e-6, as JAX's
test holds its sharded step, and the step's gradients rtol 2e-4, atol 1e-5
of the largest; metrics rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
import torch

from conftest import random_ui_matrix
from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data.general_cf import bundle_from_matrices as jbundle
from sslrec_tpu.models.registry import build_model as jbuild_model
from sslrec_tpu.ops import sparse as jsparse
from sslrec_tpu.ops.topk import sharded_topk as jsharded_topk
from sslrec_tpu.parallel import dist_train as jdt
from sslrec_tpu.parallel.mesh import make_mesh as jmake_mesh
from sslrec_tpu.trainer.metrics import Evaluator as JEvaluator
from sslrec_tpu_torch.ops.sparse import CooGraph
from sslrec_tpu_torch.parallel import checks, dist_train, launch
from sslrec_tpu_torch.parallel.mesh import mesh_dims

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

PROP = dict(rtol=2e-5, atol=2e-6)


def _bi(ui):
    """The bi-adjacency of ``ui`` as the JAX package's CooGraph and as numpy."""
    g = jsparse.from_scipy(jsparse.make_bi_adj(ui, *ui.shape))
    n = ui.shape[0] + ui.shape[1]
    return g, {"rows": np.asarray(g.rows), "cols": np.asarray(g.cols),
               "vals": np.asarray(g.vals), "n": n}


def _tiny():
    return random_ui_matrix()


def _cf_mats():
    return (random_ui_matrix(60, 30, density=0.15, seed=0), None,
            random_ui_matrix(60, 30, density=0.05, seed=1))


def _ones(gd: dict) -> dict:
    return {**gd, "vals": np.ones_like(gd["vals"])}


def _view_vals(gd: dict, seed: int) -> np.ndarray:
    return (gd["vals"] * np.random.default_rng(seed).random(gd["vals"].shape[0])
            ).astype(np.float32)


def _tables(n_users, n_items, n_model, d=8, seed=3):
    rng = np.random.default_rng(seed)
    u_pad, i_pad = (-(-n // n_model) * n_model for n in (n_users, n_items))
    return (rng.standard_normal((u_pad, d)).astype(np.float32),
            rng.standard_normal((i_pad, d)).astype(np.float32))


def _step_inputs():
    ui = _tiny()
    n_users, n_items = ui.shape
    _, gd = _bi(ui)
    u0, i0 = _tables(n_users, n_items, 2, seed=0)
    u0, i0 = 0.1 * u0, 0.1 * i0
    u0[n_users:], i0[n_items:] = 0.0, 0.0
    rng = np.random.default_rng(0)
    b = 8 * 4
    batch = {k: rng.integers(0, n, b).astype(np.int32)
             for k, n in (("user", n_users), ("pos", n_items), ("neg", n_items))}
    return {**gd, "n_users": n_users, "n_items": n_items, "n_data": 4, "n_model": 2,
            "layer_num": 2, "reg_weight": 1e-6, "keep_rate": 1.0, "lr": 1e-2,
            "user_embeds": u0, "item_embeds": i0, **batch, "key": np.array([0, 3])}


def _multi_view_inputs():
    ui = _tiny()
    _, gd = _bi(ui)
    u, i = _tables(*ui.shape, 2, seed=5)
    return {**gd, "n_users": ui.shape[0], "n_items": ui.shape[1], "n_data": 4, "n_model": 2,
            "u": u, "i": i, "layer_num": 2, "combine": "mean",
            "view_vals": [_view_vals(gd, 1), (gd["vals"] - _view_vals(gd, 1)).astype(np.float32)]}


def _entry_inputs(n_data, n_model, combine):
    ui = _tiny()
    _, gd = _bi(ui)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((ui.shape[0], 8)).astype(np.float32)
    i = rng.standard_normal((ui.shape[1], 8)).astype(np.float32)
    return {**_ones(gd), "n_users": ui.shape[0], "n_items": ui.shape[1], "n_data": n_data,
            "n_model": n_model, "u": u, "i": i, "layer_num": 2, "combine": combine,
            "view_vals": [_view_vals(gd, 8)]}


def _scores():
    """Scores on a coarse grid, so that many tie."""
    return np.random.default_rng(0).integers(0, 6, (6, 64)).astype(np.float32)


def _rect_inputs():
    ui = random_ui_matrix(60, 40, density=0.1, seed=4)
    ui.data = np.random.default_rng(5).random(ui.nnz).astype(np.float32)
    a, at = jsparse.from_scipy(ui), jsparse.from_scipy(sp.coo_matrix(ui.T))
    return {"n_users": 60, "n_items": 40, "n_data": 2, "n_model": 2,
            "a_rows": np.asarray(a.rows), "a_cols": np.asarray(a.cols),
            "a_vals": np.asarray(a.vals), "at_rows": np.asarray(at.rows),
            "at_cols": np.asarray(at.cols), "at_vals": np.asarray(at.vals)}, (a, at)


def _lightgcn_inputs(n_data, n_model, mask=None):
    trn, _, tst = _cf_mats()
    cfg = jload_config("lightgcn", overrides={"model.embedding_size": 8})
    jm = jbuild_model(cfg, jbundle(trn, None, tst))
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(3)))
    return {"trn": trn.toarray(), "val": None, "tst": tst.toarray(), "n_data": n_data,
            "n_model": n_model, "params": {k: np.asarray(v) for k, v in params.items()},
            "mask": mask, "overrides": {"model.embedding_size": 8, "test.batch_size": 16,
                                        "test.k": [5, 10],
                                        "test.metrics": ["recall", "ndcg", "precision",
                                                         "mrr"]}}


def _trainer_inputs(n_data, n_model):
    """LightGCN's Trainer on the JAX package's test bundle, with weight decay:
    L2 added to the gradient before Adam makes Adam's step depend on the
    gradient's scale, which Adam alone does not."""
    trn, _, tst = _cf_mats()
    return {"trn": trn.toarray(), "val": None, "tst": tst.toarray(), "n_data": n_data,
            "n_model": n_model, "overrides": {"model.embedding_size": 8,
                                              "train.batch_size": 64,
                                              "optimizer.weight_decay": 1e-2}}


def _mask():
    _, gd = _bi(_cf_mats()[0])
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (gd["rows"].shape[0],)))


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    todo = [("shape", "mesh_shape", {"n_data": 4, "n_model": 2}),
            ("topk", "topk", {"n_model": 8, "scores": _scores(), "k": 5}),
            ("step", "sharded_step", _step_inputs()),
            ("views", "propagate", _multi_view_inputs()),
            ("entry24_sum", "propagate", _entry_inputs(2, 4, "sum")),
            ("entry24_mean", "propagate", _entry_inputs(2, 4, "mean"))]
    return launch.spawn(checks.run, (todo,), 8, root=str(tmp_path_factory.mktemp("r8")))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    rng = np.random.default_rng(1)
    look = {"n_model": 4, "shard": 16, "table": rng.standard_normal((64, 8)).astype(np.float32),
            "idx": rng.integers(0, 64, 12)}
    todo = [("lookup", "owned_lookup", look),
            ("lgcn22", "lightgcn", _lightgcn_inputs(2, 2, _mask())),
            ("eval41", "lightgcn", _lightgcn_inputs(4, 1)),
            ("entry22_sum", "propagate", _entry_inputs(2, 2, "sum")),
            ("entry22_mean", "propagate", _entry_inputs(2, 2, "mean")),
            ("rect", "rect_pair", _rect_inputs()[0]),
            ("step22", "trainer_step", _trainer_inputs(2, 2))]
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("r4")))
    return out, look


def test_mesh_shapes(ranks8):
    assert jmake_mesh(n_data=4, n_model=2).shape == {"data": 4, "model": 2}
    assert [r["shape"]["shape"] for r in ranks8] == [{"data": 4, "model": 2}] * 8
    assert [r["shape"]["coords"] for r in ranks8] == [(d, m) for d in range(4) for m in range(2)]
    assert mesh_dims(None, 2, 8) == (4, 2) and mesh_dims(None, None, 8) == (8, 1)
    with pytest.raises(ValueError, match="needs more than 8 devices"):
        mesh_dims(4, 4, 8)


@pytest.mark.parametrize("n_model", [2, 4])
def test_partition_graph_equals_jax(n_model):
    ui = _tiny()
    g, gd = _bi(ui)
    want = jdt.partition_graph(g, *ui.shape, n_model=n_model)
    got = dist_train.partition_graph(CooGraph(gd["rows"], gd["cols"], gd["vals"], gd["n"],
                                              gd["n"]), *ui.shape, n_model)
    for f in ("local_rows", "cols", "vals", "src_idx"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert (got.u_loc, got.i_loc, got.n_model) == (want.u_loc, want.i_loc, want.n_model)
    assert int((got.src_idx >= 0).sum()) == g.nnz == got.n_edges


def test_shard_layouts_hold_the_live_slots_only():
    """Each shard's B1 layout over its live slots gives JAX's segment sum of
    its padded slots (padding slots have row 0 and value 0)."""
    import torch
    from sslrec_tpu_torch.ops import spmm_kernel as sk
    ui = _tiny()
    g, gd = _bi(ui)
    sg = dist_train.partition_graph(CooGraph(gd["rows"], gd["cols"], gd["vals"], gd["n"],
                                             gd["n"]), *ui.shape, 4)
    x = np.random.default_rng(2).standard_normal((sg.n_pad, 8)).astype(np.float32)
    for p in range(4):
        want = jax.ops.segment_sum(x[sg.cols[p]] * sg.vals[p][:, None], sg.local_rows[p],
                                   num_segments=sg.n_local)
        sh = dist_train.shard_graph(sg, p, "cpu")
        got = sk.csr_spmm(sh.graph.fwd, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PROP)
        assert sh.graph.fwd.n_ids == g.nnz and sh.graph.nnz == int((sg.src_idx[p] >= 0).sum())


def test_owned_lookup_matches_jax(ranks4):
    out, look = ranks4
    mesh = jmake_mesh(n_data=1, n_model=4)
    want = shard_map(lambda t, i: jdt._owned_lookup(t, i, 16, "model"), mesh=mesh,
                     in_specs=(P("model", None), P()), out_specs=P(), check_rep=False)(
        jnp.asarray(look["table"]), jnp.asarray(look["idx"]))
    for r in out:
        np.testing.assert_array_equal(r["lookup"]["out"], np.asarray(want))
    np.testing.assert_array_equal(out[0]["lookup"]["out"], look["table"][look["idx"]])


def _grads_as_state():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradients it was given as its state: JAX's step then returns
    the gradients it computed."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_sharded_step_matches_jax(ranks8):
    """One TP×DP step at keep_rate 1.0 ({data: 4, model: 2}) against JAX's
    ``build_sharded_lightgcn_step``: the loss, the gradients given to the
    optimiser (rtol 2e-4, atol 1e-5 of the largest; Adam's first step does
    not see their scale, so a gradient a factor off shows only here) and the
    tables after optax's Adam."""
    inp = _step_inputs()
    n_users, n_items = inp["n_users"], inp["n_items"]
    mesh = jmake_mesh(n_data=4, n_model=2)
    g, _ = _bi(_tiny())
    sg = jdt.partition_graph(g, n_users, n_items, 2)
    batch = {k: jnp.asarray(inp[k]) for k in ("user", "pos", "neg")}
    out = {}
    for name, opt in (("adam", optax.adam(1e-2)), ("grads", _grads_as_state())):
        shardings, step = jdt.build_sharded_lightgcn_step(mesh, sg, 2, 1e-6, 1.0, opt)
        params = {k: jax.device_put(jnp.asarray(inp[k]), shardings[k])
                  for k in ("user_embeds", "item_embeds")}
        out[name] = step(params, opt.init(params), batch, jax.random.PRNGKey(3))
    new, _, loss = out["adam"]
    _, grads, _ = out["grads"]
    for r in ranks8:
        got = r["step"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for k in ("user_embeds", "item_embeds"):
            want = np.asarray(grads[k])
            np.testing.assert_allclose(got[f"{k}_grad"], want, rtol=2e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{k} grad")
            np.testing.assert_allclose(got[k], np.asarray(new[k]), rtol=2e-4, atol=2e-6,
                                       err_msg=k)


def test_sharded_evaluator_matches_jax(ranks4):
    """Evaluator(mesh) with the user batches split over {data: 4} against the
    JAX evaluator under its mesh and the single one."""
    out, _ = ranks4
    inp = _lightgcn_inputs(4, 1)
    trn, _, tst = _cf_mats()
    cfg = jload_config("lightgcn", overrides=inp["overrides"])
    data = jbundle(trn, None, tst)
    jm = jbuild_model(cfg, data)
    params = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    single = JEvaluator(jm, data.test, cfg)(params)
    sharded = JEvaluator(jm, data.test, cfg, mesh=jmake_mesh(n_data=4, n_model=1))(params)
    for r in out:
        assert not r["eval41"]["sharded"]
        for m in single:
            np.testing.assert_allclose(r["eval41"]["metrics"][m], sharded[m], rtol=1e-5)
            np.testing.assert_allclose(r["eval41"]["metrics"][m], single[m], rtol=1e-5)


def test_sharded_topk_matches_jax(ranks8):
    scores = _scores()
    mesh = jmake_mesh(n_data=1, n_model=8)

    def f(s):
        return jsharded_topk(s, jax.lax.axis_index("model") * 8, 5, "model")

    want = shard_map(f, mesh=mesh, in_specs=(P(None, "model"),), out_specs=P(),
                     check_rep=False)(jnp.asarray(scores))
    _, ref = jax.lax.top_k(jnp.asarray(scores), 5)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(ref))
    for r in ranks8:
        np.testing.assert_array_equal(r["topk"]["out"], np.asarray(want))


def test_partitioned_spmm_multi_view_matches_jax(ranks8):
    """Two views' values riding the partition (mean combine, 2 hops) under
    {data: 4, model: 2}, as JAX's test builds them with one partition a view."""
    inp = _multi_view_inputs()
    n_users, n_items = inp["n_users"], inp["n_items"]
    g, _ = _bi(_tiny())
    mesh = jmake_mesh(n_data=4, n_model=2)
    views = [jsparse.CooGraph(g.rows, g.cols, jnp.asarray(v), g.n_rows, g.n_cols)
             for v in inp["view_vals"]]
    sg = jdt.partition_graph(g, n_users, n_items, 2)
    sgs = [jdt.partition_graph(v, n_users, n_items, 2) for v in views]

    def gather_rows(x):
        return jax.lax.all_gather(x, "model").reshape(-1, x.shape[-1])

    def f(u, i, r1, c1, v1, r2, c2, v2):
        u1, i1 = jdt.partitioned_propagate(sg, u, i, r1[0], c1[0], v1[0], 2, "mean")
        u2, i2 = jdt.partitioned_propagate(sg, u, i, r2[0], c2[0], v2[0], 2, "mean")
        return gather_rows(u1 + u2), gather_rows(i1 + i2)

    spec = P("model", None)
    want = shard_map(f, mesh=mesh, in_specs=(spec,) * 8, out_specs=(P(), P()),
                     check_rep=False)(jnp.asarray(inp["u"]), jnp.asarray(inp["i"]),
                                      *[getattr(s, a) for s in sgs
                                        for a in ("local_rows", "cols", "vals")])
    for r in ranks8:
        np.testing.assert_allclose(r["views"]["u"], np.asarray(want[0]), **PROP)
        np.testing.assert_allclose(r["views"]["i"], np.asarray(want[1]), **PROP)


@pytest.mark.parametrize("n_data,n_model", [(2, 4), (2, 2)])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_mesh_partitioned_propagate_matches_jax(ranks8, ranks4, n_data, n_model, combine):
    inp = _entry_inputs(n_data, n_model, combine)
    g, _ = _bi(_tiny())
    ones = jsparse.CooGraph(g.rows, g.cols, jnp.ones_like(g.vals), g.n_rows, g.n_cols)
    sg = jdt.partition_graph(ones, inp["n_users"], inp["n_items"], n_model)
    pv = jdt.view_vals_partitioned(sg, jnp.asarray(inp["view_vals"][0]))
    mesh = jmake_mesh(n_data=n_data, n_model=n_model)
    with mesh:
        want = jax.jit(lambda u, i, v: jdt.mesh_partitioned_propagate(
            mesh, sg, u, i, v, layer_num=2, combine=combine))(
            jnp.asarray(inp["u"]), jnp.asarray(inp["i"]), pv)
    ranks = ranks8 if n_model == 4 else ranks4[0]
    for r in ranks:
        got = r[f"entry{n_data}{n_model}_{combine}"]
        np.testing.assert_array_equal(got["pv"], np.asarray(pv))
        np.testing.assert_allclose(got["u"][:inp["n_users"]], np.asarray(want[0]), **PROP)
        np.testing.assert_allclose(got["i"][:inp["n_items"]], np.asarray(want[1]), **PROP)


def test_rect_pair_equals_jax(ranks4):
    out, _ = ranks4
    inp, (a, at) = _rect_inputs()
    cfg = jload_config("hmgcr", overrides={"train.mesh": {"data": 2, "model": 2}})
    _, (sg_a, sg_at) = jdt.maybe_partition_rect_pair(cfg, a, at, 60, 40)
    for r in out:
        for tag, sg in (("a", sg_a), ("at", sg_at)):
            for f in ("local_rows", "cols", "vals", "src_idx"):
                np.testing.assert_array_equal(r["rect"][f"{tag}.{f}"],
                                              np.asarray(getattr(sg, f)), err_msg=f"{tag}.{f}")


def test_lightgcn_partitioned_propagate_matches_jax(ranks4):
    """LightGCN's partitioned ``propagate`` under {data: 2, model: 2} against
    JAX's, plain and under an injected [nnz] mask; each rank holds its
    ``U_loc`` rows; the mesh evaluator's metrics against JAX's single one."""
    out, _ = ranks4
    inp = _lightgcn_inputs(2, 2)
    trn, _, tst = _cf_mats()
    jcfg = jload_config("lightgcn", overrides={**inp["overrides"],
                                               "train.mesh": {"data": 2, "model": 2}})
    jdata = jbundle(trn, None, tst)
    mm = jbuild_model(jcfg, jdata)
    params = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    um, im = mm.propagate(params)
    um2, im2 = mm.propagate(params, edge_weight=jnp.asarray(_mask()))
    j1 = jbuild_model(jload_config("lightgcn", overrides=inp["overrides"]), jdata)
    single = JEvaluator(j1, jdata.test, jload_config("lightgcn", overrides=inp["overrides"]))(
        params)
    for r in out:
        got = r["lgcn22"]
        assert got["sharded"] and got["local_rows"] == 30
        np.testing.assert_allclose(got["u"], np.asarray(um), **PROP)
        np.testing.assert_allclose(got["i"], np.asarray(im), **PROP)
        np.testing.assert_allclose(got["u_mask"], np.asarray(um2), **PROP)
        np.testing.assert_allclose(got["i_mask"], np.asarray(im2), **PROP)
        for m in single:
            np.testing.assert_allclose(got["metrics"][m], single[m], rtol=1e-5)


def test_mesh_step_matches_single_step(ranks4):
    """One step of the port's Trainer on a {data: 2, model: 2} mesh against
    the same step on one device: the gradients summed over ``data`` (rtol
    1e-5, atol 1e-9: sums in another order) and the tables after weight decay
    and Adam (rtol 2e-4, atol 2e-6).  Without the division by the ``model``
    axis in ``dist_train.mesh_backward`` every gradient would come out twice
    the single one."""
    out, _ = ranks4
    single = checks.trainer_step(_trainer_inputs(1, 1))
    for r in out:
        got = r["step22"]
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6)
        for k in ("user_embeds", "item_embeds"):
            np.testing.assert_allclose(got[k + ".grad"], single[k + ".grad"], rtol=1e-5,
                                       atol=1e-9, err_msg=k)
            np.testing.assert_allclose(got[k], single[k], rtol=2e-4, atol=2e-6, err_msg=k)
