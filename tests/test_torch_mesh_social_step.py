"""DcRec, DSL, KCGN, MHCN and SMIN on a {data: 2, model: 2} mesh of gloo
processes: one step of each against the JAX package on one device
(``value_and_grad`` of the loss on the whole batch), and DSL's Trainer step,
whose clip takes the mesh's global norm, against the same step on one
device.

The ranks run ``parallel.checks.model_step`` for the five and
``checks.trainer_step`` for DSL on {2, 2} and on {1, 1} in one spawn of four.
Each rank holds a row shard of the model's tables and reads them whole, so
every hop runs on the whole graphs in every rank.  The five train on a
seeded social split of 51 users × 31 items (``test_torch_social_data.
social_split``), so that every row-sharded table has a padding row; the
batch has 31 rows, so the two ``data`` slices differ by one.  KCGN runs on
the same split with two rating classes fused by a learned weight (ratings
and train times drawn on its pairs, as
``test_torch_social_metapaths.rated_split`` draws them), so that its item
copies' table stays replicated and its fusion weights are row-sharded.

Draws are JAX's under the loss's key, computed in the same float64 context
as the loss: DcRec's four views (``_pick_kinds`` and ``_view``), MHCN's
permutations, DSL's pairs and dropout masks (its pairs in the JAX batch, as
``test_torch_social_models_b.py`` gives them), KCGN's and SMIN's row
shuffles; they are the whole batch's, and a rank keeps its slice of DSL's.
SMIN's port is built on the JAX package's sampled metapaths, which the
ranks' handler takes in place of its own draw.

All five run in float64 on both sides (JAX under ``jax.enable_x64``, the
port's model in double; the graphs' values stay float32), so that the
comparison sees the mesh and not float32 rounding.  Tolerances: the loss
terms rtol 1e-6; the whole gradients (summed over ``data``, gathered over
``model``) rtol 1e-5 with atol 1e-7 of the tensor's largest entry, as
``test_torch_mesh_gcf_step.py`` holds item 9a's; the global norm of the
summed gradients (``dist_train.global_norm``) rtol 1e-6 against the norm
of JAX's.  DSL's Trainer step (float32): the loss terms rtol 1e-6, the
clipped gradients rtol 1e-5 with atol 1e-5 of the largest entry, the
tables after Adam rtol 2e-4, atol 2e-6; the clip fires (the single step's
clipped gradients have norm 10).

KCGN's or SMIN's mask built from a rank's slice alone, DSL's draws sized by
the slice, DSL's norm without the ``model`` sum or DcRec's GRACE split over
the ``model`` ranks fails these.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import social as jsocial
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu_torch.models.social.kcgn import time_table
from sslrec_tpu_torch.parallel import checks, launch
from sslrec_tpu_torch.utils import convert
from test_torch_social_data import social_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

N_USERS, N_ITEMS, BATCH = 51, 31, 31
MODELS = ("dcrec", "dsl", "kcgn", "mhcn", "smin")
OVERRIDES = {m: {"model.embedding_size": 8} for m in MODELS}
OVERRIDES["kcgn"]["model.fuse"] = "weight"
TERMS_RTOL, RTOL, ATOL_REL, NORM_RTOL = 1e-6, 1e-5, 1e-7, 1e-6
# DSL's Trainer step: a batch large enough that its summed BPR's gradient
# passes the clip (10)
DSL_TRAINER = {"model.embedding_size": 8, "train.batch_size": 256}


def _x64():
    return jax.enable_x64(True)


@functools.lru_cache(maxsize=None)
def split(name):
    """``(trn, tst, trust)`` and the handler's keyword inputs of ``name``."""
    trn, tst, trust = social_split(N_USERS, N_ITEMS, seed=3)
    if name == "kcgn":          # two rating classes and train times on the same pairs
        rng = np.random.default_rng(4)
        coo = trn.tocoo()

        def on_pairs(vals):
            return sp.csr_matrix((vals, (coo.row, coo.col)), shape=coo.shape)

        return (on_pairs(rng.choice((1.0, 3.0), coo.nnz)), tst, trust), {
            "trn_time": on_pairs(rng.integers(10**9, 10**9 + 3600 * 360 * 5, coo.nnz)
                                 .astype(np.float64))}
    return (trn, tst, trust), {}


def _metapaths(mats):
    """The JAX handler's metapath draw for SMIN, from the inputs the port's
    handler passes its sampler."""
    trn, _, trust = mats
    trn_bin = (trn != 0).astype(np.float32).tocoo()
    category = sp.csr_matrix(np.ones((trn.shape[1], 1), np.float32))
    return jsocial.gen_metapaths(trn_bin, sp.csr_matrix(trust), category)


def _names(name, tree) -> dict:
    """A JAX parameter (or gradient) tree as numpy arrays under the port's
    names, in the tree's own precision."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_state", lambda flat: {k: np.asarray(v) for k, v in flat.items()})
        return getattr(convert, f"{name}_params_from_jax")(
            jax.tree.map(np.asarray, jax.device_get(tree)))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return None if x is None else np.asarray(x)


def _draws(name, jm, key, idx):
    """JAX's draws under the loss's ``key`` as the port's, for the whole
    batch; DSL's pairs also go into the JAX batch (``idx``)."""
    if name == "dcrec":
        u, i = jm.user_num, jm.item_num
        kc, ks, kv = jax.random.split(key, 3)
        kinds = [*jm._pick_kinds(kc), *jm._pick_kinds(ks)]
        specs = [(jm.ui_rows, u, i, jm.n_aug_ui)] * 2 + [(jm.t_rows, u, u, jm.n_aug_t)] * 2
        views = []
        for k, kind, spec in zip(jax.random.split(kv, 4), kinds, specs):
            w, add_r, add_c, _ = jm._view(k, kind, *spec)
            # 0/1 weights, float32 as the port draws them
            views.append({"w": jnp.asarray(w, jnp.float32),
                          "add": (add_r, add_c) if int(kind) == 0 else None})
        return "views", views
    if name == "mhcn":
        n, d = jm.user_num, jm.embedding_size
        out = []
        for kc in jax.random.split(key, 3):
            k1, k2, k3, _ = jax.random.split(kc, 4)
            p = {"row1": jax.random.permutation(k1, n)}
            for tag, k in (("2", k2), ("3", k3)):
                ka, kb = jax.random.split(k)
                p["col" + tag], p["row" + tag] = (jax.random.permutation(ka, d),
                                                  jax.random.permutation(kb, n))
            out.append(p)
        return "draws", out
    if name == "dsl":
        _, kl = jax.random.split(key)
        k1, k2 = jax.random.split(kl)
        return "draws", {"sal_u1": idx["sal_u1"], "sal_u2": idx["sal_u2"],
                         "keep1": jax.random.bernoulli(k1, 0.5, (BATCH, jm.embedding_size)),
                         "keep2": jax.random.bernoulli(k2, 0.5, (BATCH, 1))}
    if name == "smin":
        return "draws", {"perm": jax.random.permutation(key, jm.user_num + jm.item_num)}
    k1, k2 = jax.random.split(key)
    return "draws", {"perm_u": jax.random.permutation(k1, jm.user_num),
                     "perm_i": jax.random.permutation(k2, jm.item_num)}


def _jax_case(name):
    """The JAX reference of one step on the whole batch (float64), and the
    port's ``model_step`` inputs."""
    mats, kw = split(name)
    cfg = jload_config(name, overrides=OVERRIDES[name])
    jm = jbuild(cfg, jsocial.bundle_from_matrices(cfg, *mats, **kw))
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    u, i = jm.user_num, jm.item_num
    fields = {"user": u, "pos": i, "neg": i}
    if name == "dsl":
        fields.update(suser=u, spos=u, sneg=u, sal_u1=u, sal_u2=u)
    idx = {k: rng.integers(0, hi, BATCH).astype(np.int32) for k, hi in fields.items()}
    key = jax.random.PRNGKey(9)
    with _x64():
        params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
        kind, draws = _draws(name, jm, key, idx)
        jbatch = {k: jnp.asarray(v) for k, v in idx.items()}
        (loss, terms), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            params, jbatch, key)
    social = {"trn": mats[0], "tst": mats[1], "trust": mats[2], **kw}
    attrs = {}
    if name == "smin":
        social["metapaths"] = _metapaths(mats)
    if name == "kcgn":      # the edges' time rows, a float32 constant, in the model's float64
        attrs["edge_time"] = time_table(jm.max_time, jm.embedding_size)[np.asarray(jm.time_seq)]
    inp = {"attrs": attrs, "model": name, "n_data": 2, "n_model": 2, "overrides": OVERRIDES[name],
           "social": social, "params": _names(name, params), "f64": True, "key": None,
           kind: _np(draws), **{k: v for k, v in idx.items() if not k.startswith("sal")}}
    grads = _names(name, grads)
    want = {"terms": {"loss": float(loss), **{k: float(v) for k, v in terms.items()}},
            "grads": grads,
            "norm": float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                      for g in grads.values())))}
    return want, inp


def _trainer_case(n):
    mats, _ = split("dsl")
    return {"model": "dsl", "n_data": n, "n_model": n, "overrides": DSL_TRAINER,
            "social": {"trn": mats[0], "tst": mats[1], "trust": mats[2]}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax_side, todo = {}, []
    for name in MODELS:
        jax_side[name], inp = _jax_case(name)
        todo.append((name, "model_step", inp))
    todo += [("trainer", "trainer_step", _trainer_case(2)),
             ("single", "trainer_step", _trainer_case(1))]
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("social20")))
    return jax_side, out


@pytest.mark.parametrize("name", MODELS)
def test_mesh_step_matches_jax(ranks, name):
    """One {2, 2} step against JAX on the whole batch: the loss terms, the
    whole gradients and their global norm, in every rank; each rank holds
    ⌈N/2⌉ rows of each row-sharded table."""
    jax_side, out = ranks
    want = jax_side[name]
    tables = {"dcrec": {"ui_user_embeds": 26, "uu_user_embeds": 26, "ui_item_embeds": 16},
              "kcgn": {"user_embeds": 26, "fuse_w": 16}}.get(
        name, {"user_embeds": 26, "item_embeds": 16})
    for r in out:
        got = r[name]
        assert {k: s[0] for k, s in got["local_shapes"].items()} == tables
        assert set(got["terms"]) == set(want["terms"])
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=TERMS_RTOL,
                                       err_msg=f"{name}: {k}")
        assert set(got["grads"]) == set(want["grads"])
        for k, v in want["grads"].items():
            assert got["grads"][k] is not None, f"{name}: {k} has no gradient"
            assert got["grads"][k].dtype == np.float64
            np.testing.assert_allclose(got["grads"][k], v, rtol=RTOL,
                                       atol=ATOL_REL * max(np.abs(v).max(), 1e-30),
                                       err_msg=f"{name}: grads {k}")
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=NORM_RTOL,
                                   err_msg=f"{name}: global norm")


def test_dsl_trainer_step_clips_by_the_mesh_norm(ranks):
    """DSL's Trainer step on {2, 2} against the same step on one device, in
    every rank: the clip fires (the single step's clipped gradients have
    norm 10), and the mesh's clipped gradients and tables after Adam are the
    single step's."""
    _, out = ranks
    single = out[0]["single"]
    grads = [v for k, v in single.items() if k.endswith(".grad")]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    np.testing.assert_allclose(norm, 10.0, rtol=1e-5)
    for r in out:
        got, want = r["trainer"], r["single"]
        assert set(got) == set(want)
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-6, err_msg=k)
        for k, v in want.items():
            if k in ("loss", "terms"):
                continue
            if k.endswith(".grad"):
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max(),
                                           err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2e-6, err_msg=k)
