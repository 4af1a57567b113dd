"""HMGCR, SMBRec, CML and KMCLR on a {data: 2, model: 2} mesh of gloo
processes: one step of each against the JAX package (``value_and_grad`` of
HMGCR's and SMBRec's loss, CML's and KMCLR's whole ``train_step``), KMCLR's
epoch hook against its single run, and the mesh's global norm.

The ranks run ``parallel.checks.model_step``, ``checks.kmclr_hook`` and
``checks.global_norm`` in one spawn of four.  The JAX side is the
single-device model on the multi-behavior bundle of
``tests/test_learning.py::_mb_bundle`` (view and buy; HMGCR's meta paths
are the two behaviors, KMCLR's KG a seeded one) at 301 users × 63 items,
so that every row-sharded table has a padding row; its
parameters are carried across by ``utils.convert``.  The batch is 31 rows,
so the two ``data`` slices differ by one.  Draws are injected as
``tests/test_torch_{mb_models,cml,kmclr}.py`` inject them: stand-ins for
``jax.random``'s functions (and CML's ``sample_negatives``) return the
jitted function's draw arguments while it is traced, in the order it takes
them, and the port takes the same draws by name.

The four run in float64 on both sides, as their single-device tests hold
SMBRec's loss and HMGCR's, CML's and KMCLR's steps: SMBRec's contrast
cancels, HMGCR's GRACE gradients of a tower's deeper weights sum terms of
either sign whose float32 order the partitioned hops change, and the
AdamW's and Adam's first steps
move an entry by about ``lr`` whatever its gradient's size.  Tolerances: the
loss terms rtol 1e-5; the whole gradients (HMGCR, SMBRec) and the tables
and optimizer moments after the step (CML, KMCLR) rtol 2e-4 with atol 1e-5
of the largest entry, as ``test_torch_mesh_kg_step.py`` holds item 8a's.
KMCLR's hook on the mesh against the same hook on one device in each rank
(float64): the KG tables and the KG Adam's moments rtol 1e-9 (atol 1e-12:
the GAT's output bias takes a gradient of float64 noise, the softmax being
blind to a shift), both views' values equal and the KG users it returns to
1e-12.

A gradient left unsummed over ``model`` (CML's round 1 without
``sync_model_grads``), a meta net's batch norm over a ``data`` slice alone,
or the mesh norm without the ``model`` sum of its squares fails these.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu.models.multi_behavior import cml as jcml
from sslrec_tpu.models.multi_behavior import kmclr as jkmclr
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu_torch.parallel import checks, launch
from sslrec_tpu_torch.utils import convert
from test_learning import _mb_bundle

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

N_USERS, N_ITEMS, BATCH, META_B, EPOCH, BLOCK = 301, 63, 31, 16, 3, 128
OVERRIDES = {"hmgcr": {"model.hidden_dim": 8},
             "smbrec": {"model.embedding_size": 8},
             "cml": {"model.hidden_dim": 8, "train.batch_size": BATCH,
                     "train.meta_batch": META_B, "train.SSL_batch": 2},
             "kmclr": {"model.embedding_size": 8, "model.latent_dim_rec": 8,
                       "train.batch_size": BATCH, "train.SSL_batch": 2,
                       "model.bpr_batch_size": 700}}
F64 = {"hmgcr", "smbrec", "cml", "kmclr"}


def _names(name, tree) -> dict:
    """A JAX parameter (or gradient) tree of model ``name`` as numpy arrays
    under the port's names, as ``utils.convert``'s ``<model>_params_from_jax``
    names them, in the tree's precision."""
    if name in ("hmgcr", "smbrec"):
        flat = convert._tree("towers", tree["towers"])
        if name == "smbrec":
            flat.update(convert._tree("", {k: tree[k] for k in
                                           ("cat_trans", "user_trans", "beh_weights")}))
    elif name == "cml":
        flat = convert._tree("", {"gcn": tree["gcn"], "meta_net": tree["meta"]})
    else:
        flat = convert._tree("", tree)
    return {k: np.asarray(v) for k, v in flat.items()}


def kg_triplets(n=600, seed=3):
    """A seeded KG over 101 entities (so that the entity table, with its pad
    row, has 102 rows) and 3 relations, its heads among the items."""
    rng = np.random.default_rng(seed)
    trip = np.stack([rng.integers(0, N_ITEMS, n), rng.integers(0, 3, n),
                     rng.integers(0, 101, n)], 1)
    trip[0] = (0, 2, 100)
    return trip.astype(np.int64)


@functools.lru_cache(maxsize=None)
def mb_split():
    """``_mb_bundle``'s behaviors, matrices and test matrix, read from the
    arguments it hands the JAX bundle's constructor."""
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmb, "bundle_from_behaviors", lambda *a, **k: seen.append(a))
        _mb_bundle(None, n_u=N_USERS, n_i=N_ITEMS)
    _, behaviors, mats, tst = seen[0]
    return behaviors, mats, tst


def _mb(name):
    behaviors, mats, tst = mb_split()
    return {"behaviors": behaviors, "mats": mats, "tst": tst,
            "meta_mats": mats if name == "hmgcr" else None,
            "kg_triplets": kg_triplets() if name == "kmclr" else None}


def _precision(f64):
    return jax.enable_x64(True) if f64 else jax.enable_x64(False)


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    mb = _mb(name)
    cfg = jload_config(name, overrides=OVERRIDES[name])
    jm = jbuild(cfg, jmb.bundle_from_behaviors(cfg, mb["behaviors"], mb["mats"], mb["tst"],
                                              meta_mats=mb["meta_mats"],
                                              kg_triplets=mb["kg_triplets"]))
    params = jm.init_params(jax.random.PRNGKey(0))
    if name in F64:
        with _precision(True):
            params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), params)
    return jm, params


_DRAWS: dict = {}      # the stand-in draws of the JAX function being traced, by function


def _stand_in(mp):
    def pop(fn):
        return lambda *a, **k: _DRAWS[fn].pop(0)

    for fn in ("randint", "uniform", "permutation"):
        mp.setattr(jax.random, fn, pop(fn))
    for mod in (jcml, jkmclr):
        mp.setattr(mod, "sample_negatives", pop("sample_negatives"))
    mp.setattr(jax.random, "bernoulli",
               lambda key, p=0.5, shape=None: _DRAWS["bernoulli"].pop(0) < p)


def _traced(fn):
    """``fn`` jitted with the stand-ins' draws as its last argument."""
    def f(*args):
        *args, draws = args
        _DRAWS.clear()
        _DRAWS.update({k: list(v) for k, v in draws.items()})
        return fn(*args)

    return jax.jit(f)


def _i32(a):
    return np.asarray(a, np.int32)


def _sampler_draws(rng, prefix, n, n_beh, items, with_target, d):
    """CML's sampler draws by the port's names for ``n`` users (the target
    behavior's positive given where ``with_target``)."""
    for b in range(n_beh - 1 if with_target else n_beh):
        d[f"{prefix}glob{b}"] = rng.integers(0, items[b], n)
        d[f"{prefix}off{b}"] = rng.random(n)
    for b in range(n_beh):
        d[f"{prefix}neg{b}"] = rng.integers(0, N_ITEMS, n)


def cml_draws(jm, seed):
    """One CML step's draws by the port's names (the meta net's masks as
    ``U < 0.5``) and JAX's stand-ins' lists in the order ``train_step`` takes
    them."""
    rng = np.random.default_rng(seed)
    nb, h = jm.n_beh, jm.hidden
    items = [int(x.shape[0]) for x in jm._beh_items]
    d = {}
    _sampler_draws(rng, "", BATCH, nb, items, True, d)
    d["meta_idx"] = rng.integers(0, jm.meta_users.shape[0], META_B)
    _sampler_draws(rng, "m", META_B, nb, items, False, d)
    masks = {}
    for r, n in ((1, BATCH), (2, META_B), (3, BATCH)):
        d[f"r{r}.perm"] = rng.permutation(n)
        s = max(n // 10, 1)
        for b in range(nb):
            for k, shape in (("ssl_in", (s, 3 * h // 2)), ("ssl_out", (s,)), ("ssl3", (s, 1)),
                             ("rs_in", (n, 3 * h // 2)), ("rs_out", (n,)), ("rs3", (n, 1))):
                masks[f"r{r}.{k}{b}"] = rng.random(shape)
    jd = {"randint": [_i32(d[f"glob{b}"]) for b in range(nb - 1)] + [_i32(d["meta_idx"])]
          + [_i32(d[f"mglob{b}"]) for b in range(nb)],
          "uniform": [d[f"off{b}"] for b in range(nb - 1)] + [d[f"moff{b}"] for b in range(nb)],
          "sample_negatives": [_i32(d[f"neg{b}"]) for b in range(nb)]
          + [_i32(d[f"mneg{b}"]) for b in range(nb)],
          "permutation": [_i32(d[f"r{r}.perm"]) for r in (1, 2, 3)],
          "bernoulli": list(masks.values())}
    return {**d, **{k: v < 0.5 for k, v in masks.items()}}, jd


def kmclr_draws(jm, seed):
    """One KMCLR step's draws (the sampler's and the InfoNCE's permutation,
    one for both rounds)."""
    rng = np.random.default_rng(seed)
    items = [int(x.shape[0]) for x in jm._beh_items]
    d = {}
    _sampler_draws(rng, "", BATCH, jm.n_beh, items, True, d)
    d["perm"] = rng.permutation(BATCH)
    nb = jm.n_beh
    jd = {"randint": [_i32(d[f"glob{b}"]) for b in range(nb - 1)],
          "uniform": [d[f"off{b}"] for b in range(nb - 1)],
          "sample_negatives": [_i32(d[f"neg{b}"]) for b in range(nb)],
          "permutation": [_i32(d["perm"])] * 2}
    return d, jd


def hook_draws(jm, seed):
    """KMCLR's epoch hook draws by the port's names: the TransR/TATEC
    batches, the views' entity masks and keep uniforms, the contrast steps'
    batches."""
    rng = np.random.default_rng(seed)
    n_trip = int(jm.kg_trip[0].shape[0])
    kg_bsz = min(4096, n_trip)
    d = {}
    for s in range(max(n_trip // kg_bsz, 1)):
        d[f"trip{s}"] = rng.integers(0, n_trip, kg_bsz)
        d[f"trip_neg{s}"] = rng.integers(0, jm.n_entities, kg_bsz)
    for v in range(2):
        for k in ("m1", "m2"):
            d[f"view{v}.{k}"] = rng.random(jm.item_ents.shape) < 0.5
        d[f"view{v}.keep_u"] = rng.random(jm.n_buy)
    for s in range(max(jm.n_buy // jm.bpr_bsz, 1)):
        d[f"bpr{s}"] = rng.integers(0, jm.n_buy, jm.bpr_bsz)
        d[f"bpr_neg{s}"] = rng.integers(0, N_ITEMS, jm.bpr_bsz)
    return d


def _batch(seed, fields):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, N_USERS if k == "user" else N_ITEMS, BATCH).astype(np.int32)
            for k in fields}


def _jax_case(name):
    """The JAX reference of one step on the whole batch and the port's
    ``model_step`` inputs."""
    jm, params = _jax_model(name)
    f64 = name in F64
    whole = _names(name, params)
    inp = {"model": name, "n_data": 2, "n_model": 2, "overrides": OVERRIDES[name],
           "mb": _mb(name), "params": whole, "key": None, "f64": f64}
    key = jax.random.PRNGKey(5)
    if name in ("hmgcr", "smbrec"):
        idx = _batch(3, ("user", "pos", "neg"))
        draws, jd = None, {}
        if name == "smbrec":
            rng = np.random.default_rng(4)
            n_blocks = -(-N_USERS // BLOCK)
            one = [rng.random((BLOCK, jm.samp_pos)) for _ in range(jm.n_beh)]
            draws = {f"co_u{b}": np.tile(u, (n_blocks, 1)) for b, u in enumerate(one)}
            jd = {"uniform": one}
        with _precision(f64), pytest.MonkeyPatch.context() as mp:
            _stand_in(mp)
            (loss, terms), grads = _traced(jax.value_and_grad(jm.loss, has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in idx.items()}, key, jd)
        want = {"terms": {"loss": float(loss), **{k: float(v) for k, v in terms.items()}},
                "grads": _names(name, grads)}
        return want, {**inp, **idx, "draws": draws}
    idx = _batch(3, ("user", "pos"))
    if name == "cml":
        draws, jd = cml_draws(jm, 4)
        aux = {"epoch": EPOCH}
        jaux = {"epoch": jnp.asarray(EPOCH, jnp.float32)}
    else:
        draws, jd = kmclr_draws(jm, 4)
        kg_user = np.random.default_rng(6).standard_normal((N_USERS, 8)) * 0.1
        aux = {"kg_user": kg_user}
        jaux = {"kg_user": jnp.asarray(kg_user), "kg_params": params["kg"]}
    with _precision(True), pytest.MonkeyPatch.context() as mp:
        _stand_in(mp)
        state = jm.init_opt_state(params)
        if name == "cml":   # the learning rates as the step sets them (float32)
            state = {k: jcml._set_chain_lr(v, jnp.float32(1e-3)) for k, v in state.items()}
        params2, state2, jout = _traced(jm.train_step)(
            params, state, {**{k: jnp.asarray(v) for k, v in idx.items()}, "aux": jaux}, key, jd)
    after = _names(name, params2)
    moments = {}
    for opt, st in state2.items():
        if name == "kmclr" and opt != "model":      # the KG Adam: the hook's
            continue
        for kind, tree in (("exp_avg", optax.tree_utils.tree_get(st, "mu")),
                           ("exp_avg_sq", optax.tree_utils.tree_get(st, "nu"))):
            for k, v in _names(name, tree).items():
                if name == "cml" or k.startswith("mb."):    # KMCLR's Adam holds the MB side
                    moments[f"{opt}.{k}.{kind}"] = v
    want = {"terms": {k: float(v) for k, v in jout.items()}, "params": after,
            "moments": moments}
    return want, {**inp, **idx, "aux": aux, "draws": draws}


def _hook_case(n):
    jm, params = _jax_model("kmclr")
    whole = _names("kmclr", params)
    return {"model": "kmclr", "n_data": n, "n_model": n, "overrides": OVERRIDES["kmclr"],
            "mb": _mb("kmclr"), "params": whole, "f64": True, "draws": hook_draws(jm, 9)}


def _norm_case(max_norm):
    rng = np.random.default_rng(11)
    table, weight = rng.standard_normal((7, 3)), rng.standard_normal((3, 2))
    grads = {"table": rng.standard_normal((7, 3)), "weight": rng.standard_normal((3, 2))}
    return {"n_data": 2, "n_model": 2, "table": table, "weight": weight, "grads": grads,
            "max_norm": max_norm}


NORM_CASES = {"fires": 2.0, "holds": 50.0}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax_side, todo = {}, []
    for name in OVERRIDES:
        jax_side[name], inp = _jax_case(name)
        todo.append((name, "model_step", inp))
    todo += [("hook.mesh", "kmclr_hook", _hook_case(2)),
             ("hook.single", "kmclr_hook", _hook_case(1))]
    todo += [(f"norm.{k}", "global_norm", _norm_case(v)) for k, v in NORM_CASES.items()]
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("mb18")))
    return jax_side, out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_mesh_step_matches_jax(ranks, name):
    """One {2, 2} step against JAX on the whole batch: the loss terms, and the
    whole gradients (HMGCR, SMBRec) or the whole tables and both optimizers'
    moments after CML's three rounds and KMCLR's two."""
    jax_side, out = ranks
    want = jax_side[name]
    for r in out:
        got = r[name]
        assert all(s[0] < (N_USERS if "user" in k else N_ITEMS)
                   for k, s in got["local_shapes"].items()), got["local_shapes"]
        assert set(got["terms"]) == set(want["terms"])
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-5, err_msg=f"{name}: {k}")
        for part in ("grads", "params", "moments"):
            if part not in want:
                continue
            assert set(got[part]) == set(want[part]), part
            for k, v in want[part].items():
                g = got[part][k]
                if g is None:       # unread by the loss (the towers' user tables)
                    assert not v.any(), f"{name}: {k}"
                    continue
                _close(g, v, f"{name}: {part} {k}")


def test_kmclr_hook_matches_single_run(ranks):
    """KMCLR's epoch hook on the {2, 2} mesh against the same hook on one
    device, in every rank: the KG tables (sharded and replicated), the KG
    Adam's moments, both views' values and the KG users."""
    _, out = ranks
    for r in out:
        got, want = r["hook.mesh"], r["hook.single"]
        for part in ("params", "moments"):
            assert set(got[part]) == set(want[part]) and want[part]
            for k, v in want[part].items():
                np.testing.assert_allclose(got[part][k], v, rtol=1e-9, atol=1e-12,
                                           err_msg=f"{part} {k}")
        assert len(got["views"]) == 2
        for g, v in zip(got["views"], want["views"]):
            np.testing.assert_array_equal(g, v)
            assert 0 < int((v == 0).sum()) < v.size
        np.testing.assert_allclose(got["kg_user"], want["kg_user"], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_global_norm_on_the_mesh(ranks, case):
    """``dist_train.global_norm`` over a row-sharded table and a replicated
    weight on the {2, 2} mesh: the single run's norm (the table's squares
    summed over ``model``, the weight's counted once), and the clip, where
    it fires, the single run's."""
    _, out = ranks
    inp = _norm_case(NORM_CASES[case])
    g = inp["grads"]
    norm = np.sqrt((g["table"] ** 2).sum() + (g["weight"] ** 2).sum())
    scale = inp["max_norm"] / norm if norm >= inp["max_norm"] else 1.0
    assert (scale < 1.0) == (case == "fires")
    for r in out:
        got = r[f"norm.{case}"]
        np.testing.assert_allclose(got["norm"], norm, rtol=1e-12)
        assert got["clipped"] == (case == "fires")
        for k in ("table", "weight"):
            np.testing.assert_allclose(got[k], g[k] * scale, rtol=1e-12)
