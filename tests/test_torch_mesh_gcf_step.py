"""DCCF, HCCF, LightGCL, AutoCF, GFormer, AdaGCL and MBGMN on a {data: 2,
model: 2} mesh of gloo processes: one step of each against the JAX package
on one device (``value_and_grad`` of the loss; AdaGCL's whole four-phase
``train_step``, ``sslrec_tpu/models/general_cf/adagcl.py:214``).

The ranks run ``parallel.checks.model_step`` for the seven in one spawn of
four.  Each rank holds a row shard of the model's user and item tables and
reads them whole, so every hop runs on the whole graph in every rank.  The
six general_cf models train on a seeded split of 61 users × 41 items, and
MBGMN on the multi-behavior split of
``test_torch_mesh_mb_step.py`` (301 × 63), so that every row-sharded table
has a padding row; the batch has 31 rows, so the two ``data`` slices differ
by one (DCCF's CL and AdaGCL's graphcl gather them padded).

Draws are injected: HCCF's dropout PRF bit for bit (JAX's ``edge_drop``
made to return its accelerator path's mask, as ``test_torch_ssl_models.py``
does) and its hyper-table masks from JAX's step key; LightGCL's SVD factors
are JAX's; AutoCF's and GFormer's view banks are made in each rank by
``epoch_state`` from JAX's per-view draws (``test_torch_{autocf,gformer}.py``);
AdaGCL's normals and hard-concrete uniforms from JAX's step key; MBGMN's
users, offsets, negatives and fallbacks by name, JAX's through stand-ins
for ``jax.random``'s functions while its loss is traced.  MBGMN runs with
its hinge in the gradient (``detach_pre_loss`` off), so that the meta
layers train too.

All seven run in float64 on both sides (JAX under ``jax.enable_x64``, the
port's model in double; the graphs' values stay float32 on both sides), so
that the comparison sees the mesh and not float32 rounding, which the
contrasts' 1/temperature and Adam's first step (an entry moves by about
``lr`` whatever its gradient's size) magnify.  Tolerances: the loss terms
rtol 1e-6 (the Trainer's ``reduce_terms`` carries them in float32); the
whole gradients (summed over ``data``, gathered over
``model``), and AdaGCL's whole tables and layers after its five Adam
updates, rtol 1e-5 with atol 1e-7 of the tensor's largest entry: the
graphs' values and some of the models' constants stay float32 on both sides
and are rounded apart in places (AutoCF's gradients then differ by up to
3e-6 of an entry, 2e-8 of the largest), far below what a missing sum moves
(a whole ``data`` slice's or ``model`` shard's share).

DCCF's CL or AdaGCL's graphcl on a ``data`` slice alone, an AdaGCL phase
without ``sync_model_grads``, or a row-sharded L2 not summed over ``model``
fails these.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_ui_matrix
from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import multi_behavior as jmb
from sslrec_tpu.data.general_cf import bundle_from_matrices as jbundle
from sslrec_tpu.models import augment as jaugment
from sslrec_tpu.models.multi_behavior import mbgmn as jmbgmn
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu.ops.pallas_spmm import _prf_uniform as j_prf_uniform
from sslrec_tpu_torch.parallel import checks, launch
from sslrec_tpu_torch.utils import convert
from test_torch_mesh_mb_step import mb_split
from test_torch_ssl_models import _draws as ssl_draws

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

N_USERS, N_ITEMS, BATCH, N_BATCHES = 61, 41, 31, 3
OVERRIDES = {"lightgcl": {"model.embedding_size": 16},
             "hccf": {"model.embedding_size": 16, "model.hyper_num": 8},
             "dccf": {"model.embedding_size": 16, "model.intent_num": 8},
             "autocf": {"model.embedding_size": 16, "model.fix_steps": 2, "model.seed_num": 5},
             "gformer": {"model.embedding_size": 16, "model.fix_steps": 2},
             "adagcl": {"model.embedding_size": 16},
             "mbgmn": {"model.embedding_size": 8, "model.sampNum": 8,
                       "model.detach_pre_loss": False}}
# HCCF's init tables at a tenth (test_torch_ssl_models.py: a tiny split's
# Xavier tables drive its BPR sigmoid to the 1e-12 floor)
SCALE = {"hccf": 0.1}
STEP = {"autocf": 2, "gformer": 2}      # a regenerating step (AutoCF's infomax term on)
TERMS_RTOL, RTOL, ATOL_REL = 1e-6, 1e-5, 1e-7


@functools.lru_cache(maxsize=None)
def mats():
    return (random_ui_matrix(N_USERS, N_ITEMS, seed=11),
            random_ui_matrix(N_USERS, N_ITEMS, density=0.03, seed=12),
            random_ui_matrix(N_USERS, N_ITEMS, density=0.03, seed=13))


def _x64():
    return jax.enable_x64(True)


def _patch_edge_drop(mp):
    """JAX's ``edge_drop`` on a CooGraph made to return its accelerator path's
    PRF mask (``test_torch_ssl_models.prf_edge_drop``), which the port draws."""
    def edge_drop(key, g, keep_rate, resize_val=False, salts=0):
        if keep_rate >= 1.0:
            return None
        keep = jnp.floor(j_prf_uniform(key, jnp.arange(g.nnz, dtype=jnp.uint32), salts)
                         + jnp.float32(keep_rate))
        return keep / jnp.float32(keep_rate) if resize_val else keep

    mp.setattr(jaugment, "edge_drop", edge_drop)


def _jax_model(name):
    cfg = jload_config(name, overrides=OVERRIDES[name])
    if name == "mbgmn":
        behaviors, bmats, tst = mb_split()
        data = jmb.bundle_from_behaviors(cfg, behaviors, bmats, tst)
    else:
        data = jbundle(*mats())
    jm = jbuild(cfg, data)
    params = jm.init_params(jax.random.PRNGKey(0))
    with _x64():
        params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64) * SCALE.get(name, 1.0),
                              params)
    return jm, params


def _names(name, tree) -> dict:
    """A JAX parameter (or gradient) tree as numpy arrays under the port's
    names, as ``utils.convert``'s ``<model>_params_from_jax`` names them, in
    the tree's own precision (``convert`` itself takes float32 alone)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_state", lambda flat: {k: np.asarray(v) for k, v in flat.items()})
        return getattr(convert, f"{name}_params_from_jax")(
            jax.tree.map(np.asarray, jax.device_get(tree)))


def _batch(name, seed=3):
    rng = np.random.default_rng(seed)
    n_u, n_i = (301, 63) if name == "mbgmn" else (N_USERS, N_ITEMS)
    return {k: rng.integers(0, n_u if k == "user" else n_i, BATCH).astype(np.int32)
            for k in ("user", "pos", "neg")}


def _view_draws(name, jm, key):
    """AutoCF's or GFormer's per-view draws under the epoch ``key``, as JAX's
    ``epoch_state`` makes them (``test_torch_autocf.py``,
    ``test_torch_gformer.py``)."""
    out = []
    for k in jax.random.split(key, -(-N_BATCHES // jm.fix_steps)):
        if name == "autocf":
            k1, k2, k3, k4 = jax.random.split(k, 4)
            n, nnz = jm.n_nodes, jm.nnz
            out.append({"noise": jax.random.uniform(k1, (n,), minval=1e-8, maxval=1.0),
                        "sample_u": jax.random.uniform(k2, (n,)),
                        "rows_u": jax.random.uniform(k3, (nnz,)),
                        "cols_u": jax.random.uniform(k4, (nnz,))})
            continue
        ks = jax.random.split(k, 9)

        def gumbel_u(kk):
            return jax.random.uniform(kk, (jm.nnz_aug,), minval=1e-9, maxval=1.0)

        out.append({"anchors": jax.random.choice(ks[0], jm.n_nodes, (jm.anchor_num,),
                                                 replace=False),
                    "add_rows": jax.random.randint(ks[1], (jm.n_add,), 0, jm.nnz),
                    "add_cols": jax.random.randint(ks[2], (jm.n_add,), 0, jm.nnz),
                    "keep_u": gumbel_u(ks[3]), "sub_u": gumbel_u(ks[4]),
                    "cmp_u": gumbel_u(ks[5]),
                    "dec_u": jax.random.uniform(ks[6], (int(jm.nnz * jm.re_rate),))})
    return [{k: np.asarray(v) for k, v in d.items()} for d in out]


def _adagcl_draws(jm, key):
    """AdaGCL's step draws under ``key`` (``test_torch_adagcl._draws``)."""
    kv, _, _, kdn = jax.random.split(key, 4)
    shape = (jm.n_nodes, jm.embedding_size)
    (kz,) = jax.random.split(kv, 1)
    us, k = [], kdn
    for _ in range(min(jm.layer_num, 2)):
        k, sub = jax.random.split(k)
        us.append(jax.random.uniform(sub, (jm.nnz,), minval=1e-7, maxval=1 - 1e-7))
    return {"view_noise": np.asarray(jax.random.normal(kv, shape)),
            "vgae_noise": np.asarray(jax.random.normal(kz, shape)),
            "gate_u": np.stack([np.asarray(u) for u in us])}


_DRAWS: dict = {}


def _mbgmn_draws(jm, seed=4):
    """MBGMN's draws by the port's names for the whole batch, and JAX's
    stand-ins' lists in the order its loss takes them."""
    rng = np.random.default_rng(seed)
    s = jm.samp_num
    d = {"users": rng.integers(0, jm.user_num, BATCH)}
    for b in range(jm.n_beh):
        d[f"pos_u{b}"] = rng.random((BATCH, s))
        d[f"neg{b}"] = rng.integers(0, jm.item_num, (BATCH, s))
        d[f"fallback{b}"] = rng.integers(0, jm.item_num, (BATCH, 1))
    n = jm.n_beh
    jd = {"randint": [d["users"], *[d[f"fallback{b}"] for b in range(n)]],
          "uniform": [d[f"pos_u{b}"] for b in range(n)],
          "sample_negatives": [d[f"neg{b}"].reshape(-1) for b in range(n)]}
    return d, jd


def _jax_case(name):
    """The JAX reference of one step on the whole batch (float64), and the
    port's ``model_step`` inputs."""
    jm, params = _jax_model(name)
    idx = _batch(name)
    inp = {"model": name, "n_data": 2, "n_model": 2, "overrides": OVERRIDES[name],
           "params": _names(name, params), "f64": True, "key": None,
           "step": STEP.get(name, 0), "n_batches": N_BATCHES, **idx}
    if name == "mbgmn":
        behaviors, bmats, tst = mb_split()
        inp["mb"] = {"behaviors": behaviors, "mats": bmats, "tst": tst}
    else:
        inp.update(zip(("trn", "val", "tst"), (m.toarray() for m in mats())))
    key = jax.random.PRNGKey(9)
    with _x64(), pytest.MonkeyPatch.context() as mp:
        _patch_edge_drop(mp)
        jbatch = {k: jnp.asarray(v) for k, v in idx.items()}
        if name == "adagcl":
            jbatch["aux"] = jm.epoch_state(params, None, 4)
            inp["aux"] = {"temperature": float(jbatch["aux"]["temperature"])}
            inp["draws"] = _adagcl_draws(jm, key)
            after, _, jout = jax.jit(jm.train_step)(params, jm.init_opt_state(params), jbatch,
                                                    key)
            return {"terms": {k: float(v) for k, v in jout.items()},
                    "params": _names(name, after)}, inp
        extra = {}
        if name in ("autocf", "gformer"):
            jm._n_batches_hint = N_BATCHES
            ekey = jax.random.PRNGKey(5)
            extra = {"step": inp["step"], "aux": jm.epoch_state(params, ekey, 0)}
            inp["epoch_draws"] = _view_draws(name, jm, ekey)
        if name == "hccf":
            _, draws = ssl_draws("hccf", jm, params, key)
            inp["draws"] = {k: v.numpy() for k, v in draws.items()}
        if name == "lightgcl":          # JAX's SVD factors (the port's own start differs)
            inp["attrs"] = {k: np.asarray(getattr(jm, k))
                            for k in ("ut", "vt", "u_mul_s", "v_mul_s")}
        jd = {}
        if name == "mbgmn":
            inp["draws"], jd = _mbgmn_draws(jm)
            for where, fn in ((jax.random, "randint"), (jax.random, "uniform"),
                              (jmbgmn, "sample_negatives")):
                mp.setattr(where, fn, lambda *a, _fn=fn, **k: _DRAWS[_fn].pop(0))

        def loss_fn(p, b, a, draws):
            # traced once: MBGMN's stand-ins hand out ``draws`` in call order
            _DRAWS.clear()
            _DRAWS.update({k: list(v) for k, v in draws.items()})
            return jax.value_and_grad(jm.loss, has_aux=True)(
                p, {**b, "step": extra.get("step", 0), "aux": a}, key)

        (loss, terms), grads = jax.jit(loss_fn)(params, jbatch, extra.get("aux"), jd)
    want = {"terms": {"loss": float(loss), **{k: float(v) for k, v in terms.items()}},
            "grads": _names(name, grads)}
    return want, inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax_side, todo = {}, []
    for name in OVERRIDES:
        jax_side[name], inp = _jax_case(name)
        todo.append((name, "model_step", inp))
    out = launch.spawn(checks.run, (todo,), 4, root=str(tmp_path_factory.mktemp("gcf19")))
    return jax_side, out


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_mesh_step_matches_jax(ranks, name):
    """One {2, 2} step against JAX on the whole batch: the loss terms, and the
    whole gradients (AdaGCL: the whole tables and layers after its five
    updates), in every rank; each rank holds half of each table's rows."""
    jax_side, out = ranks
    want = jax_side[name]
    tables = {"u_embed", "i_embed"} if name == "mbgmn" else {"user_embeds", "item_embeds"}
    n_u, n_i = (301, 63) if name == "mbgmn" else (N_USERS, N_ITEMS)
    for r in out:
        got = r[name]
        assert {k: s[0] for k, s in got["local_shapes"].items()} == {
            k: -(-(n_u if k.startswith("u") else n_i) // 2) for k in tables}
        assert set(got["terms"]) == set(want["terms"])
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=TERMS_RTOL,
                                       err_msg=f"{name}: {k}")
        part = "params" if name == "adagcl" else "grads"
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            assert got[part][k] is not None, f"{name}: {k} has no gradient"
            assert got[part][k].dtype == np.float64
            np.testing.assert_allclose(got[part][k], v, rtol=RTOL,
                                       atol=ATOL_REL * max(np.abs(v).max(), 1e-30),
                                       err_msg=f"{name}: {part} {k}")
