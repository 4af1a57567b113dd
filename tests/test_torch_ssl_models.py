"""The port's self-supervised general_cf models (SGL, SimGCL, DirectAU, NCL,
LightGCL, HCCF, DCCF) against the JAX package on one small graph: weights
carried across by ``convert``, ``generate()``, the loss and every parameter
gradient under the same draws, and three Adam steps against optax.  SGL runs
in all three augmentations and LightGCL with and without edge dropout.  The
cases are split between this file and ``test_torch_ssl_models_b.py``.

Random draws: the dropout PRF is bit-exact in both packages once JAX's
``edge_drop`` on a CooGraph is made to return the PRF mask its accelerator
path uses (the ``prf_edge_drop`` fixture; the port's LightGCL numbers the
transposed graph's edges in Â's order, so JAX's Âᵀ mask is read at those
ids).  Every other draw (SimGCL's noise, HCCF's hyper-table dropout and
per-layer keys, SGL's node drop, NCL's clusters) JAX makes from the step key
as the JAX model would, and the port takes through its ``draws`` argument.

Tolerances: rtol 1e-5, atol 1e-7 for one forward and backward pass (float
sums taken in another order).  Gradients take atol 1e-6 times the largest
entry of the tensor where that is larger: an entry near zero there is the
cancellation of terms of that size, whose float32 rounding the 1/temperature
in front of every logit multiplies (HCCF's largest entries are about 2).
rtol 1e-4, atol 1e-6 after three Adam steps, which divide by √v and so
magnify those differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.models import augment as jaugment
from sslrec_tpu.models.general_cf.dccf import DCCF as JDCCF
from sslrec_tpu.models.general_cf.directau import DirectAU as JDirectAU
from sslrec_tpu.models.general_cf.hccf import HCCF as JHCCF
from sslrec_tpu.models.general_cf.lightgcl import LightGCL as JLightGCL
from sslrec_tpu.models.general_cf.ncl import NCL as JNCL
from sslrec_tpu.models.general_cf.sgl import SGL as JSGL
from sslrec_tpu.models.general_cf.simgcl import SimGCL as JSimGCL
from sslrec_tpu.ops.pallas_spmm import _prf_uniform as j_prf_uniform
from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils import convert
from test_torch_lightgcn import _batch, _keys, _mats

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-7

# case: (config name, JAX class, config overrides, scale of the init weights)
CASES = {
    "sgl": ("sgl", JSGL, {}, 1.0),
    "sgl_random_walk": ("sgl", JSGL, {"model.augmentation": "random_walk"}, 1.0),
    "sgl_node_drop": ("sgl", JSGL, {"model.augmentation": "node_drop"}, 1.0),
    "simgcl": ("simgcl", JSimGCL, {}, 1.0),
    "directau": ("directau", JDirectAU, {}, 1.0),
    "ncl": ("ncl", JNCL, {"model.cluster_num": 8}, 1.0),
    "lightgcl": ("lightgcl", JLightGCL, {}, 1.0),
    "lightgcl_dropout": ("lightgcl", JLightGCL, {"model.dropout": 0.25}, 1.0),
    # Xavier tables of 60 and 40 rows are some 40 times those of a real
    # dataset's; HCCF's hypergraph branch (leaky 1, mult 1) then drives the
    # BPR sigmoid to its 1e-12 floor, where float32 gradients carry rounding
    # of 2e-4 of their largest entry in either package.  A tenth of them
    # keeps the sigmoid in range.
    "hccf": ("hccf", JHCCF, {}, 0.1),
    "dccf": ("dccf", JDCCF, {}, 1.0),
}


@pytest.fixture
def prf_edge_drop(monkeypatch):
    """JAX's edge_drop on a CooGraph made to return the PRF mask of its
    accelerator path, salts and rescaling included; ``relabel[id(g)]`` gives
    the edge ids to evaluate the PRF at for a graph ``g`` (default: its own
    order)."""
    relabel = {}

    def edge_drop(key, g, keep_rate, resize_val=False, salts=0):
        if keep_rate >= 1.0:
            return None
        ids = relabel.get(id(g), jnp.arange(g.nnz, dtype=jnp.uint32))

        def one(salt):
            keep = jnp.floor(j_prf_uniform(key, ids, salt) + jnp.float32(keep_rate))
            return keep / jnp.float32(keep_rate) if resize_val else keep

        if jnp.ndim(salts) == 0:
            return one(salts)
        return jnp.stack([one(int(s)) for s in np.asarray(salts)])

    monkeypatch.setattr(jaugment, "edge_drop", edge_drop)
    return relabel


def make_pair(case, tiny_bundle, relabel):
    """(case, JAX model, its init params, the port's model carrying them, the
    port's data, both configs)."""
    name, jcls, ov, scale = CASES[case]
    jcfg, tcfg = jload_config(name, overrides=ov), tload_config(name, overrides=ov)
    jmodel = jcls(jcfg, tiny_bundle)
    params = jax.tree.map(lambda p: p * scale, jmodel.init_params(jax.random.PRNGKey(0)))
    tdata = tbundle(*_mats())
    tmodel = build_model(tcfg, tdata)
    tmodel.load_state_dict(getattr(convert, f"{name}_params_from_jax")(jax.device_get(params)))
    if name == "lightgcl":
        # the same SVD factors on both sides (the SVD itself is held to JAX
        # in test_torch_ssl_ops.py); JAX's Âᵀ read at Â's edge ids
        for k in ("ut", "vt", "u_mul_s", "v_mul_s"):
            setattr(tmodel, k, torch.from_numpy(np.array(getattr(jmodel, k))))
        relabel[id(jmodel.adj_t)] = jnp.asarray(tmodel.adj.bwd.edge_ids.numpy().astype(np.uint32))
    return case, jmodel, params, tmodel, tdata, jcfg, tcfg


@pytest.fixture(params=["sgl", "sgl_random_walk", "sgl_node_drop", "simgcl", "directau"])
def pair(request, tiny_bundle, prf_edge_drop):
    """The models that propagate as LightGCN does; the others are in
    ``test_torch_ssl_models_b.py``, so that xdist spreads the two files."""
    return make_pair(request.param, tiny_bundle, prf_edge_drop)


def _draws(case, jmodel, params, jkey):
    """The JAX model's draws under ``jkey`` beyond the dropout PRF: extra
    batch entries for both packages, and the port's ``draws`` (or None)."""
    n = jmodel.user_num + jmodel.item_num
    if case == "sgl_node_drop":
        return {}, {"node_u": torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(k, (n, 1))) for k in jax.random.split(jkey)]))}
    if case == "simgcl":
        L = jmodel.layer_num
        keys = jax.random.split(jkey, 2 * L).reshape(2, L, 2)
        return {}, {"noise": torch.from_numpy(np.stack([[np.asarray(jax.random.uniform(
            keys[v, l], (n, jmodel.embedding_size))) for l in range(L)] for v in range(2)]))}
    if case == "hccf":
        rate = 1.0 - jmodel.keep_rate
        layers = [jax.random.split(k, 3) for k in jax.random.split(jkey, jmodel.layer_num)]
        h = jmodel.hyper_num

        def keep(i, rows):
            return torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
                ks[i], 1.0 - rate, (rows, h))) for ks in layers]))

        return {}, {"edge_keys": torch.from_numpy(np.stack(
                        [np.asarray(ks[0]).astype(np.int64) for ks in layers])),
                    "keep_u": keep(1, jmodel.user_num), "keep_i": keep(2, jmodel.item_num)}
    if case == "ncl":
        aux = jax.device_get(jmodel.epoch_state_fn(params, jkey))
        return {"aux": aux}, None
    return {}, None


def _step_inputs(case, jmodel, params, tdata, seed):
    jbatch, tbatch = _batch(tdata.user_num, tdata.item_num, seed)
    jkey, tkey = _keys(seed)
    extra, draws = _draws(case, jmodel, params, jkey)
    jbatch = {**jbatch, **extra}
    tbatch = {**tbatch, **{k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                           for k, v in extra.items()}}
    return jbatch, tbatch, jkey, tkey, draws


def test_generate_matches_jax(pair):
    case, jmodel, params, tmodel, *_ = pair
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)


def test_loss_and_grads_match_jax(pair):
    case, jmodel, params, tmodel, tdata, *_ = pair
    jbatch, tbatch, jkey, tkey, draws = _step_inputs(case, jmodel, params, tdata, 1)
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jbatch, jkey)
    tloss, taux = tmodel.loss(tbatch, tkey, **({} if draws is None else {"draws": draws}))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=RTOL, atol=ATOL)
    flat = {**{k: v for k, v in jgrads.items() if k != "ws"},
            **{f"ws.{i}": w for i, w in enumerate(jgrads.get("ws", []))}}
    names = [name for name, _ in tmodel.named_parameters()]
    assert sorted(names) == sorted(flat)
    for name, p in tmodel.named_parameters():
        want = np.asarray(flat[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=RTOL,
                                   atol=max(ATOL, 1e-6 * float(np.abs(want).max())),
                                   err_msg=f"{case}: {name}")


def test_adam_steps_match_optax(pair):
    case, jmodel, params, tmodel, tdata, jcfg, tcfg = pair
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tmodel, tdata)
    for step in range(3):
        jbatch, tbatch, jkey, tkey, draws = _step_inputs(case, jmodel, params, tdata,
                                                         10 + step)
        (jloss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, jbatch, jkey)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        if draws is not None:
            tmodel.step_draws = lambda gen, d=draws: d
        aux = trainer.train_step(tbatch, tkey)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-4)
    want = {**{k: v for k, v in params.items() if k != "ws"},
            **{f"ws.{i}": w for i, w in enumerate(params.get("ws", []))}}
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=f"{case}: {name}")


def test_ncl_epoch_state_matches_jax(tiny_bundle, prf_edge_drop):
    """NCL's clusters from the same initial rows (JAX's picks under the epoch
    key), re-made every ``epoch_period`` epochs and kept in between."""
    _, jmodel, params, tmodel, *_ = make_pair("ncl", tiny_bundle, prf_edge_drop)
    key = jax.random.PRNGKey(5)
    want = jax.device_get(jmodel.epoch_state(params, key, 0))
    C = jmodel.cluster_num
    picks = {name: torch.from_numpy(np.array(jax.random.choice(k, n, (C,), replace=n < C)))
             for name, k, n in zip(("user", "item"), jax.random.split(key),
                                   (jmodel.user_num, jmodel.item_num))}
    got = tmodel.epoch_state(None, 0, draws=picks)
    for k in ("user2cluster", "item2cluster"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in ("user_centroids", "item_centroids"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL, atol=1e-6)
    assert tmodel.epoch_state(torch.Generator().manual_seed(0), 1) is got
    again = tmodel.epoch_state(torch.Generator().manual_seed(0), jmodel.epoch_period)
    assert again is not got and again["user_centroids"].shape == got["user_centroids"].shape
