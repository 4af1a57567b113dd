"""The port's DCRec_seq and MAERec against the JAX package on the JAX
sequential tests' small split: weights carried across by ``convert``,
``generate()``, DCRec_seq's loss and every parameter gradient (also under a
batch's ``hp`` overrides of its ``hparams()``), MAERec's mask bank, its own
``train_step`` (losses and gradients, then three steps with its Adam and
the loss history it carries), and DCRec_seq's three Adam steps against
optax.  Every item-graph sum of both runs through B1's wrapper (its plain
version on the CPU).

Random draws: JAX makes them from the key as its model does (the GCN's and
the towers' dropout, the KL normals; MAERec's path keeps, Gumbel uniforms,
thinning, edge uniforms and negative rounds), and the port takes them by
name.

Tolerances: rtol 1e-5, atol 1e-6 for one forward and backward pass; a
gradient takes atol 1e-6 times the largest entry of its tensor where that is
larger; rtol 1e-4, atol 1e-6 after three Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sslrec_tpu.trainer.trainer import build_optimizer as jbuild_optimizer
from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
from sslrec_tpu_torch.trainer.trainer import Trainer, build_optimizer
from sslrec_tpu_torch.utils import convert
from test_torch_seq_data import make_pair
from test_torch_seq_layers import grad_close, t, tower_masks
from test_torch_seq_models import batches

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6


def _keep(key, p, shape):
    return t(jax.random.bernoulli(key, p, shape))


# -- DCRec_seq -----------------------------------------------------------------

@pytest.fixture(scope="module")
def dcrec():
    return make_pair("dcrec_seq")


def dcrec_draws(jmodel, seqs, key) -> dict:
    ks = jax.random.split(key, 8)
    n, d, p = jmodel.n_items1, jmodel.emb_size, 1 - jmodel.graph_dropout
    out = {}
    for name, k, nnz in (("adj", ks[0], jmodel.adj[0].shape[0]),
                         ("sim", ks[1], jmodel.sim[0].shape[0]),
                         ("aug", ks[2], jmodel.adj[0].shape[0])):
        k, kd = jax.random.split(k)
        _, kg, kl = jax.random.split(k, 3)
        out.update({f"{name}.emb_keep": _keep(kd, 1 - jmodel.dropout_rate, (n, d)),
                    f"{name}.edge_keep": _keep(kg, p, (nnz,)),
                    f"{name}.loop_keep": _keep(kl, p, (n,))})
    b, l = seqs.shape
    for name, k in (("drop", ks[3]), ("drop_aug", ks[4])):
        out[name] = tower_masks(k, jmodel.n_layers, jmodel.dropout_rate, b, l, d,
                                jmodel.n_heads)
    out["kl_normal"] = t(jax.random.normal(ks[5], (b,)))
    return out


def test_dcrec_convert_and_generate(dcrec):
    jmodel, params, tmodel, *_ = dcrec
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(
        convert.dcrec_seq_params_from_jax(jax.device_get(params)))
    ju, ji = jmodel.generate(params)
    with torch.no_grad():
        tu, ti = tmodel.generate()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hp", [None, {"cl_lambda": 0.5, "weight_mean": 0.6}],
                         ids=["config", "hp"])
def test_dcrec_loss_and_grads_match_jax(dcrec, hp):
    jmodel, params, tmodel, jdata, *_ = dcrec
    assert tmodel.hparams() == {"cl_lambda": jmodel.cl_lambda, "weight_mean": jmodel.weight_mean}
    jb, tb = batches("dcrec_seq", jmodel, jdata, 2)
    if hp is not None:
        jb = {**jb, "hp": {k: jnp.float32(v) for k, v in hp.items()}}
        tb = {**tb, "hp": hp}
    key = jax.random.PRNGKey(5)
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb, key)
    tmodel.load_state_dict(convert.dcrec_seq_params_from_jax(jax.device_get(params)))
    tmodel.zero_grad(set_to_none=True)
    tloss, taux = tmodel.loss(tb, None, dcrec_draws(jmodel, jb["seq"], key))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    want = convert.dcrec_seq_params_from_jax(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        if p.grad is None:      # cl_fc1/cl_fc2 take no part in the loss, in JAX too
            assert not np.asarray(want[name]).any(), name
            continue
        grad_close(p.grad.numpy(), want[name].numpy(), f"dcrec_seq: {name}")


def test_dcrec_adam_steps_match_optax(dcrec):
    jmodel, params, tmodel, jdata, tdata, jcfg, tcfg = dcrec
    tmodel.load_state_dict(convert.dcrec_seq_params_from_jax(jax.device_get(params)))
    opt = jbuild_optimizer(jcfg)
    opt_state = opt.init(params)
    trainer = Trainer(tcfg, tmodel, tdata)
    for step in range(3):
        jb, tb = batches("dcrec_seq", jmodel, jdata, 40 + step)
        key = jax.random.PRNGKey(50 + step)
        (jloss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        draws = dcrec_draws(jmodel, jb["seq"], key)
        tmodel.draws = lambda gen, given=None, d=draws: StepDraws(None, d, "cpu")
        aux = trainer.train_step(tb, None)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-4)
    del tmodel.draws
    want = convert.dcrec_seq_params_from_jax(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# -- MAERec ----------------------------------------------------------------------

N_BATCHES = 3


@pytest.fixture(scope="module")
def maerec():
    jmodel, params, tmodel, jdata, tdata, jcfg, tcfg = make_pair("maerec")
    jmodel._n_batches_hint = tmodel._n_batches_hint = N_BATCHES
    return jmodel, params, tmodel, jdata, tdata, jcfg, tcfg


def path_draws(jmodel, key) -> dict:
    out = {}
    for i in range(jmodel.mask_depth):
        key, sub = jax.random.split(key)
        out[f"path_keep{i}"] = _keep(sub, jmodel.path_prob ** (i + 1), (jmodel.nnz,))
    key, sub = jax.random.split(key)
    out["path_u"] = t(jax.random.uniform(sub, (jmodel.n_items1,), minval=1e-8, maxval=1.0))
    return out


def view_draws(jmodel, key, n_views) -> list:
    views = []
    for k in jax.random.split(key, n_views):
        k1, k2 = jax.random.split(k)
        d = path_draws(jmodel, k1)
        for i in range(jmodel.mask_depth - 1):
            d[f"thin{i}"] = _keep(jax.random.fold_in(k2, i), jmodel.path_prob ** (i + 1),
                                  (jmodel.n_items1,))
        views.append(d)
    return views


def step_draws(jmodel, seqs, key) -> dict:
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    half = jmodel.num_reco_neg // 2
    n = jmodel.con_batch * half
    b, l = seqs.shape
    return {"edge_u": t(jax.random.uniform(k1, (jmodel.con_batch,))),
            "vneg": t(jax.random.randint(k2, (6, n), 1, jmodel.n_items1, dtype=jnp.int32)),
            "uneg": t(jax.random.randint(k3, (6, n), 1, jmodel.n_items1, dtype=jnp.int32)),
            "drop": tower_masks(k4, jmodel.num_trm_layers, jmodel.dropout_rate, b, l,
                                jmodel.emb_size, jmodel.n_heads),
            **path_draws(jmodel, k5)}


@pytest.fixture(scope="module")
def maerec_views(maerec):
    jmodel, params, tmodel, *_ = maerec
    key = jax.random.PRNGKey(8)
    n_views = -(-N_BATCHES // jmodel.mask_steps)
    return jmodel.epoch_state(params, key, 0), tmodel.epoch_state(
        None, 0, draws=view_draws(jmodel, key, n_views))


def test_maerec_convert_and_generate(maerec):
    jmodel, params, tmodel, *_ = maerec
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(
        convert.maerec_params_from_jax(jax.device_get(params)))
    ju, ji = jmodel.generate(params)
    with torch.no_grad():
        tu, ti = tmodel.generate()
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)


def test_maerec_mask_bank_matches_jax(maerec, maerec_views):
    jaux, taux = maerec_views
    assert taux["masked"].shape == (2, maerec[0].nnz)
    np.testing.assert_array_equal(taux["masked"].numpy(), np.asarray(jaux["masked"]))
    np.testing.assert_allclose(taux["enc_vals"].numpy(), np.asarray(jaux["enc_vals"]),
                               rtol=RTOL, atol=ATOL)
    assert 0 < float(taux["masked"].mean()) < 1


def _maerec_batch(jmodel, jdata, jaux, seed, step):
    jb, tb = batches("maerec", jmodel, jdata, seed)
    jb = {**jb, "step": jnp.asarray(step), "aux": jaux}
    tb = {**tb, "step": step, "aux": {k: t(v) for k, v in jaux.items()}}
    return jb, tb


class _Recorder:
    """An optax transformation that keeps the gradients and changes nothing."""

    def __init__(self):
        self.grads = None

    def tx(self):
        def update(g, state, params=None):
            self.grads = g
            return jax.tree.map(jnp.zeros_like, g), state
        return optax.GradientTransformation(lambda p: optax.EmptyState(), update)


@pytest.mark.parametrize("step", [0, 1], ids=["mask_step", "plain_step"])
def test_maerec_step_losses_and_grads_match_jax(maerec, maerec_views, step):
    jmodel, params, tmodel, jdata, *_ = maerec
    jaux, _ = maerec_views
    jb, tb = _maerec_batch(jmodel, jdata, jaux, 3, step)
    key = jax.random.PRNGKey(9)
    rec, real_opt = _Recorder(), jmodel._opt
    jmodel._opt = rec.tx()
    try:
        _, jstate, jloss = jmodel.train_step(params, jmodel.init_opt_state(params), jb, key)
    finally:
        jmodel._opt = real_opt
    tmodel.load_state_dict(convert.maerec_params_from_jax(jax.device_get(params)))
    tmodel.loss_hist.zero_()
    tmodel.hist_len = 0
    tloss = tmodel.train_step(tb, None, step_draws(jmodel, jb["seq"], key))
    for k in jloss:
        np.testing.assert_allclose(tloss[k].item(), float(jloss[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert (float(jloss["loss_mask"]) != 0) == (step == 0)
    np.testing.assert_allclose(tmodel.loss_hist.numpy(), np.asarray(jstate["loss_hist"]),
                               rtol=RTOL)
    want = convert.maerec_params_from_jax(jax.device_get(rec.grads))
    for name, p in tmodel.named_parameters():
        grad_close(p.grad.numpy(), want[name].numpy(), f"maerec: {name}")


def test_maerec_three_steps_match_jax(maerec, maerec_views):
    jmodel, params, tmodel, jdata, tdata, jcfg, tcfg = maerec
    jaux, _ = maerec_views
    tmodel.load_state_dict(convert.maerec_params_from_jax(jax.device_get(params)))
    tmodel.opt = build_optimizer(tcfg, tmodel.parameters())
    tmodel.loss_hist.zero_()
    tmodel.hist_len = 0
    trainer = Trainer(tcfg, tmodel, tdata)
    assert trainer.optimizer is None
    opt_state = jmodel.init_opt_state(params)
    for step in range(N_BATCHES):
        jb, tb = _maerec_batch(jmodel, jdata, jaux, 60 + step, step)
        key = jax.random.PRNGKey(70 + step)
        params, opt_state, jloss = jmodel.train_step(params, opt_state, jb, key)
        draws = step_draws(jmodel, jb["seq"], key)
        tmodel.draws = lambda gen, given=None, d=draws: StepDraws(None, d, "cpu")
        tloss = trainer.train_step(tb, None)
        np.testing.assert_allclose(tloss["loss"].item(), float(jloss["loss"]), rtol=1e-4)
    del tmodel.draws
    np.testing.assert_allclose(tmodel.loss_hist.numpy(), np.asarray(opt_state["loss_hist"]),
                               rtol=1e-4)
    assert tmodel.hist_len == int(opt_state["hist_len"])
    want = convert.maerec_params_from_jax(jax.device_get(params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
