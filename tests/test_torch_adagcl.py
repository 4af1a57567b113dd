"""The port's AdaGCL against the JAX package on one small graph (embedding
16): weights carried across by ``convert``, ``generate()``, the VGAE view,
each phase's loss and gradients, one whole four-phase ``train_step`` (all
three parameter partitions after their Adam updates), and the temperature
schedule.

Random draws: JAX makes them from the step key as its ``train_step`` does
(the VGAE view's and the VGAE loss's normals, the hard-concrete uniforms of
each gate layer), and the port takes them through ``draws``.

Tolerances: rtol 1e-5, atol 1e-7 for one forward and backward pass (float
sums in another order); gradients take atol 1e-6 times the largest entry of
the tensor where that is larger (an entry near zero is the cancellation of
terms of that size).  rtol 1e-4, atol 1e-6 after the step's five Adam
updates, which divide by √v and so magnify those differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.models import losses as jlosses
from sslrec_tpu.models.general_cf.adagcl import AdaGCL as JAdaGCL
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models import losses as tlosses
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.trainer.trainer import Trainer
from sslrec_tpu_torch.utils import convert
from test_torch_lightgcn import _batch, _mats

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-7
OVERRIDES = {"model.embedding_size": 16}


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=max(ATOL, 1e-6 * float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


def _flat(params) -> dict:
    """The JAX pytree under the port's parameter names."""
    return {k: np.asarray(v) for k, v in
            convert.adagcl_params_from_jax(jax.device_get(params)).items()}


@pytest.fixture
def pair(tiny_bundle):
    jcfg = jload_config("adagcl", overrides=OVERRIDES)
    tcfg = tload_config("adagcl", overrides=OVERRIDES)
    jmodel = JAdaGCL(jcfg, tiny_bundle)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tdata = tbundle(*_mats())
    tmodel = build_model(tcfg, tdata)
    tmodel.load_state_dict(convert.adagcl_params_from_jax(jax.device_get(params)))
    return jmodel, params, tmodel, tdata, tcfg


def _draws(jmodel, key):
    """The JAX train_step's draws under ``key``, as the port's ``draws``."""
    kv, _, _, kdn = jax.random.split(key, 4)
    shape = (jmodel.n_nodes, jmodel.embedding_size)
    (kz,) = jax.random.split(kv, 1)
    us, k = [], kdn
    for _ in range(min(jmodel.layer_num, 2)):
        k, sub = jax.random.split(k)
        us.append(jax.random.uniform(sub, (jmodel.nnz,), minval=1e-7, maxval=1 - 1e-7))
    return {"view_noise": torch.from_numpy(np.array(jax.random.normal(kv, shape))),
            "vgae_noise": torch.from_numpy(np.array(jax.random.normal(kz, shape))),
            "gate_u": torch.from_numpy(np.stack([np.asarray(u) for u in us]))}


def _grads_close(tmodel, jgrads, names, what):
    want = _flat(jgrads)
    for name, p in tmodel.named_parameters():
        if name in names:
            _close(p.grad.numpy(), want[name], f"{what}: {name}")


def test_convert_and_generate(pair):
    jmodel, params, tmodel, *_ = pair
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(_flat(params))
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    _close(tu.numpy(), ju, "generate users")
    _close(ti.numpy(), ji, "generate items")


def test_each_phase_matches_jax(pair):
    jmodel, params, tmodel, tdata, _ = pair
    jbatch, tbatch = _batch(tdata.user_num, tdata.item_num, 1)
    ancs, poss, negs = jbatch["user"], jbatch["pos"], jbatch["neg"]
    ta, tp, tn = tbatch["user"], tbatch["pos"], tbatch["neg"]
    key = jax.random.PRNGKey(3)
    kv, kd1, _, kdn = jax.random.split(key, 4)
    draws = _draws(jmodel, key)
    rec = {"user_embeds", "item_embeds"}

    jvals = jmodel._vgae_view(params, kv)
    tvals = tmodel._vgae_view(draws["view_noise"])
    _close(tvals.numpy(), jvals, "vgae view values")
    np.testing.assert_array_equal(tvals.numpy() > 0, np.asarray(jvals) > 0)
    vals = torch.from_numpy(np.array(jvals))

    def phase(jloss, tloss, names, what):
        jl, jg = jax.value_and_grad(jloss)(params)
        tmodel.zero_grad(set_to_none=True)
        tl = tloss()
        tl.backward()
        _close(tl.item(), float(jl), f"{what} loss")
        _grads_close(tmodel, jg, names, what)
        return tl

    phase(lambda p: jnp.mean(jmodel._graphcl(jmodel._forward(p["rec"], jvals),
                                             jmodel._dn_view_forward(p, kd1), ancs, poss))
          * jmodel.cl_weight,
          lambda: tmodel._graphcl(tmodel._forward(vals), tmodel._dn_view_forward(),
                                  ta, tp).mean() * tmodel.cl_weight, rec, "cl")
    old1 = jax.lax.stop_gradient(jmodel._forward(params["rec"], jvals))
    old2 = jax.lax.stop_gradient(jmodel._dn_view_forward(params, kd1))
    t1, t2 = torch.from_numpy(np.array(old1)), torch.from_numpy(np.array(old2))
    phase(lambda p: jnp.mean(jmodel._graphcl(jmodel._forward(p["rec"], jvals), old1, ancs, poss)
                             + jmodel._graphcl(jmodel._dn_view_forward(p, kd1), old2, ancs,
                                               poss)) * jmodel.ib_weight,
          lambda: (tmodel._graphcl(tmodel._forward(vals), t1, ta, tp)
                   + tmodel._graphcl(tmodel._dn_view_forward(), t2, ta, tp)).mean()
          * tmodel.ib_weight, rec, "ib")

    def jmain(p):
        e = jmodel._forward(p["rec"], jmodel.norm_vals)
        u, i = e[: jmodel.user_num], e[jmodel.user_num:]
        return (jlosses.bpr_loss(u[ancs], i[poss], i[negs]) / ancs.shape[0]
                + jmodel.reg_weight * jlosses.reg_params(p["rec"]))

    phase(jmain, lambda: tmodel._bpr(tmodel._forward(tmodel.norm_vals), ta, tp, tn)
          + tmodel.reg_weight * tlosses.reg_params(
              {"user_embeds": tmodel.user_embeds, "item_embeds": tmodel.item_embeds}),
          rec, "bpr")

    def jvgae(p):
        (kz,) = jax.random.split(kv, 1)
        z, mean, std = jmodel._vgae_encode(p, kz)
        zu, zi = z[: jmodel.user_num], z[jmodel.user_num:]
        pos = jax.nn.sigmoid(jmodel._vgae_decode(p, zu[ancs], zi[poss]))
        neg = jax.nn.sigmoid(jmodel._vgae_decode(p, zu[ancs], zi[negs]))
        bce = -jnp.log(pos + 1e-12) - jnp.log(1 - neg + 1e-12)
        kl = -0.5 * jnp.sum(1 + 2 * jnp.log(std + 1e-12) - mean ** 2 - std ** 2, 1)
        bpr = jlosses.bpr_loss(zu[ancs], zi[poss], zi[negs]) / ancs.shape[0]
        return jnp.mean(bce) + 0.1 * jnp.mean(kl) + bpr

    vgae = {n for n, _ in tmodel.named_parameters() if n.startswith("vgae.")}
    phase(jvgae, lambda: tmodel._vgae_loss(draws["vgae_noise"], ta, tp, tn), vgae, "vgae")

    temp = jnp.float32(1.3)

    def jdn(p):
        x, l0 = jmodel._dn_forward(p, kdn, temp, True, True)
        u, i = x[: jmodel.user_num], x[jmodel.user_num:]
        return (jlosses.bpr_loss(u[ancs], i[poss], i[negs]) / ancs.shape[0]
                + l0 * jmodel.lambda0)

    def tdn():
        x, l0 = tmodel._dn_forward(draws["gate_u"], torch.tensor(1.3))
        return tmodel._bpr(x, ta, tp, tn) + l0 * tmodel.lambda0

    dn = {n for n, _ in tmodel.named_parameters() if n.startswith("dn.")}
    phase(jdn, tdn, dn, "denoise")


def test_train_step_matches_jax(pair):
    """One whole step: the VGAE view, three recommender updates and the two
    generators' updates, through the trainer as the CLI drives it."""
    jmodel, params, tmodel, tdata, tcfg = pair
    trainer = Trainer(tcfg, tmodel, tdata)
    assert trainer.optimizer is None and tmodel._n_batches_hint == trainer.n_batches
    opt_state = jmodel.init_opt_state(params)
    jbatch, tbatch = _batch(tdata.user_num, tdata.item_num, 2)
    key = jax.random.PRNGKey(7)
    jbatch["aux"] = jmodel.epoch_state(params, None, 4)
    tbatch["aux"] = tmodel.epoch_state(None, 4)
    new, _, jaux = jmodel.train_step(params, opt_state, jbatch, key)
    draws = _draws(jmodel, key)
    tmodel.step_draws = lambda gen: draws
    taux = trainer.train_step(tbatch, None)
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k].item(), float(jaux[k]), f"aux {k}", rtol=1e-4)
    want = _flat(new)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_temperature_schedule(pair):
    jmodel, params, tmodel, *_ = pair
    for epoch in (0, 1, 10, 150, 400):
        got = tmodel.epoch_state(None, epoch)["temperature"]
        want = jmodel.epoch_state(params, None, epoch)["temperature"]
        assert got.dtype == torch.float32 and got.item() == float(want)
