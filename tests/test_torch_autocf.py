"""The port's AutoCF against the JAX package on one small graph (embedding
16, 4 heads, seed_num 5, fix_steps 2): ``convert``, the seed scores and
their gradient, the view bank from the same draws, the loss and every
gradient on a step where the views regenerate and on one where they do not,
and ``generate()``.

Random draws: JAX makes each view's draws from the epoch key as its
``epoch_state`` does (the seeds' Gumbel noise, the node sample, the two pair
draws), and the port takes them through ``epoch_state``'s ``draws``.

Tolerances: the view's selections (``keep``, the random pairs) exactly
equal; its encoder values within rtol 1e-6, atol 1e-7 (three float32
products and a power); one forward and backward pass within rtol 1e-5, atol
1e-7, gradients with atol 1e-6 times the tensor's largest entry where that is
larger (an entry near zero is the cancellation of terms of that size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.models.general_cf.autocf import AutoCF as JAutoCF
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.utils import convert
from test_torch_lightgcn import _batch, _mats

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-7
OVERRIDES = {"model.embedding_size": 16, "model.fix_steps": 2, "model.seed_num": 5}
N_BATCHES = 3                   # two views at fix_steps 2


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=max(ATOL, 1e-6 * float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


@pytest.fixture
def pair(tiny_bundle):
    jcfg = jload_config("autocf", overrides=OVERRIDES)
    tcfg = tload_config("autocf", overrides=OVERRIDES)
    jmodel = JAutoCF(jcfg, tiny_bundle)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, tbundle(*_mats()))
    tmodel.load_state_dict(convert.autocf_params_from_jax(jax.device_get(params)))
    jmodel._n_batches_hint = tmodel._n_batches_hint = N_BATCHES
    return jmodel, params, tmodel


def _view_draws(jmodel, key):
    """JAX's per-view draws under the epoch key, as the port's ``draws``."""
    n, nnz = jmodel.n_nodes, jmodel.nnz
    out = []
    for k in jax.random.split(key, -(-N_BATCHES // jmodel.fix_steps)):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        out.append({name: torch.from_numpy(np.array(u)) for name, u in (
            ("noise", jax.random.uniform(k1, (n,), minval=1e-8, maxval=1.0)),
            ("sample_u", jax.random.uniform(k2, (n,))),
            ("rows_u", jax.random.uniform(k3, (nnz,))),
            ("cols_u", jax.random.uniform(k4, (nnz,))))})
    return out


def _views(jmodel, params, tmodel, seed=5):
    key = jax.random.PRNGKey(seed)
    jviews = jax.device_get(jmodel.epoch_state(params, key, 0))
    tviews = tmodel.epoch_state(None, 0, draws=_view_draws(jmodel, key))
    return jviews, tviews


def test_convert_and_generate(pair):
    jmodel, params, tmodel = pair
    names = sorted(n for n, _ in tmodel.named_parameters())
    assert names == ["gt.0.k", "gt.0.q", "gt.0.v", "item_embeds", "user_embeds"]
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    _close(tu.numpy(), ju, "generate users")
    _close(ti.numpy(), ji, "generate items")


def test_seed_scores_and_gradient(pair):
    jmodel, params, tmodel = pair
    w = np.random.default_rng(0).standard_normal(jmodel.n_nodes).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda p: jnp.sum(jmodel._seed_scores(p, jax.random.PRNGKey(1))[0] * w))(params)
    scores = tmodel._seed_scores()
    (scores * torch.from_numpy(w)).sum().backward()
    _close(scores.detach().numpy(), jmodel._seed_scores(params, jax.random.PRNGKey(1))[0],
           "scores")
    want = convert.autocf_params_from_jax(jax.device_get(jgrad))
    for name, p in tmodel.named_parameters():
        if name.endswith("embeds"):
            _close(p.grad.numpy(), want[name].numpy(), name)


def test_views_match_jax(pair):
    jmodel, params, tmodel = pair
    jviews, tviews = _views(jmodel, params, tmodel)
    assert len(tviews["views"]) == 2
    for v, tv in enumerate(tviews["views"]):
        for k in ("keep", "rand_rows", "rand_cols"):
            np.testing.assert_array_equal(tv[k].numpy(), jviews[k][v], err_msg=f"view {v} {k}")
        assert 0 < tv["keep"].sum() < jmodel.nnz
        np.testing.assert_allclose(tv["enc_vals"].numpy(), jviews["enc_vals"][v], rtol=1e-6,
                                   atol=1e-7)
        lay_r, lay_c, valid = tv["dec"]
        assert lay_r.n == 2 * jmodel.nnz + jmodel.n_nodes + jmodel.nnz
        np.testing.assert_array_equal(valid[-jmodel.nnz:].numpy(), jviews["keep"][v])


@pytest.mark.parametrize("step", [2, 3])
def test_loss_and_grads_match_jax(pair, step):
    """Step 2 regenerates (view 1, the infomax term on); step 3 does not."""
    jmodel, params, tmodel = pair
    jviews, tviews = _views(jmodel, params, tmodel)
    jbatch, tbatch = _batch(tmodel.user_num, tmodel.item_num, step)
    jbatch = {"user": jbatch["user"], "pos": jbatch["pos"], "step": step, "aux": jviews}
    tbatch = {"user": tbatch["user"], "pos": tbatch["pos"], "step": step, "aux": tviews}
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, jbatch, jax.random.PRNGKey(9))
    tloss, taux = tmodel.loss(tbatch)
    tloss.backward()
    _close(tloss.item(), float(jloss), "loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k].item(), float(jaux[k]), k)
    assert (float(jaux["infomax_loss"]) != 0.0) == (step % 2 == 0)
    want = convert.autocf_params_from_jax(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), f"step {step}: {name}")
