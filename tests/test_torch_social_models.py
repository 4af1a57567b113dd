"""The port's DcRec, MHCN and DSL against the JAX package on a tiny synthetic
social split (embedding 16): weights carried across by ``convert`` and
``generate()`` for all three; here ``grace_pair_losses`` at G = 2 and 4 and
two chunk sizes, and DcRec: the loss, every loss term and every parameter
gradient at keep rate 1 and under JAX's view draws at keep 0.3, and its
augmented views of each kind (``test_torch_social_models_b.py``: MHCN and
DSL).

Random draws are JAX's, injected: DcRec's views (``_pick_kinds`` and
``_view`` under the loss's key, as the port's view dicts).

Tolerances: rtol 1e-5, atol 1e-6 for a forward and backward pass (float sums
in another order: B1's segment sums against XLA's ``segment_sum``). the
parameters after one Adam step within atol 1e-6 (the step is lr-sized).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.data import social as jsocial
from sslrec_tpu.models.multi_behavior.hmgcr import grace_pair_losses as jgrace
from sslrec_tpu.models.registry import build_model as jbuild
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data import social as tsocial
from sslrec_tpu_torch.models import losses as tlosses
from sslrec_tpu_torch.models.registry import build_model as tbuild
from sslrec_tpu_torch.models.social.dcrec import EDGE_ADD
from sslrec_tpu_torch.utils import convert
from test_torch_social_data import social_split

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6
CONVERT = {"dcrec": convert.dcrec_params_from_jax, "mhcn": convert.mhcn_params_from_jax,
           "dsl": convert.dsl_params_from_jax}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _pair(name, **over):
    over = {"model.embedding_size": 16, **over}
    jcfg, tcfg = jload_config(name, overrides=over), tload_config(name, overrides=over)
    mats = social_split()
    jmodel = jbuild(jcfg, jsocial.bundle_from_matrices(jcfg, *mats))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = tbuild(tcfg, tsocial.bundle_from_matrices(tcfg, *mats))
    tmodel.load_state_dict(CONVERT[name](jax.device_get(params)))
    return jmodel, params, tmodel


def _batch(jmodel, seed, b=64, **extra):
    rng = np.random.default_rng(seed)
    arrs = {"user": rng.integers(0, jmodel.user_num, b),
            "pos": rng.integers(0, jmodel.item_num, b),
            "neg": rng.integers(0, jmodel.item_num, b),
            **{k: rng.integers(0, hi, b) for k, hi in extra.items()}}
    return ({k: jnp.asarray(v, jnp.int32) for k, v in arrs.items()},
            {k: torch.from_numpy(v.astype(np.int32)) for k, v in arrs.items()})


def _grads_close(tmodel, jgrads, name, what):
    want = CONVERT[name](jax.device_get(jgrads))
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), f"{what}: grad {k}")


def _check_loss(name, jmodel, params, tmodel, jbatch, tbatch, key, **kw):
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jbatch, key)
    tloss, taux = tmodel.loss(tbatch, None, **kw)
    tloss.backward()
    _close(tloss.item(), float(jloss), f"{name} loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k].item(), float(jaux[k]), f"{name} {k}")
    _grads_close(tmodel, jgrads, name, name)


@pytest.mark.parametrize("name", ["dcrec", "mhcn", "dsl"])
def test_convert_and_generate(name):
    jmodel, params, tmodel = _pair(name)
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    _close(tu.numpy(), ju, f"{name} users")
    _close(ti.numpy(), ji, f"{name} items")


@pytest.mark.parametrize("g_n", [2, 4])
@pytest.mark.parametrize("chunk", [16, 64])
def test_grace_pair_losses(g_n, chunk):
    rng = np.random.default_rng(g_n * 100 + chunk)
    zs = [np.maximum(rng.standard_normal((45, 8)), 0).astype(np.float32) for _ in range(g_n)]
    zs[0][3] = 0.0                                   # a zero row, as after relu
    w = rng.standard_normal(g_n * (g_n - 1)).astype(np.float32)

    def jtotal(zs_):
        out = jgrace(list(zs_), 0.7, chunk)
        return sum(wi * out[k] for wi, k in zip(w, sorted(out))), out

    (_, jout), jgrads = jax.value_and_grad(jtotal, has_aux=True)([jnp.asarray(z) for z in zs])
    tz = [torch.from_numpy(z).requires_grad_() for z in zs]
    tout = tlosses.grace_pair_losses(tz, 0.7, chunk)
    assert sorted(tout) == sorted(jout) and len(tout) == g_n * (g_n - 1)
    sum(float(wi) * tout[k] for wi, k in zip(w, sorted(tout))).backward()
    for k in jout:
        _close(tout[k].item(), float(jout[k]), f"pair {k}")
    for i, (t, j) in enumerate(zip(tz, jgrads)):
        _close(t.grad.numpy(), j, f"grad of view {i}")


def test_dcrec_at_keep_rate_one():
    jmodel, params, tmodel = _pair("dcrec", **{"model.keep_rate": 1.0})
    jbatch, tbatch = _batch(jmodel, 1)
    _check_loss("dcrec", jmodel, params, tmodel, jbatch, tbatch, jax.random.PRNGKey(3))


def _tview(jview, kind):
    """JAX's ``_view`` output ``(w, add_r, add_c, add_w)`` as the port's view."""
    w, add_r, add_c, add_w = (np.asarray(a) for a in jview)
    assert (add_w == 1.0).all() if kind == EDGE_ADD else not add_w.any()
    add = ((torch.tensor(add_r), torch.tensor(add_c)) if kind == EDGE_ADD else None)
    return {"w": torch.tensor(w), "add": add}


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_dcrec_views_of_each_kind(kind):
    """Each domain's view propagation from JAX's draws of one kind: values and
    the gradients of a weighted sum."""
    jmodel, params, tmodel = _pair("dcrec")
    U, I = jmodel.user_num, jmodel.item_num
    rng = np.random.default_rng(kind)
    wu, wi = (rng.standard_normal((n, 16)).astype(np.float32) for n in (U, I))
    ku, kt = jax.random.split(jax.random.PRNGKey(10 + kind))
    jv_ui = jmodel._view(ku, kind, jmodel.ui_rows, U, I, jmodel.n_aug_ui)
    jv_uu = jmodel._view(kt, kind, jmodel.t_rows, U, U, jmodel.n_aug_t)
    if kind != EDGE_ADD:
        assert float(np.asarray(jv_ui[0]).sum()) < jmodel.ui_rows.shape[0]

    def jui(p):
        u, i = jmodel._lightgcn_view(p, *jv_ui)
        return jnp.sum(u * wu) + jnp.sum(i * wi), (u, i)

    (_, (ju, ji)), jg = jax.value_and_grad(jui, has_aux=True)(params)
    tu, ti = tmodel._lightgcn_view(_tview(jv_ui, kind))
    ((tu * torch.from_numpy(wu)).sum() + (ti * torch.from_numpy(wi)).sum()).backward()
    _close(tu.detach().numpy(), ju, "ui view users")
    _close(ti.detach().numpy(), ji, "ui view items")
    want = CONVERT["dcrec"](jax.device_get(jg))
    for k in ("ui_user_embeds", "ui_item_embeds"):
        _close(getattr(tmodel, k).grad.numpy(), want[k].numpy(), f"ui view grad {k}")

    def juu(p):
        x = jmodel._gcn_view(p, *jv_uu)
        return jnp.sum(x * wu), x

    (_, jx), jg = jax.value_and_grad(juu, has_aux=True)(params)
    tx = tmodel._gcn_view(_tview(jv_uu, kind))
    (tx * torch.from_numpy(wu)).sum().backward()
    _close(tx.detach().numpy(), jx, "trust view")
    _close(tmodel.uu_user_embeds.grad.numpy(),
           CONVERT["dcrec"](jax.device_get(jg))["uu_user_embeds"].numpy(), "trust view grad")


def test_dcrec_loss_with_jax_views():
    jmodel, params, tmodel = _pair("dcrec")
    U, I = jmodel.user_num, jmodel.item_num
    key = jax.random.PRNGKey(5)
    kc, ks, kv = jax.random.split(key, 3)
    kinds = [*jmodel._pick_kinds(kc), *jmodel._pick_kinds(ks)]
    specs = [(jmodel.ui_rows, U, I, jmodel.n_aug_ui)] * 2 + [(jmodel.t_rows, U, U,
                                                              jmodel.n_aug_t)] * 2
    views = [_tview(jmodel._view(k, kind, *spec), int(kind))
             for k, kind, spec in zip(jax.random.split(kv, 4), kinds, specs)]
    assert len({int(k) for k in kinds[:2]}) == 2 and len({int(k) for k in kinds[2:]}) == 2
    jbatch, tbatch = _batch(jmodel, 2)
    _check_loss("dcrec", jmodel, params, tmodel, jbatch, tbatch, key, views=views)
    assert tmodel.added_views["ui"] + tmodel.added_views["uu"] == sum(
        int(k) == EDGE_ADD for k in kinds)
