"""The port's GFormer against the JAX package on one small graph (embedding
16, 4 heads, fix_steps 2): ``convert``, the anchor distances from the same
anchors, the PNN encoding, the graph-transformer layer and ``att_edge``, the
view's masks, values and decoder edges, the loss and every gradient, and
``generate()``.

Random draws: JAX makes each view's draws from the epoch key as its
``epoch_state`` does, and the port takes them through its ``draws``.  The
masks are held given JAX's own ``att_edge`` and Gumbel noise, so that a
rounding difference at the top-k boundary cannot flip an edge; the port's
``att_edge`` is held to JAX's apart.

Tolerances: anchor distances, the augmented and decoder edges and the mask
supports exactly equal; values and one forward and backward pass within
rtol 1e-5, atol 1e-7, gradients with atol 1e-6 times the tensor's largest
entry where that is larger (an entry near zero is the cancellation of terms
of that size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.config import load_config as jload_config
from sslrec_tpu.models.general_cf.gformer import GFormer as JGFormer
from sslrec_tpu_torch.config import load_config as tload_config
from sslrec_tpu_torch.data.general_cf import bundle_from_matrices as tbundle
from sslrec_tpu_torch.models.general_cf.autocf import gt_attention
from sslrec_tpu_torch.models.registry import build_model
from sslrec_tpu_torch.ops.segment_kernel import segment_layout_from_ids
from sslrec_tpu_torch.utils import convert
from test_torch_lightgcn import _batch, _mats

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-7
OVERRIDES = {"model.embedding_size": 16, "model.fix_steps": 2}
N_BATCHES = 3                   # two views at fix_steps 2


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=max(ATOL, 1e-6 * float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def pair(tiny_bundle):
    jcfg = jload_config("gformer", overrides=OVERRIDES)
    tcfg = tload_config("gformer", overrides=OVERRIDES)
    jmodel = JGFormer(jcfg, tiny_bundle)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, tbundle(*_mats()))
    tmodel.load_state_dict(convert.gformer_params_from_jax(jax.device_get(params)))
    jmodel._n_batches_hint = tmodel._n_batches_hint = N_BATCHES
    return jmodel, params, tmodel


def _view_draws(jmodel, key):
    """JAX's per-view draws under the epoch key, as the port's ``draws``."""
    n_aug = jmodel.nnz_aug
    out = []
    for k in jax.random.split(key, -(-N_BATCHES // jmodel.fix_steps)):
        ks = jax.random.split(k, 9)

        def gumbel_u(kk):
            return jax.random.uniform(kk, (n_aug,), minval=1e-9, maxval=1.0)

        out.append({name: _t(a) for name, a in (
            ("anchors", jax.random.choice(ks[0], jmodel.n_nodes, (jmodel.anchor_num,),
                                          replace=False)),
            ("add_rows", jax.random.randint(ks[1], (jmodel.n_add,), 0, jmodel.nnz)),
            ("add_cols", jax.random.randint(ks[2], (jmodel.n_add,), 0, jmodel.nnz)),
            ("keep_u", gumbel_u(ks[3])), ("sub_u", gumbel_u(ks[4])),
            ("cmp_u", gumbel_u(ks[5])),
            ("dec_u", jax.random.uniform(ks[6], (int(jmodel.nnz * jmodel.re_rate),))))})
    return out


def _jax_att_edge(jmodel, params, view, v):
    embeds = jnp.concatenate([params["user_embeds"], params["item_embeds"]], 0)
    pnn = jmodel._pnn(params, embeds, view["anchors"][v], view["dist_w"][v])
    return jmodel._gt(params, view["aug_rows"][v], view["aug_cols"][v], None, pnn)[1]


def _views(jmodel, params, tmodel, seed=5):
    """JAX's view bank, and the port's from the same draws, its masks made
    from JAX's att_edge."""
    key = jax.random.PRNGKey(seed)
    jviews = jax.device_get(jmodel.epoch_state(params, key, 0))
    tviews = []
    with torch.no_grad():
        for v, d in enumerate(_view_draws(jmodel, key)):
            aug = tmodel.augment(d)
            tviews.append(tmodel.masks(aug, _t(_jax_att_edge(jmodel, params, jviews, v)), d))
    return jviews, {"views": tviews}


def test_convert_and_generate(pair):
    jmodel, params, tmodel = pair
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(
        convert.gformer_params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        tu, ti = tmodel.generate()
    ju, ji = jmodel.generate(params)
    _close(tu.numpy(), ju, "generate users")
    _close(ti.numpy(), ji, "generate items")


def test_anchor_distances_and_pnn(pair):
    jmodel, params, tmodel = pair
    anchors, jw = jmodel._anchor_dists(jax.random.PRNGKey(2))
    tw = tmodel._anchor_dists(_t(anchors))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert len(np.unique(tw.numpy())) > 3               # several hop distances
    embeds = jnp.concatenate([params["user_embeds"], params["item_embeds"]], 0)
    with torch.no_grad():
        tp = tmodel._pnn(tmodel._embeds(), _t(anchors), tw)
    _close(tp.numpy(), jmodel._pnn(params, embeds, anchors, jw), "pnn")


def test_gt_and_att_edge(pair):
    jmodel, params, tmodel = pair
    jviews = jax.device_get(jmodel.epoch_state(params, jax.random.PRNGKey(5), 0))
    rows, cols = jviews["aug_rows"][0], jviews["aug_cols"][0]
    valid = np.asarray(jviews["sub_vals"][0] > 0)
    w = np.random.default_rng(0).standard_normal(
        (jmodel.n_nodes, jmodel.embedding_size)).astype(np.float32)

    def jfn(p):
        embeds = jnp.concatenate([p["user_embeds"], p["item_embeds"]], 0)
        out, att = jmodel._gt(p, rows, cols, valid, embeds)
        return jnp.sum(out * w), (out, att)

    (_, (jout, jatt)), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    n = jmodel.n_nodes
    out = gt_attention(tmodel.gt, segment_layout_from_ids(_t(rows), n),
                       segment_layout_from_ids(_t(cols), n), _t(valid).float(),
                       tmodel._embeds(), tmodel.head)
    (out * _t(w)).sum().backward()
    _close(out.detach().numpy(), jout, "gt")
    want = convert.gformer_params_from_jax(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        if p.grad is not None:
            _close(p.grad.numpy(), want[name].numpy(), f"gt grad {name}")
    with torch.no_grad():
        tatt = tmodel._att_edge(tmodel._embeds(), _t(rows).long(), _t(cols).long())
    _close(tatt.numpy(), jatt, "att_edge")
    view = tmodel.augment(_view_draws(jmodel, jax.random.PRNGKey(5))[0])
    with torch.no_grad():
        tatt = tmodel._att_edge(view["pnn"], view["aug_rows"], view["aug_cols"])
    _close(tatt.numpy(), _jax_att_edge(jmodel, params, jviews, 0), "att_edge of the PNN")


def test_view_masks_values_and_decoder(pair):
    jmodel, params, tmodel = pair
    jviews, tviews = _views(jmodel, params, tmodel)
    for v, tv in enumerate(tviews["views"]):
        for k in ("aug_rows", "aug_cols", "dec_rows", "dec_cols", "anchors"):
            np.testing.assert_array_equal(tv[k].numpy(), jviews[k][v], err_msg=f"view {v} {k}")
        np.testing.assert_array_equal(tv["dist_w"].numpy(), jviews["dist_w"][v])
        assert tv["keep"].sum() == jmodel.k_keep and tv["sub_mask"].sum() == jmodel.k_sub
        for k in ("enc_vals", "sub_vals", "cmp_vals"):
            np.testing.assert_array_equal(tv[k].numpy() > 0, jviews[k][v] > 0,
                                          err_msg=f"view {v} {k} support")
            _close(tv[k].numpy(), jviews[k][v], f"view {v} {k}")
        assert tv["aug"].nnz == jmodel.nnz_aug
        assert tv["dec_seg"][0].n == 2 * int(jmodel.nnz * jmodel.re_rate) + jmodel.n_nodes


def test_loss_and_grads_match_jax(pair):
    jmodel, params, tmodel = pair
    jviews, tviews = _views(jmodel, params, tmodel)
    jbatch, tbatch = _batch(tmodel.user_num, tmodel.item_num, 3)
    step = 2                                            # view 1
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        params, {**jbatch, "step": step, "aux": jviews}, jax.random.PRNGKey(9))
    tloss, taux = tmodel.loss({**tbatch, "step": step, "aux": tviews})
    tloss.backward()
    _close(tloss.item(), float(jloss), "loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        _close(taux[k].item(), float(jaux[k]), k)
    want = convert.gformer_params_from_jax(jax.device_get(jgrads))
    for name, p in tmodel.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), name)
