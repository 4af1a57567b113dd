"""The port's transformer blocks (``models/layers.py``), the masked-item
cross entropy, the sequence augmentations (``models/seq_augment.py``) and
the in-batch contrasts against the JAX package, under the same parameters
and the same draws: every dropout mask and augmentation draw is made by JAX
from its key as its own functions make them (:func:`tower_masks`,
:func:`aug_draws`, used by the model tests too) and handed to the port.

Tolerances: rtol 1e-5, atol 1e-6 for a forward and backward pass (float
sums in another order); a gradient takes atol 1e-6 times the largest entry
of its tensor where that is larger (an entry near zero there is the
cancellation of terms of that size); augmentations and masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.models import layers as jlayers
from sslrec_tpu.models import losses as jlosses
from sslrec_tpu.models import seq_augment as jaug
from sslrec_tpu.models.sequential.cl4srec import nt_xent as jnt_xent
from sslrec_tpu.models.sequential.iclrec import nce_loss as jnce_loss
from sslrec_tpu_torch.models import layers as tlayers
from sslrec_tpu_torch.models import losses as tlosses
from sslrec_tpu_torch.models import seq_augment as taug
from sslrec_tpu_torch.models.sequential.cl4srec import nt_xent as tnt_xent
from sslrec_tpu_torch.models.sequential.iclrec import nce_loss as tnce_loss
from sslrec_tpu_torch.utils import convert

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def grad_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=max(ATOL, 1e-6 * float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


def _keep(key, rate, shape):
    return t(jax.random.bernoulli(key, 1.0 - rate, shape))


def layer_masks(key, rate, b, l, d, h, d_ff=None):
    """One JAX transformer layer's five keep masks, in the port's order."""
    d_ff = d_ff or 4 * d
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    return [_keep(k1, rate, (b, h, l, l)), _keep(k2, rate, (b, l, d)),
            _keep(k3, rate, (b, l, d_ff)), _keep(k4, rate, (b, l, d)),
            _keep(k5, rate, (b, l, d))]


def tower_masks(key, n_layers, rate, b, l, d, h):
    """The keep masks JAX's ``apply_transformer_tower`` (and MAERec's tower)
    draws from ``key``: the embedding's, then each layer's five."""
    keys = jax.random.split(key, n_layers + 1)
    out = [_keep(keys[0], rate, (b, l, d))]
    for k in keys[1:]:
        out += layer_masks(k, rate, b, l, d, h)
    return out


def _view(kv, seqs, eta, beta):
    b, l = seqs.shape
    lens = jnp.sum((seqs > 0).astype(jnp.int32), axis=1)
    num_left = jnp.maximum((lens.astype(jnp.float32) * eta).astype(jnp.int32), 0)
    num_re = (lens.astype(jnp.float32) * beta).astype(jnp.int32)
    kb, kp = jax.random.split(jax.random.fold_in(kv, 2))
    return {"crop_begin": t(jax.random.randint(jax.random.fold_in(kv, 0), (b,), 0,
                                               jnp.maximum(lens - num_left + 1, 1))),
            "mask_u": t(jax.random.uniform(jax.random.fold_in(kv, 1), (b, l))),
            "reorder_begin": t(jax.random.randint(kb, (b,), 0,
                                                  jnp.maximum(lens - num_re + 1, 1))),
            "reorder_u": t(jax.random.uniform(kp, (b, l)))}


def aug_draws(key, seqs, eta=0.6, beta=0.6):
    """``cl4srec_two_views``'s draws from ``key`` under the port's names."""
    seqs = jnp.asarray(seqs)
    ksel, k1, k2 = jax.random.split(key, 3)
    return {"aug_op_u": t(jax.random.uniform(ksel, (seqs.shape[0], 3))),
            "aug_view1": _view(k1, seqs, eta, beta), "aug_view2": _view(k2, seqs, eta, beta)}


def _seqs(b=12, l=10, n_items=30, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, l + 1, b)
    lens[:3] = (0, 1, l)
    s = rng.integers(1, n_items + 1, (b, l)).astype(np.int32)
    s[np.arange(l)[None, :] < (l - lens)[:, None]] = 0
    return s


class _Tower(torch.nn.Module):
    def __init__(self, vocab, d, l, n_layers):
        super().__init__()
        self.emb, self.layers = tlayers.tower_params(vocab, d, l, n_layers, "cpu")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "dropout"])
def test_tower_matches_jax(train):
    d, l, h, n_layers, rate = 16, 10, 2, 2, 0.3
    params = jlayers.init_transformer_tower(jax.random.PRNGKey(1), 32, d, l, n_layers)
    tower = _Tower(32, d, l, n_layers)
    tower.load_state_dict(convert.cl4srec_params_from_jax(jax.device_get(params)))
    seqs = _seqs()
    key = jax.random.PRNGKey(7)
    w_out = np.random.default_rng(2).standard_normal((12, l, d)).astype(np.float32)

    def f(p):
        y = jlayers.apply_transformer_tower(p, key, jnp.asarray(seqs), h, rate,
                                            deterministic=not train)
        return jnp.sum(y * w_out), y

    (_, jy), jg = jax.value_and_grad(f, has_aux=True)(params)
    drop = (tlayers.mask_dropout(tower_masks(key, n_layers, rate, 12, l, d, h), rate)
            if train else None)
    ty = tlayers.apply_transformer_tower(tower.emb, tower.layers, t(seqs), h, drop)
    (ty * t(w_out)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    want = convert.cl4srec_params_from_jax(jax.device_get(jg))
    for name, p in tower.named_parameters():
        grad_close(p.grad.numpy(), want[name].numpy(), name)


def test_attention_masks_padded_keys():
    d, l, h = 16, 10, 2
    p = jlayers.init_attention(jax.random.PRNGKey(3), d)
    tp = tlayers.attention_params(d, "cpu")
    for k, lin in p.items():
        for kk, v in lin.items():
            tp[k][kk].data.copy_(t(v))
    x = np.random.default_rng(4).standard_normal((12, l, d)).astype(np.float32)
    seqs = _seqs()
    mask = (seqs > 0).astype(np.int32)
    jy = jlayers.apply_attention(p, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                                 h, 0.0, True)
    ty = tlayers.apply_attention(tp, t(x), t(mask), h)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    # a padded key gets no weight: changing its value changes no output row
    # whose row has a live key
    x2 = x.copy()
    x2[seqs == 0] += 5.0
    ty2 = tlayers.apply_attention(tp, t(x2), t(mask), h)
    live = (seqs > 0).any(1)
    q_rows = seqs > 0
    np.testing.assert_allclose(ty2.detach().numpy()[live][q_rows[live]],
                               ty.detach().numpy()[live][q_rows[live]], rtol=RTOL, atol=ATOL)


def test_layer_norm_eps():
    x = np.random.default_rng(5).standard_normal((4, 16)).astype(np.float32) * 0.02
    p = {"scale": np.linspace(0.5, 1.5, 16, dtype=np.float32),
         "bias": np.linspace(-0.1, 0.1, 16, dtype=np.float32)}
    tp = {k: t(v) for k, v in p.items()}
    for eps in (1e-5, 1e-12):
        np.testing.assert_allclose(
            tlayers.apply_layer_norm(tp, t(x), eps).numpy(),
            np.asarray(jlayers.apply_layer_norm(p, jnp.asarray(x), eps)), rtol=RTOL, atol=ATOL)


def test_cross_entropy_ignore_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((40, 31)).astype(np.float32)
    labels = rng.integers(0, 31, 40).astype(np.int32)
    labels[::3] = 0
    for lab in (labels, np.zeros_like(labels)):
        tl = t(logits).requires_grad_()
        got = tlosses.cross_entropy_ignore(tl, t(lab), 0)
        got.backward()
        want, jg = jax.value_and_grad(
            lambda z: jlosses.cross_entropy_ignore(z, jnp.asarray(lab), 0))(jnp.asarray(logits))
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_augmentations_match_jax(seed):
    seqs = _seqs(b=20, seed=seed)
    key = jax.random.PRNGKey(seed + 10)
    dr = _view(key, jnp.asarray(seqs), 0.6, 0.6)
    js = jnp.asarray(seqs)
    jc, _ = jaug.crop(jax.random.fold_in(key, 0), js, 0.6)
    jm, _ = jaug.mask(jax.random.fold_in(key, 1), js, 31, 0.3)
    jr, _ = jaug.reorder(jax.random.fold_in(key, 2), js, 0.6)
    np.testing.assert_array_equal(taug.crop(t(seqs), dr["crop_begin"], 0.6).numpy(), jc)
    np.testing.assert_array_equal(taug.mask(t(seqs), dr["mask_u"], 31, 0.3).numpy(), jm)
    np.testing.assert_array_equal(
        taug.reorder(t(seqs), dr["reorder_begin"], dr["reorder_u"], 0.6).numpy(), jr)
    # a reorder permutes within the row; a crop keeps a suffix of live items
    out = taug.reorder(t(seqs), dr["reorder_begin"], dr["reorder_u"], 0.6).numpy()
    for a, b in zip(out, seqs):
        assert sorted(a) == sorted(b)


@pytest.mark.parametrize("eta,gamma,beta", [(0.6, 0.3, 0.6), (0.2, 0.7, 0.2)],
                         ids=["cl4srec", "iclrec"])
def test_two_views_match_jax(eta, gamma, beta):
    seqs = _seqs(b=24, seed=3)
    key = jax.random.PRNGKey(5)
    j1, j2 = jaug.cl4srec_two_views(key, jnp.asarray(seqs), 31, eta, gamma, beta)
    d = aug_draws(key, seqs, eta, beta)
    t1, t2 = taug.cl4srec_two_views(t(seqs), d["aug_op_u"], d["aug_view1"], d["aug_view2"],
                                    31, eta, gamma, beta)
    np.testing.assert_array_equal(t1.numpy(), j1)
    np.testing.assert_array_equal(t2.numpy(), j2)
    gen = torch.Generator().manual_seed(0)
    from sslrec_tpu_torch.models.sequential.base_seq import StepDraws
    op_u, d1, d2 = taug.two_view_draws(StepDraws(gen), t(seqs), eta, beta)
    lens = taug.lengths(t(seqs))
    assert bool((d1["crop_begin"] <= (lens - taug.crop_len(lens, eta)).clamp(min=0)).all())
    assert op_u.shape == (24, 3) and d2["mask_u"].shape == seqs.shape


def test_contrasts_match_jax():
    rng = np.random.default_rng(9)
    z1, z2 = (rng.standard_normal((8, 16)).astype(np.float32) for _ in range(2))
    for jf, tf in ((jnt_xent, tnt_xent), (jnce_loss, tnce_loss)):
        for temp in (1.0, 0.5):
            a, b = t(z1).requires_grad_(), t(z2).requires_grad_()
            got = tf(a, b, temp)
            got.backward()
            want, (ga, gb) = jax.value_and_grad(lambda x, y: jf(x, y, temp), argnums=(0, 1))(
                jnp.asarray(z1), jnp.asarray(z2))
            np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), rtol=RTOL, atol=ATOL)
