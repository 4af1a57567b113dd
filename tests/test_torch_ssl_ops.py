"""The port's self-supervised building blocks against the JAX package on the
CPU: the contrastive losses (value and gradient), ``split`` of a raw PRNG
key, ``spmm_views`` with per-view and per-layer PRF masks and with a
post-hop hook, the augmentations under injected draws, DCCF's
``adaptive_mask`` (value and gradient), ``kmeans`` from an injected initial
pick and ``svd_decompose`` from an injected Gaussian start.

Random draws differ between jax.random and torch, so JAX makes them here and
the port takes them as arguments; the dropout PRF is bit-exact in both.

Tolerances: rtol 1e-5, atol 1e-7 for one forward and backward pass (float
sums taken in another order); exact for keys, masks and the k-means
assignment; rtol 1e-4 (atol 1e-6) for the randomised SVD, whose QR and SVD
steps come from two LAPACK call sequences, compared through the sign-free
products U·S·Vᵀ and V·S·Uᵀ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.models import augment as jaugment
from sslrec_tpu.models import losses as jlosses
from sslrec_tpu.ops import sparse as jsparse
from sslrec_tpu.ops import spmm as jspmm
from sslrec_tpu.ops.pallas_spmm import _prf_uniform as j_prf_uniform
from sslrec_tpu_torch.models import augment as taugment
from sslrec_tpu_torch.models import losses as tlosses
from sslrec_tpu_torch.models.general_cf.dccf import plain_and_norm_adj
from sslrec_tpu_torch.models.general_cf.lightgcl import rect_norm_adj
from sslrec_tpu_torch.ops import sparse as tsparse
from sslrec_tpu_torch.ops import spmm as tspmm
from sslrec_tpu_torch.ops import spmm_kernel as sk

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-7


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _bi_graphs(tiny_ui):
    mat = jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape)
    return jsparse.from_scipy(mat), sk.build_csr_graph(tsparse.from_scipy(mat))


LOSSES = {
    # name: (JAX fn, port fn, input shapes, extra args)
    "infonce": (lambda a, b, c: jlosses.infonce_loss(a, b, c, 0.2),
                lambda a, b, c: tlosses.infonce_loss(a, b, c, 0.2),
                ((16, 8), (16, 8), (40, 8))),
    "infonce_spec_nodes": (
        lambda a, b: jlosses.infonce_loss_spec_nodes(a, b, jnp.asarray([0, 3, 3, 7, 29]), 0.1),
        lambda a, b: tlosses.infonce_loss_spec_nodes(a, b, torch.tensor([0, 3, 3, 7, 29]), 0.1),
        ((30, 8), (30, 8))),
    "alignment": (jlosses.alignment_loss, tlosses.alignment_loss, ((16, 8), (16, 8))),
    "uniformity": (jlosses.uniformity_loss, tlosses.uniformity_loss, ((24, 8),)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_grads_match_jax(name):
    jfn, tfn, shapes = LOSSES[name]
    xs = [_x(s, i) for i, s in enumerate(shapes)]
    xs[0][2] = 0.0                  # a zero row: the epsilons keep it finite
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(xs))))(
        *map(jnp.asarray, xs))
    txs = [_t(x).requires_grad_() for x in xs]
    tval = tfn(*txs)
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    for tx, jg in zip(txs, jgrads):
        assert np.isfinite(tx.grad.numpy()).all()
        _close(tx.grad, jg)


@pytest.mark.parametrize("key", [(0, 0), (1, 2), (2**32 - 1, 12345), (3987654321, 77)])
def test_split_is_jax_random_split(key):
    assert jax.config.jax_threefry_partitionable
    for num in (1, 2, 3, 5):
        want = np.asarray(jax.random.split(jnp.asarray(key, jnp.uint32), num))
        got = sk.split(torch.tensor(key, dtype=torch.int64), num)
        assert got.dtype == torch.int64 and got.shape == (num, 2)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a split key splits again, as the models split the step key per layer
    jk = jax.random.split(jax.random.split(jnp.asarray(key, jnp.uint32), 3)[2], 2)
    tk = sk.split(sk.split(torch.tensor(key, dtype=torch.int64), 3)[2], 2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


def _jprf(key, nnz, keep_rate, salt, resize_val):
    keep = jnp.floor(j_prf_uniform(key, jnp.arange(nnz, dtype=jnp.uint32), salt)
                     + jnp.float32(keep_rate))
    return keep / jnp.float32(keep_rate) if resize_val else keep


@pytest.mark.parametrize("mode", ["per_view", "per_view_and_layer"])
def test_spmm_views_prf_matches_jax(tiny_ui, mode):
    """SGL's two views: the step key split in two, one PRF mask per view
    (``edge_drop``) or per view and layer (``random_walk``'s salts, here
    rescaled), against JAX's ``spmm_views`` fed the same masks."""
    jg, tg = _bi_graphs(tiny_ui)
    L, keep, resize = 3, 0.6, mode != "per_view"
    key = jnp.asarray([2023, 99], jnp.uint32)
    jkeys = jax.random.split(key)
    salts = list(range(L)) if mode == "per_view_and_layer" else 0
    if mode == "per_view":
        jw = jnp.stack([_jprf(k, jg.nnz, keep, 0, resize) for k in jkeys])
    else:
        jw = jnp.stack([jnp.stack([_jprf(k, jg.nnz, keep, s, resize) for s in salts])
                        for k in jkeys])
    x0s = np.stack([_x((jg.n_cols, 8), 1), _x((jg.n_cols, 8), 2)])
    jfn = lambda x: jnp.sum(jnp.sin(jspmm.spmm_views(jg, x, L, jw)))  # noqa: E731
    jval, jdx = jax.value_and_grad(jfn)(jnp.asarray(x0s))
    prf = taugment.edge_drop(sk.split(torch.tensor([2023, 99])), tg, keep,
                             resize_val=resize, salts=salts)
    assert isinstance(prf, sk.PrfMask) and prf.ndim == jw.ndim
    np.testing.assert_array_equal(prf.w.numpy(), np.asarray(jw))
    tx = _t(x0s).requires_grad_()
    out = tspmm.spmm_views(tg, tx, L, prf)
    assert out.shape == (2, L, jg.n_rows, 8)
    tval = torch.sin(out).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    _close(tx.grad, jdx, atol=1e-6)


def test_spmm_views_post_hook_matches_jax(tiny_ui):
    """SimGCL's views: noise after every hop, each view and hop its own."""
    jg, tg = _bi_graphs(tiny_ui)
    L, eps, n = 2, 0.9, jg.n_rows
    keys = jax.random.split(jnp.asarray([5, 6], jnp.uint32), 2 * L).reshape(2, L, 2)
    noise = np.stack([[np.asarray(jax.random.uniform(keys[v, l], (n, 8))) for l in range(L)]
                      for v in range(2)])
    x0 = _x((n, 8), 3)
    jfn = lambda x: jnp.sum(jnp.sin(jspmm.spmm_views(  # noqa: E731
        jg, jnp.stack([x, x]), L, post=lambda k, y: jaugment.embed_perturb(k, y, eps),
        keys=keys)))
    jval, jdx = jax.value_and_grad(jfn)(jnp.asarray(x0))
    tx = _t(x0).requires_grad_()
    tval = torch.sin(tspmm.spmm_views(
        tg, [tx, tx], L, post=lambda u, y: taugment.embed_perturb(u, y, eps),
        keys=_t(noise))).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    _close(tx.grad, jdx, atol=1e-6)


@pytest.mark.parametrize("name", ["node_drop", "embed_dropout", "embed_perturb"])
def test_augmentations_match_jax_under_the_same_draws(name):
    key = jnp.asarray([8, 9], jnp.uint32)
    x = _x((50, 16), 4)
    x[3] = 0.0                                  # sign 0: no noise on that row
    if name == "node_drop":
        want = jaugment.node_drop(key, jnp.asarray(x), 0.7)
        got = taugment.node_drop(_t(jax.random.uniform(key, (50, 1))), _t(x), 0.7)
        assert 0 < int((got.abs().sum(1) == 0).sum()) < 50
    elif name == "embed_dropout":
        want = jaugment.embed_dropout(key, jnp.asarray(x), 0.25)
        got = taugment.embed_dropout(_t(jax.random.bernoulli(key, 0.75, (50, 16))),
                                     _t(x), 0.25)
    else:
        want = jaugment.embed_perturb(key, jnp.asarray(x), 0.1)
        got = taugment.embed_perturb(_t(jax.random.uniform(key, (50, 16))), _t(x), 0.1)
    _close(got, want)


def test_adaptive_mask_value_and_grads_match_jax(tiny_ui):
    """DCCF's learned edge values over its plain (all-ones) adjacency: the
    alpha-degree summed by B1 as a d = 1 hop with alpha as the weight."""
    n_u, n_i = tiny_ui.shape
    plain, _ = plain_and_norm_adj(tiny_ui, n_u, n_i, "cpu")
    assert plain.fwd.vals_ones and plain.bwd.vals_ones
    jg = jsparse.CooGraph(rows=jnp.asarray(plain.rows.numpy()),
                          cols=jnp.asarray(plain.cols.numpy()),
                          vals=jnp.asarray(plain.vals.numpy()), n_rows=plain.n_rows,
                          n_cols=plain.n_cols)
    h, t = _x((plain.n_rows, 8), 5), _x((plain.n_rows, 8), 6)
    w = _x((plain.nnz,), 7)

    def jfn(h, t):
        return jnp.sum(jnp.sin(jaugment.adaptive_mask(jg, h, t)) * w)

    jval, (jdh, jdt) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(t))
    th, tt = _t(h).requires_grad_(), _t(t).requires_grad_()
    vals = taugment.adaptive_mask(plain, th, tt)
    _close(vals, jaugment.adaptive_mask(jg, jnp.asarray(h), jnp.asarray(t)))
    tval = (torch.sin(vals) * _t(w)).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    _close(th.grad, jdh, atol=1e-6)
    _close(tt.grad, jdt, atol=1e-6)
    with pytest.raises(ValueError, match="must all be 1"):
        taugment.adaptive_mask(sk.build_csr_graph(tsparse.from_scipy(
            jsparse.make_bi_adj(tiny_ui, n_u, n_i))), th, tt)


@pytest.mark.parametrize("n,clusters", [(60, 5), (40, 50)], ids=["distinct", "replace"])
def test_kmeans_from_injected_pick_matches_jax(n, clusters):
    x = _x((n, 8), 8)
    key = jax.random.PRNGKey(3)
    jc, jidx, jcnt = jaugment.kmeans(key, jnp.asarray(x), clusters)
    pick = jax.random.choice(key, n, (clusters,), replace=n < clusters)
    tc, tidx, tcnt = taugment.kmeans(_t(x), clusters, pick=_t(pick).long())
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    _close(tc, jc, atol=1e-6)
    # drawn from a generator: distinct rows when there are enough
    c2, _, cnt2 = taugment.kmeans(_t(x), clusters, iters=0,
                                  gen=torch.Generator().manual_seed(0))
    assert cnt2.sum() == n and c2.shape == (clusters, 8)
    if n >= clusters:
        assert torch.unique(c2, dim=0).shape[0] == clusters


def test_svd_decompose_from_injected_omega_matches_jax(tiny_ui):
    """LightGCL's rank-5 SVD of the 1/√(rowD·colD) train matrix, at width
    q + 8 = 13 through B1's plain version."""
    q = 5
    g = rect_norm_adj(tiny_ui, "cpu")
    jg = jsparse.CooGraph(rows=jnp.asarray(g.rows.numpy()), cols=jnp.asarray(g.cols.numpy()),
                          vals=jnp.asarray(g.vals.numpy()), n_rows=g.n_rows, n_cols=g.n_cols)
    key = jax.random.PRNGKey(2023)
    jut, jvt, jus, jvs = jaugment.svd_decompose(key, jg, q)
    omega = jax.random.normal(key, (g.n_cols, q + 8), jnp.float32)
    tut, tvt, tus, tvs = taugment.svd_decompose(g, q, omega=_t(omega))
    for got, want in zip((tut, tvt, tus, tvs), (jut, jvt, jus, jvs)):
        assert tuple(got.shape) == want.shape
    _close(tus @ tvt, jus @ jvt, rtol=1e-4, atol=1e-6)
    _close(tvs @ tut, jvs @ jut, rtol=1e-4, atol=1e-6)
    # drawn from a generator, the factors have the same shapes
    again = taugment.svd_decompose(g, q, gen=torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in again] == [tuple(a.shape) for a in (tut, tvt, tus, tvs)]
