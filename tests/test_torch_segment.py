"""The port's segment ops (``sslrec_tpu_torch/ops/segment.py``,
``ops/segment_kernel.py``) against the JAX package: ``sslrec_tpu.ops.segment``
(XLA's ``jax.ops.segment_*``) and the blocked Pallas ops of
``sslrec_tpu/ops/pallas_segment.py`` in interpret mode with r=16, m=32, as
``tests/test_pallas_segment.py`` runs them.  Values and gradients.

On the CPU the B1/B2 wrappers take their plain versions, so these tests hold
the plain paths and the autograd around the kernels to JAX; the kernels are
held to the plain paths on the card by the last test here and by
``chip_smoke.py``.

Also KGCL's relation take (``OneHotTake``, whose backward is a B1 segment
sum) against a plain index and JAX's ``OneHotTake``, and B2's group-width
choice.

Tolerances: segment max is exact (a max has no rounding), −inf empties
included.  Sums, softmax, attention and their gradients: rtol 1e-5, atol 1e-6,
for float sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.ops import segment as jseg
from sslrec_tpu.ops.pallas_segment import OneHotTake as JOneHotTake
from sslrec_tpu.ops.pallas_segment import (attn_aggregate as j_attn_aggregate,
                                           build_blocked_segments, segment_max_blocked,
                                           segment_softmax_blocked, segment_sum_blocked,
                                           take_blocked)
from sslrec_tpu_torch.ops import segment as tseg
from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import spmm_kernel as sk

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", params=[True, False], ids=["sorted_ids", "unsorted_ids"])
def case(request):
    """n=1000 entries over 37 segments with skewed sizes and an empty
    segment (5); sorted ids as KG edges often are, or shuffled as the capped
    heads are."""
    rng = np.random.default_rng(0)
    n, S = 1000, 37
    ids = np.sort(rng.integers(0, S, n))
    ids[ids == 5] = 6
    if not request.param:
        ids = rng.permutation(ids)
    bs = build_blocked_segments(ids, S, r=16, m=32)
    ops = skn.SegmentOps(torch.from_numpy(ids.astype(np.int32)), S)
    data = rng.normal(size=(n, 8)).astype(np.float32)
    logits = (rng.normal(size=n) * 5).astype(np.float32)
    return bs, jnp.asarray(ids.astype(np.int32)), ops, data, logits, S


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a).copy()).requires_grad_(grad)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_layout_is_the_stable_argsort(case):
    bs, ids, ops, *_ = case
    lay = ops.layout
    ids = np.asarray(ids)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(lay.csr.cols.numpy(), order)
    np.testing.assert_array_equal(lay.csr.rows.numpy(), ids[order])
    np.testing.assert_array_equal(np.diff(lay.csr.indptr.numpy()),
                                  np.bincount(ids, minlength=lay.num_segments))
    np.testing.assert_array_equal(lay.ids.numpy(), ids)
    assert (lay.csr.vals.numpy() == 1).all() and lay.n == ids.shape[0]


@pytest.mark.parametrize("width", [None, 8], ids=["1d", "2d"])
def test_segment_sum_values_and_grad(case, width):
    bs, ids, ops, data, _, S = case
    x = data[:, 0] if width is None else data
    _close(ops.sum(_t(x)), jseg.segment_sum(jnp.asarray(x), ids, S))
    _close(ops.sum(_t(x)), segment_sum_blocked(bs, jnp.asarray(x), True))
    _close(tseg.segment_sum(_t(x), _t(ids), S), jseg.segment_sum(jnp.asarray(x), ids, S))

    jg = jax.grad(lambda d: jnp.sum(jnp.sin(segment_sum_blocked(bs, d, True))))(jnp.asarray(x))
    tx = _t(x, grad=True)
    torch.sin(ops.sum(tx)).sum().backward()
    _close(tx.grad, jg)


def test_take_values_and_grad(case):
    bs, ids, ops, data, _, S = case
    x = np.random.default_rng(1).normal(size=(S, 8)).astype(np.float32)
    np.testing.assert_array_equal(ops.take(_t(x)).detach().numpy(), np.asarray(x)[np.asarray(ids)])

    def f(x):
        return jnp.sum(jnp.cos(take_blocked(bs, x, True)) * data)

    tx = _t(x, grad=True)
    (torch.cos(ops.take(tx)) * _t(data)).sum().backward()
    _close(tx.grad, jax.grad(f)(jnp.asarray(x)))


def test_segment_max_exact_with_empty_segments(case):
    bs, ids, ops, _, logits, S = case
    got = skn.segment_max(ops.layout, _t(logits, grad=True))
    assert not got.requires_grad
    got = got.numpy()
    want_xla = np.asarray(jseg.segment_max(jnp.asarray(logits), ids, S))
    want_pallas = np.asarray(segment_max_blocked(bs, jnp.asarray(logits), True))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    assert got[5] == -np.inf and np.isfinite(np.delete(got, 5)).all()
    np.testing.assert_array_equal(tseg.segment_max(_t(logits), _t(ids), S).numpy(), want_xla)


def test_segment_max_edge_cases():
    """One-element segments, a segment longer than 1,024 entries, all-−1e9
    logits, no entries at all, and NaN propagation."""
    rng = np.random.default_rng(4)
    ids = np.concatenate([np.zeros(1500, np.int64), np.arange(1, 40), np.full(3, 45)])
    data = rng.normal(size=ids.size).astype(np.float32)
    data[-3:] = -1e9
    cases = [(ids, data, 50), (np.zeros(0, np.int64), np.zeros(0, np.float32), 4)]
    nan_data = data.copy()
    nan_data[7] = np.nan
    cases.append((ids, nan_data, 50))
    for ids_c, data_c, S in cases:
        lay = skn.build_segment_layout(ids_c, S)
        got = skn.segment_max(lay, _t(data_c)).numpy()
        want = np.asarray(jseg.segment_max(jnp.asarray(data_c), jnp.asarray(ids_c, jnp.int32), S))
        np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0]) and got[45] == np.float32(-1e9)


def test_segment_softmax_values_and_grad(case):
    bs, ids, ops, data, logits, S = case
    got = ops.softmax(_t(logits))
    _close(got, jseg.segment_softmax(jnp.asarray(logits), ids, S))
    _close(got, segment_softmax_blocked(bs, jnp.asarray(logits), True))
    _close(tseg.segment_softmax(_t(logits), _t(ids), S),
           jseg.segment_softmax(jnp.asarray(logits), ids, S))
    w = data[:, 0]

    def f(l):
        s = segment_softmax_blocked(bs, l, True)
        return jnp.sum(s * w + 0.1 * jnp.sin(s))

    tl = _t(logits, grad=True)
    s = ops.softmax(tl)
    (s * _t(w) + 0.1 * torch.sin(s)).sum().backward()
    _close(tl.grad, jax.grad(f)(jnp.asarray(logits)))


def test_attn_aggregate_with_mask_and_masked_segment(case):
    bs, ids, ops, data, logits, S = case
    mask = (np.random.default_rng(3).random(ids.shape[0]) > 0.4).astype(np.float32)
    mask[np.asarray(ids) == 7] = 0.0                   # a fully masked head
    jmask = jnp.asarray(mask)

    def fused(l, v):
        return j_attn_aggregate(bs, jnp.where(jmask > 0, l, -1e9), v, jmask, True)[0]

    def ref(l, v):
        e = jseg.segment_softmax(jnp.where(jmask > 0, l, -1e9), ids, S) * jmask
        return jseg.segment_sum(v * e[:, None], ids, S)

    tl, tv = _t(logits, grad=True), _t(data, grad=True)
    got = ops.attn(torch.where(_t(mask) > 0, tl, -1e9), tv, _t(mask))
    jl, jv = jnp.asarray(logits), jnp.asarray(data)
    _close(got, fused(jl, jv))
    _close(got, ref(jl, jv))
    assert (got[7] == 0).all()
    torch.sin(got).sum().backward()
    gl, gv = jax.grad(lambda l, v: jnp.sum(jnp.sin(fused(l, v))), argnums=(0, 1))(jl, jv)
    _close(tl.grad, gl)
    _close(tv.grad, gv)
    out, e = skn.attn_aggregate(ops.layout, _t(logits), _t(data))
    jout, je = j_attn_aggregate(bs, jl, jv, None, True)
    _close(out, jout)
    _close(e, je)


def test_segment_mean(case):
    bs, ids, ops, data, _, S = case
    want = jseg.segment_mean(jnp.asarray(data), ids, S)
    _close(ops.mean(_t(data)), want)
    _close(tseg.segment_mean(_t(data), _t(ids), S), want)
    _close(ops.mean(_t(data[:, 0])), jseg.segment_mean(jnp.asarray(data[:, 0]), ids, S))


def test_rgat_style_hop_grad(case):
    """A whole message-passing hop (gather endpoints → attention → weighted
    segment sum): gradients for the node embeddings match JAX's."""
    bs, ids, ops, data, logits, S = case
    rng = np.random.default_rng(2)
    n = ids.shape[0]
    tails = rng.integers(0, S, n)
    bs_t = build_blocked_segments(tails, S, r=16, m=32)
    ops_t = skn.SegmentOps(tails, S)
    x = rng.normal(size=(S, 8)).astype(np.float32)
    a = rng.normal(size=(8,)).astype(np.float32)

    def hop_jax(x):
        h_e, t_e = take_blocked(bs, x, True), take_blocked(bs_t, x, True)
        out, _ = j_attn_aggregate(bs, jnp.sum(h_e * t_e * a, axis=-1), t_e, None, True)
        return jnp.sum(jnp.sin(out))

    tx = _t(x, grad=True)
    h_e, t_e = ops.take(tx), ops_t.take(tx)
    val = torch.sin(ops.attn((h_e * t_e * _t(a)).sum(-1), t_e)).sum()
    val.backward()
    jval, jgrad = jax.value_and_grad(hop_jax)(jnp.asarray(x))
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    _close(tx.grad, jgrad)


def test_cpu_tensors_do_not_launch(case):
    *_, ops, _, logits, S = case
    before = (sk.csr_spmm.launches, skn.segment_max.launches)
    table = torch.randn(S, 8, requires_grad=True)
    ops.attn(_t(logits), ops.take(table)).sum().backward()
    ops.softmax(_t(logits, grad=True)).sum().backward()
    assert (sk.csr_spmm.launches, skn.segment_max.launches) == before


def test_relation_take_values_and_grad():
    """KGCL's relation take: 600 ids into 7 relations (one unused), table
    gradients as a plain index gives them and as JAX's one-hot matmul."""
    rng = np.random.default_rng(6)
    V, d = 7, 8
    ids = rng.integers(0, V - 1, 600)
    table = rng.normal(size=(V, d)).astype(np.float32)
    w = rng.normal(size=(ids.size, d)).astype(np.float32)
    take = skn.OneHotTake(torch.from_numpy(ids.astype(np.int32)), V)
    assert take.layout.num_segments == V and take.layout.n == ids.size
    tt, tp = _t(table, grad=True), _t(table, grad=True)
    got = take.take(tt)
    np.testing.assert_array_equal(got.detach().numpy(), table[ids])
    (torch.sin(got) * _t(w)).sum().backward()
    (torch.sin(tp[torch.from_numpy(ids)]) * _t(w)).sum().backward()
    _close(tt.grad, tp.grad.numpy())
    assert (tt.grad[V - 1] == 0).all()
    jtake = JOneHotTake(jnp.asarray(ids, jnp.int32), V)
    jonehot = JOneHotTake(jnp.asarray(ids, jnp.int32), V)
    jonehot.onehot = jax.nn.one_hot(jonehot.ids, V, dtype=jnp.float32)   # the TPU design
    for jt in (jtake, jonehot):
        np.testing.assert_array_equal(np.asarray(jt.take(jnp.asarray(table))), table[ids])
        jgrad = jax.grad(lambda x: jnp.sum(jnp.sin(jt.take(x)) * w))(jnp.asarray(table))
        _close(tt.grad, jgrad)


@pytest.mark.parametrize("length", [0, 1, 9, 17, 5000])
def test_segmax_group_width_and_long_bin(length):
    """The host's group width follows the mean segment length; segments longer
    than LONG_STRIDES strides of a group go to the whole-warp bin; the plain
    max is exact for a segment of ``length`` slots among 9-slot ones."""
    assert skn.segmax_group_width(np.array([], np.int64)) == 4
    for mean, want in ((1, 4), (9.9, 4), (16, 4), (17, 8), (33, 16), (65, 32), (5000, 32)):
        assert skn.segmax_group_width(np.array([mean])) == want
    rng = np.random.default_rng(length)
    lengths = np.array([9] * 40 + [length, 0, 9])
    ids = rng.permutation(np.repeat(np.arange(lengths.size), lengths))
    lay = skn.build_segment_layout(ids, lengths.size)
    width = skn.segmax_group_width(lengths)
    assert lay.group_width == width
    np.testing.assert_array_equal(lay.long_segments.numpy(),
                                  np.flatnonzero(lengths > skn.LONG_STRIDES * width))
    assert (40 in lay.long_segments.tolist()) == (length > skn.LONG_STRIDES * width)
    data = rng.normal(size=ids.size).astype(np.float32)
    got = skn.segment_max(lay, _t(data)).numpy()
    want = np.asarray(jseg.segment_max(jnp.asarray(data), jnp.asarray(ids, jnp.int32),
                                       lengths.size))
    np.testing.assert_array_equal(got, want)
    assert got[41] == -np.inf and (got[40] == -np.inf) == (length == 0)


def test_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment-max kernel has no CPU mode")
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(0, 300, 5000), np.zeros(2000, np.int64)])
    ids = rng.permutation(ids)
    lay = skn.build_segment_layout(ids, 310, "cuda")
    assert lay.group_width == 8 and lay.long_segments.tolist() == [0]
    short = rng.permutation(np.concatenate([rng.integers(0, 3000, 30000),
                                            np.full(5000, 3001)]))   # packed + long bin
    lay_short = skn.build_segment_layout(short, 3010, "cuda")
    lengths = np.bincount(short, minlength=3010)
    assert lay_short.group_width == 4 and 3001 in lay_short.long_segments.tolist()
    np.testing.assert_array_equal(lay_short.long_segments.cpu().numpy(),
                                  np.flatnonzero(lengths > skn.LONG_STRIDES * 4))
    cases = [(lay, ids.size), (lay_short, short.size)]
    for width, mean in ((16, 60), (32, 200)):     # the host's other two group widths
        lengths = rng.integers(mean // 2, 3 * mean // 2 + 1, 200)
        lengths[7], lengths[9] = 0, 10 * mean       # empty, and for the whole-warp bin
        ids_w = rng.permutation(np.repeat(np.arange(lengths.size), lengths))
        lay_w = skn.build_segment_layout(ids_w, lengths.size, "cuda")
        assert lay_w.group_width == width and 9 in lay_w.long_segments.tolist()
        cases.append((lay_w, ids_w.size))
    for lay_c, n in cases:
        for data in (torch.randn(n, device="cuda"), torch.full((n,), -1e9, device="cuda")):
            before = skn.segment_max.launches
            got = skn.segment_max(lay_c, data)
            assert skn.segment_max.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, skn.segment_max_plain(lay_c, data))
    rel = skn.OneHotTake(rng.integers(0, 41, 30000), 41, "cuda")
    g_rel = torch.randn(30000, 64, device="cuda")
    table = torch.randn(41, 64, device="cuda", requires_grad=True)
    (rel.take(table) * g_rel).sum().backward()
    ref = torch.zeros(41, 64, device="cuda").index_add_(0, rel.layout.ids.long(), g_rel)
    torch.cuda.synchronize()
    assert float((table.grad - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(skn._segment_sum(rel.layout, g_rel), table.grad)   # deterministic
    for d in (1, 64, 65):
        x = torch.randn(ids.size, d, device="cuda")
        got = skn.SegmentSumFn.apply(lay, x)
        ref = tseg.segment_sum(x, lay.ids, lay.num_segments)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
