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
sum) against a plain index and JAX's ``OneHotTake``, and B2's plan: a model
of its kernel, warp by warp and lane by lane, on layouts that take every path
of the plan (``_b2_model``), its runs and scratch, the host's rule for the
segments it combines across runs, and its plain version on power-law heads.

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


NO_SEGMENT = 2 ** 31 - 1      # the kernel's id of a slot past n


def _key(x):
    """The kernel's order key of a float32: −0 below +0, a NaN (its sign
    cleared) above +inf."""
    b = np.asarray(x, np.float32).view(np.int32)
    b = np.where(np.isnan(x), b & 0x7FFFFFFF, b)
    return int(b ^ ((b >> 31) & 0x7FFFFFFF))


def _key_float(k):
    return np.int32(k ^ ((k >> 31) & 0x7FFFFFFF)).view(np.float32)


def _b2_model(lay, data, order_seed=0):
    """B2's decomposition as ``csrc/segment_max.cu`` runs it, warp by warp and
    lane by lane, the runs taken in a seeded random order (the card's blocks
    run in none) and their arrivals counted in another: the run that counts
    a spread segment's last part combines it, once every part is written (on
    the card it waits for them).  Returns ``(out, writes, spread)``: the
    output, how often each segment was written, and ``{segment: parts}`` of
    the segments whose parts met through ``arrivals``; asserts that every
    counter is back at 0 and that each part was written before it was
    read."""
    rows, perm = lay.csr.rows.numpy(), lay.csr.cols.numpy()
    indptr, x_all = lay.csr.indptr.numpy(), data.numpy()
    n, n_seg, run_len, window = lay.n, lay.num_segments, skn.RUN_SLOTS, skn.RUN_WINDOW
    v = run_len // 32
    n_runs = -(-n // run_len)
    low = -2 ** 31                                      # below every key
    out, writes = np.zeros(n_seg, np.float32), np.zeros(n_seg, np.int64)
    partials, arrivals, spread = [None] * (2 * n_runs), np.zeros(n_runs, np.int64), {}

    def write(seg, key):
        out[seg] = _key_float(key)
        writes[seg] += 1

    pending = []                                        # arrivals, counted after the runs

    def arrive(slot, part, seg, start, end):
        partials[slot] = part
        pending.append((slot, seg, start, end))

    def slot(s):
        return (rows[s], _key(x_all[perm[s]])) if s < n else (NO_SEGMENT, low)

    for run in np.random.default_rng(order_seed).permutation(n_runs):
        base = run * run_len
        lanes = [[slot(base + v * lane + k) for k in range(v)] for lane in range(32)]
        win = [slot(base + run_len + lane) for lane in range(32)]
        first, last = lanes[0][0][0], lanes[31][v - 1][0]
        f_start, f_end = indptr[first], indptr[first + 1]
        l_start, l_end = (indptr[last], indptr[last + 1]) if last != NO_SEGMENT else (0, 0)
        before = f_start < base
        first_spread = before and f_end > (f_start // run_len + 1) * run_len + window
        runs_on = last != NO_SEGMENT and win[0][0] == last
        # the kernel places them from the ids at a few slots, not from indptr

        def row(s):
            return rows[s] if 0 <= s < n else NO_SEGMENT

        assert before == (row(base - 1) == first)
        assert first_spread == (before and (row(base - run_len - 1) == first
                                            or row(base + window) == first))
        last_own = runs_on and not (last == first and before)
        assert (last_own and l_end > base + run_len + window) == (
            last_own and row(base + run_len + window) == last)
        fid, lid, head, tail = [], [], [], []
        for sl in lanes:
            cur, m, h = sl[0][0], sl[0][1], low
            for seg, x in sl[1:]:
                if seg != cur:
                    if cur == sl[0][0]:
                        h = m
                    else:
                        write(cur, m)
                    cur, m = seg, x
                else:
                    m = max(m, x)
            fid.append(sl[0][0])
            lid.append(sl[-1][0])
            head.append(h)
            tail.append(m)
        s = list(tail)
        flag = [lane == 0 or fid[lane] != lid[lane] or lid[lane - 1] != fid[lane]
                for lane in range(32)]
        off = 1
        while off < 32:                                  # the shuffle scan, step by step
            s_old, f_old = list(s), list(flag)
            for lane in range(off, 32):
                if not f_old[lane]:
                    s[lane] = max(s_old[lane - off], s_old[lane])
                flag[lane] = f_old[lane] or f_old[lane - off]
            off *= 2
        parts = []

        def finish(seg, val):
            if seg == NO_SEGMENT:
                return
            if seg == first and before:
                if first_spread:
                    parts.append(val)
            else:
                write(seg, val)

        for lane in range(32):
            if fid[lane] != lid[lane]:
                finish(fid[lane], max(s[lane - 1], head[lane])
                       if lane > 0 and lid[lane - 1] == fid[lane] else head[lane])
            if (lid[lane] != fid[lane + 1]) if lane < 31 else not runs_on:
                finish(lid[lane], s[lane])
        assert len(parts) <= 1
        if parts:
            arrive(2 * run, parts[0], first, f_start, f_end)
        if runs_on:
            if last == first and before:
                arrive(2 * run, s[31], first, f_start, f_end)
            elif l_end > base + run_len + window:
                arrive(2 * run + 1, s[31], last, l_start, l_end)
            else:
                w = low
                for seg, x in win:
                    w = max(w, x) if seg == last else w
                write(last, max(s[31], w))
    rng = np.random.default_rng(order_seed + 1)
    for i in rng.permutation(len(pending)):                # the counts, in their own order
        slot_, seg, start, end = pending[i]
        owner = start // run_len
        parts = (end - 1) // run_len - owner + 1
        arrivals[owner] += 1
        if arrivals[owner] == parts:                     # the last to count combines
            m = low
            for j in range(parts):
                got = partials[2 * owner + 1 if j == 0 else 2 * (owner + j)]
                assert got is not None
                m = max(m, got)
            write(seg, m)
            arrivals[owner] = 0
            spread[seg] = parts
    for seg in range(n_seg):                  # the threads past the runs, 4 segments each
        if indptr[seg] == indptr[seg + 1]:
            write(seg, _key(np.float32(-np.inf)))
    assert not arrivals.any()
    return out, writes, spread


def _zipf_ids(n, n_seg, seed=24, power=1.1):
    """``n`` ids over ``n_seg`` segments, id i drawn with p ∝ 1/(i +
    1)^power, then the slots shuffled (``chip_smoke.zipf_heads``): a KG whose
    head degrees follow a power law."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_seg + 1) ** power
    return rng.permutation(rng.choice(n_seg, n, p=p / p.sum()))


def _b2_cases():
    """(ids, segments) of every path of the kernel's plan (runs of 128
    slots): closed in the run, closed in the next run's first 32
    slots, spread over 2 and over many runs, ending exactly on a run's end
    and on the window's, a run that is all one segment, a ragged last run,
    0 slots, 0 segments."""
    rng = np.random.default_rng(7)

    def of_lengths(lengths):
        return rng.permutation(np.repeat(np.arange(len(lengths)), lengths)), len(lengths)

    return {
        "zipf": (_zipf_ids(3000, 300), 300),
        "uniform": (rng.integers(0, 300, 3000), 300),
        "ends_on_run_end": of_lengths([100, 28, 128, 64, 64, 1, 127]),
        "ends_on_window_end": of_lengths([120, 40, 96, 160, 50]),
        "one_past_window": of_lengths([120, 41, 95, 161, 49]),
        "spans_many_runs": of_lengths([3, 1000, 0, 0, 2, 700, 5, 1]),
        "one_segment": (np.full(1000, 2), 4),
        "singletons": (rng.permutation(700), 750),
        "exact_runs": (rng.integers(0, 9, 512), 9),
        "n0": (np.zeros(0, np.int64), 5),
        "no_segments": (np.zeros(0, np.int64), 0)}


# {case: {spread segment: parts}} where the lengths fix it
B2_SPREAD = {"ends_on_run_end": {}, "ends_on_window_end": {}, "one_past_window": {1: 2, 3: 2},
             "spans_many_runs": {1: 8, 5: 7}, "one_segment": {2: 8}, "singletons": {},
             "n0": {}, "no_segments": {}}


@pytest.mark.parametrize("order_seed", [0, 2])
@pytest.mark.parametrize("name", list(_b2_cases()))
def test_b2_runs_plan(name, order_seed):
    """The kernel's plan, run through its model: every segment written
    exactly once (−inf where empty), the spread segments those that
    ``spread_segments`` lists, each combined from all its parts, the
    counters back at 0, in any order of the runs; the result bit-equal to
    the plain version and to JAX's segment max, with a NaN inside the
    longest segment."""
    ids, n_seg = _b2_cases()[name]
    lay = skn.build_segment_layout(ids, n_seg)
    data = np.random.default_rng(1).normal(size=ids.size).astype(np.float32)
    if ids.size:
        longest = np.flatnonzero(ids == np.bincount(ids).argmax())
        data[longest[len(longest) // 2]] = np.nan
    got, writes, spread = _b2_model(lay, _t(data), order_seed)
    again, *_ = _b2_model(lay, _t(data), order_seed + 1)
    assert (writes == 1).all()
    segs, owners, parts = skn.spread_segments(lay.csr.indptr)
    assert spread == dict(zip(segs.tolist(), parts.tolist()))
    np.testing.assert_array_equal(owners, lay.csr.indptr.numpy()[segs] // skn.RUN_SLOTS)
    want = skn.segment_max(lay, _t(data)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(again.view(np.int32), got.view(np.int32))
    jwant = np.asarray(jseg.segment_max(jnp.asarray(data), jnp.asarray(ids, jnp.int32), n_seg))
    np.testing.assert_array_equal(got, jwant)
    if name in B2_SPREAD:
        assert spread == B2_SPREAD[name]


def test_b2_signed_zeros():
    """Of −0 and +0 in one segment the kernel's max is +0 in either order;
    a segment of −0 alone gives −0."""
    ids = np.repeat(np.arange(6), [2, 2, 200, 3, 1, 300])
    data = np.full(ids.size, -1.0, np.float32)
    data[[0, 3]] = -0.0
    data[[1, 2]] = 0.0
    data[4:204] = np.where(np.arange(200) % 2, -0.0, 0.0)
    data[204:207] = -0.0
    data[207] = 0.0
    data[208:] = -0.0
    lay = skn.build_segment_layout(ids, 6)
    got, writes, _ = _b2_model(lay, _t(data))
    assert (writes == 1).all() and (got == 0).all()
    np.testing.assert_array_equal(np.signbit(got), [False, False, False, True, False, True])


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 1000, 12345, 300000])
def test_segmax_plan(n):
    """The plan's runs of 128 slots and its scratch: zero counters, two
    parts a run, made once a layout; the call's epoch runs from 1 to
    2^32 − 1, then wraps to 1."""
    lay = skn.build_segment_layout(np.arange(n) % 7, 7)
    plan = skn.segmax_plan(lay)
    assert plan.n_runs == -(-n // 128) and plan.partials.shape == (2 * plan.n_runs,)
    assert plan.arrivals.shape == (plan.n_runs,)
    assert plan.arrivals.dtype == torch.int32 and not plan.arrivals.any()
    assert plan.partials.dtype == torch.int64 and not plan.partials.any()
    assert skn.segmax_plan(lay) is plan
    assert [plan.next_epoch() for _ in range(3)] == [1, 2, 3]
    plan.epoch = 2 ** 32 - 1
    assert plan.next_epoch() == 1


@pytest.mark.parametrize("lengths,want", [
    ([128, 5], {}),                       # ends on its run's end
    ([160, 5], {}),                       # ends on the window's end
    ([161, 5], {0: 2}),                   # one slot past the window
    ([100, 60, 5], {}),                   # straddles two runs, closed in the window
    ([100, 61, 5], {1: 2}),               # straddles two runs, past the window
    ([3, 640, 0, 5], {1: 6})])            # over six runs, an empty one after it
def test_spread_segments(lengths, want):
    """The host's rule for the segments the kernel combines across runs:
    those that end more than ``RUN_WINDOW`` slots past the end of the run of
    their first slot, each with its owner and the runs it touches."""
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    segs, owners, parts = skn.spread_segments(indptr)
    assert dict(zip(segs.tolist(), parts.tolist())) == want
    np.testing.assert_array_equal(owners, indptr[segs] // skn.RUN_SLOTS)


def test_segment_max_zipf_against_jax():
    """B2's plain version on the seeded power-law heads at a small size
    (6,000 slots into 600 segments, a tenth of them or more empty) against
    JAX's segment max, bit for bit: −inf for the empty segments, NaN inside
    the longest, all −1e9; and on a strided column of [n, 2] logits."""
    ids = _zipf_ids(6000, 600)
    lay = skn.build_segment_layout(ids, 600)
    counts = np.bincount(ids, minlength=600)
    assert counts.max() > 500 and (counts == 0).sum() >= 60
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(ids.size, 2)) * 5).astype(np.float32)
    nan = logits[:, 0].copy()
    nan[np.flatnonzero(ids == counts.argmax())[100]] = np.nan
    for data in (logits[:, 0], nan, np.full(ids.size, -1e9, np.float32), logits[:, 1]):
        got = skn.segment_max(lay, _t(data)).numpy()
        want = np.asarray(jseg.segment_max(jnp.asarray(data), jnp.asarray(ids, jnp.int32), 600))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert (got[counts == 0] == -np.inf).all()
    column = skn.segment_max(lay, _t(logits)[:, 1])
    np.testing.assert_array_equal(column.numpy(), skn.segment_max(lay, _t(logits[:, 1])).numpy())
    assert np.isnan(skn.segment_max(lay, _t(nan)).numpy()[counts.argmax()])


def test_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment-max kernel has no CPU mode")
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(0, 300, 5000), np.zeros(2000, np.int64)])
    ids = rng.permutation(ids)
    lay = skn.build_segment_layout(ids, 310, "cuda")
    cases = [(lay, None), *((skn.build_segment_layout(i, s, "cuda"), None)
                            for i, s in _b2_cases().values())]
    more_runs = sk.resident_threads(0) * 4 + 1     # more runs than the card holds warps
    cases.append((skn.build_segment_layout(_zipf_ids(more_runs, 30000), 30000, "cuda"), None))
    logits = torch.randn(ids.size, 2, device="cuda")
    cases.append((lay, logits[:, 1]))                 # a strided column, read in place
    for lay_c, column in cases:
        n = lay_c.n
        for data in ((torch.randn(n, device="cuda"), torch.full((n,), -1e9, device="cuda"))
                     if column is None else (column,)):
            before = skn.segment_max.launches
            got = skn.segment_max(lay_c, data)
            assert skn.segment_max.launches == before + 1
            torch.cuda.synchronize()
            want = skn.segment_max_plain(lay_c, data.contiguous())
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert torch.equal(skn.segment_max(lay_c, data).view(torch.int32),
                               got.view(torch.int32))
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
