"""B1's schedule against the plain version and the JAX package's kernel.

``csr_spmm_split_plain`` follows the CUDA kernel's order of every sum: each
chunk's edges in order where the lanes hold features (d > 4), lane-strided
over the group's lanes and added by the fixed xor butterfly at d <= 4, then
the split rows' combine tree (``SplitPlan.node_ptr`` …) level by level, each
node's partials in slot order (lane-strided with the butterfly at d <= 4).
Here it is held to ``csr_spmm_plain`` and to the JAX package's
``pallas_spmm`` (Pallas in interpret mode with r=16, m=32, as
``tests/test_pallas_spmm.py`` runs it) at d 1, 2, 3, 4, 13, 32 and 65 in
all three multiplier modes (none, a tensor, the in-kernel PRF), on graphs
with a row of 100,000 entries (the JAX kernel at two widths) or 5,000
entries beside rows of T-1, T and T+1 entries; trees of fan-in 2, 3 and
``FAN_IN``; and in the bf16 mode.

Tolerances: exact on small integers (x in [-8, 8], values in {0.5, 1, 2},
weights in {0, 0.5, 1}: every partial sum is exact in float32, so a lost,
repeated or misplaced term shows whatever the order); 1e-5 of the largest
entry on random floats, the same sum in another order.  The plans' trees
are checked field by field for covering every partial once, in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.ops.pallas_spmm import (build_pallas_graph_host, dropout_padded,
                                        pallas_spmm, pallas_spmm_pv)
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.ops.sparse import CooGraph

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

T = 32
N_COLS = 300
WIDTHS = (1, 2, 3, 4, 13, 32, 65)
KEY = (2**32 - 7, 99)


def _graph(long_row: int, seed: int = 0):
    """Rows of ``long_row``, T-1, T, T+1, 2T, 2T+1 and 4T+3 entries, short
    and empty rows (first, inner and last), values in {0.5, 1, 2}: the JAX
    graph (host arrays) and the port's, in the same edge order."""
    rng = np.random.default_rng(seed)
    deg = np.array([0, long_row, T - 1, T, T + 1, 0, 1, 3, 2 * T, 2 * T + 1, 4 * T + 3, 2, 0])
    rows = np.repeat(np.arange(deg.size), deg)
    cols = rng.integers(0, N_COLS, rows.size)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.choice(np.float32([0.5, 1.0, 2.0]), rows.size)
    pg = build_pallas_graph_host(rows, cols, vals, deg.size, N_COLS, r=16, m=32)
    tg = sk.build_csr_graph(CooGraph(rows=torch.from_numpy(rows.astype(np.int32)),
                                     cols=torch.from_numpy(cols.astype(np.int32)),
                                     vals=torch.from_numpy(vals), n_rows=deg.size,
                                     n_cols=N_COLS))
    return pg, tg, deg


@pytest.fixture(scope="module")
def long_graph():
    return _graph(100_000)


@pytest.fixture(scope="module")
def mid_graph():
    return _graph(5_000, seed=1)


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-8, 9, shape).astype(np.float32)


def _modes(tg, seed):
    """(name, port multiplier, JAX multiplier) of the three modes."""
    ew = np.random.default_rng(seed).choice(np.float32([0.0, 0.5, 1.0]), tg.nnz)
    return [("none", None, None), ("tensor", torch.from_numpy(ew), jnp.asarray(ew)),
            ("prf", sk.prf_mask(torch.tensor(KEY), tg, 0.5), "prf")]


def _jax(pg, x, w):
    if w is None or not isinstance(w, str):
        return np.asarray(pallas_spmm(pg, jnp.asarray(x), w, True))
    pw = dropout_padded(jnp.asarray(KEY, jnp.uint32), pg, keep_rate=0.5)
    return np.asarray(pallas_spmm_pv(pg, jnp.asarray(x), pw.fwd, pw.bwd, True))


def _groups(d):
    return (2, 4, 16) if d <= sk.NARROW_D else (None,)


@pytest.mark.parametrize("fan_in", [2, 3, sk.FAN_IN])
@pytest.mark.parametrize("t", [T, 7])
def test_combine_tree_covers_every_partial_once_in_order(mid_graph, t, fan_in):
    _, tg, _ = mid_graph
    for lay in (tg.fwd, tg.bwd):
        plan = sk.split_plan(lay.indptr, t, fan_in)
        ptr, dst = plan.node_ptr.numpy(), plan.node_dst.numpy()
        owner = plan.slot_node.numpy()
        # the nodes' partial ranges tile [0, n_partials) in order, none empty or over R
        sizes = np.diff(ptr)
        assert ptr[0] == 0 and ptr[-1] == plan.n_partials
        assert (sizes >= 1).all() and (sizes <= fan_in).all()
        np.testing.assert_array_equal(owner, np.repeat(np.arange(dst.size), sizes))
        # a root a split row; the other nodes write the partials after the chunks', in order
        np.testing.assert_array_equal(np.sort(dst[dst >= 0]), plan.split_rows.numpy())
        np.testing.assert_array_equal(-1 - dst[dst < 0],
                                      np.arange(plan.n_slots, plan.n_partials))
        assert plan.n_first == 0 or ptr[plan.n_first] == plan.n_slots
        assert plan.arrivals.dtype == torch.int32 and plan.arrivals.shape == dst.shape
        assert not plan.arrivals.any()
        # each split row: its chunks' partials, then each level's, are runs of
        # consecutive slots cut into nodes of fan_in from the first, up to a root
        chunk_dst, chunk_row = plan.chunk_dst.numpy(), plan.chunk_row.numpy()
        n_chunks = -(-np.diff(lay.indptr.numpy()) // t)
        for r in plan.split_rows.numpy():
            level = -1 - chunk_dst[chunk_row == r]          # its chunks' partials, chunk order
            assert level.size == n_chunks[r] and (level >= 0).all()
            depth = 0
            while True:
                assert (np.diff(level) == 1).all()
                runs = -(-level.size // fan_in)
                nodes = owner[level]
                np.testing.assert_array_equal(
                    nodes, nodes[0] + np.arange(level.size) // fan_in)
                depth += 1
                up = dst[nodes[0] + np.arange(runs)]
                if runs == 1:
                    assert up[0] == r
                    break
                assert (up < 0).all()
                level = -1 - up
            assert depth == int(np.ceil(np.log(n_chunks[r]) / np.log(fan_in) - 1e-9))


@pytest.mark.parametrize("d", WIDTHS)
def test_schedule_matches_plain_exactly(long_graph, d):
    _, tg, _ = long_graph
    for lay in (tg.fwd, tg.bwd):
        x = torch.from_numpy(_ints((lay.n_cols, d), d))
        for name, w, _ in _modes(tg, d):
            ref = sk.csr_spmm_plain(lay, x.double(), w).float()
            for t, fan_in in ((T, sk.FAN_IN), (T, 2), (7, 3)):
                plan = sk.split_plan(lay.indptr, t, fan_in)
                for group in _groups(d):
                    got = sk.csr_spmm_split_plain(lay, plan, x, w, group)
                    assert torch.equal(got, ref), (name, t, fan_in, group)


@pytest.mark.parametrize("d", WIDTHS)
def test_schedule_on_random_floats(long_graph, d):
    _, tg, _ = long_graph
    lay = tg.fwd
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((lay.n_cols, d))
                         .astype(np.float32))
    for name, w, _ in _modes(tg, d + 1):
        ref = sk.csr_spmm_plain(lay, x.double(), w)
        for group in _groups(d):
            got = sk.csr_spmm_split_plain(lay, sk.split_plan(lay.indptr, T), x, w, group)
            err = float((got.double() - ref).abs().max())
            assert err <= 1e-5 * float(ref.abs().max()), (name, group, err)


@pytest.mark.parametrize("d", WIDTHS)
def test_schedule_matches_jax(mid_graph, d):
    pg, tg, _ = mid_graph
    x = _ints((tg.n_cols, d), 10 + d)
    plan = sk.split_plan(tg.fwd.indptr, T, 3)
    for name, w, jw in _modes(tg, 20 + d):
        want = _jax(pg, x, jw)
        for group in _groups(d):
            got = sk.csr_spmm_split_plain(tg.fwd, plan, torch.from_numpy(x), w, group)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {group}")


@pytest.mark.parametrize("d", [1, 32])
def test_long_row_matches_jax(long_graph, d):
    pg, tg, deg = long_graph
    x = _ints((tg.n_cols, d), 30 + d)
    plan = sk.split_plan(tg.fwd.indptr, T)
    assert plan.n_first < plan.node_dst.shape[0]      # the long row's tree has levels
    for name, w, jw in _modes(tg, 40 + d):
        got = sk.csr_spmm_split_plain(tg.fwd, plan, torch.from_numpy(x), w)
        np.testing.assert_array_equal(got.numpy(), _jax(pg, x, jw), err_msg=name)
    assert deg.max() >= 100_000


@pytest.mark.parametrize("d", [1, 2, 3, 4, 32])
def test_schedule_in_bf16_mode(long_graph, d, monkeypatch):
    """bf16 mode: each contribution bf16(bf16(x)·bf16(vals·w)); on small
    integers exact, so the schedule's sums equal the plain version's."""
    _, tg, _ = long_graph
    monkeypatch.setenv("SSLREC_PALLAS_PRECISION", "default")
    sk.bf16_mode.cache_clear()
    try:
        assert sk.bf16_mode()
        lay = tg.bwd
        x = torch.from_numpy(_ints((lay.n_cols, d), 50 + d))
        plan = sk.split_plan(lay.indptr, T, 3)
        for name, w, _ in _modes(tg, 60 + d):
            ref = sk.csr_spmm_plain(lay, x.double(), w).float()
            for group in _groups(d):
                assert torch.equal(sk.csr_spmm_split_plain(lay, plan, x, w, group), ref), name
    finally:
        monkeypatch.delenv("SSLREC_PALLAS_PRECISION")
        sk.bf16_mode.cache_clear()


H100_SXM_THREADS = 132 * 2048


@pytest.fixture
def bf16_mode(monkeypatch):
    """Both packages' bf16 mode (``SSLREC_PALLAS_PRECISION=default``), their
    caches of the variable cleared around the test."""
    from sslrec_tpu.ops import pallas_spmm as jps

    monkeypatch.setenv("SSLREC_PALLAS_PRECISION", "default")
    jps._mxu_precision.cache_clear()
    sk.bf16_mode.cache_clear()
    yield
    monkeypatch.delenv("SSLREC_PALLAS_PRECISION")
    jps._mxu_precision.cache_clear()
    sk.bf16_mode.cache_clear()


def _layout(nnz: int, n_rows: int, n_cols: int) -> sk.CsrLayout:
    """A layout with only the sizes the schedule reads."""
    z = torch.zeros(nnz, dtype=torch.int32)
    return sk.CsrLayout(indptr=torch.zeros(n_rows + 1, dtype=torch.int32), rows=z, cols=z,
                        vals=z.float(), edge_ids=z, n_rows=n_rows, n_cols=n_cols,
                        ids_identity=True, vals_ones=False, plans=sk.PlanCache())


# (name, nnz, n_rows, n_cols, d, cast to bf16 rows, lane group, T over bf16
# rows in the bf16 mode, T in the float32 mode) on an H100 SXM's threads
BF16_SCHEDULES = (
    ("lightgcn_hop", 502_048, 144_777, 144_777, 32, True, 4, 16, 32),
    ("maerec_hop", 740_336, 18_358, 18_358, 64, True, 8, 32, 64),
    ("dcrec_seq_hop", 317_224, 18_358, 18_358, 64, True, 8, 16, 32),
    ("kcgn_ii_hop", 3_439_046, 29_422, 29_422, 128, True, 16, 256, 512),
    ("kgcl_segment_sum", 297_404, 30_000, 297_404, 64, False, 8, 16, 32),
    ("lightgcl_rect_t", 251_024, 30_040, 114_737, 32, True, 4, 16, 32),
    ("degree_sum_d1", 297_404, 30_000, 297_404, 1, True, 4, 16, 32),
    ("lightgcn_hop_d36", 502_048, 144_777, 144_777, 36, False, 8, 16, 32),
    ("lightgcn_hop_d65", 502_048, 144_777, 144_777, 65, False, 32, 64, 128))


@pytest.mark.parametrize("case", BF16_SCHEDULES, ids=[c[0] for c in BF16_SCHEDULES])
def test_bf16_schedule_values(case, bf16_mode):
    """The bf16 mode's rows and schedule, value by value: bf16 rows (cast
    before the kernel) where ``d % 8 == 0`` and a layout gathers each row of
    x at least ``CAST_READS`` times, or at d <= 4; the float32 rule's lane group (one
    lane per 8 values: a 16-byte vector of bf16); over bf16 rows half the
    float32 split threshold, so a chunk gathers the same bytes."""
    _, nnz, n_rows, n_cols, d, cast, group, t_bf16, t_f32 = case
    lay = _layout(nnz, n_rows, n_cols)
    assert sk.bf16_rows(lay, d) is cast
    assert sk.row_bytes(lay, d) == (2 if cast else 4)
    assert sk.lane_group(d, sk.mean_degree(lay)) == group
    want = t_bf16 if cast else t_f32
    assert sk.schedule(lay, d, H100_SXM_THREADS) == (group, want)
    assert sk.split_threshold(nnz, group, H100_SXM_THREADS, 2) == t_bf16
    assert sk.split_threshold(nnz, group, H100_SXM_THREADS) == t_f32


def test_float32_schedule_unchanged_by_the_bf16_rule(monkeypatch):
    """Outside the bf16 mode every layout gathers float32 rows, at the
    float32 threshold, whatever its reads a row."""
    monkeypatch.delenv("SSLREC_PALLAS_PRECISION", raising=False)
    sk.bf16_mode.cache_clear()
    for _, nnz, n_rows, n_cols, d, _, group, _, t_f32 in BF16_SCHEDULES:
        lay = _layout(nnz, n_rows, n_cols)
        assert sk.row_bytes(lay, d) == 4
        assert sk.schedule(lay, d, H100_SXM_THREADS) == (group, t_f32)


@pytest.mark.parametrize("cast", [True, False], ids=["bf16_rows", "f32_rows"])
def test_bf16_split_schedule_matches_jax_contrib(mid_graph, bf16_mode, cast):
    """``csr_spmm_split_plain`` under the bf16 mode's schedule at d 64 (its
    lane group, and over bf16 rows its halved threshold, on 1,280 resident
    threads so that T splits the graph's rows: 128 over float32 rows, 64 over
    bf16 rows) against the JAX package's bf16 ``_contrib`` summed by its
    kernel in interpret mode: the same bf16 contributions in another order
    of float32 sums, within 1e-5 of the largest output."""
    pg, tg, _ = mid_graph
    d = 64
    lay = tg.fwd
    group = sk.lane_group(d, sk.mean_degree(lay))
    t = sk.split_threshold(lay.cols.shape[0], group, 1280, 2 if cast else 4)
    assert (group, t) == (8, 64 if cast else 128)
    plan = sk.split_plan(lay.indptr, t)
    assert plan.split_rows.numel() > 1
    x = np.random.default_rng(70).standard_normal((tg.n_cols, d)).astype(np.float32)
    for name, w, jw in _modes(tg, 71):
        want = _jax(pg, x, jw)
        got = sk.csr_spmm_split_plain(lay, plan, torch.from_numpy(x), w, group).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
        ev = sk._edge_values(lay, w).double()       # the unrounded sum: the mode rounds
        exact = torch.zeros(lay.n_rows, d, dtype=torch.float64).index_add_(
            0, lay.rows.long(), ev[:, None] * torch.from_numpy(x).double()[lay.cols.long()])
        assert np.abs(got - exact.numpy()).max() > 1e-4 * np.abs(want).max()
