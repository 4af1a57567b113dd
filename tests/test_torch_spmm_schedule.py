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
