"""Layouts built on the tensors' own device (``csr_graph_from_edges``,
``device_split_plan``, ``segment_layout_from_ids``) against the host
functions they stand in for (``csr_layout``, ``build_csr_graph``,
``split_plan``, ``build_segment_layout``): every field equal, dtypes
included, on unsorted ids with duplicates, self loops and empty rows, at
several split thresholds and combine-tree fan-ins.  B1's plain version on a
device-built graph equals the dense product within 1e-6 of the largest
entry (float32 sums of up to 280 terms in another order; gradients against
float64); a card test holds the kernel on them to 1e-5 of the plain version.
"""

import numpy as np
import pytest
import torch

from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import spmm_kernel as sk
from sslrec_tpu_torch.ops.sparse import CooGraph
from sslrec_tpu_torch.ops.spmm import spmm, spmm_dense_ref

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores


def _equal(a, b, what):
    """Every field of two NamedTuples equal (tensors: values and dtype)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "plans":
            continue
        if hasattr(x, "_fields"):
            _equal(x, y, f"{what}.{f}")
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}.{f}"
        else:
            assert x == y, f"{what}.{f}: {x} != {y}"


def _edges(seed, n_rows=40, n_cols=30, nnz=400):
    """Unsorted edges with duplicates, self loops and rows 5..9 empty."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    rows[(rows >= 5) & (rows < 10)] = 0
    cols = rng.integers(0, n_cols, nnz)
    rows[:20], cols[:20] = 3, 3                       # a duplicated self loop
    rows[20:300] = 11                                 # one long row
    return rows, cols, n_rows, n_cols


def _host_graph(rows, cols, n_rows, n_cols):
    """The host build of the same edges: each layout sorted stably by its
    destination, its edge ids that permutation."""
    ones = np.ones(rows.size, np.float32)
    o, p = np.argsort(rows, kind="stable"), np.argsort(cols, kind="stable")
    return (sk.csr_layout(rows[o], cols[o], ones, o, n_rows, n_cols, "cpu"),
            sk.csr_layout(cols[p], rows[p], ones, p, n_cols, n_rows, "cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_graph_from_edges_equals_host_build(seed):
    rows, cols, n_rows, n_cols = _edges(seed)
    g = sk.csr_graph_from_edges(torch.from_numpy(rows), torch.from_numpy(cols), n_rows, n_cols)
    fwd, bwd = _host_graph(rows, cols, n_rows, n_cols)
    _equal(g.fwd, fwd, "fwd")
    _equal(g.bwd, bwd, "bwd")
    assert torch.equal(g.rows, torch.from_numpy(rows.astype(np.int32)))
    assert torch.equal(g.cols, torch.from_numpy(cols.astype(np.int32)))
    for lay in (g.fwd, g.bwd):
        for t in (1, 2, 3, 32, 64, 1024):
            _equal(sk.device_split_plan(lay.indptr, t), sk.split_plan(lay.indptr, t),
                   f"plan t={t}")


@pytest.mark.parametrize("fan_in", [2, 3, sk.FAN_IN])
def test_device_split_plan_tree_equals_host(fan_in):
    """The combine tree's fields (``n_first``, ``node_ptr``, ``node_dst``,
    ``slot_node``, ``arrivals``) of the device build equal the host build's,
    on rows from 0 to 3,000 entries, so that trees of several levels meet
    rows of one node and rows with no split."""
    rng = np.random.default_rng(fan_in)
    deg = np.concatenate([[3000, 0, 1], rng.integers(0, 70, 40), [257, 0]])
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    depths = set()
    for t in (1, 3, 32, 64):
        got, want = sk.device_split_plan(indptr, t, fan_in), sk.split_plan(indptr, t, fan_in)
        _equal(got, want, f"plan t={t} fan_in={fan_in}")
        assert got.n_partials == got.node_ptr[-1] and got.fan_in == fan_in
        depths.add(int(np.ceil(np.log(-(-3000 // t)) / np.log(fan_in) - 1e-9)))
    assert max(depths) >= 3


def test_csr_graph_from_sorted_edges_equals_build_csr_graph():
    rows, cols, n_rows, n_cols = _edges(3)
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    coo = CooGraph(rows=torch.from_numpy(rows.astype(np.int32)),
                   cols=torch.from_numpy(cols.astype(np.int32)),
                   vals=torch.ones(rows.size), n_rows=n_rows, n_cols=n_cols)
    want = sk.build_csr_graph(coo)
    got = sk.csr_graph_from_edges(torch.from_numpy(rows), torch.from_numpy(cols),
                                  n_rows, n_cols)
    assert got.fwd.ids_identity and not got.bwd.ids_identity
    _equal(got.fwd, want.fwd, "fwd")
    _equal(got.bwd, want.bwd, "bwd")


def test_csr_graph_from_edges_rejects_out_of_range_ids():
    rows = torch.tensor([0, 1, 4])
    with pytest.raises(ValueError, match="out of range"):
        sk.csr_graph_from_edges(rows, torch.tensor([0, 1, 2]), 4, 3)
    empty = sk.csr_graph_from_edges(rows[:0], rows[:0], 4, 3)
    assert empty.fwd.indptr.tolist() == [0] * 5 and empty.fwd.ids_identity


@pytest.mark.parametrize("n,segments", [(1000, 50), (0, 10), (3000, 4000), (500, 1),
                                        (6000, 60)])
def test_segment_layout_from_ids_equals_host_build(n, segments):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, segments, n)
    if n >= 6000:
        ids[:2000] = 7            # a segment long enough for B2's whole-warp bin
    got = skn.segment_layout_from_ids(torch.from_numpy(ids), segments)
    want = skn.build_segment_layout(ids, segments)
    _equal(got, want, "segment layout")
    if n >= 6000:
        assert got.long_segments.numel() > 0
    for t in (1, 4, 32):
        _equal(sk.device_split_plan(got.csr.indptr, t), sk.split_plan(want.csr.indptr, t),
               f"plan t={t}")
    with pytest.raises(ValueError, match="must lie in"):
        skn.segment_layout_from_ids(torch.tensor([0, segments]), segments)


def test_b1_on_device_built_graph_matches_dense():
    """Value, dx and the edge weight's gradient of a hop over a device-built
    graph, and the gather's backward over a device-built segment layout."""
    rows, cols, n_rows, n_cols = _edges(4)
    g = sk.csr_graph_from_edges(torch.from_numpy(rows), torch.from_numpy(cols), n_rows, n_cols)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n_cols, 8, generator=gen, requires_grad=True)
    ew = torch.rand(g.nnz, generator=gen, requires_grad=True)
    w_out = torch.randn(n_rows, 8, generator=gen)
    (spmm(g, x, ew) * w_out).sum().backward()
    dense = torch.zeros(n_rows, n_cols, dtype=torch.float64)
    ew64 = ew.detach().double().requires_grad_()
    x64 = x.detach().double().requires_grad_()
    dense = dense.index_put((g.rows.long(), g.cols.long()), ew64, accumulate=True)
    (dense @ x64 * w_out.double()).sum().backward()
    torch.testing.assert_close(x.grad, x64.grad.float(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ew.grad, ew64.grad.float(), rtol=1e-6, atol=1e-6)
    ref = spmm_dense_ref(g, x.detach())
    torch.testing.assert_close(spmm(g, x.detach()), ref, rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))
    lay = skn.segment_layout_from_ids(torch.from_numpy(rows), n_rows)
    table = torch.randn(n_rows, 8, generator=gen, requires_grad=True)
    w_e = torch.randn(rows.size, 8, generator=gen)
    (skn.TakeFn.apply(lay, table) * w_e).sum().backward()
    want = torch.zeros(n_rows, 8).index_add_(0, torch.from_numpy(rows), w_e)
    torch.testing.assert_close(table.grad, want, rtol=1e-6, atol=1e-6)


def test_device_built_layouts_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 has no CPU mode")
    rows, cols, n_rows, n_cols = _edges(5)
    r, c = torch.from_numpy(rows).cuda(), torch.from_numpy(cols).cuda()
    g = sk.csr_graph_from_edges(r, c, n_rows, n_cols)
    fwd, bwd = _host_graph(rows, cols, n_rows, n_cols)
    for got, want in ((g.fwd, fwd), (g.bwd, bwd)):
        _equal(sk.CsrLayout(*(v.cpu() if torch.is_tensor(v) else v for v in got)), want,
               "layout")
        for t in (1, 32):
            plan = sk.device_split_plan(got.indptr, t)
            _equal(plan._replace(**{f: getattr(plan, f).cpu() for f in plan._fields
                                    if torch.is_tensor(getattr(plan, f))}),
                   sk.split_plan(want.indptr, t), "plan")
    x = torch.randn(n_cols, 32, device="cuda")
    ew = torch.rand(g.nnz, device="cuda")
    for lay in (g.fwd, g.bwd):
        xin = x if lay is g.fwd else torch.randn(n_rows, 32, device="cuda")
        got, ref = sk.csr_spmm(lay, xin, ew), sk.csr_spmm_plain(lay, xin, ew)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
