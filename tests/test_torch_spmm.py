"""The port's CSR SpMM (``sslrec_tpu_torch/ops/spmm_kernel.py``, ``ops/spmm.py``)
against the JAX package: layouts, values, gradients, the masked path, the
transposed direction, the dropout PRF (materialised, and as the in-kernel
``PrfMask``), and the kernel's split plan with its plain emulation.

On the CPU the kernel's wrapper takes its plain version, so these tests hold
the plain path (and the autograd structure around the kernel) to JAX; the
kernel itself is held to the plain path on the card, by the last test here
and by ``chip_smoke.py``.  Pallas runs in interpret mode with r=16, m=32, as
``tests/test_pallas_spmm.py`` runs it.

Tolerances: rtol 1e-5, atol 1e-6 for float sums taken in another order
(index_add_ against segment_sum / one-hot matmuls); exact for layouts, plans
and the PRF, which are integer computations.  The split emulation is held to
1e-6 on inputs whose sums are exact in float32 (small integers, values in
{0.5, 1, 2}), so a lost or repeated edge shows however long the row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.ops import sparse as jsparse
from sslrec_tpu.ops import spmm as jspmm
from sslrec_tpu.ops.pallas_spmm import (_prf_uniform as j_prf_uniform,
                                        _threefry2x32 as j_threefry,
                                        build_pallas_graph, dropout_padded,
                                        pallas_spmm, pallas_spmm_pv)
from sslrec_tpu_torch.ops import sparse as tsparse
from sslrec_tpu_torch.ops import spmm as tspmm
from sslrec_tpu_torch.ops import spmm_kernel as sk

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6


def _graphs(tiny_ui, bi=True):
    mat = jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape) if bi else tiny_ui
    return jsparse.from_scipy(mat), sk.build_csr_graph(tsparse.from_scipy(mat))


def _x(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _key(k0, k1):
    return jnp.asarray([k0, k1], jnp.uint32), torch.tensor([k0, k1], dtype=torch.int64)


SPLIT_T = 32
# resident threads (SMs x threads per SM) of an H100 SXM and an H100 PCIe
H100_SXM_THREADS, H100_PCIE_THREADS = 132 * 2048, 114 * 2048


def _split_graph(t=SPLIT_T, seed=0, n_cols=300, ones=False):
    """A 5,000-edge row, rows of t-1, t, t+1, 2t and 2t+1 edges, short rows
    and empty rows (first, inner and last), with edge values in {0.5, 1, 2},
    or all 1 (``ones``)."""
    rng = np.random.default_rng(seed)
    deg = np.array([0, 5000, t - 1, t, t + 1, 0, 0, 1, 3, 2 * t, 2 * t + 1, 2, 0])
    rows = np.repeat(np.arange(deg.size), deg)
    cols = rng.integers(0, n_cols, rows.size)
    order = np.lexsort((cols, rows))
    vals = rng.choice(np.float32([0.5, 1.0, 2.0]), rows.size)
    if ones:
        vals = np.ones_like(vals)
    g = sk.build_csr_graph(tsparse.CooGraph(
        rows=torch.from_numpy(rows[order].astype(np.int32)),
        cols=torch.from_numpy(cols[order].astype(np.int32)),
        vals=torch.from_numpy(vals), n_rows=deg.size, n_cols=n_cols))
    return g, deg


@pytest.mark.parametrize("bi", [True, False], ids=["bi_adj", "rectangular"])
def test_layouts_cover_every_edge_once(tiny_ui, bi):
    jg, tg = _graphs(tiny_ui, bi)
    rows, cols, vals = (np.asarray(a) for a in (jg.rows, jg.cols, jg.vals))
    np.testing.assert_array_equal(tg.rows.numpy(), rows)
    np.testing.assert_array_equal(tg.cols.numpy(), cols)
    np.testing.assert_array_equal(tg.vals.numpy(), vals)
    for lay, dst, src, n_rows in ((tg.fwd, rows, cols, jg.n_rows),
                                  (tg.bwd, cols, rows, jg.n_cols)):
        eids = lay.edge_ids.numpy()
        np.testing.assert_array_equal(np.sort(eids), np.arange(jg.nnz))
        indptr = lay.indptr.numpy()
        assert indptr.shape == (n_rows + 1,) and indptr[-1] == jg.nnz
        slot_rows = np.repeat(np.arange(n_rows), np.diff(indptr))
        np.testing.assert_array_equal(lay.rows.numpy(), slot_rows)
        np.testing.assert_array_equal(slot_rows, dst[eids])
        np.testing.assert_array_equal(lay.cols.numpy(), src[eids])
        np.testing.assert_array_equal(lay.vals.numpy(), vals[eids])
    np.testing.assert_array_equal(tg.fwd.edge_ids.numpy(), np.arange(jg.nnz))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "edge_weight"])
def test_spmm_matches_jax(tiny_ui, weighted):
    jg, tg = _graphs(tiny_ui)
    x = _x(jg.n_cols, 8, 0)
    ew = (np.random.default_rng(1).uniform(size=jg.nnz).astype(np.float32)
          if weighted else None)
    got = tspmm.spmm(tg, _t(x), None if ew is None else _t(ew)).numpy()
    jew = None if ew is None else jnp.asarray(ew)
    ref_xla = jspmm.spmm(jg, jnp.asarray(x), edge_weight=jew)
    ref_pallas = pallas_spmm(build_pallas_graph(jg, r=16, m=32), jnp.asarray(x), jew, True)
    np.testing.assert_allclose(got, np.asarray(ref_xla), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(ref_pallas), rtol=RTOL, atol=ATOL)
    if not weighted:
        ref = tspmm.spmm_dense_ref(tg, _t(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_spmm_grads_match_jax(tiny_ui):
    jg, tg = _graphs(tiny_ui)
    x = _x(jg.n_cols, 8, 2)
    ew = np.random.default_rng(3).uniform(size=jg.nnz).astype(np.float32)

    def f_jax(x, ew):
        return jnp.sum(jnp.sin(jspmm.spmm(jg, x, edge_weight=ew)))

    jdx, jdew = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(ew))
    tx, tew = _t(x).requires_grad_(), _t(ew).requires_grad_()
    torch.sin(tspmm.spmm(tg, tx, tew)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tew.grad.numpy(), np.asarray(jdew), rtol=RTOL, atol=ATOL)


def test_spmm_pv_matches_jax(tiny_ui):
    jg, tg = _graphs(tiny_ui)
    pg = build_pallas_graph(jg, r=16, m=32)
    jkey, tkey = _key(11, 2**32 - 5)
    pw = dropout_padded(jkey, pg, keep_rate=0.6, resize_val=True)
    mask = sk.dropout_mask(tkey, tg, 0.6, resize_val=True)
    x = _x(jg.n_cols, 8, 4)

    def f_jax(x):
        return jnp.sum(jnp.sin(pallas_spmm_pv(pg, x, pw.fwd, pw.bwd, True)))

    jval, jdx = jax.value_and_grad(f_jax)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    val = torch.sin(tspmm.spmm(tg, tx, mask)).sum()
    val.backward()
    np.testing.assert_allclose(val.detach().item(), float(jval), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "edge_weight"])
def test_spmm_t_rectangular(tiny_ui, weighted):
    jg, tg = _graphs(tiny_ui, bi=False)
    assert jg.n_rows != jg.n_cols
    x = _x(jg.n_rows, 4, 5)
    ew = (np.random.default_rng(6).uniform(size=jg.nnz).astype(np.float32)
          if weighted else None)
    got = tspmm.spmm_t(tg, _t(x), None if ew is None else _t(ew)).numpy()
    ref = jspmm.spmm_t(jg, jnp.asarray(x), None if ew is None else jnp.asarray(ew))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    if not weighted:
        np.testing.assert_allclose(got, tiny_ui.toarray().T @ x, rtol=RTOL, atol=ATOL)


def test_spmm_layers_per_layer_mask_matches_jax(tiny_ui):
    jg, tg = _graphs(tiny_ui)
    x = _x(jg.n_cols, 8, 7)
    ew = (np.random.default_rng(8).uniform(size=(3, jg.nnz)) < 0.5).astype(np.float32)
    ref = jspmm.spmm_layers(jg, jnp.asarray(x), 3, jnp.asarray(ew))
    got = tspmm.spmm_layers(tg, _t(x), 3, sk.EdgeMask(_t(ew)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    got_w = tspmm.spmm_layers(tg, _t(x), 3, _t(ew))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_sddmm_matches_jax(tiny_ui):
    jg, tg = _graphs(tiny_ui)
    a, b = _x(jg.n_rows, 8, 10), _x(jg.n_cols, 8, 11)
    np.testing.assert_allclose(tspmm.sddmm(tg, _t(a), _t(b)).numpy(),
                               np.asarray(jspmm.sddmm(jg, jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k0,k1", [(0, 0), (0, 42), (2023, 7), (2**31, 2**32 - 1),
                                   (0xDEADBEEF, 0x12345678)])
def test_prf_bit_exact(k0, k1):
    counts = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1], np.uint64),
        np.random.default_rng(k1 % 97).integers(0, 2**32, 500, dtype=np.uint64)])
    jkey, tkey = _key(k0, k1)
    jc = jnp.asarray(counts.astype(np.uint32))
    tc = torch.from_numpy(counts.astype(np.int64))
    for salt in range(4):
        jb0, jb1 = j_threefry(jkey[0], jkey[1], jc, jnp.full_like(jc, salt))
        tb0, tb1 = sk._threefry2x32(tkey[0], tkey[1], tc, torch.full_like(tc, salt))
        np.testing.assert_array_equal(tb0.numpy(), np.asarray(jb0).astype(np.int64))
        np.testing.assert_array_equal(tb1.numpy(), np.asarray(jb1).astype(np.int64))
        ju = np.asarray(j_prf_uniform(jkey, jc, salt))
        tu = sk._prf_uniform(tkey, tc, salt).numpy()
        assert tu.dtype == np.float32
        np.testing.assert_array_equal(tu, ju)


def test_dropout_mask_same_in_both_layouts(tiny_ui):
    jg, tg = _graphs(tiny_ui)
    pg = build_pallas_graph(jg, r=16, m=32)
    jkey, tkey = _key(3, 9)
    pw = dropout_padded(jkey, pg, keep_rate=0.5)
    mask = sk.dropout_mask(tkey, tg, 0.5).w.numpy()
    ref = np.asarray(jnp.floor(
        j_prf_uniform(jkey, jnp.arange(jg.nnz, dtype=jnp.uint32), 0) + 0.5))
    np.testing.assert_array_equal(mask, ref)
    for bg, jw, lay in ((pg.fwd, pw.fwd, tg.fwd), (pg.bwd, pw.bwd, tg.bwd)):
        live = np.asarray(bg.vals) != 0
        eids = np.asarray(bg.edge_ids)[live]
        # the JAX layout's slot for edge e holds the port's mask[e]
        np.testing.assert_array_equal(np.asarray(jw)[live], mask[eids])
        # and the port's layout reads the same bit through its edge ids
        np.testing.assert_array_equal(mask[lay.edge_ids.numpy()],
                                      ref[lay.edge_ids.numpy()])
    stacked = sk.dropout_mask(tkey, tg, 0.5, salts=[0, 1, 2]).w
    assert stacked.shape == (3, jg.nnz)
    np.testing.assert_array_equal(stacked[0].numpy(), mask)


def test_cpu_tensor_does_not_launch(tiny_ui):
    _, tg = _graphs(tiny_ui)
    before = sk.csr_spmm.launches
    x = _t(_x(tg.n_cols, 8, 9)).requires_grad_()
    ew = torch.rand(tg.nnz, requires_grad=True)
    tspmm.spmm(tg, x, ew).sum().backward()
    tspmm.spmm(tg, x.detach(), sk.dropout_mask(torch.tensor([1, 2]), tg, 0.5))
    sk.csr_spmm(tg.fwd, x.detach())
    assert sk.csr_spmm.launches == before


def test_kernel_matches_plain_on_cuda(tiny_ui):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CSR SpMM kernel has no CPU mode")
    mat = jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape)
    g_bi = sk.build_csr_graph(tsparse.from_scipy(mat), "cuda")
    on_card = []
    for ones in (False, True):      # the second reads no vals
        g_split, _ = _split_graph(ones=ones)
        on_card.append(sk.build_csr_graph(tsparse.CooGraph(
            rows=g_split.rows, cols=g_split.cols, vals=g_split.vals,
            n_rows=g_split.n_rows, n_cols=g_split.n_cols), "cuda"))
    assert on_card[1].fwd.vals_ones and not g_bi.fwd.vals_ones
    for g in (g_bi, *on_card):
        key = torch.tensor([5, 6], device="cuda")
        for keep_rate, resize in ((0.5, False), (0.6, True)):
            mask = sk.dropout_mask(key, g, keep_rate, resize_val=resize).w
            prf = sk.prf_mask(key, g, keep_rate, resize_val=resize)
            for lay in (g.fwd, g.bwd):
                for d in (1, 8, 17, 32, 33, 64, 65, 128):
                    x = torch.randn(lay.n_cols, d, device="cuda")
                    for ew in (None, mask, prf):
                        before = sk.csr_spmm.launches
                        got = sk.csr_spmm(lay, x, ew)
                        assert sk.csr_spmm.launches == before + 1
                        ref = sk.csr_spmm_plain(lay, x, ew)
                        torch.cuda.synchronize()
                        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
                        assert torch.equal(got, sk.csr_spmm(lay, x, ew))   # deterministic
                    assert torch.equal(sk.csr_spmm(lay, x, prf), sk.csr_spmm(lay, x, mask))


@pytest.mark.parametrize("t", [SPLIT_T, 7, 1])
def test_split_plan_covers_every_edge_once_in_order(t):
    g, deg = _split_graph()
    plan = sk.split_plan(g.fwd.indptr, t)
    indptr = g.fwd.indptr.numpy()
    ptr, row, dst = (a.numpy() for a in (plan.chunk_ptr, plan.chunk_row, plan.chunk_dst))
    sizes = np.diff(ptr)
    # chunks tile [0, nnz) in order, none empty, none longer than t
    assert ptr[0] == 0 and ptr[-1] == g.nnz and (sizes >= 1).all() and (sizes <= t).all()
    # each chunk lies in its row, and a row's chunks are consecutive and cover it
    assert (ptr[:-1] >= indptr[row]).all() and (ptr[1:] <= indptr[row + 1]).all()
    np.testing.assert_array_equal(np.bincount(row, minlength=deg.size), -(-deg // t))
    np.testing.assert_array_equal(plan.empty_rows.numpy(), np.flatnonzero(deg == 0))
    split = np.flatnonzero(deg > t)
    np.testing.assert_array_equal(plan.split_rows.numpy(), split)
    # a whole row's chunk writes its row; a split row's chunks take slots in order
    whole = dst >= 0
    np.testing.assert_array_equal(dst[whole], row[whole])
    assert np.array_equal(np.unique(row[whole]), np.flatnonzero((deg > 0) & (deg <= t)))
    np.testing.assert_array_equal(-1 - dst[~whole], np.arange(plan.n_slots))
    np.testing.assert_array_equal(row[~whole], np.repeat(split, -(-deg[split] // t)))
    assert plan.n_slots == int((-(-deg[split] // t)).sum())


def test_split_threshold_and_lane_group():
    for d, g in ((1, 4), (8, 4), (17, 16), (32, 4), (33, 32), (64, 8), (65, 32), (68, 16),
                 (128, 16), (256, 32)):
        assert sk.lane_group(d) == g
    # the narrow mode (d <= 4) by mean row length: AdaGCL's gate rows, KGCL's
    # degrees, DCRec_seq's and MAERec's item graphs
    for d, mean, g in ((1, 3.47, 4), (1, 12.6, 4), (4, 11.4, 4), (1, 17.3, 8), (3, 40.3, 16),
                       (2, 1e6, 16), (64, 40.3, 8)):
        assert sk.lane_group(d, mean) == g
    for resident in (H100_SXM_THREADS, H100_PCIE_THREADS):
        for nnz in (0, 10, 502_048, 297_404, 10**8):
            for group in (4, 8, 16, 32):
                t = sk.split_threshold(nnz, group, resident)
                assert 32 <= t <= 1024 and t & (t - 1) == 0
    # LightGCN's hop on alibaba-fashion (d 32) and KGCL's relation take (d 64)
    assert sk.split_threshold(502_048, sk.lane_group(32), H100_SXM_THREADS) == 32
    assert sk.split_threshold(297_404, sk.lane_group(64), H100_SXM_THREADS) == 32
    # fewer resident threads, longer chunks
    assert sk.split_threshold(10**6, 8, H100_PCIE_THREADS) > sk.split_threshold(
        10**6, 8, H100_SXM_THREADS)
    g, _ = _split_graph()
    assert sk.layout_plan(g.fwd, 16) is sk.layout_plan(g.fwd, 16)
    assert g.fwd.ids_identity and not g.bwd.ids_identity
    assert not g.fwd.vals_ones and not g.bwd.vals_ones
    ones, _ = _split_graph(ones=True)
    assert ones.fwd.vals_ones and ones.bwd.vals_ones


@pytest.mark.parametrize("d", [1, 8, 32, 33, 65])
def test_split_emulation_matches_plain(d):
    g, _ = _split_graph()
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.integers(-8, 9, (g.n_cols, d)).astype(np.float32))
    ew = torch.from_numpy(rng.choice(np.float32([0.0, 0.5, 1.0]), g.nnz))
    prf = sk.prf_mask(torch.tensor([3, 4]), g, 0.5)
    for t in (SPLIT_T, 7):
        for lay in (g.fwd, g.bwd):
            xl = x if lay is g.fwd else torch.from_numpy(
                rng.integers(-8, 9, (g.n_rows, d)).astype(np.float32))
            plan = sk.split_plan(lay.indptr, t)
            for w in (None, ew, prf):
                got = sk.csr_spmm_split_plain(lay, plan, xl, w)
                ref = sk.csr_spmm_plain(lay, xl, w)
                np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    # random floats: the same sum in another order
    xr = torch.from_numpy(_x(g.n_cols, d, 5))
    plan = sk.split_plan(g.fwd.indptr, SPLIT_T)
    got = sk.csr_spmm_split_plain(g.fwd, plan, xr)
    ref = sk.csr_spmm_plain(g.fwd, xr)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("keep_rate,resize_val", [(0.5, False), (0.6, True)])
def test_prf_mask_matches_materialised_and_jax(tiny_ui, keep_rate, resize_val):
    jg, tg = _graphs(tiny_ui)
    pg = build_pallas_graph(jg, r=16, m=32)
    jkey, tkey = _key(2**32 - 7, 99)
    prf = sk.prf_mask(tkey, tg, keep_rate, resize_val=resize_val)
    mask = sk.dropout_mask(tkey, tg, keep_rate, resize_val=resize_val)
    np.testing.assert_array_equal(prf.w.numpy(), mask.w.numpy())
    for lay in (tg.fwd, tg.bwd):
        np.testing.assert_array_equal(prf.at(lay.edge_ids).numpy(),
                                      mask.w[lay.edge_ids].numpy())
        x = torch.from_numpy(_x(lay.n_cols, 8, 12))
        np.testing.assert_array_equal(sk.csr_spmm_plain(lay, x, prf).numpy(),
                                      sk.csr_spmm_plain(lay, x, mask.w).numpy())
    pw = dropout_padded(jkey, pg, keep_rate=keep_rate, resize_val=resize_val)
    x = _x(jg.n_cols, 8, 13)

    def f_jax(x):
        return jnp.sum(jnp.sin(pallas_spmm_pv(pg, x, pw.fwd, pw.bwd, True)))

    jval, jdx = jax.value_and_grad(f_jax)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    val = torch.sin(tspmm.spmm(tg, tx, prf)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)


def test_prf_mask_per_layer_and_transposed(tiny_ui):
    jg, tg = _graphs(tiny_ui)
    tkey = torch.tensor([17, 23])
    prf = sk.prf_mask(tkey, tg, 0.5, salts=[0, 1, 2])
    mask = sk.dropout_mask(tkey, tg, 0.5, salts=[0, 1, 2])
    assert prf.ndim == 2 and prf.w.shape == (3, jg.nnz)
    np.testing.assert_array_equal(prf.w.numpy(), mask.w.numpy())
    np.testing.assert_array_equal(prf.layer(1).w.numpy(), mask.w[1].numpy())
    x = _t(_x(jg.n_cols, 8, 14))
    np.testing.assert_array_equal(tspmm.spmm_layers(tg, x, 3, prf).numpy(),
                                  tspmm.spmm_layers(tg, x, 3, mask).numpy())
    xt = _t(_x(jg.n_rows, 8, 15))
    one = sk.prf_mask(tkey, tg, 0.5)
    np.testing.assert_array_equal(tspmm.spmm_t(tg, xt, one).numpy(),
                                  tspmm.spmm_t(tg, xt, one.w).numpy())
    with pytest.raises(ValueError, match="indexed by layer"):
        sk._check(tg.fwd, x, prf)
