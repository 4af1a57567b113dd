"""B1's bf16 mode (``SSLREC_PALLAS_PRECISION=default``) against the JAX
package, and the float32 default kept bit for bit.

In the mode the JAX package's hops gather ``bf16(x)`` and multiply it by
``bf16(vals·w)`` in bf16 (``pallas_spmm._contrib`` / ``_contrib_pv``), and
the Pallas kernel sums the bf16 contributions in float32; its interpret mode
on the CPU shows exactly that, so the port's plain version is held to it
within rtol 1e-5 (the same terms summed in another order), value and dx.
Its segment sums build the contribution in float32 and only the TPU's
one-pass matmul rounds it to bf16, which interpret mode does not show: the
port states that rounding explicitly (every B1 contribution rounded to bf16
before the float32 sum), tested here against that sum written out, and
against JAX's unrounded sum within the one rounding's bound, 2^-8 of the
summed magnitudes.  Every result of the mode is within the rounding bound
of the float32 one.  Both caches of the variable are cleared around
each test, which changes no file of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sslrec_tpu.ops import pallas_spmm as jps
from sslrec_tpu.ops import sparse as jsparse
from sslrec_tpu.ops import spmm as jspmm
from sslrec_tpu.ops.pallas_segment import build_blocked_segments, segment_sum_blocked
from sslrec_tpu_torch.ops import segment_kernel as skn
from sslrec_tpu_torch.ops import sparse as tsparse
from sslrec_tpu_torch.ops import spmm as tspmm
from sslrec_tpu_torch.ops import spmm_kernel as sk

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

RTOL, ATOL = 1e-5, 1e-6


def _clear():
    jps._mxu_precision.cache_clear()
    sk.bf16_mode.cache_clear()


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setenv("SSLREC_PALLAS_PRECISION", "default")
    _clear()
    assert sk.bf16_mode()
    yield
    monkeypatch.delenv("SSLREC_PALLAS_PRECISION")
    _clear()


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.delenv("SSLREC_PALLAS_PRECISION", raising=False)
    _clear()
    yield
    _clear()


def _graphs(tiny_ui):
    mat = jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape)
    jg = jsparse.from_scipy(mat)
    return jg, jps.build_pallas_graph(jg, r=16, m=32), sk.build_csr_graph(
        tsparse.from_scipy(mat))


def _x(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "edge_weight"])
def test_bf16_hop_and_dx_match_jax(tiny_ui, bf16, weighted):
    jg, pg, tg = _graphs(tiny_ui)
    x = _x(jg.n_cols, 8, 0)
    ew = np.random.default_rng(1).uniform(size=jg.nnz).astype(np.float32) if weighted else None
    w_out = _x(jg.n_rows, 8, 2)

    def f_jax(x):
        y = jps.pallas_spmm(pg, x, None if ew is None else jnp.asarray(ew), True)
        return jnp.sum(y * w_out), y

    (_, jy), jdx = jax.value_and_grad(f_jax, has_aux=True)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    ty = tspmm.spmm(tg, tx, None if ew is None else _t(ew))
    (ty * _t(w_out)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)
    # the mode is in force: the result differs from the float32 product
    exact = jspmm.spmm(jg, jnp.asarray(x), None if ew is None else jnp.asarray(ew))
    assert np.abs(np.asarray(jy) - np.asarray(exact)).max() > 0


def test_bf16_masked_hop_matches_jax(tiny_ui, bf16):
    jg, pg, tg = _graphs(tiny_ui)
    jkey = jnp.asarray([11, 2**32 - 5], jnp.uint32)
    tkey = torch.tensor([11, 2**32 - 5], dtype=torch.int64)
    pw = jps.dropout_padded(jkey, pg, keep_rate=0.6, resize_val=True)
    x = _x(jg.n_cols, 16, 4)
    w_out = _x(jg.n_rows, 16, 5)

    def f_jax(x):
        y = jps.pallas_spmm_pv(pg, x, pw.fwd, pw.bwd, True)
        return jnp.sum(y * w_out), y

    (_, jy), jdx = jax.value_and_grad(f_jax, has_aux=True)(jnp.asarray(x))
    for mask in (sk.dropout_mask(tkey, tg, 0.6, resize_val=True),
                 sk.prf_mask(tkey, tg, 0.6, resize_val=True)):
        tx = _t(x).requires_grad_()
        ty = tspmm.spmm(tg, tx, mask)
        (ty * _t(w_out)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)


def test_bf16_within_rounding_bound_of_f32(tiny_ui, monkeypatch):
    """Each contribution carries at most three bf16 roundings (x, the value,
    the product), each within 2^-8 relative (bf16 keeps 8 significant
    bits), so every output is within (3·2^-8 + 2^-15)·Σ|contribution| of
    the float32 sum."""
    _, _, tg = _graphs(tiny_ui)
    x = _t(_x(tg.n_cols, 32, 6))
    ew = torch.rand(tg.nnz, generator=torch.Generator().manual_seed(0))
    lays = (tg.fwd, tg.bwd)
    monkeypatch.delenv("SSLREC_PALLAS_PRECISION", raising=False)
    _clear()
    exact = [sk.csr_spmm(lay, x[: lay.n_cols], ew) for lay in lays]
    magnitude = [sk.csr_spmm(lay, x[: lay.n_cols].abs(), ew) for lay in lays]
    monkeypatch.setenv("SSLREC_PALLAS_PRECISION", "default")
    _clear()
    try:
        rounded = [sk.csr_spmm(lay, x[: lay.n_cols], ew) for lay in lays]
    finally:
        monkeypatch.delenv("SSLREC_PALLAS_PRECISION")
        _clear()
    for got, ref, mag in zip(rounded, exact, magnitude):
        err = (got - ref).abs()
        assert float(err.max()) > 0
        assert bool((err <= (3 * 2.0**-8 + 2.0**-15) * mag + 1e-7).all())


def test_f32_default_unchanged_bit_for_bit(tiny_ui, f32):
    _, _, tg = _graphs(tiny_ui)
    assert not sk.bf16_mode()
    x = _t(_x(tg.n_cols, 8, 7))
    ew = torch.rand(tg.nnz, generator=torch.Generator().manual_seed(1))
    for lay in (tg.fwd, tg.bwd):
        for w in (None, ew):
            ev = lay.vals if w is None else lay.vals * w[lay.edge_ids]
            want = torch.zeros(lay.n_rows, 8).index_add_(0, lay.rows, ev[:, None] * x[lay.cols])
            assert torch.equal(sk.csr_spmm_plain(lay, x, w), want)
            assert torch.equal(sk.csr_spmm(lay, x, w), want)


def test_segment_sum_rounding_is_stated(bf16):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 40, 600)
    data = rng.standard_normal((600, 8)).astype(np.float32)
    lay = skn.build_segment_layout(ids, 40)
    got = skn.SegmentSumFn.apply(lay, _t(data))
    # the stated rounding: each contribution bf16(data), summed in float32
    rounded = _t(data).to(torch.bfloat16).float()
    want = torch.zeros(40, 8).index_add_(0, lay.csr.rows, rounded[lay.csr.cols])
    assert torch.equal(got, want)
    # JAX's interpret mode sums the unrounded float32 contributions
    bs = build_blocked_segments(ids, 40, r=16, m=32)
    jref = np.asarray(segment_sum_blocked(bs, jnp.asarray(data), True))
    unrounded = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=40)
    np.testing.assert_allclose(jref, np.asarray(unrounded), rtol=RTOL, atol=ATOL)
    mag = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(data)), jnp.asarray(ids),
                                         num_segments=40))
    err = np.abs(got.numpy() - jref)
    assert err.max() > 0 and (err <= 2.0**-8 * mag + 1e-6).all()


def test_bf16_kernel_matches_plain_on_cuda(tiny_ui, bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CSR SpMM kernel has no CPU mode")
    mat = jsparse.make_bi_adj(tiny_ui, *tiny_ui.shape)
    g = sk.build_csr_graph(tsparse.from_scipy(mat), "cuda")
    key = torch.tensor([5, 6], device="cuda")
    prf = sk.prf_mask(key, g, 0.5)
    ew = torch.rand(g.nnz, device="cuda")
    for lay in (g.fwd, g.bwd):
        for d in (1, 8, 17, 32, 64):
            x = torch.randn(lay.n_cols, d, device="cuda")
            for w in (None, ew, prf):
                got = sk.csr_spmm(lay, x, w)
                ref = sk.csr_spmm_plain(lay, x, w)
                assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
                assert torch.equal(got, sk.csr_spmm(lay, x, w))


def test_jax_mode_reads_over_3_8e3_at_the_lightgcn_hop(bf16):
    """The JAX mode's 3.76e-3 against XLA (``BENCH_r05.json``) is one
    input's reading, not a bound: its own contribution formula
    (``_contrib``: ``bf16(x)[cols] · bf16(v)`` in bf16, summed in float32)
    reads 4.45e-3 of the largest output at the LightGCN hop on seed-0
    normals, within the rounding bound; the port's mode equals it."""
    from sslrec_tpu_torch.config import load_config
    from sslrec_tpu_torch.data import general_cf
    cfg = load_config("lightgcn", overrides={"data.dir": "datasets",
                                             "data.name": "alibaba-fashion"})
    g = general_cf.load(cfg, "cpu").extras["bi_adj"]
    rows, cols, vals = (jnp.asarray(t.numpy()) for t in (g.rows, g.cols, g.vals))
    x = _x(g.n_cols, 32, 0)
    xj = jnp.asarray(x)
    contrib = xj.astype(jnp.bfloat16)[cols] * vals.astype(jnp.bfloat16)[:, None]
    y16 = np.asarray(jax.ops.segment_sum(contrib.astype(jnp.float32), rows, g.n_rows))
    y32 = np.asarray(jax.ops.segment_sum(xj[cols] * vals[:, None], rows, g.n_rows))
    mag = np.asarray(jax.ops.segment_sum(jnp.abs(xj)[cols] * vals[:, None], rows, g.n_rows))
    err = np.abs(y16 - y32)
    assert err.max() / np.abs(y32).max() > 3.8e-3
    assert (err <= (3 * 2.0**-8 + 2.0**-15) * mag + 1e-7 * mag.max()).all()
    got = sk.csr_spmm(g.fwd, _t(x)).numpy()
    np.testing.assert_allclose(got, y16, rtol=RTOL, atol=ATOL)


def _bf16_bits(rng, n):
    """``n`` bf16 values as float32, every sign, exponent (subnormals, zeros,
    inf and NaN included) and mantissa drawn uniformly from the 16 bits."""
    bits = rng.integers(0, 1 << 16, n, dtype=np.uint32) << 16
    return bits.view(np.float32)


def _round_exact(p: np.ndarray) -> np.ndarray:
    """The float64 values ``p`` rounded once to bf16, half to even, computed
    apart from both frameworks: the quantum of ``p``'s binade (2^-133 below
    bf16's normal range), ``np.round`` (half to even) on the quotient, inf
    past the largest bf16 value; inf and NaN kept, zeros keep their sign."""
    out = p.copy()
    fin = np.isfinite(p) & (p != 0)
    _, e = np.frexp(p[fin])
    q = np.exp2(np.maximum(e, -125) - 8.0)
    r = np.round(p[fin] / q) * q
    r[np.abs(r) >= 2.0**128] = np.inf * np.sign(r[np.abs(r) >= 2.0**128])
    out[fin] = r
    return out


def test_native_bf16_multiply_is_the_modes_rounding():
    """The identity a packed bf16 multiply (``mul.rn.bf16x2`` in B1's bf16
    kernel) rests on: the correctly rounded bf16 product of two bf16 values,
    which torch's native bf16 multiply gives, is ``_round_bf16`` of their
    float32 product, the plain version's contribution, bit for bit: for
    every sign, exponent and mantissa (random bit patterns), exact halfway
    products, subnormal products and ones that round to ±0, products that
    overflow to inf, and signed zeros.  Both equal the exact product
    rounded once (``_round_exact``, float64)."""
    rng = np.random.default_rng(2026)
    a, b = _bf16_bits(rng, 400_000), _bf16_bits(rng, 400_000)
    # exact halfway products: 1.5 * (1 + 2^-7) = 1 + 65 * 2^-7 + 2^-8, at
    # every binade, down into bf16's subnormals and up to its overflow
    e = rng.integers(-130, 128, 20_000)
    half_a = (np.float32(1.5) * np.exp2(e.clip(-126, 127))).astype(np.float32)
    half_b = (np.float32(1 + 2.0**-7) * np.exp2((e - e.clip(-126, 127))
                                               .astype(np.float32))).astype(np.float32)
    tiny = np.exp2(rng.integers(-75, -55, (2, 20_000)).astype(np.float32))
    tiny *= rng.choice(np.float32([-1.5, -1.0, 1.0078125, 1.9921875]), (2, 20_000))
    zeros = np.float32([0.0, -0.0, 0.0, -0.0, 1.0, -np.inf, 2.0**-133, np.nan])
    a = np.concatenate([a, half_a, tiny[0], zeros]).astype(np.float32)
    b = np.concatenate([b, half_b, tiny[1], zeros[::-1]]).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.allclose(ta.to(torch.bfloat16).float(), ta, rtol=0, atol=0,
                          equal_nan=True)                       # already bf16 values
    native = (ta.to(torch.bfloat16) * tb.to(torch.bfloat16)).float()
    plain = sk._round_bf16(sk._round_bf16(ta) * sk._round_bf16(tb))
    with np.errstate(invalid="ignore", over="ignore"):     # inf * 0, as IEEE has it
        exact = torch.from_numpy(_round_exact(a.astype(np.float64) * b.astype(np.float64)))
    exact = exact.float()
    for got in (native, plain):
        nan = torch.isnan(exact)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32), exact[~nan].view(torch.int32))
    prod = ta.double() * tb.double()
    fin = torch.isfinite(prod) & (prod != 0)
    assert int((fin & (prod.abs() < 2.0**-126) & (exact != 0)).sum()) > 1000   # subnormal
    assert int((fin & (exact == 0)).sum()) > 1000                               # to ±0
    assert int((fin & torch.isinf(exact)).sum()) > 100                          # overflow
    under = fin & (exact == 0)
    assert bool((torch.signbit(exact[under]) == torch.signbit(prod[under])).all())
    ties = fin & ((prod.float().view(torch.int32) & 0xFFFF) == 0x8000) & (prod.abs() > 2.0**-126)
    assert int(ties.sum()) > 10_000
