"""Port parity, exact part: ``dplasma_tpu_torch.kernels.dd`` against
``dplasma_tpu.kernels.dd`` on the same numpy inputs.

Every function here is integer work or exact f64 work (bit-pattern
splits, int8 products with int32 sums, recombines whose terms are
exact), so the two packages must agree BITWISE: compared as raw bits,
NaNs included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

M, K, N = 40, 48, 32


def _bits(x):
    x = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    if x.dtype.kind == "c":      # (re, im) pairs
        x = np.ascontiguousarray(x).view(f"f{x.dtype.itemsize // 2}")
    return x if x.dtype.kind in "iu" else x.view(f"i{x.dtype.itemsize}")


def assert_bitwise(want, got):
    want = np.stack([np.asarray(x) for x in want]) \
        if isinstance(want, (list, tuple)) else np.asarray(want)
    got = torch.stack(list(got)) if isinstance(got, (list, tuple)) else got
    assert want.shape == tuple(got.shape)
    assert want.dtype == got.numpy().dtype
    np.testing.assert_array_equal(_bits(want), _bits(got))


@pytest.fixture(scope="module")
def ops():
    rng = np.random.default_rng(7)
    # rows and columns over ~10 binades, so the scales differ
    a = rng.standard_normal((M, K)) * 2.0 ** rng.integers(-5, 6, (M, 1))
    b = rng.standard_normal((K, N)) * 2.0 ** rng.integers(-5, 6, (1, N))
    base = rng.standard_normal((M, N))
    return a, b, base


def test_plan_and_chunk_depth():
    for K_ in (1, 64, 16642, 16643, 2 ** 20):
        for bits in (53, 32, 24, 60):
            assert dd._plan(K_, bits) == ref_dd._plan(K_, bits)
    assert dd.KC == ref_dd.KC and dd.W8 == ref_dd.W8


def test_pow2_scale_bits_edges():
    rng = np.random.default_rng(1)
    m = np.concatenate([
        np.abs(rng.standard_normal(64)) * 10.0 ** rng.integers(-300, 300, 64),
        [0.0, 5e-324, 2.2e-308, 1e-310, 1.0, 0.75, 2.0 ** 1021,
         1.7976931348623157e308, np.inf, np.nan]])
    assert_bitwise(ref_dd._pow2_scale_bits(jnp.asarray(m)),
                   dd._pow2_scale_bits(torch.from_numpy(m)))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bits", [53, 32])
def test_split_int_digits_and_scales(ops, axis, bits):
    a, _, _ = ops
    x = a.copy()
    x[0, :3] = [0.0, -0.0, 1e-310]          # zero, signed zero, subnormal
    x[1, 0] = -x[1].__abs__().max()         # a row max that is negative
    w, nl, _ = ref_dd._plan(K, bits)
    rl, rs, rm = ref_dd._split_int(jnp.asarray(x), w, nl, axis)
    pl, ps, pm = dd._split_int(torch.from_numpy(x), w, nl, axis)
    assert_bitwise(rs, ps)
    assert_bitwise(rm, pm)
    assert_bitwise(rl, pl)


def test_split_fixed_shared_row_scales(ops):
    """The blocked Cholesky's form: a transposed operand against one
    a-priori scale per row."""
    a, _, _ = ops
    sc = ref_dd._row_norm_scales(jnp.asarray(np.abs(a[:, 0]) * 40.0))
    psc = dd._row_norm_scales(torch.from_numpy(np.abs(a[:, 0]) * 40.0))
    assert_bitwise(sc, psc)
    w, nl, _ = ref_dd._plan(K, 53)
    x = a.T[:16]                               # (16, M), column scales
    assert_bitwise(ref_dd._split_fixed(jnp.asarray(x), sc[None, :], w, nl),
                   dd._split_fixed(torch.from_numpy(a).T[:16],
                                   psc[None, :], w, nl))


@pytest.mark.parametrize("kc", [None, 16, 7])
@pytest.mark.parametrize("lhs_t", [False, True])
def test_limb_levels_plain_transposed_and_chunked(ops, kc, lhs_t):
    a, b, _ = ops
    w, nl, kc0 = ref_dd._plan(K, 53)
    kc = kc0 if kc is None else kc
    al, _, _ = ref_dd._split_int(jnp.asarray(a), w, nl, 0)
    bl, _, _ = ref_dd._split_int(jnp.asarray(b), w, nl, 1)
    if lhs_t:
        al = [x.T for x in al]
    want = ref_dd._limb_levels(al, bl, K, w, nl, kc, lhs_t=lhs_t)
    got = dd._limb_levels([torch.from_numpy(np.array(x)) for x in al],
                          [torch.from_numpy(np.array(x)) for x in bl],
                          K, w, nl, kc, lhs_t=lhs_t)
    assert got.dtype == (torch.int32 if kc >= K else torch.float64)
    assert_bitwise(want, got)
    # the recombine of the same levels, both forms of the epilogue
    assert_bitwise(ref_dd._level_recombine(want, w),
                   dd._level_recombine(got, w))


def test_recombine_scale_base_and_pair_dot(ops):
    a, b, base = ops
    w, nl, kc = ref_dd._plan(K, 53)
    al, sa, _ = ref_dd._split_int(jnp.asarray(a), w, nl, 0)
    bl, sb, _ = ref_dd._split_int(jnp.asarray(b), w, nl, 1)
    lv = ref_dd._limb_levels(al, bl, K, w, nl, kc)
    plv = torch.from_numpy(np.stack([np.array(x) for x in lv]))
    psa, psb = torch.from_numpy(np.array(sa)), torch.from_numpy(
        np.array(sb))
    pbase = torch.from_numpy(base)
    routed = pdd.ROUTED
    assert_bitwise(ref_dd._recombine_scale_base(lv, jnp.asarray(base), sa,
                                                sb, w),
                   dd._recombine_scale_base(plv, pbase, psa, psb, w))
    assert_bitwise(ref_dd._recombine_scale_base(lv, None, -sa, sb, w),
                   dd._recombine_scale_base(plv, None, -psa, psb, w))
    assert pdd.ROUTED == routed + 2
    with cfg.override_scope({"dd_epilogue": "off"}):
        assert_bitwise(ref_dd._recombine_scale_base(lv, None, -sa, sb, w),
                       dd._recombine_scale_base(plv, None, -psa, psb, w))
    assert pdd.ROUTED == routed + 2
    # the blocked sweep's K-major pair products
    alt = [x.T for x in al]
    palt = [torch.from_numpy(np.array(x)) for x in alt]
    pbl = [torch.from_numpy(np.array(x)) for x in bl]
    assert_bitwise(ref_dd._pair_dot(alt, bl, K, w, nl, kc),
                   dd._pair_dot(palt, pbl, K, w, nl, kc))
    assert_bitwise(
        ref_dd._pair_dot_base(alt, bl, jnp.asarray(base), sa, sb, K, w, nl,
                              kc),
        dd._pair_dot_base(palt, pbl, pbase, psa, psb, K, w, nl, kc))


@pytest.mark.parametrize("bits", [53, 32])
def test_gemm_residual_and_gemm_f64(ops, bits):
    a, b, base = ops
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert_bitwise(ref_dd.gemm_residual(jnp.asarray(base), ja, jb, bits),
                   dd.gemm_residual(torch.from_numpy(base), ta, tb, bits))
    assert_bitwise(ref_dd.gemm_f64(ja, jb, bits=bits),
                   dd.gemm_f64(ta, tb, bits=bits))
    # a transposed operand (what _potrf_tile_ir hands over: L.T)
    assert_bitwise(ref_dd.gemm_f64(ja[:32, :32].T, ja[:32], bits=bits),
                   dd.gemm_f64(ta[:32, :32].T, ta[:32], bits=bits))


def test_gemm_f64_nonfinite_mask(ops):
    a, b, _ = ops
    a, b = a.copy(), b.copy()
    a[3, 5], a[7, 0], b[2, 9] = np.nan, np.inf, -np.inf
    want = ref_dd.gemm_f64(jnp.asarray(a), jnp.asarray(b))
    got = dd.gemm_f64(torch.from_numpy(a), torch.from_numpy(b))
    assert_bitwise(want, got)
    g = got.numpy()
    assert np.isnan(g[3]).all() and np.isnan(g[7]).all()
    assert np.isnan(g[:, 9]).all() and np.isfinite(g[0, :9]).all()
    assert_bitwise(ref_dd.gemm_f64(jnp.asarray(a), jnp.asarray(b),
                                   _nonfinite_mask=False),
                   dd.gemm_f64(torch.from_numpy(a), torch.from_numpy(b),
                               _nonfinite_mask=False))


def test_gemm_dd_and_mm(ops):
    a, b, base = ops
    assert_bitwise(
        ref_dd.gemm_dd(0.51, jnp.asarray(a), jnp.asarray(b), -0.42,
                       jnp.asarray(base)),
        dd.gemm_dd(0.51, torch.from_numpy(a), torch.from_numpy(b), -0.42,
                   torch.from_numpy(base)))
    assert_bitwise(ref_dd.mm(jnp.asarray(a), jnp.asarray(b)),
                   dd.mm(torch.from_numpy(a), torch.from_numpy(b)))
    # f32 operands are promoted to f64 first, as in the reference
    a32 = a.astype(np.float32)
    assert_bitwise(ref_dd.mm(jnp.asarray(a32), jnp.asarray(b)),
                   dd.mm(torch.from_numpy(a32), torch.from_numpy(b)))
    # complex128 against a real operand: two 2K-deep limb products
    assert_bitwise(ref_dd.mm(jnp.asarray(a).astype(jnp.complex128),
                             jnp.asarray(b)),
                   dd.mm(torch.from_numpy(a).to(torch.complex128),
                         torch.from_numpy(b)))


def test_gemm_f64_beats_f32(ops):
    """Independent of the reference: a float64 product is met to f64
    rounding, orders of magnitude below the f32 product's error."""
    a, b, _ = ops
    exact = a @ b
    got = dd.gemm_f64(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    f32 = (a.astype(np.float32) @ b.astype(np.float32)).astype(np.float64)
    scale = np.abs(a).max(1)[:, None] * np.abs(b).max(0)[None, :] * K
    assert (np.abs(got - exact) / scale).max() < 2.0 ** -50
    assert (np.abs(f32 - exact) / scale).max() > 2.0 ** -30
