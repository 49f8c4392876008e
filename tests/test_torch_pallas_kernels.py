"""Port parity: K1 (``dplasma_tpu_torch.kernels.pallas_kernels``).

On the CPU the wrapper computes with ``gemm_reference``, the plain
PyTorch version of the CUDA kernel; here it is held against the
reference Pallas kernel run in interpret mode (as tests/test_pallas.py
runs it). The CUDA kernel itself is held against ``gemm_reference`` on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32 differs from the Pallas kernel only in summation order,
so |Δ| <= 8·eps32·K·max|A|·max|B| (+ the same for the beta·C term);
bf16 output additionally differs by at most one rounding of the output,
2^-8 relative to max|out|.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from dplasma_tpu.kernels import pallas_kernels as ref_pk
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from torch_threads import one_torch_thread  # noqa: F401

EPS32 = float(np.finfo(np.float32).eps)
SHAPES = [(300, 260, 270), (257, 384, 300)]


@pytest.fixture
def k1_on():
    was_ref, was_port = ref_pk.enabled(), pk.enabled()
    ref_pk.enable(True)
    pk.enable(True)
    try:
        yield
    finally:
        ref_pk.enable(was_ref)
        pk.enable(was_port)


def _operands(rng, M, K, N):
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    c = rng.standard_normal((M, N)).astype(np.float32)
    return a, b, c


def _bound(a, b, c, K, alpha, beta):
    tol = 8 * EPS32 * K * np.abs(a).max() * np.abs(b).max() * abs(alpha)
    if c is not None:
        tol += 8 * EPS32 * np.abs(c).max() * abs(beta)
    return tol


@requires_pallas
@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (2.0, -0.5),
                                        (0.75, 0.0)])
def test_gemm_reference_f32_matches_pallas(rng, M, K, N, alpha, beta):
    a, b, c = _operands(rng, M, K, N)
    want = np.asarray(ref_pk.gemm(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(c), alpha=alpha, beta=beta))
    got = pk.gemm_reference(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(c), alpha=alpha,
                            beta=beta).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= _bound(a, b, c, K, alpha, beta)


@requires_pallas
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_gemm_reference_matmul_f32_matches_pallas(rng, M, K, N):
    a, b, _ = _operands(rng, M, K, N)
    want = np.asarray(ref_pk.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = pk.gemm_reference(torch.from_numpy(a),
                            torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() <= _bound(a, b, None, K, 1.0, 0.0)


@requires_pallas
@pytest.mark.parametrize("with_c", [True, False])
def test_gemm_reference_bf16_matches_pallas(rng, with_c):
    M, K, N = SHAPES[0]
    a, b, c = _operands(rng, M, K, N)
    ja, jb, jc = (jnp.asarray(x, jnp.bfloat16) for x in (a, b, c))
    ta, tb, tc = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (a, b, c))
    if with_c:
        want = ref_pk.gemm(ja, jb, jc, alpha=1.5, beta=-0.25)
        got = pk.gemm_reference(ta, tb, tc, alpha=1.5, beta=-0.25)
    else:
        want = ref_pk.matmul(ja, jb)
        got = pk.gemm_reference(ta, tb)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    af = np.asarray(ja.astype(jnp.float32))
    bf = np.asarray(jb.astype(jnp.float32))
    tol = 2.0 ** -8 * np.abs(want).max() \
        + _bound(af, bf, c if with_c else None, K, 1.5, 0.25)
    assert np.abs(got - want).max() <= tol


def test_wrapper_on_cpu_routes_to_reference(rng, k1_on):
    a, b, c = _operands(rng, 260, 300, 270)
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    routed, launches = pk.ROUTED, pk.LAUNCHES
    out = pk.gemm(ta, tb, tc, alpha=2.0, beta=-1.0)
    assert torch.equal(out, pk.gemm_reference(ta, tb, tc, alpha=2.0,
                                              beta=-1.0))
    # a transposed view of B goes in as it is (strides, no copy)
    bt = torch.from_numpy(np.ascontiguousarray(b.T)).T
    assert torch.allclose(pk.matmul(ta, bt), pk.gemm_reference(ta, tb))
    assert pk.ROUTED == routed + 2
    assert pk.LAUNCHES == launches       # no CUDA launch on the CPU


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(256, 256)
    with pytest.raises(ValueError):
        pk.gemm(a, torch.zeros(255, 256))
    with pytest.raises(TypeError):
        pk.gemm(a, torch.zeros(256, 256, dtype=torch.float64))
    with pytest.raises(ValueError):
        pk.gemm(a.to("meta"), torch.zeros(256, 256, device="meta"))
    with pytest.raises(ValueError):
        pk.gemm(a[None], a)


_GRID = [(255, 300, 300), (256, 256, 256), (300, 255, 300),
         (300, 300, 255), (512, 1024, 256), (8, 8, 8)]
_DT = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
       (jnp.float64, torch.float64), (jnp.float16, torch.float16)]


@pytest.mark.parametrize("on", [True, False])
def test_eligible_matches_reference(on):
    was_ref, was_port = ref_pk.enabled(), pk.enabled()
    ref_pk.enable(on)
    pk.enable(on)
    try:
        for (M, K, N), (jdt, tdt), (jb_dt, tb_dt), with_c in \
                itertools.product(_GRID, _DT, _DT[:2], (True, False)):
            ja = jnp.zeros((M, K), jdt)
            jb = jnp.zeros((K, N), jb_dt)
            jc = jnp.zeros((M, N), jdt) if with_c else None
            ta = torch.zeros((M, K), dtype=tdt)
            tb = torch.zeros((K, N), dtype=tb_dt)
            tc = torch.zeros((M, N), dtype=tdt) if with_c else None
            assert pk.eligible(ta, tb, tc) == ref_pk.eligible(ja, jb, jc), \
                (M, K, N, jdt, jb_dt, with_c)
    finally:
        ref_pk.enable(was_ref)
        pk.enable(was_port)


# ---------------------------------------------------------------------
# 3xTF32: the split the tensor-core kernel makes, and its plain product
# ---------------------------------------------------------------------

def _np_rna_tf32(x):
    """TF32 rounding by sign and magnitude bits: keep the top 19 bits of
    the magnitude, add one unit of the kept part when the dropped 13 bits
    are at least half of it (ties away from zero); Inf and NaN as they
    are."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    sign, mag = u & 0x80000000, u & 0x7FFFFFFF
    keep, dropped = mag >> 13, mag & 0x1FFF
    keep = keep + (dropped >= 0x1000)
    out = sign | (keep << 13)
    special = (mag & 0x7F800000) == 0x7F800000
    return np.where(special, u, out).astype(np.uint32).view(np.float32)


def _tf32_cases(rng):
    """Values across the whole f32 range, signed zeros, subnormals, exact
    ties (normal and subnormal), the largest finite values, Inf and
    NaN."""
    vals = [rng.standard_normal(4000).astype(np.float32)
            * np.float32(2.0) ** rng.integers(-140, 120, 4000)]
    mant = rng.integers(0, 1 << 10, 500).astype(np.uint32)
    expo = rng.integers(1, 254, 500).astype(np.uint32)
    ties = (expo << 23) | (mant << 13) | 0x1000
    sub_ties = (mant << 13) | 0x1000
    vals += [ties.view(np.float32), (ties | 0x80000000).view(np.float32),
             sub_ties.view(np.float32),
             np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 3.4e38, -3.4e38,
                       np.finfo(np.float32).max, np.inf, -np.inf, np.nan,
                       1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)],
                      np.float32)]
    return np.concatenate(vals).astype(np.float32)


def test_tf32_rna_is_bitwise_the_sign_magnitude_rounding(rng):
    x = _tf32_cases(rng)
    got = pk.tf32_rna(torch.from_numpy(x)).numpy()
    want = _np_rna_tf32(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # ties go away from zero, and every result has 10 mantissa bits
    assert pk.tf32_rna(torch.tensor([1.0 + 2.0 ** -11])).item() \
        == 1.0 + 2.0 ** -10
    assert pk.tf32_rna(torch.tensor([-(1.0 + 2.0 ** -11)])).item() \
        == -(1.0 + 2.0 ** -10)
    finite = np.isfinite(got)
    assert not (got[finite].view(np.uint32) & 0x1FFF).any()
    assert np.signbit(pk.tf32_rna(torch.tensor([-0.0])).numpy()[0])


def test_tf32_rna_matches_float64_rounding_on_normal_values(rng):
    """An independent derivation for normal values: round |x| to 11
    significant bits in float64, halves away from zero."""
    x = rng.standard_normal(20000).astype(np.float32) \
        * np.float32(2.0) ** rng.integers(-100, 100, 20000)
    x = x[(np.abs(x) >= np.finfo(np.float32).tiny) & (np.abs(x) < 1e38)]
    ax = np.abs(x.astype(np.float64))
    step = 2.0 ** (np.floor(np.log2(ax)) - 10)
    want = np.sign(x) * np.floor(ax / step + 0.5) * step
    got = pk.tf32_rna(torch.from_numpy(x)).numpy().astype(np.float64)
    assert np.array_equal(got, want)


def test_tf32_split_reproduces_x(rng):
    x = rng.standard_normal(20000).astype(np.float32) \
        * np.float32(2.0) ** rng.integers(-100, 100, 20000)
    hi, lo = pk.tf32_split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    err = np.abs(x64 - (hi.astype(np.float64) + lo.astype(np.float64)))
    assert (err <= 2.0 ** -21 * np.abs(x64)).all()
    # Inf and NaN keep their hi, with lo = 0
    hi, lo = pk.tf32_split(torch.tensor([np.inf, -np.inf, np.nan]))
    assert torch.isinf(hi[:2]).all() and torch.isnan(hi[2])
    assert (lo == 0).all()


@requires_pallas
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_3xtf32_product_matches_pallas(rng, M, K, N):
    """The tensor-core kernel's arithmetic in plain f32 matmuls (three
    products of TF32 values, lo*lo dropped) against the reference K1 in
    interpret mode: within the summation-order bound plus the dropped
    term's, K * 2^-21 * max|A| * max|B|."""
    a, b, _ = _operands(rng, M, K, N)
    want = np.asarray(ref_pk.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = pk.gemm_3xtf32_reference(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    tol = _bound(a, b, None, K, 1.0, 0.0) \
        + 2.0 ** -21 * K * np.abs(a).max() * np.abs(b).max()
    assert np.abs(got - want).max() <= tol
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# ---------------------------------------------------------------------
# The plan: which kernel, tile and split each main-path product gets
# ---------------------------------------------------------------------

def _spotrf_products(n=16384, nb=1024):
    """spotrf's 29 products at lookahead 1: A a row slab of the matrix
    (row stride n), B a b.T view of another (stride (1, n))."""
    out = []
    for k in range(1, n // nb):
        m = n - k * nb
        out.append((m, nb, nb, (n, 1), (1, n)))
        if k >= 2:
            out.append((m, (k - 1) * nb, nb, (n, 1), (1, n)))
    return out


def _lu_qr_products(n=8192, nb=256):
    """The product families one sgetrf and one sgeqrf factorization give
    K1 (recorded on the CPU at small n): LU's l21 @ u12.T view, QR's
    V^T (a transposed view) @ C and its row-major updates."""
    out = []
    for m in range(nb, n, nb):
        out.append((m, nb, nb, (nb, 1), (1, nb)))            # LU panel col
        out.append((m, nb, n - m, (nb, 1), (1, nb)))         # LU trailing
        out.append((nb, m, nb, (1, nb), (n, 1)))             # QR V^T V
        out.append((nb, m, n - m + nb, (1, nb), (n, 1)))     # QR V^T C
        out.append((m, nb, nb, (nb, 1), (nb, 1)))            # QR V T
        out.append((m, nb, n - m + nb, (nb, 1), (n, 1)))     # QR update
    return out


def _cyclic_products():
    """getrf_cyclic (N=8192, nb=512, 2x2): l21 @ u12 and the lookahead's
    column slice u12[:, c1]; potrf_cyclic (N=16384, nb=1024): Lbelow @
    W.T, b.T views."""
    return [(4096, 512, 4096, (512, 1), (4096, 1)),
            (4096, 512, 512, (512, 1), (4096, 1)),
            (8192, 1024, 8192, (1024, 1), (1, 1024)),
            (8192, 1024, 1024, (1024, 1), (1, 1024))]


@pytest.mark.parametrize("family", ["spotrf", "lu_qr", "cyclic"])
def test_plan_sends_every_main_path_product_to_the_tensor_cores(family):
    prods = {"spotrf": _spotrf_products, "lu_qr": _lu_qr_products,
             "cyclic": _cyclic_products}[family]()
    for M, K, N, sa, sb in prods:
        p = pk.plan(M, N, K, "float32", sa, sb, 0, 0)
        assert p.kernel == "wgmma", (M, K, N, sa, sb)
        assert (p.bm, p.bn, p.bk) == (128, 128, 32)
        assert p.a_kmajor == (sa[1] == 1) and p.b_kmajor == (sb[0] == 1)
        ktiles = -(-K // p.bk)
        # no empty split, every K tile in exactly one
        assert (p.splits - 1) * p.kt_per < ktiles <= p.splits * p.kt_per
        # the card is filled: whole tiles where there are enough, else
        # as many splits as it holds (each at least MIN_KT_PER_SPLIT deep)
        if p.tiles >= pk.H100_SMS:
            assert p.splits == 1
        else:
            assert p.work_units <= 2 * pk.H100_SMS
            assert p.work_units >= pk.H100_SMS // 2 or \
                ktiles < 2 * pk.MIN_KT_PER_SPLIT * (p.splits + 1), \
                (M, K, N, p)


def test_plan_splits_the_deep_narrow_gram():
    p = pk.plan(256, 256, 8192, "float32", (1, 256), (8192, 1))
    assert p.kernel == "wgmma" and p.tiles == 4
    assert p.splits > 1 and p.work_units >= 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_sends_what_tma_cannot_describe_to_the_ffma_kernel(dtype):
    # the ragged K = 777 case: a leading stride of 777 elements is not a
    # multiple of 16 bytes
    assert pk.plan(1000, 1030, 777, dtype, (777, 1), (1030, 1)).kernel \
        == "ffma"
    # neither stride of B is 1
    assert pk.plan(512, 512, 512, dtype, (512, 1), (1024, 2)).kernel \
        == "ffma"
    # a base address off 16 bytes
    assert pk.plan(512, 512, 512, dtype, (512, 1), (512, 1), 4, 0).kernel \
        == "ffma"
    # aligned, both layouts
    p = pk.plan(512, 512, 512, dtype, (1, 512), (1, 512))
    assert p.kernel == "wgmma" and not p.a_kmajor and p.b_kmajor
    assert p.bk == (32 if dtype == "float32" else 64)


def test_plan_for_reads_strides_and_alignment_on_the_cpu():
    a = torch.zeros(512, 1024)
    b = torch.zeros(2048, 1024).T
    p = pk.plan_for(a, b)
    assert p == pk.plan(512, 2048, 1024, torch.float32, (1024, 1),
                        (1, 1024), a.data_ptr(), b.data_ptr())
    assert p.kernel == "wgmma" and p.a_kmajor and p.b_kmajor
    assert pk.plan_for(a[:, 1:], b[1:]).kernel == "ffma"
