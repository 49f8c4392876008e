"""The port's hand-written kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip where there is no
GPU; on a machine with one they build K1, K2, K3 and K4 from
``kernels/csrc`` and hold each against its plain PyTorch version:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: K1, relative Frobenius error <= 1e-5 for f32 (3xTF32 on
the tensor cores drops the lo*lo term, 2^-22 relative, and sums in
another order) and <= 1e-2 for bf16 output; against a float64 product
its f32 error is no worse than twice torch.matmul's (full FP32), and a
product split over K gives the same bits on every launch. K3, bitwise equal to its
plain version, permutation and packed factor (the kernel rounds each
step as the plain version does, whichever block of its cluster owns the
row), also over 100 back-to-back launches (a fault in the ordering of
memory between the cluster's SMs would show as an occasional
difference). K4, max|Δpacked|/max|packed| <= 1e-4 and max|Δtau| <= 1e-4
(it sums in another order than the plain version), the Q rebuilt from
its output passes the reference's QR checks (< 60), and two launches
agree bitwise (its sums run in a fixed order). K2 (the int8 limb
product with the recombine fused), bitwise equal to its plain version
(integer sums are exact in any order within int32, and every operation
of the f64 epilogue is exact but the last rounding, which both make the
same), also split over K and over 1000 back-to-back launches; the dd
products it closes are therefore bitwise equal on the card and on the
CPU. K5, bitwise equal to
its plain version (it moves bytes), also over many launches on one flag
buffer (flags are never reset), and the cyclic factorizations' ring
route ``torch.equal`` to their psum route. The IR slice's K2 shapes
(the skinny residual, the nl = 5 square product) bitwise as above; the
block-scaled int8 GEMM's int8 parts bitwise against the CPU, its f32
sum within 1e-6; ``posv_ir`` converging with every residual on K2. The
Cholesky inverse family and the symmetric Level-3 BLAS: every K1
product of trtri, lauum, syrk and syr2k (two views of one buffer, one
transposed) on the tensor-core kernel within 1e-5 of gemm_reference
(or, where the f32 summation order itself moves the result more, with
an error against float64 within twice torch.matmul's),
the launch counts the ops' k.dot sites give, and every K2 product of a
dd poinv bitwise equal to its plain version. The complex slice: the c
and z generators bitwise equal on the card and the CPU; a complex dd
product two 2K-deep K2 launches, each bitwise, the whole product the
CPU's bits; zpotrf under dd with its derived launch count; the
incpiv/qrf K1 products held as the inverse family's. The eigen/SVD
slice: KT ``torch.equal`` to its plain version (random at n = 700 and
2048, clustered, zero-diagonal and n = 2 tridiagonals; bisection run to
nmant + 1 levels, which is where the plain version's global stop ends
on these), ascending, one launch a call; with targets (and gesvd's K
kept values of a Jordan–Wielandt tridiagonal) the full launch's bits
at their indices; the same bits under every plan of the shared tree
(flat, shallow, deep; resident or streamed pairs) and at n = 40000
f32, whose pairs do not fit shared memory; KW step by step against
its plain version on random storage of the herm 32-, 4- and 64-wide
and the bidiag 31- and 127-wide sweeps (the 127-wide a
cluster of CTAs in f64, c64 and c128; f64/c128 within 1e-11 relative;
f32/c64 finite and, over the sweep, a median distance to the step in
twice the precision at most 4x the plain version's: once a random block
is close to rank-deficient its last reflectors come from rounding noise
and both f32 routes land far from the wide step); every default-ladder
sweep (herm 64, 16, 4; bidiag 127, 31, 7) in each dtype in one launch
``torch.equal`` to its one-step launches, the narrow ones' warp and
block forms too; an shetrd and an sgesvd on the card with one KW launch
a sweep over the steps, the KT / K1 launches the schedules give, and
the spectrum of the dense solver. The block-cyclic catalogue:
geqrf_cyclic's K5 ring route ``torch.equal`` to its psum route and,
against the float64 factor, within 4x the CPU f32 route's error;
SUMMA's K1 launches all on the tensor cores; heev_cyclic's KW and KT
launches.
"""
import pytest
import torch

from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.kernels import pallas_lu as plu
from dplasma_tpu_torch.kernels import pallas_qr as pqr
from dplasma_tpu_torch.kernels import pallas_ring as pring

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def k1_on():
    was = pk.enabled()
    pk.enable(True)
    try:
        yield
    finally:
        pk.enable(was)


def _rel(got, want):
    want = want.double()
    return float(torch.linalg.norm(got.double() - want)
                 / torch.linalg.norm(want))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("beta", [0.0, -0.5])
@pytest.mark.parametrize("b_view", [False, True])
def test_k1_matches_plain_version(card, dtype, tol, beta, b_view):
    g = torch.Generator(device=card).manual_seed(5)
    M, K, N = 1000, 777, 1030
    a = torch.randn(M, K, device=card, generator=g).to(dtype)
    b = torch.randn(N, K, device=card, generator=g).to(dtype).T \
        if b_view else torch.randn(K, N, device=card, generator=g).to(dtype)
    c = torch.randn(M, N, device=card, generator=g).to(dtype)
    launches = pk.LAUNCHES
    got = pk.gemm(a, b, c, alpha=1.5, beta=beta)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == launches + 1
    assert got.dtype == dtype and got.shape == (M, N)
    want = pk.gemm_reference(a, b, c, alpha=1.5, beta=beta)
    assert _rel(got, want) <= tol


def _k1_operands(card, g, M, K, N, layout, dtype):
    """A and B of one product in a main-path layout: ``gram``/``vtc``
    sgeqrf's V^T view (unit stride along M) times a row-major B; ``bT``
    a b.T view; ``cols`` a column slice of a wider row-major B."""
    if layout in ("gram", "vtc"):
        a = torch.randn(K, M, device=card, generator=g).to(dtype).T
    else:
        a = torch.randn(M, K, device=card, generator=g).to(dtype)
    if layout == "bT":
        b = torch.randn(N, K, device=card, generator=g).to(dtype).T
    elif layout == "cols":
        b = torch.randn(K, 4 * N, device=card,
                        generator=g).to(dtype)[:, N:2 * N]
    else:
        b = torch.randn(K, N, device=card, generator=g).to(dtype)
    return a, b


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("beta", [0.0, -0.5])
@pytest.mark.parametrize("M,K,N,layout", [
    (256, 8192, 256, "gram"), (256, 8192, 2048, "vtc"),
    (2048, 1024, 1024, "bT"), (3072, 512, 512, "cols")])
def test_k1_tensor_core_kernel_matches_plain_version(card, dtype, tol, beta,
                                                     M, K, N, layout):
    """The main paths' layouts take the tensor-core kernel (3xTF32 for
    f32, one bf16 pass) and agree with gemm_reference."""
    g = torch.Generator(device=card).manual_seed(M + K + N)
    a, b = _k1_operands(card, g, M, K, N, layout, dtype)
    c = torch.randn(M, N, device=card, generator=g).to(dtype)
    assert pk.plan_for(a, b).kernel == "wgmma"
    wgmma = pk.WGMMA_LAUNCHES
    got = pk.gemm(a, b, c, alpha=1.5, beta=beta)
    torch.cuda.synchronize()
    assert pk.WGMMA_LAUNCHES == wgmma + 1
    assert got.dtype == dtype and got.shape == (M, N)
    assert _rel(got, pk.gemm_reference(a, b, c, alpha=1.5, beta=beta)) <= tol


def test_k1_split_k_launches_are_bitwise_equal(card):
    g = torch.Generator(device=card).manual_seed(8)
    a, b = _k1_operands(card, g, 256, 8192, 256, "gram", torch.float32)
    plan = pk.plan_for(a, b)
    assert plan.kernel == "wgmma" and plan.splits > 1
    assert plan.work_units >= 64
    first = pk.matmul(a, b)
    for _ in range(5):
        assert torch.equal(pk.matmul(a, b), first)


@pytest.mark.parametrize("M,K,N,layout", [
    (256, 8192, 256, "gram"), (4096, 4096, 1024, "bT"),
    (1024, 14336, 1024, "bT")])
def test_k1_error_against_float64_within_twice_fp32_matmul(card, M, K, N,
                                                           layout):
    g = torch.Generator(device=card).manual_seed(9)
    a, b = _k1_operands(card, g, M, K, N, layout, torch.float32)
    exact = a.double() @ b.double()
    mine = _rel(pk.matmul(a, b), exact)
    fp32 = _rel(torch.matmul(a, b), exact)
    assert mine <= 2 * fp32, (mine, fp32)


def test_k1_rejects_mixed_devices(card):
    with pytest.raises(ValueError, match="different devices"):
        pk.gemm(torch.zeros(256, 256, device=card), torch.zeros(256, 256))


def test_spotrf_on_card_routes_every_update(card, k1_on):
    from dplasma_tpu_torch.ops import checks, generators, potrf
    A = generators.plghe(2048.0, 2048, 256, seed=3)
    launches = pk.LAUNCHES
    L = potrf.potrf(A, "L", lookahead=1)
    torch.cuda.synchronize()
    assert pk.LAUNCHES - launches == 2 * 8 - 3
    r, ok = checks.check_potrf(A, L, "L")
    assert ok, r
    A_cpu = generators.plghe(2048.0, 2048, 256, seed=3, device="cpu")
    L_cpu = potrf.potrf(A_cpu, "L", lookahead=1)
    assert torch.allclose(L.data.cpu(), L_cpu.data, rtol=0, atol=1e-4)


def _k3_check(a):
    launches = plu.LAUNCHES
    packed, perm = plu.lu_panel(a)
    torch.cuda.synchronize()
    assert plu.LAUNCHES == launches + 1
    want, wperm = plu.lu_panel_reference(a)
    assert packed.shape == a.shape and packed.dtype == torch.float32
    assert torch.isfinite(packed).all()
    assert torch.equal(perm, wperm)
    assert torch.equal(packed, want)
    return packed, perm


def _tie_panel(card, M, nb):
    """An integer panel full of ties across the blocks of the cluster,
    with column 0's largest |a| twice in the last block (the lower of the
    two wins) and row 0 in the first."""
    g = torch.Generator(device=card).manual_seed(11)
    a = torch.randint(-2, 3, (M, nb), device=card, generator=g).float()
    a[:, 0] = 1.0
    a[M - 3, 0], a[M - 1, 0] = 7.0, -7.0
    return a


@pytest.mark.parametrize("M,nb", [(1000, 64), (4096, 256), (8192, 256),
                                  (256, 256), (262144, 8), (5000, 24)])
def test_k3_matches_plain_version(card, M, nb):
    g = torch.Generator(device=card).manual_seed(M + nb)
    a = torch.randn(M, nb, device=card, generator=g)
    packed, perm = _k3_check(a)
    L = torch.tril(packed, -1) + torch.eye(M, nb, device=card)
    assert torch.allclose(a[perm], L @ torch.triu(packed[:nb]), atol=1e-4)


def test_k3_ties_signed_zeros_and_zero_column(card):
    g = torch.Generator(device=card).manual_seed(3)
    a = torch.randint(-2, 3, (2048, 64), device=card, generator=g).float()
    a[:, 5] = 0.0
    a[a == 0] = -0.0
    packed, _ = _k3_check(a)
    assert (packed[6:, 5] == 0).all()


def test_k3_tie_winner_in_the_last_block(card):
    M, nb = 4096, 64
    assert plu.launch_geometry(M, nb).cluster > 2
    packed, perm = _k3_check(_tie_panel(card, M, nb))
    assert int(perm[0]) == M - 3


def test_k3_rows_not_a_multiple_of_the_cluster(card):
    M, nb = 8184, 256
    assert M % plu.launch_geometry(M, nb).cluster
    g = torch.Generator(device=card).manual_seed(12)
    _k3_check(torch.randn(M, nb, device=card, generator=g))


def test_k3_two_launches_agree_bitwise(card):
    g = torch.Generator(device=card).manual_seed(13)
    a = torch.randn(8192, 256, device=card, generator=g)
    p1, q1 = plu.lu_panel(a)
    p2, q2 = plu.lu_panel(a)
    assert torch.equal(p1, p2) and torch.equal(q1, q2)


def test_k3_100_back_to_back_launches_match_plain_version(card):
    g = torch.Generator(device=card).manual_seed(14)
    a = torch.randn(8192, 256, device=card, generator=g)
    want, wperm = plu.lu_panel_reference(a)
    launches = plu.LAUNCHES
    outs = [plu.lu_panel(a) for _ in range(100)]
    torch.cuda.synchronize()
    assert plu.LAUNCHES == launches + 100
    bad = [n for n, (p, q) in enumerate(outs)
           if not (torch.equal(p, want) and torch.equal(q, wperm))]
    assert not bad, f"launches {bad} differ from the plain version"


def test_k3_takes_strided_panels(card):
    g = torch.Generator(device=card).manual_seed(4)
    big = torch.randn(3000, 512, device=card, generator=g)
    _k3_check(big[100:2100, 256:320])


def test_sgetrf_on_card_routes_every_panel_and_product(card, k1_on):
    from dplasma_tpu_torch.ops import checks, generators, lu
    from dplasma_tpu_torch.utils import config as cfg
    A = generators.plrnt(2048, 2048, 256, 256, seed=3)
    k1, k3 = pk.LAUNCHES, plu.LAUNCHES
    with cfg.override_scope({"panel.kernel": "pallas"}):
        LU, perm = lu.getrf_1d(A)
    torch.cuda.synchronize()
    assert (pk.LAUNCHES - k1, plu.LAUNCHES - k3) == (2 * 8 - 3, 8)
    B = generators.plrnt(2048, 1, 256, 256, seed=4)
    r, ok = checks.check_axmb(A, B, lu.getrs("N", LU, perm, B))
    assert ok, r


def _k4_check(a):
    from dplasma_tpu_torch.descriptors import TileMatrix
    from dplasma_tpu_torch.ops import checks
    launches = pqr.LAUNCHES
    packed, taus = pqr.geqrt_panel_packed(a)
    torch.cuda.synchronize()
    assert pqr.LAUNCHES == launches + 1
    want, wtau = pqr.geqrt_panel_reference(a)
    M, nb = a.shape
    assert packed.shape == a.shape and packed.dtype == torch.float32
    assert taus.shape == (nb,) and torch.isfinite(packed).all()
    err = (packed - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-4
    assert float((taus - wtau).abs().max()) <= 1e-4
    # Q = H_0 ... H_{nb-1} from the packed panel: A = Q R, Q orthonormal
    _, v, T = pqr.geqrt_panel(a)
    q = (torch.eye(M, nb, device=a.device)
         - v @ (T @ v[:nb].T))
    A0 = TileMatrix.from_dense(a, nb, nb)
    assert checks.check_qr(A0, q, torch.triu(packed[:nb]))[1]
    assert checks.check_orthogonality(q)[1]
    return packed, taus


@pytest.mark.parametrize("M,nb", [(1000, 64), (4096, 256), (8192, 256),
                                  (256, 256), (262144, 8), (5000, 24)])
def test_k4_matches_plain_version(card, M, nb):
    g = torch.Generator(device=card).manual_seed(M + nb + 1)
    _k4_check(torch.randn(M, nb, device=card, generator=g))


def test_k4_square_panel_reflects_the_last_column(card):
    """The reference's rule: a column with nothing below its diagonal
    reflects with tau = 2."""
    g = torch.Generator(device=card).manual_seed(9)
    _, taus = _k4_check(torch.randn(256, 256, device=card, generator=g))
    assert float(taus[-1]) == 2.0


def test_k4_tie_panel_and_rows_not_a_multiple_of_the_cluster(card):
    _k4_check(_tie_panel(card, 4096, 64))
    g = torch.Generator(device=card).manual_seed(15)
    _k4_check(torch.randn(8184, 256, device=card, generator=g))


def test_k4_two_launches_agree_bitwise(card):
    g = torch.Generator(device=card).manual_seed(16)
    for M, nb in ((8192, 256), (262144, 8)):
        a = torch.randn(M, nb, device=card, generator=g)
        p1, t1 = pqr.geqrt_panel_packed(a)
        p2, t2 = pqr.geqrt_panel_packed(a)
        assert torch.equal(p1, p2) and torch.equal(t1, t2), (M, nb)


def test_k4_zero_column_and_strided_panel(card):
    g = torch.Generator(device=card).manual_seed(10)
    a = torch.randn(2048, 64, device=card, generator=g)
    a[:, 5] = 0.0
    packed, taus = pqr.geqrt_panel_packed(a)
    want, wtau = pqr.geqrt_panel_reference(a)
    torch.cuda.synchronize()
    assert float(taus[5]) == 0.0 == float(wtau[5])
    assert (packed[6:, 5] == 0).all() and torch.isfinite(packed).all()
    big = torch.randn(3000, 512, device=card, generator=g)
    _k4_check(big[100:2100, 256:320])
    _k4_check(big.T[64:128].T)


def test_sgeqrf_on_card_routes_every_panel_and_product(card, k1_on):
    """N=2048, nb=256 (KT=8), panel.kernel=pallas: 8 K4 launches and
    11.5·8 − 24 = 68 K1 products (ops/qr.py's count)."""
    from dplasma_tpu_torch.ops import checks, generators, qr
    from dplasma_tpu_torch.utils import config as cfg
    A = generators.plrnt(2048, 2048, 256, 256, seed=3)
    k1, k4 = pk.LAUNCHES, pqr.LAUNCHES
    with cfg.override_scope({"panel.kernel": "pallas"}):
        Af, Tf = qr.geqrf(A)
    torch.cuda.synchronize()
    assert (pk.LAUNCHES - k1, pqr.LAUNCHES - k4) == (68, 8)
    Q = qr.ungqr(Af, Tf).to_dense()
    R = torch.triu(Af.to_dense())
    r, ok = checks.check_qr(A, Q, R)
    assert ok, r
    r, ok = checks.check_orthogonality(Q)
    assert ok, r


def _k2_operands(card, nl, M, N, K, seed, *, digits=None):
    """Limb planes (nl, M, K) and (nl, N, K) of random f64 operands split
    as the dd route splits them (``dd._split_rows``), their scales, and a
    base; ``digits`` fills every digit with that value instead."""
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.randn(M, K, device=card, generator=g, dtype=torch.float64)
    b = torch.randn(N, K, device=card, generator=g, dtype=torch.float64)
    w, _, _ = dd._plan(K, 53)
    al, sa, _ = dd._split_rows(a, w, nl)
    bl, sb, _ = dd._split_rows(b, w, nl)
    if digits is not None:
        al.fill_(digits)
        bl.fill_(digits)
    base = torch.randn(M, N, device=card, generator=g,
                       dtype=torch.float64) * 8.0
    return al, bl, base, sa, sb.T


def _k2_check(al, bl, base, sa, sb, w=7):
    """The fused kernel, one launch, bitwise equal to its plain version."""
    launches, unfused = pdd.LAUNCHES, pdd.UNFUSED
    got = pdd.limb_product_base(al, bl, base, sa, sb, w)
    torch.cuda.synchronize()
    assert (pdd.LAUNCHES, pdd.UNFUSED) == (launches + 1, unfused)
    want = pdd.limb_product_base_reference(al, bl, base, sa, sb, w)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    return got


@pytest.mark.parametrize("nl,M,N,K", [(8, 1000, 300, 777),
                                      (5, 1000, 300, 777),
                                      (8, 7680, 512, 512),
                                      (5, 512, 512, 512), (8, 1, 1, 1),
                                      (3, 17, 9, 13), (8, 130, 70, 1100)])
def test_k2_matches_plain_version_bitwise(card, nl, M, N, K):
    al, bl, base, sa, sb = _k2_operands(card, nl, M, N, K, seed=nl + M)
    _k2_check(al, bl, base, sa, sb)
    _k2_check(al, bl, None, -sa, sb)          # the gemm_f64 form
    _k2_check(al, bl, None, None, None)       # _pair_dot's unscaled form
    # K not a multiple of 16 in contiguous planes: TMA needs the copy
    contiguous = al.contiguous(), bl.contiguous()
    assert pdd.plan_for(*contiguous).a_copy == (K % 16 != 0)
    _k2_check(*contiguous, base, sa, sb)


@pytest.mark.parametrize("nl", [8, 5])
def test_k2_strided_base_and_extreme_levels(card, nl):
    """Every digit +127 (or -127 in B) at K = the int32 bound: every
    level sum at its largest; the base a view and a transposed view."""
    K = pdd.max_depth(nl)
    al, bl, _, sa, sb = _k2_operands(card, nl, 192, 130, K, seed=9,
                                     digits=127)
    bl.neg_()
    A = torch.randn(2048, 2048, device=card, dtype=torch.float64)
    _k2_check(al, bl, A[1000:1192, 512:642], sa, sb)     # a view of A
    _k2_check(al, bl, A[512:642, 1000:1192].T, sa, sb)   # transposed
    _k2_check(al, bl, None, -sa, sb)


def test_k2_cache_views_at_several_k(card):
    """The blocked sweep's trailing product: K-major views of one limb
    cache W[l, row, col] handed over with no copy, at several k."""
    N, nb = 2048, 256
    g = torch.Generator(device=card).manual_seed(11)
    F = torch.randn(N, N - nb, device=card, generator=g,
                    dtype=torch.float64)
    scale = dd._row_norm_scales(torch.full((N,), float(N), device=card,
                                           dtype=torch.float64))[:, None]
    w, nl, _ = dd._plan(N, 53)
    W = torch.zeros((nl, N, N - nb), dtype=torch.int8, device=card)
    dd._split_fixed(F * 8.0, scale, w, nl, out=W)   # |x| < scale/2
    A = torch.randn(N, N, device=card, generator=g, dtype=torch.float64)
    for k in (1, 2, 5, 7):
        s = k * nb
        al, bl = W[:, s:, :s], W[:, s:s + nb, :s]
        p = pdd.plan_for(al, bl)
        assert not (p.a_copy or p.b_copy), p
        _k2_check(al, bl, A[s:, s:s + nb], scale[s:], scale[s:s + nb].T)


def test_k2_split_shapes_and_many_launches(card):
    """Products whose tiles are too few to fill the card split over K in
    the launch; 1000 back-to-back launches each give the same bits (the
    workspace and counters are left zero by every launch)."""
    for nl, M, N, K in ((8, 512, 512, 512), (5, 512, 512, 512),
                        (8, 512, 512, 7680), (8, 100, 70, 3000)):
        al, bl, base, sa, sb = _k2_operands(card, nl, M, N, K, seed=K + M)
        assert pdd.plan_for(al, bl).splits > 1
        _k2_check(al, bl, base, sa, sb)
    al, bl, base, sa, sb = _k2_operands(card, 8, 512, 512, 512, seed=3)
    want = pdd.limb_product_base_reference(al, bl, base, sa, sb, 7)
    for i in range(1000):
        got = pdd.limb_product_base(al, bl, base, sa, sb, 7)
        assert torch.equal(got.view(torch.int64),
                           want.view(torch.int64)), i


def test_k2_misaligned_operand_is_padded_not_rerouted(card):
    """An operand TMA cannot describe (an odd base address, an odd row
    stride) is copied once into an aligned buffer and still launches the
    fused kernel."""
    al, bl, base, sa, sb = _k2_operands(card, 8, 300, 200, 528, seed=4)
    buf = torch.zeros((8, 300, 530), dtype=torch.int8, device=card)
    buf[:, :, 1:529] = al
    odd = buf[:, :, 1:529]                       # base address + 1
    assert pdd.plan_for(odd, bl).a_copy
    routed = pdd.ROUTED
    _k2_check(odd, bl, base, sa, sb)
    assert pdd.ROUTED == routed + 1
    odd_rows = bl[:, :, :527].contiguous()       # row stride 527
    assert pdd.plan_for(al[:, :, :527], odd_rows).b_copy
    _k2_check(al[:, :, :527], odd_rows, base, sa, sb)


def test_k2_only_cpu_takes_the_plain_version(card):
    al, bl, base, sa, sb = _k2_operands(card, 8, 64, 64, 96, seed=2)
    routed, launches = pdd.ROUTED, pdd.LAUNCHES
    got = pdd.limb_product_base(al.cpu(), bl.cpu(), base.cpu(), sa.cpu(),
                                sb.cpu(), 7)
    assert (pdd.ROUTED, pdd.LAUNCHES) == (routed + 1, launches)
    assert torch.equal(got, _k2_check(al, bl, base, sa, sb).cpu())
    with pytest.raises(ValueError, match="different devices"):
        pdd.limb_product_base(al, bl, base.cpu(), sa, sb, 7)
    lv = torch.zeros((8, 64, 64), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="fused"):
        pdd.recombine_base(lv, base, sa, sb, 7)


@pytest.mark.parametrize("M,K,N,view", [(300, 200, 100, False),
                                        (5, 13, 3, False),
                                        (520, 1024, 512, True)])
def test_int8_products_and_dd_gemm_match_the_cpu_bitwise(card, M, K, N,
                                                         view):
    """``_imm`` (``torch._int_mm`` with the card's shape and layout rules
    met by copies) and the whole dd product are exact, so the card and
    the CPU give the same bits."""
    rng = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (K, M) if view else (M, K), generator=rng,
                      dtype=torch.int8)
    a = a.T if view else a
    b = torch.randint(-127, 128, (K, N), generator=rng, dtype=torch.int8)
    assert torch.equal(dd._imm(a.to(card), b.to(card)).cpu(),
                       dd._imm(a, b))
    x = torch.randn(M, K, generator=rng, dtype=torch.float64)
    y = torch.randn(K, N, generator=rng, dtype=torch.float64)
    launches = pdd.LAUNCHES
    got = dd.gemm_f64(x.to(card), y.to(card))
    torch.cuda.synchronize()
    assert pdd.LAUNCHES == launches + 1
    assert torch.equal(got.cpu().view(torch.int64),
                       dd.gemm_f64(x, y).view(torch.int64))


def test_dpotrf_dd_on_card_routes_every_product(card):
    """N=2048, nb=512 under dd_gemm=always: 5·4 − 3 = 17 K2 launches and
    no K1; the factor agrees with a float64 host Cholesky."""
    from dplasma_tpu_torch.ops import checks, generators, potrf
    from dplasma_tpu_torch.utils import config as cfg
    A = generators.plghe(2048.0, 2048, 512, seed=3, dtype=torch.float64)
    k1, k2, unfused = pk.LAUNCHES, pdd.LAUNCHES, pdd.UNFUSED
    with cfg.override_scope({"dd_gemm": "always"}):
        L = potrf.potrf(A, "L")
    torch.cuda.synchronize()
    assert (pk.LAUNCHES - k1, pdd.LAUNCHES - k2) == (0, 17)
    assert pdd.UNFUSED == unfused
    r, ok = checks.check_potrf(A, L, "L")
    assert ok, r
    L64 = torch.linalg.cholesky(A.to_dense().cpu())
    err = (L.to_dense().cpu() - L64).abs().max() / L64.abs().max()
    assert float(err) <= 1e-11


@pytest.mark.parametrize("nl,nrhs", [(8, 1), (8, 4), (5, 4)])
def test_k2_skinny_residual_matches_plain_version(card, nl, nrhs):
    """The IR residual b − A x: an N×nrhs output with K = N, one 64-wide
    tile column whose B box TMA zero-fills past nrhs; one fused launch,
    bitwise to its plain version, and the whole ``gemm_residual`` the
    same bits as on the CPU."""
    N = 2048
    g = torch.Generator(device=card).manual_seed(nrhs + nl)
    a = torch.randn(N, N, device=card, generator=g, dtype=torch.float64)
    x = torch.randn(N, nrhs, device=card, generator=g, dtype=torch.float64)
    b = torch.randn(N, nrhs, device=card, generator=g, dtype=torch.float64)
    al, sa, _ = dd._split_rows(a, 7, nl)
    bl, sb, _ = dd._split_rows(x.T, 7, nl)
    _k2_check(al, bl, b, sa, sb.T)
    _k2_check(al, bl, b[:, :nrhs].T.contiguous().T, sa, sb.T)
    bits = 53 if nl == 8 else 32
    launches, unfused = pdd.LAUNCHES, pdd.UNFUSED
    got = dd.gemm_residual(b, a, x, bits=bits)
    torch.cuda.synchronize()
    assert (pdd.LAUNCHES - launches, pdd.UNFUSED - unfused) == (1, 0)
    want = dd.gemm_residual(b.cpu(), a.cpu(), x.cpu(), bits=bits)
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


def test_k2_nl5_square_product_matches_plain_version(card):
    """The f32x2 rung's whole-matrix products at bits=32 (nl = 5): E = A
    − L Lᵀ at K = N in one launch, bitwise."""
    N = 2048
    g = torch.Generator(device=card).manual_seed(5)
    a = torch.randn(N, N, device=card, generator=g, dtype=torch.float64)
    L = torch.tril(torch.randn(N, N, device=card, generator=g,
                               dtype=torch.float64))
    w, nl, kc = dd._plan(N, 32)
    assert nl == 5 and kc == N
    al, sa, _ = dd._split_rows(L, w, nl)
    bl, sb, _ = dd._split_rows(L, w, nl)           # (Lᵀ)ᵀ = L
    _k2_check(al, bl, a, sa, sb.T)
    launches = pdd.LAUNCHES
    dd.gemm_residual(a, L, L.T, bits=32)
    torch.cuda.synchronize()
    assert pdd.LAUNCHES == launches + 1


@pytest.mark.parametrize("m,kk,n,tile", [(700, 1024, 300, 128),
                                         (5, 100, 3, 32),
                                         (1030, 520, 770, 64)])
def test_qgemm_on_card_matches_the_cpu(card, m, kk, n, tile):
    """The block-scaled int8 GEMM: quantization and every int32 block
    product the same bits on the card as on the CPU; the f32 dequantized
    sum within 1e-6·max|C| (each pass is one IEEE multiply or add on
    both, so it is bitwise too unless a device contracts them)."""
    from dplasma_tpu_torch.kernels import quant
    rng = torch.Generator().manual_seed(m + n)
    a = torch.randn(m, kk, generator=rng) * 3.0
    b = torch.randn(kk, n, generator=rng)
    qa, sa = quant.quantize(a.to(card), tile)
    qa0, sa0 = quant.quantize(a, tile)
    assert torch.equal(qa.cpu(), qa0) and torch.equal(sa.cpu(), sa0)
    qb, _ = quant.quantize(b.T.to(card), tile)
    p = dd._imm(qa[:, :tile], qb[:, :tile].T)
    assert torch.equal(p.cpu(), dd._imm(qa0[:, :tile],
                                        quant.quantize(b.T, tile)[0][
                                            :, :tile].T))
    got = quant.qgemm(a.to(card), b.to(card), tile)
    want = quant.qgemm(a, b, tile)
    assert got.shape == (m, n) and got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= \
        1e-6 * float(want.abs().max())


def test_posv_ir_f32_on_card_converges_through_k2(card):
    """posv_ir at the f32 rung, N=1024: converged without escalation,
    every residual one fused K2 launch (none unfused), and the -x check
    of the solution."""
    from dplasma_tpu_torch.ops import checks, generators, refine
    A = generators.plghe(1024.0, 1024, 256, seed=3, dtype=torch.float64)
    B = generators.plrnt(1024, 4, 256, 256, seed=4, dtype=torch.float64)
    launches, unfused = pdd.LAUNCHES, pdd.UNFUSED
    X, info = refine.posv_ir(A, B, precision="f32")
    torch.cuda.synchronize()
    s = refine.summarize(info, op="posv_ir", precision="f32")
    assert s["converged"] and not s["escalated"]
    assert X.device.type == "cuda" and X.dtype == torch.float64
    assert pdd.LAUNCHES - launches == len(s["backward_errors"])
    assert pdd.UNFUSED == unfused
    r, ok = checks.check_solve(A, B, X, uplo="L")
    assert ok, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("chunks", [1, 4])
def test_k5_bcast_matches_plain_version_bitwise(card, dtype, n, chunks):
    g = torch.Generator(device=card).manual_seed(50 + n)
    for root in range(n):
        xs = [torch.randn(1000, 300, device=card, generator=g).to(dtype)
              for _ in range(n)]
        launches = pring.LAUNCHES
        got = pring.ring_bcast(xs, root=root, chunks=chunks)
        torch.cuda.synchronize()
        assert pring.LAUNCHES == launches + 1
        want = pring.ring_bcast_reference(xs, root, chunks)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k5_bcast_strided_panel_and_many_launches(card):
    """A column slice of a row-major slab (row stride 4096), and 300
    launches on one flag buffer, each checked."""
    g = torch.Generator(device=card).manual_seed(60)
    slab = torch.randn(4096, 4096, device=card, generator=g)
    xs = [slab[:, 512:1024], torch.empty(4096, 512, device=card)]
    want = slab[:, 512:1024].contiguous()
    for i in range(300):
        got = pring.ring_bcast(xs, root=0, chunks=4)
        assert all(torch.equal(o, want) for o in got), i


def test_k5_1000_back_to_back_launches_with_a_strided_root(card):
    """The main path's broadcast (a column slice of a slab as the root,
    4 chunks) and shift, 1000 launches each on one flag buffer, each
    checked bitwise."""
    g = torch.Generator(device=card).manual_seed(61)
    slab = torch.randn(4096, 4096, device=card, generator=g)
    other = torch.empty(4096, 512, device=card)
    want = slab[:, 512:1024].contiguous()
    for i in range(1000):
        root = i % 2
        xs = [slab[:, 512:1024] if q == root else other for q in range(2)]
        got = pring.ring_bcast(xs, root=root, chunks=4)
        assert all(torch.equal(o, want) for o in got), i
    cur = [torch.randn(512, 4096, device=card, generator=g)
           for _ in range(2)]
    for i in range(1000):
        nxt = pring.ring_shift(cur)
        assert all(torch.equal(nxt[(r + 1) % 2], cur[r])
                   for r in range(2)), i
        cur = nxt


@pytest.mark.parametrize("n", [2, 3, 4])
def test_k5_shift_matches_plain_version_bitwise(card, n):
    g = torch.Generator(device=card).manual_seed(70 + n)
    xs = [torch.randn(512, 4096, device=card, generator=g)
          for _ in range(n)]
    for _ in range(20):
        got = pring.ring_shift(xs)
        want = pring.ring_shift_reference(xs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        xs = got


@pytest.mark.parametrize("op", ["potrf", "getrf", "geqrf"])
def test_cyclic_ring_route_equals_psum_route_on_card(card, op):
    """2x2 grid on the card, f32: ring.enable=on launches K5 (KT per
    process row for the broadcasts, KT·Q·(P−1) LU shifts) and gives
    torch.equal factors (and perm, or geqrf's T stack) to
    ring.enable=off."""
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg
    N, nb = 1024, 128
    A = (generators.plghe(float(N), N, nb, seed=9) if op == "potrf"
         else generators.plrnt(N, N, nb, nb, seed=9))
    res, launches = {}, {}
    with mesh.use_grid(mesh.make_mesh(2, 2)):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=2, Q=2))
        for mode in ("off", "on"):
            with cfg.override_scope({"ring.enable": mode}):
                before = pring.LAUNCHES
                res[mode] = (cyclic.potrf_cyclic(C), None) \
                    if op == "potrf" else cyclic.geqrf_cyclic(C) \
                    if op == "geqrf" else cyclic.getrf_cyclic(C)
                torch.cuda.synchronize()
                launches[mode] = pring.LAUNCHES - before
    KT = N // nb
    assert launches["off"] == 0
    assert launches["on"] == 2 * KT + (KT * 2 * 1 if op == "getrf" else 0)
    (F0, p0), (F1, p1) = res["off"], res["on"]
    for r0, r1 in zip(F0.data, F1.data):
        assert all(torch.equal(a, b) for a, b in zip(r0, r1))
    if op != "potrf":
        assert torch.equal(p0, p1)


@pytest.mark.parametrize("lookahead", [0, 1])
def test_geqrf_cyclic_on_card_ring_psum_and_the_cpu(card, k1_on, lookahead):
    """geqrf_cyclic on a 2x2 grid at N=1024, nb=256, f32 with K1 on: the
    K5 ring route torch.equal to the psum route (factor and T stack),
    and within f32 tolerance of the CPU's plain route: against the
    float64 factor of the same input, the card's error (packed factor
    and T stack, max norm) at most 4x the CPU f32 route's — the
    CholeskyQR2 + TSQR-HR panel carries its products' rounding by the
    panels' condition (the CPU's own T is ~3e-3 off float64 here), and
    the 3xTF32 products round as often as f32 ones, in another order;
    |A - QR| passes the reference's check."""
    from dplasma_tpu_torch.descriptors import Dist, TileMatrix
    from dplasma_tpu_torch.ops import checks, generators, qr
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg
    N, nb = 1024, 256
    A = generators.plrnt(N, N, nb, nb, seed=21)
    res = {}
    for dev, mode, dt in (("cuda", "off", torch.float32),
                          ("cuda", "on", torch.float32),
                          ("cpu", "off", torch.float32),
                          ("cpu", "off", torch.float64)):
        Ad = A if dev == "cuda" else generators.plrnt(
            N, N, nb, nb, seed=21, device="cpu", dtype=dt)
        with mesh.use_grid(mesh.make_mesh(2, 2, dev)), \
                cfg.override_scope({"ring.enable": mode,
                                    "sweep.lookahead": lookahead}):
            C = cyclic.CyclicMatrix.from_tile(Ad, Dist(P=2, Q=2))
            before = pring.BCAST_LAUNCHES
            F, T = cyclic.geqrf_cyclic(C)
            if dev == "cuda":
                torch.cuda.synchronize()
                assert pring.BCAST_LAUNCHES - before == \
                    (2 * N // nb if mode == "on" else 0)
            res[dev, mode, dt] = (F, T)
    (F0, T0), (F1, T1) = (res["cuda", "off", torch.float32],
                          res["cuda", "on", torch.float32])
    assert torch.equal(T0, T1)
    for r0, r1 in zip(F0.data, F1.data):
        assert all(torch.equal(a, b) for a, b in zip(r0, r1))
    Fc, Tc = res["cpu", "off", torch.float32]
    F64, T64 = res["cpu", "off", torch.float64]

    def err(F, T):
        p = F.to_tile().data.cpu().double()
        return (float((p - F64.to_tile().data).abs().max()),
                float((T.cpu().double() - T64).abs().max()))
    card, cpu = err(F1, T1), err(Fc, Tc)
    assert card[0] <= 4 * cpu[0] and card[1] <= 4 * cpu[1], (card, cpu)
    packed = F1.to_tile()
    Tf = cyclic.qr_t_factor(T1, A)
    eye = torch.eye(N, device="cuda")
    Q = qr.unmqr("L", "N", packed, Tf,
                 TileMatrix.from_dense(eye, nb, nb)).to_dense()
    r, ok = checks.check_qr(A, Q, torch.triu(packed.to_dense()))
    assert ok, r


def test_summa_k1_launches_are_tensor_core_launches(card, k1_on):
    """gemm_ex under a 2x2 grid at M=N=K=2048, nb=256 runs SUMMA:
    lcm(2, 2)·2 = 4 broadcast steps a rank, each one K1 launch on the
    tensor-core kernel (none on FFMA), within 1e-5 of blas3.gemm."""
    from dplasma_tpu_torch.ops import blas3, gemm, generators
    from dplasma_tpu_torch.parallel import mesh
    A = generators.plrnt(2048, 2048, 256, 256, seed=1)
    B = generators.plrnt(2048, 2048, 256, 256, seed=2)
    C = generators.plrnt(2048, 2048, 256, 256, seed=3)
    pk.reset_counts()
    with mesh.use_grid(mesh.make_mesh(2, 2)):
        assert gemm.plan_gemm(C, A, B).algo == "summa"
        got = gemm.gemm_ex(0.5, A, B, 2.0, C)
        torch.cuda.synchronize()
    assert (pk.LAUNCHES, pk.WGMMA_LAUNCHES, pk.FFMA_LAUNCHES) == (16, 16, 0)
    want = blas3.gemm(0.5, A, B, 2.0, C)
    assert _rel(got.data, want.data) <= 1e-5


def test_heev_cyclic_on_card_takes_kw_and_kt(card, k1_on):
    """heev_cyclic on a 2x2 grid at N=1024, nb=256: herbt on the slabs
    (its ten products a rank and step and R2·R1 a process column on
    K1), then the band's SBR chain on one device with KW once a sweep of
    b <= 128 (herm 64, 16, 4) over all its steps and KT once; the
    spectrum within the drivers' -x gate of the dense solver's."""
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.kernels import sbr, tridiag
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.parallel import cyclic, mesh
    n, nb = 1024, 256
    (hl, hs), _ = _eig_kw_counts(n, nb)
    A = generators.plghe(0.0, n, nb, seed=3)
    with mesh.use_grid(mesh.make_mesh(2, 2)):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=2, Q=2))
        pk.reset_counts()
        before = (sbr.LAUNCHES, sbr.STEPS, tridiag.LAUNCHES)
        w = cyclic.heev_cyclic(C)
        torch.cuda.synchronize()
    assert (sbr.LAUNCHES - before[0], sbr.STEPS - before[1],
            tridiag.LAUNCHES - before[2]) == (hl, hs, 1)
    assert pk.FFMA_LAUNCHES == 0 and pk.LAUNCHES >= (n // nb - 1) * 42
    ref = torch.linalg.eigvalsh(A.to_dense().double())
    eps = torch.finfo(torch.float32).eps
    assert float((w.double() - ref).abs().max() / ref.abs().max()) < \
        60 * eps * n


def _record_k1(monkeypatch, rows):
    """Hold every K1 product, as it launches, against gemm_reference
    and a float64 product: (shapes, strides, kernel, ok). A product
    passes within 1e-5 of gemm_reference or, where the two f32
    summation orders differ more (a triangular factor with an N-sized
    diagonal: the small terms fall below the diagonal's f32 spacing, so
    the order decides which are lost), with an error against float64
    no worse than twice torch.matmul's, phase 2's yardstick."""
    orig = pk.gemm

    def spy(a, b, c=None, **kw):
        out = orig(a, b, c, **kw)
        ok = _rel(out, pk.gemm_reference(a, b, c, **kw)) <= 1e-5
        if not ok:
            exact = a.double() @ b.double()
            ok = _rel(out, exact) <= 2 * _rel(torch.matmul(a, b), exact)
        rows.append((tuple(a.shape), tuple(b.shape), a.stride(), b.stride(),
                     pk.plan_for(a, b).kernel, ok))
        return out

    monkeypatch.setattr(pk, "gemm", spy)


@pytest.mark.parametrize("op,want", [("trtri", 2 * 7), ("lauum", 1),
                                     ("poinv", 13 + 2 * 7 + 1),
                                     ("syrk", 1), ("syr2k", 2)])
def test_inverse_family_and_syrk_products_on_k1(card, k1_on, monkeypatch,
                                                op, want):
    """N=2048, nb=256 (KT = 8): trtri 2·(KT − 1) products, lauum 1,
    poinv potrf's 2·KT − 3 more, syrk 1 (A·Aᵀ from one buffer), syr2k
    2; each on the tensor-core kernel and held as ``_record_k1`` says,
    and the result within 1e-4 of the CPU's."""
    from dplasma_tpu_torch.ops import blas3, generators, potrf
    n, nb = 2048, 256
    calls = {
        "trtri": lambda dev: potrf.trtri(
            generators.plghe(float(n), n, nb, seed=3, device=dev), "L"),
        "lauum": lambda dev: potrf.lauum(
            generators.plghe(float(n), n, nb, seed=3, device=dev), "L"),
        "poinv": lambda dev: potrf.poinv(
            generators.plghe(float(n), n, nb, seed=3, device=dev), "L"),
        "syrk": lambda dev: blas3.syrk(
            0.7, generators.plrnt(n, 1024, nb, nb, seed=4, device=dev),
            0.3, generators.plghe(float(n), n, nb, seed=5, device=dev)),
        "syr2k": lambda dev: blas3.syr2k(
            0.7, generators.plrnt(n, 1024, nb, nb, seed=4, device=dev),
            generators.plrnt(n, 1024, nb, nb, seed=6, device=dev),
            0.3, generators.plghe(float(n), n, nb, seed=5, device=dev))}
    rows = []
    _record_k1(monkeypatch, rows)
    launches = pk.LAUNCHES
    got = calls[op](None)
    torch.cuda.synchronize()
    assert pk.LAUNCHES - launches == want == len(rows)
    bad = [r for r in rows if r[4] != "wgmma" or not r[5]]
    assert not bad, bad
    if op in ("lauum", "syrk"):
        # one operand a transposed view of the other's buffer
        assert any(1 in (sa[0], sb[0]) for _, _, sa, sb, *_ in rows)
    want_cpu = calls[op]("cpu")
    scale = float(want_cpu.data.abs().max())
    assert float((got.data.cpu() - want_cpu.data).abs().max()) \
        <= 1e-4 * scale


def test_dd_poinv_products_on_k2_bitwise(card, k1_on, monkeypatch):
    """poinv at N=2048, nb=512 under dd_gemm=always: potrf's 5·4 − 3 =
    17, trtri's 2·3 products and 4·4 Newton products, lauum's 1; every
    launch bitwise equal to limb_product_base_reference on its own
    operands; no K1, none unfused; the inverse passes check_inverse."""
    from dplasma_tpu_torch.ops import checks, generators, potrf
    from dplasma_tpu_torch.utils import config as cfg
    orig = pdd.limb_product_base
    same = []

    def spy(al, bl, base, sa, sb, w):
        out = orig(al, bl, base, sa, sb, w)
        want = pdd.limb_product_base_reference(al, bl, base, sa, sb, w)
        same.append(torch.equal(out.view(torch.int64),
                                want.view(torch.int64)))
        return out

    monkeypatch.setattr(pdd, "limb_product_base", spy)
    A = generators.plghe(2048.0, 2048, 512, seed=3, dtype=torch.float64)
    k1, k2, unfused = pk.LAUNCHES, pdd.LAUNCHES, pdd.UNFUSED
    with cfg.override_scope({"dd_gemm": "always"}):
        Ai = potrf.poinv(A, "L")
        torch.cuda.synchronize()
        assert (pk.LAUNCHES - k1, pdd.LAUNCHES - k2) == (0, 17 + 22 + 1)
        assert pdd.UNFUSED == unfused and len(same) == 40 and all(same)
        r, ok = checks.check_inverse(A, Ai, uplo="L")
    assert ok, r


# ---------------------------------------------------------------------
# the complex dtypes and the rest of the pivoted-LU family
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("seed", [3872, 2**32 - 1])
def test_complex_generators_on_card_match_the_cpu_bitwise(card, dtype,
                                                          seed):
    from dplasma_tpu_torch.ops import generators
    for gen in (lambda dev: generators.plrnt(301, 290, 64, 64, seed=seed,
                                             dtype=dtype, diagdom=True,
                                             device=dev),
                lambda dev: generators.plghe(290.0, 290, 64, seed=seed,
                                             dtype=dtype, device=dev),
                lambda dev: generators.plgsy(290.0, 290, 64, seed=seed,
                                             dtype=dtype, device=dev)):
        got, want = gen(card).data.cpu(), gen("cpu").data
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))


def _record_k2(monkeypatch, rows):
    """Hold every K2 launch, as it happens, bitwise against
    limb_product_base_reference on its own operands: (K, bitwise)."""
    orig = pdd.limb_product_base

    def spy(al, bl, base, sa, sb, w):
        out = orig(al, bl, base, sa, sb, w)
        want = pdd.limb_product_base_reference(al, bl, base, sa, sb, w)
        rows.append((al.shape[2], torch.equal(out.view(torch.int64),
                                              want.view(torch.int64))))
        return out

    monkeypatch.setattr(pdd, "limb_product_base", spy)


@pytest.mark.parametrize("M,K,N", [(300, 200, 100), (512, 1024, 512)])
def test_k2_complex_mm_matches_the_cpu_bitwise(card, monkeypatch, M, K, N):
    """A complex dd product is two 2K-deep limb products, each one K2
    launch bitwise equal to its plain version, and, the whole product
    being exact, the card's bits are the CPU's; a ``.mH`` operand
    included."""
    g = torch.Generator().manual_seed(K)
    a = torch.randn(M, K, generator=g, dtype=torch.complex128)
    bt = torch.randn(N, K, generator=g, dtype=torch.complex128)
    rows = []
    _record_k2(monkeypatch, rows)
    launches = pdd.LAUNCHES
    got = dd.mm(a.to(card), bt.to(card).mH)
    torch.cuda.synchronize()
    assert pdd.LAUNCHES - launches == 2
    assert rows == [(2 * K, True), (2 * K, True)]
    want = dd.mm(a, bt.mH)
    assert torch.equal(torch.view_as_real(got.cpu()),
                       torch.view_as_real(want))


def test_zpotrf_dd_on_card_routes_every_product(card, monkeypatch):
    """zpotrf at N=1024, nb=256 (nt = 4) under dd_gemm=always: the tile
    sweep, 46·nt − 16 = 168 K2 launches (per tile potrf_f64's 16 complex
    products, per panel trsm_f64's 5, 2·nt − 3 updates, two limb products
    each), each bitwise; no K1, none unfused; -x's check passes."""
    from dplasma_tpu_torch.ops import checks, generators, potrf
    from dplasma_tpu_torch.utils import config as cfg
    A = generators.plghe(1024.0, 1024, 256, seed=3,
                         dtype=torch.complex128)
    rows = []
    _record_k2(monkeypatch, rows)
    k1, k2, unfused = pk.LAUNCHES, pdd.LAUNCHES, pdd.UNFUSED
    with cfg.override_scope({"dd_gemm": "always"}):
        L = potrf.potrf(A, "L")
        torch.cuda.synchronize()
        assert (pk.LAUNCHES - k1, pdd.LAUNCHES - k2) == (0, 168)
        assert pdd.UNFUSED == unfused and all(ok for _, ok in rows)
        r, ok = checks.check_potrf(A, L, "L")
    assert ok, r
    L64 = torch.linalg.cholesky(A.to_dense().cpu())
    err = (L.to_dense().cpu() - L64).abs().max() / L64.abs().max()
    assert float(err) <= 1e-11


@pytest.mark.parametrize("op,want", [("getrf_incpiv", 28),
                                     ("getrs_incpiv", 28 + 7),
                                     ("getrf_qrf", 8 + 3 * 7)])
def test_incpiv_and_qrf_products_on_k1(card, k1_on, monkeypatch, op, want):
    """N=2048, nb=256 (KT = 8): getrf_incpiv's KT·(KT − 1)/2 couple
    products, getrs_incpiv as many and its upper solve's KT − 1,
    getrf_qrf (higham_sum: every panel QR on this random matrix) one
    larft Gram per panel and three per apply, getrs_qrf three per panel
    and the upper solve's KT − 1; each on the tensor-core
    kernel and held as ``_record_k1`` says; the solve passes -x's
    check."""
    from dplasma_tpu_torch.ops import checks, generators, lu
    n, nb = 2048, 256
    A = generators.plrnt(n, n, nb, nb, seed=3)
    B = generators.plrnt(n, 4, nb, nb, seed=4)
    F = lu.getrf_incpiv(A) if op == "getrs_incpiv" else None
    rows = []
    _record_k1(monkeypatch, rows)
    launches = pk.LAUNCHES
    if op == "getrf_incpiv":
        LU, Lc, piv = lu.getrf_incpiv(A)
        X = lu.getrs_incpiv(LU, Lc, piv, B)
        want_run = want + 28 + 7
    elif op == "getrs_incpiv":
        X = lu.getrs_incpiv(*F, B)
        want_run = want
    else:
        LU, Tm, tab = lu.getrf_qrf(A)
        assert tab.tolist() == [0] * 8
        X = lu.getrs_qrf(LU, Tm, tab, B)
        want_run = want + 3 * 8 + 7
    torch.cuda.synchronize()
    assert pk.LAUNCHES - launches == want_run == len(rows)
    bad = [r for r in rows if r[4] != "wgmma" or not r[5]]
    assert not bad, bad
    r, ok = checks.check_axmb(A, B, X)
    assert ok, r


# ---------------------------------------------------------------------
# the hierarchical QR trees and the LDLᴴ / butterfly solvers
# ---------------------------------------------------------------------

def _hqr_counts(tree, kt):
    """(geqrf_param, unmqr_param) products at KT = kt: a larft Gram per
    leader and per couple, 3 per apply on a trailing slab; 3 per
    operation of an apply."""
    ops = [len(tree.leaders(k)) + len(tree.schedule(k)) for k in range(kt)]
    return (sum(n * (4 if k < kt - 1 else 1) for k, n in enumerate(ops)),
            3 * sum(ops))


@pytest.mark.parametrize("llvl,a", [("greedy", 1), ("binary", 2)])
def test_hqr_and_hetrf_products_on_k1(card, k1_on, monkeypatch, llvl, a):
    """N=2048, nb=256 (MT = 8): geqrf_param and unmqr_param launch K1
    on every product ops/hqr.py counts, hetrf its KT − 1 HEDRK
    products; each on the tensor-core kernel within 1e-5 of
    gemm_reference; R, Q·C and the LDLᴴ factor within 1e-4 of the
    CPU's. The T factors are not compared entry by entry: the T of a
    short reflector is ill-conditioned (the CPU's own f32 and f64 runs
    part by 4.9e-4 there, against 6e-6 for Q·C)."""
    from dplasma_tpu_torch.ops import generators, hqr, ldl
    n, nb = 2048, 256
    tree = hqr.hqr_tree(8, llvl=llvl, a=a)
    want_f, want_q = _hqr_counts(tree, 8)
    rows = []
    orig = pk.gemm

    def spy(a_, b_, c=None, **kw):
        out = orig(a_, b_, c, **kw)
        rows.append((tuple(a_.shape), tuple(b_.shape),
                     pk.plan_for(a_, b_).kernel,
                     _rel(out, pk.gemm_reference(a_, b_, c, **kw))))
        return out

    monkeypatch.setattr(pk, "gemm", spy)

    def run(dev):
        A = generators.plrnt(n, n, nb, nb, seed=3, device=dev)
        C = generators.plrnt(n, 512, nb, nb, seed=4, device=dev)
        H = generators.plghe(float(n), n, nb, seed=5, device=dev)
        F = hqr.geqrf_param(tree, A)
        return F, hqr.unmqr_param(tree, "L", "N", *F, C), ldl.hetrf(H)

    launches = pk.LAUNCHES
    got = run(None)
    torch.cuda.synchronize()
    assert pk.LAUNCHES - launches == want_f + want_q + 7 == len(rows)
    bad = [r for r in rows if r[2] != "wgmma" or r[3] > 1e-5]
    assert not bad, bad
    want = run("cpu")
    for g, w in ((torch.triu(got[0][0].data), torch.triu(want[0][0].data)),
                 (got[1].data, want[1].data), (got[2].data, want[2].data)):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale


def test_dd_hqr_and_hetrf_products_on_k2_bitwise(card, k1_on, monkeypatch):
    """N=1024, nb=256 under dd_gemm=always: geqrf_param's 61 limb
    products (MT = 4, the greedy a = 1 tree) and hetrf's 3·(KT − 1) = 9,
    each K2 launch bitwise equal to its plain version; no K1, none
    unfused; both within 1e-12 of the CPU's dd run."""
    from dplasma_tpu_torch.ops import generators, hqr, ldl
    from dplasma_tpu_torch.utils import config as cfg
    tree = hqr.hqr_tree(4, a=1)
    rows = []
    _record_k2(monkeypatch, rows)

    def run(dev):
        A = generators.plrnt(1024, 1024, 256, 256, seed=3,
                             dtype=torch.float64, device=dev)
        H = generators.plghe(1024.0, 1024, 256, seed=5,
                             dtype=torch.float64, device=dev)
        return (*hqr.geqrf_param(tree, A), ldl.hetrf(H))

    k1, k2, unfused = pk.LAUNCHES, pdd.LAUNCHES, pdd.UNFUSED
    with cfg.override_scope({"dd_gemm": "always"}):
        got = run(None)
        torch.cuda.synchronize()
        assert (pk.LAUNCHES - k1, pdd.LAUNCHES - k2) == (0, 61 + 9)
        assert pdd.UNFUSED == unfused and len(rows) == 70
        assert all(ok for _, ok in rows)
        want = run("cpu")
    for g, w in zip(got, want):
        scale = float(w.data.abs().max())
        assert float((g.data.cpu() - w.data).abs().max()) <= 1e-12 * scale


# ------------------------------------------------------- KT and KW

def _kt_cases():
    g = torch.Generator().manual_seed(11)
    m = 10
    return {"random": (torch.randn(700, generator=g),
                       torch.randn(699, generator=g)),
            "wilkinson": (torch.arange(-m, m + 1).abs().double(),
                          torch.ones(2 * m)),
            "zero_diag": (torch.zeros(301), torch.rand(300, generator=g)),
            "n2": (torch.tensor([1.0, -3.0]), torch.tensor([0.75])),
            "random2048": (torch.randn(2048, generator=g),
                           torch.randn(2047, generator=g))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["random", "wilkinson", "zero_diag", "n2",
                                  "random2048"])
def test_kt_matches_plain_version(card, dtype, case):
    from dplasma_tpu_torch.kernels import tridiag
    d, e = (x.to(dtype).to(card) for x in _kt_cases()[case])
    n = tridiag.LAUNCHES
    got = tridiag.eigh_tridiagonal(d, e)
    torch.cuda.synchronize()
    assert tridiag.LAUNCHES == n + 1
    want = tridiag.eigh_tridiagonal_reference(d, e)
    a = e.abs().double()
    row = torch.cat([a[:1], a[:-1] + a[1:], a[-1:]])
    tn = float(torch.maximum((d.double() + row).abs().max(),
                             (d.double() - row).abs().max()))
    assert float((got - want).abs().max()) <= 2 * torch.finfo(dtype).eps * tn
    assert torch.equal(got, want)
    assert bool((got[1:] >= got[:-1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["random", "zero_diag", "jordan_wielandt"])
def test_kt_targets_are_the_full_launch_at_their_indices(card, monkeypatch,
                                                         dtype, case):
    """One launch a call with targets too, each value the full launch's
    bits at its index; gesvd's K targets (the Jordan–Wielandt
    tridiagonal of a 300×200 bidiagonal: zero diagonal of length 401,
    off-diagonal [d1, e1, ...]) give the full launch's top K."""
    from dplasma_tpu_torch.kernels import tridiag
    from dplasma_tpu_torch.ops import eig, generators
    if case == "jordan_wielandt":
        G = generators.plrnt(300, 200, 64, 64, seed=5, dtype=dtype)
        bd, be = eig.gebrd(G)
        e = torch.zeros(bd.shape[0] + be.shape[0], dtype=dtype, device=card)
        e[0::2], e[1::2] = bd, be
        d = torch.zeros(e.shape[0] + 1, dtype=dtype, device=card)
    else:
        d, e = (x.to(dtype).to(card) for x in _kt_cases()[case])
    n = d.shape[0]
    full = tridiag.eigh_tridiagonal(d, e)
    k = torch.tensor([n - 1, 0, n // 2, n // 2 - 1, 7, n - 1],
                     dtype=torch.int32, device=card)
    before = tridiag.LAUNCHES
    got = tridiag.eigh_tridiagonal(d, e, targets=k)
    torch.cuda.synchronize()
    assert tridiag.LAUNCHES == before + 1
    assert torch.equal(got, full[k.long()])
    top = torch.arange(n // 2 + 1, n, dtype=torch.int32, device=card)
    assert torch.equal(tridiag.eigh_tridiagonal(d, e, targets=top),
                       full[n // 2 + 1:])
    if case == "jordan_wielandt":
        monkeypatch.setattr(eig, "gebrd", lambda A: (bd, be))
        before = tridiag.LAUNCHES
        s = eig.gesvd(G)
        assert tridiag.LAUNCHES == before + 1
        assert torch.equal(s, torch.flip(full, (0,))[:200])
    # an index outside [0, n) launches nothing and raises
    before = tridiag.LAUNCHES
    for bad in ([-1], [0, n]):
        with pytest.raises(ValueError):
            tridiag.eigh_tridiagonal(
                d, e, targets=torch.tensor(bad, device=card))
    assert tridiag.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kt_every_plan_gives_the_same_bits(card, dtype):
    """Flat (depth 0), shallow and deep top trees, rounds of 1 to 5
    levels, resident or streamed pairs: the same bits at every index."""
    from dplasma_tpu_torch.kernels import tridiag
    d, e = (x.to(dtype).to(card) for x in _kt_cases()["random"])
    want = tridiag.eigh_tridiagonal(d, e)
    P = tridiag.Plan
    for pl in (P(0, 1, True), P(0, 4, False), P(3, 2, True),
               P(10, 5, True), P(11, 3, False), P(16, 4, False),
               P(tridiag.MAX_DEPTH, 5, True)):
        got = tridiag._launch(d, e, None, pl)
        assert torch.equal(got, want), pl


def test_kt_streamed_pairs_above_shared_memory(card):
    """n = 40000 f32 (its 320 KB of pairs streamed through shared memory
    in chunks): held against the plain version on the host at sampled
    indices, and the targets launch at those indices the same bits."""
    from dplasma_tpu_torch.kernels import tridiag
    n = 40000
    assert not tridiag.plan(n, n, torch.float32).resident
    g = torch.Generator().manual_seed(12)
    d, e = torch.randn(n, generator=g), torch.randn(n - 1, generator=g)
    before = tridiag.LAUNCHES
    got = tridiag.eigh_tridiagonal(d.to(card), e.to(card))
    torch.cuda.synchronize()
    assert tridiag.LAUNCHES == before + 1
    k = torch.tensor([0, 1, 9999, n // 2, 31234, n - 2, n - 1],
                     dtype=torch.int32)
    want = tridiag.eigh_tridiagonal_reference(d, e, targets=k)
    assert torch.equal(got.cpu()[k.long()], want)
    assert torch.equal(tridiag.eigh_tridiagonal(d.to(card), e.to(card),
                                                targets=k.to(card)).cpu(),
                       want)
    assert bool((got[1:] >= got[:-1]).all())


def _kw_check(got, plain, wide_plain, dtype, ratios):
    """f64/c128: KW within 1e-11 of the plain step. f32/c64: finite, and
    KW's distance to the step in twice the precision over the plain
    version's kept for the median over the sweep (a step whose block is
    close to rank-deficient sends both f32 routes far from the wide step,
    so no per-step bound)."""
    if wide_plain is None:
        assert float((got - plain).abs().max()) <= \
            1e-11 * float(plain.abs().max())
        return
    assert bool(torch.isfinite(got).all())
    scale = float(wide_plain.abs().max())
    e_kw = float((got.to(wide_plain.dtype) - wide_plain).abs().max())
    e_pl = float((plain.to(wide_plain.dtype) - wide_plain).abs().max())
    ratios.append(e_kw / max(e_pl, torch.finfo(dtype).eps * scale))


def _median_ok(ratios):
    return not ratios or sorted(ratios)[len(ratios) // 2] <= 4.0


_WIDE = {torch.float32: torch.float64, torch.complex64: torch.complex128}


_ALL = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _herm_case(card, dtype, n, b, w, seed):
    """Random band storage of one Hermitian sweep's geometry, its
    geometry and device tables."""
    from dplasma_tpu_torch.kernels import sbr
    from dplasma_tpu_torch.ops import band
    base, us, T, G, S, V, L0, hi = band._sbr_banded_schedule(n, b, w)
    D = 2 * b + w
    H = 2 * D + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    F = torch.randn((L0 + max(hi, n) + S, H), dtype=dtype, device=card,
                    generator=g)
    geom = sbr.HermGeom(G, S, V, b, H, D)
    return F, T, geom, sbr.herm_tabs(base + L0, us, geom, card)


def _bidiag_case(card, dtype, m, n, b, w, seed):
    """A random m x n matrix padded for one bidiagonal sweep, its
    geometry and device tables."""
    from dplasma_tpu_torch.kernels import sbr
    from dplasma_tpu_torch.ops import band
    K = min(m, n)
    c0s, us, offs, T, G, V, park0 = band._sbr_schedule_bidiag(K, b, w, m < n)
    lim = park0 + G * V
    X = torch.zeros((max(lim, m), max(lim, n)), dtype=dtype, device=card)
    g = torch.Generator(device="cuda").manual_seed(seed)
    X[:m, :n] = torch.randn((m, n), dtype=dtype, device=card, generator=g)
    geom = sbr.BidiagGeom(G, V, b, X.shape[1])
    return X, T, geom, sbr.bidiag_tabs(c0s, us, offs, geom, card)


def _herm_replay(card, dtype, n, b, w):
    from dplasma_tpu_torch.kernels import sbr
    F, T, geom, tabs = _herm_case(card, dtype, n, b, w, b)
    ratios = []
    for t in range(T):
        bs = int(tabs.base[t])
        P = F.clone()
        sbr.herm_step_reference(P, bs, tabs.u[t], geom)
        W = None
        if dtype in _WIDE:
            W = F.to(_WIDE[dtype])
            sbr.herm_step_reference(W, bs, tabs.u[t], geom)
        sbr.herm_step(F, tabs, t, geom)
        _kw_check(F, P, W, dtype, ratios)
    assert _median_ok(ratios)


def _bidiag_replay(card, dtype, m, n, b, w):
    from dplasma_tpu_torch.kernels import sbr
    X, T, geom, tabs = _bidiag_case(card, dtype, m, n, b, w, m + n)
    ratios = []
    for t in range(T):
        qr = t % 2 == 1
        P = X.clone()
        sbr.bidiag_step_reference(P, tabs.c0[t], tabs.u[t], tabs.off[t],
                                  geom, qr)
        W = None
        if dtype in _WIDE:
            W = X.to(_WIDE[dtype])
            sbr.bidiag_step_reference(W, tabs.c0[t], tabs.u[t],
                                      tabs.off[t], geom, qr)
        sbr.bidiag_step(X, tabs, t, geom)
        _kw_check(X, P, W, dtype, ratios)
    assert _median_ok(ratios)


@pytest.mark.parametrize("dtype", _ALL)
@pytest.mark.parametrize("b,w", [(32, 8), (4, 1)])
def test_kw_herm_steps_match_plain_version(card, dtype, b, w):
    _herm_replay(card, dtype, 400, b, w)


@pytest.mark.parametrize("dtype", _ALL)
@pytest.mark.parametrize("m,n", [(300, 300), (300, 200), (200, 300)])
def test_kw_bidiag_steps_match_plain_version(card, dtype, m, n):
    _bidiag_replay(card, dtype, m, n, 31, 7)


@pytest.mark.parametrize("dtype", _ALL)
@pytest.mark.parametrize("n,b,w", [(600, 64, 16), (700, 127, 31),
                                   (400, 31, 7)])
def test_kw_wide_herm_steps_match_plain_version(card, dtype, n, b, w):
    """The 64-wide Hermitian sweep of heev's ladder (one block a window,
    213 KB in complex128) and the 127- and 31-wide ones of hbrdt's (the
    127-wide window one block of 416 threads, 218 KB, in f32; refused in
    the other types, which take the plain route), step by step against
    the plain version."""
    from dplasma_tpu_torch.kernels import sbr
    if not sbr.eligible(b, 3 * b + w, dtype, "herm"):
        assert b == 127 and dtype != torch.float32
        F, T, geom, tabs = _herm_case(card, dtype, n, b, w, b)
        with pytest.raises(ValueError, match="refuses"):
            sbr.herm_step(F, tabs, 0, geom)
        return
    _herm_replay(card, dtype, n, b, w)


@pytest.mark.parametrize("dtype", _ALL)
@pytest.mark.parametrize("m,n", [(700, 700), (700, 500)])
def test_kw_wide_bidiag_steps_match_plain_version(card, dtype, m, n):
    """The 127-wide bidiagonal sweep (one block in f32, a cluster of 2
    CTAs in f64 / c64 and of 4 in c128), step by step against the plain
    version."""
    _bidiag_replay(card, dtype, m, n, 127, 31)


#: heev's and gesvd's default ladders at nb = 256, and hbrdt's Hermitian
#: one from its 511-wide band
_LADDER = [("herm", 64, 16), ("herm", 16, 4), ("herm", 4, 1),
           ("bidiag", 127, 31), ("bidiag", 31, 7), ("bidiag", 7, 1),
           ("herm", 127, 31), ("herm", 31, 7), ("herm", 7, 1)]


@pytest.mark.parametrize("dtype", _ALL)
@pytest.mark.parametrize("kind,b,w", _LADDER)
def test_kw_sweep_launch_equals_step_launches(card, dtype, kind, b, w):
    """One launch over [0, T) of a default-ladder sweep is bitwise equal
    to T one-step launches (the grid barrier orders the steps; sums run
    in a fixed order), and the narrow sweeps' warp and block forms to
    each other. (The 127-wide Hermitian window runs in f32 only; the
    other types' whole-sweep launch is refused.)"""
    from dplasma_tpu_torch.kernels import sbr
    n = 700 if b > 32 else 300
    if kind == "herm":
        X, T, geom, tabs = _herm_case(card, dtype, n, b, w, 7 * b)
        steps, step = sbr.herm_steps, sbr.herm_step
    else:
        X, T, geom, tabs = _bidiag_case(card, dtype, n, n, b, w, 7 * b)
        steps, step = sbr.bidiag_steps, sbr.bidiag_step
    if not sbr.eligible(b, 3 * b + w, dtype, kind):
        assert (kind, b) == ("herm", 127) and dtype != torch.float32
        with pytest.raises(ValueError, match="refuses"):
            steps(X, tabs, 0, T, geom)
        return
    one, many = X.clone(), X.clone()
    launches = sbr.LAUNCHES
    for t in range(T):
        step(one, tabs, t, geom)
    steps(many, tabs, 0, T, geom)
    torch.cuda.synchronize()
    assert sbr.LAUNCHES - launches == T + 1
    assert torch.equal(one, many)
    if b <= sbr.WARP_MAX_B:
        for form in ("warp", "block"):
            other = X.clone()
            steps(other, tabs, 0, T, geom, form=form)
            assert torch.equal(other, many)


def test_kw_sweeps_on_two_streams_keep_their_own_barriers(card):
    """Two whole-sweep launches in flight at once on two streams (a
    Hermitian 16-wide and a bidiagonal 31-wide sweep) each end as they
    do alone: each launch has its own grid-barrier counter."""
    from dplasma_tpu_torch.kernels import sbr
    Xh, Th, gh, th = _herm_case(card, torch.float32, 300, 16, 4, 5)
    Xb, Tb, gb, tb = _bidiag_case(card, torch.float32, 300, 300, 31, 7, 6)
    want_h, want_b = Xh.clone(), Xb.clone()
    sbr.herm_steps(want_h, th, 0, Th, gh)
    sbr.bidiag_steps(want_b, tb, 0, Tb, gb)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        sbr.herm_steps(Xh, th, 0, Th, gh)
    with torch.cuda.stream(s2):
        sbr.bidiag_steps(Xb, tb, 0, Tb, gb)
    torch.cuda.synchronize()
    assert torch.equal(Xh, want_h) and torch.equal(Xb, want_b)


def _eig_kw_counts(n, nb):
    """(launches, steps) of KW in one heev 2stage and one gesvd at n, nb:
    one launch a sweep it takes, every step of the sweep."""
    from dplasma_tpu_torch.kernels import sbr
    from dplasma_tpu_torch.ops import band
    out = []
    for kind, b0 in (("herm", nb), ("bidiag", 2 * nb - 1)):
        launches = steps = 0
        for b, w in band.sweep_ladder(b0):
            if sbr.eligible(b, 3 * b + w, torch.float32, kind):
                launches += 1
                steps += (band._sbr_banded_schedule(n, b, w)[2]
                          if kind == "herm" else
                          band._sbr_schedule_bidiag(n, b, w, False)[3])
        out.append((launches, steps))
    return out


def test_eig_chain_on_card_launches_the_counted_kernels(card, k1_on):
    """shetrd / heev 2stage and sgesvd at N=1024, nb=256: KW once a
    sweep of b <= 128 (herm 64, 16, 4; bidiag 127, 31, 7) over all its
    steps, KT once per tridiagonal, K1 on herbt's and the first sweep's
    window products; spectra within the drivers' -x gates of the dense
    solver's."""
    from dplasma_tpu_torch.kernels import sbr, tridiag
    from dplasma_tpu_torch.ops import eig, generators
    n, nb = 1024, 256
    (hl, hs), (bl, bs) = _eig_kw_counts(n, nb)
    assert (hl, bl) == (3, 3)
    A = generators.plghe(0.0, n, nb, seed=3)
    before = (sbr.LAUNCHES, sbr.STEPS, tridiag.LAUNCHES)
    w_ = eig.heev(A, method="2stage")
    torch.cuda.synchronize()
    assert (sbr.LAUNCHES - before[0], sbr.STEPS - before[1],
            tridiag.LAUNCHES - before[2]) == (hl, hs, 1)
    ref = torch.linalg.eigvalsh(A.to_dense().double())
    eps = torch.finfo(torch.float32).eps
    assert float((w_.double() - ref).abs().max() / ref.abs().max()) < \
        60 * eps * n
    G = generators.plrnt(n, n, nb, nb, seed=4)
    before = (sbr.LAUNCHES, sbr.STEPS, tridiag.LAUNCHES)
    s = eig.gesvd(G)
    torch.cuda.synchronize()
    assert (sbr.LAUNCHES - before[0], sbr.STEPS - before[1],
            tridiag.LAUNCHES - before[2]) == (bl, bs, 1)
    ref = torch.linalg.svdvals(G.to_dense().double())
    assert float((s.double() - ref).abs().max() / ref.max()) < \
        60 * eps * n


# -- the out-of-HBM tiers, the streamed GEMM and the DTD path ------------

def _lowmem_inputs(kind, n):
    import numpy as np
    g = np.random.default_rng(7).standard_normal((n, n))
    if kind == "potrf":
        return (g @ g.T / n + 4.0 * np.eye(n)).astype(np.float32)
    return g.astype(np.float32)


def _lowmem_call(kind, a, device="cuda"):
    from dplasma_tpu_torch.ops import lu, potrf, qr
    if kind == "potrf":
        return (potrf.potrf_lowmem(a, budget_bytes=a.nbytes // 4,
                                   device=device),)
    if kind == "getrf":
        LU, perm = lu.getrf_lowmem(a, nb=256,
                                   budget_bytes=3 * a.shape[0] * 512 * 4,
                                   device=device)
        return LU, perm.cpu().numpy()
    return qr.geqrf_lowmem(a, nb=256, budget_bytes=3 * a.shape[0] * 256 * 4,
                           device=device)


@pytest.mark.parametrize("kind,n", [("potrf", 4096), ("getrf", 4096),
                                    ("geqrf", 2048)])
def test_lowmem_tier_on_the_card_within_its_budget(card, k1_on, kind, n):
    """Each tier at a small N on the card (the default device): its
    result within 1e-4 of the same schedule on the CPU (the LU by its
    residual A[perm] = L U < 60), one K1 launch per
    streamed update (potrf) / apply (getrf) / three per apply and one
    per panel (geqrf), and its peak device memory logged beside the
    budget and within 16 MiB over it: the budget counts the panels, the
    chunk and the update temporaries, not cuSOLVER's and K1's split-K
    workspaces, a few MiB that weigh at this N (geqrf 2048: 13.9 MB
    against 6.3) and not at the sizes the tiers are for (chip_smoke
    phase 17: under the budget)."""
    import numpy as np
    from dplasma_tpu_torch.kernels import hostlink
    a = _lowmem_inputs(kind, n)
    budget = {"potrf": a.nbytes // 4, "getrf": 3 * n * 512 * 4,
              "geqrf": 3 * n * 256 * 4}[kind]
    # the libraries' handles and their one-time workspaces (cuBLAS keeps
    # 32 MiB per stream) come before the measurement
    _lowmem_call(kind, _lowmem_inputs(kind, 1024))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hostlink.reset_stats()
    before = pk.LAUNCHES
    got = _lowmem_call(kind, a)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = pk.LAUNCHES - before
    print(f"[lowmem] {kind} N={n}: peak {peak} B, budget {budget} B "
          f"({peak / budget:.3f}x), K1 {launches}, h2d "
          f"{hostlink.STATS.h2d_bytes} B, d2h {hostlink.STATS.d2h_bytes} B")
    if kind == "getrf":
        # LU of a random f32 matrix: the factors of two devices may part
        # by kappa·u (and by a pivot), so the card's is held by A[p] = LU
        LU, p = got
        L = np.tril(LU, -1) + np.eye(n, dtype=np.float32)
        r = np.abs(a[p] - L @ np.triu(LU)).max() / (
            np.abs(a).max() * n * np.finfo(np.float32).eps)
        assert r < 60, r
    else:
        want = _lowmem_call(kind, a, device="cpu")
        for g_, w_ in zip(got, want):
            assert np.abs(g_ - w_).max() <= 1e-4 * max(np.abs(w_).max(),
                                                       1.0)
    nbk = 256
    kt = n // nbk
    derived = {"potrf": kt * (kt - 1) // 2,             # cw = nb = 256
               "getrf": sum(-(-k // 2) for k in range(kt)),   # cw = 512
               "geqrf": 3 * kt * (kt - 1) // 2 + kt}[kind]
    assert launches == derived
    assert peak <= budget + 16 * 2**20


@pytest.mark.parametrize("kind", ["potrf", "getrf", "geqrf"])
def test_lowmem_overlapped_copies_equal_synchronous_ones(card, k1_on, kind,
                                                         monkeypatch):
    """The write-back stream with its events gives bitwise what every copy
    blocking gives: a missing event between a panel's write-back and the
    next panel's upload of it would read stale host rows."""
    import numpy as np
    from dplasma_tpu_torch.kernels import hostlink
    a = _lowmem_inputs(kind, 2048)
    monkeypatch.setattr(hostlink, "OVERLAP", True)
    fast = _lowmem_call(kind, a)
    monkeypatch.setattr(hostlink, "OVERLAP", False)
    slow = _lowmem_call(kind, a)
    assert all(np.array_equal(f, s) for f, s in zip(fast, slow))


def test_getrf_lowmem_launches_k3_under_pallas(card, k1_on):
    """N=8192, nb=512, cw=1024 under panel.kernel=pallas: K3 on the 8
    panels with (N - s)·nb·4 <= 8 MiB, the rec panel (one K1 product) on
    the other 8, one K1 per apply (64): A[perm] = L U."""
    import numpy as np
    from dplasma_tpu_torch.kernels import hostlink
    from dplasma_tpu_torch.ops import lu
    from dplasma_tpu_torch.utils import config as cfg
    n, nb = 8192, 512
    a = _lowmem_inputs("getrf", n)
    k1, k3 = pk.LAUNCHES, plu.LAUNCHES
    hostlink.reset_stats()
    with cfg.override_scope({"panel.kernel": "pallas"}):
        LU, perm = lu.getrf_lowmem(a, nb=nb, budget_bytes=3 * n * 1024 * 4)
    torch.cuda.synchronize()
    assert perm.device.type == "cuda"
    assert plu.LAUNCHES - k3 == 8
    assert pk.LAUNCHES - k1 == 64 + 8
    assert hostlink.STATS.swapped_rows <= 2 * nb * (n // nb)
    L = torch.tril(torch.from_numpy(LU), -1).cuda() + torch.eye(n,
                                                                device=card)
    U = torch.triu(torch.from_numpy(LU)).cuda()
    A = torch.from_numpy(a).cuda()
    r = float((A[perm] - L @ U).abs().max() / (A.abs().max() * n
                                               * np.finfo(np.float32).eps))
    assert r < 60, r


def test_gemm_stream_on_the_card(card, k1_on):
    """gemm_ex(algo="stream") at M=N=K=2048, 256-wide tiles, B=C=4, D=2:
    4 C blocks × 4 k-chunks, one K1 launch each, within 1e-5 of
    blas3.gemm."""
    from dplasma_tpu_torch.ops import blas3, gemm, generators
    from dplasma_tpu_torch.utils import config as cfg
    A = generators.plrnt(2048, 2048, 256, 256, seed=1)
    B = generators.plrnt(2048, 2048, 256, 256, seed=2)
    C = generators.plrnt(2048, 2048, 256, 256, seed=3)
    info = cfg.Info({"DPLASMA:GEMM:GPU:B": 4, "DPLASMA:GEMM:GPU:C": 4,
                     "DPLASMA:GEMM:GPU:D": 2})
    before = pk.LAUNCHES
    got = gemm.gemm_ex(0.5, A, B, 2.0, C, info=info, algo="stream")
    torch.cuda.synchronize()
    assert pk.LAUNCHES - before == 16
    want = blas3.gemm(0.5, A, B, 2.0, C)
    assert _rel(got.data, want.data) <= 1e-5


def test_potrf_dtd_on_the_card(card, k1_on):
    """potrf_dtd at N=2048, nb=256 (nt=8): one K1 launch per herk and gemm
    task (28 + 56), the factor within 1e-5 of ops.potrf's."""
    from dplasma_tpu_torch import dtd
    from dplasma_tpu_torch.ops import generators, potrf
    A = generators.plghe(2048.0, 2048, 256, seed=5)
    before = pk.LAUNCHES
    F = dtd.potrf_dtd(A, "L")
    torch.cuda.synchronize()
    assert pk.LAUNCHES - before == 28 + 56
    want = potrf.potrf(A, "L")
    assert _rel(torch.tril(F.data), want.data) <= 1e-5


# ---------------------------------------------------------------------
# the instruments on the card
# ---------------------------------------------------------------------

def test_span_under_a_ledger_waits_for_its_k1_product(card, k1_on):
    """A span fences at exit only under a ledger: a K1 product launched
    in it has retired when the span ends (the stream is idle)."""
    from dplasma_tpu_torch.observability import phases
    g = torch.Generator(device=card).manual_seed(3)
    a = torch.randn(4096, 4096, device=card, generator=g)
    b = torch.randn(4096, 4096, device=card, generator=g)
    torch.cuda.synchronize()
    launches = pk.LAUNCHES
    with phases.profiling() as led:
        with phases.span("far_flush") as fence:
            c = fence(pk.gemm(a, b))
        assert torch.cuda.current_stream().query()
    assert pk.LAUNCHES == launches + 1
    assert [(r["phase"], r["count"]) for r in led.summary()] == \
        [("far_flush", 1)]
    assert led.summary()[0]["measured_s"] > 0
    assert torch.isfinite(c).all()


def test_torch_trace_captures_k1_kernel_events(card, k1_on, tmp_path):
    import json

    from dplasma_tpu_torch.utils import profiling
    a = torch.randn(2048, 2048, device=card)
    pk.gemm(a, a)
    torch.cuda.synchronize()
    with profiling.torch_trace(str(tmp_path / "tr")) as prof:
        pk.gemm(a, a)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert any("k1_gemm" in n for n in names), sorted(names)[:20]
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("k1_gemm" in str(e.get("name", ""))
               for e in doc["traceEvents"])


@pytest.mark.parametrize("grid", [(2, 2), (2, 4)])
def test_panel_bcast_probe_ring_equals_psum_on_card(card, grid):
    """The ``ring`` span's probe: the K5 ring route torch.equal to the
    masked psum, with KT·P broadcasts."""
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.parallel import cyclic, mesh
    P, Q = grid
    N, nb = 2048, 256
    A = generators.plrnt(N, N, nb, nb, seed=11)
    with mesh.use_grid(mesh.make_mesh(P, Q)):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(P=P, Q=Q))
        before = pring.LAUNCHES
        ring = cyclic._panel_bcast_probe(C, True, 4)
        torch.cuda.synchronize()
        launches = pring.LAUNCHES - before
        psum = cyclic._panel_bcast_probe(C, False, 0)
    assert launches == (N // nb) * P
    for r0, r1 in zip(ring, psum):
        assert all(torch.equal(a, b) for a, b in zip(r0, r1))


def _devprof_capture(card, body, grid=(1, 1), nruns=2):
    """``body`` in ``nruns`` timed runs under a ``torch`` capture, each
    run fenced at both ends as the drivers' timed loop is."""
    from dplasma_tpu_torch.observability import devprof as dp
    cap = dp.DevprofCapture(backend="torch", device=card, grid=grid)
    with cap:
        for i in range(nruns):
            with cap.run(i):
                torch.cuda.synchronize()
                body()
                torch.cuda.synchronize()
    return cap


def test_devprof_capture_of_one_k1_product(card, k1_on):
    """The ``torch`` backend holds one K1 launch a run, binned compute,
    a device copy binned host, each run's ops inside its own window."""
    from dplasma_tpu_torch.observability import devprof as dp
    a = torch.randn(2048, 2048, device=card)
    pk.gemm(a, a)
    torch.cuda.synchronize()
    before = pk.LAUNCHES
    cap = _devprof_capture(card, lambda: (pk.gemm(a, a), a.clone()))
    assert pk.LAUNCHES - before == 2
    runs = [cap.select(i) for i in range(2)]
    assert cap.used == "torch" and not cap.note
    for ops in runs:
        rows = dp.device_ops(ops)
        k1 = [r for r in rows if "k1_gemm" in r["name"]]
        assert sum(r["count"] for r in k1) == 1, rows
        assert {r["category"] for r in k1} == {"compute"}
        assert any(r["category"] == "host" for r in rows), rows
    assert max(o["end_ns"] for o in runs[0]) <= \
        min(o["begin_ns"] for o in runs[1])
    entry = dp.ingest(runs[1], 1.0, 1, backend="torch")
    assert entry["categories"]["compute"] > 0
    assert entry["reconciliation"]["relation"] == "no-collectives"


@pytest.mark.parametrize("kind", ["bcast", "shift"])
@pytest.mark.parametrize("axis", ["q", "p"])
def test_devprof_capture_of_one_k5_launch(card, kind, axis):
    """A K5 broadcast (shift) along ``axis`` is one ``ici`` op of class
    ring_bcast@axis (ring_shift@axis), from the range its launch opens,
    carrying the rings of its axis on a 2×3 mesh."""
    from dplasma_tpu_torch.observability import devprof as dp
    xs = [torch.randn(512, 256, device=card) for _ in range(3)]

    def body():
        if kind == "bcast":
            pring.ring_bcast(xs, root=1, axis=axis)
        else:
            pring.ring_shift(xs, axis=axis)
    body()
    torch.cuda.synchronize()
    before = pring.LAUNCHES
    cap = _devprof_capture(card, body, grid=(2, 3))
    assert pring.LAUNCHES - before == 2
    ops = cap.select(1)
    k5 = [o for o in ops if o.get("cls")]
    want = (f"ring_{kind}@{axis}", 2 if axis == "q" else 3)
    assert [(o["cls"], o["rings"], o["category"]) for o in k5] == \
        [want + ("ici",)], ops
    assert f"k5_ring_{kind}_kernel" in k5[0]["name"]


@pytest.mark.parametrize("op", ["potrf_L", "getrf"])
def test_cyclic_dd_on_card_k2_launches_as_derived(card, op):
    """The dd route under the 2x2 grid on the card, f64 at N=1024,
    nb=128 under dd_gemm=always: K2's launches equal chip_smoke's
    ``cyclic_k2_launches``, none unfused, no K1; the factor (max|Δ| /
    max|native|) within 1e-12 (potrf) or 1e-11 (the LU's factor carries
    the random matrix's condition) of the same op's native FP64 run on
    the card and of the dd run on the CPU (the plain versions, f32 seeds
    from the CPU's LAPACK), perm equal. Measured on an NVIDIA H100 80GB
    HBM3 at 700.00 W: potrf 2.1e-14 against native, 2.4e-16 against the
    CPU; the LU 1.95e-12 and 1.78e-12 (max|factor| 24.0)."""
    import chip_smoke as cs
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg
    N, nb = 1024, 128
    A = (generators.plghe(float(N), N, nb, seed=4, dtype=torch.float64)
         if op == "potrf_L" else
         generators.plrnt(N, N, nb, nb, seed=4, dtype=torch.float64))

    def run(device):
        with mesh.use_grid(mesh.make_mesh(2, 2, device)):
            C = cyclic.CyclicMatrix.from_tile(
                A if device == "cuda" else type(A)(A.data.cpu(), A.desc),
                Dist(P=2, Q=2))
            out = cyclic.potrf_cyclic(C) if op == "potrf_L" \
                else cyclic.getrf_cyclic(C)
            return out if op == "getrf" else (out, None)

    native, nperm = run("cuda")
    with cfg.override_scope({"dd_gemm": "always"}):
        k1, k2, unfused = pk.LAUNCHES, pdd.LAUNCHES, pdd.UNFUSED
        (F, perm) = run("cuda")
        torch.cuda.synchronize()
        k1, k2, unfused = (pk.LAUNCHES - k1, pdd.LAUNCHES - k2,
                           pdd.UNFUSED - unfused)
        (Fc, permc) = run("cpu")
    la = cfg.mca_get_int("sweep.lookahead", 1)
    tol = 1e-12 if op == "potrf_L" else 1e-11
    assert (k1, unfused) == (0, 0)
    assert k2 == cs.cyclic_k2_launches(op, 2, 2, N // nb, la)
    gaps = {}
    for key, got, want in (("native", F, native), ("cpu", F, Fc)):
        gaps[key] = max(float((g_ - w_.to(g_.device)).abs().max()
                              / w_.abs().max())
                        for rg, rw in zip(got.data, want.data)
                        for g_, w_ in zip(rg, rw))
    print(f"[cyclic_dd_card] {op} N={N} nb={nb}: max|factor| "
          f"{max(float(t.abs().max()) for r in F.data for t in r):.4g}, "
          f"max|dd - native| / max|native| {gaps['native']:.3e}, "
          f"max|card - cpu| / max|cpu| {gaps['cpu']:.3e} (limit {tol:g})")
    assert max(gaps.values()) <= tol, gaps
    if op == "getrf":
        assert torch.equal(perm.cpu(), permc) and torch.equal(perm, nperm)


def test_injected_fault_heals_on_card(card, k1_on, tmp_path):
    """``testing_spotrf --abft --inject=nan@gemm:1:1`` on the card with
    K1 on: the NaN lands in the first K1 product of the primary attempt
    (its K1 launches per run those of the bordered matrix), the health
    scan and ABFT flag it, the retry rung heals it and -x passes; a
    ``reject`` plan walks to the kernel fallback, whose attempt runs with
    K1 off, and the driver's close turns K1 back on."""
    import json

    import chip_smoke as cs
    from dplasma_tpu_torch.drivers import common, main
    from dplasma_tpu_torch.utils import config as cfg
    N, nb = 2048, 256
    rep = tmp_path / "r.json"
    common.RUNS.clear()
    assert main(["testing_spotrf", "-N", str(N), "-t", str(nb), "-x",
                 "--abft", "--inject=nan@gemm:1:1", f"--report={rep}"]) == 0
    r = json.load(open(rep))["resilience"][0]
    assert [(a["action"], a["ok"]) for a in r["attempts"]] == \
        [("primary", False), ("retry", True)]
    assert r["attempts"][0]["abft"]["detected"]
    assert r["outcome"] == "remediated"
    op = common.RUNS[-1]["ops"][0]
    want = len(cs.main_path_products(N + nb, nb))
    assert all(n == want for n in op["attempts"][0]["k1"])
    assert all(c["ok"] for c in common.RUNS[-1]["checks"])
    common.RUNS.clear()
    try:
        assert main(["testing_spotrf", "-N", str(N), "-t", str(nb), "-x",
                     "--inject=reject@potrf:1:1", f"--report={rep}"]) == 0
        assert pk.enabled()
        assert cfg.mca_snapshot().get("panel.kernel") is None
    finally:
        pk.enable(True)
        cfg.mca_unset("panel.kernel")
    r = json.load(open(rep))["resilience"][0]
    assert [a["action"] for a in r["attempts"]] == ["primary",
                                                    "kernel_fallback"]
    att = common.RUNS[-1]["ops"][0]["attempts"]
    assert [a["action"] for a in att] == ["kernel_fallback"]
    assert not any(att[0]["k1"])


def test_k1_launch_failure_under_abft_fails_the_run(card, k1_on,
                                                    monkeypatch):
    """A K1 launch that fails on the card (its C entry point returning a
    CUDA error) under ``--abft`` is no ladder class: the error leaves
    ``main``, so the program exits non-zero, and K1 stays on."""
    from dplasma_tpu_torch.drivers import main
    from dplasma_tpu_torch.utils import config as cfg
    pk.gemm(torch.ones(256, 256, device=card),
            torch.ones(256, 256, device=card))     # K1 built
    monkeypatch.setattr(pk, "_kernel", lambda: (lambda args: 700))
    with pytest.raises(RuntimeError, match="K1 .* launch failed: "
                                           "cudaError 700"):
        main(["testing_spotrf", "-N", "2048", "-t", "256", "-x", "--abft"])
    assert pk.enabled()
    assert cfg.mca_snapshot().get("panel.kernel") is None
