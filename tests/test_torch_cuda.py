"""The port's hand-written kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip where there is no
GPU; on a machine with one they build K1, K3 and K4 from
``kernels/csrc`` and hold each against its plain PyTorch version:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: K1, relative Frobenius error <= 1e-5 for f32 (summation
order only) and <= 1e-2 for bf16 output. K3, the permutation bitwise
equal and max|Δ|/max|packed| <= 1e-4 (the kernel rounds each step as
the plain version does, so it is expected to agree exactly). K4,
max|Δpacked|/max|packed| <= 1e-4 and max|Δtau| <= 1e-4 (it sums in
another order than the plain version), and the Q rebuilt from its
output passes the reference's QR checks (< 60).
"""
import pytest
import torch

from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.kernels import pallas_lu as plu
from dplasma_tpu_torch.kernels import pallas_qr as pqr

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
    err = (packed - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-4
    return packed, perm


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
