"""The port's hand-written kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip where there is no
GPU; on a machine with one they build K1 from ``kernels/csrc`` and hold
it against its plain PyTorch version:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: relative Frobenius error <= 1e-5 for f32 (summation order
only) and <= 1e-2 for bf16 output.
"""
import pytest
import torch

from dplasma_tpu_torch.kernels import pallas_kernels as pk

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
