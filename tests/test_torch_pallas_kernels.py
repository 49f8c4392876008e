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
