"""Port parity: the Cholesky slice (``dplasma_tpu_torch.ops.potrf``) against
the JAX package, on the very same padded input.

Tolerances: max|ΔL|/max|L| <= 1e-4 for f32 and 1e-12 for f64 — the two
packages run the same sweep with different BLAS/LAPACK, so they differ
by rounding only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from dplasma_tpu.kernels import pallas_kernels as ref_pk
from dplasma_tpu.ops import checks as ref_checks
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import checks, generators
from dplasma_tpu_torch.ops import potrf as port_potrf
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"s": (jnp.float32, 1e-4), "d": (jnp.float64, 1e-12)}

# one traced program per (uplo, lookahead) instead of one eager dispatch
# per tile op: the reference sweep at N=100 compiles faster this way
ref_potrf_jit = jax.jit(ref_potrf.potrf,
                        static_argnames=("uplo", "lookahead"))


def _pair(N, nb, jdt, seed=3872, bump=None):
    A = ref_gen.plghe(float(N) if bump is None else bump, N, nb,
                      seed=seed, dtype=jdt)
    T = TileMatrix.from_reference(np.asarray(A.data),
                                  dataclasses.asdict(A.desc), device="cpu")
    return A, T


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    return np.abs(ref - got).max() / np.abs(ref).max()


@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("la", [0, 1, 2])
def test_potrf_matches_reference(prec, uplo, la):
    jdt, tol = DTYPES[prec]
    A, T = _pair(100, 16, jdt)
    want = ref_potrf_jit(A, uplo=uplo, lookahead=la)
    got = port_potrf.potrf(T, uplo, lookahead=la)
    assert got.desc == T.desc
    assert _rel(want.data, got.data) <= tol
    r, ok = checks.check_potrf(T, got, uplo)
    assert ok, r
    r_ref, _ = ref_checks.check_potrf(A, want, uplo)
    assert r == pytest.approx(r_ref, rel=0.5, abs=1e-2)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_opposite_triangle_is_never_read(uplo):
    _, T = _pair(100, 16, jnp.float64)
    garbage = T.like(T.data.clone())
    junk = torch.full_like(garbage.data, 1e30)
    if uplo == "L":
        garbage.data += torch.triu(junk, 1)
    else:
        garbage.data += torch.tril(junk, -1)
    clean = port_potrf.potrf(T, uplo)
    dirty = port_potrf.potrf(garbage, uplo)
    assert torch.equal(clean.data, dirty.data)


def test_non_spd_gives_nans_in_both_packages():
    A, T = _pair(100, 16, jnp.float64, bump=-1.0)
    want = np.asarray(ref_potrf_jit(A, uplo="L", lookahead=1).data)
    got = port_potrf.potrf(T, "L").data.numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_posv_and_potrs_residuals(uplo):
    N, nb, nrhs = 100, 16, 7
    A, T = _pair(N, nb, jnp.float64)
    B = generators.plrnt(N, nrhs, nb, nb, seed=2354,
                         dtype=torch.float64, device="cpu")
    L, X = port_potrf.posv(T, B, uplo)
    r, ok = checks.check_axmb(T, B, X, uplo=uplo)
    assert ok, r
    X2 = port_potrf.potrs(L, B, uplo)
    assert torch.equal(X.data, X2.data)
    ref_B = ref_gen.plrnt(N, nrhs, nb, nb, seed=2354, dtype=jnp.float64)
    _, ref_X = jax.jit(ref_potrf.posv, static_argnames="uplo")(
        A, ref_B, uplo=uplo)
    assert _rel(ref_X.data, X.data) <= 1e-12


def test_potrf_rec_matches_plain():
    _, T = _pair(96, 32, jnp.float64)
    plain = port_potrf.potrf(T, "L")
    rec = port_potrf.potrf_rec(T, "L", hnb=8)
    assert torch.allclose(plain.data, rec.data, rtol=0, atol=1e-12)


@requires_pallas
def test_potrf_with_k1_matches_reference():
    """K1 enabled on both sides (interpret mode on the reference side):
    at N=768, nb=256 every one of the 2·3 − 3 update products takes the
    kernel route."""
    A, T = _pair(768, 256, jnp.float32)
    was_ref, was_port = ref_pk.enabled(), pk.enabled()
    ref_pk.enable(True)
    pk.enable(True)
    try:
        want = ref_potrf.potrf(A, "L", lookahead=1)
        routed = pk.ROUTED
        got = port_potrf.potrf(T, "L", lookahead=1)
        assert pk.ROUTED - routed == 3
    finally:
        ref_pk.enable(was_ref)
        pk.enable(was_port)
    assert _rel(want.data, got.data) <= 1e-4
    r, ok = checks.check_potrf(T, got, "L")
    assert ok, r


@pytest.fixture
def dd_always():
    ref_cfg.mca_set("dd_gemm", "always")
    try:
        with cfg.override_scope({"dd_gemm": "always"}):
            yield
    finally:
        ref_cfg.mca_unset("dd_gemm")


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dd_potrf_posv_match_reference(uplo, dd_always):
    """dd_gemm=always: both packages run the limb-cached blocked
    factorization (N=192, nb=64: 5·3 − 3 = 12 limb products, each
    through K2's route) and solve through the dd trsm; within 1e-12."""
    N, nb, nrhs = 192, 64, 3
    A, T = _pair(N, nb, jnp.float64, seed=51)
    routed = pdd.ROUTED
    got = port_potrf.potrf(T, uplo)
    assert pdd.ROUTED - routed == 12
    want = ref_potrf.potrf(A, uplo)
    assert _rel(want.data, got.data) <= 1e-12
    r, ok = checks.check_potrf(T, got, uplo)
    assert ok, r
    B = generators.plrnt(N, nrhs, nb, nb, seed=2354, dtype=torch.float64,
                         device="cpu")
    L, X = port_potrf.posv(T, B, uplo)
    assert torch.equal(L.data, got.data)
    assert torch.equal(port_potrf.potrs(L, B, uplo).data, X.data)
    r, ok = checks.check_axmb(T, B, X, uplo=uplo)
    assert ok, r
    ref_B = ref_gen.plrnt(N, nrhs, nb, nb, seed=2354, dtype=jnp.float64)
    assert _rel(ref_potrf.potrs(want, ref_B, uplo).data, X.data) <= 1e-12
