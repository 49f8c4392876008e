"""Port parity, refinement part: the f64-equivalent tile factorizations
and solves of ``dplasma_tpu_torch.kernels.dd`` against
``dplasma_tpu.kernels.dd``.

These start from an f32 seed (a Cholesky, a triangular solve, f32
products) that torch and XLA round differently, and refinement on exact
residuals then pulls both to f64 accuracy, so they agree within a
tolerance, not bitwise: max|Δ| <= 1e-12 · max|result| (the refined
error is ~kappa·eps64 ≈ 1e-14 for these well-conditioned inputs; the
margin covers the two seeds' different rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu_torch.kernels import dd
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12
n, m = 48, 24


def assert_close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(11)
    T = rng.standard_normal((n, n)) + n * np.eye(n)
    q = rng.standard_normal((n, n))
    spd = q @ q.T + n * np.eye(n)
    return rng, T, spd


def _tri(T, unit):
    """A well-conditioned operand for the unit case too: with a unit
    diagonal, O(1) off-diagonals make a triangle whose condition grows
    like 2^n, so they are scaled by 1/n there."""
    return T / n if unit else T


def _resid(a, b):
    """max|a − b| / (max|b| · n · eps64): the reference's residual
    measure, passing below 60 (tests/testing_zpotrf.c)."""
    return np.abs(a - b).max() / (np.abs(b).max() * a.shape[0]
                                  * np.finfo(np.float64).eps)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [False, True])
def test_trtri_f64(mats, lower, unit):
    _, T, _ = mats
    T = _tri(T, unit)
    assert_close(ref_dd.trtri_f64(jnp.asarray(T), lower=lower, unit=unit),
                 dd.trtri_f64(torch.from_numpy(T), lower=lower, unit=unit))


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_f64_all_cases(mats, side, trans, lower, unit):
    rng, T, _ = mats
    T = _tri(T, unit)
    B = rng.standard_normal((n, m) if side == "L" else (m, n))
    kw = dict(side=side, lower=lower, trans=trans, unit=unit, alpha=2.0)
    want = ref_dd.trsm_f64(jnp.asarray(T), jnp.asarray(B), **kw)
    got = dd.trsm_f64(torch.from_numpy(T), torch.from_numpy(B), **kw)
    assert_close(want, got)
    # and it is a solve: op(tri(T)) X = 2 B (or X op(tri(T)) = 2 B)
    t = np.tril(T) if lower else np.triu(T)
    if unit:
        np.fill_diagonal(t, 1.0)
    op = t.T if trans == "T" else t
    x = got.numpy()
    r = op @ x - 2 * B if side == "L" else x @ op - 2 * B
    assert _resid(r + 2 * B, 2 * B) < 60


def test_trsm_f64_extreme_magnitudes(mats):
    """The pow2 prescales keep the f32 seed in range for columns outside
    f32's span (tests/test_dd.py's case)."""
    rng, T, _ = mats
    T = np.tril(T)
    B = rng.standard_normal((n, 8))
    B[:, 0] *= 1e38
    B[:, 1] *= 1e-38
    want = np.asarray(ref_dd.trsm_f64(jnp.asarray(T), jnp.asarray(B),
                                      side="L", lower=True))
    got = dd.trsm_f64(torch.from_numpy(T), torch.from_numpy(B), side="L",
                      lower=True).numpy()
    ref = np.linalg.solve(T, B)
    assert np.isfinite(got).all()
    for x in (got, want):
        rel = np.abs(x - ref) / np.abs(ref).max(axis=0, keepdims=True)
        assert rel.max() < 1e-10, rel.max()
    col = np.abs(want - got) / np.abs(want).max(axis=0, keepdims=True)
    assert col.max() <= TOL


@pytest.mark.parametrize("lower", [True, False])
def test_potrf_f64(mats, lower):
    _, _, spd = mats
    want = ref_dd.potrf_f64(jnp.asarray(spd), lower=lower)
    got = dd.potrf_f64(torch.from_numpy(spd), lower=lower)
    assert_close(want, got)
    L = got.numpy() if lower else got.numpy().T
    assert _resid(L @ L.T, spd) < 60


def test_potrf_tile_ir_and_panel_trsm_ir(mats):
    rng, _, spd = mats
    for need_inverse in (False, True):
        wL, wX = ref_dd._potrf_tile_ir(jnp.asarray(spd), refine=2,
                                       need_inverse=need_inverse)
        gL, gX = dd._potrf_tile_ir(torch.from_numpy(spd), refine=2,
                                   need_inverse=need_inverse)
        assert_close(wL, gL)
        assert (gX is None) == (not need_inverse)
        if need_inverse:
            assert_close(wX, gX)
    L = gL
    slab = rng.standard_normal((2 * n, n)) * 4.0
    want = ref_dd._panel_trsm_ir(jnp.asarray(L.numpy()), jnp.asarray(slab))
    got = dd._panel_trsm_ir(L, torch.from_numpy(slab))
    assert_close(want, got)
    assert _resid(got.numpy() @ L.numpy().T, slab) < 60
