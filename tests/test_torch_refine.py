"""Port parity: the mixed-precision IR solvers (``ops.refine``) and
``checks.check_solve`` of ``dplasma_tpu_torch`` against ``dplasma_tpu``,
on the very same inputs (the reference eagerly on the CPU with x64, as
its own tests run it).

Both packages factor in the same working precision and refine on
exact limb residuals, so their solutions agree far below the f64
backward-error floor they converge to: max|ΔX|/max|X| <= 1e-11 (the
working factors round in each package's own order, and the matrices
here are well conditioned). ``converged`` and ``escalated`` must be
equal and ``iterations`` within one. The bf16-rounded working matrix is
bitwise the reference's (both round f64 -> f32 -> bf16, shown on values
where a direct f64 -> bf16 rounding would differ, and flush f32
subnormals). ``gels_ir`` is in ``test_torch_refine_gels.py``. The small
cases share the 24×8-tile shapes, so the reference compiles them once.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import TileMatrix as RefTile
from dplasma_tpu.ops import checks as ref_checks
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import refine as ref_refine
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import checks, refine
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

XTOL = 1e-11
EPS = 2.0 ** -52
N, NB = 96, 32


def _pair(A):
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


def _spd(n, nb, cond=None, seed=5):
    """SPD matrix: the diagonally dominant generator, or Q diag(logspace)
    Qᵀ with the given condition number."""
    if cond is None:
        return _pair(ref_gen.plghe(float(n), n, nb, seed=seed,
                                   dtype=jnp.float64))
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0.0, -np.log10(cond), n)
    return _pair(RefTile.from_dense(jnp.asarray((Q * d) @ Q.T), nb, nb))


def _gen(m, n, nb, seed, diagdom=False):
    return _pair(ref_gen.plrnt(m, n, nb, nb, seed=seed, dtype=jnp.float64,
                               diagdom=diagdom))


def _same(want_x, want_info, got_x, got_info, exact_iters=False):
    w = np.asarray(want_x.to_dense())
    g = got_x.to_dense().numpy()
    assert g.shape == w.shape and g.dtype == np.float64
    assert np.abs(w - g).max() <= XTOL * np.abs(w).max()
    for key in ("converged", "escalated"):
        assert bool(got_info[key]) == bool(want_info[key]), key
    di = int(got_info["iterations"]) - int(want_info["iterations"])
    assert di == 0 if exact_iters else abs(di) <= 1
    assert got_info["backward_errors"].shape == \
        want_info["backward_errors"].shape
    if "quant_guard_max" in want_info:
        assert float(got_info["quant_guard_max"]) > 0


def test_ir_params_resolve_like_the_reference():
    for args in ((None, None, None), ("F32X2", 3, 1e-9), ("bf16", 0, -1.0)):
        assert refine.ir_params(*args) == ref_refine.ir_params(*args)
    assert refine.ir_params()[0] == "f32"
    assert refine.ir_params()[2] == 100 * 2.0 ** -52
    knobs = {"ir.precision": "int8", "ir.max_iters": "4", "ir.tol": "1e-12"}
    with cfg.override_scope(knobs), ref_cfg.override_scope(knobs):
        assert refine.ir_params() == ref_refine.ir_params() == \
            ("int8", 4, 1e-12)
    with pytest.raises(ValueError, match="ir.precision"):
        refine.ir_params("fp8")
    assert refine.PRECISIONS == ref_refine.PRECISIONS


def test_round_wp_bf16_is_bitwise():
    """Values just past a bf16 midpoint (direct f64 -> bf16 rounding
    would round them up, f64 -> f32 -> bf16 lands on the midpoint and
    ties to even), f32 subnormals of both signs (flushed to signed zero,
    as XLA does), values around f32's smallest normal and beyond its
    largest, and a random matrix over 40 decades: the same bits as the
    reference."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        [1 + 2 ** -8 + 2 ** -30, -(1 + 3 * 2 ** -8 + 2 ** -40),
         2 ** 100 * (1 + 2 ** -8 + 2 ** -31), 1e-40, -1e-40, 2e-39,
         1.17549435e-38, 1.2e-38, -1.5e-38, 1e-50, 3.0e38 * 1.2],
        rng.standard_normal(200) * 10.0 ** rng.integers(-20, 20, 200)])
    for prec in refine.PRECISIONS:
        want = np.asarray(ref_refine._round_wp(jnp.asarray(x), prec))
        got = refine._round_wp(torch.from_numpy(x), prec)
        assert got.dtype == torch.float32
        assert np.array_equal(want.view(np.uint32),
                              got.numpy().view(np.uint32)), prec


@pytest.mark.parametrize("uplo", ["L", None])
def test_check_solve_matches_reference(uplo):
    RA, A = _spd(24, 8) if uplo else _gen(24, 24, 8, 7)
    RB, B = _gen(24, 2, 8, 8)
    a = np.asarray(RA.to_dense())
    if uplo:
        a = np.tril(a) + np.tril(a, -1).T
    x = np.linalg.solve(a, np.asarray(RB.to_dense()))
    for noise in (0.0, 1e-9):
        xn = x + noise * np.random.default_rng(1).standard_normal(x.shape)
        RX, X = _pair(RefTile.from_dense(jnp.asarray(xn), 8, 8))
        want = ref_checks.check_solve(RA, RB, RX, uplo=uplo)
        got = checks.check_solve(A, B, X, uplo=uplo)
        assert got[1] == want[1] == (noise == 0.0)
        if noise:
            assert abs(got[0] - want[0]) <= 1e-6 * want[0]
        else:   # both at the f64 floor, rounded in each one's order
            assert max(got[0], want[0]) <= 20 * EPS


@pytest.mark.parametrize("prec", refine.PRECISIONS)
def test_posv_ir_matches_reference(prec):
    RA, A = _spd(N, NB)
    RB, B = _gen(N, 2, NB, 6)
    want_x, want_i = ref_refine.posv_ir(RA, RB, precision=prec)
    got_x, got_i = refine.posv_ir(A, B, precision=prec)
    _same(want_x, want_i, got_x, got_i)
    assert bool(got_i["converged"]) and not bool(got_i["escalated"])
    s = refine.summarize(got_i, op="posv_ir", precision=prec)
    assert s == dict(s, op="posv_ir", precision=prec, converged=True)
    assert len(s["backward_errors"]) == s["iterations"] + 1
    assert s["backward_errors"][-1] <= s["tol"]
    assert ("quant_guard_max" in s) == (prec == "int8")
    r, ok = checks.check_solve(A, B, got_x, uplo="L")
    assert ok, r


@pytest.mark.parametrize("prec", refine.PRECISIONS)
def test_gesv_ir_matches_reference(prec):
    """A diagonally dominant general matrix: every rung converges (the
    int8 and bf16 rungs escalate on a plain plrnt one, in both
    packages)."""
    RA, A = _gen(N, N, NB, 3874, diagdom=True)
    RB, B = _gen(N, 2, NB, 3875)
    want_x, want_i = ref_refine.gesv_ir(RA, RB, precision=prec)
    got_x, got_i = refine.gesv_ir(A, B, precision=prec)
    _same(want_x, want_i, got_x, got_i)
    assert bool(got_i["converged"]) and not bool(got_i["escalated"])
    r, ok = checks.check_solve(A, B, got_x)
    assert ok, r


@pytest.mark.parametrize("cond", [1e3, 1e5])
def test_posv_ir_escalates_like_the_reference(cond):
    """Deterministic divergence of the bf16 rung with a budget of 2: at
    cond 1e3 the budget runs out before the floor, at cond 1e5 the bf16
    factor is no longer positive definite (a NaN backward error). Both
    packages escalate to the full-precision posv and hand back its
    solve, equal within XTOL at these conditions."""
    RA, A = _spd(24, 8, cond=cond, seed=11)
    RB, B = _gen(24, 2, 8, 12)
    want_x, want_i = ref_refine.posv_ir(RA, RB, precision="bf16",
                                        max_iters=2)
    got_x, got_i = refine.posv_ir(A, B, precision="bf16", max_iters=2)
    assert bool(got_i["escalated"]) and not bool(got_i["converged"])
    _same(want_x, want_i, got_x, got_i, exact_iters=True)
    r, ok = checks.check_solve(A, B, got_x, uplo="L")
    assert ok, r
    # with escalation off the caller owns the divergence
    _, info = refine.posv_ir(A, B, precision="bf16", max_iters=2,
                             escalate=False)
    assert not bool(info["converged"]) and not bool(info["escalated"])


def test_ir_converges_at_exact_budget_no_escalation():
    """A solve converging at exactly max_iters corrections is a
    convergence: the budget's last correction gets its own verdict, so
    the escalation rung never re-factors a solved system (reference
    test_refine.py:171)."""
    RA, A = _spd(24, 8)
    RB, B = _gen(24, 2, 8, 6)
    _, info = refine.posv_ir(A, B, precision="bf16", escalate=False)
    kk = int(info["iterations"])
    assert kk >= 2
    want_x, want_i = ref_refine.posv_ir(RA, RB, precision="bf16",
                                        max_iters=kk)
    got_x, got_i = refine.posv_ir(A, B, precision="bf16", max_iters=kk)
    s = refine.summarize(got_i, op="posv_ir", precision="bf16")
    assert s["converged"] and not s["escalated"] and s["iterations"] == kk
    assert got_i["backward_errors"].shape == (kk + 1,)
    _same(want_x, want_i, got_x, got_i, exact_iters=True)


def test_solvers_refuse_what_the_reference_refuses():
    _, A = _spd(32, 8)
    _, B = _gen(32, 2, 8, 6)
    f32 = TileMatrix(A.data.float(), A.desc)
    for fn in (refine.posv_ir, refine.gesv_ir, refine.gels_ir):
        with pytest.raises(TypeError, match="float64"):
            fn(f32, B)
    _, W = _gen(16, 32, 8, 7)
    with pytest.raises(ValueError, match="M >= N"):
        refine.gels_ir(W, B)
