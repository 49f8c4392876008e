"""Port parity: the f64-equivalent (dd) LU route of
``dplasma_tpu_torch`` (``kernels.dd.lu_ir``, ``ops.lu._panel_lu_dd``,
``getrf_1d``/``getrf_rec``/``gesv_1d`` under MCA ``dd_gemm=always``)
against ``dplasma_tpu``, on the very same inputs.

The f32 seed panels of both packages are LAPACK's pivoted LU of the same
power-of-two prescaled f32 panel, so the permutations must agree bit for
bit; refinement on exact limb residuals then pulls both factors to f64
accuracy, and they agree within max|Δ| <= 1e-12 · max|factor| (the two
round their f32 correction products differently). The reference runs at
MCA ``lu.agg_depth=1`` and at most 4 panels, where it takes its traced
route; its results are shared through module-scoped fixtures (its dd
route compiles per shape). The port at more than 8 panels (where the
reference takes its eager route and ``lu.agg_depth`` fuses its far
flushes) is held to itself and to numpy float64: the reference needs
minutes there.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.ops import checks
from dplasma_tpu_torch.ops import lu
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12
DD = {"dd_gemm": "always", "lu.agg_depth": "1"}
EPS = np.finfo(np.float64).eps


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    return np.abs(want - got).max() / np.abs(want).max()


def _pair(N, nb, seed=3872, K=None):
    """The same plrnt matrix (or N×K right-hand side) in both packages."""
    A = ref_gen.plrnt(N, K or N, nb, nb, seed=seed, dtype=jnp.float64)
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


def _seed(pp):
    """An f32 seed L, U of the (already permuted) f64 panel ``pp``."""
    P, L, U = torch.linalg.lu(torch.from_numpy(pp).float())
    assert torch.equal(P, torch.eye(P.shape[0]))
    return L.double().numpy(), U.double().numpy()


def _panel(m, nb, seed, zero_col=None):
    """A random (m, nb) panel already in partial-pivoting row order, so
    the seed LU needs no permutation."""
    a = np.random.default_rng(seed).standard_normal((m, nb))
    if zero_col is not None:
        a[:, zero_col] = 0.0
    P, _, _ = torch.linalg.lu(torch.from_numpy(a).float())
    return P.double().numpy().T @ a


@pytest.mark.parametrize("m,nb,bits,zero_col", [
    (96, 32, None, None), (32, 32, None, None), (96, 32, 32, None),
    (96, 32, None, 5)])
def test_lu_ir_matches_reference(m, nb, bits, zero_col):
    """Refining the same seed: tall and square panels, the ``bits=32``
    pin, and an exactly zero column (the guarded inverse keeps the
    refinement finite and U's zero diagonal exact)."""
    pp = _panel(m, nb, 11 + m, zero_col)
    L0, U0 = _seed(pp)
    wl, wu = ref_dd.lu_ir(jnp.asarray(pp), jnp.asarray(L0), jnp.asarray(U0),
                          bits=bits)
    gl, gu = dd.lu_ir(torch.from_numpy(pp), torch.from_numpy(L0),
                      torch.from_numpy(U0), bits=bits)
    assert _rel(wl, gl) <= TOL and _rel(wu, gu) <= TOL
    # backward error: the -x measure (< 60) on the full ladder; pinned to
    # the bits=32 rung, between the f32 seed's and f64's (the rung's
    # 2^-32 floor times the panel's growth: 1.6e-8 here, the seed 2.6e-7)
    back = np.abs(pp - gl.numpy() @ gu.numpy()).max() / np.abs(pp).max()
    seed = np.abs(pp - L0 @ U0).max() / np.abs(pp).max()
    if bits == 32:
        assert seed / 10 > back > 60 * m * EPS, (back, seed)
    else:
        assert back < 60 * m * EPS, back
    if zero_col is not None:
        assert gu[zero_col, zero_col] == 0 and gl[:, zero_col].abs().max() \
            <= 1.0


def test_panel_lu_dd_matches_reference():
    """The dd panel: perm bitwise, packed L\\U within 1e-12; the same
    panel with its columns scaled far outside f32's range (2^±200) gives
    the same perm and the factor scaled exactly (the column prescale)."""
    a = np.random.default_rng(5).standard_normal((96, 32))
    with ref_cfg.override_scope(DD), cfg.override_scope(DD):
        want, wperm = ref_lu._panel_lu_dd(jnp.asarray(a))
        got, perm = lu._panel_lu_dd(torch.from_numpy(a))
        d = 2.0 ** np.where(np.arange(32) % 2, 200, -200)
        big, bperm = lu._panel_lu_dd(torch.from_numpy(a * d))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want, got) <= TOL
    np.testing.assert_array_equal(bperm.numpy(), perm.numpy())
    f, fb = got.numpy(), big.numpy()
    assert np.abs(np.tril(fb, -1) - np.tril(f, -1)).max() <= TOL
    assert np.abs(np.triu(fb)[:32] / d - np.triu(f)[:32]).max() \
        <= TOL * np.abs(np.triu(f)).max()


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's dd runs, once: getrf_1d at N=96 and ragged N=100
    (nb=32), getrf_rec with hnb=8, and gesv_1d with 3 right-hand
    sides."""
    out = {}
    with ref_cfg.override_scope(DD):
        for N in (96, 100):
            A, T = _pair(N, 32)
            out["getrf", N] = T, ref_lu.getrf_1d(A)
        A, T = _pair(96, 32)
        out["getrf_rec"] = T, ref_lu.getrf_rec(A, 8)
        B, TB = _pair(96, 32, seed=3873, K=3)
        out["gesv"] = (T, TB), ref_lu.gesv_1d(A, B)
    return out


@pytest.mark.parametrize("N", [96, 100])
def test_getrf_1d_dd_matches_reference(ref_runs, N):
    """Perm bitwise, factor within 1e-12 of max|F|; on the ragged N the
    zero pad rows never win a pivot over a real row."""
    T, (want, wperm) = ref_runs["getrf", N]
    routed = pdd.ROUTED
    with cfg.override_scope(DD):
        F, perm = lu.getrf_1d(T)
    kt = T.desc.KT
    # 4 lu_ir residuals a panel, 3 a block apply (2·KT − 3 at lookahead 1)
    assert pdd.ROUTED - routed == 4 * kt + 3 * (2 * kt - 3)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, F.data) <= TOL
    assert (perm[:N] < N).all()


def test_getrf_rec_dd_matches_reference(ref_runs):
    T, (want, wperm) = ref_runs["getrf_rec"]
    with cfg.override_scope(DD):
        F, perm = lu.getrf_rec(T, 8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, F.data) <= TOL


def test_gesv_1d_dd_matches_reference(ref_runs):
    """The factor, perm and solution against the reference, and the
    solution's backward error under the -x threshold."""
    (T, TB), (want, wperm, wx) = ref_runs["gesv"]
    with cfg.override_scope(DD):
        F, perm, X = lu.gesv_1d(T, TB)
        r, ok = checks.check_axmb(T, TB, X)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, F.data) <= TOL and _rel(wx.data, X.data) <= TOL
    assert ok and r < 60


def _backward(T, F, perm):
    """max|A[perm] − L U| / (max|A| · N · eps64), in numpy float64."""
    a = T.pad_diag().data.numpy()
    f = F.data.numpy()
    L = np.tril(f, -1) + np.eye(f.shape[0])
    return np.abs(a[perm.numpy()] - L @ np.triu(f)).max() / (
        np.abs(a).max() * a.shape[0] * EPS)


@pytest.fixture(scope="module")
def many_panels():
    """The port at N=160, nb=16 (10 panels, past the reference's switch to
    its eager route) under lu.agg_depth 4 and 1 and lookahead 1 and 0,
    with the limb products each run routed to K2."""
    _, T = _pair(160, 16)
    out = {}
    for agg in (4, 1):
        for la in (1, 0):
            routed = pdd.ROUTED
            with cfg.override_scope({"dd_gemm": "always",
                                     "lu.agg_depth": str(agg),
                                     "sweep.lookahead": str(la)}):
                out[agg, la] = lu.getrf_1d(T), pdd.ROUTED - routed
    return T, out


def test_getrf_dd_agg_depth_flush_is_bitwise(many_panels):
    """The port's eager sweep applies per step whatever lu.agg_depth says
    (the reference's flush fuses dispatch in the same op order):
    lu.agg_depth 4 is torch.equal to lu.agg_depth 1 at either lookahead,
    and both make the ops/lu.py docstring's 10·KT − 9 K2 launches."""
    _, out = many_panels
    kt = 10
    for la in (1, 0):
        (F4, p4), _ = out[4, la]
        (F1, p1), _ = out[1, la]
        assert torch.equal(F4.data, F1.data) and torch.equal(p4, p1)
    assert out[4, 1][1] == out[1, 1][1] == 10 * kt - 9 == 91


def test_getrf_dd_lookahead_and_float64_residual(many_panels):
    """Lookahead 0 against 1 within 1e-12 (same perm), and the factor's
    backward error against numpy float64 under the -x threshold."""
    T, out = many_panels
    (F1, p1), _ = out[1, 1]
    (F0, p0), _ = out[1, 0]
    assert torch.equal(p0, p1)
    assert (F0.data - F1.data).abs().max() <= TOL * F1.data.abs().max()
    assert _backward(T, F1, p1) < 60


def test_getrf_dd_singular_column_stays_finite():
    """An exactly zero column: the factor stays finite with U's zero
    diagonal exact (the INFO contract), and A[perm] = L U still holds."""
    _, T = _pair(64, 32)
    T.data[:, 5] = 0.0
    with cfg.override_scope(DD):
        F, perm = lu.getrf_1d(T)
    assert torch.isfinite(F.data).all() and F.data[5, 5] == 0
    assert _backward(T, F, perm) < 60


def test_f32_never_takes_the_limb_route():
    """Under dd_gemm=always an f32 factorization routes nothing to K2."""
    _, T = _pair(96, 32)
    T32 = TileMatrix(T.data.float(), T.desc)
    routed = pdd.ROUTED
    with cfg.override_scope(DD):
        F, perm = lu.getrf_1d(T32)
        lu.gesv_1d(T32, T32)
    assert pdd.ROUTED == routed and F.dtype == torch.float32
    assert _backward(TileMatrix(T.data, T.desc), TileMatrix(
        F.data.double(), F.desc), perm) < 60 / EPS * 1e-5
