"""Port parity: the stage-2 band module (``ops/band.py``) and the band
descriptor against the reference, on the very same numpy inputs.

* Every schedule table (the pipelined SBR sweeps' dense-layout,
  bidiagonal and band-storage tables, both Givens chase schedules) is
  ``np.array_equal`` to the reference's, dtypes included, over a grid of
  (N, b, w), tall and wide.
* The storage helpers (the shear pair, full-band storage, lower-band
  storage and back, ``BandMatrix``) are bitwise the reference's.
* Each sweep on a random band at N = 70 (not a multiple of anything),
  b = 16, in s/d/c/z: the Hermitian band-storage scan, one dense-layout
  Hermitian sweep, the bidiagonal scan on square, tall (70×50) and wide
  (50×70) bands; each Givens chase (both Hermitian ones, the
  bidiagonal one square, tall and wide) at N = 40, one small eager
  step per rotation. Tolerances, relative to the largest entry: the (d, e) and the
  swept arrays within 1e-9 (d/z) and 2e-3 (s/c) — rotations accumulate
  rounding in another order in each package, and d, e are not a stable
  function of the input — and the spectra of the tridiagonal /
  singular values of the bidiagonal within 1e-12 (d/z) and 1e-4 (s/c)
  of the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu import descriptors as ref_desc
from dplasma_tpu.ops import band as rb
from dplasma_tpu_torch import descriptors
from dplasma_tpu_torch.kernels import sbr
from dplasma_tpu_torch.ops import band
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DT = {"s": np.float32, "d": np.float64, "c": np.complex64,
      "z": np.complex128}
TOL = {"s": 2e-3, "c": 2e-3, "d": 1e-9, "z": 1e-9}
SPEC = {"s": 1e-4, "c": 1e-4, "d": 1e-12, "z": 1e-12}
N, B = 70, 16
NC = 40            # the Givens chases: one small launch per rotation


def _rand(rng, shape, prec):
    a = rng.standard_normal(shape)
    if prec in "cz":
        a = a + 1j * rng.standard_normal(shape)
    return a


def _herm_band(prec, n=N, b=B, seed=0):
    a = np.tril(np.triu(_rand(np.random.default_rng(seed), (n, n), prec),
                        -b))
    return (a + a.conj().T).astype(DT[prec])


def _upper_band(prec, m, n, b=B, seed=1):
    a = _rand(np.random.default_rng(seed), (m, n), prec)
    return np.triu(np.tril(a, b)).astype(DT[prec])


def _close(got, want, prec, tol=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.max(np.abs(want)), 1.0) if want.size else 1.0
    assert np.max(np.abs(got - want), initial=0.0) <= (tol or TOL[prec]) \
        * scale


def _tridiag_spectrum(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))


def _bidiag_svals(d, e, M, Nn):
    K = min(M, Nn)
    Bm = np.zeros((K, K + (1 if M < Nn else 0)))
    Bm[np.arange(K), np.arange(K)] = np.asarray(d, np.float64)
    e = np.asarray(e, np.float64)
    Bm[np.arange(e.size), np.arange(e.size) + 1] = e
    return np.linalg.svd(Bm, compute_uv=False)


def _same_spectrum(got, want, prec):
    scale = max(np.max(np.abs(want)), 1.0)
    assert np.max(np.abs(np.sort(got) - np.sort(want))) <= SPEC[prec] * scale


# -------------------------------------------------------------- tables

GRID = [(n, b) for n in (3, 17, 40, 97, 256) for b in (2, 4, 8, 16, 33)]


def _ws(b):
    return sorted({w for w in (1, max(1, b // 4), max(1, b // 8))
                   if 1 <= w <= b // 4 or (b <= 4 and w == 1)})


def _equal(want, got):
    if want is None:
        return got is None
    return len(want) == len(got) and all(
        np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
        and type(x) is type(y) for x, y in zip(want, got))


@pytest.mark.parametrize("n,b", GRID)
def test_sweep_schedules_equal_the_reference(n, b):
    for w in _ws(b):
        assert _equal(rb._sbr_schedule(n, b, w), band._sbr_schedule(n, b, w))
        for wide in (False, True):
            assert _equal(rb._sbr_schedule_bidiag(n, b, w, wide),
                          band._sbr_schedule_bidiag(n, b, w, wide))
        if 4 * b - w >= 3 * b + w:
            assert _equal(rb._sbr_banded_schedule(n, b, w),
                          band._sbr_banded_schedule(n, b, w))


@pytest.mark.parametrize("n,b", GRID)
def test_chase_schedules_equal_the_reference(n, b):
    assert _equal((rb.herm_chase_schedule(n, b),),
                  (band.herm_chase_schedule(n, b),))
    for m in (n, max(n // 2, 1), 2 * n):
        assert _equal((rb.bidiag_chase_schedule(m, n, b),),
                      (band.bidiag_chase_schedule(m, n, b),))


def test_large_banded_schedule_equals_the_reference_and_is_cached():
    want = rb._sbr_banded_schedule(3000, 4, 1)
    got = band._sbr_banded_schedule(3000, 4, 1)
    assert _equal(want, got)
    assert band._sbr_banded_schedule(3000, 4, 1) is got


def test_schedule_caches_are_bounded():
    """Each builder keeps its SCHEDULES_KEPT most recent schedules (at
    least one chain's sweeps) and no more."""
    builders = (band.herm_chase_schedule, band._sbr_schedule,
                band._sbr_schedule_bidiag, band._sbr_banded_schedule,
                band.bidiag_chase_schedule)
    for f in builders:
        assert f.cache_info().maxsize == band.SCHEDULES_KEPT
    assert band.SCHEDULES_KEPT >= len(band.sweep_ladder(511))
    for n in range(40, 40 + band.SCHEDULES_KEPT + 3):
        band._sbr_banded_schedule(n, 4, 1)
    assert band._sbr_banded_schedule.cache_info().currsize == \
        band.SCHEDULES_KEPT


# ------------------------------------------------------------- storage

def test_shear_pair_is_bitwise_the_reference():
    x = np.random.default_rng(2).standard_normal((3, 7, 11))
    y_ref = np.asarray(rb._shear_fwd(jnp.asarray(x), 11))
    y = band._shear_fwd(torch.from_numpy(x), 11)
    np.testing.assert_array_equal(y.numpy(), y_ref)
    back_ref = np.asarray(rb._shear_bwd(jnp.asarray(y_ref), 11))
    back = band._shear_bwd(y, 11)
    np.testing.assert_array_equal(back.numpy(), back_ref)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("prec", ["d", "z"])
def test_band_storage_helpers_are_bitwise_the_reference(prec):
    h = _herm_band(prec)
    D, L0, Nc = 2 * B + 4, 5, N + 60
    np.testing.assert_array_equal(
        band._band_full(torch.from_numpy(h), N, D, L0, Nc).numpy(),
        np.asarray(rb._band_full(jnp.asarray(h), N, D, L0, Nc)))
    for margin in (0, 3):
        S_ref = np.asarray(rb.to_lower_band(jnp.asarray(h), B + 1, N,
                                            margin))
        S = band.to_lower_band(torch.from_numpy(h), B + 1, N, margin)
        np.testing.assert_array_equal(S.numpy(), S_ref)
    np.testing.assert_array_equal(
        band.lower_band_to_dense(S, N).numpy(),
        np.asarray(rb.lower_band_to_dense(jnp.asarray(S_ref), N)))


@pytest.mark.parametrize("kl,ku", [(0, 3), (4, 0), (2, 5)])
def test_band_matrix_round_trip_is_the_reference(kl, ku):
    a = np.random.default_rng(3).standard_normal((9, 12))
    ref = ref_desc.BandMatrix.from_dense(jnp.asarray(a), kl, ku)
    got = descriptors.BandMatrix.from_dense(torch.from_numpy(a), kl, ku)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(ref.to_dense()))
    for off in range(-kl, ku + 1):
        np.testing.assert_array_equal(got.diagonal(off).numpy(),
                                      np.asarray(ref.diagonal(off)))


# -------------------------------------------------------------- sweeps

PRECS = ["s", "d", "c", "z"]


@pytest.mark.parametrize("prec", PRECS)
def test_herm_scan_matches_the_reference(prec):
    h = _herm_band(prec)
    sbr.reset_counts()
    d, e = band.herm_band_to_tridiag_scan(torch.from_numpy(h), N, B)
    # 16 -> 4 -> 1: both sweeps through the KW wrapper (its plain
    # version on the CPU, step by step), one call per sweep
    sweeps = len(band.sweep_ladder(B))
    assert (sbr.ROUTED, sbr.LAUNCHES, sbr.STEPS) == (sweeps, 0, 0)
    d0, e0 = rb.herm_band_to_tridiag_scan(jnp.asarray(h), N, B)
    _close(d, d0, prec)
    _close(e, e0, prec)
    _same_spectrum(_tridiag_spectrum(d, e), _tridiag_spectrum(d0, e0), prec)


@pytest.mark.parametrize("prec", PRECS)
def test_dense_herm_sweep_matches_the_reference(prec):
    h = _herm_band(prec)
    got = band.herm_sbr_sweep(torch.from_numpy(h), N, B, 4)
    _close(got, rb.herm_sbr_sweep(jnp.asarray(h), N, B, 4), prec)


@pytest.mark.parametrize("prec", PRECS)
def test_herm_chases_match_the_reference(prec):
    h = _herm_band(prec, n=NC)
    d, e = band.herm_band_to_tridiag(torch.from_numpy(h), NC, B)
    d0, e0 = rb.herm_band_to_tridiag(jnp.asarray(h), NC, B)
    _close(d, d0, prec)
    _close(e, e0, prec)
    S = band.to_lower_band(torch.from_numpy(h), B + 1, NC)
    d, e = band.herm_band_to_tridiag_banded(S, NC, B)
    d1, e1 = rb.herm_band_to_tridiag_banded(jnp.asarray(S.numpy()), NC, B)
    _close(d, d1, prec)
    _close(e, e1, prec)
    _same_spectrum(_tridiag_spectrum(d, e), np.linalg.eigvalsh(h), prec)


SHAPES = [(N, N), (N, 50), (50, N)]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("m,n", SHAPES)
def test_bidiag_scan_matches_the_reference(prec, m, n):
    a = _upper_band(prec, m, n)
    d, e = band.bidiag_band_to_bidiag_scan(torch.from_numpy(a), m, n, B)
    d0, e0 = rb.bidiag_band_to_bidiag_scan(jnp.asarray(a), m, n, B)
    _close(d, d0, prec)
    _close(e, e0, prec)
    _same_spectrum(_bidiag_svals(d, e, m, n),
                   np.linalg.svd(a, compute_uv=False), prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("m,n", [(NC, NC), (NC, 30), (30, NC)])
def test_bidiag_chase_matches_the_reference(prec, m, n):
    a = _upper_band(prec, m, n)
    d, e = band.bidiag_band_to_bidiag(torch.from_numpy(a), m, n, B)
    d0, e0 = rb.bidiag_band_to_bidiag(jnp.asarray(a), m, n, B)
    _close(d, d0, prec)
    _close(e, e0, prec)
    _same_spectrum(_bidiag_svals(d, e, m, n),
                   np.linalg.svd(a, compute_uv=False), prec)


def test_forced_routes_agree():
    """The batched torch route and the KW wrapper (its plain version
    here) are one computation on the CPU: the sweeps' ``route`` switch
    gives equal storage."""
    h = _herm_band("d")
    X = torch.from_numpy(h)
    dk, ek = band.herm_band_to_tridiag_scan(X, N, B)
    dp, ep = band.herm_band_to_tridiag_scan(
        X, N, B, sweep=lambda *a: band.herm_sbr_sweep_banded(*a,
                                                             route="plain"))
    assert torch.equal(dk, dp) and torch.equal(ek, ep)
    a = torch.from_numpy(_upper_band("d", N, 50))
    for b, w in band.sweep_ladder(B):
        assert torch.equal(band.bidiag_sbr_sweep(a, N, 50, b, w),
                           band.bidiag_sbr_sweep(a, N, 50, b, w, "plain"))
        a = band.bidiag_sbr_sweep(a, N, 50, b, w)


def test_wide_blocks_factor_live_windows_one_at_a_time(monkeypatch):
    """From b = LOOP_QR_MIN_B the batched route factors each live
    window's block with its own 2-D geqrf (the dead ones are the
    identity): the same sweep as one batched geqrf over every slot."""
    a = torch.from_numpy(_upper_band("d", 300, 300, b=127, seed=4))
    h = torch.from_numpy(_herm_band("d", n=300, b=127, seed=5))
    assert 127 >= band.LOOP_QR_MIN_B
    plain = functools.partial(band.herm_sbr_sweep_banded, route="plain")
    got_b = band.bidiag_sbr_sweep(a, 300, 300, 127, 31, "plain")
    got_h = band.herm_band_to_tridiag_scan(h, 300, 127, sweep=plain)
    monkeypatch.setattr(band, "LOOP_QR_MIN_B", 10 ** 6)
    want_b = band.bidiag_sbr_sweep(a, 300, 300, 127, 31, "plain")
    want_h = band.herm_band_to_tridiag_scan(h, 300, 127, sweep=plain)
    assert float((got_b - want_b).abs().max()) <= 1e-12 * float(
        want_b.abs().max())
    for g, w in zip(got_h, want_h):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


def _herm_first_sweep(h, n, b, w):
    """One band-storage sweep b -> w of the dense Hermitian h, back to
    dense (F[L0 + c, D + r - c] = X[r, c])."""
    _, _, _, _, S, _, L0, hi = band._sbr_banded_schedule(n, b, w)
    D = 2 * b + w
    F = band._band_full(h, n, D, L0, L0 + max(hi, n) + S)
    band.herm_sbr_sweep_banded(F, n, b, w, D, L0)
    r = torch.arange(n)[:, None]
    c = torch.arange(n)[None, :]
    k = (r - c).clamp(-D, D)
    return torch.where((r - c).abs() <= D, F[L0 + c, D + k],
                       torch.zeros((), dtype=F.dtype))


@pytest.mark.parametrize("b", [256, 511])
def test_k1_window_route_matches_the_batched_route(b):
    """With K1 on, a sweep whose window products pass its gate runs each
    live window's products as 2-D operands (zero-padded to 16-byte
    rows): seven per Hermitian window, four per bidiagonal one, routed
    to K1 (its plain version on the CPU). One sweep b -> b/4 each way:
    the swept matrices' spectra equal the batched route's and the
    input's."""
    from dplasma_tpu_torch.kernels import pallas_kernels as pk
    n, w = 640, b // 4
    h = torch.from_numpy(_herm_band("s", n=n, b=b, seed=6))
    a = torch.from_numpy(_upper_band("s", n, n, b=b, seed=7))
    pk.enable(True)
    try:
        pk.reset_counts()
        got_h = _herm_first_sweep(h, n, b, w)
        live_h = int((band._sbr_banded_schedule(n, b, w)[1] > 0).sum())
        assert pk.ROUTED == 7 * live_h
        pk.reset_counts()
        got_b = band.bidiag_sbr_sweep(a, n, n, b, w)
        live_b = int((band._sbr_schedule_bidiag(n, b, w, False)[1] > 0).sum())
        assert pk.ROUTED == 4 * live_b
    finally:
        pk.enable(False)
    want_h = _herm_first_sweep(h, n, b, w)
    want_b = band.bidiag_sbr_sweep(a, n, n, b, w)
    ev = [np.linalg.eigvalsh(x.double().numpy()) for x in (got_h, want_h)]
    _same_spectrum(ev[0], ev[1], "s")
    _same_spectrum(ev[0], np.linalg.eigvalsh(h.double().numpy()), "s")
    sv = [np.linalg.svd(x.double().numpy(), compute_uv=False)
          for x in (got_b, want_b)]
    _same_spectrum(sv[0], sv[1], "s")
    _same_spectrum(sv[0], np.linalg.svd(a.double().numpy(),
                                        compute_uv=False), "s")
