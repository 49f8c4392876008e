"""KW's sweep-at-once interface on the CPU (``kernels/sbr.py``, the
``kw`` route of ``ops/band.py``).

On a CPU tensor the wrappers run the plain version step by step, so
these tests hold what the CUDA launch relies on and the CPU can show:
a step range [t0, t1) is the same computation as its steps one at a
time (bitwise), the device tables equal the host schedules (the
Hermitian sweep's bases included) and bound the windows they address,
every sweep of the drivers' default ladders with b <= 128 is routed to
KW in every dtype (K1 kept for f32 b >= 256), the launch plans fit an
H100's shared memory in at most 4 CTAs and an oversize window is
refused, and the chains through the forced ``kw`` route agree with the
JAX reference (spectra within 1e-4 s/c and 1e-12 d/z relative to the
largest, as ``tests/test_torch_band.py`` holds them: the swept (d, e)
are not a stable function of the input).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import band as rb
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.kernels import sbr
from dplasma_tpu_torch.ops import band
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DT = {"s": np.float32, "d": np.float64, "c": np.complex64,
      "z": np.complex128}
TORCH = {"s": torch.float32, "d": torch.float64, "c": torch.complex64,
         "z": torch.complex128}
SPEC = {"s": 1e-4, "c": 1e-4, "d": 1e-12, "z": 1e-12}
PRECS = ["s", "d", "c", "z"]
#: the drivers' default ladders at nb = 256: (kind, b, w) of each sweep
LADDERS = {"herm": band.sweep_ladder(256), "bidiag": band.sweep_ladder(511)}


def _rand(rng, shape, prec):
    a = rng.standard_normal(shape)
    if prec in "cz":
        a = a + 1j * rng.standard_normal(shape)
    return a


def _herm_case(prec, n, b, w, seed):
    """Random band storage of one Hermitian sweep's geometry, with its
    geometry and (CPU) tables."""
    base, us, T, G, S, V, L0, hi = band._sbr_banded_schedule(n, b, w)
    D = 2 * b + w
    H = 2 * D + 1
    rng = np.random.default_rng(seed)
    F = torch.from_numpy(_rand(rng, (L0 + max(hi, n) + S, H), prec)
                         .astype(DT[prec]))
    geom = sbr.HermGeom(G, S, V, b, H, D)
    return F, T, geom, sbr.herm_tabs(base + L0, us, geom, "cpu")


def _bidiag_case(prec, n, b, w, seed):
    K = n
    c0s, us, offs, T, G, V, park0 = band._sbr_schedule_bidiag(K, b, w, False)
    lim = park0 + G * V
    X = torch.zeros((max(lim, n), max(lim, n)), dtype=TORCH[prec])
    rng = np.random.default_rng(seed)
    X[:n, :n] = torch.from_numpy(_rand(rng, (n, n), prec).astype(DT[prec]))
    geom = sbr.BidiagGeom(G, V, b, X.shape[1])
    return X, T, geom, sbr.bidiag_tabs(c0s, us, offs, geom, "cpu")


def _size(b):
    return 300 if b > 32 else 120


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("kind,b,w", [("herm", 4, 1), ("herm", 16, 4),
                                      ("herm", 64, 16), ("herm", 127, 31),
                                      ("bidiag", 4, 1), ("bidiag", 16, 4),
                                      ("bidiag", 64, 16),
                                      ("bidiag", 127, 31)])
def test_step_range_is_bitwise_its_steps(prec, kind, b, w):
    """A range [t0, t1) of the wrapper, split anywhere, is bitwise the
    plain steps one at a time; a window KW refuses (a Hermitian window
    larger than one block) raises instead."""
    n = _size(b)
    if kind == "herm":
        X, T, geom, tabs = _herm_case(prec, n, b, w, b)
        steps, step = sbr.herm_steps, sbr.herm_step

        def plain(Y, t):
            sbr.herm_step_reference(Y, int(tabs.base[t]), tabs.u[t], geom)
    else:
        X, T, geom, tabs = _bidiag_case(prec, n, b, w, b)
        steps, step = sbr.bidiag_steps, sbr.bidiag_step

        def plain(Y, t):
            sbr.bidiag_step_reference(Y, tabs.c0[t], tabs.u[t], tabs.off[t],
                                      geom, t % 2 == 1)
    if not sbr.eligible(b, geom.V, X.dtype, kind):
        assert kind == "herm" and prec != "s"
        with pytest.raises(ValueError, match="refuses"):
            steps(X, tabs, 0, T, geom)
        return
    ref, one, split = X.clone(), X.clone(), X.clone()
    for t in range(T):
        plain(ref, t)
        step(one, tabs, t, geom)
    k = T // 3
    sbr.reset_counts()
    steps(split, tabs, 0, k, geom)
    steps(split, tabs, k, T, geom)
    assert (sbr.ROUTED, sbr.LAUNCHES, sbr.STEPS) == (2, 0, 0)
    assert torch.equal(one, ref) and torch.equal(split, ref)
    assert not torch.equal(ref, X)


@pytest.mark.parametrize("n,b,w", [(40, 4, 1), (97, 16, 4), (300, 64, 16),
                                   (300, 127, 31)])
def test_device_tables_are_the_host_schedules(n, b, w):
    """herm_tabs / bidiag_tabs hold the schedules' numbers (the Hermitian
    bases, shifted by L0, as int64; the rest int32) and their ``rows``
    span every window the sweep addresses."""
    base, us, T, G, S, V, L0, hi = band._sbr_banded_schedule(n, b, w)
    D = 2 * b + w
    geom = sbr.HermGeom(G, S, V, b, 2 * D + 1, D)
    tabs = sbr.herm_tabs(base + L0, us, geom, "cpu")
    assert tabs.base.dtype == torch.int64 and tabs.u.dtype == torch.int32
    assert np.array_equal(tabs.base.numpy(), base + L0)
    assert np.array_equal(tabs.u.numpy(), us)
    first = base + L0
    lo, hi_rows = tabs.rows
    assert lo == first.min() >= 0
    assert hi_rows == first.max() + (G - 1) * S + V <= L0 + hi
    c0s, ub, offs, Tb, Gb, Vb, park0 = band._sbr_schedule_bidiag(n, b, w,
                                                                 False)
    bg = sbr.BidiagGeom(Gb, Vb, b, park0 + Gb * Vb)
    bt = sbr.bidiag_tabs(c0s, ub, offs, bg, "cpu")
    for got, want in ((bt.c0, c0s), (bt.u, ub), (bt.off, offs)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert np.array_equal(got.numpy(), want)
    assert bt.rows == (c0s.min(), c0s.max() + Vb)
    assert bt.rows[1] <= park0 + Gb * Vb


@pytest.mark.parametrize("prec", PRECS)
def test_default_ladders_route_to_kw(prec):
    """With K1 on, every sweep of the default ladders with b <= 128 takes
    the ``kw`` route in every dtype; the 256- and 511-wide sweeps take K1
    in f32 (the reference's gate) and the plain route otherwise."""
    dt = TORCH[prec]
    was = pk.enabled()
    pk.enable(True)
    try:
        for kind, ladder in LADDERS.items():
            for b, w in ladder:
                route = band._route("auto", b, dt, 3 * b + w, kind)
                if b <= sbr.MAX_B:
                    assert route == "kw", (kind, b, prec)
                else:
                    assert route == ("k1" if prec == "s" else "plain")
                assert band._route("plain", b, dt, 3 * b + w, kind) == \
                    "plain"
    finally:
        pk.enable(was)


def test_plans_fit_the_card_and_refuse_oversize_windows():
    """Every default-ladder sweep KW takes fits at most 4 CTAs of at most
    227 KB (b = 127 bidiagonal: 1 CTA f32, 2 f64/c64, 4 c128; the
    Hermitian 64-wide window one block, 213 KB in c128; hbrdt's 127-wide
    Hermitian window one block of 416 threads, 218 KB, in f32 only); a
    b <= 8 sweep runs one warp a window where ``WARP_FORM`` lists its
    (kind, b, dtype), else one block; the plan's bytes are the kernel's
    sum; b > 128, a Hermitian window past one block and a type KW does
    not take are refused."""
    want127 = {"s": 1, "d": 2, "c": 2, "z": 4}
    for prec in PRECS:
        dt = TORCH[prec]
        isz = torch.empty((), dtype=dt).element_size()
        for kind, ladder in LADDERS.items():
            for b, w in ladder:
                V = 3 * b + w
                n = sbr.eligible(b, V, dt, kind)
                if b > sbr.MAX_B:
                    assert n == 0
                    continue
                pl = sbr.plan(b, V, dt, kind)
                assert 1 <= n == pl.ncta <= 4 and pl.smem <= sbr.SMEM_MAX
                assert pl.smem <= 227 * 1024
                LS, E = sbr.line_stride(b, dt), 16 // isz
                assert LS >= b and LS % E == 0 and (LS // E) % 2 == 1
                if pl.form == "warp":
                    assert b <= sbr.WARP_MAX_B
                    assert pl.smem == pl.wpb * (V * LS + -(-b // E) * E) \
                        * isz
                    assert pl.threads == 32 * pl.wpb
                elif pl.form == "block":
                    assert pl.smem == (V * LS + b) * isz
                else:
                    P = -(-V // pl.ncta)
                    assert pl.smem == (P * LS + LS + b + 1) * isz
                    assert kind == "bidiag"
                assert pl.threads % 32 == 0 and pl.threads <= 512
                if b == 127:
                    assert n == want127[prec]
                if kind == "herm" and b == 64:
                    assert pl.form == "block"
                # the narrow sweeps take either form, the other forced
                if b <= sbr.WARP_MAX_B:
                    want = "warp" if (kind, b, dt) in sbr.WARP_FORM \
                        else "block"
                    assert pl.form == want
                    for f in ("warp", "block"):
                        assert sbr.plan(b, V, dt, kind, f).form == f
                else:
                    assert pl.form != "warp"
    assert sbr.plan(64, 208, torch.complex128, "herm").smem == 217344
    assert sbr.plan(127, 412, torch.float32, "herm") == sbr.Plan(
        "block", 1, 416, 1, 218044)
    for dt in (torch.float64, torch.complex64, torch.complex128):
        assert sbr.eligible(127, 412, dt, "herm") == 0
    assert all(k == "herm" and b <= sbr.WARP_MAX_B
               for k, b, _ in sbr.WARP_FORM)
    assert sbr.plan(7, 22, torch.float32, "herm").form == "block"
    assert sbr.eligible(129, 3 * 129 + 32, torch.float32, "bidiag") == 0
    assert sbr.eligible(100, 325, torch.float64, "herm") == 0
    assert sbr.eligible(100, 325, torch.float64, "bidiag") == 2
    assert sbr.eligible(16, 52, torch.bfloat16, "herm") == 0


def _herm_chain(h, n, b, route):
    return band.herm_band_to_tridiag_scan(
        torch.from_numpy(h), n, b,
        sweep=functools.partial(band.herm_sbr_sweep_banded, route=route))


def _spectrum(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))


def _svals(d, e, n):
    Bm = np.diag(np.asarray(d, np.float64))
    Bm[np.arange(n - 1), np.arange(1, n)] = np.asarray(e, np.float64)
    return np.linalg.svd(Bm, compute_uv=False)


def _same(got, want, prec):
    scale = max(np.max(np.abs(want)), 1.0)
    assert np.max(np.abs(np.sort(got) - np.sort(want))) <= SPEC[prec] * scale


@pytest.mark.parametrize("prec", ["s", "z"])
def test_forced_kw_chains_match_the_reference(prec):
    """The Hermitian chain 64 -> 16 -> 4 -> 1 and the bidiagonal chain
    127 -> 31 -> 7 -> 1 through the forced ``kw`` route: one wrapper
    call a sweep, and the spectra of the JAX reference's chains."""
    n = 150
    rng = np.random.default_rng(15)
    a = np.tril(np.triu(_rand(rng, (n, n), prec), -64))
    h = (a + a.conj().T).astype(DT[prec])
    sbr.reset_counts()
    d, e = _herm_chain(h, n, 64, "kw")
    assert sbr.ROUTED == 3
    d0, e0 = rb.herm_band_to_tridiag_scan(jnp.asarray(h), n, 64)
    _same(_spectrum(d, e), _spectrum(d0, e0), prec)
    _same(_spectrum(d, e), np.linalg.eigvalsh(h.astype(np.complex128)), prec)
    g = np.triu(np.tril(_rand(rng, (n, n), prec), 127)).astype(DT[prec])
    sbr.reset_counts()
    d, e = band.bidiag_band_to_bidiag_scan(
        torch.from_numpy(g), n, n, 127,
        sweep=functools.partial(band.bidiag_sbr_sweep, route="kw"))
    assert sbr.ROUTED == 3
    d0, e0 = rb.bidiag_band_to_bidiag_scan(jnp.asarray(g), n, n, 127)
    _same(_svals(d, e, n), _svals(d0, e0, n), prec)
    _same(_svals(d, e, n), np.linalg.svd(g, compute_uv=False), prec)
