"""Port parity: the LU slice (``dplasma_tpu_torch.ops.lu`` and the
sweep engine ``ops._sweep``) against the JAX package, on the very same
padded input.

The reference runs its default ``chain`` route (the vendor LU) unless a
case says otherwise; the port runs each of its panel kernels. Gates:
the permutation bitwise equal, and max|ΔLU|/max|LU| <= 1e-4 for f32 and
1e-12 for f64 (the packages differ in rounding only). MCA-dependent
reference calls are traced inside the override scope, each through a
fresh ``jax.jit`` so no cached trace of another setting is replayed.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from dplasma_tpu.kernels import pallas_kernels as ref_pk
from dplasma_tpu.kernels import pallas_lu as ref_plu
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.kernels import pallas_lu as plu
from dplasma_tpu_torch.ops import _sweep, checks, generators
from dplasma_tpu_torch.ops import lu as port_lu
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"s": (jnp.float32, 1e-4), "d": (jnp.float64, 1e-12)}


def _pair(N, nb, jdt, diagdom=False, seed=3872):
    A = ref_gen.plrnt(N, N, nb, nb, seed=seed, dtype=jdt, diagdom=diagdom)
    T = TileMatrix.from_reference(np.asarray(A.data),
                                  dataclasses.asdict(A.desc), device="cpu")
    return A, T


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.numpy().astype(np.float64)
    return np.abs(want - got).max() / np.abs(want).max()


@contextlib.contextmanager
def _both(kv):
    with cfg.override_scope(kv), ref_cfg.override_scope(kv):
        yield


def _ref(fn, *args, mca=None):
    """``fn(*args)`` traced fresh under the reference MCA ``mca``."""
    with ref_cfg.override_scope(mca or {}):
        return jax.jit(lambda *a: fn(*a))(*args)


@functools.lru_cache(maxsize=None)
def _ref_getrf(N, nb, prec):
    A, _ = _pair(N, nb, DTYPES[prec][0])
    LU, perm = _ref(ref_lu.getrf_1d, A)
    return np.asarray(LU.data), np.asarray(perm)


@pytest.mark.parametrize("N", [96, 90])
@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("kind", ["chain", "rec", "pallas"])
def test_getrf_matches_reference_chain(N, prec, kind):
    jdt, tol = DTYPES[prec]
    want, wperm = _ref_getrf(N, 32, prec)
    _, T = _pair(N, 32, jdt)
    routed = plu.ROUTED
    with cfg.override_scope({"panel.kernel": kind}):
        LU, perm = port_lu.getrf_1d(T)
    # K3 takes the f32 panels only (its gate), the rest go to rec
    assert plu.ROUTED - routed == (3 if kind == "pallas" and prec == "s"
                                   else 0)
    assert LU.desc == T.desc and perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), wperm)
    assert _rel(want, LU.data) <= tol


@pytest.mark.parametrize("prec", ["s", "d"])
def test_calu_tournament_branch(prec):
    """Panels taller than lu.panel_chunk elect their pivots by CALU."""
    jdt, tol = DTYPES[prec]
    A, T = _pair(96, 16, jdt)
    mca = {"lu.panel_chunk": 32, "panel.kernel": "chain"}
    want, wperm = _ref(ref_lu.getrf_1d, A, mca=mca)
    with cfg.override_scope(mca):
        LU, perm = port_lu.getrf_1d(T)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, LU.data) <= tol


def test_calu_base_matches_reference_panel(rng):
    panel = rng.standard_normal((200, 16))
    want, wperm = _ref(lambda p: ref_lu._base_lu(p, 32, "chain"),
                       jnp.asarray(panel))
    got, gperm = port_lu._base_lu(torch.from_numpy(panel), 32, "chain")
    np.testing.assert_array_equal(gperm.numpy(), np.asarray(wperm))
    assert _rel(want, got) <= 1e-12


@pytest.mark.parametrize("panel_ib", [0, 8])
def test_getrf_rec_and_nested_panel_sweep(panel_ib):
    A, T = _pair(64, 32, jnp.float64)
    mca = {"lu.panel_ib": panel_ib}
    want, wperm = _ref(lambda a: ref_lu.getrf_rec(a, 8), A, mca=mca)
    with cfg.override_scope(mca):
        LU, perm = port_lu.getrf_rec(T, 8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, LU.data) <= 1e-12
    if panel_ib:     # lu.panel_ib nests the same sweep inside getrf_1d
        with cfg.override_scope(mca):
            LU1, perm1 = port_lu.getrf_1d(T)
        assert torch.equal(perm1, perm) and torch.equal(LU1.data, LU.data)


@pytest.mark.parametrize("kind,la", [("chain", 0), ("chain", 1),
                                     ("chain", 2), ("rec", 1)])
def test_getrf_nopiv_matches_reference(kind, la):
    A, T = _pair(90, 32, jnp.float64, diagdom=True)
    mca = {"panel.kernel": kind}
    want = _ref(lambda a: ref_lu.getrf_nopiv(a, lookahead=la), A, mca=mca)
    with cfg.override_scope(mca):
        got = port_lu.getrf_nopiv(T, lookahead=la)
    assert got.desc == T.desc
    assert _rel(want.data, got.data) <= 1e-12


@pytest.mark.parametrize("la", [0, 2])
def test_getrf_lookahead_only_regroups(la):
    _, T = _pair(90, 16, jnp.float64)
    base, bperm = port_lu.getrf_1d(T)
    with cfg.override_scope({"sweep.lookahead": la}):
        LU, perm = port_lu.getrf_1d(T)
    assert torch.equal(perm, bperm)
    assert torch.allclose(LU.data, base.data, rtol=0, atol=1e-12)


def test_pipelined_sweep_aggregated_flush_matches_per_step():
    """``agg_apply`` (a d-panel far flush) replaying the per-step applies
    gives the per-step sweep exactly."""
    _, T = _pair(80, 16, jnp.float64, diagdom=True)
    X = T.pad_diag().data

    def panel(col):
        d = port_lu.k.getrf_nopiv(col[:16])
        if col.shape[0] > 16:
            d = torch.cat([d, port_lu.k.trsm(d, col[16:], side="R",
                                              lower=False)])
        return d, d

    def apply(pan, blk):
        return port_lu._lu_apply_block(pan, blk, 16)

    def agg(states, far):
        tops = []
        for st in states:
            top, far = apply(st, far)
            tops.append(top)
        return tops, far

    want = _sweep.assemble_sweep(*_sweep.pipelined_sweep(
        X, 16, 5, 5, panel, apply, lookahead=1), 5, 5, 16)
    got = _sweep.assemble_sweep(*_sweep.pipelined_sweep(
        X, 16, 5, 5, panel, apply, lookahead=1, agg_depth=3,
        agg_apply=agg), 5, 5, 16)
    assert torch.equal(want, got)


@pytest.fixture(scope="module")
def solve_pair():
    N, nb, nrhs = 90, 32, 5
    A, T = _pair(N, nb, jnp.float64)
    B = ref_gen.plrnt(N, nrhs, nb, nb, seed=2354, dtype=jnp.float64)
    TB = TileMatrix.from_reference(np.asarray(B.data),
                                   dataclasses.asdict(B.desc), device="cpu")
    return A, T, B, TB


def test_gesv_and_getrs_n_match_reference(solve_pair):
    A, T, B, TB = solve_pair
    _, _, want = _ref(ref_lu.gesv_1d, A, B)
    LU, perm, X = port_lu.gesv_1d(T, TB)
    assert X.desc == TB.desc
    assert _rel(want.data, X.data) <= 1e-12
    r, ok = checks.check_axmb(T, TB, X)
    assert ok, r
    assert torch.equal(port_lu.getrs("N", LU, perm, TB).data, X.data)


@pytest.mark.parametrize("trans", ["T", "C"])
def test_getrs_transposed_matches_reference(solve_pair, trans):
    A, T, B, TB = solve_pair
    want = _ref(lambda a, b: ref_lu.getrs(trans, *ref_lu.getrf_1d(a), b),
                A, B)
    LU, perm = port_lu.getrf_1d(T)
    X = port_lu.getrs(trans, LU, perm, TB)
    assert _rel(want.data, X.data) <= 1e-12
    a, x, b = T.to_dense(), X.to_dense(), TB.to_dense()
    assert torch.allclose(a.T @ x, b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("inverse", [False, True])
def test_laswp_matches_reference(rng, solve_pair, inverse):
    A, T, _, _ = solve_pair
    perm = rng.permutation(T.desc.Mp)
    want = ref_lu.laswp(A, jnp.asarray(perm), inverse=inverse)
    got = port_lu.laswp(T, torch.from_numpy(perm), inverse=inverse)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    if inverse:
        back = port_lu.laswp(got, torch.from_numpy(perm))
        assert torch.equal(back.data, T.data)


def test_perm_ipiv_round_trips_match_reference(rng):
    for n in (1, 7, 50):
        perm = rng.permutation(n)
        ipiv = port_lu.perm_to_ipiv(torch.from_numpy(perm))
        np.testing.assert_array_equal(ipiv.numpy(),
                                      np.asarray(ref_lu.perm_to_ipiv(perm)))
        back = port_lu.ipiv_to_perm(ipiv)
        np.testing.assert_array_equal(back.numpy(), perm)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(ref_lu.ipiv_to_perm(ipiv.numpy())))


def test_dd_route_raises_for_f64():
    """Under dd_gemm=always every f64 LU entry point takes the limb route
    (each routes limb products to K2; parity with the reference is
    tests/test_torch_dd_lu.py); complex128 takes the plain pivoted sweep
    with its trsm and update products on the limb route (parity with the
    reference: tests/test_torch_complex_dd.py), agreeing with the native
    complex128 factorization, while the real-only ``lu_ir`` still
    raises; f32 never takes the limb route."""
    _, T = _pair(48, 16, jnp.float64)
    with cfg.override_scope({"dd_gemm": "always"}):
        for fn in (port_lu.getrf_1d, lambda a: port_lu.getrf_rec(a, 8),
                   lambda a: port_lu.gesv_1d(a, a),
                   lambda a: port_lu._panel_lu(a.data[:, :16])):
            routed = pdd.ROUTED
            fn(T)
            assert pdd.ROUTED > routed
        Z = TileMatrix(T.data.to(torch.complex128)
                       + 0.5j * T.data.flip(0), T.desc)
        routed = pdd.ROUTED
        F, perm = port_lu.getrf_1d(Z)
        assert pdd.ROUTED - routed == 12 * (2 * Z.desc.KT - 3)
        with pytest.raises(NotImplementedError, match="real f64 only"):
            port_lu._dd.lu_ir(Z.data[:, :16], Z.data[:, :16],
                              Z.data[:16, :16])
    Fn, permn = port_lu.getrf_1d(Z)
    assert torch.equal(perm, permn)
    assert (F.data - Fn.data).abs().max() <= 1e-12 * Fn.data.abs().max()
    with cfg.override_scope({"dd_gemm": "always"}):
        _, T32 = _pair(48, 16, jnp.float32)
        routed = pdd.ROUTED
        port_lu.getrf_1d(T32)          # f32 never takes the limb route
        assert pdd.ROUTED == routed


def test_against_reference_k3_route(monkeypatch):
    """The reference's own K3 (Pallas, interpret mode) on both sides."""
    monkeypatch.setattr(ref_plu, "x64_scope",
                        lambda e: contextlib.nullcontext())
    A, T = _pair(48, 16, jnp.float32)
    routed = plu.ROUTED
    with _both({"panel.kernel": "pallas"}):
        want, wperm = jax.jit(lambda a: ref_lu.getrf_1d(a))(A)
        LU, perm = port_lu.getrf_1d(T)
    assert plu.ROUTED - routed == 3
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, LU.data) <= 1e-4


def test_lu_pallas_panel_knob_routes_chain_panels_to_k3():
    _, T = _pair(48, 16, jnp.float32)
    routed = plu.ROUTED
    with cfg.override_scope({"panel.kernel": "chain",
                             "lu.pallas_panel": "on"}):
        LU, perm = port_lu.getrf_1d(T)
    assert plu.ROUTED - routed == 3
    base, bperm = port_lu.getrf_1d(T)
    assert torch.equal(perm, bperm)
    assert torch.allclose(LU.data, base.data, rtol=0, atol=1e-5)


@requires_pallas
def test_getrf_counts_with_k1_and_k3():
    """N=768, nb=256, K1 enabled on both sides (interpret mode on the
    reference side), K3 on the port's: every panel goes through K3 and
    all 2·3 − 3 Schur products through K1."""
    A, T = _pair(768, 256, jnp.float32)
    was_ref, was_port = ref_pk.enabled(), pk.enabled()
    ref_pk.enable(True)
    pk.enable(True)
    try:
        want, wperm = _ref(ref_lu.getrf_1d, A)
        k1, k3 = pk.ROUTED, plu.ROUTED
        with cfg.override_scope({"panel.kernel": "pallas"}):
            LU, perm = port_lu.getrf_1d(T)
        assert (pk.ROUTED - k1, plu.ROUTED - k3) == (3, 3)
    finally:
        ref_pk.enable(was_ref)
        pk.enable(was_port)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert _rel(want.data, LU.data) <= 1e-4
    B = generators.plrnt(768, 1, 256, 256, seed=5, device="cpu")
    r, ok = checks.check_axmb(T, B, port_lu.getrs("N", LU, perm, B))
    assert ok, r
