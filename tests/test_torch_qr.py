"""Port parity: the QR slice (``dplasma_tpu_torch.ops.qr`` and its
checks) against the JAX package, on the very same padded input.

Each ``panel.kernel`` route of the port is held against the same route
of the reference: ``chain`` (the vendor geqrf), ``tree`` (TSQR + the
Householder reconstruction) and ``pallas`` (K4's plain version on the
port's side, the reference's Pallas kernel in interpret mode on the
other). The routes are not compared with one another: the fused kernel
follows the reference's reflector rule, which reflects a column with
nothing below its diagonal (tau = 2) where LAPACK does not.

Gates: max|Δ|/max|x| <= 1e-4 for f32 and 1e-10 for f64, on the packed
factor and on T (the packages differ in summation order only).
MCA-dependent reference calls are traced inside the override scope,
each through a fresh ``jax.jit``.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import pallas_qr as ref_pqr
from dplasma_tpu.ops import checks as ref_checks
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.kernels import pallas_qr as pqr
from dplasma_tpu_torch.ops import checks, generators
from dplasma_tpu_torch.ops import qr
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"s": (jnp.float32, 1e-4), "d": (jnp.float64, 1e-10)}


def _tm(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc), device="cpu")


def _pair(M, N, nb, jdt, seed=3872):
    A = ref_gen.plrnt(M, N, nb, nb, seed=seed, dtype=jdt)
    return A, _tm(A)


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.numpy().astype(np.float64)
    return np.abs(want - got).max() / np.abs(want).max()


def _ref(fn, *args, mca=None):
    """``fn(*args)`` traced fresh under the reference MCA ``mca``."""
    with ref_cfg.override_scope(mca or {}):
        return jax.jit(lambda *a: fn(*a))(*args)


@pytest.fixture
def ref_pallas(monkeypatch):
    """The reference's public ``geqrt_panel`` runs under this jax only
    with its ``x64_scope`` made a null context."""
    monkeypatch.setattr(ref_pqr, "x64_scope",
                        lambda e: contextlib.nullcontext())


@functools.lru_cache(maxsize=None)
def _ref_geqrf(M, N, nb, prec, kind, la=None, agg=None):
    A, _ = _pair(M, N, nb, DTYPES[prec][0])
    mca = {"panel.kernel": kind}
    Af, Tf = _ref(lambda a: ref_qr.geqrf(a, lookahead=la, agg_depth=agg),
                  A, mca=mca)
    Q = jax.jit(ref_qr.ungqr)(Af, Tf)
    return np.asarray(Af.data), np.asarray(Tf.data), np.asarray(Q.data)


def _check_geqrf(M, N, nb, prec, kind, la=None, agg=None):
    """The port's geqrf on route ``kind`` against the reference's, and
    the Q that ``ungqr`` forms from each."""
    jdt, tol = DTYPES[prec]
    want, wT, wQ = _ref_geqrf(M, N, nb, prec, kind, la, agg)
    _, T = _pair(M, N, nb, jdt)
    with cfg.override_scope({"panel.kernel": kind}):
        Af, Tf = qr.geqrf(T, lookahead=la, agg_depth=agg)
    assert Af.desc == T.desc and Af.dtype == T.dtype
    assert tuple(Tf.data.shape) == wT.shape
    assert _rel(want, Af.data) <= tol
    assert _rel(wT, Tf.data) <= tol
    Q = qr.ungqr(Af, Tf)
    assert _rel(wQ, Q.data) <= tol
    return T, Af, Tf, Q.to_dense()


@pytest.mark.parametrize("M,N", [(96, 96), (100, 100), (130, 90),
                                 (90, 130)])
@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_geqrf_matches_reference_route(M, N, prec, kind):
    T, Af, Tf, Q = _check_geqrf(M, N, 32, prec, kind)
    R = torch.triu(Af.to_dense()[:min(M, N), :])
    assert checks.check_qr(T, Q, R)[1]
    assert checks.check_orthogonality(Q)[1]


@pytest.mark.parametrize("M,N", [(96, 96), (100, 100), (130, 90)])
def test_geqrf_pallas_route_matches_reference_kernel(ref_pallas, M, N):
    """K4's plain version against the reference's Pallas kernel, every
    eligible panel of the sweep; the ragged and square cases put the
    tau = 2 columns on the path."""
    routed = pqr.ROUTED
    T, Af, Tf, Q = _check_geqrf(M, N, 32, "s", "pallas")
    assert pqr.ROUTED - routed == T.desc.KT
    R = torch.triu(Af.to_dense()[:min(M, N), :])
    assert checks.check_qr(T, Q, R)[1]
    assert checks.check_orthogonality(Q)[1]


def test_geqrf_pallas_route_on_f64_takes_the_tree():
    """K4 is f32 only: an f64 panel fails its gate and goes to the TSQR
    tree, in both packages."""
    routed = pqr.ROUTED
    _check_geqrf(100, 100, 32, "d", "pallas")
    assert pqr.ROUTED == routed


@pytest.mark.parametrize("la,agg", [(0, 1), (0, 4), (1, 1), (1, 4),
                                    (2, 1), (2, 4)])
def test_geqrf_pipeline_shapes_match_reference(la, agg):
    _check_geqrf(136, 136, 16, "d", "chain", la, agg)


def test_geqrf_pipeline_shapes_agree_with_each_other():
    _, T = _pair(136, 136, 16, jnp.float64)
    base = qr.geqrf(T, lookahead=0, agg_depth=1)
    for la, agg in ((1, 4), (2, 2)):
        got = qr.geqrf(T, lookahead=la, agg_depth=agg)
        for b, g in zip(base, got):
            assert torch.allclose(b.data, g.data, rtol=0, atol=1e-12)


@pytest.mark.parametrize("N,hnb", [(96, 8), (100, 16), (64, 0)])
def test_geqrf_rec_matches_reference(N, hnb):
    A, T = _pair(N, N, 32, jnp.float64)
    want, wT = _ref(lambda a: ref_qr.geqrf_rec(a, hnb), A)
    got, gT = qr.geqrf_rec(T, hnb)
    assert _rel(want.data, got.data) <= 1e-10
    assert _rel(wT.data, gT.data) <= 1e-10


def test_geqrt_rec_panel_matches_reference(rng):
    a = rng.standard_normal((70, 24))
    want = jax.jit(lambda x: ref_qr.geqrt_rec(x, 8))(jnp.asarray(a))
    got = qr.geqrt_rec(torch.from_numpy(a), 8)
    for w, g in zip(want, got):
        assert _rel(w, g) <= 1e-10


@pytest.fixture(scope="module")
def qr_factor():
    M, N, nb = 100, 80, 32
    A, T = _pair(M, N, nb, jnp.float64)
    wf, wt = ref_qr.geqrf(A)
    gf, gt = qr.geqrf(T)
    return A, T, wf, wt, gf, gt


def test_ungqr_matches_reference(qr_factor):
    A, T, wf, wt, gf, gt = qr_factor
    want = ref_qr.ungqr(wf, wt)
    got = qr.ungqr(gf, gt)
    assert got.desc.M == 100 and got.desc.N == 80
    assert _rel(want.data, got.data) <= 1e-10
    k = qr.ungqr(gf, gt, K=40)
    assert _rel(ref_qr.ungqr(wf, wt, K=40).data, k.data) <= 1e-10


@pytest.mark.parametrize("side,trans", [("L", "N"), ("L", "C"), ("R", "N"),
                                        ("R", "C"), ("L", "T")])
def test_unmqr_matches_reference(qr_factor, side, trans):
    A, T, wf, wt, gf, gt = qr_factor
    shape = (100, 7) if side == "L" else (9, 100)
    C = ref_gen.plrnt(*shape, 32, 32, seed=11, dtype=jnp.float64)
    TC = _tm(C)
    want = ref_qr.unmqr(side, trans, wf, wt, C)
    got = qr.unmqr(side, trans, gf, gt, TC)
    assert got.desc == TC.desc
    assert _rel(want.data, got.data) <= 1e-10
    # Q is orthogonal: applying op(Q) keeps the Frobenius norm
    assert torch.allclose(torch.linalg.norm(got.to_dense()),
                          torch.linalg.norm(TC.to_dense()), rtol=1e-12)
    assert torch.equal(TC.data, _tm(C).data)        # C itself untouched


def test_unmqr_rejects_bad_arguments(qr_factor):
    _, T, _, _, gf, gt = qr_factor
    with pytest.raises(ValueError):
        qr.unmqr("X", "N", gf, gt, T)
    with pytest.raises(ValueError):
        qr.unmlq("L", "Q", gf, gt, T)


@pytest.fixture(scope="module")
def lq_factor():
    A, T = _pair(70, 100, 32, jnp.float64)
    wf, wt = ref_qr.gelqf(A)
    gf, gt = qr.gelqf(T)
    return A, T, wf, wt, gf, gt


def test_gelqf_and_unglq_match_reference(lq_factor):
    A, T, wf, wt, gf, gt = lq_factor
    assert gf.desc == T.desc
    assert _rel(wf.data, gf.data) <= 1e-10
    assert _rel(wt.data, gt.data) <= 1e-10
    Q = qr.unglq(gf, gt)
    assert _rel(ref_qr.unglq(wf, wt).data, Q.data) <= 1e-10
    q = Q.to_dense()
    L = torch.tril(gf.to_dense()[:, :70])
    assert torch.allclose(L @ q, T.to_dense(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("side,trans", [("L", "N"), ("L", "C"), ("R", "N"),
                                        ("R", "C")])
def test_unmlq_matches_reference(lq_factor, side, trans):
    A, T, wf, wt, gf, gt = lq_factor
    shape = (100, 5) if side == "L" else (6, 100)
    C = ref_gen.plrnt(*shape, 32, 32, seed=12, dtype=jnp.float64)
    want = ref_qr.unmlq(side, trans, wf, wt, C)
    got = qr.unmlq(side, trans, gf, gt, _tm(C))
    assert _rel(want.data, got.data) <= 1e-10


@pytest.mark.parametrize("M,N", [(100, 70), (70, 100), (64, 64)])
@pytest.mark.parametrize("prec", ["s", "d"])
def test_gels_matches_reference(M, N, prec):
    """Least squares for M >= N, the minimum-norm solution for M < N;
    B has M rows, as both packages' gels take it."""
    jdt, tol = DTYPES[prec]
    A, T = _pair(M, N, 32, jdt)
    B = ref_gen.plrnt(M, 3, 32, 32, seed=2354, dtype=jdt)
    TB = _tm(B)
    want = _ref(ref_qr.gels, A, B)
    got = qr.gels(T, TB)
    assert got.data.shape == want.data.shape
    assert _rel(want.data, got.data) <= 10 * tol
    r, ok = checks.check_gels(T, TB, got.to_dense())
    wr, wok = ref_checks.check_gels(A, B, want.to_dense())
    assert ok and wok, (r, wr)
    lsq = np.linalg.lstsq(T.to_dense().double().numpy(),
                          TB.to_dense().double().numpy(), rcond=None)[0]
    assert np.abs(got.to_dense().numpy()[:N] - lsq).max() <= \
        1e3 * tol * np.abs(lsq).max()


def test_qr_checks_match_reference(qr_factor):
    A, T, wf, wt, gf, gt = qr_factor
    Q = qr.ungqr(gf, gt).to_dense()
    R = torch.triu(gf.to_dense()[:80, :])
    r, ok = checks.check_qr(T, Q, R)
    wr, wok = ref_checks.check_qr(A, jnp.asarray(Q.numpy()),
                                  jnp.asarray(R.numpy()))
    assert ok and wok and r == pytest.approx(wr, rel=1e-6, abs=1e-3)
    r, ok = checks.check_orthogonality(Q)
    wr, wok = ref_checks.check_orthogonality(jnp.asarray(Q.numpy()))
    assert ok and wok and r == pytest.approx(wr, rel=1e-6, abs=1e-3)
    # a Q that is not orthogonal, and a wrong R, fail both packages
    bad = 1.01 * Q
    assert not checks.check_orthogonality(bad)[1]
    assert not ref_checks.check_orthogonality(jnp.asarray(bad.numpy()))[1]
    assert not checks.check_qr(T, Q, 1.001 * R)[1]


def test_t_desc_and_square_tile_rule():
    _, T = _pair(100, 70, 32, jnp.float32)
    Tm = qr.t_desc(T)
    ref = ref_qr.t_desc(ref_gen.plrnt(100, 70, 32, 32, seed=1))
    assert (Tm.desc.M, Tm.desc.N, Tm.desc.mb, Tm.desc.nb) == \
        (ref.desc.M, ref.desc.N, ref.desc.mb, ref.desc.nb)
    assert Tm.dtype == torch.float32 and not Tm.data.any()
    rect = generators.plrnt(64, 64, 32, 16, seed=1, device="cpu")
    for fn in (qr.geqrf, qr.gelqf):
        with pytest.raises(ValueError, match="square tiles"):
            fn(rect)


def test_dd_route_raises_for_f64():
    """Under dd_gemm=always every f64 QR entry point takes the limb route
    (each routes limb products to K2; parity with the reference is
    tests/test_torch_dd_qr*.py); complex128 takes the Householder sweep
    on vendor panels with its products on the limb route (parity with the
    reference: tests/test_torch_complex_dd.py), agreeing with the native
    complex128 factorization, while the real-only dd panel still raises;
    f32 never takes the limb route."""
    _, T = _pair(64, 64, 32, jnp.float64)
    with cfg.override_scope({"dd_gemm": "always"}):
        for fn in (qr.geqrf, qr.gelqf, lambda a: qr.geqrf_rec(a, 8),
                   lambda a: qr.gels(a, a)):
            routed = pdd.ROUTED
            fn(T)
            assert pdd.ROUTED > routed
        Z = TileMatrix(T.data.to(torch.complex128)
                       + 0.5j * T.data.flip(0), T.desc)
        routed = pdd.ROUTED
        F, Tf = qr.geqrf(Z)
        assert pdd.ROUTED > routed
        with pytest.raises(NotImplementedError, match="real f64 only"):
            qr._dd.geqrt_f64(Z.data[:, :32])
    Fn, Tn = qr.geqrf(Z)
    assert (F.data - Fn.data).abs().max() <= 1e-12 * Fn.data.abs().max()
    assert (Tf.data - Tn.data).abs().max() <= 1e-12 * Tn.data.abs().max()
    with cfg.override_scope({"dd_gemm": "always"}):
        _, T32 = _pair(64, 64, 32, jnp.float32)
        routed = pdd.ROUTED
        qr.geqrf(T32)                  # f32 never takes the limb route
        assert pdd.ROUTED == routed


def test_qr_panel_cholqr_route_matches_reference():
    """MCA ``qr_panel=cholqr`` on the chain route: CholeskyQR2 panels
    (the identity-padded edge keeps them full rank)."""
    _check_cholqr = {"qr_panel": "cholqr"}
    A, T = _pair(100, 100, 32, jnp.float64)
    want = _ref(ref_qr.geqrf, A, mca=_check_cholqr)
    with cfg.override_scope(_check_cholqr):
        got = qr.geqrf(T)
    assert _rel(want[0].data, got[0].data) <= 1e-10
    assert _rel(want[1].data, got[1].data) <= 1e-10


def test_geqrf_counts_with_k1_and_k4():
    """N=768, nb=256 (KT=3), K1 enabled, panel.kernel=pallas: every
    panel takes the K4 route and the K1 products are those the ops.qr
    docstring counts: 3 larft Grams and 3 per apply_q of the two narrow
    lookahead applies and of the catch-up of the column peeled after
    step 0 (the far flush at the last step finds no columns left)."""
    A, T = _pair(768, 768, 256, jnp.float32)
    was = pk.enabled()
    pk.enable(True)
    try:
        k1, k4 = pk.ROUTED, pqr.ROUTED
        with cfg.override_scope({"panel.kernel": "pallas"}):
            Af, Tf = qr.geqrf(T)
        assert (pk.ROUTED - k1, pqr.ROUTED - k4) == (3 + 3 * 3, 3)
    finally:
        pk.enable(was)
    Q = qr.ungqr(Af, Tf).to_dense()
    R = torch.triu(Af.to_dense())
    r, ok = checks.check_qr(T, Q, R)
    assert ok, r
    assert checks.check_orthogonality(Q)[1]
