"""Port parity in the complex dtypes c and z: the factorizations and
solvers of ``ops.potrf`` (potrf, potrf_rec, potrs, posv, trtri, lauum,
potri, poinv), ``ops.lu`` (getrf_1d, getrf_rec, getrf_nopiv, getrs in
every trans, gesv_1d, laswp) and ``ops.qr`` (geqrf, geqrf_rec, gelqf,
ungqr, unglq, unmqr, unmlq, gels) against the JAX package on the same
padded inputs (N=100, nb=32: an edge tile and a padded diagonal).

Tolerance: max|Δ|/max|result| <= 1e-5 in c and 1e-12 in z on every
factor. A solve's forward error is its backward error (rounding) times
the condition number κ₂(A), so two backward-stable solves agree within
4·κ·u (u the unit roundoff; κ² for least squares): solutions are held
to the larger of that and the factor tolerance — 1e-12 still in z,
where 4·κ·u stays below it on these inputs, while a plrnt matrix's κ of
a few hundred makes it ~5e-5 in c. Both
packages reach LAPACK's pivoted LU on the CPU, so the permutations must
be equal (``np.array_equal``). LAPACK picks a complex pivot by
|re| + |im| and the recursive panel by |z| in both packages alike.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import lu, qr
from dplasma_tpu_torch.ops import potrf as port_potrf
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

N, NB = 100, 32
TOL = {"c": 1e-5, "z": 1e-12}
JDT = {"c": jnp.complex64, "z": jnp.complex128}
PRECS = ["c", "z"]


def _port(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _pair(A):
    return A, _port(A)


def _close(want, got, prec):
    want = np.asarray(getattr(want, "data", want))
    got = getattr(got, "data", got).resolve_conj().numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= TOL[prec], err


def _close_solve(want, got, prec, a, power=1):
    """Solutions: within max(TOL, 4·κ₂(a)^power·u)."""
    u = float(np.finfo(np.float32 if prec == "c" else np.float64).eps) / 2
    kappa = np.linalg.cond(np.asarray(a.to_dense(), np.complex128))
    want = np.asarray(want.data)
    got = got.data.resolve_conj().numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= max(TOL[prec], 4 * kappa ** power * u), (err, kappa)


def _he(prec, seed=3872, unit=False):
    A = ref_gen.plghe(float(N), N, NB, seed=seed, dtype=JDT[prec])
    if unit:   # a well-conditioned unit triangle: off-diagonals over N
        A = A.like(A.data / N)
    return _pair(A)


def _rnt(prec, m=N, n=N, seed=3872):
    return _pair(ref_gen.plrnt(m, n, NB, NB, seed=seed, dtype=JDT[prec]))


# ---------------------------------------------------------------------
# Cholesky family
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_potrs_posv(prec, uplo):
    A, TA = _he(prec)
    B, TB = _rnt(prec, N, 5, seed=7)
    L = ref_potrf.potrf(A, uplo)
    TL = port_potrf.potrf(TA, uplo)
    _close(L, TL, prec)
    _close_solve(ref_potrf.potrs(L, B, uplo),
                 port_potrf.potrs(TL, TB, uplo), prec, A)
    _close_solve(ref_potrf.posv(A, B, uplo)[1],
                 port_potrf.posv(TA, TB, uplo)[1], prec, A)


@pytest.mark.parametrize("prec", PRECS)
def test_potrf_rec(prec):
    A, TA = _he(prec)
    _close(ref_potrf.potrf_rec(A, "L", 8), port_potrf.potrf_rec(TA, "L", 8),
           prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo,diag", [("L", "N"), ("U", "U")])
def test_trtri_lauum(prec, uplo, diag):
    A, TA = _he(prec, unit=diag == "U")
    _close(ref_potrf.trtri(A, uplo, diag), port_potrf.trtri(TA, uplo, diag),
           prec)
    _close(ref_potrf.lauum(A, uplo), port_potrf.lauum(TA, uplo), prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potri_poinv(prec, uplo):
    A, TA = _he(prec)
    _close(ref_potrf.poinv(A, uplo), port_potrf.poinv(TA, uplo), prec)
    L = ref_potrf.potrf(A, uplo)
    _close(ref_potrf.potri(L, uplo), port_potrf.potri(_port(L), uplo),
           prec)


# ---------------------------------------------------------------------
# pivoted and unpivoted LU
# ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=PRECS)
def lu_pair(request):
    prec = request.param
    A, TA = _rnt(prec, N - 3, N - 3)
    B, TB = _rnt(prec, N - 3, 4, seed=11)
    return prec, A, TA, B, TB, ref_lu.getrf_1d(A), lu.getrf_1d(TA)


def test_getrf_1d(lu_pair):
    prec, _, _, _, _, (F, perm), (TF, tperm) = lu_pair
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    _close(F, TF, prec)


@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_getrs(lu_pair, trans):
    prec, A, _, B, TB, (F, perm), (TF, tperm) = lu_pair
    _close_solve(ref_lu.getrs(trans, F, perm, B),
                 lu.getrs(trans, TF, tperm, TB), prec, A)


def test_gesv_and_laswp(lu_pair):
    prec, A, TA, B, TB, (_, perm), (_, tperm) = lu_pair
    _close_solve(ref_lu.gesv_1d(A, B)[2], lu.gesv_1d(TA, TB)[2], prec, A)
    for inverse in (False, True):
        _close(ref_lu.laswp(A.pad_diag(), perm, inverse=inverse),
               lu.laswp(TA.pad_diag(), tperm, inverse=inverse), prec)


@pytest.mark.parametrize("prec", PRECS)
def test_getrf_rec(prec):
    """getrf_rec's nested hnb-wide sweep (chain panels)."""
    A, TA = _rnt(prec)
    F, perm = ref_lu.getrf_rec(A, 16)
    TF, tperm = lu.getrf_rec(TA, 16)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    _close(F, TF, prec)


@pytest.mark.parametrize("prec", PRECS)
def test_recursive_panel_pivots_by_modulus(prec):
    """``panel.kernel=rec``: the recursive panel picks each pivot by |z|
    in both packages (LAPACK's by |re| + |im|), on a small matrix (the
    reference compiles its recursion per shape)."""
    A = ref_gen.plrnt(24, 24, 8, 8, seed=29, dtype=JDT[prec])
    with cfg.override_scope({"panel.kernel": "rec"}), \
            ref_cfg.override_scope({"panel.kernel": "rec"}):
        F, perm = ref_lu.getrf_1d(A)
        TF, tperm = lu.getrf_1d(_port(A))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    _close(F, TF, prec)


@pytest.mark.parametrize("prec", PRECS)
def test_getrf_nopiv(prec):
    A = ref_gen.plrnt(N, N, NB, NB, seed=5, dtype=JDT[prec], diagdom=True)
    _close(ref_lu.getrf_nopiv(A), lu.getrf_nopiv(_port(A)), prec)


# ---------------------------------------------------------------------
# QR and LQ
# ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=PRECS)
def qr_pair(request):
    prec = request.param
    A, TA = _rnt(prec, N, N - 30)
    return prec, A, TA, ref_qr.geqrf(A), qr.geqrf(TA)


def test_geqrf_ungqr(qr_pair):
    prec, _, _, (Af, Tf), (TAf, TTf) = qr_pair
    _close(Af, TAf, prec)
    _close(Tf, TTf, prec)
    _close(ref_qr.ungqr(Af, Tf), qr.ungqr(TAf, TTf), prec)


@pytest.mark.parametrize("side,trans", [("L", "N"), ("L", "C"),
                                        ("R", "N"), ("R", "C")])
def test_unmqr(qr_pair, side, trans):
    prec, _, _, (Af, Tf), (TAf, TTf) = qr_pair
    C, TC = _rnt(prec, N, 20, seed=13) if side == "L" else \
        _rnt(prec, 20, N, seed=13)
    _close(ref_qr.unmqr(side, trans, Af, Tf, C),
           qr.unmqr(side, trans, TAf, TTf, TC), prec)


@pytest.mark.parametrize("prec", PRECS)
def test_geqrf_rec(prec):
    """The hnb-wide recursive panels, on a small matrix (the reference
    compiles its recursion per shape)."""
    A = ref_gen.plrnt(40, 30, 16, 16, seed=31, dtype=JDT[prec])
    for w, g in zip(ref_qr.geqrf_rec(A, 8), qr.geqrf_rec(_port(A), 8)):
        _close(w, g, prec)


@pytest.mark.parametrize("prec", PRECS)
def test_gelqf_unglq_unmlq(prec):
    A, TA = _rnt(prec, N - 30, N)
    Af, Tf = ref_qr.gelqf(A)
    TAf, TTf = qr.gelqf(TA)
    _close(Af, TAf, prec)
    _close(ref_qr.unglq(Af, Tf), qr.unglq(TAf, TTf), prec)
    C, TC = _rnt(prec, N, 20, seed=17)
    for trans in ("N", "C"):
        _close(ref_qr.unmlq("L", trans, Af, Tf, C),
               qr.unmlq("L", trans, TAf, TTf, TC), prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("m,n", [(N, N - 30), (N - 30, N)])
def test_gels(prec, m, n):
    """Least squares (m > n) and the minimum-norm solution (m < n); B has
    m rows, as both packages' gels take it."""
    A, TA = _rnt(prec, m, n)
    B, TB = _rnt(prec, m, 3, seed=19)
    _close_solve(ref_qr.gels(A, B), qr.gels(TA, TB), prec, A, power=2)
