"""Port parity in the complex dtypes c (complex64) and z (complex128):
the generators bitwise, and the tile Level-3 BLAS, aux ops, norms and
residual checks against the JAX package on the same padded inputs
(M=100, N=70, K=60, nb=32: edge tiles everywhere).

Tolerance: max|Δ|/max|result| <= 1e-5 in c and 1e-12 in z (one or two
products each, summed in another order by XLA and by torch). The
Hermitian and symmetric inputs carry garbage in the triangle the op does
not name, so reading it would show; the conjugations of the h-ops show
because every input has an imaginary part.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import aux as ref_aux
from dplasma_tpu.ops import blas3 as ref_blas3
from dplasma_tpu.ops import checks as ref_checks
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import norms as ref_norms
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import aux, blas3, checks, generators, norms
from torch_threads import one_torch_thread  # noqa: F401

M, N, K, NB = 100, 70, 60, 32
TOL = {"c": 1e-5, "z": 1e-12}
JDT = {"c": jnp.complex64, "z": jnp.complex128}
TDT = {"c": torch.complex64, "z": torch.complex128}
VIEW = {"c": np.uint32, "z": np.uint64}
PRECS = ["c", "z"]


def _bits(x, prec):
    return np.ascontiguousarray(np.asarray(x)).view(VIEW[prec])


def _port(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _gen(m, n, prec, seed):
    A = ref_gen.plrnt(m, n, NB, NB, seed=seed, dtype=JDT[prec])
    return A, _port(A)


def _herm(n, prec, seed, uplo, kind="he"):
    """A Hermitian (``he``) or complex-symmetric (``sy``) matrix whose
    other triangle holds garbage."""
    gen = ref_gen.plghe if kind == "he" else ref_gen.plgsy
    A = gen(float(n), n, NB, seed=seed, dtype=JDT[prec])
    junk = jnp.full_like(A.data, 1e6 + 1e6j)
    A = A.like(A.data + (jnp.triu(junk, 1) if uplo == "L"
                         else jnp.tril(junk, -1)))
    return A, _port(A)


def _close(want, got, prec):
    want = np.asarray(getattr(want, "data", want))
    got = getattr(got, "data", got)
    got = got.resolve_conj().numpy() if torch.is_tensor(got) else got
    assert want.shape == got.shape and np.isfinite(got).all()
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= TOL[prec], err


# ---------------------------------------------------------------------
# generators: bitwise
# ---------------------------------------------------------------------

SEEDS = [3872, 0, 2**32 - 1]   # the last wraps seed + 1 to 0


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("N_,nb", [(37, 8), (96, 32), (50, 16)])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("diagdom", [False, True])
def test_plrnt_complex_bitwise(prec, N_, nb, seed, diagdom):
    M_ = N_ - 3
    a = ref_gen.plrnt(M_, N_, nb, nb, seed=seed, dtype=JDT[prec],
                      diagdom=diagdom)
    b = generators.plrnt(M_, N_, nb, nb, seed=seed, dtype=TDT[prec],
                         diagdom=diagdom, device="cpu")
    assert b.dtype == TDT[prec]
    assert dataclasses.asdict(a.desc) == b.desc.to_dict()
    np.testing.assert_array_equal(_bits(a.data, prec),
                                  _bits(b.data.numpy(), prec))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("N_,nb", [(37, 8), (50, 16)])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gen", ["plghe", "plgsy"])
def test_plghe_plgsy_complex_bitwise(prec, N_, nb, seed, gen):
    a = getattr(ref_gen, gen)(float(N_) + 0.5, N_, nb, seed=seed,
                              dtype=JDT[prec])
    b = getattr(generators, gen)(float(N_) + 0.5, N_, nb, seed=seed,
                                 dtype=TDT[prec], device="cpu")
    assert dataclasses.asdict(a.desc) == b.desc.to_dict()
    np.testing.assert_array_equal(_bits(a.data, prec),
                                  _bits(b.data.numpy(), prec))
    x = b.to_dense()
    if gen == "plghe":     # Hermitian, with a real diagonal
        assert torch.equal(x, x.mH.resolve_conj())
        assert not x.diagonal().imag.any()
    else:                  # complex-symmetric, not Hermitian
        assert torch.equal(x, x.T) and x.diagonal().imag.any()


def test_complex_parts_are_the_real_hashes_of_seed_and_seed_plus_1():
    """re = the real generator at ``seed``, im = at ``seed + 1``, both in
    the real dtype; the chunked rows give the same bits."""
    z = generators.plrnt(30, 20, 8, 8, seed=41, dtype=torch.complex128,
                         device="cpu").data
    re = generators.plrnt(30, 20, 8, 8, seed=41, dtype=torch.float64,
                          device="cpu").data
    im = generators.plrnt(30, 20, 8, 8, seed=42, dtype=torch.float64,
                          device="cpu").data
    assert torch.equal(z.real, re) and torch.equal(z.imag, im)
    c = generators.plrnt(30, 20, 8, 8, seed=41, dtype=torch.complex64,
                         device="cpu").data
    assert torch.equal(c.real, generators.plrnt(
        30, 20, 8, 8, seed=41, device="cpu").data)
    assert torch.equal(c.imag, generators.plrnt(
        30, 20, 8, 8, seed=42, device="cpu").data)


def test_complex_generator_chunking_is_invisible(monkeypatch):
    whole = generators.plghe(50.0, 50, 16, seed=9, dtype=torch.complex64,
                             device="cpu").data
    monkeypatch.setattr(generators, "_CHUNK_ELEMS", 70)
    chunked = generators.plghe(50.0, 50, 16, seed=9, dtype=torch.complex64,
                               device="cpu").data
    assert torch.equal(whole, chunked)


# ---------------------------------------------------------------------
# Level-3 BLAS
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("ta,tb", [("N", "N"), ("C", "N"), ("N", "T"),
                                   ("T", "C")])
def test_gemm(prec, ta, tb):
    A, TA = _gen(*((M, K) if ta == "N" else (K, M)), prec, 1)
    B, TB = _gen(*((K, N) if tb == "N" else (N, K)), prec, 2)
    C, TC = _gen(M, N, prec, 3)
    alpha, beta = 0.51 - 0.2j, -0.42 + 0.1j
    _close(ref_blas3.gemm(alpha, A, B, beta, C, ta, tb),
           blas3.gemm(alpha, TA, TB, beta, TC, ta, tb), prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("side,uplo", [("L", "L"), ("R", "U")])
@pytest.mark.parametrize("op", ["symm", "hemm"])
def test_symm_hemm(prec, side, uplo, op):
    n = M if side == "L" else N
    A, TA = _herm(n, prec, 4, uplo, "he" if op == "hemm" else "sy")
    B, TB = _gen(M, N, prec, 5)
    C, TC = _gen(M, N, prec, 6)
    _close(getattr(ref_blas3, op)(0.7, A, B, 0.3, C, side=side, uplo=uplo),
           getattr(blas3, op)(0.7, TA, TB, 0.3, TC, side=side, uplo=uplo),
           prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("op,trans", [("syrk", "N"), ("syrk", "T"),
                                      ("herk", "N"), ("herk", "C"),
                                      ("syr2k", "N"), ("syr2k", "T"),
                                      ("her2k", "N"), ("her2k", "C")])
def test_rank_k_updates(prec, uplo, op, trans):
    shape = (N, K) if trans == "N" else (K, N)
    A, TA = _gen(*shape, prec, 7)
    C, TC = _herm(N, prec, 8, uplo, "he" if op[0] == "h" else "sy")
    alpha = 0.7 if op == "herk" else 0.7 - 0.3j
    if op.endswith("2k"):
        B, TB = _gen(*shape, prec, 9)
        want = getattr(ref_blas3, op)(alpha, A, B, 0.3, C, uplo=uplo,
                                      trans=trans)
        got = getattr(blas3, op)(alpha, TA, TB, 0.3, TC, uplo=uplo,
                                 trans=trans)
    else:
        want = getattr(ref_blas3, op)(alpha, A, 0.3, C, uplo=uplo,
                                      trans=trans)
        got = getattr(blas3, op)(alpha, TA, 0.3, TC, uplo=uplo, trans=trans)
    _close(want, got, prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("op", ["trmm", "trsm"])
@pytest.mark.parametrize("side,uplo,trans,diag", [
    ("L", "L", "N", "N"), ("L", "U", "C", "U"), ("R", "L", "T", "N"),
    ("R", "U", "C", "N")])
def test_trmm_trsm(prec, op, side, uplo, trans, diag):
    n = M if side == "L" else N
    A, TA = _herm(n, prec, 10, uplo)
    B, TB = _gen(M, N, prec, 11)
    alpha = 0.8 + 0.25j
    _close(getattr(ref_blas3, op)(alpha, A, B, side=side, uplo=uplo,
                                  trans=trans, diag=diag),
           getattr(blas3, op)(alpha, TA, TB, side=side, uplo=uplo,
                              trans=trans, diag=diag), prec)


# ---------------------------------------------------------------------
# aux ops and norms
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_aux_ops(prec):
    A, TA = _gen(M, N, prec, 12)
    B, TB = _gen(M, N, prec, 13)
    a, b = 0.7 - 0.1j, 0.3 + 0.2j
    for uplo in ("A", "L", "U"):
        _close(ref_aux.lacpy(A, uplo), aux.lacpy(TA, uplo), prec)
        _close(ref_aux.laset(A, a, b, uplo), aux.laset(TA, a, b, uplo),
               prec)
        _close(ref_aux.lascal(A, a, uplo), aux.lascal(TA, a, uplo), prec)
    _close(ref_aux.geadd(A, B, a, b), aux.geadd(TA, TB, a, b), prec)
    for uplo in ("L", "U"):
        _close(ref_aux.tradd(A, B, a, b, uplo=uplo),
               aux.tradd(TA, TB, a, b, uplo=uplo), prec)
    x = np.array(A.data[:M, 0])
    y = np.array(B.data[:N, 1])
    for conj_y in (True, False):
        _close(ref_aux.ger(a, jnp.asarray(x), jnp.asarray(y), A,
                           conj_y=conj_y),
               aux.ger(a, torch.from_numpy(x), torch.from_numpy(y), TA,
                       conj_y=conj_y), prec)


def _norm_close(want, got, prec):
    want, got = float(want), float(got)
    assert abs(want - got) <= TOL[prec] * abs(want), (want, got)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("nrm", ["M", "1", "I", "F"])
def test_norms(prec, nrm):
    A, TA = _gen(M, N, prec, 14)
    _norm_close(ref_norms.lange(A, nrm), norms.lange(TA, nrm), prec)
    for uplo in ("L", "U"):
        H, TH = _herm(N, prec, 15, uplo)
        _norm_close(ref_norms.lanhe(H, nrm, uplo),
                    norms.lanhe(TH, nrm, uplo), prec)
        S, TS = _herm(N, prec, 16, uplo, "sy")
        _norm_close(ref_norms.lansy(S, nrm, uplo),
                    norms.lansy(TS, nrm, uplo), prec)
        for diag in ("N", "U"):
            _norm_close(ref_norms.lantr(A, nrm, uplo, diag),
                        norms.lantr(TA, nrm, uplo, diag), prec)


@pytest.mark.parametrize("prec", PRECS)
def test_lanm2(prec):
    A, TA = _gen(M, N, prec, 17)
    _norm_close(ref_norms.lanm2(A), norms.lanm2(TA), prec)


# ---------------------------------------------------------------------
# residual checks
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("bad", [False, True])
def test_checks(prec, bad):
    """The residual checks on complex inputs: a right answer passes in
    both packages, one perturbed by 1e-3 fails in both; the residuals
    are of one size (both are O(1) sums of rounding errors)."""
    H, TH = _herm(N, prec, 18, "L")
    h = np.asarray(ref_gen.plghe(float(N), N, NB, seed=18,
                                 dtype=JDT[prec]).to_dense())
    L = np.linalg.cholesky(h)
    bvals = np.asarray(ref_gen.plrnt(N, 3, NB, NB, seed=19,
                                     dtype=JDT[prec]).to_dense())
    X = np.linalg.solve(h, bvals)
    A = ref_gen.plrnt(N, N, NB, NB, seed=20, dtype=JDT[prec])
    Q, R = np.linalg.qr(np.asarray(A.to_dense()))
    if bad:
        L, X, Q = L * (1 + 1e-3), X * (1 + 1e-3), Q * (1 + 1e-3)
    LL = H.like(jnp.zeros_like(H.data).at[:N, :N].set(L))
    B, TB = _gen(N, 3, prec, 19)
    Xt = B.like(jnp.zeros_like(B.data).at[:N, :3].set(X))
    TA = _port(A)
    pairs = [(ref_checks.check_potrf(H, LL, "L"),
              checks.check_potrf(TH, _port(LL), "L")),
             (ref_checks.check_axmb(H, B, Xt, uplo="L"),
              checks.check_axmb(TH, TB, _port(Xt), uplo="L")),
             (ref_checks.check_qr(A, jnp.asarray(Q), jnp.asarray(R)),
              checks.check_qr(TA, torch.from_numpy(Q), torch.from_numpy(R))),
             (ref_checks.check_orthogonality(jnp.asarray(Q)),
              checks.check_orthogonality(torch.from_numpy(Q)))]
    for (rw, okw), (rg, okg) in pairs:
        assert bool(okw) == bool(okg) == (not bad), (rw, rg)
        rw, rg = float(rw), float(rg)
        assert max(rw, rg) <= 10 * max(min(rw, rg), 1.0), (rw, rg)
