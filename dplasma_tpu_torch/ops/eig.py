"""Hermitian eigensolver and SVD reduction chains.

Ports ``dplasma_tpu/ops/eig.py``: ``herbt`` (dense → band,
dplasma_zherbt), ``band_to_rect``, ``hbrdt`` (band → tridiagonal,
dplasma_zhbrdt), ``hetrd``, ``heev`` (dplasma_zheev, eigenvalues only),
``gebrd_ge2gb`` (dense → band bidiagonal, dplasma_zgebrd_ge2gb),
``gebrd``, ``gesvd`` (singular values) and ``gesvd_direct``, with the
reference's routing.

* Stage 1 is the blocked two-sided panel reduction: per panel one
  ``torch.geqrf`` and two compact-WY applies, every product through
  ``blas.dot`` (K1 on f32 products with every dimension >= 256, the
  limb route K2 under MCA ``dd_gemm=always``).
* Stage 2 is ``ops/band.py``: successive quarter-width SBR sweeps
  (kernel KW, one launch a sweep, for b <= 128: at nb = 256 three of
  hetrd's four sweeps, 42983 steps at N=8192, and three of gesvd's,
  96229 steps; the first sweep's window products on K1 in f32), or the
  Givens chase on request.
* The tridiagonal eigenvalues come from kernel KT
  (``kernels/tridiag.py``), the counterpart of the reference's
  ``jax.scipy.linalg.eigh_tridiagonal``; singular values from the
  Jordan–Wielandt tridiagonal of the bidiagonal (eigenvalues ±σ, zero
  diagonal), through KT as well, bisecting only the K values kept.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import BandMatrix, TileMatrix
from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.kernels import tridiag
from dplasma_tpu_torch.ops import band as band_mod
from dplasma_tpu_torch.ops.norms import _sym_full
from dplasma_tpu_torch.parallel import mesh as pmesh


def _panel_reflector_blocks(packed, nb: int):
    """The panel's R on its top nb rows, zeros below (the reduced
    column block)."""
    blk = torch.zeros_like(packed)
    blk[:nb] = torch.triu(packed[:nb, :])
    return blk


def herbt(A: TileMatrix, uplo: str = "L"):
    """Dense Hermitian → band reduction (dplasma_zherbt), bandwidth = tile
    size nb. Returns (band TileMatrix with both triangles of the band
    filled, V TileMatrix, T TileMatrix): V/T hold the panel reflectors."""
    assert A.desc.mb == A.desc.nb and A.desc.M == A.desc.N
    nb = A.desc.nb
    N = A.desc.M
    Mp = A.desc.Mp
    X = torch.zeros((Mp, Mp), dtype=A.dtype, device=A.device)
    X[:N, :N] = _sym_full(A, uplo, conj=True)
    Vm = torch.zeros_like(X)
    Tm = torch.zeros_like(X)
    for s in range(0, N - nb - 1, nb):
        e = s + nb
        if e >= Mp:
            break
        packed, v, T = hh.geqrt(X[e:, s:e])
        blk = _panel_reflector_blocks(packed, nb)
        X[e:, s:e] = blk
        X[s:e, e:] = blk.mH
        Vm[e:, s:e] = v
        Tm[s:s + nb, s:e] = T
        t = hh.apply_q(v, T, X[e:, e:], trans="C")
        X[e:, e:] = hh.apply_q_right(v, T, t, trans="N")
        X = pmesh.constrain2d(X)
    return (TileMatrix(X, A.desc), TileMatrix(Vm, A.desc),
            TileMatrix(Tm, A.desc))


def band_to_rect(B: TileMatrix, bw: int):
    """The Hermitian band in LAPACK lower-band storage (bw+1, N): row d
    holds diagonal d (the parsec_diag_band_to_rect analog)."""
    x = B.to_dense()
    return band_mod.to_lower_band(x, bw + 1, x.shape[0])


_CHASE_CUT = 64  # bandwidth below which the Givens chase takes over
_EIG_NB = 256    # stage-1 band width of the heev chain (see heev)


def _mirrored(S0, N: int):
    """Both triangles of a Hermitian band from its lower-band storage."""
    low = band_mod.lower_band_to_dense(S0, N)
    return low + torch.tril(low, -1).mH


def hbrdt(B, bw: int, chase_cut: int = _CHASE_CUT, method: str = "auto"):
    """Band → tridiagonal (dplasma_zhbrdt analog). ``method``: ``"scan"``
    (``auto`` for a dense-stored band) — the pipelined SBR sweeps of
    ``band.herm_band_to_tridiag_scan``; ``"chase"`` (``auto`` for a
    ``BandMatrix`` with bw <= chase_cut) — the Givens chase on band
    storage, after SBR sweeps down to ``chase_cut`` for a wider band.
    ``B`` is a TileMatrix (dense-stored band) or a BandMatrix; ``bw`` the
    true bandwidth. Returns (d, e) real."""
    if isinstance(B, BandMatrix):
        N = B.N
        S0 = B.data[B.ku:]             # column-aligned lower rows
    else:
        N = B.desc.M
        S0 = None
    b = min(bw, max(N - 1, 1))
    if method == "auto":
        method = "chase" if (S0 is not None and b <= max(1, chase_cut)) \
            else "scan"
    if method == "scan" and b > 1:
        X = B.zero_pad().data if S0 is None else _mirrored(S0, N)
        return band_mod.herm_band_to_tridiag_scan(X, N, b)
    if method == "chase" and b > max(1, chase_cut):
        # wide band: SBR sweeps down to the chase window first
        X = B.zero_pad().data if S0 is None else _mirrored(S0, N)
        while b > max(1, chase_cut):
            w_ = max(1, b // 4)
            X = band_mod.herm_sbr_sweep(X, N, b, w_)
            b = w_
        S0 = band_mod.to_lower_band(X, b + 1, N)
    elif S0 is None:
        S0 = band_mod.to_lower_band(B.zero_pad().data, b + 1, N)
    if b > 1:
        return band_mod.herm_band_to_tridiag_banded(S0[:b + 1], N, b)
    d = S0[0, :N].real
    if N > 1 and S0.shape[0] > 1:
        e = S0[1, :N - 1].abs().to(d.dtype)
    else:  # diagonal input (bandwidth 0) or N == 1
        e = torch.zeros((max(N - 1, 0),), dtype=d.dtype, device=d.device)
    return d, e


def hetrd(A: TileMatrix, uplo: str = "L"):
    """Dense Hermitian → tridiagonal, two-stage (dplasma_zhetrd): herbt
    to band nb, then band reduction to 1. Returns (d, e); the complex
    off-diagonal is phase-rotated real, as LAPACK zhetrd does."""
    Bm, _, _ = herbt(A, uplo)
    return hbrdt(Bm, A.desc.nb)


def heev(A: TileMatrix, uplo: str = "L", method: str = "auto"):
    """Eigenvalues of a Hermitian tile matrix (dplasma_zheev, jobz=N).
    ``method``: ``"2stage"`` — herbt ∘ hbrdt at band ``_EIG_NB`` and KT on
    the tridiagonal; ``"direct"`` (and ``"auto"``, as in the reference) —
    the vendor dense solver ``torch.linalg.eigvalsh`` of the mirrored
    matrix. Returns ascending eigenvalues (N,)."""
    if method == "auto":
        method = "direct"
    if method == "direct":
        return torch.linalg.eigvalsh(_sym_full(A, uplo, conj=True))
    nb_e = min(A.desc.nb, _EIG_NB)
    if nb_e != A.desc.nb:
        # re-tile for the chain: a narrow band trims the sweep count
        A = TileMatrix.from_dense(_sym_full(A, uplo, conj=True), nb_e, nb_e,
                                  A.desc.dist)
        uplo = "L"
    Bm, _, _ = herbt(A, uplo)
    d, e = hbrdt(Bm, nb_e)
    if d.shape[0] == 1:
        return d
    return tridiag.eigh_tridiagonal(d, e)


# -- SVD chain ---------------------------------------------------------

def _row_lq(X, s: int, e: int, nb: int, Mp: int, Np: int):
    """The row LQ of X[s:e, e:] (kills right of the superdiagonal block)
    and its right apply to the rows below."""
    rowp = X[s:e, e:].mH                         # (Np-e, nb)
    packed2, v2, T2 = hh.geqrt(rowp)
    blk = torch.zeros((nb, Np - e), dtype=X.dtype, device=X.device)
    blk[:, :nb] = torch.triu(packed2[:nb, :]).mH  # nb×nb lower triangle
    X[s:e, e:] = blk
    if e < Mp:
        X[e:, e:] = hh.apply_q_right(v2, T2, X[e:, e:], trans="N")


def gebrd_ge2gb(A: TileMatrix):
    """Dense → band upper-bidiagonal via QR/LQ panel alternation
    (dplasma_zgebrd_ge2gb): panel k runs a column QR, then a row LQ.
    Returns the band TileMatrix (the band in tiles (k, k) and
    (k, k+1))."""
    assert A.desc.mb == A.desc.nb
    nb = A.desc.nb
    X = A.zero_pad().data.clone()
    Mp, Np = X.shape
    for kk in range(A.desc.KT):
        s, e = kk * nb, (kk + 1) * nb
        packed, v, T = hh.geqrt(X[s:, s:e])
        X[s:, s:e] = _panel_reflector_blocks(packed, nb)
        if e < Np:
            X[s:, e:] = hh.apply_q(v, T, X[s:, e:], trans="C")
            _row_lq(X, s, e, nb, Mp, Np)
        X = pmesh.constrain2d(X)
    return TileMatrix(X, A.desc)


def _bidiag_reduce(X, nbp: int, M: int, N: int):
    """One QR/LQ sweep with panel width nbp on a general (band) matrix:
    leaves an upper band of width nbp."""
    X = X.clone()
    Mp, Np = X.shape
    for s in range(0, min(M, N), nbp):
        e = s + nbp
        if e > Mp:
            break
        packed, v, T = hh.geqrt(X[s:, s:e])
        X[s:, s:e] = _panel_reflector_blocks(packed, nbp)
        if e < Np:
            X[s:, e:] = hh.apply_q(v, T, X[s:, e:], trans="C")
            _row_lq(X, s, e, nbp, Mp, Np)
    return X


def gebrd(A: TileMatrix, chase_cut: int = _CHASE_CUT, method: str = "auto"):
    """Dense → bidiagonal (d, e): ge2gb to upper band 2nb−1, then
    ``"scan"`` (``auto``) — the pipelined QR/LQ SBR sweeps
    (band.bidiag_band_to_bidiag_scan); ``"chase"`` — blocked halving to
    ``chase_cut``, then the Givens chase. Returns (d, e) real."""
    B = gebrd_ge2gb(A)
    X = B.data
    M, N = A.desc.M, A.desc.N
    b = min(2 * A.desc.nb - 1, max(N - 1, 1))
    if method in ("auto", "scan") and b > 1:
        return band_mod.bidiag_band_to_bidiag_scan(X, M, N, b)
    while b > max(1, chase_cut):
        w = max(1, (b + 1) // 4)
        X = _bidiag_reduce(X, w, M, N)
        b = 2 * w - 1
    if b > 1:
        return band_mod.bidiag_band_to_bidiag(X, M, N, b)
    return band_mod._bidiag_of(X, M, N)


def gesvd(A: TileMatrix):
    """Singular values (the SVD chain + the driver's finish): the
    bidiagonal's Jordan–Wielandt tridiagonal (zero diagonal of length
    L + 1, off-diagonal [d1, e1, d2, e2, ...]) through KT, which bisects
    only the K eigenvalues kept (indices L + 1 − K … L, the reference's
    ``w[::-1][:K]``). Returns descending singular values (min(M, N),)."""
    d, e = gebrd(A)
    K = d.shape[0]
    if K == 1 and e.shape[0] == 0:
        return d
    L = K + e.shape[0]
    off = torch.zeros((L,), dtype=d.dtype, device=d.device)
    off[0::2] = d
    off[1::2] = e
    w = tridiag.eigh_tridiagonal(
        torch.zeros((L + 1,), dtype=d.dtype, device=d.device), off,
        targets=torch.arange(L + 1 - K, L + 1, dtype=torch.int32,
                             device=d.device))
    return torch.flip(w, (0,))


def gesvd_direct(A: TileMatrix):
    """Singular values by the vendor dense SVD (``torch.linalg.svdvals``,
    the reference's jnp.linalg.svd)."""
    return torch.linalg.svdvals(A.to_dense())
