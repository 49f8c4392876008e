"""LDL^H factorization (Hermitian-indefinite, no pivoting) — the
reference's prototype HETRF family.

Ports ``dplasma_tpu/ops/ldl.py`` (:28-100): ``dplasma_zhetrf``
(zhetrf.jdf), ``dplasma_zhetrs``, ``dplasma_ztrdsm`` (ztrdsm.jdf),
``ztrmdm.jdf``, with tile kernels core_zhetrf*_nopiv.c / core_zhedrk.c.

A blocked right-looking sweep like potrf: per panel one unblocked tile
LDL^H (:func:`hetrf_tile`, a Python loop of rank-1 updates written in
place into one clone of the tile, where the reference runs a
``fori_loop`` of masked updates), one TRSM + diagonal scale, and one
HEDRK-shaped trailing update L21 D L21^H as one product. D is kept on
the diagonal of the packed factor (LAPACK convention); L is unit lower.
Like the reference, no pivoting — pair with the random butterfly
transform (``ops.rbt``) for stability on indefinite systems.

Products and solves go through ``kernels.blas``: per :func:`hetrf` with
KT diagonal tiles, KT − 1 trailing products (K1 for f32 when every
dimension is at least 256, K2 under MCA ``dd_gemm=always``, where each
``trsm`` is ``dd.trsm_f64``'s two limb residuals more). The diagonal
tiles' rank-1 loops are nb small launches each, all host-bound.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.ops import blas3


def hetrf_tile(a):
    """Unblocked LDL^H of one Hermitian tile (core_zhetrf_nopiv
    analog): returns packed L\\D (unit L implicit, D on the diagonal).
    Only the lower triangle of ``a`` is read. As in the reference, each
    rank-1 update covers the whole trailing square, so the strict upper
    triangle ends up holding scratch that no reader looks at."""
    n = a.shape[0]
    m = torch.tril(a)
    for j in range(n - 1):
        d = m[j, j]
        l = m[j + 1:, j] / d
        # rank-1 Hermitian update on the trailing block
        m[j + 1:, j + 1:] -= torch.outer(l, l.conj()) * d
        m[j + 1:, j] = l
    return m


def hetrf(A: TileMatrix, uplo: str = "L") -> TileMatrix:
    """Blocked LDL^H: A = L D L^H (dplasma_zhetrf, lower storage).
    Returns the packed factor (strict lower = L, diagonal = D)."""
    assert uplo.upper() == "L", "reference hetrf is lower-storage"
    assert A.desc.mb == A.desc.nb and A.desc.M == A.desc.N
    nb = A.desc.nb
    KT = A.desc.KT
    X = A.pad_diag().data.clone()
    Mp = X.shape[0]
    for kk in range(KT):
        s, e = kk * nb, (kk + 1) * nb
        d = hetrf_tile(X[s:e, s:e])
        X[s:e, s:e] = d
        if e < Mp:
            dd = torch.real(torch.diagonal(d)).to(X.dtype)
            # L21 = A21 L11^{-H} D^{-1}
            l21 = k.trsm(d, X[e:, s:e], side="R", lower=True, trans="C",
                         unit=True) / dd[None, :]
            X[e:, s:e] = l21
            # trailing HEDRK: A22 -= L21 D L21^H (core_zhedrk)
            X[e:, e:] -= k.dot(l21 * dd[None, :], l21, tb=True, conj_b=True)
    return TileMatrix(X, A.desc)


def _d(F: TileMatrix):
    return torch.real(torch.diagonal(F.data)).to(F.dtype)


def trdsm(F: TileMatrix, B: TileMatrix) -> TileMatrix:
    """Diagonal solve B ← D^{-1} B against the D of a packed LDL^H
    factor (dplasma_ztrdsm analog)."""
    return B.like(B.zero_pad().data / _d(F)[:, None])


def trmdm(F: TileMatrix, B: TileMatrix) -> TileMatrix:
    """Diagonal multiply B ← D B (ztrmdm analog)."""
    return B.like(B.zero_pad().data * _d(F)[:, None])


def hetrs(F: TileMatrix, B: TileMatrix) -> TileMatrix:
    """Solve L D L^H x = b from a hetrf factor (dplasma_zhetrs):
    unit-lower TRSM, diagonal solve, unit-lower^H TRSM."""
    y = blas3.trsm(1.0, F, B, side="L", uplo="L", trans="N", diag="U")
    y = trdsm(F, y)
    return blas3.trsm(1.0, F, y, side="L", uplo="L", trans="C", diag="U")


def hesv(A: TileMatrix, B: TileMatrix):
    """Factor + solve. Returns (factor, X)."""
    F = hetrf(A)
    return F, hetrs(F, B)
