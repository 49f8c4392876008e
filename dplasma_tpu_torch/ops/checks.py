"""Norm-based residual verification (the ``-x`` self-checks).

Ports ``dplasma_tpu/ops/checks.py``: regenerate from the seed, compute an analytic residual, pass
iff residual < 60 after scaling by eps·N (ref src/dplasma_zcheck.c,
tests/testing_zpotrf.c:86-121); ``check_solve``'s normwise backward
error passes below ``scale·eps``. No golden files.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas
from dplasma_tpu_torch.kernels import dd as _dd
from dplasma_tpu_torch.ops import norms

THRESHOLD = 60.0


def _real(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def _eps(dtype):
    return float(torch.finfo(_real(dtype)).eps)


def _tiny(dtype):
    """Smallest normal of the input's REAL dtype — the denominator
    clamp."""
    return float(torch.finfo(_real(dtype)).tiny)


def check_potrf(A0: TileMatrix, LL: TileMatrix, uplo: str = "L"):
    """||A - L L^H|| / (N ||A|| eps) — check_zpotrf semantics."""
    N = A0.desc.N
    a = norms._sym_full(A0, uplo, conj=True)
    x = LL.to_dense()
    if uplo.upper() == "L":
        t = torch.tril(x)
        rec = blas.dot(t, t, tb=True, conj_b=True)
    else:
        t = torch.triu(x)
        rec = blas.dot(t, t, ta=True, conj_a=True)
    res = torch.max(torch.abs(a - rec))
    anorm = torch.max(torch.abs(a))
    # a zero-norm A0 must give a finite residual, not 0/0 = NaN
    r = float(res / torch.clamp(anorm * _eps(A0.dtype) * N,
                                min=_tiny(A0.dtype)))
    return r, r < THRESHOLD


def check_axmb(A0: TileMatrix, b: TileMatrix, x: TileMatrix,
               uplo: str | None = None):
    """||b - A x||_inf / (||A|| ||x|| N eps) — check_zaxmb semantics.
    ``uplo`` set means A0 stores a Hermitian triangle."""
    N = A0.desc.N
    a = norms._sym_full(A0, uplo, conj=True) if uplo else A0.to_dense()
    bd = b.to_dense()
    xd = x.to_dense()
    r = bd - blas.dot(a, xd)
    num = torch.max(torch.abs(r))
    den = (torch.max(torch.abs(a)) * torch.max(torch.abs(xd))
           * _eps(A0.dtype) * N)
    val = float(num / torch.clamp(den, min=_tiny(A0.dtype)))
    return val, val < THRESHOLD


def check_solve(A0: TileMatrix, b: TileMatrix, x: TileMatrix,
                uplo: str | None = None, scale: float = 100.0):
    """Normwise backward error ``||b - A x|| / (||A|| ||x|| + ||b||)``
    against ``scale·eps`` (default the 100·u floor the mixed-precision
    IR solvers converge to): the measure the IR convergence test itself
    uses, residual included. For real f64 the residual is the exact limb
    product ``dd.gemm_residual`` (K2 on the card), as the IR loop's and
    as the reference's ``blas.dot`` on its TPU: an FP64 product rounds
    at ~sqrt(N)·u of ||A|| ||x||, which at N = 8192 is above the
    100·u gate itself. ``uplo`` set means A0 stores a Hermitian
    triangle. Max-norms throughout; the ``_tiny`` clamp keeps a
    zero-norm system finite."""
    a = norms._sym_full(A0, uplo, conj=True) if uplo else A0.to_dense()
    bd = b.to_dense()
    xd = x.to_dense()
    if a.dtype == torch.float64 and xd.dtype == torch.float64:
        r = _dd.gemm_residual(bd, a, xd)
    else:
        r = bd - blas.dot(a, xd)
    den = (torch.max(torch.abs(a)) * torch.max(torch.abs(xd))
           + torch.max(torch.abs(bd)))
    val = float(torch.max(torch.abs(r))
                / torch.clamp(den, min=_tiny(A0.dtype)))
    return val, val < scale * _eps(A0.dtype)


def check_gels(A0: TileMatrix, b: TileMatrix, xd):
    """Least-squares optimality ``||A^H (A x - b)|| / (||A||_F^2 ||x||_F
    eps max(M,N))`` — the gels testers' normal-equations gate. ``xd`` is
    the dense N-row solution; rows of ``b`` beyond A's M are ignored."""
    Ad = A0.to_dense()
    M, N = A0.desc.M, A0.desc.N
    res = blas.dot(Ad, xd[:N]) - b.to_dense()[:M]
    res = blas.dot(Ad, res, ta=True, conj_a=True)
    nrm = torch.linalg.norm(Ad) ** 2 * torch.linalg.norm(xd[:N])
    den = nrm * _eps(A0.dtype) * max(M, N)
    val = float(torch.linalg.norm(res)
                / torch.clamp(den, min=_tiny(A0.dtype)))
    return val, val < THRESHOLD


def check_qr(A0: TileMatrix, Q, R):
    """||A - Q R|| / (||A|| max(M,N) eps)."""
    a = A0.to_dense()
    rec = blas.dot(Q, R)
    den = torch.clamp(torch.max(torch.abs(a)), min=1.0) \
        * _eps(A0.dtype) * max(A0.desc.M, A0.desc.N)
    r = float(torch.max(torch.abs(a - rec))
              / torch.clamp(den, min=_tiny(A0.dtype)))
    return r, r < THRESHOLD


def check_orthogonality(Q):
    """||I - Q^H Q|| / (N eps)."""
    n = Q.shape[1]
    g = blas.dot(Q, Q, ta=True, conj_a=True)
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    r = float(torch.max(torch.abs(g - eye)) / (_eps(Q.dtype) * n))
    return r, r < THRESHOLD


def check_gemm(Cref, C):
    """Relative max-norm discrepancy between two tile matrices."""
    a = Cref.to_dense()
    b = C.to_dense()
    scale = torch.clamp(torch.max(torch.abs(a)), min=1.0)
    r = float(torch.max(torch.abs(a - b))
              / (scale * _eps(C.dtype) * max(C.desc.N, 1)))
    return r, r < THRESHOLD


def check_inverse(A0: TileMatrix, Ainv: TileMatrix, uplo: str | None = None):
    """||I - A A^{-1}|| / (N ||A|| ||A^{-1}|| eps) — check_zpoinv. ``uplo``
    set means both matrices store a Hermitian triangle. The product goes
    through ``blas.dot`` (K1 in f32, K2 under the dd route)."""
    N = A0.desc.N
    a = norms._sym_full(A0, uplo, conj=True) if uplo else A0.to_dense()
    ai = norms._sym_full(Ainv, uplo, conj=True) if uplo \
        else Ainv.to_dense()
    eye = torch.eye(N, dtype=a.dtype, device=a.device)
    r = torch.max(torch.abs(eye - blas.dot(a, ai)))
    den = torch.max(torch.abs(a)) * torch.max(torch.abs(ai)) \
        * _eps(A0.dtype) * N
    val = float(r / torch.clamp(den, min=_tiny(A0.dtype)))
    return val, val < THRESHOLD
