"""Tile-level compute kernels (the CORE_z* substrate) on tensors.

Ports ``dplasma_tpu/kernels/blas.py``. Products go to the hand-written
K1 kernel (``kernels.pallas_kernels``) when it is enabled and the
operands are eligible, else to ``torch.matmul``; the small dense tile
factorizations and solves go to ``torch.linalg`` (cuSOLVER/cuBLAS on
the card), as the reference leaves them to ``lax.linalg``.

f32 products are full f32: the package turns TF32 off where it
initialises (the reference's ``Precision.HIGHEST``, blas.py:27).

The f64-equivalent limb route (MCA ``dd_gemm``) is active only under
``dd_gemm=always`` — ``auto`` picks it on a TPU alone, and no backend of
the port is one. There, as in the reference, ``dot`` (and ``gemm``
through it) goes to ``dd.mm``, ``potrf`` to ``dd.potrf_f64``, ``trsm``
to ``dd.trsm_f64`` and ``trtri`` to ``dd.trtri_f64``: exact int8 limb
products closed by kernel K2. The LU and QR sweeps take the dd panels
themselves (``ops.lu._panel_lu_dd``, ``dd.geqrt_f64``) for float64;
complex128 factorizations keep the plain sweeps, every product a pair of
2K-deep limb products (``dd.mm``).

Every route's output passes a fault tap (``resilience.inject.tap``) at
the reference's choke points: ``dot`` and ``gemm`` (stage ``gemm``; K1,
the limb route and torch alike), ``potrf``, ``trsm`` and
``getrf_nopiv`` (stage ``getrf``). With no plan armed a tap is one
attribute check.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.kernels import dd as _dd
from dplasma_tpu_torch.kernels import pallas_kernels as _pk
from dplasma_tpu_torch.resilience import inject as _inject
from dplasma_tpu_torch.utils import config as _cfg


def _dd_active(dtype) -> bool:
    """Should f64/c128 matmuls take the Ozaki limb GEMM? Only under MCA
    ``dd_gemm=always`` (``auto`` means a TPU, which the port never
    runs on)."""
    if dtype not in (torch.float64, torch.complex128):
        return False
    return (_cfg.mca_get("dd_gemm") or "auto").lower() == "always"


def dot(a, b, ta: bool = False, tb: bool = False, conj_a: bool = False,
        conj_b: bool = False):
    """op(a) @ op(b): ``ta``/``tb`` transpose, ``conj_*`` conjugate.

    Transposes are views of the last two axes; K1 reads them through its
    strides. Operands with leading batch axes (the band sweeps' windows,
    the reference's ``vmap``) go to ``torch.matmul`` in their own dtype:
    K1 and the limb route take 2-D operands only."""
    res_dtype = torch.promote_types(a.dtype, b.dtype)
    a = a.to(res_dtype)
    b = b.to(res_dtype)
    if conj_a:
        a = a.conj()
    if conj_b:
        b = b.conj()
    if ta:
        a = a.mT
    if tb:
        b = b.mT
    if a.ndim > 2 or b.ndim > 2:
        return _inject.tap("gemm", torch.matmul(a, b))
    if _dd_active(res_dtype):
        return _inject.tap("gemm", _dd.mm(a, b))
    if _pk.eligible(a, b):
        return _inject.tap("gemm", _pk.matmul(a, b).to(res_dtype))
    return _inject.tap("gemm", torch.matmul(a, b).to(res_dtype))


def gemm(alpha, a, b, beta, c, ta=False, tb=False, conj_a=False,
         conj_b=False):
    """C = alpha op(A) op(B) + beta C (CORE_zgemm semantics). Goes to
    the fused K1 kernel (one read of C) when enabled and eligible; else
    matmul + axpy."""
    if (not (conj_a or conj_b) and isinstance(alpha, (int, float))
            and isinstance(beta, (int, float))):
        aa = a.T if ta else a
        bb = b.T if tb else b
        if _pk.eligible(aa, bb, c):
            return _inject.tap("gemm", _pk.gemm(aa, bb, c,
                                                alpha=float(alpha),
                                                beta=float(beta)))
    return alpha * dot(a, b, ta, tb, conj_a, conj_b) + beta * c


def tri(x, lower: bool = True, unit: bool = False):
    """The named triangle (optionally with unit diagonal) of the last two
    axes, non-square safe."""
    t = torch.tril(x) if lower else torch.triu(x)
    if unit:
        t = t.clone()
        t.diagonal(dim1=-2, dim2=-1).fill_(1)
    return t


def _nan_unless(ok, x):
    """``x`` where the factorization succeeded, NaN where not — the INFO
    contract of ops/potrf (no host sync: a device-side select)."""
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def potrf(a, lower: bool = True):
    """Cholesky of one tile (CORE_zpotrf). Reads only the ``lower``/upper
    triangle of ``a``; returns the factor with the opposite triangle
    zeroed; when the tile is not positive definite its triangle is all
    NaN (as ``lax.linalg.cholesky`` gives)."""
    if _dd_active(a.dtype):
        return _inject.tap("potrf", _dd.potrf_f64(a, lower=lower))
    if lower:
        f, info = torch.linalg.cholesky_ex(torch.tril(a))
        return _inject.tap("potrf", torch.tril(_nan_unless(info == 0, f)))
    f, info = torch.linalg.cholesky_ex(torch.triu(a), upper=True)
    return _inject.tap("potrf", torch.triu(_nan_unless(info == 0, f)))


def _inv_trsm_active() -> bool:
    """MCA ``trsm_inv=always``: solve as (triangular inverse) x matmul."""
    return (_cfg.mca_get("trsm_inv") or "auto").lower() == "always"


def _op_tri(a, lower: bool, trans: str):
    """op(A) and the triangle it is stored in after the op."""
    if trans == "T":
        return a.T, not lower
    if trans == "C":
        return a.mH, not lower
    return a, lower


def trsm(a, b, *, side="L", lower=True, trans="N", unit=False, alpha=1.0):
    """Triangular solve: op(A) X = alpha B (side=L) or X op(A) = alpha B
    (side=R). CORE_ztrsm semantics; reads only the named triangle."""
    if _dd_active(torch.promote_types(a.dtype, b.dtype)):
        return _inject.tap("trsm", _dd.trsm_f64(
            a, b, side=side, lower=lower, trans=trans, unit=unit,
            alpha=alpha))
    op_a, op_lower = _op_tri(a, lower, trans)
    if _inv_trsm_active():
        n = a.shape[0]
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        inv_op = torch.linalg.solve_triangular(
            op_a, eye, upper=not op_lower, left=True, unitriangular=unit)
        if side == "L":
            return _inject.tap("trsm", dot(inv_op, alpha * b))
        return _inject.tap("trsm", dot(alpha * b, inv_op))
    return _inject.tap("trsm", torch.linalg.solve_triangular(
        op_a, alpha * b, upper=not op_lower, left=(side == "L"),
        unitriangular=unit))


def trmm(a, b, *, side="L", lower=True, trans="N", unit=False, alpha=1.0):
    """Triangular matrix multiply B = alpha op(A) B (or B op(A))."""
    t = tri(a, lower=lower, unit=unit)
    if trans == "T":
        t = t.T
    elif trans == "C":
        t = t.mH
    if side == "L":
        return alpha * dot(t, b)
    return alpha * dot(b, t)


def syrk(alpha, a, beta, c, *, lower=True, trans="N"):
    """C = alpha A A^T + beta C on the full tile (callers keep only the
    relevant triangle)."""
    upd = dot(a, a, tb=True) if trans == "N" else dot(a, a, ta=True)
    return alpha * upd + beta * c


def herk(alpha, a, beta, c, *, lower=True, trans="N"):
    """C = alpha A A^H + beta C (Hermitian rank-k)."""
    if trans == "N":
        upd = dot(a, a, tb=True, conj_b=True)
    else:
        upd = dot(a, a, ta=True, conj_a=True)
    return alpha * upd + beta * c


def getrf_nopiv(a):
    """LU without pivoting of one tile (CORE_zgetrf_nopiv): packed L\\U
    (unit L implicit), one rank-1 step per column."""
    m = a.clone()
    for kk in range(min(a.shape)):
        lcol = m[kk + 1:, kk] * (1.0 / m[kk, kk])
        m[kk + 1:, kk + 1:] -= torch.outer(lcol, m[kk, kk + 1:])
        m[kk + 1:, kk] = lcol
    return _inject.tap("getrf", m)


def getrf_nopiv_blocked(a, base: int = 32):
    """Blocked-recursive LU without pivoting of a square tile: the
    :func:`getrf_nopiv` contract, with the sequential rank-1 loop only
    inside ``base``-sized diagonal blocks and every off-diagonal step a
    trsm or a product."""
    n = a.shape[0]
    if n <= base:
        return getrf_nopiv(a)
    n1 = n // 2
    p11 = getrf_nopiv_blocked(a[:n1, :n1], base)
    u12 = trsm(p11, a[:n1, n1:], side="L", lower=True, unit=True)
    l21 = trsm(p11, a[n1:, :n1], side="R", lower=False)
    p22 = getrf_nopiv_blocked(a[n1:, n1:] - dot(l21, u12), base)
    return torch.cat([torch.cat([p11, u12], dim=1),
                      torch.cat([l21, p22], dim=1)], dim=0)


def lauum(a, lower: bool = True):
    """Tile LAUUM: L^H L (lower) or U U^H (upper) of a triangular tile."""
    if lower:
        t = torch.tril(a)
        return dot(t, t, ta=True, conj_a=True)
    t = torch.triu(a)
    return dot(t, t, tb=True, conj_b=True)


def trtri(a, *, lower=True, unit=False):
    """Tile triangular inverse via a solve against the identity."""
    if _dd_active(a.dtype):
        return _dd.trtri_f64(a, lower=lower, unit=unit)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return torch.linalg.solve_triangular(a, eye, upper=not lower,
                                         left=True, unitriangular=unit)
