"""Level-3 tile BLAS on tile matrices.

Ports ``dplasma_tpu/ops/blas3.py``: gemm, symm/hemm, syrk/herk,
syr2k/her2k and trmm are each one or two products over the dense views
(with triangle masks where needed); ``trsm`` is the blocked tile
algorithm — one tile solve plus one panel product per diagonal tile, on
a padded workspace that is updated in place (it is this function's own
copy). Every product goes through ``kernels.blas.dot``, so f32 products
reach K1 when it is enabled and they are eligible, and f64 products
take the limb route (K2) under MCA ``dd_gemm=always``.

Triangular and symmetric inputs are read only from the triangle the op
names; syrk/herk/syr2k/her2k write only the stored triangle of C. For
real dtypes hemm, herk and her2k compute what symm, syrk and syr2k do.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.ops.aux import _scalar, _tri_mask
from dplasma_tpu_torch.ops.norms import _sym_full


def _op(x, trans: str):
    if trans == "N":
        return x
    if trans == "T":
        return x.T
    if trans == "C":
        return x.mH
    raise ValueError(f"bad trans {trans!r}")


def _tri(x, uplo: str, diag: str = "N"):
    return k.tri(x, lower=(uplo.upper() == "L"),
                 unit=(diag.upper() == "U"))


def _pack_like(C: TileMatrix, dense) -> TileMatrix:
    return TileMatrix.from_dense(dense, C.desc.mb, C.desc.nb, C.desc.dist)


def gemm(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
         transa: str = "N", transb: str = "N") -> TileMatrix:
    """C = alpha op(A) op(B) + beta C (dplasma_zgemm)."""
    a = _op(A.to_dense(), transa)
    b = _op(B.to_dense(), transb)
    out = alpha * k.dot(a, b) + beta * C.to_dense()
    return _pack_like(C, out.to(C.dtype))


def symm(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
         side: str = "L", uplo: str = "L", conj: bool = False) -> TileMatrix:
    """C = alpha A B + beta C with A symmetric (zsymm) or Hermitian
    (zhemm, conj=True), stored in the ``uplo`` triangle."""
    a = _sym_full(A, uplo, conj=conj)
    b = B.to_dense()
    prod = k.dot(a, b) if side == "L" else k.dot(b, a)
    cd = C.to_dense()
    out = _scalar(alpha, cd) * prod + _scalar(beta, cd) * cd
    return _pack_like(C, out)


def hemm(alpha, A, B, beta, C, side="L", uplo="L"):
    return symm(alpha, A, B, beta, C, side, uplo, conj=True)


def _rank_k_update(alpha, upd, beta, C: TileMatrix, uplo: str) -> TileMatrix:
    """C with its ``uplo`` triangle replaced by alpha·upd + beta·C, as a
    new matrix (C's storage is only read)."""
    cd = C.to_dense()
    m = _tri_mask(C.desc.M, C.desc.N, uplo, C.device)
    new = torch.where(m, _scalar(alpha, cd) * upd + _scalar(beta, cd) * cd,
                      cd)
    return _pack_like(C, new)


def syrk(alpha, A: TileMatrix, beta, C: TileMatrix, uplo: str = "L",
         trans: str = "N") -> TileMatrix:
    """C_tri = alpha A A^T + beta C (zsyrk)."""
    if trans not in ("N", "T"):
        raise ValueError(f"syrk trans must be N or T, got {trans!r}")
    a = A.to_dense()
    upd = k.dot(a, a, tb=True) if trans == "N" else k.dot(a, a, ta=True)
    return _rank_k_update(alpha, upd, beta, C, uplo)


def herk(alpha, A: TileMatrix, beta, C: TileMatrix, uplo: str = "L",
         trans: str = "N") -> TileMatrix:
    """C_tri = alpha A A^H + beta C (zherk)."""
    if trans not in ("N", "C"):
        raise ValueError(f"herk trans must be N or C, got {trans!r}")
    a = A.to_dense()
    if trans == "N":
        upd = k.dot(a, a, tb=True, conj_b=True)
    else:
        upd = k.dot(a, a, ta=True, conj_a=True)
    return _rank_k_update(alpha, upd, beta, C, uplo)


def syr2k(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
          uplo: str = "L", trans: str = "N") -> TileMatrix:
    """C_tri = alpha A B^T + alpha B A^T + beta C (zsyr2k)."""
    if trans not in ("N", "T"):
        raise ValueError(f"syr2k trans must be N or T, got {trans!r}")
    a, b = A.to_dense(), B.to_dense()
    if trans == "N":
        upd = k.dot(a, b, tb=True) + k.dot(b, a, tb=True)
    else:
        upd = k.dot(a, b, ta=True) + k.dot(b, a, ta=True)
    return _rank_k_update(alpha, upd, beta, C, uplo)


def her2k(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
          uplo: str = "L", trans: str = "N") -> TileMatrix:
    """C_tri = alpha A B^H + conj(alpha) B A^H + beta C (zher2k).
    ``alpha`` may be a Python number or a 0-d tensor."""
    if trans not in ("N", "C"):
        raise ValueError(f"her2k trans must be N or C, got {trans!r}")
    a, b = A.to_dense(), B.to_dense()
    al = _scalar(alpha, a)
    if trans == "N":
        upd = al * k.dot(a, b, tb=True, conj_b=True) \
            + al.conj() * k.dot(b, a, tb=True, conj_b=True)
    else:
        upd = al * k.dot(a, b, ta=True, conj_a=True) \
            + al.conj() * k.dot(b, a, ta=True, conj_a=True)
    return _rank_k_update(1.0, upd, beta, C, uplo)


def trmm(alpha, A: TileMatrix, B: TileMatrix, side: str = "L",
         uplo: str = "L", trans: str = "N", diag: str = "N") -> TileMatrix:
    """B = alpha op(tri(A)) B (or B op(tri(A))) — ztrmm's 8 cases."""
    t = _op(_tri(A.to_dense(), uplo, diag), trans)
    b = B.to_dense()
    out = _scalar(alpha, b) * (k.dot(t, b) if side == "L" else k.dot(b, t))
    return _pack_like(B, out)


def trsm(alpha, A: TileMatrix, B: TileMatrix, side: str = "L",
         uplo: str = "L", trans: str = "N", diag: str = "N") -> TileMatrix:
    """Solve op(tri(A)) X = alpha B (side=L) or X op(tri(A)) = alpha B —
    ztrsm's 8 cases, as a blocked loop over the KT diagonal tiles. The
    forward/backward direction follows from (side, uplo, trans)."""
    nt = A.desc.KT
    mb = A.desc.mb
    if A.desc.mb != A.desc.nb:
        raise ValueError(f"trsm needs square tiles on A, got {A.desc}")
    Bp = B.zero_pad()
    Ap = A.pad_diag().data  # pad-diag identity keeps pad rows solvable
    X = Bp.data * alpha     # (Mp, Np) workspace; pad rows/cols stay zero
    u = uplo.upper()
    tchar = trans.upper()
    unit = diag.upper() == "U"

    def dtile(kk):
        return Ap[kk * mb:(kk + 1) * mb, kk * mb:(kk + 1) * mb]

    if side.upper() == "L":
        # (L, N) / (U, T/C) -> forward substitution
        # (U, N) / (L, T/C) -> backward substitution
        forward = (u == "L") == (tchar == "N")
        order = range(nt) if forward else range(nt - 1, -1, -1)
        for kk in order:
            rows = slice(kk * mb, (kk + 1) * mb)
            xk = k.trsm(dtile(kk), X[rows, :], side="L",
                        lower=(u == "L"), trans=tchar, unit=unit)
            X[rows, :] = xk
            if forward and kk + 1 < nt:
                if u == "L":
                    pan = Ap[(kk + 1) * mb:, rows]
                else:  # (U, T/C): op(A) lower = A^H upper panel row
                    pan = _op(Ap[rows, (kk + 1) * mb:], tchar)
                X[(kk + 1) * mb:, :] -= k.dot(pan, xk)
            elif (not forward) and kk > 0:
                if u == "U":
                    pan = Ap[: kk * mb, rows]
                else:  # (L, T/C)
                    pan = _op(Ap[rows, : kk * mb], tchar)
                X[: kk * mb, :] -= k.dot(pan, xk)
    else:
        # X op(A) = alpha B  <=>  columns processed in the opposite order
        forward_r = (u == "L") == (tchar != "N")
        order = range(nt) if forward_r else range(nt - 1, -1, -1)
        for kk in order:
            cols = slice(kk * mb, (kk + 1) * mb)
            xk = k.trsm(dtile(kk), X[:, cols], side="R",
                        lower=(u == "L"), trans=tchar, unit=unit)
            X[:, cols] = xk
            if forward_r and kk + 1 < nt:
                if u == "L":
                    pan = _op(Ap[(kk + 1) * mb:, cols], tchar)
                else:
                    pan = Ap[cols, (kk + 1) * mb:]
                X[:, (kk + 1) * mb:] -= k.dot(xk, pan)
            elif (not forward_r) and kk > 0:
                if u == "L":
                    pan = Ap[cols, : kk * mb]
                else:
                    pan = _op(Ap[: kk * mb, cols], tchar)
                X[:, : kk * mb] -= k.dot(xk, pan)

    return TileMatrix(X, Bp.desc).zero_pad()
