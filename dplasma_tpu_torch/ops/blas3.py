"""Level-3 tile BLAS on tile matrices: ``gemm`` and the blocked ``trsm``.

Ports ``dplasma_tpu/ops/blas3.py`` (:57-66, :156-231); symm/syrk/trmm
and the rest wait for a later slice. ``gemm`` is one product over the
dense views; ``trsm`` is the blocked tile algorithm — one tile solve
plus one panel product per diagonal tile, on a padded workspace that is
updated in place (it is this function's own copy). Panel products go
through ``kernels.blas.dot``, so they reach K1 when it is enabled and
they are eligible.

Triangular inputs are read only from the triangle the op names.
"""
from __future__ import annotations

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k


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
