"""Matrix norms.

Ports ``dplasma_tpu/ops/norms.py``: ``lange``, ``lanhe``, ``lansy`` and
``lantr`` are one reduction over the dense view (padding is zero, so
neutral for max, abs-sum and Frobenius); ``lanm2`` estimates the
2-norm by 20 power iterations on A^H A (dplasma_zlanm2), a Python loop
where the reference runs ``fori_loop``. Its matrix-vector products are
plain ``@``, as the reference's are.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as _k


def _norm2d(x, norm: str):
    a = torch.abs(x)
    norm = norm.upper()
    if norm in ("M", "MAX"):
        return a.max()
    if norm in ("1", "O", "ONE"):
        return a.sum(dim=0).max()
    if norm in ("I", "INF"):
        return a.sum(dim=1).max()
    if norm in ("F", "FRO", "E"):
        # scaled ssq for overflow safety (core_zgessq semantics)
        scale = torch.clamp(a.max(), min=torch.finfo(a.dtype).tiny)
        return scale * torch.sqrt(((a / scale) ** 2).sum())
    raise ValueError(f"unknown norm {norm!r}")


def lange(A: TileMatrix, norm: str = "F"):
    """General matrix norm (dplasma_zlange)."""
    return _norm2d(A.to_dense(), norm)


def _sym_full(A: TileMatrix, uplo: str, conj: bool):
    """Both triangles of a symmetric/Hermitian matrix from the stored
    ``uplo`` one."""
    x = A.to_dense()
    if uplo.upper() == "L":
        t = torch.tril(x)
        o = torch.tril(x, -1)
    else:
        t = torch.triu(x)
        o = torch.triu(x, 1)
    return t + (o.mH if conj else o.T)


def lanhe(A: TileMatrix, norm: str = "F", uplo: str = "L"):
    """Hermitian matrix norm from one stored triangle (dplasma_zlanhe)."""
    return _norm2d(_sym_full(A, uplo, conj=True), norm)


def lansy(A: TileMatrix, norm: str = "F", uplo: str = "L"):
    """Symmetric matrix norm from one stored triangle (dplasma_zlansy)."""
    return _norm2d(_sym_full(A, uplo, conj=False), norm)


def lantr(A: TileMatrix, norm: str = "F", uplo: str = "L", diag: str = "N"):
    """Triangular matrix norm (dplasma_zlantr)."""
    t = _k.tri(A.to_dense(), lower=(uplo.upper() == "L"),
               unit=(diag.upper() == "U"))
    return _norm2d(t, norm)


def lanm2(A: TileMatrix, iters: int = 20):
    """2-norm (largest singular value) estimator by ``iters`` power
    iterations on A^H A (dplasma_zlanm2 semantics with a fixed iteration
    count)."""
    x = A.to_dense()
    N = x.shape[1]
    rdt = x.real.dtype if x.is_complex() else x.dtype
    tiny = torch.finfo(rdt).tiny
    v = torch.ones((N,), dtype=x.dtype, device=x.device) / torch.sqrt(
        torch.tensor(N, dtype=rdt, device=x.device)).to(x.dtype)
    for _ in range(iters):
        u = x.mH @ (x @ v)
        v = u / torch.clamp(torch.linalg.vector_norm(u), min=tiny).to(
            u.dtype)
    return torch.linalg.vector_norm(x @ v)
