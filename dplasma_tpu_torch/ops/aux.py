"""Elementwise / Level-2 auxiliary operations on tile matrices.

Ports ``dplasma_tpu/ops/aux.py``: the map-framework clients lacpy,
laset, geadd, tradd, lascal and ger (dplasma_zlacpy, zlaset, zgeadd,
ztradd, zlascal, zger(u/c)), each a few elementwise tensor ops. Every
one returns a new matrix; none writes into its inputs.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix


def _tri_mask(M, N, uplo: str, device=None):
    """Boolean (M, N) mask of the ``uplo`` triangle (all-true for any
    other ``uplo``)."""
    r = torch.arange(M, device=device)[:, None]
    c = torch.arange(N, device=device)[None, :]
    u = uplo.upper()
    if u == "L":
        return r >= c
    if u == "U":
        return r <= c
    return torch.ones((M, N), dtype=torch.bool, device=device)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype and device (the
    reference's ``jnp.asarray(v, dtype)``)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _op(x, trans: str):
    if trans == "T":
        return x.T
    if trans == "C":
        return x.mH
    return x


def lacpy(A: TileMatrix, uplo: str = "A") -> TileMatrix:
    """Copy general/lower/upper part of A into a fresh matrix
    (dplasma_zlacpy)."""
    x = A.zero_pad()
    if uplo.upper() in ("A", "G"):
        return x.like(x.data.clone())
    m = _tri_mask(x.desc.Mp, x.desc.Np, uplo, x.device)
    return x.like(torch.where(m, x.data, _scalar(0, x.data)))


def laset(A: TileMatrix, alpha, beta, uplo: str = "A") -> TileMatrix:
    """Set off-diagonal to alpha, diagonal to beta (dplasma_zlaset)."""
    d = A.desc
    r = torch.arange(d.Mp, device=A.device)[:, None]
    c = torch.arange(d.Np, device=A.device)[None, :]
    v = torch.where(r == c, _scalar(beta, A.data), _scalar(alpha, A.data))
    u = uplo.upper()
    if u == "L":
        v = torch.where(r >= c, v, A.data)
    elif u == "U":
        v = torch.where(r <= c, v, A.data)
    return A.like(v.expand(A.data.shape).clone()).zero_pad()


def geadd(A: TileMatrix, B: TileMatrix, alpha=1.0, beta=1.0,
          trans: str = "N") -> TileMatrix:
    """B = alpha op(A) + beta B (dplasma_zgeadd)."""
    bd = B.to_dense()
    newb = _scalar(alpha, bd) * _op(A.to_dense(), trans) \
        + _scalar(beta, bd) * bd
    return TileMatrix.from_dense(newb, B.desc.mb, B.desc.nb, B.desc.dist)


def tradd(A: TileMatrix, B: TileMatrix, alpha=1.0, beta=1.0,
          uplo: str = "L", trans: str = "N") -> TileMatrix:
    """Triangular add: the uplo triangle of B gets alpha op(A) + beta B;
    the rest of B is untouched (dplasma_ztradd)."""
    bd = B.to_dense()
    m = _tri_mask(B.desc.M, B.desc.N, uplo, B.device)
    newb = torch.where(m, _scalar(alpha, bd) * _op(A.to_dense(), trans)
                       + _scalar(beta, bd) * bd, bd)
    return TileMatrix.from_dense(newb, B.desc.mb, B.desc.nb, B.desc.dist)


def lascal(A: TileMatrix, alpha, uplo: str = "A") -> TileMatrix:
    """Scale (a triangle of) A by alpha (dplasma_zlascal)."""
    scaled = A.data * _scalar(alpha, A.data)
    if uplo.upper() in ("A", "G"):
        return A.like(scaled)
    m = _tri_mask(A.desc.Mp, A.desc.Np, uplo, A.device)
    return A.like(torch.where(m, scaled, A.data))


def ger(alpha, x, y, A: TileMatrix, conj_y: bool = True) -> TileMatrix:
    """Rank-1 update A += alpha x y^{H or T} (dplasma_zgerc / zgeru)."""
    x = torch.as_tensor(x, dtype=A.dtype, device=A.device)
    y = torch.as_tensor(y, dtype=A.dtype, device=A.device)
    yv = y.conj() if conj_y else y
    out = A.data.clone()
    out[: x.shape[0], : y.shape[0]] += _scalar(alpha, out) * torch.outer(
        x, yv)
    return A.like(out)
