"""Matrix norms.

Ports ``_norm2d``, ``lange`` and ``_sym_full`` of
``dplasma_tpu/ops/norms.py``: one reduction over the dense view.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix


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
