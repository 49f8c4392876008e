"""Auxiliary tile-matrix helpers.

Ports ``_tri_mask`` of ``dplasma_tpu/ops/aux.py``; the map-framework
clients (lacpy, laset, geadd, ...) wait for a later slice.
"""
from __future__ import annotations

import torch


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
