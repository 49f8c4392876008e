"""Block-cyclic index algebra.

A copy of ``dplasma_tpu/parallel/layout.py`` (numpy only; the port
imports nothing of the reference). Pure integer functions reproducing
the semantics of PaRSEC's ``parsec_matrix_block_cyclic_t``
owner/local-index maps (ref tests/testing_zpotrf.c:100-103; supertile
factors KP/KQ and grid offsets IP/JQ parsed at tests/common.c:79-93).
They run on the host (plain Python ints / numpy): the rank map shapes
the slabs of ``parallel/cyclic.py`` and the collective schedule;
nothing here runs on the device.

Conventions (one axis; rows and columns are independent):
  - ``nt``   number of tiles on the axis
  - ``P``    number of ranks on the axis
  - ``kp``   supertile (k-cyclic) factor: consecutive runs of ``kp`` tiles
             share an owner before cycling
  - ``ip``   grid offset: rank owning tile 0
owner(t)      = ((t // kp) + ip) % P
local index   = (t // (kp * P)) * kp + t % kp        (within owner)
"""
from __future__ import annotations

import numpy as np


def owner(t, P: int, kp: int = 1, ip: int = 0):
    """Rank owning tile ``t`` on a P-rank axis (vectorized-safe)."""
    return ((t // kp) + ip) % P


def local_index(t, P: int, kp: int = 1):
    """Index of tile ``t`` within its owner's local tile list."""
    return (t // (kp * P)) * kp + t % kp


def global_index(l, p, P: int, kp: int = 1, ip: int = 0):
    """Inverse of (owner, local_index): global tile of local slot ``l`` on
    rank ``p``."""
    cycle = l // kp
    within = l % kp
    return (cycle * P + (p - ip) % P) * kp + within


def local_count(nt: int, p: int, P: int, kp: int = 1, ip: int = 0) -> int:
    """Number of tiles on axis owned by rank ``p``."""
    t = np.arange(nt)
    return int(np.count_nonzero(owner(t, P, kp, ip) == p))


def max_local_count(nt: int, P: int, kp: int = 1) -> int:
    """Upper bound of local_count over ranks (ceil-uniform padding size)."""
    full_cycles, rem = divmod(nt, kp * P)
    return full_cycles * kp + min(rem, kp)


def cyclic_permutation(nt: int, P: int, kp: int = 1, ip: int = 0) -> np.ndarray:
    """Storage permutation grouping tiles by owner.

    Returns ``perm`` with ``perm[storage_slot] = global_tile`` such that
    slots are ordered (rank 0 locals..., rank 1 locals..., ...). Sharding
    the permuted axis into P contiguous chunks then realizes the
    block-cyclic distribution with XLA's contiguous partitioning.
    """
    t = np.arange(nt)
    own = owner(t, P, kp, ip)
    loc = local_index(t, P, kp)
    order = np.lexsort((loc, own))
    return t[order]


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def rank_of(i, j, *, P: int, Q: int, kp: int = 1, kq: int = 1,
            ip: int = 0, jq: int = 0):
    """2-D rank (p, q) owning tile (i, j) — the reference's ``rank_of``."""
    return owner(i, P, kp, ip), owner(j, Q, kq, jq)


def owners_grid(MT: int, NT: int, *, P: int, Q: int, kp: int = 1,
                kq: int = 1, ip: int = 0, jq: int = 0) -> np.ndarray:
    """(MT, NT) array of linear ranks p*Q+q — for debugging/visualisation
    and for the redistribution engine."""
    pi = owner(np.arange(MT), P, kp, ip)[:, None]
    qj = owner(np.arange(NT), Q, kq, jq)[None, :]
    return pi * Q + qj
