"""Seeded matrix generators: ``plrnt`` (random), ``plghe`` (Hermitian,
diagonally bumped → SPD) and ``plgsy`` (symmetric, diagonally bumped).

Ports ``dplasma_tpu/ops/generators.py`` bit for bit: every element is
an avalanche hash of (seed, global row, global col), so the values do
not depend on tiling, device or package.

torch's ``uint32`` lacks most arithmetic, so the hash runs in ``int64``
holding values in [0, 2^32). A 32×32-bit product would overflow int64;
:func:`_mul32` multiplies by the constant's 16-bit halves instead,
which gives the wrapped uint32 product exactly. The hash then converts
to the real dtype through float64 (exact below 2^53), whose rounding to
float32 is round-to-nearest-even — what XLA's uint32 → float32
conversion does.

A complex element takes its real part from the hash of ``seed`` and its
imaginary part from the hash of ``seed + 1`` (wrapped to 32 bits), both
in the real dtype. For the real dtypes ``plghe`` and ``plgsy`` are the
same matrix, as in the reference.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.descriptors import Dist, TileDesc, TileMatrix

_MASK = 0xFFFFFFFF
_C1 = 0x7feb352d
_C2 = 0x846ca68b
_R1 = 0x85ebca6b
_R2 = 0xc2b2ae35
_GOLDEN = 0x9e3779b9

# elements hashed per chunk of rows: bounds the int64 temporaries
_CHUNK_ELEMS = 1 << 24


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)                       # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16       # < 2^32
    return (lo + hi) & _MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32-style avalanche mix on uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def _hash2d(seed: int, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The uint32 hash of (seed, i, j) at integer index tensors of any
    (broadcastable) shape, as int64 values in [0, 2^32); an index wraps
    to 32 bits as the reference's ``astype(uint32)`` wraps it."""
    h = _mix(torch.tensor((seed & _MASK) ^ _GOLDEN, device=i.device))
    h = _mix(h ^ _mul32(i.to(torch.int64) & _MASK, _R1))
    return _mix(h ^ _mul32(j.to(torch.int64) & _MASK, _R2))


def _uniform(seed: int, i: torch.Tensor, j: torch.Tensor,
             real_dtype) -> torch.Tensor:
    """U(-0.5, 0.5) at global elements (i, j), in ``real_dtype``."""
    u = _hash2d(seed, i, j).to(torch.float64).to(real_dtype) * (2.0 ** -32)
    return 0.5 - u


def _grid(desc: TileDesc, device):
    """Row and column index tensors (Mp, 1) and (1, Np) of the padded
    grid (int64)."""
    r = torch.arange(desc.Mp, device=device)[:, None]
    c = torch.arange(desc.Np, device=device)[None, :]
    return r, c


def _value(seed: int, r: torch.Tensor, c: torch.Tensor,
           dtype) -> torch.Tensor:
    """The generators' value at (r, c): uniform in the real dtype; a
    complex element's real part from ``seed``, its imaginary part from
    ``seed + 1``."""
    if dtype.is_complex:
        rdt = dtype.to_real()
        return torch.complex(_uniform(seed, r, c, rdt),
                             _uniform(seed + 1, r, c, rdt))
    return _uniform(seed, r, c, dtype)


def _uniform_rows(seed: int, r0: int, r1: int, ncols: int, dtype,
                  device) -> torch.Tensor:
    """U(-0.5, 0.5) at global elements [r0, r1) × [0, ncols) (the row
    part of the hash once a row)."""
    return _uniform(seed, torch.arange(r0, r1, device=device)[:, None],
                    torch.arange(ncols, device=device)[None, :], dtype)


def _hash_grid(seed: int, desc: TileDesc, dtype, device) -> torch.Tensor:
    """The uniform value at every (row, col) of the padded grid; for a
    complex dtype the real part from ``seed``, the imaginary part from
    ``seed + 1``."""
    out = torch.empty((desc.Mp, desc.Np), dtype=dtype, device=device)
    parts = ((out.real, seed), (out.imag, seed + 1)) if dtype.is_complex \
        else ((out, seed),)
    step = max(1, _CHUNK_ELEMS // max(desc.Np, 1))
    for r0 in range(0, desc.Mp, step):
        r1 = min(r0 + step, desc.Mp)
        for dst, sd in parts:
            dst[r0:r1] = _uniform_rows(sd, r0, r1, desc.Np, dst.dtype,
                                       device)
    return out


def _mask_mn(desc: TileDesc, x: torch.Tensor) -> torch.Tensor:
    x[desc.M:, :] = 0
    x[:, desc.N:] = 0
    return x


def _bump_diag(x: torch.Tensor, bump) -> None:
    d = x.diagonal()
    d += torch.tensor(bump, dtype=x.dtype, device=x.device)


def plrnt(M: int, N: int, mb: int, nb: int, seed: int = 3872,
          dtype=torch.float32, diagdom: bool = False,
          dist: Dist = Dist(), device=None) -> TileMatrix:
    """Random matrix (dplasma_zplrnt). ``diagdom`` adds max(M,N) to the
    diagonal."""
    dev = resolve_device(device)
    desc = TileDesc(M, N, mb, nb, dist)
    v = _hash_grid(seed, desc, dtype, dev)
    if diagdom:
        _bump_diag(v, max(M, N))
    return TileMatrix(_mask_mn(desc, v), desc)


def _bumped_symmetric(bump, N, nb, seed, dtype, mb, dist, device,
                      hermitian: bool):
    """Element (r, c) takes the hash of the unordered pair (max, min),
    plus ``bump`` on the diagonal. ``hermitian`` (plghe) conjugates the
    upper triangle and keeps only the real part of the diagonal; for
    real dtypes it changes nothing."""
    dev = resolve_device(device)
    mb = mb or nb
    desc = TileDesc(N, N, mb, nb, dist)
    g = _hash_grid(seed, desc, dtype, dev)
    # the lower triangle of g as it is, the upper mirrored from it
    v = torch.tril(g)
    v += torch.triu(g.T.conj() if hermitian else g.T, 1)
    del g
    if hermitian and dtype.is_complex:
        v.diagonal().imag.zero_()
    _bump_diag(v, bump)
    return TileMatrix(_mask_mn(desc, v), desc)


def plghe(bump: float, N: int, nb: int, seed: int = 3872,
          dtype=torch.float32, mb: int | None = None,
          dist: Dist = Dist(), device=None) -> TileMatrix:
    """Hermitian matrix with a real diagonal + ``bump`` on it
    (dplasma_zplghe). ``bump >= N`` yields a positive-definite
    matrix."""
    return _bumped_symmetric(bump, N, nb, seed, dtype, mb, dist, device,
                             hermitian=True)


def plgsy(bump: float, N: int, nb: int, seed: int = 3872,
          dtype=torch.float32, mb: int | None = None,
          dist: Dist = Dist(), device=None) -> TileMatrix:
    """Symmetric (for complex dtypes: complex-symmetric, not Hermitian)
    matrix + ``bump`` on the diagonal (dplasma_zplgsy)."""
    return _bumped_symmetric(bump, N, nb, seed, dtype, mb, dist, device,
                             hermitian=False)
