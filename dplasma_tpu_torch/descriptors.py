"""Tile-matrix descriptors and storage.

Ports ``dplasma_tpu/descriptors.py``. A :class:`TileMatrix` is ONE
padded 2-D ``torch.Tensor`` carrying a static :class:`TileDesc`; tiles
are slices (views) of it.

Padding semantics are the reference's: ``data`` has shape
(MT*mb, NT*nb); the region beyond (M, N) is owned by the framework.
Generators write zeros there, and factorizations that need a
nonsingular padded diagonal install an identity pad via
:meth:`TileMatrix.pad_diag`. Residual checks slice back to (M, N).

State crosses between the two packages through
:meth:`TileMatrix.from_reference` / :meth:`TileMatrix.to_reference`:
a numpy array of the padded storage plus a plain dict with the fields
of the reference's ``TileDesc`` (``dataclasses.asdict`` of it), so both
packages can factor the very same padded array.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Dist:
    """Block-cyclic distribution descriptor: process grid P×Q,
    supertile factors kp/kq, grid offsets ip/jq (ref
    tests/testing_zpotrf.c:100-103). ``parallel.cyclic`` lays a matrix
    out in block-cyclic slabs by it; the tile ops ignore it."""

    P: int = 1
    Q: int = 1
    kp: int = 1
    kq: int = 1
    ip: int = 0
    jq: int = 0

    def __post_init__(self):
        if self.P < 1 or self.Q < 1 or self.kp < 1 or self.kq < 1:
            raise ValueError(f"invalid distribution {self}")


@dataclasses.dataclass(frozen=True)
class TileDesc:
    """Static shape/tiling metadata for a tile matrix."""

    M: int
    N: int
    mb: int
    nb: int
    dist: Dist = Dist()

    def __post_init__(self):
        if self.M < 0 or self.N < 0 or self.mb < 1 or self.nb < 1:
            raise ValueError(f"invalid descriptor {self}")

    @property
    def MT(self) -> int:
        return max(1, _ceildiv(self.M, self.mb))

    @property
    def NT(self) -> int:
        return max(1, _ceildiv(self.N, self.nb))

    @property
    def Mp(self) -> int:
        """Padded row count."""
        return self.MT * self.mb

    @property
    def Np(self) -> int:
        """Padded column count."""
        return self.NT * self.nb

    @property
    def KT(self) -> int:
        """Number of diagonal tiles."""
        return min(self.MT, self.NT)

    def with_shape(self, M: int, N: int) -> "TileDesc":
        """The same tiling and grid for an M×N matrix."""
        return dataclasses.replace(self, M=M, N=N)

    def transposed(self) -> "TileDesc":
        """The descriptor of the transpose: shapes, tile sizes and the
        process grid swapped (descriptors.py:93-99 of the reference)."""
        d = self.dist
        dist_t = Dist(d.Q, d.P, d.kq, d.kp, d.jq, d.ip)
        return TileDesc(self.N, self.M, self.nb, self.mb, dist_t)

    def to_dict(self) -> dict:
        """The reference ``TileDesc``'s fields as a plain dict."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "TileDesc":
        dist = d.get("dist") or {}
        if isinstance(dist, dict):
            dist = Dist(**dist)
        return TileDesc(int(d["M"]), int(d["N"]), int(d["mb"]),
                        int(d["nb"]), dist)


@dataclasses.dataclass
class TileMatrix:
    """A tiled matrix: padded 2-D storage of shape ``(desc.Mp, desc.Np)``;
    entries beyond ``(M, N)`` are padding (see module docstring)."""

    data: torch.Tensor
    desc: TileDesc

    # -- construction -------------------------------------------------
    @staticmethod
    def zeros(M: int, N: int, mb: int, nb: int, dtype=torch.float32,
              dist: Dist = Dist(), device=None) -> "TileMatrix":
        d = TileDesc(M, N, mb, nb, dist)
        return TileMatrix(torch.zeros((d.Mp, d.Np), dtype=dtype,
                                      device=resolve_device(device)), d)

    @staticmethod
    def from_dense(a: torch.Tensor, mb: int, nb: int,
                   dist: Dist = Dist()) -> "TileMatrix":
        M, N = a.shape
        d = TileDesc(M, N, mb, nb, dist)
        if (d.Mp, d.Np) == (M, N):
            return TileMatrix(a.clone(), d)
        # out of place, so a batched ``a`` (torch.func.vmap) pads too
        return TileMatrix(
            torch.nn.functional.pad(a, (0, d.Np - N, 0, d.Mp - M)), d)

    @staticmethod
    def from_reference(data: np.ndarray, desc: dict,
                       device=None) -> "TileMatrix":
        """The padded storage and descriptor of a reference
        ``TileMatrix`` (``np.asarray(A.data)``,
        ``dataclasses.asdict(A.desc)``) as a port TileMatrix on
        ``device``."""
        d = TileDesc.from_dict(desc)
        t = torch.from_numpy(np.array(data, copy=True)).to(
            resolve_device(device))
        if tuple(t.shape) != (d.Mp, d.Np):
            raise ValueError(f"storage {tuple(t.shape)} does not match "
                             f"descriptor ({d.Mp}, {d.Np})")
        return TileMatrix(t, d)

    def to_reference(self) -> tuple:
        """``(padded storage as numpy, descriptor dict)`` — the inverse
        of :meth:`from_reference`."""
        return self.data.detach().cpu().numpy(), self.desc.to_dict()

    def like(self, data: torch.Tensor) -> "TileMatrix":
        assert data.shape == self.data.shape, (data.shape, self.data.shape)
        return TileMatrix(data, self.desc)

    # -- basic properties ---------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def shape(self):
        return (self.desc.M, self.desc.N)

    @property
    def MT(self) -> int:
        return self.desc.MT

    @property
    def NT(self) -> int:
        return self.desc.NT

    @property
    def mb(self) -> int:
        return self.desc.mb

    @property
    def nb(self) -> int:
        return self.desc.nb

    # -- views ---------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        return self.data[: self.desc.M, : self.desc.N]

    def tile(self, i: int, j: int) -> torch.Tensor:
        """Tile (i, j) as an (mb, nb) view."""
        mb, nb = self.desc.mb, self.desc.nb
        return self.data[i * mb:(i + 1) * mb, j * nb:(j + 1) * nb]

    # The writers below are functional, as the reference's ``.at[]``
    # updates are: each returns a new matrix on a copy of the storage and
    # never writes into ``self.data``.
    def set_tile(self, i: int, j: int, val) -> "TileMatrix":
        return self.set_block(i, i + 1, j, j + 1, val)

    def block(self, i0: int, i1: int, j0: int, j1: int) -> torch.Tensor:
        """Rows of tiles [i0, i1) × cols of tiles [j0, j1) as a 2-D
        view."""
        mb, nb = self.desc.mb, self.desc.nb
        return self.data[i0 * mb: i1 * mb, j0 * nb: j1 * nb]

    def set_block(self, i0: int, i1: int, j0: int, j1: int,
                  val) -> "TileMatrix":
        out = self.like(self.data.clone())
        out.block(i0, i1, j0, j1)[...] = val
        return out

    def add_block(self, i0: int, i1: int, j0: int, j1: int,
                  val) -> "TileMatrix":
        out = self.like(self.data.clone())
        out.block(i0, i1, j0, j1)[...] += val
        return out

    # -- padding management -------------------------------------------
    def zero_pad(self) -> "TileMatrix":
        """Force the padding region to zero (a copy when there is
        padding; ``self`` when there is none)."""
        M, N = self.desc.M, self.desc.N
        Mp, Np = self.desc.Mp, self.desc.Np
        if Mp == M and Np == N:
            return self
        data = self.data.clone()
        data[M:, :] = 0
        data[:M, N:] = 0
        return self.like(data)

    def pad_diag(self, value=1.0) -> "TileMatrix":
        """Set the padded diagonal to ``value`` (and pad off-diag to
        zero), so chol/LU/trsm of blkdiag(A, value*I) leave the (M, N)
        region exact."""
        d = self.desc
        K = min(d.M, d.N)
        Kp = min(d.Mp, d.Np)
        out = self.zero_pad()
        if Kp == K:
            return out
        idx = torch.arange(K, Kp, device=self.device)
        out.data[idx, idx] = value
        return out

    def subtile_view(self, i: int, j: int, mb2: int, nb2: int) \
            -> "TileMatrix":
        """Tile (i, j) as its own TileMatrix with finer mb2×nb2 tiling
        (the ``subtile_desc_create`` analogue backing -z/--HNB)."""
        return TileMatrix.from_dense(self.tile(i, j), mb2, nb2)

    def sym_mirror(self, uplo: str = "L", conj: bool = True) \
            -> "TileMatrix":
        """Both triangles materialized from the stored ``uplo`` one (the
        access path the reference's symmetric block-cyclic descriptor
        provides implicitly); under ``conj`` the diagonal is its real
        part, as a Hermitian matrix's is."""
        x = self.zero_pad().data
        if uplo.upper() == "L":
            lo = torch.tril(x)
        else:
            lo = torch.triu(x).mH if conj else torch.triu(x).T
        full = lo + (lo.mH if conj else lo.T)
        # lo's diagonal is x's (conjugated for a mirrored U)
        diag = x.diagonal()
        full.diagonal().copy_(diag.real if conj and diag.is_complex()
                              else diag)
        return self.like(full.to(self.dtype))

    def astype(self, dtype) -> "TileMatrix":
        return self.like(self.data.to(dtype, copy=True))

    def __repr__(self):
        d = self.desc
        return (f"TileMatrix({d.M}x{d.N}, tiles {d.mb}x{d.nb} "
                f"[{d.MT}x{d.NT}], dist P={d.dist.P} Q={d.dist.Q}, "
                f"{self.data.dtype}, {self.data.device})")


@dataclasses.dataclass
class BandMatrix:
    """LAPACK band storage: row ``d`` of ``data`` holds diagonal
    ``ku - d`` (columns aligned with the global column index), shape
    (kl+ku+1, N). Ports the reference's ``BandMatrix``
    (dplasma_tpu/descriptors.py:260-308): O(N·band) storage for the band
    stages of the eigen/SVD chains."""

    data: torch.Tensor
    M: int
    N: int
    kl: int
    ku: int

    @staticmethod
    def from_dense(a: torch.Tensor, kl: int, ku: int) -> "BandMatrix":
        M, N = a.shape
        data = torch.zeros((kl + ku + 1, N), dtype=a.dtype, device=a.device)
        for i, d in enumerate(range(ku, -kl - 1, -1)):   # diag ku .. -kl
            diag = torch.diagonal(a, offset=d)
            pre = max(d, 0)
            data[i, pre:pre + diag.shape[0]] = diag
        return BandMatrix(data, M, N, kl, ku)

    @staticmethod
    def from_tiles(A: TileMatrix, kl: int, ku: int) -> "BandMatrix":
        return BandMatrix.from_dense(A.to_dense(), kl, ku)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.M, self.N), dtype=self.data.dtype,
                          device=self.data.device)
        for i, d in enumerate(range(self.ku, -self.kl - 1, -1)):
            n = torch.diagonal(out, offset=d).shape[0]
            pre = max(d, 0)
            torch.diagonal(out, offset=d).copy_(self.data[i, pre:pre + n])
        return out

    def diagonal(self, offset: int = 0) -> torch.Tensor:
        assert -self.kl <= offset <= self.ku, offset
        row = self.ku - offset
        pre = max(offset, 0)
        n = min(self.M + min(offset, 0), self.N - max(offset, 0))
        return self.data[row, pre:pre + n]
