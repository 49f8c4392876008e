"""The map framework: generic per-tile operator application.

Ports ``dplasma_tpu/ops/map.py`` (:28-111), the reference's
``dplasma_map`` / ``dplasma_map2`` (src/map_wrapper.c:21-61,
src/map2.jdf). The padded matrix is viewed as a (MT, NT, mb, nb) tile
tensor and the tile operator is ``torch.func.vmap``-ed over the tile
grid, one batched call for all tiles. :func:`to_tiles` /
:func:`from_tiles` take any leading batch axes.
"""
from __future__ import annotations

from typing import Callable

import torch

from dplasma_tpu_torch.descriptors import TileDesc, TileMatrix


def to_tiles(data: torch.Tensor, desc: TileDesc) -> torch.Tensor:
    """``(..., Mp, Np) -> (..., MT, NT, mb, nb)`` tile tensor view;
    leading axes pass through untouched."""
    lead = data.shape[:-2]
    assert tuple(data.shape[-2:]) == (desc.Mp, desc.Np), \
        (data.shape, desc.Mp, desc.Np)
    t = data.reshape(*lead, desc.MT, desc.mb, desc.NT, desc.nb)
    return t.transpose(-3, -2)


def from_tiles(tiles: torch.Tensor, desc: TileDesc) -> torch.Tensor:
    """Inverse of :func:`to_tiles`: ``(..., MT, NT, mb, nb) ->
    (..., Mp, Np)``."""
    lead = tiles.shape[:-4]
    assert tuple(tiles.shape[-4:]) == (desc.MT, desc.NT, desc.mb,
                                       desc.nb), (tiles.shape, desc)
    return tiles.transpose(-3, -2).reshape(*lead, desc.Mp, desc.Np)


def _coords(desc: TileDesc, device):
    return (torch.arange(desc.MT, dtype=torch.int32, device=device),
            torch.arange(desc.NT, dtype=torch.int32, device=device))


def map_tiles(A: TileMatrix,
              op: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                           torch.Tensor]) -> TileMatrix:
    """Apply ``op(i, j, tile) -> tile`` to every tile (dplasma_map).

    ``i``/``j`` are int32 scalar tensors (the tile coordinates); ``op``
    must be vmappable. The result is cast back to ``A``'s dtype: the
    reference's map writes into A's own tiles, so an operator whose
    arithmetic promotes must not widen the matrix storage."""
    ii, jj = _coords(A.desc, A.device)
    f = torch.func.vmap(torch.func.vmap(op, in_dims=(None, 0, 0)),
                        in_dims=(0, None, 0))
    out = f(ii, jj, to_tiles(A.data, A.desc))
    return A.like(from_tiles(out, A.desc).to(A.dtype))


def map2_tiles(A: TileMatrix, B: TileMatrix,
               op: Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor], torch.Tensor]) -> TileMatrix:
    """Apply ``op(i, j, tileA, tileB) -> tileB`` pairwise (dplasma_map2).

    Both operands must share the whole tile geometry (equal tile counts
    alone would pair tiles covering different global regions). The
    result takes ``B``'s dtype, as map2 writes B's tiles."""
    assert A.desc.MT == B.desc.MT and A.desc.NT == B.desc.NT, \
        (A.desc, B.desc)
    assert A.desc.mb == B.desc.mb and A.desc.nb == B.desc.nb, \
        ("map2_tiles needs matching tile shapes", A.desc, B.desc)
    ii, jj = _coords(A.desc, A.device)
    f = torch.func.vmap(torch.func.vmap(op, in_dims=(None, 0, 0, 0)),
                        in_dims=(0, None, 0, 0))
    out = f(ii, jj, to_tiles(A.data, A.desc), to_tiles(B.data, B.desc))
    return B.like(from_tiles(out, B.desc).to(B.dtype))


def elementwise(A: TileMatrix, op: Callable[[torch.Tensor], torch.Tensor]
                ) -> TileMatrix:
    """Whole-matrix elementwise op, padding kept zero."""
    return A.like(op(A.data)).zero_pad()
