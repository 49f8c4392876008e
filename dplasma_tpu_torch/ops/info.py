"""INFO propagation — the factorization failure-detection path.

Ports ``dplasma_tpu/ops/info.py`` (:24-32). The reference's DPLASMA
reduces each rank's local ``iinfo`` with ``MPI_Allreduce(MAX)``
(src/zpotrf_L.jdf:176-187, src/zpotrf_wrapper.c:327-333); a failed tile
factorization here leaves NaN or Inf in the factor (``blas.potrf`` NaNs
a tile that is not positive definite), and the INFO equivalent is a
scan on the device: the first row of the stored triangle with a
non-finite entry.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops.aux import _tri_mask


def factor_info(F: TileMatrix, uplo: str = "L") -> torch.Tensor:
    """LAPACK-style INFO of a computed factor, an int32 scalar tensor on
    its device: 0 if every entry of the stored triangle is finite, else
    the 1-based index of the first row with one that is not."""
    x = F.to_dense()
    bad = ~torch.isfinite(x) & _tri_mask(x.shape[0], x.shape[1], uplo,
                                         x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    bad_row = torch.where(bad.any(dim=1), rows, x.shape[0])
    first = bad_row.min() if x.shape[0] else rows.new_zeros(())
    return torch.where(first == x.shape[0], 0, first + 1).to(torch.int32)
