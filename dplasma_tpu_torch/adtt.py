"""Lazy LAPACK-layout <-> tiled interop — the ADTT role.

Ports ``dplasma_tpu/adtt.py`` (:26-95). The reference runs one JDF on
tile-stored and LAPACK/ScaLAPACK-layout matrices alike by attaching
per-location datatypes that reshape tiles on send and receive
(src/utils/dplasma_lapack_adtt.c:1-389). Here the caller's column-major
buffer stays the storage of record: :class:`LapackView` moves only the
column block an algorithm step touches, and :func:`potrf_lapack` runs
the left-looking blocked Cholesky panel by panel against it, with the
finished column blocks cached on the device (they are the factor: the
device holds factor + one panel, never the whole input). The ScaLAPACK
shim that rides it is ROADMAP queue 1 item 11, step 4.

Each update product goes through ``kernels.blas.dot`` (K1 in f32 when
it is enabled and every dimension is at least 256): with nb-wide blocks
and KT of them, KT·(KT − 1)/2 products (496 at N = 16384, nb = 512).
"""
from __future__ import annotations

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device


class LapackView:
    """A column-major LAPACK buffer with block-granular lazy transfers.

    ``a`` is the caller's 2-D numpy array (typically a zero-copy view
    of an F77 buffer); reads and writes move one column block at a
    time."""

    def __init__(self, a: np.ndarray):
        if a.ndim != 2:
            raise ValueError(f"LapackView takes a 2-D array, got {a.shape}")
        self.a = a
        self.M, self.N = a.shape

    def read_cols(self, j0: int, j1: int, i0: int = 0, device=None):
        """Rows i0:, columns j0:j1 on ``device`` (one transfer). A
        column-major block goes as its transpose, whose rows are the
        buffer's contiguous columns, and is transposed on the device."""
        x = self.a[i0:, j0:j1]
        dev = resolve_device(device)
        if x.strides[0] == x.itemsize:
            blk = torch.from_numpy(np.array(x.T, order="C"))
            return blk.to(dev).T.contiguous()
        return torch.from_numpy(np.array(x, order="C")).to(dev)

    def write_cols_tril(self, j0: int, x: torch.Tensor, i0: int):
        """Write a block back at (i0, j0), masked to the global lower
        triangle (row >= col): the caller's strict upper triangle is
        never touched."""
        arr = x.cpu().numpy()
        m, w = arr.shape
        r = np.arange(i0, i0 + m)[:, None]
        c = np.arange(j0, j0 + w)[None, :]
        mask = r >= c
        tgt = self.a[i0:i0 + m, j0:j0 + w]
        if tgt.strides[0] == tgt.itemsize:     # column-major: in its order
            tgt, arr, mask = tgt.T, arr.T, mask.T
        tgt[mask] = arr[mask]


def potrf_lapack(view: LapackView, nb: int = 512, *, device=None) -> int:
    """Blocked left-looking Cholesky directly on LAPACK-layout storage
    (lower). Step k reads only column block k from the caller's buffer,
    updates it against the device-cached finished blocks, factors and
    solves, writes its lower part back and caches it. Returns LAPACK
    INFO: 0, or at the first panel whose diagonal factor is not
    positive, its 1-based global row (the trailing buffer is left as
    it was). ``device``: the card by default, the CPU only when asked."""
    from dplasma_tpu_torch.kernels import blas as k

    dev = resolve_device(device)
    N = view.N
    if view.M != N:
        raise ValueError("potrf_lapack: square matrices only")
    cols = []            # finished device column blocks (rows s:, nb)
    for s in range(0, N, nb):
        w = min(nb, N - s)
        col = view.read_cols(s, s + w, i0=s, device=dev)   # (N - s, w)
        for j, cj in enumerate(cols):
            off = s - j * nb
            col -= k.dot(cj[off:], cj[off:off + w], tb=True, conj_b=True)
        lkk = k.potrf(col[:w], lower=True)
        if s + w < N:
            pan = k.trsm(lkk, col[w:], side="R", lower=True, trans="C")
            colL = torch.cat([lkk, pan], dim=0)
        else:
            colL = lkk
        view.write_cols_tril(s, colL, i0=s)
        d = torch.diagonal(lkk).real.cpu().numpy()
        bad = np.nonzero((d <= 0) | ~np.isfinite(d))[0]
        if bad.size:
            # LAPACK's contract: stop at the first panel that is not
            # positive definite (written as computed; the rest untouched)
            return s + int(bad[0]) + 1
        cols.append(colL)
    return 0
