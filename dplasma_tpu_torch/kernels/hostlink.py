"""The host link of the out-of-HBM tiers (``potrf_lowmem``,
``getrf_lowmem``, ``geqrf_lowmem``).

Those tiers keep the matrix on the host and stream column blocks of it
through a device working set held to a byte budget. The reference ships
each block as a strided numpy slice through ``jnp.asarray``
(dplasma_tpu/ops/potrf.py:322-330, lu.py:838-843, qr.py:466-476). Their
pace is set by the host link, not by HBM or the tensor cores, so
:class:`HostMatrix` does two things about it on the card:

- the working host copy lives in pinned memory (a numpy view of it is
  the reference's host array), and every block moves as one pitched
  2-D copy (``csrc/host_copy.cu``, ``cudaMemcpy2DAsync``) straight from
  or into it: ``Tensor.copy_`` of a strided host slice would first gather
  it into pageable memory, losing the pinned rate and the asynchrony;
- uploads run in order on the caller's (compute) stream; write-backs
  run on a stream of their own, after an event on the compute stream,
  so the next panel's uploads overlap the previous panel's write-back.
  An upload whose host block overlaps a write-back still in flight
  waits for that write-back's event first (a left-looking sweep reads
  the panel it just wrote with its very next panel's last chunk), and
  host code that writes the matrix (``permute_rows``) waits for every
  copy that touches the rows it writes. Each written-back device buffer
  is recorded on the write-back stream, so the allocator does not reuse
  it before its copy has read it.

On the CPU (the tests) a block is a plain copy of the host slice; the
schedule and the byte counts are the same. :data:`STATS` counts the
bytes and copies each way, the largest single upload, the rows and
host time of ``permute_rows`` (the LU's physical row swaps) and the host
time of copying the inputs in.
:data:`OVERLAP` set to False makes every copy synchronous (the test of
the ordering compares the two bitwise).
"""
from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

#: False: every copy blocks until it is done (no write-back stream)
OVERLAP = True

_H2D, _D2H = 1, 2          # cudaMemcpyKind
_FN = None


@dataclasses.dataclass
class LinkStats:
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    h2d_copies: int = 0
    d2h_copies: int = 0
    largest_h2d: int = 0
    swapped_rows: int = 0
    swap_s: float = 0.0
    setup_s: float = 0.0       # host copies of the inputs (pinned on the card)


#: transfers of every HostMatrix since the last :func:`reset_stats`
STATS = LinkStats()


def reset_stats() -> None:
    STATS.__init__()


def _copy2d():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        fn = _build.load("host_copy").dtt_copy2d
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _overlaps(a0, a1, b0, b1) -> bool:
    return a0 < b1 and b0 < a1


class HostMatrix:
    """A row-major host copy of ``a`` that blocks stream to and from
    ``device``. :attr:`a` is the reference's host array (a numpy view of
    the pinned buffer on the card)."""

    def __init__(self, a, device: torch.device):
        t0 = time.perf_counter()
        arr = np.asarray(a)
        if arr.ndim != 2:
            raise ValueError(f"a host matrix is 2-D, got {arr.shape}")
        self.device = device
        if device.type == "cuda":
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            self.t = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            if arr.flags.writeable:         # torch's copy runs on all cores
                self.t.copy_(torch.from_numpy(arr))
            else:
                self.t.numpy()[...] = arr
            self._stream = torch.cuda.Stream(device)
        else:
            self.t = torch.from_numpy(np.array(arr, order="C", copy=True))
        self.a = self.t.numpy()
        self._item = self.a.itemsize
        self._ld = self.a.shape[1]
        self._pending = []     # (r0, r1, c0, c1, event) write-backs
        STATS.setup_s += time.perf_counter() - t0

    def _host_ptr(self, r: int, c: int) -> int:
        return self.t.data_ptr() + (r * self._ld + c) * self._item

    def _launch(self, dst, dpitch, src, spitch, width, height, kind, stream):
        err = _copy2d()(dst, dpitch, src, spitch, width, height, kind,
                        stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"cudaMemcpy2DAsync failed: cudaError {err} "
                               f"({height} rows of {width} bytes)")

    def upload(self, r0: int, r1: int, c0: int, c1: int) -> torch.Tensor:
        """Rows [r0, r1) × columns [c0, c1) as a new contiguous tensor on
        the device, one copy on the current stream."""
        rows, cols = r1 - r0, c1 - c0
        nbytes = rows * cols * self._item
        STATS.h2d_bytes += nbytes
        STATS.h2d_copies += 1
        STATS.largest_h2d = max(STATS.largest_h2d, nbytes)
        if self.device.type != "cuda":
            return self.t[r0:r1, c0:c1].clone(
                memory_format=torch.contiguous_format)
        out = torch.empty((rows, cols), dtype=self.t.dtype,
                          device=self.device)
        cur = torch.cuda.current_stream(self.device)
        for p in self._pending:
            if _overlaps(r0, r1, p[0], p[1]) and _overlaps(c0, c1, p[2],
                                                           p[3]):
                cur.wait_event(p[4])
        if nbytes:
            self._launch(out.data_ptr(), cols * self._item,
                         self._host_ptr(r0, c0), self._ld * self._item,
                         cols * self._item, rows, _H2D, cur)
        if not OVERLAP:
            cur.synchronize()
        return out

    def download(self, x: torch.Tensor, r0: int, c0: int) -> None:
        """Write ``x`` into rows r0.. × columns c0.. of the host matrix:
        one copy on the write-back stream after the work queued so far
        on the current stream (on the current stream, blocking, when
        :data:`OVERLAP` is off)."""
        rows, cols = x.shape
        STATS.d2h_bytes += rows * cols * self._item
        STATS.d2h_copies += 1
        if self.device.type != "cuda":
            self.t[r0:r0 + rows, c0:c0 + cols].copy_(x)
            return
        x = x.contiguous()
        cur = torch.cuda.current_stream(self.device)
        args = (self._host_ptr(r0, c0), self._ld * self._item,
                x.data_ptr(), cols * self._item, cols * self._item, rows,
                _D2H)
        if not OVERLAP:
            self._launch(*args, cur)
            cur.synchronize()
            return
        self._stream.wait_event(cur.record_event())
        self._launch(*args, self._stream)
        x.record_stream(self._stream)
        self._pending = [p for p in self._pending if not p[4].query()]
        self._pending.append((r0, r0 + rows, c0, c0 + cols,
                              self._stream.record_event()))

    def _fence(self, r0: int = 0, skip0: int = 0, skip1: int = 0) -> None:
        """Every copy that touches host rows r0.. outside columns
        [skip0, skip1) done, so host code may write them: the uploads
        (on the current stream) and the overlapping write-backs."""
        if self.device.type != "cuda":
            return
        torch.cuda.current_stream(self.device).synchronize()
        keep = []
        for p in self._pending:
            if p[1] > r0 and (p[2] < skip0 or p[3] > skip1):
                p[4].synchronize()
            else:
                keep.append(p)
        self._pending = keep

    def permute_rows(self, r0: int, perm: np.ndarray, skip0: int,
                     skip1: int) -> None:
        """Host rows r0 + i take rows r0 + perm[i], in every column
        outside [skip0, skip1) — the reference's ``Ah[s:, cols] =
        Ah[s:, cols][perm]``, applied to the rows ``perm`` moves only
        (gathered before they are scattered)."""
        t0 = time.perf_counter()
        moved = np.nonzero(perm != np.arange(perm.shape[0]))[0]
        if moved.size:
            self._fence(r0, skip0, skip1)
            dst, src = r0 + moved, r0 + perm[moved]
            for c0, c1 in ((0, skip0), (skip1, self._ld)):
                if c1 > c0:
                    self.a[dst, c0:c1] = self.a[src, c0:c1]
        STATS.swapped_rows += int(moved.size)
        STATS.swap_s += time.perf_counter() - t0

    def finish(self) -> np.ndarray:
        """The host array, every write-back done."""
        self._fence()
        return self.a
