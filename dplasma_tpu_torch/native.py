"""The runtime half of ``dplasma_tpu/native.py`` that the instruments
need, as its pure-Python path: the block-cyclic owner maps and the
DTPUPROF1 binary trace.

Ports ``rank_of`` (:91), ``rank_grid`` (:105), ``TraceWriter``
(:221-274) and ``read_trace`` (:276-316). The file format is the
reference's byte for byte: a trace written here reads with the
reference's ``read_trace``, and one written there reads here.

Not ported yet (ROADMAP queue 1 item 15): the ctypes binding to
``native/build/libdplasma_rt.so`` (the reference uses it when built and
falls back to the same pure-Python code otherwise), ``wavefront_order``
and ``potrf_priority``, which the DAG builders read.
"""
from __future__ import annotations

import struct

import numpy as np

#: DTPUPROF1 on-disk magic
TRACE_MAGIC = b"DTPUPROF1"


# ---------------------------------------------------------------------
# Block-cyclic owner maps
# ---------------------------------------------------------------------

def rank_of(dist, i: int, j: int) -> int:
    """Owner rank of tile (i, j): the single-tile form of
    :func:`rank_grid`. ``dist`` is any object with P/Q/kp/kq/ip/jq
    (``descriptors.Dist``)."""
    pr = (i // dist.kp + dist.ip) % dist.P
    pc = (j // dist.kq + dist.jq) % dist.Q
    return int(pr * dist.Q + pc)


def rank_grid(dist, MT: int, NT: int) -> np.ndarray:
    """Owner rank of every tile: an (MT, NT) int32 array."""
    i = np.arange(MT)[:, None]
    j = np.arange(NT)[None, :]
    pr = (i // dist.kp + dist.ip) % dist.P
    pc = (j // dist.kq + dist.jq) % dist.Q
    return (pr * dist.Q + pc).astype(np.int32)


# ---------------------------------------------------------------------
# Binary trace writer
# ---------------------------------------------------------------------

class TraceWriter:
    """Binary profiling trace (DTPUPROF1; the PaRSEC-trace analogue).

    After the magic, one record per call: an event is ``0x01``, the
    name's length (int32 LE), the name (UTF-8), then begin_ns, end_ns
    (int64 LE) and flops (float64 LE); an info pair is ``0x02``, then
    length-prefixed key and value."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(TRACE_MAGIC)

    def event(self, name: str, begin_ns: int, end_ns: int,
              flops: float = 0.0) -> None:
        nb = name.encode()
        self._f.write(b"\x01" + struct.pack("<i", len(nb)) + nb
                      + struct.pack("<qqd", begin_ns, end_ns, flops))

    def info(self, key: str, val: str) -> None:
        kb, vb = key.encode(), val.encode()
        self._f.write(b"\x02" + struct.pack("<i", len(kb)) + kb
                      + struct.pack("<i", len(vb)) + vb)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trace(path: str, strict: bool = True):
    """Parse a DTPUPROF1 file into (events, info): events are
    ``(name, begin_ns, end_ns, flops)`` tuples, info a dict.

    ``strict=False`` tolerates a truncated final record (a run killed
    mid-write) and returns everything before the tear instead of
    raising."""

    def take(f, n: int) -> bytes:
        buf = f.read(n)
        if len(buf) != n:
            raise EOFError(f"truncated trace record in {path}")
        return buf

    events, info = [], {}
    with open(path, "rb") as f:
        magic = f.read(len(TRACE_MAGIC))
        if magic != TRACE_MAGIC:
            raise ValueError(f"bad trace magic {magic!r}")
        try:
            while True:
                tag = f.read(1)
                if not tag:
                    break
                if tag == b"\x01":
                    (n,) = struct.unpack("<i", take(f, 4))
                    name = take(f, n).decode()
                    b, e, fl = struct.unpack("<qqd", take(f, 24))
                    events.append((name, b, e, fl))
                elif tag == b"\x02":
                    (n,) = struct.unpack("<i", take(f, 4))
                    key = take(f, n).decode()
                    (n,) = struct.unpack("<i", take(f, 4))
                    info[key] = take(f, n).decode()
                else:
                    raise ValueError(f"bad trace tag {tag!r}")
        except EOFError:
            if strict:
                raise
    return events, info
