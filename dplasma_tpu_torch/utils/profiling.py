"""Run profiles and kernel trace prints (``dplasma_tpu/utils/profiling.py``).

* :class:`Profile` — wall-clock spans and run metadata, written as a
  DTPUPROF1 trace (:mod:`dplasma_tpu_torch.native`); ``save_info`` /
  ``save_dinfo`` mirror the reference's ``PROFILING_SAVE_[di]INFO``
  (tests/common.h:198-231). The drivers' ``--profile`` writes one.
* :func:`torch_trace` — device-side kernel tracing through
  ``torch.profiler`` (the reference's ``jax_trace``, :163), a Chrome
  trace in ``logdir``; the drivers' ``--jaxtrace`` keeps its spelling.
* :func:`printlog` — kernel trace print, on when
  ``DPLASMA_TRACE_KERNELS`` is set (read at call time).

``DagRecorder`` and ``recording`` (the ``--dot`` DAG dump) wait for
ROADMAP queue 1 item 15: they need the ops' ``dag()`` builders.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

from dplasma_tpu_torch import native

# Programmatic override for kernel tracing; None = defer to the env,
# read at CALL time so a test's monkeypatched environment takes effect.
_TRACE_KERNELS_OVERRIDE: Optional[bool] = None


def set_trace_kernels(enabled: Optional[bool]) -> None:
    """Force kernel trace prints on/off; ``None`` defers to the
    ``DPLASMA_TRACE_KERNELS`` environment variable again."""
    global _TRACE_KERNELS_OVERRIDE
    _TRACE_KERNELS_OVERRIDE = enabled


def trace_kernels_enabled() -> bool:
    if _TRACE_KERNELS_OVERRIDE is not None:
        return _TRACE_KERNELS_OVERRIDE
    try:
        return bool(int(os.environ.get("DPLASMA_TRACE_KERNELS", "0")))
    except ValueError:
        return False


def printlog(fmt: str, *args) -> None:
    """Kernel-level trace print, silent unless DPLASMA_TRACE_KERNELS is
    set (ref src/dplasmajdf.h:21-31)."""
    if trace_kernels_enabled():
        print("[dplasma_tpu] " + (fmt % args if args else fmt), flush=True)


# Track-id separator inside DTPUPROF1 event names: spans on track != 0
# serialize as "<name>\x1f<track>", so the on-disk format stays the
# reference's while a reader recovers the (rank, track) lanes.
TRACK_SEP = "\x1f"


class Profile:
    """Run profile: named spans + metadata, serialized as DTPUPROF1.

    Spans carry a ``track`` (a viewer lane: harness phases on 0, timed
    runs on 1); the profile carries the ``rank`` that made it. Usage::

        prof = Profile(rank=0)
        with prof.span("potrf", flops=1e9, track=1):
            run()
        prof.save_dinfo("GFLOPS", gf)
        prof.write("run.prof")
    """

    TRACK_HARNESS = 0
    TRACK_RUN = 1

    def __init__(self, rank: int = 0):
        self.events: List[Tuple[str, int, int, float, int]] = []
        self.info: Dict[str, str] = {}
        self.rank = int(rank)
        self._t0 = time.time_ns()
        self.info["cwd"] = os.getcwd()
        self.info["start_time"] = str(self._t0)
        self.info["rank"] = str(self.rank)

    @contextlib.contextmanager
    def span(self, name: str, flops: float = 0.0, track: int = 0):
        b = time.time_ns()
        try:
            yield
        finally:
            self.events.append((name, b, time.time_ns(), flops,
                                int(track)))

    def add_event(self, name: str, begin_ns: int, end_ns: int,
                  flops: float = 0.0, track: int = 0) -> None:
        """Record an externally timed span."""
        self.events.append((name, int(begin_ns), int(end_ns),
                            float(flops), int(track)))

    def save_info(self, key: str, value) -> None:
        self.info[str(key)] = str(value)

    def save_dinfo(self, key: str, value: float) -> None:
        self.info[str(key)] = repr(float(value))

    def write(self, path: str) -> None:
        with native.TraceWriter(path) as t:
            for k, v in self.info.items():
                t.info(k, v)
            for name, b, e, fl, track in self.events:
                wire = name if track == 0 else f"{name}{TRACK_SEP}{track}"
                t.event(wire, b, e, fl)

    @classmethod
    def load(cls, path: str, strict: bool = True) -> "Profile":
        """Read a DTPUPROF1 file back (track ids decoded)."""
        raw_events, info = native.read_trace(path, strict=strict)
        prof = cls(rank=int(info.get("rank", 0) or 0))
        prof.info = dict(info)
        prof.events = decode_wire_events(raw_events)
        return prof


def decode_wire_events(raw_events):
    """Split raw ``native.read_trace`` 4-tuples into 5-tuples with the
    track decoded from the ``TRACK_SEP`` name suffix."""
    out = []
    for wire, b, e, fl in raw_events:
        name, sep, tr = wire.rpartition(TRACK_SEP)
        if sep and tr.isdigit():
            out.append((name, b, e, fl, int(tr)))
        else:
            out.append((wire, b, e, fl, 0))
    return out


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Device-side kernel tracing: ``torch.profiler`` with CPU and (when
    there is a card) CUDA activities over the block; its Chrome trace
    goes to ``logdir/trace.json``. Yields the profiler."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
