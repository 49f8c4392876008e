"""devprof: per-device timeline ingestion and cross-rank attribution
(``dplasma_tpu/observability/devprof.py``; its ``jax`` capture backend
becomes a ``torch`` one).

The roofline, the schedule and the comm model predict; this module
reads back what the device did:

1. **capture** — :class:`DevprofCapture` wraps the driver's timed loop.
   Backend ``torch`` runs it under a ``torch.profiler.profile`` with CPU
   and CUDA activities, each timed run bounded by a
   ``record_function("devprof_run[i]")`` range, and ingests the CUDA
   kernel, memcpy and memset events with their device timestamps —
   **of the best run only**: the reference's capture wraps all timed
   runs while ``attribute`` gets one run's seconds, so a real timeline
   would read a coverage near ``nruns`` times the busy share. A device
   event belongs to the run whose host range holds the call that
   launched it (its correlation id), else the one that holds its own
   start; every timed run starts and ends with a synchronize, so its
   kernels run inside its range. Coverage then stays at 1 or below.
   Each edge of the capture holds :data:`CAPTURE_MARKERS` marker
   kernels and :data:`CAPTURE_PAD_S` of idle time: late in a long
   process the profiler loses a capture's first device records, a
   fixed count of them when the runs start soon after the profiler
   (chip_smoke phase 20 counts the markers each edge keeps). A
   sentinel op in its own range (``RUN_RANGE`` of run -1) ends the
   head pad; a capture that lost it lost the runs' head too, and its
   note says so.
   Backend ``synthetic`` reconstructs the per-rank timeline from the
   measured run seconds, the schedule
   (:func:`dplasma_tpu_torch.analysis.spmdcheck.expected_counts`) and
   the :func:`~dplasma_tpu_torch.parallel.cyclic.spmd_comm_model`
   pricing; every rank's categories sum to the timed run exactly, equal
   to the reference's. ``auto`` (MCA ``devprof.backend``) resolves to
   ``torch`` on a CUDA run with a 1×1 grid, ``synthetic`` on the CPU
   (as the reference on its CPU mesh) and ``synthetic`` on a P×Q > 1
   virtual mesh, whose ranks share the card's one device lane: one lane
   cannot give the per-rank lanes the reconciliation reads, and the
   entry's ``note`` says so. An explicit ``devprof.backend=torch`` on a
   grid captures the one lane.
2. **binning** — timeline ops land in ``compute`` / ``collective`` /
   ``ici`` / ``host`` by
   :func:`dplasma_tpu_torch.analysis.hlo_names.timeline_category`
   (the reference's HLO names and the CUDA device ops: K5's kernels are
   ``ici``, memcpy/memset ``host``, ``nccl*`` ``collective``).
3. **reconciliation** — measured seconds and achieved bytes/s per
   (kind, axis) class against the comm model's bytes and the roofline
   ``ici`` peak; a class the schedule expects that the timeline lacks
   is a ``missing-collective`` diagnostic, a count off it a
   ``count-mismatch``, an achieved fraction under MCA
   ``devprof.ici_floor`` an ``ici-floor`` diagnostic. On one card a K5
   launch names its class in a ``k5[ring_<kind>@<axis>]`` range
   (``hlo_names.K5_RANGE``; the caller gives the axis) and serves one
   ring: the virtual mesh's P process rows each run their own 'q'
   broadcast, its Q process columns their own 'p' exchange. A K5 op
   launched outside such a range is ``ring_<kind>@?``. A captured K5
   op carries ``rings``, the rings of its axis that share the lane, and
   counts (and times) as ``1/rings`` of a per-rank instance, so
   sgetrf_ptgpanel's 2·KT broadcast launches on 2×2 reconcile with
   the schedule's KT per rank. The schedule's psum and all_gather
   classes are ordinary torch ops on one card, with no device op of
   their own: a ``torch`` capture reports them ``missing-collective``
   (the multi-card step, ROADMAP queue 1 item 11 step 4, has NCCL lanes
   for them).
4. **straggler attribution** — per-rank busy-seconds skew
   ``(max-min)/max``, the slowest rank and its dominating category, the
   per-step spread across ranks, and a critical-path walk over the
   merged timeline.

Results land in the run-report's ``"devprof"`` section (schema v14,
:meth:`~dplasma_tpu_torch.observability.report.RunReport.add_devprof`);
the port's perfdiff core extracts ``<label>.devprof.ici_achieved_frac``
and ``<label>.devprof.skew`` from it. Wired as ``--devprof`` on every
driver.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import tempfile
import threading
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from dplasma_tpu_torch.analysis.hlo_names import (JAXPR_TO_HLO, RING_MARKER,
                                                  k5_kind, k5_range_class,
                                                  timeline_category)
from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "devprof.backend", "auto",
    "Timeline capture backend for --devprof: torch = wrap the timed "
    "loop in a torch.profiler capture and ingest the best run's CUDA "
    "kernel, memcpy and memset events; synthetic = reconstruct the "
    "per-rank timeline from the measured run + the spmdcheck schedule "
    "+ the spmd_comm_model pricing (the CPU path); auto = torch on a "
    "CUDA run with a 1x1 grid, synthetic on the CPU and on a P x Q > 1 "
    "virtual mesh (one device lane for all its ranks).")
_cfg.mca_register(
    "devprof.ici_floor", "0.05",
    "Minimum achieved-ICI fraction (measured bytes/s over the "
    "roofline ici peak) per collective class before devprof records "
    "an ici-floor diagnostic naming the op; 0 disables the check.")
_cfg.mca_register(
    "devprof.max_path", "32",
    "Maximum spans recorded for the critical-path extraction in the "
    "run-report (the walk itself is unbounded; only the reported "
    "span list truncates, keeping the longest spans).")

#: the category model every timeline op bins into
CATEGORIES = ("compute", "collective", "ici", "host")


def _ici_peak_bps(peaks: Optional[dict]) -> float:
    if not peaks:
        from dplasma_tpu_torch.observability.roofline import \
            DEFAULT_PEAKS
        peaks = DEFAULT_PEAKS
    try:
        return float(peaks.get("ici_gbps", 0.0)) * 1e9
    except (TypeError, ValueError):
        return 0.0


def timeline_op(name: str, rank: int, begin_ns: int, end_ns: int,
                cls: Optional[str] = None,
                step: Optional[int] = None) -> dict:
    """One timeline op: a span on one rank's device lane. ``cls`` is
    the collective class key (``kind@axis``, spmdcheck's spelling)
    when known; the category bin always derives from the op *name*
    (:mod:`~dplasma_tpu_torch.analysis.hlo_names`), never from the
    class. A captured K5 op adds ``rings`` (module docstring)."""
    return {"name": str(name), "rank": int(rank),
            "begin_ns": int(begin_ns), "end_ns": int(end_ns),
            "category": timeline_category(name),
            "cls": cls, "step": step}


class DevprofCollector:
    """Thread-safe timeline accumulator: capture backends append from
    whatever thread produced the event (the profiler callback thread,
    the driver loop, a test harness); ingestion snapshots once. All
    mutable state is guarded by ``_lock``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ops: List[dict] = []

    def add(self, name: str, rank: int, begin_ns: int, end_ns: int,
            cls: Optional[str] = None,
            step: Optional[int] = None) -> None:
        op = timeline_op(name, rank, begin_ns, end_ns, cls=cls,
                         step=step)
        with self._lock:
            self._ops.append(op)

    def extend(self, ops) -> None:
        ops = [dict(o) for o in ops]
        with self._lock:
            self._ops.extend(ops)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ops)

    def clear(self) -> None:
        with self._lock:
            self._ops = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._ops)


# ---------------------------------------------------------------------
# Capture backends
# ---------------------------------------------------------------------

#: the record_function range that bounds timed run i in a capture
RUN_RANGE = "devprof_run[{}]"

#: marker kernels and idle seconds at each edge of a capture
#: (:meth:`DevprofCapture._pad`)
CAPTURE_MARKERS = 256
CAPTURE_PAD_S = 0.5

#: the run index whose ``RUN_RANGE`` holds the head pad's sentinel op
HEAD_RUN = -1

#: Chrome-trace categories of the device ops a capture ingests
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: Chrome-trace categories of the host calls that launch them
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _run_index(name: str) -> Optional[int]:
    head, tail = RUN_RANGE.split("{}")
    if name.startswith(head) and name.endswith(tail):
        try:
            return int(name[len(head):len(name) - len(tail)])
        except ValueError:
            return None
    return None


def torch_timeline(trace_events, run: Optional[int],
                   grid: Tuple[int, int] = (1, 1)) -> List[dict]:
    """The timeline ops of timed run ``run`` from a ``torch.profiler``
    Chrome trace's ``traceEvents``: every CUDA kernel, memcpy and
    memset event whose launch (matched by correlation id) or, without
    one, whose own start lies in the run's ``RUN_RANGE`` host range
    (``run=None``: every device op of the capture).
    All ops are rank 0's: the one card is one device lane. A K5 kernel
    gets the schedule class of the ``K5_RANGE`` range that holds its
    launch (``ring_<kind>@?`` outside one) and ``rings``, the rings of
    its axis that share the lane on a P×Q mesh (P 'q' broadcasts, Q 'p'
    exchanges)."""
    P, Q = max(int(grid[0]), 1), max(int(grid[1]), 1)
    windows: Dict[int, Tuple[float, float]] = {}
    k5_ranges: List[Tuple[float, float, str]] = []
    launch_ts: Dict[int, float] = {}
    device = []
    for e in trace_events or ():
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) \
                or not isinstance(dur, (int, float)):
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", "?"))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(ts)
        elif cat == "user_annotation":
            i = _run_index(name)
            if i is not None:
                windows[i] = (float(ts), float(ts) + float(dur))
            cls = k5_range_class(name)
            if cls is not None:
                k5_ranges.append((float(ts), float(ts) + float(dur), cls))
    lo, hi = windows.get(run, (None, None)) if run is not None \
        else (-math.inf, math.inf)
    if lo is None:
        return []
    k5_ranges.sort()
    k5_starts = [r[0] for r in k5_ranges]
    ops = []
    for e in device:
        ts = float(e["ts"])
        at = launch_ts.get((e.get("args") or {}).get("correlation"), ts)
        if not lo <= at <= hi:
            continue
        name = str(e.get("name", "?"))
        kind, cls = k5_kind(name), None
        if kind is not None:
            j = bisect.bisect_right(k5_starts, at) - 1
            cls = k5_ranges[j][2] if j >= 0 and at <= k5_ranges[j][1] \
                and k5_ranges[j][2].startswith(kind + "@") \
                else f"{kind}@?"
        op = timeline_op(name, 0, round(ts * 1e3),
                         round((ts + float(e["dur"])) * 1e3), cls=cls)
        if cls is not None:
            axis = cls.rsplit("@", 1)[1]
            op["rings"] = P if axis == "q" else Q if axis == "p" else 1
        ops.append(op)
    ops.sort(key=lambda o: (o["begin_ns"], o["end_ns"]))
    return ops


def device_ops(timeline: List[dict]) -> List[dict]:
    """Per op name: category, count and device seconds, the most
    seconds first (the ``"device_ops"`` table of a captured entry)."""
    by: Dict[str, dict] = {}
    for op in timeline:
        row = by.setdefault(op["name"], {
            "name": op["name"], "category": op.get("category")
            or timeline_category(op["name"]), "count": 0, "seconds": 0.0})
        row["count"] += 1
        row["seconds"] += (op["end_ns"] - op["begin_ns"]) / 1e9
    return sorted(by.values(), key=lambda r: (-r["seconds"], r["name"]))


class DevprofCapture:
    """Context manager around the timed loop: runs it under a
    ``torch.profiler`` capture when the resolved backend is ``torch``,
    otherwise a no-op whose caller synthesizes the timeline afterwards.
    Each timed run goes inside :meth:`run`; after the loop,
    :meth:`select` keeps the best run's device ops in ``self.events``
    (empty on the synthetic path or an event-less capture).
    ``self.used`` names the backend that produced them, ``self.note``
    why it is not the one asked for."""

    def __init__(self, backend: Optional[str] = None, device=None,
                 grid: Tuple[int, int] = (1, 1)):
        want = (backend or _cfg.mca_get("devprof.backend")
                or "auto").strip().lower()
        self.backend = want
        self.device = device
        self.grid = (max(int(grid[0]), 1), max(int(grid[1]), 1))
        self.events: List[dict] = []
        self.used = "synthetic"
        self.note = ""
        self.resolved = None
        self._prof = None
        self._trace: List[dict] = []

    def _cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def _resolve(self) -> str:
        if self.backend not in ("auto", "torch", "synthetic"):
            self.note = (f"unknown devprof.backend {self.backend!r} (auto, "
                         f"torch or synthetic); synthetic timeline used")
            return "synthetic"
        if self.backend != "auto":
            return self.backend
        if not self._cuda():
            return "synthetic"
        P, Q = self.grid
        if P * Q > 1:
            self.note = (
                f"auto: the {P}x{Q} virtual mesh runs its {P * Q} ranks "
                f"on the card's one device lane, which cannot give the "
                f"per-rank lanes the reconciliation reads; synthetic "
                f"timeline used (devprof.backend=torch captures the one "
                f"lane)")
            return "synthetic"
        return "torch"

    def __enter__(self) -> "DevprofCapture":
        self.resolved = self._resolve()
        if self.resolved != "torch":
            return self
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._pad(head=True)
        except Exception as exc:  # noqa: BLE001 — capture is
            # observability; a profiler that cannot start must not
            # kill the timed run it watches
            self._prof = None
            self.note = f"torch profiler unavailable: {exc!r}"
        return self

    def run(self, i: int):
        """The context of timed run ``i``: its ``RUN_RANGE`` range when
        capturing, else nothing."""
        if self._prof is None:
            import contextlib
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(RUN_RANGE.format(i))

    def _pad(self, head: bool = False) -> None:
        """:data:`CAPTURE_MARKERS` marker kernels and
        :data:`CAPTURE_PAD_S` of idle time between an edge of the
        capture and the runs, where the profiler loses records (module
        docstring); the head pad ends with its sentinel op in run
        :data:`HEAD_RUN`'s range."""
        if self._cuda():
            import torch
            x = torch.zeros(1, device=self.device)
            for _ in range(CAPTURE_MARKERS):
                x.add_(1.0)
            torch.cuda.synchronize(self.device)
            time.sleep(CAPTURE_PAD_S)
            if head:
                with self.run(HEAD_RUN):
                    x.add_(1.0)
                    torch.cuda.synchronize(self.device)

    def __exit__(self, *exc_info) -> bool:
        if self._prof is None:
            return False
        prof, self._prof = self._prof, None
        try:
            self._pad()
            prof.__exit__(None, None, None)
            with tempfile.TemporaryDirectory(prefix="devprof_") as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    self._trace = (json.load(f) or {}).get(
                        "traceEvents") or []
        except Exception as exc:  # noqa: BLE001 — same contract
            self.note = f"torch profiler stop failed: {exc!r}"
            self._trace = []
        return False

    def captured(self) -> List[dict]:
        """Every device op of the capture: all timed runs and the
        marker kernels at its edges."""
        return torch_timeline(self._trace, None, self.grid)

    def select(self, run: int) -> List[dict]:
        """Keep timed run ``run``'s device ops (the best run's, which
        ``attribute`` is handed the seconds of)."""
        self.events = torch_timeline(self._trace, run, self.grid)
        if self.events:
            self.used = "torch"
            if not torch_timeline(self._trace, HEAD_RUN) and not self.note:
                self.note = ("torch capture lost its head sentinel: the "
                             "profiler dropped the first device records "
                             "past the head pad, so a run may lack ops")
        elif self.resolved == "torch" and not self.note:
            self.note = (f"torch capture recorded no device event in "
                         f"run {run}; synthetic timeline used")
        return self.events


# ---------------------------------------------------------------------
# Synthetic timeline (the CPU and virtual-mesh backend)
# ---------------------------------------------------------------------

def _class_of_model_key(key: str) -> str:
    """``spmd_comm_model`` byte key -> spmdcheck class key, the parse
    rule :func:`dplasma_tpu_torch.analysis.spmdcheck.model_classes`
    uses too (``panel_bcast_psum_q`` -> ``psum@q``,
    ``pivot_row_ring_shift_p`` -> ``ring_shift@p``)."""
    base, _, axis = key.rpartition("_")
    kind = base.rsplit("_", 1)[-1]
    kind = {"allgather": "all_gather", "bcast": "ring_bcast",
            "shift": "ring_shift"}.get(kind, kind)
    return f"{kind}@{axis}"


def model_bytes_by_class(model: Optional[dict]) -> Dict[str, float]:
    """Collapse a ``spmd_comm_model`` result's per-collective bytes
    onto spmdcheck class keys (several model keys may share one class:
    potrf's panel and diagonal broadcasts are both ``psum`` classes on
    different axes)."""
    out: Dict[str, float] = {}
    for key, val in ((model or {}).get("bytes_by_collective")
                     or {}).items():
        cls = _class_of_model_key(key)
        out[cls] = out.get(cls, 0.0) + float(val)
    return out


def _span_name(cls: str, seq: int) -> str:
    """An HLO-shaped op name for one synthetic collective instance —
    the names must round-trip through the shared op-name vocabulary
    (``psum@q`` -> ``all-reduce.7``; ring classes -> the
    ``dplasma_ring_`` custom-call marker)."""
    kind = cls.split("@", 1)[0]
    hlo = JAXPR_TO_HLO.get(kind, kind)
    if hlo == "ring-dma":
        leg = kind[5:] if kind.startswith("ring_") else kind
        return f"custom-call.{seq} {RING_MARKER}{leg}"
    return f"{hlo}.{seq}"


def synthesize_timeline(run_s: float, nranks: int,
                        counts: Optional[Dict[str, int]] = None,
                        bytes_by_class: Optional[Dict[str, float]] = None,
                        peaks: Optional[dict] = None,
                        base_ns: int = 0) -> List[dict]:
    """Reconstruct a per-rank device timeline from one timed run.

    Each rank's lane covers exactly ``[base_ns, base_ns + run_s)``:
    every expected collective instance (``counts``, spmdcheck class
    keys) becomes one span whose duration is its class's per-rank
    modeled wire bytes (``bytes_by_class``, TOTAL bytes across ranks)
    over the roofline ICI peak, instances interleaved round-robin
    across classes in the panel-step order the kernels emit; the
    remaining time fills with compute spans (``fusion.N``) between
    them. Category seconds therefore sum to ``run_s`` per rank by
    construction — the property the devprof smoke gate asserts. With
    no expected collectives the lane is one compute span."""
    R = max(int(nranks), 1)
    run_ns = max(float(run_s), 0.0) * 1e9
    counts = {k: int(v) for k, v in (counts or {}).items() if v > 0}
    bb = bytes_by_class or {}
    bps = _ici_peak_bps(peaks)
    cls_s: Dict[str, float] = {}
    for cls in sorted(counts):
        per_rank_bytes = float(bb.get(cls, 0.0)) / R
        cls_s[cls] = per_rank_bytes / bps if bps > 0 else 0.0
    total_coll = sum(cls_s.values())
    if total_coll > 0.0 and run_s > 0 and total_coll > 0.9 * run_s:
        # the model pricing exceeding the measured run means the
        # run beat the ICI peak assumption — clamp the synthetic
        # collective share so the lane still fits the measurement
        scale = 0.9 * run_s / total_coll
        cls_s = {k: v * scale for k, v in cls_s.items()}
        total_coll = sum(cls_s.values())
    # round-robin instance order across classes (panel-step shaped)
    order: List[str] = []
    if counts:
        for step in range(max(counts.values())):
            for cls in sorted(counts):
                if step < counts[cls]:
                    order.append(cls)
    n_inst = len(order)
    comp_ns = ((run_ns - total_coll * 1e9) / (n_inst + 1)
               if run_ns > 0 else 0.0)
    ops: List[dict] = []
    for r in range(R):
        cursor = float(base_ns)
        seq = 0
        for step, cls in enumerate(order):
            end = cursor + comp_ns
            ops.append(timeline_op(f"fusion.{seq}", r,
                                   round(cursor), round(end),
                                   step=step))
            cursor, seq = end, seq + 1
            dur_ns = cls_s[cls] / counts[cls] * 1e9
            end = cursor + dur_ns
            ops.append(timeline_op(_span_name(cls, seq), r,
                                   round(cursor), round(end),
                                   cls=cls, step=step))
            cursor, seq = end, seq + 1
        ops.append(timeline_op(f"fusion.{seq}", r, round(cursor),
                               round(base_ns + run_ns),
                               step=n_inst))
    return ops


def stretch_rank(timeline: List[dict], rank: int, factor: float,
                 categories: Tuple[str, ...] = ("collective", "ici")
                 ) -> List[dict]:
    """Stretch one rank's spans of the given categories by ``factor``,
    shifting its later spans so the lane stays contiguous — the
    straggler-injection helper the skew tests (and docs examples)
    share. Other ranks pass through untouched."""
    out: List[dict] = []
    shift = 0.0
    for op in sorted(timeline,
                     key=lambda o: (o["rank"], o["begin_ns"])):
        op = dict(op)
        if op["rank"] == rank:
            dur = op["end_ns"] - op["begin_ns"]
            op["begin_ns"] = round(op["begin_ns"] + shift)
            if op.get("category") in categories:
                grow = dur * (factor - 1.0)
                shift += grow
                dur += grow
            op["end_ns"] = round(op["begin_ns"] + dur)
        out.append(op)
    return out


# ---------------------------------------------------------------------
# Ingestion + attribution
# ---------------------------------------------------------------------

def _derive_cls(name: str) -> str:
    """Class key for a captured collective span that carries none: the
    K5 kernel's kind or the opcode, with a wildcard axis."""
    low = str(name).lower()
    kind = k5_kind(low)
    if kind is not None:
        return f"{kind}@?"
    if RING_MARKER in low:
        return ("ring_shift@?" if "shift" in low else "ring_bcast@?")
    opcode = low.split(" ", 1)[0].split(".", 1)[0].lstrip("%")
    return f"{opcode}@?"


def _rings(span: dict) -> int:
    """The rings that share a span's lane: the span is 1/rings of one
    rank's instance (module docstring; 1 but for a captured K5 op)."""
    return max(int(span.get("rings") or 1), 1)


def _critical_path(spans: List[dict], run_s: float,
                   max_path: int) -> dict:
    """Greedy longest back-chain over the merged timeline: start at
    the latest-ending span, repeatedly hop (across ranks) to the
    latest-ending span that finishes by the current span's begin.

    A hop goes only to a span before the current one in end order. The
    reference hops to the latest such span among all, which for a
    zero-width span (a class priced at 0 bytes: the size-1 axis of a
    1×Q or P×1 grid) is the span itself, and never ends; on spans of
    positive width the two walks are the same."""
    if not spans:
        return {"length_s": 0.0, "frac": 0.0, "spans": [],
                "truncated": False}
    import bisect
    ordered = sorted(spans, key=lambda s: s["end_ns"])
    ends = [s["end_ns"] for s in ordered]
    pos = len(ordered) - 1
    cur = ordered[pos]
    chain = [cur]
    while True:
        pos = min(bisect.bisect_right(ends, cur["begin_ns"]), pos)
        if pos == 0:
            break
        pos -= 1
        cur = ordered[pos]
        chain.append(cur)
    chain.reverse()
    length_s = sum((s["end_ns"] - s["begin_ns"]) for s in chain) / 1e9
    rows = [{"name": s["name"], "rank": s["rank"],
             "category": s.get("category")
             or timeline_category(s["name"]),
             "dur_s": (s["end_ns"] - s["begin_ns"]) / 1e9}
            for s in chain]
    truncated = len(rows) > max_path
    if truncated:
        keep = sorted(sorted(range(len(rows)),
                             key=lambda i: -rows[i]["dur_s"])
                      [:max_path])
        rows = [rows[i] for i in keep]
    return {"length_s": length_s,
            "frac": (length_s / run_s if run_s > 0 else 0.0),
            "spans": rows, "truncated": truncated}


def ingest(timeline: List[dict], run_s: float, nranks: int,
           peaks: Optional[dict] = None,
           expected: Optional[Dict[str, int]] = None,
           bytes_by_class: Optional[Dict[str, float]] = None,
           op: str = "", label: str = "",
           backend: str = "synthetic",
           floor: Optional[float] = None,
           max_path: Optional[int] = None) -> dict:
    """Ingest one captured/synthesized timeline into the run-report
    ``"devprof"`` entry: category seconds, per-collective
    measured seconds + achieved bytes/s + achieved-ICI fraction,
    schedule reconciliation, skew/straggler attribution, and the
    critical path. ``expected`` is the spmdcheck schedule (class key
    -> per-rank count); ``bytes_by_class`` the comm model's TOTAL
    wire bytes per class."""
    if floor is None:
        floor = _cfg.mca_get_float("devprof.ici_floor", 0.05)
    if max_path is None:
        max_path = max(_cfg.mca_get_int("devprof.max_path", 32), 1)
    run_s = float(run_s)
    by_rank: Dict[int, List[dict]] = {}
    for span in timeline:
        by_rank.setdefault(int(span["rank"]), []).append(span)
    R = max(int(nranks) or len(by_rank), 1)
    ranks = sorted(by_rank) or [0]
    n_lanes = max(len(ranks), 1)
    diagnostics: List[dict] = []

    # -- category seconds (mean across rank lanes) --------------------
    rank_cat = {r: dict.fromkeys(CATEGORIES, 0.0) for r in ranks}
    for r in ranks:
        for s in by_rank.get(r, ()):
            cat = s.get("category") or timeline_category(s["name"])
            if cat not in rank_cat[r]:
                cat = "compute"
            rank_cat[r][cat] += (s["end_ns"] - s["begin_ns"]) / 1e9
    categories = {c: sum(rank_cat[r][c] for r in ranks) / n_lanes
                  for c in CATEGORIES}
    busy = sum(categories.values())
    coverage = busy / run_s if run_s > 0 else 0.0

    # -- per-collective reconciliation --------------------------------
    cls_spans: Dict[str, List[dict]] = {}
    for span in timeline:
        cat = span.get("category") or timeline_category(span["name"])
        if cat not in ("collective", "ici"):
            continue
        cls = span.get("cls") or _derive_cls(span["name"])
        cls_spans.setdefault(cls, []).append(span)
    ici_bps = _ici_peak_bps(peaks)
    bb = bytes_by_class or {}
    collectives: List[dict] = []
    ingested: Dict[str, int] = {}
    for cls in sorted(cls_spans):
        spans = cls_spans[cls]
        per_rank_n: Dict[int, Fraction] = {}
        for s in spans:
            per_rank_n[s["rank"]] = per_rank_n.get(s["rank"], 0) \
                + Fraction(1, _rings(s))
        count = max(per_rank_n.values())
        count = int(count) if count.denominator == 1 else float(count)
        ingested[cls] = count
        measured_s = sum((s["end_ns"] - s["begin_ns"]) / _rings(s)
                         for s in spans) / 1e9 / n_lanes
        kind = cls.split("@", 1)[0]
        row = {"cls": cls, "hlo": JAXPR_TO_HLO.get(kind, kind),
               "count": count,
               "measured_s": measured_s,
               "model_bytes": None, "achieved_bytes_per_s": None,
               "achieved_frac": None}
        if cls in bb:
            per_rank_bytes = float(bb[cls]) / R
            row["model_bytes"] = float(bb[cls])
            if measured_s > 0:
                achieved = per_rank_bytes / measured_s
                row["achieved_bytes_per_s"] = achieved
                if ici_bps > 0:
                    frac = achieved / ici_bps
                    row["achieved_frac"] = frac
                    if 0.0 < floor and frac < floor:
                        diagnostics.append({
                            "kind": "ici-floor", "op": cls,
                            "message":
                                f"{label or op}: collective {cls} "
                                f"achieved {achieved:.4g} B/s = "
                                f"{frac:.4f} of the ICI peak "
                                f"({ici_bps:.4g} B/s), under the "
                                f"devprof.ici_floor {floor:g}"})
        collectives.append(row)

    if expected is None:
        relation = "unmodelled" if ingested else "no-collectives"
    else:
        bad = False
        for cls in sorted(expected):
            want = int(expected[cls])
            got = ingested.get(cls, 0)
            if got == 0:
                bad = True
                diagnostics.append({
                    "kind": "missing-collective", "op": cls,
                    "message":
                        f"{label or op}: collective {cls} expected "
                        f"{want} instance(s) by the spmdcheck "
                        f"schedule, ingested 0 — the timeline lost "
                        f"a priced collective"})
            elif got != want:
                bad = True
                diagnostics.append({
                    "kind": "count-mismatch", "op": cls,
                    "message":
                        f"{label or op}: collective {cls} expected "
                        f"{want} instance(s), ingested {got}"})
        for cls in sorted(set(ingested) - set(expected)):
            diagnostics.append({
                "kind": "unmodelled-collective", "op": cls,
                "message":
                    f"{label or op}: ingested collective {cls} "
                    f"({ingested[cls]} instance(s)) is absent from "
                    f"the spmdcheck schedule (informational)"})
        relation = "==" if not bad else "mismatch"

    # -- skew / straggler attribution ---------------------------------
    rank_busy = {r: sum(rank_cat[r].values()) for r in ranks}
    slowest = max(ranks, key=lambda r: (rank_busy[r], r))
    b_max = rank_busy[slowest]
    b_min = min(rank_busy.values())
    skew_v = (b_max - b_min) / b_max if b_max > 0 else 0.0
    others = [r for r in ranks if r != slowest]
    dom, dom_excess = None, 0.0
    for c in CATEGORIES:
        mean_other = (sum(rank_cat[r][c] for r in others)
                      / len(others)) if others else 0.0
        excess = rank_cat[slowest][c] - mean_other
        if dom is None or excess > dom_excess:
            dom, dom_excess = c, excess
    if dom_excess <= 0:
        dom = max(CATEGORIES, key=lambda c: rank_cat[slowest][c])
    step_rank: Dict[int, Dict[int, float]] = {}
    for span in timeline:
        st = span.get("step")
        if st is None:
            continue
        d = step_rank.setdefault(int(st), {})
        r = int(span["rank"])
        d[r] = d.get(r, 0.0) + (span["end_ns"] - span["begin_ns"]) / 1e9
    spreads = [max(d.values()) - min(d.values())
               for d in step_rank.values() if len(d) > 1]
    skew = {"value": skew_v, "slowest_rank": int(slowest),
            "dominating_category": dom,
            "per_rank_s": [rank_busy[r] for r in ranks],
            "ranks": [int(r) for r in ranks],
            "max_step_spread_s": max(spreads) if spreads else 0.0}

    critical = _critical_path(timeline, run_s, max_path)
    ok = not any(d["kind"] in ("missing-collective", "count-mismatch")
                 for d in diagnostics)
    return {"label": label, "op": op, "backend": backend,
            "nranks": R, "run_s": run_s,
            "categories": categories, "coverage": coverage,
            "timeline_ops": len(timeline),
            "collectives": collectives,
            "reconciliation": {"relation": relation,
                               "expected": expected,
                               "ingested": ingested},
            "skew": skew, "critical_path": critical,
            "diagnostics": diagnostics, "ok": ok}


# ---------------------------------------------------------------------
# The one-call front door (the drivers)
# ---------------------------------------------------------------------

def attribute(label: str, op_class: Optional[str], run_s: float,
              grid: Tuple[int, int], M: int, N: int, nb: int,
              itemsize: int = 8, kt: Optional[int] = None,
              ring: bool = False, lookahead: int = 0,
              peaks: Optional[dict] = None,
              timeline: Optional[List[dict]] = None,
              backend: str = "synthetic") -> dict:
    """Model-assemble and ingest one op's attribution: the spmdcheck
    expected schedule + the spmd_comm_model pricing for
    ``(op_class, grid, M, N, nb)``, a synthetic timeline when the
    capture produced none, and the full :func:`ingest` pass. A 1x1
    grid (or an unmodelled op) attributes honestly as all-compute
    with no reconciliation rather than guessing."""
    P, Q = max(int(grid[0]), 1), max(int(grid[1]), 1)
    R = P * Q
    expected = None
    bytes_by_class = None
    if op_class and R > 1:
        from dplasma_tpu_torch.analysis import spmdcheck
        KT = kt if kt is not None else max(
            min(-(-int(M) // int(nb)), -(-int(N) // int(nb))), 1)
        expected = spmdcheck.expected_counts(
            op_class, KT, lookahead, ring=ring, grid=(P, Q))
        try:
            from dplasma_tpu_torch.descriptors import Dist
            from dplasma_tpu_torch.parallel.cyclic import (
                CyclicDesc, spmd_comm_model)
            model = spmd_comm_model(
                CyclicDesc(int(M), int(N), int(nb), int(nb),
                           Dist(P=P, Q=Q)),
                op_class, int(itemsize), kt=kt, ring=ring)
            bytes_by_class = model_bytes_by_class(model)
        except KeyError:
            bytes_by_class = None
    if peaks is None:
        from dplasma_tpu_torch.observability.roofline import \
            DEFAULT_PEAKS
        peaks = DEFAULT_PEAKS
    if timeline is None:
        timeline = synthesize_timeline(run_s, R, counts=expected,
                                       bytes_by_class=bytes_by_class,
                                       peaks=peaks)
        backend = "synthetic"
    return ingest(timeline, run_s, R, peaks=peaks, expected=expected,
                  bytes_by_class=bytes_by_class, op=op_class or "",
                  label=label, backend=backend)
