"""Per-request tracing: the always-on span layer
(``dplasma_tpu/observability/tracing.py``, plain Python, line for line).

:mod:`dplasma_tpu_torch.observability.phases` attributes ONE pass after
the fact (fence at exit, one thread, ``--phase-profile``); a serving
process needs the opposite trade: spans cheap enough to leave on for
every request, safe under a caller + timer thread mix, and exportable
while the process runs. :class:`Tracer` is that layer:

* **thread-safe and always-on** — the hot path takes no lock: every
  thread owns its span stack and open/close counters (created once
  under the lock), span ids are allocated per thread, and commits ride
  the GIL-atomic append of a bounded deque (MCA
  ``telemetry.max_spans``). The lock guards only thread-state
  creation, the summary/clear paths and explicit ``add()``;
* **span trees** — ``with tracer.span("dispatch", ...)`` parents any
  span opened inside it on the same thread (ids are process-unique:
  the thread lane is folded into the id's high bits);
  :meth:`Tracer.add` records an externally-timed span (a request's
  queue wait, measured at dispatch);
* **request attribution** — spans carry ``request`` (one id) or
  ``requests`` (a batch's ids) so one request can be followed through
  queue, batch, dispatch, gate and ladder;
* **balanced by construction** — every open is closed by the context
  manager even when the body raises; :meth:`balanced` checks it;
* **exportable** — :meth:`to_chrome` emits Chrome trace-event JSON
  through :func:`dplasma_tpu_torch.observability.chrome.spans_to_chrome`,
  :meth:`save` writes the span document the reference's
  ``tools/tracecat.py --merge`` reads.

Timestamps are wall-clock ``time.time_ns()`` (the base of
:class:`dplasma_tpu_torch.utils.profiling.Profile`), so spans and
driver profiles merge onto one axis. Disabled (``enabled=False``) a
span is one attribute check and a no-op context. Nothing here touches
CUDA: any thread may record.
"""
from __future__ import annotations

import collections
import json
import threading
import time
import weakref
from typing import List, Optional

from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "telemetry.max_spans", "8192",
    "Ring-buffer bound on finished tracing spans kept in memory "
    "(oldest dropped past this; the drop count is reported in the "
    "telemetry summary).")

#: schema tag of the serialized span document (tracecat --merge input)
SPANS_SCHEMA = 1

#: span-id layout: the thread lane in the high bits keeps per-thread
#: id allocation collision-free without any shared counter
_SID_SHIFT = 40


class _NoopSpan:
    """Disabled-tracer span: yields the attrs dict (callers may still
    read what they wrote into it) and records nothing. Class-based —
    a generator context manager costs ~1.5 µs per use, too much for a
    per-request always-on path."""

    __slots__ = ("attrs",)

    def __init__(self, attrs):
        self.attrs = attrs

    def __enter__(self):
        return self.attrs

    def __exit__(self, *exc):
        return False


class _LiveSpan:
    """One open span (class-based for the same per-use cost reason).
    Commits its record on exit even when the body raised — the
    open/close ledger stays balanced by construction."""

    __slots__ = ("tr", "name", "request", "attrs", "st", "sid",
                 "parent", "t0")

    def __init__(self, tr, name, request, attrs):
        self.tr = tr
        self.name = name
        self.request = request
        self.attrs = attrs

    def __enter__(self):
        st = self.tr._thread_state()
        self.st = st
        st["opened"] += 1
        self.sid = (st["track"] << _SID_SHIFT) + st["opened"]
        stack = st["stack"]
        self.parent = stack[-1] if stack else -1
        stack.append(self.sid)
        self.t0 = time.time_ns()
        return self.attrs

    def __exit__(self, *exc):
        t1 = time.time_ns()
        st = self.st
        st["stack"].pop()
        st["closed"] += 1
        # commit as a flat tuple (a dict build costs ~1 µs — spans()
        # rehydrates dicts only at export time); GIL-atomic append
        self.tr._spans.append(
            (self.sid, self.parent, self.name, self.t0, t1,
             self.request, self.attrs or None, st["track"]))
        return False


class Tracer:
    """Bounded, thread-safe span recorder (module docstring)."""

    def __init__(self, enabled: bool = True, rank: int = 0,
                 capacity: Optional[int] = None):
        self.enabled = bool(enabled)
        self.rank = int(rank)
        cap = capacity if capacity is not None \
            else _cfg.mca_get_int("telemetry.max_spans", 8192)
        #: finished spans as flat tuples (sid, parent, name, t0_ns,
        #: t1_ns, request, attrs, track); spans() rehydrates dicts
        self._spans: "collections.deque[tuple]" = collections.deque(
            maxlen=max(int(cap), 1))
        self._lock = threading.Lock()
        self._local = threading.local()
        #: per-thread states, indexed by lane id. A lane whose owner
        #: thread died is recycled by the next new thread (bounds
        #: _states by the max CONCURRENT thread count, not the total
        #: ever seen); its opened counter carries on, so recycled
        #: lanes still allocate unique span ids
        self._states: List[dict] = []

    # ------------------------------------------------------- recording
    def _thread_state(self) -> dict:
        st = getattr(self._local, "st", None)
        if st is None:
            cur = threading.current_thread()
            with self._lock:
                # recycle a dead thread's lane first: the scheduler
                # spawns a fresh Timer thread per batch window, and
                # appending a permanent state per short-lived thread
                # would grow _states forever in a long-running
                # service. A dead owner's stack is empty (spans are
                # balanced per thread) and its opened/closed counters
                # keep accumulating, so the totals stay exact.
                st = None
                for cand in self._states:
                    owner = cand["thread"]()
                    if owner is None or not owner.is_alive():
                        st = cand
                        break
                if st is None:
                    st = {"stack": [], "opened": 0, "closed": 0,
                          "track": len(self._states)}
                    self._states.append(st)
                st["thread"] = weakref.ref(cur)
            self._local.st = st
        return st

    def span(self, name: str, request: Optional[int] = None, **attrs):
        """Record one span around the block; entering yields the attrs
        dict so the body can add fields discovered mid-span (cache
        hit/miss, batch size). Closed — and committed — even when the
        body raises, so the open/close ledger stays balanced. When
        disabled this is one attribute check and a no-op context."""
        if not self.enabled:
            return _NoopSpan(attrs)
        return _LiveSpan(self, name, request, attrs)

    def instant(self, name: str, request: Optional[int] = None,
                **attrs) -> None:
        """Record a zero-width marker span at "now" — point decisions
        (an admission shed, a deadline expiry) land on the request
        timeline without an enclosing context manager. Rides
        :meth:`add`, so the open/close ledger stays balanced."""
        t = time.time_ns()
        self.add(name, t, t, request=request, **attrs)

    def add(self, name: str, t0_ns: int, t1_ns: int,
            request: Optional[int] = None, track: Optional[int] = None,
            **attrs) -> None:
        """Record an externally-timed span (e.g. queue-wait, whose
        start predates the dispatch thread observing it)."""
        if not self.enabled:
            return
        st = self._thread_state()
        st["opened"] += 1
        sid = (st["track"] << _SID_SHIFT) + st["opened"]
        st["closed"] += 1
        self._spans.append(
            (sid, -1, name, int(t0_ns), int(t1_ns),
             None if request is None else int(request),
             attrs or None,
             st["track"] if track is None else int(track)))

    # ------------------------------------------------------ inspection
    def spans(self) -> List[dict]:
        """Finished spans as dicts (rehydrated from the tuple ring)."""
        out = []
        for sid, parent, name, t0, t1, request, attrs, track \
                in list(self._spans):
            rec = {"sid": sid, "parent": parent, "name": name,
                   "t0_ns": t0, "t1_ns": t1, "rank": self.rank,
                   "track": track}
            if request is not None:
                rec["request"] = request
            if attrs:
                rec["attrs"] = dict(attrs)
            out.append(rec)
        return out

    def _totals(self):
        with self._lock:
            opened = sum(st["opened"] for st in self._states)
            closed = sum(st["closed"] for st in self._states)
        return opened, closed

    def balanced(self) -> bool:
        """Every opened span was closed (no span left the context
        manager unfinished anywhere in the process). Exact when the
        tracer is quiescent."""
        opened, closed = self._totals()
        return opened == closed

    def clear(self) -> None:
        """Drop recorded spans and zero the open/close ledgers
        (benches reset after warmup; call while quiescent)."""
        with self._lock:
            self._spans.clear()
            for st in self._states:
                st["opened"] = st["closed"] = 0

    def summary(self) -> dict:
        """The span half of the run-report's ``"telemetry"`` section
        (schema v13)."""
        opened, closed = self._totals()
        kept = len(self._spans)
        return {"enabled": self.enabled, "opened": opened,
                "closed": closed, "recorded": kept,
                "dropped": closed - kept,
                "balanced": opened == closed}

    # --------------------------------------------------------- export
    def to_doc(self) -> dict:
        """The serialized span document (the reference's
        ``tools/tracecat.py --merge`` reads it; also the ``save``
        payload)."""
        return {"dplasma_serving_spans": SPANS_SCHEMA,
                "rank": self.rank, "spans": self.spans()}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f)
            f.write("\n")
        return path

    def to_chrome(self, name: str = "serving") -> dict:
        """Spans as a Chrome trace-event document (one (pid, tid) =
        (rank, thread-lane) grid; request ids in ``args``)."""
        from dplasma_tpu_torch.observability.chrome import \
            spans_to_chrome
        return spans_to_chrome(self.spans(), rank=self.rank, name=name)
