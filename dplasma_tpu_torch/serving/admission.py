"""Admission control, deadlines, and circuit breakers — the serving
layer's overload posture.

Ports ``dplasma_tpu/serving/admission.py`` line for line (host logic:
the same knobs, decisions, breaker states and summary). It bounds three
things a request stream can otherwise grow without limit:

* **admission decisions** — :meth:`AdmissionController.decide` runs
  inside the submit critical section (a handful of integer compares;
  the un-stressed path's cost is measured by
  ``dplasma_tpu_torch/tools/servebench.py`` as
  ``admission_overhead_frac``). Hard queue-depth / inflight caps (MCA
  ``serving.max_queue`` / ``serving.max_inflight``) shed with
  :class:`AdmissionError`; an EWMA-smoothed p99 latency tracker fed by
  the ``serving_latency_s`` telemetry histogram (MCA
  ``serving.slo_p99_ms``) *degrades* IR requests to the next-cheaper
  ``ir.precision`` rung (``int8 < bf16 < f32 < f32x2``) before
  shedding. Every decision lands in the flight recorder as an
  ``admit``/``shed``/``degrade`` event carrying the request id.
* **deadlines** — ``submit(deadline_s=...)`` (default MCA
  ``serving.default_deadline_s``; 0 = none) stamps an absolute expiry
  that batching, dispatch, and the remediation ladder all honor: an
  expired request fails fast with :class:`DeadlineExceeded`.
* **circuit breakers** — one breaker per ``(op, rung)``: ``closed``
  until MCA ``serving.breaker_failures`` *consecutive* rung failures,
  then ``open`` (the ladder skips the rung); after MCA
  ``serving.breaker_cooldown_s`` one ``half_open`` probe is admitted,
  and its outcome closes or re-opens the breaker. Transitions are
  flight-recorder events (``breaker_open`` / ``breaker_close`` /
  ``breaker_half_open``) and live gauges (``serving_breaker_open`` /
  ``serving_breaker_half_open``).
* **retry budget** — a process-global cap (MCA
  ``serving.retry_budget``; 0 = unlimited) on ladder *retry* rungs
  across all requests.

Thread contract: one :class:`threading.Lock` guards the EWMA tracker,
the breaker table, and the retry ledger. ``decide`` reads the EWMA
lock-free — a single float load is GIL-atomic, as a
``metrics.Counter.value`` read is.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "serving.admission", "on",
    "Admission control on SolverService.submit (queue/inflight caps, "
    "SLO shed/degrade): on or off. Off skips the decision entirely — "
    "the leg servebench measures admission_overhead_frac "
    "against.")
_cfg.mca_register(
    "serving.max_queue", "256",
    "Admission cap on queued (undispatched) serving requests; a "
    "submit past this depth is shed with AdmissionError. 0 = "
    "unbounded (the pre-admission behavior).")
_cfg.mca_register(
    "serving.max_inflight", "0",
    "Admission cap on concurrently dispatching batches; submits "
    "arriving past it are shed with AdmissionError. 0 = unbounded.")
_cfg.mca_register(
    "serving.slo_p99_ms", "0",
    "p99 latency SLO in milliseconds: when the EWMA-smoothed p99 "
    "(fed by the serving_latency_s histogram) exceeds it, IR requests "
    "are degraded to the next-cheaper ir.precision rung and "
    "non-degradable requests are shed. 0 = SLO tracking off.")
_cfg.mca_register(
    "serving.slo_alpha", "0.25",
    "EWMA smoothing factor of the p99 SLO tracker (weight of the "
    "newest histogram p99 sample; higher reacts faster).")
_cfg.mca_register(
    "serving.degrade", "on",
    "Under SLO pressure, degrade *_ir requests to the next-cheaper "
    "ir.precision rung instead of shedding them: on or off.")
_cfg.mca_register(
    "serving.default_deadline_s", "0",
    "Default per-request deadline in seconds applied when "
    "submit(deadline_s=) is not given; an expired request fails with "
    "DeadlineExceeded before dispatch or mid-ladder. 0 = no deadline.")
_cfg.mca_register(
    "serving.breaker_failures", "3",
    "Consecutive failures of one (op, rung) remediation rung that "
    "open its circuit breaker (the ladder then skips the rung until "
    "a half-open probe succeeds).")
_cfg.mca_register(
    "serving.breaker_cooldown_s", "5",
    "Seconds an open (op, rung) breaker waits before admitting one "
    "half-open probe of the rung.")
_cfg.mca_register(
    "serving.retry_budget", "0",
    "Process-global cap on remediation-ladder retry rungs across ALL "
    "serving requests (exhausted: the ladder skips straight to the "
    "fallback rungs). 0 = unlimited.")

#: admission decisions
ADMIT = "admit"
SHED = "shed"
DEGRADE = "degrade"

#: circuit-breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: the SLO tracker re-reads the histogram p99 every this-many
#: completed requests (percentile() sorts the exact sample set — fine
#: amortized, too hot per request)
_EWMA_SAMPLE_EVERY = 8


class AdmissionError(RuntimeError):
    """Request shed at admission (queue/inflight cap or SLO pressure).
    Carries the request id the flight-recorder ``shed`` event is
    keyed by, so a rejected caller and the audit trail reconcile."""

    def __init__(self, msg: str, request_id: Optional[int] = None,
                 reason: Optional[str] = None):
        super().__init__(msg)
        self.request_id = request_id
        self.reason = reason


class DeadlineExceeded(RuntimeError):
    """Request deadline expired before (or during) remediation — the
    future fails fast instead of paying for a result nobody awaits."""

    def __init__(self, msg: str, request_id: Optional[int] = None):
        super().__init__(msg)
        self.request_id = request_id


class ServingTimeout(TimeoutError):
    """``SolveFuture.result(timeout=)`` expired with the future still
    unresolved (e.g. its batch's dispatch thread died). Subclasses
    :class:`TimeoutError` so pre-existing callers keep working; names
    the request id so the hang is attributable."""

    def __init__(self, msg: str, request_id: Optional[int] = None):
        super().__init__(msg)
        self.request_id = request_id


def resolve_deadline(deadline_s: Optional[float],
                     now: Optional[float] = None) -> float:
    """The absolute ``time.perf_counter()`` expiry of one request: the
    explicit ``submit(deadline_s=)`` wins, else MCA
    ``serving.default_deadline_s``. Returns 0.0 for "no deadline"."""
    d = deadline_s if deadline_s is not None \
        else _cfg.mca_get_float("serving.default_deadline_s", 0.0)
    if d is None or d <= 0:
        return 0.0
    return (time.perf_counter() if now is None else now) + float(d)


def degraded_precision() -> Optional[str]:
    """The next-cheaper ``ir.precision`` rung below the ambient one
    (None at the ``int8`` floor — nothing left to give up)."""
    from dplasma_tpu_torch.ops.refine import PRECISIONS, ir_params
    prec, _, _ = ir_params()
    i = PRECISIONS.index(prec)
    return PRECISIONS[i - 1] if i > 0 else None


class AdmissionController:
    """Admission decisions, the SLO tracker, the per-(op, rung)
    circuit breakers, and the global retry budget for ONE service
    (module docstring). All knobs resolve from the MCA tier at
    construction; explicit arguments win (tests)."""

    def __init__(self, metrics, flight=None,
                 max_queue: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 retry_budget: Optional[int] = None):
        self.metrics = metrics
        #: optional FlightRecorder: decisions and breaker transitions
        #: become structured events an incident can replay
        self.flight = flight
        self.enabled = _cfg.mca_get("serving.admission", "on") != "off"
        self.max_queue = _cfg.mca_get_int("serving.max_queue", 256) \
            if max_queue is None else int(max_queue)
        self.max_inflight = \
            _cfg.mca_get_int("serving.max_inflight", 0) \
            if max_inflight is None else int(max_inflight)
        self.slo_p99_ms = \
            _cfg.mca_get_float("serving.slo_p99_ms", 0.0) \
            if slo_p99_ms is None else float(slo_p99_ms)
        self.slo_alpha = min(max(
            _cfg.mca_get_float("serving.slo_alpha", 0.25), 0.0), 1.0)
        self.degrade_enabled = \
            _cfg.mca_get("serving.degrade", "on") != "off"
        self.breaker_failures = max(
            _cfg.mca_get_int("serving.breaker_failures", 3)
            if breaker_failures is None else int(breaker_failures), 1)
        self.breaker_cooldown_s = \
            _cfg.mca_get_float("serving.breaker_cooldown_s", 5.0) \
            if breaker_cooldown_s is None else float(breaker_cooldown_s)
        self.retry_budget = \
            _cfg.mca_get_int("serving.retry_budget", 0) \
            if retry_budget is None else int(retry_budget)
        # one lock for the EWMA tracker, breaker table, retry ledger
        self._lock = threading.Lock()
        self._ewma_p99_ms: Optional[float] = None
        self._observed = 0
        self._retries_used = 0
        #: (op, rung) -> breaker state dict (see breaker_record)
        self._breakers: dict = {}
        # prime the decision counters: the conservation audit reads
        # them and zero must mean "zero", never "absent"
        for name in ("serving_admitted_total", "serving_shed_total",
                     "serving_degraded_total",
                     "serving_deadline_expired_total",
                     "serving_breaker_open_total",
                     "serving_resolved_total"):
            self.metrics.counter(name)

    # -------------------------------------------------------- decisions

    def decide(self, op: str, queued: int,
               inflight: int) -> Tuple[str, Optional[str]]:
        """One admission decision for a submit already holding the
        service lock: ``(ADMIT|SHED|DEGRADE, reason|None)``. O(1)
        compares on the hot path; the EWMA read is lock-free (single
        GIL-atomic float load)."""
        if not self.enabled:
            return ADMIT, None
        if self.max_queue > 0 and queued >= self.max_queue:
            self.metrics.counter("serving_shed_total").inc()
            return SHED, (f"queue depth {queued} >= serving.max_queue "
                          f"{self.max_queue}")
        if self.max_inflight > 0 and inflight >= self.max_inflight:
            self.metrics.counter("serving_shed_total").inc()
            return SHED, (f"inflight batches {inflight} >= "
                          f"serving.max_inflight {self.max_inflight}")
        if self.slo_p99_ms > 0:
            ewma = self._ewma_p99_ms    # lock-free single read
            if ewma is not None and ewma > self.slo_p99_ms:
                why = (f"ewma p99 {ewma:.2f}ms > serving.slo_p99_ms "
                       f"{self.slo_p99_ms:g}ms")
                if self.degrade_enabled and op.endswith("_ir") \
                        and degraded_precision() is not None:
                    # degraded requests ARE admitted (the conservation
                    # audit's submitted == admitted + shed)
                    self.metrics.counter(
                        "serving_admitted_total").inc()
                    self.metrics.counter(
                        "serving_degraded_total").inc()
                    return DEGRADE, why
                self.metrics.counter("serving_shed_total").inc()
                return SHED, why
        self.metrics.counter("serving_admitted_total").inc()
        return ADMIT, None

    def observe(self, latency_s: float, hist=None) -> None:
        """Feed the SLO tracker one completed-request latency. Every
        ``_EWMA_SAMPLE_EVERY``-th completion re-reads p99 from the
        ``serving_latency_s`` histogram (the telemetry feed) and folds
        it into the EWMA; between samples the raw latency is ignored
        (the histogram already recorded it)."""
        if self.slo_p99_ms <= 0:
            return
        with self._lock:
            self._observed += 1
            if self._ewma_p99_ms is not None \
                    and self._observed % _EWMA_SAMPLE_EVERY != 1:
                return
            p99 = hist.percentile(99.0) if hist is not None else None
            ms = (latency_s if p99 is None else p99) * 1000.0
            a = self.slo_alpha
            self._ewma_p99_ms = ms if self._ewma_p99_ms is None \
                else a * ms + (1.0 - a) * self._ewma_p99_ms

    def ewma_p99_ms(self) -> Optional[float]:
        return self._ewma_p99_ms

    # ----------------------------------------------------- retry budget

    def take_retry(self) -> bool:
        """Consume one unit of the process-global ladder retry budget;
        False when exhausted (the ladder skips the retry rung and
        falls through to the fallback rungs)."""
        if self.retry_budget <= 0:
            return True
        with self._lock:
            if self._retries_used >= self.retry_budget:
                return False
            self._retries_used += 1
            return True

    # -------------------------------------------------- circuit breaker

    def _flight(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def _publish_breaker_gauges(self) -> None:
        """Publish breaker-state gauges (call with ``_lock`` held — the
        gauge must agree with the table that computed it)."""
        nopen = nhalf = 0
        for b in self._breakers.values():
            if b["state"] == OPEN:
                nopen += 1
            elif b["state"] == HALF_OPEN:
                nhalf += 1
        self.metrics.gauge("serving_breaker_open").set(nopen)
        self.metrics.gauge("serving_breaker_half_open").set(nhalf)

    def _breaker(self, op: str, rung: str) -> dict:
        return self._breakers.setdefault((op, rung), {
            "state": CLOSED, "failures": 0, "opened_t": 0.0,
            "opens": 0, "probes": 0})

    def breaker_allow(self, op: str, rung: str,
                      request: Optional[int] = None) -> bool:
        """May this (op, rung) rung run? ``closed`` → yes; ``open`` →
        only once the cooldown elapsed (transitions to ``half_open``
        and admits ONE probe); ``half_open`` → no (a probe is already
        in flight — its outcome decides)."""
        with self._lock:
            br = self._breakers.get((op, rung))
            if br is None or br["state"] == CLOSED:
                return True
            if br["state"] == OPEN and \
                    time.perf_counter() - br["opened_t"] \
                    >= self.breaker_cooldown_s:
                br["state"] = HALF_OPEN
                br["probes"] += 1
                self._publish_breaker_gauges()
                self._flight("breaker_half_open", op=op, rung=rung,
                             request=request, probes=br["probes"])
                return True
            return False

    def breaker_record(self, op: str, rung: str, ok: bool,
                       request: Optional[int] = None) -> None:
        """Feed one rung outcome into its breaker. A success closes
        (and zeroes the consecutive-failure count); the Nth
        consecutive failure — or any half-open probe failure — opens."""
        with self._lock:
            br = self._breaker(op, rung)
            if ok:
                reopened = br["state"] != CLOSED
                br["state"] = CLOSED
                br["failures"] = 0
                if reopened:
                    self._publish_breaker_gauges()
                    self._flight("breaker_close", op=op, rung=rung,
                                 request=request)
                return
            br["failures"] += 1
            if br["state"] == HALF_OPEN \
                    or br["failures"] >= self.breaker_failures:
                was_open = br["state"] == OPEN
                br["state"] = OPEN
                br["opened_t"] = time.perf_counter()
                if not was_open:
                    br["opens"] += 1
                    self.metrics.counter(
                        "serving_breaker_open_total").inc()
                    self._publish_breaker_gauges()
                    self._flight("breaker_open", op=op, rung=rung,
                                 request=request,
                                 failures=br["failures"])

    def breaker_state(self, op: str, rung: str) -> str:
        with self._lock:
            br = self._breakers.get((op, rung))
            return br["state"] if br is not None else CLOSED

    # ---------------------------------------------------------- summary

    def summary(self) -> dict:
        """The controller half of the run-report schema-v15
        ``"admission"`` section (the soak audit adds its own keys)."""
        def _c(name):
            m = self.metrics.get(name)
            return int(m.value) if m is not None else 0
        with self._lock:
            breakers = {
                f"{op}:{rung}": {"state": b["state"],
                                 "failures": b["failures"],
                                 "opens": b["opens"],
                                 "probes": b["probes"]}
                for (op, rung), b in sorted(self._breakers.items())}
            ewma = self._ewma_p99_ms
            retries_used = self._retries_used
        return {"enabled": self.enabled,
                "max_queue": self.max_queue,
                "max_inflight": self.max_inflight,
                "slo_p99_ms": self.slo_p99_ms,
                "ewma_p99_ms": ewma,
                "admitted": _c("serving_admitted_total"),
                "shed": _c("serving_shed_total"),
                "degraded": _c("serving_degraded_total"),
                "deadline_expired": _c(
                    "serving_deadline_expired_total"),
                "breaker_opens": _c("serving_breaker_open_total"),
                "breakers": breakers,
                "retry_budget": {"limit": self.retry_budget,
                                 "used": retries_used}}
