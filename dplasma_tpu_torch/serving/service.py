"""The request front-end: ``SolverService`` — submit/future handles,
a batching scheduler, and a per-request resilience ladder.

Ports ``dplasma_tpu/serving/service.py``. Requests (``submit(op, A, b)
-> SolveFuture``) are grouped by their cache key (op, shape bucket,
dtype, nrhs bucket, grid, pipeline shape, IR precision —
:func:`dplasma_tpu_torch.serving.cache.make_key`); a group dispatches as
ONE batched call when it reaches ``serving.max_batch``, when
``serving.max_wait_ms`` expires (a timer thread), when the caller blocks
on a pending future, or on ``flush()``. The batch is stacked on the host
and moved to the device in one transfer per operand; each kernel site
of the batched sweeps is one launch for the batch
(:mod:`dplasma_tpu_torch.serving.batched`). Results scatter back per
request (each sliced to its exact pre-padding shape) and are verified: a
non-finite census plus a normwise backward-error gate (and the
per-element convergence mask for the IR solvers).

A failed request walks the remediation ladder
(:class:`dplasma_tpu_torch.resilience.guard.Ladder`) **individually** —
classify -> retry (a solo re-solve, clean under ``inject.suppressed``)
-> kernel fallback -> algorithm escalation (posv -> pivoted LU, gesv ->
QR least squares, the IR ops -> their full-precision routes).
Batch-mates are untouched: their futures resolve from the batched
dispatch while the failed request heals on the side.

Fault injection: a per-request ``"serving"`` tap
(:mod:`dplasma_tpu_torch.resilience.inject`) on each scattered result —
the soft-error model for a corrupted response slot. Kernel-stage taps
(gemm/trsm/...) fire at run time inside the batched dispatch (the
reference's fire at trace time) and corrupt every element of the batch
at the tapped site; the dispatch's entry is then marked tainted and
dropped (the reference's accounting) and each request heals on its own
ladder.

Threads: the service dispatches from the caller's thread and from timer
threads. The batched sweeps touch process-global state (the MCA
override stack that pins a key's precision and pipeline, the kernels'
counters and launch-argument caches, torch's linalg backend switch), so
one dispatch runs at a time (``_DISPATCH_LOCK``); the device serializes
them anyway.

Telemetry (:mod:`dplasma_tpu_torch.observability.telemetry`): every
submit is stamped with a monotonically increasing ``request_id`` (on the
:class:`SolveFuture`, in ``meta``, and in every ``#+ serving:`` verbose
line and remediation stderr note); the always-on tracer records a span
tree per request — ``queue_wait`` → ``batch``
(``batch_form``/``cache``/``dispatch``) → ``scatter_gate`` → each
``ladder:<rung>`` — and the flight recorder keeps a bounded ring of
structured events, dumped to MCA ``telemetry.flight_path`` the moment a
request fails its gate and walks the ladder. Live gauges
(``serving_queue_depth``, ``serving_inflight_batches``,
``serving_cache_entries``) feed the streaming Prometheus exporter.

Overload posture (:mod:`dplasma_tpu_torch.serving.admission`): every
submit passes an admission decision inside the same critical section;
requests carry an optional deadline honored at dispatch and between
ladder rungs; the ladder consults a process-global retry budget and a
per-(op, rung) circuit breaker. ``SolveFuture.result(timeout=)`` raises
a structured :class:`ServingTimeout` naming the request id.

The tuning-DB consult of the reference (``_tuning_for``,
``_autopilot_for``) waits for ROADMAP item 9b: both return None, as the
reference's do with no DB; a service constructed while a DB is
configured (``DPLASMA_TUNE_DB`` or MCA ``tune.db``) with MCA
``tune.serving`` on raises instead of ignoring it.

Conventions: ``A`` is the full matrix (posv reads the lower triangle
of a full symmetric operand); ``b`` may be 1-D (a single right-hand
side — the result is returned 1-D) or ``(n, nrhs)``. The IR ops
require float64 inputs. Inputs are host arrays (numpy, or CPU
tensors); results are numpy arrays.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.observability import telemetry as tel_mod
from dplasma_tpu_torch.observability.metrics import (Histogram,
                                                     MetricsRegistry)
from dplasma_tpu_torch.resilience import guard, inject
from dplasma_tpu_torch.serving import admission as adm_mod
from dplasma_tpu_torch.serving import batched
from dplasma_tpu_torch.serving import cache as cache_mod
from dplasma_tpu_torch.serving.admission import (AdmissionError,
                                                 DeadlineExceeded,
                                                 ServingTimeout)
from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "serving.verbose", "0",
    "Verbosity of the SolverService: >=1 prints '#+ serving:' lines "
    "(dispatches, gate failures, ladder rungs) with the request id "
    "every line is attributable to.")
_cfg.mca_register(
    "serving.max_batch", "16",
    "Batching bound of the SolverService scheduler: a compatible "
    "request group dispatches as one batched call when it reaches "
    "this many requests.")
_cfg.mca_register(
    "serving.max_wait_ms", "5",
    "Batching window of the SolverService scheduler: an incomplete "
    "request group dispatches at most this many milliseconds after "
    "its first request arrived.")
_cfg.mca_register(
    "serving.max_retries", "1",
    "Per-request retry budget of the serving resilience ladder (the "
    "solo re-solve rung; fallback rungs are one-shot on top).")

#: residual gate scale of the per-request verification (check_axmb
#: style: THRESHOLD * eps * n)
_GATE = 60.0

#: one batched dispatch (or escalation) at a time: _dispatch runs on
#: caller AND timer threads, and the sweeps push the key's MCA pins on
#: the process-global, strictly LIFO override stack (two concurrent
#: pushes would interleave their pops), bump the kernels' module-level
#: counters and launch-argument caches, and switch torch's linalg
#: backend (ops.lu._lu_chain). The device runs one batch at a time
#: anyway. Order: the cache lock, then this one (a cache build runs the
#: callable), never the reverse.
_DISPATCH_LOCK = threading.Lock()


def _tune_db() -> Optional[str]:
    """The tuning DB a deployment configured (env ``DPLASMA_TUNE_DB`` >
    MCA ``tune.db``), as the reference's ``tuning.db.db_path`` reads
    it."""
    return os.environ.get("DPLASMA_TUNE_DB") or _cfg.mca_get("tune.db") \
        or None


def percentile(sorted_vals, p: float):
    """Nearest-rank percentile of an ascending list (None when empty)
    — shared by the service summary and tools/servebench.py."""
    if not sorted_vals:
        return None
    k = min(int(round(p / 100.0 * (len(sorted_vals) - 1))),
            len(sorted_vals) - 1)
    return sorted_vals[k]


@dataclasses.dataclass
class _Request:
    op: str
    a: np.ndarray
    b: np.ndarray          # always (n, nrhs)
    vec: bool              # caller passed a 1-D b
    n: int
    nrhs: int
    future: "SolveFuture"
    t_submit: float
    kwargs: dict
    rid: int = 0           # the stamped request id
    t_submit_ns: int = 0   # wall-clock twin of t_submit (tracing)
    deadline: float = 0.0  # absolute perf_counter expiry; 0 = none
    autopilot: Optional[dict] = None  # precision pre-flight decision


class SolveFuture:
    """Handle for one submitted solve. ``result()`` drives the
    scheduler if the request is still pending (a blocked caller is a
    latency bound, not a deadlock), then returns the solution;
    ``request_id`` is the service-stamped monotone id every telemetry
    span, flight-recorder event, and verbose/stderr line about this
    request carries; ``meta`` carries latency, batch, verification,
    and the resilience summary when the request walked the ladder."""

    def __init__(self, service: "SolverService", group):
        self._service = service
        self._group = group
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.request_id: int = 0
        self.meta: dict = {}

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, value, meta: dict) -> None:
        first = not self._event.is_set()
        self._value = value
        self.meta.update(meta)
        self._event.set()
        if first:
            # the conservation ledger: every admitted request resolves
            # exactly once (value or error) — the soak audit's
            # submitted == resolved + shed side
            self._service.metrics.counter(
                "serving_resolved_total").inc()

    def _fail(self, exc: BaseException) -> None:
        first = not self._event.is_set()
        self._error = exc
        self._event.set()
        if first:
            self._service.metrics.counter(
                "serving_resolved_total").inc()

    def result(self, timeout: Optional[float] = None):
        if not self._event.is_set():
            self._service._drive(self._group)
        if not self._event.wait(timeout):
            # structured and attributable: the caller learns WHICH
            # request is stuck (a dead dispatch thread, a wedged
            # build) instead of hanging forever on the bare event
            raise ServingTimeout(
                f"request {self.request_id} still pending after "
                f"{timeout:g}s (solve not dispatched or dispatch "
                f"thread died)", request_id=self.request_id)
        if self._error is not None:
            raise self._error
        return self._value


class SolverService:
    """Batched solver-as-a-service front-end (module docstring).

    ``nb`` is the tile size every batched sweep runs at (one cache entry
    per cache key); ``check=False`` disables the per-request
    verification gate (dispatch-rate benchmarking — the resilience
    ladder needs the gate on). ``device``: where the batches run (the
    card unless the caller asks for the CPU, :func:`resolve_device`).
    """

    def __init__(self, nb: int = 8, *, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 cache: Optional[cache_mod.ExecutableCache] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 max_retries: Optional[int] = None, check: bool = True,
                 telemetry: Optional[tel_mod.Telemetry] = None,
                 verbose: Optional[int] = None, device=None):
        if _cfg.mca_get("tune.serving", "on") != "off" and _tune_db():
            raise ValueError(
                f"a tuning DB is configured ({_tune_db()!r}) but the "
                "serving layer's tuning-DB consult is not ported yet "
                "(ROADMAP item 9b); unset DPLASMA_TUNE_DB / MCA tune.db "
                "or set MCA tune.serving=off")
        self.device = resolve_device(device)
        self.nb = int(nb)
        self.max_batch = max(
            max_batch if max_batch is not None
            else _cfg.mca_get_int("serving.max_batch", 16), 1)
        if max_wait_ms is None:
            try:
                max_wait_ms = float(
                    _cfg.mca_get("serving.max_wait_ms", "5"))
            except ValueError:
                max_wait_ms = 5.0
        self.max_wait_ms = max(float(max_wait_ms), 0.0)
        self.max_retries = max(
            max_retries if max_retries is not None
            else _cfg.mca_get_int("serving.max_retries", 1), 0)
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self.cache = cache if cache is not None \
            else cache_mod.ExecutableCache(metrics=self.metrics)
        self.check = bool(check)
        # the live instruments: always-on span tracer + flight
        # recorder (module docstring); cache evictions/invalidations
        # land in the same flight ring
        self.telemetry = telemetry if telemetry is not None \
            else tel_mod.Telemetry()
        self.cache.recorder = self.telemetry.flight
        # the overload posture: admission decisions, the SLO tracker,
        # circuit breakers, and the global retry budget (MCA
        # serving.* knobs; decisions/transitions land in the flight
        # ring by request id)
        self.admission = adm_mod.AdmissionController(
            metrics=self.metrics, flight=self.telemetry.flight)
        self.verbose = int(verbose) if verbose is not None \
            else _cfg.mca_get_int("serving.verbose", 0)
        self.resilience: List[dict] = []   # ladder summaries
        # per-cache-key tuning-DB consultation memo (the reference's
        # serving face of its tuning package, ROADMAP item 9b here:
        # every value is None, as the reference's with no DB)
        self._tuning: Dict[cache_mod.CacheKey, Optional[dict]] = {}
        self._pending: Dict[tuple, List[_Request]] = {}
        # (op, n, nrhs, dtype, kwargs) -> CacheKey memo: the key
        # context (grid, pipeline shape, ir precision, bucket policy)
        # is captured when a request shape is first seen — retune MCA
        # knobs, construct a new service
        self._keys: Dict[tuple, cache_mod.CacheKey] = {}
        self._timers: Dict[tuple, threading.Timer] = {}
        self._lock = threading.RLock()
        self._latencies: List[float] = []
        self._batches = 0
        self._requests = 0
        self._next_rid = 0      # monotone request-id stamp
        self._queued = 0        # live queue depth (gauge)
        self._inflight = 0      # live in-flight batches (gauge)

    # ------------------------------------------------------ submission
    def submit(self, op: str, A, b,
               deadline_s: Optional[float] = None,
               **kwargs) -> SolveFuture:
        """Queue one solve ``op(A) x = b``; returns a future. The
        request first passes admission: a shed raises
        :class:`AdmissionError` (the request id it carries matches
        the flight-recorder ``shed`` event), a degrade re-keys an IR
        request onto the next-cheaper ``ir.precision`` cache entry.
        ``deadline_s`` (default MCA ``serving.default_deadline_s``)
        bounds the request end to end: expired requests fail with
        :class:`DeadlineExceeded` instead of paying for a solve."""
        if op not in ("posv", "gesv", "posv_ir", "gesv_ir"):
            raise ValueError(f"unservable op {op!r}")
        a = np.asarray(A)
        bb = np.asarray(b)
        vec = bb.ndim == 1
        if vec:
            bb = bb[:, None]
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"A must be (n, n), got {a.shape}")
        if bb.ndim != 2 or bb.shape[0] != a.shape[0]:
            raise ValueError(f"b {bb.shape} does not match A {a.shape}")
        if a.dtype != bb.dtype:
            raise TypeError(f"A ({a.dtype}) and b ({bb.dtype}) must "
                            "share a dtype")
        if op.endswith("_ir") and np.dtype(a.dtype).name != "float64":
            raise TypeError(f"{op} refines to f64-equivalent accuracy: "
                            f"inputs must be float64, got {a.dtype}")
        n, nrhs = a.shape[0], bb.shape[1]
        extra = tuple(sorted(kwargs.items()))
        memo = (op, n, nrhs, a.dtype.str, extra)
        deadline = adm_mod.resolve_deadline(deadline_s)
        # precision-autopilot pre-flight (IR ops): the reference's
        # condest sketch -> cond class -> stored rung, which needs the
        # tuning DB (ROADMAP item 9b); None here, as the reference's
        # with no DB. It folds into the memo/cache key below.
        ap = self._autopilot_for(op, a) if op.endswith("_ir") else None
        ap_prec = (ap or {}).get("precision")
        dispatch_now = None
        degrade_prec: Optional[str] = None
        # one critical section per submit: the admission decision, the
        # key memo (the _tuning_for discipline — two threads racing
        # the same new shape must memoize exactly one key), the queue
        # mutation, and the gauge publish are all cheap host work,
        # cheap enough to hold the lock across
        with self._lock:
            decision, reason = self.admission.decide(
                op, self._queued, self._inflight)
            self._next_rid += 1
            rid = self._next_rid
            if decision == adm_mod.SHED:
                queued = self._queued
            else:
                if decision == adm_mod.DEGRADE:
                    # the cheaper-precision callable is a DIFFERENT
                    # program: its own memo slot and cache key (the
                    # key's precision field pins the run in _builder).
                    # An overload degrade outranks the autopilot — it
                    # is a load-shedding decision, not a tuning one.
                    degrade_prec = adm_mod.degraded_precision()
                    memo = memo + (("degrade", degrade_prec),)
                elif ap_prec:
                    # the autopilot's rung lands in the cache key the
                    # same way: per-rung memo slot, precision-pinned
                    # run in _builder
                    memo = memo + (("autopilot", ap_prec),)
                key = self._keys.get(memo)
                if key is None:
                    key = cache_mod.make_key(
                        op, n, a.dtype, 1, nrhs, extra=extra,
                        precision=(degrade_prec if degrade_prec
                                   else ap_prec))
                    self._keys[memo] = key
                group = key._replace(batch=0)  # batch bucket set at
                fut = SolveFuture(self, group)  # dispatch
                req = _Request(op=op, a=a, b=bb, vec=vec, n=n,
                               nrhs=nrhs, future=fut,
                               t_submit=time.perf_counter(),
                               kwargs=dict(kwargs),
                               t_submit_ns=time.time_ns(),
                               deadline=deadline, autopilot=ap)
                self._requests += 1
                req.rid = fut.request_id = rid
                self.metrics.counter("serving_requests_total",
                                     op=op).inc()
                lst = self._pending.setdefault(group, [])
                lst.append(req)
                self._queued += 1
                if len(lst) >= self.max_batch:
                    dispatch_now = self._pending.pop(group)
                    self._queued -= len(dispatch_now)
                    self._cancel_timer(group)
                elif len(lst) == 1 and self.max_wait_ms > 0:
                    t = threading.Timer(self.max_wait_ms / 1000.0,
                                        self._drive, args=(group,))
                    t.daemon = True
                    self._timers[group] = t
                    t.start()
                # published under the lock, like _drive's update: a
                # gauge set after release could land out of order
                # against a racing submit and stick a stale depth in
                # the exporter
                self.metrics.gauge("serving_queue_depth").set(
                    self._queued)
        if decision == adm_mod.SHED:
            self.telemetry.flight.record("shed", request=rid, op=op,
                                         reason=reason, queued=queued)
            self.telemetry.tracer.instant("shed", request=rid, op=op)
            if self.verbose >= 1:
                print(f"#+ serving: req={rid} SHED ({reason})",
                      flush=True)
            raise AdmissionError(f"request {rid} shed: {reason}",
                                 request_id=rid, reason=reason)
        self.telemetry.flight.record("submit", request=rid, op=op,
                                     n=n, nrhs=nrhs)
        if ap is not None:
            self.telemetry.flight.record(
                "autopilot", request=rid, op=op,
                precision=ap_prec, cond_class=ap["cond_class"],
                source=ap["source"])
            self.metrics.counter("serving_autopilot_consults_total",
                                 source=ap["source"]).inc()
            if self.verbose >= 1:
                print(f"#+ serving: req={rid} autopilot "
                      f"cond_class={ap['cond_class']} "
                      f"ir.precision={ap_prec or 'ambient'} "
                      f"({ap['source']})", flush=True)
        if decision == adm_mod.DEGRADE:
            self.telemetry.flight.record(
                "degrade", request=rid, op=op,
                precision=degrade_prec, reason=reason)
            if self.verbose >= 1:
                print(f"#+ serving: req={rid} DEGRADED to "
                      f"ir.precision={degrade_prec} ({reason})",
                      flush=True)
        else:
            self.telemetry.flight.record("admit", request=rid, op=op)
        if dispatch_now:
            self._dispatch(group, dispatch_now)
        return fut

    def _cancel_timer(self, group) -> None:
        t = self._timers.pop(group, None)
        if t is not None:
            t.cancel()

    def _drive(self, group) -> None:
        """Dispatch one group now (timer fired / caller blocked)."""
        with self._lock:
            reqs = self._pending.pop(group, None)
            self._cancel_timer(group)
            if reqs:
                self._queued -= len(reqs)
                self.metrics.gauge("serving_queue_depth").set(
                    self._queued)
        if reqs:
            self._dispatch(group, reqs)

    def flush(self) -> None:
        """Dispatch every pending group."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                group = next(iter(self._pending))
            self._drive(group)

    def close(self) -> None:
        self.flush()
        with self._lock:
            for t in self._timers.values():
                t.cancel()
            self._timers.clear()
        self.telemetry.close()     # final exporter flush, if running

    # -------------------------------------------------------- dispatch
    def _stack(self, key: cache_mod.CacheKey, reqs: List[_Request]):
        """Assemble a bucket-shaped (As, bs) pair: identity everywhere
        first, so the overwritten top-left block leaves exactly the
        identity shape-padding (cache.pad_problem semantics) and empty
        batch slots carry whole identity problems — host-side numpy,
        then one transfer per operand (:meth:`_run`)."""
        nB, rB, Bc = key.n, key.nrhs, key.batch
        dt = np.dtype(key.dtype)
        As = np.zeros((Bc, nB, nB), dt)
        bs = np.zeros((Bc, nB, rB), dt)
        idx = np.arange(nB)
        As[:, idx, idx] = 1.0
        for i, r in enumerate(reqs):
            As[i, :r.n, :r.n] = r.a
            bs[i, :r.n, :r.nrhs] = r.b
        return As, bs

    def _builder(self, key: cache_mod.CacheKey, kwargs: dict):
        """The ONE callable body both the batched and the solo paths
        build: solve + the backward errors, under ``_DISPATCH_LOCK`` and
        the key's pins (its pipeline shape and, for the IR ops, its
        ``ir.precision``: key and callable always agree, also for a
        degraded rung)."""
        nb, op, kw = self.nb, key.op, dict(kwargs)
        pins = {"sweep.lookahead": str(key.pipeline[0]),
                "qr.agg_depth": str(key.pipeline[1])}
        if key.precision and op.endswith("_ir"):
            pins["ir.precision"] = key.precision

        def build():
            def fn(a, b):
                with _DISPATCH_LOCK, \
                        _cfg.override_scope(pins, label="serving"):
                    x, info = batched.solve_batched(op, a, b, nb, **kw)
                    bwd = batched.backward_errors(a, b, x)
                return (x, bwd, info) if info is not None else (x, bwd)
            return fn
        return build

    def _tuning_for(self, key: cache_mod.CacheKey) -> Optional[dict]:
        """The tuning-DB consultation for one cache key, memoized. The
        consult is ROADMAP item 9b: None, as the reference's with no DB
        (a configured DB is refused at construction)."""
        with self._lock:
            self._tuning.setdefault(key, None)
            return self._tuning[key]

    def _autopilot_for(self, op: str, a: np.ndarray) -> Optional[dict]:
        """The precision-autopilot pre-flight of one IR request: None
        until ROADMAP item 9b, as the reference's with no DB."""
        return None

    def _run(self, key: cache_mod.CacheKey, reqs: List[_Request]):
        """Build-or-hit + dispatch one bucket-shaped batch; returns
        (X, bwds, info, cache_hit), host numpy. An entry whose dispatch
        fired a fault plan is marked tainted and dropped (the
        reference's accounting: its tainted executables are those
        compiled while a plan fired)."""
        tracer = self.telemetry.tracer
        with tracer.span("batch_form", op=key.op, batch=len(reqs)):
            As, bs = self._stack(key, reqs)
            # ONE host -> device transfer per operand
            Aj = torch.from_numpy(As).to(self.device)
            bj = torch.from_numpy(bs).to(self.device)
        with tracer.span("cache", op=key.op) as cattrs:
            # probed ONCE; the span attr, the flight event, and the
            # verbose line all reuse this answer
            hit = cattrs["hit"] = key in self.cache
            self._tuning_for(key)
            entry = self.cache.get(key, self._builder(key, reqs[0].kwargs),
                                   Aj, bj)
        with tracer.span("dispatch", op=key.op, batch=len(reqs)):
            faults0 = len(inject.faults())
            out = entry.fn(Aj, bj)
            if len(inject.faults()) > faults0:
                entry.tainted = True
            info = None
            if len(out) > 2:
                info = {k: v.cpu().numpy() for k, v in out[2].items()}
            res = (out[0].cpu().numpy(), out[1].cpu().numpy(), info, hit)
        if entry.tainted:
            self.cache.invalidate(key)
        return res

    def _expire(self, r: _Request, where: str,
                fail_future: bool = True) -> None:
        """Account one expired deadline (counter + flight event +
        timeline marker, all by request id); optionally fail the
        future with the structured :class:`DeadlineExceeded`."""
        self.metrics.counter("serving_deadline_expired_total").inc()
        self.telemetry.flight.record("deadline_expired",
                                     request=r.rid, op=r.op,
                                     where=where)
        self.telemetry.tracer.instant("deadline_expired",
                                      request=r.rid, where=where)
        if self.verbose >= 1:
            print(f"#+ serving: req={r.rid} deadline expired at "
                  f"{where}", flush=True)
        if fail_future:
            r.future._fail(DeadlineExceeded(
                f"request {r.rid} deadline expired at {where}",
                request_id=r.rid))

    def _dispatch(self, group, reqs: List[_Request]) -> None:
        tracer = self.telemetry.tracer
        # queue-wait spans close here, retroactively: the wait ended
        # the moment this dispatch picked the group up
        now_ns = time.time_ns()
        for r in reqs:
            # no attrs: the request's op is on its submit event, and
            # this add() runs per request on the always-on hot path
            tracer.add("queue_wait", r.t_submit_ns, now_ns,
                       request=r.rid)
        # deadline gate: a request that expired waiting in the queue
        # fails fast HERE, before anyone pays to solve it (and before
        # the batch bucket is sized, so the survivors run small)
        now = time.perf_counter()
        expired = [r for r in reqs if r.deadline and now > r.deadline]
        if expired:
            for r in expired:
                self._expire(r, where="dispatch")
            reqs = [r for r in reqs
                    if not (r.deadline and now > r.deadline)]
            if not reqs:
                return
        key = group._replace(batch=cache_mod.bucket_batch(len(reqs)))
        rids = [r.rid for r in reqs]
        with self._lock:
            self._inflight += 1
            self.metrics.gauge("serving_inflight_batches").set(
                self._inflight)
        try:
            with tracer.span("batch", op=key.op, requests=rids,
                             batch=len(reqs)) as battrs:
                try:
                    X, bwds, info, hit = self._run(key, reqs)
                    battrs["cached"] = hit
                except Exception as exc:   # build/dispatch failure:
                    for r in reqs:         # every request fails loudly
                        r.future._fail(exc)
                    self.telemetry.flight.record(
                        "dispatch_error", op=key.op, requests=rids,
                        error=repr(exc))
                    raise
                self.telemetry.flight.record(
                    "dispatch", op=key.op, batch=len(reqs),
                    requests=rids,
                    bucket=[key.n, key.nrhs, key.batch],
                    cache="hit" if hit else "miss")
                if self.verbose >= 1:
                    print(f"#+ serving: dispatch op={key.op} "
                          f"batch={len(reqs)} "
                          f"bucket=({key.n},{key.nrhs},{key.batch}) "
                          f"reqs={rids} "
                          f"cache={'hit' if hit else 'miss'}",
                          flush=True)
                with self._lock:
                    self._batches += 1
                self.metrics.counter("serving_batches_total").inc()
                self.metrics.histogram("serving_batch_size").observe(
                    len(reqs))
                first_exc: Optional[BaseException] = None
                failed_rids: List[int] = []
                for i, r in enumerate(reqs):
                    # per-request isolation: a raising remediation (the
                    # solo rebuild, an escalation route) must fail
                    # THIS future only — the remaining batch-mates
                    # still resolve, and no caller blocks forever on
                    # an unresolved future
                    try:
                        self._scatter_one(key, reqs, r, i, X, bwds,
                                          info)
                    except Exception as exc:
                        r.future._fail(exc)
                        first_exc = first_exc or exc
                        failed_rids.append(r.rid)
                if first_exc is not None:
                    # delivered to the owning futures above; do NOT
                    # re-raise — dispatch may be running inside an
                    # INNOCENT batch-mate's result()/submit() call (or
                    # a timer thread), and a foreign request's failure
                    # must not surface there. One stderr note (request
                    # ids named) so timer-thread failures aren't
                    # invisible or unattributable.
                    sys.stderr.write(
                        f"#! serving: {len(failed_rids)} request(s) "
                        f"failed in dispatch "
                        f"(reqs={failed_rids}): {first_exc!r}\n")
        finally:
            with self._lock:
                self._inflight -= 1
                self.metrics.gauge("serving_inflight_batches").set(
                    self._inflight)

    def _scatter_one(self, key, reqs: List[_Request], r: _Request,
                     i: int, X, bwds, info) -> None:
        """Scatter + gate + (if needed) remediate ONE request of a
        dispatched batch, resolving its future."""
        tracer = self.telemetry.tracer
        with tracer.span("scatter_gate", request=r.rid,
                         op=r.op) as gattrs:
            x = X[i, :r.n, :r.nrhs]
            rejected = False
            if inject.armed():
                # per-request response tap (module docstring) — only
                # pay the round-trip while a plan is live. A 'reject'
                # fault raises here: treated as a failed response (not
                # a raw future failure) so it walks the ladder below
                nfaults0 = len(inject.faults())
                try:
                    x = inject.tap("serving",
                                   torch.from_numpy(x.copy())).numpy()
                except inject.InjectedReject:
                    rejected = True
                if len(inject.faults()) > nfaults0:
                    self.telemetry.flight.record(
                        "inject", request=r.rid, op=r.op,
                        fault=inject.faults()[-1])
            meta = {"request_id": r.rid, "batch": len(reqs),
                    "batched": True,
                    "bucket": (key.n, key.nrhs, key.batch)}
            if info is not None:
                meta["refine"] = self._refine_meta(info, i)
                if r.autopilot is not None:
                    meta["autopilot"] = r.autopilot
            if rejected:
                # no response to verify — synthesize a failing health
                # record and go straight to remediation
                health = {"nan": 0, "inf": 0, "leaves": 1, "ok": False}
                ok, verdict = False, {"ok": False,
                                      "error": "injected reject"}
            else:
                ok, health, verdict = self._verify(
                    r, x, meta.get("refine"),
                    bwd=None if inject.armed() else float(bwds[i]))
            meta.update(verdict)
            gattrs["ok"] = bool(ok)
        if not ok:
            self.telemetry.flight.record(
                "gate_fail", request=r.rid, op=r.op, verdict=verdict,
                health={k: health[k] for k in ("nan", "inf", "ok")})
            if self.verbose >= 1:
                print(f"#+ serving: req={r.rid} gate FAILED "
                      f"verdict={verdict} -> remediation ladder",
                      flush=True)
            if r.deadline and time.perf_counter() > r.deadline:
                # nobody is waiting anymore: fail fast instead of
                # paying for a ladder walk
                self._expire(r, where="ladder")
                return
            x, meta = self._remediate(r, x, health, meta,
                                      batch_key=key)
        # latency is the user-visible submit->resolve span, INCLUDING
        # any remediation walk this request took
        lat = time.perf_counter() - r.t_submit
        meta["latency_s"] = lat
        with self._lock:
            self._latencies.append(lat)
        self.metrics.histogram("serving_latency_s").observe(lat)
        # feed the admission SLO tracker from the telemetry histogram
        # (EWMA-smoothed p99 — the shed/degrade pressure signal)
        self.admission.observe(
            lat, self.metrics.histogram("serving_latency_s"))
        r.future._resolve(x[:, 0] if r.vec else x, meta)

    @staticmethod
    def _refine_meta(info, i: int) -> dict:
        hist = [float(v) for v in np.asarray(info["backward_errors"])[i]
                if v >= 0]
        return {"converged": bool(np.asarray(info["converged"])[i]),
                "escalated": bool(np.asarray(info["escalated"])[i]),
                "iterations": int(np.asarray(info["iterations"])[i]),
                "backward_errors": hist}

    # ---------------------------------------------------- verification
    def _verify(self, r: _Request, x: np.ndarray,
                refine_meta: Optional[dict], bwd: Optional[float] = None
                ) -> Tuple[bool, dict, dict]:
        """Per-request health gate: non-finite census + normwise
        backward error (and the IR convergence verdict). ``bwd`` is
        the error the batched callable computed on the device
        (:func:`serving.batched.backward_errors`); recomputed on the
        host when absent (remediation rungs) or when a fault plan is
        armed (the serving tap corrupts AFTER the callable measured
        its error — the gate must see the corruption)."""
        bad = int(np.size(x) - np.isfinite(x).sum())
        health = {"nan": int(np.isnan(x).sum()),
                  "inf": bad - int(np.isnan(x).sum()),
                  "leaves": 1, "ok": bad == 0}
        if not self.check:
            return health["ok"], health, {"ok": health["ok"]}
        verdict: dict = {}
        ok = health["ok"]
        if ok:
            if bwd is None:
                res = r.b - r.a @ x
                den = (max(np.max(np.abs(r.a)), 1.0)
                       * np.max(np.abs(x)) + np.max(np.abs(r.b)))
                tiny = float(np.finfo(r.a.dtype).tiny)
                bwd = float(np.max(np.abs(res)) / max(den, tiny))
            verdict["backward_error"] = float(bwd)
            gate = _GATE * float(np.finfo(r.a.dtype).eps) * r.n
            if refine_meta is not None:
                # the convergence mask was measured INSIDE the
                # batched callable, before the response left it — a
                # corrupted-in-flight (finite-but-wrong) IR response
                # must still fail the host-side residual gate
                ok = (refine_meta["converged"] and np.isfinite(bwd)
                      and bwd <= gate)
            else:
                ok = bwd <= gate
        verdict["ok"] = bool(ok)
        return bool(ok), health, verdict

    # ----------------------------------------------------- remediation
    def _solo_key(self, r: _Request) -> cache_mod.CacheKey:
        return cache_mod.make_key(
            r.op, r.n, r.a.dtype, 1, r.nrhs,
            extra=tuple(sorted(r.kwargs.items())))

    def _solo(self, r: _Request):
        """The retry rung: re-solve this one request alone (batch
        bucket 1) through the same stack/build path as the batched
        dispatch — a fresh entry when the batched one was dropped
        as tainted."""
        X, _bwds, info, _hit = self._run(self._solo_key(r), [r])
        return X[0, :r.n, :r.nrhs], (
            self._refine_meta(info, 0) if info is not None else None)

    def _escalate(self, r: _Request):
        """The algorithm-escalation rung: the trusted unbatched route
        — posv -> pivoted LU, gesv -> QR least squares, the IR ops ->
        their full-precision solvers (exactly the escape
        :mod:`dplasma_tpu_torch.ops.refine` wires internally)."""
        from dplasma_tpu_torch.descriptors import TileMatrix
        from dplasma_tpu_torch.ops import lu as lu_mod
        from dplasma_tpu_torch.ops import potrf as potrf_mod
        from dplasma_tpu_torch.ops import qr as qr_mod
        At = TileMatrix.from_dense(torch.from_numpy(r.a).to(self.device),
                                   self.nb, self.nb)
        Bt = TileMatrix.from_dense(torch.from_numpy(r.b).to(self.device),
                                   self.nb, self.nb)
        with _DISPATCH_LOCK:
            if r.op == "posv":
                _, _, X = lu_mod.gesv_1d(At, Bt)
            elif r.op == "gesv":
                X = qr_mod.gels(At, Bt)
            elif r.op == "posv_ir":
                _, X = potrf_mod.posv(At, Bt, "L")
            else:   # gesv_ir
                _, _, X = lu_mod.gesv_1d(At, Bt)
            x = X.to_dense()[:r.n, :r.nrhs].cpu().numpy()
        return x, None

    def _remediate(self, r: _Request, x: np.ndarray, health: dict,
                   meta: dict,
                   batch_key: Optional[cache_mod.CacheKey] = None
                   ) -> Tuple[np.ndarray, dict]:
        """Walk the remediation ladder for ONE request (classify -> retry ->
        kernel fallback -> algorithm escalation); batch-mates are
        never re-dispatched."""
        ip = types.SimpleNamespace(max_retries=self.max_retries,
                                   inject=None, abft=False,
                                   run_timeout=0.0)
        ladder = guard.Ladder(ip, r.op, fallbacks=[
            (f"{r.op}_escalate", self._escalate)])
        cls = ladder.classify(health, None, False)
        ladder.record(guard.ACTION_PRIMARY, f"batched[{meta['batch']}]",
                      ok=False, classification=cls, health=health)
        self.metrics.counter("serving_faults_total", op=r.op).inc()
        tracer = self.telemetry.tracer
        while True:
            if r.deadline and time.perf_counter() > r.deadline:
                # the walk is bounded by the request deadline: account
                # the expiry and surface DeadlineExceeded through the
                # dispatch isolation (which fails THIS future only)
                ladder.record("deadline", "deadline", ok=False,
                              classification=cls,
                              error="deadline expired mid-ladder")
                with self._lock:
                    self.resilience.append(
                        ladder.summary(injection=None))
                self._expire(r, where="ladder", fail_future=False)
                raise DeadlineExceeded(
                    f"request {r.rid} deadline expired mid-ladder",
                    request_id=r.rid)
            nxt = ladder.next_action(cls)
            if nxt is None:
                break
            action, label, fn = nxt
            if not self.admission.breaker_allow(r.op, action,
                                               request=r.rid):
                # the (op, rung) breaker is open: a rung that failed
                # serving.breaker_failures times in a row is skipped,
                # not re-failed per request — a poisoned entry
                # cannot consume the service
                ladder.record(action, label, ok=False,
                              classification=cls,
                              error="breaker open")
                if self.verbose >= 1:
                    print(f"#+ serving: req={r.rid} ladder rung "
                          f"{action}:{label} skipped (breaker open)",
                          flush=True)
                continue
            if action == guard.ACTION_RETRY \
                    and not self.admission.take_retry():
                # process-global retry budget exhausted: fall through
                # to the fallback rungs instead of multiplying load
                ladder.record(action, label, ok=False,
                              classification=cls,
                              error="retry budget exhausted")
                if self.verbose >= 1:
                    print(f"#+ serving: req={r.rid} ladder rung "
                          f"{action}:{label} skipped (retry budget "
                          f"exhausted)", flush=True)
                continue
            if action == guard.ACTION_KERNEL_FALLBACK:
                guard.kernel_fallback()
                # the demotion changes what a fresh build runs,
                # but not the cache keys: drop the solo entry the
                # retry rung cached so this rung actually runs on
                # the demoted kernel set, AND the batched entry
                # this request came from — otherwise every future
                # batch under that key replays the distrusted program
                # and walks the ladder forever
                self.cache.invalidate(self._solo_key(r))
                if batch_key is not None:
                    self.cache.invalidate(batch_key)
            if action == guard.ACTION_RETRY:
                self.metrics.counter("serving_retries_total",
                                     op=r.op).inc()
            if action == guard.ACTION_ALGO_FALLBACK:
                self.metrics.counter("serving_escalations_total",
                                     op=r.op).inc()
            # remediation runs clean, like the driver ladder's rungs
            # (a transient fault does not recur on recompute)
            try:
                with tracer.span(f"ladder:{action}", request=r.rid,
                                 op=r.op, label=label) as lattrs:
                    with inject.suppressed():
                        if fn is not None:
                            x2, rmeta = fn(r)
                        else:
                            x2, rmeta = self._solo(r)
                    ok2, health2, verdict2 = self._verify(r, x2, rmeta)
                    lattrs["ok"] = bool(ok2)
            except Exception:
                # a RAISING rung is a failure the breaker must see
                # (the exception still propagates to the dispatch
                # isolation, failing this future only)
                self.admission.breaker_record(r.op, action, False,
                                              request=r.rid)
                raise
            self.admission.breaker_record(r.op, action, bool(ok2),
                                          request=r.rid)
            self.telemetry.flight.record(
                "ladder", request=r.rid, op=r.op, action=action,
                label=label, ok=bool(ok2))
            if self.verbose >= 1:
                print(f"#+ serving: req={r.rid} ladder rung "
                      f"{action}:{label} "
                      f"{'ok' if ok2 else 'failed'}", flush=True)
            ladder.record(action, label, ok2,
                          classification=None if ok2
                          else ladder.classify(health2, None, False),
                          health=health2)
            if ok2:
                ladder.winner = label
                x = x2
                meta.update(verdict2)
                if rmeta is not None:
                    meta["refine"] = rmeta
                break
            cls = ladder.classify(health2, None, False)
        summary = ladder.summary(injection=None)
        meta["resilience"] = summary
        meta["ok"] = summary["outcome"] != "failed"
        with self._lock:
            self.resilience.append(summary)
        if summary["outcome"] == "failed":
            self.metrics.counter("serving_failed_total", op=r.op).inc()
        self.telemetry.flight.record(
            "remediation", request=r.rid, op=r.op,
            outcome=summary["outcome"], winner=summary["winner"],
            attempts=len(summary["attempts"]))
        if self.verbose >= 1:
            print(f"#+ serving: req={r.rid} remediation outcome="
                  f"{summary['outcome']} winner={summary['winner']}",
                  flush=True)
        # the incident carries its own evidence: a request that failed
        # its gate and walked the ladder dumps the flight ring to disk
        # (MCA telemetry.flight_path; empty = in-memory only, the ring
        # still lands in the run-report's telemetry section)
        dump_path = self.telemetry.flight_dump_path()
        if dump_path:
            self.telemetry.flight.dump(dump_path)
        return x, meta

    # --------------------------------------------------------- summary
    def reset_stats(self) -> None:
        """Zero the request/batch/latency/remediation records (the
        cache and its counters stay): benches call this after a
        warmup pass so the summary covers measured traffic only —
        a warmup build latency is not service latency. The
        telemetry instruments reset with them (warmup spans/events
        and warmup latency observations are build noise, not
        traffic), but the request-id stamp stays monotone."""
        with self._lock:
            self._latencies.clear()
            self.resilience.clear()
            self._batches = 0
            self._requests = 0
        self.telemetry.clear()
        for name in ("serving_latency_s", "serving_batch_size"):
            h = self.metrics.get(name)
            if isinstance(h, Histogram):
                h.reset()

    def summary(self) -> dict:
        """The run-report schema-v8 ``"serving"`` entry for this
        service's lifetime (requests, batching, latency percentiles,
        cache economics, remediation outcomes)."""
        with self._lock:
            lats = sorted(self._latencies)
            batches = self._batches
            requests = self._requests
            res = list(self.resilience)
            tunes = dict(self._tuning)
        tuning = None
        if any(v is not None for v in tunes.values()):
            sources: Dict[str, int] = {}
            for v in tunes.values():
                src = v["source"] if v else "default"
                sources[src] = sources.get(src, 0) + 1
            tuning = {"consulted": len(tunes), "sources": sources}
        return {"requests": requests, "batches": batches,
                "admission": self.admission.summary(),
                "tuning": tuning,
                "mean_batch": (requests / batches) if batches else None,
                "latency_s": {"p50": percentile(lats, 50),
                              "p99": percentile(lats, 99),
                              "max": lats[-1] if lats else None},
                "cache": self.cache.stats(),
                "remediated": sum(1 for s in res
                                  if s["outcome"] == "remediated"),
                "failed": sum(1 for s in res
                              if s["outcome"] == "failed"),
                "retries": sum(
                    1 for s in res for a in s["attempts"]
                    if a["action"] == guard.ACTION_RETRY),
                "escalations": sum(
                    1 for s in res for a in s["attempts"]
                    if a["action"] == guard.ACTION_ALGO_FALLBACK)}
