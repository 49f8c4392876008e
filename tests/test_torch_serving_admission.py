"""Port parity: the serving layer's admission control
(``dplasma_tpu_torch.serving.admission``) against
``dplasma_tpu.serving.admission``, host logic ported line for line.

One scripted stream — admission decisions at given queue depths and
inflight counts, completed-request latencies feeding the SLO tracker,
retry-budget draws, and breaker outcomes with the clock advanced
between them — drives a controller of each package. The clock is
injected (``time.perf_counter`` replaced by a counter the script
advances), so cooldowns, half-open probes and deadlines are exact. Every
decision, every breaker answer, each summary and the flight events
(kind and fields, without the wall-clock stamp and sequence number) must
be equal.
"""
import time

import pytest

from dplasma_tpu.observability import metrics as ref_metrics
from dplasma_tpu.observability import telemetry as ref_tel
from dplasma_tpu.serving import admission as ref_adm
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.observability import metrics
from dplasma_tpu_torch.observability import telemetry
from dplasma_tpu_torch.serving import admission
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def _pair(**kw):
    """(port controller, its histogram), (reference controller, its
    histogram), each with its own registry and flight recorder."""
    out = []
    for met, tel, adm in ((metrics, telemetry, admission),
                          (ref_metrics, ref_tel, ref_adm)):
        reg = met.MetricsRegistry()
        ctl = adm.AdmissionController(reg, flight=tel.FlightRecorder(512),
                                      **kw)
        out.append((ctl, reg.histogram("serving_latency_s")))
    return out


def _events(ctl):
    return [{k: v for k, v in e.items() if k not in ("seq", "t_ns")}
            for e in ctl.flight.events()]


SCRIPT = [
    # (action, args)
    ("decide", ("posv", 0, 0)), ("decide", ("posv", 3, 1)),
    ("decide", ("gesv", 4, 0)),            # queue cap
    ("decide", ("posv_ir", 1, 2)),         # inflight cap
    ("observe", (0.002,)), ("observe", (0.004,)),
    ("decide", ("posv_ir", 0, 0)),
    ("observe", (0.030,)), ("observe", (0.050,)), ("observe", (0.060,)),
    ("observe", (0.070,)), ("observe", (0.080,)), ("observe", (0.090,)),
    ("observe", (0.100,)), ("observe", (0.110,)), ("observe", (0.120,)),
    ("decide", ("posv_ir", 0, 0)),         # SLO pressure: degrade
    ("decide", ("gesv", 0, 0)),            # SLO pressure: shed
    ("retry", ()), ("retry", ()), ("retry", ()), ("retry", ()),
    ("record", ("posv", "retry", False, 7)),
    ("allow", ("posv", "retry", 7)),
    ("record", ("posv", "retry", False, 8)),   # opens
    ("allow", ("posv", "retry", 9)),
    ("tick", (0.5,)), ("allow", ("posv", "retry", 10)),
    ("tick", (0.6,)), ("allow", ("posv", "retry", 11)),   # half-open
    ("allow", ("posv", "retry", 12)),                      # probe busy
    ("record", ("posv", "retry", False, 11)),              # re-opens
    ("tick", (1.5,)), ("allow", ("posv", "retry", 13)),
    ("record", ("posv", "retry", True, 13)),               # closes
    ("allow", ("posv", "retry", 14)),
    ("record", ("gesv", "algo_fallback", True, 15)),
    ("state", ("posv", "retry")), ("state", ("gesv", "x")),
]


def _run(ctl, hist, clock):
    out = []
    for act, args in SCRIPT:
        if act == "decide":
            out.append(ctl.decide(*args))
        elif act == "observe":
            hist.observe(args[0])
            ctl.observe(args[0], hist)
            out.append(ctl.ewma_p99_ms())
        elif act == "retry":
            out.append(ctl.take_retry())
        elif act == "record":
            op, rung, ok, rid = args
            out.append(ctl.breaker_record(op, rung, ok, request=rid))
        elif act == "allow":
            op, rung, rid = args
            out.append(ctl.breaker_allow(op, rung, request=rid))
        elif act == "state":
            out.append(ctl.breaker_state(*args))
        else:
            clock.t += args[0]
    return out


def test_scripted_stream_decides_like_the_reference(clock):
    kw = dict(max_queue=4, max_inflight=2, slo_p99_ms=20.0,
              breaker_failures=2, breaker_cooldown_s=1.0, retry_budget=3)
    (p, ph), (r, rh) = _pair(**kw)
    t0 = clock.t
    got = _run(p, ph, clock)
    clock.t = t0
    want = _run(r, rh, clock)
    assert got == want
    assert ("degrade", got[16][1]) == got[16] and got[17][0] == "shed"
    assert p.summary() == r.summary()
    assert _events(p) == _events(r)
    kinds = [e["kind"] for e in _events(p)]
    assert {"breaker_open", "breaker_half_open", "breaker_close"} <= \
        set(kinds)


@pytest.mark.parametrize("knobs", [
    {}, {"serving.admission": "off"}, {"serving.max_queue": "0",
                                       "serving.degrade": "off",
                                       "serving.slo_p99_ms": "1"},
    {"serving.retry_budget": "1", "serving.breaker_failures": "1",
     "serving.breaker_cooldown_s": "0"}])
def test_mca_knobs_resolve_like_the_reference(clock, knobs):
    with cfg.override_scope(knobs), ref_cfg.override_scope(knobs):
        (p, ph), (r, rh) = _pair()
        for k in ("enabled", "max_queue", "max_inflight", "slo_p99_ms",
                  "slo_alpha", "degrade_enabled", "breaker_failures",
                  "breaker_cooldown_s", "retry_budget"):
            assert getattr(p, k) == getattr(r, k), k
        t0 = clock.t
        got = _run(p, ph, clock)
        clock.t = t0
        assert got == _run(r, rh, clock)
        assert p.summary() == r.summary()


@pytest.mark.parametrize("prec", ["int8", "bf16", "f32", "f32x2"])
def test_degraded_precision_and_deadlines(clock, prec):
    with cfg.override_scope({"ir.precision": prec}), \
            ref_cfg.override_scope({"ir.precision": prec}):
        assert admission.degraded_precision() == \
            ref_adm.degraded_precision()
    for d, pin in ((None, {}), (0.5, {}), (None, {
            "serving.default_deadline_s": "2"}), (-1.0, {}), (0.0, {
                "serving.default_deadline_s": "3"})):
        with cfg.override_scope(pin), ref_cfg.override_scope(pin):
            assert admission.resolve_deadline(d) == \
                ref_adm.resolve_deadline(d)
            assert admission.resolve_deadline(d, now=5.0) == \
                ref_adm.resolve_deadline(d, now=5.0)


def test_errors_carry_the_request_id():
    e = admission.AdmissionError("shed", request_id=7, reason="queue")
    assert (e.request_id, e.reason, str(e)) == (7, "queue", "shed")
    assert admission.DeadlineExceeded("late", request_id=3).request_id == 3
    t = admission.ServingTimeout("stuck", request_id=4)
    assert isinstance(t, TimeoutError) and t.request_id == 4
    for name in ("ADMIT", "SHED", "DEGRADE", "CLOSED", "OPEN", "HALF_OPEN",
                 "_EWMA_SAMPLE_EVERY"):
        assert getattr(admission, name) == getattr(ref_adm, name)
