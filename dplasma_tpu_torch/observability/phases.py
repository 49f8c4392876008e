"""Scoped phase timers for performance attribution (``--phase-profile``);
ports ``dplasma_tpu/observability/phases.py``.

The sweeps, the IR solvers and the cyclic factorizations wrap their
regions in :func:`span` — ``panel``, ``lookahead``, ``far_flush``,
``catchup``, ``assemble``; ``factor``, ``solve``, ``residual``,
``correct``, ``escalate``; ``quantize``, ``dequantize``; ``ring`` —
with the reference's names at the same places in the control flow. A
driver run with ``--phase-profile`` activates a :class:`PhaseLedger`
around one extra attributed pass after its timed loop and lands the
per-phase times beside the roofline expectations
(:mod:`dplasma_tpu_torch.observability.roofline`) in the run-report.

Fencing contract: a span measures truthfully only if the device work
it issued has retired, so the values the region hands to the span's
sink are fenced at span exit — but ONLY while a ledger is active. On
the card the fence is one ``torch.cuda.synchronize(device)``: it waits
for every stream of the device, so the lowmem tiers' write-back
stream has retired too. On the CPU it does nothing (the work has run).
With no ledger active :func:`span` yields a no-op sink and neither
fences nor times anything, so the default path and the drivers' timed
loop keep their launches and their overlap.

Usage (instrumented code)::

    with phases.span("panel") as fence:
        pack, state = panel(col)
        fence((pack, state))      # fenced at exit iff profiling is on

Usage (harness)::

    with phases.profiling() as ledger:
        out = fn(*args)
    ledger.summary()   # [{"phase", "count", "measured_s", "total_s"}, ...]
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class PhaseLedger:
    """Per-phase accumulator: span count + wall seconds."""

    def __init__(self):
        self.phases: Dict[str, dict] = {}

    def add(self, name: str, seconds: float,
            total: Optional[float] = None) -> None:
        """Record one span: ``seconds`` is SELF time (disjoint across
        the ledger — these sum to at most the attributed run);
        ``total`` is the inclusive elapsed time (self + enclosed child
        spans, ``seconds`` for a leaf span) — what a rate computed from
        an ENCLOSING span (the IR solvers' ``factor``) divides by."""
        e = self.phases.setdefault(
            name, {"count": 0, "seconds": 0.0, "total": 0.0})
        e["count"] += 1
        e["seconds"] += float(seconds)
        e["total"] += float(seconds if total is None else total)

    def total(self) -> float:
        return sum(e["seconds"] for e in self.phases.values())

    def summary(self) -> List[dict]:
        """Phases as JSON-able rows, heaviest first (ties by name).
        ``measured_s`` is self time; ``total_s`` the inclusive elapsed
        (== measured_s for leaf spans)."""
        return [{"phase": name, "count": e["count"],
                 "measured_s": e["seconds"], "total_s": e["total"]}
                for name, e in sorted(self.phases.items(),
                                      key=lambda kv:
                                      (-kv[1]["seconds"], kv[0]))]


#: the active ledger; None = profiling off (spans are no-ops)
_active: Optional[PhaseLedger] = None


def active() -> Optional[PhaseLedger]:
    return _active


def _cuda_device(values):
    """The device of the first CUDA tensor in ``values`` (nested lists,
    tuples and dicts of tensors), else None."""
    import torch
    stack = [values]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                return v.device
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return None


def _fence(values) -> None:
    """Wait until the device work behind ``values`` has retired: one
    ``torch.cuda.synchronize`` of the device of the first CUDA tensor
    in them (a device-wide wait: every stream), nothing for CPU
    tensors. The single choke point the no-fencing test patches."""
    dev = _cuda_device(values)
    if dev is not None:
        import torch
        torch.cuda.synchronize(dev)


class _Sink:
    """Span sink: values passed in are fenced at span exit."""

    __slots__ = ("values",)

    def __init__(self):
        self.values = []

    def __call__(self, x):
        self.values.append(x)
        return x


class _NoopSink:
    """Inactive-profiling sink: identity, retains nothing."""

    __slots__ = ()

    def __call__(self, x):
        return x


_NOOP = _NoopSink()

#: enclosing-span child-time stack: spans may NEST (the IR solvers'
#: ``factor`` wraps the inner factorization's sweep spans, the LU's
#: in-panel sweep nests in its ``panel``) — each span records its SELF
#: time (elapsed minus enclosed spans), so the ledger's phase seconds
#: stay disjoint and sum to at most the attributed run
_nest: List[float] = []


@contextlib.contextmanager
def span(name: str):
    """Time one phase region. Yields a sink; values the region passes
    to it are fenced at exit *only when profiling is active* —
    otherwise no fence and no timing. Nested spans attribute self time
    (child seconds are subtracted from the enclosing span)."""
    led = _active
    if led is None:
        yield _NOOP
        return
    sink = _Sink()
    _nest.append(0.0)
    t0 = time.perf_counter()
    try:
        yield sink
    finally:
        try:
            if sink.values:
                _fence(sink.values)
        finally:
            # balance _nest even when the fence raises: a leaked entry
            # would corrupt every later span's child-time subtraction
            elapsed = time.perf_counter() - t0
            child = _nest.pop()
            if _nest:
                _nest[-1] += elapsed
            led.add(name, max(elapsed - child, 0.0), total=elapsed)


@contextlib.contextmanager
def profiling(ledger: Optional[PhaseLedger] = None):
    """Activate a (fresh by default) ledger for the block; restores
    the previous one on exit, so nested scopes compose."""
    global _active
    prev = _active
    led = ledger if ledger is not None else PhaseLedger()
    _active = led
    try:
        yield led
    finally:
        _active = prev
