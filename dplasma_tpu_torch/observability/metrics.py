"""Labelled metrics registry: counters, gauges, histograms
(``dplasma_tpu/observability/metrics.py``, unchanged in behaviour).

The driver harness populates one registry per run (ENQ/warmup/run/DEST
timings, flop counts, comm-volume figures — each labelled with the
``[SDCZ]`` op name), and its :meth:`MetricsRegistry.snapshot` embeds in
the versioned JSON run-report. The design follows the usual
client-library shape (a metric family keyed by name, instruments keyed
by label values) with none of the server machinery: everything is
in-process and serializes to plain JSON.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter. ``inc`` by non-negative amounts only.

    Locked: ``value += amount`` is a read-modify-write, and two
    unlocked threads interleaving it lose increments. Reading
    ``value`` stays lock-free: a single float load is GIL-atomic.
    """

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Gauge:
    """Point-in-time value; ``set`` wins, ``add`` adjusts. Locked for
    the same reason as :class:`Counter` (``add`` is a
    read-modify-write); single reads of ``value`` stay lock-free."""

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Bounded observation accumulator; exports
    count/sum/min/max/mean/median/stddev.

    Memory is O(buckets), not O(observations): each observe lands in a
    log-spaced bucket (``_BASE``-wide rungs of ``|value|``, a zero
    bucket, mirrored rungs for negatives) alongside exact running
    moments (count/sum/sum-of-squares/min/max). Small sample sets —
    driver runs, panels — additionally keep the raw values up to
    ``_EXACT_CAP``, so their ``stats()`` (the run-report timing path,
    :func:`dplasma_tpu_torch.observability.report.run_stats`) stay
    bit-identical to the historical exact implementation; once the cap
    spills (sustained serving traffic) the raw list is dropped and
    percentiles come from bucket interpolation, bounded by the bucket
    width (~±4.5% with the default base). ``stats()``'s key set is
    unchanged either way.

    Thread-safe: the spill transition (raw list dropped at the cap) is
    a check-then-act that would crash unlocked. One RLock guards every
    accessor (re-entrant: the spilled ``stats`` calls ``percentile``).
    """

    #: log-spaced bucket ratio: adjacent rungs differ by 2^(1/8) ≈
    #: 1.09, so an interpolated percentile is within ~4.5% of exact
    _BASE = 2.0 ** 0.125
    _LOG_BASE = math.log(_BASE)
    #: raw samples kept below this count (exact percentiles for the
    #: small sets the run-report records); beyond it the raw list is
    #: dropped and memory stays O(buckets)
    _EXACT_CAP = 512

    def __init__(self, exact_cap: Optional[int] = None):
        """``exact_cap`` overrides the raw-sample retention bound for
        callers that KNOW their sample count and need exact
        percentiles regardless of size (``report.run_stats`` passes
        the run count — a 513-run report's median must not silently
        become an interpolation); default: ``_EXACT_CAP``."""
        self._lock = threading.RLock()
        self._cap = self._EXACT_CAP if exact_cap is None \
            else max(int(exact_cap), 0)
        self._zero()

    def _zero(self) -> None:
        self._count = 0
        self._sum = 0.0
        self._sumsq = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        #: bucket index -> count; index 0 is the zero bucket, +k/-k
        #: the k-th positive/negative log rung (see _bucket_of)
        self._buckets: Dict[int, int] = {}
        self._exact: Optional[List[float]] = []

    def reset(self) -> None:
        """Zero every accumulator (benches drop warmup observations)."""
        with self._lock:
            self._zero()

    #: rung-index offset keeping every finite double's rung strictly
    #: positive (|log(v)/log(BASE)| <= 8*1075 for doubles), so the
    #: sign of the bucket index can carry the sign of the value
    _OFFSET = 16384

    @classmethod
    def _bucket_of(cls, v: float) -> int:
        if v == 0.0 or not math.isfinite(v):
            return 0
        k = int(round(math.log(abs(v)) / cls._LOG_BASE))
        idx = k + cls._OFFSET
        return idx if v > 0 else -idx

    @classmethod
    def _bucket_value(cls, idx: int) -> float:
        if idx == 0:
            return 0.0
        try:
            mag = cls._BASE ** (abs(idx) - cls._OFFSET)
        except OverflowError:
            mag = math.inf
        return math.copysign(mag, idx)

    def observe(self, value: float) -> None:
        v = float(value)
        idx = self._bucket_of(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._sumsq += v * v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            if self._exact is not None:
                self._exact.append(v)
                if len(self._exact) > self._cap:
                    self._exact = None  # spilled: buckets take over

    def bucket_count(self) -> int:
        """Distinct buckets in use (the memory bound under sustained
        traffic — tested to stay O(buckets) at a million observes)."""
        with self._lock:
            return len(self._buckets)

    def percentile(self, p: float) -> Optional[float]:
        """The p-th percentile (0-100): exact while the raw sample set
        is retained, bucket-interpolated after it spills."""
        with self._lock:
            return self._percentile(p)

    def _percentile(self, p: float) -> Optional[float]:
        if self._count == 0:
            return None
        if p <= 0.0:
            return self._min
        if p >= 100.0:
            return self._max
        if self._exact is not None:
            ordered = sorted(self._exact)
            rank = p / 100.0 * (len(ordered) - 1)
            lo = int(math.floor(rank))
            hi = min(lo + 1, len(ordered) - 1)
            frac = rank - lo
            return ordered[lo] * (1.0 - frac) + ordered[hi] * frac
        target = p / 100.0 * (self._count - 1)
        seen = 0
        for idx in sorted(self._buckets,
                          key=lambda i: self._bucket_value(i)):
            n = self._buckets[idx]
            if seen + n > target:
                # linear interpolation across the bucket's width,
                # clamped to the observed extremes (keeps the edges
                # finite even for rungs near the double range limit)
                bv = self._bucket_value(idx)
                half = math.sqrt(self._BASE)
                lo, hi = (bv / half, bv * half) if idx else (0.0, 0.0)
                if lo > hi:
                    lo, hi = hi, lo
                lo = min(max(lo, self._min), self._max)
                hi = min(max(hi, self._min), self._max)
                frac = (target - seen) / n
                return lo + (hi - lo) * frac
            seen += n
        return self._max

    def stats(self) -> dict:
        with self._lock:
            return self._stats()

    def _stats(self) -> dict:
        if self._count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "mean": None, "median": None, "stddev": None}
        if self._exact is not None:
            # the historical exact path, bit-for-bit: run-report
            # timings (nruns-sized sets) must not drift by a ULP
            s = self._exact
            n = len(s)
            mean = sum(s) / n
            var = sum((x - mean) ** 2 for x in s) / n
            ordered = sorted(s)
            mid = n // 2
            median = ordered[mid] if n % 2 else \
                0.5 * (ordered[mid - 1] + ordered[mid])
            return {"count": n, "sum": sum(s), "min": ordered[0],
                    "max": ordered[-1], "mean": mean, "median": median,
                    "stddev": math.sqrt(var)}
        n = self._count
        mean = self._sum / n
        var = max(self._sumsq / n - mean * mean, 0.0)
        return {"count": n, "sum": self._sum, "min": self._min,
                "max": self._max, "mean": mean,
                "median": self._percentile(50.0),
                "stddev": math.sqrt(var)}


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Families of labelled instruments; snapshot() -> JSON-able list.

    Usage::

        reg = MetricsRegistry()
        reg.counter("runs_total", op="dpotrf").inc()
        reg.gauge("gflops", op="dpotrf").set(812.0)
        reg.histogram("run_seconds", op="dpotrf").observe(0.031)
        reg.snapshot()
    """

    def __init__(self):
        self._families: Dict[str, str] = {}          # name -> type
        self._metrics: Dict[Tuple[str, tuple], object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: dict):
        with self._lock:
            seen = self._families.get(name)
            if seen is None:
                self._families[name] = kind
            elif seen != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {seen}")
            key = (name, _label_key(labels))
            m = self._metrics.get(key)
            if m is None:
                m = _TYPES[kind]()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def get(self, name: str, **labels) -> Optional[object]:
        """Lookup without creating; None when absent."""
        with self._lock:
            return self._metrics.get((name, _label_key(labels)))

    def snapshot(self) -> List[dict]:
        """All instruments as JSON-able dicts, deterministically
        ordered by (family name, sorted label pairs) — never by
        insertion order — and with fixed key order inside each entry,
        so two runs recording the same figures produce byte-identical
        metric sections (``tools/perfdiff.py`` and the run-report
        diffing depend on this)."""
        out = []
        with self._lock:
            items = sorted(self._metrics.items(),
                           key=lambda kv: (kv[0][0], kv[0][1]))
            for (name, lk), m in items:
                kind = self._families[name]
                entry = {"name": name, "type": kind, "labels": dict(lk)}
                if kind == "histogram":
                    entry.update(m.stats())
                else:
                    entry["value"] = m.value
                out.append(entry)
        return out
