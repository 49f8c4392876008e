"""Live telemetry: streaming metrics export and the flight recorder
(``dplasma_tpu/observability/telemetry.py``, plain Python).

The run-report, the profile and the phase ledger are written after the
timed loop. A long-running process needs instruments that stream while
it runs and carry their own evidence when something breaks:

* :func:`prometheus_text` — a Prometheus text-exposition snapshot of a
  :class:`~dplasma_tpu_torch.observability.metrics.MetricsRegistry`
  (counters/gauges verbatim; histograms as summaries with
  count/sum/min/max and interpolated p50/p90/p99 quantiles);
  :func:`parse_prometheus_text` is its strict reader.
* :class:`MetricsExporter` — a daemon thread that atomically rewrites
  the snapshot file every MCA ``telemetry.interval_s`` seconds
  (``telemetry.export_path`` names the file), deriving per-op request
  *rates* from counter deltas between flushes.
* :class:`FlightRecorder` — a bounded ring of structured events (MCA
  ``telemetry.flight_events``), cheap enough to leave on; it rides the
  run-report (schema v13 ``"telemetry"`` section) and, when MCA
  ``telemetry.flight_path`` is set, is dumped to disk on an incident.

:class:`Telemetry` bundles a
:class:`~dplasma_tpu_torch.observability.tracing.Tracer`, a recorder
and an optional exporter: the one object the drivers' ``--telemetry``
flag holds. The exporter thread and the recorder read and write host
objects only; neither touches CUDA.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from dplasma_tpu_torch.observability.metrics import (Histogram,
                                                     MetricsRegistry)
from dplasma_tpu_torch.observability.tracing import Tracer
from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "telemetry.export_path", "",
    "Prometheus text-snapshot file the streaming metrics exporter "
    "rewrites periodically (empty = exporter inert unless a path is "
    "passed explicitly; the driver --telemetry flag supplies one).")
_cfg.mca_register(
    "telemetry.interval_s", "10",
    "Flush period (seconds) of the streaming metrics exporter.")
_cfg.mca_register(
    "telemetry.flight_events", "256",
    "Ring-buffer bound of the flight recorder (oldest structured "
    "events dropped past this; the drop count is reported).")
_cfg.mca_register(
    "telemetry.flight_path", "",
    "File the serving layer dumps the flight recorder to when a "
    "request fails its gate or walks the remediation ladder (empty = "
    "in-memory only; the dump always also lands in the run-report's "
    "telemetry section).")

#: schema tag of the on-disk flight-recorder dump
FLIGHT_SCHEMA = 1


# ----------------------------------------------------- prometheus text

def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    kv = dict(labels)
    if extra:
        kv.update(extra)
    if not kv:
        return ""
    parts = []
    for k in sorted(kv):
        v = str(kv[k]).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry as Prometheus text exposition format.

    Counters and gauges export verbatim; a histogram family exports as
    a summary — ``<name>_count``/``<name>_sum``/``<name>_min``/
    ``<name>_max`` plus ``<name>{quantile="0.5|0.9|0.99"}`` from the
    bounded-bucket interpolation. Families are emitted in deterministic
    (name, labels) order with one ``# TYPE`` line each.
    """
    by_family: Dict[str, List[dict]] = {}
    kinds: Dict[str, str] = {}
    for entry in registry.snapshot():
        by_family.setdefault(entry["name"], []).append(entry)
        kinds[entry["name"]] = entry["type"]
    lines = []
    for name in sorted(by_family):
        kind = kinds[name]
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "summary"}[kind]
        lines.append(f"# TYPE {name} {ptype}")
        for entry in by_family[name]:
            labels = entry["labels"]
            if kind != "histogram":
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_value(entry['value'])}")
                continue
            inst = registry.get(name, **labels)
            for q in ("0.5", "0.9", "0.99"):
                v = inst.percentile(float(q) * 100.0) \
                    if isinstance(inst, Histogram) else None
                lines.append(
                    f"{name}{_fmt_labels(labels, {'quantile': q})} "
                    f"{_fmt_value(v)}")
            lines.append(f"{name}_count{_fmt_labels(labels)} "
                         f"{_fmt_value(entry['count'])}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} "
                         f"{_fmt_value(entry['sum'])}")
            lines.append(f"{name}_min{_fmt_labels(labels)} "
                         f"{_fmt_value(entry['min'])}")
            lines.append(f"{name}_max{_fmt_labels(labels)} "
                         f"{_fmt_value(entry['max'])}")
    return "\n".join(lines) + "\n"


def _parse_labels(line: str, brace: int, lineno: int):
    """Quote-aware scan of one sample's ``{...}`` label body starting
    at ``brace``: returns (labels, index past the closing brace).
    Values are UNESCAPED (the inverse of :func:`_fmt_labels`) and a
    ``,``/``}``/escaped quote inside a quoted value never splits or
    truncates the scan — the parser must read anything its paired
    writer emits."""
    labels: Dict[str, str] = {}
    i = brace + 1
    n = len(line)
    while True:
        while i < n and line[i] in ", ":
            i += 1
        if i < n and line[i] == "}":
            return labels, i + 1
        eq = line.find("=", i)
        if eq < 0 or i >= n:
            raise ValueError(f"line {lineno}: unbalanced braces")
        key = line[i:eq].strip()
        if not key or eq + 1 >= n or line[eq + 1] != '"':
            raise ValueError(
                f"line {lineno}: malformed label {line[i:eq + 2]!r}")
        j = eq + 2
        out = []
        while j < n and line[j] != '"':
            c = line[j]
            if c == "\\" and j + 1 < n:
                nxt = line[j + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(
                    nxt, "\\" + nxt))
                j += 2
            else:
                out.append(c)
                j += 1
        if j >= n:
            raise ValueError(f"line {lineno}: unterminated label "
                             f"value for {key!r}")
        labels[key] = "".join(out)
        i = j + 1


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Strict reader for the exposition format this module writes:
    returns ``{family: {"type": t, "samples": [(name, labels, value)]}}``
    and raises ``ValueError`` on any malformed line — the proof that
    the exporter file actually parses. Label values
    round-trip exactly (commas/braces/quotes inside values included —
    the inverse of the writer's escaping)."""
    families: Dict[str, dict] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) == 4 and parts[1] == "TYPE":
                families[parts[2]] = {"type": parts[3], "samples": []}
                continue
            if parts[0] == "#" and len(parts) >= 2 \
                    and parts[1] in ("HELP", "TYPE"):
                continue
            raise ValueError(f"line {lineno}: malformed comment {raw!r}")
        name, labels, rest = line, {}, ""
        brace = line.find("{")
        if brace >= 0:
            name = line[:brace]
            labels, end = _parse_labels(line, brace, lineno)
            rest = line[end:].strip()
        else:
            name, _, rest = line.partition(" ")
        if not name or not rest:
            raise ValueError(f"line {lineno}: malformed sample {raw!r}")
        try:
            value = float(rest.split()[0])
        except ValueError:
            raise ValueError(
                f"line {lineno}: non-numeric value {rest!r}")
        base = name
        for suffix in ("_count", "_sum", "_min", "_max"):
            if name.endswith(suffix) and name[:-len(suffix)] in families:
                base = name[:-len(suffix)]
                break
        fam = families.get(base)
        if fam is None:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no # TYPE family")
        fam["samples"].append((name, labels, value))
    return families


# ------------------------------------------------------------ exporter

class MetricsExporter:
    """Periodic Prometheus-snapshot writer (daemon thread).

    Each flush atomically rewrites ``path`` (write + rename) and
    derives per-op request *rate* gauges (``serving_request_rate``,
    requests/s since the previous flush) from the
    ``serving_requests_total`` counters, so a scraper sees live rates
    without the request path ever paying for them."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: Optional[float] = None):
        self.registry = registry
        self.path = str(path)
        self.interval_s = max(
            float(interval_s) if interval_s is not None
            else _cfg.mca_get_float("telemetry.interval_s", 10.0),
            0.05)
        self.flushes = 0
        self._prev_counts: Dict[tuple, float] = {}
        self._prev_t: Optional[float] = None
        # flush() runs on the daemon flusher AND on whatever thread
        # calls start()/stop()/flush() directly (a bench, a
        # test): the rate memo is a check-then-act and the tmp-file
        # write+rename is not idempotent, so flushes serialize
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # rate derivation: counter deltas between flushes
    def _update_rates(self) -> None:
        now = time.perf_counter()
        dt = (now - self._prev_t) if self._prev_t is not None else None
        for entry in self.registry.snapshot():
            if entry["name"] != "serving_requests_total":
                continue
            key = tuple(sorted(entry["labels"].items()))
            cur = float(entry["value"])
            prev = self._prev_counts.get(key)
            if dt and prev is not None and dt > 0:
                self.registry.gauge(
                    "serving_request_rate",
                    **entry["labels"]).set((cur - prev) / dt)
            self._prev_counts[key] = cur
        self._prev_t = now

    def flush(self) -> None:
        """One atomic snapshot write (failures land on stderr — the
        exporter must never take down the process it observes).
        Serialized: the daemon flusher and a direct caller racing
        here would interleave the rate memo's check-then-act and
        collide on the tmp file."""
        with self._lock:
            self._update_rates()
            try:
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(prometheus_text(self.registry))
                os.replace(tmp, self.path)
                self.flushes += 1
            except OSError as exc:
                sys.stderr.write(f"#! telemetry exporter: cannot "
                                 f"write {self.path}: {exc}\n")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()

    def start(self) -> "MetricsExporter":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()  # restartable after stop()
            self._thread = threading.Thread(
                target=self._loop, name="dplasma-telemetry-exporter",
                daemon=True)
            self._thread.start()
        self.flush()            # the file exists from second zero
        return self

    def stop(self) -> None:
        """Stop the flusher and write one final snapshot."""
        self._stop.set()
        with self._lock:        # never join under _lock: flush() takes it
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self.flush()

    def summary(self) -> dict:
        return {"path": self.path, "interval_s": self.interval_s,
                "flushes": self.flushes}


# ----------------------------------------------------- flight recorder

class FlightRecorder:
    """Bounded ring of structured events — the always-on black box.

    ``record(kind, **fields)`` is one lock + one deque append; the ring
    (MCA ``telemetry.flight_events``) bounds memory under sustained
    traffic, and the drop count is part of the dump so truncation is
    visible, never silent. Events carry a process-monotone ``seq`` and
    a wall-clock ``t_ns``."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None \
            else _cfg.mca_get_int("telemetry.flight_events", 256)
        self.capacity = max(int(cap), 1)
        self._d: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields) -> dict:
        ev = {"seq": 0, "t_ns": time.time_ns(), "kind": str(kind)}
        ev.update(fields)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._d.append(ev)
        return ev

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._seq = 0

    def counts(self) -> Dict[str, int]:
        """Per-kind event counts of what the ring still HOLDS (dropped
        events are not re-counted); ``summary()['dropped']`` bounds what
        the ring lost."""
        with self._lock:
            out: Dict[str, int] = {}
            for ev in self._d:
                out[ev["kind"]] = out.get(ev["kind"], 0) + 1
            return out

    def summary(self) -> dict:
        """The flight-recorder half of the schema-v13 ``"telemetry"``
        section (events included — the dump IS the evidence)."""
        with self._lock:
            evs = list(self._d)
            return {"capacity": self.capacity, "recorded": self._seq,
                    "dropped": self._seq - len(evs), "events": evs}

    def dump(self, path: str) -> Optional[str]:
        """Write the ring to ``path`` (atomic rename); returns the
        path, or None when the write failed (logged, never raised —
        incident evidence must not add an incident)."""
        doc = {"dplasma_flight_recorder": FLIGHT_SCHEMA,
               "dumped_t_ns": time.time_ns()}
        doc.update(self.summary())
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except OSError as exc:
            sys.stderr.write(f"#! flight recorder: cannot dump to "
                             f"{path}: {exc}\n")
            return None


# -------------------------------------------------------------- facade

class Telemetry:
    """One handle bundling the live instruments: a tracer, a flight
    recorder, and (once started) a metrics exporter. The driver
    ``--telemetry`` flag creates one per run (the reference's serving
    layer one per service)."""

    def __init__(self, rank: int = 0, trace: bool = True):
        self.tracer = Tracer(enabled=trace, rank=rank)
        self.flight = FlightRecorder()
        self.exporter: Optional[MetricsExporter] = None

    def start_exporter(self, registry: MetricsRegistry,
                       path: Optional[str] = None,
                       interval_s: Optional[float] = None
                       ) -> Optional[MetricsExporter]:
        """Start the periodic Prometheus flusher (``path`` falls back
        to MCA ``telemetry.export_path``; empty = stay inert)."""
        path = path or _cfg.mca_get("telemetry.export_path", "")
        if not path:
            return None
        if self.exporter is None:
            self.exporter = MetricsExporter(registry, path,
                                            interval_s).start()
        return self.exporter

    def flight_dump_path(self) -> str:
        """The configured on-incident dump file (MCA
        ``telemetry.flight_path``; empty = in-memory only)."""
        return _cfg.mca_get("telemetry.flight_path", "") or ""

    def clear(self) -> None:
        """Reset spans + flight events (benches drop warmup noise)."""
        self.tracer.clear()
        self.flight.clear()

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.stop()

    def summary(self) -> dict:
        """The run-report schema-v13 ``"telemetry"`` section."""
        return {"spans": self.tracer.summary(),
                "exporter": (self.exporter.summary()
                             if self.exporter is not None else None),
                "flight_recorder": self.flight.summary()}
