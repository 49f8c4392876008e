#!/usr/bin/env python
"""tracecat: DTPUPROF1 binary trace -> Chrome trace-event JSON.

The port's copy of the reference's ``tools/tracecat.py``, over the
port's :mod:`~dplasma_tpu_torch.observability.chrome`,
:mod:`~dplasma_tpu_torch.utils.profiling` and
:mod:`~dplasma_tpu_torch.native` (the same DTPUPROF1 format and the same
JSON out): a driver run with ``--profile=run.prof`` writes the binary
trace; this converts it to the Chrome trace-event schema for Perfetto /
chrome://tracing::

    python dplasma_tpu_torch/tools/tracecat.py run.prof -o run.trace.json
    python -m dplasma_tpu_torch.tools.tracecat run.prof      # stdout
    python -m dplasma_tpu_torch.tools.tracecat --info run.prof

Truncated traces (a run killed mid-write) convert with ``--lax``.

**Merge mode** fuses several sources into ONE multi-lane timeline —
the multichip picture (one pid lane per rank, the ``ring``/``panel``
phases visible per chip) plus the serving layer's request spans and a
phase ledger, on one rebased, time-monotone axis::

    python -m dplasma_tpu_torch.tools.tracecat --merge r0.prof r1.prof \\
        --serving spans.json --phases report.json -o merged.json

``--serving`` takes a span document
(:meth:`dplasma_tpu_torch.observability.tracing.Tracer.save`, the
reference's ``tools/servebench.py --spans``); ``--phases`` takes either a
run-report with per-op ``"phases"`` sections or a raw
``PhaseLedger.summary()`` row list (durations only — its lane is a
synthetic end-to-end layout, labelled as such); ``--flight`` takes a
flight-recorder dump (MCA ``telemetry.flight_path`` / a run-report's
``"telemetry"]["flight"]`` doc written to a file) and renders each
event as a Perfetto INSTANT pin at its real timestamp; ``--devprof``
takes a run-report with ``"devprof"`` sections (schema v14, any
driver's ``--devprof``) and lays the attributed category seconds and
measured per-collective seconds out as synthetic lanes. All four
flags repeat. ``--lax`` applies to every ``.prof`` input.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def convert(path: str, strict: bool = True) -> dict:
    from dplasma_tpu_torch import native
    from dplasma_tpu_torch.observability.chrome import profile_to_chrome
    from dplasma_tpu_torch.utils.profiling import decode_wire_events
    raw, info = native.read_trace(path, strict=strict)
    return profile_to_chrome(decode_wire_events(raw), info,
                             name=os.path.basename(path))


def _load_phase_tables(path: str) -> list:
    """Phase rows from one ``--phases`` input: a run-report (each op's
    ``"phases"]["spans"]`` becomes one labelled table), a raw row
    list, or ``{"phases": [rows]}``."""
    with open(path) as f:
        doc = json.load(f)
    base = os.path.basename(path)
    if isinstance(doc, list):
        return [(base, doc)]
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a phase ledger or run-report")
    if isinstance(doc.get("phases"), list):
        return [(base, doc["phases"])]
    tables = []
    for op in doc.get("ops") or []:
        ph = (op or {}).get("phases")
        if isinstance(ph, dict) and isinstance(ph.get("spans"), list):
            tables.append((f"{base}:{op.get('label', '?')}",
                           ph["spans"]))
    if not tables:
        raise ValueError(f"{path}: no phase rows found (want a "
                         f"run-report with \"phases\" sections or a "
                         f"PhaseLedger.summary() row list)")
    return tables


def _load_span_doc(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "spans" not in doc:
        raise ValueError(f"{path}: not a serving span document "
                         f"(want Tracer.save output)")
    return doc


def _load_flight_doc(path: str) -> dict:
    """One ``--flight`` input: a flight-recorder dump (the
    ``dplasma_flight_recorder`` doc :meth:`FlightRecorder.dump`
    writes on an incident), or a run-report whose ``"telemetry"``
    section embeds the same ring as ``flight_recorder``."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "dplasma_flight_recorder" not in doc:
        # accept a whole run-report: pull its embedded event ring
        tl = doc.get("telemetry")
        fl = tl.get("flight_recorder") if isinstance(tl, dict) else None
        if isinstance(fl, dict) and isinstance(fl.get("events"), list):
            return {"dplasma_flight_recorder": 1, **fl}
    if not isinstance(doc, dict) \
            or "dplasma_flight_recorder" not in doc:
        raise ValueError(f"{path}: not a flight-recorder dump (want "
                         f"a dplasma_flight_recorder doc or a "
                         f"run-report with a telemetry."
                         f"flight_recorder section)")
    return doc


def _load_devprof_tables(path: str) -> list:
    """``--devprof`` rows from one run-report: each ``"devprof"``
    entry (schema v14) becomes one labelled synthetic lane."""
    with open(path) as f:
        doc = json.load(f)
    base = os.path.basename(path)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a run-report")
    tables = []
    for e in doc.get("devprof") or []:
        if isinstance(e, dict) and isinstance(e.get("categories"),
                                              dict):
            tables.append((f"{base}:{e.get('label') or e.get('op') or '?'}",
                           e))
    if not tables:
        raise ValueError(f"{path}: no devprof entries found (want a "
                         f"run-report written with --devprof, "
                         f"schema v14)")
    return tables


def merge(trace_paths, serving=(), phases=(), flight=(), devprof=(),
          strict: bool = True, name: str = "merged") -> dict:
    """Fuse rank traces + serving spans + phase ledgers + flight
    events + devprof attributions into one Chrome trace-event
    document (observability.chrome.merge_to_chrome does the
    lane/timebase work)."""
    from dplasma_tpu_torch import native
    from dplasma_tpu_torch.observability.chrome import merge_to_chrome
    from dplasma_tpu_torch.utils.profiling import decode_wire_events
    profiles = []
    for p in trace_paths:
        raw, info = native.read_trace(p, strict=strict)
        info = dict(info)
        info.setdefault("source", os.path.basename(p))
        profiles.append((decode_wire_events(raw), info))
    span_docs = [_load_span_doc(p) for p in serving]
    tables = []
    for p in phases:
        tables.extend(_load_phase_tables(p))
    flight_docs = [_load_flight_doc(p) for p in flight]
    dtables = []
    for p in devprof:
        dtables.extend(_load_devprof_tables(p))
    return merge_to_chrome(profiles, span_docs, tables,
                           flight_docs=flight_docs,
                           devprof_tables=dtables, name=name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracecat", description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="+",
                    help="DTPUPROF1 file(s) (driver --profile=); "
                         "several only with --merge")
    ap.add_argument("-o", "--output", default=None,
                    help="output JSON path (default: stdout)")
    ap.add_argument("--lax", action="store_true",
                    help="tolerate a truncated final record")
    ap.add_argument("--info", action="store_true",
                    help="print the metadata kv pairs only")
    ap.add_argument("--merge", action="store_true",
                    help="fuse every input (rank traces + --serving "
                         "spans + --phases ledgers) into one "
                         "multi-lane timeline")
    ap.add_argument("--serving", action="append", default=[],
                    metavar="SPANS_JSON",
                    help="serving span document to merge "
                         "(Tracer.save / servebench --spans); "
                         "repeatable, requires --merge")
    ap.add_argument("--phases", action="append", default=[],
                    metavar="LEDGER_JSON",
                    help="phase ledger (run-report with \"phases\" "
                         "or raw summary rows) to merge as a "
                         "synthetic lane; repeatable, requires "
                         "--merge")
    ap.add_argument("--flight", action="append", default=[],
                    metavar="FLIGHT_JSON",
                    help="flight-recorder dump (or run-report with a "
                         "telemetry.flight section) to merge as an "
                         "instant-event pin lane; repeatable, "
                         "requires --merge")
    ap.add_argument("--devprof", action="append", default=[],
                    metavar="REPORT_JSON",
                    help="run-report with \"devprof\" sections "
                         "(schema v14) to merge as attributed "
                         "category/collective lanes; repeatable, "
                         "requires --merge")
    ns = ap.parse_args(argv)
    if not ns.merge and (len(ns.trace) > 1 or ns.serving or ns.phases
                         or ns.flight or ns.devprof):
        sys.stderr.write("tracecat: multiple traces / --serving / "
                         "--phases / --flight / --devprof require "
                         "--merge\n")
        return 2
    try:
        if ns.merge:
            doc = merge(ns.trace, serving=ns.serving,
                        phases=ns.phases, flight=ns.flight,
                        devprof=ns.devprof, strict=not ns.lax)
        else:
            doc = convert(ns.trace[0], strict=not ns.lax)
    except (OSError, ValueError, EOFError) as exc:
        sys.stderr.write(f"tracecat: {exc}\n")
        return 1
    if ns.info:
        out = json.dumps(doc["otherData"], indent=1, sort_keys=True)
    else:
        out = json.dumps(doc)
    if ns.output:
        with open(ns.output, "w") as f:
            f.write(out + "\n")
    else:
        sys.stdout.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
