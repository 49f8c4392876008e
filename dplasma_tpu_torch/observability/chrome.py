"""DTPUPROF1 -> Chrome trace-event JSON (the profile-converter analogue;
``dplasma_tpu/observability/chrome.py``, plain JSON).

PaRSEC ships converters from its binary trace to visualizer formats;
the target here is the Chrome trace-event schema, which Perfetto
and ``chrome://tracing`` both load. Spans become complete ('X') events
on a (pid, tid) = (rank, track) grid; run metadata (the
``save_[di]info`` pairs) rides in ``otherData`` and per-event flops in
``args`` so Perfetto queries can compute achieved rates per span.

:func:`merge_to_chrome` is the multi-source fusion: per-rank DTPUPROF1 traces, serving span
documents (``observability.tracing.Tracer.to_doc()``, the reference's
format),
and phase-ledger tables land in ONE document with distinct
(pid, tid) = (rank, track) lanes, every timestamp rebased to the
earliest real event and the event stream sorted time-monotone — a
multichip run becomes one picture (each chip's ``ring``/``panel``/...
phases side by side with the serving request lanes).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def profile_to_chrome(events: Iterable[tuple], info: Dict[str, str],
                      name: str = "dplasma_tpu") -> dict:
    """Convert profile events + info to a Chrome trace-event document.

    ``events`` are ``(name, begin_ns, end_ns, flops[, track])`` tuples
    (4-tuples — raw :func:`dplasma_tpu_torch.native.read_trace` output — get
    track 0); ``info`` is the metadata kv dict. Timestamps are
    rebased to the earliest event and expressed in microseconds, as the
    schema requires. The rank (trace-event ``pid``) comes from
    ``info["rank"]`` when present.
    """
    evs = list(events)
    pid = 0
    try:
        pid = int(info.get("rank", 0))
    except (TypeError, ValueError):
        pid = 0
    t0 = min((e[1] for e in evs), default=0)
    trace = []
    tracks = set()
    for e in evs:
        ev, track = _profile_event(e, pid, t0)
        tracks.add(track)
        trace.append(ev)
    # metadata events name the process/threads for the viewer UI
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"{name} rank {pid}"}}]
    for tr in sorted(tracks):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tr, "args": {"name": f"track {tr}"}})
    return {"traceEvents": meta + trace,
            "displayTimeUnit": "ms",
            "otherData": dict(info)}


def _profile_event(e: tuple, pid: int, t0: int) -> Tuple[dict, int]:
    """One decoded DTPUPROF1 event (4/5-tuple) -> a complete ('X')
    event — the ONE conversion both the single-profile and the merge
    views share. Returns (event, track)."""
    nm, b, en, fl = e[0], e[1], e[2], e[3]
    track = int(e[4]) if len(e) > 4 else 0
    ev = {"name": nm, "cat": "span", "ph": "X",
          "ts": (b - t0) / 1e3, "dur": max(en - b, 0) / 1e3,
          "pid": pid, "tid": track}
    if fl:
        ev["args"] = {"flops": fl}
    return ev, track


def spans_to_chrome(spans: Iterable[dict], rank: int = 0,
                    name: str = "serving") -> dict:
    """Serving tracer spans -> a Chrome trace-event document (the
    single-source face of the serving lane; :func:`merge_to_chrome`
    embeds the same spans into a fused timeline)."""
    evs = list(spans)
    t0 = min((e["t0_ns"] for e in evs), default=0)
    trace = []
    tracks = set()
    for e in evs:
        tracks.add(int(e.get("track", 0)))
        trace.append(_span_event(e, int(e.get("rank", rank)), t0))
    meta = [{"name": "process_name", "ph": "M", "pid": rank,
             "args": {"name": f"{name} rank {rank}"}}]
    for tr in sorted(tracks):
        meta.append({"name": "thread_name", "ph": "M", "pid": rank,
                     "tid": tr, "args": {"name": f"serving lane {tr}"}})
    trace.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms",
            "otherData": {"source": name, "rank": str(rank)}}


def _span_event(span: dict, pid: int, t0: int) -> dict:
    """One serving tracer span -> one complete ('X') event."""
    ev = {"name": span["name"], "cat": "serving", "ph": "X",
          "ts": (span["t0_ns"] - t0) / 1e3,
          "dur": max(span["t1_ns"] - span["t0_ns"], 0) / 1e3,
          "pid": pid, "tid": int(span.get("track", 0))}
    args = dict(span.get("attrs") or {})
    if span.get("request") is not None:
        args["request"] = span["request"]
    if span.get("parent", -1) >= 0:
        args["parent"] = span["parent"]
    if args:
        ev["args"] = args
    return ev


def merge_to_chrome(profiles: Iterable[Tuple[Iterable[tuple], Dict[str, str]]] = (),
                    span_docs: Iterable[dict] = (),
                    phase_tables: Iterable[Tuple[str, List[dict]]] = (),
                    flight_docs: Iterable[dict] = (),
                    devprof_tables: Iterable[Tuple[str, dict]] = (),
                    name: str = "merged") -> dict:
    """Fuse traces from five sources into one multi-lane timeline.

    * ``profiles`` — ``(events, info)`` pairs, one per rank (decoded
      DTPUPROF1 5-tuples); each keeps its ``(pid, tid)`` =
      (rank, track) grid. Two profiles claiming the same rank get
      distinct pids (first wins the raw rank; collisions shift up).
    * ``span_docs`` — serving span documents (``Tracer.to_doc()``);
      each gets its own pid above every profile rank, one tid per
      dispatch-thread lane, request ids in ``args``.
    * ``phase_tables`` — ``(label, rows)`` with
      :meth:`~dplasma_tpu_torch.observability.phases.PhaseLedger.summary`
      rows. A ledger records durations, not wall timestamps, so its
      lane is *synthetic*: the self-time spans are laid end-to-end
      from the merged timeline's origin — an honest aggregate lane
      (disjoint self-times sum to the attributed run), clearly
      labelled ``(synthetic layout)``.
    * ``flight_docs`` — flight-recorder dumps
      (the reference's ``FlightRecorder.dump()`` format): each event
      becomes a Perfetto INSTANT event
      (``ph: "i"``, process scope) at its real ``t_ns`` on its own
      pid lane — op starts/finishes, remediation rungs and devprof
      diagnostics land as pins on the shared time axis.
    * ``devprof_tables`` — ``(label, entry)`` with run-report
      ``"devprof"`` entries (schema v14): the attributed category
      seconds (compute/collective/ici/host) as one synthetic
      end-to-end lane, the per-collective measured seconds as a
      second tid — the measured-attribution picture next to the
      harness spans.

    Every real timestamp is rebased to the earliest event across all
    sources; the merged ``traceEvents`` stream is sorted
    time-monotone (metadata first).
    """
    profs = [(list(evs), dict(info)) for evs, info in profiles]
    sdocs = [dict(d) for d in span_docs]
    tables = [(str(lbl), list(rows)) for lbl, rows in phase_tables]
    fdocs = [dict(d) for d in flight_docs]
    dtables = [(str(lbl), dict(e)) for lbl, e in devprof_tables]
    # global origin over every REAL timestamp (profile ns + span ns
    # + flight event ns)
    t0s = []
    for evs, _info in profs:
        t0s.extend(e[1] for e in evs)
    for d in sdocs:
        t0s.extend(s["t0_ns"] for s in d.get("spans") or [])
    for d in fdocs:
        t0s.extend(e["t_ns"] for e in d.get("events") or []
                   if isinstance(e.get("t_ns"), (int, float)))
    t0 = min(t0s, default=0)

    meta: List[dict] = []
    trace: List[dict] = []
    used_pids = set()

    def claim_pid(want: int) -> int:
        pid = want
        while pid in used_pids:
            pid += 1
        used_pids.add(pid)
        return pid

    other: Dict[str, str] = {"merged": name}
    for i, (evs, info) in enumerate(profs):
        try:
            rank = int(info.get("rank", i))
        except (TypeError, ValueError):
            rank = i
        pid = claim_pid(rank)
        src = info.get("source", f"rank{rank}")
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"{name} rank {rank}"}})
        tracks = set()
        for e in evs:
            ev, track = _profile_event(e, pid, t0)
            tracks.add(track)
            trace.append(ev)
        for tr in sorted(tracks):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tr, "args": {"name": f"track {tr}"}})
        for k, v in info.items():
            other[f"{src}:{k}"] = str(v)
    base = (max(used_pids) + 1) if used_pids else 0
    for i, d in enumerate(sdocs):
        pid = claim_pid(base + i + 1000)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"serving spans [{i}] "
                                      f"(rank {d.get('rank', 0)})"}})
        tracks = set()
        for s in d.get("spans") or []:
            tracks.add(int(s.get("track", 0)))
            trace.append(_span_event(s, pid, t0))
        for tr in sorted(tracks):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tr,
                         "args": {"name": f"serving lane {tr}"}})
    for i, (label, rows) in enumerate(tables):
        pid = claim_pid(base + i + 2000)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"phases: {label} "
                                      f"(synthetic layout)"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "phase self-time"}})
        cursor = 0.0    # µs from the merged origin, end-to-end
        for row in rows:
            dur_us = float(row.get("measured_s", 0.0)) * 1e6
            ev = {"name": str(row.get("phase", "?")), "cat": "phase",
                  "ph": "X", "ts": cursor, "dur": max(dur_us, 0.0),
                  "pid": pid, "tid": 0,
                  "args": {"count": row.get("count"),
                           "measured_s": row.get("measured_s"),
                           "total_s": row.get("total_s")}}
            trace.append(ev)
            cursor += max(dur_us, 0.0)
    for i, d in enumerate(fdocs):
        pid = claim_pid(base + i + 3000)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"flight recorder [{i}] "
                                      f"({d.get('recorded', 0)} "
                                      f"events, {d.get('dropped', 0)} "
                                      f"dropped)"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "flight events"}})
        for e in d.get("events") or []:
            if not isinstance(e, dict) \
                    or not isinstance(e.get("t_ns"), (int, float)):
                continue
            args = {k: v for k, v in e.items()
                    if k not in ("t_ns", "kind")}
            ev = {"name": str(e.get("kind", "?")), "cat": "flight",
                  "ph": "i", "s": "p",
                  "ts": (e["t_ns"] - t0) / 1e3, "pid": pid, "tid": 0}
            if args:
                ev["args"] = args
            trace.append(ev)
    for i, (label, entry) in enumerate(dtables):
        pid = claim_pid(base + i + 4000)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"devprof: {label} "
                                      f"(synthetic layout)"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "category seconds"}})
        cursor = 0.0
        for cat, sec in (entry.get("categories") or {}).items():
            dur_us = max(float(sec or 0.0), 0.0) * 1e6
            trace.append({"name": str(cat), "cat": "devprof",
                          "ph": "X", "ts": cursor, "dur": dur_us,
                          "pid": pid, "tid": 0,
                          "args": {"seconds": sec,
                                   "backend": entry.get("backend")}})
            cursor += dur_us
        colls = entry.get("collectives") or []
        if colls:
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": 1,
                         "args": {"name": "collectives (measured)"}})
            cursor = 0.0
            for c in colls:
                dur_us = max(float(c.get("measured_s") or 0.0),
                             0.0) * 1e6
                trace.append({
                    "name": str(c.get("cls", "?")), "cat": "devprof",
                    "ph": "X", "ts": cursor, "dur": dur_us,
                    "pid": pid, "tid": 1,
                    "args": {"count": c.get("count"),
                             "measured_s": c.get("measured_s"),
                             "achieved_frac": c.get("achieved_frac")}})
                cursor += dur_us
    trace.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms",
            "otherData": other}
