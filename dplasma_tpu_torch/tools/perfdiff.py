#!/usr/bin/env python3
"""perfdiff: cross-run performance regression gate — the port's copy
of the reference's ``tools/perfdiff.py`` (stdlib only, no torch, no
jax), loaded by file path by
:mod:`dplasma_tpu_torch.observability.trend`; run it as
``python dplasma_tpu_torch/tools/perfdiff.py old.json new.json``.

Compares two performance documents — versioned JSON run-reports
(``--report`` from any driver of either package, any schema vintage
v1-v18), the bench one-line JSON doc, or a ``.jsonl`` ledger (the
newest entry is used) — metric by metric, with per-metric relative
thresholds. A regression beyond threshold names the offending metric
(worst offender highlighted) and exits nonzero::

    python dplasma_tpu_torch/tools/perfdiff.py old.json new.json
    python dplasma_tpu_torch/tools/perfdiff.py ledger.jsonl report.json \\
        --auto-threshold

``--auto-threshold`` consults the longitudinal noise model
(:mod:`dplasma_tpu_torch.observability.trend`) instead of the fixed
fractions when the baseline is a ``.jsonl`` ledger: each candidate
metric's matching series yields a rolling-MAD noise sigma and the gate
bound becomes ``max(z * sigma, AUTO_FLOOR)``; below the model's minimum
history the fixed fractions stand.

Ledger envelope: every writer stamps its documents with a ``"family"``
key (run-reports carry ``schema`` + ``name``); envelope-less fragments
are skipped by :func:`latest_comparable_entry` with a named note on
stderr, never adopted as a baseline.

Metrics (:func:`extract_metrics`): per-op ``<label>.median_s`` /
``.best_s`` (lower is better) and ``<label>.gflops`` (higher); bench
ladder entries; ``<label>.hlocheck.hbm_peak_bytes`` and
``<label>.memcheck.peak_bytes`` (lower); the serving section's
``trace_overhead_frac`` / ``admission_overhead_frac`` and the admission
audit's shed / deadline-miss fractions (lower); ``racefuzz.*``; and from
a ``devprof`` section (``--devprof`` on any driver)
``<label>.devprof.ici_achieved_frac`` (higher is better: the worst
class's achieved fraction of the ICI peak) and ``<label>.devprof.skew``
(lower is better; a near-zero fraction, so its default threshold is
the wide 100% relative bound).

Exit codes: 0 = no regression, 1 = regression past threshold,
2 = unusable input. Candidate metrics absent from the baseline are
informational. ``--json[=PATH]`` writes the machine-readable verdict,
its ``exit_code`` mirroring the process's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
from typing import Dict, Optional

DEFAULT_THRESHOLD = 0.10   # 10% relative regression


#: the name the by-path load registers the port's trend module under
_TREND_NAME = "dplasma_tpu_torch_perfdiff_trend"


def _trend():
    """dplasma_tpu_torch/observability/trend.py loaded by file path —
    the noise/changepoint model is stdlib-only like this tool, and a
    by-path load keeps torch (the package root's import) out of the
    gate."""
    mod = sys.modules.get("dplasma_tpu_torch.observability.trend")
    if mod is not None:
        return mod
    mod = sys.modules.get(_TREND_NAME)
    if mod is not None:
        return mod
    path = pathlib.Path(__file__).resolve().parent.parent \
        / "observability" / "trend.py"
    spec = importlib.util.spec_from_file_location(_TREND_NAME, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load trend from {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_TREND_NAME] = mod
    spec.loader.exec_module(mod)
    return mod

#: per-metric-suffix default thresholds (caller --metric-threshold
#: still wins): trace overhead and cross-rank skew are near-zero,
#: noise-dominated fractions — a 10% RELATIVE bound would flag
#: 0.020 -> 0.023
DEFAULT_METRIC_THRESHOLDS = {"trace_overhead_frac": 1.0, "skew": 1.0,
                             "admission_overhead_frac": 1.0}


# ------------------------------------------------------------- loading

def latest_ledger_entry(path: str) -> Optional[dict]:
    """Newest (last non-empty line) entry of a .jsonl ledger."""
    last = None
    with open(path) as f:
        for line in f:
            if line.strip():
                last = line
    return json.loads(last) if last else None


def latest_comparable_entry(path: str, doc: dict) -> Optional[dict]:
    """Newest ledger entry sharing at least one comparable metric with
    ``doc``. Several bench families (bench.py's ladder, servebench's
    serving.* metrics, the autotuner's trial entries) may share one
    ledger; a gate that baselines against the raw newest entry would
    compare across families and pass informationally forever. Among
    shared-metric entries, one whose ``"pipeline"`` section (since
    v11 the FULL resolved knob vector — lookahead/aggregation shape,
    every panel.* knob, grid) matches the candidate's is preferred: a
    chain-panel rerun interleaved after a tree-panel run must not
    silently become the tree run's baseline — knob-vector flips
    compare same-vs-same when the ledger has a same-vector entry, and
    only fall back to the newest same-family entry when it does not.
    Autotuner exploration trials mark themselves ``"tuning": true``
    (deliberately-bad configs measured to be rejected): a candidate
    that is NOT itself a tuning trial never baselines against one.
    With no shared-metric entry (or a candidate with no metrics at
    all) this falls back to the newest raw non-tuning entry,
    preserving the callers' vacuous-gate handling.
    Envelope-less fragments (no ``family`` and no ``schema`` key —
    pre-envelope vintages wrote them) are SKIPPED with a named stderr
    note: a fragment is unattributable, so it must neither crash the
    scan nor silently become a baseline."""
    want = set(extract_metrics(doc))
    pipe = doc.get("pipeline")
    # the trial MARKER is the literal `true` — a v11 run-report's
    # "tuning" section (a list of consultation records) does not make
    # the document an exploration trial
    tuning_doc = doc.get("tuning") is True
    best = best_pipe = last = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if not isinstance(entry, dict):
                continue
            if "family" not in entry and "schema" not in entry:
                sys.stderr.write(
                    f"perfdiff: note: {path}:{lineno}: envelope-less "
                    f"ledger fragment (no family/schema key) skipped "
                    f"as baseline; run tools/ledger_backfill.py\n")
                continue
            if entry.get("tuning") is True and not tuning_doc:
                # a production gate must never baseline against a
                # deliberately-bad exploration trial
                continue
            last = entry
            if want & set(extract_metrics(entry)):
                best = entry
                if isinstance(pipe, dict) \
                        and entry.get("pipeline") == pipe:
                    best_pipe = entry
    if best_pipe is not None:
        return best_pipe
    return best if best is not None else last


def append_ledger(path: str, doc: dict) -> None:
    """Append one document to a .jsonl ledger (one line, flushed)."""
    with open(path, "a") as f:
        f.write(json.dumps(doc) + "\n")
        f.flush()


def load_doc(path: str) -> dict:
    """A run-report / bench JSON doc, or the newest entry of a
    ``.jsonl`` ledger. Tolerates every run-report vintage (the schema
    history is additive; absent sections read as empty)."""
    if path.endswith(".jsonl"):
        doc = latest_ledger_entry(path)
        if doc is None:
            raise ValueError(f"{path}: empty ledger")
        return doc
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a JSON object")
    return doc


# ---------------------------------------------------------- extraction

def extract_metrics(doc: dict) -> Dict[str, dict]:
    """Comparable metrics of one document:
    ``{name: {"value": v, "better": "lower"|"higher"}}``."""
    out: Dict[str, dict] = {}
    for op in doc.get("ops") or []:
        lbl = op.get("label")
        if not lbl:
            continue
        t = op.get("timings") or {}
        for key in ("median_s", "best_s"):
            v = t.get(key)
            if isinstance(v, (int, float)):
                out[f"{lbl}.{key}"] = {"value": float(v),
                                       "better": "lower"}
        g = op.get("gflops")
        if isinstance(g, (int, float)) and g > 0:
            out[f"{lbl}.gflops"] = {"value": float(g),
                                    "better": "higher"}
    for s in doc.get("serving") or []:
        # the tracing-on overhead servebench measures (schema v13):
        # lower is better — the always-on tracer staying ~free is a
        # gated property, not a hope
        if not isinstance(s, dict):
            continue
        v = s.get("trace_overhead_frac")
        if isinstance(v, (int, float)) and v >= 0:
            out["serving.trace_overhead_frac"] = {
                "value": float(v), "better": "lower"}
        v = s.get("admission_overhead_frac")
        if isinstance(v, (int, float)) and v >= 0:
            out["serving.admission_overhead_frac"] = {
                "value": float(v), "better": "lower"}
    adm = doc.get("admission")
    if isinstance(adm, dict):
        # the overload posture (schema v15): shed and deadline-miss
        # fractions, lower-better. A soak run's conservation audit is
        # the gated window (the SAME replayed traffic either side of
        # a change); without one, the controller's lifetime counters
        # stand in
        src = adm.get("audit") if isinstance(adm.get("audit"), dict) \
            else adm
        admitted = src.get("admitted")
        shed = src.get("shed")
        expired = src.get("deadline_expired")
        if isinstance(admitted, (int, float)) \
                and isinstance(shed, (int, float)) \
                and admitted + shed > 0:
            out["serving.shed_frac"] = {
                "value": float(shed) / float(admitted + shed),
                "better": "lower"}
            if isinstance(expired, (int, float)) and expired >= 0:
                out["serving.deadline_miss_frac"] = {
                    "value": float(expired) / float(admitted + shed),
                    "better": "lower"}
    for e in doc.get("hlocheck") or []:
        # compiled-artifact peak memory (schema v10): lower is
        # better — a grown peak is an HBM regression exactly like a
        # grown median is a time regression
        if not isinstance(e, dict):
            continue
        lbl = e.get("op") or e.get("kernel")
        v = e.get("hbm_peak_bytes")
        if lbl and isinstance(v, (int, float)) and v > 0:
            out[f"{lbl}.hlocheck.hbm_peak_bytes"] = {
                "value": float(v), "better": "lower"}
    for e in doc.get("memcheck") or []:
        # static liveness-model resident peak (schema v16): lower is
        # better — a grown structural peak means the schedule holds
        # more tiles live, a residency regression the static verifier
        # sees before any compile
        if not isinstance(e, dict):
            continue
        lbl = e.get("op") or e.get("kernel")
        v = e.get("peak_bytes")
        if lbl and isinstance(v, (int, float)) and v > 0:
            out[f"{lbl}.memcheck.peak_bytes"] = {
                "value": float(v), "better": "lower"}
    for e in doc.get("devprof") or []:
        # measured-ICI attribution (schema v14): the WORST per-class
        # achieved fraction of the ICI peak (higher-better — one
        # collective class falling off the wire drags the metric even
        # when the others hold), and the cross-rank busy-seconds skew
        # (lower-better — a growing straggler gap is a regression)
        if not isinstance(e, dict):
            continue
        lbl = e.get("label") or e.get("op")
        if not lbl:
            continue
        fracs = [c.get("achieved_frac")
                 for c in e.get("collectives") or []
                 if isinstance(c, dict) and isinstance(
                     c.get("achieved_frac"), (int, float))]
        if fracs:
            out[f"{lbl}.devprof.ici_achieved_frac"] = {
                "value": float(min(fracs)), "better": "higher"}
        skew = (e.get("skew") or {}).get("value") \
            if isinstance(e.get("skew"), dict) else None
        if isinstance(skew, (int, float)) and skew >= 0:
            out[f"{lbl}.devprof.skew"] = {"value": float(skew),
                                          "better": "lower"}
    rf = doc.get("racefuzz")
    if isinstance(rf, dict):
        # the threadcheck gate's schedule-fuzz surface: fewer
        # schedules run is a COVERAGE regression (higher-better),
        # invariant failures grow from a 0 baseline (lower-better —
        # the zero-baseline ratio path below handles the gate)
        # zero schedules is the WORST case (total coverage collapse),
        # not a missing measurement — it must stay comparable
        v = rf.get("schedules_run")
        if isinstance(v, (int, float)) and v >= 0:
            out["racefuzz.schedules_run"] = {"value": float(v),
                                             "better": "higher"}
        v = rf.get("invariant_failures")
        if isinstance(v, (int, float)) and v >= 0:
            out["racefuzz.invariant_failures"] = {"value": float(v),
                                                  "better": "lower"}
    for e in (doc.get("entries") or []) + (doc.get("ladder") or []):
        if isinstance(e, dict) and isinstance(e.get("metric"), str) \
                and isinstance(e.get("value"), (int, float)):
            # entries may declare their direction ("better": "lower" —
            # the IR solvers' iteration counts, where growth is a
            # convergence regression); GFlop/s-style default is higher
            better = e.get("better")
            out[e["metric"]] = {"value": float(e["value"]),
                                "better": better
                                if better in ("lower", "higher")
                                else "higher"}
    return out


# ---------------------------------------------------------- comparison

def compare(old_doc: dict, new_doc: dict,
            threshold: float = DEFAULT_THRESHOLD,
            per_metric: Optional[Dict[str, float]] = None,
            auto: Optional[Dict[str, dict]] = None) -> dict:
    """Compare every metric present in both documents.

    The per-metric regression ratio is positive-when-worse regardless
    of direction: ``(new-old)/old`` for lower-is-better timings,
    ``(old-new)/old`` for higher-is-better rates. ``per_metric`` maps
    a full metric name (or its bare suffix, e.g. ``median_s``) to a
    custom threshold; ``auto`` (built by :func:`auto_thresholds` from
    a ledger baseline) maps a metric to its noise-calibrated
    ``{"threshold", "sigma", "changepoint"}`` — an explicit
    ``per_metric`` override still wins. Returns ``{"ok", "compared",
    "rows", "regressions", "worst"}`` with rows sorted worst-first;
    every row carries the noise-model fields (``sigma`` /
    ``effect_sigma`` / ``auto_threshold``, null/false where the model
    had no series history).
    """
    per_metric = per_metric or {}
    auto = auto or {}
    old_m, new_m = extract_metrics(old_doc), extract_metrics(new_doc)
    rows = []
    for name in sorted(set(old_m) & set(new_m)):
        ov, nv = old_m[name]["value"], new_m[name]["value"]
        better = new_m[name]["better"]
        if ov <= 0:
            if not (better == "lower" and ov == 0 and nv >= 0):
                continue
            # a 0 baseline is legitimate for lower-better counts (an
            # IR solve converging at the initial solve records 0
            # iterations); growth from it is still a regression the
            # gate must see — ratio against a unit denominator
            # instead of skipping the metric
            ratio = float(nv)
        else:
            ratio = (nv - ov) / ov if better == "lower" \
                else (ov - nv) / ov
        suffix = name.rsplit(".", 1)[-1]
        th = per_metric.get(name, per_metric.get(suffix))
        noise = auto.get(name)
        used_auto = False
        if th is None and noise is not None:
            th = noise["threshold"]
            used_auto = True
        if th is None:
            th = DEFAULT_METRIC_THRESHOLDS.get(suffix, threshold)
        sigma = noise["sigma"] if noise else None
        rows.append({"metric": name, "old": ov, "new": nv,
                     "better": better, "regression": ratio,
                     "threshold": th, "worse": ratio > th,
                     "sigma": sigma,
                     "effect_sigma": ratio / sigma if sigma else None,
                     "auto_threshold": used_auto,
                     "changepoint": noise.get("changepoint")
                     if noise else None})
    rows.sort(key=lambda r: -r["regression"])
    regs = [r for r in rows if r["worse"]]
    # baseline metrics with no candidate counterpart: an op that
    # regressed into failure records no timing at all — surface the
    # disappearance instead of silently shrinking the comparison
    missing = sorted(set(old_m) - set(new_m))
    # candidate metrics with no baseline counterpart: the FIRST entry
    # of a new metric family (e.g. the serving layer's first v8
    # ledger entry against a pre-serving baseline) is informational —
    # it seeds the baseline for the next run, it cannot regress
    new_only = sorted(set(new_m) - set(old_m))
    return {"ok": not regs, "compared": len(rows), "rows": rows,
            "regressions": regs, "worst": regs[0] if regs else None,
            "missing": missing, "new": new_only}


def auto_thresholds(path: str, doc: dict,
                    z: Optional[float] = None) -> Dict[str, dict]:
    """Noise-calibrated per-metric thresholds from a ledger baseline
    (``--auto-threshold``): each candidate metric's matching series
    (exact family/knob/platform/placeholder identity, else the
    longest same-family series of that metric) yields
    ``{"threshold": max(z * sigma, AUTO_FLOOR), "sigma", "changepoint"}``.
    Metrics whose series is shorter than the noise model's minimum
    history are ABSENT — the fixed fractions stand for them, so a
    young ledger gates exactly as without the flag."""
    tr = _trend()
    series, _ = tr.ingest_ledger(path)
    fam = tr.doc_family(doc)
    platform = tr.doc_platform(doc)
    out: Dict[str, dict] = {}
    for metric, row in tr.iter_points(doc):
        s = None
        if fam is not None:
            s = series.get(tr.series_key(
                fam, metric, row["knobs"], platform,
                row["placeholder"]))
        if s is None:
            cands = [x for x in series.values()
                     if x["metric"] == metric
                     and x["placeholder"] == row["placeholder"]
                     and (fam is None or x["family"] == fam)]
            s = max(cands, key=lambda x: len(x["points"]),
                    default=None)
        if s is None:
            continue
        values = [p["value"] for p in s["points"]]
        sigma = tr.noise_sigma(values)
        if sigma is None:
            continue
        cps = tr.changepoints(values + [row["value"]])
        out[metric] = {
            "threshold": max((z or tr.Z_SIGMA) * sigma,
                             tr.AUTO_FLOOR),
            "sigma": sigma,
            "changepoint": cps[-1]["index"] if cps else None}
    return out


def format_result(res: dict, verbose: bool = False) -> list:
    """Human lines: every regression (worst first), the worst offender
    named, one summary line; ``verbose`` adds all compared rows.
    Auto-gated rows show the effect size in noise-sigma units, and a
    regression names the changepoint index the median-shift detector
    placed in its series."""
    lines = []
    shown = res["rows"] if verbose else res["regressions"]
    for r in shown:
        tag = "REGRESSION" if r["worse"] else "ok        "
        extra = ""
        if r.get("auto_threshold"):
            extra = " auto"
            if r.get("effect_sigma") is not None:
                extra += ", %.1f sigma" % r["effect_sigma"]
            if r.get("changepoint") is not None and r["worse"]:
                extra += ", changepoint @%d" % r["changepoint"]
        lines.append(
            "perfdiff: %s %s %.6g -> %.6g (%+.1f%% %s, threshold "
            "%.1f%%%s)" % (tag, r["metric"], r["old"], r["new"],
                           100.0 * r["regression"],
                           "worse" if r["regression"] > 0 else "change",
                           100.0 * r["threshold"], extra))
    if res["worst"] is not None:
        lines.append("perfdiff: worst offender: %s (%+.1f%%)"
                     % (res["worst"]["metric"],
                        100.0 * res["worst"]["regression"]))
    missing = res.get("missing") or []
    if missing:
        shown = ", ".join(missing[:5])
        if len(missing) > 5:
            shown += ", ..."
        lines.append("perfdiff: note: %d baseline metric(s) absent "
                     "from candidate: %s" % (len(missing), shown))
    new_only = res.get("new") or []
    if new_only:
        shown = ", ".join(new_only[:5])
        if len(new_only) > 5:
            shown += ", ..."
        lines.append("perfdiff: note: %d candidate metric(s) not in "
                     "baseline (informational, seeds the next "
                     "comparison): %s" % (len(new_only), shown))
    if res["compared"] == 0:
        if new_only:
            lines.append("perfdiff: OK (no common metrics; %d new "
                         "metric(s) recorded)" % len(new_only))
        else:
            lines.append("perfdiff: no common metrics to compare")
    elif res["ok"]:
        lines.append("perfdiff: OK (%d metric(s) within threshold)"
                     % res["compared"])
    else:
        lines.append("perfdiff: %d regression(s) over %d metric(s)"
                     % (len(res["regressions"]), res["compared"]))
    return lines


def verdict_doc(res: dict, exit_code: int, threshold: float,
                baseline: str, candidate: str) -> dict:
    """The machine-readable ``--json`` verdict: every compared row,
    the regression list, the worst offender, and an ``exit_code``
    that mirrors the process exit code."""
    return {"perfdiff": 1, "ok": res["ok"], "exit_code": exit_code,
            "threshold": threshold,
            "auto_threshold": bool(res.get("auto_threshold")),
            "baseline": baseline, "candidate": candidate,
            "compared": res["compared"], "rows": res["rows"],
            "regressions": [r["metric"] for r in res["regressions"]],
            "worst": res["worst"],
            "missing_metrics": res.get("missing") or [],
            "new_metrics": res.get("new") or []}


def _emit_json(dst: str, doc: dict) -> None:
    text = json.dumps(doc, indent=2, sort_keys=True)
    if dst == "-":
        print(text)
    else:
        with open(dst, "w") as f:
            f.write(text + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="perfdiff", description=__doc__.splitlines()[0])
    ap.add_argument("old", help="baseline: run-report/bench JSON, or "
                                ".jsonl ledger (newest entry)")
    ap.add_argument("new", help="candidate: run-report/bench JSON, or "
                                ".jsonl ledger (newest entry)")
    ap.add_argument("--threshold", type=float,
                    default=DEFAULT_THRESHOLD,
                    help="relative regression threshold "
                         f"(default {DEFAULT_THRESHOLD})")
    ap.add_argument("--metric-threshold", action="append", default=[],
                    metavar="NAME=FRAC",
                    help="per-metric threshold override (full name or "
                         "bare suffix, e.g. median_s=0.25); repeatable")
    ap.add_argument("--auto-threshold", action="store_true",
                    help="noise-calibrated per-metric thresholds from "
                         "the baseline ledger's series history "
                         "(observability.trend); metrics below the "
                         "minimum history keep the fixed fractions. "
                         "Needs a .jsonl ledger baseline")
    ap.add_argument("--z-sigma", type=float, default=None,
                    help="auto-threshold bound in noise-sigma units "
                         "(default trend.Z_SIGMA)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH", dest="json_out",
                    help="write the machine-readable verdict JSON to "
                         "PATH (use --json=PATH; bare --json or '-' "
                         "writes to stdout); its exit_code field "
                         "mirrors the process exit code")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every compared metric, not just "
                         "regressions")
    ns = ap.parse_args(argv)
    per = {}
    for spec in ns.metric_threshold:
        name, eq, val = spec.partition("=")
        if not eq:
            sys.stderr.write(f"perfdiff: bad --metric-threshold "
                             f"{spec!r} (want NAME=FRAC)\n")
            return 2
        try:
            per[name] = float(val)
        except ValueError:
            sys.stderr.write(f"perfdiff: bad threshold in {spec!r}\n")
            return 2
    try:
        old_doc, new_doc = load_doc(ns.old), load_doc(ns.new)
    except (OSError, ValueError) as exc:
        sys.stderr.write(f"perfdiff: {exc}\n")
        if ns.json_out:
            # the machine consumer still gets a verdict on an
            # unusable input — exit_code 2, no rows
            _emit_json(ns.json_out, {
                "perfdiff": 1, "ok": False, "exit_code": 2,
                "threshold": ns.threshold, "baseline": ns.old,
                "candidate": ns.new, "compared": 0, "rows": [],
                "regressions": [], "worst": None,
                "missing_metrics": [], "new_metrics": [],
                "error": str(exc)})
        return 2
    auto = None
    if ns.auto_threshold:
        if ns.old.endswith(".jsonl"):
            try:
                auto = auto_thresholds(ns.old, new_doc, z=ns.z_sigma)
            except (OSError, ValueError, ImportError) as exc:
                sys.stderr.write(f"perfdiff: note: auto-threshold "
                                 f"unavailable ({exc}); fixed "
                                 f"thresholds in effect\n")
        else:
            sys.stderr.write("perfdiff: note: --auto-threshold needs "
                             "a .jsonl ledger baseline; fixed "
                             "thresholds in effect\n")
    res = compare(old_doc, new_doc, ns.threshold, per, auto=auto)
    res["auto_threshold"] = bool(auto)
    for line in format_result(res, verbose=ns.verbose):
        print(line)
    if res["compared"] == 0:
        # nothing in common: candidate-only metrics are informational
        # (a new metric family's first entry must not break the gate);
        # a candidate with NO extractable metrics at all is unusable
        code = 0 if res.get("new") else 2
    else:
        code = 0 if res["ok"] else 1
    if ns.json_out:
        _emit_json(ns.json_out, verdict_doc(
            res, code, ns.threshold, ns.old, ns.new))
    return code


if __name__ == "__main__":
    sys.exit(main())
