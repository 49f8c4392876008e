"""The versioned JSON run-report (``"schema": 18``); ports
``dplasma_tpu/observability/report.py``.

One report per driver invocation (``--report[=file]``): the
machine-readable record of everything the ``[****] TIME(s)`` line
summarizes plus what it drops — per-run times (not just best), the
harness phases (ENQ/warmup/PROG/DEST), the analytic comm-volume model,
the ``--phase-profile`` phase table and the roofline ledger. The schema
is the reference's (its module docstring lists every section and its
history), so the reference's readers (``load_report``,
``tools/perfdiff.py``) read a port report. Two keys read differently:

* ``env`` is ``{"backend": "cuda" | "cpu", "torch": version,
  "device_count": n}`` in place of the reference's ``"jax"`` key;
* each op's ``"xla"`` is an explicit null — the reference's meaning,
  "the backend declined to answer": the port compiles nothing.

The drivers fill ``telemetry`` (``--telemetry``), ``devprof``
(``--devprof``) and ``provenance`` (:meth:`RunReport.stamp_provenance`
at every ``--report``; ``observability.trend.collect_provenance``).
The sections of layers not ported yet (resilience, dagcheck,
spmdcheck, hlocheck, memcheck, tuning, autopilot, admission; ROADMAP
queue 1 items 9b, 12, 13 and 15) stay absent, as they are in a
reference run that does not ask for them; their ``add_*`` methods are
kept, so a later slice only calls them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

from dplasma_tpu_torch.observability.metrics import (Histogram,
                                                    MetricsRegistry)

REPORT_SCHEMA = 18


def run_stats(runs_s: List[float]) -> dict:
    """min/median/max/mean/stddev of the per-run times (the reference
    prints per-run lines; ``best`` alone hides variance). The math is
    :meth:`Histogram.stats` — one statistics implementation for both
    the report timings and the metrics snapshot. A no-runs entry
    (``nruns=0`` dry runs) carries explicit nulls for every statistic
    so the document still serializes/round-trips cleanly."""
    # exact_cap = the run count: report statistics stay EXACT at any
    # nruns (the bounded default exists for unbounded serving
    # traffic, not for a list we hold in full right here)
    h = Histogram(exact_cap=len(runs_s))
    for v in runs_s:
        h.observe(v)
    s = h.stats()
    return {"nruns": len(runs_s), "runs_s": list(runs_s),
            "best_s": s["min"],
            "min_s": s["min"], "median_s": s["median"],
            "max_s": s["max"], "mean_s": s["mean"],
            "stddev_s": s["stddev"]}


class RunReport:
    """Accumulates per-op entries + metrics; writes versioned JSON."""

    def __init__(self, name: str, iparam=None):
        self.name = name
        self.iparam = iparam
        self.metrics = MetricsRegistry()
        self.ops: List[dict] = []
        self.entries: List[dict] = []   # free-form (bench ladder)
        self.checks: List[dict] = []    # -x verification outcomes
        self.resilience: List[dict] = []  # per-op ladder summaries
        self.dagcheck: List[dict] = []  # --dagcheck verification (v3)
        self.spmdcheck: List[dict] = []  # --spmdcheck verification (v6)
        self.refine: List[dict] = []    # IR-solver records (v7)
        self.serving: List[dict] = []   # serving-layer records (v8)
        self.hlocheck: List[dict] = []  # --hlocheck audits (v10)
        self.memcheck: List[dict] = []  # --memcheck residency (v16)
        self.tuning: List[dict] = []    # --autotune consultations (v11)
        self.autopilot: List[dict] = []  # precision-autopilot picks (v17)
        self.scaling: List[dict] = []   # per-chip-count curves (v12)
        self.telemetry: Optional[dict] = None  # live instruments (v13)
        self.devprof: List[dict] = []   # measured-timeline attribution (v14)
        self.admission: Optional[dict] = None  # overload posture (v15)
        self.pipeline: Optional[dict] = None  # sweep pipeline shape (v4)
        self.provenance: Optional[dict] = None  # attribution stamp (v18)
        self.roofline: List[dict] = []  # per-op roofline entries (v5)
        self.extra: dict = {}
        self._t0 = time.time_ns()

    def add_op(self, label: str, *, prec: str = "", flops: float = 0.0,
               enq_s: float = 0.0, warmup_s: Optional[float] = None,
               dest_s: float = 0.0, runs_s: Optional[List[float]] = None,
               gflops: Optional[float] = None, xla: Optional[dict] = None,
               comm: Optional[dict] = None, dag: Optional[dict] = None,
               phases: Optional[dict] = None) -> dict:
        timings = {"enq_s": enq_s, "warmup_s": warmup_s,
                   "dest_s": dest_s}
        timings.update(run_stats(runs_s or []))
        entry = {"label": label, "prec": prec, "model_flops": flops,
                 "gflops": gflops, "timings": timings,
                 "xla": xla, "comm": comm, "dag": dag,
                 "phases": phases}
        self.ops.append(entry)
        return entry

    def add_check(self, what: str, residual: float, ok: bool) -> dict:
        """Record one -x verification outcome (schema v2)."""
        entry = {"what": what, "residual": float(residual),
                 "ok": bool(ok)}
        self.checks.append(entry)
        return entry

    def add_resilience(self, summary: dict) -> dict:
        """Record one progress() call's resilience summary — the
        injection, every attempt's classification/action, and the
        outcome (schema v2; see resilience.guard.Ladder.summary)."""
        self.resilience.append(summary)
        return summary

    def add_dagcheck(self, op: str, summary: dict) -> dict:
        """Record one --dagcheck verification outcome (schema v3; see
        analysis.dagcheck.CheckResult.summary)."""
        entry = {"op": op, **summary}
        self.dagcheck.append(entry)
        return entry

    def add_spmdcheck(self, op: str, summary: dict) -> dict:
        """Record one --spmdcheck verification outcome (schema v6; see
        analysis.spmdcheck.SpmdResult.summary)."""
        entry = {"op": op, **summary}
        self.spmdcheck.append(entry)
        return entry

    def add_refine(self, summary: dict) -> dict:
        """Record one mixed-precision IR solve (schema v7; see
        ops.refine.summarize)."""
        self.refine.append(summary)
        return summary

    def add_serving(self, summary: dict) -> dict:
        """Record one serving-layer lifetime summary (schema v8; see
        serving.service.SolverService.summary)."""
        self.serving.append(summary)
        return summary

    def add_hlocheck(self, op: str, summary: dict) -> dict:
        """Record one --hlocheck compiled-artifact audit (schema v10;
        see analysis.hlocheck.HloResult.summary)."""
        entry = {"op": op, **summary}
        self.hlocheck.append(entry)
        return entry

    def add_memcheck(self, op: str, summary: dict) -> dict:
        """Record one --memcheck static residency verification
        (schema v16; see analysis.memcheck.MemResult.summary)."""
        entry = {"op": op, **summary}
        self.memcheck.append(entry)
        return entry

    def add_tuning(self, summary: dict) -> dict:
        """Record one --autotune tuning-DB consultation (schema v11;
        see drivers.common.Driver and dplasma_tpu.tuning.consult)."""
        self.tuning.append(summary)
        return summary

    def add_autopilot(self, summary: dict) -> dict:
        """Record one precision-autopilot consultation (schema v17;
        see dplasma_tpu.tuning.autopilot.consult)."""
        self.autopilot.append(summary)
        return summary

    def add_scaling(self, summary: dict) -> dict:
        """Record one op's per-chip-count scaling curve (schema v12;
        see tools/multichip.py)."""
        self.scaling.append(summary)
        return summary

    def add_telemetry(self, summary: dict) -> dict:
        """Record the live-instrument summary (schema v13; see
        observability.telemetry.Telemetry.summary — span ledger,
        exporter provenance, the flight recorder's event ring)."""
        self.telemetry = summary
        return summary

    def add_devprof(self, entry: dict) -> dict:
        """Record one op's measured-timeline attribution (schema v14;
        see observability.devprof.ingest/attribute — category
        seconds, measured-ICI reconciliation, skew/straggler
        attribution, critical path)."""
        self.devprof.append(entry)
        return entry

    def add_admission(self, summary: dict) -> dict:
        """Record the serving overload posture's end-of-run summary
        (schema v15; see serving.admission.AdmissionController.summary
        — servebench --soak adds the ``"audit"`` conservation
        subkey)."""
        self.admission = summary
        return summary

    def stamp_provenance(self, **kw) -> dict:
        """Collect and attach the attribution stamp (schema v18; see
        observability.trend.collect_provenance — git SHA + dirty
        flag, torch/CUDA versions, backend + device count + the card's
        name, mesh shape, peaks source, active MCA snapshot, ladder
        family). Keyword arguments pass through (``family=``,
        ``mesh_shape=``, ``peaks_source=``)."""
        from dplasma_tpu_torch.observability.trend import \
            collect_provenance
        self.provenance = collect_provenance(**kw)
        return self.provenance

    def add_roofline(self, entry: dict) -> dict:
        """Record one per-op roofline ledger entry (schema v5; see
        observability.roofline.op_roofline)."""
        self.roofline.append(entry)
        return entry

    def snapshot(self) -> dict:
        import torch
        cuda = torch.cuda.is_available()
        env = {"backend": "cuda" if cuda else "cpu",
               "torch": torch.__version__,
               "device_count": torch.cuda.device_count() if cuda else 1}
        ipd = None
        if self.iparam is not None:
            ipd = {k: v for k, v in
                   dataclasses.asdict(self.iparam).items()
                   if isinstance(v, (int, float, str, bool, type(None)))}
        doc = {"schema": REPORT_SCHEMA, "name": self.name,
               "created_unix_ns": self._t0, "iparam": ipd, "env": env,
               "ops": self.ops, "metrics": self.metrics.snapshot()}
        if self.checks:
            doc["checks"] = self.checks
        if self.resilience:
            doc["resilience"] = self.resilience
        if self.dagcheck:
            doc["dagcheck"] = self.dagcheck
        if self.spmdcheck:
            doc["spmdcheck"] = self.spmdcheck
        if self.refine:
            doc["refine"] = self.refine
        if self.serving:
            doc["serving"] = self.serving
        if self.hlocheck:
            doc["hlocheck"] = self.hlocheck
        if self.memcheck:
            doc["memcheck"] = self.memcheck
        if self.tuning:
            doc["tuning"] = self.tuning
        if self.autopilot:
            doc["autopilot"] = self.autopilot
        if self.scaling:
            doc["scaling"] = self.scaling
        if self.telemetry is not None:
            doc["telemetry"] = self.telemetry
        if self.devprof:
            doc["devprof"] = self.devprof
        if self.admission is not None:
            doc["admission"] = self.admission
        if self.pipeline is not None:
            doc["pipeline"] = self.pipeline
        if self.provenance is not None:
            doc["provenance"] = self.provenance
        if self.roofline:
            doc["roofline"] = self.roofline
        if self.entries:
            doc["entries"] = self.entries
        if self.extra:
            doc["extra"] = self.extra
        return doc

    def write(self, path: str) -> str:
        """Serialize to ``path`` (atomic rename); returns the path."""
        doc = self.snapshot()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=_json_default)
            f.write("\n")
        os.replace(tmp, path)
        return path


def _json_default(o):
    for cast in (float, int):
        try:
            return cast(o)
        except (TypeError, ValueError):
            continue
    return str(o)


def load_report(path: str) -> dict:
    """Read a run-report back; raises on schema mismatch newer than
    this reader.

    Every older vintage (v1-v17) loads: the schema history is purely
    additive, so an old doc is a valid new doc minus the sections its
    writer didn't know about. The always-present keys (``schema``,
    ``ops``, ``metrics``) are filled with safe defaults when absent,
    so consumers (perfdiff, bench) can iterate them unconditionally;
    optional sections stay absent exactly as the writer left them.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: run-report is not a JSON object")
    if doc.get("schema", 0) > REPORT_SCHEMA:
        raise ValueError(
            f"run-report schema {doc.get('schema')} is newer than "
            f"supported ({REPORT_SCHEMA})")
    doc.setdefault("schema", 1)
    doc.setdefault("ops", [])
    doc.setdefault("metrics", [])
    return doc
