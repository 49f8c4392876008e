"""Observability: metrics, run-reports, phase attribution, traces, live
telemetry and measured device timelines (``dplasma_tpu/observability/``;
ROADMAP queue 1 item 14).

* :mod:`.metrics` — the labelled counter/gauge/histogram registry whose
  snapshot embeds in the run-report;
* :mod:`.report` — the versioned JSON run-report (schema 18), assembled
  by :class:`dplasma_tpu_torch.drivers.common.Driver` (``--report``),
  with the provenance stamp of :mod:`.trend`;
* :mod:`.comm` — the analytic comm-volume model from the block-cyclic
  layout (``native.rank_of`` and ``parallel.cyclic.spmd_comm_model``);
* :mod:`.phases` — scoped phase timers in the sweeps, the IR solvers
  and the cyclic factorizations, activated by the drivers'
  ``--phase-profile`` attributed pass; inert otherwise;
* :mod:`.roofline` — expected seconds per phase and op against the
  peaks of a ``--peaks-file`` (``chip_smoke.py`` phase 19 probes the
  card's), with the binding resource and ``achieved_frac``;
* :mod:`.chrome` — DTPUPROF1 profiles, phase tables and tracer spans
  as Chrome trace-event JSON;
* :mod:`.tracing` — :class:`Tracer`, the always-on, thread-safe span
  layer with request attribution;
* :mod:`.telemetry` — the live instruments: the Prometheus text
  exposition of a registry (:class:`MetricsExporter` rewrites it from a
  daemon thread) and the :class:`FlightRecorder` of structured events,
  bundled with a tracer in :class:`Telemetry` (the drivers'
  ``--telemetry``; the run-report's ``"telemetry"`` section);
* :mod:`.devprof` — the measured half of the roofline story: the device
  timeline of the best timed run (a ``torch.profiler`` capture on the
  card; a synthetic timeline from the run's seconds, the schedule and
  the comm model on the CPU and on a virtual mesh), binned into
  compute/collective/ici/host, reconciled per collective class, with
  skew and the critical path (the drivers' ``--devprof``; the
  ``"devprof"`` section);
* :mod:`.trend` — the longitudinal series, noise model, changepoints
  and the provenance stamp (stdlib only).

Not ported yet: ``dag`` (the ``dag()`` builders of item 15), and
``xla``, which has no twin: the port compiles nothing, so a report's
``"xla"`` is null.
"""
from dplasma_tpu_torch.observability import (devprof, phases, roofline,
                                             telemetry, trend)
from dplasma_tpu_torch.observability.chrome import (merge_to_chrome,
                                                    profile_to_chrome)
from dplasma_tpu_torch.observability.comm import comm_volume_model
from dplasma_tpu_torch.observability.metrics import MetricsRegistry
from dplasma_tpu_torch.observability.report import REPORT_SCHEMA, RunReport
from dplasma_tpu_torch.observability.telemetry import (FlightRecorder,
                                                       MetricsExporter,
                                                       Telemetry)
from dplasma_tpu_torch.observability.tracing import Tracer

__all__ = [
    "FlightRecorder", "MetricsExporter", "MetricsRegistry",
    "REPORT_SCHEMA", "RunReport", "Telemetry", "Tracer",
    "comm_volume_model", "devprof", "merge_to_chrome", "phases",
    "profile_to_chrome", "roofline", "telemetry", "trend",
]
