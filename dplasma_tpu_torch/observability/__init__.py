"""Observability: metrics, run-reports, phase attribution, traces
(``dplasma_tpu/observability/``, the part the drivers' instruments
need; ROADMAP queue 1 item 14, first part).

* :mod:`.metrics` — the labelled counter/gauge/histogram registry whose
  snapshot embeds in the run-report;
* :mod:`.report` — the versioned JSON run-report (schema 18), assembled
  by :class:`dplasma_tpu_torch.drivers.common.Driver` (``--report``);
* :mod:`.comm` — the analytic comm-volume model from the block-cyclic
  layout (``native.rank_of`` and ``parallel.cyclic.spmd_comm_model``);
* :mod:`.phases` — scoped phase timers in the sweeps, the IR solvers
  and the cyclic factorizations, activated by the drivers'
  ``--phase-profile`` attributed pass; inert otherwise;
* :mod:`.roofline` — expected seconds per phase and op against the
  peaks of a ``--peaks-file`` (``chip_smoke.py`` phase 19 probes the
  card's), with the binding resource and ``achieved_frac``;
* :mod:`.chrome` — DTPUPROF1 profiles and phase tables as Chrome
  trace-event JSON.

Not ported yet: ``devprof``, ``telemetry``, ``tracing`` and ``trend``
(item 14's second part; ``devprof`` reads the spmdcheck schedule of
item 15), ``dag`` (the ``dag()`` builders of item 15), and ``xla``,
which has no twin: the port compiles nothing, so a report's ``"xla"``
is null.
"""
from dplasma_tpu_torch.observability import phases, roofline
from dplasma_tpu_torch.observability.chrome import (merge_to_chrome,
                                                    profile_to_chrome)
from dplasma_tpu_torch.observability.comm import comm_volume_model
from dplasma_tpu_torch.observability.metrics import MetricsRegistry
from dplasma_tpu_torch.observability.report import REPORT_SCHEMA, RunReport

__all__ = [
    "MetricsRegistry", "REPORT_SCHEMA", "RunReport", "comm_volume_model",
    "merge_to_chrome", "phases", "profile_to_chrome", "roofline",
]
