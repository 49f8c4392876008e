"""Command-line tools of the port: ``perfdiff`` (stdlib only, loaded by
file path where torch must stay out,
:mod:`dplasma_tpu_torch.observability.trend`) and ``tracecat``
(DTPUPROF1 -> Chrome trace-event JSON)."""
