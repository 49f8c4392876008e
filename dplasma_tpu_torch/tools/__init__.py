"""Stdlib-only tools of the port (``perfdiff``), loaded by file path
where torch must stay out (:mod:`dplasma_tpu_torch.observability.trend`)."""
