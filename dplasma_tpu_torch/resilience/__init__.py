"""Resilience: deterministic fault injection, ABFT checksums and the
driver's remediation ladder (ports ``dplasma_tpu/resilience``).

- :mod:`~dplasma_tpu_torch.resilience.inject` — seeded fault plans
  (``--inject=KIND@STAGE[:RATE[:COUNT]]``, env ``DPLASMA_INJECT``)
  applied by taps at the ``kernels.blas`` choke points;
- :mod:`~dplasma_tpu_torch.resilience.abft` — checksum-carried GEMM,
  POTRF and LU (``--abft``) with O(n^2) verification that detects and
  locates a corrupted tile (and corrects it for GEMM);
- :mod:`~dplasma_tpu_torch.resilience.guard` — the health scan, the
  watchdog and the ladder (retry → kernel fallback → the driver body's
  algorithm fallbacks) that ``Driver.progress`` walks after a failed
  attempt.

Submodules are imported directly; this ``__init__`` stays empty because
``kernels.blas`` imports :mod:`inject` from the kernel layer.
"""

__all__ = ["abft", "guard", "inject"]
