"""Solver-as-a-service: batched execution paths, a cache of built
batched callables, and a request front-end over the port's factor/solve
workloads.

Ports ``dplasma_tpu/serving/``. Production traffic is many medium-size
problems, not one N=16k matrix. This subsystem turns the solvers into a
high-throughput, latency-measured service:

* :mod:`~dplasma_tpu_torch.serving.batched` — ``torch.func.vmap`` over
  the unbatched potrf/potrs, getrf/getrs and mixed-precision IR sweeps:
  one call factors/solves a stacked ``(B, n, n)`` batch, each K1 product
  and K2 residual one launch for the batch, with per-problem convergence
  masks for iterative refinement;
* :mod:`~dplasma_tpu_torch.serving.cache` — a cache keyed by (op, shape
  bucket, dtype, batch bucket, nrhs bucket, grid, pipeline shape, ir
  precision), with ragged inputs identity/zero-padded into
  power-of-two-ish buckets and an LRU bound;
* :mod:`~dplasma_tpu_torch.serving.service` — :class:`SolverService`:
  ``submit() -> future`` handles, a batching scheduler
  (``serving.max_batch`` / ``serving.max_wait_ms``), result scatter,
  and a per-request resilience ladder (classify -> retry -> escalate)
  that heals a failed request without poisoning its batch-mates;
* :mod:`~dplasma_tpu_torch.serving.admission` — the overload posture:
  admission control, per-request deadlines, per-(op, rung) circuit
  breakers and a process-global ladder retry budget.

``python -m dplasma_tpu_torch.tools.servebench`` drives a synthetic
open-loop workload through the service and records solves/sec + p50/p99
latency + cache hit-rate into the run-report ``"serving"`` section;
``--soak`` replays sustained mixed traffic under a scripted chaos
schedule and closes with a conservation audit.
"""
from dplasma_tpu_torch.serving import admission, batched, cache, service
from dplasma_tpu_torch.serving.admission import (AdmissionController,
                                                 AdmissionError,
                                                 DeadlineExceeded,
                                                 ServingTimeout)
from dplasma_tpu_torch.serving.service import SolveFuture, SolverService

__all__ = ["admission", "batched", "cache", "service", "SolverService",
           "SolveFuture", "AdmissionController", "AdmissionError",
           "DeadlineExceeded", "ServingTimeout"]
