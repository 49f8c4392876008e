"""Batched-callable cache with shape bucketing — the serving layer's
answer to ragged traffic.

Ports ``dplasma_tpu/serving/cache.py``. Real request streams are ragged,
so the cache first *buckets* shapes (power-of-two-ish ladders: each
bucket is at most ~1.33x the exact size, so padding waste is bounded)
and pads inputs into the bucket:

* ``A`` pads with IDENTITY blocks on the diagonal (the
  :meth:`TileMatrix.pad_diag` contract one level up): the padded system
  is ``blkdiag(A, I) [x; y] = [b; 0]`` whose ``x`` is EXACTLY the
  unpadded solution;
* ``b`` pads with zeros (rows and right-hand-side columns);
* batch slots pad with identity problems (``A = I``, ``b = 0``).

The port compiles nothing: an :class:`Entry` holds the built batched
callable (``batched.solve_batched`` plus the backward errors), keyed by
:func:`make_key`'s full contract tuple: op, shape bucket, dtype, batch
bucket, nrhs bucket, device grid, pipeline shape
(``sweep.lookahead``/``qr.agg_depth``), and ``ir.precision`` for the IR
solvers. Its build is one run at the bucket shape on identity problems,
with fault taps suppressed: the run builds the kernels at first use and
fills K1's and K2's launch-argument caches, and its time lands in
``serving_cache_compile_seconds``. An LRU bound (MCA
``serving.cache_capacity``) evicts cold entries; hit/miss/eviction
counts land in the metrics registry (``serving_cache_*``).

The reference audits every admitted executable (``analysis.hlocheck``,
``serving_hlocheck_*``); that waits for ROADMAP item 15 here, so
:attr:`Entry.hlocheck` is None and no audit metric is emitted.

Fault-injection interplay: the reference's taps fire at trace time, so
an executable compiled while a plan fires is poisoned for its lifetime
and the service drops it. The port's taps fire at run time and an entry
cannot be poisoned, but the service keeps the reference's accounting:
an entry whose dispatch fired a fault is marked ``tainted`` and
invalidated, so the cache's counters agree with the reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dplasma_tpu_torch.observability.metrics import MetricsRegistry
from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "serving.cache_capacity", "32",
    "LRU bound of the serving cache (built batched callables kept hot; "
    "least-recently-used entries are evicted past this).")
_cfg.mca_register(
    "serving.bucket", "pow2ish",
    "Shape-bucket policy of the serving layer: pow2ish (2^k and "
    "1.5*2^k rungs — padding waste bounded by ~33%), pow2 (pure "
    "powers of two), or exact (no shape bucketing; every distinct "
    "size builds its own entry).")

#: smallest shape bucket (one 8-row tile quantum; tiny problems share)
MIN_BUCKET = 8
#: smaller floor for right-hand-side counts (nrhs=1 traffic is common;
#: an 8-wide floor would double every solve sweep's width)
MIN_NRHS_BUCKET = 4


def bucket_dim(n: int, policy: Optional[str] = None,
               floor: int = MIN_BUCKET) -> int:
    """Round a problem/nrhs dimension up into its shape bucket."""
    n = max(int(n), 1)
    policy = (policy or _cfg.mca_get("serving.bucket") or "pow2ish")
    if policy == "exact":
        return n
    b = max(int(floor), 1)
    while b < n:
        b2 = b + b // 2          # the 1.5*2^k rung
        if policy == "pow2ish" and n <= b2:
            return b2
        b *= 2
    return b


def bucket_batch(nreq: int) -> int:
    """Round a batch size up to the next power of two (batch slots are
    cheap — identity problems — and halving the distinct batch shapes
    halves the entries built)."""
    b = 1
    while b < max(int(nreq), 1):
        b *= 2
    return b


class CacheKey(NamedTuple):
    """The full batched-program contract — two requests share an entry
    iff every field matches."""
    op: str
    n: int            # shape bucket (problem dimension)
    dtype: str
    batch: int        # batch bucket
    nrhs: int         # rhs bucket
    grid: Tuple[int, int]
    pipeline: Tuple[int, int]   # (sweep.lookahead, qr.agg_depth)
    precision: str    # ir.precision for *_ir ops, "" otherwise
    extra: Tuple = ()  # canonicalized solver kwargs


def dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype (``"float64"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def make_key(op: str, n: int, dtype, batch: int, nrhs: int,
             policy: Optional[str] = None,
             extra: Tuple = (),
             precision: Optional[str] = None) -> CacheKey:
    """Bucket a raw request shape into its cache key. Pure function of
    the arguments + the MCA tier (grid from the active mesh, pipeline
    shape from ``sweep.*``, ``ir.precision`` for IR ops) — the scheduler
    groups requests by this key. ``precision`` overrides the ambient
    ``ir.precision`` for IR ops (the admission layer's
    degrade-under-pressure rung keys its cheaper entry separately); the
    service runs the entry at the key's precision, so key and callable
    always agree."""
    from dplasma_tpu_torch.ops._sweep import sweep_params
    from dplasma_tpu_torch.parallel import mesh as pmesh
    m = pmesh.active()
    grid = (1, 1)
    if m is not None:
        grid = (int(m.shape[pmesh.ROW_AXIS]),
                int(m.shape[pmesh.COL_AXIS]))
    la, agg = sweep_params()
    prec = ""
    if op.endswith("_ir"):
        from dplasma_tpu_torch.ops.refine import ir_params
        prec, _, _ = ir_params(precision=precision)
    return CacheKey(op=op, n=bucket_dim(n, policy),
                    dtype=dtype_name(dtype),
                    batch=bucket_batch(batch),
                    nrhs=bucket_dim(nrhs, policy,
                                    floor=MIN_NRHS_BUCKET),
                    grid=grid, pipeline=(la, agg), precision=prec,
                    extra=tuple(extra))


# ------------------------------------------------------------- padding

def pad_problem(a, n_to: int):
    """Pad one ``(n, n)`` operand (a tensor, or an array) to ``(n_to,
    n_to)`` with identity blocks: zeros off-diagonal, ones on the padded
    diagonal. The padded system solves to the exact unpadded
    solution."""
    a = torch.as_tensor(a)
    n = a.shape[-1]
    if n > n_to:
        raise ValueError(f"cannot pad {n} down to {n_to}")
    if n == n_to:
        return a
    out = torch.nn.functional.pad(a, (0, n_to - n, 0, n_to - n))
    idx = torch.arange(n, n_to, device=a.device)
    out[..., idx, idx] = 1.0
    return out


def pad_rhs(b, n_to: int, nrhs_to: int):
    """Pad one ``(n, nrhs)`` right-hand side with zeros (rows AND
    columns — the padded rows belong to the identity block, the padded
    columns are discarded on scatter)."""
    b = torch.as_tensor(b)
    n, nrhs = b.shape[-2], b.shape[-1]
    if n > n_to or nrhs > nrhs_to:
        raise ValueError(f"cannot pad {tuple(b.shape)} down to "
                         f"({n_to}, {nrhs_to})")
    if n == n_to and nrhs == nrhs_to:
        return b
    return torch.nn.functional.pad(b, (0, nrhs_to - nrhs, 0, n_to - n))


# --------------------------------------------------------------- cache

@dataclasses.dataclass
class Entry:
    """One cached batched callable + its provenance."""
    fn: Callable
    key: CacheKey
    compile_s: float   # the build run's seconds
    tainted: bool      # a fault plan fired during a dispatch of it
    hits: int = 0
    #: the compiled-artifact audit of the reference; None until ROADMAP
    #: item 15 brings the auditor
    hlocheck: Optional[dict] = None


class ExecutableCache:
    """LRU cache of built batched solve callables.

    ``get(key, build, *args)`` returns the :class:`Entry` for ``key``,
    building ``build()``'s callable and running it once at ``args``'
    shapes (identity problems) on a miss. Counters (hits / misses /
    evictions / build seconds) land in ``metrics`` (``serving_cache_*``).
    """

    def __init__(self, capacity: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.capacity = max(
            capacity if capacity is not None
            else _cfg.mca_get_int("serving.cache_capacity", 32), 1)
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        #: optional flight recorder (observability.telemetry): the
        #: service points this at its ring so evictions/invalidations
        #: become structured events
        self.recorder = None
        self._d: "collections.OrderedDict[CacheKey, Entry]" = \
            collections.OrderedDict()
        # the service dispatches from caller AND timer threads: every
        # OrderedDict access holds this; builds serialize under it too
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._d

    def get(self, key: CacheKey, build: Callable[[], Callable],
            *args) -> Entry:
        """The cached callable for ``key`` (LRU-refreshed), or build
        ``build()`` against ``args`` and admit it."""
        with self._lock:
            entry = self._d.get(key)
            if entry is not None:
                self._d.move_to_end(key)
                entry.hits += 1
                self.metrics.counter("serving_cache_hits_total").inc()
                return entry
            self.metrics.counter("serving_cache_misses_total").inc()
            entry = self._compile(key, build, args)
            self._d[key] = entry
            while len(self._d) > self.capacity:
                old_key, old = self._d.popitem(last=False)
                self.metrics.counter(
                    "serving_cache_evictions_total").inc()
                if self.recorder is not None:
                    self.recorder.record(
                        "cache_evict", op=old_key.op, n=old_key.n,
                        batch=old_key.batch, hits=old.hits)
            self.metrics.gauge("serving_cache_entries").set(
                len(self._d))
            return entry

    def _compile(self, key: CacheKey, build: Callable[[], Callable],
                 args: Tuple) -> Entry:
        """Build one admission (called with ``_lock`` held): the callable,
        then one run of it at the bucket shape on identity problems
        (``A = I``, ``b = 0``) with fault taps suppressed — the kernels
        build at first use and their launch arguments are cached here,
        not in a request's dispatch. The run's seconds are the entry's
        build seconds."""
        from dplasma_tpu_torch.resilience import inject
        fn = build()
        t0 = time.perf_counter()
        a = args[0]
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        warm = [eye.expand(a.shape).contiguous()] + [
            torch.zeros_like(x) for x in args[1:]]
        with inject.suppressed():
            out = fn(*warm)
        if a.device.type == "cuda":
            torch.cuda.synchronize(a.device)
        del out
        dt = time.perf_counter() - t0
        self.metrics.counter("serving_cache_compile_seconds").inc(dt)
        return Entry(fn=fn, key=key, compile_s=dt, tainted=False)

    def invalidate(self, key: CacheKey) -> bool:
        """Drop one entry (a tainted one after a detected fault); True
        when something was evicted."""
        with self._lock:
            gone = self._d.pop(key, None) is not None
            if gone:
                self.metrics.counter(
                    "serving_cache_invalidations_total").inc()
                self.metrics.gauge("serving_cache_entries").set(
                    len(self._d))
                if self.recorder is not None:
                    self.recorder.record(
                        "cache_invalidate", op=key.op, n=key.n,
                        batch=key.batch)
            return gone

    def stats(self) -> dict:
        """The cache economics summary for the run-report ``"serving"``
        section."""
        def _c(name):
            m = self.metrics.get(name)
            return float(m.value) if m is not None else 0.0
        hits = _c("serving_cache_hits_total")
        misses = _c("serving_cache_misses_total")
        total = hits + misses
        with self._lock:
            entries = len(self._d)
        return {"entries": entries, "capacity": self.capacity,
                "hits": int(hits), "misses": int(misses),
                "evictions": int(_c("serving_cache_evictions_total")),
                "invalidations": int(
                    _c("serving_cache_invalidations_total")),
                "hit_rate": (hits / total) if total else None,
                "compile_s": _c("serving_cache_compile_seconds")}
