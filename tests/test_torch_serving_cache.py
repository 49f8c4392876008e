"""Port parity: the serving cache (``dplasma_tpu_torch.serving.cache``)
against ``dplasma_tpu.serving.cache``.

``bucket_dim``, ``bucket_batch`` and ``make_key`` are pure functions of
their arguments and the MCA tier: equal over a sweep of sizes, floors,
policies and pins (the keys compared field by field, as tuples). The
padding is exact: bitwise the reference's padded arrays, and the padded
system solves to the unpadded solution. The cache's LRU and its
``serving_cache_*`` economics as the reference's. Listed differences:
an entry is the built batched callable, not an AOT executable; its
build is one run on identity problems with fault taps suppressed; the
reference's compiled-artifact audit (``Entry.hlocheck``,
``serving_hlocheck_*`` metrics) waits for ROADMAP item 15, so the
entry's audit is None and no such metric exists.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.serving import cache as ref_cache
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.observability.metrics import MetricsRegistry
from dplasma_tpu_torch.ops import refine
from dplasma_tpu_torch.resilience import inject
from dplasma_tpu_torch.serving import batched
from dplasma_tpu_torch.serving import cache
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

SIZES = list(range(1, 70)) + [96, 127, 128, 129, 191, 192, 193, 383, 384,
                              385, 640, 1000, 1024, 1100, 1536, 2047, 2048]


@pytest.mark.parametrize("policy", ["pow2ish", "pow2", "exact", None])
@pytest.mark.parametrize("floor", [cache.MIN_BUCKET, cache.MIN_NRHS_BUCKET,
                                   1])
def test_bucket_dim_equals_reference(policy, floor):
    assert [cache.bucket_dim(n, policy, floor) for n in SIZES] == \
        [ref_cache.bucket_dim(n, policy, floor) for n in SIZES]


def test_bucket_batch_and_constants_equal_reference():
    assert [cache.bucket_batch(n) for n in range(0, 70)] == \
        [ref_cache.bucket_batch(n) for n in range(0, 70)]
    assert (cache.MIN_BUCKET, cache.MIN_NRHS_BUCKET) == \
        (ref_cache.MIN_BUCKET, ref_cache.MIN_NRHS_BUCKET)
    assert cache.CacheKey._fields == ref_cache.CacheKey._fields


@pytest.mark.parametrize("pins", [{}, {"sweep.lookahead": "0"},
                                  {"qr.agg_depth": "3",
                                   "ir.precision": "bf16"},
                                  {"serving.bucket": "pow2"},
                                  {"serving.bucket": "exact"}])
def test_make_key_equals_reference(pins):
    for op in ("posv", "gesv", "posv_ir", "gesv_ir"):
        for n in (1, 7, 12, 13, 100, 384, 1000):
            for batch, nrhs in ((1, 1), (3, 2), (9, 5)):
                for dtype in (np.float32, np.float64):
                    for prec in (None, "int8", "f32x2"):
                        if prec and not op.endswith("_ir"):
                            continue
                        kw = dict(extra=(("max_iters", 3),),
                                  precision=prec)
                        with cfg.override_scope(pins), \
                                ref_cfg.override_scope(pins):
                            got = cache.make_key(op, n, dtype, batch, nrhs,
                                                 **kw)
                            want = ref_cache.make_key(op, n, dtype, batch,
                                                      nrhs, **kw)
                            assert tuple(got) == tuple(want), (got, want)
                            assert got == cache.make_key(
                                op, n, torch.float32 if dtype == np.float32
                                else torch.float64, batch, nrhs, **kw)
    assert cache.make_key("posv_ir", 10, np.float64, 3, 2).precision \
        in refine.PRECISIONS


def test_padding_is_the_reference_padding_and_exact():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((2, 6, 6))
    A = a @ a.transpose(0, 2, 1) + 6 * np.eye(6)
    b = rng.standard_normal((2, 6, 2))
    nB = cache.bucket_dim(6)
    rB = cache.bucket_dim(2, floor=cache.MIN_NRHS_BUCKET)
    Ap = cache.pad_problem(torch.from_numpy(A), nB)
    bp = cache.pad_rhs(b, nB, rB)
    assert np.array_equal(Ap.numpy(), np.asarray(
        ref_cache.pad_problem(jnp.asarray(A), nB)))
    assert np.array_equal(bp.numpy(), np.asarray(
        ref_cache.pad_rhs(jnp.asarray(b), nB, rB)))
    assert cache.pad_problem(torch.from_numpy(A), 6) is not None
    X = batched.posv_batched(torch.from_numpy(A), torch.from_numpy(b), 4)
    Xp = batched.posv_batched(Ap, bp, 4)
    assert torch.allclose(Xp[:, :6, :2], X, rtol=0, atol=1e-12)
    assert torch.all(Xp[:, 6:] == 0) and torch.all(Xp[:, :, 2:] == 0)
    with pytest.raises(ValueError):
        cache.pad_problem(torch.from_numpy(A), 4)
    with pytest.raises(ValueError):
        cache.pad_rhs(b, 6, 1)


def test_cache_lru_and_metrics_like_the_reference():
    """The reference's ``test_executable_cache_lru_and_metrics``, and the
    same ``stats()`` keys."""
    reg = MetricsRegistry()
    c = cache.ExecutableCache(capacity=2, metrics=reg)
    calls, runs = [], []

    def build_for(tag):
        def build():
            calls.append(tag)

            def fn(x):
                runs.append((tag, x.clone()))
                return x + 1
            return fn
        return build

    x = torch.full((2, 2, 2), 7.0)
    k = [cache.make_key("posv", 8 * (i + 1), np.float32, 1, 1)
         for i in range(3)]
    e0 = c.get(k[0], build_for(0), x)
    assert not e0.tainted and e0.compile_s >= 0 and e0.hlocheck is None
    # the build ran once, on an identity problem
    assert len(runs) == 1 and torch.equal(runs[0][1], torch.eye(2).expand(
        2, 2, 2))
    assert c.get(k[0], build_for(0), x) is e0      # hit
    c.get(k[1], build_for(1), x)
    c.get(k[2], build_for(2), x)                   # evicts k[0] (LRU)
    assert k[0] not in c and k[1] in c and k[2] in c and len(c) == 2
    assert calls == [0, 1, 2]
    s = c.stats()
    assert s["hits"] == 1 and s["misses"] == 3 and s["evictions"] == 1
    assert s["hit_rate"] == pytest.approx(0.25)
    assert s["compile_s"] > 0
    assert c.invalidate(k[1]) and not c.invalidate(k[1])
    assert json.loads(json.dumps(s)) == s
    ref = ref_cache.ExecutableCache(capacity=2)
    assert set(s) == set(ref.stats())
    names = {m["name"] for m in reg.snapshot()}
    assert names == {"serving_cache_hits_total",
                     "serving_cache_misses_total",
                     "serving_cache_evictions_total",
                     "serving_cache_compile_seconds",
                     "serving_cache_entries",
                     "serving_cache_invalidations_total"}


def test_build_run_suppresses_fault_taps():
    """An armed plan does not fire during an entry's build run (it is
    not a request's dispatch): the fault waits for the dispatch."""
    c = cache.ExecutableCache(capacity=4)
    key = cache.make_key("posv", 12, np.float64, 2, 1)

    def build():
        return lambda a, b: batched.posv_batched(a, b, 4)

    A = torch.eye(12, dtype=torch.float64).expand(2, 12, 12).contiguous()
    b = torch.ones(2, 12, 4, dtype=torch.float64)
    with inject.active(inject.parse_plan("nan@trsm:1:1")) as faults:
        e = c.get(key, build, A, b)
        assert inject.faults() == []
        out = e.fn(A, b)
    assert len(faults) == 1 and torch.isnan(out).any()
