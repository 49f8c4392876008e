"""The phase spans of ``dplasma_tpu_torch``: the fencing contract, self
against inclusive time, and the ``(phase, count)`` rows of the port's
eager ops against the reference's eager pass.

Phase counts are control flow: for the same op, shape and
``sweep.lookahead`` the port's sweeps must emit the reference's rows,
so a difference names a span in the wrong place or a loop that differs.
The reference runs eagerly on the CPU (its ``jit``-free route, the one
its driver's attributed pass takes), the port on CPU tensors.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.observability import phases as ref_phases
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.ops import refine as ref_refine
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import Dist, TileMatrix
from dplasma_tpu_torch.kernels import pallas_ring as pring
from dplasma_tpu_torch.observability import phases
from dplasma_tpu_torch.ops import generators, lu, potrf, qr, refine
from dplasma_tpu_torch.parallel import cyclic
from dplasma_tpu_torch.utils import config as cfg
from torch_cyclic_pairs import (GRID_2x2, GRID_2x4_K2, grids, port,
                                ref_cyclic_of)
from torch_threads import one_torch_thread  # noqa: F401


def _pair(A):
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


def _rows(led):
    return sorted((r["phase"], r["count"]) for r in led.summary())


@pytest.fixture
def fences(monkeypatch):
    """Count the calls of the single fence choke point."""
    calls = []
    real = phases._fence

    def counting(values):
        calls.append(values)
        real(values)

    monkeypatch.setattr(phases, "_fence", counting)
    return calls


# ---------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------

def _all_ops():
    A = generators.plghe(64.0, 64, 16, seed=3, device="cpu")
    G = generators.plrnt(64, 64, 16, 16, seed=4, device="cpu")
    A64 = generators.plghe(64.0, 64, 16, seed=5, dtype=torch.float64,
                           device="cpu")
    B64 = generators.plrnt(64, 2, 16, 16, seed=6, dtype=torch.float64,
                           device="cpu")
    potrf.potrf(A, "L")
    lu.getrf_1d(G)
    qr.geqrf(G)
    refine.posv_ir(A64, B64)


def test_no_fence_and_no_row_without_a_ledger(fences, monkeypatch):
    """With no ledger active a span neither fences nor times: the
    default path and the drivers' timed loop are untouched."""
    monkeypatch.setattr(time, "perf_counter", lambda: (_ for _ in ()).throw(
        AssertionError("a span timed with no ledger active")))
    assert phases.active() is None
    _all_ops()
    assert fences == []
    assert phases._nest == []


def test_every_span_fences_under_a_ledger(fences):
    with phases.profiling() as led:
        _all_ops()
    assert phases.active() is None
    assert led.summary() and len(fences) == sum(
        r["count"] for r in led.summary())
    assert all(isinstance(v, list) and v for v in fences)


def test_cpu_values_never_synchronize_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (_ for _ in (
        )).throw(AssertionError("synchronized for CPU tensors")))
    phases._fence([torch.ones(3), (torch.zeros(2), {"a": [torch.ones(1)]}),
                   5, "x", None])
    assert phases._cuda_device([[torch.ones(2)], {"k": (1.0,)}]) is None


def test_self_time_against_inclusive_time():
    with phases.profiling() as led:
        with phases.span("outer"):
            time.sleep(0.02)
            with phases.span("inner"):
                time.sleep(0.03)
            with phases.span("inner"):
                time.sleep(0.01)
    rows = {r["phase"]: r for r in led.summary()}
    assert rows["inner"]["count"] == 2 and rows["outer"]["count"] == 1
    assert rows["inner"]["measured_s"] == rows["inner"]["total_s"]
    # lower bounds are the sleeps; the upper ones only catch a child
    # time that was not subtracted (a loaded host may oversleep)
    assert 0.035 <= rows["inner"]["measured_s"] < 0.5
    assert 0.015 <= rows["outer"]["measured_s"] < \
        rows["outer"]["total_s"] - 0.035
    assert rows["outer"]["total_s"] >= rows["outer"]["measured_s"] + \
        rows["inner"]["measured_s"] - 1e-9
    assert abs(led.total() - rows["outer"]["total_s"]) < 1e-6
    assert [r["phase"] for r in led.summary()] == ["inner", "outer"]


def test_nest_stays_balanced_when_the_fence_raises(monkeypatch):
    def boom(values):
        raise RuntimeError("poisoned")

    with phases.profiling() as led:
        with phases.span("outer"):
            monkeypatch.setattr(phases, "_fence", boom)
            with pytest.raises(RuntimeError, match="poisoned"):
                with phases.span("bad") as f:
                    f(torch.ones(2))
            monkeypatch.undo()
            assert len(phases._nest) == 1
            with phases.span("after") as f:
                f(torch.ones(2))
    assert phases._nest == []
    rows = {r["phase"]: r["count"] for r in led.summary()}
    assert rows == {"outer": 1, "bad": 1, "after": 1}


def test_profiling_scopes_nest_and_restore():
    outer = phases.PhaseLedger()
    with phases.profiling(outer) as a:
        assert phases.active() is outer is a
        with phases.profiling() as b:
            with phases.span("x"):
                pass
        assert phases.active() is outer
    assert phases.active() is None
    assert _rows(b) == [("x", 1)] and outer.summary() == []


# ---------------------------------------------------------------------
# (phase, count) rows against the reference's eager pass
# ---------------------------------------------------------------------

N, NB = 64, 16
NI, NBI = 64, 32


@pytest.fixture(scope="module")
def mats():
    return {
        "spd": _pair(ref_gen.plghe(float(N), N, NB, seed=3,
                                   dtype=jnp.float32)),
        "gen": _pair(ref_gen.plrnt(N, N, NB, NB, seed=4,
                                   dtype=jnp.float32)),
        "tall": _pair(ref_gen.plrnt(N + 32, N, NB, NB, seed=2,
                                    dtype=jnp.float32)),
        "spd64": _pair(ref_gen.plghe(float(NI), NI, NBI, seed=5,
                                     dtype=jnp.float64)),
        "gen64": _pair(ref_gen.plrnt(NI, NI, NBI, NBI, seed=6,
                                     dtype=jnp.float64, diagdom=True)),
        "rhs64": _pair(ref_gen.plrnt(NI, 3, NBI, NBI, seed=7,
                                     dtype=jnp.float64)),
        "ls64": _pair(ref_gen.plrnt(NI + 32, NI, NBI, NBI, seed=8,
                                    dtype=jnp.float64)),
        "lsrhs64": _pair(ref_gen.plrnt(NI + 32, 3, NBI, NBI, seed=9,
                                       dtype=jnp.float64)),
    }


def _both_rows(ref_fn, port_fn, mca):
    with ref_cfg.override_scope(mca), ref_phases.profiling() as rl:
        jax.block_until_ready(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(
                lambda x: getattr(x, "data", x), ref_fn(),
                is_leaf=lambda x: hasattr(x, "desc"))))
    with cfg.override_scope(mca), phases.profiling() as pl:
        port_fn()
    return _rows(rl), _rows(pl)


_FACTORS = {
    "potrf_L": ("spd", lambda m: ref_potrf.potrf(m[0], "L"),
                lambda m: potrf.potrf(m[1], "L")),
    "potrf_U": ("spd", lambda m: ref_potrf.potrf(m[0], "U"),
                lambda m: potrf.potrf(m[1], "U")),
    "getrf": ("gen", lambda m: ref_lu.getrf_1d(m[0]),
              lambda m: lu.getrf_1d(m[1])),
    "getrf_tall": ("tall", lambda m: ref_lu.getrf_1d(m[0]),
                   lambda m: lu.getrf_1d(m[1])),
    "geqrf": ("gen", lambda m: ref_qr.geqrf(m[0]),
              lambda m: qr.geqrf(m[1])),
    "geqrf_tall": ("tall", lambda m: ref_qr.geqrf(m[0]),
                   lambda m: qr.geqrf(m[1])),
}


@pytest.mark.parametrize("la", [0, 1])
@pytest.mark.parametrize("op", sorted(_FACTORS))
def test_factor_rows_equal_the_reference(mats, op, la):
    key, rf, pf = _FACTORS[op]
    m = mats[key]
    want, got = _both_rows(lambda: rf(m), lambda: pf(m),
                           {"sweep.lookahead": la})
    assert got == want
    assert ("panel", -(-N // NB)) in got


def test_geqrf_aggregated_flush_rows_equal_the_reference(mats):
    m = mats["gen"]
    want, got = _both_rows(lambda: ref_qr.geqrf(m[0]),
                           lambda: qr.geqrf(m[1]),
                           {"sweep.lookahead": 1, "qr.agg_depth": 2})
    assert got == want


_SOLVERS = {
    "posv_ir": (("spd64", "rhs64"), ref_refine.posv_ir, refine.posv_ir),
    "gesv_ir": (("gen64", "rhs64"), ref_refine.gesv_ir, refine.gesv_ir),
    "gels_ir": (("ls64", "lsrhs64"), ref_refine.gels_ir, refine.gels_ir),
}


@pytest.mark.parametrize("la", [0, 1])
@pytest.mark.parametrize("solver", sorted(_SOLVERS))
@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_ir_rows_equal_the_reference(mats, solver, prec, la):
    """Solves that converge without escalating (and gels_ir's int8
    escalation, whose full-precision route is the reference's)."""
    (ka, kb), rf, pf = _SOLVERS[solver]
    a, b = mats[ka], mats[kb]
    want, got = _both_rows(lambda: rf(a[0], b[0]), lambda: pf(a[1], b[1]),
                           {"sweep.lookahead": la, "ir.precision": prec})
    assert got == want
    assert ("factor", 1) in got and ("solve", 1) in got
    if prec == "int8":
        assert any(p == "quantize" for p, _ in got)


def test_escalating_solve_holds_its_derived_counts(monkeypatch):
    """posv_ir's and gesv_ir's escalation differ from the reference on
    purpose: the port refines the full-precision solve (ops/refine.py
    module docstring), so its ``escalate`` span encloses that
    refinement's own ``residual`` and ``correct`` spans. Derived counts,
    for either package: ``residual`` = the backward errors each
    ``ir_solve`` call measured, ``correct`` = the corrections each
    applied, summed over the calls; every other row equal between the
    two."""
    a = np.random.default_rng(12).standard_normal((NI, NI))
    from dplasma_tpu.descriptors import TileMatrix as RTile
    A = _pair(RTile.from_dense(jnp.asarray(a), NBI, NBI))
    B = _pair(ref_gen.plrnt(NI, 2, NBI, NBI, seed=13, dtype=jnp.float64))
    calls = {"port": [], "ref": []}

    def wrap(mod, tag):
        real = mod.ir_solve

        def recording(*args, **kw):
            x, info = real(*args, **kw)
            bwd = np.asarray(info["backward_errors"])
            calls[tag].append((int((bwd >= 0).sum()),
                               int(np.asarray(info["iterations"]))))
            return x, info
        monkeypatch.setattr(mod, "ir_solve", recording)

    wrap(refine, "port")
    wrap(ref_refine, "ref")
    want, got = _both_rows(lambda: ref_refine.gesv_ir(A[0], B[0]),
                           lambda: refine.gesv_ir(A[1], B[1]),
                           {"ir.precision": "bf16", "ir.max_iters": 3})
    gd, wd = dict(got), dict(want)
    assert gd["escalate"] == wd["escalate"] == 1
    for tag, rows in (("port", gd), ("ref", wd)):
        assert rows["residual"] == sum(r for r, _ in calls[tag])
        assert rows["correct"] == sum(c for _, c in calls[tag])
    assert len(calls["port"]) == 2 and len(calls["ref"]) == 1
    assert {k: v for k, v in gd.items() if k not in ("residual",
                                                     "correct")} == \
        {k: v for k, v in wd.items() if k not in ("residual", "correct")}


# ---------------------------------------------------------------------
# the cyclic factorizations' ring span
# ---------------------------------------------------------------------

def _cyclic_input(op, dist, n=64, nb=16):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((n, n))
    if op == "potrf":
        a = a @ a.T + n * np.eye(n)
    a = a.astype(np.float32)        # K5 moves f32 and bf16
    with grids(dist):
        C = port(ref_cyclic_of(a, nb, dist))
    return C


_CYC = {"potrf": cyclic.potrf_cyclic, "getrf": cyclic.getrf_cyclic,
        "geqrf": cyclic.geqrf_cyclic}


@pytest.mark.parametrize("ring", ["on", "off"])
@pytest.mark.parametrize("op", sorted(_CYC))
def test_cyclic_ops_emit_ring_once_under_a_ledger(op, ring, monkeypatch):
    dist = GRID_2x2
    C = _cyclic_input(op, dist)
    probes = []
    real = cyclic._panel_bcast_probe
    monkeypatch.setattr(cyclic, "_panel_bcast_probe",
                        lambda *a, **k: probes.append(a) or real(*a, **k))
    with grids(dist, {"ring.enable": ring}):
        _CYC[op](C)
        assert probes == []
        routed = pring.ROUTED
        with phases.profiling() as led:
            _CYC[op](C)
        k5 = pring.ROUTED - routed
        routed = pring.ROUTED
        _CYC[op](C)
        k5_plain = pring.ROUTED - routed
    assert _rows(led) == [("ring", 1)] and len(probes) == 1
    kt, P = C.desc.MT, dist["P"]
    # the probe's K5 broadcasts: one a step and a process row
    assert k5 - k5_plain == (kt * P if ring == "on" else 0)


@pytest.mark.parametrize("dist", [GRID_2x2, GRID_2x4_K2],
                         ids=["2x2", "2x4k2"])
@pytest.mark.parametrize("ring", [False, True])
def test_panel_bcast_probe_equals_the_reference(dist, ring):
    """The probe's per-rank sums equal the reference's psum program's
    (the ring route moves the same bytes)."""
    rng = np.random.default_rng(22)
    a = rng.standard_normal((96, 96))
    with grids(dist):
        R = ref_cyclic_of(a, 16, dist)
        want = np.asarray(ref_cyclic._panel_bcast_probe_jit(
            R.data, R.desc, ref_cyclic.pmesh.active(), False, 0))
        C = port(R)
        got = cyclic._panel_bcast_probe(C, ring, 1 if ring else 0)
    for p in range(dist["P"]):
        for q in range(dist["Q"]):
            assert np.array_equal(got[p][q].numpy(), want[p, q])


def test_ring_span_needs_a_ledger_only():
    C = _cyclic_input("getrf", GRID_2x2)
    calls = []
    real = cyclic._panel_bcast_probe
    cyclic._panel_bcast_probe = lambda *a, **k: calls.append(1) or real(
        *a, **k)
    try:
        cyclic._ring_span(C, False, 0)
        assert calls == []
        with phases.profiling() as led:
            cyclic._ring_span(C, False, 0)
    finally:
        cyclic._panel_bcast_probe = real
    assert calls == [1] and _rows(led) == [("ring", 1)]
    assert Dist(P=2, Q=2).P == C.desc.dist.P


# ---------------------------------------------------------------------
# chip_smoke.py phase 19's derived rows against the port's ledger
# ---------------------------------------------------------------------

@pytest.mark.parametrize("la", [0, 1, 2])
@pytest.mark.parametrize("shape", [(64, 64, 16), (96, 64, 16),
                                   (128, 128, 32)])
@pytest.mark.parametrize("agg", [1, 2, 4])
def test_phase19_derived_rows_equal_the_ledger(shape, la, agg):
    """The rows chip_smoke.py gates the card's phase tables on
    (``sweep_rows``, ``potrf_rows``) are the port's control flow."""
    import chip_smoke as cs
    M, N, nb = shape
    G = generators.plrnt(M, N, nb, nb, seed=4, device="cpu")
    mca = {"sweep.lookahead": la, "qr.agg_depth": agg}
    kt, nt = min(M, N) // nb, N // nb
    with cfg.override_scope(mca):
        with phases.profiling() as led:
            lu.getrf_1d(G)
        want = cs.sweep_rows(kt, nt, la, 1)
        want["assemble"] += 1
        assert dict(_rows(led)) == want
        with phases.profiling() as led:
            qr.geqrf(G)
        want = cs.sweep_rows(kt, nt, la, agg)
        want["assemble"] += 1
        assert dict(_rows(led)) == want
        if M == N:
            A = generators.plghe(float(N), N, nb, seed=3, device="cpu")
            with phases.profiling() as led:
                potrf.potrf(A, "L")
            assert dict(_rows(led)) == cs.potrf_rows(nt, la)


def test_phase19_ir_rows_equal_the_ledger():
    import chip_smoke as cs
    A = generators.plghe(96.0, 96, 32, seed=5, dtype=torch.float64,
                         device="cpu")
    B = generators.plrnt(96, 2, 32, 32, seed=6, dtype=torch.float64,
                         device="cpu")
    with cfg.override_scope({"ir.precision": "f32"}), \
            phases.profiling() as led:
        _, info = refine.posv_ir(A, B)
    s = refine.summarize(info, op="testing_dposv_ir")
    want = cs.potrf_rows(3, 1)
    want.update(factor=1, solve=1, residual=len(s["backward_errors"]),
                correct=s["iterations"])
    assert dict(_rows(led)) == want
