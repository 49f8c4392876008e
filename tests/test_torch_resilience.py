"""Port parity: the resilience layer (``dplasma_tpu_torch.resilience``:
inject, abft, guard) and the drivers' ``--abft --inject --max-retries
--run-timeout`` against the JAX package's, on the CPU.

Gates:

- the fault lottery, the element and bit positions and the corrupted
  values BITWISE the reference's (s, d, c, z; every value kind), the
  plan and schedule grammar equal;
- the taps' rate and count semantics: the same fault log for the same
  sequence of taps;
- ABFT: checksummed outputs within 1e-12 (f64) of the reference's and
  the verification reports equal (detected, located, corrected, ok),
  clean and with an injected fault;
- the ladder's action sequence, summary and lines equal for each
  classification; the health scan, the watchdog and the kernel
  fallback.

The drivers' flags are in ``test_torch_resilience_drivers.py``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.drivers import common as ref_common
from dplasma_tpu.resilience import abft as ref_abft
from dplasma_tpu.resilience import guard as ref_guard
from dplasma_tpu.resilience import inject as ref_inject
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.drivers import common, main
from dplasma_tpu_torch.kernels import blas as kb
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.resilience import abft, guard, inject
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"s": (np.float32, torch.float32), "d": (np.float64, torch.float64),
          "c": (np.complex64, torch.complex64),
          "z": (np.complex128, torch.complex128)}


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    if x.dtype.kind == "c":
        x = x.view(f"f{x.dtype.itemsize // 2}")
    return x.view(f"i{x.dtype.itemsize}")


def _rand(rng, shape, prec):
    x = rng.standard_normal(shape)
    if prec in "cz":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(DTYPES[prec][0])


# ------------------------------------------------------------ inject

@pytest.mark.parametrize("stage", ["gemm", "trsm", "potrf", "getrf"])
def test_fault_lottery_and_position_rng_are_the_references(stage):
    for seed in (3872, 7, 2 ** 31 + 5):
        for site in range(40):
            assert inject._site_u01(seed, stage, site) == \
                ref_inject._site_u01(seed, stage, site)
            a = inject._site_rng(seed, stage, site)
            b = ref_inject._site_rng(seed, stage, site)
            assert np.array_equal(a.integers(0, 2 ** 40, 8),
                                  b.integers(0, 2 ** 40, 8))


@pytest.mark.parametrize("prec", list(DTYPES))
@pytest.mark.parametrize("kind", ["bitflip", "nan", "inf", "zero"])
def test_corrupt_is_the_references_bitwise(kind, prec):
    """The same element and bit, the same corrupted value (complex: the
    real part flipped), raw bits, on many sites."""
    rng = np.random.default_rng(5)
    for site in range(12):
        x = _rand(rng, (9, 7), prec)
        want, widx = ref_inject.corrupt(
            jnp.asarray(x), kind, ref_inject._site_rng(11, "gemm", site))
        got, gidx = inject.corrupt(
            torch.from_numpy(x.copy()), kind,
            inject._site_rng(11, "gemm", site))
        assert tuple(widx) == tuple(gidx)
        np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_bitflip_of_a_scalar_and_of_every_bit():
    for bit in range(64):
        x = torch.tensor(-1.5, dtype=torch.float64)
        w = np.asarray(ref_inject._bitflip(jnp.asarray(-1.5), bit))
        np.testing.assert_array_equal(_bits(w), _bits(
            inject._bitflip(x, bit).numpy()))
    for bit in range(32):
        w = np.asarray(ref_inject._bitflip(jnp.float32(3.25), bit))
        np.testing.assert_array_equal(_bits(w), _bits(inject._bitflip(
            torch.tensor(3.25, dtype=torch.float32), bit).numpy()))


@pytest.mark.parametrize("spec", ["nan@trsm:1", "bitflip@gemm:0.25:0",
                                  "ZERO@any", "inf@potrf::3",
                                  "delay@serving:0.5:2", "reject@getrf"])
def test_parse_plan_equals_the_references(spec):
    p, r = inject.parse_plan(spec, seed=9), ref_inject.parse_plan(spec,
                                                                  seed=9)
    assert (p.kind, p.stage, p.rate, p.max_faults, p.seed) == \
        (r.kind, r.stage, r.rate, r.max_faults, r.seed)
    assert p.spec() == r.spec()


@pytest.mark.parametrize("bad", ["nan", "nan@", "gremlin@trsm:1",
                                 "nan@trsm:0", "nan@gem:1"])
def test_parse_plan_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        ref_inject.parse_plan(bad)
    with pytest.raises(ValueError):
        inject.parse_plan(bad)


def test_parse_schedule_equals_the_references():
    text = "nan@serving:1:2,off,,delay@serving:0.5:0,-,bitflip@gemm"
    p = inject.parse_schedule(text, seed=40)
    r = ref_inject.parse_schedule(text, seed=40)
    assert [(x.spec, x.plan and x.plan.spec(), x.plan and x.plan.seed)
            for x in p] == [(x.spec, x.plan and x.plan.spec(),
                             x.plan and x.plan.seed) for x in r]
    with pytest.raises(ValueError):
        inject.parse_schedule("  ")


@pytest.mark.parametrize("spec", ["nan@gemm:0.5:0", "bitflip@gemm:1:3",
                                  "inf@any:0.3:2", "zero@gemm:1"])
def test_tap_sequences_log_the_references_faults(spec):
    """20 taps of one stage (and of others, for ``any``): the same sites
    fault, at the same elements, with the same values."""
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((6, 5)) for _ in range(20)]
    stages = ["gemm", "trsm"] * 10
    plan_p = inject.parse_plan(spec, seed=17)
    plan_r = ref_inject.parse_plan(spec, seed=17)
    with inject.active(plan_p) as fp:
        outs_p = [inject.tap(s, torch.from_numpy(x.copy()))
                  for s, x in zip(stages, xs)]
    with ref_inject.active(plan_r) as fr:
        outs_r = [ref_inject.tap(s, jnp.asarray(x))
                  for s, x in zip(stages, xs)]
    assert fp == fr and len(fp) >= 1
    for p, r in zip(outs_p, outs_r):
        np.testing.assert_array_equal(_bits(r), _bits(p.numpy()))


def test_suppressed_and_behavioral_kinds():
    a = torch.ones(4, 4, dtype=torch.float64)
    with inject.active(inject.parse_plan("nan@gemm:1:0")) as f:
        with inject.suppressed():
            assert torch.isfinite(kb.dot(a, a)).all()
        assert torch.isnan(kb.dot(a, a)).sum() == 1
    assert len(f) == 1 and torch.isfinite(kb.dot(a, a)).all()
    with inject.active(inject.parse_plan("reject@trsm")) as f:
        with pytest.raises(inject.InjectedReject, match="trsm site 0"):
            kb.trsm(torch.eye(4, dtype=torch.float64), a)
        kb.trsm(torch.eye(4, dtype=torch.float64), a)   # budget spent
    assert f == [{"stage": "trsm", "site": 0, "kind": "reject"}]
    with cfg.override_scope({"chaos.delay_ms": "30"}):
        import time
        with inject.active(inject.parse_plan("delay@potrf")) as f:
            t0 = time.perf_counter()
            kb.potrf(a + 3 * torch.eye(4, dtype=torch.float64))
            assert time.perf_counter() - t0 >= 0.03
    assert f[0]["kind"] == "delay"
    # integer outputs are never corrupted
    with inject.active(inject.parse_plan("nan@gemm")) as f:
        assert torch.equal(inject.tap("gemm", torch.arange(4)),
                           torch.arange(4))
    assert f == []


@pytest.mark.parametrize("stage,call", [
    ("gemm", lambda a: kb.dot(a, a)),
    ("gemm", lambda a: kb.gemm(1.0, a, a, 0.5, a)),
    ("trsm", lambda a: kb.trsm(a + 8 * torch.eye(8, dtype=a.dtype), a)),
    ("potrf", lambda a: kb.potrf(a @ a.T + 8 * torch.eye(8,
                                                         dtype=a.dtype))),
    ("getrf", lambda a: kb.getrf_nopiv(a + 8 * torch.eye(8,
                                                         dtype=a.dtype)))])
@pytest.mark.parametrize("mode", ["auto", "always"])
def test_every_kernel_route_is_tapped(stage, call, mode):
    """Each choke point's output passes its stage's tap, on the torch
    route and on the limb route (``dd_gemm=always``); K1's route is
    tapped the same way (its wrapper's output is the tapped value)."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 8)))
    with cfg.override_scope({"dd_gemm": mode}):
        with inject.active(inject.parse_plan(f"nan@{stage}")) as f:
            out = call(a)
    assert len(f) == 1 and f[0]["stage"] == stage
    assert torch.isnan(out).sum() == 1


def test_k1_route_is_tapped():
    a = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (256, 256)).astype(np.float32))
    pk.enable(True)
    try:
        before = pk.ROUTED
        with inject.active(inject.parse_plan("inf@gemm")) as f:
            out = kb.dot(a, a)
        assert pk.ROUTED == before + 1
    finally:
        pk.enable(False)
    assert len(f) == 1 and torch.isinf(out).sum() == 1


# -------------------------------------------------------------- ABFT

def _pair(x, mb=16):
    return RTile.from_dense(jnp.asarray(x), mb, mb), \
        TileMatrix.from_dense(torch.from_numpy(x.copy()), mb, mb)


def _same_report(p, r, finite=True):
    """The verdicts; for a finite fault also the located tiles and the
    mismatch counts (a NaN spreads by each package's own sweep order and
    pivots, so its tiles are held by the verdict alone)."""
    keys = ["scheme", "detected", "corrected", "ok"]
    if finite:
        keys += ["located", "mismatches"]
    assert {k: p[k] for k in keys} == {k: r[k] for k in keys}


@pytest.fixture(scope="module")
def gemm_ops():
    rng = np.random.default_rng(0)
    M, N, K = 48, 40, 32
    return [_pair(rng.standard_normal(s)) for s in ((M, K), (K, N), (M, N))]


@pytest.mark.parametrize("spec", [None, "nan@gemm:1", "bitflip@gemm:1",
                                  "zero@gemm:1"])
def test_abft_gemm_matches_the_reference(gemm_ops, spec):
    """Checksummed product, report and corrected output: a located tile
    is recomputed, the consistent ``zero`` corruption trips the probe."""
    (Ar, Ap), (Br, Bp), (Cr, Cp) = gemm_ops
    plan = spec and (inject.parse_plan(spec, seed=5),
                     ref_inject.parse_plan(spec, seed=5))
    with (inject.active(plan[0]) if plan else _null()) as fp:
        outp = abft.gemm_checksummed(0.5, Ap, Bp, -0.3, Cp)
    with (ref_inject.active(plan[1]) if plan else _null()) as fr:
        outr = ref_abft.gemm_checksummed(0.5, Ar, Br, -0.3, Cr)
    assert fp == fr
    np.testing.assert_allclose(outp.data.numpy(), np.asarray(outr.data),
                               rtol=1e-12, atol=1e-12)
    plainp, repp = abft.gemm_verify(outp, 0.5, Ap, Bp, -0.3, Cp)
    plainr, repr_ = ref_abft.gemm_verify(outr, 0.5, Ar, Br, -0.3, Cr)
    _same_report(repp, repr_)
    np.testing.assert_allclose(plainp.data.numpy(), np.asarray(plainr.data),
                               rtol=1e-12, atol=1e-12)
    if spec in ("nan@gemm:1", "bitflip@gemm:1"):
        assert repp["corrected"] and repp["ok"]


class _null:
    def __enter__(self):
        return []

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("spec", [None, "nan@trsm:1", "bitflip@gemm:1"])
def test_abft_potrf_matches_the_reference(spec):
    from dplasma_tpu.ops import generators as ref_gen
    from dplasma_tpu_torch.ops import generators
    n, t = 64, 16
    Ar = ref_gen.plghe(float(n), n, t, seed=42, dtype=jnp.float64)
    Ap = generators.plghe(float(n), n, t, seed=42, dtype=torch.float64,
                          device="cpu")
    plan = spec and (inject.parse_plan(spec, seed=1),
                     ref_inject.parse_plan(spec, seed=1))
    with (inject.active(plan[0]) if plan else _null()) as fp:
        Lp = abft.potrf_checksummed(Ap, "L")
    with (ref_inject.active(plan[1]) if plan else _null()) as fr:
        Lr = ref_abft.potrf_checksummed(Ar, "L")
    assert fp == fr
    _, repp = abft.potrf_verify(Lp, Ap, "L")
    _, repr_ = ref_abft.potrf_verify(Lr, Ar, "L")
    _same_report(repp, repr_, finite=spec is None or "nan" not in spec)
    if spec is None:
        np.testing.assert_allclose(Lp.data.numpy(), np.asarray(Lr.data),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pivoted,spec", [
    (False, None), (False, "bitflip@trsm:1"), (False, "nan@gemm:1"),
    (True, None), (True, "bitflip@trsm:1")])
def test_abft_getrf_matches_the_reference(pivoted, spec):
    from dplasma_tpu.ops import generators as ref_gen
    from dplasma_tpu_torch.ops import generators
    n, t = 64, 16
    Ar = ref_gen.plghe(float(n), n, t, seed=43, dtype=jnp.float64)
    Ap = generators.plghe(float(n), n, t, seed=43, dtype=torch.float64,
                          device="cpu")
    plan = spec and (inject.parse_plan(spec, seed=1),
                     ref_inject.parse_plan(spec, seed=1))
    with (inject.active(plan[0]) if plan else _null()) as fp:
        augp = abft.getrf_checksummed(Ap) if pivoted \
            else abft.getrf_nopiv_checksummed(Ap)
    with (ref_inject.active(plan[1]) if plan else _null()) as fr:
        augr = ref_abft.getrf_checksummed(Ar) if pivoted \
            else ref_abft.getrf_nopiv_checksummed(Ar)
    assert fp == fr
    if pivoted:
        (Fp, permp), repp = abft.getrf_verify(augp, Ap)
        (Fr, permr), repr_ = ref_abft.getrf_verify(augr, Ar)
        np.testing.assert_array_equal(permp.numpy(), np.asarray(permr))
    else:
        Fp, repp = abft.getrf_nopiv_verify(augp, Ap)
        Fr, repr_ = ref_abft.getrf_nopiv_verify(augr, Ar)
    assert Fp.desc == Ap.desc
    _same_report(repp, repr_, finite=spec is None or "nan" not in spec)
    if spec is None:
        assert repp["ok"]
        np.testing.assert_allclose(Fp.data.numpy(), np.asarray(Fr.data),
                                   rtol=1e-12, atol=1e-12)
    else:
        assert repp["detected"] and not repp["ok"]


def test_nonfinite_tiles_and_outlier_flags_match():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((37, 29))
    x[3, 4] = np.nan
    x[30, 28] = np.inf
    assert abft.nonfinite_tiles(torch.from_numpy(x), 8, 8) == \
        ref_abft.nonfinite_tiles(jnp.asarray(x), 8, 8)
    d = rng.standard_normal(50) * 1e-14
    d[7] = 1e-3
    np.testing.assert_array_equal(abft._flag_outliers(d, 1e-12),
                                  ref_abft._flag_outliers(d, 1e-12))
    assert abft._finite_max(torch.from_numpy(x), [1.0, -7.0]) == \
        ref_abft._finite_max(jnp.asarray(x), [1.0, -7.0])


# ----------------------------------------------------- guard / ladder

@pytest.mark.parametrize("cls", [guard.CLASS_NUMERICAL, guard.CLASS_SILENT,
                                 guard.CLASS_COMPILE, guard.CLASS_TIMEOUT])
@pytest.mark.parametrize("retries", [0, 2])
def test_ladder_action_sequence_is_the_references(cls, retries,
                                                  monkeypatch):
    monkeypatch.setattr(guard, "_BACKOFF_S", 0.0)
    monkeypatch.setattr(ref_guard, "_BACKOFF_S", 0.0)
    fb = [("alt1", None), ("alt2", None)]
    p = guard.Ladder(common.IParam(max_retries=retries), "op", fb)
    r = ref_guard.Ladder(ref_common.IParam(max_retries=retries), "op", fb)
    seq_p = [p.next_action(cls) for _ in range(8)]
    seq_r = [r.next_action(cls) for _ in range(8)]
    assert [s and s[:2] for s in seq_p] == [s and s[:2] for s in seq_r]
    for lad in (p, r):
        lad.record("primary", "op", False, classification=cls)
        lad.record("retry", "op", True)
    assert p.summary(None) == r.summary(None)
    assert guard.format_lines(p.summary(None)) == \
        ref_guard.format_lines(r.summary(None))


@pytest.mark.parametrize("cls", [guard.CLASS_NUMERICAL, guard.CLASS_SILENT,
                                 guard.CLASS_COMPILE, guard.CLASS_TIMEOUT])
@pytest.mark.parametrize("injected", [False, True])
def test_advance_takes_the_kernel_rung_after_an_injected_fault_only(
        cls, injected, monkeypatch):
    """:meth:`Ladder.advance` is :meth:`next_action` with the kernel rung
    passed over unless the failed attempt carried an injected fault; the
    rung it takes demotes K1 and ``panel.kernel=pallas`` until
    :meth:`Ladder.restore`."""
    monkeypatch.setattr(guard, "_BACKOFF_S", 0.0)
    fb = [("alt1", None), ("alt2", None)]
    plain = guard.Ladder(common.IParam(max_retries=1), "op", fb)
    want = [s and s[0] for s in [plain.next_action(cls) for _ in range(6)]]
    if not injected:
        want.remove(guard.ACTION_KERNEL_FALLBACK)
        want.append(None)
    k1 = pk.enabled()
    pk.enable(True)
    try:
        with cfg.override_scope({"panel.kernel": "pallas"}):
            lad = guard.Ladder(common.IParam(max_retries=1), "op", fb)
            got, demoted = [], []
            for _ in range(6):
                nxt = lad.advance(cls, injected)
                got.append(nxt and nxt[0])
                demoted.append((pk.enabled(), cfg.mca_get("panel.kernel")))
            assert got == want
            assert (False, "chain") in demoted if injected \
                else set(demoted) == {(True, "pallas")}
            lad.restore()
            assert pk.enabled() and cfg.mca_get("panel.kernel") == "pallas"
    finally:
        pk.enable(k1)


def test_classify_health_scan_and_watchdog():
    import time
    lad = guard.Ladder(common.IParam(), "op")
    assert lad.classify({"ok": False}, None, False) == "numerical"
    assert lad.classify({"ok": True}, {"ok": False}, False) == "silent"
    assert lad.classify(None, None, True) == "timeout"
    x = torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]])
    tm = TileMatrix.from_dense(x, 1, 1)
    h = guard.health_scan((tm, torch.arange(3), [x]))
    assert h == {"nan": 2, "inf": 2, "leaves": 2, "ok": False}
    assert guard.health_scan(torch.ones(2))["ok"]
    with guard.Watchdog(0.01, "probe") as wd:
        time.sleep(0.05)
    assert wd.timed_out and wd.fired
    with guard.Watchdog(0.0, "probe") as wd:
        pass
    assert not wd.timed_out


def test_kernel_fallback_demotes_the_kernels():
    pk.enable(True)
    try:
        with cfg.override_scope({"panel.kernel": "pallas"}):
            got = guard.kernel_fallback()
            assert cfg.mca_get("panel.kernel") == "chain"
            cfg.mca_unset("panel.kernel")
        assert got == {"k1_was_enabled": True,
                       "mca": {"panel.kernel": "chain"}}
        assert not pk.enabled()
    finally:
        pk.enable(False)


def test_resilience_flags_parse_like_the_reference():
    argv = ["-N", "8", "--abft", "--inject=nan@trsm:1", "--max-retries",
            "5", "--run-timeout=2.5"]
    p, r = common.parse_arguments(argv), ref_common.parse_arguments(argv)
    assert (p.abft, p.inject, p.max_retries, p.run_timeout) == \
        (r.abft, r.inject, r.max_retries, r.run_timeout) == \
        (True, "nan@trsm:1", 5, 2.5)
    d = common.parse_arguments(["-N", "8"])
    assert (d.abft, d.inject, d.max_retries, d.run_timeout) == \
        (False, None, 2, 0.0)


def test_bad_inject_spec_exits_2_and_env_tier(capsys, monkeypatch,
                                              tmp_path):
    assert main(["testing_dpotrf", "-N", "32", "-t", "16", "--device",
                 "cpu", "--inject=bitlfip@gemm"]) == 2
    assert "bad --inject spec" in capsys.readouterr().err
    monkeypatch.setenv("DPLASMA_INJECT", "nan@trsm:1")
    rep = tmp_path / "env.json"
    assert main(["testing_dpotrf", "-N", "64", "-t", "16", "-x", "--device",
                 "cpu", f"--report={rep}"]) == 0
    r = json.load(open(rep))["resilience"][0]
    assert r["injection"]["plan"] == "nan@trsm:1:1"
    assert r["outcome"] == "remediated"
