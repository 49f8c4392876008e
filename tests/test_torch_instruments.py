"""Port parity: the drivers' instruments of ``dplasma_tpu_torch`` against
``dplasma_tpu`` — the metrics registry, the run-report's statistics and
reader, the DTPUPROF1 trace (each package reads the other's files), the
Chrome conversions, the comm-volume model, the roofline (peaks,
expectations, phase model, attribution, op entries), the owner maps and
the MCA keys the instruments read.

All of it is arithmetic on the same inputs, so every comparison is
exact. The roofline is held with every probed key in the peaks dict, so
the port's own fallback ratios (``roofline.WP_MXU``) never decide a
compared number, and d and z under ``dd_gemm=always``, where the port
prices as the reference does; native d (the card's default route) is
priced at ``f64_gflops`` and held to that on its own.
"""
import json
import math

import numpy as np
import pytest

from dplasma_tpu import native as ref_native
from dplasma_tpu.descriptors import Dist as RDist
from dplasma_tpu.observability import chrome as ref_chrome
from dplasma_tpu.observability import comm as ref_comm
from dplasma_tpu.observability import metrics as ref_metrics
from dplasma_tpu.observability import phases as ref_phases
from dplasma_tpu.observability import report as ref_report
from dplasma_tpu.observability import roofline as ref_rl
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu.utils import profiling as ref_prof
from dplasma_tpu_torch import native
from dplasma_tpu_torch.descriptors import Dist
from dplasma_tpu_torch.observability import chrome, comm, metrics, phases
from dplasma_tpu_torch.observability import report, roofline
from dplasma_tpu_torch.utils import config as cfg
from dplasma_tpu_torch.utils import profiling
from torch_cyclic_pairs import DISTS, GRID_1x3
from torch_threads import one_torch_thread  # noqa: F401

#: every probed key (chip_smoke.py phase 19's peaks file) plus the
#: reference's f32x2 rate, so no fallback ratio is ever consulted
PEAKS = {"mxu_gflops": 1234.5, "hbm_gbps": 2800.0, "ici_gbps": 2700.0,
         "host_gbps": 50.0, "latency_us": 4.5,
         "f32_highest_gflops": 60000.0, "bf16_gflops": 650000.0,
         "int8_gops": 950000.0, "f64equiv_bound_gflops": 33000.0,
         "f32x2_gflops": 30000.0, "f64_gflops": 52000.0}


@pytest.fixture
def dd_always():
    with cfg.override_scope({"dd_gemm": "always"}), \
            ref_cfg.override_scope({"dd_gemm": "always"}):
        yield


# ---------------------------------------------------------------------
# metrics, run statistics, report reader
# ---------------------------------------------------------------------

def _drive_registry(reg, n_obs):
    reg.counter("runs_total", op="spotrf", prec="s").inc(3)
    reg.counter("runs_total", op="spotrf", prec="s").inc()
    reg.gauge("gflops", op="dpotrf").set(812.5)
    reg.gauge("gflops", op="dpotrf").add(-2.25)
    reg.gauge("depth", op="a").set(7)
    h = reg.histogram("run_seconds", op="spotrf", prec="s")
    rng = np.random.default_rng(11)
    for v in rng.lognormal(-3.0, 1.0, n_obs):
        h.observe(float(v))
    h.observe(0.0)
    h.observe(-1.5)
    reg.histogram("empty", op="x")
    return reg


@pytest.mark.parametrize("n_obs", [0, 5, 511, 2000])
def test_metrics_snapshots_equal(n_obs):
    got = _drive_registry(metrics.MetricsRegistry(), n_obs).snapshot()
    want = _drive_registry(ref_metrics.MetricsRegistry(), n_obs).snapshot()
    assert got == want


def test_metrics_errors_and_percentiles_equal():
    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("y").inc(-1)
        assert reg.get("z") is None
    hs = [mod.Histogram() for mod in (metrics, ref_metrics)]
    for h in hs:
        for v in range(3000):
            h.observe(1.0 + v * 0.01)
    for p in (0, 1, 50, 99, 100):
        assert hs[0].percentile(p) == hs[1].percentile(p)
    assert hs[0].bucket_count() == hs[1].bucket_count()


@pytest.mark.parametrize("runs", [[], [0.5], [3.0, 1.0, 2.0],
                                  [0.1 * i for i in range(1, 600)]])
def test_run_stats_equal(runs):
    assert report.run_stats(runs) == ref_report.run_stats(runs)


def test_reports_read_each_other(tmp_path):
    docs = {}
    for tag, mod in (("port", report), ("ref", ref_report)):
        rep = mod.RunReport("testing_spotrf")
        rep.add_op("testing_spotrf", prec="s", flops=1e9, runs_s=[0.2, 0.1],
                   gflops=10.0, warmup_s=0.3)
        rep.add_check("POTRF", 0.5, True)
        rep.add_refine({"op": "posv_ir", "iterations": 2})
        rep.add_roofline({"op": "testing_spotrf"})
        rep.pipeline = {"sweep.lookahead": 1}
        rep.extra["peaks"] = dict(PEAKS)
        path = str(tmp_path / f"{tag}.json")
        rep.write(path)
        docs[tag] = path
    for reader in (report.load_report, ref_report.load_report):
        a, b = reader(docs["port"]), reader(docs["ref"])
        assert set(a) == set(b)
        for key in set(a) - {"env", "created_unix_ns"}:
            assert a[key] == b[key], key
    assert report.REPORT_SCHEMA == ref_report.REPORT_SCHEMA == 18
    env = report.load_report(docs["port"])["env"]
    assert env["backend"] == "cpu" and "torch" in env and "jax" not in env
    newer = tmp_path / "newer.json"
    newer.write_text(json.dumps({"schema": 19}))
    for reader in (report.load_report, ref_report.load_report):
        with pytest.raises(ValueError):
            reader(str(newer))


# ---------------------------------------------------------------------
# DTPUPROF1
# ---------------------------------------------------------------------

def _fill(prof):
    prof.save_info("driver", "testing_spotrf")
    prof.save_dinfo("GFLOPS:testing_spotrf", 123.25)
    prof.add_event("enq:testing_spotrf", 100, 100)
    prof.add_event("warmup:testing_spotrf", 200, 900)
    prof.add_event("run[0]:testing_spotrf", 1000, 1800, flops=1e9,
                   track=1)
    prof.add_event("phase:ünïcode", 1900, 2500, flops=0.5, track=3)
    return prof


def test_trace_files_read_both_ways(tmp_path):
    mine, theirs = str(tmp_path / "port.prof"), str(tmp_path / "ref.prof")
    _fill(profiling.Profile(rank=2)).write(mine)
    _fill(ref_prof.Profile(rank=2)).write(theirs)
    for path in (mine, theirs):
        ev_p, info_p = native.read_trace(path)
        ev_r, info_r = ref_native.read_trace(path)
        assert ev_p == ev_r and info_p == info_r
        assert profiling.decode_wire_events(ev_p) == \
            ref_prof.decode_wire_events(ev_r)
        lp = profiling.Profile.load(path)
        lr = ref_prof.Profile.load(path)
        assert lp.events == lr.events and lp.info == lr.info
        assert lp.rank == lr.rank == 2
    # the same profile content gives the same bytes, but for the fields
    # each instance stamps (cwd, start_time) — drop them and compare
    a, b = profiling.Profile(rank=0), ref_prof.Profile(rank=0)
    a.info.clear()
    b.info.clear()
    _fill(a).write(mine)
    _fill(b).write(theirs)
    with open(mine, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()


def test_truncated_trace_read_alike(tmp_path):
    path = str(tmp_path / "torn.prof")
    _fill(profiling.Profile()).write(path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-5])
    for mod in (native, ref_native):
        with pytest.raises(EOFError):
            mod.read_trace(path)
    assert native.read_trace(path, strict=False) == \
        ref_native.read_trace(path, strict=False)
    with open(path, "wb") as f:
        f.write(b"NOTATRACE")
    for mod in (native, ref_native):
        with pytest.raises(ValueError):
            mod.read_trace(path)


def test_trace_kernels_read_at_call_time(monkeypatch, capsys):
    monkeypatch.delenv("DPLASMA_TRACE_KERNELS", raising=False)
    profiling.printlog("k %d", 1)
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("DPLASMA_TRACE_KERNELS", "1")
    assert profiling.trace_kernels_enabled()
    profiling.printlog("k %d", 2)
    assert capsys.readouterr().out == "[dplasma_tpu] k 2\n"
    monkeypatch.setenv("DPLASMA_TRACE_KERNELS", "x")
    assert not profiling.trace_kernels_enabled()
    profiling.set_trace_kernels(True)
    try:
        assert profiling.trace_kernels_enabled()
    finally:
        profiling.set_trace_kernels(None)
    assert not profiling.trace_kernels_enabled()


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with profiling.torch_trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in str(e.get("name", "")) for e in doc["traceEvents"])


# ---------------------------------------------------------------------
# Chrome conversions
# ---------------------------------------------------------------------

_EVENTS = [("enq:x", 1000, 1000, 0.0, 0), ("warmup:x", 1500, 4000, 0.0, 0),
           ("run[0]:x", 5000, 9000, 2e9, 1), ("phase:x", 9500, 12000,
                                                  0.0, 0)]
_SPANS = {"rank": 1, "spans": [
    {"name": "request", "t0_ns": 800, "t1_ns": 7000, "track": 2,
     "request": 7, "parent": -1, "attrs": {"op": "posv"}},
    {"name": "solve", "t0_ns": 900, "t1_ns": 5000, "track": 2,
     "parent": 0}]}
_ROWS = [{"phase": "panel", "count": 8, "measured_s": 0.002,
          "total_s": 0.002},
         {"phase": "far_flush", "count": 6, "measured_s": 0.001,
          "total_s": 0.001}]
_FLIGHT = {"recorded": 2, "dropped": 0, "events": [
    {"seq": 0, "t_ns": 700, "kind": "op_start", "op": "x"},
    {"seq": 1, "kind": "untimed"}]}
_DEVPROF = {"backend": "synthetic", "categories": {"compute": 0.01,
                                                   "ici": 0.002},
            "collectives": [{"cls": "psum@q", "count": 4,
                             "measured_s": 0.001, "achieved_frac": 0.5}]}


@pytest.mark.parametrize("events", [_EVENTS, [e[:4] for e in _EVENTS], []])
def test_profile_to_chrome_equal(events):
    info = {"rank": "3", "driver": "x"}
    assert chrome.profile_to_chrome(events, info, name="n") == \
        ref_chrome.profile_to_chrome(events, info, name="n")


def test_spans_and_merge_to_chrome_equal():
    assert chrome.spans_to_chrome(_SPANS["spans"], rank=1) == \
        ref_chrome.spans_to_chrome(_SPANS["spans"], rank=1)
    kw = dict(profiles=[(_EVENTS, {"rank": "0"}), (_EVENTS, {"rank": "0",
                                                              "source": "b"})],
              span_docs=[_SPANS], phase_tables=[("spotrf", _ROWS)],
              flight_docs=[_FLIGHT], devprof_tables=[("op", _DEVPROF)],
              name="m")
    assert chrome.merge_to_chrome(**kw) == ref_chrome.merge_to_chrome(**kw)
    assert chrome.merge_to_chrome() == ref_chrome.merge_to_chrome()


# ---------------------------------------------------------------------
# owner maps and the comm-volume model
# ---------------------------------------------------------------------

_GRIDS = DISTS + [GRID_1x3, dict(P=1, Q=1)]


@pytest.mark.parametrize("dist", _GRIDS, ids=lambda d: "x".join(
    str(d.get(k, "")) for k in ("P", "Q", "kp")))
def test_owner_maps_equal(dist):
    d, rd = Dist(**dist), RDist(**dist)
    assert np.array_equal(native.rank_grid(d, 7, 9),
                          ref_native.rank_grid(rd, 7, 9))
    assert [native.rank_of(d, i, j) for i in range(7) for j in range(9)] \
        == [ref_native.rank_of(rd, i, j) for i in range(7) for j in range(9)]


def test_op_class_table_equal():
    assert comm.OP_CLASS == ref_comm.OP_CLASS


@pytest.mark.parametrize("dist", _GRIDS, ids=lambda d: "x".join(
    str(d.get(k, "")) for k in ("P", "Q", "kp")))
@pytest.mark.parametrize("shape", [(512, 512, 1, 64, 64, 4),
                                   (700, 300, 130, 64, 64, 8),
                                   (96, 200, 50, 32, 32, 16)])
def test_comm_volume_model_equal(dist, shape):
    M, N, K, mb, nb, item = shape
    d, rd = Dist(**dist), RDist(**dist)
    for op in list(comm.OP_CLASS) + ["lanm2", "heev_2stage"]:
        got = comm.comm_volume_model(op, M, N, K, mb, nb, item, d)
        want = ref_comm.comm_volume_model(op, M, N, K, mb, nb, item, rd)
        assert got == want, op


def test_comm_dag_walk_cap_equal():
    d, rd = Dist(P=2, Q=2), RDist(P=2, Q=2)
    got = comm.comm_volume_model("getrf", 40000, 40000, 1, 128, 128, 4, d)
    want = ref_comm.comm_volume_model("getrf", 40000, 40000, 1, 128, 128,
                                      4, rd)
    assert got == want and got["dag_model"] is None


# ---------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------

def test_roofline_tables_equal():
    assert roofline.DEFAULT_PEAKS == ref_rl.DEFAULT_PEAKS
    assert roofline.BOUNDS == ref_rl.BOUNDS
    assert roofline.REFINE_CLASSES == ref_rl.REFINE_CLASSES
    assert roofline._BENCH_MXU_KEY == ref_rl._BENCH_MXU_KEY
    assert set(ref_rl._AUX_RATE_KEYS) < set(roofline._AUX_RATE_KEYS)
    assert {k: v[0] for k, v in roofline.WP_MXU.items()} == \
        {k: v[0] for k, v in ref_rl.WP_MXU.items()}


@pytest.mark.parametrize("demand", [
    dict(flops=1e12), dict(hbm_bytes=5e9), dict(ici_bytes=1e9),
    dict(dispatches=1000), dict(host_bytes=2e10),
    dict(flops=1e9, hbm_bytes=1e9, ici_bytes=1e9, dispatches=3,
         host_bytes=1e9), dict()])
@pytest.mark.parametrize("peaks", [None, PEAKS])
def test_expected_seconds_equal(demand, peaks):
    assert roofline.expected_seconds(peaks=peaks, **demand) == \
        ref_rl.expected_seconds(peaks=peaks, **demand)


def _without_native_rate(peaks):
    return {k: v for k, v in peaks.items() if k != "f64_gflops"}


@pytest.mark.parametrize("prec", ["s", "c", "d", "z"])
@pytest.mark.parametrize("wrap", ["raw", "doc", "report", "partial"])
def test_resolve_peaks_equal(tmp_path, dd_always, prec, wrap):
    raw = dict(PEAKS)
    if wrap == "partial":
        raw = {"hbm_gbps": 9.0, "int8_gops": 7.0, "f64equiv_bound_gflops":
               3.0, "f32_highest_gflops": 11.0, "junk": "x"}
    doc = {"raw": raw, "partial": raw, "doc": {"peaks": raw},
           "report": {"schema": 18, "extra": {"peaks": raw}}}[wrap]
    path = tmp_path / "peaks.json"
    path.write_text(json.dumps(doc))
    got, src = roofline.resolve_peaks(str(path), prec=prec)
    want, wsrc = ref_rl.resolve_peaks(str(path), prec=prec)
    assert src == wsrc
    assert _without_native_rate(got) == want
    assert got.get("f64_gflops") == raw.get("f64_gflops")
    assert roofline.resolve_peaks(None, prec) == \
        ref_rl.resolve_peaks(None, prec)


def test_resolve_peaks_prices_native_d_at_the_fp64_rate(tmp_path):
    """Off the dd route (the card's default), d and z take the probed
    native FP64 rate; s and c are unchanged."""
    no_mxu = {k: v for k, v in PEAKS.items() if k != "mxu_gflops"}
    path = tmp_path / "peaks.json"
    path.write_text(json.dumps({"peaks": no_mxu}))
    for prec in ("d", "z"):
        got, _ = roofline.resolve_peaks(str(path), prec=prec)
        assert got["mxu_gflops"] == PEAKS["f64_gflops"]
        with cfg.override_scope({"dd_gemm": "always"}):
            got, _ = roofline.resolve_peaks(str(path), prec=prec)
        assert got["mxu_gflops"] == PEAKS["f64equiv_bound_gflops"]
    got, _ = roofline.resolve_peaks(str(path), prec="s")
    assert got["mxu_gflops"] == PEAKS["f32_highest_gflops"]
    # an explicit mxu_gflops wins over any probed key
    path.write_text(json.dumps(PEAKS))
    assert roofline.resolve_peaks(str(path), "d")[0]["mxu_gflops"] == \
        PEAKS["mxu_gflops"]


@pytest.mark.parametrize("content", [None, "not json", "[1, 2]",
                                     '{"peaks": [1, 2]}'])
def test_unreadable_peaks_file_raises_alike(tmp_path, content):
    path = tmp_path / "bad.json"
    if content is not None:
        path.write_text(content)
    errs = []
    for mod in (roofline, ref_rl):
        with pytest.raises((OSError, ValueError)) as ei:
            mod.resolve_peaks(str(path), "s")
        errs.append(type(ei.value))
    assert errs[0] is errs[1]


@pytest.mark.parametrize("op", ["potrf", "getrf", "geqrf", "gemm", None])
@pytest.mark.parametrize("la,agg", [(0, 1), (1, 1), (2, 4), (1, 3)])
@pytest.mark.parametrize("pker", [None, "chain", "tree", "pallas"])
def test_phase_model_equal(op, la, agg, pker):
    for M, N, nb, grid in ((1024, 1024, 128, None), (1000, 700, 64, (2, 2)),
                           (8192, 8192, 256, (1, 3))):
        kw = dict(lookahead=la, agg_depth=agg, panel_kernel=pker, grid=grid)
        assert roofline.phase_model(op, M, N, nb, 4, **kw) == \
            ref_rl.phase_model(op, M, N, nb, 4, **kw)


def test_phase_model_resolves_the_panel_kernel_from_mca():
    for pk in ("pallas", "tree", "rec"):
        with cfg.override_scope({"panel.kernel": pk}), \
                ref_cfg.override_scope({"panel.kernel": pk}):
            for op in ("getrf", "geqrf"):
                assert roofline.phase_model(op, 2048, 2048, 256, 4) == \
                    ref_rl.phase_model(op, 2048, 2048, 256, 4)


@pytest.mark.parametrize("op", ["posv_ir", "gesv_ir", "gels_ir"])
@pytest.mark.parametrize("prec", ["int8", "bf16", "f32", "f32x2"])
def test_refine_phase_model_equal(dd_always, op, prec):
    M = 3000 if op == "gels_ir" else 2000
    with cfg.override_scope({"ir.precision": prec}), \
            ref_cfg.override_scope({"ir.precision": prec}):
        got = roofline.phase_model(op, M, 2000, 256, 8, nrhs=4, peaks=PEAKS)
        want = ref_rl.phase_model(op, M, 2000, 256, 8, nrhs=4, peaks=PEAKS)
    assert got == want
    for p in ("int8", "bf16", "f32", "f32x2"):
        assert roofline.wp_mxu_gflops(PEAKS, p) == \
            ref_rl.wp_mxu_gflops(PEAKS, p)


def test_native_residual_priced_at_the_limb_bound():
    """Off the dd route the IR residual (always a limb product) keeps
    the f64-equivalent rate while mxu_gflops is the native rate."""
    got = roofline.refine_phase_model("posv_ir", 2000, 2000, 4, 8, "f32",
                                      PEAKS)
    assert got["residual"]["mxu_gflops"] == PEAKS["f64equiv_bound_gflops"]
    with cfg.override_scope({"dd_gemm": "always"}):
        got = roofline.refine_phase_model("posv_ir", 2000, 2000, 4, 8,
                                          "f32", PEAKS)
    assert "mxu_gflops" not in got["residual"]


def test_ring_and_stream_demands_equal():
    for op in ("potrf", "getrf", "geqrf", "gemm"):
        for grid in ((2, 2), (1, 3), (3, 1), (1, 1)):
            assert roofline.ring_phase_demand(op, 2048, 2048, 256, 4,
                                              grid) == \
                ref_rl.ring_phase_demand(op, 2048, 2048, 256, 4, grid)
    for b in (0, None, -1.0, 3e9):
        assert roofline.stream_phase_demand(b) == \
            ref_rl.stream_phase_demand(b)


def _ledgers(rows):
    a, b = phases.PhaseLedger(), ref_phases.PhaseLedger()
    for name, secs, total in rows:
        a.add(name, secs, total)
        b.add(name, secs, total)
    return a, b


_LEDGER = [("panel", 0.004, None), ("panel", 0.003, None),
           ("far_flush", 0.01, None), ("factor", 0.001, 0.05),
           ("residual", 0.002, None), ("residual", 0.002, None),
           ("ring", 0.0005, None), ("mystery", 0.0, None),
           ("quantize", 0.001, None), ("solve", 0.0007, None)]


@pytest.mark.parametrize("op", ["potrf", "getrf", "posv_ir", "gels_ir"])
def test_attribute_phases_equal(dd_always, op):
    a, b = _ledgers(_LEDGER)
    assert a.summary() == b.summary() and a.total() == b.total()
    with cfg.override_scope({"ir.precision": "int8"}), \
            ref_cfg.override_scope({"ir.precision": "int8"}):
        model = ref_rl.phase_model(op, 1024, 1024, 128, 8, nrhs=2,
                                   peaks=PEAKS, grid=(2, 2))
    for peaks in (PEAKS, None):
        assert roofline.attribute_phases(a, model, peaks) == \
            ref_rl.attribute_phases(b, model, peaks)
    assert roofline.attribute_phases(a, None) == \
        ref_rl.attribute_phases(b, None)


@pytest.mark.parametrize("measured", [0.05, 0.0])
def test_op_roofline_equal(measured):
    d, rd = Dist(P=2, Q=2), RDist(P=2, Q=2)
    for op in ("potrf", "getrf", "gemm", "heev"):
        c = comm.comm_volume_model(op, 1024, 1024, 512, 128, 128, 4, d)
        rc = ref_comm.comm_volume_model(op, 1024, 1024, 512, 128, 128, 4,
                                        rd)
        got = roofline.op_roofline("testing_s" + op, comm.OP_CLASS.get(op),
                                   1024, 1024, 512, 4, 7e11, c, measured,
                                   PEAKS, "file:x")
        want = ref_rl.op_roofline("testing_s" + op,
                                  ref_comm.OP_CLASS.get(op), 1024, 1024,
                                  512, 4, 7e11, rc, measured, PEAKS,
                                  "file:x")
        assert got == want
        assert got["achieved_frac"] is None or math.isfinite(
            got["achieved_frac"])


# ---------------------------------------------------------------------
# MCA keys the instruments read
# ---------------------------------------------------------------------

@pytest.mark.parametrize("key", ["sweep.lookahead", "qr.agg_depth",
                                 "lu.agg_depth", "panel.kernel",
                                 "panel.tree_leaf", "panel.rec_base",
                                 "ring.enable", "ring.chunks",
                                 "ir.precision", "dd_gemm"])
def test_instrument_mca_keys_registered_alike(key):
    """Every MCA key the driver's pipeline section, the phase model and
    the d rate read is registered, with the reference's default."""
    import dplasma_tpu.kernels.pallas_ring  # noqa: F401 (registers ring.*)
    import dplasma_tpu.kernels.panels  # noqa: F401 (registers panel.*)
    import dplasma_tpu.ops.refine  # noqa: F401
    import dplasma_tpu_torch.kernels.pallas_ring  # noqa: F401
    import dplasma_tpu_torch.kernels.panels  # noqa: F401
    assert key in cfg._MCA_REGISTRY
    if key in ref_cfg._MCA_REGISTRY:
        assert cfg.mca_get(key) == ref_cfg.mca_get(key)
