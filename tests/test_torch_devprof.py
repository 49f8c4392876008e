"""The port's devprof (``observability/devprof.py``, the schedule part of
``analysis/spmdcheck.py`` and ``analysis/hlo_names.py``) against the
reference: ``attribute`` within 1e-12 relative on potrf, getrf, geqrf
and gemm over the grids 1×1, 2×2, 1×4, 4×1 and 2×3, ring on and off,
``kt`` set and unset; ``ingest`` on hand-made timelines (a straggler,
a dropped class, a count mismatch, an ici-floor case); the schedule and
the op-name bins on every reference case; the ``torch`` backend's event
converter on a fabricated ``torch.profiler`` trace (bins, the best
run's window, K5's classes and rings); and ``--devprof`` on the
drivers of both packages.

The reference's critical-path walk never ends on a zero-width span,
which a 1×Q or P×1 grid's synthetic timeline has (the size-1 axis's
classes price at 0 bytes): on those grids the reference runs with the
port's walk in its place, which is the same walk on spans of positive
width (held on the other grids and on hand-made timelines).
"""
import itertools
import pathlib

import pytest
import torch

from dplasma_tpu.analysis import hlo_names as ref_names
from dplasma_tpu.analysis import spmdcheck as ref_spmd
from dplasma_tpu.drivers import main as ref_main
from dplasma_tpu.observability import devprof as ref_dp
from dplasma_tpu_torch.analysis import hlo_names, spmdcheck
from dplasma_tpu_torch.drivers import common, main
from dplasma_tpu_torch.observability import devprof as dp
from dplasma_tpu_torch.observability import report as port_report
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent

OPS = ("potrf", "getrf", "geqrf", "gemm")
GRIDS = ((1, 1), (2, 2), (1, 4), (4, 1), (2, 3))
REL = 1e-12


def _close(a, b, path="entry"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == b or abs(a - b) <= REL * max(abs(a), abs(b)), \
            (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def ref_walk(monkeypatch, request):
    """The reference with the port's critical-path walk on the grids
    whose synthetic timeline has zero-width spans."""
    grid = request.node.callspec.params.get("grid", (2, 2))
    if 1 in grid and grid != (1, 1):
        monkeypatch.setattr(ref_dp, "_critical_path", dp._critical_path)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("op", OPS)
def test_attribute_equals_the_reference(op, grid, ref_walk):
    for ring, kt, (m, n, nb) in itertools.product(
            (False, True), (None, 3), ((96, 80, 16), (64, 64, 32))):
        kw = dict(itemsize=4, kt=kt, ring=ring, lookahead=1)
        got = dp.attribute("lbl", op, 0.0123, grid, m, n, nb, **kw)
        ref = ref_dp.attribute("lbl", op, 0.0123, grid, m, n, nb, **kw)
        _close(got, ref)
        if grid != (1, 1):
            assert got["reconciliation"]["relation"] == "=="


def test_attribute_unmodelled_op_and_peaks():
    peaks = {"ici_gbps": 0.5}
    for args in (("x", None, 0.005, (2, 2), 64, 64, 16),
                 ("x", "herbt", 0.005, (2, 3), 64, 64, 16),
                 ("x", "potrf", 0.02, (2, 3), 128, 128, 16)):
        _close(dp.attribute(*args, peaks=peaks),
               ref_dp.attribute(*args, peaks=peaks))


def _inputs(op="potrf", grid=(2, 2), n=64, nb=16):
    expected = ref_spmd.expected_counts(op, -(-n // nb), 0, grid=grid)
    from dplasma_tpu.descriptors import Dist
    from dplasma_tpu.parallel.cyclic import CyclicDesc, spmd_comm_model
    bb = ref_dp.model_bytes_by_class(spmd_comm_model(
        CyclicDesc(n, n, nb, nb, Dist(P=grid[0], Q=grid[1])), op, 8))
    return expected, bb


def _timelines():
    """Hand-made timelines: (name, timeline, run_s, ingest kwargs)."""
    expected, bb = _inputs()
    base = ref_dp.synthesize_timeline(0.02, 4, counts=expected,
                                      bytes_by_class=bb)
    drop = sorted(expected)[0]
    lost, seen = [], set()
    for s in base:
        if s.get("cls") == drop and s["rank"] not in seen:
            seen.add(s["rank"])
            continue
        lost.append(s)
    floor = base
    for r in range(4):
        floor = ref_dp.stretch_rank(floor, r, 50.0)
    kw = dict(expected=expected, bytes_by_class=bb, op="potrf",
              label="hand")
    return [
        ("straggler", ref_dp.stretch_rank(base, 2, 8.0), 0.02, kw),
        ("compute-straggler", ref_dp.stretch_rank(
            base, 1, 6.0, categories=("compute",)), 0.02, kw),
        ("dropped", [s for s in base if s.get("cls") != drop], 0.02, kw),
        ("count-mismatch", lost, 0.02, kw),
        ("ici-floor", floor, 0.5, dict(kw, floor=0.5)),
        ("unmodelled", base, 0.02, dict(kw, expected=None)),
        ("empty", [], 0.02, kw),
    ]


@pytest.mark.parametrize("case", [t[0] for t in _timelines()])
def test_ingest_equals_the_reference(case):
    (_, tl, run_s, kw), = [t for t in _timelines() if t[0] == case]
    got = dp.ingest([dict(s) for s in tl], run_s, 4, **kw)
    ref = ref_dp.ingest([dict(s) for s in tl], run_s, 4, **kw)
    _close(got, ref)
    kinds = {d["kind"] for d in got["diagnostics"]}
    want = {"straggler": set(), "compute-straggler": set(),
            "dropped": {"missing-collective"},
            "count-mismatch": {"count-mismatch"},
            "ici-floor": {"ici-floor"}, "unmodelled": set(),
            "empty": {"missing-collective"}}[case]
    assert want <= kinds
    if case == "straggler":
        assert got["skew"]["slowest_rank"] == 2


def test_synthesize_and_stretch_equal_the_reference():
    expected, bb = _inputs("getrf", (2, 3), 96, 16)
    for peaks in (None, {"ici_gbps": 0.001}):
        got = dp.synthesize_timeline(0.01, 6, counts=expected,
                                     bytes_by_class=bb, peaks=peaks,
                                     base_ns=123)
        ref = ref_dp.synthesize_timeline(0.01, 6, counts=expected,
                                         bytes_by_class=bb, peaks=peaks,
                                         base_ns=123)
        assert got == ref
        assert dp.stretch_rank(got, 4, 3.0) == \
            ref_dp.stretch_rank(ref, 4, 3.0)


def test_collector_equals_the_reference():
    import threading
    got, ref = dp.DevprofCollector(), ref_dp.DevprofCollector()

    def feed(c, r):
        for i in range(50):
            c.add(f"fusion.{i}", r, i * 10, i * 10 + 5)
        c.extend([dp.timeline_op("all-reduce.1", r, 0, 3, cls="psum@q")])
    for c in (got, ref):
        workers = [threading.Thread(target=feed, args=(c, r))
                   for r in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
            assert not w.is_alive()
    key = lambda o: (o["rank"], o["begin_ns"], o["name"])  # noqa: E731
    assert sorted(got.snapshot(), key=key) == \
        sorted(ref.snapshot(), key=key)
    assert len(got) == len(ref) == 204
    got.clear()
    assert len(got) == 0 and got.snapshot() == []


def test_critical_path_walk():
    """Positive widths: the reference's walk. Zero widths: it ends."""
    expected, bb = _inputs()
    tl = ref_dp.stretch_rank(ref_dp.synthesize_timeline(
        0.02, 4, counts=expected, bytes_by_class=bb), 1, 3.0)
    for mp in (3, 32):
        assert dp._critical_path(tl, 0.02, mp) == \
            ref_dp._critical_path(tl, 0.02, mp)
    zero = [dp.timeline_op("fusion.0", 0, 0, 10),
            dp.timeline_op("all-reduce.1", 0, 10, 10, cls="psum@q"),
            dp.timeline_op("all-reduce.2", 1, 10, 10, cls="psum@q"),
            dp.timeline_op("fusion.3", 0, 10, 30)]
    cp = dp._critical_path(zero, 30e-9, 32)
    assert [s["name"] for s in cp["spans"]] == \
        ["fusion.0", "all-reduce.1", "all-reduce.2", "fusion.3"]
    assert cp["length_s"] == pytest.approx(30e-9)


@pytest.mark.parametrize("op", OPS + ("herbt", "nope"))
def test_schedule_equals_the_reference(op):
    for kt, la, ring, grid in itertools.product(
            (1, 4, 16), (0, 1, 2), (False, True), GRIDS + ((3, 1),)):
        assert spmdcheck.expected_counts(op, kt, la, ring=ring, grid=grid) \
            == ref_spmd.expected_counts(op, kt, la, ring=ring, grid=grid)
    for ring, grid in itertools.product((False, True), GRIDS):
        assert spmdcheck.model_classes(op, ring=ring, grid=grid) == \
            ref_spmd.model_classes(op, ring=ring, grid=grid)


REF_NAMES = sorted(ref_names.HLO_COLLECTIVES) + [
    "fusion.17", "%all-reduce.3", "all-gather-start.2", "dot.4",
    "copy.1", "copy-start.9", "transpose.2", "custom-call.4",
    "custom-call.4 dplasma_ring_bcast", "custom-call.5 dplasma_ring_shift",
    "custom-call.6 xla_python_cpu_callback", "infeed.1", "outfeed.2",
    "while.3", "convolution.1", "custom-call.7 tpu_custom_call", "",
    "All-Reduce.3", "reduce-scatter-start.1",
] + [dp._span_name(c, 7) for c in ("psum@q", "all_gather@p",
                                    "ring_bcast@q", "ring_shift@p",
                                    "reduce_scatter@q", "ppermute@p")]


@pytest.mark.parametrize("name", REF_NAMES)
def test_timeline_category_of_reference_names(name):
    assert hlo_names.timeline_category(name) == \
        ref_names.timeline_category(name)


def test_tables_equal_the_reference():
    for key in ("HLO_COLLECTIVES", "JAXPR_TO_HLO", "RING_MARKER",
                "CALLBACK_MARKERS", "COPY_OPCODES"):
        assert getattr(hlo_names, key) == getattr(ref_names, key), key


CUDA_NAMES = {
    "void k5_ring_bcast_kernel<unsigned int>(RingArgs)": "ici",
    "void k5_ring_shift_kernel<uint4>(RingArgs)": "ici",
    "Memcpy DtoD (Device -> Device)": "host",
    "Memcpy HtoD (Pinned -> Device)": "host",
    "Memset (Device)": "host",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)":
        "collective",
    "void ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)":
        "collective",
    "void k1_gemm_wgmma_kernel<float, true, true>(K1Args)": "compute",
    "void k1_gemm_kernel<float, false, true, false>(K1Args)": "compute",
    "void k3_lu_panel_kernel(K3Args)": "compute",
    "kt_tree_kernel": "compute", "void kw_sweep_kernel<float>()": "compute",
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32": "compute",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::FillFunctor<float>>(int, FillFunctor<float>)": "compute",
    "void potrf_kernel<float>(cusolver)": "compute",
}


@pytest.mark.parametrize("name", sorted(CUDA_NAMES))
def test_timeline_category_of_cuda_names(name):
    assert hlo_names.timeline_category(name) == CUDA_NAMES[name]
    want = {"bcast": "ring_bcast", "shift": "ring_shift"}
    k5 = [v for k, v in want.items() if f"k5_ring_{k}" in name]
    assert hlo_names.k5_kind(name) == (k5[0] if k5 else None)


@pytest.mark.parametrize("name,cls", [
    ("k5[ring_bcast@q]", "ring_bcast@q"), ("k5[ring_shift@p]", "ring_shift@p"),
    ("k5[ring_bcast@?]", "ring_bcast@?"), ("k5[]", None),
    ("devprof_run[0]", None), ("k5[ring_bcast@q", None)])
def test_k5_range_class(name, cls):
    assert hlo_names.k5_range_class(name) == cls
    if cls is not None:
        assert hlo_names.K5_RANGE.format(cls) == name


# ------------------------------------------------- the torch backend

K1 = "void k1_gemm_wgmma_kernel<float, true, true>(K1Args)"
BCAST = "void k5_ring_bcast_kernel<unsigned int>(RingArgs)"
SHIFT = "void k5_ring_shift_kernel<unsigned int>(RingArgs)"


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": 7}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def fabricated_trace(axes=None):
    """Two timed runs: run 0 one K1 product; run 1 (the best) K1, four
    K5 broadcasts, two shifts, a memcpy, a memset, a kernel launched at
    the run's end that starts after it, one without a launch record;
    plus the capture's warm-up op before the runs. Each K5 launch sits
    in the ``K5_RANGE`` range its caller opens, naming the axis
    ``axes[kind]`` (a broadcast along 'q', a shift along 'p' by
    default); ``axes=False`` leaves the ranges out."""
    if axes is None:
        axes = {"bcast": "q", "shift": "p"}
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0},
        _ev("user_annotation", "devprof_run[0]", 1000.0, 500.0),
        _ev("user_annotation", "devprof_run[1]", 2000.0, 400.0),
        _ev("gpu_user_annotation", "devprof_run[1]", 2005.0, 600.0),
        _ev("cpu_op", "aten::add_", 900.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 901.0, 2.0, corr=1),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel",
            903.0, 1.0, corr=1),
        _ev("cuda_driver", "cuLaunchKernelEx", 1010.0, 3.0, corr=2),
        _ev("kernel", K1, 1015.0, 50.0, corr=2),
    ]
    t, corr = 2010.0, 10
    for name, cat in [(K1, "kernel"), (BCAST, "kernel"), (BCAST, "kernel"),
                      (SHIFT, "kernel"), (BCAST, "kernel"),
                      (BCAST, "kernel"), (SHIFT, "kernel"),
                      ("Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
                      ("Memset (Device)", "gpu_memset")]:
        kind = hlo_names.k5_kind(name)
        if kind is not None and axes:
            ev.append(_ev("user_annotation", hlo_names.K5_RANGE.format(
                f"{kind}@{axes[kind.split('_')[1]]}"), t - 1.0, 4.0))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t, 2.0,
                      corr=corr))
        ev.append(_ev(cat, name, t + 3.0, 10.0, corr=corr))
        t, corr = t + 20.0, corr + 1
    ev.append(_ev("cuda_runtime", "cudaLaunchKernel", 2395.0, 2.0,
                  corr=99))
    ev.append(_ev("kernel", K1, 2401.0, 20.0, corr=99))
    ev.append(_ev("kernel", "void kt_tree_kernel", 2300.0, 10.0))
    return ev


def test_torch_timeline_bins_window_and_rings():
    tl0 = dp.torch_timeline(fabricated_trace(), 0, grid=(2, 2))
    assert [op["name"] for op in tl0] == [K1]
    assert tl0[0]["begin_ns"] == 1015000 and tl0[0]["end_ns"] == 1065000
    tl = dp.torch_timeline(fabricated_trace(), 1, grid=(2, 2))
    rows = {r["name"]: r for r in dp.device_ops(tl)}
    assert rows[K1]["count"] == 2 and rows[BCAST]["count"] == 4
    assert rows[SHIFT]["count"] == 2
    assert {r["category"] for r in rows.values()} == \
        {"compute", "ici", "host"}
    assert rows["Memset (Device)"]["category"] == "host"
    assert rows["void kt_tree_kernel"]["count"] == 1
    assert len(tl) == 11 and all(op["rank"] == 0 for op in tl)
    k5 = [op for op in tl if op.get("cls")]
    assert {(op["cls"], op["rings"]) for op in k5} == \
        {("ring_bcast@q", 2), ("ring_shift@p", 2)}
    assert not any("rings" in op for op in tl if not op.get("cls"))
    assert dp.torch_timeline(fabricated_trace(), 2) == []
    every = dp.torch_timeline(fabricated_trace(), None, grid=(2, 2))
    assert len(every) == len(tl0) + len(tl) + 1    # + the warm-up op
    # a 1x3 grid: one 'q' ring (P = 1), three 'p' exchanges
    tl13 = dp.torch_timeline(fabricated_trace(), 1, grid=(1, 3))
    assert {(op["cls"], op["rings"]) for op in tl13 if op.get("cls")} == \
        {("ring_bcast@q", 1), ("ring_shift@p", 3)}


def test_torch_timeline_k5_class_comes_from_the_launch():
    """A K5 op takes the axis its launch's range names (a broadcast
    along 'p' carries the Q rings of that axis), and one launched
    outside a range is ``ring_<kind>@?`` with one ring."""
    def classes(axes, grid=(2, 3)):
        return {(op["cls"], op["rings"]) for op in dp.torch_timeline(
            fabricated_trace(axes), 1, grid=grid) if op.get("cls")}
    assert classes({"bcast": "p", "shift": "q"}) == \
        {("ring_bcast@p", 3), ("ring_shift@q", 2)}
    assert classes(False) == {("ring_bcast@?", 1), ("ring_shift@?", 1)}
    # a range of the other kind does not class the kernel
    ev = [e for e in fabricated_trace() if e.get("name") !=
          hlo_names.K5_RANGE.format("ring_shift@p")]
    ev += [_ev("user_annotation", hlo_names.K5_RANGE.format("ring_bcast@q"),
               e["ts"] - 1.0, 4.0) for e in fabricated_trace()
           if e.get("cat") == "cuda_runtime" and e["ts"] in (2070.0, 2130.0)]
    got = {(op["cls"], op["rings"]) for op in dp.torch_timeline(
        ev, 1, grid=(2, 2)) if op.get("cls")}
    assert got == {("ring_bcast@q", 2), ("ring_shift@?", 1)}


def test_cyclic_call_sites_name_their_axis(monkeypatch):
    """sgetrf_ptgpanel on a 2×2 mesh with the ring on: every panel
    broadcast names axis 'q', every exchange hop axis 'p' — the axis
    the ``K5_RANGE`` range of its launch carries on the card."""
    from dplasma_tpu_torch.kernels import pallas_ring as pring
    seen = []
    for fn in ("ring_bcast", "ring_shift"):
        real = getattr(pring, fn)

        def spy(*a, _real=real, _fn=fn, **kw):
            seen.append((_fn, kw.get("axis")))
            return _real(*a, **kw)
        monkeypatch.setattr(pring, fn, spy)
    with cfg.override_scope({"ring.enable": "on"}):
        assert main(["testing_sgetrf_ptgpanel", "-N", "64", "-t", "16",
                     "-p", "2", "-q", "2", "--device", "cpu"]) == 0
    assert seen and set(seen) == {("ring_bcast", "q"), ("ring_shift", "p")}


def test_shared_lane_counts_per_rank():
    """sgetrf_ptgpanel's shape on one lane: 2·KT broadcasts and 2·KT
    shifts over a 2×2 mesh reconcile with KT each per rank."""
    kt = 3
    tl = dp.torch_timeline(fabricated_trace(), 1, grid=(2, 2))
    expected = {"ring_bcast@q": 2, "ring_shift@p": 1,
                "all_gather@p": 2 * kt}
    entry = dp.ingest(tl, 400e-6, 4, expected=expected, backend="torch",
                      bytes_by_class={"ring_bcast@q": 4e6,
                                      "ring_shift@p": 2e6})
    ing = entry["reconciliation"]["ingested"]
    assert ing == {"ring_bcast@q": 2, "ring_shift@p": 1}
    assert isinstance(ing["ring_bcast@q"], int)
    rows = {r["cls"]: r for r in entry["collectives"]}
    # a lane's time counts as its share of one rank's instance
    assert rows["ring_bcast@q"]["measured_s"] == pytest.approx(20e-6)
    assert rows["ring_shift@p"]["measured_s"] == pytest.approx(10e-6)
    assert [d["op"] for d in entry["diagnostics"]
            if d["kind"] == "missing-collective"] == ["all_gather@p"]
    assert entry["categories"]["ici"] == pytest.approx(60e-6)
    assert entry["coverage"] <= 1.0
    # one instance lost on the lane is a fractional count, a mismatch
    lossy = [op for op in tl if op["name"] != SHIFT][:] + \
        [op for op in tl if op["name"] == SHIFT][:1]
    e2 = dp.ingest(lossy, 400e-6, 4, expected=expected)
    assert e2["reconciliation"]["ingested"]["ring_shift@p"] == 0.5
    assert "count-mismatch" in {d["kind"] for d in e2["diagnostics"]}


def test_capture_resolution():
    cuda = torch.device("cuda")
    cap = dp.DevprofCapture(backend="auto", device=torch.device("cpu"))
    assert cap._resolve() == "synthetic" and cap.note == ""
    cap = dp.DevprofCapture(backend="auto", device=cuda, grid=(1, 1))
    assert cap._resolve() == "torch"
    cap = dp.DevprofCapture(backend="auto", device=cuda, grid=(2, 2))
    assert cap._resolve() == "synthetic"
    assert "2x2 virtual mesh" in cap.note and "one device lane" in cap.note
    assert dp.DevprofCapture(backend="torch", device=cuda,
                             grid=(2, 2))._resolve() == "torch"
    cap = dp.DevprofCapture(backend="jax")
    assert cap._resolve() == "synthetic" and "unknown" in cap.note
    with cfg.override_scope({"devprof.backend": "synthetic"}):
        assert dp.DevprofCapture(device=cuda)._resolve() == "synthetic"


def test_torch_capture_on_the_cpu_notes_no_device_event():
    cap = dp.DevprofCapture(backend="torch", device=torch.device("cpu"))
    with cap:
        for i in range(2):
            with cap.run(i):
                torch.ones(4).add_(1.0)
    assert cap.select(1) == [] and cap.used == "synthetic"
    assert "no device event" in cap.note
    # synthetic: no profiler, the run context is empty
    cap = dp.DevprofCapture(backend="synthetic")
    with cap, cap.run(0):
        pass
    assert cap.select(0) == [] and cap.note == ""


def test_torch_capture_notes_a_lost_head_sentinel():
    """A capture whose trace lacks the head pad's sentinel op (run
    ``HEAD_RUN``'s range) keeps its runs' ops and says in its note that
    the profiler's head loss reached past the pad; with the sentinel
    there is no note."""
    sentinel = [
        _ev("user_annotation", dp.RUN_RANGE.format(dp.HEAD_RUN), 800.0, 50.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 810.0, 2.0, corr=500),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel",
            815.0, 1.0, corr=500)]
    for trace, lost in ((fabricated_trace() + sentinel, False),
                        (fabricated_trace(), True)):
        cap = dp.DevprofCapture(backend="torch", device=torch.device("cpu"))
        cap.resolved, cap._trace = "torch", trace
        assert len(cap.select(1)) == 11 and cap.used == "torch"
        assert ("lost its head sentinel" in cap.note) is lost
    assert len(dp.torch_timeline(fabricated_trace() + sentinel,
                                 dp.HEAD_RUN)) == 1


def test_mca_keys_register_with_the_reference_defaults():
    from dplasma_tpu.utils import config as ref_cfg
    for key in ("devprof.ici_floor", "devprof.max_path",
                "devprof.backend"):
        assert cfg._MCA_REGISTRY[key][0] == ref_cfg._MCA_REGISTRY[key][0]


# ------------------------------------------------------ the drivers

DRIVERS = {
    "spotrf": ["testing_spotrf", "-N", "64", "-t", "16", "-x"],
    "sgetrf_ptgpanel": ["testing_sgetrf_ptgpanel", "-N", "64", "-t", "16",
                        "-p", "2", "-q", "2", "-x"],
}


@pytest.fixture(scope="module")
def driver_docs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("devprof")
    out = {}
    for tag, argv in DRIVERS.items():
        docs = {}
        for pkg, fn, extra in (("ref", ref_main, []),
                               ("port", main, ["--device", "cpu"])):
            rep = tmp / f"{pkg}_{tag}.json"
            rc = fn(argv + extra + ["--devprof", f"--report={rep}",
                                    f"--telemetry={tmp}/{pkg}_{tag}.prom",
                                    "--nowarmup"])
            assert rc == 0
            docs[pkg] = port_report.load_report(str(rep))
        out[tag] = docs
    return out


@pytest.mark.parametrize("tag", sorted(DRIVERS))
def test_driver_devprof_equals_the_reference(driver_docs, tag):
    ref, got = driver_docs[tag]["ref"], driver_docs[tag]["port"]
    (r,), (g,) = ref["devprof"], got["devprof"]
    assert set(g) == set(r)
    assert g["backend"] == r["backend"] == "synthetic" and g["ok"]
    assert g["reconciliation"] == r["reconciliation"]
    assert g["nranks"] == r["nranks"] and g["label"] == r["label"]
    assert g["op"] == r["op"]
    # the synthetic lane sums to the run; its wire spans are priced
    # from the same bytes and peaks, so their seconds agree up to the
    # lane's rounding to whole ns (one a span edge), and the compute
    # share is the rest of each package's own run
    for e in (g, r):
        lane_s = round(e["run_s"] * 1e9) / 1e9
        assert sum(e["categories"].values()) == \
            pytest.approx(lane_s, rel=1e-12)
    ns = 1e-9 * (1 + sum((r["reconciliation"]["expected"] or {}).values()))
    for c in ("collective", "ici", "host"):
        assert g["categories"][c] == pytest.approx(r["categories"][c],
                                                   rel=1e-12, abs=ns)
    assert [(c["cls"], c["count"]) for c in g["collectives"]] == \
        [(c["cls"], c["count"]) for c in r["collectives"]]
    for cg, cr in zip(g["collectives"], r["collectives"]):
        assert cg["measured_s"] == pytest.approx(
            cr["measured_s"], rel=1e-12, abs=1e-9 * (1 + cr["count"]))
        assert cg["model_bytes"] == cr["model_bytes"]
    assert {m["name"] for m in got["metrics"]
            if m["name"].startswith("devprof_")} == \
        {m["name"] for m in ref["metrics"]
         if m["name"].startswith("devprof_")}


@pytest.mark.parametrize("tag", sorted(DRIVERS))
def test_driver_report_holds_telemetry_and_provenance(driver_docs, tag):
    ref, got = driver_docs[tag]["ref"], driver_docs[tag]["port"]
    assert set(got["telemetry"]) == set(ref["telemetry"])
    kinds = [e["kind"] for e in
             got["telemetry"]["flight_recorder"]["events"]]
    assert kinds == [e["kind"] for e in
                     ref["telemetry"]["flight_recorder"]["events"]]
    assert kinds[:3] == ["run_start", "op_start", "op_done"]
    pg, pr = got["provenance"], ref["provenance"]
    renamed = {"jax": "torch", "jaxlib": "cuda"}
    assert set(pg) == {renamed.get(k, k) for k in pr} | {"device_name"}
    for key in ("schema", "family", "mesh_shape", "peaks_source"):
        assert pg[key] == pr[key], key
    assert pg["git"] == (pr["git"] if (REPO / ".git").exists() else None)
    assert pg["backend"] == got["env"]["backend"] == "cpu"
    assert pg["torch"] == torch.__version__


def test_ring_route_reconciles_on_the_virtual_mesh(tmp_path):
    rep = tmp_path / "r.json"
    with cfg.override_scope({"ring.enable": "on"}):
        assert main(DRIVERS["sgetrf_ptgpanel"] + [
            "--device", "cpu", "--devprof", f"--report={rep}",
            "--nowarmup"]) == 0
    (e,) = port_report.load_report(str(rep))["devprof"]
    rec = e["reconciliation"]
    assert rec["relation"] == "==" and e["backend"] == "synthetic"
    assert rec["expected"] == {"ring_bcast@q": 4, "all_gather@p": 8,
                               "ring_shift@p": 4}
    assert e["categories"]["ici"] > 0


def test_failed_attribution_is_loud_not_fatal(tmp_path, monkeypatch,
                                              capsys):
    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dp, "attribute", broken)
    rep = tmp_path / "r.json"
    assert main(["testing_spotrf", "-N", "32", "-t", "16", "--device",
                 "cpu", "--devprof", f"--telemetry={tmp_path}/t.prom",
                 f"--report={rep}"]) == 0
    assert "devprof attribution failed" in capsys.readouterr().err
    doc = port_report.load_report(str(rep))
    assert "devprof" not in doc
    evs = doc["telemetry"]["flight_recorder"]["events"]
    assert [e["kind"] for e in evs] == \
        ["run_start", "op_start", "op_done", "devprof_error"]
    assert common.RUNS[-1]["ops"][0]["devprof"] is None


def test_devprof_flag_parses():
    assert common.parse_arguments(["-N", "64", "--devprof"]).devprof
    assert not common.parse_arguments(["-N", "64"]).devprof
    assert "devprof" not in common._DEFERRED
    assert "telemetry" not in common._DEFERRED
