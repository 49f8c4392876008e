"""Port parity: ``dplasma_tpu_torch/tools/tracecat.py`` against the
reference's ``tools/tracecat.py`` on the same input files.

The inputs are written by the port's own instruments (a DTPUPROF1
profile per rank, a serving tracer's span document, a phase ledger and
a run-report with phase sections, a flight-recorder dump, a run-report
with a devprof entry); both converters read the very same files, and
their Chrome trace-event documents, ``--info`` output and exit codes
must be EQUAL.
"""
import json

import pytest

from dplasma_tpu_torch.observability import devprof as dp
from dplasma_tpu_torch.observability.report import RunReport
from dplasma_tpu_torch.observability.telemetry import FlightRecorder
from dplasma_tpu_torch.observability.tracing import Tracer
from dplasma_tpu_torch.tools import tracecat
from dplasma_tpu_torch.utils import profiling
from tools import tracecat as ref_tracecat
from torch_threads import one_torch_thread  # noqa: F401


def _write_profile(path, rank, tracks=(0, 1, 2), spans_per_track=2):
    prof = profiling.Profile(rank=rank)
    prof.save_info("SCHED", "wavefront")
    prof.save_dinfo("GFLOPS:testing_spotrf", 12.5)
    n = 0
    for tr in tracks:
        for i in range(spans_per_track):
            prof.add_event(f"t{tr}:span{i}", 1000 * n, 1000 * n + 500,
                           flops=float(n), track=tr)
            n += 1
    prof.write(str(path))
    return n


@pytest.fixture
def inputs(tmp_path):
    """Every kind of input tracecat reads, written by the port."""
    for rank in (0, 1):
        _write_profile(tmp_path / f"r{rank}.prof", rank=rank,
                       tracks=(0, 1))
    tr = Tracer(enabled=True, rank=0)
    tr.add("queue_wait", 5_000_000, 5_001_000, request=1)
    with tr.span("batch", requests=[1]):
        with tr.span("dispatch"):
            pass
    tr.save(str(tmp_path / "spans.json"))
    ledger = [{"phase": "panel", "count": 3, "measured_s": 0.5,
               "total_s": 0.5},
              {"phase": "ring", "count": 2, "measured_s": 0.25,
               "total_s": 0.25}]
    (tmp_path / "ledger.json").write_text(json.dumps(ledger))
    report = {"schema": 18, "name": "x", "metrics": [],
              "ops": [{"label": "testing_dpotrf",
                       "phases": {"spans": [
                           {"phase": "panel", "count": 2,
                            "measured_s": 0.1}]}}]}
    (tmp_path / "rep_phases.json").write_text(json.dumps(report))
    fr = FlightRecorder(capacity=8)
    fr.record("op_start", op="testing_dpotrf", n=64)
    fr.record("devprof_diag", op="testing_dpotrf",
              diag="missing-collective", target="psum@p")
    fr.dump(str(tmp_path / "flight.json"))
    rep = RunReport("testing_dpotrf")
    rep.add_devprof(dp.attribute("testing_dpotrf", "potrf", 0.01,
                                 (2, 2), 64, 64, 16))
    rep.write(str(tmp_path / "rep_devprof.json"))
    return tmp_path


def _both(argv, capsys):
    """Run both CLIs on ``argv``: (exit codes, stdouts, stderrs)."""
    rcs, outs, errs = [], [], []
    for mod in (ref_tracecat, tracecat):
        rcs.append(mod.main(list(argv)))
        c = capsys.readouterr()
        outs.append(c.out)
        errs.append(c.err)
    return rcs, outs, errs


def test_convert_is_the_references(inputs):
    for rank in (0, 1):
        p = str(inputs / f"r{rank}.prof")
        assert tracecat.convert(p) == ref_tracecat.convert(p)


@pytest.mark.parametrize("flags", [[], ["--info"]])
def test_cli_stdout_is_the_references(inputs, flags, capsys):
    rcs, outs, _ = _both([str(inputs / "r1.prof")] + flags, capsys)
    assert rcs == [0, 0] and outs[0] == outs[1]
    json.loads(outs[1])


def test_torn_tail_strict_and_lax_are_the_references(inputs, capsys):
    raw = (inputs / "r0.prof").read_bytes()
    (inputs / "torn.prof").write_bytes(raw[:-4])
    rcs, outs, errs = _both([str(inputs / "torn.prof")], capsys)
    assert rcs == [1, 1] and "tracecat:" in errs[1]
    rcs, outs, _ = _both(["--lax", str(inputs / "torn.prof")], capsys)
    assert rcs == [0, 0] and outs[0] == outs[1]


def test_merge_of_every_lane_is_the_references(inputs):
    kw = dict(serving=[str(inputs / "spans.json")],
              phases=[str(inputs / "ledger.json"),
                      str(inputs / "rep_phases.json")],
              flight=[str(inputs / "flight.json")],
              devprof=[str(inputs / "rep_devprof.json")])
    traces = [str(inputs / "r0.prof"), str(inputs / "r1.prof")]
    got = tracecat.merge(traces, **kw)
    assert got == ref_tracecat.merge(traces, **kw)
    cats = {e.get("cat") for e in got["traceEvents"] if e["ph"] != "M"}
    assert {"span", "serving", "phase", "flight", "devprof"} <= cats


def test_merge_cli_writes_the_references_file(inputs, capsys):
    args = ["--merge", str(inputs / "r0.prof"), str(inputs / "r1.prof"),
            "--serving", str(inputs / "spans.json"),
            "--flight", str(inputs / "flight.json"),
            "--devprof", str(inputs / "rep_devprof.json"),
            "--phases", str(inputs / "ledger.json")]
    assert ref_tracecat.main(args + ["-o", str(inputs / "a.json")]) == 0
    assert tracecat.main(args + ["-o", str(inputs / "b.json")]) == 0
    assert (inputs / "a.json").read_text() == \
        (inputs / "b.json").read_text()


@pytest.mark.parametrize("argv", [
    ["A", "B"], ["A", "--flight", "B"], ["A", "--serving", "B"]])
def test_cli_refusals_are_the_references(inputs, argv, capsys):
    """Several traces or a lane without ``--merge`` exit 2; an input of
    the wrong shape exits 1, both with a message on stderr."""
    paths = {"A": str(inputs / "r0.prof"), "B": str(inputs / "r1.prof")}
    rcs, _, errs = _both([paths.get(a, a) for a in argv], capsys)
    assert rcs == [2, 2] and "--merge" in errs[1]
    rcs, _, errs = _both(["--merge", paths["A"], "--devprof",
                          str(inputs / "rep_phases.json")], capsys)
    assert rcs == [1, 1] and errs[0] == errs[1]


def test_loaders_refuse_what_the_reference_refuses(inputs):
    (inputs / "bad.json").write_text('{"x": 1}')
    for loader in ("_load_phase_tables", "_load_span_doc",
                   "_load_flight_doc", "_load_devprof_tables"):
        with pytest.raises(ValueError):
            getattr(ref_tracecat, loader)(str(inputs / "bad.json"))
        with pytest.raises(ValueError):
            getattr(tracecat, loader)(str(inputs / "bad.json"))
