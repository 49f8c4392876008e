"""The port's live instruments (``observability/telemetry.py``) against
the reference's: registries filled the same way give string-equal
Prometheus text and equal parses; the strict reader refuses the same
lines; the flight recorder's counts, summary and ring order on
overflow agree; the exporter rewrites its file on its interval and
stops on ``close()``; and a driver run with ``--telemetry`` writes a
file whose counters equal the report's metrics, with the flight ring's
``run_start``, ``op_start`` and ``op_done``."""
import ast
import json
import os
import pathlib
import threading
import time

import pytest

from dplasma_tpu.observability import metrics as ref_metrics
from dplasma_tpu.observability import telemetry as ref_tel
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.drivers import common, main
from dplasma_tpu_torch.observability import metrics, telemetry
from dplasma_tpu_torch.observability import report as port_report
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
EXPORTER = "dplasma-telemetry-exporter"


def _fill(reg):
    """One fill script for either package's registry."""
    reg.counter("runs_total", op="testing_spotrf", prec="s").inc(3)
    reg.counter("serving_requests_total", op="posv").inc(7)
    reg.gauge("gflops_best", op="testing_spotrf", prec="s").set(123.25)
    reg.gauge("odd", label='a "quoted", {braced}\\ value\nline').set(-2.5)
    reg.gauge("empty")
    h = reg.histogram("run_seconds", op="testing_spotrf", prec="s")
    for v in (0.5, 0.25, 0.125, 1.5, 3.0, 0.001, 7.0):
        h.observe(v)
    reg.histogram("never_observed", op="x")
    return reg


def test_prometheus_text_is_string_equal_and_parses_alike():
    ref = ref_tel.prometheus_text(_fill(ref_metrics.MetricsRegistry()))
    got = telemetry.prometheus_text(_fill(metrics.MetricsRegistry()))
    assert got == ref
    # repr: an unobserved histogram's quantiles are NaN, NaN != NaN
    assert repr(telemetry.parse_prometheus_text(got)) == \
        repr(ref_tel.parse_prometheus_text(ref))
    fams = telemetry.parse_prometheus_text(got)
    (odd,) = fams["odd"]["samples"]
    assert odd[1]["label"] == 'a "quoted", {braced}\\ value\nline'
    assert fams["run_seconds"]["type"] == "summary"


@pytest.mark.parametrize("text", [
    "x 1\n",                                  # no # TYPE family
    "# TYPE x gauge\nx{a=\"1\" 2\n",          # unterminated braces
    "# TYPE x gauge\nx{a=1} 2\n",             # unquoted value
    "# TYPE x gauge\nx nope\n",               # non-numeric value
    "# TYPE x gauge\nx\n",                    # no value
    "# garbage comment line here\n",          # malformed comment
])
def test_strict_reader_refuses_alike(text):
    with pytest.raises(ValueError) as got:
        telemetry.parse_prometheus_text(text)
    with pytest.raises(ValueError) as ref:
        ref_tel.parse_prometheus_text(text)
    assert str(got.value) == str(ref.value)


def _flight(rec, n):
    for i in range(n):
        rec.record("op_start" if i % 3 else "op_done", op=f"op{i % 2}",
                   i=i)
    return rec


def _no_clock(events):
    return [{k: v for k, v in e.items() if k != "t_ns"} for e in events]


@pytest.mark.parametrize("cap,n", [(4, 3), (4, 11), (256, 40)])
def test_flight_recorder_counts_summary_and_ring_order(cap, n):
    got = _flight(telemetry.FlightRecorder(capacity=cap), n)
    ref = _flight(ref_tel.FlightRecorder(capacity=cap), n)
    assert got.counts() == ref.counts()
    gs, rs = got.summary(), ref.summary()
    assert {k: v for k, v in gs.items() if k != "events"} == \
        {k: v for k, v in rs.items() if k != "events"}
    assert _no_clock(gs["events"]) == _no_clock(rs["events"])
    # the ring keeps the newest events, oldest first
    assert [e["seq"] for e in gs["events"]] == \
        list(range(max(n - cap, 0), n))
    got.clear()
    assert got.summary()["recorded"] == 0 and got.events() == []


def test_flight_dump_round_trips(tmp_path):
    rec = _flight(telemetry.FlightRecorder(capacity=8), 5)
    path = rec.dump(str(tmp_path / "flight.json"))
    doc = json.loads(open(path).read())
    assert doc["dplasma_flight_recorder"] == ref_tel.FLIGHT_SCHEMA
    assert doc["events"] == rec.events() and doc["recorded"] == 5
    assert rec.dump(str(tmp_path / "no" / "dir.json")) is None


def _exporters():
    return [t for t in threading.enumerate() if t.name == EXPORTER]


def test_exporter_rewrites_and_stops(tmp_path):
    reg = _fill(metrics.MetricsRegistry())
    path = str(tmp_path / "m.prom")
    tel = telemetry.Telemetry()
    ex = tel.start_exporter(reg, path, interval_s=0.05)
    assert ex is tel.start_exporter(reg, path)       # one exporter
    reg.counter("serving_requests_total", op="posv").inc(5)
    deadline = time.time() + 10
    while ex.flushes < 3 and time.time() < deadline:
        time.sleep(0.02)
    assert ex.flushes >= 3 and len(_exporters()) == 1
    tel.close()
    assert _exporters() == [] and not os.path.exists(path + ".tmp")
    fams = telemetry.parse_prometheus_text(open(path).read())
    assert "serving_request_rate" in fams        # counter deltas -> rate
    assert tel.summary()["exporter"]["path"] == path
    # inert without a path
    assert telemetry.Telemetry().start_exporter(reg) is None


def test_live_instruments_import_no_torch():
    """The exporter thread and the flight recorder touch no CUDA: the
    modules they run (and the registry they read) import no torch."""
    for mod in ("telemetry", "tracing", "metrics"):
        tree = ast.parse((REPO / "dplasma_tpu_torch" / "observability"
                          / f"{mod}.py").read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert "torch" not in names, mod


def test_mca_keys_register_with_the_reference_defaults():
    for key in ("telemetry.max_spans", "telemetry.export_path",
                "telemetry.interval_s", "telemetry.flight_events",
                "telemetry.flight_path"):
        assert cfg._MCA_REGISTRY[key] == ref_cfg._MCA_REGISTRY[key], key


def test_driver_telemetry_exports_and_stops(tmp_path):
    prom, rep = tmp_path / "t.prom", tmp_path / "r.json"
    with cfg.override_scope({"telemetry.interval_s": "0.05"}):
        assert main(["testing_spotrf", "-N", "96", "-t", "32", "-x",
                     "--device", "cpu", "--nruns", "3",
                     f"--telemetry={prom}", f"--report={rep}"]) == 0
    assert _exporters() == []
    doc = port_report.load_report(str(rep))
    tel = doc["telemetry"]
    assert tel["exporter"]["path"] == str(prom)
    assert tel["exporter"]["interval_s"] == 0.05
    assert tel["exporter"]["flushes"] >= 2
    kinds = [e["kind"] for e in tel["flight_recorder"]["events"]]
    assert kinds == ["run_start", "op_start", "op_done"]
    assert tel["spans"]["balanced"]
    fams = telemetry.parse_prometheus_text(prom.read_text())
    for m in doc["metrics"]:
        if m["type"] in ("counter", "gauge"):
            (s,) = [s for s in fams[m["name"]]["samples"]
                    if s[1] == m["labels"]]
            assert s[2] == m["value"], m["name"]
    assert fams["runs_total"]["samples"][0][2] == 3.0
    assert common.RUNS[-1]["ops"][0]["gflops"] > 0


def test_telemetry_default_file_name(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ip = common.parse_arguments(["-N", "64", "--telemetry"])
    assert ip.telemetry == "telemetry.prom"
    assert main(["testing_spotrf", "-N", "32", "-t", "16", "--device",
                 "cpu", "--telemetry"]) == 0
    assert telemetry.parse_prometheus_text(
        (tmp_path / "telemetry.prom").read_text())["runs_total"]
