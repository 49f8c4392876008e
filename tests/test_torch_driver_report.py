"""The port's drivers under the instruments' flags (``--report
--profile --phase-profile``) against the reference driver run with the
same arguments: report schema, section keys, per-op keys, the
pipeline section, the comm model, the checks, the ``(phase, count)``
rows of the attributed pass; the DTPUPROF1 profiles' span vocabulary;
the reference's ``tools/perfdiff.py`` on a port report; the deferred
flags' usage error; and the timed loop, which fences nothing and
launches what it launched without the flags.

Both reports carry a ``provenance`` section (each ``Driver.close``
stamps one whenever ``--report`` is given). The reference's ops carry a
``dag`` summary and an ``xla`` capture (with its ``xla_*`` gauges): the
port's stay null (the DAG builders wait for ROADMAP queue 1 item 15,
and the port compiles nothing).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from dplasma_tpu.drivers import main as ref_main
from dplasma_tpu.utils import profiling as ref_prof
from dplasma_tpu_torch.drivers import common, main
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.observability import phases
from dplasma_tpu_torch.observability import report as port_report
from dplasma_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "spotrf": ["testing_spotrf", "-N", "128", "-t", "16", "-x"],
    "sgetrf": ["testing_sgetrf", "-N", "128", "-t", "16", "-x"],
    "dposv_ir": ["testing_dposv_ir", "-N", "96", "-t", "32", "-K", "2",
                 "-x"],
}
FLAGS = ["--phase-profile"]
ABSENT_IN_PORT = set()


def _run(fn, argv, tmp, tag):
    rep, prof = os.path.join(tmp, f"{tag}.json"), \
        os.path.join(tmp, f"{tag}.prof")
    rc = fn(argv + FLAGS + [f"--report={rep}", f"--profile={prof}"])
    return rc, rep, prof


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case through both drivers once: (rc, report, profile)."""
    tmp = str(tmp_path_factory.mktemp("reports"))
    out = {}
    for case, argv in CASES.items():
        out[case] = {
            "ref": _run(ref_main, argv, tmp, f"ref_{case}"),
            "port": _run(main, argv + ["--device", "cpu"], tmp,
                         f"port_{case}")}
    return out


def _docs(runs, case):
    r, p = runs[case]["ref"], runs[case]["port"]
    assert r[0] == 0 and p[0] == 0
    return (port_report.load_report(r[1]), port_report.load_report(p[1]))


def _rows(op):
    return sorted((s["phase"], s["count"]) for s in op["phases"]["spans"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_sections_equal_the_reference(runs, case):
    ref, got = _docs(runs, case)
    assert got["schema"] == ref["schema"] == 18
    assert set(got) == set(ref) - ABSENT_IN_PORT
    assert got["name"] == ref["name"]
    assert got["pipeline"] == ref["pipeline"]
    assert [c["what"] for c in got["checks"]] == \
        [c["what"] for c in ref["checks"]]
    assert all(c["ok"] for c in got["checks"])
    assert set(got["env"]) == {"backend", "torch", "device_count"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_ops_and_phase_rows_equal_the_reference(runs, case):
    ref, got = _docs(runs, case)
    assert len(got["ops"]) == len(ref["ops"]) == 1
    g, r = got["ops"][0], ref["ops"][0]
    assert set(g) == set(r)
    assert set(g["timings"]) == set(r["timings"])
    assert g["label"] == r["label"] and g["prec"] == r["prec"]
    assert g["model_flops"] == r["model_flops"]
    assert g["comm"] == r["comm"]
    assert g["xla"] is None and g["dag"] is None
    assert set(g["phases"]) == set(r["phases"])
    assert _rows(g) == _rows(r)
    assert 0 < g["phases"]["coverage"] <= 1.05
    assert g["phases"]["peaks_source"] == r["phases"]["peaks_source"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_roofline_and_metrics_equal_the_reference(runs, case):
    ref, got = _docs(runs, case)
    (g,), (r,) = got["roofline"], ref["roofline"]
    assert set(g) == set(r)
    for key in ("op", "op_class", "bound", "peaks", "peaks_source"):
        assert g[key] == r[key], key
    # expected_s follows from the same flops, bytes and peaks
    assert g["expected_s"] == r["expected_s"]
    # the xla_* gauges carry the reference's compile analyses
    names = {(m["name"], tuple(sorted(m["labels"])))
             for m in ref["metrics"] if not m["name"].startswith("xla_")}
    assert {(m["name"], tuple(sorted(m["labels"])))
            for m in got["metrics"]} == names


def test_refine_section_equals_the_reference(runs):
    ref, got = _docs(runs, "dposv_ir")
    (g,), (r,) = got["refine"], ref["refine"]
    assert set(g) == set(r)
    for key in ("op", "precision", "iterations", "converged", "escalated",
                "tol"):
        assert g[key] == r[key], key


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiles_decode_alike(runs, case):
    names = {}
    for tag in ("ref", "port"):
        path = runs[case][tag][2]
        prof = profiling.Profile.load(path)
        other = ref_prof.Profile.load(path)
        assert prof.events == other.events and prof.info == other.info
        names[tag] = sorted((n.split(":")[0], tr)
                            for n, _, _, _, tr in prof.events)
        assert prof.info["driver"] == CASES[case][0]
    assert names["port"] == names["ref"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_perfdiff_self_compare_of_a_port_report(runs, case):
    rep = runs[case]["port"][1]
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "perfdiff.py"), rep,
         rep], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "perfdiff: OK" in res.stdout


@pytest.mark.parametrize("flag,item", [
    ("--dot", "item 15"),
    ("--dot=g.dot", "item 15"), ("--dagcheck", "item 15"),
    ("--spmdcheck", "item 15"), ("--hlocheck", "item 15"),
    ("--memcheck", "item 15"), ("--autotune", "item 9b")])
def test_deferred_flags_name_their_roadmap_item(flag, item, capsys):
    with pytest.raises(SystemExit) as ei:
        main(["testing_spotrf", "-N", "64", "-t", "16", "--device", "cpu",
              flag])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP queue 1 {item}" in err


def test_flag_spellings_parse_like_the_reference():
    ip = common.parse_arguments(["-N", "64", "--report", "--profile",
                                 "--jaxtrace", "--phase-profile",
                                 "--peaks-file", "p.json"])
    assert (ip.report, ip.profile, ip.jaxtrace) == \
        ("report.json", "run.prof", "jax_trace")
    assert ip.phase_profile and ip.peaks_file == "p.json"
    ip = common.parse_arguments(["-N", "64", "--report=a", "--profile=b",
                                 "--jaxtrace=c", "--peaks-file=d"])
    assert (ip.report, ip.profile, ip.jaxtrace, ip.peaks_file) == \
        ("a", "b", "c", "d")


def test_timed_loop_fences_nothing_and_launches_alike(tmp_path,
                                                      monkeypatch):
    """The flags add no fence to the timed loop and no K1 route to a
    timed run; only the attributed pass fences."""
    calls = []
    real = phases._fence
    monkeypatch.setattr(phases, "_fence",
                        lambda v: calls.append(phases.active()) or real(v))
    argv = ["testing_spotrf", "-N", "768", "-t", "256", "--device", "cpu",
            "--nruns", "2"]
    pk.enable(True)
    try:
        routed = []
        for extra in ([], ["--phase-profile", f"--report={tmp_path}/r.json",
                           f"--profile={tmp_path}/r.prof",
                           f"--jaxtrace={tmp_path}/tr"]):
            common.RUNS.clear()
            before = pk.ROUTED
            assert main(argv + extra) == 0
            routed.append(pk.ROUTED - before)
            if not extra:
                assert calls == []
    finally:
        pk.enable(False)
    assert calls and all(led is not None for led in calls)
    op = common.RUNS[-1]["ops"][0]
    nt = 768 // 256
    # warm-up + two timed runs + the attributed pass, 2·nt − 3 each
    assert routed == [3 * (2 * nt - 3), 4 * (2 * nt - 3)]
    assert op["k1_launches"] == [0, 0]
    assert op["phases"]["spans"]
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_unreadable_peaks_file_degrades_to_the_builtins(tmp_path, capsys):
    bad = tmp_path / "peaks.json"
    bad.write_text("{not json")
    rep = tmp_path / "r.json"
    assert main(["testing_spotrf", "-N", "64", "-t", "16", "--device",
                 "cpu", "--phase-profile", f"--peaks-file={bad}",
                 f"--report={rep}"]) == 0
    assert "cannot read peaks file" in capsys.readouterr().err
    doc = port_report.load_report(str(rep))
    assert doc["roofline"][0]["peaks_source"] == "default"
    assert doc["ops"][0]["phases"]["peaks_source"] == "default"


def test_peaks_file_prices_the_phase_table(tmp_path):
    peaks = {"hbm_gbps": 1.0, "ici_gbps": 1.0, "host_gbps": 1.0,
             "latency_us": 1.0, "f32_highest_gflops": 2.0}
    path = tmp_path / "peaks.json"
    path.write_text(json.dumps({"peaks": peaks}))
    rep = tmp_path / "r.json"
    assert main(["testing_spotrf", "-N", "64", "-t", "16", "--device",
                 "cpu", "--phase-profile", f"--peaks-file={path}",
                 f"--report={rep}"]) == 0
    doc = port_report.load_report(str(rep))
    rl = doc["roofline"][0]
    assert rl["peaks_source"] == f"file:{path}"
    assert rl["peaks"]["mxu_gflops"] == 2.0 and rl["bound"] == "mxu"


def test_failed_attribution_reports_null(tmp_path, monkeypatch, capsys):
    """The reference's contract: a failed attributed pass is a warning
    and a null ``phases``, never a failed run."""
    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(phases, "profiling", broken)
    rep = tmp_path / "r.json"
    assert main(["testing_spotrf", "-N", "64", "-t", "16", "--device",
                 "cpu", "--phase-profile", f"--report={rep}"]) == 0
    assert "phase attribution failed" in capsys.readouterr().err
    assert port_report.load_report(str(rep))["ops"][0]["phases"] is None


def test_cyclic_driver_phase_table_has_the_ring_row(tmp_path):
    rep = tmp_path / "r.json"
    assert main(["testing_sgetrf_ptgpanel", "-N", "64", "-t", "16", "-p",
                 "2", "-q", "2", "--device", "cpu", "--phase-profile",
                 f"--report={rep}", "--nowarmup"]) == 0
    op = port_report.load_report(str(rep))["ops"][0]
    rows = dict(_rows(op))
    assert rows == {"ring": 1}
    ring = [s for s in op["phases"]["spans"] if s["phase"] == "ring"][0]
    assert ring["bound"] in ("ici", "latency")
    assert op["comm"]["spmd_model"] is not None
    assert torch.get_num_threads() == 1
