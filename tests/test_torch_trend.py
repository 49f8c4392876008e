"""The port's trend (``observability/trend.py``) and perfdiff core
(``tools/perfdiff.py`` of the port) against the reference's: the noise
model, the changepoints, the gate and the series are equal on seeded
series and on the committed ``BENCH_r*``, ``MULTICHIP_r*`` and
``SERVEBENCH_r*`` artifacts and ledgers; ``extract_metrics``,
``compare``, ``auto_thresholds`` and the ``--json`` verdict are equal on
run-reports that both packages' drivers wrote; the provenance stamp
keeps the reference's keys, with torch and CUDA for jax and jaxlib."""
import glob
import importlib.util
import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from dplasma_tpu.drivers import main as ref_main
from dplasma_tpu.observability import trend as ref_trend
from dplasma_tpu_torch.drivers import main
from dplasma_tpu_torch.observability import report as port_report
from dplasma_tpu_torch.observability import trend
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ref_pd = _load("perfdiff", REPO / "tools" / "perfdiff.py")
pd = trend._perfdiff()

ARTIFACTS = sorted(
    glob.glob(str(REPO / "BENCH_r*.json"))
    + glob.glob(str(REPO / "MULTICHIP_r*.json"))
    + glob.glob(str(REPO / "SERVEBENCH_r*.json")))


def _series(seed, n=24, frac=0.02, step_at=None, step=0.0, base=100.0):
    rng = random.Random(seed)
    return [base * (1.0 + (step if step_at is not None and i >= step_at
                           else 0.0)) * (1.0 + rng.uniform(-frac, frac))
            for i in range(n)]


SERIES = {
    "quiet": _series(1, frac=0.004),
    "noisy": _series(2, frac=0.2),
    "step_down": _series(3, frac=0.005, step_at=12, step=-0.2),
    "step_up_late": _series(4, frac=0.005, step_at=23, step=0.3),
    "two_steps": _series(5, n=30, frac=0.005, step_at=10, step=0.15)[:20]
    + _series(6, n=10, frac=0.005, base=70.0),
    "short": [1.0, 2.0],
    "constant": [5.0] * 9,
    "with_zero": [0.0, 1.0, 1.1, 0.9, 1.0, 1.05, 0.0, 1.0],
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_noise_model_and_changepoints_equal_the_reference(name):
    v = SERIES[name]
    assert trend.rel_steps(v) == ref_trend.rel_steps(v)
    assert trend.noise_sigma(v) == ref_trend.noise_sigma(v)
    assert trend.noise_sigma(v, window=4) == \
        ref_trend.noise_sigma(v, window=4)
    assert trend.auto_threshold(v, 0.1) == ref_trend.auto_threshold(v, 0.1)
    for z, ms in ((3.0, 0.05), (2.0, 0.02)):
        assert trend.changepoints(v, z=z, min_shift=ms) == \
            ref_trend.changepoints(v, z=z, min_shift=ms)
    for better in ("higher", "lower"):
        for ph in (False, True):
            s = {"key": f"t/{name}", "family": "bench", "metric": "m",
                 "knobs": "", "platform": "gpu", "placeholder": ph,
                 "better": better,
                 "points": [{"value": x} for x in v]}
            assert trend.gate_series(s) == ref_trend.gate_series(s)


def test_a_clean_step_is_named_at_its_index():
    (cp,) = trend.changepoints(SERIES["step_down"])
    assert cp["index"] == 12 and cp["shift"] == pytest.approx(-0.2,
                                                               abs=0.02)


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_artifacts_equal_the_reference(path):
    docs, notes = trend.load_artifact(path)
    assert (docs, notes) == ref_trend.load_artifact(path)
    for d in docs:
        assert trend.doc_family(d) == ref_trend.doc_family(d)
        assert trend.doc_platform(d) == ref_trend.doc_platform(d)
        assert trend.knob_signature(d) == ref_trend.knob_signature(d)
        assert trend.iter_points(d) == ref_trend.iter_points(d)
    pairs = [(d, os.path.basename(path)) for d in docs]
    assert trend.build_series(pairs) == ref_trend.build_series(pairs)


def test_all_artifacts_fold_into_the_same_series():
    docs = []
    for p in ARTIFACTS:
        docs += [(d, os.path.basename(p)) for d in trend.load_artifact(p)[0]]
    got = trend.build_series(docs)
    assert got == ref_trend.build_series(docs) and got
    for s in got.values():
        assert trend.gate_series(s) == ref_trend.gate_series(s)


@pytest.mark.parametrize("ledger", ["bench_history.jsonl",
                                    "PERF_LEDGER.jsonl"])
def test_ledgers_equal_the_reference(ledger):
    path = str(REPO / ledger)
    assert trend.ingest_ledger(path) == ref_trend.ingest_ledger(path)


def test_ledger_notes_name_bad_lines(tmp_path):
    p = tmp_path / "l.jsonl"
    p.write_text('{"family": "bench", "ladder": [], "peaks": {}}\n'
                 'not json\n\n{"no": "envelope"}\n'
                 '{"family": "f", "entries": [{"metric": "m", '
                 '"value": 2.0}]}\n')
    got = trend.ingest_ledger(str(p))
    assert got == ref_trend.ingest_ledger(str(p))
    assert len(got[1]) == 2 and ":2:" in got[1][0] and ":4:" in got[1][1]


def test_knob_keys_and_digests_equal_the_reference():
    for knobs in ("", '{"nb": 512}', '{"lu.agg_depth": 4, "nb": 256}'):
        assert trend.hash_knobs(knobs) == ref_trend.hash_knobs(knobs)
        for plat, ph in ((None, False), ("gpu", True)):
            assert trend.series_key("f", "m", knobs, plat, ph) == \
                ref_trend.series_key("f", "m", knobs, plat, ph)


# --------------------------------------- run-reports of both drivers

ARGV = ["testing_spotrf", "-N", "64", "-t", "16", "-p", "2", "-q", "2",
        "-x", "--devprof", "--nowarmup", "--nruns", "2"]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trend")
    out = {}
    for pkg, fn, extra in (("ref", ref_main, []),
                           ("port", main, ["--device", "cpu"])):
        rep = str(tmp / f"{pkg}.json")
        assert fn(ARGV + extra + [f"--report={rep}"]) == 0
        out[pkg] = rep
    return out


def test_extract_metrics_equals_the_reference(reports):
    for pkg in ("ref", "port"):
        doc = pd.load_doc(reports[pkg])
        got = pd.extract_metrics(doc)
        assert got == ref_pd.extract_metrics(doc)
        assert {"testing_spotrf.median_s", "testing_spotrf.best_s",
                "testing_spotrf.gflops", "testing_spotrf.devprof.skew",
                "testing_spotrf.devprof.ici_achieved_frac"} <= set(got)
    port = port_report.load_report(reports["port"])
    assert trend.doc_platform(port) == "cpu"
    assert trend.doc_family(port) == "testing_spotrf"


def test_compare_and_verdict_equal_the_reference(reports):
    old, new = (pd.load_doc(reports[k]) for k in ("ref", "port"))
    for th, per in ((0.10, None), (1e9, {"median_s": 0.0}),
                    (0.5, {"testing_spotrf.gflops": 1e9})):
        got = pd.compare(old, new, th, per)
        assert got == ref_pd.compare(old, new, th, per)
        assert pd.format_result(got, verbose=True) == \
            ref_pd.format_result(got, verbose=True)
        code = 0 if got["ok"] else 1
        assert pd.verdict_doc(got, code, th, "a", "b") == \
            ref_pd.verdict_doc(got, code, th, "a", "b")


def test_ledger_gate_with_auto_thresholds(reports, tmp_path):
    ledger = str(tmp_path / "ledger.jsonl")
    doc = pd.load_doc(reports["port"])
    rng = random.Random(7)
    for i in range(8):
        d = json.loads(json.dumps(doc))
        for op in d["ops"]:
            for k in ("median_s", "best_s"):
                op["timings"][k] *= 1.0 + rng.uniform(-0.05, 0.05)
        pd.append_ledger(ledger, d)
    assert pd.latest_comparable_entry(ledger, doc) == \
        ref_pd.latest_comparable_entry(ledger, doc)
    auto = pd.auto_thresholds(ledger, doc)
    assert auto == ref_pd.auto_thresholds(ledger, doc) and auto
    out = str(tmp_path / "v.json")
    rc = pd.main([ledger, reports["port"], "--auto-threshold",
                  f"--json={out}"])
    ref_out = str(tmp_path / "rv.json")
    assert rc == ref_pd.main([ledger, reports["port"], "--auto-threshold",
                              f"--json={ref_out}"])
    got, ref = json.load(open(out)), json.load(open(ref_out))
    assert got == ref and got["exit_code"] == rc


def test_perfdiff_exit_codes(reports, tmp_path, capsys):
    assert pd.main([reports["port"], reports["port"]]) == 0
    assert "perfdiff: OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    assert pd.main([reports["port"], str(bad)]) == 2
    assert pd.main([str(bad), reports["port"], "--json=-"]) == 2
    assert json.loads(capsys.readouterr().out)["exit_code"] == 2


def test_provenance_keys_and_values(reports):
    got = port_report.load_report(reports["port"])["provenance"]
    ref = port_report.load_report(reports["ref"])["provenance"]
    renamed = {"jax": "torch", "jaxlib": "cuda"}
    assert set(got) == {renamed.get(k, k) for k in ref} | {"device_name"}
    if (REPO / ".git").exists():
        assert got["git"] == ref["git"] and got["git"]["sha"]
    else:   # a copy without its own .git names no commit
        assert got["git"] is None
    assert (got["backend"], got["device_count"], got["device_name"]) == \
        ("cpu", 1, None)
    assert got["mesh_shape"] == [2, 2] and got["peaks_source"] == "default"
    with cfg.override_scope({"ring.enable": "off"}):
        prov = trend.collect_provenance(family="f", mesh_shape=(1, 2),
                                        peaks_source="file",
                                        repo_root=str(REPO / "nowhere"))
    assert prov["git"] is None and prov["mca"] == {"ring.enable": "off"}
    assert prov["family"] == "f" and prov["mesh_shape"] == [1, 2]
    assert prov["schema"] == ref_trend.PROVENANCE_SCHEMA


def _git(cwd, *args):
    subprocess.run(["git", *args], cwd=str(cwd), check=True,
                   capture_output=True, env=dict(
                       os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
                       GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t"))


def test_git_state_asks_only_the_checkout(tmp_path):
    """A copy without .git nested in another repository names no commit
    and leaves the enclosing repository's index untouched; a checkout
    with its own .git names its HEAD and its dirty flag."""
    outer = tmp_path / "outer"
    (outer / "build" / "copy").mkdir(parents=True)
    _git(outer, "init", "-q")
    (outer / "f.txt").write_text("x\n")
    _git(outer, "add", "f.txt")
    _git(outer, "commit", "-q", "-m", "c")
    index = outer / ".git" / "index"
    before = index.stat().st_mtime_ns
    (outer / "f.txt").write_text("y\n")
    assert trend._git_state(outer / "build" / "copy") is None
    assert trend.collect_provenance(
        repo_root=str(outer / "build" / "copy"))["git"] is None
    assert index.stat().st_mtime_ns == before
    head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=str(outer),
                          capture_output=True, text=True).stdout.strip()
    assert trend._git_state(outer) == {"sha": head, "dirty": True}


def test_report_stamp_provenance():
    rep = port_report.RunReport("testing_x")
    prov = rep.stamp_provenance(family="testing_x", mesh_shape=[1, 1])
    assert rep.snapshot()["provenance"] is prov
    assert prov["torch"] and prov["backend"] in ("cpu", "cuda")
