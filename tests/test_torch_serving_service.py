"""Port parity: ``SolverService`` (``dplasma_tpu_torch.serving.service``)
against ``dplasma_tpu.serving.service``, and the port's servebench.

The same scripted request stream goes to a service of each package (the
reference's on the CPU, as its own tests run it; the port's with
``device="cpu"``): the dispatch triggers (which futures are done after
each submit), the request ids, the scatter (shapes, a 1-D right-hand
side returned 1-D, the meta's batch / bucket / ids), the span names and
their tree, the flight-event kinds and the metric names are equal, and
the solutions within 1e-4 (f32; each package factors in its own
summation order). Per-request ladder outcomes under an injected fault
are equal: which request walked the ladder, its classification, its
rungs and their verdicts, the winner. Listed differences: the
reference audits each compiled executable (``serving_hlocheck_*``
metrics, ROADMAP item 15 in the port); the port's cache entry is built
by one run on identity problems; a kernel-stage tap fires at run time in
the port (the reference's at trace time), so the outcome, not the site,
is compared. The reference's services compile per bucket, so the
scenarios share a few buckets.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest

from dplasma_tpu.resilience import inject as ref_inject
from dplasma_tpu.serving import SolverService as RefService
from dplasma_tpu_torch.resilience import inject
from dplasma_tpu_torch.serving import SolverService, service
from dplasma_tpu_torch.serving.admission import (AdmissionError,
                                                 ServingTimeout)
from dplasma_tpu_torch.tools import servebench
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

NB = 8


def _spd(rng, n, dtype=np.float32):
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(dtype)


def _gen(rng, n, dtype=np.float32):
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype)


def _stream(seed=12):
    """(op, A, b) requests: three posv of one bucket (n 10, 9, 12 -> 12;
    nrhs -> 4; the middle one a 1-D right-hand side), a gesv, a posv_ir."""
    rng = np.random.default_rng(seed)
    out = []
    for op, n, nrhs in (("posv", 10, 1), ("gesv", 9, 2), ("posv", 9, 0),
                        ("posv", 12, 3), ("posv_ir", 11, 2)):
        dt = np.float64 if op.endswith("_ir") else np.float32
        a = (_spd if op.startswith("posv") else _gen)(rng, n, dt)
        b = rng.standard_normal((n,) if nrhs == 0 else (n, nrhs)).astype(dt)
        out.append((op, a, b))
    return out


def _drive(svc, reqs, plan=None, arm=None):
    """Submit the stream, recording which futures are done after each
    submit, then flush and gather."""
    done, futs = [], []
    if plan is not None:
        arm.arm(plan)
    try:
        for op, a, b in reqs:
            futs.append(svc.submit(op, a, b))
            done.append([f.done() for f in futs])
        svc.flush()
        xs = [f.result(120.0) for f in futs]
    finally:
        if plan is not None:
            arm.disarm()
    return done, futs, xs


def _meta(f):
    keep = ("request_id", "batch", "batched", "bucket", "ok")
    m = {k: f.meta[k] for k in keep}
    m["bucket"] = list(m["bucket"])
    if "refine" in f.meta:
        m["converged"] = f.meta["refine"]["converged"]
    return m


def _tree(svc):
    spans = svc.telemetry.tracer.spans()
    by_sid = {s["sid"]: s["name"] for s in spans}
    return sorted((s["name"], by_sid.get(s["parent"])) for s in spans)


def _kinds(svc):
    return [e["kind"] for e in svc.telemetry.flight.events()]


def _names(svc):
    return {m["name"] for m in svc.metrics.snapshot()
            if not m["name"].startswith("serving_hlocheck_")}


@pytest.fixture(scope="module")
def scenario():
    reqs = _stream()
    out = {}
    for tag, mk in (("port", lambda: SolverService(
            nb=NB, max_batch=3, max_wait_ms=0, device="cpu")),
                    ("ref", lambda: RefService(nb=NB, max_batch=3,
                                               max_wait_ms=0))):
        svc = mk()
        done, futs, xs = _drive(svc, reqs)
        out[tag] = dict(svc=svc, done=done, futs=futs, xs=xs)
    return reqs, out


def test_dispatch_triggers_ids_and_scatter(scenario):
    reqs, out = scenario
    p, r = out["port"], out["ref"]
    assert p["done"] == r["done"]
    assert p["done"][3] == [True, False, True, True]   # max_batch fills
    assert [f.request_id for f in p["futs"]] == [1, 2, 3, 4, 5]
    assert [_meta(f) for f in p["futs"]] == [_meta(f) for f in r["futs"]]
    for (op, a, b), x, rx in zip(reqs, p["xs"], r["xs"]):
        assert x.shape == b.shape == np.asarray(rx).shape
        tol = 1e-10 if op.endswith("_ir") else 1e-4
        assert np.abs(x - np.asarray(rx)).max() <= tol * np.abs(x).max()
        want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
        assert np.abs(x - want).max() <= tol * np.abs(want).max()


def test_spans_flight_and_metrics_equal_the_reference(scenario):
    _, out = scenario
    p, r = out["port"]["svc"], out["ref"]["svc"]
    assert p.telemetry.tracer.balanced()
    assert _tree(p) == _tree(r)
    assert _kinds(p) == _kinds(r)
    assert _names(p) == _names(r)
    sp, sr = p.summary(), r.summary()
    for k in ("requests", "batches", "mean_batch", "remediated", "failed",
              "retries", "escalations", "tuning", "admission"):
        assert sp[k] == sr[k], k
    assert {k: sp["cache"][k] for k in ("entries", "hits", "misses")} == \
        {k: sr["cache"][k] for k in ("entries", "hits", "misses")}
    assert p.metrics.get("serving_queue_depth").value == 0
    assert p.metrics.get("serving_inflight_batches").value == 0


@pytest.mark.parametrize("spec", ["nan@serving:1:1", "nan@trsm:1:1"])
def test_ladder_outcomes_under_injection_equal_the_reference(spec):
    """A serving-tap fault heals its own request on the retry rung while
    its batch-mates resolve from the batch; a kernel-stage fault
    corrupts the whole batch, its entry is dropped and every request
    heals on its own ladder — in both packages."""
    rng = np.random.default_rng(17)
    reqs = [("posv", _spd(rng, 8), rng.standard_normal((8, 2)).astype(
        np.float32)) for _ in range(3)]
    res = {}
    for tag, svc, arm in (
            ("port", SolverService(nb=NB, max_batch=8, max_wait_ms=0,
                                   device="cpu"), inject),
            ("ref", RefService(nb=NB, max_batch=8, max_wait_ms=0),
             ref_inject)):
        _, futs, xs = _drive(svc, reqs, arm.parse_plan(spec), arm)
        outcomes = []
        for f in futs:
            s = f.meta.get("resilience")
            outcomes.append(None if s is None else (
                s["outcome"], s["winner"],
                [(a["action"], a["ok"], a["classification"])
                 for a in s["attempts"]]))
        res[tag] = (outcomes, svc.cache.stats()["invalidations"],
                    svc.summary()["remediated"], xs)
    assert res["port"][:3] == res["ref"][:3]
    outcomes = res["port"][0]
    if spec.startswith("nan@serving"):
        assert outcomes[1:] == [None, None]
        assert outcomes[0][0] == "remediated"
    else:
        assert all(o is not None and o[0] == "remediated" for o in outcomes)
        assert res["port"][1] >= 1
    for (op, a, b), x in zip(reqs, res["port"][3]):
        want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
        assert np.abs(x - want).max() <= 1e-4 * np.abs(want).max()


def test_finite_corruption_of_an_ir_response_remediates():
    rng = np.random.default_rng(16)
    a = _spd(rng, 8, np.float64)
    b = rng.standard_normal((8, 1))
    svc = SolverService(nb=NB, max_batch=4, max_wait_ms=0, device="cpu")
    fut = svc.submit("posv_ir", a, b, max_iters=3)
    assert np.allclose(fut.result(120.0), np.linalg.solve(a, b), atol=1e-9)
    assert fut.meta["refine"]["converged"] and fut.meta["ok"]
    with inject.active(inject.parse_plan("bitflip@serving:1:1")):
        fut2 = svc.submit("posv_ir", a, b, max_iters=3)
        x2 = fut2.result(120.0)
    assert fut2.meta["resilience"]["outcome"] == "remediated"
    assert np.allclose(x2, np.linalg.solve(a, b), atol=1e-9)


def test_submit_validation_like_the_reference():
    svc = SolverService(nb=NB, device="cpu")
    ref = RefService(nb=NB)
    ok_a = np.eye(8, dtype=np.float32)
    ok_b = np.ones((8, 1), np.float32)
    for args, exc in ((("potrs", ok_a, ok_b), ValueError),
                      (("posv", ok_a[:4], ok_b), ValueError),
                      (("posv", ok_a, ok_b[:4]), ValueError),
                      (("posv", ok_a, ok_b.astype(np.float64)), TypeError),
                      (("posv_ir", ok_a, ok_b), TypeError)):
        with pytest.raises(exc):
            svc.submit(*args)
        with pytest.raises(exc):
            ref.submit(*args)


def test_wait_window_timer_and_blocking_result():
    rng = np.random.default_rng(15)
    a, b = _spd(rng, 8), rng.standard_normal(8).astype(np.float32)
    svc = SolverService(nb=NB, max_batch=8, max_wait_ms=30.0, device="cpu")
    fut = svc.submit("posv", a, b)
    fut._event.wait(10.0)              # the timer thread dispatches it
    assert fut.done() and fut.result(1.0).shape == (8,)
    svc2 = SolverService(nb=NB, max_batch=8, max_wait_ms=0, device="cpu")
    fut2 = svc2.submit("posv", a, b)
    assert not fut2.done()
    assert np.allclose(fut2.result(60.0), fut.result(1.0))
    svc.close()
    # a future whose group is never dispatched times out, named
    stuck = service.SolveFuture(svc2, None)
    stuck.request_id = 99
    stuck._service = type("S", (), {"_drive": lambda self, g: None})()
    with pytest.raises(ServingTimeout) as ei:
        stuck.result(0.01)
    assert ei.value.request_id == 99


def test_remediation_failure_stays_isolated(capsys):
    rng = np.random.default_rng(21)
    reqs = [(_spd(rng, 8), rng.standard_normal((8, 1)).astype(np.float32))
            for _ in range(2)]
    svc = SolverService(nb=NB, max_batch=8, max_wait_ms=0, max_retries=0,
                        device="cpu")
    svc._solo = svc._escalate = lambda r: (_ for _ in ()).throw(
        RuntimeError("remediation exploded"))
    with inject.active(inject.parse_plan("nan@serving:1:1")):
        futs = [svc.submit("posv", a, b) for a, b in reqs]
        svc.flush()
        x1 = futs[1].result(60.0)
    a1, b1 = reqs[1]
    assert np.allclose(x1, np.linalg.solve(a1, b1), atol=1e-3)
    with pytest.raises(RuntimeError, match="remediation exploded"):
        futs[0].result(60.0)
    err = capsys.readouterr().err
    assert f"reqs=[{futs[0].request_id}]" in err


def test_tuning_db_is_refused_until_it_is_ported(monkeypatch, tmp_path):
    db = str(tmp_path / "db.json")
    monkeypatch.setenv("DPLASMA_TUNE_DB", db)
    with pytest.raises(ValueError, match="9b"):
        SolverService(nb=NB, device="cpu")
    with cfg.override_scope({"tune.serving": "off"}):
        SolverService(nb=NB, device="cpu")
    monkeypatch.delenv("DPLASMA_TUNE_DB")
    with cfg.override_scope({"tune.db": db}):
        with pytest.raises(ValueError, match="ROADMAP item 9b"):
            SolverService(nb=NB, device="cpu")
    svc = SolverService(nb=NB, device="cpu")
    assert svc._autopilot_for("posv_ir", np.eye(4)) is None


def test_concurrent_submitters_conserve_requests():
    """More caller threads than cores and the timer threads together,
    the switch interval shortened: every admitted request resolves once,
    the gauges drain to zero, spans balance (a lost update in the queue,
    the counters or the dispatch lock would break one of them)."""
    rng = np.random.default_rng(30)
    mats = [(_spd(rng, n), rng.standard_normal((n, 1)).astype(np.float32))
            for n in (8, 12, 8, 12)]
    svc = SolverService(nb=NB, max_batch=3, max_wait_ms=2.0, device="cpu")
    futs, lock = [], threading.Lock()
    nthreads = (os.cpu_count() or 4) + 2

    def worker(k):
        for i in range(4):
            a, b = mats[(k + i) % 4]
            f = svc.submit("posv", a, b)
            with lock:
                futs.append(f)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(nthreads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120.0)
        assert not any(t.is_alive() for t in ts)
        svc.flush()
        for f in futs:
            assert f.result(120.0) is not None and f.meta["ok"]
    finally:
        sys.setswitchinterval(interval)
    n = 4 * nthreads
    m = svc.metrics
    tot = sum(x["value"] for x in m.snapshot()
              if x["name"] == "serving_requests_total")
    assert tot == len(futs) == n
    assert m.get("serving_resolved_total").value == n
    assert m.get("serving_admitted_total").value == n
    assert m.get("serving_queue_depth").value == 0
    assert m.get("serving_inflight_batches").value == 0
    assert svc.telemetry.tracer.balanced()
    svc.close()


def test_admission_sheds_at_the_queue_cap():
    rng = np.random.default_rng(31)
    a, b = _spd(rng, 8), rng.standard_normal((8, 1)).astype(np.float32)
    with cfg.override_scope({"serving.max_queue": "2"}):
        svc = SolverService(nb=NB, max_batch=8, max_wait_ms=0, device="cpu")
    svc.submit("posv", a, b)
    svc.submit("posv", a, b)
    with pytest.raises(AdmissionError) as ei:
        svc.submit("posv", a, b)
    assert ei.value.request_id == 3
    shed = [e for e in svc.telemetry.flight.events() if e["kind"] == "shed"]
    assert [e["request"] for e in shed] == [3]
    svc.flush()


# ---------------------------------------------------------------------
# servebench on the CPU
# ---------------------------------------------------------------------

def test_servebench_cpu_report_trace_and_gate(tmp_path, capsys):
    rep, hist = str(tmp_path / "r.json"), str(tmp_path / "h.jsonl")
    trace = str(tmp_path / "t.jsonl")
    argv = ["--device", "cpu", "--requests", "8", "--sizes", "12,16",
            "--ops", "posv,gesv", "--reps", "1", "--nb", str(NB),
            "--history", hist, "--report", rep, "--inject",
            "nan@serving:1:1", "--record-trace", trace, "--gate"]
    assert servebench.main(argv) == 0
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith('{"bench"')][-1])
    assert line["device"] == "cpu" and line["remediated"] >= 1
    with open(rep) as f:
        doc = json.load(f)
    sv = doc["serving"]
    sv = sv[-1] if isinstance(sv, list) else sv
    assert sv["workload"]["requests"] == 8 and sv["failed"] == 0
    assert sv["device"] == {"platform": "cpu", "name": "cpu", "count": 1}
    assert os.path.exists(sv["flight_dump"])
    with open(trace) as f:
        assert len(f.read().splitlines()) == 8
    # the replay drives the same stream, appended to the same ledger (its
    # timing gate is not held here: CPU times under a test run are noise)
    assert servebench.main(["--device", "cpu", "--replay", trace, "--reps",
                            "1", "--nb", str(NB), "--history", hist]) == 0
    with open(hist) as f:
        docs = [json.loads(ln) for ln in f.read().splitlines()]
    assert len(docs) == 2 and all(d["bench"] == "servebench" for d in docs)


def test_servebench_cpu_soak_audit_balances(tmp_path):
    rep = str(tmp_path / "soak.json")
    assert servebench.main([
        "--device", "cpu", "--requests", "8", "--sizes", "12", "--ops",
        "posv", "--reps", "1", "--nb", str(NB), "--soak",
        "--soak-seconds", "0.3", "--chaos",
        "nan@serving:0.3:2,delay@serving:0.2,off", "--mca",
        "serving.max_queue=4", "--mca", "chaos.delay_ms=2", "--report",
        rep]) == 0
    with open(rep) as f:
        audit = json.load(f)["admission"]["audit"]
    assert audit["balanced"] and audit["lost"] == 0 and audit["hung"] == 0
    assert audit["submitted"] == audit["admitted"] + audit["shed"]
    with pytest.raises(SystemExit):
        servebench.main(["--device", "cpu", "--chaos", "off"])
