"""Port parity: the drivers' resilience flags (``--abft --inject
--max-retries --run-timeout``, env ``DPLASMA_INJECT``) and the
``getrf_nopiv`` driver against the JAX package's drivers, on the CPU.

- Driver runs with ``--abft --inject=KIND@STAGE:1:1`` for gemm, potrf,
  getrf and getrf_nopiv (and a ``reject`` plan, and a clean ``--abft``
  run) whose report sections name the same faults, rungs, outcome and
  winner as the reference driver's. Site 0 of a stage is the first call
  in both packages: the port taps at run time, the reference at trace
  time (``resilience/inject.py``), so plans are held at ``COUNT=1``.
- The ``getrf_nopiv`` driver's -x check in every precision and its
  ladder's escalation to ``getrf_rbt`` and ``getrf_qrf``; the IR
  testers' fallback rung to the full-precision solve.
- Where the port differs on purpose: a kernel that fails under a
  resilience flag fails the run; the kernel-fallback rung follows an
  injected fault only, and the driver's close undoes it. The flip seeds
  chip_smoke derives from ABFT's floor are classed as predicted.
"""
import json

import pytest
import torch

from dplasma_tpu.drivers import main as ref_main
from dplasma_tpu_torch.drivers import common, main
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import lu
from dplasma_tpu_torch.resilience import guard
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

import chip_smoke as cs


#: (prog, argv): each run once in both packages
DRIVER_CASES = {
    "potrf_nan_trsm": ("testing_dpotrf", "-N 96 -t 32 -x -v --abft "
                       "--inject=nan@trsm:1:1"),
    "potrf_bitflip_gemm": ("testing_dpotrf", "-N 96 -t 32 -x --abft "
                           "--inject=bitflip@gemm:1:1"),
    "gemm_bitflip": ("testing_sgemm", "-N 96 -M 80 -K 64 -t 32 -x --abft "
                     "--inject=bitflip@gemm:1:1"),
    "gemm_zero": ("testing_dgemm", "-N 64 -K 64 -t 32 -x --abft "
                  "--inject=zero@gemm:1:1"),
    "getrf_bitflip_gemm": ("testing_dgetrf", "-N 96 -t 32 -x --abft "
                           "--inject=bitflip@gemm:1:1"),
    "getrf_nopiv_nan_getrf": ("testing_dgetrf_nopiv", "-N 96 -t 32 -x "
                              "--abft --inject=nan@getrf:1:1"),
    "getrf_nopiv_nan_trsm": ("testing_dgetrf_nopiv", "-N 96 -t 32 -x "
                             "--inject=nan@trsm:1:1"),
    "potrf_reject": ("testing_spotrf", "-N 96 -t 32 -x "
                     "--inject=reject@potrf:1:1"),
    "potrf_clean_abft": ("testing_dpotrf", "-N 96 -t 32 -x --abft"),
    # a finite diagonal flip of the first tile factor past the ABFT
    # floor, the seed derived as on the card: classed silent, flagged
    "spotrf_silent_flip": ("testing_spotrf", "-N 96 -t 32 -x --abft "
                           "--inject=bitflip@potrf:1:1 --seed %d"
                           % cs.silent_flip_seed(96, 32)[0]),
}


def _section(doc):
    """What both packages must agree on: per progress call the plan, the
    faults, each attempt's action, label, verdict and classification
    (and its ABFT verdict), the outcome and the winner."""
    out = []
    for r in doc["resilience"]:
        out.append({
            "injection": r["injection"] and {
                "plan": r["injection"]["plan"],
                "faults": [{k: (list(v) if isinstance(v, (list, tuple))
                                else v) for k, v in f.items()}
                           for f in r["injection"]["faults"]]},
            "attempts": [(a["action"], a["label"], a["ok"],
                          a["classification"],
                          a["abft"] and (a["abft"]["detected"],
                                         a["abft"]["corrected"],
                                         a["abft"]["ok"]))
                         for a in r["attempts"]],
            "outcome": r["outcome"], "winner": r["winner"],
            "faults_detected": r["faults_detected"]})
    return out


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Each case through the reference's driver once (its jit compiles
    dominate the module)."""
    d = tmp_path_factory.mktemp("ref")
    out = {}
    for key, (prog, argv) in DRIVER_CASES.items():
        rep = d / f"{key}.json"
        rc = ref_main(argv.split() + [f"--report={rep}"], prog=prog)
        out[key] = (rc, json.load(open(rep)))
    return out


@pytest.mark.parametrize("key", list(DRIVER_CASES))
def test_driver_resilience_section_is_the_references(key, reference_runs,
                                                     tmp_path, capsys):
    prog, argv = DRIVER_CASES[key]
    rep = tmp_path / "r.json"
    k1 = pk.enabled()
    try:
        rc = main([prog] + argv.split() + ["--device", "cpu",
                                           f"--report={rep}"])
        after = (pk.enabled(), cfg.mca_snapshot().get("panel.kernel"))
    finally:
        pk.enable(k1)
        cfg.mca_unset("panel.kernel")
    # Driver.close undid the kernel-fallback rung of the reject plan
    assert after == (k1, None)
    out = capsys.readouterr().out
    want_rc, want = reference_runs[key]
    doc = json.load(open(rep))
    assert rc == want_rc == 0, out
    assert "FAILED" not in out
    assert _section(doc) == _section(want)
    if key == "potrf_reject":
        assert [a["action"] for a in doc["resilience"][0]["attempts"]] == \
            ["primary", "kernel_fallback"]
    if key == "spotrf_silent_flip":
        assert [(a["action"], a["classification"])
                for a in doc["resilience"][0]["attempts"]] == \
            [("primary", "silent"), ("retry", None)]
    if key == "potrf_clean_abft":
        r = doc["resilience"][0]
        assert r["outcome"] == "clean" and len(r["attempts"]) == 1
    assert "resilience_attempts_total" in json.dumps(doc["metrics"])


def test_driver_prints_the_ladder_at_v2(capsys):
    assert main(["testing_dpotrf", "-N", "64", "-t", "16", "-x", "-v",
                 "--abft", "--inject=nan@trsm:1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "#+ resilience: injected nan at trsm site 0" in out
    assert "(retry:testing_dpotrf) ok" in out
    assert "outcome remediated after 2 attempt(s)" in out
    op = common.RUNS[-1]["ops"][0]
    assert [a["action"] for a in op["attempts"]] == ["primary", "retry"]


def _poison_unbutterflied(monkeypatch, A0, always=False):
    """Make ``lu.getrf_nopiv`` fail (a NaN factor) on the driver's own
    matrix A0 — or on every input — so the ladder must escalate."""
    real = lu.getrf_nopiv

    def poisoned(A, *a, **k):
        F = real(A, *a, **k)
        if always or torch.equal(A.data, A0.data):
            F = F.like(torch.full_like(F.data, float("nan")))
        return F
    monkeypatch.setattr(lu, "getrf_nopiv", poisoned)


@pytest.mark.parametrize("winner,always", [("getrf_rbt", False),
                                           ("getrf_qrf", True)])
def test_getrf_nopiv_escalates_and_checks_the_winner(
        winner, always, monkeypatch, capsys):
    """A deterministic numerical failure of the unpivoted LU walks the
    retries, then the butterfly (which changes the matrix) or, when that
    fails too, the LU/QR hybrid; the -x check solves with the winner's
    factor. No fault was injected, so the kernel-fallback rung is passed
    over (the reference takes it)."""
    from dplasma_tpu_torch.ops import generators
    monkeypatch.setattr(guard, "_BACKOFF_S", 0.0)
    A0 = generators.plghe(64.0, 64, 16, seed=3872, dtype=torch.float64,
                          device="cpu")
    _poison_unbutterflied(monkeypatch, A0, always)
    common.RUNS.clear()
    rc = main(["testing_dgetrf_nopiv", "-N", "64", "-t", "16", "-x", "-v",
               "--run-timeout=3600", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    want = ["primary", "retry", "retry", "algo_fallback"]
    if always:
        want.append("algo_fallback")
    assert f"(algo_fallback:{winner}) ok" in out
    tag = "GETRF_QRF" if always else "GETRF_RBT"
    assert f"[SUCCESS] {tag} |b-Ax|" in out
    assert [a["action"] for a in common.RUNS[-1]["ops"][0]["attempts"]] \
        == want


def test_getrf_nopiv_driver_checks_in_every_precision(capsys):
    for prec in "sdcz":
        assert main([f"testing_{prec}getrf_nopiv", "-N", "70", "-t", "16",
                     "-x", "--device", "cpu"]) == 0
    assert "FAILED" not in capsys.readouterr().out


@pytest.mark.parametrize("prog,argv,winner", [
    ("testing_dposv_ir", "-N 64 -t 32 -K 2 -x", "posv_dd"),
    ("testing_dgesv_ir", "-N 64 -t 32 -K 2 -x", "gesv_dd"),
    ("testing_dgels_ir", "-M 96 -N 64 -t 32 -K 2 -x", "gels_dd")])
def test_ir_solvers_fall_back_to_the_full_precision_solve(
        prog, argv, winner, monkeypatch, capsys):
    """The IR testers' ``fallbacks`` rung: a solver that keeps failing
    (here: its solution is NaN) walks the retries to the full-precision
    solve, whose answer passes -x."""
    from dplasma_tpu_torch.ops import refine
    name = {"posv_dd": "posv_ir", "gesv_dd": "gesv_ir",
            "gels_dd": "gels_ir"}[winner]
    real = getattr(refine, name)

    def broken(*a, **k):
        X, info = real(*a, **k)
        return X.like(torch.full_like(X.data, float("nan"))), info
    monkeypatch.setattr(guard, "_BACKOFF_S", 0.0)
    monkeypatch.setattr(refine, name, broken)
    rc = main([prog] + argv.split() + ["--run-timeout=3600", "--device",
                                       "cpu", "-v"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"(algo_fallback:{winner}) ok" in out and "FAILED" not in out
    assert [a["action"] for a in common.RUNS[-1]["ops"][0]["attempts"]] \
        == ["primary", "retry", "retry", "algo_fallback"]


@pytest.mark.parametrize("case,cls", [("silent", "silent"),
                                      ("overflow", "numerical")])
def test_derived_flip_seeds_are_classed_as_predicted(case, cls, tmp_path):
    """chip_smoke's seeds, derived at N=512, nb=128 from the ABFT floor:
    the potrf-stage flip lands on a diagonal entry of the first tile
    factor and moves it past the floor, finite (``silent``, flagged by
    ABFT alone); the gemm-stage flip sets bit 30 of a trailing-update
    product, and the factor overflows (``numerical``). Both heal on the
    retry and pass -x."""
    N, nb = 512, 128
    stage, (seed, idx, bit) = (
        ("potrf", cs.silent_flip_seed(N, nb)) if case == "silent"
        else ("gemm", cs.overflow_flip_seed(N, nb)))
    bits, floor = cs.flip_bits_above_floor(N)
    assert case == "overflow" or (idx[0] == idx[1] and bit in bits)
    assert floor == pytest.approx(60 * 2.0 ** -23 * N * 1.5 * N)
    rep = tmp_path / "r.json"
    assert main(["testing_spotrf", "-N", str(N), "-t", str(nb), "-x",
                 "--abft", f"--inject=bitflip@{stage}:1:1", "--seed",
                 str(seed), "--device", "cpu", f"--report={rep}"]) == 0
    r = json.load(open(rep))["resilience"][0]
    assert [tuple(f["index"]) for f in r["injection"]["faults"]] == [idx]
    assert [(a["action"], a["ok"], a["classification"],
             (a["abft"] or {}).get("detected"))
            for a in r["attempts"]] == [("primary", False, cls, True),
                                        ("retry", True, None, False)]


@pytest.mark.parametrize("flag", ["--abft", "--inject=nan@trsm:1:1",
                                  "--run-timeout=3600"])
def test_a_failing_kernel_under_a_resilience_flag_fails_the_run(
        flag, monkeypatch):
    """Under any resilience flag, a K1 launch failure is no ladder class:
    it leaves ``main`` (the program exits non-zero) with K1 still on and
    ``panel.kernel`` untouched."""
    def launch_failed(*a, **k):
        raise RuntimeError("K1 wgmma launch failed: cudaError 700")
    monkeypatch.setattr(pk, "gemm_reference", launch_failed)
    k1 = pk.enabled()
    pk.enable(True)
    try:
        with pytest.raises(RuntimeError, match="K1 wgmma launch failed"):
            main(["testing_spotrf", "-N", "512", "-t", "256", "-x", flag,
                  "--device", "cpu"])
        assert pk.enabled()
        assert cfg.mca_snapshot().get("panel.kernel") is None
    finally:
        pk.enable(k1)


@pytest.mark.parametrize("panel", [None, "pallas"])
def test_driver_close_restores_what_the_kernel_rung_demoted(panel,
                                                            capsys):
    """A reject plan walks to the kernel-fallback rung; once the driver
    closes, K1 and ``panel.kernel`` are as they were before the run."""
    k1 = pk.enabled()
    pk.enable(True)
    try:
        with cfg.override_scope({"panel.kernel": panel}):
            common.RUNS.clear()
            assert main(["testing_spotrf", "-N", "64", "-t", "16", "-x",
                         "--inject=reject@potrf:1:1", "--device",
                         "cpu"]) == 0
            assert pk.enabled()
            assert cfg.mca_snapshot().get("panel.kernel") == panel
    finally:
        pk.enable(k1)
    # the rejected primary ran to no output, so the op record holds the
    # rung alone
    att = common.RUNS[-1]["ops"][0]["attempts"]
    assert [a["action"] for a in att] == ["kernel_fallback"]


def test_behavioral_fault_prints_without_an_index(capsys):
    """A ``delay`` fault has no element: the port's ladder lines name
    its stage and site alone (the reference's ``format_lines`` raises
    KeyError on it, ROADMAP queue 3); the run is clean."""
    with cfg.override_scope({"chaos.delay_ms": "1"}):
        assert main(["testing_dpotrf", "-N", "64", "-t", "32", "-v",
                     "--inject=delay@potrf:1:1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "#+ resilience: injected delay at potrf site 0\n" in out
    assert "outcome clean after 1 attempt(s)" in out
