"""The port's drivers on the CPU: the slice end to end (generate → factor
→ -x checks → the reference's perf line), and the CLI parse."""
import pytest
import torch

from dplasma_tpu.drivers import common as ref_common
from dplasma_tpu_torch.drivers import common, main
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.kernels import pallas_lu as plu
from dplasma_tpu_torch.kernels import pallas_qr as pqr
from dplasma_tpu_torch.kernels import pallas_ring as pring
from dplasma_tpu_torch.parallel import mesh as pmesh
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("argv", [
    ["testing_spotrf", "-N", "96", "-t", "32", "-x"],
    ["testing_dpotrf", "-N", "100", "-t", "16", "-x", "--nruns", "2"],
    ["testing_dpotrf", "-N", "64", "-t", "32", "-z", "8", "-x"],
    ["testing_sgemm", "-N", "96", "-M", "80", "-K", "64", "-t", "32", "-x"],
    ["testing_dgemm", "-N", "50", "-K", "70", "-t", "16", "-x",
     "--nowarmup"],
    ["testing_sgetrf", "-N", "96", "-t", "32", "-x"],
    ["testing_dgetrf", "-N", "90", "-t", "32", "-z", "8", "-x"],
    ["testing_dgetrf_1d", "-N", "64", "-t", "16", "-x", "--lookahead", "0"],
    ["testing_sgesv", "-N", "96", "-t", "32", "-x"],
    ["testing_dgesv", "-N", "90", "-t", "32", "-K", "3", "-x"],
    ["testing_sgeqrf", "-N", "96", "-t", "32", "-x"],
    ["testing_dgeqrf", "-N", "100", "-M", "130", "-t", "32", "-x"],
    ["testing_dgeqrf", "-N", "96", "-t", "32", "-z", "8", "-x"],
    ["testing_sgels", "-N", "96", "-t", "32", "-K", "4", "-x"],
    ["testing_dgels", "-N", "70", "-M", "100", "-t", "32", "-K", "3", "-x"],
    ["testing_sgelqf", "-N", "100", "-M", "70", "-t", "32", "-x"],
    ["testing_dungqr", "-N", "64", "-M", "90", "-t", "32", "-x"],
    ["testing_dposv", "-N", "100", "-t", "16", "-K", "3", "-x"],
    ["testing_dpotrs", "-N", "90", "-t", "32", "-x"],
    ["testing_dgetrf_ptgpanel", "-N", "90", "-t", "16", "-x"],
    ["testing_dgetrf_ptgpanel", "-N", "100", "-t", "16", "-p", "2", "-q",
     "4", "-x", "--lookahead", "0"],
    ["testing_spotrf", "-N", "96", "-t", "32", "-p", "2", "-q", "2", "-x"],
])
def test_driver_runs_and_checks(argv, capsys):
    common.RUNS.clear()
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[****] TIME(s)" in out
    assert "FAILED" not in out
    run = common.RUNS[-1]
    assert run["device"] == "cpu" and run["checks"]
    assert all(c["ok"] for c in run["checks"])
    assert run["ops"][0]["gflops"] > 0


def test_spotrf_driver_counts_k1_launch_routes(capsys):
    """With K1 on, the timed spotrf run routes its 2·3 − 3 update
    products; on the CPU none of them is a CUDA launch."""
    pk.enable(True)
    try:
        common.RUNS.clear()
        routed = pk.ROUTED
        assert main(["testing_spotrf", "-N", "768", "-t", "256", "-x",
                     "--nowarmup", "--device", "cpu", "-v"]) == 0
    finally:
        pk.enable(False)
    # factorization 3, check_potrf 1, the two potrs sweeps 2 each
    assert pk.ROUTED - routed == 3 + 1 + 4
    assert common.RUNS[-1]["ops"][0]["k1_launches"] == [0]
    assert "K1 launches per run" in capsys.readouterr().out


@pytest.mark.parametrize("prog", ["testing_sgetrf", "testing_sgesv"])
def test_lu_drivers_count_k3_routes(prog, capsys):
    """With panel.kernel=pallas every panel of each factorization takes
    the K3 route (3 at N=96, nb=32: warm-up and timed run); on the CPU
    none of them is a CUDA launch."""
    common.RUNS.clear()
    routed = plu.ROUTED
    with cfg.override_scope({"panel.kernel": "pallas"}):
        assert main([prog, "-N", "96", "-t", "32", "-x", "-v",
                     "--device", "cpu"]) == 0
    assert plu.ROUTED - routed == 2 * 3
    op = common.RUNS[-1]["ops"][0]
    assert op["k3_launches"] == [0] and op["k1_launches"] == [0]
    out = capsys.readouterr().out
    assert "K3 launches per run" in out and "panel.kernel=pallas" in out


@pytest.mark.parametrize("argv", [
    ["testing_dunglq", "-N", "90", "-M", "64", "-t", "32"],
    ["testing_dunmqr", "-N", "5", "-M", "64", "-t", "32"],
    ["testing_sunmlq", "-N", "5", "-M", "64", "-t", "32"],
])
def test_qr_appliers_run(argv, capsys):
    """The drivers without a -x check time their op and print the
    reference's perf line."""
    common.RUNS.clear()
    assert main(argv + ["--device", "cpu"]) == 0
    assert "[****] TIME(s)" in capsys.readouterr().out
    assert common.RUNS[-1]["ops"][0]["gflops"] > 0


def test_geqrf_driver_counts_k4_routes(capsys):
    """With panel.kernel=pallas every panel of each factorization takes
    the K4 route (3 at N=96, nb=32: warm-up and timed run); on the CPU
    none of them is a CUDA launch. The banner names the QR route."""
    common.RUNS.clear()
    routed = pqr.ROUTED
    with cfg.override_scope({"panel.kernel": "pallas"}):
        assert main(["testing_sgeqrf", "-N", "96", "-t", "32", "-x", "-v",
                     "--device", "cpu"]) == 0
    assert pqr.ROUTED - routed == 2 * 3
    run = common.RUNS[-1]
    op = run["ops"][0]
    assert op["k4_launches"] == [0] and op["k3_launches"] == [0] \
        and op["k1_launches"] == [0]
    assert all(c["ok"] for c in run["checks"])
    out = capsys.readouterr().out
    assert "K4 launches per run" in out and "QR panel.kernel=pallas" in out


@pytest.mark.parametrize("argv,k2_per_run", [
    (["testing_dpotrf", "-N", "192", "-t", "64", "-x"], 12),
    (["testing_dposv", "-N", "192", "-t", "64", "-K", "3", "-x"], None),
    (["testing_dgemm", "-N", "96", "-K", "64", "-t", "32", "-x"], 1),
    (["testing_dgetrf", "-N", "96", "-t", "32", "-x"], 21),
    (["testing_dgetrf_1d", "-N", "90", "-t", "32", "-z", "8", "-x"], None),
    (["testing_dgesv", "-N", "96", "-t", "32", "-K", "2", "-x"], None),
])
def test_dd_drivers_route_k2_on_the_cpu(argv, k2_per_run, capsys,
                                        mca=None):
    """dd_gemm=always end to end on the CPU: the checks pass and every
    limb product takes K2's route (5·3 − 3 = 12 per dpotrf at N=192,
    nb=64; one per dgemm; 21 per dgetrf factorization at N=96, nb=32, the
    ops/lu.py count), none of them a CUDA launch."""
    common.RUNS.clear()
    with cfg.override_scope(dict(mca or {}, dd_gemm="always")):
        routed = pdd.ROUTED
        assert main(argv + ["--device", "cpu", "--nowarmup", "-v"]) == 0
        routed = pdd.ROUTED - routed
    run = common.RUNS[-1]
    assert ("-x" not in argv or run["checks"]) and all(
        c["ok"] for c in run["checks"])
    op = run["ops"][0]
    assert op["k2_launches"] == [0] and op["k1_launches"] == [0]
    assert routed >= (k2_per_run or 12)
    if k2_per_run == 1:
        assert routed == 1
    out = capsys.readouterr().out
    assert "K2 launches per run = [0]" in out and "FAILED" not in out


@pytest.mark.parametrize("argv,kind,k2_per_run", [
    (["testing_dgeqrf", "-N", "96", "-t", "32", "-x"], "tree", 70),
    (["testing_dgeqrf", "-N", "96", "-t", "32", "-x"], "chain", 82),
    (["testing_dgeqrf", "-N", "96", "-M", "160", "-t", "32", "-x"], "chain",
     None),
    (["testing_dgelqf", "-N", "96", "-t", "32", "-x"], "tree", None),
    (["testing_dunmqr", "-N", "64", "-M", "96", "-t", "32"], "chain", None),
    (["testing_dgels", "-N", "96", "-t", "32", "-K", "4", "-x"], "tree",
     None),
    (["testing_dgels", "-N", "96", "-M", "160", "-t", "32", "-K", "4",
      "-x"], "chain", None),
])
def test_dd_qr_drivers_route_k2_on_the_cpu(argv, kind, k2_per_run, capsys):
    """The QR drivers on the dd route, end to end on the CPU, on the tree
    and the chain panels: 70 and 82 limb products per dgeqrf
    factorization at N=96, nb=32 (the ops/qr.py count; the chain route's
    last panel, square, is a tree panel)."""
    test_dd_drivers_route_k2_on_the_cpu(argv, k2_per_run, capsys,
                                        {"panel.kernel": kind})


def test_dd_lu_drivers_run_on_one_device_and_on_a_2x2_grid(capsys):
    """Under dd_gemm=always the f64 LU drivers run on one device (the
    cases of test_dd_drivers_route_k2_on_the_cpu) and on a 2x2 grid: the
    distributed panel's every per-rank product and solve takes the limb
    route, chip_smoke's ``cyclic_k2_launches`` a factorization (KT = 4;
    warm-up and timed run), and -x passes."""
    import chip_smoke as cs
    grid = ["-N", "64", "-t", "16", "-p", "2", "-q", "2", "--device", "cpu"]
    with cfg.override_scope({"dd_gemm": "always"}):
        assert main(["testing_dgetrf", "-N", "64", "-t", "32", "-x",
                     "--device", "cpu"]) == 0
        before = pdd.ROUTED
        assert main(["testing_dgetrf_ptgpanel"] + grid) == 0
        assert pdd.ROUTED - before == 2 * cs.cyclic_k2_launches(
            "getrf", 2, 2, 4)
        assert main(["testing_dgetrf_ptgpanel", "-x"] + grid) == 0
    assert "FAILED" not in capsys.readouterr().out


@pytest.mark.parametrize("prog", ["testing_sgetrf_ptgpanel",
                                  "testing_dgetrf_ptgpanel"])
def test_getrf_ptgpanel_grid_routes_k5(prog, capsys):
    """-p 2 -q 2 runs the distributed panel on a 2x2 virtual mesh. Under
    ring.enable=on the f32 run walks the ring route (the plain versions
    on the CPU): per factorization KT = 7 broadcasts along 'q' per
    process row (14) and KT·Q·(P−1) = 14 winner-row shifts,
    twice (warm-up and timed run); none is a CUDA launch. f64 has no
    ring kernel: the psum path, nothing routed."""
    common.RUNS.clear()
    routed = pring.ROUTED
    with cfg.override_scope({"ring.enable": "on"}):
        assert main([prog, "-N", "200", "-t", "32", "-p", "2", "-q", "2",
                     "-x", "-v", "--device", "cpu"]) == 0
    routed = pring.ROUTED - routed
    run = common.RUNS[-1]
    assert run["grid"] == [2, 2]
    assert run["checks"] and all(c["ok"] for c in run["checks"])
    assert run["ops"][0]["k5_launches"] == [0]
    out = capsys.readouterr().out
    assert "#+ grid: 2x2" in out and "ring.enable=on" in out
    if prog[8] == "s":
        assert routed == 2 * (2 * 7 + 7 * 2 * 1)
        assert "q ring True, p ring True" in out
    else:
        assert routed == 0
        assert "q ring False, p ring False" in out
    assert pmesh.active() is None


def test_every_kernel_wrapper_is_counted():
    """The driver reads the launch counter of every kernel wrapper."""
    from dplasma_tpu_torch.kernels import sbr, tridiag
    assert [lab for lab, _ in common.KERNELS] == ["k1", "k2", "k3", "k4",
                                                  "k5", "kt", "kw"]
    assert [mod for _, mod in common.KERNELS] == [pk, pdd, plu, pqr, pring,
                                                  tridiag, sbr]
    assert all(hasattr(mod, "LAUNCHES") for _, mod in common.KERNELS)


def test_parse_matches_reference_defaults():
    argv = ["-N", "1000", "-x", "--nruns", "3", "--seed=7", "-v"]
    ip = common.parse_arguments(argv)
    rp = ref_common.parse_arguments(argv)
    for f in ("N", "M", "K", "MB", "NB", "HNB", "HMB", "check", "nruns",
              "seed", "loud"):
        assert getattr(ip, f) == getattr(rp, f), f
    # -K / --NRHS: the right-hand sides of the solvers
    for argv in (["-N", "64", "-K", "5"], ["-N", "64", "--NRHS=5"]):
        assert common.parse_arguments(argv).K == \
            ref_common.parse_arguments(argv).K == 5
    assert common.default_tile(5000) == ref_common.default_tile(5000)
    assert common.parse_arguments(["-N", "8", "-t", "4", "-T", "2",
                                   "--device", "cpu"]).NB == 2


def test_bad_invocations(capsys):
    with pytest.raises(SystemExit) as e:
        common.parse_arguments(["-N", "8", "--mtx", "2"])
    assert e.value.code == 2
    assert main(["testing_sgetrf_bogus", "-N", "8"]) == 2   # no such driver
    assert main(["testing_spotrf", "--device", "cpu"]) == 2
    with pytest.raises(SystemExit, match="invalid grid"):
        main(["testing_spotrf", "-N", "8", "-p", "0", "--device", "cpu"])


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["testing_spotrf", "-N", "32", "-t", "16"])


def test_lookahead_flag_is_scoped():
    from dplasma_tpu_torch.utils import config as cfg
    before = cfg.mca_snapshot()
    assert main(["testing_dpotrf", "-N", "40", "-t", "8", "-x",
                 "--lookahead", "2", "--device", "cpu"]) == 0
    assert cfg.mca_snapshot() == before


@pytest.mark.parametrize("argv,prec,outcome", [
    (["testing_dposv_ir", "-N", "100", "-t", "32", "-K", "3"], "int8",
     "converged"),
    (["testing_dposv_ir", "-N", "100", "-t", "32", "-K", "3"], "bf16",
     "converged"),
    (["testing_dposv_ir", "-N", "100", "-t", "32", "-K", "3"], "f32",
     "converged"),
    (["testing_dposv_ir", "-N", "100", "-t", "32", "-K", "3"], "f32x2",
     "converged"),
    (["testing_dgesv_ir", "-N", "90", "-t", "32", "-K", "2"], "f32",
     "converged"),
    (["testing_dgesv_ir", "-N", "90", "-t", "32", "-K", "2"], "f32x2",
     "converged"),
    # plain plrnt: the int8 rung diverges and escalates, -x still passes
    (["testing_dgesv_ir", "-N", "90", "-t", "32", "-K", "2"], "int8",
     "escalated"),
    (["testing_dgels_ir", "-M", "130", "-N", "70", "-t", "32", "-K", "2"],
     "f32x2", "converged"),
    (["testing_dgels_ir", "-M", "130", "-N", "70", "-t", "32", "-K", "2"],
     "bf16", "converged"),
])
def test_ir_drivers_refine_and_check(argv, prec, outcome, capsys):
    """The IR drivers end to end on the CPU: the working precision from
    MCA ``ir.precision`` (as DPLASMA_MCA_IR_PRECISION sets it), the
    record's ``"refine"`` entry per run, the ``#+ refine`` line at -v 2,
    and the -x backward-error check."""
    from dplasma_tpu_torch.utils import config as cfg
    common.RUNS.clear()
    with cfg.override_scope({"ir.precision": prec}):
        assert main(argv + ["-x", "-v", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[****] TIME(s)" in out and "FAILED" not in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith(f"#+ refine[{argv[0]}]"))
    assert f"precision={prec} " in line and f" {outcome} bwd=" in line
    run = common.RUNS[-1]
    assert run["checks"] and all(c["ok"] for c in run["checks"])
    # one entry: the last timed run's solve
    assert len(run["refine"]) == 1
    s = run["refine"][-1]
    assert s["precision"] == prec and s[outcome]
    assert ("quant_guard_max" in s) == (prec == "int8")
    if prec == "int8":
        assert s["quant_guard_max"] > 0


def test_gels_ir_driver_refuses_underdetermined():
    with pytest.raises(SystemExit, match="M >= N"):
        main(["testing_dgels_ir", "-M", "40", "-N", "64", "-t", "16",
              "--device", "cpu"])


@pytest.mark.parametrize("argv,checked", [
    (["testing_ssymm", "-M", "100", "-N", "70", "-t", "32"], False),
    (["testing_dhemm", "-M", "100", "-N", "70", "-t", "32"], False),
    (["testing_ssyrk", "-N", "100", "-K", "60", "-t", "32"], False),
    (["testing_dherk", "-N", "100", "-K", "60", "-t", "32"], False),
    (["testing_dsyr2k", "-N", "100", "-K", "60", "-t", "32"], False),
    (["testing_sher2k", "-N", "100", "-K", "60", "-t", "32"], False),
    (["testing_dtrmm", "-M", "100", "-N", "70", "-t", "32"], False),
    (["testing_strsm", "-M", "100", "-N", "70", "-t", "32", "-x"], True),
    (["testing_dtrsm", "-M", "100", "-N", "70", "-t", "32", "-x"], True),
    (["testing_spotri", "-N", "100", "-t", "32", "-x"], True),
    (["testing_dpotri", "-N", "100", "-t", "32", "-X"], True),
    (["testing_spoinv", "-N", "100", "-t", "32", "-x"], True),
    (["testing_dpoinv", "-N", "100", "-t", "32", "-X", "--nruns", "2"],
     True),
    (["testing_strtri", "-N", "100", "-t", "32"], False),
    (["testing_dlauum", "-N", "100", "-t", "32"], False),
    (["testing_slange", "-M", "100", "-N", "70", "-t", "32"], False),
    (["testing_dlanhe", "-N", "100", "-t", "32"], False),
    (["testing_slansy", "-N", "100", "-t", "32"], False),
    (["testing_dlantr", "-M", "100", "-N", "70", "-t", "32"], False),
    (["testing_slanm2", "-M", "100", "-N", "70", "-t", "32", "-x"], True),
    (["testing_dgeadd", "-M", "100", "-N", "70", "-t", "32"], False),
    (["testing_stradd", "-M", "100", "-N", "70", "-t", "32"], False),
])
def test_blas3_inverse_norm_aux_drivers(argv, checked, capsys):
    """Each driver of this family times its op with the reference's
    flop count and prints the perf line (the norm drivers one per norm);
    -x / -X run the reference's checks where it has one."""
    common.RUNS.clear()
    assert main(argv + ["--device", "cpu", "-v"]) == 0
    out = capsys.readouterr().out
    assert "[****] TIME(s)" in out and "FAILED" not in out
    run = common.RUNS[-1]
    assert all(c["ok"] for c in run["checks"])
    assert bool(run["checks"]) == checked
    ops = run["ops"]
    assert len(ops) == (4 if argv[0][9:12] == "lan" and "lanm2" not in
                        argv[0] else 1)
    assert all(op["gflops"] > 0 for op in ops)


def test_print_driver(capsys):
    assert main(["testing_dprint", "-M", "10", "-N", "7", "-t", "4",
                 "-v=3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "TileMatrix(10x7, tiles 4x4 [3x2]" in out and "tensor(" in out


def test_flop_counts_are_the_references():
    """symm/syrk/syr2k/trmm/trsm/trtri/lauum/potri drivers advertise the
    reference's LAWN-41 counts."""
    from dplasma_tpu.utils import flops as ref_flops
    from dplasma_tpu_torch.utils import flops
    common.RUNS.clear()
    for prog, want in (
            ("testing_ssymm", ref_flops.symm("L", 96, 64)),
            ("testing_ssyrk", ref_flops.syrk(40, 64)),
            ("testing_ssyr2k", ref_flops.syr2k(40, 64)),
            ("testing_strmm", ref_flops.trmm("L", 96, 64)),
            ("testing_strsm", ref_flops.trsm("L", 96, 64)),
            ("testing_strtri", ref_flops.trtri(64)),
            ("testing_slauum", ref_flops.lauum(64)),
            ("testing_spotri", ref_flops.potri(64)),
            ("testing_spoinv", ref_flops.potri(64) + ref_flops.potrf(64))):
        assert main([prog, "-M", "96", "-N", "64", "-K", "40", "-t", "32",
                     "--nowarmup", "--device", "cpu"]) == 0
        assert common.RUNS[-1]["ops"][0]["flops"] == pytest.approx(want)
    assert flops.potri(64) == ref_flops.potri(64)


@pytest.mark.parametrize("prog,want", [
    # the untimed potrf's 2·KT − 3, then trtri's 2·(KT − 1) and lauum's 1
    ("testing_spotri", 5 + 2 * 3 + 1),
    ("testing_spoinv", 5 + 2 * 3 + 1),    # + potrf's 2·KT − 3
    ("testing_strtri", 2 * 3),
    ("testing_slauum", 1),
    ("testing_ssyrk", 1),
    ("testing_ssyr2k", 2),
    ("testing_ssymm", 1),
    ("testing_strmm", 1),
    ("testing_strsm", 3),                  # KT − 1 panel products
])
def test_drivers_route_k1_per_timed_run(prog, want):
    """With K1 on, each driver run routes the products the ops' k.dot
    sites make (N=1024, nb=256: KT = 4), no -x check. On the CPU none is
    a CUDA launch."""
    pk.enable(True)
    try:
        common.RUNS.clear()
        routed = pk.ROUTED
        assert main([prog, "-N", "1024", "-M", "1024", "-K", "512", "-t",
                     "256", "--nowarmup", "--device", "cpu"]) == 0
        assert pk.ROUTED - routed == want
        assert common.RUNS[-1]["ops"][0]["k1_launches"] == [0]
    finally:
        pk.enable(False)


@pytest.mark.parametrize("prog,want", [
    ("testing_dpotri", 2 * 3 + 4 * 4 + 1),     # trtri, its leaves, lauum
    ("testing_dpoinv", 17 + 2 * 3 + 4 * 4 + 1),  # + potrf's 5·KT − 3
])
def test_dd_inverse_drivers_route_k2(prog, want, capsys):
    """Under dd_gemm=always every product of the timed run takes the K2
    route (N=128, nb=32: KT = 4; two Newton steps of two products per
    trtri leaf), none K1's; -x passes."""
    pk.enable(True)
    try:
        with cfg.override_scope({"dd_gemm": "always"}):
            common.RUNS.clear()
            assert main([prog, "-N", "128", "-t", "32", "--nowarmup",
                         "--device", "cpu"]) == 0
            routed = pdd.ROUTED
            assert main([prog, "-N", "128", "-t", "32", "-x", "--nowarmup",
                         "--device", "cpu"]) == 0
            routed = pdd.ROUTED - routed
    finally:
        pk.enable(False)
    run = common.RUNS[-1]
    assert run["checks"] and all(c["ok"] for c in run["checks"])
    # the timed run, plus the driver's potrf (potri) and the check's
    # product
    assert routed == want + (17 if prog.endswith("potri") else 0) + 1
    assert run["ops"][0]["k1_launches"] == [0]


def test_registry_has_38_drivers_and_check_inv_parses():
    from dplasma_tpu.drivers import testers as ref_testers
    from dplasma_tpu_torch.drivers import testers
    assert len(testers.DRIVERS) == 66   # all of the reference's drivers
    assert set(testers.DRIVERS) <= set(ref_testers.DRIVERS)
    for argv in (["-N", "8", "-X"], ["-N", "8", "--check_inv"],
                 ["-N", "8", "-xX"]):
        ip, rp = common.parse_arguments(argv), \
            ref_common.parse_arguments(argv)
        assert ip.check_inv and ip.check_inv == rp.check_inv
        assert ip.check == rp.check


@pytest.mark.parametrize("prog", ["testing_csyrk", "testing_zpotri",
                                  "testing_cherk", "testing_zlansy",
                                  "testing_ctrsm", "testing_zgeadd"])
def test_complex_drivers_raise(prog):
    """The complex drivers run (every one of them with its -x check:
    tests/test_torch_complex_drivers.py)."""
    assert main([prog, "-N", "16", "-t", "8", "-x", "--device", "cpu"]) == 0
    run = common.RUNS[-1]
    assert run["prec"] == prog[8] and all(c["ok"] for c in run["checks"])
