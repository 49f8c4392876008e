"""The ``testing_c*`` and ``testing_z*`` drivers through
``drivers.main`` on the CPU: every driver of ``testers.DRIVERS`` in c and
z with its -x check (N=70, nb=32, 3 right-hand sides: edge tiles), the
IR solvers refusing complex with the reference's ``TypeError``; the new
LU-family drivers (getrf_incpiv, getrf_qrf under each ``--criteria``,
gesv_incpiv) in all four precisions; and the z drivers under MCA
``dd_gemm=always`` with their limb products counted on the K2 route.
"""
import pytest

from dplasma_tpu.drivers import common as ref_common
from dplasma_tpu.drivers import testers as ref_testers
from dplasma_tpu_torch.drivers import common, main, testers
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

IR = ("posv_ir", "gesv_ir", "gels_ir")
ARGV = ["-N", "70", "-t", "32", "-K", "3", "-x", "--device", "cpu"]


def _run(prog, argv=ARGV):
    rc = main([prog] + argv)
    run = common.RUNS[-1]
    assert rc == 0, (prog, run["checks"])
    assert all(c["ok"] for c in run["checks"]), run["checks"]
    return run


@pytest.mark.parametrize("prec", ["c", "z"])
@pytest.mark.parametrize("algo", sorted(set(testers.DRIVERS) - set(IR)))
def test_complex_driver_runs_and_checks(prec, algo, capsys):
    run = _run(f"testing_{prec}{algo}")
    assert run["prec"] == prec
    assert algo in ref_testers.DRIVERS


@pytest.mark.parametrize("prec", ["c", "z"])
@pytest.mark.parametrize("algo", IR)
def test_ir_drivers_refuse_complex_as_the_reference(prec, algo):
    with pytest.raises(TypeError, match="float64"):
        main([f"testing_{prec}{algo}"] + ARGV)


@pytest.mark.parametrize("prec", ["s", "d", "c", "z"])
@pytest.mark.parametrize("prog,extra", [
    ("getrf_incpiv", []), ("gesv_incpiv", []),
    ("getrf_qrf", ["--criteria", "1"]),
    ("getrf_qrf", ["--criteria=2", "-a", "0.5"])])
def test_lu_family_drivers(prec, prog, extra, capsys):
    """-x in all four precisions; getrf_qrf under the data-driven
    criteria (1 higham_sum, 2 mumps), which pick a QR panel where an LU
    panel would grow."""
    run = _run(f"testing_{prec}{prog}",
               ["-N", "100", "-t", "32", "-K", "2", "-x", "-v",
                "--device", "cpu"] + extra)
    assert run["checks"]
    if prog == "getrf_qrf":
        crit = "mumps" if "--criteria=2" in extra else "higham_sum"
        assert f"criterion={crit}" in capsys.readouterr().out


@pytest.mark.parametrize("prec", ["s", "d", "c", "z"])
@pytest.mark.parametrize("crit", ["0", "3"])
def test_getrf_qrf_forced_criteria(prec, crit, capsys):
    """The forced criteria (0 alternating, 3 random) choose their panels
    whatever the data, by the reference's rules (random: the parity of
    ``hash((seed, k))``), in every precision."""
    assert main([f"testing_{prec}getrf_qrf", "-N", "100", "-t", "32",
                 "-v", "--criteria", crit, "--device", "cpu"]) == 0
    tab = [int(k % 2 == 0) if crit == "0" else
           int(hash((3872, k)) % 2 == 0) for k in range(4)]
    assert f"lu_tab={tab}" in capsys.readouterr().out


def test_criteria_and_alpha_parse_as_the_reference():
    assert testers.CRITERIA == ref_testers.CRITERIA
    for argv in (["-N", "8"], ["-N", "8", "--criteria", "2", "-a", "0.25"],
                 ["-N", "8", "--criteria=3", "--alpha=7"]):
        ip = common.parse_arguments(argv)
        rp = ref_common.parse_arguments(argv)
        assert (ip.criteria, ip.alpha) == (rp.criteria, rp.alpha)


@pytest.mark.parametrize("algo", ["potrf", "posv", "getrf", "gesv",
                                  "geqrf", "gels", "getrf_incpiv",
                                  "gemm", "trsm", "poinv"])
def test_z_drivers_under_dd(algo, capsys):
    """Under dd_gemm=always the z drivers pass -x with their products on
    the K2 route (two limb products per complex product)."""
    with cfg.override_scope({"dd_gemm": "always"}):
        routed = pdd.ROUTED
        run = _run(f"testing_z{algo}")
        assert pdd.ROUTED - routed > 0
    assert run["prec"] == "z"
