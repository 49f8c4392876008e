"""The eigen/SVD drivers of the port against the reference's, through
both CLIs on the CPU: ``heev``, ``hetrd``, ``gesvd``, ``gebrd``,
``hbrdt`` and ``gebrd_ge2gb`` in s, d, c and z (N = 40, nb = 16: edge
tiles; ``gesvd`` and ``gebrd_ge2gb`` also 40×24 and 24×40) give the same
exit codes and -x verdicts; each run of ``heev`` (``auto`` is the
dense solver: no kernel), ``hetrd``, ``hbrdt``, ``gebrd`` and ``gesvd``
routes the steps its schedules count through KW and each tridiagonal
through KT (on the CPU a route is not a CUDA launch); the registry holds
59 drivers, the reference's 66 less the six ``*_dtd`` drivers and
``getrf_nopiv``."""
import contextlib
import io

import pytest

from dplasma_tpu.drivers import main as ref_main
from dplasma_tpu.drivers import testers as ref_testers
from dplasma_tpu_torch.drivers import common, main, testers
from dplasma_tpu_torch.kernels import sbr, tridiag
from dplasma_tpu_torch.ops import band
from torch_threads import one_torch_thread  # noqa: F401

NEW = ("heev", "hetrd", "gesvd", "gebrd", "hbrdt", "gebrd_ge2gb")
ARGV = ["-N", "40", "-t", "16", "-x"]


def _verdicts(out: str):
    return [ln.split("]")[0] + "] " + ln.split("]")[1].split(" residual")[0]
            for ln in out.splitlines()
            if ln.startswith(("[SUCCESS]", "[FAILED]"))]


def _run(entry, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry(argv)
    out = buf.getvalue()
    return rc, _verdicts(out), [ln.split(":")[1].split("PxQxg")[0].strip()
                                for ln in out.splitlines()
                                if ln.startswith("[****] TIME")]


@pytest.mark.parametrize("prec", ["s", "d", "c", "z"])
@pytest.mark.parametrize("algo", NEW)
def test_new_drivers_match_the_reference_cli(prec, algo):
    prog = f"testing_{prec}{algo}"
    want = _run(ref_main, [prog] + ARGV)
    got = _run(main, [prog] + ARGV + ["--device", "cpu"])
    assert got == want
    assert got[0] == 0
    assert got[2] == [prog]
    if algo not in ("hetrd", "gebrd"):
        assert got[1] and all(v.startswith("[SUCCESS]") for v in got[1])


@pytest.mark.parametrize("prec", ["s", "z"])
@pytest.mark.parametrize("algo", ["gesvd", "gebrd_ge2gb"])
@pytest.mark.parametrize("m,n", [(40, 24), (24, 40)])
def test_rectangular_drivers_match_the_reference_cli(prec, algo, m, n):
    argv = [f"testing_{prec}{algo}", "-M", str(m), "-N", str(n), "-t",
            "16", "-x"]
    want = _run(ref_main, argv)
    got = _run(main, argv + ["--device", "cpu"])
    assert got == want and got[0] == 0
    assert got[1] and all(v.startswith("[SUCCESS]") for v in got[1])


def _herm_steps(n, b):
    return sum(band._sbr_banded_schedule(n, bb, w)[2]
               for bb, w in band.sweep_ladder(b)
               if band._sbr_banded_schedule(n, bb, w) is not None)


def _bidiag_steps(m, n, b):
    k = min(m, n)
    return sum(band._sbr_schedule_bidiag(k, bb, w, m < n)[3]
               for bb, w in band.sweep_ladder(b))


@pytest.mark.parametrize("argv,kw,kt", [
    (["testing_dheev", "-N", "40", "-t", "16"], 0, 0),
    (["testing_dhetrd", "-N", "40", "-t", "16"], _herm_steps(40, 16), 0),
    (["testing_dhbrdt", "-N", "40", "-t", "16"], _herm_steps(40, 31), 0),
    (["testing_dgebrd", "-N", "40", "-t", "16"], _bidiag_steps(40, 40, 31),
     0),
    (["testing_dgesvd", "-M", "40", "-N", "24", "-t", "16"],
     _bidiag_steps(40, 24, 23), 1),
    (["testing_dgesvd", "-M", "24", "-N", "40", "-t", "16"],
     _bidiag_steps(24, 40, 31), 1)])
def test_timed_runs_route_the_counted_steps(argv, kw, kt):
    """Each timed run calls the KW wrapper once per sweep (every sweep
    here: b <= 31, two of them, b -> b/4 -> 1; the wrapper runs the
    ``kw`` steps of each, step by step on the CPU) and KT once per
    tridiagonal."""
    sbr.reset_counts()
    tridiag.reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(argv + ["--device", "cpu", "-v"])
    assert rc == 0
    # on the CPU the wrappers count routes, not launches
    op = common.RUNS[-1]["ops"][0]
    assert op["kw_launches"] == [0] and op["kt_launches"] == [0]
    runs = 2   # the warm-up and the timed run
    sweeps = 2 if kw else 0
    assert sbr.ROUTED == runs * sweeps and sbr.STEPS == 0
    assert tridiag.ROUTED == runs * kt


def test_registry_holds_65_of_the_references_66():
    missing = set(ref_testers.DRIVERS) - set(testers.DRIVERS)
    assert set(testers.DRIVERS) <= set(ref_testers.DRIVERS)
    assert len(testers.DRIVERS) == 65 and len(ref_testers.DRIVERS) == 66
    assert missing == {"getrf_nopiv"}
    assert all(a in testers.DRIVERS for a in NEW)
