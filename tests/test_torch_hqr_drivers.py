"""The hierarchical QR, LDLᴴ and butterfly drivers of the port against
the reference's, through both CLIs on the CPU: ``geqrf_hqr``,
``gelqf_hqr``, ``geqrf_systolic``, ``gelqf_systolic``, ``geqrf_rd``,
``unmqr_hqr``, ``unmlq_hqr``, ``unmqr_systolic``, ``unmlq_systolic``,
``pivgen``, ``hetrf`` and ``hebut`` in s and z (N = 70, nb = 32, 3
right-hand sides: edge tiles) give the same exit codes and -x verdicts
(c and z of every driver: ``test_torch_complex_drivers.py``); the HQR
and butterfly flags parse to the reference's fields and build the
reference's tree; with K1 on, each timed run routes the products the
ops count (on the CPU a route is not a CUDA launch); the registry holds
these 12 with the rest (59 drivers since the eigen/SVD slice)."""
import contextlib
import dataclasses
import io

import pytest

from dplasma_tpu.drivers import common as ref_common
from dplasma_tpu.drivers import main as ref_main
from dplasma_tpu.drivers import testers as ref_testers
from dplasma_tpu_torch.drivers import common, main, testers
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import hqr
from torch_threads import one_torch_thread  # noqa: F401

NEW = ("geqrf_hqr", "gelqf_hqr", "geqrf_systolic", "gelqf_systolic",
       "geqrf_rd", "unmqr_hqr", "unmlq_hqr", "unmqr_systolic",
       "unmlq_systolic", "pivgen", "hetrf", "hebut")
ARGV = ["-N", "70", "-t", "32", "-K", "3", "-x"]


def _verdicts(out: str):
    return [ln.split("]")[0] + "] " + ln.split("]")[1].split(" residual")[0]
            for ln in out.splitlines()
            if ln.startswith(("[SUCCESS]", "[FAILED]"))]


def _run(entry, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry(argv)
    out = buf.getvalue()
    return rc, _verdicts(out), [ln for ln in out.splitlines()
                                if ln.startswith("#+ pivgen")]


@pytest.mark.parametrize("prec", ["s", "z"])
@pytest.mark.parametrize("algo", NEW)
def test_new_drivers_match_the_reference_cli(prec, algo):
    prog = f"testing_{prec}{algo}"
    want = _run(ref_main, [prog] + ARGV)
    got = _run(main, [prog] + ARGV + ["--device", "cpu"])
    assert got == want
    assert got[0] == 0
    if algo.startswith("geqrf"):
        assert got[1] and all(v.startswith("[SUCCESS]") for v in got[1])


@pytest.mark.parametrize("argv", [
    ["-N", "8"],
    ["-N", "8", "--qr_a", "4", "--qr_p", "2", "--treel", "3", "--treeh",
     "1", "-d", "1", "-r", "1", "-y", "2"],
    ["-N", "8", "--qr_a=2", "--qr_p=3", "--treel=4", "--treeh=0",
     "--domino=0", "--tsrr=1", "--butlvl=3"],
    ["-N", "8", "-d1", "-r0", "-y3", "-x"],
])
def test_hqr_and_butterfly_flags_parse_as_the_reference(argv):
    ip, rp = common.parse_arguments(argv), ref_common.parse_arguments(argv)
    for f in ("qr_a", "qr_p", "lowlvl_tree", "highlvl_tree", "qr_domino",
              "qr_tsrr", "butterfly_level", "check", "N"):
        assert getattr(ip, f) == getattr(rp, f), f


@pytest.mark.parametrize("argv", [
    [], ["--qr_a", "4", "--treeh", "1"],
    ["--treel", "2", "--qr_p", "2", "-d", "1", "-r", "1"],
    ["--treel", "0", "--treeh", "1", "--qr_a", "3"], ["-p", "2"]])
def test_driver_trees_are_the_references(argv):
    """``_hqr_tree_from_ip`` builds the reference's tree; as there,
    ``-d/--domino`` and ``-r/--tsrr`` do not reach it."""
    full = ["-N", "100", "-t", "10"] + argv
    ip = common.parse_arguments(full + ["--device", "cpu"])
    rp = ref_common.parse_arguments(full)
    drv = common.Driver(ip, "testing_sgeqrf_hqr")
    try:
        got = testers._hqr_tree_from_ip(drv, 10)
    finally:
        drv.close()
    want = ref_testers._hqr_tree_from_ip(type("D", (), {"ip": rp})(), 10)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert not got.domino and not got.tsrr


def _tree_products(tree, kt, applies):
    ops = [len(tree.leaders(k)) + len(tree.schedule(k)) for k in range(kt)]
    if applies:
        return 3 * sum(ops)
    return sum(n * (4 if k < kt - 1 else 1) for k, n in enumerate(ops))


@pytest.mark.parametrize("prog,argv,want", [
    ("testing_sgeqrf_hqr", [],
     _tree_products(hqr.hqr_tree(3, a=1), 3, False)),
    ("testing_sgeqrf_hqr", ["--qr_a", "2", "--treeh", "1"],
     _tree_products(hqr.hqr_tree(3, a=2, hlvl="greedy"), 3, False)),
    ("testing_sgeqrf_rd", [], _tree_products(hqr.svd_tree(3), 3, False)),
    ("testing_sgelqf_systolic", [],
     _tree_products(hqr.systolic_tree(3), 3, False)),
    ("testing_sunmqr_hqr", [],
     sum(_tree_products(hqr.hqr_tree(3, a=1), 3, ap) for ap in (0, 1))),
    ("testing_sunmlq_systolic", [],
     sum(_tree_products(hqr.systolic_tree(3), 3, ap) for ap in (0, 1))),
    ("testing_shetrf", [], 3 - 1),
    ("testing_shebut", [], (3 - 1) + 3 * 2 * (3 - 1) + 2),
])
def test_timed_runs_route_the_counted_products_to_k1(prog, argv, want):
    """N = 768, nb = 256 (KT = 3), K1 on, no warm-up: the timed run
    routes every product ops/hqr.py and ops/ldl.py count (all three
    dimensions >= 256), hebut's one right-hand side padded to a tile;
    the appliers' drivers also factor, untimed, first."""
    pk.enable(True)
    try:
        routed = pk.ROUTED
        assert main([prog, "-N", "768", "-t", "256", "--nowarmup",
                     "--device", "cpu"] + argv) == 0
        routed = pk.ROUTED - routed
    finally:
        pk.enable(False)
    assert routed == want
    assert common.RUNS[-1]["ops"][0]["k1_launches"] == [0]


def test_pivgen_checks_the_whole_grid(capsys):
    assert main(["testing_dpivgen", "-N", "300", "-t", "32",
                 "--device", "cpu"]) == 0
    assert "#+ pivgen: 94 trees checked OK (MT=10)" in capsys.readouterr().out


def test_registry_holds_53_drivers_all_in_the_reference():
    # 53 after the HQR slice; the eigen/SVD slice brought it to 59, the
    # DTD drivers to 65
    assert len(testers.DRIVERS) == 65
    assert set(testers.DRIVERS) <= set(ref_testers.DRIVERS)
    assert set(NEW) <= set(testers.DRIVERS)
