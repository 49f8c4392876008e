"""Port parity: the hierarchical QR trees and ops (``ops.hqr``) of
``dplasma_tpu_torch`` against ``dplasma_tpu`` (the c and z ops are in
``test_torch_hqr_complex.py``).

The tree algebra is host-side index arithmetic in both packages, so its
answers must be EQUAL: every panel's elimination schedule, its leaders
and the vtable (gettype, currpiv, nextpiv/prevpiv walks) over the whole
pivgen grid (5 low trees × 2 high trees × a ∈ {1, 2, 4} × p ∈ {1, 2,
4}), each with domino and tsrr off and on, the systolic trees (p ∈ {1,
2, 3}) and the svd-ratio tree, at MT ∈ {1, 2, 5, 9, 16}; ``check_tree``
gives the same verdict (and a corrupted schedule raises
``AssertionError`` in both).

The ops in s and d are held as ``hqr_parity`` says, the factored
matrix, Tts, Ttt and Q within 1e-4 (s) and 1e-12 (d) of the reference's
at a square and an odd size; d also under MCA ``dd_gemm=always``, where
every product is one K2 route and the results stay within 1e-12 of the
reference's f64 answer (the reference's own dd route compiles a limb
program per product shape on the CPU, 35 s at the smallest size, so it
is not run here).
"""
import dataclasses
import itertools

import pytest
import torch

import hqr_parity as hp
from dplasma_tpu.ops import hqr as ref_hqr
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.ops import hqr
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

LOW = ("flat", "greedy", "fibonacci", "binary", "greedy1p")
HIGH = ("flat", "greedy")


def _answers(mod, tree):
    """Every question the factorization asks of a tree, per panel."""
    out = []
    MT = tree.MT
    for k in range(MT):
        sched = [(e.piv, e.victim, e.kind, e.round)
                 for e in tree.schedule(k)]
        leaders = tree.leaders(k)
        types = [tree.gettype(k, m) for m in range(k, MT)]
        curr = [tree.currpiv(k, v) for _, v, _, _ in sched]
        walks = []
        for piv in sorted({p for p, *_ in sched}):
            fwd, m = [], MT
            while (m := tree.nextpiv(k, piv, m)) != MT:
                fwd.append(m)
            back, m = [], MT
            while (m := tree.prevpiv(k, piv, m)) != MT:
                back.append(m)
            walks.append((piv, fwd, back))
        out.append((sched, leaders, tree.getnbgeqrf(k), types, curr,
                    walks))
    try:
        mod.check_tree(tree)
        verdict = "ok"
    except AssertionError as exc:
        verdict = str(exc)
    return out, verdict


def _same_tree(ref_tree):
    want = _answers(ref_hqr, ref_tree)
    got = _answers(hqr, hp.port_tree(ref_tree))
    assert got == want
    return want[1]


@pytest.mark.parametrize("MT", [1, 2, 5, 9, 16])
@pytest.mark.parametrize("llvl", LOW)
@pytest.mark.parametrize("hlvl", HIGH)
def test_hqr_trees_equal_the_reference(MT, llvl, hlvl):
    """The pivgen grid at one (MT, llvl, hlvl): a, p ∈ {1, 2, 4}, each
    with domino and tsrr off and on. Without them every tree passes
    ``check_tree``, as the reference's pivgen requires."""
    for a, p, domino, tsrr in itertools.product(
            (1, 2, 4), (1, 2, 4), (False, True), (False, True)):
        tree = ref_hqr.hqr_tree(MT, llvl=llvl, hlvl=hlvl, a=a, p=p,
                                domino=domino, tsrr=tsrr)
        verdict = _same_tree(tree)
        if not (domino or tsrr) or llvl == "greedy":
            assert verdict == "ok", (a, p, domino, tsrr, verdict)


@pytest.mark.parametrize("MT", [1, 2, 5, 9, 16])
def test_systolic_and_svd_trees_equal_the_reference(MT):
    for p in (1, 2, 3):
        for q in (1, 2, 3):
            assert _same_tree(ref_hqr.systolic_tree(MT, p, q)) == "ok"
    for p, ratio in ((1, 2), (2, 2), (3, 4)):
        assert _same_tree(ref_hqr.svd_tree(MT, p, ratio)) == "ok"


@pytest.mark.parametrize("corrupt", ["swap", "duplicate", "drop"])
def test_corrupted_schedule_raises_in_both(corrupt):
    """check_tree rejects a schedule whose pivot sits below its victim,
    that kills a row twice, or that leaves a row alive."""
    for mod in (ref_hqr, hqr):
        tree = mod.hqr_tree(9, llvl="binary", hlvl="greedy", a=2, p=2)
        sched = list(tree.schedule(3))
        e = sched[-1]
        if corrupt == "swap":
            sched[-1] = mod.Elim(e.victim, e.piv, e.kind, e.round)
        elif corrupt == "duplicate":
            sched.append(e)
        else:
            sched.pop()
        tree._sched_cache[3] = sched
        with pytest.raises(AssertionError):
            mod.check_tree(tree)


def test_greedy_low_tree_is_coupled_as_in_the_reference():
    """The low greedy tree pairs by cross-column arrival, GREEDY1P per
    column: their schedules differ, identically in both packages."""
    g, g1 = hqr.hqr_tree(13, a=1), hqr.hqr_tree(13, llvl="greedy1p", a=1)
    assert any(g.schedule(k) != g1.schedule(k) for k in range(13))
    for t in (g, g1):
        ref = ref_hqr.hqr_tree(13, llvl=t.llvl, a=1)
        assert [[dataclasses.astuple(e) for e in t.schedule(k)]
                for k in range(13)] == [
            [dataclasses.astuple(e) for e in ref.schedule(k)]
            for k in range(13)]


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("shape", sorted(hp.SHAPES))
@pytest.mark.parametrize("prec", ["s", "d"])
def test_geqrf_gelqf_param_and_q_match_the_reference(prec, shape):
    hp.check_factors(prec, shape)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("shape", sorted(hp.SHAPES))
@pytest.mark.parametrize("prec", ["s", "d"])
def test_unmqr_unmlq_param_match_the_reference(prec, shape, side):
    hp.check_applies(prec, shape, side)


def test_hqr_ops_under_dd_match_the_reference():
    """d under MCA dd_gemm=always: every product of the factorizations
    and of Q's formation is one K2 route (the counts ops/hqr.py
    derives), none left unfused; the results within 1e-12 of the
    reference's."""
    ref = hp.reference("d", "square")
    A = hp.port_tile(ref["A"])
    tq, tl = hp.trees_of(A)
    routed, unfused = pdd.ROUTED, pdd.UNFUSED
    with cfg.override_scope({"dd_gemm": "always"}):
        F = hqr.geqrf_param(tq, A)
        G = hqr.gelqf_param(tl, A)
        Q = hqr.ungqr_param(tq, *F)
        Ql = hqr.unglq_param(tl, *G)
    KT = A.desc.KT
    per_f = sum((len(tq.leaders(k)) + len(tq.schedule(k)))
                * (4 if k < KT - 1 else 1) for k in range(KT))
    per_q = 3 * sum(len(tq.leaders(k)) + len(tq.schedule(k))
                    for k in range(KT))
    assert pdd.ROUTED - routed == 2 * (per_f + per_q)
    assert pdd.UNFUSED == unfused
    for want, got in zip(ref["qr"] + ref["lq"] + [ref["Q"], ref["Ql"]],
                         F + G + (Q, Ql)):
        hp.close(want, got.data, "d")


def test_geqrf_param_writes_one_buffer_and_leaves_a_alone():
    """The input is not written; the three outputs are new row-major
    buffers of A's padded shape."""
    A = hp.port_tile(hp.reference("s", "odd")["A"])
    before = A.data.clone()
    out = hqr.geqrf_param(hp.trees_of(A)[0], A)
    assert torch.equal(A.data, before)
    for x in out:
        assert x.data.shape == A.data.shape and x.data.is_contiguous()
        assert x.data.data_ptr() != A.data.data_ptr()
