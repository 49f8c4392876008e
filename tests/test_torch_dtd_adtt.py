"""Port parity: the insert-task front end (``dtd.py``), the LAPACK-layout
Cholesky (``adtt.py``), the map framework (``ops/map.py``) and INFO
(``ops/info.py``) against the reference's.

Held: ``TaskPool`` edges and task names equal to the reference's for the
same insertions (potrf_dtd's in L and U, and a sequence with OUT and
repeated writes); ``record_dag`` into the reference's ``DagRecorder``
giving the same nodes and edges; ``potrf_dtd`` in L and U on a ragged
matrix (N = 45, nb = 8) within 1e-5 (s/c) / 1e-12 (d/z) of the
reference's; the port's in-place replay ``torch.equal`` to a functional
replay (a new matrix per written tile, as the reference replays) on the
CPU; ``potrf_lapack`` on a Fortran-ordered buffer within the same
tolerances, with INFO equal to the reference's (0, and the failing
panel's row on a matrix that is not SPD) and the strict upper triangle
untouched; ``map_tiles`` / ``map2_tiles`` bitwise, with the tile-geometry
assertion; ``factor_info`` equal; the six ``testing_*_dtd`` drivers
passing -x on the CPU, one of them through ``python -m
dplasma_tpu_torch.drivers``.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu import adtt as ref_adtt
from dplasma_tpu import dtd as ref_dtd
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import info as ref_info
from dplasma_tpu.ops import map as ref_map
from dplasma_tpu.utils.profiling import DagRecorder
from dplasma_tpu_torch import adtt, dtd
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import info, map as pmap, potrf
from torch_threads import one_torch_thread  # noqa: F401

DT = {"s": (jnp.float32, 1e-5), "d": (jnp.float64, 1e-12),
      "c": (jnp.complex64, 1e-5), "z": (jnp.complex128, 1e-12)}
N, NB = 45, 8


def _tile(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _rel(got, want):
    want = np.asarray(want)
    got = got.resolve_conj().numpy() if torch.is_tensor(got) else got
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


def _he(prec, seed=3872, n=N):
    return ref_gen.plghe(float(n), n, NB, seed=seed, dtype=DT[prec][0])


# -- TaskPool ------------------------------------------------------------

@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_dtd_edges_equal_reference(uplo):
    A = _he("d")
    rp = ref_dtd.potrf_dtd(A, uplo, pool=ref_dtd.TaskPool(A.pad_diag()))
    pp = dtd.potrf_dtd(_tile(A), uplo,
                       pool=dtd.TaskPool(_tile(A).pad_diag()))
    assert pp.edges == rp.edges
    assert [t.name for t in pp.tasks] == [t.name for t in rp.tasks]
    assert [t.refs for t in pp.tasks] == [
        tuple(dtd.TileRef(r.mat, r.i, r.j, r.mode) for r in t.refs)
        for t in rp.tasks]
    nt = A.desc.KT
    assert len(pp.tasks) == nt + nt * (nt - 1) + nt * (nt - 1) * (
        nt - 2) // 6


def _insertions(mod, mats):
    """Insertions with IN, OUT (an output dependence), INOUT, two
    matrices and the same class twice on one tile."""
    tp = mod.TaskPool(*mats)

    def f1(a):
        return a

    def f2(a, b):
        return a + b

    def f3(a, b):
        return a, b

    def f0(a):
        return ()

    tp.insert_task(f1, tp.tile(0, 0, 0, mod.OUT), name="w")
    tp.insert_task(f1, tp.tile(0, 0, 0, mod.OUT), name="w")
    tp.insert_task(f2, tp.tile(0, 0, 0, mod.IN),
                   tp.tile(1, 1, 0, mod.INOUT), name="acc")
    tp.insert_task(f2, tp.tile(0, 0, 0, mod.IN),
                   tp.tile(1, 1, 0, mod.INOUT), name="acc")
    tp.insert_task(f3, tp.tile(1, 1, 0, mod.INOUT),
                   tp.tile(0, 1, 1, mod.INOUT), name="swap")
    tp.insert_task(f0, tp.tile(0, 1, 1, mod.IN), name="read")
    return tp


def test_taskpool_edges_and_dag_equal_reference():
    ra = ref_gen.plrnt(16, 16, 8, 8, seed=1, dtype=jnp.float64)
    rb = ref_gen.plrnt(16, 8, 8, 8, seed=2, dtype=jnp.float64)
    rp = _insertions(ref_dtd, [ra, rb])
    pp = _insertions(dtd, [_tile(ra), _tile(rb)])
    assert pp.edges == rp.edges
    rec_r, rec_p = DagRecorder(enabled=True), DagRecorder(enabled=True)
    rp.record_dag(rec_r)
    pp.record_dag(rec_p)
    assert [(t.cls, t.index) for t in rec_p.tasks] == \
        [(t.cls, t.index) for t in rec_r.tasks]
    assert rec_p.edges == rec_r.edges
    # potrf_dtd's DAG too
    A = _he("d")
    rec_r, rec_p = DagRecorder(enabled=True), DagRecorder(enabled=True)
    ref_dtd.potrf_dtd(A, "L", pool=ref_dtd.TaskPool(A.pad_diag())
                      ).record_dag(rec_r)
    dtd.potrf_dtd(_tile(A), "L", pool=dtd.TaskPool(_tile(A).pad_diag())
                  ).record_dag(rec_p)
    assert len(rec_p.tasks) == len(rec_r.tasks) and \
        rec_p.edges == rec_r.edges
    with pytest.raises(ValueError):
        dtd.TileRef(0, 0, 0, "RW")
    with pytest.raises(IndexError):
        pp.tile(1, 0, 1)
    with pytest.raises(NotImplementedError, match="item 15"):
        pp.schedule()


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("prec", list(DT))
def test_potrf_dtd_matches_reference(prec, uplo):
    A = _he(prec)
    want = ref_dtd.potrf_dtd(A, uplo)
    A0 = _tile(A)
    before = A0.data.clone()
    got = dtd.potrf_dtd(A0, uplo)
    assert torch.equal(A0.data, before)        # the operand is not written
    assert got.dtype == A0.dtype
    assert _rel(got.data, want.data) <= DT[prec][1]
    # the stored triangle is the port's left-looking potrf's (the
    # other one keeps the input's off-diagonal tiles, as the
    # reference's does)
    tri = torch.tril if uplo == "L" else torch.triu
    assert _rel(tri(got.to_dense()),
                potrf.potrf(A0, uplo).to_dense().numpy()) <= DT[prec][1]


def _functional_replay(tp):
    """The reference's replay (dtd.py:104-116) on port matrices: every
    written tile makes a new matrix (``set_tile`` copies)."""
    mats = [TileMatrix(m.data, m.desc) for m in tp.mats]
    for t in tp.tasks:
        ins = [mats[r.mat].tile(r.i, r.j) for r in t.refs]
        outs = t.fn(*ins, **t.kwargs)
        wrefs = [r for r in t.refs if r.mode in (dtd.OUT, dtd.INOUT)]
        if len(wrefs) == 1:
            outs = (outs,)
        for r, val in zip(wrefs, outs):
            mats[r.mat] = mats[r.mat].set_tile(r.i, r.j, val)
    return mats


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_in_place_replay_equals_functional_replay(uplo):
    A = _tile(_he("s", n=40))
    tp = dtd.potrf_dtd(A, uplo, pool=dtd.TaskPool(A.pad_diag()))
    (got,) = tp.wait()
    (want,) = _functional_replay(tp)
    assert torch.equal(got.data, want.data)
    # a task whose outputs are views of its inputs (a tile swap) reads
    # both before writing either
    ra = ref_gen.plrnt(16, 16, 8, 8, seed=1, dtype=jnp.float64)
    rb = ref_gen.plrnt(16, 8, 8, 8, seed=2, dtype=jnp.float64)
    tp = _insertions(dtd, [_tile(ra), _tile(rb)])
    got = tp.wait(jit=False)
    want = _functional_replay(tp)
    assert all(torch.equal(g.data, w.data) for g, w in zip(got, want))
    rgot = _insertions(ref_dtd, [ra, rb]).wait()
    assert all(np.array_equal(g.data.numpy(), np.asarray(r.data))
               for g, r in zip(got, rgot))


# -- potrf_lapack ----------------------------------------------------------

@pytest.mark.parametrize("n,nb", [(96, 32), (100, 32), (64, 64)])
@pytest.mark.parametrize("prec", ["s", "d"])
def test_potrf_lapack_matches_reference(prec, n, nb):
    dt = np.dtype(DT[prec][0])
    g = np.random.default_rng(5).standard_normal((n, n))
    spd = (g @ g.T + n * np.eye(n)).astype(dt)
    a_ref, a = np.asfortranarray(spd), np.asfortranarray(spd)
    info_r = ref_adtt.potrf_lapack(ref_adtt.LapackView(a_ref), nb)
    info_p = adtt.potrf_lapack(adtt.LapackView(a), nb, device="cpu")
    assert info_p == info_r == 0
    assert _rel(np.tril(a), np.tril(a_ref)) <= DT[prec][1]
    assert np.array_equal(np.triu(a, 1), np.triu(spd, 1))
    assert a.flags.f_contiguous


@pytest.mark.parametrize("prec", ["s", "d"])
def test_potrf_lapack_info_non_spd(prec):
    n, nb = 64, 16
    dt = np.dtype(DT[prec][0])
    g = np.random.default_rng(6).standard_normal((n, n))
    spd = g @ g.T + n * np.eye(n)
    spd[40, 40] = -1e6       # break SPD inside the third panel
    spd = spd.astype(dt)
    a_ref, a = np.asfortranarray(spd), np.asfortranarray(spd)
    info_r = ref_adtt.potrf_lapack(ref_adtt.LapackView(a_ref), nb)
    info_p = adtt.potrf_lapack(adtt.LapackView(a), nb, device="cpu")
    assert info_p == info_r and 33 <= info_p <= 48
    # the panels after the failing one are left as they were
    assert np.array_equal(a[:, 48:], spd[:, 48:])
    with pytest.raises(ValueError):
        adtt.potrf_lapack(adtt.LapackView(np.zeros((4, 5))), 2,
                          device="cpu")


# -- map / info ------------------------------------------------------------

@pytest.mark.parametrize("prec", list(DT))
def test_map_tiles_bitwise(prec):
    A = ref_gen.plrnt(37, 29, 8, 5, seed=9, dtype=DT[prec][0])
    B = ref_gen.plrnt(37, 29, 8, 5, seed=10, dtype=DT[prec][0])

    def op(i, j, t):
        return t * 2.0 + (i - 2 * j)

    def op2(i, j, a, b):
        return a - b * (i + 1) + j

    want = ref_map.map_tiles(A, op)
    got = pmap.map_tiles(_tile(A), op)
    assert got.dtype == _tile(A).dtype
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    want = ref_map.map2_tiles(A, B, op2)
    got = pmap.map2_tiles(_tile(A), _tile(B), op2)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    t = pmap.to_tiles(_tile(A).data, _tile(A).desc)
    assert np.array_equal(t.numpy(), np.asarray(ref_map.to_tiles(A.data,
                                                                 A.desc)))
    assert torch.equal(pmap.from_tiles(t, _tile(A).desc), _tile(A).data)
    want = ref_map.elementwise(A, lambda x: x * 3 + 1)
    got = pmap.elementwise(_tile(A), lambda x: x * 3 + 1)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


def test_map2_tiles_needs_one_geometry():
    A = _tile(ref_gen.plrnt(16, 16, 8, 8, seed=1, dtype=jnp.float32))
    B = _tile(ref_gen.plrnt(8, 8, 4, 4, seed=1, dtype=jnp.float32))
    with pytest.raises(AssertionError, match="matching tile shapes"):
        pmap.map2_tiles(A, B, lambda i, j, a, b: a + b)
    # batched leading axes pass through to_tiles / from_tiles
    x = torch.stack([A.data, 2 * A.data])
    t = pmap.to_tiles(x, A.desc)
    assert t.shape == (2, 2, 2, 8, 8)
    assert torch.equal(pmap.from_tiles(t, A.desc), x)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_factor_info_matches_reference(uplo):
    A = _he("d")
    F = potrf.potrf(_tile(A), uplo)
    assert int(info.factor_info(F, uplo)) == 0
    assert info.factor_info(F, uplo).dtype == torch.int32
    data = F.data.clone()
    data[17, 5] = float("nan")
    data[5, 17] = float("inf")
    data[30, 30] = float("nan")
    bad = F.like(data)
    rbad = dataclasses.replace(A, data=jnp.asarray(data.numpy()))
    want = int(ref_info.factor_info(rbad, uplo))
    assert int(info.factor_info(bad, uplo)) == want == \
        (18 if uplo == "L" else 6)


# -- the six DTD drivers ---------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["testing_spotrf_dtd", "-N", "70", "-t", "16"],
    ["testing_zpotrf_dtd_untied", "-N", "45", "-t", "8"],
    ["testing_cgemm_dtd", "-M", "37", "-N", "29", "-K", "21", "-t", "8"],
    ["testing_dgeqrf_dtd", "-N", "40", "-t", "16"],
    ["testing_sgeqrf_dtd_untied", "-M", "50", "-N", "40", "-t", "16"],
    ["testing_dgetrf_incpiv_dtd", "-N", "60", "-t", "16"]],
    ids=lambda a: a[0])
def test_dtd_drivers_pass_x_on_the_cpu(argv):
    from dplasma_tpu_torch.drivers import common, main
    assert main(argv + ["-x", "--device", "cpu"]) == 0
    run = common.RUNS[-1]
    assert run["checks"] and all(c["ok"] for c in run["checks"])


def test_dtd_driver_through_the_module_cli():
    out = subprocess.run(
        [sys.executable, "-m", "dplasma_tpu_torch.drivers",
         "testing_dpotrf_dtd", "-N", "40", "-t", "16", "-x", "--device",
         "cpu"], capture_output=True, text=True, timeout=300,
        cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert "[SUCCESS] POTRF(dtd)" in out.stdout
