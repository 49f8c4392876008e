"""Port parity: SUMMA over slabs (``gemm_cyclic``), ``gemm_ex`` /
``gemm_summa`` under an active grid, the cyclic Level-3 BLAS (herk,
trmm, hemm, her2k) and the cyclic inverses (lauum, trtri, potri) of
``dplasma_tpu_torch`` against the JAX package on the conftest's 8
virtual CPU devices (the dists of tests/test_cyclic.py:280-633 and a
3×1 or 1×3 grid).

Tolerances, max|port - reference| / max|reference|: 1e-12 in float64,
1e-11 in complex128 (the two packages sum the same products in another
order); each op is also held to its dense numpy result.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.ops import gemm as ref_gemm
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import gemm
from dplasma_tpu_torch.parallel import cyclic
from torch_cyclic_pairs import (DISTS, GRID_1x3, GRID_2x2, GRID_2x4_K2,
                                grids, port, rand, ref_cyclic_of, rel,
                                slabs)
from torch_threads import one_torch_thread  # noqa: F401

TOL = {"d": 1e-12, "z": 1e-11}
MB, MT = 8, 4
N = MB * MT


def _dense(C, m, n):
    return C.to_tile().data.numpy()[:m, :n]


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_gemm_cyclic_matches_reference(devices8, dist, dt):
    """C = A B over slabs with a ragged contraction and C width."""
    rng = np.random.default_rng(9)
    a = rand(rng, (N, 3 * MB - 2), dt == "z")
    b = rand(rng, (3 * MB - 2, 2 * MB + 3), dt == "z")
    with grids(dist):
        Ac, Bc = ref_cyclic_of(a, MB, dist), ref_cyclic_of(b, MB, dist)
        want = ref_cyclic.gemm_cyclic(Ac, Bc)
        got = cyclic.gemm_cyclic(port(Ac), port(Bc))
    assert dataclasses.asdict(got.desc) == dataclasses.asdict(want.desc)
    assert rel(slabs(got), np.asarray(want.data)) <= TOL[dt]
    assert rel(_dense(got, *(a @ b).shape), a @ b) <= TOL[dt]


@pytest.mark.parametrize("dist,dt,trans", [
    (GRID_2x2, "s", ("N", "N")), (GRID_2x2, "z", ("N", "C")),
    (GRID_2x2, "z", ("C", "T")), (GRID_1x3, "d", ("T", "N")),
    (GRID_2x4_K2, "d", ("N", "N"))], ids=str)
def test_gemm_ex_under_a_grid_runs_summa(devices8, dist, dt, trans):
    """``gemm_ex`` under an active grid plans ``summa`` and gives the
    reference's ``gemm_summa`` on a ragged problem (C 37×29, K = 21,
    edge-padded to the mesh quantum)."""
    ta, tb = trans
    jdt = {"s": jnp.float32, "d": jnp.float64, "z": jnp.complex128}[dt]
    rng = np.random.default_rng(2)
    M, Nc, K = 37, 29, 21
    a = rand(rng, (M, K) if ta == "N" else (K, M), dt == "z")
    b = rand(rng, (K, Nc) if tb == "N" else (Nc, K), dt == "z")
    c = rand(rng, (M, Nc), dt == "z")
    A, B, C = (RTile.from_dense(jnp.asarray(x, jdt), 8, 8)
               for x in (a, b, c))
    At, Bt, Ct = (TileMatrix.from_reference(
        np.asarray(X.data), dataclasses.asdict(X.desc), device="cpu")
        for X in (A, B, C))
    with grids(dist):
        assert gemm.plan_gemm(Ct, At, Bt, ta, tb).algo == "summa"
        want = ref_gemm.gemm_summa(1.5, A, B, 0.5, C, ta, tb)
        got = gemm.gemm_ex(1.5, At, Bt, 0.5, Ct, ta, tb)
    tol = 1e-5 if dt == "s" else TOL[dt]
    assert got.desc == Ct.desc
    assert rel(got.data.numpy(), want.data) <= tol


@pytest.mark.parametrize("steps", [1, 3])
def test_gemm_summa_steps_knob_matches_reference(devices8, steps):
    """MCA ``gemm.summa_steps`` sets the panels per owner block in both
    packages: the same padded quantum, the same result."""
    rng = np.random.default_rng(5)
    a, b, c = (rand(rng, s) for s in ((33, 27), (27, 19), (33, 19)))
    A, B, C = (RTile.from_dense(jnp.asarray(x), 8, 8) for x in (a, b, c))
    At, Bt, Ct = (TileMatrix.from_reference(
        np.asarray(X.data), dataclasses.asdict(X.desc), device="cpu")
        for X in (A, B, C))
    with grids(GRID_2x2, {"gemm.summa_steps": steps}):
        want = ref_gemm.gemm_summa(1.0, A, B, -1.0, C)
        got = gemm.gemm_summa(1.0, At, Bt, -1.0, Ct)
    assert rel(got.data.numpy(), want.data) <= TOL["d"]


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("K", [N, 2 * MB])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_herk_cyclic_matches_reference(devices8, dist, K, dt):
    """C = A A^H (lower stored), A square or rectangular: C follows the
    M×M descriptor."""
    rng = np.random.default_rng(11)
    a = rand(rng, (N, K), dt == "z")
    with grids(dist):
        Ac = ref_cyclic_of(a, MB, dist)
        want = ref_cyclic.herk_cyclic(Ac)
        got = cyclic.herk_cyclic(port(Ac))
    assert got.desc.M == got.desc.N == N
    assert rel(slabs(got), np.asarray(want.data)) <= TOL[dt]
    assert rel(_dense(got, N, N), np.tril(a @ a.conj().T)) <= TOL[dt]


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_trmm_cyclic_corners_match_reference(devices8, uplo, trans, unit):
    """B <- op(T) B, every (uplo, trans) corner, unit or not (T aliases C
    for real data)."""
    dist = GRID_2x4_K2
    rng = np.random.default_rng(6)
    t = rand(rng, (N, N))
    b = rand(rng, (N, 20))
    with grids(dist):
        Tc, Bc = ref_cyclic_of(t, MB, dist), ref_cyclic_of(b, MB, dist)
        want = ref_cyclic.trmm_cyclic(Tc, Bc, trans, unit, uplo)
        got = cyclic.trmm_cyclic(port(Tc), port(Bc), trans, unit, uplo)
    assert rel(slabs(got), np.asarray(want.data)) <= TOL["d"]
    tm = np.tril(t) if uplo == "L" else np.triu(t)
    if unit:
        np.fill_diagonal(tm, 1.0)
    op = tm if trans == "N" else tm.T
    assert rel(_dense(got, N, 20), op @ b) <= TOL["d"]


@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_trmm_cyclic_complex_matches_reference(devices8, dist):
    """Complex N and C on every grid; complex T is refused, as the
    reference asserts."""
    rng = np.random.default_rng(6)
    t = rand(rng, (N, N), True)
    b = rand(rng, (N, 12), True)
    with grids(dist):
        Tc, Bc = ref_cyclic_of(t, MB, dist), ref_cyclic_of(b, MB, dist)
        for trans in ("N", "C"):
            want = ref_cyclic.trmm_cyclic(Tc, Bc, trans, uplo="U")
            got = cyclic.trmm_cyclic(port(Tc), port(Bc), trans, uplo="U")
            assert rel(slabs(got), np.asarray(want.data)) <= TOL["z"]
        with pytest.raises(ValueError, match="plain-transpose"):
            cyclic.trmm_cyclic(port(Tc), port(Bc), "T")


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_hemm_cyclic_matches_reference(devices8, dist, dt):
    """C = A B with A Hermitian stored lower: the upper triangle holds
    scratch that must not leak."""
    rng = np.random.default_rng(8)
    a0 = rand(rng, (N, N), dt == "z")
    h = a0 + a0.conj().T
    stored = np.tril(h) + np.triu(rand(rng, (N, N), dt == "z"), 1)
    b = rand(rng, (N, 16), dt == "z")
    with grids(dist):
        Hc, Bc = ref_cyclic_of(stored, MB, dist), ref_cyclic_of(b, MB, dist)
        want = ref_cyclic.hemm_cyclic(Hc, Bc)
        got = cyclic.hemm_cyclic(port(Hc), port(Bc))
    assert rel(slabs(got), np.asarray(want.data)) <= TOL[dt]
    assert rel(_dense(got, N, 16), h @ b) <= TOL[dt]


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_her2k_cyclic_matches_reference(devices8, dist, dt):
    """C = A B^H + B A^H (lower stored) on rectangular A, B."""
    rng = np.random.default_rng(10)
    a = rand(rng, (N, 2 * MB), dt == "z")
    b = rand(rng, (N, 2 * MB), dt == "z")
    with grids(dist):
        Ac, Bc = ref_cyclic_of(a, MB, dist), ref_cyclic_of(b, MB, dist)
        want = ref_cyclic.her2k_cyclic(Ac, Bc)
        got = cyclic.her2k_cyclic(port(Ac), port(Bc))
    assert rel(slabs(got), np.asarray(want.data)) <= TOL[dt]
    ref = a @ b.conj().T + b @ a.conj().T
    assert rel(_dense(got, N, N), np.tril(ref)) <= TOL[dt]


def _chol(rng, cplx):
    a0 = rand(rng, (N, N), cplx)
    spd = a0 @ a0.conj().T + N * np.eye(N)
    return spd, np.linalg.cholesky(spd)


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_lauum_trtri_potri_cyclic_match_reference(devices8, dist, dt):
    """The inverses chain: trtri (L and U), lauum and the composed potri
    on the slabs, each the reference's, and potri is A^-1's lower
    triangle."""
    rng = np.random.default_rng(12)
    spd, lf = _chol(rng, dt == "z")
    with grids(dist):
        Lc = ref_cyclic_of(lf, MB, dist)
        Uc = ref_cyclic_of(lf.conj().T, MB, dist)
        for op, args, pargs in (
                ("lauum_cyclic", (Lc,), (port(Lc),)),
                ("potri_cyclic", (Lc,), (port(Lc),))):
            want = getattr(ref_cyclic, op)(*args)
            got = getattr(cyclic, op)(*pargs)
            assert rel(slabs(got), np.asarray(want.data)) <= TOL[dt], op
        for uplo, X in (("L", Lc), ("U", Uc)):
            for unit in (False, True):
                want = ref_cyclic.trtri_cyclic(X, unit, uplo)
                got = cyclic.trtri_cyclic(port(X), unit, uplo)
                assert rel(slabs(got), np.asarray(want.data)) <= TOL[dt]
        pot = _dense(cyclic.potri_cyclic(port(Lc)), N, N)
    assert rel(pot, np.tril(np.linalg.inv(spd))) <= 1e-12


def test_blas3_guards_raise_value_errors(devices8):
    """The reference's asserts are ValueErrors in the port."""
    rng = np.random.default_rng(1)
    with grids(GRID_2x2):
        A = port(ref_cyclic_of(rand(rng, (N, N)), MB, GRID_2x2))
        B = port(ref_cyclic_of(rand(rng, (N + MB, 8)), MB, GRID_2x2))
        for op in (cyclic.gemm_cyclic, cyclic.hemm_cyclic,
                   cyclic.her2k_cyclic, cyclic.trmm_cyclic):
            with pytest.raises(ValueError, match="mismatched"):
                op(A, B)
