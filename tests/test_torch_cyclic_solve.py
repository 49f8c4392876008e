"""Port parity: the U-storage distributed Cholesky, the triangular
solves, POTRS, the slab row gather and GETRS of ``dplasma_tpu_torch.
parallel.cyclic`` against the JAX package's ``parallel.cyclic`` on the
conftest's 8 virtual CPU devices (the dists of tests/test_cyclic.py:
280-633 and a 3×1 grid).

Tolerances, max|port - reference| / max|reference|: 1e-12 in float64,
1e-11 in complex128 for every factor and solve (the two packages sum
the same products in another order); the solves also pass the
reference's residual check, max|A X - B| / (max|A| max|X| N) < 60 u.
"""
import numpy as np
import pytest

from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu_torch.parallel import cyclic
from torch_cyclic_pairs import (DISTS, GRID_2x2, GRID_2x4_K2, grids, port,
                                rand, ref_cyclic_of, rel, slabs)
from torch_threads import one_torch_thread  # noqa: F401

TOL = {"d": 1e-12, "z": 1e-11}
MB, MT, NRHS = 8, 5, 12
N = MB * MT


def _spd(rng, cplx):
    a = rand(rng, (N, N), cplx)
    return a @ a.conj().T + N * np.eye(N)


def _tri(rng, cplx):
    """A well-conditioned general matrix; each solve reads one triangle."""
    return rand(rng, (N, N), cplx) + 2 * N * np.eye(N)


def _residual_ok(a, x, b):
    eps = np.finfo(np.float64).eps
    r = np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * N)
    return r / eps < 60


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_potrf_cyclic_upper_matches_reference(devices8, dist, dt):
    """A = U^H U on U-stored slabs: the mirrored sweep (row panel along
    'p', diagonal along 'q', column formation along 'q') gives the
    reference's slabs, and U^H U is A."""
    rng = np.random.default_rng(14)
    spd = _spd(rng, dt == "z")
    with grids(dist):
        C = ref_cyclic_of(np.triu(spd), MB, dist)
        want = np.asarray(ref_cyclic.potrf_cyclic(C, "U").data)
        got = cyclic.potrf_cyclic(port(C), "U")
        U = np.triu(got.to_tile().data.numpy()[:N, :N])
    assert rel(slabs(got), want) <= TOL[dt]
    assert rel(U.conj().T @ U, spd) <= 1e-13


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_potrs_cyclic_matches_reference(devices8, dist, uplo, dt):
    """POTRS from either storage's factor: two slab TRSMs, the
    reference's X, and a passing residual."""
    rng = np.random.default_rng(7)
    spd = _spd(rng, dt == "z")
    b = rand(rng, (N, NRHS), dt == "z")
    stored = np.tril(spd) if uplo == "L" else np.triu(spd)
    with grids(dist):
        C = ref_cyclic_of(stored, MB, dist)
        Bc = ref_cyclic_of(b, MB, dist)
        F = ref_cyclic.potrf_cyclic(C, uplo)
        want = np.asarray(ref_cyclic.potrs_cyclic(F, Bc, uplo).data)
        got = cyclic.potrs_cyclic(port(F), port(Bc), uplo)
        x = got.to_tile().data.numpy()[:N, :NRHS]
    assert rel(slabs(got), want) <= TOL[dt]
    assert _residual_ok(spd, x, b)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_trsm_cyclic_corners_match_reference(devices8, uplo, trans, unit):
    """Every (uplo, trans) corner with and without a unit diagonal on the
    2×4 supertiled grid: op(T) X = B."""
    dist = GRID_2x4_K2
    rng = np.random.default_rng(15)
    t = _tri(rng, False)
    b = rand(rng, (N, NRHS))
    with grids(dist):
        Tc, Bc = ref_cyclic_of(t, MB, dist), ref_cyclic_of(b, MB, dist)
        want = np.asarray(ref_cyclic.trsm_cyclic(Tc, Bc, trans, unit,
                                                 uplo).data)
        got = cyclic.trsm_cyclic(port(Tc), port(Bc), trans, unit, uplo)
        x = got.to_tile().data.numpy()[:N, :NRHS]
    assert rel(slabs(got), want) <= TOL["d"]
    tm = np.tril(t) if uplo == "L" else np.triu(t)
    if unit:
        np.fill_diagonal(tm, 1.0)
    op = tm if trans == "N" else tm.T
    assert _residual_ok(op, x, b)


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["T", "C"])
def test_trsm_cyclic_complex_T_and_C_stay_distinct(devices8, trans, uplo):
    """In complex, the partial sums' coupling blocks follow the solve's
    op: plain transpose for T, conjugate for C."""
    rng = np.random.default_rng(16)
    t = _tri(rng, True)
    b = rand(rng, (N, NRHS), True)
    with grids(GRID_2x2):
        Tc, Bc = (ref_cyclic_of(t, MB, GRID_2x2),
                  ref_cyclic_of(b, MB, GRID_2x2))
        want = np.asarray(ref_cyclic.trsm_cyclic(Tc, Bc, trans,
                                                 uplo=uplo).data)
        got = cyclic.trsm_cyclic(port(Tc), port(Bc), trans, uplo=uplo)
        x = got.to_tile().data.numpy()[:N, :NRHS]
    assert rel(slabs(got), want) <= TOL["z"]
    tm = np.tril(t) if uplo == "L" else np.triu(t)
    assert _residual_ok(tm.T if trans == "T" else tm.conj().T, x, b)


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_trsm_cyclic_grids_match_reference(devices8, dist, dt):
    """The forward and backward lower solves on every grid."""
    rng = np.random.default_rng(3)
    t = _tri(rng, dt == "z")
    b = rand(rng, (N, NRHS), dt == "z")
    with grids(dist):
        Tc, Bc = ref_cyclic_of(t, MB, dist), ref_cyclic_of(b, MB, dist)
        for trans in ("N", "C"):
            want = np.asarray(ref_cyclic.trsm_cyclic(Tc, Bc, trans).data)
            got = cyclic.trsm_cyclic(port(Tc), port(Bc), trans)
            assert rel(slabs(got), want) <= TOL[dt]


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_laswp_getrs_cyclic_match_reference(devices8, dist, dt):
    """GETRS from getrf_cyclic's in-place factor: the slab row gather by
    perm (of the factor and of B) and the unit-lower and upper sweeps;
    the gather alone is a bitwise row move."""
    rng = np.random.default_rng(4)
    a = rand(rng, (N, N), dt == "z")
    b = rand(rng, (N, NRHS), dt == "z")
    with grids(dist):
        Ac, Bc = ref_cyclic_of(a, MB, dist), ref_cyclic_of(b, MB, dist)
        F, perm = ref_cyclic.getrf_cyclic(Ac)
        want_swp = np.asarray(ref_cyclic.laswp_cyclic(Bc, perm).data)
        want = np.asarray(ref_cyclic.getrs_cyclic(F, perm, Bc).data)
        perm = np.asarray(perm)
        got_swp = cyclic.laswp_cyclic(port(Bc), perm)
        got = cyclic.getrs_cyclic(port(F), perm, port(Bc))
        x = got.to_tile().data.numpy()[:N, :NRHS]
    np.testing.assert_array_equal(slabs(got_swp), want_swp)
    assert rel(slabs(got), want) <= TOL[dt]
    assert _residual_ok(a, x, b)


def test_solve_guards_raise_value_errors(devices8):
    """The reference's asserts are ValueErrors in the port."""
    rng = np.random.default_rng(1)
    with grids(GRID_2x2):
        A = port(ref_cyclic_of(_tri(rng, False), MB, GRID_2x2))
        B = port(ref_cyclic_of(rand(rng, (N - MB, 4)), MB, GRID_2x2))
        with pytest.raises(ValueError, match="mismatched"):
            cyclic.trsm_cyclic(A, B)
        with pytest.raises(ValueError, match="trans"):
            cyclic.trsm_cyclic(A, A, "X")
        with pytest.raises(ValueError, match="uplo"):
            cyclic.potrs_cyclic(A, A, "X")
