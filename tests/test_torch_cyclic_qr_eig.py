"""Port parity: the distributed QR (``geqrf_cyclic`` with its T stack and
``qr_t_factor``) and the eigen / SVD stage 1 on the slabs (``herbt_cyclic``
with the band extraction, ``heev_cyclic``, ``gebrd_ge2gb_cyclic``,
``gesvd_cyclic``) of ``dplasma_tpu_torch`` against the JAX package on the
conftest's 8 virtual CPU devices (the dists of tests/test_cyclic.py:
280-633 and a 3×1 grid).

Tolerances, max|port - reference| / max|reference|: 1e-12 in float64,
1e-11 in complex128 for the factor, the T stack and the bands (the two
packages sum the same products in another order); eigenvalues within
1e-12·N, singular values within 1e-8 (the reference test's gate; both
packages' stage 2 then runs on bands that differ in the last bits).
"""
import dataclasses

import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu.parallel import mesh as ref_mesh
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import qr
from dplasma_tpu_torch.parallel import cyclic
from torch_cyclic_pairs import (DISTS, GRID_2x4_K2, grids, port, rand,
                                ref_cyclic_of, rel, slabs)
from torch_threads import one_torch_thread  # noqa: F401

TOL = {"d": 1e-12, "z": 1e-11}
MB = 8


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_geqrf_cyclic_matches_reference(devices8, dist, dt, lookahead):
    """The packed factor and the T stack on a ragged matrix (the pad
    columns identity-seeded), with and without the lookahead carry."""
    N = 5 * MB - 3
    a = rand(np.random.default_rng(5), (N, N), dt == "z")
    with grids(dist, {"sweep.lookahead": lookahead}):
        C = ref_cyclic_of(a, MB, dist)
        F, Ts = ref_cyclic.geqrf_cyclic(C)
        Fp, Tsp = cyclic.geqrf_cyclic(port(C))
    assert tuple(Tsp.shape) == (5, MB, MB)
    assert rel(slabs(Fp), np.asarray(F.data)) <= TOL[dt]
    assert rel(Tsp.numpy(), np.asarray(Ts)) <= TOL[dt]


@pytest.mark.parametrize("dt", ["d", "z"])
def test_geqrf_cyclic_t_factor_feeds_unmqr(devices8, dt):
    """``qr_t_factor`` gives the reference's T TileMatrix, and the port's
    ``ops.qr.unmqr`` applies the gathered factor: Q R = A and Q^H Q = I
    (the reference test's checks)."""
    dist = GRID_2x4_K2
    N = 6 * MB
    a = rand(np.random.default_rng(21), (N, N), dt == "z")
    with grids(dist):
        C = ref_cyclic_of(a, MB, dist)
        F, Ts = ref_cyclic.geqrf_cyclic(C)
        A0 = RTile.from_dense(np.asarray(a), MB, MB)
        want_T = ref_cyclic.qr_t_factor(Ts, A0)
        Fp, Tsp = cyclic.geqrf_cyclic(port(C))
        packed = Fp.to_tile()
    At = TileMatrix.from_dense(torch.from_numpy(a), MB, MB)
    Tf = cyclic.qr_t_factor(Tsp, At)
    assert Tf.desc == qr.t_desc(At).desc
    assert rel(Tf.data.numpy(), np.asarray(want_T.data)) <= TOL[dt]
    R = torch.triu(packed.to_dense())
    QR = qr.unmqr("L", "N", packed, Tf,
                  TileMatrix.from_dense(R, MB, MB)).to_dense().numpy()
    eps = np.finfo(np.float64).eps
    assert np.abs(QR - a).max() / (np.abs(a).max() * N * eps) < 100
    eye = torch.eye(N, dtype=R.dtype)
    Qm = qr.unmqr("L", "N", packed, Tf,
                  TileMatrix.from_dense(eye, MB, MB)).to_dense().numpy()
    assert np.abs(Qm.conj().T @ Qm - np.eye(N)).max() / (N * eps) < 100


def _hermitian(rng, n, cplx):
    a = rand(rng, (n, n), cplx)
    return a + a.conj().T + n * np.eye(n)


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_herbt_band_and_heev_cyclic_match_reference(devices8, dist, dt):
    """herbt on the slabs leaves the reference's band (zero beyond mb),
    the band extraction moves the reference's per-row diagonals, and
    heev_cyclic's eigenvalues are the reference's (and numpy's)."""
    N = 4 * MB
    h = _hermitian(np.random.default_rng(17), N, dt == "z")
    with grids(dist):
        C = ref_cyclic_of(h, MB, dist)
        B = ref_cyclic.herbt_cyclic(C)
        band = ref_cyclic._band_extract_cyclic_jit(B.data, B.desc,
                                                   ref_mesh.active())
        w = np.asarray(ref_cyclic.heev_cyclic(C))
        Bp = cyclic.herbt_cyclic(port(C))
        bandp = cyclic._band_extract_cyclic(Bp)
        wp = cyclic.heev_cyclic(port(C)).numpy()
        dense = Bp.to_tile().data.numpy()[:N, :N]
    assert rel(slabs(Bp), np.asarray(B.data)) <= TOL[dt]
    assert rel(bandp.numpy(), np.asarray(band)) <= TOL[dt]
    for off in range(MB + 1, N):
        assert np.abs(np.diagonal(dense, -off)).max() <= 1e-12 * N
    assert rel(wp, w) <= 1e-12 * N
    assert rel(wp, np.linalg.eigvalsh(h)) <= 1e-12 * N


@pytest.mark.parametrize("dt", ["d", "z"])
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_ge2gb_band_and_gesvd_cyclic_match_reference(devices8, dist, dt):
    """ge2gb on the slabs leaves an upper band-bidiagonal (zero below the
    diagonal and beyond the first superdiagonal tile) with A's singular
    values, and gesvd_cyclic gives them. In float64 the band and the
    values are the reference's. In complex128 they are held to numpy
    alone: the reference's LQ half applies conj(A V T V^H) where A H =
    A - A V T V^H belongs (cyclic.py:1198-1199; its tests run real data
    only), so its complex band has other singular values; the port
    applies A H, the same operations on real data."""
    N = 4 * MB
    a = rand(np.random.default_rng(21), (N, N), dt == "z")
    s_ref = np.linalg.svd(a, compute_uv=False)
    with grids(dist):
        C = ref_cyclic_of(a, MB, dist)
        if dt == "d":
            B = ref_cyclic.gebrd_ge2gb_cyclic(C)
            s = np.asarray(ref_cyclic.gesvd_cyclic(C))
        Bp = cyclic.gebrd_ge2gb_cyclic(port(C))
        sp = cyclic.gesvd_cyclic(port(C)).numpy()
        dense = Bp.to_tile().data.numpy()[:N, :N]
    if dt == "d":
        assert rel(slabs(Bp), np.asarray(B.data)) <= TOL[dt]
        assert rel(sp, s) <= 1e-8
    for off in range(1, N):
        assert np.abs(np.diagonal(dense, -off)).max() <= 1e-12 * N
    for off in range(2 * MB, N):
        assert np.abs(np.diagonal(dense, off)).max() <= 1e-12 * N
    assert rel(np.linalg.svd(dense, compute_uv=False), s_ref) <= 1e-12
    assert rel(sp, s_ref) <= 1e-8


def test_stage1_guards_raise_value_errors(devices8):
    """herbt and ge2gb need N % mb == 0, as the reference asserts."""
    a = rand(np.random.default_rng(2), (4 * MB - 3, 4 * MB - 3))
    with grids(DISTS[0]):
        C = port(ref_cyclic_of(a + a.T, MB, DISTS[0]))
        with pytest.raises(ValueError, match="N % mb"):
            cyclic.herbt_cyclic(C)
        with pytest.raises(ValueError, match="N % mb"):
            cyclic.gebrd_ge2gb_cyclic(C)


def test_descriptor_round_trip_carries_the_qr_state(devices8):
    """The T stack is rank (0, 0)'s, as the reference returns Ts[0, 0],
    and the factor carries the input's descriptor."""
    a = rand(np.random.default_rng(3), (3 * MB, 3 * MB))
    with grids(DISTS[0]):
        C = ref_cyclic_of(a, MB, DISTS[0])
        Fp, Tsp = cyclic.geqrf_cyclic(port(C))
    assert dataclasses.asdict(Fp.desc) == dataclasses.asdict(C.desc)
    assert tuple(Tsp.shape) == (3, MB, MB)
