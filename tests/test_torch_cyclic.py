"""Port parity: the block-cyclic distribution (``dplasma_tpu_torch.
parallel.cyclic``) against the JAX package's ``parallel.cyclic`` on the
conftest's 8 virtual CPU devices, as ``tests/test_cyclic.py`` runs it.

The port's mesh is a single-controller virtual mesh on the CPU; the
reference's slabs are handed across with ``CyclicMatrix.from_reference``
so both factor the very same local storage. Gates:

- conversions: slabs and round trips bitwise (pure index moves);
- f64 factors within 1e-10 (max abs, the reference test's gate) and the
  LU permutation bitwise equal;
- f32 factors within 1e-4 relative to max|factor|: the two packages sum
  the same products in another order (torch's CPU BLAS against XLA's);
- ``ring.enable=on`` against ``off`` on the port alone: ``torch.equal``
  on factor and perm (potrf, getrf) or T stack (geqrf). The broadcast's
  owner mask is one-hot and the winner rows have one owner each, so both
  sums are exact (−0.0 and +0.0 compare equal);
- the K1 products of every cyclic op, counted as its code derives them.

The rest of the catalogue's parity is in ``test_torch_cyclic_solve.py``,
``test_torch_cyclic_blas3.py``, ``test_torch_cyclic_qr_eig.py`` and
``test_torch_comm_model.py``; the dd route under the grid in
``test_torch_cyclic_dd.py``.
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import Dist as RDist
from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu.parallel import mesh as ref_mesh
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import Dist, TileMatrix
from dplasma_tpu_torch.kernels import pallas_ring as pring
from dplasma_tpu_torch.ops import gemm as port_gemm
from dplasma_tpu_torch.parallel import cyclic, layout, mesh
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DISTS = [
    dict(P=2, Q=4),
    dict(P=2, Q=4, kp=2, kq=1),
    dict(P=2, Q=4, kp=2, kq=3),
    dict(P=2, Q=4, kp=1, kq=2, ip=1, jq=2),
    dict(P=4, Q=2, kp=3, kq=2, ip=2),
]

FACTOR_DISTS = [
    dict(P=2, Q=4),
    dict(P=2, Q=4, kp=2, kq=2),
    dict(P=4, Q=2, kp=1, kq=3, ip=1, jq=1),
]

# grids with one ring axis only, and the square one
SMALL_GRIDS = [dict(P=2, Q=2), dict(P=1, Q=4), dict(P=4, Q=1)]


@contextlib.contextmanager
def _grids(dist):
    """The reference's mesh over the virtual devices and the port's
    virtual mesh on the CPU, both active."""
    m = ref_mesh.make_mesh(dist["P"], dist["Q"])
    with ref_mesh.use_grid(m), \
            mesh.use_grid(mesh.make_mesh(dist["P"], dist["Q"], "cpu")):
        yield


@contextlib.contextmanager
def _both(kv):
    with cfg.override_scope(kv), ref_cfg.override_scope(kv):
        yield


def _port_slabs(C):
    return cyclic.CyclicMatrix.from_reference(
        np.asarray(C.data), dataclasses.asdict(C.desc), device="cpu")


def _slabs_np(C):
    return C.to_reference()[0]


# ---------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dist", DISTS, ids=str)
@pytest.mark.parametrize("MN", [(8, 8), (11, 7), (5, 13)])
def test_conversions_match_reference(devices8, dist, MN):
    """from_tile gives the reference's slabs bitwise; to_tile
    round-trips; from_reference/to_reference carry the state across."""
    MT, NT = MN
    mb = 4
    M, N = MT * mb - 1, NT * mb - 2  # ragged edges
    a = np.random.default_rng(5).standard_normal((M, N))
    A = RTile.from_dense(jnp.asarray(a), mb, mb, RDist(**dist))
    T = TileMatrix.from_reference(np.asarray(A.data),
                                  dataclasses.asdict(A.desc), device="cpu")
    with _grids(dist):
        C = ref_cyclic.CyclicMatrix.from_tile(A)
        Cp = cyclic.CyclicMatrix.from_tile(T)
        back = Cp.to_tile()
    np.testing.assert_array_equal(_slabs_np(Cp), np.asarray(C.data))
    assert dataclasses.asdict(Cp.desc) == dataclasses.asdict(C.desc)
    np.testing.assert_array_equal(back.data.numpy(),
                                  np.asarray(A.zero_pad().data))
    assert back.desc == T.desc
    carried = _port_slabs(C)
    np.testing.assert_array_equal(_slabs_np(carried), np.asarray(C.data))


def test_slab_coords_match_the_layout_tables():
    """Every element row of a slab names its global tile as the layout
    algebra places it."""
    desc = cyclic.CyclicDesc(37, 29, 4, 4, Dist(P=3, Q=2, kp=2, kq=1,
                                                ip=1, jq=1))
    for p in range(3):
        for q in range(2):
            grow, gcol, gid, gcid = cyclic._slab_coords(desc, p, q)
            for e in range(0, desc.MTL * 4, 4):
                t = int(grow[e])
                assert layout.global_index(e // 4, p, 3, 2, 1) == t
                if t < desc.MT:
                    assert layout.owner(t, 3, 2, 1) == p
            assert int(gid[5]) == int(grow[5]) * 4 + 1
            assert int(gcid[6]) == int(gcol[6]) * 4 + 2


@pytest.mark.parametrize("dist", [dict(P=2, Q=2), dict(P=2, Q=3, kp=2)])
def test_from_tile_slabs_have_the_uniform_local_shape(dist):
    """Every rank's slab is (MTL*mb, NTL*nb) on A's device when no mesh
    is active, pad slots zero, and the slabs hold each element once."""
    A = TileMatrix.from_dense(torch.arange(1.0, 1 + 10 * 9).reshape(10, 9),
                              4, 3)
    assert mesh.active() is None
    C = cyclic.CyclicMatrix.from_tile(A, Dist(**dist))
    d = C.desc
    total = 0.0
    for row in C.data:
        for s in row:
            assert s.shape == (d.MTL * 4, d.NTL * 3)
            assert s.device == A.data.device
            total += float(s.sum())
    assert total == float(A.data.sum())


# ---------------------------------------------------------------------
# distributed Cholesky
# ---------------------------------------------------------------------

def _potrf_pair(dist, MT, mb, jdt, lookahead):
    N = MT * mb
    A = ref_gen.plghe(float(N), N, mb, seed=3872, dtype=jdt)
    A = RTile(A.data, A.desc.with_shape(N, N))
    with _grids(dist), _both({"sweep.lookahead": lookahead}):
        C = ref_cyclic.CyclicMatrix.from_tile(A, RDist(**dist))
        want = ref_cyclic.potrf_cyclic(C, "L")
        got = cyclic.potrf_cyclic(_port_slabs(C), "L")
    return np.asarray(want.data), _slabs_np(got)


@pytest.mark.parametrize("dist", FACTOR_DISTS, ids=str)
@pytest.mark.parametrize("MT", [4, 7])
def test_potrf_cyclic_matches_reference(devices8, dist, MT):
    want, got = _potrf_pair(dist, MT, 8, jnp.float64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dist", [FACTOR_DISTS[0], SMALL_GRIDS[0]],
                         ids=str)
def test_potrf_cyclic_lookahead_0_matches_reference(devices8, dist):
    want, got = _potrf_pair(dist, 5, 8, jnp.float64, 0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dist", SMALL_GRIDS, ids=str)
def test_potrf_cyclic_small_grids_match_reference(devices8, dist):
    want, got = _potrf_pair(dist, 6, 8, jnp.float64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_potrf_cyclic_f32_matches_reference(devices8):
    want, got = _potrf_pair(FACTOR_DISTS[0], 4, 8, jnp.float32, 1)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("dist", FACTOR_DISTS, ids=str)
def test_potrf_cyclic_upper_storage_matches_reference(devices8, dist):
    """uplo=U on the plghe matrix (both triangles stored; the sweep
    reads the upper one): the mirrored sweep gives the reference's slabs
    (the U path has no lookahead or ring, as in the reference)."""
    N, mb = 6 * 8, 8
    A = ref_gen.plghe(float(N), N, mb, seed=3872, dtype=jnp.float64)
    A = RTile(A.data, A.desc.with_shape(N, N))
    with _grids(dist):
        C = ref_cyclic.CyclicMatrix.from_tile(A, RDist(**dist))
        want = np.asarray(ref_cyclic.potrf_cyclic(C, "U").data)
        got = _slabs_np(cyclic.potrf_cyclic(_port_slabs(C), "U"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------
# distributed pivoted LU
# ---------------------------------------------------------------------

def _getrf_pair(dist, MT, mb, jdt, lookahead, ragged=3):
    N = MT * mb - ragged
    A = ref_gen.plrnt(N, N, mb, mb, seed=3872, dtype=jdt)
    base = RTile(A.pad_diag().data, A.desc)
    with _grids(dist), _both({"sweep.lookahead": lookahead}):
        C = ref_cyclic.CyclicMatrix.from_tile(base, RDist(**dist))
        F, perm = ref_cyclic.getrf_cyclic(C)
        Fp, permp = cyclic.getrf_cyclic(_port_slabs(C))
        full = Fp.to_tile().data.numpy()[permp.numpy()]
    return (np.asarray(F.data), np.asarray(perm), _slabs_np(Fp),
            permp.numpy(), full, np.asarray(base.data))


def _check_factorization(full, base, perm, N):
    """The reference test's contract: A[perm] = L U on the padded
    matrix, and the CALU growth bound."""
    ap = base[perm]
    n = full.shape[0]
    L = np.tril(full, -1) + np.eye(n)
    assert np.abs(ap - L @ np.triu(full)).max() < 1e-10 * N
    assert np.abs(np.tril(full, -1)).max() <= 8.0


@pytest.mark.parametrize("dist", FACTOR_DISTS, ids=str)
@pytest.mark.parametrize("MT", [4, 7])
def test_getrf_cyclic_matches_reference(devices8, dist, MT):
    want, perm, got, permp, full, base = _getrf_pair(dist, MT, 8,
                                                     jnp.float64, 1)
    np.testing.assert_array_equal(permp, perm)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    _check_factorization(full, base, permp, MT * 8 - 3)


@pytest.mark.parametrize("dist", [FACTOR_DISTS[2], SMALL_GRIDS[0]],
                         ids=str)
def test_getrf_cyclic_lookahead_0_matches_reference(devices8, dist):
    want, perm, got, permp, _, _ = _getrf_pair(dist, 5, 8, jnp.float64, 0)
    np.testing.assert_array_equal(permp, perm)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dist", SMALL_GRIDS, ids=str)
def test_getrf_cyclic_small_grids_match_reference(devices8, dist):
    want, perm, got, permp, full, base = _getrf_pair(dist, 6, 8,
                                                     jnp.float64, 1)
    np.testing.assert_array_equal(permp, perm)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    _check_factorization(full, base, permp, 6 * 8 - 3)


def test_getrf_cyclic_f32_matches_reference(devices8):
    want, perm, got, permp, _, _ = _getrf_pair(SMALL_GRIDS[0], 4, 8,
                                               jnp.float32, 1)
    np.testing.assert_array_equal(permp, perm)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_getrf_cyclic_rec_election_factorizes(devices8):
    """panel.kernel=rec elects with the recursive panel in both
    packages: same perm, same factor."""
    with _both({"panel.kernel": "rec"}):
        want, perm, got, permp, full, base = _getrf_pair(
            FACTOR_DISTS[0], 4, 8, jnp.float64, 1)
    np.testing.assert_array_equal(permp, perm)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    _check_factorization(full, base, permp, 4 * 8 - 3)


# ---------------------------------------------------------------------
# the ring route against the psum route (the port alone)
# ---------------------------------------------------------------------

def _port_cyclic(dist, N, mb, dtype, op):
    from dplasma_tpu_torch.ops import generators
    if op == "potrf":
        A = generators.plghe(float(N), N, mb, seed=11, dtype=dtype,
                             device="cpu")
    else:
        A = generators.plrnt(N, N, mb, mb, seed=11, dtype=dtype,
                             device="cpu")
    with mesh.use_grid(mesh.make_mesh(dist["P"], dist["Q"], "cpu")):
        C = cyclic.CyclicMatrix.from_tile(A, Dist(**dist))
        if op == "potrf":
            return cyclic.potrf_cyclic(C, "L"), None
        if op == "geqrf":
            return cyclic.geqrf_cyclic(C)
        return cyclic.getrf_cyclic(C)


@pytest.mark.parametrize("dist", [dict(P=2, Q=2), dict(P=2, Q=4, kp=2),
                                  dict(P=4, Q=1), dict(P=1, Q=4)], ids=str)
@pytest.mark.parametrize("op", ["potrf", "getrf", "geqrf"])
@pytest.mark.parametrize("lookahead", [0, 1])
def test_ring_on_equals_psum_path(dist, op, lookahead):
    res = {}
    routed = {}
    for mode in ("off", "on"):
        with cfg.override_scope({"ring.enable": mode,
                                 "sweep.lookahead": lookahead,
                                 "ring.chunks": 3}):
            before = pring.ROUTED
            # potrf_cyclic takes whole tiles (its pad diagonal is not
            # seeded, as in the reference); getrf a ragged edge
            res[mode] = _port_cyclic(dist, 64 if op == "potrf" else 61, 8,
                                     torch.float32, op)
            routed[mode] = pring.ROUTED - before
    (F0, p0), (F1, p1) = res["off"], res["on"]
    for row0, row1 in zip(F0.data, F1.data):
        for a, b in zip(row0, row1):
            assert torch.equal(a, b)
    if op != "potrf":             # getrf's perm, geqrf's T stack
        assert torch.equal(p0, p1)
    assert routed["off"] == 0
    KT = 8
    P, Q = dist["P"], dist["Q"]
    bcasts = KT * P if Q > 1 else 0
    shifts = KT * Q * (P - 1) if op == "getrf" else 0
    assert routed["on"] == bcasts + shifts


def test_f64_slabs_take_the_psum_path():
    """f64 has no ring kernel (the reference's rule): ring.enable=on
    routes nothing."""
    with cfg.override_scope({"ring.enable": "on"}):
        before = pring.ROUTED
        _port_cyclic(dict(P=2, Q=2), 40, 8, torch.float64, "getrf")
        assert pring.ROUTED == before


def _nopiv_k1(n, base=32):
    """K1 products of one ``blas.getrf_nopiv_blocked`` of an n×n f32
    tile (the TSQR-HR reconstruction's LU): its Schur product a level
    when every dimension is at least 256."""
    if n <= base:
        return 0
    n1 = n // 2
    return (int(min(n1, n - n1) >= 256) + _nopiv_k1(n1, base)
            + _nopiv_k1(n - n1, base))


def _k1_want(op, P, Q, KT, mb, lookahead):
    """K1 products of one call of ``op`` on the P×Q grid, f32, every slab
    dimension >= 256, as the code derives them: one product a step and
    rank for the sweeps (two for her2k; two TRSM sweeps for potrs,
    getrs, and trtri + lauum for potri; lcm(P, Q)·summa_steps steps for
    SUMMA); the CholeskyQR2 panels two Gram products a rank, and R2 R1
    plus the reconstruction's LU once an axis group."""
    R = P * Q
    grp = 1 + _nopiv_k1(mb)
    summa_steps = P * Q // np.gcd(P, Q) * 2
    return {
        "potrf": R * (KT + lookahead * (KT - 1)),
        "getrf": R * (KT + lookahead * (KT - 1)),
        "potrf_U": R * KT, "trsm_N": R * KT, "trsm_T": R * KT,
        "trsm_C": R * KT, "potrs_L": 2 * R * KT, "potrs_U": 2 * R * KT,
        "getrs": 2 * R * KT, "gemm_cyclic": R * KT,
        "gemm_ex_summa": R * summa_steps, "herk": R * KT, "trmm_N": R * KT,
        "trmm_C": R * KT, "hemm": R * KT, "her2k": 2 * R * KT,
        "lauum": R * KT, "trtri": R * KT, "potri": 2 * R * KT,
        "geqrf": KT * (5 * R + Q * grp) + lookahead * (KT - 1) * 2 * R,
        "herbt": (KT - 1) * (10 * R + Q * grp),
        "ge2gb": KT * (5 * R + Q * grp) + (KT - 1) * (5 * R + P * grp),
    }[op]


K1_OPS = ["potrf", "getrf", "potrf_U", "trsm_N", "trsm_T", "trsm_C",
          "potrs_L", "potrs_U", "getrs", "gemm_cyclic", "gemm_ex_summa",
          "herk", "trmm_N", "trmm_C", "hemm", "her2k", "lauum", "trtri",
          "potri", "geqrf", "herbt", "ge2gb"]


def _k1_run(op, dist, N, mb):
    """A call of ``op`` on f32 inputs at N (square tiles mb) on ``dist``;
    its operands (factors included) are made before the call."""
    from dplasma_tpu_torch.ops import generators
    if op in ("potrf", "getrf", "geqrf"):
        return lambda: _port_cyclic(dist, N, mb, torch.float32, op)
    P, Q = dist["P"], dist["Q"]
    m = mesh.make_mesh(P, Q, "cpu")
    d = Dist(**dist)
    A = generators.plghe(float(N), N, mb, seed=11, device="cpu")
    G = generators.plrnt(N, N, mb, mb, seed=12, device="cpu")
    B = generators.plrnt(N, mb, mb, mb, seed=13, device="cpu")
    with mesh.use_grid(m):
        Ac, Gc, Bc = (cyclic.CyclicMatrix.from_tile(X, d) for X in (A, G, B))
        L = cyclic.potrf_cyclic(Ac, "L")
        U = cyclic.potrf_cyclic(Ac, "U")
        F, perm = cyclic.getrf_cyclic(Gc)
    run = {
        "potrf_U": lambda: cyclic.potrf_cyclic(Ac, "U"),
        "trsm_N": lambda: cyclic.trsm_cyclic(Gc, Bc, "N"),
        "trsm_T": lambda: cyclic.trsm_cyclic(Gc, Bc, "T", uplo="U"),
        "trsm_C": lambda: cyclic.trsm_cyclic(Gc, Bc, "C"),
        "potrs_L": lambda: cyclic.potrs_cyclic(L, Bc, "L"),
        "potrs_U": lambda: cyclic.potrs_cyclic(U, Bc, "U"),
        "getrs": lambda: cyclic.getrs_cyclic(F, perm, Bc),
        "gemm_cyclic": lambda: cyclic.gemm_cyclic(Gc, Gc),
        "gemm_ex_summa": lambda: port_gemm.gemm_ex(1.0, G, G, 0.0, G),
        "herk": lambda: cyclic.herk_cyclic(Gc),
        "trmm_N": lambda: cyclic.trmm_cyclic(Gc, Gc, "N"),
        "trmm_C": lambda: cyclic.trmm_cyclic(Gc, Gc, "C", uplo="U"),
        "hemm": lambda: cyclic.hemm_cyclic(Ac, Gc),
        "her2k": lambda: cyclic.her2k_cyclic(Gc, Gc),
        "lauum": lambda: cyclic.lauum_cyclic(L),
        "trtri": lambda: cyclic.trtri_cyclic(L),
        "potri": lambda: cyclic.potri_cyclic(L),
        "herbt": lambda: cyclic.herbt_cyclic(Ac),
        "ge2gb": lambda: cyclic.gebrd_ge2gb_cyclic(Gc),
    }[op]

    def under_grid():
        with mesh.use_grid(m):
            return run()
    return under_grid


@pytest.mark.parametrize("op", K1_OPS)
@pytest.mark.parametrize("lookahead", [0, 1])
def test_k1_products_per_factorization(op, lookahead):
    """Every rank's slab-wide product takes the K1 route (the counts
    chip_smoke.py asserts on the card): per rank KT trailing products,
    plus KT − 1 at lookahead 1 for potrf L and getrf; the other ops'
    counts as :func:`_k1_want` derives them. Slab-wide f32 products of
    256 or more in every dimension pass K1's gate."""
    from dplasma_tpu_torch.kernels import pallas_kernels as pk
    dist, N, mb = dict(P=2, Q=2), 1024, 256
    with cfg.override_scope({"sweep.lookahead": lookahead}):
        run = _k1_run(op, dist, N, mb)
        pk.enable(True)
        try:
            before = pk.ROUTED
            run()
            routed = pk.ROUTED - before
        finally:
            pk.enable(False)
    assert routed == _k1_want(op, 2, 2, N // mb, mb, lookahead)


def test_k1_count_of_the_reconstruction_at_nb_512():
    """At nb = 512 the TSQR-HR reconstruction's LU has one K1 product
    (its top-level Schur update, 256 wide), once an axis group."""
    from dplasma_tpu_torch.kernels import pallas_kernels as pk
    dist, N, mb = dict(P=2, Q=2), 1024, 512
    pk.enable(True)
    try:
        with cfg.override_scope({"sweep.lookahead": 0}):
            before = pk.ROUTED
            _port_cyclic(dist, N, mb, torch.float32, "geqrf")
            routed = pk.ROUTED - before
    finally:
        pk.enable(False)
    assert _nopiv_k1(mb) == 1
    assert routed == _k1_want("geqrf", 2, 2, N // mb, mb, 0)
