"""Port parity: the f64-equivalent (dd) route under the process grid.

Under MCA ``dd_gemm=always`` every per-rank product, solve and tile
factor of the port's block-cyclic ops goes through ``kernels.blas`` to
the limb route (``dd.mm`` and K2, ``dd.trsm_f64``, ``dd.potrf_f64``),
as the reference's shard_map bodies do. On the conftest's 8 virtual CPU
devices, 2×2 grid, f64, N = 32, nb = 8 (the shapes of
``test_torch_cyclic_blas3.py``):

- (i) every ``dd.mm`` call inside one port ``potrf_cyclic`` and one
  ``getrf_cyclic``, recorded with its operands, is held BITWISE to the
  reference's single-device ``dplasma_tpu.kernels.dd.mm`` on the same
  operands (the limb product is exact integer work);
- (ii) the 19 ops of the catalogue and ``getrf_cyclic`` under
  ``always`` are held to the reference's ``auto`` run (native f64 on
  the CPU) on the same grid and slabs within ``TOL`` = 1e-12 relative
  (max|Δ| / max|reference|), pivots bitwise;
- their K2 routes, counted on the CPU, equal chip_smoke's
  ``cyclic_k2_launches`` (on the card the same count is held against
  K2's launch counter), and the f64 slabs keep the psum path.

The patched-reference comparison (the reference itself under
``always``) is in ``test_torch_cyclic_dd_ref.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu.ops import gemm as ref_gemm
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu_torch.descriptors import Dist, TileMatrix
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_ring as pring
from dplasma_tpu_torch.ops import gemm
from dplasma_tpu_torch.parallel import cyclic, mesh
from dplasma_tpu_torch.utils import config as cfg
from torch_cyclic_pairs import GRID_2x2, grids, port, ref_cyclic_of, rel
from torch_threads import one_torch_thread  # noqa: F401

import chip_smoke as cs

TOL = 1e-12
MB, MT = 8, 4
N = MB * MT
ALWAYS = {"dd_gemm": "always"}


def _inputs():
    """The dense numpy inputs, made from a seed: an SPD matrix and its
    Cholesky factor, a well-conditioned general matrix (the triangular
    solves read one triangle of it), a random square matrix and an
    nb-wide right-hand side."""
    rng = np.random.default_rng(21)
    a0 = rng.standard_normal((N, N))
    spd = a0 @ a0.T + N * np.eye(N)
    return {"A": spd, "U": np.triu(spd), "L": np.linalg.cholesky(spd),
            "T": rng.standard_normal((N, N)) + 2 * N * np.eye(N),
            "G": rng.standard_normal((N, N)),
            "B": rng.standard_normal((N, MB))}


def _tile(x):
    return RTile.from_dense(jnp.asarray(x), MB, MB)


def _port_tile(X):
    return TileMatrix.from_reference(np.asarray(X.data),
                                     dataclasses.asdict(X.desc),
                                     device="cpu")


#: the op under test, written once for both packages and for the card
#: (chip_smoke phase 21): ``lib`` is the package's ``parallel.cyclic``,
#: ``M`` its inputs
OPS = cs.DDC_OPS


def _arrays(out):
    """The output's arrays as a flat list of numpy arrays (slabs for a
    CyclicMatrix, storage for a TileMatrix)."""
    if isinstance(out, (list, tuple)):
        return [a for x in out for a in _arrays(x)]
    if isinstance(out, cyclic.CyclicMatrix):
        return [out.to_reference()[0]]
    if isinstance(out, TileMatrix):
        return [out.data.numpy()]
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    if hasattr(out, "data") and not isinstance(out, np.ndarray):
        return [np.asarray(out.data)]
    return [np.asarray(out)]


@pytest.fixture(scope="module")
def pair(devices8):
    """Both packages' inputs on the 2×2 grid, and the reference's
    ``auto`` result of every op (native f64 on the CPU), computed once
    for the module."""
    x = _inputs()
    with grids(GRID_2x2):
        R = {k: ref_cyclic_of(v, MB, GRID_2x2) for k, v in x.items()}
        R["F"], R["perm"] = ref_cyclic.getrf_cyclic(R["G"])
        R["Gt"] = _tile(x["G"])
        R["summa"] = ref_gemm.gemm_summa
        want = {op: _arrays(fn(ref_cyclic, R)) for op, fn in OPS.items()}
    P = {k: port(v) for k, v in R.items()
         if isinstance(v, ref_cyclic.CyclicMatrix)}
    P["perm"] = torch.from_numpy(np.array(R["perm"]))
    P["Gt"] = _port_tile(R["Gt"])
    P["summa"] = gemm.gemm_ex
    return P, want


@pytest.mark.parametrize("op", sorted(OPS))
def test_cyclic_op_under_dd_matches_the_references_native_run(pair, op):
    """(ii): the port's op under ``always`` against the reference's
    ``auto`` run on the same slabs, within 1e-12 relative; integer
    outputs (the LU pivots) bitwise; the op's limb products as
    ``cyclic_k2_launches`` counts them."""
    P, want = pair
    with grids(GRID_2x2), cfg.override_scope(ALWAYS):
        before = pdd.ROUTED
        got = _arrays(OPS[op](cyclic, P))
        routed = pdd.ROUTED - before
    assert len(got) == len(want[op])
    for g, w in zip(got, want[op]):
        assert g.shape == w.shape, op
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            assert rel(g, w) <= TOL, (op, rel(g, w))
    la = cfg.mca_get_int("sweep.lookahead", 1)
    assert routed == cs.cyclic_k2_launches(op, 2, 2, MT, la)


@pytest.mark.parametrize("grid", [(1, 4), (4, 1)], ids=str)
@pytest.mark.parametrize("op,lookahead", [
    ("potrf_L", 0), ("potrf_L", 1), ("getrf", 0), ("getrf", 1),
    ("geqrf", 0), ("geqrf", 1), ("herbt", 1), ("ge2gb", 1),
    ("gemm_ex", 1)])
def test_k2_routes_on_other_grids(op, lookahead, grid):
    """The derived K2 count holds on grids with one rank along an axis
    and at either lookahead (the port alone; the grid's shape enters
    the per-axis-group products and SUMMA's step count)."""
    P_, Q_ = grid
    x = _inputs()
    m = mesh.make_mesh(P_, Q_, "cpu")
    d = Dist(P=P_, Q=Q_)
    with mesh.use_grid(m), cfg.override_scope(
            {"sweep.lookahead": lookahead, **ALWAYS}):
        M = {k: cyclic.CyclicMatrix.from_tile(
            TileMatrix.from_dense(torch.from_numpy(v), MB, MB), d)
            for k, v in x.items() if k in ("A", "G")}
        M["Gt"] = TileMatrix.from_dense(torch.from_numpy(x["G"]), MB, MB)
        M["summa"] = gemm.gemm_ex
        before = pdd.ROUTED
        OPS[op](cyclic, M)
        routed = pdd.ROUTED - before
    assert routed == cs.cyclic_k2_launches(op, P_, Q_, MT, lookahead)


def _recorded_mm(monkeypatch, run):
    """Run ``run`` with every ``dd.mm`` call recorded: [(a, b, out)]."""
    seen = []
    real = dd.mm

    def rec(a, b, bits=53):
        out = real(a, b, bits=bits)
        seen.append((a.clone(), b.clone(), bits, out))
        return out
    monkeypatch.setattr(dd, "mm", rec)
    run()
    monkeypatch.setattr(dd, "mm", real)
    return seen


def _bits(x):
    return np.asarray(x).view(np.int64)


@pytest.mark.parametrize("op", ["potrf_L", "getrf"])
def test_per_rank_limb_products_are_the_references_bitwise(
        pair, monkeypatch, op):
    """(i): every limb product of one port call, on its own operands,
    against the reference's single-device ``dd.mm``, raw bits. The
    reference's product is jitted once per shape (the distinct shapes
    are few; its limb products and recombine are exact, so the jitted
    and the eager product give the same bits)."""
    P, _ = pair
    ref_mm = jax.jit(ref_dd.mm, static_argnames=("bits",))
    with grids(GRID_2x2), cfg.override_scope(ALWAYS):
        seen = _recorded_mm(monkeypatch, lambda: OPS[op](cyclic, P))
    la = cfg.mca_get_int("sweep.lookahead", 1)
    # the products of dd.mm alone: the solves' residuals are
    # gemm_residual's (trsm_f64's two a solve)
    solves = {"potrf_L": 1, "getrf": 2}[op] * 2 * 4 * MT
    assert len(seen) == cs.cyclic_k2_launches(op, 2, 2, MT, la) - solves
    for a, b, bits, out in seen:
        want = ref_mm(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                      bits=bits)
        np.testing.assert_array_equal(_bits(want), _bits(out.numpy()))


def test_f64_slabs_take_the_psum_path_under_dd(pair):
    """The f64 slabs keep the psum path under dd, as natively: K5 is an
    f32/bf16 kernel, so no ring route is taken even with
    ``ring.enable=on``."""
    P, _ = pair
    before = pring.ROUTED
    with grids(GRID_2x2), cfg.override_scope(
            {"ring.enable": "on", **ALWAYS}):
        cyclic.potrf_cyclic(P["A"], "L")
        cyclic.getrf_cyclic(P["G"])
    assert pring.ROUTED == before


@pytest.mark.parametrize("op", ["geqrf", "herbt", "ge2gb", "gesvd"])
def test_k2_routes_with_a_split_reconstruction_lu(op):
    """At nb = 64 the TSQR-HR reconstruction's f64 LU
    (``getrf_nopiv_blocked``) splits its tile once: two solves and a
    product on the limb route, once an axis group and panel, as
    ``cyclic_k2_launches`` derives them (nb = 8 never splits)."""
    nb, kt = 64, 2
    n = nb * kt
    rng = np.random.default_rng(3)
    g = rng.standard_normal((n, n))
    a = g @ g.T + n * np.eye(n)
    d = Dist(P=2, Q=2)
    with mesh.use_grid(mesh.make_mesh(2, 2, "cpu")), \
            cfg.override_scope(ALWAYS):
        X = cyclic.CyclicMatrix.from_tile(TileMatrix.from_dense(
            torch.from_numpy(a if op == "herbt" else g), nb, nb), d)
        before = pdd.ROUTED
        {"geqrf": cyclic.geqrf_cyclic, "herbt": cyclic.herbt_cyclic,
         "ge2gb": cyclic.gebrd_ge2gb_cyclic,
         "gesvd": cyclic.gesvd_cyclic}[op](X)
        routed = pdd.ROUTED - before
    la = cfg.mca_get_int("sweep.lookahead", 1)
    assert cs.nopiv_nodes(nb) == 1
    assert routed == cs.cyclic_k2_launches(op, 2, 2, kt, la, nb=nb)
