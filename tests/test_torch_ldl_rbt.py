"""Port parity: the LDLᴴ solvers (``ops.ldl``) and the random butterfly
transform (``ops.rbt``) of ``dplasma_tpu_torch`` against ``dplasma_tpu``,
on the very same padded inputs (the reference on the CPU with x64, all
of its ops of one precision under one ``jax.jit``, as its own tests jit
hetrf: one compile instead of one per eager op).

The butterfly's random diagonals are host constants drawn by numpy in
both packages, so ``_rdiag`` and the constants each op multiplies by
are bitwise the reference's. The rest rounds in each package's own
order: the packed LDLᴴ factor (its strict upper scratch included), the
solves, the butterflies in every mode at depths 1 and 2 (3 in the
U⁻¹U round trip), and ``hesv_rbt``
(its factor and solution) agree within max|Δ| <= TOL·max|reference|,
TOL = 1e-4 for s/c and 1e-12 for d/z, on a diagonally dominant
Hermitian matrix. Size: N = 45 with nb = 8 (edge tiles). The
butterflies and ``hesv_rbt`` also run on an indefinite matrix with
eigenvalues ±[1, 2]: there the pivot-free factor grows in both
packages, so in d and z the solution is held by the -x check and to the
reference's within TOL. d also runs under MCA
``dd_gemm=always``: every product and solve of hetrf and hetrs takes
the K2 route as ops/ldl.py counts them, and the results stay within
1e-12 of the reference's f64 answer (its own dd route compiles a limb
program per shape on the CPU, too slow for this file).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import TileMatrix as RefTile
from dplasma_tpu.ops import checks as ref_checks
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import ldl as ref_ldl
from dplasma_tpu.ops import rbt as ref_rbt
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.ops import checks, ldl, rbt
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DT = {"s": jnp.float32, "d": jnp.float64, "c": jnp.complex64,
      "z": jnp.complex128}
TDT = {"s": torch.float32, "d": torch.float64, "c": torch.complex64,
       "z": torch.complex128}
TOL = {"s": 1e-4, "c": 1e-4, "d": 1e-12, "z": 1e-12}
N, NB, NRHS = 45, 8, 3


def _tile(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _close(want, got, prec):
    want = np.asarray(want)
    got = got.resolve_conj().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(want - got).max()
    assert err <= TOL[prec] * np.abs(want).max(), err


def _indefinite(prec):
    """Q diag(±(1 + u)) Qᴴ, u ~ U[0, 1), from a seeded numpy draw."""
    rng = np.random.default_rng(17)
    q = rng.standard_normal((N, N))
    if prec in "cz":
        q = q + 1j * rng.standard_normal((N, N))
    q, _ = np.linalg.qr(q)
    ev = (1.0 + rng.random(N)) * np.where(np.arange(N) % 2, -1.0, 1.0)
    a = (q * ev) @ q.conj().T
    return RefTile.from_dense(jnp.asarray(a, DT[prec]), NB, NB)


def _all_ops(A, Ai, B, G):
    """Every op held here, one reference call each."""
    F = ref_ldl.hetrf(A)
    out = {"tile": ref_ldl.hetrf_tile(A.data[:NB, :NB]), "F": F.data,
           "trdsm": ref_ldl.trdsm(F, B).data,
           "trmdm": ref_ldl.trmdm(F, B).data,
           "hetrs": ref_ldl.hetrs(F, B).data,
           "hesv": [x.data for x in ref_ldl.hesv(A, B)]}
    for depth in (1, 2):
        for mode in "NTI":
            out[f"gebmm {depth} {mode}"] = ref_rbt.gebmm(
                B, seed=11, depth=depth, trans=mode).data
        out[f"hebut {depth}"] = ref_rbt.hebut(Ai, seed=12, depth=depth).data
        out[f"gebut {depth}"] = ref_rbt.gebut(G, seed_u=13, seed_v=14,
                                            depth=depth).data
    for depth in (1, 2):
        out[f"hesv_rbt {depth}"] = [x.data for x in
                                    ref_rbt.hesv_rbt(A, B, depth=depth)]
        out[f"hesv_rbt indefinite {depth}"] = ref_rbt.hesv_rbt(
            Ai, B, depth=depth)[1].data
    return out


@functools.lru_cache(maxsize=None)
def _reference(prec):
    """Inputs and the reference's results at one precision."""
    dt = DT[prec]
    A = ref_gen.plghe(float(N), N, NB, seed=3, dtype=dt)
    Ai = _indefinite(prec)
    B = ref_gen.plrnt(N, NRHS, NB, NB, seed=4, dtype=dt)
    G = ref_gen.plrnt(N, N - 3, NB, NB, seed=5, dtype=dt)
    out = jax.tree_util.tree_map(np.asarray,
                                 jax.jit(_all_ops)(A, Ai, B, G))
    out.update(A=A, Ai=Ai, B=B, G=G)
    return out


@pytest.mark.parametrize("seed", [0, 3872, 2**31 + 5, 2**40 + 3])
def test_rdiag_is_bitwise_the_references(seed):
    for lvl in range(3):
        for idx in range(5):
            for n in (1, 7, 22):
                want = ref_rbt._rdiag(seed, lvl, idx, n)
                got = rbt._rdiag(seed, lvl, idx, n)
                assert got.dtype == want.dtype == np.float64
                assert np.array_equal(got, want)


@pytest.mark.parametrize("prec", sorted(DT))
def test_butterfly_constants_round_as_the_references(prec):
    """The diagonals the ops multiply by: the f64 draw rounded to the
    operand's type, bitwise (mode N on a unit column is U's first level
    scale times the mix, so compare the converted draws directly)."""
    d = rbt._rdiag(3872, 1, 2, 17)
    want = np.asarray(jnp.asarray(d, DT[prec]))
    got = torch.as_tensor(d).to(TDT[prec]).numpy()
    assert want.dtype == got.dtype and np.array_equal(want, got)


@pytest.mark.parametrize("prec", sorted(DT))
def test_hetrf_tile_hetrf_and_solves_match_the_reference(prec):
    ref = _reference(prec)
    A, B = _tile(ref["A"]), _tile(ref["B"])
    nb = A.desc.nb
    _close(ref["tile"], ldl.hetrf_tile(A.data[:nb, :nb]), prec)
    F = ldl.hetrf(A)
    _close(ref["F"], F.data, prec)
    _close(ref["trdsm"], ldl.trdsm(F, B).data, prec)
    _close(ref["trmdm"], ldl.trmdm(F, B).data, prec)
    _close(ref["hetrs"], ldl.hetrs(F, B).data, prec)
    for want, got in zip(ref["hesv"], ldl.hesv(A, B)):
        _close(want, got.data, prec)


@pytest.mark.parametrize("prec", sorted(DT))
def test_butterflies_in_every_mode_match_the_reference(prec):
    ref = _reference(prec)
    B, Ai, G = _tile(ref["B"]), _tile(ref["Ai"]), _tile(ref["G"])
    for depth in (1, 2):
        for mode in "NTI":
            _close(ref[f"gebmm {depth} {mode}"],
                   rbt.gebmm(B, seed=11, depth=depth, trans=mode).data,
                   prec)
        _close(ref[f"hebut {depth}"],
               rbt.hebut(Ai, seed=12, depth=depth).data, prec)
        _close(ref[f"gebut {depth}"],
               rbt.gebut(G, seed_u=13, seed_v=14, depth=depth).data, prec)
    # U^{-1} U = I on the rows the butterfly covers, depth 3 included
    for depth in (1, 2, 3):
        back = rbt.gebmm(rbt.gebmm(B, seed=11, depth=depth, trans="N"),
                         seed=11, depth=depth, trans="I")
        _close(np.asarray(ref["B"].data), back.data, prec)


@pytest.mark.parametrize("prec", sorted(DT))
def test_hesv_rbt_matches_the_reference(prec):
    """On the diagonally dominant matrix, the factor of the butterflied
    matrix and the refined solution, at depths 1 and 2."""
    ref = _reference(prec)
    A, B = _tile(ref["A"]), _tile(ref["B"])
    for depth in (1, 2):
        for want, got in zip(ref[f"hesv_rbt {depth}"],
                             rbt.hesv_rbt(A, B, depth=depth)):
            _close(want, got.data, prec)


@pytest.mark.parametrize("prec", ["d", "z"])
def test_hesv_rbt_solves_an_indefinite_system(prec):
    """On the indefinite matrix the pivot-free factor grows (entries up
    to 10⁴ here, in both packages), so the factors part by that growth
    times the rounding. In d and z, the precisions the reference's own
    indefinite test runs (tests/test_ldl_rbt.py), the solution passes
    the -x check (check_axmb) in both packages and agrees with the
    reference's within TOL; in s and c two refinement steps do not
    absorb a growth of 10⁴ (the residual lands near the -x threshold in
    both packages)."""
    ref = _reference(prec)
    Ai, B = _tile(ref["Ai"]), _tile(ref["B"])
    for depth in (1, 2):
        _, X = rbt.hesv_rbt(Ai, B, depth=depth)
        r, ok = checks.check_axmb(Ai, B, X)
        assert ok, r
        want = ref[f"hesv_rbt indefinite {depth}"]
        r_ref, ok_ref = ref_checks.check_axmb(
            ref["Ai"], ref["B"], RefTile(jnp.asarray(want),
                                         ref["B"].desc))
        assert ok_ref, r_ref
        _close(want, X.data, prec)


def test_hetrf_and_hetrs_under_dd_route_every_product_to_k2():
    """hetrf at N = 45, nb = 8 (KT = 6): 3 K2 routes per panel with a
    trailing block (trsm_f64's two residuals, the HEDRK product); hetrs
    two blocked trsm's of KT trsm_f64 solves and KT − 1 products each;
    none unfused; the results within 1e-12 of the reference's f64."""
    ref = _reference("d")
    A, B = _tile(ref["A"]), _tile(ref["B"])
    kt = A.desc.KT
    routed, unfused = pdd.ROUTED, pdd.UNFUSED
    with cfg.override_scope({"dd_gemm": "always"}):
        F = ldl.hetrf(A)
        assert pdd.ROUTED - routed == 3 * (kt - 1)
        X = ldl.hetrs(F, B)
        assert pdd.ROUTED - routed == 3 * (kt - 1) + 2 * (2 * kt + kt - 1)
    assert pdd.UNFUSED == unfused
    _close(ref["F"], F.data, "d")
    _close(ref["hetrs"], X.data, "d")


def test_hetrf_leaves_its_input_alone():
    ref = _reference("s")
    A = _tile(ref["A"])
    before = A.data.clone()
    ldl.hetrf(A)
    rbt.hesv_rbt(A, _tile(ref["B"]))
    assert torch.equal(A.data, before)
