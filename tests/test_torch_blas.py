"""Port parity: the tile kernels (``kernels/blas.py``), the trailing-update
router (``kernels/quant.py``) and the blocked ``ops/blas3.trsm``/``gemm``
against the JAX package. f64 throughout, tolerance 1e-12 relative."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import blas as ref_k
from dplasma_tpu.ops import blas3 as ref_blas3
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import quant
from dplasma_tpu_torch.ops import blas3
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12


def _rel(ref, got):
    ref = np.asarray(ref)
    return np.abs(ref - got.numpy()).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture
def tiles(rng):
    n = 24
    a = rng.standard_normal((n, n)) + n * np.eye(n)   # well conditioned
    b = rng.standard_normal((n, 9))
    c = rng.standard_normal((9, n))
    return a, b, c


@pytest.mark.parametrize("side,lower,trans,unit", list(itertools.product(
    ["L", "R"], [True, False], ["N", "T", "C"], [False, True])))
@pytest.mark.parametrize("inv", ["auto", "always"])
def test_trsm_all_cases(tiles, side, lower, trans, unit, inv):
    a, b, c = tiles
    rhs = b if side == "L" else c
    with cfg.override_scope({"trsm_inv": inv}):
        got = k.trsm(torch.from_numpy(a), torch.from_numpy(rhs),
                     side=side, lower=lower, trans=trans, unit=unit,
                     alpha=0.5)
    want = ref_k.trsm(jnp.asarray(a), jnp.asarray(rhs), side=side,
                      lower=lower, trans=trans, unit=unit, alpha=0.5)
    assert _rel(want, got) <= TOL * 100


@pytest.mark.parametrize("lower", [True, False])
def test_tile_potrf_trtri_lauum(tiles, lower):
    a, _, _ = tiles
    spd = a @ a.T
    want = ref_k.potrf(jnp.asarray(spd), lower=lower)
    got = k.potrf(torch.from_numpy(spd), lower=lower)
    assert _rel(want, got) <= TOL
    assert _rel(ref_k.trtri(jnp.asarray(a), lower=lower),
                k.trtri(torch.from_numpy(a), lower=lower)) <= TOL
    assert _rel(ref_k.lauum(jnp.asarray(a), lower=lower),
                k.lauum(torch.from_numpy(a), lower=lower)) <= TOL


def test_products(tiles):
    a, b, c = tiles
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    ja, jb, jc = map(jnp.asarray, (a, b, c))
    assert _rel(ref_k.dot(ja, jb), k.dot(ta, tb)) <= TOL
    assert _rel(ref_k.dot(jb, ja, ta=True), k.dot(tb, ta, ta=True)) <= TOL
    assert _rel(ref_k.gemm(2.0, ja, jb, -1.0, jb),
                k.gemm(2.0, ta, tb, -1.0, tb)) <= TOL
    assert _rel(ref_k.syrk(1.5, jb, 0.5, ja),
                k.syrk(1.5, tb, 0.5, ta)) <= TOL
    assert _rel(ref_k.herk(1.5, jc, 0.5, ja, trans="C"),
                k.herk(1.5, tc, 0.5, ta, trans="C")) <= TOL
    assert _rel(ref_k.trmm(ja, jb, trans="T", unit=True),
                k.trmm(ta, tb, trans="T", unit=True)) <= TOL
    assert _rel(ref_k.tri(ja, lower=False, unit=True),
                k.tri(ta, lower=False, unit=True)) == 0
    assert k.dot(ta.float(), tb).dtype == torch.float64


@pytest.mark.parametrize("lower", [True, False])
def test_tile_potrf_not_spd_gives_nan_triangle(tiles, lower):
    a, _, _ = tiles
    bad = -(a @ a.T)
    got = k.potrf(torch.from_numpy(bad), lower=lower).numpy()
    want = np.asarray(ref_k.potrf(jnp.asarray(bad), lower=lower))
    n = bad.shape[0]
    idx = np.tril_indices(n) if lower else np.triu_indices(n)
    assert np.isnan(want[idx]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_dd_route_raises_rather_than_going_native(tiles):
    """Under dd_gemm=always the f64 tile kernels take the limb route
    (every product closed by K2's route), never native FP64; f32 and
    dd_gemm=never stay native. The LU and QR sweeps take the dd panels
    (tests/test_torch_dd_lu.py, test_torch_dd_qr*.py)."""
    a, b, _ = tiles
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with cfg.override_scope({"dd_gemm": "always"}):
        for fn in (lambda: k.dot(ta, tb), lambda: k.potrf(ta @ ta.T),
                   lambda: k.trsm(ta, tb), lambda: k.trtri(ta)):
            routed = pdd.ROUTED
            assert torch.isfinite(fn()).all()
            assert pdd.ROUTED > routed
        assert torch.equal(k.dot(ta, tb), dd.mm(ta, tb))
        # f32 never takes the limb route
        routed = pdd.ROUTED
        k.dot(ta.float(), tb.float())
        assert pdd.ROUTED == routed
    with cfg.override_scope({"dd_gemm": "never"}):
        k.dot(ta, tb)
        assert pdd.ROUTED == routed


@pytest.fixture
def dd_always():
    ref_cfg.mca_set("dd_gemm", "always")
    try:
        with cfg.override_scope({"dd_gemm": "always"}):
            yield
    finally:
        ref_cfg.mca_unset("dd_gemm")


def test_dd_dot_and_gemm_match_reference_bitwise(tiles, dd_always):
    """The limb products are exact integer work: bitwise."""
    a, b, c = tiles
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    ta, tb, tc = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)
    for want, got in (
            (ref_k.dot(ja, jb), k.dot(ta, tb)),
            (ref_k.dot(jb, ja, ta=True), k.dot(tb, ta, ta=True)),
            (ref_k.dot(jc, jc, tb=True), k.dot(tc, tc, tb=True)),
            (ref_k.gemm(0.5, ja, jb, -2.0, jb), k.gemm(0.5, ta, tb, -2.0, tb))):
        np.testing.assert_array_equal(np.asarray(want).view(np.int64),
                                      got.numpy().view(np.int64))


@pytest.mark.parametrize("lower", [True, False])
def test_dd_tile_kernels_match_reference(tiles, dd_always, lower):
    """potrf, trsm and trtri refine f32 seeds: within 1e-12."""
    a, b, _ = tiles
    spd = a @ a.T
    ja, jb, ta, tb = (jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a),
                      torch.from_numpy(b))
    assert _rel(ref_k.potrf(jnp.asarray(spd), lower=lower),
                k.potrf(torch.from_numpy(spd), lower=lower)) <= TOL
    assert _rel(ref_k.trtri(ja, lower=lower), k.trtri(ta, lower=lower)) \
        <= TOL
    for side, trans in (("L", "N"), ("R", "T")):
        rhs = (jb, tb) if side == "L" else (jb.T, tb.T)
        assert _rel(ref_k.trsm(ja, rhs[0], side=side, lower=lower,
                               trans=trans, alpha=2.0),
                    k.trsm(ta, rhs[1], side=side, lower=lower, trans=trans,
                           alpha=2.0)) <= TOL


def test_update_dot_falls_through_and_int8_raises(tiles):
    a, b, _ = tiles
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(quant.update_dot(ta, tb), k.dot(ta, tb))
    with cfg.override_scope({"quant.updates": "int8"}):
        assert quant.updates_active(torch.float32, torch.float32)
        assert not quant.updates_active(torch.float64)
        # f64 falls through bit-identically, as in the ref
        assert torch.equal(quant.update_dot(ta, tb), k.dot(ta, tb))
        # f32 takes the block-scaled int8 GEMM (ported: no longer raises)
        a32, b32 = ta.float(), tb.float()
        assert torch.equal(quant.update_dot(a32, b32),
                           quant.qgemm(a32, b32))
        assert not torch.equal(quant.update_dot(a32, b32), k.dot(a32, b32))
    assert quant.quant_params() == (128, "off", "probe")


@pytest.mark.parametrize("side,uplo,trans", list(itertools.product(
    ["L", "R"], ["L", "U"], ["N", "T", "C"])))
def test_blocked_trsm(side, uplo, trans):
    N, nb = 45, 16
    A = ref_gen.plghe(float(N), N, nb, seed=7, dtype=jnp.float64)
    Bm, Bn = (N, 11) if side == "L" else (11, N)
    B = ref_gen.plrnt(Bm, Bn, nb, nb, seed=8, dtype=jnp.float64)
    TA, TB = (TileMatrix.from_reference(np.asarray(x.data),
                                        dataclasses.asdict(x.desc),
                                        device="cpu") for x in (A, B))
    want = ref_blas3.trsm(0.5, A, B, side=side, uplo=uplo, trans=trans)
    got = blas3.trsm(0.5, TA, TB, side=side, uplo=uplo, trans=trans)
    assert got.desc == TB.desc
    assert _rel(want.data, got.data) <= TOL * 100


def test_blocked_gemm():
    A = ref_gen.plrnt(40, 30, 16, 16, seed=1, dtype=jnp.float64)
    B = ref_gen.plrnt(30, 20, 16, 16, seed=2, dtype=jnp.float64)
    C = ref_gen.plrnt(40, 20, 16, 16, seed=3, dtype=jnp.float64)
    TA, TB, TC = (TileMatrix.from_reference(np.asarray(x.data),
                                            dataclasses.asdict(x.desc),
                                            device="cpu") for x in (A, B, C))
    want = ref_blas3.gemm(0.51, A, B, -0.42, C)
    got = blas3.gemm(0.51, TA, TB, -0.42, TC)
    assert _rel(want.data, got.data) <= TOL


@pytest.mark.parametrize("base", [None, 8])
def test_tile_getrf_nopiv(tiles, base):
    """Unpivoted tile LU on a diagonally dominant tile, plain and
    blocked-recursive, against the reference's."""
    a, _, _ = tiles
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    if base is None:
        want, got = ref_k.getrf_nopiv(ja), k.getrf_nopiv(ta)
    else:
        want = ref_k.getrf_nopiv_blocked(ja, base)
        got = k.getrf_nopiv_blocked(ta, base)
    assert _rel(want, got) <= TOL
    n = a.shape[0]
    L = torch.tril(got, -1) + torch.eye(n, dtype=got.dtype)
    assert torch.allclose(L @ torch.triu(got), ta, rtol=0, atol=1e-12)
