"""Port parity: the complex128 f64-equivalent (dd) route of
``dplasma_tpu_torch.kernels.dd`` against ``dplasma_tpu.kernels.dd``, and
the z factorizations under MCA ``dd_gemm=always`` against the
reference's.

- ``dd.mm`` on complex is bitwise: both packages split the same
  [re | im] operands into the same limbs and recombine them the same
  way (two 2K-deep real limb products), and the result is the
  reference's ``re + 1j·im`` part by part — a ``.mH`` (conjugate-bit)
  operand included;
- ``trtri_f64``, ``trsm_f64`` (every side/trans/uplo) and ``potrf_f64``
  start from c64 seeds that LAPACK and XLA round alike but not
  identically, and the Newton and refinement steps on exact products
  pull both to f64 accuracy: within 1e-13 relative;
- zpotrf, zgetrf and zgeqrf at N=48, nb=16 (3 tiles, one shape per
  reference compile) within 1e-12, the permutation equal, and the K2
  route counter ``pallas_dd.ROUTED`` rising by the count derived from
  the code (each complex product is two limb products).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.ops import lu, qr
from dplasma_tpu_torch.ops import potrf as port_potrf
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DD = {"dd_gemm": "always"}
N, NB = 48, 16
KT = N // NB


def _c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint64)


def _rel(want, got):
    want = np.asarray(want)
    got = got.resolve_conj().numpy() if torch.is_tensor(got) else got
    assert want.shape == got.shape and np.isfinite(got).all()
    return np.abs(want - got).max() / np.abs(want).max()


# ---------------------------------------------------------------------
# the engine: mm bitwise, the tile solves within 1e-13
# ---------------------------------------------------------------------

def _mm_case(kind, rng):
    a, b = _c(rng, 20, 33), _c(rng, 33, 17)
    if kind == "cc":
        return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a),
                                                  torch.from_numpy(b))
    if kind == "mH_lhs":
        at = _c(rng, 33, 20)
        return ((jnp.asarray(at).conj().T, jnp.asarray(b)),
                (torch.from_numpy(at).mH, torch.from_numpy(b)))
    if kind == "mH_rhs":
        bt = _c(rng, 17, 33)
        return ((jnp.asarray(a), jnp.asarray(bt).conj().T),
                (torch.from_numpy(a), torch.from_numpy(bt).mH))
    if kind == "real_lhs":
        ar = rng.standard_normal((20, 33))
        return (jnp.asarray(ar), jnp.asarray(b)), (torch.from_numpy(ar),
                                                   torch.from_numpy(b))
    if kind == "real_rhs":
        br = rng.standard_normal((33, 17))
        return (jnp.asarray(a), jnp.asarray(br)), (torch.from_numpy(a),
                                                   torch.from_numpy(br))
    if kind == "c64":
        a32, b32 = a.astype(np.complex64), b.astype(np.complex64)
        return (jnp.asarray(a32), jnp.asarray(b32)), (torch.from_numpy(a32),
                                                      torch.from_numpy(b32))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["cc", "mH_lhs", "mH_rhs", "real_lhs",
                                  "real_rhs", "c64"])
@pytest.mark.parametrize("bits", [53, 32])
def test_mm_complex_bitwise(kind, bits):
    (ja, jb), (ta, tb) = _mm_case(kind, np.random.default_rng(7))
    want = ref_dd.mm(ja, jb, bits=bits)
    got = dd.mm(ta, tb, bits=bits)
    assert got.dtype == torch.complex128
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_mm_complex_nonfinite_rows_follow_the_reference():
    """A NaN or Inf operand entry poisons its result row (column) in both
    parts, as the reference's re + 1j·im gives; the rest stays
    bitwise."""
    rng = np.random.default_rng(8)
    a, b = _c(rng, 12, 9), _c(rng, 9, 10)
    a[3, 4] = np.nan
    a[5, 1] = complex(0.0, np.inf)
    b[2, 7] = complex(np.inf, 1.0)
    want = np.asarray(ref_dd.mm(jnp.asarray(a), jnp.asarray(b)))
    got = dd.mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for part in (np.real, np.imag):
        np.testing.assert_array_equal(np.isnan(part(want)),
                                      np.isnan(part(got)))
    ok = np.isfinite(want)
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(_bits(want[ok]), _bits(got[ok]))


@pytest.fixture(scope="module")
def tri():
    rng = np.random.default_rng(11)
    n = 40
    T = _c(rng, n, n) + n * np.eye(n)
    q = _c(rng, n, n)
    return rng, T, q @ q.conj().T + n * np.eye(n)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("unit", [False, True])
def test_trtri_f64_complex(tri, lower, unit):
    _, T, _ = tri
    T = T / T.shape[0] if unit else T
    assert _rel(ref_dd.trtri_f64(jnp.asarray(T), lower=lower, unit=unit),
                dd.trtri_f64(torch.from_numpy(T), lower=lower,
                             unit=unit)) <= 1e-13


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("lower", [True, False])
def test_trsm_f64_complex(tri, side, trans, lower):
    rng, T, _ = tri
    B = _c(rng, 40, 24) if side == "L" else _c(rng, 24, 40)
    kw = dict(side=side, lower=lower, trans=trans, alpha=0.7 - 0.2j)
    assert _rel(ref_dd.trsm_f64(jnp.asarray(T), jnp.asarray(B), **kw),
                dd.trsm_f64(torch.from_numpy(T), torch.from_numpy(B),
                            **kw)) <= 1e-13


def test_trsm_f64_real_triangle_complex_rhs(tri):
    """A real triangle with a complex right-hand side takes the complex
    branch (the real Newton inverse, one complex product)."""
    rng, T, _ = tri
    Tr = T.real.copy()
    B = _c(rng, 40, 8)
    assert _rel(ref_dd.trsm_f64(jnp.asarray(Tr), jnp.asarray(B)),
                dd.trsm_f64(torch.from_numpy(Tr),
                            torch.from_numpy(B))) <= 1e-13


@pytest.mark.parametrize("lower", [True, False])
def test_potrf_f64_complex(tri, lower):
    _, _, spd = tri
    got = dd.potrf_f64(torch.from_numpy(spd), lower=lower)
    assert _rel(ref_dd.potrf_f64(jnp.asarray(spd), lower=lower),
                got) <= 1e-13
    L = got.resolve_conj().numpy()
    rec = L @ L.conj().T if lower else L.conj().T @ L
    assert np.abs(rec - spd).max() <= 1e-13 * np.abs(spd).max()


def test_real_only_routes_still_refuse_complex():
    """lu_ir and the geqrt panels are real-f64 routes in the reference
    (its sweeps call them for float64 only): complex still raises."""
    z = torch.ones((32, 16), dtype=torch.complex128)
    with pytest.raises(NotImplementedError, match="real f64 only"):
        dd.lu_ir(z, torch.tril(z), torch.triu(z[:16]))
    for fn in (dd.geqrt_f64, dd.geqrt_f64_tree):
        with pytest.raises(NotImplementedError, match="real f64 only"):
            fn(z)


# ---------------------------------------------------------------------
# the z factorizations under dd_gemm=always
# ---------------------------------------------------------------------

def _pair(A):
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


def _under_dd(ref_fn, port_fn):
    with ref_cfg.override_scope(DD):
        want = ref_fn()
    with cfg.override_scope(DD):
        routed = pdd.ROUTED
        got = port_fn()
        routed = pdd.ROUTED - routed
    return want, got, routed


def test_zpotrf_dd_matches_reference():
    """The tile sweep (not the real-only blocked route): per tile one
    potrf_f64 (16 complex products), per panel one trsm_f64 (5), and
    2·KT − 3 update products, two limb products each: 46·KT − 16."""
    A, TA = _pair(ref_gen.plghe(float(N), N, NB, seed=3872,
                                dtype=jnp.complex128))
    want, got, routed = _under_dd(lambda: ref_potrf.potrf(A, "L"),
                                  lambda: port_potrf.potrf(TA, "L"))
    assert _rel(want.data, got.data) <= 1e-12
    assert routed == 46 * KT - 16


def test_zgetrf_dd_matches_reference():
    """The plain pivoted sweep: LAPACK panels, each of the 2·KT − 3 block
    applies a complex trsm_f64 (5 products) and one update product:
    12·(2·KT − 3) limb products."""
    A, TA = _pair(ref_gen.plrnt(N, N, NB, NB, seed=3872,
                                dtype=jnp.complex128))
    (want, perm), (got, gperm), routed = _under_dd(
        lambda: ref_lu.getrf_1d(A), lambda: lu.getrf_1d(TA))
    np.testing.assert_array_equal(gperm.numpy(), np.asarray(perm))
    assert _rel(want.data, got.data) <= 1e-12
    assert routed == 12 * (2 * KT - 3)


def test_zgeqrf_dd_matches_reference():
    """The Householder sweep on vendor panels, its products on the limb
    route: KT larft Grams and 3 per apply (KT − 1 lookahead applies and
    the far block's catch-up), two limb products each."""
    A, TA = _pair(ref_gen.plrnt(N, N, NB, NB, seed=3872,
                                dtype=jnp.complex128))
    (wf, wt), (gf, gt), routed = _under_dd(lambda: ref_qr.geqrf(A),
                                           lambda: qr.geqrf(TA))
    assert _rel(wf.data, gf.data) <= 1e-12
    assert _rel(wt.data, gt.data) <= 1e-12
    catch_up = sum(k % 4 + 1 for k in range(KT - 2))
    assert routed == 2 * (KT + 3 * (KT - 1 + catch_up))
