"""Port parity: the Cholesky inverse family (``ops.potrf`` trtri, lauum,
potri, poinv) and ``checks.check_inverse`` against the JAX package, on
the very same padded inputs (N=100, nb=32: an edge tile and a padded
diagonal), on the native route and under MCA ``dd_gemm=always``.

Tolerances, max|Δ|/max|result| over the padded storage: 1e-5 in f32
and 1e-12 in f64 — the two packages run the same recursion and products
with different BLAS/LAPACK, so they differ by rounding only (the inputs
are well conditioned: the plghe triangles have an N-sized diagonal, and
the unit-diagonal cases scale the off-diagonal part by 1/N). On the dd
route both refine f32 seeds on exact limb products: 1e-12. The
check_inverse residuals agree with the reference's within a factor of 2
(they are ratios of rounding errors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import checks as ref_checks
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import checks, generators
from dplasma_tpu_torch.ops import potrf as port_potrf
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

N, NB = 100, 32
TOL = {"s": 1e-5, "d": 1e-12}
JDT = {"s": jnp.float32, "d": jnp.float64}
UPLO_DIAG = [("L", "N"), ("L", "U"), ("U", "N"), ("U", "U")]

# one traced program per static argument set, shared by the cases of a
# shape (the native and the dd route trace separately: the MCA is read
# at trace time)
_jit = {name: jax.jit(getattr(ref_potrf, name), static_argnums=(1,))
        for name in ("lauum", "potri", "poinv", "potrf")}
_jit_dd = {name: jax.jit(getattr(ref_potrf, name), static_argnums=(1,))
           for name in ("lauum", "potri", "poinv", "potrf")}
_trtri = jax.jit(ref_potrf.trtri, static_argnums=(1, 2))
_trtri_dd = jax.jit(ref_potrf.trtri, static_argnums=(1, 2))


def _pair(A):
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


def _input(prec, unit=False):
    """The plghe matrix (its triangles are well-conditioned triangular
    matrices); for a unit diagonal its off-diagonal part over N."""
    A = ref_gen.plghe(float(N), N, NB, seed=3872, dtype=JDT[prec])
    if unit:
        A = A.like(A.data / N)
    return _pair(A)


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.numpy().astype(np.float64)
    assert np.isfinite(got).all()
    return np.abs(want - got).max() / np.abs(want).max()


@pytest.fixture
def dd_always():
    ref_cfg.mca_set("dd_gemm", "always")
    try:
        with cfg.override_scope({"dd_gemm": "always"}):
            yield
    finally:
        ref_cfg.mca_unset("dd_gemm")


@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("uplo,diag", UPLO_DIAG)
def test_trtri_matches_reference(prec, uplo, diag):
    A, T = _input(prec, unit=diag == "U")
    want = _trtri(A, uplo, diag)
    got = port_potrf.trtri(T, uplo, diag)
    assert got.desc == T.desc and got.dtype == T.dtype
    assert _rel(want.data, got.data) <= TOL[prec]
    # the opposite triangle is zero, the padded diagonal the identity's
    opp = torch.triu(got.data, 1) if uplo == "L" else torch.tril(got.data,
                                                                 -1)
    assert not opp.any()
    assert torch.all(got.data.diagonal()[N:] == 1)


@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_lauum_matches_reference(prec, uplo):
    A, T = _input(prec)
    want = _jit["lauum"](A, uplo)
    got = port_potrf.lauum(T, uplo)
    assert got.desc == T.desc
    assert _rel(want.data, got.data) <= TOL[prec]
    # the opposite triangle keeps the input's
    x = T.to_dense()
    opp = (lambda t: torch.triu(t, 1)) if uplo == "L" else \
        (lambda t: torch.tril(t, -1))
    assert torch.equal(opp(got.to_dense()), opp(x))


@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("op", ["potri", "poinv"])
def test_potri_poinv_match_reference(prec, uplo, op):
    A, T = _input(prec)
    if op == "potri":
        A = _jit["potrf"](A, uplo)
        T = TileMatrix.from_reference(np.asarray(A.data),
                                      dataclasses.asdict(A.desc),
                                      device="cpu")
    want = _jit[op](A, uplo)
    got = getattr(port_potrf, op)(T, uplo)
    assert _rel(want.data, got.data) <= TOL[prec]


@pytest.mark.parametrize("prec", ["s", "d"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_check_inverse_matches_reference(prec, uplo):
    A0, T0 = _input(prec)
    want = _jit["poinv"](A0, uplo)
    got = port_potrf.poinv(T0, uplo)
    r_ref, ok_ref = ref_checks.check_inverse(A0, want, uplo=uplo)
    r, ok = checks.check_inverse(T0, got, uplo=uplo)
    assert ok and ok_ref
    assert r_ref / 2 <= r <= 2 * r_ref
    # without uplo the full storage is taken as it is: a lower-only
    # inverse of a full symmetric matrix fails
    r_full, ok_full = checks.check_inverse(T0, got)
    r_full_ref, _ = ref_checks.check_inverse(A0, want)
    assert not ok_full and r_full == pytest.approx(r_full_ref, rel=1e-3)


def test_check_gemm_matches_reference():
    A, T = _input("d")
    B, U = _pair(A.like(A.data * (1 + 1e-14)))
    r_ref, ok_ref = ref_checks.check_gemm(A, B)
    r, ok = checks.check_gemm(T, U)
    assert ok == ok_ref and r == pytest.approx(r_ref, rel=1e-12)
    assert not checks.check_gemm(T, U.like(U.data * 2))[1]


@pytest.mark.parametrize("uplo,diag", UPLO_DIAG)
def test_dd_trtri_matches_reference(dd_always, uplo, diag):
    """The recursion's products go to dd.mm and its leaves to
    dd.trtri_f64 in both packages; 2·(KT − 1) + 4·KT = 22 limb products
    at KT = 4 (two Newton steps of two products per leaf)."""
    A, T = _input("d", unit=diag == "U")
    want = _trtri_dd(A, uplo, diag)
    routed = pdd.ROUTED
    got = port_potrf.trtri(T, uplo, diag)
    assert pdd.ROUTED - routed == 2 * 3 + 4 * 4
    assert _rel(want.data, got.data) <= TOL["d"]


@pytest.mark.parametrize("op", ["lauum", "potri", "poinv"])
def test_dd_inverse_family_matches_reference(dd_always, op):
    A, T = _input("d")
    if op == "potri":
        A = _jit_dd["potrf"](A, "L")
        T = TileMatrix.from_reference(np.asarray(A.data),
                                      dataclasses.asdict(A.desc),
                                      device="cpu")
    want = _jit_dd[op](A, "L")
    routed = pdd.ROUTED
    got = getattr(port_potrf, op)(T, "L")
    # lauum 1; potri 22 + 1; poinv adds potrf's 5·KT − 3 = 17
    assert pdd.ROUTED - routed == {"lauum": 1, "potri": 23,
                                   "poinv": 40}[op]
    assert _rel(want.data, got.data) <= TOL["d"]


def test_inverse_family_routes_k1_on_cpu_tensors():
    """With K1 on, trtri at N=1024, nb=256 (KT = 4) sends 2·(KT − 1) = 6
    products to the K1 route and lauum 1, the reference's k.dot sites;
    on the CPU none is a launch, and the result is the plain route's."""
    A = generators.plghe(1024.0, 1024, 256, seed=1, device="cpu")
    plain_t = port_potrf.trtri(A, "L")
    plain_l = port_potrf.lauum(plain_t, "L")
    pk.enable(True)
    try:
        routed, launches = pk.ROUTED, pk.LAUNCHES
        t = port_potrf.trtri(A, "L")
        assert pk.ROUTED - routed == 6
        l_ = port_potrf.lauum(t, "L")
        assert pk.ROUTED - routed == 7
        assert pk.LAUNCHES == launches
    finally:
        pk.enable(False)
    # on the CPU the K1 route is gemm_reference: f32 accumulation
    assert _rel(plain_t.data.numpy(), t.data) <= 1e-6
    assert _rel(plain_l.data.numpy(), l_.data) <= 1e-6


def test_trtri_split_is_on_tile_boundaries(monkeypatch):
    """The recursion splits on multiples of nb: at KT = 5 (N=150, nb=32)
    every leaf is one 32-wide tile."""
    seen = []
    orig = port_potrf.k.trtri

    def spy(x, **kw):
        seen.append(tuple(x.shape))
        return orig(x, **kw)

    monkeypatch.setattr(port_potrf.k, "trtri", spy)
    A = generators.plghe(150.0, 150, 32, seed=2, device="cpu")
    port_potrf.trtri(A, "U")
    assert seen == [(32, 32)] * 5
