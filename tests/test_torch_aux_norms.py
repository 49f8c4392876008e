"""Port parity: the aux ops (``ops.aux``: lacpy, laset, geadd, tradd,
lascal, ger) and the norms (``ops.norms``: lange, lanhe, lansy, lantr,
lanm2) against the JAX package, on the same padded inputs (M=100, N=70,
nb=32: edge tiles).

Tolerances: the aux ops are one or two elementwise operations per entry
in the same order in both packages: bitwise in f32 and f64. The norms
are reductions summed in different orders: 1e-6 relative in f32 and
1e-14 in f64 (the max norm is exact). lanm2 runs the same 20 power
iterations: 1e-5 / 1e-12 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import aux as ref_aux
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import norms as ref_norms
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import aux, norms
from torch_threads import one_torch_thread  # noqa: F401

M, N, NB = 100, 70, 32
JDT = {"s": jnp.float32, "d": jnp.float64}
NORM_TOL = {"s": 1e-6, "d": 1e-14}
PRECS = ["s", "d"]


def _port(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _gen(m, n, prec, seed=1, kind="rnt"):
    if kind == "he":
        A = ref_gen.plghe(float(n), n, NB, seed=seed, dtype=JDT[prec])
    else:
        A = ref_gen.plrnt(m, n, NB, NB, seed=seed, dtype=JDT[prec])
    return A, _port(A)


def _same(want, got):
    assert dataclasses.asdict(want.desc) == got.desc.to_dict()
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo", ["A", "L", "U"])
def test_lacpy_laset_lascal(prec, uplo):
    A, T = _gen(M, N, prec)
    before = T.data.clone()
    _same(ref_aux.lacpy(A, uplo), aux.lacpy(T, uplo))
    _same(ref_aux.laset(A, 0.25, -2.0, uplo), aux.laset(T, 0.25, -2.0, uplo))
    _same(ref_aux.lascal(A, 0.7, uplo), aux.lascal(T, 0.7, uplo))
    assert torch.equal(T.data, before)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("trans", ["N", "T"])
def test_geadd(prec, trans):
    A, T = _gen(M, N, prec) if trans == "N" else _gen(N, M, prec)
    B, U = _gen(M, N, prec, 2)
    before = U.data.clone()
    _same(ref_aux.geadd(A, B, 0.7, 0.3, trans), aux.geadd(T, U, 0.7, 0.3,
                                                         trans))
    assert torch.equal(U.data, before)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
def test_tradd(prec, uplo, trans):
    A, T = _gen(M, N, prec) if trans == "N" else _gen(N, M, prec)
    B, U = _gen(M, N, prec, 2)
    _same(ref_aux.tradd(A, B, 0.7, 0.3, uplo, trans),
          aux.tradd(T, U, 0.7, 0.3, uplo, trans))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("conj_y", [True, False])
def test_ger(prec, conj_y):
    A, T = _gen(M, N, prec)
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(M), rng.standard_normal(N)
    _same(ref_aux.ger(0.5, x, y, A, conj_y),
          aux.ger(0.5, x, y, T, conj_y))


def _norm_close(want, got, prec, tol=None):
    want = float(want)
    assert abs(float(got) - want) <= (tol or NORM_TOL[prec]) * abs(want)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("norm", ["M", "1", "I", "F"])
def test_lange_lanhe_lansy(prec, norm):
    A, T = _gen(M, N, prec)
    _norm_close(ref_norms.lange(A, norm), norms.lange(T, norm), prec)
    S, TS = _gen(M, M, prec, kind="he")
    # the stored triangle only: garbage in the other one must not count
    for uplo in ("L", "U"):
        junk = 1e3 * (torch.triu(torch.ones_like(TS.data), 1) if uplo == "L"
                      else torch.tril(torch.ones_like(TS.data), -1))
        S2 = S.like(S.data + jnp.asarray(junk.numpy()))
        T2 = TS.like(TS.data + junk)
        _norm_close(ref_norms.lanhe(S2, norm, uplo),
                    norms.lanhe(T2, norm, uplo), prec)
        _norm_close(ref_norms.lansy(S2, norm, uplo),
                    norms.lansy(T2, norm, uplo), prec)
        _norm_close(ref_norms.lansy(S, norm), norms.lanhe(TS, norm), prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("norm", ["M", "1", "I", "F"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_lantr(prec, norm, uplo, diag):
    A, T = _gen(M, N, prec)
    _norm_close(ref_norms.lantr(A, norm, uplo, diag),
                norms.lantr(T, norm, uplo, diag), prec)


def test_bad_norm_raises():
    _, T = _gen(M, N, "s")
    with pytest.raises(ValueError, match="unknown norm"):
        norms.lantr(T, "X")


@pytest.mark.parametrize("prec,tol", [("s", 1e-5), ("d", 1e-12)])
@pytest.mark.parametrize("shape", [(M, N), (N, M)])
def test_lanm2(prec, tol, shape):
    """The same estimate as the reference's, so the same distance to
    the SVD's 2-norm (which 20 iterations need not close: 1.7% on the
    70×100 matrix, in both packages)."""
    A, T = _gen(*shape, prec)
    got = norms.lanm2(T)
    _norm_close(ref_norms.lanm2(A), got, prec, tol)
    assert float(got) <= float(torch.linalg.matrix_norm(
        T.to_dense().double(), ord=2)) * (1 + tol)
