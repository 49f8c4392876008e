"""Port parity: the Level-3 tile BLAS of ``ops.blas3`` beyond gemm/trsm —
symm, hemm, syrk, herk, syr2k, her2k and trmm in every side / uplo /
trans / diag case — against the JAX package, on the same padded inputs
(M=100, N=70, K=60, nb=32: edge tiles everywhere).

Tolerance: max|Δ|/max|result| <= 1e-5 in f32 and 1e-13 in f64 (one or
two products each, summed in a different order by XLA and by torch).
The symmetric inputs carry garbage in the triangle the op does not
name, so reading it would show. For real dtypes hemm/herk/her2k give
what symm/syrk/syr2k give, in both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import blas3 as ref_blas3
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import blas3
from torch_threads import one_torch_thread  # noqa: F401

M, N, K, NB = 100, 70, 60, 32
TOL = {"s": 1e-5, "d": 1e-13}
JDT = {"s": jnp.float32, "d": jnp.float64}
PRECS = ["s", "d"]


def _port(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _gen(m, n, prec, seed):
    A = ref_gen.plrnt(m, n, NB, NB, seed=seed, dtype=JDT[prec])
    return A, _port(A)


def _sym(n, prec, seed, uplo):
    """A symmetric matrix whose other triangle holds garbage."""
    A = ref_gen.plghe(float(n), n, NB, seed=seed, dtype=JDT[prec])
    x = A.data
    junk = jnp.full_like(x, 1e6)
    x = x + (jnp.triu(junk, 1) if uplo == "L" else jnp.tril(junk, -1))
    A = A.like(x)
    return A, _port(A)


def _close(want, got, prec):
    want = np.asarray(want.data, np.float64)
    got = got.data.numpy().astype(np.float64)
    assert want.shape == got.shape and np.isfinite(got).all()
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= TOL[prec], err


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("op", ["symm", "hemm"])
def test_symm_hemm(prec, side, uplo, op):
    n = M if side == "L" else N
    A, TA = _sym(n, prec, 1, uplo)
    B, TB = _gen(M, N, prec, 2)
    C, TC = _gen(M, N, prec, 3)
    want = getattr(ref_blas3, op)(0.7, A, B, 0.3, C, side=side, uplo=uplo)
    got = getattr(blas3, op)(0.7, TA, TB, 0.3, TC, side=side, uplo=uplo)
    assert got.desc == TC.desc
    _close(want, got, prec)


def _rank_k_inputs(prec, uplo, trans, rank2):
    shape = (N, K) if trans == "N" else (K, N)
    A, TA = _gen(*shape, prec, 4)
    C, TC = _sym(N, prec, 5, uplo)
    if rank2:
        B, TB = _gen(*shape, prec, 6)
        return (A, B, C), (TA, TB, TC)
    return (A, C), (TA, TC)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("op,trans", [("syrk", "N"), ("syrk", "T"),
                                      ("herk", "N"), ("herk", "C"),
                                      ("syr2k", "N"), ("syr2k", "T"),
                                      ("her2k", "N"), ("her2k", "C")])
def test_rank_k_updates(prec, uplo, op, trans):
    """Only the ``uplo`` triangle of C is written: the other keeps C's
    garbage, in both packages."""
    rank2 = op.endswith("2k")
    ref_args, args = _rank_k_inputs(prec, uplo, trans, rank2)
    c_before = args[-1].data.clone()
    want = getattr(ref_blas3, op)(0.7, *ref_args[:-1], 0.3, ref_args[-1],
                                  uplo=uplo, trans=trans)
    got = getattr(blas3, op)(0.7, *args[:-1], 0.3, args[-1], uplo=uplo,
                             trans=trans)
    _close(want, got, prec)
    # a new matrix: C itself is untouched
    assert torch.equal(args[-1].data, c_before)


def test_her2k_alpha_as_tensor_and_float():
    """conj(alpha) of a real Python float and of a 0-d tensor."""
    (A, B, C), (TA, TB, TC) = _rank_k_inputs("d", "L", "N", True)
    want = ref_blas3.her2k(0.7, A, B, 0.3, C)
    for alpha in (0.7, torch.tensor(0.7, dtype=torch.float64)):
        _close(want, blas3.her2k(alpha, TA, TB, 0.3, TC), "d")


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trmm(prec, side, uplo, trans, diag):
    n = M if side == "L" else N
    A, TA = _sym(n, prec, 7, uplo)
    B, TB = _gen(M, N, prec, 8)
    want = ref_blas3.trmm(0.7, A, B, side=side, uplo=uplo, trans=trans,
                          diag=diag)
    got = blas3.trmm(0.7, TA, TB, side=side, uplo=uplo, trans=trans,
                     diag=diag)
    assert got.desc == TB.desc
    _close(want, got, prec)


@pytest.mark.parametrize("op,bad", [("syrk", "C"), ("herk", "T"),
                                    ("syr2k", "C"), ("her2k", "T"),
                                    ("syrk", "X")])
def test_bad_trans_raises_as_the_reference(op, bad):
    ref_args, args = _rank_k_inputs("s", "L", "N", op.endswith("2k"))
    with pytest.raises(ValueError, match="trans must be"):
        getattr(ref_blas3, op)(1.0, *ref_args[:-1], 0.0, ref_args[-1],
                               trans=bad)
    with pytest.raises(ValueError, match="trans must be"):
        getattr(blas3, op)(1.0, *args[:-1], 0.0, args[-1], trans=bad)


def test_trmm_bad_trans_raises():
    _, TA = _sym(M, "s", 7, "L")
    _, TB = _gen(M, N, "s", 8)
    with pytest.raises(ValueError, match="bad trans"):
        blas3.trmm(1.0, TA, TB, trans="X")


@pytest.mark.parametrize("op,want", [("syrk", 1), ("syr2k", 2),
                                     ("symm", 1), ("trmm", 1)])
def test_k1_routes_on_cpu_tensors(op, want):
    """With K1 on, each op's products take the K1 route at the
    reference's k.dot sites (syrk's two views of one buffer, one
    transposed, included); on the CPU none is a launch."""
    _, TA = _gen(512, 512, "s", 9)
    _, TB = _gen(512, 512, "s", 10)
    _, TC = _gen(512, 512, "s", 11)
    call = {"syrk": lambda: blas3.syrk(1.0, TA, 0.5, TC),
            "syr2k": lambda: blas3.syr2k(1.0, TA, TB, 0.5, TC),
            "symm": lambda: blas3.symm(1.0, TA, TB, 0.5, TC),
            "trmm": lambda: blas3.trmm(1.0, TA, TB)}[op]
    plain = call()
    pk.enable(True)
    try:
        routed, launches = pk.ROUTED, pk.LAUNCHES
        got = call()
        assert pk.ROUTED - routed == want and pk.LAUNCHES == launches
    finally:
        pk.enable(False)
    assert torch.allclose(got.data, plain.data, rtol=1e-5, atol=1e-4)
