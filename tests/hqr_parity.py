"""Shared parity checks of ``ops.hqr``'s factorizations and appliers
against the reference, for ``test_torch_hqr.py`` (s, d and the dd
route) and ``test_torch_hqr_complex.py`` (c, z).

The same padded inputs go through both packages (the reference eagerly
on the CPU with x64): the factored matrix, ``Tts``, ``Ttt``, Q from
``ungqr_param`` / ``unglq_param`` and op(Q)·C from ``unmqr_param`` /
``unmlq_param`` (side L/R × trans N/C/T) agree within max|Δ| <=
TOL·max|reference|, TOL = 1e-4 for s/c and 1e-12 for d/z (the tile QRs
and products round in each package's own order). Sizes: a square
5·nb = 40 with nb = 8, and M = 37, N = 29 with nb = 8 for the edge
tiles. The tree is binary/greedy with a = 2, p = 2, so TS and TT
couples both occur. The reference's results are computed once per
(precision, shape) and shared, so its eager ops compile once.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import hqr as ref_hqr
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import hqr

DT = {"s": jnp.float32, "d": jnp.float64, "c": jnp.complex64,
      "z": jnp.complex128}
TOL = {"s": 1e-4, "c": 1e-4, "d": 1e-12, "z": 1e-12}
SHAPES = {"square": (40, 40, 8), "odd": (37, 29, 8)}


def port_tree(tree):
    """The port's tree built with a reference tree's parameters."""
    return hqr.QRTree(**{f.name: getattr(tree, f.name)
                         for f in dataclasses.fields(tree)})


def tree(MT):
    return ref_hqr.hqr_tree(MT, llvl="binary", hlvl="greedy", a=2, p=2)


def port_tile(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


@functools.lru_cache(maxsize=None)
def reference(prec, shape):
    """The reference's factorizations and applies at one (precision,
    shape), as numpy arrays, with the inputs."""
    M, N, nb = SHAPES[shape]
    dt = DT[prec]
    A = ref_gen.plrnt(M, N, nb, nb, seed=7, dtype=dt)
    C = {"L": ref_gen.plrnt(M, 11, nb, nb, seed=9, dtype=dt),
         "R": ref_gen.plrnt(11, M, nb, nb, seed=10, dtype=dt)}
    D = {"L": ref_gen.plrnt(N, 11, nb, nb, seed=9, dtype=dt),
         "R": ref_gen.plrnt(11, N, nb, nb, seed=10, dtype=dt)}
    tq, tl = tree(A.desc.MT), tree(A.desc.NT)
    F = ref_hqr.geqrf_param(tq, A)
    G = ref_hqr.gelqf_param(tl, A)
    out = {"A": A, "C": C, "D": D,
           "qr": [np.asarray(x.data) for x in F],
           "Q": np.asarray(ref_hqr.ungqr_param(tq, *F).data),
           "lq": [np.asarray(x.data) for x in G],
           "Ql": np.asarray(ref_hqr.unglq_param(tl, *G).data)}
    for side in "LR":
        for trans in "NCT":
            out["unmqr", side, trans] = np.asarray(ref_hqr.unmqr_param(
                tq, side, trans, *F, C[side]).data)
            out["unmlq", side, trans] = np.asarray(ref_hqr.unmlq_param(
                tl, side, trans, *G, D[side]).data)
    return out


def close(want, got, prec):
    got = got.resolve_conj().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(want - got).max()
    assert err <= TOL[prec] * np.abs(want).max(), err


def trees_of(A):
    return port_tree(tree(A.desc.MT)), port_tree(tree(A.desc.NT))


@functools.lru_cache(maxsize=None)
def port_factors(prec, shape):
    A = port_tile(reference(prec, shape)["A"])
    tq, tl = trees_of(A)
    return hqr.geqrf_param(tq, A), hqr.gelqf_param(tl, A)


def check_factors(prec, shape):
    """The factored matrix, Tts and Ttt of both factorizations, and the
    explicit Q of each."""
    ref = reference(prec, shape)
    F, G = port_factors(prec, shape)
    for want, got in zip(ref["qr"] + ref["lq"], F + G):
        close(want, got.data, prec)
    tq, tl = trees_of(port_tile(ref["A"]))
    close(ref["Q"], hqr.ungqr_param(tq, *F).data, prec)
    close(ref["Ql"], hqr.unglq_param(tl, *G).data, prec)


def check_applies(prec, shape, side):
    """op(Q)·C (side L) and C·op(Q) (side R) for trans N, C and T (T
    folds into C), from the QR and from the LQ."""
    ref = reference(prec, shape)
    F, G = port_factors(prec, shape)
    tq, tl = trees_of(port_tile(ref["A"]))
    for trans in "NCT":
        close(ref["unmqr", side, trans],
              hqr.unmqr_param(tq, side, trans, *F,
                              port_tile(ref["C"][side])).data, prec)
        close(ref["unmlq", side, trans],
              hqr.unmlq_param(tl, side, trans, *G,
                              port_tile(ref["D"][side])).data, prec)
