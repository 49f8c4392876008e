"""Port parity: ``ops.refine.gels_ir`` (least squares by a low-precision
QR and semi-normal-equation refinement on R) against the reference's, on
the very same inputs, for every working precision; the tolerance and
flags as in ``test_torch_refine.py``. On a plain random 128×64 matrix
the int8 rung's semi-normal equations do not contract (κ squared) and
both packages escalate to the full-precision ``gels``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import refine as ref_refine
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.ops import checks, refine
from torch_threads import one_torch_thread  # noqa: F401

XTOL = 1e-11
M, N, NB = 128, 64, 32


def _pair(m, n, seed):
    A = ref_gen.plrnt(m, n, NB, NB, seed=seed, dtype=jnp.float64)
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


@pytest.mark.parametrize("prec", refine.PRECISIONS)
def test_gels_ir_matches_reference(prec):
    RA, A = _pair(M, N, 8)
    RB, B = _pair(M, 2, 9)
    want_x, want_i = ref_refine.gels_ir(RA, RB, precision=prec)
    got_x, got_i = refine.gels_ir(A, B, precision=prec)
    w = np.asarray(want_x.to_dense())
    g = got_x.to_dense().numpy()
    assert g.shape == w.shape == (N, 2)
    assert np.abs(w - g).max() <= XTOL * np.abs(w).max()
    for key in ("converged", "escalated"):
        assert bool(got_i[key]) == bool(want_i[key]), key
    assert abs(int(got_i["iterations"]) - int(want_i["iterations"])) <= 1
    if prec != "int8":
        assert bool(got_i["converged"]) and not bool(got_i["escalated"])
    else:
        assert float(got_i["quant_guard_max"]) > 0
    r, ok = checks.check_gels(A, B, got_x.to_dense())
    assert ok, r
