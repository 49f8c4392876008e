"""Port parity: ``ops.hqr``'s factorizations and appliers in c and z
against the reference, as ``hqr_parity`` says (the trees and the s / d
ops are in ``test_torch_hqr.py``): the factored matrix, Tts, Ttt, Q and
op(Q)·C within 1e-4 (c) and 1e-12 (z) of the reference's, at a square
and an odd size, side L/R × trans N/C/T."""
import pytest

import hqr_parity as hp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape", sorted(hp.SHAPES))
@pytest.mark.parametrize("prec", ["c", "z"])
def test_complex_geqrf_gelqf_param_and_q_match_the_reference(prec, shape):
    hp.check_factors(prec, shape)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("shape", sorted(hp.SHAPES))
@pytest.mark.parametrize("prec", ["c", "z"])
def test_complex_unmqr_unmlq_param_match_the_reference(prec, shape, side):
    hp.check_applies(prec, shape, side)
