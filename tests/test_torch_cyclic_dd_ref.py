"""Port parity: the dd route under the grid against the reference itself
under ``dd_gemm=always``.

The reference's block-cyclic ops raise under ``always`` on a mesh: its
``kernels.dd._pin_cat_axis`` pins a sharding inside the shard_map body,
where every array is rank-local (``Axes mentioned in 'vma' field ...
should be of type Manual``). That pin means nothing inside the body, so
these tests replace it with the identity through ``monkeypatch`` (in
this process only; restored after), and the reference's ops then run
their limb route. Its jit caches are not keyed on ``dd_gemm``, so
``jax.clear_caches()`` runs before and after each case, and each case
asserts that the reference's ``always`` result differs from its
``auto`` result, which proves that the limb route ran.

Gates: the port's ``always`` run within ``TOL`` = 1e-13 relative of the
reference's ``always`` run (max|Δ| / max|reference|), pivots bitwise.
``potrf_cyclic`` (L) and ``getrf_cyclic`` run in tier 1; the other 19
ops of the catalogue are marked ``slow``: the reference compiles each
one under ``always`` for ~40-60 s.
"""
import jax
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu.ops import gemm as ref_gemm
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu_torch.ops import gemm
from dplasma_tpu_torch.parallel import cyclic
from test_torch_cyclic_dd import MB, OPS, _arrays, _inputs, _port_tile, _tile
from torch_cyclic_pairs import GRID_2x2, grids, port, ref_cyclic_of, rel
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-13
ALWAYS = {"dd_gemm": "always"}
SLOW_OPS = sorted(set(OPS) - {"potrf_L", "getrf"})


def _operands(x):
    """The reference's operands of every op (and the port's, on the
    same slabs); the LU factor for getrs/laswp from the reference's
    native run."""
    R = {k: ref_cyclic_of(v, MB, GRID_2x2) for k, v in x.items()}
    R["F"], R["perm"] = ref_cyclic.getrf_cyclic(R["G"])
    R["Gt"] = _tile(x["G"])
    R["summa"] = ref_gemm.gemm_summa
    P = {k: port(v) for k, v in R.items()
         if isinstance(v, ref_cyclic.CyclicMatrix)}
    P["perm"] = torch.from_numpy(np.array(R["perm"]))
    P["Gt"] = _port_tile(R["Gt"])
    P["summa"] = gemm.gemm_ex
    return R, P


def _against_patched_reference(monkeypatch, op):
    x = _inputs()
    jax.clear_caches()
    try:
        with grids(GRID_2x2):
            R, P = _operands(x)
            auto = _arrays(OPS[op](ref_cyclic, R))
            monkeypatch.setattr(ref_dd, "_pin_cat_axis", lambda p: p)
            jax.clear_caches()
            with grids(GRID_2x2, ALWAYS):
                want = _arrays(OPS[op](ref_cyclic, R))
                got = _arrays(OPS[op](cyclic, P))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    assert len(got) == len(want) == len(auto)
    floats = [i for i, w in enumerate(want)
              if not (np.issubdtype(w.dtype, np.integer) or w.dtype == bool)]
    # the limb route ran in the reference: its always run is not its
    # native one (laswp has no product)
    if op != "laswp":
        assert any(not np.array_equal(want[i], auto[i]) for i in floats), op
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            worst = max(worst, rel(g, w))
    assert worst <= TOL, (op, worst)
    return worst


@pytest.mark.parametrize("op", ["potrf_L", "getrf"])
def test_cyclic_factor_under_dd_matches_the_patched_reference(
        devices8, monkeypatch, op):
    """potrf_cyclic (L) and getrf_cyclic under ``always`` in both
    packages, on the same slabs."""
    _against_patched_reference(monkeypatch, op)


@pytest.mark.slow
@pytest.mark.parametrize("op", SLOW_OPS)
def test_cyclic_op_under_dd_matches_the_patched_reference(
        devices8, monkeypatch, op):
    """The other 19 ops of the catalogue, the same way (slow: the
    reference compiles each under ``always``)."""
    worst = _against_patched_reference(monkeypatch, op)
    print(f"[patched-reference] {op}: max rel {worst:.3e}")
