"""Port parity: ``spmd_comm_model``, the analytic wire-byte model of the
block-cyclic programs, against the JAX package's: the same dict, key for
key and value for value (exact: both are the same arithmetic on Python
numbers), for each of the six ops with the K5 ring off and on, on
square, supertiled and one-axis grids, and ``KeyError`` for an op it
does not price.
"""
import dataclasses

import pytest

from dplasma_tpu.descriptors import Dist as RDist
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu_torch.parallel import cyclic
from torch_threads import one_torch_thread  # noqa: F401

OPS = ["potrf", "getrf", "geqrf", "gemm", "herbt", "ge2gb"]
DISTS = [dict(P=2, Q=2), dict(P=2, Q=4, kp=2, kq=2), dict(P=3, Q=1, ip=1)]


def _descs(dist, M=8192, N=8192, mb=512):
    rd = ref_cyclic.CyclicDesc(M, N, mb, mb, RDist(**dist))
    pd = cyclic.CyclicDesc.from_dict(dataclasses.asdict(rd))
    return rd, pd


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dist", DISTS, ids=str)
def test_comm_model_equals_reference(dist, op, ring):
    rd, pd = _descs(dist)
    want = ref_cyclic.spmd_comm_model(rd, op, 4, ring=ring)
    got = cyclic.spmd_comm_model(pd, op, 4, ring=ring)
    assert got == want
    assert list(got["bytes_by_collective"]) == \
        list(want["bytes_by_collective"])


@pytest.mark.parametrize("itemsize", [2, 8, 16])
def test_comm_model_gemm_kt_and_ragged_shapes(itemsize):
    """``kt`` carries SUMMA's contraction tile count; a ragged, tall
    matrix over a supertiled grid prices the ceil-uniform slabs."""
    rd, pd = _descs(dict(P=2, Q=4, kp=2, kq=3, ip=1, jq=2), M=9000,
                    N=5000, mb=256)
    for op, kt in (("gemm", 7), ("gemm", None), ("getrf", None)):
        assert cyclic.spmd_comm_model(pd, op, itemsize, kt=kt) == \
            ref_cyclic.spmd_comm_model(rd, op, itemsize, kt=kt)


def test_comm_model_one_by_one_grid_prices_zero():
    _, pd = _descs(dict(P=1, Q=1))
    for op in OPS:
        assert cyclic.spmd_comm_model(pd, op, 4, ring=True)[
            "bytes_total"] == 0.0


def test_comm_model_size_one_axis_keeps_its_psum_class():
    """On a P×1 grid the ring flag leaves the 'q' panel broadcast a
    psum entry (priced zero), as the kernels fall back per axis."""
    _, pd = _descs(dict(P=4, Q=1))
    by = cyclic.spmd_comm_model(pd, "getrf", 4, ring=True)[
        "bytes_by_collective"]
    assert by["panel_bcast_psum_q"] == 0.0
    assert "pivot_row_ring_shift_p" in by


def test_comm_model_unknown_op_raises_key_error():
    _, pd = _descs(dict(P=2, Q=2))
    with pytest.raises(KeyError, match="trsm"):
        cyclic.spmd_comm_model(pd, "trsm", 4)
    with pytest.raises(KeyError):
        ref_cyclic.spmd_comm_model(_descs(dict(P=2, Q=2))[0], "trsm", 4)
