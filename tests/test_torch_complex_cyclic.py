"""Port parity in c and z on the virtual mesh: ``potrf_cyclic`` (lower)
and ``getrf_cyclic`` on a 2×2 grid against the reference's shard_map
programs on the conftest's virtual CPU devices, the reference's slabs
handed across with ``CyclicMatrix.from_reference``.

The ring gate refuses complex in both packages, so both take the
masked-psum route, and ``ring.enable=on`` changes nothing. Gates: the
permutation bitwise; factors within 1e-5 (c) and 1e-12 (z) of
max|factor| (the two packages sum the same products in another order).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import Dist as RDist
from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu.parallel import mesh as ref_mesh
from dplasma_tpu_torch.kernels import pallas_ring as pring
from dplasma_tpu_torch.parallel import cyclic, mesh
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DIST = dict(P=2, Q=2)
TOL = {"c": 1e-5, "z": 1e-12}
JDT = {"c": jnp.complex64, "z": jnp.complex128}
TDT = {"c": torch.complex64, "z": torch.complex128}


@contextlib.contextmanager
def _grids():
    m = ref_mesh.make_mesh(DIST["P"], DIST["Q"])
    with ref_mesh.use_grid(m), \
            mesh.use_grid(mesh.make_mesh(DIST["P"], DIST["Q"], "cpu")):
        yield


def _port_slabs(C):
    import dataclasses
    return cyclic.CyclicMatrix.from_reference(
        np.asarray(C.data), dataclasses.asdict(C.desc), device="cpu")


def _rel(want, got):
    want = np.asarray(want)
    assert want.shape == got.shape and np.isfinite(got).all()
    return np.abs(want - got).max() / np.abs(want).max()


@pytest.mark.parametrize("prec", ["c", "z"])
def test_potrf_cyclic_complex_matches_reference(devices8, prec):
    mt, mb = 5, 8
    n = mt * mb
    A = ref_gen.plghe(float(n), n, mb, seed=3872, dtype=JDT[prec])
    A = RTile(A.data, A.desc.with_shape(n, n))
    with _grids():
        C = ref_cyclic.CyclicMatrix.from_tile(A, RDist(**DIST))
        want = ref_cyclic.potrf_cyclic(C, "L")
        got = cyclic.potrf_cyclic(_port_slabs(C), "L")
        with cfg.override_scope({"ring.enable": "on"}):
            routed = pring.ROUTED
            ring = cyclic.potrf_cyclic(_port_slabs(C), "L")
            assert pring.ROUTED == routed
    got_np = got.to_reference()[0]
    assert _rel(want.data, got_np) <= TOL[prec]
    np.testing.assert_array_equal(ring.to_reference()[0], got_np)
    full = got.to_tile().to_dense()
    L = torch.tril(full)
    a = torch.from_numpy(np.asarray(A.to_dense()))
    assert (L @ L.mH - a).abs().max() <= 100 * TOL[prec] * a.abs().max()


@pytest.mark.parametrize("prec", ["c", "z"])
def test_getrf_cyclic_complex_matches_reference(devices8, prec):
    mt, mb = 5, 8
    n = mt * mb - 3
    A = ref_gen.plrnt(n, n, mb, mb, seed=3872, dtype=JDT[prec])
    base = RTile(A.pad_diag().data, A.desc)
    with _grids():
        C = ref_cyclic.CyclicMatrix.from_tile(base, RDist(**DIST))
        F, perm = ref_cyclic.getrf_cyclic(C)
        Fp, permp = cyclic.getrf_cyclic(_port_slabs(C))
        full = Fp.to_tile().data[permp]
    np.testing.assert_array_equal(permp.numpy(), np.asarray(perm))
    assert _rel(F.data, Fp.to_reference()[0]) <= TOL[prec]
    assert full.dtype == TDT[prec]
    assert not pring.ring_active(2, TDT[prec], None, "q")
