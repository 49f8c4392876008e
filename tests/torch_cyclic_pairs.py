"""Shared set-up of the port's block-cyclic parity tests: both packages'
meshes active at once, the reference's slabs handed to the port, and
the relative distance the tolerances are stated in.

The inputs are numpy arrays made from a seed; the reference converts
them to its slabs under its mesh on the conftest's 8 virtual CPU
devices, and the port starts from those very slabs
(``CyclicMatrix.from_reference``), so both run the op on the same local
storage.
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np

from dplasma_tpu.descriptors import Dist as RDist
from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.parallel import cyclic as ref_cyclic
from dplasma_tpu.parallel import mesh as ref_mesh
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.parallel import cyclic, mesh
from dplasma_tpu_torch.utils import config as cfg

# the reference tests' grids (tests/test_cyclic.py:280-633), and grids
# with one rank along an axis
GRID_2x2 = dict(P=2, Q=2)
GRID_2x4_K2 = dict(P=2, Q=4, kp=2, kq=2)
GRID_1x3 = dict(P=1, Q=3)
GRID_3x1 = dict(P=3, Q=1, ip=1)
DISTS = [GRID_2x2, GRID_2x4_K2, GRID_3x1]


@contextlib.contextmanager
def grids(dist, mca=None):
    """The reference's mesh over the virtual devices and the port's
    virtual mesh on the CPU, both active (and ``mca`` set in both)."""
    kv = mca or {}
    with ref_mesh.use_grid(ref_mesh.make_mesh(dist["P"], dist["Q"])), \
            mesh.use_grid(mesh.make_mesh(dist["P"], dist["Q"], "cpu")), \
            cfg.override_scope(kv), ref_cfg.override_scope(kv):
        yield


def rand(rng, shape, cplx=False):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if cplx else x


def ref_cyclic_of(a, mb, dist):
    """The reference CyclicMatrix of the dense numpy array ``a`` (square
    mb tiles) under the active reference mesh."""
    d = RDist(**dist)
    return ref_cyclic.CyclicMatrix.from_tile(
        RTile.from_dense(jnp.asarray(a), mb, mb, d), d)


def port(C):
    """The port's CyclicMatrix on the reference's very slabs."""
    return cyclic.CyclicMatrix.from_reference(
        np.asarray(C.data), dataclasses.asdict(C.desc), device="cpu")


def slabs(C):
    return C.to_reference()[0]


def rel(got, want) -> float:
    """max|got - want| / max|want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-300))
