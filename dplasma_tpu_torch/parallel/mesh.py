"""The P×Q process grid and the active-grid context.

Ports ``dplasma_tpu/parallel/mesh.py`` (:1-104). The reference's grid is
a ``jax.sharding.Mesh`` with axes ``('p', 'q')``, one device per rank.
The port's :class:`Mesh` is a **single-controller virtual mesh**: one
process drives P×Q ranks, and every rank's slab lives on the mesh's one
``torch.device`` (the card, or the CPU in the tests). The block-cyclic
factorizations (``parallel/cyclic.py``) step the ranks in lockstep and
run their collectives between phases; the ring transfers (kernel K5,
``kernels/pallas_ring.py``) move blocks between the ranks' buffers.

A mesh whose ranks would sit on several cards raises
``NotImplementedError``: that is the multi-card step of ROADMAP queue 1
item 11 (peer-mapped buffers for K5).

The module-level active grid plays the role of the reference's global
``dplasma_pcomm`` communicator (ref src/dplasmaaux.c:31-43): ops consult
it through :func:`active`; :func:`use_grid` sets it for a dynamic
extent.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device

ROW_AXIS = "p"
COL_AXIS = "q"

_MULTI_CARD = ("a mesh whose ranks sit on several devices is the "
               "multi-card step of the distribution layer (peer-mapped "
               "K5 buffers), not ported yet (ROADMAP queue 1 item 11)")


class Mesh:
    """P×Q ranks with axis names ``('p', 'q')`` on one device.

    ``shape`` maps each axis name to its size, as the reference's
    ``Mesh.shape`` does; ``devices`` is the (P, Q) array of the ranks'
    devices (all the same one), for code that walks it."""

    axis_names = (ROW_AXIS, COL_AXIS)

    def __init__(self, P: int, Q: int, device: torch.device):
        if P < 1 or Q < 1:
            raise ValueError(f"invalid grid {P}x{Q}")
        self.P, self.Q = int(P), int(Q)
        self.device = torch.device(device)

    @property
    def shape(self) -> dict:
        return {ROW_AXIS: self.P, COL_AXIS: self.Q}

    @property
    def size(self) -> int:
        return self.P * self.Q

    @property
    def devices(self) -> np.ndarray:
        grid = np.empty((self.P, self.Q), dtype=object)
        grid.fill(self.device)
        return grid

    def __eq__(self, other):
        return (isinstance(other, Mesh) and (self.P, self.Q, self.device)
                == (other.P, other.Q, other.device))

    def __hash__(self):
        return hash((self.P, self.Q, self.device))

    def __repr__(self):
        return f"Mesh({self.P}x{self.Q}, {self.device})"


def make_mesh(P_: int, Q_: int, device=None) -> Mesh:
    """Create a P×Q mesh on ``device`` (default: ``resolve_device()``,
    so the card). A sequence of devices is accepted as the reference
    takes one; it must name a single device."""
    if isinstance(device, (list, tuple)):
        devs = {torch.device(d) for d in device}
        if len(devs) > 1:
            raise NotImplementedError(_MULTI_CARD)
        device = devs.pop() if devs else None
    return Mesh(P_, Q_, resolve_device(device))


_ACTIVE: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    return _ACTIVE


@contextlib.contextmanager
def use_grid(mesh: Optional[Mesh]):
    """Activate a mesh for the dynamic extent (analog of establishing the
    process grid at ``parsec_init``)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev



def constrain2d(x: torch.Tensor, mesh: Optional[Mesh] = None) \
        -> torch.Tensor:
    """The reference's (rows→'p', cols→'q') sharding constraint
    (dplasma_tpu/parallel/mesh.py:74-85). Every rank of the port's mesh
    lives on one device, so there is nothing to place: the identity."""
    del mesh
    return x
