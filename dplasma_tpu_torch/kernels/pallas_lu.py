"""K3, the blocked partial-pivoting LU panel, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_lu.py:lu_panel`` (the Pallas
kernel on the TPU; this module keeps its name so a reader finds the
counterpart). The kernel is ``csrc/lu_panel.cu``: CUDA C++ for
``sm_90a``, one thread-block cluster per panel with K4's launch
geometry (``pallas_qr.launch_geometry``: 2 to 16 blocks of 512 threads,
each owning a contiguous range of rows and keeping them of the current
JB = 8 column strip in shared memory; the panel in device memory,
L2-resident, column-major). Per column one exchange: each block pushes
its lowest-index max-|a| candidate with that row's strip values into
every block's shared memory (``st.async`` counted off an mbarrier), and
every block elects the same pivot from the C candidates. That chain runs
on half of each block's threads while the other half applies the
previous strip's rank-8 update; per JB block two cluster barriers
around the row moves of the columns outside the strip and the U12
solve. Bitwise equal to :func:`lu_panel_reference`.

What bounds it: the chain of nb sequential pivot steps, each a round of
communication between the cluster's SMs, and the rank-8 updates at two
FP32 instructions per multiply-subtract (no FMA, to stay bitwise), not
bytes.

The route and its gate are the reference's: ``ops.lu._base_lu`` sends a
panel here under MCA ``panel.kernel=pallas`` (or ``lu.pallas_panel=on``
on the chain route) when :func:`eligible` holds: f32 and the fused-panel
shape gate of ``kernels/pallas_qr.py`` (``nb % 8 == 0``, ``M·nb·4 <=
8 MiB``), so both packages route the same panels. On a
CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor takes :func:`lu_panel_reference`, the plain PyTorch version the
tests and the on-card comparison use. ``ROUTED`` counts calls on any
device, ``LAUNCHES`` the CUDA launches.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.kernels import panels as _panels
# the fused-panel gate has one home, K4's module, as in the reference
# (dplasma_tpu/kernels/pallas_lu.py:134-139)
from dplasma_tpu_torch.kernels import pallas_qr as _pqr
from dplasma_tpu_torch.kernels.pallas_qr import (  # noqa: F401
    JB, VMEM_PANEL_BYTES, eligible_shape, launch_geometry)

#: calls that took the K3 route, on any device
ROUTED = 0
#: CUDA launches of the K3 kernel
LAUNCHES = 0

_FN = None


def reset_counts() -> None:
    global ROUTED, LAUNCHES
    ROUTED = 0
    LAUNCHES = 0


def eligible(a) -> bool:
    """Route this panel to K3? (the reference's gate: f32 + the shape
    gate)."""
    if a.ndim != 2 or a.dtype != torch.float32:
        return False
    return eligible_shape(a.shape[0], a.shape[1])


def lu_panel_reference(a):
    """Plain PyTorch K3: the column loop of the rec panel's base case
    over the whole width — lowest-index pivot, two-row swap, reciprocal
    scale (0 for a zero pivot), rank-1 update, each step rounded as the
    kernel rounds it. Returns ``(packed, perm)`` with ``a[perm] = L U``."""
    return _panels._lu_base_vec(a, True)


def _kernel():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        lib = _build.load("lu_panel")
        _FN = _pqr.bind_cluster_entry(lib.dtt_k3_lu_panel, 3)
    return _FN


def _launch(a):
    global LAUNCHES
    M, nb = a.shape
    geom = launch_geometry(M, nb)
    work = _pqr.column_major(a)
    swaps = torch.empty(nb, dtype=torch.int32, device=a.device)
    perm = torch.empty(M, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(M, nb, *geom, work.data_ptr(), swaps.data_ptr(),
                        perm.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise _pqr.launch_error("K3 lu_panel", err, M, nb, geom)
    LAUNCHES += 1
    return work.T.contiguous(), perm


def lu_panel(a):
    """Packed L\\U + permutation of an (M, nb) f32 panel, ``a[perm] =
    L U`` (perm int64, derived in the kernel from its swap sequence).
    Takes M >= nb, nb a multiple of 8; any strides."""
    global ROUTED
    if a.ndim != 2:
        raise ValueError(f"K3 takes a 2-D panel, got {tuple(a.shape)}")
    M, nb = a.shape
    if nb < 1 or nb % JB or M < nb or M * nb >= 2 ** 31:
        raise ValueError(f"K3 takes M >= nb, nb a positive multiple of "
                         f"{JB} and M*nb < 2^31, got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"K3 takes float32 panels, got {a.dtype}")
    ROUTED += 1
    if a.device.type == "cpu":
        return lu_panel_reference(a)
    if a.device.type != "cuda":
        raise ValueError(f"K3 runs on cuda (or cpu), not {a.device}")
    return _launch(a)
