"""K3, the blocked partial-pivoting LU panel, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_lu.py:lu_panel`` (the Pallas
kernel on the TPU; this module keeps its name so a reader finds the
counterpart). The kernel is ``csrc/lu_panel.cu``: CUDA C++ for
``sm_90a``, one block of 1024 threads per panel, the panel in device
memory (L2-resident) in column-major order, JB = 8 column blocks, a
block-wide lowest-index pivot reduction per column, deferred swaps of
the columns outside the strip, and per block the unit-lower U12 solve
and the rank-8 trailing update.

What bounds it: latency, not FLOP/s or bytes — one SM of the card's
132 does the work, with nb sequential pivot steps. A later design
spreads each panel over many SMs.

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

import ctypes

import torch

from dplasma_tpu_torch.kernels import panels as _panels
# the fused-panel gate has one home, K4's module, as in the reference
# (dplasma_tpu/kernels/pallas_lu.py:134-139)
from dplasma_tpu_torch.kernels.pallas_qr import (  # noqa: F401
    JB, VMEM_PANEL_BYTES, eligible_shape)

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
        fn = _build.load("lu_panel").dtt_k3_lu_panel
        ptr = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(a):
    global LAUNCHES
    M, nb = a.shape
    work = torch.empty((nb, M), dtype=torch.float32, device=a.device)
    work.copy_(a.T)                      # column-major panel, in place
    swaps = torch.empty(nb, dtype=torch.int32, device=a.device)
    perm = torch.empty(M, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(M, nb, work.data_ptr(), swaps.data_ptr(),
                        perm.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 lu_panel launch failed: cudaError {err} "
                           f"(M={M} nb={nb})")
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
