"""K4, the blocked Householder QR panel, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_qr.py:geqrt_panel`` (body
``_geqrt_kernel``, ``pallas_call`` at :123; this module keeps its name
so a reader finds the counterpart). The kernel is
``csrc/geqrt_panel.cu``: CUDA C++ for ``sm_90a``, one thread-block
cluster per panel (:func:`launch_geometry`: 2 to 16 blocks of 512
threads, each owning a contiguous range of rows and keeping them of the
current JB = 8 column strip in shared memory; the panel in device
memory, L2-resident, column-major). Per column one exchange: each block
pushes its partial sum of squares and dot products with the strip
columns to its right into every block's shared memory (``st.async``
counted off an mbarrier), and every block sums the C partials in one
fixed order, so all derive the same reflector; per JB block two
cluster barriers for the Gram VbᵀVb, the 8×8 T_blk by the larft
recurrence and the rank-8 compact-WY update of the trailing columns,
each block on its own rows.

What bounds it: the chain of nb sequential reflectors, each a round of
communication between the cluster's SMs, not FLOP/s or bytes.

Reflector rule: the reference's, not LAPACK's larfg. With alpha the
diagonal entry and norm = sqrt(alpha² + Σ below²): beta = -norm if
alpha >= 0 (-0.0 included) else +norm; tau = (beta - alpha)/beta when
norm > 0, else 0; v = x/(alpha - beta) below the diagonal (0 when that
difference is 0). A column with nothing below its diagonal but a
non-zero alpha therefore reflects with tau = 2 (LAPACK: tau = 0): the
last column of a square panel does so, and so do both packages.

The route and its gate are the reference's: ``kernels.panels.qr_panel``
sends a panel here under MCA ``panel.kernel=pallas`` when
:func:`eligible` holds — f32, ``nb % 8 == 0`` and ``M·nb·4 <= 8 MiB``
(the gate's one home, as in the reference; ``pallas_lu`` imports it).
Other panels go to the TSQR tree. On a CUDA tensor the wrapper
launches the kernel or raises; only a CPU tensor takes
:func:`geqrt_panel_reference`, the plain PyTorch version the tests and
the on-card comparison use. ``ROUTED`` counts calls on any device,
``LAUNCHES`` the CUDA launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from dplasma_tpu_torch.kernels import householder as hh

#: column register-block width (the reference's JB, pallas_qr.py:43)
JB = 8
#: whole-panel residency budget of the fused panel kernels
#: (pallas_qr.py:150); kept as the routing gate
VMEM_PANEL_BYTES = 8 * 2 ** 20

#: most blocks in one cluster (Hopper's non-portable limit)
MAX_CLUSTER = 16
#: rows a block should own before the cluster grows by one more block
ROWS_PER_BLOCK_TARGET = 64
#: dynamic shared memory a block may take: the card's 232,448-byte
#: per-block limit less room for each kernel's static shared memory
SMEM_LIMIT = 232448
SMEM_BUDGET = SMEM_LIMIT - 16384


class Geometry(NamedTuple):
    """How K3 and K4 spread an (M, nb) panel over one cluster."""
    cluster: int         # blocks in the cluster (2..16)
    rows_per_block: int  # block r owns rows [r·R, min(M, (r+1)·R))
    smem_rows: int       # rows of its strip a block keeps in shared memory
    smem_bytes: int      # dynamic shared memory per block


def launch_geometry(m: int, nb: int) -> Geometry:
    """The cluster launch of K3 and K4 for an (m, nb) panel: one block
    per ~:data:`ROWS_PER_BLOCK_TARGET` rows, at least 2 and at most
    :data:`MAX_CLUSTER`; each block keeps as many of its rows of the
    8-column strip in shared memory as fit twice (K3 double-buffers the
    strip) beside two staging areas of JB·nb floats and the nb pivots,
    and reads the rest from the panel.
    A constant of the design (not an MCA knob); the tests check it for
    every shape the gate admits."""
    if m < 1 or nb < 1:
        raise ValueError(f"no launch geometry for a {m}x{nb} panel")
    cluster = min(MAX_CLUSTER, max(2, math.ceil(m / ROWS_PER_BLOCK_TARGET)))
    rows = math.ceil(m / cluster)
    fixed = 4 * (2 * JB * nb + nb)
    smem_rows = max(0, min(rows, (SMEM_BUDGET - fixed) // (8 * JB)))
    return Geometry(cluster, rows, smem_rows,
                    8 * JB * smem_rows + fixed)


#: calls that took the K4 route, on any device
ROUTED = 0
#: CUDA launches of the K4 kernel
LAUNCHES = 0

_FN = None


def reset_counts() -> None:
    global ROUTED, LAUNCHES
    ROUTED = 0
    LAUNCHES = 0


def eligible_shape(m: int, nb: int, itemsize: int = 4) -> bool:
    """The fused-panel shape gate (pallas_qr.py:153-159): f32-width
    items, JB-aligned width, whole panel within the residency budget.
    Shared by K3 and K4."""
    return (itemsize == 4 and nb % JB == 0
            and m * nb * itemsize <= VMEM_PANEL_BYTES)


def eligible(a) -> bool:
    """Route this panel to K4? (the reference's gate: f32 + the shape
    gate)."""
    if a.ndim != 2 or a.dtype != torch.float32:
        return False
    return eligible_shape(a.shape[0], a.shape[1])


def geqrt_panel_reference(a):
    """Plain PyTorch K4: ``_geqrt_kernel`` block by block — per column
    the reflector of the rule above applied to the strip columns right
    of it, per JB block the larft recurrence for T_blk and the rank-JB
    update ``trail -= Vb (T_blkᵀ (Vbᵀ trail))``. Data-independent
    control flow (selects, no host syncs). Returns ``(packed, taus)``."""
    M, nb = a.shape
    # row-major whatever the input's strides, so the sums below run in
    # one order for every layout of the same panel
    A = a.clone(memory_format=torch.contiguous_format)
    dev = a.device
    rows = torch.arange(M, device=dev)
    taus = torch.zeros(nb, dtype=a.dtype, device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    one = torch.ones((), dtype=a.dtype, device=dev)
    for j0 in range(0, nb, JB):
        S = A[:, j0:j0 + JB]                       # view: updates land in A
        jb = S.shape[1]
        blk_taus = []
        for jj in range(jb):
            j = j0 + jj
            x = torch.where(rows >= j, S[:, jj], zero)
            alpha = S[j, jj]
            ssq = torch.sum(torch.where(rows > j, x * x, zero))
            norm = torch.sqrt(alpha * alpha + ssq)
            beta = torch.where(alpha >= 0, -norm, norm)
            live = norm > 0
            tau = torch.where(live, (beta - alpha) / torch.where(
                live, beta, one), zero)
            denom = alpha - beta
            vinv = torch.where(denom != 0, 1.0 / torch.where(
                denom != 0, denom, one), zero)
            v = torch.where(rows > j, x * vinv,
                            torch.where(rows == j, one, zero))
            taus[j] = tau
            blk_taus.append(tau)
            if jj + 1 < jb:
                right = S[:, jj + 1:]
                w = torch.sum(v[:, None] * right, dim=0, keepdim=True)
                right.sub_(tau * v[:, None] * w)
            S[j, jj] = beta
            S[j + 1:, jj] = v[j + 1:]
        trail = A[:, j0 + jb:]
        if trail.shape[1]:
            cidx = torch.arange(jb, device=dev)
            diag = j0 + cidx
            Vb = torch.where(rows[:, None] > diag, S,
                             torch.where(rows[:, None] == diag, one, zero))
            G = Vb.T @ Vb
            T = torch.zeros((jb, jb), dtype=a.dtype, device=dev)
            for i in range(jb):
                if i:
                    T[:i, i] = -blk_taus[i] * (T[:i, :i] @ G[:i, i])
                T[i, i] = blk_taus[i]
            W = Vb.T @ trail
            trail.sub_(Vb @ (T.T @ W))
    return A, taus


def _kernel():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        lib = _build.load("geqrt_panel")
        _FN = bind_cluster_entry(lib.dtt_k4_geqrt_panel, 2)
    return _FN


def bind_cluster_entry(fn, n_ptrs):
    """ctypes types of a cluster panel entry point: M, nb and the four
    geometry ints, then ``n_ptrs`` tensor pointers (the column-major
    panel first) and the stream."""
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * (n_ptrs + 1)
    fn.restype = ctypes.c_int
    return fn


def column_major(a):
    """The (M, nb) panel ``a`` copied into column-major order, as the
    cluster panel kernels factor it in place: an (nb, M) tensor."""
    work = torch.empty((a.shape[1], a.shape[0]), dtype=torch.float32,
                       device=a.device)
    work.copy_(a.T)
    return work


def launch_error(name, err, M, nb, geom):
    """The error a refused cluster launch raises."""
    why = ("no cluster of this shape fits on the card" if err == -1
           else f"cudaError {err}")
    return RuntimeError(f"{name} launch failed: {why} (M={M} nb={nb}, "
                        f"{geom})")


def _launch(a):
    global LAUNCHES
    M, nb = a.shape
    geom = launch_geometry(M, nb)
    work = column_major(a)
    taus = torch.empty(nb, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel()(M, nb, *geom, work.data_ptr(), taus.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise launch_error("K4 geqrt_panel", err, M, nb, geom)
    LAUNCHES += 1
    return work.T.contiguous(), taus


def geqrt_panel_packed(a):
    """K4 itself: ``(packed, taus)`` of an (M, nb) f32 panel — R on and
    above the diagonal, V below it (unit diagonal implicit). Takes
    M >= nb, nb a multiple of 8; any strides."""
    global ROUTED
    if a.ndim != 2:
        raise ValueError(f"K4 takes a 2-D panel, got {tuple(a.shape)}")
    M, nb = a.shape
    if nb < 1 or nb % JB or M < nb or M * nb >= 2 ** 31:
        raise ValueError(f"K4 takes M >= nb, nb a positive multiple of "
                         f"{JB} and M*nb < 2^31, got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"K4 takes float32 panels, got {a.dtype}")
    ROUTED += 1
    if a.device.type == "cpu":
        return geqrt_panel_reference(a)
    if a.device.type != "cuda":
        raise ValueError(f"K4 runs on cuda (or cpu), not {a.device}")
    return _launch(a)


def geqrt_panel(a):
    """Fused panel QR of an (M, nb) f32 panel: ``(packed, V, T)`` in the
    :func:`~dplasma_tpu_torch.kernels.householder.geqrt` contract; T is
    rebuilt from the taus by ``householder.larft`` (one product, one
    small solve), as the reference's wrapper does."""
    packed, taus = geqrt_panel_packed(a)
    v, _ = hh.split_qr(packed)
    return packed, v, hh.larft(v, taus)
