"""K2, the level recombine + epilogue of the dd limb route, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_dd.py:recombine_base`` (the Pallas
kernel on the TPU; this module keeps its name so a reader finds the
counterpart). It computes the epilogue that closes every exact limb
product (``kernels/dd.py``)::

    base - (sa * sb) * sum_l levels[l] * 2^(-w(l+2))

The kernel is ``csrc/recombine.cu``: CUDA C++ for ``sm_90a``, one thread
per element, rows over ``blockIdx.y``, every level plane, the base and
the output read and written coalesced.

Why f64 and not double-single: on the TPU, f64 is an f32 pair, so the
Pallas body sums exact hi16/lo16 f32 terms by Knuth two-sum (~2^-48),
the platform's own f64 width; its docstring sends true-f64 backends to
the exact ``_level_recombine``. Hopper has f64 ALUs, so K2 computes the
function in f64 in ``_level_recombine``'s order. Each term
``levels[l]·2^(-w(l+2))`` is exact (an int32 times a power of two fits in
53 bits) and ``sa·sb`` is a power of two, and the kernel contracts
nothing into an FMA: it equals :func:`recombine_base_reference`, and so
the reference's exact route, bit for bit.

What bounds it: bytes — ``4·nl + 8 + 8`` per element (levels, base,
output), ``4·nl + 8`` without a base.

The route: ``kernels.dd._recombine_scale_base`` sends the recombine here
when :func:`eligible` holds: int32 levels (an unchunked product: f64
levels of a chunked one take the exact plain route on any device, as
the reference's gate excludes them) and MCA ``dd_epilogue`` not
``off``. The reference's other conditions are dropped: ``_ff_backend()``
(K2 is exact, so nothing changes by routing on a true-f64 device), and
``N % 128`` and ``M % 8`` (Mosaic's (8, 128) tile alignment; the CUDA
kernel masks its own edges). On a CUDA tensor
the wrapper launches the kernel or raises; only a CPU tensor takes
:func:`recombine_base_reference`, the plain PyTorch version the tests
and the on-card comparison use. ``ROUTED`` counts calls on any device,
``LAUNCHES`` the CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

from dplasma_tpu_torch.utils import config as _cfg

#: calls that took the K2 route, on any device
ROUTED = 0
#: CUDA launches of the K2 kernel
LAUNCHES = 0

_FN = None


def reset_counts() -> None:
    global ROUTED, LAUNCHES
    ROUTED = 0
    LAUNCHES = 0


def eligible(levels) -> bool:
    """Route this recombine to K2? int32 levels (an unchunked product)
    and MCA ``dd_epilogue`` not ``off``."""
    if levels.dtype != torch.int32:
        return False
    return (_cfg.mca_get("dd_epilogue") or "auto").lower() != "off"


def recombine_base_reference(levels, base, sa, sb, w: int):
    """Plain PyTorch K2: ``_level_recombine``'s loop in f64, then
    ``base - U·(sa·sb)`` (``-U·(sa·sb)`` when ``base`` is None)."""
    from dplasma_tpu_torch.kernels.dd import _level_recombine
    prod = _level_recombine(levels, w) * (sa * sb)
    return -prod if base is None else base - prod


def _kernel():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        fn = _build.load("recombine").dtt_k2_recombine
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_int, i64, i64, ptr, ptr, i64,
                       i64, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(lv, base, sa, sb, w):
    global LAUNCHES
    nl, M, N = lv.shape
    lv = lv.contiguous()
    sav = sa.to(torch.float64).expand(M, 1).reshape(M).contiguous()
    sbv = sb.to(torch.float64).expand(1, N).reshape(N).contiguous()
    out = torch.empty((M, N), dtype=torch.float64, device=lv.device)
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(lv.device):
        err = _kernel()(
            nl, w, M, N, lv.data_ptr(),
            None if base is None else base.data_ptr(),
            0 if base is None else base.stride(0),
            0 if base is None else base.stride(1),
            sav.data_ptr(), sbv.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 recombine launch failed: cudaError {err} "
                           f"(nl={nl} M={M} N={N})")
    LAUNCHES += 1
    return out


def recombine_base(lv, base, sa, sb, w: int):
    """``base - (sa * sb) * sum_l lv[l] * 2^(-w(l+2))`` in f64.

    ``lv``: the levels, an int32 (nl, M, N) tensor; ``base``: f64
    (M, N), any strides, or None (zero); ``sa``/``sb``: f64 power-of-two
    scales broadcastable to (M, 1) / (1, N), any sign (callers negate to
    add the product). Returns a new f64 (M, N) tensor."""
    global ROUTED
    if lv.ndim != 3 or lv.dtype != torch.int32:
        raise TypeError(f"K2 takes int32 (nl, M, N) levels, got "
                        f"{lv.dtype} {tuple(lv.shape)}")
    _, M, N = lv.shape
    if base is not None and (base.dtype != torch.float64
                             or tuple(base.shape) != (M, N)):
        raise TypeError(f"K2 takes an f64 ({M}, {N}) base, got "
                        f"{base.dtype} {tuple(base.shape)}")
    devs = {lv.device, sa.device, sb.device} | (
        {base.device} if base is not None else set())
    if len(devs) != 1:
        raise ValueError(f"K2 operands on different devices: {devs}")
    ROUTED += 1
    if lv.device.type == "cpu":
        return recombine_base_reference(lv, base, sa, sb, w)
    if lv.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda (or cpu), not {lv.device}")
    return _launch(lv, base, sa, sb, w)
