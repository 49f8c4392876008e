"""K1, the fused GEMM ``C = alpha*A@B + beta*C``, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_kernels.py:gemm`` / ``matmul``
(the Pallas kernel on the TPU; this module keeps its name so a reader
finds the counterpart). The kernel is ``csrc/gemm.cu``: CUDA C++ for
``sm_90a``, one block per 128×128 output tile with a loop over K inside
it, A and B tiles staged in shared memory, f32 FFMA accumulation (full
f32, never TF32) and the alpha/beta epilogue fused so C is read once
(never, when beta = 0). It takes strides and masks ragged edges, so
transposed views and odd shapes need no copy and no padding.

What bounds it: FP32 CUDA-core FLOP/s (67 TFLOP/s on an H100 SXM) for
the large update products of the Cholesky sweep. A later design moves
them to the tensor cores (wgmma + TMA, 3xTF32 to keep f32 accuracy).

As in the reference the route is opt-in (:func:`enable`) and gated by
:func:`eligible` (f32/bf16, every dimension >= 256). On a CUDA tensor
the wrapper launches the kernel or raises; only a CPU tensor takes
:func:`gemm_reference`, the plain PyTorch version the tests and the
on-card comparison use. ``ROUTED`` counts calls that took the K1 route
on any device, ``LAUNCHES`` the CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

_ENABLED = False
# Threshold below which the kernel route is not taken (the reference's
# one-MXU-pass gate, kept so both packages route the same products).
_MIN_DIM = 256

#: calls that took the K1 route, on any device
ROUTED = 0
#: CUDA launches of the K1 kernel
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset_counts() -> None:
    global ROUTED, LAUNCHES
    ROUTED = 0
    LAUNCHES = 0


def eligible(a, b, c=None) -> bool:
    """Is the K1 route worth dispatching? (the reference's gate)"""
    if not _ENABLED:
        return False
    if a.ndim != 2 or b.ndim != 2:
        return False
    if a.dtype not in (torch.float32, torch.bfloat16):
        return False
    if a.dtype != b.dtype or (c is not None and c.dtype != a.dtype):
        return False
    M, K = a.shape
    N = b.shape[1]
    return min(M, K, N) >= _MIN_DIM


def gemm_reference(a, b, c=None, *, alpha=1.0, beta=1.0):
    """Plain PyTorch K1: f32 accumulation, output in C's dtype (A's
    when there is no C). Used for CPU tensors and by the tests."""
    out_dtype = a.dtype if c is None else c.dtype
    acc = alpha * torch.matmul(a.float(), b.float())
    if c is not None and beta != 0.0:
        acc = acc + beta * c.float()
    return acc.to(out_dtype)


def _kernel():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        fn = _build.load("gemm").dtt_k1_gemm
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ptr, i64, i64, ptr, i64, i64, ptr, i64, i64,
                       ptr, i64, i64,
                       ctypes.c_float, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(a, b, c, out, alpha, beta) -> None:
    global LAUNCHES
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0:
        return
    has_c = c is not None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            _DTYPES[a.dtype], int(has_c), M, N, K,
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            c.data_ptr() if has_c else None,
            c.stride(0) if has_c else 0, c.stride(1) if has_c else 0,
            out.data_ptr(), out.stride(0), out.stride(1),
            alpha, beta, stream)
    if err != 0:
        raise RuntimeError(f"K1 gemm launch failed: cudaError {err} "
                           f"(M={M} N={N} K={K} {a.dtype})")
    LAUNCHES += 1


def gemm(a, b, c=None, *, alpha=1.0, beta=1.0, bm=512, bn=512, bk=512,
         precision=None):
    """C = alpha * A @ B + beta * C as one fused kernel.

    A:(M,K) B:(K,N) C:(M,N), real f32/bf16, any strides. ``c=None`` (or
    beta=0) selects the variant that never reads C. ``bm/bn/bk`` and
    ``precision`` keep the reference's signature: the Hopper kernel's
    tile is fixed at 128×128×16 and its products are always full f32.
    """
    global ROUTED
    if beta == 0.0:
        c = None
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"K1 takes 2-D operands, got {a.shape} {b.shape}")
    M, K = a.shape
    K2, N = b.shape
    if max(M, N, K) >= 2**31:
        raise ValueError(f"K1 dimensions must fit in int32: {M} {N} {K}")
    if K != K2 or (c is not None and tuple(c.shape) != (M, N)):
        raise ValueError(f"K1 shape mismatch: {tuple(a.shape)} "
                         f"{tuple(b.shape)} "
                         f"{None if c is None else tuple(c.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype or \
            (c is not None and c.dtype != a.dtype):
        raise TypeError(f"K1 takes f32 or bf16 operands of one dtype, got "
                        f"{a.dtype} {b.dtype} "
                        f"{None if c is None else c.dtype}")
    devs = {a.device, b.device} | ({c.device} if c is not None else set())
    if len(devs) != 1:
        raise ValueError(f"K1 operands on different devices: {devs}")
    ROUTED += 1
    if a.device.type == "cpu":
        return gemm_reference(a, b, c, alpha=alpha, beta=beta)
    if a.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda (or cpu), not {a.device}")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch(a, b, c, out, float(alpha), float(beta))
    return out


def matmul(a, b, **kw):
    """A @ B via the C-free kernel variant (C never read)."""
    return gemm(a, b, None, alpha=kw.pop("alpha", 1.0), beta=0.0, **kw)
