"""K1, the fused GEMM ``C = alpha*A@B + beta*C``, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_kernels.py:gemm`` / ``matmul``
(the Pallas kernel on the TPU; this module keeps its name so a reader
finds the counterpart). The kernels are in ``csrc/gemm.cu``, CUDA C++
for ``sm_90a``; :func:`plan` picks one per product:

- ``wgmma``, for every operand TMA can describe (a unit stride on one
  axis, 16-byte aligned base and leading stride; every main-path
  product): TMA loads in a ring of stages fed by a producer warp, two
  consumer warpgroups on ``wgmma``, 128×128 output tiles. f32 is
  3xTF32 (each operand split into ``hi = tf32_rna(x)`` and
  ``lo = tf32_rna(x - hi)``; ``lo·hi + hi·lo + hi·hi``), the Hopper
  analogue of the reference's ``Precision.HIGHEST``; bf16 is one pass.
  Products with too few output tiles to fill the card are split over K
  inside the same launch (the partials summed in a fixed order, so two
  launches are bitwise equal).
- ``ffma``, the first port's kernel (128×128 tiles, f32 FFMA), for the
  rest (odd strides such as the ragged K = 777 tests).

What bounds it: operations (tensor-core TF32 rate / 3 for f32, 495 / 3
TFLOP/s on an H100 SXM; 67 for the FFMA kernel).

As in the reference the route is opt-in (:func:`enable`) and gated by
:func:`eligible` (f32/bf16, every dimension >= 256). On a CUDA tensor
the wrapper launches a kernel or raises; only a CPU tensor takes
:func:`gemm_reference`, the plain PyTorch version the tests and the
on-card comparison use. ``ROUTED`` counts calls that took the K1 route
on any device, ``LAUNCHES`` the CUDA launches of either kernel
(``WGMMA_LAUNCHES`` + ``FFMA_LAUNCHES``).

The batched form (:func:`gemm_batched`) is one launch for a stack of
products: the serving layer runs the unbatched sweeps under
``torch.func.vmap``, as the reference runs them under ``jax.vmap``
(whose ``pallas_call`` batching rule makes one launch of the batch).
:func:`gemm` sees a functorch-batched operand there, counts one
``ROUTED`` call for the site and goes through the custom op
``dtt::k1_gemm``, whose vmap rule moves the batch axis to the front and
makes one :func:`gemm_batched` call (a broadcast operand gets batch
stride 0). A plain 2-D tensor never takes that route: it keeps the
direct ctypes launch. Each element of a batched launch runs its 2-D
plan, so it is bitwise its 2-D launch; ``BATCHED_LAUNCHES`` counts the
batched launches (also counted in ``LAUNCHES``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

_ENABLED = False
# Threshold below which the kernel route is not taken (the reference's
# one-MXU-pass gate, kept so both packages route the same products).
_MIN_DIM = 256

#: calls that took the K1 route, on any device
ROUTED = 0
#: CUDA launches of K1, either kernel
LAUNCHES = 0
#: CUDA launches of the tensor-core kernel and of the FFMA kernel
WGMMA_LAUNCHES = 0
FFMA_LAUNCHES = 0
#: CUDA launches of K1 that covered a batch (counted in LAUNCHES too)
BATCHED_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS: dict = {}

# The tensor-core kernel's tile (csrc/gemm.cu, namespace wg): 128×128
# output, K in 128-byte rows (32 f32, 64 bf16)
TILE_M = TILE_N = 128
_ROW_BYTES = 128
#: the least K tiles one split takes
MIN_KT_PER_SPLIT = 4
#: SMs of an H100 SXM, the plan's default
H100_SMS = 132


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset_counts() -> None:
    global ROUTED, LAUNCHES, WGMMA_LAUNCHES, FFMA_LAUNCHES, BATCHED_LAUNCHES
    ROUTED = LAUNCHES = WGMMA_LAUNCHES = FFMA_LAUNCHES = 0
    BATCHED_LAUNCHES = 0


def is_batched(*xs) -> bool:
    """Is any of these a functorch-batched tensor (inside
    ``torch.func.vmap``)? Such a tensor has no storage of its own to
    launch from: the kernels reach it through their custom ops."""
    return any(isinstance(x, torch.Tensor)
               and torch._C._functorch.is_batchedtensor(x) for x in xs)


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


# ---------------------------------------------------------------------
# 3xTF32, plain
# ---------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest TF32 value (10 mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits of the
    pattern become zero. Signed zeros and subnormals round like any
    value; Inf and NaN pass through unchanged."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(special, bits, rounded).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32_rna(x), lo = tf32_rna(x - hi), lo = 0 where hi
    is not finite. hi + lo is x within 2^-21 relative."""
    x = x.to(torch.float32)
    hi = tf32_rna(x)
    lo = torch.where(torch.isfinite(hi), tf32_rna(x - hi),
                     torch.zeros_like(x))
    return hi, lo


def gemm_batched_reference(a, b, c=None, *, alpha=1.0, beta=1.0):
    """Plain PyTorch batched K1: :func:`gemm_reference` on (B, M, K) @
    (B, K, N) stacks, one ``torch.matmul`` at f32 accumulation."""
    return gemm_reference(a, b, c, alpha=alpha, beta=beta)


def gemm_3xtf32_reference(a, b):
    """A @ B from the 3xTF32 split in plain f32 matmuls, the tensor-core
    kernel's terms (lo·hi + hi·lo + hi·hi; lo·lo dropped). Every operand
    is a TF32 value, so each product is exact in f32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


# ---------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------

class Plan(NamedTuple):
    """How one product runs: the kernel (``"wgmma"`` or ``"ffma"``), its
    tile, the K split (``splits`` launches' worth of work units per tile,
    ``kt_per`` K tiles each), whether each operand is K-major in memory,
    and the output tiles."""
    kernel: str
    bm: int
    bn: int
    bk: int
    splits: int
    kt_per: int
    a_kmajor: bool
    b_kmajor: bool
    tiles: int

    @property
    def work_units(self) -> int:
        return self.tiles * self.splits


def _tma_kmajor(strides, esz: int, ptr: int, k_is_cols: bool):
    """Can TMA describe a 2-D operand with these element strides? None if
    not (no unit stride, or a base or leading stride not 16-byte
    aligned), else whether its K axis is the unit-stride one."""
    s0, s1 = strides
    if s1 == 1:
        inner_is_k, ld = k_is_cols, s0
    elif s0 == 1:
        inner_is_k, ld = not k_is_cols, s1
    else:
        return None
    ldb = ld * esz
    if ptr % 16 or ldb % 16 or ldb <= 0 or ldb >= 1 << 40:
        return None
    return inner_is_k


def plan(M: int, N: int, K: int, dtype, a_strides, b_strides,
         a_ptr: int = 0, b_ptr: int = 0, sms: int = H100_SMS) -> Plan:
    """The plan of one product A (M, K) @ B (K, N) with the given element
    strides and base addresses, on a card of ``sms`` SMs.

    The tensor-core kernel takes it when TMA can describe both operands
    and K >= 1; else the FFMA kernel. Output tiles that fill the card
    run whole; fewer are split over K, into as many splits as the card
    holds blocks beside them, each at least ``MIN_KT_PER_SPLIT`` K
    tiles, none empty."""
    name = dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]
    esz = {"float32": 4, "bfloat16": 2}[name]
    bk = _ROW_BYTES // esz
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    a_k = _tma_kmajor(a_strides, esz, a_ptr, True)
    b_k = _tma_kmajor(b_strides, esz, b_ptr, False)
    if a_k is None or b_k is None or K < 1 or M < 1 or N < 1:
        return Plan("ffma", 128, 128, 16, 1, -(-max(K, 1) // 16),
                    a_strides[1] == 1, b_strides[0] == 1, tiles)
    ktiles = -(-K // bk)
    splits = 1
    if tiles < sms:
        splits = max(1, min(sms // tiles, ktiles // MIN_KT_PER_SPLIT))
    kt_per = -(-ktiles // splits)
    splits = -(-ktiles // kt_per)
    return Plan("wgmma", TILE_M, TILE_N, bk, splits, kt_per, a_k, b_k,
                tiles)


_SMS: dict = {}


def _sms(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def plan_batched(M: int, N: int, K: int, dtype, a_strides, b_strides,
                 a_ptr: int = 0, b_ptr: int = 0, sms: int = H100_SMS) -> Plan:
    """The plan of a batched launch over (B, M, K) @ (B, K, N) stacks
    with these element strides (batch first): each element's 2-D
    :func:`plan` (so the element is bitwise its 2-D launch), the FFMA
    kernel when a batch stride is not a multiple of 16 bytes (TMA's rank-3
    rule; 0, a broadcast operand, is fine)."""
    p = plan(M, N, K, dtype, a_strides[1:], b_strides[1:], a_ptr, b_ptr,
             sms)
    name = dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]
    esz = {"float32": 4, "bfloat16": 2}[name]
    if p.kernel == "wgmma" and any((s * esz) % 16 for s in
                                   (a_strides[0], b_strides[0])):
        return Plan("ffma", 128, 128, 16, 1, -(-max(K, 1) // 16),
                    a_strides[2] == 1, b_strides[1] == 1, p.tiles)
    return p


def plan_for(a, b) -> Plan:
    """:func:`plan` of ``a @ b`` as the wrapper computes it (the SM count
    of the tensors' card; an H100's for CPU tensors)."""
    sms = _sms(a.device) if a.device.type == "cuda" else H100_SMS
    return plan(a.shape[0], b.shape[1], a.shape[1], a.dtype, a.stride(),
                b.stride(), a.data_ptr(), b.data_ptr(), sms)


# ---------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------

class _K1Args(ctypes.Structure):
    """``K1Args`` of csrc/gemm.cu: one launch's arguments."""
    _fields_ = [("dtype", ctypes.c_int), ("has_c", ctypes.c_int),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("K", ctypes.c_int),
                ("A", ctypes.c_void_p), ("sam", ctypes.c_longlong),
                ("sak", ctypes.c_longlong),
                ("B", ctypes.c_void_p), ("sbk", ctypes.c_longlong),
                ("sbn", ctypes.c_longlong),
                ("C", ctypes.c_void_p), ("scm", ctypes.c_longlong),
                ("scn", ctypes.c_longlong),
                ("O", ctypes.c_void_p), ("som", ctypes.c_longlong),
                ("son", ctypes.c_longlong),
                ("alpha", ctypes.c_float), ("beta", ctypes.c_float),
                ("kernel", ctypes.c_int), ("bm", ctypes.c_int),
                ("bn", ctypes.c_int), ("bk", ctypes.c_int),
                ("splits", ctypes.c_int), ("kt_per", ctypes.c_int),
                ("a_k", ctypes.c_int), ("b_k", ctypes.c_int),
                ("ws", ctypes.c_void_p), ("counters", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("batch", ctypes.c_int),
                ("sab", ctypes.c_longlong), ("sbb", ctypes.c_longlong),
                ("scb", ctypes.c_longlong), ("sob", ctypes.c_longlong)]


def _kernel():
    fn = _FNS.get("gemm")
    if fn is None:
        from dplasma_tpu_torch.kernels import _build
        fn = _build.load("gemm").dtt_k1_gemm
        fn.argtypes = [ctypes.POINTER(_K1Args)]
        fn.restype = ctypes.c_int
        _FNS["gemm"] = fn
    return fn


#: device index -> int32 per-tile counters of the split-K kernel (zero
#: between launches: the last split of each tile resets its counter)
_COUNTERS: dict = {}


def _counters(device, tiles: int):
    idx = device.index
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < tiles:
        buf = _COUNTERS[idx] = torch.zeros(max(tiles, 1024),
                                           dtype=torch.int32, device=device)
    return buf


#: product shape, layout and alignment -> (plan, its _K1Args)
_LAUNCH_ARGS: dict = {}


def _launch(a, b, c, out, alpha, beta) -> None:
    """One K1 launch into ``out``. The plan and the launch arguments are
    cached per shape, strides, dtype, base alignment and device; a call
    fills the pointers, alpha and beta."""
    global LAUNCHES, WGMMA_LAUNCHES, FFMA_LAUNCHES
    dev = a.device
    pa, pb = a.data_ptr(), b.data_ptr()
    key = (a.shape, b.shape, a.stride(), b.stride(), a.dtype,
           None if c is None else c.stride(), (pa | pb) % 16 == 0, dev)
    hit = _LAUNCH_ARGS.get(key)
    if hit is None:
        M, K = a.shape
        N = b.shape[1]
        p = plan(M, N, K, a.dtype, a.stride(), b.stride(), pa, pb,
                 _sms(dev))
        args = _K1Args(
            dtype=_DTYPES[a.dtype], has_c=int(c is not None), M=M, N=N, K=K,
            sam=a.stride(0), sak=a.stride(1), sbk=b.stride(0),
            sbn=b.stride(1), scm=0 if c is None else c.stride(0),
            scn=0 if c is None else c.stride(1), som=N, son=1,
            kernel=int(p.kernel == "wgmma"), bm=p.bm, bn=p.bn, bk=p.bk,
            splits=p.splits, kt_per=p.kt_per, a_k=int(p.a_kmajor),
            b_k=int(p.b_kmajor), batch=1)
        if p.splits > 1:
            args.counters = _counters(dev, p.tiles).data_ptr()
        hit = _LAUNCH_ARGS[key] = (p, args)
    p, args = hit
    if out.numel() == 0:
        return
    args.A, args.B, args.O = pa, pb, out.data_ptr()
    args.C = None if c is None else c.data_ptr()
    args.alpha, args.beta = alpha, beta
    ws = None
    if p.splits > 1:
        ws = torch.empty(p.splits * p.tiles * TILE_M * TILE_N,
                         dtype=torch.float32, device=dev)
        args.ws = ws.data_ptr()
    args.stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _kernel()(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"K1 {p.kernel} launch failed: cudaError {err} "
                           f"(shapes {tuple(a.shape)} {tuple(b.shape)} "
                           f"{a.dtype} {p})")
    LAUNCHES += 1
    if p.kernel == "wgmma":
        WGMMA_LAUNCHES += 1
    else:
        FFMA_LAUNCHES += 1


def gemm(a, b, c=None, *, alpha=1.0, beta=1.0, bm=512, bn=512, bk=512,
         precision=None):
    """C = alpha * A @ B + beta * C as one fused kernel launch.

    A:(M,K) B:(K,N) C:(M,N), real f32/bf16, any strides. ``c=None`` (or
    beta=0) selects the variant that never reads C. ``bm/bn/bk`` and
    ``precision`` keep the reference's signature: the tiles are the
    plan's (:func:`plan`) and f32 products are always 3xTF32 on the
    tensor cores (or full f32 FFMA), the analogue of ``HIGHEST``.
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
    if is_batched(a, b, c):
        # inside torch.func.vmap: one batched launch for the whole batch
        return torch.ops.dtt.k1_gemm(a, b, c, float(alpha), float(beta))
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


# ---------------------------------------------------------------------
# The batched form: one launch for a stack of products
# ---------------------------------------------------------------------

#: device index -> int32 per-tile counters of batched split-K launches
#: (apart from the 2-D launches', whose cached arguments hold theirs)
_BCOUNTERS: dict = {}


def _batch_counters(device, n: int):
    buf = _BCOUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = _BCOUNTERS[device.index] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=device)
    return buf


def _launch_batched(a, b, c, out, alpha, beta) -> None:
    """One K1 launch over (B, M, K) @ (B, K, N) stacks into ``out`` (B, M,
    N): each element's 2-D plan, batch strides in the arguments,
    workspace and tile counters per element."""
    global LAUNCHES, WGMMA_LAUNCHES, FFMA_LAUNCHES, BATCHED_LAUNCHES
    dev = a.device
    B, M, K = a.shape
    N = b.shape[2]
    pa, pb = a.data_ptr(), b.data_ptr()
    key = ("batched", a.shape, b.shape, a.stride(), b.stride(), a.dtype,
           None if c is None else c.stride(), (pa | pb) % 16 == 0, dev)
    hit = _LAUNCH_ARGS.get(key)
    if hit is None:
        p = plan_batched(M, N, K, a.dtype, a.stride(), b.stride(), pa, pb,
                         _sms(dev))
        args = _K1Args(
            dtype=_DTYPES[a.dtype], has_c=int(c is not None), M=M, N=N, K=K,
            sam=a.stride(1), sak=a.stride(2), sbk=b.stride(1),
            sbn=b.stride(2), scm=0 if c is None else c.stride(1),
            scn=0 if c is None else c.stride(2), som=N, son=1,
            kernel=int(p.kernel == "wgmma"), bm=p.bm, bn=p.bn, bk=p.bk,
            splits=p.splits, kt_per=p.kt_per, a_k=int(p.a_kmajor),
            b_k=int(p.b_kmajor), batch=B, sab=a.stride(0), sbb=b.stride(0),
            scb=0 if c is None else c.stride(0), sob=M * N)
        hit = _LAUNCH_ARGS[key] = (p, args)
    p, args = hit
    if out.numel() == 0:
        return
    args.A, args.B, args.O = pa, pb, out.data_ptr()
    args.C = None if c is None else c.data_ptr()
    args.alpha, args.beta = alpha, beta
    ws = None
    if p.splits > 1:
        ws = torch.empty(B * p.splits * p.tiles * TILE_M * TILE_N,
                         dtype=torch.float32, device=dev)
        args.ws = ws.data_ptr()
        # per call: the batched counters may grow, the 2-D ones never do
        args.counters = _batch_counters(dev, B * p.tiles).data_ptr()
    args.stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _kernel()(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"K1 batched {p.kernel} launch failed: cudaError "
                           f"{err} (shapes {tuple(a.shape)} "
                           f"{tuple(b.shape)} {a.dtype} {p})")
    LAUNCHES += 1
    BATCHED_LAUNCHES += 1
    if p.kernel == "wgmma":
        WGMMA_LAUNCHES += 1
    else:
        FFMA_LAUNCHES += 1


def gemm_batched(a, b, c=None, *, alpha=1.0, beta=1.0):
    """C[i] = alpha * A[i] @ B[i] + beta * C[i] for every i, one launch.

    A:(B,M,K) B:(B,K,N) C:(B,M,N), real f32/bf16, any strides; a batch
    stride of 0 broadcasts one matrix to every element (the vmap rule
    gives an unbatched operand so). On a CPU tensor the plain
    :func:`gemm_batched_reference`; on a CUDA tensor one launch or a
    raise."""
    if beta == 0.0:
        c = None
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"batched K1 takes 3-D stacks, got {a.shape} "
                         f"{b.shape}")
    B, M, K = a.shape
    N = b.shape[2]
    if b.shape[0] != B or b.shape[1] != K or (
            c is not None and tuple(c.shape) != (B, M, N)):
        raise ValueError(f"batched K1 shape mismatch: {tuple(a.shape)} "
                         f"{tuple(b.shape)} "
                         f"{None if c is None else tuple(c.shape)}")
    if max(M, N, K) >= 2**31 or B > 65535:
        raise ValueError(f"batched K1 sizes out of range: {B} {M} {N} {K}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype or \
            (c is not None and c.dtype != a.dtype):
        raise TypeError(f"K1 takes f32 or bf16 operands of one dtype, got "
                        f"{a.dtype} {b.dtype} "
                        f"{None if c is None else c.dtype}")
    devs = {a.device, b.device} | ({c.device} if c is not None else set())
    if len(devs) != 1:
        raise ValueError(f"K1 operands on different devices: {devs}")
    if a.device.type == "cpu":
        return gemm_batched_reference(a, b, c, alpha=alpha, beta=beta)
    if a.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda (or cpu), not {a.device}")
    out = torch.empty((B, M, N), dtype=a.dtype, device=a.device)
    _launch_batched(a, b, c, out, float(alpha), float(beta))
    return out


def front(x, bdim, size: int):
    """``x`` with its vmap batch axis first; an unbatched operand
    broadcast over the batch (batch stride 0). None stays None."""
    if x is None:
        return None
    if bdim is None:
        return x.unsqueeze(0).expand(size, *x.shape)
    return x.movedim(bdim, 0)


@torch.library.custom_op("dtt::k1_gemm", mutates_args=())
def _k1_op(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor],
           alpha: float, beta: float) -> torch.Tensor:
    """K1 as a custom op. Reached only from :func:`gemm` on a batched
    operand; called outside vmap it is a batch of one."""
    out = gemm_batched(a[None], b[None], None if c is None else c[None],
                       alpha=alpha, beta=beta)
    return out[0]


@_k1_op.register_fake
def _(a, b, c, alpha, beta):
    return a.new_empty((a.shape[0], b.shape[1]))


def _k1_vmap(info, in_dims, a, b, c, alpha, beta):
    """The vmap rule: the batch axis to the front, ONE batched launch."""
    n = info.batch_size
    return gemm_batched(front(a, in_dims[0], n), front(b, in_dims[1], n),
                        front(c, in_dims[2], n), alpha=alpha,
                        beta=beta), 0


torch.library.register_vmap("dtt::k1_gemm", _k1_vmap)
