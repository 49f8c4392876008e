"""K2, the level recombine + epilogue of the dd limb route, on Hopper,
fused into the exact int8 limb product it closes.

Replaces ``dplasma_tpu/kernels/pallas_dd.py:recombine_base`` (the Pallas
kernel on the TPU; this module keeps its name so a reader finds the
counterpart). On the TPU, XLA fuses the level sums into the per-limb
int8 dots and K2 is one pass over the (nl, M, N) level tensor. Eager
PyTorch fuses nothing, so here the recombine is the epilogue of a
hand-written int8 tensor-core product, :func:`limb_product_base`::

    base - (sa * sb) * sum_l 2^(-w(l+2)) * sum_{i+j=l} A_i @ B_j^T

with the int32 level sums kept in registers and never written to device
memory. The kernel is ``csrc/recombine.cu``: CUDA C++ for ``sm_90a``,
TMA + ``wgmma.m64n64k32.s32.s8.s8``, 64×64 output tiles, all nl levels
live (:func:`plan` gives the level groups of its warpgroups), split over
K inside the launch when the output tiles are too few to fill the card.

Why f64 and not double-single: on the TPU, f64 is an f32 pair, so the
Pallas body sums exact hi16/lo16 f32 terms by Knuth two-sum (~2^-48),
the platform's own f64 width; its docstring sends true-f64 backends to
the exact ``_level_recombine``. Hopper has f64 ALUs, so K2's epilogue
computes the function in f64 in ``_level_recombine``'s order. Integer
sums are exact in any order within int32 (the route's chunk bound), each
term ``levels[l]·2^(-w(l+2))`` is exact and ``sa·sb`` is a power of two,
and the kernel contracts nothing into an FMA: it equals
:func:`limb_product_base_reference`, and so the reference's exact route,
bit for bit.

What bounds it: operations — nl(nl+1)/2 limb-pair products of 2·M·N·K
int8 operations, at the 1979 TOP/s dense int8 peak of an H100 SXM.

The route: ``kernels.dd._limb_product_base`` sends an unchunked product
(K <= kc) here on the card when MCA ``dd_epilogue`` is not ``off``
(:func:`fused`); every other product takes the plain route, the
reference's ``_recombine_scale_base(_limb_levels(...))``, and adds one
to ``UNFUSED`` when it runs on the card. On a CUDA tensor the wrapper
launches the kernel or raises; only a CPU tensor takes
:func:`limb_product_base_reference`, the plain PyTorch version the tests
and the on-card comparison use. :func:`recombine_base` keeps the
reference's name and level-tensor API for CPU tensors (the plain route's
epilogue there). ``ROUTED`` counts calls of either entry point on any
device, ``LAUNCHES`` the CUDA launches.

The batched form (:func:`limb_product_base_batched`) is one launch for
the limb products of a whole batch, the serving layer's residuals under
``torch.func.vmap`` (the reference's ``pallas_call`` batching rule).
:func:`limb_product_base` sees functorch-batched planes there, counts one
``ROUTED`` call and goes through the custom op ``dtt::k2_limb_gemm``,
whose vmap rule moves the batch axis to the front and makes one batched
call (an unbatched operand broadcasts with batch stride 0). A plain
tensor keeps the direct ctypes launch. Every element is bitwise its 2-D
launch and the plain version; ``BATCHED_LAUNCHES`` counts the batched
launches (also counted in ``LAUNCHES``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from dplasma_tpu_torch.kernels import pallas_kernels as _pk
from dplasma_tpu_torch.utils import config as _cfg

#: calls that took the K2 route (either entry point), on any device
ROUTED = 0
#: CUDA launches of the fused K2 kernel
LAUNCHES = 0
#: limb products on the card that took the plain, unfused route
UNFUSED = 0
#: CUDA launches of K2 that covered a batch (counted in LAUNCHES too)
BATCHED_LAUNCHES = 0

# The kernel's tile (csrc/recombine.cu): 64×64 output, 64 bytes of K a
# step, one 4 KB box per limb plane
TILE_M = TILE_N = TILE_K = 64
_PLANE = TILE_M * TILE_K
#: the most limbs the kernel keeps live (four warpgroups of two levels)
MAX_NL = 8
_MAX_STAGES = 4
_SMEM_LIMIT = 232448          # the 227 KB a block can opt into
_LDS = TILE_N + 8             # level tile row stride (int32)
_BAR_BYTES = 256
_ALIGN = 1024
#: the least K steps one split takes
MIN_KT_PER_SPLIT = 2
#: SMs of an H100 SXM, the plan's default
H100_SMS = 132
#: the largest int8 digit magnitude (w = 7 bits)
_DIGIT = 127

_FNS: dict = {}


def reset_counts() -> None:
    global ROUTED, LAUNCHES, UNFUSED, BATCHED_LAUNCHES
    ROUTED = 0
    LAUNCHES = 0
    UNFUSED = 0
    BATCHED_LAUNCHES = 0


def fused() -> bool:
    """MCA ``dd_epilogue`` is not ``off``: the route's K2 switch."""
    return (_cfg.mca_get("dd_epilogue") or "auto").lower() != "off"


def eligible(levels) -> bool:
    """Route this level recombine to :func:`recombine_base`? int32
    levels (an unchunked product) and :func:`fused`."""
    return levels.dtype == torch.int32 and fused()


# ---------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------

class Plan(NamedTuple):
    """How one limb product runs: the output tile and K step, the level
    groups of the consumer warpgroups (one group each), the pipeline's
    stage count and the block's shared memory, the K split (``splits``
    blocks per output tile, ``kt_per`` K steps each), the output tiles,
    and whether each operand needs an aligned copy for TMA."""
    bm: int
    bn: int
    bk: int
    groups: tuple
    stages: int
    smem: int
    splits: int
    kt_per: int
    tiles: int
    a_copy: bool
    b_copy: bool

    @property
    def threads(self) -> int:
        return 128 * len(self.groups) + 32


def max_depth(nl: int) -> int:
    """The deepest K whose level sums stay exact in int32:
    nl·K·127² < 2^31 (the chunk depth of ``dd._plan``)."""
    return (2 ** 31 - 1) // (nl * _DIGIT ** 2)


def level_groups(nl: int) -> tuple:
    """Levels of each consumer warpgroup: (l, nl−1−l), the middle level
    alone when nl is odd. Level l sums l + 1 pairs, so every pair of
    levels is nl + 1 pairs."""
    return tuple((l, nl - 1 - l) if l != nl - 1 - l else (l,)
                 for l in range((nl + 1) // 2))


def _stages(nl: int) -> int:
    return min(_MAX_STAGES,
               (_SMEM_LIMIT - _ALIGN - _BAR_BYTES) // (2 * nl * _PLANE))


def _tma_ok(strides, ptr: int, nl: int) -> bool:
    """Can TMA describe (nl, rows, K) int8 planes with these element
    strides at this address? Unit stride along K; base, row and plane
    strides 16-byte aligned (the plane stride matters only for nl > 1)."""
    sp, sr, sk = strides
    if nl == 1:
        sp = 16
    return (sk == 1 and ptr % 16 == 0 and sr % 16 == 0 and sp % 16 == 0
            and 0 < sr < 1 << 40 and 0 < sp < 1 << 40)


def plan(nl: int, M: int, N: int, K: int, a_strides=None, b_strides=None,
         a_ptr: int = 0, b_ptr: int = 0, sms: int = H100_SMS) -> Plan:
    """The plan of one limb product of nl (M, K) and nl (N, K) int8
    planes with the given element strides (plane, row, K; default
    contiguous) and base addresses, on a card of ``sms`` SMs.

    Refuses (ValueError) nl outside 1..``MAX_NL``, K < 1, and K beyond
    :func:`max_depth` (the route chunks those). Output tiles that fill
    the card run whole; fewer are split over K into as many splits as
    the card holds blocks beside them, each at least
    ``MIN_KT_PER_SPLIT`` K steps, none empty."""
    if not 1 <= nl <= MAX_NL:
        raise ValueError(f"K2 keeps 1..{MAX_NL} limbs live, got nl={nl}")
    if K < 1 or K > max_depth(nl):
        raise ValueError(f"K2 sums K in 1..{max_depth(nl)} exactly in "
                         f"int32 at nl={nl}, got K={K}")
    stages = _stages(nl)
    body = max(stages * 2 * nl * _PLANE, nl * TILE_M * _LDS * 4)
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    ktiles = -(-K // TILE_K)
    splits = 1
    if 0 < tiles < sms:
        splits = max(1, min(sms // tiles, ktiles // MIN_KT_PER_SPLIT))
    kt_per = -(-ktiles // splits)
    splits = -(-ktiles // kt_per)
    a_s = (M * K, K, 1) if a_strides is None else tuple(a_strides)
    b_s = (N * K, K, 1) if b_strides is None else tuple(b_strides)
    return Plan(TILE_M, TILE_N, TILE_K, level_groups(nl), stages,
                body + _BAR_BYTES + _ALIGN, splits, kt_per, tiles,
                not _tma_ok(a_s, a_ptr, nl), not _tma_ok(b_s, b_ptr, nl))


_SMS: dict = {}


def _sms(device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device.index).multi_processor_count
    return n


def plan_for(al, bl) -> Plan:
    """:func:`plan` of the product of these limb planes as the wrapper
    computes it (the SM count of their card; an H100's for CPU
    tensors)."""
    sms = _sms(al.device) if al.device.type == "cuda" else H100_SMS
    nl, M, K = al.shape
    return plan(nl, M, bl.shape[1], K, al.stride(), bl.stride(),
                al.data_ptr(), bl.data_ptr(), sms)


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------

def recombine_base_reference(levels, base, sa, sb, w: int):
    """Plain PyTorch K2 epilogue: ``_level_recombine``'s loop in f64,
    then ``base - U·(sa·sb)`` (``-U·(sa·sb)`` when ``base`` is None)."""
    from dplasma_tpu_torch.kernels.dd import _level_recombine
    prod = _level_recombine(levels, w) * (sa * sb)
    return -prod if base is None else base - prod


def limb_product_base_reference(al, bl, base, sa, sb, w: int):
    """Plain PyTorch fused K2: the plain route's unchunked level sums
    (``dd._limb_levels``: one ``torch._int_mm`` per left limb and the
    level adds), closed by :func:`recombine_base_reference`; with ``sa``
    and ``sb`` None (and no base) the unscaled level recombine."""
    from dplasma_tpu_torch.kernels.dd import _level_recombine, _limb_levels
    nl, _, K = al.shape
    levels = _limb_levels(list(al), [x.T for x in bl], K, w, nl, K)
    if sa is None:
        return _level_recombine(levels, w)
    return recombine_base_reference(levels, base, sa, sb, w)


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------

class _K2Args(ctypes.Structure):
    """``K2Args`` of csrc/recombine.cu: one launch's arguments."""
    _fields_ = [("nl", ctypes.c_int), ("w", ctypes.c_int),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("K", ctypes.c_int),
                ("A", ctypes.c_void_p), ("a_plane", ctypes.c_longlong),
                ("a_row", ctypes.c_longlong),
                ("B", ctypes.c_void_p), ("b_plane", ctypes.c_longlong),
                ("b_row", ctypes.c_longlong),
                ("base", ctypes.c_void_p), ("bs0", ctypes.c_longlong),
                ("bs1", ctypes.c_longlong),
                ("sa", ctypes.c_void_p), ("sas", ctypes.c_longlong),
                ("sb", ctypes.c_void_p), ("sbs", ctypes.c_longlong),
                ("out", ctypes.c_void_p),
                ("bm", ctypes.c_int), ("bn", ctypes.c_int),
                ("bk", ctypes.c_int), ("stages", ctypes.c_int),
                ("smem", ctypes.c_int), ("splits", ctypes.c_int),
                ("kt_per", ctypes.c_int),
                ("ws", ctypes.c_void_p), ("counters", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("batch", ctypes.c_int),
                ("a_batch", ctypes.c_longlong),
                ("b_batch", ctypes.c_longlong),
                ("base_b", ctypes.c_longlong), ("sa_b", ctypes.c_longlong),
                ("sb_b", ctypes.c_longlong), ("out_b", ctypes.c_longlong)]


def _kernel():
    fn = _FNS.get("k2")
    if fn is None:
        from dplasma_tpu_torch.kernels import _build
        fn = _build.load("recombine").dtt_k2_limb_gemm
        fn.argtypes = [ctypes.POINTER(_K2Args)]
        fn.restype = ctypes.c_int
        _FNS["k2"] = fn
    return fn


#: device index -> (int32 workspace, int32 per-tile counters) of the
#: split kernel; both zero between launches (the last split of each tile
#: clears its part)
_SCRATCH: dict = {}


def _scratch(device, ws_ints: int, tiles: int):
    ws, cnt = _SCRATCH.get(device.index, (None, None))
    if ws is None or ws.numel() < ws_ints:
        ws = torch.zeros(max(ws_ints, 1 << 20), dtype=torch.int32,
                         device=device)
    if cnt is None or cnt.numel() < tiles:
        cnt = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
    _SCRATCH[device.index] = (ws, cnt)
    return ws, cnt


#: device index -> the scales of the unscaled form: sa = -1, sb = 1, so
#: the kernel's -(acc·(sa·sb)) is acc bit for bit
_UNIT: dict = {}


def _aligned(x):
    """(nl, R, K) int8 planes copied once into a zero-padded buffer with
    a 16-byte row stride (zeros add nothing to an integer sum)."""
    nl, R, K = x.shape
    buf = torch.zeros((nl, R, -(-K // 16) * 16), dtype=torch.int8,
                      device=x.device)
    buf[:, :, :K] = x
    return buf[:, :, :K]


def _tma_strides(x):
    """Element strides of (nl, R, K) planes as TMA takes them (a plane
    stride for one plane is never read)."""
    sp, sr, sk = x.stride()
    if x.shape[0] == 1:
        sp = 16
    return sp, sr


#: product shape, layout and alignment -> (plan, its _K2Args)
_LAUNCH_ARGS: dict = {}


def _launch(al, bl, base, sa, sb, w: int):
    global LAUNCHES
    dev = al.device
    nl, M, K = al.shape
    N = bl.shape[1]
    out = torch.empty((M, N), dtype=torch.float64, device=dev)
    if M == 0 or N == 0:
        return out
    if sa is None:
        unit = _UNIT.get(dev.index)
        if unit is None:
            unit = _UNIT[dev.index] = torch.tensor(
                [-1.0, 1.0], dtype=torch.float64, device=dev)
        sa, sb = unit[0:1].view(1, 1), unit[1:2].view(1, 1)
    sa = sa.expand(M, 1)
    sb = sb.expand(1, N)
    pa, pb = al.data_ptr(), bl.data_ptr()
    key = (al.shape, bl.shape, al.stride(), bl.stride(), pa % 16, pb % 16,
           None if base is None else base.stride(), sa.stride(0),
           sb.stride(1), w, dev)
    hit = _LAUNCH_ARGS.get(key)
    if hit is None:
        p = plan(nl, M, N, K, al.stride(), bl.stride(), pa, pb, _sms(dev))
        args = _K2Args(
            nl=nl, w=w, M=M, N=N, K=K,
            bs0=0 if base is None else base.stride(0),
            bs1=0 if base is None else base.stride(1),
            sas=sa.stride(0), sbs=sb.stride(1), bm=p.bm, bn=p.bn, bk=p.bk,
            stages=p.stages, smem=p.smem, splits=p.splits,
            kt_per=p.kt_per, batch=1)
        hit = _LAUNCH_ARGS[key] = (p, args)
    p, args = hit
    if p.a_copy:
        al = _aligned(al)
    if p.b_copy:
        bl = _aligned(bl)
    args.a_plane, args.a_row = _tma_strides(al)
    args.b_plane, args.b_row = _tma_strides(bl)
    args.A, args.B = al.data_ptr(), bl.data_ptr()
    args.base = None if base is None else base.data_ptr()
    args.sa, args.sb, args.out = sa.data_ptr(), sb.data_ptr(), out.data_ptr()
    if p.splits > 1:
        ws, cnt = _scratch(dev, p.tiles * nl * TILE_M * TILE_N, p.tiles)
        args.ws, args.counters = ws.data_ptr(), cnt.data_ptr()
    args.stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _kernel()(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err} (nl={nl} "
                           f"M={M} N={N} K={K} {p})")
    LAUNCHES += 1
    return out


def limb_product_base(al, bl, base, sa, sb, w: int):
    """``base - (sa·sb)·Σ_l 2^(-w(l+2))·Σ_{i+j=l} al[i] @ bl[j]ᵀ`` in
    f64, the exact limb product closed in one launch.

    ``al``: (nl, M, K) int8 limb planes, unit stride along K (any plane
    and row strides; those TMA cannot take are copied once, zero-padded);
    ``bl``: (nl, N, K) likewise; ``base``: f64 (M, N), any strides, or
    None (zero); ``sa``/``sb``: f64 power-of-two scales broadcastable to
    (M, 1) / (1, N), any strides and sign (callers negate to add the
    product), or both None with no base for the unscaled level recombine.
    K must lie in 1..:func:`max_depth` (nl). Returns a new f64 (M, N)
    tensor."""
    global ROUTED
    if al.ndim != 3 or bl.ndim != 3 or al.dtype != torch.int8 or \
            bl.dtype != torch.int8:
        raise TypeError(f"K2 takes int8 (nl, M, K) and (nl, N, K) limb "
                        f"planes, got {al.dtype} {tuple(al.shape)} and "
                        f"{bl.dtype} {tuple(bl.shape)}")
    nl, M, K = al.shape
    if bl.shape[0] != nl or bl.shape[2] != K:
        raise ValueError(f"K2 limb planes disagree: {tuple(al.shape)} "
                         f"{tuple(bl.shape)}")
    N = bl.shape[1]
    if (sa is None) != (sb is None) or (sa is None and base is not None):
        raise ValueError("K2 takes both scales, or neither and no base")
    if base is not None and (base.dtype != torch.float64
                             or tuple(base.shape) != (M, N)):
        raise TypeError(f"K2 takes an f64 ({M}, {N}) base, got "
                        f"{base.dtype} {tuple(base.shape)}")
    for s, want in ((sa, (M, 1)), (sb, (1, N))):
        if s is not None and (s.dtype != torch.float64 or s.ndim != 2 or
                              any(d not in (1, e)
                                  for d, e in zip(s.shape, want))):
            raise TypeError(f"K2 takes f64 scales broadcastable to {want}, "
                            f"got {s.dtype} {tuple(s.shape)}")
    if al.stride(2) != 1 or bl.stride(2) != 1:
        raise ValueError("K2 takes limb planes with unit stride along K")
    if K < 1 or K > max_depth(nl):
        raise ValueError(f"K2 sums K in 1..{max_depth(nl)} exactly at "
                         f"nl={nl}, got K={K} (chunk deeper products)")
    devs = {x.device for x in (al, bl, base, sa, sb) if x is not None}
    if len(devs) != 1:
        raise ValueError(f"K2 operands on different devices: {devs}")
    ROUTED += 1
    if _pk.is_batched(al, bl, base, sa, sb):
        # inside torch.func.vmap: one batched launch for the whole batch
        return torch.ops.dtt.k2_limb_gemm(al, bl, base, sa, sb, w)
    if al.device.type == "cpu":
        return limb_product_base_reference(al, bl, base, sa, sb, w)
    if al.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda (or cpu), not {al.device}")
    return _launch(al, bl, base, sa, sb, w)


def recombine_base(lv, base, sa, sb, w: int):
    """``base - (sa * sb) * sum_l lv[l] * 2^(-w(l+2))`` in f64 from a
    level tensor: the reference's API, for CPU tensors (the plain
    route's epilogue there). On the card the recombine runs only fused
    into the limb product (:func:`limb_product_base`).

    ``lv``: the levels, an int32 (nl, M, N) tensor; ``base``: f64
    (M, N), any strides, or None (zero); ``sa``/``sb``: f64 power-of-two
    scales broadcastable to (M, 1) / (1, N), any sign. Returns a new f64
    (M, N) tensor."""
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
    if lv.device.type != "cpu":
        raise ValueError(f"K2's recombine runs on {lv.device} only fused "
                         "into the limb product (limb_product_base)")
    ROUTED += 1
    return recombine_base_reference(lv, base, sa, sb, w)


# ---------------------------------------------------------------------
# The batched form: one launch for the limb products of a batch
# ---------------------------------------------------------------------

def limb_product_base_batched_reference(al, bl, base, sa, sb, w: int):
    """Plain PyTorch batched K2: :func:`limb_product_base_reference` of
    each element of (B, nl, M, K) / (B, nl, N, K) stacks (``base`` (B, M,
    N) or None, ``sa`` (B, M|1, 1), ``sb`` (B, 1, N|1) or both None),
    stacked."""
    return torch.stack([
        limb_product_base_reference(
            al[i], bl[i], None if base is None else base[i],
            None if sa is None else sa[i], None if sb is None else sb[i], w)
        for i in range(al.shape[0])])


def _aligned_batched(x):
    """(B, nl, R, K) planes copied once into a zero-padded buffer with a
    16-byte row stride (a broadcast stack stays one element)."""
    if x.stride(0) == 0:
        return _aligned(x[0]).unsqueeze(0).expand(x.shape)
    B, nl, R, K = x.shape
    buf = torch.zeros((B, nl, R, -(-K // 16) * 16), dtype=torch.int8,
                      device=x.device)
    buf[..., :K] = x
    return buf[..., :K]


def _launch_batched(al, bl, base, sa, sb, w: int):
    """One K2 launch over (B, nl, M, K) / (B, nl, N, K) stacks: each
    element's 2-D plan, batch strides in the arguments, workspace and tile
    counters per element."""
    global LAUNCHES, BATCHED_LAUNCHES
    dev = al.device
    B, nl, M, K = al.shape
    N = bl.shape[2]
    out = torch.empty((B, M, N), dtype=torch.float64, device=dev)
    if M == 0 or N == 0 or B == 0:
        return out
    if sa is None:
        unit = _UNIT.get(dev.index)
        if unit is None:
            unit = _UNIT[dev.index] = torch.tensor(
                [-1.0, 1.0], dtype=torch.float64, device=dev)
        sa, sb = unit[0:1].view(1, 1, 1), unit[1:2].view(1, 1, 1)
    sa = sa.expand(B, M, 1)
    sb = sb.expand(B, 1, N)
    ok = [_tma_ok(x.stride()[1:], x.data_ptr(), nl)
          and x.stride(0) % 16 == 0 for x in (al, bl)]
    if not ok[0]:
        al = _aligned_batched(al)
    if not ok[1]:
        bl = _aligned_batched(bl)
    pa, pb = al.data_ptr(), bl.data_ptr()
    key = ("batched", al.shape, bl.shape, al.stride(), bl.stride(), pa % 16,
           pb % 16, None if base is None else base.stride(), sa.stride(),
           sb.stride(), w, dev)
    hit = _LAUNCH_ARGS.get(key)
    if hit is None:
        p = plan(nl, M, N, K, al.stride()[1:], bl.stride()[1:], pa, pb,
                 _sms(dev))
        args = _K2Args(
            nl=nl, w=w, M=M, N=N, K=K,
            bs0=0 if base is None else base.stride(1),
            bs1=0 if base is None else base.stride(2),
            sas=sa.stride(1), sbs=sb.stride(2), bm=p.bm, bn=p.bn, bk=p.bk,
            stages=p.stages, smem=p.smem, splits=p.splits,
            kt_per=p.kt_per, batch=B, a_batch=al.stride(0),
            b_batch=bl.stride(0),
            base_b=0 if base is None else base.stride(0),
            sa_b=sa.stride(0), sb_b=sb.stride(0), out_b=M * N)
        hit = _LAUNCH_ARGS[key] = (p, args)
    p, args = hit
    args.a_plane, args.a_row = _tma_strides(al[0])
    args.b_plane, args.b_row = _tma_strides(bl[0])
    args.A, args.B = pa, pb
    args.base = None if base is None else base.data_ptr()
    args.sa, args.sb, args.out = sa.data_ptr(), sb.data_ptr(), out.data_ptr()
    if p.splits > 1:
        ws, cnt = _scratch(dev, B * p.tiles * nl * TILE_M * TILE_N,
                           B * p.tiles)
        args.ws, args.counters = ws.data_ptr(), cnt.data_ptr()
    args.stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _kernel()(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"K2 batched launch failed: cudaError {err} "
                           f"(B={B} nl={nl} M={M} N={N} K={K} {p})")
    LAUNCHES += 1
    BATCHED_LAUNCHES += 1
    return out


def limb_product_base_batched(al, bl, base, sa, sb, w: int):
    """:func:`limb_product_base` of every element of a batch in one
    launch: ``al`` (B, nl, M, K) and ``bl`` (B, nl, N, K) int8 planes,
    unit stride along K; ``base`` f64 (B, M, N) or None; ``sa`` / ``sb``
    f64 broadcastable to (B, M, 1) / (B, 1, N), or both None with no base.
    A batch stride of 0 broadcasts one element. On a CPU tensor the plain
    :func:`limb_product_base_batched_reference`; on a CUDA tensor one
    launch or a raise."""
    if al.ndim != 4 or bl.ndim != 4 or al.dtype != torch.int8 or \
            bl.dtype != torch.int8:
        raise TypeError(f"batched K2 takes int8 (B, nl, M, K) and (B, nl, "
                        f"N, K) limb planes, got {al.dtype} "
                        f"{tuple(al.shape)} and {bl.dtype} "
                        f"{tuple(bl.shape)}")
    B, nl, M, K = al.shape
    if bl.shape[0] != B or bl.shape[1] != nl or bl.shape[3] != K:
        raise ValueError(f"batched K2 limb planes disagree: "
                         f"{tuple(al.shape)} {tuple(bl.shape)}")
    N = bl.shape[2]
    if (sa is None) != (sb is None) or (sa is None and base is not None):
        raise ValueError("K2 takes both scales, or neither and no base")
    if base is not None and (base.dtype != torch.float64
                             or tuple(base.shape) != (B, M, N)):
        raise TypeError(f"batched K2 takes an f64 ({B}, {M}, {N}) base, "
                        f"got {base.dtype} {tuple(base.shape)}")
    for s, want in ((sa, (B, M, 1)), (sb, (B, 1, N))):
        if s is not None and (s.dtype != torch.float64 or s.ndim != 3 or
                              any(d not in (1, e)
                                  for d, e in zip(s.shape, want))):
            raise TypeError(f"batched K2 takes f64 scales broadcastable to "
                            f"{want}, got {s.dtype} {tuple(s.shape)}")
    if al.stride(3) != 1 or bl.stride(3) != 1:
        raise ValueError("K2 takes limb planes with unit stride along K")
    if K < 1 or K > max_depth(nl):
        raise ValueError(f"K2 sums K in 1..{max_depth(nl)} exactly at "
                         f"nl={nl}, got K={K} (chunk deeper products)")
    if B > 65535:
        raise ValueError(f"batched K2 takes at most 65535 elements, got {B}")
    devs = {x.device for x in (al, bl, base, sa, sb) if x is not None}
    if len(devs) != 1:
        raise ValueError(f"K2 operands on different devices: {devs}")
    if al.device.type == "cpu":
        if sa is not None:
            sa, sb = sa.expand(B, *sa.shape[1:]), sb.expand(B, *sb.shape[1:])
        return limb_product_base_batched_reference(al, bl, base, sa, sb, w)
    if al.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda (or cpu), not {al.device}")
    return _launch_batched(al, bl, base, sa, sb, w)


@torch.library.custom_op("dtt::k2_limb_gemm", mutates_args=())
def _k2_op(al: torch.Tensor, bl: torch.Tensor, base: Optional[torch.Tensor],
           sa: Optional[torch.Tensor], sb: Optional[torch.Tensor],
           w: int) -> torch.Tensor:
    """K2 as a custom op. Reached only from :func:`limb_product_base` on
    batched planes; called outside vmap it is a batch of one."""
    one = [None if x is None else x[None] for x in (base, sa, sb)]
    return limb_product_base_batched(al[None], bl[None], *one, w)[0]


@_k2_op.register_fake
def _(al, bl, base, sa, sb, w):
    return al.new_empty((al.shape[1], bl.shape[1]), dtype=torch.float64)


def _k2_vmap(info, in_dims, al, bl, base, sa, sb, w):
    """The vmap rule: the batch axis to the front, ONE batched launch."""
    n = info.batch_size
    args = [_pk.front(x, d, n) for x, d in zip((al, bl, base, sa, sb),
                                                in_dims[:5])]
    return limb_product_base_batched(*args, w), 0


torch.library.register_vmap("dtt::k2_limb_gemm", _k2_vmap)
