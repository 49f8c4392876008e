"""KW, the successive-band-reduction sweeps with b <= 128, on Hopper.

A kernel of the port with no Pallas counterpart: the reference runs each
step of a sweep as plain JAX inside one ``lax.scan`` with ``jax.vmap``
over the independent windows of the step (``dplasma_tpu/ops/band.py``:
``one`` of ``herm_sbr_sweep_banded`` :460-482, ``qr_one`` / ``lq_one`` of
``bidiag_sbr_sweep`` :291-307), so XLA compiles the whole sweep once.
Eager PyTorch would pay launch and Python cost on every one of a chain's
tens of thousands of steps, and torch's batched QR of the wide sweeps'
windows is a library call per step. KW runs a range of steps of one sweep
in one persistent launch: ``csrc/sbr_window.cu``, CUDA C++ for
``sm_90a``. A sweep on the ``kw`` route (``ops/band.py``) is one launch.

Design (the source has the details): a window is V lines of b elements
in shared memory, and one Householder QR runs over it with LAPACK
``larfg`` conventions (β = −sign(Re α)·‖(α, x)‖, τ = 0 when x = 0 and
Im α = 0, as ``torch.geqrf`` gives them), each reflector stored in
place and applied as it is made. The Hermitian step holds only its row
strip: its column strip is written as the mirror of the updated rows, and
its trailing b×b block takes the right-hand pass. The LQ step holds its
column strip conjugated, so it is the same left-hand QR. Three launch
forms (:func:`plan`): one warp a window (several windows a block) for
the narrow sweeps where that measured faster, one block a window, or a
thread-block cluster of 2-8 CTAs a window where a bidiagonal window does
not fit one block's 227 KB. Blocks stride over
the window slots of a step; a grid barrier in global memory orders the
steps. Sums run in a fixed order, so a launch over [0, T) is bitwise
equal to T launches of one step (:func:`herm_step`, :func:`bidiag_step`,
kept for replays and the card tests), and the forms agree bitwise.

What bounds it: neither bytes nor operations. A step moves its strips
once each way and does ~4·b²·V flops a window, microseconds of work at
the card's rates; the chain of b reflectors per window, each a
reduction and two barriers, and the grid barrier between steps take the
time (PERF.md has the numbers).

The plain versions (:func:`herm_step_reference`,
:func:`bidiag_step_reference`) are the batched torch route: the
reference's window step with its ``vmap`` axis written out (batched
``torch.geqrf``, ``householder.larft`` and the two compact-WY applies
on 3-D tensors). The band sweeps take that route for what KW refuses,
and the wrappers take it for a CPU tensor, step by step. On a CUDA tensor
the wrappers launch KW or raise. ``ROUTED`` counts wrapper calls on any
device, ``LAUNCHES`` the CUDA launches and ``STEPS`` the sweep steps
those launches ran.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from dplasma_tpu_torch.kernels import householder as hh

#: widest band the kernel takes
MAX_B = 128
#: bytes of shared memory one block may use (H100: 227 KB)
SMEM_MAX = 232448
#: bands up to this may run one warp a window
WARP_MAX_B = 8
#: (kind, b, dtype) of the narrow sweeps that take the warp form: where it
#: measured faster than one block a window. chip_smoke phase 16 times both
#: forms of every narrow sweep it replays in the order A B B A; on an H100
#: 80GB HBM3 at 700 W, f32 herm 4->1 at N=8192 took 193.25 / 193.16 ms
#: warp, 207.61 / 208.32 ms block, and the block form was ahead in the
#: other 8 (sweep, dtype) pairs (herm 7->1 f32 319.37 / 319.38 against
#: 347.33 / 347.22)
WARP_FORM = {("herm", 4, torch.float32)}
#: windows a block in the warp form
WARP_WINDOWS = 4
#: CTAs a cluster may hold (the portable limit)
MAX_CLUSTER = 8

#: wrapper calls on any device
ROUTED = 0
#: CUDA launches of KW
LAUNCHES = 0
#: sweep steps those launches ran
STEPS = 0

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
_ISZ = {torch.float32: 4, torch.float64: 8, torch.complex64: 8,
        torch.complex128: 16}
_FORMS = {"warp": 0, "block": 1, "cluster": 2}
_FN: list = []


def reset_counts() -> None:
    global ROUTED, LAUNCHES, STEPS
    ROUTED = 0
    LAUNCHES = 0
    STEPS = 0


class HermGeom(NamedTuple):
    """One Hermitian band-storage sweep: G window slots at stride S rows
    of the column-major full-band storage F (row width H = 2D+1), band b,
    window V = 3b + w."""
    G: int
    S: int
    V: int
    b: int
    H: int
    D: int


class BidiagGeom(NamedTuple):
    """One bidiagonal dense-layout sweep: G window slots of V×V in the
    padded matrix X (row stride ld), band b."""
    G: int
    V: int
    b: int
    ld: int


class Plan(NamedTuple):
    """How KW launches a sweep: ``form`` "warp" (``wpb`` windows a
    block), "block" or "cluster" (``ncta`` CTAs a window), ``threads`` a
    block and ``smem`` bytes of shared memory a block."""
    form: str
    ncta: int
    threads: int
    wpb: int
    smem: int


def _threads(lines: int) -> int:
    return min(512, max(64, -(-lines // 32) * 32))


def line_stride(b: int, dtype) -> int:
    """A window line's stride in shared memory, in elements: a whole
    number of 16-byte vectors, odd (against bank conflicts), >= b."""
    E = 16 // _ISZ[dtype]
    m = -(-b // E)
    return (m + 1 - m % 2) * E


def plan(b: int, V: int, dtype, kind: str,
         form: Optional[str] = None) -> Optional[Plan]:
    """KW's launch of a ``kind`` ("herm" or "bidiag") sweep of band ``b``
    and window ``V`` in ``dtype``, or None where KW refuses it. A window
    holds V lines of b elements at :func:`line_stride` (plus its taus; a
    cluster CTA also one reflector copy). ``form`` None takes the warp
    form where :data:`WARP_FORM` lists the sweep, else one block, else
    (bidiag only) the smallest cluster of 2, 4 or 8 CTAs whose share of
    the lines fits :data:`SMEM_MAX`; ``form`` "warp" (b <=
    :data:`WARP_MAX_B`) or "block" forces one, so the two narrow forms
    can be timed side by side (chip_smoke phase 16's ``[kw]`` lines, on
    which :data:`WARP_FORM` rests)."""
    if not (1 <= b <= MAX_B and b <= V <= 4 * b) or dtype not in _ISZ:
        return None
    isz, LS = _ISZ[dtype], line_stride(b, dtype)
    E = 16 // isz
    if form is None:
        form = "warp" if (kind, b, dtype) in WARP_FORM else "block"
    if form == "warp" and b <= WARP_MAX_B:
        smem = WARP_WINDOWS * (V * LS + -(-b // E) * E) * isz
        if smem <= SMEM_MAX:
            return Plan("warp", 1, 32 * WARP_WINDOWS, WARP_WINDOWS, smem)
    smem = (V * LS + b) * isz
    if smem <= SMEM_MAX:
        return Plan("block", 1, _threads(V), 1, smem)
    if kind != "bidiag":
        return None
    n = 2
    while n <= MAX_CLUSTER:
        P = -(-V // n)
        smem = (P * LS + LS + b + 1) * isz
        if smem <= SMEM_MAX:
            return Plan("cluster", n, _threads(P), 1, smem)
        n *= 2
    return None


def eligible(b: int, V: int, dtype, kind: str) -> int:
    """Does a ``kind`` sweep of band ``b``, window ``V``, in ``dtype``
    take KW? The CTAs a window needs (1 for one block or warp), 0 where
    KW refuses it (b > :data:`MAX_B`, or more than :data:`MAX_CLUSTER`
    CTAs, or a Hermitian window larger than one block)."""
    p = plan(b, V, dtype, kind)
    return 0 if p is None else p.ncta


class HermTabs(NamedTuple):
    """A Hermitian sweep's step tables on the device: ``base`` (T,) int64,
    the F row of slot 0's anchor at each step; ``u`` (T, G) int32, the
    elimination widths; and, from the host, ``rows`` = [lo, hi), the F
    rows its windows span."""
    base: torch.Tensor
    u: torch.Tensor
    rows: tuple


class BidiagTabs(NamedTuple):
    """A bidiagonal sweep's step tables on the device, (T, G) int32 each:
    window anchors ``c0``, widths ``u``, LQ column offsets ``off``; and,
    from the host, ``rows`` = [lo, hi), the rows and columns of X its
    windows span."""
    c0: torch.Tensor
    u: torch.Tensor
    off: torch.Tensor
    rows: tuple


def _dev(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def herm_tabs(base, u, geom: HermGeom, device) -> HermTabs:
    """The device tables of a Hermitian sweep from its host schedule
    (``base`` (T,) F rows of slot 0, ``u`` (T, G))."""
    lo = int(np.min(base))
    hi = int(np.max(base)) + (geom.G - 1) * geom.S + geom.V
    return HermTabs(_dev(base, np.int64, device), _dev(u, np.int32, device),
                    (lo, hi))


def bidiag_tabs(c0, u, off, geom: BidiagGeom, device) -> BidiagTabs:
    """The device tables of a bidiagonal sweep from its host schedule."""
    return BidiagTabs(_dev(c0, np.int32, device), _dev(u, np.int32, device),
                      _dev(off, np.int32, device),
                      (int(np.min(c0)), int(np.max(c0)) + geom.V))


def herm_views(F, bs: int, geom: HermGeom):
    """The G windows' row strips R[g, i, t'] = A[c0+b+i, c0+t'] (G, b, V)
    and column strips C[g, r, j] = A[c0+r, c0+b+j] (G, V, b) as strided
    views of F, where slot g's anchor column c0 sits at F row bs + g·S:
    F[L0 + c, D + r − c] = A[r, c], so each strip is one affine map of
    the storage (the reference's shear, with no copy)."""
    G, S, V, b, H, D = geom
    o = F.storage_offset() + bs * H
    R = F.as_strided((G, b, V), (S * H, 1, H - 1), o + D + b)
    C = F.as_strided((G, V, b), (S * H, 1, H - 1), o + b * H + D - b)
    return R, C


def masked_block(R, u, b: int):
    """The QR block of each window: the first b columns of R with only
    the last u kept, rolled to the front (the reference's mask and
    ``jnp.roll(blk, u − b, axis=1)``; a per-window gather here)."""
    G = R.shape[0]
    cols = torch.arange(b, device=R.device)
    blk = R[:, :, :b]
    blk = torch.where((cols[None, :] >= (b - u)[:, None])[:, None, :], blk,
                      torch.zeros((), dtype=R.dtype, device=R.device))
    idx = (cols[None, :] + b - u[:, None]) % b
    return torch.gather(blk, 2, idx[:, None, :].expand(G, b, b))


def herm_window(R, v, t, b: int):
    """The two-sided update of the windows (leading window axis, or one
    2-D window; R may carry zero rows past b, as the K1 route pads it)
    given their reflectors:
    (R2, C2), the new row and column strips. The unchanged rows of the
    column strip are the Hermitian mirror of the ORIGINAL row strip; its
    mixed rows carry the left-updated block untransposed, as the
    reference's ``one`` builds them."""
    R1 = hh.apply_q(v, t, R, trans="C")
    C1 = R.conj().mT.clone()
    C1[..., b:2 * b, :b] = R1[..., :b, b:2 * b]
    C2 = hh.apply_q_right(v, t, C1, trans="N")
    R2 = R1.clone()
    R2[..., :b, b:2 * b] = C2[..., b:2 * b, :b]
    return R2, C2


def herm_step_reference(F, bs: int, u, geom: HermGeom,
                        factor=torch.geqrf) -> None:
    """Plain KW, Hermitian band-storage step, in place on F: batched
    masked QR of every window's block and the two-sided compact-WY
    update. ``u`` (G,) holds the elimination widths (0: an inactive slot,
    whose update is the identity on the row strip and rewrites the column
    strip as its mirror, as the reference's does). ``factor`` is the
    batched QR, (G, b, b) -> (packed, taus)."""
    b = geom.b
    Rv, Cv = herm_views(F, bs, geom)
    R = Rv.clone()
    packed, taus = factor(masked_block(R, u, b))
    v, _ = hh.split_qr(packed)
    R2, C2 = herm_window(R, v, hh.larft(v, taus), b)
    Rv.copy_(R2)
    Cv.copy_(C2)


def window_index(c0, rows: int, cols: int, r_off, c_off, ld: int):
    """Flat indices of the (G, rows, cols) blocks X[c0+r_off+r,
    c0+c_off+c] of a row-major X with row stride ``ld`` (``c0`` and the
    offsets per slot, or scalars)."""
    dev = c0.device
    c0 = c0.to(torch.int64)
    r = torch.arange(rows, device=dev, dtype=torch.int64)
    c = torch.arange(cols, device=dev, dtype=torch.int64)
    base = (c0 + r_off) * ld + c0 + c_off
    return base[:, None, None] + r[None, :, None] * ld + c[None, None, :]


def bidiag_index(c0, off, geom: BidiagGeom, qr: bool):
    """Flat indices into X of each slot's strip: the QR step's rows
    X[c0+i, c0+t'] (G, b, V), the LQ step's columns X[c0+r, c0+off+j]
    (G, V, b)."""
    G, V, b, ld = geom
    if qr:
        return window_index(c0, b, V, 0, 0, ld)
    return window_index(c0, V, b, 0, off.to(torch.int64), ld)


def bidiag_step_reference(X, c0, u, off, geom: BidiagGeom, qr: bool,
                          factor=torch.geqrf) -> None:
    """Plain KW, bidiagonal dense-layout step, in place on X: the QR
    step (``qr``) factors each window's leading b×b block and applies
    Q^H to its b×V row strip; the LQ step factors the conjugate transpose
    of the b×b block at column ``off`` with rows >= u masked and applies
    Q to its V×b column strip from the right. ``factor`` as in
    :func:`herm_step_reference`."""
    b = geom.b
    idx = bidiag_index(c0, off, geom, qr)
    flat = X.view(-1)
    W = flat[idx]
    if qr:
        packed, taus = factor(W[:, :, :b])
        v, _ = hh.split_qr(packed)
        W = hh.apply_q(v, hh.larft(v, taus), W, trans="C")
    else:
        rows = torch.arange(b, device=X.device)
        blk = torch.where((rows[None, :] < u[:, None])[:, :, None],
                          W[:, :b, :],
                          torch.zeros((), dtype=X.dtype, device=X.device))
        packed, taus = factor(blk.conj().mT)
        v, _ = hh.split_qr(packed)
        W = hh.apply_q_right(v, hh.larft(v, taus), W, trans="N")
    flat[idx] = W


# ---------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------

def _lib():
    if not _FN:
        from dplasma_tpu_torch.kernels import _build
        lib = _build.load("sbr_window")
        fn = lib.dtt_kw_sweep
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_longlong] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 2)
        _FN.append(fn)
    return _FN[0]


def _check(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"KW {what}: runs on cuda (or cpu), not "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"KW {what}: storage must be contiguous")
    if t.dtype not in _DTYPES:
        raise TypeError(f"KW {what}: takes {sorted(map(str, _DTYPES))}, "
                        f"got {t.dtype}")


def _check_tabs(A, tabs, shapes, t0: int, t1: int, what: str):
    T = tabs.u.shape[0]
    if not 0 <= t0 < t1 <= T:
        raise ValueError(f"KW {what}: steps [{t0}, {t1}) outside [0, {T})")
    for name, (dt, shape) in shapes.items():
        x = getattr(tabs, name)
        if (x.device != A.device or x.dtype != dt or not x.is_contiguous()
                or tuple(x.shape) != shape):
            raise ValueError(f"KW {what}: table {name} must be a "
                             f"contiguous {dt} {shape} on {A.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _launch(A, herm: bool, tabs, t0: int, t1: int, geom, pl: Plan,
            what: str) -> None:
    global LAUNCHES, STEPS
    fn = _lib()
    dev = A.device
    # the grid barrier's counter, this launch's own: zeroed on the
    # launch's stream, and freed to that stream after it
    bar = (torch.zeros(1, dtype=torch.int64, device=dev) if t1 - t0 > 1
           else None)
    if herm:
        G, S, V, b, H, D = geom
        ld, ptrs = 0, (tabs.base.data_ptr(), 0, tabs.u.data_ptr(), 0)
    else:
        G, V, b, ld = geom
        S = H = D = 0
        ptrs = (0, tabs.c0.data_ptr(), tabs.u.data_ptr(), tabs.off.data_ptr())
    with torch.cuda.device(dev):
        err = fn(_DTYPES[A.dtype], int(herm), A.data_ptr(), ld, *ptrs, t0,
                 t1, G, V, b, S, H, D, _FORMS[pl.form], pl.ncta, pl.threads,
                 pl.wpb, None if bar is None else bar.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"KW {what} launch failed: error {err} "
                           f"({A.dtype}, {geom}, {pl}, steps [{t0}, {t1}))")
    LAUNCHES += 1
    STEPS += t1 - t0


def herm_steps(F, tabs: HermTabs, t0: int, t1: int, geom: HermGeom,
               form: Optional[str] = None) -> None:
    """Steps [t0, t1) of one Hermitian band-storage sweep, in place on F,
    in one launch (``form`` forces :func:`plan`'s form)."""
    global ROUTED
    G, S, V, b, H, D = geom
    pl = plan(b, V, F.dtype, "herm", form)
    if pl is None:
        raise ValueError(f"KW refuses a herm sweep b={b} V={V} {F.dtype}")
    ROUTED += 1
    if F.device.type == "cpu":
        for t in range(t0, t1):
            herm_step_reference(F, int(tabs.base[t]), tabs.u[t], geom)
        return
    _check(F, "herm steps")
    T = tabs.base.shape[0]
    _check_tabs(F, tabs, {"base": (torch.int64, (T,)),
                          "u": (torch.int32, (T, G))}, t0, t1, "herm steps")
    lo, hi = tabs.rows
    if F.dim() != 2 or F.shape[1] != H or lo < 0 or hi > F.shape[0]:
        raise ValueError(f"KW herm steps: window rows [{lo}, {hi}) outside "
                         f"F {tuple(F.shape)} (row width {H})")
    _launch(F, True, tabs, t0, t1, geom, pl, "herm steps")


def bidiag_steps(X, tabs: BidiagTabs, t0: int, t1: int, geom: BidiagGeom,
                 form: Optional[str] = None) -> None:
    """Steps [t0, t1) of one bidiagonal dense-layout sweep (odd steps QR,
    even LQ), in place on X, in one launch."""
    global ROUTED
    G, V, b, ld = geom
    pl = plan(b, V, X.dtype, "bidiag", form)
    if pl is None:
        raise ValueError(f"KW refuses a bidiag sweep b={b} V={V} {X.dtype}")
    ROUTED += 1
    if X.device.type == "cpu":
        for t in range(t0, t1):
            bidiag_step_reference(X, tabs.c0[t], tabs.u[t], tabs.off[t],
                                  geom, t % 2 == 1)
        return
    _check(X, "bidiag steps")
    T = tabs.u.shape[0]
    _check_tabs(X, tabs, {k: (torch.int32, (T, G))
                          for k in ("c0", "u", "off")}, t0, t1,
                "bidiag steps")
    lo, hi = tabs.rows
    if (X.dim() != 2 or X.shape[1] != ld or lo < 0
            or hi > min(X.shape)):
        raise ValueError(f"KW bidiag steps: X {tuple(X.shape)} (row stride "
                         f"{ld}) does not hold windows [{lo}, {hi})")
    _launch(X, False, tabs, t0, t1, geom, pl, "bidiag steps")


def herm_step(F, tabs: HermTabs, t: int, geom: HermGeom,
              form: Optional[str] = None) -> None:
    """Step ``t`` alone: :func:`herm_steps` over [t, t + 1)."""
    herm_steps(F, tabs, t, t + 1, geom, form)


def bidiag_step(X, tabs: BidiagTabs, t: int, geom: BidiagGeom,
                form: Optional[str] = None) -> None:
    """Step ``t`` alone: :func:`bidiag_steps` over [t, t + 1)."""
    bidiag_steps(X, tabs, t, t + 1, geom, form)
