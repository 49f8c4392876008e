"""KW, one step of a narrow successive-band-reduction sweep, on Hopper.

A kernel of the port with no Pallas counterpart: the reference runs the
step as plain JAX inside ``lax.scan`` with ``jax.vmap`` over the
independent windows of the step (``dplasma_tpu/ops/band.py``: ``one``
of ``herm_sbr_sweep_banded`` :460-482, ``qr_one`` / ``lq_one`` of
``bidiag_sbr_sweep`` :291-307), compiled once. Eager PyTorch pays launch
and Python cost on every step instead, and the sweeps with b <= 32 hold
94-97% of the steps of a chain (tens of thousands at N = 8192), each a
batch of up to a thousand b×b QRs and two strip applies. KW does one
step in one launch: ``csrc/sbr_window.cu``, CUDA C++ for ``sm_90a``.

Design: one thread block per window slot of the step. The block copies
its strips into shared memory (the herm step's row strip R, b×V, and
its column strip, V×b; the bidiag QR step's b×V rows or the LQ step's
V×b columns: at most 123 KB in complex128 at b = 32), runs the masked
Householder QR column by column with LAPACK ``larfg`` conventions
(β = −sign(Re α)·‖(α, x)‖, τ = 0 when x = 0 and Im α = 0, as
``torch.geqrf`` gives them; not K4's τ = 2 rule), applies each
reflector to the row strip from the left and to the column strip from
the right as it is made, and writes the strips back in place. The
step tables (window anchors, elimination widths, offsets) live on the
device; the host loop passes the step index and nothing else, with no
slicing and no synchronisation per step.

What bounds it: neither bytes nor operations. A step moves 2·G·b·V
elements each way and does ~8·G·b²·V flops, microseconds of work at the
card's rates; the block's chain of b reflectors, each a reduction and a
barrier, and the launch itself take the time (PERF.md has the numbers).

The plain versions (:func:`herm_step_reference`,
:func:`bidiag_step_reference`) are the batched torch route: the
reference's window step with its ``vmap`` axis written out (batched
``torch.geqrf``, ``householder.larft`` and the two compact-WY applies
on 3-D tensors). The band sweeps take that route directly for b > 32,
and the wrappers take it for a CPU tensor. On a CUDA tensor the
wrappers launch KW or raise. ``ROUTED`` counts wrapper calls on any
device, ``LAUNCHES`` the CUDA launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dplasma_tpu_torch.kernels import householder as hh

#: widest band the kernel takes (its shared-memory plan)
MAX_B = 32

#: wrapper calls on any device
ROUTED = 0
#: CUDA launches of KW
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
_FNS: dict = {}


def reset_counts() -> None:
    global ROUTED, LAUNCHES
    ROUTED = 0
    LAUNCHES = 0


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


def eligible(b: int) -> bool:
    """Does a sweep of band ``b`` take KW? (b <= :data:`MAX_B`)"""
    return 1 <= b <= MAX_B


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

def _kernel(entry: str):
    fn = _FNS.get(entry)
    if fn is None:
        from dplasma_tpu_torch.kernels import _build
        lib = _build.load("sbr_window")
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


def _check(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"KW {what}: runs on cuda (or cpu), not "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"KW {what}: storage must be contiguous")
    if t.dtype not in _DTYPES:
        raise TypeError(f"KW {what}: takes {sorted(map(str, _DTYPES))}, "
                        f"got {t.dtype}")


def herm_step(F, bs: int, u_tab, t: int, geom: HermGeom) -> None:
    """One Hermitian band-storage step of a sweep with b <= 32, in place
    on F. ``u_tab`` is the sweep's (T, G) int32 table of elimination
    widths on F's device, ``t`` the step, ``bs`` the F row of slot 0's
    anchor."""
    global ROUTED, LAUNCHES
    G, S, V, b, H, D = geom
    if not eligible(b):
        raise ValueError(f"KW takes b <= {MAX_B}, got {b}")
    ROUTED += 1
    if F.device.type == "cpu":
        herm_step_reference(F, bs, u_tab[t], geom)
        return
    _check(F, "herm step")
    if bs < 0 or (bs + G * S) * H > F.numel():
        raise ValueError(f"KW herm step: window rows [{bs}, "
                         f"{bs + G * S}) outside F {tuple(F.shape)}")
    fn = _kernel("dtt_kw_herm_step")
    with torch.cuda.device(F.device):
        err = fn(ctypes.c_int(_DTYPES[F.dtype]), ctypes.c_void_p(F.data_ptr()),
                 ctypes.c_longlong(bs),
                 ctypes.c_void_p(u_tab.data_ptr() + 4 * t * G),
                 ctypes.c_int(G), ctypes.c_int(S), ctypes.c_int(V),
                 ctypes.c_int(b), ctypes.c_int(H), ctypes.c_int(D),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"KW herm step launch failed: cudaError {err} "
                           f"({F.dtype}, {geom})")
    LAUNCHES += 1


def bidiag_step(X, tabs, t: int, geom: BidiagGeom, qr: bool) -> None:
    """One bidiagonal dense-layout step (QR when ``qr``, else LQ) of a
    sweep with b <= 32, in place on X. ``tabs`` = (c0, u, off), the
    sweep's (T, G) int32 tables on X's device."""
    global ROUTED, LAUNCHES
    G, V, b, ld = geom
    if not eligible(b):
        raise ValueError(f"KW takes b <= {MAX_B}, got {b}")
    c0, u, off = tabs
    ROUTED += 1
    if X.device.type == "cpu":
        bidiag_step_reference(X, c0[t], u[t], off[t], geom, qr)
        return
    _check(X, "bidiag step")
    if X.dim() != 2 or X.shape[1] != ld:
        raise ValueError(f"KW bidiag step: X {tuple(X.shape)} does not "
                         f"have row stride {ld}")
    fn = _kernel("dtt_kw_bidiag_step")
    o = 4 * t * G
    with torch.cuda.device(X.device):
        err = fn(ctypes.c_int(_DTYPES[X.dtype]), ctypes.c_int(int(qr)),
                 ctypes.c_void_p(X.data_ptr()), ctypes.c_longlong(ld),
                 ctypes.c_void_p(c0.data_ptr() + o),
                 ctypes.c_void_p(u.data_ptr() + o),
                 ctypes.c_void_p(off.data_ptr() + o),
                 ctypes.c_int(G), ctypes.c_int(V), ctypes.c_int(b),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"KW bidiag step launch failed: cudaError "
                           f"{err} ({X.dtype}, {geom}, qr={qr})")
    LAUNCHES += 1
