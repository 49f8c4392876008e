"""Band → tridiagonal / bidiagonal: the stage-2 sweeps and chases.

Ports ``dplasma_tpu/ops/band.py``. The reference's stage 2
(``zhbrdt.jdf:41-60``; ``tests/testing_zgesvd.c:106-145`` via
``zgbbrd``) is a long sequential chain of tiny steps. Its schedules are
pure index algebra, computed once on the host; the execution is a loop
over them.

* **Pipelined SBR sweeps** (the drivers' default): each sweep takes the
  band b → w = b/4 by panel QRs and bulge-chasing QRs in windows of
  V = 3b + w; the G windows of one step are independent (the
  reference's ``vmap``), here a leading window axis. Hermitian bands run
  on column-major full-band storage ``F`` (:func:`herm_sbr_sweep_banded`,
  its windows strided views of F: :func:`kernels.sbr.herm_views`),
  bidiagonal bands on the padded dense matrix
  (:func:`bidiag_sbr_sweep`, its windows one indexed gather and one
  scatter per step). A sweep takes one of three routes: kernel KW
  (``kernels/sbr.py``) for every window it takes (b <= 128: at the
  drivers' default nb = 256 the Hermitian 64-, 16- and 4-wide sweeps
  and the bidiagonal 127-, 31- and 7-wide ones, in every dtype), the
  whole sweep in one launch; one 2-D product per window through
  ``blas.dot`` (hence K1) where the reference's K1 gate admits the
  window's products (f32, b and V >= 256: the first sweep of the
  drivers' default chains); else the batched torch route (KW's plain
  version), step by step.
* **Givens chases** (``hbrdt(method="chase")``, a ``BandMatrix`` input,
  ``gebrd(method="chase")``): one rotation per step, plain torch.

Every schedule is cached on the host per argument set
(``functools.lru_cache``, the :data:`SCHEDULES_KEPT` most recent of each
builder: one chain's sweeps and more), so a timed run after the warm-up
builds none of them; each sweep call copies its tables to the device
(the Hermitian sweep's bases too) and frees them when it ends
(milliseconds at N = 8192).

Stage 2's window products stay in the working dtype under MCA
``dd_gemm=always``: the reference would send each b×b product to the
limb route, which only emulates on a TPU what Hopper does natively
(ROADMAP queue 3).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.kernels import pallas_kernels as _pk
from dplasma_tpu_torch.kernels import sbr


def _lartg(f, g):
    """Complex-safe Givens: (c, s) with c real such that
    [[c, s], [-conj(s), c]] @ [f, g]^T = [r, 0]^T."""
    one = torch.ones((), dtype=f.dtype, device=f.device)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    af = f.abs()
    ag = g.abs()
    r = torch.sqrt(af * af + ag * ag)
    safe = r > 0
    rs = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, af / rs, torch.ones_like(r))
    phase = torch.where(af > 0, f / torch.where(af > 0, af,
                                                torch.ones_like(af)).to(
        f.dtype), one)
    s = torch.where(safe, phase * g.conj() / rs.to(f.dtype), zero)
    swap = (af == 0) & (ag > 0)
    c = torch.where(swap, torch.zeros_like(c), c)
    s = torch.where(swap, one, s)
    return c.to(f.dtype), s


def _start(i: int, size: int, dim: int) -> int:
    """``lax.dynamic_slice``'s start clamp."""
    return min(max(i, 0), dim - size)


# ---------------------------------------------------------------------
# schedules (numpy, cached)
# ---------------------------------------------------------------------

#: schedules kept per builder: a chain runs at most 5 sweeps (N = 8192,
#: nb = 512), and the narrowest of a gebrd at 8192 holds 232 MB of tables
SCHEDULES_KEPT = 8


@functools.lru_cache(maxsize=SCHEDULES_KEPT)
def herm_chase_schedule(N: int, b: int) -> np.ndarray:
    """Rotation schedule (K, 2) of (i, c): rotate rows (i-1, i) to zero
    A[i, c], then chase the (i+b, i-1) fills down the band."""
    steps = []
    for s in range(N - 2):
        for j in range(min(b, N - 1 - s), 1, -1):
            i, c = s + j, s
            while i < N:
                steps.append((i, c))
                i, c = i + b, i - 1
    if not steps:
        return np.zeros((0, 2), dtype=np.int32)
    return np.asarray(steps, dtype=np.int32)


def _panel_steps(P: int, M: np.ndarray, delay: int):
    """(j, m, t) of every step of every panel: panel j's steps
    m in [0, M[j]) at t = delay·j + m."""
    j = np.repeat(np.arange(P), M)
    first = np.repeat(np.cumsum(M) - M, M)
    m = np.arange(j.size) - first
    return j, m, delay * j + m


@functools.lru_cache(maxsize=SCHEDULES_KEPT)
def _sbr_schedule(N: int, b: int, w: int):
    """(c0, u, T, G, V, park0): pipelined step tables of one dense-layout
    Hermitian sweep (reference band.py:142-168, panel stagger 5)."""
    starts = np.arange(0, max(N - w - 1, 0), w)
    V = 3 * b + w
    if not starts.size:
        return None
    M = 1 + np.maximum(0, -(-(N - starts - w) // b) - 1)
    G = -(-int(M.max()) // 5) + 1
    T = int((5 * np.arange(starts.size) + M).max())
    park0 = N + 3 * b + w
    c0 = np.repeat((park0 + np.arange(G) * V)[None, :].astype(np.int32),
                   T, axis=0)
    uu = np.zeros((T, G), np.int32)
    j, m, t = _panel_steps(starts.size, M, 5)
    s = starts[j]
    c0[t, j % G] = np.where(m == 0, s, s + w + (m - 1) * b)
    uu[t, j % G] = np.where(m == 0, w, b)
    return c0, uu, T, G, V, park0


@functools.lru_cache(maxsize=SCHEDULES_KEPT)
def _sbr_schedule_bidiag(K: int, b: int, w: int, wide: bool):
    """Pipelined step tables of one bidiagonal QR/LQ sweep (reference
    band.py:228-265): panel j (rows [s, s+w), s = j·w) starts at
    t = 10j; step m = 0 is the panel LQ, then QR at odd m and LQ at even
    m, both anchored at s + w + (ceil(m/2) − 1)·b, so every time step
    holds one kind (t odd = QR). ``wide`` (M < N): the tail panels run
    too, masked to the rows that exist."""
    starts = np.arange(0, max(K if wide else K - w, 0), w)
    V = 3 * b + w
    if not starts.size:
        return None
    M = 1 + 2 * np.maximum(0, -(-(K - starts - w) // b))
    G = -(-int(M.max()) // 10) + 1
    T = int((10 * np.arange(starts.size) + M).max())
    park0 = K + 3 * b + w
    c0 = np.repeat((park0 + np.arange(G) * V)[None, :].astype(np.int32),
                   T, axis=0)
    uu = np.zeros((T, G), np.int32)
    off = np.zeros((T, G), np.int32)
    j, m, t = _panel_steps(starts.size, M, 10)
    s = starts[j]
    g = j % G
    c0[t, g] = np.where(m == 0, s, s + w + ((m + 1) // 2 - 1) * b)
    uu[t, g] = np.where(m == 0, np.minimum(w, K - s), b)
    off[t, g] = np.where(m == 0, w, b)
    return c0, uu, off, T, G, V, park0


@functools.lru_cache(maxsize=SCHEDULES_KEPT)
def _sbr_banded_schedule(N: int, b: int, w: int, delta: int = 4):
    """base (T,), u (T, G) of the band-storage sweep, plus geometry
    (reference band.py:388-423): the G slot windows of step t sit at
    F rows base[t] + g·S, S = delta·b − w."""
    starts = np.arange(0, max(N - w - 1, 0), w)
    if not starts.size:
        return None
    assert delta * b - w >= 3 * b + w, (b, w, delta)
    P = starts.size
    M = 1 + np.maximum(0, -(-(N - starts - w) // b) - 1)
    S = delta * b - w
    V = 3 * b + w
    G = -(-int(M.max()) // delta) + 1
    T = int((delta * np.arange(P) + M).max())
    tt = np.arange(T)
    jmax = np.minimum(tt // delta, P - 1)
    base = (tt * b - jmax * S + (w - b)).astype(np.int64)
    j = jmax[:, None] - np.arange(G)[None, :]
    m = tt[:, None] - delta * j
    live = (j >= 0) & (m >= 0) & (m < M[np.maximum(j, 0)])
    uu = np.where(live, np.where(m == 0, w, b), 0).astype(np.int32)
    L0 = int(max(0, -base.min()))
    hi = int(base.max()) + G * S
    return base, uu, T, G, S, V, L0, hi


@functools.lru_cache(maxsize=SCHEDULES_KEPT)
def bidiag_chase_schedule(M: int, N: int, b: int) -> np.ndarray:
    """Schedule (K, 3) of (side, i, c): side 0 = column rotation on
    columns (i-1, i) zeroing A[c, i]; side 1 = row rotation on rows
    (i-1, i) zeroing A[i, c]."""
    steps = []
    K = min(M, N)
    for s in range(K):
        for j in range(min(b, N - 1 - s), 1, -1):
            q, c = s + j, s
            while True:
                steps.append((0, q, c))
                if q >= M:
                    break
                steps.append((1, q, q - 1))
                c, q = q - 1, q + b
                if q >= N:
                    break
    if not steps:
        return np.zeros((0, 3), dtype=np.int32)
    return np.asarray(steps, dtype=np.int32)


def _to_device(arrays, device):
    """The schedule ``arrays`` on ``device``, owned by the calling sweep."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


#: from this band on the window QRs of the batched torch route and of the
#: K1 route are one 2-D ``torch.geqrf`` a live window. On an H100
#: (chip_smoke phase 16, its ``[geqrf]`` lines), f32 at N = 8192: the
#: 127-wide sweep's batched call over its 15 slots took 7.30 ms a step,
#: 2-D calls 0.63 ms each over its ~7 live windows; the 64-wide sweep's
#: 1.15 ms over 33 slots against 0.18 ms each over ~16 live windows, so
#: it stays batched; the 256- and 511-wide sweeps' loops 2.2-2.5x faster
#: than their batched calls over every slot
LOOP_QR_MIN_B = 96


def _live_factor(live, b: int):
    """The window QR of a (G, b, b) batch of blocks: one batched
    ``torch.geqrf`` below :data:`LOOP_QR_MIN_B`, else one 2-D call per
    live window (``live``: host indices), the dead windows' reflectors
    the identity (taus 0), as a batched QR of their zero blocks gives."""
    if b < LOOP_QR_MIN_B:
        return torch.geqrf

    def factor(blk):
        packed = torch.zeros_like(blk)
        taus = blk.new_zeros(blk.shape[:-1])
        for g in live:
            packed[g], taus[g] = torch.geqrf(blk[g])
        return packed, taus
    return factor


def _k1_windows(dtype, b: int, V: int) -> bool:
    """Do the window products pass the reference's K1 gate (f32/bf16, K1
    on, every dimension >= 256)? Then each active window's products go
    through ``blas.dot`` as 2-D operands."""
    return (_pk.enabled() and dtype in (torch.float32, torch.bfloat16)
            and min(b, V) >= _pk._MIN_DIM)


# ---------------------------------------------------------------------
# Hermitian band -> tridiagonal: the dense-layout Givens chase
# ---------------------------------------------------------------------

def _givens(cs, sn):
    """G = [[c, s], [-conj(s), c]] as a 2×2 tensor."""
    return torch.stack([cs, sn, -sn.conj(), cs]).view(2, 2)


def _rot_rows(R, G):
    """The (2, L) strip R <- G R, in place."""
    R.copy_(G @ R)


def _rot_cols(C, G):
    """The (L, 2) strip C <- C G^H, in place."""
    C.copy_(C @ G.mH)


def _tridiag_of(body, N: int):
    d = torch.diagonal(body).real
    e = torch.diagonal(body, offset=-1).abs().to(d.dtype) if N > 1 else \
        torch.zeros((0,), dtype=d.dtype, device=body.device)
    return d[:N], e[:max(N - 1, 0)]


def herm_band_to_tridiag(X, N: int, b: int):
    """Reduce a dense-stored Hermitian band matrix (bandwidth b, both
    triangles populated, logical size N) to tridiagonal by the Givens
    chase of :func:`herm_chase_schedule`. Returns (d, e) real."""
    if N <= 2 or b <= 1:
        return _tridiag_of(X[:N, :N], N)
    sched = herm_chase_schedule(N, b)
    D = b + 2                      # window margin (band + bulge)
    L = 2 * D + 2                  # strip length covering both rows/cols
    P = D + 1                      # padding so slices never clamp
    Xp = torch.zeros((N + 2 * P, N + 2 * P), dtype=X.dtype, device=X.device)
    Xp[P:P + N, P:P + N] = X[:N, :N]
    for i, c in sched.tolist():
        G = _givens(*_lartg(Xp[i - 1 + P, c + P], Xp[i + P, c + P]))
        row0 = i - 1 + P
        col0 = i - 1 - D + P
        _rot_rows(Xp[row0:row0 + 2, col0:col0 + L], G)
        _rot_cols(Xp[col0:col0 + L, row0:row0 + 2], G)
    return _tridiag_of(Xp[P:P + N, P:P + N], N)


# ---------------------------------------------------------------------
# Pipelined blocked SBR on the dense layout
# ---------------------------------------------------------------------

def herm_sbr_sweep(X, N: int, b: int, w: int):
    """One pipelined SBR sweep on the dense layout: Hermitian band ``b``
    -> ``w`` (``w <= b//4``). ``X`` dense-stored (both triangles live),
    logical size ``N``. Returns the swept array (padding grown to hold
    the parked windows). The reference's ``one`` per window: masked QR
    of the b×b block at (u, 0) eliminating its first u columns, the
    row strip [u, u+b) × [0, V) from the left, then the column strip
    [0, V) × [u, u+b) from the right; batched over the G windows."""
    assert 1 <= w <= b // 4 or (b <= 4 and w == 1), (b, w)
    sched = _sbr_schedule(N, b, w)
    if sched is None or N <= 2 or b <= 1:
        return X
    c0s, us, T, G, V, park0 = sched
    Mp = X.shape[0]
    Mp2 = park0 + G * V
    if Mp2 > Mp:
        Xp = torch.zeros((Mp2, Mp2), dtype=X.dtype, device=X.device)
        Xp[:Mp, :Mp] = X
    else:
        Xp = X.clone()
    c0d, ud = _to_device((c0s, us), X.device)
    flat = Xp.view(-1)
    cols = torch.arange(b, device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    for t in range(T):
        c0, u = c0d[t], ud[t]
        ridx = sbr.window_index(c0, b, V, u.to(torch.int64), 0, Mp2)
        R = flat[ridx]                                  # (G, b, V)
        blk = torch.where((cols < u[:, None])[:, None, :], R[:, :, :b],
                          zero)
        packed, taus = torch.geqrf(blk)
        v, _ = hh.split_qr(packed)
        tT = hh.larft(v, taus)
        flat[ridx] = hh.apply_q(v, tT, R, trans="C")
        cidx = sbr.window_index(c0, V, b, 0, u.to(torch.int64), Mp2)
        flat[cidx] = hh.apply_q_right(v, tT, flat[cidx], trans="N")
    return Xp


def _pad4(x):
    """``x`` zero-padded on its last two axes to multiples of 4 elements:
    the K1 route's operands with 16-byte rows, which TMA describes (the
    sweeps' b = 2nb − 1 is odd). The padding adds zero rows and columns
    to the reflectors, T and the strips, so the products' other entries
    are the same sums."""
    r, c = x.shape[-2:]
    rp, cp = -(-r // 4) * 4, -(-c // 4) * 4
    out = x.new_zeros(x.shape[:-2] + (rp, cp))
    out[..., :r, :c] = x
    return out


def _k1_reflectors(packed, taus, a: int):
    """Window ``a``'s (V, T) of a batched QR, 16-byte padded."""
    v, _ = hh.split_qr(packed[a])
    vp = _pad4(v)
    tp = taus.new_zeros(vp.shape[-1])
    tp[:taus.shape[-1]] = taus[a]
    return vp, hh.larft(vp, tp)


def _bidiag_k1_step(X, c0s, us, offs, t: int, geom, qr: bool):
    """One bidiagonal step with each active window's products as 2-D
    operands through ``blas.dot`` (K1 when it is on): the route of the
    reference's batched K1 launch on the first sweep."""
    G, V, b, ld = geom
    live = np.nonzero(us[t])[0]
    if not live.size:
        return
    dev = X.device
    c0 = torch.from_numpy(c0s[t, live].astype(np.int64)).to(dev)
    off = torch.from_numpy(offs[t, live].astype(np.int64)).to(dev)
    idx = sbr.bidiag_index(c0, off, geom, qr)
    flat = X.view(-1)
    W = flat[idx]
    factor = _live_factor(range(live.size), b)
    if qr:
        packed, taus = factor(W[:, :, :b])
    else:
        blk = W[:, :b, :].clone()
        for a, g in enumerate(live):
            blk[a, int(us[t, g]):, :] = 0
        packed, taus = factor(blk.conj().mT)
    out = torch.empty_like(W)
    for a in range(live.size):
        vp, tp = _k1_reflectors(packed, taus, a)
        Wp = _pad4(W[a])
        out[a] = (hh.apply_q(vp, tp, Wp, trans="C")[:b] if qr else
                  hh.apply_q_right(vp, tp, Wp, trans="N")[:, :b])
    flat[idx] = out


def _route(route: str, b: int, dtype, V: int, kind: str) -> str:
    """The route of a ``kind`` ("herm" or "bidiag") sweep: ``kw`` (KW
    takes its windows: b <= 128), ``k1`` (the window products pass K1's
    gate: f32, b and V >= 256) or ``plain`` (the batched torch route);
    ``route`` other than ``auto`` forces one."""
    if route != "auto":
        return route
    if sbr.eligible(b, V, dtype, kind):
        return "kw"
    return "k1" if _k1_windows(dtype, b, V) else "plain"


def _bidiag_storage(X, M: int, N: int, b: int, w: int):
    """(Xp, T, geom, tabs): X zero-padded to hold the parked windows, and
    the sweep's step count, geometry and device tables."""
    K = min(M, N)
    c0s, us, offs, T, G, V, park0 = _sbr_schedule_bidiag(K, b, w, M < N)
    Mp, Np = X.shape
    lim = park0 + G * V
    R, C = max(lim, Mp), max(lim, Np)
    Xp = torch.zeros((R, C), dtype=X.dtype, device=X.device)
    Xp[:Mp, :Np] = X
    geom = sbr.BidiagGeom(G, V, b, C)
    return Xp, T, geom, sbr.bidiag_tabs(c0s, us, offs, geom, X.device)


def bidiag_sweep_steps(X, M: int, N: int, b: int, w: int,
                       route: str = "auto"):
    """The steps of :func:`bidiag_sbr_sweep` as a generator: pads X into
    a fresh array Xp and yields (t, Xp) after each step t (the ``kw``
    route one KW launch a step)."""
    assert 1 <= w <= b // 4 or (b <= 4 and w == 1), (b, w)
    c0s, us, offs = _sbr_schedule_bidiag(min(M, N), b, w, M < N)[:3]
    Xp, T, geom, tabs = _bidiag_storage(X, M, N, b, w)
    how = _route(route, b, X.dtype, geom.V, "bidiag")
    for t in range(T):
        qr = t % 2 == 1
        if how == "kw":
            sbr.bidiag_step(Xp, tabs, t, geom)
        elif how == "k1":
            _bidiag_k1_step(Xp, c0s, us, offs, t, geom, qr)
        else:
            sbr.bidiag_step_reference(
                Xp, tabs.c0[t], tabs.u[t], tabs.off[t], geom, qr,
                _live_factor(np.nonzero(us[t])[0], b))
        yield t, Xp


def bidiag_sbr_sweep(X, M: int, N: int, b: int, w: int,
                     route: str = "auto"):
    """One pipelined SBR sweep on an upper-band matrix: band ``b`` ->
    ``w`` (``w <= b//4``) by row-panel LQ + alternating QR/LQ bulge
    chasing. ``X`` dense-stored, logical ``M x N``, upper bandwidth
    ``<= b``. Returns the swept array, cropped back to X's shape. On the
    ``kw`` route the whole sweep is one KW launch."""
    K = min(M, N)
    if _sbr_schedule_bidiag(K, b, w, M < N) is None or K <= 1 or b <= 1:
        return X
    if _route(route, b, X.dtype, 3 * b + w, "bidiag") == "kw":
        assert 1 <= w <= b // 4 or (b <= 4 and w == 1), (b, w)
        Xp, T, geom, tabs = _bidiag_storage(X, M, N, b, w)
        sbr.bidiag_steps(Xp, tabs, 0, T, geom)
    else:
        Xp = X
        for _, Xp in bidiag_sweep_steps(X, M, N, b, w, route):
            pass
    return Xp[:X.shape[0], :X.shape[1]]


def _bidiag_of(X, M: int, N: int):
    """(|d|, |e|) of an upper-bidiagonal X: e has K entries when M < N
    (the K×(K+1) bidiagonal's tail), else K − 1."""
    K = min(M, N)
    ne = K if (M < N and K >= 1) else max(K - 1, 0)
    d = torch.diagonal(X).abs()[:K]
    e = torch.diagonal(X, offset=1).abs()[:ne]
    return d, e


def bidiag_band_to_bidiag_scan(X, M: int, N: int, b: int,
                               sweep=bidiag_sbr_sweep):
    """Upper band -> bidiagonal by successive quarter-width sweeps
    (``sweep(X, M, N, b, w)``, default :func:`bidiag_sbr_sweep`).
    Returns (|d|, |e|) with the tail contract of
    :func:`bidiag_band_to_bidiag`."""
    for bb, w in sweep_ladder(b):
        X = sweep(X, M, N, bb, w)
    return _bidiag_of(X, M, N)


# ---------------------------------------------------------------------
# Band-storage pipelined SBR (the Hermitian default)
# ---------------------------------------------------------------------

def _shear_fwd(Wt, H: int):
    """Y[g, t, k] = Wt[g, t, k - t] (zero where k - t outside [0, H));
    Wt (G, S, H) -> (G, S, H + S - 1)."""
    G, S, _ = Wt.shape
    Wp = torch.nn.functional.pad(Wt, (0, S))
    flat = Wp.reshape(G, S * (H + S))
    return flat[:, :S * (H + S - 1)].reshape(G, S, H + S - 1)


def _shear_bwd(Y, H: int):
    """Inverse of :func:`_shear_fwd`: Wt[g, t, h] = Y[g, t, h + t]."""
    G, S, Wsh = Y.shape
    flat = torch.nn.functional.pad(Y.reshape(G, S * Wsh), (0, S))
    return flat.reshape(G, S, Wsh + 1)[:, :, :H]


def _band_full(X, N: int, D: int, L0: int, Nc: int):
    """Full-band COLUMN-MAJOR storage from dense:
    F[L0 + c, D + (r-c)] = X[r, c] for |r - c| <= D."""
    dev = X.device
    c = torch.arange(N, device=dev)[:, None]
    k = torch.arange(-D, D + 1, device=dev)[None, :]
    r = c + k
    valid = (r >= 0) & (r < N)
    body = torch.where(valid, X[r.clamp(0, N - 1), c.clamp(0, N - 1)],
                       torch.zeros((), dtype=X.dtype, device=dev))
    F = torch.zeros((Nc, 2 * D + 1), dtype=X.dtype, device=dev)
    F[L0:L0 + N] = body
    return F


def _herm_k1_step(F, bs: int, us, t: int, geom):
    """One Hermitian band-storage step with each active window's products
    as 2-D operands through ``blas.dot`` (K1 when it is on); inactive
    windows get the identity update (their column strip rewritten as the
    mirror, as in the batched route)."""
    b = geom.b
    Rv, Cv = sbr.herm_views(F, bs, geom)
    R = Rv.contiguous()
    R2 = R.clone()
    C2 = R.conj().mT.contiguous()
    live = np.nonzero(us[t])[0]
    if live.size:
        blk = R.new_zeros((live.size, b, b))
        for a, g in enumerate(live):
            u = int(us[t, g])
            blk[a, :, :u] = R[g, :, b - u:b]
        packed, taus = _live_factor(range(live.size), b)(blk)
        for a, g in enumerate(live):
            vp, tp = _k1_reflectors(packed, taus, a)
            r2, c2 = sbr.herm_window(_pad4(R[g]), vp, tp, b)
            R2[g], C2[g] = r2[:b], c2[:, :b]
    Rv.copy_(R2)
    Cv.copy_(C2)


def _herm_tables(F, N: int, b: int, w: int, D: int, L0: int):
    """(T, geom, tabs, host schedule (bases, us)) of one band-storage
    sweep on F."""
    base, us, T, G, S, V, L0_need, hi = _sbr_banded_schedule(N, b, w)
    H = F.shape[1]
    assert D >= 2 * b + w and H == 2 * D + 1
    assert L0 >= L0_need and L0 + hi <= F.shape[0], (L0, hi, F.shape)
    assert F.is_contiguous()
    geom = sbr.HermGeom(G, S, V, b, H, D)
    return T, geom, sbr.herm_tabs(base + L0, us, geom, F.device), \
        ((base + L0).tolist(), us)


def herm_sweep_steps(F, N: int, b: int, w: int, D: int, L0: int,
                     route: str = "auto"):
    """The steps of :func:`herm_sbr_sweep_banded` as a generator, in
    place on F: yields t after each step t (the ``kw`` route one KW
    launch a step)."""
    T, geom, tabs, (bases, us) = _herm_tables(F, N, b, w, D, L0)
    how = _route(route, b, F.dtype, geom.V, "herm")
    for t in range(T):
        if how == "kw":
            sbr.herm_step(F, tabs, t, geom)
        elif how == "k1":
            _herm_k1_step(F, bases[t], us, t, geom)
        else:
            sbr.herm_step_reference(F, bases[t], tabs.u[t], geom,
                                    _live_factor(np.nonzero(us[t])[0], b))
        yield t


def herm_sbr_sweep_banded(F, N: int, b: int, w: int, D: int, L0: int,
                          route: str = "auto"):
    """One pipelined SBR sweep on full-band storage ``F`` ((Nc, 2D+1)
    column-major, contiguous, D >= 2b + w, logical column c at row
    L0 + c): band b -> w, in place. Returns F. On the ``kw`` route the
    whole sweep is one KW launch."""
    if _sbr_banded_schedule(N, b, w) is None or N <= 2 or b <= 1:
        return F
    if _route(route, b, F.dtype, 3 * b + w, "herm") == "kw":
        T, geom, tabs, _ = _herm_tables(F, N, b, w, D, L0)
        sbr.herm_steps(F, tabs, 0, T, geom)
        return F
    for _ in herm_sweep_steps(F, N, b, w, D, L0, route):
        pass
    return F


def sweep_ladder(b: int):
    """The (b, w) pairs of the quarter-width ladder b -> 1."""
    ws = []
    while b > 1:
        w = max(1, b // 4)
        ws.append((b, w))
        b = w
    return ws


def herm_band_to_tridiag_scan(X, N: int, b: int,
                              sweep=herm_sbr_sweep_banded):
    """Band -> tridiagonal by successive pipelined SBR sweeps
    (b -> b//4 -> ... -> 1, each ``sweep(F, N, b, w, D, L0)``, default
    :func:`herm_sbr_sweep_banded`) on band storage. Returns (d, e)
    real."""
    if N <= 2 or b <= 1:
        return _tridiag_of(X[:N, :N], N)
    F = None
    D = L0 = 0
    for bs_, ws_ in sweep_ladder(b):
        sched = _sbr_banded_schedule(N, bs_, ws_)
        if sched is None:
            continue
        _, _, _, _, S_, _, L0n, hin = sched
        Dn = 2 * bs_ + ws_
        Ncn = L0n + max(hin, N) + S_
        if F is None:
            F = _band_full(X, N, Dn, L0n, Ncn)
        else:
            # re-center the band into the new (narrower) geometry
            body = F[L0:L0 + N, D - Dn:D + Dn + 1]
            F = torch.zeros((Ncn, 2 * Dn + 1), dtype=F.dtype,
                            device=F.device)
            F[L0n:L0n + N] = body
        D, L0 = Dn, L0n
        F = sweep(F, N, bs_, ws_, D, L0)
    d = F[L0:L0 + N, D].real
    e = F[L0:L0 + N - 1, D + 1].abs().to(d.dtype)
    return d, e


# ---------------------------------------------------------------------
# Lower-band storage and the band-storage Givens chase
# ---------------------------------------------------------------------

def to_lower_band(X, D: int, N: int, margin: int = 0):
    """Column-aligned lower-band storage from a dense (Hermitian) array:
    S[k, c] = X[c + k, c] for k in [0, D); ``margin`` adds zero
    columns."""
    dev = X.device
    Nc = N + margin
    c = torch.arange(Nc, device=dev)[None, :]
    k = torch.arange(D, device=dev)[:, None]
    r = c + k
    valid = (r < min(N, X.shape[0])) & (c < min(N, X.shape[1]))
    return torch.where(valid, X[r.clamp(0, X.shape[0] - 1),
                                c.clamp(0, X.shape[1] - 1)],
                       torch.zeros((), dtype=X.dtype, device=dev))


def lower_band_to_dense(S, N: int):
    """Inverse of :func:`to_lower_band` (lower triangle only)."""
    D = S.shape[0]
    dev = S.device
    r = torch.arange(N, device=dev)[:, None]
    c = torch.arange(N, device=dev)[None, :]
    k = r - c
    valid = (k >= 0) & (k < D)
    return torch.where(valid, S[k.clamp(0, D - 1),
                                c.clamp(0, S.shape[1] - 1)],
                       torch.zeros((), dtype=S.dtype, device=dev))


def herm_band_to_tridiag_banded(S, N: int, b: int):
    """Band -> tridiagonal Givens chase on O(N·b) full-band storage
    (both triangles, column-aligned: F[D + off, c] = X[c + off, c]) with
    P zero columns of margin. Each rotation acts on the anti-diagonals
    of its window for the rows and on two contiguous columns for the
    columns. ``S`` is lower storage (>= b+1 rows); returns (d, e)."""
    if N <= 2 or b <= 1:
        d = S[0, :N].real
        e = S[1, :N - 1].abs() if N > 1 else \
            torch.zeros((0,), dtype=d.dtype, device=S.device)
        return d, e
    sched = herm_chase_schedule(N, b)
    D = b + 2
    L = 2 * D + 2
    P = D + 1
    H = 2 * D + 1
    Nc = N + 2 * P
    dev = S.device
    F = torch.zeros((H, Nc), dtype=S.dtype, device=dev)
    nk = min(D + 1, S.shape[0])
    F[D:D + nk, P:P + N] = S[:nk, :N]
    for kk in range(1, nk):       # upper mirror: X[c-k, c] = conj(S[k, c-k])
        F[D - kk, P + kk:P + N] = S[kk, :N - kk].conj()
    # row r = i-1+dr at window column c0+t sits at band row 2D + dr - t:
    # row i-1 is the anti-diagonal (2D - t, c0 + t), t in [0, 2D], and
    # row i the one shifted a column right, each a strided view of F
    # (stride Nc - 1, walking t downwards); column c = i-1+dc at window
    # row c0+t sits at band row t - dc, two contiguous columns of F
    n_ad = 2 * D + 1
    for i, c in sched.tolist():
        i, c = i + P, c + P
        G = _givens(*_lartg(F[D + (i - 1) - c, c], F[D + i - c, c]))
        c0 = i - 1 - D
        r0 = F.as_strided((n_ad,), (Nc - 1,), F.storage_offset() + c0 + 2 * D)
        r1 = F.as_strided((n_ad,), (Nc - 1,),
                          F.storage_offset() + c0 + 2 * D + 1)
        # pair the two rows by window column t (s = 2D + 1 - t)
        W = G @ torch.stack([torch.nn.functional.pad(r0, (1, 0)),
                             torch.nn.functional.pad(r1, (0, 1))])
        r0.copy_(W[0, 1:])
        r1.copy_(W[1, :n_ad])
        cols = F[:, i - 1:i + 1]
        Sc = torch.stack([torch.nn.functional.pad(cols[:, 0], (0, 1)),
                          torch.nn.functional.pad(cols[:, 1], (1, 0))], 1)
        Sc = Sc @ G.mH
        cols[:, 0] = Sc[:H, 0]
        cols[:, 1] = Sc[1:, 1]
    d = F[D, P:P + N].real
    e = F[D + 1, P:P + N - 1].abs()
    return d, e


# ---------------------------------------------------------------------
# Upper-bidiagonal band -> bidiagonal: the Givens chase
# ---------------------------------------------------------------------

def bidiag_band_to_bidiag(X, M: int, N: int, b: int):
    """Reduce a dense-stored upper-band matrix (upper bandwidth b, zero
    below the diagonal, logical M×N) to upper bidiagonal by the Givens
    chase of :func:`bidiag_chase_schedule`. Returns (|d|, |e|); when
    M < N, ``e`` keeps the tail entry A[M-1, M] (K entries)."""
    K = min(M, N)
    rdt = torch.zeros((), dtype=X.dtype).real.dtype
    if K == 0:
        z = torch.zeros((0,), dtype=rdt, device=X.device)
        return z, z
    if b <= 1 or K == 1:
        return _bidiag_of(X[:M, :N], M, N)
    sched = bidiag_chase_schedule(M, N, b)
    D = b + 2
    L = 2 * D + 2
    P = D + 1
    Xp = torch.zeros((M + 2 * P, N + 2 * P), dtype=X.dtype, device=X.device)
    Xp[P:P + M, P:P + N] = X[:M, :N]
    nr, nc = Xp.shape
    for side, i, c in sched.tolist():
        if side == 0:
            # zero A[c, i] against A[c, i-1]: mix columns (i-1, i); the
            # conjugated lartg makes -sn·f + cs·g vanish for complex
            G = _givens(*_lartg(Xp[c + P, i - 1 + P].conj(),
                                Xp[c + P, i + P].conj()))
            r0 = _start(i - 1 - D + P, L, nr)
            c1 = _start(i - 1 + P, 2, nc)
            _rot_cols(Xp[r0:r0 + L, c1:c1 + 2], G)
        else:
            # zero A[i, c] against A[i-1, c]: mix rows (i-1, i)
            G = _givens(*_lartg(Xp[i - 1 + P, c + P], Xp[i + P, c + P]))
            r1 = _start(i - 1 + P, 2, nr)
            c0 = _start(i - 1 - D + P, L, nc)
            _rot_rows(Xp[r1:r1 + 2, c0:c0 + L], G)
    return _bidiag_of(Xp[P:P + M, P:P + N], M, N)
