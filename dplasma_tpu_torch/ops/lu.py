"""LU factorization: partial pivoting (getrf_1d), no pivoting, solvers.

Ports ``dplasma_tpu/ops/lu.py`` (:51-151, :168-525). Pivoting is a
global row permutation vector with the semantics ``A[perm] = L U``
(int64, on the factor's device), not LAPACK's swap-format IPIV:
:func:`laswp` applies it as one gather, and :func:`perm_to_ipiv` /
:func:`ipiv_to_perm` convert to and from the reference's format on the
host.

``getrf_1d`` is a right-looking shrinking-window sweep over nb-wide
panels (``ops._sweep.pipelined_sweep``, lookahead from MCA
``sweep.lookahead``) with deferred pivot bookkeeping: each panel's
permutation is applied to the trailing window only, and the packed
factor is stitched at the end from the row ids. Every panel goes to
:func:`_base_lu`, which picks the panel kernel (MCA ``panel.kernel``):
K3 (``kernels/pallas_lu``) under ``pallas``, the recursive panel under
``rec``, cuSOLVER's getrf under ``chain`` (CALU tournament pivoting for
panels taller than ``lu.panel_chunk``). Every Schur update product goes
through ``quant.update_dot``, hence to K1 when it is enabled and
eligible. With lookahead 1 and KT panels, that is one narrow product per
step while a lookahead column remains and one far product while far
columns remain: 2·KT − 3 products per square factorization. The pivot
bookkeeping never leaves the device.

Under MCA ``dd_gemm=always`` (the f64-equivalent limb route) every f64
panel is :func:`_panel_lu_dd`: an f32 seed by the panel kernel above
(K3 under ``pallas``), refined by ``dd.lu_ir``; the U solve is
``dd.trsm_f64`` and the Schur product ``dd.gemm_f64``, each limb product
one K2 launch. The sweep is the per-step one whatever MCA
``lu.agg_depth`` says: the reference's eager ``jit_steps`` route flushes
the far updates every ``lu.agg_depth`` panels to fuse their dispatch on
the TPU, in the same op order, and eager torch has nothing to fuse. K2
launches per square factorization with KT panels at lookahead 1, from
the code: 4 per panel (``lu_ir``'s residuals) and 3 per block apply (the
U solve's 2 residuals and the Schur product), 2·KT − 3 applies:
10·KT − 9 (71 at N = 8192, nb = 1024; 311 at nb = 256, with 32 K3
launches under ``pallas``). No K1 launch: the seed panels' f32 work is
cuSOLVER's or K3's.

:func:`getrf_ptgpanel` runs the distributed panel of
``parallel/cyclic.py`` under an active P×Q grid (not yet under dd,
ROADMAP item 11).

:func:`getrf_incpiv` (tile-incremental pivoting on [U_kk; A_mk]
couples), :func:`getrf_qrf` (the LU/QR hybrid, an LU or a QR panel per
step by a data-dependent criterion), their solvers and :func:`gerfs`
port ``lu.py:527-781``. Their products go through ``blas.dot``, so K1
takes the f32 ones and K2 the dd ones. Per square factorization with KT
tiles: ``getrf_incpiv`` makes KT·(KT − 1)/2 couple products (one per
``_ssssm`` with a trailing block); ``getrs_incpiv`` as many on the
right-hand side and the upper solve's KT − 1 (``blas3.trsm``);
``getrf_qrf`` one per LU panel with a trailing block, and per QR panel
its ``larft`` Gram and three per ``apply_q`` on a trailing block. Under
``dd_gemm=always`` a complex product is two limb products and a complex
``trsm_f64`` five products (the Newton inverse's four and one apply); a
real one is two limb residuals. The reference's ``lax.cond`` on the
criterion is a host ``bool`` per panel here.

The out-of-HBM tier :func:`getrf_lowmem` (lu.py:780-854) keeps the
matrix on the host (``kernels.hostlink``) and runs a left-looking
sweep: per nb-wide panel, its whole column and then each finished
``cw``-wide block (rows j0 and below) go up, each block one U solve and
one rank-cw product (one K1 launch in f32), then the panel's rows from
its diagonal down factor by :func:`_panel_lu` and go back with the U
rows above. The panel's pivots then swap host rows in every other
column — only the rows the permutation moves (at most 2·nb for a
partial-pivoting panel), gathered before they are scattered, which is
bitwise the reference's whole-slab gather. Per square factorization
with nb-wide panels: Σₖ ceil(k·nb / cw) applies, and under
``panel.kernel=pallas`` K3 on the panels with (N − s)·nb·4 <= 8 MiB and
the ``rec`` panel on the others, whose one Schur product of width nb/2
>= 256 is one more K1 launch: at N = 16384, nb = 512, cw = 1024, 256
applies, 8 K3 and 24 + 256 = 280 K1 launches.

``dag`` waits for ROADMAP queue 1 item 15.
"""
from __future__ import annotations

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.analysis import memcheck as _mc
from dplasma_tpu_torch.descriptors import Dist, TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import dd as _dd
from dplasma_tpu_torch.kernels import hostlink
from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.kernels import pallas_lu
from dplasma_tpu_torch.kernels import panels as _panels
from dplasma_tpu_torch.kernels import quant as _quant
from dplasma_tpu_torch.observability import phases
from dplasma_tpu_torch.ops import _sweep, blas3
from dplasma_tpu_torch.ops.potrf import lowmem_budget
from dplasma_tpu_torch.parallel import cyclic
from dplasma_tpu_torch.parallel import mesh as pmesh
from dplasma_tpu_torch.utils import config as _cfg

# -- pivot bookkeeping -------------------------------------------------


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def perm_to_ipiv(perm):
    """Convert a permutation vector (A[perm] = LU) to LAPACK-style
    sequential swap indices (0-based): swapping rows i and ipiv[i] for
    i = 0..n-1 reproduces the permutation. Host numpy."""
    target = _host(perm)
    n = target.shape[0]
    cur = np.arange(n)            # cur[i] = original row now at slot i
    where = np.arange(n)          # where[r] = slot currently holding r
    ipiv = np.zeros(n, dtype=np.int32)
    for i in range(n):
        j = int(where[target[i]])
        ipiv[i] = j
        ri, rj = cur[i], cur[j]
        cur[i], cur[j] = rj, ri
        where[ri], where[rj] = j, i
    return torch.from_numpy(ipiv)


def ipiv_to_perm(ipiv):
    """Inverse of :func:`perm_to_ipiv`."""
    iv = _host(ipiv)
    n = iv.shape[0]
    perm = np.arange(n)
    for i in range(n):
        j = int(iv[i])
        if j != i:
            perm[i], perm[j] = perm[j], perm[i]
    return torch.from_numpy(perm)


def _swaps_to_perm(swaps, m: int):
    """The permutation of a swap sequence (0-based, ``swaps[..., i] >=
    i``) over ``m`` rows, on the device and without a loop over the
    swaps: each swap is a transposition array, and the arrays are
    composed pairwise, log2(k) batched gathers in all. Leading batch
    dims are kept."""
    *batch, kk = swaps.shape
    dev = swaps.device
    ident = torch.arange(m, device=dev)
    t = ident.expand(*batch, kk, m).clone()
    j = torch.arange(kk, device=dev).expand(*batch, kk)[..., None]
    t.scatter_(-1, j, swaps[..., None])          # t[i][i] = swaps[i]
    t.scatter_(-1, swaps[..., None], j)          # t[i][swaps[i]] = i
    while t.shape[-2] > 1:
        if t.shape[-2] % 2:
            t = torch.cat([t, ident.expand(*batch, 1, m)], dim=-2)
        # (f o g)[x] = f[g[x]]: swap 2i is applied before swap 2i+1
        t = torch.gather(t[..., 0::2, :], -1, t[..., 1::2, :])
    return t[..., 0, :]


def laswp(A: TileMatrix, perm, inverse: bool = False) -> TileMatrix:
    """Apply a global row permutation (dplasma_zlaswp analog): one
    gather instead of sequential row swaps."""
    if inverse:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        perm = inv
    return A.like(A.data[perm, :])


# -- no-pivoting LU ----------------------------------------------------

def _lu_apply_block(pan, blk, bw: int, perm=None):
    """Apply one factored LU panel to a column block: optional pivot
    gather, U solve of the top bw rows, rank-bw Schur update below
    (through ``quant.update_dot``, hence K1 when eligible)."""
    if perm is not None:
        blk = blk[perm]
    u = k.trsm(pan[:bw], blk[:bw], side="L", lower=True, unit=True)
    below = blk[bw:]
    if below.shape[0]:
        below = below - _quant.update_dot(pan[bw:], u)
    return u, below


def getrf_nopiv(A: TileMatrix, lookahead=None) -> TileMatrix:
    """Blocked right-looking LU without pivoting
    (dplasma_zgetrf_nopiv). Returns packed L\\U (unit L implicit).
    Lookahead-pipelined (:func:`~dplasma_tpu_torch.ops._sweep.
    pipelined_sweep`); ``lookahead=0`` is the serialized op order."""
    if A.desc.mb != A.desc.nb:
        raise ValueError(f"getrf needs square tiles, got {A.desc}")
    la, _ = _sweep.sweep_params(lookahead)
    nb = A.desc.nb
    pkind = _panels.panel_kernel("nopiv")

    def panel(col):
        if pkind == "rec":
            pan = _panels.lu_panel_rec_nopiv(col)
            return pan, pan
        d = k.getrf_nopiv(col[:nb])
        if col.shape[0] > nb:
            d = torch.cat([d, k.trsm(d, col[nb:], side="R", lower=False)],
                          dim=0)
        return d, d

    packs, urows = _sweep.pipelined_sweep(
        A.pad_diag().data, nb, A.desc.KT, A.desc.NT, panel,
        lambda pan, blk: _lu_apply_block(pan, blk, nb), lookahead=la)
    return TileMatrix(_sweep.assemble_sweep(packs, urows, A.desc.KT,
                                            A.desc.NT, nb), A.desc)


# -- partial pivoting --------------------------------------------------

def _lu_chain(panel):
    """cuSOLVER's (LAPACK's on the CPU) pivoted LU of one panel, its
    1-based pivots turned into a perm on the device. cuSOLVER is asked
    for by name: torch's default choice for a tall panel takes MAGMA,
    ~10x slower at 8192x256 on an H100 (PERF.md)."""
    if panel.device.type == "cuda":
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            lu, piv, _ = torch.linalg.lu_factor_ex(panel)
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)
    else:
        lu, piv, _ = torch.linalg.lu_factor_ex(panel)
    return lu, _swaps_to_perm(piv.long() - 1, panel.shape[-2])


def _base_lu(panel, chunk: int | None = None, kind: str | None = None):
    """Pivoted LU of one narrow tall sub-panel by the panel kernel
    ``kind`` (default: MCA ``panel.kernel``). ``pallas`` takes K3 where
    its gate holds, else ``rec``; ``chain`` takes the vendor LU, and for
    panels taller than ``lu.panel_chunk`` CALU tournament pivoting
    (Grigori/Demmel): row chunks elect ib candidate pivot rows each
    (one batched LU), a second-level LU of the stacked candidates picks
    the winners, and the other rows are solved against the winners' U.
    Returns (packed m x ib L\\U with unit L, perm) with ``panel[perm] =
    L U``."""
    m, ib = panel.shape
    if kind is None:
        kind = _panels.panel_kernel("lu")
    if kind == "pallas":
        if pallas_lu.eligible(panel):
            return pallas_lu.lu_panel(panel)
        kind = "rec"
    if kind == "rec":
        return _panels.lu_panel_rec(panel)
    if ((_cfg.mca_get("lu.pallas_panel") or "off").lower() == "on"
            and pallas_lu.eligible(panel)):
        return pallas_lu.lu_panel(panel)
    if chunk is None:
        chunk = _cfg.mca_get_int("lu.panel_chunk", 8192)
    # a chunk below 2*ib could not shrink the candidate recursion
    chunk = max(chunk, 2 * ib)
    if m <= chunk:
        return _lu_chain(panel)
    C = -(-m // chunk)
    pad = C * chunk - m
    dev = panel.device
    chunks = torch.cat([panel, panel.new_zeros((pad, ib))]).reshape(
        C, chunk, ib)
    _, cperm = _lu_chain(chunks)
    cand_pos = cperm[:, :ib]                                # (C, ib)
    cands = torch.gather(chunks, 1, cand_pos[:, :, None].expand(-1, -1, ib))
    cand_glob = cand_pos + (torch.arange(C, device=dev) * chunk)[:, None]
    lu2, perm2 = _base_lu(cands.reshape(C * ib, ib), chunk, kind)
    win_rows = cand_glob.reshape(-1)[perm2[:ib]]            # (ib,)
    # winners first in elimination order, the rest in original order
    key = ib + torch.arange(m + pad, device=dev)
    key[win_rows] = torch.arange(ib, device=dev)
    perm = torch.argsort(key[:m])
    top = lu2[:ib]
    l21 = k.trsm(torch.triu(top), panel[perm[ib:]], side="R", lower=False)
    return torch.cat([top, l21], dim=0), perm


def _lu_finish(packs, urows, step_ids, ids, Mp, KT, NT, bw):
    """Deferred-pivot stitching: the final row order and each step's
    reorder of its panel rows into it, then the assembly. The pivot
    bookkeeping is the ``assemble`` phase (a sibling of the span inside
    ``assemble_sweep``)."""
    with phases.span("assemble") as _f:
        final_ids = _f(torch.cat([si[:bw] for si in step_ids] + [ids]))

    def reorder(kk):
        sids = step_ids[kk]
        wpos = torch.zeros(Mp, dtype=torch.int64, device=sids.device)
        wpos[sids] = torch.arange(sids.shape[0], device=sids.device)
        return wpos[final_ids[(kk + 1) * bw:]]

    full = _sweep.assemble_sweep(packs, urows, KT, NT, bw, reorder=reorder)
    return full, final_ids


def _lu_sweep(X, bw: int, panel_fn, lookahead=None):
    """Pivoted shrinking-window LU sweep at block width ``bw`` with
    deferred pivot bookkeeping: each block's permutation is applied to
    the trailing window only (one gather), never to finished left
    columns. Returns (packed L\\U, perm) with ``X[perm] = L U``. Used at
    two levels: the nb-wide matrix sweep and the ib-wide in-panel
    sweep."""
    la, _ = _sweep.sweep_params(lookahead)
    Mp, Np = X.shape
    KT = min(Mp, Np) // bw
    NT = -(-Np // bw)
    ids_cell = [torch.arange(Mp, device=X.device)]
    step_ids = []

    def panel(col):
        pan, perm = panel_fn(col)
        idsp = ids_cell[0][perm]
        step_ids.append(idsp)
        ids_cell[0] = idsp[bw:]
        return pan, (pan, perm)

    packs, urows = _sweep.pipelined_sweep(
        X, bw, KT, NT, panel,
        lambda st, blk: _lu_apply_block(st[0], blk, bw, perm=st[1]),
        lookahead=la)
    return _lu_finish(packs, urows, step_ids, ids_cell[0], Mp, KT, NT, bw)


def _panel_lu_dd(panel, ib: int | None = None, kind: str | None = None):
    """The dd panel LU: an f32 seed by the f32 pivoted panel machinery
    (:func:`_panel_lu` with ``ib`` and ``kind``, so K3, the recursive
    panel and the cuSOLVER chain with its CALU fall-back all stay
    reachable), then ``dd.lu_ir`` refines L and U to f64-equivalent
    accuracy for that FIXED permutation.

    A power-of-two column prescale comes before the f32 cast, so f64
    magnitudes outside f32's range cannot overflow or flush the seed.
    Column scaling changes neither the pivot choice nor L, only U, and
    that exactly: panel·D = L·(U·D), so U = U_scaled / d."""
    nb = panel.shape[1]
    m_ = torch.amax(torch.abs(panel), dim=0, keepdim=True)
    d = 4.0 / _dd._pow2_scale_bits(m_)      # 2^-floor(log2 colmax)
    pan32, perm = _panel_lu((panel * d).to(torch.float32), ib, kind)
    # refine in the scaled coordinates (everything O(growth) there, so
    # the refinement's own f32 seeds stay in range); unscale U after
    L = k.tri(pan32.to(panel.dtype), lower=True, unit=True)
    Us = torch.triu(pan32[:nb]).to(panel.dtype)
    L, Us = _dd.lu_ir(panel[perm] * d, L, Us)
    U = Us / d
    return torch.cat([torch.triu(U) + torch.tril(L[:nb], -1)]
                     + ([L[nb:]] if L.shape[0] > nb else []), dim=0), perm


def _panel_lu(panel, ib: int | None = None, kind: str | None = None):
    """Pivoted LU of one nb-wide tall panel: a nested ib-wide
    shrinking-window sweep (full-height pivot search per sub-panel)
    whose base case is :func:`_base_lu`; ``ib`` from MCA
    ``lu.panel_ib`` (0: the whole panel is one base case). f64 panels
    on the dd route take :func:`_panel_lu_dd`."""
    if panel.dtype == torch.float64 and k._dd_active(panel.dtype):
        return _panel_lu_dd(panel, ib, kind)
    m, nb = panel.shape
    if ib is None:
        ib = _cfg.mca_get_int("lu.panel_ib", 0)
    if ib <= 0 or nb <= ib or nb % ib or m % ib:
        return _base_lu(panel, kind=kind)
    # the in-panel sweep stays serialized: the matrix sweep owns the
    # pipeline
    return _lu_sweep(panel, ib, lambda sub: _base_lu(sub, kind=kind),
                     lookahead=0)


def _getrf(A: TileMatrix, panel_fn):
    if A.desc.mb != A.desc.nb:
        raise ValueError(f"getrf needs square tiles, got {A.desc}")
    full, final_ids = _lu_sweep(A.pad_diag().data, A.desc.nb, panel_fn)
    return TileMatrix(full, A.desc), final_ids


def getrf_1d(A: TileMatrix):
    """Partial-pivoting blocked LU (dplasma_zgetrf_1d). Returns
    (packed L\\U, perm) with ``A[perm] = L U``; the perm spans the
    padded frame (``A.pad_diag()`` rows)."""
    return _getrf(A, _panel_lu)


def getrf_rec(A: TileMatrix, hnb: int = 0):
    """Recursive-panel LU (the -z/--HNB variant): each nb-wide panel
    factors as an hnb-wide nested sweep; ``hnb`` of 0 or >= nb is plain
    :func:`getrf_1d`."""
    if hnb <= 0 or hnb >= A.desc.nb:
        return getrf_1d(A)
    return _getrf(A, lambda panel: _panel_lu(panel, ib=hnb))


def getrf_ptgpanel(A: TileMatrix):
    """Distributed-parallel-panel LU (dplasma_zgetrf_ptgpanel,
    src/zgetrf_ptgpanel.jdf). Under an active mesh with P·Q > 1 and
    square tiles this runs the distributed panel of
    :func:`dplasma_tpu_torch.parallel.cyclic.getrf_cyclic` (per-row-rank
    candidate election, an all_gather playoff, the winner-row exchange
    along 'p'); everything else goes to :func:`getrf_1d`. The same
    (LU, perm) contract either way."""
    m = pmesh.active()
    if m is not None and A.desc.mb == A.desc.nb:
        P = m.shape[pmesh.ROW_AXIS]
        Q = m.shape[pmesh.COL_AXIS]
        if P * Q > 1:
            d = A.desc.dist
            if (d.P, d.Q) != (P, Q):  # grid comes from the mesh; keep
                d = Dist(P=P, Q=Q)    # dist's kp/kq only when it fits
            C = cyclic.CyclicMatrix.from_tile(A, d)
            F, perm = cyclic.getrf_cyclic(C)
            full = F.to_tile().data[perm]
            return TileMatrix(full, A.desc), perm
    return getrf_1d(A)


def trsmpl_ptgpanel(LU: TileMatrix, perm, B: TileMatrix) -> TileMatrix:
    """Apply pivots + L^{-1} to B (dplasma_ztrsmpl_ptgpanel)."""
    Bp = laswp(B.zero_pad(), perm)
    return blas3.trsm(1.0, LU, Bp, side="L", uplo="L", trans="N", diag="U")


def getrs(trans: str, LU: TileMatrix, perm, B: TileMatrix) -> TileMatrix:
    """Solve op(A) X = B from a pivoted factorization (dplasma_zgetrs)."""
    trans = trans.upper()
    if trans == "N":
        Y = trsmpl_ptgpanel(LU, perm, B)
        return blas3.trsm(1.0, LU, Y, side="L", uplo="U", trans="N")
    # op(A) = A^T/A^H: U^x L^x P x = b
    Y = blas3.trsm(1.0, LU, B, side="L", uplo="U", trans=trans)
    Z = blas3.trsm(1.0, LU, Y, side="L", uplo="L", trans=trans, diag="U")
    return laswp(Z, perm, inverse=True)


def gesv_1d(A: TileMatrix, B: TileMatrix):
    """Factor + solve (dplasma_zgesv_1d). Returns (LU, perm, X)."""
    LU, perm = getrf_1d(A)
    return LU, perm, getrs("N", LU, perm, B)


# -- incremental pivoting ----------------------------------------------

def getrf_incpiv(A: TileMatrix):
    """Tile-incremental-pivoting LU (dplasma_zgetrf_incpiv): pivoting is
    confined to [U_kk; A_mk] couples, each a pivoted LU of 2·nb rows.

    Returns (factored, Lc, piv): ``factored`` holds U on and above the
    diagonal and the couples' L21 blocks below it; ``Lc`` holds the
    couples' L11 blocks at tile (m, k) (the reference's separate L
    descriptor); ``piv[k, m]`` is the couple's 2·nb-row permutation (row
    k of ``piv`` holds the diagonal tile's in its first nb entries)."""
    if A.desc.mb != A.desc.nb:
        raise ValueError(f"getrf needs square tiles, got {A.desc}")
    nb = A.desc.nb
    MT, KT, Np = A.desc.MT, A.desc.KT, A.desc.Np
    X = A.pad_diag().data.clone()
    Lc = torch.zeros_like(X)
    piv = torch.arange(2 * nb, device=X.device).repeat(KT, MT, 1)
    for kk in range(KT):
        s, e = kk * nb, (kk + 1) * nb
        lu, perm = _lu_chain(X[s:e, s:e])
        X[s:e, s:e] = lu
        piv[kk, kk, :nb] = perm
        if e < Np:
            X[s:e, e:] = k.trsm(lu, X[s:e, e:][perm], side="L", lower=True,
                                unit=True)
        for m in range(kk + 1, MT):
            r0, r1 = m * nb, (m + 1) * nb
            lu2, perm2 = _lu_chain(torch.cat([torch.triu(X[s:e, s:e]),
                                              X[r0:r1, s:e]], dim=0))
            l11c = torch.tril(lu2[:nb], -1)
            l21c = lu2[nb:]
            X[s:e, s:e] = torch.tril(X[s:e, s:e], -1) + torch.triu(lu2[:nb])
            X[r0:r1, s:e] = l21c
            Lc[r0:r1, s:e] = l11c
            piv[kk, m] = perm2
            if e < Np:
                X[s:e, e:], X[r0:r1, e:] = _ssssm(l11c, l21c, perm2,
                                                  X[s:e, e:], X[r0:r1, e:])
    return TileMatrix(X, A.desc), TileMatrix(Lc, A.desc), piv


def _ssssm(l11c, l21c, perm, c_top, c_bot):
    """Apply a couple's L^-1 P to the vertical pair (CORE_zssssm):
    y1 = L11c^-1 (P c)[:nb]; y2 = (P c)[nb:] − L21c y1."""
    nb = l11c.shape[0]
    cstack = torch.cat([c_top, c_bot], dim=0)[perm]
    y1 = k.trsm(l11c, cstack[:nb], side="L", lower=True, unit=True)
    return y1, cstack[nb:] - k.dot(l21c, y1)


def trsmpl_incpiv(LU: TileMatrix, Lc: TileMatrix, piv,
                  B: TileMatrix) -> TileMatrix:
    """Replay the incpiv panel transformations on B
    (dplasma_ztrsmpl_incpiv)."""
    nb = LU.desc.nb
    MT, KT = LU.desc.MT, LU.desc.KT
    Y = B.zero_pad().data.clone()
    for kk in range(KT):
        s, e = kk * nb, (kk + 1) * nb
        Y[s:e] = k.trsm(LU.data[s:e, s:e], Y[s:e][piv[kk, kk, :nb]],
                        side="L", lower=True, unit=True)
        for m in range(kk + 1, MT):
            r0, r1 = m * nb, (m + 1) * nb
            Y[s:e], Y[r0:r1] = _ssssm(Lc.data[r0:r1, s:e],
                                      LU.data[r0:r1, s:e], piv[kk, m],
                                      Y[s:e], Y[r0:r1])
    return TileMatrix(Y, B.desc)


def getrs_incpiv(LU: TileMatrix, Lc: TileMatrix, piv,
                 B: TileMatrix) -> TileMatrix:
    """Solve from an incpiv factorization (dplasma_zgetrs_incpiv)."""
    Y = trsmpl_incpiv(LU, Lc, piv, B)
    return blas3.trsm(1.0, LU, Y, side="L", uplo="U", trans="N")


def gesv_incpiv(A: TileMatrix, B: TileMatrix):
    """dplasma_zgesv_incpiv. Returns (LU, Lc, piv, X)."""
    LU, Lc, piv = getrf_incpiv(A)
    return LU, Lc, piv, getrs_incpiv(LU, Lc, piv, B)


# -- hybrid LU/QR ------------------------------------------------------

CRITERIA = ("higham_sum", "higham_max", "higham_moy", "mumps",
            "random", "alternating")


def _panel_criterion(criterion: str, panel, nb: int, alpha: float) -> bool:
    """Data-dependent LU-acceptability test for one panel (the
    reference's Higham and MUMPS criteria, zgetrf_qrf_wrapper.c:115-201):
    True when the unpivoted LU panel is numerically acceptable."""
    d = torch.abs(torch.diagonal(panel[:nb]))
    col = torch.abs(panel)
    if criterion == "higham_sum":
        growth = torch.sum(col, dim=0)
    elif criterion == "higham_max":
        growth = torch.amax(col, dim=0)
    elif criterion == "higham_moy":
        growth = torch.mean(col, dim=0) * panel.shape[0]
    elif criterion == "mumps":
        # diagonal dominance within the diagonal block
        off = torch.sum(torch.abs(panel[:nb]), dim=0) - d
        return bool(torch.all(d >= alpha * off))
    else:
        raise ValueError(criterion)
    safe = torch.where(d > 0, d, torch.finfo(col.dtype).tiny)
    return bool(torch.all(growth <= alpha * safe))


def getrf_qrf(A: TileMatrix, criterion: str = "higham_sum",
              alpha: float | None = None, seed: int = 3872):
    """Hybrid LU/QR factorization (dplasma_zgetrf_qrf): per panel an
    unpivoted LU panel when the criterion accepts it, else a Householder
    QR panel (stability by orthogonality, without pivoting).

    Returns (factored, T, lu_tab): ``lu_tab[k]`` is 1 for an LU panel, 0
    for a QR panel (the reference's ``lu_tab``); T holds the
    compact-WY triangles of the QR panels. Solve with
    :func:`trsmpl_qrf` and an upper trsm (:func:`getrs_qrf`)."""
    if A.desc.mb != A.desc.nb:
        raise ValueError(f"getrf needs square tiles, got {A.desc}")
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}")
    nb = A.desc.nb
    KT = A.desc.KT
    X = A.pad_diag().data.clone()
    Mp, Np = X.shape
    if alpha is None:
        # the Higham criteria accept LU when growth <= alpha·|diag|
        # (larger alpha, more LU); mumps when the diagonal dominates
        # alpha·|offdiag| (larger alpha, less LU)
        alpha = 0.5 if criterion == "mumps" else float(Mp)
    Tm = torch.zeros_like(X)
    lu_tab = torch.zeros(KT, dtype=torch.int32)
    for kk in range(KT):
        s, e = kk * nb, (kk + 1) * nb
        if criterion == "random":
            use_lu = hash((seed, kk)) % 2 == 0
        elif criterion == "alternating":
            use_lu = kk % 2 == 0
        else:
            use_lu = _panel_criterion(criterion, X[s:, s:e], nb, alpha)
        if use_lu:
            d = k.getrf_nopiv(X[s:e, s:e])
            l21 = k.trsm(d, X[e:, s:e], side="R", lower=False)
            X[s:e, s:e] = d
            X[e:, s:e] = l21
            if e < Np:
                u12 = k.trsm(d, X[s:e, e:], side="L", lower=True, unit=True)
                X[s:e, e:] = u12
                X[e:, e:] -= k.dot(l21, u12)
        else:
            packed, v, T = hh.geqrt(X[s:, s:e])
            X[s:, s:e] = packed
            if e < Np:
                X[s:, e:] = hh.apply_q(v, T, X[s:, e:], trans="C")
            Tm[s:e, s:e] = T
        lu_tab[kk] = int(use_lu)
    return TileMatrix(X, A.desc), TileMatrix(Tm, A.desc), lu_tab


def trsmpl_qrf(LU: TileMatrix, Tm: TileMatrix, lu_tab,
               B: TileMatrix) -> TileMatrix:
    """Apply the qrf panel transformations to B (dplasma_ztrsmpl_qrf):
    L^-1 for LU panels, Q^H for QR panels, as ``lu_tab`` says."""
    nb = LU.desc.nb
    Y = B.zero_pad().data.clone()
    for kk in range(LU.desc.KT):
        s, e = kk * nb, (kk + 1) * nb
        pan = LU.data[s:, s:e]
        if int(lu_tab[kk]) == 1:
            y1 = k.trsm(pan[:nb], Y[s:e], side="L", lower=True, unit=True)
            Y[e:] -= k.dot(pan[nb:], y1)
            Y[s:e] = y1
        else:
            Y[s:] = hh.apply_q(k.tri(pan, lower=True, unit=True),
                               Tm.data[s:e, s:e], Y[s:], trans="C")
    return TileMatrix(Y, B.desc)


def getrs_qrf(LU: TileMatrix, Tm: TileMatrix, lu_tab,
              B: TileMatrix) -> TileMatrix:
    """Solve from a qrf factorization."""
    Y = trsmpl_qrf(LU, Tm, lu_tab, B)
    return blas3.trsm(1.0, LU, Y, side="L", uplo="U", trans="N")


def gerfs(A: TileMatrix, LU: TileMatrix, perm, B: TileMatrix,
          X: TileMatrix, iters: int = 1) -> TileMatrix:
    """Iterative refinement of a getrf_1d solve (dplasma_zgerfs):
    r = B − A X; X += A^-1 r, ``iters`` times."""
    for _ in range(iters):
        R = B.like(B.zero_pad().data
                   - k.dot(A.zero_pad().data, X.zero_pad().data))
        D = getrs("N", LU, perm, R)
        X = X.like(X.data + D.data)
    return X


# -- out-of-HBM tier ---------------------------------------------------

def _lowmem_lu_apply(col, W, j0: int):
    """One streamed finished block, applied in place: the panel's rows
    j0..j0+cw solve against W's unit-lower diagonal block, then the rows
    below take the rank-cw product. ``W`` holds only rows j0 and below
    (the rows above are never read)."""
    cw = W.shape[1]
    blk = col[j0:j0 + cw]
    u = k.trsm(W[:cw], blk, side="L", lower=True, unit=True)
    blk.copy_(u)
    if col.shape[0] > j0 + cw:
        col[j0 + cw:] -= k.dot(W[cw:], u)
    return col


def getrf_lowmem(A, nb: int = 512, budget_bytes: int | None = None, *,
                 device=None):
    """Out-of-HBM partial-pivoting LU (the reference's lowmem tier;
    ref tests/Testings.cmake:147, src/zgemm_NN_gpu.jdf:243-330).

    ``A`` is a square host numpy array (not written). A left-looking
    sweep streams finished column blocks through a device working set
    of ``3·N·cw`` elements (``cw`` from ``budget_bytes``, default MCA
    ``device.hbm_fraction`` of the device's memory); the new pivots of
    each panel swap host rows, so streamed factor columns are always in
    final row order. Returns (packed L\\U host array, perm on the
    device) with ``A[perm] = L U``. ``device``: the card by default, the
    CPU only when asked; without CUDA the default raises."""
    dev = resolve_device(device)
    H = hostlink.HostMatrix(A, dev)
    N = H.a.shape[0]
    if H.a.shape[1] != N:
        raise ValueError(f"getrf_lowmem: square only, got {H.a.shape}")
    if budget_bytes is None:
        budget_bytes = lowmem_budget(dev)
    cw = _mc.lowmem_blocking("getrf", N, H.a.itemsize, budget_bytes,
                             nb=nb)["cw"]
    perm = np.arange(N)
    for s in range(0, N, nb):
        w = min(nb, N - s)
        col = H.upload(0, N, s, s + w)
        for j0 in range(0, s, cw):
            _lowmem_lu_apply(col, H.upload(j0, N, j0, min(j0 + cw, s)), j0)
        pan, p_loc = _panel_lu(col[s:])
        if s:
            H.download(col[:s], 0, s)
        H.download(pan, s, s)
        del col, pan
        p_loc = _host(p_loc)
        H.permute_rows(s, p_loc, s, s + w)
        perm[s:] = perm[s:][p_loc]
    return H.finish(), torch.as_tensor(perm, device=dev)
