"""Algorithm-based fault tolerance (ABFT) — checksum-carried GEMM,
POTRF and LU with O(n^2) post-verification.

Ports ``dplasma_tpu/resilience/abft.py`` (Huang & Abraham's scheme and
its dense-factorization extension, Bouteiller et al.): checksum rows
and columns are appended to the operands, carried through the same
computation, and compared with direct sums afterwards, so a corrupted
tile is detected and located in O(n^2) instead of recomputed in O(n^3).
One checksum row/column per tile row/column block, appended as extra
tiles of the padded ``TileMatrix`` storage:

- **GEMM** (:func:`gemm_checksummed` / :func:`gemm_verify`): ``[A;
  S_A] @ [B, S_B]`` is one product through ``blas.dot`` (K1 when it is
  enabled and the operands are eligible; the limb route and K2 under
  ``dd_gemm=always``), giving C and its row and column checksum
  blocks. A tile flagged by both checksums is recomputed (one
  ``blas.dot`` of O(mb·nb·K)); the input-side probe ``alpha·A(Bw) +
  beta·Cw`` against ``C'w`` catches a fault that corrupts data and
  checksums consistently.
- **POTRF** (:func:`potrf_checksummed` / :func:`potrf_verify`): the
  bordered matrix ``[[A, A w], [wᵀA, B]]`` factors so that the border
  row of the factor is the carried checksum ``wᵀL``, computed by the
  same panel solves as L; verified against L's column sums and the
  probe ``A w − L(Lᴴ w)``.
- **LU** (:func:`getrf_nopiv_checksummed`, :func:`getrf_checksummed`
  and their verifies): an appended column ``A w`` is carried into ``U
  w`` by the sweep's solves, verified against U's row sums and the
  probe ``(P A) w − L(U w)``.

Non-finite corruption is located exactly (a per-tile scan); a silent
finite fault is located from the mismatch pattern. Correction beyond
GEMM is the ladder's (:mod:`~dplasma_tpu_torch.resilience.guard`).
Verification runs under :func:`inject.suppressed`; its matrix-vector
probes are plain ``torch.matmul``, as the reference's are ``@``.
"""
from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np
import torch

from dplasma_tpu_torch.descriptors import TileDesc, TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.ops import blas3, norms
from dplasma_tpu_torch.ops.checks import THRESHOLD, _eps
from dplasma_tpu_torch.resilience import inject


def _blocksum(x, mt: int, mb: int, nt: int, nb: int):
    """Per-tile sums of a padded (mt*mb, nt*nb) dense array."""
    return x.reshape(mt, mb, nt, nb).sum(dim=(1, 3))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def nonfinite_tiles(x, mb: int, nb: int) -> List[Tuple[int, int]]:
    """Tile coordinates holding NaN/Inf (a host-side list, row-major)."""
    m, n = x.shape
    mt, nt = -(-m // mb), -(-n // nb)
    bad = torch.zeros((mt * mb, nt * nb), dtype=torch.int32,
                      device=x.device)
    bad[:m, :n] = (~torch.isfinite(x)).to(torch.int32)
    cnt = _np(_blocksum(bad, mt, mb, nt, nb))
    return [(int(i), int(j)) for i, j in np.argwhere(cnt > 0)]


def _finite_max(*arrays) -> float:
    """max |finite entry| over the arrays; a complex array counts its
    real part, as the reference's float64 cast does."""
    out = 0.0
    for a in arrays:
        a = _np(a)
        if np.iscomplexobj(a):
            a = a.real
        a = np.abs(np.asarray(a, dtype=np.float64).ravel())
        a = a[np.isfinite(a)]
        if a.size:
            out = max(out, float(a.max()))
    return out


def _flag_outliers(diff, floor: float):
    """Mismatch mask over a checksum-difference population: an entry is
    flagged when it exceeds both the rounding floor and 20 times the
    population's median (a single corrupted tile leaves the other
    entries as a live noise estimate). NaN/Inf always flag."""
    a = np.abs(np.asarray(diff, dtype=np.float64))
    fin = a[np.isfinite(a)]
    noise = float(np.median(fin)) if fin.size else 0.0
    thr = max(floor, 20.0 * noise)
    with np.errstate(invalid="ignore"):
        return ~(a <= thr)


def _scalar(v, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


# --------------------------------------------------------------- GEMM

def gemm_checksummed(alpha, A: TileMatrix, B: TileMatrix, beta,
                     C: TileMatrix, transa: str = "N",
                     transb: str = "N") -> TileMatrix:
    """C = alpha op(A) op(B) + beta C with checksum tiles carried
    through the product: returns the augmented result (MT checksum rows
    and NT checksum columns after the padded C region)."""
    mb, nb = C.desc.mb, C.desc.nb
    MT, NT = C.desc.MT, C.desc.NT
    a = blas3._op(A.zero_pad().data, transa)
    b = blas3._op(B.zero_pad().data, transb)
    c = C.zero_pad().data
    Mp, Kp = a.shape
    Np = b.shape[1]
    # checksum blocks by reshape-sum: they must ride the SAME product
    # as the data, not a second clean one
    sa = a.reshape(MT, mb, Kp).sum(dim=1)            # (MT, Kp)
    sb = b.reshape(Kp, NT, nb).sum(dim=2)            # (Kp, NT)
    crow = c.reshape(MT, mb, Np).sum(dim=1)          # (MT, Np)
    ccol = c.reshape(Mp, NT, nb).sum(dim=2)          # (Mp, NT)
    ccc = crow.reshape(MT, NT, nb).sum(dim=2)        # (MT, NT)
    aug_a = torch.cat([a, sa], dim=0)
    aug_b = torch.cat([b, sb], dim=1)
    aug_c = torch.cat([torch.cat([c, ccol], dim=1),
                       torch.cat([crow, ccc], dim=1)], dim=0)
    TA = TileMatrix.from_dense(aug_a, mb, nb, C.desc.dist)
    TB = TileMatrix.from_dense(aug_b, mb, nb, C.desc.dist)
    TC = TileMatrix.from_dense(aug_c, mb, nb, C.desc.dist)
    return blas3.gemm(alpha, TA, TB, beta, TC)


def gemm_verify(out_aug: TileMatrix, alpha, A: TileMatrix, B: TileMatrix,
                beta, C0: TileMatrix, transa: str = "N",
                transb: str = "N", max_correct: int = 4):
    """Verify (and correct) a checksummed GEMM. Returns ``(C_plain,
    report)``; a tile flagged by both the carried row and column
    checksums is recomputed in place (O(mb·nb·K) a tile). The
    input-side probe ``alpha·A(Bw) + beta·Cw`` against ``C'w`` (w =
    ones) catches a fault that corrupts data and checksums alike (a
    ``zero@gemm`` of the whole augmented product)."""
    with inject.suppressed():
        mb, nb = C0.desc.mb, C0.desc.nb
        MT, NT = C0.desc.MT, C0.desc.NT
        Mp, Np = C0.desc.Mp, C0.desc.Np
        d = out_aug.to_dense()
        core = d[:Mp, :Np].clone()
        act = _blocksum(core, MT, mb, NT, nb)
        exp_r = d[Mp:Mp + MT, :Np].reshape(MT, NT, nb).sum(dim=2)
        exp_c = d[:Mp, Np:Np + NT].reshape(MT, mb, NT).sum(dim=1)
        actn, rn, cn = (_np(x) for x in (act, exp_r, exp_c))
        a = blas3._op(A.zero_pad().data, transa)
        b = blas3._op(B.zero_pad().data, transb)
        c0 = C0.zero_pad().data
        Kdim = a.shape[1]
        eps = _eps(C0.dtype)
        scale = max(_finite_max(actn, rn, cn), 1.0)
        # rounding of a block sum grows ~sqrt(work); 8x sqrt-scaled eps
        # sits ~2 decades above clean noise and below the smallest
        # significant-half bitflip
        floor = 8.0 * eps * np.sqrt(Kdim + mb * nb) * scale
        m1 = _flag_outliers(actn - rn, floor)
        m2 = _flag_outliers(actn - cn, floor)
        both = m1 & m2
        located = [(int(i), int(j)) for i, j in np.argwhere(both)]
        al = _scalar(alpha, C0.dtype, c0.device)
        be = _scalar(beta, C0.dtype, c0.device)
        w = torch.ones((Np,), dtype=C0.dtype, device=c0.device)
        lhs = al * (a @ (b @ w)) + be * (c0 @ w)
        s_prb = max(_finite_max(lhs), 1.0)

        def probe_bad(cur):
            prb = _np(lhs - cur @ w)
            with np.errstate(invalid="ignore"):
                return ~(np.abs(prb) <= THRESHOLD * eps
                         * max(Kdim, Np) * s_prb)
        bad_prb = probe_bad(core)
        detected = bool(m1.any() or m2.any() or bad_prb.any())
        corrected = False
        if located and len(located) <= max_correct:
            for (i, j) in located:
                r0, r1 = i * mb, (i + 1) * mb
                c0_, c1 = j * nb, (j + 1) * nb
                core[r0:r1, c0_:c1] = al * k.dot(a[r0:r1, :], b[:, c0_:c1]) \
                    + be * c0[r0:r1, c0_:c1]
            corrected = True
            bad_prb = probe_bad(core)   # re-probe the corrected product
        plain = TileMatrix(core, C0.desc).zero_pad()
        report = {
            "scheme": "gemm", "detected": detected,
            "located": [list(t) for t in located],
            "corrected": corrected,
            "mismatches": {"row_chk": int(m1.sum()),
                           "col_chk": int(m2.sum()),
                           "probe": int(bad_prb.sum())},
            "ok": ((not detected) or corrected)
            and not bool(bad_prb.any()),
        }
        return plain, report


# -------------------------------------------------------------- POTRF

def potrf_checksummed(A: TileMatrix, uplo: str = "L",
                      hnb: int = 0) -> TileMatrix:
    """Cholesky of the checksum-bordered matrix: one extra tile
    row/column carries ``wᵀL`` (``U w``) through the same panel solves
    that compute the factor. Returns the augmented factor."""
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    mb = A.desc.mb
    Np = A.desc.Np
    N = A.desc.N
    lower = uplo.upper() == "L"
    base = A.pad_diag().data
    full = norms._sym_full(A, uplo, conj=True)
    s = full.sum(dim=0)                        # wᵀA == (A w)ᵀ, w = ones
    # border diagonal: strictly dominates the Schur complement wᵀA w
    b00 = full.sum() + full.abs().sum() + 1.0
    aug = torch.zeros((Np + mb, Np + mb), dtype=A.dtype, device=A.device)
    aug[:Np, :Np] = base
    idx = torch.arange(Np + 1, Np + mb, device=A.device)
    aug[idx, idx] = 1.0
    aug[Np, Np] = b00.to(A.dtype)
    if lower:
        aug[Np, :N] = s.to(A.dtype)
    else:
        aug[:N, Np] = s.conj().to(A.dtype)
    tm = TileMatrix(aug, TileDesc(Np + mb, Np + mb, mb, mb, A.desc.dist))
    return potrf_mod.potrf_rec(tm, uplo, hnb) if hnb > 0 \
        else potrf_mod.potrf(tm, uplo)


def potrf_verify(L_aug: TileMatrix, A0: TileMatrix, uplo: str = "L"):
    """Carried-checksum and probe verification of a checksummed POTRF.
    Returns ``(L_plain, report)``: detection and tile location, no
    correction (the ladder remediates)."""
    with inject.suppressed():
        mb = A0.desc.mb
        N, Np = A0.desc.N, A0.desc.Np
        lower = uplo.upper() == "L"
        Ld = L_aug.data
        L = Ld[:Np, :Np]
        tri = L[:N, :N]
        if lower:
            carried = Ld[Np, :N]
            direct = tri.sum(dim=0)            # wᵀL, columns
        else:
            carried = Ld[:N, Np]
            direct = tri.sum(dim=1)            # U w, rows
        a_sym = norms._sym_full(A0, uplo, conj=True)
        w = torch.ones((N,), dtype=A0.dtype, device=A0.device)
        if lower:
            probe = a_sym @ w - tri @ (tri.mH @ w)
        else:
            probe = a_sym @ w - tri.mH @ (tri @ w)
        dchk = _np(carried - direct)
        prb = _np(probe)
        eps = _eps(A0.dtype)
        s_chk = max(_finite_max(carried, direct), 1.0)
        s_prb = max(_finite_max(a_sym @ w), 1.0)
        with np.errstate(invalid="ignore"):
            bad_chk = ~(np.abs(dchk) <= THRESHOLD * eps * N * s_chk)
            bad_prb = ~(np.abs(prb) <= THRESHOLD * eps * N * s_prb)
        nf = nonfinite_tiles(tri, mb, mb)
        detected = bool(nf or bad_chk.any() or bad_prb.any())
        located: List[list] = [list(t) for t in nf]
        if not located and detected:
            # the checksum mismatch names the column block (row block
            # for U), the probe the row block
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                j = int(np.nanargmax(np.abs(dchk))) // mb \
                    if bad_chk.any() else None
                i = int(np.nanargmax(np.abs(prb))) // mb \
                    if bad_prb.any() else None
            if not lower:
                i, j = j, i
            located = [[i, j]]
        report = {
            "scheme": "potrf", "detected": detected, "located": located,
            "corrected": False,
            "mismatches": {"checksum": int(bad_chk.sum()),
                           "probe": int(bad_prb.sum()),
                           "nonfinite_tiles": len(nf)},
            "ok": not detected,
        }
        return TileMatrix(L, A0.desc), report


# ----------------------------------------------------------------- LU

def _lu_augment(A: TileMatrix) -> TileMatrix:
    """Append one checksum tile column holding ``A w`` (the first column
    of the appended block; the panel solves carry it into ``U w``)."""
    nb = A.desc.nb
    Np = A.desc.Np
    N = A.desc.N
    base = A.pad_diag().data
    aug = torch.zeros((Np, Np + nb), dtype=A.dtype, device=A.device)
    aug[:, :Np] = base
    aug[:N, Np] = A.to_dense() @ torch.ones((N,), dtype=A.dtype,
                                            device=A.device)
    return TileMatrix(aug, TileDesc(Np, Np + nb, A.desc.mb, nb,
                                    A.desc.dist))


def getrf_nopiv_checksummed(A: TileMatrix) -> TileMatrix:
    from dplasma_tpu_torch.ops import lu
    return lu.getrf_nopiv(_lu_augment(A))


def getrf_checksummed(A: TileMatrix, hnb: int = 0):
    """Partial-pivoting variant (``hnb`` > 0: the recursive-panel sweep,
    as the plain driver's -z/--HNB); the appended checksum column sits
    beyond column N and never takes part in pivot selection."""
    from dplasma_tpu_torch.ops import lu
    return lu.getrf_rec(_lu_augment(A), hnb)


def _getrf_verify(F_aug: TileMatrix, A0: TileMatrix, perm):
    with inject.suppressed():
        nb = A0.desc.nb
        N, Np = A0.desc.N, A0.desc.Np
        Fd = F_aug.data
        F = Fd[:Np, :Np]
        carried = Fd[:N, Np]                   # U w, carried
        U = torch.triu(F)
        direct = U[:N, :N].sum(dim=1)
        # input-side probe: (P A) w − L (U w)
        ap = A0.pad_diag().data
        w = torch.zeros((Np,), dtype=A0.dtype, device=A0.device)
        w[:N] = 1
        v = ap @ w
        if perm is not None:
            v = v[perm]
        recon = k.tri(F, lower=True, unit=True) @ (U @ w)
        dchk = _np(carried - direct)
        prb = _np(v - recon)
        eps = _eps(A0.dtype)
        s_chk = max(_finite_max(carried, direct), 1.0)
        s_prb = max(_finite_max(v), 1.0)
        with np.errstate(invalid="ignore"):
            bad_chk = ~(np.abs(dchk) <= THRESHOLD * eps * N * s_chk)
            bad_prb = ~(np.abs(prb) <= THRESHOLD * eps * N * s_prb)
        nf = nonfinite_tiles(F[:N, :N], A0.desc.mb, nb)
        detected = bool(nf or bad_chk.any() or bad_prb.any())
        located: List[list] = [list(t) for t in nf]
        if not located and detected:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                i = int(np.nanargmax(np.abs(dchk))) // A0.desc.mb \
                    if bad_chk.any() else (
                        int(np.nanargmax(np.abs(prb))) // A0.desc.mb
                        if bad_prb.any() else None)
            located = [[i, None]]
        report = {
            "scheme": "getrf", "detected": detected, "located": located,
            "corrected": False,
            "mismatches": {"checksum": int(bad_chk.sum()),
                           "probe": int(bad_prb.sum()),
                           "nonfinite_tiles": len(nf)},
            "ok": not detected,
        }
        return TileMatrix(F, A0.desc), report


def getrf_nopiv_verify(F_aug: TileMatrix, A0: TileMatrix):
    return _getrf_verify(F_aug, A0, None)


def getrf_verify(out, A0: TileMatrix):
    """Verify a checksummed pivoted LU: ``out`` is ``(F_aug, perm)``;
    returns ``((F_plain, perm), report)`` (the getrf_1d contract)."""
    F_aug, perm = out
    F_plain, report = _getrf_verify(F_aug, A0, perm)
    return (F_plain, perm), report
