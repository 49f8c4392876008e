"""Cholesky factorization family: POTRF / POTRS / POSV / TRTRI / LAUUM /
POTRI / POINV.

Ports ``dplasma_tpu/ops/potrf.py`` (:44-184, :352-431): the LEFT-looking
block-column sweep. Step k gathers the update of column k from the
finished panels — the ``la`` freshest as individual narrow products
(lookahead), every older one folded into ONE aggregated product over
the concatenated panels (``far_flush``) — then factors the diagonal
tile and solves the panel. Every update product goes through
``quant.update_dot`` → ``kernels.blas.dot``, which sends it to the K1
kernel when that is enabled and eligible. With lookahead 1 and
nt = N/nb block columns that is one product for column 1 and two for
each later column: 2·nt − 3 products per factorization.

Under MCA ``dd_gemm=always`` a real f64 factorization (with the default
diagonal kernel) is instead ``kernels.dd.potrf_f64_blocked`` on the
padded data, as in the reference: 5·nt − 3 exact limb products, each
closed by kernel K2; ``potrs``/``posv`` then solve through
``blas3.trsm`` → ``dd.trsm_f64``.

Lookahead only regroups products, so every lookahead agrees with the
reference within rounding. Only the ``uplo`` triangle of the input is
read; the opposite triangle of the result is zero. INFO (non-SPD input)
surfaces as NaNs in the factor.

The inverse family: ``trtri`` is a blocked recursion split on a tile
boundary — two half-size inverses and two products per level, the
leaves one tile inverse each (``kernels.blas.trtri``, ``dd.trtri_f64``
under ``dd_gemm=always``). At KT diagonal tiles that is 2·(KT − 1)
products (30 at KT = 16). ``lauum`` is one product, ``potri`` =
``lauum ∘ trtri`` and ``poinv`` = ``potri ∘ potrf``. Every product goes
through ``kernels.blas.dot``: K1 in f32, K2 under the dd route.

The out-of-HBM tier ``potrf_lowmem`` (potrf.py:269-350) keeps the
matrix on the host and streams it through a device working set of
``N·(cw + 3·nb)`` elements (``analysis.memcheck.lowmem_blocking``): per
panel, its column and then each finished chunk of ``cw`` columns go up
(``kernels.hostlink``: pinned memory, one pitched copy a block), each
chunk is one update product, and the factored panel goes back. With
``nt`` panels that is Σₖ ceil(k·nb / cw) update products, one K1 launch
each in f32 (185 at N = 32768, nb = 512, cw = 6656); the panel solve is
cuBLAS's. Host → device it moves Σ (N − s)(s + w) elements, device →
host Σ (N − s)·w.

``dag`` waits for ROADMAP queue 1 item 15.
"""
from __future__ import annotations

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.analysis import memcheck as _mc
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import dd as _dd
from dplasma_tpu_torch.kernels import hostlink
from dplasma_tpu_torch.kernels import quant as _quant
from dplasma_tpu_torch.ops import blas3
from dplasma_tpu_torch.ops import gemm as _gemm
from dplasma_tpu_torch.ops._sweep import sweep_params
from dplasma_tpu_torch.ops.aux import _tri_mask


def potrf(A: TileMatrix, uplo: str = "L", *, diag_kernel=None,
          lookahead=None) -> TileMatrix:
    """Tile Cholesky: A = L L^H (uplo=L) or A = U^H U (uplo=U).

    ``diag_kernel`` replaces the diagonal-tile factorizer
    (kernels.blas.potrf) — the recursive-variant hook. ``lookahead``
    (default MCA ``sweep.lookahead``) is how many of the freshest
    panels update column k individually; 0 is the per-panel
    baseline."""
    la, _ = sweep_params(lookahead)
    dk = diag_kernel if diag_kernel is not None else k.potrf
    if A.desc.mb != A.desc.nb or A.desc.M != A.desc.N:
        raise ValueError(f"potrf needs a square matrix of square tiles, "
                         f"got {A.desc}")
    nt = A.desc.KT
    mb = A.desc.mb
    lower = uplo.upper() == "L"
    X = A.pad_diag().data
    if (diag_kernel is None and A.dtype == torch.float64
            and k._dd_active(A.dtype)):
        # the f64-equivalent route: the limb-cached blocked factorization
        # replaces the whole sweep (dplasma_tpu/ops/potrf.py:71-79)
        return TileMatrix(_dd.potrf_f64_blocked(X, nb=mb, lower=lower),
                          A.desc)
    Mp = X.shape[0]

    # cols[j]: finished block column j (lower: rows j*mb.., width mb;
    # upper: the mirrored row block), diagonal tile at the top/left.
    cols = []
    for kk in range(nt):
        s = kk * mb
        fresh_from = max(kk - la, 0) if la > 0 else 0
        if lower:
            col = X[s:, s:s + mb]
            if fresh_from > 0:
                W = torch.cat([cols[j][s - j * mb:]
                               for j in range(fresh_from)], dim=1)
                B = torch.cat([cols[j][s - j * mb:s - j * mb + mb]
                               for j in range(fresh_from)], dim=1)
                col = col - _quant.update_dot(W, B, tb=True, conj_b=True)
            for j in range(fresh_from, kk):
                Lj = cols[j]
                off = s - j * mb
                col = col - _quant.update_dot(
                    Lj[off:, :], Lj[off:off + mb, :], tb=True, conj_b=True)
            lkk = dk(col[:mb], lower=True)
            if s + mb < Mp:
                pan = k.trsm(lkk, col[mb:], side="R", lower=True,
                             trans="C")
                cols.append(torch.cat([lkk, pan], dim=0))
            else:
                cols.append(lkk)
        else:
            row = X[s:s + mb, s:]
            if fresh_from > 0:
                W = torch.cat([cols[j][:, s - j * mb:]
                               for j in range(fresh_from)], dim=0)
                B = torch.cat([cols[j][:, s - j * mb:s - j * mb + mb]
                               for j in range(fresh_from)], dim=0)
                row = row - _quant.update_dot(B, W, ta=True, conj_a=True)
            for j in range(fresh_from, kk):
                Uj = cols[j]
                off = s - j * mb
                row = row - _quant.update_dot(
                    Uj[:, off:off + mb], Uj[:, off:], ta=True, conj_a=True)
            ukk = dk(row[:, :mb], lower=False)
            if s + mb < Mp:
                pan = k.trsm(ukk, row[:, mb:], side="L", lower=False,
                             trans="C")
                cols.append(torch.cat([ukk, pan], dim=1))
            else:
                cols.append(ukk)
    full = torch.zeros_like(X)
    for j, c in enumerate(cols):
        if lower:
            full[j * mb:, j * mb:(j + 1) * mb] = c
        else:
            full[j * mb:(j + 1) * mb, j * mb:] = c
    return TileMatrix(full, A.desc)


def potrf_rec(A: TileMatrix, uplo: str = "L",
              hnb: int = 0) -> TileMatrix:
    """Recursive-variant Cholesky (dplasma_zpotrf_rec, -z/--HNB): the
    diagonal-tile factorization is itself a nested sweep over ``hnb``
    subtiles; ``hnb`` of 0 or >= the tile size is plain :func:`potrf`."""
    if hnb <= 0 or hnb >= A.desc.mb:
        return potrf(A, uplo)

    def nested(a, lower=True):
        sub = TileMatrix.from_dense(a, hnb, hnb)
        return potrf(sub, "L" if lower else "U").to_dense()

    return potrf(A, uplo, diag_kernel=nested)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def lowmem_budget(device) -> int:
    """The lowmem tiers' default budget: MCA ``device.hbm_fraction`` of
    the device's memory (``ops.gemm.device_memory_bytes``)."""
    return int(_gemm.hbm_fraction() * _gemm.device_memory_bytes(device))


def plan_potrf_lowmem(N: int, dtype, budget_bytes: int):
    """Blocking of the out-of-HBM tier: panel width ``nb`` and streamed
    chunk width ``cw`` such that one (N, nb) panel, one (N, cw) chunk
    and the update temporaries (~two more panels) fit the budget — the
    inequality of ``analysis.memcheck.lowmem_blocking`` (the
    reference's, line for line). ``dtype``: a numpy or torch dtype."""
    blk = _mc.lowmem_blocking("potrf", N, _itemsize(dtype), budget_bytes)
    return blk["nb"], blk["cw"]


def _lowmem_upd(col, W):
    """col -= W @ W[:width]^H, in place (W's rows align with col's)."""
    col -= k.dot(W, W[:col.shape[1]], tb=True, conj_b=True)
    return col


def _lowmem_panel(col):
    w = col.shape[1]
    lkk = k.potrf(col[:w], lower=True)
    if col.shape[0] > w:
        pan = k.trsm(lkk, col[w:], side="R", lower=True, trans="C")
        return torch.cat([lkk, pan], dim=0)
    return lkk


def potrf_lowmem(A, nb: int | None = None, budget_bytes: int | None = None,
                 *, device=None):
    """Out-of-HBM Cholesky (the reference's lowmem tier, potrf.py:293-350;
    ref tests/Testings.cmake:147, src/zgemm_NN_gpu.jdf:243-330).

    ``A`` is a host numpy array (its lower triangle is read; it is not
    written). A left-looking panel sweep streams block columns through a
    device working set sized to ``budget_bytes`` (default: MCA
    ``device.hbm_fraction`` of the device's memory): per panel, the
    finished columns come up in ``cw``-wide chunks, one update product
    each, then the panel is factored on the device and written back.
    Returns the host factor (lower; on the card a view of the tier's
    pinned host copy). ``device``: the card by default, the CPU only
    when asked; without CUDA the default raises."""
    dev = resolve_device(device)
    H = hostlink.HostMatrix(A, dev)
    N = H.a.shape[0]
    if budget_bytes is None:
        budget_bytes = lowmem_budget(dev)
    nb_p, cw = plan_potrf_lowmem(N, H.a.dtype, budget_bytes)
    if nb is None:
        nb = nb_p
    cw = max(cw // nb * nb, nb)
    for s in range(0, N, nb):
        w = min(nb, N - s)
        col = H.upload(s, N, s, s + w)
        for j0 in range(0, s, cw):
            _lowmem_upd(col, H.upload(s, N, j0, min(j0 + cw, s)))
        H.download(_lowmem_panel(col), s, s)
        del col
    L = H.finish()
    for r0 in range(0, N, nb):       # np.tril, in place, a row block a time
        r1 = min(r0 + nb, N)
        L[r0:r1, r1:] = 0
        L[r0:r1, r0:r1] = np.tril(L[r0:r1, r0:r1])
    return L


def potrs(A: TileMatrix, B: TileMatrix, uplo: str = "L") -> TileMatrix:
    """Solve A X = B given the Cholesky factor (dplasma_zpotrs: two
    blocked TRSM sweeps)."""
    if uplo.upper() == "L":
        y = blas3.trsm(1.0, A, B, side="L", uplo="L", trans="N")
        return blas3.trsm(1.0, A, y, side="L", uplo="L", trans="C")
    y = blas3.trsm(1.0, A, B, side="L", uplo="U", trans="C")
    return blas3.trsm(1.0, A, y, side="L", uplo="U", trans="N")


def posv(A: TileMatrix, B: TileMatrix, uplo: str = "L"):
    """Factor + solve (dplasma_zposv). Returns (factor, X)."""
    L = potrf(A, uplo)
    return L, potrs(L, B, uplo)


def _trtri_rec(x, lower: bool, unit: bool, base: int):
    """Blocked-recursive triangular inverse: inv([[A, 0], [C, B]]) =
    [[inv A, 0], [−inv B · C · inv A, inv B]] (and its upper mirror),
    split on a tile boundary, leaves of at most ``base`` rows."""
    n = x.shape[0]
    if n <= base:
        return k.trtri(x, lower=lower, unit=unit)
    h = (n // 2 + base - 1) // base * base  # split on a tile boundary
    h = min(max(h, base), n - base)
    zeros = x.new_zeros
    if lower:
        a, c, b = x[:h, :h], x[h:, :h], x[h:, h:]
        ia = _trtri_rec(a, lower, unit, base)
        ib = _trtri_rec(b, lower, unit, base)
        off = -k.dot(k.dot(ib, c), ia)
        return torch.cat([torch.cat([ia, zeros((h, n - h))], dim=1),
                          torch.cat([off, ib], dim=1)], dim=0)
    a, c, b = x[:h, :h], x[:h, h:], x[h:, h:]
    ia = _trtri_rec(a, lower, unit, base)
    ib = _trtri_rec(b, lower, unit, base)
    off = -k.dot(k.dot(ia, c), ib)
    return torch.cat([torch.cat([ia, off], dim=1),
                      torch.cat([zeros((n - h, h)), ib], dim=1)], dim=0)


def trtri(A: TileMatrix, uplo: str = "L", diag: str = "N") -> TileMatrix:
    """Triangular inverse (dplasma_ztrtri) of the ``uplo`` triangle, on
    the padded matrix with an identity pad diagonal; the opposite
    triangle of the result is zero."""
    lower = uplo.upper() == "L"
    unit = diag.upper() == "U"
    X = A.pad_diag().data
    inv = _trtri_rec(X, lower, unit, max(A.desc.nb, 1))
    m = _tri_mask(A.desc.Mp, A.desc.Np, uplo, A.device)
    return TileMatrix(torch.where(m, inv, inv.new_zeros(())), A.desc)


def lauum(A: TileMatrix, uplo: str = "L") -> TileMatrix:
    """L^H L (lower) or U U^H (upper) of a triangular factor
    (dplasma_zlauum): one product, stored in the ``uplo`` triangle; the
    opposite triangle keeps A's."""
    x = A.to_dense()
    prod = k.lauum(x, lower=(uplo.upper() == "L"))
    m = _tri_mask(A.desc.M, A.desc.N, uplo, A.device)
    out = torch.where(m, prod, x)
    return TileMatrix.from_dense(out, A.desc.mb, A.desc.nb, A.desc.dist)


def potri(A: TileMatrix, uplo: str = "L") -> TileMatrix:
    """A^{-1} from the Cholesky factor (dplasma_zpotri = trtri ∘ lauum),
    in the ``uplo`` triangle."""
    return lauum(trtri(A, uplo), uplo)


def poinv(A: TileMatrix, uplo: str = "L") -> TileMatrix:
    """Direct SPD inverse (dplasma_zpoinv): potrf, trtri and lauum."""
    return potri(potrf(A, uplo), uplo)
