"""QR / LQ factorization family (flat tile algorithm).

Ports ``dplasma_tpu/ops/qr.py`` (:39-81, :84-420): ``geqrf`` (with
``geqrt_rec``/``geqrf_rec``, the -z/--HNB variant), ``unmqr`` in its
four side×trans cases, ``ungqr``, ``geqrs``, and the LQ duals
``gelqf``/``unmlq``/``unglq``/``gelqs``, and the ``gels`` driver. The
factor stores R on and above the diagonal and the Householder vectors V
below it (LQ: L on and below, V above); the T triangles live in an
(nb × KT·nb) tile matrix, the reference's TS descriptor.

``geqrf`` is a right-looking shrinking-window sweep
(``ops._sweep.pipelined_sweep``): each panel goes to
``kernels.panels.qr_panel`` (MCA ``panel.kernel``: K4 under ``pallas``
where its gate holds, else the TSQR tree; the TSQR tree under ``tree``;
cuSOLVER's geqrf under ``chain``), the next block column gets a narrow
compact-WY apply (lookahead, MCA ``sweep.lookahead``) and the far
trailing matrix one aggregated apply per ``qr.agg_depth`` panels
(``householder.wy_stack``). Every product goes through
``kernels.blas.dot``, hence through K1 when it is enabled and all three
dimensions are at least 256.

Count per square factorization with KT panels, lookahead 1 and
``qr.agg_depth=4``, from the code: KT K4 launches (one per panel when
``M·nb·4 <= 8 MiB``), and, when nb >= 256, these K1 products:

- KT ``larft`` Grams VᵀV (K4's wrapper rebuilds T from the taus);
- 3 per ``apply_q``: KT − 1 narrow lookahead applies, plus the
  catch-up applies of the columns peeled from the far block at steps
  k <= KT − 3 that did not flush (k mod 4 + 1 pending panels each);
- 12 per far flush (steps k <= KT − 3 with k mod 4 = 3): 3 ``wy_merge``
  of 3 products each, and one ``apply_q``.

For KT a multiple of 4 that is KT + 3·(KT − 1 + 1.5·KT − 3) +
12·(KT − 4)/4 = 11.5·KT − 24 products: 344 at N = 8192, nb = 256.

Under MCA ``dd_gemm=always`` an f64 ``geqrf`` takes the dd panels
(unless MCA ``qr_panel=lapack``, which keeps the vendor panel): the
tree-seeded ``dd.geqrt_f64_tree`` under ``panel.kernel`` tree and
pallas (K4 is an f32 kernel) and under auto on the card (the
reference's auto on its accelerator), the limb CholeskyQR2
``dd.geqrt_f64`` under chain and under auto on the CPU (the reference's
auto there). A square panel (nb rows: a square matrix's last) takes the
tree panel whatever the kind: CholeskyQR2 seeds its Cholesky in f32 from
the Gram matrix, whose condition is the square of the panel's, and on a
square panel its Q falls far outside the -x orthogonality threshold, in
the reference's algorithm as here (PERF.md). An explicit
``panel_kernel`` (``geqrf_rec``) bypasses the dd panels. The trailing
applies are the same calls, their products limb products through
``blas.dot``. K2 launches per square factorization with KT panels at
lookahead 1 and ``qr.agg_depth`` d, from the code: 27 per chain panel
(two CholeskyQR passes of 9 — the Gram product, 3 refinement residuals
and 4 Newton products of the tile Cholesky, the Q product — the R
product, and the reconstruction's 4 ``lu_ir`` residuals and 2 + 2
``trsm_f64`` residuals), 21 per tree panel (the 3-step IR solve, one
CholeskyQR pass of 9, the R product, the reconstruction's 8), 19 for
the last (a tree panel of nb rows: no V2 solve); 3 per ``apply_q``,
KT − 1 narrow applies, and at steps k <= KT − 3 the catch-up of
k mod d + 1 held panels or a flush whose d − 1 ``wy_merge``s and one
apply make 3·d: P·(KT − 1) + 19 + 3·(KT − 1 + Σ_{k=0}^{KT−3}
(k mod d + 1)), P = 27 (chain) or 21 (tree). For d = 4 and KT a
multiple of 4: 37.5·KT − 32 (chain) and 31.5·KT − 26 (tree), 268 and
226 at N = 8192, nb = 1024. K1 takes only the reconstruction's f32
``getrf_nopiv_blocked`` products with every dimension >= 256: 3 per
panel at nb = 1024.

The out-of-HBM tier :func:`geqrf_lowmem` (qr.py:424-481) keeps the
matrix and the T stack on the host (``kernels.hostlink``) and runs a
left-looking sweep: per panel its whole column goes up, then each
finished panel's V (rows from its diagonal down, rebuilt unit-lower on
the device in place) and T, one compact-WY apply each (three K1
products in f32 when nb >= 256), updating the column in place; the
panel's own rows factor by the vendor ``householder.geqrt`` (its
``larft`` Gram one more K1 product) and go back with the R rows above
and T. KT(KT − 1)/2 applies with KT panels: at N = 16384, nb = 512, 496
applies and 3·496 + 32 = 1520 K1 launches.

``dag`` waits for ROADMAP queue 1 item 15; the phase spans and the 2-D
sharding constraint have no counterpart yet.
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
from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.kernels import panels as _panels
from dplasma_tpu_torch.kernels import quant as _quant
from dplasma_tpu_torch.observability import phases
from dplasma_tpu_torch.ops import _sweep, blas3
from dplasma_tpu_torch.utils import config as _cfg


def _quant_apply_q(v, T, c):
    """Compact-WY trailing apply Q^H C with the wide outer product
    ``V @ (T^H (V^H C))`` through ``quant.update_dot``, hence the
    block-scaled int8 GEMM under the ``ir.precision=int8`` rung; the two
    narrow inner products stay f32. ``householder.apply_q`` verbatim
    when the int8 route is inactive."""
    if not _quant.updates_active(v.dtype, c.dtype):
        return hh.apply_q(v, T, c, trans="C")
    w = k.dot(T.mH, k.dot(v, c, ta=True, conj_a=True))
    return c - _quant.update_dot(v, w)


def _check_square_tiles(A: TileMatrix, who: str):
    if A.desc.mb != A.desc.nb:
        raise ValueError(f"{who} needs square tiles, got {A.desc}")


def t_desc(A: TileMatrix) -> TileMatrix:
    """The T-factor matrix for A: one nb×nb triangle per panel."""
    nb = A.desc.nb
    return TileMatrix.zeros(nb, A.desc.KT * nb, nb, nb, dtype=A.dtype,
                            dist=A.desc.dist, device=A.device)


# -- QR ----------------------------------------------------------------

def geqrt_rec(a, hnb: int):
    """Panel QR as an hnb-wide nested sweep (the recursive-QR panel,
    -z/--HNB): sub-panels factor and apply within the panel, and their
    T triangles merge by T12 = -T1 (V1^H V2) T2. Same (packed, V, T)
    contract as ``householder.geqrt``."""
    m, nb = a.shape
    if hnb <= 0 or hnb >= nb:
        return hh.geqrt(a, rankfull=True)
    V = T = None
    packs, rrows, offs = [], [], []
    rest = a
    for j in range(0, nb, hnb):
        wj = min(hnb, nb - j)
        pk, vj, tj = hh.geqrt(rest[:, :wj], rankfull=True)
        trail = rest[:, wj:]
        if trail.shape[1]:
            trail = hh.apply_q(vj, tj, trail, trans="C")
        rrows.append(trail[:wj])      # R12 rows for later columns
        packs.append(pk)
        offs.append(j)
        vfull = torch.cat([vj.new_zeros((j, wj)), vj], dim=0) if j else vj
        if V is None:
            V, T = vfull, tj
        else:
            V, T = hh.wy_merge(V, T, vfull, tj)
        rest = trail[wj:]
    # column block i carries the R12 slices of every earlier sub-step
    # above its own (R diagonal + V below) pack
    cols = []
    for i, (pk, j) in enumerate(zip(packs, offs)):
        wi = pk.shape[1]
        tops = [rrows[t][:, j - offs[t] - rrows[t].shape[0]:
                         j - offs[t] - rrows[t].shape[0] + wi]
                for t in range(i)]
        cols.append(torch.cat(tops + [pk], dim=0))
    return torch.cat(cols, dim=1), V, T


def geqrf(A: TileMatrix, *, panel_kernel=None, lookahead=None,
          agg_depth=None) -> tuple[TileMatrix, TileMatrix]:
    """A = Q R (dplasma_zgeqrf). Returns (packed factor, T factors).

    Lookahead-pipelined sweep with aggregated far updates (module
    docstring); ``lookahead=0, agg_depth=1`` is the serialized op
    order. Defaults from MCA ``sweep.lookahead`` / ``qr.agg_depth``.
    The explicit ``panel_kernel`` callable (``geqrf_rec``) bypasses the
    panel engine."""
    _check_square_tiles(A, "geqrf")
    la, agg = _sweep.sweep_params(lookahead, agg_depth)
    nb = A.desc.nb
    KT = A.desc.KT
    NT = A.desc.NT
    rest = A.zero_pad().data
    if KT == NT and rest.shape[1] > A.desc.N:
        # Tall/square: the right-edge pad columns do get factored.
        # Identity-pad them (e_i): the pad reflectors are exact no-ops
        # on the valid region, and every panel stays full rank.
        # (zero_pad copied: there is padding.)
        idx = torch.arange(A.desc.N, rest.shape[1], device=rest.device)
        rest[idx, idx] = 1
    Ts = []       # T triangle per finished panel
    pk = _panels.panel_kernel("qr")
    # the dd route's panels (module docstring); MCA qr_panel=lapack keeps
    # the vendor panel, with dd trailing products
    use_dd = (A.dtype == torch.float64 and k._dd_active(A.dtype)
              and (_cfg.mca_get("qr_panel") or "auto").lower() != "lapack")
    dd_tree = pk in ("tree", "pallas") or (
        _panels.panel_kernel_config() == "auto" and rest.is_cuda)

    def panel(col):
        if panel_kernel is not None:
            packed, v, T = panel_kernel(col)
        elif use_dd:
            packed, v, T = (_dd.geqrt_f64_tree(col)
                            if dd_tree or col.shape[0] <= nb
                            else _dd.geqrt_f64(col))
        else:
            packed, v, T = _panels.qr_panel(col, pk)
        Ts.append(T)
        return packed, (v, T)

    def apply_block(st, blk):
        out = _quant_apply_q(st[0], st[1], blk)
        return out[:nb], out[nb:]

    def agg_apply(sts, far):
        new = _quant_apply_q(*hh.wy_stack(sts), far)
        d = len(sts)
        return ([new[i * nb:(i + 1) * nb] for i in range(d)],
                new[d * nb:])

    packs, rrows = _sweep.pipelined_sweep(
        rest, nb, KT, NT, panel, apply_block, lookahead=la,
        agg_depth=agg, agg_apply=agg_apply if agg > 1 else None)
    full = _sweep.assemble_sweep(packs, rrows, KT, NT, nb)
    Tm = t_desc(A)
    # T-factor stitching rides the assemble phase (a sibling of the span
    # inside assemble_sweep)
    with phases.span("assemble") as _f:
        Td = torch.cat(Ts, dim=1)
        if Td.shape[1] < Tm.desc.Np:
            Td = torch.cat([Td, Td.new_zeros((nb, Tm.desc.Np
                                              - Td.shape[1]))], dim=1)
        _f(Td)
    return TileMatrix(full, A.desc), TileMatrix(Td, Tm.desc)


def geqrf_rec(A: TileMatrix, hnb: int = 0):
    """Recursive-panel QR (dplasma_zgeqrf_rec, -z/--HNB): each nb-wide
    panel is itself an hnb-wide nested sweep (:func:`geqrt_rec`)."""
    if hnb <= 0 or hnb >= A.desc.nb:
        return geqrf(A)
    return geqrf(A, panel_kernel=lambda a: geqrt_rec(a, hnb))


def _qr_panels(Af: TileMatrix, Tf: TileMatrix):
    """(row_start, V, T) per panel of a geqrf result, cached on ``Af``
    for the exact (Af.data, Tf.data) pair it was split from."""
    cache = getattr(Af, "_qr_panels_cache", None)
    if cache is not None and cache[0] is Af.data and cache[1] is Tf.data:
        return cache[2]
    nb = Af.desc.nb
    out = []
    for kk in range(Af.desc.KT):
        s, e = kk * nb, (kk + 1) * nb
        v, _ = hh.split_qr(Af.data[s:, s:e])
        out.append((s, v, Tf.data[:, s:e]))
    Af._qr_panels_cache = (Af.data, Tf.data, out)
    return out


def unmqr(side: str, trans: str, Af: TileMatrix, Tf: TileMatrix,
          C: TileMatrix) -> TileMatrix:
    """C ← op(Q) C or C op(Q) (dplasma_zunmqr, the LN/LC/RN/RC cases);
    Q is the factor implicit in (Af, Tf) from :func:`geqrf`. Returns a
    new matrix; C is not modified."""
    side = side.upper()
    trans = trans.upper()
    if side not in ("L", "R") or trans not in ("N", "C", "T"):
        raise ValueError(f"unmqr: bad side/trans {side!r} {trans!r}")
    if trans == "T":  # real-case alias of ConjTrans
        trans = "C"
    panels = _qr_panels(Af, Tf)
    # Q = Q_0 Q_1 … Q_{K-1}: Q on the left runs the panels backwards,
    # Q^H forwards; the right side mirrors
    forward = (side == "L") == (trans != "N")
    if not forward:
        panels = panels[::-1]
    Y = C.zero_pad().data.clone()
    for s, v, T in panels:
        if side == "L":
            Y[s:, :] = hh.apply_q(v, T, Y[s:, :], trans=trans)
        else:
            Y[:, s:] = hh.apply_q_right(v, T, Y[:, s:], trans=trans)
    return TileMatrix(Y, C.desc)


def ungqr(Af: TileMatrix, Tf: TileMatrix, K: int | None = None) -> TileMatrix:
    """The first K (default N) columns of Q (dplasma_zungqr)."""
    M = Af.desc.M
    K = min(M, Af.desc.N) if K is None else K
    nb = Af.desc.nb
    E = TileMatrix.from_dense(
        torch.eye(M, K, dtype=Af.dtype, device=Af.device), nb, nb,
        Af.desc.dist)
    return unmqr("L", "N", Af, Tf, E)


def geqrs(Af: TileMatrix, Tf: TileMatrix, B: TileMatrix) -> TileMatrix:
    """Least-squares solve from a QR factorization (dplasma_zgeqrs):
    X = R^{-1} (Q^H B)[:N]."""
    N = Af.desc.N
    nb = Af.desc.nb
    Y = unmqr("L", "C", Af, Tf, B)
    R = TileMatrix.from_dense(Af.to_dense()[:N, :N], nb, nb, Af.desc.dist)
    Yt = TileMatrix.from_dense(Y.to_dense()[:N, :], nb, nb, B.desc.dist)
    return blas3.trsm(1.0, R, Yt, side="L", uplo="U", trans="N")


# -- LQ ----------------------------------------------------------------

def gelqf(A: TileMatrix) -> tuple[TileMatrix, TileMatrix]:
    """A = L Q (dplasma_zgelqf): the QR of A^H, conjugate-transposed
    back. Returns (packed factor, T factors): L on and below the
    diagonal, V^H above it."""
    _check_square_tiles(A, "gelqf")
    At = A.zero_pad().data.mH
    Bf, Tf = geqrf(TileMatrix(At, A.desc.transposed()))
    return TileMatrix(Bf.data.mH.contiguous(), A.desc), Tf


def unmlq(side: str, trans: str, Af: TileMatrix, Tf: TileMatrix,
          C: TileMatrix) -> TileMatrix:
    """C ← op(Q) C or C op(Q) for the LQ factor (dplasma_zunmlq): with
    A = L Q and A^H = Q' R, Q = Q'^H, so conjugate-transpose C, flip the
    side, keep trans, and conjugate-transpose back."""
    side = side.upper()
    trans = trans.upper()
    if side not in ("L", "R") or trans not in ("N", "C", "T"):
        raise ValueError(f"unmlq: bad side/trans {side!r} {trans!r}")
    if trans == "T":
        trans = "C"
    AfT = TileMatrix(Af.data.mH, Af.desc.transposed())
    CT = TileMatrix(C.zero_pad().data.mH, C.desc.transposed())
    out = unmqr("R" if side == "L" else "L", trans, AfT, Tf, CT)
    return TileMatrix(out.data.mH.contiguous(), C.desc)


def unglq(Af: TileMatrix, Tf: TileMatrix, K: int | None = None) -> TileMatrix:
    """The first K (default M) rows of Q from an LQ factorization
    (dplasma_zunglq)."""
    N = Af.desc.N
    K = min(N, Af.desc.M) if K is None else K
    nb = Af.desc.nb
    E = TileMatrix.from_dense(
        torch.eye(K, N, dtype=Af.dtype, device=Af.device), nb, nb,
        Af.desc.dist)
    return unmlq("R", "N", Af, Tf, E)


def gelqs(Af: TileMatrix, Tf: TileMatrix, B: TileMatrix) -> TileMatrix:
    """Minimum-norm solve from an LQ factorization (dplasma_zgelqs):
    X = Q^H L^{-1} B."""
    M, N = Af.desc.M, Af.desc.N
    nb = Af.desc.nb
    L = TileMatrix.from_dense(Af.to_dense()[:M, :M], nb, nb, Af.desc.dist)
    Y = blas3.trsm(1.0, L, B, side="L", uplo="L", trans="N")
    z = torch.zeros((N, B.desc.N), dtype=B.dtype, device=B.device)
    z[:M, :] = Y.to_dense()
    Z = TileMatrix.from_dense(z, nb, nb, B.desc.dist)
    return unmlq("L", "C", Af, Tf, Z)


def gels(A: TileMatrix, B: TileMatrix) -> TileMatrix:
    """Least-squares / minimum-norm driver (dplasma_zgels): the QR path
    for M >= N, the LQ path for M < N."""
    if A.desc.M >= A.desc.N:
        Af, Tf = geqrf(A)
        return geqrs(Af, Tf, B)
    Af, Tf = gelqf(A)
    return gelqs(Af, Tf, B)


# -- out-of-HBM tier ---------------------------------------------------

def _lowmem_qr_apply(col, V, T, s0: int):
    """Q^H of one streamed finished panel (its compact-WY V, T; rows s0
    and below) applied to the device column, in place — the reference
    donates ``col`` (qr.py:424-426): the tier exists to not hold a
    second N × nb buffer."""
    tail = col[s0:]
    w = k.dot(V, tail, ta=True, conj_a=True)
    tail -= k.dot(V, k.dot(T.mH, w))
    return col


def geqrf_lowmem(A, nb: int = 512, budget_bytes: int | None = None, *,
                 device=None):
    """Out-of-HBM blocked QR (the reference's lowmem tier; ref
    tests/Testings.cmake:147, src/zgemm_NN_gpu.jdf:243-330).

    ``A`` is a square host numpy array (not written). A left-looking
    sweep holds one column block on the device and streams each finished
    panel's (V, T) through it, then factors the shrinking tail with the
    vendor panel: device-live bytes stay about 3·N·nb elements;
    ``budget_bytes`` bounds them by shrinking the panel width when
    needed. Returns (packed host factor, host T stack (nb, KT·nb)) in
    the ops.qr layout. ``device``: the card by default, the CPU only
    when asked; without CUDA the default raises."""
    dev = resolve_device(device)
    H = hostlink.HostMatrix(A, dev)
    N = H.a.shape[0]
    if H.a.shape[1] != N:
        raise ValueError(f"geqrf_lowmem: square only, got {H.a.shape}")
    if budget_bytes is not None:
        nb = _mc.lowmem_blocking("geqrf", N, H.a.itemsize, budget_bytes,
                                 nb=nb)["nb"]
    KT = -(-N // nb)
    Ts = hostlink.HostMatrix(np.zeros((nb, KT * nb), H.a.dtype), dev)
    for kk in range(KT):
        s = kk * nb
        w = min(nb, N - s)
        col = H.upload(0, N, s, s + w)
        for j in range(kk):
            s0 = j * nb
            V = H.upload(s0, N, s0, s0 + nb)
            V.tril_(-1)
            V.diagonal().fill_(1)
            _lowmem_qr_apply(col, V, Ts.upload(0, nb, s0, s0 + nb), s0)
            del V
        packed, _, T = hh.geqrt(col[s:], rankfull=True)
        if s:
            H.download(col[:s], 0, s)
        H.download(packed, s, s)
        Ts.download(T, 0, s)
        del col, packed, T
    return H.finish(), Ts.finish()
