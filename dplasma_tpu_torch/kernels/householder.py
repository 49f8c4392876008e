"""Householder reflector kernels — the QR/LQ tile substrate.

Ports ``dplasma_tpu/kernels/householder.py`` (:24-286): the
compact-WY block reflector Q = I - V T V^H applied with three products,
the panel QR (``geqrt``: the vendor geqrf, cuSOLVER on the card, or
CholeskyQR2 plus Householder reconstruction under MCA
``qr_panel=cholqr``), the block-T merges of the pipelined QR sweep
(``wy_merge``, ``wy_stack``) and the stacked TS/TT couple kernels.

Every product goes through ``kernels.blas.dot`` — hence through K1
when it is enabled and the operands pass its gate — never through
``torch.matmul`` directly, as the reference routes every product
through its ``k.dot``.

Layouts differ from JAX in one place: ``torch.geqrf`` returns LAPACK's
packed layout directly, where ``jnp.linalg.qr(mode="raw")`` returns it
transposed (the reference undoes that with ``.mT``).
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.utils import config as _cfg


def geqrf_packed(a):
    """LAPACK-style packed QR: returns (packed, taus) — R on and above
    the diagonal, the Householder vectors below it (unit diagonal
    implicit)."""
    return torch.geqrf(a)


def _cholqr_active() -> bool:
    """Should the panel QR take CholeskyQR2 + reconstruction? MCA
    ``qr_panel`` in {auto, cholqr, lapack}; ``auto`` is the vendor
    panel. Callers forcing ``cholqr`` must feed numerically full-rank
    panels (ops.qr.geqrf identity-pads its edge tiles)."""
    return (_cfg.mca_get("qr_panel") or "auto").lower() == "cholqr"


def _unimodular_sign(d):
    """s = d/|d| with s = 1 where d == 0 (complex-safe)."""
    if d.is_complex():
        mag = d.abs()
        safe = torch.where(mag > 0, mag, torch.ones_like(mag))
        return torch.where(mag > 0, d / safe, torch.ones_like(d))
    return torch.where(d >= 0, torch.ones_like(d), -torch.ones_like(d))


def cholqr2(a):
    """Thin QR of a tall panel by shifted CholeskyQR2: two
    Gram → Cholesky → trsm passes, the first with a diagonal shift
    (Fukaya et al.) so the Cholesky cannot break down on an
    ill-conditioned panel. Returns (q, r)."""
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps

    def one_pass(x, shift: bool):
        g = k.dot(x, x, ta=True, conj_a=True)
        if shift:
            s = (11.0 * (m * n + n * (n + 1))) * eps
            g = g + (s * torch.trace(g).real) * torch.eye(
                n, dtype=g.dtype, device=g.device)
        ell = k.potrf(g, lower=True)  # G = L L^H, R = L^H
        q = k.trsm(ell, x, side="R", lower=True, trans="C")
        return q, ell.mH

    q, r1 = one_pass(a, shift=True)
    q, r2 = one_pass(q, shift=False)
    return q, k.dot(r2, r1)


def reconstruct_sign_shift(q):
    """The TSQR-HR sign choice and diagonal shift:
    S = -sign(diag Q1), B = Q - [S; 0]."""
    s = -_unimodular_sign(torch.diagonal(q))
    b = q.clone()
    b.diagonal().add_(-s)
    return s, b


def reconstruct_pack(s, r, v, n):
    """The packed layout: Householder-convention R = S r on and above
    the diagonal, V strictly below."""
    rh = s[:, None] * r
    m = v.shape[0]
    return torch.cat([torch.triu(rh) + torch.tril(v[:n], -1)]
                     + ([v[n:]] if m > n else []), dim=0)


def _solve_right_unit_upper(u, rhs):
    """X with X U = rhs for a unit upper-triangular U (its diagonal and
    lower triangle are not read)."""
    return torch.linalg.solve_triangular(u, rhs, upper=True, left=False,
                                         unitriangular=True)


def householder_reconstruct(q, r, s=None, return_u=False):
    """Recover the compact-WY form from a thin QR factor (Ballard,
    Demmel, Grigori et al., "Reconstructing Householder vectors from
    TSQR"): unit-lower-trapezoidal V and triangular T with
    I - V T V^H = H, H [S; 0] = Q, A = H [S R; 0]. Q - [S; 0] = V U is
    an LU without pivoting; T = -U S^-1 V1^-H.

    Returns (packed, v, t) in the CORE_zgeqrt layout (and U when
    ``return_u``)."""
    m, n = q.shape
    if s is None:
        s, b = reconstruct_sign_shift(q)
    else:
        b = q.clone()
        b.diagonal().add_(-s)
    p1 = k.getrf_nopiv_blocked(b[:n])
    v1 = k.tri(p1, lower=True, unit=True)
    u = torch.triu(p1)
    if m > n:
        v2 = k.trsm(u, b[n:], side="R", lower=False)
        v = torch.cat([v1, v2], dim=0)
    else:
        v = v1
    # T = -(U S^-1) V1^-H: solve T V1^H = rhs, V1^H unit upper
    rhs = -u * s.conj()[None, :]
    t = _solve_right_unit_upper(v1.mH, rhs)
    packed = reconstruct_pack(s, r, v, n)
    if return_u:
        return packed, v, t, u
    return packed, v, t


def geqrt_cholqr(a):
    """Panel QR by CholeskyQR2 + Householder reconstruction: the
    (packed, V, T) triple of :func:`geqrt` from products, a tile
    Cholesky, trsm and one small unpivoted LU."""
    q, r = cholqr2(a)
    return householder_reconstruct(q, r)


def split_qr(packed):
    """Split a packed geqrf result into (V, R): V unit
    lower-trapezoidal (m, n), R upper triangular (n, n), m >= n; leading
    batch axes pass through."""
    n = packed.shape[-1]
    r = torch.triu(packed[..., :n, :])
    v = k.tri(packed, lower=True, unit=True)
    return v, r


def larft(v, taus):
    """The upper-triangular T of the compact-WY form Q = I - V T V^H
    (CORE_zlarft): with B = strict_upper(V^H V) and D = diag(tau),
    T = (I + D B)^{-1} D — one product and one triangular solve. Leading
    batch axes of ``v`` and ``taus`` pass through."""
    n = taus.shape[-1]
    s = k.dot(v, v, ta=True, conj_a=True)
    b = torch.triu(s, 1)
    taus = taus.to(v.dtype)
    m = torch.eye(n, dtype=v.dtype, device=v.device) + taus[..., :, None] * b
    rhs = torch.diag_embed(taus)
    return torch.linalg.solve_triangular(m, rhs, upper=True, left=True,
                                         unitriangular=True)


def geqrt(a, *, rankfull: bool = False):
    """Tile/panel QR (CORE_zgeqrt): (packed, V, T). ``rankfull=True``
    lets MCA ``qr_panel=cholqr`` take the CholeskyQR2 path; other
    callers always get the vendor panel."""
    if rankfull and _cholqr_active():
        return geqrt_cholqr(a)
    packed, taus = geqrf_packed(a)
    v, _ = split_qr(packed)
    return packed, v, larft(v, taus)


def apply_q(v, t, c, *, trans: str = "C"):
    """C ← op(Q) C with Q = I - V T V^H (CORE_zunmqr, left side):
    trans='C' applies Q^H, 'N' applies Q."""
    tt = t.mH if trans == "C" else t
    w = k.dot(v, c, ta=True, conj_a=True)
    return c - k.dot(v, k.dot(tt, w))


def apply_q_right(v, t, c, *, trans: str = "N"):
    """C ← C op(Q) (CORE_zunmqr, right side)."""
    tt = t.mH if trans == "C" else t
    w = k.dot(c, v)
    return c - k.dot(k.dot(w, tt), v, tb=True, conj_b=True)


def wy_merge(v1, t1, v2, t2):
    """Compact-WY of Q1 Q2 (``v2`` already in ``v1``'s row frame):
    V = [V1 V2], T = [[T1, T12], [0, T2]], T12 = -T1 (V1^H V2) T2."""
    s = k.dot(v1, v2, ta=True, conj_a=True)
    t12 = k.dot(-k.dot(t1, s), t2)
    w1, w2 = t1.shape[0], t2.shape[0]
    T = torch.cat([
        torch.cat([t1, t12], dim=1),
        torch.cat([torch.zeros((w2, w1), dtype=v1.dtype, device=v1.device),
                   t2], dim=1)], dim=0)
    return torch.cat([v1, v2], dim=1), T


def wy_stack(panels):
    """Aggregate consecutive sweep panels ``[(V_0, T_0), ...]`` — each
    V_i in its own shrinking window frame — into one compact-WY pair in
    the first panel's frame: each V_i is zero-padded at the top by its
    frame offset and merged by :func:`wy_merge`."""
    v, T = panels[0]
    h = v.shape[0]
    for vi, ti in panels[1:]:
        off = h - vi.shape[0]
        vf = torch.cat([vi.new_zeros((off, vi.shape[1])), vi], dim=0) \
            if off else vi
        v, T = wy_merge(v, T, vf, ti)
    return v, T


def stacked_qr(top, bot):
    """QR of the vertical couple [top; bot] (CORE_ztsqrt/zttqrt): the
    new top triangle R, the stacked V and T."""
    n = top.shape[1]
    packed, taus = geqrf_packed(torch.cat([top, bot], dim=0))
    v, r = split_qr(packed)
    return r[:n, :], v, larft(v, taus)


def stacked_apply(v, t, c_top, c_bot, *, trans: str = "C"):
    """Apply the stacked-couple reflector to [c_top; c_bot]
    (CORE_ztsmqr/zttmqr)."""
    m_top = c_top.shape[0]
    c = apply_q(v, t, torch.cat([c_top, c_bot], dim=0), trans=trans)
    return c[:m_top, :], c[m_top:, :]
