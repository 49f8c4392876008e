"""Panel-factorization engine: the QR tree panel and the recursive LU
panel.

Ports ``dplasma_tpu/kernels/panels.py`` (:56-297): the MCA
``panel.kernel`` resolution; the TSQR/CAQR binary-reduction QR panel
(:func:`tsqr`, :func:`geqrt_tree`: batched leaf QRs, an O(log mt) tree
of batched stacked QRs, the root's thin Q pushed back down, then TSQR-HR
Householder reconstruction to the compact-WY contract) and
:func:`qr_panel`; the blocked-recursive pivoted panel (Toledo's
recursive LU; :func:`lu_panel_rec`) with its unpivoted twin. Pivot ties
break to the LOWEST row index: ``torch.argmax`` returns the first
maximum.

``panel.kernel`` in {auto, chain, rec, tree, pallas}: ``chain`` is the
per-route vendor panel (cuSOLVER on the card), ``rec`` the recursive
LU panel, ``tree`` the TSQR QR panel, ``pallas`` the fused panel kernels
(K3 for LU, ``kernels/pallas_lu.py``; K4 for QR,
``kernels/pallas_qr.py``). ``auto`` resolves to ``chain``: the reference
picks tree/rec only on a TPU, and no backend of the port is one. The
port's fused kernels build at their first launch and raise there if the
build fails, so ``pallas`` never degrades to ``rec`` for want of a
runtime (the reference's ``_pallas_ready`` probe has no counterpart);
the unpivoted route, which has no fused kernel, still takes ``rec``.

"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.kernels import pallas_qr
from dplasma_tpu_torch.utils import config as _cfg

_KERNELS = ("auto", "chain", "rec", "tree", "pallas")

_cfg.mca_register(
    "panel.kernel", "auto",
    "Panel-factorization kernel of the blocked sweeps (ops.qr geqrf, "
    "ops.lu pivoted and nopiv): chain (the per-route vendor panel), rec "
    "(blocked-recursive LU panel, vectorized pivot search; QR maps it "
    "to tree), tree (the TSQR QR panel; LU maps it to rec), pallas (the "
    "fused panel kernels written for the card, K3 for LU and K4 for QR, "
    "where their shape gate holds; the unpivoted route takes rec), auto "
    "(chain: the reference picks tree/rec on a TPU only).")
_cfg.mca_register(
    "panel.tree_leaf", "2",
    "Leaf-block height of the TSQR tree panel, in multiples of the "
    "panel width (>=1): taller leaves mean fewer tree levels, shorter "
    "leaves more batch parallelism per level.")
_cfg.mca_register(
    "panel.rec_base", "8",
    "Base-case column width of the blocked-recursive LU panel: below "
    "this width columns eliminate by the vectorized pivot loop; above "
    "it, recursion halves (trsm + rank-h Schur per level).")


def panel_kernel_config() -> str:
    """The raw MCA ``panel.kernel`` value."""
    return (_cfg.mca_get("panel.kernel") or "auto").lower()


def panel_kernel(route: str) -> str:
    """Resolve the active panel kernel for ``route`` in {qr, lu,
    nopiv}: the explicit MCA value wins (cross-family names map to the
    route's own engine: tree->rec for LU, rec->tree for QR), ``auto``
    is ``chain``, and ``pallas`` on the unpivoted route is ``rec``."""
    v = panel_kernel_config()
    if v not in _KERNELS or v == "auto":
        v = "chain"
    if v == "pallas" and route == "nopiv":
        v = "rec"
    if route == "qr" and v == "rec":
        v = "tree"
    elif route in ("lu", "nopiv") and v == "tree":
        v = "rec"
    return v


# ---------------------------------------------------------------------
# TSQR tree panel (QR)
# ---------------------------------------------------------------------

def _mm(a, b):
    """Full-precision (batched) product for the tree's push-down (TF32
    is off package-wide, the reference's ``Precision.HIGHEST``)."""
    return torch.matmul(a, b)


def tree_leaf_height(nb: int) -> int:
    """Leaf-block height of the TSQR tree (MCA ``panel.tree_leaf``
    multiples of the panel width, floor 1)."""
    return max(_cfg.mca_get_int("panel.tree_leaf", 2), 1) * nb


def tsqr(a, leaf: int | None = None, *, need_q: bool = True):
    """Thin QR of a tall panel by TSQR binary-tree reduction: one batched
    QR of the ``leaf``-tall blocks, then per level one batched QR of the
    stacked sibling R pairs; the root's thin Q is pushed back down (one
    batched product per level), so ``a = q @ r``.

    The block count pads to a power of two with ZERO blocks (for a
    full-rank panel the pad rows of Q are exactly zero). ``need_q=False``
    returns ``(None, r)`` without the push-down."""
    m, n = a.shape
    lb = tree_leaf_height(n) if leaf is None else max(int(leaf), n)
    if m <= lb:
        q, r = torch.linalg.qr(a, mode="reduced")
        return (q if need_q else None), r
    L = -(-m // lb)
    L2 = 1 << (L - 1).bit_length()      # pad block count to a power of 2
    ap = torch.cat([a, a.new_zeros((L2 * lb - m, n))], dim=0)
    q0, r = torch.linalg.qr(ap.reshape(L2, lb, n), mode="reduced")
    qs = []                             # per-level (B, 2n, n) Q factors
    while r.shape[0] > 1:
        pairs = r.reshape(r.shape[0] // 2, 2 * n, n)
        qi, r = torch.linalg.qr(pairs, mode="reduced")
        if need_q:
            qs.append(qi)
    if not need_q:
        return None, r[0]
    # push the root's Q back down: W starts as I at the root, each level
    # maps a node's (n, n) W to its two children's W blocks
    w = torch.eye(n, dtype=a.dtype, device=a.device)[None]
    for qi in reversed(qs):
        w = _mm(qi, w).reshape(qi.shape[0] * 2, n, n)
    q = _mm(q0, w).reshape(L2 * lb, n)[:m]
    return q, r[0]


def geqrt_tree(a, leaf: int | None = None):
    """TSQR/CAQR panel QR: tree-reduced thin (Q, R), then TSQR-HR
    Householder reconstruction back to the compact-WY ``(packed, V, T)``
    contract of :func:`~dplasma_tpu_torch.kernels.householder.geqrt`."""
    q, r = tsqr(a, leaf)
    return hh.householder_reconstruct(q, r)


def qr_panel(a, kind: str | None = None, *, rankfull: bool = True):
    """One (m, nb) QR panel by the selected kernel: ``(packed, V, T)``.
    ``pallas`` takes K4 where its shape gate holds and falls back to
    ``tree`` for the other shapes (the reference's per-shape rule);
    ``chain`` is the vendor panel (still honouring MCA ``qr_panel``)."""
    kind = panel_kernel("qr") if kind is None else kind
    if kind == "pallas":
        if pallas_qr.eligible(a):
            return pallas_qr.geqrt_panel(a)
        kind = "tree"
    if kind == "tree":
        return geqrt_tree(a)
    return hh.geqrt(a, rankfull=rankfull)


# ---------------------------------------------------------------------
# Blocked-recursive LU panel
# ---------------------------------------------------------------------

def rec_base_width() -> int:
    return max(_cfg.mca_get_int("panel.rec_base", 8), 1)


def _lu_base_vec(a, pivot: bool):
    """Column-by-column elimination of an (m, w) strip: per column the
    lowest-index max-|a| pivot, a two-row swap, the scale by the
    pivot's reciprocal (0 for a zero pivot) and a rank-1 update of the
    columns to its right — each a rounded product then a rounded
    difference. The pivot stays on the device (no host sync). Returns
    ``(packed, perm)``."""
    m, w = a.shape
    A = a.clone()
    perm = torch.arange(m, device=a.device)
    for j in range(w):
        if pivot:
            piv = torch.argmax(A[j:, j].abs()) + j
            rows = torch.stack((torch.full_like(piv, j), piv))
            A[rows] = A[rows.flip(0)]
            perm[rows] = perm[rows.flip(0)]
        d = A[j, j]
        inv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 0.0)
        lcol = A[j + 1:, j] * inv
        A[j + 1:, j] = lcol
        if j + 1 < w:
            A[j + 1:, j + 1:] -= torch.outer(lcol, A[j, j + 1:])
    return A, perm


def _lu_rec(a, bw: int, pivot: bool):
    m, n = a.shape
    if n <= bw:
        return _lu_base_vec(a, pivot)
    h = n // 2
    l1, p1 = _lu_rec(a[:, :h], bw, pivot)
    rest = a[:, h:]
    if pivot:
        rest = rest[p1]
    u12 = k.trsm(l1[:h], rest[:h], side="L", lower=True, unit=True)
    s = rest[h:] - k.dot(l1[h:], u12)
    l2, p2 = _lu_rec(s, bw, pivot)
    bot_l = l1[h:]
    if pivot:
        bot_l = bot_l[p2]
        perm = p1[torch.cat([torch.arange(h, device=a.device), h + p2])]
    else:
        perm = torch.arange(m, device=a.device)
    top = torch.cat([l1[:h], u12], dim=1)
    bot = torch.cat([bot_l, l2], dim=1)
    return torch.cat([top, bot], dim=0), perm


def lu_panel_rec(a, base: int | None = None):
    """Blocked-recursive partial-pivoting LU of an (m, n) slab (m >= n):
    ``a[perm] = L U``. Returns (packed L\\U with unit L implicit, perm)
    — the ``ops.lu._base_lu`` contract. Columns halve down to
    ``panel.rec_base`` wide; each level is one trsm and one Schur
    product."""
    bw = rec_base_width() if base is None else max(int(base), 1)
    return _lu_rec(a, bw, pivot=True)


def lu_panel_rec_nopiv(a, base: int | None = None):
    """Unpivoted twin of :func:`lu_panel_rec`: packed L\\U of the (m, n)
    slab (the getrf_nopiv panel contract)."""
    bw = rec_base_width() if base is None else max(int(base), 1)
    packed, _ = _lu_rec(a, bw, pivot=False)
    return packed
