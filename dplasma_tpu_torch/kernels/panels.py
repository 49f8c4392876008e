"""Panel-factorization engine, LU half.

Ports the LU half of ``dplasma_tpu/kernels/panels.py`` (:56-125,
:226-297): the MCA ``panel.kernel`` resolution and the blocked-recursive
pivoted panel (Toledo's recursive LU; :func:`lu_panel_rec`) with its
unpivoted twin. Pivot ties break to the LOWEST row index:
``torch.argmax`` returns the first maximum.

``panel.kernel`` in {auto, chain, rec, tree, pallas}: ``chain`` is the
per-route vendor panel (cuSOLVER on the card), ``rec`` the recursive
panel, ``pallas`` the fused panel kernels (K3 for LU,
``kernels/pallas_lu.py``). ``auto`` resolves to ``chain``: the reference
picks tree/rec only on a TPU, and no backend of the port is one. The
port's fused kernels build at their first launch and raise there if the
build fails, so ``pallas`` never degrades to ``rec`` for want of a
runtime (the reference's ``_pallas_ready`` probe has no counterpart);
the unpivoted route, which has no fused kernel, still takes ``rec``.

The QR half (``tsqr``, ``geqrt_tree``, ``qr_panel``) waits for the QR
slice.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.utils import config as _cfg

_KERNELS = ("auto", "chain", "rec", "tree", "pallas")

_cfg.mca_register(
    "panel.kernel", "auto",
    "Panel-factorization kernel of the blocked sweeps (ops.lu pivoted "
    "and nopiv): chain (the per-route vendor panel), rec "
    "(blocked-recursive LU panel, vectorized pivot search), tree "
    "(the TSQR QR panel; LU maps it to rec), pallas (the fused panel "
    "kernels written for the card, K3 for LU; the unpivoted route takes "
    "rec), auto (chain: the reference picks tree/rec on a TPU only).")
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
