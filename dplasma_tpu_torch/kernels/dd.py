"""FP64-equivalent products, Cholesky, and the LU and QR panels, from
exact int8 limb splitting.

Ports ``dplasma_tpu/kernels/dd.py`` but for the float-float split
(:1-331, :333-454, :456-541, :591-701, :782-889, :1047-1074, and the
LU/QR panels :892-1045: ``lu_ir``, ``geqrt_f64``, ``_tsqrhr_f64``,
``geqrt_f64_tree``). Each f64 operand is scaled
(per A-row / per B-column, by a power of two read from the exponent
field) and split EXACTLY into ``nl`` limbs of ``w = 7`` bits stored as
int8 digits. Limb-pair products accumulate exactly in int32 (chunk bound
``nl·kc·127² < 2^31``), and only the ``nl`` level sums touch f64, in the
epilogue ``base − (sa·sb)·Σ_l levels[l]·2^(−w(l+2))``. On the card every
unchunked product is ONE launch of kernel K2 (``kernels/pallas_dd.py``,
``csrc/recombine.cu``), the int8 tensor-core product with that epilogue
fused (:func:`_limb_product_base`); the plain route (``torch._int_mm``
per left limb, the level adds, the plain recombine) takes the rest.

Everything here is the reference's true-f64 branch (Hopper and the CPU
have f64 ALUs); the float-float digit split ``_split_fixed_ff`` waits
for a later slice. Differences from the reference, none of which
changes a number:

* The limbs of an operand are one (nl, rows, K) int8 tensor, K-major,
  its rows padded to 16 bytes (what TMA reads without a copy); the right
  operand's limbs are split from Bᵀ's rows, so both are K-major.
* ``_limb_levels`` (the plain route) returns one (nl, M, N) tensor
  (int32 unchunked, f64 chunked), accumulated in place; the right limbs
  are concatenated once, K-contiguous.
* The blocked Cholesky keeps its limb cache row-major,
  ``W[l, row, col]``, so both operands of the trailing product are
  K-major views of it (the reference stores the transpose, the layout
  the TPU's MXU prefers), and works on the live rows of each block
  column (the reference's fixed (N, nb) slab and rolled scales exist for
  XLA's compile cache).
* ``_pin_cat_axis`` has no counterpart: it pins a sharding for XLA's
  partitioner, and the port's mesh (``parallel.mesh``) is an eager
  lockstep loop with none; under a grid each rank's limb products are
  plain calls of this module.
* Complex128 ``mm`` is the reference's two 2K-deep real limb products
  (two K2 launches); ``trtri_f64``, ``trsm_f64`` and ``potrf_f64`` take
  c64 seeds. ``lu_ir`` and the geqrt panels stay real-only, as the
  reference calls them only for float64.
"""
from __future__ import annotations

import math

import torch

from dplasma_tpu_torch.kernels import pallas_dd as _pdd
from dplasma_tpu_torch.kernels import pallas_kernels as _pk

# Digit width for int8 limbs: |d| <= 2^7 - 1 = 127.
W8 = 7

_F64 = torch.float64
_F32 = torch.float32


def _plan(K: int, bits: int):
    """Limb width/count and chunk depth for a K-deep product: nl covers
    the requested mantissa; kc bounds the per-chunk depth so the worst
    level sum (nl pair products of kc-deep 7-bit digit dots) stays exact
    in int32: nl·kc·(2^w − 1)² < 2^31 (:func:`pallas_dd.max_depth`)."""
    w = W8
    nl = math.ceil((bits + 1) / w)
    return w, nl, min(K, _pdd.max_depth(nl))


# The chunk depth at 53 bits for deep K (tests poke it).
KC = _plan(2 ** 20, 53)[2]


#: the 64-bit types :func:`_bitcast` reinterprets between
_BITCAST = {0: torch.int64, 1: _F64}


@torch.library.custom_op("dtt::bitcast", mutates_args=())
def _bitcast_op(x: torch.Tensor, code: int) -> torch.Tensor:
    return x.view(_BITCAST[code]).clone()


@_bitcast_op.register_fake
def _(x, code):
    return torch.empty_like(x, dtype=_BITCAST[code])


def _bitcast_vmap(info, in_dims, x, code):
    return x.view(_BITCAST[code]).clone(), in_dims[0]


torch.library.register_vmap("dtt::bitcast", _bitcast_vmap)


def _bitcast(x, dtype):
    """x's bits as ``dtype`` (int64 <-> float64): ``Tensor.view``, or,
    for a functorch-batched ``x`` (``torch.func.vmap``, the serving
    layer), a copy through the custom op ``dtt::bitcast``: some torch
    versions have no batching rule for ``view.dtype``."""
    if _pk.is_batched(x):
        return torch.ops.dtt.bitcast(x, 0 if dtype == torch.int64 else 1)
    return x.view(dtype)


def _pow2_scale_bits(m):
    """2^(floor(log2 m) + 2), read from the f64 exponent field (so
    |x| <= scale/2 for |x| <= m), the exponent clamped inside the normal
    range: 0 and subnormals give 2^-1020, Inf and NaN 2^1023."""
    b = _bitcast(torch.as_tensor(m).to(_F64), torch.int64)
    e = ((b >> 52) & 0x7FF).clamp(1, 0x7FC) + 2
    return _bitcast(e << 52, _F64)


def _split_fixed(x, scale, w: int, nl: int, out=None):
    """Exact limb split with a caller-supplied power-of-two scale
    (requires |x| <= scale/2): x == scale · Σ_l limbs[l]·2^(−w(l+1)) up
    to the dropped tail. Digits are read straight from the f64 bit
    pattern (shifted mantissa windows); the arithmetic ``>>`` on int64 is
    harmless because the exponent is masked and the sign read from bit
    63, and the shift counts are clipped to [0, 63] as in the
    reference. Writes the nl int8 limbs into ``out`` (nl, *x.shape), a
    new tensor when None, and returns it. A functorch-batched ``x``
    (``torch.func.vmap``) cannot write into ``out``: its limbs are
    stacked out of place instead, padded like ``out``'s rows, and that
    tensor is returned."""
    p = _bitcast(x.to(_F64), torch.int64)
    e_x = (p >> 52) & 0x7FF
    mant = torch.where(e_x > 0, (p & ((1 << 52) - 1)) | (1 << 52),
                       torch.zeros((), dtype=torch.int64, device=p.device))
    sgn = 1 - 2 * ((p >> 63) & 1)
    e_s = (_bitcast(torch.as_tensor(scale).to(_F64), torch.int64) >> 52) \
        & 0x7FF
    t0 = 52 - (e_x - e_s)           # bit offset of limb l's LSB: t0 - w(l+1)
    mask = 2 ** w - 1

    def digits(l):
        t = t0 - w * (l + 1)
        return sgn * (((mant >> t.clamp(0, 63)) << (-t).clamp(0, 63)) & mask)

    if _pk.is_batched(x):
        limbs = torch.stack([digits(l) for l in range(nl)]).to(torch.int8)
        if out is None:
            return limbs
        k = limbs.shape[-1]
        return torch.nn.functional.pad(limbs, (0, out.stride(-2) - k))[
            ..., :k]
    if out is None:
        out = torch.empty((nl, *x.shape), dtype=torch.int8, device=x.device)
    for l in range(nl):
        out[l].copy_(digits(l))
    return out


def _split_int(x, w: int, nl: int, axis: int, out=None):
    """Row- (axis 0) or column- (axis 1) scaled limb split. Returns
    (limbs, scale, m): ``m`` is the row/column max the scale derives
    from, which callers reuse for NaN/Inf detection; ``out`` as in
    :func:`_split_fixed`."""
    m = torch.amax(torch.abs(x), dim=1 - axis, keepdim=True)
    scale = _pow2_scale_bits(m)
    return _split_fixed(x, scale, w, nl, out=out), scale, m


def _limb_planes(nl: int, rows: int, K: int, device):
    """An (nl, rows, K) int8 buffer for limbs, K-major, each row padded
    to a multiple of 16 bytes (TMA's stride rule: K2 reads it as is)."""
    return torch.empty((nl, rows, -(-K // 16) * 16), dtype=torch.int8,
                       device=device)[:, :, :K]


def _split_rows(x, w: int, nl: int):
    """Row-scaled limbs of x (rows, K) as (nl, rows, K) planes: (limbs,
    scale (rows, 1), row max). The right operand of a product B (K, N)
    goes in as Bᵀ: its row scales are B's column scales, its digits B's
    digits."""
    return _split_int(x, w, nl, 0, out=_limb_planes(nl, *x.shape, x.device))


def _level_recombine(levels, w: int):
    """Σ_l levels[l]·2^(−w(l+2)) in f64, in order of l."""
    acc = None
    for l, lvl in enumerate(levels):
        term = lvl.to(_F64) * (2.0 ** (-w * (l + 2)))
        acc = term if acc is None else acc + term
    return acc


def _imm(a, b):
    """Exact int8 (M, K) @ (K, N) -> int32 by ``torch._int_mm``. On the
    card it takes M > 16 and K, N multiples of 8, and its int8 product
    runs ~7x faster with both operands K-contiguous (A row-major, B
    column-major; a leading dimension that is a multiple of 8) than in
    the other three layouts (chip_smoke.py, PERF.md); cuBLASLt refuses a
    base address that is not 16-byte aligned. Other operands are copied
    once into that form, zero-padded: zeros add nothing to an integer
    sum."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8

    def k_major(x, rows):          # x (rows, Kp) with K contiguous
        return (x.shape == (rows, Kp) and x.stride(1) == 1
                and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0)

    if _pk.is_batched(a) or _pk.is_batched(b):
        # torch.func.vmap: padded out of place, and _int_mm per element
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
        bt = torch.nn.functional.pad(b.T, (0, Kp - K, 0, Np - N))
        out = torch._int_mm(a, bt.T)
        return out if (Mp, Np) == (M, N) else out[:M, :N]
    if not k_major(a, Mp):
        ap = torch.zeros((Mp, Kp), dtype=torch.int8, device=a.device)
        ap[:M, :K] = a
        a = ap
    bt = b.T
    if not k_major(bt, Np):
        bp = torch.zeros((Np, Kp), dtype=torch.int8, device=b.device)
        bp[:N, :K] = bt
        bt = bp
    out = torch._int_mm(a, bt.T)
    return out if (Mp, Np) == (M, N) else out[:M, :N]


def _limb_levels(al, bl, K: int, w: int, nl: int, kc: int,
                 lhs_t: bool = False):
    """Exact level sums of the limb-pair products: level l is
    Σ_{i+j=l} al[i] @ bl[j]. ``al``: nl int8 (M, K) arrays, or (K, M)
    when ``lhs_t``; ``bl``: nl int8 (K, N). One product per left limb
    against the concatenation of the right limbs it pairs with
    (j < nl − i), as in the reference. Returns an (nl, M, N) tensor:
    int32 when unchunked (K <= kc), else the exact f64 sum of the
    per-chunk int32 sums."""
    lhs = [x.T for x in al] if lhs_t else list(al)
    M = lhs[0].shape[0]
    P = bl[0].shape[1]
    dev = lhs[0].device
    # the right limbs concatenated ONCE, stored (nl·P, K) so that every
    # prefix (the rhs of left limb i) is K-contiguous
    bt = torch.empty((nl * P, K), dtype=torch.int8, device=dev)
    for j in range(nl):
        bt[j * P:(j + 1) * P].copy_(bl[j].T)
    lv = torch.zeros((nl, M, P), dtype=torch.int32, device=dev)
    nchunks = math.ceil(K / kc)
    tot = None
    for c in range(nchunks):
        k0, k1 = c * kc, min(K, (c + 1) * kc)
        if c:
            lv.zero_()
        for i in range(nl):
            nj = nl - i
            p = _imm(lhs[i][:, k0:k1], bt[:nj * P, k0:k1].T)
            lv[i:].add_(p.view(M, nj, P).transpose(0, 1))
            del p       # one (M, nj·P) int32 product alive at a time
        if nchunks > 1:
            tot = lv.to(_F64) if tot is None else tot.add_(lv)
    return lv if nchunks == 1 else tot


def _recombine_scale_base(levels, base, sa, sb, w: int):
    """``base − (sa·sb)·Σ_l levels[l]·2^(−w(l+2))`` — the plain route's
    epilogue: :func:`pallas_dd.recombine_base` for unchunked int32
    levels on the CPU where :func:`pallas_dd.eligible` holds (the
    reference's K2 gate), else the exact plain recombine."""
    if levels.device.type == "cpu" and _pdd.eligible(levels):
        return _pdd.recombine_base(levels, base, sa, sb, w)
    prod = _level_recombine(levels, w) * (sa * sb)
    return -prod if base is None else base - prod


def _limb_product_base(al, bl, base, sa, sb, K: int, w: int, nl: int,
                       kc: int):
    """``base − (sa·sb)·Σ_l 2^(−w(l+2))·Σ_{i+j=l} al[i] @ bl[j]ᵀ``, the
    exact limb product and its epilogue; with ``sa``/``sb`` None (and no
    base) the unscaled level recombine. ``al`` (nl, M, K) and ``bl``
    (nl, N, K) int8 planes, K-major.

    On the card an unchunked product (K <= kc) with MCA ``dd_epilogue``
    not ``off`` is one launch of K2 (:func:`pallas_dd.limb_product_base`).
    Every other product takes the plain route, the reference's
    ``_recombine_scale_base(_limb_levels(...))``, and on the card adds
    one to ``pallas_dd.UNFUSED``.

    Functorch-batched planes (``torch.func.vmap``, the serving layer)
    take K2 on any device, one batched launch (the plain batched version
    on the CPU); the plain route cannot batch, so a batched product that
    K2 does not take raises."""
    cuda = al.device.type == "cuda"
    batched = _pk.is_batched(al)
    if (cuda or batched) and K <= kc and _pdd.fused():
        return _pdd.limb_product_base(al, bl, base, sa, sb, w)
    if batched:
        raise NotImplementedError(
            f"a batched limb product runs only as one K2 launch: K={K} "
            f"must be <= {kc} and MCA dd_epilogue on")
    if cuda:
        _pdd.UNFUSED += 1
    levels = _limb_levels(list(al), [x.T for x in bl], K, w, nl, kc)
    if sa is None:
        return _level_recombine(levels, w)
    return _recombine_scale_base(levels, base, sa, sb, w)


def gemm_residual(base, a, b, bits: int = 53):
    """``base − a @ b`` at f64-equivalent accuracy, the subtraction fused
    into the recombine epilogue (the residual of every dd refinement
    step). Real f64 only."""
    a = a.to(_F64)
    b = b.to(_F64)
    K = a.shape[1]
    w, nl, kc = _plan(K, bits)
    al, sa, _ = _split_rows(a, w, nl)
    bl, sb, _ = _split_rows(b.T, w, nl)
    return _limb_product_base(al, bl, base.to(_F64), sa, sb.T, K, w, nl,
                              kc)


def gemm_f64(a, b, bits: int = 53, _nonfinite_mask: bool = True):
    """C = A @ B at f64-equivalent accuracy from exact int8 products.

    ``bits`` is the target mantissa (53 = full f64; 32 ~ double-single at
    5 limbs instead of 8). Any NaN or Inf entry of an operand poisons its
    whole result row/column with NaN (the digit cast cannot represent
    them); internal refinement callers skip the mask."""
    a = a.to(_F64)
    b = b.to(_F64)
    K = a.shape[1]
    w, nl, kc = _plan(K, bits)
    al, sa, ma = _split_rows(a, w, nl)      # row-scaled
    bl, sb, mb = _split_rows(b.T, w, nl)    # B's columns, K-major
    out = _limb_product_base(al, bl, None, -sa, sb.T, K, w, nl, kc)
    del al, bl
    if not _nonfinite_mask:
        return out
    bad = ~torch.isfinite(ma) | ~torch.isfinite(mb.T)
    return torch.where(bad, torch.full((), float("nan"), dtype=_F64,
                                       device=out.device), out)


def gemm_dd(alpha, a, b, beta, c, bits: int = 53):
    """alpha·A@B + beta·C in f64-equivalent precision."""
    out = gemm_f64(a, b, bits=bits)
    return alpha * out + beta * c.to(_F64)


def mm(a, b, bits: int = 53):
    """Complex-aware exact matmul: f64 via :func:`gemm_f64`; complex128
    as two 2K-deep real limb products, [re(a) | im(a)] against
    [re(b); −im(b)] and [im(b); re(b)] (the flops of the four-product
    form). Conjugate views (``.mH``) are read through ``.real`` and
    ``.imag``."""
    if a.is_complex() or b.is_complex():
        a = a.to(torch.complex128)
        b = b.to(torch.complex128)
        lhs = torch.cat([a.real, a.imag], dim=1)
        re = gemm_f64(lhs, torch.cat([b.real, -b.imag], dim=0), bits=bits)
        im = gemm_f64(lhs, torch.cat([b.imag, b.real], dim=0), bits=bits)
        # the reference's re + 1j·im, part by part: its real part is
        # re + 0·im (NaN where im is not finite), its imaginary part
        # 0 + im (−0 becomes +0)
        return torch.complex(re + 0.0 * im, 0.0 + im)
    return gemm_f64(a, b, bits=bits)


# ---------------------------------------------------------------------
# Tile factorizations at f64-equivalent accuracy: an f32 seed, then
# refinement whose only exact work is limb products.
# ---------------------------------------------------------------------


def _wdtype(x):
    return torch.complex128 if x.is_complex() else _F64


def _ct(x):
    return x.mH if x.is_complex() else x.T


def _take_triangle(T, lower: bool, unit: bool):
    """The named triangle (optionally with a unit diagonal): the opposite
    triangle may hold scratch and must not leak into the products."""
    t = torch.tril(T) if lower else torch.triu(T)
    if unit:
        t = t.clone()
        t.diagonal().fill_(1)
    return t


def _inv32(t, lower: bool):
    """The f32 (c64) seed inverse of the named triangle of ``t`` (f32 or
    c64)."""
    eye = torch.eye(t.shape[0], dtype=t.dtype, device=t.device)
    return torch.linalg.solve_triangular(t, eye, upper=not lower, left=True)


def _seed_dtype(x):
    """The seed precision of a working dtype: c64 for complex, f32."""
    return torch.complex64 if x.is_complex() else _F32


def _real_only(what: str, *xs):
    """The routes the reference runs on real f64 only (``lu_ir``, the
    geqrt panels): complex raises rather than silently taking native
    complex128."""
    if any(x.is_complex() for x in xs):
        raise NotImplementedError(
            f"dd {what} is real f64 only, as in the reference; complex "
            "factorizations take the plain sweeps with dd products")


def _chol32(a):
    """f32 Cholesky of the lower triangle; all-NaN when it fails (as
    ``lax.linalg.cholesky`` gives)."""
    f, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, f, torch.full_like(f, float("nan")))


def trtri_f64(T, lower: bool = True, unit: bool = False, iters: int = 2):
    """Inverse of a triangular tile at f64-equivalent accuracy: an f32
    solve seeds X; Newton steps X <- X(2I − TX), every product exact.
    Reads only the named triangle; complex128 takes a c64 seed."""
    T = _take_triangle(T.to(_wdtype(T)), lower, unit)
    n = T.shape[0]
    if not unit:
        # power-of-two row prescale keeps the f32 seed in range
        s = 0.25 * _pow2_scale_bits(
            torch.amax(torch.abs(T), dim=1, keepdim=True))
        T = T / s
    X = _inv32(T.to(_seed_dtype(T)), lower).to(T.dtype)
    eye2 = 2.0 * torch.eye(n, dtype=T.dtype, device=T.device)
    tri = torch.tril if lower else torch.triu
    for _ in range(iters):
        R = mm(T, X)
        X = tri(mm(X, eye2 - R))
    if not unit:
        X = X / s[:, 0][None, :]
    return X


def trsm_f64(T, B, *, side="L", lower=True, trans="N", unit=False,
             alpha=1.0, iters=2):
    """Triangular solve at f64-equivalent accuracy: an f32-inverse seed,
    then iterative refinement on exact residuals (the first at
    ``bits=32``). Power-of-two prescales on both operands keep the f32
    seed in range. Reads only the named triangle of T. Complex operands
    take the Newton inverse (:func:`trtri_f64`) times one exact product,
    as in the reference."""
    T = T.to(_wdtype(T))
    if T.is_complex() or B.is_complex():
        X = trtri_f64(T, lower=lower, unit=unit)
        if trans == "T":
            X = X.T
        elif trans == "C":
            X = X.mH
        return alpha * (mm(X, B) if side == "L" else mm(B, X))
    B = B.to(_F64)
    Tm = _take_triangle(T, lower, unit)
    if trans in ("T", "C"):
        Tm = Tm.T
    n = Tm.shape[0]
    m_ = torch.amax(torch.abs(Tm), dim=1, keepdim=True)
    one = torch.ones((), dtype=_F64, device=T.device)
    s = 0.25 * _pow2_scale_bits(torch.where(m_ > 0, m_, one))
    Ts = Tm / s
    lo_eff = lower != (trans in ("T", "C"))
    Xi = _inv32(Ts.to(_F32), lo_eff)

    if side == "L":
        Bs = B / s
        mB = torch.amax(torch.abs(Bs), dim=0, keepdim=True)
        c = _pow2_scale_bits(torch.where(mB > 0, mB, one))
        Bs = Bs / c
        X = torch.matmul(Xi, Bs.to(_F32)).to(_F64)
        for it in range(iters):
            bits = 32 if it == 0 and iters > 1 else 53
            E = gemm_residual(Bs, Ts, X, bits=bits)
            X = X + torch.matmul(Xi, E.to(_F32)).to(_F64)
        X = X * c
    else:
        mB = torch.amax(torch.abs(B), dim=1, keepdim=True)
        c = _pow2_scale_bits(torch.where(mB > 0, mB, one))
        Bc = B / c
        X = torch.matmul(Bc.to(_F32), Xi).to(_F64)
        for it in range(iters):
            bits = 32 if it == 0 and iters > 1 else 53
            E = gemm_residual(Bc, X, Ts, bits=bits)
            X = X + torch.matmul(E.to(_F32), Xi).to(_F64)
        X = (X * c) / s[:, 0][None, :]
    return alpha * X


def potrf_f64(A, lower: bool = True, refine: int = 3):
    """Cholesky of one tile at f64-equivalent accuracy: an f32 seed, then
    ``refine`` first-order corrections L <- L(I + Φ(L^-1 E L^-T)) on the
    exact residual E = A − L Lᵀ. Reads only the named triangle; NaN
    when the seed fails (not positive definite). Complex128 takes a c64
    seed and L^H."""
    A = A.to(_wdtype(A))
    if not lower:
        return _ct(potrf_f64(_ct(A), lower=True, refine=refine))
    Afull = torch.tril(A) + _ct(torch.tril(A, -1))
    L = _chol32(Afull.to(_seed_dtype(A))).to(A.dtype)
    X = trtri_f64(L, lower=True)
    for _ in range(refine):
        E = Afull - mm(L, _ct(L))
        M = mm(mm(X, E), _ct(X))
        phi = torch.tril(M, -1) + 0.5 * torch.diag(torch.diag(M))
        L = torch.tril(L + mm(L, phi))
    return L


# ---------------------------------------------------------------------
# Blocked FP64-equivalent Cholesky with limb-cached panels: the N^3/3
# bulk rides limbs split once per finished block column; diagonal tiles
# and panels are f32 seeds refined on exact residuals.
# ---------------------------------------------------------------------


def _row_norm_scales(diag):
    """A-priori power-of-two scales for the rows of the Cholesky factor:
    row i of L has 2-norm sqrt(A_ii), so 2^(ceil(log2 sqrt(A_ii)) + 1)
    bounds each of its entries; one scale per row lets the finished
    limbs of every block column share one cache."""
    tiny = torch.finfo(_F64).tiny
    return _pow2_scale_bits(torch.sqrt(torch.clamp(diag, min=tiny)))


def _k_major(limbs):
    """nl limbs given (K, R) each, as in the reference — a sequence, or a
    (nl, K, R) view such as the blocked sweep's cache — as (nl, R, K)
    planes: a view of a tensor, a stack of a sequence."""
    if torch.is_tensor(limbs):
        return limbs.transpose(1, 2)
    return torch.stack([x.T for x in limbs])


def _pair_dot_base(al, bl, base, sa, sb, K: int, w: int, nl: int,
                   kc: int):
    """``base − (sa·sb)·pair-dot`` with the epilogue fused (the trailing
    update of the blocked sweep). ``al`` nl (K, M) and ``bl`` nl (K, N)
    limbs (:func:`_k_major`)."""
    return _limb_product_base(_k_major(al), _k_major(bl), base, sa, sb, K,
                              w, nl, kc)


def _pair_dot(al, bl, K: int, w: int, nl: int, kc: int):
    """Unscaled limb product Σ_l 2^(−w(l+2)) Σ_{i+j=l} al[i]ᵀ @ bl[j],
    ``al`` nl (K, M) and ``bl`` nl (K, N) limbs (:func:`_k_major`)."""
    return _limb_product_base(_k_major(al), _k_major(bl), None, None, None,
                              K, w, nl, kc)


def _potrf_tile_ir(Akk, refine: int = 3, newton: int = 2,
                   need_inverse: bool = True, refine_bits=(32, 53, 53)):
    """Diagonal-tile Cholesky (+ inverse) at f64 accuracy: an f32 seed,
    ``refine`` corrections on the exact residual E = A − L Lᵀ (the first
    at ``bits=32``, the ``refine_bits`` ladder), each applied with f32
    products by one f32 inverse; then, if asked, ``newton`` Newton steps
    for X ≈ L^-1 with exact residual and apply. A symmetric power-of-two
    prescale keeps the f32 seed in range. Returns (L, X or None)."""
    n = Akk.shape[0]
    dev = Akk.device
    Af = torch.tril(Akk) + torch.tril(Akk, -1).T
    dg = torch.diagonal(Af)
    one = torch.ones((), dtype=_F64, device=dev)
    d = 0.25 * _pow2_scale_bits(torch.sqrt(torch.where(dg > 0, dg, one)))
    Af = Af / (d[:, None] * d[None, :])
    L = _chol32(Af.to(_F32))
    X32 = _inv32(torch.tril(L), True)
    L = torch.tril(L).to(_F64)
    for r in range(refine):
        bits = refine_bits[min(r, len(refine_bits) - 1)]
        E = gemm_residual(Af, L, L.T, bits=bits)
        L32 = torch.tril(L).to(_F32)
        Y = torch.matmul(X32, E.to(_F32))
        M = torch.matmul(Y, X32.T)
        phi = torch.tril(M, -1) + 0.5 * torch.diag(torch.diag(M))
        L = torch.tril(L + torch.matmul(L32, phi).to(_F64))
    if not need_inverse:
        return L * d[:, None], None
    eye = torch.eye(n, dtype=_F64, device=dev)
    X = _inv32(L.to(_F32), True).to(_F64)
    for _ in range(newton):
        R = eye - gemm_f64(L, X)
        X = torch.tril(X + gemm_f64(X, R))
    return L * d[:, None], X / d[None, :]


def _panel_trsm_ir(Lkk, slab, iters: int = 2):
    """Panel solve pan @ Lkkᵀ = slab at f64-equivalent accuracy:
    multiply by the f32 inverse Lkk^-T, then ``iters`` refinement steps
    on exact residuals (the first at ``bits=32``)."""
    L32 = torch.tril(Lkk).to(_F32)
    Xt = _inv32(L32, True).T
    pan = torch.matmul(slab.to(_F32), Xt).to(_F64)
    for it in range(iters):
        bits = 32 if it == 0 and iters > 1 else 53
        E = gemm_residual(slab, pan, Lkk.T, bits=bits)
        pan = pan + torch.matmul(E.to(_F32), Xt).to(_F64)
    return pan


def potrf_f64_blocked(A, nb: int = 512, lower: bool = True,
                      refine: int = 2):
    """Blocked left-looking Cholesky at f64-equivalent accuracy.

    Step k updates block column k with ONE limb product against the
    cached limbs of every finished column (the N³/3 bulk), factors the
    diagonal tile by f32 + refinement, and solves the panel by
    multiply-by-inverse + refinement; the finished column is split once
    (shared a-priori row scales, :func:`_row_norm_scales`) into the
    cache. With nt = N/nb, one factorization runs 5·nt − 3 limb products
    (for nt >= 2): the trailing product of each column k >= 1, two
    refinement residuals of each diagonal tile and two of each panel.

    Reads only the ``lower``/upper triangle; square A with N divisible
    by nb (ops-level callers pad). Real f64 only."""
    A = A.to(_F64)
    if not lower:
        # A = UᵀU with U = Lᵀ: factor the transpose (its lower triangle
        # is our stored upper) and return Lᵀ
        return potrf_f64_blocked(A.T, nb=nb, lower=True, refine=refine).T
    N = A.shape[0]
    if A.shape[1] != N or N % nb:
        raise ValueError(f"potrf_f64_blocked needs a square A with N % nb "
                         f"== 0, got {tuple(A.shape)} nb={nb}")
    nt = N // nb
    if nt <= 1:
        return _potrf_tile_ir(A, refine=refine, need_inverse=False)[0]
    w, nl, _ = _plan(N, 53)
    scale = _row_norm_scales(torch.diagonal(A))[:, None]
    # limb cache W[l, row, col] of the finished columns: rows s.. of
    # column block k live at W[:, s:, s:s+nb]; rows padded to 16 bytes,
    # so every product reads K-major views of it with no copy
    W = torch.zeros((nl, N, -(-(N - nb) // 16) * 16), dtype=torch.int8,
                    device=A.device)[:, :, :N - nb]
    out = torch.zeros((N, N), dtype=_F64, device=A.device)
    for k in range(nt):
        s = k * nb
        slab = A[s:, s:s + nb]
        if k:
            _, _, kc = _plan(s, 53)
            slab = _pair_dot_base(
                W[:, s:, :s].transpose(1, 2),
                W[:, s:s + nb, :s].transpose(1, 2), slab,
                scale[s:], scale[s:s + nb].T, K=s, w=w, nl=nl, kc=kc)
        Lkk, _ = _potrf_tile_ir(slab[:nb], refine=refine,
                                need_inverse=False)
        out[s:s + nb, s:s + nb] = Lkk
        if s + nb < N:
            pan = _panel_trsm_ir(Lkk, slab[nb:])
            out[s + nb:, s:s + nb] = pan
            if k + 1 < nt:
                _split_fixed(out[s:, s:s + nb], scale[s:], w, nl,
                             out=W[:, s:, s:s + nb])
    return out


# ---------------------------------------------------------------------
# LU and QR panels at f64-equivalent accuracy: f32 seeds refined on
# exact residuals, the d-precision analogues of CORE_zgetrf_rectil and
# CORE_zgeqrt for the blocked sweeps of ops.lu and ops.qr. Only the
# residuals and the heavy products are limb products (K2); every
# correction solve and product is f32.
# ---------------------------------------------------------------------


def lu_ir(pp, L, U, refine: int = 4, bits: int | None = None):
    """Refine a seed factorization ``pp ≈ L U`` to f64-equivalent
    accuracy for its FIXED permutation: ``pp`` the row-permuted (m, nb)
    panel, ``L`` (m, nb) unit lower trapezoidal, ``U`` (nb, nb) upper.
    ``bits`` pins every residual to one rung of the limb ladder; None
    keeps the 32, 32, 53, 53 ladder (the first two steps on the cheap
    rung, whose 2^-32 floor lies below the corrections they drive).

    One step: with the exact E = pp − L U, G = L1^-1 E1 U^-1 gives
    dU = triu(G) U and dL1 = L1 stril(G), and dL2 = (E2 − L2 dU) U^-1
    for the rows below. Only E is a limb product (one K2 launch a step);
    the solves are against the f32 SEED inverses and the products f32.
    A zero diagonal of U (an exactly singular panel) is replaced by 1 in
    the inverse only: the singular column's residual is zero, so its
    correction vanishes and the zero diagonal survives for INFO.
    Returns (L, U). Real f64 only."""
    _real_only("lu_ir", pp, L, U)
    nb = U.shape[0]
    dev = U.device
    L1_32 = _take_triangle(L[:nb].to(_F32), True, True)
    U32 = torch.triu(U).to(_F32)
    eye = torch.eye(nb, dtype=_F32, device=dev)
    L1i = torch.linalg.solve_triangular(L1_32, eye, upper=False,
                                        left=True, unitriangular=True)
    Ug = U32.clone()
    dg = Ug.diagonal()
    dg.copy_(torch.where(dg == 0, torch.ones_like(dg), dg))
    Ui = torch.linalg.solve_triangular(Ug, eye, upper=True, left=True)
    for r in range(refine):
        rbits = bits if bits is not None \
            else (32 if (r < 2 and refine > 2) else 53)
        E32 = gemm_residual(pp, L, U, bits=rbits).to(_F32)
        G = torch.matmul(torch.matmul(L1i, E32[:nb]), Ui)
        dU = torch.matmul(torch.triu(G), U32)
        dL = torch.matmul(L1_32, torch.tril(G, -1))
        if L.shape[0] > nb:
            dL2 = torch.matmul(
                E32[nb:] - torch.matmul(L[nb:].to(_F32), dU), Ui)
            dL = torch.cat([dL, dL2], dim=0)
        L = torch.tril(L + dL.to(_F64), -1)
        L.diagonal().fill_(1)
        U = torch.triu(U + dU.to(_F64))
    return L, U


def geqrt_f64(panel):
    """Panel QR at f64-equivalent accuracy: shifted, then unshifted,
    CholeskyQR in limb arithmetic, then Householder reconstruction
    (:func:`_tsqrhr_f64`). Returns (packed, V, T) in the CORE_zgeqrt
    layout. Needs a numerically full-rank panel with cond below ~1e5
    (the Gram matrix squares it and its Cholesky seeds in f32); MCA
    ``qr_panel=lapack`` keeps the vendor panel for harder ones. Real f64
    only."""
    _real_only("geqrt", panel)
    m, nb = panel.shape
    eps32 = torch.finfo(_F32).eps

    def cholqr_pass(x, shift):
        G = gemm_f64(x.T, x)
        if shift:
            s = (11.0 * (m * nb + nb * (nb + 1))) * eps32
            G = G + (s * torch.trace(G)) * torch.eye(
                nb, dtype=_F64, device=G.device)
        Lg, Xg = _potrf_tile_ir(G)
        return gemm_f64(x, Xg.T), Lg.T          # (q, r), r = Lgᵀ

    q, r1 = cholqr_pass(panel, True)
    q, r2 = cholqr_pass(q, False)
    return _tsqrhr_f64(q, gemm_f64(r2, r1))


def _tsqrhr_f64(q, r):
    """The TSQR-HR tail of both dd QR panels: compact-WY (packed, V, T)
    from a dd-accurate thin (q, r), with the sign/shift convention and
    packed layout of ``kernels.householder`` (shared with the f32 path)
    and every product, LU and inverse refined by limb residuals."""
    from dplasma_tpu_torch.kernels import blas as _kb
    from dplasma_tpu_torch.kernels import householder as _hh
    m, nb = q.shape
    s, b = _hh.reconstruct_sign_shift(q)
    p32 = _kb.getrf_nopiv_blocked(b[:nb].to(_F32))
    V1 = _take_triangle(p32.to(_F64), True, True)
    Ub = torch.triu(p32).to(_F64)
    V1, Ub = lu_ir(b[:nb], V1, Ub)
    if m > nb:
        # V2 Ub = b2: a right IR solve
        V2 = trsm_f64(Ub, b[nb:], side="R", lower=False)
        v = torch.cat([V1, V2], dim=0)
    else:
        v = V1
    # T = −(Ub S^-1) V1^-T (S^-1 = S): t V1ᵀ = −(Ub S), a right
    # transposed IR solve
    t = trsm_f64(V1, -(Ub * s[None, :]), side="R", lower=True, trans="T",
                 unit=True)
    packed = _hh.reconstruct_pack(s, r, v, nb)
    return packed, v, t


def geqrt_f64_tree(panel, solve_iters: int = 3):
    """The tree-seeded dd panel QR (MCA ``panel.kernel`` tree or pallas
    on the dd route): an R-only f32 TSQR tree
    (``panels.tsqr(..., need_q=False)``) on the power-of-two column
    prescaled panel conditions one exact-residual IR right-solve
    ``q1 R32 = panel`` in place of the shifted CholeskyQR pass; one
    unshifted limb CholeskyQR pass restores orthogonality, R unscales
    exactly, and :func:`_tsqrhr_f64` recovers (packed, V, T). Same
    envelope as :func:`geqrt_f64`. Real f64 only."""
    from dplasma_tpu_torch.kernels import panels as _panels
    _real_only("geqrt", panel)
    # column scaling leaves Q invariant: only R unscales, exactly
    m_ = torch.amax(torch.abs(panel), dim=0, keepdim=True)
    one = torch.ones((), dtype=_F64, device=panel.device)
    d = 4.0 / _pow2_scale_bits(torch.where(m_ > 0, m_, one))
    As = panel * d
    _, r32 = _panels.tsqr(As.to(_F32), need_q=False)
    r1 = torch.triu(r32).to(_F64)
    q1 = trsm_f64(r1, As, side="R", lower=False, iters=solve_iters)
    G = gemm_f64(q1.T, q1)
    Lg, Xg = _potrf_tile_ir(G)
    q = gemm_f64(q1, Xg.T)
    r = gemm_f64(Lg.T, r1) / d
    return _tsqrhr_f64(q, r)
