"""Block-scaled int8 GEMM: the quantized trailing-update substrate.

Ports ``dplasma_tpu/kernels/quant.py`` (:57-210). The trailing updates
of the factorization sweeps (potrf's far and lookahead products, the
LU's Schur products, the QR's wide compact-WY applies) are contractions
whose error the f64-carry IR loop (``ops.refine``) corrects, so the
``ir.precision=int8`` rung runs them on int8 operands; panels,
triangular solves and diagonal factorizations stay f32.

Scheme: symmetric per-tile scale quantization of BOTH operands. Each
``quant.tile``-square block gets one scale ``amax/127`` and ``q =
round(x/scale)`` in int8. The product runs per K block as an exact int32
``torch._int_mm`` (127·127·tile << 2^31), dequantized by the row-scale ×
column-scale outer product into an f32 accumulator across K blocks, in
the reference's order. The reference computes it in plain JAX, outside
any Pallas kernel, so here it is a library int8 product per K block and
no hand-written kernel; on the card the int8 operands are laid out the
way ``dd._imm`` wants them (both K-contiguous): B is quantized as Bᵀ,
whose tiles and scales are those of B transposed.

Divergence guard: the ones-vector residual ``|A(Bw) − C_q w|`` of each
quantized update is recorded into the ambient :func:`update_scope`;
``ops.refine`` reports the max as ``quant_guard_max`` beside the backward
error, and real divergence rides IR's escalation like every other rung.

Routing is call-site opt-in: ops pass their update products through
:func:`update_dot`, which falls through to ``kernels.blas.dot``
bit-identically unless MCA ``quant.updates=int8`` is active AND the
operands are real f32.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import dd as _dd
from dplasma_tpu_torch.kernels import pallas_kernels as _pk
from dplasma_tpu_torch.observability import phases
from dplasma_tpu_torch.utils import config as _cfg

_F32 = torch.float32


def quant_params():
    """Resolve (tile, updates, guard) from MCA."""
    tile = max(_cfg.mca_get_int("quant.tile", 128), 8)
    updates = (_cfg.mca_get("quant.updates") or "off").lower()
    guard = (_cfg.mca_get("quant.guard") or "probe").lower()
    return tile, updates, guard


def _pad_to(x, rows: int, cols: int):
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    if pr or pc:
        x = torch.nn.functional.pad(x, (0, pc, 0, pr))
    return x


def quantize(x, tile: Optional[int] = None):
    """Symmetric per-tile scale quantization.

    Returns ``(q, scales)``: ``q`` int8 of x's shape padded up to tile
    multiples, ``scales`` f32 of shape (ceil(M/t), ceil(K/t)) with
    ``scale = amax(block)/127`` (floored at 1e-30 so all-zero pad blocks
    stay exactly zero after the round trip)."""
    t = tile if tile is not None else quant_params()[0]
    m, n = x.shape
    mt, nt = -(-m // t), -(-n // t)
    xp = _pad_to(x.to(_F32), mt * t, nt * t)
    blocks = xp.reshape(mt, t, nt, t)
    amax = torch.amax(torch.abs(blocks), dim=(1, 3))
    # a tensor divisor: a Python scalar one is a multiply by its
    # reciprocal on the card (other bits than the reference's divide)
    scales = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-30)
    q = torch.round(blocks / scales[:, None, :, None])
    q = torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return q.reshape(mt * t, nt * t), scales


def dequantize(q, scales, tile: Optional[int] = None, shape=None):
    """Inverse of :func:`quantize` (up to rounding): int8 tiles times
    their per-tile scales, cropped to ``shape`` when given."""
    t = tile if tile is not None else quant_params()[0]
    mt, nt = scales.shape
    blocks = q.reshape(mt, t, nt, t).to(_F32)
    x = (blocks * scales[:, None, :, None]).reshape(mt * t, nt * t)
    if shape is not None:
        x = x[:shape[0], :shape[1]]
    return x


def qgemm(a, b, tile: Optional[int] = None):
    """Block-scaled int8 GEMM: ``a @ b`` with both operands quantized
    per tile, an exact int32 product inside each K block, and an f32
    dequantized accumulation across K blocks (``acc + p·rs·cs``, the
    reference's order). Result f32, a.shape[0] × b.shape[1]."""
    t = tile if tile is not None else quant_params()[0]
    m, kk = a.shape
    k2, n = b.shape
    if kk != k2:
        raise ValueError(f"qgemm: inner dimensions differ, {tuple(a.shape)}"
                         f" @ {tuple(b.shape)}")
    if m == 0 or n == 0 or kk == 0:
        return torch.zeros((m, n), dtype=_F32, device=a.device)
    with phases.span("quantize") as _f:
        qa, sa = quantize(a, t)
        qbt, sbt = quantize(b.T, t)      # Bᵀ's tiles: both K-contiguous
        _f(qa)
        _f(qbt)
    kt = sa.shape[1]
    acc = torch.zeros((qa.shape[0], qbt.shape[0]), dtype=_F32,
                      device=a.device)
    for j in range(kt):
        blk = slice(j * t, (j + 1) * t)
        # exact int32 contraction within one K block ...
        p = _dd._imm(qa[:, blk], qbt[:, blk].T)
        # ... dequantized by the row-scale x col-scale outer product
        with phases.span("dequantize") as _f:
            p = p.to(_F32)
            p.mul_(sa[:, j].repeat_interleave(t)[:, None])
            p.mul_(sbt[:, j].repeat_interleave(t)[None, :])
            # out of place under torch.func.vmap (the serving batch)
            acc = acc + p if _pk.is_batched(p) else acc.add_(p)
            _f(acc)
        del p
    return acc[:m, :n]


# -- trailing-update routing -------------------------------------------

#: ambient guard-residual collector: a list while an update_scope with
#: guarding is active, else None (probes skipped entirely)
_GUARD: Optional[List] = None


def updates_active(*dtypes) -> bool:
    """True when trailing updates take the int8 route: MCA
    ``quant.updates=int8`` and every operand real float32 (f64 and
    complex never route)."""
    _, updates, _ = quant_params()
    if updates != "int8":
        return False
    return all(d == _F32 for d in dtypes)


def probe_residual(a, b, c):
    """ABFT input-side ones-probe of one update product: relative
    residual ``max|a (b w) − c w| / (max|a| max|b| K + 1e-30)`` with w
    the ones vector, so one narrow matvec pair audits the whole
    quantized GEMM."""
    w = torch.ones((b.shape[1], 1), dtype=_F32, device=b.device)
    ref = torch.matmul(a, torch.matmul(b, w))
    got = torch.matmul(c, w)
    floor = (torch.amax(torch.abs(a)) * torch.amax(torch.abs(b))
             * float(max(b.shape[0], 1)) + 1e-30)
    return torch.amax(torch.abs(ref - got)) / floor


def update_dot(a, b, *, ta=False, tb=False, conj_a=False, conj_b=False):
    """Quant-aware trailing-update product: ``op(a) @ op(b)`` through
    :func:`qgemm` when :func:`updates_active`, else ``kernels.blas.dot``
    verbatim (bit-identical fall-through). The conj flags are identity
    on the routed (real f32) path."""
    if not updates_active(a.dtype, b.dtype):
        return k.dot(a, b, ta=ta, tb=tb, conj_a=conj_a, conj_b=conj_b)
    am = a.T if ta else a
    bm = b.T if tb else b
    out = qgemm(am, bm)
    if _GUARD is not None and quant_params()[2] == "probe":
        _GUARD.append(probe_residual(am, bm, out))
    return out


@contextlib.contextmanager
def update_scope(guard: bool = True):
    """Activate the int8 trailing-update route for the block (the
    ``ir.precision=int8`` factor): pushes MCA ``quant.updates=int8`` and
    installs a fresh guard-residual collector, yielded so the caller can
    fold ``max(residuals)`` into its info. Restores both on exit
    (re-entrant)."""
    global _GUARD
    prev = _GUARD
    collected: List = [] if guard else (prev if prev is not None else [])
    _GUARD = collected if guard else prev
    with _cfg.override_scope({"quant.updates": "int8"}, label="quant"):
        try:
            yield collected
        finally:
            _GUARD = prev


def guard_max(residuals):
    """Reduce collected probe residuals to one f32 scalar (0 when none
    were recorded: guard off or no routed updates)."""
    if not residuals:
        return torch.zeros((), dtype=_F32)
    return torch.amax(torch.stack([torch.as_tensor(r, dtype=_F32)
                                   for r in residuals]))
