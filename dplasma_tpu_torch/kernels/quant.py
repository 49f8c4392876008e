"""Trailing-update routing (``quant.update_dot``).

Ports the routing part of ``dplasma_tpu/kernels/quant.py`` (:145-183):
every potrf update product goes through :func:`update_dot`, which falls
through to ``kernels.blas.dot`` unless MCA ``quant.updates=int8`` is
active and the operands are real f32. That block-scaled int8 route is
not ported yet (ROADMAP queue 1 item 9), so there it raises instead of
computing something else.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.utils import config as _cfg


def quant_params():
    """Resolve (tile, updates, guard) from MCA."""
    tile = max(_cfg.mca_get_int("quant.tile", 128), 8)
    updates = (_cfg.mca_get("quant.updates") or "off").lower()
    guard = (_cfg.mca_get("quant.guard") or "probe").lower()
    return tile, updates, guard


def updates_active(*dtypes) -> bool:
    """True when trailing updates would take the int8 route: MCA
    ``quant.updates=int8`` and every operand real float32."""
    _, updates, _ = quant_params()
    if updates != "int8":
        return False
    return all(d == torch.float32 for d in dtypes)


def update_dot(a, b, *, ta=False, tb=False, conj_a=False, conj_b=False):
    """Quant-aware trailing-update product: ``kernels.blas.dot``
    verbatim unless :func:`updates_active`."""
    if updates_active(a.dtype, b.dtype):
        raise NotImplementedError(
            "quant.updates=int8 needs the block-scaled int8 GEMM, which "
            "is not ported yet (ROADMAP queue 1 item 9)")
    return k.dot(a, b, ta=ta, tb=tb, conj_a=conj_a, conj_b=conj_b)
