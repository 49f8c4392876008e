"""Runtime configuration: MCA-style params and the ``Info`` store.

Ports ``dplasma_tpu/utils/config.py`` (plain Python, copied rather than
imported). Two of the reference's four tiers are here:

- MCA-style params — ``mca_register/set/unset/get`` with help text
  and env overrides ``DPLASMA_MCA_<NAME>`` (the same variables the JAX
  package reads, so one environment configures both), plus the scoped
  LIFO override stack (``push/pop_overrides``, ``override_scope``);
- ``Info``, the MPI_Info-style string store of ``dplasma_info_t``.

:func:`mca_load` applies a plain dict as returned by the reference's
``mca_snapshot()``, so a run configured under one package can be
replayed under the other.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional


class Info:
    """MPI_Info-style string key/value store (dplasma_info_t analog:
    create/set/get/delete/dup — ref src/utils/dplasma_info.h). Keys are
    case-insensitive; values are strings (callers parse numbers)."""

    def __init__(self, items: Optional[dict] = None):
        self._kv: dict[str, str] = {}
        if items:
            for k, v in items.items():
                self.set(k, v)

    def set(self, key: str, value) -> None:
        self._kv[key.upper()] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._kv.get(key.upper(), default)

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            return default

    def delete(self, key: str) -> None:
        self._kv.pop(key.upper(), None)

    def dup(self) -> "Info":
        return Info(dict(self._kv))

    def nkeys(self) -> int:
        return len(self._kv)

    def keys(self):
        return list(self._kv)

    def __contains__(self, key: str) -> bool:
        return key.upper() in self._kv

    def __repr__(self):
        return f"Info({self._kv!r})"


# -- MCA-style params with a help catalog ------------------------------

_MCA_REGISTRY: dict[str, tuple[str, str]] = {}  # name -> (default, help)
_MCA_OVERRIDES: dict[str, str] = {}


def mca_register(name: str, default, help_text: str) -> None:
    """Register a tunable with its default and help text."""
    _MCA_REGISTRY[name] = (str(default), help_text)


def mca_set(name: str, value) -> None:
    """Programmatic override (``--mca name value`` passthrough)."""
    _MCA_OVERRIDES[name] = str(value)


def mca_unset(name: str) -> None:
    """Drop a programmatic override (the env/default tiers resume)."""
    _MCA_OVERRIDES.pop(name, None)


def mca_snapshot() -> dict:
    """The active override set (explicit overrides only)."""
    return dict(sorted(_MCA_OVERRIDES.items()))


def mca_load(snapshot: dict) -> None:
    """Replace the active override set with ``snapshot`` — the plain
    dict :func:`mca_snapshot` (or the reference's) returns."""
    _MCA_OVERRIDES.clear()
    for name, value in snapshot.items():
        mca_set(name, value)


def mca_get(name: str, default=None) -> Optional[str]:
    """Resolution order: explicit override > env DPLASMA_MCA_<NAME>
    (dots → underscores) > registered default > ``default``."""
    if name in _MCA_OVERRIDES:
        return _MCA_OVERRIDES[name]
    env = os.environ.get(
        "DPLASMA_MCA_" + name.upper().replace(".", "_").replace(":", "_"))
    if env is not None:
        return env
    if name in _MCA_REGISTRY:
        return _MCA_REGISTRY[name][0]
    return None if default is None else str(default)


def mca_get_int(name: str, default: int) -> int:
    v = mca_get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def mca_get_float(name: str, default: float) -> float:
    v = mca_get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


# -- scoped override stack ---------------------------------------------
#
# Temporary overrides around a region of work (a driver's --lookahead)
# nest, so each frame records the prior state of exactly the keys it
# touched and popping out of order is an error, not silent corruption.

_UNSET = object()          # "key had no override before this frame"
_OVERRIDE_STACK: list = []  # [_OverrideFrame, ...] — top is last


class _OverrideFrame:
    """One pushed override scope: the applied values plus the exact
    prior state of every touched key (value, or _UNSET)."""

    __slots__ = ("applied", "saved", "label")

    def __init__(self, applied: dict, saved: dict, label: str):
        self.applied = applied
        self.saved = saved
        self.label = label


def push_overrides(kv: dict, label: str = "") -> _OverrideFrame:
    """Apply ``kv`` as MCA overrides and push a restore frame; a
    ``None`` value unsets the key for this scope. Hand the returned
    frame to :func:`pop_overrides` in LIFO order."""
    saved = {}
    applied = {}
    for name, value in kv.items():
        saved[name] = _MCA_OVERRIDES.get(name, _UNSET)
        if value is None:
            mca_unset(name)
            applied[name] = None
        else:
            mca_set(name, value)
            applied[name] = str(value)
    frame = _OverrideFrame(applied, saved, label)
    _OVERRIDE_STACK.append(frame)
    return frame


def pop_overrides(frame: _OverrideFrame) -> None:
    """Restore the prior override state of ``frame``'s keys. ``frame``
    must be the innermost scope; otherwise raise RuntimeError and leave
    the stack untouched."""
    if not _OVERRIDE_STACK or _OVERRIDE_STACK[-1] is not frame:
        raise RuntimeError(
            "MCA override scopes must pop in LIFO order: "
            f"frame {frame.label or id(frame)} is not the innermost "
            "active scope")
    _OVERRIDE_STACK.pop()
    for name, prev in frame.saved.items():
        if prev is _UNSET:
            _MCA_OVERRIDES.pop(name, None)
        else:
            _MCA_OVERRIDES[name] = prev


@contextlib.contextmanager
def override_scope(kv: dict, label: str = ""):
    """``with override_scope({...}):`` — scoped overrides with LIFO
    restore."""
    frame = push_overrides(kv, label=label)
    try:
        yield frame
    finally:
        pop_overrides(frame)


def override_depth() -> int:
    """Number of active override scopes."""
    return len(_OVERRIDE_STACK)


# The knobs this package reads, with the reference's defaults.
mca_register("device.hbm_fraction", "0.95",
             "Fraction of accelerator memory the streaming GEMM footprint "
             "model may plan for (analog of "
             "device_cuda_memory_use/number_of_blocks).")
mca_register("gemm.lookahead", "2",
             "Pipeline lookahead depth for paced GEMM variants (analog of "
             "dplasma_aux_getGEMMLookahead, dplasmaaux.c:92-111).")
mca_register("gemm.summa_steps", "2",
             "SUMMA broadcast panels per owner block (pipelined "
             "lookahead; >1 overlaps a step's matmul with the next "
             "panel's broadcast)")
mca_register("sweep.lookahead", "1",
             "Lookahead depth of the pipelined factorization sweeps: how "
             "many upcoming panel columns are updated by narrow products "
             "ahead of the one aggregated far product. 0 = the "
             "serialized baseline. CLI --lookahead overrides.")
mca_register("qr.agg_depth", "4",
             "Update aggregation depth of the pipelined QR sweep: the "
             "far trailing update is held back for this many panels and "
             "applied as one compact-WY product (1 = per-step updates).")
mca_register("qr_panel", "auto",
             "Panel QR algorithm for the flat geqrf sweep: auto/lapack "
             "(the vendor QR, cuSOLVER on the card), cholqr "
             "(CholeskyQR2 + Householder reconstruction, all "
             "matmul-shaped work; requires numerically full-rank "
             "panels). Applies only to ops.qr.geqrf, whose edge tiles "
             "are identity-padded to keep panels full rank.")
mca_register("trsm_inv", "auto",
             "Run triangular solves as explicit triangle inverse + "
             "matmul: auto/never (native solve), always (inverse form).")
mca_register("dd_gemm", "auto",
             "FP64-equivalent limb GEMM for f64 matmuls: auto (native "
             "FP64 on the GPU), always (the exact int8 limb route, each "
             "product closed by kernel K2: the tile dot/gemm, potrf, "
             "trsm and trtri, so ops.potrf/potrs/posv, blas3.gemm/"
             "trsm and the f64 LU and QR entry points), never.")
mca_register("dd_epilogue", "auto",
             "Recombine epilogue of the dd limb route: auto (unchunked "
             "products through kernel K2), off (the plain PyTorch "
             "recombine).")
mca_register("quant.tile", "128",
             "block size of the per-tile scale grid for int8 quantized "
             "updates")
mca_register("quant.updates", "off",
             "route factorization trailing updates through the "
             "block-scaled int8 GEMM: off | int8 (set by the "
             "ir.precision=int8 rung)")
mca_register("quant.guard", "probe",
             "per-update ABFT ones-probe divergence guard on quantized "
             "updates: probe | off")
mca_register("lu.pallas_panel", "off",
             "on = factor f32 LU panels of the chain route with the "
             "blocked LU panel kernel (K3) instead of the vendor LU")
mca_register("lu.panel_ib", "0",
             "Sub-panel width for a nested in-panel LU sweep "
             "(0 = disabled; each nb-wide panel then factors as one "
             "base-case LU).")
mca_register("lu.panel_chunk", "8192",
             "Row-chunk height for the CALU tournament-pivoting LU "
             "panel; panels taller than this elect pivot candidates "
             "per chunk.")
mca_register("lu.agg_depth", "4",
             "Fused far-flush depth of the reference's eager dd LU "
             "sweep. The port's eager sweep applies per step whatever "
             "it says (the flush keeps the same op order, and eager "
             "torch has nothing to fuse); registered so a reference "
             "snapshot replays.")
mca_register("ir.precision", "f32",
             "Working precision of the mixed-precision IR solvers "
             "(posv_ir/gesv_ir/gels_ir): int8 (f32 factor whose trailing "
             "updates ride the block-scaled int8 GEMM, kernels.quant), "
             "bf16 (operands/factors rounded through bf16 storage), f32, "
             "or f32x2 (double-single: the f32 factor takes one extra "
             "refinement step on the kernels.dd bits=32 limb ladder "
             "rung).")
mca_register("ir.max_iters", "10",
             "Refinement-iteration budget of the IR solvers; a solve that "
             "has not reached ir.tol within the budget escalates to the "
             "full-precision factorization route.")
mca_register("ir.tol", "0",
             "Normwise-backward-error convergence target of the IR "
             "solvers (||b-Ax|| / (||A|| ||x|| + ||b||)); 0 = auto, 100x "
             "the f64 unit roundoff (the check_solve acceptance floor).")
