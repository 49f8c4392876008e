"""Deterministic fault injection — the testable half of resilience.

Ports ``dplasma_tpu/resilience/inject.py``. A :class:`FaultPlan` (CLI
``--inject=KIND@STAGE[:RATE[:COUNT]]``, env ``DPLASMA_INJECT``)
corrupts the output of chosen kernel *stages* with one of six fault
models:

- ``bitflip`` — XOR one seeded bit of one seeded element (a silent,
  finite, wrong value);
- ``nan`` / ``inf`` — poison one seeded element;
- ``zero`` — zero the whole tapped tile or panel (a torn write);
- ``delay`` — the tap sleeps MCA ``chaos.delay_ms`` and returns the
  value untouched (a straggler);
- ``reject`` — the tap raises :class:`InjectedReject` (a dispatch
  failure surfacing as an exception).

:func:`parse_schedule` strings plans into a chaos schedule
(comma-separated phases, ``off`` = quiet).

Stages are the tile-kernel choke points of :mod:`kernels.blas`
(``gemm`` — ``dot`` on every route, K1 and the dd limb route included —
``trsm``, ``potrf``, ``getrf``), the serving tap ``serving`` and the
wildcard ``any``. Each stage keeps a site counter per arm; whether site
``i`` faults is a SHA-256 function of (seed, stage, site, rate)
(:func:`_site_u01`) and the element and bit come from a numpy
``default_rng`` seeded by the same triple (:func:`_site_rng`): both are
the reference's, so the same plan corrupts the same element and bit of
the same site in both packages. :func:`_bitflip` is a
``Tensor.view(int16/int32/int64)`` XOR; complex data flips its real
part, as in the reference.

Taps fire at run time here, at trace time in the reference. The
reference corrupts the traced program: a tap inside a jitted or
scanned body fires once per trace, and a cached executable replays the
corruption on every call without firing again (so its :func:`disarm`
clears jax's caches). The port is eager: its taps fire once per
kernel call, so a stage's site numbers differ from the reference's
wherever the reference traces a loop body once and runs it many times.
Site 0 of a stage is the first call in both, so plans of ``COUNT=1`` at
rate 1 corrupt the same element; elsewhere the two packages agree on
the outcome (detected, classified, healed on which rung), not on the
site. The driver re-arms the plan before each execution of the primary
attempt, so each of its runs carries the same fault, as each run of the
reference's compiled executable does.

Faults are transient: the ladder's retry rungs run unarmed, and
:func:`suppressed` scopes (verification, health scans) never fire.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import List, Optional

import numpy as np
import torch

from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "chaos.delay_ms", "50",
    "Straggler stall injected by the 'delay' fault kind, in "
    "milliseconds per faulting tap site.")

KINDS = ("bitflip", "nan", "inf", "zero", "delay", "reject")

#: kinds that act host-side in tap() (sleep / raise) instead of
#: corrupting the value; they skip the inexact-dtype check
BEHAVIORAL_KINDS = ("delay", "reject")


class InjectedReject(RuntimeError):
    """Raised by the ``reject`` fault kind at a tapped site."""


#: stage names with a tap in the kernel layer, plus the serving tap
#: (``any`` matches all)
STAGES = ("gemm", "trsm", "potrf", "getrf", "serving", "any")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic corruption campaign.

    ``rate`` is the per-site fault probability (>= 1 means every
    matching site, subject to ``max_faults``); ``max_faults`` caps the
    campaign (0 = unbounded)."""

    kind: str
    stage: str
    rate: float = 1.0
    max_faults: int = 1
    seed: int = 3872

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {KINDS})")
        if self.stage not in STAGES:
            # a typo'd stage would arm a plan whose tap never matches
            raise ValueError(f"unknown fault stage {self.stage!r} "
                             f"(choose from {STAGES})")
        if not (self.rate > 0.0):
            raise ValueError(f"fault rate must be > 0, got {self.rate}")

    def spec(self) -> str:
        return f"{self.kind}@{self.stage}:{self.rate:g}:{self.max_faults}"


def parse_plan(spec: str, seed: int = 3872) -> FaultPlan:
    """Parse ``KIND@STAGE[:RATE[:COUNT]]`` (the ``--inject`` grammar):
    ``nan@trsm:1`` poisons the first trsm output;
    ``bitflip@gemm:0.25:0`` flips a bit in ~every 4th gemm output."""
    kind, at, rest = spec.strip().partition("@")
    if not at or not rest:
        raise ValueError(
            f"bad inject spec {spec!r}: expected KIND@STAGE[:RATE[:COUNT]]")
    if kind.lower() not in KINDS:
        raise ValueError(
            f"bad inject spec {spec!r}: unknown fault kind "
            f"{kind.lower()!r} (valid kinds: {', '.join(KINDS)})")
    parts = rest.split(":")
    stage = parts[0]
    rate = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
    count = int(parts[2]) if len(parts) > 2 and parts[2] else 1
    return FaultPlan(kind.lower(), stage.lower(), rate, count, seed)


@dataclasses.dataclass(frozen=True)
class ChaosPhase:
    """One window of a chaos schedule: the spec text and its plan
    (``None`` for a quiet phase)."""

    spec: str
    plan: Optional[FaultPlan]


def parse_schedule(text: str, seed: int = 3872) -> List[ChaosPhase]:
    """Parse a comma-separated chaos schedule into phases.
    ``off``/``none``/``-`` (or an empty field) is a quiet phase; armed
    phase k gets seed ``seed + k``."""
    if not text.strip():
        raise ValueError("empty chaos schedule")
    phases: List[ChaosPhase] = []
    for k, field in enumerate(text.split(",")):
        spec = field.strip()
        if not spec or spec.lower() in ("off", "none", "-"):
            phases.append(ChaosPhase(spec or "off", None))
        else:
            phases.append(ChaosPhase(spec, parse_plan(spec, seed + k)))
    return phases


class _Session:
    """Module-global injection state (one armed plan at a time)."""

    def __init__(self):
        self.plan: Optional[FaultPlan] = None
        self.suppress = 0
        self.sites: dict = {}
        self.faults: List[dict] = []


_S = _Session()


def arm(plan: FaultPlan) -> None:
    """Activate ``plan``: site counters and the fault log reset, so a
    re-armed plan replays the same corruption."""
    _S.plan = plan
    _S.sites = {}
    _S.faults = []


def disarm() -> List[dict]:
    """Deactivate the armed plan; returns its fault records. (The
    reference also clears jax's caches here; the port caches nothing
    that a fault could poison.)"""
    faults = list(_S.faults)
    _S.plan = None
    _S.sites = {}
    _S.faults = []
    return faults


def armed() -> bool:
    """Is a plan armed and not suppressed (a tap could fire)?"""
    return _S.plan is not None and _S.suppress == 0


def rearm() -> None:
    """Reset the armed plan's site counters and fault log without
    disarming; no-op when nothing is armed."""
    if _S.plan is not None:
        arm(_S.plan)


def faults() -> List[dict]:
    return list(_S.faults)


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped :func:`arm`/:func:`disarm`; yields the fault-record list
    (filled in on exit)."""
    out: List[dict] = []
    arm(plan)
    try:
        yield out
    finally:
        out.extend(disarm())


@contextlib.contextmanager
def suppressed():
    """Scope where taps never fire (verification, health scans)."""
    _S.suppress += 1
    try:
        yield
    finally:
        _S.suppress -= 1


def _site_u01(seed: int, stage: str, site: int) -> float:
    """Deterministic U[0,1) draw for one (stage, site): the fault
    lottery, the reference's bit for bit."""
    h = hashlib.sha256(f"{seed}:{stage}:{site}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def _site_rng(seed: int, stage: str, site: int):
    """Host-side RNG for the element and bit positions (the
    reference's)."""
    h = hashlib.sha256(f"pos:{seed}:{stage}:{site}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "big"))


_INT_OF = {16: torch.int16, 32: torch.int32, 64: torch.int64}


def _bitflip(val: torch.Tensor, bit: int) -> torch.Tensor:
    """Flip bit ``bit`` of a real tensor's IEEE representation."""
    bits = torch.finfo(val.dtype).bits
    bit %= bits
    mask = 1 << bit
    if mask >= 1 << (bits - 1):   # the sign bit, as a signed word
        mask -= 1 << bits
    word = val.contiguous().view(_INT_OF[bits])
    return torch.bitwise_xor(word, mask).view(val.dtype)


def _real_dtype(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def _index(shape, rng) -> tuple:
    return tuple(int(rng.integers(0, max(int(d), 1))) for d in shape)


def _flip_bit(dtype, rng) -> int:
    # flip within the significant half (sign, exponent, high mantissa):
    # a low-mantissa flip is rounding noise
    bits = torch.finfo(_real_dtype(dtype)).bits
    return int(rng.integers(bits // 2, bits))


def bitflip_at(seed: int, stage: str, site: int, shape, dtype):
    """The (element index, bit) a ``bitflip`` plan of ``seed`` flips in
    the output of ``shape`` and ``dtype`` at (stage, site), drawn on the
    host as :func:`corrupt` draws them, without the output."""
    rng = _site_rng(seed, stage, site)
    return _index(shape, rng), _flip_bit(dtype, rng)


def corrupt(x: torch.Tensor, kind: str, rng):
    """Corruption transform: returns (corrupted copy of x, element
    index). The positions come from ``rng``; ``zero`` wipes the whole
    tensor and reports index (0, ...)."""
    if kind == "zero":
        return torch.zeros_like(x), (0,) * max(x.ndim, 1)
    idx = _index(x.shape, rng)
    if kind in ("nan", "inf"):
        bad = torch.tensor(float(kind), dtype=_real_dtype(x.dtype))
        if x.is_complex():
            bad = torch.complex(bad, torch.zeros_like(bad))
    else:  # bitflip
        el = x[idx].detach().cpu() if idx else x.detach().cpu()
        bit = _flip_bit(x.dtype, rng)
        if x.is_complex():
            im = el.imag
            bad = torch.complex(_bitflip(el.real, bit) + 0.0 * im,
                                0.0 + im)
        else:
            bad = _bitflip(el, bit)
    bad = bad.to(device=x.device, dtype=x.dtype)
    if not idx:
        return bad.reshape(x.shape), idx
    y = x.clone()
    y[idx] = bad
    return y, idx


def tap(stage: str, x):
    """Fault tap on a kernel-stage output — the one entry point the
    kernel layer calls. No armed plan: one attribute check and out."""
    plan = _S.plan
    if plan is None or _S.suppress:
        return x
    if plan.stage != "any" and plan.stage != stage:
        return x
    site = _S.sites.get(stage, 0)
    _S.sites[stage] = site + 1
    if plan.max_faults and len(_S.faults) >= plan.max_faults:
        return x
    if _site_u01(plan.seed, stage, site) >= min(plan.rate, 1.0) \
            and plan.rate < 1.0:
        return x
    if plan.kind in BEHAVIORAL_KINDS:
        # recorded first, so the budget is charged even when it raises
        _S.faults.append({"stage": stage, "site": site,
                          "kind": plan.kind})
        if plan.kind == "delay":
            time.sleep(max(_cfg.mca_get_float("chaos.delay_ms", 50.0),
                           0.0) / 1000.0)
            return x
        raise InjectedReject(f"injected reject at {stage} site {site}")
    if not isinstance(x, torch.Tensor) or not (
            x.is_floating_point() or x.is_complex()):
        return x
    y, idx = corrupt(x, plan.kind, _site_rng(plan.seed, stage, site))
    _S.faults.append({"stage": stage, "site": site, "kind": plan.kind,
                      "shape": tuple(int(d) for d in x.shape),
                      "index": tuple(int(i) for i in idx)})
    return y
