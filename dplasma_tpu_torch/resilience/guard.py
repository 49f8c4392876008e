"""Run guard: health scan, fault classification, watchdog, and the
remediation ladder the driver walks after a failed attempt.

Ports ``dplasma_tpu/resilience/guard.py``. After each driver run a
health scan (a non-finite census over the output, plus the op's ABFT
verification under ``--abft``) gates the result; a failure is
classified and the ladder walks, in order and within ``--max-retries``:

1. **retry** (with exponential backoff): soft errors are transient, and
   retries run with no plan armed, so an injected fault heals as a real
   one recomputes clean;
2. **kernel fallback**: the hand-written Hopper kernels are demoted to
   the port's library route for the rest of the driver run (K1 off, MCA
   ``panel.kernel=pallas`` (K3/K4) to ``chain``; ``Driver.close``
   restores them) — the reference's Pallas → XLA demotion. Taken only
   when the failed attempt carried an injected fault: a wrong answer
   that outlives the retries goes on to the algorithm rungs on the same
   kernels, so a real kernel fault is never hidden behind the library
   route;
3. **algorithm escalation**: the driver body's ``fallbacks`` (LU nopiv →
   RBT-preconditioned nopiv → LU/QR hybrid by ``--criteria``; the IR
   solvers' full-precision solve).

A rung is taken only after an attempt has failed and been classified:
never on a run with no fault. ``numerical``/``silent`` failures start
at retry; ``compile`` and ``timeout`` skip it. The port's ``compile``
class is an injected ``reject`` alone: any other exception an attempt
raises (a kernel's build or launch failure, a CUDA error) fails the
run, where the reference files every trace-time exception as
``compile``. Every attempt, classification and action lands in
the run-report's ``"resilience"`` section.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

CLASS_NUMERICAL = "numerical"
CLASS_SILENT = "silent"          # finite but ABFT-flagged wrong answer
CLASS_COMPILE = "compile"
CLASS_TIMEOUT = "timeout"

ACTION_PRIMARY = "primary"
ACTION_RETRY = "retry"
ACTION_KERNEL_FALLBACK = "kernel_fallback"
ACTION_ALGO_FALLBACK = "algo_fallback"

#: base backoff before a retry rung (doubles per attempt)
_BACKOFF_S = 0.05


def enabled(ip) -> bool:
    """Is the guard active for this run? Off (no cost) unless a
    resilience flag is set."""
    return bool(getattr(ip, "inject", None) or getattr(ip, "abft", False)
                or getattr(ip, "run_timeout", 0.0) > 0)


def _leaves(out):
    """The tensors of an output tree: tensors, TileMatrix storage, the
    slabs of a CyclicMatrix, tuples, lists and dict values."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _leaves(x)
    elif hasattr(out, "data"):
        yield from _leaves(out.data)


def health_scan(out) -> dict:
    """Non-finite census over the output tree (the cheap post-run gate:
    one reduction per floating leaf, one host read for all)."""
    counts = []
    for leaf in _leaves(out):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            continue
        counts.append(torch.stack([torch.isnan(leaf).sum(),
                                   torch.isinf(leaf).sum()]))
    if counts:
        nan, inf = (int(v) for v in torch.stack(counts).sum(dim=0).cpu())
    else:
        nan = inf = 0
    return {"nan": nan, "inf": inf, "leaves": len(counts),
            "ok": (nan + inf) == 0}


class Watchdog:
    """Watchdog on the timed loop: a timer thread flags (and logs) the
    overrun as it happens; the ladder classifies the attempt as
    ``timeout`` afterwards. A launched kernel cannot be preempted, so
    the watchdog observes rather than kills."""

    def __init__(self, limit_s: float, label: str = ""):
        self.limit_s = float(limit_s or 0.0)
        self.label = label
        self.fired = False
        self.elapsed_s = 0.0
        self._t0 = 0.0
        self._timer: Optional[threading.Timer] = None

    def _fire(self):
        self.fired = True
        sys.stderr.write(
            f"#! watchdog: {self.label or 'run'} exceeded "
            f"{self.limit_s:g}s\n")

    def __enter__(self):
        self._t0 = time.perf_counter()
        if self.limit_s > 0:
            self._timer = threading.Timer(self.limit_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        self.elapsed_s = time.perf_counter() - self._t0
        return False

    @property
    def timed_out(self) -> bool:
        return self.limit_s > 0 and (self.fired
                                     or self.elapsed_s > self.limit_s)


def kernel_fallback() -> dict:
    """Demote the hand-written kernels to the library route until
    :meth:`Ladder.restore`: K1 off, and the K3/K4 panels (MCA
    ``panel.kernel`` ``pallas``) to the vendor chain. Returns what
    changed."""
    from dplasma_tpu_torch.kernels import pallas_kernels, panels
    from dplasma_tpu_torch.utils import config
    was = pallas_kernels.enabled()
    pallas_kernels.enable(False)
    mca = {}
    if panels.panel_kernel_config() == "pallas":
        config.mca_set("panel.kernel", "chain")
        mca["panel.kernel"] = "chain"
    return {"k1_was_enabled": bool(was), "mca": mca}


class Ladder:
    """Remediation state machine for one ``Driver.progress`` call.

    ``fallbacks`` is an ordered list of ``(label, fn)`` alternates from
    the driver body; each takes the primary fn's arguments (its output
    contract may differ: the body dispatches on :attr:`winner`)."""

    def __init__(self, ip, name: str,
                 fallbacks: Sequence[Tuple[str, Callable]] = ()):
        self.name = name
        self.max_retries = max(int(getattr(ip, "max_retries", 2)), 0)
        self.attempts: List[dict] = []
        self._fallbacks = list(fallbacks)
        self._retries_used = 0
        self._tried_kernel = False
        self._demoted = None      # (K1 enabled, panel.kernel override)
        self.winner = name
        self.outcome = "clean"

    def record(self, action: str, label: str, ok: bool,
               classification: Optional[str] = None,
               health: Optional[dict] = None,
               abft: Optional[dict] = None,
               elapsed_s: Optional[float] = None,
               error: Optional[str] = None) -> dict:
        entry = {"attempt": len(self.attempts), "action": action,
                 "label": label, "ok": bool(ok),
                 "classification": classification, "health": health,
                 "abft": abft, "elapsed_s": elapsed_s, "error": error}
        self.attempts.append(entry)
        return entry

    def classify(self, health: Optional[dict], abft: Optional[dict],
                 timed_out: bool) -> str:
        if timed_out:
            return CLASS_TIMEOUT
        if health is not None and not health["ok"]:
            return CLASS_NUMERICAL
        return CLASS_SILENT

    def next_action(self, classification: str):
        """The next untried rung for this failure class: ``--max-retries``
        budgets the retry rung, the fallback rungs are one-shot. Returns
        ``(action, label, fn or None)``, or None when the ladder is
        exhausted."""
        skip_retry = classification in (CLASS_COMPILE, CLASS_TIMEOUT)
        if not skip_retry and self._retries_used < self.max_retries:
            self._retries_used += 1
            time.sleep(_BACKOFF_S * (2 ** (self._retries_used - 1)))
            return (ACTION_RETRY, self.name, None)
        if not self._tried_kernel:
            self._tried_kernel = True
            return (ACTION_KERNEL_FALLBACK, self.name, None)
        if self._fallbacks:
            label, fn = self._fallbacks.pop(0)
            return (ACTION_ALGO_FALLBACK, label, fn)
        return None

    def advance(self, classification: str, injected: bool):
        """:meth:`next_action`, applied: the kernel-fallback rung is
        taken (and the kernels demoted) only when the failed attempt
        carried an injected fault, else passed over. Returns ``(action,
        label, fn or None)``, or None when the ladder is exhausted."""
        nxt = self.next_action(classification)
        if nxt is not None and nxt[0] == ACTION_KERNEL_FALLBACK:
            if not injected:
                return self.next_action(classification)
            from dplasma_tpu_torch.kernels import pallas_kernels
            from dplasma_tpu_torch.utils import config
            self._demoted = (pallas_kernels.enabled(),
                             config.mca_snapshot().get("panel.kernel"))
            kernel_fallback()
        return nxt

    def restore(self) -> None:
        """Undo the kernel-fallback rung: K1 and MCA ``panel.kernel`` as
        they were before it."""
        if self._demoted is None:
            return
        from dplasma_tpu_torch.kernels import pallas_kernels
        from dplasma_tpu_torch.utils import config
        k1, panel = self._demoted
        self._demoted = None
        pallas_kernels.enable(k1)
        if panel is None:
            config.mca_unset("panel.kernel")
        else:
            config.mca_set("panel.kernel", panel)

    def summary(self, injection: Optional[dict]) -> dict:
        ok_last = bool(self.attempts) and self.attempts[-1]["ok"]
        abft_fixed = bool(
            ok_last and (self.attempts[-1].get("abft") or {}).get(
                "corrected"))
        if not self.attempts:
            self.outcome = "clean"
        elif ok_last:
            self.outcome = "remediated" \
                if (len(self.attempts) > 1 or abft_fixed) else "clean"
        else:
            self.outcome = "failed"
        return {"op": self.name, "enabled": True, "injection": injection,
                "attempts": self.attempts, "outcome": self.outcome,
                "winner": self.winner,
                "faults_detected": sum(
                    1 for a in self.attempts
                    if not a["ok"] or (a.get("abft")
                                       or {}).get("detected"))}


def format_lines(summary: dict) -> List[str]:
    """Human form of the resilience summary (``#+`` driver lines). A
    behavioral fault (delay, reject) has no element index."""
    lines = []
    inj = summary.get("injection")
    if inj and inj.get("faults"):
        for f in inj["faults"]:
            where = (f" index {tuple(f['index'])}" if "index" in f
                     else "")
            lines.append(f"#+ resilience: injected {f['kind']} at "
                         f"{f['stage']} site {f['site']}{where}")
    for a in summary.get("attempts", ()):
        if a["ok"]:
            lines.append(f"#+ resilience: attempt {a['attempt']} "
                         f"({a['action']}:{a['label']}) ok")
        else:
            h = a.get("health") or {}
            extra = ""
            if h and not h.get("ok", True):
                extra = f" ({h['nan']} nan / {h['inf']} inf)"
            ab = a.get("abft")
            if ab and ab.get("detected"):
                extra += (f" [abft located "
                          f"{ab.get('located')}"
                          + (" corrected" if ab.get("corrected") else "")
                          + "]")
            lines.append(f"#+ resilience: attempt {a['attempt']} "
                         f"({a['action']}:{a['label']}) failed "
                         f"[{a['classification']}]{extra}")
    lines.append(f"#+ resilience: outcome {summary['outcome']} "
                 f"after {len(summary.get('attempts', ()))} attempt(s)")
    return lines
