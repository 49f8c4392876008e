"""Shared driver harness — the part of ``dplasma_tpu/drivers/common.py``
that the ported drivers need (``testers.DRIVERS``).

The CLI vocabulary is the reference's (ref tests/common.c:73-259):
``-N -M -K -t -T -x -X -v --nruns -z/--HNB --seed -p -q -g
--criteria -a/--alpha``, the HQR tree flags ``--qr_a --qr_p --treel
--treeh -d/--domino -r/--tsrr`` and the butterfly depth ``-y/--butlvl``,
plus
``--nowarmup``, ``--lookahead`` and the port's ``--device`` (``cuda``
by default; ``--device cpu`` runs on the CPU). Each timed op runs once
untimed (the warm-up: kernel builds, allocator growth), then ``--nruns``
times, each timed with CUDA events and a ``torch.cuda.synchronize()``
on the card (a host clock on the CPU), and prints the reference's
``[****] TIME(s)`` line (common.py:1541-1545) so log parsers work
unchanged. The port has no trace/compile step, so ENQ and DEST are 0.
``-p P -q Q`` with P·Q > 1 activates a P×Q virtual mesh on the run's
device (``parallel.mesh``) for the run: the distributed drivers
(``getrf_ptgpanel``) run on it, the others ignore it.

Every driver run is recorded in :data:`RUNS` (newest last): per op the
run times, GFLOP/s and the launches of each hand-written kernel
(:data:`KERNELS`) in each timed run; per ``-x`` check its residual and
verdict; per mixed-precision IR solve its ``"refine"`` summary
(:meth:`Driver.report_refine`).
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.kernels import pallas_dd as _pdd
from dplasma_tpu_torch.kernels import pallas_kernels as _pk
from dplasma_tpu_torch.kernels import pallas_lu as _plu
from dplasma_tpu_torch.kernels import pallas_qr as _pqr
from dplasma_tpu_torch.kernels import pallas_ring as _pring
from dplasma_tpu_torch.kernels import panels as _panels
from dplasma_tpu_torch.kernels import sbr as _sbr
from dplasma_tpu_torch.kernels import tridiag as _tridiag
from dplasma_tpu_torch.parallel import mesh as _pmesh
from dplasma_tpu_torch.utils import config as _cfg

PRECISIONS = {"s": torch.float32, "d": torch.float64,
              "c": torch.complex64, "z": torch.complex128}

#: one record per driver run in this process, newest last
RUNS: list = []

#: (label, wrapper module with a ``LAUNCHES`` counter) of every
#: hand-written kernel; op records carry ``<label>_launches``, and
#: ``kw_steps``, the sweep steps KW's launches ran
KERNELS = (("k1", _pk), ("k2", _pdd), ("k3", _plu), ("k4", _pqr),
           ("k5", _pring), ("kt", _tridiag), ("kw", _sbr))


@dataclass
class IParam:
    """Driver parameter block (the iparam[] array of tests/common.c)."""
    P: int = 1
    Q: int = 1
    M: int = 0
    N: int = 0
    K: int = 1          # NRHS for solves, K for gemm
    MB: int = 0
    NB: int = 0
    HMB: int = 0        # recursive inner blocking (-z/--HNB)
    HNB: int = 0
    check: bool = False
    check_inv: bool = False
    loud: int = 1       # verbosity ladder (-v[=n])
    seed: int = 3872
    nruns: int = 1
    warmup: bool = True
    lookahead: int = -1  # -1 = MCA sweep.lookahead
    # HQR trees (--qr_a/--qr_p/--treel/--treeh/-d/-r)
    qr_a: int = -1
    qr_p: int = -1
    lowlvl_tree: int = -1
    highlvl_tree: int = -1
    qr_domino: int = -1
    qr_tsrr: int = 0
    # butterfly (-y)
    butterfly_level: int = 0
    # LU/QR hybrid (--criteria, -a/--alpha)
    criteria: int = 0
    alpha: float = -1.0
    gpus: int = 0
    device: str = "cuda"
    prec: str = "d"

    @property
    def prec_dtype(self):
        return PRECISIONS[self.prec]


_USAGE = """\
Mandatory argument:
 -N                : dimension (N) of the matrices
Optional arguments:
 -M                : dimension (M) of the matrices (default: N)
 -K --NRHS         : dimension (K) / right-hand-side count (default: 1)
 -t --MB           : rows in a tile (default: from N)
 -T --NB           : columns in a tile (default: MB)
 -z --HNB --HMB    : inner NB/MB for recursive algorithms
 -x --check        : verify the results
 -X --check_inv    : verify against the inverse
 -p -q             : process grid P x Q (a virtual mesh on the device)
 -g --gpus         : accepted and recorded
 --qr_a --qr_p     : HQR TS-domain size / high-level tree size
 -d --domino -r --tsrr : HQR domino / TS round-robin toggles
 --treel --treeh   : HQR low/high level tree (0 flat 1 greedy
                     2 fibonacci 3 binary 4 greedy1p)
 -y --butlvl       : butterfly level
 --criteria -a --alpha : LU/QR switch criteria and threshold
 --lookahead       : pipelined-sweep lookahead (default: MCA
                     sweep.lookahead, 1)
 --seed            : generator seed
 --nruns           : number of timed runs
 --nowarmup        : skip the untimed warm run before the timed loop
 --device          : cuda (default) or cpu
 -v --verbose[=n]  : verbosity ladder
 -h --help         : this message
MCA knobs come from the environment, DPLASMA_MCA_<NAME> (dots as
underscores): DPLASMA_MCA_DD_GEMM=always puts the d-precision drivers
on the f64-equivalent limb route; DPLASMA_MCA_IR_PRECISION=int8|bf16|
f32|f32x2 picks the working precision of posv_ir, gesv_ir and gels_ir.
"""


def _int(v: str) -> int:
    return int(v, 0)


def default_tile(n: int) -> int:
    """The defaults-cascade tile size for an ``n``-sized problem (the
    reference's formula)."""
    return min(max(n, 1), 192 if n >= 1024 else 64)


# option name -> (iparam field, converter or None-for-flag)
_LONG = {
    "grid-rows": ("P", _int), "grid-cols": ("Q", _int),
    "P": ("P", _int), "Q": ("Q", _int),
    "N": ("N", _int), "M": ("M", _int), "K": ("K", _int),
    "NRHS": ("K", _int),
    "MB": ("MB", _int), "NB": ("NB", _int),
    "HNB": ("HNB", _int), "HMB": ("HMB", _int),
    "check": ("check", None), "check_inv": ("check_inv", None),
    "qr_a": ("qr_a", _int), "qr_p": ("qr_p", _int),
    "treel": ("lowlvl_tree", _int), "treeh": ("highlvl_tree", _int),
    "domino": ("qr_domino", _int), "tsrr": ("qr_tsrr", _int),
    "criteria": ("criteria", _int), "alpha": ("alpha", float),
    "lookahead": ("lookahead", _int),
    "seed": ("seed", _int),
    "butlvl": ("butterfly_level", _int),
    "nruns": ("nruns", _int),
    "gpus": ("gpus", _int),
    "device": ("device", str),
}

_SHORT = {
    "p": "grid-rows", "P": "grid-rows", "q": "grid-cols", "Q": "grid-cols",
    "N": "N", "M": "M", "K": "NRHS", "t": "MB", "T": "NB", "z": "HNB",
    "a": "alpha", "y": "butlvl", "g": "gpus", "d": "domino", "r": "tsrr",
}
_SHORT_FLAGS = {"x": "check", "X": "check_inv"}


def _usage_exit(msg: str):
    sys.stderr.write(f"{msg}\n{_USAGE}")
    raise SystemExit(2)


def parse_arguments(argv: list[str], ip: Optional[IParam] = None) -> IParam:
    ip = ip or IParam()
    args = list(argv)
    i = 0
    positional = []
    while i < len(args):
        a = args[i]
        if a in ("-h", "--help"):
            sys.stderr.write(_USAGE)
            raise SystemExit(0)
        if a.startswith("--"):
            name, eq, val = a[2:].partition("=")
            if name == "verbose":
                ip.loud = _int(val) if eq else 2
            elif name == "nowarmup":
                ip.warmup = False
            elif name in _LONG:
                field_, conv = _LONG[name]
                if conv is None:
                    setattr(ip, field_, True)
                else:
                    if not eq:
                        i += 1
                        if i >= len(args):
                            _usage_exit(f"missing value for option {a}")
                        val = args[i]
                    setattr(ip, field_, conv(val))
            else:
                _usage_exit(f"unknown option {a}")
        elif a.startswith("-") and len(a) >= 2 and not a[1].isdigit():
            c, rest = a[1], a[2:]
            if c == "v":
                ip.loud = _int(rest.lstrip("=")) if rest else 2
            elif c in _SHORT_FLAGS:
                for cc in a[1:]:
                    if cc not in _SHORT_FLAGS:
                        _usage_exit(f"unknown flag -{cc} in {a}")
                    setattr(ip, _SHORT_FLAGS[cc], True)
            elif c in _SHORT:
                field_, conv = _LONG[_SHORT[c]]
                val = rest.lstrip("=")
                if not val:
                    i += 1
                    if i >= len(args):
                        _usage_exit(f"missing value for option {a}")
                    val = args[i]
                setattr(ip, field_, conv(val))
            else:
                _usage_exit(f"unknown option {a}")
        else:
            positional.append(a)
        i += 1
    if positional and ip.N == 0:
        ip.N = _int(positional[0])
    # defaults cascade (iparam_default_* in tests/common.c:586-638)
    if ip.M == 0:
        ip.M = ip.N
    if ip.MB == 0:
        ip.MB = default_tile(ip.N)
    if ip.NB == 0:
        ip.NB = ip.MB
    if ip.HNB == 0:
        ip.HNB = ip.NB
    if ip.HMB == 0:
        ip.HMB = ip.MB
    return ip


class Driver:
    """Per-run context: device, scoped knobs, timing, reporting."""

    def __init__(self, ip: IParam, name: str):
        self.ip = ip
        self.name = name
        self.check_failures = 0
        if ip.P < 1 or ip.Q < 1:
            raise SystemExit(f"invalid grid {ip.P}x{ip.Q}")
        self.device = resolve_device(ip.device)
        self.mesh = (_pmesh.make_mesh(ip.P, ip.Q, self.device)
                     if ip.P * ip.Q > 1 else None)
        self.record = {"driver": name, "prec": ip.prec, "N": ip.N,
                       "M": ip.M, "K": ip.K, "NB": ip.NB,
                       "grid": [ip.P, ip.Q],
                       "device": str(self.device), "ops": [],
                       "checks": [], "refine": []}
        RUNS.append(self.record)
        self._frames = []
        self._grid = None
        if self.mesh is not None:
            self._grid = _pmesh.use_grid(self.mesh)
            self._grid.__enter__()
        if ip.lookahead >= 0:
            self._frames.append(_cfg.push_overrides(
                {"sweep.lookahead": ip.lookahead}, label="--lookahead"))
        if ip.loud >= 2:
            where = (torch.cuda.get_device_name(self.device)
                     if self.device.type == "cuda" else "cpu")
            print(f"#+ device: {self.device} ({where}) K1 enabled="
                  f"{_pk.enabled()} dd_gemm={_cfg.mca_get('dd_gemm')} "
                  f"LU panel.kernel="
                  f"{_panels.panel_kernel('lu')} QR panel.kernel="
                  f"{_panels.panel_kernel('qr')}")
            if self.mesh is not None:
                dt = ip.prec_dtype
                print(f"#+ grid: {ip.P}x{ip.Q} on {self.device} "
                      f"ring.enable={_cfg.mca_get('ring.enable')} -> "
                      f"q ring {_pring.ring_active(ip.Q, dt, self.mesh, 'q')}"
                      f", p ring {_pring.ring_active(ip.P, dt, self.mesh, 'p')}"
                      f" ({dt})")

    def close(self):
        for frame in reversed(self._frames):
            _cfg.pop_overrides(frame)
        self._frames = []
        if self._grid is not None:
            self._grid.__exit__(None, None, None)
            self._grid = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, fn: Callable, args: tuple):
        """One run of ``fn``: (output, seconds, {label: launches} of
        every kernel in :data:`KERNELS`, and "kw_steps")."""
        before = {lab: mod.LAUNCHES for lab, mod in KERNELS}
        steps = _sbr.STEPS
        if self.device.type == "cuda":
            self.sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.sync()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            secs = time.perf_counter() - t0
        return out, secs, {**{lab: mod.LAUNCHES - before[lab]
                              for lab, mod in KERNELS},
                           "kw_steps": _sbr.STEPS - steps}

    def progress(self, fn: Callable, args: tuple, flops: float,
                 label: Optional[str] = None):
        """Warm up, run ``nruns`` timed, print the reference-format perf
        line. Returns (output, gflops)."""
        ip, name = self.ip, label or self.name
        warm = None
        if ip.warmup:
            _, warm, _ = self._timed(fn, args)
        times = []
        launches = {lab: [] for lab, _ in KERNELS}
        kw_steps = []
        out = None
        for _ in range(max(ip.nruns, 1)):
            out, secs, n = self._timed(fn, args)
            times.append(secs)
            for lab in launches:
                launches[lab].append(n[lab])
            kw_steps.append(n["kw_steps"])
        best = min(times)
        gflops = (flops / 1e9) / best
        enq = dest = 0.0
        total = enq + best + dest
        self.record["ops"].append({
            "op": name, "flops": flops, "warmup_s": warm, "runs_s": times,
            "best_s": best, "gflops": gflops,
            **{f"{lab}_launches": n for lab, n in launches.items()},
            "kw_steps": kw_steps})
        if ip.loud >= 2:
            print(f"#+ kernels[{name}]: " + ", ".join(
                f"{lab.upper()} launches per run = {n}"
                for lab, n in launches.items())
                + f", KW steps per run = {kw_steps}")
        print("[****] TIME(s) %12.5f : %s\tPxQxg= %3d %-3d %d NB= %4d "
              "N= %7d : %14f gflops - ENQ&PROG&DEST %12.5f : %14f gflops"
              " - ENQ %12.5f - DEST %12.5f"
              % (best, name, ip.P, ip.Q, ip.gpus, ip.NB, ip.N,
                 gflops, total, (flops / 1e9) / total, enq, dest))
        sys.stdout.flush()
        return out, gflops

    def report_refine(self, summary: dict) -> dict:
        """Record one mixed-precision IR solve (``ops.refine.summarize``)
        in the record's ``"refine"`` list, and at -v >= 2 print the
        ``#+ refine[op]:`` line."""
        self.record["refine"].append(summary)
        if self.ip.loud >= 2:
            hist = summary.get("backward_errors") or []
            tail = f" bwd={hist[-1]:.3e}" if hist else ""
            print("#+ refine[%s]: precision=%s iters=%d %s%s"
                  % (summary.get("op", self.name),
                     summary.get("precision", "?"),
                     summary.get("iterations", 0),
                     ("escalated" if summary.get("escalated") else
                      "converged" if summary.get("converged") else
                      "exhausted"), tail))
            sys.stdout.flush()
        return summary

    def report_check(self, what: str, residual, ok) -> int:
        res = float(residual)
        passed = bool(ok)
        self.record["checks"].append(
            {"check": what, "residual": res, "ok": passed})
        if not passed:
            self.check_failures += 1
        print(f"[{'SUCCESS' if passed else 'FAILED'}] {what} residual = "
              f"{res:e}")
        return 0 if passed else 1


def run_driver(name: str, body: Callable[[Driver], int],
               argv: Optional[list[str]] = None) -> int:
    """Entry point shared by the testing_* drivers. The precision letter
    after ``testing_`` selects the dtype."""
    ip = IParam()
    base = name.rsplit("/", 1)[-1]
    if base.startswith("testing_") and base[8:9] in PRECISIONS:
        ip.prec = base[8]
    ip = parse_arguments(sys.argv[1:] if argv is None else argv, ip)
    if ip.N <= 0:
        sys.stderr.write("missing matrix dimension (-N)\n" + _USAGE)
        return 2
    drv = Driver(ip, base)
    try:
        ret = body(drv) or 0
    finally:
        drv.close()
    if ret == 0 and drv.check_failures:
        ret = 1
    return ret
