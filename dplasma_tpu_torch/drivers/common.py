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

The reference's instruments (common.py:213-255, :300-325, :507-560,
:795-812, :1027-1080, :1363-1386): every run keeps a DTPUPROF1
:class:`~dplasma_tpu_torch.utils.profiling.Profile` (``enq``,
``warmup`` and ``run[i]`` spans) and a
:class:`~dplasma_tpu_torch.observability.report.RunReport` (one op
entry a timed op: timings, model flops, GFLOP/s, the comm model; the
checks and IR summaries; the metrics registry), written at
:meth:`Driver.close` by ``--profile[=file]`` and ``--report[=file]``.
``--phase-profile`` adds one attributed pass after the timed loop under
a phase ledger (the only place spans fence), met with the roofline
model on the peaks of ``--peaks-file`` (default: the conservative
built-ins); ``-v 2`` prints its table. ``--jaxtrace[=dir]`` keeps the
reference's spelling and writes a ``torch.profiler`` trace of the timed
loop. The timed loop itself never fences: it launches what it launched
without the flags.

The live and measured instruments (common.py:553-562, :748-776,
:1141-1143, :1292-1308, :1389-1480): ``--telemetry[=file]`` opens a
:class:`~dplasma_tpu_torch.observability.telemetry.Telemetry` for the
run (its exporter rewrites the Prometheus snapshot of the run's
metrics in ``file``; its flight recorder keeps ``run_start``,
``op_start``, ``op_done`` and the devprof events), closed into the
report's ``"telemetry"`` section. ``--devprof`` wraps the timed loop in
a :class:`~dplasma_tpu_torch.observability.devprof.DevprofCapture`
(a ``torch.profiler`` capture of the best run on the card, the
synthetic timeline elsewhere; MCA ``devprof.backend``) and attributes
it into the ``"devprof"`` section; a failed attribution is a flight
event and a line on stderr, never a failed run. Every ``--report`` is
stamped with its provenance.
"""
from __future__ import annotations

import contextlib
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
from dplasma_tpu_torch.observability import phases as _phases
from dplasma_tpu_torch.observability import roofline as _rl
from dplasma_tpu_torch.observability.comm import OP_CLASS
from dplasma_tpu_torch.observability.report import RunReport
from dplasma_tpu_torch.ops._sweep import sweep_params
from dplasma_tpu_torch.parallel import mesh as _pmesh
from dplasma_tpu_torch.utils import config as _cfg
from dplasma_tpu_torch.utils.profiling import Profile, torch_trace

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
    # observability outputs (--profile/--report/--jaxtrace)
    profile: Optional[str] = None    # DTPUPROF1 binary trace
    report: Optional[str] = None     # versioned JSON run-report
    jaxtrace: Optional[str] = None   # torch.profiler trace directory
    # live telemetry (--telemetry[=prom-file]): streaming metrics
    # exporter + flight recorder, the report's "telemetry" section
    telemetry: Optional[str] = None
    # performance attribution (--phase-profile/--devprof/--peaks-file)
    phase_profile: bool = False
    devprof: bool = False            # device timeline attribution (v14)
    peaks_file: Optional[str] = None
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
 --profile[=file]  : write the binary DTPUPROF1 run trace (default
                     file: run.prof)
 --report[=file]   : write the versioned JSON run-report (timings,
                     per-run stats, comm model, checks, IR summaries,
                     phases, roofline; default file: report.json)
 --jaxtrace[=dir]  : a torch.profiler trace of the timed loop (CPU and
                     CUDA activities) into dir/trace.json (default:
                     jax_trace; the reference's spelling)
 --telemetry[=file]: live telemetry for this run: a daemon thread
                     rewrites the Prometheus text snapshot of the run's
                     metrics in file (default: telemetry.prom) every MCA
                     telemetry.interval_s seconds, and a bounded flight
                     recorder of structured events (run and op starts,
                     op finishes, devprof diagnostics) lands in the
                     run-report ("telemetry" section)
 --devprof         : the device timeline of the best timed run: a
                     torch.profiler capture on the card (CUDA kernels,
                     memcpy, memset), else a synthetic timeline from the
                     measured run, the collective schedule and the comm
                     model (MCA devprof.backend: auto, torch, synthetic;
                     auto is torch on a card with a 1x1 grid), binned
                     into compute/collective/ici/host, reconciled per
                     collective class against the schedule and the comm
                     model (MCA devprof.ici_floor), with per-rank skew
                     and the critical path; lands in the run-report
                     ("devprof" section) and the devprof_* metrics
 --phase-profile   : one extra attributed pass after the timed loop,
                     its phase spans fenced at exit and met with the
                     roofline model; the table prints at -v>=2 and
                     lands in the run-report. The timed loop stays
                     fence-free
 --peaks-file=FILE : peaks for the roofline (a JSON doc with a "peaks"
                     section, or a raw dict: mxu_gflops, hbm_gbps,
                     ici_gbps, host_gbps, latency_us and the probed
                     per-type rates); default: conservative built-ins
 -v --verbose[=n]  : verbosity ladder
 -h --help         : this message
Not ported yet (a usage error names the ROADMAP queue 1 item):
 --dot --dagcheck --spmdcheck --hlocheck --memcheck (item 15),
 --autotune (item 9b), --abft --inject --max-retries --run-timeout
 (item 13).
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
    "phase-profile": ("phase_profile", None),
    "devprof": ("devprof", None),
    "peaks-file": ("peaks_file", str),
}

#: "--name[=value]" options whose value is optional -> (field, default)
_OPTIONAL_VALUE = {"profile": ("profile", "run.prof"),
                   "report": ("report", "report.json"),
                   "jaxtrace": ("jaxtrace", "jax_trace"),
                   "telemetry": ("telemetry", "telemetry.prom")}

#: the reference's flags of layers not ported yet -> the ROADMAP item
_DEFERRED = {
    "dot": "ROADMAP queue 1 item 15", "dagcheck": "ROADMAP queue 1 item 15",
    "spmdcheck": "ROADMAP queue 1 item 15",
    "hlocheck": "ROADMAP queue 1 item 15",
    "memcheck": "ROADMAP queue 1 item 15",
    "autotune": "ROADMAP queue 1 item 9b",
    "abft": "ROADMAP queue 1 item 13", "inject": "ROADMAP queue 1 item 13",
    "max-retries": "ROADMAP queue 1 item 13",
    "run-timeout": "ROADMAP queue 1 item 13",
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
            elif name in _OPTIONAL_VALUE:
                field_, default = _OPTIONAL_VALUE[name]
                setattr(ip, field_, val if eq else default)
            elif name in _DEFERRED:
                _usage_exit(f"option --{name} is not ported yet "
                            f"({_DEFERRED[name]})")
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


def _pct(frac) -> str:
    """Format an achieved fraction as a percent (None -> n/a)."""
    return "n/a" if frac is None else f"{100.0 * frac:.1f}%"


def _algo_of(name: str) -> str:
    """Precision-less algo name of a driver: testing_dpotrf -> potrf."""
    base = name.rsplit("/", 1)[-1]
    if base.startswith("testing_"):
        rest = base[8:]
        if rest[:1] in PRECISIONS and rest[1:]:
            return rest[1:]
        return rest
    return base


def _itemsize(prec: str) -> int:
    return torch.empty((), dtype=PRECISIONS[prec]).element_size()


#: drivers whose op the collective schedule and the comm model price
#: (the reference's ``_HLOCHECK_MODEL_ALGOS``, common.py:460-466)
_MODEL_ALGOS = {
    "potrf": "potrf", "posv": "potrf",
    "getrf_ptgpanel": "getrf",
    "geqrf": "geqrf", "gels": "geqrf",
    "gemm": "gemm",
}


def _model_op_kt(algo: str, ip) -> tuple:
    """(op class, KT) of the schedule's model, or (None, 0)
    (common.py:468-482). SUMMA gemm steps over ``ceil(K / NB)``
    contraction steps, the factorizations over ``ceil(min(M, N) / NB)``
    panels."""
    cls = _MODEL_ALGOS.get(algo)
    nb = max(ip.NB, 1)
    if cls == "gemm":
        return "gemm", max(-(-max(ip.K, 1) // nb), 1)
    if cls is not None:
        return cls, max(-(-min(ip.M, ip.N) // nb), 1)
    return None, 0


@contextlib.contextmanager
def _trace_guard(logdir: str):
    """``--jaxtrace`` around the timed loop: a profiler that fails to
    start or stop degrades to a warning, never a failed run."""
    cm = torch_trace(logdir)
    try:
        cm.__enter__()
    except Exception as exc:
        sys.stderr.write(f"#! torch profiler unavailable: {exc}\n")
        yield
        return
    try:
        yield
    finally:
        try:
            cm.__exit__(None, None, None)
        except Exception as exc:
            sys.stderr.write(f"#! torch profiler stop failed: {exc}\n")


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
        # one profile + one run-report per driver run, written at
        # close() when --profile / --report ask for them
        self.prof = Profile(rank=0)
        self.prof.save_info("driver", name)
        self.prof.save_info("prec", ip.prec)
        self.report = RunReport(name, ip)
        # --telemetry: the live instruments — the Prometheus exporter
        # over the run's metrics registry and a flight recorder of the
        # run's events (the report's "telemetry" section)
        self.telemetry = None
        if ip.telemetry:
            from dplasma_tpu_torch.observability.telemetry import Telemetry
            self.telemetry = Telemetry(rank=0)
            self.telemetry.start_exporter(self.report.metrics, ip.telemetry)
            self.telemetry.flight.record(
                "run_start", driver=name, prec=ip.prec, N=ip.N, NB=ip.NB,
                grid=[ip.P, ip.Q])
        self._peaks_cache = None
        self._pipe_printed = False
        self._frames = []
        self._grid = None
        if self.mesh is not None:
            self._grid = _pmesh.use_grid(self.mesh)
            self._grid.__enter__()
        if ip.lookahead >= 0:
            self._frames.append(_cfg.push_overrides(
                {"sweep.lookahead": ip.lookahead}, label="--lookahead"))
        # the pipeline shape from the now-active configuration, the
        # source every sweep and panel reads (schema v4/v9/v11/v12)
        la, agg = sweep_params()
        self.pipeline = {
            "sweep.lookahead": la, "qr.agg_depth": agg,
            "lu.agg_depth": _cfg.mca_get_int("lu.agg_depth", 4),
            "panel.kernel": _panels.panel_kernel_config(),
            "panel.qr": _panels.panel_kernel("qr"),
            "panel.lu": _panels.panel_kernel("lu"),
            "panel.tree_leaf": _cfg.mca_get_int("panel.tree_leaf", 2),
            "panel.rec_base": _cfg.mca_get_int("panel.rec_base", 8),
            "ring.enable": _cfg.mca_get("ring.enable") or "auto"}
        self.report.pipeline = dict(self.pipeline)
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
        ip = self.ip
        if self.telemetry is not None:
            # the exporter's last flush and the section, before the
            # report is written below
            self.telemetry.close()
            self.report.add_telemetry(self.telemetry.summary())
            if ip.loud >= 1 and self.telemetry.exporter:
                ex = self.telemetry.exporter
                print(f"#+ telemetry: {ex.flushes} snapshot(s) exported "
                      f"to {ex.path}")
            self.telemetry = None
        if ip.profile:
            try:
                self.prof.write(ip.profile)
                if ip.loud >= 1:
                    print(f"#+ profile trace written to {ip.profile}")
            except OSError as exc:
                sys.stderr.write(f"#! cannot write profile: {exc}\n")
        if ip.report:
            try:
                # the attribution stamp, collected at close() so the MCA
                # snapshot holds the knobs the run ended with
                self.report.stamp_provenance(
                    family=self.report.name, mesh_shape=[ip.P, ip.Q],
                    peaks_source="file" if ip.peaks_file else "default")
                self.report.write(ip.report)
                if ip.loud >= 1:
                    print(f"#+ run-report written to {ip.report}")
            except OSError as exc:
                sys.stderr.write(f"#! cannot write report: {exc}\n")
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

    def _comm_model(self):
        """The analytic comm-volume model of this driver's op class, or
        None when it fails (the report shows an explicit null)."""
        from dplasma_tpu_torch.descriptors import Dist
        from dplasma_tpu_torch.observability.comm import comm_volume_model
        ip = self.ip
        try:
            return comm_volume_model(
                _algo_of(self.name), ip.M, ip.N, ip.K, ip.MB, ip.NB,
                _itemsize(ip.prec), Dist(P=ip.P, Q=ip.Q))
        except Exception:
            return None

    def _peaks(self):
        """The roofline peaks, resolved once a run (``--peaks-file``,
        else the conservative built-ins); an unreadable file degrades
        to the built-ins with a warning."""
        if self._peaks_cache is None:
            try:
                self._peaks_cache = _rl.resolve_peaks(self.ip.peaks_file,
                                                      prec=self.ip.prec)
            except (OSError, ValueError) as exc:
                sys.stderr.write(f"#! cannot read peaks file: {exc}\n")
                self._peaks_cache = (dict(_rl.DEFAULT_PEAKS), "default")
        return self._peaks_cache

    def _phase_attribution(self, fn, args, name):
        """``--phase-profile``: one extra attributed pass after the timed
        loop, under a phase ledger whose spans fence at exit, met with
        the roofline model's per-phase expectations. Returns the
        schema-v5 ``"phases"`` dict, or None when the pass fails."""
        ip = self.ip
        t0 = time.perf_counter()
        try:
            with _phases.profiling() as led, \
                    self.prof.span(f"phase:{name}"):
                fn(*args)
                self.sync()
        except Exception as exc:
            sys.stderr.write(
                f"#! phase attribution failed for {name}: {exc!r}\n")
            return None
        total = time.perf_counter() - t0
        peaks, src = self._peaks()
        model = _rl.phase_model(
            OP_CLASS.get(_algo_of(self.name)), ip.M, ip.N, ip.NB,
            _itemsize(ip.prec), lookahead=self.pipeline["sweep.lookahead"],
            agg_depth=self.pipeline["qr.agg_depth"], nrhs=ip.K,
            peaks=peaks, grid=(ip.P, ip.Q))
        spans = _rl.attribute_phases(led, model, peaks)
        ssum = led.total()
        return {"attributed_run_s": total, "sum_s": ssum,
                "coverage": (ssum / total) if total > 0 else None,
                "peaks_source": src, "spans": spans}

    def _devprof_attribution(self, name, best, cap):
        """``--devprof``: attribute the captured timeline of the best
        run (or a synthetic one) with the schedule and the comm model
        of this driver's op, priced with the ring gate the cyclic
        kernels consult (``cyclic._cyclic_ring``). Returns the
        ``"devprof"`` entry, or None when the attribution fails: that
        is a flight event and a line on stderr, never a failed run."""
        from dplasma_tpu_torch.observability import devprof as _dp
        ip, tel = self.ip, self.telemetry
        op_cls, op_kt = _model_op_kt(_algo_of(self.name), ip)
        try:
            ring = False
            if op_cls is not None and ip.P * ip.Q > 1:
                from dplasma_tpu_torch.descriptors import Dist
                from dplasma_tpu_torch.parallel import cyclic as _cyc
                desc = _cyc.CyclicDesc(ip.M, ip.N, max(ip.MB, 1),
                                       max(ip.NB, 1), Dist(P=ip.P, Q=ip.Q))
                ring = _cyc._cyclic_ring(desc, ip.prec_dtype, self.mesh,
                                         need_row=(op_cls == "getrf"))
            entry = _dp.attribute(
                name, op_cls, best, (ip.P, ip.Q), ip.M, ip.N,
                max(ip.NB, 1), itemsize=_itemsize(ip.prec),
                kt=op_kt or None, ring=ring,
                lookahead=self.pipeline["sweep.lookahead"],
                peaks=self._peaks()[0], timeline=cap.events or None,
                backend=cap.used)
        except Exception as exc:
            if tel is not None:
                tel.flight.record("devprof_error", op=name, error=repr(exc))
            sys.stderr.write(f"#! devprof attribution failed for {name}: "
                             f"{exc!r}\n")
            return None
        if cap.note:
            entry["note"] = cap.note
        if entry["backend"] == "torch":
            entry["device_ops"] = _dp.device_ops(cap.events)
        self.report.add_devprof(entry)
        if tel is not None:
            for d in entry["diagnostics"]:
                tel.flight.record("devprof_diag", op=name, diag=d["kind"],
                                  target=d["op"])
            if not entry["ok"]:
                tel.flight.record(
                    "devprof_mismatch", op=name,
                    relation=entry["reconciliation"]["relation"])
        return entry

    def progress(self, fn: Callable, args: tuple, flops: float,
                 label: Optional[str] = None):
        """Warm up, run ``nruns`` timed, print the reference-format perf
        line; every harness phase lands in ``self.prof`` and one op
        entry in ``self.report``. Returns (output, gflops)."""
        ip, name = self.ip, label or self.name
        if ip.loud >= 2 and not self._pipe_printed:
            self._pipe_printed = True
            print("#+ pipeline: sweep.lookahead=%d qr.agg_depth=%d "
                  "panel.qr=%s panel.lu=%s"
                  % (self.pipeline["sweep.lookahead"],
                     self.pipeline["qr.agg_depth"],
                     self.pipeline["panel.qr"], self.pipeline["panel.lu"]))
        tel = self.telemetry
        if tel is not None:
            tel.flight.record("op_start", op=name, flops=flops)
        # ENQ: nothing traces or compiles here, the span is empty
        t = time.time_ns()
        self.prof.add_event(f"enq:{name}", t, t)
        warm = None
        if ip.warmup:
            with self.prof.span(f"warmup:{name}"):
                _, warm, _ = self._timed(fn, args)
        times = []
        launches = {lab: [] for lab, _ in KERNELS}
        kw_steps = []
        out = None
        trace_cm = _trace_guard(ip.jaxtrace) if ip.jaxtrace \
            else contextlib.nullcontext()
        # --devprof: the device-timeline capture around the same window,
        # each run in a range of its own (the best run's ops are kept)
        dp_cap = None
        if ip.devprof:
            from dplasma_tpu_torch.observability import devprof as _dp
            dp_cap = _dp.DevprofCapture(device=self.device,
                                        grid=(ip.P, ip.Q))
        with trace_cm, (dp_cap or contextlib.nullcontext()):
            for i in range(max(ip.nruns, 1)):
                with self.prof.span(f"run[{i}]:{name}", flops=flops,
                                    track=self.prof.TRACK_RUN), \
                        (dp_cap.run(i) if dp_cap is not None
                         else contextlib.nullcontext()):
                    out, secs, n = self._timed(fn, args)
                times.append(secs)
                for lab in launches:
                    launches[lab].append(n[lab])
                kw_steps.append(n["kw_steps"])
        best = min(times)
        if dp_cap is not None:
            dp_cap.select(times.index(best))
        gflops = (flops / 1e9) / best
        enq = dest = 0.0
        total = enq + best + dest
        want_attrib = bool(ip.report or ip.phase_profile)
        comm = self._comm_model() if want_attrib else None
        # the attributed pass runs AFTER the timed loop, so the stats
        # above come from the fence-free path
        phase_info = (self._phase_attribution(fn, args, name)
                      if ip.phase_profile else None)
        entry = self.report.add_op(
            name, prec=ip.prec, flops=flops, enq_s=enq, warmup_s=warm,
            dest_s=dest, runs_s=times, gflops=gflops, xla=None,
            comm=comm, dag=None, phases=phase_info)
        if tel is not None:
            tel.flight.record("op_done", op=name, best_s=best,
                              gflops=gflops, nruns=len(times))
        rl_entry = None
        if want_attrib:
            peaks, src = self._peaks()
            rl_entry = self.report.add_roofline(_rl.op_roofline(
                name, OP_CLASS.get(_algo_of(self.name)), ip.M, ip.N,
                ip.K, _itemsize(ip.prec), flops, comm, best, peaks, src))
        dp_entry = (self._devprof_attribution(name, best, dp_cap)
                    if dp_cap is not None else None)
        stats = entry["timings"]
        reg = self.report.metrics
        lbl = dict(op=name, prec=ip.prec)
        reg.counter("runs_total", **lbl).inc(len(times))
        hist = reg.histogram("run_seconds", **lbl)
        for t_ in times:
            hist.observe(t_)
        reg.gauge("gflops_best", **lbl).set(gflops)
        reg.gauge("enq_seconds", **lbl).set(enq)
        reg.gauge("model_flops", **lbl).set(flops)
        if comm and comm.get("dag_model"):
            reg.gauge("comm_bytes_dag_model", **lbl).set(
                comm["dag_model"]["bytes_total"])
        if rl_entry is not None and rl_entry["achieved_frac"] is not None:
            reg.gauge("roofline_achieved_frac", **lbl).set(
                rl_entry["achieved_frac"])
        if phase_info is not None:
            for sp in phase_info["spans"]:
                reg.gauge("phase_seconds", phase=sp["phase"],
                          **lbl).set(sp["measured_s"])
        if dp_entry is not None:
            dp_fracs = [c["achieved_frac"] for c in dp_entry["collectives"]
                        if c["achieved_frac"] is not None]
            if dp_fracs:
                reg.gauge("devprof_ici_achieved_frac", **lbl).set(
                    min(dp_fracs))
            reg.gauge("devprof_skew", **lbl).set(dp_entry["skew"]["value"])
            for c, v in dp_entry["categories"].items():
                reg.gauge("devprof_seconds", category=c, **lbl).set(v)
        self.prof.save_dinfo(f"GFLOPS:{name}", gflops)
        self.record["ops"].append({
            "op": name, "flops": flops, "warmup_s": warm, "runs_s": times,
            "best_s": best, "gflops": gflops,
            **{f"{lab}_launches": n for lab, n in launches.items()},
            "kw_steps": kw_steps, "phases": phase_info,
            "roofline": rl_entry, "devprof": dp_entry})
        if ip.loud >= 2:
            print(f"#+ kernels[{name}]: " + ", ".join(
                f"{lab.upper()} launches per run = {n}"
                for lab, n in launches.items())
                + f", KW steps per run = {kw_steps}")
            for i, t_ in enumerate(times):
                print(f"#+ run {i}: {t_:12.5f} s : "
                      f"{(flops / 1e9) / t_:14f} gflops")
            if len(times) > 1:
                print("#+ runs %d : min/median/max %g/%g/%g s stddev %g"
                      % (len(times), stats["min_s"], stats["median_s"],
                         stats["max_s"], stats["stddev_s"]))
            if rl_entry is not None:
                print("#+ roofline[%s]: bound=%s expected %.5g s "
                      "measured %.5g s achieved %s (peaks: %s)"
                      % (name, rl_entry["bound"], rl_entry["expected_s"],
                         best, _pct(rl_entry["achieved_frac"]),
                         rl_entry["peaks_source"]))
            if dp_entry is not None:
                dps = dp_entry["skew"]
                print("#+ devprof[%s]: backend=%s coverage %s relation=%s "
                      "skew %.3f (slowest rank %d: %s) critical-path %s"
                      % (name, dp_entry["backend"],
                         _pct(dp_entry["coverage"]),
                         dp_entry["reconciliation"]["relation"],
                         dps["value"], dps["slowest_rank"],
                         dps["dominating_category"],
                         _pct(dp_entry["critical_path"]["frac"])))
                for c in dp_entry["collectives"]:
                    print("#+   %-16s n=%3s measured %10.5f s achieved "
                          "%7s of ICI peak"
                          % (c["cls"], c["count"], c["measured_s"],
                             _pct(c["achieved_frac"])))
            if phase_info is not None:
                print("#+ phases[%s]: attributed run %.5f s, spans %.5f s "
                      "(coverage %s)"
                      % (name, phase_info["attributed_run_s"],
                         phase_info["sum_s"],
                         _pct(phase_info["coverage"])))
                for sp in phase_info["spans"]:
                    print("#+   %-10s n=%3d measured %10.5f s expected "
                          "%10.5g s achieved %7s bound=%s"
                          % (sp["phase"], sp["count"], sp["measured_s"],
                             sp["expected_s"], _pct(sp["achieved_frac"]),
                             sp["bound"]))
        if dp_entry is not None and not dp_entry["ok"] and ip.loud >= 1:
            # a priced collective the timeline lost is worth a line at
            # the default loudness
            for d in dp_entry["diagnostics"]:
                if d["kind"] in ("missing-collective", "count-mismatch"):
                    print(f"#! devprof[{name}]: {d['message']}")
        print("[****] TIME(s) %12.5f : %s\tPxQxg= %3d %-3d %d NB= %4d "
              "N= %7d : %14f gflops - ENQ&PROG&DEST %12.5f : %14f gflops"
              " - ENQ %12.5f - DEST %12.5f"
              % (best, name, ip.P, ip.Q, ip.gpus, ip.NB, ip.N,
                 gflops, total, (flops / 1e9) / total, enq, dest))
        sys.stdout.flush()
        return out, gflops

    def report_refine(self, summary: dict) -> dict:
        """Record one mixed-precision IR solve (``ops.refine.summarize``)
        in the record's and the run-report's ``"refine"`` lists and the
        refine_* metrics, and at -v >= 2 print the ``#+ refine[op]:``
        line."""
        self.record["refine"].append(summary)
        self.report.add_refine(summary)
        reg = self.report.metrics
        lbl = dict(op=summary.get("op", self.name), prec=self.ip.prec)
        reg.gauge("refine_iterations", **lbl).set(
            summary.get("iterations", 0))
        reg.counter("refine_escalations_total", **lbl).inc(
            1 if summary.get("escalated") else 0)
        hist = summary.get("backward_errors") or []
        if hist:
            reg.gauge("refine_backward_error", **lbl).set(hist[-1])
        if summary.get("quant_guard_max") is not None:
            reg.gauge("quant_guard_max", **lbl).set(
                summary["quant_guard_max"])
        if self.ip.loud >= 2:
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
        self.report.add_check(what, res, passed)
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
