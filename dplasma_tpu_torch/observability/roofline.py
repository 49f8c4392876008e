"""Roofline efficiency ledger: expected-time-per-phase from analytic
models against probed hardware peaks
(``dplasma_tpu/observability/roofline.py``).

The roofline model (Williams et al., CACM 2009) bounds the time of a
computation from below by its heaviest resource demand: flops against
the matrix rate (``mxu``: the tensor-core or FP64 rate of the run's
type on the card), bytes against HBM bandwidth, bytes between ranks
against the ``ici`` rate (on the one-card virtual mesh a transfer is a
device copy), host<->device bytes against the pinned-copy rate, and
launch count against per-launch latency. The analytic flops (LAWN-41
via ``RunReport.add_op(model_flops=)``) and the comm-volume model
(:mod:`dplasma_tpu_torch.observability.comm`) meet measured time here:

* :func:`resolve_peaks` — peaks from a ``--peaks-file`` (a JSON doc
  with a ``peaks`` section, a run-report carrying ``extra.peaks``, or a
  raw peaks dict; ``chip_smoke.py`` phase 19 writes one from the
  rates it probes on the card) or the conservative built-in defaults;
* :func:`expected_seconds` — the roofline lower bound + the binding
  resource label (``bound ∈ {mxu, hbm, ici, latency}``);
* :func:`phase_model` — per-phase flop/byte/dispatch demands of the
  factorization sweeps, simulated over the *same control flow* as
  :func:`dplasma_tpu_torch.ops._sweep.pipelined_sweep` (and the
  left-looking potrf), so the expected split matches what the engine
  ran;
* :func:`attribute_phases` / :func:`op_roofline` — join measured
  (phase ledger / timed loop) with expected into the run-report's
  schema-v5 ``"phases"`` and ``"roofline"`` sections, each with an
  ``achieved_frac = expected_s / measured_s`` (1.0 = running at the
  roofline; small = unexplained gap).

Every expectation is a *lower bound* (touch-each-operand-once bytes,
peak-rate flops), so ``achieved_frac`` lands in (0, 1] on honest
peaks; a value far below 1 names the phase to go dig into, a value
above 1 a priced count or a peak that is wrong.

The rate of d and z (:func:`_mxu_key`): the reference prices both at
``f64equiv_bound_gflops``, the limb route's bound, because its d runs
took that route on the TPU. On the card the default d and z path is
native FP64 (MCA ``dd_gemm=auto``), so here d and z take the probed
native rate ``f64_gflops`` when the dd route is not active, and the
reference's ``f64equiv_bound_gflops`` when it is (``dd_gemm=always``),
where the pricing is the reference's and the parity tests hold it
there. The IR solvers' ``residual`` always runs the limb route
(``kernels.dd.gemm_residual``): off the dd route it is priced at
``f64equiv_bound_gflops`` when the peaks carry it.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

#: conservative built-in peaks (used when no --peaks-file / bench peaks
#: are available — e.g. CPU CI runs). Deliberately modest: an inflated
#: peak would understate achieved_frac everywhere, a conservative one
#: only compresses the range. Override from a bench report for real
#: attribution on hardware.
DEFAULT_PEAKS = {
    "mxu_gflops": 200.0,   # sustained matmul rate
    "hbm_gbps": 50.0,      # main-memory streaming bandwidth
    "ici_gbps": 10.0,      # cross-chip interconnect bandwidth
    "host_gbps": 5.0,      # host<->HBM (PCIe) streaming bandwidth
    "latency_us": 50.0,    # per-dispatch overhead
}

#: resource labels, in tie-break precedence order
BOUNDS = ("mxu", "hbm", "ici", "host", "latency")

#: peaks-dict key per precision letter on the dd route (the
#: reference's table): the K1 3xTF32 rate and the limb route's
#: f64-equivalent bound
_BENCH_MXU_KEY = {"s": "f32_highest_gflops", "c": "f32_highest_gflops",
                  "d": "f64equiv_bound_gflops",
                  "z": "f64equiv_bound_gflops"}

#: the d and z key off the dd route: the probed native FP64 rate
_NATIVE_F64_KEY = "f64_gflops"

#: probed per-precision rates carried alongside the canonical keys so
#: the mixed-precision IR phase pricing can rate each phase at ITS
#: precision's peak (resolve_peaks keeps them when the source has them)
_AUX_RATE_KEYS = ("f32_highest_gflops", "bf16_gflops", "int8_gops",
                  "f64equiv_bound_gflops", "f32x2_gflops",
                  _NATIVE_F64_KEY)

#: rate resolution for the IR working precisions: the probed peaks key
#: when the source carries it, else a multiple of the run precision's
#: ``mxu_gflops`` (native FP64 on a d run off the dd route). The ratios
#: are the card's, not the reference's (whose come from TPU peaks):
#: chip_smoke.py phase 19 on an NVIDIA H100 80GB HBM3 at 700 W probed
#: int8 927.5–971.5 TOP/s, bf16 756.2–775.2, K1 3xTF32 70.7–71.1 and
#: FP64 63.4–63.7 TFLOP/s at 8192³ in two runs, so int8, bf16 and f32
#: are those rates over FP64's, rounded down below both runs; f32x2
#: (not probed) is f32's times the reference's 2/3 for the rung's extra
#: refinement step. Every probed key in a peaks file wins over its
#: ratio.
WP_MXU = {"int8": ("int8_gops", 14.0),
          "bf16": ("bf16_gflops", 11.0),
          "f32": ("f32_highest_gflops", 1.1),
          "f32x2": ("f32x2_gflops", 0.73)}

#: op classes of the mixed-precision iterative-refinement solvers
REFINE_CLASSES = ("posv_ir", "gesv_ir", "gels_ir")


def wp_mxu_gflops(peaks: Optional[dict], precision: str) -> float:
    """MXU rate (GFlop/s) of an IR working precision: the probed key
    from the peaks dict when present, else the conservative ratio of
    ``mxu_gflops`` — always strictly above the dd rate, so a factor
    phase priced here expects strictly less time than the dd route
    for the same flops."""
    p = peaks or DEFAULT_PEAKS
    key, ratio = WP_MXU.get(precision, WP_MXU["f32"])
    v = p.get(key)
    if isinstance(v, (int, float)) and v > 0:
        return float(v)
    return ratio * float(p["mxu_gflops"])


def _dd_route() -> bool:
    """Is the f64-equivalent limb route active (MCA ``dd_gemm``)?"""
    import torch

    from dplasma_tpu_torch.kernels import blas as _blas
    return _blas._dd_active(torch.float64)


def _mxu_key(prec: str) -> str:
    """The probed rate a run of precision ``prec`` is priced at: the
    reference's :data:`_BENCH_MXU_KEY`, but native FP64 for d and z
    off the dd route (module docstring)."""
    if prec in ("d", "z") and not _dd_route():
        return _NATIVE_F64_KEY
    return _BENCH_MXU_KEY.get(prec, "f32_highest_gflops")


def resolve_peaks(path: Optional[str] = None,
                  prec: str = "s") -> Tuple[dict, str]:
    """Resolve the peaks dict: ``(peaks, source)``.

    ``path`` may be a run-report (peaks under ``extra.peaks``), a JSON
    doc with a top-level ``peaks``, or a raw peaks dict with the
    canonical keys. Missing figures keep the conservative defaults; the
    matrix rate maps per precision from the probed peaks
    (:func:`_mxu_key`) when no explicit ``mxu_gflops`` is given. No
    path → :data:`DEFAULT_PEAKS`.
    """
    peaks = dict(DEFAULT_PEAKS)
    if not path:
        return peaks, "default"
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a JSON object")
    raw = doc.get("peaks") or (doc.get("extra") or {}).get("peaks") \
        or doc
    if not isinstance(raw, dict):
        # e.g. {"peaks": [..]} — a ValueError keeps the driver's
        # degrade-to-defaults contract (Driver._peaks catches it)
        raise ValueError(f"{path}: peaks section is not a JSON object")
    for key in DEFAULT_PEAKS:
        if isinstance(raw.get(key), (int, float)):
            peaks[key] = float(raw[key])
    for key in _AUX_RATE_KEYS:
        if isinstance(raw.get(key), (int, float)):
            peaks[key] = float(raw[key])
    if not isinstance(raw.get("mxu_gflops"), (int, float)):
        probed = raw.get(_mxu_key(prec))
        if isinstance(probed, (int, float)) and probed > 0:
            peaks["mxu_gflops"] = float(probed)
    return peaks, f"file:{path}"


def expected_seconds(flops: float = 0.0, hbm_bytes: float = 0.0,
                     ici_bytes: float = 0.0, dispatches: int = 0,
                     peaks: Optional[dict] = None,
                     host_bytes: float = 0.0):
    """Roofline lower bound for one phase/op.

    Returns ``(expected_s, bound, components_s)`` where ``bound`` names
    the binding resource and ``components_s`` carries every resource's
    individual bound (so a report reader sees how close the runner-up
    is).  ``host_bytes`` is host<->HBM (PCIe) traffic — the lowmem
    tiers' streamed bytes, priced by memcheck's streaming simulator —
    so an out-of-core phase can attribute as ``host``-bound."""
    p = peaks or DEFAULT_PEAKS
    comp = {
        "mxu": flops / (p["mxu_gflops"] * 1e9),
        "hbm": hbm_bytes / (p["hbm_gbps"] * 1e9),
        "ici": ici_bytes / (p["ici_gbps"] * 1e9),
        "host": host_bytes / (p.get("host_gbps",
                                    DEFAULT_PEAKS["host_gbps"]) * 1e9),
        "latency": dispatches * p["latency_us"] * 1e-6,
    }
    bound = max(BOUNDS, key=lambda b: comp[b])
    return comp[bound], bound, comp


# ---------------------------------------------------------------------
# Analytic per-phase demand model of the factorization sweeps
# ---------------------------------------------------------------------

def _apply_cost(op_class: str, m: int, w: int, nb: int, d: int,
                itemsize: int):
    """Flops/bytes of applying ``d`` aggregated panels (rank d·nb) to
    an ``m x w`` block: LU = triangular solve + Schur product, QR =
    compact-WY (two tall products + the T application)."""
    r = d * nb
    fl = (4.0 if op_class == "geqrf" else 2.0) * m * r * w
    by = (2.0 * m * w + d * (m * nb + nb * w)) * itemsize
    return fl, by


def _panel_cost(op_class: str, m: int, nb: int, itemsize: int,
                panel_kernel: str = "chain"):
    """Per-panel demand of the panel-factorization engine's kernels.

    ``chain``/``rec``/``pallas`` carry the factorization's own flops
    (the rec panel reorganizes the SAME math into trsm/matmul levels;
    a lower bound either way). The ``tree`` QR panel genuinely does
    more arithmetic — leaf QRs + the push-down products + the TSQR-HR
    reconstruction (LU + two triangular solves + the T solve), ~3x
    the chain's 2·m·nb² — all of it matmul-shaped, which is the
    point: the chain's latency-bound dispatch ladder becomes
    MXU-bound work, and the priced bound shifts with it."""
    fl = (2.0 if op_class == "geqrf" else 1.0) * m * nb * nb
    by = 2.0 * m * nb * itemsize
    if op_class == "geqrf" and panel_kernel == "tree":
        # leaves ~2mnb² + push-down ~2mnb² + reconstruction (V2
        # solve + T solve + packing) ~2mnb²; streams the panel ~3x
        fl, by = 3.0 * fl, 3.0 * by
    return fl, by


def refine_phase_model(op_class: str, M: int, N: int, nrhs: int,
                       itemsize: int, precision: str,
                       peaks: Optional[dict] = None
                       ) -> Dict[str, dict]:
    """Per-phase demands of the mixed-precision IR solvers
    (:mod:`dplasma_tpu_torch.ops.refine`): the O(n³) ``factor`` and the
    per-iteration ``solve``/``correct`` triangular sweeps priced at
    the WORKING-precision MXU rate (f32 storage bytes), the
    per-iteration ``residual`` at the dd f64-equivalent rate
    (``peaks["mxu_gflops"]`` on a d-precision run) with f64 bytes.
    ``solve``/``residual``/``correct`` are per-dispatch demands
    (``per_count``): :func:`attribute_phases` scales them by the
    measured span count, so the expectation tracks the iterations the
    engine actually ran rather than a guessed budget.

    The ``int8`` rung prices the factor at the probed ``int8_gops``
    MXU peak (counting the same f32-equivalent flops — the int8 rate
    strictly dominates, so the expectation stays a lower bound) and
    adds the quantize/dequantize byte streams the block-scaled
    trailing updates emit (:mod:`dplasma_tpu_torch.kernels.quant`): the
    quantize span reads the f32 operands and writes int8 tiles +
    scales (>= one full-matrix pass, 4+1 bytes/elt), the dequantize
    span reads the int32 partials and writes the f32 accumulation
    (>= one full-matrix pass, 4+4 bytes/elt) — aggregate HBM
    lower bounds, judged against the spans' summed self time."""
    wp = wp_mxu_gflops(peaks, precision)
    n3 = float(N) ** 3
    if op_class == "posv_ir":
        fac = n3 / 3.0
    elif op_class == "gesv_ir":
        fac = 2.0 * n3 / 3.0
    else:   # gels_ir: QR of the M x N operand
        fac = 2.0 * float(M) * N * N - 2.0 * n3 / 3.0
    # one correction solve: two triangular sweeps against the cached
    # factor (gels' semi-normal solves are two N x N sweeps too)
    solve_fl = 2.0 * float(N) * N * nrhs
    # one residual r = b - A x (gels adds the A^T r projection)
    resid_fl = (2.0 if op_class != "gels_ir" else 4.0) \
        * float(M) * N * nrhs
    wp_item = 4.0   # the working factor/operands live in f32 storage
    resid = {"flops": resid_fl,
             "hbm_bytes": (float(M) * N + 2.0 * M * nrhs) * itemsize,
             "per_count": True}
    limb = (peaks or {}).get("f64equiv_bound_gflops")
    if isinstance(limb, (int, float)) and limb > 0 and not _dd_route():
        # the residual is a limb product whatever dd_gemm says, while
        # mxu_gflops is the native FP64 rate off the dd route
        resid["mxu_gflops"] = float(limb)
    out = {
        # inclusive: the factor span ENCLOSES the inner factorization
        # sweep (whose panel/lookahead/... child spans hold the work),
        # so its n^3 demand must be judged against the inclusive wall
        # time, not the thin self-time wrapper
        "factor": {"flops": fac, "hbm_bytes": float(M) * N * wp_item,
                   "mxu_gflops": wp, "inclusive": True},
        "solve": {"flops": solve_fl, "mxu_gflops": wp,
                  "hbm_bytes": (float(N) * N
                                + 2.0 * N * nrhs) * wp_item,
                  "per_count": True},
        "correct": {"flops": solve_fl, "mxu_gflops": wp,
                    "hbm_bytes": (float(N) * N
                                  + 2.0 * N * nrhs) * wp_item,
                    "per_count": True},
        "residual": resid,
    }
    if precision == "int8":
        # block-scaled quantization streams of the int8 trailing
        # updates (kernels.quant): aggregate >= one full-matrix pass
        out["quantize"] = {"hbm_bytes": float(M) * N * (4.0 + 1.0)}
        out["dequantize"] = {"hbm_bytes": float(M) * N * (4.0 + 4.0)}
    return out


def ring_phase_demand(op_class: str, M: int, N: int, nb: int,
                      itemsize: int,
                      grid: Tuple[int, int]) -> Optional[dict]:
    """The ``ring`` span's demand: the PANEL-BROADCAST wire bytes of
    the cyclic kernel on this grid — exactly the transfers the
    wrappers' probe (``cyclic._panel_bcast_probe``) runs, priced from
    :func:`dplasma_tpu_torch.parallel.cyclic.spmd_comm_model` — so the
    measured seconds of the ``ring`` span meet the roofline ``ici``
    component. The RING pricing is used
    unconditionally: at ``(n-1)/n`` of the payload it never exceeds
    the masked psum's ``2(n-1)/n``, so it lower-bounds the probe's
    transfer whichever schedule the live gate resolved."""
    P, Q = int(grid[0]), int(grid[1])
    if Q <= 1 or op_class not in ("potrf", "getrf", "geqrf") \
            or nb <= 0:
        return None
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.parallel.cyclic import (CyclicDesc,
                                                   spmd_comm_model)
    desc = CyclicDesc(M, N, nb, nb, Dist(P=P, Q=Q))
    model = spmd_comm_model(desc, op_class, itemsize, ring=True)
    ici = sum(v for k, v in model["bytes_by_collective"].items()
              if "panel" in k and "bcast" in k)
    return {"ici_bytes": float(ici)}


def stream_phase_demand(streamed_bytes: float) -> Optional[dict]:
    """A streaming (lowmem/out-of-core) span's demand: the host<->HBM
    bytes of the sweep (the lowmem tiers' schedule sums), attributed
    through the roofline ``host`` bound — the component that makes
    ``bound == "host"`` (a PCIe-bound phase) reachable."""
    if not streamed_bytes or streamed_bytes <= 0:
        return None
    return {"host_bytes": float(streamed_bytes)}


def phase_model(op_class: Optional[str], M: int, N: int, nb: int,
                itemsize: int, lookahead: int = 1,
                agg_depth: int = 1, nrhs: int = 1,
                peaks: Optional[dict] = None,
                panel_kernel: Optional[str] = None,
                grid: Optional[Tuple[int, int]] = None
                ) -> Optional[Dict[str, list]]:
    """Per-phase ``{name: [flops, hbm_bytes, dispatches]}`` demands.

    Mirrors the control flow of :func:`dplasma_tpu_torch.ops._sweep.
    pipelined_sweep` (right-looking ``getrf``/``geqrf``) and the
    left-looking ``potrf`` column sweep, at the same (lookahead,
    agg_depth) shape — phase names match the spans the instrumented
    code emits (``panel`` / ``lookahead`` / ``far_flush`` / ``catchup``
    / ``assemble``). The total flops across phases is invariant in the
    pipeline shape (the split moves work between phases, never creates
    it). The mixed-precision IR op classes route to
    :func:`refine_phase_model` (dict-valued demands carrying per-phase
    MXU-rate overrides), with the working precision resolved from the
    live MCA ``ir.*`` configuration — the same source the solver
    reads. A multi-rank ``grid`` adds the ``ring`` entry
    (:func:`ring_phase_demand`) — the ICI-bytes demand of the cyclic
    wrappers' panel-broadcast span. Unmodelled op classes return
    None.
    """
    ring_extra = None
    if grid is not None and op_class is not None:
        ring_extra = ring_phase_demand(op_class, M, N, nb, itemsize,
                                       grid)
    if op_class in REFINE_CLASSES:
        from dplasma_tpu_torch.ops import refine as _refine
        prec_w, _, _ = _refine.ir_params()
        return refine_phase_model(op_class, M, N, max(int(nrhs), 1),
                                  itemsize, prec_w, peaks)
    if op_class not in ("getrf", "geqrf", "potrf") or nb <= 0:
        return None
    if panel_kernel is None and op_class in ("getrf", "geqrf"):
        # resolve from the live MCA config — the same source the
        # sweep's panel callback reads
        from dplasma_tpu_torch.kernels import panels as _panels
        panel_kernel = _panels.panel_kernel(
            "qr" if op_class == "geqrf" else "lu")
    pker = panel_kernel or "chain"
    la = max(int(lookahead), 0)
    agg = max(int(agg_depth), 1) if op_class == "geqrf" else 1
    MT, NT = -(-M // nb), -(-N // nb)
    KT = min(MT, NT)
    Mp = MT * nb

    acc: Dict[str, list] = {}

    def add(phase, fl, by, n=1):
        a = acc.setdefault(phase, [0.0, 0.0, 0])
        a[0] += fl
        a[1] += by
        a[2] += n

    if op_class == "potrf":
        # left-looking: column kk accumulates panels 0..kk-1 (la
        # freshest narrow, older folded into one wide product), then
        # factors its own panel
        for kk in range(KT):
            m = Mp - kk * nb
            fresh_from = max(kk - la, 0) if la > 0 else 0
            if fresh_from > 0:
                add("far_flush",
                    *_apply_cost("potrf", m, nb, nb, fresh_from,
                                 itemsize))
            for _ in range(fresh_from, kk):
                add("lookahead",
                    *_apply_cost("potrf", m, nb, nb, 1, itemsize))
            add("panel", *_panel_cost("potrf", m, nb, itemsize))
        add("assemble", 0.0, 2.0 * Mp * Mp * itemsize)
        if ring_extra is not None:
            acc["ring"] = ring_extra
        return acc

    # right-looking engine simulation (mirrors pipelined_sweep /
    # _sweep.dag_pipelined)
    pending: list = []
    ahead: list = []
    farq = list(range(NT))

    def peel():
        c = farq.pop(0)
        if pending:
            fl = by = 0.0
            for s in pending:
                f, b = _apply_cost(op_class, Mp - s * nb, nb, nb, 1,
                                   itemsize)
                fl += f
                by += b
            add("catchup", fl, by)
        return c

    for _ in range(min(1 + la, NT)):
        ahead.append(peel())

    for kk in range(KT):
        ahead.pop(0)
        m = Mp - kk * nb
        pk_k = pker
        if pk_k == "pallas" and op_class == "geqrf":
            # the fused pallas QR panel (K4) is f32-only and gated
            # PER SHAPE: panels the gate rejects (non-f32 routes,
            # tall early panels) execute the tree fallback — price
            # what each panel actually runs
            from dplasma_tpu_torch.kernels.pallas_qr import eligible_shape
            if not eligible_shape(m, nb, itemsize):
                pk_k = "tree"
        add("panel", *_panel_cost(op_class, m, nb, itemsize, pk_k))
        pending.append(kk)
        if ahead:
            fl = by = 0.0
            for _ in ahead:
                f, b = _apply_cost(op_class, m, nb, nb, 1, itemsize)
                fl += f
                by += b
            add("lookahead", fl, by)
        if len(pending) >= agg or kk == KT - 1:
            if farq:
                w = len(farq) * nb
                if agg > 1 and len(pending) > 1:
                    add("far_flush",
                        *_apply_cost(op_class, Mp - pending[0] * nb, w,
                                     nb, len(pending), itemsize))
                else:
                    for s in pending:
                        add("far_flush",
                            *_apply_cost(op_class, Mp - s * nb, w, nb,
                                         1, itemsize))
            pending.clear()
        while len(ahead) < 1 + la and farq:
            ahead.append(peel())

    add("assemble", 0.0, 2.0 * Mp * NT * nb * itemsize)
    if ring_extra is not None:
        acc["ring"] = ring_extra
    return acc


# ---------------------------------------------------------------------
# Joins: measured x expected -> report sections
# ---------------------------------------------------------------------

def attribute_phases(ledger, model: Optional[dict],
                     peaks: Optional[dict] = None) -> list:
    """Join a :class:`~dplasma_tpu_torch.observability.phases.PhaseLedger`
    with the analytic demand model into the schema-v5 per-phase rows
    ``{phase, count, measured_s, expected_s, achieved_frac, bound}``.

    Phases the model doesn't know get a latency-only expectation (the
    dispatch count is still a real lower bound), so every measured
    span carries a bound label. A dict-valued demand
    (:func:`refine_phase_model`) may scale per measured dispatch
    (``per_count``), override the MXU rate (``mxu_gflops`` — how
    the IR factor phase gets priced at the WORKING-precision peak
    while the residual stays at the dd rate), carry an ``ici_bytes``
    demand (the ``ring`` span of the cyclic kernels — the component
    that makes ``bound == "ici"`` reachable in the phase table; it
    never was before this join passed ICI bytes through), carry a
    ``host_bytes`` demand (:func:`stream_phase_demand` — the lowmem
    tiers' PCIe streaming, making ``bound == "host"`` reachable), and
    declare
    itself ``inclusive``: its demand covers the whole region
    INCLUDING enclosed child spans (the IR ``factor`` span wraps the
    inner factorization sweep, whose panel/lookahead/... spans carry
    the actual work), so achieved_frac divides by the ledger's
    inclusive ``total_s`` instead of the self ``measured_s``."""
    out = []
    for row in ledger.summary():
        name, meas = row["phase"], row["measured_s"]
        demand = (model or {}).get(name)
        if isinstance(demand, dict):
            scale = row["count"] if demand.get("per_count") else 1
            pk = dict(peaks or DEFAULT_PEAKS)
            if demand.get("mxu_gflops"):
                pk["mxu_gflops"] = demand["mxu_gflops"]
            exp, bound, _ = expected_seconds(
                flops=demand.get("flops", 0.0) * scale,
                hbm_bytes=demand.get("hbm_bytes", 0.0) * scale,
                ici_bytes=demand.get("ici_bytes", 0.0) * scale,
                dispatches=row["count"], peaks=pk,
                host_bytes=demand.get("host_bytes", 0.0) * scale)
            if demand.get("inclusive"):
                meas = row.get("total_s", meas)
        elif demand is not None:
            exp, bound, _ = expected_seconds(
                flops=demand[0], hbm_bytes=demand[1],
                dispatches=row["count"], peaks=peaks)
        else:
            exp, bound, _ = expected_seconds(
                dispatches=row["count"], peaks=peaks)
        out.append({"phase": name, "count": row["count"],
                    "measured_s": meas, "expected_s": exp,
                    "achieved_frac": (exp / meas) if meas > 0 else None,
                    "bound": bound})
    return out


def op_roofline(label: str, op_class: Optional[str], M: int, N: int,
                K: int, itemsize: int, model_flops: float,
                comm: Optional[dict], measured_s: float,
                peaks: Optional[dict] = None,
                peaks_source: str = "default") -> dict:
    """Whole-op roofline entry for the report's ``"roofline"`` section.

    HBM bytes are the touch-each-operand-once lower bound; ICI bytes
    come from the analytic comm model when present (max of the DAG and
    SPMD pricings — either is a valid lower bound on what crossed the
    wire)."""
    hbm = float(M * N + M * K + K * N) * itemsize
    ici = 0.0
    for mdl in ("dag_model", "spmd_model"):
        m = (comm or {}).get(mdl) or {}
        b = m.get("bytes_total")
        if isinstance(b, (int, float)):
            ici = max(ici, float(b))
    exp, bound, comp = expected_seconds(
        flops=model_flops, hbm_bytes=hbm, ici_bytes=ici, dispatches=1,
        peaks=peaks)
    return {"op": label, "op_class": op_class,
            "expected_s": exp, "measured_s": measured_s,
            "achieved_frac": (exp / measured_s) if measured_s > 0
            else None,
            "bound": bound, "components_s": comp,
            "peaks": dict(peaks or DEFAULT_PEAKS),
            "peaks_source": peaks_source}
