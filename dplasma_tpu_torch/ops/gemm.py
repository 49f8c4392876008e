"""GEMM algorithm family with runtime dispatch.

Ports ``dplasma_tpu/ops/gemm.py`` (:56-193, :276-286). The reference's
surface is ``dplasma_zgemm_New_ex``, which picks one of three algorithms
(src/zgemm_wrapper.c:439-493):

(a) the owner-computes default: one product (``ops.blas3.gemm``);
(b) SUMMA with pipelined broadcasts when a process grid is active
    (:func:`gemm_summa`, on the port's virtual mesh: the ranks' blocks in
    lockstep, the panel broadcasts as masked psums between the steps);
(c) the footprint-paced blocked GEMM, chosen when the operands approach
    device memory (:func:`gemm_stream`), tunable through the info keys
    ``DPLASMA:GEMM:GPU:{B,C,D,LOOK_AHEAD}``.

:func:`plan_gemm` is the reference's memory model line for line;
:func:`device_memory_bytes` reads the card's total memory (the
counterpart of XLA's ``bytes_limit``) and gives the reference's 16 GiB
default on the CPU, so a plan made on the CPU is the reference's plan.

``gemm_stream`` keeps the reference's blocks and k-chunks: C advances in
(b·mb) × (c·nb) blocks, each accumulated over d·nb-deep k-chunks (K
zero-padded to whole chunks), one ``kernels.blas.dot`` per chunk, so an
f32 chunk of at least 256 in every dimension is one K1 launch:
ceil(Mp / (b·mb)) · ceil(Np / (c·nb)) · ceil(Kp / (d·nb)) launches
(16 blocks × 8 chunks = 128 at M = N = K = 16384, mb = nb = 512 and
B = C = 8, D = 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.ops.blas3 import _op, gemm as gemm_dot
from dplasma_tpu_torch.parallel import mesh as pmesh
from dplasma_tpu_torch.utils import config

@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Chosen algorithm and blocking (the taskpool-constructor arguments
    the reference derives in dplasma_zgemm_gpu_new)."""

    algo: str                  # "dot" | "summa" | "stream"
    b: int = 0                 # C block rows, in tiles
    c: int = 0                 # C block cols, in tiles
    d: int = 0                 # k-chunk depth, in tiles
    look_ahead: int = 1


def device_memory_bytes(device=None, default_gb: float = 16.0) -> int:
    """The memory of ``device`` (default: the card): the card's total
    memory, or ``default_gb`` GiB on the CPU — the reference's default
    where its backend reports no ``bytes_limit``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(default_gb * 2**30)


def _footprint_bytes(M, N, K, dtype) -> int:
    return (M * K + K * N + M * N) * dtype.itemsize


def hbm_fraction() -> float:
    """MCA ``device.hbm_fraction`` (0.95 when malformed, as the
    reference reads it)."""
    try:
        return float(config.mca_get("device.hbm_fraction", "0.95"))
    except ValueError:
        return 0.95


def plan_gemm(C: TileMatrix, A: TileMatrix, B: TileMatrix,
              transa: str = "N", transb: str = "N",
              info: Optional[config.Info] = None,
              algo: str = "auto") -> GemmPlan:
    """Algorithm and blocking (zgemm_wrapper.c:439-493, memory model at
    :261-305): ``summa`` under an active grid, ``stream`` when the three
    operands exceed MCA ``device.hbm_fraction`` of C's device's memory,
    else ``dot``. The streamed blocking grows (b, c, d) one tile at a
    time while one block set fits a quarter of the device memory; the
    info keys override each."""
    info = info or config.Info()
    M, N = C.shape
    Ka = A.shape[1] if transa == "N" else A.shape[0]

    if algo == "auto":
        if pmesh.active() is not None:
            algo = "summa"
        elif _footprint_bytes(M, N, Ka, C.dtype) > hbm_fraction() * \
                device_memory_bytes(C.device):
            algo = "stream"
        else:
            algo = "dot"

    if algo != "stream":
        return GemmPlan(algo)

    mb, nb = C.desc.mb, C.desc.nb
    MT, NT = C.desc.MT, C.desc.NT
    KT = max(1, -(-Ka // nb))
    budget = 0.25 * device_memory_bytes(C.device)
    item = C.dtype.itemsize

    def fits(b, c, d):
        return (b * mb * c * nb + b * mb * d * nb + d * nb * c * nb) \
            * item <= budget

    b = c = d = 1
    grew = True
    while grew:
        grew = False
        for attr in ("b", "c", "d"):
            nb_, nc_, nd_ = b + (attr == "b"), c + (attr == "c"), \
                d + (attr == "d")
            if nb_ <= MT and nc_ <= NT and nd_ <= KT and \
                    fits(nb_, nc_, nd_):
                b, c, d = nb_, nc_, nd_
                grew = True
    b = info.get_int("DPLASMA:GEMM:GPU:B", b)
    c = info.get_int("DPLASMA:GEMM:GPU:C", c)
    d = info.get_int("DPLASMA:GEMM:GPU:D", d)
    la = info.get_int("DPLASMA:GEMM:GPU:LOOK_AHEAD",
                      config.mca_get_int("gemm.lookahead", 2))
    return GemmPlan("stream", b=min(b, MT), c=min(c, NT), d=min(d, KT),
                    look_ahead=max(1, la))


def gemm_stream(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
                transa: str = "N", transb: str = "N",
                plan: Optional[GemmPlan] = None,
                info: Optional[config.Info] = None) -> TileMatrix:
    """Footprint-paced blocked GEMM (the zgemm_NN_gpu analog): C block
    (bi, cj) accumulated over depth-d k-chunks, one ``blas.dot`` a
    chunk, then ``C_block = beta·C_block + alpha·acc``.

    ``plan.look_ahead`` is the reference's scan unroll: how many chunks
    its trace issues per step. Eager PyTorch has no trace to unroll; the
    chunk products go to the device in order on one stream, which runs
    behind the host by as many launches as its queue holds, so the port
    keeps ``look_ahead`` in the plan (and its info key) without effect
    on the schedule or the result."""
    if plan is None:
        plan = plan_gemm(C, A, B, transa, transb, info, algo="stream")
    mb, nb = C.desc.mb, C.desc.nb
    a = _op(A.zero_pad().data, transa)
    bm = _op(B.zero_pad().data, transb)
    Mp, Kp = a.shape
    Np = bm.shape[1]
    Cp = C.zero_pad()
    out = Cp.data * beta

    brow = plan.b * mb            # C block rows
    bcol = plan.c * nb            # C block cols
    kdep = plan.d * nb            # k chunk
    nk = -(-Kp // kdep)
    ktot = nk * kdep
    if ktot != Kp:                # whole chunks: the pad region is zeros
        a = torch.cat([a, a.new_zeros((Mp, ktot - Kp))], dim=1)
        bm = torch.cat([bm, bm.new_zeros((ktot - Kp, Np))], dim=0)

    for i0 in range(0, Mp, brow):
        i1 = min(i0 + brow, Mp)
        for j0 in range(0, Np, bcol):
            j1 = min(j0 + bcol, Np)
            acc = torch.zeros((i1 - i0, j1 - j0), dtype=C.dtype,
                              device=out.device)
            for t in range(nk):
                acc += k.dot(a[i0:i1, t * kdep:(t + 1) * kdep],
                             bm[t * kdep:(t + 1) * kdep, j0:j1])
            out[i0:i1, j0:j1] += alpha * acc
    return TileMatrix(out, Cp.desc).zero_pad()


def gemm_summa(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
               transa: str = "N", transb: str = "N",
               steps_per_panel: int | None = None) -> TileMatrix:
    """SUMMA over the active P×Q grid (gemm.py:195-274; the zgemm_summa
    JDF analog). Rank (p, q) holds the (p, q) contiguous block of op(A),
    op(B) and C. k advances in panels, each owned by one mesh column (of
    A) and one mesh row (of B); the owner's panel is broadcast along the
    other axis by the masked psum, and every rank adds one ``blas.dot``
    (K1 when enabled) a step. ``steps_per_panel`` (MCA
    ``gemm.summa_steps``, default 2) splits each owner's block into that
    many panels. Every extent is edge-padded to the mesh quantum (K to
    lcm(P, Q)·steps) with zeros and C is cropped back. Without an active
    grid: the one product, as in the reference."""
    from dplasma_tpu_torch.parallel import cyclic

    m = pmesh.active()
    if m is None:
        return gemm_dot(alpha, A, B, beta, C, transa, transb)
    cyclic._dd_guard(C.dtype)
    if steps_per_panel is None:
        steps_per_panel = config.mca_get_int("gemm.summa_steps", 2)
    Pn = m.shape[pmesh.ROW_AXIS]
    Qn = m.shape[pmesh.COL_AXIS]
    a = _op(A.zero_pad().data, transa)
    bmat = _op(B.zero_pad().data, transb)
    cmat = C.zero_pad().data
    Mp, Kp = a.shape
    Np = bmat.shape[1]
    lcm = Pn * Qn // math.gcd(Pn, Qn)
    quant = lcm * max(steps_per_panel, 1)
    Mp2 = -(-Mp // Pn) * Pn
    Np2 = -(-Np // Qn) * Qn
    Kp2 = -(-Kp // quant) * quant

    def pad(x, rows, cols):
        if tuple(x.shape) == (rows, cols):
            return x
        out = x.new_zeros((rows, cols))
        out[:x.shape[0], :x.shape[1]] = x
        return out

    a, bmat, cmat = pad(a, Mp2, Kp2), pad(bmat, Kp2, Np2), pad(cmat, Mp2, Np2)
    kb = Kp2 // quant
    nsteps = Kp2 // kb
    kq, kp = Kp2 // Qn, Kp2 // Pn
    mloc, nloc = Mp2 // Pn, Np2 // Qn
    ranks = [(p, q) for p in range(Pn) for q in range(Qn)]
    acc = {(p, q): cmat[p * mloc:(p + 1) * mloc, q * nloc:(q + 1) * nloc]
           * beta for p, q in ranks}
    for t in range(nsteps):
        # A panel: global k-cols [t*kb, (t+1)*kb) live on mesh col owner_q
        owner_q, off_q = divmod(t * kb, kq)
        pa = cyclic._rows_q(
            {(p, q): a[p * mloc:(p + 1) * mloc,
                       q * kq + off_q:q * kq + off_q + kb]
             for p, q in ranks}, Pn, Qn,
            lambda v: cyclic._masked_psum(v, owner_q))
        # B panel: global k-rows live on mesh row owner_p
        owner_p, off_p = divmod(t * kb, kp)
        pb = cyclic._cols_p(
            {(p, q): bmat[p * kp + off_p:p * kp + off_p + kb,
                          q * nloc:(q + 1) * nloc] for p, q in ranks},
            Pn, Qn, lambda v: cyclic._masked_psum(v, owner_p))
        for r in ranks:
            acc[r] = acc[r] + alpha * k.dot(pa[r], pb[r])
    out = torch.cat([torch.cat([acc[p, q] for q in range(Qn)], dim=1)
                     for p in range(Pn)], dim=0)
    return TileMatrix(out[:Mp, :Np], C.desc).zero_pad()


def gemm_ex(alpha, A: TileMatrix, B: TileMatrix, beta, C: TileMatrix,
            transa: str = "N", transb: str = "N",
            info: Optional[config.Info] = None,
            algo: str = "auto") -> TileMatrix:
    """dplasma_zgemm_New_ex analog: dispatch on grid, footprint and
    info."""
    plan = plan_gemm(C, A, B, transa, transb, info, algo)
    if plan.algo == "summa":
        return gemm_summa(alpha, A, B, beta, C, transa, transb)
    if plan.algo == "stream":
        return gemm_stream(alpha, A, B, beta, C, transa, transb, plan)
    return gemm_dot(alpha, A, B, beta, C, transa, transb)


def dag(C: TileMatrix, A: TileMatrix, B: TileMatrix, recorder=None):
    """The tile GEMM DAG for ``--dot`` dumps (gemm.py:289) comes with the
    analysis layer, ROADMAP queue 1 item 15."""
    raise NotImplementedError("ops.gemm.dag is not ported yet (ROADMAP "
                              "queue 1 item 15)")
