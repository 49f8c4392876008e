"""The testing_* driver bodies of the ported slices: ``potrf``,
``potrs``, ``posv``, ``gemm``, ``getrf`` (= ``getrf_1d``), ``gesv``,
``getrf_ptgpanel`` (the distributed panel under ``-p P -q Q``), the
QR family ``geqrf``, ``gelqf``, ``ungqr``, ``unglq``, ``unmqr``,
``unmlq`` and ``gels``, and the mixed-precision IR solvers ``posv_ir``,
``gesv_ir`` and ``gels_ir`` (working precision from MCA
``ir.precision``). Under MCA ``dd_gemm=always`` the d-precision drivers
take the f64-equivalent limb route.

Ports ``dplasma_tpu/drivers/testers.py`` (:68-93, :191-246, :290-381,
:454-455, :510-545, :577-589, :609-713; the IR drivers without the
autopilot and the ladder's fallback rung, whose escape the solvers'
own escalation already takes): seeded
generation → timed run with the GFLOPS print → optional ``-x`` residual
verification against the regenerated input.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch.drivers.common import Driver
from dplasma_tpu_torch.ops import blas3, checks, generators, lu, qr
from dplasma_tpu_torch.ops import refine
from dplasma_tpu_torch.ops import potrf as potrf_mod
from dplasma_tpu_torch.utils import flops as lawn41


def _gen(drv: Driver, M, N, seed_off=0, kind="rnt"):
    ip = drv.ip
    dt = ip.prec_dtype
    if kind == "he":
        return generators.plghe(float(N), N, ip.NB, seed=ip.seed + seed_off,
                                dtype=dt, device=drv.device)
    return generators.plrnt(M, N, ip.MB, ip.NB, seed=ip.seed + seed_off,
                            dtype=dt, device=drv.device)


def gemm(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.K)
    B = _gen(drv, ip.K, ip.N, 1)
    C = _gen(drv, ip.M, ip.N, 2)
    alpha, beta = (0.51, -0.42)
    out, _ = drv.progress(
        lambda a, b, c: blas3.gemm(alpha, a, b, beta, c), (A, B, C),
        lawn41.gemm(ip.M, ip.N, ip.K, ip.prec_dtype.is_complex))
    if ip.check:
        ref = alpha * (A.to_dense() @ B.to_dense()) + beta * C.to_dense()
        got = out.to_dense()
        eps = checks._eps(ref.dtype)
        r = float(torch.max(torch.abs(ref - got))
                  / (torch.max(torch.abs(ref)) + 1.0))
        return drv.report_check("GEMM", r, r < 60 * eps * ip.K)
    return 0


def potrf(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    hnb = max(ip.HNB, 0)  # -z/--HNB: recursive diagonal-tile variant
    L, _ = drv.progress(lambda a: potrf_mod.potrf_rec(a, "L", hnb), (A0,),
                        lawn41.potrf(ip.N, ip.prec_dtype.is_complex))
    ret = 0
    if ip.check:
        r, ok = checks.check_potrf(A0, L, "L")
        ret |= drv.report_check("POTRF", r, ok)
        B = _gen(drv, ip.N, ip.K, 1)
        X = potrf_mod.potrs(L, B, "L")
        r, ok = checks.check_axmb(A0, B, X, uplo="L")
        ret |= drv.report_check("POTRS |b-Ax|", r, ok)
    return ret


def potrs(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    L = potrf_mod.potrf(A0, "L")
    B = _gen(drv, ip.N, ip.K, 1)
    X, _ = drv.progress(lambda l, b: potrf_mod.potrs(l, b, "L"), (L, B),
                        lawn41.potrs(ip.N, ip.K, ip.prec_dtype.is_complex))
    if ip.check:
        r, ok = checks.check_axmb(A0, B, X, uplo="L")
        return drv.report_check("POTRS |b-Ax|", r, ok)
    return 0


def posv(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    B = _gen(drv, ip.N, ip.K, 1)
    cplx = ip.prec_dtype.is_complex
    out, _ = drv.progress(
        lambda a, b: potrf_mod.posv(a, b, "L"), (A0, B),
        lawn41.potrf(ip.N, cplx) + lawn41.potrs(ip.N, ip.K, cplx))
    if ip.check:
        _, X = out
        r, ok = checks.check_axmb(A0, B, X, uplo="L")
        return drv.report_check("POSV |b-Ax|", r, ok)
    return 0


def getrf_1d(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    hnb = max(ip.HNB, 0)  # -z/--HNB: recursive-panel variant
    (LU, perm), _ = drv.progress(
        lambda a: lu.getrf_rec(a, hnb), (A0,),
        lawn41.getrf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        B = _gen(drv, ip.N, ip.K, 1)
        X = lu.getrs("N", LU, perm, B)
        r, ok = checks.check_axmb(A0, B, X)
        return drv.report_check("GETRF |b-Ax|", r, ok)
    return 0


def getrf_ptgpanel(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    (LU, perm), _ = drv.progress(
        lu.getrf_ptgpanel, (A0,),
        lawn41.getrf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        B = _gen(drv, ip.N, ip.K, 1)
        X = lu.trsmpl_ptgpanel(LU, perm, B)
        X = blas3.trsm(1.0, LU, X, side="L", uplo="U")
        r, ok = checks.check_axmb(A0, B, X)
        return drv.report_check("GETRF_PTGPANEL |b-Ax|", r, ok)
    return 0


def gesv(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    B = _gen(drv, ip.N, ip.K, 1)
    cplx = ip.prec_dtype.is_complex
    (_, _, X), _ = drv.progress(
        lu.gesv_1d, (A0, B),
        lawn41.getrf(ip.N, ip.N, cplx) + lawn41.getrs(ip.N, ip.K, cplx))
    if ip.check:
        r, ok = checks.check_axmb(A0, B, X)
        return drv.report_check("GESV |b-Ax|", r, ok)
    return 0


# ------------------------------------------------------------------ QR

def geqrf(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    hnb = max(ip.HNB, 0)  # -z/--HNB: recursive-panel variant
    (Af, Tf), _ = drv.progress(
        lambda a: qr.geqrf_rec(a, hnb), (A0,),
        lawn41.geqrf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        Q = qr.ungqr(Af, Tf).to_dense()
        R = torch.triu(Af.to_dense()[:min(ip.M, ip.N), :])
        ret = 0
        r, ok = checks.check_qr(A0, Q, R)
        ret |= drv.report_check("|A-QR|", r, ok)
        r, ok = checks.check_orthogonality(Q)
        ret |= drv.report_check("|I-Q'Q|", r, ok)
        return ret
    return 0


def gelqf(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    (Af, Tf), _ = drv.progress(
        qr.gelqf, (A0,), lawn41.gelqf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        Q = qr.unglq(Af, Tf).to_dense()
        L = torch.tril(Af.to_dense()[:, :min(ip.M, ip.N)])
        ref = A0.to_dense()
        eps = checks._eps(ref.dtype)
        r = float(torch.max(torch.abs(ref - L @ Q))
                  / (torch.max(torch.abs(ref)) + 1.0))
        return drv.report_check("|A-LQ|", r, r < 60 * eps * max(ip.M, ip.N))
    return 0


def ungqr(drv: Driver):
    ip = drv.ip
    Af, Tf = qr.geqrf(_gen(drv, ip.M, ip.N))
    out, _ = drv.progress(qr.ungqr, (Af, Tf),
                          lawn41.ungqr(ip.M, ip.N, ip.N,
                                       ip.prec_dtype.is_complex))
    if ip.check:
        r, ok = checks.check_orthogonality(out.to_dense())
        return drv.report_check("|I-Q'Q|", r, ok)
    return 0


def unglq(drv: Driver):
    ip = drv.ip
    Af, Tf = qr.gelqf(_gen(drv, ip.M, ip.N))
    drv.progress(qr.unglq, (Af, Tf),
                 lawn41.ungqr(ip.N, ip.M, ip.M, ip.prec_dtype.is_complex))
    return 0


def unmqr(drv: Driver):
    ip = drv.ip
    Af, Tf = qr.geqrf(_gen(drv, ip.M, ip.M))
    C = _gen(drv, ip.M, ip.N, 1)
    drv.progress(lambda a, t, c: qr.unmqr("L", "N", a, t, c), (Af, Tf, C),
                 lawn41.unmqr("L", ip.M, ip.N, ip.M,
                              ip.prec_dtype.is_complex))
    return 0


def unmlq(drv: Driver):
    ip = drv.ip
    Af, Tf = qr.gelqf(_gen(drv, ip.M, ip.M))
    C = _gen(drv, ip.M, ip.N, 1)
    drv.progress(lambda a, t, c: qr.unmlq("L", "N", a, t, c), (Af, Tf, C),
                 lawn41.unmqr("L", ip.M, ip.N, ip.M,
                              ip.prec_dtype.is_complex))
    return 0


def gels(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    B = _gen(drv, max(ip.M, ip.N), ip.K, 1)
    cplx = ip.prec_dtype.is_complex
    out, _ = drv.progress(qr.gels, (A0, B),
                          lawn41.geqrf(ip.M, ip.N, cplx)
                          + lawn41.unmqr("L", ip.M, ip.K, ip.N, cplx))
    if ip.check:
        r, ok = checks.check_gels(A0, B, out.to_dense())
        return drv.report_check("GELS normal eq", r, ok)
    return 0


# ------------------------------------------- mixed-precision IR solves

def _refine_flops(ip, kind: str) -> float:
    """Advertised flop model of an IR solve: the factorization + one
    solve (the LAWN-41 counts of the op the IR route replaces; the
    O(n^2) refinement steps are not counted, as the reference leaves
    gerfs-style refinement unpriced)."""
    cplx = ip.prec_dtype.is_complex
    if kind == "posv":
        return lawn41.potrf(ip.N, cplx) + lawn41.potrs(ip.N, ip.K, cplx)
    if kind == "gesv":
        return lawn41.getrf(ip.N, ip.N, cplx) + lawn41.getrs(ip.N, ip.K,
                                                             cplx)
    return lawn41.geqrf(ip.M, ip.N, cplx) + lawn41.unmqr(
        "L", ip.M, ip.K, ip.N, cplx)


def posv_ir(drv: Driver):
    """testing_dposv_ir: SPD solve, factored in the MCA ``ir.precision``
    working precision and refined to f64-equivalent backward error
    (ops.refine); divergence escalates to the full-precision posv."""
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    B = _gen(drv, ip.N, ip.K, 1)
    (X, info), _ = drv.progress(lambda a, b: refine.posv_ir(a, b, "L"),
                                (A0, B), _refine_flops(ip, "posv"))
    drv.report_refine(refine.summarize(info, op=drv.name))
    if ip.check:
        r, ok = checks.check_solve(A0, B, X, uplo="L")
        return drv.report_check("POSV_IR backward error", r, ok)
    return 0


def gesv_ir(drv: Driver):
    """testing_dgesv_ir: general solve by low-precision pivoted LU +
    iterative refinement (see posv_ir)."""
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    B = _gen(drv, ip.N, ip.K, 1)
    (X, info), _ = drv.progress(refine.gesv_ir, (A0, B),
                                _refine_flops(ip, "gesv"))
    drv.report_refine(refine.summarize(info, op=drv.name))
    if ip.check:
        r, ok = checks.check_solve(A0, B, X)
        return drv.report_check("GESV_IR backward error", r, ok)
    return 0


def gels_ir(drv: Driver):
    """testing_dgels_ir: overdetermined least squares by low-precision
    QR + semi-normal-equation refinement on the R factor (see
    posv_ir)."""
    ip = drv.ip
    if ip.M < ip.N:
        raise SystemExit("gels_ir: overdetermined (M >= N) only; use "
                         "testing_?gels for the minimum-norm path")
    A0 = _gen(drv, ip.M, ip.N)
    B = _gen(drv, ip.M, ip.K, 1)
    (X, info), _ = drv.progress(refine.gels_ir, (A0, B),
                                _refine_flops(ip, "gels"))
    drv.report_refine(refine.summarize(info, op=drv.name))
    if ip.check:
        r, ok = checks.check_gels(A0, B, X.to_dense())
        return drv.report_check("GELS_IR normal eq", r, ok)
    return 0


DRIVERS = {"gemm": gemm, "potrf": potrf, "potrs": potrs, "posv": posv,
           "getrf": getrf_1d,
           "getrf_1d": getrf_1d, "getrf_ptgpanel": getrf_ptgpanel,
           "gesv": gesv,
           "geqrf": geqrf, "gelqf": gelqf, "ungqr": ungqr, "unglq": unglq,
           "unmqr": unmqr, "unmlq": unmlq, "gels": gels,
           "posv_ir": posv_ir, "gesv_ir": gesv_ir, "gels_ir": gels_ir}
