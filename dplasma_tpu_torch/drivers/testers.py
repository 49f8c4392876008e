"""The testing_* driver bodies of the ported slices: the Level-3 BLAS
``gemm``, ``symm``, ``hemm``, ``syrk``, ``herk``, ``syr2k``, ``her2k``,
``trmm`` and ``trsm``; the Cholesky family ``potrf``, ``potrs``,
``posv``, ``potri``, ``poinv``, ``trtri`` and ``lauum``; ``getrf`` (=
``getrf_1d``), ``getrf_nopiv`` (its ladder escalating to the
butterfly and the LU/QR hybrid), ``gesv``, ``getrf_ptgpanel`` (the distributed panel
under ``-p P -q Q``), ``getrf_incpiv``, ``gesv_incpiv`` and
``getrf_qrf`` (``--criteria`` and ``-a/--alpha``); the QR family
``geqrf``, ``gelqf``, ``ungqr``, ``unglq``, ``unmqr``, ``unmlq`` and
``gels``; the hierarchical QR trees ``geqrf_hqr``, ``gelqf_hqr``,
``geqrf_systolic``, ``gelqf_systolic``, ``geqrf_rd``, their appliers
``unmqr_hqr``, ``unmlq_hqr``, ``unmqr_systolic``, ``unmlq_systolic``
and the tree checker ``pivgen``; the LDLᴴ and butterfly solvers
``hetrf`` and ``hebut`` (``-y/--butlvl``); the eigen/SVD chain
``heev``, ``hetrd``, ``gesvd``, ``gebrd`` and its stages ``hbrdt`` and
``gebrd_ge2gb``; the mixed-precision IR
solvers ``posv_ir``, ``gesv_ir`` and ``gels_ir`` (working precision
from MCA ``ir.precision``; their ladder's fallback rung is the
full-precision solve); the norms ``lange``, ``lanhe``, ``lansy``,
``lantr``, ``lanm2`` and the aux ops ``geadd``, ``tradd``, ``print``;
the insert-task (DTD) runtime paths ``potrf_dtd``, ``potrf_dtd_untied``,
``gemm_dtd``, ``geqrf_dtd``, ``geqrf_dtd_untied`` and
``getrf_incpiv_dtd`` (``_untied`` differs from its twin only in
PaRSEC's worker binding, which the port does not have; ``geqrf_dtd`` and
``getrf_incpiv_dtd`` run the geqrf and getrf_incpiv bodies, as the
reference re-runs its PTG DAG under the DTD engine).
Under MCA ``dd_gemm=always`` the d-precision drivers take the
f64-equivalent limb route. Every driver but the IR solvers (float64
only, as in the reference) runs in all four precisions s, d, c and z.

Ports ``dplasma_tpu/drivers/testers.py`` (:24, :31-41, :68-287,
:290-381, :395-450, :454-455, :510-607, :609-713, :771-798,
:720-768, :801-868, :871-930, :932-975, :980-1067, :458-490; the IR
drivers without the autopilot, ROADMAP queue 1 item 9b): seeded
generation → timed run with the GFLOPS print → optional ``-x``
residual verification against the regenerated input, with the
reference's flop counts and thresholds. ``--abft`` puts gemm, potrf,
getrf and getrf_nopiv on their checksum-carried variants
(``resilience.abft``), verified after each attempt.
"""
from __future__ import annotations

import torch

from dplasma_tpu_torch import dtd
from dplasma_tpu_torch.drivers.common import Driver
from dplasma_tpu_torch.kernels import blas as kb
from dplasma_tpu_torch.ops import aux, blas3, checks, eig, generators, hqr
from dplasma_tpu_torch.ops import ldl, lu, norms, qr, rbt, refine
from dplasma_tpu_torch.ops import potrf as potrf_mod
from dplasma_tpu_torch.utils import flops as lawn41

TREE_NAMES = {0: "flat", 1: "greedy", 2: "fibonacci", 3: "binary",
              4: "greedy1p"}
CRITERIA = {0: "alternating", 1: "higham_sum", 2: "mumps", 3: "random"}


def _gen(drv: Driver, M, N, seed_off=0, kind="rnt", bump=None):
    ip = drv.ip
    dt = ip.prec_dtype
    if kind in ("he", "sy"):
        gen = generators.plghe if kind == "he" else generators.plgsy
        return gen(float(N) if bump is None else bump, N, ip.NB,
                   seed=ip.seed + seed_off, dtype=dt, device=drv.device)
    return generators.plrnt(M, N, ip.MB, ip.NB, seed=ip.seed + seed_off,
                            dtype=dt, device=drv.device)


def gemm(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.K)
    B = _gen(drv, ip.K, ip.N, 1)
    C = _gen(drv, ip.M, ip.N, 2)
    alpha, beta = (0.51, -0.42)
    fn = lambda a, b, c: blas3.gemm(alpha, a, b, beta, c)  # noqa: E731
    verify = None
    if ip.abft:
        from dplasma_tpu_torch.resilience import abft as _abft
        fn = lambda a, b, c: _abft.gemm_checksummed(  # noqa: E731
            alpha, a, b, beta, c)
        verify = lambda out: _abft.gemm_verify(  # noqa: E731
            out, alpha, A, B, beta, C)
    out, _ = drv.progress(
        fn, (A, B, C),
        lawn41.gemm(ip.M, ip.N, ip.K, ip.prec_dtype.is_complex),
        verify_fn=verify)
    if ip.check:
        ref = alpha * (A.to_dense() @ B.to_dense()) + beta * C.to_dense()
        got = out.to_dense()
        eps = checks._eps(ref.dtype)
        r = float(torch.max(torch.abs(ref - got))
                  / (torch.max(torch.abs(ref)) + 1.0))
        return drv.report_check("GEMM", r, r < 60 * eps * ip.K)
    return 0


def _sym_update(drv: Driver, op, flops, rank2: bool):
    """syrk/herk (rank2 False) and syr2k/her2k: ``flops`` is the LAWN-41
    count's function of (K, N, complex)."""
    ip = drv.ip
    A = _gen(drv, ip.N, ip.K)
    C = _gen(drv, ip.N, ip.N, 2,
             kind="he" if op in (blas3.herk, blas3.her2k) else "sy")
    if rank2:
        B = _gen(drv, ip.N, ip.K, 1)
        args, fn = (A, B, C), lambda a, b, c: op(0.7, a, b, 0.3, c,
                                                uplo="L", trans="N")
    else:
        args, fn = (A, C), lambda a, c: op(0.7, a, 0.3, c,
                                           uplo="L", trans="N")
    drv.progress(fn, args, flops(ip.K, ip.N, ip.prec_dtype.is_complex))
    return 0


def syrk(drv):
    return _sym_update(drv, blas3.syrk, lawn41.syrk, False)


def herk(drv):
    return _sym_update(drv, blas3.herk, lawn41.syrk, False)


def syr2k(drv):
    return _sym_update(drv, blas3.syr2k, lawn41.syr2k, True)


def her2k(drv):
    return _sym_update(drv, blas3.her2k, lawn41.syr2k, True)


def _symm_like(drv: Driver, op):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.M, 0, kind="he" if op is blas3.hemm else "sy")
    B = _gen(drv, ip.M, ip.N, 1)
    C = _gen(drv, ip.M, ip.N, 2)
    drv.progress(lambda a, b, c: op(0.7, a, b, 0.3, c, side="L", uplo="L"),
                 (A, B, C),
                 lawn41.symm("L", ip.M, ip.N, ip.prec_dtype.is_complex))
    return 0


def symm(drv):
    return _symm_like(drv, blas3.symm)


def hemm(drv):
    return _symm_like(drv, blas3.hemm)


def trmm(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.M, 0, kind="he")
    B = _gen(drv, ip.M, ip.N, 1)
    drv.progress(
        lambda a, b: blas3.trmm(1.0, a, b, side="L", uplo="L"), (A, B),
        lawn41.trmm("L", ip.M, ip.N, ip.prec_dtype.is_complex))
    return 0


def trsm(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.M, 0, kind="he")
    B = _gen(drv, ip.M, ip.N, 1)
    X, _ = drv.progress(
        lambda a, b: blas3.trsm(1.0, a, b, side="L", uplo="L"), (A, B),
        lawn41.trsm("L", ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        R = blas3.trmm(1.0, A, X, side="L", uplo="L")
        r = float(norms.lange(aux.geadd(R, B, -1.0, 1.0), "F")
                  / norms.lange(B, "F"))
        return drv.report_check("TRSM", r,
                                r < 60 * checks._eps(ip.prec_dtype) * ip.M)
    return 0


def potrf(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    hnb = max(ip.HNB, 0)  # -z/--HNB: recursive diagonal-tile variant
    fn = lambda a: potrf_mod.potrf_rec(a, "L", hnb)  # noqa: E731
    verify = None
    if ip.abft:
        from dplasma_tpu_torch.resilience import abft as _abft
        fn = lambda a: _abft.potrf_checksummed(a, "L", hnb)  # noqa: E731
        verify = lambda out: _abft.potrf_verify(out, A0, "L")  # noqa: E731
    L, _ = drv.progress(fn, (A0,),
                        lawn41.potrf(ip.N, ip.prec_dtype.is_complex),
                        verify_fn=verify)
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


def potri(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    L = potrf_mod.potrf(A0, "L")
    Ainv, _ = drv.progress(lambda l: potrf_mod.potri(l, "L"), (L,),
                           lawn41.potri(ip.N, ip.prec_dtype.is_complex))
    if ip.check or ip.check_inv:
        r, ok = checks.check_inverse(A0, Ainv, uplo="L")
        return drv.report_check("POTRI", r, ok)
    return 0


def poinv(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    cplx = ip.prec_dtype.is_complex
    Ainv, _ = drv.progress(lambda a: potrf_mod.poinv(a, "L"), (A0,),
                           lawn41.potri(ip.N, cplx)
                           + lawn41.potrf(ip.N, cplx))
    if ip.check or ip.check_inv:
        r, ok = checks.check_inverse(A0, Ainv, uplo="L")
        return drv.report_check("POINV", r, ok)
    return 0


def trtri(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.N, ip.N, 0, kind="he")
    drv.progress(lambda a: potrf_mod.trtri(a, "L", "N"), (A,),
                 lawn41.trtri(ip.N, ip.prec_dtype.is_complex))
    return 0


def lauum(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.N, ip.N, 0, kind="he")
    drv.progress(lambda a: potrf_mod.lauum(a, "L"), (A,),
                 lawn41.lauum(ip.N, ip.prec_dtype.is_complex))
    return 0


def _lu_flops(ip):
    return lawn41.getrf(ip.M, ip.N, ip.prec_dtype.is_complex)


def getrf_nopiv(drv: Driver):
    """testing_?getrf_nopiv: LU without pivoting of a diagonally
    dominant matrix. The ladder's algorithm escalation (a failed attempt
    only): RBT-preconditioned nopiv, then the LU/QR hybrid by
    ``--criteria``; the -x check follows the winner's contract."""
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    depth = max(ip.butterfly_level, 2)
    crit = CRITERIA.get(ip.criteria, "higham_sum")
    qalpha = ip.alpha if ip.alpha > 0 else 100.0
    fn = lu.getrf_nopiv
    verify = None
    if ip.abft:
        from dplasma_tpu_torch.resilience import abft as _abft
        fn = _abft.getrf_nopiv_checksummed
        verify = lambda out: _abft.getrf_nopiv_verify(out, A0)  # noqa: E731
    fallbacks = [
        ("getrf_rbt", lambda a: lu.getrf_nopiv(
            rbt.hebut(a, seed=ip.seed, depth=depth))),
        ("getrf_qrf", lambda a: lu.getrf_qrf(
            a, criterion=crit, alpha=qalpha)),
    ]
    out, _ = drv.progress(fn, (A0,), _lu_flops(ip), verify_fn=verify,
                          fallbacks=fallbacks)
    if ip.check:
        B = _gen(drv, ip.N, ip.K, 1)
        if drv.winner == "getrf_qrf":
            LU, Tm, lu_tab = out
            X = lu.getrs_qrf(LU, Tm, lu_tab, B)
            return drv.report_check("GETRF_QRF |b-Ax|",
                                    *checks.check_axmb(A0, B, X))
        if drv.winner == "getrf_rbt":
            # the factor is of the butterflied Ã = Uᵀ A U:
            # x = U Ã⁻¹ Uᵀ b
            Y = rbt.gebmm(B, seed=ip.seed, depth=depth, trans="T")
            Y = blas3.trsm(1.0, out, Y, side="L", uplo="L", trans="N",
                           diag="U")
            Y = blas3.trsm(1.0, out, Y, side="L", uplo="U", trans="N")
            X = rbt.gebmm(Y, seed=ip.seed, depth=depth, trans="N")
            return drv.report_check("GETRF_RBT |b-Ax|",
                                    *checks.check_axmb(A0, B, X))
        Y = blas3.trsm(1.0, out, B, side="L", uplo="L", trans="N",
                       diag="U")
        X = blas3.trsm(1.0, out, Y, side="L", uplo="U", trans="N")
        return drv.report_check("GETRF_NOPIV |b-Ax|",
                                *checks.check_axmb(A0, B, X))
    return 0


def getrf_1d(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    hnb = max(ip.HNB, 0)  # -z/--HNB: recursive-panel variant
    fn = lambda a: lu.getrf_rec(a, hnb)  # noqa: E731
    verify = None
    if ip.abft:
        from dplasma_tpu_torch.resilience import abft as _abft
        fn = lambda a: _abft.getrf_checksummed(a, hnb)  # noqa: E731
        verify = lambda out: _abft.getrf_verify(out, A0)  # noqa: E731
    (LU, perm), _ = drv.progress(fn, (A0,), _lu_flops(ip),
                                 verify_fn=verify)
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


def getrf_incpiv(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    (LU, Lc, piv), _ = drv.progress(
        lu.getrf_incpiv, (A0,),
        lawn41.getrf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        B = _gen(drv, ip.N, ip.K, 1)
        X = lu.getrs_incpiv(LU, Lc, piv, B)
        r, ok = checks.check_axmb(A0, B, X)
        return drv.report_check("GETRF_INCPIV |b-Ax|", r, ok)
    return 0


def getrf_qrf(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    crit = CRITERIA.get(ip.criteria, "higham_sum")
    alpha = ip.alpha if ip.alpha > 0 else 100.0
    (LU, Tm, lu_tab), _ = drv.progress(
        lambda a: lu.getrf_qrf(a, criterion=crit, alpha=alpha), (A0,),
        lawn41.getrf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.loud >= 2:
        print(f"#+ getrf_qrf: criterion={crit} alpha={alpha} lu_tab="
              f"{lu_tab.tolist()}")
    if ip.check:
        B = _gen(drv, ip.N, ip.K, 1)
        X = lu.getrs_qrf(LU, Tm, lu_tab, B)
        r, ok = checks.check_axmb(A0, B, X)
        return drv.report_check("GETRF_QRF |b-Ax|", r, ok)
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


def gesv_incpiv(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N)
    B = _gen(drv, ip.N, ip.K, 1)
    cplx = ip.prec_dtype.is_complex
    out, _ = drv.progress(
        lu.gesv_incpiv, (A0, B),
        lawn41.getrf(ip.N, ip.N, cplx) + lawn41.getrs(ip.N, ip.K, cplx))
    if ip.check:
        r, ok = checks.check_axmb(A0, B, out[-1])
        return drv.report_check("GESV_INCPIV |b-Ax|", r, ok)
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


# ------------------------------------------------- hierarchical QR trees

def _hqr_tree_from_ip(drv: Driver, MT: int):
    """The tree of ``--treel --treeh --qr_a --qr_p``; as in the
    reference, ``-d/--domino`` and ``-r/--tsrr`` parse but do not reach
    the tree."""
    ip = drv.ip
    return hqr.hqr_tree(
        MT,
        llvl=TREE_NAMES.get(ip.lowlvl_tree, "greedy"),
        hlvl=TREE_NAMES.get(ip.highlvl_tree, "flat"),
        a=ip.qr_a if ip.qr_a > 0 else 1,
        p=ip.qr_p if ip.qr_p > 0 else max(ip.P, 1),
    )


def _systolic_from_ip(drv: Driver, MT: int):
    ip = drv.ip
    return hqr.systolic_tree(MT, p=max(ip.qr_p, 1), q=max(ip.qr_a, 1))


def _geqrf_param_driver(drv: Driver, make_tree, orthogonality: bool):
    """Factor with the tree ``make_tree(MT)``; -x: |A−QR| on
    ``ungqr_param``'s Q, and |I−Q'Q| where ``orthogonality``."""
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    tree = make_tree(A0.desc.MT)
    out, _ = drv.progress(
        lambda a: hqr.geqrf_param(tree, a), (A0,),
        lawn41.geqrf(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        Af, Tts, Ttt = out
        Q = hqr.ungqr_param(tree, Af, Tts, Ttt).to_dense()
        R = torch.triu(Af.to_dense()[:min(ip.M, ip.N), :])
        r, ok = checks.check_qr(A0, Q, R)
        ret = drv.report_check("|A-QR|", r, ok)
        if orthogonality:
            r, ok = checks.check_orthogonality(Q)
            ret |= drv.report_check("|I-Q'Q|", r, ok)
        return ret
    return 0


def geqrf_hqr(drv: Driver):
    return _geqrf_param_driver(
        drv, lambda MT: _hqr_tree_from_ip(drv, MT), True)


def geqrf_systolic(drv: Driver):
    return _geqrf_param_driver(
        drv, lambda MT: _systolic_from_ip(drv, MT), False)


def geqrf_rd(drv: Driver):
    """testing_zgeqrf_rd: reduction-domain QR — the svd-ratio tree."""
    return _geqrf_param_driver(
        drv, lambda MT: hqr.svd_tree(MT, p=max(drv.ip.qr_p, 1)), False)


def _gelqf_param_driver(drv: Driver, make_tree):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    tree = make_tree(A0.desc.NT)
    drv.progress(lambda a: hqr.gelqf_param(tree, a), (A0,),
                 lawn41.gelqf(ip.M, ip.N, ip.prec_dtype.is_complex))
    return 0


def gelqf_hqr(drv: Driver):
    return _gelqf_param_driver(drv, lambda MT: _hqr_tree_from_ip(drv, MT))


def gelqf_systolic(drv: Driver):
    return _gelqf_param_driver(drv, lambda MT: _systolic_from_ip(drv, MT))


def _unm_hqr(drv: Driver, kind: str, make_tree):
    """Factor an M×M matrix untimed, then time the apply of Q (``qr``)
    or of the LQ's Q (``lq``) to an M×N matrix from the left."""
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.M)
    if kind == "qr":
        tree = make_tree(A0.desc.MT)
        factor, apply = hqr.geqrf_param, hqr.unmqr_param
    else:
        tree = make_tree(A0.desc.NT)
        factor, apply = hqr.gelqf_param, hqr.unmlq_param
    Af, Tts, Ttt = factor(tree, A0)
    C = _gen(drv, ip.M, ip.N, 1)
    drv.progress(lambda c: apply(tree, "L", "N", Af, Tts, Ttt, c), (C,),
                 lawn41.unmqr("L", ip.M, ip.N, ip.M,
                              ip.prec_dtype.is_complex))
    return 0


def unmqr_hqr(drv: Driver):
    return _unm_hqr(drv, "qr", lambda MT: _hqr_tree_from_ip(drv, MT))


def unmlq_hqr(drv: Driver):
    return _unm_hqr(drv, "lq", lambda MT: _hqr_tree_from_ip(drv, MT))


def unmqr_systolic(drv: Driver):
    return _unm_hqr(drv, "qr", lambda MT: _systolic_from_ip(drv, MT))


def unmlq_systolic(drv: Driver):
    return _unm_hqr(drv, "lq", lambda MT: _systolic_from_ip(drv, MT))


def pivgen(drv: Driver):
    """testing_zpivgen: combinatorial QR-tree checker over the full
    generator grid (ref TestsQRPivgen.cmake, dplasma_qrtree_check)."""
    ip = drv.ip
    MT = max(-(-ip.M // max(ip.MB, 1)), 1)
    n_ok = 0
    for llvl in ("flat", "greedy", "fibonacci", "binary", "greedy1p"):
        for hlvl in ("flat", "greedy"):
            for a in (1, 2, 4):
                for p in (1, 2, 4):
                    tree = hqr.hqr_tree(MT, llvl=llvl, hlvl=hlvl,
                                        a=a, p=p)
                    hqr.check_tree(tree)
                    n_ok += 1
    for p in (1, 2, 3):
        hqr.check_tree(hqr.systolic_tree(MT, p=p))
        n_ok += 1
    hqr.check_tree(hqr.svd_tree(MT))
    n_ok += 1
    if ip.loud >= 1:
        print(f"#+ pivgen: {n_ok} trees checked OK (MT={MT})")
    return 0


# ------------------------------------------------------- eigen and SVD

def _eig_slack(ip) -> float:
    """Spectrum-check slack. The reference widens its check 50x for d and
    z on its TPU, whose f64 is emulated; the card computes f64 natively,
    so the slack stays 1 (the reference's CPU value)."""
    del ip
    return 1.0


def _spectrum_residual(got, want):
    """max|sort(got) − sort(want)| / (max|want| + 1)."""
    got = torch.sort(got.to(want.dtype)).values
    want = torch.sort(want).values
    return float(torch.max(torch.abs(got - want))
                 / (torch.max(torch.abs(want)) + 1.0))


def heev(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he", bump=0.0)
    out, _ = drv.progress(lambda a: eig.heev(a, "L"), (A0,),
                          lawn41.heev(ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        w = out[0] if isinstance(out, tuple) else out
        r = _spectrum_residual(w, torch.linalg.eigvalsh(A0.to_dense()))
        eps = checks._eps(ip.prec_dtype)
        return drv.report_check("HEEV eigenvalues", r,
                                r < 60 * eps * ip.N * _eig_slack(ip))
    return 0


def hetrd(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he", bump=0.0)
    drv.progress(lambda a: eig.hetrd(a, "L"), (A0,),
                 lawn41.heev(ip.N, ip.prec_dtype.is_complex))
    return 0


def gesvd(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    out, _ = drv.progress(eig.gesvd, (A0,),
                          lawn41.gebrd(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        s = out[0] if isinstance(out, tuple) else out
        ref = torch.linalg.svdvals(A0.to_dense())
        k = min(s.reshape(-1).shape[0], ref.shape[0])
        got = torch.sort(s.reshape(-1).to(ref.dtype)).values[-k:]
        want = torch.sort(ref).values[-k:]
        r = float(torch.max(torch.abs(got - want)) / (ref.max() + 1.0))
        eps = checks._eps(ip.prec_dtype)
        return drv.report_check("GESVD singular values", r,
                                r < 60 * eps * max(ip.M, ip.N))
    return 0


def gebrd(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    drv.progress(eig.gebrd, (A0,),
                 lawn41.gebrd(ip.M, ip.N, ip.prec_dtype.is_complex))
    return 0


def hbrdt(drv: Driver):
    """testing_zhbrdt: the band → tridiagonal stage alone, on the band
    herbt leaves (untimed), called with bw = 2nb − 1 as the reference's
    driver does."""
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he", bump=0.0)
    Bm, _, _ = eig.herbt(A0, "L")
    bw = 2 * A0.desc.nb - 1
    # band-stage work only: ~6 N^2 bw flops (not the full heev count)
    stage_flops = 6.0 * float(ip.N) ** 2 * bw
    out, _ = drv.progress(lambda b: eig.hbrdt(b, bw), (Bm,), stage_flops)
    if ip.check:
        d, e = out
        t = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
        ref = torch.linalg.eigvalsh(norms._sym_full(A0, "L", conj=True))
        r = _spectrum_residual(torch.linalg.eigvalsh(t), ref)
        eps = checks._eps(ip.prec_dtype)
        return drv.report_check("HBRDT spectrum", r,
                                r < 60 * eps * ip.N * _eig_slack(ip))
    return 0


def gebrd_ge2gb(drv: Driver):
    """testing_zgebrd_ge2gb: the dense → band bidiagonal stage alone."""
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.N)
    out, _ = drv.progress(eig.gebrd_ge2gb, (A0,),
                          lawn41.gebrd(ip.M, ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        sb = torch.linalg.svdvals(out.to_dense())
        sa = torch.linalg.svdvals(A0.to_dense())
        r = float(torch.max(torch.abs(sb - sa)) / (torch.max(sa) + 1.0))
        eps = checks._eps(ip.prec_dtype)
        return drv.report_check("GE2GB svals", r,
                                r < 60 * eps * max(ip.M, ip.N))
    return 0


# ------------------------------------------------- LDLᴴ and butterfly

def hetrf(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    out, _ = drv.progress(lambda a: ldl.hetrf(a, "L"), (A0,),
                          lawn41.hetrf(ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        B = _gen(drv, ip.N, ip.K, 1)
        X = ldl.hetrs(out, B)
        r, ok = checks.check_axmb(A0, B, X, uplo="L")
        return drv.report_check("HETRF |b-Ax|", r, ok)
    return 0


def hebut(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    B = _gen(drv, ip.N, ip.K, 1)
    depth = max(ip.butterfly_level, 1)
    out, _ = drv.progress(
        lambda a, b: rbt.hesv_rbt(a, b, "L", seed=ip.seed, depth=depth),
        (A0, B), lawn41.hetrf(ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        _, X = out
        r, ok = checks.check_axmb(A0, B, X, uplo="L")
        return drv.report_check("HESV_RBT |b-Ax|", r, ok)
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
    fallbacks = [("posv_dd", lambda a, b: potrf_mod.posv(a, b, "L"))]
    out, _ = drv.progress(lambda a, b: refine.posv_ir(a, b, "L"),
                          (A0, B), _refine_flops(ip, "posv"),
                          fallbacks=fallbacks)
    if drv.winner == "posv_dd":
        X = out[1]
    else:
        X, info = out
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

    def _gesv_ptg(a, b):
        # the full-precision route the solver's own escalation takes
        F, p = lu.getrf_ptgpanel(a)
        return F, p, lu.getrs("N", F, p, b)

    out, _ = drv.progress(refine.gesv_ir, (A0, B),
                          _refine_flops(ip, "gesv"),
                          fallbacks=[("gesv_dd", _gesv_ptg)])
    if drv.winner == "gesv_dd":
        X = out[-1]
    else:
        X, info = out
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
    out, _ = drv.progress(refine.gels_ir, (A0, B),
                          _refine_flops(ip, "gels"),
                          fallbacks=[("gels_dd", qr.gels)])
    if drv.winner == "gels_dd":
        Xd = out.to_dense()[:ip.N]
    else:
        X, info = out
        drv.report_refine(refine.summarize(info, op=drv.name))
        Xd = X.to_dense()
    if ip.check:
        r, ok = checks.check_gels(A0, B, Xd)
        return drv.report_check("GELS_IR normal eq", r, ok)
    return 0


# -------------------------------------------------------------- norms/aux

def _norm_driver(drv: Driver, fn, kind="rnt"):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.N, 0, kind=kind)
    for nrm in ("M", "1", "I", "F"):
        val, _ = drv.progress(lambda a, n=nrm: fn(a, n), (A,),
                              float(ip.M) * ip.N, label=f"{drv.name}:{nrm}")
        if ip.loud >= 2:
            print(f"  ||A||_{nrm} = {float(val):e}")
    return 0


def lange(drv):
    return _norm_driver(drv, norms.lange)


def lanhe(drv):
    return _norm_driver(drv, lambda a, n: norms.lanhe(a, n, "L"), kind="he")


def lansy(drv):
    return _norm_driver(drv, lambda a, n: norms.lansy(a, n, "L"), kind="sy")


def lantr(drv):
    return _norm_driver(drv, lambda a, n: norms.lantr(a, n, "L", "N"))


def lanm2(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.N)
    val, _ = drv.progress(norms.lanm2, (A,), 2.0 * ip.M * ip.N * 20)
    if ip.check:
        ref = torch.linalg.matrix_norm(A.to_dense(), ord=2)
        r = float(torch.abs(val - ref) / ref)
        return drv.report_check("LANM2 vs SVD", r, r < 1e-2)
    return 0


def geadd(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.N)
    B = _gen(drv, ip.M, ip.N, 1)
    drv.progress(lambda a, b: aux.geadd(a, b, 0.7, 0.3), (A, B),
                 2.0 * ip.M * ip.N)
    return 0


def tradd(drv: Driver):
    ip = drv.ip
    A = _gen(drv, ip.M, ip.N)
    B = _gen(drv, ip.M, ip.N, 1)
    drv.progress(lambda a, b: aux.tradd(a, b, 0.7, 0.3, uplo="L"), (A, B),
                 1.0 * ip.M * ip.N)
    return 0


def print_matrix(drv: Driver):
    A = _gen(drv, drv.ip.M, drv.ip.N)
    print(A)
    if drv.ip.loud >= 3:
        print(A.to_dense())
    return 0


# ------------------------------------------------------------------ DTD

def potrf_dtd(drv: Driver):
    """testing_zpotrf_dtd: the insert-task runtime path."""
    ip = drv.ip
    A0 = _gen(drv, ip.N, ip.N, 0, kind="he")
    out, _ = drv.progress(lambda a: dtd.potrf_dtd(a, "L"), (A0,),
                          lawn41.potrf(ip.N, ip.prec_dtype.is_complex))
    if ip.check:
        r, ok = checks.check_potrf(A0, out, "L")
        return drv.report_check("POTRF(dtd)", r, ok)
    return 0


def _dtd_gemm_body(a, b, c):
    """C = A B by one task per C tile and k panel, each accumulating
    into its C tile (INOUT)."""
    tp = dtd.TaskPool(c)
    for i in range(c.MT):
        for j in range(c.NT):
            for kk in range(a.NT):
                def task(ct, i=i, j=j, kk=kk):
                    return kb.gemm(1.0, a.tile(i, kk), b.tile(kk, j),
                                   1.0 if kk else 0.0, ct)
                tp.insert_task(task, tp.tile(0, i, j, dtd.INOUT),
                               name="gemm")
    (out,) = tp.wait()
    return out


def gemm_dtd(drv: Driver):
    ip = drv.ip
    A0 = _gen(drv, ip.M, ip.K)
    B0 = _gen(drv, ip.K, ip.N, 1)
    C0 = _gen(drv, ip.M, ip.N, 2)
    out, _ = drv.progress(
        _dtd_gemm_body, (A0, B0, C0),
        lawn41.gemm(ip.M, ip.N, ip.K, ip.prec_dtype.is_complex))
    if ip.check:
        ref = blas3.gemm(1.0, A0, B0, 0.0, C0.like(C0.data * 0))
        r = float(torch.max(torch.abs(out.to_dense() - ref.to_dense()))
                  / (torch.max(torch.abs(ref.to_dense())) + 1.0))
        eps = checks._eps(ip.prec_dtype)
        return drv.report_check("GEMM(dtd)", r, r < 60 * eps * ip.K)
    return 0


def geqrf_dtd(drv: Driver):
    """testing_zgeqrf_dtd: the blocked QR (the reference re-runs its PTG
    DAG under the DTD engine)."""
    return geqrf(drv)


def getrf_incpiv_dtd(drv: Driver):
    return getrf_incpiv(drv)


#: registry: algo name (precision-less) -> driver body
DRIVERS = {
    "gemm": gemm, "symm": symm, "hemm": hemm,
    "syrk": syrk, "herk": herk, "syr2k": syr2k, "her2k": her2k,
    "trmm": trmm, "trsm": trsm,
    "potrf": potrf, "potrs": potrs, "posv": posv,
    "potri": potri, "poinv": poinv, "trtri": trtri, "lauum": lauum,
    "geqrf": geqrf, "gelqf": gelqf, "ungqr": ungqr, "unglq": unglq,
    "unmqr": unmqr, "unmlq": unmlq, "gels": gels,
    "geqrf_hqr": geqrf_hqr, "gelqf_hqr": gelqf_hqr,
    "geqrf_systolic": geqrf_systolic, "gelqf_systolic": gelqf_systolic,
    "geqrf_rd": geqrf_rd,
    "unmqr_hqr": unmqr_hqr, "unmlq_hqr": unmlq_hqr,
    "unmqr_systolic": unmqr_systolic, "unmlq_systolic": unmlq_systolic,
    "pivgen": pivgen, "hetrf": hetrf, "hebut": hebut,
    "heev": heev, "hetrd": hetrd, "gesvd": gesvd, "gebrd": gebrd,
    "hbrdt": hbrdt, "gebrd_ge2gb": gebrd_ge2gb,
    "getrf": getrf_1d, "getrf_1d": getrf_1d, "getrf_nopiv": getrf_nopiv,
    "getrf_ptgpanel": getrf_ptgpanel, "gesv": gesv,
    "getrf_incpiv": getrf_incpiv, "getrf_qrf": getrf_qrf,
    "gesv_incpiv": gesv_incpiv,
    "posv_ir": posv_ir, "gesv_ir": gesv_ir, "gels_ir": gels_ir,
    "lange": lange, "lanhe": lanhe, "lansy": lansy, "lantr": lantr,
    "lanm2": lanm2,
    "geadd": geadd, "tradd": tradd, "print": print_matrix,
    "potrf_dtd": potrf_dtd, "potrf_dtd_untied": potrf_dtd,
    "gemm_dtd": gemm_dtd,
    "geqrf_dtd": geqrf_dtd, "geqrf_dtd_untied": geqrf_dtd,
    "getrf_incpiv_dtd": getrf_incpiv_dtd,
}
