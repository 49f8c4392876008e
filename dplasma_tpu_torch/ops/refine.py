"""Mixed-precision iterative-refinement solvers: factor low, refine to
f64-equivalent accuracy.

Ports ``dplasma_tpu/ops/refine.py`` (:87-574). Factor A ONCE in a cheap
working precision, then recover an f64-accurate solution by looping the
O(n^2) refinement step

    r = b - A x          (f64-equivalent, kernels.dd.gemm_residual)
    d = solve(F_w, r)    (cached low-precision factors)
    x = x + d            (x carried in f64)

until the normwise backward error ||r|| / (||A|| ||x|| + ||b||) reaches
the ~100·u_f64 floor. Only the residual pays the limb-product cost;
the factorization runs at the working precision.

Working precisions (MCA ``ir.precision``, default ``f32``):

* ``int8`` — the f32 factor's trailing updates ride the block-scaled
  int8 GEMM (:mod:`dplasma_tpu_torch.kernels.quant`) while panels,
  trsm and diagonal tiles stay f32; per-update ones-probes guard
  divergence (``quant_guard_max``);
* ``bf16`` — operands and factors rounded through bf16 storage, the
  compute in f32;
* ``f32`` — plain f32 factorization;
* ``f32x2`` — the f32 factor takes ONE extra whole-matrix refinement
  step whose residual rides :func:`kernels.dd.gemm_residual` at
  ``bits=32`` (the nl=5 limb rung); its factor is then held in f64, so
  its correction solves are f64 solves.

Every residual and projection is a direct ``kernels.dd`` limb product,
whatever MCA ``dd_gemm`` says: on the card each is one launch of kernel
K2. The f32 factors take K1 (their update products, when K1 is
enabled), K3 (gesv_ir's panels under ``panel.kernel=pallas``) and K4
(gels_ir's panels under ``pallas``). Solves ride the blocked paths
(``ops.potrf.potrs``, ``ops.lu.getrs``, ``ops.blas3.trsm``) at the
factor's dtype; ``gels_ir`` refines least squares via semi-normal
equations on the QR ``R`` factor (R^T R d = A^T r: no Q per iteration).

Control flow is the reference's eager mode only: a host loop with an
early exit on convergence, divergence detection (non-finite or stalled
backward error) and escalation by running the full-precision route
(``potrf`` + ``potrs``, ``getrf_ptgpanel`` + ``getrs``, ``qr.gels``:
native FP64 under ``dd_gemm=auto``, the dd route under ``always``). The
reference's traced masked loop (refine.py:235-264) exists for
``jax.jit``, and the port has no jit. The analytic ``dag`` waits for
ROADMAP queue 1 item 15. The solvers carry the reference's phase spans
(``factor``, which encloses the inner factorization's own spans,
``solve``, ``residual``, ``correct``, ``escalate``), no-ops unless a
``--phase-profile`` pass has a ledger active.

One difference from the reference: posv_ir's and gesv_ir's escalation
refines the full-precision solve on the same exact residuals, with the
full-precision factor as the correction solver (:func:`_refined`), so an
escalating solve's ``escalate`` span encloses ``residual`` and
``correct`` spans the reference's does not have. The reference returns
that solve as it is, and its normwise backward error
(~n·u) fails the 100·u ``check_solve`` gate its own testers apply once
n is a few hundred; refined, an escalated solve meets the gate like a
converged one. gels_ir's escalation (``qr.gels``) already passes its
own gate, ``check_gels``, and stays the reference's.
"""
from __future__ import annotations

import math

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import dd as _dd
from dplasma_tpu_torch.kernels import quant as _quant
from dplasma_tpu_torch.observability import phases
from dplasma_tpu_torch.ops import blas3, norms
from dplasma_tpu_torch.utils import config as _cfg

#: supported working precisions, cheapest-to-strongest
PRECISIONS = ("int8", "bf16", "f32", "f32x2")

_F32 = torch.float32
_F64 = torch.float64


def ir_params(precision=None, max_iters=None, tol=None, eps=None):
    """Resolve the IR configuration: explicit args win, else the MCA
    ``ir.*`` tier. Returns ``(precision, max_iters, tol)`` with the
    auto tolerance expanded to ``100*eps`` (``eps`` defaults to f64
    unit roundoff)."""
    p = (precision if precision is not None
         else (_cfg.mca_get("ir.precision") or "f32")).lower()
    if p not in PRECISIONS:
        raise ValueError(f"ir.precision {p!r} not in {PRECISIONS}")
    n = max_iters if max_iters is not None \
        else _cfg.mca_get_int("ir.max_iters", 10)
    t = tol
    if t is None:
        t = _cfg.mca_get_float("ir.tol", 0.0)
    if t <= 0:
        t = 100.0 * (2.0 ** -52 if eps is None else eps)
    return p, max(int(n), 1), float(t)


def _round_wp(x, precision: str):
    """Round through the working precision's STORAGE width: f32 for
    every rung (int8 quantizes per update, not in storage), then bf16
    for the bf16 rung (held in f32 for the compute). The reference's
    cast rounds f64 -> f32 -> bf16 as torch's does, and flushes f32
    subnormals to signed zero (XLA runs f32 with denormals flushed), so
    this flushes them too: the working matrix is the reference's, bit
    for bit."""
    y = x.to(_F32)
    y = torch.where(torch.abs(y) < torch.finfo(_F32).tiny, y * 0, y)
    if precision == "bf16":
        return y.to(torch.bfloat16).to(_F32)
    return y


def _tile(dense, like: TileMatrix) -> TileMatrix:
    return TileMatrix.from_dense(dense, like.desc.mb, like.desc.nb,
                                 like.desc.dist)


def _maxabs(x):
    return torch.amax(torch.abs(x))


# ---------------------------------------------------------------------
# The refinement engine
# ---------------------------------------------------------------------

def ir_solve(x, *, residual, correct, backward, escalate, tol: float,
             max_iters: int):
    """The generic iterative-refinement engine: ``residual(x) -> r``
    (f64-equivalent), ``correct(r) -> d`` (working-precision solve, f64
    out), ``backward(r, x) -> scalar`` (normwise backward error),
    ``escalate() -> x`` (full-precision route; None disables).

    A host loop with early exit and divergence detection (a non-finite
    or non-contracting backward error ends it); when the budget runs out
    right after a correction, that x gets its own verdict. Returns ``(x,
    info)``: ``backward_errors`` (fixed length ``max_iters + 1``, padded
    with the finite "no verdict" −1, which also records a non-finite
    measurement), ``iterations`` (corrections applied), ``converged``,
    ``escalated``; host tensors."""
    bwds = []
    converged = False
    nsolves = 0
    prev = None
    for _ in range(max_iters):
        with phases.span("residual") as _f:
            r = _f(residual(x))
        bwd = float(backward(r, x))
        bwds.append(bwd)
        if bwd <= tol:
            converged = True
            break
        if bwd != bwd or (prev is not None and bwd >= prev):
            # divergence: stop burning iterations, escalation owns it
            break
        prev = bwd
        with phases.span("correct") as _f:
            x = _f(x + correct(r))
        nsolves += 1
    else:
        # budget exhausted right after a correction: a solve converging
        # at exactly max_iters steps is a convergence, not a divergence
        with phases.span("residual") as _f:
            r = _f(residual(x))
        bwd = float(backward(r, x))
        bwds.append(bwd)
        converged = bwd <= tol
    escalated = False
    if not converged and escalate is not None:
        with phases.span("escalate") as _f:
            x = _f(escalate())
        escalated = True
    hist = [b if math.isfinite(b) else -1.0 for b in bwds]
    hist += [-1.0] * (max_iters + 1 - len(hist))
    info = {"backward_errors": torch.tensor(hist, dtype=_F64),
            "iterations": torch.tensor(nsolves, dtype=torch.int32),
            "converged": torch.tensor(converged),
            "escalated": torch.tensor(escalated)}
    return x, info


def _refined(x, solve, residual, backward, tol: float, max_iters: int):
    """The escalation rung's answer: the full-precision solve ``x``,
    refined on the same exact residuals with the full-precision factor's
    ``solve`` (the same budget, no further escalation)."""
    return ir_solve(x, residual=residual, correct=solve, backward=backward,
                    escalate=None, tol=tol, max_iters=max_iters)[0]


def _backward_fn(anorm, bnorm, tiny):
    def backward(r, x):
        return _maxabs(r) / torch.clamp(anorm * _maxabs(x) + bnorm,
                                        min=tiny)
    return backward


def _eye32(n, device):
    return torch.eye(n, dtype=_F32, device=device)


def _factor_refine_chol(af, L32):
    """One f64-equivalent refinement step of a whole-matrix Cholesky
    factor on the bits=32 limb rung: E = A − L Lᵀ exact (one K2 launch
    on the card), correction L <- L (I + Φ(L^-1 E L^-T)) in f32. This IS
    the f32x2 working-precision factorization; returns L in f64."""
    L32 = torch.tril(L32)
    L = L32.to(_F64)
    E = _dd.gemm_residual(af, L, L.T, bits=32)
    Li = torch.linalg.solve_triangular(L32, _eye32(L32.shape[0], L.device),
                                       upper=False, left=True)
    M = torch.matmul(torch.matmul(Li, E.to(_F32)), Li.T)
    phi = torch.tril(M, -1) + 0.5 * torch.diag(torch.diag(M))
    corr = torch.matmul(L32, phi)
    return torch.tril(L + corr.to(_F64))


def _factor_refine_r(ad, R32):
    """One bits=32 refinement step of the QR ``R`` factor via its Gram
    identity Rᵀ R = Aᵀ A (the CholeskyQR2 correction, upper form): E =
    G − Rᵀ R exact, correction R <- (I + Φ(R^-T E R^-1)) R in f32; the
    f32x2 working R, in f64."""
    R32 = torch.triu(R32)
    R = R32.to(_F64)
    G = _dd.gemm_f64(ad.T, ad, bits=32)
    E = _dd.gemm_residual(G, R.T, R, bits=32)
    Ri = torch.linalg.solve_triangular(R32, _eye32(R32.shape[0], R.device),
                                       upper=True, left=True)
    M = torch.matmul(torch.matmul(Ri.T, E.to(_F32)), Ri)
    phi = torch.triu(M, 1) + 0.5 * torch.diag(torch.diag(M))
    corr = torch.matmul(phi, R32)
    return torch.triu(R + corr.to(_F64))


def _require_f64(A: TileMatrix, who: str):
    if A.dtype != _F64:
        raise TypeError(f"{who} refines to f64-equivalent accuracy: "
                        f"input must be float64, got {A.dtype}")


def _factor(prec: str, fn, *args):
    """Run the working-precision factorization ``fn(*args)``; the int8
    rung runs it under :func:`quant.update_scope`. Returns (result,
    collected guard residuals)."""
    if prec != "int8":
        return fn(*args), []
    with _quant.update_scope() as guards:
        return fn(*args), guards


def _with_guard(info, prec: str, guards):
    if prec == "int8":
        return dict(info, quant_guard_max=_quant.guard_max(guards))
    return info


# ---------------------------------------------------------------------
# User-facing solvers
# ---------------------------------------------------------------------

def posv_ir(A: TileMatrix, B: TileMatrix, uplo: str = "L", *,
            precision=None, max_iters=None, tol=None,
            escalate: bool = True):
    """SPD solve A X = B by Cholesky in a low working precision +
    iterative refinement to f64-equivalent backward error.

    ``A`` stores the ``uplo`` triangle (posv contract); returns ``(X,
    info)`` with ``X`` f64 and ``info`` the refinement record
    (:func:`summarize` turns it into the run record's ``"refine"``
    entry). ``escalate=False`` disables the full-precision fallback."""
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    _require_f64(A, "posv_ir")
    prec, iters, tol_ = ir_params(precision, max_iters, tol)
    af = norms._sym_full(A, uplo, conj=True)
    bd = B.to_dense().to(_F64)
    tiny = torch.finfo(_F64).tiny

    with phases.span("factor") as _f:
        Aw = _tile(_round_wp(af, prec), A)
        Lw, guards = _factor(prec, potrf_mod.potrf, Aw, "L")
        if prec == "bf16":
            Lw = Lw.like(_round_wp(Lw.data, prec))
        elif prec == "f32x2":
            Lw = _tile(_factor_refine_chol(af, Lw.to_dense()), A)
        _f(Lw.data)

    def solve_w(rhs):
        rw = rhs if prec == "f32x2" else _round_wp(rhs, prec)
        return potrf_mod.potrs(Lw, _tile(rw, B), "L").to_dense().to(_F64)

    def residual(xv):
        return _dd.gemm_residual(bd, af, xv)

    backward = _backward_fn(_maxabs(af), _maxabs(bd), tiny)

    def escalate_fn():
        L = potrf_mod.potrf(A, uplo)

        def solve(rhs):
            return potrf_mod.potrs(L, _tile(rhs, B), uplo).to_dense()

        return _refined(solve(bd), solve, residual, backward, tol_, iters)

    with phases.span("solve") as _f:
        x0 = _f(solve_w(bd))
    x, info = ir_solve(
        x0, residual=residual, correct=solve_w, backward=backward,
        escalate=escalate_fn if escalate else None,
        tol=tol_, max_iters=iters)
    return _tile(x, B), _with_guard(info, prec, guards)


def gesv_ir(A: TileMatrix, B: TileMatrix, *, precision=None,
            max_iters=None, tol=None, escalate: bool = True):
    """General solve A X = B by pivoted LU in a low working precision +
    iterative refinement to f64-equivalent backward error. Returns
    ``(X, info)`` (see :func:`posv_ir`). The factor is
    :func:`~dplasma_tpu_torch.ops.lu.getrf_ptgpanel` (the distributed
    panel under an active grid, else ``getrf_1d``); the f32x2 rung
    refines its L and U for the FIXED pivot order with one whole-matrix
    ``dd.lu_ir`` step at ``bits=32``."""
    from dplasma_tpu_torch.ops import lu as lu_mod
    _require_f64(A, "gesv_ir")
    prec, iters, tol_ = ir_params(precision, max_iters, tol)
    ad = A.to_dense().to(_F64)
    bd = B.to_dense().to(_F64)
    tiny = torch.finfo(_F64).tiny

    with phases.span("factor") as _f:
        Aw = _tile(_round_wp(ad, prec), A)
        (LUw, perm), guards = _factor(prec, lu_mod.getrf_ptgpanel, Aw)
        if prec == "bf16":
            LUw = LUw.like(_round_wp(LUw.data, prec))
        elif prec == "f32x2":
            pk = LUw.data
            L32 = torch.tril(pk, -1).to(_F64)
            L32.diagonal().fill_(1)
            U32 = torch.triu(pk).to(_F64)
            pp = A.pad_diag().data.to(_F64)[perm]
            L, U = _dd.lu_ir(pp, L32, U32, refine=1, bits=32)
            LUw = LUw.like(torch.triu(U) + torch.tril(L, -1))
        _f(LUw.data)

    def solve_w(rhs):
        rw = rhs if prec == "f32x2" else _round_wp(rhs, prec)
        return lu_mod.getrs("N", LUw, perm, _tile(rw, B)).to_dense().to(
            _F64)

    def residual(xv):
        return _dd.gemm_residual(bd, ad, xv)

    backward = _backward_fn(_maxabs(ad), _maxabs(bd), tiny)

    def escalate_fn():
        F, p = lu_mod.getrf_ptgpanel(A)

        def solve(rhs):
            return lu_mod.getrs("N", F, p, _tile(rhs, B)).to_dense()

        return _refined(solve(bd), solve, residual, backward, tol_, iters)

    with phases.span("solve") as _f:
        x0 = _f(solve_w(bd))
    x, info = ir_solve(
        x0, residual=residual, correct=solve_w, backward=backward,
        escalate=escalate_fn if escalate else None,
        tol=tol_, max_iters=iters)
    return _tile(x, B), _with_guard(info, prec, guards)


def gels_ir(A: TileMatrix, B: TileMatrix, *, precision=None,
            max_iters=None, tol=None, escalate: bool = True):
    """Overdetermined least squares min ||A X − B|| (M >= N) by QR in a
    low working precision + iterative refinement via SEMI-NORMAL
    equations on the R factor: each correction solves Rᵀ R d = Aᵀ r with
    two triangular sweeps, no Q (Björck's corrected semi-normal
    equations; the f32x2 rung's bits=32-refined R is the stabilizer).
    Convergence is measured on the PROJECTED residual ||Aᵀ r|| / (||A||
    (||A|| ||x|| + ||b||)). Returns ``(X, info)`` with ``X`` N-row
    f64."""
    from dplasma_tpu_torch.ops import qr as qr_mod
    _require_f64(A, "gels_ir")
    if A.desc.M < A.desc.N:
        raise ValueError("gels_ir: overdetermined (M >= N) only; use "
                         "ops.qr.gels")
    prec, iters, tol_ = ir_params(precision, max_iters, tol)
    N = A.desc.N
    ad = A.to_dense().to(_F64)
    bd = B.to_dense().to(_F64)[:A.desc.M]
    tiny = torch.finfo(_F64).tiny

    with phases.span("factor") as _f:
        Aw = _tile(_round_wp(ad, prec), A)
        (Afw, _), guards = _factor(prec, qr_mod.geqrf, Aw)
        r32 = torch.triu(Afw.to_dense()[:N, :N])
        if prec == "bf16":
            r32 = _round_wp(r32, prec)
        Rw = _tile(_factor_refine_r(ad, r32) if prec == "f32x2" else r32,
                   A)
        _f(Rw.data)

    def snd_solve(s):
        """d = R^-1 R^-T s by the blocked trsm."""
        St = _tile(s if prec == "f32x2" else _round_wp(s, prec), Rw)
        y = blas3.trsm(1.0, Rw, St, side="L", uplo="U", trans="T")
        d = blas3.trsm(1.0, Rw, y, side="L", uplo="U", trans="N")
        return d.to_dense().to(_F64)

    anorm = _maxabs(ad)
    bnorm = _maxabs(bd)

    def residual(xv):
        # projected residual s = Aᵀ (b − A x), both products limb
        # products
        return _dd.gemm_f64(ad.T, _dd.gemm_residual(bd, ad, xv))

    def backward(s, xv):
        return _maxabs(s) / torch.clamp(
            anorm * (anorm * _maxabs(xv) + bnorm), min=tiny)

    def escalate_fn():
        return qr_mod.gels(A, B).to_dense().to(_F64)[:N]

    # x0 from the semi-normal equations directly (Rᵀ R x = Aᵀ b)
    with phases.span("solve") as _f:
        x0 = _f(snd_solve(_dd.gemm_f64(ad.T, bd)))
    x, info = ir_solve(
        x0, residual=residual,
        correct=snd_solve, backward=backward,
        escalate=escalate_fn if escalate else None,
        tol=tol_, max_iters=iters)
    return _tile(x, B), _with_guard(info, prec, guards)


# ---------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------

def summarize(info, *, op: str, precision=None, tol=None) -> dict:
    """Fold a refinement ``info`` into the run record's ``"refine"``
    entry. ``precision`` defaults to the MCA resolution, not the solve's
    argument: pass it when the solve was given one."""
    prec, _, tol_ = ir_params(precision, None, tol)
    # -1 is the engine's "no verdict" padding (and the record of a
    # non-finite measurement); real backward errors are >= 0
    hist = [float(v) for v in info["backward_errors"].tolist() if v >= 0]
    out = {"op": op, "precision": prec,
           "iterations": int(info["iterations"]),
           "backward_errors": hist,
           "converged": bool(info["converged"]),
           "escalated": bool(info["escalated"]),
           "tol": tol_}
    if "quant_guard_max" in info:
        # int8 rung: the max ones-probe residual over the routed updates
        out["quant_guard_max"] = float(info["quant_guard_max"])
    return out
