"""Batched single-device execution paths: one call factors/solves a
whole stacked problem batch, each kernel site one launch for the batch.

Ports ``dplasma_tpu/serving/batched.py``. The serving workload is many
medium-size problems; dispatching each through the unbatched sweeps pays
one kernel launch per product per problem. Here the *same* tile sweeps
run under ``torch.func.vmap`` over a stacked batch ``(B, n, n)`` +
``(B, n, nrhs)``, as the reference runs them under ``jax.vmap``: every
torch op carries the batch dimension, and the two hand-written kernels
on the path are launched once per site for the whole batch — K1 (the
f32 update products, :func:`kernels.pallas_kernels.gemm_batched`) and K2
(the IR residuals' limb products,
:func:`kernels.pallas_dd.limb_product_base_batched`), each reached
through its custom op's vmap rule. One element's sweep is the unbatched
sweep, so a batch makes exactly one element's count of launches.

Correctness contract (tested): a batched op matches a Python loop of
the unbatched op element for element — bit for bit where the op sequence
is the same, and always within the ``check_solve`` backward-error gate.

Iterative refinement (``posv_ir``/``gesv_ir``) batches on the masked
loop of :func:`dplasma_tpu_torch.ops.refine.ir_solve` (``eager=False``,
the reference's traced mode): under vmap the convergence mask is per
batch element, so each problem stops updating on its own (``where``)
while stragglers keep refining, and each of the ``max_iters + 1``
residuals is one K2 launch for the batch. Escalation is OFF inside the
batch, as in the reference: one divergent element would charge everyone
the full-precision factorization. Divergence surfaces per element in
``info["converged"]`` and the service's per-request resilience ladder
escalates only the failed request (:mod:`.service`).

Padding semantics (the bucket contract of :mod:`.cache`): factor entry
points install the identity on the padded diagonal via
:meth:`TileMatrix.pad_diag`, so a problem padded from ``n`` to a bucket
``nB`` solves ``blkdiag(A, I) [x; y] = [b; 0]`` — ``x`` is exact and
``y = 0``. Partial pivoting may permute padding rows into the factor,
which is why :func:`getrf_batched` returns the *padded* factor.

K3 (``panel.kernel=pallas``) has no batched launch yet: a batched LU
under it raises (``ops.lu._base_lu``) instead of taking another panel.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from dplasma_tpu_torch.descriptors import TileDesc, TileMatrix

#: ops servable through the batched paths (service dispatch table)
OPS = ("posv", "gesv", "potrf", "getrf", "posv_ir", "gesv_ir")


def _tm(a, nb: int) -> TileMatrix:
    """One problem's dense tensor as a square-tiled TileMatrix (the
    per-element view under vmap — shapes here are UNBATCHED)."""
    return TileMatrix.from_dense(a, nb, nb)


def _check_stacked(A, B=None):
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"batched ops want (B, n, n) stacks, got "
                         f"{tuple(A.shape)}")
    if B is not None and (B.ndim != 3 or
                          tuple(B.shape[:2]) != tuple(A.shape[:2])):
        raise ValueError(f"rhs stack {tuple(B.shape)} does not match "
                         f"{tuple(A.shape)}")


# ---------------------------------------------------------------------
# Cholesky family
# ---------------------------------------------------------------------

def potrf_batched(A, nb: int, uplo: str = "L"):
    """Batched tile Cholesky: ``(B, n, n) -> (B, n, n)`` factors (the
    ``uplo`` triangle of each element is meaningful)."""
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    _check_stacked(A)

    def one(a):
        return potrf_mod.potrf(_tm(a, nb), uplo).to_dense()

    return vmap(one)(A)


def potrs_batched(L, B, nb: int, uplo: str = "L"):
    """Batched triangular solves from stacked Cholesky factors: the
    factor is re-tiled with a unit padded diagonal (``pad_diag``), so
    the backward sweep never divides by padding zeros."""
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    _check_stacked(L, B)

    def one(l, b):
        Lt = _tm(l, nb).pad_diag()
        return potrf_mod.potrs(Lt, _tm(b, nb), uplo).to_dense()

    return vmap(one)(L, B)


def posv_batched(A, B, nb: int, uplo: str = "L"):
    """Batched SPD factor+solve: ``(B, n, n), (B, n, nrhs) ->
    (B, n, nrhs)`` solutions."""
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    _check_stacked(A, B)

    def one(a, b):
        _, X = potrf_mod.posv(_tm(a, nb), _tm(b, nb), uplo)
        return X.to_dense()

    return vmap(one)(A, B)


# ---------------------------------------------------------------------
# LU family
# ---------------------------------------------------------------------

def getrf_batched(A, nb: int):
    """Batched pivoted LU: ``(B, n, n) -> ((B, Mp, Mp), (B, Mp))`` — the
    PADDED packed factors and pivot permutations (``A[perm] = LU``). The
    padding rows stay in the factor deliberately: partial pivoting may
    elect a unit padding row (see module docstring)."""
    from dplasma_tpu_torch.ops import lu as lu_mod
    _check_stacked(A)

    def one(a):
        F, perm = lu_mod.getrf_1d(_tm(a, nb))
        return F.data, perm

    return vmap(one)(A)


def getrs_batched(LUp, perm, B, nb: int, trans: str = "N"):
    """Batched pivoted solves from :func:`getrf_batched`'s padded
    factors: ``(B, Mp, Mp), (B, Mp), (B, n, nrhs) -> (B, n, nrhs)``."""
    from dplasma_tpu_torch.ops import lu as lu_mod
    if LUp.ndim != 3 or B.ndim != 3:
        raise ValueError(f"batched getrs wants stacks, got "
                         f"{tuple(LUp.shape)} {tuple(B.shape)}")
    n = B.shape[1]
    desc = TileDesc(n, n, nb, nb)
    if tuple(LUp.shape[1:]) != (desc.Mp, desc.Np):
        raise ValueError(f"factor stack {tuple(LUp.shape)} does not match "
                         f"{desc}")

    def one(f, p, b):
        X = lu_mod.getrs(trans, TileMatrix(f, desc), p, _tm(b, nb))
        return X.to_dense()

    return vmap(one)(LUp, perm, B)


def gesv_batched(A, B, nb: int):
    """Batched general factor+solve: ``(B, n, n), (B, n, nrhs) ->
    (B, n, nrhs)`` via partial-pivoted LU."""
    from dplasma_tpu_torch.ops import lu as lu_mod
    _check_stacked(A, B)

    def one(a, b):
        _, _, X = lu_mod.gesv_1d(_tm(a, nb), _tm(b, nb))
        return X.to_dense()

    return vmap(one)(A, B)


# ---------------------------------------------------------------------
# Mixed-precision IR solvers
# ---------------------------------------------------------------------

def posv_ir_batched(A, B, nb: int, *, precision=None, max_iters=None,
                    tol=None):
    """Batched mixed-precision SPD solve: factor each element in the
    working precision, refine to f64-equivalent on the masked loop —
    each batch element converges (and stops updating) independently.
    Returns ``(X, info)`` with every ``info`` leaf carrying a leading
    batch axis (``converged``: ``(B,)`` bools). No in-batch escalation
    (see module docstring)."""
    from dplasma_tpu_torch.ops import refine
    _check_stacked(A, B)

    def one(a, b):
        X, info = refine.posv_ir(_tm(a, nb), _tm(b, nb),
                                 precision=precision, max_iters=max_iters,
                                 tol=tol, escalate=False, eager=False)
        return X.to_dense(), info

    return vmap(one)(A, B)


def gesv_ir_batched(A, B, nb: int, *, precision=None, max_iters=None,
                    tol=None):
    """Batched mixed-precision general solve (pivoted LU factor +
    iterative refinement); contract as :func:`posv_ir_batched`."""
    from dplasma_tpu_torch.ops import refine
    _check_stacked(A, B)

    def one(a, b):
        X, info = refine.gesv_ir(_tm(a, nb), _tm(b, nb),
                                 precision=precision, max_iters=max_iters,
                                 tol=tol, escalate=False, eager=False)
        return X.to_dense(), info

    return vmap(one)(A, B)


def backward_errors(A, B, X):
    """Per-element normwise backward errors of a solved batch:
    ``max|b - A x| / (max(max|A|, 1) * max|x| + max|b|)``, one
    ``torch.matmul`` on the stack (the reference's plain ``jnp.matmul``)
    and reductions, on the device, so the host gate reads one scalar per
    request. The ``max(.., 1)`` clamp is the identity padding's
    contribution made explicit: padded operands carry 1.0 on the padded
    diagonal and the padded residual rows are exactly zero, so numerator
    and verdict are padding-invariant."""
    r = B - torch.matmul(A, X)
    num = torch.amax(torch.abs(r), dim=(-2, -1))
    den = (torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=1.0)
           * torch.amax(torch.abs(X), dim=(-2, -1))
           + torch.amax(torch.abs(B), dim=(-2, -1)))
    return num / torch.clamp(den, min=torch.finfo(A.dtype).tiny)


# ---------------------------------------------------------------------
# The service's uniform solve entry
# ---------------------------------------------------------------------

def solve_batched(op: str, A, B, nb: int, **kw):
    """Uniform ``(X, info|None)`` entry over every servable op — the
    single body the serving cache builds per bucket."""
    if op == "posv":
        return posv_batched(A, B, nb, **kw), None
    if op == "gesv":
        return gesv_batched(A, B, nb, **kw), None
    if op == "posv_ir":
        return posv_ir_batched(A, B, nb, **kw)
    if op == "gesv_ir":
        return gesv_ir_batched(A, B, nb, **kw)
    raise ValueError(f"unservable op {op!r} (choose from "
                     f"{[o for o in OPS if o not in ('potrf', 'getrf')]})")
