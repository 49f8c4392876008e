"""KT, the eigenvalues of a real symmetric tridiagonal matrix, on Hopper.

A kernel of the port with no Pallas counterpart: the reference finishes
``eig.heev`` (2stage) and ``eig.gesvd`` with
``jax.scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)``
(dplasma_tpu/ops/eig.py:205, :317), plain JAX, and no single PyTorch
call computes it. The algorithm is bisection on Sturm counts: one search
per eigenvalue index k, each iteration one length-n recurrence
q_i = α_i − β²_{i−1}/q_{i−1} − x counting the negative q_i, up to
``nmant + 1`` iterations. In eager PyTorch that is n × iterations
sequential launches, so KT is ``csrc/tridiag_bisect.cu``, CUDA C++ for
``sm_90a``: one thread per target count k, every thread bisecting its own
interval to ``nmant + 1`` iterations in ONE launch, α and β² streamed
through shared memory in chunks (every thread reads the same element:
each load is a broadcast). float32 and float64; complex d/e take their
real part and |e|² as the reference does.

The plain version :func:`eigh_tridiagonal_reference` repeats the
reference step for step: Gershgorin bounds, ``pivmin``,
``alpha0_perturbation``, the ``fudge`` = 2.1 widening, the Sturm step
with its ``pivmin`` clamp, ``counts <= target`` bisection and the global
stop max(upper − lower) <= eps·t_norm. The kernel runs every search to
``nmant + 1`` iterations instead of the global stop: its iterations up
to that stop are the plain version's, and each later one stays inside
the interval that stop left, so the two agree within eps·t_norm. The
results ascend with k.

What bounds it: the chain. Each thread's n·(nmant + 1) Sturm steps are
dependent divisions; n threads on n/64 blocks leave most of the card's
issue slots idle below n ~ 10⁴ (PERF.md has the numbers beside the
n²·(nmant+1) operations bound).

``ROUTED`` counts :func:`eigh_tridiagonal` calls on any device,
``LAUNCHES`` the CUDA launches. A CPU tensor takes the plain version; a
CUDA tensor launches KT or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

ROUTED = 0
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.float64: 1}
#: threads per block of the kernel
THREADS = 64
_FN = None


def reset_counts() -> None:
    global ROUTED, LAUNCHES
    ROUTED = 0
    LAUNCHES = 0


def _real_inputs(d, e):
    """(alpha, beta_abs, beta_sq) in the real dtype, as the reference
    derives them (complex: real part of d, |e|² as e·conj(e))."""
    if d.is_complex():
        alpha = d.real
        beta_sq = (e * e.conj()).real
        return alpha, torch.sqrt(beta_sq), beta_sq
    return d, e.abs(), e * e


def setup(d, e):
    """The scalars of the search: (alpha, beta_sq, lower, upper, pivmin,
    alpha0_perturbation, abs_tol, max_it), as tensors on d's device
    (no host synchronisation)."""
    alpha, beta_abs, beta_sq = _real_inputs(d, e)
    n = alpha.shape[0]
    finfo = np.finfo(np.float32 if alpha.dtype == torch.float32
                     else np.float64)
    dt = alpha.dtype
    row = torch.cat([beta_abs[:1], beta_abs[:-1] + beta_abs[1:],
                     beta_abs[-1:]])
    lmax = torch.amax(alpha + row)
    lmin = torch.amin(alpha - row)
    t_norm = torch.maximum(lmin.abs(), lmax.abs())
    one = np.ones([], dtype=finfo.dtype)
    safemin = np.maximum(one / finfo.max, (one + finfo.eps) * finfo.tiny)
    pivmin = float(safemin) * torch.clamp(torch.amax(beta_sq), min=1)
    alpha0_pert = torch.square(float(finfo.eps) * beta_abs[0])
    abs_tol = float(finfo.eps) * t_norm
    fudge = 2.1
    norm_slack = torch.tensor(n, dtype=dt, device=alpha.device) * fudge \
        * float(finfo.eps) * t_norm
    lower = lmin - norm_slack - 2 * fudge * pivmin
    upper = lmax + norm_slack + fudge * pivmin
    return (alpha, beta_sq, lower, upper, pivmin, alpha0_pert, abs_tol,
            finfo.nmant + 1)


def sturm_counts(alpha, beta_sq, pivmin, alpha0_pert, x):
    """The number of eigenvalues below each shift in ``x`` (the
    reference's ``_sturm``: its first step special-cases x = alpha[0])."""
    n = alpha.shape[0]
    q = alpha[0] - x
    count = (q < 0).to(torch.int32)
    q = torch.where(alpha[0] == x, alpha0_pert, q)
    neg = -pivmin
    for i in range(1, n):
        q = alpha[i] - beta_sq[i - 1] / q - x
        low = q <= pivmin
        count = count + low.to(torch.int32)
        q = torch.where(low, torch.minimum(q, neg), q)
    return count


def eigh_tridiagonal_reference(d, e, targets=None):
    """Plain KT: ascending eigenvalues of the symmetric tridiagonal
    matrix with diagonal ``d`` (n,) and off-diagonal ``e`` (n−1,), the
    reference's bisection step for step. One host synchronisation per
    iteration (the global stop). ``targets`` (int32, on d's device)
    bisects for those eigenvalue indices only (the searches are
    independent; the global stop then sees only theirs, which moves each
    result by at most eps·t_norm)."""
    n = d.shape[0]
    if n <= 1:
        return d.real if d.is_complex() else d
    alpha, beta_sq, lower, upper, pivmin, a0p, abs_tol, max_it = setup(d, e)
    target = (torch.arange(n, dtype=torch.int32, device=d.device)
              if targets is None else targets)
    lower = lower.expand(target.shape[0])
    upper = upper.expand(target.shape[0])
    mid = 0.5 * (upper + lower)
    i = 0
    while i < max_it and bool(abs_tol < torch.amax(upper - lower)):
        counts = sturm_counts(alpha, beta_sq, pivmin, a0p, mid)
        lower = torch.where(counts <= target, mid, lower)
        upper = torch.where(counts > target, mid, upper)
        mid = 0.5 * (lower + upper)
        i += 1
    return mid


def _kernel():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        _FN = _build.load("tridiag_bisect").dtt_kt_bisect
        _FN.restype = ctypes.c_int
    return _FN


def _launch(d, e):
    global LAUNCHES
    n = d.shape[0]
    alpha, beta_sq, lower, upper, pivmin, a0p, _, max_it = setup(d, e)
    alpha = alpha.contiguous()
    beta_sq = torch.cat([beta_sq, beta_sq.new_zeros(1)]).contiguous()
    params = torch.stack([lower, upper, pivmin, a0p]).contiguous()
    out = torch.empty(n, dtype=alpha.dtype, device=d.device)
    with torch.cuda.device(d.device):
        err = _kernel()(ctypes.c_int(_DTYPES[alpha.dtype]), ctypes.c_int(n),
                        ctypes.c_int(max_it),
                        ctypes.c_void_p(alpha.data_ptr()),
                        ctypes.c_void_p(beta_sq.data_ptr()),
                        ctypes.c_void_p(params.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()),
                        ctypes.c_int(THREADS),
                        ctypes.c_void_p(
                            torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"KT launch failed: cudaError {err} (n={n}, "
                           f"{alpha.dtype})")
    LAUNCHES += 1
    return out


def eigh_tridiagonal(d, e):
    """Ascending eigenvalues of the real symmetric (or Hermitian, taken
    as |e|) tridiagonal matrix (d, e): KT on a CUDA tensor, the plain
    version on a CPU one."""
    global ROUTED
    if d.ndim != 1 or e.ndim != 1 or e.shape[0] != max(d.shape[0] - 1, 0):
        raise ValueError(f"KT takes d (n,) and e (n-1,), got "
                         f"{tuple(d.shape)} and {tuple(e.shape)}")
    if d.dtype != e.dtype or d.dtype not in (
            torch.float32, torch.float64, torch.complex64,
            torch.complex128):
        raise TypeError(f"KT takes matching f32/f64/c64/c128 d and e, got "
                        f"{d.dtype} and {e.dtype}")
    ROUTED += 1
    if d.device.type == "cpu":
        return eigh_tridiagonal_reference(d, e)
    if d.device.type != "cuda":
        raise ValueError(f"KT runs on cuda (or cpu), not {d.device}")
    if d.shape[0] <= 1:
        return d.real if d.is_complex() else d.clone()
    return _launch(d, e)
