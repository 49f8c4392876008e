"""KT, the eigenvalues of a real symmetric tridiagonal matrix, on Hopper.

A kernel of the port with no Pallas counterpart: the reference finishes
``eig.heev`` (2stage) and ``eig.gesvd`` with
``jax.scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)``
(dplasma_tpu/ops/eig.py:205, :317), plain JAX, and no single PyTorch
call computes it. The algorithm is bisection on Sturm counts: one search
per eigenvalue index k, each level one length-n recurrence
q_i = α_i − β²_{i−1}/q_{i−1} − x counting the negative q_i, up to
``nmant + 1`` levels. In eager PyTorch that is n × levels sequential
launches, so KT is ``csrc/tridiag_bisect.cu``, CUDA C++ for ``sm_90a``,
one persistent launch per call. float32 and float64; complex d/e take
their real part and |e|² as the reference does.

The searches share one bisection tree: a node's shift 0.5·(lo + hi) is a
pure function of its path from the root, and so is its Sturm count.
The kernel first counts every node of the top ``depth`` levels (2^depth
− 1 sequences, all independent), then, after a grid barrier, each
search descends those levels reading the counts on its path and runs
rounds of ``s`` levels in which a group of lanes counts the 2^s − 1
nodes of the next s levels of its subtree at once and descends them,
one sequence a lane. (α_i, β²_{i−1}) are interleaved pairs held in
shared memory for the whole launch where they fit a block's 227 KB
(n <= 29056 in f32, 14528 in f64), else streamed through it in chunks.
:func:`plan` picks the three. Every search runs
``nmant + 1`` levels, so the value at an index is bitwise the bisection
run to that depth whatever the plan and whatever the other ``targets``.

The plain version :func:`eigh_tridiagonal_reference` repeats the
reference step for step: Gershgorin bounds, ``pivmin``,
``alpha0_perturbation``, the ``fudge`` = 2.1 widening, the Sturm step
with its ``pivmin`` clamp, ``counts <= target`` bisection and the global
stop max(upper − lower) <= eps·t_norm. The kernel runs every search to
``nmant + 1`` levels instead of the global stop: its levels up to that
stop are the plain version's, and each later one stays inside the
interval that stop left, so the two agree within eps·t_norm (bitwise
where the stop does not fire earlier, as on every tridiagonal the tests
and chip_smoke hold). The results ascend with k.

What bounds it: the dependent division chain of a Sturm sequence (the
top tree and each round take n chained steps) and, with enough
sequences in flight, the card's rate of divisions (PERF.md has the
numbers beside that bound).

``ROUTED`` counts :func:`eigh_tridiagonal` calls on any device,
``LAUNCHES`` the CUDA launches (one a call with n >= 2). A CPU tensor
takes the plain version; a CUDA tensor launches KT or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

ROUTED = 0
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.float64: 1}
#: threads per block of the kernel: one block an SM, so the pairs are
#: held once an SM
THREADS = 1024
#: bytes of shared memory one block may use (H100: 227 KB)
SMEM_MAX = 232448
#: the deepest top tree the kernel takes (2^20 int32 counts)
MAX_DEPTH = 20
_FN = None


class Plan(NamedTuple):
    """How one launch bisects: a top tree of ``depth`` levels, rounds of
    ``s`` levels, the pairs ``resident`` in shared memory (else streamed
    in chunks)."""
    depth: int
    s: int
    resident: bool


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
            max_levels(dt))


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
        w = d.real if d.is_complex() else d
        return w if targets is None else w[targets.long()]
    alpha, beta_sq, lower, upper, pivmin, a0p, abs_tol, max_it = setup(d, e)
    target = (torch.arange(n, dtype=torch.int32, device=d.device)
              if targets is None else targets)
    if target.shape[0] == 0:
        return alpha.new_empty(0)
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


def max_levels(dtype) -> int:
    """nmant + 1: the levels every search runs."""
    return np.finfo(np.float32 if dtype == torch.float32
                    else np.float64).nmant + 1


#: sequences a round aims to keep in flight: about half the card's
#: thread slots, where a round is still bound by the chain of divisions
#: and not by their issue (chip_smoke.py's plan timings, PERF.md §6)
ROUND_LANES = 1 << 16


def plan(n: int, m: int, dtype) -> Plan:
    """The launch's plan for m targets of an n × n tridiagonal: rounds
    of s levels, s the nearest (1 to 5) to log₂(ROUND_LANES / m); a top
    tree as deep as ⌈log₂ m⌉ (one node a target at its last level) plus
    the levels that would leave a short last round (a top-tree level
    costs 2^depth more sequences, all in flight at once; a round, n more
    chained steps); the pairs resident where they fit."""
    levels = max_levels(dtype)
    s = min(max(round(math.log2(ROUND_LANES / max(m, 1))), 1), 5)
    d0 = max(m - 1, 0).bit_length()
    depth = min(d0 + (levels - d0) % s, MAX_DEPTH, levels)
    isz = 4 if dtype == torch.float32 else 8
    return Plan(depth, s, 2 * n * isz <= SMEM_MAX)


def _kernel():
    global _FN
    if _FN is None:
        from dplasma_tpu_torch.kernels import _build
        fn = _build.load("tridiag_bisect").dtt_kt_tree
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                  ctypes.c_void_p])
        _FN = fn
    return _FN


def _launch(d, e, targets, pl: Optional[Plan] = None):
    global LAUNCHES
    n = d.shape[0]
    alpha, beta_sq, lower, upper, pivmin, a0p, _, max_it = setup(d, e)
    ab = torch.stack([alpha, torch.cat([beta_sq.new_zeros(1), beta_sq])],
                     dim=1).contiguous()
    params = torch.stack([lower, upper, pivmin, a0p]).contiguous()
    m = n if targets is None else targets.shape[0]
    out = torch.empty(m, dtype=alpha.dtype, device=d.device)
    if m == 0:
        return out
    pl = pl or plan(n, m, alpha.dtype)
    counts = bar = None
    if pl.depth > 0:
        counts = torch.empty(1 << pl.depth, dtype=torch.int32,
                             device=d.device)
        bar = torch.zeros(1, dtype=torch.int64, device=d.device)
    with torch.cuda.device(d.device):
        err = _kernel()(
            _DTYPES[alpha.dtype], n, max_it, ab.data_ptr(),
            params.data_ptr(),
            None if targets is None else targets.data_ptr(), m,
            out.data_ptr(), pl.depth, pl.s, int(pl.resident),
            None if counts is None else counts.data_ptr(),
            None if bar is None else bar.data_ptr(), THREADS,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"KT launch failed: error {err} (n={n}, m={m}, "
                           f"{alpha.dtype}, {pl})")
    LAUNCHES += 1
    return out


def _targets(targets, device, n: int):
    """``targets`` as a contiguous int32 tensor on ``device``, each in
    [0, n)."""
    if targets is None:
        return None
    t = torch.as_tensor(targets, device=device)
    if t.ndim != 1 or t.dtype.is_floating_point or t.is_complex():
        raise TypeError(f"KT targets: a 1-D integer tensor, got "
                        f"{tuple(t.shape)} {t.dtype}")
    if t.numel():
        lo, hi = (int(v) for v in torch.aminmax(t))
        if lo < 0 or hi >= n:
            raise ValueError(f"KT targets: indices in [0, {n}), got "
                             f"[{lo}, {hi}]")
    return t.to(torch.int32).contiguous()


def eigh_tridiagonal(d, e, targets=None):
    """Ascending eigenvalues of the real symmetric (or Hermitian, taken
    as |e|) tridiagonal matrix (d, e): KT on a CUDA tensor, the plain
    version on a CPU one. ``targets`` (integer indices in [0, n)) gives
    the eigenvalues at those indices only, in their order, each bitwise
    what the whole spectrum gives at that index."""
    global ROUTED
    if d.ndim != 1 or e.ndim != 1 or e.shape[0] != max(d.shape[0] - 1, 0):
        raise ValueError(f"KT takes d (n,) and e (n-1,), got "
                         f"{tuple(d.shape)} and {tuple(e.shape)}")
    if d.dtype != e.dtype or d.dtype not in (
            torch.float32, torch.float64, torch.complex64,
            torch.complex128):
        raise TypeError(f"KT takes matching f32/f64/c64/c128 d and e, got "
                        f"{d.dtype} and {e.dtype}")
    tg = _targets(targets, d.device, d.shape[0])
    ROUTED += 1
    if d.device.type == "cpu":
        return eigh_tridiagonal_reference(d, e, targets=tg)
    if d.device.type != "cuda":
        raise ValueError(f"KT runs on cuda (or cpu), not {d.device}")
    if d.shape[0] <= 1:
        w = d.real if d.is_complex() else d.clone()
        return w if tg is None else w[tg.long()]
    return _launch(d, e, tg)
