"""Random Butterfly Transform (RBT) — pivoting avoidance.

Ports ``dplasma_tpu/ops/rbt.py`` (:31-154): ``dplasma_zhebut`` /
``dplasma_zgebut`` / ``dplasma_zgebmm`` (zhebut.jdf, zgebut.jdf,
zgebmm.jdf) with ``butterfly_map.c``'s recursive two-level segmentation
and the per-level random diagonals of ``parsec_rbt_calculate_constants``
(zhebut_wrapper.c:110-143). The transform Ã = U^T A U (Hermitian) /
U^T A V (general) randomizes A so the factorization after it needs no
pivoting.

A depth-d butterfly is d levels of segment-halving mixes — each level
one scale and one pairwise add/sub over rows, elementwise work. The
random diagonals are drawn on the host with numpy from the seed, as the
reference draws them (bitwise the same constants), then moved to the
operand's device. Segmentation of odd sizes keeps the unpaired middle
row as a pass-through. U is real orthogonal-up-to-scaling with
U^{-1} = R^{-1} S (S is involutive), so solves replay cheaply.
``hesv_rbt``'s factorization is ``ldl.hetrf`` and its refinement
residuals ``blas.dot`` products (K1 / K2 where eligible).
"""
from __future__ import annotations

import numpy as np
import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.ops import ldl

_SQRT2 = np.sqrt(2.0)


def _rdiag(seed: int, lvl: int, idx: int, n: int):
    """Deterministic random diagonal for one segment (a host constant,
    like the reference's rbt constants): exp(u/10)/sqrt(2) with
    u ~ U[-1, 1]."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed & 0x7FFFFFFF, lvl, idx]))
    return np.exp(rng.uniform(-1.0, 1.0, size=n) * 0.1) / _SQRT2


def _rows_apply(x, seed: int, depth: int, mode: str):
    """Apply U (mode 'N'), U^T (mode 'T') or U^{-1} (mode 'I') to the
    rows of x. U = S·R recursively: U = B ∘ blockdiag(U₁, U₂)."""
    assert mode in ("N", "T", "I")

    def const(lvl, idx, n):
        return torch.as_tensor(_rdiag(seed, lvl, idx, n)).to(
            dtype=x.dtype, device=x.device)

    def coarse(seg, lvl, idx, n):
        h1 = (n + 1) // 2
        h2 = n - h1
        if h2 == 0:
            return seg
        r1 = const(lvl, 2 * idx, h1)
        r2 = const(lvl, 2 * idx + 1, h2)
        if mode == "I":
            # paired rows invert through S^{-1} = S/2; the unpaired
            # middle pass-through row inverts as 1/r alone
            r1 = torch.cat([1.0 / (2.0 * r1[:h2]), 1.0 / r1[h2:]])
            r2 = 1.0 / (2.0 * r2)

        def mix(top, bot):
            t, b = top[:h2], bot
            return torch.cat([t + b, top[h2:]], dim=0), t - b

        top, bot = seg[:h1], seg[h1:]
        if mode == "N":        # S (R seg)
            top = top * r1[:, None]
            bot = bot * r2[:, None]
            top, bot = mix(top, bot)
        else:                  # R (S seg) — S is symmetric/involutive
            top, bot = mix(top, bot)
            top = top * r1[:, None]
            bot = bot * r2[:, None]
        return torch.cat([top, bot], dim=0)

    def rec(seg, lvl, idx, n):
        if lvl >= depth or n < 2:
            return seg
        h1 = (n + 1) // 2
        if mode == "N":
            s1 = rec(seg[:h1], lvl + 1, 2 * idx, h1)
            s2 = rec(seg[h1:], lvl + 1, 2 * idx + 1, n - h1)
            return coarse(torch.cat([s1, s2], dim=0), lvl, idx, n)
        seg = coarse(seg, lvl, idx, n)
        s1 = rec(seg[:h1], lvl + 1, 2 * idx, h1)
        s2 = rec(seg[h1:], lvl + 1, 2 * idx + 1, n - h1)
        return torch.cat([s1, s2], dim=0)

    return rec(x, 0, 0, x.shape[0])


def gebmm(B: TileMatrix, seed: int = 3872, depth: int = 2,
          trans: str = "N") -> TileMatrix:
    """Multiply rows of B by the butterfly: op(U) B (dplasma_zgebmm).

    The butterfly is sized to the TRUE row count M (the reference's
    butterfly_map segments the actual matrix, not the tile grid);
    padding rows pass through untouched.
    """
    M = B.desc.M
    X = B.zero_pad().data.clone()
    X[:M, :] = _rows_apply(X[:M, :], seed, depth, trans)
    return B.like(X)


def hebut(A: TileMatrix, seed: int = 3872, depth: int = 2) -> TileMatrix:
    """Two-sided Hermitian butterfly Ã = U^T A U (dplasma_zhebut).
    U is real, so hermitian-ness is preserved."""
    N = A.desc.M
    X = A.zero_pad().data.clone()
    sub = _rows_apply(X[:N, :N], seed, depth, "T")
    X[:N, :N] = _rows_apply(sub.mH, seed, depth, "T").mH
    return A.like(X)


def gebut(A: TileMatrix, seed_u: int = 3872, seed_v: int = 2354,
          depth: int = 2) -> TileMatrix:
    """General two-sided butterfly Ã = U^T A V (dplasma_zgebut)."""
    M, N = A.desc.M, A.desc.N
    X = A.zero_pad().data.clone()
    sub = _rows_apply(X[:M, :N], seed_u, depth, "T")
    # A·V = (V^T A^T)^T — column application is mode "T" on the transpose
    X[:M, :N] = _rows_apply(sub.T, seed_v, depth, "T").T
    return A.like(X)


def hesv_rbt(A: TileMatrix, B: TileMatrix, uplo: str = "L",
             seed: int = 3872, depth: int = 2, refine: int = 2):
    """Solve a Hermitian-indefinite system without pivoting via
    RBT + LDL^H (the reference's hebut → hetrf → backtransform flow,
    tests/testing_zhebut.c): Ã = U^T A U; x = U Ã^{-1} U^T b.
    A must store BOTH triangles (or be densified by the caller) since
    the butterfly mixes them.

    ``refine`` steps of iterative refinement against the ORIGINAL A
    recover the accuracy the pivot-free factorization gives up to
    element growth. Returns (factor, X)."""
    At = hebut(A, seed, depth)
    F = ldl.hetrf(At, uplo)

    def solve(rhs):
        y = gebmm(rhs, seed, depth, trans="T")
        return gebmm(ldl.hetrs(F, y), seed, depth, trans="N")

    X = solve(B)
    a = A.zero_pad().data
    for _ in range(max(refine, 0)):
        R = B.like(B.zero_pad().data - k.dot(a, X.data))
        X = X.like(X.data + solve(R).data)
    return F, X
