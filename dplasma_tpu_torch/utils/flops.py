"""LAWN-41 floating-point operation counts.

A copy of ``dplasma_tpu/utils/flops.py`` (the port imports nothing of
the JAX package); values are exactly equal. Reference:
``src/flops.h:12-22`` — per-run GFLOPS is ``flops/1e9 / time``
(tests/common.h:136-145). Complex counts as 6*FMULS + 2*FADDS, real as
FMULS + FADDS.
"""
from __future__ import annotations


def _total(fmuls: float, fadds: float, complex_: bool) -> float:
    return 6.0 * fmuls + 2.0 * fadds if complex_ else fmuls + fadds


def gemm(m, n, k, complex_=False):
    return _total(m * n * k, m * n * k, complex_)


def symm(side, m, n, complex_=False):
    k = m if side == "L" else n
    return _total(k * m * n, k * m * n, complex_)


def syrk(k, n, complex_=False):
    f = 0.5 * k * n * (n + 1)
    return _total(f, f, complex_)


def syr2k(k, n, complex_=False):
    f = k * n * n
    return _total(f, f + n, complex_)


def trmm(side, m, n, complex_=False):
    if side == "L":
        return _total(0.5 * n * m * (m + 1), 0.5 * n * m * (m - 1), complex_)
    return _total(0.5 * m * n * (n + 1), 0.5 * m * n * (n - 1), complex_)


def trsm(side, m, n, complex_=False):
    return trmm(side, m, n, complex_)


def potrf(n, complex_=False):
    return _total(n ** 3 / 6 + n ** 2 / 2 + n / 3,
                  n ** 3 / 6 - n / 6, complex_)


def potri(n, complex_=False):
    return trtri(n, complex_) + lauum(n, complex_)


def trtri(n, complex_=False):
    return _total(n ** 3 / 6 + n ** 2 / 2 + n / 3,
                  n ** 3 / 6 - n ** 2 / 2 + n / 3, complex_)


def lauum(n, complex_=False):
    return potrf(n, complex_)


def getrf(m, n, complex_=False):
    mn = min(m, n)
    fmuls = 0.5 * m * n * mn - mn ** 3 / 6 + 0.5 * m * mn \
        - 0.5 * mn * n + 2 * mn / 3
    fadds = 0.5 * m * n * mn - mn ** 3 / 6 - 0.5 * m * mn + mn / 6
    return _total(fmuls, fadds, complex_)


def getrs(n, nrhs, complex_=False):
    return _total(nrhs * n * n, nrhs * n * (n - 1), complex_)


def potrs(n, nrhs, complex_=False):
    return _total(nrhs * n * (n + 1), nrhs * n * (n - 1), complex_)


def geqrf(m, n, complex_=False):
    if m >= n:
        fmuls = n * (n * (0.5 - n / 3 + m) + m + 23 / 6)
        fadds = n * (n * (0.5 - n / 3 + m) + 5 / 6)
    else:
        fmuls = m * (m * (-0.5 - m / 3 + n) + 2 * n + 23 / 6)
        fadds = m * (m * (-0.5 - m / 3 + n) + n + 5 / 6)
    return _total(fmuls, fadds, complex_)


def gelqf(m, n, complex_=False):
    return geqrf(n, m, complex_)


def ungqr(m, n, k, complex_=False):
    fmuls = k * (2 * m * n - (m + n) * k + 2 * k ** 2 / 3 + 2 * n - k - 5 / 3)
    fadds = k * (2 * m * n - (m + n) * k + 2 * k ** 2 / 3 + n - m + 1 / 3)
    return _total(fmuls, fadds, complex_)


def unmqr(side, m, n, k, complex_=False):
    if side == "L":
        fmuls = 2 * n * m * k - n * k ** 2 + 2 * n * k
        fadds = 2 * n * m * k - n * k ** 2 + n * k
    else:
        fmuls = 2 * n * m * k - m * k ** 2 + m * k + n * k - 0.5 * k ** 2 + 0.5 * k
        fadds = 2 * n * m * k - m * k ** 2 + m * k
    return _total(fmuls, fadds, complex_)


def gebrd(m, n, complex_=False):
    mn = min(m, n)
    fmuls = mn * (mn * (2 * max(m, n) - 2 * mn / 3) + 2 * max(m, n))
    fadds = mn * (mn * (2 * max(m, n) - 2 * mn / 3) + max(m, n))
    return _total(fmuls, fadds, complex_)


def heev(n, complex_=False):
    # two-stage reduction + tridiagonal solve, leading order 4/3 n^3
    return _total(2 * n ** 3 / 3, 2 * n ** 3 / 3, complex_)


def hetrf(n, complex_=False):
    return _total(n ** 3 / 6, n ** 3 / 6, complex_)
