"""Special test-matrix generators: the ``pltmg`` catalogue and
``latms``.

Ports ``dplasma_tpu/ops/matgen.py`` (:28-463): ``dplasma_zpltmg`` with
the dplasmaMatrix* types (ref src/include/dplasma/constants.h:164-203,
src/zpltmg_wrapper.c) and ``dplasma_zlatms`` (src/zlatms_wrapper.c).
Every generator is a closed-form elementwise map of the global indices
(or of seeded vectors drawn from the generators' hash), so its values do
not depend on tiling or device.

Integer and hash arithmetic is bitwise the reference's (the hash through
``ops.generators._hash2d``; index arithmetic in int64, as the reference
runs under x64). Closed forms round as the reference's in the same
dtype where they are one correctly rounded operation away from exact
integers; the transcendental ones (``orthog``, ``kms``, ``toeppd``,
``demmel``, ``chebvand``) and the sums (``house``, ``toeppd``) may
differ in the last bits. ``house``, ``condex`` and ``latms`` take
``torch.linalg.qr`` where the reference takes ``jnp.linalg.qr``: a QR is
unique up to the signs of Q's columns, so ``condex``'s projector
``Q Qᴴ`` is the reference's within rounding while ``latms``'s factors
are only the same in their singular values and orthogonality.
"""
from __future__ import annotations

import math

import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.descriptors import Dist, TileDesc, TileMatrix
from dplasma_tpu_torch.ops.generators import _grid, _uniform, _value, plrnt


def _setup(M, N, mb, nb, dist, device):
    d = TileDesc(M, N, mb, nb, dist)
    dev = resolve_device(device)
    r, c = _grid(d, dev)
    return d, r, c


def _rdtype(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def _finish(desc, v, dtype):
    """The (M, N) region of ``v`` cast to ``dtype``, zeros in the pad."""
    v = v.expand(desc.Mp, desc.Np)
    out = torch.zeros((desc.Mp, desc.Np), dtype=dtype, device=v.device)
    out[:desc.M, :desc.N] = v[:desc.M, :desc.N]
    return TileMatrix(out, desc)


def _randvec(n, seed, dtype, device):
    """Seeded random vector (U(-0.5, 0.5)), the analog of the reference's
    workspace V vectors fed to the genvect JDFs."""
    i = torch.arange(n, device=device)
    return _value(seed, i, torch.zeros_like(i), dtype)


def _square(M, N, who):
    if M != N:
        raise ValueError(f"{who} requires a square matrix, got {M}x{N}")


def _div(x, d):
    """x / d for a Python number d, correctly rounded on every device:
    on the card torch turns a division by a host scalar into a product
    with its reciprocal, one rounding more than the reference's
    division (chebvand's arccos near 1 magnifies that ulp 10^5 times)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _where(cond, a, b, dtype):
    dev = cond.device
    return torch.where(cond, torch.as_tensor(a, dtype=dtype, device=dev),
                       torch.as_tensor(b, dtype=dtype, device=dev))


# -- elementwise closed forms -----------------------------------------

def hadamard(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
             device=None):
    """H(i,j) = (-1)^popcount(i & j); N a power of two
    (core_zpltmg.c PlasmaMatrixHadamard)."""
    _square(M, N, "hadamard")
    if M & (M - 1):
        raise ValueError("hadamard requires a power-of-two size")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    x = (r & c) & 0xFFFFFFFF
    for s in (16, 8, 4, 2, 1):          # the popcount's parity, folded
        x = x ^ (x >> s)
    v = 1.0 - 2.0 * (x & 1).to(_rdtype(dtype))
    return _finish(d, v, dtype)


def parter(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """A(i,j) = 1/(i - j + 0.5): Toeplitz/Cauchy, singular values near
    pi."""
    _square(M, N, "parter")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    v = 1.0 / (r.to(rd) - c.to(rd) + 0.5)
    return _finish(d, v, dtype)


def ris(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
        device=None):
    """A(i,j) = 0.5/(N - i - j - 0.5) (F.N. Ris; eigenvalues cluster
    around +-pi/2)."""
    _square(M, N, "ris")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    v = 0.5 / (N - r.to(rd) - c.to(rd) - 0.5)
    return _finish(d, v, dtype)


def kms(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
        rho=0.5, device=None):
    """Kac-Murdock-Szego Toeplitz: A(i,j) = rho^|i-j| (SPD for
    0 < |rho| < 1)."""
    _square(M, N, "kms")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    v = torch.pow(torch.tensor(rho, dtype=rd, device=r.device),
                  (r - c).abs().to(rd))
    return _finish(d, v, dtype)


def moler(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
          device=None):
    """SPD U^T U with U unit upper triangular of -1s: diagonal i+1,
    off-diagonal min(i,j) - 1 (0-based)."""
    _square(M, N, "moler")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    v = torch.where(r == c, r + 1, torch.minimum(r, c) - 1)
    return _finish(d, v.to(_rdtype(dtype)), dtype)


def riemann(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
            device=None):
    """B(2:n+1, 2:n+1) with B(i,j) = i-1 if i | j else -1."""
    _square(M, N, "riemann")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    ii, jj = r + 2, c + 2
    v = torch.where(jj % ii == 0, ii - 1, -1)
    return _finish(d, v.to(_rdtype(dtype)), dtype)


def lehmer(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """SPD A(i,j) = min(i,j)/max(i,j) (1-based)."""
    _square(M, N, "lehmer")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    v = (torch.minimum(r, c) + 1).to(rd) / (torch.maximum(r, c) + 1).to(rd)
    return _finish(d, v, dtype)


def minij(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
          device=None):
    """SPD A(i,j) = min(i,j) (1-based)."""
    _square(M, N, "minij")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    return _finish(d, (torch.minimum(r, c) + 1).to(_rdtype(dtype)), dtype)


def invhess(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
            device=None):
    """gallery('invhess', 1:n): lower triangle j+1, strict upper -(i+1);
    inverse is upper Hessenberg."""
    _square(M, N, "invhess")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    v = torch.where(c <= r, c + 1, -(r + 1))
    return _finish(d, v.to(_rdtype(dtype)), dtype)


def cauchy(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """C(i,j) = 1/(i + j) with 1-based indices."""
    _square(M, N, "cauchy")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    v = 1.0 / (r.to(rd) + c.to(rd) + 2.0)
    return _finish(d, v, dtype)


def hilb(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
         device=None):
    """Hilbert matrix H(i,j) = 1/(i + j - 1) (1-based)."""
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    v = 1.0 / (r.to(rd) + c.to(rd) + 1.0)
    return _finish(d, v, dtype)


def lotkin(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """Hilbert with first row set to ones; ill-conditioned,
    nonsymmetric."""
    A = hilb(M, N, mb, nb, seed, dtype, dist, device)
    A.data[0, :] = 1.0
    return A.zero_pad()


def orthog(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """Orthogonal eigenvector matrix of the second-difference matrix:
    Q(i,j) = sqrt(2/(n+1)) sin((i+1)(j+1) pi / (n+1))."""
    _square(M, N, "orthog")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    scale = math.pi / (N + 1.0)
    v = math.sqrt(2.0 / (N + 1.0)) * torch.sin(
        (r + 1).to(rd) * (c + 1).to(rd) * scale)
    return _finish(d, v, dtype)


def wilkinson(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
              device=None):
    """Wilkinson eigenvalue test matrix W_n: symmetric tridiagonal,
    diagonal (n - 2 min(i, n-1-i) - 1)/2, off-diagonals 1."""
    _square(M, N, "wilkinson")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    diag = ((N - 2 * torch.minimum(r, N - 1 - r) - 1).to(torch.float64)
            / 2.0).to(rd)
    v = torch.where(r == c, diag, torch.zeros((), dtype=rd,
                                              device=r.device))
    v = torch.where((r - c).abs() == 1, torch.ones((), dtype=rd,
                                                   device=r.device), v)
    return _finish(d, v, dtype)


def foster(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """Foster's pathological case for partial-pivoting LU (k=h=c=1)."""
    _square(M, N, "foster")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    kh = 1.0  # k*h with the reference defaults k=h=c=1
    v = torch.zeros((d.Mp, d.Np), dtype=rd, device=r.device)
    v = torch.where(r > c, torch.tensor(-kh, dtype=rd, device=r.device), v)
    v = torch.where(c == 0, torch.tensor(-kh / 2.0, dtype=rd,
                                         device=r.device), v)
    v = torch.where(c == N - 1, torch.tensor(-1.0, dtype=rd,
                                             device=r.device), v)
    diag = torch.where(c == 0, torch.tensor(1.0, dtype=rd, device=r.device),
                       _where(c == N - 1, 1.0 - 1.0 - kh / 2.0,
                              1.0 - kh / 2.0, rd))
    v = torch.where(r == c, diag, v)
    return _finish(d, v, dtype)


def wright(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           device=None):
    """Wright's pathological case for partial-pivoting LU (h=0.01,
    two-step exponential-integrator structure)."""
    _square(M, N, "wright")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)

    def put(cond, val, v):
        return torch.where(cond, torch.tensor(val, dtype=rd,
                                              device=r.device), v)

    v = _where(r == c, 1.0, 0.0, rd)
    v = put((r == c + 2) & (c % 2 == 0), -0.9048, v)
    v = put((r == c + 3) & (c % 2 == 0), -1.2092, v)
    v = put((r == c + 2) & (c % 2 == 1), -0.8270, v)
    v = put((r == c + 3) & (c % 2 == 1), -1.3499, v)
    v = put((c == M - 2) & (r == 0), 1.0, v)
    v = put((c == M - 1) & (r == 1), 1.0, v)
    return _finish(d, v, dtype)


def dorr(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
         theta=0.01, device=None):
    """Dorr matrix: row-diagonally-dominant ill-conditioned tridiagonal
    (core_zpltmg.c PlasmaMatrixDorr, theta default 0.01)."""
    _square(M, N, "dorr")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    h = 1.0 / (N + 1.0)
    term = theta / (h * h)
    half = (N + 1) // 2
    jj = c.to(rd)
    first = c < half
    # column jj: above-diagonal (r == c-1), diagonal, below (r == c+1)
    above = torch.where(first | (c == half),
                        -term - _div(0.5 - jj * h, h),
                        torch.tensor(-term, dtype=rd, device=c.device))
    diag = torch.where(first, 2.0 * term + _div(0.5 - (jj + 1.0) * h, h),
                       2.0 * term - _div(0.5 - (jj + 1.0) * h, h))
    below = torch.where(first & (c + 1 != half),
                        torch.tensor(-term, dtype=rd, device=c.device),
                        -term + _div(0.5 - (jj + 2.0) * h, h))
    v = torch.zeros((d.Mp, d.Np), dtype=rd, device=c.device)
    v = torch.where(r == c - 1, above, v)
    v = torch.where(r == c, diag, v)
    v = torch.where(r == c + 1, below, v)
    return _finish(d, v, dtype)


# -- seeded-vector forms ----------------------------------------------

def fiedler(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
            device=None):
    """A(i,j) = |c(i) - c(j)| with seeded random c
    (zpltmg_fiedler.jdf)."""
    _square(M, N, "fiedler")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    n = max(d.Mp, d.Np)
    idx = torch.arange(n, device=r.device)
    vvec = _uniform(seed, idx, torch.zeros_like(idx), _rdtype(dtype))
    v = (vvec[:d.Mp, None] - vvec[None, :d.Np]).abs()
    return _finish(d, v, dtype)


def hankel(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
           device=None):
    """Symmetric Hankel from a seeded vector: A(i,j) = v(i+j)
    (zpltmg_hankel.jdf)."""
    d, r, c = _setup(M, N, mb, nb, dist, device)
    vvec = _randvec(d.Mp + d.Np, seed, dtype, r.device)
    return _finish(d, vvec[r + c], dtype)


def circul(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
           device=None):
    """Circulant of a seeded random first column: A(i,j) =
    v((j - i) mod N) (core_zpltmg_circul.c)."""
    _square(M, N, "circul")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    vvec = _randvec(M, seed, dtype, r.device)
    return _finish(d, vvec[(c - r + M) % M], dtype)


def compan(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
           device=None):
    """Companion-form matrix of a seeded random polynomial: ones on the
    subdiagonal, first row u(2:n)/u(1) with the leading entry zeroed —
    the reference's (unnegated) variant (core_zpltmg.c
    PlasmaMatrixCompan)."""
    _square(M, N, "compan")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    u = _randvec(N + 1, seed, dtype, r.device)
    row0 = u[1:] / u[0]
    row0[0] = 0
    v = _where(r == c + 1, 1.0, 0.0, row0.dtype)
    v[0, :] = 0
    v[0, :N] = row0[:N]
    return _finish(d, v, dtype)


def toeppd(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
           terms: int | None = None, device=None):
    """SPD Toeplitz: A(i,j) = sum_k w_k cos(t_k (i-j)) with seeded
    w in (0,1), t in (0, 2 pi) (core_zpltmg_toeppd.c)."""
    _square(M, N, "toeppd")
    d, r, c = _setup(M, N, mb, nb, dist, device)
    m = terms if terms is not None else N
    rd = _rdtype(dtype)
    idx = torch.arange(m, device=r.device)
    zero = torch.zeros_like(idx)
    w = _uniform(seed, idx, zero, rd) + 0.5
    t = 2.0 * math.pi * (_uniform(seed, idx, zero + 1, rd) + 0.5)
    # Toeplitz: the value depends only on the lag k = i - j in (-N, N)
    lags = torch.arange(-(d.Mp - 1), d.Np, device=r.device).to(rd)
    prof = (w[None, :] * torch.cos(lags[:, None] * t[None, :])).sum(dim=1)
    return _finish(d, prof[(r - c) + (d.Mp - 1)], dtype)


def demmel(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
           device=None):
    """Row-graded random matrix after Demmel: A(i,j) = r(i,j) *
    10^(14 i / n) * (1 if i == j else 1e-7), r seeded random — the
    reference's variant (core_zpltmg.c PlasmaMatrixDemmel scales the
    random diagonal by dii, not 1 + 1e-7 r)."""
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    rand = _value(seed, r, c, dtype)
    dii = torch.pow(torch.tensor(10.0, dtype=rd, device=r.device),
                    _div(14.0 * r.to(rd), M))
    v = rand * dii.to(rand.dtype) * _where(r == c, 1.0, 1e-7, rand.dtype)
    return _finish(d, v, dtype)


def chebvand(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
             device=None):
    """Chebyshev-Vandermonde: A(i,j) = T_i(p_j) at points
    p = linspace(0, 1, N), by the closed form T_i(x) = cos(i arccos x)
    on [0, 1] (the reference's zpltmg_chebvand.jdf runs the three-term
    row recurrence)."""
    d, r, c = _setup(M, N, mb, nb, dist, device)
    rd = _rdtype(dtype)
    p = _div(c.to(rd), max(N - 1, 1))
    v = torch.cos(r.to(rd) * torch.arccos(torch.clamp(p, 0.0, 1.0)))
    return _finish(d, v, dtype)


def langou(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
           device=None):
    """Random matrix with columns N/4..N/2 scaled by eps — fails plain
    partial pivoting, recovered by the hybrid LU/QR (getrf_qrf)
    (core_zpltmg.c final case)."""
    d, r, c = _setup(M, N, mb, nb, dist, device)
    v = _value(seed, r, c, dtype)
    eps = torch.finfo(_rdtype(dtype)).eps
    v = v * _where((c >= N // 4) & (c < N // 2), eps, 1.0, v.dtype)
    return _finish(d, v, dtype)


# -- QR-built forms ----------------------------------------------------

def house(M, N, mb, nb, seed=3872, dtype=torch.float32, dist=Dist(),
          device=None):
    """Householder reflector of a seeded random vector:
    A = I - tau v v^H (dplasma_zpltmg_house)."""
    _square(M, N, "house")
    dev = resolve_device(device)
    x = _randvec(M, seed, dtype, dev)
    alpha = x[0]
    sigma = torch.vdot(x[1:], x[1:]).real
    nrm = torch.sqrt(alpha.abs() ** 2 + sigma)
    # real beta, as LAPACK zlarfg: H stays unitary for complex x
    beta = torch.where(alpha.real >= 0, -nrm, nrm).to(x.dtype)
    v = x.clone()
    v[0] = alpha - beta
    tau = (beta - alpha) / beta
    vn = v / v[0]
    eye = torch.eye(M, dtype=dtype, device=dev)
    mat = eye - tau * torch.outer(vn, vn.conj())
    return TileMatrix.from_dense(mat.to(dtype), mb, nb, dist)


def condex(M, N, mb, nb, seed=0, dtype=torch.float32, dist=Dist(),
           theta=100.0, device=None):
    """Higham's counter-example for condition estimators (gallery
    condex, k=4): A = I + theta Q Q^H, Q = orth([ones, e1,
    (-1)^i (1 + i/(n-1))]) (core_zpltmg_condexq.c)."""
    _square(M, N, "condex")
    dev = resolve_device(device)
    rd = _rdtype(dtype)
    i = torch.arange(M, device=dev).to(rd)
    e1 = torch.zeros((M,), dtype=rd, device=dev)
    e1[0] = 1.0
    cols = torch.stack([torch.ones((M,), dtype=rd, device=dev), e1,
                        torch.pow(-1.0, i) * (1.0 + _div(i, max(N - 1, 1)))],
                       dim=1).to(dtype)
    q, _ = torch.linalg.qr(cols)
    mat = torch.eye(M, dtype=q.dtype, device=dev) + theta * (q @ q.mH)
    return TileMatrix.from_dense(mat.to(dtype), mb, nb, dist)


def latms(M, N, mb, nb, sv, seed=3872, dtype=torch.float32, dist=Dist(),
          device=None):
    """A = U diag(sv) V^H with Haar-ish random U, V from QRs of seeded
    uniforms (dplasma_zlatms semantics: the spectrum is ``sv`` exactly;
    used by the SVD tests, tests/testing_zgesvd.c:99)."""
    dev = resolve_device(device)
    K = min(M, N)
    sv = torch.as_tensor(sv, dtype=_rdtype(dtype), device=dev)
    if tuple(sv.shape) != (K,):
        raise ValueError(f"need {K} singular values, got "
                         f"{tuple(sv.shape)}")
    gu = plrnt(M, K, mb, nb, seed=seed, dtype=dtype, device=dev).to_dense()
    gv = plrnt(N, K, mb, nb, seed=seed + 7, dtype=dtype,
               device=dev).to_dense()
    u, _ = torch.linalg.qr(gu)
    v, _ = torch.linalg.qr(gv)
    mat = (u * sv[None, :].to(u.dtype)) @ v.mH
    return TileMatrix.from_dense(mat.to(dtype), mb, nb, dist)


def _random(M, N, mb, nb, seed, dtype, dist, device=None):
    return plrnt(M, N, mb, nb, seed=seed, dtype=dtype, dist=dist,
                 device=device)


_DISPATCH = {
    "random": _random,
    "hadamard": hadamard, "house": house, "parter": parter, "ris": ris,
    "kms": kms, "condex": condex, "moler": moler, "circul": circul,
    "hankel": hankel, "compan": compan, "riemann": riemann,
    "lehmer": lehmer, "toeppd": toeppd, "minij": minij, "fiedler": fiedler,
    "dorr": dorr, "demmel": demmel, "chebvand": chebvand,
    "invhess": invhess, "cauchy": cauchy, "hilb": hilb, "lotkin": lotkin,
    "orthog": orthog, "wilkinson": wilkinson, "foster": foster,
    "wright": wright, "langou": langou,
}

#: the matrix-type vocabulary, the reference's dplasmaMatrix* enum
#: (constants.h:164-203) without its "Unavailable" entries
TYPES = tuple(_DISPATCH)


def pltmg(mtxtype: str, M: int, N: int, mb: int, nb: int,
          seed: int = 3872, dtype=torch.float32, dist: Dist = Dist(),
          device=None) -> TileMatrix:
    """A named special matrix (dplasma_zpltmg dispatch,
    src/zpltmg_wrapper.c:480-560)."""
    key = mtxtype.lower()
    if key not in _DISPATCH:
        raise ValueError(f"unknown matrix type {mtxtype!r}; "
                         f"known: {sorted(_DISPATCH)}")
    return _DISPATCH[key](M, N, mb, nb, seed=seed, dtype=dtype, dist=dist,
                          device=device)
