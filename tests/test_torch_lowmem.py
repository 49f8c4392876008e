"""Port parity: the out-of-HBM tiers ``potrf_lowmem``, ``getrf_lowmem``
and ``geqrf_lowmem`` and their blocking (``analysis.memcheck``), against
the reference's on the same host arrays.

Sizes: the reference tests' (potrf N=192 with the budget a quarter of
the matrix; getrf N=160 and geqrf N=128 with nb=32 and a budget of four
f64 panels) and a ragged N (the last panel narrower), in f32 and f64.
Held: the factors within 1e-4 (f32) / 1e-12 (f64) of the reference's,
relative to the largest entry; ``getrf_lowmem``'s permutation bitwise;
``lowmem_blocking`` and ``plan_potrf_lowmem`` equal over a grid of
(op, N, itemsize, budget); the host link's accounting (the port's
counterpart of the reference's jaxlint J010 and
``test_adtt.py::test_potrf_lapack_never_assembles``): every upload fits
the budget, each panel's device working set too, and the bytes each way
equal the schedule's sums.
"""
import numpy as np
import pytest
import torch

from dplasma_tpu.analysis import memcheck as ref_mc
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu_torch.analysis import memcheck
from dplasma_tpu_torch.kernels import hostlink
from dplasma_tpu_torch.ops import lu, potrf, qr
from torch_threads import one_torch_thread  # noqa: F401

TOL = {np.float32: 1e-4, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


def _close(got, want, tol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _spd(N, dtype, seed):
    g = np.random.default_rng(seed).standard_normal((N, N))
    return (g @ g.T / N + 4.0 * np.eye(N)).astype(dtype)


def _general(N, dtype, seed, shift=True):
    a = np.random.default_rng(seed).standard_normal((N, N))
    return (a + N * np.eye(N) if shift else a).astype(dtype)


# -- blocking ------------------------------------------------------------

@pytest.mark.parametrize("op", ["potrf", "getrf", "geqrf"])
def test_lowmem_blocking_equals_reference(op):
    for N in (1, 7, 128, 160, 192, 1000, 16384, 32768):
        for item in (4, 8, 16):
            for budget in (1, 4096, N * N * item // 4, 4 * N * 32 * 8,
                           2**28, 2**30, 80 * 2**30):
                for nb in (32, 512):
                    want = ref_mc.lowmem_blocking(op, N, item, budget, nb=nb)
                    got = memcheck.lowmem_blocking(op, N, item, budget,
                                                   nb=nb)
                    assert got == want, (op, N, item, budget, nb)
    with pytest.raises(ValueError):
        memcheck.lowmem_blocking("gemm", 10, 4, 100)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_potrf_lowmem_equals_reference(dtype):
    for N in (64, 192, 200, 4096, 32768):
        for budget in (N * N * np.dtype(dtype).itemsize // 4, 2**30):
            assert potrf.plan_potrf_lowmem(N, dtype, budget) == \
                ref_potrf.plan_potrf_lowmem(N, dtype, budget)
    t = torch.float32 if dtype == np.float32 else torch.float64
    assert potrf.plan_potrf_lowmem(192, t, 2**20) == \
        potrf.plan_potrf_lowmem(192, dtype, 2**20)


# -- the tiers against the reference ------------------------------------

@pytest.mark.parametrize("N", [192, 200])
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_lowmem_matches_reference(N, dtype):
    A = _spd(N, dtype, 11)
    budget = A.nbytes // 4
    A0 = A.copy()
    got = potrf.potrf_lowmem(A, budget_bytes=budget, device="cpu")
    want = ref_potrf.potrf_lowmem(A, budget_bytes=budget)
    assert got.dtype == A.dtype and np.array_equal(A, A0)
    _close(got, want, TOL[dtype])
    assert np.array_equal(got, np.tril(got))


@pytest.mark.parametrize("N", [160, 150])
@pytest.mark.parametrize("dtype", DTYPES)
def test_getrf_lowmem_matches_reference(N, dtype):
    nb = 32
    A = _general(N, dtype, 12, shift=False)
    budget = 4 * N * nb * 8
    A0 = A.copy()
    LU, perm = lu.getrf_lowmem(A, nb=nb, budget_bytes=budget, device="cpu")
    LUr, permr = ref_lu.getrf_lowmem(A, nb=nb, budget_bytes=budget)
    assert np.array_equal(A, A0)
    assert perm.dtype == torch.int64 and perm.device.type == "cpu"
    assert np.array_equal(perm.numpy(), np.asarray(permr))
    _close(LU, LUr, TOL[dtype])
    p = perm.numpy()
    L = np.tril(LU, -1) + np.eye(N)
    r = np.abs(A[p] - L @ np.triu(LU)).max() / (
        np.abs(A).max() * N * np.finfo(dtype).eps)
    assert r < 100.0, r


@pytest.mark.parametrize("N", [128, 120])
@pytest.mark.parametrize("dtype", DTYPES)
def test_geqrf_lowmem_matches_reference(N, dtype):
    nb = 32
    A = _general(N, dtype, 13, shift=False)
    budget = 4 * N * nb * 8
    packed, Ts = qr.geqrf_lowmem(A, nb=nb, budget_bytes=budget,
                                 device="cpu")
    packedr, Tsr = ref_qr.geqrf_lowmem(A, nb=nb, budget_bytes=budget)
    assert packed.dtype == A.dtype and Ts.shape == Tsr.shape
    _close(packed, packedr, TOL[dtype])
    _close(Ts, Tsr, TOL[dtype])


def test_geqrf_lowmem_budget_shrinks_the_panel():
    """A budget of three f64 columns of 16 rows: nb is the largest
    multiple of 32 that fits, floored at 32, as in the reference."""
    A = _general(96, np.float64, 14, shift=False)
    budget = 3 * 96 * 40 * 8
    packed, Ts = qr.geqrf_lowmem(A, nb=64, budget_bytes=budget,
                                 device="cpu")
    packedr, Tsr = ref_qr.geqrf_lowmem(A, nb=64, budget_bytes=budget)
    assert Ts.shape == Tsr.shape == (32, 96)
    _close(packed, packedr, 1e-12)


# -- the host link's accounting -----------------------------------------

def _potrf_bytes(N, nb, cw, item):
    h2d = d2h = 0
    for s in range(0, N, nb):
        w = min(nb, N - s)
        h2d += (N - s) * (w + s)
        d2h += (N - s) * w
    return h2d * item, d2h * item


def _getrf_bytes(N, nb, cw, item):
    h2d = d2h = 0
    for s in range(0, N, nb):
        w = min(nb, N - s)
        h2d += N * w + sum((N - j0) * (min(j0 + cw, s) - j0)
                           for j0 in range(0, s, cw))
        d2h += N * w
    return h2d * item, d2h * item


def _geqrf_bytes(N, nb, item):
    h2d = d2h = 0
    for kk in range(-(-N // nb)):
        s = kk * nb
        w = min(nb, N - s)
        h2d += N * w + sum((N - j * nb) * nb + nb * nb for j in range(kk))
        d2h += N * w + w * w
    return h2d * item, d2h * item


@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_lowmem_transfers_fit_the_budget(dtype):
    N = 200
    A = _spd(N, dtype, 15)
    item = A.itemsize
    budget = A.nbytes // 4
    nb, cw = potrf.plan_potrf_lowmem(N, dtype, budget)
    cw = max(cw // nb * nb, nb)
    hostlink.reset_stats()
    potrf.potrf_lowmem(A, budget_bytes=budget, device="cpu")
    st = hostlink.STATS
    assert (st.h2d_bytes, st.d2h_bytes) == _potrf_bytes(N, nb, cw, item)
    # one panel + one chunk + two panels of temporaries, every step
    assert N * (cw + 3 * nb) * item <= budget
    assert st.largest_h2d <= N * cw * item
    assert st.h2d_copies == sum(1 + -(-s // cw) for s in range(0, N, nb))
    assert st.d2h_copies == -(-N // nb)


@pytest.mark.parametrize("dtype", DTYPES)
def test_getrf_lowmem_transfers_fit_the_budget(dtype):
    N, nb = 160, 32
    A = _general(N, dtype, 16)
    item = A.itemsize
    budget = 4 * N * nb * 8
    cw = memcheck.lowmem_blocking("getrf", N, item, budget, nb=nb)["cw"]
    hostlink.reset_stats()
    lu.getrf_lowmem(A, nb=nb, budget_bytes=budget, device="cpu")
    st = hostlink.STATS
    assert (st.h2d_bytes, st.d2h_bytes) == _getrf_bytes(N, nb, cw, item)
    assert 3 * N * cw * item <= budget
    assert st.largest_h2d <= N * cw * item
    # a partial-pivoting panel moves at most 2·nb rows
    assert st.swapped_rows <= 2 * nb * (-(-N // nb))


@pytest.mark.parametrize("dtype", DTYPES)
def test_geqrf_lowmem_transfers_fit_the_budget(dtype):
    N, nb = 128, 32
    A = _general(N, dtype, 17, shift=False)
    item = A.itemsize
    budget = 4 * N * nb * 8
    hostlink.reset_stats()
    qr.geqrf_lowmem(A, nb=nb, budget_bytes=budget, device="cpu")
    st = hostlink.STATS
    assert (st.h2d_bytes, st.d2h_bytes) == _geqrf_bytes(N, nb, item)
    assert 3 * N * nb * item <= budget
    assert st.largest_h2d <= N * nb * item


def test_permute_rows_moves_only_the_moved_rows():
    """Bitwise the reference's whole-slab gather, touching only the rows
    the permutation moves, never the skipped columns."""
    rng = np.random.default_rng(18)
    a = rng.standard_normal((40, 30))
    a0 = a.copy()
    H = hostlink.HostMatrix(a, torch.device("cpu"))
    perm = np.arange(30)
    perm[[0, 5, 17]] = [17, 0, 5]
    want = a.copy()
    want[10:, :8] = want[10:, :8][perm]
    want[10:, 12:] = want[10:, 12:][perm]
    hostlink.reset_stats()
    H.permute_rows(10, perm, 8, 12)
    assert np.array_equal(H.finish(), want)
    assert hostlink.STATS.swapped_rows == 3
    assert np.array_equal(a, a0) and not np.shares_memory(H.a, a)


@pytest.mark.parametrize("fn", [potrf.potrf_lowmem, lu.getrf_lowmem,
                                qr.geqrf_lowmem])
def test_lowmem_runs_on_the_card_or_raises(fn):
    """The default device is the card; without CUDA it raises (and never
    runs on the CPU instead), as does an explicit ``device="cuda"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    A = _spd(64, np.float32, 19)
    hostlink.reset_stats()
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(A, **kw)
    assert hostlink.STATS.h2d_copies == 0
