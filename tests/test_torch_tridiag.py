"""Port parity: KT's plain version (``kernels/tridiag.py``,
``eigh_tridiagonal_reference``) against the reference's finish,
``jax.scipy.linalg.eigh_tridiagonal(d, e, eigvals_only=True)``, on the
very same numpy inputs in f32 and f64: random, clustered (Wilkinson's
W₂₁⁺, a glued pair of it), a zero diagonal (the Jordan–Wielandt form of
``gesvd``), n = 1 and 2, e = 0, a badly scaled matrix and a complex
input (|e| taken real, as the reference does); and the plain version
bisecting for a sample of indices only.

Tolerance: 2·eps·t_norm, t_norm the Gershgorin bound of the reference
(the KT contract on the card); the plain version repeats the
reference's arithmetic step for step, and here it agrees bitwise on
every case but the complex one (its |e|² rounds in another order).
The wrapper takes the plain version on a CPU tensor (no launch), and
the results ascend.

KT's schedule (a top tree of ``depth`` levels shared by every search,
then rounds of ``s`` levels, each node's shift walked from the root):
a model of it in plain torch is ``torch.equal`` to the plain version on
every case but n1 in f32 and f64, for several (depth, s) from a flat
schedule (depth 0) to a top tree of all nmant + 1 levels; with targets
it gives the whole spectrum's bits at those indices. The wrapper with
``targets`` on a CPU tensor is the plain version with them, and
``gesvd`` asks for the K values it keeps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu_torch.kernels import tridiag
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def _wilkinson(m):
    return np.abs(np.arange(-m, m + 1)).astype(float), np.ones(2 * m)


def _cases():
    rng = np.random.default_rng(5)
    d21, e21 = _wilkinson(10)
    return {
        "random": (rng.standard_normal(97), rng.standard_normal(96)),
        "wilkinson21": (d21, e21),
        "glued": (np.concatenate([d21, d21]),
                  np.concatenate([e21, [1e-6], e21])),
        "zero_diag": (np.zeros(41), np.abs(rng.standard_normal(40))),
        "n1": (np.array([2.5]), np.zeros(0)),
        "n2": (np.array([1.0, -3.0]), np.array([0.75])),
        "e0": (rng.standard_normal(12), np.zeros(11)),
        "scaled": (1e6 * rng.standard_normal(30),
                   1e-3 * rng.standard_normal(29)),
    }


def _t_norm(d, e):
    a = np.abs(e)
    row = np.concatenate([a[:1], a[:-1] + a[1:], a[-1:]]) if a.size else 0
    return max(np.max(np.abs(d + row)), np.max(np.abs(d - row)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(_cases()))
def test_plain_version_matches_the_reference(case, dtype):
    d, e = (x.astype(dtype) for x in _cases()[case])
    want = np.asarray(jax.scipy.linalg.eigh_tridiagonal(
        jnp.asarray(d), jnp.asarray(e), eigvals_only=True))
    got = tridiag.eigh_tridiagonal_reference(torch.from_numpy(d),
                                             torch.from_numpy(e)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 2 * np.finfo(dtype).eps * _t_norm(d, e)
    assert np.max(np.abs(got - want)) <= tol
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) >= 0)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_input_takes_abs_e(dtype):
    rng = np.random.default_rng(6)
    d = rng.standard_normal(30).astype(dtype)
    e = (rng.standard_normal(29) + 1j * rng.standard_normal(29)).astype(dtype)
    want = np.asarray(jax.scipy.linalg.eigh_tridiagonal(
        jnp.asarray(d), jnp.asarray(e), eigvals_only=True))
    got = tridiag.eigh_tridiagonal_reference(torch.from_numpy(d),
                                             torch.from_numpy(e)).numpy()
    assert got.dtype == want.dtype
    tol = 2 * np.finfo(dtype).eps * _t_norm(d.real, np.abs(e))
    assert np.max(np.abs(got - want)) <= tol


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["random", "glued", "zero_diag"])
def test_sampled_targets_match_the_reference_at_their_indices(case, dtype):
    """The plain version bisecting for a sample of indices (how the card
    check holds KT at n ~ 10⁴) gives the reference's eigenvalues at those
    indices within eps·t_norm."""
    d, e = (x.astype(dtype) for x in _cases()[case])
    want = np.asarray(jax.scipy.linalg.eigh_tridiagonal(
        jnp.asarray(d), jnp.asarray(e), eigvals_only=True))
    k = np.unique(np.linspace(0, d.size - 1, 7).astype(np.int32))
    got = tridiag.eigh_tridiagonal_reference(
        torch.from_numpy(d), torch.from_numpy(e),
        targets=torch.from_numpy(k)).numpy()
    assert got.shape == k.shape and got.dtype == want.dtype
    assert np.max(np.abs(got - want[k])) <= \
        np.finfo(dtype).eps * _t_norm(d, e)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    d, e = _cases()["random"]
    d, e = torch.from_numpy(d), torch.from_numpy(e)
    tridiag.reset_counts()
    got = tridiag.eigh_tridiagonal(d, e)
    assert (tridiag.ROUTED, tridiag.LAUNCHES) == (1, 0)
    assert torch.equal(got, tridiag.eigh_tridiagonal_reference(d, e))
    with pytest.raises(ValueError):
        tridiag.eigh_tridiagonal(d, e[:-1])
    with pytest.raises(TypeError):
        tridiag.eigh_tridiagonal(d.float(), e)


def test_spectrum_matches_a_dense_solver():
    d, e = _cases()["random"]
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    got = tridiag.eigh_tridiagonal(torch.from_numpy(d), torch.from_numpy(e))
    assert np.max(np.abs(got.numpy() - np.linalg.eigvalsh(T))) <= \
        4 * np.finfo(np.float64).eps * _t_norm(d, e) * d.size


# ------------------------------------------------ KT's schedule, modelled

def _walk(lo, hi, h, levels):
    """The shift of heap node h (>= 1, int64) of the tree over [lo, hi]:
    its path below the leading one, top bit first (1 = upper half), by
    the 0.5·(lo + hi) steps a search takes, as the kernel walks it."""
    dep = sum(((h >> b) > 0).long() for b in range(1, 63))
    for b in range(levels - 1, -1, -1):
        act = b < dep
        up = ((h >> b) & 1) == 1
        mid = 0.5 * (lo + hi)
        lo = torch.where(act & up, mid, lo)
        hi = torch.where(act & ~up, mid, hi)
    return 0.5 * (lo + hi)


def _schedule_model(d, e, depth, s, targets=None):
    """KT's schedule in plain torch: the counts of every node of the top
    ``depth`` levels (all 2^depth − 1 when that is at most 4095, else
    only the nodes the searches reach, level by level: the same counts,
    since a node's count depends on its path alone), each search's
    descent through them, then rounds of s levels in which all 2^s − 1
    nodes of the search's subtree are counted before it descends."""
    alpha, beta_sq, lower, upper, pivmin, a0p, _, levels = tridiag.setup(
        d, e)
    n = alpha.shape[0]
    k = (torch.arange(n, dtype=torch.int32) if targets is None
         else targets)
    m = k.shape[0]

    def counts(x):
        return tridiag.sturm_counts(alpha, beta_sq, pivmin, a0p, x)

    lo = lower.expand(m).clone()
    hi = upper.expand(m).clone()
    h = torch.ones(m, dtype=torch.int64)
    if depth and (1 << depth) <= 4096:
        nodes = torch.arange(1, 1 << depth, dtype=torch.int64)
        top = torch.zeros(1 << depth, dtype=torch.int32)
        top[1:] = counts(_walk(lower.expand(nodes.shape[0]),
                               upper.expand(nodes.shape[0]), nodes, depth))
    for _ in range(depth):
        if (1 << depth) <= 4096:
            c = top[h]
        else:
            nodes, at = torch.unique(h, return_inverse=True)
            c = counts(_walk(lower.expand(nodes.shape[0]),
                             upper.expand(nodes.shape[0]), nodes,
                             levels))[at]
        mid = 0.5 * (lo + hi)
        go_up = c <= k
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
        h = 2 * h + go_up.long()
    left = levels - depth
    while left > 0:
        rr = min(s, left)
        sub = torch.arange(1, 1 << rr, dtype=torch.int64)
        x = _walk(lo[:, None].expand(m, sub.shape[0]),
                  hi[:, None].expand(m, sub.shape[0]),
                  sub[None, :].expand(m, sub.shape[0]), rr)
        c = torch.zeros((m, 1 << rr), dtype=torch.int32)
        c[:, 1:] = counts(x.reshape(-1)).reshape(m, -1)
        hh = torch.ones(m, dtype=torch.int64)
        for _ in range(rr):
            mid = 0.5 * (lo + hi)
            go_up = c.gather(1, hh[:, None])[:, 0] <= k
            lo = torch.where(go_up, mid, lo)
            hi = torch.where(go_up, hi, mid)
            hh = 2 * hh + go_up.long()
        left -= rr
    return 0.5 * (lo + hi)


_MODEL_CASES = ["random", "wilkinson21", "glued", "zero_diag", "scaled",
                "e0", "n2"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", _MODEL_CASES)
@pytest.mark.parametrize("depth,s", [(0, 1), (0, 4), (4, 4), (7, 3),
                                     ("levels", 1)])
def test_tree_schedule_is_bitwise_the_plain_version(case, dtype, depth, s):
    d, e = (torch.from_numpy(x.astype(dtype)) for x in _cases()[case])
    if depth == "levels":
        depth = tridiag.max_levels(d.dtype)
    got = _schedule_model(d, e, depth, s)
    assert torch.equal(got, tridiag.eigh_tridiagonal_reference(d, e))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["random", "glued", "zero_diag"])
def test_tree_schedule_with_targets_gives_the_whole_spectrums_bits(
        case, dtype):
    d, e = (torch.from_numpy(x.astype(dtype)) for x in _cases()[case])
    n = d.shape[0]
    k = torch.tensor([n - 1, 0, n // 2, n // 2, 3], dtype=torch.int32)
    whole = _schedule_model(d, e, 5, 4)
    pl = tridiag.plan(n, k.shape[0], d.dtype)
    assert torch.equal(_schedule_model(d, e, pl.depth, pl.s, targets=k),
                       whole[k.long()])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["random", "zero_diag", "n2", "n1"])
def test_wrapper_with_targets_is_the_plain_version_with_them(case, dtype):
    d, e = (torch.from_numpy(x.astype(dtype)) for x in _cases()[case])
    n = d.shape[0]
    k = torch.unique(torch.linspace(0, n - 1, 5).round().to(torch.int32))
    tridiag.reset_counts()
    got = tridiag.eigh_tridiagonal(d, e, targets=k.long())
    assert (tridiag.ROUTED, tridiag.LAUNCHES) == (1, 0)
    want = tridiag.eigh_tridiagonal_reference(d, e, targets=k)
    assert got.shape == k.shape and torch.equal(got, want)
    assert torch.equal(got, tridiag.eigh_tridiagonal(d, e)[k.long()])
    with pytest.raises(TypeError):
        tridiag.eigh_tridiagonal(d, e, targets=k.double())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bad", [[-1], "n", [0, "n+3"]])
def test_wrapper_refuses_targets_out_of_range(bad, dtype):
    d, e = (torch.from_numpy(x.astype(dtype)) for x in _cases()["random"])
    n = d.shape[0]
    bad = [n if b == "n" else n + 3 if b == "n+3" else b
           for b in (bad if isinstance(bad, list) else [bad])]
    with pytest.raises(ValueError):
        tridiag.eigh_tridiagonal(d, e, targets=torch.tensor(bad))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wrapper_with_no_targets_gives_no_values(dtype):
    d, e = (torch.from_numpy(x.astype(dtype)) for x in _cases()["random"])
    got = tridiag.eigh_tridiagonal(d, e, targets=torch.zeros(0, dtype=int))
    assert got.shape == (0,) and got.dtype == d.dtype


@pytest.mark.parametrize("n,m,dtype", [
    (8192, 8192, "float32"), (16385, 8192, "float32"),
    (4096, 4096, "float64"), (4096, 2048, "float64"), (64, 1, "float32"),
    (3, 3, "float64")])
def test_kt_bound_counts_the_least_tree(n, m, dtype):
    import chip_smoke as cs
    levels = tridiag.max_levels(getattr(torch, dtype))
    rates = {"sm_clock_max_mhz": 1980.0, "ddiv_fp64_ops": 8}
    ms, by, terms, depth = cs.kt_bound_ms(n, dtype, levels, m, rates)

    def steps(D):
        return ((1 << D) - 1 + (levels - D) * m) * n

    assert depth == min(max(m - 1, 0).bit_length(), levels)
    assert steps(depth) == min(steps(D) for D in range(levels + 1))
    per = 16 if dtype == "float32" else 64 / 8
    assert terms["division"] == pytest.approx(
        1e3 * steps(depth) / (132 * per * 1980e6), rel=1e-12)
    assert ms == max(terms.values()) and terms[by] == ms


def test_plan_for_the_main_path_shapes():
    f32, f64 = torch.float32, torch.float64
    # rounds of s levels with m·2^s near 2^16 lanes, a top tree one node a
    # target deep, widened so the rounds end together; the pairs
    # resident up to 227 KB
    assert tridiag.plan(8192, 8192, f32) == tridiag.Plan(15, 3, True)
    assert tridiag.plan(16385, 8192, f32) == tridiag.Plan(15, 3, True)
    assert tridiag.plan(4096, 4096, f64) == tridiag.Plan(13, 4, True)
    assert tridiag.plan(8192, 8192, f64) == tridiag.Plan(14, 3, True)
    assert tridiag.plan(16385, 16385, f32) == tridiag.Plan(16, 2, True)
    assert not tridiag.plan(40000, 40000, f32).resident
    assert not tridiag.plan(14529, 64, f64).resident
    assert tridiag.plan(14528, 64, f64).resident
    for n, m, dt in ((2, 1, f32), (2, 2, f64), (10**6, 10**6, f64)):
        pl = tridiag.plan(n, m, dt)
        assert 0 <= pl.depth <= min(tridiag.MAX_DEPTH,
                                     tridiag.max_levels(dt))
        assert 1 <= pl.s <= 5


def test_gesvd_asks_for_the_k_values_it_keeps(monkeypatch):
    from dplasma_tpu_torch.descriptors import TileMatrix
    from dplasma_tpu_torch.ops import eig
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.standard_normal((30, 20)))
    seen = []
    kt = tridiag.eigh_tridiagonal

    def spy(d, e, targets=None):
        seen.append((d.shape[0], targets))
        return kt(d, e, targets=targets)

    monkeypatch.setattr(tridiag, "eigh_tridiagonal", spy)
    s = eig.gesvd(TileMatrix.from_dense(A, 8, 8))
    (L1, k), = seen
    assert L1 == 2 * 20 and torch.equal(
        k, torch.arange(L1 - 20, L1, dtype=torch.int32))
    d, e = eig.gebrd(TileMatrix.from_dense(A, 8, 8))
    off = torch.zeros(L1 - 1, dtype=d.dtype)
    off[0::2], off[1::2] = d, e
    whole = tridiag.eigh_tridiagonal_reference(torch.zeros(L1, dtype=d.dtype),
                                               off)
    assert torch.equal(s, torch.flip(whole, (0,))[:20])
