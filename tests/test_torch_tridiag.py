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
the results ascend."""
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
