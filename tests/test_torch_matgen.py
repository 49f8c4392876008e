"""Port parity: the special-matrix generators (``ops/matgen.py``) and
the generators' index-array hash (``ops/generators._hash2d``) against
the reference's, on the same sizes and seeds.

Every type of ``TYPES`` in s/d/c/z at N = 37 (hadamard 32), nb = 8, and
the types without a square requirement on 37 × 29 too. Held bitwise
where the values come from the hash or from integers (one correctly
rounded operation away from them): every type but the transcendental
ones (orthog, kms, demmel, chebvand), the sums (house, toeppd), the QR
(condex) and the complex division of ``compan``, which are within 1e-5
(s/c) / 1e-13 (d/z) of the reference relative to its largest entry
(chebvand's cos(i·arccos p) carries i·eps: 3.8e-6 in f32 here).
``condex``'s I + θ Q Qᴴ is held entry by entry: its projector does not
depend on the signs a QR gives Q's columns. ``latms`` is held through
its singular values (``sv`` exactly, within 1e-4 / 1e-10) and the
reference's, not entry by entry: its U and V come from QRs whose column
signs the two libraries choose differently. The error cases are the
reference's: an unknown type, a non-square size for the square-only
types, a non-power-of-two hadamard, a wrong ``sv`` length.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import matgen as ref_mg
from dplasma_tpu_torch.ops import generators, matgen
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DT = {"s": (jnp.float32, torch.float32), "d": (jnp.float64, torch.float64),
      "c": (jnp.complex64, torch.complex64),
      "z": (jnp.complex128, torch.complex128)}
TOL = {"s": 1e-5, "c": 1e-5, "d": 1e-13, "z": 1e-13}
CLOSE = {"orthog", "kms", "demmel", "chebvand", "house", "toeppd",
         "condex"}
N, NB = 37, 8


def _size(name):
    return 32 if name == "hadamard" else N


def _held(got, want, prec, exact):
    want = np.asarray(want)
    got = got.resolve_conj().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        assert np.array_equal(got, want)
    else:
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= TOL[prec] * scale


@pytest.mark.parametrize("prec", list(DT))
@pytest.mark.parametrize("name", matgen.TYPES)
def test_pltmg_matches_reference(name, prec):
    jd, td = DT[prec]
    n = _size(name)
    want = ref_mg.pltmg(name, n, n, NB, NB, seed=3872, dtype=jd)
    got = matgen.pltmg(name, n, n, NB, NB, seed=3872, dtype=td,
                       device="cpu")
    assert got.desc.to_dict() == {**vars(want.desc),
                                  "dist": vars(want.desc.dist)}
    exact = name not in CLOSE and not (name == "compan"
                                       and prec in "cz")
    _held(got.data, want.data, prec, exact)


RECT = [t for t in matgen.TYPES
        if t in ("random", "hilb", "hankel", "demmel", "chebvand",
                 "langou")]


@pytest.mark.parametrize("prec", ["s", "z"])
@pytest.mark.parametrize("name", RECT)
def test_pltmg_rectangular_matches_reference(name, prec):
    jd, td = DT[prec]
    want = ref_mg.pltmg(name, N, 29, NB, 5, seed=11, dtype=jd)
    got = matgen.pltmg(name, N, 29, NB, 5, seed=11, dtype=td, device="cpu")
    _held(got.data, want.data, prec, name not in CLOSE)


@pytest.mark.parametrize("name", matgen.TYPES)
def test_pltmg_errors_match_reference(name):
    """Each type raises ValueError on a 16 × 12 request exactly when the
    reference does."""
    try:
        ref_mg.pltmg(name, 16, 12, 4, 4, dtype=jnp.float64)
        ref_raises = False
    except ValueError:
        ref_raises = True
    if ref_raises:
        with pytest.raises(ValueError):
            matgen.pltmg(name, 16, 12, 4, 4, dtype=torch.float64,
                         device="cpu")
    else:
        matgen.pltmg(name, 16, 12, 4, 4, dtype=torch.float64, device="cpu")


def test_pltmg_unknown_type_and_hadamard_size():
    with pytest.raises(ValueError):
        ref_mg.pltmg("nosuch", 8, 8, 4, 4)
    with pytest.raises(ValueError, match="unknown matrix type"):
        matgen.pltmg("nosuch", 8, 8, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        matgen.pltmg("hadamard", 24, 24, 8, 8, device="cpu")
    assert matgen.TYPES == ref_mg.TYPES
    a = matgen.pltmg("HILB", 8, 8, 4, 4, device="cpu")
    assert torch.equal(a.data, matgen.hilb(8, 8, 4, 4, device="cpu").data)


@pytest.mark.parametrize("prec", list(DT))
def test_latms_singular_values(prec):
    jd, td = DT[prec]
    M_, N_ = 31, 20
    sv = np.geomspace(1.0, 1e-3, N_)
    want = ref_mg.latms(M_, N_, NB, NB, jnp.asarray(sv), dtype=jd)
    got = matgen.latms(M_, N_, NB, NB, sv, dtype=td, device="cpu")
    assert got.dtype == td and got.desc.Mp == want.desc.Mp
    s_got = np.linalg.svd(got.to_dense().numpy().astype(np.complex128),
                          compute_uv=False)
    s_want = np.linalg.svd(np.asarray(want.to_dense(), np.complex128),
                           compute_uv=False)
    tol = 1e-4 if prec in "sc" else 1e-10
    np.testing.assert_allclose(s_got, sv, rtol=tol)
    np.testing.assert_allclose(s_got, s_want, rtol=tol)
    with pytest.raises(ValueError):
        matgen.latms(M_, N_, NB, NB, sv[:-1], dtype=td, device="cpu")


def test_hash2d_at_index_arrays_bitwise():
    i = np.array([0, 1, 5, 2**32 - 1, 2**33 + 7, -3, 123456789])
    j = np.array([0, 3, 9, 1, 2, -1, 42])
    for seed in (0, 3872, 2**32 - 1):
        want = np.asarray(ref_gen._hash2d(seed, jnp.asarray(i),
                                          jnp.asarray(j)))
        got = generators._hash2d(seed, torch.as_tensor(i),
                                 torch.as_tensor(j))
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        for jd, td in DT.values():
            want = ref_gen._value(seed, jnp.asarray(i)[:, None],
                                  jnp.asarray(j)[None, :], jd)
            got = generators._value(seed, torch.as_tensor(i)[:, None],
                                    torch.as_tensor(j)[None, :], td)
            assert np.array_equal(got.numpy(), np.asarray(want))
