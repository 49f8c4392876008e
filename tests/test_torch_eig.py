"""Port parity: the eigen/SVD chain (``ops/eig.py``) against the
reference's, on the very same padded inputs (the reference on the CPU
with x64, every op of one precision and shape under one ``jax.jit``: one
compile instead of one per eager tile op).

Inputs: a Hermitian ``plghe`` matrix N = 45 with nb = 8 (ragged: 45 is
no multiple of 8) in s/d/c/z, and ``plrnt`` matrices with nb = 8: 45×45
in s/d/c/z, 60×36 (tall) and 36×60 (wide) in s and z, made by the
reference's generators and handed across as numpy. The reference's
``gesvd`` is its ``gebrd`` followed by its own finish on that (d, e)
(one compile of the chain instead of two); its ``gebrd`` chase runs in
d and c on the square matrix (the chases of every shape and precision
are held in ``test_torch_band.py``).

Held: ``herbt``'s band, V and T; ``band_to_rect``; ``hetrd``'s (d, e);
``heev`` direct and 2stage; ``gebrd_ge2gb``'s band; ``gebrd`` by the
scan and by the chase; ``gesvd`` and ``gesvd_direct``; ``hbrdt`` on a
``BandMatrix`` (the Givens chase). Tolerances, relative to the largest
entry of the reference's result: stage-1 outputs (band, V, T) within
1e-4 (s/c) / 1e-12 (d/z); (d, e) within 2e-3 / 1e-9 (a rotation-order
quantity, see ``test_torch_band.py``); eigenvalues and singular values
within 1e-4 / 1e-12.

The dd departure (MCA ``dd_gemm=always``): stage 1's products take the
limb route (``pallas_dd.ROUTED`` grows by herbt's products and by no
more in hetrd: stage 2's window products stay native FP64), and the
port's dd ``hetrd`` / ``gesvd`` agree with the reference's native f64
results within 1e-12 (the reference's dd route compiles a limb program
per tile product on the CPU, minutes at this size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import BandMatrix as RefBand
from dplasma_tpu.ops import eig as ref_eig
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu_torch.descriptors import BandMatrix, TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import tridiag
from dplasma_tpu_torch.ops import eig
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DT = {"s": jnp.float32, "d": jnp.float64, "c": jnp.complex64,
      "z": jnp.complex128}
TOL = {"s": 1e-4, "c": 1e-4, "d": 1e-12, "z": 1e-12}
DE = {"s": 2e-3, "c": 2e-3, "d": 1e-9, "z": 1e-9}
N, NB = 45, 8
PRECS = ["s", "d", "c", "z"]
# square in every precision, tall and wide in s and z
CASES = [(p, 45, 45) for p in PRECS] + [
    (p, m, n) for p in ("s", "z") for m, n in ((60, 36), (36, 60))]
# gebrd's Givens chase (one reference compile of ~6 s each)
CHASE = {("d", 45, 45), ("c", 45, 45)}


def _tile(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.resolve_conj().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0) if want.size else 1.0
    assert np.abs(want - got).max(initial=0.0) <= tol * scale


def _herm_ops(A):
    X, V, T = ref_eig.herbt(A, "L")
    return {"herbt": (X.data, V.data, T.data),
            "rect": ref_eig.band_to_rect(X, A.desc.nb),
            "hetrd": ref_eig.hetrd(A, "L"),
            "direct": ref_eig.heev(A, "L", "direct"),
            "2stage": ref_eig.heev(A, "L", "2stage")}


def _svd_ops(A, chase):
    d, e = ref_eig.gebrd(A)
    out = {"ge2gb": ref_eig.gebrd_ge2gb(A).data, "gebrd": (d, e),
           "gesvd": _ref_gesvd_finish(d, e),
           "direct": ref_eig.gesvd_direct(A)}
    if chase:
        out["chase"] = ref_eig.gebrd(A, chase_cut=4, method="chase")
    return out


def _ref_gesvd_finish(d, e):
    """The reference's ``gesvd`` after its ``gebrd`` (eig.py:300-319),
    on the (d, e) already computed: one compile of gebrd instead of
    two."""
    K = d.shape[0]
    L = K + e.shape[0]
    off = jnp.zeros((L,), d.dtype).at[0::2].set(d).at[1::2].set(e)
    w = jax.scipy.linalg.eigh_tridiagonal(jnp.zeros((L + 1,), d.dtype), off,
                                          eigvals_only=True)
    return w[::-1][:K]


_CACHE: dict = {}


def _herm_ref(prec):
    key = ("he", prec)
    if key not in _CACHE:
        A = ref_gen.plghe(0.0, N, NB, seed=3872, dtype=DT[prec])
        _CACHE[key] = (A, jax.jit(_herm_ops)(A))
    return _CACHE[key]


def _svd_ref(prec, m, n):
    key = ("ge", prec, m, n)
    if key not in _CACHE:
        A = ref_gen.plrnt(m, n, NB, NB, seed=3872, dtype=DT[prec])
        chase = (prec, m, n) in CHASE
        _CACHE[key] = (A, jax.jit(lambda a: _svd_ops(a, chase))(A))
    return _CACHE[key]


def _spectrum(d, e):
    d = np.asarray(d, np.float64)
    e = np.asarray(e, np.float64)
    return np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))


def _svals(d, e, m, n):
    K = min(m, n)
    B = np.zeros((K, K + (1 if m < n else 0)))
    B[np.arange(K), np.arange(K)] = np.asarray(d, np.float64)
    e = np.asarray(e, np.float64)
    B[np.arange(e.size), np.arange(e.size) + 1] = e
    return np.linalg.svd(B, compute_uv=False)


@pytest.mark.parametrize("prec", PRECS)
def test_herbt_band_v_t_match_the_reference(prec):
    A, ref = _herm_ref(prec)
    X, V, T = eig.herbt(_tile(A), "L")
    for got, want in zip((X.data, V.data, T.data), ref["herbt"]):
        _close(got, want, TOL[prec])
    _close(eig.band_to_rect(X, NB), ref["rect"], TOL[prec])


@pytest.mark.parametrize("prec", PRECS)
def test_hetrd_matches_the_reference(prec):
    A, ref = _herm_ref(prec)
    d, e = eig.hetrd(_tile(A), "L")
    d0, e0 = ref["hetrd"]
    _close(d, d0, DE[prec])
    _close(e, e0, DE[prec])
    _close(np.sort(_spectrum(d, e)), np.sort(_spectrum(d0, e0)), TOL[prec])


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("method", ["direct", "2stage"])
def test_heev_matches_the_reference(prec, method):
    A, ref = _herm_ref(prec)
    tridiag.reset_counts()
    w = eig.heev(_tile(A), "L", method)
    assert tridiag.ROUTED == (1 if method == "2stage" else 0)
    _close(w, ref[method], TOL[prec])
    _close(w, ref["direct"], TOL[prec])


@pytest.mark.parametrize("prec,m,n", CASES)
def test_gebrd_ge2gb_and_gebrd_match_the_reference(prec, m, n):
    A, ref = _svd_ref(prec, m, n)
    At = _tile(A)
    _close(eig.gebrd_ge2gb(At).data, ref["ge2gb"], TOL[prec])
    for key, kw in (("gebrd", {}),
                    ("chase", {"chase_cut": 4, "method": "chase"})):
        if key not in ref:
            continue
        d, e = eig.gebrd(At, **kw)
        d0, e0 = ref[key]
        _close(d, d0, DE[prec])
        _close(e, e0, DE[prec])
        _close(np.sort(_svals(d, e, m, n)), np.sort(_svals(d0, e0, m, n)),
               TOL[prec])


@pytest.mark.parametrize("prec,m,n", CASES)
def test_gesvd_matches_the_reference(prec, m, n):
    A, ref = _svd_ref(prec, m, n)
    tridiag.reset_counts()
    s = eig.gesvd(_tile(A))
    assert tridiag.ROUTED == 1
    _close(s, ref["gesvd"], TOL[prec])
    _close(s, ref["direct"], TOL[prec])
    _close(eig.gesvd_direct(_tile(A)), ref["direct"], TOL[prec])


@pytest.mark.parametrize("prec", ["d", "z"])
def test_hbrdt_on_a_band_matrix_takes_the_chase(prec):
    """A BandMatrix of bandwidth 8 (<= chase_cut) takes the band-storage
    Givens chase, in both packages."""
    _, ref = _herm_ref(prec)
    x = np.array(ref["herbt"][0])[:N, :N]
    ref_band = RefBand.from_dense(jnp.asarray(x), NB, NB)
    d0, e0 = jax.jit(lambda b: ref_eig.hbrdt(b, NB))(ref_band)
    band = BandMatrix.from_dense(torch.from_numpy(x), NB, NB)
    d, e = eig.hbrdt(band, NB)
    _close(d, d0, DE[prec])
    _close(e, e0, DE[prec])
    _close(np.sort(_spectrum(d, e)), np.sort(_spectrum(d0, e0)), TOL[prec])


@pytest.mark.parametrize("prec", ["d", "z"])
def test_dd_stage_two_stays_native(prec):
    """Under ``dd_gemm=always`` every stage-1 product takes the limb
    route and the sweeps add none; the results are the reference's f64
    ones within 1e-12."""
    A, ref = _herm_ref(prec)
    At = _tile(A)
    with cfg.override_scope({"dd_gemm": "always"}):
        pdd.reset_counts()
        eig.herbt(At, "L")
        stage1 = pdd.ROUTED
        pdd.reset_counts()
        d, e = eig.hetrd(At, "L")
        assert stage1 > 0 and pdd.ROUTED == stage1
        G, sref = _svd_ref(prec, 45, 45)
        s = eig.gesvd(_tile(G))
    _close(np.sort(_spectrum(d, e)), np.sort(_spectrum(*ref["hetrd"])), 1e-12)
    _close(s, sref["gesvd"], 1e-12)
