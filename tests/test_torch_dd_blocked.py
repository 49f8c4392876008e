"""Port parity: the blocked f64-equivalent Cholesky
(``dplasma_tpu_torch.kernels.dd.potrf_f64_blocked``) against
``dplasma_tpu.kernels.dd``, and the live-rows form of its block columns.

Tolerance: max|ΔL| <= 1e-12 · max|L| (f32 seeds round differently in
torch and XLA; refinement on exact residuals pulls both to f64), and the
reference's residual measure below 60.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu_torch.kernels import dd
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12


def _resid(a, b):
    """max|a − b| / (max|b| · n · eps64), the reference's measure."""
    return np.abs(a - b).max() / (np.abs(b).max() * a.shape[0]
                                  * np.finfo(np.float64).eps)


@pytest.mark.parametrize("lower", [True, False])
def test_potrf_f64_blocked(lower):
    """N=192, nb=64 (nt = 3): the trailing products, the cache and the
    last-column tile, against the reference's eager blocked route."""
    rng = np.random.default_rng(51)
    N, nb = 192, 64
    q = rng.standard_normal((N, N))
    A = q @ q.T + N * np.eye(N)
    junk = A.copy()                          # the unread triangle: noise
    junk[np.triu_indices(N, 1) if lower else np.tril_indices(N, -1)] = 7e3
    want = ref_dd.potrf_f64_blocked(jnp.asarray(junk), nb=nb, lower=lower)
    got = dd.potrf_f64_blocked(torch.from_numpy(junk), nb=nb, lower=lower)
    want = np.asarray(want)
    assert np.abs(want - got.numpy()).max() / np.abs(want).max() <= TOL
    L = got.numpy() if lower else got.numpy().T
    assert np.abs(np.triu(L, 1)).max() == 0.0
    assert _resid(L @ L.T, A) < 60


def test_live_rows_equal_the_fixed_slab():
    """The reference runs each block column on a fixed (N, nb) slab whose
    rows below the live N − s are zero, with the row scales rolled (for
    XLA's compile cache); the port works on the live rows. Zero rows
    change no live row: the panel solve and the limb split of the padded
    slab, cut to the live rows, equal those of the live slab bitwise —
    in the reference's own functions and in the port's."""
    rng = np.random.default_rng(5)
    N, nb, s = 192, 32, 64
    live = N - s
    q = rng.standard_normal((nb, nb))
    L = np.linalg.cholesky(q @ q.T + nb * np.eye(nb))
    slab = np.zeros((N, nb))
    slab[:live] = rng.standard_normal((live, nb)) * 3.0
    diag = np.abs(rng.standard_normal(N)) * 50.0 + 1.0
    w, nl, _ = ref_dd._plan(N, 53)
    # the reference: its panel solve and split, padded vs live
    sc = ref_dd._row_norm_scales(jnp.asarray(diag))[:, None]
    rolled = jnp.roll(sc, -s, axis=0)
    pan = ref_dd._panel_trsm_ir(jnp.asarray(L), jnp.asarray(slab[nb:]))
    pan_live = ref_dd._panel_trsm_ir(jnp.asarray(L),
                                     jnp.asarray(slab[nb:live]))
    np.testing.assert_array_equal(np.asarray(pan)[:live - nb],
                                  np.asarray(pan_live))
    col = jnp.concatenate([jnp.asarray(L), pan], axis=0)
    limbs = ref_dd._split_fixed(col.T, rolled[:, 0][None, :], w, nl)
    limbs_live = ref_dd._split_fixed(col[:live], sc[s:], w, nl)
    for a, b in zip(limbs, limbs_live):
        np.testing.assert_array_equal(np.asarray(a)[:, :live],
                                      np.asarray(b).T)
    # the port's functions, padded vs live
    tL, tslab = torch.from_numpy(L), torch.from_numpy(slab)
    assert torch.equal(dd._panel_trsm_ir(tL, tslab[nb:])[:live - nb],
                       dd._panel_trsm_ir(tL, tslab[nb:live]))
