"""Port parity: the panel kernels — K3's wrapper and plain version
(``kernels/pallas_lu.py``), the LU half of ``kernels/panels.py`` and its
QR half (the TSQR tree panel, ``qr_panel``) — against the JAX package.

The reference K3 runs as the JAX package's own tests run it on the CPU:
its jitted ``_panel_call(a, True)`` in interpret mode. The CUDA kernel
itself is held against ``lu_panel_reference`` on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the permutation must be bitwise equal; the packed factor
within 1e-5 of max|packed| (f32; the two differ in rounding only: the
reference's rank-JB update is one 8-term product, the port's eight
rank-1 steps) or 1e-12 (f64). The QR half: relative Frobenius error
<= 1e-5 (f32) or 1e-12 (f64); both packages call LAPACK's QR on the
CPU, so they differ in summation order only.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import pallas_lu as ref_plu
from dplasma_tpu.kernels import pallas_qr as ref_pqr
from dplasma_tpu.kernels import panels as ref_panels
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.kernels import pallas_lu as plu
from dplasma_tpu_torch.kernels import pallas_qr as pqr
from dplasma_tpu_torch.kernels import panels
from dplasma_tpu_torch.ops import lu as port_lu
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.numpy().astype(np.float64)
    return np.abs(want - got).max() / np.abs(want).max()


def _ref_k3(a):
    """The reference Pallas kernel (interpret mode): packed + perm."""
    packed, swaps = ref_plu._panel_call(jnp.asarray(a), True)
    ipiv = np.arange(a.shape[0])
    ipiv[:a.shape[1]] = np.asarray(swaps)
    return np.asarray(packed), np.asarray(ref_lu.ipiv_to_perm(ipiv))


def _tie_panel():
    """Small integers, so many rows of a column share the largest |a|;
    column 3 is zero (its L must come out 0, not NaN) and a few entries
    are -0.0."""
    rng = np.random.default_rng(11)
    a = rng.integers(-2, 3, size=(24, 8)).astype(np.float32)
    a[:, 3] = 0.0
    a[a == 0] = np.where(np.arange((a == 0).sum()) % 2, 0.0, -0.0)
    return a


@pytest.mark.parametrize("M,nb", [(40, 16), (96, 32)])
def test_k3_plain_version_matches_reference_kernel(rng, M, nb):
    a = rng.standard_normal((M, nb)).astype(np.float32)
    want, wperm = _ref_k3(a)
    got, gperm = plu.lu_panel_reference(torch.from_numpy(a))
    assert gperm.dtype == torch.int64
    np.testing.assert_array_equal(gperm.numpy(), wperm)
    assert _rel(want, got) <= 1e-5
    # the contract: a[perm] = L U
    L = torch.tril(got, -1) + torch.eye(M, nb)
    U = torch.triu(got[:nb])
    assert torch.allclose(torch.from_numpy(a)[gperm], L @ U, atol=1e-5)


def test_k3_tie_case_and_zero_column():
    a = _tie_panel()
    want, wperm = _ref_k3(a)
    got, gperm = plu.lu_panel_reference(torch.from_numpy(a))
    np.testing.assert_array_equal(gperm.numpy(), wperm)
    assert _rel(want, got) <= 1e-5
    assert torch.isfinite(got).all()
    assert (got[4:, 3] == 0).all()         # zero pivot: L column is 0
    # the first pivot is the lowest row holding the column's max |a|
    col = np.abs(a[:, 0])
    assert gperm[0] == np.flatnonzero(col == col.max())[0]
    # the recursive panel breaks the same ties the same way
    rperm = panels.lu_panel_rec(torch.from_numpy(a))[1]
    np.testing.assert_array_equal(rperm.numpy(), wperm)


_GRID = [(40, 16), (40, 12), (8192, 256), (8193, 256), (262144, 8),
         (262145, 8), (1024, 2048), (7, 8)]
_DT = [(jnp.float32, torch.float32), (jnp.float64, torch.float64),
       (jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]


def test_k3_eligible_matches_reference():
    for (M, nb), (jdt, tdt) in itertools.product(_GRID, _DT):
        ja = jax.ShapeDtypeStruct((M, nb), jdt)
        ta = torch.empty((M, nb), dtype=tdt, device="meta")
        assert plu.eligible(ta) == ref_plu.eligible(ja), (M, nb, jdt)
    assert not plu.eligible(torch.empty(64, device="meta"))
    for m, nb, item in itertools.product([8, 1000, 8192, 65536],
                                         [8, 12, 256, 1024], [2, 4, 8]):
        assert plu.eligible_shape(m, nb, item) == \
            ref_pqr.eligible_shape(m, nb, item)
    assert (plu.JB, plu.VMEM_PANEL_BYTES) == (ref_pqr.JB,
                                              ref_pqr.VMEM_PANEL_BYTES)


def test_k3_wrapper_on_cpu_routes_to_plain_version(rng):
    a = torch.from_numpy(rng.standard_normal((100, 24)).astype(np.float32))
    routed, launches = plu.ROUTED, plu.LAUNCHES
    packed, perm = plu.lu_panel(a.T.contiguous().T)   # strided input
    want, wperm = plu.lu_panel_reference(a)
    assert torch.equal(packed, want) and torch.equal(perm, wperm)
    assert plu.ROUTED == routed + 1
    assert plu.LAUNCHES == launches       # no CUDA launch on the CPU


@pytest.mark.parametrize("shape,dtype,err", [
    ((64,), torch.float32, ValueError),
    ((64, 12), torch.float32, ValueError),     # nb not a multiple of 8
    ((8, 16), torch.float32, ValueError),      # M < nb
    ((64, 16), torch.float64, TypeError),
])
def test_k3_wrapper_rejects_what_the_kernel_does_not_take(shape, dtype,
                                                          err):
    with pytest.raises(err):
        plu.lu_panel(torch.zeros(shape, dtype=dtype))


def test_k3_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda"):
        plu.lu_panel(torch.zeros((64, 16), device="meta"))


@pytest.mark.parametrize("base", [None, 4])
def test_lu_panel_rec_matches_reference(rng, base):
    a = rng.standard_normal((40, 16))
    want, wperm = jax.jit(lambda x: ref_panels.lu_panel_rec(x, base))(
        jnp.asarray(a))
    got, gperm = panels.lu_panel_rec(torch.from_numpy(a), base)
    np.testing.assert_array_equal(gperm.numpy(), np.asarray(wperm))
    assert _rel(want, got) <= 1e-12
    want_np = jax.jit(lambda x: ref_panels.lu_panel_rec_nopiv(x, base))(
        jnp.asarray(a))
    got_np = panels.lu_panel_rec_nopiv(torch.from_numpy(a), base)
    assert _rel(want_np, got_np) <= 1e-12


def test_lu_panel_rec_f32_matches_reference(rng):
    a = rng.standard_normal((40, 16)).astype(np.float32)
    want, wperm = jax.jit(ref_panels.lu_panel_rec)(jnp.asarray(a))
    got, gperm = panels.lu_panel_rec(torch.from_numpy(a))
    np.testing.assert_array_equal(gperm.numpy(), np.asarray(wperm))
    assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("value", ["auto", "chain", "rec", "tree", "pallas",
                                   "bogus", "PALLAS"])
def test_panel_kernel_resolution_matches_reference(value):
    with cfg.override_scope({"panel.kernel": value}), \
            ref_cfg.override_scope({"panel.kernel": value}):
        assert panels.panel_kernel_config() == \
            ref_panels.panel_kernel_config()
        for route in ("qr", "lu", "nopiv"):
            assert panels.panel_kernel(route) == \
                ref_panels.panel_kernel(route), (value, route)


def test_rec_base_width_matches_reference():
    for v in ("8", "3", "0", "x"):
        with cfg.override_scope({"panel.rec_base": v}), \
                ref_cfg.override_scope({"panel.rec_base": v}):
            assert panels.rec_base_width() == ref_panels.rec_base_width()


@pytest.mark.parametrize("batch", [(), (3,)])
def test_swaps_to_perm_matches_sequential_swaps(rng, batch):
    m, kk = 50, 13
    swaps = np.stack([np.array([rng.integers(i, m) for i in range(kk)])
                      for _ in range(int(np.prod(batch)))]).reshape(
                          *batch, kk)
    got = port_lu._swaps_to_perm(torch.from_numpy(swaps), m).numpy()
    for idx in np.ndindex(*batch):
        want = np.arange(m)
        for i, p in enumerate(swaps[idx]):
            want[[i, p]] = want[[p, i]]
        np.testing.assert_array_equal(got[idx], want)


# ---------------------------------------------------------------------
# QR half: the TSQR tree panel and the route selection
# ---------------------------------------------------------------------

_FRO = {np.float32: 1e-5, np.float64: 1e-12}


def _fro(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got,
                     np.float64)
    return np.linalg.norm(want - got) / np.linalg.norm(want)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,leaf", [(40, 8, None), (100, 8, None),
                                      (96, 16, 24), (16, 16, None),
                                      (70, 12, 12)])
def test_tsqr_matches_reference(rng, dt, m, n, leaf):
    """Leaf counts 3 and 5 pad to 4 and 8 zero-padded blocks; m <= leaf
    is one plain QR."""
    a = rng.standard_normal((m, n)).astype(dt)
    wq, wr = jax.jit(lambda x: ref_panels.tsqr(x, leaf))(jnp.asarray(a))
    gq, gr = panels.tsqr(torch.from_numpy(a), leaf)
    assert gq.shape == (m, n) and gr.shape == (n, n)
    assert _fro(wq, gq) <= _FRO[dt] and _fro(wr, gr) <= _FRO[dt]
    assert torch.allclose(gq @ gr, torch.from_numpy(a),
                          atol=1e3 * float(np.finfo(dt).eps))
    none, r_only = panels.tsqr(torch.from_numpy(a), leaf, need_q=False)
    assert none is None and _fro(wr, r_only) <= _FRO[dt]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_geqrt_tree_matches_reference(rng, dt):
    a = rng.standard_normal((100, 16)).astype(dt)
    want = jax.jit(ref_panels.geqrt_tree)(jnp.asarray(a))
    got = panels.geqrt_tree(torch.from_numpy(a))
    for w, g in zip(want, got):
        assert _fro(w, g) <= _FRO[dt]


@pytest.mark.parametrize("leaf", ["1", "2", "4", "0"])
def test_tree_leaf_height_matches_reference(leaf):
    with cfg.override_scope({"panel.tree_leaf": leaf}), \
            ref_cfg.override_scope({"panel.tree_leaf": leaf}):
        for nb in (8, 32):
            assert panels.tree_leaf_height(nb) == \
                ref_panels.tree_leaf_height(nb)


@pytest.mark.parametrize("kind", ["chain", "tree", "pallas"])
@pytest.mark.parametrize("shape", [(64, 16), (64, 12)])
def test_qr_panel_routes_like_reference(rng, kind, shape):
    """``pallas`` takes K4 where its gate holds (nb % 8 == 0) and the
    tree elsewhere; ``chain`` is the vendor panel."""
    a = rng.standard_normal(shape).astype(np.float32)
    routed = pqr.ROUTED
    got = panels.qr_panel(torch.from_numpy(a), kind)
    to_k4 = kind == "pallas" and shape[1] % 8 == 0
    assert pqr.ROUTED - routed == (1 if to_k4 else 0)
    if to_k4:
        want = pqr.geqrt_panel(torch.from_numpy(a))
    else:
        want = jax.jit(lambda x: ref_panels.qr_panel(
            x, "tree" if kind == "pallas" else kind))(jnp.asarray(a))
    for w, g in zip(want, got):
        assert _fro(w, g) <= 1e-5
    with cfg.override_scope({"panel.kernel": kind}):
        again = panels.qr_panel(torch.from_numpy(a))
    for w, g in zip(got, again):
        assert torch.equal(w, g)
