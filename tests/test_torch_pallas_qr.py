"""Port parity: K4's wrapper and plain version
(``dplasma_tpu_torch/kernels/pallas_qr.py``) against the JAX package.

The reference K4 runs as the JAX package's own tests run it on the CPU:
its jitted ``_geqrt_call(a, True)`` in interpret mode (the public
``geqrt_panel`` needs ``x64_scope`` patched to a null context under
this jax). The CUDA kernel itself is held against
``geqrt_panel_reference`` on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Gates: the packed panel within 1e-5 of max|packed| and the taus within
1e-5 (f32; the two sum in different orders), and every sign equal —
including the reference's rule that a column with nothing below its
diagonal reflects with tau = 2 (LAPACK's larfg would give 0).
"""
import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import householder as ref_hh
from dplasma_tpu.kernels import pallas_qr as ref_pqr
from dplasma_tpu_torch.kernels import pallas_lu as plu
from dplasma_tpu_torch.kernels import pallas_qr as pqr
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _ref_k4(a):
    packed, taus = ref_pqr._geqrt_call(jnp.asarray(a), True)
    return np.asarray(packed), np.asarray(taus)


def _panel(kind):
    rng = np.random.default_rng(7)
    if kind == "tall":
        return rng.standard_normal((96, 32)).astype(np.float32)
    if kind == "ragged":
        return rng.standard_normal((77, 24)).astype(np.float32)
    if kind == "square":
        return rng.standard_normal((32, 32)).astype(np.float32)
    a = rng.standard_normal((40, 16)).astype(np.float32)
    a[:, 3] = 0.0                       # zero column: tau 0, v 0
    return a


@pytest.mark.parametrize("kind", ["tall", "ragged", "square", "zero_column"])
def test_k4_plain_version_matches_reference_kernel(kind):
    a = _panel(kind)
    want, wtau = _ref_k4(a)
    got, gtau = pqr.geqrt_panel_reference(torch.from_numpy(a))
    assert got.dtype == torch.float32 and gtau.shape == (a.shape[1],)
    scale = np.abs(want).max()
    assert np.abs(want - got.numpy()).max() / scale <= TOL
    assert np.abs(wtau - gtau.numpy()).max() <= TOL
    big = np.abs(want) > 1e-3 * scale
    np.testing.assert_array_equal(np.sign(want[big]),
                                  np.sign(got.numpy()[big]))
    if kind == "square":
        # the last column has nothing below its diagonal: tau = 2 and
        # R[-1, -1] flips sign, on both sides
        assert float(gtau[-1]) == 2.0 == float(wtau[-1])
        lapack = ref_hh.geqrf_packed(jnp.asarray(a))[1]
        assert float(lapack[-1]) == 0.0
    if kind == "zero_column":
        assert float(gtau[3]) == 0.0 == float(wtau[3])
        assert (got[4:, 3] == 0).all() and torch.isfinite(got).all()


def test_k4_tall_panel_agrees_with_lapack(rng):
    """On a tall panel the reference's rule and LAPACK's coincide."""
    a = rng.standard_normal((80, 16)).astype(np.float32)
    got, gtau = pqr.geqrt_panel_reference(torch.from_numpy(a))
    want, wtau = ref_hh.geqrf_packed(jnp.asarray(a))
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5 * \
        np.abs(np.asarray(want)).max()
    assert np.abs(np.asarray(wtau) - gtau.numpy()).max() <= 1e-5


def test_geqrt_panel_contract_matches_reference(monkeypatch):
    """(packed, V, T) of the port's wrapper against the reference's
    public ``geqrt_panel`` (interpret mode)."""
    monkeypatch.setattr(ref_pqr, "x64_scope",
                        lambda e: contextlib.nullcontext())
    a = _panel("tall")
    want = ref_pqr.geqrt_panel(jnp.asarray(a))
    got = pqr.geqrt_panel(torch.from_numpy(a))
    for w, g in zip(want, got):
        w = np.asarray(w, np.float64)
        assert np.linalg.norm(w - g.numpy()) / np.linalg.norm(w) <= TOL
    # Q = I - V T V^T is orthogonal and Q [R; 0] = a
    packed, v, T = got
    q = torch.eye(96) - v @ T @ v.T
    assert torch.allclose(q.T @ q, torch.eye(96), atol=1e-5)
    r = torch.triu(packed[:32])
    assert torch.allclose(q[:, :32] @ r, torch.from_numpy(a), atol=1e-4)


_GRID = [(40, 16), (40, 12), (8192, 256), (8193, 256), (262144, 8),
         (262145, 8), (1024, 2048), (7, 8)]
_DT = [(jnp.float32, torch.float32), (jnp.float64, torch.float64),
       (jnp.bfloat16, torch.bfloat16)]


def test_k4_eligible_matches_reference():
    for (M, nb), (jdt, tdt) in itertools.product(_GRID, _DT):
        ja = jax.ShapeDtypeStruct((M, nb), jdt)
        ta = torch.empty((M, nb), dtype=tdt, device="meta")
        assert pqr.eligible(ta) == ref_pqr.eligible(ja), (M, nb, jdt)
    assert not pqr.eligible(torch.empty(64, device="meta"))
    for m, nb, item in itertools.product([8, 1000, 8192, 65536],
                                         [8, 12, 256, 1024], [2, 4, 8]):
        assert pqr.eligible_shape(m, nb, item) == \
            ref_pqr.eligible_shape(m, nb, item)
    assert (pqr.JB, pqr.VMEM_PANEL_BYTES) == (ref_pqr.JB,
                                              ref_pqr.VMEM_PANEL_BYTES)


def test_gate_has_one_home():
    """K3 routes by K4's module's gate, as the reference's pallas_lu
    imports it from pallas_qr."""
    assert plu.eligible_shape is pqr.eligible_shape
    assert (plu.JB, plu.VMEM_PANEL_BYTES) == (pqr.JB, pqr.VMEM_PANEL_BYTES)


def test_k4_wrapper_on_cpu_routes_to_plain_version(rng):
    a = torch.from_numpy(rng.standard_normal((100, 24)).astype(np.float32))
    routed, launches = pqr.ROUTED, pqr.LAUNCHES
    packed, taus = pqr.geqrt_panel_packed(a.T.contiguous().T)  # strided
    want, wtau = pqr.geqrt_panel_reference(a)
    assert torch.equal(packed, want) and torch.equal(taus, wtau)
    pqr.geqrt_panel(a)
    assert pqr.ROUTED == routed + 2
    assert pqr.LAUNCHES == launches       # no CUDA launch on the CPU


@pytest.mark.parametrize("shape,dtype,err", [
    ((64,), torch.float32, ValueError),
    ((64, 12), torch.float32, ValueError),     # nb not a multiple of 8
    ((8, 16), torch.float32, ValueError),      # M < nb
    ((64, 16), torch.float64, TypeError),
])
def test_k4_wrapper_rejects_what_the_kernel_does_not_take(shape, dtype,
                                                          err):
    with pytest.raises(err):
        pqr.geqrt_panel(torch.zeros(shape, dtype=dtype))


def test_k4_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda"):
        pqr.geqrt_panel(torch.zeros((64, 16), device="meta"))


def test_reset_counts():
    pqr.geqrt_panel(torch.ones((16, 8)))
    pqr.reset_counts()
    assert (pqr.ROUTED, pqr.LAUNCHES) == (0, 0)


def _block_rows(geom, m):
    """Per block of the cluster, as the kernels compute it: (first row,
    end row, rows in shared memory, rows read from the panel)."""
    out = []
    for r in range(geom.cluster):
        r0 = min(m, r * geom.rows_per_block)
        r1 = min(m, r0 + geom.rows_per_block)
        in_smem = min(r1 - r0, geom.smem_rows)
        out.append((r0, r1, in_smem, r1 - r0 - in_smem))
    return out


def _check_bounds(M, nb):
    """The geometry's closed-form invariants at one (M, nb)."""
    geom = pqr.launch_geometry(M, nb)
    assert 2 <= geom.cluster <= pqr.MAX_CLUSTER, (M, nb, geom)
    assert geom.smem_bytes <= pqr.SMEM_LIMIT, (M, nb, geom)
    # the kernels' dynamic shared memory: two buffers of the strip rows,
    # two staging areas of JB·nb floats and the nb pivots
    assert geom.smem_bytes == 4 * (2 * pqr.JB * geom.smem_rows
                                   + 2 * pqr.JB * nb + nb)
    assert 0 <= geom.smem_rows <= geom.rows_per_block
    # the cluster's blocks reach past the last row, and the last block
    # starts below it
    assert (geom.cluster - 1) * geom.rows_per_block < M \
        <= geom.cluster * geom.rows_per_block, (M, nb, geom)
    return geom


def _check_geometry(M, nb):
    """The closed-form invariants, then the blocks walked one by one."""
    geom = _check_bounds(M, nb)
    end = 0
    for r0, r1, in_smem, in_panel in _block_rows(geom, M):
        assert r0 == end and r1 >= r0, (M, nb, geom)
        assert in_smem + in_panel == r1 - r0 and in_panel >= 0
        assert in_smem <= geom.smem_rows
        end = r1
    assert end == M, (M, nb, geom)
    return geom


@pytest.mark.parametrize("nb", [8, 24, 64, 256])
def test_launch_geometry_covers_every_gated_shape(nb):
    """For every M the gate admits at this nb: the blocks' row ranges
    cover 0..M-1 once, the cluster has 2..16 blocks, the dynamic shared
    memory stays under the card's per-block limit, and every row a
    block cannot keep in shared memory is counted as read from the
    panel."""
    top = pqr.VMEM_PANEL_BYTES // (4 * nb)
    assert pqr.eligible_shape(top, nb) and not pqr.eligible_shape(
        top + 1, nb)
    prev = None
    for M in range(nb, top + 1):
        geom = _check_bounds(M, nb)
        # the blocks walked one by one wherever the geometry changes
        # (cluster size, rows per block, strip rows in shared memory),
        # at both ends of the gate, and at every 997th M between
        if geom != prev or M in (nb, top) or M % 997 == 0:
            _check_geometry(M, nb)
            if prev is not None:
                _check_geometry(M - 1, nb)
        prev = geom


@pytest.mark.parametrize("M,nb,cluster,overflow", [
    (8, 8, 2, False),            # M = nb, the smallest panel
    (100, 8, 2, False),          # few rows: at least 2 blocks
    (256, 256, 4, False),        # sgetrf's last panel
    (8192, 256, 16, False),      # the top panel: 16 blocks of 512 rows
    (8184, 256, 16, False),      # rows not a multiple of the cluster
    (1000, 64, 16, False),
    (262144, 8, 16, True),       # tall narrow: rows read from the panel
    (1448, 1448, 16, False),     # the widest panel the gate admits
])
def test_launch_geometry_named_shapes(M, nb, cluster, overflow):
    geom = _check_geometry(M, nb)
    assert geom.cluster == cluster
    assert any(p for *_, p in _block_rows(geom, M)) == overflow
    assert plu.launch_geometry is pqr.launch_geometry
