"""Port parity: the block-scaled int8 update route
(``dplasma_tpu_torch.kernels.quant``) against ``dplasma_tpu.kernels.quant``
on the very same inputs, and the f32 factorizations whose trailing
updates it carries under ``update_scope``.

``quantize`` is bitwise (q, scales and the pad blocks: the same f32
division, round-half-even and clamp). ``qgemm`` sums exact int32 block
products and dequantizes them in the reference's order (``acc + p·rs·cs``
in f32), so it comes out bitwise equal here too; the test holds it to
1e-6·max|ref|, which any order of the f32 dequantize passes. The
factorizations agree within 1e-5 relative: their quantized products
are the same, their f32 panels and solves round in the packages' own
orders.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import quant as ref_q
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu.ops import potrf as ref_potrf
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import quant
from dplasma_tpu_torch.ops import lu, qr
from dplasma_tpu_torch.ops import potrf as potrf_mod
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

QTOL = 1e-6
FTOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape,tile", [((100, 300), 32), ((64, 64), 32),
                                        ((37, 200), None), ((8, 9), 8)])
def test_quantize_and_dequantize_bitwise(rng, shape, tile):
    """q, scales (pad blocks at the 1e-30 floor included) and the
    dequantized round trip, bit for bit."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, : shape[1] // 3] *= 1e4          # blocks of very different scale
    jx, tx = _both(x)
    q1, s1 = ref_q.quantize(jx, tile)
    q2, s2 = quant.quantize(tx, tile)
    assert q2.dtype == torch.int8 and s2.dtype == torch.float32
    assert np.array_equal(np.asarray(q1), q2.numpy())
    assert np.array_equal(np.asarray(s1), s2.numpy())
    t = tile or 128
    assert q2.shape == (-(-shape[0] // t) * t, -(-shape[1] // t) * t)
    assert (q2.numpy()[shape[0]:] == 0).all()
    assert (q2.numpy()[:, shape[1]:] == 0).all()
    d1 = ref_q.dequantize(q1, s1, tile, shape=shape)
    d2 = quant.dequantize(q2, s2, tile, shape=shape)
    assert np.array_equal(np.asarray(d1), d2.numpy())


def test_quantize_zero_block_round_trips_to_zero():
    x = np.zeros((64, 64), np.float32)
    x[:32, :32] = 3.0
    q, s = quant.quantize(torch.from_numpy(x), 32)
    assert float(s[1, 1]) == np.float32(1e-30)
    assert torch.equal(quant.dequantize(q, s, 32), torch.from_numpy(x))


@pytest.mark.parametrize("m,kk,n,tile", [(100, 300, 70, 32),
                                         (96, 96, 96, None),
                                         (5, 40, 3, 8),
                                         (130, 257, 65, 64)])
def test_qgemm_matches_reference(rng, m, kk, n, tile):
    a = rng.standard_normal((m, kk)).astype(np.float32)
    b = rng.standard_normal((kk, n)).astype(np.float32)
    want = np.asarray(ref_q.qgemm(jnp.asarray(a), jnp.asarray(b), tile))
    got = quant.qgemm(torch.from_numpy(a), torch.from_numpy(b), tile)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert np.abs(want - got.numpy()).max() <= QTOL * np.abs(want).max()
    # within the quantization error of the exact product
    exact = a.astype(np.float64) @ b
    assert np.abs(exact - got.numpy()).max() <= 0.05 * np.abs(exact).max()


def test_qgemm_zero_dims_and_mismatch():
    z = quant.qgemm(torch.zeros(0, 5), torch.zeros(5, 3))
    assert z.shape == (0, 3) and z.dtype == torch.float32
    with pytest.raises(ValueError, match="inner"):
        quant.qgemm(torch.zeros(4, 5), torch.zeros(6, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True)])
def test_update_dot_falls_through_bitwise(rng, dtype, ta, tb):
    """Inactive route (the default, or f64 under int8): ``update_dot`` is
    ``blas.dot`` verbatim."""
    a = torch.from_numpy(rng.standard_normal((40, 40))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((40, 24))).to(dtype)
    bb = b.T.contiguous() if tb else b
    assert torch.equal(quant.update_dot(a, bb, ta=ta, tb=tb),
                       k.dot(a, bb, ta=ta, tb=tb))
    if dtype == torch.float64:
        with quant.update_scope() as guards:
            assert torch.equal(quant.update_dot(a, bb, ta=ta, tb=tb),
                               k.dot(a, bb, ta=ta, tb=tb))
        assert guards == []


def test_update_scope_routes_records_and_restores(rng):
    a = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert quant.quant_params()[1] == "off"
    depth = cfg.override_depth()
    with cfg.override_scope({"quant.tile": "32"}):
        with quant.update_scope() as guards:
            assert quant.quant_params()[1] == "int8"
            got = quant.update_dot(ta, tb, ta=True)
            assert torch.equal(got, quant.qgemm(ta.T, tb))
            with quant.update_scope(guard=False) as inner:
                quant.update_dot(ta, tb, ta=True)
            assert inner is guards          # no fresh collector
        assert len(guards) == 2
        # the ones-probe against the reference's on the same product:
        # a normalised f32 difference, whose two matvecs round in each
        # package's own order (K·eps_f32 ~ 4e-6 at K = 64)
        want = ref_q.probe_residual(jnp.asarray(a.T), jnp.asarray(b),
                                    jnp.asarray(got.numpy()))
        assert abs(float(guards[0]) - float(want)) <= 1e-5
        gm = quant.guard_max(guards)
        assert gm.dtype == torch.float32 and float(gm) > 0
        assert float(gm) == max(float(g) for g in guards)
    assert quant.quant_params()[1] == "off"
    assert cfg.override_depth() == depth and quant._GUARD is None
    assert float(quant.guard_max([])) == 0.0
    with cfg.override_scope({"quant.guard": "off"}):
        with quant.update_scope() as guards:
            quant.update_dot(ta.T.contiguous(), tb)
        assert guards == []


def _pair(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    return np.abs(want - got).max() / np.abs(want).max()


def test_factorizations_with_int8_updates_match_reference():
    """potrf, getrf_1d and geqrf on f32 under ``update_scope``: every
    update product quantized in both packages (the factor moves away
    from the unquantized one), the factors within 1e-5 of the
    reference's, the same pivots, and a positive guard."""
    n, nb = 96, 32
    A = ref_gen.plghe(float(n), n, nb, seed=11, dtype=jnp.float32)
    G = ref_gen.plrnt(n, n, nb, nb, seed=8, dtype=jnp.float32,
                      diagdom=True)
    Q = ref_gen.plrnt(128, n, nb, nb, seed=9, dtype=jnp.float32)
    with ref_cfg.override_scope({"quant.tile": "32"}):
        with ref_q.update_scope():
            want_c = ref_potrf.potrf(A, "L")
            want_lu, want_p = ref_lu.getrf_1d(G)
            want_qr, _ = ref_qr.geqrf(Q)
    tA, tG, tQ = _pair(A), _pair(G), _pair(Q)
    with cfg.override_scope({"quant.tile": "32"}):
        with quant.update_scope() as guards:
            got_c = potrf_mod.potrf(tA, "L")
            got_lu, got_p = lu.getrf_1d(tG)
            got_qr, _ = qr.geqrf(tQ)
    assert len(guards) > 0 and float(quant.guard_max(guards)) > 0
    assert _rel(want_c.data, got_c.data) <= FTOL
    assert np.array_equal(np.asarray(want_p), got_p.numpy())
    assert _rel(want_lu.data, got_lu.data) <= FTOL
    assert _rel(want_qr.data, got_qr.data) <= FTOL
    # the route really ran: the unquantized factor differs
    assert not torch.equal(got_c.data, potrf_mod.potrf(tA, "L").data)
