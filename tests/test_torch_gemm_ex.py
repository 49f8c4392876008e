"""Port parity: the GEMM dispatcher (``ops/gemm.py``) against the
reference's.

Held: ``plan_gemm`` equal to the reference's (algorithm, b, c, d,
look_ahead) with the device memory set equal on both sides, over shapes,
transposes, info keys and the ``device.hbm_fraction`` / ``gemm.lookahead``
MCA knobs; ``gemm_stream`` and ``gemm_ex`` against the reference for
every transa/transb pair in s/d/c/z on a ragged problem (C 37×29 with
8×8 tiles, K = 21, streamed in 16×24 blocks over 16-deep k-chunks, so
edge blocks and a zero-padded last chunk) within 1e-5 (s/c) / 1e-12
(d/z) relative to the largest entry; the one ``blas.dot`` (K1 when
enabled) per chunk; the ``summa`` plan under a virtual mesh, whose
``gemm_ex`` runs SUMMA and gives the reference's ``gemm_summa``
(test_torch_cyclic_blas3.py holds it on more grids and dtypes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import gemm as ref_gemm
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.parallel import mesh as ref_mesh
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import gemm
from dplasma_tpu_torch.parallel import mesh
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DT = {"s": (jnp.float32, 1e-5), "d": (jnp.float64, 1e-12),
      "c": (jnp.complex64, 1e-5), "z": (jnp.complex128, 1e-12)}
TRANS = [(a, b) for a in "NTC" for b in "NTC"]
M, N, K, NB = 37, 29, 21, 8
INFO = {"DPLASMA:GEMM:GPU:B": 2, "DPLASMA:GEMM:GPU:C": 3,
        "DPLASMA:GEMM:GPU:D": 2}


def _tile(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _operands(prec, ta, tb):
    jd = DT[prec][0]
    A = ref_gen.plrnt(*((M, K) if ta == "N" else (K, M)), NB, NB, seed=1,
                      dtype=jd)
    B = ref_gen.plrnt(*((K, N) if tb == "N" else (N, K)), NB, NB, seed=2,
                      dtype=jd)
    C = ref_gen.plrnt(M, N, NB, NB, seed=3, dtype=jd)
    return A, B, C


@pytest.fixture
def memory(monkeypatch):
    """Both packages see the same device memory."""
    def set_to(nbytes):
        monkeypatch.setattr(ref_gemm, "device_memory_bytes",
                            lambda default_gb=16.0: nbytes)
        monkeypatch.setattr(gemm, "device_memory_bytes",
                            lambda device=None, default_gb=16.0: nbytes)
    return set_to


def _plans_equal(Cr, Ar, Br, ta, tb, info, algo):
    want = ref_gemm.plan_gemm(Cr, Ar, Br, ta, tb,
                              ref_cfg.Info(info) if info else None, algo)
    got = gemm.plan_gemm(_tile(Cr), _tile(Ar), _tile(Br), ta, tb,
                         cfg.Info(info) if info else None, algo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


@pytest.mark.parametrize("ta,tb", [("N", "N"), ("T", "N"), ("N", "C")])
def test_plan_gemm_equals_reference(memory, ta, tb):
    A, B, C = _operands("d", ta, tb)
    for nbytes in (10**5, 2**20, 16 * 2**30):
        memory(nbytes)
        for algo in ("auto", "stream", "dot"):
            for info in (None, INFO, {"DPLASMA:GEMM:GPU:LOOK_AHEAD": 5},
                         {"DPLASMA:GEMM:GPU:B": "x"}):
                _plans_equal(C, A, B, ta, tb, info, algo)
    memory(10**4)
    assert _plans_equal(C, A, B, ta, tb, None, "auto").algo == "stream"
    for kv in ({"device.hbm_fraction": "1e9"},
               {"device.hbm_fraction": "bad"}, {"gemm.lookahead": "4"}):
        with cfg.override_scope(kv), ref_cfg.override_scope(kv):
            for algo in ("auto", "stream"):
                _plans_equal(C, A, B, ta, tb, None, algo)


def test_device_memory_default_and_knobs():
    assert gemm.device_memory_bytes("cpu") == 16 * 2**30
    assert gemm.device_memory_bytes("cpu", default_gb=2) == 2**31
    assert cfg.mca_get("device.hbm_fraction") == "0.95"
    assert cfg.mca_get("gemm.lookahead") == "2"


@pytest.mark.parametrize("ta,tb", TRANS)
@pytest.mark.parametrize("prec", list(DT))
def test_gemm_stream_matches_reference(prec, ta, tb):
    A, B, C = _operands(prec, ta, tb)
    plan = ref_gemm.plan_gemm(C, A, B, ta, tb, ref_cfg.Info(INFO),
                              algo="stream")
    # one compile of the whole streamed product (eager, each block's
    # scan compiles apart)
    want = jax.jit(lambda a, b, c: ref_gemm.gemm_stream(
        0.7, a, b, -0.4, c, ta, tb, plan))(A, B, C)
    pplan = gemm.plan_gemm(_tile(C), _tile(A), _tile(B), ta, tb,
                           cfg.Info(INFO), algo="stream")
    assert (pplan.b, pplan.c, pplan.d) == (plan.b, plan.c, plan.d) == \
        (2, 3, 2)
    C0 = _tile(C)
    before = C0.data.clone()
    got = gemm.gemm_stream(0.7, _tile(A), _tile(B), -0.4, C0, ta, tb, pplan)
    assert torch.equal(C0.data, before) and got.dtype == C0.dtype
    scale = max(np.abs(np.asarray(want.data)).max(), 1.0)
    err = np.abs(got.data.numpy() - np.asarray(want.data)).max()
    assert err <= DT[prec][1] * scale


@pytest.mark.parametrize("prec", list(DT))
def test_gemm_ex_dispatch_matches_reference(memory, prec):
    A, B, C = _operands(prec, "T", "N")
    for nbytes in (16 * 2**30, 10**4):      # "dot", then "stream"
        memory(nbytes)
        want = jax.jit(lambda a, b, c: ref_gemm.gemm_ex(
            1.5, a, b, 0.5, c, "T", "N"))(A, B, C)
        got = gemm.gemm_ex(1.5, _tile(A), _tile(B), 0.5, _tile(C), "T", "N")
        err = np.abs(got.data.numpy() - np.asarray(want.data)).max()
        assert err <= DT[prec][1] * max(np.abs(np.asarray(want.data)).max(),
                                        1.0)
    want = jax.jit(lambda a, b, c: ref_gemm.gemm_ex(
        1.0, a, b, 0.0, c, "T", "N", ref_cfg.Info(INFO),
        algo="stream"))(A, B, C)
    got = gemm.gemm_ex(1.0, _tile(A), _tile(B), 0.0, _tile(C), "T", "N",
                       cfg.Info(INFO), algo="stream")
    assert np.abs(got.data.numpy() - np.asarray(want.data)).max() <= \
        DT[prec][1] * max(np.abs(np.asarray(want.data)).max(), 1.0)


def test_gemm_stream_one_dot_per_chunk():
    """One ``blas.dot`` — one K1 launch on the card — per block and
    k-chunk: 2 × 2 blocks × 3 chunks (K = 700 padded to 768)."""
    g = np.random.default_rng(3)
    A = TileMatrix.from_dense(torch.from_numpy(
        g.standard_normal((512, 700)).astype(np.float32)), 256, 256)
    B = TileMatrix.from_dense(torch.from_numpy(
        g.standard_normal((700, 512)).astype(np.float32)), 256, 256)
    C = TileMatrix.zeros(512, 512, 256, 256, device="cpu")
    plan = gemm.GemmPlan("stream", b=1, c=1, d=1)
    was = pk.enabled()
    pk.enable(True)
    pk.reset_counts()
    try:
        out = gemm.gemm_stream(1.0, A, B, 0.0, C, plan=plan)
    finally:
        pk.enable(was)
    assert pk.ROUTED == 2 * 2 * 3 and pk.LAUNCHES == 0
    want = A.to_dense().double() @ B.to_dense().double()
    assert float((out.to_dense() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


def test_summa_plan_under_a_grid_matches_reference(devices8):
    A, B, C = _operands("s", "N", "N")
    At, Bt, Ct = _tile(A), _tile(B), _tile(C)
    with mesh.use_grid(mesh.make_mesh(2, 2, "cpu")), \
            ref_mesh.use_grid(ref_mesh.make_mesh(2, 2)):
        assert gemm.plan_gemm(Ct, At, Bt).algo == "summa"
        want = ref_gemm.gemm_summa(1.0, A, B, 0.5, C)
        got = gemm.gemm_ex(1.0, At, Bt, 0.5, Ct)
    assert np.abs(got.data.numpy() - np.asarray(want.data)).max() <= \
        1e-5 * np.abs(np.asarray(want.data)).max()
    # without a grid gemm_summa is the one product, as in the reference
    want = ref_gemm.gemm_summa(1.0, A, B, 0.5, C)
    got = gemm.gemm_summa(1.0, At, Bt, 0.5, Ct)
    assert np.abs(got.data.numpy() - np.asarray(want.data)).max() <= 1e-5
    with pytest.raises(NotImplementedError, match="item 15"):
        gemm.dag(Ct, At, Bt)
