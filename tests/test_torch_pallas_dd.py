"""K2's plain version and route (``dplasma_tpu_torch.kernels.pallas_dd``)
on the CPU, against the reference.

- :func:`recombine_base_reference` is bitwise equal to the reference's
  exact recombine (``dd._recombine_scale_base`` off the TPU);
- it is within 2^-45 of max|product| of the Pallas double-single kernel
  itself, run in interpret mode (the DS width contract of
  ``dplasma_tpu/kernels/pallas_dd.py``). The test calls the jitted
  ``_recombine_call`` directly: the public ``recombine_base`` wraps it in
  an x64 scope that this jax does not offer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu.kernels import pallas_dd as ref_pdd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(nl, M, N, seed, lo=-2 ** 30, hi=2 ** 30):
    rng = np.random.default_rng(seed)
    lv = rng.integers(lo, hi, (nl, M, N)).astype(np.int32)
    base = rng.standard_normal((M, N)) * 8.0
    sa = 2.0 ** rng.integers(-2, 3, (M, 1)).astype(np.float64)
    sb = 2.0 ** rng.integers(-2, 3, (1, N)).astype(np.float64)
    return lv, base, sa, sb


def _bits(x):
    return np.asarray(x).view(np.int64)


@pytest.mark.parametrize("nl,M,N", [(8, 64, 128), (5, 37, 19), (8, 1, 1)])
@pytest.mark.parametrize("with_base", [True, False])
def test_plain_version_is_the_exact_recombine(nl, M, N, with_base):
    lv, base, sa, sb = _inputs(nl, M, N, seed=nl + M)
    lv[0, 0, :] = 2 ** 31 - 1              # the extreme levels
    lv[-1, -1, :] = -(2 ** 31 - 1)
    jb = jnp.asarray(base) if with_base else None
    tb = torch.from_numpy(base) if with_base else None
    # the gemm_f64 form negates sa when there is no base
    sgn = 1.0 if with_base else -1.0
    want = ref_dd._recombine_scale_base(list(jnp.asarray(lv)), jb,
                                        sgn * jnp.asarray(sa),
                                        jnp.asarray(sb), 7)
    got = pdd.recombine_base_reference(torch.from_numpy(lv), tb,
                                       sgn * torch.from_numpy(sa),
                                       torch.from_numpy(sb), 7)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_plain_version_within_ds_width_of_the_pallas_kernel():
    M, N, nl, w = 64, 128, 8, 7
    lv, base, sa, sb = _inputs(nl, M, N, seed=3)
    f32 = jnp.float32
    bh = jnp.asarray(base).astype(f32)
    bl = (jnp.asarray(base) - bh.astype(jnp.float64)).astype(f32)
    oh, ol = ref_pdd._recombine_call(jnp.asarray(lv), bh, bl,
                                     jnp.asarray(sa).astype(f32),
                                     jnp.asarray(sb).astype(f32), w, True)
    ds = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    got = pdd.recombine_base_reference(
        torch.from_numpy(lv), torch.from_numpy(base), torch.from_numpy(sa),
        torch.from_numpy(sb), w).numpy()
    prod = base - got
    assert np.abs(ds - got).max() / np.abs(prod).max() < 2.0 ** -45


def test_eligible_and_the_cpu_route():
    lv, base, sa, sb = _inputs(8, 16, 24, seed=1)
    tlv = torch.from_numpy(lv)
    assert cfg.mca_get("dd_epilogue") == "auto"
    assert pdd.eligible(tlv)
    assert not pdd.eligible(tlv.double())       # chunked levels: plain
    with cfg.override_scope({"dd_epilogue": "off"}):
        assert not pdd.eligible(tlv)
    routed, launches = pdd.ROUTED, pdd.LAUNCHES
    args = (torch.from_numpy(base), torch.from_numpy(sa),
            torch.from_numpy(sb), 7)
    got = pdd.recombine_base(tlv, *args)
    assert (pdd.ROUTED, pdd.LAUNCHES) == (routed + 1, launches)
    assert torch.equal(got, pdd.recombine_base_reference(tlv, *args))


def test_wrapper_rejects_bad_operands():
    lv, base, sa, sb = _inputs(5, 8, 8, seed=2)
    tlv, tb = torch.from_numpy(lv), torch.from_numpy(base)
    tsa, tsb = torch.from_numpy(sa), torch.from_numpy(sb)
    with pytest.raises(TypeError, match="int32"):
        pdd.recombine_base(tlv.long(), tb, tsa, tsb, 7)
    with pytest.raises(TypeError, match="f64"):
        pdd.recombine_base(tlv, tb.float(), tsa, tsb, 7)
    with pytest.raises(TypeError, match="base"):
        pdd.recombine_base(tlv, tb[:4], tsa, tsb, 7)
    with pytest.raises(TypeError, match="int32"):
        pdd.recombine_base(tlv[0], tb, tsa, tsb, 7)
    pdd.reset_counts()
    assert pdd.ROUTED == 0 and pdd.LAUNCHES == 0
