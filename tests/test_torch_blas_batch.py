"""The tile products and Householder appliers with leading batch axes
(``kernels/blas.dot`` and ``tri``, ``householder.split_qr``, ``larft``,
``apply_q``, ``apply_q_right``): the band sweeps run them on a leading
window axis, where the reference uses ``vmap``.

* On 2-D operands every result is ``torch.equal`` to the 2-D-only
  implementation they replace (copied below as ``_old_*``: ``.T`` for
  the transposes, ``torch.diag`` for T's right-hand side), in s/d/c/z.
* A batched call equals the loop of 2-D calls over the batch, within
  4·eps relative (a batched product may sum in another order than a
  single one).
* 3-D operands never take K1 or the limb route: with K1 enabled and
  under ``dd_gemm=always`` their products go to ``torch.matmul`` in
  their own dtype (the stage-2 departure of ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

from dplasma_tpu_torch.kernels import blas as k
from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

DT = {"s": torch.float32, "d": torch.float64, "c": torch.complex64,
      "z": torch.complex128}


def _old_dot(a, b, ta=False, tb=False, conj_a=False, conj_b=False):
    res = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(res), b.to(res)
    if conj_a:
        a = a.conj()
    if conj_b:
        b = b.conj()
    if ta:
        a = a.T
    if tb:
        b = b.T
    return torch.matmul(a, b).to(res)


def _old_tri(x, lower=True, unit=False):
    t = torch.tril(x) if lower else torch.triu(x)
    if unit:
        t = t.clone()
        t.diagonal().fill_(1)
    return t


def _old_larft(v, taus):
    n = taus.shape[0]
    s = _old_dot(v, v, ta=True, conj_a=True)
    b = torch.triu(s, 1)
    taus = taus.to(v.dtype)
    m = torch.eye(n, dtype=v.dtype) + taus[:, None] * b
    return torch.linalg.solve_triangular(m, torch.diag(taus), upper=True,
                                         left=True, unitriangular=True)


def _rand(shape, prec, seed):
    g = np.random.default_rng(seed)
    a = g.standard_normal(shape)
    if prec in "cz":
        a = a + 1j * g.standard_normal(shape)
    return torch.from_numpy(a).to(DT[prec])


def _batched_close(got, want):
    eps = torch.finfo(want.real.dtype if want.is_complex()
                      else want.dtype).eps
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 4 * eps * scale * \
        want.shape[-1]


@pytest.mark.parametrize("prec", list(DT))
def test_two_d_results_equal_the_old_ones(prec):
    a, b = _rand((13, 9), prec, 0), _rand((13, 7), prec, 1)
    for ta, ca in ((True, True), (True, False)):
        assert torch.equal(k.dot(a, b, ta=ta, conj_a=ca),
                           _old_dot(a, b, ta=ta, conj_a=ca))
    c = _rand((7, 9), prec, 2)
    assert torch.equal(k.dot(a, c, tb=True, conj_b=True),
                       _old_dot(a, c, tb=True, conj_b=True))
    for lower in (True, False):
        assert torch.equal(k.tri(a, lower, True), _old_tri(a, lower, True))
    packed, taus = torch.geqrf(a)
    v, r = hh.split_qr(packed)
    assert torch.equal(v, _old_tri(packed, True, True))
    assert torch.equal(r, torch.triu(packed[:9, :]))
    t = hh.larft(v, taus)
    assert torch.equal(t, _old_larft(v, taus))
    x = _rand((13, 5), prec, 3)
    y = _rand((5, 13), prec, 4)
    for tr in ("C", "N"):
        tt = t.mH if tr == "C" else t
        want = x - _old_dot(v, _old_dot(tt, _old_dot(v, x, ta=True,
                                                     conj_a=True)))
        assert torch.equal(hh.apply_q(v, t, x, trans=tr), want)
        want = y - _old_dot(_old_dot(_old_dot(y, v), tt), v, tb=True,
                            conj_b=True)
        assert torch.equal(hh.apply_q_right(v, t, y, trans=tr), want)


@pytest.mark.parametrize("prec", list(DT))
def test_batched_calls_equal_a_loop(prec):
    G = 4
    blk = _rand((G, 11, 11), prec, 5)
    blk[:, :, 8:] = 0                    # masked columns, as the sweeps
    packed, taus = torch.geqrf(blk)
    v, r = hh.split_qr(packed)
    t = hh.larft(v, taus)
    R = _rand((G, 11, 30), prec, 6)
    C = _rand((G, 30, 11), prec, 7)
    left = hh.apply_q(v, t, R, trans="C")
    right = hh.apply_q_right(v, t, C, trans="N")
    for g in range(G):
        vg, rg = hh.split_qr(packed[g])
        assert torch.equal(v[g], vg) and torch.equal(r[g], rg)
        tg = hh.larft(vg, taus[g])
        _batched_close(t[g], tg)
        _batched_close(left[g], hh.apply_q(vg, tg, R[g], trans="C"))
        _batched_close(right[g], hh.apply_q_right(vg, tg, C[g], trans="N"))
    assert torch.equal(k.tri(blk, False, True)[1],
                       k.tri(blk[1], False, True))


def test_batched_products_stay_native():
    a = torch.randn(3, 300, 300, dtype=torch.float32)
    pk.enable(True)
    try:
        pk.reset_counts()
        got = k.dot(a, a, ta=True)
        assert pk.ROUTED == 0
        assert torch.equal(got, torch.matmul(a.mT, a))
        assert pk.eligible(a[0], a[0])
    finally:
        pk.enable(False)
    a64 = torch.randn(2, 40, 40, dtype=torch.float64)
    with cfg.override_scope({"dd_gemm": "always"}):
        pdd.reset_counts()
        assert torch.equal(k.dot(a64, a64, tb=True),
                           torch.matmul(a64, a64.mT))
        assert pdd.ROUTED == 0
        k.dot(a64[0], a64[0])
        assert pdd.ROUTED > 0
