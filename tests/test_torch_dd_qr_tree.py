"""Port parity: the tree-seeded f64-equivalent (dd) QR panel
(``kernels.dd.geqrt_f64_tree``) and the dd ``geqrf`` routes that take it
(MCA ``panel.kernel`` tree, and pallas: K4 is an f32 kernel, so the dd
route resolves pallas to the tree panel in both packages), and
``geqrf_rec`` under ``dd_gemm=always``, against ``dplasma_tpu`` on the
very same inputs, within max|Δ| <= 1e-12 · max|value| (the f32 TSQR
seeds round differently; refinement pulls both to f64 accuracy).
``test_torch_dd_qr.py`` holds the chain and lapack routes.
"""
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_qr as pqr
from dplasma_tpu_torch.ops import checks, qr
from dplasma_tpu_torch.utils import config as cfg
from test_torch_dd_qr import DD, TOL, _pair, _rel, check_panel
from torch_threads import one_torch_thread  # noqa: F401

ROUTES = {"tree": {"panel.kernel": "tree", "qr.agg_depth": "1"},
          "tree_agg2": {"panel.kernel": "tree", "qr.agg_depth": "2"},
          "pallas": {"panel.kernel": "pallas", "qr.agg_depth": "4"}}


def test_geqrt_f64_tree_matches_reference():
    a = np.random.default_rng(19).standard_normal((96, 32))
    check_panel("tree", a, dd.geqrt_f64_tree(torch.from_numpy(a)))


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's dd runs, once: geqrf at N=96, nb=32 on every route
    of ROUTES, and geqrf_rec at N=64, nb=32 with hnb=16."""
    A, T = _pair(96, 96, 32)
    out = {"A": T}
    for name, mca in ROUTES.items():
        with ref_cfg.override_scope(dict(DD, **mca)):
            out[name] = ref_qr.geqrf(A)
    A, T = _pair(64, 64, 32)
    with ref_cfg.override_scope(DD):
        out["rec"] = T, ref_qr.geqrf_rec(A, 16)
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_geqrf_dd_tree_matches_reference(ref_runs, route):
    """The packed factor and T within 1e-12 of the same route of the
    reference; under pallas no panel takes K4."""
    routed = pqr.ROUTED
    with cfg.override_scope(dict(DD, **ROUTES[route])):
        Af, Tf = qr.geqrf(ref_runs["A"])
    assert pqr.ROUTED == routed
    want_f, want_t = ref_runs[route]
    assert _rel(want_f.data, Af.data) <= TOL
    assert _rel(want_t.data, Tf.data) <= TOL


def test_geqrf_rec_dd_matches_reference(ref_runs):
    """geqrf_rec's hnb-wide panels are the native f64 Householder panels
    (an explicit panel callable bypasses the dd panel, as in the
    reference); their applies and T merges ride the limb route. The
    factor and T within 1e-12, and the -x checks."""
    T, (want_f, want_t) = ref_runs["rec"]
    routed = pdd.ROUTED
    with cfg.override_scope(DD):
        Af, Tf = qr.geqrf_rec(T, 16)
        Q = qr.ungqr(Af, Tf).to_dense()
        rq, okq = checks.check_qr(T, Q, torch.triu(Af.to_dense()))
        ro, oko = checks.check_orthogonality(Q)
    assert pdd.ROUTED > routed
    assert _rel(want_f.data, Af.data) <= TOL
    assert _rel(want_t.data, Tf.data) <= TOL
    assert okq and oko and rq < 60 and ro < 60
