"""Port parity: the f64-equivalent (dd) QR panels of ``dplasma_tpu_torch``
(``kernels.dd.geqrt_f64``, ``geqrt_f64_tree``) and the dd branch of
``ops.qr.geqrf`` under MCA ``dd_gemm=always`` against ``dplasma_tpu``, on
the very same inputs.

Both packages seed with f32 (a Cholesky of the Gram matrix, or a TSQR
tree's R) that torch and XLA round differently; limb-exact refinement
then pulls both to f64 accuracy, so packed factors, V and T agree within
max|Δ| <= 1e-12 · max|value|. Each ``panel.kernel`` route is held to the
SAME route of the reference (chain: limb CholeskyQR2; tree and pallas:
the tree-seeded panel; MCA ``qr_panel=lapack``: the vendor panel with dd
trailing products). The port's chain route gives a square panel (a
square matrix's last) to the tree panel, where the limb CholeskyQR2
loses orthogonality; the reference is run with the same choice of panel
through its ``panel_kernel`` argument. The reference's runs are shared
through a module-scoped fixture, and its panels are called through its
own jitted panel executable (``ops.qr._jit_dd_qr_panel``), whose 96×32
compile the N=96 sweeps reuse: its dd route compiles per shape. This
file holds the chain and lapack routes; ``test_torch_dd_qr_tree.py`` the
tree routes and ``geqrf_rec``; ``test_torch_dd_qr_solvers.py`` gelqf and
gels.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.ops import checks, qr
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-12
DD = {"dd_gemm": "always"}
ROUTES = {"chain": {"panel.kernel": "chain", "qr.agg_depth": "1"},
          "chain_agg2": {"panel.kernel": "chain", "qr.agg_depth": "2"},
          "lapack": {"qr_panel": "lapack", "qr.agg_depth": "1"}}


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = got.numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    return np.abs(want - got).max() / np.abs(want).max()


def _pair(M, N, nb, seed=3872):
    A = ref_gen.plrnt(M, N, nb, nb, seed=seed, dtype=jnp.float64)
    return A, TileMatrix.from_reference(np.asarray(A.data),
                                        dataclasses.asdict(A.desc),
                                        device="cpu")


def check_panel(kind, a, got):
    """``got`` (packed, V, T) of the 96×32 panel ``a`` against the
    reference's jitted dd panel of the same kind, within 1e-12; and the
    triple is a QR: Q = I − V T Vᵀ orthogonal and Qᵀ a upper triangular
    with R on its diagonal block, at the -x thresholds."""
    want = ref_qr._jit_dd_qr_panel(jnp.asarray(a), kind)
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL
    packed, v, t = (x.numpy() for x in got)
    m, n = a.shape
    q = np.eye(m) - v @ t @ v.T
    eps = np.finfo(np.float64).eps
    assert np.abs(q.T @ q - np.eye(m)).max() / (m * eps) < 60
    qa = q.T @ a
    assert np.abs(qa[:n] - np.triu(packed[:n])).max() / (
        np.abs(a).max() * m * eps) < 60
    assert np.abs(qa[n:]).max() / (np.abs(a).max() * m * eps) < 60


def _ref_chain_panel(col):
    """The port's chain route in the reference: limb CholeskyQR2, the
    tree panel on a square panel."""
    return ref_qr._jit_dd_qr_panel(
        col, "tree" if col.shape[0] <= col.shape[1] else "chain")


def test_geqrt_f64_matches_reference():
    a = np.random.default_rng(17).standard_normal((96, 32))
    check_panel("chain", a, dd.geqrt_f64(torch.from_numpy(a)))


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's dd runs, once: geqrf at N=96, nb=32 on every route
    of ROUTES."""
    A, T = _pair(96, 96, 32)
    out = {"A": T}
    for name, mca in ROUTES.items():
        with ref_cfg.override_scope(dict(DD, **mca)):
            out[name] = ref_qr.geqrf(A, panel_kernel=(
                _ref_chain_panel if name.startswith("chain") else None))
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_geqrf_dd_matches_reference(ref_runs, route):
    """Each route against the same route of the reference: the packed
    factor and the T factors within 1e-12."""
    T = ref_runs["A"]
    want_f, want_t = ref_runs[route]
    with cfg.override_scope(dict(DD, **ROUTES[route])):
        Af, Tf = qr.geqrf(T)
    assert _rel(want_f.data, Af.data) <= TOL
    assert _rel(want_t.data, Tf.data) <= TOL


@pytest.mark.parametrize("kind", ["chain", "tree"])
def test_geqrf_dd_ragged_passes_the_checks(kind):
    """A square N (its last panel, square, takes the tree panel on either
    kind), a ragged N (the identity-padded right edge keeps the pad panel
    full rank) and a tall M: |A − QR| and |I − QᵀQ| under the -x
    threshold."""
    for M, N in ((96, 96), (100, 100), (130, 100)):
        _, T = _pair(M, N, 32)
        with cfg.override_scope(dict(DD, **{"panel.kernel": kind})):
            Af, Tf = qr.geqrf(T)
            Q = qr.ungqr(Af, Tf).to_dense()
            R = torch.triu(Af.to_dense()[:N])
            rq, okq = checks.check_qr(T, Q, R)
            ro, oko = checks.check_orthogonality(Q)
        assert okq and oko and rq < 60 and ro < 60, (M, N, rq, ro)


@pytest.mark.parametrize("kind,per_panel", [("chain", 27), ("tree", 21)])
def test_geqrf_dd_k2_count(kind, per_panel):
    """The ops/qr.py docstring's count at N=256, nb=32 (KT=8,
    qr.agg_depth 4, lookahead 1): per_panel·(KT − 1) + 19 panel products
    (the last, square, a tree panel with no V2 solve), 3 a compact-WY
    apply, KT − 1 narrow applies and Σ_{k<KT−2} (k mod 4 + 1) far ones —
    268 (chain) and 226 (tree)."""
    _, T = _pair(256, 256, 32)
    kt = 8
    far = sum(k % 4 + 1 for k in range(kt - 2))
    routed = pdd.ROUTED
    with cfg.override_scope(dict(DD, **{"panel.kernel": kind,
                                        "qr.agg_depth": "4"})):
        qr.geqrf(T)
    assert pdd.ROUTED - routed == \
        per_panel * (kt - 1) + 19 + 3 * (kt - 1 + far)
    assert pdd.ROUTED - routed == {"chain": 268, "tree": 226}[kind]


def test_f32_never_takes_the_limb_route():
    _, T = _pair(96, 96, 32)
    T32 = TileMatrix(T.data.float(), T.desc)
    routed = pdd.ROUTED
    with cfg.override_scope(DD):
        Af, Tf = qr.geqrf(T32)
        qr.gels(T32, T32)
    assert pdd.ROUTED == routed and Af.dtype == torch.float32
