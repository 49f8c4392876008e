"""Port parity: ``gelqf`` and ``gels`` of ``dplasma_tpu_torch`` under MCA
``dd_gemm=always`` on the chain panels (limb CholeskyQR2) against
``dplasma_tpu``, on the very same inputs, within max|Δ| <= 1e-12 ·
max|value|: gelqf of a wide 96×160 matrix and gels of a tall 160×96
one, whose panels are all tall, so both packages take the chain panel
on every one. ``test_torch_dd_qr.py`` holds geqrf's routes.
"""
import pytest

from dplasma_tpu.ops import qr as ref_qr
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.ops import checks, qr
from dplasma_tpu_torch.utils import config as cfg
from test_torch_dd_qr import DD, ROUTES, TOL, _pair, _rel
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's gelqf and gels (4 right-hand sides), once."""
    out = {}
    with ref_cfg.override_scope(dict(DD, **ROUTES["chain"])):
        A, out["wide"] = _pair(96, 160, 32)
        out["gelqf"] = ref_qr.gelqf(A)
        A, out["tall"] = _pair(160, 96, 32)
        B, out["B"] = _pair(160, 4, 32, seed=3873)
        out["gels"] = ref_qr.gels(A, B)
    return out


def test_gelqf_and_gels_dd_match_reference(ref_runs):
    W, T, B = ref_runs["wide"], ref_runs["tall"], ref_runs["B"]
    with cfg.override_scope(dict(DD, **ROUTES["chain"])):
        Lf, Tf = qr.gelqf(W)
        X = qr.gels(T, B)
        r, ok = checks.check_gels(T, B, X.to_dense())
    want_f, want_t = ref_runs["gelqf"]
    assert _rel(want_f.data, Lf.data) <= TOL
    assert _rel(want_t.data, Tf.data) <= TOL
    assert _rel(ref_runs["gels"].data, X.data) <= TOL
    assert ok and r < 60
