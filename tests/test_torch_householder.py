"""Port parity: ``dplasma_tpu_torch.kernels.householder`` against
``dplasma_tpu.kernels.householder``, on the same numpy inputs.

Tolerances: relative Frobenius error <= 1e-5 for f32 and <= 1e-12 for
f64. Both packages call LAPACK's geqrf on the CPU, so the packed panels
and taus agree to rounding (same sign convention); the compact-WY
products and solves differ in summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import householder as ref_hh
from dplasma_tpu.utils import config as ref_cfg
from dplasma_tpu_torch.kernels import householder as hh
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got,
                     np.float64)
    return np.linalg.norm(want - got) / max(np.linalg.norm(want), 1e-300)


def _t(x):
    return torch.from_numpy(np.array(x))


def _panel(rng, m, n, dt):
    return rng.standard_normal((m, n)).astype(dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m,n", [(64, 16), (37, 13), (24, 24)])
def test_geqrf_packed_matches_reference(rng, dt, m, n):
    a = _panel(rng, m, n, dt)
    wp, wt = ref_hh.geqrf_packed(jnp.asarray(a))
    gp, gt = hh.geqrf_packed(_t(a))
    assert gp.shape == (m, n) and gt.shape == (n,)
    assert _rel(wp, gp) <= TOL[dt]
    assert _rel(wt, gt) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_split_qr_larft_and_geqrt_match_reference(rng, dt):
    a = _panel(rng, 50, 16, dt)
    wp, wv, wT = jax.jit(ref_hh.geqrt)(jnp.asarray(a))
    gp, gv, gT = hh.geqrt(_t(a))
    for w, g in ((wp, gp), (wv, gv), (wT, gT)):
        assert _rel(w, g) <= TOL[dt]
    packed, taus = hh.geqrf_packed(_t(a))
    v, r = hh.split_qr(packed)
    rv, rr = ref_hh.split_qr(jnp.asarray(packed.numpy()))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(r.numpy(), np.asarray(rr))
    assert _rel(ref_hh.larft(rv, jnp.asarray(taus.numpy())),
                hh.larft(v, taus)) <= TOL[dt]
    # the compact-WY form reproduces the panel: Q [R; 0] = A
    full = hh.apply_q(gv, gT, torch.cat([r, r.new_zeros((34, 16))]),
                      trans="N")
    assert _rel(a, full) <= 10 * TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_cholqr2_and_cholqr_geqrt_match_reference(rng, dt):
    a = _panel(rng, 64, 16, dt)
    wq, wr = jax.jit(ref_hh.cholqr2)(jnp.asarray(a))
    gq, gr = hh.cholqr2(_t(a))
    assert _rel(wq, gq) <= TOL[dt] and _rel(wr, gr) <= TOL[dt]
    with ref_cfg.override_scope({"qr_panel": "cholqr"}):
        want = jax.jit(lambda x: ref_hh.geqrt(x, rankfull=True))(
            jnp.asarray(a))
    with cfg.override_scope({"qr_panel": "cholqr"}):
        assert hh._cholqr_active()
        got = hh.geqrt(_t(a), rankfull=True)
        # without rankfull the vendor panel is taken whatever the MCA
        vendor = hh.geqrt(_t(a))
    for w, g in zip(want, got):
        assert _rel(w, g) <= 10 * TOL[dt]
    assert torch.equal(vendor[0], hh.geqrf_packed(_t(a))[0])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m", [48, 16])
def test_householder_reconstruct_matches_reference(rng, dt, m):
    q, r = np.linalg.qr(_panel(rng, m, 16, np.float64))
    q, r = q.astype(dt), r.astype(dt)
    want = jax.jit(lambda a, b: ref_hh.householder_reconstruct(
        a, b, return_u=True))(jnp.asarray(q), jnp.asarray(r))
    got = hh.householder_reconstruct(_t(q), _t(r), return_u=True)
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL[dt]
    ws, wb = ref_hh.reconstruct_sign_shift(jnp.asarray(q))
    gs, gb = hh.reconstruct_sign_shift(_t(q))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    # an explicit sign vector takes the same branch as the derived one
    got_s = hh.householder_reconstruct(_t(q), _t(r), s=gs)
    for w, g in zip(got[:3], got_s):
        assert torch.equal(w, g)


def test_right_unit_upper_solve_alone(rng):
    """X U = rhs with U unit upper: the diagonal and the lower triangle
    of the matrix handed over are never read (the reference's
    ``triangular_solve(v1, rhs, left_side=False, transpose_a=True,
    conjugate_a=True, unit_diagonal=True)`` against V1^H)."""
    n = 12
    v1 = np.tril(rng.standard_normal((n, n)), -1) + np.eye(n)
    rhs = rng.standard_normal((7, n))
    want = jax.lax.linalg.triangular_solve(
        jnp.asarray(v1), jnp.asarray(rhs), left_side=False, lower=True,
        transpose_a=True, conjugate_a=True, unit_diagonal=True)
    garbage = _t(v1).mH.clone()
    garbage.diagonal().fill_(5.0)
    garbage += torch.tril(torch.full((n, n), 3.0, dtype=garbage.dtype), -1)
    got = hh._solve_right_unit_upper(garbage, _t(rhs))
    assert _rel(want, got) <= 1e-12
    assert torch.allclose(got @ _t(v1).mH, _t(rhs), atol=1e-10)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("trans", ["C", "N"])
def test_apply_q_both_sides_match_reference(rng, dt, trans):
    a = _panel(rng, 40, 8, dt)
    _, v, T = hh.geqrt(_t(a))
    c = _panel(rng, 40, 6, dt)
    cr = _panel(rng, 5, 40, dt)
    jv, jT = jnp.asarray(v.numpy()), jnp.asarray(T.numpy())
    assert _rel(ref_hh.apply_q(jv, jT, jnp.asarray(c), trans=trans),
                hh.apply_q(v, T, _t(c), trans=trans)) <= TOL[dt]
    assert _rel(ref_hh.apply_q_right(jv, jT, jnp.asarray(cr), trans=trans),
                hh.apply_q_right(v, T, _t(cr), trans=trans)) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_wy_merge_and_stack_match_reference(rng, dt):
    a = _panel(rng, 48, 24, dt)
    parts = []
    rest = _t(a)
    for j in range(3):                   # three 8-wide sweep panels
        _, v, T = hh.geqrt(rest[:, :8])
        parts.append((v, T))
        rest = hh.apply_q(v, T, rest[:, 8:], trans="C")[8:]
    jparts = [(jnp.asarray(v.numpy()), jnp.asarray(T.numpy()))
              for v, T in parts]
    wv, wT = ref_hh.wy_stack(jparts)
    gv, gT = hh.wy_stack(parts)
    assert gv.shape == (48, 24) and gT.shape == (24, 24)
    assert _rel(wv, gv) <= TOL[dt] and _rel(wT, gT) <= TOL[dt]
    # the aggregated reflector is the product of the three
    c = _panel(rng, 48, 5, dt)
    seq = _t(c)
    for i, (v, T) in enumerate(parts):
        seq = torch.cat([seq[:8 * i], hh.apply_q(v, T, seq[8 * i:])])
    assert _rel(seq.numpy(), hh.apply_q(gv, gT, _t(c))) <= 10 * TOL[dt]
    v1, t1 = parts[0]
    v2 = torch.cat([parts[1][0].new_zeros((8, 8)), parts[1][0]])
    wm = ref_hh.wy_merge(*jparts[0], jnp.asarray(v2.numpy()), jparts[1][1])
    gm = hh.wy_merge(v1, t1, v2, parts[1][1])
    assert _rel(wm[0], gm[0]) <= TOL[dt] and _rel(wm[1], gm[1]) <= TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_stacked_qr_and_apply_match_reference(rng, dt):
    top = np.triu(_panel(rng, 8, 8, dt))
    bot = _panel(rng, 16, 8, dt)
    want = ref_hh.stacked_qr(jnp.asarray(top), jnp.asarray(bot))
    got = hh.stacked_qr(_t(top), _t(bot))
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL[dt]
    ct, cb = _panel(rng, 8, 5, dt), _panel(rng, 16, 5, dt)
    jv, jT = jnp.asarray(got[1].numpy()), jnp.asarray(got[2].numpy())
    for trans in ("C", "N"):
        w2 = ref_hh.stacked_apply(jv, jT, jnp.asarray(ct), jnp.asarray(cb),
                                  trans=trans)
        g2 = hh.stacked_apply(got[1], got[2], _t(ct), _t(cb), trans=trans)
        assert _rel(w2[0], g2[0]) <= TOL[dt] and _rel(w2[1], g2[1]) <= TOL[dt]


def test_unimodular_sign_matches_reference():
    d = np.array([2.0, -3.0, 0.0, -0.0, 1e-30, -1e-30])
    np.testing.assert_array_equal(
        hh._unimodular_sign(_t(d)).numpy(),
        np.asarray(ref_hh._unimodular_sign(jnp.asarray(d))))
    z = np.array([3 + 4j, 0j, -2j])
    np.testing.assert_allclose(
        hh._unimodular_sign(_t(z)).numpy(),
        np.asarray(ref_hh._unimodular_sign(jnp.asarray(z))), rtol=1e-15)


@pytest.mark.parametrize("value", ["auto", "cholqr", "lapack", "CHOLQR"])
def test_cholqr_active_matches_reference(value):
    with cfg.override_scope({"qr_panel": value}), \
            ref_cfg.override_scope({"qr_panel": value}):
        assert hh._cholqr_active() == ref_hh._cholqr_active()
