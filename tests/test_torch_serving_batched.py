"""Port parity: the serving layer's batched ops
(``dplasma_tpu_torch.serving.batched``) against the reference's vmapped
ops (``dplasma_tpu.serving.batched`` under ``jax.jit``, as its own tests
run them), against a loop of the port's unbatched ops, and the batched
forms of K1 and K2 that the batch reaches through ``torch.func.vmap``.

Inputs are seeded numpy stacks (B = 3) at n = 20 with nb = 8 (ragged:
the last tile is padded), the same arrays handed to both packages.
Tolerances: f64 ops within 1e-12 of the reference (max|Δ|/max|X|; both
factor by the same blocked sweeps, in their own summation orders), f32
within 1e-4 (the working precision, κ ≈ 2 here); the pivot permutations
equal. Against a loop of the port's unbatched op the batched op is
bitwise: under vmap each element runs the same op sequence. The masked
IR loop (``refine.ir_solve(eager=False)``, the reference's traced mode):
``iterations`` and ``converged`` equal, the history's "no verdict" -1
padding in the same places and its measured entries within 10x (each
package's working factor rounds in its own order, so the residuals
differ by that rounding), at the f32 rung with ``tol=1e-12`` and at the
bf16 rung at the default tolerance. At the f32 rung's default tolerance
(100·u = 2.2e-14) the step that crosses it is decided by that rounding
for some elements (one element here measures 2.8e-14 in the reference
and 7.3e-15 in the port after one correction), so there the iterations
agree within one and the solutions within 1e-12. The reference's
batched entries are jitted once per module and share their compiles
across the cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from dplasma_tpu.serving import batched as ref_batched
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import lu as lu_mod
from dplasma_tpu_torch.ops import potrf as potrf_mod
from dplasma_tpu_torch.ops import refine
from dplasma_tpu_torch.serving import batched
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

B, N, NB, NRHS, ITERS = 3, 20, 8, 2, 4
TOL = {np.float64: 1e-12, np.float32: 1e-4}


def _spd(rng, n=N, dtype=np.float64):
    a = rng.standard_normal((B, n, n))
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)


def _gen(rng, n=N, dtype=np.float64):
    return (rng.standard_normal((B, n, n)) + n * np.eye(n)).astype(dtype)


def _rhs(rng, n=N, dtype=np.float64):
    return rng.standard_normal((B, n, NRHS)).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


#: (op, dtype) -> (A, b): the inputs every case of an op shares
_INPUTS = {}


def _inputs(op, dtype):
    key = (op, dtype)
    if key not in _INPUTS:
        rng = np.random.default_rng(
            {"posv": 1, "gesv": 2, "posv_ir": 3, "gesv_ir": 4}[op])
        gen = _spd if op.startswith("posv") else _gen
        _INPUTS[key] = (gen(rng, dtype=dtype), _rhs(rng, dtype=dtype))
    return _INPUTS[key]


_REF = {
    "posv": jax.jit(lambda a, b: ref_batched.posv_batched(a, b, NB)),
    "gesv": jax.jit(lambda a, b: ref_batched.gesv_batched(a, b, NB)),
    "getrf": jax.jit(lambda a: ref_batched.getrf_batched(a, NB)),
    "posv_ir": jax.jit(lambda a, b: ref_batched.posv_ir_batched(
        a, b, NB, max_iters=ITERS)),
    "gesv_ir": jax.jit(lambda a, b: ref_batched.gesv_ir_batched(
        a, b, NB, max_iters=ITERS)),
}
#: the masked-loop configurations held step for step: (precision, tol)
_IR_CONF = {"f32": ("f32", 1e-12), "bf16": ("bf16", None)}


@pytest.fixture(scope="module")
def ref_out():
    """The reference's batched outputs, computed once per module."""
    cache = {}

    def get(op, dtype=np.float64):
        if (op, dtype) not in cache:
            if op == "getrf":
                A, _ = _inputs("gesv", dtype)
                cache[op, dtype] = jax.device_get(_REF[op](jnp.asarray(A)))
            elif dtype in _IR_CONF:
                A, b = _inputs(op, np.float64)
                prec, tol = _IR_CONF[dtype]
                f = getattr(ref_batched, f"{op}_batched")
                cache[op, dtype] = jax.device_get(jax.jit(
                    lambda a, bb: f(a, bb, NB, precision=prec, tol=tol,
                                    max_iters=8))(jnp.asarray(A),
                                                  jnp.asarray(b)))
            else:
                A, b = _inputs(op, dtype)
                cache[op, dtype] = jax.device_get(
                    _REF[op](jnp.asarray(A), jnp.asarray(b)))
        return cache[op, dtype]
    return get


def _port(op, A, b):
    t = torch.from_numpy
    if op.endswith("_ir"):
        return batched.solve_batched(op, t(A), t(b), NB, max_iters=ITERS)
    return batched.solve_batched(op, t(A), t(b), NB)


@pytest.mark.parametrize("op,dtype", [("posv", np.float64),
                                      ("posv", np.float32),
                                      ("gesv", np.float64),
                                      ("gesv", np.float32)])
def test_batched_solve_matches_reference(ref_out, op, dtype):
    A, b = _inputs(op, dtype)
    X, info = _port(op, A, b)
    assert info is None and X.shape == (B, N, NRHS) and X.dtype == \
        torch.from_numpy(A).dtype
    assert _rel(X, ref_out(op, dtype)) <= TOL[dtype]


def test_batched_getrf_matches_reference(ref_out):
    A, _ = _inputs("gesv", np.float64)
    F, perm = batched.getrf_batched(torch.from_numpy(A), NB)
    rF, rperm = ref_out("getrf")
    assert F.shape == rF.shape == (B, 24, 24)       # the padded factor
    assert np.array_equal(perm.numpy(), np.asarray(rperm))
    assert _rel(F, rF) <= TOL[np.float64]
    # getrs from the padded factors solves the padded system exactly
    _, b = _inputs("gesv", np.float64)
    X = batched.getrs_batched(F, perm, torch.from_numpy(b), NB)
    assert _rel(X, np.linalg.solve(A, b)) <= 1e-12


@pytest.mark.parametrize("op", ["posv_ir", "gesv_ir"])
def test_batched_ir_matches_reference_at_default_tolerance(ref_out, op):
    A, b = _inputs(op, np.float64)
    X, info = _port(op, A, b)
    rX, rinfo = ref_out(op)
    assert _rel(X, rX) <= 1e-12
    for k in ("converged", "escalated"):
        assert np.array_equal(info[k].numpy(), np.asarray(rinfo[k])), k
    assert not info["escalated"].any() and info["converged"].all()
    assert np.abs(info["iterations"].numpy()
                  - np.asarray(rinfo["iterations"])).max() <= 1
    assert info["backward_errors"].shape == (B, ITERS + 1)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["posv_ir", "gesv_ir"])
def test_masked_loop_matches_reference_traced_mode(ref_out, op, prec):
    A, b = _inputs(op, np.float64)
    p, tol = _IR_CONF[prec]
    X, info = batched.solve_batched(op, torch.from_numpy(A),
                                    torch.from_numpy(b), NB, precision=p,
                                    tol=tol, max_iters=8)
    rX, rinfo = ref_out(op, prec)
    assert _rel(X, rX) <= 1e-12
    for k in ("iterations", "converged", "escalated"):
        assert np.array_equal(info[k].numpy(), np.asarray(rinfo[k])), k
    assert not info["escalated"].any() and info["converged"].all()
    h, rh = info["backward_errors"].numpy(), np.asarray(
        rinfo["backward_errors"])
    assert h.shape == rh.shape == (B, 9)
    assert np.array_equal(h < 0, rh < 0)
    ratio = h[h > 0] / rh[h > 0]
    assert np.all((ratio > 0.1) & (ratio < 10.0)), (h, rh)


def test_masked_loop_convergence_mask_is_per_element():
    """One hard element must not stop an easy batch-mate: the mask,
    the iteration count and the history are per element (the
    reference's ``test_ir_batched_per_element_convergence_mask``)."""
    rng = np.random.default_rng(10)
    A = _spd(rng, 8)[:2]
    w, v = np.linalg.eigh(A[1])
    w[0] = w[-1] * 1e-13
    A[1] = (v * w) @ v.T
    b = rng.standard_normal((2, 8, 1))
    _, info = batched.posv_ir_batched(torch.from_numpy(A),
                                      torch.from_numpy(b), NB, max_iters=2)
    _, rinfo = jax.jit(lambda a, bb: ref_batched.posv_ir_batched(
        a, bb, NB, max_iters=2))(jnp.asarray(A), jnp.asarray(b))
    conv = info["converged"].numpy()
    assert conv[0] and np.array_equal(conv, np.asarray(rinfo["converged"]))
    assert np.array_equal(info["iterations"].numpy(),
                          np.asarray(rinfo["iterations"]))


@pytest.mark.parametrize("op", ["posv", "gesv", "posv_ir", "gesv_ir"])
def test_batched_is_a_loop_of_the_unbatched_op(op):
    A, b = _inputs(op, np.float64)
    X, info = _port(op, A, b)
    for i in range(B):
        At = TileMatrix.from_dense(torch.from_numpy(A[i]), NB, NB)
        bt = TileMatrix.from_dense(torch.from_numpy(b[i]), NB, NB)
        if op == "posv":
            Xi = potrf_mod.posv(At, bt, "L")[1]
        elif op == "gesv":
            Xi = lu_mod.gesv_1d(At, bt)[2]
        else:
            fn = refine.posv_ir if op == "posv_ir" else refine.gesv_ir
            Xi, ii = fn(At, bt, max_iters=ITERS, escalate=False,
                        eager=False)
            for k in ("iterations", "converged", "backward_errors"):
                assert torch.equal(info[k][i], ii[k]), k
        assert torch.equal(X[i], Xi.to_dense()), f"element {i}"


def test_padding_contract_and_backward_errors():
    """A problem padded into a bucket by the identity solves exactly;
    ``backward_errors`` is padding-invariant (its max(|A|, 1) clamp)."""
    rng = np.random.default_rng(11)
    A, b = _spd(rng, 6)[:2], rng.standard_normal((2, 6, 2))
    Ap = np.zeros((2, 12, 12))
    Ap[:, np.arange(12), np.arange(12)] = 1.0
    Ap[:, :6, :6] = A
    bp = np.zeros((2, 12, 4))
    bp[:, :6, :2] = b
    t = torch.from_numpy
    X = batched.posv_batched(t(A), t(b), NB)
    Xp = batched.posv_batched(t(Ap), t(bp), NB)
    assert _rel(Xp[:, :6, :2], X) <= 1e-13
    assert torch.all(Xp[:, 6:] == 0) and torch.all(Xp[:, :, 2:] == 0)
    e = batched.backward_errors(t(A), t(b), X)
    ep = batched.backward_errors(t(Ap), t(bp), Xp)
    assert e.shape == (2,) and torch.allclose(e, ep, rtol=1e-6, atol=0)
    ref = jax.device_get(ref_batched.backward_errors(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(X.numpy())))
    assert np.allclose(e.numpy(), ref, rtol=1e-12, atol=0)


def test_solve_batched_refuses_unservable_ops():
    with pytest.raises(ValueError, match="unservable"):
        batched.solve_batched("potrf", torch.zeros(1, 8, 8),
                              torch.zeros(1, 8, 1), NB)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        batched.posv_batched(torch.zeros(8, 8), torch.zeros(8, 1), NB)
    assert batched.OPS == ref_batched.OPS


# ---------------------------------------------------------------------
# K1 and K2 through vmap: one call (one launch on the card) per site
# ---------------------------------------------------------------------

@pytest.fixture
def k1_on():
    was = pk.enabled()
    pk.enable(True)
    try:
        yield
    finally:
        pk.enable(was)


@pytest.mark.parametrize("op", ["posv", "gesv", "posv_ir", "gesv_ir"])
def test_k1_k2_routed_once_per_site(k1_on, op):
    """With K1 on, a batch of 2 at n = 768, nb = 256 (every update
    product eligible) calls K1 exactly as often as one element does
    alone, each call one batched launch on the card; each masked-loop
    residual is one K2 call."""
    n, nbk, iters = 768, 256, 2
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, n, n))
    A = a @ a.transpose(0, 2, 1) / n + np.eye(n) if op.startswith("posv") \
        else a / np.sqrt(n) + 2 * np.eye(n)
    b = rng.standard_normal((2, n, 3))
    dt = np.float64 if op.endswith("_ir") else np.float32
    A, b = torch.from_numpy(A.astype(dt)), torch.from_numpy(b.astype(dt))
    kw = {"max_iters": iters} if op.endswith("_ir") else {}
    calls = []
    orig = pk.gemm_batched

    def spy(*args, **kwargs):
        calls.append(args[0].shape[0])
        return orig(*args, **kwargs)

    pk.reset_counts()
    pdd.reset_counts()
    with cfg.override_scope({"ir.precision": "f32"}):
        pk.gemm_batched = spy
        try:
            X, _ = batched.solve_batched(op, A, b, nbk, **kw)
        finally:
            pk.gemm_batched = orig
        routed = (pk.ROUTED, pdd.ROUTED)
        pk.reset_counts()
        pdd.reset_counts()
        batched.solve_batched(op, A[:1], b[:1], nbk, **kw)
        one = (pk.ROUTED, pdd.ROUTED)
    import chip_smoke
    want = chip_smoke.serving_k1_want(op, n, nbk, iters)
    assert routed == one == (want, iters + 1 if op.endswith("_ir") else 0)
    assert calls == [2] * want          # one batched call a site
    assert X.shape == (2, n, 3)


def test_batched_gesv_refuses_k3():
    """K3 has no batched launch: under ``panel.kernel=pallas`` a batched
    LU raises the named refusal instead of taking another panel."""
    A, b = _inputs("gesv", np.float32)
    with cfg.override_scope({"panel.kernel": "pallas"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.*K3"):
            batched.gesv_batched(torch.from_numpy(A), torch.from_numpy(b),
                                 NB)
        # the unbatched LU keeps its K3 route (plain version on the CPU)
        lu_mod.gesv_1d(TileMatrix.from_dense(torch.from_numpy(A[0]), NB, NB),
                       TileMatrix.from_dense(torch.from_numpy(b[0]), NB, NB))


def test_k1_batched_plain_version_and_custom_op(k1_on):
    """``gemm_batched`` on the CPU is the plain batched version: each
    element bitwise ``gemm_reference``'s 2-D product, a broadcast
    (batch stride 0) operand included; the custom op outside vmap is a
    batch of one; under vmap an unbatched operand broadcasts."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 300, 270, generator=g)
    b = torch.randn(270, 260, generator=g)
    c = torch.randn(4, 300, 260, generator=g)
    out = pk.gemm_batched(a, b.expand(4, 270, 260), c, alpha=2.0, beta=-0.5)
    for i in range(4):
        assert torch.equal(out[i], pk.gemm_reference(a[i], b, c[i],
                                                     alpha=2.0, beta=-0.5))
    assert torch.equal(torch.ops.dtt.k1_gemm(a[0], b, c[0], 2.0, -0.5),
                       out[0])
    got = vmap(lambda x, z: pk.gemm(x, b, z, alpha=2.0, beta=-0.5))(a, c)
    assert torch.equal(got, out)
    with pytest.raises(ValueError, match="3-D"):
        pk.gemm_batched(a[0], b)


def test_k1_plan_batched_is_the_element_plan():
    """Every element of a batched launch runs its 2-D plan (so it is
    bitwise its 2-D launch); a batch stride TMA cannot take (not a
    multiple of 16 bytes) sends the launch to the FFMA kernel."""
    st_a, st_b = (1024 * 256, 256, 1), (256 * 512, 512, 1)
    p = pk.plan_batched(1024, 512, 256, torch.float32, st_a, st_b)
    assert p == pk.plan(1024, 512, 256, torch.float32, st_a[1:], st_b[1:])
    assert p.kernel == "wgmma"
    assert pk.plan_batched(1024, 512, 256, torch.float32, (0, 256, 1),
                           st_b).kernel == "wgmma"
    odd = pk.plan_batched(1024, 512, 256, torch.float32,
                          (1024 * 256 + 1, 256, 1), st_b)
    assert odd.kernel == "ffma" and odd.tiles == p.tiles


def test_k2_batched_plain_version_is_bitwise():
    """``limb_product_base_batched`` on the CPU: each element bitwise
    ``limb_product_base_reference``; through vmap one K2 call for the
    batch, an unbatched operand broadcast; the split of a batched
    operand (the custom bitcast) gives the 2-D limbs and scales."""
    g = torch.Generator().manual_seed(4)
    al = torch.randint(-127, 128, (3, 8, 40, 50), generator=g,
                       dtype=torch.int8)
    bl = torch.randint(-127, 128, (3, 8, 4, 50), generator=g,
                       dtype=torch.int8)
    base = torch.randn(3, 40, 4, generator=g, dtype=torch.float64)
    sa = torch.exp2(torch.randint(-5, 5, (3, 40, 1), generator=g).double())
    sb = torch.exp2(torch.randint(-5, 5, (1, 4), generator=g).double())
    out = pdd.limb_product_base_batched(al, bl, base, sa, sb[None], 7)
    for i in range(3):
        assert torch.equal(out[i], pdd.limb_product_base_reference(
            al[i], bl[i], base[i], sa[i], sb, 7))
    pdd.reset_counts()
    got = vmap(lambda x, y, z, s: pdd.limb_product_base(x, y, z, s, sb, 7))(
        al, bl, base, sa)
    assert torch.equal(got, out) and pdd.ROUTED == 1
    x = torch.randn(3, 30, 20, generator=g, dtype=torch.float64)
    w, nl, _ = dd._plan(20, 53)
    limbs, scale, m = vmap(lambda v: dd._split_rows(v, w, nl))(x)
    for i in range(3):
        l2, s2, m2 = dd._split_rows(x[i], w, nl)
        assert torch.equal(limbs[i], l2) and torch.equal(scale[i], s2)
    assert torch.equal(
        vmap(lambda v: dd.gemm_residual(v[:, :4], v, v[:20, 4:8]))(x)[1],
        dd.gemm_residual(x[1][:, :4], x[1], x[1][:20, 4:8]))


def test_masked_loop_escalates_where_it_did_not_converge():
    """``eager=False`` with escalation on (the reference's ``lax.cond``):
    an unconverged solve takes the full-precision route, flagged as the
    reference's traced mode flags it."""
    from dplasma_tpu.descriptors import TileMatrix as RefTile
    from dplasma_tpu.ops import refine as ref_refine
    rng = np.random.default_rng(10)
    A = _spd(rng, 8)[1]
    w, v = np.linalg.eigh(A)
    w[0] = w[-1] * 1e-13
    A = (v * w) @ v.T
    b = rng.standard_normal((8, 1))
    X, info = refine.posv_ir(TileMatrix.from_dense(torch.from_numpy(A), NB,
                                                   NB),
                             TileMatrix.from_dense(torch.from_numpy(b), NB,
                                                   NB),
                             max_iters=2, eager=False)
    _, rinfo = jax.jit(lambda a, bb: ref_refine.posv_ir(
        RefTile.from_dense(a, NB, NB), RefTile.from_dense(bb, NB, NB),
        max_iters=2))(jnp.asarray(A), jnp.asarray(b))
    for k in ("converged", "escalated", "iterations"):
        assert bool(np.array_equal(info[k].numpy(), np.asarray(rinfo[k]))), k
    assert bool(info["escalated"]) and not bool(info["converged"])
    x = X.to_dense().numpy()
    assert np.abs(A @ x - b).max() <= 1e-12 * np.abs(A).max() * np.abs(
        x).max()
