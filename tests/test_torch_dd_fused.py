"""The fused K2 route on the CPU: ``pallas_dd.limb_product_base`` (the
exact int8 limb product with the level recombine fused), its plan and
the dd route's counters, against the reference.

- The plain version ``limb_product_base_reference`` is bitwise equal to
  the reference's exact route, ``dplasma_tpu.kernels.dd``'s
  ``_recombine_scale_base(_limb_levels(...))`` off the TPU, on limbs the
  port splits (bitwise the reference's digits and scales), and on the
  limb-cache views of a blocked Cholesky.
- A plain emulation of the kernel's schedule (the plan's output tiles,
  K steps, level groups and split partials, summed in int64) is
  ``torch.equal`` to the plain version, and every partial it forms fits
  in int32 (the kernel's accumulators and workspace): integer sums are
  exact in any order, so the kernel's bits are the plain version's.
- ``plan`` gives every limb pair (i, j), i + j < nl, to exactly one
  warpgroup, stays within the block's shared memory, covers K with its
  splits and refuses what the int32 bound does not admit.
- The route's counters: a blocked Cholesky routes 5·nt − 3 products;
  ``dd_epilogue=off`` and a smaller chunk depth take the plain route,
  with the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.kernels import dd as ref_dd
from dplasma_tpu_torch.kernels import dd
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

W = 7


def _bits(x):
    x = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return x if x.dtype.kind in "iu" else x.view(f"i{x.dtype.itemsize}")


def assert_bitwise(want, got):
    want = np.asarray(want)
    assert want.shape == tuple(got.shape)
    np.testing.assert_array_equal(_bits(want), _bits(got.contiguous()))


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    # rows and columns over ~10 binades, so the scales differ
    a = rng.standard_normal((M, K)) * 2.0 ** rng.integers(-5, 6, (M, 1))
    b = rng.standard_normal((K, N)) * 2.0 ** rng.integers(-5, 6, (1, N))
    big = rng.standard_normal((2 * N + 3, 2 * M + 5))
    return a, b, big


@pytest.mark.parametrize("nl", [5, 8])
@pytest.mark.parametrize("form", ["dense", "strided", "none", "unscaled"])
@pytest.mark.parametrize("lhs_t", [False, True])
def test_plain_version_is_the_reference_exact_product(nl, form, lhs_t):
    """Ragged M, K, N; the port's K-major limb planes (B's split from its
    transpose) hold the reference's digits and scales, and the plain
    version (and the wrapper on the CPU) equal the reference's product
    bit for bit: base dense, a transposed view, None with −sa (the
    ``gemm_f64`` form), and the unscaled form."""
    M, K, N = 37, 45, 29
    a, b, big = _operands(M, K, N, seed=nl)
    bits = {5: 32, 8: 53}[nl]
    w, nl_, kc = ref_dd._plan(K, bits)
    assert (w, nl_) == (W, nl) and K <= kc
    ral, rsa, _ = ref_dd._split_int(jnp.asarray(a), w, nl, 0)
    rbl, rsb, _ = ref_dd._split_int(jnp.asarray(b), w, nl, 1)
    al, sa, _ = dd._split_rows(torch.from_numpy(a), w, nl)
    bl, sbt, _ = dd._split_rows(torch.from_numpy(b).T, w, nl)
    sb = sbt.T
    assert_bitwise(np.stack(ral), al)
    assert_bitwise(np.stack(rbl), bl.transpose(1, 2))
    assert_bitwise(rsa, sa)
    assert_bitwise(rsb, sb)
    assert al.stride(2) == 1 and al.stride(1) % 16 == 0
    if lhs_t:
        # the reference's (K, M) limbs; the port's K-major view of them
        ral = [x.T for x in ral]
        al = dd._k_major(al.transpose(1, 2))
        assert al.stride(2) == 1
    levels = ref_dd._limb_levels(ral, rbl, K, w, nl, kc, lhs_t=lhs_t)
    if form == "unscaled":
        want = ref_dd._level_recombine(levels, w)
        args = (None, None, None)
    else:
        if form == "dense":
            base = torch.from_numpy(big[:M, :N].copy())
        elif form == "strided":
            base = torch.from_numpy(big)[5:5 + N, 3:3 + M].T
        else:
            base = None
        s = -1.0 if base is None else 1.0
        want = ref_dd._recombine_scale_base(
            levels, None if base is None else jnp.asarray(base.numpy()),
            s * rsa, rsb, w)
        args = (base, s * sa, sb)
    assert_bitwise(want, pdd.limb_product_base_reference(al, bl, *args, w))
    routed = pdd.ROUTED
    assert_bitwise(want, pdd.limb_product_base(al, bl, *args, w))
    assert pdd.ROUTED == routed + 1


def _recorded_trailing_products(monkeypatch, N, nb):
    """The trailing products of one port ``potrf_f64_blocked`` on the
    CPU: the limb-cache views and scales it hands over."""
    seen = []
    orig = dd._pair_dot_base

    def spy(al, bl, base, sa, sb, K, w, nl, kc):
        seen.append((al, bl, base.clone(), sa, sb, K, w, nl, kc))
        return orig(al, bl, base, sa, sb, K, w, nl, kc)

    monkeypatch.setattr(dd, "_pair_dot_base", spy)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, N))
    A = torch.from_numpy(x @ x.T + N * np.eye(N))
    dd.potrf_f64_blocked(A, nb=nb)
    return seen


def test_plain_version_on_the_blocked_cache_views(monkeypatch):
    """N=256, nb=32: every trailing product's operands are K-major views
    of one limb cache that TMA reads with no copy, and the plain version
    on them equals the reference's exact product of the same limbs in
    its (K, M) form."""
    N, nb = 256, 32
    seen = _recorded_trailing_products(monkeypatch, N, nb)
    assert len(seen) == N // nb - 1
    for al, bl, base, sa, sb, K, w, nl, kc in seen[::3]:    # k = 1, 4, 7
        a3, b3 = dd._k_major(al), dd._k_major(bl)
        assert a3.data_ptr() == al.data_ptr() and a3.stride(2) == 1
        p = pdd.plan_for(a3, b3)
        assert not (p.a_copy or p.b_copy)
        levels = ref_dd._limb_levels(
            [jnp.asarray(x.numpy()) for x in al],
            [jnp.asarray(x.numpy()) for x in bl], K, w, nl, kc, lhs_t=True)
        want = ref_dd._recombine_scale_base(
            levels, jnp.asarray(base.numpy()), jnp.asarray(sa.numpy()),
            jnp.asarray(sb.numpy()), w)
        assert_bitwise(want, pdd.limb_product_base_reference(
            a3, b3, base, sa, sb, w))


def _emulate(p, al, bl, base, sa, sb, w):
    """The kernel's schedule in plain arithmetic: zero-filled 64-row
    tiles (every tile at once), split z summing K steps z·kt_per.., each
    warpgroup summing the pairs of its levels on every step (one product
    over the pairs' K rows side by side); partial level sums in int64,
    each asserted to fit in int32 (a split's accumulators, then the
    workspace after each split adds in); then the f64 epilogue of the
    plain version on the totals."""
    nl, M, K = al.shape
    N = bl.shape[1]
    Mp, Np = -(-M // p.bm) * p.bm, -(-N // p.bn) * p.bn
    ktiles = -(-K // p.bk)
    Kp = ktiles * p.bk
    A = torch.zeros((nl, Mp, Kp), dtype=torch.float64)
    B = torch.zeros((nl, Np, Kp), dtype=torch.float64)
    A[:, :M, :K] = al.double()
    B[:, :N, :K] = bl.double()
    lim = 2 ** 31 - 1
    ws = torch.zeros((nl, Mp, Np), dtype=torch.int64)
    done = set()
    for z in range(p.splits):
        acc = torch.zeros((nl, Mp, Np), dtype=torch.int64)
        for kt in range(z * p.kt_per, min(ktiles, (z + 1) * p.kt_per)):
            assert kt not in done
            done.add(kt)
            ks = slice(kt * p.bk, (kt + 1) * p.bk)
            for group in p.groups:
                for lvl in group:
                    # pairs (i, lvl - i) on one K step: exact in f64
                    acc[lvl] += (
                        A[:lvl + 1, :, ks].transpose(0, 1).reshape(Mp, -1)
                        @ B[:lvl + 1, :, ks].flip(0).transpose(0, 1)
                        .reshape(Np, -1).T
                    ).to(torch.int64)
        assert int(acc.abs().max()) <= lim
        ws += acc
        assert int(ws.abs().max()) <= lim
    assert done == set(range(ktiles))
    levels = ws[:, :M, :N].to(torch.int32)
    if sa is None:
        return dd._level_recombine(levels, w)
    return pdd.recombine_base_reference(levels, base, sa, sb, w)


def _dpotrf_products(n, nb):
    """(nl, M, N, K) of every limb product of one blocked dd Cholesky,
    in order (as chip_smoke.dd_k2_shapes counts them at full size)."""
    nt = n // nb
    out = []
    for k in range(nt):
        m = n - k * nb
        if k:
            out.append((8, m, nb, k * nb))
        out += [(5, nb, nb, nb), (8, nb, nb, nb)]
        if k < nt - 1:
            out += [(5, m - nb, nb, nb), (8, m - nb, nb, nb)]
    return out


_SPLIT_SHAPES = [(8, 256, 192, 640), (5, 130, 70, 1100), (8, 64, 64, 4096),
                 (3, 17, 9, 13)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("which", ["dpotrf", "split"])
def test_kernel_schedule_emulation_equals_plain_version(sms, which):
    """Every plan of the 77 limb products of a blocked dd Cholesky (N=512,
    nb=32: nt = 16, the main path's count at 1/16 the size) and of
    split shapes, on cards of 132 and 8 SMs (split and whole tiles)."""
    shapes = (_dpotrf_products(512, 32) if which == "dpotrf"
              else _SPLIT_SHAPES)
    if which == "dpotrf":
        assert len(shapes) == 77
    rng = np.random.default_rng(sms)
    splits = set()
    for idx, (nl, M, N, K) in enumerate(shapes):
        al = torch.from_numpy(rng.integers(-127, 128, (nl, M, K),
                                           dtype=np.int8))
        bl = torch.from_numpy(rng.integers(-127, 128, (nl, N, K),
                                           dtype=np.int8))
        base = torch.from_numpy(rng.standard_normal((M, N)))
        sa = torch.from_numpy(2.0 ** rng.integers(-3, 4, (M, 1)))
        sb = torch.from_numpy(2.0 ** rng.integers(-3, 4, (1, N)))
        p = pdd.plan(nl, M, N, K, sms=sms)
        splits.add(p.splits)
        args = (base, sa, sb) if idx % 3 else (None, None, None)
        got = _emulate(p, al, bl, *args, W)
        want = pdd.limb_product_base_reference(al, bl, *args, W)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert max(splits) > 1


@pytest.mark.parametrize("nl", range(1, 9))
def test_plan_covers_every_pair_once_within_shared_memory(nl):
    kc = dd._plan(2 ** 20, 7 * nl - 1)[2]
    assert dd._plan(2 ** 20, 7 * nl - 1)[1] == nl
    assert pdd.max_depth(nl) == kc
    for M, N, K in ((512, 512, 512), (7680, 512, 7680), (1, 1, 1),
                    (1000, 300, kc)):
        p = pdd.plan(nl, M, N, K)
        pairs = [(i, lvl - i) for g in p.groups for lvl in g
                 for i in range(lvl + 1)]
        assert sorted(pairs) == [(i, j) for i in range(nl)
                                 for j in range(nl) if i + j < nl]
        assert len(p.groups) <= 4 and p.threads == 128 * len(p.groups) + 32
        assert p.smem <= 232448 and p.stages >= 2
        # the stages hold every limb of a K step; the level tiles fit
        assert p.smem >= p.stages * 2 * nl * p.bm * p.bk
        assert p.smem >= nl * p.bm * (p.bn + 8) * 4
        ktiles = -(-K // p.bk)
        assert p.splits * p.kt_per >= ktiles > (p.splits - 1) * p.kt_per
        assert p.tiles == -(-M // 64) * -(-N // 64)
        if p.tiles >= 132:
            assert p.splits == 1
    with pytest.raises(ValueError, match="int32"):
        pdd.plan(nl, 64, 64, kc + 1)
    with pytest.raises(ValueError):
        pdd.plan(nl, 64, 64, 0)
    with pytest.raises(ValueError, match="limbs"):
        pdd.plan(9, 64, 64, 64)
    # what TMA reads as is, and what it needs copied
    assert not pdd.plan(nl, 64, 64, 100, (64 * 112, 112, 1),
                        (64 * 112, 112, 1)).a_copy
    odd = pdd.plan(nl, 64, 64, 100, (64 * 100, 100, 1), (64 * 112, 112, 1),
                   a_ptr=16, b_ptr=8)
    assert odd.a_copy and odd.b_copy        # odd row stride; odd address


def test_route_counters_and_the_plain_route(monkeypatch):
    """``potrf_f64_blocked`` (N=128, nb=16: nt = 8) routes 5·nt − 3 = 37
    limb products through K2's entry points on the CPU and launches
    none; ``dd_epilogue=off`` and a chunk depth poked below K take the
    plain route (no K2 call) with the same bits. ``UNFUSED`` counts only
    card products."""
    N, nb = 128, 16
    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, N))
    A = torch.from_numpy(x @ x.T + N * np.eye(N))
    pdd.reset_counts()
    L = dd.potrf_f64_blocked(A, nb=nb)
    assert (pdd.ROUTED, pdd.LAUNCHES, pdd.UNFUSED) == (5 * (N // nb) - 3,
                                                       0, 0)
    with cfg.override_scope({"dd_epilogue": "off"}):
        off = dd.potrf_f64_blocked(A, nb=nb)
    assert pdd.ROUTED == 37
    assert torch.equal(off.view(torch.int64), L.view(torch.int64))

    orig = dd._plan

    def shallow(K, bits):
        w, nl, kc = orig(K, bits)
        return w, nl, min(kc, 8)

    monkeypatch.setattr(dd, "_plan", shallow)
    chunked = dd.potrf_f64_blocked(A, nb=nb)
    assert pdd.ROUTED == 37 and pdd.UNFUSED == 0
    assert torch.equal(chunked.view(torch.int64), L.view(torch.int64))
    # one product both ways: the route's plain chunked levels against
    # the fused entry point's plain version
    a, b, _ = _operands(40, 70, 24, seed=3)
    al, sa, _ = dd._split_rows(torch.from_numpy(a), W, 8)
    bl, sbt, _ = dd._split_rows(torch.from_numpy(b).T, W, 8)
    base = torch.from_numpy(x[:40, :24].copy())
    got = dd._limb_product_base(al, bl, base, sa, sbt.T, 70, W, 8, 8)
    want = pdd.limb_product_base_reference(al, bl, base, sa, sbt.T, W)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert pdd.ROUTED == 37
