"""Port parity: the rest of the pivoted-LU family of ``ops.lu`` —
``getrf_incpiv`` (tile-incremental pivoting), its ``trsmpl``/``getrs``/
``gesv`` solvers, the LU/QR hybrid ``getrf_qrf`` under each criterion
with ``trsmpl_qrf``/``getrs_qrf``, and ``gerfs`` — against the JAX
package in s, d, c and z, on the same padded inputs (N=45, nb=16: an
edge tile and a padded diagonal).

Both packages reach LAPACK's pivoted LU for the couples on the CPU, so
the couple permutations ``piv`` are equal, and ``getrf_qrf``'s per-panel
choice ``lu_tab`` must be equal. Factors are held to max|Δ|/max|factor|
<= 1e-5 (s, c) and 1e-12 (d, z); solutions to the larger of that and
4·κ₂(A)·u, the agreement of two backward-stable solves (u the unit
roundoff).

The hybrid's input takes an N added to the diagonal of its first two
block columns and none on the last: there the Higham and MUMPS criteria
(with the alphas below) accept the LU panels and refuse the last, so
each criterion runs both branches, every LU panel on a dominant
diagonal (unpivoted LU amplifies rounding on a random panel, in the
reference as here); ``alternating`` and ``random`` choose [1, 0, 1].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dplasma_tpu.descriptors import TileMatrix as RTile
from dplasma_tpu.ops import generators as ref_gen
from dplasma_tpu.ops import lu as ref_lu
from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import pallas_dd as pdd
from dplasma_tpu_torch.kernels import pallas_kernels as pk
from dplasma_tpu_torch.ops import checks, generators, lu
from dplasma_tpu_torch.utils import config as cfg
from torch_threads import one_torch_thread  # noqa: F401

N, NB = 45, 16
PRECS = ["s", "d", "c", "z"]
JDT = {"s": jnp.float32, "d": jnp.float64, "c": jnp.complex64,
       "z": jnp.complex128}
TOL = {"s": 1e-5, "d": 1e-12, "c": 1e-5, "z": 1e-12}
EPS = {"s": np.finfo(np.float32).eps, "d": np.finfo(np.float64).eps}
EPS.update(c=EPS["s"], z=EPS["d"])


def _port(A):
    return TileMatrix.from_reference(np.asarray(A.data),
                                     dataclasses.asdict(A.desc),
                                     device="cpu")


def _close(want, got, prec):
    want = np.asarray(getattr(want, "data", want))
    got = getattr(got, "data", got).resolve_conj().numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    err = np.abs(want - got).max() / max(np.abs(want).max(), 1e-300)
    assert err <= TOL[prec], err


def _close_solve(want, got, prec, A):
    kappa = np.linalg.cond(np.asarray(A.to_dense(), np.complex128))
    want = np.asarray(want.data)
    got = got.data.resolve_conj().numpy()
    err = np.abs(want - got).max() / np.abs(want).max()
    assert err <= max(TOL[prec], 2 * kappa * EPS[prec]), (err, kappa)


@pytest.fixture(scope="module", params=PRECS)
def system(request):
    prec = request.param
    A = ref_gen.plrnt(N, N, NB, NB, seed=3872, dtype=JDT[prec])
    B = ref_gen.plrnt(N, 3, NB, NB, seed=3873, dtype=JDT[prec])
    return prec, A, _port(A), B, _port(B)


# ---------------------------------------------------------------------
# incremental pivoting
# ---------------------------------------------------------------------

def test_getrf_incpiv_matches_reference(system):
    prec, A, TA, _, _ = system
    LU, Lc, piv = ref_lu.getrf_incpiv(A)
    TLU, TLc, tpiv = lu.getrf_incpiv(TA)
    assert tpiv.shape == tuple(np.asarray(piv).shape)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(piv))
    _close(LU, TLU, prec)
    _close(Lc, TLc, prec)
    assert TLU.desc == TA.desc and TLc.desc == TA.desc


def test_incpiv_solvers_match_reference(system):
    prec, A, TA, B, TB = system
    LU, Lc, piv = ref_lu.getrf_incpiv(A)
    TLU, TLc, tpiv = lu.getrf_incpiv(TA)
    _close_solve(ref_lu.trsmpl_incpiv(LU, Lc, piv, B),
                 lu.trsmpl_incpiv(TLU, TLc, tpiv, TB), prec, A)
    _close_solve(ref_lu.getrs_incpiv(LU, Lc, piv, B),
                 lu.getrs_incpiv(TLU, TLc, tpiv, TB), prec, A)
    want = ref_lu.gesv_incpiv(A, B)
    got = lu.gesv_incpiv(TA, TB)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close_solve(want[3], got[3], prec, A)
    r, ok = checks.check_axmb(TA, TB, got[3])
    assert ok, r


def test_ssssm_matches_reference(system):
    """One couple apply (CORE_zssssm) on the reference's own couple."""
    prec, A, _, _, _ = system
    x = np.asarray(A.data)
    stack = np.concatenate([np.triu(x[:NB, :NB]), x[NB:2 * NB, :NB]])
    lu2, _, perm = jax.lax.linalg.lu(jnp.asarray(stack))
    l11 = jnp.tril(lu2[:NB], -1)
    l21 = lu2[NB:]
    want = ref_lu._ssssm(l11, l21, perm, jnp.asarray(x[:NB, NB:]),
                         jnp.asarray(x[NB:2 * NB, NB:]))
    t = torch.from_numpy
    got = lu._ssssm(t(np.array(l11)), t(np.array(l21)),
                    t(np.array(perm)).long(), t(x[:NB, NB:].copy()),
                    t(x[NB:2 * NB, NB:].copy()))
    for w, g in zip(want, got):
        _close(w, g, prec)


# ---------------------------------------------------------------------
# the LU/QR hybrid
# ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=PRECS)
def hybrid(request):
    prec = request.param
    A = ref_gen.plrnt(N, N, NB, NB, seed=3872, dtype=JDT[prec])
    a = np.array(A.data)
    idx = np.arange(2 * NB)
    a[idx, idx] += N
    A = RTile(jnp.asarray(a), A.desc)
    B = ref_gen.plrnt(N, 3, NB, NB, seed=3873, dtype=JDT[prec])
    return prec, A, _port(A), B, _port(B)


@pytest.mark.parametrize("criterion,alpha,tab", [
    ("higham_sum", 2.0, [1, 1, 0]), ("higham_max", 1.0, [1, 1, 0]),
    ("higham_moy", 2.0, [1, 1, 0]), ("mumps", None, [1, 1, 0]),
    ("random", None, [1, 0, 1]), ("alternating", None, [1, 0, 1])])
def test_getrf_qrf_matches_reference(hybrid, criterion, alpha, tab):
    prec, A, TA, B, TB = hybrid
    LU, Tm, lu_tab = ref_lu.getrf_qrf(A, criterion=criterion, alpha=alpha)
    TLU, TTm, tlu_tab = lu.getrf_qrf(TA, criterion=criterion, alpha=alpha)
    assert tlu_tab.tolist() == np.asarray(lu_tab).tolist() == tab
    _close(LU, TLU, prec)
    _close(Tm, TTm, prec)
    _close_solve(ref_lu.trsmpl_qrf(LU, Tm, lu_tab, B),
                 lu.trsmpl_qrf(TLU, TTm, tlu_tab, TB), prec, A)
    X = lu.getrs_qrf(TLU, TTm, tlu_tab, TB)
    _close_solve(ref_lu.getrs_qrf(LU, Tm, lu_tab, B), X, prec, A)
    r, ok = checks.check_axmb(TA, TB, X)
    assert ok, r


@pytest.mark.parametrize("prec", PRECS)
def test_getrf_qrf_default_alpha_on_a_random_matrix(prec):
    """The default alphas (Mp for Higham, 0.5 for MUMPS) on a plain
    random matrix: the same choices as the reference."""
    A = ref_gen.plrnt(N, N, NB, NB, seed=3872, dtype=JDT[prec])
    TA = _port(A)
    for criterion in ("higham_sum", "mumps"):
        want = ref_lu.getrf_qrf(A, criterion=criterion)[2]
        got = lu.getrf_qrf(TA, criterion=criterion)[2]
        assert got.tolist() == np.asarray(want).tolist()


def test_panel_criterion_and_bad_arguments():
    panel = torch.tensor([[4.0, 1.0], [1.0, 3.0], [0.5, 0.5]])
    assert lu._panel_criterion("higham_sum", panel, 2, 2.0)
    assert not lu._panel_criterion("higham_sum", panel, 2, 1.0)
    assert lu._panel_criterion("mumps", panel, 2, 0.5)
    with pytest.raises(ValueError):
        lu._panel_criterion("nope", panel, 2, 1.0)
    A = generators.plrnt(32, 32, 16, 16, device="cpu")
    with pytest.raises(ValueError, match="criterion"):
        lu.getrf_qrf(A, criterion="nope")
    with pytest.raises(ValueError, match="square tiles"):
        lu.getrf_incpiv(generators.plrnt(32, 32, 16, 8, device="cpu"))
    assert lu.CRITERIA == ref_lu.CRITERIA


# ---------------------------------------------------------------------
# gerfs
# ---------------------------------------------------------------------

def test_gerfs_matches_reference(system):
    prec, A, TA, B, TB = system
    F, perm = ref_lu.getrf_1d(A)
    X = ref_lu.getrs("N", F, perm, B)
    TF, tperm = lu.getrf_1d(TA)
    TX = lu.getrs("N", TF, tperm, TB)
    for iters in (1, 2):
        _close_solve(ref_lu.gerfs(A, F, perm, B, X, iters=iters),
                     lu.gerfs(TA, TF, tperm, TB, TX, iters=iters), prec, A)


# ---------------------------------------------------------------------
# kernel routes (CPU tensors: K1's plain version, K2's route counter)
# ---------------------------------------------------------------------

def _k1_products(fn):
    pk.enable(True)
    try:
        pk.reset_counts()
        out = fn()
        return out, pk.ROUTED
    finally:
        pk.enable(False)


def test_incpiv_and_qrf_route_k1_products():
    """At nb = 256 (K1's gate) every couple product and trailing product
    is a K1 product: getrf_incpiv KT·(KT − 1)/2 (one per ``_ssssm`` with
    a trailing block); getrs_incpiv one per couple apply, KT·(KT − 1)/2,
    and the upper solve's KT − 1 (``blas3.trsm``); getrf_qrf one per LU
    panel with a trailing block, and per QR panel its ``larft`` Gram and
    three per ``apply_q`` on a trailing block."""
    n, nb = 768, 256
    kt = n // nb
    A = generators.plrnt(n, n, nb, nb, seed=3872, device="cpu")
    B = generators.plrnt(n, nb, nb, nb, seed=3873, device="cpu")
    (LU, Lc, piv), k1 = _k1_products(lambda: lu.getrf_incpiv(A))
    assert k1 == kt * (kt - 1) // 2
    _, k1 = _k1_products(lambda: lu.getrs_incpiv(LU, Lc, piv, B))
    assert k1 == kt * (kt - 1) // 2 + kt - 1
    (_, _, tab), k1 = _k1_products(
        lambda: lu.getrf_qrf(A, criterion="alternating"))
    assert tab.tolist() == [1, 0, 1]
    assert k1 == 1 + (1 + 3)


def test_dgetrf_incpiv_dd_routes_k2():
    """Under dd_gemm=always every couple product and trsm of a d
    factorization is on the limb route, and the factor agrees with the
    native one to f64 accuracy."""
    A = generators.plrnt(N, N, NB, NB, seed=3872, dtype=torch.float64,
                         device="cpu")
    native = lu.getrf_incpiv(A)
    with cfg.override_scope({"dd_gemm": "always"}):
        routed = pdd.ROUTED
        got = lu.getrf_incpiv(A)
        routed = pdd.ROUTED - routed
    kt = A.desc.KT
    # a real trsm_f64 is 2 limb residuals: one per diagonal tile with a
    # trailing block; per couple with one, a trsm and one product
    assert routed == 2 * (kt - 1) + 3 * kt * (kt - 1) // 2
    assert torch.equal(got[2], native[2])
    assert (got[0].data - native[0].data).abs().max() <= \
        1e-12 * native[0].data.abs().max()
