"""Hierarchical QR (HQR): reduction-tree-parameterized tile QR/LQ.

Ports ``dplasma_tpu/ops/hqr.py`` (:31-662): ``dplasma_zgeqrf_param``
and friends, parameterized by a ``dplasma_qrtree_t`` vtable
(getnbgeqrf/getm/geti/gettype/currpiv/nextpiv/prevpiv — ref
src/include/dplasma/qr_param.h:36-118): low-level trees
FLAT/GREEDY/FIBONACCI/BINARY/GREEDY1P within each of ``p`` distribution
domains, TS-domain size ``a``, a high-level FLAT/GREEDY tree across
domains, plus domino coupling and TS round-robin; systolic
(dplasma_systolic_init) and svd-ratio (dplasma_svd_init) variants.

A tree is pure index algebra, evaluated on the host (the reference's
own copy, line for line: the schedules and vtable answers are equal).
It materializes an *elimination schedule*: per panel k, rounds of
disjoint (pivot, victim, kind) triples. The factorization replays the
schedule with the stacked-couple tile kernels
(``kernels.householder.stacked_qr`` / ``stacked_apply``); each
elimination updates the whole trailing row slab of both rows at once.

Storage (the reference's TS/TT split): the factored matrix holds R in
the panel triangle, GEQRT V's below leaders' diagonals, TS victims'
dense V2 in their tile, TT victims' triangular V2 in their upper
triangle; T factors live in two A-shaped tile matrices (Tts for
GEQRT/TS kills, Ttt for TT kills) — the analogs of the reference's TS
and TT descriptors (tests/testing_zgeqrf_hqr.c).

Where the reference rebuilds the whole array per tile (``.at[].set``),
the port clones A once and writes each tile in place into that one
working buffer. The couples' QR stays cuSOLVER's ``geqrf``
(``householder.geqrf_packed``): a TT stack's triangular bottom has
zeros below its diagonal, where LAPACK's reflectors take tau = 0 as the
reference's vendor QR does. The reference's 2-D sharding constraint
after each panel (``pmesh.constrain2d``) has no counterpart on one
card.

Every product goes through ``kernels.blas.dot`` (``householder.larft``
and ``apply_q``): K1 for f32 when it is enabled and all three
dimensions are at least 256, K2 under MCA ``dd_gemm=always`` for f64
and complex128 (a complex product being two limb products). Per
``geqrf_param`` call with square nb-tiles, from the code: one ``larft``
Gram per GEQRT leader and per couple in every panel, and three products
per ``apply_q`` / ``stacked_apply`` in every panel with a trailing
slab: Σₖ (Lₖ + Cₖ)·(1 + 3·[k < NT − 1]), Lₖ = ``leaders(k)``, Cₖ the
panel's eliminations (MT − 1 − k on a square matrix). With the default
driver tree (greedy, a = 1: every row leads, Lₖ = MT − k) at MT = NT =
16 that is 256 + 3·255 = 1021. ``unmqr_param`` makes 3 per operation:
3·Σₖ (Lₖ + Cₖ), 768 at MT = 16.
"""
from __future__ import annotations

import dataclasses

from typing import Literal

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import householder as hh

LowTree = Literal["flat", "greedy", "fibonacci", "binary", "greedy1p"]
HighTree = Literal["flat", "greedy"]

TS = 0   # victim eliminated by a TS kernel (dense square tile)
TT = 1   # victim eliminated by a TT kernel (triangularized tile)


@dataclasses.dataclass(frozen=True)
class Elim:
    """One elimination: ``piv`` absorbs ``victim`` (kind TS or TT)."""
    piv: int
    victim: int
    kind: int
    round: int


def _fib_counts():
    """Fibonacci round sizes 1, 1, 2, 3, 5, … (callers cap by the
    live-set size)."""
    a, b = 1, 1
    while True:
        yield a
        a, b = b, a + b


def _reduce_rounds(rows: list[int], kind: str, base_round: int,
                   elim_kind: int) -> tuple[list[Elim], int]:
    """Reduce ``rows`` (ascending) to its head with the named tree.

    Returns (eliminations, next free round index). Every tree keeps the
    smallest row as the survivor, pairing pivots strictly above their
    victims — the invariant the pivgen checker enforces.
    """
    elims: list[Elim] = []
    live = list(rows)
    r = base_round
    if len(live) <= 1:
        return elims, r
    if kind == "flat":
        head = live[0]
        for v in live[1:]:
            elims.append(Elim(head, v, elim_kind, r))
            r += 1
        return elims, r
    if kind == "binary":
        # standard distance-doubling reduction on the ascending list
        alive = list(live)
        while len(alive) > 1:
            nxt = []
            for i in range(0, len(alive), 2):
                if i + 1 < len(alive):
                    elims.append(Elim(alive[i], alive[i + 1], elim_kind, r))
                nxt.append(alive[i])
            alive = nxt
            r += 1
        return elims, r
    if kind in ("greedy", "greedy1p"):
        # per-column independent greedy fold (victim j killed by
        # j-height): the reference's GREEDY1P (dplasma_hqr.c:789-836)
        # and its high-level greedy (hqr_high_greedy_init). The LOW
        # "greedy" tree is arrival-coupled across columns and is
        # generated by QRTree._greedy_pairs instead, not here.
        alive = list(live)
        while len(alive) > 1:
            c = len(alive) // 2
            keep = len(alive) - c
            for i in range(c):
                elims.append(Elim(alive[keep - c + i], alive[keep + i],
                                  elim_kind, r))
            alive = alive[:keep]
            r += 1
        return elims, r
    if kind == "fibonacci":
        alive = list(live)
        fib = _fib_counts()
        while len(alive) > 1:
            c = min(next(fib), len(alive) // 2 or 1, len(alive) - 1)
            keep = len(alive) - c
            for i in range(c):
                elims.append(Elim(alive[keep - c + i], alive[keep + i],
                                  elim_kind, r))
            alive = alive[:keep]
            r += 1
        return elims, r
    raise ValueError(f"unknown tree kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class QRTree:
    """The qrtree vtable (dplasma_qrtree_t analog) for an MT-row matrix.

    Construction parameters mirror dplasma_hqr_init
    (src/include/dplasma/qr_param.h:129-133): low-level tree ``llvl``
    within each of ``p`` block-cyclic domains, TS-domain size ``a``
    (groups aligned to global super-rows (m//p)//a, the reference's
    fixed ipiv indexing — dplasma_hqr.c:757-760), high-level tree
    ``hlvl`` across domain heads.

    ``domino`` couples the levels (dplasma_hqr.c:1755-1762): each
    domain's low tree runs only on super-rows >= k//a; the rows a
    domain owns above that boundary form a diagonal band that is
    TT-chained directly into the domain head.

    ``tsrr`` round-robins which member of each full aligned TS group
    leads, rotating by panel (the hqr_genperm permutation,
    dplasma_hqr.c:1591-1628).
    """

    MT: int
    a: int = 1
    p: int = 1
    llvl: LowTree = "flat"
    hlvl: HighTree = "flat"
    domino: bool = False
    tsrr: bool = False

    def __post_init__(self):
        assert self.MT >= 1 and self.a >= 1 and self.p >= 1
        # per-instance memo (a module-level lru_cache would pin every
        # tree ever built for process lifetime)
        object.__setattr__(self, "_sched_cache", {})
        object.__setattr__(self, "_leader_cache", {})
        object.__setattr__(self, "_greedy_cache", {})

    # -- domain structure ---------------------------------------------
    def _domain_rows(self, k: int, res: int) -> list[int]:
        return [m for m in range(k, self.MT) if m % self.p == res]

    def _split_band(self, k: int, dom: list[int]):
        """(band, deep): with domino, rows whose super-row < k//a are
        high-level band rows; without domino everything is deep."""
        if not self.domino:
            return [], dom
        boundary = (k // self.a)
        band = [m for m in dom if (m // self.p) // self.a < boundary]
        return band, dom[len(band):]

    def _groups(self, deep: list[int]) -> list[list[int]]:
        """Aligned TS groups: rows sharing super-row (m//p)//a."""
        out: list[list[int]] = []
        for m in deep:
            g = (m // self.p) // self.a
            if out and (out[-1][0] // self.p) // self.a == g:
                out[-1].append(m)
            else:
                out.append([m])
        return out

    def _group_leader(self, k: int, group: list[int]) -> int:
        """tsrr rotates the leader of FULL aligned groups strictly
        below the diagonal block row; partial/diagonal groups keep
        their top row (the fixed i<end2 region of hqr_genperm)."""
        if (self.tsrr and len(group) == self.a and group[0] > k
                and self.a > 1):
            return group[(k % self.a) % len(group)]
        return group[0]

    # -- coupled greedy (the reference's GREEDY low tree) -------------
    def _greedy_pairs(self, res: int) -> dict[int, list[tuple]]:
        """Arrival-coupled greedy pairing per panel for one domain
        (dplasma_hqr.c:660-750): column k+1's tree grows as column k
        kills (nT[k+1] += height). Returns {k: [(victim_top_idx,
        height, wave), ...]} in the domain's fixed super-row index
        space."""
        hit = self._greedy_cache.get(res)
        if hit is not None:
            return hit
        MT = self.MT
        counts = []
        for k in range(MT):
            band, deep = self._split_band(k, self._domain_rows(k, res))
            counts.append(len(self._groups(deep)))
        mt = counts[0] if counts else 0
        lmin = MT
        for k in range(MT):
            if counts[k] == 0:
                lmin = k
                break
        pairs: dict[int, list[tuple]] = {k: [] for k in range(MT)}
        if lmin == 0 or mt <= 1:
            self._greedy_cache[res] = pairs
            return pairs
        nT = [0] * lmin
        nZ = [0] * lmin
        nT[0] = counts[0]
        k = 0
        firstk = 0
        wave = 0
        guard = 0
        while (not (nT[lmin - 1] == counts[lmin - 1]
                    and nZ[lmin - 1] + 1 == nT[lmin - 1])
               and firstk < lmin):
            guard += 1
            assert guard < 16 * MT * MT, "greedy simulation diverged"
            height = (nT[k] - nZ[k]) // 2
            if height == 0:
                while (firstk < lmin and nT[firstk] == counts[firstk]
                       and nZ[firstk] + 1 == nT[firstk]):
                    if (firstk < lmin - 1
                            and counts[firstk + 1] == counts[firstk]):
                        # the survivor stays active next panel
                        nT[firstk + 1] += 1
                    firstk += 1
                k = firstk
                if firstk >= lmin:
                    break
                continue
            if k < lmin - 1:
                nT[k + 1] += height
            start = mt - nZ[k] - 1
            nZ[k] += height
            for j in range(start, start - height, -1):
                pairs[k].append((j, height, wave))
            wave += 1
            k += 1
            if k > lmin - 1:
                k = firstk
        self._greedy_cache[res] = pairs
        return pairs

    # -- schedule -----------------------------------------------------
    def schedule(self, k: int) -> list[Elim]:
        """Elimination schedule for panel k over rows [k, MT)."""
        hit = self._sched_cache.get(k)
        if hit is not None:
            return hit
        # domains by block-cyclic row owner (m % p), matching the
        # reference's distribution-aligned domains
        elims: list[Elim] = []
        domain_heads = []
        r_after_ts = 0
        per_domain = []   # (residue, band, leaders)
        for d in range(self.p):
            res = (k + d) % self.p
            dom = self._domain_rows(k, res)
            if not dom:
                continue
            band, deep = self._split_band(k, dom)
            leaders = []
            for group in self._groups(deep):
                lead = self._group_leader(k, group)
                leaders.append(lead)
                order = [m for m in group if m != lead]
                if self.tsrr and lead != group[0]:
                    # rotated kill order continues the round-robin
                    idx = group.index(lead)
                    order = group[idx + 1:] + group[:idx]
                for j, v in enumerate(order):
                    elims.append(Elim(lead, v, TS, 1 + j))
                    r_after_ts = max(r_after_ts, 2 + j)
            per_domain.append((res, band, leaders))
            domain_heads.append(band[0] if band else leaders[0])
        # low-level tree per domain (parallel across domains)
        r_low = r_after_ts or 1
        r_max = r_low
        for res, band, leaders in per_domain:
            if self.llvl == "greedy" and len(leaders) > 1:
                mt = len(self._groups(self._split_band(
                    0, self._domain_rows(0, res))[1]))
                off = mt - len(leaders)
                r_end = r_low
                for j, height, wave in self._greedy_pairs(res).get(k, ()):
                    piv = leaders[j - height - off]
                    vic = leaders[j - off]
                    elims.append(Elim(piv, vic, TT, r_low + wave))
                    r_end = max(r_end, r_low + wave + 1)
            else:
                e, r_end = _reduce_rounds(leaders, self.llvl, r_low, TT)
                elims.extend(e)
            low_head = leaders[0] if leaders else None
            r_max = max(r_max, r_end)
            if band:
                # domino: TT-chain the deep head and the band rows into
                # the domain head (the type-2 tasks, dplasma_hqr.c:197)
                chain = band[1:] + ([low_head] if low_head is not None
                                    else [])
                for v in chain:
                    elims.append(Elim(band[0], v, TT, r_max))
                    r_max += 1
        # high-level tree across domain heads; row k is the global head
        e, _ = _reduce_rounds(sorted(domain_heads), self.hlvl, r_max, TT)
        elims.extend(e)
        out = sorted(elims, key=lambda x: x.round)
        self._sched_cache[k] = out
        return out

    # -- vtable (dplasma_qrtree_t semantics) --------------------------
    def _kills(self, k: int) -> dict[int, Elim]:
        return {e.victim: e for e in self.schedule(k)}

    def leaders(self, k: int) -> list[int]:
        """Rows that run GEQRT in panel k (type != TS in the reference)."""
        hit = self._leader_cache.get(k)
        if hit is not None:
            return hit
        kills = self._kills(k)
        out = [m for m in range(k, self.MT)
               if m not in kills or kills[m].kind == TT]
        self._leader_cache[k] = out
        return out

    def getnbgeqrf(self, k: int) -> int:
        return len(self.leaders(k))

    def getm(self, k: int, i: int) -> int:
        return self.leaders(k)[i]

    def geti(self, k: int, m: int) -> int:
        return self.leaders(k).index(m)

    def gettype(self, k: int, m: int) -> int:
        kills = self._kills(k)
        if m in kills and kills[m].kind == TS:
            return 0
        return 1

    def currpiv(self, k: int, m: int) -> int:
        """The row that eliminates m in panel k."""
        return self._kills(k)[m].piv

    def _victims_of(self, k: int, piv: int) -> list[int]:
        return [e.victim for e in self.schedule(k) if e.piv == piv]

    def nextpiv(self, k: int, piv: int, m: int) -> int:
        """Next row killed by ``piv`` after m (m == MT → first);
        returns MT when exhausted (reference sentinel semantics)."""
        vs = self._victims_of(k, piv)
        if m == self.MT:
            return vs[0] if vs else self.MT
        i = vs.index(m)
        return vs[i + 1] if i + 1 < len(vs) else self.MT

    def prevpiv(self, k: int, piv: int, m: int) -> int:
        """Row killed by ``piv`` before m (m == MT → last)."""
        vs = self._victims_of(k, piv)
        if m == self.MT:
            return vs[-1] if vs else self.MT
        i = vs.index(m)
        return vs[i - 1] if i - 1 >= 0 else self.MT


def hqr_tree(MT: int, llvl: LowTree = "greedy", hlvl: HighTree = "flat",
             a: int = 4, p: int = 1, domino: bool = False,
             tsrr: bool = False) -> QRTree:
    """dplasma_hqr_init analog."""
    return QRTree(MT=MT, a=a, p=p, llvl=llvl, hlvl=hlvl, domino=domino,
                  tsrr=tsrr)


def systolic_tree(MT: int, p: int = 1, q: int = 1) -> QRTree:
    """dplasma_systolic_init analog: flat TS chains of depth q within p
    domains, flat coupling (src/dplasma_systolic_qr.c semantics)."""
    return QRTree(MT=MT, a=max(q, 1), p=max(p, 1), llvl="flat",
                  hlvl="flat")


def svd_tree(MT: int, p: int = 1, ratio: int = 2) -> QRTree:
    """dplasma_svd_init analog: greedy trees with TS-domain size set by
    the perf ratio between TS and TT kernels (qr_param.h:125-127)."""
    return QRTree(MT=MT, a=max(ratio, 1), p=max(p, 1), llvl="greedy",
                  hlvl="greedy")


# -- combinatorial pivgen checker (dplasma_qrtree_check analog) --------

def check_tree(tree: QRTree) -> None:
    """Validate the reduction-tree invariants for every panel
    (ref dplasma_qrtree_check, qr_param.h:138, dplasma_hqr_dbg.c):
    every non-head row killed exactly once by a live pivot above it;
    TS victims are never leaders; vtable functions consistent with the
    schedule. Raises AssertionError on violation."""
    MT = tree.MT
    for k in range(MT):
        sched = tree.schedule(k)
        victims = [e.victim for e in sched]
        assert sorted(victims) == list(range(k + 1, MT)), (
            f"panel {k}: victims {sorted(victims)}")
        assert k not in victims, f"panel {k}: head row killed"
        dead: set[int] = set()
        for e in sched:
            if e.kind == TS and tree.tsrr:
                # tsrr rotates the leader inside an aligned group, so a
                # TS pivot may sit below its victim; require only that
                # the pair shares the aligned super-row group
                same_group = ((e.piv % tree.p == e.victim % tree.p) and
                              (e.piv // tree.p) // tree.a
                              == (e.victim // tree.p) // tree.a)
                assert same_group, f"panel {k}: tsrr pair {e}"
            else:
                assert e.piv < e.victim, (
                    f"panel {k}: pivot below victim {e}")
            assert e.piv >= k and e.victim < MT, f"panel {k}: range {e}"
            assert e.piv not in dead, f"panel {k}: dead pivot {e}"
            dead.add(e.victim)
        # rounds are consistent: an elimination's pivot must not be
        # killed in an earlier-or-equal round
        kills = {e.victim: e for e in sched}
        for e in sched:
            if e.piv in kills:
                assert kills[e.piv].round > e.round, (
                    f"panel {k}: pivot {e.piv} killed in round "
                    f"{kills[e.piv].round} but used in round {e.round}")
        # TS victims must not be leaders; leaders bijection
        leaders = tree.leaders(k)
        for e in sched:
            if e.kind == TS:
                assert e.victim not in leaders
            else:
                assert e.victim in leaders
        for i, m in enumerate(leaders):
            assert tree.getm(k, i) == m and tree.geti(k, m) == i
        # currpiv/nextpiv/prevpiv walk the schedule
        for e in sched:
            assert tree.currpiv(k, e.victim) == e.piv
        for piv in {e.piv for e in sched}:
            vs = [e.victim for e in sched if e.piv == piv]
            walk, m = [], MT
            while True:
                m = tree.nextpiv(k, piv, m)
                if m == MT:
                    break
                walk.append(m)
            assert walk == vs, f"panel {k}: nextpiv walk {walk} != {vs}"
            walk, m = [], MT
            while True:
                m = tree.prevpiv(k, piv, m)
                if m == MT:
                    break
                walk.append(m)
            assert walk == vs[::-1], f"panel {k}: prevpiv walk"


# -- factorization -----------------------------------------------------

def _work_copy(A: TileMatrix) -> torch.Tensor:
    """A's zero-padded storage as a new row-major buffer that the op may
    write in place (conjugate views resolved)."""
    return A.zero_pad().data.clone(memory_format=torch.contiguous_format)


def _ct(data: torch.Tensor, desc) -> TileMatrix:
    """The conjugate transpose of the padded storage ``data`` as a new
    row-major buffer, under the transposed descriptor."""
    return TileMatrix(data.mH.clone(memory_format=torch.contiguous_format),
                      desc.transposed())


def geqrf_param(tree: QRTree, A: TileMatrix):
    """Tree-parameterized tile QR (dplasma_zgeqrf_param).

    Returns (factored TileMatrix, Tts, Ttt) — see module docstring for
    the storage contract.
    """
    assert A.desc.mb == A.desc.nb, "geqrf_param needs square tiles"
    nb = A.desc.nb
    KT = A.desc.KT
    assert tree.MT == A.desc.MT, (
        f"tree built for MT={tree.MT}, matrix has {A.desc.MT}")
    X = _work_copy(A)
    Np = A.desc.Np
    Tts = torch.zeros_like(X)
    Ttt = torch.zeros_like(X)

    def rows(m):
        return slice(m * nb, (m + 1) * nb)

    for k in range(KT):
        s, e = k * nb, (k + 1) * nb
        # 1) GEQRT every leader tile
        for m in tree.leaders(k):
            r = rows(m)
            packed, v, T = hh.geqrt(X[r, s:e])
            X[r, s:e] = packed
            Tts[r, s:e] = T
            if e < Np:
                X[r, e:] = hh.apply_q(v, T, X[r, e:], trans="C")
        # 2) replay eliminations in schedule order
        for el in tree.schedule(k):
            rp, rv = rows(el.piv), rows(el.victim)
            r_top = torch.triu(X[rp, s:e])
            bot = X[rv, s:e] if el.kind == TS else torch.triu(X[rv, s:e])
            r_new, v, T = hh.stacked_qr(r_top, bot)
            v2 = v[nb:, :]
            # the pivot tile keeps its GEQRT V below the diagonal; only
            # its R triangle is replaced by the couple's new R
            X[rp, s:e] = torch.tril(X[rp, s:e], -1) + r_new
            if el.kind == TS:
                X[rv, s:e] = v2
                Tts[rv, s:e] = T
            else:
                # keep the victim's GEQRT V below the diagonal; V2 of a
                # TT couple is upper triangular (UPPER_TILE remote type,
                # zgeqrf_param.jdf:80-85)
                X[rv, s:e] = torch.tril(X[rv, s:e], -1) + torch.triu(v2)
                Ttt[rv, s:e] = T
            if e < Np:
                ct, cb = hh.stacked_apply(v, T, X[rp, e:], X[rv, e:],
                                          trans="C")
                X[rp, e:] = ct
                X[rv, e:] = cb
    return (TileMatrix(X, A.desc),
            TileMatrix(Tts, A.desc), TileMatrix(Ttt, A.desc))


def _panel_ops(tree: QRTree, Af: TileMatrix, Tts: TileMatrix,
               Ttt: TileMatrix, k: int):
    """Reconstruct panel k's reflector sequence [(kind, args…)] in
    factorization order from the stored pieces."""
    nb = Af.desc.nb
    s, e = k * nb, (k + 1) * nb

    def rows(m):
        return slice(m * nb, (m + 1) * nb)

    ops = []
    for m in tree.leaders(k):
        v, _ = hh.split_qr(Af.data[rows(m), s:e])
        ops.append(("geqrt", m, v, Tts.data[rows(m), s:e]))
    for el in tree.schedule(k):
        if el.kind == TS:
            v2 = Af.data[rows(el.victim), s:e]
            T = Tts.data[rows(el.victim), s:e]
        else:
            v2 = torch.triu(Af.data[rows(el.victim), s:e])
            T = Ttt.data[rows(el.victim), s:e]
        v = torch.cat([torch.eye(nb, dtype=v2.dtype, device=v2.device),
                       v2], dim=0)
        ops.append(("couple", el.piv, el.victim, v, T))
    return ops


def _check_side_trans(side: str, trans: str) -> tuple[str, str]:
    side, trans = side.upper(), trans.upper()
    assert side in ("L", "R") and trans in ("N", "C", "T")
    return side, "C" if trans == "T" else trans


def unmqr_param(tree: QRTree, side: str, trans: str, Af: TileMatrix,
                Tts: TileMatrix, Ttt: TileMatrix,
                C: TileMatrix) -> TileMatrix:
    """Apply op(Q) from a geqrf_param factorization
    (dplasma_zunmqr_param, 4 side×trans JDFs). Left side only applies
    panels over matching row tiles; right side via the transpose dual."""
    side, trans = _check_side_trans(side, trans)
    if side == "R":
        # C op(Q) = (op(Q)^H C^H)^H
        flip = "C" if trans == "N" else "N"
        out = unmqr_param(tree, "L", flip, Af, Tts, Ttt,
                          _ct(C.zero_pad().data, C.desc))
        return TileMatrix(out.data.mH.resolve_conj(), C.desc)

    nb = Af.desc.nb
    KT = Af.desc.KT
    Y = _work_copy(C)

    def rows(m):
        return slice(m * nb, (m + 1) * nb)

    panel_range = range(KT) if trans == "C" else range(KT - 1, -1, -1)
    for k in panel_range:
        ops = _panel_ops(tree, Af, Tts, Ttt, k)
        if trans == "N":
            ops = ops[::-1]
        for op in ops:
            if op[0] == "geqrt":
                _, m, v, T = op
                Y[rows(m), :] = hh.apply_q(v, T, Y[rows(m), :], trans=trans)
            else:
                _, piv, victim, v, T = op
                ct, cb = hh.stacked_apply(v, T, Y[rows(piv), :],
                                          Y[rows(victim), :], trans=trans)
                Y[rows(piv), :] = ct
                Y[rows(victim), :] = cb
    return TileMatrix(Y, C.desc)


def ungqr_param(tree: QRTree, Af: TileMatrix, Tts: TileMatrix,
                Ttt: TileMatrix, K: int | None = None) -> TileMatrix:
    """Form Q explicitly from a geqrf_param factorization
    (dplasma_zungqr_param)."""
    M = Af.desc.M
    K = min(M, Af.desc.N) if K is None else K
    nb = Af.desc.nb
    E = TileMatrix.from_dense(
        torch.eye(M, K, dtype=Af.dtype, device=Af.device), nb, nb,
        Af.desc.dist)
    return unmqr_param(tree, "L", "N", Af, Tts, Ttt, E)


# -- LQ duals ----------------------------------------------------------

def gelqf_param(tree: QRTree, A: TileMatrix):
    """Tree-parameterized LQ (dplasma_zgelqf_param): QR dual of A^H."""
    assert A.desc.mb == A.desc.nb
    Bf, Tts, Ttt = geqrf_param(tree, _ct(A.zero_pad().data, A.desc))
    return (TileMatrix(Bf.data.mH.resolve_conj(), A.desc),
            TileMatrix(Tts.data, Bf.desc), TileMatrix(Ttt.data, Bf.desc))


def unmlq_param(tree: QRTree, side: str, trans: str, Af: TileMatrix,
                Tts: TileMatrix, Ttt: TileMatrix,
                C: TileMatrix) -> TileMatrix:
    """Apply op(Q) of a gelqf_param factorization (dplasma_zunmlq_param):
    conjugate-transpose C, flip the side, keep trans (see ops.qr.unmlq)."""
    side, trans = _check_side_trans(side, trans)
    out = unmqr_param(tree, "R" if side == "L" else "L", trans,
                      _ct(Af.data, Af.desc), Tts, Ttt,
                      _ct(C.zero_pad().data, C.desc))
    return TileMatrix(out.data.mH.resolve_conj(), C.desc)


def unglq_param(tree: QRTree, Af: TileMatrix, Tts: TileMatrix,
                Ttt: TileMatrix, K: int | None = None) -> TileMatrix:
    """Form Q rows from a gelqf_param factorization (dplasma_zunglq_param)."""
    N = Af.desc.N
    K = min(N, Af.desc.M) if K is None else K
    nb = Af.desc.nb
    E = TileMatrix.from_dense(
        torch.eye(K, N, dtype=Af.dtype, device=Af.device), nb, nb,
        Af.desc.dist)
    return unmlq_param(tree, "R", "N", Af, Tts, Ttt, E)
