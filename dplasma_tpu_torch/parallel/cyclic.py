"""Realized 2-D block-cyclic distribution on a P×Q virtual grid.

Ports the part of ``dplasma_tpu/parallel/cyclic.py`` that the
distributed Cholesky and pivoted LU need (:46-166, :299-377, :379-494,
:496-700, :1280-1384, :2172-2196). As in the reference, rank (p, q)
holds the reference's local tile storage: the tiles {(i, j): owner(i) =
p, owner(j) = q} packed into one (mloc, nloc) slab in cyclic order
(``parallel/layout.py``; ref parsec_matrix_block_cyclic_t,
tests/testing_zpotrf.c:100-103).

The reference runs each factorization as a ``shard_map`` program, one
device per rank. The port has a single-controller virtual mesh
(``parallel/mesh.py``): a :class:`CyclicMatrix` is a P×Q grid of slabs
on the mesh's one device, and the shard_map body becomes a lockstep
loop over the ranks in one process. Per step each phase runs for every
rank, and the collectives run between phases over the list of the
ranks' tensors along one axis: :func:`_psum` (summed in rank order, the
result handed to every rank), :func:`_all_gather` (stacked in rank
order), and the ring transfers of kernel K5 (``kernels/pallas_ring.py``)
under MCA ``ring.enable``: the panel broadcast along 'q'
(:func:`_bcast_q`) and the LU winner-row exchange along 'p'. A rank's
``axis_index`` is a Python int here, so the reference's
``jnp.where(q == qk, ...)`` is a branch with the same values. Every
per-rank product and solve is the reference's: ``blas.dot`` (so K1 when
it is enabled), ``blas.potrf``, ``blas.trsm``; the LU candidate election
takes ``rec`` under ``panel.kernel=pallas`` or ``rec``, else the vendor
LU (``ops/lu._lu_chain``, cuSOLVER by name).

Conversions use the gather path (index tables from ``layout``): the
reference's all_to_all exchange (MCA ``cyclic.convert=a2a``) bounds the
per-device memory of a mesh over several devices, which the port does
not have yet; the knob comes with that path.

Not ported yet (ROADMAP queue 1 item 11): the U storage of
``potrf_cyclic``, ``geqrf_cyclic`` and the other ``*_cyclic`` ops, the
a2a conversions, ``spmd_comm_model``, the ``ring`` phase span, a mesh
over several cards, and the dd route under a grid.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Tuple

import numpy as np
import torch

from dplasma_tpu_torch import resolve_device
from dplasma_tpu_torch.descriptors import Dist, TileDesc, TileMatrix
from dplasma_tpu_torch.kernels import blas as kb
from dplasma_tpu_torch.parallel import layout
from dplasma_tpu_torch.parallel import mesh as pmesh
from dplasma_tpu_torch.utils import config as _cfg

_QUEUED = "ROADMAP queue 1 item 11"


@dataclasses.dataclass(frozen=True)
class CyclicDesc:
    M: int
    N: int
    mb: int
    nb: int
    dist: Dist

    @property
    def MT(self):
        return -(-self.M // self.mb)

    @property
    def NT(self):
        return -(-self.N // self.nb)

    @property
    def MTL(self):
        """Local row-tile slots per rank (ceil-uniform)."""
        return max(layout.max_local_count(self.MT, self.dist.P,
                                          self.dist.kp), 1)

    @property
    def NTL(self):
        return max(layout.max_local_count(self.NT, self.dist.Q,
                                          self.dist.kq), 1)

    @staticmethod
    def from_dict(d: dict) -> "CyclicDesc":
        """From the reference ``CyclicDesc``'s fields
        (``dataclasses.asdict`` of it)."""
        dist = d.get("dist") or {}
        if isinstance(dist, dict):
            dist = Dist(**dist)
        return CyclicDesc(int(d["M"]), int(d["N"]), int(d["mb"]),
                          int(d["nb"]), dist)


def _slot_tiles(n_slots: int, nranks: int, k: int, off: int) -> np.ndarray:
    """(nranks, n_slots) global tile index of each local slot."""
    return np.array([[layout.global_index(l, r, nranks, k, off)
                      for l in range(n_slots)] for r in range(nranks)])


class CyclicMatrix:
    """Block-cyclic distributed matrix: ``data[p][q]`` is rank (p, q)'s
    (MTL*mb, NTL*nb) slab; every slab is on the mesh's device."""

    def __init__(self, data: List[List[torch.Tensor]], desc: CyclicDesc):
        self.data = data
        self.desc = desc

    @property
    def dtype(self):
        return self.data[0][0].dtype

    @property
    def device(self):
        return self.data[0][0].device

    # -- conversions ---------------------------------------------------
    @staticmethod
    def from_tile(A: TileMatrix, dist: Dist | None = None,
                  mesh=None) -> "CyclicMatrix":
        """Natural-order TileMatrix -> cyclic local slabs (the gather
        path of cyclic.py:107-130): row tiles, then column tiles, picked
        by the slot tables, pad slots zero. The slabs go to the active
        (or given) mesh's device, else stay on A's."""
        d = dist or A.desc.dist
        desc = CyclicDesc(A.desc.M, A.desc.N, A.desc.mb, A.desc.nb, d)
        m = mesh or pmesh.active()
        dev = m.device if m is not None else A.device
        MT, NT, mb, nb = desc.MT, desc.NT, desc.mb, desc.nb
        X = A.zero_pad().data.to(dev)
        X4 = X[:MT * mb, :NT * nb].reshape(MT, mb, NT, nb)
        gi = _slot_tiles(desc.MTL, d.P, d.kp, d.ip)
        gj = _slot_tiles(desc.NTL, d.Q, d.kq, d.jq)
        data = []
        for p in range(d.P):
            ri = torch.as_tensor(gi[p].clip(max=MT - 1), device=dev)
            rv = torch.as_tensor(gi[p] < MT, device=dev)
            Xr = X4.index_select(0, ri).masked_fill(
                ~rv[:, None, None, None], 0)
            row = []
            for q in range(d.Q):
                ci = torch.as_tensor(gj[q].clip(max=NT - 1), device=dev)
                cv = torch.as_tensor(gj[q] < NT, device=dev)
                s = Xr.index_select(2, ci).masked_fill(
                    ~cv[None, None, :, None], 0)
                row.append(s.reshape(desc.MTL * mb, desc.NTL * nb))
            data.append(row)
        return CyclicMatrix(data, desc)

    def to_tile(self) -> TileMatrix:
        """Cyclic slabs -> natural-order TileMatrix (the gather path of
        cyclic.py:143-166, as scatters of each rank's valid tiles)."""
        desc = self.desc
        d = desc.dist
        MT, NT, mb, nb = desc.MT, desc.NT, desc.mb, desc.nb
        out = TileDesc(desc.M, desc.N, mb, nb, d)
        dev = self.device
        X = torch.zeros((out.Mp, out.Np), dtype=self.dtype, device=dev)
        X4 = X[:MT * mb, :NT * nb].view(MT, mb, NT, nb)
        gi = _slot_tiles(desc.MTL, d.P, d.kp, d.ip)
        gj = _slot_tiles(desc.NTL, d.Q, d.kq, d.jq)
        for p in range(d.P):
            rs = np.nonzero(gi[p] < MT)[0]
            gr = torch.as_tensor(gi[p][rs], device=dev)
            rs = torch.as_tensor(rs, device=dev)
            for q in range(d.Q):
                cs = np.nonzero(gj[q] < NT)[0]
                gc = torch.as_tensor(gj[q][cs], device=dev)
                cs = torch.as_tensor(cs, device=dev)
                s4 = self.data[p][q].view(desc.MTL, mb, desc.NTL, nb)
                s4 = s4.index_select(0, rs).index_select(2, cs)
                X4[gr[:, None], :, gc[None, :], :] = s4.permute(0, 2, 1, 3)
        return TileMatrix(X, out)

    @staticmethod
    def from_reference(data: np.ndarray, desc: dict,
                       device=None) -> "CyclicMatrix":
        """The reference ``CyclicMatrix``'s ``(P, Q, mloc, nloc)`` array
        (``np.asarray(C.data)``) and descriptor
        (``dataclasses.asdict(C.desc)``) as port slabs on ``device``."""
        d = CyclicDesc.from_dict(desc)
        dev = resolve_device(device)
        want = (d.dist.P, d.dist.Q, d.MTL * d.mb, d.NTL * d.nb)
        if tuple(data.shape) != want:
            raise ValueError(f"slabs {tuple(data.shape)} do not match "
                             f"descriptor {want}")
        return CyclicMatrix(
            [[torch.from_numpy(np.array(data[p, q], copy=True)).to(dev)
              for q in range(d.dist.Q)] for p in range(d.dist.P)], d)

    def to_reference(self) -> tuple:
        """``(slabs as a (P, Q, mloc, nloc) numpy array, descriptor
        dict)`` — the inverse of :meth:`from_reference`."""
        arr = np.stack([np.stack([s.detach().cpu().numpy() for s in row])
                        for row in self.data])
        return arr, dataclasses.asdict(self.desc)


# ---------------------------------------------------------------------
# Per-rank coordinates and the collectives over one axis's rank list
# ---------------------------------------------------------------------

def _grow(lslots: int, nb: int, rank: int, P: int, kp: int, ip: int,
          device=None) -> torch.Tensor:
    """Global tile index per local element row of rank ``rank``:
    g(l) = (l//kp * P + (rank - ip) % P) * kp + l % kp."""
    l = torch.arange(lslots * nb, device=device) // nb
    return ((l // kp) * P + (rank - ip) % P) * kp + l % kp


def _slab_coords(desc: CyclicDesc, p: int, q: int, device=None):
    """Per-element global coordinates of a rank's local slab:
    (grow, gcol) tile ids and (gid, gcid) element ids."""
    d = desc.dist
    grow = _grow(desc.MTL, desc.mb, p, d.P, d.kp, d.ip, device)
    gcol = _grow(desc.NTL, desc.nb, q, d.Q, d.kq, d.jq, device)
    gid = grow * desc.mb + torch.arange(desc.MTL * desc.mb,
                                        device=device) % desc.mb
    gcid = gcol * desc.nb + torch.arange(desc.NTL * desc.nb,
                                         device=device) % desc.nb
    return grow, gcol, gid, gcid


def _seed_pad_diag(A, desc: CyclicDesc, gid, gcid):
    """Well-posed padding for factorizations: 1.0 on the pad diagonal
    of the slab (conversions zero the pad region) — factor
    blkdiag(A, I). Returns a new tensor."""
    K = min(desc.M, desc.N)
    KT = min(desc.MT, desc.NT)
    padrow = (gid >= K) & (gid < KT * desc.mb)
    eq = (gid[:, None] == gcid[None, :]) & padrow[:, None]
    return torch.where(eq, torch.ones((), dtype=A.dtype, device=A.device),
                       A)


def _psum(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over one axis's ranks, in rank order; every rank gets the
    (one, new) result."""
    s = xs[0].clone() if len(xs) == 1 else xs[0]
    for x in xs[1:]:
        s = s + x
    return [s] * len(xs)


def _all_gather(xs: List[torch.Tensor]) -> torch.Tensor:
    """Stack one axis's blocks in rank order (every rank's result)."""
    return torch.stack(xs)


def _bcast_q(vals: List[torch.Tensor], qk: int, ring: bool,
             rchunks: int = 0) -> List[torch.Tensor]:
    """Panel broadcast along 'q' from owner column ``qk``: the K5 ring
    when ``ring`` (each hop carries the panel once), else the masked
    psum (the ``ring.enable=off`` path). The owner mask is one-hot, so
    both give identical values. ``rchunks`` is the pinned pipelining
    depth (0: MCA ``ring.chunks``)."""
    if ring and len(vals) > 1:
        from dplasma_tpu_torch.kernels import pallas_ring as _pring
        return _pring.ring_bcast(vals, root=qk,
                                 chunks=rchunks if rchunks > 0 else None)
    return _psum([v if q == qk else torch.zeros_like(v)
                  for q, v in enumerate(vals)])


def _rows_q(vals: Dict[Tuple[int, int], torch.Tensor], P: int, Q: int,
            fn) -> Dict[Tuple[int, int], torch.Tensor]:
    """Run a collective ``fn`` along 'q' for each process row."""
    out = {}
    for p in range(P):
        res = fn([vals[p, q] for q in range(Q)])
        out.update({(p, q): res[q] for q in range(Q)})
    return out


def _cols_p(vals: Dict[Tuple[int, int], torch.Tensor], P: int, Q: int,
            fn) -> Dict[Tuple[int, int], torch.Tensor]:
    """Run a collective ``fn`` along 'p' for each process column."""
    out = {}
    for q in range(Q):
        res = fn([vals[p, q] for p in range(P)])
        out.update({(p, q): res[p] for p in range(P)})
    return out


def _dd_guard(dtype) -> None:
    if kb._dd_active(dtype):
        raise NotImplementedError(
            "the block-cyclic factorizations under dd_gemm=always (the dd "
            f"route under a grid) are not ported yet ({_QUEUED})")


# ---------------------------------------------------------------------
# Distributed Cholesky (lower)
# ---------------------------------------------------------------------

def _potrf_cyclic(A: CyclicMatrix, lookahead: int = 0, ring: bool = False,
                  rchunks: int = 0) -> List[List[torch.Tensor]]:
    """The reference's ``_potrf_cyclic_jit`` body (cyclic.py:379-494) in
    lockstep: per step k, the panel column broadcast along 'q' (or the
    lookahead-carried pre-updated column), the diagonal tile along 'p'
    (masked psum), the local panel solve, the owners' write-back, the
    row panel by all_gather along 'p' and a cyclic row pick, and one
    local trailing product per rank. ``lookahead`` > 0 broadcasts and
    narrowly updates the next panel column before the wide product."""
    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    assert desc.mb == desc.nb and desc.M == desc.N
    KT = min(desc.MT, desc.NT)
    mloc = desc.MTL * mb
    nloc = desc.NTL * mb
    cplx = A.dtype.is_complex
    dev = A.device
    ranks = [(p, q) for p in range(P) for q in range(Q)]
    S = {(p, q): A.data[p][q].clone() for p, q in ranks}
    grow = {p: _grow(desc.MTL, mb, p, P, d.kp, d.ip, dev) for p in range(P)}
    gcol = {q: _grow(desc.NTL, mb, q, Q, d.kq, d.jq, dev) for q in range(Q)}
    # the cyclic row pick of step 5: row tile jt of column slot j sits on
    # rank pj at local row lj*mb + j % mb of the gathered panels. An
    # over-allocated pad slot can point past the end; the reference's
    # gather clamps such an index, and so does this one
    pick = {}
    for q in range(Q):
        jt = gcol[q]
        pj = (jt // d.kp + d.ip) % P
        lj = (jt // (d.kp * P)) * d.kp + jt % d.kp
        pick[q] = (pj * mloc + lj * mb + torch.arange(nloc, device=dev)
                   % mb).clamp(max=P * mloc - 1)

    pan_next = None
    for k in range(KT):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        lrk = layout.local_index(k, P, d.kp)
        lck = layout.local_index(k, Q, d.kq)
        rk = slice(lrk * mb, (lrk + 1) * mb)
        ck = slice(lck * mb, (lck + 1) * mb)
        # 1) broadcast block column k along 'q' — or take the
        # lookahead-carried pre-updated column
        cs = {r: S[r][:, ck] for r in ranks}
        pan = pan_next if pan_next is not None else _rows_q(
            cs, P, Q, partial(_bcast_q, qk=qk, ring=ring, rchunks=rchunks))
        # 2) broadcast the diagonal tile along 'p' (masked psum)
        ddt = _cols_p({(p, q): pan[p, q][rk] if p == pk
                       else torch.zeros((mb, mb), dtype=A.dtype, device=dev)
                       for p, q in ranks}, P, Q, _psum)
        Lpan, Lbelow = {}, {}
        for p, q in ranks:
            Lkk = kb.potrf(ddt[p, q], lower=True)
            # 3) local panel solve (rows strictly below k)
            sol = kb.trsm(Lkk, pan[p, q], side="R", lower=True, trans="C")
            below = (grow[p] > k)[:, None]
            lp = torch.where(below, sol, torch.zeros_like(sol))
            if p == pk:
                diagrow = (grow[p] == k)[:, None]
                at_k = torch.zeros_like(sol)
                at_k[rk] = Lkk
                lp = torch.where(diagrow, at_k, lp)
            Lpan[p, q] = lp
            Lbelow[p, q] = torch.where(below, lp, torch.zeros_like(lp))
            # 4) owners write the factored panel back
            if q == qk:
                keep = (grow[p] >= k)[:, None]
                S[p, q][:, ck] = torch.where(keep, lp, cs[p, q])
        # 5) row panel: all_gather along 'p' + cyclic row pick
        allg = {q: _all_gather([Lpan[p, q] for p in range(P)]).reshape(
            P * mloc, mb) for q in range(Q)}
        W = {}
        for p, q in ranks:
            w = allg[q][pick[q]]
            W[p, q] = torch.where((gcol[q] > k)[:, None], w,
                                  torch.zeros_like(w))
        # 5b) lookahead: broadcast the STALE next panel column and apply
        # step k's rank-mb update to it narrowly
        if lookahead > 0 and k + 1 < KT:
            qk1 = layout.owner(k + 1, Q, d.kq, d.jq)
            lck1 = layout.local_index(k + 1, Q, d.kq)
            pk1 = layout.owner(k + 1, P, d.kp, d.ip)
            lrk1 = layout.local_index(k + 1, P, d.kp)
            stale = _rows_q({r: S[r][:, lck1 * mb:(lck1 + 1) * mb]
                             for r in ranks}, P, Q,
                            partial(_bcast_q, qk=qk1, ring=ring,
                                    rchunks=rchunks))
            base = pk1 * mloc + lrk1 * mb
            pan_next = {}
            for p, q in ranks:
                Lk1 = allg[q][base:base + mb]
                pan_next[p, q] = stale[p, q] - kb.dot(
                    Lbelow[p, q], Lk1, tb=True, conj_b=cplx)
        else:
            pan_next = None
        # 6) local trailing update (one product per rank)
        for p, q in ranks:
            S[p, q] = S[p, q] - kb.dot(Lbelow[p, q], W[p, q], tb=True,
                                       conj_b=cplx)
    return [[S[p, q] for q in range(Q)] for p in range(P)]


# ---------------------------------------------------------------------
# Distributed pivoted LU (the ptgpanel shape)
# ---------------------------------------------------------------------

def _set_rows(X: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor):
    """``X.at[rows].set(vals, mode="drop")``: rows equal to X's row count
    are dropped (they land on a scratch row). Returns a new tensor."""
    ext = torch.empty((X.shape[0] + 1, X.shape[1]), dtype=X.dtype,
                      device=X.device)
    ext[:-1] = X
    ext.index_copy_(0, rows, vals)
    return ext[:-1]


def _getrf_cyclic(A: CyclicMatrix, lookahead: int = 0, panel: str = "chain",
                  ring: bool = False, rchunks: int = 0):
    """The reference's ``_getrf_cyclic_jit`` body (cyclic.py:496-654) in
    lockstep — distributed tournament-pivoting LU over cyclic slabs.
    Per step: the panel broadcast along 'q'; each row-rank elects mb
    candidate rows with one local LU; an all_gather along 'p' stages the
    playoff, a replicated LU of the P·mb candidates picks the winners;
    the winner rows are exchanged along 'p' (K5 ring all-reduce or
    masked psum; one owner per row, so both sums are exact); local U12
    solve, L column and Schur update. Factor rows stay in their owners'
    slabs; pivoting is deferred to the returned global permutation.

    Returns (factor slabs, win_gids[p][q] (KT, mb) global element-row
    ids in elimination order, active[p][q] (mloc,) bools)."""
    from dplasma_tpu_torch.kernels import pallas_ring as _pring
    from dplasma_tpu_torch.kernels import panels as _panels
    from dplasma_tpu_torch.ops import lu as _lu

    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    assert desc.mb == desc.nb, "getrf_cyclic needs square tiles"
    KT = min(desc.MT, desc.NT)
    mloc = desc.MTL * mb
    nloc = desc.NTL * mb
    dev = A.device
    ranks = [(p, q) for p in range(P) for q in range(Q)]
    co = {(p, q): _slab_coords(desc, p, q, dev) for p, q in ranks}
    S = {r: _seed_pad_diag(A.data[r[0]][r[1]], desc, co[r][2], co[r][3])
         for r in ranks}
    active = {r: torch.ones(mloc, dtype=torch.bool, device=dev)
              for r in ranks}
    wins = {r: [] for r in ranks}

    def elect(x):
        if panel == "rec":
            return _panels.lu_panel_rec(x)
        return _lu._lu_chain(x)

    exchange = _pring.ring_allreduce if ring and P > 1 else _psum
    pan_next = None
    for k in range(KT):
        qk = layout.owner(k, Q, d.kq, d.jq)
        lck = layout.local_index(k, Q, d.kq)
        ck = slice(lck * mb, (lck + 1) * mb)
        # 1) panel broadcast along 'q' — or the lookahead-carried
        # pre-updated next column from the previous step
        cs = {r: S[r][:, ck] for r in ranks}
        pan = pan_next if pan_next is not None else _rows_q(
            cs, P, Q, partial(_bcast_q, qk=qk, ring=ring, rchunks=rchunks))
        # 2) local candidate election (one local LU per rank)
        panm, cand_pos, cands = {}, {}, {}
        for r in ranks:
            panm[r] = torch.where(active[r][:, None], pan[r],
                                  torch.zeros_like(pan[r]))
            _, cperm = elect(panm[r])
            cand_pos[r] = cperm[:mb]
            cands[r] = panm[r][cand_pos[r]]
        # 3) playoff: all_gather the candidates along 'p', replicated LU
        allc = {q: _all_gather([cands[p, q] for p in range(P)]).reshape(
            P * mb, mb) for q in range(Q)}
        allid = {q: _all_gather([co[p, q][2][cand_pos[p, q]]
                                 for p in range(P)]).reshape(P * mb)
                 for q in range(Q)}
        top, mine, win_lrow, elim, sel = {}, {}, {}, {}, {}
        for p, q in ranks:
            r = (p, q)
            lu2, perm2 = elect(allc[q])
            wr = perm2[:mb]
            wins[r].append(allid[q][wr])
            top[r] = lu2[:mb]                  # packed L11\U11 rows
            # 4) my winners -> local rows; retire them from the active set
            mine[r] = (wr // mb) == p
            win_lrow[r] = torch.where(mine[r], cand_pos[r][wr % mb],
                                      torch.full_like(wr, mloc))
            e = torch.zeros(mloc + 1, dtype=torch.bool, device=dev)
            e[win_lrow[r]] = True
            elim[r] = e[:mloc]
            # 5) winner rows' current values for my columns
            got = S[r][torch.where(mine[r], win_lrow[r],
                                   torch.zeros_like(wr))]
            sel[r] = torch.where(mine[r][:, None], got,
                                 torch.zeros_like(got))
        # the pivot-row exchange along 'p': ring all-reduce (P-1 K5
        # shifts + adds) or masked psum — disjoint contributions
        wrows = _cols_p(sel, P, Q, exchange)
        u12, l21 = {}, {}
        for p, q in ranks:
            r = (p, q)
            u = kb.trsm(top[r], wrows[r], side="L", lower=True, unit=True)
            trailing = (co[r][1] > k)[None, :]
            u12[r] = torch.where(trailing, u, torch.zeros_like(u))
            # 6) local L column
            l = kb.trsm(torch.triu(top[r]), panm[r], side="R", lower=False)
            l21[r] = torch.where((active[r] & ~elim[r])[:, None], l,
                                 torch.zeros_like(l))
        # 6b) lookahead: assemble the NEXT panel column — narrow Schur
        # update + the winner-row substitution of step 8 — broadcast
        # along 'q' before the wide update
        if lookahead > 0 and k + 1 < KT:
            qk1 = layout.owner(k + 1, Q, d.kq, d.jq)
            lck1 = layout.local_index(k + 1, Q, d.kq)
            c1 = slice(lck1 * mb, (lck1 + 1) * mb)
            coln = {}
            for r in ranks:
                u12k1 = u12[r][:, c1]
                col = S[r][:, c1] - kb.dot(l21[r], u12k1)
                coln[r] = _set_rows(col, win_lrow[r], u12k1)
            pan_next = _rows_q(coln, P, Q, partial(
                _bcast_q, qk=qk1, ring=ring, rchunks=rchunks))
        else:
            pan_next = None
        for p, q in ranks:
            r = (p, q)
            # the Schur update lands in a buffer with one scratch row,
            # where step 8 drops the rows of other ranks' winners
            ext = S[r].new_empty((mloc + 1, nloc))
            X = ext[:mloc]
            torch.sub(S[r], kb.dot(l21[r], u12[r]), out=X)
            # 7) owners write the L column into the panel block
            if q == qk:
                X[:, ck] = torch.where((active[r] & ~elim[r])[:, None],
                                       l21[r], cs[r])
            # 8) winner rows take their factor content (U12 on trailing
            # columns, packed L11\U11 in the panel block)
            trailing = (co[r][1] > k)[None, :]
            row_new = torch.where(trailing, u12[r], wrows[r])
            if q == qk:
                row_new[:, ck] = top[r]
            ext.index_copy_(0, win_lrow[r], row_new)
            S[r] = X
            active[r] = active[r] & ~elim[r]
    return ([[S[p, q] for q in range(Q)] for p in range(P)],
            [[torch.stack(wins[p, q]) for q in range(Q)] for p in range(P)],
            [[active[p, q] for q in range(Q)] for p in range(P)])


def getrf_cyclic(A: CyclicMatrix):
    """Distributed partial-pivoting LU on block-cyclic local storage
    (the pdgetrf / zgetrf_ptgpanel shape). Returns (factor CyclicMatrix —
    rows in place, perm) with the :func:`dplasma_tpu_torch.ops.lu.
    getrf_1d` contract ``A[perm] = L U`` after gathering rows by
    ``perm``."""
    from dplasma_tpu_torch.kernels import panels as _panels
    m = _mesh_of(A)
    _dd_guard(A.dtype)
    pk = _panels.panel_kernel("lu")
    if pk == "pallas":   # the reference's rule: no fused panel here
        pk = "rec"
    ring = _cyclic_ring(A.desc, A.dtype, m, need_row=True)
    out, wins, active = _getrf_cyclic(A, _cyclic_lookahead(), pk, ring,
                                      _ring_chunks(ring))
    desc = A.desc
    d = desc.dist
    mb = desc.mb
    Mp = desc.MT * mb
    KT = min(desc.MT, desc.NT)
    win_flat = wins[0][0].reshape(-1)
    nleft = Mp - KT * mb   # winners cover exactly KT*mb rows
    if nleft:
        # leftover rows (tall case), ascending global id, excluding
        # over-allocated pad slots
        mloc = desc.MTL * mb
        gids = torch.as_tensor(np.concatenate([
            np.asarray([layout.global_index(l // mb, p, d.P, d.kp, d.ip)
                        * mb + l % mb for l in range(mloc)])
            for p in range(d.P)]), device=win_flat.device)
        act = torch.cat([active[p][0] for p in range(d.P)])
        key = torch.where(act & (gids < Mp), gids,
                          torch.full_like(gids, Mp + 1))
        left = torch.sort(key).values[:nleft].to(win_flat.dtype)
        perm = torch.cat([win_flat, left])
    else:
        perm = win_flat
    return CyclicMatrix(out, desc), perm[:Mp]


def potrf_cyclic(A: CyclicMatrix, uplo: str = "L") -> CyclicMatrix:
    """Distributed right-looking Cholesky on block-cyclic local storage
    (the pdpotrf shape; ref src/zpotrf_L.jdf over
    parsec_matrix_block_cyclic). Lower storage; the global-array
    :func:`dplasma_tpu_torch.ops.potrf.potrf` remains the single-device
    path."""
    if uplo.upper() not in ("L", "U"):
        raise ValueError(f"uplo must be L or U, got {uplo!r}")
    m = _mesh_of(A)
    if uplo.upper() == "U":
        raise NotImplementedError(
            f"potrf_cyclic uplo=U is not ported yet ({_QUEUED})")
    _dd_guard(A.dtype)
    ring = _cyclic_ring(A.desc, A.dtype, m)
    out = _potrf_cyclic(A, _cyclic_lookahead(), ring, _ring_chunks(ring))
    return CyclicMatrix(out, A.desc)


# ---------------------------------------------------------------------
# Wrapper-side resolution (cyclic.py:1280-1384)
# ---------------------------------------------------------------------

def _cyclic_ring(desc: CyclicDesc, dtype, mesh,
                 need_row: bool = False) -> bool:
    """Resolve MCA ``ring.enable`` for one cyclic factorization: the
    panel-broadcast ring rides the 'q' axis, the LU winner-row exchange
    (``need_row``) the 'p' axis. Every ringable axis (size > 1) the
    kernel would use must pass its gate; one flag covers both, with a
    size-1 axis falling back on its own."""
    from dplasma_tpu_torch.kernels import pallas_ring as _pring
    d = desc.dist
    gates = []
    if d.Q > 1:
        gates.append(_pring.ring_active(d.Q, dtype, mesh, pmesh.COL_AXIS))
    if need_row and d.P > 1:
        gates.append(_pring.ring_active(d.P, dtype, mesh, pmesh.ROW_AXIS))
    return bool(gates) and all(gates)


def _ring_chunks(ring: bool) -> int:
    """Resolve MCA ``ring.chunks`` once per factorization; 0 on the psum
    path."""
    return _cfg.mca_get_int("ring.chunks", 4) if ring else 0


def _cyclic_lookahead() -> int:
    """Pipeline depth of the cyclic factorizations: MCA
    ``sweep.lookahead`` > 0 enables the one-column ``pan_next`` carry."""
    from dplasma_tpu_torch.ops._sweep import sweep_params
    la, _ = sweep_params()
    return 1 if la > 0 else 0


def _mesh_of(A: CyclicMatrix):
    m = pmesh.active()
    if m is None:
        raise RuntimeError("cyclic ops need an active mesh (use_grid)")
    ms = (m.shape[pmesh.ROW_AXIS], m.shape[pmesh.COL_AXIS])
    if ms != (A.desc.dist.P, A.desc.dist.Q):
        raise ValueError(f"mesh {ms} != dist grid "
                         f"{(A.desc.dist.P, A.desc.dist.Q)}")
    return m
