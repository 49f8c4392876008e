"""Realized 2-D block-cyclic distribution on a P×Q virtual grid.

Ports ``dplasma_tpu/parallel/cyclic.py`` but for its all_to_all
conversions: the conversions, the
distributed Cholesky in both storages, the pivoted LU, the triangular
solves and POTRS/GETRS with the slab row gather, SUMMA over slabs, the
Level-3 BLAS (herk, trmm, hemm, her2k), the inverses (lauum, trtri,
potri), the distributed QR (CholeskyQR2 + TSQR-HR panels) with its
T-factor conversion, the eigen and SVD stage 1 on the slabs (herbt,
ge2gb) with heev/gesvd finishing on one device, the analytic comm
model, and the ``ring`` phase span with its panel-broadcast probe
(:func:`_panel_bcast_probe`, timed only under a phase ledger). As in the reference, rank (p, q) holds the reference's local
tile storage: the tiles {(i, j): owner(i) = p, owner(j) = q} packed
into one (mloc, nloc) slab in cyclic order (``parallel/layout.py``; ref
parsec_matrix_block_cyclic_t, tests/testing_zpotrf.c:100-103).

The reference runs each op as a ``shard_map`` program, one device per
rank. The port has a single-controller virtual mesh
(``parallel/mesh.py``): a :class:`CyclicMatrix` is a P×Q grid of slabs
on the mesh's one device, and the shard_map body becomes a lockstep
loop over the ranks in one process. Per step each phase runs for every
rank, and the collectives run between phases over the list of the
ranks' tensors along one axis: :func:`_psum` (summed in rank order, the
result handed to every rank), :func:`_masked_psum` (the reference's
owner-masked psum broadcast), :func:`_all_gather` (stacked in rank
order), and the ring transfers of kernel K5 (``kernels/pallas_ring.py``)
under MCA ``ring.enable``: the panel broadcast along 'q'
(:func:`_bcast_q`, in potrf L, getrf and geqrf) and the LU winner-row
exchange along 'p'. A rank's ``axis_index`` is a Python int here, so
the reference's ``jnp.where(q == qk, ...)`` is a branch with the same
values. Every per-rank product and solve is the reference's:
``blas.dot`` (so K1 when it is enabled), ``blas.potrf``, ``blas.trsm``;
the LU candidate election takes ``rec`` under ``panel.kernel=pallas``
or ``rec``, else the vendor LU (``ops/lu._lu_chain``, cuSOLVER by
name). A value the reference computes on every rank of an axis from
one psum's result (a CholeskyQR2 panel's Gram factor, R, the top block
and its reconstruction) is computed once for that axis group: its
inputs are the very same tensor, so every rank's copy would be bitwise
the same.

Conversions use the gather path (index tables from ``layout``): the
reference's all_to_all exchange (MCA ``cyclic.convert=a2a``) bounds the
per-device memory of a mesh over several devices, which the port does
not have yet; the knob comes with that path.

Under MCA ``dd_gemm=always`` every op here runs the f64-equivalent limb
route, as the reference's shard_map bodies do: each rank's products go
through ``blas.dot`` to ``dd.mm`` (kernel K2), its solves to
``dd.trsm_f64`` and its tile factors to ``dd.potrf_f64``; the eigen/SVD
second stages stay native FP64, as on one device. The f64 slabs keep the
psum path: K5 moves f32/bf16 only (``pallas_ring.ring_active``). The
reference's ``_pin_cat_axis`` (a sharding pin on the limb products) has
no counterpart: the mesh is an eager lockstep loop with no partitioner.

Not ported yet (ROADMAP queue 1 item 11, step 4): the a2a conversions
and a mesh over several cards.
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


def _masked_psum(vals: List[torch.Tensor], root: int) -> List[torch.Tensor]:
    """The reference's owner-masked psum broadcast along one axis:
    ``psum(where(axis_index == root, v, 0))`` — the root's value plus
    the other ranks' zeros, handed to every rank."""
    return _psum([v if i == root else torch.zeros_like(v)
                  for i, v in enumerate(vals)])


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
                                 chunks=rchunks if rchunks > 0 else None,
                                 axis=pmesh.COL_AXIS)
    return _masked_psum(vals, qk)


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
        ddt = _cols_p({r: pan[r][rk] for r in ranks}, P, Q,
                      partial(_masked_psum, root=pk))
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

    exchange = partial(_pring.ring_allreduce, axis=pmesh.ROW_AXIS) \
        if ring and P > 1 else _psum
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
    pk = _panels.panel_kernel("lu")
    if pk == "pallas":   # the reference's rule: no fused panel here
        pk = "rec"
    ring = _cyclic_ring(A.desc, A.dtype, m, need_row=True)
    rch = _ring_chunks(ring)
    _ring_span(A, ring, rch)
    out, wins, active = _getrf_cyclic(A, _cyclic_lookahead(), pk, ring,
                                      rch)
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


# ---------------------------------------------------------------------
# Shared per-rank helpers of the ops below
# ---------------------------------------------------------------------

def _ranks(d: Dist):
    return [(p, q) for p in range(d.P) for q in range(d.Q)]


def _ct(x: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose (a plain transpose for real data)."""
    return x.mH if x.is_complex() else x.T


def _cj(x: torch.Tensor) -> torch.Tensor:
    return x.conj() if x.is_complex() else x


def _blk(lslot: int, mb: int) -> slice:
    return slice(lslot * mb, (lslot + 1) * mb)


def _put_rows(like: torch.Tensor, blk: torch.Tensor, lslot: int,
              mb: int) -> torch.Tensor:
    """Zeros shaped like ``like`` with ``blk`` at local row slot
    ``lslot`` (the reference's dynamic_update_slice into zeros)."""
    z = torch.zeros_like(like)
    z[_blk(lslot, mb)] = blk
    return z


def _put_cols(like: torch.Tensor, blk: torch.Tensor, lslot: int,
              mb: int) -> torch.Tensor:
    z = torch.zeros_like(like)
    z[:, _blk(lslot, mb)] = blk
    return z


def _zero_unless(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _col_pick(desc: CyclicDesc, gcol: torch.Tensor, nloc: int,
              mloc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index table mapping my local COLUMN ids (global tile ``gcol`` per
    element) into a 'p'-axis all_gather of column slabs reshaped
    (P·mloc, ·): the herk/potrf row formation's cyclic pick, clamped as
    the reference's gather clamps; and which columns name a real row
    tile (< MT)."""
    d = desc.dist
    jt = gcol
    pj = (jt // d.kp + d.ip) % d.P
    lj = (jt // (d.kp * d.P)) * d.kp + jt % d.kp
    idx = (pj * mloc + lj * desc.mb
           + torch.arange(nloc, device=gcol.device) % desc.mb)
    return idx.clamp(0, d.P * mloc - 1), jt < desc.MT


def _row_pick(desc: CyclicDesc, gid: torch.Tensor, nloc_src: int):
    """Index table mapping my local ROW ids (global column coordinate
    ``gid`` per element) into a 'q'-axis all_gather of a row slab
    reshaped (mb, Q·nloc_src) (cyclic.py:1635-1647): the entry for
    global id g is q_owner(g)·nloc_src + local_col(g), clamped; and
    which rows name a real column tile (< NT)."""
    d = desc.dist
    t = gid // desc.nb
    qj = (t // d.kq + d.jq) % d.Q
    lj = (t // (d.kq * d.Q)) * d.kq + t % d.kq
    idx = qj * nloc_src + lj * desc.nb + gid % desc.nb
    return idx.clamp(0, d.Q * nloc_src - 1), t < desc.NT


def _gather_q_rows(vals: Dict[Tuple[int, int], torch.Tensor], P: int,
                   Q: int) -> Dict[int, torch.Tensor]:
    """all_gather along 'q' of (mb, nloc) row blocks, laid out (mb,
    Q·nloc) as the reference's ``transpose(1, 0, 2).reshape``: one
    tensor per process row."""
    out = {}
    for p in range(P):
        allr = _all_gather([vals[p, q] for q in range(Q)])
        out[p] = allr.transpose(0, 1).reshape(allr.shape[1], -1)
    return out


def _gather_p_cols(vals: Dict[Tuple[int, int], torch.Tensor], P: int,
                   Q: int) -> Dict[int, torch.Tensor]:
    """all_gather along 'p' of (mloc, w) column blocks, laid out
    (P·mloc, w): one tensor per process column."""
    out = {}
    for q in range(Q):
        allg = _all_gather([vals[p, q] for p in range(P)])
        out[q] = allg.reshape(-1, allg.shape[-1])
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _out(S: Dict[Tuple[int, int], torch.Tensor], d: Dist):
    return [[S[p, q] for q in range(d.Q)] for p in range(d.P)]


# ---------------------------------------------------------------------
# Distributed Cholesky (upper)
# ---------------------------------------------------------------------

def _potrf_cyclic_upper(A: CyclicMatrix) -> List[List[torch.Tensor]]:
    """The reference's ``_potrf_cyclic_upper_jit`` body
    (cyclic.py:2099-2170) in lockstep: A = U^H U, the lower sweep with
    the axes' roles mirrored — the row panel broadcast along 'p', the
    diagonal tile along 'q' (masked psums), the local row-panel solve,
    the owners' write-back, the column by all_gather along 'q' and a
    cyclic pick (clamped as the reference's gather clamps), and one
    local trailing product per rank. No ring and no lookahead, as in
    the reference."""
    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    KT = min(desc.MT, desc.NT)
    mloc = desc.MTL * mb
    nloc = desc.NTL * mb
    dev = A.device
    ranks = _ranks(d)
    S = {(p, q): A.data[p][q].clone() for p, q in ranks}
    grow = {p: _grow(desc.MTL, mb, p, P, d.kp, d.ip, dev) for p in range(P)}
    gcol = {q: _grow(desc.NTL, mb, q, Q, d.kq, d.jq, dev) for q in range(Q)}
    # column formation's pick: row tile it of my rows sits on rank qi at
    # local column li*mb + i % mb of the gathered row panels
    pick = {}
    for p in range(P):
        it = grow[p]
        qi = (it // d.kq + d.jq) % Q
        li = (it // (d.kq * Q)) * d.kq + it % d.kq
        pick[p] = (qi * nloc + li * mb + torch.arange(mloc, device=dev)
                   % mb).clamp(0, Q * nloc - 1)
    for k in range(KT):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        rk = _blk(layout.local_index(k, P, d.kp), mb)
        lck = layout.local_index(k, Q, d.kq)
        # 1) block row k along 'p'; 2) the diagonal tile along 'q'
        rs = {r: S[r][rk] for r in ranks}
        pan = _cols_p(rs, P, Q, partial(_masked_psum, root=pk))
        ddt = _rows_q({r: pan[r][:, _blk(lck, mb)] for r in ranks}, P, Q,
                      partial(_masked_psum, root=qk))
        Upan = {}
        for p, q in ranks:
            r = (p, q)
            Ukk = kb.potrf(ddt[r], lower=False)
            # 3) local row-panel solve (columns strictly right of k)
            sol = kb.trsm(Ukk, pan[r], side="L", lower=False, trans="C")
            right = (gcol[q] > k)[None, :]
            up = _zero_unless(right, sol)
            if q == qk:
                diagcol = (gcol[q] == k)[None, :]
                up = torch.where(diagcol, _put_cols(pan[r], Ukk, lck, mb),
                                 up)
            Upan[r] = up
            # 4) owners write the factored row panel back
            if p == pk:
                S[r][rk] = torch.where((gcol[q] >= k)[None, :], up, rs[r])
        # 5) column formation: all_gather along 'q' + cyclic pick
        flat = _gather_q_rows(Upan, P, Q)
        for p, q in ranks:
            r = (p, q)
            # W[i, t] = U[k*mb+t, gid_i]; trailing A_ij -= conj(W_i) U_j
            W = _zero_unless((grow[p] > k)[:, None], flat[p][:, pick[p]].T)
            Uright = _zero_unless((gcol[q] > k)[None, :], Upan[r])
            S[r] = S[r] - kb.dot(W, Uright, conj_a=True)
    return _out(S, d)


# ---------------------------------------------------------------------
# Distributed triangular solves, POTRS, the slab row gather and GETRS
# ---------------------------------------------------------------------

def _trsm_cyclic(A: CyclicMatrix, B: CyclicMatrix, uplo: str, trans: str,
                 unit: bool) -> List[List[torch.Tensor]]:
    """The reference's ``_trsm_cyclic_jit`` body (cyclic.py:1387-1473)
    in lockstep: op(T) X = B for T the named stored triangle, every
    (uplo, trans). Per step the block column of T along 'q' and its
    diagonal tile along 'p' (masked psums), for trans T/C the partial
    sums of the solved rows along 'p' (psum), the owner's tile solve
    handed to its process column (psum), and for trans N one local
    product per rank."""
    lower = uplo == "L"
    desc, bdesc = A.desc, B.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    KT = min(desc.MT, desc.NT)
    dev = A.device
    ranks = _ranks(d)
    # op(T) is lower (forward substitution) for (L, N) and (U, T/C)
    forward = lower == (trans == "N")
    X = {(p, q): B.data[p][q] for p, q in ranks}
    grow = {p: _grow(desc.MTL, mb, p, P, d.kp, d.ip, dev) for p in range(P)}
    for k in (range(KT) if forward else range(KT - 1, -1, -1)):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        rk = _blk(layout.local_index(k, P, d.kp), mb)
        ck = _blk(layout.local_index(k, Q, d.kq), mb)
        pan = _rows_q({(p, q): A.data[p][q][:, ck] for p, q in ranks}, P, Q,
                      partial(_masked_psum, root=qk))
        Tkk = _cols_p({r: pan[r][rk] for r in ranks}, P, Q,
                      partial(_masked_psum, root=pk))
        Tb, rhs = {}, {}
        for p, q in ranks:
            # off-diagonal rows of the panel that couple with X_k
            off = (grow[p] > k) if lower else (grow[p] < k)
            Tb[p, q] = _zero_unless(off[:, None], pan[p, q])
        if trans != "N":
            # X_k = op(T)_kk^-1 (B_k - sum_i op(T)_ik X_i): the partial
            # sums ride one psum along 'p'; the coupling blocks follow the
            # solve's op (plain transpose for T, conjugate for C)
            part = {r: kb.dot(Tb[r], X[r], ta=True,
                              conj_a=(trans == "C" and X[r].is_complex()))
                    for r in ranks}
            s = _cols_p(part, P, Q, _psum)
        xk = {}
        for p, q in ranks:
            r = (p, q)
            bk = X[r][rk]
            rh = bk if trans == "N" else bk - s[r]
            Tk = Tkk[r] if lower else torch.triu(Tkk[r])
            xk[r] = kb.trsm(Tk, rh if p == pk else torch.zeros_like(rh),
                            side="L", lower=lower, trans=trans, unit=unit)
        xk = _cols_p(xk, P, Q, _psum)
        for p, q in ranks:
            r = (p, q)
            if p == pk:
                X[r] = X[r].clone()
                X[r][rk] = xk[r]
            if trans == "N":
                # B_off -= T_ik X_k (one local product per rank)
                X[r] = X[r] - kb.dot(Tb[r], xk[r])
    return _out(X, d)


def trsm_cyclic(A: CyclicMatrix, B: CyclicMatrix, trans: str = "N",
                unit: bool = False, uplo: str = "L") -> CyclicMatrix:
    """Distributed op(T) X = B on block-cyclic local storage (left side;
    every (uplo, trans) corner, with ``unit``; ref src/ztrsm_LLN.jdf).
    A and B share the grid and row tiling; B keeps its column
    blocking."""
    _mesh_of(A)
    _check(A.desc.dist == B.desc.dist and A.desc.mb == B.desc.mb
           and A.desc.M == B.desc.M, "trsm_cyclic: mismatched descs")
    u, t = uplo.upper(), trans.upper()
    _check(u in ("L", "U"), f"uplo must be L or U, got {uplo!r}")
    _check(t in ("N", "T", "C"), f"trans must be N, T or C, got {trans!r}")
    return CyclicMatrix(_trsm_cyclic(A, B, u, t, unit), B.desc)


def potrs_cyclic(L: CyclicMatrix, B: CyclicMatrix,
                 uplo: str = "L") -> CyclicMatrix:
    """Solve A X = B from the distributed Cholesky factor without leaving
    the slabs (the pdpotrs / zpotrs_wrapper.c composition of two
    distributed TRSMs). ``uplo`` names the factor's storage: A = L L^H
    (L) or A = U^H U (U)."""
    u = uplo.upper()
    _check(u in ("L", "U"), f"uplo must be L or U, got {uplo!r}")
    if u == "U":
        return trsm_cyclic(L, trsm_cyclic(L, B, "C", uplo="U"), "N",
                           uplo="U")
    return trsm_cyclic(L, trsm_cyclic(L, B, "N"), "C")


def laswp_cyclic(A: CyclicMatrix, perm) -> CyclicMatrix:
    """Apply a global row permutation to cyclic slabs: out global row r =
    in global row perm[r] (cyclic.py:2036-2082). One all_gather along
    'p' of the column slabs and a cyclic pick per rank — never the
    natural-order global array."""
    _mesh_of(A)
    desc = A.desc
    d = desc.dist
    P = d.P
    mb = desc.mb
    mloc = desc.MTL * mb
    dev = A.device
    if not isinstance(perm, torch.Tensor):
        perm = torch.from_numpy(np.array(perm, dtype=np.int64))
    pm = perm.to(dev).reshape(-1).long()
    Mp = pm.shape[0]
    allg = _gather_p_cols({(p, q): A.data[p][q] for p, q in _ranks(d)},
                          P, d.Q)
    out = []
    for p in range(P):
        gid = (_grow(desc.MTL, mb, p, P, d.kp, d.ip, dev) * mb
               + torch.arange(mloc, device=dev) % mb)
        src = pm[gid.clamp(0, Mp - 1)]               # global source row
        t = src // mb
        ps = (t // d.kp + d.ip) % P
        ls = (t // (d.kp * P)) * d.kp + t % d.kp
        idx = ps * mloc + ls * mb + src % mb
        keep = (gid < Mp)[:, None]
        out.append([torch.where(keep, allg[q][idx], A.data[p][q])
                    for q in range(d.Q)])
    return CyclicMatrix(out, desc)


def getrs_cyclic(LU: CyclicMatrix, perm, B: CyclicMatrix) -> CyclicMatrix:
    """Solve A X = B from :func:`getrf_cyclic`'s output without leaving
    the slabs (pdgetrs): the factor rows live at their original positions
    with the elimination order in ``perm``, so one distributed row gather
    puts the factor and B in elimination order, then the unit-lower and
    upper TRSM sweeps run on the slabs."""
    Lp = laswp_cyclic(LU, perm)
    Bp = laswp_cyclic(B, perm)
    Y = trsm_cyclic(Lp, Bp, "N", unit=True)
    return trsm_cyclic(Lp, Y, "N", uplo="U")


# ---------------------------------------------------------------------
# SUMMA and the Level-3 BLAS over slabs
# ---------------------------------------------------------------------

def gemm_cyclic(A: CyclicMatrix, B: CyclicMatrix) -> CyclicMatrix:
    """Distributed C = A @ B on block-cyclic local storage: the SUMMA
    loop over slabs (cyclic.py:1503-1558; ref src/zsumma_NN.jdf) — per
    contraction tile one masked-psum broadcast of A's block column along
    'q', one of B's block row along 'p', one local product per rank. A's
    column tiling must match B's row tiling."""
    _mesh_of(A)
    ad, bd = A.desc, B.desc
    _check(ad.dist == bd.dist and ad.nb == bd.mb and ad.N == bd.M,
           "gemm_cyclic: mismatched descs")
    d = ad.dist
    P, Q = d.P, d.Q
    ranks = _ranks(d)
    C = {r: A.data[r[0]][r[1]].new_zeros(
        (ad.MTL * ad.mb, bd.NTL * bd.nb)) for r in ranks}
    for k in range(ad.NT):
        qk = layout.owner(k, Q, d.kq, d.jq)
        pk = layout.owner(k, P, d.kp, d.ip)
        ac = _blk(layout.local_index(k, Q, d.kq), ad.nb)
        br = _blk(layout.local_index(k, P, d.kp), bd.mb)
        acol = _rows_q({(p, q): A.data[p][q][:, ac] for p, q in ranks},
                       P, Q, partial(_masked_psum, root=qk))
        brow = _cols_p({(p, q): B.data[p][q][br] for p, q in ranks},
                       P, Q, partial(_masked_psum, root=pk))
        for r in ranks:
            C[r] = C[r] + kb.dot(acol[r], brow[r])
    return CyclicMatrix(_out(C, d), CyclicDesc(ad.M, bd.N, ad.mb, bd.nb,
                                               d))


def _stored_triangle(C: Dict[Tuple[int, int], torch.Tensor],
                     desc: CyclicDesc, cdesc: CyclicDesc,
                     lower: bool = True):
    """Keep the stored triangle of each rank's C slab (element ids of
    ``desc``'s rows against ``cdesc``'s columns)."""
    d = desc.dist
    out = {}
    for p, q in C:
        dev = C[p, q].device
        _, _, gid, _ = _slab_coords(desc, p, q, dev)
        _, _, _, gcid = _slab_coords(cdesc, p, q, dev)
        keep = (gid[:, None] >= gcid[None, :]) if lower else \
            (gid[:, None] <= gcid[None, :])
        out[p, q] = _zero_unless(keep, C[p, q])
    return _out(out, d)


def herk_cyclic(A: CyclicMatrix) -> CyclicMatrix:
    """Distributed C = A A^H (lower stored, M×M) on block-cyclic local
    storage (cyclic.py:1561-1632; ref src/zherk_LN.jdf): the POTRF
    trailing-update collectives as a standalone rank-k sweep — per
    column tile the block column along 'q' (masked psum), the row
    formation by all_gather along 'p' and a cyclic pick, one local
    product per rank. A may be rectangular: C's columns follow the M×M
    descriptor."""
    _mesh_of(A)
    desc = A.desc
    _check(desc.mb == desc.nb, "herk_cyclic needs square tiles")
    d = desc.dist
    P, Q = d.P, d.Q
    mloc = desc.MTL * desc.mb
    cdesc = CyclicDesc(desc.M, desc.M, desc.mb, desc.mb, d)
    ncloc = cdesc.NTL * cdesc.nb
    dev = A.device
    ranks = _ranks(d)
    pick = {q: _col_pick(desc, _grow(cdesc.NTL, cdesc.nb, q, Q, d.kq, d.jq,
                                     dev), ncloc, mloc) for q in range(Q)}
    C = {r: A.data[r[0]][r[1]].new_zeros((mloc, ncloc)) for r in ranks}
    for k in range(desc.NT):
        qk = layout.owner(k, Q, d.kq, d.jq)
        ck = _blk(layout.local_index(k, Q, d.kq), desc.nb)
        acol = _rows_q({(p, q): A.data[p][q][:, ck] for p, q in ranks},
                       P, Q, partial(_masked_psum, root=qk))
        allg = _gather_p_cols(acol, P, Q)
        for p, q in ranks:
            idx, valid = pick[q]
            W = _zero_unless(valid[:, None], allg[q][idx])   # (ncloc, nb)
            C[p, q] = C[p, q] + kb.dot(acol[p, q], W, tb=True, conj_b=True)
    return CyclicMatrix(_stored_triangle(C, desc, cdesc), cdesc)


def _tri_keep(gid: torch.Tensor, ke: torch.Tensor, x: torch.Tensor,
              strict, unit: bool) -> torch.Tensor:
    """The reference's triangle mask of a (rows, mb) operand against
    block-k element ids ``ke``: keep where ``strict`` holds, the
    diagonal as-is (or 1 when ``unit``), zeros elsewhere."""
    dg = gid[:, None] == ke[None, :]
    diag = torch.ones((), dtype=x.dtype, device=x.device) if unit else x
    return torch.where(strict, x, torch.where(
        dg, diag, torch.zeros((), dtype=x.dtype, device=x.device)))


def trmm_cyclic(A: CyclicMatrix, B: CyclicMatrix, trans: str = "N",
                unit: bool = False, uplo: str = "L") -> CyclicMatrix:
    """Distributed B <- op(T) B on block-cyclic local storage (left side;
    cyclic.py:1650-1757, ref src/ztrmm_LLN.jdf family). trans=N is the
    SUMMA loop with T's block column element-masked to its triangle;
    trans=C (and T, for real data) forms the lhs conj(T(k, r)) from T's
    block row along 'p', gathered along 'q' and picked by column
    coordinate."""
    _mesh_of(A)
    desc, bdesc = A.desc, B.desc
    _check(desc.dist == bdesc.dist and desc.mb == bdesc.mb
           and desc.M == bdesc.M, "trmm_cyclic: mismatched descs")
    _check(desc.mb == desc.nb, "trmm_cyclic needs square tiles")
    t = trans.upper()
    lower = uplo.upper() == "L"
    _check(uplo.upper() in ("L", "U"), f"uplo must be L or U, got {uplo!r}")
    # 'T' aliases 'C' only for real data: the non-N branch conjugates
    _check(t in ("N", "C") or (t == "T" and not A.dtype.is_complex),
           "trmm_cyclic: complex plain-transpose not implemented")
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    KT = min(desc.MT, desc.NT)
    nloc = desc.NTL * mb
    dev = A.device
    ranks = _ranks(d)
    gid = {p: _slab_coords(desc, p, 0, dev)[2] for p in range(P)}
    rpick = {p: _row_pick(desc, gid[p], nloc) for p in range(P)}
    C = {r: B.data[r[0]][r[1]].new_zeros(B.data[r[0]][r[1]].shape)
         for r in ranks}
    for k in range(KT):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        rk = _blk(layout.local_index(k, P, d.kp), mb)
        ck = _blk(layout.local_index(k, Q, d.kq), mb)
        ke = k * mb + torch.arange(mb, device=dev)
        # B block row k -> everyone in the column ('p' broadcast)
        brow = _cols_p({(p, q): B.data[p][q][rk] for p, q in ranks}, P, Q,
                       partial(_masked_psum, root=pk))
        if t == "N":
            # T's block column k ('q' broadcast), element-masked
            acol = _rows_q({(p, q): A.data[p][q][:, ck] for p, q in ranks},
                           P, Q, partial(_masked_psum, root=qk))
            for p, q in ranks:
                g = gid[p]
                keep = (g[:, None] > ke[None, :]) if lower else \
                    (g[:, None] < ke[None, :])
                lhs = _tri_keep(g, ke, acol[p, q], keep, unit)
                C[p, q] = C[p, q] + kb.dot(lhs, brow[p, q])
        else:
            # lhs = conj(T(k, gid_r)): T's row slab k ('p' broadcast),
            # gathered along 'q', column-coordinate pick
            rowk = _cols_p({(p, q): A.data[p][q][rk] for p, q in ranks},
                           P, Q, partial(_masked_psum, root=pk))
            flat = _gather_q_rows(rowk, P, Q)
            for p, q in ranks:
                g = gid[p]
                idx, valid = rpick[p]
                Wl = _zero_unless(valid[:, None], _cj(flat[p][:, idx].T))
                # Wl[r, t] = conj(T(ke_t, gid_r)): lower T has T(ke, r)
                # nonzero for ke >= r, upper for ke <= r
                keep = (g[:, None] < ke[None, :]) if lower else \
                    (g[:, None] > ke[None, :])
                lhs = _tri_keep(g, ke, Wl, keep, unit)
                C[p, q] = C[p, q] + kb.dot(lhs, brow[p, q])
    return CyclicMatrix(_out(C, d), bdesc)


def hemm_cyclic(A: CyclicMatrix, B: CyclicMatrix) -> CyclicMatrix:
    """Distributed C = A B with A Hermitian stored lower (left side;
    cyclic.py:1760-1836, ref src/zhemm.jdf): per step the stored block
    column serves rows >= k directly and rows < k through its
    conjugate-transposed row strip (the 'q' gather + column-coordinate
    pick); one local product per rank."""
    _mesh_of(A)
    desc, bdesc = A.desc, B.desc
    _check(desc.dist == bdesc.dist and desc.mb == bdesc.mb
           and desc.M == bdesc.M and desc.M == desc.N,
           "hemm_cyclic: mismatched descs")
    _check(desc.mb == desc.nb, "hemm_cyclic needs square tiles")
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    nloc = desc.NTL * mb
    dev = A.device
    ranks = _ranks(d)
    gid = {p: _slab_coords(desc, p, 0, dev)[2] for p in range(P)}
    rpick = {p: _row_pick(desc, gid[p], nloc) for p in range(P)}
    C = {r: B.data[r[0]][r[1]].new_zeros(B.data[r[0]][r[1]].shape)
         for r in ranks}
    for k in range(desc.MT):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        rk = _blk(layout.local_index(k, P, d.kp), mb)
        ck = _blk(layout.local_index(k, Q, d.kq), mb)
        ke = k * mb + torch.arange(mb, device=dev)
        brow = _cols_p({(p, q): B.data[p][q][rk] for p, q in ranks}, P, Q,
                       partial(_masked_psum, root=pk))
        # the stored lower column block k: rows >= k (diagonal included)
        acol = _rows_q({(p, q): A.data[p][q][:, ck] for p, q in ranks},
                       P, Q, partial(_masked_psum, root=qk))
        # rows < k: A(r, ke) = conj(A_stored(ke, r)) — row slab k
        # gathered along 'q', picked at my rows' global columns
        rowk = _cols_p({(p, q): A.data[p][q][rk] for p, q in ranks}, P, Q,
                       partial(_masked_psum, root=pk))
        flat = _gather_q_rows(rowk, P, Q)
        for p, q in ranks:
            g = gid[p]
            idx, valid = rpick[p]
            lo = _zero_unless(g[:, None] >= ke[None, :], acol[p, q])
            Wl = _zero_unless(valid[:, None], _cj(flat[p][:, idx].T))
            Wl = _zero_unless(g[:, None] < ke[None, :], Wl)
            C[p, q] = C[p, q] + kb.dot(lo + Wl, brow[p, q])
    return CyclicMatrix(_out(C, d), bdesc)


def her2k_cyclic(A: CyclicMatrix, B: CyclicMatrix) -> CyclicMatrix:
    """Distributed C = A B^H + B A^H (lower stored, M×M) on block-cyclic
    local storage (cyclic.py:1839-1914, ref src/zher2k_LN.jdf): the
    herk_cyclic collectives doubled — per column tile one 'q' broadcast
    and one 'p'-gather row formation of each operand, two local products
    per rank."""
    _mesh_of(A)
    desc = A.desc
    _check(desc.dist == B.desc.dist and desc.mb == B.desc.mb
           and desc.M == B.desc.M and desc.N == B.desc.N,
           "her2k_cyclic: mismatched descs")
    _check(desc.mb == desc.nb, "her2k_cyclic needs square tiles")
    d = desc.dist
    P, Q = d.P, d.Q
    mloc = desc.MTL * desc.mb
    cdesc = CyclicDesc(desc.M, desc.M, desc.mb, desc.mb, d)
    ncloc = cdesc.NTL * cdesc.nb
    dev = A.device
    ranks = _ranks(d)
    pick = {q: _col_pick(desc, _grow(cdesc.NTL, cdesc.nb, q, Q, d.kq, d.jq,
                                     dev), ncloc, mloc) for q in range(Q)}
    C = {r: A.data[r[0]][r[1]].new_zeros((mloc, ncloc)) for r in ranks}
    for k in range(desc.NT):
        qk = layout.owner(k, Q, d.kq, d.jq)
        ck = _blk(layout.local_index(k, Q, d.kq), desc.nb)

        def colof(X):
            c = _rows_q({(p, q): X.data[p][q][:, ck] for p, q in ranks},
                        P, Q, partial(_masked_psum, root=qk))
            allg = _gather_p_cols(c, P, Q)
            W = {}
            for p, q in ranks:
                idx, valid = pick[q]
                W[p, q] = _zero_unless(valid[:, None], allg[q][idx])
            return c, W
        acol, Wa = colof(A)
        bcol, Wb = colof(B)
        for r in ranks:
            C[r] = (C[r] + kb.dot(acol[r], Wb[r], tb=True, conj_b=True)
                    + kb.dot(bcol[r], Wa[r], tb=True, conj_b=True))
    return CyclicMatrix(_stored_triangle(C, desc, cdesc), cdesc)


# ---------------------------------------------------------------------
# The inverses: LAUUM, TRTRI, POTRI
# ---------------------------------------------------------------------

def lauum_cyclic(A: CyclicMatrix) -> CyclicMatrix:
    """Distributed L^H L (lower stored) on block-cyclic local storage
    (cyclic.py:1917-1975, ref src/zlauum_L.jdf): a Gram sweep over row
    blocks — the lhs conj(L(k, r)) by the 'q' gather pick, the rhs the
    row slab broadcast along 'p', one local product per rank."""
    _mesh_of(A)
    desc = A.desc
    _check(desc.mb == desc.nb and desc.M == desc.N,
           "lauum_cyclic needs a square matrix of square tiles")
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    nloc = desc.NTL * mb
    dev = A.device
    ranks = _ranks(d)
    gid = {p: _slab_coords(desc, p, 0, dev)[2] for p in range(P)}
    gcid = {q: _slab_coords(desc, 0, q, dev)[3] for q in range(Q)}
    rpick = {p: _row_pick(desc, gid[p], nloc) for p in range(P)}
    C = {r: A.data[r[0]][r[1]].new_zeros(A.data[r[0]][r[1]].shape)
         for r in ranks}
    for k in range(desc.MT):
        pk = layout.owner(k, P, d.kp, d.ip)
        rk = _blk(layout.local_index(k, P, d.kp), mb)
        ke = k * mb + torch.arange(mb, device=dev)
        rowk = _cols_p({(p, q): A.data[p][q][rk] for p, q in ranks}, P, Q,
                       partial(_masked_psum, root=pk))
        # stored lower: row k holds columns <= k
        rowk = {(p, q): _zero_unless(ke[:, None] >= gcid[q][None, :],
                                     rowk[p, q]) for p, q in ranks}
        flat = _gather_q_rows(rowk, P, Q)
        for p, q in ranks:
            idx, valid = rpick[p]
            Wl = _zero_unless(valid[:, None], _cj(flat[p][:, idx].T))
            Wl = _zero_unless(ke[None, :] >= gid[p][:, None], Wl)
            C[p, q] = C[p, q] + kb.dot(Wl, rowk[p, q])
    return CyclicMatrix(_stored_triangle(C, desc, desc), desc)


def _identity_cyclic(A: CyclicMatrix) -> CyclicMatrix:
    """The identity on A's slabs (cyclic.py:1978-1993): ones where the
    global row and column ids meet below min(M, N)."""
    desc = A.desc
    K = min(desc.M, desc.N)
    out = {}
    for p, q in _ranks(desc.dist):
        _, _, gid, gcid = _slab_coords(desc, p, q, A.device)
        eye = (gid[:, None] == gcid[None, :]) & (gid < K)[:, None]
        out[p, q] = eye.to(A.dtype)
    return CyclicMatrix(_out(out, desc.dist), desc)


def _tri_mask_cyclic(A: CyclicMatrix, lower: bool) -> CyclicMatrix:
    """The named triangle of A's slabs, zeros elsewhere
    (cyclic.py:1996-2010)."""
    S = {(p, q): A.data[p][q] for p, q in _ranks(A.desc.dist)}
    return CyclicMatrix(_stored_triangle(S, A.desc, A.desc, lower), A.desc)


def trtri_cyclic(A: CyclicMatrix, unit: bool = False,
                 uplo: str = "L") -> CyclicMatrix:
    """Distributed triangular inverse on block-cyclic local storage
    (cyclic.py:2013-2026, ref src/ztrtri_L.jdf): the solve-shaped sweep
    op(T) X = I over the trsm_cyclic collectives, masked to the
    triangle."""
    _mesh_of(A)
    eye = _identity_cyclic(A)
    X = trsm_cyclic(A, eye, "N", unit=unit, uplo=uplo.upper())
    return _tri_mask_cyclic(X, uplo.upper() == "L")


def potri_cyclic(L: CyclicMatrix) -> CyclicMatrix:
    """Distributed POTRI from the cyclic Cholesky factor: A^-1 =
    L^-H L^-1 = lauum(trtri(L)) without leaving the slabs (ref
    src/zpotri_wrapper.c composing ztrtri + zlauum)."""
    return lauum_cyclic(trtri_cyclic(L))


# ---------------------------------------------------------------------
# Distributed QR: CholeskyQR2 + TSQR-HR panels
# ---------------------------------------------------------------------

def _cqr2_panel(xs: List[torch.Tensor], M: int, mb: int, eps: float,
                pdiag: int, ldiag: int):
    """The reference's ``_cqr2_panel`` (cyclic.py:704-744) over one axis
    group: ``xs`` are the masked local panel rows of the group's ranks in
    axis order (the QR, herbt and ge2gb sweeps pass a process column's
    ranks, the ge2gb LQ half a process row's); ``pdiag``/``ldiag`` the
    owner rank and local tile slot of the diagonal tile along that axis.
    CholeskyQR2 with the shift 11·(M·mb + mb(mb+1))·eps·trace(G) on the
    first pass, then TSQR-HR (``householder_reconstruct``). The Gram's
    factor, R, the top block and its reconstruction come from one psum's
    result, so they are computed once for the group.

    Returns (packedtop, V1, T, Ub, q2 per rank)."""
    from dplasma_tpu_torch.kernels import householder as hh

    x0 = xs[0]
    eye = torch.eye(mb, dtype=x0.dtype, device=x0.device)

    def cqr(xx, shift):
        g = _psum([kb.dot(x, x, ta=True, conj_a=True)
                   for x in xx])[0]
        if shift:
            sft = 11.0 * (M * mb + mb * (mb + 1)) * eps
            g = g + (sft * torch.trace(g).real) * eye
        ell = kb.potrf(g, lower=True)
        return [kb.trsm(ell, x, side="R", lower=True, trans="C")
                for x in xx], ell

    q1, l1 = cqr(xs, True)
    q2, l2 = cqr(q1, False)
    R = _ct(kb.dot(l1, l2))               # R2 R1
    topq = _masked_psum([q[_blk(ldiag, mb)] for q in q2], pdiag)[0]
    packedtop, V1, T, Ub = hh.householder_reconstruct(topq, R,
                                                      return_u=True)
    return packedtop, V1, T, Ub, q2


def _geqrf_cyclic(A: CyclicMatrix, lookahead: int = 0, ring: bool = False,
                  rchunks: int = 0):
    """The reference's ``_geqrf_cyclic_jit`` body (cyclic.py:747-864) in
    lockstep — distributed blocked Householder QR over cyclic slabs: per
    step the panel broadcast along 'q' (K5 under ``ring``, else the
    masked psum; or the lookahead-carried pre-updated column), the
    CholeskyQR2 + TSQR-HR panel along 'p' for each process column, the
    local V (V1 on the diagonal owner, q2 Ub^-1 below), V^H C by psum
    along 'p' and one local compact-WY apply per rank. Pad columns are
    identity-seeded (zero pad panels break the Gram).

    Returns (factor slabs, Ts (KT, mb, mb), rank (0, 0)'s)."""
    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    KT = min(desc.MT, desc.NT)
    dev = A.device
    ranks = _ranks(d)
    eps = float(torch.finfo(A.dtype).eps)
    co = {r: _slab_coords(desc, r[0], r[1], dev) for r in ranks}
    S = {r: _seed_pad_diag(A.data[r[0]][r[1]], desc, co[r][2], co[r][3])
         for r in ranks}
    Ts = []
    pan_next = None
    for k in range(KT):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        lrk = layout.local_index(k, P, d.kp)
        ck = _blk(layout.local_index(k, Q, d.kq), mb)
        cs = {r: S[r][:, ck] for r in ranks}
        pan = pan_next if pan_next is not None else _rows_q(
            cs, P, Q, partial(_bcast_q, qk=qk, ring=ring, rchunks=rchunks))
        x = {r: _zero_unless((co[r][2] >= k * mb)[:, None], pan[r])
             for r in ranks}
        grp = {q: _cqr2_panel([x[p, q] for p in range(P)], desc.M, mb, eps,
                              pk, lrk) for q in range(Q)}
        Ts.append(grp[0][2])
        V, Wp = {}, {}
        for p, q in ranks:
            r = (p, q)
            _, V1, T, Ub, q2 = grp[q]
            below = (co[r][2] >= (k + 1) * mb)[:, None]
            V2 = kb.trsm(Ub, q2[p], side="R", lower=False)
            Vl = _zero_unless(below, V2)
            if p == pk:
                diagrow = (co[r][0] == k)[:, None]
                Vl = torch.where(diagrow, _put_rows(V2, V1, lrk, mb), Vl)
            V[r] = (Vl, V2)
            Wp[r] = kb.dot(Vl, S[r], ta=True, conj_a=True)
        # trailing + R12 update: C <- C - V (T^H (V^H C))
        W = _cols_p(Wp, P, Q, _psum)
        if lookahead > 0 and k + 1 < KT:
            qk1 = layout.owner(k + 1, Q, d.kq, d.jq)
            c1 = _blk(layout.local_index(k + 1, Q, d.kq), mb)
            nxt = {}
            for p, q in ranks:
                r = (p, q)
                T = grp[q][2]
                updn = kb.dot(V[r][0], kb.dot(T, W[r][:, c1], ta=True,
                                              conj_a=True))
                nxt[r] = S[r][:, c1] - updn
            pan_next = _rows_q(nxt, P, Q, partial(
                _bcast_q, qk=qk1, ring=ring, rchunks=rchunks))
        else:
            pan_next = None
        for p, q in ranks:
            r = (p, q)
            packedtop, _, T, _, _ = grp[q]
            Vl, V2 = V[r]
            upd = kb.dot(Vl, kb.dot(T, W[r], ta=True, conj_a=True))
            trail = (co[r][3] >= (k + 1) * mb)[None, :]
            S[r] = S[r] - _zero_unless(trail, upd)
            # owners write the packed panel column
            if q == qk:
                below = (co[r][2] >= (k + 1) * mb)[:, None]
                newcs = cs[r]
                if p == pk:
                    diagrow = (co[r][0] == k)[:, None]
                    newcs = torch.where(
                        diagrow, _put_rows(newcs, packedtop, lrk, mb), newcs)
                S[r][:, ck] = torch.where(below, V2, newcs)
    return _out(S, d), torch.stack(Ts)


def geqrf_cyclic(A: CyclicMatrix):
    """Distributed blocked QR on block-cyclic local storage (the pdgeqrf
    / zgeqrf_param shape; cyclic.py:1262-1277). Returns (factor
    CyclicMatrix in the ops.qr packed layout, Ts (KT, mb, mb) T-factor
    stack — :func:`qr_t_factor` converts it to the ops.qr T
    TileMatrix)."""
    m = _mesh_of(A)
    _check(A.desc.mb == A.desc.nb, "geqrf_cyclic needs square tiles")
    ring = _cyclic_ring(A.desc, A.dtype, m)
    rch = _ring_chunks(ring)
    _ring_span(A, ring, rch)
    out, Ts = _geqrf_cyclic(A, _cyclic_lookahead(), ring, rch)
    return CyclicMatrix(out, A.desc), Ts


def qr_t_factor(Ts, A: TileMatrix) -> TileMatrix:
    """Convert a geqrf_cyclic T-factor stack (KT, mb, mb) into the ops.qr
    T TileMatrix (unmqr/ormqr-ready), padded to the T descriptor of
    ``A`` (cyclic.py:1250-1259)."""
    from dplasma_tpu_torch.ops import qr as qr_mod
    Td = torch.cat([Ts[i] for i in range(Ts.shape[0])], dim=1)
    Tm = qr_mod.t_desc(A)
    if Td.shape[1] < Tm.desc.Np:
        Td = torch.cat([Td, Td.new_zeros((Td.shape[0],
                                          Tm.desc.Np - Td.shape[1]))], dim=1)
    return TileMatrix(Td.to(Tm.device), Tm.desc)


# ---------------------------------------------------------------------
# Eigen and SVD stage 1 on the slabs
# ---------------------------------------------------------------------

def _herbt_cyclic(A: CyclicMatrix) -> List[List[torch.Tensor]]:
    """The reference's ``_herbt_cyclic_jit`` body (cyclic.py:867-991) in
    lockstep: panel k QR-factors block column k below the first
    subdiagonal tile by the distributed CholeskyQR2 + TSQR-HR panel,
    then applies the two-sided compact-WY update A <- Q^H A Q with four
    collectives: S = psum_p(V^H A); Vc by all_gather along 'p' and the
    cyclic pick; Y = psum_q(A Vc), Z = psum_q(P1 Vc); A -= V (T^H S) +
    mask((Y - V Z) T) Vc^H. Leaves the bandwidth-mb band, both
    triangles."""
    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    mloc = desc.MTL * mb
    nloc = desc.NTL * mb
    dev = A.device
    ranks = _ranks(d)
    eps = float(torch.finfo(A.dtype).eps)
    co = {r: _slab_coords(desc, r[0], r[1], dev) for r in ranks}
    S = {r: _seed_pad_diag(A.data[r[0]][r[1]], desc, co[r][2], co[r][3])
         for r in ranks}
    # column-space pick tables; unused ceil-uniform slots (gcol >= MT)
    # pick zero, as in the reference
    pick = {q: _col_pick(desc, co[0, q][1], nloc, mloc) for q in range(Q)}
    for k in range(desc.MT - 1):
        qk = layout.owner(k, Q, d.kq, d.jq)
        lck = layout.local_index(k, Q, d.kq)
        pk = layout.owner(k, P, d.kp, d.ip)
        lrk = layout.local_index(k, P, d.kp)
        pk1 = layout.owner(k + 1, P, d.kp, d.ip)
        lrk1 = layout.local_index(k + 1, P, d.kp)
        qk1 = layout.owner(k + 1, Q, d.kq, d.jq)
        lck1 = layout.local_index(k + 1, Q, d.kq)
        e = (k + 1) * mb
        # 1) panel broadcast along 'q', masked below the band
        cs = {r: S[r][:, _blk(lck, mb)] for r in ranks}
        pan = _rows_q(cs, P, Q, partial(_masked_psum, root=qk))
        x = {r: _zero_unless((co[r][2] >= e)[:, None], pan[r])
             for r in ranks}
        # 2) distributed CholeskyQR2 + TSQR-HR (diagonal tile k+1); the
        # applied Q gives the sign-adjusted R of the reconstruction
        grp = {q: _cqr2_panel([x[p, q] for p in range(P)], desc.M, mb, eps,
                              pk1, lrk1) for q in range(Q)}
        Vloc, Sp = {}, {}
        for p, q in ranks:
            r = (p, q)
            _, V1, T, Ub, q2 = grp[q]
            strict = (co[r][2] >= e + mb)[:, None]
            V2 = kb.trsm(Ub, q2[p], side="R", lower=False)
            Vl = _zero_unless(strict, V2)
            if p == pk1:
                diagrow1 = (co[r][0] == k + 1)[:, None]
                Vl = torch.where(diagrow1, _put_rows(V2, V1, lrk1, mb), Vl)
            Vloc[r] = Vl
            Sp[r] = kb.dot(Vl, S[r], ta=True, conj_a=True)
        # 3) the two-sided update
        Sm = _cols_p(Sp, P, Q, _psum)                     # (mb, nloc)
        P1 = {r: kb.dot(grp[r[1]][2], Sm[r], ta=True, conj_a=True)
              for r in ranks}
        allv = _gather_p_cols(Vloc, P, Q)
        Vc = {}
        for p, q in ranks:
            idx, valid = pick[q]
            Vc[p, q] = _zero_unless(valid[:, None], allv[q][idx])
        Y = _rows_q({r: kb.dot(S[r], Vc[r]) for r in ranks}, P, Q, _psum)
        Z = _rows_q({r: kb.dot(P1[r], Vc[r]) for r in ranks}, P, Q, _psum)
        for p, q in ranks:
            r = (p, q)
            T = grp[q][2]
            W2 = kb.dot(Y[r] - kb.dot(Vloc[r], Z[r]), T)
            W2 = _zero_unless((co[r][2] >= e)[:, None], W2)
            S[r] = (S[r] - kb.dot(Vloc[r], P1[r])
                    - kb.dot(W2, Vc[r], tb=True, conj_b=True))
        # 4) owners write the reduced panel column (R at tile k+1, zeros
        # below) and its mirror row strip
        for p, q in ranks:
            r = (p, q)
            Rw = torch.triu(grp[q][0])
            if q == qk:
                below = (co[r][2] >= e)[:, None]
                fill = torch.zeros_like(cs[r])
                if p == pk1:
                    diagrow1 = (co[r][0] == k + 1)[:, None]
                    fill = _zero_unless(diagrow1,
                                        _put_rows(cs[r], Rw, lrk1, mb))
                S[r][:, _blk(lck, mb)] = torch.where(below, fill, cs[r])
            if p == pk:
                rows = S[r][_blk(lrk, mb)]
                keep = (co[r][3] < e)[None, :]
                strip = _zero_unless(keep, rows)
                if q == qk1:
                    strip = torch.where(
                        ~keep, _put_cols(rows, _ct(Rw), lck1, mb), strip)
                S[r][_blk(lrk, mb)] = strip
    return _out(S, d)


def herbt_cyclic(A: CyclicMatrix) -> CyclicMatrix:
    """Distributed dense Hermitian -> band (bandwidth mb) reduction on
    block-cyclic local storage (dplasma_zherbt over
    parsec_matrix_block_cyclic; stage 1 of the zheev chain). ``A`` must
    store both triangles (full Hermitian slabs), with N % mb == 0: the
    last panel needs a full mb real rows below the band."""
    _mesh_of(A)
    desc = A.desc
    _check(desc.mb == desc.nb and desc.M == desc.N,
           "herbt_cyclic needs a square matrix of square tiles")
    _check(desc.M % desc.mb == 0, "herbt_cyclic: need N % mb == 0")
    return CyclicMatrix(_herbt_cyclic(A), desc)


def _band_extract_cyclic(B: CyclicMatrix) -> torch.Tensor:
    """Lower band (bandwidth mb) of a Hermitian cyclic matrix as per-row
    diagonal storage, out[global row i, d] = A(i, i-d), d = 0..mb
    (cyclic.py:1008-1060): one masked psum along 'q' (each rank
    contributes the band entries whose columns it owns) and an
    all_gather along 'p' — O(N·mb) moved, never the whole matrix."""
    desc = B.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    nloc = desc.NTL * mb
    dev = B.device
    ranks = _ranks(d)
    offs = torch.arange(mb + 1, device=dev)
    band = {}
    for p, q in ranks:
        _, _, gid, _ = _slab_coords(desc, p, q, dev)
        tgt = gid[:, None] - offs[None, :]              # (mloc, mb+1)
        t = tgt.clamp(0, desc.N - 1)
        ct_ = t // mb
        qj = (ct_ // d.kq + d.jq) % Q
        lj = (ct_ // (d.kq * Q)) * d.kq + ct_ % d.kq
        colpos = (lj * mb + t % mb).clamp(0, nloc - 1)
        mine = (qj == q) & (tgt >= 0)
        vals = torch.take_along_dim(B.data[p][q], colpos, dim=1)
        band[p, q] = _zero_unless(mine, vals)
    band = _rows_q(band, P, Q, _psum)
    # every rank holds the same gather; take rank (0, 0)'s and reorder
    # the cyclic row slots to natural order
    stacked = _gather_p_cols(band, P, Q)[0]              # (P*mloc, mb+1)
    own = np.array([layout.owner(i, P, d.kp, d.ip) for i in range(desc.MT)])
    locr = np.array([layout.local_index(i, P, d.kp)
                     for i in range(desc.MT)])
    idx = (own[:, None] * desc.MTL + locr[:, None]) * mb + \
        np.arange(mb)[None, :]
    return stacked[torch.as_tensor(idx.reshape(-1), device=dev)][:desc.M]


def _dense_band(band: torch.Tensor) -> torch.Tensor:
    """The dense Hermitian band matrix of per-row diagonal storage:
    B[i, i-d] = band[i, d] and its mirror, built by index tensors on
    band's device (the reference's loop of mb + 1 scatters in one)."""
    N, w = band.shape
    dev = band.device
    i = torch.arange(N, device=dev)[:, None].expand(N, w)
    j = i - torch.arange(w, device=dev)[None, :]
    ok = j >= 0
    dense = band.new_zeros((N, N))
    dense[i[ok], j[ok]] = band[ok]
    up = ok.clone()
    up[:, 0] = False
    dense[j[up], i[up]] = _cj(band[up])
    return dense


def heev_cyclic(A: CyclicMatrix) -> torch.Tensor:
    """Distributed Hermitian eigenvalues (the dplasma_zheev composition,
    ref src/zheev_wrapper.c:96-103; cyclic.py:1063-1094): herbt on the
    slabs, the band alone off the slabs, and the band's reduction
    (``ops.eig.hbrdt``: KW for the b <= 128 sweeps) and the tridiagonal
    eigenvalues (KT) on one device, as the reference ships its
    tridiagonal to rank 0. N % mb == 0. Returns ascending eigenvalues
    (N,)."""
    from dplasma_tpu_torch.kernels import tridiag
    from dplasma_tpu_torch.ops import eig as eig_mod

    B = herbt_cyclic(A)
    band = _band_extract_cyclic(B)
    mb = B.desc.mb
    Bt = TileMatrix.from_dense(_dense_band(band), mb, mb)
    d_, e_ = eig_mod.hbrdt(Bt, mb)
    if d_.shape[0] == 1:
        return d_
    return tridiag.eigh_tridiagonal(d_, e_)


def _ge2gb_cyclic(A: CyclicMatrix) -> List[List[torch.Tensor]]:
    """The reference's ``_ge2gb_cyclic_jit`` body (cyclic.py:1097-1225)
    in lockstep. Panel k alternates a QR half on column block k (rows >=
    k; the geqrf_cyclic step, CholeskyQR2 + TSQR-HR along 'p' per
    process column, trailing A <- Q^H A by psum_p(V^H A)) and an LQ half
    on row block k (columns >= k+1; the same panel algebra along 'q' per
    process row on the conjugate-transposed row strip, trailing A <- A H
    by psum_q(A V)). Leaves R_k on the diagonal tiles and ct(Rtilde) on
    the first superdiagonal tiles: a band with A's singular values, in
    complex too (where the reference's LQ update is conjugated)."""
    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    KT = desc.MT
    dev = A.device
    ranks = _ranks(d)
    eps = float(torch.finfo(A.dtype).eps)
    co = {r: _slab_coords(desc, r[0], r[1], dev) for r in ranks}
    S = {r: _seed_pad_diag(A.data[r[0]][r[1]], desc, co[r][2], co[r][3])
         for r in ranks}
    for k in range(KT):
        pk = layout.owner(k, P, d.kp, d.ip)
        qk = layout.owner(k, Q, d.kq, d.jq)
        lrk = layout.local_index(k, P, d.kp)
        lck = layout.local_index(k, Q, d.kq)
        e = k * mb
        # ---- QR half: column block k, rows >= k ----
        cs = {r: S[r][:, _blk(lck, mb)] for r in ranks}
        pan = _rows_q(cs, P, Q, partial(_masked_psum, root=qk))
        x = {r: _zero_unless((co[r][2] >= e)[:, None], pan[r])
             for r in ranks}
        grp = {q: _cqr2_panel([x[p, q] for p in range(P)], desc.M, mb, eps,
                              pk, lrk) for q in range(Q)}
        Vloc, Sp = {}, {}
        for p, q in ranks:
            r = (p, q)
            _, V1, T, Ub, q2 = grp[q]
            V2 = kb.trsm(Ub, q2[p], side="R", lower=False)
            Vl = _zero_unless((co[r][2] >= e + mb)[:, None], V2)
            if p == pk:
                diagrow = (co[r][0] == k)[:, None]
                Vl = torch.where(diagrow, _put_rows(V2, V1, lrk, mb), Vl)
            Vloc[r] = Vl
            Sp[r] = kb.dot(Vl, S[r], ta=True, conj_a=True)
        Sm = _cols_p(Sp, P, Q, _psum)
        for p, q in ranks:
            r = (p, q)
            T = grp[q][2]
            upd = kb.dot(Vloc[r], kb.dot(T, Sm[r], ta=True, conj_a=True))
            trail = (co[r][3] >= e + mb)[None, :]
            S[r] = S[r] - _zero_unless(trail, upd)
            # column k: R on the diagonal tile, zeros below
            if q == qk:
                act = (co[r][2] >= e)[:, None]
                fill = torch.zeros_like(cs[r])
                if p == pk:
                    diagrow = (co[r][0] == k)[:, None]
                    fill = _zero_unless(diagrow, _put_rows(
                        cs[r], torch.triu(grp[q][0]), lrk, mb))
                S[r][:, _blk(lck, mb)] = torch.where(act, fill, cs[r])
        if k == KT - 1:
            break
        # ---- LQ half: row block k, columns >= k+1 ----
        qk1 = layout.owner(k + 1, Q, d.kq, d.jq)
        lck1 = layout.local_index(k + 1, Q, d.kq)
        strip = _cols_p({r: S[r][_blk(lrk, mb)] for r in ranks}, P, Q,
                        partial(_masked_psum, root=pk))
        xq = {r: _zero_unless((co[r][3] >= e + mb)[:, None],
                              _ct(strip[r])) for r in ranks}
        grq = {p: _cqr2_panel([xq[p, q] for q in range(Q)], desc.N, mb, eps,
                              qk1, lck1) for p in range(P)}
        Vq, Yp = {}, {}
        for p, q in ranks:
            r = (p, q)
            _, V1q, Tq, Ubq, q2q = grq[p]
            V2q = kb.trsm(Ubq, q2q[q], side="R", lower=False)
            Vl = _zero_unless((co[r][3] >= e + 2 * mb)[:, None], V2q)
            if q == qk1:
                diagcol = (co[r][1] == k + 1)[:, None]
                Vl = torch.where(diagcol, _put_rows(V2q, V1q, lck1, mb), Vl)
            Vq[r] = Vl
            Yp[r] = kb.dot(S[r], Vl)
        # trailing rows > k: A <- A H = A - (A Vq) Tq Vq^H, H = I - Vq Tq
        # Vq^H the reflector of the strip's conjugate transpose. The
        # reference applies conj(A Vq Tq Vq^H) there (cyclic.py:1198-1199):
        # the same operations on real data, the wrong band in complex
        Y = _rows_q(Yp, P, Q, _psum)
        for p, q in ranks:
            r = (p, q)
            Tq = grq[p][2]
            updr = kb.dot(kb.dot(Y[r], Tq), Vq[r], tb=True, conj_b=True)
            S[r] = S[r] - _zero_unless((co[r][2] >= e + mb)[:, None], updr)
            # row k: ct(Rtilde) on the superdiagonal tile (held by the
            # owner column of tile k+1 alone), zeros to its right
            if p == pk:
                rows = S[r][_blk(lrk, mb)]
                at_c1 = torch.zeros_like(rows)
                if q == qk1:
                    at_c1 = _put_cols(rows, _ct(torch.triu(grq[p][0])), lck1,
                                      mb)
                keepleft = (co[r][3] < e + mb)[None, :]
                S[r][_blk(lrk, mb)] = torch.where(keepleft, rows, at_c1)
    return _out(S, d)


def gebrd_ge2gb_cyclic(A: CyclicMatrix) -> CyclicMatrix:
    """Distributed dense -> band-bidiagonal reduction (SVD stage 1) on
    block-cyclic local storage (ref src/zgebrd_ge2gb.jdf). Square with
    N % mb == 0 (the LQ panels need full real blocks, as herbt)."""
    _mesh_of(A)
    desc = A.desc
    _check(desc.mb == desc.nb and desc.M == desc.N,
           "ge2gb_cyclic needs a square matrix of square tiles")
    _check(desc.M % desc.mb == 0, "ge2gb_cyclic: need N % mb == 0")
    return CyclicMatrix(_ge2gb_cyclic(A), desc)


def gesvd_cyclic(A: CyclicMatrix) -> torch.Tensor:
    """Distributed singular values (the dplasma_zgesvd composition, ref
    src/zgesvd_wrapper.c; cyclic.py:1238-1247): ge2gb on the cyclic
    slabs, then the band finishes on one device through the
    single-device SVD chain (``ops.eig.gesvd``), which runs its own
    stage 1 on the band again, as the reference's does. Returns
    descending singular values (N,)."""
    from dplasma_tpu_torch.ops import eig as eig_mod
    return eig_mod.gesvd(gebrd_ge2gb_cyclic(A).to_tile())


def potrf_cyclic(A: CyclicMatrix, uplo: str = "L") -> CyclicMatrix:
    """Distributed right-looking Cholesky on block-cyclic local storage
    (the pdpotrf shape; ref src/zpotrf_L.jdf / zpotrf_U.jdf over
    parsec_matrix_block_cyclic), in both storages: A = L L^H (L, with the
    lookahead carry and the K5 ring) or A = U^H U (U, neither, as in the
    reference). N % nb == 0: the pad diagonal is not seeded. The
    global-array :func:`dplasma_tpu_torch.ops.potrf.potrf` remains the
    single-device path."""
    if uplo.upper() not in ("L", "U"):
        raise ValueError(f"uplo must be L or U, got {uplo!r}")
    m = _mesh_of(A)
    _check(A.desc.mb == A.desc.nb and A.desc.M == A.desc.N,
           "potrf_cyclic needs a square matrix of square tiles")
    if uplo.upper() == "U":
        return CyclicMatrix(_potrf_cyclic_upper(A), A.desc)
    ring = _cyclic_ring(A.desc, A.dtype, m)
    rch = _ring_chunks(ring)
    _ring_span(A, ring, rch)
    out = _potrf_cyclic(A, _cyclic_lookahead(), ring, rch)
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


def _panel_bcast_probe(A: CyclicMatrix, ring: bool = False,
                       rchunks: int = 0) -> List[List[torch.Tensor]]:
    """The factorizations' panel-broadcast schedule alone
    (cyclic.py:1306-1342): for each of the KT steps and each process
    row, the owner column's (mloc, mb) block column broadcast along 'q'
    by :func:`_bcast_q` — the K5 ring when ``ring``, else the masked
    psum — summed into one (mloc, mb) slab a rank, which keeps every
    transfer live. KT·P ring broadcasts; the ``ring`` span times it."""
    desc = A.desc
    d = desc.dist
    P, Q = d.P, d.Q
    mb = desc.mb
    KT = min(desc.MT, desc.NT)
    ranks = _ranks(d)
    acc = {r: torch.zeros((desc.MTL * mb, mb), dtype=A.dtype,
                          device=A.device) for r in ranks}
    for k in range(KT):
        qk = layout.owner(k, Q, d.kq, d.jq)
        lck = layout.local_index(k, Q, d.kq)
        cs = {(p, q): A.data[p][q][:, lck * mb:(lck + 1) * mb]
              for p, q in ranks}
        got = _rows_q(cs, P, Q, partial(_bcast_q, qk=qk, ring=ring,
                                        rchunks=rchunks))
        for r in ranks:
            acc[r] = acc[r] + got[r]
    return [[acc[p, q] for q in range(Q)] for p in range(P)]


def _ring_span(A: CyclicMatrix, ring: bool, rchunks: int = 0) -> None:
    """The ``ring`` phase span (cyclic.py:1352-1364): one fenced pass of
    :func:`_panel_bcast_probe`, only while a phase ledger is active —
    the default path never runs the probe, so the timed loop is
    untouched. Its seconds meet the roofline's ``ici`` bound priced
    from :func:`spmd_comm_model`'s panel-broadcast bytes."""
    from dplasma_tpu_torch.observability import phases as _phases
    if _phases.active() is None:
        return
    with _phases.span("ring") as fence:
        fence(_panel_bcast_probe(A, ring, rchunks))


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


# ---------------------------------------------------------------------
# Analytic SPMD comm-volume model (the instruments read it)
# ---------------------------------------------------------------------

def spmd_comm_model(desc: CyclicDesc, op: str, itemsize: int,
                    kt: int | None = None, ring: bool = False) -> dict:
    """Per-collective wire-byte model of the cyclic programs
    (cyclic.py:2202-2320), pure arithmetic over ``desc``.

    Per panel step: a masked psum along 'q' (panel broadcast), a masked
    psum along 'p' (diagonal or top-block broadcast), and an all_gather
    along 'p' or 'q' (row or column panel formation), priced with the
    standard ring costs (an all-reduce moves 2(n-1)/n of the payload per
    rank, an all-gather (n-1)/n of the gathered output). Bytes are TOTAL
    wire bytes over all ranks and steps; a 1x1 grid prices to zero.

    ``ring=True`` prices the K5 schedule under MCA ``ring.enable``: the
    panel broadcast as a store-and-forward ring (each link carries the
    panel once) and the LU winner-row exchange as n-1 shift-and-add
    hops. A size-1 axis keeps its psum class.

    Known ``op`` values: potrf, getrf, geqrf, gemm, herbt, ge2gb; any
    other raises KeyError."""
    d = desc.dist
    P, Q, R = d.P, d.Q, d.P * d.Q
    mb = desc.mb
    mloc = desc.MTL * mb
    nloc = desc.NTL * desc.nb
    KT = min(desc.MT, desc.NT)

    def psum(payload_elems: float, n: int) -> float:
        return R * 2.0 * (n - 1) / max(n, 1) * payload_elems * itemsize

    def agather(payload_elems: float, n: int) -> float:
        # per-rank output is n*payload; ring moves (n-1)*payload/rank
        return R * (n - 1) * payload_elems * itemsize

    def rbcast(payload_elems: float, n: int) -> float:
        # each of the n-1 links in a ring row carries the payload once
        return R * (n - 1) / max(n, 1) * payload_elems * itemsize

    def rshift_sum(payload_elems: float, n: int) -> float:
        # n-1 shift-and-add hops, every rank sends the payload per hop
        return R * (n - 1) * payload_elems * itemsize

    ring_q = ring and Q > 1
    ring_p = ring and P > 1

    def bcast_q_entry(payload_elems: float) -> tuple:
        if ring_q:
            return "panel_ring_bcast_q", KT * rbcast(payload_elems, Q)
        return "panel_bcast_psum_q", KT * psum(payload_elems, Q)

    if op == "potrf":
        key, val = bcast_q_entry(mloc * mb)
        by = {
            key: val,
            "diag_bcast_psum_p": KT * psum(mb * mb, P),
            "row_panel_allgather_p": KT * agather(mloc * mb, P),
        }
    elif op == "getrf":
        key, val = bcast_q_entry(mloc * mb)
        by = {
            key: val,
            "candidate_allgather_p": KT * (
                agather(mb * mb, P) + agather(mb, P)),
        }
        if ring_p:
            by["pivot_row_ring_shift_p"] = KT * rshift_sum(mb * nloc, P)
        else:
            by["pivot_row_exchange_psum_p"] = KT * psum(mb * nloc, P)
    elif op == "geqrf":
        key, val = bcast_q_entry(mloc * mb)
        by = {
            key: val,
            # CholeskyQR2: two Gram psums + the top-block psum along 'p'
            "gram_psum_p": KT * 3 * psum(mb * mb, P),
            "trailing_vhc_psum_p": KT * psum(mb * nloc, P),
        }
    elif op == "gemm":
        # SUMMA over slabs: per contraction step one A-column broadcast
        # along 'q' and one B-row broadcast along 'p'; ``kt`` carries the
        # contraction tile count (default: the square case)
        KT = kt if kt is not None else KT
        by = {
            "a_col_bcast_psum_q": KT * psum(mloc * desc.nb, Q),
            "b_row_bcast_psum_p": KT * psum(desc.nb * nloc, P),
        }
    elif op == "herbt":
        by = {
            "panel_bcast_psum_q": (KT - 1) * psum(mloc * mb, Q),
            "gram_psum_p": (KT - 1) * 3 * psum(mb * mb, P),
            "inner_products_psum_p": (KT - 1) * psum(mb * nloc, P),
            "v_allgather_p": (KT - 1) * agather(mloc * mb, P),
            "two_sided_psum_q": (KT - 1) * 2 * psum(mloc * mb, Q),
        }
    elif op == "ge2gb":
        by = {
            "qr_panel_bcast_psum_q": KT * psum(mloc * mb, Q),
            "qr_gram_psum_p": KT * 3 * psum(mb * mb, P),
            "qr_trailing_psum_p": KT * psum(mb * nloc, P),
            "lq_row_bcast_psum_p": KT * psum(mb * nloc, P),
            "lq_gram_psum_q": KT * 3 * psum(mb * mb, Q),
            "lq_trailing_psum_q": KT * psum(mloc * mb, Q),
        }
    else:
        raise KeyError(f"no spmd comm model for op {op!r}")
    by = {k: float(v) for k, v in by.items()}
    return {"model": "spmd_ring", "steps": KT,
            "bytes_total": float(sum(by.values())),
            "bytes_by_collective": by}
