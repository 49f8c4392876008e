"""Analytic comm-volume model from the block-cyclic layout
(``dplasma_tpu/observability/comm.py``).

Two complementary models, both computed from pure index algebra (the
same property the reference exploits: dependence expressions evaluate
identically on every rank, so comm volume is knowable without running):

* **DAG model** — owner-computes tile traffic: walk the tile DAG's flow
  dependences (the ``type_remote`` edges of the JDFs) and count one
  tile-sized message per *distinct remote consumer rank* of each
  produced tile, using the block-cyclic owner map
  (:func:`dplasma_tpu_torch.native.rank_grid` semantics). This is what
  PaRSEC's comm engine would put on the wire for the same distribution.
* **SPMD model** — the ring-priced collective bytes of the cyclic
  programs (:func:`dplasma_tpu_torch.parallel.cyclic.spmd_comm_model`,
  held key for key to the reference's), what the distributed path's
  collectives move between ranks.

Side by side in the run-report they bound the comm cost from both ends
of the design space. All figures are total bytes across ranks.
"""
from __future__ import annotations

from typing import Optional, Set

#: dependence-walk size cap (tile products above this skip the DAG
#: model — explicit null in the report; the spmd model is closed-form)
_DAG_WALK_CAP = 1 << 14

#: driver algo name -> modelled op class (None = no model, report null)
OP_CLASS = {
    "potrf": "potrf", "potrs": "potrf", "posv": "potrf",
    "potri": "potrf", "poinv": "potrf",
    "getrf": "getrf", "getrf_1d": "getrf", "getrf_nopiv": "getrf",
    "getrf_ptgpanel": "getrf", "getrf_incpiv": "getrf",
    "getrf_qrf": "getrf", "gesv": "getrf", "gesv_incpiv": "getrf",
    "geqrf": "geqrf", "gelqf": "geqrf", "geqrf_hqr": "geqrf",
    "geqrf_systolic": "geqrf", "geqrf_rd": "geqrf", "gels": "geqrf",
    "gemm": "gemm", "symm": "gemm", "hemm": "gemm", "syrk": "gemm",
    "herk": "gemm", "syr2k": "gemm", "her2k": "gemm", "trmm": "gemm",
    "trsm": "gemm", "gemm_dtd": "gemm",
    "hetrd": "herbt", "heev": "herbt", "hbrdt": "herbt",
    "gebrd": "ge2gb", "gesvd": "ge2gb", "gebrd_ge2gb": "ge2gb",
    # mixed-precision IR solvers (ops.refine): their own phase-model
    # classes (observability.roofline.refine_phase_model); no tile-
    # message comm model — the factor's traffic is the inner op's
    "posv_ir": "posv_ir", "gesv_ir": "gesv_ir", "gels_ir": "gels_ir",
}


def _owners(lo: int, hi: int, n: int, kblk: int, off: int) -> Set[int]:
    """Distinct block-cyclic owners of tile range [lo, hi] along one
    grid axis: owner(t) = (t//kblk + off) % n (ref common.c:79-93)."""
    if lo > hi or n <= 0:
        return set()
    s_lo, s_hi = lo // kblk, hi // kblk
    if s_hi - s_lo + 1 >= n:
        return set(range(n))
    return {(s + off) % n for s in range(s_lo, s_hi + 1)}


class _DagCounter:
    """Counts remote tile messages per flow over a P x Q k-cyclic grid."""

    def __init__(self, dist):
        self.dist = dist
        self.P, self.Q = dist.P, dist.Q
        self.kp, self.kq = dist.kp, dist.kq
        self.ip, self.jq = dist.ip, dist.jq
        self.flows = {}

    def rank(self, i: int, j: int) -> int:
        # the one shared owner map (native.rank_of)
        from dplasma_tpu_torch import native
        return native.rank_of(self.dist, i, j)

    def send(self, flow: str, src_tile, col_consumers=None,
             row_consumers=None) -> None:
        """One produced tile at ``src_tile`` consumed by tiles spanning
        ``col_consumers = (row_lo, row_hi, col)`` and/or
        ``row_consumers = (row, col_lo, col_hi)``; adds one message per
        distinct remote consumer rank."""
        ranks: Set[int] = set()
        if col_consumers is not None:
            lo, hi, j = col_consumers
            pc = (j // self.kq + self.jq) % self.Q
            for pr in _owners(lo, hi, self.P, self.kp, self.ip):
                ranks.add(pr * self.Q + pc)
        if row_consumers is not None:
            i, lo, hi = row_consumers
            pr = (i // self.kp + self.ip) % self.P
            for pc in _owners(lo, hi, self.Q, self.kq, self.jq):
                ranks.add(pr * self.Q + pc)
        ranks.discard(self.rank(*src_tile))
        if ranks:
            self.flows[flow] = self.flows.get(flow, 0) + len(ranks)


def _dag_messages(op: str, MT: int, NT: int, KTg: int,
                  dist) -> Optional[dict]:
    """Tile-message counts by flow for the modelled op classes."""
    c = _DagCounter(dist)
    KT = min(MT, NT)
    if op == "potrf":
        for k in range(KT):
            # Lkk -> trsm(m,k) down column k
            c.send("Lkk", (k, k), col_consumers=(k + 1, KT - 1, k))
            for m in range(k + 1, KT):
                # panel tile (m,k) -> herk/gemm across row m and col m
                c.send("panel", (m, k),
                       col_consumers=(m, KT - 1, m),
                       row_consumers=(m, k + 1, m))
    elif op == "getrf":
        for k in range(KT):
            c.send("Lkk_Ukk", (k, k),
                   col_consumers=(k + 1, MT - 1, k),
                   row_consumers=(k, k + 1, NT - 1))
            for m in range(k + 1, MT):
                # L(m,k) -> gemm row m trailing
                c.send("L_panel", (m, k),
                       row_consumers=(m, k + 1, NT - 1))
            for n in range(k + 1, NT):
                # U(k,n) -> gemm column n trailing
                c.send("U_row", (k, n),
                       col_consumers=(k + 1, MT - 1, n))
    elif op == "geqrf":
        for k in range(KT):
            # geqrt(k) V -> unmqr row k trailing + tsqrt(k+1,k)
            c.send("V1_T1", (k, k),
                   row_consumers=(k, k + 1, NT - 1),
                   col_consumers=(k + 1, min(k + 1, MT - 1), k))
            for m in range(k + 1, MT):
                # tsqrt(m,k) V -> tsmqr row m trailing; R couple chains
                c.send("V2_T2", (m, k),
                       row_consumers=(m, k + 1, NT - 1))
                c.send("R_couple", (m, k),
                       col_consumers=(min(m + 1, MT - 1), min(m + 1, MT - 1), k))
            for n in range(k + 1, NT):
                # the top row slab A(k,n) rides down the column through
                # the tsmqr chain (one hop per row tile)
                c.send("row_slab", (k, n),
                       col_consumers=(k + 1, MT - 1, n))
    elif op == "gemm":
        # SUMMA broadcasts at tile granularity: A(m,l) across its mesh
        # row, B(l,n) down its mesh column
        for m in range(MT):
            for l in range(KTg):
                c.send("A_bcast", (m, l), row_consumers=(m, 0, NT - 1))
        for l in range(KTg):
            for n in range(NT):
                c.send("B_bcast", (l, n), col_consumers=(0, MT - 1, n))
    else:
        return None
    return c.flows


def comm_volume_model(op: str, M: int, N: int, K: int, mb: int, nb: int,
                      itemsize: int, dist) -> dict:
    """Comm-volume model for one driver op on a block-cyclic layout.

    ``op`` is the precision-less algo name (``potrf``, ``getrf_1d``,
    ``gemm``, ...); unmodelled ops report explicit nulls. 1x1 grids
    report zeros (everything is rank-local).
    """
    cls = OP_CLASS.get(op)
    out = {"op": op, "op_class": cls,
           "grid": {"P": dist.P, "Q": dist.Q, "kp": dist.kp,
                    "kq": dist.kq},
           "tile_bytes": mb * nb * itemsize,
           "dag_model": None, "spmd_model": None}
    if cls is None:
        return out
    MT, NT, KTg = -(-M // mb), -(-N // nb), -(-max(K, 1) // nb)
    if dist.P * dist.Q <= 1:
        # everything is rank-local: no need to walk the tile DAG
        flows = {}
    elif MT * NT > _DAG_WALK_CAP or KTg * (MT + NT) > _DAG_WALK_CAP:
        # the dependence walk is O(tiles^2)-ish in Python; past the
        # cap the report carries an explicit null (the closed-form
        # spmd model below still prices the run)
        flows = None
    else:
        flows = _dag_messages(cls, MT, NT, KTg, dist)
    if flows is not None:
        tb = mb * nb * itemsize
        msgs = int(sum(flows.values()))
        out["dag_model"] = {"model": "owner_computes", "messages": msgs,
                            "bytes_total": float(msgs * tb),
                            "messages_by_flow": flows}
    try:
        from dplasma_tpu_torch.descriptors import Dist
        from dplasma_tpu_torch.parallel.cyclic import (CyclicDesc,
                                                       spmd_comm_model)
        desc = CyclicDesc(M, N, mb, nb,
                          Dist(dist.P, dist.Q, dist.kp, dist.kq,
                               dist.ip, dist.jq))
        out["spmd_model"] = spmd_comm_model(
            desc, cls, itemsize,
            kt=KTg if cls == "gemm" else None)
    except KeyError:
        pass
    return out
