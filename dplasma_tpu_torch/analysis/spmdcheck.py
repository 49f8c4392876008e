"""The collective schedule of the cyclic programs: the schedule part of
``dplasma_tpu/analysis/spmdcheck.py`` (its ``_STEP_COUNTS``,
``expected_counts`` and ``model_classes``, spmdcheck.py:387-461).

:mod:`dplasma_tpu_torch.observability.devprof` reconciles a measured or
synthesized timeline against :func:`expected_counts`, the per-rank
collective count of each (kind, axis) class over ``KT`` panel steps.
:func:`model_classes` parses the classes that
:func:`dplasma_tpu_torch.parallel.cyclic.spmd_comm_model` prices, so the
schedule and the comm model cannot drift apart.

The rest of the reference module (the jaxpr walk with its axis-binding,
uniformity and ppermute-bijection checks, ``reconcile_counts`` and the
ring-schedule simulator) checks traced programs; its port, a checker of
the RingOp programs and the collective schedule, is ROADMAP queue 1
item 15.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

#: per-step (kind, axis-role) multiplicities of the cyclic kernels — the
#: collective structure spmd_comm_model prices. Axis roles 'row'/'col'
#: resolve to the mesh axis constants at check time.
_STEP_COUNTS = {
    # panel bcast psum_q + diag bcast psum_p + row-panel all_gather_p
    "potrf": {("psum", "col"): 1, ("psum", "row"): 1,
              ("all_gather", "row"): 1},
    # panel bcast psum_q + candidate/gid all_gathers + pivot-row psum_p
    "getrf": {("psum", "col"): 1, ("all_gather", "row"): 2,
              ("psum", "row"): 1},
    # panel bcast psum_q + CholeskyQR2 grams/top (3) + V^H C psum_p
    "geqrf": {("psum", "col"): 1, ("psum", "row"): 4},
    # SUMMA: A-column psum_q + B-row psum_p per contraction step
    "gemm": {("psum", "col"): 1, ("psum", "row"): 1},
}


def expected_counts(op: str, KT: int, lookahead: int = 0,
                    ring: bool = False,
                    grid: Tuple[int, int] = (1, 1)
                    ) -> Optional[Dict[str, int]]:
    """Expected per-rank collective counts of one cyclic kernel over
    ``KT`` panel steps. The lookahead pipeline relocates the panel
    broadcast (step k pre-broadcasts column k+1) but never changes the
    totals, so the check is exact.

    ``ring=True`` expects the K5 schedule (MCA ``ring.enable``): the
    panel broadcast class moves from ``psum@q`` to ``ring_bcast@q`` (one
    ring a step) and the LU winner-row exchange from ``psum@p`` to
    ``ring_shift@p`` at P-1 hops a step — which is why the ring schedule
    needs the ``grid`` shape (a size-1 axis keeps its psum class)."""
    from dplasma_tpu_torch.parallel import mesh as pmesh
    tbl = _STEP_COUNTS.get(op)
    if tbl is None:
        return None
    axis = {"row": pmesh.ROW_AXIS, "col": pmesh.COL_AXIS}
    P, Q = int(grid[0]), int(grid[1])
    out: Dict[str, int] = {}
    for (kind, role), n in tbl.items():
        key = f"{kind}@{axis[role]}"
        cnt = n * KT
        if ring and kind == "psum" and role == "col" and Q > 1 \
                and op in ("potrf", "getrf", "geqrf"):
            key, cnt = f"ring_bcast@{axis[role]}", KT
        elif ring and op == "getrf" and kind == "psum" \
                and role == "row" and P > 1:
            key, cnt = f"ring_shift@{axis[role]}", KT * (P - 1)
        out[key] = out.get(key, 0) + cnt
    return out


def model_classes(op: str, ring: bool = False,
                  grid: Tuple[int, int] = (2, 2)) -> Optional[set]:
    """The (kind, axis) collective classes that
    :func:`dplasma_tpu_torch.parallel.cyclic.spmd_comm_model` prices for
    one op, parsed from its per-collective key names. Ring classes
    (``panel_ring_bcast_q``/``pivot_row_ring_shift_p``) parse to
    ``ring_bcast``/``ring_shift`` kinds; the ``grid`` shape must match
    the count table's (per-axis psum fallback)."""
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.observability.devprof import _class_of_model_key
    from dplasma_tpu_torch.parallel.cyclic import (CyclicDesc,
                                                   spmd_comm_model)
    P, Q = max(int(grid[0]), 1), max(int(grid[1]), 1)
    desc = CyclicDesc(8, 8, 4, 4, Dist(P=P, Q=Q))
    try:
        model = spmd_comm_model(desc, op, 4, ring=ring)
    except KeyError:
        return None
    return {_class_of_model_key(k) for k in model["bytes_by_collective"]}
