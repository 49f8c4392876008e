"""DTD-style insert-task front end.

Ports ``dplasma_tpu/dtd.py`` (:33-213), the reference's second
programming model: the application inserts tile tasks one by one and
the runtime infers the dependences from the access modes
(``parsec_dtd_insert_task`` with PARSEC_INPUT/OUTPUT/INOUT — ref
src/dtd_wrappers/dplasma_z_dtd.h:13,49-53, tests/testing_zpotrf_dtd.c).

:class:`TaskPool` records inserted tasks against tiles of its
:class:`~dplasma_tpu_torch.descriptors.TileMatrix` operands, with the
last writer of each tile, so its edges are the reference's for the same
insertions. Insertion order is a valid sequential schedule (PaRSEC
DTD's sequential-consistency contract): the reference replays the tasks
in it inside one jit trace; the port replays them eagerly, in insertion
order, on the current stream, on one private copy of each matrix,
writing every output tile in place. A task's outputs are computed from
its input tiles before any of them is written, so the in-place replay
gives what the reference's functional replay (a new matrix per written
tile) gives.

The task classes for potrf/trsm/herk/gemm mirror
``src/dtd_wrappers/dplasma_z_dtd.h``; their products go through
``kernels.blas`` (K1 in f32 when it is enabled and the tiles are at
least 256 wide): :func:`potrf_dtd` on nt tiles inserts nt potrf,
nt(nt − 1)/2 trsm and herk, nt(nt − 1)(nt − 2)/6 gemm tasks (816 at
nt = 16), one K1 launch per herk and gemm (680). ``TaskPool.schedule``
(the native wavefront scheduler) is ROADMAP queue 1 item 15.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dplasma_tpu_torch.descriptors import TileMatrix
from dplasma_tpu_torch.kernels import blas as k

IN, OUT, INOUT = "IN", "OUT", "INOUT"


@dataclasses.dataclass(frozen=True)
class TileRef:
    """A (matrix, i, j, mode) access — the dtd tile handle analogue."""
    mat: int          # index of the matrix within the pool
    i: int
    j: int
    mode: str

    def __post_init__(self):
        if self.mode not in (IN, OUT, INOUT):
            raise ValueError(f"unknown access mode {self.mode!r}")


@dataclasses.dataclass
class _Task:
    fn: Callable
    refs: Tuple[TileRef, ...]
    name: str
    kwargs: dict


def _shares(x: torch.Tensor, data: torch.Tensor) -> bool:
    return x.untyped_storage().data_ptr() == \
        data.untyped_storage().data_ptr()


class TaskPool:
    """Insert-task pool over one or more TileMatrix operands.

    Usage (mirrors testing_zpotrf_dtd.c's insertion loops)::

        tp = TaskPool(A)
        tp.insert_task(fn, tp.tile(0, kk, kk, INOUT), name="potrf")
        ...
        (A_out,) = tp.wait()

    ``fn`` receives the current tiles (one per ref, in order) and
    returns the new values of the OUT/INOUT tiles (in order; a single
    tensor if there is exactly one)."""

    def __init__(self, *mats: TileMatrix):
        if not mats:
            raise ValueError("TaskPool needs at least one TileMatrix")
        self.mats = list(mats)
        self.tasks: List[_Task] = []
        # last writer task id per (mat, i, j); -1 = initial data
        self._writer: Dict[Tuple[int, int, int], int] = {}
        self.edges: List[Tuple[int, int]] = []

    def tile(self, mat: int, i: int, j: int, mode: str = IN) -> TileRef:
        d = self.mats[mat].desc
        if not (0 <= i < d.MT and 0 <= j < d.NT):
            raise IndexError(f"tile ({i}, {j}) outside {d.MT}x{d.NT}")
        return TileRef(mat, i, j, mode)

    def insert_task(self, fn: Callable, *refs: TileRef,
                    name: Optional[str] = None, **kwargs) -> int:
        """Register a task; the dependences follow from the access
        modes (flow dependences, and an output dependence between two
        writers of a tile with no read between them)."""
        tid = len(self.tasks)
        self.tasks.append(_Task(fn, refs, name or fn.__name__, kwargs))
        for r in refs:
            key = (r.mat, r.i, r.j)
            w = self._writer.get(key, -1)
            if r.mode in (IN, INOUT) and w >= 0:
                self.edges.append((w, tid))
            if r.mode in (OUT, INOUT):
                if r.mode == OUT and w >= 0:
                    self.edges.append((w, tid))
                self._writer[key] = tid
        return tid

    # -- execution -----------------------------------------------------
    def wait(self, jit: bool = True) -> Tuple[TileMatrix, ...]:
        """Run every inserted task and return the updated matrices (the
        parsec_dtd_taskpool_wait analogue); the operands are not
        written. ``jit`` keeps the reference's signature: there it
        chooses one traced program over an eager replay; the port's
        replay is always the eager one, in insertion order."""
        del jit
        mats = [TileMatrix(m.data.clone(), m.desc) for m in self.mats]
        for t in self.tasks:
            ins = [mats[r.mat].tile(r.i, r.j) for r in t.refs]
            outs = t.fn(*ins, **t.kwargs)
            wrefs = [r for r in t.refs if r.mode in (OUT, INOUT)]
            if len(wrefs) == 1:
                outs = (outs,)
            if len(outs) != len(wrefs):
                raise ValueError(f"task {t.name} returned {len(outs)} "
                                 f"tiles for {len(wrefs)} outputs")
            # an output that is a view of a tile is read before any
            # tile is written
            outs = [o.clone() if any(_shares(o, m.data) for m in mats)
                    else o for o in outs]
            for r, val in zip(wrefs, outs):
                mats[r.mat].tile(r.i, r.j).copy_(val)
        return tuple(mats)

    # -- introspection -------------------------------------------------
    def record_dag(self, rec) -> None:
        """Feed the tracked task DAG into a recorder with the reference's
        ``DagRecorder`` interface (``task(name, *index)``,
        ``edge(a, b)``). The flattened refs plus the insertion id key
        each node: DTD may insert the same task class on the same tiles
        twice, and a recorder would otherwise merge the two."""
        ids = []
        for tid, t in enumerate(self.tasks):
            ix = tuple(x for r in t.refs for x in (r.i, r.j))
            ids.append(rec.task(t.name, *ix, tid))
        for s, d in self.edges:
            rec.edge(ids[s], ids[d])

    def schedule(self, lookahead: int = 0):
        """The wavefront order of the inserted DAG (the reference's
        native scheduler) comes with ROADMAP queue 1 item 15."""
        raise NotImplementedError("TaskPool.schedule (native.wavefront_"
                                  "order) is not ported yet (ROADMAP "
                                  "queue 1 item 15)")


# ---------------------------------------------------------------------
# Task classes (src/dtd_wrappers/dplasma_z_dtd.h analogues)
# ---------------------------------------------------------------------

def _t_potrf(akk, *, lower):
    return k.potrf(akk, lower=lower)


def _t_trsm(lkk, amk, *, lower):
    if lower:
        return k.trsm(lkk, amk, side="R", lower=True, trans="C")
    return k.trsm(lkk, amk, side="L", lower=False, trans="C")


def _t_herk(pan, amm, *, lower):
    if lower:
        return k.herk(-1.0, pan, 1.0, amm, trans="N")
    return k.herk(-1.0, pan, 1.0, amm, trans="C")


def _t_gemm(pm, pn, amn, *, lower):
    if lower:
        return k.gemm(-1.0, pm, pn, 1.0, amn, tb=True, conj_b=True)
    return k.gemm(-1.0, pm, pn, 1.0, amn, ta=True, conj_a=True)


def potrf_dtd(A: TileMatrix, uplo: str = "L",
              pool: Optional[TaskPool] = None):
    """Right-looking tile Cholesky by task insertion — the
    testing_zpotrf_dtd.c flow. Returns the factored TileMatrix. With a
    ``pool``, the tasks are only inserted and the pool is returned, so
    the caller can insert more before ``wait()``; such a pool must wrap
    ``A.pad_diag()`` (ragged edge tiles need the unit pad diagonal)."""
    lower = uplo.upper() == "L"
    tp = pool if pool is not None else TaskPool(A.pad_diag())
    nt = tp.mats[0].desc.KT
    for kk in range(nt):
        tp.insert_task(_t_potrf, tp.tile(0, kk, kk, INOUT),
                       name="potrf", lower=lower)
        for m in range(kk + 1, nt):
            pan = (m, kk) if lower else (kk, m)
            tp.insert_task(_t_trsm, tp.tile(0, kk, kk, IN),
                           tp.tile(0, *pan, INOUT),
                           name="trsm", lower=lower)
        for m in range(kk + 1, nt):
            pan = (m, kk) if lower else (kk, m)
            tp.insert_task(_t_herk, tp.tile(0, *pan, IN),
                           tp.tile(0, m, m, INOUT),
                           name="herk", lower=lower)
            for n in range(kk + 1, m):
                # lower: A[m,n] -= A[m,k] A[n,k]^H
                # upper: A[n,m] -= A[k,n]^H A[k,m]
                pm, pn = ((m, kk), (n, kk)) if lower else ((kk, n), (kk, m))
                tgt = (m, n) if lower else (n, m)
                tp.insert_task(_t_gemm, tp.tile(0, *pm, IN),
                               tp.tile(0, *pn, IN),
                               tp.tile(0, *tgt, INOUT),
                               name="gemm", lower=lower)
    if pool is not None:
        return tp
    (out,) = tp.wait()
    return out
