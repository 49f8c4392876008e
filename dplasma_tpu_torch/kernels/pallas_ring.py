"""K5, the ring transfers of the block-cyclic factorizations, on Hopper.

Replaces ``dplasma_tpu/kernels/pallas_ring.py`` (:53-391; this module
keeps its name so a reader finds the counterpart): the chunked
store-and-forward panel broadcast :func:`ring_bcast` (pallas_call at
:321) and the neighbour hop :func:`ring_shift` (:357), with
:func:`ring_allreduce` (n−1 shifts plus adds, :367-387) on top. On the
TPU they are remote DMAs between chips. In the port the mesh is a
single-controller virtual mesh (``parallel/mesh.py``): each function
takes the **list of the ranks' tensors along one mesh axis** and
returns the list of results, and the kernel ``csrc/ring.cu`` moves the
blocks between the ranks' buffers with the reference's schedule and a
flag protocol (one cooperative launch per ring line; design and memory
order in the source).

What bounds it: bytes. A broadcast of S bytes to n ranks must read the
root's block once and write n blocks, (n+1)·S; the store-and-forward
schedule moves (2n−1)·S (the root's seed and first hop in one pass,
then n−2 forwards). A shift must move 2·n·S.

The host side of a launch is cached per shape (:class:`_Launch`:
geometry from :func:`ring_geometry`, flag slot, prebuilt ctypes
arguments); a call fills the pointers, bumps the epoch and launches.

The route: MCA ``ring.enable`` (auto/on/off) resolved per axis by
:func:`ring_active`, with the reference's rules (off, a size-1 axis, a
dtype other than float32/bfloat16 and an unknown mode). ``auto`` rings
on a CUDA mesh where the geometry gate passes, and raises on a card
that is not Hopper (:func:`ring_runtime_ok`): no device fallback hides
the kernel. ``on`` also walks the ring route on a CPU mesh, through the plain versions (:func:`ring_bcast_reference`,
:func:`ring_shift_reference`), so the CPU tests count it in ``ROUTED``
(the reference falls back to its psum path there; the values are
identical either way). On a CUDA tensor the wrapper launches K5 or
raises; only a CPU tensor takes the plain version. ``ROUTED`` counts
calls on any device, ``LAUNCHES`` the CUDA launches
(``BCAST_LAUNCHES`` + ``SHIFT_LAUNCHES``). The caller names the mesh
axis (``axis=``); while a ``torch.profiler`` capture records, a launch
runs inside a ``k5[ring_<kind>@<axis>]`` range
(``analysis.hlo_names.K5_RANGE``), from which ``--devprof`` classes
its kernel.

The RingOp programs of the reference (``bcast_program``,
``shift_program``, ``allreduce_program``, ``kernel_programs``) need the
spmdcheck types of the analysis slice (ROADMAP queue 1 item 15) and are
not ported yet.
"""
from __future__ import annotations

import ctypes
import functools
import operator
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dplasma_tpu_torch.analysis.hlo_names import K5_RANGE
from dplasma_tpu_torch.utils import config as _cfg

_cfg.mca_register(
    "ring.enable", "auto",
    "Explicit ring transfers in the cyclic factorization kernels "
    "(panel-broadcast ring + LU winner-row exchange ring, "
    "kernels/pallas_ring.py, kernel K5): off = the masked-psum path "
    "(bit-identical values), on = force the ring kernels (a CPU mesh "
    "walks the ring route through the plain versions), auto = the ring "
    "kernels on a CUDA mesh that passes the mesh-geometry gate (every "
    "rank of the axis on one card), the psum path on the CPU. On a "
    "CUDA card that is not Hopper (compute capability 9.0) on and auto "
    "raise.")
_cfg.mca_register(
    "ring.chunks", "4",
    "Pipelining depth of the panel-broadcast ring: the panel is "
    "forwarded in this many chunks so a rank streams chunk c+1 in "
    "while it forwards chunk c (clamped to a divisor of the panel "
    "rows; 1 = store-and-forward whole panels).")

#: kernel-name prefix of the ring transfers (``k5_ring_bcast_kernel``,
#: ``k5_ring_shift_kernel``); the reference's pallas_call names carry
#: ``dplasma_ring_``
RING_NAME_PREFIX = "k5_ring_"

#: calls that took the K5 route, on any device
ROUTED = 0
#: CUDA launches of K5 (both entry points)
LAUNCHES = 0
BCAST_LAUNCHES = 0
SHIFT_LAUNCHES = 0

#: ranks one launch can hold (``MAXN`` in csrc/ring.cu)
MAX_RANKS = 16

_warned: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        sys.stderr.write(f"#! {msg}\n")


def reset_counts() -> None:
    global ROUTED, LAUNCHES, BCAST_LAUNCHES, SHIFT_LAUNCHES
    ROUTED = LAUNCHES = BCAST_LAUNCHES = SHIFT_LAUNCHES = 0


# ---------------------------------------------------------------------
# Runtime probe + mesh-geometry gate
# ---------------------------------------------------------------------

def ring_runtime_ok(device=None) -> bool:
    """Can K5 run on ``device`` (default: the current CUDA device)? A
    CUDA device of compute capability (9, 0): the kernel is built for
    ``sm_90a``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) == (9, 0)


def ring_geometry_ok(mesh, axis: str) -> bool:
    """The ranks along ``axis`` must be ring-connected. Every rank of a
    port mesh shares its one device, which passes. Objects that carry
    hardware ``coords`` (the reference's TPU devices, the tests' fakes)
    are walked as the reference walks them: consecutive devices along
    the axis must differ in exactly one coordinate by ±1, the closing
    hop may be the torus wraparound of a full contiguous extent."""
    try:
        axes = list(mesh.axis_names)
        devs = np.asarray(mesh.devices)
        ax = axes.index(axis)
    except (ValueError, AttributeError):
        return True
    n = devs.shape[ax]
    if n <= 1:
        return False
    lines = np.moveaxis(devs, ax, -1).reshape(-1, n)
    for line in lines:
        coords = [getattr(d, "coords", None) for d in line]
        if any(c is None for c in coords):
            continue            # one device, or no metadata
        dims = [max(c[i] for c in coords) + 1
                for i in range(len(coords[0]))]
        pairs = list(zip(coords, coords[1:] + [coords[0]]))
        for j, (a, b) in enumerate(pairs):
            diff = [i for i in range(len(a)) if a[i] != b[i]]
            if len(diff) != 1:
                return False
            i = diff[0]
            if abs(b[i] - a[i]) == 1:
                continue
            closing = (j == len(pairs) - 1)
            vals = sorted(c[i] for c in coords)
            full = vals == list(range(dims[i]))
            if not (closing and full
                    and (b[i] - a[i]) % max(dims[i], 1)
                    in (1, dims[i] - 1)):
                return False
    return True


_RING_DTYPES = ("float32", "bfloat16")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def ring_active(axis_size: int, dtype=None, mesh=None,
                axis: Optional[str] = None) -> bool:
    """Resolve MCA ``ring.enable`` for one broadcast/exchange axis.

    ``off`` → False (the masked-psum path). An axis of size 1 never
    rings, nor does a dtype other than float32/bfloat16 (f64 slabs take
    the psum path: the reference's rule). Otherwise the mesh's device
    decides (without a mesh: the current card, else the CPU). On the
    CPU ``on`` walks the ring route through the plain versions and
    ``auto`` takes the psum path. On a CUDA device ``on`` and ``auto``
    take K5 wherever the geometry gate passes (every rank of a port
    mesh shares its card, so it does), and a card that is not Hopper
    raises rather than fall back. An unrecognized mode warns once and
    resolves as ``auto``."""
    mode = (_cfg.mca_get("ring.enable") or "auto").lower()
    if mode not in ("auto", "on", "off"):
        _warn_once(f"mode:{mode}",
                   f"ring.enable={mode!r} is not one of auto/on/off; "
                   f"treating as auto")
        mode = "auto"
    if mode == "off" or axis_size <= 1:
        return False
    if dtype is not None:
        name = _dtype_name(dtype)
        if name not in _RING_DTYPES:
            if mode == "on":
                _warn_once(f"dtype:{name}",
                           f"ring.enable=on: dtype {name} has no ring "
                           f"kernel (float32/bfloat16 only); falling "
                           f"back to the psum path")
            return False
    device = getattr(mesh, "device", None)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return mode == "on"
    if not ring_runtime_ok(device):
        cap = torch.cuda.get_device_capability(device)
        raise RuntimeError(
            f"ring.enable={mode}: K5 is built for sm_90a and {device} has "
            f"compute capability {cap[0]}.{cap[1]}; set ring.enable=off "
            f"for the psum path")
    if mode == "auto" and mesh is not None and axis is not None \
            and not ring_geometry_ok(mesh, axis):
        return False
    return True


def _resolve_chunks(rows: int, chunks: Optional[int]) -> int:
    c = chunks if chunks is not None \
        else _cfg.mca_get_int("ring.chunks", 4)
    c = max(int(c), 1)
    while c > 1 and rows % c:
        c -= 1
    return c


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------

def ring_bcast_reference(xs: List[torch.Tensor], root: int,
                         chunks: Optional[int] = None) -> List[torch.Tensor]:
    """Plain K5 broadcast: list copies in the schedule's order — per
    chunk, the root's seed copy, then each rank's forward to its right
    neighbour."""
    n = len(xs)
    rows = xs[root].shape[0]
    c = _resolve_chunks(rows, chunks)
    csz = rows // c
    outs = [torch.empty_like(xs[root], memory_format=torch.contiguous_format)
            for _ in range(n)]
    for ch in range(c):
        sl = slice(ch * csz, (ch + 1) * csz)
        outs[root][sl] = xs[root][sl]
        for d in range(1, n):
            r = (root + d) % n
            outs[r][sl] = outs[(r - 1) % n][sl]
    return outs


def ring_shift_reference(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Plain K5 shift: rank r's block lands on rank (r+1) mod n."""
    n = len(xs)
    return [xs[(r - 1) % n].clone(memory_format=torch.contiguous_format)
            for r in range(n)]


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------

_FNS: dict = {}
#: (kind, device index, n, chunks, blocks per rank) -> [int64 flags, epoch]
_FLAGS: dict = {}
_CORESIDENT: dict = {}
_THREADS = 256


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from dplasma_tpu_torch.kernels import _build
        lib = _build.load("ring")
        i64, ptr, c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        parr, larr = ctypes.POINTER(ctypes.c_void_p), \
            ctypes.POINTER(ctypes.c_longlong)
        tail = [parr, larr, parr, larr, ptr, ctypes.c_ulonglong, ptr]
        lib.dtt_k5_coresident.argtypes = [ctypes.POINTER(c_int)]
        lib.dtt_k5_ring_bcast.argtypes = [c_int, c_int, c_int, c_int, i64,
                                          i64, c_int] + tail
        lib.dtt_k5_ring_shift.argtypes = [c_int, c_int, i64, i64,
                                          c_int] + tail
        for f in (lib.dtt_k5_coresident, lib.dtt_k5_ring_bcast,
                  lib.dtt_k5_ring_shift):
            f.restype = c_int
        _FNS.update(coresident=lib.dtt_k5_coresident,
                    bcast=lib.dtt_k5_ring_bcast,
                    shift=lib.dtt_k5_ring_shift)
        fn = _FNS[name]
    return fn


def _coresident(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    m = _CORESIDENT.get(idx)
    if m is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = _kernel("coresident")(ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"K5 occupancy query failed: cudaError {err}")
        m = _CORESIDENT[idx] = out.value
    return m


class RingGeometry(NamedTuple):
    """One K5 launch's shape: the copy unit (16, 4 or 2 bytes), the
    blocks per rank, the units per chunk of one rank and the flag
    counters the launch uses."""
    unit: int
    blocks: int
    units: int
    flags: int


def _widest_unit(row_bytes: int, strides_bytes) -> int:
    """The widest copy unit (16, 4 or 2 bytes) that divides the row bytes
    and every row stride (the pointers are tested per call)."""
    for u in (16, 4, 2):
        if row_bytes % u == 0 and all(s % u == 0 for s in strides_bytes):
            return u
    raise ValueError("K5 needs 2-byte aligned rows")


def ring_geometry(kind: str, n: int, rows: int, row_bytes: int,
                  strides_bytes, chunks: int, room: int,
                  threads: int = _THREADS) -> RingGeometry:
    """The geometry of one ring transfer of ``rows`` rows of
    ``row_bytes`` along ``n`` ranks in ``chunks`` chunks, with these row
    strides (bytes, every rank's in and out), on a card that holds
    ``room`` co-resident K5 blocks: the widest unit, as many blocks per
    rank as the card holds for n ranks but no more than one unit per
    thread of a chunk needs, and n·chunks counters for a broadcast, n
    for a shift."""
    if n > room:
        raise RuntimeError(f"K5: {n} ranks do not fit one cooperative "
                           f"launch ({room} blocks)")
    unit = _widest_unit(row_bytes, strides_bytes)
    units = rows // chunks * (row_bytes // unit)
    blocks = max(1, min(room // n, -(-units // threads)))
    return RingGeometry(unit, blocks, units,
                        n * chunks if kind == "bcast" else n)


def _check(xs: List[torch.Tensor], what: str) -> None:
    n = len(xs)
    if n < 1:
        raise ValueError(f"K5 {what}: no ranks")
    x0 = xs[0]
    for x in xs:
        if x.ndim != 2:
            raise ValueError(f"K5 {what} takes 2-D blocks, got "
                             f"{tuple(x.shape)}")
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(f"K5 {what}: ranks disagree on the block: "
                             f"{tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(x0.shape)} {x0.dtype}")
        if x.device != x0.device:
            raise ValueError(f"K5 {what}: blocks on different devices: "
                             f"{x.device} vs {x0.device}")


class _Launch:
    """The cached host side of one launch shape: its geometry, flag
    slot and a prebuilt ctypes argument list. A call fills the pointers,
    the target and the stream, and calls."""
    __slots__ = ("kind", "chunks", "shape", "geo", "dev", "fn", "slot",
                 "ins", "outs", "target", "stream", "args")

    def __init__(self, kind, dev, n, root, chunks, rows, cols, esz, ld_in,
                 ld_out, room, align=()):
        self.kind, self.chunks = kind, chunks
        self.shape = (n, rows, cols)
        row_bytes = cols * esz
        self.geo = ring_geometry(kind, n, rows, row_bytes,
                                 (*ld_in, *ld_out, *align), chunks, room)
        self.fn = _kernel(kind)
        self.dev = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        key = (kind, dev.index, n, chunks, self.geo.blocks)
        slot = _FLAGS.get(key)
        if slot is None:
            slot = _FLAGS[key] = [torch.zeros(self.geo.flags,
                                              dtype=torch.int64,
                                              device=dev), 0]
        self.slot = slot
        parr, larr = ctypes.c_void_p * n, ctypes.c_longlong * n
        self.ins, self.outs = parr(), parr()
        self.target = ctypes.c_ulonglong(0)
        self.stream = ctypes.c_void_p(0)
        ci, cl = ctypes.c_int, ctypes.c_longlong
        tail = (self.ins, larr(*ld_in), self.outs, larr(*ld_out),
                ctypes.c_void_p(slot[0].data_ptr()), self.target,
                self.stream)
        if kind == "bcast":
            self.args = (ci(n), ci(root), ci(chunks), ci(self.geo.blocks),
                         cl(rows), cl(row_bytes), ci(self.geo.unit)) + tail
        else:
            self.args = (ci(n), ci(self.geo.blocks), cl(rows),
                         cl(row_bytes), ci(self.geo.unit)) + tail


#: (kind, root, chunks, block signature) -> _Launch
_LAUNCHES: dict = {}


def _signature(xs):
    """(shape, strides, dtype, device index) of every rank's block: the
    launch cache's key, so a launch shape is checked once."""
    return tuple((x.shape, x.stride(), x.dtype, x.get_device())
                 for x in xs)


def _new_launch(kind, xs, root, chunks):
    """The cached host side of a launch shape not seen before (after
    :func:`_check`)."""
    n = len(xs)
    if n > MAX_RANKS:
        raise ValueError(f"K5 takes at most {MAX_RANKS} ranks, got {n}")
    x0 = xs[root]
    for t in [x0] if kind == "bcast" else xs:
        if t.shape[0] > 1 and t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"K5 needs unit-stride columns, got strides "
                             f"{t.stride()}")
    rows, cols = x0.shape
    esz = x0.element_size()
    # the outputs are new contiguous blocks: row stride = row bytes
    return _Launch(kind, x0.device, n, root, chunks, rows, cols, esz,
                   [x.stride(0) * esz for x in xs], [cols * esz] * n,
                   _coresident(x0.device))


def _launch(ent, xs, root: int = 0, axis: Optional[str] = None):
    """One K5 launch of a cached shape: new contiguous outputs, the
    pointers filled in, the epoch bumped; inside its ``K5_RANGE``
    range while a profiler records."""
    global LAUNCHES, BCAST_LAUNCHES, SHIFT_LAUNCHES
    x0 = xs[root]
    outs = x0.new_empty(ent.shape).unbind(0)
    if not x0.numel():
        return list(outs)
    n = len(xs)
    ptrs_in = [x.data_ptr() for x in xs]
    ptrs_out = [o.data_ptr() for o in outs]
    align = ptrs_out[0] | (ptrs_in[root] if ent.kind == "bcast"
                           else functools.reduce(operator.or_, ptrs_in))
    if align % ent.geo.unit:
        # a view off the unit's alignment: this call takes the widest
        # unit its pointers allow, outside the cache
        rows, cols = x0.shape
        esz = x0.element_size()
        ent = _Launch(ent.kind, x0.device, n, root, ent.chunks, rows, cols,
                      esz, [x.stride(0) * esz for x in xs],
                      [cols * esz] * n, _coresident(x0.device),
                      align=(align,))
    for i in range(n):
        ent.ins[i] = ptrs_in[i]
        ent.outs[i] = ptrs_out[i]
    slot = ent.slot
    slot[1] += 1
    ent.target.value = ent.geo.blocks * slot[1]
    ent.stream.value = torch._C._cuda_getCurrentRawStream(ent.dev)
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(
                K5_RANGE.format(f"ring_{ent.kind}@{axis or '?'}")):
            err = ent.fn(*ent.args)
    else:
        err = ent.fn(*ent.args)
    if err != 0:
        slot[1] -= 1
        raise RuntimeError(f"K5 ring_{ent.kind} launch failed: cudaError "
                           f"{err} (n={n} shape={tuple(x0.shape)} "
                           f"{x0.dtype} {ent.geo})")
    LAUNCHES += 1
    if ent.kind == "bcast":
        BCAST_LAUNCHES += 1
    else:
        SHIFT_LAUNCHES += 1
    return list(outs)


def ring_bcast(xs: List[torch.Tensor], *, root: int,
               chunks: Optional[int] = None,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """Broadcast rank ``root``'s 2-D block to every rank of one mesh
    axis: ``xs`` holds the n ranks' blocks in axis order (only the
    root's is read; it may be a strided view with unit-stride columns);
    returns n new contiguous blocks equal to ``xs[root]``. The rows go
    in ``chunks`` pieces (MCA ``ring.chunks`` by default, clamped down
    to a divisor of the rows). ``axis`` names the mesh axis for a
    profiler capture."""
    global ROUTED
    want = chunks if chunks is not None \
        else _cfg.mca_get_int("ring.chunks", 4)
    key = ("bcast", root, want, _signature(xs))
    ent = _LAUNCHES.get(key)
    if ent is not None:          # a CUDA launch shape seen (and checked)
        ROUTED += 1
        return _launch(ent, xs, root, axis)
    _check(xs, "ring_bcast")
    n = len(xs)
    if not 0 <= root < n:
        raise ValueError(f"K5 ring_bcast: root {root} outside 0..{n - 1}")
    if n == 1:
        return [xs[0].clone(memory_format=torch.contiguous_format)]
    c = _resolve_chunks(xs[root].shape[0], want)
    ROUTED += 1
    dev = xs[root].device
    if dev.type == "cpu":
        return ring_bcast_reference(xs, root, c)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on cuda (or cpu), not {dev}")
    ent = _LAUNCHES[key] = _new_launch("bcast", xs, root, c)
    return _launch(ent, xs, root, axis)


def ring_shift(xs: List[torch.Tensor], *,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """One neighbour hop along one mesh axis (``axis``, named for a
    profiler capture): every rank sends its block to ``(r+1) % n`` and
    returns the block received from ``(r-1) % n`` (n new contiguous
    blocks)."""
    global ROUTED
    key = ("shift", 0, 1, _signature(xs))
    ent = _LAUNCHES.get(key)
    if ent is not None:          # a CUDA launch shape seen (and checked)
        ROUTED += 1
        return _launch(ent, xs, axis=axis)
    _check(xs, "ring_shift")
    n = len(xs)
    if n == 1:
        return [xs[0].clone(memory_format=torch.contiguous_format)]
    ROUTED += 1
    dev = xs[0].device
    if dev.type == "cpu":
        return ring_shift_reference(xs)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on cuda (or cpu), not {dev}")
    ent = _LAUNCHES[key] = _new_launch("shift", xs, 0, 1)
    return _launch(ent, xs, axis=axis)


def ring_allreduce(xs: List[torch.Tensor], *,
                   axis: Optional[str] = None) -> List[torch.Tensor]:
    """Sum the ranks' blocks by n−1 shift-and-add ring steps (the cyclic
    LU's winner-row exchange) along mesh axis ``axis``: each rank keeps
    an accumulator and a carry; per step the carry hops one rank right
    and is added, so after n−1 steps every rank holds the full sum,
    accumulated in rank-relative order (r, r−1, ...)."""
    acc, carry = list(xs), list(xs)
    for _ in range(len(xs) - 1):
        carry = ring_shift(carry, axis=axis)
        acc = [a + c for a, c in zip(acc, carry)]
    return acc
