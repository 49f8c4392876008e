"""Op-name tables: the one place the timeline's op spellings live
(``dplasma_tpu/analysis/hlo_names.py``, plain Python, with the CUDA
spellings a ``torch.profiler`` device timeline carries).

:mod:`dplasma_tpu_torch.observability.devprof` bins every timeline op
into ``compute`` / ``collective`` / ``ici`` / ``host`` with
:func:`timeline_category`. Two vocabularies meet here:

* the reference's HLO names (``all-reduce.3``, ``fusion.17``,
  ``custom-call.4 dplasma_ring_bcast``), which the synthetic backend
  writes; on these the answer is the reference's;
* the device ops of a ``torch.profiler`` CUDA timeline:
  - K5's kernels (``k5_ring_bcast_kernel`` and ``k5_ring_shift_kernel``,
    ``kernels/csrc/ring.cu``) are the one card's ring legs: ``ici``;
    each launch names its axis in a :data:`K5_RANGE` profiler range;
  - ``Memcpy*`` and ``Memset*`` device ops: ``host`` (data movement
    no kernel of the op asked for, as HLO ``copy``);
  - ``nccl*`` kernels: ``collective`` (the multi-card step);
  - every other kernel (K1–K4, KT, KW, cuBLAS, cuSOLVER, the
    elementwise kernels): ``compute``.

A CUDA kernel of a template is named ``void name<...>(...)`` in the
timeline, so the CUDA rules match anywhere in the name, the HLO rules
on the leading opcode token.
"""
from __future__ import annotations

#: HLO opcode -> normalized collective kind (async -start forms count
#: once; their -done halves are bookkeeping, not wire traffic)
HLO_COLLECTIVES = {
    "all-reduce": "all-reduce", "all-reduce-start": "all-reduce",
    "all-gather": "all-gather", "all-gather-start": "all-gather",
    "reduce-scatter": "reduce-scatter",
    "collective-permute": "collective-permute",
    "collective-permute-start": "collective-permute",
    "all-to-all": "all-to-all",
    "collective-broadcast": "collective-broadcast",
}

#: collective kind of the schedule -> the HLO opcode it lowers to in
#: the reference (psum/pmax/pmin are all all-reduce). The ring kernels
#: (ring_bcast/ring_shift) are reconciled as "ring-dma".
JAXPR_TO_HLO = {
    "psum": "all-reduce", "pmax": "all-reduce", "pmin": "all-reduce",
    "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
    "ppermute": "collective-permute", "all_to_all": "all-to-all",
    "ring_bcast": "ring-dma", "ring_shift": "ring-dma",
}

#: marker identifying a ring kernel's custom-call in the reference's
#: compiled HLO (the synthetic timeline's ring spans carry it too)
RING_MARKER = "dplasma_ring_"

#: custom-call targets that are host round-trips in disguise
CALLBACK_MARKERS = ("callback", "infeed", "outfeed")

#: HLO opcodes that are pure data movement the compiler inserted
COPY_OPCODES = ("copy", "copy-start", "copy-done", "transpose")

#: K5's CUDA kernels -> the collective kind each runs
K5_KERNELS = {"k5_ring_bcast_kernel": "ring_bcast",
              "k5_ring_shift_kernel": "ring_shift"}

#: the profiler range a K5 launch opens while a capture records
#: (``kernels.pallas_ring``): it names the launch's schedule class,
#: its kind and its mesh axis, e.g. ``k5[ring_bcast@q]``
K5_RANGE = "k5[{}]"

#: leading words of the device-side data movement of a CUDA timeline
CUDA_COPY_PREFIXES = ("memcpy", "memset")

#: the NCCL collective kernels' names hold this word
NCCL_MARKER = "nccl"


def k5_kind(name: str):
    """The collective kind of a K5 kernel name, or None."""
    low = str(name).lower()
    for kernel, kind in K5_KERNELS.items():
        if kernel in low:
            return kind
    return None


def k5_range_class(name: str):
    """The schedule class a :data:`K5_RANGE` range names, or None."""
    head, tail = K5_RANGE.split("{}")
    name = str(name)
    if name.startswith(head) and name.endswith(tail) \
            and len(name) > len(head) + len(tail):
        return name[len(head):len(name) - len(tail)]
    return None


def timeline_category(name: str) -> str:
    """Bin one timeline op name into the devprof category model:
    ``compute`` / ``collective`` / ``ici`` / ``host``.

    A :data:`RING_MARKER` custom-call or a K5 kernel is ``ici``; a
    :data:`HLO_COLLECTIVES` opcode or an ``nccl*`` kernel is
    ``collective``; copy/transpose, a ``Memcpy*``/``Memset*`` device
    op and the host-callback markers are ``host``; everything else
    (fusions, dots, every other kernel) is ``compute``."""
    low = str(name).lower()
    if RING_MARKER in low or k5_kind(low) is not None:
        return "ici"
    opcode = low.split(" ", 1)[0].split(".", 1)[0].lstrip("%")
    if opcode in HLO_COLLECTIVES or NCCL_MARKER in low:
        return "collective"
    if opcode in COPY_OPCODES or opcode.startswith(CUDA_COPY_PREFIXES):
        return "host"
    if any(m in low for m in CALLBACK_MARKERS):
        return "host"
    return "compute"
