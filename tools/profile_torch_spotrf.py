#!/usr/bin/env python3
"""Where the time of one spotrf goes on the GPU, for the PyTorch port.

    python3 tools/profile_torch_spotrf.py

Factors the driver's SPD input (plghe, N=16384, nb=1024, f32,
lookahead 1) with K1 enabled: five factorizations timed with CUDA
events (min / median / max, the run-to-run spread), then one under
``torch.profiler``. Device time is attributed to the top-level host
call that launched it — K1's ctypes launch, ``linalg_cholesky_ex``
(cuSOLVER, with the GEMM kernels it runs inside), ``linalg_solve_
triangular``, ``cat``, ``sub`` and the rest — and the heaviest kernels
are listed by name. Prints one JSON line with the per-call totals and
the share of the factorization's wall time that no kernel covered (the
device's idle share). Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dplasma_tpu_torch.kernels import pallas_kernels as pk  # noqa: E402
from dplasma_tpu_torch.ops import generators  # noqa: E402
from dplasma_tpu_torch.ops import potrf as potrf_mod  # noqa: E402

N, NB, REPS = 16384, 1024, 5


def _device_ms(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return (us or 0.0) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_spotrf: needs a CUDA device", file=sys.stderr)
        return 1
    pk.enable(True)
    A = generators.plghe(float(N), N, NB, seed=3872)
    potrf_mod.potrf(A, "L")      # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        potrf_mod.potrf(A, "L")
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        potrf_mod.potrf(A, "L")
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    cuda = torch.autograd.DeviceType.CUDA
    by_kernel, by_call = {}, {}
    for ev in prof.events():
        ms = _device_ms(ev)
        if not ms:
            continue
        if ev.device_type == cuda:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
        elif ev.cpu_parent is None:    # a top-level host call
            by_call[ev.name] = by_call.get(ev.name, 0.0) + ms
    busy = sum(by_kernel.values())
    # K1 is launched through ctypes, so no aten call is its parent
    by_call["K1 (ctypes launch)"] = sum(
        ms for name, ms in by_kernel.items() if "k1_gemm" in name)
    print(f"spotrf N={N} nb={NB} f32 K1 on: {REPS} timed factorizations "
          f"min {min(times):.3f} median {statistics.median(times):.3f} "
          f"max {max(times):.3f} ms")
    if not by_kernel:
        print("profiler recorded no device time: breakdown not measured")
    print(f"device busy {busy:.3f} ms of {wall_ms:.3f} ms; by top-level "
          "host call:")
    for name, ms in sorted(by_call.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {name}")
    print("heaviest kernels:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f} ms  {name[:100]}")
    doc = {"N": N, "nb": NB, "device": torch.cuda.get_device_name(0),
           "times_ms": times, "profiled_wall_ms": wall_ms,
           "device_busy_ms": busy,
           "idle_share": (1 - busy / wall_ms) if by_kernel else None,
           "calls_ms": dict(sorted(by_call.items(),
                                   key=lambda kv: -kv[1]))}
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
