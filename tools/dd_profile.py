#!/usr/bin/env python3
"""One f64-equivalent (dd) Cholesky on the card, timed and profiled.

    python3 tools/dd_profile.py [--root DIR] [--tag TAG] [--reps R]
                                [--grid PxQ]

Factors bench.py's ``dpotrf_f64equiv`` matrix (N=8192, nb=512, MCA
``dd_gemm=always``) with the ``dplasma_tpu_torch`` found under ``--root``
(default: this checkout) — with ``--grid PxQ`` by ``potrf_cyclic`` on a
P×Q virtual mesh of the card: ``--reps`` factorizations timed one by one with
CUDA events after one warm-up, then one under torch.profiler, its device
time split by ``chip_smoke.py``'s kernel categories (K2, the digit
splits' shifts, ands, wheres and clamps, adds, casts and copies, cuBLAS
int8 GEMMs, ...) and the device's idle share. Two trees compare on one
card in one command: unpack the other tree (``git archive``) into a
directory that ``.gitignore`` lists and run this script on each in turn
(A, B, B, A). Each run prints one JSON line and appends it to
``chiprun_out/dd_profile.jsonl``. Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NB = 8192, 512


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--grid", default="1x1",
                    help="PxQ: potrf_cyclic on that virtual mesh")
    args = ap.parse_args()
    P, Q = (int(x) for x in args.grid.lower().split("x"))
    import torch
    if not torch.cuda.is_available():
        print("dd_profile: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import contextlib

    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.kernels import pallas_dd as pdd
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.ops import potrf as potrf_mod
    from dplasma_tpu_torch.parallel import cyclic, mesh
    from dplasma_tpu_torch.utils import config as cfg

    A = generators.plghe(float(N), N, NB, seed=3872, dtype=torch.float64)
    record = {}
    grid = (mesh.use_grid(mesh.make_mesh(P, Q)) if P * Q > 1
            else contextlib.nullcontext())
    with cfg.override_scope({"dd_gemm": "always"}), grid:
        if P * Q > 1:
            C = cyclic.CyclicMatrix.from_tile(A, Dist(P=P, Q=Q))

            def run():
                return cyclic.potrf_cyclic(C, "L")
        else:
            def run():
                return potrf_mod.potrf(A, "L")

        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            pdd.reset_counts()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        launches = pdd.LAUNCHES
        smoke._profile(torch, record, "dd", f"N={N} nb={NB} dd grid "
                       f"{P}x{Q} ({args.tag or root})", run)
    prof = record["dd"]
    out = {"tag": args.tag, "root": os.path.relpath(root, HERE), "N": N,
           "nb": NB, "grid": [P, Q],
           "device": torch.cuda.get_device_name(0),
           "ms": times, "best_ms": min(times),
           "median_ms": sorted(times)[len(times) // 2],
           "k2_launches": launches,
           **{k: prof.get(k) for k in ("wall_ms", "busy_ms", "idle_share",
                                       "categories_ms")}}
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "dd_profile.jsonl"),
              "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
