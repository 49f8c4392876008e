#!/usr/bin/env python3
"""Time the cluster panel kernels K3 (LU) and K4 (QR) of the PyTorch
port on one GPU, over the panels of one N=8192, nb=256 factorization,
for several cluster geometries, beside cuSOLVER's getrf / geqrf.

    python3 tools/panel_cluster_sweep.py [--targets 64,128,256]
                                         [--max-cluster 8,16]

For each (rows-per-block target, cluster cap) the wrapper's
``launch_geometry`` is rebuilt with those constants, every panel height
M = 8192, 7936, ..., 256 is factored once and checked (K3 bitwise
against ``lu_panel_reference``, K4 within chip_smoke's tolerance of
``geqrt_panel_reference``), then timed as chip_smoke.py times it.
Prints per configuration the sums over the 32 panels, chip_smoke's fit
ms = a + b·M (a: the part that does not grow with M) and the kernel's
device time from torch.profiler (so that host time between launches
does not count), and writes everything to
``chiprun_out/panel_cluster_sweep.json``. Needs CUDA; exits 1 without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

N, NB = 8192, 256


def device_ms(torch, run, panels, key):
    """Device time of each panel's kernel (name containing ``key``), one
    launch each under torch.profiler, in the panels' order; None when
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in panels:
            run(a)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if key in e.name),
                 key=lambda e: e.time_range.start)
    ms = [cs._device_ms(e) for e in evs]
    return ms if len(ms) == len(panels) and any(ms) else None


def agrees(torch, name, got, want):
    if name == "k3":
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rel = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    return rel <= cs.K4_TOL and float((got[1] - want[1]).abs().max()) \
        <= cs.K4_TOL


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", default="64,128,256")
    ap.add_argument("--max-cluster", default="8,16")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("panel_cluster_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from dplasma_tpu_torch.kernels import pallas_lu as plu
    from dplasma_tpu_torch.kernels import pallas_qr as pqr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    heights = cs.main_path_panels(N, NB)
    g = torch.Generator(device="cuda").manual_seed(600)
    panels = {M: torch.randn(M, NB, device="cuda", generator=g)
              for M in heights}
    kernels = {"k3": (plu.lu_panel, plu.lu_panel_reference, "k3_lu_panel",
                      torch.linalg.lu_factor_ex),
               "k4": (pqr.geqrt_panel_packed, pqr.geqrt_panel_reference,
                      "k4_geqrt_panel", torch.geqrf)}
    lib = {name: [cs.time_ms(torch, lambda a=a, f=k[3]: cs.with_cusolver(
        torch, f, a), args.reps) for a in panels.values()]
        for name, k in kernels.items()}
    refs = {name: {M: k[1](a) for M, a in panels.items()}
            for name, k in kernels.items()}
    print(f"cuSOLVER over the {len(heights)} panels: getrf "
          f"{sum(lib['k3']):.3f} ms, geqrf {sum(lib['k4']):.3f} ms",
          flush=True)
    keep = (pqr.ROWS_PER_BLOCK_TARGET, pqr.MAX_CLUSTER)
    out = {"device": smi, "heights": heights, "library_ms": lib,
           "configs": []}
    try:
        for cap in [int(x) for x in args.max_cluster.split(",")]:
            for target in [int(x) for x in args.targets.split(",")]:
                pqr.ROWS_PER_BLOCK_TARGET, pqr.MAX_CLUSTER = target, cap
                row = {"target": target, "max_cluster": cap}
                for name, (run, _, key, _) in kernels.items():
                    rows = []
                    for M, a in panels.items():
                        if not agrees(torch, name, run(a), refs[name][M]):
                            print(f"{name} WRONG at M={M} target={target} "
                                  f"cap={cap}", flush=True)
                            return 1
                        rows.append({"M": M, "ms": cs.time_ms(
                            torch, lambda a=a: run(a), args.reps),
                            "cluster": pqr.launch_geometry(M, NB).cluster})
                    fit = cs.fit_against_m(rows)
                    dev = device_ms(torch, run, list(panels.values()), key)
                    total = sum(r["ms"] for r in rows)
                    row[name] = {"rows": rows, "sum_ms": total,
                                 "device_ms": dev, "fit": fit}
                    print(f"target {target:4d} cap {cap:2d} {name}: sum "
                          f"{total:8.3f} ms (cuSOLVER "
                          f"{sum(lib[name]):.3f}); top {rows[0]['ms']:.4f} "
                          f"ms, last {rows[-1]['ms']:.4f} ms; fit a = "
                          f"{fit['fixed_ms']:.4f} ms, b = "
                          f"{1e6 * fit['ms_per_row']:.4f} ns/row; device "
                          + (f"{sum(dev):.3f} ms" if dev else "not measured"),
                          flush=True)
                out["configs"].append(row)
    finally:
        pqr.ROWS_PER_BLOCK_TARGET, pqr.MAX_CLUSTER = keep
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "panel_cluster_sweep.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
