#!/usr/bin/env python3
"""Where K1's tensor-core kernel spends its time, on the card.

    python3 tools/k1_diagnose.py

Builds ``dplasma_tpu_torch/kernels/csrc/gemm.cu`` four times into
``build/k1_diagnose/`` (listed in ``.gitignore``): as it is, without the
split pass (the ``stage_tile`` calls), without the tensor-core pass (the
``wgmma`` batch of each tile) and without both (TMA and the pipeline
alone). The variants compute wrong values; they only time parts of the
kernel. Each is timed on the same products through the K1 wrapper (CUDA
events, mean of 5 after one warm-up), beside ``torch.matmul``; then the
host time of one small K1 call and of one ``torch.matmul`` call (wall
clock over 300 calls enqueued back to back). Prints one line per product
and writes ``chiprun_out/k1_diagnose.json``.
"""
from __future__ import annotations

import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PRODUCTS = [  # M, K, N, A as a transposed view, B as a b.T view
    (15360, 1024, 1024, False, True),
    (8192, 8192, 1024, False, True),
    (2048, 8192, 2048, True, False),
]


def variants(src: str) -> dict:
    """{name: source}: the kernel with parts taken out."""
    split = re.compile(r"    stage_tile<T, A_K>\(raw_a\(s\), hl_a\(i & 1\), t\);"
                       r"\n    stage_tile<T, B_K>\(raw_b\(s\), hl_b\(i & 1\), "
                       r"t\);\n")
    mma = re.compile(r"(    asm volatile\(\"wgmma.fence.sync.aligned;\" ::: "
                     r"\"memory\"\);\n).*?(    asm volatile\(\"wgmma"
                     r".commit_group)", re.S)
    if not split.search(src) or not mma.search(src):
        raise SystemExit("k1_diagnose: gemm.cu no longer has the split "
                         "and wgmma blocks this tool takes out")
    no_split = split.sub("", src)
    return {"full": src, "no_split": no_split,
            "no_mma": mma.sub(r"\1\2", src),
            "tma_only": mma.sub(r"\1\2", no_split)}


def build(torch) -> dict:
    from dplasma_tpu_torch.kernels import _build, pallas_kernels as pk
    out = ROOT / "build" / "k1_diagnose"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gemm.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu = out / f"gemm_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"libgemm_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k1_diagnose: nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(out / f"libgemm_{name}.so")).dtt_k1_gemm
        fn.argtypes = [ctypes.POINTER(pk._K1Args)]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps=300):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_diagnose: CUDA is not available", file=sys.stderr)
        return 1
    from dplasma_tpu_torch.kernels import pallas_kernels as pk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    fns = build(torch)
    shipped = pk._kernel()

    def via(fn, a, b):
        pk._FNS["gemm"] = fn
        try:
            return pk.gemm(a, b)
        finally:
            pk._FNS["gemm"] = shipped

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for M, K, N, a_t, b_t in PRODUCTS:
        a = torch.randn(K, M, device="cuda", generator=g).T if a_t \
            else torch.randn(M, K, device="cuda", generator=g)
        b = torch.randn(N, K, device="cuda", generator=g).T if b_t \
            else torch.randn(K, N, device="cuda", generator=g)
        row = {"M": M, "K": K, "N": N, "a_t": a_t, "b_t": b_t,
               "ms": {name: time_ms(torch, lambda f=fn: via(f, a, b))
                      for name, fn in fns.items()},
               "matmul_ms": time_ms(torch, lambda: torch.matmul(a, b)),
               "bound_3xtf32_ms": 1e3 * 3 * 2.0 * M * N * K / 495e12}
        rows.append(row)
        print(f"{M}x{K}x{N}: " + "  ".join(
            f"{k} {v:.3f}" for k, v in row["ms"].items())
            + f"  matmul {row['matmul_ms']:.3f}  3xTF32 bound "
            f"{row['bound_3xtf32_ms']:.3f} ms", flush=True)
    a = torch.randn(256, 256, device="cuda", generator=g)
    b = torch.randn(256, 256, device="cuda", generator=g)
    host = {"k1_256": host_us(torch, lambda: pk.matmul(a, b)),
            "matmul_256": host_us(torch, lambda: torch.matmul(a, b))}
    print(f"host per call, 256x256x256: K1 {host['k1_256']:.1f} us, "
          f"torch.matmul {host['matmul_256']:.1f} us")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "k1_diagnose.json", "w") as f:
        json.dump({"nvidia_smi": smi, "products": rows, "host_us": host},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
