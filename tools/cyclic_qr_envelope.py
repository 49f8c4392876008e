#!/usr/bin/env python3
"""The CholeskyQR2 envelope of ``geqrf_cyclic``: each panel's Gram
condition number, pass by pass.

    python3 tools/cyclic_qr_envelope.py [--device cpu|cuda] [--k1] [M,N,nb ...]

For each M×N matrix (default 8192,8192,512 and 8192,4096,512; plrnt,
seed 3872, f32) on a 2×2 virtual mesh, ``parallel.cyclic.geqrf_cyclic``
runs (its products on K1 with ``--k1``, on the card) with ``blas.potrf``
watched: every Gram it factors (one process
column's; both columns factor the same values) is handed to a float64
``eigvalsh`` first, and the tool prints cond(G) of the shifted first
pass and of the second pass for every panel beside 1/u (negative where
the Gram as computed is indefinite), then whether the factor and T
stack came out finite. The second pass's Gram squares
the panel's condition, so a panel whose condition passes u^-1/2 (2896
in f32) takes a Gram that float32 cannot factor reliably: potrf returns
NaN there or not, as the rounding falls. The shift of the first pass,
11·(M·nb + nb(nb+1))·u·trace(G), exceeds trace(G) itself once M·nb·u
is near 0.1 (M = 8192, nb = 512 in f32: 5.8·trace), so that pass
conditions nothing. Writes ``chiprun_out/cyclic_qr_envelope.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def run(M, N, nb, device):
    import torch
    from dplasma_tpu_torch.descriptors import Dist
    from dplasma_tpu_torch.ops import generators
    from dplasma_tpu_torch.parallel import cyclic, mesh

    A = generators.plrnt(M, N, nb, nb, seed=3872, device=device)
    orig = cyclic.kb.potrf
    conds = []

    def watched(g, lower=True):
        e = torch.linalg.eigvalsh(g.double())
        conds.append(float(e[-1] / e[0]))
        return orig(g, lower)

    cyclic.kb.potrf = watched
    try:
        with mesh.use_grid(mesh.make_mesh(2, 2, device)):
            F, T = cyclic.geqrf_cyclic(
                cyclic.CyclicMatrix.from_tile(A, Dist(P=2, Q=2)))
    finally:
        cyclic.kb.potrf = orig
    # per panel: (column 0 pass 1, pass 2, column 1 pass 1, pass 2)
    panels = [{"panel": k // 4, "pass1": conds[k], "pass2": conds[k + 1]}
              for k in range(0, len(conds), 4)]
    finite = bool(torch.isfinite(T).all()) and all(
        bool(torch.isfinite(s).all()) for row in F.data for s in row)
    return {"M": M, "N": N, "nb": nb, "device": device, "panels": panels,
            "finite": finite}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("shapes", nargs="*",
                    default=["8192,8192,512", "8192,4096,512"])
    args = ap.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    inv_u = 1.0 / torch.finfo(torch.float32).eps
    if args.k1:
        from dplasma_tpu_torch.kernels import pallas_kernels as pk
        pk.enable(True)
    out = []
    for spec in args.shapes:
        M, N, nb = (int(x) for x in spec.split(","))
        r = run(M, N, nb, args.device)
        worst = max(abs(p["pass2"]) for p in r["panels"])
        print(f"{M}x{N} nb={nb} f32 on {args.device}"
              f"{' (K1)' if args.k1 else ''}: factor finite "
              f"{r['finite']}; second-pass cond(G) per panel "
              + " ".join(f"{p['pass2']:.2e}" for p in r["panels"])
              + f"; worst |cond| {worst:.2e} against 1/u = {inv_u:.2e}; "
              f"first "
              f"pass {min(p['pass1'] for p in r['panels']):.3f}–"
              f"{max(p['pass1'] for p in r['panels']):.3f}")
        out.append(dict(r, k1=args.k1))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "cyclic_qr_envelope.json", "w") as f:
        json.dump({"inv_u_f32": inv_u, "runs": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
