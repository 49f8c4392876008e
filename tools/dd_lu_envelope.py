#!/usr/bin/env python3
"""Backward error of the dd LU panel in both packages, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/dd_lu_envelope.py [m,nb ...]

For each (m, nb) panel (default 1024,256 2048,512 4096,1024), uniform in
[-0.5, 0.5) from a numpy seed as ``plrnt`` draws it, the f32 pivoted
seed of the column-prescaled panel is refined by ``lu_ir`` of
``dplasma_tpu`` (the reference, JAX with x64) and of
``dplasma_tpu_torch`` (the port, its plain limb products) from the SAME
seed and permutation, with 4 steps (the route's count) and with 8. It
prints max|pp - L U| / max|pp| for each, beside LAPACK's f64 LU of the
same panel (scipy) and the f32 seed, and max(|L||U|) / max|pp| (the
panel's growth), and writes ``chiprun_out/dd_lu_envelope.json``. Both
packages compute the same limb products, so a backward error that
stalls above LAPACK's in both is the route's envelope, and one that
stalls in the port alone is a fault of the port.

This is a comparison harness, like the parity tests: it imports both
packages. The reference's limb products are slow on the CPU (tens of
seconds a residual at 4096×1024).
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def backward(pp, L, U):
    import numpy as np
    return float(np.abs(pp - L @ U).max() / np.abs(pp).max())


def run(m: int, nb: int, seed: int = 3872) -> dict:
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import scipy.linalg
    import torch

    from dplasma_tpu.kernels import dd as ref_dd
    from dplasma_tpu_torch.kernels import dd
    from dplasma_tpu_torch.ops import lu

    a = np.random.default_rng(seed).uniform(-0.5, 0.5, (m, nb))
    # the route's column prescale and f32 seed (_panel_lu_dd's first half)
    d = (4.0 / dd._pow2_scale_bits(
        torch.from_numpy(np.abs(a).max(axis=0, keepdims=True)))).numpy()
    pan32, perm = lu._panel_lu(torch.from_numpy(a * d).float())
    perm = perm.numpy()
    pp = a[perm] * d
    L0 = np.tril(pan32.double().numpy(), -1)
    L0[:nb] += np.eye(nb)
    U0 = np.triu(pan32.double().numpy()[:nb])
    out = {"m": m, "nb": nb, "seed": seed,
           "growth": float((np.abs(L0) @ np.abs(U0)).max()
                           / np.abs(pp).max()),
           "f32_seed": backward(pp, L0, U0)}
    P, Ll, Ul = scipy.linalg.lu(a * d)
    out["lapack_f64"] = backward(P.T @ (a * d), Ll, Ul)
    for refine in (4, 8):
        t0 = time.perf_counter()
        wl, wu = ref_dd.lu_ir(jnp.asarray(pp), jnp.asarray(L0),
                              jnp.asarray(U0), refine=refine)
        wl, wu = np.asarray(wl), np.asarray(wu)
        t1 = time.perf_counter()
        gl, gu = dd.lu_ir(torch.from_numpy(pp), torch.from_numpy(L0),
                          torch.from_numpy(U0), refine=refine)
        gl, gu = gl.numpy(), gu.numpy()
        t2 = time.perf_counter()
        out[f"reference_refine{refine}"] = backward(pp, wl, wu)
        out[f"port_refine{refine}"] = backward(pp, gl, gu)
        out[f"port_vs_reference_refine{refine}"] = float(max(
            np.abs(gl - wl).max(), np.abs(gu - wu).max() / np.abs(wu).max()))
        out[f"seconds_refine{refine}"] = [t1 - t0, t2 - t1]
    return out


def main(argv) -> int:
    shapes = [tuple(int(v) for v in s.split(",")) for s in argv] or [
        (1024, 256), (2048, 512), (4096, 1024)]
    rows = []
    for m, nb in shapes:
        r = run(m, nb)
        rows.append(r)
        print(json.dumps(r), flush=True)
    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "dd_lu_envelope.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
