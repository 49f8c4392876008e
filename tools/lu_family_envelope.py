#!/usr/bin/env python3
"""The -x residuals of the LU-family drivers in both packages, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/lu_family_envelope.py [--quick]

Runs each configuration through the reference's driver
(``dplasma_tpu.drivers.main``, JAX with x64) and the port's
(``dplasma_tpu_torch.drivers.main`` with ``--device cpu``) on the same
seeded matrices, and prints one JSON line per run with both ``|b-Ax|``
residuals (the gate is 60): zgetrf under ``dd_gemm=always`` (the complex
``trsm_f64`` is a Newton inverse from a c64 seed), dgetrf_incpiv under
dd and natively, sgetrf_incpiv at growing N, and getrf_qrf under its
forced criteria. A residual over 60 in both packages is the algorithm's
envelope, not a fault of the port. ``--quick`` drops the runs that take
the reference minutes. The record goes to
``chiprun_out/lu_family_envelope.json``.

This is a comparison harness, like the parity tests: it imports both
packages.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (driver, argv, MCA overrides, slow for the reference)
RUNS = [
    ("testing_zgetrf", ["-N", "1024", "-t", "512"], {"dd_gemm": "always"},
     True),
    ("testing_zgetrf", ["-N", "1024", "-t", "256"], {"dd_gemm": "always"},
     True),
    ("testing_dgetrf_incpiv", ["-N", "1024", "-t", "512"],
     {"dd_gemm": "always"}, False),
    ("testing_dgetrf_incpiv", ["-N", "2048", "-t", "512"],
     {"dd_gemm": "always"}, False),
    ("testing_dgetrf_incpiv", ["-N", "2048", "-t", "512"], {}, False),
    ("testing_sgetrf_incpiv", ["-N", "2048", "-t", "512"], {}, False),
    ("testing_sgetrf_incpiv", ["-N", "4096", "-t", "512"], {}, False),
    ("testing_sgetrf_incpiv", ["-N", "8192", "-t", "512"], {}, True),
    ("testing_sgetrf_qrf", ["-N", "100", "-t", "32", "-K", "2",
                            "--criteria", "3"], {}, False),
    ("testing_dgetrf_qrf", ["-N", "100", "-t", "32", "-K", "2",
                            "--criteria", "3"], {}, False),
    ("testing_dgetrf_qrf", ["-N", "100", "-t", "32", "-K", "2",
                            "--criteria", "0"], {}, False),
    ("testing_zgetrf_qrf", ["-N", "100", "-t", "32", "-K", "2",
                            "--criteria", "3"], {}, False),
]


def _residual(runner, argv):
    """Run one driver with -x, its stdout captured: (residual, rc,
    seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = runner(argv + ["-x", "--nowarmup"])
    secs = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if "|b-Ax|" in ln and "residual" in ln]
    return float(lines[-1].rsplit("=", 1)[1]), rc, secs


def main(argv) -> int:
    import jax
    jax.config.update("jax_enable_x64", True)
    from dplasma_tpu.drivers import main as ref_main
    from dplasma_tpu.utils import config as ref_cfg
    from dplasma_tpu_torch.drivers import main as port_main
    from dplasma_tpu_torch.utils import config as cfg

    quick = "--quick" in argv
    rows = []
    for prog, args, mca, slow in RUNS:
        if quick and slow:
            continue
        with ref_cfg.override_scope(mca):
            ref = _residual(lambda a: ref_main([prog] + a), args)
        with cfg.override_scope(mca):
            port = _residual(lambda a: port_main([prog] + a
                                                 + ["--device", "cpu"]),
                             args)
        row = {"driver": prog, "argv": args, "mca": mca,
               "reference": ref[0], "port": port[0],
               "reference_rc": ref[1], "port_rc": port[1],
               "seconds": [ref[2], port[2]]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)
    (dst / "lu_family_envelope.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
