"""CLI-compatible test/benchmark drivers (the reference's tests/ binaries).

Run as ``python -m dplasma_tpu_torch.drivers testing_spotrf -N 16384
-t 1024 -x`` (on the card; add ``--device cpu`` for the CPU). The
precision letter after ``testing_`` picks the dtype.
"""
from dplasma_tpu_torch.drivers.common import (PRECISIONS, Driver, IParam,
                                              parse_arguments, run_driver)
from dplasma_tpu_torch.drivers.testers import DRIVERS

__all__ = ["Driver", "IParam", "parse_arguments", "run_driver", "DRIVERS",
           "main"]


def main(argv=None, prog=None):
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    name = prog
    if name is None:
        if not args or args[0].startswith("-"):
            sys.stderr.write(
                "usage: python -m dplasma_tpu_torch.drivers "
                "testing_<prec><algo> [options]\n  algos: "
                + " ".join(sorted(DRIVERS)) + "\n")
            return 2
        name = args.pop(0)
    base = name.rsplit("/", 1)[-1]
    algo = base
    if base.startswith("testing_"):
        rest = base[8:]
        algo = rest[1:] if rest[:1] in PRECISIONS and rest[1:] else rest
    if algo not in DRIVERS:
        sys.stderr.write(f"unknown driver {base}; algos: "
                         + " ".join(sorted(DRIVERS)) + "\n")
        return 2
    return run_driver(base, DRIVERS[algo], args)
