"""Build the hand-written CUDA kernels at first use and load them.

Each source under ``csrc/`` has a plain C interface and compiles with
``nvcc`` alone (no PyTorch headers) into a shared library under
``build/dplasma_tpu_torch/`` at the root of the checkout, named by a
hash of its source and flags, so an unchanged kernel is built once. The
library is loaded with ``ctypes``; wrappers pass every pointer and the
stream as ``c_void_p``. A failed build raises with nvcc's stderr.

:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "dplasma_tpu_torch"

#: kernel name -> source file under csrc/ (``host_copy`` is no kernel:
#: the lowmem tiers' pitched host copy, ``kernels/hostlink.py``)
SOURCES = {"gemm": "gemm.cu", "recombine": "recombine.cu",
           "lu_panel": "lu_panel.cu", "geqrt_panel": "geqrt_panel.cu",
           "ring": "ring.cu", "tridiag_bisect": "tridiag_bisect.cu",
           "sbr_window": "sbr_window.cu", "host_copy": "host_copy.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: kernel name -> ptxas report (registers, shared memory, spills)
BUILD_LOG: dict = {}

_LIBS: dict = {}


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the default
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return nvcc


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every kernel in ``names`` (default: all) that is not
    built yet, one nvcc process per source, all started together.
    Returns {name: seconds} for the ones compiled here."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    took = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]} "
                            f"(exit {proc.returncode}):\n{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
