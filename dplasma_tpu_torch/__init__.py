"""dplasma_tpu_torch — the PyTorch/CUDA port of ``dplasma_tpu``.

Each module sits at the same relative path as the JAX module it ports
(``dplasma_tpu_torch/ops/potrf.py`` ports ``dplasma_tpu/ops/potrf.py``),
written in PyTorch's own idiom: plain functions on tensors, an explicit
``device=``, no jit. Every kernel the JAX package wrote in Pallas for
the TPU is a kernel written by hand for Hopper (``kernels/csrc``).

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Without CUDA, asking for the default device raises;
nothing falls back to the CPU quietly.

Precision rule: f32 products are full f32 — TF32 is switched off here,
the analogue of the JAX package's ``Precision.HIGHEST``
(dplasma_tpu/kernels/blas.py:27).
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for. Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (drivers: "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
