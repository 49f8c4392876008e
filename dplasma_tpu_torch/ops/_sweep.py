"""Pipeline shape of the factorization sweeps.

Ports ``sweep_params`` of ``dplasma_tpu/ops/_sweep.py`` (:44-53). The
pipelined engine (``pipelined_sweep``) waits for the LU slice.
"""
from __future__ import annotations

from dplasma_tpu_torch.utils import config as _cfg


def sweep_params(lookahead=None, agg_depth=None):
    """Resolve the pipeline shape: explicit args win, else MCA
    ``sweep.lookahead`` / ``qr.agg_depth``. Returns (lookahead >= 0,
    agg_depth >= 1)."""
    la = _cfg.mca_get_int("sweep.lookahead", 1) \
        if lookahead is None else int(lookahead)
    d = _cfg.mca_get_int("qr.agg_depth", 1) \
        if agg_depth is None else int(agg_depth)
    return max(la, 0), max(d, 1)
