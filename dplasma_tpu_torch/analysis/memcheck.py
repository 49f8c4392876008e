"""The lowmem tiers' working-set inequality.

Ports the part of ``dplasma_tpu/analysis/memcheck.py`` that the port's
out-of-HBM tiers need: :func:`lowmem_blocking` (:755-791), copied line
for line so the port's ``(nb, cw)`` equal the reference's for every
(op, N, itemsize, budget). The residency analysis, ``lowmem_plan`` and
``simulate_stream`` come with ROADMAP queue 1 item 15.
"""
from __future__ import annotations


def lowmem_blocking(op: str, N: int, itemsize: float,
                    budget_bytes: int, nb: int = 512,
                    align: int = 32) -> dict:
    """The device-resident bytes per panel step of a lowmem tier, and
    the blocking that keeps them within ``budget_bytes``:

    * ``potrf`` — one (N, nb) panel + one (N, cw) streamed chunk +
      update temporaries (~two more panels): ``N*(cw + 3*nb) <=
      budget``. Returns ``{"nb", "cw"}`` with ``nb = min(512,
      cols//4)`` and ``cw`` the remainder.
    * ``getrf`` — one full (N, nb) column + one (<=N, cw) streamed
      block + panel temporaries: ``cw`` is the largest nb-multiple
      with ``3*N*cw*item <= budget``. Returns ``{"nb", "cw"}``.
    * ``geqrf`` — one (N, nb) column + one streamed (V, T) pair +
      apply temporaries (~3 panels): ``nb`` shrinks to the largest
      ``align``-multiple with ``3*N*nb*item <= budget``. Returns
      ``{"nb", "cw": nb}``.
    """
    item = float(itemsize)
    if op == "potrf":
        per_col = N * item
        cols = max(int(budget_bytes // per_col), 4)
        nbp = max(min(512, cols // 4), 1)
        cw = max(cols - 3 * nbp, nbp)
        return {"nb": nbp, "cw": cw}
    if op == "getrf":
        cw = max(int(budget_bytes / (3 * N * item)) // nb * nb, nb)
        return {"nb": nb, "cw": cw}
    if op == "geqrf":
        fit = max(align,
                  int(budget_bytes / (3 * N * item)) // align * align)
        nbq = min(nb, fit)
        return {"nb": nbq, "cw": nbq}
    raise ValueError(f"lowmem_blocking: unknown op {op!r}")
