"""Pipeline shape and engine of the factorization sweeps.

Ports ``sweep_params``, ``pipelined_sweep`` and ``assemble_sweep`` of
``dplasma_tpu/ops/_sweep.py`` (:44-171), without the phase spans
(ROADMAP queue 1 item 14). ``dag_pipelined`` waits for item 15.

The right-looking sweeps (getrf, getrf_nopiv) keep the trailing
submatrix as a fresh tensor per step and stitch the packed factor
together at the end. :func:`pipelined_sweep` is the lookahead engine
(Kurzak & Dongarra's tiled LU lookahead): at step k the next panel's
block column is updated first by a narrow apply, then the rest of the
trailing matrix by one wide apply, so the chain panel -> column update
-> panel does not wait for the wide product. ``lookahead=0`` is the
serialized sweep's exact op order.
"""
from __future__ import annotations

import torch

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


def pipelined_sweep(rest, bw: int, KT: int, NT: int, panel, apply_block,
                    *, lookahead: int = 1, agg_depth: int = 1,
                    agg_apply=None):
    """Drive a right-looking shrinking-window sweep with lookahead
    column peeling and (optionally) aggregated far updates.

    ``panel(col) -> (pack, state)`` factors one ``bw``-wide column
    block (full current window height); ``apply_block(state, blk) ->
    (top, rest)`` applies one panel's transform to a column block,
    returning the finished top ``bw`` rows and the updated remainder
    (the window shrinks by ``bw`` rows); ``agg_apply(states, far) ->
    (tops, far')`` applies ``len(states)`` consecutive panels to the
    far block in one flush. Without ``agg_apply``, ``agg_depth`` is 1
    (per-step far updates).

    Invariants: columns in the lookahead window are current through
    every factored panel; the far block is current through the last
    flush; a column peeled from far mid-window is caught up by
    replaying the pending states. Returns ``(packs, urows)`` in
    :func:`assemble_sweep` layout.
    """
    la = max(int(lookahead), 0)
    d = max(int(agg_depth), 1) if agg_apply is not None else 1
    packs = []
    pieces: list[dict] = [dict() for _ in range(KT)]
    pending: list[tuple] = []          # [(step, state)] not yet on far
    ahead: list[list] = []             # [[col index, block], ...]
    far = rest
    far_col = 0                        # first column-block index in far

    def peel():
        nonlocal far, far_col
        w = min(bw, far.shape[1])
        blk = far[:, :w]
        far = far[:, w:]
        idx = far_col
        far_col += 1
        for s, st in pending:          # catch up to the window
            top, blk = apply_block(st, blk)
            pieces[s][idx] = top
        return [idx, blk]

    for _ in range(min(1 + la, NT)):   # window: panel + la columns
        ahead.append(peel())

    for kk in range(KT):
        _, c = ahead.pop(0)
        pack, st = panel(c)
        packs.append(pack)
        pending.append((kk, st))
        for slot in ahead:             # narrow lookahead-column updates
            top, slot[1] = apply_block(st, slot[1])
            pieces[kk][slot[0]] = top
        if len(pending) >= d or kk == KT - 1:   # far flush
            if far.shape[1]:
                if agg_apply is not None and len(pending) > 1:
                    tops, far = agg_apply([s for _, s in pending], far)
                    for (s, _), top in zip(pending, tops):
                        pieces[s][far_col] = top
                else:
                    for s, st in pending:
                        top, far = apply_block(st, far)
                        pieces[s][far_col] = top
            pending.clear()
        while len(ahead) < 1 + la and far.shape[1] > 0:
            ahead.append(peel())       # refill the window

    urows = []
    for kk in range(KT):
        ps = [pieces[kk][i] for i in sorted(pieces[kk])]
        urows.append(ps[0] if len(ps) == 1 else
                     torch.cat(ps, dim=1) if ps else packs[kk][:bw, :0])
    return packs, urows


def assemble_sweep(packs, urows, KT: int, NT: int, nb: int, reorder=None):
    """Stitch per-step panel columns and finished row slabs into the
    global packed factor. ``packs[k]`` is step k's factored panel
    column (top nb rows final), ``urows[k]`` the finished nb-row slab
    right of it. ``reorder``, when given, maps a column-block index to
    the row-gather indices of its below-diagonal part (deferred
    pivoting)."""
    outcols = []
    for kk in range(NT):
        pieces = [urows[j][:, (kk - j - 1) * nb:(kk - j) * nb]
                  for j in range(min(kk, KT))]
        if kk < KT:
            pan = packs[kk]
            pieces.append(pan[:nb])
            if pan.shape[0] > nb:
                pieces.append(pan[nb:] if reorder is None
                              else pan[reorder(kk)])
        outcols.append(pieces[0] if len(pieces) == 1
                       else torch.cat(pieces, dim=0))
    return torch.cat(outcols, dim=1)
