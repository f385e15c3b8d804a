"""Tie-aware comparison of top-k results, for the tests and the smoke run.

Two correct top-k searches over the same data may disagree where two
candidates' distances tie within float noise: their order, or which one
fills the last slot, can swap. ``topk_mismatch`` accepts exactly those
swaps and nothing else.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def topk_mismatch(d, ids, d_ref, ids_ref, *, rtol: float,
                  atol: float) -> Optional[str]:
    """Why (d, ids) is not the top-k (d_ref, ids_ref) up to near-ties, or
    ``None`` when it is.

    Distances must agree slot by slot within ``atol + rtol * |d_ref|``.
    Where the ids differ, the id found must either sit elsewhere in the
    reference row at a distance within that tolerance of this slot, or be
    absent from it with a distance that ties the reference's last slot.
    """
    d, ids, d_ref, ids_ref = map(_np, (d, ids, d_ref, ids_ref))
    if d.shape != d_ref.shape or ids.shape != ids_ref.shape:
        return f"shapes differ: {d.shape}/{ids.shape} vs {d_ref.shape}"
    close = np.isclose(d, d_ref, rtol=rtol, atol=atol)
    if not close.all():
        r, c = np.argwhere(~close)[0]
        return (f"{int((~close).sum())} distances differ, first at "
                f"[{r}, {c}]: {d[r, c]!r} vs {d_ref[r, c]!r}")
    for r in range(ids.shape[0]):
        live = ids[r][ids[r] >= 0]
        if live.size != np.unique(live).size:
            return f"row {r} repeats an id: {ids[r]}"
        for c in np.flatnonzero(ids[r] != ids_ref[r]):
            tol = atol + rtol * abs(d_ref[r, c])
            where = np.flatnonzero(ids_ref[r] == ids[r, c])
            if where.size:
                ok = abs(d_ref[r, where[0]] - d_ref[r, c]) <= tol
            else:
                ok = d[r, c] >= d_ref[r, -1] - tol
            if not ok:
                return (f"row {r} slot {c}: id {ids[r, c]} instead of "
                        f"{ids_ref[r, c]} is not a near-tie "
                        f"(d {d[r, c]!r}, reference {d_ref[r, c]!r})")
    return None
