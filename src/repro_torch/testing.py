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


# -- the dense kernels against their plain versions --------------------------

#: pdist_sq and zen_estimate agree in squared space within SQ_RTOL x
#: (|x|^2 + |y|^2): both evaluate the f32 norm expansion, whose two sums
#: (norms, dot) round in another order on each path; their error is a few
#: 2^-24 of that scale per chunk of summed terms, ~1e-6 at m = 1000.
SQ_RTOL = 1e-5
#: jsd_pdist agrees on K = D^2 within JSD_KTOL absolute: K is one minus half
#: a difference of three f32 sums of m entropy terms (each sum at most
#: log2(m) + 1, ~11 at m = 1000), rounded in another order on each path.
JSD_KTOL = 1e-5
#: the distances themselves then agree within sqrt(tolerance), since
#: |sqrt(a) - sqrt(b)| <= sqrt(|a - b|): near D = 0 (close or identical
#: rows) the square root turns an error e in D^2 into up to sqrt(e) in D.

#: (N, K, m) shapes of the pdist_sq sweep: aligned, ragged everything, m
#: off the 32-column chunk, N or K of 1, and K <= 16 (the narrow tile)
PDIST_CASES = [(8, 8, 16), (128, 128, 512), (100, 37, 129), (256, 64, 1000),
               (1, 5, 3), (130, 257, 640), (1000, 16, 256), (777, 13, 33),
               (5, 1, 70)]
#: (N, K, m) shapes at the edges of pdist_sq's launch plans
#: (kernels/pdist.py::pdist_plan), in f32 and bf16: K = 16 (narrow tile),
#: 17 and 130 (output rows off 16 bytes: SIMT tile) and 20 (MMA plan); m %
#: 4 != 0 (f32: SIMT tile) and m % 8 != 0 (bf16: SIMT tile, f32: MMA plan
#: with a last k-step half zero fill); N or K of 1; m past one 32- or
#: 64-feature stage with a ragged last stage; ragged tiles of 128; more
#: tiles (160) than the persistent grid's blocks; and m = 4,096 (128 stages
#: of the MMA plan)
PDIST_PLAN_CASES = [(300, 16, 64), (300, 17, 64), (300, 20, 64),
                    (300, 130, 64), (200, 132, 70), (200, 132, 36),
                    (1, 300, 64), (300, 1, 64), (1, 132, 36), (300, 200, 12),
                    (300, 200, 40), (129, 260, 100), (2048, 1200, 32),
                    (256, 256, 4096)]
#: (N, M, k) shapes of the zen_estimate sweep, k in {1, 2, 16, 130}
ZEN_CASES = [(n, m, k) for k in (1, 2, 16, 130)
             for n, m in ((16, 16), (100, 300), (7, 1), (65, 129))]
#: (N, K, m) shapes of the jsd_pdist sweep
JSD_CASES = [(8, 8, 48), (64, 64, 256), (40, 100, 100), (16, 16, 48),
             (128, 128, 513), (333, 16, 256), (1, 7, 513)]


def dense_inputs(kind: str, shape, seed: int, dtype, device):
    """(X, Y) of one case of a dense sweep, drawn from ``seed`` with numpy:
    normal rows for "pdist", normal coordinates with a non-negative last
    column (an altitude) for "zen", l1-normalised rows for "jsd", a
    third of whose entries are zero (0 log 0), and for "near" rows of norm
    ~1,000 that all lie within ~0.03 of one another (the norm expansion
    cancels |x|^2 + |y|^2 ~ 2e6 down to distances ~1e-3)."""
    import torch

    n, k, m = shape
    rng = np.random.default_rng(seed)
    if kind == "jsd":
        X, Y = rng.uniform(size=(n, m)), rng.uniform(size=(k, m))
        X[rng.uniform(size=X.shape) < 1 / 3] = 0.0
        Y[rng.uniform(size=Y.shape) < 1 / 3] = 0.0
        X[:, 0] += 1e-3  # no all-zero row
        Y[:, 0] += 1e-3
        X, Y = X / X.sum(1, keepdims=True), Y / Y.sum(1, keepdims=True)
    elif kind == "near":
        base = rng.standard_normal(m)
        base *= 1e3 / np.linalg.norm(base)
        X = base + 1e-3 * rng.standard_normal((n, m))
        Y = base + 1e-3 * rng.standard_normal((k, m))
    else:
        X, Y = rng.standard_normal((n, m)), rng.standard_normal((k, m))
        if kind == "zen":
            X[:, -1], Y[:, -1] = np.abs(X[:, -1]), np.abs(Y[:, -1])

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    return tensor(X), tensor(Y)


def dense_errors(kind: str, X, Y, got, want):
    """(max error in squared space, max error on the distances, why they
    disagree or ``None``) of a dense kernel's output ``got`` against its
    plain version's ``want``. ``kind`` "pdist" compares squared distances
    as given; "zen" and "jsd" compare distances, squared for the check."""
    import torch

    got, want = got.double(), want.double()
    if got.shape != want.shape:
        return float("inf"), float("inf"), \
            f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}"
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return float("inf"), float("inf"), "a value is not finite"
    if kind == "pdist":
        sq, sq_want = got, want
        d_err = (got.sqrt() - want.sqrt()).abs().max()
    else:
        sq, sq_want = got * got, want * want
        d_err = (got - want).abs().max()
    if kind == "jsd":
        tol = torch.full_like(sq, JSD_KTOL)
    else:
        x2 = X.double().pow(2).sum(1)
        y2 = Y.double().pow(2).sum(1)
        tol = SQ_RTOL * (x2[:, None] + y2[None, :])
    err = (sq - sq_want).abs()
    bad = err > tol
    why = None
    if bad.any():
        r, c = (int(i) for i in torch.nonzero(bad)[0])
        why = (f"{int(bad.sum())} entries differ in squared space, first at "
               f"[{r}, {c}]: {float(sq[r, c])!r} vs "
               f"{float(sq_want[r, c])!r} (tolerance {float(tol[r, c]):.3g})")
    return float(err.max()) if err.numel() else 0.0, \
        float(d_err) if err.numel() else 0.0, why
