"""Principled base-simplex (pivot) selection: the ``pivots=`` strategies.

PyTorch counterpart of ``repro.core.pivots``. The strategies read a witness
*distance matrix*, never raw coordinates, so they work in coordinate-free
spaces (jsd, qform, ... any ``core.metrics`` entry):

  random          the paper's baseline; delegates to
                  ``core.projection.select_references``;
  kmeanspp        D^2 sampling: each next pivot drawn with probability
                  proportional to its squared distance to the nearest
                  chosen one;
  farthest_first  the deterministic greedy k-center traversal from the
                  maximum-eccentricity witness;
  maxvol          greedy simplex-volume growth: after the farthest pair,
                  each next pivot is the witness of largest altitude over
                  the current base simplex (``core.simplex.apex_project``).

The greedy loops run on the host in float64 numpy, as in the reference,
and break ties to the lowest index (numpy argmax), so given the same
matrix ``farthest_first`` and ``maxvol`` choose the reference's ids. The
draws of ``random`` and ``kmeanspp`` come from a ``torch.Generator`` or are
handed in (``draws``): ``jax.random`` streams cannot be replayed in torch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import metrics as metrics_lib
from . import projection as projection_lib
from . import simplex as simplex_lib

Tensor = torch.Tensor

#: the pivot-selection menu (the ``pivots=`` knob takes exactly these)
PIVOT_STRATEGIES = ("random", "kmeanspp", "farthest_first", "maxvol")

#: witness subsample cap for the O(n^2) distance-matrix strategies
MAX_WITNESS = 2048


def check_strategy(strategy: str) -> None:
    """Raise ValueError on an unknown pivot strategy (single menu owner)."""
    if strategy not in PIVOT_STRATEGIES:
        raise ValueError(
            f"unknown pivot strategy {strategy!r}; expected one of "
            + "/".join(PIVOT_STRATEGIES))


def _as_dist(D) -> np.ndarray:
    """A writable float64 host copy of an (n, n) matrix (tensor or array);
    the greedy loops mutate their working copies in place."""
    if isinstance(D, torch.Tensor):
        D = D.detach().cpu().numpy()
    D = np.array(D, np.float64)
    n = D.shape[0]
    if D.shape != (n, n):
        raise ValueError(f"need a square distance matrix, got {D.shape}")
    return D


def farthest_first_indices(D, k: int) -> np.ndarray:
    """Deterministic farthest-first traversal over a (n, n) distance matrix.

    Starts at the maximum-eccentricity row (largest mean distance to the
    rest), then greedily appends ``argmax_x min_{p in chosen} D[x, p]``.
    Ties break to the lowest index.
    """
    D = _as_dist(D)
    chosen = [int(np.argmax(D.mean(axis=1)))]
    mind = D[:, chosen[0]].copy()
    while len(chosen) < k:
        mind[chosen] = -np.inf
        nxt = int(np.argmax(mind))
        chosen.append(nxt)
        mind = np.minimum(mind, D[:, nxt])
    return np.asarray(chosen, np.int64)


def kmeanspp_indices(D, k: int, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[int]] = None) -> np.ndarray:
    """k-means++ (D^2) pivot sampling over a (n, n) distance matrix.

    The first pivot is uniform; each next one is drawn with probability
    proportional to its squared distance to the nearest chosen pivot. A
    degenerate all-zero tail (duplicate witnesses) takes the first unchosen
    index, and a draw that is already chosen takes the argmax, as in the
    reference. The draws come from ``generator`` (a CPU generator; seed 0
    when ``None``), or are given: ``draws[i]`` is step i's drawn index
    (the reference's ``jax.random`` draws, for parity), and the rules
    above still apply to it.
    """
    D = _as_dist(D)
    n = D.shape[0]
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(0)

    def draw(step: int, p: Optional[np.ndarray]) -> int:
        if draws is not None:
            return int(draws[step])
        if p is None:
            return int(torch.randint(n, (), generator=generator))
        return int(torch.multinomial(torch.from_numpy(p), 1,
                                     generator=generator))

    chosen = [draw(0, None)]
    d2 = D[:, chosen[0]] ** 2
    while len(chosen) < k:
        d2[chosen] = 0.0
        total = float(d2.sum())
        if total <= 0.0:  # duplicates everywhere: deterministic fill
            taken = set(chosen)
            chosen.append(next(i for i in range(n) if i not in taken))
        else:
            nxt = draw(len(chosen), d2 / total)
            if nxt in set(chosen):
                nxt = int(np.argmax(d2))
            chosen.append(nxt)
        d2 = np.minimum(d2, D[:, chosen[-1]] ** 2)
    return np.asarray(chosen, np.int64)


def maxvol_indices(D, k: int, *, jitter: float = 0.0) -> np.ndarray:
    """Greedy max-volume pivots via the apex projection's own altitude.

    Seeds with the globally farthest pair, then repeatedly builds the base
    simplex of the chosen set (``core.simplex.build_base_simplex``, f32 on
    the CPU as the reference builds it), projects every witness onto it,
    and appends the witness with the largest altitude. Fully deterministic.
    """
    D = _as_dist(D)
    n = D.shape[0]
    if k == 1:
        return np.asarray([int(np.argmax(D.mean(axis=1)))], np.int64)
    flat = int(np.argmax(D))
    chosen = sorted({flat // n, flat % n})
    if len(chosen) == 1:  # all-duplicate corner: any second point
        chosen.append((chosen[0] + 1) % n)
    while len(chosen) < k:
        sub = torch.as_tensor(D[np.ix_(chosen, chosen)], dtype=torch.float32)
        base = simplex_lib.build_base_simplex(sub, jitter=jitter)
        coords = simplex_lib.apex_project(
            base, torch.as_tensor(D[:, chosen], dtype=torch.float32))
        alt = coords[:, -1].numpy().astype(np.float64)
        alt[~np.isfinite(alt)] = -np.inf
        alt[chosen] = -np.inf
        nxt = int(np.argmax(alt))
        if not np.isfinite(alt[nxt]):  # every altitude collapsed: keep the
            taken = set(chosen)        # ids distinct regardless
            nxt = next(i for i in range(n) if i not in taken)
        chosen.append(nxt)
    return np.asarray(chosen, np.int64)


def select_pivot_indices(D, k: int, strategy: str, *,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Sequence[int]] = None,
                         jitter: float = 0.0) -> np.ndarray:
    """Dispatch: (n, n) witness distance matrix -> (k,) pivot row indices.

    ``generator`` or ``draws`` feed the stochastic strategies and are
    ignored by the deterministic ones: for ``random`` the draws are the k
    ids themselves, for ``kmeanspp`` each step's drawn index.
    """
    check_strategy(strategy)
    D = _as_dist(D)
    n = D.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n={n} pivots, got k={k}")
    if strategy == "random":
        if draws is not None:
            return np.asarray(draws, np.int64)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return torch.randperm(n, generator=generator)[:k].numpy()
    if strategy == "kmeanspp":
        return kmeanspp_indices(D, k, generator=generator, draws=draws)
    if strategy == "farthest_first":
        return farthest_first_indices(D, k)
    return maxvol_indices(D, k, jitter=jitter)


def pivot_ids(X: Tensor, k: int, *, strategy: str,
              metric: str = "euclidean", max_witness: int = MAX_WITNESS,
              jitter: float = 0.0,
              generator: Optional[torch.Generator] = None,
              witness_ids: Optional[Sequence[int]] = None,
              draws: Optional[Sequence[int]] = None) -> np.ndarray:
    """Chosen pivot *row ids into X* for a strategy.

    Subsamples the witness set to ``max_witness`` rows (``witness_ids``, or
    sorted draws from ``generator``), builds the metric's pairwise matrix
    once on X's device, and maps the local selection back to row ids.
    """
    check_strategy(strategy)
    n = X.shape[0]
    if witness_ids is not None:
        wit = np.asarray(witness_ids, np.int64)
    elif n > max_witness:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        wit = np.sort(torch.randperm(n, generator=generator)[:max_witness]
                      .numpy())
    else:
        wit = np.arange(n, dtype=np.int64)
    m = metrics_lib.get_metric(metric)
    W = X[torch.as_tensor(wit, device=X.device)]
    if m.normalize is not None:
        W = m.normalize(W)
    D = _as_dist(m.pdist(W, W))
    np.fill_diagonal(D, 0.0)
    local = select_pivot_indices(D, k, strategy, generator=generator,
                                 draws=draws, jitter=jitter)
    return wit[local]


def select_references(X: Tensor, k: int, *, metric: str = "euclidean",
                      strategy: str = "random",
                      max_witness: int = MAX_WITNESS, jitter: float = 0.0,
                      max_tries: int = 8,
                      generator: Optional[torch.Generator] = None,
                      ids: Optional[Sequence[int]] = None
                      ) -> projection_lib.NSimplexTransform:
    """Strategy-aware ``core.projection.select_references``.

    ``ids`` fits exactly those rows. ``strategy="random"`` delegates to the
    redraw loop of ``core.projection``; the principled strategies pick
    pivots from a witness distance matrix (:func:`pivot_ids`) and fit, and
    fall back to the random redraw loop should the simplex still be
    degenerate (duplicate witnesses, rank-deficient corpora).
    """
    check_strategy(strategy)
    if ids is not None or strategy == "random":
        return projection_lib.select_references(
            X, k, ids=ids, generator=generator, metric=metric,
            max_tries=max_tries, jitter=jitter)
    idx = pivot_ids(X, k, strategy=strategy, metric=metric,
                    max_witness=max_witness, jitter=jitter,
                    generator=generator)
    tr = projection_lib.NSimplexTransform(k=k, metric=metric,
                                          jitter=jitter).fit(
        X[torch.as_tensor(idx, device=X.device)])
    if tr.degenerate():
        return projection_lib.select_references(
            X, k, generator=generator, metric=metric, max_tries=max_tries,
            jitter=jitter)
    return tr
