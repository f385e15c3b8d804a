"""Quality measures for DR transforms (paper §5.1 and Appendix E).

PyTorch counterpart of ``repro.core.quality``. The measures take flat
arrays (numpy or tensors, on any device) of original distances ``delta``
and reduced distances ``zeta`` over the same sampled object pairs (i < j),
except the kNN-recall DCG, which takes ranked id lists. They run on the
host in float64 numpy, as in the reference: ``kruskal_stress``'s
pool-adjacent-violators regression is sequential, and these are
evaluation-only paths. ``pairwise_sample`` and ``flatten_upper`` pick the
pairs, in ``torch.triu_indices``'s row-major order (``jnp.triu_indices``'s).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64).ravel()


def _pava(y: np.ndarray, w: Optional[np.ndarray] = None) -> np.ndarray:
    """Least-squares isotonic (non-decreasing) fit; O(n) pool-adjacent-
    violators."""
    y = np.asarray(y, np.float64)
    n = y.shape[0]
    w = np.ones(n) if w is None else np.asarray(w, np.float64)
    means = y.copy()
    weights = w.copy()
    starts = np.arange(n)
    ends = np.arange(n)
    top = 0  # stack pointer over blocks
    for i in range(1, n):
        top += 1
        means[top] = y[i]
        weights[top] = w[i]
        starts[top] = i
        ends[top] = i
        while top > 0 and means[top - 1] > means[top]:
            tot = weights[top - 1] + weights[top]
            means[top - 1] = (weights[top - 1] * means[top - 1]
                              + weights[top] * means[top]) / tot
            weights[top - 1] = tot
            ends[top - 1] = ends[top]
            top -= 1
    out = np.empty(n)
    for b in range(top + 1):
        out[starts[b]:ends[b] + 1] = means[b]
    return out


def isotonic_fit(zeta, delta) -> np.ndarray:
    """Kruskal disparities d*: the least-squares monotone fit of ``zeta``
    in the order of ``delta`` (paper Eq. 4 / Eq. 30), in input order. A
    zeta that is any monotone function of delta is fitted exactly."""
    zeta = _host64(zeta)
    delta = _host64(delta)
    order = np.argsort(delta, kind="stable")
    fit_sorted = _pava(zeta[order])
    out = np.empty_like(fit_sorted)
    out[order] = fit_sorted
    return out


def kruskal_stress(delta, zeta) -> float:
    """Kruskal stress-1 (paper Eq. 4 / Eq. 30)."""
    delta, zeta = _host64(delta), _host64(zeta)
    d_star = isotonic_fit(zeta, delta)
    denom = np.sum(zeta ** 2)
    if denom <= 0:
        return float("inf")
    return float(np.sqrt(np.sum((zeta - d_star) ** 2) / denom))


def sammon_stress(delta, zeta, eps: float = 1e-12) -> float:
    """Sammon stress (paper Eq. 31)."""
    delta, zeta = _host64(delta), _host64(zeta)
    safe = np.maximum(delta, eps)
    return float(np.sum((delta - zeta) ** 2 / safe)
                 / np.maximum(np.sum(delta), eps))


def quadratic_loss(delta, zeta) -> float:
    """Quadratic loss (paper Eq. 32)."""
    delta, zeta = _host64(delta), _host64(zeta)
    return float(np.sum((delta - zeta) ** 2))


def _tie_averaged_ranks(a: np.ndarray) -> np.ndarray:
    """1-indexed ranks where tied values share the mean of their ranks
    (``scipy.stats.spearmanr``'s "average")."""
    order = np.argsort(a, kind="stable")
    ranks = np.empty(a.size, np.float64)
    ranks[order] = np.arange(1, a.size + 1, dtype=np.float64)
    _, inv, counts = np.unique(a, return_inverse=True, return_counts=True)
    sums = np.zeros(counts.size, np.float64)
    np.add.at(sums, inv, ranks)
    return sums[inv] / counts[inv]


def spearman_rho(delta, zeta) -> float:
    """Spearman rank correlation over sampled pairwise distances (Eq. 33),
    as the Pearson correlation of tie-averaged ranks. NaN for fewer than
    two pairs or a constant input."""
    delta, zeta = _host64(delta), _host64(zeta)
    if delta.shape[0] < 2:
        return float("nan")
    dr = _tie_averaged_ranks(delta)
    zr = _tie_averaged_ranks(zeta)
    dr -= dr.mean()
    zr -= zr.mean()
    denom = math.sqrt(float(np.sum(dr * dr)) * float(np.sum(zr * zr)))
    if denom == 0.0:
        return float("nan")
    return float(np.sum(dr * zr) / denom)


# -- kNN recall as logistic-relevance DCG (paper Appendix E.3) ---------------


def rank_relevance(i, n: int = 1000) -> np.ndarray:
    """Paper Eq. (34): inverse-sigmoid relevance of the i-th true neighbour
    (1-indexed), midpoint n/2 and width n/10."""
    i = np.asarray(i, np.float64)
    return 1.0 - 1.0 / (1.0 + np.exp(-(i - n / 2.0) / (n / 10.0)))


def _ids(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def dcg_recall(true_ids, approx_ids) -> float:
    """Paper Eq. (35), normalised to [0, 1] by the perfect DCG.

    Args:
      true_ids:   (n,) ids of the true nearest neighbours, best first.
      approx_ids: (n,) ids returned by the DR-space search, best first.
    """
    true_ids = _ids(true_ids).ravel()
    approx_ids = _ids(approx_ids).ravel()
    n = true_ids.shape[0]
    pos_in_true = {int(t): i + 1 for i, t in enumerate(true_ids)}
    i = np.arange(1, n + 1, dtype=np.float64)
    discount = np.log2(i + 1.0)
    # a miss lands at rank 2n, deep past the sigmoid cliff (relevance ~0)
    ranks = np.array([pos_in_true.get(int(a), 2 * n) for a in approx_ids],
                     np.float64)
    dcg = np.sum((np.power(2.0, rank_relevance(ranks, n)) - 1.0) / discount)
    ideal = np.sum((np.power(2.0, rank_relevance(i, n)) - 1.0) / discount)
    return float(dcg / ideal)


def batch_dcg_recall(true_ids, approx_ids) -> float:
    """Mean DCG recall over a batch of queries: (Q, n) id arrays."""
    return float(np.mean([dcg_recall(t, a) for t, a in
                          zip(_ids(true_ids), _ids(approx_ids))]))


def recall_at_k(true_ids, approx_ids) -> float:
    """Set-overlap recall@k meaned over queries: |true ∩ approx| / k, with
    (Q, k) or (k,) ``true_ids``; order is ignored and negative ids (padding
    slots) never count as hits."""
    true_ids = np.atleast_2d(_ids(true_ids))
    approx_ids = np.atleast_2d(_ids(approx_ids))
    if true_ids.shape[0] != approx_ids.shape[0]:
        raise ValueError(f"query counts differ: {true_ids.shape} vs "
                         f"{approx_ids.shape}")
    k = true_ids.shape[1]
    if k == 0:
        return 0.0
    hits = [len(set(t.tolist()) & set(a[a >= 0].tolist()))
            for t, a in zip(true_ids, approx_ids)]
    return float(np.mean(hits) / k)


# -- normalised quality profiles (paper Appendix E.4) ------------------------


def quality_profile(delta, zeta, *, qmax: Optional[float] = None
                    ) -> Dict[str, float]:
    """All pairwise-distance measures normalised into [0, 1] (1 = perfect)."""
    k = kruskal_stress(delta, zeta)
    s = sammon_stress(delta, zeta)
    q = quadratic_loss(delta, zeta)
    rho = spearman_rho(delta, zeta)
    out = {
        "kruskal": float(np.clip(1.0 - k, 0.0, 1.0)),
        "sammon": float(np.clip(1.0 - s, 0.0, 1.0)),
        "spearman": float(np.clip(rho, 0.0, 1.0)),
        "quadratic_raw": q,
    }
    if qmax is not None and qmax > 0:
        out["quadratic"] = float(np.clip((qmax - q) / qmax, 0.0, 1.0))
    return out


def pairwise_sample(X: Tensor, n_objects: int, *,
                    generator: Optional[torch.Generator] = None,
                    ids: Optional[Sequence[int]] = None
                    ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Sample ``n_objects`` rows (``ids``, or distinct draws from a CPU
    ``generator``, seed 0 when ``None``) and return (subset,
    upper-triangular index pairs (rows, cols))."""
    if ids is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        ids = torch.randperm(X.shape[0], generator=generator)[
            :min(n_objects, X.shape[0])]
    sub = X[torch.as_tensor(ids, device=X.device)]
    iu = torch.triu_indices(sub.shape[0], sub.shape[0], 1, device=X.device)
    return sub, (iu[0], iu[1])


def flatten_upper(D: Tensor) -> Tensor:
    """The strict upper triangle of a square matrix, row by row."""
    iu = torch.triu_indices(D.shape[0], D.shape[0], 1, device=D.device)
    return D[iu[0], iu[1]]
