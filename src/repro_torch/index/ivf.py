"""Index helpers of ``repro.index.ivf`` that the flat serving path uses.

The clustered index (``IVFZenIndex``) is not ported yet; what is here are
the id checks every mutable layout shares and the exact re-rank.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import metrics as metrics_lib

Tensor = torch.Tensor


def _check_ids(ids: np.ndarray) -> None:
    """Reject ids the int32 id layout cannot represent (``-1`` is the dead
    slot; an id above int32 max would wrap negative)."""
    if ids.size == 0:
        return
    if ids.min() < 0:
        raise ValueError("ids must be non-negative (-1 marks padding)")
    if ids.max() > np.iinfo(np.int32).max:
        raise ValueError(
            f"ids must fit int32 (max {np.iinfo(np.int32).max}), "
            f"got {ids.max()}")


def _dedupe_last_wins(
    ids: np.ndarray, rows: Tensor
) -> Tuple[np.ndarray, Tensor]:
    """Drop duplicate ids within an upsert batch, keeping the last
    occurrence of each (relative order otherwise preserved)."""
    _, first_of_rev = np.unique(ids[::-1], return_index=True)
    keep = np.sort(ids.size - 1 - first_of_rev)
    return ids[keep], rows[torch.as_tensor(keep, device=rows.device)]


def _batched_pdist(name: str, q: Tensor, c: Tensor) -> Tensor:
    """(Q, C) distances between each query (Q, m) and its own candidates
    (Q, C, m) under the metric's pairwise function (inputs normalised).

    The Euclidean family uses the norm expansion of ``sqeuclidean_pdist``
    batched over queries; any other metric calls its pairwise function
    once per query.
    """
    if name in ("euclidean", "sqeuclidean", "cosine"):
        x2 = torch.sum(q * q, dim=-1)[:, None]              # (Q, 1)
        y2 = torch.sum(c * c, dim=-1)                       # (Q, C)
        xy = torch.bmm(c, q[:, :, None])[..., 0]            # (Q, C)
        d2 = torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)
        return d2 if name == "sqeuclidean" else torch.sqrt(d2)
    m = metrics_lib.get_metric(name)
    return torch.stack([m.pdist(q[i:i + 1], c[i])[0]
                        for i in range(q.shape[0])])


def exact_rerank(
    queries: Tensor,
    corpus: Tensor,
    cand_ids: Tensor,
    n_neighbors: int,
    *,
    metric: str = "euclidean",
) -> Tuple[Tensor, Tensor]:
    """Refine a (Q, C) candidate pool with true distances.

    Gathers the candidates' original vectors, scores them exactly under
    ``metric`` and returns the best ``n_neighbors``, ascending, in
    ``lax.top_k``'s tie order (a stable sort). Padding candidates
    (id == -1) are masked to +inf and never returned unless the pool holds
    fewer than ``n_neighbors`` valid candidates.
    """
    m = metrics_lib.get_metric(metric)
    safe_ids = torch.clamp_min(cand_ids, 0).long()
    cands = corpus[safe_ids]                              # (Q, C, m)
    qn = m.normalize(queries) if m.normalize is not None else queries
    cn = m.normalize(cands) if m.normalize is not None else cands
    d = _batched_pdist(metric, qn.to(torch.float32), cn.to(torch.float32))
    d = torch.where(cand_ids >= 0, d, torch.full_like(d, float("inf")))
    n_neighbors = min(n_neighbors, cand_ids.shape[1])
    d, pos = torch.sort(d, dim=1, stable=True)
    return d[:, :n_neighbors], torch.gather(cand_ids, 1, pos[:, :n_neighbors])
