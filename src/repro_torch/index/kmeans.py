"""Batched Lloyd's k-means over apex coordinates — the IVF coarse quantizer.

PyTorch counterpart of ``repro.index.kmeans``. The assignment pass walks
the (N, k) coordinates in row chunks (one (chunk, C) distance block live
at a time, the tail chunk clamped back as in the JAX scan) and the update
is two ``index_add_`` segment sums.

Seeding is k-means++ D² sampling from a ``torch.Generator``; the draws are
not the JAX package's (``jax.random`` cannot be replayed), so
``kmeans_fit`` also takes explicit initial centroids, and a test hands it
the JAX ``_seed_plus_plus`` output to hold every Lloyd iterate to the
reference.

Tie rules kept from the reference: ``argmin`` takes the first minimum; the
empty-cluster reseed takes the farthest points in ``lax.top_k`` order
(descending, lower index first on ties) through a stable descending sort.
On the card ``index_add_`` adds with float atomics in a varying order, so
centroids agree with the reference to a tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _sq_dist(blk: Tensor, centroids: Tensor) -> Tensor:
    """Squared Euclidean distances (rows, C) between blk and centroids, f32."""
    bn = torch.sum(blk * blk, dim=1, keepdim=True)
    cn = torch.sum(centroids * centroids, dim=1)
    dot = blk @ centroids.T
    return torch.clamp_min(bn + cn[None, :] - 2.0 * dot, 0.0)


def _assign_pass(coords: Tensor, centroids: Tensor,
                 chunk: int) -> Tuple[Tensor, Tensor]:
    """(assignments (N,) int32, squared distance to own centroid (N,)).

    The tail chunk is clamped back to ``N - chunk`` and recomputes a few
    already-visited rows identically, as the JAX scan does.
    """
    n = coords.shape[0]
    chunk = min(chunk, n)
    assign = torch.zeros(n, dtype=torch.int32, device=coords.device)
    d2own = torch.zeros(n, dtype=torch.float32, device=coords.device)
    for i in range(-(-n // chunk)):
        start = min(i * chunk, n - chunk)
        d2 = _sq_dist(coords[start:start + chunk], centroids)
        m, a = torch.min(d2, dim=1)  # first minimum on ties, like argmin
        assign[start:start + chunk] = a.to(torch.int32)
        d2own[start:start + chunk] = m
    return assign, d2own


def _seed_plus_plus(coords: Tensor, n_clusters: int,
                    generator: torch.Generator) -> Tensor:
    """k-means++ D² seeding: one (N,) single-centroid distance pass per draw.

    All draws come from ``generator`` at once (on its own device) and are
    moved to the data, so the loop never waits on the host. Zero residual
    mass falls back to a floor weight of 1e-30 per row, as the reference's
    ``log(max(d2, 1e-30))`` logits do.
    """
    n, dev = coords.shape[0], coords.device
    first = torch.randint(n, (1,), generator=generator,
                          device=generator.device).to(dev)
    u = torch.rand(max(n_clusters - 1, 0), generator=generator,
                   device=generator.device, dtype=torch.float64).to(dev)
    cents = torch.zeros((n_clusters, coords.shape[1]), dtype=torch.float32,
                        device=dev)
    cents[0] = coords[first[0]]

    def min_d2_to(c: Tensor) -> Tensor:
        diff = coords - c[None, :]
        return torch.sum(diff * diff, dim=1)

    min_d2 = min_d2_to(cents[0])
    for i in range(1, n_clusters):
        cdf = torch.cumsum(torch.clamp_min(min_d2, 1e-30).double(), 0)
        idx = torch.searchsorted(cdf, u[i - 1:i] * cdf[-1], right=True)
        c = coords[torch.clamp_max(idx, n - 1)[0]]
        cents[i] = c
        min_d2 = torch.minimum(min_d2, min_d2_to(c))
    return cents


def kmeans_fit(
    coords: Tensor,
    n_clusters: int,
    *,
    generator: Optional[torch.Generator] = None,
    init: Optional[Tensor] = None,
    n_iters: int = 15,
    chunk: int = 16384,
) -> Tuple[Tensor, Tensor]:
    """Fit ``n_clusters`` centroids to (N, k) coordinates with Lloyd's method.

    Args:
      coords:     (N, k) points; the fit runs in f32 on their device.
      n_clusters: C, with 0 < C <= N.
      generator:  k-means++ seeding draws (seed 0 on the CPU when None).
      init:       (C, k) initial centroids instead of the seeding.
      n_iters:    Lloyd iterations.
      chunk:      row chunk of the assignment passes.

    Returns ``(centroids (C, k) f32, inertia ())``: the mean squared
    distance of every point to its nearest centroid at the last
    assignment pass.
    """
    n = coords.shape[0]
    if not 0 < n_clusters <= n:
        raise ValueError(f"need 0 < n_clusters <= N, got {n_clusters} for "
                         f"N={n}")
    x = coords.to(torch.float32)
    if init is not None:
        cents = init.to(device=x.device, dtype=torch.float32).clone()
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cents = _seed_plus_plus(x, n_clusters, generator)
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(n_iters):
        assign, d2own = _assign_pass(x, cents, chunk)
        a = assign.long()
        counts = torch.zeros(n_clusters, device=x.device).index_add_(
            0, a, ones)
        sums = torch.zeros_like(cents).index_add_(0, a, x)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # empty-cluster reseeding: the i-th empty cluster takes the i-th
        # farthest point from its current centroid
        empty = counts == 0.0
        far_ids = torch.sort(d2own, descending=True, stable=True).indices
        far_ids = far_ids[:min(n_clusters, n)]
        rank = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0,
                           far_ids.shape[0] - 1)
        cents = torch.where(empty[:, None], x[far_ids[rank]], new)
        inertia = torch.sum(d2own) / n
    return cents, inertia


def kmeans_assign(coords: Tensor, centroids: Tensor, *,
                  chunk: int = 16384) -> Tensor:
    """Nearest-centroid assignment (N,) int32 — the out-of-sample step."""
    assign, _ = _assign_pass(coords.to(torch.float32),
                             centroids.to(torch.float32), chunk)
    return assign
