"""Batched Lloyd's k-means over apex coordinates — the IVF coarse quantizer.

PyTorch counterpart of ``repro.index.kmeans``. The assignment pass walks
the (N, k) coordinates in row chunks (one (chunk, C) distance block live
at a time, the tail chunk clamped back as in the JAX scan) and the update
sums each cluster's members with :func:`segment_sums`.

Seeding is k-means++ D² sampling from a ``torch.Generator``; the draws are
not the JAX package's (``jax.random`` cannot be replayed), so
``kmeans_fit`` also takes explicit initial centroids, and a test hands it
the JAX ``_seed_plus_plus`` output to hold every Lloyd iterate to the
reference.

Tie rules kept from the reference: ``argmin`` takes the first minimum; the
empty-cluster reseed takes the farthest points in ``lax.top_k`` order
(descending, lower index first on ties) through a stable descending sort.

A fit is the same bytes every time on one device: no sum of the fit adds
in an order that follows thread timing. The Lloyd update sums in an order
fixed by the data (:func:`segment_sums`, in place of ``index_add_``, whose
float atomics add in arrival order on the card) and the seeding's
cumulative weights come from :func:`prefix_sums` (a 1-D CUDA ``cumsum`` is
a decoupled look-back scan, whose association order follows the blocks'
timing). The sums are float64, rounded once to f32, so centroids agree
with the reference's f32 segment sums to a tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

#: rows one fixed-shape partial sum of :func:`segment_sums` adds, and the
#: row length of :func:`prefix_sums`' two-level scan
FOLD = 256


def segment_sums(rows: Tensor, labels: Tensor,
                 n_segments: int) -> Tuple[Tensor, Tensor]:
    """Per-label sums and counts of (N, width) ``rows``, in an order fixed
    by the data.

    Returns ``(sums (n_segments, width) float64, counts (n_segments,)
    int64)``; an empty label sums to zero. The rows are sorted stably by
    label, so each label's rows form one run in their input order. Each
    level cuts every run into pieces of at most :data:`FOLD` rows from the
    run's start, writes each piece into its own zero-filled (FOLD, width)
    slot and sums the slots over their rows, one reduction of one shape;
    the levels repeat until every run is one row. No two writes share a
    slot, so the bits follow the rows and labels alone.
    """
    width, dev = rows.shape[1], rows.device
    labels = labels.to(torch.long)
    counts = torch.bincount(labels, minlength=n_segments)
    order = torch.argsort(labels, stable=True)
    x = rows[order].to(torch.float64)
    lab, lengths = labels[order], counts
    while x.shape[0] and int(lengths.max()) > 1:
        starts = torch.cumsum(lengths, 0) - lengths
        pos = torch.arange(x.shape[0], device=dev) - starts[lab]
        pieces = torch.div(lengths + (FOLD - 1), FOLD, rounding_mode="floor")
        first = torch.cumsum(pieces, 0) - pieces
        slot = first[lab] + torch.div(pos, FOLD, rounding_mode="floor")
        buf = torch.zeros((int(pieces.sum()), FOLD, width),
                          dtype=torch.float64, device=dev)
        buf[slot, pos % FOLD] = x
        x = buf.sum(dim=1)
        lab = torch.repeat_interleave(
            torch.arange(n_segments, device=dev), pieces)
        lengths = pieces
    sums = torch.zeros((n_segments, width), dtype=torch.float64, device=dev)
    sums[lab] = x
    return sums, counts


def prefix_sums(w: Tensor) -> Tensor:
    """Inclusive float64 prefix sums of a 1-D tensor, in an order fixed by
    its length.

    Each row of a zero-padded (rows, :data:`FOLD`) view is scanned on its
    own, then the row totals, as two equal rows of a (2, rows) tensor, and
    each row's carry is the total of the rows before it. A scan along the
    last axis of a tensor of two or more rows is a block scan of each row,
    whose order is fixed; a 1-D tensor would take the look-back scan.
    """
    n = w.shape[0]
    rows = max(2, -(-n // FOLD))
    v = torch.nn.functional.pad(w.to(torch.float64), (0, rows * FOLD - n))
    inner = torch.cumsum(v.reshape(rows, FOLD), dim=1)
    tot = inner[:, -1]
    carried = torch.cumsum(torch.stack([tot, tot]), dim=1)[0]
    carry = torch.cat([torch.zeros_like(tot[:1]), carried[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


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
        cdf = prefix_sums(torch.clamp_min(min_d2, 1e-30))
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
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(n_iters):
        assign, d2own = _assign_pass(x, cents, chunk)
        sums, counts = segment_sums(x, assign, n_clusters)
        new = (sums / torch.clamp_min(counts, 1)[:, None]).to(torch.float32)
        # empty-cluster reseeding: the i-th empty cluster takes the i-th
        # farthest point from its current centroid
        empty = counts == 0
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
