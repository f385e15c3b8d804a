"""Zen / Lwb / Upb estimators over nSimplex-projected coordinates (paper §4.1).

PyTorch counterpart of ``repro.core.zen``. For projected points x, y in R^k
(last coordinate = altitude), with full squared norms and the dot product
p over the first k-1 coordinates:

  Zen^2 = nx + ny - 2 p
  Lwb^2 = Zen^2 - 2 x_k y_k
  Upb^2 = Zen^2 + 2 x_k y_k

``knn_search`` takes the Hopper ``zen_topk`` kernel for every CUDA index.
On the CPU, ``chunk`` chooses between the plain streaming scan and the
dense (Q, N) path, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops

from .metrics import map_rows, fixed_sum

Tensor = torch.Tensor

MODES = ("zen", "lwb", "upb")


def _acc(x: Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _norms_and_dot(X: Tensor, Y: Tensor):
    acc = _acc(X)
    Xa, Ya = X.to(acc), Y.to(acc)
    nx = torch.sum(Xa * Xa, dim=-1)
    ny = torch.sum(Ya * Ya, dim=-1)
    p = Xa[:, :-1] @ Ya[:, :-1].T
    z2 = nx[:, None] + ny[None, :] - 2.0 * p
    return Xa, Ya, z2


def estimate_pdist(X: Tensor, Y: Tensor, mode: str = "zen") -> Tensor:
    """Pairwise estimator matrix (N, M) between projected X (N,k), Y (M,k)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    Xa, Ya, z2 = _norms_and_dot(X, Y)
    if mode != "zen":
        cross = torch.outer(Xa[:, -1], Ya[:, -1])
        z2 = z2 - 2.0 * cross if mode == "lwb" else z2 + 2.0 * cross
    return torch.sqrt(torch.clamp_min(z2, 0.0))


def estimate_pdist_rows(X: Tensor, Y: Tensor, mode: str = "zen") -> Tensor:
    """:func:`estimate_pdist` in a row-invariant form: row i has the same
    bits whatever other rows X holds. The serving path's coarse ranking and
    dense search use it.

    The estimators in their difference form, in float64 and rounded once:
    Zen^2 = |x' - y'|^2 + x_k^2 + y_k^2 over the first k-1 columns x', y',
    and Lwb^2 / Upb^2 with (x_k -/+ y_k)^2 for the altitude term (the norm
    expansion's value without its cancellation), summed by
    ``metrics.fixed_sum``.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    acc = _acc(X)
    f64 = torch.float64

    def block(a: Tensor, b: Tensor) -> Tensor:
        diff = a[:, None, :-1] - b[None, :, :-1]
        xa, ya = a[:, None, -1], b[None, :, -1]
        if mode == "zen":
            alt = xa * xa + ya * ya
        else:
            alt = xa - ya if mode == "lwb" else xa + ya
            alt = alt * alt
        return fixed_sum(diff * diff) + alt

    z2 = map_rows(block, X.to(f64), Y.to(f64), Y.shape[0] * X.shape[1])
    return torch.sqrt(z2).to(acc)


def zen_pdist(X: Tensor, Y: Tensor) -> Tensor:
    return estimate_pdist(X, Y, "zen")


def lwb_pdist(X: Tensor, Y: Tensor) -> Tensor:
    return estimate_pdist(X, Y, "lwb")


def upb_pdist(X: Tensor, Y: Tensor) -> Tensor:
    return estimate_pdist(X, Y, "upb")


def estimate_triple(X: Tensor, Y: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(lwb, zen, upb) evaluated as a triple sharing one matmul (paper §4.1)."""
    Xa, Ya, z2 = _norms_and_dot(X, Y)
    cross = 2.0 * torch.outer(Xa[:, -1], Ya[:, -1])

    def sq(a):
        return torch.sqrt(torch.clamp_min(a, 0.0))

    return sq(z2 - cross), sq(z2), sq(z2 + cross)


def _dense_topk(queries: Tensor, index: Tensor, n_neighbors: int,
                mode: str) -> Tuple[Tensor, Tensor]:
    """Dense path: full (Q, N) estimator matrix (row-invariant) + a stable
    ascending sort (``lax.top_k``'s tie order)."""
    d = estimate_pdist_rows(queries, index, mode)
    d, ids = torch.sort(d, dim=1, stable=True)
    return d[:, :n_neighbors], ids[:, :n_neighbors].to(torch.int32)


def knn_search(
    queries: Tensor,
    index: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    chunk: int = 0,
    *,
    scales: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Top-k nearest neighbours of ``queries`` in ``index`` under an estimator.

    Args:
      queries: (Q, k) projected queries.
      index:   (N, k) projected index, stored f32, bf16 or int8.
      chunk:   CPU only: if > 0 and the index is longer, stream it in blocks
               of this many rows (bounded memory) instead of the dense path.
      scales:  (N, 1) f32 per-row scales when ``index`` is int8.

    Returns (distances, indices), each (Q, n_neighbors), ascending.
    A CUDA index always goes through the fused Hopper kernel.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n_neighbors = min(n_neighbors, index.shape[0])
    if index.is_cuda or (chunk and index.shape[0] > chunk):
        return kernel_ops.zen_topk(queries, index, n_neighbors, mode,
                                   scales=scales, chunk=chunk or 4096)
    if scales is not None:  # dense path: dequantise once
        index = index.to(torch.float32) * scales.to(torch.float32)
    return _dense_topk(queries, index, n_neighbors, mode)
