"""nSimplex base-simplex construction and apex projection.

PyTorch counterpart of ``repro.core.simplex``: the paper's inductive
algorithms as dense linear algebra.

  * base simplex  = Cholesky factor of the reference Gram matrix,
  * apex addition = batched lower-triangular solve + altitude.

The paper-faithful sequential oracles stay in the JAX package (they are
numpy); the tests hold this module to them.

Conventions match the paper: the base simplex of ``k`` references lives in
R^(k-1) as a lower-triangular matrix whose first row is the origin; an apex
has ``k`` coordinates, the last one being its altitude (non-negative).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class BaseSimplex(NamedTuple):
    """Base simplex over k reference objects.

    Attributes:
      chol:   (k-1, k-1) lower-triangular Cholesky factor L; row i are the
              coordinates of vertex i+1 (vertex 0 is the origin). NaN where
              the Gram matrix is not positive definite.
      diag_g: (k-1,) squared norms of vertices 1..k-1 (diagonal of the Gram
              matrix), cached for the apex solve.
      d0:     (k,) distances from reference 0 to every reference.
    """

    chol: Tensor
    diag_g: Tensor
    d0: Tensor

    @property
    def k(self) -> int:
        return self.chol.shape[0] + 1

    def vertices(self) -> Tensor:
        """(k, k-1) vertex coordinate matrix (paper's lower-triangular Sigma)."""
        zero = self.chol.new_zeros((1, self.chol.shape[0]))
        return torch.cat([zero, self.chol], dim=0)


def gram_from_distances(D: Tensor) -> Tensor:
    """Gram matrix of vertices 1..k-1 with vertex 0 at the origin.

    G_ij = (d(r0,ri)^2 + d(r0,rj)^2 - d(ri,rj)^2) / 2.
    """
    d0 = D[0, 1:]
    D2 = D[1:, 1:] ** 2
    return 0.5 * (d0[:, None] ** 2 + d0[None, :] ** 2 - D2)


def build_base_simplex(D: Tensor, *, jitter: float = 0.0) -> BaseSimplex:
    """Construct the base simplex from the (k, k) reference distance matrix.

    ``jitter`` (relative to the mean diagonal) regularises nearly degenerate
    reference sets. A Gram matrix that is not positive definite does not
    raise: its Cholesky factor comes back NaN, as ``jnp.linalg.cholesky``
    gives it, so :func:`simplex_is_degenerate` flags it.
    """
    acc = torch.promote_types(D.dtype, torch.float32)
    D = D.to(acc)
    G = gram_from_distances(D)
    if jitter:
        eye = torch.eye(G.shape[0], dtype=acc, device=G.device)
        G = G + jitter * torch.mean(torch.diagonal(G)) * eye
    L, info = torch.linalg.cholesky_ex(G)
    if int(info) != 0:
        L = torch.full_like(L, float("nan"))
    return BaseSimplex(chol=L, diag_g=torch.diagonal(G).clone(), d0=D[0, :])


def simplex_is_degenerate(base: BaseSimplex, *, rtol: float = 1e-5) -> bool:
    """True if the reference set spans fewer than k-1 dimensions (paper §7.2).

    Detected from the Cholesky diagonal: a (near-)zero or non-finite
    altitude at row i means reference i lies (almost) in the span of
    references 0..i-1.
    """
    d = torch.diagonal(base.chol)
    scale = torch.sqrt(torch.clamp_min(torch.max(base.diag_g), 1e-30))
    return bool(torch.any(~torch.isfinite(d)) or torch.any(d < rtol * scale))


def apex_project(base: BaseSimplex, dists: Tensor) -> Tensor:
    """Project a batch of objects into R^k from their reference distances.

    Args:
      base:  the fitted base simplex over k references.
      dists: (N, k) distances d(u_n, r_i) in the original space.

    Returns (N, k) apex coordinates; the last column is the altitude (>= 0).
    Solves L x = b with b_i = (d(u,r0)^2 + ||v_i||^2 - d(u,ri)^2) / 2 for the
    whole batch at once, then altitude = sqrt(max(d(u,r0)^2 - ||x||^2, 0)).
    """
    acc = torch.promote_types(dists.dtype, torch.float32)
    dists = dists.to(acc)
    if dists.ndim == 1:
        dists = dists[None, :]
    delta0_sq = dists[:, 0] ** 2
    b = 0.5 * (delta0_sq[:, None] + base.diag_g.to(acc)[None, :]
               - dists[:, 1:] ** 2)
    x = torch.linalg.solve_triangular(
        base.chol.to(acc), b.T, upper=False).T  # (N, k-1)
    alt_sq = delta0_sq - torch.sum(x * x, dim=-1)
    altitude = torch.sqrt(torch.clamp_min(alt_sq, 0.0))
    return torch.cat([x, altitude[:, None]], dim=-1)
