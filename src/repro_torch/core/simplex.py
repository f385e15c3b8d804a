"""nSimplex base-simplex construction and apex projection.

PyTorch counterpart of ``repro.core.simplex``: the paper's inductive
algorithms as dense linear algebra.

  * base simplex  = Cholesky factor of the reference Gram matrix,
  * apex addition = batched lower-triangular solve + altitude.

The paper-faithful sequential oracles (Algorithms 1 and 2, numpy float64)
are kept here as their own copy of the JAX package's; the tests hold both
packages to them.

Conventions match the paper: the base simplex of ``k`` references lives in
R^(k-1) as a lower-triangular matrix whose first row is the origin; an apex
has ``k`` coordinates, the last one being its altitude (non-negative).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .metrics import fixed_dot

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


def _forward_substitute(L: Tensor, b: Tensor) -> Tensor:
    """Solve L x = b for each row of b (N, k-1), L lower-triangular.

    Column-oriented substitution as the reference BLAS ``trsm`` runs it:
    x_j = r_j / L_jj, then r_i -= x_j L_ij below, one column at a time (two
    elementwise launches a column). Every row goes through the same
    operations in the same order, so its bits do not depend on the batch,
    where a library solve picks its blocking by the number of right-hand
    sides.
    """
    r = b.clone()
    n = L.shape[0]
    cols = []
    for j in range(n):
        cols.append(r[:, j] / L[j, j])
        if j + 1 < n:
            r[:, j + 1:].addcmul_(cols[-1][:, None], L[j + 1:, j][None, :],
                                  value=-1.0)
    return torch.stack(cols, dim=1) if cols else r


def apex_project(base: BaseSimplex, dists: Tensor) -> Tensor:
    """Project a batch of objects into R^k from their reference distances.

    Args:
      base:  the fitted base simplex over k references.
      dists: (N, k) distances d(u_n, r_i) in the original space.

    Returns (N, k) apex coordinates; the last column is the altitude (>= 0).
    Solves L x = b with b_i = (d(u,r0)^2 + ||v_i||^2 - d(u,ri)^2) / 2 for the
    whole batch at once, then altitude = sqrt(max(d(u,r0)^2 - ||x||^2, 0)).

    Each row's result is independent of the other rows of the batch, bit
    for bit (see :func:`_forward_substitute`).
    """
    acc = torch.promote_types(dists.dtype, torch.float32)
    dists = dists.to(acc)
    if dists.ndim == 1:
        dists = dists[None, :]
    delta0_sq = dists[:, 0] ** 2
    b = 0.5 * (delta0_sq[:, None] + base.diag_g.to(acc)[None, :]
               - dists[:, 1:] ** 2)
    x = _forward_substitute(base.chol.to(acc), b)  # (N, k-1)
    alt_sq = delta0_sq - fixed_dot(x, x)
    altitude = torch.sqrt(torch.clamp_min(alt_sq, 0.0))
    return torch.cat([x, altitude[:, None]], dim=-1)


def verify_base_simplex(D: Tensor, base: BaseSimplex, *,
                        atol: float = 1e-4) -> Tuple[bool, float]:
    """Check that the pairwise vertex distances reproduce the reference
    distances ``D``: ``(ok, max abs error)``."""
    V = base.vertices()
    n2 = torch.sum(V ** 2, -1)
    d2 = n2[:, None] + n2[None, :] - 2 * V @ V.T
    # self-distances are definitionally zero; the matrix form leaves
    # O(eps*||v||^2) roundoff there, which sqrt would inflate
    d2 = d2 * (1.0 - torch.eye(d2.shape[0], dtype=d2.dtype,
                               device=d2.device))
    got = torch.sqrt(torch.clamp_min(d2, 0.0))
    err = float(torch.max(torch.abs(got - torch.as_tensor(
        D, dtype=got.dtype, device=got.device))))
    return err <= atol, err


# ---------------------------------------------------------------------------
# Paper-faithful oracles (Algorithms 1 and 2, sequential; numpy float64)
# ---------------------------------------------------------------------------


def nsimplex_build_reference(D: np.ndarray) -> np.ndarray:
    """Algorithm 1 (nSimplexBuild), the inductive construction.

    Args:
      D: (n+1, n+1) distance matrix among the reference points.

    Returns:
      Sigma: (n+1, n) lower-triangular vertex coordinate matrix.
    """
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0] - 1
    if n == 1:
        return np.array([[0.0], [D[0, 1]]])
    sigma_base = nsimplex_build_reference(D[:n, :n])  # (n, n-1)
    apex = apex_addition_reference(sigma_base, D[:n, n])  # (n,)
    sigma = np.zeros((n + 1, n))
    sigma[:n, : n - 1] = sigma_base
    sigma[n, :] = apex
    return sigma


def apex_addition_reference(sigma_base: np.ndarray,
                            distances: np.ndarray) -> np.ndarray:
    """Algorithm 2 (ApexAddition), the sequential loop.

    Args:
      sigma_base: (n, n-1) base simplex vertex matrix.
      distances:  (n,) distances from the unknown apex to each base vertex.

    Returns:
      (n,) apex coordinates; the last component is the (non-negative)
      altitude.
    """
    sigma_base = np.asarray(sigma_base, dtype=np.float64)
    distances = np.asarray(distances, dtype=np.float64)
    n = sigma_base.shape[0]
    out = np.zeros(n)
    out[0] = distances[0]
    for i in range(1, n):  # the paper's i = 2..n (1-indexed)
        base_row = np.zeros(n)
        base_row[: n - 1] = sigma_base[i]
        dist = np.linalg.norm(base_row - out)
        x = sigma_base[i, i - 1]
        y = out[i - 1]
        out[i - 1] = y - (distances[i] ** 2 - dist ** 2) / (2.0 * x)
        out[i] = np.sqrt(max(y ** 2 - out[i - 1] ** 2, 0.0))
    return out


def apex_project_reference(D_refs: np.ndarray,
                           dists: np.ndarray) -> np.ndarray:
    """Project a batch with the per-object loop of the paper (oracle)."""
    D_refs = np.asarray(D_refs, dtype=np.float64)
    k = D_refs.shape[0]
    sigma = nsimplex_build_reference(D_refs)  # (k, k-1)
    dists = np.atleast_2d(np.asarray(dists, dtype=np.float64))
    out = np.zeros((dists.shape[0], k))
    for idx in range(dists.shape[0]):
        out[idx] = apex_addition_reference(sigma, dists[idx])
    return out
