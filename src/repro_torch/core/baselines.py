"""Baseline DR transforms the paper compares against (Section 3).

PyTorch counterpart of ``repro.core.baselines``:

* PCA  — witness-set economy SVD, top-k principal components (§3.2).
* RP   — Achlioptas sparse random projection, Eq. (2) (§3.1).
* MDS  — classical (Torgerson) MDS on a witness set, extended out of
         sample by the least-squares linear map from the witness
         coordinates to the embedding (§3.3).
* LMDS — Landmark MDS (de Silva & Tenenbaum), distance-only
         triangulation; applies to coordinate-free Hilbert spaces (§3.4).

Each follows ``NSimplexTransform``'s fit/transform protocol. SVD and eigh
choose eigenvector signs (and the order of near-equal eigenvalues) per
backend, so two correct fits may differ by a sign per column: compare them
by the distances of their projections, or carry a fitted state across with
``repro_torch.convert``. Everything is f32 on the witness set's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass
class PCATransform:
    k: int
    mean: Optional[Tensor] = None
    components: Optional[Tensor] = None  # (m, k)
    explained_variance: Optional[Tensor] = None  # (min(l, m),) all of them

    def fit(self, witness: Tensor) -> "PCATransform":
        W = witness.to(_F32)
        mean = torch.mean(W, dim=0)
        # economy SVD: components = right singular vectors
        _, s, vt = torch.linalg.svd(W - mean, full_matrices=False)
        var = s ** 2 / max(W.shape[0] - 1, 1)
        return dataclasses.replace(self, mean=mean,
                                   components=vt[:self.k].T.contiguous(),
                                   explained_variance=var)

    def transform(self, X: Tensor) -> Tensor:
        return (X.to(_F32) - self.mean) @ self.components

    def dims_for_variance(self, frac: float = 0.8) -> int:
        """Paper Eq. (3): #components explaining ``frac`` of the total
        variance, clamped to [1, n_eigenvalues] (an f32 cumsum can land a
        hair below 1.0)."""
        ev = self.explained_variance
        c = torch.cumsum(ev, 0) / torch.sum(ev)
        i = int(torch.searchsorted(c, torch.tensor([frac], dtype=c.dtype,
                                                   device=c.device))[0])
        return min(max(i + 1, 1), ev.shape[0])


@dataclasses.dataclass
class RandomProjection:
    """Achlioptas database-friendly RP (paper Eq. 2), scaled by 1/sqrt(k)."""

    k: int
    matrix: Optional[Tensor] = None  # (m, k)

    def fit(self, m_or_witness, *, generator: Optional[torch.Generator] = None,
            uniforms: Optional[Tensor] = None) -> "RandomProjection":
        """Draw the (m, k) matrix: +sqrt(3) where u < 1/6, -sqrt(3) where
        u >= 5/6, else 0, over (m, k) uniforms ``u`` in [0, 1) drawn from
        ``generator`` (on its device) or given (the reference's draws)."""
        if isinstance(m_or_witness, int):
            m, dev = m_or_witness, None
        else:
            m, dev = m_or_witness.shape[-1], m_or_witness.device
        if uniforms is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            uniforms = torch.rand((m, self.k), generator=generator,
                                  device=generator.device)
        u = uniforms.to(device=dev or uniforms.device, dtype=_F32)
        if u.shape != (m, self.k):
            raise ValueError(f"need ({m}, {self.k}) uniforms, got "
                             f"{tuple(u.shape)}")
        vals = math.sqrt(3.0) * ((u < 1.0 / 6.0).to(_F32)
                                 - (u >= 5.0 / 6.0).to(_F32))
        return dataclasses.replace(self,
                                   matrix=vals / math.sqrt(float(self.k)))

    def transform(self, X: Tensor) -> Tensor:
        return X.to(_F32) @ self.matrix


def classical_mds_embed(D: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Torgerson MDS: embed an (l, l) distance matrix into R^k.

    Returns (coords (l, k), eigenvalues (k,) descending, mean squared
    distance of each row (l,)).
    """
    D = D.to(_F32)
    l = D.shape[0]
    D2 = D ** 2
    J = (torch.eye(l, dtype=_F32, device=D.device)
         - torch.full((l, l), 1.0 / l, dtype=_F32, device=D.device))
    B = -0.5 * J @ D2 @ J
    evals, evecs = torch.linalg.eigh(B)  # ascending
    evals = torch.flip(evals, (0,))[:k]
    evecs = torch.flip(evecs, (1,))[:, :k]
    coords = evecs * torch.sqrt(torch.clamp_min(evals, 0.0))[None, :]
    return coords, evals, torch.mean(D2, dim=1)


@dataclasses.dataclass
class MDSTransform:
    """Classical MDS + linear out-of-sample map (Euclidean domains, §3.3)."""

    k: int
    mean: Optional[Tensor] = None
    linear: Optional[Tensor] = None  # (m, k) least-squares map
    stress_coords: Optional[Tensor] = None  # witness embedding

    def fit(self, witness: Tensor, D: Optional[Tensor] = None
            ) -> "MDSTransform":
        W = witness.to(_F32)
        if D is None:
            n2 = torch.sum(W ** 2, 1)
            D = torch.sqrt(torch.clamp_min(
                n2[:, None] + n2[None, :] - 2 * W @ W.T, 0.0))
        coords, _, _ = classical_mds_embed(D, self.k)
        mean = torch.mean(W, dim=0)
        # pseudo-inverse least-squares map R^m -> R^k (Procrustes + pinv)
        linear = torch.linalg.pinv(W - mean) @ coords
        return dataclasses.replace(self, mean=mean, linear=linear,
                                   stress_coords=coords)

    def transform(self, X: Tensor) -> Tensor:
        return (X.to(_F32) - self.mean) @ self.linear


@dataclasses.dataclass
class LMDSTransform:
    """Landmark MDS (distance-only; works on coordinate-free spaces).

    fit: classical MDS over the (l, l) landmark distance matrix.
    transform: for an object with squared landmark distances delta (l,),
      x = -0.5 * pinv_coords @ (delta - mean_delta), where
      pinv_coords_j = evec_j / sqrt(eval_j) (de Silva & Tenenbaum 2004).
    """

    k: int
    pinv_coords: Optional[Tensor] = None  # (k, l)
    mean_sq: Optional[Tensor] = None  # (l,)
    landmarks: Optional[Tensor] = None

    def fit_from_distances(self, D: Tensor) -> "LMDSTransform":
        coords, evals, mean_sq = classical_mds_embed(D, self.k)
        # Directions whose eigenvalue is numerically zero against the
        # spectrum's head carry no metric information and are dropped:
        # dividing by the raw near-zero eigenvalue would give ~1/eps
        # triangulation rows whenever l ~ k.
        tiny = 1e-6 * torch.clamp_min(torch.max(evals), 1e-12)
        safe = torch.maximum(evals, tiny)
        pinv = torch.where(evals[None, :] > tiny, coords / safe[None, :],
                           torch.zeros_like(coords)).T.contiguous()
        return dataclasses.replace(self, pinv_coords=pinv, mean_sq=mean_sq)

    def transform_from_distances(self, dists: Tensor) -> Tensor:
        """dists: (N, l) object-to-landmark distances (not squared)."""
        d2 = dists.to(_F32) ** 2
        return -0.5 * (d2 - self.mean_sq[None, :]) @ self.pinv_coords.T
