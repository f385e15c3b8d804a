"""Distance metrics over Hilbert-embeddable spaces (paper Appendix A).

PyTorch counterpart of ``repro.core.metrics``. Every metric is exposed as
``<name>_pdist(X, Y) -> (N, M)`` and through the registry
``get_metric(name)``. All pairwise computations accumulate in float32 (or
float64 for float64 inputs) even for bf16 inputs; TF32 is off package-wide.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor

_EPS = 1e-12


def _acc_dtype(x: Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _zero_diagonal(d2: Tensor) -> Tensor:
    # self-distances are definitionally zero; the matmul form leaves
    # O(eps*||x||^2) roundoff there, which sqrt inflates to O(sqrt(eps))
    eye = torch.eye(d2.shape[0], dtype=d2.dtype, device=d2.device)
    return d2 * (1.0 - eye)


def sqeuclidean_pdist(X: Tensor, Y: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances in the matmul form."""
    acc = _acc_dtype(X)
    Xa, Ya = X.to(acc), Y.to(acc)
    x2 = torch.sum(Xa ** 2, dim=-1)
    y2 = torch.sum(Ya ** 2, dim=-1)
    xy = Xa @ Ya.T
    d2 = x2[:, None] + y2[None, :] - 2.0 * xy
    if Y is X:
        d2 = _zero_diagonal(d2)
    return torch.clamp_min(d2, 0.0)


def euclidean_pdist(X: Tensor, Y: Tensor) -> Tensor:
    return torch.sqrt(sqeuclidean_pdist(X, Y))


def l2_normalize(X: Tensor, eps: float = _EPS) -> Tensor:
    n = torch.linalg.vector_norm(X, dim=-1, keepdim=True)
    return X / torch.clamp_min(n, eps)


def l1_normalize(X: Tensor, eps: float = _EPS) -> Tensor:
    """Project onto the probability simplex (for JSD / triangular)."""
    Xp = torch.clamp_min(X, 0.0)
    s = torch.sum(Xp, dim=-1, keepdim=True)
    return Xp / torch.clamp_min(s, eps)


def cosine_pdist(X: Tensor, Y: Tensor) -> Tensor:
    """Paper Eq. (11): Euclidean distance over L2-normalised vectors."""
    Xn = l2_normalize(X)
    Yn = Xn if Y is X else l2_normalize(Y)
    return euclidean_pdist(Xn, Yn)


def _h(x: Tensor) -> Tensor:
    """h(x) = -x log2(x), with 0 log 0 := 0 (paper Eq. 14)."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, -x * torch.log2(safe), torch.zeros_like(x))


def jsd_pdist(X: Tensor, Y: Tensor, *, assume_normalized: bool = False
              ) -> Tensor:
    """Jensen-Shannon distance (paper Eqs. 12-14).

    K(v, w) = 1 - 0.5 * sum_i [h(v_i) + h(w_i) - h(v_i + w_i)];  D = sqrt(K).
    """
    if not assume_normalized:
        X, Y = l1_normalize(X), l1_normalize(Y)
    acc = _acc_dtype(X)
    X, Y = X.to(acc), Y.to(acc)
    hx = torch.sum(_h(X), dim=-1)
    hy = torch.sum(_h(Y), dim=-1)
    cross = torch.sum(_h(X[:, None, :] + Y[None, :, :]), dim=-1)
    K = 1.0 - 0.5 * (hx[:, None] + hy[None, :] - cross)
    return torch.sqrt(torch.clamp_min(K, 0.0))


def triangular_pdist(X: Tensor, Y: Tensor, *,
                     assume_normalized: bool = False) -> Tensor:
    """Triangular distance (paper Eq. 15), cheap JSD estimator; 0/0 := 0."""
    if not assume_normalized:
        X, Y = l1_normalize(X), l1_normalize(Y)
    acc = _acc_dtype(X)
    Xa, Ya = X[:, None, :].to(acc), Y[None, :, :].to(acc)
    num = (Xa - Ya) ** 2
    den = Xa + Ya
    frac = torch.where(den > 0, num / torch.clamp_min(den, _EPS),
                       torch.zeros_like(num))
    return torch.sqrt(0.5 * torch.sum(frac, dim=-1))


def qform_pdist(X: Tensor, Y: Tensor, M: Tensor) -> Tensor:
    """Quadratic-form distance (paper Eq. 16) with PSD matrix ``M``.

    D(v,w)^2 = v'Mv + w'Mw - 2 v'Mw : three matmuls, no N*M*m intermediate.
    """
    acc = _acc_dtype(X)
    Xa, M = X.to(acc), M.to(acc)
    XM = Xa @ M
    Ya = Xa if Y is X else Y.to(acc)
    YM = XM if Y is X else Ya @ M
    xmx = torch.sum(XM * Xa, dim=-1)
    ymy = xmx if Y is X else torch.sum(YM * Ya, dim=-1)
    xmy = XM @ Ya.T
    d2 = xmx[:, None] + ymy[None, :] - 2.0 * xmy
    if Y is X:
        d2 = _zero_diagonal(d2)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def default_qform_matrix(m: int, *, rho: float = 0.5, device=None) -> Tensor:
    """Kac-Murdock-Szego matrix ``M[i, j] = rho^|i - j|`` (strictly PD),
    the registry ``qform`` metric's fixed form matrix."""
    idx = torch.arange(m, device=device)
    return rho ** (idx[:, None] - idx[None, :]).abs().to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    pdist: Callable[[Tensor, Tensor], Tensor]
    normalize: Optional[Callable[[Tensor], Tensor]]
    hilbert_embeddable: bool
    has_coordinates: bool  # False => only distance-based DR applies


def _qform_registry(X: Tensor, Y: Tensor) -> Tensor:
    return qform_pdist(X, Y, default_qform_matrix(X.shape[-1],
                                                  device=X.device))


_REGISTRY = {
    "euclidean": Metric("euclidean", euclidean_pdist, None, True, True),
    "sqeuclidean": Metric("sqeuclidean", sqeuclidean_pdist, None, False,
                          True),
    # callers pre-normalise: the pairwise function is plain euclidean
    "cosine": Metric("cosine", euclidean_pdist, l2_normalize, True, True),
    "jsd": Metric("jsd",
                  lambda X, Y: jsd_pdist(X, Y, assume_normalized=True),
                  l1_normalize, True, False),
    "triangular": Metric(
        "triangular",
        lambda X, Y: triangular_pdist(X, Y, assume_normalized=True),
        l1_normalize, True, False),
    "qform": Metric("qform", _qform_registry, None, True, True),
}


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def pairwise(name: str, X: Tensor, Y: Tensor) -> Tensor:
    """Normalise (if the metric requires it) and compute the pairwise matrix."""
    m = get_metric(name)
    if m.normalize is not None:
        Xn = m.normalize(X)
        Y = Xn if Y is X else m.normalize(Y)  # keep the self-pdist identity
        X = Xn
    return m.pdist(X, Y)


def self_pairwise(name: str, X: Tensor) -> Tensor:
    return pairwise(name, X, X)
