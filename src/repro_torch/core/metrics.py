"""Distance metrics over Hilbert-embeddable spaces (paper Appendix A).

PyTorch counterpart of ``repro.core.metrics``. Every metric is exposed as
``<name>_pdist(X, Y) -> (N, M)`` and through the registry
``get_metric(name)``. All pairwise computations accumulate in float32 (or
float64 for float64 inputs) even for bf16 inputs; TF32 is off package-wide.

Row-invariant forms. A served query row must come out with the same bits
whatever batch it rides in, as the JAX package's do. A matmul does not
promise that: the library picks its kernel, blocking and split of the
inner dimension by the row count, so the same row's dot products round
differently at Q = 2 and Q = 64. ``Metric.rows`` is each metric's pairwise
function written with elementwise products and ``fixed_sum`` /
``fixed_dot`` (``kernels.scoring``): a pairwise tree of elementwise adds
in float64 whose order depends on the summed length alone, so every entry
depends only on its own two rows, on the CPU and on the card. The query
projection uses it; the fit and the evaluation keep the matmul forms.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels.scoring import fixed_dot, fixed_sum

Tensor = torch.Tensor

_EPS = 1e-12


def _acc_dtype(x: Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


#: elements of one (rows, K, m) product block of the row-invariant forms
#: (256 MiB of f64 products): longer inputs go through in row chunks
ROW_BLOCK_ELEMS = 1 << 25


def _row_chunks(n_rows: int, per_row: int):
    """Row slices of at most ``ROW_BLOCK_ELEMS // per_row`` rows."""
    step = max(1, ROW_BLOCK_ELEMS // max(per_row, 1))
    return [slice(lo, min(lo + step, n_rows))
            for lo in range(0, n_rows, step)] or [slice(0, 0)]


def map_rows(fn, X: Tensor, Y: Tensor, per_row: int) -> Tensor:
    """``fn(X[rows], Y)`` over row chunks of X, concatenated."""
    out = [fn(X[s], Y) for s in _row_chunks(X.shape[0], per_row)]
    return torch.cat(out) if len(out) > 1 else out[0]


def row_dot(X: Tensor, Y: Tensor) -> Tensor:
    """(N, m) x (K, m) -> (N, K) dot products, each a :func:`fixed_sum` of
    its elementwise products (row-invariant; chunked over the rows of X)."""
    return map_rows(lambda a, b: fixed_dot(a[:, None, :], b[None, :, :]),
                     X, Y, Y.shape[0] * X.shape[1])


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


def _sqeuclidean_block(X: Tensor, Y: Tensor) -> Tensor:
    diff = X[:, None, :] - Y[None, :, :]  # exact in f64 for f32 inputs
    return fixed_sum(diff * diff)


def sqeuclidean_rows(X: Tensor, Y: Tensor) -> Tensor:
    """Squared Euclidean distances, row-invariant: the sum of squared
    differences taken in float64 (each difference and square exact for
    f32 inputs) and rounded once, so it is also free of the norm
    expansion's cancellation. A dozen elementwise launches a block."""
    f64 = torch.float64
    return map_rows(_sqeuclidean_block, X.to(f64), Y.to(f64),
                     Y.shape[0] * X.shape[1]).to(_acc_dtype(X))


def euclidean_pdist(X: Tensor, Y: Tensor) -> Tensor:
    return torch.sqrt(sqeuclidean_pdist(X, Y))


def euclidean_rows(X: Tensor, Y: Tensor) -> Tensor:
    return torch.sqrt(sqeuclidean_rows(X, Y))


def l2_normalize(X: Tensor, eps: float = _EPS) -> Tensor:
    n = torch.sqrt(fixed_dot(X, X))[..., None]
    return X / torch.clamp_min(n, eps)


def l1_normalize(X: Tensor, eps: float = _EPS) -> Tensor:
    """Project onto the probability simplex (for JSD / triangular)."""
    Xp = torch.clamp_min(X, 0.0)
    s = fixed_sum(Xp)[..., None]
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


def _h_rows(x: Tensor) -> Tensor:
    """:func:`_h` in float64 (for :func:`fixed_sum`): a vectorised f32
    log2 and its scalar tail loop can differ by an ulp, and which elements
    fall in the tail depends on the tensor's size."""
    x = x.to(torch.float64)
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, -x * torch.log2(safe), torch.zeros_like(x))


def jsd_rows(X: Tensor, Y: Tensor) -> Tensor:
    """:func:`jsd_pdist` of l1-normalised rows, row-invariant."""
    acc = _acc_dtype(X)
    X, Y = X.to(acc), Y.to(acc)
    hx = fixed_sum(_h_rows(X)).to(acc)
    hy = fixed_sum(_h_rows(Y)).to(acc)
    cross = map_rows(
        lambda a, b: fixed_sum(_h_rows(a[:, None, :] + b[None, :, :])),
        X, Y, Y.shape[0] * X.shape[1]).to(acc)
    K = 1.0 - 0.5 * (hx[:, None] + hy[None, :] - cross)
    return torch.sqrt(torch.clamp_min(K, 0.0))


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


def _triangular_block(Xa: Tensor, Ya: Tensor) -> Tensor:
    num = (Xa[:, None, :] - Ya[None, :, :]) ** 2
    den = Xa[:, None, :] + Ya[None, :, :]
    frac = torch.where(den > 0, num / torch.clamp_min(den, _EPS),
                       torch.zeros_like(num))
    return torch.sqrt(0.5 * fixed_sum(frac))


def triangular_rows(X: Tensor, Y: Tensor) -> Tensor:
    """:func:`triangular_pdist` of l1-normalised rows, row-invariant."""
    acc = _acc_dtype(X)
    return map_rows(_triangular_block, X.to(acc), Y.to(acc),
                     Y.shape[0] * X.shape[1])


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


def qform_rows(X: Tensor, Y: Tensor, M: Tensor) -> Tensor:
    """:func:`qform_pdist`'s expansion, row-invariant."""
    acc = _acc_dtype(X)
    Xa, Ya, Mt = X.to(acc), Y.to(acc), M.to(acc).T
    XM, YM = row_dot(Xa, Mt), row_dot(Ya, Mt)
    xmx = fixed_dot(XM, Xa)
    ymy = fixed_dot(YM, Ya)
    d2 = xmx[:, None] + ymy[None, :] - 2.0 * row_dot(XM, Ya)
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
    #: ``pdist`` in its row-invariant form (inputs normalised likewise)
    rows: Callable[[Tensor, Tensor], Tensor]


def _qform_registry(X: Tensor, Y: Tensor) -> Tensor:
    return qform_pdist(X, Y, default_qform_matrix(X.shape[-1],
                                                  device=X.device))


def _qform_registry_rows(X: Tensor, Y: Tensor) -> Tensor:
    return qform_rows(X, Y, default_qform_matrix(X.shape[-1],
                                                 device=X.device))


_REGISTRY = {
    "euclidean": Metric("euclidean", euclidean_pdist, None, True, True,
                        euclidean_rows),
    "sqeuclidean": Metric("sqeuclidean", sqeuclidean_pdist, None, False,
                          True, sqeuclidean_rows),
    # callers pre-normalise: the pairwise function is plain euclidean
    "cosine": Metric("cosine", euclidean_pdist, l2_normalize, True, True,
                     euclidean_rows),
    "jsd": Metric("jsd",
                  lambda X, Y: jsd_pdist(X, Y, assume_normalized=True),
                  l1_normalize, True, False, jsd_rows),
    "triangular": Metric(
        "triangular",
        lambda X, Y: triangular_pdist(X, Y, assume_normalized=True),
        l1_normalize, True, False, triangular_rows),
    "qform": Metric("qform", _qform_registry, None, True, True,
                    _qform_registry_rows),
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
