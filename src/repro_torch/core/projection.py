"""NSimplexTransform — the paper's DR technique as a library object.

PyTorch counterpart of ``repro.core.projection``:

    tr = NSimplexTransform(metric="euclidean", k=32).fit(refs)
    Xp = tr.transform(X)           # (N, k) apex coordinates

    tr = NSimplexTransform.from_distances(D_refs)      # coordinate-free
    Xp = tr.transform_from_distances(D_x_refs)

``select_references`` and ``fit_transform`` draw from a
``torch.Generator`` or take explicit row ids: ``jax.random`` streams cannot
be replayed in torch, so parity with the JAX package goes through the ids
it chose.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import metrics as metrics_lib
from . import simplex as simplex_lib

Tensor = torch.Tensor


@dataclasses.dataclass
class NSimplexTransform:
    """nSimplex projection sigma_R : (U, d) -> R^k (paper §4).

    Attributes:
      k:      number of reference objects == output dimensionality.
      metric: name from ``core.metrics``, or "precomputed" in distance-only
              mode.
      jitter: relative Gram-diagonal regulariser (0.0 = exact).
      refs:   (k, m) fitted (normalised) reference objects, or ``None``.
      base:   the fitted ``BaseSimplex``.
    """

    k: int
    metric: str = "euclidean"
    jitter: float = 0.0
    refs: Optional[Tensor] = None
    base: Optional[simplex_lib.BaseSimplex] = None

    def fit(self, refs: Tensor) -> "NSimplexTransform":
        """Fit from (k, m) reference objects; returns a new transform.

        Raises ValueError when ``refs`` does not hold exactly ``k`` rows.
        """
        if refs.shape[0] != self.k:
            raise ValueError(
                f"expected {self.k} references, got {refs.shape[0]}")
        m = metrics_lib.get_metric(self.metric)
        if m.normalize is not None:
            refs = m.normalize(refs)
        D = m.pdist(refs, refs)
        # exact zero diagonal (numeric noise breaks the Gram construction)
        D = D * (1.0 - torch.eye(self.k, dtype=D.dtype, device=D.device))
        base = simplex_lib.build_base_simplex(D, jitter=self.jitter)
        return dataclasses.replace(self, refs=refs, base=base)

    @classmethod
    def from_distances(cls, D_refs: Tensor, *, metric: str = "precomputed",
                       jitter: float = 0.0) -> "NSimplexTransform":
        """Fit from a (k, k) reference distance matrix (coordinate-free)."""
        base = simplex_lib.build_base_simplex(D_refs, jitter=jitter)
        return cls(k=D_refs.shape[0], metric=metric, jitter=jitter,
                   refs=None, base=base)

    @property
    def is_fitted(self) -> bool:
        return self.base is not None

    def degenerate(self) -> bool:
        self._check_fitted()
        return simplex_lib.simplex_is_degenerate(self.base)

    def reference_distances(self, X: Tensor) -> Tensor:
        """(N, k) distances from each row of X to every reference object,
        in the metric's row-invariant form (``metrics.Metric.rows``): a
        row's distances, and so its projection, have the same bits
        whatever batch it is transformed in."""
        self._check_fitted()
        if self.refs is None:
            raise ValueError(
                "transform(X) needs coordinate references; use "
                "transform_from_distances for distance-only transforms")
        m = metrics_lib.get_metric(self.metric)
        if m.normalize is not None:
            X = m.normalize(X)
        return m.rows(X, self.refs)

    def transform(self, X: Tensor) -> Tensor:
        """Project (N, m) objects to (N, k) apex coordinates.

        Row by row the result does not depend on N; long inputs go through
        in row blocks that bound the row-invariant forms' (rows, k, m)
        temporaries (``metrics.ROW_BLOCK_ELEMS``).
        """
        step = max(1, metrics_lib.ROW_BLOCK_ELEMS // (self.k * X.shape[-1]))
        if X.shape[0] <= step:
            return simplex_lib.apex_project(self.base,
                                            self.reference_distances(X))
        return torch.cat([
            simplex_lib.apex_project(self.base,
                                     self.reference_distances(X[lo:lo + step]))
            for lo in range(0, X.shape[0], step)])

    def transform_from_distances(self, dists: Tensor) -> Tensor:
        """Project from precomputed (N, k) object-to-reference distances."""
        self._check_fitted()
        return simplex_lib.apex_project(self.base, dists)

    def __call__(self, X: Tensor) -> Tensor:
        return self.transform(X)

    def _check_fitted(self):
        if self.base is None:
            raise ValueError("NSimplexTransform is not fitted")


def select_references(
    X: Tensor,
    k: int,
    *,
    ids: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    metric: str = "euclidean",
    max_tries: int = 8,
    jitter: float = 0.0,
) -> NSimplexTransform:
    """Select k references from a witness set and fit.

    With ``ids`` the references are exactly those rows (one fit, no
    redraw). Otherwise k distinct rows are drawn from ``generator`` (a
    CPU ``torch.Generator``; seed 0 when ``None``) and re-drawn while the
    simplex is degenerate (paper §7.2), at most ``max_tries`` times; the
    last fit is returned either way and the caller may inspect
    ``.degenerate()``.
    """
    if ids is not None:
        idx = torch.as_tensor(ids, dtype=torch.long, device=X.device)
        return NSimplexTransform(k=k, metric=metric, jitter=jitter).fit(
            X[idx])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    last = None
    for _ in range(max_tries):
        idx = torch.randperm(X.shape[0], generator=generator)[:k]
        last = NSimplexTransform(k=k, metric=metric, jitter=jitter).fit(
            X[idx.to(X.device)])
        if not last.degenerate():
            return last
    return last


def fit_transform(
    X: Tensor,
    k: int,
    *,
    ids: Optional[Sequence[int]] = None,
    generator: Optional[torch.Generator] = None,
    metric: str = "euclidean",
    pivots: str = "random",
) -> Tuple[NSimplexTransform, Tensor]:
    """Select k references under a pivot strategy, fit, and project X.

    ``pivots`` is one of ``core.pivots.PIVOT_STRATEGIES``; the default
    "random" is :func:`select_references`'s redraw loop. ``ids`` fixes the
    reference rows (one fit, any strategy); otherwise they are drawn from
    ``generator``.
    """
    from . import pivots as pivots_lib  # deferred: it imports this module

    tr = pivots_lib.select_references(X, k, ids=ids, generator=generator,
                                      metric=metric, strategy=pivots)
    return tr, tr.transform(X)
