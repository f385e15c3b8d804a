"""One fit/transform protocol over every DR method the paper compares.

PyTorch counterpart of ``repro.core.reducers``:

    r = make_reducer("pca", k=8)            # or zen / rp / mds / lmds
    r = r.fit(witness, generator=gen)       # same signature for every method
    Xr = r.transform(X)                     # (N, k) reduced coordinates
    D  = r.pdist(Xr, Yr)                    # reduced-space distance matrix

``pdist`` is each method's own reduced-space comparator, with the routing
of the reference: the Zen estimator (``core.zen.zen_pdist``) for nSimplex,
Euclidean (``core.metrics.euclidean_pdist``) for the coordinate baselines.
``zen`` and ``lmds`` fit from distances alone and take any registry metric;
``pca``/``rp``/``mds`` are Euclidean-coordinate methods and raise on
anything else (the paper's §5.6 claim). Draws come from a CPU
``torch.Generator`` (seed 0 when ``None``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import metrics as metrics_lib
from .baselines import LMDSTransform, MDSTransform, PCATransform
from .baselines import RandomProjection
from .pivots import select_references
from .projection import NSimplexTransform
from .zen import zen_pdist

Tensor = torch.Tensor
Generator = Optional[torch.Generator]

#: every reducer name ``make_reducer`` accepts, in paper order
REDUCER_NAMES: Tuple[str, ...] = ("zen", "pca", "rp", "mds", "lmds")

#: reducers that fit from pairwise distances alone (coordinate-free spaces)
DISTANCE_ONLY: Tuple[str, ...] = ("zen", "lmds")


def _require_euclidean(name: str, metric: str) -> None:
    if metric != "euclidean":
        raise ValueError(
            f"{name} is a Euclidean-coordinate method and cannot fit a "
            f"{metric!r} space; distance-only methods "
            f"({'/'.join(DISTANCE_ONLY)}) handle coordinate-free metrics")


def _euclidean(Xr: Tensor, Yr: Tensor) -> Tensor:
    return metrics_lib.euclidean_pdist(Xr, Yr)


@dataclasses.dataclass
class ZenReducer:
    """nSimplex Zen behind the protocol (references from the witness set,
    random pivots as in the reference)."""

    k: int
    metric: str = "euclidean"
    transform_: Optional[NSimplexTransform] = None
    name: str = "zen"

    def fit(self, witness: Tensor, *, generator: Generator = None
            ) -> "ZenReducer":
        tr = select_references(witness, self.k, metric=self.metric,
                               generator=generator)
        return dataclasses.replace(self, transform_=tr)

    def transform(self, X: Tensor) -> Tensor:
        return self.transform_.transform(X)

    def pdist(self, Xr: Tensor, Yr: Tensor) -> Tensor:
        return zen_pdist(Xr, Yr)


@dataclasses.dataclass
class PCAReducer:
    k: int
    metric: str = "euclidean"
    transform_: Optional[PCATransform] = None
    name: str = "pca"

    def fit(self, witness: Tensor, *, generator: Generator = None
            ) -> "PCAReducer":
        _require_euclidean(self.name, self.metric)
        return dataclasses.replace(
            self, transform_=PCATransform(k=self.k).fit(witness))

    def transform(self, X: Tensor) -> Tensor:
        return self.transform_.transform(X)

    pdist = staticmethod(_euclidean)


@dataclasses.dataclass
class RPReducer:
    k: int
    metric: str = "euclidean"
    transform_: Optional[RandomProjection] = None
    name: str = "rp"

    def fit(self, witness: Tensor, *, generator: Generator = None
            ) -> "RPReducer":
        _require_euclidean(self.name, self.metric)
        return dataclasses.replace(
            self, transform_=RandomProjection(k=self.k).fit(
                witness, generator=generator))

    def transform(self, X: Tensor) -> Tensor:
        return self.transform_.transform(X)

    pdist = staticmethod(_euclidean)


@dataclasses.dataclass
class MDSReducer:
    k: int
    metric: str = "euclidean"
    transform_: Optional[MDSTransform] = None
    name: str = "mds"

    def fit(self, witness: Tensor, *, generator: Generator = None
            ) -> "MDSReducer":
        _require_euclidean(self.name, self.metric)
        return dataclasses.replace(
            self, transform_=MDSTransform(k=self.k).fit(witness))

    def transform(self, X: Tensor) -> Tensor:
        return self.transform_.transform(X)

    pdist = staticmethod(_euclidean)


@dataclasses.dataclass
class LMDSReducer:
    """Landmark MDS behind the protocol: coordinates in, coordinates out.

    ``fit`` takes ``n_landmarks`` witness rows (default ``max(2k, k+2)``),
    drawn from ``generator`` or, without one, the first rows; computes
    their pairwise distances under ``metric`` and triangulates new points
    from their landmark distances, so it also serves coordinate-free
    metrics (``metric="jsd"``).
    """

    k: int
    metric: str = "euclidean"
    n_landmarks: Optional[int] = None
    transform_: Optional[LMDSTransform] = None
    landmarks_: Optional[Tensor] = None
    name: str = "lmds"

    def fit(self, witness: Tensor, *, generator: Generator = None
            ) -> "LMDSReducer":
        l = min(self.n_landmarks or max(2 * self.k, self.k + 2),
                witness.shape[0])
        if generator is not None:
            pick = torch.randperm(witness.shape[0], generator=generator)[:l]
            landmarks = witness[pick.to(witness.device)]
        else:
            landmarks = witness[:l]
        D = metrics_lib.pairwise(self.metric, landmarks, landmarks)
        eye = torch.eye(l, dtype=torch.bool, device=D.device)
        D = torch.where(eye, torch.zeros_like(D), D)
        tr = LMDSTransform(k=self.k).fit_from_distances(D)
        return dataclasses.replace(self, transform_=tr, landmarks_=landmarks)

    def transform(self, X: Tensor) -> Tensor:
        dists = metrics_lib.pairwise(self.metric, X, self.landmarks_)
        return self.transform_.transform_from_distances(dists)

    pdist = staticmethod(_euclidean)


_REDUCERS = {
    "zen": ZenReducer,
    "pca": PCAReducer,
    "rp": RPReducer,
    "mds": MDSReducer,
    "lmds": LMDSReducer,
}


def make_reducer(name: str, k: int, *, metric: str = "euclidean", **kw):
    """One protocol object for ``name`` in ``REDUCER_NAMES`` (unfitted)."""
    try:
        cls = _REDUCERS[name]
    except KeyError:
        raise ValueError(
            f"unknown reducer {name!r}; choose from {REDUCER_NAMES}"
        ) from None
    return cls(k=k, metric=metric, **kw)
