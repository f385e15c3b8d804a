"""nSimplex math: metrics, base simplex + apex projection, estimators,
pivots, the baseline reducers and the quality measures (PyTorch
counterpart of ``repro.core``)."""
from .metrics import (
    cosine_pdist,
    euclidean_pdist,
    get_metric,
    jsd_pdist,
    l1_normalize,
    l2_normalize,
    pairwise,
    qform_pdist,
    self_pairwise,
    sqeuclidean_pdist,
    triangular_pdist,
)
from .projection import NSimplexTransform, fit_transform, select_references
from .simplex import (
    BaseSimplex,
    apex_project,
    build_base_simplex,
    gram_from_distances,
    simplex_is_degenerate,
)
from .zen import (estimate_pdist, estimate_triple, knn_search, lwb_pdist,
                  upb_pdist, zen_pdist)
from .baselines import LMDSTransform, MDSTransform, PCATransform, RandomProjection
from .reducers import DISTANCE_ONLY, REDUCER_NAMES, make_reducer
from . import pivots
from . import quality

__all__ = [
    "NSimplexTransform",
    "BaseSimplex",
    "apex_project",
    "build_base_simplex",
    "gram_from_distances",
    "simplex_is_degenerate",
    "select_references",
    "fit_transform",
    "estimate_pdist",
    "estimate_triple",
    "knn_search",
    "zen_pdist",
    "lwb_pdist",
    "upb_pdist",
    "PCATransform",
    "RandomProjection",
    "MDSTransform",
    "LMDSTransform",
    "make_reducer",
    "REDUCER_NAMES",
    "DISTANCE_ONLY",
    "pivots",
    "quality",
    "get_metric",
    "pairwise",
    "self_pairwise",
    "euclidean_pdist",
    "sqeuclidean_pdist",
    "cosine_pdist",
    "jsd_pdist",
    "triangular_pdist",
    "qform_pdist",
    "l1_normalize",
    "l2_normalize",
]
