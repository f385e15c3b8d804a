"""Public dispatch for the kernels: by the device the tensors lie on.

PyTorch counterpart of ``repro.kernels.ops``. A CUDA tensor goes to the
Hopper kernel, which either runs or raises: nothing catches a build or
launch error to fall back. A CPU tensor goes to the kernel's plain PyTorch
version. The staging copy, whose source is always host memory, goes by
its target device instead.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import ivf_probe as _ivf_probe
from . import jsd as _jsd
from . import pdist as _pdist
from . import tile_stage as _tile_stage
from . import zen as _zen
from . import zen_topk as _zen_topk

Tensor = torch.Tensor


def pdist_sq(X: Tensor, Y: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances (N, K) f32 of (N, m) x (K, m),
    f32 or bf16 inputs."""
    fn = _pdist.pdist_sq if X.is_cuda else _pdist.pdist_sq_plain
    return fn(X, Y)


def pdist(X: Tensor, Y: Tensor) -> Tensor:
    """Pairwise Euclidean distances: ``sqrt(pdist_sq(X, Y))``."""
    return torch.sqrt(pdist_sq(X, Y))


def zen_estimate(X: Tensor, Y: Tensor, mode: str = "zen") -> Tensor:
    """Zen/Lwb/Upb estimator matrix (N, M) f32 of projected (N, k) x (M, k)
    coordinates (last column the altitude)."""
    fn = _zen.zen_estimate if X.is_cuda else _zen.zen_estimate_plain
    return fn(X, Y, mode)


def jsd_pdist(X: Tensor, Y: Tensor) -> Tensor:
    """Jensen-Shannon distance matrix (N, K) f32 of l1-normalised rows,
    clipped to [0, 1] before the root as the TPU kernel does."""
    fn = _jsd.jsd_pdist if X.is_cuda else _jsd.jsd_pdist_plain
    return fn(X, Y)


def zen_topk(
    queries: Tensor,
    index: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    scales: Optional[Tensor] = None,
    chunk: int = 4096,
) -> Tuple[Tensor, Tensor]:
    """Streaming top-k retrieval under an estimator.

    Args:
      queries:     (Q, k) projected query coordinates.
      index:       (N, k) projected index coordinates, stored f32, bf16 or
                   int8 (``kernels.quantize``).
      n_neighbors: results per query (clamped to N).
      mode:        estimator: "zen", "lwb" or "upb".
      scales:      (N, 1) f32 per-row scales when ``index`` is int8.
      chunk:       row tile of the plain version (its memory bound); the
                   kernel ignores it.

    Returns (distances f32, indices int32), each (Q, n_neighbors),
    ascending by (distance, id).
    """
    if index.is_cuda:
        return _zen_topk.zen_topk(queries, index, n_neighbors, mode,
                                  scales=scales)
    return _zen_topk.zen_topk_scan(queries, index, n_neighbors, mode,
                                   scales=scales, chunk=chunk)


def ivf_probe(
    queries: Tensor,
    tile_coords: Tensor,
    tile_ids: Tensor,
    probes: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    tiles_per_cluster: int,
    tile_scales: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Clustered top-k probe over packed cluster tiles.

    Args:
      queries:     (Q, k) projected queries.
      tile_coords: (C*T, tile_rows, k) packed cluster tiles, stored f32,
                   bf16 or int8.
      tile_ids:    (C*T, tile_rows) int32 global row ids, -1 = padding or
                   tombstone.
      probes:      (Q, P) int32 cluster ids to visit per query.
      tiles_per_cluster: T.
      tile_scales: (C, 1) f32 per-cluster scales when the tiles are int8.

    Returns (distances f32, indices int32), each (Q, n_neighbors),
    ascending; unfilled slots are (+inf, -1).
    """
    fn = _ivf_probe.ivf_probe if tile_coords.is_cuda else \
        _ivf_probe.ivf_probe_scan
    return fn(queries, tile_coords, tile_ids, probes, n_neighbors, mode,
              tiles_per_cluster=tiles_per_cluster, tile_scales=tile_scales)


def ivf_probe_pq(
    tile_codes: Tensor,
    tile_ids: Tensor,
    probes: Tensor,
    luts: Tensor,
    n_neighbors: int = 10,
    *,
    tiles_per_cluster: int,
) -> Tuple[Tensor, Tensor]:
    """Clustered top-k probe over PQ code tiles with per-(query, probe)
    (M, 256) tables (``pq.build_luts``; the estimator mode is folded into
    them). Same contract as :func:`ivf_probe`."""
    fn = _ivf_probe.ivf_probe_pq if tile_codes.is_cuda else \
        _ivf_probe.ivf_probe_pq_scan
    return fn(tile_codes, tile_ids, probes, luts, n_neighbors,
              tiles_per_cluster=tiles_per_cluster)


def dma_copy_blocks(src: Union[np.ndarray, Tensor], device) -> Tensor:
    """Copy a (B, ...) host block array onto ``device``, byte for byte.

    A CUDA ``device`` launches the Hopper staging kernel, which reads a
    pinned CPU tensor (``tile_stage.dma_copy_blocks``; a pageable source
    raises); a CPU ``device`` takes the plain copy.
    """
    if torch.device(device).type == "cuda":
        return _tile_stage.dma_copy_blocks(src, device)
    return _tile_stage.dma_copy_blocks_plain(src, device)
