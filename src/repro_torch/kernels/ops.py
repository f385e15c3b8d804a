"""Public dispatch for the kernels: by the device the tensors lie on.

PyTorch counterpart of ``repro.kernels.ops``. A CUDA tensor goes to the
Hopper kernel, which either runs or raises: nothing catches a build or
launch error to fall back. A CPU tensor goes to the kernel's plain PyTorch
version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import zen_topk as _zen_topk

Tensor = torch.Tensor


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
