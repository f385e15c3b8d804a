"""Storage-dtype codec for index rows and tiles: bf16 casts, symmetric int8.

PyTorch counterpart of ``repro.kernels.quantize`` (the JAX package's copy
cannot be imported without JAX). Modes:

  float32   the identity;
  bfloat16  a plain cast through ``torch.bfloat16`` — round to nearest even,
            the same bits ``ml_dtypes`` gives;
  int8      symmetric linear quantisation ``v ~= q * s`` with ``q`` in
            [-127, 127] and one positive scale ``s = absmax / 127`` per
            *group*: per index row in the flat layout (robust to the
            far-sentinel dead rows of the mutable flat index), per cluster
            in the IVF tile layout (``cluster_scales``);
  pq        per-cluster-residual product quantisation (``kernels.pq``):
            each member stores M uint8 codebook codes. IVF-only — the
            residual is taken against the member's coarse centroid, so the
            flat layout has nothing to encode against.

The codec runs on the control plane (build / upsert / compact); the query
path dequantises in register inside the search kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

#: the element-wise (scalar) storage modes: the flat and IVF layouts both
#: take these
SCALAR_STORAGE_DTYPES = ("float32", "bfloat16", "int8")

#: every accepted ``storage=`` value, in decreasing width; "pq" is IVF-only
STORAGE_DTYPES = SCALAR_STORAGE_DTYPES + ("pq",)

#: symmetric int8 quantisation range (-128 is never produced)
INT8_MAX = 127.0

#: scale floor — an all-zero group quantises to zeros with a harmless
#: positive scale instead of dividing by zero
_SCALE_FLOOR = 1e-30

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "pq": torch.uint8}


def check_storage(storage: str) -> str:
    if storage not in STORAGE_DTYPES:
        raise ValueError(
            f"storage must be one of {STORAGE_DTYPES}, got {storage!r}")
    return storage


def storage_help() -> str:
    """The one-line ``--storage`` CLI help text, derived from the menu."""
    return (f"resident dtype of the searchable index, one of "
            f"{'/'.join(STORAGE_DTYPES)} (bf16 halves, int8 quarters the "
            f"bytes, pq packs M uint8 codes per row — IVF only; estimator "
            f"accumulation stays f32)")


def torch_dtype(storage: str) -> torch.dtype:
    """The torch dtype index values are resident in under ``storage``."""
    return _TORCH_DTYPES[check_storage(storage)]


def symmetric_scales(absmax: Tensor) -> Tensor:
    """Per-group scales ``s = max(absmax, floor) / 127`` as float32."""
    return (torch.clamp_min(absmax.to(torch.float32), _SCALE_FLOOR)
            / INT8_MAX).to(torch.float32)


def quantize(x: Tensor, scales: Tensor) -> Tensor:
    """Symmetric int8 quantisation of ``x`` with broadcastable ``scales``.

    ``torch.round`` rounds half to even, as ``np.rint`` does, so the codes
    are byte-identical to the JAX package's.
    """
    q = torch.round(x.to(torch.float32) / scales.to(torch.float32))
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize(values: Tensor, scales: Tensor) -> Tensor:
    """f32 reconstruction ``q * s`` (broadcastable scales)."""
    return values.to(torch.float32) * scales.to(torch.float32)


def row_scales(x: Tensor) -> Tensor:
    """(N, 1) per-row scales of a flat (N, k) coordinate array."""
    return symmetric_scales(
        x.to(torch.float32).abs().amax(dim=-1, keepdim=True))


def cluster_scales(coords: Tensor, assign: Tensor,
                   n_clusters: int) -> Tensor:
    """(C, 1) per-cluster scales from member coords and their assignment.

    Taken over all members of each cluster before any tile packing, so the
    scale depends only on the assignment, never on the layout.
    """
    absmax = torch.zeros(n_clusters, dtype=torch.float32,
                         device=coords.device)
    if assign.numel():
        per_row = coords.to(torch.float32).abs().amax(dim=-1)
        absmax.scatter_reduce_(0, assign.long(), per_row, "amax")
    return symmetric_scales(absmax)[:, None]


def encode_rows(x: Tensor, storage: str) -> Tuple[Tensor, Optional[Tensor]]:
    """Encode a flat (N, k) f32 array: ``(values, row scales or None)``.

    Scalar modes only: "pq" codes are residuals against a coarse centroid,
    which the flat layout does not have.
    """
    check_storage(storage)
    if storage == "pq":
        raise ValueError(
            "storage='pq' is IVF-only (codes are per-cluster residuals); "
            "the flat layout takes " + "/".join(SCALAR_STORAGE_DTYPES))
    x = x.to(torch.float32)
    if storage == "float32":
        return x, None
    if storage == "bfloat16":
        return x.to(torch.bfloat16), None
    s = row_scales(x)
    return quantize(x, s), s
