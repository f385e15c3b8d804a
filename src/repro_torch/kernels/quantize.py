"""Storage-dtype codec for the flat index: bf16 casts and symmetric int8.

PyTorch counterpart of the scalar modes of ``repro.kernels.quantize``
(the JAX package's copy cannot be imported without JAX). Modes:

  float32   the identity;
  bfloat16  a plain cast through ``torch.bfloat16`` — round to nearest even,
            the same bits ``ml_dtypes`` gives;
  int8      symmetric linear quantisation ``v ~= q * s`` with ``q`` in
            [-127, 127] and one positive scale ``s = absmax / 127`` per
            index row (robust to the far-sentinel dead rows of the mutable
            flat index).

The codec runs on the control plane (build / upsert / compact); the query
path dequantises in register inside the top-k kernel. Product quantisation
("pq") is IVF-only and not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

#: the element-wise (scalar) storage modes the flat index takes
SCALAR_STORAGE_DTYPES = ("float32", "bfloat16", "int8")

#: symmetric int8 quantisation range (-128 is never produced)
INT8_MAX = 127.0

#: scale floor — an all-zero group quantises to zeros with a harmless
#: positive scale instead of dividing by zero
_SCALE_FLOOR = 1e-30

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def check_storage(storage: str) -> str:
    if storage not in SCALAR_STORAGE_DTYPES:
        raise ValueError(
            f"storage must be one of {SCALAR_STORAGE_DTYPES}, got "
            f"{storage!r}")
    return storage


def storage_help() -> str:
    """The one-line ``--storage`` CLI help text, derived from the menu."""
    return (f"resident dtype of the searchable index, one of "
            f"{'/'.join(SCALAR_STORAGE_DTYPES)} (bf16 halves, int8 quarters "
            f"the bytes; estimator accumulation stays f32)")


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


def encode_rows(x: Tensor, storage: str) -> Tuple[Tensor, Optional[Tensor]]:
    """Encode a flat (N, k) f32 array: ``(values, row scales or None)``."""
    check_storage(storage)
    x = x.to(torch.float32)
    if storage == "float32":
        return x, None
    if storage == "bfloat16":
        return x.to(torch.bfloat16), None
    s = row_scales(x)
    return quantize(x, s), s
