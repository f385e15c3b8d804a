"""Parameter helpers (PyTorch counterpart of ``repro.models.layers``): only
``dense_init``; the LM's layers wait for ROADMAP A8."""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(shape, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32, *,
               generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-in init (a standard normal cut at +-2, times
    ``fan_in ** -0.5``), drawn in f32 on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in**-0.5
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)
