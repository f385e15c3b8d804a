"""Gradient compression with error feedback (PyTorch counterpart of
``repro.optim.compression``).

int8 uniform quantisation per tensor with an f32 scale; the quantisation
residual is carried in an error-feedback buffer (Seide et al. / EF-SGD),
so the compressed exchange is unbiased over time. The trainer's
``--compress-grads`` runs it on one process; the cross-replica mean of
the reference's data-parallel path comes with the multi-card trainer
(ROADMAP A, item 3).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class CompressionState(NamedTuple):
    error: Dict[str, Tensor]  # f32, keyed as the gradients


def init_state(grads_like: Dict[str, Tensor]) -> CompressionState:
    return CompressionState(error={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()})


def _quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def compress_decompress(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Round-trip a tensor through int8; returns (reconstruction, residual)."""
    x = x.float()
    q, s = _quantize(x)
    rec = _dequantize(q, s)
    return rec, x - rec


@torch.no_grad()
def error_feedback_update(grads: Dict[str, Tensor], state: CompressionState
                          ) -> Tuple[Dict[str, Tensor], CompressionState]:
    """EF-compressed gradients: g_corrected = g + error; q = Q(g_corrected);
    error' = g_corrected - q; returns (q as the gradients, new state)."""
    new_g, new_e = {}, {}
    for k, g in grads.items():
        rec, resid = compress_decompress(g.float() + state.error[k])
        new_g[k], new_e[k] = rec.to(g.dtype), resid
    return new_g, CompressionState(error=new_e)
