"""Gradient compression with error feedback (PyTorch counterpart of
``repro.optim.compression``).

int8 uniform quantisation per tensor with an f32 scale; the quantisation
residual is carried in an error-feedback buffer (Seide et al. / EF-SGD),
so the compressed exchange is unbiased over time. The trainer's
``--compress-grads`` runs ``error_feedback_update`` on one device, and
on a mesh with data replicas the reference's ``axis_name`` branch
(``error_feedback_mean``): each replica quantises its own corrected
gradient with its own error buffer, and the reconstructions are averaged
over the replicas in a fixed order. A tensor split over model shards is
quantised with one scale, the whole tensor's (``compress_decompress_shards``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from repro_torch.distributed import partition

Tensor = torch.Tensor


class CompressionState(NamedTuple):
    error: Dict[str, Tensor]  # f32, keyed as the gradients


def init_state(grads_like: Dict[str, Tensor]) -> CompressionState:
    return CompressionState(error={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()})


def _quantize(x: Tensor, scale: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor]:
    if scale is None:
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


def compress_decompress_shards(shards: Sequence[Tensor]
                               ) -> Tuple[List[Tensor], List[Tensor]]:
    """``compress_decompress`` of one tensor given as its shards (on any
    devices, of any process): one scale, the largest |x| over every shard
    (a max, exact in any order, taken on the first shard's device, and
    the scale computed there and copied), then each shard's
    reconstruction and residual where it lives."""
    xs = [s.float() for s in shards]
    amax = partition.all_max([torch.max(torch.abs(x)) for x in xs])[0]
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    recs, resids = [], []
    for x in xs:
        rec = _dequantize(*_quantize(x, partition.send(scale, x)))
        recs.append(rec)
        resids.append(x - rec)
    return recs, resids


def replica_mean(parts: Sequence[Tensor]) -> Tensor:
    """sum(parts) / len(parts) on the first part's device, summed in part
    order (the reference's ``pmean``: a psum, then the division), inside
    a ``mesh.replica_mean`` profiler range: the parts may lie on other
    cards, or other processes (``partition.sum_to``)."""
    with record_function("mesh.replica_mean"):
        return partition.sum_to(parts, parts[0]) / len(parts)


@torch.no_grad()
def error_feedback_mean(grads: Sequence[Dict[str, Tensor]],
                        states: Sequence[CompressionState]
                        ) -> Tuple[List[Dict[str, Tensor]],
                                   List[CompressionState]]:
    """The reference's ``error_feedback_update(..., axis_name=)`` over the
    replicas of one axis, in one process: ``grads[r]`` and ``states[r]``
    are replica r's gradients and error buffers. Each replica quantises
    g + error with its own scale and keeps its residual; the
    reconstructions are averaged over the replicas in replica order, and
    every replica gets that mean (in its gradients' dtype, on its
    gradients' devices) as its new gradients."""
    new_g = [{} for _ in grads]
    new_e = [{} for _ in grads]
    for k in grads[0]:
        recs = []
        for r, (g, st) in enumerate(zip(grads, states)):
            rec, resid = compress_decompress(g[k].float() + st.error[k])
            recs.append(rec)
            new_e[r][k] = resid
        mean = replica_mean(recs)
        for r, g in enumerate(grads):
            new_g[r][k] = mean.to(device=g[k].device, dtype=g[k].dtype,
                                  copy=True)
    return new_g, [CompressionState(error=e) for e in new_e]


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
