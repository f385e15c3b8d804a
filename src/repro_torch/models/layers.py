"""Shared neural-net layers: norms, RoPE, attention (query-chunked), MLPs,
and the deterministic row gather (PyTorch counterpart of
``repro.models.layers``).

The reference's rounding points are kept:

* every product of two operands is taken with an f32 result
  (``preferred_element_type=f32``): ``matmul_f32``. On the card two bf16
  operands go through ``torch.mm``/``torch.bmm(..., out_dtype=f32)`` (bf16
  tensor-core products accumulated and returned in f32, no bf16 rounding
  of the result); anywhere else the operands are upcast and multiplied in
  f32 (TF32 is off package-wide);
* the norms work in ``promote(x.dtype, f32)`` and cast back once;
* attention's scores, softcap, mask (``-1e30``, not ``-inf``) and softmax
  are f32, and the probabilities are cast to ``v.dtype`` before the PV
  product;
* GQA is expressed as (kv_head, group) query heads: K and V are never
  repeated.

Attention is the reference's plain chunked form: a loop over query blocks
of ``query_chunk`` rows bounds the score tensor at (B, H, qc, Skv). It is
not ``F.scaled_dot_product_attention``, which has no softcap and rounds
elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_LOW = (torch.bfloat16, torch.float16)


def _mm_out_f32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` with an f32 result: (m, k) x (k, n) or batched (z, m, k) x
    (z, k, n). Low-precision operand pairs on the card take the library's
    mixed-precision product (f32 accumulation and output); anything else
    is multiplied in f32."""
    if a.is_cuda and a.dtype in _LOW and b.dtype == a.dtype:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` with an f32 result, and its gradients in the operands'
    dtypes. On the card with bf16 operands each gradient product is the
    same mixed-precision call on the f32 cotangent rounded to bf16 (the
    TPU's default precision for an f32 x bf16 product); elsewhere the
    cotangent stays f32 and the other operand is upcast (the reference's
    f32 x bf16 product on the CPU)."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        ctx.save_for_backward(a, b)
        return _mm_out_f32(a, b)

    @staticmethod
    def backward(ctx, g: Tensor):
        a, b = ctx.saved_tensors
        if a.is_cuda and a.dtype in _LOW and b.dtype == a.dtype:
            g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_out_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm_out_f32(a.transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a: Tensor, b: Tensor) -> Tensor:
    """(..., d) x (d, f) -> (..., f), or (z, m, k) x (z, k, n) -> (z, m,
    n), with an f32 result (the reference's ``preferred_element_type=
    f32``); see ``_MatmulF32``."""
    if b.dim() == 2:
        lead = a.shape[:-1]
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*lead, b.shape[-1])
    return _MatmulF32.apply(a, b)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-6, *,
             plus_one: bool = False) -> Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.to(acc)
    if plus_one:  # gemma-style (1 + w) parameterisation
        w = 1.0 + w
    return (y * w).to(x.dtype)


def softcap(x: Tensor, cap: float) -> Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: Tensor, positions: Tensor, *, theta: float = 10000.0) -> Tensor:
    """Rotary embedding, halves rotated. x: (B, S, H, dh); positions:
    (B, S) integers. The frequencies and angles are f32."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_block(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                kv_pos: Tensor, *, causal: bool, window: int,
                attn_softcap: float, scale: float) -> Tensor:
    """q (B, qc, KV, G, dh), k and v (B, Skv, KV, dh) -> (B, qc, KV, G, dh)
    f32."""
    B, qc, KV, G, dh = q.shape
    Skv = k.shape[1]
    # bqhgd,bkhd->bhgqk as (B*KV) products of (G*qc, dh) x (dh, Skv)
    qm = q.permute(0, 2, 3, 1, 4).reshape(B * KV, G * qc, dh)
    km = k.permute(0, 2, 3, 1).reshape(B * KV, dh, Skv)
    scores = matmul_f32(qm, km).view(B, KV, G, qc, Skv) * scale
    if attn_softcap:
        scores = softcap(scores, attn_softcap)
    kp = kv_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = None
    if causal:
        mask = kp <= qp
    if window:
        inside = kp > qp - window
        mask = inside if mask is None else mask & inside
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), -1e30, dtype=scores.dtype,
                                        device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    # bhgqk,bkhd->bqhgd
    pm = probs.to(v.dtype).reshape(B * KV, G * qc, Skv)
    vm = v.permute(0, 2, 1, 3).reshape(B * KV, Skv, dh)
    out = matmul_f32(pm, vm).view(B, KV, G, qc, dh)
    return out.permute(0, 3, 1, 2, 4)


def attention(q: Tensor, k: Tensor, v: Tensor, *, q_positions: Tensor,
              kv_positions: Tensor, causal: bool = True, window: int = 0,
              attn_softcap: float = 0.0, query_chunk: int = 1024,
              scale: Optional[float] = None) -> Tensor:
    """Softmax attention with GQA, causal/sliding-window masks and softcap.

    q (B, Sq, H, dh), k and v (B, Skv, KV, dh) -> (B, Sq, H, dh) in q's
    dtype. Query-chunked when Sq > query_chunk: a ragged length is padded
    with queries at position 0, which are cut from the result.
    """
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else dh**-0.5
    qg = q.reshape(B, Sq, KV, G, dh)
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              scale=scale)
    if Sq <= query_chunk:
        out = _attn_block(qg, k, v, q_positions, kv_positions, **kw)
        return out.reshape(B, Sq, H, dh).to(q.dtype)
    pad = -Sq % query_chunk
    if pad:  # pad ragged query lengths with masked dummies
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad), value=0)
    # one block at a time: the score tensor stays at (B, H, qc, Skv); each
    # block's f32 output is cast once, as the reference casts the whole
    out = [
        _attn_block(qg[:, lo:lo + query_chunk], k, v,
                    q_positions[:, lo:lo + query_chunk], kv_positions,
                    **kw).to(q.dtype)
        for lo in range(0, Sq + pad, query_chunk)]
    return torch.cat(out, dim=1)[:, :Sq].reshape(B, Sq, H, dh)


# -- parameter helpers --------------------------------------------------------


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


@dataclasses.dataclass(frozen=True)
class ActFn:
    name: str

    def __call__(self, x: Tensor) -> Tensor:
        if self.name == "silu":
            return F.silu(x)
        if self.name == "gelu":  # jax.nn.gelu(approximate=True)
            return F.gelu(x, approximate="tanh")
        if self.name == "relu":
            return F.relu(x)
        raise ValueError(self.name)


def mlp_glu(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
            act: ActFn) -> Tensor:
    """Gated-linear-unit FFN (SwiGLU / GeGLU): down(act(x wg) * (x wu))."""
    g = act(matmul_f32(x, wg))
    u = matmul_f32(x, wu)
    return matmul_f32((g * u).to(x.dtype), wd).to(x.dtype)


# -- the deterministic row gather --------------------------------------------


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums each row's gradients in the
    order the ids occur, deterministically on any device."""

    @staticmethod
    def forward(ctx, table: Tensor, ids: Tensor) -> Tensor:
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad: Tensor):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        rows, counts = torch.unique_consecutive(flat[order],
                                                return_counts=True)
        sums = torch.segment_reduce(
            grad.reshape(flat.numel(), -1)[order], "sum", lengths=counts)
        out = grad.new_zeros((ctx.n_rows, grad.shape[-1]))
        out[rows] = sums  # each row written once
        return out, None


def gather_rows(table: Tensor, ids: Tensor) -> Tensor:
    """(*ids.shape, d) rows of ``table``. Its backward is a dense (rows, d)
    gradient that sums each row's duplicates in the order the ids occur
    (a stable sort, then one sequential sum a (row, column):
    ``torch.segment_reduce``). No float atomics, so a step gives the same
    bits every time; ``F.embedding``'s CUDA backward does not."""
    return _GatherRows.apply(table, ids.long())
