"""Shared neural-net layers: norms, RoPE, attention (query-chunked), MLPs,
the deterministic row gather and segment sum (PyTorch counterpart of
``repro.models.layers``; the segment sum replaces ``jax.ops.segment_sum``).

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
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.partition import all_sum, sum_to

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


def _masked(scores: Tensor, kp: Tensor, qp: Tensor, *, causal: bool,
            window: int) -> Tensor:
    """``scores`` at -1e30 where key position ``kp`` is after query
    position ``qp`` (causal) or ``window`` or more before it."""
    mask = None
    if causal:
        mask = kp <= qp
    if window:
        inside = kp > qp - window
        mask = inside if mask is None else mask & inside
    if mask is None:
        return scores
    return torch.where(mask, scores, torch.full((), -1e30, dtype=scores.dtype,
                                                device=scores.device))


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
    scores = _masked(scores, kv_pos[:, None, None, None, :],
                     q_pos[:, None, None, :, None], causal=causal,
                     window=window)
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


def decode_scores(q: Tensor, k: Tensor, q_pos: Tensor, kv_pos: Tensor, *,
                  window: int, attn_softcap: float, scale: float) -> Tensor:
    """One query a row against a block of keys, scored as ``_attn_block``
    scores (f32 products, scale, softcap, causal and window masks at
    -1e30): q (B, KV, G, dh), k (B, n, KV, dh), q_pos (B,), kv_pos (B, n)
    -> (B, KV, G, n) f32. One product a KV head over a strided view of
    ``k``, so a cache block is read where it lies, not copied."""
    s = torch.stack([matmul_f32(q[:, h], k[:, :, h].transpose(1, 2))
                     for h in range(k.shape[2])], 1) * scale
    if attn_softcap:
        s = softcap(s, attn_softcap)
    return _masked(s, kv_pos[:, None, None, :], q_pos[:, None, None, None],
                   causal=True, window=window)


def decode_values(probs: Tensor, v: Tensor) -> Tensor:
    """probs (B, KV, G, n) in v's dtype against v (B, n, KV, dh) -> (B,
    KV, G, dh) f32, one product a KV head (``v`` not copied)."""
    return torch.stack([matmul_f32(probs[:, h], v[:, :, h])
                        for h in range(v.shape[2])], 1)


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


# -- products over the model axis -------------------------------------------
#
# Lists run over the model shards of one data replica, shard m's tensors on
# its device. A column-parallel product (``wq``, ``w_gate``, ...: the
# weight's output columns split over the shards) is each shard's own
# ``matmul_f32``: its contraction is whole, so each column is the unsharded
# one. A row-parallel product (``wo``, ``w_down``, ``ws_down``: the
# contraction split) sums the shards' f32 partials in f32, in shard order,
# and rounds once to the dtype after the sum, where the reference rounds.


def row_parallel(xs, ws, dtype: torch.dtype) -> list:
    """sum_m xs[m] @ ws[m] in f32, cast once to ``dtype``, on every
    shard."""
    return [t.to(dtype) for t in
            all_sum([matmul_f32(x, w) for x, w in zip(xs, ws)])]


def mlp_glu_sharded(xs, wgs, wus, wds, act: ActFn) -> list:
    """``mlp_glu`` with ``wg``/``wu`` column- and ``wd`` row-parallel."""
    hs = [(act(matmul_f32(x, wg)) * matmul_f32(x, wu)).to(x.dtype)
          for x, wg, wu in zip(xs, wgs, wus)]
    return row_parallel(hs, wds, xs[0].dtype)


def gather_rows_sharded(tables, ids: list, *, to=None):
    """``gather_rows`` of a table whose rows are split over the shards in
    order (``tables[m]`` holds rows ``m * n .. (m + 1) * n - 1``): each
    shard gathers only the ids it holds into zeros at their places, and
    the shards are summed (one nonzero term a row, so exactly the row):
    on every shard (``all_sum``), or once on device ``to`` (``sum_to``).
    ``ids[m]`` (any shape) lives on shard m's device.

    A shard's backward scatters only its own ids' cotangents, each row's
    duplicates summed in the order they occur (``gather_rows``), so a
    row's gradient has the bits ``gather_rows`` of the whole table gives
    it from the same cotangent."""
    if len(tables) == 1:
        got = gather_rows(tables[0], ids[0])
        return [got] if to is None else got.to(to)
    parts = []
    for m, (table, i) in enumerate(zip(tables, ids)):
        n = table.shape[0]
        local = i.long().reshape(-1) - m * n
        mine = torch.nonzero((local >= 0) & (local < n)).squeeze(1)
        got = gather_rows(table, local.index_select(0, mine))
        out = got.new_zeros((local.numel(),) + tuple(table.shape[1:]))
        parts.append(out.index_copy(0, mine, got).view(
            *i.shape, *table.shape[1:]))
    return all_sum(parts) if to is None else sum_to(parts, to)


# -- recompute across devices -----------------------------------------------


class RematGroup(torch.autograd.Function):
    """A group of work over a mesh's shards, rematerialised: forward runs
    ``fn(*inputs)`` without recording, backward runs it again with
    recording and differentiates that graph in the same call
    (``torch.autograd.grad``), so each group is recomputed once, by one
    thread. (``torch.utils.checkpoint``'s non-reentrant recompute starts
    in whichever thread unpacks a saved tensor first; with the autograd
    engine's one thread a card, two cards' threads can start it at once
    and it fails its saved-tensor count.) ``inputs`` are every tensor the
    group reads that needs a gradient (the shards' hidden states and
    leaves); ``fn`` returns a tuple of tensors."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return tuple(fn(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.fn(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads,
                                       materialize_grads=True))
        return (None, *[next(got) if t.requires_grad else None
                        for t in inputs])


class _Tee(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x), x.view_as(x)

    @staticmethod
    def backward(ctx, a, b):
        return a + b


def fan_out(x: Tensor, n: int) -> list:
    """``n`` aliases of ``x`` whose gradients are summed in a fixed
    grouping, g_0 + (g_1 + (... + g_{n-1})): a chain of two-way tees,
    each adding two gradients (exact in either order). A tensor that
    several groups read (``RematGroup``s, each run by the autograd thread
    of its first output's card) then gets its gradient the same bits
    whatever order the groups finish in. The engine runs the tees after
    the groups (they are older), so it holds all n gradients at once:
    for small tensors (leaves)."""
    out = []
    for _ in range(n - 1):
        a, x = _Tee.apply(x)
        out.append(a)
    return out + [x]


# -- the deterministic row gather --------------------------------------------


def run_lengths(sorted_ids: Tensor, n: int) -> Tensor:
    """(n,) how many times each of 0 .. n - 1 occurs in ``sorted_ids``
    (ascending): the differences of its ``searchsorted`` bounds. The same
    integers as ``bincount(minlength=n)`` for ids below n, but of a size
    known without reading the ids, so the host never waits on the card
    for it."""
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(n + 1, dtype=sorted_ids.dtype,
                                 device=sorted_ids.device))
    return bounds[1:] - bounds[:-1]


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
        # one segment a table row (a row no id names sums to zeros)
        return torch.segment_reduce(
            grad.reshape(flat.numel(), grad.shape[-1])[order], "sum",
            lengths=run_lengths(flat[order], ctx.n_rows)), None


def gather_rows(table: Tensor, ids: Tensor) -> Tensor:
    """(*ids.shape, d) rows of ``table``. Its backward is a dense (rows, d)
    gradient that sums each row's duplicates in the order the ids occur
    (a stable sort, then one sequential sum a (row, column):
    ``torch.segment_reduce``). No float atomics, so a step gives the same
    bits every time; ``F.embedding``'s CUDA backward does not."""
    return _GatherRows.apply(table, ids.long())


class _SegmentSum(torch.autograd.Function):
    """Rows of ``data`` summed per segment id, in the order the rows occur;
    its backward is a gather of the output's gradient."""

    @staticmethod
    def forward(ctx, data: Tensor, ids: Tensor, num_segments: int,
                order: Optional[Tensor]) -> Tensor:
        ctx.save_for_backward(ids)
        rows = data if order is None else data.index_select(0, order)
        lengths = run_lengths(ids if order is None else ids[order],
                              num_segments)
        out = torch.segment_reduce(
            rows.reshape(rows.shape[0], math.prod(rows.shape[1:])), "sum",
            lengths=lengths, axis=0)
        return out.view((num_segments,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, grad: Tensor):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None, None


def segment_sum(data: Tensor, ids: Tensor, num_segments: int, *,
                ids_sorted: bool = False) -> Tensor:
    """``jax.ops.segment_sum``: (num_segments, *data.shape[1:]) sums of the
    rows of ``data`` by ``ids``, in ``data``'s dtype; a segment no row
    names is exact zeros. Each segment adds its rows one after another in
    the order they occur, from 0 (the reference's scatter-add on the CPU,
    bf16 rounding at each add): ``torch.segment_reduce`` over the rows
    stably sorted by id (``ids_sorted``: already in that order). No float
    atomics, so the sums (and the backward, a gather) are the same bits
    every time on the card; ``index_add_`` and ``scatter_add_`` are not."""
    ids = ids.long()
    order = None if ids_sorted else torch.argsort(ids, stable=True)
    return _SegmentSum.apply(data, ids, num_segments, order)
