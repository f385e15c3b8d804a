"""Decoder-only transformer family: dense + MoE, GQA, QKV-bias, RoPE,
sliding-window/global alternating layers, logit soft-capping (PyTorch
counterpart of ``repro.models.transformer``).

Covers the LM architectures: qwen2-moe-a2.7b, granite-moe-3b-a800m (MoE),
qwen1.5-0.5b, gemma2-2b, granite-8b (dense).

* **stacked layers**: the layer parameters are stacked along leading
  (groups, pattern position) axes under the reference's names (``embed``,
  ``layers.wq``, ..., ``final_norm``, ``lm_head``), so a state dict maps
  leaf to leaf onto the reference's pytree and its checkpoints. A Python
  loop over the groups replaces ``lax.scan``; each stacked tensor is
  unbound once a call (its backward one stack of the layers' gradients).
  Architectures with a repeating layer pattern (gemma-2's local/global
  alternation) loop over groups of ``len(pattern)`` layers, each position
  with its static window.
* **remat**: ``"minimal"`` wraps each group in
  ``torch.utils.checkpoint(use_reentrant=False)`` (nothing saved, the
  group recomputed in backward), ``"dots"`` saves the outputs of the
  groups' un-batched products (``aten.mm``) and recomputes the rest, and
  ``"none"`` keeps every activation.
* decode keeps a **ring buffer** KV cache for sliding-window layers
  (length = window, position p at slot p % window) and a full-length cache
  for global layers. ``decode_step`` writes the new token's keys and
  values into the cache in place and returns it.

The reference's ``ActShard`` constraints are GSPMD hints; the port has no
such argument. Its sharded path (``init_sharded``, ``sharded_loss_fn``,
``sharded_prefill``, ``sharded_decode_step``, the end of this module) lays
the leaves out on a (data, model) mesh by the reference's partition rules
and computes the same functions, the serving plans' KV cache with its
sequence over ``model``.

Embedding lookups go through ``layers.gather_rows``, whose backward is
deterministic. Every product is taken with an f32 result
(``layers.matmul_f32``); biases are added in f32, then one cast to
``cfg.dtype``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from repro_torch.distributed.partition import (
    ShardedTensor,
    all_gather,
    all_max,
    all_sum,
    all_to_all,
    axis_groups,
    place,
    send,
    shard_key,
    sum_to,
    zeros,
)
from repro_torch.distributed.sharding import (
    P,
    data_replicas,
    lm_param_specs,
    mesh_data_axes,
)

from . import layers as L
from . import moe as moe_lib

Tensor = torch.Tensor

#: an invalid cache slot's position: far in the future, so every causal
#: mask hides it
_FAR = 1 << 30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 4096
    # attention / misc
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    layer_pattern: Tuple[int, ...] = (0,)  # window per position; 0 = global
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"
    post_norms: bool = False               # gemma-2 style post-block norms
    norm_plus_one: bool = False            # gemma (1 + w) RMSNorm
    embed_scale: bool = False              # gemma sqrt(d_model) embed scaling
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    remat_policy: str = "minimal"          # none | minimal | dots
    query_chunk: int = 1024
    # the reference's layer-scan switch; the port always loops
    unroll_layers: bool = False
    # the reference's gradient-accumulation knob; its trainer does not
    # read it, and neither does the port's
    n_microbatches: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rows padded to a multiple of 256 (the reference shards
        them over the model axis). Padded logits are masked to -1e30
        before the softmax, so semantics are unchanged."""
        if self.vocab_size % 256 == 0 or self.vocab_size < 256:
            return self.vocab_size
        return (self.vocab_size + 255) // 256 * 256

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.pattern_len == 0, (
            self.n_layers, self.layer_pattern)
        return self.n_layers // self.pattern_len

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS accounting)."""
        dh, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = self.d_model * dh * (H + 2 * KV) + H * dh * self.d_model
        if self.qkv_bias:
            attn += dh * (H + 2 * KV)
        if self.is_moe:
            ffn = self.d_model * self.n_experts  # router
            ffn += 3 * self.d_model * self.moe_d_ff * self.n_experts
            if self.n_shared_experts:
                ffn += 3 * self.d_model * self.moe_d_ff * self.n_shared_experts
        else:
            ffn = 3 * self.d_model * self.d_ff
        norms = (4 if self.post_norms else 2) * self.d_model
        per_layer = attn + ffn + norms
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                  else 2)
        return self.n_layers * per_layer + embed + self.d_model

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        dh, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
        attn = self.d_model * dh * (H + 2 * KV) + H * dh * self.d_model
        ffn = self.d_model * self.n_experts
        ffn += 3 * self.d_model * self.moe_d_ff * (self.top_k
                                                   + self.n_shared_experts)
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                  else 2)
        return self.n_layers * per_layer + embed + self.d_model


# -- parameters ----------------------------------------------------------------


def _layer_shapes(cfg: TransformerConfig) -> dict:
    """Every stacked layer leaf: name -> (shape after (G, PL), init), init
    being ("dense", scale or None), "ones" or "zeros"."""
    dh, H, KV, D = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    norm = "zeros" if cfg.norm_plus_one else "ones"
    dense = ("dense", None)
    out = {
        "wq": ((D, H * dh), dense),
        "wk": ((D, KV * dh), dense),
        "wv": ((D, KV * dh), dense),
        "wo": ((H * dh, D), dense),
        "ln1": ((D,), norm),
        "ln2": ((D,), norm),
    }
    if cfg.qkv_bias:
        out["bq"] = ((H * dh,), "zeros")
        out["bk"] = ((KV * dh,), "zeros")
        out["bv"] = ((KV * dh,), "zeros")
    if cfg.post_norms:
        out["ln1_post"] = ((D,), "zeros")
        out["ln2_post"] = ((D,), "zeros")
    if cfg.is_moe:
        E, F = moe_lib.padded_experts(cfg.n_experts), cfg.moe_d_ff
        out["router"] = ((D, E), ("dense", D**-0.5))
        out["we_gate"] = ((E, D, F), dense)
        out["we_up"] = ((E, D, F), dense)
        out["we_down"] = ((E, F, D), ("dense", F**-0.5))
        if cfg.n_shared_experts:
            Fs = F * cfg.n_shared_experts
            out["ws_gate"] = ((D, Fs), dense)
            out["ws_up"] = ((D, Fs), dense)
            out["ws_down"] = ((Fs, D), ("dense", Fs**-0.5))
            out["ws_gate_logit"] = ((D, 1), ("dense", D**-0.5))
    else:
        out["w_gate"] = ((D, cfg.d_ff), dense)
        out["w_up"] = ((D, cfg.d_ff), dense)
        out["w_down"] = ((cfg.d_ff, D), ("dense", cfg.d_ff**-0.5))
    return out


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device))


class TransformerLayers(nn.Module):
    """The stacked (n_groups, pattern_len, ...) layer leaves, by the
    reference's names (``wq``, ``ln1``, ``we_gate``, ...)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        lead = (cfg.n_groups, cfg.pattern_len)
        for name, (shape, _) in _layer_shapes(cfg).items():
            setattr(self, name, _param(lead + shape, cfg.dtype, device))


class Transformer(nn.Module):
    """The parameters of one LM; uninitialised until ``init_params`` draws
    them or a caller loads them. ``state_dict`` keys mirror the reference's
    pytree paths (``embed``, ``layers.wq``, ``final_norm``, ``lm_head``)."""

    def __init__(self, cfg: TransformerConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.d_model, cfg.dtype
        self.embed = _param((cfg.padded_vocab, D), dt, device)
        self.layers = TransformerLayers(cfg, device)
        self.final_norm = _param((D,), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((D, cfg.padded_vocab), dt, device)

    def forward(self, tokens: Tensor) -> Tensor:
        return forward(self.cfg, self, tokens)


def _draws(cfg: TransformerConfig, generator: torch.Generator):
    """(name, whole leaf) of every parameter in ``init_params``' order of
    draws, each made on the generator's device when it is reached."""
    lead = (cfg.n_groups, cfg.pattern_len)
    dev = generator.device
    for name, (shape, init) in _layer_shapes(cfg).items():
        if init == "zeros":
            yield f"layers.{name}", torch.zeros(lead + shape, dtype=cfg.dtype,
                                                device=dev)
        elif init == "ones":
            yield f"layers.{name}", torch.ones(lead + shape, dtype=cfg.dtype,
                                               device=dev)
        else:
            yield f"layers.{name}", L.dense_init(lead + shape, init[1],
                                                 cfg.dtype,
                                                 generator=generator)
    D = cfg.d_model
    yield "embed", L.dense_init((cfg.padded_vocab, D), 1.0, cfg.dtype,
                                generator=generator)
    yield "final_norm", torch.full((D,), 0.0 if cfg.norm_plus_one else 1.0,
                                   dtype=cfg.dtype, device=dev)
    if not cfg.tie_embeddings:
        yield "lm_head", L.dense_init((D, cfg.padded_vocab), None, cfg.dtype,
                                      generator=generator)


@torch.no_grad()
def init_params(cfg: TransformerConfig, *,
                generator: torch.Generator) -> Transformer:
    """An LM with random weights, on the generator's device: the stacks
    truncated-normal fan-in (``layers.dense_init``), the embedding at
    scale 1, norms ones (zeros for the (1 + w) form and the post-norms),
    biases zero."""
    model = Transformer(cfg, device=generator.device)
    for name, value in _draws(cfg, generator):
        model.get_parameter(name).copy_(value)
        del value
    return model


def layer_params(cfg: TransformerConfig, model: Transformer) -> list:
    """Per group, per pattern position, the dict of that layer's leaves:
    views of the stacks, each stack unbound once."""
    G, PL = cfg.n_groups, cfg.pattern_len
    unbound = {name: p.flatten(0, 1).unbind(0)
               for name, p in model.layers.named_parameters()}
    return [[{name: t[g * PL + pos] for name, t in unbound.items()}
             for pos in range(PL)] for g in range(G)]


# -- layer body ---------------------------------------------------------------


def _one_layer(cfg: TransformerConfig, p: dict, x: Tensor,
               positions: Tensor, window: int,
               kv: Optional[Tuple[Tensor, Tensor]] = None,
               kv_positions: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    B, S, D = x.shape
    dh, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    act = L.ActFn(cfg.act)
    npo = cfg.norm_plus_one

    h = L.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=npo)
    q = L.matmul_f32(h, p["wq"])
    k = L.matmul_f32(h, p["wk"])
    v = L.matmul_f32(h, p["wv"])
    if cfg.qkv_bias:  # in f32, then one cast
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, dh).to(cfg.dtype)
    k = k.reshape(B, S, KV, dh).to(cfg.dtype)
    v = v.reshape(B, S, KV, dh).to(cfg.dtype)
    q = L.rope(q, positions, theta=cfg.rope_theta)
    k = L.rope(k, positions, theta=cfg.rope_theta)

    if kv is not None:
        k_all = torch.cat([kv[0], k], dim=1)
        v_all = torch.cat([kv[1], v], dim=1)
        kv_pos = torch.cat([kv_positions, positions], dim=1)
    else:
        k_all, v_all, kv_pos = k, v, positions

    attn = L.attention(
        q, k_all, v_all, q_positions=positions, kv_positions=kv_pos,
        causal=True, window=window, attn_softcap=cfg.attn_softcap,
        query_chunk=cfg.query_chunk)
    attn = L.matmul_f32(attn.reshape(B, S, H * dh), p["wo"]).to(cfg.dtype)
    if cfg.post_norms:
        attn = L.rms_norm(attn, p["ln1_post"], cfg.norm_eps, plus_one=npo)
    x = x + attn

    h = L.rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=npo)
    if cfg.is_moe:
        ffn = moe_lib.moe_ffn(cfg, p, h)
        if cfg.n_shared_experts:
            shared = L.mlp_glu(h, p["ws_gate"], p["ws_up"], p["ws_down"], act)
            gate = torch.sigmoid(L.matmul_f32(h, p["ws_gate_logit"])
                                 ).to(cfg.dtype)
            ffn = ffn + gate * shared
    else:
        ffn = L.mlp_glu(h, p["w_gate"], p["w_up"], p["w_down"], act)
    if cfg.post_norms:
        ffn = L.rms_norm(ffn, p["ln2_post"], cfg.norm_eps, plus_one=npo)
    x = x + ffn
    return x, (k, v)


#: the un-batched products ``"dots"`` saves (``dots_with_no_batch_dims``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    cp = ckpt_lib.CheckpointPolicy
    return cp.MUST_SAVE if op in _DOTS else cp.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn):
    """``fn(x) -> out`` under the config's rematerialisation policy."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "minimal":
        return lambda x: ckpt_lib.checkpoint(fn, x, use_reentrant=False)
    if cfg.remat_policy == "dots":
        ctx = functools.partial(ckpt_lib.create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda x: ckpt_lib.checkpoint(fn, x, use_reentrant=False,
                                             context_fn=ctx)
    raise ValueError(cfg.remat_policy)


def _embed(cfg: TransformerConfig, model: Transformer, tokens: Tensor, *,
           scale: bool = True) -> Tensor:
    x = L.gather_rows(model.embed, tokens).to(cfg.dtype)
    if scale and cfg.embed_scale:  # sqrt(d_model) rounded to the dtype first
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _lm_logits(cfg: TransformerConfig, model: Transformer, x: Tensor
               ) -> Tensor:
    """Project hidden states to (padded) vocab logits; softcap; mask the
    padded columns to -1e30."""
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    logits = L.matmul_f32(x, head)
    logits = L.softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full((), -1e30, device=x.device),
                             logits)
    return logits


# -- forward: training --------------------------------------------------------


def _final_hidden(cfg: TransformerConfig, model: Transformer, x: Tensor,
                  positions: Tensor, *, remat: bool = True) -> Tensor:
    for group in layer_params(cfg, model):
        def body(x, group=group):
            for pos, p in enumerate(group):
                x, _ = _one_layer(cfg, p, x, positions,
                                  cfg.layer_pattern[pos])
            return x
        x = _remat(cfg, body)(x) if remat else body(x)
    return L.rms_norm(x, model.final_norm, cfg.norm_eps,
                      plus_one=cfg.norm_plus_one)


def forward(cfg: TransformerConfig, model: Transformer,
            tokens: Tensor) -> Tensor:
    """Token logits (B, S, V) f32."""
    B, S = tokens.shape
    x = _embed(cfg, model, tokens)
    x = _final_hidden(cfg, model, x, _positions(B, S, tokens.device))
    return _lm_logits(cfg, model, x)


def last_token_logits(cfg: TransformerConfig, model: Transformer,
                      tokens: Tensor) -> Tensor:
    """The last position's logits (B, V) f32: ``forward``'s last row,
    without the other positions' vocabulary products (no remat)."""
    B, S = tokens.shape
    x = _embed(cfg, model, tokens)
    x = _final_hidden(cfg, model, x, _positions(B, S, tokens.device),
                      remat=False)
    return _lm_logits(cfg, model, x[:, -1])


def loss_fn(cfg: TransformerConfig, model: Transformer, batch: dict
            ) -> Tuple[Tensor, dict]:
    """Next-token cross entropy. batch: {tokens (B,S), loss_mask (B,S)
    optional}."""
    tokens = batch["tokens"]
    logits = forward(cfg, model, tokens)  # (B, S, V) f32
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    tgt_logit = torch.gather(lg, -1, targets[..., None])[..., 0]
    nll = logz - tgt_logit  # (B, S-1)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask[:, 1:].to(nll.dtype)
    ntokens = torch.sum(mask)
    loss = torch.sum(nll * mask) / torch.clamp_min(ntokens, 1.0)
    return loss, {"loss": loss, "ntokens": ntokens}


# -- serving: prefill + decode ------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, seq_len: int, *,
                  device=None) -> dict:
    """Per-pattern-position caches. Sliding-window positions get a ring
    buffer of length min(window, seq_len); global positions a full-length
    buffer."""
    dh, KV, G = cfg.head_dim, cfg.n_kv_heads, cfg.n_groups
    caches = {}
    for pos, window in enumerate(cfg.layer_pattern):
        slen = min(window, seq_len) if window else seq_len
        shape = (G, batch, slen, KV, dh)
        caches[f"pos{pos}"] = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
    return caches


def _ring_positions(cache_len: int, slen: int, batch: int, device,
                    lo: int = 0, n: Optional[int] = None) -> Tensor:
    """Absolute position held by each ring-buffer slot (invalid -> far
    future): slots ``lo .. lo + n - 1`` (all by default) of ``slen``."""
    slots = torch.arange(lo, slen if n is None else lo + n, device=device)
    # latest absolute position congruent to slot (mod slen) strictly
    # before cache_len
    rem = torch.remainder(cache_len - 1 - slots, slen)
    pos = cache_len - 1 - rem
    pos = torch.where(pos >= 0, pos, torch.full_like(pos, _FAR))
    if cache_len <= 0:
        pos = torch.full_like(pos, _FAR)
    return pos.expand(batch, slots.numel())


def _global_positions(cache_len: int, batch: int, device, lo: int, n: int
                      ) -> Tensor:
    """Absolute position of global-cache slots ``lo .. lo + n - 1``
    (slot p holds position p; a slot at or past ``cache_len`` -> far
    future)."""
    pos = torch.arange(lo, lo + n, device=device)
    pos = torch.where(pos < cache_len, pos, torch.full_like(pos, _FAR))
    return pos.expand(batch, n)


def _cache_lengths(cfg: TransformerConfig, seq_len: int,
                   pad_to: Optional[int] = None) -> list:
    """Each pattern position's cache length after a prompt of ``seq_len``
    tokens: a ring buffer of min(window, seq_len), or the global length
    padded to ``pad_to``."""
    glob = pad_to if pad_to is not None and pad_to > seq_len else seq_len
    return [min(w, seq_len) if w else glob for w in cfg.layer_pattern]


def _to_cache(k: Tensor, window: int, pad_to: Optional[int]) -> Tensor:
    """A layer's prompt keys or values (B, S, ...) in the cache's layout:
    a sliding-window layer's last ``window`` positions rolled into the ring
    (position p at slot p % window), a global layer's padded to
    ``pad_to`` positions."""
    S = k.shape[1]
    if window:
        if window < S:
            return torch.roll(k[:, -window:], (S - window) % window, dims=1)
        return k
    if pad_to is not None and pad_to > S:
        return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_to - S))
    return k


@torch.no_grad()
def decode_step(cfg: TransformerConfig, model: Transformer, cache: dict,
                token: Tensor, cache_len) -> Tuple[Tensor, dict]:
    """One autoregressive step against a KV cache of ``cache_len`` tokens.

    Returns (logits (B, V), the cache), the new token's keys and values
    written into the cache in place: sliding-window layers at slot
    ``cache_len % window``, global layers at ``min(cache_len, len - 1)``.
    """
    cache_len = int(cache_len)
    B = token.shape[0]
    x = _embed(cfg, model, token)  # (B, 1, D)
    positions = torch.full((B, 1), cache_len, device=token.device)
    for g, group in enumerate(layer_params(cfg, model)):
        for pos, p in enumerate(group):
            window = cfg.layer_pattern[pos]
            ck = cache[f"pos{pos}"]["k"][g]
            cv = cache[f"pos{pos}"]["v"][g]
            slen = ck.shape[1]
            if window:
                # ring buffer: the cached token at absolute position p sits
                # at slot p % window; every occupied slot is in the window
                kv_pos = _ring_positions(cache_len, slen, B, token.device)
            else:
                kv_pos = _global_positions(cache_len, B, token.device, 0,
                                           slen)
            x, (k_new, v_new) = _one_layer(cfg, p, x, positions, window,
                                           kv=(ck, cv), kv_positions=kv_pos)
            slot = (cache_len % max(slen, 1) if window
                    else min(cache_len, slen - 1))
            ck[:, slot] = k_new[:, 0]
            cv[:, slot] = v_new[:, 0]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps,
                   plus_one=cfg.norm_plus_one)
    return _lm_logits(cfg, model, x)[:, 0], cache


def prefill(cfg: TransformerConfig, model: Transformer, tokens: Tensor, *,
            pad_to: Optional[int] = None) -> Tuple[Tensor, dict]:
    """Run the prompt, returning (last-token logits (B, V), filled KV
    cache).

    Global-layer caches are padded to ``pad_to`` total positions (headroom
    for the decode steps that follow); sliding-window caches are rolled
    into the ring layout ``decode_step`` expects (position p at slot
    p % window).
    """
    B, S = tokens.shape
    x = _embed(cfg, model, tokens)
    positions = _positions(B, S, tokens.device)
    per_pos = [{"k": [], "v": []} for _ in range(cfg.pattern_len)]
    for group in layer_params(cfg, model):
        def body(x, group=group):
            caches = []
            for pos, p in enumerate(group):
                window = cfg.layer_pattern[pos]
                x, (k, v) = _one_layer(cfg, p, x, positions, window)
                caches.append((_to_cache(k, window, pad_to),
                               _to_cache(v, window, pad_to)))
            return x, caches
        x, caches = _remat(cfg, body)(x)
        for pos, (k, v) in enumerate(caches):
            per_pos[pos]["k"].append(k)
            per_pos[pos]["v"].append(v)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps,
                   plus_one=cfg.norm_plus_one)
    logits = _lm_logits(cfg, model, x[:, -1])
    cache = {f"pos{pos}": {"k": torch.stack(c["k"]), "v": torch.stack(c["v"])}
             for pos, c in enumerate(per_pos)}
    return logits, cache


def embeddings(cfg: TransformerConfig, model: Transformer,
               tokens: Tensor) -> Tensor:
    """Mean-pooled final hidden states (B, d_model) f32: the metric space
    the nSimplex DR consumes. As in the reference: no embedding scale and
    no remat."""
    B, S = tokens.shape
    x = _embed(cfg, model, tokens, scale=False)
    x = _final_hidden(cfg, model, x, _positions(B, S, tokens.device),
                      remat=False)
    return torch.mean(x.to(torch.float32), dim=1)


# -- sharded: a (data, model) mesh ----------------------------------------------
#
# The reference's GSPMD lowering of the same function, written out for the
# process that owns every device of the mesh, or for each of the processes
# that own its positions (``distributed.partition``).
# The leaves are laid out by ``distributed.sharding.lm_param_specs``; each
# data replica runs its rows of the batch through its model shards:
#
# * heads over ``model``: wq/wk/wv (and their biases) column-parallel, wo
#   row-parallel; a shard's q heads and their KV heads sit on the shard
#   (GQA groups aligned) when n_kv_heads % M == 0. Otherwise (M a multiple
#   of n_kv_heads: each shard's q heads share one KV head) every shard
#   gathers wk/wv whole and takes its KV head's columns; their gradients
#   are summed back onto the owners in shard order;
# * when the heads do not split over ``model`` (n_heads % M, or n_kv_heads
#   and M neither dividing the other: gemma2-2b's 8 heads or
#   granite-moe's 24 on 16 shards), the leaves keep the same layout,
#   column blocks of H * dh / M, and attention is re-laid out instead: each
#   shard's column block of q goes over the sequence
#   (``partition.all_to_all``: shard m takes rows m S / M .. of every
#   column), k and v are gathered whole (``all_gather``), each shard runs
#   whole heads for its rows, and the output comes back as column blocks
#   for the row-parallel ``wo`` (``all_to_all`` the other way); a decode
#   step gathers its one token's q, k and v whole;
# * the FFN: w_gate/w_up (ws_gate/ws_up) column-, w_down (ws_down)
#   row-parallel; MoE experts over ``model`` (``moe.moe_ffn_sharded``);
# * the embedding's vocabulary rows over ``model`` (``gather_rows_sharded``)
#   and the logits' vocabulary columns (``lm_head`` P(None, "model"), or
#   the row-sharded ``embed`` when tied); the cross entropy combines the
#   shards' max and exp-sums, takes the target logit from its owner, and
#   sums nll and token counts over ``data`` before the one division.
#
# Everything else (norms, RoPE, residuals, routing) is computed by every
# shard on the same bits.


#: the dimensions of a KV cache leaf, by name
_CACHE_DIMS = ("group", "batch", "sequence", "KV head", "head")


def check_mesh(cfg: TransformerConfig, mesh, *,
               cache: Optional[dict] = None) -> None:
    """Raise unless ``cfg`` splits over the mesh's model axis and, given
    ``cache`` (leaf name -> (shape, spec) of a KV cache), every cache leaf
    splits over its spec's axes. The reference pads a cache length that
    does not split; the port refuses it, naming the dimension."""
    M = mesh.shape["model"]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bad = []
    if _column_attention(cfg, M):
        for name, n in (("q", H), ("KV", KV)):
            if (n * dh) % M:
                bad.append(f"{name} columns % M: {n} heads of {dh} on {M} "
                           "model shards")
    if cfg.padded_vocab % M:
        bad.append(f"padded_vocab % M: {cfg.padded_vocab} rows on {M} "
                   "model shards")
    if cfg.is_moe:
        E = moe_lib.padded_experts(cfg.n_experts)
        if E % M:
            bad.append(f"padded experts % M: {E} experts on {M} model "
                       "shards")
        if cfg.n_shared_experts and (cfg.moe_d_ff * cfg.n_shared_experts) % M:
            bad.append(f"shared-expert width % M on {M} model shards")
    elif cfg.d_ff % M:
        bad.append(f"d_ff % M: {cfg.d_ff} on {M} model shards")
    for name, (shape, spec) in (cache or {}).items():
        for d, size in enumerate(shape):
            n = math.prod(mesh.shape[a] for a in spec.axes(d))
            if size % n:
                bad.append(f"dimension {d} ({_CACHE_DIMS[d]}) of the {name} "
                           f"cache {tuple(shape)} ({size}) does not split "
                           f"into {n} shards ({spec})")
    if bad:
        raise ValueError(f"{cfg.name} does not split over the mesh "
                         f"{dict(mesh.shape)}: " + "; ".join(bad))


class ShardedTransformer:
    """An LM's leaves (``params``: name -> ``ShardedTensor``) on a (data,
    model) mesh."""

    def __init__(self, cfg: TransformerConfig, mesh, params: dict):
        check_mesh(cfg, mesh)
        self.cfg, self.mesh, self.params = cfg, mesh, dict(params)


def param_specs(cfg: TransformerConfig) -> dict:
    """The reference's rules' spec of every leaf, by name."""
    return lm_param_specs(Transformer(cfg, device="meta"))


@torch.no_grad()
def init_sharded(cfg: TransformerConfig, mesh, *,
                 generator: torch.Generator) -> ShardedTransformer:
    """``init_params``' weights, bit for bit (the same draws on the
    generator's device, leaf by leaf), each placed on ``mesh`` by its spec
    and dropped before the next is drawn."""
    check_mesh(cfg, mesh)
    specs = param_specs(cfg)
    params = {}
    for name, value in _draws(cfg, generator):
        params[name] = place(value, specs[name], mesh)
        del value
    for st in params.values():
        for s in st.shards:
            s.requires_grad_(True)
    return ShardedTransformer(cfg, mesh, params)


def _local_layers(cfg: TransformerConfig, model: ShardedTransformer,
                  pos: int) -> list:
    """``layer_params`` of mesh position ``pos``'s shards."""
    G, PL = cfg.n_groups, cfg.pattern_len
    unbound = {name[len("layers."):]: st.shards[pos].flatten(0, 1).unbind(0)
               for name, st in model.params.items()
               if name.startswith("layers.")}
    return [[{name: t[g * PL + pos_] for name, t in unbound.items()}
             for pos_ in range(PL)] for g in range(G)]


def _kv_columns(cfg: TransformerConfig, ps: list, name: str) -> list:
    """Each shard's ``wk``/``wv`` (``bk``/``bv``) columns: its own block
    when n_kv_heads % M == 0, else its KV head's columns of the gathered
    leaf."""
    M, KV, dh = len(ps), cfg.n_kv_heads, cfg.head_dim
    if KV % M == 0:
        return [p[name] for p in ps]
    full = all_gather([p[name] for p in ps], -1)
    group = cfg.n_heads // KV
    out = []
    for m, w in enumerate(full):
        kv = (m * cfg.n_heads // M) // group
        out.append(w[..., kv * dh:(kv + 1) * dh])
    return out


def _column_attention(cfg: TransformerConfig, M: int) -> bool:
    """Whether attention on M model shards runs re-laid out over the
    sequence (the heads do not split over the shards: n_heads % M, or
    n_kv_heads and M neither dividing the other)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return bool(H % M or (KV % M and M % KV))


def _kv_sources(cfg: TransformerConfig, M: int) -> list:
    """For each block of KV heads in order, the first of M model shards
    holding it: every shard its own block of KV heads when n_kv_heads % M
    == 0; (M a multiple of n_kv_heads) the first of the M / n_kv_heads
    shards whose q heads share each; and every KV head on shard 0 when
    attention runs re-laid out (each shard holds them whole)."""
    KV = cfg.n_kv_heads
    if _column_attention(cfg, M):
        return [0]
    if KV % M == 0:
        return list(range(M))
    return [kv * (M // KV) for kv in range(KV)]


def _column_qkv(cfg: TransformerConfig, ps: list, hs: list) -> tuple:
    """Each model shard's column blocks of q (B, S, H dh / M) and k, v
    (B, S, KV dh / M) in the dtype, no RoPE: the column-parallel products
    of ``_sharded_qkv`` before the heads are cut."""
    qs, ks, vs = [], [], []
    for p, h in zip(ps, hs):
        q = L.matmul_f32(h, p["wq"])
        k = L.matmul_f32(h, p["wk"])
        v = L.matmul_f32(h, p["wv"])
        if cfg.qkv_bias:  # in f32, then one cast
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        qs.append(q.to(cfg.dtype))
        ks.append(k.to(cfg.dtype))
        vs.append(v.to(cfg.dtype))
    return qs, ks, vs


def _column_layer_attention(cfg: TransformerConfig, ps: list, hs: list,
                            positions: list, window: int,
                            kv_out: Optional[list]) -> list:
    """Attention of one layer when the heads do not split over the model
    shards: q re-laid out over the sequence (shard m its S / M rows, every
    head), k and v gathered whole, whole heads on each shard, and the
    output re-laid out back into column blocks (B, S, H dh / M) for the
    row-parallel ``wo``. With ``kv_out``, each shard's whole keys and
    values (B, S, KV, dh) are appended to it."""
    M = len(ps)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qc, kc, vc = _column_qkv(cfg, ps, hs)
    ks, vs = [], []
    for k, v, pos in zip(all_gather(kc, 2), all_gather(vc, 2), positions):
        B, S = k.shape[:2]
        ks.append(L.rope(k.reshape(B, S, KV, dh), pos, theta=cfg.rope_theta))
        vs.append(v.reshape(B, S, KV, dh))
    if kv_out is not None:
        kv_out.append((ks, vs))
    heads = []
    for m, (q, k, v, pos) in enumerate(zip(all_to_all(qc, 1, 2), ks, vs,
                                           positions)):
        B, n = q.shape[:2]
        q_pos = pos[:, m * n:(m + 1) * n]
        q = L.rope(q.reshape(B, n, H, dh), q_pos, theta=cfg.rope_theta)
        attn = L.attention(
            q, k, v, q_positions=q_pos, kv_positions=pos, causal=True,
            window=window, attn_softcap=cfg.attn_softcap,
            query_chunk=cfg.query_chunk)
        heads.append(attn.reshape(B, n, H * dh))
    return all_to_all(heads, 2, 1)


def _sharded_qkv(cfg: TransformerConfig, ps: list, hs: list,
                 positions: list) -> tuple:
    """Each model shard's q (B, S, H / M, dh) and k, v (B, S, its KV heads,
    dh) in the dtype, RoPE applied, from its normed input ``hs[m]``."""
    dh, Hl = cfg.head_dim, cfg.n_heads // len(ps)
    wk, wv = _kv_columns(cfg, ps, "wk"), _kv_columns(cfg, ps, "wv")
    if cfg.qkv_bias:
        bk, bv = _kv_columns(cfg, ps, "bk"), _kv_columns(cfg, ps, "bv")
    qs, ks, vs = [], [], []
    for m, (p, h, pos) in enumerate(zip(ps, hs, positions)):
        B, S, _ = h.shape
        q = L.matmul_f32(h, p["wq"])
        k = L.matmul_f32(h, wk[m])
        v = L.matmul_f32(h, wv[m])
        if cfg.qkv_bias:  # in f32, then one cast
            q, k, v = q + p["bq"], k + bk[m], v + bv[m]
        q = q.reshape(B, S, Hl, dh).to(cfg.dtype)
        k = k.reshape(B, S, -1, dh).to(cfg.dtype)
        v = v.reshape(B, S, -1, dh).to(cfg.dtype)
        qs.append(L.rope(q, pos, theta=cfg.rope_theta))
        ks.append(L.rope(k, pos, theta=cfg.rope_theta))
        vs.append(v)
    return qs, ks, vs


def _sharded_tail(cfg: TransformerConfig, ps: list, xs: list, heads: list,
                  total_tokens: int, moe_carry: Optional[dict] = None
                  ) -> list:
    """The rest of ``_one_layer`` after attention over the model shards:
    ``wo`` row-parallel over each shard's heads (B, S, H / M * dh), the
    post-norm and residual, then the FFN block (``moe_carry``: the
    layer's slot claims passed from replica to replica, for MoE groups
    that span replicas; ``moe.moe_ffn_sharded``)."""
    act = L.ActFn(cfg.act)
    npo = cfg.norm_plus_one
    attn = L.row_parallel(heads, [p["wo"] for p in ps], cfg.dtype)
    if cfg.post_norms:
        attn = [L.rms_norm(a, p["ln1_post"], cfg.norm_eps, plus_one=npo)
                for a, p in zip(attn, ps)]
    xs = [x + a for x, a in zip(xs, attn)]

    hs = [L.rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=npo)
          for x, p in zip(xs, ps)]
    if cfg.is_moe:
        ffn = moe_lib.moe_ffn_sharded(cfg, ps, hs,
                                      total_tokens=total_tokens,
                                      carry=moe_carry)
        if cfg.n_shared_experts:
            shared = L.mlp_glu_sharded(
                hs, [p["ws_gate"] for p in ps], [p["ws_up"] for p in ps],
                [p["ws_down"] for p in ps], act)
            ffn = [f + torch.sigmoid(L.matmul_f32(h, p["ws_gate_logit"])
                                     ).to(cfg.dtype) * s
                   for f, s, h, p in zip(ffn, shared, hs, ps)]
    else:
        ffn = L.mlp_glu_sharded(hs, [p["w_gate"] for p in ps],
                                [p["w_up"] for p in ps],
                                [p["w_down"] for p in ps], act)
    if cfg.post_norms:
        ffn = [L.rms_norm(f, p["ln2_post"], cfg.norm_eps, plus_one=npo)
               for f, p in zip(ffn, ps)]
    return [x + f for x, f in zip(xs, ffn)]


def _sharded_layer(cfg: TransformerConfig, ps: list, xs: list,
                   positions: list, window: int, total_tokens: int,
                   kv_out: Optional[list] = None) -> list:
    """``_one_layer`` over the model shards of one data replica (of a
    batch of ``total_tokens`` tokens). With ``kv_out``, each shard's keys
    and values (lists over the shards) are appended to it."""
    hs = [L.rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=cfg.norm_plus_one)
          for x, p in zip(xs, ps)]
    if _column_attention(cfg, len(ps)):
        heads = _column_layer_attention(cfg, ps, hs, positions, window,
                                        kv_out)
        return _sharded_tail(cfg, ps, xs, heads, total_tokens)
    qs, ks, vs = _sharded_qkv(cfg, ps, hs, positions)
    if kv_out is not None:
        kv_out.append((ks, vs))
    heads = []
    for q, k, v, pos in zip(qs, ks, vs, positions):
        B, S = q.shape[:2]
        attn = L.attention(
            q, k, v, q_positions=pos, kv_positions=pos, causal=True,
            window=window, attn_softcap=cfg.attn_softcap,
            query_chunk=cfg.query_chunk)
        heads.append(attn.reshape(B, S, -1))
    return _sharded_tail(cfg, ps, xs, heads, total_tokens)


def _sharded_group(cfg: TransformerConfig, body, xs: list, ps: list) -> list:
    """``body(xs, ps) -> xs`` for one layer group (``ps[m][pos]`` the
    leaves of shard m's layer at pattern position pos), under the config's
    remat policy: "none" runs it, "minimal" through
    ``layers.RematGroup``."""
    if cfg.remat_policy == "none":
        return body(xs, ps)
    if cfg.remat_policy != "minimal":
        raise ValueError(f"remat policy {cfg.remat_policy!r} has no sharded "
                         "form (the sharded path takes none or minimal)")
    M = len(xs)
    keys = [[sorted(d) for d in shard] for shard in ps]
    flat = [d[k] for shard, ks in zip(ps, keys) for d, kk in zip(shard, ks)
            for k in kk]

    def fn(*t):
        rest = iter(t[M:])
        return tuple(body(list(t[:M]),
                          [[{k: next(rest) for k in kk} for kk in ks]
                           for ks in keys]))

    return list(L.RematGroup.apply(fn, *xs, *flat))


def _replica_embed(cfg: TransformerConfig, model: ShardedTransformer,
                   row: list, tokens: list) -> list:
    """The embedded rows of one data replica, one a model shard (the
    vocabulary rows over ``model``, summed on every shard)."""
    p = model.params
    xs = L.gather_rows_sharded([p["embed"].shards[i] for i in row], tokens)
    xs = [x.to(cfg.dtype) for x in xs]
    if cfg.embed_scale:  # sqrt(d_model) rounded to the dtype first
        xs = [x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype,
                               device=x.device) for x in xs]
    return xs


def _vocab_logits(cfg: TransformerConfig, model: ShardedTransformer,
                  row: list, xs: list) -> list:
    """The final norm and each model shard's vocabulary columns of the
    logits (..., Vp / M) f32, the padded columns at -1e30."""
    M = len(row)
    p = model.params
    Vl = cfg.padded_vocab // M
    out = []
    for m, (i, x) in enumerate(zip(row, xs)):
        x = L.rms_norm(x, p["final_norm"].shards[i], cfg.norm_eps,
                       plus_one=cfg.norm_plus_one)
        head = (p["embed"].shards[i].t() if cfg.tie_embeddings
                else p["lm_head"].shards[i])
        logits = L.softcap(L.matmul_f32(x, head), cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(m * Vl, (m + 1) * Vl,
                               device=x.device) >= cfg.vocab_size
            logits = torch.where(pad, torch.full((), -1e30, device=x.device),
                                 logits)
        out.append(logits)
    return out


def _replica_logits(cfg: TransformerConfig, model: ShardedTransformer,
                    row: list, tokens: list) -> list:
    """One data replica's vocabulary-sharded logits (B, S, Vp / M) f32,
    one a model shard, the padded columns at -1e30. ``tokens[m]`` are the
    replica's rows on shard m's device."""
    xs = _replica_embed(cfg, model, row, tokens)
    B, S = tokens[0].shape
    total = B * S * data_replicas(model.mesh)
    positions = [_positions(B, S, t.device) for t in tokens]
    local = [_local_layers(cfg, model, i) for i in row]

    def body(xs, ps):
        for pos in range(cfg.pattern_len):
            xs = _sharded_layer(cfg, [shard[pos] for shard in ps], xs,
                                positions, cfg.layer_pattern[pos], total)
        return xs

    for g in range(cfg.n_groups):
        xs = _sharded_group(cfg, body, xs, [lay[g] for lay in local])
    return _vocab_logits(cfg, model, row, xs)


def _replica_nll(cfg: TransformerConfig, logits: list, tokens: list
                 ) -> Tensor:
    """(B, S - 1) next-token nll of one data replica from its vocabulary
    shards, on the first shard's device."""
    lg = [x[:, :-1] for x in logits]
    targets = [t[:, 1:].long() for t in tokens]
    if len(lg) == 1:  # the unsharded loss_fn's operations
        logz = torch.logsumexp(lg[0], dim=-1)
        return logz - torch.gather(lg[0], -1, targets[0][..., None])[..., 0]
    mx = all_max([x.amax(-1) for x in lg])
    sums = all_sum([torch.sum(torch.exp(x - m[..., None]), -1)
                    for x, m in zip(lg, mx)])
    Vl = lg[0].shape[-1]
    tgt = []
    for m, (x, t) in enumerate(zip(lg, targets)):
        local = t - m * Vl
        inside = (local >= 0) & (local < Vl)
        picked = torch.gather(x, -1, torch.where(inside, local, 0)[..., None])
        tgt.append(torch.where(inside, picked[..., 0], picked.new_zeros(())))
    tgt = all_sum(tgt)
    return torch.log(sums[0]) + mx[0] - tgt[0]


def _replica_tokens(model: ShardedTransformer, tokens) -> list:
    """Per data replica, its rows of the batch on each of its model
    shards' devices (``tokens``: a whole (B, S) tensor, split over the
    data axes here, or a ``ShardedTensor`` laid out P(dp, None), dp the
    mesh's data axes)."""
    if not isinstance(tokens, ShardedTensor):
        tokens = place(tokens, P(mesh_data_axes(model.mesh), None),
                       model.mesh)
    return [[tokens.shards[i] for i in row]
            for row in axis_groups(model.mesh, "model")]


def sharded_logits(cfg: TransformerConfig, model: ShardedTransformer,
                   tokens) -> Tensor:
    """``forward``'s (B, S, Vp) f32 logits, assembled on the mesh's first
    device (a check's view of the sharded forward; no gradient)."""
    rows = axis_groups(model.mesh, "model")
    with torch.no_grad():
        parts = []
        for row, toks in zip(rows, _replica_tokens(model, tokens)):
            lg = _replica_logits(cfg, model, row, toks)
            at0 = parts[0] if parts else lg[0]   # at mesh position 0
            parts.append(torch.cat([send(x, at0, copy=False) for x in lg],
                                   -1))
    return torch.cat(parts, 0)


def sharded_loss_fn(cfg: TransformerConfig, model: ShardedTransformer,
                    batch: dict) -> Tuple[Tensor, dict]:
    """``loss_fn`` on the mesh: the sums of nll x mask and of the mask
    over every data replica, then one division, on the mesh's first
    device. batch: {tokens (B, S), loss_mask (B, S) optional}, whole
    tensors or laid out P(dp, None)."""
    rows = axis_groups(model.mesh, "model")
    toks = _replica_tokens(model, batch["tokens"])
    masks = (None if batch.get("loss_mask") is None
             else _replica_tokens(model, batch["loss_mask"]))
    nll_sums, counts = [], []
    for d, (row, t) in enumerate(zip(rows, toks)):
        nll = _replica_nll(cfg, _replica_logits(cfg, model, row, t), t)
        mask = (torch.ones_like(nll) if masks is None
                else masks[d][0][:, 1:].to(nll.dtype))
        nll_sums.append(torch.sum(nll * mask))
        counts.append(torch.sum(mask))
    dev = model.mesh.first_device
    total, ntokens = sum_to(nll_sums, dev), sum_to(counts, dev)
    loss = total / torch.clamp_min(ntokens, 1.0)
    return loss, {"loss": loss, "ntokens": ntokens}


# -- sharded serving: prefill and decode ------------------------------------------
#
# The reference's serving plans lay the KV cache out (G, B, slen, KV, dh)
# over P(None, "data", "model", None, None): the batch over ``data`` and
# the sequence over ``model`` (the 500k decode: one row, the sequence over
# ("data", "model")). The weights keep their training layout, heads over
# ``model``. So a prefill's head-sharded keys and values are re-laid out
# over the sequence (``partition.all_to_all``), and a decode step scores
# each block of the cache where it lies: every shard of the block's
# sequence group takes the whole q (gathered over the replica's model
# shards), scores its block for every head, and the softmax is GSPMD's
# lowering of the reference's, written out: the block maxima ``all_max``,
# the exponentials, their sums ``all_sum``, each block's probabilities
# normalised and cast to the dtype before its PV product, and the f32
# partial outputs summed in group order. The new token's own column is
# scored on the group's last shard under the same maximum and sum (the
# cache is not concatenated). Only the shard holding the written slot
# writes it.

@torch.no_grad()
def sharded_prefill(cfg: TransformerConfig, model: ShardedTransformer,
                    tokens, *, pad_to: Optional[int] = None
                    ) -> Tuple[ShardedTensor, dict]:
    """``prefill`` on the mesh: (the last position's logits (B, Vp) f32
    laid out P(dp, "model"), the filled KV cache: pos{p} -> {"k", "v"},
    each (G, B, slen, KV, dh) laid out P(None, dp, "model", None, None)),
    dp the mesh's data axes. ``tokens``: a whole (B, S) tensor or laid
    out P(dp, None). Each data replica runs its rows as ``sharded_logits``
    does, heads over ``model``; each layer's head-sharded keys and values
    are cut into the ring or padded to ``pad_to`` on their shard
    (``_to_cache``), then re-laid out over the sequence, each KV head
    taken from its first holder."""
    mesh = model.mesh
    M = mesh.shape["model"]
    rows = axis_groups(mesh, "model")
    toks = _replica_tokens(model, tokens)
    Bd, S = toks[0][0].shape
    B = Bd * data_replicas(mesh)
    dp = mesh_data_axes(mesh)
    cache_spec = P(None, dp, "model", None, None)
    lengths = _cache_lengths(cfg, S, pad_to)
    G, KV, dh = cfg.n_groups, cfg.n_kv_heads, cfg.head_dim
    check_mesh(cfg, mesh, cache={
        f"pos{p}": ((G, B, n, KV, dh), cache_spec)
        for p, n in enumerate(lengths)})
    cache = {f"pos{p}": {kv: zeros((G, B, n, KV, dh), cache_spec, mesh,
                                   cfg.dtype) for kv in ("k", "v")}
             for p, n in enumerate(lengths)}
    sources = _kv_sources(cfg, M)
    xs = [_replica_embed(cfg, model, row, t) for row, t in zip(rows, toks)]
    positions = [[_positions(Bd, S, x.device) for x in r] for r in xs]
    local = [_local_layers(cfg, model, i) for i in range(mesh.size)]
    # layer by layer, each replica in turn: one replica's launches do not
    # queue up behind the other's whole forward
    for g in range(G):
        for pos, window in enumerate(cfg.layer_pattern):
            for d, row in enumerate(rows):
                kv = []
                xs[d] = _sharded_layer(cfg, [local[i][g][pos] for i in row],
                                       xs[d], positions[d], window, B * S,
                                       kv_out=kv)
                for name, parts in zip(("k", "v"), kv[0]):
                    parts = [_to_cache(c, window, pad_to) for c in parts]
                    leaf = cache[f"pos{pos}"][name]
                    for i, blk in zip(row, all_to_all(parts, 1, 2, sources)):
                        leaf.shards[i][g].copy_(blk)
                del kv
    logits = [None] * mesh.size
    for row, x in zip(rows, xs):
        for i, lg in zip(row, _vocab_logits(cfg, model, row,
                                            [h[:, -1] for h in x])):
            logits[i] = lg
    out = ShardedTensor(mesh, P(dp, "model"), (B, cfg.padded_vocab),
                        torch.float32, logits)
    return out, cache


def _serve_layout(mesh, spec: P) -> tuple:
    """The batch axes b of a cache ``spec`` P(None, b, s, None, None);
    raises unless every mesh axis splits one of the batch and the
    sequence, and the sequence takes ``model``."""
    b_axes, s_axes = spec.axes(1), spec.axes(2)
    if (len(spec) > 5 or spec.axes(0) or spec.axes(3) or spec.axes(4)
            or "model" not in s_axes or set(b_axes) & set(s_axes)
            or set(b_axes) | set(s_axes) != set(mesh.axis_names)):
        raise ValueError(f"a decode step takes a cache laid out P(None, "
                         f"batch axes, sequence axes with 'model', None, "
                         f"None) over every axis of {mesh.axis_names}; "
                         f"got {spec}")
    return b_axes


def _sequence_attention(cfg: TransformerConfig, group: list, qs: dict,
                        knew: dict, vnew: dict, blocks: dict, cache_len: int,
                        window: int) -> dict:
    """One decode step's attention for one sequence group (``group``: the
    positions holding the blocks of one batch block's sequence, in block
    order). ``qs[i]`` (B, KV, G, dh), the new token's whole ``knew[i]`` /
    ``vnew[i]`` (B, 1, KV, dh) and ``blocks[i]`` = (k block, v block,
    kv_pos (B, n)) at position i. Returns the (B, KV, G, dh) f32 output,
    the same bits on every position of the group."""
    scale = cfg.head_dim**-0.5
    kw = dict(window=window, attn_softcap=cfg.attn_softcap, scale=scale)
    last = group[-1]
    scores, new = [], None
    for i in group:
        k, _, kv_pos = blocks[i]
        q_pos = torch.full((k.shape[0],), cache_len, device=k.device)
        scores.append(L.decode_scores(qs[i], k, q_pos, kv_pos, **kw))
        if i == last:  # the new token's own column
            new = L.decode_scores(qs[i], knew[i], q_pos, q_pos[:, None], **kw)
    maxima = [s.amax(-1, keepdim=True) for s in scores]
    maxima[-1] = torch.maximum(maxima[-1], new)
    mx = all_max(maxima)
    exps = [torch.exp(s - m) for s, m in zip(scores, mx)]
    e_new = torch.exp(new - mx[-1])
    sums = [e.sum(-1, keepdim=True) for e in exps]
    sums[-1] = sums[-1] + e_new
    z = all_sum(sums)
    outs = []
    for i, e, zz in zip(group, exps, z):
        v = blocks[i][1]
        o = L.decode_values((e / zz).to(v.dtype), v)
        if i == last:
            o = o + L.decode_values((e_new / zz).to(v.dtype), vnew[i])
        outs.append(o)
    return dict(zip(group, all_sum(outs)))


@torch.no_grad()
def sharded_decode_step(cfg: TransformerConfig, model: ShardedTransformer,
                        cache: dict, token, cache_len
                        ) -> Tuple[ShardedTensor, dict]:
    """``decode_step`` on the mesh against a sequence-sharded cache.

    ``cache``: pos{p} -> {"k", "v"}, each (G, B, slen, KV, dh) laid out
    P(None, b, s, None, None), the batch over axes b (``data``, or none)
    and the sequence over axes s (``model``, or ("data", "model") for the
    500k decode, whose one row every data replica runs). ``token`` (B, 1):
    whole, or laid out P(b, None). Returns (logits (B, Vp) f32 laid out
    P(b, "model"), ``cache``), the new token's keys and values written in
    place into the shard holding the slot, as ``decode_step`` writes its
    cache: slot ``cache_len % slen`` of a ring buffer, ``min(cache_len,
    slen - 1)`` of a global cache (past the end the last slot)."""
    mesh = model.mesh
    M = mesh.shape["model"]
    spec = cache["pos0"]["k"].spec
    b_axes = _serve_layout(mesh, spec)
    leaves = {f"{name}.{kv}": leaf for name, c in cache.items()
              for kv, leaf in c.items()}
    for name, leaf in leaves.items():
        if leaf.spec != spec:
            raise ValueError(f"cache leaf {name} is laid out {leaf.spec}, "
                             f"not {spec}")
    check_mesh(cfg, mesh, cache={n: (leaf.shape, leaf.spec)
                                 for n, leaf in leaves.items()})
    if isinstance(cache_len, ShardedTensor):
        cache_len = cache_len.shards[0]
    cache_len = int(cache_len)
    B = cache["pos0"]["k"].shape[1]
    if not isinstance(token, ShardedTensor):
        token = place(token, P(spec[1], None), mesh)
    elif token.spec.axes(0) != b_axes:
        raise ValueError(f"the token is laid out {token.spec}; the cache's "
                         f"batch lies over {b_axes}")
    rows = axis_groups(mesh, "model")
    # the sequence groups: the positions of one batch block, in block order
    keys = [shard_key(spec, mesh, p) for p in range(mesh.size)]
    groups = {}
    for p in sorted(range(mesh.size), key=lambda p: keys[p][2]):
        groups.setdefault(keys[p][1], []).append(p)
    groups = list(groups.values())
    seq_block = [k[2] for k in keys]
    sources = _kv_sources(cfg, M)
    columns = _column_attention(cfg, M)
    cols = cfg.n_heads * cfg.head_dim // M
    xs, positions, local = {}, {}, {}
    for row in rows:
        toks = [token.shards[i] for i in row]
        for i, x in zip(row, _replica_embed(cfg, model, row, toks)):
            xs[i] = x
            positions[i] = torch.full(tuple(x.shape[:2]), cache_len,
                                      device=x.device)
            local[i] = _local_layers(cfg, model, i)
    for g in range(cfg.n_groups):
        for pos, window in enumerate(cfg.layer_pattern):
            ck, cv = cache[f"pos{pos}"]["k"], cache[f"pos{pos}"]["v"]
            slen = ck.shape[2]
            qs, knew, vnew, blocks = {}, {}, {}, {}
            for row in rows:
                ps = [local[i][g][pos] for i in row]
                hs = [L.rms_norm(xs[i], p["ln1"], cfg.norm_eps,
                                 plus_one=cfg.norm_plus_one)
                      for i, p in zip(row, ps)]
                if columns:  # whole q, k and v, then RoPE
                    q, k, v = (all_gather(c, 2)
                               for c in _column_qkv(cfg, ps, hs))
                    for i, qw, kw, vw in zip(row, q, k, v):
                        Bb, dh = qw.shape[0], cfg.head_dim
                        qs[i] = L.rope(qw.reshape(Bb, 1, -1, dh),
                                       positions[i], theta=cfg.rope_theta
                                       ).reshape(Bb, cfg.n_kv_heads, -1, dh)
                        knew[i] = L.rope(kw.reshape(Bb, 1, -1, dh),
                                         positions[i], theta=cfg.rope_theta)
                        vnew[i] = vw.reshape(Bb, 1, -1, dh)
                    continue
                q, k, v = _sharded_qkv(cfg, ps, hs,
                                       [positions[i] for i in row])
                for i, qw, kw, vw in zip(row, all_gather(q, 2),
                                         all_to_all(k, None, 2, sources),
                                         all_to_all(v, None, 2, sources)):
                    Bb = qw.shape[0]
                    qs[i] = qw.reshape(Bb, cfg.n_kv_heads, -1, cfg.head_dim)
                    knew[i], vnew[i] = kw, vw
            for i in range(mesh.size):
                kb, vb = ck.shards[i][g], cv.shards[i][g]
                n = kb.shape[1]
                lo = seq_block[i] * n
                kv_pos = (_ring_positions(cache_len, slen, kb.shape[0],
                                          kb.device, lo, n) if window else
                          _global_positions(cache_len, kb.shape[0],
                                            kb.device, lo, n))
                blocks[i] = (kb, vb, kv_pos)
            attn = {}
            for group in groups:
                attn.update(_sequence_attention(cfg, group, qs, knew, vnew,
                                                blocks, cache_len, window))
            carry = {}  # MoE slots claimed by earlier replicas' tokens
            for row in rows:
                heads = []
                for m, i in enumerate(row):  # shard m's columns of wo's rows
                    o = attn[i].reshape(attn[i].shape[0], 1, -1)
                    heads.append(o[:, :, m * cols:(m + 1) * cols].to(
                        cfg.dtype))
                out = _sharded_tail(cfg, [local[i][g][pos] for i in row],
                                    [xs[i] for i in row], heads, B,
                                    moe_carry=carry)
                for i, x in zip(row, out):
                    xs[i] = x
            slot = cache_len % max(slen, 1) if window else min(cache_len,
                                                               slen - 1)
            for i in range(mesh.size):
                kb, vb, _ = blocks[i]
                lo = seq_block[i] * kb.shape[1]
                if lo <= slot < lo + kb.shape[1]:
                    kb[:, slot - lo] = knew[i][:, 0]
                    vb[:, slot - lo] = vnew[i][:, 0]
    logits = [None] * mesh.size
    for row in rows:
        for i, lg in zip(row, _vocab_logits(cfg, model, row,
                                            [xs[i][:, 0] for i in row])):
            logits[i] = lg
    out = ShardedTensor(mesh, P(spec[1], "model"), (B, cfg.padded_vocab),
                        torch.float32, logits)
    return out, cache
