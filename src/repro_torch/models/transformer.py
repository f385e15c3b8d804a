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

The reference's ``ActShard`` constraints are GSPMD hints with no meaning
on one device; the port has no such argument (the multi-card trainer is
ROADMAP A, item 3).

Embedding lookups go through ``layers.gather_rows``, whose backward is
deterministic. Every product is taken with an f32 result
(``layers.matmul_f32``); biases are added in f32, then one cast to
``cfg.dtype``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

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


@torch.no_grad()
def init_params(cfg: TransformerConfig, *,
                generator: torch.Generator) -> Transformer:
    """An LM with random weights, on the generator's device: the stacks
    truncated-normal fan-in (``layers.dense_init``), the embedding at
    scale 1, norms ones (zeros for the (1 + w) form and the post-norms),
    biases zero."""
    model = Transformer(cfg, device=generator.device)
    lead = (cfg.n_groups, cfg.pattern_len)
    for name, (shape, init) in _layer_shapes(cfg).items():
        p = getattr(model.layers, name)
        if init == "zeros":
            p.zero_()
        elif init == "ones":
            p.fill_(1.0)
        else:
            p.copy_(L.dense_init(lead + shape, init[1], cfg.dtype,
                                 generator=generator))
    model.embed.copy_(L.dense_init(model.embed.shape, 1.0, cfg.dtype,
                                   generator=generator))
    model.final_norm.fill_(0.0 if cfg.norm_plus_one else 1.0)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(L.dense_init(model.lm_head.shape, None,
                                         cfg.dtype, generator=generator))
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


def _ring_positions(cache_len: int, slen: int, batch: int, device
                    ) -> Tensor:
    """Absolute position held by each ring-buffer slot (invalid -> far
    future)."""
    slots = torch.arange(slen, device=device)
    # latest absolute position congruent to slot (mod slen) strictly
    # before cache_len
    rem = torch.remainder(cache_len - 1 - slots, slen)
    pos = cache_len - 1 - rem
    pos = torch.where(pos >= 0, pos, torch.full_like(pos, _FAR))
    if cache_len <= 0:
        pos = torch.full_like(pos, _FAR)
    return pos.expand(batch, slen)


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
                kv_pos = _positions(B, slen, token.device)
                kv_pos = torch.where(kv_pos < cache_len, kv_pos,
                                     torch.full_like(kv_pos, _FAR))
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
                if window:
                    if window < S:
                        # ring layout: position p lives at slot p % window
                        shift = (S - window) % window
                        k = torch.roll(k[:, -window:], shift, dims=1)
                        v = torch.roll(v[:, -window:], shift, dims=1)
                elif pad_to is not None and pad_to > S:
                    widths = (0, 0, 0, 0, 0, pad_to - S)
                    k = torch.nn.functional.pad(k, widths)
                    v = torch.nn.functional.pad(v, widths)
                caches.append((k, v))
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
