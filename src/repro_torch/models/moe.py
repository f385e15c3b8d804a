"""Mixture-of-Experts FFN with group-limited, capacity-bounded dispatch
(PyTorch counterpart of ``repro.models.moe``).

* tokens are reshaped into groups of ``moe_group_size``;
* within a group, each token's top-k expert assignments claim a slot in an
  (E, C) buffer through an exclusive prefix count of the one-hot
  assignments (integers, exact); assignments beyond the per-group capacity
  C = ceil(group * top_k / E * capacity_factor) (rounded up to 8) go to
  the discarded row E * C (Switch/GShard semantics);
* expert buffers (groups, E, C, d) contract with the expert weights
  (E, d, f) as E batched products;
* the expert count is padded to a multiple of 16; padded experts are
  masked to -1e30 in the router.

Router: softmax over the true experts, top-k, renormalised combine weights
(norm_topk_prob=True). The top-k keeps ``lax.top_k``'s order (a tie goes
to the lower expert): a stable descending sort, not ``torch.topk``.

Every gather here has a backward without float atomics: a token's k
copies in the dispatch are an ``expand`` (its backward a fixed-order sum
over k) and the combine reads the expert outputs through
``layers.gather_rows``, so a step gives the same bits every time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import TYPE_CHECKING, Iterator, List, Optional

import torch

from repro_torch.distributed.partition import all_gather, all_sum, send

from . import layers as L

if TYPE_CHECKING:  # pragma: no cover
    from .transformer import TransformerConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class Dispatch:
    """What the MoE FFN did within a ``recording()`` block: ``handoffs``,
    the per-expert slot counts a data replica received from the earlier
    replicas of its group (``carry=``), one a model shard; ``assignments``,
    the token-expert assignments routed; ``dropped``, those past their
    expert's capacity (a replica's counted once, on its first model
    shard; read on the host)."""

    handoffs: int = 0
    assignments: int = 0
    kept: List[Tensor] = dataclasses.field(default_factory=list)

    @property
    def dropped(self) -> int:
        return self.assignments - sum(int(k) for k in self.kept)


_RECORDS: List[Dispatch] = []


@contextlib.contextmanager
def recording() -> Iterator[Dispatch]:
    """Within the block, ``moe_ffn`` and ``moe_ffn_sharded`` add to the
    yielded record. Off (one list check a call) outside any such block;
    blocks may nest, each counting everything inside it."""
    rec = Dispatch()
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _note(keep: Tensor, handoffs: int) -> None:
    """Record one call's slot claims: ``keep`` the assignments given a
    slot, ``handoffs`` the counts it received from an earlier replica."""
    for rec in _RECORDS:
        rec.handoffs += handoffs
        rec.assignments += keep.numel()
        rec.kept.append(keep.sum())


def padded_experts(n_experts: int, multiple: int = 16) -> int:
    return int(math.ceil(n_experts / multiple) * multiple)


def capacity(group: int, top_k: int, n_experts_padded: int,
             factor: float) -> int:
    c = math.ceil(group * top_k / n_experts_padded * factor)
    return max(8, int(math.ceil(c / 8) * 8))


def route(cfg: "TransformerConfig", router: Tensor, xt: Tensor):
    """The router of ``moe_ffn``: xt (G, gs, D) -> (gate (G, gs, k) f32,
    renormalised; expert_idx (G, gs, k) int64)."""
    E = router.shape[-1]
    logits = L.matmul_f32(xt, router)
    if E > cfg.n_experts:  # mask padded experts
        pad = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = torch.where(pad, torch.full((), -1e30, device=xt.device),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate = gate / torch.clamp_min(torch.sum(gate, -1, keepdim=True), 1e-9)
    return gate, expert_idx


def slots(expert_idx: Tensor, E: int, C: int,
          claimed: Optional[Tensor] = None):
    """Slot assignment within each group: (G, gs, k) expert ids -> (slot
    (G, gs*k) in [0, E*C] int64, E*C for a dropped assignment; keep
    (G, gs*k) bool). Assignments claim their expert's slots in token
    order, the k of one token in rank order. ``claimed`` (G, E): slots of
    each expert already claimed by the group's earlier tokens (held
    elsewhere), which these tokens follow."""
    G = expert_idx.shape[0]
    flat_e = expert_idx.reshape(G, -1)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    if claimed is not None:
        pos = pos + claimed[:, None, :].to(torch.int32)
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0].long()
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return slot, keep


def moe_ffn(cfg: "TransformerConfig", p: dict, x: Tensor) -> Tensor:
    """x: (B, S, D) -> (B, S, D) routed through top-k experts. ``p`` holds
    one layer's ``router``, ``we_gate``, ``we_up`` and ``we_down``."""
    B, S, D = x.shape
    E = p["we_gate"].shape[0]  # padded expert count (weights are pre-padded)
    T = B * S
    gs = min(cfg.moe_group_size, T)
    assert T % gs == 0, (T, gs)
    G = T // gs
    K = cfg.top_k
    C = capacity(gs, K, E, cfg.capacity_factor)
    xt = x.reshape(G, gs, D)

    gate, expert_idx = route(cfg, p["router"], xt)
    slot, keep = slots(expert_idx, E, C)
    if _RECORDS:
        _note(keep, 0)

    # dispatch: each token's k copies (an expand, whose backward sums over
    # k in a fixed order) copied to their slots, every group's E*C + 1 rows
    # one block of a flat buffer; dropped ones go to the block's row E*C
    rows = slot + (E * C + 1) * torch.arange(G, device=x.device)[:, None]
    xk = xt[:, :, None, :].expand(G, gs, K, D).reshape(G * gs * K, D)
    buf = xt.new_zeros((G * (E * C + 1), D)).index_copy(
        0, rows.reshape(-1), xk)
    buffers = buf.view(G, E * C + 1, D)[:, :E * C].reshape(G, E, C, D)

    # expert computation: E batched products of (G*C, D) x (D, F)
    act = L.ActFn(cfg.act)
    be = buffers.permute(1, 0, 2, 3).reshape(E, G * C, D)
    g = act(L.matmul_f32(be, p["we_gate"]))
    u = L.matmul_f32(be, p["we_up"])
    out_e = L.matmul_f32((g * u).to(x.dtype), p["we_down"]).to(x.dtype)
    out_buf = out_e.reshape(E, G, C, D).permute(1, 0, 2, 3)  # (G, E, C, D)

    # combine: gather expert outputs back to tokens, weighted
    flat_gate = gate.reshape(G, gs * K) * keep.to(gate.dtype)
    flat = torch.cat([out_buf.reshape(G, E * C, D),
                      out_buf.new_zeros((G, 1, D))], dim=1)
    picked = L.gather_rows(flat.reshape(G * (E * C + 1), D), rows)
    w = picked * flat_gate[..., None].to(picked.dtype)
    out = torch.sum(w.reshape(G, gs, K, D), dim=2)
    return out.reshape(B, S, D)


def moe_ffn_sharded(cfg: "TransformerConfig", ps: list, xs: list, *,
                    total_tokens: int, carry: Optional[dict] = None
                    ) -> list:
    """``moe_ffn`` with the experts split over the model shards (``ps[m]``
    holds experts ``m * E/M .. (m + 1) * E/M - 1`` of the padded E, and
    the router's columns for them); ``xs[m]`` is the same (B, S, D) on
    shard m's device: one data replica's rows of a batch of
    ``total_tokens`` tokens. The groups are the whole batch's (``min(
    moe_group_size, total_tokens)`` tokens, so the same capacity), and
    must not straddle two replicas.

    The router's columns (D x E, small) are gathered whole on every shard
    and each shard takes ``moe_ffn``'s own product, so every shard routes
    and claims slots exactly as ``moe_ffn`` does on the same input
    (gathering the (tokens, E) logits of column-split products instead
    would hold only where a column block of a product is the same bits as
    the whole, which a card's GEMMs do not promise); the router's gradient
    is summed back onto its owners in shard order. A shard
    fills and runs only its experts' slots and picks its experts' outputs
    for the assignments that name them (zeros for the rest); the picks are
    summed over the shards (one nonzero term an assignment: exactly the
    unsharded pick), and the combine runs on them as in ``moe_ffn``. No
    contraction is split, so the result is the unsharded one; the price is
    an all-sum of (tokens x top_k, D) picks a layer.

    A replica whose tokens are a part of one group (a decode step's few
    rows a replica, the group the whole batch's) takes ``carry``: the
    caller passes one dict to the group's replicas in order within a
    layer, and each replica's tokens follow the slots its predecessors
    claimed (their per-expert counts, sent on by ``partition.send``), so
    every assignment keeps the slot and the drop it has in the whole
    group. Such a replica fills a whole group's buffer, its own tokens in
    their slots.
    """
    M = len(ps)
    B, S, D = xs[0].shape
    El = ps[0]["we_gate"].shape[0]
    E = El * M
    T = B * S
    gs = min(cfg.moe_group_size, total_tokens)
    part = bool(T % gs)
    if part and (carry is None or gs % T):
        raise ValueError(f"a data replica's {T} tokens do not hold whole "
                         f"MoE groups of {gs}")
    G, n = (1, T) if part else (T // gs, gs)
    K = cfg.top_k
    C = capacity(gs, K, E, cfg.capacity_factor)
    act = L.ActFn(cfg.act)
    xts = [x.reshape(G, n, D) for x in xs]
    routers = all_gather([p["router"] for p in ps], -1)
    if part:  # the first replica of a group starts from no claimed slot
        first = carry.get("seen", 0) % gs == 0
        carry["seen"] = carry.get("seen", 0) + T
        counts = carry.setdefault("counts", {})
    picks, gates = [], []
    for m, (p, xt, router) in enumerate(zip(ps, xts, routers)):
        gate, expert_idx = route(cfg, router, xt)
        if part:
            claimed = (None if first
                       else send(counts[m], xt))
            slot, keep = slots(expert_idx, E, C, claimed)
            mine = torch.nn.functional.one_hot(
                expert_idx.reshape(1, -1), E).sum(1, dtype=torch.int32)
            counts[m] = mine if claimed is None else claimed + mine
        else:
            slot, keep = slots(expert_idx, E, C)
        if _RECORDS and m == 0:
            _note(keep, 0 if not part or first else M)
        gates.append(gate.reshape(G, n * K) * keep.to(gate.dtype))
        lo = m * El * C
        inside = (slot >= lo) & (slot < lo + El * C)
        local = torch.where(inside, slot - lo, El * C)
        rows = local + (El * C + 1) * torch.arange(G, device=xt.device)[:,
                                                                        None]
        xk = xt[:, :, None, :].expand(G, n, K, D).reshape(G * n * K, D)
        buf = xt.new_zeros((G * (El * C + 1), D)).index_copy(
            0, rows.reshape(-1), xk)
        buffers = buf.view(G, El * C + 1, D)[:, :El * C].reshape(G, El, C, D)
        be = buffers.permute(1, 0, 2, 3).reshape(El, G * C, D)
        g = act(L.matmul_f32(be, p["we_gate"]))
        u = L.matmul_f32(be, p["we_up"])
        out_e = L.matmul_f32((g * u).to(xt.dtype), p["we_down"]).to(xt.dtype)
        out_buf = out_e.reshape(El, G, C, D).permute(1, 0, 2, 3)
        flat = torch.cat([out_buf.reshape(G, El * C, D),
                          out_buf.new_zeros((G, 1, D))], dim=1)
        picked = L.gather_rows(flat.reshape(G * (El * C + 1), D), rows)
        picks.append(torch.where(inside[..., None], picked,
                                 picked.new_zeros(())))
    out = []
    for picked, flat_gate in zip(all_sum(picks), gates):
        w = picked * flat_gate[..., None].to(picked.dtype)
        out.append(torch.sum(w.reshape(G, n, K, D), dim=2).reshape(B, S, D))
    return out


def pad_expert_weights(params_layer: dict, n_experts: int,
                       multiple: int = 16) -> dict:
    """Zero-pad the expert dimension of stacked MoE weights to a multiple
    of ``multiple`` (router logits for padded experts are masked)."""
    E = padded_experts(n_experts, multiple)
    if E == n_experts:
        return params_layer
    out = dict(params_layer)
    pad = E - n_experts
    for name in ("we_gate", "we_up", "we_down"):
        w = out[name]  # (..., E, d, f)
        widths = [0, 0, 0, 0, 0, pad]  # F.pad runs from the last axis
        out[name] = torch.nn.functional.pad(w, widths)
    r = out["router"]  # (..., D, E)
    out["router"] = torch.nn.functional.pad(r, (0, pad))
    return out
