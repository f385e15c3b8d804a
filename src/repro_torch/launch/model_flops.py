"""Analytic MODEL_FLOPS per cell, the 'useful compute' of a step (PyTorch
counterpart of ``repro.launch.model_flops``; arithmetic only).

Conventions (the reference's):
* LM train:   6 * N_active * tokens  (fwd 2x + bwd 4x) + causal attention
              12 * L * B * S^2/2 * H * dh (score+out, fwd+bwd)
* LM prefill: 2 * N_active * tokens + attention fwd term
* LM decode:  2 * N_active * B  + 4 * L * B * S_cache * KV_eff * dh
* GNN train:  3 * (edge-path flops + node-mix flops)  (fwd + 2x bwd)
* RecSys:     3x (train) or 1x (serve) the dense MLP/interaction flops;
              embedding GATHERS are bytes, not flops, and are excluded.

All values are GLOBAL (the whole cell). The reference takes a lowering plan
(``estimate(build_plan(arch, shape))``); the port takes its three inputs,
``estimate(arch_id, shape, cfg)``, and binds a GNN config to the cell's
feature width as the plan does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import configs as C
from repro_torch.models import mace


def estimate(arch_id: str, shape: str, cfg) -> dict:
    """``model_flops_global``, ``param_count`` and ``active_param_count``
    of ``cfg`` (the architecture's published or reduced config) at the
    cell ``shape``."""
    spec = C.get_arch(arch_id)
    cell = spec.cell(shape)
    fn = {"lm": _lm, "gnn": _gnn, "recsys": _recsys}[spec.family]
    flops, n_params, n_active = fn(cfg, cell)
    return {
        "model_flops_global": float(flops),
        "param_count": int(n_params),
        "active_param_count": int(n_active),
    }


def _lm(cfg, cell):
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    N = cfg.param_count()
    Na = cfg.active_param_count()
    L, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim

    # attention fwd: QK^T + PV = 2 matmuls x 2 flops/MAC over S^2/2 causal
    # positions, per layer per batch row
    attn_fwd = 4 * L * B * (S * S / 2) * H * dh

    if cell.kind == "train":
        tokens = B * S
        dense = 6 * Na * tokens
        return dense + 3 * attn_fwd, N, Na       # bwd = 2x fwd
    if cell.kind == "prefill":
        tokens = B * S
        dense = 2 * Na * tokens
        return dense + attn_fwd, N, Na
    if cell.kind == "decode":
        dense = 2 * Na * B
        # one query against S cached positions, per layer; GQA contracts over
        # H query heads (kv replicated logically)
        eff_S = 0
        for w in cfg.layer_pattern:
            eff_S += min(w, S) if w else S
        eff_S /= len(cfg.layer_pattern)
        attn = 2 * 2 * L * B * eff_S * H * dh
        return dense + attn, N, Na
    raise ValueError(cell.kind)


def _gnn(cfg, cell):
    cfg = dataclasses.replace(cfg, d_feat=cell.dims["d_feat"])
    E, Nn = cell.dims["n_edges"], cell.dims["n_nodes"]
    Ch = cfg.channels
    irrep = 1 + 3 + 9
    # per edge: radial MLP + path products + weighting
    rad = 2 * (cfg.n_rbf * cfg.radial_hidden
               + cfg.radial_hidden * Ch * mace.N_A_PATHS)
    paths = 40 * Ch            # ~#mul-adds across the 12 Cartesian paths
    per_edge = rad + paths
    # per node: B-basis products + channel mixing linears + self linears
    mix = 2 * Ch * Ch * (mace.N_MSG0 + 3 * mace.N_MSG1 + 9 * mace.N_MSG2
                         + irrep)
    corr = 120 * Ch
    per_node = mix + corr
    fwd = cfg.n_layers * (E * per_edge + Nn * per_node) + \
        2 * Nn * cfg.d_feat * Ch
    # the parameters, counted from the port's model shapes (no storage)
    n_params = sum(p.numel() for p in mace.MACE(
        cfg, device=torch.device("meta")).parameters())
    return 3 * fwd, n_params, n_params  # train: fwd + 2x bwd


def _recsys(cfg, cell):
    B = cell.dims["batch"]
    F, d = cfg.n_sparse, cfg.embed_dim

    def mlp_flops(dims):
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))

    per_ex = 0
    if cfg.model == "dlrm":
        per_ex += mlp_flops((cfg.n_dense,) + cfg.bot_mlp)
        nf = F + 1
        per_ex += 2 * nf * nf * d  # dot interaction
        per_ex += mlp_flops((nf * (nf - 1) // 2 + cfg.bot_mlp[-1],)
                            + cfg.top_mlp)
    elif cfg.model == "autoint":
        di = d
        for _ in range(cfg.n_attn_layers):
            do = cfg.n_heads * cfg.d_attn
            per_ex += 4 * 2 * F * di * do + 2 * 2 * F * F * do
            di = do
        per_ex += 2 * F * di
    elif cfg.model == "wide_deep":
        per_ex += mlp_flops((F * d,) + cfg.mlp + (1,))
    elif cfg.model == "xdeepfm":
        hk = F
        for h in cfg.cin_layers:
            per_ex += 2 * hk * F * d + 2 * hk * F * h * d
            hk = h
        per_ex += mlp_flops((F * d,) + cfg.mlp + (1,))
    # per_ex already counts 2 flops/MAC; train = fwd + 2x bwd = 3x fwd
    mult = 3 if cell.kind == "train" else 1
    flops = mult * per_ex * B
    if cell.kind == "retrieval":
        flops = 2 * B * cell.dims["n_candidates"] * d
    n_params = cfg.total_rows * d
    return flops, n_params, n_params
