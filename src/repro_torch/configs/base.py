"""Config substrate (PyTorch counterpart of ``repro.configs.base``):
architecture specs, shape cells and the LM, GNN and recsys input specs.

Every architecture module exposes ``spec() -> ArchSpec`` with
  * the exact published configuration (``make_config``),
  * a reduced same-family smoke configuration (``make_reduced``),
  * its shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape: str                      # e.g. "train_batch"
    kind: str                       # train | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None      # reason when the cell is mandated-skipped


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # lm | gnn | recsys
    source: str                     # citation tag from the assignment table
    make_config: Callable[[], Any]
    make_reduced: Callable[[], Any]
    cells: Tuple[ShapeCell, ...]

    def cell(self, shape: str) -> ShapeCell:
        for c in self.cells:
            if c.shape == shape:
                return c
        raise KeyError(f"{self.arch_id} has no shape {shape}")


LM_CELLS = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)


def lm_cells(*, full_attention_only: bool) -> Tuple[ShapeCell, ...]:
    cells = list(LM_CELLS)
    if full_attention_only:
        cells[3] = dataclasses.replace(
            cells[3],
            skip=(
                "pure full-attention arch: long_500k requires sub-quadratic "
                "attention (shape-table instruction; see DESIGN.md "
                "§Arch-applicability)"
            ),
        )
    return tuple(cells)


GNN_CELLS = (
    ShapeCell("full_graph_sm", "train",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_graphs": 1}),
    ShapeCell("minibatch_lg", "train",
              {"n_nodes": 176128, "n_edges": 172032, "d_feat": 602,
               "batch_nodes": 1024, "n_graphs": 1,
               "pool_nodes": 232965, "pool_edges": 114615892}),
    ShapeCell("ogb_products", "train",
              {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
               "n_graphs": 1}),
    ShapeCell("molecule", "train",
              {"n_nodes": 3840, "n_edges": 8192, "d_feat": 16, "n_graphs": 128}),
)

RECSYS_CELLS = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input, with no storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def lm_input_specs(cfg, cell: ShapeCell) -> dict:
    """The inputs of ``cfg`` at ``cell``: the token batch (train, prefill)
    or, for decode, the KV cache ``models.transformer.init_kv_cache``
    makes, the next token and the cache length."""
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    i32 = torch.int32
    if cell.kind == "train":
        return {"batch": {"tokens": TensorSpec((B, S), i32)}}
    if cell.kind == "prefill":
        return {"tokens": TensorSpec((B, S), i32)}
    if cell.kind == "decode":
        dh, KV, G = cfg.head_dim, cfg.n_kv_heads, cfg.n_groups
        cache = {}
        for pos, window in enumerate(cfg.layer_pattern):
            slen = min(window, S) if window else S
            spec = TensorSpec((G, B, slen, KV, dh), cfg.dtype)
            cache[f"pos{pos}"] = {"k": spec, "v": spec}
        return {"cache": cache, "token": TensorSpec((B, 1), i32),
                "cache_len": TensorSpec((), i32)}
    raise ValueError(cell.kind)


def pad_edges(e: int, mult: int = 512) -> int:
    """Edge arrays shard over the data axes; pad to a shardable multiple
    (padding edges carry edge_mask = 0)."""
    return (e + mult - 1) // mult * mult


#: the GNN cells trained per node (the rest per graph)
NODE_LEVEL_CELLS = ("minibatch_lg", "ogb_products")


def gnn_input_specs(cfg, cell: ShapeCell) -> dict:
    """The inputs of ``cfg`` at ``cell``: the graph batch (edges padded by
    ``pad_edges``) and its static entries ``n_graphs`` and
    ``node_level``."""
    d = cell.dims
    N, E, G = d["n_nodes"], pad_edges(d["n_edges"]), d["n_graphs"]
    f32, i32 = torch.float32, torch.int32
    node_level = cell.shape in NODE_LEVEL_CELLS
    batch = {
        "positions": TensorSpec((N, 3), f32),
        "node_feat": TensorSpec((N, d["d_feat"]), f32),
        "senders": TensorSpec((E,), i32),
        "receivers": TensorSpec((E,), i32),
        "edge_mask": TensorSpec((E,), f32),
        "node_mask": TensorSpec((N,), f32),
        "node_graph": TensorSpec((N,), i32),
    }
    if node_level:
        batch["target_nodes"] = TensorSpec((N,), f32)
        batch["loss_node_mask"] = TensorSpec((N,), f32)
    else:
        batch["target_energy"] = TensorSpec((G,), f32)
    return {"batch": batch, "static": {"n_graphs": G,
                                       "node_level": node_level}}


def recsys_input_specs(cfg, cell: ShapeCell) -> dict:
    """The inputs of ``cfg`` at ``cell``: the batch (sparse ids, dense
    features, labels for training) and, for retrieval, the candidates (raw
    or, with ``retrieval_mode="zen"``, the reduced index and transform)."""
    B = cell.dims["batch"]
    f32, i32 = torch.float32, torch.int32
    batch = {"sparse": TensorSpec((B, cfg.n_sparse), i32)}
    if cfg.n_dense:
        batch["dense"] = TensorSpec((B, cfg.n_dense), f32)
    if cell.kind == "train":
        batch["labels"] = TensorSpec((B,), f32)
    out = {"batch": batch}
    if cell.kind == "retrieval":
        n_cand = cell.dims["n_candidates"]
        if cfg.retrieval_mode == "zen":
            k = cfg.zen_k
            out["candidates"] = {
                "coords": TensorSpec((n_cand, k), f32),
                "refs": TensorSpec((k, cfg.embed_dim), f32),
                "chol": TensorSpec((k - 1, k - 1), f32),
                "diag_g": TensorSpec((k - 1,), f32),
                "d0": TensorSpec((k,), f32),
            }
        else:
            out["candidates"] = TensorSpec((n_cand, cfg.embed_dim), f32)
    return out


def input_specs(spec: ArchSpec, cfg, cell: ShapeCell) -> dict:
    return {
        "lm": lm_input_specs,
        "gnn": gnn_input_specs,
        "recsys": recsys_input_specs,
    }[spec.family](cfg, cell)
