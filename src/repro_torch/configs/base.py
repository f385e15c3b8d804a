"""Config substrate (PyTorch counterpart of ``repro.configs.base``):
architecture specs, shape cells and the LM and recsys input specs.

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
    family: str                     # lm | recsys (gnn: ROADMAP A, item 2)
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
    if spec.family == "lm":
        return lm_input_specs(cfg, cell)
    if spec.family == "recsys":
        return recsys_input_specs(cfg, cell)
    raise ValueError(f"the port has no {spec.family} family yet "
                     "(ROADMAP A, item 2)")
