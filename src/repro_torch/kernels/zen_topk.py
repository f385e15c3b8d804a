"""Streaming fused Zen/Lwb/Upb top-k retrieval: Hopper kernel + plain version.

PyTorch counterpart of ``repro.kernels.zen_topk``. Two functions compute
the same thing — each query's ``n`` nearest index rows under an estimator,
ascending by (distance, row id), without the (Q, N) distance matrix:

  ``zen_topk``       the wrapper of the CUDA kernel ``csrc/zen_topk.cu``
                     (Hopper, sm_90a). It takes CUDA tensors only and counts
                     its launches in ``zen_topk.launches``.
  ``zen_topk_scan``  the plain PyTorch version: a loop over index chunks
                     with the same estimator (``scoring.estimate_tile``) and
                     the same merge (``scoring.merge_topk``), clamping the
                     tail chunk as the JAX scan does. It runs on any device;
                     the CPU path and the kernel's checks use it.

``kernels.ops.zen_topk`` picks between them by the tensors' device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .scoring import MODE_IDS
from .scoring import estimate_tile
from .scoring import merge_topk

Tensor = torch.Tensor

#: dynamic shared memory a plan gives one block: the 227 KB (232,448 B) a
#: block may take on an H100, less 1 KB left for the kernels' static
#: __shared__ variables (16 B in the probes, none in zen_topk, per ptxas);
#: and what each of two blocks on one SM may take (the SM's 228 KB less
#: 1 KB the hardware reserves per block, halved)
SMEM_LIMIT = 232_448 - 1_024
SMEM_TWO_BLOCKS = 115_712

#: rows one pass-1 block scores per tile (kTile in csrc/zen_topk.cu)
_TILE_ROWS = 512
#: columns staged per pass, with one word of padding per staged row
_X_STRIDE = 17
#: queries per pass-1 block, widest first (the kernel's instantiations)
_BLOCK_QUERIES = (8, 4, 2, 1)
#: the most 8-byte keys pass 2 holds in shared memory: n_lists * w is a
#: power of two, and 16,384 keys (128 KB) is the largest within SMEM_LIMIT
_MERGE_KEYS = 16_384

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclass(frozen=True)
class TopkPlan:
    """The geometry of one ``zen_topk`` launch; the kernel takes every
    field as an argument and derives none of them itself.

    Pass 1 runs a (ceil(Q / queries_per_block), n_split) grid; each block
    keeps, per query, a sorted list of ``w`` keys and a buffer of ``cap``
    unsorted candidates. They sit in ``smem`` bytes of shared memory, or,
    when even one query a block does not fit (``global_lists``), in global
    scratch that the wrapper allocates. Pass 2 merges each query's
    ``n_lists`` lists (``n_split`` padded to a power of two) in
    ``merge_smem`` bytes of shared memory, or in place in global memory
    when ``merge_smem`` is 0.
    """
    w: int
    queries_per_block: int
    cap: int
    global_lists: bool
    smem: int
    blocks_per_sm: int
    n_split: int
    split_rows: int
    n_lists: int
    merge_smem: int


def pass1_smem(k: int, w: int, cap: int, queries_per_block: int,
               global_lists: bool) -> int:
    """Dynamic shared memory of a pass-1 block, as csrc/zen_topk.cu lays it
    out: the lists and buffers (8-byte keys) and the staged queries unless
    they live in global memory, then the staged tile, the per-query norm,
    altitude and bound (f32) and the buffer counts (int32)."""
    kq = queries_per_block
    lists = 0 if global_lists else 8 * kq * (w + cap) + 4 * kq * k
    return lists + 4 * (_TILE_ROWS * _X_STRIDE + 3 * kq) + 4 * kq


def launch_geometry(nq: int, n_index: int, n_out: int, k: int,
                    n_sms: int) -> TopkPlan:
    """The plan of one launch for Q = ``nq`` queries of width ``k`` over
    ``n_index`` rows, keeping ``n_out`` neighbours, on ``n_sms`` SMs.

    ``w`` is the list width (a power of two >= n_out) and the candidate
    buffer holds ``max(2 * kTile, w)`` keys, at least a list. A block takes
    the most queries (8, 4, 2, 1) whose lists fit shared memory, else one
    query with its lists in global memory. N is cut into ``n_split``
    contiguous splits of ``split_rows`` rows (a multiple of the tile):
    enough blocks to fill every SM (two a SM where two fit), but no split
    shorter than one tile or than one list, and, while pass 1 keeps its
    lists in shared memory, no more lists than pass 2 merges there.
    """
    w = _pow2_ceil(n_out)
    cap = max(2 * _TILE_ROWS, w)
    for kq in _BLOCK_QUERIES:
        smem = pass1_smem(k, w, cap, kq, False)
        if smem <= SMEM_LIMIT:
            global_lists = False
            break
    else:
        kq, global_lists = 1, True
        smem = pass1_smem(k, w, cap, 1, True)
    blocks_per_sm = 2 if smem <= SMEM_TWO_BLOCKS else 1
    q_blocks = -(-nq // kq)
    n_split = min(-(-blocks_per_sm * n_sms // q_blocks),
                  -(-n_index // _TILE_ROWS), max(1, n_index // w))
    if not global_lists:
        n_split = min(n_split, max(1, _MERGE_KEYS // w))
    per_split = -(-n_index // n_split)
    split_rows = -(-per_split // _TILE_ROWS) * _TILE_ROWS
    n_split = -(-n_index // split_rows)
    n_lists = _pow2_ceil(n_split)
    merge_smem = 8 * n_lists * w if n_lists * w <= _MERGE_KEYS else 0
    return TopkPlan(w=w, queries_per_block=kq, cap=cap,
                    global_lists=global_lists, smem=smem,
                    blocks_per_sm=blocks_per_sm, n_split=n_split,
                    split_rows=split_rows, n_lists=n_lists,
                    merge_smem=merge_smem)


def zen_topk(
    queries: Tensor,
    index: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    scales: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Hopper kernel: (Q, k) x (N, k) -> (Q, n) f32 distances, int32 ids.

    ``index`` is stored float32, bfloat16 or int8 (then with (N, 1) or (N,)
    f32 row ``scales``); rows are dequantised to f32 in the kernel right
    after the load. ``n`` is ``n_neighbors`` clamped to N; every width and
    ``k`` is served (:func:`launch_geometry`). Rows come back ascending by
    (distance, id). Raises for CPU tensors, an index of 2**31 rows or more,
    and when the launch fails.
    """
    if not (queries.is_cuda and index.is_cuda):
        raise ValueError("zen_topk launches the CUDA kernel and takes CUDA "
                         "tensors; zen_topk_scan is the plain version")
    if mode not in MODE_IDS:
        raise ValueError(f"mode must be one of {tuple(MODE_IDS)}, got "
                         f"{mode!r}")
    if index.dtype not in _DTYPE_CODES:
        raise ValueError(f"index dtype {index.dtype} is not one of "
                         f"{tuple(_DTYPE_CODES)}")
    nq, k = queries.shape
    n_index, k2 = index.shape
    if k != k2:
        raise ValueError(f"queries {tuple(queries.shape)} and index "
                         f"{tuple(index.shape)} differ in width")
    if n_neighbors <= 0 or n_index == 0:
        raise ValueError("need n_neighbors > 0 and a non-empty index")
    if n_index >= 2 ** 31:
        raise ValueError("row ids are int32: the index must hold < 2**31 rows")
    if k == 0:
        raise ValueError("need coordinates of width k >= 1")
    n_out = min(n_neighbors, n_index)
    dev = index.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    index = index.contiguous()
    if scales is not None:
        if scales.numel() != n_index:
            raise ValueError(f"scales must hold one f32 per row, got shape "
                             f"{tuple(scales.shape)} for {n_index} rows")
        scales = scales.to(device=dev, dtype=torch.float32).contiguous()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_geometry(nq, n_index, n_out, k, n_sms)
    partial = torch.empty((nq, plan.n_lists, plan.w), dtype=torch.int64,
                          device=dev)
    scratch = None
    if plan.global_lists:  # one candidate buffer per (query, split)
        scratch = torch.empty((nq * plan.n_split, plan.cap),
                              dtype=torch.int64, device=dev)
    out_d = torch.empty((nq, n_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_out), dtype=torch.int32, device=dev)
    lib = _build.load("zen_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zen_topk_launch(
            queries.data_ptr(), index.data_ptr(),
            None if scales is None else scales.data_ptr(),
            _DTYPE_CODES[index.dtype], nq, n_index, k, n_out, MODE_IDS[mode],
            plan.w, plan.queries_per_block, plan.cap, int(plan.global_lists),
            plan.smem, plan.n_split, plan.split_rows, plan.n_lists,
            plan.merge_smem, partial.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    _build.check(lib, err, "zen_topk launch")
    zen_topk.launches += 1
    return out_d, out_i


zen_topk.launches = 0


def zen_topk_scan(
    queries: Tensor,
    index: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    scales: Optional[Tensor] = None,
    chunk: int = 4096,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: a loop over index chunks with a running top-k.

    Peak live distance state is one (Q, chunk) block plus the (Q, n)
    running best. The index is sliced in place; the final chunk is clamped
    back to ``N - chunk`` and its already-visited rows are masked to +inf,
    as the JAX scan does. ``scales`` (N, 1) dequantises an int8 index chunk
    by chunk.
    """
    if mode not in MODE_IDS:
        raise ValueError(f"mode must be one of {tuple(MODE_IDS)}, got "
                         f"{mode!r}")
    nq = queries.shape[0]
    n = index.shape[0]
    if n_neighbors <= 0 or n == 0:
        raise ValueError("need n_neighbors > 0 and a non-empty index")
    n_neighbors = min(n_neighbors, n)
    chunk = min(chunk, n)
    mode_i = MODE_IDS[mode]
    dev = index.device
    queries = queries.to(device=dev, dtype=torch.float32)
    if scales is not None:
        scales = scales.reshape(n, 1)
    best_d = torch.full((nq, n_neighbors), float("inf"), device=dev)
    best_i = torch.full((nq, n_neighbors), -1, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for i in range(-(-n // chunk)):
        start = min(i * chunk, n - chunk)  # clamp the tail chunk
        d = estimate_tile(
            queries, index[start:start + chunk], mode=mode_i,
            scale=None if scales is None else scales[start:start + chunk])
        ids = torch.arange(start, start + chunk, dtype=torch.int32,
                           device=dev)[None, :]
        # a clamped tail revisits rows of the previous chunk: mask them out
        d = torch.where(ids >= i * chunk, d, inf)
        best_d, best_i = merge_topk(best_d, best_i, d, ids, n_neighbors)
    return best_d, best_i
