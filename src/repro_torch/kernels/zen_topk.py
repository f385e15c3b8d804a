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

from typing import Optional, Tuple

import torch

from . import _build
from .scoring import MODE_IDS
from .scoring import estimate_tile
from .scoring import merge_topk

Tensor = torch.Tensor

#: widest coordinate row and longest result list the kernel takes
MAX_K = 256
MAX_NEIGHBORS = 256

#: rows one pass-1 block scores per tile and queries per block
#: (kTile, kQueries in csrc/zen_topk.cu)
_TILE_ROWS = 512
_BLOCK_QUERIES = 8
#: pass 2 holds n_split * w keys of 8 bytes (n_split rounded up to a power
#: of two) in shared memory
_MERGE_KEYS = 8192

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def launch_geometry(nq: int, n_index: int, n_out: int,
                    n_sms: int) -> Tuple[int, int, int]:
    """(w, n_split, split_rows) of one launch.

    ``w`` is the per-split list width (a power of two >= n_out). N is cut
    into ``n_split`` contiguous splits of ``split_rows`` rows (a multiple
    of the tile): enough blocks for two per SM, but no split shorter than
    one tile and no more lists than pass 2 holds in shared memory.
    """
    w = _pow2_ceil(n_out)
    q_blocks = -(-nq // _BLOCK_QUERIES)
    n_split = min(-(-2 * n_sms // q_blocks), _MERGE_KEYS // w,
                  -(-n_index // _TILE_ROWS))
    per_split = -(-n_index // n_split)
    split_rows = -(-per_split // _TILE_ROWS) * _TILE_ROWS
    return w, -(-n_index // split_rows), split_rows


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
    after the load. ``n`` is ``n_neighbors`` clamped to N. Rows come back
    ascending by (distance, id). Raises for CPU tensors, for shapes past
    ``MAX_K``/``MAX_NEIGHBORS``, and when the launch fails.
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
    n_out = min(n_neighbors, n_index)
    if k > MAX_K or n_out > MAX_NEIGHBORS:
        raise ValueError(
            f"the zen_topk kernel takes k <= {MAX_K} and n_neighbors <= "
            f"{MAX_NEIGHBORS}; got k={k}, n_neighbors={n_out}")
    dev = index.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    index = index.contiguous()
    if scales is not None:
        if scales.numel() != n_index:
            raise ValueError(f"scales must hold one f32 per row, got shape "
                             f"{tuple(scales.shape)} for {n_index} rows")
        scales = scales.to(device=dev, dtype=torch.float32).contiguous()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w, n_split, split_rows = launch_geometry(nq, n_index, n_out, n_sms)
    partial = torch.empty((nq, n_split, w), dtype=torch.int64, device=dev)
    out_d = torch.empty((nq, n_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_out), dtype=torch.int32, device=dev)
    lib = _build.load("zen_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zen_topk_launch(
            queries.data_ptr(), index.data_ptr(),
            None if scales is None else scales.data_ptr(),
            _DTYPE_CODES[index.dtype], nq, n_index, k, n_out, w, n_split,
            split_rows, MODE_IDS[mode], partial.data_ptr(), out_d.data_ptr(),
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
