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
#: what each of two blocks on one SM may take (the SM's 228 KB less 1 KB
#: the hardware reserves per block, halved); and the SM's 228 KB
SMEM_LIMIT = 232_448 - 1_024
SMEM_TWO_BLOCKS = 115_712
SMEM_SM = 233_472
#: the most 8-byte keys pass 2 holds in shared memory: n_lists * w is a
#: power of two, and 16,384 keys (128 KB) is the largest within SMEM_LIMIT
_MERGE_KEYS = 16_384

# The SIMT plan (csrc/zen_topk.cu, zen_topk_partial)
#: rows one pass-1 block scores per tile (kTile)
_TILE_ROWS = 512
#: columns staged per pass, with one word of padding per staged row
_X_STRIDE = 17
#: queries per pass-1 block, widest first (the kernel's instantiations)
_BLOCK_QUERIES = (8, 4, 2, 1)

# The MMA plan (csrc/zen_topk.cu, namespace mma)
#: queries a consumer warp owns (the MMA's n)
_WARP_QUERIES = 8
#: consumer warps a block, query groups (8 queries each) and row streams
#: among them, and ring stages, at most; the mbarriers' bytes
_MAX_WARPS = 16
_MAX_GROUPS = 8
_MAX_STREAMS = 4
_MAX_STAGES = 8
_BAR_BYTES = 16 * _MAX_STAGES
#: rows a tile of the ring
_MMA_TILE_ROWS = 128
#: bytes of index rows the ring keeps in flight on an SM
_RING_TARGET = 65_536
#: buffer keys a query (a flush merges up to 64 in registers)
MMA_CAP = 64
#: the widest list the MMA plan keeps (its flushes sort and merge in
#: registers) and its widest rows (one 16-column chunk: over longer dots
#: the tensor cores' truncating accumulation drifts from f32); the rest
#: takes the SIMT plan
MMA_MAX_W = 64
MMA_MAX_K = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KERNELS = {"simt": 0, "mma": 1}


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclass(frozen=True)
class TopkPlan:
    """The geometry of one ``zen_topk`` launch; the kernel takes every
    field as an argument and derives none of them itself.

    ``kernel`` names the pass-1 kernel. ``"mma"``: a (ceil(Q /
    queries_per_block), n_split) grid of blocks, each ``warps`` consumer
    warps of 8 queries in ``streams`` row streams (a stream scores every
    ``streams``-th tile of the split; their lists merge in the block at
    the end) and one producer warp that fills a ring of ``stages`` tiles of
    ``tile_rows`` rows by TMA bulk copies; each (query, stream) keeps a
    sorted list of ``w`` keys and a buffer of ``cap`` candidates in
    ``smem`` bytes of shared memory, ``blocks_per_sm`` blocks an SM.
    ``"simt"``: a grid of 256-thread blocks of ``queries_per_block``
    queries scoring 512-row tiles on the CUDA cores, the lists and buffers
    in shared memory or, when even one query a block does not fit
    (``global_lists``), in global scratch that the wrapper allocates
    (``warps``, ``streams``, ``stages``: 0). Both cut N into ``n_split``
    splits of ``split_rows`` rows. Pass 2 merges each query's
    ``n_lists`` lists (``n_split`` padded to a power of two) in
    ``merge_smem`` bytes of shared memory, or in place in global memory
    when ``merge_smem`` is 0.
    """
    kernel: str
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
    tile_rows: int
    stages: int
    warps: int
    streams: int

    def shares_bound(self, n_out: int) -> bool:
        """Whether the MMA plan's lists share a bound across blocks: it
        needs n_out buckets a query, each fed by at least one list."""
        return self.kernel == "mma" and self.n_split * self.streams >= n_out

    @property
    def route(self) -> str:
        """How pass 1 loads the index and scores it."""
        if self.kernel == "mma":
            return "TMA bulk copies; mma.sync m16n8k8 3xTF32"
        return "register-staged loads; f32 FMA on the CUDA cores"


def simt_smem(k: int, w: int, cap: int, queries_per_block: int,
              global_lists: bool) -> int:
    """Dynamic shared memory of a SIMT pass-1 block, as csrc/zen_topk.cu
    lays it out: the lists and buffers (8-byte keys) and the staged queries
    unless they live in global memory, then the staged tile, the per-query
    norm, altitude and bound (f32) and the buffer counts (int32)."""
    kq = queries_per_block
    lists = 0 if global_lists else 8 * kq * (w + cap) + 4 * kq * k
    return lists + 4 * (_TILE_ROWS * _X_STRIDE + 3 * kq) + 4 * kq


def mma_stage_bytes(tile_rows: int, k: int, elem_bytes: int) -> int:
    """One ring stage of the MMA plan: the rows (rounded up to 16 B), then
    their f32 scales."""
    return ((tile_rows * k * elem_bytes + 15) & ~15) + 4 * tile_rows


def mma_smem(k: int, elem_bytes: int, w: int, warps: int, tile_rows: int,
             stages: int) -> int:
    """Dynamic shared memory of an MMA pass-1 block: the mbarriers, the
    ring, then each consumer warp's 8 lists (w keys) and buffers
    (``MMA_CAP`` keys)."""
    return (_BAR_BYTES + stages * mma_stage_bytes(tile_rows, k, elem_bytes)
            + 8 * warps * _WARP_QUERIES * (w + MMA_CAP))


def _splits(n_index: int, want: int, tile_rows: int, w: int,
            merge_cap: bool):
    """(n_split, split_rows, n_lists, merge_smem): at most ``want`` splits
    of whole tiles, none empty; while ``merge_cap``, no more lists than pass
    2 merges in shared memory."""
    n_split = min(want, -(-n_index // tile_rows))
    if merge_cap:
        n_split = min(n_split, max(1, _MERGE_KEYS // w))
    per_split = -(-n_index // max(n_split, 1))
    split_rows = -(-per_split // tile_rows) * tile_rows
    n_split = -(-n_index // split_rows)
    n_lists = _pow2_ceil(n_split)
    merge_smem = 8 * n_lists * w if n_lists * w <= _MERGE_KEYS else 0
    return n_split, split_rows, n_lists, merge_smem


def _mma_plan(nq: int, n_index: int, w: int, k: int, n_sms: int,
              elem_bytes: int) -> Optional[TopkPlan]:
    if w > MMA_MAX_W or k > MMA_MAX_K:
        return None
    tile_rows = _MMA_TILE_ROWS
    stage = mma_stage_bytes(tile_rows, k, elem_bytes)

    def fits(warps: int, stages: int) -> bool:
        return mma_smem(k, elem_bytes, w, warps, tile_rows,
                        stages) <= SMEM_LIMIT

    groups = min(_MAX_GROUPS, -(-nq // _WARP_QUERIES))
    while not fits(groups, 2):
        if groups == 1:
            return None
        groups //= 2
    # more row streams (up to 4) while their warps and two stages each fit;
    # a stage always serves one stream (stages a multiple of streams), so
    # each stream waits on its stages' mbarrier phases in turn
    streams = 1
    while (2 * streams <= _MAX_STREAMS
           and groups * streams * 2 <= _MAX_WARPS
           and fits(groups * streams * 2, 4 * streams)):
        streams *= 2
    warps = groups * streams
    # ~64 KB in flight, two stages a stream at least
    stages = min(_MAX_STAGES, max(-(-_RING_TARGET // stage), 2 * streams))
    stages -= stages % streams
    while not fits(warps, stages):
        stages -= streams
    smem = mma_smem(k, elem_bytes, w, warps, tile_rows, stages)
    blocks_per_sm = max(1, min(_MAX_WARPS // warps,
                               SMEM_SM // (smem + 1_024)))
    per_block = groups * _WARP_QUERIES
    q_blocks = -(-nq // per_block)
    n_split, split_rows, n_lists, merge_smem = _splits(
        n_index, -(-blocks_per_sm * n_sms // q_blocks), tile_rows, w, True)
    return TopkPlan(kernel="mma", w=w, queries_per_block=per_block,
                    cap=MMA_CAP,
                    global_lists=False, smem=smem,
                    blocks_per_sm=blocks_per_sm, n_split=n_split,
                    split_rows=split_rows, n_lists=n_lists,
                    merge_smem=merge_smem, tile_rows=tile_rows,
                    stages=stages, warps=warps, streams=streams)


def _simt_plan(nq: int, n_index: int, w: int, k: int,
               n_sms: int) -> TopkPlan:
    cap = max(2 * _TILE_ROWS, w)
    for kq in _BLOCK_QUERIES:
        smem = simt_smem(k, w, cap, kq, False)
        if smem <= SMEM_LIMIT:
            global_lists = False
            break
    else:
        kq, global_lists = 1, True
        smem = simt_smem(k, w, cap, 1, True)
    blocks_per_sm = 2 if smem <= SMEM_TWO_BLOCKS else 1
    q_blocks = -(-nq // kq)
    want = min(-(-blocks_per_sm * n_sms // q_blocks), max(1, n_index // w))
    n_split, split_rows, n_lists, merge_smem = _splits(
        n_index, want, _TILE_ROWS, w, not global_lists)
    return TopkPlan(kernel="simt", w=w, queries_per_block=kq, cap=cap,
                    global_lists=global_lists, smem=smem,
                    blocks_per_sm=blocks_per_sm, n_split=n_split,
                    split_rows=split_rows, n_lists=n_lists,
                    merge_smem=merge_smem, tile_rows=_TILE_ROWS, stages=0,
                    warps=0, streams=0)


def simt_plan(nq: int, n_index: int, n_out: int, k: int,
              n_sms: int) -> TopkPlan:
    """The SIMT plan of a launch, whatever the width (what
    ``launch_geometry`` gives past the MMA plan)."""
    return _simt_plan(nq, n_index, _pow2_ceil(n_out), k, n_sms)


def launch_geometry(nq: int, n_index: int, n_out: int, k: int, n_sms: int,
                    elem_bytes: int = 4) -> TopkPlan:
    """The plan of one launch for Q = ``nq`` queries of width ``k`` over
    ``n_index`` rows of ``elem_bytes`` a coordinate, keeping ``n_out``
    neighbours, on ``n_sms`` SMs.

    ``w`` is the list width (a power of two >= n_out). The MMA plan serves
    w <= ``MMA_MAX_W`` and k <= ``MMA_MAX_K`` (every flush sorts and merges
    in registers; the dot is one 16-column chunk): up to 8 query groups of
    8 queries a block (as
    many as the queries need, fewer where their lists do not fit), as many
    row streams (1, 2 or 4) as keep the consumer warps within 16 and their
    lists within shared memory, tiles of 128 rows, as many stages (a
    multiple of the streams, 2 to 8) as keep ~64 KB in flight, buffers of
    64 keys, and
    enough splits to give each SM its blocks. Everything else takes the
    SIMT plan: its buffer holds ``max(2 * 512, w)`` keys, a block the most
    queries (8, 4, 2, 1) whose lists fit shared memory, else one query with
    its lists in global memory, and two blocks an SM where two fit. Both
    cut N into contiguous splits of whole tiles, none shorter than one list
    (SIMT) and, while the lists sit in shared memory, no more than pass 2
    merges there.
    """
    w = _pow2_ceil(n_out)
    plan = _mma_plan(nq, n_index, w, k, n_sms, elem_bytes)
    return plan if plan is not None else _simt_plan(nq, n_index, w, k,
                                                    n_sms)


def zen_topk(
    queries: Tensor,
    index: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    scales: Optional[Tensor] = None,
    plan: Optional[TopkPlan] = None,
) -> Tuple[Tensor, Tensor]:
    """Hopper kernel: (Q, k) x (N, k) -> (Q, n) f32 distances, int32 ids.

    ``index`` is stored float32, bfloat16 or int8 (then with (N, 1) or (N,)
    f32 row ``scales``); rows are dequantised to f32 in the kernel right
    after the load. ``n`` is ``n_neighbors`` clamped to N; every width and
    ``k`` is served (:func:`launch_geometry`). Rows come back ascending by
    (distance, id). ``plan`` replaces the planner's (tests and timings
    compare the two plans with it). Raises for CPU tensors, an index of
    2**31 rows or more, and when the launch fails.
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
    if plan is None:
        plan = launch_geometry(nq, n_index, n_out, k, n_sms,
                               index.element_size())
    if plan.kernel == "mma":  # TMA bulk copies read from 16-byte boundaries
        if index.data_ptr() % 16:
            index = index.clone()
        if scales is not None and scales.data_ptr() % 16:
            scales = scales.clone()
    partial = torch.empty((nq, plan.n_lists, plan.w), dtype=torch.int64,
                          device=dev)
    scratch = None
    if plan.global_lists:  # one candidate buffer per (query, split)
        scratch = torch.empty((nq * plan.n_split, plan.cap),
                              dtype=torch.int64, device=dev)
    elif plan.shares_bound(n_out):  # n_out buckets a query (the kernel fills)
        scratch = torch.empty((nq, n_out), dtype=torch.int64, device=dev)
    out_d = torch.empty((nq, n_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_out), dtype=torch.int32, device=dev)
    lib = _build.load("zen_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zen_topk_launch(
            queries.data_ptr(), index.data_ptr(),
            None if scales is None else scales.data_ptr(),
            _DTYPE_CODES[index.dtype], nq, n_index, k, n_out, MODE_IDS[mode],
            _KERNELS[plan.kernel], plan.w, plan.queries_per_block, plan.cap,
            int(plan.global_lists), plan.smem, plan.n_split, plan.split_rows,
            plan.n_lists, plan.merge_smem, plan.tile_rows, plan.stages,
            plan.warps, plan.streams, partial.data_ptr(),
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
