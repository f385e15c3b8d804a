"""Clustered (IVF) top-k probes: Hopper kernels + plain versions.

PyTorch counterpart of ``repro.kernels.ivf_probe``. The clustered index
(``index.ivf``) keeps each cluster's members in ``T`` fixed tiles,

  tile_coords : (C*T, tile_rows, k)   cluster c owns blocks c*T .. c*T+T-1
  tile_ids    : (C*T, tile_rows)      global row ids, -1 = padding/tombstone

and each query visits only the clusters of its probe list ``probes``
(Q, P). Two estimators, each as a kernel wrapper and a plain version that
compute the same (Q, n) result, ascending by (distance, visit position):

  ``ivf_probe`` / ``ivf_probe_scan``        scalar tiles (f32, bf16, int8
                                            with (C, 1) per-cluster scales)
                                            under the Zen/Lwb/Upb estimator;
  ``ivf_probe_pq`` / ``ivf_probe_pq_scan``  uint8 PQ code tiles scored by
                                            per-(query, probe) (M, 256)
                                            tables (``pq.build_luts``).

The wrappers launch the CUDA kernels of ``csrc/ivf_probe.cu`` (Hopper,
sm_90a), take CUDA tensors only and count their launches in ``.launches``.
The plain versions loop over the P*T (probe, tile) steps, gathering one
(Q, tile_rows, .) block per step and merging it into the running best
(``scoring.merge_topk``), as the JAX scans do; they run on any device.
``kernels.ops`` picks between them by the tensors' device.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .scoring import MODE_IDS
from .scoring import estimate_rows
from .scoring import lut_estimate_rows
from .scoring import mask_invalid
from .scoring import merge_topk
from .zen_topk import SMEM_LIMIT, _DTYPE_CODES, _pow2_ceil

Tensor = torch.Tensor

#: PQ table entries per subspace (one uint8 code)
PQ_ENTRIES = 256
#: the shortest candidate buffer of a block-plan block: four chunks of 256
#: rows (one row a thread)
_MIN_CAP = 1024

# The warp plan (csrc/ivf_probe.cu, namespace warp)
#: the widest list the warp plan keeps (one warp sorts and merges it in
#: registers); wider lists take the block plan
WARP_MAX_W = 64
#: warps a block (the kernels' launch bounds) and blocks a query (a
#: portable thread block cluster), at most
_MAX_WARPS = 16
_MAX_CLUSTER = 8
#: rows a warp scores a step: a split of a cluster holds whole steps
_STEP_ROWS = 64
#: radix-select bins (4-byte counters) of a warp-plan block, and the keys
#: its last warp sorts
_BINS = 256
_GATHER = 128
#: the SMs of an H100 SXM: the default of the planner's ``n_sms``
H100_SMS = 132
_KERNELS = {"block": 0, "warp": 1}


@dataclass(frozen=True)
class ProbePlan:
    """The geometry of one probe launch; the kernels take every field as an
    argument and derive none of them itself.

    ``kernel`` names the plan. ``"warp"`` (lists up to ``WARP_MAX_W``
    wide), one launch: each query is served by a cluster of ``cluster``
    blocks of ``warps`` warps, block g taking its probe columns [g * cols,
    (g + 1) * cols), each column cut into ``splits`` items of
    ``split_rows`` rows that the warps take in turn; every live row's key
    goes to the block's candidates in ``smem`` bytes of shared memory
    (one slot for each row of its columns' clusters), beside the PQ tables
    of its columns' first ``m_smem`` subspaces; a radix select finds the
    bound under which the n best lie, one warp sorts those, and the
    cluster's first block merges the blocks' lists and writes the result.
    ``"block"`` (wider lists), two launches: one 256-thread block per
    (query, probe column) keeps a sorted list of ``w`` keys and a buffer of
    ``cap`` candidates in ``smem`` bytes beside the query or the first
    ``m_smem`` subspaces' tables, or, when the lists do not fit
    (``global_lists``), in global scratch; pass 2 merges each query's
    lists ``group`` at a time in ``merge_smem`` bytes of shared memory, or,
    when ``merge_smem`` is 0, each list straight from global memory into a
    running best there. Fields of the other plan are 0.
    """
    kernel: str
    w: int
    cap: int
    global_lists: bool
    smem: int
    m_smem: int
    group: int = 0
    merge_smem: int = 0
    warps: int = 0
    splits: int = 0
    split_rows: int = 0
    cols: int = 0
    cluster: int = 0


def block_plan(n_neighbors: int, n_probe: int, k: int = 0,
               pq_m: int = 0) -> ProbePlan:
    """The block plan of a launch keeping ``n_neighbors`` over ``n_probe``
    columns: scalar tiles of width ``k`` (``pq_m`` = 0) or PQ codes of
    ``pq_m`` subspaces. The buffer holds ``max(1024, w)`` keys, at least a
    list; pass 2 groups as many lists as fit beside the running best."""
    w = _pow2_ceil(n_neighbors)
    cap = max(_MIN_CAP, w)
    lists = 8 * (w + cap)
    if pq_m:
        global_lists = lists + 4 * PQ_ENTRIES > SMEM_LIMIT
        room = SMEM_LIMIT - (0 if global_lists else lists)
        m_smem = min(pq_m, room // (4 * PQ_ENTRIES))
        smem = (0 if global_lists else lists) + 4 * PQ_ENTRIES * m_smem
    else:
        global_lists = lists + 4 * k > SMEM_LIMIT
        m_smem = 0
        smem = 0 if global_lists else lists + 4 * k
    group, merge_smem = 1, 0
    if 8 * 2 * w <= SMEM_LIMIT:
        while group < n_probe and 8 * (2 * group + 1) * w <= SMEM_LIMIT:
            group *= 2
        merge_smem = 8 * (group + 1) * w
    return ProbePlan(kernel="block", w=w, cap=cap, global_lists=global_lists,
                     smem=smem, m_smem=m_smem, group=group,
                     merge_smem=merge_smem)


def warp_smem(slots: int, cols: int, m_smem: int, cluster: int) -> int:
    """Dynamic shared bytes of a warp-plan block: a candidate key for each
    of its ``slots`` rows (rounded up to even) and 128 gathered keys, the
    radix histogram, an inbox of 64 keys for each other block of its
    ``cluster``, then the PQ tables (csrc/ivf_probe.cu,
    warp::smem_bytes)."""
    return (8 * ((slots + 1) // 2 * 2 + _GATHER + (cluster - 1) * WARP_MAX_W)
            + 4 * _BINS + 4 * PQ_ENTRIES * cols * m_smem)


@functools.lru_cache(maxsize=1024)
def probe_plan(n_neighbors: int, n_probe: int, k: int = 0, pq_m: int = 0,
               *, nq: int = 1, cluster_rows: int = 384,
               n_sms: int = H100_SMS) -> ProbePlan:
    """The plan of a probe launch of ``nq`` queries keeping ``n_neighbors``
    over ``n_probe`` clusters of ``cluster_rows`` (T * rows) rows each:
    scalar tiles of width ``k`` (``pq_m`` = 0) or PQ codes of ``pq_m``
    subspaces, on a card of ``n_sms`` SMs; cached.

    Lists up to ``WARP_MAX_W`` wide take the warp plan, wider ones the
    block plan (:func:`block_plan`). The warp plan gives each query as many
    blocks as the SMs share among the queries (at most 8, a cluster), and
    more where its items would leave a warp more than two, or where a
    block's candidates would not fit shared memory (the block plan past 8);
    it cuts each probed cluster into as many splits of whole 64-row steps
    as give its blocks' warps about one item each.
    """
    w = _pow2_ceil(n_neighbors)
    if w > WARP_MAX_W:
        return block_plan(n_neighbors, n_probe, k, pq_m)
    steps = max(1, -(-cluster_rows // _STEP_ROWS))
    cluster = max(1, min(_MAX_CLUSTER, n_sms // max(nq, 1)))
    cluster = 1 << (cluster.bit_length() - 1)
    splits = max(1, min(steps, cluster * _MAX_WARPS // n_probe))
    split_rows = -(-steps // splits) * _STEP_ROWS
    splits = -(-cluster_rows // split_rows)
    while cluster < _MAX_CLUSTER and (
            n_probe * splits > 2 * _MAX_WARPS * cluster
            or warp_smem(-(-n_probe // cluster) * cluster_rows, 0, 0,
                         cluster) > SMEM_LIMIT):
        cluster *= 2
    cols = -(-n_probe // cluster)
    cluster = -(-n_probe // cols)  # every block gets a column
    if warp_smem(cols * cluster_rows, 0, 0, cluster) > SMEM_LIMIT:
        return block_plan(n_neighbors, n_probe, k, pq_m)
    warps = min(_MAX_WARPS, cols * splits)
    m_smem = 0
    if pq_m:
        room = SMEM_LIMIT - warp_smem(cols * cluster_rows, 0, 0, cluster)
        m_smem = min(pq_m, room // (4 * PQ_ENTRIES * cols))
    return ProbePlan(kernel="warp", w=w, cap=0, global_lists=False,
                     smem=warp_smem(cols * cluster_rows, cols, m_smem,
                                    cluster),
                     m_smem=m_smem, warps=warps, splits=splits,
                     split_rows=split_rows, cols=cols, cluster=cluster)


def _check_layout(tile_ids: Tensor, probes: Tensor, ct: int, rows: int,
                  tiles_per_cluster: int, n_neighbors: int) -> None:
    if tile_ids.shape != (ct, rows):
        raise ValueError(f"tile_ids {tuple(tile_ids.shape)} do not match "
                         f"the tiles' (C*T, rows) = ({ct}, {rows})")
    if tiles_per_cluster <= 0 or ct % tiles_per_cluster:
        raise ValueError(f"{ct} tile blocks are not a whole number of "
                         f"clusters of T={tiles_per_cluster} tiles")
    if probes.dim() != 2 or probes.shape[1] == 0:
        raise ValueError(f"probes must be (Q, P) with P >= 1, got "
                         f"{tuple(probes.shape)}")
    if n_neighbors <= 0:
        raise ValueError(f"need n_neighbors > 0, got {n_neighbors}")
    if probes.shape[1] * tiles_per_cluster * rows >= 2 ** 31:
        raise ValueError(
            "P * T * tile_rows must stay below 2**31: the kernels break ties "
            "by the 32-bit visit position")
    if probes.shape[0] * probes.shape[1] >= 2 ** 31:
        raise ValueError("Q * P must stay below 2**31 (one block each)")


def _outputs(plan: ProbePlan, nq: int, n_probe: int, n: int, dev):
    """(partial, pass-1 scratch, pass-2 scratch, out_d, out_i) of a launch:
    only the tensors the plan reads (None for the others: null pointers).
    out_d and out_i are views of one allocation."""
    partial = scratch = merge_scratch = None
    if plan.kernel == "block":
        partial = torch.empty((nq, n_probe, plan.w), dtype=torch.int64,
                              device=dev)
        if plan.global_lists:  # one candidate buffer per (query, column)
            scratch = torch.empty((nq * n_probe, plan.cap),
                                  dtype=torch.int64, device=dev)
        if plan.merge_smem == 0:  # one running best per query
            merge_scratch = torch.empty((nq, plan.w), dtype=torch.int64,
                                        device=dev)
    out = torch.empty((2, nq, n), dtype=torch.int32, device=dev)
    return partial, scratch, merge_scratch, out[0].view(torch.float32), out[1]


def _as(t: Tensor, dtype, dev) -> Tensor:
    """``t`` as a contiguous ``dtype`` tensor on ``dev``: itself when it is
    one already (the checks cost less than a conversion that does
    nothing)."""
    if t.dtype == dtype and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _n_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _on(dev):
    """The device context of a launch on ``dev``; none when it is current."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def ivf_probe(
    queries: Tensor,
    tile_coords: Tensor,
    tile_ids: Tensor,
    probes: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    tiles_per_cluster: int,
    tile_scales: Optional[Tensor] = None,
    plan: Optional[ProbePlan] = None,
) -> Tuple[Tensor, Tensor]:
    """Hopper kernel: each query's ``n_neighbors`` best rows over the tiles
    of its probed clusters -> (Q, n) f32 distances, int32 ids.

    ``tile_coords`` is stored f32, bf16 or int8 (then with (C, 1) f32
    ``tile_scales``); a tile is dequantised to f32 right after the load.
    Slots the probed clusters cannot fill are (+inf, -1). ``probes`` must
    hold cluster ids in [0, C); the kernel skips a column outside it
    instead of reading out of bounds. Every width and ``k`` is served
    (:func:`probe_plan`; ``plan`` forces another, as tests do). Raises for
    CPU tensors, P*T*tile_rows >= 2**31, and when the launch fails.
    """
    if not (queries.is_cuda and tile_coords.is_cuda):
        raise ValueError("ivf_probe launches the CUDA kernel and takes CUDA "
                         "tensors; ivf_probe_scan is the plain version")
    if mode not in MODE_IDS:
        raise ValueError(f"mode must be one of {tuple(MODE_IDS)}, got "
                         f"{mode!r}")
    if tile_coords.dtype not in _DTYPE_CODES:
        raise ValueError(f"tile dtype {tile_coords.dtype} is not one of "
                         f"{tuple(_DTYPE_CODES)}")
    nq, k = queries.shape
    ct, rows, k2 = tile_coords.shape
    if k != k2 or k < 1:
        raise ValueError(f"the ivf_probe kernel takes queries and tiles of "
                         f"one width k >= 1; got {tuple(queries.shape)} and "
                         f"{tuple(tile_coords.shape)}")
    _check_layout(tile_ids, probes, ct, rows, tiles_per_cluster, n_neighbors)
    n_clusters = ct // tiles_per_cluster
    dev = tile_coords.device
    if tile_scales is not None:
        if tile_scales.numel() != n_clusters:
            raise ValueError(f"tile_scales must hold one f32 per cluster, "
                             f"got shape {tuple(tile_scales.shape)} for "
                             f"{n_clusters} clusters")
        tile_scales = _as(tile_scales, torch.float32, dev)
    queries = _as(queries, torch.float32, dev)
    tile_coords = tile_coords.contiguous()
    tile_ids = _as(tile_ids, torch.int32, dev)
    probes = _as(probes, torch.int32, dev)
    n_probe = probes.shape[1]
    cluster_rows = tiles_per_cluster * rows
    if plan is None:
        plan = probe_plan(n_neighbors, n_probe, k=k, nq=nq,
                          cluster_rows=cluster_rows, n_sms=_n_sms(dev))
    # vector loads: k % 4 == 0 and tiles on a boundary of 4 elements
    vec = k % 4 == 0 and \
        tile_coords.data_ptr() % (4 * tile_coords.element_size()) == 0
    partial, scratch, merge_scratch, out_d, out_i = _outputs(
        plan, nq, n_probe, n_neighbors, dev)
    lib = _build.load("ivf_probe")
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ivf_probe_launch(
            queries.data_ptr(), tile_coords.data_ptr(), tile_ids.data_ptr(),
            probes.data_ptr(), _ptr(tile_scales),
            _DTYPE_CODES[tile_coords.dtype], nq, n_probe, n_clusters,
            cluster_rows, k, n_neighbors, MODE_IDS[mode],
            _KERNELS[plan.kernel], plan.w, plan.cap, int(plan.global_lists),
            plan.smem, plan.group, plan.merge_smem, plan.warps, plan.splits,
            plan.split_rows, plan.cols, plan.cluster, int(vec),
            _ptr(partial), _ptr(scratch), _ptr(merge_scratch),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, err, "ivf_probe launch")
    ivf_probe.launches += 1
    return out_d, out_i


ivf_probe.launches = 0


def ivf_probe_pq(
    tile_codes: Tensor,
    tile_ids: Tensor,
    probes: Tensor,
    luts: Tensor,
    n_neighbors: int = 10,
    *,
    tiles_per_cluster: int,
    plan: Optional[ProbePlan] = None,
) -> Tuple[Tensor, Tensor]:
    """Hopper kernel: the PQ probe over (C*T, rows, M) uint8 code tiles with
    the (Q, P, M, 256) f32 tables of ``pq.build_luts`` -> (Q, n) f32
    distances, int32 ids; unfilled slots are (+inf, -1). Every M is served:
    the first subspaces' tables sit in shared memory, the rest are read
    from global memory (:func:`probe_plan`; ``plan`` forces another).
    Raises for CPU tensors, the limits of :func:`ivf_probe`, and when the
    launch fails.
    """
    if not (tile_codes.is_cuda and luts.is_cuda):
        raise ValueError("ivf_probe_pq launches the CUDA kernel and takes "
                         "CUDA tensors; ivf_probe_pq_scan is the plain "
                         "version")
    if tile_codes.dtype != torch.uint8:
        raise ValueError(f"PQ code tiles must be uint8, got "
                         f"{tile_codes.dtype}")
    ct, rows, m = tile_codes.shape
    if m < 1:
        raise ValueError(f"the ivf_probe_pq kernel takes M >= 1 subspaces, "
                         f"got M={m}")
    _check_layout(tile_ids, probes, ct, rows, tiles_per_cluster, n_neighbors)
    nq, n_probe = probes.shape
    if tuple(luts.shape) != (nq, n_probe, m, PQ_ENTRIES):
        raise ValueError(f"luts must be (Q, P, M, {PQ_ENTRIES}) = "
                         f"({nq}, {n_probe}, {m}, {PQ_ENTRIES}), got "
                         f"{tuple(luts.shape)}")
    dev = tile_codes.device
    tile_codes = tile_codes.contiguous()
    tile_ids = _as(tile_ids, torch.int32, dev)
    probes = _as(probes, torch.int32, dev)
    luts = _as(luts, torch.float32, dev)
    cluster_rows = tiles_per_cluster * rows
    if plan is None:
        plan = probe_plan(n_neighbors, n_probe, pq_m=m, nq=nq,
                          cluster_rows=cluster_rows, n_sms=_n_sms(dev))
    if plan.kernel == "warp" and luts.data_ptr() % 16:
        luts = luts.clone()  # the tables are staged by 16-byte loads
    vec = m % 4 == 0 and tile_codes.data_ptr() % 4 == 0  # 4-byte code loads
    partial, scratch, merge_scratch, out_d, out_i = _outputs(
        plan, nq, n_probe, n_neighbors, dev)
    lib = _build.load("ivf_probe")
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ivf_probe_pq_launch(
            tile_codes.data_ptr(), tile_ids.data_ptr(), probes.data_ptr(),
            luts.data_ptr(), nq, n_probe, ct // tiles_per_cluster,
            cluster_rows, m, n_neighbors, _KERNELS[plan.kernel], plan.w,
            plan.cap, int(plan.global_lists), plan.smem, plan.m_smem,
            plan.group, plan.merge_smem, plan.warps, plan.splits,
            plan.split_rows, plan.cols, plan.cluster, int(vec),
            _ptr(partial), _ptr(scratch), _ptr(merge_scratch),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(lib, err, "ivf_probe_pq launch")
    ivf_probe_pq.launches += 1
    return out_d, out_i


ivf_probe_pq.launches = 0


def _scan(n_queries: int, probes: Tensor, tiles_per_cluster: int,
          n_neighbors: int, score, dev) -> Tuple[Tensor, Tensor]:
    """The shared loop of the plain probes: step j visits tile ``j % T`` of
    probe column ``j // T``; ``score(p, b)`` gives the (Q, rows) distances
    of the gathered blocks ``b`` (Q,) of column ``p``."""
    T = tiles_per_cluster
    best_d = torch.full((n_queries, n_neighbors), float("inf"), device=dev)
    best_i = torch.full((n_queries, n_neighbors), -1, dtype=torch.int32,
                        device=dev)
    probes = probes.to(device=dev, dtype=torch.long)
    for j in range(probes.shape[1] * T):
        p, t = divmod(j, T)
        b = probes[:, p] * T + t                   # (Q,) tile block ids
        d, ids = score(p, b)
        d = mask_invalid(d, ids)                   # padding + tombstones
        best_d, best_i = merge_topk(best_d, best_i, d, ids, n_neighbors)
    return best_d, best_i


def ivf_probe_scan(
    queries: Tensor,
    tile_coords: Tensor,
    tile_ids: Tensor,
    probes: Tensor,
    n_neighbors: int = 10,
    mode: str = "zen",
    *,
    tiles_per_cluster: int,
    tile_scales: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`ivf_probe`: a loop over the (probe,
    tile) steps, one gathered (Q, tile_rows, k) block at a time; int8
    blocks are dequantised with their probed cluster's scale."""
    if mode not in MODE_IDS:
        raise ValueError(f"mode must be one of {tuple(MODE_IDS)}, got "
                         f"{mode!r}")
    dev = tile_coords.device
    T, mode_i = tiles_per_cluster, MODE_IDS[mode]
    queries = queries.to(device=dev, dtype=torch.float32)
    tile_ids = tile_ids.to(dev)

    def score(p: int, b: Tensor):
        blk = tile_coords[b].to(torch.float32)     # (Q, rows, k)
        scale = None
        if tile_scales is not None:  # per-query probed-cluster scales
            scale = tile_scales.to(dev, torch.float32)[b // T][:, :, None]
        return (estimate_rows(queries, blk, mode=mode_i, scale=scale),
                tile_ids[b])

    return _scan(queries.shape[0], probes, T, n_neighbors, score, dev)


def ivf_probe_pq_scan(
    tile_codes: Tensor,
    tile_ids: Tensor,
    probes: Tensor,
    luts: Tensor,
    n_neighbors: int = 10,
    *,
    tiles_per_cluster: int,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`ivf_probe_pq`: a loop over the
    (probe, tile) steps, one gathered (Q, rows, M) code block and its
    (Q, M, 256) tables at a time."""
    dev = tile_codes.device
    luts = luts.to(device=dev, dtype=torch.float32)
    tile_ids = tile_ids.to(dev)

    def score(p: int, b: Tensor):
        return lut_estimate_rows(luts[:, p], tile_codes[b]), tile_ids[b]

    return _scan(probes.shape[0], probes, tiles_per_cluster, n_neighbors,
                 score, dev)
