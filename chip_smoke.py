"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the Hopper
kernels, holds each against its plain PyTorch version, serves the flat, the
IVF and the tiered (host-offloaded) IVF index end to end at full size,
churns, snapshots and reloads them, serves them through the micro-batching
frontend and a hot-swapping replica, runs the paper's evaluation (Zen
against PCA, RP, MDS and LMDS) through the dense kernels, and times the
kernels.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # build + kernel checks (phases 1-3, 7,
                                     # 11, 14)
    python3 chip_smoke.py --sharded  # phases 1-3, the f32 build and serve
                                     # of phase 8, and phase 20 (on four
                                     # cards where there are four)

Phases:
  1. the device, and its name and power limit as nvidia-smi reports them;
  2. build every kernel from src/repro_torch/kernels/csrc (nvcc, sm_90a);
  3. zen_topk against zen_topk_scan on the card: every mode x storage,
     Q in {2, 64}, n in {10, 64, 128}, N = 1,000,000 and 1,000,003, a small
     N with n > N, an index holding dead (_DEAD_COORD) rows, 64 exact
     copies of 1,000 rows (ids equal, the lower id first), and k in {1, 2,
     13, 130} for every storage;
  4. serve: build_index on a 1,000,000 x 256 f32 manifold corpus (k = 16,
     flat, re-rank 4), 8 batches of 64 queries through ZenServer.query,
     recall@10 against an exact brute-force top-10, p50/p99 request
     latency; plus the card's answers against the CPU path on a small
     index. The kernel's launch count must advance;
  5. churn: delete and upsert ids, query, compact, query; no deleted id
     may come back;
  6. time the kernel at the serving shape (Q = 64, N = 1e6, k = 16, n = 64)
     with CUDA events, per call and queued back to back on the card, pass 1
     and pass 2 apart (torch.profiler), with its plan, beside the bound of
     its route (3xTF32 on the tensor cores or f32 on the CUDA cores, and the
     bytes) and the f32 CUDA-core bound, the plain version and a library
     composite (matmul-form distances + torch.topk); then n = 10 and the
     wide widths 512, 2,048 and 16,384;
  7. ivf_probe and ivf_probe_pq against ivf_probe_scan and
     ivf_probe_pq_scan on the card, on the phase-3 coordinates packed into
     4,000 clusters of 128-row tiles: every mode x f32/bf16/int8 and PQ at
     M = 4, Q in {2, 64}, n in {10, 64, 128}, nprobe in {1, 8, 64}, plus a
     tombstoned index where query 0 probes clusters holding one live row;
     then the warp plan's edge cases on small tiles: duplicated rows in two
     probed clusters (the lower visit position first), tombstoned and
     dummy-slot clusters, k in {1, 2, 13, 16, 130}, ragged T * rows, PQ M
     in {1, 5, 256}, and the warp and block plans at n = 33 and 64;
  8. IVF serving: build_index(index="ivf") on the 1,000,000 x 256 corpus
     (4,000 clusters, 128-row tiles, nprobe 8, re-rank 4), f32 then PQ,
     8 batches of 64 queries, recall@10 (beside the same index served
     through the probe's plain version on the card) and p50/p99; the probe
     kernel's launch count must advance. On a 20,000-row index nprobe = n_clusters
     gives the flat zen_topk answer, and one index built on the card and
     moved to the CPU serves the same answers on both. Each build is made
     twice from equal generators (PQ only when its build takes under 10
     s) and its snapshot arrays must be the same bytes;
  9. IVF churn: delete (served ids too), upsert until T grows, query,
     compact(), query, compact(recluster=True), query; no deleted id may
     come back;
 10. time both probe kernels at the serving shape (Q = 64, nprobe 8, the
     index's T, n = 64) with their plans, passes (profiler) and the host's
     cost a call, split into the plan, the allocations and the ctypes call
     with its launches, beside their bounds, plain versions and library
     composites (gather + matmul-form estimator or table gather +
     torch.topk); then at n = 512 and 2,048, at nprobe 64 and at Q = 2;
 11. dma_copy_blocks against dma_copy_blocks_plain, byte for byte:
     f32/bf16/int8/int32/uint8 x block shapes (128, 16), (128,), (128, 13),
     (5, 7, 3) x B in {1, 2, 3, 257, 1024}, from pinned buffers filled from
     a memory-mapped file, plus views off a 16-byte boundary, and sizes
     from 1 byte to 64 MB that leave the last thread, warp or block step
     partial, at offsets 0, 5 and 16;
 12. tiered serving: phase 8's f32 index offloaded with hot_fraction 0.1,
     the same batches through ZenServer (nprobe 8, re-rank 4): ids equal to
     the resident server's (ties aside) and the same recall@10, p50/p99,
     the device busy share, the tier statistics, dma_copy_blocks launches
     against 2 x cold uploads, and the kernel on one chunk of this run
     beside its bound (bytes over the host link), its plain version and the
     library copy; at 20,000 rows, bf16 and int8 tiered servers on the card
     against the CPU, and all-hot and all-cold tiered indexes against the
     resident one;
 13. snapshots: the 1,000,000-row IVF f32 server (ZenServer.save) and its
     tile pool (TieredIVFZenIndex.save) saved to a temporary directory and
     reloaded (ZenServer.load, and ZenServer.load(pool=, mmap=True)); the
     reloads answer the same batches identically; the flat server
     round-trips at 20,000 rows; save/load seconds and bytes;
 14. the dense kernels pdist_sq, zen_estimate and jsd_pdist against their
     plain versions, in squared space: the sweeps of repro_torch.testing
     (f32 and bf16; ragged N, K and m; every mode, k in {1, 2, 16, 130};
     sparse probability rows and disjoint supports), pdist_sq at the edges
     of its launch plans (PDIST_PLAN_CASES), at m = 4,096 and on nearly
     equal rows of norm ~1,000, operands of two dtypes (bf16 with f32 and
     the reverse) for all three, X against X, and the working shapes of
     phases 15 and 16; pdist_sq's MMA plan also against its SIMT tile;
 15. the paper's evaluation through the public dispatch
     repro_torch.kernels: on the 1,000,000 x 256 corpus, Zen (random,
     farthest_first and maxvol pivots), PCA, RP, MDS (400 witnesses) and
     LMDS fitted at k = 16 from 2,048 witnesses, a 2,048-row sample
     transformed; delta by kernels.pdist, zeta by kernels.zen_estimate
     (Zen) or kernels.pdist; and a JSD leg on 2,048 + 16 probability rows
     (jsd_pdist for the reference, cross and true distances, Zen from
     distances against LMDS). quality_profile of each; the dispatched
     matrices against core/metrics.py and core/zen.py on the card; the
     quality numbers against the same evaluation on the CPU; each dense
     kernel's launch count must advance;
 16. the dense kernels timed at their working shapes (CUDA events, queued
     behind a spin kernel) beside their bounds, plain versions and library
     calls, pdist_sq also at the shapes phase 15 launches (2,048 x 2,048 x
     256 and x 16, and x 256 in bf16), with its plan, the bound of its
     route (3xTF32 or bf16 on the tensor cores, or the bytes) and the f32
     CUDA-core bound, and torch.cdist beside the library composite;
 17. wide result lists: the flat, IVF f32, IVF PQ and tiered servers of
     phases 4, 8 and 12 at n in {65, 128, 300} with re-rank 4 (fetch widths
     512, 512 and 2,048) and at n = 10, 8 batches each: every kernel of
     the path counted from 0 around them, one batch's answers against the
     same server with the search kernels' plain versions on the card, and
     the p50 at n = 300 beside the p50 at n = 10;
 18. the frontend and batch invariance: phase 4's flat, phase 8's IVF f32
     and PQ indexes served with ZenServer(frontend=True, max_batch=64,
     cache_size=1,024, re-rank 4): 64 one-row submissions coalesce into
     one dispatch whose rows equal, bit for bit, the same rows served
     alone (Q bucket 2) and in the 64-row batch; the 64 resubmitted rows
     are cache hits equal to the misses; after deleting every row's top
     answer no stale entry is served and the re-served rows equal fresh
     direct ones; the search kernels' launch counts advance. Then, on
     the flat and IVF f32 indexes, the direct path's capacity C = 64 / p50
     of a 64-row batch, the QPS of 1-row direct queries from one caller,
     and run_open_loop (wall clock, 1-row Poisson arrivals) at 0.25, 0.5,
     1.0 and 1.5 C: achieved QPS, p50 / p99, batch occupancy, rejects and
     the device's busy share (torch.profiler, a shorter run);
 19. replication and fault tolerance: an IndexLeader over phase 8's IVF
     f32 server publishes, a QueryReplica loads it onto the card; two
     rounds of delete + upsert -> publish -> poll while a thread keeps
     querying the replica: every in-flight answer is one generation's,
     the replica equals its leader bit for bit at every generation, the
     retired generations are released; publish and swap seconds. Then
     phase 12's tiered store re-offloaded over 4 logical shards under
     enable_fault_tolerance (a fake clock): shard 2 silent past its
     deadline answers as set_dead_shards([2]) applied directly, bit for
     bit, stats()["degraded_shards"] names it, a beat restores the
     healthy answers; a preemption request writes a snapshot that reloads
     to the same answers;
 20. sharded serving on make_mesh(4): every card when there are four,
     else 4 logical shards of the first card. Flat f32 and int8 indexes
     built as phase 4's on all 1,000,003 rows (which do not divide by 4,
     so the shard padding is exercised), saved and reloaded onto the mesh
     (ZenServer.load(mesh=)), and IVF f32 and int8 indexes built on the
     mesh from phase 8's corpus and generator (centroids byte-equal to
     phase 8's); 8 batches each
     against the single-device server: answers equal up to near ties
     (bit-equality reported), recall@10, p50 / p99, the search kernel
     launched once a shard a batch, and the sharded answers against the
     kernels' plain versions (plain_dispatch). Then shard 2 silent past its
     deadline (fake clock) on the flat and IVF f32 servers: degraded_shards
     names it, none of its ids answer, the answers stay finite and equal
     their plain versions'; the 4-shard IVF save reloaded onto 2 shards and
     onto no mesh answers the same; storage='pq' with a mesh raises. The
     sharded flat and IVF f32 servers are profiled as in phases 4 and 8.

Phases 7, 11 and 14 run right after phase 3 (so ``--quick`` covers every
kernel); phases 17-20 run after phase 12. Phase 3 also holds zen_topk at
widths up to 16,384 (lists in global memory) and k = 300, phase 7 the
probes at widths up to 16,384 and PQ at M = 256, phase 14 zen_estimate at
k = 300 and 600 and every dense kernel past 65,535 grid rows of column
tiles; phase 12 also times the staging copy of the coords and of the ids
apart, and splits a tiered request's host time into the gather of cold
tiles and the waits on the staging slots' copies.
Prints one JSON line of kernel records, the nvidia-smi line, and last the
device line. Any failed check exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

#: published H100 SXM peaks (data sheet, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
#: kernel vs plain tolerance: both evaluate the same f32 norm expansion,
#: in another summation order (per-thread FMA chain vs cuBLAS f32 GEMM)
RTOL = 1e-5
#: the IVF configuration served at full size: ~4 sqrt(N) clusters of
#: 128-row tiles, 8 probed per query (the JAX package's defaults)
N_CLUSTERS, TILE_ROWS, NPROBE, PQ_M = 4_000, 128, 8, 4
#: phase 8 builds an IVF index a second time to hold the two to the same
#: bytes; the PQ index only when its build takes less than this
REBUILD_MAX_S = 10.0
#: phase 15: the evaluation's sizes (witness set = pivots.MAX_WITNESS rows;
#: MDS on 400 witnesses, as benchmarks/paper_quality.py fits it)
EVAL_ROWS, MDS_WITNESS = 2_048, 400
#: phases 14 and 16: the side of the square evaluation-sized matrices
SQUARE = 4_096
#: phase 15: the quality numbers of the card and of the CPU agree within
#: this, per normalised measure. The two runs take the same rows, draws and
#: pivot ids; zeta carries each backend's f32 noise of the fits (SVD, eigh,
#: pinv, Cholesky: ~1e-5 relative), which moves stress and rho by ~1e-5 on
#: two million pairs; the margin covers rank swaps of near-tied pairs.
EVAL_ATOL = 1e-3
#: phase 14: more output columns than 65,535 grid rows of 64-column tiles
WIDE_COLS = 65_535 * 64 + 1_000
#: phases 3, 7 and 17: result widths past the 256 the kernels once took
#: (n = 65 and 128 at re-rank 4 fetch 512, n = 300 fetches 2,048)
WIDE_N = (65, 128, 300)
#: the special-function units' log2 rate per SM and clock (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0)
SFU_PER_CLOCK = 16


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def timed(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events) with the
    host's launch overhead hidden: the ``iters`` calls are queued behind a
    spin kernel that outlasts their enqueueing, so the card runs them back
    to back. Unlike :func:`timed` it leaves out the host's gaps between
    launches (launch gaps on the card stay in)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2e3 * enqueue_s + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_serving(server, batches) -> None:
    """Device time by kernel over a few served batches (torch.profiler),
    and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for q in batches:
            server.query(q, 10)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"    profile of {len(batches)} batches (profiler on): wall "
        f"{wall_us:.0f} us, device busy {busy:.0f} us "
        f"({busy / wall_us:.1%}); by kernel:")
    for us, count, key in rows[:8]:
        log(f"      {us:9.1f} us  {us / max(busy, 1e-9):6.1%}  x{count:<4d} "
            f"{key[:90]}")

def probe_cost(index, probes, n: int, luts=None):
    """(bytes, f32 operations) the probe of ``probes`` (Q, P) over ``index``
    must move and do, from this run's data: each probed cluster's ids and
    live rows read once (a cluster probed by several queries counts once),
    the queries or tables, and the (Q, n) result; 2 k operations per (query,
    live probed row), or M table adds under PQ."""
    import torch

    nq, n_probe = probes.shape
    T, rows = index.tiles_per_cluster, index.tile_rows
    live = index.tile_ids.reshape(index.n_clusters, T * rows) >= 0
    per_cluster = live.sum(1)
    uniq = torch.unique(probes.long())
    row_bytes = index.tile_coords.shape[-1] * index.tile_coords.element_size()
    nbytes = (uniq.numel() * T * rows * 4 + int(per_cluster[uniq].sum())
              * row_bytes + nq * n * 8)
    rows_scored = int(per_cluster[probes.long()].sum())
    if luts is not None:
        nbytes += luts.numel() * 4
        flops = rows_scored * index.tile_coords.shape[-1]
    else:
        nbytes += nq * index.dim * 4 + (0 if index.tile_scales is None
                                        else uniq.numel() * 4)
        flops = 2 * rows_scored * index.dim
    return nbytes, flops


#: the kernels of each pass of zen_topk and of the probes (names as the
#: profiler shows them)
TOPK_PARTS = {"pass 1": ("zen_topk_mma", "zen_topk_partial"),
              "pass 2": ("zen_topk_merge",), "memset": ("emset",)}
PROBE_PARTS = {"pass 1": ("ivf_probe_warp", "ivf_probe_pq_warp",
                          "ivf_probe_partial", "ivf_probe_pq_partial"),
               "pass 2": ("ivf_probe_merge",)}


def kernel_split(fn, parts=TOPK_PARTS, iters: int = 10):
    """Device ms a call of ``fn`` by pass (torch.profiler): the summed time
    of the kernels whose names hold each part's strings; None where the
    profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {part: 0.0 for part in parts}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, names in parts.items():
            if any(name in e.key for name in names):
                out[part] += e.self_device_time_total / iters / 1e3
                break
    if out["pass 1"] == 0.0:
        return {key: None for key in out}
    return out


def _fmt_split(split) -> str:
    if split["pass 1"] is None:
        return "passes not measured: the profiler shows no device time"
    return ", ".join(f"{part} {ms:.4f} ms" for part, ms in split.items())


def host_split(module, fn) -> dict:
    """Host microseconds a probe wrapper's call issued back to back and its
    parts (src/repro_torch/kernels/probes/probe_timing.py::host_split)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                        "repro_torch", "kernels", "probes", "probe_timing.py")
    spec = importlib.util.spec_from_file_location("probe_timing", path)
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    return timing.host_split(module, fn)


def describe_plan(plan, n_out: int) -> str:
    """One line of a zen_topk launch plan."""
    if plan.kernel == "mma":
        return (f"MMA plan, width {plan.w}: {plan.queries_per_block} queries "
                f"a block in {plan.warps} consumer warps ({plan.streams} row "
                f"streams) + 1 producer, {plan.stages} stages of "
                f"{plan.tile_rows} rows, {plan.smem:,} B, {plan.n_split} "
                f"splits, bound shared across blocks: "
                f"{'yes' if plan.shares_bound(n_out) else 'no'}; "
                f"{plan.route}")
    return (f"SIMT plan, width {plan.w}: {plan.queries_per_block} queries a "
            f"block, {plan.n_split} splits, {plan.smem:,} B, "
            f"{plan.blocks_per_sm} block(s) an SM, lists in "
            f"{'global' if plan.global_lists else 'shared'} memory, pass 2 "
            f"in {'shared' if plan.merge_smem else 'global'} memory; "
            f"{plan.route}")


def describe_pdist_plan(plan) -> str:
    """One line of a pdist_sq launch plan."""
    if plan.kernel == "mma":
        return (f"MMA plan: {plan.grid} persistent blocks walk "
                f"{plan.tile[0]} x {plan.tile[1]} tiles, a {plan.stages}-"
                f"stage TMA ring of {plan.chunk} features, TMA stores from "
                f"an output tile, {plan.smem:,} B; {plan.route}")
    return (f"{plan.kernel} plan: {plan.grid:,} blocks of {plan.tile[0]} x "
            f"{plan.tile[1]}, {plan.chunk} features a step; {plan.route}")


def bound_of(nbytes: int, flops: int):
    """(bound ms, what binds) on the published H100 peaks."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb > tf else "operations")


def check_ivf_kernels(coords, queries, atol: float):
    """Phase 7: both probe kernels against their plain versions on tiles
    packed from ``coords``; returns the max |d - d_plain| of each."""
    import torch
    from repro_torch.index import ivf
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import pq
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels.scoring import MODE_IDS
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    base = ivf.IVFZenIndex.build(coords, N_CLUSTERS, tile_rows=TILE_ROWS,
                                 n_iters=5,
                                 generator=torch.Generator().manual_seed(0))
    C, T, k = base.n_clusters, base.tiles_per_cluster, base.dim
    packed = base.tile_coords.reshape(C, T * TILE_ROWS, k)
    layouts = {}
    for st in quant.SCALAR_STORAGE_DTYPES:
        values, scales = ivf._encode_packed(packed, st)
        layouts[st] = dataclasses.replace(
            base, tile_coords=values.reshape(C * T, TILE_ROWS, k),
            storage=st, tile_scales=scales)
    layouts["pq"] = ivf.IVFZenIndex.from_members(
        *base._live_members(), base.centroids, C, TILE_ROWS, storage="pq",
        pq_m=PQ_M)
    # tombstones: every 7th id, and 64 clusters cut down to one live row
    dead = list(range(0, coords.shape[0], 7))
    tids = base.delete(dead).tile_ids.reshape(C, -1)
    live = tids >= 0
    sparse = torch.nonzero(live.sum(1) >= 2)[:64, 0]
    rank = torch.cumsum(live[sparse].int(), 1)
    dead += tids[sparse][live[sparse] & (rank > 1)].tolist()
    churned = {st: idx.delete(dead) for st, idx in layouts.items()}
    torch.cuda.synchronize()
    log(f"[7] ivf_probe / ivf_probe_pq vs their plain versions on "
        f"{coords.shape[0]:,} rows in {C} clusters, T = {T} tiles of "
        f"{TILE_ROWS} rows (packed in {time.perf_counter() - t0:.1f} s); "
        f"rtol {RTOL}, atol {atol:.3g}")
    max_err = {"ivf_probe": 0.0, "ivf_probe_pq": 0.0}
    n_cases = 0
    dead_set = set(dead)
    for st in (*quant.SCALAR_STORAGE_DTYPES, "pq"):
        for mode in ("zen", "lwb", "upb"):
            cases = [(False, nq, n, P) for nq in (2, 64) for n in (10, 64, 128)
                     for P in (1, 8, 64)]
            cases += [(True, 64, 128, P) for P in (1, 8, 64)]
            # widths 512, 2,048 and 16,384 (lists in global memory)
            cases += [(False, 64, n, NPROBE) for n in (300, 2_048, 10_000)]
            for tomb, nq, n, P in cases:
                idx = (churned if tomb else layouts)[st]
                q = queries[:nq]
                probes = idx.probe_clusters(q, P, mode)
                if tomb:  # query 0 probes clusters holding one live row
                    probes[0] = sparse[:P].to(probes.dtype)
                if st == "pq":
                    name = "ivf_probe_pq"
                    luts = pq.build_luts(q, idx.centroids, idx.codebooks,
                                         probes, MODE_IDS[mode])
                    args = (idx.tile_coords, idx.tile_ids, probes, luts, n)
                    kw = dict(tiles_per_cluster=idx.tiles_per_cluster)
                    got = ip.ivf_probe_pq(*args, **kw)
                    want = ip.ivf_probe_pq_scan(*args, **kw)
                else:
                    name = "ivf_probe"
                    args = (q, idx.tile_coords, idx.tile_ids, probes, n, mode)
                    kw = dict(tiles_per_cluster=idx.tiles_per_cluster,
                              tile_scales=idx.tile_scales)
                    got = ip.ivf_probe(*args, **kw)
                    want = ip.ivf_probe_scan(*args, **kw)
                torch.cuda.synchronize()
                label = (f"{name} {st} {mode} Q={nq} n={n} nprobe={P}"
                         + (" tombstoned" if tomb else ""))
                msg = topk_mismatch(got[0], got[1], want[0], want[1],
                                    rtol=RTOL, atol=atol)
                if msg is not None:
                    fail(f"{label} disagrees with its plain version: {msg}")
                if tomb:
                    ids = got[1]
                    if set(ids.ravel().tolist()) & dead_set:
                        fail(f"{label}: a tombstoned id came back")
                    if int((ids[0] >= 0).sum()) != P or \
                            not torch.isinf(got[0][0, P:]).all():
                        fail(f"{label}: query 0 should get {P} rows, then "
                             f"(+inf, -1)")
                fin = torch.isfinite(want[0])
                if fin.any():
                    max_err[name] = max(max_err[name], float(
                        (got[0] - want[0])[fin].abs().max()))
                n_cases += 1
    # PQ at M = 256 over k = 256 (one column a subspace): the first ~217
    # tables fit shared memory beside the list, the rest are read from
    # global memory
    wide = torch.randn((100_000, 256), generator=torch.Generator(
        coords.device).manual_seed(3), device=coords.device)
    wide[:, -1].abs_()
    pq256 = ivf.IVFZenIndex.build(wide, 64, tile_rows=TILE_ROWS, n_iters=3,
                                  storage="pq", pq_m=256,
                                  generator=torch.Generator().manual_seed(0))
    plan = ip.probe_plan(64, NPROBE, pq_m=256, nq=64,
                         cluster_rows=pq256.tiles_per_cluster * TILE_ROWS)
    for n in (10, 300):
        probes = pq256.probe_clusters(wide[:64] + 0.01, NPROBE)
        luts = pq.build_luts(wide[:64] + 0.01, pq256.centroids,
                             pq256.codebooks, probes, MODE_IDS["zen"])
        args = (pq256.tile_coords, pq256.tile_ids, probes, luts, n)
        kw = dict(tiles_per_cluster=pq256.tiles_per_cluster)
        got = ip.ivf_probe_pq(*args, **kw)
        want = ip.ivf_probe_pq_scan(*args, **kw)
        torch.cuda.synchronize()
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                            atol=RTOL)
        if msg is not None:
            fail(f"ivf_probe_pq at M=256 n={n} disagrees with its plain "
                 f"version: {msg}")
        fin = torch.isfinite(want[0])
        max_err["ivf_probe_pq"] = max(max_err["ivf_probe_pq"], float(
            (got[0] - want[0])[fin].abs().max()))
        n_cases += 1
    del wide, pq256
    log(f"    {n_cases} cases agree (ids equal outside near-ties; widths up "
        f"to 16,384; PQ at M = 256 with {plan.m_smem} tables a column in "
        f"shared memory); max |d - d_plain| ivf_probe "
        f"{max_err['ivf_probe']:.3g}, ivf_probe_pq "
        f"{max_err['ivf_probe_pq']:.3g}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    edge_cases, edge_err = check_probe_edges(coords.device, atol)
    max_err["ivf_probe"] = max(max_err["ivf_probe"], edge_err)
    log(f"    the warp plan's edge cases: {edge_cases} agree (duplicated "
        f"rows in two clusters, ids equal, the lower visit position first; "
        f"tombstoned and dummy-slot clusters; k in 1, 2, 13, 16, 130; T * "
        f"rows 144, 100, 65, 896; PQ M 1, 5, 256; the warp and block plans "
        f"at n = 33 and 64); max |d - d_plain| {edge_err:.3g}; "
        f"{time.perf_counter() - t0:.1f} s")
    return max_err


def check_probe_edges(dev, atol: float):
    """Phase 7, the warp plan's edge cases on small synthetic tiles, each
    kernel against its plain version: duplicated rows in two probed
    clusters (ids equal exactly, the lower visit position first), an
    all-tombstone cluster and dummy-slot probes (whole queries of them
    answered (+inf, -1)), every k (1, 2, 13, 16, 130) in f32/bf16/int8 with
    per-cluster scales, ragged T * rows (144, 100, 65, 896), PQ at M = 1,
    5 and 256, and both plans agreeing at the widths 33 and 64. Returns
    (cases, max |d - d_plain|)."""
    import torch
    from repro_torch.index import ivf
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.testing import topk_mismatch

    def coords(seed, n, k):
        g = torch.Generator(dev).manual_seed(seed)
        x = torch.randn((n, k), generator=g, device=dev)
        x[:, -1].abs_()
        return x

    def tiles(seed, C, T, rows, k, storage):
        slots = C * T * rows
        values, scales = ivf._encode_packed(
            coords(seed, slots, k).reshape(C, -1, k), storage)
        ids = torch.arange(slots, dtype=torch.int32, device=dev)
        dead = torch.rand(slots, generator=torch.Generator(dev).manual_seed(
            seed + 1), device=dev) < 0.2
        ids[dead] = -1
        return values.reshape(-1, rows, k), ids.reshape(-1, rows), scales

    cases, max_err = 0, 0.0

    def check(label, fn, plain, args, kw):
        nonlocal cases, max_err
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                            atol=atol)
        if msg is not None:
            fail(f"{label} disagrees with its plain version: {msg}")
        fin = torch.isfinite(want[0])
        if fin.any():
            max_err = max(max_err, float((got[0] - want[0])[fin].abs().max()))
        cases += 1
        return got, want

    # duplicated rows: cluster 3 copies cluster 0 and is probed first
    for st in ("float32", "bfloat16", "int8"):
        x, ids, sc = tiles(31, 6, 2, 64, 16, st)
        x = x.reshape(6, 128, 16).clone()
        x[3] = x[0]
        x = x.reshape(12, 64, 16)
        if sc is not None:
            sc = sc.clone()
            sc[3] = sc[0]
        q = x.reshape(6, 128, 16)[0, :40].float() * (1.0 if sc is None
                                                     else sc[0])
        q = q + 0.1 * coords(32, 40, 16)  # off the row: no cancellation
        q[:, -1].abs_()
        probes = torch.tensor([3, 0, 1, 5], dtype=torch.int32,
                              device=dev).repeat(40, 1)
        got, want = check(f"duplicated rows ({st})", ip.ivf_probe,
                          ip.ivf_probe_scan, (q, x, ids, probes, 64, "lwb"),
                          dict(tiles_per_cluster=2, tile_scales=sc))
        # each query's two nearest: its row's copies, tied, cluster 3's
        # (the lower visit position) first
        ids0 = ids.reshape(6, 128)
        both = (ids0[0, :40] >= 0) & (ids0[3, :40] >= 0)
        first = got[1][both, :2]
        if not (torch.equal(first[:, 0], ids0[3, :40][both])
                and torch.equal(first[:, 1], ids0[0, :40][both])
                and torch.equal(got[0][both, 0], got[0][both, 1])
                and torch.equal(want[1][both, :2], first)):
            fail(f"duplicated rows ({st}): a tie did not go to the lower "
                 f"visit position")
    # an all-tombstone cluster and the dummy slot
    for st in ("float32", "int8"):
        x, ids, sc = tiles(41, 9, 3, 128, 16, st)
        ids = ids.reshape(9, -1).clone()
        ids[2] = -1
        ids[8] = -1
        ids = ids.reshape(-1, 128)
        probes = torch.tensor([0, 2, 4, 8, 8, 8, 1, 8], dtype=torch.int32,
                              device=dev).repeat(64, 1)
        probes[:8] = 8
        (d, i), _ = check(f"tombstoned and dummy clusters ({st})",
                          ip.ivf_probe, ip.ivf_probe_scan,
                          (coords(42, 64, 16), x, ids, probes, 40),
                          dict(tiles_per_cluster=3, tile_scales=sc))
        if not ((i[:8] == -1).all() and torch.isinf(d[:8]).all()):
            fail(f"tombstoned and dummy clusters ({st}): a query probing "
                 f"only empty clusters got rows")
    # every k, and ragged T * rows
    for st in ("float32", "bfloat16", "int8"):
        for k in (1, 2, 13, 16, 130):
            x, ids, sc = tiles(50 + k, 12, 2, 128, k, st)
            probes = torch.randperm(12, generator=torch.Generator(
                dev).manual_seed(k), device=dev)[:5].to(torch.int32)
            check(f"k={k} ({st})", ip.ivf_probe, ip.ivf_probe_scan,
                  (coords(60 + k, 33, k), x, ids, probes.repeat(33, 1), 20),
                  dict(tiles_per_cluster=2, tile_scales=sc))
    for rows, T in ((48, 3), (100, 1), (13, 5), (128, 7)):
        x, ids, _ = tiles(70 + rows, 10, T, rows, 16, "float32")
        probes = torch.rand((64, 10), generator=torch.Generator(
            dev).manual_seed(rows), device=dev).argsort(1)[:, :6].to(
                torch.int32)  # 6 distinct clusters a query
        for mode in ("zen", "lwb", "upb"):
            check(f"T * rows = {T * rows} ({mode})", ip.ivf_probe,
                  ip.ivf_probe_scan,
                  (coords(71, 64, 16), x, ids, probes, 64, mode),
                  dict(tiles_per_cluster=T))
    # PQ at M = 1, 5 and 256 (tables past shared memory)
    for m in (1, 5, 256):
        g = torch.Generator(dev).manual_seed(m)
        codes = torch.randint(0, 256, (40, 64, m), dtype=torch.uint8,
                              device=dev, generator=g)
        ids = torch.arange(40 * 64, dtype=torch.int32,
                           device=dev).reshape(40, 64)
        ids[:, ::5] = -1
        probes = torch.randperm(20, generator=g, device=dev)[:6].to(
            torch.int32).repeat(64, 1)
        luts = torch.rand((64, 6, m, 256), device=dev, generator=g)
        check(f"PQ M={m}", ip.ivf_probe_pq, ip.ivf_probe_pq_scan,
              (codes, ids, probes, luts, 64), dict(tiles_per_cluster=2))
    # both plans at the boundary widths
    x, ids, sc = tiles(81, 40, 3, 128, 16, "int8")
    q = coords(82, 64, 16)
    probes = torch.rand((64, 40), generator=torch.Generator(
        dev).manual_seed(83), device=dev).argsort(1)[:, :8].to(torch.int32)
    for n in (33, 64):
        args = (q, x, ids, probes, n)
        kw = dict(tiles_per_cluster=3, tile_scales=sc)
        warp = ip.ivf_probe(*args, **kw)
        block = ip.ivf_probe(*args, **kw, plan=ip.block_plan(n, 8, k=16))
        torch.cuda.synchronize()
        msg = topk_mismatch(warp[0], warp[1], block[0], block[1], rtol=RTOL,
                            atol=atol)
        if msg is not None:
            fail(f"the warp and block plans disagree at n={n}: {msg}")
        cases += 1
    return cases, max_err


def serve_ivf(corpus, batches, k: int, storage: str):
    """Phase 8: build the full-size IVF index in ``storage`` and serve the
    batches; returns (server, launches of the probe kernel while serving)."""
    import torch
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.launch import serve

    kernel = ip.ivf_probe_pq if storage == "pq" else ip.ivf_probe

    def build():
        return serve.build_index(corpus, k, index="ivf", storage=storage,
                                 n_clusters=N_CLUSTERS, tile_rows=TILE_ROWS,
                                 generator=torch.Generator().manual_seed(0),
                                 device=corpus.device)

    t0 = time.perf_counter()
    index = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    iv = index.ivf
    tile_bytes = (iv.tile_coords.numel() * iv.tile_coords.element_size()
                  + iv.tile_ids.numel() * 4)
    log(f"[8] build_index(index='ivf', storage={storage!r}): {index.size:,}"
        f" rows, {iv.n_clusters} clusters, T = {iv.tiles_per_cluster} tiles "
        f"of {iv.tile_rows} rows, tiles + ids {tile_bytes / 2**20:.1f} MiB; "
        f"{build_s:.2f} s")
    # C5: a build is the same bytes every time (PQ too when it is cheap)
    if storage != "pq" or build_s < REBUILD_MAX_S:
        check_rebuild(index, build, storage)
    else:
        log(f"    not rebuilt: the {storage} build takes {build_s:.2f} s, "
            f"past {REBUILD_MAX_S} s")
    serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4).query(
        batches[0], 10)  # warm-up
    server = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4)
    kernel.launches = 0
    lat, recalls = [], []
    for q in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, ids = server.query(q, 10)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if d.shape != (64, 10) or not torch.isfinite(d).all():
            fail(f"IVF ({storage}) served distances not finite of shape "
                 f"(64, 10): {tuple(d.shape)}")
        if ids.min() < 0 or ids.max() >= corpus.shape[0]:
            fail(f"IVF ({storage}) served ids out of range")
        recalls.append(serve.recall(ids, serve.exact_topk(q, corpus, 10)))
    launches = kernel.launches
    if launches == 0:
        fail(f"the IVF ({storage}) serving path never launched "
             f"{kernel.__name__}")
    # the same index and batches through the probe's plain version on the
    # card: the recall the kernel must keep
    with plain_dispatch():
        plain_recall = np.mean([
            serve.recall(server.query(q, 10)[1],
                         serve.exact_topk(q, corpus, 10))
            for q in batches[1:]])
    if abs(plain_recall - np.mean(recalls)) > 0.002:
        fail(f"IVF ({storage}) recall@10 {np.mean(recalls):.4f} with the "
             f"kernel against {plain_recall:.4f} with its plain version")
    lat_ms = np.asarray(lat) * 1e3
    log(f"    served {len(lat)} batches x 64 queries at nprobe {NPROBE}: "
        f"recall@10 {np.mean(recalls):.4f} (min batch {np.min(recalls):.4f};"
        f" the probe's plain version on the card: {plain_recall:.4f}); "
        f"request latency p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms; {kernel.__name__} launches "
        f"{launches}")
    sweep = []
    for nprobe in (32, 128, 512):  # recall against probe depth
        probe = serve.ZenServer(index, nprobe=nprobe, rerank_factor=4)
        got = [serve.recall(probe.query(q, 10)[1],
                            serve.exact_topk(q, corpus, 10))
               for q in batches[1:3]]
        sweep.append(f"nprobe {nprobe}: {np.mean(got):.4f}")
    log(f"    recall@10 on 2 batches by depth: {'; '.join(sweep)}")
    return server, launches


def check_ivf_small(corpus, batches, k: int):
    """Phase 8, small index: nprobe = n_clusters against the flat zen_topk
    answer, and the card's served answers against the CPU's on one index
    moved between devices."""
    import torch
    from repro_torch.index import ivf
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import zen_topk as zt
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    small = corpus[:20_000]
    pivots = [int(i) for i in torch.randperm(
        20_000, generator=torch.Generator().manual_seed(1))[:k]]
    flat = serve.build_index(small, k, pivot_ids=pivots, device=small.device)
    qp = flat.transform.transform(batches[1])
    scale = float(flat.coords.norm(dim=1).median())
    full = ivf.IVFZenIndex.build(flat.coords, 566, tile_rows=TILE_ROWS,
                                 generator=torch.Generator().manual_seed(0))
    for mode in ("zen", "lwb", "upb"):
        before = ip.ivf_probe.launches
        got = full.search(qp, 64, nprobe=full.n_clusters, mode=mode)
        want = zt.zen_topk(qp, flat.coords, 64, mode)
        torch.cuda.synchronize()
        if ip.ivf_probe.launches != before + 1:
            fail("IVF search did not launch ivf_probe")
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                            atol=RTOL * scale)
        if msg is not None:
            fail(f"IVF at nprobe = n_clusters ({mode}) is not the flat "
                 f"zen_topk answer: {msg}")
    log(f"    20,000 rows, {full.n_clusters} clusters: nprobe = n_clusters "
        f"gives the flat zen_topk answer (zen/lwb/upb, n = 64)")
    for st in ("float32", "bfloat16", "int8", "pq"):
        index = serve.build_index(
            small, k, index="ivf", storage=st, pivot_ids=pivots,
            device=small.device, generator=torch.Generator().manual_seed(0))
        got = serve.ZenServer(index, nprobe=NPROBE,
                              rerank_factor=4).query(batches[1], 10)
        want = serve.ZenServer(index.to("cpu"), nprobe=NPROBE,
                               rerank_factor=4).query(batches[1].cpu(), 10)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        if msg is not None:
            fail(f"card and CPU IVF serving disagree ({st}): {msg}")
    log("    one IVF index built on the card and moved to the CPU serves "
        "the same answers on both (f32/bf16/int8/pq, nprobe 8, re-rank 4)")


def churn_ivf(server, batches, gen, corpus_rows: int):
    """Phase 9: delete, upsert until T grows, and both compactions, on the
    served f32 IVF index; no deleted id may come back."""
    import torch
    from repro_torch.data import synthetic as syn

    _, ids = server.query(batches[1], 10)
    dead = sorted(set(ids[:, :3].ravel().tolist())
                  | set(range(0, corpus_rows, 997)))
    server.delete(dead)
    T0 = server.index.ivf.tiles_per_cluster
    # rows around one corpus vector land in one cluster and overflow it
    base = server.index.corpus[dead[0]:dead[0] + 1]
    fresh = base + 1e-3 * syn.manifold_space(4 * TILE_ROWS * T0, 256, 32,
                                             generator=gen)
    revive = dead[:500]
    new_ids = list(range(corpus_rows,
                         corpus_rows + fresh.shape[0] - len(revive))) + revive
    server.upsert(new_ids, fresh)
    T1 = server.index.ivf.tiles_per_cluster
    if T1 <= T0:
        fail(f"IVF upsert of {len(new_ids)} rows into one cluster did not "
             f"grow T ({T0} -> {T1})")
    revived = set(revive)
    steps = []
    for step in ("delete + upsert", "compact()", "compact(recluster=True)"):
        if step == "compact()":
            server.compact()
        elif step == "compact(recluster=True)":
            server.compact(recluster=True)
        for q in batches[1:4]:
            d, ids = server.query(q, 10)
            back = (set(ids.ravel().tolist()) & set(dead)) - revived
            if back or not torch.isfinite(d).all():
                fail(f"IVF churn after {step}: deleted ids came back: "
                     f"{sorted(back)[:10]}")
        steps.append(f"T {server.index.ivf.tiles_per_cluster} after {step}")
    log(f"[9] IVF churn: deleted {len(dead):,}, upserted {len(new_ids):,} "
        f"({len(revived)} revived ids); no deleted id returned ("
        f"T {T0} before; {', '.join(steps)}); {server.index.size:,} live "
        f"rows")


def describe_probe_plan(plan) -> str:
    """One line of a probe launch plan."""
    if plan.kernel == "warp":
        return (f"warp plan, width {plan.w}: one launch, clusters of "
                f"{plan.cluster} blocks of {plan.warps} warps, {plan.cols} "
                f"probe columns a block in {plan.splits} splits of "
                f"{plan.split_rows} rows, {plan.smem:,} B"
                + (f", PQ tables of {plan.m_smem} subspaces a column in "
                   f"shared memory" if plan.m_smem else ""))
    return (f"block plan, width {plan.w}: pass 1 and pass 2, a block a "
            f"(query, probe column), buffer {plan.cap}, {plan.smem:,} B, "
            f"lists in {'global' if plan.global_lists else 'shared'} "
            f"memory, pass 2 over {plan.group} lists at a time in "
            f"{'shared' if plan.merge_smem else 'global'} memory")


def time_ivf(index_f32, index_pq, queries, smi: str):
    """Phase 10: both probe kernels at the serving shape (Q = 64, nprobe 8,
    the index's T, n = 64) with their plan, their passes, the host's cost a
    call and its parts, beside bound, plain version and library composite;
    then at n = 512 and 2,048, at nprobe 64 and at Q = 2 (device time, plan
    and passes). Returns the serving shape's records for the kernels
    line."""
    import torch
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import pq
    from repro_torch.kernels.scoring import MODE_IDS

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, records = 64, {}
    for name, index in (("ivf_probe", index_f32), ("ivf_probe_pq", index_pq)):
        iv = index.ivf
        qp = index.transform.transform(queries).contiguous()
        T, rows, C = iv.tiles_per_cluster, iv.tile_rows, iv.n_clusters
        kw = dict(tiles_per_cluster=T)
        pq_m = iv.tile_coords.shape[-1] if name == "ivf_probe_pq" else 0
        if name == "ivf_probe_pq":
            kernel, plain = ip.ivf_probe_pq, ip.ivf_probe_pq_scan
        else:
            kw["tile_scales"] = iv.tile_scales
            kernel, plain = ip.ivf_probe, ip.ivf_probe_scan

        def call_args(nq: int, n_out: int, n_probe: int):
            """(args, probes, tables) of a call at this shape."""
            q = qp[:nq]
            probes = iv.probe_clusters(q, n_probe)
            if name == "ivf_probe":
                return (q, iv.tile_coords, iv.tile_ids, probes, n_out,
                        "zen"), probes, None
            luts = pq.build_luts(q, iv.centroids, iv.codebooks, probes,
                                 MODE_IDS["zen"])
            return (iv.tile_coords, iv.tile_ids, probes, luts, n_out), \
                probes, luts

        args, probes, luts = call_args(qp.shape[0], n, NPROBE)
        if name == "ivf_probe_pq":
            def library():
                codes = iv.tile_coords.reshape(C, T * rows, -1)[probes.long()]
                idx = codes.long().permute(0, 1, 3, 2)   # (Q, P, M, T*rows)
                z2 = torch.gather(luts, 3, idx).sum(2)
                d = torch.sqrt(torch.clamp_min(z2, 0.0))
                ids = iv.tile_ids.reshape(C, -1)[probes.long()]
                d = torch.where(ids >= 0, d, float("inf"))
                return torch.topk(d.reshape(d.shape[0], -1), n, dim=1,
                                  largest=False)
            nbytes, flops = probe_cost(iv, probes, n, luts)
        else:
            def library():
                x = iv.tile_coords.reshape(C, T * rows, -1)[probes.long()]
                x = x.float()                         # (Q, P, T*rows, k)
                z2 = ((qp * qp).sum(1)[:, None, None] + (x * x).sum(-1)
                      - 2.0 * torch.einsum("qk,qprk->qpr", qp[:, :-1],
                                           x[..., :-1]))
                d = torch.sqrt(torch.clamp_min(z2, 0.0))
                ids = iv.tile_ids.reshape(C, -1)[probes.long()]
                d = torch.where(ids >= 0, d, float("inf"))
                return torch.topk(d.reshape(d.shape[0], -1), n, dim=1,
                                  largest=False)
            nbytes, flops = probe_cost(iv, probes, n)
        bound, bound_by = bound_of(nbytes, flops)
        # the looser bound of what the blocks read as laid out: every probed
        # (query, cluster) pair's T tiles of ids and rows, padding included,
        # and the PQ tables
        slots = probes.numel() * T * rows
        read_bound, _ = bound_of(
            slots * (4 + iv.tile_coords.shape[-1]
                     * iv.tile_coords.element_size())
            + (luts.numel() * 4 if iv.codebooks is not None else 0),
            2 * slots * iv.dim)
        plan = ip.probe_plan(n, NPROBE, k=0 if pq_m else iv.dim, pq_m=pq_m,
                             nq=qp.shape[0], cluster_rows=T * rows,
                             n_sms=n_sms)
        before = kernel.launches
        ms = timed(lambda: kernel(*args, **kw), 20)
        ms2 = timed(lambda: kernel(*args, **kw), 20)
        dev = queued_ms(lambda: kernel(*args, **kw), 20)
        dev2 = queued_ms(lambda: kernel(*args, **kw), 20)
        split = kernel_split(lambda: kernel(*args, **kw), PROBE_PARTS)
        host = host_split(ip, lambda: kernel(*args, **kw))
        plain_ms = timed(lambda: plain(*args, **kw), 3, warmup=1)
        lib = timed(library, 10)
        lib_dev = queued_ms(library, 10)
        records[name] = dict(ms=min(dev, dev2), plain_ms=plain_ms,
                             bound_ms=bound, bound_by=bound_by,
                             library_ms=lib_dev, pass1_ms=split["pass 1"],
                             pass2_ms=split["pass 2"],
                             host_us=host["whole_us"])
        log(f"[10] {name} at Q={qp.shape[0]}, nprobe={NPROBE}, T={T}, "
            f"rows={rows}, n={n} ({iv.storage}): kernel device time "
            f"{dev:.4f} / {dev2:.4f} ms ({_fmt_split(split)}), per call "
            f"with the host {ms:.4f} / {ms2:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}; {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP) "
            f"= {bound / min(dev, dev2):.1%} of bound (bound of the padded "
            f"tiles as the blocks read them {read_bound:.4f} ms); plain "
            f"{plain_ms:.3f} ms; library device time {lib_dev:.4f} ms (per "
            f"call with the host {lib:.4f} ms); {smi}")
        rest = host["whole_us"] - host["plan_us"] - host["outputs_us"] \
            - host["library_us"]
        log(f"    {describe_probe_plan(plan)}; host cost a call issued back "
            f"to back {host['whole_us']:.1f} us: probe_plan "
            f"{host['plan_us']:.1f} us, allocations "
            f"{host['outputs_us']:.1f} us, the ctypes call and its launches "
            f"{host['library_us']:.1f} us, the rest (checks, conversions, "
            f"stream) {rest:.1f} us")
        for label, nq, n_out, n_probe in (
                ("n=512", 64, 512, NPROBE), ("n=2,048", 64, 2_048, NPROBE),
                ("nprobe=64", 64, n, 64), ("Q=2", 2, n, NPROBE)):
            args2, _, _ = call_args(nq, n_out, n_probe)
            plan2 = ip.probe_plan(n_out, n_probe, k=0 if pq_m else iv.dim,
                                  pq_m=pq_m, nq=nq, cluster_rows=T * rows,
                                  n_sms=n_sms)
            dev_ms = min(queued_ms(lambda: kernel(*args2, **kw), 20),
                         queued_ms(lambda: kernel(*args2, **kw), 20))
            split2 = kernel_split(lambda: kernel(*args2, **kw), PROBE_PARTS)
            log(f"[10] {name} at {label} ({iv.storage}): kernel device time "
                f"{dev_ms:.4f} ms ({_fmt_split(split2)}); "
                f"{describe_probe_plan(plan2)}; {smi}")
        kernel.launches = before  # timing launches are not the path's
    return records


def check_stage_kernel(dev):
    """Phase 11: dma_copy_blocks against dma_copy_blocks_plain, byte for
    byte, on pinned buffers filled from a memory-mapped temporary file;
    returns (cases, mismatching cases, max |byte difference|)."""
    import tempfile

    import torch
    from repro_torch.kernels import tile_stage as ts

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    n_cases = n_bad = max_err = 0
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16", "int8", "int32", "uint8"):
            np_dtype = np.uint16 if dtype == "bfloat16" else np.dtype(dtype)
            for block in ((128, 16), (128,), (128, 13), (5, 7, 3)):
                shape = (1024,) + block
                path = os.path.join(tmp, f"{dtype}-{len(block)}.bin")
                nbytes = int(np.prod(shape)) * np.dtype(np_dtype).itemsize
                rng.integers(0, 256, nbytes, dtype=np.uint8).tofile(path)
                pool = np.memmap(path, dtype=np_dtype, mode="r", shape=shape)
                for n_blocks in (1, 2, 3, 257, 1024):
                    src = ts.pinned_like(pool[:n_blocks])
                    got = ts.dma_copy_blocks(src, dev).cpu().numpy()
                    want = ts.dma_copy_blocks_plain(src, dev).cpu().numpy()
                    a = got.view(np.uint8).astype(np.int16)
                    b = want.view(np.uint8).astype(np.int16)
                    max_err = max(max_err, int(np.abs(a - b).max()))
                    n_bad += int(got.tobytes() != want.tobytes())
                    n_cases += 1
                del pool
    # views off a 16-byte boundary: the byte-wise head and tail
    base = ts.pinned_like(rng.integers(0, 256, 1 << 20, dtype=np.uint8))
    for off, n in ((1, 1000), (3, 65_537), (16, 4096 * 5 + 7)):
        got = ts.dma_copy_blocks(base[off:off + n], dev).cpu().numpy()
        n_bad += int(got.tobytes() != base[off:off + n].numpy().tobytes())
        n_cases += 1
    # sizes that leave the last thread, warp or block step partial (1 byte
    # to 64 MB, the tiered chunk's ids and coords), from an aligned start,
    # one off it (a head and a tail) and one 16 bytes in
    sizes = (1, 15, 16, 17, 4_097, 196_608, 196_609, 3_145_728, 64 << 20)
    for n in sizes:
        base = ts.pinned_like(rng.integers(0, 256, n + 32, dtype=np.uint8))
        for off in (0, 5, 16):
            view = base[off:off + n]
            got = ts.dma_copy_blocks(view, dev).cpu().numpy()
            n_bad += int(got.tobytes() != view.numpy().tobytes())
            n_cases += 1
    torch.cuda.synchronize()
    log(f"[11] dma_copy_blocks vs dma_copy_blocks_plain, byte for byte: "
        f"{n_cases} cases (f32/bf16/int8/int32/uint8 x (128, 16)/(128,)/"
        f"(128, 13)/(5, 7, 3) x B in 1/2/3/257/1024 from a memory-mapped "
        f"file, 3 unaligned views, and {len(sizes)} sizes from 1 byte to "
        f"64 MB at offsets 0, 5 and 16), {n_bad} differ; "
        f"{time.perf_counter() - t0:.1f} s")
    if n_bad:
        fail(f"dma_copy_blocks differs from its plain version in {n_bad} "
             f"cases")
    return n_cases, n_bad, float(max_err)


def host_link(smi_name: str):
    """(bytes/s one way, description) of the card's host link at its
    maximum: nvidia-smi's PCIe fields, else the kernel's sysfs entries of
    the card's PCI device, else the part's published PCIe Gen5 x16."""
    per_lane_gt = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}

    def rate(gen, width):
        enc = 0.8 if gen <= 2 else 128 / 130
        return per_lane_gt[gen] * 1e9 * width * enc / 8

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max,"
         "pcie.link.gen.current,pcie.link.width.current,pci.bus_id",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0].split(", ")
    try:
        gen, width = int(out[0]), int(out[1])
        return rate(gen, width), (f"nvidia-smi: max Gen{gen} x{width}, now "
                                  f"Gen{out[2]} x{out[3]}")
    except (ValueError, IndexError):
        pass
    try:
        dom, rest = out[4].split(":", 1)
        sysdir = f"/sys/bus/pci/devices/{int(dom, 16):04x}:{rest.lower()}"
        with open(f"{sysdir}/max_link_speed") as f:
            gt = float(f.read().split()[0])
        with open(f"{sysdir}/max_link_width") as f:
            width = int(f.read())
        gen = {v: k for k, v in per_lane_gt.items()}[gt]
        return rate(gen, width), (f"sysfs {sysdir}: max {gt} GT/s x{width}"
                                  f" (nvidia-smi: {', '.join(out[:4])})")
    except (OSError, ValueError, IndexError, KeyError):
        return rate(5, 16), (f"the published PCIe Gen5 x16 host interface "
                             f"of the {smi_name} (nvidia-smi gives "
                             f"{', '.join(out[:4])}, sysfs unreadable)")


def serve_tiered(index, batches, corpus, smi: str):
    """Phase 12: offload the full-size f32 IVF index (hot_fraction 0.1) and
    serve the batches through ZenServer; returns (tiered server, launches
    of dma_copy_blocks while serving, the kernel's timing record)."""
    import torch
    from repro_torch.index import ivf
    from repro_torch.kernels import tile_stage as ts
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    tiered = ivf.TieredIVFZenIndex.from_index(index.ivf, hot_fraction=0.1)
    torch.cuda.synchronize()
    log(f"[12] TieredIVFZenIndex.from_index(hot_fraction=0.1): "
        f"{tiered.hot_clusters.size} of {tiered.n_clusters} clusters hot, "
        f"host pool {tiered.host_bytes() / 2**20:.1f} MiB, on the device "
        f"{tiered.device_bytes() / 2**20:.1f} MiB; "
        f"{time.perf_counter() - t0:.2f} s")
    resident = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4)
    want = [resident.query(q, 10) for q in batches[1:]]
    tindex = dataclasses.replace(index, ivf=tiered)
    serve.ZenServer(tindex, nprobe=NPROBE, rerank_factor=4).query(
        batches[0], 10)  # warm-up: allocates the pinned staging buffers
    server = serve.ZenServer(tindex, nprobe=NPROBE, rerank_factor=4)
    cold0 = tiered.stats()["cold_uploads"]
    ts.dma_copy_blocks.launches = 0
    lat, got = [], []
    for q in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got.append(server.query(q, 10))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    launches = ts.dma_copy_blocks.launches
    reckoned = 2 * (tiered.stats()["cold_uploads"] - cold0)
    if launches == 0 or launches != reckoned:
        fail(f"the tiered serving path launched dma_copy_blocks {launches} "
             f"times; its cold uploads reckon {reckoned}")
    rec_t, rec_r = [], []
    for q, (d, ids), (wd, wi) in zip(batches[1:], got, want):
        if d.shape != (64, 10) or not torch.isfinite(d).all():
            fail(f"tiered served distances not finite of shape (64, 10): "
                 f"{tuple(d.shape)}")
        msg = topk_mismatch(d, ids, wd, wi, rtol=0.0, atol=0.0)
        if msg is not None:
            fail(f"tiered and resident serving disagree: {msg}")
        true = serve.exact_topk(q, corpus, 10)
        rec_t.append(serve.recall(ids, true))
        rec_r.append(serve.recall(wi, true))
    if np.mean(rec_t) != np.mean(rec_r):
        fail(f"tiered recall@10 {np.mean(rec_t)} != resident "
             f"{np.mean(rec_r)}")
    lat_ms = np.asarray(lat) * 1e3
    st = server.stats()["tier"]
    log(f"    served {len(lat)} batches x 64 queries at nprobe {NPROBE}, "
        f"re-rank 4: ids equal the resident server's (ties aside), "
        f"recall@10 {np.mean(rec_t):.4f} = resident {np.mean(rec_r):.4f}; "
        f"request latency p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms")
    log(f"    tier: hot_hits {st['hot_hits']}, cold_uploads "
        f"{st['cold_uploads']}, bytes_uploaded {st['bytes_uploaded']:,} "
        f"({st['bytes_uploaded'] / max(st['cold_uploads'], 1) / 1e6:.2f} MB"
        f" a chunk), device_bytes {st['device_bytes']:,} against host_bytes"
        f" {st['host_bytes']:,}, provisioned_device_bytes(64) "
        f"{tiered.provisioned_device_bytes(64):,}; dma_copy_blocks launches "
        f"{launches} = 2 x {reckoned // 2} cold uploads while serving")
    split_tier_host_time(server, batches[1:])
    profile_serving(server, batches[1:5])

    # the kernel on one chunk of this run: the first batch's first two
    # probe columns, gathered as _stage_chunk does
    qp = index.transform.transform(batches[1])
    probes = ivf._probe_clusters(qp, tiered.centroids, NPROBE,
                                 "zen").cpu().numpy()[:, :2]
    H = tiered.hot_clusters.size
    uniq = np.unique(probes[tiered._base_slot[probes] == H])
    T = tiered.tiles_per_cluster
    n_slots = max(min(1 << int(uniq.size).bit_length(),
                      tiered.n_clusters + 1), uniq.size + 1)
    blocks = (uniq[:, None] * T + np.arange(T)).reshape(-1)
    coords = np.zeros((n_slots * T,) + tiered.host_coords.shape[1:],
                      tiered.host_coords.dtype)
    ids = np.full((n_slots * T, tiered.tile_rows), -1, np.int32)
    coords[:blocks.size] = tiered.host_coords[blocks]
    ids[:blocks.size] = tiered.host_ids[blocks]
    src_c, src_i = ts.pinned_like(coords), ts.pinned_like(ids)
    dst_c = torch.empty(src_c.shape, dtype=src_c.dtype, device=qp.device)
    dst_i = torch.empty(src_i.shape, dtype=src_i.dtype, device=qp.device)
    nbytes = coords.nbytes + ids.nbytes
    link, link_src = host_link(smi.split(",")[0])
    bound = nbytes / link * 1e3

    def kernel(parts=(src_c, src_i)):
        for src in parts:
            ts.dma_copy_blocks(src, qp.device)

    def plain():
        ts.dma_copy_blocks_plain(src_c, qp.device)
        ts.dma_copy_blocks_plain(src_i, qp.device)

    def library(parts=((dst_c, src_c), (dst_i, src_i))):
        for dst, src in parts:
            dst.copy_(src, non_blocking=True)

    before = ts.dma_copy_blocks.launches
    ms = timed(kernel, 20)
    dev_ms = queued_ms(kernel, 20)
    dev_ms2 = queued_ms(kernel, 20)
    plain_ms = timed(plain, 5, warmup=1)
    lib_ms = queued_ms(library, 20)
    lib_ms2 = queued_ms(library, 20)
    # the coords and the ids apart, kernel and library in turns
    apart = []
    for what, src, dst in (("coords", src_c, dst_c), ("ids", src_i, dst_i)):
        k1 = queued_ms(lambda: kernel((src,)), 20)
        l1 = queued_ms(lambda: library(((dst, src),)), 20)
        k2 = queued_ms(lambda: kernel((src,)), 20)
        l2 = queued_ms(lambda: library(((dst, src),)), 20)
        nb = src.numel() * src.element_size()
        apart.append(f"{what} {nb:,} B: kernel {min(k1, k2):.4f} ms "
                     f"({nb / min(k1, k2) / 1e6:.1f} GB/s), library "
                     f"{min(l1, l2):.4f} ms ({nb / min(l1, l2) / 1e6:.1f} "
                     f"GB/s), bound {nb / link * 1e3:.4f} ms")
    ts.dma_copy_blocks.launches = before  # timing launches are not the path's
    # the launcher's host cost: a 0-byte launch runs the pointer check (and
    # launches nothing), against a bare ctypes call into the same library
    from repro_torch.kernels import _build
    lib = _build.load("tile_stage")
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    host_us = {}
    for what, call in (
            ("check", lambda: lib.tile_stage_launch(
                src_c.data_ptr(), dst_c.data_ptr(), 0, 1, stream)),
            ("bare", lambda: lib.zen_cuda_error_string(0))):
        t = time.perf_counter()
        for _ in range(10_000):
            call()
        host_us[what] = (time.perf_counter() - t) * 1e2
    log(f"    host cost of a launch's pointer check (cudaPointerGetAttributes"
        f", which also gives the mapped address): {host_us['check']:.2f} us "
        f"a call against {host_us['bare']:.2f} us for a bare ctypes call")
    log(f"    dma_copy_blocks on one chunk ({uniq.size} cold clusters in "
        f"{n_slots} slots, {n_slots * T} blocks of coords + ids, "
        f"{nbytes / 1e6:.2f} MB): device time {dev_ms:.4f} / {dev_ms2:.4f} "
        f"ms ({nbytes / min(dev_ms, dev_ms2) / 1e6:.1f} GB/s; per call with "
        f"the host {ms:.4f} ms), bound {bound:.4f} ms (bytes over the host "
        f"link at {link / 1e9:.2f} GB/s one way, {link_src}) = "
        f"{bound / min(dev_ms, dev_ms2):.1%} of bound; plain {plain_ms:.4f} "
        f"ms; library copy_(non_blocking=True) device time {lib_ms:.4f} / "
        f"{lib_ms2:.4f} ms ({nbytes / min(lib_ms, lib_ms2) / 1e6:.1f} GB/s);"
        f" {smi}")
    log(f"    apart: {'; '.join(apart)}")
    record = dict(ms=min(dev_ms, dev_ms2), plain_ms=plain_ms, bound_ms=bound,
                  bound_by="bytes", library_ms=min(lib_ms, lib_ms2))
    return server, launches, record


def split_tier_host_time(server, batches) -> None:
    """Phase 12: the host's time in a tiered request, split: the gathers of
    cold tiles into the pinned staging slots (np.take) and the waits on a
    slot's last copy (torch.cuda.Event.synchronize), against the whole
    request (host clock, ending in torch.cuda.synchronize)."""
    import torch

    spent = {"gather": 0.0, "wait": 0.0, "calls": 0}
    take, sync = np.take, torch.cuda.Event.synchronize

    def timed_take(*a, **kw):
        t = time.perf_counter()
        try:
            return take(*a, **kw)
        finally:
            spent["gather"] += time.perf_counter() - t
            spent["calls"] += 1

    def timed_sync(event):
        t = time.perf_counter()
        try:
            return sync(event)
        finally:
            spent["wait"] += time.perf_counter() - t

    lat = []
    np.take, torch.cuda.Event.synchronize = timed_take, timed_sync
    try:
        for q in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            server.query(q, 10)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
    finally:
        np.take, torch.cuda.Event.synchronize = take, sync
    n = len(batches)
    wall = sum(lat) * 1e3 / n
    gather, wait = spent["gather"] * 1e3 / n, spent["wait"] * 1e3 / n
    log(f"    host split of a tiered request (mean of {n} batches, host "
        f"clock): {wall:.3f} ms in all, of which the gather of cold tiles "
        f"into the pinned slots {gather:.3f} ms ({gather / wall:.1%}, "
        f"{spent['calls'] // n} np.take calls a batch) and the waits on a "
        f"slot's last copy {wait:.3f} ms ({wait / wall:.1%}); the rest "
        f"{wall - gather - wait:.3f} ms (launches, the coarse ranking and "
        f"its device sync, the merges, the re-rank)")


@contextlib.contextmanager
def plain_dispatch():
    """A context in which ``kernels.ops`` sends CUDA tensors to the search
    kernels' plain versions (on the card) instead of the kernels: the
    reference the served answers of phase 17 are held to."""
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import ops
    from repro_torch.kernels import zen_topk as zt

    saved = ops.zen_topk, ops.ivf_probe, ops.ivf_probe_pq
    ops.zen_topk = zt.zen_topk_scan
    ops.ivf_probe, ops.ivf_probe_pq = ip.ivf_probe_scan, ip.ivf_probe_pq_scan
    try:
        yield
    finally:
        ops.zen_topk, ops.ivf_probe, ops.ivf_probe_pq = saved


def serve_wide(servers, batches):
    """Phase 17: each full-size server at n in WIDE_N with re-rank 4
    (fetch widths 512, 512, 2,048) and at n = 10: the answers of one batch
    against the same server with the search kernels' plain versions on the
    card, the path's kernels counted from 0 around the served batches, and
    the p50 at n = 300 beside the p50 at n = 10."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    log(f"[17] wide result lists at 1,000,000 rows, re-rank 4: n in "
        f"{WIDE_N} (fetch widths "
        f"{[serve.bucket_neighbors(4 * n) for n in WIDE_N]})")
    atol = RTOL * float(batches[1].norm(dim=1).median())
    for name, server, kernels in servers:
        p50 = {}
        for n in (10, *WIDE_N):
            for kern in kernels:
                kern.launches = 0
            lat = []
            for q in batches[1:]:
                torch.cuda.synchronize()
                t = time.perf_counter()
                d, ids = server.query(q, n)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t)
                # the flat server was churned in phase 5: its ids run past
                # the corpus rows, so only -1 (an unfilled slot) is wrong
                if d.shape != (64, n) or not torch.isfinite(d).all() or \
                        ids.min() < 0:
                    fail(f"{name} at n={n}: served {tuple(d.shape)} with "
                         f"non-finite distances or unfilled slots")
            counts = {kern.__name__: kern.launches for kern in kernels}
            if min(counts.values()) == 0:
                fail(f"{name} at n={n} did not launch every kernel of its "
                     f"path: {counts}")
            p50[n] = float(np.percentile(np.asarray(lat) * 1e3, 50))
            if n == 10:
                continue
            got = server.query(batches[1], n)
            before = {kern.__name__: kern.launches for kern in kernels}
            with plain_dispatch():
                want = server.query(batches[1], n)
            torch.cuda.synchronize()
            after = {kern.__name__: kern.launches for kern in kernels}
            searched = {k: after[k] - before[k] for k in after
                        if k != "dma_copy_blocks"}
            if any(searched.values()):
                fail(f"{name}: the plain reference launched {searched}")
            msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                                atol=atol)
            if msg is not None:
                fail(f"{name} at n={n} disagrees with the plain versions: "
                     f"{msg}")
            log(f"    {name:8s} n={n:3d}: matches the plain versions on the "
                f"card; p50 {p50[n]:.3f} ms; launches {counts}")
        log(f"    {name:8s} p50 at n=300 {p50[300]:.3f} ms beside "
            f"{p50[10]:.3f} ms at n=10")
    log(f"    {time.perf_counter() - t0:.1f} s")


def check_tiered_small(corpus, batches, k: int):
    """Phase 12, small index: bf16 and int8 tiered indexes on the card
    against the CPU path, and an all-hot and an all-cold index against the
    resident one."""
    import torch
    from repro_torch.index import ivf
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    small = corpus[:20_000]
    pivots = [int(i) for i in torch.randperm(
        20_000, generator=torch.Generator().manual_seed(1))[:k]]
    q = batches[1]
    for st in ("bfloat16", "int8"):
        index = serve.build_index(
            small, k, index="ivf", storage=st, pivot_ids=pivots,
            device=small.device, generator=torch.Generator().manual_seed(0),
            offload=True)
        got = serve.ZenServer(index, nprobe=NPROBE,
                              rerank_factor=4).query(q, 10)
        want = serve.ZenServer(index.to("cpu"), nprobe=NPROBE,
                               rerank_factor=4).query(q.cpu(), 10)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        if msg is not None:
            fail(f"card and CPU tiered serving disagree ({st}): {msg}")
    index = serve.build_index(small, k, index="ivf", pivot_ids=pivots,
                              device=small.device,
                              generator=torch.Generator().manual_seed(0))
    qp = index.transform.transform(q)
    for hot in (0, index.ivf.n_clusters):
        tiered = ivf.TieredIVFZenIndex.from_index(index.ivf,
                                                  hot_clusters=hot)
        for nprobe in (NPROBE, index.ivf.n_clusters):
            got = tiered.search(qp, 64, nprobe)
            want = index.ivf.search(qp, 64, nprobe)
            msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=0.0,
                                atol=0.0)
            if msg is not None:
                fail(f"{hot}-hot tiered index disagrees with the resident "
                     f"one at nprobe {nprobe}: {msg}")
    log(f"    20,000 rows: bf16 and int8 tiered servers on the card answer "
        f"as on the CPU (nprobe {NPROBE}, re-rank 4); all-cold and all-hot "
        f"({index.ivf.n_clusters} clusters) tiered indexes give the "
        f"resident answers (n = 64, nprobe {NPROBE} and all)")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def check_snapshots(index, tiered_server, batches, corpus, k: int):
    """Phase 13: save the full-size IVF f32 server and its tile pool,
    reload both (resident, and tiered off the memory-mapped pool), and
    round-trip the flat server at 20,000 rows; every reload answers as
    before."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    def same(server, want, label):
        for q, (wd, wi) in zip(batches[1:], want):
            d, ids = server.query(q, 10)
            msg = topk_mismatch(d, ids, wd, wi, rtol=1e-6, atol=0.0)
            if msg is not None or not torch.equal(ids, wi):
                fail(f"{label} answers differently after the reload: {msg}")

    tmp = tempfile.mkdtemp(prefix="zen-snapshot-")
    try:
        resident = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4)
        want = [resident.query(q, 10) for q in batches[1:]]
        want_t = [tiered_server.query(q, 10) for q in batches[1:]]
        sdir, pdir = os.path.join(tmp, "server"), os.path.join(tmp, "pool")
        t = time.perf_counter()
        resident.save(sdir)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        tiered_server.index.ivf.save(pdir)
        pool_s = time.perf_counter() - t
        t = time.perf_counter()
        back = serve.ZenServer.load(sdir, device=corpus.device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        same(back, want, "the resident IVF server")
        del back
        t = time.perf_counter()
        back = serve.ZenServer.load(sdir, pool=pdir, mmap=True,
                                    device=corpus.device)
        torch.cuda.synchronize()
        mmap_s = time.perf_counter() - t
        same(back, want_t, "the tiered IVF server (memory-mapped pool)")
        del back
        log(f"[13] snapshots of the {index.size:,}-row IVF f32 server: "
            f"ZenServer.save {save_s:.2f} s ({_dir_bytes(sdir) / 2**20:.1f}"
            f" MiB with the re-rank corpus), TieredIVFZenIndex.save "
            f"{pool_s:.2f} s ({_dir_bytes(pdir) / 2**20:.1f} MiB); "
            f"ZenServer.load {load_s:.2f} s, ZenServer.load(pool=, "
            f"mmap=True) {mmap_s:.2f} s; both answer {len(want)} batches "
            f"with the same ids and distances")
        small = serve.build_index(corpus[:20_000], k, device=corpus.device,
                                  generator=torch.Generator().manual_seed(0))
        flat = serve.ZenServer(small, rerank_factor=4)
        want = [flat.query(q, 10) for q in batches[1:]]
        fdir = os.path.join(tmp, "flat")
        flat.save(fdir)
        same(serve.ZenServer.load(fdir, device=corpus.device), want,
             "the flat 20,000-row server")
        log(f"    flat 20,000-row server: save + load "
            f"({_dir_bytes(fdir) / 2**20:.1f} MiB) answers the same")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



def _bits(res):
    """(distances as int32 bits, ids) on the host, for bit-equality."""
    d, ids = res
    if not isinstance(d, np.ndarray):
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
    return d.view(np.int32), ids


def _same_bits(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_bits(a), _bits(b)))


def device_busy(fn) -> tuple:
    """(result of ``fn``, wall seconds, device-busy seconds): ``fn`` runs
    under torch.profiler, and the busy time is its CUDA kernels' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, wall, busy_us * 1e-6


def check_frontend(servers, batches, smi: str):
    """Phase 18: the micro-batching frontend on the full-size flat, IVF f32
    and PQ indexes. 64 one-row submissions coalesce into one dispatch whose
    rows equal the same rows served alone (Q bucket 2) and in the 64-row
    batch, bit for bit; cache hits equal the misses; after a churn no
    stale answer is served; then open-loop Poisson load of 1-row arrivals
    at 0.25, 0.5, 1.0 and 1.5 x the direct path's capacity."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import run_open_loop

    t0 = time.perf_counter()
    log(f"[18] frontend (max_batch 64, cache 1,024 rows, re-rank 4) on the "
        f"1,000,000-row servers; {smi}")
    q = batches[1]
    for name, index, kernels in servers:
        for kern in kernels:
            kern.launches = 0
        fe = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4,
                             frontend=True, max_batch=64, cache_size=1_024)
        sched = fe.frontend
        handles = [sched.submit(q[i], 10) for i in range(64)]
        if sched.tick() != 1:
            fail(f"{name}: 64 one-row submissions did not coalesce into "
                 f"one dispatch")
        batch = fe.query(q, 10, direct=True)
        for i, h in enumerate(handles):
            alone = fe.query(q[i:i + 1], 10, direct=True)
            row = (batch[0][i:i + 1], batch[1][i:i + 1])
            got = h.result()
            if not (_same_bits(got, alone) and _same_bits(got, row)):
                fail(f"{name}: row {i} coalesced differs from the same row "
                     f"served alone or in the 64-row batch")
        hits = [sched.submit(q[i], 10) for i in range(64)]
        if not all(h.done() for h in hits) or sched.stats.cache_hits != 64:
            fail(f"{name}: resubmitted rows were not all cache hits")
        if not all(_same_bits(a.result(), b.result())
                   for a, b in zip(hits, handles)):
            fail(f"{name}: a cache hit differs from its miss")
        counts = {kern.__name__: kern.launches for kern in kernels}
        if min(counts.values()) == 0:
            fail(f"{name}: the frontend did not launch {counts}")
        churn = ""
        if name != "ivf pq":  # churn: delete every row's top answer
            victims = sorted(set(batch[1][:, 0].tolist()))
            fe.delete(victims)
            again = [sched.submit(q[i], 10) for i in range(64)]
            if any(h.done() for h in again):
                fail(f"{name}: a pre-churn cache entry answered after the "
                     f"churn")
            sched.tick()
            fresh = fe.query(q, 10, direct=True)
            for i, h in enumerate(again):
                if not _same_bits(h.result(),
                                  (fresh[0][i:i + 1], fresh[1][i:i + 1])):
                    fail(f"{name}: row {i} after the churn differs from a "
                         f"fresh direct query")
                if set(h.result()[1].ravel().tolist()) & set(victims):
                    fail(f"{name}: a deleted id was served after the churn")
            churn = (f"; after deleting {len(victims)} ids no stale entry "
                     f"answered and the re-served rows equal fresh ones")
        log(f"    {name:7s}: 64 one-row submissions in 1 dispatch equal the "
            f"rows alone (Q bucket 2) and in the 64-row batch bit for bit; "
            f"64 cache hits equal the misses{churn}; launches {counts}")

    # open loop, real clock: capacity from the direct path's 64-row p50
    for name, index, kernels in servers[:2]:
        direct = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4)
        lat = []
        for b in batches[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            direct.query(b, 10)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        p50 = float(np.percentile(lat, 50))
        cap = 64 / p50
        n1 = 0
        t = time.perf_counter()
        while time.perf_counter() - t < 1.0:
            direct.query(q[n1 % 64:n1 % 64 + 1], 10)
            n1 += 1
        one_qps = n1 / (time.perf_counter() - t)
        _, wall, busy = device_busy(
            lambda: [direct.query(q[i:i + 1], 10) for i in range(200)])
        log(f"    {name} open loop: direct 64-row p50 {p50 * 1e3:.3f} ms, "
            f"capacity C = {cap:,.0f} queries/s; 1-row direct queries "
            f"from one caller {one_qps:,.0f} queries/s (device busy "
            f"{busy / wall:.1%})")
        pool = torch.cat(batches[1:]).cpu().numpy()
        for frac in (0.25, 0.5, 1.0, 1.5):
            fe = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4,
                                 frontend=True, max_batch=64)
            rep = run_open_loop(fe, pool, offered_qps=frac * cap,
                                duration_s=1.0, n_neighbors=10, seed=1,
                                drain_timeout_s=20.0)
            occ = fe.stats()["frontend"]["batch_occupancy"]
            fe_p = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4,
                                   frontend=True, max_batch=64)
            _, wall, busy = device_busy(lambda: run_open_loop(
                fe_p, pool, offered_qps=frac * cap, duration_s=0.5,
                n_neighbors=10, seed=2, drain_timeout_s=20.0))
            if rep.failures or rep.timeouts or rep.completed == 0:
                fail(f"{name} open loop at {frac} C: {rep.row()}")
            log(f"      offered {frac:4.2f} C = {frac * cap:9,.0f}/s: "
                f"achieved {rep.achieved_qps:9,.0f}/s, p50 "
                f"{rep.p50_ms:.3f} ms, p99 {rep.p99_ms:.3f} ms, occupancy "
                f"{occ:.3f}, rejected {rep.rejected}, completed "
                f"{rep.completed}; device busy {busy / wall:.1%} "
                f"(profiled 0.5 s run)")
    log(f"    {time.perf_counter() - t0:.1f} s")


def check_replication(ivf_index, batches, corpus):
    """Phase 19: an IndexLeader over the full-size IVF f32 server publishes;
    a QueryReplica on the card polls and swaps, also under a thread that
    keeps querying it, bit-identical to its leader at every generation;
    fault tolerance on phase 12's tiered store re-offloaded over 4 logical
    shards, one silent past its deadline (fake clock), against
    set_dead_shards applied directly; and a preemption snapshot that
    reloads to the same answers."""
    import dataclasses
    import shutil
    import tempfile
    import threading

    import torch
    from repro_torch.index import ivf
    from repro_torch.launch import serve
    from repro_torch.launch.replicate import IndexLeader, QueryReplica
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    q = batches[1]
    tmp = tempfile.mkdtemp(prefix="zen-replicate-")
    try:
        leader_srv = serve.ZenServer(ivf_index, nprobe=NPROBE,
                                     rerank_factor=4)
        leader = IndexLeader(leader_srv, os.path.join(tmp, "pub"), keep=2)
        t = time.perf_counter()
        leader.publish()
        pub_s = [time.perf_counter() - t]
        rep = QueryReplica(os.path.join(tmp, "pub"), device=corpus.device,
                           frontend=True, cache_size=1_024)
        t = time.perf_counter()
        if not rep.poll():
            fail("the replica did not swap in the first publish")
        torch.cuda.synchronize()
        swap_s = [time.perf_counter() - t]

        def coherent(label):
            want = leader_srv.query(q, 10, direct=True)
            got = rep.query(q, 10)
            if rep.generation != leader.generation or \
                    not _same_bits(got, want):
                fail(f"the replica differs from its leader {label}")
            return want

        gens = [coherent("at generation 0")]
        served = [rep.generation]
        stop, seen, errors = threading.Event(), [], []

        def reader():
            try:
                while not stop.is_set():
                    seen.append(_bits(rep.query(q, 10, direct=True)))
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        gen = torch.Generator(device=corpus.device).manual_seed(19)
        for round_ in range(2):
            th = threading.Thread(target=reader)
            th.start()
            try:
                victims = sorted(set(gens[-1][1][:, 0].tolist()))
                leader.delete(victims)
                fresh = corpus[:500] + 0.01 * torch.randn(
                    (500, corpus.shape[1]), generator=gen,
                    device=corpus.device)
                leader.upsert(list(range(corpus.shape[0] + 500 * round_,
                                         corpus.shape[0] + 500 * round_
                                         + 500)), fresh)
                t = time.perf_counter()
                leader.publish()
                pub_s.append(time.perf_counter() - t)
                t = time.perf_counter()
                if not rep.poll():
                    fail(f"the replica did not swap in round {round_}")
                torch.cuda.synchronize()
                swap_s.append(time.perf_counter() - t)
            finally:
                stop.set()
                th.join(timeout=300)
                stop.clear()
            if errors:
                fail(f"a query in flight across the swap failed: {errors}")
            gens.append(coherent(f"at generation {leader.generation}"))
            served.append(rep.generation)
            known = [_bits(g) for g in gens[-2:]]
            for d, ids in seen:
                if not any(np.array_equal(d, a) and np.array_equal(ids, b)
                           for a, b in known):
                    fail("an in-flight answer is no generation's answer")
            n_seen, seen[:] = len(seen), []
            log(f"[19] round {round_}: deleted {len(victims)} ids, upserted "
                f"500; publish {pub_s[-1]:.2f} s, swap (load onto the card) "
                f"{swap_s[-1]:.2f} s; {n_seen} in-flight batches each equal "
                f"to one generation's answers; replica at generation "
                f"{rep.generation} equals its leader bit for bit")
        if rep.poll_errors or \
                rep.released_generations() != tuple(served[:-1]):
            fail(f"replica poll errors {rep.poll_errors}, released "
                 f"{rep.released_generations()} of {served}")
        log(f"    first publish {pub_s[0]:.2f} s, first swap "
            f"{swap_s[0]:.2f} s; generations {served[:-1]} released once "
            f"idle; replica stats {rep.stats()['server']['frontend']}")
        del rep, leader, leader_srv

        # fault tolerance on a tiered index: shard 2 of 4 goes silent
        clock = [0.0]
        tiered = ivf.TieredIVFZenIndex.from_index(
            ivf_index.ivf, hot_fraction=0.1, n_shards=4)
        oracle_t = tiered.to(corpus.device)
        oracle_t.set_dead_shards([2])
        ft = serve.ZenServer(dataclasses.replace(ivf_index, ivf=tiered),
                             nprobe=NPROBE, rerank_factor=4)
        healthy = ft.query(q, 10)
        ft.enable_fault_tolerance(deadline_s=10.0, clock=lambda: clock[0],
                                  snapshot_dir=os.path.join(tmp, "pre"))
        for s in range(4):
            ft.heartbeat(s)
        clock[0] = 11.0
        for s in (0, 1, 3):
            ft.heartbeat(s)
        degraded = ft.query(q, 10)
        oracle = serve.ZenServer(dataclasses.replace(ivf_index,
                                                     ivf=oracle_t),
                                 nprobe=NPROBE, rerank_factor=4)
        if ft.stats()["degraded_shards"] != ["shard2"]:
            fail(f"degraded shards {ft.stats()['degraded_shards']}")
        if not _same_bits(degraded, oracle.query(q, 10)):
            fail("the silent shard's answers differ from set_dead_shards "
                 "applied directly")
        ft.heartbeat(2)
        if not _same_bits(ft.query(q, 10), healthy):
            fail("the revived shard's answers differ from the healthy ones")
        ft.preemption.request()
        t = time.perf_counter()
        ft.query(q, 10)              # the next tick writes the snapshot
        pre_s = time.perf_counter() - t
        back = serve.ZenServer.load(os.path.join(tmp, "pre"),
                                    device=corpus.device)
        got = back.query(q, 10)
        atol = RTOL * float(q.norm(dim=1).median())
        msg = topk_mismatch(got[0], got[1], healthy[0], healthy[1],
                            rtol=RTOL, atol=atol)
        if msg is not None:
            fail(f"the preemption snapshot reloads to other answers: {msg}")
        log(f"    fault tolerance on a tiered index (4 shards): shard2 "
            f"silent past 10 s answers as set_dead_shards([2]) bit for "
            f"bit, stats degraded_shards {['shard2']}; revived, the healthy "
            f"answers; a preemption request saved a snapshot in "
            f"{pre_s:.2f} s that reloads to the same answers")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"    {time.perf_counter() - t0:.1f} s")


def _state_bytes(index) -> dict:
    """The arrays a ZenServer snapshot of an IVF ``index`` holds, but the
    re-rank corpus, as flat byte tensors on the device."""
    import torch
    from repro_torch.index.ivf import snapshot_payload

    tr = index.transform
    arrays = {"refs": tr.refs, "base_chol": tr.base.chol,
              "base_diag_g": tr.base.diag_g, "base_d0": tr.base.d0}
    arrays.update({f"ivf_{name}": t for name, t in
                   snapshot_payload(index.ivf)[0].items()})
    return {name: torch.as_tensor(t).contiguous().reshape(-1)
            .view(torch.uint8) for name, t in arrays.items()}


def check_rebuild(index, rebuild, label: str) -> float:
    """Phase 8, C5: build the IVF index again from an equal generator and
    fail unless its snapshot arrays are the same bytes; returns the
    rebuild's seconds."""
    import torch

    t0 = time.perf_counter()
    again = rebuild()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    a, b = _state_bytes(index), _state_bytes(again)
    differ = [name for name in a if not torch.equal(a[name], b[name])]
    if sorted(a) != sorted(b) or differ:
        fail(f"two IVF ({label}) builds from equal generators differ in "
             f"{differ or sorted(set(a) ^ set(b))}")
    log(f"    rebuilt from an equal generator in {secs:.2f} s: the "
        f"snapshot arrays ({', '.join(sorted(a))}) are the same bytes")
    return secs


def check_sharded(flat_corpus, ivf_index, corpus, batches, k: int,
                  smi: str):
    """Phase 20: sharded serving at full width on ``make_mesh(4)`` (every
    card when there are four, else 4 logical shards of the first): flat
    f32 and int8 servers on the 1,000,003 rows of ``flat_corpus`` (phase
    4's settings; the row count leaves one row of shard padding) reloaded
    from single-device snapshots onto the mesh, the IVF f32 and int8
    servers built on it from phase 8's corpus and generator; answers,
    recall, latency and launches against the single-device servers, the
    kernels against their plain versions under the sharded path, a silent
    shard, a reshard onto 2 shards and onto no mesh, and the PQ refusal.
    Returns the search kernels' launches while the sharded servers served
    (the batches of the four servers)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import zen_topk as zt
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    mesh = make_mesh(4)
    layout = ("4 cards" if len(set(mesh.devices.flat)) == 4 else
              f"4 logical shards of {mesh.first_device}")
    log(f"[20] sharded serving on a mesh of {layout} "
        f"({[str(d) for d in mesh.devices.flat]}); {smi}")
    rows = batches[1:]
    launches = {"zen_topk": 0, "ivf_probe": 0}
    truths = {}

    def serve_all(server):
        lat, out = [], []
        for q in rows:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(server.query(q, 10))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        ms = np.asarray(lat) * 1e3
        return out, np.percentile(ms, 50), np.percentile(ms, 99)

    def recall_of(out, data):
        key = data.shape[0]
        if key not in truths:
            truths[key] = [serve.exact_topk(q, data, 10) for q in rows]
        return float(np.mean([serve.recall(ids, t)
                              for t, (_, ids) in zip(truths[key], out)]))

    atol = 0.0

    def agree(got, want, label):
        bit = all(_same_bits(g, w) for g, w in zip(got, want))
        for (gd, gi), (wd, wi) in zip(got, want):
            msg = topk_mismatch(gd, gi, wd, wi, rtol=RTOL, atol=atol)
            if msg is not None:
                fail(f"{label} disagrees: {msg}")
        return bit

    def compare(single, sharded, kernel, label, data):
        nonlocal atol
        serve.ZenServer(single, nprobe=NPROBE, rerank_factor=4).query(
            batches[0], 10)  # warm-up
        serve.ZenServer(sharded, nprobe=NPROBE, rerank_factor=4).query(
            batches[0], 10)
        want, w50, w99 = serve_all(serve.ZenServer(single, nprobe=NPROBE,
                                                   rerank_factor=4))
        # the served distances are the exact re-rank's, in the corpus space
        atol = RTOL * float(torch.cat([d for d, _ in want]).median())
        server = serve.ZenServer(sharded, nprobe=NPROBE, rerank_factor=4)
        before = kernel.launches
        got, g50, g99 = serve_all(server)
        n = kernel.launches - before
        launches[kernel.__name__] += n
        if n != 4 * len(rows):
            fail(f"{label}: {n} {kernel.__name__} launches for {len(rows)} "
                 f"batches on 4 shards")
        bit = agree(got, want, f"the sharded {label} server")
        r_got, r_want = recall_of(got, data), recall_of(want, data)
        if abs(r_got - r_want) > 0.002:
            fail(f"{label}: recall@10 {r_got:.4f} sharded against "
                 f"{r_want:.4f} on one device")
        with plain_dispatch():
            plain = [server.query(q, 10) for q in rows[:2]]
        agree(got[:2], plain, f"the sharded {label} server's kernels "
              f"against their plain versions")
        log(f"    {label}: answers {'bit-equal to' if bit else 'equal (near ties aside) to'}"
            f" the single-device server's; recall@10 {r_got:.4f} "
            f"(single device {r_want:.4f}); p50 / p99 {g50:.3f} / "
            f"{g99:.3f} ms against {w50:.3f} / {w99:.3f} ms on one device; "
            f"{n // len(rows)} {kernel.__name__} launches a batch; "
            f"kernels = plain versions under the sharded path")
        return server, got

    tmp = tempfile.mkdtemp(prefix="zen-sharded-")
    try:
        # flat: the single-device snapshot reloaded onto the mesh
        flat_servers = {}
        for st in ("float32", "int8"):
            single = serve.build_index(
                flat_corpus, k, storage=st, device=flat_corpus.device,
                generator=torch.Generator().manual_seed(0))
            sdir = os.path.join(tmp, f"flat_{st}")
            serve.ZenServer(single, rerank_factor=4).save(sdir)
            t = time.perf_counter()
            sharded = serve.ZenServer.load(sdir, mesh=mesh).index
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            shutil.rmtree(sdir)
            log(f"    flat {st}: ZenServer.load(mesh=) {load_s:.2f} s; "
                f"{sharded.coords.shard_rows:,} rows a shard "
                f"({sharded.coords.n_rows:,} + "
                f"{sharded.coords.shape[0] - sharded.coords.n_rows} padding)")
            flat_servers[st] = compare(single, sharded, zt.zen_topk,
                                       f"flat {st}", flat_corpus)
            if st == "float32":
                profile_serving(flat_servers[st][0], rows[:4])
            del single
        # IVF: built on the mesh from phase 8's generator
        ivf_servers = {}
        for st in ("float32", "int8"):
            single = ivf_index if st == "float32" else serve.build_index(
                corpus, k, index="ivf", storage=st, n_clusters=N_CLUSTERS,
                tile_rows=TILE_ROWS, device=corpus.device,
                generator=torch.Generator().manual_seed(0))
            t = time.perf_counter()
            sharded = serve.build_index(
                corpus, k, index="ivf", storage=st, n_clusters=N_CLUSTERS,
                tile_rows=TILE_ROWS, mesh=mesh,
                generator=torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            if not torch.equal(sharded.ivf.centroids.cpu(),
                               ivf_index.ivf.centroids.cpu()):
                fail(f"the sharded IVF ({st}) build fitted other centroids "
                     f"than phase 8's from the same generator")
            log(f"    IVF {st}: build_index(mesh=) {build_s:.2f} s, T = "
                f"{sharded.ivf.tiles_per_cluster} a shard (one device: "
                f"{single.ivf.tiles_per_cluster}); centroids byte-equal to "
                f"phase 8's")
            ivf_servers[st] = compare(single, sharded, ip.ivf_probe,
                                      f"IVF {st}", corpus)
            if st == "float32":
                profile_serving(ivf_servers[st][0], rows[:4])
            del single

        # a silent shard: shard 2 past its deadline (fake clock)
        q = rows[0]
        for label, (server, _), kernel in (
                ("flat f32", flat_servers["float32"], zt.zen_topk),
                ("IVF f32", ivf_servers["float32"], ip.ivf_probe)):
            clock = [0.0]
            server.enable_fault_tolerance(deadline_s=10.0,
                                          clock=lambda: clock[0])
            for s in range(4):
                server.heartbeat(s)
            clock[0] = 11.0
            for s in (0, 1, 3):
                server.heartbeat(s)
            before = kernel.launches
            d, ids = server.query(q, 10)
            n = kernel.launches - before
            if server.stats()["degraded_shards"] != ["shard2"]:
                fail(f"{label}: degraded shards "
                     f"{server.stats()['degraded_shards']}")
            if not torch.isfinite(d).all():
                fail(f"{label}: degraded answers are not finite")
            index = server.index
            if index.ivf is None:
                r = index.coords.shard_rows
                held = (ids >= 2 * r) & (ids < 3 * r)
            else:
                held = torch.isin(ids, index.ivf.tile_ids.blocks[2]
                                  .to(ids.device)) & (ids >= 0)
            if held.any():
                fail(f"{label}: shard 2's ids answer while it is silent")
            with plain_dispatch():
                plain = server.query(q, 10)
            agree([(d, ids)], [plain], f"the degraded {label} server's "
                  f"kernels against their plain versions")
            server.heartbeat(2)
            log(f"    {label}: shard2 silent past 10 s: degraded_shards "
                f"['shard2'], {n} {kernel.__name__} launches (3 live "
                f"shards), no id of shard 2, finite answers, kernels = "
                f"plain versions under the mask")

        # reshard: the 4-shard IVF save onto 2 shards and onto no mesh
        server, want = ivf_servers["float32"]
        sdir = os.path.join(tmp, "ivf4")
        t = time.perf_counter()
        server.save(sdir)
        save_s = time.perf_counter() - t
        for label, kw in (("2 shards", {"mesh": make_mesh(2)}),
                          ("no mesh", {"device": corpus.device})):
            back = serve.ZenServer.load(sdir, **kw)
            got = [back.query(q, 10) for q in rows]
            bit = agree(got, want, f"the 4-shard IVF snapshot on {label}")
            log(f"    the 4-shard IVF f32 save ({save_s:.2f} s) reloaded "
                f"on {label}: answers "
                f"{'bit-equal' if bit else 'equal (near ties aside)'}")
            del back
        try:
            serve.build_index(corpus[:2_000], k, index="ivf", storage="pq",
                              mesh=mesh, n_clusters=16)
        except NotImplementedError as exc:
            log(f"    storage='pq' with a mesh raises NotImplementedError "
                f"({exc})")
        else:
            fail("storage='pq' with a mesh did not raise")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"    {time.perf_counter() - t0:.1f} s")
    return launches


def dense_kernels():
    """(name, kernel wrapper, plain version, ``testing.dense_errors`` kind)
    of the three dense kernels."""
    import importlib

    from repro_torch.kernels import jsd as jk
    from repro_torch.kernels import zen as zk

    pk = importlib.import_module("repro_torch.kernels.pdist")
    return (("pdist_sq", pk.pdist_sq, pk.pdist_sq_plain, "pdist"),
            ("zen_estimate", zk.zen_estimate, zk.zen_estimate_plain, "zen"),
            ("jsd_pdist", jk.jsd_pdist, jk.jsd_pdist_plain, "jsd"))


def check_dense_kernels(corpus, coords, gen):
    """Phase 14: the dense kernels against their plain versions on the
    card; returns each kernel's max |out - out_plain| on its own output
    (squared distances for pdist_sq, distances for the others)."""
    import importlib

    import torch
    from repro_torch import testing
    from repro_torch.data import synthetic as syn

    t0 = time.perf_counter()
    dev = corpus.device
    funcs = {name: (kernel, plain, kind)
             for name, kernel, plain, kind in dense_kernels()}
    probs = syn.probability_space(2 * SQUARE, 256, generator=gen)
    cases = []  # (kernel name, label, X, Y, extra args)
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        for i, shape in enumerate(testing.PDIST_CASES):
            X, Y = testing.dense_inputs("pdist", shape, i, dt, dev)
            cases.append(("pdist_sq", f"{tag} {shape}", X, Y, ()))
        for i, shape in enumerate(testing.ZEN_CASES):
            X, Y = testing.dense_inputs("zen", shape, i, dt, dev)
            for mode in ("zen", "lwb", "upb"):
                cases.append(("zen_estimate", f"{tag} {shape} {mode}", X, Y,
                              (mode,)))
        for i, shape in enumerate(testing.JSD_CASES):
            X, Y = testing.dense_inputs("jsd", shape, i, dt, dev)
            cases.append(("jsd_pdist", f"{tag} {shape} sparse", X, Y, ()))
        # pdist_sq at the edges of its plans (kernels/pdist.py::pdist_plan)
        for i, shape in enumerate(testing.PDIST_PLAN_CASES):
            X, Y = testing.dense_inputs("pdist", shape, 100 + i, dt, dev)
            cases.append(("pdist_sq", f"{tag} plan edge {shape}", X, Y, ()))
        # m = 4,096 and nearly equal rows of norm ~1,000 (MMA plan)
        for kind, shape in (("pdist", (300, 260, 4_096)),
                            ("near", (256, 200, 256)),
                            ("near", (130, 140, 4_096))):
            X, Y = testing.dense_inputs(kind, shape, 11, dt, dev)
            cases.append(("pdist_sq", f"{tag} {kind} {shape}", X, Y, ()))
    # operands of two dtypes: each keeps its own values (both launch as f32)
    for name, kind in (("pdist_sq", "pdist"), ("zen_estimate", "zen"),
                       ("jsd_pdist", "jsd")):
        for da, db in ((torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16)):
            X, _ = testing.dense_inputs(kind, (130, 72, 64), 3, da, dev)
            _, Y = testing.dense_inputs(kind, (130, 72, 64), 3, db, dev)
            cases.append((name, f"X {da} with Y {db}", X, Y,
                          ("zen",) if kind == "zen" else ()))
    sparse_x = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.25] * 4], device=dev)
    sparse_y = torch.tensor([[0.0, 0.0, 0.5, 0.5]], device=dev)
    cases.append(("jsd_pdist", "disjoint supports", sparse_x, sparse_y, ()))
    # X against X, and the working shapes of phases 15 and 16
    sample = corpus[:EVAL_ROWS]
    square = corpus[:SQUARE]
    refs = corpus[EVAL_ROWS:EVAL_ROWS + 16]
    cases += [
        ("pdist_sq", "X vs X 2048 x 256", sample, sample, ()),
        ("pdist_sq", "1,000,000 x 16 x 256", corpus[:1_000_000], refs, ()),
        ("pdist_sq", f"{SQUARE} x {SQUARE} x 256", square,
         corpus[SQUARE:2 * SQUARE], ()),
        ("jsd_pdist", "X vs X 2048 x 256", probs[:EVAL_ROWS],
         probs[:EVAL_ROWS], ()),
        ("jsd_pdist", f"{SQUARE} x {SQUARE} x 256", probs[:SQUARE],
         probs[SQUARE:2 * SQUARE], ()),
        ("jsd_pdist", "2048 x 16 x 256", probs[:EVAL_ROWS],
         probs[-16:], ())]
    for mode in ("zen", "lwb", "upb"):
        cases += [
            ("zen_estimate", f"X vs X 2048 x 16 {mode}", coords[:EVAL_ROWS],
             coords[:EVAL_ROWS], (mode,)),
            ("zen_estimate", f"{SQUARE} x {SQUARE} x 16 {mode}",
             coords[:SQUARE], coords[SQUARE:2 * SQUARE], (mode,)),
            ("zen_estimate", f"64 x 1,000,000 x 16 {mode}", coords[:64],
             coords[:1_000_000], (mode,))]
    # k past one 256-column chunk, and more column tiles than grid y holds
    for kw in (300, 600):
        X, Y = testing.dense_inputs("zen", (1_024, 1_024, kw), kw,
                                    torch.float32, dev)
        for mode in ("zen", "lwb", "upb"):
            cases.append(("zen_estimate", f"1024 x 1024 x {kw} {mode}", X, Y,
                          (mode,)))
    for name, kind in (("pdist_sq", "pdist"), ("zen_estimate", "zen"),
                       ("jsd_pdist", "jsd")):
        X, Y = testing.dense_inputs(kind, (3, WIDE_COLS, 8), 5,
                                    torch.float32, dev)
        cases.append((name, f"3 x {WIDE_COLS:,} x 8", X, Y,
                      ("zen",) if kind == "zen" else ()))
    pk = importlib.import_module("repro_torch.kernels.pdist")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {name: [0.0, 0.0, 0.0] for name in funcs}  # out, squared, D
    plans = {}  # pdist_sq's cases by plan
    for name, label, X, Y, extra in cases:
        kernel, plain, kind = funcs[name]
        if name == "pdist_sq":
            Xp, Yp = (X, Y) if X.dtype == Y.dtype else (X.float(), Y.float())
            plan = pk.pdist_plan(X.shape[0], Y.shape[0], X.shape[1],
                                 Xp.dtype, pk.operands_aligned(Xp, Yp),
                                 n_sms=n_sms).kernel
            plans[plan] = plans.get(plan, 0) + 1
        got = kernel(X, Y, *extra)
        torch.cuda.synchronize()
        want = plain(X, Y, *extra)
        err_sq, err_d, why = testing.dense_errors(kind, X, Y, got, want)
        if why is not None:
            fail(f"{name} ({label}) disagrees with its plain version: {why}")
        if label == "disjoint supports" and float(got[0, 0]) != 1.0:
            fail(f"jsd_pdist of disjoint supports is {float(got[0, 0])!r}, "
                 f"not 1.0")
        w = worst[name]
        w[0] = max(w[0], float((got - want).abs().max()))
        w[1], w[2] = max(w[1], err_sq), max(w[2], err_d)
    # the MMA plan against the SIMT tile on the same working shapes
    for label, X, Y in ((f"X vs X {EVAL_ROWS} x 256", sample, sample),
                        (f"{SQUARE} x {SQUARE} x 256", square,
                         corpus[SQUARE:2 * SQUARE]),
                        (f"3 x {WIDE_COLS:,} x 8", *testing.dense_inputs(
                            "pdist", (3, WIDE_COLS, 8), 5, torch.float32,
                            dev))):
        got = pk.pdist_sq(X, Y)
        simt = pk.pdist_sq(X, Y, plan=pk.dense_plan(X.shape[0], Y.shape[0],
                                                    X.shape[1]))
        torch.cuda.synchronize()
        _, _, why = testing.dense_errors("pdist", X, Y, got, simt)
        if why is not None:
            fail(f"pdist_sq's MMA plan and SIMT tile differ ({label}): {why}")
    log(f"[14] dense kernels vs their plain versions: {len(cases)} cases "
        f"(f32/bf16 sweeps of repro_torch.testing, pdist_sq's plan edges, "
        f"m = 4,096 and near rows of norm 1e3, X vs X, operands of two "
        f"dtypes, the working shapes, zen_estimate at k = 300 and 600, "
        f"{WIDE_COLS:,} columns) agree in squared space; pdist_sq's cases "
        f"by plan {plans}; its MMA plan agrees with the SIMT tile at "
        f"{EVAL_ROWS:,}^2 x 256, {SQUARE:,}^2 x 256 and {WIDE_COLS:,} "
        f"columns; "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"    tolerance: pdist_sq and zen_estimate |d^2 - d^2_plain| <= "
        f"{testing.SQ_RTOL:g} x (|x|^2 + |y|^2) (the norm expansion's f32 "
        f"sums in another order), jsd_pdist |K - K_plain| <= "
        f"{testing.JSD_KTOL:g} on K = D^2 (three f32 sums of m entropy "
        f"terms); on D itself within sqrt of that")
    for name, (out, sq, d) in worst.items():
        log(f"    {name}: max |out - out_plain| {out:.3g}, in squared space "
            f"{sq:.3g}, on D {d:.3g}")
    return {name: w[0] for name, w in worst.items()}


def evaluate(witness, sample, probs, k: int, pivot_ids=None):
    """Phase 15's evaluation on the tensors' device, through the public
    dispatch ``repro_torch.kernels``. Returns (quality profiles by method,
    farthest_first/maxvol pivot ids, the dispatched matrices by name, the
    reduced coordinates by method, the seconds the host measures took).
    ``pivot_ids`` replaces the selection (the CPU rerun takes the card's)."""
    import torch
    import repro_torch.kernels as K
    from repro_torch.core import pivots, quality, reducers
    from repro_torch.core.baselines import LMDSTransform
    from repro_torch.core.projection import NSimplexTransform

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    fitted = {"zen_random": reducers.make_reducer("zen", k).fit(
        witness, generator=gen(1))}
    ids = {}
    for st in ("farthest_first", "maxvol"):
        ids[st] = (pivots.pivot_ids(witness, k, strategy=st)
                   if pivot_ids is None else pivot_ids[st])
        fitted[f"zen_{st}"] = dataclasses.replace(
            reducers.make_reducer("zen", k),
            transform_=pivots.select_references(witness, k, ids=ids[st]))
    fitted["pca"] = reducers.make_reducer("pca", k).fit(witness)
    fitted["rp"] = reducers.make_reducer("rp", k).fit(witness,
                                                       generator=gen(2))
    fitted["mds"] = reducers.make_reducer("mds", k).fit(
        witness[:MDS_WITNESS])
    fitted["lmds"] = reducers.make_reducer("lmds", k).fit(witness,
                                                           generator=gen(3))
    mats = {"delta": K.pdist(sample, sample)}
    reduced = {}
    for name, r in fitted.items():
        Y = reduced[name] = r.transform(sample)
        mats[name] = (K.zen_estimate(Y, Y) if name.startswith("zen")
                      else K.pdist(Y, Y))
    # the JSD leg: coordinate-free, reference and object distances only
    R, P = probs[:k], probs[k:]
    D_refs = K.jsd_pdist(R, R).fill_diagonal_(0.0)
    D_xr = K.jsd_pdist(P, R)
    mats["jsd_delta"] = K.jsd_pdist(P, P)
    Xz = NSimplexTransform.from_distances(D_refs).transform_from_distances(
        D_xr)
    Xl = LMDSTransform(k=k).fit_from_distances(
        D_refs).transform_from_distances(D_xr)
    reduced.update(jsd_zen=Xz, jsd_lmds=Xl)
    mats["jsd_zen"] = K.zen_estimate(Xz, Xz)
    mats["jsd_lmds"] = K.pdist(Xl, Xl)
    if probs.is_cuda:
        torch.cuda.synchronize()
    t_measures = time.perf_counter()
    profiles = {}
    for name, D in mats.items():
        if name in ("delta", "jsd_delta"):
            continue
        delta = quality.flatten_upper(
            mats["jsd_delta" if name.startswith("jsd") else "delta"])
        # quadratic normalised by the loss of the all-zero embedding
        qmax = float((delta.double() ** 2).sum())
        profiles[name] = quality.quality_profile(
            delta, quality.flatten_upper(D), qmax=qmax)
    return profiles, ids, mats, reduced, time.perf_counter() - t_measures


def _fmt(p) -> str:
    return (f"kruskal {p['kruskal']:.4f} sammon {p['sammon']:.4f} spearman "
            f"{p['spearman']:.4f} quadratic {p['quadratic']:.4f}")


def run_evaluation(corpus, gen, k: int):
    """Phase 15: the evaluation on the card, its cross-checks, and its
    rerun on the CPU; returns each dense kernel's launches in the card
    run."""
    import torch
    from repro_torch import testing
    from repro_torch.core import metrics, pivots, zen
    from repro_torch.data import synthetic as syn

    t0 = time.perf_counter()
    perm = torch.randperm(corpus.shape[0],
                          generator=torch.Generator().manual_seed(5))
    witness = corpus[perm[:EVAL_ROWS].to(corpus.device)]
    sample = corpus[perm[EVAL_ROWS:2 * EVAL_ROWS].to(corpus.device)]
    probs = syn.probability_space(EVAL_ROWS + k, 256, generator=gen)
    kernels = {name: kernel for name, kernel, _, _ in dense_kernels()}
    for kernel in kernels.values():
        kernel.launches = 0
    profiles, ids, mats, reduced, t_measures = evaluate(witness, sample,
                                                         probs, k)
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    t_card = time.perf_counter() - t0
    if min(launches.values()) == 0:
        fail(f"the evaluation did not launch every dense kernel: {launches}")
    log(f"[15] paper evaluation on the card, k = {k}: {EVAL_ROWS:,} "
        f"witnesses and a {EVAL_ROWS:,}-row sample of the "
        f"{corpus.shape[0]:,} x 256 corpus ({EVAL_ROWS * (EVAL_ROWS - 1) // 2:,}"
        f" pairs), MDS on {MDS_WITNESS}; JSD leg {EVAL_ROWS:,} + {k} "
        f"probability rows of width 256; {t_card:.1f} s, of which the "
        f"data, pivots, fits, transforms and dispatched matrices "
        f"{t_card - t_measures:.1f} s and the quality measures (host numpy) "
        f"{t_measures:.1f} s; launches {launches}")
    log(f"    pivot ids: farthest_first {ids['farthest_first'].tolist()}, "
        f"maxvol {ids['maxvol'].tolist()}")
    for name, p in profiles.items():
        log(f"    {name:20s} {_fmt(p)}")
    # the dispatched matrices against the modules' own torch functions
    checks = [("pdist", sample, sample, mats["delta"] ** 2,
               metrics.sqeuclidean_pdist(sample, sample.clone()))]
    for name, Y in reduced.items():
        if "zen" in name:
            checks.append(("zen", Y, Y, mats[name], zen.zen_pdist(Y, Y)))
        else:
            checks.append(("pdist", Y, Y, mats[name] ** 2,
                           metrics.sqeuclidean_pdist(Y, Y.clone())))
    P = probs[k:]
    want = torch.cat([metrics.jsd_pdist(P[s:s + 256], P, assume_normalized=True)
                      for s in range(0, P.shape[0], 256)])
    checks.append(("jsd", P, P, mats["jsd_delta"], want))
    worst = 0.0
    for kind, X, Y, got, want in checks:
        err_sq, _, why = testing.dense_errors(kind, X, Y, got, want)
        if why is not None:
            fail(f"a dispatched {kind} matrix of the evaluation disagrees "
                 f"with core/metrics.py or core/zen.py: {why}")
        worst = max(worst, err_sq)
    log(f"    {len(checks)} dispatched matrices agree with core/metrics.py "
        f"and core/zen.py on the card (max squared-space error {worst:.3g})")
    # the same evaluation on the CPU, from the same rows, draws and pivots
    t0 = time.perf_counter()
    cpu_ids = {st: pivots.pivot_ids(witness.cpu(), k, strategy=st)
               for st in ids}
    cpu, _, _, _, _ = evaluate(witness.cpu(), sample.cpu(), probs.cpu(), k,
                               pivot_ids=ids)
    diff = max(abs(cpu[n][m] - profiles[n][m]) for n in profiles
               for m in ("kruskal", "sammon", "spearman", "quadratic"))
    same_ids = {st: bool(np.array_equal(cpu_ids[st], ids[st])) for st in ids}
    log(f"    the same evaluation on the CPU ({time.perf_counter() - t0:.1f}"
        f" s, the card's pivot ids): max |measure difference| {diff:.3g} "
        f"(tolerance {EVAL_ATOL}); the CPU's own pivot selection gives the "
        f"card's ids: {same_ids}")
    if not diff <= EVAL_ATOL:
        fail(f"card and CPU quality numbers differ by {diff:.3g} > "
             f"{EVAL_ATOL}")
    return launches


def time_dense(corpus, transform, gen, smi: str):
    """Phase 16: the dense kernels at their working shapes; returns each
    kernel's record for the kernels line, and logs the others."""
    import importlib

    import torch
    from repro_torch.core import metrics, zen
    from repro_torch.data import synthetic as syn

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    log_rate = SFU_PER_CLOCK * n_sms * clock_mhz * 1e6
    X = corpus[:1_000_000]
    refs = transform.refs
    coords = transform.transform(X)
    square = (corpus[:SQUARE], corpus[SQUARE:2 * SQUARE])
    delta = (corpus[:EVAL_ROWS], corpus[EVAL_ROWS:2 * EVAL_ROWS])
    probs = syn.probability_space(2 * SQUARE, 256, generator=gen)
    kernels = {name: (kernel, plain) for name, kernel, plain, _
               in dense_kernels()}
    # (kernel, shape, operands, arguments, library call, kept for the
    # kernels line)
    shapes = [
        ("pdist_sq", "transform 1,000,000 x 16 x 256", (X, refs), (),
         metrics.sqeuclidean_pdist, False),
        ("pdist_sq", f"evaluation square {SQUARE:,} x {SQUARE:,} x 256",
         square, (), metrics.sqeuclidean_pdist, False),
        # the shapes phase 15 launches: its sample's distances (delta) and
        # the reduced coordinates' (zeta); delta also in bf16
        ("pdist_sq", f"phase 15's delta {EVAL_ROWS:,} x {EVAL_ROWS:,} x 256",
         delta, (), metrics.sqeuclidean_pdist, True),
        ("pdist_sq", f"phase 15's zeta {EVAL_ROWS:,} x {EVAL_ROWS:,} x 16",
         (coords[:EVAL_ROWS], coords[EVAL_ROWS:2 * EVAL_ROWS]), (),
         metrics.sqeuclidean_pdist, False),
        ("pdist_sq", f"phase 15's delta in bf16 {EVAL_ROWS:,} x "
         f"{EVAL_ROWS:,} x 256", tuple(t.bfloat16() for t in delta), (),
         metrics.sqeuclidean_pdist, False),
        ("zen_estimate", f"({SQUARE:,} x 16)^2",
         (coords[:SQUARE], coords[SQUARE:2 * SQUARE]), ("zen",),
         zen.estimate_pdist, True),
        ("zen_estimate", "64 x 1,000,000 x 16", (coords[:64], coords),
         ("zen",), zen.estimate_pdist, False),
        ("jsd_pdist", f"{SQUARE:,} x {SQUARE:,} x 256",
         (probs[:SQUARE], probs[SQUARE:]), (), None, True),
    ]
    pk = importlib.import_module("repro_torch.kernels.pdist")
    records = {}
    for name, label, (A, B), extra, library, keep in shapes:
        kernel, plain = kernels[name]
        n, m = A.shape
        kk = B.shape[0]
        nbytes = (A.numel() + B.numel()) * A.element_size() + n * kk * 4
        pdist_note = ""
        if name == "jsd_pdist":
            # one log2 per (i, j, l) on the special-function units
            t_ops = n * kk * m / log_rate
            bound = max(nbytes / PEAK_BYTES_S, t_ops) * 1e3
            bound_by = "operations" if t_ops > nbytes / PEAK_BYTES_S \
                else "bytes"
            ops_note = f"{n * kk * m / 1e9:.2f} G log2 at {log_rate / 1e12:.2f} T/s"
        else:
            flops = 2 * n * kk * (m - (name == "zen_estimate")) \
                + 2 * (n + kk) * m
            bound, bound_by = bound_of(nbytes, flops)
            ops_note = f"{flops / 1e9:.2f} GFLOP"
        if name == "pdist_sq":
            # the bound of the plan's route (3xTF32: three products on the
            # tensor cores; bf16: one) beside the f32 CUDA-core bound
            plan = pk.pdist_plan(n, kk, m, A.dtype, pk.operands_aligned(A, B),
                                 n_sms=n_sms)
            f32_bound, f32_by = bound, bound_by
            if plan.kernel == "mma":
                tf = (2 * n * kk * m / PEAK_BF16_FLOPS
                      if A.dtype == torch.bfloat16
                      else 3 * 2 * n * kk * m / PEAK_TF32_FLOPS)
                tb = nbytes / PEAK_BYTES_S
                bound = max(tb, tf) * 1e3
                bound_by = "bytes" if tb > tf else "operations"
            Af, Bf = A.float(), B.float()  # cdist on f32 (bf16 copied first)
            cdist_ms = min(queued_ms(lambda: torch.cdist(
                Af, Bf, compute_mode="use_mm_for_euclid_dist"), 20)
                for _ in range(2))
            del Af, Bf
        iters = 5 if name == "jsd_pdist" else 20
        before = kernel.launches
        dev = queued_ms(lambda: kernel(A, B, *extra), iters)
        dev2 = queued_ms(lambda: kernel(A, B, *extra), iters)
        kernel.launches = before  # timing launches are not the path's
        plain_ms = timed(lambda: plain(A, B, *extra), 2, warmup=1)
        lib_ms = None if library is None else min(
            queued_ms(lambda: library(A, B, *extra), iters),
            queued_ms(lambda: library(A, B, *extra), iters))
        ms = min(dev, dev2)
        if name == "pdist_sq":
            log(f"[16] pdist_sq at {label}: {describe_pdist_plan(plan)}; "
                f"device time {dev:.4f} / {dev2:.4f} ms; bound of the route "
                f"{bound:.4f} ms ({bound_by}) = {bound / ms:.1%}, f32 "
                f"CUDA-core bound {f32_bound:.4f} ms ({f32_by}; "
                f"{nbytes / 1e6:.1f} MB, {ops_note}) = {f32_bound / ms:.1%};"
                f" plain {plain_ms:.3f} ms; library "
                f"{library.__module__}.{library.__name__} {lib_ms:.4f} ms, "
                f"torch.cdist (use_mm_for_euclid_dist, f32) {cdist_ms:.4f} "
                f"ms; {smi}")
        else:
            log(f"[16] {name} at {label}: device time {dev:.4f} / "
                f"{dev2:.4f} ms, bound {bound:.4f} ms ({bound_by}; "
                f"{nbytes / 1e6:.1f} MB, {ops_note}) = {bound / ms:.1%} of "
                f"bound; plain {plain_ms:.3f} ms; library "
                + ("none (no single PyTorch call computes it)"
                   if lib_ms is None
                   else f"{library.__module__}.{library.__name__} "
                        f"{lib_ms:.4f} ms") + f"; {smi}")
        if keep:
            records[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=bound_by, library_ms=lib_ms,
                                 at=label)
            if name == "pdist_sq":
                records[name].update(
                    plan=describe_pdist_plan(plan), bound_f32_ms=f32_bound,
                    bound_f32_by=f32_by, share_of_bound=bound / ms,
                    share_of_f32_bound=f32_bound / ms, cdist_ms=cdist_ms)
    return records


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a GPU")
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels import zen_topk as zt
    from repro_torch.launch import serve
    from repro_torch.testing import topk_mismatch

    quick = "--quick" in sys.argv[1:]
    sharded_only = "--sharded" in sys.argv[1:]
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] device {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}; {smi}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 must be off: the reference accumulates in full f32")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[2] built {built} from {_build.CSRC} in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for lib_name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {lib_name}: {line.strip()}")

    # -- 3. kernel vs plain ---------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 16
    corpus = syn.manifold_space(1_000_003, 256, 32, generator=gen)
    small = serve.build_index(corpus[:20_000], k, generator=torch.Generator()
                              .manual_seed(0), device=dev, keep_corpus=False)
    tr = small.transform
    coords = tr.transform(corpus)               # (1,000,003, 16) f32
    queries = tr.transform(syn.manifold_space(64, 256, 32, generator=gen))
    scale = float(coords.norm(dim=1).median())
    atol = RTOL * scale
    log(f"[3] zen_topk vs zen_topk_scan: rtol {RTOL}, atol {atol:.3g} "
        f"(1e-5 x median row norm {scale:.3g})")
    encoded = {s: quant.encode_rows(coords, s)
               for s in quant.SCALAR_STORAGE_DTYPES}
    max_err, n_checked = 0.0, 0

    def compare(q, x, s, n, mode, label):
        nonlocal max_err, n_checked
        got = zt.zen_topk(q, x, n, mode, scales=s)
        want = zt.zen_topk_scan(q, x, n, mode, scales=s)
        torch.cuda.synchronize()
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                            atol=atol)
        if msg is not None:
            fail(f"zen_topk disagrees with its plain version ({label}): "
                 f"{msg}")
        live = torch.isfinite(want[0])
        err = float((got[0] - want[0])[live].abs().max())
        max_err = max(max_err, err)
        n_checked += 1

    cases = [(st, m, nq, n, nrows)
             for st in quant.SCALAR_STORAGE_DTYPES
             for m in ("zen", "lwb", "upb")
             for nq in (2, 64) for n in (10, 64, 128)
             for nrows in (1_000_000, 1_000_003)]
    if quick or sharded_only:
        cases = [c for c in cases if c[2] == 64 and c[3] == 64
                 and c[4] == 1_000_003]
    t0 = time.perf_counter()
    for st, m, nq, n, nrows in cases:
        x, s = encoded[st]
        compare(queries[:nq], x[:nrows], None if s is None else s[:nrows],
                n, m, f"{st} {m} Q={nq} n={n} N={nrows}")
    # n > N, and an index with dead rows (the mutable index's sentinel)
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = encoded[st]
        compare(queries, x[:100], None if s is None else s[:100], 128,
                "zen", f"{st} N=100 n=128")
        dead = serve.ZenIndex(tr, x[:50_000].clone(), None, storage=st,
                              coord_scales=None if s is None
                              else s[:50_000].clone())
        dead = dead.delete(list(range(0, 50_000, 7)))
        compare(queries, dead.coords, dead.coord_scales, 64, "lwb",
                f"{st} N=50000 with {50_000 // 7 + 1} dead rows")
    # exactly duplicated rows (64 copies of 1,000): distances tie exactly,
    # and the ids must equal the plain version's, the lower id first
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = quant.encode_rows(coords[:1_000].repeat(64, 1), st)
        got = zt.zen_topk(queries, x, 64, "zen", scales=s)
        want = zt.zen_topk_scan(queries, x, 64, "zen", scales=s)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            fail(f"zen_topk orders tied duplicate rows unlike its plain "
                 f"version ({st})")
        compare(queries, x, s, 64, "zen", f"{st} 64 copies of 1,000 rows")
    # odd k: rows whose bytes are not a multiple of 16 (the TMA bulk copy's
    # tail), k = 1, 2 and 13 (the MMA plan) and 130 (the SIMT plan); Zen,
    # whose distances stay off zero (Lwb's nearest rows of 200,003 random
    # ones at k <= 2 sit where any two f32 summation orders differ by more
    # than the tolerance, the SIMT plan's as much as the MMA plan's)
    for kk in (1, 2, 13, 130):
        xk = torch.randn((200_003, kk), generator=gen, device=dev)
        xk[:, -1].abs_()
        qk = torch.randn((64, kk), generator=gen, device=dev)
        qk[:, -1].abs_()
        for st in quant.SCALAR_STORAGE_DTYPES:
            x, s = quant.encode_rows(xk, st)
            compare(qk, x, s, 64, "zen", f"{st} k={kk} Q=64 n=64 N=200003")
    del xk, qk
    # the MMA plan (3xTF32 on the tensor cores) against the SIMT plan (f32
    # FMAs) on the same inputs, every mode
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = encoded[st]
        for m in ("zen", "lwb", "upb"):
            got = zt.zen_topk(queries, x, 64, m, scales=s)
            want = zt.zen_topk(queries, x, 64, m, scales=s, plan=zt.simt_plan(
                64, x.shape[0], 64, k, n_sms))
            msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=RTOL,
                                atol=atol)
            if msg is not None:
                fail(f"the MMA and SIMT plans of zen_topk differ ({st} {m}): "
                     f"{msg}")
    log("    the MMA and SIMT plans agree at N = 1,000,003 (3 storages x 3 "
        "modes)")
    # wide lists: widths 512 to 16,384 (past 8,192 the lists live in global
    # memory, one query a block), on 200,003 rows; and k = 300
    wide_ns = (300, 2_048) if quick else (300, 600, 2_048, 5_000, 10_000)
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = encoded[st]
        for n in wide_ns if st == "float32" else wide_ns[:1]:
            plan = zt.launch_geometry(64, 200_003, n, k, torch.cuda
                                      .get_device_properties(dev)
                                      .multi_processor_count)
            compare(queries, x[:200_003], None if s is None else s[:200_003],
                    n, "zen", f"{st} Q=64 n={n} N=200003 (width {plan.w}, "
                    f"{plan.kernel} plan, {plan.queries_per_block} a block, "
                    f"lists in {'global' if plan.global_lists else 'shared'}"
                    f" memory)")
    wide_k = torch.randn((100_000, 300), generator=gen, device=dev)
    wide_k[:, -1].abs_()
    wide_q = torch.randn((64, 300), generator=gen, device=dev)
    wide_q[:, -1].abs_()
    for n in (10, 300):
        compare(wide_q, wide_k, None, n, "zen",
                f"float32 k=300 Q=64 n={n} N=100000")
    log(f"    {n_checked} cases agree (ids equal outside near-ties), widths "
        f"up to {zt.launch_geometry(64, 200_003, wide_ns[-1], k, 132).w} and"
        f" k up to 300; max |d - d_plain| {max_err:.3g}; "
        f"{time.perf_counter() - t0:.1f} s")
    del encoded, wide_k, wide_q
    full_corpus = corpus                        # 1,000,003 rows
    if sharded_only:
        corpus = corpus[:1_000_000]
        batches = [syn.manifold_space(64, 256, 32, generator=gen)
                   for _ in range(9)]
        ivf_server, _ = serve_ivf(corpus, batches, k, "float32")
        check_sharded(full_corpus, ivf_server.index, corpus, batches, k,
                      smi)
        log("sharded run: stopping after phases 8 (f32) and 20")
        sys.exit(2)
    dense_err = check_dense_kernels(corpus, coords, gen)
    ivf_err = check_ivf_kernels(coords[:1_000_000], queries, atol)
    stage_cases, stage_bad, stage_err = check_stage_kernel(dev)
    if quick:
        log("quick run: stopping after the kernel checks")
        sys.exit(2)

    # -- 4. serve end to end --------------------------------------------
    corpus = corpus[:1_000_000]
    t0 = time.perf_counter()
    index = serve.build_index(corpus, k, storage="float32",
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
    torch.cuda.synchronize()
    log(f"[4] build_index: {index.size} x {k} from 256-d, f32, "
        f"{time.perf_counter() - t0:.2f} s; coords "
        f"{index.coords.numel() * 4 / 2**20:.0f} MiB, corpus "
        f"{corpus.numel() * 4 / 2**30:.2f} GiB on {index.device}")
    batches = [syn.manifold_space(64, 256, 32, generator=gen)
               for _ in range(9)]
    serve.ZenServer(index, rerank_factor=4).query(batches[0], 10)  # warm-up
    server = serve.ZenServer(index, rerank_factor=4)
    zt.zen_topk.launches = 0
    lat, recalls = [], []
    for q in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, ids = server.query(q, 10)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if d.shape != (64, 10) or not torch.isfinite(d).all():
            fail(f"served distances not finite of shape (64, 10): {d.shape}")
        if ids.min() < 0 or ids.max() >= corpus.shape[0]:
            fail("served ids out of range")
        recalls.append(serve.recall(ids, serve.exact_topk(q, corpus, 10)))
    serve_launches = zt.zen_topk.launches
    if serve_launches == 0:
        fail("the serving path never launched the zen_topk kernel")
    lat_ms = np.asarray(lat) * 1e3
    log(f"    served {len(lat)} batches x 64 queries: recall@10 "
        f"{np.mean(recalls):.4f} (min batch {np.min(recalls):.4f}); "
        f"request latency p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms; zen_topk launches "
        f"{serve_launches}; stats {server.stats()}")
    profile_serving(server, batches[1:5])
    # the card's answers against the CPU path on a small index
    pivots = [int(i) for i in torch.randperm(
        20_000, generator=torch.Generator().manual_seed(1))[:k]]
    for st in quant.SCALAR_STORAGE_DTYPES:
        q = batches[1]
        got = serve.ZenServer(serve.build_index(
            corpus[:20_000], k, storage=st, pivot_ids=pivots, device=dev),
            rerank_factor=4).query(q, 10)
        want = serve.ZenServer(serve.build_index(
            corpus[:20_000].cpu(), k, storage=st, pivot_ids=pivots,
            device="cpu"), rerank_factor=4, chunk=4096).query(q.cpu(), 10)
        # fit on two devices: coordinates differ by f32 noise, which a
        # quantised code can turn into one storage step; the re-rank is
        # exact, so the results agree to 1e-4
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        if msg is not None:
            fail(f"card and CPU serving disagree ({st}): {msg}")
    log("    card vs CPU serving on a 20,000-row index agree "
        "(f32/bf16/int8, re-rank 4)")

    # -- 5. churn --------------------------------------------------------
    zt.zen_topk.launches = 0
    q = batches[1]
    _, ids = server.query(q, 10)
    dead = sorted(set(ids[:, :3].ravel().tolist())
                  | set(range(0, 1_000_000, 997)))
    server.delete(dead)
    fresh = syn.manifold_space(2_000, 256, 32, generator=gen)
    new_ids = list(range(1_000_000, 1_001_000)) + dead[:1_000]
    server.upsert(new_ids, fresh)
    revived = set(dead[:1_000])
    for step in ("after delete + upsert", "after compact"):
        for q in batches[1:4]:
            d, ids = server.query(q, 10)
            back = (set(ids.ravel().tolist()) & set(dead)) - revived
            if back or not torch.isfinite(d).all():
                fail(f"churn {step}: deleted ids came back: {sorted(back)}")
        server.compact()
    log(f"[5] churn: deleted {len(dead)}, upserted {len(new_ids)} "
        f"({len(revived)} revived ids); no deleted id returned after "
        f"delete/upsert or compact; index {server.index.size} live rows; "
        f"zen_topk launches {zt.zen_topk.launches}")

    # -- 6. timing at the serving shape ----------------------------------
    nq, n = 64, 64
    qt = queries[:nq].contiguous()
    x32 = coords[:1_000_000].contiguous()
    n_sms = torch.cuda.get_device_properties(qt.device).multi_processor_count
    records = {}
    log(f"[6] zen_topk at Q={nq}, N=1,000,000, k={k}, n={n}; {smi}")
    for st in quant.SCALAR_STORAGE_DTYPES:
        x, s = quant.encode_rows(x32, st)
        plan = zt.launch_geometry(nq, x.shape[0], n, k, n_sms,
                                  x.element_size())
        nbytes = (qt.numel() * 4 + x.numel() * x.element_size()
                  + (0 if s is None else s.numel() * 4) + nq * n * 8)
        flops = 2 * nq * x.shape[0] * k
        # the f32 CUDA-core bound, and the bound of the plan's route: 3xTF32
        # is three products on the tensor cores
        f32_bound, f32_by = bound_of(nbytes, flops)
        bound, bound_by = f32_bound, f32_by
        if plan.kernel == "mma":
            tb, tf = nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_FLOPS
            bound = max(tb, tf) * 1e3
            bound_by = "bytes" if tb > tf else "operations"
        before = zt.zen_topk.launches
        ms = timed(lambda: zt.zen_topk(qt, x, n, "zen", scales=s), 20)
        ms2 = timed(lambda: zt.zen_topk(qt, x, n, "zen", scales=s), 20)
        dev = queued_ms(lambda: zt.zen_topk(qt, x, n, "zen", scales=s), 20)
        split = kernel_split(lambda: zt.zen_topk(qt, x, n, "zen", scales=s))
        zt.zen_topk.launches = before  # timing launches are not the path's
        plain = timed(lambda: zt.zen_topk_scan(qt, x, n, "zen", scales=s),
                      3, warmup=1)

        def library():
            xf = x.float() if s is None else x.float() * s
            z2 = ((qt * qt).sum(1, keepdim=True) + (xf * xf).sum(1)[None]
                  - 2.0 * qt[:, :-1] @ xf[:, :-1].T)
            return torch.topk(torch.sqrt(torch.clamp_min(z2, 0.0)), n,
                              dim=1, largest=False)

        lib = timed(library, 10)
        lib_dev = queued_ms(library, 10)
        records[st] = dict(ms=dev, plain_ms=plain, bound_ms=bound,
                           bound_by=bound_by, library_ms=lib_dev,
                           bound_f32_ms=f32_bound, bound_f32_by=f32_by,
                           pass1_ms=split["pass 1"], pass2_ms=split["pass 2"])
        log(f"    {st:8s}: {describe_plan(plan, n)}")
        log(f"      kernel {ms:.4f} / {ms2:.4f} ms, device time {dev:.4f} ms "
            f"({_fmt_split(split)}); bound of the route {bound:.4f} ms "
            f"({bound_by}) = {bound / dev:.1%}, f32 CUDA-core bound "
            f"{f32_bound:.4f} ms ({f32_by}; {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) = {f32_bound / dev:.1%}; plain "
            f"{plain:.3f} ms; library {lib:.4f} ms, device time "
            f"{lib_dev:.4f} ms")
    main_rec = records["float32"]
    # narrower and wider lists at the same shape: width 16 (n = 10), and
    # widths 512 (n = 65 x 4), 2,048 (n = 300 x 4) and 16,384 (lists in
    # global memory)
    for n in (10, 65 * 4, 300 * 4, 10_000):
        plan = zt.launch_geometry(nq, x32.shape[0], n, k, n_sms)
        before = zt.zen_topk.launches
        wide_ms = queued_ms(lambda: zt.zen_topk(qt, x32, n, "zen"),
                            20 if n <= 1_200 else 5)
        split = kernel_split(lambda: zt.zen_topk(qt, x32, n, "zen"),
                             iters=10 if n <= 1_200 else 3)
        zt.zen_topk.launches = before
        log(f"    float32 n={n:5d}: {describe_plan(plan, n)}")
        log(f"      device time {wide_ms:.4f} ms ({_fmt_split(split)}), "
            f"{main_rec['bound_ms'] / wide_ms:.1%} of the n = 64 bound")
    del coords, x32

    # -- 8. IVF serving at full width --------------------------------------
    ivf_server, ivf_launches = serve_ivf(corpus, batches, k, "float32")
    ivf_index_f32 = ivf_server.index
    profile_serving(ivf_server, batches[1:5])
    pq_server, pq_launches = serve_ivf(corpus, batches, k, "pq")
    ivf_index_pq = pq_server.index
    profile_serving(pq_server, batches[1:5])
    del pq_server
    check_ivf_small(corpus, batches, k)

    # -- 9. IVF churn ------------------------------------------------------
    churn_ivf(ivf_server, batches, gen, corpus.shape[0])
    del ivf_server

    # -- 10. timing of the probes at the serving shape ---------------------
    ivf_records = time_ivf(ivf_index_f32, ivf_index_pq, batches[1], smi)

    # -- 12. tiered serving at full size ------------------------------------
    tiered_server, stage_launches, stage_rec = serve_tiered(
        ivf_index_f32, batches, corpus, smi)
    check_tiered_small(corpus, batches, k)

    # -- 17. wide result lists on every path --------------------------------
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import tile_stage as ts
    serve_wide((
        ("flat", server, (zt.zen_topk,)),
        ("ivf f32", serve.ZenServer(ivf_index_f32, nprobe=NPROBE,
                                    rerank_factor=4), (ip.ivf_probe,)),
        ("ivf pq", serve.ZenServer(ivf_index_pq, nprobe=NPROBE,
                                   rerank_factor=4), (ip.ivf_probe_pq,)),
        ("tiered", tiered_server, (ip.ivf_probe, ts.dma_copy_blocks))),
        batches)
    # -- 18. the frontend on the full-size servers ---------------------------
    check_frontend((("flat", server.index, (zt.zen_topk,)),
                    ("ivf f32", ivf_index_f32, (ip.ivf_probe,)),
                    ("ivf pq", ivf_index_pq, (ip.ivf_probe_pq,))),
                   batches, smi)
    del ivf_index_pq

    # -- 19. replication and fault tolerance ---------------------------------
    check_replication(ivf_index_f32, batches, corpus)

    # -- 20. sharded serving on a mesh ----------------------------------------
    sharded_launches = check_sharded(full_corpus, ivf_index_f32, corpus,
                                     batches, k, smi)

    # -- 13. snapshots -----------------------------------------------------
    check_snapshots(ivf_index_f32, tiered_server, batches, corpus, k)
    del tiered_server, ivf_index_f32

    # -- 15. the paper's evaluation through the dense kernels ----------------
    dense_launches = run_evaluation(corpus, gen, k)

    # -- 16. the dense kernels at their working shapes -----------------------
    dense_records = time_dense(corpus, tr, gen, smi)

    kernels = [dict(name="zen_topk", route="cuda",
                    source="src/repro_torch/kernels/csrc/zen_topk.cu",
                    replaces="src/repro/kernels/zen_topk.py:92",
                    launches=serve_launches, max_abs_err=max_err,
                    sharded_launches=sharded_launches["zen_topk"],
                    **main_rec)]
    for kname, line, launches in (("ivf_probe", 94, ivf_launches),
                                  ("ivf_probe_pq", 296, pq_launches)):
        extra = ({"sharded_launches": sharded_launches[kname]}
                 if kname in sharded_launches else {})
        kernels.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/kernels/csrc/ivf_probe.cu",
            replaces=f"src/repro/kernels/ivf_probe.py:{line}",
            launches=launches, max_abs_err=ivf_err[kname], **extra,
            **ivf_records[kname]))
    kernels.append(dict(
        name="dma_copy_blocks", route="cuda",
        source="src/repro_torch/kernels/csrc/tile_stage.cu",
        replaces="src/repro/kernels/tile_stage.py:62",
        launches=stage_launches, max_abs_err=stage_err,
        byte_mismatches=stage_bad, cases=stage_cases, **stage_rec))
    for kname, source, line in (
            ("pdist_sq", "pdist.cu", "pdist.py:52"),
            ("zen_estimate", "zen_estimate.cu", "zen.py:60"),
            ("jsd_pdist", "jsd.cu", "jsd.py:72")):
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=f"src/repro/kernels/{line}",
            launches=dense_launches[kname], max_abs_err=dense_err[kname],
            **dense_records[kname]))
    log(f"whole run {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
