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
 21. the trainer (repro_torch.launch.train) at full width: dlrm-rm2 (26
     Criteo tables, 33,762,816 x 64 f32) 12 steps at the train_batch
     cell's B = 65,536 through the CLI's function: loss finite and falling
     (steps 0 and 11), ms a step (median of the last 8), samples/s, peak
     device memory (at most 48 GB); autoint and wide-deep 3 steps at B,
     xdeepfm at B = 4,096 (its CIN's saved activations: 20.4 GB a layer at
     65,536), autoint with --compress-grads; at full autoint width, 3
     steps, save_async + wait, 3 steps, a restore and the same 3 steps
     again: losses and every parameter byte equal; 2 reduced steps of each
     architecture on the card against the CPU (rtol 1e-4, atol 1e-6);
 22. learned embeddings into Zen serving: the two-tower model (dlrm-rm2's
     tables as the user tower, 1,000,000 x 64 items) trains 50 steps at B
     = 4,096, 5 epochs of 10 batches (in_batch_acc must rise; a held-out
     batch's beside it), build_index(index="ivf", k = 16) on
     the raw item tower as phase 8 builds, 8 batches of 64 user_repr
     queries through ZenServer (Lwb, nprobe 8, re-rank 4): recall@10
     against an exact Euclidean top-10 (Zen's beside it), p50/p99,
     ivf_probe launches; 5 more steps, the upsert of every item they
     touched, the batches again through the frontend and direct:
     bit-equal, none answered from the cache's old generation, and every
     upserted item's own vector finds it in its top-10.
 23. the LM family in the trainer at published width: qwen1.5-0.5b 12
     steps of lm_batch at the train_4k cell's S = 4,096, B = 4 through the
     CLI's function (loss finite and falling, ms a step, tokens/s, the
     share of the bf16 peak, peak device memory at most 70 GB; a profiled
     step split into GEMMs, attention, logits + cross-entropy and AdamW);
     a restart at full qwen width bit-equal; gemma2-2b and
     granite-moe-3b-a800m 3 steps at B = 1, S = 4,096, and one more step
     of each profiled; gemma2-2b's prefill of 8,192 tokens (the ring
     buffer wraps) and 16 decode steps against forward, in bf16 and f32,
     and the same with two planted faults that the check must catch; 2
     reduced steps of each LM architecture on the card against the CPU;
     matmul_f32's bf16 branch at the qwen step's shapes, and qwen reduced
     in bf16 against the CPU;
 24. LM next-token rows into Zen's JSD index at full qwen width
     (benchmarks/retrieval_e2e.py's jsd_lm_leg): train_lm 40 Markov steps,
     16,384 + 512 contexts, rows of 152,064 at temperature 6, flat and IVF
     build_index(metric="jsd", k = 16) from explicit reference ids, 8
     batches of 64 through ZenServer (re-rank 16, n = 10): recall@10
     against the jsd_pdist kernel's exact top-10, p50/p99, a batch's peak
     memory, the launches of zen_topk, ivf_probe and jsd_pdist in each
     server's 8 timed batches and the exact top-10's apart, LMDS's
     recall beside Zen's; the flat server (Lwb) returns 24 corpus rows
     first at JSD < 2e-3, the answers equal the plain dispatch's, and
     jsd_pdist equals its plain version at this width.

Phases 7, 11 and 14 run right after phase 3 (so ``--quick`` covers every
kernel); phases 17-20 run after phase 12, phases 21-24 last. Phase 3
also holds zen_topk at widths up to 16,384 (lists in global memory) and
k = 300, phase 7 the probes at widths up to 16,384 and PQ at M = 256,
phase 14 zen_estimate at k = 300 and 600 and every dense kernel past
65,535 grid rows of column tiles; phase 12 also times the staging copy of the coords and of the ids
apart, and splits a tiered request's host time into the gather of cold
tiles and the waits on the staging slots' copies.
Prints one JSON line of kernel records, the nvidia-smi line, and last the
device line. Any failed check exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
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
#: phase 21: dlrm-rm2's steps (the median of the last 8 is the step time)
#: and the bound on the trainer's peak device memory at its full width
#: (parameters, gradients, mu and nu: 4 x 8.64 GB for the table)
TRAIN_STEPS, TRAIN_PEAK_BYTES = 12, 48e9
#: phase 21: xDeepFM's batch on one card; its CIN keeps (B, 200 x 39, 10)
#: f32 a layer for backward, 20.4 GB at the cell's 65,536
XDEEPFM_BATCH = 4_096
#: phase 22: the two-tower model's batch, steps, the steps trained again
#: before the upsert, and its learning rate (benchmarks/retrieval_e2e.py's).
#: It trains epochs over a dataset of TT_DATASET batches: at the Criteo
#: vocabularies a click's (user pattern -> item) pair seldom recurs in a
#: stream of fresh batches (the item hashes a 10M-value field), so the
#: in-batch accuracy of a fresh batch stays at chance within 50 steps; the
#: phase prints that accuracy on a held-out batch beside the training one
TT_BATCH, TT_STEPS, TT_MORE, TT_LR, TT_DATASET = 4_096, 50, 5, 3e-3, 10
#: phases 21, 22 and 23: a train step on the card against the same step on
#: the CPU, the tolerance of the CPU parity tests (tests/test_torch_train.py,
#: tests/test_torch_lm_train.py)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
#: phase 23: a reduced LM step on the card against the CPU is held in two
#: parts, the loss and gradients, then both sides' AdamW updates of the
#: card's gradients (STEP_TOL each). AdamW divides each gradient by its own
#: root mean square, so an element whose f32 sum cancels to ~1e-5 of its
#: leaf's scale (its last digits set by the summation order, ~1% apart on
#: the two backends) moves ~1% of the learning rate apart after two steps
#: of whole-step trajectories: a few elements of the LMs' leaves do.
#: phase 23: qwen1.5-0.5b's steps at the train_4k cell's S = 4,096 (the
#: median of the last 8 is the step time), its batch (the cell's global
#: batch of 256 spans the reference's pod; one card takes 4 sequences,
#: 16,384 tokens a step) and the bound on its peak device memory
LM_STEPS, LM_BATCH, LM_PEAK_BYTES = 12, 4, 70e9
#: phase 23: gemma2-2b's prompt (past its 4,096-token window: the ring
#: buffer wraps) and its decode steps, each step's logits held to forward's
#: over the whole sequence at that position (max and mean |diff|), in bf16
#: and in f32. Both compute the same functions with the same roundings;
#: only the f32 accumulation order of the products differs (one row
#: against 8,208 picks another GEMM kernel). In bf16 an intermediate then
#: lands on the other side of a rounding boundary now and then, moves by
#: one ulp (2^-8 relative), and 26 layers carry it on: the sound run reads
#: max 1.0231, mean 0.07086 (the same bits on every card run so far), and
#: a planted fault, the local layers' ring written one slot ahead, only
#: max 1.1439, mean 0.09128; each position one ahead max 3.0871, mean
#: 0.2197. The bf16 limits sit between the sound and the faulty readings.
#: In f32 the two differ by f32 roundings alone (~1e-3 expected at most),
#: while the ring fault's own share of bf16's mean is ~0.05 (0.09128 over
#: a noise of 0.07086, added in quadrature): the f32 limits sit between,
#: max 0.05 and mean 0.005. Each planted fault must read past a limit.
DECODE_PROMPT, DECODE_STEPS = 8_192, 16
DECODE_TOL = {"torch.bfloat16": (1.08, 0.081), "torch.float32": (0.05, 0.005)}
#: phase 24: the JSD leg of benchmarks/retrieval_e2e.py at qwen1.5-0.5b's
#: full width: the LM's steps, batch and sequence (the leg's), the corpus
#: rows (the leg's 1,024 raised so the rows load the card: 16,384 x 152,064
#: f32 is 10 GB), the queries (8 batches of 64), the contexts' length, the
#: rows' temperature, k, the re-rank factor and n (the leg's)
JSD_LM_STEPS, JSD_LM_BATCH, JSD_LM_SEQ = 40, 8, 64
JSD_N, JSD_Q, JSD_CTX, JSD_TEMPERATURE = 16_384, 512, 32, 6.0
JSD_K, JSD_RERANK, JSD_NN = 16, 16, 10
#: phase 24: jsd_pdist against jsd_pdist_plain on K = D^2 at the rows'
#: width. testing.JSD_KTOL (1e-5) holds at m ~ 1,000; the kernel adds
#: m / 32 chunk partials into one f32 accumulator a sum (4,752 at m =
#: 152,064), whose rounding error grows as the square root of their count,
#: so the tolerance scales by sqrt(m / 1,000): 1.23e-4 (a numpy model of
#: that summation on softmax rows of 10.5 bits of entropy: 1.9e-5)
JSD_WIDE_KTOL_PER_SQRT_M = 1e-5 / 1_000**0.5


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
    profile_device(lambda: [server.query(q, 10) for q in batches],
                   f"{len(batches)} batches")


def profile_device(fn, label: str, top: int = 8):
    """Device time by kernel of ``fn()`` (torch.profiler), and the
    device's busy share of the wall time; returns ((device us, count,
    kernel name) rows, busy us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"    profile of {label} (profiler on): wall "
        f"{wall_us:.0f} us, device busy {busy:.0f} us "
        f"({busy / wall_us:.1%}); by kernel:")
    for us, count, key in rows[:top]:
        log(f"      {us:9.1f} us  {us / max(busy, 1e-9):6.1%}  x{count:<4d} "
            f"{key[:90]}")
    return rows, busy


class GcClock:
    """The seconds Python's cyclic garbage collector ran, its collections
    and its full (generation 2) collections, while the block runs (``with
    GcClock() as gc_clock``), in any thread."""

    def __init__(self):
        self.s, self.n, self.full, self._t = 0.0, 0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.s += time.perf_counter() - self._t
            self.n += 1
            self.full += info["generation"] == 2
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def host_state() -> str:
    """What else holds this process's host: its live threads, the objects
    the garbage collector tracks, its resident memory, the host's
    available memory and load average."""
    names = sorted(t.name for t in threading.enumerate())
    mem = {}
    for path in ("/proc/self/status", "/proc/meminfo"):
        with open(path) as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("VmRSS", "MemAvailable"):
                    mem[key] = int(value.split()[0]) * 1024
    return (f"{len(names)} threads {names}; {len(gc.get_objects()):,} "
            f"objects tracked by the garbage collector; resident "
            f"{mem['VmRSS'] / 1e9:.2f} GB, the host's available "
            f"{mem['MemAvailable'] / 1e9:.2f} GB; load average "
            f"{os.getloadavg()[0]:.2f} on {len(os.sched_getaffinity(0))} "
            f"cores")


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


def check_trainer(dev, smi: str) -> None:
    """Phase 21: ``repro_torch.launch.train`` at full width. dlrm-rm2 takes
    TRAIN_STEPS steps at the train_batch cell's B through the CLI's
    function (loss finite and falling, step time, samples/s, peak device
    memory under TRAIN_PEAK_BYTES, the batch as ``configs.input_specs``
    gives it); autoint and wide-deep 3 steps at B, xdeepfm at
    XDEEPFM_BATCH; autoint with --compress-grads; a resumed autoint run
    at full width bit-equal to an uninterrupted one; a reduced step of
    each architecture on the card against the CPU."""
    import functools
    import tempfile

    import torch
    from repro_torch import configs as C
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import recsys

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = C.get_arch("dlrm-rm2")
    cell = spec.cell("train_batch")
    B = cell.dims["batch"]
    held = torch.cuda.memory_allocated(dev)
    log(f"[21] the trainer at full width, the {cell.shape} cell (B = {B:,}); "
        f"{smi}; earlier phases hold {held / 1e9:.2f} GB")

    def run(arch, batch, steps, *extra):
        out = train.main(["--arch", arch, "--steps", str(steps), "--batch",
                          str(batch), "--device", str(dev), *extra])
        losses = out["losses"]
        if len(losses) != steps or not np.isfinite(losses).all():
            fail(f"{arch} {' '.join(extra)}: losses {losses}")
        ms = float(np.median(out["step_s"][-8:])) * 1e3
        return out, ms

    out, ms = run("dlrm-rm2", B, TRAIN_STEPS)
    losses, peak = out["losses"], out["peak_bytes"]
    if not losses[-1] < losses[0]:
        fail(f"dlrm-rm2's loss did not fall: {losses}")
    want = {k: (v.shape, v.dtype) for k, v in C.input_specs(
        spec, spec.make_config(), cell)["batch"].items()}
    if out["batch_shapes"] != want:
        fail(f"the pipeline's batch {out['batch_shapes']} is not the "
             f"cell's {want}")
    if peak > TRAIN_PEAK_BYTES:
        fail(f"dlrm-rm2's peak device memory {peak / 1e9:.2f} GB is past "
             f"{TRAIN_PEAK_BYTES / 1e9:.0f} GB")
    cfg = spec.make_config()
    mlp = "-".join
    log(f"    dlrm-rm2 ({cfg.n_sparse} tables, {cfg.padded_rows:,} x "
        f"{cfg.embed_dim} f32, bottom MLP "
        f"{mlp(map(str, (cfg.n_dense,) + cfg.bot_mlp))}, top MLP "
        f"{mlp(map(str, cfg.top_mlp))}), B = {B:,}, {TRAIN_STEPS} steps: "
        f"{ms:.2f} ms a "
        f"step (median of the last 8; every step "
        f"{np.round(np.asarray(out['step_s']) * 1e3, 1).tolist()} ms), "
        f"{B / ms * 1e3:,.0f} samples/s; loss {losses[0]:.5f} at step 0, "
        f"{losses[-1]:.5f} at step {TRAIN_STEPS - 1}; peak device memory "
        f"{peak / 1e9:.2f} GB ({(peak - held) / 1e9:.2f} GB above the "
        f"earlier phases'); the batch is the cell's input spec")
    step_batch = train.batch_fn(cfg, seed=0, batch=B, device=dev)(TRAIN_STEPS)
    profile_device(lambda: out["trainer"].step(step_batch),
                   "one dlrm-rm2 step", top=12)
    del out, step_batch
    torch.cuda.empty_cache()
    for arch, batch, extra in (("autoint", B, ()), ("wide-deep", B, ()),
                               ("xdeepfm", XDEEPFM_BATCH, ()),
                               ("autoint", B, ("--compress-grads",))):
        out, ms = run(arch, batch, 3, *extra)
        log(f"    {arch} {' '.join(extra)}: B = {batch:,}, 3 steps, loss "
            f"{out['losses'][0]:.5f} -> {out['losses'][-1]:.5f}, "
            f"{out['step_s'][-1] * 1e3:.2f} ms the last step "
            f"({batch / out['step_s'][-1]:,.0f} samples/s), peak "
            f"{out['peak_bytes'] / 1e9:.2f} GB")
        del out
        torch.cuda.empty_cache()

    # the gather's backward on ids that repeat thousands of times a batch
    # (the reduced tables' 512 rows under B x 8 lookups): the same bits in
    # every run, and against the CPU's sequential sums
    red = C.get_arch("dlrm-rm2").make_reduced()
    ids = train.batch_fn(red, seed=0, batch=B, device=dev)(0)["sparse"]
    ids = ids.long() + torch.tensor(red.offsets, device=dev)
    go = torch.randn((*ids.shape, red.embed_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    table = torch.zeros((red.padded_rows, red.embed_dim), device=dev,
                        requires_grad=True)
    grads = [torch.autograd.grad(recsys.gather_rows(table, ids), table,
                                 go)[0] for _ in range(3)]
    if not all(torch.equal(grads[0], g) for g in grads[1:]):
        fail("the gather's backward differs run to run on the card")
    cpu_table = table.detach().cpu().requires_grad_(True)
    want = torch.autograd.grad(recsys.gather_rows(cpu_table, ids.cpu()),
                               cpu_table, go.cpu())[0]
    gather_err = float((grads[0].cpu() - want).abs().max())
    if not torch.allclose(grads[0].cpu(), want, **STEP_TOL):
        fail(f"the gather's backward on the card is not the CPU's: max "
             f"|diff| {gather_err}")
    log(f"    the gather's backward, {ids.numel():,} ids on "
        f"{red.padded_rows} rows: 3 runs bit-equal on the card; against "
        f"the CPU {'bit-equal' if gather_err == 0 else f'max |diff| {gather_err:.3g}'}")
    del grads, table, go

    # a resumed run at full autoint width is the uninterrupted run's bits
    cfg = C.get_arch("autoint").make_config()
    make = train.batch_fn(cfg, seed=0, batch=B, device=dev)
    tr = train.recsys_trainer(cfg, seed=0, device=dev)

    def steps(start):
        return [tr.step(make(s))[0].item() for s in range(start, start + 3)]

    steps(0)
    state_gb = sum(t.numel() * t.element_size() for t in
                   (*tr.params.values(), *tr.opt_state.mu.values(),
                    *tr.opt_state.nu.values())) / 1e9
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = time.perf_counter()
        mgr.save_async(3, tr.state_tree())
        copy_s = time.perf_counter() - t
        mgr.wait()
        save_s = time.perf_counter() - t
        after = steps(3)
        want = {n: p.detach().clone() for n, p in tr.params.items()}
        t = time.perf_counter()
        step, tree = mgr.restore(like=tr.state_tree())
        tr.load_state_tree(tree)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    if step != 3:
        fail(f"restored step {step}, not 3")
    again = steps(3)
    if again != after:
        fail(f"resumed autoint losses {again} differ from the uninterrupted "
             f"run's {after}")
    bad = [n for n, p in tr.params.items() if not torch.equal(p, want[n])]
    if bad:
        fail(f"resumed autoint parameters differ from the uninterrupted "
             f"run's: {bad}")
    log(f"    restart at full autoint width ({state_gb:.2f} GB of "
        f"parameters, mu and nu): steps 3-5 after a restore of step 3 equal "
        f"the uninterrupted run's, losses and every parameter byte; "
        f"save_async {copy_s:.2f} s to the host, {save_s:.2f} s written; "
        f"restore {restore_s:.2f} s")
    del tr, want
    torch.cuda.empty_cache()

    # one reduced step on the card against the same step on the CPU
    worst = 0.0
    recsys_archs = [a for a in C.list_archs()
                    if C.get_arch(a).family == "recsys"]
    for arch in recsys_archs:
        cfg = C.get_arch(arch).make_reduced()

        def trainer(device):
            model = recsys.init_params(
                cfg, generator=torch.Generator().manual_seed(0))
            return train.Trainer(model.to(device),
                                 functools.partial(recsys.loss_fn, cfg))

        cpu, card = trainer("cpu"), trainer(dev)
        batch = train.batch_fn(cfg, seed=0, batch=512, device="cpu")(0)
        for s in range(2):
            want = cpu.step(batch)[0].item()
            got = card.step({k: v.to(dev) for k, v in batch.items()})[0]
            if not np.isclose(got.item(), want, **STEP_TOL):
                fail(f"{arch} reduced: the card's loss {got.item()} at step "
                     f"{s} against the CPU's {want}")
        for name, p in cpu.params.items():
            q = card.params[name].detach().cpu()
            if not torch.allclose(q, p.detach(), **STEP_TOL):
                fail(f"{arch} reduced: {name} after 2 steps on the card "
                     f"differs from the CPU's")
            worst = max(worst, float((q - p.detach()).abs().max()))
    log(f"    2 reduced steps of {recsys_archs} on the card equal the "
        f"CPU's (rtol {STEP_TOL['rtol']}, atol {STEP_TOL['atol']}; max "
        f"|param diff| {worst:.3g}); {time.perf_counter() - t0:.1f} s")


def check_learned_serving(dev, smi: str) -> None:
    """Phase 22: learned embeddings into Zen serving. The two-tower model
    at full width (dlrm-rm2's Criteo tables as the user tower, the
    retrieval_cand cell's n_candidates x 64 items) trains TT_STEPS steps
    of TT_BATCH, epochs over TT_DATASET batches (in_batch_acc must rise);
    its raw item tower is indexed as
    phase 8 builds (IVF, k = 16) and serves 8 batches of 64 ``user_repr``
    queries through ZenServer (recall@10 against an exact Euclidean
    top-10, p50/p99, ivf_probe launches); TT_MORE more steps, the upsert
    of every item those steps touched, and the batches again through the
    frontend and direct: bit-equal, none answered from the cache's old
    generation, each upserted item's own vector finds it in its top-10.

    The server ranks with Lwb: the Zen estimator has no identity (zen(x,
    x) = sqrt(2) x altitude), so a row's own vector need not be among its
    first-stage candidates; Lwb's is 0, and the probe's cluster order is
    then the quantizer's (both Euclidean in the apex space). Zen's recall
    on the same batches is printed beside it."""
    import functools

    import torch
    from repro_torch import configs as C
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.launch import serve, train
    from repro_torch.models import recsys
    from repro_torch.optim import AdamW

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = C.get_arch("dlrm-rm2")
    cfg = spec.make_config()
    n_items = spec.cell("retrieval_cand").dims["n_candidates"]
    log(f"[22] learned embeddings into Zen serving: two towers, users "
        f"{cfg.padded_rows:,} x {cfg.embed_dim} (dlrm-rm2's {cfg.n_sparse} "
        f"tables), items {n_items:,} x {cfg.embed_dim}; {smi}")
    model = recsys.init_two_tower_params(
        cfg, n_items, generator=torch.Generator(device=dev).manual_seed(22))
    tr = train.Trainer(model, functools.partial(recsys.two_tower_loss, cfg),
                       opt=AdamW(learning_rate=TT_LR))

    def batch(seed, step, n=TT_BATCH):
        return syn.two_tower_batch(n, cfg.vocab_sizes, n_items,
                                   generator=syn.batch_generator(seed, step,
                                                                 dev))

    losses, accs, step_s = [], [], []
    for s in range(TT_STEPS):
        b = batch(0, s % TT_DATASET)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, aux = tr.step(b)
        losses.append(loss.item())
        accs.append(aux["in_batch_acc"].item())
        step_s.append(time.perf_counter() - t)
    if not np.isfinite(losses).all():
        fail(f"two-tower losses not finite: {losses}")
    first, last = np.mean(accs[:5]), np.mean(accs[-5:])
    if not last > first:
        fail(f"in_batch_acc did not rise: {accs}")
    with torch.no_grad():
        held_out = recsys.two_tower_loss(cfg, model, batch(2, 0))[1]
    log(f"    {TT_STEPS} steps of B = {TT_BATCH:,} ({TT_STEPS // TT_DATASET} "
        f"epochs of {TT_DATASET} batches, lr {TT_LR}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, in_batch_acc (mean of 5 "
        f"steps) {first:.4f} -> {last:.4f}, on a held-out batch "
        f"{held_out['in_batch_acc'].item():.4f}; "
        f"{np.median(step_s) * 1e3:.2f} ms a step")

    k = 16
    items = model.items.detach().clone()  # the raw tower, frozen
    t = time.perf_counter()
    index = serve.build_index(items, k, index="ivf", n_clusters=N_CLUSTERS,
                              tile_rows=TILE_ROWS,
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    with torch.no_grad():
        queries = [recsys.user_repr(cfg, model, batch(1, s, 64))
                   for s in range(9)]
    fe = serve.ZenServer(index, mode="lwb", nprobe=NPROBE, rerank_factor=4,
                         frontend=True, max_batch=64, cache_size=1_024)
    fe.query(queries[0], 10, direct=True)  # warm-up
    ip.ivf_probe.launches = 0
    lat, recalls = [], []
    for q in queries[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, ids = fe.query(q, 10, direct=True)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if d.shape != (64, 10) or not torch.isfinite(d).all():
            fail(f"learned serving: distances not finite of shape (64, 10):"
                 f" {tuple(d.shape)}")
        recalls.append(serve.recall(ids, serve.exact_topk(q, items, 10)))
    launches = ip.ivf_probe.launches
    if launches == 0:
        fail("learned serving never launched ivf_probe")
    zen = serve.ZenServer(index, nprobe=NPROBE, rerank_factor=4)
    zen_recall = np.mean([serve.recall(zen.query(q, 10)[1],
                                       serve.exact_topk(q, items, 10))
                          for q in queries[1:]])
    lat_ms = np.asarray(lat) * 1e3
    log(f"    build_index(index='ivf', k = {k}) on the raw item tower: "
        f"{build_s:.2f} s, {index.ivf.n_clusters} clusters, T = "
        f"{index.ivf.tiles_per_cluster}; 8 batches x 64 user_repr queries "
        f"(Lwb, nprobe {NPROBE}, re-rank 4): recall@10 "
        f"{np.mean(recalls):.4f} (min batch {np.min(recalls):.4f}; Zen "
        f"{zen_recall:.4f}), p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms; ivf_probe launches {launches}")

    # the cache holds every batch at this generation, then the tower moves
    sched = fe.frontend
    cached = [fe.query(q, 10) for q in queries[1:]]
    for got, q in zip(cached, queries[1:]):
        if not _same_bits(got, fe.query(q, 10, direct=True)):
            fail("learned serving: scheduled and direct answers differ "
                 "before the upsert")
    live = sched.submit(queries[1], 10)  # the cache is live
    if not (live.done() and _same_bits(live.result(), cached[0])):
        fail("learned serving: a resubmitted batch was not a cache hit "
             "equal to its miss")
    touched = []
    for s in range(TT_STEPS, TT_STEPS + TT_MORE):
        b = batch(0, s % TT_DATASET)
        tr.step(b)
        touched.append(b["items"])
    touched = torch.unique(torch.cat(touched)).long()
    gen0 = fe.index.generation
    t = time.perf_counter()
    fe.upsert(touched.tolist(), model.items.detach()[touched])
    torch.cuda.synchronize()
    upsert_s = time.perf_counter() - t
    items[touched] = model.items.detach()[touched]
    ip.ivf_probe.launches = 0
    hits0 = sched.stats.cache_hits
    recalls = []
    for q in queries[1:]:
        handle = sched.submit(q, 10)
        if handle.done():
            fail("learned serving: the cache answered from the old "
                 "generation")
        sched.flush()
        direct = fe.query(q, 10, direct=True)
        if not _same_bits(handle.result(), direct):
            fail("learned serving: scheduled and direct answers differ "
                 "after the upsert")
        recalls.append(serve.recall(direct[1], serve.exact_topk(q, items,
                                                                 10)))
    if sched.stats.cache_hits != hits0:
        fail(f"learned serving: {sched.stats.cache_hits - hits0} rows "
             f"answered from the cache's old generation")
    misses = 0
    for lo in range(0, touched.numel(), 64):
        ids = touched[lo:lo + 64]
        _, got = fe.query(model.items.detach()[ids], 10, direct=True)
        misses += int((~(got.long() == ids[:, None]).any(1)).sum())
    if misses:
        fail(f"learned serving: {misses} of {touched.numel():,} upserted "
             f"items do not find themselves in their top-10")
    if ip.ivf_probe.launches == 0:
        fail("learned serving after the upsert never launched ivf_probe")
    log(f"    {TT_MORE} more steps, upsert of the {touched.numel():,} items "
        f"they touched: {upsert_s:.2f} s, generation {gen0} -> "
        f"{fe.index.generation}, T = {fe.index.ivf.tiles_per_cluster}; "
        f"scheduled and direct answers bit-equal, none from the old "
        f"generation ({hits0} cache hits before the upsert, none after); "
        f"recall@10 "
        f"{np.mean(recalls):.4f}; every upserted item's own vector finds it"
        f" in its top-10; ivf_probe launches {ip.ivf_probe.launches}; "
        f"{time.perf_counter() - t0:.1f} s")


def _gemm_kernel(name: str) -> bool:
    """Whether a device kernel's name is a library GEMM's (cuBLAS and
    CUTLASS name their products so on Hopper)."""
    key = name.lower()
    return any(t in key for t in ("gemm", "xmma", "nvjet", "cutlass",
                                  "wgmma"))


def _lm_model_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 x parameters x tokens for the
    products with weights, plus 12 x layers x S x d x tokens for
    attention's two products (forward and backward)."""
    return (6 * cfg.param_count() * tokens
            + 12 * cfg.n_layers * seq * cfg.d_model * tokens)


def check_lm_trainer(dev, smi: str) -> None:
    """Phase 23: the LM family in ``repro_torch.launch.train`` at published
    width.

    qwen1.5-0.5b (24 layers, d 1,024, 16 heads, d_ff 2,816, vocab 151,936
    padded to 152,064, QKV bias, tied embeddings, bf16, remat "minimal")
    takes LM_STEPS steps of ``lm_batch`` at the train_4k cell's S = 4,096,
    B = LM_BATCH, through the CLI's function: loss finite and falling, ms a
    step (median of the last 8), tokens/s, the share of the bf16 peak
    (``_lm_model_flops`` over 989 TFLOP/s), peak device memory (at most
    LM_PEAK_BYTES); a profiled step split into GEMMs (by kernel name) and,
    timed apart with CUDA events, attention (forward twice under remat,
    backward once, 24 layers), the logits and cross-entropy, and AdamW.
    Then a restart at full qwen width: 3 steps, save_async + wait, 3 steps;
    a restore and the same 3 steps again, losses and every parameter byte
    equal. gemma2-2b (the local/global alternation, both softcaps, the
    post-norms, (1 + w) norms) and granite-moe-3b-a800m (40 experts padded
    to 48, top-8, capacity 856 a group of 4,096) take 3 steps each at B =
    1, S = 4,096, each run's allocator counts and one more step profiled
    and timed outside the loop; gemma2-2b prefills an 8,192-token prompt
    and decodes 16 tokens, in bf16 and in f32, each step's logits against
    forward's over the whole sequence (DECODE_TOL), and again with each of
    two planted faults, which must read past the limits (negative
    controls). Then 2 reduced steps of each of the five LM architectures on
    the card against the CPU (STEP_TOL); last, bf16 on the card:
    ``matmul_f32``'s mixed-precision branch at the full-width step's shapes
    against f64 products of the same values
    (``testing.matmul_f32_errors``), and qwen1.5-0.5b's reduced config in
    bf16 against the CPU (``testing.bf16_lm_mismatch``).

    granite-8b (8.2e9 parameters: ~16 GB in bf16, ~16 GB of gradients and
    ~66 GB of f32 moments, ~98 GB) and qwen2-moe-a2.7b (~14.3e9 padded
    parameters, ~170 GB) do not fit one 80 GB card: they wait for the
    multi-card trainer (ROADMAP A, item 3) and run here at reduced width
    only.
    """
    import functools
    import tempfile

    import torch
    from repro_torch import configs as C
    from repro_torch import testing
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import layers, transformer
    from repro_torch.optim import apply_updates

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = C.get_arch("qwen1.5-0.5b")
    cfg = spec.make_config()
    cell = spec.cell("train_4k")
    S, B = cell.dims["seq_len"], LM_BATCH
    held = torch.cuda.memory_allocated(dev)
    log(f"[23] the LM trainer at full width, the {cell.shape} cell (S = "
        f"{S:,}; B = {B} of its global {cell.dims['global_batch']}); {smi}; "
        f"earlier phases hold {held / 1e9:.2f} GB; the host: {host_state()}")

    def run(arch, batch, steps):
        out = train.main(["--arch", arch, "--steps", str(steps), "--batch",
                          str(batch), "--seq", str(S), "--device",
                          str(dev)])
        losses = out["losses"]
        if len(losses) != steps or not np.isfinite(losses).all():
            fail(f"{arch}: losses {losses}")
        return out

    out = run("qwen1.5-0.5b", B, LM_STEPS)
    losses, peak = out["losses"], out["peak_bytes"]
    if not losses[-1] < losses[0]:
        fail(f"qwen1.5-0.5b's loss did not fall: {losses}")
    if peak > LM_PEAK_BYTES:
        fail(f"qwen1.5-0.5b's peak device memory {peak / 1e9:.2f} GB is "
             f"past {LM_PEAK_BYTES / 1e9:.0f} GB")
    want = {k: ((B,) + v.shape[1:], v.dtype) for k, v in C.input_specs(
        spec, cfg, cell)["batch"].items()}
    if out["batch_shapes"] != want:
        fail(f"the pipeline's batch {out['batch_shapes']} is not the "
             f"cell's {want} at B = {B}")
    ms = float(np.median(out["step_s"][-8:])) * 1e3
    tokens = B * S
    flops = _lm_model_flops(cfg, tokens, S)
    log(f"    qwen1.5-0.5b ({cfg.param_count():,} parameters; vocab "
        f"{cfg.vocab_size:,} padded to {cfg.padded_vocab:,}), B = {B}, S = "
        f"{S:,}, {LM_STEPS} steps: {ms:.2f} ms a step (median of the last 8;"
        f" every step {np.round(np.asarray(out['step_s']) * 1e3, 1).tolist()}"
        f" ms), {tokens / ms * 1e3:,.0f} tokens/s; model FLOPs "
        f"{flops / 1e12:.1f} T a step = {flops / (ms / 1e3) / PEAK_BF16_FLOPS:.1%}"
        f" of the bf16 peak; loss {losses[0]:.5f} at step 0, {losses[-1]:.5f} "
        f"at step {LM_STEPS - 1}; peak device memory {peak / 1e9:.2f} GB "
        f"({(peak - held) / 1e9:.2f} GB above the earlier phases'); the "
        f"batch is the cell's input spec at B = {B}")

    # one step under the profiler, the GEMMs' share by kernel name; then
    # attention, the logits + cross-entropy and AdamW timed apart
    tr = out["trainer"]
    step_batch = train.lm_batch_fn(cfg, seed=0, batch=B, seq=S,
                                   device=dev)(LM_STEPS)
    rows, busy = profile_device(lambda: tr.step(step_batch),
                                "one qwen1.5-0.5b step", top=12)
    gemm_us = sum(us for us, _, key in rows if _gemm_kernel(key))
    del out
    H, dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(23)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)

    q, k, v = (rand(B, S, H, dh).requires_grad_(True) for _ in range(3))
    pos = torch.arange(S, device=dev).expand(B, S)

    def attn():
        return layers.attention(q, k, v, q_positions=pos, kv_positions=pos,
                                query_chunk=cfg.query_chunk)

    def attn_fwd():
        with torch.no_grad():
            attn()

    def attn_fwd_bwd():
        torch.autograd.grad(attn().float().sum(), (q, k, v))

    attn_ms = cfg.n_layers * (timed(attn_fwd, 3, 1)
                              + timed(attn_fwd_bwd, 3, 1))
    del q, k, v
    model = tr.model
    x = rand(B, S, D).requires_grad_(True)

    def head_ce():
        logits = transformer._lm_logits(cfg, model, x)[:, :-1]
        tgt = step_batch["tokens"][:, 1:].long()
        nll = (torch.logsumexp(logits, -1)
               - torch.gather(logits, -1, tgt[..., None])[..., 0])
        torch.autograd.grad(nll.mean(), (x, model.embed))

    head_ms = timed(head_ce, 3, 1)
    del x
    grads = {n: torch.zeros_like(p) for n, p in tr.params.items()}

    def adamw():
        upd, tr.opt_state = tr.opt.update(grads, tr.opt_state, tr.params)
        apply_updates(tr.params, upd)

    adam_ms = timed(adamw, 3, 1)
    del grads
    log(f"    where a step's device time goes ({busy / 1e3:.1f} ms busy "
        f"under the profiler): GEMM kernels {gemm_us / 1e3:.1f} ms "
        f"({gemm_us / busy:.1%}, by name, attention's products included); "
        f"timed apart (CUDA events): attention {attn_ms:.1f} ms "
        f"({attn_ms * 1e3 / busy:.1%}: 24 layers x (forward + forward and "
        f"backward), its products included), logits + cross-entropy "
        f"forward and backward {head_ms:.1f} ms ({head_ms * 1e3 / busy:.1%}),"
        f" AdamW over {sum(p.numel() for p in tr.params.values()):,} "
        f"parameters {adam_ms:.1f} ms ({adam_ms * 1e3 / busy:.1%})")
    del tr, model, step_batch
    torch.cuda.empty_cache()

    # a resumed run at full qwen width is the uninterrupted run's bits
    tr = train.lm_trainer(cfg, seed=0, device=dev)
    make = train.lm_batch_fn(cfg, seed=0, batch=B, seq=S, device=dev)

    def steps(start):
        return [tr.step(make(s))[0].item() for s in range(start, start + 3)]

    steps(0)
    state_gb = sum(t.numel() * t.element_size() for t in
                   (*tr.params.values(), *tr.opt_state.mu.values(),
                    *tr.opt_state.nu.values())) / 1e9
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = time.perf_counter()
        mgr.save_async(3, tr.state_tree())
        copy_s = time.perf_counter() - t
        mgr.wait()
        save_s = time.perf_counter() - t
        after = steps(3)
        want = {n: p.detach().clone() for n, p in tr.params.items()}
        t = time.perf_counter()
        step, tree = mgr.restore(like=tr.state_tree())
        tr.load_state_tree(tree)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    if step != 3:
        fail(f"restored step {step}, not 3")
    again = steps(3)
    if again != after:
        fail(f"resumed qwen losses {again} differ from the uninterrupted "
             f"run's {after}")
    bad = [n for n, p in tr.params.items() if not torch.equal(p, want[n])]
    if bad:
        fail(f"resumed qwen parameters differ from the uninterrupted run's:"
             f" {bad}")
    log(f"    restart at full qwen width ({state_gb:.2f} GB of parameters, "
        f"mu and nu): steps 3-5 after a restore of step 3 equal the "
        f"uninterrupted run's, losses {after} and every parameter byte; "
        f"save_async {copy_s:.2f} s to the host, {save_s:.2f} s written; "
        f"restore {restore_s:.2f} s")
    del tr, want
    torch.cuda.empty_cache()

    # granite-moe runs twice: the second time with the objects of the
    # earlier phases frozen out of the garbage collector's reach, as a fresh
    # process holds none of them
    for arch, frozen in (("gemma2-2b", False), ("granite-moe-3b-a800m", False),
                         ("granite-moe-3b-a800m", True)):
        if frozen:
            gc.collect()
            gc.freeze()
        free = torch.cuda.mem_get_info(dev)[0]
        before = torch.cuda.memory_stats(dev)
        with GcClock() as gc_run:
            out = run(arch, 1, 3)
        if frozen:
            gc.unfreeze()
        after = torch.cuda.memory_stats(dev)
        alloc = {k: after.get(k, 0) - before.get(k, 0) for k in (
            "num_alloc_retries", "num_device_alloc", "num_device_free")}
        acfg = C.get_arch(arch).make_config()
        log(f"    {arch} ({acfg.param_count():,} parameters"
            + (f", {acfg.n_experts} experts padded to "
               f"{transformer.moe_lib.padded_experts(acfg.n_experts)}, top-"
               f"{acfg.top_k}, capacity "
               f"{transformer.moe_lib.capacity(S, acfg.top_k, transformer.moe_lib.padded_experts(acfg.n_experts), acfg.capacity_factor)}"
               f" a group of {acfg.moe_group_size:,}" if acfg.is_moe else
               ", local window 4,096 / global, softcaps 30 and 50")
            + f"), B = 1, S = {S:,}, 3 steps: loss {out['losses'][0]:.5f} -> "
            f"{out['losses'][-1]:.5f}, {out['step_s'][-1] * 1e3:.1f} ms the "
            f"last step ({S / out['step_s'][-1]:,.0f} tokens/s; every step "
            f"{np.round(np.asarray(out['step_s']) * 1e3, 1).tolist()} ms), "
            f"peak {out['peak_bytes'] / 1e9:.2f} GB; {free / 1e9:.2f} GB of "
            f"the card free before the run, the allocator in it {alloc}; the "
            f"garbage collector in the run {gc_run.n} times ({gc_run.full} "
            f"full), {gc_run.s * 1e3:.1f} ms"
            + (f", {len(gc.get_objects()):,} objects tracked" if not frozen
               else ", the earlier phases' objects frozen"))
        if not frozen:
            # where a step's time goes: one more step under the profiler
            # (the card's busy share), then one timed with the garbage
            # collector's share of it
            tr = out["trainer"]
            step_batch = train.lm_batch_fn(acfg, seed=0, batch=1, seq=S,
                                           device=dev)(3)
            profile_device(lambda: tr.step(step_batch), f"one {arch} step",
                           top=4)
            with GcClock() as gc_clock:
                torch.cuda.synchronize()
                t = time.perf_counter()
                tr.step(step_batch)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t) * 1e3
            log(f"    {arch}: one more step outside the loop {step_ms:.1f} "
                f"ms, the garbage collector {gc_clock.n} times, "
                f"{gc_clock.s * 1e3:.1f} ms of it")
            del tr, step_batch
        del out
        torch.cuda.empty_cache()

    # gemma2-2b: prefill past the window, then decode against forward, in
    # the model's bf16 and in f32; the same runs with a planted fault show
    # that the check sees it
    gcfg = C.get_arch("gemma2-2b").make_config()
    total = DECODE_PROMPT + DECODE_STEPS
    toks = torch.randint(0, gcfg.vocab_size, (1, total), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    def decode(model, cfg, fault=None):
        """The prompt's prefill, then DECODE_STEPS decode steps: (each
        step's logits, ms a step, prefill seconds, a ring buffer's shape).
        ``fault`` plants a bug: "position" hands each step a position one
        ahead of its own; "slot" writes the local layers' ring buffers one
        slot ahead (the cache moved after each step)."""
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = transformer.prefill(
                cfg, model, toks[:, :DECODE_PROMPT], pad_to=total)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            rings = [c for pos, c in cache.items()
                     if cfg.layer_pattern[int(pos[3:])]]
            W = rings[0]["k"].shape[2]
            planted = [(c, key) for c in rings for key in ("k", "v")
                       if fault == "slot"]
            got, step_ms = [logits], []
            for i in range(DECODE_STEPS):
                n = DECODE_PROMPT + i
                kept = [c[key][:, :, n % W].clone() for c, key in planted]
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = transformer.decode_step(
                    cfg, model, cache, toks[:, n:n + 1],
                    n + (fault == "position"))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                for (c, key), old in zip(planted, kept):
                    c[key][:, :, (n + 1) % W] = c[key][:, :, n % W]
                    c[key][:, :, n % W] = old
                got.append(logits)
            if fault is None and cfg.dtype == torch.bfloat16:
                # the last step once more, under the profiler
                profile_device(lambda: transformer.decode_step(
                    cfg, model, cache, toks[:, n:n + 1], n),
                    "one gemma2-2b decode step", top=4)
        return (torch.cat(got[:-1]), step_ms, prefill_s,
                tuple(rings[0]["k"].shape))

    for dtype in (torch.bfloat16, torch.float32):
        cfg_d = dataclasses.replace(gcfg, dtype=dtype)
        model = transformer.init_params(
            cfg_d, generator=torch.Generator(device=dev).manual_seed(23))
        with torch.no_grad():
            want = transformer.forward(cfg_d, model, toks)
        # the last step's logits predict past the end
        want = want[0, DECODE_PROMPT - 1:][:DECODE_STEPS].clone()
        tol_max, tol_mean = DECODE_TOL[str(dtype)]
        readings = {}
        for fault in (None, "position", "slot"):
            got, step_ms, prefill_s, ring = decode(model, cfg_d, fault)
            diff = (got - want).abs()
            readings[fault] = (float(diff.max()), float(diff.mean()),
                               int((got.argmax(-1) == want.argmax(-1)).sum()))
            if fault is None:
                if not (torch.isfinite(got).all() and diff.max() <= tol_max
                        and diff.mean() <= tol_mean):
                    fail(f"gemma2-2b's {dtype} decode logits differ from "
                         f"forward's: max |diff| {float(diff.max()):.4g} "
                         f"(tolerance {tol_max}), mean "
                         f"{float(diff.mean()):.4g} (tolerance {tol_mean})")
                sound = step_ms, prefill_s, ring
            elif not (readings[fault][0] > tol_max
                    or readings[fault][1] > tol_mean):
                fail(f"gemma2-2b's {dtype} decode check cannot see a planted "
                     f"fault ({fault}): max |diff| {readings[fault][0]:.4g}, "
                     f"mean {readings[fault][1]:.4g}")
            del got, diff
        worst, mean, same_top = readings[None]
        step_ms, prefill_s, ring = sound
        log(f"    gemma2-2b in {str(dtype)[6:]}: prefill of "
            f"{DECODE_PROMPT:,} tokens ({prefill_s:.2f} s; the local "
            f"layers' ring buffer {ring}) and {DECODE_STEPS} decode steps: "
            f"{np.median(step_ms):.2f} ms a step (median; "
            f"{min(step_ms):.2f}-{max(step_ms):.2f}); logits against "
            f"forward over all {total:,} tokens at each position: max |diff|"
            f" {worst:.4g} (tolerance {tol_max}), mean {mean:.4g} "
            f"(tolerance {tol_mean}), the same argmax at {same_top} of "
            f"{DECODE_STEPS}; planted faults, "
            + "; ".join(f"{what}: max {readings[f][0]:.4g}, mean "
                        f"{readings[f][1]:.4g}, argmax {readings[f][2]} of "
                        f"{DECODE_STEPS}"
                        for f, what in (("position", "each step's position "
                                         "one ahead"),
                                        ("slot", "the ring buffers written "
                                         "one slot ahead")))
            + " (each past a tolerance)")
        del model, want
        torch.cuda.empty_cache()

    # two reduced steps of each LM architecture on the card against the CPU
    worst = worst_g = 0.0
    lm_archs = [a for a in C.list_archs() if C.get_arch(a).family == "lm"]
    for arch in lm_archs:
        rcfg = C.get_arch(arch).make_reduced()

        def trainer(device):
            model = transformer.init_params(
                rcfg, generator=torch.Generator().manual_seed(0))
            return train.Trainer(model.to(device), functools.partial(
                transformer.loss_fn, rcfg))

        def loss_and_grads(tr, batch):
            loss, _ = tr.loss_fn(tr.model, batch)
            return loss.item(), dict(zip(tr.params, torch.autograd.grad(
                loss, list(tr.params.values()))))

        cpu, card = trainer("cpu"), trainer(dev)
        make = train.lm_batch_fn(rcfg, seed=0, batch=8, seq=64, device="cpu")
        for s in range(2):
            # the step in its two parts: the loss and gradients, then both
            # sides' AdamW update of the card's gradients
            batch = make(s)
            want, want_g = loss_and_grads(cpu, batch)
            got, got_g = loss_and_grads(card, {k: v.to(dev)
                                               for k, v in batch.items()})
            if not np.isclose(got, want, **STEP_TOL):
                fail(f"{arch} reduced: the card's loss {got} at step {s} "
                     f"against the CPU's {want}")
            for name, g in want_g.items():
                if not torch.allclose(got_g[name].cpu(), g, **STEP_TOL):
                    fail(f"{arch} reduced: the card's gradient of {name} at "
                         f"step {s} differs from the CPU's")
                worst_g = max(worst_g, float((got_g[name].cpu() - g).abs()
                                             .max()))
            for tr, grads in ((cpu, {n: g.cpu().clone() for n, g in got_g.items()}),
                              (card, got_g)):
                upd, tr.opt_state = tr.opt.update(grads, tr.opt_state,
                                                  tr.params)
                apply_updates(tr.params, upd)
        for name, p in cpu.params.items():
            q = card.params[name].detach().cpu()
            if not torch.allclose(q, p.detach(), **STEP_TOL):
                fail(f"{arch} reduced: {name} after 2 steps on the card "
                     f"differs from the CPU's")
            worst = max(worst, float((q - p.detach()).abs().max()))
    log(f"    2 reduced steps of {lm_archs} on the card equal the CPU's "
        f"(rtol {STEP_TOL['rtol']}, atol {STEP_TOL['atol']}: losses, each "
        f"step's gradients, max |grad diff| {worst_g:.3g}, and the "
        f"parameters after both sides' AdamW updates of the card's "
        f"gradients, max |param diff| {worst:.3g})")

    # bf16 on the card: matmul_f32's mixed-precision branch at the shapes of
    # the full-width qwen step, then qwen's reduced config in bf16 against
    # the CPU (f32 products of the same values)
    F, V = cfg.d_ff, cfg.padded_vocab
    G = cfg.n_heads // cfg.n_kv_heads
    qc, BKV = cfg.query_chunk, B * cfg.n_kv_heads
    ratios = {}
    for label, case in (
            ("q projection", ((B, S, D), (D, D), False)),
            ("MLP down", ((B * S, F), (F, D), False)),
            ("attention scores", ((BKV, G * qc, dh), (BKV, dh, S), False)),
            ("attention values", ((BKV, G * qc, S), (BKV, S, dh), False)),
            ("tied head", ((S // 2, D), (D, V), True))):
        errs = testing.matmul_f32_errors(*testing.matmul_inputs(*case, 23,
                                                                dev))
        if not max(errs.values()) <= 1:
            fail(f"matmul_f32's bf16 branch, {label} {case[:2]}: errors "
                 f"over their bounds {errs}")
        ratios[label] = max(errs.values())
        torch.cuda.empty_cache()
    rcfg = dataclasses.replace(C.get_arch("qwen1.5-0.5b").make_reduced(),
                               dtype=torch.bfloat16)
    cpu = transformer.init_params(rcfg,
                                  generator=torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, rcfg.vocab_size, (2, 96)).astype(np.int32))
    msg = testing.bf16_lm_mismatch(
        *testing.lm_outputs(rcfg, cpu.to(dev), toks.to(dev)),
        *testing.lm_outputs(rcfg, transformer.init_params(
            rcfg, generator=torch.Generator().manual_seed(1)), toks))
    if msg is not None:
        fail(f"qwen1.5-0.5b reduced in bf16 on the card against the CPU: "
             f"{msg}")
    log(f"    bf16 on the card: matmul_f32's result and gradients within "
        f"their bounds of f64 products of the same values (largest error "
        f"over bound: {', '.join(f'{k} {v:.3f}' for k, v in ratios.items())}"
        f"); qwen1.5-0.5b reduced in bf16, logits, loss and every gradient "
        f"leaf equal the CPU's (testing.bf16_lm_mismatch: logits "
        f"{testing.BF16_LOGITS_TOL:g} of the largest, loss rtol "
        f"{testing.BF16_LOSS_RTOL:g}, gradients {testing.BF16_GRAD_TOL:g} "
        f"of each leaf's largest); {time.perf_counter() - t0:.1f} s")


def check_lm_serving(dev, smi: str) -> dict:
    """Phase 24: the LM's next-token rows into Zen's JSD index at
    qwen1.5-0.5b's full width, after benchmarks/retrieval_e2e.py's
    ``jsd_lm_leg``: ``train_lm`` (JSD_LM_STEPS steps of ``lm_markov_batch``,
    B = 8, S = 64, lr 1e-3), JSD_N + JSD_Q Markov contexts of 32 tokens,
    their next-token rows at temperature 6 (152,064 wide, the padded
    columns exact zeros), ``build_index(metric="jsd", k=16)`` flat and IVF
    from explicit reference ids (nprobe max(8, C // 2)), ZenServer at
    re-rank 16, n = 10, 8 batches of 64 queries: recall@10 against an exact
    top-10 by ``kernels.ops.jsd_pdist`` (the jsd_pdist kernel), p50/p99,
    the peak device memory of a served batch, the launches of zen_topk,
    ivf_probe and jsd_pdist in each server's 8 batches (counted from 0
    after its warm-up; the exact re-rank is core/metrics.py's plain JSD,
    so the served path launches no jsd_pdist) and the exact top-10's
    jsd_pdist launches apart, LMDS's recall beside Zen's, and how
    concentrated the rows are. Gates: 24 corpus rows come back first from
    the flat server at JSD < 2e-3 (the reference's own check,
    tests/test_retrieval_e2e.py), served with Lwb, whose first stage has
    the identity that Zen's lacks (Zen's count is printed beside); every served
    answer equals the same server's on the search kernels' plain versions
    (phase 17's standard); jsd_pdist equals jsd_pdist_plain on K = D^2 on a
    64 x 1,024 slice of the rows (JSD_WIDE_KTOL_PER_SQRT_M x sqrt(m)).
    Returns the served batches' launches by kernel, and the exact
    top-10's jsd_pdist launches as ``jsd_pdist_truth``."""
    import torch
    from repro_torch import configs as C
    from repro_torch.core import make_reducer
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import ivf_probe as ip
    from repro_torch.kernels import jsd as jk
    from repro_torch.kernels import ops
    from repro_torch.kernels import zen_topk as zt
    from repro_torch.launch import serve
    from repro_torch.launch import train_lm
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = C.get_arch("qwen1.5-0.5b").make_config()
    m = cfg.padded_vocab
    log(f"[24] LM next-token rows into Zen's JSD index at full qwen width "
        f"({m:,}-wide rows); {smi}")
    t = time.perf_counter()
    _, model, losses = train_lm.train_lm(
        JSD_LM_STEPS, batch=JSD_LM_BATCH, seq=JSD_LM_SEQ, data="markov",
        cfg=cfg, device=dev)
    train_s = time.perf_counter() - t
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"the JSD leg's LM did not train: {losses}")
    t = time.perf_counter()
    toks = syn.lm_markov_batch(1, 0, JSD_N + JSD_Q, JSD_CTX, cfg.vocab_size,
                               device=dev)["tokens"]
    torch.cuda.synchronize()
    ctx_s = time.perf_counter() - t
    t = time.perf_counter()
    P = torch.cat([train_lm.next_token_distributions(
        cfg, model, toks[lo:lo + 512], temperature=JSD_TEMPERATURE)
        for lo in range(0, toks.shape[0], 512)])
    torch.cuda.synchronize()
    rows_s = time.perf_counter() - t
    del model
    torch.cuda.empty_cache()
    row_err = float((P.double().sum(1) - 1.0).abs().max())
    if not (P[:, cfg.vocab_size:] == 0).all():
        fail("a padded column of a next-token row is not exactly 0")
    corpus, queries = P[:JSD_N], P[JSD_N:]
    log(f"    train_lm: {JSD_LM_STEPS} steps of B = {JSD_LM_BATCH}, S = "
        f"{JSD_LM_SEQ} Markov tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {train_s:.1f} s; {JSD_N + JSD_Q:,} contexts of "
        f"{JSD_CTX} tokens {ctx_s:.1f} s; rows at temperature "
        f"{JSD_TEMPERATURE} {rows_s:.1f} s: {tuple(P.shape)} f32 "
        f"({P.numel() * 4 / 1e9:.2f} GB), largest |row sum - 1| "
        f"{row_err:.3g}, the {m - cfg.vocab_size} padded columns exact "
        f"zeros")

    # the kernel against its plain version at this width
    Xs, Ys = queries[:64].contiguous(), corpus[:1_024].contiguous()
    got, want = jk.jsd_pdist(Xs, Ys), jk.jsd_pdist_plain(Xs, Ys)
    k_err = float((got.double() ** 2 - want.double() ** 2).abs().max())
    k_tol = JSD_WIDE_KTOL_PER_SQRT_M * m**0.5
    if not (torch.isfinite(got).all() and k_err <= k_tol):
        fail(f"jsd_pdist differs from jsd_pdist_plain on 64 x 1,024 rows "
             f"{m:,} wide: max |K - K_plain| {k_err:.3g} (tolerance "
             f"{k_tol:.3g})")
    # the exact top-10 of every query, by the kernel
    truth = []
    jk.jsd_pdist.launches = 0
    for lo in range(0, JSD_Q, 64):
        d = ops.jsd_pdist(queries[lo:lo + 64], corpus)
        truth.append(torch.sort(d, dim=1, stable=True)[1][:, :JSD_NN])
    truth = torch.cat(truth)
    truth_launches = jk.jsd_pdist.launches
    if truth_launches == 0:
        fail("the JSD leg's exact top-10 never launched jsd_pdist")
    batches = [queries[lo:lo + 64] for lo in range(0, JSD_Q, 64)]
    # how concentrated the rows are: the entropy of each, and how many
    # corpus rows lie within JSD 0.02 of each of the first 24
    ent = -(corpus * torch.log2(torch.clamp_min(corpus, 1e-30))).sum(1)
    near = (ops.jsd_pdist(corpus[:24].contiguous(), corpus) < 0.02).sum(1)
    log(f"    jsd_pdist vs jsd_pdist_plain on 64 x 1,024 rows: max |K - "
        f"K_plain| {k_err:.3g} (tolerance {k_tol:.3g}); the exact top-"
        f"{JSD_NN} of {JSD_Q} queries over {JSD_N:,} rows by the kernel; "
        f"row entropy {float(ent.min()):.2f}-{float(ent.max()):.2f} bits "
        f"(median {float(ent.median()):.2f}), {int(torch.unique(corpus.argmax(1)).numel())}"
        f" distinct argmax tokens; corpus rows within JSD 0.02 of each of "
        f"the first 24: median {int(near.median()):,} of {JSD_N:,}")
    del ent

    ids = [int(i) for i in torch.randperm(
        JSD_N, generator=torch.Generator().manual_seed(3))[:JSD_K]]
    records, served = {}, {}
    counted = {"zen_topk": zt.zen_topk, "ivf_probe": ip.ivf_probe,
               "jsd_pdist": jk.jsd_pdist}
    for kind in ("flat", "ivf"):
        t = time.perf_counter()
        index = serve.build_index(corpus, JSD_K, metric="jsd", index=kind,
                                  pivot_ids=ids, device=dev,
                                  generator=torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        kw = ({"nprobe": max(8, index.ivf.n_clusters // 2)}
              if kind == "ivf" else {})
        server = serve.ZenServer(index, rerank_factor=JSD_RERANK, **kw)
        server.query(batches[0], JSD_NN)  # warm-up
        lat, recalls, peaks, answers = [], [], [], []
        for fn in counted.values():
            fn.launches = 0
        for q in batches:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            d, got_ids = server.query(q, JSD_NN)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
            peaks.append(torch.cuda.max_memory_allocated(dev) - base)
            if d.shape != (64, JSD_NN) or not torch.isfinite(d).all():
                fail(f"JSD {kind}: distances not finite of shape (64, "
                     f"{JSD_NN}): {tuple(d.shape)}")
            answers.append((d, got_ids))
        served[kind] = {name: fn.launches for name, fn in counted.items()}
        search = "zen_topk" if kind == "flat" else "ivf_probe"
        if served[kind][search] == 0:
            fail(f"JSD {kind}: the served batches never launched {search}")
        for i, q in enumerate(batches):
            recalls.append(serve.recall(answers[i][1],
                                        truth[64 * i:64 * (i + 1)]))
        with plain_dispatch():
            for (d, got_ids), q in zip(answers, batches):
                pd, pids = server.query(q, JSD_NN)
                msg = topk_mismatch(d, got_ids, pd, pids, rtol=RTOL,
                                    atol=RTOL)
                if msg is not None:
                    fail(f"JSD {kind}: the served answers differ from the "
                         f"kernels' plain versions': {msg}")
        # corpus rows queried back: Zen's first stage has no identity
        # (zen(x, x) = sqrt(2) x altitude), and among thousands of rows
        # within JSD 0.02 it misses some rows' own; Lwb's is 0, so its
        # server must return each row first, at the f32 roundoff of the
        # exact JSD (the reference's check)
        found = {}
        for mode in ("zen", "lwb"):
            d, self_ids = serve.ZenServer(
                index, mode=mode, rerank_factor=JSD_RERANK, **kw).query(
                    corpus[:24], JSD_NN)
            first = self_ids[:, 0].cpu() == torch.arange(24)
            found[mode] = (int(first.sum()), float(d[:, 0].abs().max()))
        if kind == "flat" and (found["lwb"][0] != 24
                               or found["lwb"][1] >= 2e-3):
            fail(f"JSD flat, Lwb: {24 - found['lwb'][0]} of 24 corpus rows "
                 f"do not come back first (largest first distance "
                 f"{found['lwb'][1]:.3g})")
        lat_ms = np.asarray(lat) * 1e3
        records[kind] = dict(recall=float(np.mean(recalls)))
        log(f"    {kind}: build_index {build_s:.2f} s"
            + (f" ({index.ivf.n_clusters} clusters, nprobe {kw['nprobe']})"
               if kind == "ivf" else "")
            + f"; {len(batches)} batches x 64: recall@{JSD_NN} "
            f"{np.mean(recalls):.4f} "
            f"(min batch {np.min(recalls):.4f}), p50 "
            f"{np.percentile(lat_ms, 50):.2f} ms, p99 "
            f"{np.percentile(lat_ms, 99):.2f} ms, peak device memory of a "
            f"batch {max(peaks) / 1e9:.3f} GB above the index; launches in "
            f"the {len(batches)} batches {served[kind]}; answers equal "
            f"the plain dispatch's; 24 corpus rows queried back come first "
            f"{found['lwb'][0]} times with Lwb (largest first distance "
            f"{found['lwb'][1]:.3g}), {found['zen'][0]} times with Zen "
            f"({found['zen'][1]:.3g})")
        del index, server
    # the served batches' launches: the flat server's zen_topk, the IVF
    # server's ivf_probe; the re-rank is core/metrics.py's plain jsd_pdist
    launches = {"zen_topk": served["flat"]["zen_topk"],
                "ivf_probe": served["ivf"]["ivf_probe"],
                "jsd_pdist": served["flat"]["jsd_pdist"]
                + served["ivf"]["jsd_pdist"],
                "jsd_pdist_truth": truth_launches}

    # the distance-only baseline on the same rows (coordinate baselines
    # cannot follow into the JSD space)
    r = make_reducer("lmds", JSD_K, metric="jsd").fit(
        corpus, generator=torch.Generator().manual_seed(4))

    def reduce(X):
        return torch.cat([r.transform(X[lo:lo + 16])
                          for lo in range(0, X.shape[0], 16)])

    red = reduce(corpus)
    pred = torch.cat([torch.sort(r.pdist(reduce(q), red), dim=1,
                                 stable=True)[1][:, :JSD_NN]
                      for q in batches])
    lmds = serve.recall(pred, truth)
    try:
        make_reducer("pca", JSD_K, metric="jsd").fit(corpus[:64])
        pca = "fits (unexpected)"
    except ValueError:
        pca = "refuses the JSD space, as the reference's"
    log(f"    LMDS (k = {JSD_K}) recall@{JSD_NN} {lmds:.4f} beside Zen's "
        f"{records['flat']['recall']:.4f} (flat) / "
        f"{records['ivf']['recall']:.4f} (IVF); PCA {pca}; the served "
        f"batches' launches zen_topk {launches['zen_topk']} (flat), "
        f"ivf_probe {launches['ivf_probe']} (IVF), jsd_pdist "
        f"{launches['jsd_pdist']}; the exact top-10's jsd_pdist "
        f"{truth_launches}; {time.perf_counter() - t0:.1f} s")
    return launches


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

    # -- 21. the trainer at full width ------------------------------------------
    del corpus, full_corpus, index, server, batches, small, queries, tr
    torch.cuda.empty_cache()
    check_trainer(torch.device("cuda"), smi)

    # -- 22. learned embeddings into Zen serving ---------------------------------
    check_learned_serving(torch.device("cuda"), smi)

    # -- 23. the LM trainer at full width -----------------------------------------
    check_lm_trainer(torch.device("cuda"), smi)

    # -- 24. LM next-token rows into Zen's JSD index ------------------------------
    lm_launches = check_lm_serving(torch.device("cuda"), smi)

    kernels = [dict(name="zen_topk", route="cuda",
                    source="src/repro_torch/kernels/csrc/zen_topk.cu",
                    replaces="src/repro/kernels/zen_topk.py:92",
                    launches=serve_launches, max_abs_err=max_err,
                    sharded_launches=sharded_launches["zen_topk"],
                    lm_jsd_launches=lm_launches["zen_topk"], **main_rec)]
    for kname, line, launches in (("ivf_probe", 94, ivf_launches),
                                  ("ivf_probe_pq", 296, pq_launches)):
        extra = ({"sharded_launches": sharded_launches[kname]}
                 if kname in sharded_launches else {})
        if kname in lm_launches:
            extra["lm_jsd_launches"] = lm_launches[kname]
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
            **({"lm_jsd_launches": lm_launches[kname],
                "lm_jsd_truth_launches": lm_launches["jsd_pdist_truth"]}
               if kname == "jsd_pdist" else {}),
            **dense_records[kname]))
    log(f"whole run {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
