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
                                     # of phase 8, phase 20 (on four
                                     # cards where there are four) and
                                     # phases 26-31 (on four
                                     # distinct cards)
    python3 chip_smoke.py --lm-mesh  # phases 1 and 26 alone (with
                                     # --sharded: on four cards)
    python3 chip_smoke.py --gnn-mesh # phases 1 and 27 alone (with
                                     # --sharded: on four cards)
    python3 chip_smoke.py --recsys-mesh    # phases 1 and 28 alone
    python3 chip_smoke.py --lm-serve-mesh  # phases 1 and 29 alone (each
                                           # with --sharded: four cards)
    python3 chip_smoke.py --dryrun   # phases 1 and 30 alone, 30 (c) on
                                     # qwen1.5-0.5b's train_4k
    python3 chip_smoke.py --multihost  # phases 1 and 31 alone (with
                                       # --sharded: on four cards)

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
 25. the GNN family in the trainer at published width: MACE (2 layers, C
     = 128, l_max 2, correlation 3, bf16, remat) through for_shape on the
     GNN cells one card holds, molecule (3,840 nodes, 8,192 edges, 128
     graphs), full_graph_sm (2,708 nodes, 10,556 edges, 1,433 features)
     and minibatch_lg (176,128 nodes, 172,032 edges, 602 features, per
     node), GNN_STEPS steps each on the cell's batch: ms a step (median of
     the last 8), nodes/s, the share of the bf16 peak (model_flops), peak
     device memory, a profiled step's busy share and top kernels; the
     loss falls on the repeated molecule batch; the same minibatch_lg
     step twice is the same bits; a full-width molecule run resumed from
     a checkpoint is the straight run's bits; 2 reduced f32 steps on the
     card against the CPU; full-width bf16 energies against an f64
     evaluation of the same parameters (GNN_BF16_TOL), and two planted
     faults past it; then the trained minibatch_lg model's node
     descriptors (176,128 x 128) into a flat build_index(k = 16), 8
     batches of 64 descriptor rows through ZenServer (re-rank 4, n = 10):
     recall@10 against an exact top-10, p50/p99, zen_topk launching once
     a batch, the answers equal the plain dispatch's, and Lwb serving
     each query row first.
 26. the LM trainer on a (data, model) mesh at published width
     (check_lm_mesh): granite-8b and qwen2-moe-a2.7b on make_host_mesh(1,
     4) (four logical shards of the card; four cards under --sharded)
     against the single device at a cut depth, qwen1.5-0.5b on 2 x 2 with
     --compress-grads and its restarts, granite-8b's plan with gradient
     accumulation beside the CLI's step; ms a step, tokens/s, bf16-peak
     share, peak GB a card, busy and cross-shard shares; qwen2-moe's
     tokens routed otherwise than on the single device held to their
     logit margins (C7).
 27. MACE on a (data, model) mesh at published width (check_gnn_mesh):
     minibatch_lg on make_host_mesh 1 x 4, 2 x 1 and 2 x 2 (four logical
     shards of the card) against the single device (energies against
     f64, losses, replicas, a rerun and a 1 x 4 restart the same bits),
     build_plan("mace", "minibatch_lg")'s step beside the CLI's; with
     --sharded on four cards, minibatch_lg the same bits as on four
     logical shards of card 0, and ogb_products (61.9M edges) through
     build_plan("mace", "ogb_products") on 1 x 4: ms a step, nodes/s,
     bf16-peak share, peak GB, busy and cross-shard shares, the edge and
     node sides apart, a rerun and a restart the same bits.
 28. the recsys family on a (data, model) mesh at published width
     (check_recsys_mesh): dlrm-rm2 and xDeepFM against the single device,
     the recsys plans (train, serve, retrieval) through build_plan.
 29. the LM's prefill and decode plans on a (data, model) mesh
     (check_lm_serve_mesh): gemma2-2b, qwen2-moe-a2.7b and
     granite-moe-3b-a800m (with --sharded also granite-8b and
     qwen1.5-0.5b) at published width through build_plan(arch, cell) on
     make_host_mesh(2, 2), one placed set of weights an architecture:
     prefill_32k (S = 32,768, B = 2 on one card, 8 on four), decode_32k
     (B = 128 where the cache fits, else the largest even batch; the
     cache drawn shard by shard; an MoE decode's slot hand-offs between
     the data replicas and its dropped assignments) and long_500k where
     the plan runs it (gemma2-2b: B = 1, the sequence over all four
     positions), 16 steps each: ms beside the bytes bound, peak GB a
     card, the bf16-peak share of the prefill; the single device's
     readings at published depth in bf16 (on one card the depth cut,
     alone); a prompt and 16 steps held to the single device, rerun the
     same bits; the comparisons with the single device (prefill rows
     0-1, an MoE prefill's on the mesh's experts beside C7's check of
     the tokens routed otherwise; decode rows 0-7, an MoE decode's every
     row at the cell's B; long_500k against 1 x 1) gated at 2 layers in
     f32, with a planted fault that must read past the gate.
 30. the dry-run against the card (check_dryrun): qwen1.5-0.5b's
     train_4k (2 layers, B = 8), dlrm-rm2's train_batch (B = 8,192) and
     MACE's molecule through build_plan on make_host_mesh(2, 2), each
     run on the card under FlopCounterMode and the collective recorder,
     then traced on fake shards of a 2 x 2 placeholder mesh: FLOPs,
     collectives and output bytes equal exactly, argument_bytes against
     the allocator's growth on placement; gemma2-2b and
     granite-moe-3b-a800m at published width and 2 layers on 1 x 16
     logical shards (heads that do not split: attention re-laid out over
     the sequence), a prefill's logits and a step's loss against the
     single device within bf16_lm_mismatch; the dry-run CLI on a
     production cell in a subprocess, its wall time and record;
 31. the trainer's mesh over two processes (--multihost: ``python -m
     torch.distributed.run --nproc-per-node 2`` started by this script,
     each worker writing its results to a file): on one card two
     processes of two logical shards over gloo, qwen1.5-0.5b at
     published width and 2 layers, B = 2, S = 2,048, on 1 x 4 and on 2 x
     2 with --compress-grads; on four cards (--sharded) two processes of
     two cards over NCCL, granite-8b at 36 layers, B = 8, S = 4,096 on 1
     x 4, then twice with a seeded random delay in one card's backward,
     and a checkpoint leg both ways. Every run 3 steps, its losses and an
     integer fingerprint of every leaf a position equal to the
     one-process run's; ms a step and tokens/s beside it, peaks, and the
     share of a step in the mesh.* ranges.

Phases 7, 11 and 14 run right after phase 3 (so ``--quick`` covers every
kernel); phases 17-20 run after phase 12, phases 21-31 last. Phase 3
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
import shutil
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
#: phase 25: the GNN cells one card holds (ogb_products, 2,449,029 nodes
#: and 61,859,140 edges, keeps over 55 GB a layer on the node side alone:
#: the multi-card trainer's, ROADMAP A, item 3) and the steps of each, all
#: on the cell's one batch (the median of the last 8 is the step time)
GNN_CELLS_ON_CARD, GNN_STEPS = ("molecule", "full_graph_sm",
                                "minibatch_lg"), 12
#: phase 25: full-width bf16 energies against an f64 evaluation of the
#: same parameters and graphs: the mean over energies of |diff| / (|f64| +
#: the median |f64|) (testing.energy_errors; at C = 128 the energies of
#: random weights are heavy-tailed, the B-basis cubing A: 4,295 the
#: largest of molecule's graphs, 1.87 the median). Readings on the card
#: (molecule, minibatch_lg): bf16 0.0045 and 0.0034; messages sent from
#: receiver to sender 1.56 and 0.57; the nu = 3 correlation dropped 0.22
#: and 0.020. The limit sits between (the CPU tests' reduced config,
#: compiled reference included, holds testing.BF16_ENERGY_TOL, 2^-6).
GNN_BF16_TOL = 0.01
#: phase 25: the descriptor leg: queries (8 batches of 64 descriptor rows),
#: k, the re-rank factor and n
GNN_Q, GNN_K, GNN_RERANK, GNN_NN = 512, 16, 4, 10
#: phase 26: the LM trainer on a (data, model) mesh at published width. The
#: one-card run puts 4 logical shards on the card and cuts the depth to
#: what one card holds twice (the sharded run beside the single-device one)
#: and the smoke run's time limit: granite-8b 2 of 36 layers at B = 4,
#: qwen2-moe-a2.7b 2 of 24 at B = 2; --sharded on four cards runs
#: granite-8b at 36 layers, B = 8 and qwen2-moe-a2.7b at 24, B = 4 (the
#: train_4k cell's global batch is 256: a pod's). S is the cell's 4,096;
#: each run takes MESH_STEPS steps, the step time the median of the last 4;
#: a second sharded run takes MESH_AGAIN steps, which must be the first
#: run's bits.
MESH_STEPS, MESH_AGAIN, MESH_SEQ = 5, 3, 4_096
#: phase 26: on four cards every run takes step 0's batch at every step
#: (``--fixed-batch``), and its loss must fall on data the model has
#: seen. On fresh i.i.d. uniform tokens there is nothing to learn past the
#: uniform distribution, and five steps at published width read as noise
#: (granite-8b at 36 layers on four cards, warmed up over 100 steps:
#: 11.1838, 11.1850, 11.1813, 11.1898, 11.1841). The one-card legs keep
#: fresh batches: there the single device's trajectory is the check (a
#: memorised batch's loss falls to ~1 in four steps, where two bf16
#: trajectories part by more than the loss rtol).
MESH_LEGS = {False: {"granite-8b": (2, 4), "qwen2-moe-a2.7b": (2, 2)},
             True: {"granite-8b": (36, 8), "qwen2-moe-a2.7b": (24, 4)}}
#: phase 26 (c): qwen1.5-0.5b at full width and depth with
#: --compress-grads: MESH_QWEN_ROWS sequences a data replica (B = 2 on 2 x
#: 2, 4 on 4 x 1; one card holds the f32 logits over the 152,064-row
#: vocabulary and both replicas' error buffers beside four shards)
MESH_QWEN_ROWS = 1
#: phase 26 (c): qwen1.5-0.5b's depth (None: its published 24 layers). One
#: card runs a cut (the smoke run's time limit: at 24 layers, its step-3
#: checkpoint of weights, moments and error buffers written and read back
#: twice, (c) was the phase's longest part)
MESH_QWEN_LAYERS = {False: 4, True: None}
#: phase 26 (b): the share of step 0's expert assignments of the sharded
#: run that equal the single-device run's, layer by layer. The routers see
#: the same function of the weights but not the same bits: the row-
#: parallel products (wo, the shared experts' down projection) sum four
#: f32 partials where the single device takes one product, and an input
#: that rounds to the other bf16 neighbour can flip a near-tie among the
#: top-k of a random router's close probabilities. On the card
#: (qwen2-moe-a2.7b, 2 layers, B = 2) layer 0 read 1.000000 and layer 1
#: 0.996735 (107 of 32,768 assignments); a router that ranked only a
#: shard's own 16 experts would agree on well under half. Each model
#: shard's assignments must equal every other shard's exactly (each routes
#: with the whole router, gathered).
MOE_ROUTE_AGREE = 0.99
#: phase 27: MACE on a (data, model) mesh. One card: minibatch_lg on four
#: logical shards as GNN_MESH_SHAPES against the single device,
#: GNN_MESH_STEPS steps each on the cell's one batch (the step time the
#: median of the last 2). At each step's parameters the mesh's energies
#: are held to an f64 evaluation (GNN_BF16_TOL, the mean of
#: testing.energy_errors) and its loss to the single device's bf16 loss
#: (GNN_MESH_LOSS_RTOL), the f64 loss logged beside both. At C = 128
#: random weights give losses of ~3e7 that the largest energies (~1e6)
#: carry, and those are off f64 by several percent in bf16 on the mesh
#: and on one device alike, while the energies' mean error stays ~0.003:
#: on an H100 the two bf16 losses read up to 3.56% apart at the same
#: parameters (step 1 on 1 x 4). The loss bound, 2^-3, was set after that
#: reading.
#: Free-running trajectories part further (AdamW moves every element by
#: ~lr whatever its gradient's size), so the steps are compared at the
#: same parameters
GNN_MESH_STEPS, GNN_MESH_SHAPES = 4, ((1, 4), (2, 1), (2, 2))
GNN_MESH_LOSS_RTOL = 2**-3
#: phase 27 on four cards: ogb_products' steps on its one batch (the step
#: time the median of the last 2; a checkpoint after step 3) and the edge
#: chunk counts tried in order: the reference plan's 16, then 32 and 64
#: when a card runs out of memory
OGB_STEPS, OGB_CHUNKS = 5, (16, 32, 64)
#: phase 28: the recsys family on a (data, model) mesh at published width.
#: One card (four logical shards): each mesh's step 0 against the single
#: device's at the same parameters, then RECSYS_TIMED steps timed (the
#: median is the step time). Four cards: RECSYS_STEPS steps a leg (the
#: median of the last RECSYS_STEPS - 2). Step 0's loss within
#: RECSYS_LOSS_RTOL of the single device's (f32 sums in another order);
#: gradients within RECSYS_GRAD_TOL of their leaf's largest |g|, and an
#: updated element whose single-device gradient is within
#: RECSYS_GRAD_FLOOR of zero within 2 lr (tests/test_torch_sharded_recsys.py's
#: tolerances)
RECSYS_TIMED, RECSYS_STEPS = 3, 6
RECSYS_LOSS_RTOL, RECSYS_GRAD_TOL, RECSYS_GRAD_FLOOR = 1e-5, 1e-4, 1e-6
#: phase 29: the LM's prefill and decode plans on a (data, model) mesh,
#: SERVE_ARCHS at published width on 2 x 2 (four cards, or four logical
#: shards of one). prefill_32k at S = 32,768 and SERVE_PREFILL_B rows a
#: call (one card, four cards; the cell's global batch of 32 cut for the
#: phase's time: each row is independent, an MoE row holding whole groups
#: of 4,096, no shape of a row changes), and SERVE_PREFILL_BIG too on four
#: cards when that took under SERVE_BIG_S; decode_32k at the cell's B =
#: 128, or the largest even batch whose cache fits with SERVE_MARGIN bytes
#: left free a card, from cache_len SERVE_DECODE_LEN, a dense model's rows
#: 0..SERVE_REF_ROWS - 1 against the single device (an MoE model's every
#: row: its group is the batch); long_500k (B = 1) from SERVE_LONG_LEN
#: where the plan runs it; SERVE_STEPS steps each; the chain: a
#: SERVE_CHAIN_PROMPT-token prompt of SERVE_CHAIN_B rows padded to
#: SERVE_CHAIN_PAD (an MoE model's SERVE_MOE_CHAIN_PROMPT and
#: SERVE_MOE_CHAIN_PAD: a data replica's prompt holds whole MoE groups),
#: then SERVE_STEPS steps. The cache is drawn a (leaf, layer group, row,
#: 1 / SERVE_UNITS of the sequence) at a time, the finest split of the
#: phase's meshes, so a shard's block and the single device's rows hold
#: the same values.
SERVE_MESH = (2, 2)
SERVE_ARCHS = {False: ("gemma2-2b", "qwen2-moe-a2.7b",
                       "granite-moe-3b-a800m"),
               True: ("qwen2-moe-a2.7b", "granite-moe-3b-a800m", "granite-8b",
                      "qwen1.5-0.5b", "gemma2-2b")}
SERVE_PREFILL_B = {False: 2, True: 8}
SERVE_PREFILL_BIG, SERVE_BIG_S = 32, 20.0
SERVE_STEPS, SERVE_REF_ROWS, SERVE_UNITS = 16, 8, 4
#: phase 29 on one card (the stand-in for four): the bf16 cells run at
#: this depth of each architecture's layers (the smoke run's time limit:
#: gemma2-2b's 26 layers took 97.9 s of a 1,114 s run; with the MoE
#: architectures beside it, the phase took 103.7 s at 8, 4 and 4 layers in
#: a 1,107 s run), without the single
#: device beside them (its comparisons, the chain's rerun and the planted
#: fault run at SERVE_CHECK_LAYERS)
SERVE_ONE_CARD_LAYERS = {"gemma2-2b": 4, "qwen2-moe-a2.7b": 3,
                         "granite-moe-3b-a800m": 3}
SERVE_DECODE_LEN, SERVE_LONG_LEN = 32_752, 524_272
SERVE_CHAIN_PROMPT, SERVE_CHAIN_PAD, SERVE_CHAIN_B = 6_000, 6_016, 2
SERVE_MOE_CHAIN_PROMPT, SERVE_MOE_CHAIN_PAD = 4_096, 4_112
#: phase 29: the gated MoE decode's cache length (the cell's 32,768 cut):
#: its group is the whole batch, so the single device beside the mesh
#: decodes all B rows and holds their cache whole, with copies of a
#: layer's keys and values; at this length both hold the cell's B = 128
SERVE_MOE_GATE_SEQ = 4_096
#: phase 29: DECODE_TOL's bf16 bounds were read on this architecture's
#: decode against its forward (phase 23): its chain is held to them in
#: bf16 too; the other architectures' bf16 chains are logged (each is
#: gated in f32 at SERVE_CHECK_LAYERS)
SERVE_BF16_CHAIN = "gemma2-2b"
SERVE_MARGIN = 6e9
#: phase 29: the comparisons with the single device are gated on a cut of
#: the model to SERVE_CHECK_LAYERS (gemma2-2b's one local and one global
#: layer: both caches) in f32, where the mesh and the single device differ
#: by f32 roundings alone: every compared tensor within ``testing.
#: bf16_lm_mismatch``'s bounds and DECODE_TOL's f32 bounds (max 0.05, mean
#: 0.005: phase 23's for gemma's decode against forward in f32), and a
#: planted fault (long_500k's steps at a position one ahead; decode_32k's
#: where the plan skips long_500k) must read past them. An MoE decode runs
#: there at the cell's B = 128 over SERVE_MOE_GATE_SEQ positions: its group
#: is the batch's 128 tokens, every expert's capacity max(8, ceil(128 top_k
#: / padded experts x 1.25)) rounded up to 8 (qwen2-moe 16 against ~8.5
#: assignments an expert a step, granite-moe 32 against ~25.6), and some
#: assignments drop (in bf16 at 4 layers and B = 58, qwen2-moe dropped 84
#: of 14,848 over 16 steps). An MoE prefill's single device takes the
#: mesh's experts (``testing.routed_as``): in f32 at 2 layers 1-2 of a
#: row's 32,768 tokens route otherwise a layer, each a near-tie within 1e-6
#: (C7's check, logged). In bf16 no change of summation order holds
#: ``bf16_lm_mismatch``'s max (2^-7 of the largest |logit|, 0.234 at 30) at
#: published width: the single device's own decode against its forward
#: reads max 1.0231 (phase 23); the mesh against the single device read max
#: 0.886-1.285, mean 0.0747-0.0880 at 26 layers and, at 2 layers, max
#: 0.1117 (prefill), 0.1849 (long_500k) and 0.2461 (decode_32k, the max
#: over 32.8 million logits), mean 0.0085-0.0115 (NVIDIA H100 80GB HBM3,
#: 700 W, one card as four logical shards). The bf16 readings at 26 layers
#: are logged (the reference's own decode spreads from its forward as far:
#: C11, tools/c11_decode_spread.py); the chain is held to forward at 26
#: layers in bf16 by DECODE_TOL.
SERVE_CHECK_LAYERS = 2
#: phase 29: DECODE_TOL's bounds hold a tensor whose largest |value| is
#: this (gemma2-2b's logit softcap, where they were read) or more; one of
#: smaller values is held to them scaled by its largest |value| over this.
#: At 2 layers in f32 granite-8b's logits reach 5.3: its planted fault
#: (positions one ahead) read max 0.00997, mean 0.00149 on four H100s,
#: past the scaled bounds (0.0088, 0.00088) and within the unscaled ones,
#: the mesh against the single device 4.8e-06 and 6.9e-07
SERVE_TOL_SCALE = 30.0
#: phase 30 (a): the dry-run held to the card on 2 x 2. The plans run at
#: published width with their cells cut to what the phase's time allows:
#: qwen1.5-0.5b's train_4k at DRYRUN_LM_LAYERS layers and a global batch
#: of DRYRUN_LM_BATCH (S = 4,096), dlrm-rm2's train_batch at
#: DRYRUN_RECSYS_BATCH (its 8.64 GB table whole), MACE's molecule as
#: published. The allocator's growth on placement must be argument_bytes
#: within its rounding: DRYRUN_ROUND a tensor, and a tensor of DRYRUN_LARGE
#: bytes or more may keep up to DRYRUN_LARGE of its block's remainder
#: unsplit (measured: 12.6 MB over qwen's 3.63 GB of shards, 5.9 MB over
#: dlrm-rm2's 51.9 GB); the bytes it was asked for are logged beside.
DRYRUN_LM_LAYERS, DRYRUN_LM_BATCH, DRYRUN_RECSYS_BATCH = 2, 8, 8_192
DRYRUN_ROUND, DRYRUN_LARGE = 512, 1 << 20
#: phase 30 (b): the head repair at published width, DRYRUN_HEADS_LAYERS
#: layers, on a 1 x DRYRUN_HEADS_M mesh of one card's logical shards
#: (gemma2-2b's 8 heads and granite-moe-3b-a800m's 24 do not split over
#: 16): a prefill of DRYRUN_HEADS_B x DRYRUN_HEADS_S tokens and a train
#: step on one row of them against the single device
DRYRUN_HEADS_LAYERS, DRYRUN_HEADS_M = 2, 16
DRYRUN_HEADS_B, DRYRUN_HEADS_S = 2, 4_096
#: phase 30 (c): the production cell traced in a subprocess: in the whole
#: run a cheap one (the run's time limit), under --dryrun qwen1.5-0.5b's
#: train_4k on the 16 x 16 mesh
DRYRUN_CELL = {False: ("dlrm-rm2", "retrieval_cand"),
               True: ("qwen1.5-0.5b", "train_4k")}

#: phase 31: the trainer's mesh over two processes (--multihost), each
#: started by ``python -m torch.distributed.run --nproc-per-node 2``. One
#: card: two processes of two logical shards each over gloo, MH_ONE_CARD's
#: LM at published width, MH_ONE_LAYERS layers, B x S = MH_ONE_BATCH x
#: MH_ONE_SEQ, on each of MH_ONE_LEGS ((data, model), --compress-grads);
#: four cards (--sharded): two processes of two cards over NCCL, MH_FOUR's
#: LM at MH_FOUR_LAYERS layers (phase 26's four-card leg), B x S =
#: MH_FOUR_BATCH x MH_FOUR_SEQ on 1 x 4, then MH_DELAY_RUNS reruns with a
#: seeded random delay (up to MH_DELAY_MS a hit, host and card) in one
#: card's backward; and the checkpoint leg (MH_ONE_CARD at MH_ONE_LAYERS
#: layers, MH_CKPT_BATCH x MH_ONE_SEQ on 1 x 4) both ways. Every run is
#: MH_STEPS steps, held to the one-process run of the same phase: every
#: loss, and an exact integer fingerprint of every leaf's bytes a
#: position, computed on its card. A spawn's wall limit is MH_WALL_S.
MH_ONE_CARD, MH_ONE_LAYERS, MH_ONE_BATCH, MH_ONE_SEQ = \
    "qwen1.5-0.5b", 2, 2, 2_048
MH_ONE_LEGS = (((1, 4), False), ((2, 2), True))
MH_FOUR, MH_FOUR_LAYERS, MH_FOUR_BATCH, MH_FOUR_SEQ = \
    "granite-8b", 36, 8, 4_096
MH_DELAY_RUNS, MH_DELAY_MS, MH_CKPT_BATCH = 2, 20.0, 2
MH_STEPS, MH_WALL_S = 3, 900
#: where the phase's runs train (a CPU rehearsal sets "cpu")
MH_DEVICE = "cuda"


#: the run's start: each phase's header line carries the seconds since
_T0 = time.perf_counter()


def log(*a):
    if a and isinstance(a[0], str) and a[0][:1] == "[" and \
            a[0][1:2].isdigit():
        a = (*a, f"(t = {time.perf_counter() - _T0:.0f} s)")
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


def profile_device(fn, label: str, top: int = 8, ops: int = 0):
    """Device time by kernel of ``fn()`` (torch.profiler), and the
    device's busy share of the wall time; with ``ops``, also the device
    time of the ``ops`` operators (``aten::mul``, ...) that launch the
    most; returns ((device us, count, kernel name) rows, busy us)."""
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
    if ops:
        by_op = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and e.self_device_time_total > 0), reverse=True)
        log("      by operator: " + "; ".join(
            f"{key} {us / max(busy, 1e-9):.1%} (x{count})"
            for us, count, key in by_op[:ops]))
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


def gnn_cell_batch(cell, seed: int, dev) -> dict:
    """A GNN cell's batch: ``geometric_graph_batch`` at the cell's nodes,
    edges (as the cell gives them; ``pad_edges`` only shards), features
    and graphs, per node on the node-level cells, with ``n_graphs`` and
    ``node_level``, on ``dev``."""
    from repro_torch.configs.base import NODE_LEVEL_CELLS
    from repro_torch.data import synthetic as syn

    d = cell.dims
    node_level = cell.shape in NODE_LEVEL_CELLS
    return dict(syn.geometric_graph_batch(
        seed, d["n_nodes"], d["n_edges"], d["d_feat"], n_graphs=d["n_graphs"],
        node_level=node_level, device=dev), n_graphs=d["n_graphs"],
        node_level=node_level)


def check_gnn_trainer(dev, smi: str) -> dict:
    """Phase 25: the GNN family in ``repro_torch.launch.train`` at
    published width, and its node descriptors served through Zen.

    MACE's published config (``configs.mace.make_config``: 2 layers, C =
    128, l_max 2, correlation 3, n_rbf 8, r_cut 5, radial 64, readout 16,
    bf16, remat), bound to each cell's feature width (``for_shape``),
    takes GNN_STEPS steps of ``train.mace_trainer`` on each cell of
    GNN_CELLS_ON_CARD, on the cell's one batch (``gnn_cell_batch``; its
    node-side shapes and static entries the cell's input specs): ms a step
    (median of the last 8), nodes/s, the share of the bf16 peak
    (``launch.model_flops.estimate`` over 989 TFLOP/s), peak device
    memory, and one more step profiled (at minibatch_lg also a
    no-gradient forward, and its layers' edge passes and node sides,
    timed apart with CUDA events). Gates: losses finite, and falling
    on the repeated molecule batch; minibatch_lg's loss and gradients
    twice from the same parameters, the same bits; a molecule run at
    published width (a fresh batch a step) resumed from a checkpoint of
    step 3, steps 3-5 the straight run's losses and parameter bytes; 2
    reduced f32 steps on the card against the CPU (STEP_TOL); the bf16
    energies of fresh full-width weights on the molecule and minibatch_lg
    batches within GNN_BF16_TOL of an f64 evaluation of the same
    parameters (``testing.energy_errors``' mean), and two planted faults
    past it (messages sent from receiver to sender; the nu = 3
    correlation dropped, w_corr3 = 0).
    Last, ``node_descriptors`` of the trained minibatch_lg model (176,128 x
    128 f32) into a flat ``build_index`` (k = GNN_K), GNN_Q descriptor rows
    in batches of 64 through ``ZenServer`` (re-rank GNN_RERANK, n =
    GNN_NN): recall@10 against an exact top-10, p50/p99, zen_topk's
    launches in those batches (one a batch), the answers equal the plain
    dispatch's, and Lwb serving each query row first. Returns the served
    batches' zen_topk launches."""
    import dataclasses
    import functools
    import tempfile

    import torch
    from repro_torch import configs as C
    from repro_torch import testing
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import mace as mace_cfg
    from repro_torch.kernels import zen_topk as zt
    from repro_torch.launch import model_flops, serve, train
    from repro_torch.models import mace
    from repro_torch.optim import apply_updates
    from repro_torch.testing import topk_mismatch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = C.get_arch("mace")
    base = spec.make_config()
    held = torch.cuda.memory_allocated(dev)
    log(f"[25] the GNN family in the trainer at published width (MACE: "
        f"{base.n_layers} layers, C = {base.channels}, l_max {base.l_max}, "
        f"correlation {base.correlation}, n_rbf {base.n_rbf}, r_cut "
        f"{base.r_cut}, radial {base.radial_hidden}, readout "
        f"{base.readout_hidden}, {str(base.dtype)[6:]}, remat "
        f"{base.remat}); {smi}; earlier phases hold {held / 1e9:.2f} GB")
    batches = {}
    for shape in GNN_CELLS_ON_CARD:
        cell = spec.cell(shape)
        cfg = mace_cfg.for_shape(base, cell.dims["d_feat"])
        t = time.perf_counter()
        batch = gnn_cell_batch(cell, 0, dev)
        make_s = time.perf_counter() - t
        specs = C.input_specs(spec, cfg, cell)
        for k, v in specs["batch"].items():
            want = ((cell.dims["n_edges"],) if k in (
                "senders", "receivers", "edge_mask") else v.shape)
            if tuple(batch[k].shape) != want or batch[k].dtype != v.dtype:
                fail(f"mace {shape}: batch {k} {tuple(batch[k].shape)} "
                     f"{batch[k].dtype}, not {want} {v.dtype}")
        if {k: batch[k] for k in specs["static"]} != specs["static"]:
            fail(f"mace {shape}: static entries are not {specs['static']}")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tr = train.mace_trainer(cfg, seed=0, device=dev)
        losses, step_s = [], []
        for _ in range(GNN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(tr.step(batch)[0].item())
            step_s.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        if not np.isfinite(losses).all():
            fail(f"mace {shape}: losses {losses}")
        if shape == "molecule" and not losses[-1] < losses[0]:
            fail(f"mace molecule: the loss did not fall over {GNN_STEPS} "
                 f"steps on one batch: {losses}")
        ms = float(np.median(step_s[-8:])) * 1e3
        n_nodes = cell.dims["n_nodes"]
        flops = model_flops.estimate("mace", shape, cfg)["model_flops_global"]
        log(f"    {shape} ({n_nodes:,} nodes, {cell.dims['n_edges']:,} edges"
            f", d_feat {cfg.d_feat:,}, {cell.dims['n_graphs']} graphs, "
            f"{'per node' if batch['node_level'] else 'per graph'}; "
            f"{sum(p.numel() for p in tr.params.values()):,} parameters; the "
            f"batch made in {make_s:.2f} s): {ms:.2f} ms a step (median of "
            f"the last 8; every step "
            f"{np.round(np.asarray(step_s) * 1e3, 1).tolist()} ms), "
            f"{n_nodes / ms * 1e3:,.0f} nodes/s; model FLOPs "
            f"{flops / 1e12:.3f} T a step = "
            f"{flops / (ms / 1e3) / PEAK_BF16_FLOPS:.2%} of the bf16 peak; "
            f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak device memory "
            f"{peak / 1e9:.2f} GB ({(peak - before) / 1e9:.2f} GB above the "
            f"batch and earlier phases)")
        if shape == "minibatch_lg":
            # the same step twice from the same parameters: the same bits
            def loss_and_grads():
                loss, _ = tr.loss_fn(tr.model, batch)
                return [loss.detach()] + list(torch.autograd.grad(
                    loss, list(tr.params.values()), materialize_grads=True))

            first, again = loss_and_grads(), loss_and_grads()
            bad = [n for n, a, b in zip(["loss", *tr.params], first, again)
                   if not torch.equal(a, b)]
            if bad:
                fail(f"mace minibatch_lg: the same step twice differs in "
                     f"{bad}")
            log(f"    minibatch_lg: the loss and all {len(tr.params)} "
                f"gradient leaves of the same step twice, the same bits")
            del first, again
        profile_device(lambda: tr.step(batch), f"one mace {shape} step",
                       top=6, ops=12)
        if shape == "minibatch_lg":
            # where a forward's device time goes: each layer's edge pass
            # (radial weights, gathers, the 12 paths, the segment sums)
            # and node side (B-basis, channel mixes, update, readout)
            edges = mace._edges(cfg, batch, 1)
            h = mace._embed(cfg, tr.model, batch)
            edge_ms = layer_ms = 0.0
            with torch.no_grad():
                for layer in tr.model.layers:
                    args = (cfg, layer, *h[:3], edges)
                    edge_ms += timed(lambda: mace._edge_pass(
                        *args, n_nodes), 3, 1)
                    layer_ms += timed(lambda: mace._one_layer(
                        *args, h[3]), 3, 1)
                    h = (*mace._one_layer(*args, h[3])[:3], h[3])
                fwd_ms = timed(lambda: mace.forward(cfg, tr.model, batch),
                               3, 1)
            del edges, h
            node_ms = layer_ms - edge_ms
            log(f"    minibatch_lg forward (no gradient, CUDA events): "
                f"{fwd_ms:.1f} ms = {fwd_ms / ms:.1%} of a step; the 2 "
                f"layers' edge passes {edge_ms:.1f} ms, their node sides "
                f"{node_ms:.1f} ms")
        batches[shape] = batch
        if shape == "minibatch_lg":
            trained = cfg, tr
        del tr
        torch.cuda.empty_cache()

    # a resumed run at published width is the straight run's bits
    cell = spec.cell("molecule")
    cfg = mace_cfg.for_shape(base, cell.dims["d_feat"])
    tr = train.mace_trainer(cfg, seed=0, device=dev)

    def steps(start):
        return [tr.step(gnn_cell_batch(cell, s, dev))[0].item()
                for s in range(start, start + 3)]

    steps(0)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save_async(3, tr.state_tree())
        mgr.wait()
        after = steps(3)
        want = {n: p.detach().clone() for n, p in tr.params.items()}
        step, tree = mgr.restore(like=tr.state_tree())
        tr.load_state_tree(tree)
    if step != 3:
        fail(f"restored step {step}, not 3")
    again = steps(3)
    bad = [n for n, p in tr.params.items() if not torch.equal(p, want[n])]
    if again != after or bad:
        fail(f"the resumed molecule run differs from the straight one: "
             f"losses {again} against {after}, parameters {bad}")
    log(f"    restart at published width (molecule, a fresh batch a "
        f"step): steps 3-5 after a restore of step 3 equal the straight "
        f"run's, losses {after} and every parameter byte")
    del tr, want

    # two reduced f32 steps on the card against the CPU
    rcfg = spec.make_reduced()

    def reduced(device):
        model = mace.init_params(rcfg, generator=torch.Generator()
                                 .manual_seed(0))
        return train.Trainer(model.to(device),
                             functools.partial(mace.loss_fn, rcfg))

    def loss_and_grads(tr, batch):
        loss, _ = tr.loss_fn(tr.model, batch)
        return loss.item(), dict(zip(tr.params, torch.autograd.grad(
            loss, list(tr.params.values()), materialize_grads=True)))

    cpu, card = reduced("cpu"), reduced(dev)
    make = train.gnn_batch_fn(rcfg, seed=0, batch=16, device="cpu")
    worst = worst_g = 0.0
    for s in range(2):
        batch = make(s)
        want, want_g = loss_and_grads(cpu, batch)
        got, got_g = loss_and_grads(card, {
            k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()})
        if not np.isclose(got, want, **STEP_TOL):
            fail(f"mace reduced: the card's loss {got} at step {s} against "
                 f"the CPU's {want}")
        for name, g in want_g.items():
            if not torch.allclose(got_g[name].cpu(), g, **STEP_TOL):
                fail(f"mace reduced: the card's gradient of {name} at step "
                     f"{s} differs from the CPU's")
            worst_g = max(worst_g, float((got_g[name].cpu() - g).abs()
                                         .max()))
        for tr, grads in ((cpu, {n: g.cpu().clone()
                                 for n, g in got_g.items()}),
                          (card, got_g)):
            upd, tr.opt_state = tr.opt.update(grads, tr.opt_state,
                                              tr.params)
            apply_updates(tr.params, upd)
    for name, p in cpu.params.items():
        q = card.params[name].detach().cpu()
        if not torch.allclose(q, p.detach(), **STEP_TOL):
            fail(f"mace reduced: {name} after 2 steps on the card differs "
                 f"from the CPU's")
        worst = max(worst, float((q - p.detach()).abs().max()))
    log(f"    2 reduced f32 steps on the card equal the CPU's (rtol "
        f"{STEP_TOL['rtol']}, atol {STEP_TOL['atol']}: losses, gradients "
        f"max |diff| {worst_g:.3g}, parameters after both sides' AdamW "
        f"updates max |diff| {worst:.3g})")
    del cpu, card

    # bf16 at published width against f64 of the same parameters, and two
    # planted faults the check must see
    for shape in ("molecule", "minibatch_lg"):
        cfg16 = mace_cfg.for_shape(base, spec.cell(shape).dims["d_feat"])
        model = mace.init_params(cfg16, generator=torch.Generator(
            device=dev).manual_seed(25))
        cfg64 = dataclasses.replace(cfg16, dtype=torch.float64, remat=False)
        m64 = mace.MACE(cfg64, device=dev)
        m64.load_state_dict({k: v.double()
                             for k, v in model.state_dict().items()})
        batch = batches[shape]
        with torch.no_grad():
            want = mace.forward(cfg64, m64, batch)
            del m64
            readings = {"sound": testing.energy_errors(
                mace.forward(cfg16, model, batch), want)}
            readings["messages reversed"] = testing.energy_errors(
                mace.forward(cfg16, model, dict(
                    batch, senders=batch["receivers"],
                    receivers=batch["senders"])), want)
            for layer in model.layers:
                layer.w_corr3.zero_()
            readings["nu = 3 dropped"] = testing.energy_errors(
                mace.forward(cfg16, model, batch), want)
        log(f"    {shape}: bf16 energies ({tuple(want.shape)}, |energy| "
            f"largest {float(want.abs().max()):.4g}, median "
            f"{float(want.abs().median()):.4g}) against f64 of the same "
            f"parameters, |diff| / (|f64| + median) max / mean: "
            + "; ".join(f"{f} {w:.4g} / {m:.4g}"
                        for f, (w, m) in readings.items())
            + f" (the mean's tolerance {GNN_BF16_TOL})")
        if not readings["sound"][1] <= GNN_BF16_TOL:
            fail(f"mace {shape}: bf16 energies against f64: mean relative "
                 f"|diff| {readings['sound'][1]:.4g} (tolerance "
                 f"{GNN_BF16_TOL})")
        for fault, (_, fm) in readings.items():
            if fault != "sound" and not fm > GNN_BF16_TOL:
                fail(f"mace {shape}: the bf16 check cannot see a planted "
                     f"fault ({fault}): mean relative |diff| {fm:.4g}")
        del model, want
        torch.cuda.empty_cache()

    # the trained minibatch_lg model's node descriptors through Zen
    cfg, tr = trained
    batch = batches["minibatch_lg"]
    t = time.perf_counter()
    with torch.no_grad():
        desc = mace.node_descriptors(cfg, tr.model, batch)
    torch.cuda.synchronize()
    desc_s = time.perf_counter() - t
    N = desc.shape[0]
    if (desc.shape != (batch["positions"].shape[0], cfg.channels)
            or desc.dtype != torch.float32 or not torch.isfinite(desc).all()):
        fail(f"node descriptors: {tuple(desc.shape)} {desc.dtype}, finite "
             f"{bool(torch.isfinite(desc).all())}")
    del trained, batches, tr, batch
    torch.cuda.empty_cache()
    t = time.perf_counter()
    index = serve.build_index(desc, GNN_K, device=dev,
                              generator=torch.Generator().manual_seed(25))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    rows = torch.randperm(N, generator=torch.Generator().manual_seed(25)
                          )[:GNN_Q].to(dev)
    queries = [desc[rows[lo:lo + 64]] for lo in range(0, GNN_Q, 64)]
    server = serve.ZenServer(index, rerank_factor=GNN_RERANK)
    server.query(queries[0], GNN_NN)  # warm-up
    zt.zen_topk.launches = 0
    lat, answers = [], []
    for q in queries:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, ids = server.query(q, GNN_NN)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        if d.shape != (64, GNN_NN) or not torch.isfinite(d).all():
            fail(f"descriptor leg: distances not finite of shape (64, "
                 f"{GNN_NN}): {tuple(d.shape)}")
        answers.append((d, ids))
    launches = zt.zen_topk.launches
    if launches != len(queries):
        fail(f"descriptor leg: {len(queries)} batches launched zen_topk "
             f"{launches} times, not once a batch")
    recalls = [serve.recall(ids, serve.exact_topk(q, desc, GNN_NN))
               for (_, ids), q in zip(answers, queries)]
    with plain_dispatch():
        for (d, ids), q in zip(answers, queries):
            pd, pids = server.query(q, GNN_NN)
            msg = topk_mismatch(d, ids, pd, pids, rtol=RTOL, atol=RTOL)
            if msg is not None:
                fail(f"descriptor leg: the served answers differ from the "
                     f"kernels' plain versions': {msg}")
    first = {}
    for mode in ("lwb", "zen"):
        srv = serve.ZenServer(index, mode=mode, rerank_factor=GNN_RERANK)
        hits = [srv.query(q, GNN_NN)[1][:, 0] == rows[64 * i:64 * (i + 1)]
                for i, q in enumerate(queries)]
        first[mode] = int(torch.cat(hits).sum())
    if first["lwb"] != GNN_Q:
        fail(f"descriptor leg: Lwb serves {GNN_Q - first['lwb']} of "
             f"{GNN_Q} query rows not first")
    lat_ms = np.asarray(lat) * 1e3
    log(f"    descriptors: node_descriptors of the trained minibatch_lg "
        f"model {tuple(desc.shape)} f32 in {desc_s:.2f} s; flat "
        f"build_index(k = {GNN_K}) {build_s:.2f} s; {len(queries)} batches "
        f"x 64 descriptor rows (re-rank {GNN_RERANK}, n = {GNN_NN}): "
        f"recall@{GNN_NN} {np.mean(recalls):.4f} (min batch "
        f"{np.min(recalls):.4f}), p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p99 {np.percentile(lat_ms, 99):.3f} ms; zen_topk launches "
        f"{launches}; answers equal the plain dispatch's; each query row "
        f"served first: Lwb {first['lwb']} of {GNN_Q}, Zen {first['zen']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"zen_topk": launches}


def _mesh_profile(fn, label: str, cards) -> dict:
    """One call of ``fn`` under torch.profiler: the wall time, each card's
    busy time (its kernels' summed durations) and the device time of the
    kernels launched inside the ``mesh.*`` ranges (the cross-shard copies
    and sums of ``distributed.partition``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for d in cards:
            torch.cuda.synchronize(d)
        t = time.perf_counter()
        fn()
        for d in cards:
            torch.cuda.synchronize(d)
        wall_us = (time.perf_counter() - t) * 1e6
    busy, mesh_us, gemm_us = {}, 0.0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy[e.device_index] = busy.get(e.device_index, 0.0) + us
            gemm_us += us if _gemm_kernel(e.name) else 0.0
        elif e.name.startswith("mesh.") and not any(
                p.name.startswith("mesh.") for p in _parents(e)):
            mesh_us += e.device_time_total
    total = sum(busy.values())
    out = {"wall_ms": wall_us / 1e3, "busy_ms": total / 1e3,
           "busy_share": total / (wall_us * max(len(busy), 1)),
           "busy_by_card": {k: round(v / wall_us, 4) for k, v in
                            sorted(busy.items())},
           "mesh_share": mesh_us / total if total else None,
           "gemm_share": gemm_us / total if total else None}
    log(f"    profile of {label} (profiler on): wall {wall_us / 1e3:.1f} ms,"
        f" busy {total / 1e3:.1f} ms over {len(busy)} card(s) (busy share "
        f"{out['busy_share']:.1%}; by card {out['busy_by_card']}); GEMM "
        f"kernels {out['gemm_share'] or 0:.1%}; cross-shard copies and sums"
        f" (mesh.* ranges) " + (f"{out['mesh_share']:.1%}" if mesh_us else
                                "not measured (no device time in the "
                                "mesh.* ranges)") + " of the busy time")
    return out


def _parents(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def check_route_flips(cfg, mesh_in, mesh_routes, single_in, single_routes,
                      labels=None) -> None:
    """Phases 26 (b) and 29, layer by layer (``labels``: each entry's
    name; by default its layer): the mesh's step-0 routing is the
    unsharded router's (``moe.route``) on the mesh's own router inputs,
    exactly; and every token the mesh routes otherwise than the single
    device is a near-tie that the inputs' difference explains. For such a
    token, at the first top-k position where the two differ, the single
    device's logit margin between its expert and the mesh's must be at
    most 2 max_e |((x_mesh - x_single) @ W)_e| (the f64 change of the
    token's logits that the inputs' difference makes) plus the two f32
    products' rounding, 2 x 4 sqrt(D) 2^-24 max_e (|x| @ |W|)_e. Also
    logged: each flipped token's margin between the single device's k-th
    and (k+1)-th logit."""
    import torch
    from repro_torch.models import layers, moe

    K = cfg.top_k
    for l, ((xm, w), idx_m, (xs, ws), idx_s) in enumerate(zip(
            mesh_in, mesh_routes, single_in, single_routes)):
        name = labels[l] if labels else f"layer {l}"
        if not torch.equal(w, ws):
            fail(f"C7 {name}: the mesh's gathered router is not the "
                 "single device's")
        again = moe.route(cfg, w, xm)[1]
        if not torch.equal(again, idx_m):
            fail(f"C7 {name}: the mesh's expert assignments are not the "
                 "unsharded router's on the mesh's own inputs")
        E, D = cfg.n_experts, xs.shape[-1]
        logits = layers.matmul_f32(xs, w)[..., :E].double()
        differ = idx_m != idx_s
        flipped = differ.any(-1)
        n = int(flipped.sum())
        if n == 0:
            log(f"    C7 {name}: no token routed otherwise")
            continue
        j = differ.int().argmax(-1, keepdim=True)
        pick = lambda t, i: torch.gather(t, -1, i)[..., 0]  # noqa: E731
        margin = (pick(logits, pick(idx_s, j)[..., None])
                  - pick(logits, pick(idx_m, j)[..., None]))[flipped]
        top = logits.sort(-1, descending=True).values
        margin_k = (top[..., K - 1] - top[..., K])[flipped]
        delta = ((xm.double() - xs.double()) @ w[:, :E].double()).abs()
        rounding = 4 * D**0.5 * 2**-24 * (xs.double().abs()
                                          @ w[:, :E].double().abs())
        bound = (2 * delta.amax(-1) + 2 * rounding.amax(-1))[flipped]
        ratio = margin / bound
        log(f"    C7 {name}: {n} of {flipped.numel()} tokens routed "
            f"otherwise; their single-device margins (its expert's logit "
            f"minus the mesh's at the first differing rank) max "
            f"{float(margin.max()):.4g}, median {float(margin.median()):.4g}"
            f"; k-th minus (k+1)-th logit max {float(margin_k.max()):.4g}; "
            f"the inputs' difference allows 2 max |dx @ W| + rounding: "
            f"median {float(bound.median()):.4g}; margin over allowance max "
            f"{float(ratio.max()):.3f}; layer inputs max |dx| "
            f"{float((xm.float() - xs.float()).abs().max()):.4g}")
        if float(ratio.max()) > 1.0:
            fail(f"C7 {name}: {int((ratio > 1).sum())} of {n} tokens "
                 f"route otherwise past what the inputs' difference "
                 f"explains (margin over allowance {float(ratio.max()):.3f})")


def check_lm_mesh(dev, smi: str, four_cards: bool) -> None:
    """Phase 26: the LM family's trainer on a (data, model) mesh
    (``launch.mesh.make_host_mesh``, ``launch.train.ShardedTrainer``), at
    published width, through the CLI's function.

    (a) granite-8b on data 1 x model 4 and (b) qwen2-moe-a2.7b (60 experts
    padded to 64, 16 a shard) on 1 x 4, at MESH_LEGS' depth and batch,
    MESH_STEPS steps, losses finite. On one card (logical shards) the
    single-device trainer at the same depth and seed beside it: step 0's
    logits, loss and every gradient leaf within
    ``testing.bf16_lm_mismatch`` (computed twice on the mesh: the same
    bits), every step's loss within its loss rtol, a second sharded run's
    first MESH_AGAIN losses the same bits, and (b) step 0's expert
    assignments against the single device's (MOE_ROUTE_AGREE); on four
    cards the loss of a repeated batch falling (``--fixed-batch``). After
    the last step every holder of every shard of the parameters and
    moments holds the same bits. (c) qwen1.5-0.5b at
    full width, MESH_QWEN_LAYERS' depth, with --compress-grads on 2 x 2
    (one card: a
    restart on 2 x 2 from a step-3 checkpoint is the uninterrupted run's
    bits, one on 1 x 4 within the loss rtol, and the manifest carries the
    rules' specs; four cards: 2 x 2 and 4 x 1). (d) one card: granite-8b's
    ``steps.build_plan(..., "train_4k")`` at 4 layers (n_microbatches 8)
    at a global batch of 8, its peak memory beside the CLI step's at that
    batch. For (a)-(c): ms a step, tokens/s, the share of the bf16 peak
    (``launch/model_flops.py`` over 989 TFLOP/s a card), peak GB a card,
    and a profiled step's busy share and cross-shard share.

    With ``four_cards`` (``--sharded``) the mesh must be four distinct
    cards, and the one-card leg's granite-8b runs on them and on four logical
    shards of card 0 from one seed: losses within the rtol, the bits'
    equality reported.
    """
    import shutil
    import tempfile

    import torch
    from repro_torch import configs as C
    from repro_torch import testing
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import P, lm_param_specs
    from repro_torch.launch import model_flops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    S = MESH_SEQ
    mesh = make_host_mesh(1, 4)
    n_cards = len(set(mesh.devices.flat))
    if four_cards and n_cards != 4:
        fail(f"--sharded needs a mesh of four distinct cards; "
             f"make_host_mesh(1, 4) sits on {n_cards} "
             f"({[str(d) for d in mesh.devices.flat]})")
    cards = list(dict.fromkeys(mesh.devices.flat))
    log(f"[26] the LM trainer on a (data, model) mesh at published width; "
        f"{smi}; make_host_mesh(1, 4) sits on "
        f"{[str(d) for d in mesh.devices.flat]} ("
        + ("four cards" if n_cards == 4 else
           f"four logical shards of {n_cards} card") + f"); S = {S:,}")
    del mesh

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def free():
        gc.collect()
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()

    def cli(arch, shape, batch, layers=None, steps=MESH_STEPS, *extra):
        args = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
                "--seq", str(S), "--data-shards", str(shape[0]),
                "--model-shards", str(shape[1]), *extra]
        if four_cards:
            args.append("--fixed-batch")
        if layers is not None:
            args += ["--layers", str(layers)]
        out = train.main(args)
        losses = out["losses"]
        if len(losses) != steps - out["start_step"] or \
                not np.isfinite(losses).all():
            fail(f"{arch} on {shape}: losses {losses}")
        return out

    def report(arch, shape, cfg, out, batch, label=""):
        ms = float(np.median(out["step_s"][-4:])) * 1e3
        est = model_flops.estimate(arch, "train_4k", cfg)
        cell = C.get_arch(arch).cell("train_4k")
        flops = est["model_flops_global"] * batch / cell.dims["global_batch"]
        n = 1 if out["mesh"] is None else len(set(out["mesh"].devices.flat))
        peaks = {k: round(v / 1e9, 2)
                 for k, v in out["peak_bytes_by_device"].items()}
        log(f"    {arch}{label} ({cfg.n_layers} layers, "
            f"{cfg.param_count():,} parameters) on {shape[0]} x {shape[1]}"
            f", B = {batch}: {ms:.1f} ms a step (median of the last 4; "
            f"every step {np.round(np.asarray(out['step_s']) * 1e3, 1).tolist()}"
            f" ms), {batch * S / ms * 1e3:,.0f} tokens/s, model FLOPs "
            f"{flops / 1e12:.1f} T a step = "
            f"{flops / (ms / 1e3) / (PEAK_BF16_FLOPS * n):.2%} of the bf16 "
            f"peak of {n} card(s); losses {np.round(out['losses'], 5).tolist()}"
            f"; peak GB a card {peaks}")
        return ms

    def held_equal(tr) -> bool:
        st = tr.opt_state
        return all(partition.replicas_equal(t) for t in (
            *tr.params.values(), *st.mu.values(), *st.nu.values(), st.step))

    def falling(arch, losses):
        if four_cards and not losses[-1] < losses[0]:
            fail(f"{arch}: the loss did not fall: {losses}")

    # -- (a), (b): granite-8b and qwen2-moe-a2.7b on data 1 x model 4 ------
    for arch, (layers, B) in MESH_LEGS[four_cards].items():
        spec = C.get_arch(arch)
        cfg = dataclasses.replace(spec.make_config(), n_layers=layers)
        free()
        out = cli(arch, (1, 4), B, layers)
        falling(arch, out["losses"])
        report(arch, (1, 4), cfg, out, B)
        tr = out["trainer"]
        batch = train.lm_batch_fn(cfg, seed=0, batch=B, seq=S,
                                  device=dev)(MESH_STEPS)
        _mesh_profile(lambda: tr.step(batch), f"one {arch} step", cards)
        if not held_equal(tr):
            fail(f"{arch}: a replicated shard differs between holders")
        log(f"    {arch}: every holder of every shard of the parameters, "
            f"moments and step holds the same bits after {MESH_STEPS + 1} "
            f"steps ({time.perf_counter() - t0:.0f} s into the phase)")
        sharded_losses = out["losses"]
        del out, tr, batch
        if four_cards:
            continue
        free()
        again = cli(arch, (1, 4), B, layers, MESH_AGAIN)
        if again["losses"] != sharded_losses[:MESH_AGAIN]:
            fail(f"{arch}: a second sharded run's losses "
                 f"{again['losses']} differ from {sharded_losses}")
        del again
        free()
        single = cli(arch, (1, 1), B, layers)
        rtol = testing.BF16_LOSS_RTOL
        if any(abs(a - b) > rtol * abs(b)
               for a, b in zip(sharded_losses, single["losses"])):
            fail(f"{arch}: sharded losses {sharded_losses} against the "
                 f"single device's {single['losses']} (rtol {rtol})")
        report(arch, (1, 1), cfg, single, B, " single device")
        del single
        free()
        # step 0 from fresh weights: the mesh's logits, loss and gradients
        # (twice: the same bits), its routing recorded layer by layer
        tokens = train.lm_batch_fn(cfg, seed=0, batch=B, seq=S,
                                   device=dev)(0)["tokens"]
        mesh = make_host_mesh(1, 4)
        model = transformer.init_sharded(cfg, mesh, generator=(
            torch.Generator(device=mesh.first_device).manual_seed(0)))
        mesh_in, single_in = [], []
        with testing.recorded_routes([], mesh_in) as routes:
            got_logits = transformer.sharded_logits(cfg, model, tokens)
        got_loss, _, grads = train.sharded_grads(model, {"tokens": tokens})
        _, _, grads2 = train.sharded_grads(model, {"tokens": tokens})
        if not all(torch.equal(a, b) for n in grads for a, b in
                   zip(grads[n].shards, grads2[n].shards)):
            fail(f"{arch}: step 0's gradients on the mesh differ between "
                 "two runs")
        got_grads = {n: g.gather() for n, g in grads.items()}
        del grads, grads2, model, mesh
        free()
        model = transformer.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0))
        forced, routing = "", contextlib.nullcontext()
        if cfg.is_moe:
            M, L_ = 4, cfg.n_layers
            mine = [routes[l * M:(l + 1) * M] for l in range(L_)]
            if len(routes) != M * L_ or not all(
                    torch.equal(r, m[0]) for m in mine for r in m):
                fail(f"{arch}: the model shards route differently")
            with testing.recorded_routes([], single_in) as single, \
                    torch.no_grad():
                transformer.forward(cfg, model, tokens)
            agree = [float((m[0] == r).float().mean())
                     for m, r in zip(mine, single)]
            log(f"    {arch}: step 0's expert assignments (tokens x top-"
                f"{cfg.top_k}) equal across the 4 model shards (each routes"
                f" with the whole router); against the single device, layer"
                f" by layer: {[f'{a:.6f}' for a in agree]} equal (limit "
                f"{MOE_ROUTE_AGREE})")
            if min(agree) < MOE_ROUTE_AGREE:
                fail(f"{arch}: step 0's expert assignments agree with the "
                     f"single device's only {min(agree):.6f}")
            check_route_flips(cfg, [mesh_in[l * M] for l in range(L_)],
                              [m[0] for m in mine], single_in, single)
            del mesh_in, single_in
            routing = testing.routed_as(model, [m[0] for m in mine])
            forced = (" (the single device routed as the mesh: its gates "
                      "from its own router probabilities)")
        with routing:
            with torch.no_grad():
                want_logits = transformer.forward(cfg, model, tokens)
            loss, _ = transformer.loss_fn(cfg, model, {"tokens": tokens})
            want_grads = dict(zip([n for n, _ in model.named_parameters()],
                                  torch.autograd.grad(
                                      loss, list(model.parameters()))))
        want_loss = loss.detach()
        del model, loss
        msg = testing.bf16_lm_mismatch(got_logits, got_loss.detach(),
                                       got_grads, want_logits, want_loss,
                                       want_grads)
        if msg is not None:
            fail(f"{arch}: step 0 on the mesh against the single device"
                 f"{forced}: {msg}")
        err = float((got_logits - want_logits).abs().max())
        worst = max(float((got_grads[n].float() - w.float()).abs().max()
                          / w.float().abs().max())
                    for n, w in want_grads.items())
        del got_logits, want_logits, got_grads, want_grads
        free()
        log(f"    {arch}: step 0 on 1 x 4 against the single device{forced}"
            f" within testing.bf16_lm_mismatch (logits max |diff| {err:.4g},"
            f" loss {got_loss.item():.6f} vs {want_loss.item():.6f}, the "
            f"worst gradient leaf's max |diff| {worst:.4g} of its largest "
            f"|g|); its gradients twice the same bits; every step's loss "
            f"within rtol {rtol:.3g}; a second sharded run's {MESH_AGAIN} "
            f"losses the same bits ({time.perf_counter() - t0:.0f} s into "
            "the phase)")

    # -- (c): qwen1.5-0.5b at full width, compressed -------------------------
    arch = "qwen1.5-0.5b"
    cfg = C.get_arch(arch).make_config()
    q_layers = MESH_QWEN_LAYERS[four_cards]
    if q_layers is not None:
        log(f"    {arch}: {q_layers} of its {cfg.n_layers} layers (cut for "
            "the smoke run's time limit)")
        cfg = dataclasses.replace(cfg, n_layers=q_layers)
    comp = ("--compress-grads",)
    shapes = [(2, 2), (4, 1)] if four_cards else [(2, 2)]
    with tempfile.TemporaryDirectory() as d:
        for shape in shapes:
            free()
            Bq = MESH_QWEN_ROWS * shape[0]
            out = cli(arch, shape, Bq, q_layers, MESH_STEPS, *comp,
                      "--ckpt-dir", os.path.join(d, f"w{shape}"),
                      "--ckpt-every", "3")
            falling(arch, out["losses"])
            report(arch, shape, cfg, out, Bq, " --compress-grads")
            tr = out["trainer"]
            final = None if four_cards else {
                n: [s.detach().to("cpu", copy=True) for s in p.shards]
                for n, p in tr.params.items()}
            batch = train.lm_batch_fn(cfg, seed=0, batch=Bq, seq=S,
                                      device=dev)(MESH_STEPS)
            _mesh_profile(lambda: tr.step(batch), f"one {arch} step on "
                          f"{shape[0]} x {shape[1]}", cards)
            if not held_equal(tr):
                fail(f"{arch} on {shape}: a replicated shard differs "
                     "between holders")
            whole = out["losses"]
            del batch, out, tr
            if four_cards:
                continue
            mgr = CheckpointManager(os.path.join(d, f"w{shape}"))
            specs = mgr.specs(3)
            rules = lm_param_specs(transformer.Transformer(cfg,
                                                           device="meta"))
            want = {f"0__{n.replace('.', '__')}": sp
                    for n, sp in rules.items()}
            want.update({f"1__.{m}__{n.replace('.', '__')}": sp
                         for n, sp in rules.items() for m in ("mu", "nu")})
            want.update({f"2__error__{n.replace('.', '__')}":
                         P("data", *sp) for n, sp in rules.items()})
            want["1__.step"] = P()
            if specs != want:
                fail(f"{arch}: the manifest's specs are not the rules': "
                     f"{sorted(set(specs.items()) ^ set(want.items()))[:6]}")
            for label, mesh_shape in (("2 x 2", (2, 2)), ("1 x 4", (1, 4))):
                r = os.path.join(d, f"r{mesh_shape}")
                os.makedirs(r)
                shutil.copytree(os.path.join(d, f"w{shape}",
                                             "step_0000000003"),
                                os.path.join(r, "step_0000000003"))
                free()
                res = cli(arch, mesh_shape, Bq, q_layers, MESH_STEPS,
                          *comp,
                          "--ckpt-dir", r, "--ckpt-every", "100",
                          "--resume")
                if res["start_step"] != 3:
                    fail(f"{arch}: resumed from {res['start_step']}, not 3")
                if mesh_shape == (2, 2):
                    if res["losses"] != whole[3:]:
                        fail(f"{arch}: resumed on 2 x 2, losses "
                             f"{res['losses']} vs {whole[3:]}")
                    bad = [n for n, p in res["trainer"].params.items()
                           if not all(torch.equal(s.detach().to("cpu", copy=True), f)
                                      for s, f in zip(p.shards, final[n]))]
                    if bad:
                        fail(f"{arch}: resumed on 2 x 2, parameters differ"
                             f": {bad}")
                else:
                    rtol = testing.BF16_LOSS_RTOL
                    if any(abs(a - b) > rtol * abs(b)
                           for a, b in zip(res["losses"], whole[3:])):
                        fail(f"{arch}: resumed on 1 x 4, losses "
                             f"{res['losses']} vs {whole[3:]}")
                log(f"    {arch}: resumed on {label} from the 2 x 2 run's "
                    f"step-3 checkpoint: losses {res['losses']} against "
                    f"{whole[3:]} (" + ("bit for bit, parameters too)"
                                        if mesh_shape == (2, 2) else
                                        "within the loss rtol; the error "
                                        "buffers restart from zero on one "
                                        "data replica)"))
                del res
            log(f"    {arch}: the manifest's {len(specs)} specs are the "
                "reference rules' (lm_param_specs; the error buffers "
                "P('data', ...))")
            del final

    # -- (d): the plan's gradient accumulation against the CLI's step -------
    if not four_cards:
        free()
        plan = steps_lib.build_plan("granite-8b", "train_4k",
                                    overrides={"n_layers": 4})
        nm, Bd = plan.cfg.n_microbatches, 8
        mesh = make_host_mesh(1, 4)
        batch = train.lm_batch_fn(plan.cfg, seed=0, batch=Bd, seq=S,
                                  device=dev)(0)
        peaks = {}
        for label in ("plan", "cli"):
            free()
            # each step from its own copy of the same starting state
            tr = train.ShardedTrainer(
                transformer.init_sharded(plan.cfg, mesh, generator=(
                    torch.Generator(device=mesh.first_device)
                    .manual_seed(0))), opt=steps_lib.make_optimizer())
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            t = time.perf_counter()
            try:
                if label == "plan":
                    loss = float(plan.fn(tr.params, tr.opt_state,
                                         batch)[2]["loss"])
                else:
                    loss = float(tr.step(batch)[0])
            except torch.cuda.OutOfMemoryError:
                peaks[label] = (None, None, None)
                del tr
                continue
            sync()
            peaks[label] = (max(torch.cuda.max_memory_allocated(c)
                                for c in cards) / 1e9,
                            time.perf_counter() - t, loss)
            del tr
        if peaks["plan"][0] is None:
            fail("granite-8b's plan (n_microbatches 8) ran out of memory")
        cli_peak = peaks["cli"]
        log(f"    granite-8b's steps.build_plan(..., 'train_4k') at 4 "
            f"layers, n_microbatches {nm}, global batch {Bd} on 1 x 4: peak "
            f"{peaks['plan'][0]:.2f} GB a card, {peaks['plan'][1]:.2f} s, "
            f"loss {peaks['plan'][2]:.5f}; the CLI's step at the same batch"
            + (f": peak {cli_peak[0]:.2f} GB a card, {cli_peak[1]:.2f} s, "
               f"loss {cli_peak[2]:.5f}" if cli_peak[0] is not None else
               ": out of memory") + f" (each from its own copy of the "
            f"same initial shards and zero moments: the mean of {nm} "
            f"microbatches' losses against the whole batch's)")
        del plan, batch, mesh
        free()

    # -- four cards against one ---------------------------------------------
    if four_cards:
        arch, (layers, B) = "granite-8b", MESH_LEGS[False]["granite-8b"]
        cfg = dataclasses.replace(C.get_arch(arch).make_config(),
                                  n_layers=layers)
        runs = {}
        for label, device in (("four cards", None),
                              ("four logical shards of cuda:0", "cuda:0")):
            free()
            mesh = make_host_mesh(1, 4, device=device)
            tr = train.sharded_lm_trainer(cfg, mesh=mesh, seed=0)
            make = train.lm_batch_fn(cfg, seed=0, batch=B, seq=S, device=dev)
            losses = [float(tr.step(make(i))[0]) for i in range(3)]
            runs[label] = (losses, {n: [s.detach().to("cpu", copy=True) for s in p.shards]
                                    for n, p in tr.params.items()})
            del tr, mesh
        (la, pa), (lb, pb) = runs.values()
        rtol = testing.BF16_LOSS_RTOL
        if any(abs(a - b) > rtol * abs(b) for a, b in zip(la, lb)):
            fail(f"granite-8b on four cards {la} against four logical "
                 f"shards of one {lb}")
        same = la == lb and all(torch.equal(x, y) for n in pa
                                for x, y in zip(pa[n], pb[n]))
        log(f"    granite-8b at {layers} layers, 3 steps, on four cards "
            f"{la} and on four logical shards of cuda:0 {lb}: within rtol "
            f"{rtol:.3g}; " + ("the same bits (losses and every parameter "
                               "shard)" if same else "not the same bits"))
    log(f"    phase 26: {time.perf_counter() - t0:.1f} s")


def sync_cards(cards) -> None:
    import torch

    for c in cards:
        torch.cuda.synchronize(c)


def free_cards(cards) -> None:
    import torch

    gc.collect()
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()


def timed_steps(step, n: int, cards) -> tuple:
    """``n`` calls of ``step`` (returning the loss): the losses and each
    call's seconds, every card synchronised around it."""
    losses, step_s = [], []
    for _ in range(n):
        sync_cards(cards)
        t = time.perf_counter()
        losses.append(float(step()))
        sync_cards(cards)
        step_s.append(time.perf_counter() - t)
    return losses, step_s


def ogb_batch(cell, dev) -> dict:
    """The ogb_products cell's graph: ``geometric_graph_batch`` at its
    2,449,029 nodes, 61,859,140 edges and 100 features, per node, its
    edges padded by ``configs.base.pad_edges`` to the input specs'
    61,859,328 (padding edges 0 -> 0 with edge_mask 0)."""
    import torch
    from repro_torch.configs.base import pad_edges

    batch = gnn_cell_batch(cell, 0, dev)
    E = batch["senders"].shape[0]
    pad = pad_edges(E) - E
    for k in ("senders", "receivers", "edge_mask"):
        batch[k] = torch.cat([batch[k], batch[k].new_zeros(pad)])
    return batch


class SideClock:
    """While open, the wall time (every card synchronised before and
    after each call) of ``models.mace``'s sharded edge side and node side,
    summed over calls."""

    def __init__(self, cards):
        from repro_torch.models import mace

        self.mace, self.cards, self.ms = mace, cards, {"edge": 0.0,
                                                       "node": 0.0}
        self.orig = {"edge": mace._sharded_edge_side,
                     "node": mace._sharded_node_side}

    def _timed(self, side):
        import torch

        def fn(*a, **k):
            for c in self.cards:
                torch.cuda.synchronize(c)
            t = time.perf_counter()
            out = self.orig[side](*a, **k)
            for c in self.cards:
                torch.cuda.synchronize(c)
            self.ms[side] += (time.perf_counter() - t) * 1e3
            return out
        return fn

    def __enter__(self):
        self.mace._sharded_edge_side = self._timed("edge")
        self.mace._sharded_node_side = self._timed("node")
        return self

    def __exit__(self, *exc):
        self.mace._sharded_edge_side = self.orig["edge"]
        self.mace._sharded_node_side = self.orig["node"]


def check_gnn_mesh(dev, smi: str, four_cards: bool) -> None:
    """Phase 27: MACE on a (data, model) mesh at published width (2
    layers, C = 128, l_max 2, correlation 3, bf16, remat), through the
    sharded trainer and the reference's GNN train plan
    (``launch.steps.build_plan("mace", cell)``).

    One card (four logical shards): minibatch_lg (176,128 nodes, 172,032
    edges, 602 features, per node) on 1 x 4, 2 x 1 and 2 x 2 against the
    single device from one seed, GNN_MESH_STEPS steps on the cell's one
    batch: step 0's per-node energies within GNN_BF16_TOL of an f64
    evaluation of the same weights (``testing.energy_errors``' mean),
    every step's loss within GNN_MESH_LOSS_RTOL of the single device's,
    every holder of every shard the same bits after the steps; on 1 x 4 a
    rerun's first 2 steps and a restart from a step-2 checkpoint the same
    bits; the plan's step and the CLI's step (``ShardedTrainer.step``),
    each from its own copy of the initial state: the same loss. ms a
    step, nodes/s, peak GB, and a profiled step's busy and cross-shard
    shares.

    Four cards (``four_cards``; the mesh must be four distinct cards):
    minibatch_lg 2 steps on 1 x 4 of the four cards and of four logical
    shards of card 0 from one seed: the same bits. Then ogb_products
    (2,449,029 nodes, 61,859,140 edges padded to 61,859,328, 100
    features, per node) through ``build_plan("mace", "ogb_products")`` on
    1 x 4 (16 edge chunks; on running out of memory, 32, then 64, through
    ``overrides``): OGB_STEPS steps on its one batch, losses finite and
    falling; ms a step (median of the last 2), nodes/s, the share of
    four cards' bf16 peak (``launch/model_flops.py``), peak GB a card, a
    profiled step's busy share a card and its ``mesh.*`` share, a
    no-gradient forward's edge and node sides apart; a rerun's first 2
    steps and a restart from a step-3 checkpoint the same bits.
    """
    import tempfile

    import torch
    from repro_torch import configs as C
    from repro_torch import testing
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import mace as mace_cfg
    from repro_torch.distributed import partition
    from repro_torch.launch import model_flops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mace

    t0 = time.perf_counter()
    spec = C.get_arch("mace")
    base = spec.make_config()
    mesh = make_host_mesh(1, 4)
    cards = list(dict.fromkeys(mesh.devices.flat))
    if four_cards and len(cards) != 4:
        fail(f"--sharded needs a mesh of four distinct cards; "
             f"make_host_mesh(1, 4) sits on {[str(d) for d in cards]}")
    log(f"[27] MACE on a (data, model) mesh at published width ("
        f"{base.n_layers} layers, C = {base.channels}, "
        f"{str(base.dtype)[6:]}, remat {base.remat}); {smi}; "
        f"make_host_mesh(1, 4) sits on "
        f"{[str(d) for d in mesh.devices.flat]}")
    del mesh

    def sync():
        sync_cards(cards)

    def free():
        free_cards(cards)

    def reset():
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    def peaks():
        return {str(c): round(torch.cuda.max_memory_allocated(c) / 1e9, 2)
                for c in cards}

    def host(params):
        return {n: [s.detach().to("cpu", copy=True) for s in p.shards]
                for n, p in params.items()}

    def same(a, b):
        return all(torch.equal(x, y) for n in a for x, y in zip(a[n], b[n]))

    def held_equal(tr):
        st = tr.opt_state
        return all(partition.replicas_equal(t) for t in (
            *tr.params.values(), *st.mu.values(), *st.nu.values(), st.step))

    cell = spec.cell("minibatch_lg")
    cfg = mace_cfg.for_shape(base, cell.dims["d_feat"])
    batch = gnn_cell_batch(cell, 0, dev)
    N = cell.dims["n_nodes"]
    flops = model_flops.estimate("mace", "minibatch_lg", cfg)[
        "model_flops_global"]

    if four_cards:
        runs = {}
        for label, device in (("four cards", None),
                              ("four logical shards of cuda:0", "cuda:0")):
            free()
            tr = train.sharded_mace_trainer(
                cfg, mesh=make_host_mesh(1, 4, device=device), seed=0)
            runs[label] = ([float(tr.step(batch)[0]) for _ in range(2)],
                           host(tr.params))
            del tr
        (la, pa), (lb, pb) = runs.values()
        # the four-card legs report every failed gate, then fail once
        problems = [] if la == lb and same(pa, pb) else [
            f"mace minibatch_lg on four cards {la} is not the bits of four "
            f"logical shards of cuda:0 {lb}"]
        log(f"    minibatch_lg on 1 x 4, 2 steps: four cards {la} and four "
            f"logical shards of cuda:0 {lb}: " + (
                "the same bits (losses and every parameter shard)"
                if not problems else "NOT the same bits"))
        del runs, pa, pb, batch
        problems += check_ogb_products(spec, cards, smi)
        log(f"    phase 27: {time.perf_counter() - t0:.1f} s")
        if problems:
            fail("; ".join(problems))
        return

    # -- the single device, then each mesh against it and against f64 -------
    free()
    reset()
    single = train.mace_trainer(cfg, seed=0, device=dev)
    want_losses, single_s = timed_steps(
        lambda: single.step(batch)[0], GNN_MESH_STEPS, cards)
    single_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del single
    free()
    ms = float(np.median(single_s[-2:])) * 1e3
    log(f"    minibatch_lg single device: {ms:.1f} ms a step (median of the "
        f"last 2 of {GNN_MESH_STEPS}), losses "
        f"{np.round(want_losses, 5).tolist()}, peak {single_peak:.2f} GB")
    rtol = GNN_MESH_LOSS_RTOL
    ref = mace.MACE(cfg, device=dev)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64, remat=False)
    m64 = mace.MACE(cfg64, device=dev)

    def at_params(tr):
        """At the mesh's parameters: the single device's bf16 loss, the
        f64 loss, and the mesh's and the single device's energies against
        f64 (``testing.energy_errors``' (max, mean))."""
        with torch.no_grad():
            for (n, p), q in zip(ref.named_parameters(), m64.parameters()):
                p.copy_(tr.params[n].gather(dev))
                q.copy_(p.double())
            want = mace.forward(cfg64, m64, batch)
            one = mace.forward(cfg, ref, batch)
            loss = float(mace._mse(one, batch)[0])
            loss64 = float(mace._mse(want, batch)[0])
            mesh_err = testing.energy_errors(
                mace.sharded_forward(cfg, tr.model, batch), want)
            return loss, loss64, mesh_err, testing.energy_errors(one, want)

    for shape in GNN_MESH_SHAPES:
        free()
        reset()
        mesh = make_host_mesh(*shape)
        tr = train.sharded_mace_trainer(cfg, mesh=mesh, seed=0)
        d = tempfile.mkdtemp()
        restart = shape == (1, 4)
        losses, step_s, at, at64, errs = [], [], [], [], []
        for s in range(GNN_MESH_STEPS):
            if restart and s == 2:
                mgr = CheckpointManager(d)
                mgr.save(2, tr.state_tree(), tr.state_specs())
            loss, loss64, mesh_err, single_err = at_params(tr)
            at64.append(loss64)
            if not mesh_err[1] <= GNN_BF16_TOL:
                fail(f"mace minibatch_lg on {shape}: step {s}'s energies "
                     f"against f64, mean relative |diff| {mesh_err[1]:.4g} "
                     f"(tolerance {GNN_BF16_TOL}; the single device's "
                     f"{single_err[1]:.4g})")
            at.append(loss)
            errs.append((mesh_err[1], single_err[1]))
            one, one_s = timed_steps(lambda: tr.step(batch)[0], 1, cards)
            losses += one
            step_s += one_s
        peak = peaks()
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, at))
        if not np.isfinite(losses).all() or not worst <= rtol:
            fail(f"mace minibatch_lg on {shape}: losses {losses} against the "
                 f"single device's at the mesh's parameters {at} (rtol "
                 f"{rtol})")
        if not held_equal(tr):
            fail(f"mace minibatch_lg on {shape}: a replicated shard differs "
                 "between holders")
        ms = float(np.median(step_s[-2:])) * 1e3
        final = host(tr.params) if restart else None
        log(f"    minibatch_lg on {shape[0]} x {shape[1]}: {ms:.1f} ms a step "
            f"(median of the last 2; every step "
            f"{np.round(np.asarray(step_s) * 1e3, 1).tolist()} ms), "
            f"{N / ms * 1e3:,.0f} nodes/s, {flops / (ms / 1e3) / PEAK_BF16_FLOPS:.2%}"
            f" of the bf16 peak; losses {np.round(losses, 5).tolist()} "
            f"(the single device's at the same parameters "
            f"{np.round(at, 5).tolist()}: max relative |diff| {worst:.3g}, "
            f"rtol {rtol}; f64's {np.round(at64, 5).tolist()}); each step's energies against f64, mean "
            f"relative |diff| {[round(e[0], 5) for e in errs]} (the single "
            f"device's at the same parameters "
            f"{[round(e[1], 5) for e in errs]}; tolerance {GNN_BF16_TOL}); "
            f"peak GB {peak}; every holder of every shard the same bits")
        _mesh_profile(lambda: tr.step(batch), f"one minibatch_lg step on "
                      f"{shape[0]} x {shape[1]}", cards)
        if restart:
            step, tree = mgr.restore(like=tr.state_tree(), mesh=mesh)
            tr.load_state_tree(tree)
            del tree
            again = [float(tr.step(batch)[0])
                     for _ in range(GNN_MESH_STEPS - 2)]
            if step != 2 or again != losses[2:] or not same(
                    host(tr.params), final):
                fail(f"mace minibatch_lg on 1 x 4: restarted from step "
                     f"{step}, losses {again} against {losses[2:]}, the "
                     f"parameters the same bits: "
                     f"{same(host(tr.params), final)}")
            tr2 = train.sharded_mace_trainer(cfg, mesh=mesh, seed=0)
            rerun = [float(tr2.step(batch)[0]) for _ in range(2)]
            del tr2
            if rerun != losses[:2]:
                fail(f"mace minibatch_lg on 1 x 4: a rerun's losses {rerun} "
                     f"against {losses[:2]}")
            log(f"    minibatch_lg on 1 x 4: a restart from the step-2 "
                f"checkpoint gives steps 2-{GNN_MESH_STEPS - 1}'s losses "
                f"{again} and parameters, the same bits; a rerun's 2 steps "
                f"{rerun}, the same bits")
            del final
        del tr
        shutil.rmtree(d, ignore_errors=True)
    del ref, m64

    # the plan's step and the CLI's step, each from its own copy
    plan = steps_lib.build_plan("mace", "minibatch_lg")
    if plan.cfg != cfg:
        fail(f"build_plan('mace', 'minibatch_lg').cfg {plan.cfg} is not "
             f"{cfg}")
    mesh = make_host_mesh(1, 4)
    out = {}
    for label in ("plan", "cli"):
        free()
        tr = train.sharded_mace_trainer(cfg, mesh=mesh, seed=0)
        reset()
        sync()
        t = time.perf_counter()
        if label == "plan":
            loss = float(plan.fn(tr.params, tr.opt_state, batch)[2]["loss"])
        else:
            loss = float(tr.step(batch)[0])
        sync()
        out[label] = (loss, time.perf_counter() - t,
                      max(peaks().values()))
        del tr
    if out["plan"][0] != out["cli"][0]:
        fail(f"mace minibatch_lg: the plan's loss {out['plan'][0]} is not "
             f"the CLI step's {out['cli'][0]}")
    log(f"    build_plan('mace', 'minibatch_lg') on 1 x 4, each step from "
        f"its own copy of the initial state: the plan's step loss "
        f"{out['plan'][0]:.5f}, {out['plan'][1]:.2f} s, peak "
        f"{out['plan'][2]:.2f} GB; the CLI's step {out['cli'][0]:.5f}, "
        f"{out['cli'][1]:.2f} s, peak {out['cli'][2]:.2f} GB (the same "
        f"loss bits)")
    del batch
    free()
    log(f"    phase 27: {time.perf_counter() - t0:.1f} s")


def check_ogb_products(spec, cards, smi: str) -> list:
    """Phase 27 on four cards: ogb_products through ``build_plan`` on 1 x
    4 (see ``check_gnn_mesh``). Returns the gates it failed."""
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import model_flops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mace

    cell = spec.cell("ogb_products")
    N = cell.dims["n_nodes"]
    t = time.perf_counter()
    batch = ogb_batch(cell, cards[0])
    make_s = time.perf_counter() - t
    mesh = make_host_mesh(1, 4)
    E = batch["senders"].shape[0]
    log(f"    ogb_products: {N:,} nodes, {cell.dims['n_edges']:,} edges "
        f"padded to {E:,} (edge_mask 0 on the padding), d_feat "
        f"{cell.dims['d_feat']}, per node; the batch made in {make_s:.1f} s")

    def start(plan):
        """The plan's arguments from seed 0 on the mesh (``place_args``),
        and a trainer over the same tensors (its checkpoints)."""
        model = mace.init_params(plan.cfg, generator=torch.Generator(
            device=mesh.first_device).manual_seed(0))
        placed, ost = steps_lib.place_args(plan, mesh,
                                           dict(model.named_parameters()))
        tr = train.ShardedTrainer(mace.ShardedMACE(plan.cfg, mesh, placed),
                                  opt=steps_lib.make_optimizer(),
                                  opt_state=ost)
        return tr, lambda: plan.fn(tr.params, tr.opt_state, batch)[2]["loss"]

    def run(step, n):
        return timed_steps(step, n, cards)

    plan = None
    for chunks in OGB_CHUNKS:
        free_cards(cards)
        plan = steps_lib.build_plan(
            "mace", "ogb_products",
            overrides=None if chunks == OGB_CHUNKS[0] else
            {"edge_chunks": chunks})
        if plan.cfg.edge_chunks != chunks:
            fail(f"build_plan('mace', 'ogb_products') chunks its edges in "
                 f"{plan.cfg.edge_chunks}, not {chunks}")
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        tr, step = start(plan)
        try:
            losses, step_s = run(step, 1)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"    ogb_products at {chunks} edge chunks: out of memory "
                f"({str(e).splitlines()[0][:160]})")
            del tr, step
            plan = None
    if plan is None:
        fail(f"ogb_products does not fit four cards at {OGB_CHUNKS} edge "
             "chunks")
    cfg = plan.cfg
    d = tempfile.mkdtemp()
    mgr = CheckpointManager(d)
    more, more_s = run(step, 2)
    mgr.save(3, tr.state_tree(), tr.state_specs())
    last, last_s = run(step, OGB_STEPS - 3)
    losses, step_s = losses + more + last, step_s + more_s + last_s
    peak = {str(c): round(torch.cuda.max_memory_allocated(c) / 1e9, 2)
            for c in cards}
    problems = []
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        problems.append(f"ogb_products: losses {losses} (finite and falling "
                        "on its one batch)")
    final = {n: [s.detach().to("cpu", copy=True) for s in p.shards]
             for n, p in tr.params.items()}
    ms = float(np.median(step_s[-2:])) * 1e3
    flops = model_flops.estimate("mace", "ogb_products", cfg)[
        "model_flops_global"]
    log(f"    ogb_products through build_plan('mace', 'ogb_products') on 1 "
        f"x 4 four cards, {cfg.edge_chunks} edge chunks "
        + ("(the reference plan's)" if cfg.edge_chunks == OGB_CHUNKS[0]
           else f"(raised from the reference plan's {OGB_CHUNKS[0]}: a cut)")
        + f": {ms:.1f} ms a step (median of the last 2; every step "
        f"{np.round(np.asarray(step_s) * 1e3, 1).tolist()} ms), "
        f"{N / ms * 1e3:,.0f} nodes/s; model FLOPs {flops / 1e12:.2f} T a "
        f"step = {flops / (ms / 1e3) / (4 * PEAK_BF16_FLOPS):.3%} of four "
        f"cards' bf16 peak; losses {np.round(losses, 5).tolist()}; peak GB "
        f"a card {peak}; {smi}")
    _mesh_profile(step, "one ogb_products step", cards)
    with torch.no_grad(), SideClock(cards) as clock:
        sync_cards(cards)
        t = time.perf_counter()
        mace.sharded_forward(cfg, tr.model, batch)
        sync_cards(cards)
        fwd_ms = (time.perf_counter() - t) * 1e3
    log(f"    ogb_products forward (no gradient, every card synchronised "
        f"around each side): {fwd_ms:.0f} ms; the 2 layers' edge sides "
        f"{clock.ms['edge']:.0f} ms, their node sides {clock.ms['node']:.0f}"
        f" ms, the rest (inputs, geometry, sorts, the sums over data) "
        f"{fwd_ms - clock.ms['edge'] - clock.ms['node']:.0f} ms")
    # a restart from the step-3 checkpoint, then a rerun from seed 0
    step_no, tree = mgr.restore(like=tr.state_tree(), mesh=mesh)
    tr.load_state_tree(tree)
    del tree
    again, _ = run(step, OGB_STEPS - 3)
    restored = {n: [s.detach().to("cpu", copy=True) for s in p.shards]
                for n, p in tr.params.items()}
    bits = all(torch.equal(x, y) for n in final
               for x, y in zip(final[n], restored[n]))
    if step_no != 3 or again != losses[3:] or not bits:
        problems.append(f"ogb_products: restarted from step {step_no}, "
                        f"losses {again} against {losses[3:]}, the "
                        f"parameters the same bits: {bits}")
    del tr, step
    free_cards(cards)
    tr, step = start(plan)
    rerun, _ = run(step, 2)
    if rerun != losses[:2]:
        problems.append(f"ogb_products: a rerun's losses {rerun} against "
                        f"{losses[:2]}")
    log(f"    ogb_products: a restart from the step-3 checkpoint gives steps "
        f"3-{OGB_STEPS - 1}'s losses {again} and parameters (the same bits:"
        f" {again == losses[3:] and bits}); a rerun from seed 0 gives steps "
        f"0-1's {rerun} (the same bits: {rerun == losses[:2]})")
    del tr, step, batch, final, restored
    shutil.rmtree(d, ignore_errors=True)
    free_cards(cards)
    return problems


def compare_to_host(st, host, *, exact: bool = False, grad=None) -> tuple:
    """Each distinct shard of ``st`` (a ``ShardedTensor`` on the cards)
    against its block of ``host`` (the whole leaf in host memory), moved
    over in row slices of 2^20 rows. Returns (max |diff|, max |host|, the
    elements out of bounds): with ``exact`` every element that differs;
    else those past STEP_TOL, where an element whose single-device
    gradient (``grad``, host) is within RECSYS_GRAD_FLOOR of zero is held
    to 2 lr + atol instead (AdamW's first update is g / (|g| + eps))."""
    from repro_torch.distributed import partition
    from repro_torch.launch import train

    worst = top = 0.0
    bad = 0
    lr = train.LEARNING_RATE
    for g in st.holders():
        pos = g[0]
        shard = st.shards[pos].detach()
        blk = partition.block(st.shape, st.spec, st.mesh, pos)
        for lo in range(0, shard.shape[0], 1 << 20):
            sl = slice(lo, min(lo + (1 << 20), shard.shape[0]))
            got = shard[sl]
            want = host[blk][sl].to(got.device)
            d = (got.float() - want.float()).abs()
            worst = max(worst, float(d.max()))
            top = max(top, float(want.abs().max()))
            if exact:
                bad += int((got != want).sum())
                continue
            ok = d <= STEP_TOL["atol"] + STEP_TOL["rtol"] * want.abs()
            if grad is not None:
                small = grad[blk][sl].to(got.device).abs() < RECSYS_GRAD_FLOOR
                ok |= small & (d <= 2 * lr + STEP_TOL["atol"])
            bad += int((~ok).sum())
    return worst, top, bad


def check_recsys_mesh(dev, smi: str, four_cards: bool) -> None:
    """Phase 28: the recsys family on a (data, model) mesh at published
    width (``launch.train.sharded_recsys_trainer``, the reference's recsys
    plans through ``launch.steps.build_plan``).

    One card (four logical shards): dlrm-rm2 at the train_batch cell's B
    = 65,536 on 1 x 4 and 2 x 2, and xDeepFM on 1 x 4 at XDEEPFM_BATCH,
    each from the single device's seed, against the single device at step
    0's parameters (its gradients and updated leaves kept in host memory:
    one card does not hold both trainers): the loss within
    RECSYS_LOSS_RTOL, every gradient leaf within RECSYS_GRAD_TOL of its
    largest |g| (dlrm-rm2's table on 1 x 4 bit for bit), every updated
    leaf within STEP_TOL (the floor rule of ``compare_to_host``); then
    RECSYS_TIMED steps timed and dlrm-rm2's 1 x 4 step profiled. Also
    ``build_plan("dlrm-rm2", "train_batch")``'s fn beside the CLI's step,
    each from its own copy: the same loss bits; xDeepFM's reruns and a
    restart from a step-1 checkpoint: the same bits.

    Four cards (``four_cards``; the mesh must be four distinct cards):
    dlrm-rm2 at B = 65,536 on the single device (card 0) and on 1 x 4,
    RECSYS_STEPS steps of the same batches, step 0's loss within
    RECSYS_LOSS_RTOL; xDeepFM at the cell's B = 65,536 on 2 x 2 (one card
    does not hold it), RECSYS_STEPS steps, losses finite; for each ms a
    step (median of the last RECSYS_STEPS - 2), samples/s, peak GB a
    card and a profiled step's busy share a card and ``mesh.*`` share.
    Then dlrm-rm2's serve_p99 and serve_bulk plans on 2 x 2 against the
    single device's logits (rtol 1e-5, atol 1e-6), and its retrieval_cand
    plan (1,000,000 candidates), dense and zen, against the single
    device's top 100 (ids equal outside near-ties, scores within RTOL),
    each call timed beside the single device's.
    """
    import tempfile

    import torch
    from repro_torch import configs as C
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys

    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 4)
    cards = list(dict.fromkeys(mesh.devices.flat))
    if four_cards and len(cards) != 4:
        fail(f"--sharded needs a mesh of four distinct cards; "
             f"make_host_mesh(1, 4) sits on {[str(d) for d in cards]}")
    spec = C.get_arch("dlrm-rm2")
    cfg = spec.make_config()
    B = spec.cell("train_batch").dims["batch"]
    log(f"[28] the recsys family on a (data, model) mesh at published "
        f"width; {smi}; make_host_mesh(1, 4) sits on "
        f"{[str(d) for d in mesh.devices.flat]}; dlrm-rm2's table "
        f"{cfg.padded_rows:,} x {cfg.embed_dim} f32")
    del mesh

    def free():
        free_cards(cards)

    def reset():
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    def peaks():
        return [round(torch.cuda.max_memory_allocated(c) / 1e9, 2)
                for c in cards]

    def host(params):
        return {n: [s.detach().to("cpu", copy=True) for s in p.shards]
                for n, p in params.items()}

    def same(a, b):
        return all(torch.equal(x, y) for n in a for x, y in zip(a[n], b[n]))

    def later_batches(cfg, batch):
        """The batches of the timed steps after step 0."""
        make = train.batch_fn(cfg, seed=1, batch=batch["sparse"].shape[0],
                              device=dev)
        return iter([make(s) for s in range(1, RECSYS_TIMED + 1)])

    def single_reference(cfg, batch, label):
        """The single device from the trainer's seed: step 0's loss, its
        gradients and its leaves after one step, in host memory; then
        RECSYS_TIMED more steps timed."""
        reset()
        tr = train.recsys_trainer(cfg, seed=0, device=dev)
        loss, _ = recsys.loss_fn(cfg, tr.model, batch)
        g = torch.autograd.grad(loss, list(tr.params.values()))
        grads = {n: x.to("cpu", copy=True) for n, x in zip(tr.params, g)}
        del g
        loss = float(loss.detach())
        tr.step(batch)
        params = {n: p.detach().to("cpu", copy=True)
                  for n, p in tr.params.items()}
        more = later_batches(cfg, batch)
        _, step_s = timed_steps(lambda: tr.step(next(more))[0],
                                RECSYS_TIMED, cards)
        ms = float(np.median(step_s)) * 1e3
        log(f"    {label} on the single device: {ms:.1f} ms a step (median "
            f"of {RECSYS_TIMED}), peak GB {peaks()[0]}")
        del tr
        free()
        return loss, grads, params

    def against_single(cfg, shape, batch, ref, label, table_exact):
        """The mesh's step 0 against the single device's; then
        RECSYS_TIMED steps timed. Returns the trainer."""
        want_loss, want_g, want_p = ref
        reset()
        tr = train.sharded_recsys_trainer(cfg, mesh=make_host_mesh(*shape),
                                          seed=0)
        loss, _, grads = tr.reduced_grads(batch)
        loss = float(loss.detach())
        if not abs(loss - want_loss) <= RECSYS_LOSS_RTOL * abs(want_loss):
            fail(f"{label}: step 0's loss {loss} against the single "
                 f"device's {want_loss} (rtol {RECSYS_LOSS_RTOL})")
        worst = {}
        for n, g in grads.items():
            exact = table_exact and n == "table"
            err, top, bad = compare_to_host(g, want_g[n], exact=exact)
            if (exact and bad) or (not exact and
                                   err > RECSYS_GRAD_TOL * top):
                fail(f"{label}: the gradient of {n}: max |diff| {err:.3g} "
                     f"of max |g| {top:.3g}" + (f", {bad} elements not "
                                                "the single device's bits"
                                                if exact else ""))
            worst[n] = err / top if top else 0.0
        tr.apply(grads)
        del grads
        out = 0
        for n, p in tr.params.items():
            out += compare_to_host(p, want_p[n], grad=want_g[n])[2]
        if out:
            fail(f"{label}: {out} updated elements past the single "
                 f"device's (rtol {STEP_TOL['rtol']}, atol "
                 f"{STEP_TOL['atol']}; 2 lr where |g| < "
                 f"{RECSYS_GRAD_FLOOR})")
        more = later_batches(cfg, batch)
        losses, step_s = timed_steps(lambda: tr.step(next(more))[0],
                                     RECSYS_TIMED, cards)
        ms = float(np.median(step_s)) * 1e3
        rows = batch["sparse"].shape[0]
        g = max(worst, key=worst.get)
        log(f"    {label}: step 0's loss {loss:.7f} (the single device's "
            f"{want_loss:.7f}); gradients within {worst[g]:.3g} of their "
            f"leaf's largest |g| (the worst, {g})"
            + ("; the table's gradient the single device's bits"
               if table_exact else f"; the table's {worst['table']:.3g}")
            + f"; every updated leaf within the step tolerance; "
            f"{ms:.1f} ms a step (median of {RECSYS_TIMED}), "
            f"{rows / ms * 1e3:,.0f} samples/s, peak GB {peaks()[0]}")
        return tr

    if four_cards:
        check_recsys_cards(cfg, spec, cards, smi)
        log(f"    phase 28: {time.perf_counter() - t0:.1f} s")
        return

    # -- dlrm-rm2 at B = 65,536: 1 x 4 and 2 x 2 against the single device -----
    batch = train.batch_fn(cfg, seed=0, batch=B, device=dev)(0)
    free()
    ref = single_reference(cfg, batch, f"dlrm-rm2 at B = {B:,}")
    for shape in ((1, 4), (2, 2)):
        tr = against_single(cfg, shape, batch, ref,
                            f"dlrm-rm2 on {shape[0]} x {shape[1]}",
                            table_exact=shape[0] == 1)
        if shape == (1, 4):
            _mesh_profile(lambda: tr.step(batch), "one dlrm-rm2 step on 1 x 4",
                          cards)
        del tr
        free()
    del ref

    # the plan's step and the CLI's step, each from its own copy
    plan = steps_lib.build_plan("dlrm-rm2", "train_batch")
    out = {}
    for label in ("plan", "cli"):
        tr = train.sharded_recsys_trainer(cfg, mesh=make_host_mesh(1, 4),
                                          seed=0)
        if label == "plan":
            out[label] = float(plan.fn(tr.params, tr.opt_state,
                                       batch)[2]["loss"])
        else:
            out[label] = float(tr.step(batch)[0])
        del tr
        free()
    if out["plan"] != out["cli"]:
        fail(f"dlrm-rm2: the plan's loss {out['plan']} is not the CLI "
             f"step's {out['cli']}")
    log(f"    build_plan('dlrm-rm2', 'train_batch') on 1 x 4, each step from "
        f"its own copy: the plan's loss {out['plan']:.7f}, the CLI step's "
        f"the same bits")
    del batch

    # -- xDeepFM at XDEEPFM_BATCH on 1 x 4; reruns and a restart -------------
    xcfg = C.get_arch("xdeepfm").make_config()
    make = train.batch_fn(xcfg, seed=0, batch=XDEEPFM_BATCH, device=dev)
    batch = make(0)
    ref = single_reference(xcfg, batch, f"xdeepfm at B = {XDEEPFM_BATCH:,}")
    tr = against_single(xcfg, (1, 4), batch, ref,
                        f"xdeepfm on 1 x 4 at B = {XDEEPFM_BATCH:,}",
                        table_exact=False)
    del tr, ref
    free()
    d = tempfile.mkdtemp()
    runs = []
    for label in ("run", "rerun", "restart"):
        tr = train.sharded_recsys_trainer(xcfg, mesh=make_host_mesh(1, 4),
                                          seed=0)
        if label == "restart":
            step, tree = CheckpointManager(d).restore(
                like=tr.state_tree(), mesh=tr.mesh)
            tr.load_state_tree(tree)
            del tree
            losses = [None, float(tr.step(make(1))[0])]
        else:
            losses = [float(tr.step(make(0))[0])]
            if label == "run":
                CheckpointManager(d).save(1, tr.state_tree(),
                                          tr.state_specs())
            losses.append(float(tr.step(make(1))[0]))
        runs.append((losses, host(tr.params)))
        del tr
        free()
    shutil.rmtree(d, ignore_errors=True)
    (la, pa), (lb, pb), (lc, pc) = runs
    if la != lb or not same(pa, pb) or lc[1] != la[1] or not same(pa, pc):
        fail(f"xdeepfm on 1 x 4: a run {la}, a rerun {lb}, a restart from "
             f"step 1 {lc[1:]}: not the same bits")
    log(f"    xdeepfm on 1 x 4: a rerun's 2 steps {lb} and a restart from the "
        f"step-1 checkpoint's step {lc[1]:.7f}: the same bits (losses and "
        f"every parameter shard)")
    del runs, pa, pb, pc, batch
    free()
    log(f"    phase 28: {time.perf_counter() - t0:.1f} s")


def check_recsys_cards(cfg, spec, cards, smi: str) -> None:
    """Phase 28 on four cards (``check_recsys_mesh``): dlrm-rm2 on 1 x 4
    beside the single device, xDeepFM at B = 65,536 on 2 x 2, then
    dlrm-rm2's serve and retrieval plans on 2 x 2 against the single
    device. Every failed gate is reported, then the phase fails once."""
    import torch
    from repro_torch import configs as C
    from repro_torch.core.metrics import euclidean_pdist
    from repro_torch.core.simplex import apex_project, build_base_simplex
    from repro_torch.core.zen import estimate_pdist
    from repro_torch.distributed import partition
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys
    from repro_torch.testing import topk_mismatch

    dev = cards[0]
    problems = []

    def peaks():
        return [round(torch.cuda.max_memory_allocated(c) / 1e9, 2)
                for c in cards]

    def reset():
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    def train_leg(arch_cfg, label, B, make_tr):
        free_cards(cards)
        reset()
        make = train.batch_fn(arch_cfg, seed=0, batch=B, device=dev)
        batches = [make(s) for s in range(RECSYS_STEPS)]
        tr = make_tr()
        it = iter(batches)
        losses, step_s = timed_steps(lambda: tr.step(next(it))[0],
                                     RECSYS_STEPS, cards)
        ms = float(np.median(step_s[2:])) * 1e3
        peak = peaks()
        prof = (_mesh_profile(lambda: tr.step(batches[0]), f"one {label} "
                              "step", cards)
                if hasattr(tr, "mesh") else None)
        if not np.isfinite(losses).all():
            problems.append(f"{label}: losses {losses}")
        log(f"    {label}: {ms:.2f} ms a step (median of the last "
            f"{RECSYS_STEPS - 2}; every step "
            f"{np.round(np.asarray(step_s) * 1e3, 2).tolist()} ms), "
            f"{B / ms * 1e3:,.0f} samples/s, peak GB a card {peak}; losses "
            f"{np.round(losses, 6).tolist()}")
        del tr, batches
        free_cards(cards)
        return losses, ms, prof

    B = spec.cell("train_batch").dims["batch"]
    one, one_ms, _ = train_leg(
        cfg, f"dlrm-rm2 at B = {B:,} on the single device ({dev})", B,
        lambda: train.recsys_trainer(cfg, seed=0, device=dev))
    mesh_l, mesh_ms, _ = train_leg(
        cfg, f"dlrm-rm2 at B = {B:,} on 1 x 4 (four cards)", B,
        lambda: train.sharded_recsys_trainer(cfg, mesh=make_host_mesh(1, 4),
                                             seed=0))
    if not abs(mesh_l[0] - one[0]) <= RECSYS_LOSS_RTOL * abs(one[0]):
        problems.append(f"dlrm-rm2 on 1 x 4: step 0's loss {mesh_l[0]} "
                        f"against the single device's {one[0]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_l, one))
    log(f"    dlrm-rm2 on 1 x 4 against the single device: {mesh_ms:.2f} "
        f"against {one_ms:.2f} ms a step ({one_ms / mesh_ms:.2f}x); losses "
        f"within {rel:.3g} relative over {RECSYS_STEPS} steps")
    xcfg = C.get_arch("xdeepfm").make_config()
    train_leg(xcfg, f"xdeepfm at B = {B:,} on 2 x 2 (four cards)", B,
              lambda: train.sharded_recsys_trainer(
                  xcfg, mesh=make_host_mesh(2, 2), seed=0))

    # -- serve and retrieval on 2 x 2 against the single device ---------------
    model = recsys.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0))
    whole = {n: p.detach() for n, p in model.named_parameters()}
    mesh = make_host_mesh(2, 2)

    def timed_call(fn, n=5):
        out, ts = None, []
        for _ in range(n):
            sync_cards(cards)
            t = time.perf_counter()
            out = fn()
            sync_cards(cards)
            ts.append(time.perf_counter() - t)
        return out, float(np.median(ts)) * 1e3

    with torch.no_grad():
        for cell in ("serve_p99", "serve_bulk"):
            n = spec.cell(cell).dims["batch"]
            batch = {k: v for k, v in train.batch_fn(
                cfg, seed=7, batch=n, device=dev)(0).items()
                if k != "labels"}
            plan = steps_lib.build_plan("dlrm-rm2", cell)
            placed = steps_lib.place_args(plan, mesh, whole)
            want, one_ms = timed_call(lambda: recsys.forward(cfg, model,
                                                             batch))
            got, ms = timed_call(lambda: plan.fn(placed, batch))
            got = got.gather(dev)
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
            if not ok:
                problems.append(f"{cell} on 2 x 2: logits off the single "
                                f"device's by {float((got - want).abs().max()):.3g}")
            log(f"    {cell} (B = {n:,}) on 2 x 2: logits "
                f"{'within' if ok else 'NOT within'} rtol 1e-5 / atol 1e-6 "
                f"of the single device's (max |diff| "
                f"{float((got - want).abs().max()):.3g}); {ms:.3f} ms a "
                f"call against the single device's {one_ms:.3f} "
                f"(median of 5)")
            del placed, batch, got, want
        n_cand = spec.cell("retrieval_cand").dims["n_candidates"]
        gen = torch.Generator(device=dev).manual_seed(11)
        cands = torch.randn((n_cand, cfg.embed_dim), generator=gen,
                            device=dev)
        batch = {k: v for k, v in train.batch_fn(
            cfg, seed=8, batch=spec.cell("retrieval_cand").dims["batch"],
            device=dev)(0).items() if k != "labels"}
        q = recsys.user_repr(cfg, model, batch)
        for mode in ("dense", "zen"):
            plan = steps_lib.build_plan("dlrm-rm2", "retrieval_cand",
                                        overrides={"retrieval_mode": mode})
            placed = steps_lib.place_args(plan, mesh, whole)
            if mode == "dense":
                index = partition.place(cands, plan.in_specs[2], mesh)

                def single():
                    return recsys.retrieval_topk(
                        recsys.user_repr(cfg, model, batch), cands, 100)
            else:
                k = cfg.zen_k
                refs = cands[torch.randperm(n_cand, generator=gen,
                                            device=dev)[:k]]
                base = build_base_simplex(euclidean_pdist(refs, refs))
                coords = apex_project(base, euclidean_pdist(cands, refs))
                index = {"coords": partition.place(
                    coords, plan.in_specs[2]["coords"], mesh), "refs": refs,
                    "chol": base.chol, "diag_g": base.diag_g, "d0": base.d0}

                def single():
                    qp = apex_project(base, euclidean_pdist(
                        recsys.user_repr(cfg, model, batch), refs))
                    dd = estimate_pdist(qp, coords, "zen")
                    v, i = torch.sort(dd, dim=1, stable=True)
                    return v[:, :100], i[:, :100].to(torch.int32)
            (wd, wi), one_ms = timed_call(single)
            got, ms = timed_call(lambda: plan.fn(placed, batch, index))
            sign = -1.0 if mode == "dense" else 1.0
            scale = float(wd.abs().max())
            msg = topk_mismatch(sign * got["scores"], got["ids"], sign * wd,
                                wi, rtol=RTOL, atol=RTOL * scale)
            if msg is not None:
                problems.append(f"retrieval_cand {mode} on 2 x 2: {msg}")
            log(f"    retrieval_cand {mode} ({n_cand:,} candidates, B = "
                f"{q.shape[0]}) on 2 x 2: the top 100 "
                f"{'equal' if msg is None else 'NOT equal'} to the single "
                f"device's outside near-ties (ids bit-equal: "
                f"{torch.equal(got['ids'], wi)}); {ms:.3f} ms a call "
                f"against the single device's {one_ms:.3f} (median of 5)")
            del placed, index
    del model, whole, cands
    free_cards(cards)
    if problems:
        fail("; ".join(problems))


def draw_cache(out, p: int, kv: int, g: int, rows, lo: int, slen: int
               ) -> None:
    """Fill ``out`` (len(rows), n, KV, dh), rows ``rows`` and positions
    ``lo .. lo + n - 1`` of layer group ``g`` of the cache leaf pos{p}
    (``kv`` 0 for k, 1 for v), from one normal draw a (leaf, group, row,
    unit), a unit a 1 / SERVE_UNITS of the sequence. So a shard's block
    and the single device's whole rows hold the same values."""
    import torch

    U = slen // SERVE_UNITS
    for r, row in enumerate(rows):
        for u in range(lo // U, (lo + out.shape[1]) // U):
            seed = (((((29 * 8 + p) * 2 + kv) * 64 + g) * 1024 + row)
                    * SERVE_UNITS + u)
            gen = torch.Generator(device=out.device).manual_seed(seed)
            out[r, u * U - lo:(u + 1) * U - lo].copy_(torch.randn(
                (U,) + tuple(out.shape[2:]), generator=gen,
                device=out.device, dtype=out.dtype))


def drawn_cache(cfg, mesh, spec, batch: int, seq_len: int) -> dict:
    """A decode cell's KV cache of ``batch`` rows laid out on ``mesh`` by
    ``spec``, each block drawn on its device (``draw_cache``)."""
    import torch
    from repro_torch.distributed import partition

    G, KV, dh = cfg.n_groups, cfg.n_kv_heads, cfg.head_dim
    cache = {}
    for p, w in enumerate(cfg.layer_pattern):
        slen = min(w, seq_len) if w else seq_len
        shape = (G, batch, slen, KV, dh)
        for kv, name in enumerate(("k", "v")):
            shards = []
            for pos in range(mesh.size):
                b = partition.block(shape, spec, mesh, pos)
                t = torch.empty(tuple(s.stop - s.start for s in b),
                                dtype=cfg.dtype,
                                device=mesh.devices.flat[pos])
                for g in range(G):
                    draw_cache(t[g], p, kv, g, range(b[1].start, b[1].stop),
                               b[2].start, slen)
                shards.append(t)
            cache.setdefault(f"pos{p}", {})[name] = partition.ShardedTensor(
                mesh, spec, shape, cfg.dtype, shards)
    return cache


def check_lm_serve_mesh(dev, smi: str, four_cards: bool) -> None:
    """Phase 29: the LM's prefill and decode plans on a (data, model) mesh
    (``launch.steps.build_plan(arch, cell)``, ``transformer.
    sharded_prefill`` / ``sharded_decode_step``, ``moe.moe_ffn_sharded``)
    for each of SERVE_ARCHS at published width on 2 x 2, one placed set of
    weights an architecture for every cell (``serve_legs``): in bf16 at
    the published depth (on one card at SERVE_ONE_CARD_LAYERS), then at
    SERVE_CHECK_LAYERS in f32.

    prefill_32k at S = 32,768 and SERVE_PREFILL_B rows (B = 32 too on four
    cards when that took under SERVE_BIG_S): ms a call, the bf16-peak
    share (``launch/model_flops.py``'s prefill term over 989 TFLOP/s a
    card), peak GB a card; rows 0-1's logits and cache against the single
    device's ``transformer.prefill``. long_500k, where the plan runs it
    (gemma2-2b; the full-attention architectures' plan carries a skip):
    B = 1, SERVE_STEPS steps from SERVE_LONG_LEN, against the same plan on
    a 1 x 1 mesh on card 0. decode_32k at the cell's B = 128 (or the
    largest even batch whose cache fits with SERVE_MARGIN left, the cut
    logged), its cache drawn shard by shard on its card, SERVE_STEPS steps
    from cache_len SERVE_DECODE_LEN: a dense model's rows 0..SERVE_REF_ROWS
    - 1 against the single device's ``decode_step`` on their slice of the
    same cache; an MoE model's every row against the single device
    decoding the same B rows (its group is the whole batch; at
    SERVE_CHECK_LAYERS), with the slot hand-offs between the data replicas
    and the dropped assignments logged. Each decode cell's ms a step beside
    its bytes bound (a card's cache block and weights over 3.35 TB/s) and
    peak GB a card. A prompt through ``sharded_prefill(pad_to=)`` and
    SERVE_STEPS steps of the decode plan, each step's logits against the
    single device's forward at that position (an MoE model's: against the
    single device's own prefill -> decode chain), run twice: the same bits.

    The comparisons with the single device, the chain's rerun and a
    planted fault are gated at SERVE_CHECK_LAYERS in f32 (see there); at
    the published depth in bf16 the readings are logged, on four cards.
    On one card the bf16 cells run at a cut depth, without the single
    device. With ``four_cards`` the mesh must be four distinct cards."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    mesh = make_host_mesh(*SERVE_MESH)
    cards = list(dict.fromkeys(mesh.devices.flat))
    if four_cards and len(cards) != 4:
        fail(f"--sharded needs a mesh of four distinct cards; "
             f"make_host_mesh{SERVE_MESH} sits on {[str(d) for d in cards]}")
    archs = SERVE_ARCHS[four_cards]
    log(f"[29] the LM's prefill and decode plans on a (data, model) mesh, "
        f"{', '.join(archs)} at published width; {smi}; "
        f"make_host_mesh{SERVE_MESH} sits on "
        f"{[str(d) for d in mesh.devices.flat]}")
    problems = []
    for arch in archs:
        ta = time.perf_counter()
        spec = C.get_arch(arch)
        cfg = spec.make_config()
        ffn = (f"MoE {cfg.n_experts} experts of {cfg.moe_d_ff}, top-"
               f"{cfg.top_k}, groups of {cfg.moe_group_size}, capacity "
               f"factor {cfg.capacity_factor}" if cfg.is_moe
               else f"dense FFN of {cfg.d_ff}")
        depth = cfg.n_layers if four_cards else SERVE_ONE_CARD_LAYERS[arch]
        log(f"    {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
            f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, {ffn}, "
            f"{cfg.dtype}; the bf16 cells at {depth} of its "
            f"{cfg.n_layers} layers"
            + ("" if four_cards else " (cut for the smoke run's time "
               "limit)"))
        serve_legs(spec, dataclasses.replace(cfg, n_layers=depth), mesh,
                   four_cards, problems, gate=False)
        tb = time.perf_counter()
        serve_legs(spec, dataclasses.replace(
            cfg, n_layers=SERVE_CHECK_LAYERS, dtype=torch.float32),
            mesh, four_cards, problems, gate=True)
        log(f"    {arch}: {time.perf_counter() - ta:.1f} s ({tb - ta:.1f} "
            f"in bf16, {time.perf_counter() - tb:.1f} at "
            f"{SERVE_CHECK_LAYERS} layers in f32)")
    log(f"    phase 29: {time.perf_counter() - t0:.1f} s")
    if problems:
        fail("; ".join(problems))


def serve_legs(spec, cfg, mesh, four_cards: bool, problems: list, *,
               gate: bool) -> None:
    """Phase 29's cells (``check_lm_serve_mesh``) for ``cfg`` on ``mesh``.
    With ``gate`` a comparison with the single device outside ``testing.
    bf16_lm_mismatch``'s bounds or DECODE_TOL's for ``cfg.dtype`` is
    appended to ``problems``, and so is a planted fault that reads within
    them; without, the readings against ``bf16_lm_mismatch`` are logged.
    Without ``gate`` on one card the cells run alone (the chain once, no
    single device beside them).

    An MoE decode step's group is the batch's B tokens, spread over the
    data replicas, so its capacity and its drops are the whole batch's: the
    single device decodes the mesh's B rows (with ``gate``, after the mesh,
    from the same drawn cache), the chain is held to the single device's
    own prefill -> decode chain (forward groups a sequence's tokens
    instead) and the mesh's slot hand-offs and dropped assignments are
    logged (``moe.recording``): hand-offs > 0 always, drops > 0 with
    ``gate``. Where the long_500k plan carries a ``skip`` the cell does not
    run, and the planted fault is decode_32k's steps at a position one
    ahead."""
    import torch
    from repro_torch import testing
    from repro_torch.distributed import partition
    from repro_torch.launch import model_flops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer

    arch = spec.arch_id
    cards = list(dict.fromkeys(mesh.devices.flat))
    card0 = cards[0]
    depth = f"{cfg.n_layers} layers in {str(cfg.dtype)[6:]}"
    depth_of = {"n_layers": cfg.n_layers, "dtype": cfg.dtype}
    single_too = gate or four_cards
    steps = SERVE_STEPS
    tol_max, tol_mean = DECODE_TOL[str(cfg.dtype)]

    def tolerance(want) -> tuple:
        """DECODE_TOL's bounds, read on gemma2-2b's logits (at most
        SERVE_TOL_SCALE, its softcap), scaled down by the largest |want|
        where that is smaller: a tensor of smaller values is held as
        tightly for its scale, never looser (granite-8b's logits at 2
        layers reach 5.3)."""
        f = min(1.0, float(want.abs().max()) / SERVE_TOL_SCALE)
        return tol_max * f, tol_mean * f
    glob = f"pos{cfg.layer_pattern.index(0)}"  # a global layer's cache
    free_cards(cards)

    def reset():
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    def peaks():
        return [round(torch.cuda.max_memory_allocated(c) / 1e9, 2)
                for c in cards]

    def run_timed(fn):
        sync_cards(cards)
        t = time.perf_counter()
        out = fn()
        sync_cards(cards)
        return out, (time.perf_counter() - t) * 1e3

    def real(logits):
        """The vocabulary's columns of (..., padded vocabulary) logits (the
        padding's are -1e30 on both sides)."""
        return logits[..., :cfg.vocab_size]

    def compare(label, got, want, record: bool = True):
        """``testing.bf16_lm_mismatch``'s logits bounds on any two tensors
        and, with ``gate``, DECODE_TOL's; the readings (max |diff|, mean
        |diff|, max |want|) and why they are outside, or None. Logits are
        compared over the vocabulary's columns."""
        if got.shape[-1] == cfg.padded_vocab:
            got, want = real(got), real(want)
        mx, mean, scale, _ = testing._max_and_mean_diff(got, want)
        msg = testing.bf16_lm_mismatch(got, 0.0, {}, want, 0.0, {})
        t_max, t_mean = tolerance(want)
        if msg is None and gate and not (mx <= t_max and mean <= t_mean):
            msg = (f"max |diff| {mx:.4g} (tolerance {t_max:.4g}), mean "
                   f"{mean:.4g} (tolerance {t_mean:.4g})")
        if msg and gate and record:
            problems.append(f"{arch} {label} at {depth}: {msg}")
        return (mx, mean, scale), msg

    def verdict(msg) -> str:
        return ("within the bounds" if msg is None else
                "outside the bounds" + (": FAILS" if gate else
                                        " (logged at this depth)"))

    def card_bytes(tensors, card) -> int:
        return sum(t.numel() * t.element_size() for t in tensors
                   if t.device == card)

    def first_rows(st, rows: int, dim: int = 0):
        """Rows 0..rows - 1 (along ``dim``) of a ShardedTensor, whole on
        card 0, each block from its first holder."""
        shape = list(st.shape)
        shape[dim] = rows
        out = torch.empty(shape, dtype=st.dtype, device=card0)
        for g in st.holders():
            b = list(partition.block(st.shape, st.spec, st.mesh, g[0]))
            lo, hi = b[dim].start, min(b[dim].stop, rows)
            if lo < hi:
                b[dim] = slice(lo, hi)
                out[tuple(b)] = st.shards[g[0]].narrow(dim, 0, hi - lo).to(
                    card0)
        return out

    def single_model():
        """The single device's model on card 0: the mesh's weights
        gathered whole (no f32 draw beside them: qwen2-moe's 28.6 GB at
        24 layers and a 17.7 GB f32 expert leaf do not fit beside its
        shard)."""
        m = transformer.Transformer(cfg, device="meta")
        m.load_state_dict({n: st.gather(card0) for n, st in params.items()},
                          assign=True)
        return m.requires_grad_(False)

    def fault_verdict(label, rf, msg):
        log(f"    {label} at {depth}, a planted fault (each step's "
            f"position one ahead): max |diff| {rf[0]:.4g}, mean "
            f"{rf[1]:.4g}: " + ("past the bounds" if msg else
                                "WITHIN the bounds: FAILS"))
        if msg is None:
            problems.append(f"{arch} {label} at {depth}: the comparison "
                            "cannot see a planted fault (positions one "
                            "ahead)")

    def prefill_routes(routes, inputs, toks):
        """An MoE prefill's comparison at the gated depth, whose data
        replicas hold a row each (``toks``): the mesh's expert assignments
        layer by layer (each replica's, its model shards' equal) against
        the single device's own on the same rows (C7's check: every token
        routed otherwise a near-tie the inputs' difference explains);
        returns ``testing.routed_as`` for the single device, so that the
        compared prefill takes the mesh's experts (and so its drops) and
        differs by arithmetic alone."""
        M, D_ = mesh.shape["model"], mesh.shape["data"]
        per = M * D_
        if len(routes) != per * cfg.n_layers or len(toks) != D_:
            fail(f"{arch}: {len(routes)} routings of {len(toks)} rows on "
                 f"the mesh, not {per * cfg.n_layers} of {D_}")
        single_in = []
        with testing.recorded_routes([], single_in) as own, torch.no_grad():
            transformer.prefill(cfg, single, toks.to(card0))
        mine, entries, labels = [], ([], [], [], []), []
        for layer in range(cfg.n_layers):
            calls = routes[layer * per:(layer + 1) * per]
            if not all(torch.equal(calls[d * M + m].to(card0),
                                   calls[d * M].to(card0))
                       for d in range(D_) for m in range(M)):
                fail(f"{arch}: the model shards route differently")
            mine.append(torch.cat([calls[d * M].to(card0)
                                   for d in range(D_)]))
            n = len(mine[-1]) // D_  # a row's groups
            xs, w = single_in[layer]
            for d in range(D_):
                x, wm = inputs[layer * per + d * M]
                for e, t in zip(entries, ((x.to(card0), wm.to(card0)),
                                          mine[-1][d * n:(d + 1) * n],
                                          (xs[d * n:(d + 1) * n], w),
                                          own[layer][d * n:(d + 1) * n])):
                    e.append(t)
                labels.append(f"layer {layer} row {d}")
        agree = [float((m == r).float().mean()) for m, r in zip(mine, own)]
        log(f"    prefill_32k at {depth}, rows 0-{D_ - 1}: the mesh's expert "
            f"assignments (tokens x top-{cfg.top_k}) against the single "
            f"device's own, layer by layer: {[f'{a:.6f}' for a in agree]} "
            "equal; the single device compared below takes the mesh's "
            "experts")
        check_route_flips(cfg, *entries, labels=labels)
        return testing.routed_as(single, mine)

    bounds = (f"bounds {testing.BF16_LOGITS_TOL:.4g} and mean "
              f"{testing.BF16_LOGITS_MEAN_TOL:.4g} of the largest"
              + (f", max {tol_max} and mean {tol_mean} scaled by the "
                 f"largest |value| / {SERVE_TOL_SCALE:g} where under 1"
                 if gate else ""))
    model = transformer.init_sharded(cfg, mesh, generator=torch.Generator(
        device=card0).manual_seed(29))
    params = model.params
    for st in params.values():
        for s in st.shards:
            s.requires_grad_(False)
    w_card = [card_bytes([s for st in params.values() for s in st.shards], c)
              for c in cards]
    single = None  # built where first needed: after the mesh's prefill

    # -- prefill_32k ---------------------------------------------------------
    S = spec.cell("prefill_32k").dims["seq_len"]
    cell_b = spec.cell("prefill_32k").dims["global_batch"]
    plan = steps_lib.build_plan(arch, "prefill_32k", overrides=depth_of)
    flops = model_flops.estimate(arch, "prefill_32k", cfg)[
        "model_flops_global"]
    sizes = [SERVE_PREFILL_B[four_cards and not gate]]
    for B in sizes:
        toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(B))
        (tokens,) = steps_lib.place_inputs(plan, mesh, toks)
        free_cards(cards)
        reset()
        # the gated MoE comparison: the mesh's routes and router inputs
        forced = gate and cfg.is_moe and B == sizes[0]
        mesh_in = []
        try:
            with (testing.recorded_routes([], mesh_in) if forced
                  else contextlib.nullcontext([])) as routes:
                (logits, cache), ms = run_timed(lambda: plan.fn(params,
                                                                tokens))
        except torch.OutOfMemoryError as e:
            log(f"    prefill_32k at {depth}, B = {B}: does not fit 2 x 2 "
                f"({str(e).splitlines()[0]})")
            free_cards(cards)
            continue
        share = flops * B / cell_b / (ms / 1e3 * PEAK_BF16_FLOPS * len(cards))
        log(f"    prefill_32k at {depth}: B = {B} "
            + (f"(the cell's {cell_b} cut for the phase's time)"
               if B < cell_b else "(the cell's)")
            + f", S = {S:,}: {ms:.1f} ms a call, "
            f"{B * S / ms * 1e3:,.0f} tokens/s, {share:.2%} of the bf16 "
            f"peak, peak GB a card {peaks()}; logits {logits.spec}, cache "
            f"{cache[glob]['k'].spec}, a card's global-layer k block "
            f"{tuple(cache[glob]['k'].shards[0].shape)}")
        if B == sizes[0] and single_too and cfg.is_moe and not gate:
            log(f"    prefill_32k at {depth}: not against the single device "
                "(its model does not fit beside the mesh's prefill on card "
                "0 at this depth; in bf16 its tokens route otherwise too)")
        elif B == sizes[0] and single_too:
            if single is None:
                single = single_model()
            routing = contextlib.nullcontext()
            if forced:
                routing = prefill_routes(routes, mesh_in, toks)
            del routes, mesh_in
            with routing, torch.no_grad():
                w_lg, w_cache = transformer.prefill(cfg, single,
                                                    toks[:2].to(card0))
            r, msg = compare("prefill_32k rows 0-1 logits",
                             first_rows(logits, 2), w_lg)
            worst, bad = ("logits", r), [msg]
            for p in range(cfg.pattern_len):
                for name in ("k", "v"):
                    rc, msg = compare(
                        f"prefill_32k rows 0-1 cache pos{p}.{name}",
                        first_rows(cache[f"pos{p}"][name], 2, 1),
                        w_cache[f"pos{p}"][name])
                    bad.append(msg)
                    if rc[0] / rc[2] > worst[1][0] / worst[1][2]:
                        worst = (f"cache pos{p}.{name}", rc)
            log(f"    prefill_32k at {depth}, rows 0-1 against the single "
                f"device's prefill: logits max |diff| {r[0]:.4g}, mean "
                f"{r[1]:.4g} (largest |logit| {r[2]:.4g}); the worst of "
                f"logits and cache leaves for its largest value: {worst[0]},"
                f" max {worst[1][0]:.4g} of {worst[1][2]:.4g} ({bounds}): "
                + verdict(next((m for m in bad if m), None)))
            del w_lg, w_cache
        if four_cards and not gate and ms < SERVE_BIG_S * 1e3 and \
                B < SERVE_PREFILL_BIG:
            sizes.append(SERVE_PREFILL_BIG)
        del logits, cache, tokens
    free_cards(cards)
    if single is None:
        single = single_model()

    # -- long_500k: the 1 x 1 mesh on card 0, then 2 x 2 ---------------------
    plan = steps_lib.build_plan(arch, "long_500k", overrides=depth_of)
    long_skip = plan.skip
    if long_skip:
        log(f"    long_500k: not run, the plan's skip: "
            f"{long_skip.split(':')[0]}")
    else:
        L0, Sl = SERVE_LONG_LEN, spec.cell("long_500k").dims["seq_len"]
        toks = torch.randint(0, cfg.vocab_size, (steps, 1, 1),
                             dtype=torch.int32,
                             generator=torch.Generator().manual_seed(500))
        mesh11 = make_host_mesh(1, 1)
        params11 = {n: partition.ShardedTensor(
            mesh11, plan.in_specs[0][n], tuple(t.shape), t.dtype, [t])
            for n, t in single.named_parameters()}
        out = {}
        legs = (("1 x 1", mesh11, params11), ("2 x 2", mesh, params))
        for label, m_, prm in legs[0 if single_too else 1:]:
            m_cards = list(dict.fromkeys(m_.devices.flat))
            free_cards(cards)
            cache = drawn_cache(cfg, m_, plan.in_specs[1]["pos0"]["k"], 1,
                                Sl)
            reset()
            got, step_ms = [], []
            for j in range(steps):
                (lg, cache), ms = run_timed(lambda: plan.fn(
                    prm, cache, toks[j], L0 + j))
                got.append(first_rows(lg, 1).to("cpu"))
                step_ms.append(ms)
            pk = peaks()[:len(m_cards)]
            c_bytes = [card_bytes([s for c in cache.values()
                                   for st in c.values() for s in st.shards],
                                  c) for c in m_cards]
            w_bytes = [card_bytes([s for st in prm.values()
                                   for s in st.shards], c) for c in m_cards]
            bound = max(c + w for c, w in zip(c_bytes, w_bytes)) / \
                PEAK_BYTES_S
            prof = (_mesh_profile(lambda: plan.fn(prm, cache, toks[-1],
                                                  L0 + steps - 1),
                                  f"one long_500k step on {label} at {depth}",
                                  m_cards)
                    if label == "2 x 2" and not gate else None)
            out[label] = torch.stack(got)
            log(f"    long_500k at {depth} on {label}: B = 1, the cache's "
                f"{Sl:,} positions ({sum(c_bytes) / 1e9:.2f} GB, "
                f"{max(c_bytes) / 1e9:.2f} GB a card) from cache_len "
                f"{L0:,}, {steps} steps: {np.median(step_ms):.2f} ms a step "
                f"(median; {min(step_ms):.2f}-{max(step_ms):.2f}) against "
                f"its bytes bound {bound * 1e3:.3f} ms (a card's cache block "
                f"and weights over 3.35 TB/s), peak GB a card {pk}"
                + (f"; busy share {prof['busy_share']:.1%}" if prof else ""))
            del cache, lg
        if single_too:
            r, msg = compare("long_500k 2 x 2 against 1 x 1", out["2 x 2"],
                             out["1 x 1"])
            log(f"    long_500k at {depth}: 2 x 2 against 1 x 1 over {steps} "
                f"steps: max |diff| {r[0]:.4g}, mean {r[1]:.4g} (largest "
                f"|logit| {r[2]:.4g}; {bounds}): {verdict(msg)}")
        if gate:
            cache = drawn_cache(cfg, mesh, plan.in_specs[1]["pos0"]["k"], 1,
                                Sl)
            got = []
            for j in range(steps):
                lg, cache = plan.fn(params, cache, toks[j], L0 + j + 1)
                got.append(first_rows(lg, 1).to("cpu"))
            rf, msg = compare("", torch.stack(got), out["1 x 1"],
                              record=False)
            fault_verdict("long_500k", rf, msg)
            del cache, lg
        del params11, out
        free_cards(cards)

    # -- prefill -> decode on the mesh ----------------------------------------
    plan = steps_lib.build_plan(arch, "decode_32k", overrides=depth_of)
    Pn, Pad = ((SERVE_MOE_CHAIN_PROMPT, SERVE_MOE_CHAIN_PAD) if cfg.is_moe
               else (SERVE_CHAIN_PROMPT, SERVE_CHAIN_PAD))
    Bc = SERVE_CHAIN_B
    toks = torch.randint(0, cfg.vocab_size, (Bc, Pad), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(6000))
    with torch.no_grad():
        if cfg.is_moe:  # the single device's own prefill -> decode chain
            lg, c = transformer.prefill(cfg, single, toks[:, :Pn].to(card0),
                                        pad_to=Pad)
            want = [lg]
            for j in range(steps):
                lg, c = transformer.decode_step(
                    cfg, single, c, toks[:, Pn + j:Pn + j + 1].to(card0),
                    Pn + j)
                want.append(lg)
            want = torch.stack(want, 1)
            del c, lg
        else:
            x = transformer._embed(cfg, single, toks.to(card0))
            x = transformer._final_hidden(
                cfg, single, x, transformer._positions(Bc, Pad, card0),
                remat=False)
            want = transformer._lm_logits(cfg, single,
                                          x[:, Pn - 1:Pn + steps])
            del x
    runs = []
    for _ in range(2 if single_too else 1):
        (lg, cache), pre_ms = run_timed(
            lambda: transformer.sharded_prefill(cfg, model, toks[:, :Pn],
                                                pad_to=Pad))
        got, step_ms = [lg.gather(card0)], []
        for j in range(steps):
            n = Pn + j
            (lg, cache), ms = run_timed(lambda: plan.fn(
                params, cache, toks[:, n:n + 1], n))
            got.append(lg.gather(card0))
            step_ms.append(ms)
        runs.append((torch.stack(got, 1), {
            f"{p}.{k}": [s.to("cpu", copy=True) for s in st.shards]
            for p, c in cache.items() for k, st in c.items()}))
        del cache, lg
    got, want = real(runs[0][0]), real(want)
    diff = (got - want).abs()
    same = len(runs) == 2 and torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for k in runs[0][1]
        for a, b in zip(runs[0][1][k], runs[1][1][k]))
    c_max, c_mean = tolerance(want)
    sound = bool(torch.isfinite(got).all() and diff.max() <= c_max
                 and diff.mean() <= c_mean)
    chain_gated = gate or arch == SERVE_BF16_CHAIN
    log(f"    prefill -> decode at {depth} on 2 x 2: a {Pn:,}-token prompt "
        f"(B = {Bc}) through sharded_prefill(pad_to={Pad:,}) in "
        f"{pre_ms:.1f} ms, then {steps} decode steps "
        f"({np.median(step_ms):.2f} ms a step, median): logits against the "
        + ("single device's own prefill -> decode chain" if cfg.is_moe
           else "single device's forward")
        + f" at each position max |diff| {float(diff.max()):.4g} "
        f"(tolerance {c_max:.4g}), mean {float(diff.mean()):.4g} (tolerance "
        f"{c_mean:.4g}), the same argmax at "
        f"{int((got.argmax(-1) == want.argmax(-1)).sum())} of "
        f"{got.shape[0] * got.shape[1]}"
        + ("" if chain_gated else (" (logged: DECODE_TOL's bf16 bounds "
                                   f"were read on {SERVE_BF16_CHAIN})"))
        + ("" if len(runs) == 1 else "; a rerun " + (
            "the same bits (logits and cache)" if same else
            "NOT the same bits")))
    if chain_gated and not sound:
        problems.append(f"{arch} the chain's logits at {depth} differ from "
                        f"the single device's: max {float(diff.max()):.4g}, "
                        f"mean {float(diff.mean()):.4g}")
    if len(runs) == 2 and not same:
        problems.append(f"{arch} the chain's rerun at {depth} is not the "
                        "same bits")
    del runs, got, want, diff

    # -- decode_32k -----------------------------------------------------------
    dcell = spec.cell("decode_32k")
    Sd, Bcell = dcell.dims["seq_len"], dcell.dims["global_batch"]
    D0 = SERVE_DECODE_LEN
    # a dense model's rows are independent: the single device decodes the
    # first SERVE_REF_ROWS first; an MoE model's group is the batch: the
    # single device decodes the mesh's B rows after it (with ``gate``), at
    # SERVE_MOE_GATE_SEQ, so that it holds the cell's batch
    same_rows = cfg.is_moe and gate
    if same_rows:
        Sd, D0 = SERVE_MOE_GATE_SEQ, SERVE_MOE_GATE_SEQ - (Sd - D0)
    lengths = [min(w, Sd) if w else Sd for w in cfg.layer_pattern]
    toks = torch.randint(0, cfg.vocab_size, (steps, Bcell, 1),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(128))
    row_bytes = sum(2 * cfg.n_groups * n * cfg.n_kv_heads * cfg.head_dim
                    * cfg.dtype.itemsize for n in lengths)

    def whole_cache(rows: int) -> dict:
        """The single device's cache of rows 0..rows - 1 on card 0, drawn
        as the mesh's (``draw_cache``)."""
        ref = {}
        for p, n in enumerate(lengths):
            for kv, name in enumerate(("k", "v")):
                t = torch.empty((cfg.n_groups, rows, n, cfg.n_kv_heads,
                                 cfg.head_dim), dtype=cfg.dtype, device=card0)
                for g in range(cfg.n_groups):
                    draw_cache(t[g], p, kv, g, range(rows), 0, n)
                ref.setdefault(f"pos{p}", {})[name] = t
        return ref

    def single_decode(rows: int):
        """The single device's SERVE_STEPS steps on rows 0..rows - 1:
        (logits a step on the CPU, ms a step, its MoE record)."""
        ref = whole_cache(rows)
        want, ms_ = [], []
        with moe_lib.recording() as rec:
            for j in range(steps):
                (lg, ref), ms = run_timed(lambda: transformer.decode_step(
                    cfg, single, ref, toks[j, :rows].to(card0), D0 + j))
                want.append(lg.to("cpu"))
                ms_.append(ms)
        return torch.stack(want), ms_, rec

    want = ref_ms = None
    if single_too and not cfg.is_moe:
        want, ref_ms, _ = single_decode(SERVE_REF_ROWS)
    if not same_rows:
        del single
    free_cards(cards)
    free_b = min(torch.cuda.mem_get_info(c)[0] for c in cards)
    per_card = row_bytes * (mesh.size // len(cards)) / mesh.size
    B = min(Bcell, (free_b - SERVE_MARGIN) / per_card)
    if same_rows:  # and its whole cache on card 0 once the mesh's is
        # freed, with copies of a layer's keys and values (decode_step)
        B = min(B, (torch.cuda.mem_get_info(card0)[0] - SERVE_MARGIN)
                / (row_bytes * (1 + 2 / cfg.n_layers)))
    B = int(B) // 2 * 2
    R = B if same_rows else SERVE_REF_ROWS
    if (single_too and B < R) or B < 2:
        fail(f"decode_32k: 2 x 2 holds {B} rows of {arch}'s cache at "
             f"{depth}, fewer than the {R} compared")
    toks = toks[:, :B]

    def mesh_decode(ahead: int = 0):
        """The plan's SERVE_STEPS steps on the mesh from a freshly drawn
        cache (each at a position ``ahead`` past its own): (rows 0..R - 1
        of each step's logits on the CPU, ms a step, the cache, its MoE
        record)."""
        cache = drawn_cache(cfg, mesh, plan.in_specs[1]["pos0"]["k"], B, Sd)
        reset()
        got, step_ms = [], []
        with moe_lib.recording() as rec:
            for j in range(steps):
                (lg, cache), ms = run_timed(lambda: plan.fn(
                    params, cache, toks[j], D0 + j + ahead))
                got.append(first_rows(lg, R).to("cpu"))
                step_ms.append(ms)
        return torch.stack(got), step_ms, cache, rec

    got, step_ms, cache, rec = mesh_decode()
    pk = peaks()
    c_bytes = [card_bytes([s for c in cache.values() for st in c.values()
                           for s in st.shards], c) for c in cards]
    bound = max(c + w for c, w in zip(c_bytes, w_card)) / PEAK_BYTES_S
    prof = (None if gate else _mesh_profile(
        lambda: plan.fn(params, cache, toks[-1], D0 + steps - 1),
        f"one decode_32k step on 2 x 2 at {depth}", cards))
    del cache
    line = (f"    decode_32k at {depth}: B = {B}"
            + (f" (the cell's {Bcell} cut: 2 x 2 on {len(cards)} card(s) "
               f"holds no more with {SERVE_MARGIN / 1e9:.0f} GB left free)"
               if B < Bcell else " (the cell's)")
            + f", S = {Sd:,}"
            + (f" (the cell's {dcell.dims['seq_len']:,} cut: the single "
               "device beside it holds the whole batch)" if same_rows
               else "")
            + f", the cache {B * row_bytes / 1e9:.2f} GB "
            f"({max(c_bytes) / 1e9:.2f} GB a card) drawn on its cards, "
            f"{steps} steps from cache_len {D0:,}: "
            f"{np.median(step_ms):.2f} ms a step (median; "
            f"{min(step_ms):.2f}-{max(step_ms):.2f}) against its bytes "
            f"bound {bound * 1e3:.3f} ms (a card's cache block and weights "
            f"over 3.35 TB/s), peak GB a card {pk}"
            + (f", busy share {prof['busy_share']:.1%}" if prof else ""))
    if cfg.is_moe:
        E = moe_lib.padded_experts(cfg.n_experts)
        cap = moe_lib.capacity(min(cfg.moe_group_size, B), cfg.top_k, E,
                               cfg.capacity_factor)
        line += (f"; MoE (a step's group: the batch's {B} tokens over "
                 f"{mesh.shape['data']} data replicas, capacity {cap} an "
                 f"expert): {rec.handoffs // steps} slot hand-offs a step "
                 f"between the replicas, {rec.dropped} of "
                 f"{rec.assignments:,} assignments dropped over the {steps} "
                 f"steps")
        if mesh.shape["data"] > 1 and rec.handoffs == 0:
            problems.append(f"{arch} decode_32k at {depth}: no slot "
                            "hand-off between the data replicas")
        if gate and rec.dropped == 0:
            problems.append(f"{arch} decode_32k at {depth}: B = {B} drops "
                            "no assignment: the capacity never binds")
    if same_rows:
        free_cards(cards)
        want, ref_ms, srec = single_decode(B)
        line += (f" (the single device on the same rows: {srec.dropped} "
                 "dropped)")
    if want is not None:
        r, msg = compare(f"decode_32k rows 0-{R - 1}", got, want)
        line += (f"; rows 0-{R - 1} against the single device's decode_step "
                 f"({np.median(ref_ms):.2f} ms a step): max |diff| "
                 f"{r[0]:.4g}, mean {r[1]:.4g} (largest |logit| {r[2]:.4g}; "
                 f"{bounds}): {verdict(msg)}")
    elif single_too:
        line += ("; not against the single device at this depth (an MoE "
                 "step's group is the whole batch: the single device would "
                 "hold all B rows)")
    log(line)
    if gate and long_skip:
        free_cards(cards)
        bad, _, cache, _ = mesh_decode(ahead=1)
        del cache
        rf, msg = compare("", bad, want, record=False)
        fault_verdict("decode_32k", rf, msg)
    del model, params
    if same_rows:
        del single
    free_cards(cards)


def check_dryrun(dev, smi: str, four_cards: bool, *,
                 production: bool = False) -> None:
    """Phase 30: the dry-run (``launch.dryrun``) held to the card, and the
    head repair at published width.

    (a) qwen1.5-0.5b's train_4k (DRYRUN_LM_LAYERS layers, a global batch
    of DRYRUN_LM_BATCH), dlrm-rm2's train_batch (DRYRUN_RECSYS_BATCH) and
    MACE's molecule through ``build_plan``, each on make_host_mesh(2, 2):
    the plan's step on the card under ``FlopCounterMode`` and the
    collective recorder (``dryrun.trace(fake=False)``), then the same
    plan traced on fake shards of a 2 x 2 placeholder mesh: FLOPs,
    collective counts and bytes and output bytes equal exactly; and
    ``dryrun.argument_bytes`` (per card: four positions on one card, one
    on each of four) against the allocator's growth while the state and
    the batch are placed, within its rounding (DRYRUN_ROUND,
    DRYRUN_LARGE), the bytes it was asked for logged beside. (b) on one
    card, gemma2-2b and granite-moe-3b-a800m at published width and
    DRYRUN_HEADS_LAYERS layers on make_host_mesh(1, DRYRUN_HEADS_M)
    (their heads do not split over it: attention re-laid out over the
    sequence): a prefill's logits and a train step's loss against the
    single device from the same draws, within
    ``testing.bf16_lm_mismatch``. (c) ``python -m
    repro_torch.launch.dryrun`` on a production cell (DRYRUN_CELL; qwen1.5-
    0.5b's train_4k on 16 x 16 under --dryrun), in a subprocess: its wall
    time and record."""
    import torch
    from repro_torch import configs as C
    from repro_torch import testing
    from repro_torch.distributed import partition
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    mesh = make_host_mesh(2, 2)
    cards = list(dict.fromkeys(mesh.devices.flat))
    if four_cards and len(cards) != 4:
        fail(f"--sharded needs a mesh of four distinct cards; "
             f"make_host_mesh(2, 2) sits on {[str(d) for d in cards]}")
    log(f"[30] the dry-run against the card; {smi}; make_host_mesh(2, 2) "
        f"sits on {[str(d) for d in mesh.devices.flat]}")
    fake_mesh = Mesh(np.array([[torch.device("meta")] * 2] * 2,
                              dtype=object), ("data", "model"))
    per_card = mesh.size // len(cards)
    problems = []

    def allocated():
        """(bytes handed out, bytes asked for) a card."""
        return [(torch.cuda.memory_allocated(d), torch.cuda.memory_stats(
            d).get("requested_bytes.all.current")) for d in cards]

    legs = (("qwen1.5-0.5b", "train_4k",
             {"n_layers": DRYRUN_LM_LAYERS},
             {"global_batch": DRYRUN_LM_BATCH}),
            ("dlrm-rm2", "train_batch", None,
             {"batch": DRYRUN_RECSYS_BATCH}),
            ("mace", "molecule", None, None))
    for arch, shape, over, dims in legs:
        plan = steps_lib.build_plan(arch, shape, overrides=over, dims=dims)
        spec = C.get_arch(arch)
        cell = dataclasses.replace(spec.cell(shape), dims=dict(
            spec.cell(shape).dims, **(dims or {})))
        seed_gen = torch.Generator(device=mesh.first_device).manual_seed(0)
        gc.collect()
        torch.cuda.empty_cache()
        sync_cards(cards)
        before = allocated()
        fam = spec.family
        if fam == "lm":
            model = transformer.init_sharded(plan.cfg, mesh,
                                             generator=seed_gen)
            batch = train.lm_batch_fn(plan.cfg, seed=1,
                                      batch=cell.dims["global_batch"],
                                      seq=cell.dims["seq_len"],
                                      device=dev)(0)
        elif fam == "recsys":
            from repro_torch.models import recsys
            model = recsys.init_sharded(plan.cfg, mesh, generator=seed_gen)
            batch = train.batch_fn(plan.cfg, seed=1,
                                   batch=cell.dims["batch"], device=dev)(0)
        else:
            from repro_torch.models import mace
            model = mace.init_sharded(plan.cfg, mesh, generator=seed_gen)
            batch = gnn_cell_batch(cell, 1, dev)
        tr = train.ShardedTrainer(model)
        laid = {k: partition.place(batch[k], plan.in_specs[2][k], mesh)
                for k in plan.args[2]}
        del batch
        slack = sum(
            DRYRUN_ROUND + (DRYRUN_LARGE if s.nbytes >= DRYRUN_LARGE else 0)
            for st in (*tr.params.values(), *tr.opt_state.mu.values(),
                       *tr.opt_state.nu.values(), tr.opt_state.step,
                       *laid.values())
            for s in st.shards) // len(cards)  # no list: it would keep them
        sync_cards(cards)
        after = allocated()
        grown = [a[0] - b[0] for a, b in zip(after, before)]
        asked = [None if a[1] is None else a[1] - b[1]
                 for a, b in zip(after, before)]
        want = dryrun.argument_bytes(plan, fake_mesh) * per_card
        if any(not want <= g <= want + slack for g in grown):
            problems.append(f"{arch} {shape}: the allocator grew {grown} "
                            f"bytes a card on placement; argument_bytes x "
                            f"{per_card} = {want} (+ up to {slack} of "
                            f"rounding)")
        t = time.perf_counter()
        real = dryrun.trace(plan, mesh, fake=False,
                            args=(tr.params, tr.opt_state, laid))
        sync_cards(cards)
        real_s = time.perf_counter() - t
        del tr, model, laid
        free_cards(cards)
        fake = dryrun.trace(plan, fake_mesh)
        same = (fake["flops"] == real["flops"]
                and fake["collectives"] == real["collectives"]
                and fake["output_bytes"] == real["output_bytes"])
        coll = sum(v["bytes"] for v in real["collectives"].values())
        log(f"    {arch} {shape} ({fam}) on 2 x 2: card {real_s:.2f} s, "
            f"fake {fake['seconds']:.2f} s; FLOPs {real['flops']:,} (fake "
            f"{fake['flops']:,}), collectives "
            f"{sum(v['count'] for v in real['collectives'].values()):,} "
            f"receipts {coll:,} bytes (fake "
            f"{sum(v['bytes'] for v in fake['collectives'].values()):,}), "
            f"outputs {real['output_bytes']:,} B a position (fake "
            f"{fake['output_bytes']:,}); argument_bytes {want // per_card:,}"
            f" a position, allocator +{grown} a card (asked {asked}: "
            f"{'exactly' if all(a == want for a in asked) else 'not'} "
            f"argument_bytes); "
            + ("equal" if same else "DIFFERENT"))
        log(f"      by kind: {json.dumps(real['collectives'])}")
        if not same:
            problems.append(f"{arch} {shape}: the fake trace's counts "
                            f"{fake['flops']}, {fake['collectives']}, "
                            f"{fake['output_bytes']} are not the card's "
                            f"{real['flops']}, {real['collectives']}, "
                            f"{real['output_bytes']}")
    del mesh

    # -- (b) heads that do not split over 16 model shards, one card ----------
    if not four_cards:
        heads_mesh = make_host_mesh(1, DRYRUN_HEADS_M)
        for arch in ("gemma2-2b", "granite-moe-3b-a800m"):
            cfg = dataclasses.replace(C.get_arch(arch).make_config(),
                                      n_layers=DRYRUN_HEADS_LAYERS)
            if not transformer._column_attention(cfg, DRYRUN_HEADS_M):
                fail(f"{arch}'s heads split over {DRYRUN_HEADS_M}")
            tokens = train.lm_batch_fn(cfg, seed=3, batch=DRYRUN_HEADS_B,
                                       seq=DRYRUN_HEADS_S,
                                       device=dev)(0)["tokens"]
            one = transformer.init_params(
                cfg, generator=torch.Generator(device=dev).manual_seed(5))
            with torch.no_grad():
                want_logits, _ = transformer.prefill(cfg, one, tokens)
            want_loss, _ = transformer.loss_fn(cfg, one,
                                               {"tokens": tokens[:1]})
            want_logits = want_logits[:, :cfg.vocab_size].float().cpu()
            want_loss = want_loss.item()
            del one
            free_cards(cards)
            t = time.perf_counter()
            sharded = transformer.init_sharded(
                cfg, heads_mesh,
                generator=torch.Generator(device=dev).manual_seed(5))
            logits, _ = transformer.sharded_prefill(cfg, sharded, tokens)
            logits = logits.gather()[:, :cfg.vocab_size].float().cpu()
            loss, _, grads = train.sharded_grads(sharded,
                                                 {"tokens": tokens[:1]})
            loss = loss.item()
            sync_cards(cards)
            ms = (time.perf_counter() - t) * 1e3
            del sharded, grads
            free_cards(cards)
            why = testing.bf16_lm_mismatch(logits, loss, {}, want_logits,
                                           want_loss, {})
            diff = (logits - want_logits).abs()
            log(f"    {arch} at {DRYRUN_HEADS_LAYERS} layers, {cfg.n_heads} "
                f"heads on 1 x {DRYRUN_HEADS_M} (one card): prefill of "
                f"{DRYRUN_HEADS_B} x {DRYRUN_HEADS_S:,} and a step's loss "
                f"in {ms:.0f} ms; logits max |diff| {float(diff.max()):.4g}"
                f", mean {float(diff.mean()):.4g} (largest "
                f"{float(want_logits.abs().max()):.4g}); loss {loss:.6f} "
                f"against {want_loss:.6f}; "
                + ("within bf16_lm_mismatch" if why is None else why))
            if why is not None:
                problems.append(f"{arch} on 1 x {DRYRUN_HEADS_M}: {why}")
        del heads_mesh

    # -- (c) a production cell through the CLI ----------------------------
    arch, shape = DRYRUN_CELL[production]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "dryrun")
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "pod", "--artifact-dir", out_dir],
        capture_output=True, text=True, env=dict(
            os.environ, PYTHONPATH=os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "src")))
    wall = time.perf_counter() - t
    log(f"    python -m repro_torch.launch.dryrun --arch {arch} --shape "
        f"{shape} --mesh pod: exit {r.returncode}, {wall:.1f} s wall")
    for line in r.stdout.strip().splitlines()[-3:]:
        log(f"      {line}")
    path = os.path.join(out_dir, f"{arch}__{shape}__pod.json")
    if r.returncode != 0 or not os.path.exists(path):
        problems.append(f"the dry-run of {arch} {shape} failed: "
                        f"{r.stderr[-1500:]}")
    else:
        with open(path) as f:
            rec = json.load(f)
        log(f"      record: {json.dumps({k: rec[k] for k in ('status', 'trace_s', 'memory', 'cost', 'corrected') if k in rec})}")
        if rec["status"] != "ok":
            problems.append(f"the dry-run of {arch} {shape}: {rec}")
    log(f"    phase 30: {time.perf_counter() - t0:.1f} s")
    if problems:
        fail("; ".join(problems))


# -- 31. the trainer's mesh over processes ------------------------------------------


def leaf_fingerprints(tree, mesh) -> dict:
    """An exact integer fingerprint of every leaf's bytes at each of this
    process's positions, computed on its card: sum_i b_i (i mod 1,000,003
    + 1) over the leaf's elements read as integers of their width, in
    int64 (wrapping, so the order of the sum does not matter)."""
    import torch

    from repro_torch.checkpoint.checkpoint import leaf_paths

    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    out = {}
    for name, st in leaf_paths(tree):
        for pos in mesh.local_positions:
            t = st.shards[pos].detach().contiguous().reshape(-1)
            flat = t.view(ints[t.element_size()])
            total = torch.zeros((), dtype=torch.int64, device=t.device)
            for lo in range(0, flat.numel(), 1 << 26):
                x = flat[lo:lo + (1 << 26)].to(torch.int64)
                w = torch.arange(lo, lo + x.numel(), device=t.device)
                total += (x * (w % 1_000_003 + 1)).sum()
            out[f"{name}@{pos}"] = int(total)
    return out


def mh_argv(arch: str, layers: int, batch: int, seq: int, shape,
            compress: bool, steps: int = MH_STEPS) -> list:
    return ["--arch", arch, "--layers", str(layers), "--batch", str(batch),
            "--seq", str(seq), "--data-shards", str(shape[0]),
            "--model-shards", str(shape[1]), "--steps", str(steps),
            "--fixed-batch"] + (["--compress-grads"] if compress else [])


def mh_run(spec: dict) -> dict:
    """One trainer run of ``spec`` (``argv``; ``device``; ``multihost``;
    ``profile``: the last step under the profiler; ``delay``: (seed, card)
    a random delay in that card's backward) in this process: its losses,
    step times, peaks, backend and leaf fingerprints."""
    import torch

    from repro_torch.distributed import partition, process
    from repro_torch.launch import train
    from repro_torch.models import layers as L

    device = spec.get("device", "cuda")
    if spec.get("multihost"):
        process.initialize(device, timeout_s=MH_WALL_S - 60)
    delay, orig_mm, hits = spec.get("delay"), L.matmul_f32, [0]
    if delay:
        rng = np.random.default_rng(delay[0])
        card = torch.device("cuda", delay[1])

        def late(g):
            hits[0] += 1
            ms = float(rng.uniform(0, MH_DELAY_MS))
            time.sleep(ms / 1e3)
            with torch.cuda.device(card):
                torch.cuda._sleep(int(ms * 1e6))   # ~1 GHz cycles
            return g

        def matmul_f32(a, b):
            out = orig_mm(a, b)
            if out.requires_grad and out.device == card:
                out.register_hook(late)
            return out

        L.matmul_f32 = matmul_f32
    orig_step, calls, prof_rec = train.ShardedTrainer.step, [0], {}

    def step(self, batch):
        calls[0] += 1
        if not (spec.get("profile") and calls[0] == MH_STEPS):
            return orig_step(self, batch)
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = orig_step(self, batch)
            partition.synchronize(self.mesh)
        prof_rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
        mesh_us = nccl_us = 0.0
        for e in prof.key_averages():
            if e.key.startswith("mesh."):
                mesh_us += e.cpu_time_total
            if "nccl" in e.key.lower():
                nccl_us += getattr(e, "device_time_total", 0.0) or \
                    getattr(e, "cuda_time_total", 0.0)
        prof_rec["mesh_ms"] = mesh_us / 1e3
        prof_rec["nccl_device_ms"] = nccl_us / 1e3
        return out

    train.ShardedTrainer.step = step
    try:
        out = train.train(train.parse_args(spec["argv"] + [
            "--device", device] + (["--multihost"] if spec.get("multihost")
                                   else [])))
    finally:
        train.ShardedTrainer.step = orig_step
        L.matmul_f32 = orig_mm
    mesh = out["mesh"]
    rec = {"losses": out["losses"], "step_s": out["step_s"],
           "peaks": out["peak_bytes_by_device"], "backend": out["backend"],
           "local": list(mesh.local_positions), "delay_hits": hits[0],
           "fingerprints": leaf_fingerprints(out["trainer"].state_tree(),
                                             mesh), **prof_rec}
    del out
    free_cards([d for d in dict.fromkeys(mesh.devices.flat)
                if d.type == "cuda"])
    return rec


def mh_worker(spec_path: str) -> None:
    """The worker of phase 31 (one process of ``torch.distributed.run``):
    ``mh_run`` of each of the spec's runs in turn, in one process group,
    the records written to ``<out>.<rank>.json``."""
    with open(spec_path) as f:
        spec = json.load(f)
    import repro_torch  # noqa: F401  (the TF32 switches)
    from repro_torch.distributed import process

    recs = [mh_run(dict(run, device=spec["device"], multihost=True))
            for run in spec["runs"]]
    rank = process.process_index()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(recs, f)
    process.barrier()
    process.shutdown()


def mh_spawn(runs: list, work: str, label: str) -> list:
    """``mh_run`` of each of ``runs`` in turn in two processes started by
    ``python -m torch.distributed.run --nproc-per-node 2``: for each run,
    the two processes' records. Any process failing fails the phase."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    path = os.path.join(work, f"{label}.json")
    spec = {"runs": runs, "out": os.path.join(work, label),
            "device": MH_DEVICE}
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
             "--master-port", str(port), os.path.abspath(__file__),
             "--mh-worker", path], capture_output=True, text=True,
            timeout=MH_WALL_S)
    except subprocess.TimeoutExpired as e:
        fail(f"phase 31 {label}: the two processes did not end within "
             f"{MH_WALL_S} s: {str(e.stdout)[-3000:]}")
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"phase 31 {label}: the two processes exited "
             f"{r.returncode}:\n{r.stdout[-6000:]}\n{r.stderr[-6000:]}")
    for line in r.stdout.splitlines():
        if line.startswith("[process") and ("backend" in line
                                            or "mesh" in line):
            log(f"      {line[:200]}")
    recs = []
    for rank in range(2):
        with open(f"{spec['out']}.{rank}.json") as f:
            recs.append(json.load(f))
    log(f"    {label}: two processes, {len(runs)} run(s), {wall:.1f} s wall")
    return [list(pair) for pair in zip(*recs)]


def mh_compare(label: str, one: dict, two: list, backend: str) -> None:
    """Fail unless both processes' losses and the union of their
    fingerprints equal the one-process run's, over ``backend``."""
    for rank, rec in enumerate(two):
        if rec["backend"] != backend:
            fail(f"phase 31 {label}: process {rank} ran over "
                 f"{rec['backend']}, not {backend}")
        if rec["losses"] != one["losses"]:
            fail(f"phase 31 {label}: process {rank}'s losses "
                 f"{rec['losses']} against one process's {one['losses']}")
    got = {**two[0]["fingerprints"], **two[1]["fingerprints"]}
    if set(got) != set(one["fingerprints"]):
        fail(f"phase 31 {label}: fingerprints of {len(got)} leaves a "
             f"position against {len(one['fingerprints'])}")
    bad = sorted(k for k, v in one["fingerprints"].items() if got[k] != v)
    if bad:
        fail(f"phase 31 {label}: {len(bad)} leaves differ from one "
             f"process's, first {bad[:5]}")
    log(f"    {label}: losses {one['losses']} on both processes and "
        f"{len(got)} leaf fingerprints (a leaf a position) equal to one "
        "process's, bit for bit")


def _dir_files(d: str) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


def check_multihost(smi: str, four_cards: bool) -> None:
    """Phase 31: the trainer's mesh over two processes against one."""
    import torch

    t0 = time.perf_counter()
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    log(f"[31] the trainer's mesh over two processes (--multihost, python "
        f"-m torch.distributed.run --nproc-per-node 2) against one "
        f"process; {smi}; {len(cards)} card(s)")
    if four_cards and len(cards) < 4:
        fail(f"--sharded needs four cards for phase 31; found {len(cards)}")
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "multihost")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if not four_cards:
        legs = []
        for shape, compress in MH_ONE_LEGS:
            argv = mh_argv(MH_ONE_CARD, MH_ONE_LAYERS, MH_ONE_BATCH,
                           MH_ONE_SEQ, shape, compress)
            legs.append((f"{MH_ONE_CARD} {MH_ONE_LAYERS} layers "
                         f"{shape[0]} x {shape[1]}"
                         + (" --compress-grads" if compress else ""),
                         argv, mh_run({"argv": argv, "device": MH_DEVICE})))
        twos = mh_spawn([{"argv": argv} for _, argv, _ in legs], work,
                        "one_card")
        tok = MH_ONE_BATCH * MH_ONE_SEQ
        for (label, _, one), two in zip(legs, twos):
            mh_compare(label, one, two, "gloo")
            t1, t2 = one["step_s"][1], max(r["step_s"][1] for r in two)
            log(f"    {label}: step 1 {t1 * 1e3:.1f} ms one process "
                f"({tok / t1:,.0f} tokens/s), {t2 * 1e3:.1f} ms two "
                f"processes ({tok / t2:,.0f} tokens/s)")
        log(f"    phase 31: {time.perf_counter() - t0:.1f} s")
        return
    argv = mh_argv(MH_FOUR, MH_FOUR_LAYERS, MH_FOUR_BATCH, MH_FOUR_SEQ,
                   (1, 4), False)
    label = f"{MH_FOUR} {MH_FOUR_LAYERS} layers 1 x 4"
    one = mh_run({"argv": argv, "device": MH_DEVICE})
    runs = [{"argv": argv, "profile": True}] + [
        {"argv": argv, "delay": [100 + i, 1]} for i in range(MH_DELAY_RUNS)]
    two, *delayed = mh_spawn(runs, work, "four")
    mh_compare(label, one, two, "nccl")
    tok = MH_FOUR_BATCH * MH_FOUR_SEQ
    t1, t2 = one["step_s"][1], max(r["step_s"][1] for r in two)
    peak1 = max(one["peaks"].values(), default=0) / 1e9
    peak2 = max((v for r in two for v in r["peaks"].values()),
                default=0) / 1e9
    log(f"    {label}: step 1 {t1 * 1e3:.1f} ms one process "
        f"({tok / t1:,.0f} tokens/s), {t2 * 1e3:.1f} ms two processes "
        f"({tok / t2:,.0f} tokens/s); every step one {one['step_s']}, two "
        f"{[r['step_s'] for r in two]}; peak {peak1:.2f} against "
        f"{peak2:.2f} GB a card")
    for rank, r in enumerate(two):
        log(f"    process {rank}'s profiled step {MH_STEPS - 1}: wall "
            f"{r['wall_ms']:.1f} ms, mesh.* ranges {r['mesh_ms']:.1f} ms "
            f"({r['mesh_ms'] / r['wall_ms']:.1%} of the step, host), NCCL "
            f"kernels {r['nccl_device_ms']:.1f} ms on the card; peaks "
            f"{ {k: round(v / 1e9, 2) for k, v in r['peaks'].items()} }")
    for i, recs in enumerate(delayed):
        mh_compare(f"{label}, random delays in cuda:1's backward (seed "
                   f"{100 + i}, {recs[0]['delay_hits']} hits)", one, recs,
                   "nccl")
    del one, two, delayed
    # the checkpoint leg: two processes save, one restores; and the reverse
    ck = mh_argv(MH_ONE_CARD, MH_ONE_LAYERS, MH_CKPT_BATCH, MH_ONE_SEQ,
                 (1, 4), False, steps=2)
    full = mh_argv(MH_ONE_CARD, MH_ONE_LAYERS, MH_CKPT_BATCH, MH_ONE_SEQ,
                   (1, 4), False, steps=4)
    whole = mh_run({"argv": full, "device": MH_DEVICE})  # uninterrupted
    d2, d1 = os.path.join(work, "ck_two"), os.path.join(work, "ck_one")
    mh_run({"argv": ck + ["--ckpt-dir", d1, "--ckpt-every", "2"],
            "device": MH_DEVICE})
    shutil.copytree(d1, d1 + "_r")
    _, two_r = mh_spawn([
        {"argv": ck + ["--ckpt-dir", d2, "--ckpt-every", "2"]},
        {"argv": full + ["--resume", "--ckpt-dir", d1 + "_r"]}], work,
        "checkpoints")
    a, b = _dir_files(d2), _dir_files(d1)
    if sorted(a) != sorted(b) or any(a[n] != b[n] for n in a):
        fail("phase 31: the two processes' checkpoint files differ from "
             "one process's")
    shutil.copytree(d2, d2 + "_r")
    one_r = mh_run({"argv": full + ["--resume", "--ckpt-dir", d2 + "_r"],
                    "device": MH_DEVICE})
    mh_compare("one process resumed from two's save, against two resumed "
               "from one's", one_r, two_r, "nccl")
    if one_r["losses"] != whole["losses"][2:]:
        fail(f"phase 31: the resumed losses {one_r['losses']} against the "
             f"uninterrupted run's {whole['losses'][2:]}")
    log(f"    checkpoint leg ({MH_ONE_CARD} {MH_ONE_LAYERS} layers, 1 x 4): "
        f"{len(a)} files byte-equal; each layout resumed the other's save "
        f"at step 2 to the uninterrupted run's losses {whole['losses'][2:]}")
    log(f"    phase 31: {time.perf_counter() - t0:.1f} s")


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
    if "--lm-mesh" in sys.argv[1:]:
        check_lm_mesh(dev, smi, four_cards=sharded_only)
        log("lm-mesh run: stopping after phase 26")
        sys.exit(2)
    if "--gnn-mesh" in sys.argv[1:]:
        check_gnn_mesh(dev, smi, four_cards=sharded_only)
        log("gnn-mesh run: stopping after phase 27")
        sys.exit(2)
    if "--recsys-mesh" in sys.argv[1:]:
        check_recsys_mesh(dev, smi, four_cards=sharded_only)
        log("recsys-mesh run: stopping after phase 28")
        sys.exit(2)
    if "--lm-serve-mesh" in sys.argv[1:]:
        check_lm_serve_mesh(dev, smi, four_cards=sharded_only)
        log("lm-serve-mesh run: stopping after phase 29")
        sys.exit(2)
    if "--dryrun" in sys.argv[1:]:
        check_dryrun(dev, smi, four_cards=sharded_only, production=True)
        log("dryrun run: stopping after phase 30")
        sys.exit(2)
    if "--multihost" in sys.argv[1:]:
        check_multihost(smi, four_cards=sharded_only)
        log("multihost run: stopping after phase 31")
        sys.exit(2)

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
        del ivf_server, corpus, full_corpus, batches, coords, queries, small
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        check_lm_mesh(dev, smi, four_cards=True)
        gc.collect()
        check_gnn_mesh(dev, smi, four_cards=True)
        gc.collect()
        check_recsys_mesh(dev, smi, four_cards=True)
        gc.collect()
        check_lm_serve_mesh(dev, smi, four_cards=True)
        gc.collect()
        check_dryrun(dev, smi, four_cards=True)
        gc.collect()
        torch.cuda.empty_cache()
        check_multihost(smi, four_cards=True)
        log(f"sharded run: stopping after phases 8 (f32), 20 and 26-31; "
            f"{time.perf_counter() - t_start:.0f} s")
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

    # -- 25. the GNN trainer at full width, its descriptors into Zen --------------
    gnn_launches = check_gnn_trainer(torch.device("cuda"), smi)

    # -- 26. the LM trainer on a (data, model) mesh -------------------------------
    torch.cuda.empty_cache()
    check_lm_mesh(torch.device("cuda"), smi, four_cards=False)

    # -- 27. MACE on a (data, model) mesh -----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    check_gnn_mesh(torch.device("cuda"), smi, four_cards=False)

    # -- 28. the recsys family on a (data, model) mesh ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    check_recsys_mesh(torch.device("cuda"), smi, four_cards=False)

    # -- 29. the LM's prefill and decode plans on a (data, model) mesh --------------
    gc.collect()
    torch.cuda.empty_cache()
    check_lm_serve_mesh(torch.device("cuda"), smi, four_cards=False)

    # -- 30. the dry-run against the card, the head repair ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    check_dryrun(torch.device("cuda"), smi, four_cards=False)

    # -- 31. the trainer's mesh over two processes ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    check_multihost(smi, four_cards=False)

    kernels = [dict(name="zen_topk", route="cuda",
                    source="src/repro_torch/kernels/csrc/zen_topk.cu",
                    replaces="src/repro/kernels/zen_topk.py:92",
                    launches=serve_launches, max_abs_err=max_err,
                    sharded_launches=sharded_launches["zen_topk"],
                    lm_jsd_launches=lm_launches["zen_topk"],
                    gnn_launches=gnn_launches["zen_topk"], **main_rec)]
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
    if "--mh-worker" in sys.argv[1:]:
        mh_worker(sys.argv[sys.argv.index("--mh-worker") + 1])
    else:
        main()
