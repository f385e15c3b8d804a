// Clustered (IVF) top-k probes for Hopper (sm_90a): scalar tiles and PQ codes.
//
// Replaces the Pallas TPU kernels repro/kernels/ivf_probe.py::ivf_probe
// (body _probe_kernel) and ::ivf_probe_pq (body _probe_pq_kernel). Each
// query q visits the T tiles of each cluster probes[q, p] it probes and
// keeps its n best rows, ascending by (distance, visit position), where the
// visit position of row r of tile t of probe column p is (p * T + t) * rows
// + r -- the order lax.top_k gives when the TPU kernel merges the running
// best before each new tile. A row whose id is -1 (padding or a tombstone,
// whose stale coordinates stay in place) is never a candidate; slots that
// the probed clusters cannot fill come back as (+inf, -1).
//   scalar  tiles (C*T, rows, k) f32/bf16/int8 (+ (C,) per-cluster f32
//           scales), the Zen/Lwb/Upb estimator of scoring.cuh, dequantised
//           to f32 right after the load and accumulated in f32;
//   pq      code tiles (C*T, rows, M) uint8 and one (M, 256) f32 table per
//           (query, probe column): sqrt(max(sum_m lut[m, code[m]], 0)),
//           summed over m in ascending order; the mode is in the table.
//
// What bounds it on an H100: bytes, and few of them. At the serving shape
// of chip_smoke.py (1e6 rows in 4,000 clusters of T = 3 tiles of 128 rows,
// Q = 64, P = 8, k = 16) the distinct probed clusters' ids and live rows
// are ~3.5 MB (~1.05 us at 3.35 TB/s; PQ: 4 code bytes a row plus the 2 MB
// of tables) and the f32 operations are noise. What a launch costs beyond
// that is latency: a few dependent loads a row, the selection, the merge
// of the lists, and each launch's own start.
//
// Design. The TPU grid is (Q, P*T), one query a row, the running best
// carried in VMEM across the row's steps. Hopper blocks run in no order, and
// queries probe different clusters, so there is no shared tile to batch
// queries over. Keys carry the visit position, not the id, in their low
// word (ids in a tile are not ascending, so the id would break ties in the
// wrong order); the id is looked up in tile_ids at write-out. The wrapper's
// planner (kernels/ivf_probe.py::probe_plan) picks one of two plans and
// sizes it; the kernels take every number of the plan as an argument.
//
// Warp plan (lists up to 64 wide: the serving widths), one launch. Each
// query is served by a thread block cluster of `cluster` blocks (on as
// many SMs), block g taking its probe columns [g * cols, (g + 1) * cols),
// each column's T * rows contiguous rows cut into `splits` items of
// split_rows rows that the block's warps take in turn. A warp scores 64
// rows a step, their ids loaded a step ahead:
//   - scalar: four lanes a row, each loading 4 columns of each 16-column
//     chunk (one 16-, 8- or 4-byte load when k % 4 == 0, else 4 scalar
//     loads), so a warp's loads cover 8 consecutive rows, coalesced; eight
//     rows a lane group in flight. Each lane sums its columns with FMAs,
//     the dot without the altitude column, and a transposed sum over the 4
//     lanes (zen::sum4_transposed) leaves each lane one row's total, in an
//     order that does not depend on the row's place (a row duplicated in
//     two clusters scores the same, and the lower visit position wins); a
//     row whose id is -1 is not loaded, and a step of 64 dead ids is
//     skipped.
//   - pq: a lane a row, its M codes read as M/4 4-byte loads when M % 4 ==
//     0; the first m_smem subspaces' tables of the block's columns sit in
//     shared memory, the rest are read from global memory (L1/L2).
// Selection. A running top-n a warp (or a bound shared by the warps) keeps
// nearly every row here: a warp sees ~80 live rows, and n is up to 64. So
// the block keeps a candidate slot for every row of its columns' clusters
// in shared memory, and each live row's key goes to its own slot (no
// atomics). After the scan a radix select over the candidates' distance
// bits (256-bin shared histograms, the first pass over the 8 bits below the
// highest bit in which the block's keys differ) finds a bound at or below
// which lie the n best and at most 128 keys; every warp gathers those, and
// one warp sorts them (zen::flush64: 64-key bitonic sorts and merges by
// shuffles). Keys compare in full, so a row tied in distance with a lower
// visit position still wins. Then the cluster's other blocks write their
// lists into the first block's shared memory (distributed shared memory),
// one cluster barrier later it merges them and writes the query's n
// results: no pass 2, no global scratch.
// Block plan (wider lists), two launches. Pass 1: one 256-thread block per
// (query, probe column) walks the cluster's rows 256 at a time, one row a
// thread; a row whose key beats the list's n-th best (as of the last
// flush) is appended to a buffer of `cap` keys with a shared atomicAdd;
// when the next chunk might not fit, and at the end, the buffer is
// bitonic-sorted and merged into the block's sorted list of w keys. Lists
// too wide for shared memory (w >= 16,384) live in global memory: the
// partial output itself and the wrapper's scratch. The PQ tables of the
// first m_smem subspaces sit in shared memory, the rest are read from
// global memory. Pass 2: one block per query merges its P lists, a group
// at a time in shared memory (or, past it, each list into a running best
// in global scratch), and writes the first n.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scoring.cuh"

// Phase marks of the warp plan's scalar kernel: probes/ivf_probe_phases.cu
// defines IVF_PROBE_PHASES and a PhaseMarks that reads the clock before it
// includes this file; here they compile to nothing.
#ifndef IVF_PROBE_PHASES
struct PhaseMarks {
  __device__ void mark(int) {}
  __device__ void radix_pass(int) {}
  __device__ void end() {}
};
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 256;       // PQ table entries per subspace

// One (query, probe column) list: in shared memory, or in global memory
// when the plan says so; __syncthreads orders both for the block.
struct List {
  uint64_t* best;  // [w] ascending
  uint64_t* buf;   // [cap] unsorted candidates
  int* cnt;
  float* bound;    // squared_bound of the n-th best as of the last flush
  int w;
  int cap;
};

__device__ __forceinline__ void offer(const List& l, uint64_t key,
                                      int n_out) {
  if (key < l.best[n_out - 1]) l.buf[atomicAdd(l.cnt, 1)] = key;
}

// Sorts the `filled` buffered candidates, merges them into the list and
// empties the buffer. Block-wide; `filled` is block-uniform.
__device__ void flush(const List& l, int filled, int n_out) {
  int p = 1;
  while (p < filled) p <<= 1;
  const int fill = max(p, l.w);
  for (int i = threadIdx.x; i < fill; i += blockDim.x)
    if (i >= filled) l.buf[i] = zen::kEmptyKey;
  __syncthreads();
  zen::bitonic_sort_segments(l.buf, 1, p, l.cap);
  zen::merge_sorted_segments(l.best, l.w, l.buf, l.cap, 1, l.w);
  if (threadIdx.x == 0) {
    *l.cnt = 0;
    *l.bound = zen::squared_bound(zen::key_distance(l.best[n_out - 1]));
  }
  __syncthreads();
}

// After each chunk of rows: flush when the next chunk might not fit. The
// count is read by every thread between two barriers, so no thread
// appends again before all have read it.
__device__ __forceinline__ void end_chunk(const List& l, int n_out,
                                          bool last) {
  __syncthreads();
  const int filled = *l.cnt;
  __syncthreads();
  if (last ? filled > 0 : filled > l.cap - kThreads) flush(l, filled, n_out);
}

// The block's list: at the start of shared memory (the returned pointer
// is what follows it), or partial's slot and gscratch's row of this block
// (global_lists; the partial is then written in place).
__device__ __forceinline__ List init_list(unsigned char* smem, int w, int cap,
                                          bool global_lists,
                                          uint64_t* partial,
                                          uint64_t* gscratch,
                                          unsigned char** rest) {
  __shared__ int cnt;
  __shared__ float bound;
  List l;
  if (global_lists) {
    l.best = partial + int64_t(blockIdx.x) * w;
    l.buf = gscratch + int64_t(blockIdx.x) * cap;
    *rest = smem;
  } else {
    l.best = reinterpret_cast<uint64_t*>(smem);
    l.buf = l.best + w;
    *rest = reinterpret_cast<unsigned char*>(l.buf + cap);
  }
  l.cnt = &cnt;
  l.bound = &bound;
  l.w = w;
  l.cap = cap;
  for (int i = threadIdx.x; i < w; i += blockDim.x) l.best[i] = zen::kEmptyKey;
  if (threadIdx.x == 0) {
    cnt = 0;
    bound = __int_as_float(0x7f800000);  // +inf: every row is wanted
  }
  return l;
}

__device__ __forceinline__ void write_list(const List& l, bool global_lists,
                                           uint64_t* partial) {
  if (global_lists) return;  // the list is partial's slot already
  for (int i = threadIdx.x; i < l.w; i += blockDim.x)
    partial[int64_t(blockIdx.x) * l.w + i] = l.best[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ivf_probe_partial(const float* __restrict__ queries,
                      const T* __restrict__ tiles,
                      const int32_t* __restrict__ tile_ids,
                      const int32_t* __restrict__ probes,
                      const float* __restrict__ scales, int n_probe,
                      int n_clusters, int64_t cluster_rows, int k, int n_out,
                      int w, int cap, bool global_lists, int mode,
                      uint64_t* partial, uint64_t* gscratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const List l =
      init_list(smem, w, cap, global_lists, partial, gscratch, &rest);
  __shared__ float qn_s;
  const int q = blockIdx.x / n_probe, p = blockIdx.x - q * n_probe;
  const int c = probes[blockIdx.x];
  // the query: staged in shared memory, or read in place beside global
  // lists
  const float* qs = queries + int64_t(q) * k;
  if (!global_lists) {
    float* qsm = reinterpret_cast<float*>(rest);  // [k]
    for (int i = threadIdx.x; i < k; i += blockDim.x) qsm[i] = qs[i];
    qs = qsm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < k; ++i) s = fmaf(qs[i], qs[i], s);
    qn_s = s;
  }
  __syncthreads();
  if (c >= 0 && c < n_clusters) {  // block-uniform
    const float scale = scales != nullptr ? scales[c] : 1.0f;
    const float qn = qn_s, qa = qs[k - 1];
    const int64_t base = int64_t(c) * cluster_rows;
    const uint32_t pos0 = uint32_t(int64_t(p) * cluster_rows);
    for (int64_t j0 = 0; j0 < cluster_rows; j0 += kThreads) {
      const int64_t j = j0 + threadIdx.x;
      const int32_t id = j < cluster_rows ? tile_ids[base + j] : -1;
      if (id >= 0) {
        const T* x = tiles + (base + j) * k;
        float nx = 0.0f, dot = 0.0f;
        for (int i = 0; i < k - 1; ++i) {
          const float v = __fmul_rn(zen::to_float(x[i]), scale);
          nx = fmaf(v, v, nx);
          dot = fmaf(qs[i], v, dot);
        }
        const float xa = __fmul_rn(zen::to_float(x[k - 1]), scale);
        nx = fmaf(xa, xa, nx);
        const float z2 = zen::estimate_sq(qn, nx, dot, qa, xa, mode);
        if (z2 <= *l.bound) {
          const float d = zen::distance(z2);
          // an infinite distance never displaces an empty slot, as in
          // the reference's merge
          offer(l, zen::make_key(d, d < __int_as_float(0x7f800000),
                                 pos0 + uint32_t(j)),
                n_out);
        }
      }
      end_chunk(l, n_out, false);
    }
    end_chunk(l, n_out, true);
  }
  write_list(l, global_lists, partial);
}

__global__ void __launch_bounds__(kThreads)
    ivf_probe_pq_partial(const uint8_t* __restrict__ codes,
                         const int32_t* __restrict__ tile_ids,
                         const int32_t* __restrict__ probes,
                         const float* __restrict__ luts, int n_probe,
                         int n_clusters, int64_t cluster_rows, int m,
                         int m_smem, int n_out, int w, int cap,
                         bool global_lists, uint64_t* partial,
                         uint64_t* gscratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const List l =
      init_list(smem, w, cap, global_lists, partial, gscratch, &rest);
  float* lut = reinterpret_cast<float*>(rest);  // [m_smem][256]
  const int p = blockIdx.x % n_probe;
  const int c = probes[blockIdx.x];
  // the (q, p) table: luts is (Q, P, M, 256), so it is block blockIdx.x
  const float* src = luts + int64_t(blockIdx.x) * m * kEntries;
  for (int i = threadIdx.x; i < m_smem * kEntries; i += blockDim.x)
    lut[i] = src[i];
  __syncthreads();
  if (c >= 0 && c < n_clusters) {  // block-uniform
    const int64_t base = int64_t(c) * cluster_rows;
    const uint32_t pos0 = uint32_t(int64_t(p) * cluster_rows);
    for (int64_t j0 = 0; j0 < cluster_rows; j0 += kThreads) {
      const int64_t j = j0 + threadIdx.x;
      const int32_t id = j < cluster_rows ? tile_ids[base + j] : -1;
      if (id >= 0) {
        const uint8_t* code = codes + (base + j) * m;
        float z2 = 0.0f;  // summed over m in ascending order
        for (int i = 0; i < m_smem; ++i)
          z2 = __fadd_rn(z2, lut[i * kEntries + code[i]]);
        for (int i = m_smem; i < m; ++i)
          z2 = __fadd_rn(z2, __ldg(src + i * kEntries + code[i]));
        if (z2 <= *l.bound) {
          const float d = zen::distance(z2);
          offer(l, zen::make_key(d, d < __int_as_float(0x7f800000),
                                 pos0 + uint32_t(j)),
                n_out);
        }
      }
      end_chunk(l, n_out, false);
    }
    end_chunk(l, n_out, true);
  }
  write_list(l, global_lists, partial);
}


// (distance, id) of a key: the id looked up from its visit position in the
// tile ids of the cluster that its probe column names (probes_q: the
// query's row of probes); (+inf, -1) for an empty slot.
__device__ __forceinline__ void write_result(uint64_t key,
                                             const int32_t* tile_ids,
                                             const int32_t* probes_q,
                                             int64_t cluster_rows, float* d,
                                             int32_t* id) {
  float dist = __int_as_float(0x7f800000);
  int32_t row = -1;
  if (key != zen::kEmptyKey) {
    const int64_t pos = zen::key_tie(key);
    const int64_t pp = pos / cluster_rows;
    const int c = probes_q[pp];
    row = tile_ids[int64_t(c) * cluster_rows + (pos - pp * cluster_rows)];
    dist = zen::key_distance(key);
  }
  *d = dist;
  *id = row;
}

// Pass 2 of the block plan, one block per query: merge its P sorted lists
// into a running best and write the first n. With in_smem: `group` lists at a
// time in shared memory (a tree over the group, then into the running
// best). Without: the running best is the query's row of gscratch, and
// each list merges into it straight from partial.
__global__ void __launch_bounds__(kThreads)
    ivf_probe_merge(const uint64_t* __restrict__ partial,
                    const int32_t* __restrict__ tile_ids,
                    const int32_t* __restrict__ probes, int n_probe,
                    int64_t cluster_rows, int w, int group,
                    bool in_smem, int n_out, uint64_t* gscratch,
                    float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  uint64_t* best = in_smem ? reinterpret_cast<uint64_t*>(smem)
                           : gscratch + int64_t(q) * w;  // [w]
  uint64_t* lists = best + w;                             // [group][w]
  const uint64_t* src = partial + int64_t(q) * n_probe * w;
  const int wshift = zen::log2_pow2(w);
  for (int i = threadIdx.x; i < w; i += blockDim.x) best[i] = zen::kEmptyKey;
  __syncthreads();
  if (in_smem) {
    for (int g0 = 0; g0 < n_probe; g0 += group) {
      for (int t = threadIdx.x; t < group * w; t += blockDim.x)
        lists[t] = g0 + (t >> wshift) < n_probe ? src[int64_t(g0) * w + t]
                                                 : zen::kEmptyKey;
      __syncthreads();
      for (int stride = 1; stride < group; stride <<= 1)
        zen::merge_sorted_segments(lists, 2 * stride * w, lists + stride * w,
                                   2 * stride * w, group / (2 * stride), w);
      zen::merge_sorted_segments(best, w, lists, w, 1, w);
    }
  } else {
    for (int p = 0; p < n_probe; ++p)
      zen::merge_sorted_segments(best, w, src + int64_t(p) * w, w, 1, w);
  }
  for (int t = threadIdx.x; t < n_out; t += blockDim.x)
    write_result(best[t], tile_ids, probes + int64_t(q) * n_probe,
                 cluster_rows, out_d + int64_t(q) * n_out + t,
                 out_i + int64_t(q) * n_out + t);
}

// Opts a kernel in to `smem` bytes of dynamic shared memory where that is
// past the default 48 KB (less 1 KB for the kernels' static variables).
inline cudaError_t set_smem(const void* kernel, int smem) {
  if (smem <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// ---------------------------------------------------------------------------
// The warp plan.
namespace warp {

constexpr int kMaxWarps = 16;
constexpr int kMaxCluster = 8;         // blocks a query (portable cluster)
constexpr int kHalves = 2;             // 32-row halves a step
constexpr int kStep = 32 * kHalves;    // rows a warp scores a step
constexpr int kList = 64;              // the widest list
constexpr int kGather = 128;           // the keys one warp sorts at the end
constexpr int kBins = 256;             // radix-select bins a pass

// Dynamic shared memory of a warp-plan block: a candidate key for each
// row of its columns' clusters (`slots`, rounded up to even), 128 gathered
// keys, the radix histogram, an inbox of 64 keys for each other block of
// its cluster, then the PQ tables. Mirrored by
// kernels/ivf_probe.py::warp_smem.
__host__ __device__ inline int64_t cand_keys(int64_t slots) {
  return (slots + 1) & ~int64_t(1);
}

__host__ __device__ inline size_t smem_bytes(int64_t slots, int cols,
                                             int m_smem, int cluster) {
  return sizeof(uint64_t) *
             (size_t(cand_keys(slots)) + kGather + size_t(cluster - 1) * kList) +
         sizeof(uint32_t) * kBins +
         sizeof(float) * size_t(cols) * m_smem * kEntries;
}

// A block's shared selection state.
struct State {
  uint32_t count;      // candidate keys
  uint32_t lo, hi;     // their least and greatest distance bits
  uint32_t gathered;   // keys gathered at or below the bound
  uint32_t prefix;     // the radix select's fixed distance bits
  uint32_t below;      // keys below the chosen bin
  uint32_t need;       // the rank sought within the chosen bin
  uint32_t in_bin;     // keys in the chosen bin
};

// The block's shared memory: candidates (a slot a row, empty where the row
// is dead), gathered [kGather], histogram [kBins], the inbox [cluster -
// 1][kList] (the first block's: the other blocks write their lists there),
// tables.
struct Smem {
  uint64_t* cand;
  uint64_t* gathered;
  uint32_t* hist;
  uint64_t* inbox;
  float* lut;
};

__device__ __forceinline__ Smem carve(unsigned char* smem, int64_t slots,
                                      int cluster) {
  Smem m;
  m.cand = reinterpret_cast<uint64_t*>(smem);
  m.gathered = m.cand + cand_keys(slots);
  m.hist = reinterpret_cast<uint32_t*>(m.gathered + kGather);
  m.inbox = reinterpret_cast<uint64_t*>(m.hist + kBins);
  m.lut = reinterpret_cast<float*>(m.inbox + (cluster - 1) * kList);
  return m;
}

// The cluster barrier split in two: every thread arrives at the kernel's
// start (relaxed: it only says the block has started) and waits before it
// writes another block's shared memory; then one release/acquire barrier
// orders the lists written into the first block's inbox before its reads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Every candidate slot empty, the counts zero. Block-wide (a barrier must
// follow before the slots are written).
__device__ __forceinline__ void init_state(const Smem& m, State& st,
                                           int64_t slots) {
  for (int64_t i = threadIdx.x; i < slots; i += blockDim.x)
    m.cand[i] = zen::kEmptyKey;
  if (threadIdx.x == 0) {
    st.count = 0;
    st.lo = 0xffffffffu;
    st.hi = 0;
    st.gathered = 0;
  }
}

// The key of a lane's row into the row's own candidate slot when the row
// is live with a finite distance (an infinite distance never displaces an
// empty slot, as in the reference's merge); count, lo and hi track the
// lane's keys and their least and greatest distance bits.
__device__ __forceinline__ void offer(uint64_t* slot, bool live, float z2,
                                      uint32_t pos, uint32_t& count,
                                      uint32_t& lo, uint32_t& hi) {
  const float d = zen::distance(z2);
  if (live && d < __int_as_float(0x7f800000)) {
    *slot = zen::make_key(d, true, pos);
    const uint32_t b = __float_as_uint(d);
    lo = min(lo, b);
    hi = max(hi, b);
    ++count;
  }
}

// After the scan: the block's count of keys and their least and greatest
// distance bits.
__device__ __forceinline__ void publish_range(State& st, uint32_t count,
                                              uint32_t lo, uint32_t hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(~0u, count, o);
    lo = min(lo, __shfl_xor_sync(~0u, lo, o));
    hi = max(hi, __shfl_xor_sync(~0u, hi, o));
  }
  if ((threadIdx.x & 31) == 0 && count > 0) {
    atomicAdd(&st.count, count);
    atomicMin(&st.lo, lo);
    atomicMax(&st.hi, hi);
  }
}

// Radix select over the candidates' distance bits: the bound B such that
// the keys at or below it hold the n_out smallest and number at most
// kGather (few), or, when that takes every bit, all keys of the n_out-th
// key's distance (not few). Each pass histograms the next 8 bits of the
// keys that agree with the bits fixed so far, the first pass starting at
// the highest bit in which the block's keys differ; warp 0 finds the bin
// holding the n_out-th key. Block-wide.
__device__ uint32_t select_bound(const Smem& m, State& st, int64_t slots,
                                 int n_out, bool& few, PhaseMarks& marks) {
  const uint32_t count = st.count, diff = st.lo ^ st.hi;
  few = count <= kGather;
  if (few || diff == 0) return st.hi;  // every key
  const int top = 31 - __clz(diff);  // the keys agree above it
  int shift = max(top - 7, 0);
  uint32_t mask = top == 31 ? 0u : ~((2u << top) - 1u);
  uint32_t prefix = st.lo & mask, need = n_out, below = 0;
  for (;;) {
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) m.hist[i] = 0;
    __syncthreads();
    for (int64_t i = threadIdx.x; i < slots; i += blockDim.x) {
      const uint64_t key = m.cand[i];
      const uint32_t b = uint32_t(key >> 32);
      if (key != zen::kEmptyKey && (b & mask) == prefix)
        atomicAdd(&m.hist[(b >> shift) & 255], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // warp 0: the bin of the need-th key
      const int lane = threadIdx.x;
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += (c[j] = m.hist[8 * lane + j]);
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += t;
      }
      uint32_t cum = incl - sum;
      if (cum < need && need <= incl) {  // one lane
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= need) {
            st.prefix = prefix | (uint32_t(8 * lane + j) << shift);
            st.below = below + cum;
            st.need = need - cum;
            st.in_bin = c[j];
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    marks.radix_pass(int(count));
    prefix = st.prefix;
    below = st.below;
    need = st.need;
    mask |= 0xffu << shift;
    few = below + st.in_bin <= kGather;
    if (few || shift == 0) return prefix | ((1u << shift) - 1u);
    shift = max(shift - 8, 0);
  }
}

// The keys at or below the bound, sorted into warp 0's list (l0, l1), w
// wide: gathered by every warp when they number at most kGather (one or
// two sorts), else (many keys of one distance) scanned by warp 0 alone, 32
// at a time into the gathered buffer, sorting and merging whenever it might
// not hold the next 32. Block-wide.
__device__ __forceinline__ void gather(const Smem& m, State& st,
                                       int64_t slots, uint32_t bound,
                                       bool few, int w, uint64_t& l0,
                                       uint64_t& l1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  l0 = l1 = zen::kEmptyKey;
  if (few) {
    for (int64_t i0 = warp * 32; i0 < slots; i0 += blockDim.x) {
      const int64_t i = i0 + lane;
      const uint64_t key = i < slots ? m.cand[i] : zen::kEmptyKey;
      const bool keep = key != zen::kEmptyKey && uint32_t(key >> 32) <= bound;
      const unsigned ballot = __ballot_sync(~0u, keep);
      if (ballot == 0) continue;
      uint32_t base = 0;
      if (lane == 0) base = atomicAdd(&st.gathered, uint32_t(__popc(ballot)));
      base = __shfl_sync(~0u, base, 0);
      if (keep) m.gathered[base + __popc(ballot & ((1u << lane) - 1u))] = key;
    }
    __syncthreads();
    if (warp == 0) {
      const int g = int(st.gathered);
      for (int c0 = 0; c0 < g; c0 += kList)
        zen::flush64(l0, l1, m.gathered + c0, min(kList, g - c0), w);
    }
    return;
  }
  if (warp != 0) return;
  int cnt = 0;
  for (int64_t i0 = 0; i0 < slots; i0 += 32) {
    const int64_t i = i0 + lane;
    const uint64_t key = i < slots ? m.cand[i] : zen::kEmptyKey;
    const bool keep = key != zen::kEmptyKey && uint32_t(key >> 32) <= bound;
    const unsigned ballot = __ballot_sync(~0u, keep);
    if (keep) m.gathered[cnt + __popc(ballot & ((1u << lane) - 1u))] = key;
    cnt += __popc(ballot);
    if (cnt > kList - 32) {
      __syncwarp();
      zen::flush64(l0, l1, m.gathered, cnt, w);
      __syncwarp();
      cnt = 0;
    }
  }
  __syncwarp();
  if (cnt > 0) zen::flush64(l0, l1, m.gathered, cnt, w);
}

// After the scan: the block's selection into warp 0's registers; then,
// across the query's cluster of blocks, the first block's warp 0 merges the
// other blocks' lists from their shared memory (distributed shared memory)
// and writes the query's n results from its registers.
__device__ __forceinline__ void finish(const Smem& m, State& st,
                                       int64_t slots, uint32_t count,
                                       uint32_t lo, uint32_t hi, int w,
                                       int n_out, int cluster,
                                       const int32_t* tile_ids,
                                       const int32_t* probes_q,
                                       int64_t cluster_rows, float* out_d,
                                       int32_t* out_i, PhaseMarks& marks) {
  namespace cg = cooperative_groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  publish_range(st, count, lo, hi);
  marks.mark(2);
  __syncthreads();
  marks.mark(3);
  bool few;
  const uint32_t bound = select_bound(m, st, slots, n_out, few, marks);
  marks.mark(4);
  uint64_t l0, l1;
  gather(m, st, slots, bound, few, w, l0, l1);
  marks.mark(5);
  bool lead = true;
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = int(cl.block_rank());
    lead = rank == 0;
    cluster_wait();  // every block of the cluster has started
    if (warp == 0 && !lead) {  // the block's list, into the first block's
      uint64_t* inbox = cl.map_shared_rank(m.inbox, 0) + (rank - 1) * kList;
      if (lane < w) inbox[lane] = l0;
      if (lane + 32 < w) inbox[lane + 32] = l1;
    }
    cluster_arrive();
    cluster_wait();  // the lists are in the first block's inbox
    if (lead && warp == 0) {
      for (int r = 1; r < cluster; ++r) {
        const uint64_t* b = m.inbox + (r - 1) * kList;
        zen::merge64(l0, l1, lane < w ? b[lane] : zen::kEmptyKey,
                     lane + 32 < w ? b[lane + 32] : zen::kEmptyKey, w);
      }
    }
  }
  marks.mark(6);
  if (lead && warp == 0) {
    const int64_t o = int64_t(blockIdx.x / cluster) * n_out;
    if (lane < n_out)
      write_result(l0, tile_ids, probes_q, cluster_rows, out_d + o + lane,
                   out_i + o + lane);
    if (lane + 32 < n_out)
      write_result(l1, tile_ids, probes_q, cluster_rows,
                   out_d + o + lane + 32, out_i + o + lane + 32);
  }
  marks.mark(7);
  marks.end();
}

// The block's share of the work: block g of query q's cluster serves probe
// columns [g * cols, (g + 1) * cols), `splits` items a column; warp i takes
// items i, i + warps, ...
struct Share {
  int q, p0, n_items;
};

__device__ __forceinline__ Share block_share(int n_probe, int splits,
                                             int cols, int cluster) {
  Share sh;
  sh.q = blockIdx.x / cluster;
  sh.p0 = (blockIdx.x - sh.q * cluster) * cols;
  sh.n_items = max(0, min(cols, n_probe - sh.p0)) * splits;
  return sh;
}

// Whether this lane's rows of the step at j0 (j0 + 32 h + r of each half
// h) are live: inside the split and not -1.
__device__ __forceinline__ void step_ids(const int32_t* __restrict__ ids,
                                         int64_t j0, int64_t j_end, int r,
                                         bool (&live)[kHalves]) {
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    const int64_t j = j0 + 32 * h + r;
    live[h] = j < j_end && __ldg(ids + j) >= 0;
  }
}

// Scalar tiles. kVec: k % 4 == 0 on aligned tiles (vector loads); kOne:
// k <= 16 (one 16-column chunk, the query's columns in registers).
template <typename T, bool kVec, bool kOne>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ivf_probe_warp(const float* __restrict__ queries,
                   const T* __restrict__ tiles,
                   const int32_t* __restrict__ tile_ids,
                   const int32_t* __restrict__ probes,
                   const float* __restrict__ scales, int n_probe,
                   int n_clusters, int64_t cluster_rows, int k, int n_out,
                   int w, int mode, int splits, int64_t split_rows, int cols,
                   int cluster, float* __restrict__ out_d,
                   int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ State st;
  PhaseMarks marks;
  if (cluster > 1) cluster_arrive_relaxed();
  const int64_t slots = int64_t(cols) * cluster_rows;
  const Smem m = carve(smem, slots, cluster);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const Share sh = block_share(n_probe, splits, cols, cluster);
  const int32_t* probes_q = probes + int64_t(sh.q) * n_probe;
  init_state(m, st, slots);
  __syncthreads();
  marks.mark(0);
  // the cluster of the warp's first item, read beside the query
  int c_next = warp < sh.n_items ? __ldg(probes_q + sh.p0 + warp / splits)
                                 : -1;
  // lane 4 grp + part loads columns 16 m + 4 part .. + 3 of rows 8 u + grp
  // of each half and ends with row 8 part + grp's total; the query's norm
  // is summed the same way
  const int part = lane & 3, grp = lane >> 2, row = 8 * part + grp;
  const float* qg = queries + int64_t(sh.q) * k;
  float qn4 = 0.0f, qv[4];
  for (int col = 4 * part; col < k; col += 16) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = col + e < k ? __ldg(qg + col + e) : 0.0f;
      qn4 = fmaf(v, v, qn4);
    }
  }
  qn4 += __shfl_xor_sync(~0u, qn4, 1);
  const float qn = qn4 + __shfl_xor_sync(~0u, qn4, 2);
  const float qa = __ldg(qg + k - 1);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    qv[e] = kOne && 4 * part + e < k - 1 ? __ldg(qg + 4 * part + e) : 0.0f;
  uint32_t count = 0, lo = 0xffffffffu, hi = 0;
  for (int it = warp; it < sh.n_items; it += warps) {
    const int p = sh.p0 + it / splits;
    const int c = c_next;  // and the next item's, an item ahead
    c_next = it + warps < sh.n_items
                 ? __ldg(probes_q + sh.p0 + (it + warps) / splits)
                 : -1;
    if (c < 0 || c >= n_clusters) continue;  // warp-uniform
    const int64_t j_begin = int64_t(it % splits) * split_rows;
    const int64_t j_end = min(cluster_rows, j_begin + split_rows);
    // int8: the cluster's scale (f32 and bf16 are read as they are)
    const float scale =
        sizeof(T) == 1 && scales != nullptr ? __ldg(scales + c) : 1.0f;
    const int64_t base = int64_t(c) * cluster_rows;
    const uint32_t pos0 = uint32_t(int64_t(p) * cluster_rows);
    uint64_t* cand = m.cand + int64_t(p - sh.p0) * cluster_rows;
    bool live[kHalves], next[kHalves];
    step_ids(tile_ids + base, j_begin, j_end, row, next);
    for (int64_t j0 = j_begin; j0 < j_end; j0 += kStep) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) live[h] = next[h];
      step_ids(tile_ids + base, j0 + kStep, j_end, row, next);  // a step
                                                                // ahead
      if (!__any_sync(~0u, live[0] || live[1])) continue;
      // the rows this lane loads (8 u + grp of each half), live as their
      // owner (lane 4 grp + u) says: a dead row's bytes are not read
      bool load[kHalves][4];
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load[h][u] = __shfl_sync(~0u, live[h], (lane & ~3) | u);
      float nx[kHalves][4] = {}, dot[kHalves][4] = {}, xa[kHalves][4] = {};
      for (int m0 = 0; m0 < k; m0 += 16) {
        const int col = m0 + 4 * part;
        float qc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qc[e] = kOne ? qv[e]
                       : (col + e < k - 1 ? __ldg(qg + col + e) : 0.0f);
        float x[kHalves][4][4];
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (load[h][u]) {
              zen::ldg4<T, kVec>(tiles + (base + j0 + 32 * h + 8 * u + grp) * k,
                                 col, k, x[h][u]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) x[h][u][e] = 0.0f;
            }
          }
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (col + e >= k) continue;
              const float v = sizeof(T) == 1 ? __fmul_rn(x[h][u][e], scale)
                                             : x[h][u][e];
              nx[h][u] = fmaf(v, v, nx[h][u]);
              if (col + e < k - 1)
                dot[h][u] = fmaf(qc[e], v, dot[h][u]);
              else
                xa[h][u] = v;
            }
        if (kOne) break;
      }
      float z2[kHalves];
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
        z2[h] = zen::estimate_sq(qn, zen::sum4_transposed(nx[h]),
                                 zen::sum4_transposed(dot[h]), qa,
                                 zen::sum4_transposed(xa[h]), mode);
      marks.mark(1);
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int64_t j = j0 + 32 * h + row;
        offer(cand + j, live[h], z2[h], pos0 + uint32_t(j), count, lo, hi);
      }
      marks.mark(2);
    }
  }
  finish(m, st, slots, count, lo, hi, w, n_out, cluster, tile_ids, probes_q,
         cluster_rows, out_d, out_i, marks);
}

// PQ codes: a lane a row; kVec: M % 4 == 0 (4-byte code loads). The
// block's tables of its columns' first m_smem subspaces sit in shared
// memory after the histogram.
template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ivf_probe_pq_warp(const uint8_t* __restrict__ codes,
                      const int32_t* __restrict__ tile_ids,
                      const int32_t* __restrict__ probes,
                      const float* __restrict__ luts, int n_probe,
                      int n_clusters, int64_t cluster_rows, int m,
                      int m_smem, int n_out, int w, int splits,
                      int64_t split_rows, int cols, int cluster,
                      float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ State st;
  PhaseMarks marks;
  if (cluster > 1) cluster_arrive_relaxed();
  const int64_t slots = int64_t(cols) * cluster_rows;
  const Smem sm = carve(smem, slots, cluster);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const Share sh = block_share(n_probe, splits, cols, cluster);
  const int32_t* probes_q = probes + int64_t(sh.q) * n_probe;
  // the cluster of the warp's first item, read beside the tables
  int c_next = warp < sh.n_items ? __ldg(probes_q + sh.p0 + warp / splits)
                                 : -1;
  init_state(sm, st, slots);
  // the tables of (q, p0 + i), i < n_cols: (M, 256) each, 1 KB a subspace
  const int n_cols = sh.n_items / splits;
  const int per_col = m_smem * (kEntries / 4);  // float4s a column
  for (int t = threadIdx.x; t < n_cols * per_col; t += blockDim.x) {
    const int i = t / per_col, r = t - i * per_col;
    reinterpret_cast<float4*>(sm.lut)[t] = __ldg(
        reinterpret_cast<const float4*>(
            luts + (int64_t(sh.q) * n_probe + sh.p0 + i) * m * kEntries) +
        r);
  }
  __syncthreads();
  uint32_t count = 0, lo = 0xffffffffu, hi = 0;
  for (int it = warp; it < sh.n_items; it += warps) {
    const int i = it / splits, p = sh.p0 + i;
    const int c = c_next;  // and the next item's, an item ahead
    c_next = it + warps < sh.n_items
                 ? __ldg(probes_q + sh.p0 + (it + warps) / splits)
                 : -1;
    if (c < 0 || c >= n_clusters) continue;  // warp-uniform
    const int64_t j_begin = int64_t(it % splits) * split_rows;
    const int64_t j_end = min(cluster_rows, j_begin + split_rows);
    const int64_t base = int64_t(c) * cluster_rows;
    const uint32_t pos0 = uint32_t(int64_t(p) * cluster_rows);
    const float* ls = sm.lut + size_t(i) * m_smem * kEntries;
    const float* lg = luts + (int64_t(sh.q) * n_probe + p) * m * kEntries;
    uint64_t* cand = sm.cand + int64_t(i) * cluster_rows;
    bool live[kHalves], next[kHalves];
    step_ids(tile_ids + base, j_begin, j_end, lane, next);
    for (int64_t j0 = j_begin; j0 < j_end; j0 += kStep) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) live[h] = next[h];
      step_ids(tile_ids + base, j0 + kStep, j_end, lane, next);  // a step
                                                                 // ahead
      if (!__any_sync(~0u, live[0] || live[1])) continue;
      float z2[kHalves] = {};
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        if (!live[h]) continue;
        const uint8_t* code = codes + (base + j0 + 32 * h + lane) * m;
        // summed over m in ascending order
        for (int i0 = 0; i0 < m; i0 += 4) {
          uint8_t b[4];
          if constexpr (kVec) {
            const uint32_t word =
                __ldg(reinterpret_cast<const uint32_t*>(code + i0));
#pragma unroll
            for (int e = 0; e < 4; ++e) b[e] = uint8_t(word >> (8 * e));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              b[e] = i0 + e < m ? __ldg(code + i0 + e) : 0;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int mi = i0 + e;
            if (mi >= m) break;
            z2[h] = __fadd_rn(z2[h], mi < m_smem
                                         ? ls[mi * kEntries + b[e]]
                                         : __ldg(lg + mi * kEntries + b[e]));
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int64_t j = j0 + 32 * h + lane;
        offer(cand + j, live[h], z2[h], pos0 + uint32_t(j), count, lo, hi);
      }
    }
  }
  finish(sm, st, slots, count, lo, hi, w, n_out, cluster, tile_ids,
         probes_q, cluster_rows, out_d, out_i, marks);
}

// The checks both warp launchers make: a plan the kernels take.
inline bool plan_ok(int w, int warps, int splits, int64_t split_rows,
                    int cols, int cluster, int n_probe) {
  return w >= 1 && w <= kList && (w & (w - 1)) == 0 && warps >= 1 &&
         warps <= kMaxWarps && splits >= 1 && split_rows >= 1 && cols >= 1 &&
         cluster >= 1 && cluster <= kMaxCluster &&
         int64_t(cols) * (cluster - 1) < n_probe;
}

// Launches a warp-plan kernel, one cluster of `cluster` blocks a query.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int nq, int warps, int cluster,
                   int smem, cudaStream_t s, Args... args) {
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nq * cluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(bool vec, bool one, int nq, int warps, int cluster,
                          int smem, cudaStream_t s, const float* q,
                          const void* tiles, const int32_t* ids,
                          const int32_t* probes, const float* scales,
                          int n_probe, int n_clusters, int64_t cluster_rows,
                          int k, int n_out, int w, int mode, int splits,
                          int64_t split_rows, int cols, float* out_d,
                          int32_t* out_i) {
  const T* t = static_cast<const T*>(tiles);
#define IVF_WARP_LAUNCH(V, O)                                                 \
  launch(ivf_probe_warp<T, V, O>, nq, warps, cluster, smem, s, q, t, ids,     \
         probes, scales, n_probe, n_clusters, cluster_rows, k, n_out, w, mode, \
         splits, split_rows, cols, cluster, out_d, out_i)
  if (vec) return one ? IVF_WARP_LAUNCH(true, true) : IVF_WARP_LAUNCH(true, false);
  return one ? IVF_WARP_LAUNCH(false, true) : IVF_WARP_LAUNCH(false, false);
#undef IVF_WARP_LAUNCH
}

}  // namespace warp

// The shared bytes the block plan's pass-1 lists need (none when they are
// global).
size_t list_smem_bytes(int w, int cap, bool global_lists) {
  return global_lists ? 0 : sizeof(uint64_t) * (size_t(w) + cap);
}

cudaError_t launch_merge(const uint64_t* partial, const int32_t* tile_ids,
                         const int32_t* probes, int nq, int n_probe,
                         int64_t cluster_rows, int w, int group,
                         int merge_smem, int n_out, uint64_t* mscratch,
                         float* out_d, int32_t* out_i, cudaStream_t s) {
  const bool in_smem = merge_smem > 0;
  if (in_smem) {
    if (group < 1 ||
        size_t(merge_smem) < sizeof(uint64_t) * size_t(group + 1) * w)
      return cudaErrorInvalidValue;
    cudaError_t err = set_smem(
        reinterpret_cast<const void*>(ivf_probe_merge), merge_smem);
    if (err != cudaSuccess) return err;
  } else if (mscratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  ivf_probe_merge<<<nq, kThreads, merge_smem, s>>>(
      partial, tile_ids, probes, n_probe, cluster_rows, w, group,
      in_smem, n_out, mscratch, out_d, out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial(int blocks, int smem, cudaStream_t s,
                           const float* queries, const void* tiles,
                           const int32_t* tile_ids, const int32_t* probes,
                           const float* scales, int n_probe, int n_clusters,
                           int64_t cluster_rows, int k, int n_out, int w,
                           int cap, bool global_lists, int mode,
                           uint64_t* partial, uint64_t* gscratch) {
  const size_t need = list_smem_bytes(w, cap, global_lists) +
                      (global_lists ? 0 : sizeof(float) * k);
  if (size_t(smem) < need || (global_lists && gscratch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(ivf_probe_partial<T>), smem);
  if (err != cudaSuccess) return err;
  ivf_probe_partial<T><<<blocks, kThreads, smem, s>>>(
      queries, static_cast<const T*>(tiles), tile_ids, probes, scales,
      n_probe, n_clusters, cluster_rows, k, n_out, w, cap, global_lists, mode,
      partial, gscratch);
  return cudaGetLastError();
}

constexpr int kBlockPlan = 0, kWarpPlan = 1;

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. scales (C,) may be null. probes is
// (nq, n_probe) int32, cluster_rows = T * rows. The plan comes from
// kernels/ivf_probe.py::probe_plan. kernel 1, the warp plan: w, smem,
// warps, splits, split_rows, cols, cluster (blocks a query), vec (k % 4 ==
// 0 on tiles aligned to 4 elements); one launch, writing out_d and out_i.
// kernel 0, the block plan: w, cap, global_lists, smem; partial holds nq *
// n_probe * w keys, gscratch (global_lists only) nq * n_probe * cap; pass
// 2 merges group lists at a time in merge_smem bytes, or in mscratch (nq *
// w keys) when merge_smem is 0. The other plan's fields are not read.
// Returns the CUDA error code of the launches (0 on success).
int ivf_probe_launch(const void* queries, const void* tiles,
                     const void* tile_ids, const void* probes,
                     const void* scales, int dtype, int nq, int n_probe,
                     int n_clusters, long long cluster_rows, int k, int n_out,
                     int mode, int kernel, int w, int cap, int global_lists,
                     int smem, int group, int merge_smem, int warps,
                     int splits, long long split_rows, int cols, int cluster,
                     int vec, void* partial, void* gscratch, void* mscratch,
                     void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const int32_t* ids = static_cast<const int32_t*>(tile_ids);
  const int32_t* pr = static_cast<const int32_t*>(probes);
  const float* sc = static_cast<const float*>(scales);
  uint64_t* part = static_cast<uint64_t*>(partial);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaError_t err;
  if (kernel == kWarpPlan) {
    if (!warp::plan_ok(w, warps, splits, split_rows, cols, cluster,
                       n_probe) ||
        size_t(smem) <
            warp::smem_bytes(int64_t(cols) * cluster_rows, cols, 0, cluster))
      return int(cudaErrorInvalidValue);
    const bool one = k <= 16;
#define IVF_WARP_ARGS                                                      \
  vec != 0, one, nq, warps, cluster, smem, s, q, tiles, ids, pr, sc,       \
      n_probe, n_clusters, cluster_rows, k, n_out, w, mode, splits,        \
      split_rows, cols, od, oi
    switch (dtype) {
      case 0:
        return int(warp::launch_scalar<float>(IVF_WARP_ARGS));
      case 1:
        return int(warp::launch_scalar<__nv_bfloat16>(IVF_WARP_ARGS));
      case 2:
        return int(warp::launch_scalar<int8_t>(IVF_WARP_ARGS));
      default:
        return int(cudaErrorInvalidValue);
    }
#undef IVF_WARP_ARGS
  }
  if (kernel != kBlockPlan) return int(cudaErrorInvalidValue);
  const int blocks = nq * n_probe;
  uint64_t* gs = static_cast<uint64_t*>(gscratch);
  const bool g = global_lists != 0;
  switch (dtype) {
    case 0:
      err = launch_partial<float>(blocks, smem, s, q, tiles, ids, pr, sc,
                                  n_probe, n_clusters, cluster_rows, k, n_out,
                                  w, cap, g, mode, part, gs);
      break;
    case 1:
      err = launch_partial<__nv_bfloat16>(blocks, smem, s, q, tiles, ids, pr,
                                          sc, n_probe, n_clusters,
                                          cluster_rows, k, n_out, w, cap, g,
                                          mode, part, gs);
      break;
    case 2:
      err = launch_partial<int8_t>(blocks, smem, s, q, tiles, ids, pr, sc,
                                   n_probe, n_clusters, cluster_rows, k,
                                   n_out, w, cap, g, mode, part, gs);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(part, ids, pr, nq, n_probe, cluster_rows,
                          w, group, merge_smem, n_out,
                          static_cast<uint64_t*>(mscratch), od, oi, s));
}

// codes (C*T, rows, m) uint8, luts (nq, n_probe, m, 256) f32, the first
// m_smem subspaces' tables staged in shared memory (the block plan: of its
// one column; the warp plan: of each of its `cols` columns); vec: m % 4 ==
// 0 on an aligned code array (the warp plan's 4-byte code loads); the rest
// as for ivf_probe_launch.
int ivf_probe_pq_launch(const void* codes, const void* tile_ids,
                        const void* probes, const void* luts, int nq,
                        int n_probe, int n_clusters, long long cluster_rows,
                        int m, int n_out, int kernel, int w, int cap,
                        int global_lists, int smem, int m_smem, int group,
                        int merge_smem, int warps, int splits,
                        long long split_rows, int cols, int cluster, int vec,
                        void* partial, void* gscratch, void* mscratch,
                        void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const int32_t* ids = static_cast<const int32_t*>(tile_ids);
  const int32_t* pr = static_cast<const int32_t*>(probes);
  const float* lt = static_cast<const float*>(luts);
  uint64_t* part = static_cast<uint64_t*>(partial);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  if (m_smem < 0 || m_smem > m) return int(cudaErrorInvalidValue);
  if (kernel == kWarpPlan) {
    if (!warp::plan_ok(w, warps, splits, split_rows, cols, cluster,
                       n_probe) ||
        size_t(smem) <
            warp::smem_bytes(int64_t(cols) * cluster_rows, cols, m_smem,
                             cluster))
      return int(cudaErrorInvalidValue);
    return int(warp::launch(vec ? &warp::ivf_probe_pq_warp<true>
                                : &warp::ivf_probe_pq_warp<false>,
                            nq, warps, cluster, smem, s, cd, ids, pr, lt,
                            n_probe, n_clusters, int64_t(cluster_rows), m,
                            m_smem, n_out, w, splits, int64_t(split_rows),
                            cols, cluster, od, oi));
  }
  if (kernel != kBlockPlan) return int(cudaErrorInvalidValue);
  uint64_t* gs = static_cast<uint64_t*>(gscratch);
  const bool g = global_lists != 0;
  const size_t need =
      list_smem_bytes(w, cap, g) + sizeof(float) * size_t(m_smem) * kEntries;
  if (size_t(smem) < need || (g && gs == nullptr))
    return int(cudaErrorInvalidValue);
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(ivf_probe_pq_partial), smem);
  if (err != cudaSuccess) return int(err);
  ivf_probe_pq_partial<<<nq * n_probe, kThreads, smem, s>>>(
      cd, ids, pr, lt, n_probe, n_clusters, cluster_rows, m, m_smem, n_out, w,
      cap, g, part, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(part, ids, pr, nq, n_probe, cluster_rows,
                          w, group, merge_smem, n_out,
                          static_cast<uint64_t*>(mscratch), od, oi, s));
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
