// Streaming fused Zen/Lwb/Upb top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/zen_topk.py::zen_topk (body
// _topk_kernel): for queries (Q, k) f32 and an index (N, k) stored f32, bf16
// or int8 (+ (N,) f32 row scales), return each query's n nearest rows under
// the estimator, ascending by (distance, row id), without ever holding the
// (Q, N) distance matrix.
//
// What bounds it on an H100, at the serving shape (Q = 64, N = 1e6, k = 16,
// f32): reading the index once, 64 MB, 19.1 us at 3.35 TB/s. Its 2.05
// GFLOP take 30.6 us on the CUDA cores (67 TFLOP/s f32), the bound of the
// SIMT plan; in 3xTF32 on the tensor cores, three products each at 495
// TFLOP/s, 12.4 us, so the MMA plan is bound by the bytes.
//
// Two plans; the wrapper's planner (kernels/zen_topk.py::launch_geometry)
// picks one and sizes it, and the kernels take every number of the plan as
// an argument.
//
// MMA plan (lists up to 64 wide, k <= 16: the serving batch; wider lists
// flush too slowly in registers, and longer dots drift from f32 in the
// tensor cores' accumulation): one block an SM walks a contiguous split of
// N for up to 64 queries.
//   - One producer warp fills a ring of up to 8 stages of 128 rows with TMA
//     bulk copies (cp.async.bulk, completing on an mbarrier a stage). A
//     tile of consecutive rows is one contiguous byte range, so the 1-D
//     copy describes every k, also where k x element size is not a
//     multiple of 16 (no tensor map is needed); a tail under 16 bytes is
//     copied by the producer itself.
//   - Consumer warps own 8 queries each, in up to 16 warps: groups of 8
//     queries times row streams (stream s scores every streams-th tile;
//     the streams' lists merge in the block at the end). A warp scores its
//     rows with mma.sync m16n8k8, rows as M and its queries as N, in split
//     TF32 (x = hi + lo; dot = hi.hi + hi.lo + lo.hi, f32 accumulators),
//     the altitude column zero in the query operand. Rows are dequantised
//     (x row scale) as they leave the stage, and their norms and altitudes
//     summed on the CUDA cores in f32 (dead rows, 1e15 a coordinate, stay
//     ~1.6e31).
//   - Each accumulator's squared estimate (the dot's error is below
//     2^-21 (|q|^2 + |x|^2), a few f32 roundings: one 16-column chunk, so
//     the tensor cores' truncating accumulation stays short) is compared in
//     registers with its query's bound (squared_bound of the n-th best key
//     as of the last flush: stale, so only looser; a row tied with the
//     n-th best passes), and survivors are appended to the query's buffer
//     with __ballot_sync and a prefix count. A buffer that might not hold
//     the next step is flushed by its warp alone: a bitonic sort and merge
//     into the query's running best of w keys, by shuffles. Keys compare
//     in full (a lower id wins a tie). No block-wide barrier runs after
//     set-up.
//   - Lists share a bound across blocks: each publishes its best key into
//     one of n buckets of its query (atomicMin); once all n buckets hold
//     keys (n different rows), their largest bounds the n-th best, and
//     every list filters with it (read at each flush).
// SIMT plan (wider lists or rows): the previous design. A (Q/KQ, S) grid of
// 256-thread blocks scores KQ in {8, 4, 2, 1} queries against one split of
// N in 512-row tiles staged in shared memory through a register double
// buffer, with FMAs on the CUDA cores; candidates are buffered (cap keys a
// query) and merged into the running best by block-wide bitonic flushes.
// Past what one query's lists can keep in shared memory (w >= 16,384 at k
// = 16) the lists and buffers live in global memory (the wrapper's
// scratch).
// Pass 2 (both plans): one block a query merges the S partial lists in a
// tree of pairs, in shared memory when they fit (merge_smem: lists up to
// 64 keys merge pairwise in one warp's registers) and in place in global
// memory otherwise, and writes the first n.
// Scoring and merging live in scoring.cuh, shared with the clustered probe.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "scoring.cuh"

// Phase marks of the MMA consumers for probes/zen_topk_phases.cu, which
// defines ZEN_TOPK_PROBE and these macros before it includes this file.
#ifndef ZEN_TOPK_PROBE
#define ZEN_PROBE_START()
#define ZEN_PROBE_MARK(phase)
#define ZEN_PROBE_FLUSH(count)
#define ZEN_PROBE_END()
#endif

namespace {

// ---------------------------------------------------------------------------
// The SIMT plan.

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;            // index rows per thread per tile
constexpr int kTile = kThreads * kRowsPerThread;  // 512 rows per tile
constexpr int kCols = 16;                    // columns staged per pass
constexpr int kXStride = kCols + 1;          // odd stride: no bank conflicts
constexpr int kRowsPerStep = kThreads / kCols;
constexpr int kLoads = kTile / kRowsPerStep;  // staged values per thread

// Dynamic shared memory a pass-1 block needs: the layout of
// zen_topk_partial, mirrored by kernels/zen_topk.py::simt_smem. The
// launcher refuses a plan that gives less.
template <int KQ, bool kGlobal>
size_t partial_smem_bytes(int k, int w, int cap) {
  const size_t lists =
      kGlobal ? 0 : sizeof(uint64_t) * KQ * (size_t(w) + cap) +
                        sizeof(float) * KQ * size_t(k);
  return lists + sizeof(float) * (kTile * kXStride + 3 * KQ) +
         sizeof(int) * KQ;
}

// Bitonic-sorts each query's buffered candidates and merges them into its
// running best, then empties the buffers and refreshes the thresholds.
// Block-wide; `most` is the largest count (block-uniform). best and buf
// are in shared or (one query a block) global memory; __syncthreads orders
// both for the block.
template <int KQ>
__device__ __forceinline__ void flush(uint64_t* best, uint64_t* buf,
                                      int* cnt, float* bound, int w, int cap,
                                      int n_out, int most) {
  int p = 1;
  while (p < most) p <<= 1;
  const int fill = max(p, w), shift = zen::log2_pow2(fill);
  for (int t = threadIdx.x; t < KQ * fill; t += kThreads) {
    const int q = t >> shift, i = t & (fill - 1);
    if (i >= cnt[q]) buf[int64_t(q) * cap + i] = zen::kEmptyKey;
  }
  __syncthreads();
  zen::bitonic_sort_segments(buf, KQ, p, cap);
  zen::merge_sorted_segments(best, w, buf, cap, KQ, w);
  if (threadIdx.x < KQ) {
    cnt[threadIdx.x] = 0;
    bound[threadIdx.x] = zen::squared_bound(
        zen::key_distance(best[threadIdx.x * w + n_out - 1]));
  }
  __syncthreads();
}

// Loads one chunk (rows [tile0, tile0 + kTile) x columns [c0, c0 + kCols))
// into registers, zeros outside the split or the row; a thread holds column
// lc of rows lr, lr + kRowsPerStep, ... Nothing waits on these loads until
// the values are stored to shared memory, one chunk later.
template <typename T>
__device__ __forceinline__ void load_chunk(T (&pre)[kLoads],
                                           const T* __restrict__ index,
                                           int64_t tile0, int64_t row_end,
                                           int k, int c0, int lc, int lr) {
  const bool col_ok = lc < min(kCols, k - c0);
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int64_t row = tile0 + lr + it * kRowsPerStep;
    pre[it] = (col_ok && row < row_end) ? index[row * k + c0 + lc] : T{};
  }
}

// The row scales of the rows this thread scores in a tile (1 without).
__device__ __forceinline__ void load_scales(float (&pre)[kRowsPerThread],
                                            const float* __restrict__ scales,
                                            int64_t tile0, int64_t row_end) {
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = tile0 + threadIdx.x + r * kThreads;
    pre[r] = (scales != nullptr && row < row_end) ? scales[row] : 1.0f;
  }
}

// Column c of the KQ staged queries (qs is [k][KQ]), with vector loads.
template <int KQ>
__device__ __forceinline__ void query_column(const float* qc,
                                             float (&qv)[KQ]) {
  if constexpr (KQ % 4 == 0) {
#pragma unroll
    for (int g = 0; g < KQ / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(qc + 4 * g);
      qv[4 * g] = v.x;
      qv[4 * g + 1] = v.y;
      qv[4 * g + 2] = v.z;
      qv[4 * g + 3] = v.w;
    }
  } else if constexpr (KQ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(qc);
    qv[0] = v.x;
    qv[1] = v.y;
  } else {
    qv[0] = qc[0];
  }
}

// KQ queries a block. kGlobal (KQ = 1): the list is partial's own slot,
// the buffer is gscratch's row of this block, and the query is read from
// `queries` in place.
template <typename T, int KQ, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 2)
    zen_topk_partial(const float* __restrict__ queries,
                     const T* __restrict__ index,
                     const float* __restrict__ scales, int nq,
                     int64_t n_index, int k, int n_out, int w, int cap,
                     int64_t split_rows, int n_lists, int mode,
                     uint64_t* partial, uint64_t* gscratch) {
  static_assert(!kGlobal || KQ == 1, "global lists hold one query a block");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * KQ;
  const int split = blockIdx.y;
  uint64_t* best;  // [KQ][w]
  uint64_t* buf;   // [KQ][cap]
  const float* qs;  // [k][KQ]
  float* xs;        // [kTile][kXStride]
  if constexpr (kGlobal) {
    best = partial + (int64_t(q0) * n_lists + split) * w;
    buf = gscratch + (int64_t(q0) * gridDim.y + split) * cap;
    qs = queries + int64_t(q0) * k;
    xs = reinterpret_cast<float*>(smem);
  } else {
    best = reinterpret_cast<uint64_t*>(smem);
    buf = best + KQ * w;
    float* qsm = reinterpret_cast<float*>(buf + KQ * cap);
    for (int t = tid; t < KQ * k; t += kThreads) {
      const int q = t / k, c = t - q * k;
      qsm[c * KQ + q] =
          (q0 + q < nq) ? queries[int64_t(q0 + q) * k + c] : 0.0f;
    }
    qs = qsm;
    xs = qsm + KQ * k;
  }
  float* qn = xs + kTile * kXStride;
  float* qa = qn + KQ;
  float* bound = qa + KQ;  // squared_bound of each query's n-th best
  int* cnt = reinterpret_cast<int*>(bound + KQ);

  const int64_t row_begin = int64_t(split) * split_rows;
  const int64_t row_end = min(n_index, row_begin + split_rows);

  for (int t = tid; t < KQ * w; t += kThreads) best[t] = zen::kEmptyKey;
  if (tid < KQ) cnt[tid] = 0;
  __syncthreads();
  if (tid < KQ) {
    float s = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float v = qs[c * KQ + tid];
      s = fmaf(v, v, s);
    }
    qn[tid] = s;
    qa[tid] = qs[(k - 1) * KQ + tid];
    bound[tid] = __int_as_float(0x7f800000);  // +inf: every row is wanted
  }
  __syncthreads();

  const int lc = tid % kCols, lr = tid / kCols;
  // register double buffer: the next chunk's loads are in flight while the
  // current chunk is scored
  T pre[kLoads];
  float pre_s[kRowsPerThread];
  if (row_begin < row_end) {
    load_chunk(pre, index, row_begin, row_end, k, 0, lc, lr);
    load_scales(pre_s, scales, row_begin, row_end);
  }
  for (int64_t tile0 = row_begin; tile0 < row_end; tile0 += kTile) {
    float dot[kRowsPerThread][KQ];
    float nx[kRowsPerThread], xa[kRowsPerThread], sc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      nx[r] = 0.0f;
      xa[r] = 0.0f;
      sc[r] = pre_s[r];
#pragma unroll
      for (int q = 0; q < KQ; ++q) dot[r][q] = 0.0f;
    }
    for (int c0 = 0; c0 < k; c0 += kCols) {
      const int kc = min(kCols, k - c0);
#pragma unroll
      for (int it = 0; it < kLoads; ++it)
        xs[(lr + it * kRowsPerStep) * kXStride + lc] = zen::to_float(pre[it]);
      __syncthreads();
      if (c0 + kCols < k) {
        load_chunk(pre, index, tile0, row_end, k, c0 + kCols, lc, lr);
      } else if (tile0 + kTile < row_end) {
        load_chunk(pre, index, tile0 + kTile, row_end, k, 0, lc, lr);
        load_scales(pre_s, scales, tile0 + kTile, row_end);
      }
      // dequantise (f32 value times row scale) as the plain version does;
      // the dot runs over the first k-1 columns, and the altitude column
      // (the last one of the last chunk) only enters the norm
      const int kdot = min(kc, k - 1 - c0);
#pragma unroll 4
      for (int c = 0; c < kdot; ++c) {
        float qv[KQ];
        query_column<KQ>(qs + (c0 + c) * KQ, qv);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float v = xs[(tid + r * kThreads) * kXStride + c] * sc[r];
          nx[r] = fmaf(v, v, nx[r]);
#pragma unroll
          for (int q = 0; q < KQ; ++q) dot[r][q] = fmaf(qv[q], v, dot[r][q]);
        }
      }
      if (kdot < kc) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          xa[r] = xs[(tid + r * kThreads) * kXStride + kdot] * sc[r];
          nx[r] = fmaf(xa[r], xa[r], nx[r]);
        }
      }
      __syncthreads();
    }
    // buffer the candidates that beat each query's n-th best as of the
    // last flush (a stale, looser threshold only lets more rows in)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int64_t row = tile0 + tid + r * kThreads;
      const int32_t id = row < row_end ? int32_t(row) : -1;
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        if (q0 + q >= nq) continue;
        const float z2 = zen::estimate_sq(qn[q], nx[r], dot[r][q], qa[q],
                                          xa[r], mode);
        if (z2 > bound[q]) continue;
        const uint64_t key =
            zen::make_key(zen::distance(z2), id >= 0, uint32_t(id));
        if (key < best[q * w + n_out - 1]) {
          buf[int64_t(q) * cap + atomicAdd(&cnt[q], 1)] = key;
        }
      }
    }
    __syncthreads();
    int most = 0;
#pragma unroll
    for (int q = 0; q < KQ; ++q) most = max(most, cnt[q]);
    // block-uniform: every thread read the same counts. Flush only when
    // the next tile might not fit.
    if (most > cap - kTile)
      flush<KQ>(best, buf, cnt, bound, w, cap, n_out, most);
  }
  int most = 0;
#pragma unroll
  for (int q = 0; q < KQ; ++q) most = max(most, cnt[q]);
  if (most > 0) flush<KQ>(best, buf, cnt, bound, w, cap, n_out, most);

  if constexpr (!kGlobal) {
    for (int t = tid; t < KQ * w; t += kThreads) {
      const int q = t / w, i = t - q * w;
      if (q0 + q < nq)
        partial[(int64_t(q0 + q) * n_lists + split) * w + i] = best[t];
    }
  }
}

// Pass 2, one block per query: tree-merge the S sorted partial lists and
// write the first n as (distance, id). In shared memory when the plan gives
// it (merge_smem): up to 64 keys a list each pair of lists merges in one
// warp's registers, by shuffles, wider lists by block-wide networks; else
// in place in the query's n_lists x w slots of partial.
constexpr int kMergeThreads = 1024;

__global__ void __launch_bounds__(kMergeThreads)
    zen_topk_merge(uint64_t* partial, int n_split, int n_lists, int w,
                   int n_out, bool in_smem, float* __restrict__ out_d,
                   int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  uint64_t* src = partial + int64_t(q) * n_lists * w;
  uint64_t* lists = src;  // [n_lists][w]
  if (in_smem) {  // 16-byte loads where the query's lists start on one
    lists = reinterpret_cast<uint64_t*>(smem);
    const int n = n_split * w;
    int t0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      t0 = n & ~1;
      for (int t = threadIdx.x; 2 * t < t0; t += blockDim.x)
        reinterpret_cast<uint4*>(lists)[t] =
            __ldcg(reinterpret_cast<const uint4*>(src) + t);
    }
    for (int t = t0 + threadIdx.x; t < n; t += blockDim.x) lists[t] = src[t];
  }
  __syncthreads();
  if (in_smem && w <= 64) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int stride = 1; stride < n_split; stride <<= 1) {
      const int pairs = (n_split - stride + 2 * stride - 1) / (2 * stride);
      for (int p = warp; p < pairs; p += n_warps) {
        uint64_t* l = lists + int64_t(2 * stride * p) * w;
        const uint64_t* b = l + int64_t(stride) * w;
        uint64_t l0 = lane < w ? l[lane] : zen::kEmptyKey;
        uint64_t l1 = lane + 32 < w ? l[lane + 32] : zen::kEmptyKey;
        const uint64_t b0 = lane < w ? b[lane] : zen::kEmptyKey;
        const uint64_t b1 = lane + 32 < w ? b[lane + 32] : zen::kEmptyKey;
        zen::merge64(l0, l1, b0, b1, w);
        if (lane < w) l[lane] = l0;
        if (lane + 32 < w) l[lane + 32] = l1;
      }
      __syncthreads();
    }
  } else {
    // only pairs of real lists merge
    for (int stride = 1, n_cur = n_split; n_cur > 1; stride <<= 1) {
      zen::merge_sorted_segments(lists, 2 * stride * w, lists + stride * w,
                                 2 * stride * w, n_cur / 2, w);
      n_cur = (n_cur + 1) / 2;
    }
  }
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    const uint64_t key = lists[t];
    out_d[int64_t(q) * n_out + t] = zen::key_distance(key);
    out_i[int64_t(q) * n_out + t] = int32_t(zen::key_tie(key));
  }
}

template <typename T, int KQ, bool kGlobal>
cudaError_t launch_partial(int nq, int n_split, size_t smem,
                           cudaStream_t stream, const float* queries,
                           const void* index, const float* scales,
                           int64_t n_index, int k, int n_out, int w, int cap,
                           int64_t split_rows, int n_lists, int mode,
                           uint64_t* partial, uint64_t* gscratch) {
  if (smem < partial_smem_bytes<KQ, kGlobal>(k, w, cap) ||
      (kGlobal && gscratch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      zen_topk_partial<T, KQ, kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + KQ - 1) / KQ, n_split);
  zen_topk_partial<T, KQ, kGlobal><<<grid, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(index), scales, nq, n_index, k, n_out, w,
      cap, split_rows, n_lists, mode, partial, gscratch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int kq, bool global_lists, int nq, int n_split,
                         size_t smem, cudaStream_t s, const float* q,
                         const void* index, const float* sc, int64_t n_index,
                         int k, int n_out, int w, int cap, int64_t split_rows,
                         int n_lists, int mode, uint64_t* part,
                         uint64_t* gscratch) {
#define ZEN_LAUNCH(KQ, G)                                                   \
  launch_partial<T, KQ, G>(nq, n_split, smem, s, q, index, sc, n_index, k, \
                           n_out, w, cap, split_rows, n_lists, mode, part,  \
                           gscratch)
  if (global_lists) return kq == 1 ? ZEN_LAUNCH(1, true) : cudaErrorInvalidValue;
  switch (kq) {
    case 8:
      return ZEN_LAUNCH(8, false);
    case 4:
      return ZEN_LAUNCH(4, false);
    case 2:
      return ZEN_LAUNCH(2, false);
    case 1:
      return ZEN_LAUNCH(1, false);
    default:
      return cudaErrorInvalidValue;
  }
#undef ZEN_LAUNCH
}


// ---------------------------------------------------------------------------
// The MMA plan.
namespace mma {

constexpr int kWarpQueries = 8;  // a consumer warp's queries: the MMA's n
constexpr int kStepRows = 32;    // rows a warp scores a step: two m16 tiles
constexpr int kMaxWarps = 16;    // consumer warps a block, at most
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 16 * kMaxStages;  // a full and an empty mbarrier
constexpr int kCap = 64;         // buffer keys a query
constexpr int kMaxW = 64;        // the widest running list

// Bytes of one ring stage: the rows (rounded up to 16 B), then their
// scales. Mirrored by kernels/zen_topk.py::mma_stage_bytes.
__host__ __device__ inline size_t stage_bytes(int tile_rows, int k, int es) {
  return ((size_t(tile_rows) * k * es + 15) & ~size_t(15)) +
         sizeof(float) * tile_rows;
}

// Dynamic shared memory of an MMA block: the mbarriers, the ring, then each
// consumer warp's 8 running lists (w keys) and 8 buffers (kCap keys).
// Mirrored by kernels/zen_topk.py::mma_smem; the launcher refuses less.
inline size_t smem_bytes(int k, int es, int w, int warps, int tile_rows,
                         int stages) {
  return kBarBytes + size_t(stages) * stage_bytes(tile_rows, k, es) +
         sizeof(uint64_t) * warps * kWarpQueries * (size_t(w) + kCap);
}

using namespace hopper;  // mbarriers, bulk copies, split TF32, mma.sync

// Copies `bytes` of one array into a stage: the 16-byte multiple by a bulk
// copy (issue), the tail under 16 B here (!issue, before the producer's
// arrival, which publishes it).
__device__ __forceinline__ void stage_copy(unsigned char* dst,
                                           const unsigned char* src, int bytes,
                                           uint64_t* bar, bool issue) {
  const int bulk = bytes & ~15;
  if (!issue) {
    for (int i = bulk; i < bytes; ++i) dst[i] = src[i];
  } else if (bulk > 0) {
    bulk_load(dst, src, bulk, bar);
  }
}

// Columns col .. col + 3 of a staged row, f32; zero past k. With kVec
// (k % 4 == 0) the four are one 16-, 8- or 4-byte load.
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* row, int col, int k,
                                      float (&v)[4]) {
  if constexpr (kVec) {
    if (col >= k) {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    } else if constexpr (sizeof(T) == 4) {
      const float4 u = *reinterpret_cast<const float4*>(row + col);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else if constexpr (sizeof(T) == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + col);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
      const char4 u = *reinterpret_cast<const char4*>(row + col);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = col + j < k ? zen::to_float(row[col + j]) : 0.0f;
  }
}

// The query operand: query g's columns col + 2h and col + 2h + 1 (col = 4t)
// for the two k-steps h, split hi/lo; zero for the altitude column, past
// k, and for a query slot past Q.
__device__ __forceinline__ void query_chunk(const float* qg, bool g_ok, int k,
                                            int col, uint32_t (&hi)[2][2],
                                            uint32_t (&lo)[2][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = col + 2 * h + b;
      split_tf32(g_ok && c < k - 1 ? __ldg(qg + c) : 0.0f, hi[h][b], lo[h][b]);
    }
  }
}

// The bound that the lists of all blocks share. bests holds n_out buckets
// a query (all ones before the launch); every list publishes its best key
// into bucket list_id % n_out with atomicMin, so each bucket holds the key
// of a real row, a different row in each bucket. Once every bucket is
// filled, n_out rows lie at or below the largest bucket: no row beyond it
// can be among the query's n_out nearest, and each list may filter with
// it (warp_flush reads it). It is only read stale, so only looser; all
// ones (no bound) until every bucket is filled.
__device__ __forceinline__ void publish_best(uint64_t* bests, int q,
                                             int n_out, int list_id,
                                             uint64_t best) {
  if (bests != nullptr && (threadIdx.x & 31) == 0 && best != zen::kEmptyKey)
    atomicMin(reinterpret_cast<unsigned long long*>(bests) +
                  int64_t(q) * n_out + list_id % n_out,
              static_cast<unsigned long long>(best));
}

// A buffered key holds max(z2, 0)'s bits (the squared estimate) above the
// row id; a flush turns it into the distance key before sorting.
__device__ __forceinline__ uint64_t to_distance_key(uint64_t z2_key) {
  const float d = zen::distance(__uint_as_float(uint32_t(z2_key >> 32)));
  return (uint64_t(__float_as_uint(d)) << 32) | (z2_key & 0xffffffffu);
}

// Sorts a query's c <= 64 buffered keys (squared-estimate keys, made
// distance keys first, with `convert`) and merges them into its running
// best of w <= 64 keys, in registers, by shuffles; returns the new n-th
// best key, tightened by the shared bound when `buckets` (the query's
// n_out buckets) is given. One warp.
__device__ __noinline__ uint64_t warp_flush(uint64_t* list,
                                            const uint64_t* buf, int c, int w,
                                            int n_out, bool convert,
                                            const uint64_t* buckets) {
  const int lane = threadIdx.x & 31;
  uint64_t most = ~uint64_t(0);
  if (buckets != nullptr) {
    const uint64_t b0 = lane < n_out ? __ldcg(buckets + lane) : 0;
    const uint64_t b1 = lane + 32 < n_out ? __ldcg(buckets + lane + 32) : 0;
    most = b0 > b1 ? b0 : b1;
  }
  uint64_t a = lane < c ? buf[lane] : zen::kEmptyKey;
  uint64_t b = lane + 32 < c ? buf[lane + 32] : zen::kEmptyKey;
  if (convert) {
    if (lane < c) a = to_distance_key(a);
    if (lane + 32 < c) b = to_distance_key(b);
  }
  if (c <= 32)
    zen::sort32(a);  // b holds no key
  else
    zen::sort64(a, b);
  uint64_t l0 = lane < w ? list[lane] : zen::kEmptyKey;
  uint64_t l1 = lane + 32 < w ? list[lane + 32] : zen::kEmptyKey;
  zen::merge64(l0, l1, a, b, w);
  if (lane < w) list[lane] = l0;
  if (lane + 32 < w) list[lane + 32] = l1;
  __syncwarp();
  const int e = n_out - 1;
  const uint64_t nth = __shfl_sync(~0u, e < 32 ? l0 : l1, e & 31);
  if (buckets == nullptr) return nth;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint64_t o = __shfl_xor_sync(~0u, most, j);
    most = o > most ? o : most;
  }
  return nth < most ? nth : most;
}

// Pass 1 of the MMA plan. Block (query block x, split y): `streams` row
// streams of `groups` consumer warps (8 queries each) and one producer
// warp. Stream s scores the tiles t = s mod streams of the split with its
// own lists, and the streams' lists merge at the end; stages is a multiple
// of streams, so a stage serves one stream and its consumers wait on each
// of its mbarrier phases in turn (a parity wait cannot skip one). k <= 16:
// one 16-column chunk, two k-steps; the query operand sits in registers.
// kVec: k % 4 == 0, four columns a load.
template <typename T, bool kVec>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1)
    zen_topk_mma(const float* __restrict__ queries,
                 const T* __restrict__ index,
                 const float* __restrict__ scales, int nq, int64_t n_index,
                 int k, int n_out, int w, int tile_rows, int stages,
                 int streams, int64_t split_rows, int n_lists, int mode,
                 uint64_t* __restrict__ partial,
                 uint64_t* __restrict__ bests) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32 - 1, groups = warps / streams;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const size_t sbytes = stage_bytes(tile_rows, k, sizeof(T));
  const size_t xbytes = sbytes - sizeof(float) * tile_rows;
  unsigned char* ring = smem + kBarBytes;
  uint64_t* lists = reinterpret_cast<uint64_t*>(ring + stages * sbytes);
  uint64_t* bufs = lists + size_t(warps) * kWarpQueries * w;
  const int64_t row_begin = int64_t(blockIdx.y) * split_rows;
  const int64_t row_end = min(n_index, row_begin + split_rows);
  const int n_tiles =
      row_begin < row_end ? int((row_end - row_begin - 1) / tile_rows) + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], groups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == warps) {  // the producer: one lane keeps the ring full
    if (lane == 0) {
      for (int tl = 0; tl < n_tiles; ++tl) {
        const int s = tl % stages;
        if (tl >= stages) bar_wait(&empty[s], ((tl / stages) + 1) & 1);
        const int64_t tile0 = row_begin + int64_t(tl) * tile_rows;
        const int rows = int(min(int64_t(tile_rows), row_end - tile0));
        unsigned char* sx = ring + s * sbytes;
        const auto* gx =
            reinterpret_cast<const unsigned char*>(index + tile0 * k);
        const auto* gs =
            reinterpret_cast<const unsigned char*>(scales + tile0);
        const int xb = rows * k * int(sizeof(T)), sb = scales ? rows * 4 : 0;
        // the tails first: the arrival below publishes them
        stage_copy(sx, gx, xb, &full[s], false);
        stage_copy(sx + xbytes, gs, sb, &full[s], false);
        bar_expect(&full[s], (xb & ~15) + (sb & ~15));
        stage_copy(sx, gx, xb, &full[s], true);
        stage_copy(sx + xbytes, gs, sb, &full[s], true);
      }
    }
    return;
  }

  // a consumer: 8 queries against its stream's rows of the split
  const int group = warp % groups, stream = warp / groups;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = (blockIdx.x * groups + group) * kWarpQueries;
  const bool idle = qw0 >= nq;
  uint64_t* list = lists + size_t(warp) * kWarpQueries * w;
  uint64_t* buf = bufs + size_t(warp) * kWarpQueries * kCap;
  for (int i = lane; i < kWarpQueries * w; i += 32) list[i] = zen::kEmptyKey;
  __syncwarp();
  // this lane's accumulator queries 2t and 2t + 1: norms, altitudes, and the
  // squared distance bound of the n-th best as of the last flush
  float qn[2], qa[2], bnd[2];
  int cnt[2];
  bool qok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = qw0 + 2 * t + j;
    qok[j] = q < nq;
    float s = 0.0f;
    for (int c = 0; qok[j] && c < k; ++c) {
      const float v = __ldg(queries + int64_t(q) * k + c);
      s = fmaf(v, v, s);
    }
    qn[j] = s;
    qa[j] = qok[j] ? __ldg(queries + int64_t(q) * k + k - 1) : 0.0f;
    // a query slot past Q passes nothing
    bnd[j] = qok[j] ? __int_as_float(0x7f800000) : -__int_as_float(0x7f800000);
    cnt[j] = 0;
  }
  // the query operand: query g of the warp (the MMA's column g), columns
  // 4t + 2h and + 1 of k-step h
  uint32_t bh[2][2], bl[2][2];
  query_chunk(queries + int64_t(qw0 + g) * k, qw0 + g < nq, k, 4 * t, bh, bl);
  // where the altitude column k - 1 sits: lane column and element
  const int alt_t = (k - 1) >> 2, alt_j = (k - 1) & 3;
  // flush a buffer that holds more than lim: 0 until its first flush (so
  // every list publishes a best key after one step), then kCap - 32
  const int limit = kCap - kStepRows;
  int lim[2] = {0, 0};
  const uint32_t mine = 0x11111111u << t, below = (1u << lane) - 1u;
  const int list_id = blockIdx.y * streams + stream;
  ZEN_PROBE_START();

  for (int tl = stream; tl < n_tiles; tl += streams) {
    const int s = tl % stages;
    bar_wait(&full[s], (tl / stages) & 1);
    ZEN_PROBE_MARK(0);
    const int64_t tile0 = row_begin + int64_t(tl) * tile_rows;
    const int rows = int(min(int64_t(tile_rows), row_end - tile0));
    const T* sx = reinterpret_cast<const T*>(ring + s * sbytes);
    const float* ss =
        reinterpret_cast<const float*>(ring + s * sbytes + xbytes);
    for (int r0 = 0; r0 < rows && !idle; r0 += kStepRows) {
      // rows r0 + 16m + 8r + g (m: m16 tile, r: its upper or lower half);
      // the dot's hi.hi products and its cross terms accumulate apart
      float big[2][4], small[2][4], nx[2][2], xa[2][2], sc[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) big[m][i] = small[m][i] = 0.0f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          nx[m][r] = 0.0f;
          sc[m][r] = scales ? ss[r0 + 16 * m + 8 * r + g] : 1.0f;
        }
      }
      float v[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          load4<T, kVec>(sx + size_t(r0 + 16 * m + 8 * r + g) * k, 4 * t, k,
                         v[m][r]);
          if (scales) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[m][r][j] *= sc[m][r];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            nx[m][r] = fmaf(v[m][r][j], v[m][r][j], nx[m][r]);
          const float pick = alt_j == 0   ? v[m][r][0]
                             : alt_j == 1 ? v[m][r][1]
                             : alt_j == 2 ? v[m][r][2]
                                          : v[m][r][3];
          xa[m][r] = t == alt_t ? pick : 0.0f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ah[4], al[4];
          split_tf32(v[m][0][2 * h], ah[0], al[0]);
          split_tf32(v[m][1][2 * h], ah[1], al[1]);
          split_tf32(v[m][0][2 * h + 1], ah[2], al[2]);
          split_tf32(v[m][1][2 * h + 1], ah[3], al[3]);
          mma_tf32(small[m], al, bh[h][0], bh[h][1]);
          mma_tf32(small[m], ah, bl[h][0], bl[h][1]);
          mma_tf32(big[m], ah, bh[h][0], bh[h][1]);
        }
      }
      // whole-row norms and altitudes from the four lanes of a row
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          nx[m][r] += __shfl_xor_sync(~0u, nx[m][r], 1);
          nx[m][r] += __shfl_xor_sync(~0u, nx[m][r], 2);
          xa[m][r] = __shfl_sync(~0u, xa[m][r], (lane & ~3) | alt_t);
        }
      }
      // the filter: accumulator (m, r, j) is row r0 + 16m + 8r + g against
      // query 2t + j; its squared estimate passes when within the bound (at
      // or above the n-th best's squared distance, so a row tied with it,
      // which a lower id may win, passes too)
      float z2[2][2][2];
      bool keep[2][2][2];
      bool any = false;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool row_ok = r0 + 16 * m + 8 * r + g < rows;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            z2[m][r][j] = zen::estimate_sq(
                qn[j], nx[m][r], big[m][2 * r + j] + small[m][2 * r + j],
                qa[j], xa[m][r], mode);
            keep[m][r][j] = row_ok && z2[m][r][j] <= bnd[j];
            any |= keep[m][r][j];
          }
        }
      }
      ZEN_PROBE_MARK(1);
      // append the survivors (squared-estimate keys): the 8 lanes of
      // column t share queries 2t and 2t + 1
      if (__any_sync(~0u, any)) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t b = __ballot_sync(~0u, keep[m][r][j]) & mine;
              if (keep[m][r][j])
                buf[(2 * t + j) * kCap + cnt[j] + __popc(b & below)] =
                    (uint64_t(__float_as_uint(fmaxf(z2[m][r][j], 0.0f)))
                     << 32) |
                    uint32_t(tile0 + r0 + 16 * m + 8 * r + g);
              cnt[j] += __popc(b);
            }
          }
        }
        __syncwarp();
      }
      ZEN_PROBE_MARK(2);
      // flush each buffer that might not hold the next step
      if (__any_sync(~0u, cnt[0] > lim[0] || cnt[1] > lim[1])) {
        for (int ql = 0; ql < kWarpQueries; ++ql) {
          const int c = __shfl_sync(~0u, (ql & 1) ? cnt[1] : cnt[0], ql >> 1);
          const int cl = __shfl_sync(~0u, (ql & 1) ? lim[1] : lim[0], ql >> 1);
          if (c <= cl) continue;
          ZEN_PROBE_FLUSH(c);
          const uint64_t nth = warp_flush(
              list + ql * w, buf + ql * kCap, c, w, n_out, true,
              bests ? bests + int64_t(qw0 + ql) * n_out : nullptr);
          publish_best(bests, qw0 + ql, n_out, list_id, list[ql * w]);
          if (t == (ql >> 1)) {
            const float b = zen::squared_bound(zen::key_distance(nth));
            if (ql & 1) {
              cnt[1] = 0, bnd[1] = b, lim[1] = limit;
            } else {
              cnt[0] = 0, bnd[0] = b, lim[0] = limit;
            }
          }
        }
      }
      ZEN_PROBE_MARK(3);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  if (!idle) {
    for (int ql = 0; ql < kWarpQueries; ++ql) {
      const int c = __shfl_sync(~0u, (ql & 1) ? cnt[1] : cnt[0], ql >> 1);
      if (c > 0) {
        ZEN_PROBE_FLUSH(c);
        warp_flush(list + ql * w, buf + ql * kCap, c, w, n_out, true, nullptr);
      }
    }
  }
  ZEN_PROBE_MARK(3);
  ZEN_PROBE_END();
  // the streams' lists merge pairwise into stream 0's, in a tree (the
  // consumers alone meet at named barrier 1)
  for (int half = streams >> 1; half > 0; half >>= 1) {
    asm volatile("bar.sync 1, %0;" ::"r"(warps * 32) : "memory");
    if (stream < half && !idle) {
      const uint64_t* other = lists + size_t(warp + half * groups) *
                                          kWarpQueries * w;
      for (int ql = 0; ql < kWarpQueries; ++ql)
        warp_flush(list + ql * w, other + ql * w, w, w, n_out, false, nullptr);
    }
  }
  if (stream != 0 || idle) return;
  for (int ql = 0; ql < kWarpQueries; ++ql) {
    const int q = qw0 + ql;
    if (q >= nq) break;
    uint64_t* dst = partial + (int64_t(q) * n_lists + blockIdx.y) * w;
    for (int i = lane; i < w; i += 32) dst[i] = list[ql * w + i];
  }
}

template <typename T, bool kVec>
cudaError_t launch(int nq, int n_split, size_t smem, cudaStream_t stream,
                   const float* queries, const void* index,
                   const float* scales, int64_t n_index, int k, int n_out,
                   int w, int cap, int tile_rows, int stages, int warps,
                   int streams, int64_t split_rows, int n_lists, int mode,
                   uint64_t* partial, uint64_t* bests) {
  if (w > kMaxW || cap != kCap || warps < 1 || warps > kMaxWarps ||
      streams < 1 || warps % streams != 0 ||
      (streams & (streams - 1)) != 0 || stages % streams != 0 ||
      stages < 2 || stages > kMaxStages ||
      tile_rows < kStepRows || tile_rows % kStepRows != 0 ||
      k < 1 || k > 16 || kVec != (k % 4 == 0) ||
      reinterpret_cast<uintptr_t>(index) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scales) % 16 != 0 ||
      split_rows % tile_rows != 0 ||
      smem < smem_bytes(k, sizeof(T), w, warps, tile_rows, stages))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(zen_topk_mma<T, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (err != cudaSuccess) return err;
  if (bests != nullptr) {
    err = cudaMemsetAsync(bests, 0xff, sizeof(uint64_t) * nq * n_out, stream);
    if (err != cudaSuccess) return err;
  }
  const int per_block = warps / streams * kWarpQueries;
  const dim3 grid((nq + per_block - 1) / per_block, n_split);
  zen_topk_mma<T, kVec><<<grid, (warps + 1) * 32, smem, stream>>>(
      queries, static_cast<const T*>(index), scales, nq, n_index, k, n_out, w,
      tile_rows, stages, streams, split_rows, n_lists, mode, partial, bests);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int nq, int n_split, size_t smem, cudaStream_t s,
                         const float* q, const void* index, const float* sc,
                         int64_t n_index, int k, int n_out, int w, int cap,
                         int tile_rows, int stages, int warps, int streams,
                         int64_t split_rows, int n_lists, int mode,
                         uint64_t* part, uint64_t* bests) {
#define ZEN_MMA(VEC)                                                        \
  launch<T, VEC>(nq, n_split, smem, s, q, index, sc, n_index, k, n_out, w, \
                 cap, tile_rows, stages, warps, streams, split_rows, n_lists, \
                 mode, part, bests)
  return k % 4 == 0 ? ZEN_MMA(true) : ZEN_MMA(false);
#undef ZEN_MMA
}

}  // namespace mma

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. scales may be null. The plan comes
// from kernels/zen_topk.py::launch_geometry: kernel 1 is the MMA plan (w,
// cap, smem, n_split, split_rows, n_lists, tile_rows, stages, warps,
// streams; index and scales 16-byte aligned), kernel 0 the SIMT plan (w,
// kq, cap, global_lists, smem, n_split, split_rows, n_lists); merge_smem
// is pass 2's. partial holds nq * n_lists * w keys. gscratch: under the
// SIMT plan with global lists nq * n_split * cap keys; under the MMA plan
// the shared bound's nq * n_out buckets (filled with ones here), or null
// for none. Returns the CUDA error code of the launches (0 on success).
int zen_topk_launch(const void* queries, const void* index, const void* scales,
                    int dtype, int nq, long long n_index, int k, int n_out,
                    int mode, int kernel, int w, int kq, int cap,
                    int global_lists, int smem, int n_split,
                    long long split_rows, int n_lists, int merge_smem,
                    int tile_rows, int stages, int warps, int streams,
                    void* partial, void* gscratch, void* out_d, void* out_i,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* sc = static_cast<const float*>(scales);
  uint64_t* part = static_cast<uint64_t*>(partial);
  uint64_t* gs = static_cast<uint64_t*>(gscratch);
  const bool g = global_lists != 0;
  cudaError_t err;
  if (kernel == 1) {
    switch (dtype) {
      case 0:
        err = mma::launch_dtype<float>(nq, n_split, smem, s, q, index, sc,
                                       n_index, k, n_out, w, cap, tile_rows,
                                       stages, warps, streams, split_rows,
                                       n_lists, mode, part, gs);
        break;
      case 1:
        err = mma::launch_dtype<__nv_bfloat16>(
            nq, n_split, smem, s, q, index, sc, n_index, k, n_out, w, cap,
            tile_rows, stages, warps, streams, split_rows, n_lists, mode,
            part, gs);
        break;
      case 2:
        err = mma::launch_dtype<int8_t>(nq, n_split, smem, s, q, index, sc,
                                        n_index, k, n_out, w, cap, tile_rows,
                                        stages, warps, streams, split_rows,
                                        n_lists, mode, part, gs);
        break;
      default:
        return int(cudaErrorInvalidValue);
    }
  } else if (kernel == 0) {
    switch (dtype) {
      case 0:
        err = launch_dtype<float>(kq, g, nq, n_split, smem, s, q, index, sc,
                                  n_index, k, n_out, w, cap, split_rows,
                                  n_lists, mode, part, gs);
        break;
      case 1:
        err = launch_dtype<__nv_bfloat16>(kq, g, nq, n_split, smem, s, q,
                                          index, sc, n_index, k, n_out, w, cap,
                                          split_rows, n_lists, mode, part, gs);
        break;
      case 2:
        err = launch_dtype<int8_t>(kq, g, nq, n_split, smem, s, q, index, sc,
                                   n_index, k, n_out, w, cap, split_rows,
                                   n_lists, mode, part, gs);
        break;
      default:
        return int(cudaErrorInvalidValue);
    }
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  if (merge_smem > 0) {
    if (size_t(merge_smem) < sizeof(uint64_t) * size_t(n_lists) * w)
      return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(zen_topk_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               merge_smem);
    if (err != cudaSuccess) return int(err);
  }
  zen_topk_merge<<<nq, kMergeThreads, merge_smem, s>>>(
      part, n_split, n_lists, w, n_out, merge_smem > 0,
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return int(cudaGetLastError());
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
