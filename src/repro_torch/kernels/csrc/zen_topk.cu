// Streaming fused Zen/Lwb/Upb top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/zen_topk.py::zen_topk (body
// _topk_kernel): for queries (Q, k) f32 and an index (N, k) stored f32, bf16
// or int8 (+ (N,) f32 row scales), return each query's n nearest rows under
// the estimator, ascending by (distance, row id), without ever holding the
// (Q, N) distance matrix.
//
// What bounds it on an H100: 2*Q*N*k f32 operations against reading the
// index once. At the serving shape (Q = 64, N = 1e6, k = 16) that is 2.0
// GFLOP (31 us at 67 TFLOP/s outside the tensor cores) against 64 MB of f32
// rows (19 us at 3.35 TB/s): compute-bound, and more so for bf16 and int8.
//
// Design. The TPU kernel walks N in order inside one grid row and carries
// the running best in VMEM scratch. Hopper blocks run in no order, and a
// serving batch has at most 64 queries (8 blocks of 8), so N itself is
// split to fill the card:
//   pass 1  grid (Q/KQ, S): a block scores its KQ queries against one
//           contiguous split of N rows, 512-row tile by tile. The tile is
//           staged in shared memory 16 columns at a time through a register
//           double buffer (the next chunk's loads are in flight while this
//           one is scored), dequantised to f32 right after, and every thread
//           scores 2 rows against the KQ queries in registers. A candidate
//           that beats the query's n-th best (as of the last flush) is
//           appended to a buffer of `cap` keys; when the next tile might not
//           fit, and at the end, the buffer is bitonic-sorted and merged
//           into the running best of w keys (the counterpart of concat +
//           top_k). Once the running best has filled, few rows beat it, so
//           flushes are rare; a squared-distance bound skips the sqrt for
//           the rows that cannot.
//   pass 2  one block per query merges the S partial lists pairwise, in a
//           tree (padded to a power of two), and writes the first n.
// Every width n the reference serves is served. The wrapper's planner
// (kernels/zen_topk.py::launch_geometry) sizes each launch: w, cap >= w
// (merge_sorted_segments reads w keys of the buffer), KQ in {8, 4, 2, 1}
// (the most queries whose lists and staged queries fit 227 KB of shared
// memory), S, and pass 2's shared bytes. Past what one query's lists can
// keep in shared memory (w >= 16,384 at k = 16), the lists, the buffers and
// the query live in global memory (the wrapper's scratch; the lists are
// the partial output itself), and pass 2 merges in place there; the same
// sort and merge run over them, slower, through L1 and L2. The kernel
// takes the plan's numbers and never derives them from constants of its
// own.
// Scoring and merging live in scoring.cuh, shared with the clustered probe.
// Nothing here uses the tensor cores: TF32 would break the f32 parity that
// _DEAD_COORD rows (squared norms ~1e30 * k) need. wgmma/TMA is later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scoring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;            // index rows per thread per tile
constexpr int kTile = kThreads * kRowsPerThread;  // 512 rows per tile
constexpr int kCols = 16;                    // columns staged per pass
constexpr int kXStride = kCols + 1;          // odd stride: no bank conflicts
constexpr int kRowsPerStep = kThreads / kCols;
constexpr int kLoads = kTile / kRowsPerStep;  // staged values per thread

// Dynamic shared memory a pass-1 block needs: the layout of
// zen_topk_partial, mirrored by kernels/zen_topk.py::pass1_smem. The
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

// One block per query: tree-merge the S sorted partial lists (padded with
// empty lists to n_lists, a power of two) and write the first n as
// (distance, id). In shared memory when the plan gives it (merge_smem),
// else in place in the query's n_lists x w slots of partial.
__global__ void __launch_bounds__(kThreads)
    zen_topk_merge(uint64_t* partial, int n_split, int n_lists, int w,
                   int n_out, bool in_smem, float* __restrict__ out_d,
                   int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  uint64_t* src = partial + int64_t(q) * n_lists * w;
  uint64_t* lists = src;  // [n_lists][w]
  if (in_smem) {
    lists = reinterpret_cast<uint64_t*>(smem);
    for (int t = threadIdx.x; t < n_lists * w; t += blockDim.x)
      lists[t] = t < n_split * w ? src[t] : zen::kEmptyKey;
  } else {
    for (int64_t t = int64_t(n_split) * w + threadIdx.x;
         t < int64_t(n_lists) * w; t += blockDim.x)
      lists[t] = zen::kEmptyKey;
  }
  __syncthreads();
  for (int stride = 1; stride < n_lists; stride <<= 1) {
    zen::merge_sorted_segments(lists, 2 * stride * w, lists + stride * w,
                               2 * stride * w, n_lists / (2 * stride), w);
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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. scales may be null. The plan
// (w, kq, cap, global_lists, smem, n_split, split_rows, n_lists,
// merge_smem) comes from kernels/zen_topk.py::launch_geometry: partial
// holds nq * n_lists * w keys, gscratch (global_lists only) nq * n_split *
// cap. Returns the CUDA error code of the launches (0 on success).
int zen_topk_launch(const void* queries, const void* index, const void* scales,
                    int dtype, int nq, long long n_index, int k, int n_out,
                    int mode, int w, int kq, int cap, int global_lists,
                    int smem, int n_split, long long split_rows, int n_lists,
                    int merge_smem, void* partial, void* gscratch, void* out_d,
                    void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* sc = static_cast<const float*>(scales);
  uint64_t* part = static_cast<uint64_t*>(partial);
  uint64_t* gs = static_cast<uint64_t*>(gscratch);
  const bool g = global_lists != 0;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_dtype<float>(kq, g, nq, n_split, smem, s, q, index, sc,
                                n_index, k, n_out, w, cap, split_rows,
                                n_lists, mode, part, gs);
      break;
    case 1:
      err = launch_dtype<__nv_bfloat16>(kq, g, nq, n_split, smem, s, q, index,
                                        sc, n_index, k, n_out, w, cap,
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
  if (err != cudaSuccess) return int(err);
  if (merge_smem > 0) {
    if (size_t(merge_smem) < sizeof(uint64_t) * size_t(n_lists) * w)
      return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(zen_topk_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               merge_smem);
    if (err != cudaSuccess) return int(err);
  }
  zen_topk_merge<<<nq, kThreads, merge_smem, s>>>(
      part, n_split, n_lists, w, n_out, merge_smem > 0,
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return int(cudaGetLastError());
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
