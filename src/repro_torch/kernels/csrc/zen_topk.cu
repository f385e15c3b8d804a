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
//   pass 1  grid (Q/8, S): a block scores its 8 queries against one
//           contiguous split of N rows, 512-row tile by tile. The tile is
//           staged in shared memory 16 columns at a time through a register
//           double buffer (the next chunk's loads are in flight while this
//           one is scored), dequantised to f32 right after, and every thread
//           scores 2 rows against the 8 queries in registers. A candidate
//           that beats the query's n-th best (as of the last flush) is
//           appended to a shared buffer of two tiles; when the next tile
//           might not fit, and at the end, the buffer is bitonic-sorted and
//           merged into the running best (the counterpart of concat +
//           top_k). Once the running best has filled, few rows beat it, so
//           flushes are rare; a squared-distance bound skips the sqrt for
//           the rows that cannot.
//   pass 2  one block per query merges the S partial lists pairwise, in a
//           tree (padded to a power of two), and writes the first n.
// Scoring and merging live in scoring.cuh, shared with the clustered probe.
// Nothing here uses the tensor cores: TF32 would break the f32 parity that
// _DEAD_COORD rows (squared norms ~1e30 * k) need. wgmma/TMA is later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scoring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 8;                  // queries per block
constexpr int kRowsPerThread = 2;            // index rows per thread per tile
constexpr int kTile = kThreads * kRowsPerThread;  // 512 rows per tile
constexpr int kCap = 2 * kTile;              // candidate buffer per query
constexpr int kCols = 16;                    // columns staged per pass
constexpr int kXStride = kCols + 1;          // odd stride: no bank conflicts
constexpr int kRowsPerStep = kThreads / kCols;
constexpr int kLoads = kTile / kRowsPerStep;  // staged values per thread

size_t partial_smem_bytes(int k, int w) {
  return sizeof(uint64_t) * kQueries * (w + kCap) +
         sizeof(float) * (kQueries * k + kTile * kXStride + 3 * kQueries) +
         sizeof(int) * kQueries;
}

// Bitonic-sorts each query's buffered candidates and merges them into its
// running best, then empties the buffers and refreshes the thresholds.
// Block-wide; `most` is the largest count (block-uniform).
__device__ __forceinline__ void flush(uint64_t* best, uint64_t* buf,
                                      int* cnt, float* bound, int w,
                                      int n_out, int most) {
  int p = 1;
  while (p < most) p <<= 1;
  const int fill = max(p, w), shift = zen::log2_pow2(fill);
  for (int t = threadIdx.x; t < kQueries * fill; t += kThreads) {
    const int q = t >> shift, i = t & (fill - 1);
    if (i >= cnt[q]) buf[q * kCap + i] = zen::kEmptyKey;
  }
  __syncthreads();
  zen::bitonic_sort_segments(buf, kQueries, p, kCap);
  zen::merge_sorted_segments(best, w, buf, kCap, kQueries, w);
  if (threadIdx.x < kQueries) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    zen_topk_partial(const float* __restrict__ queries,
                     const T* __restrict__ index,
                     const float* __restrict__ scales, int nq,
                     int64_t n_index, int k, int n_out, int w,
                     int64_t split_rows, int mode,
                     uint64_t* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* best = reinterpret_cast<uint64_t*>(smem);  // [kQueries][w]
  uint64_t* buf = best + kQueries * w;                  // [kQueries][kCap]
  float* qs = reinterpret_cast<float*>(buf + kQueries * kCap);  // [k][8]
  float* xs = qs + kQueries * k;                        // [kTile][kXStride]
  float* qn = xs + kTile * kXStride;
  float* qa = qn + kQueries;
  float* bound = qa + kQueries;  // squared_bound of each query's n-th best
  int* cnt = reinterpret_cast<int*>(bound + kQueries);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueries;
  const int split = blockIdx.y;
  const int64_t row_begin = int64_t(split) * split_rows;
  const int64_t row_end = min(n_index, row_begin + split_rows);

  for (int t = tid; t < kQueries * w; t += kThreads) best[t] = zen::kEmptyKey;
  for (int t = tid; t < kQueries * k; t += kThreads) {
    const int q = t / k, c = t - q * k;
    qs[c * kQueries + q] =
        (q0 + q < nq) ? queries[int64_t(q0 + q) * k + c] : 0.0f;
  }
  if (tid < kQueries) cnt[tid] = 0;
  __syncthreads();
  if (tid < kQueries) {
    float s = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float v = qs[c * kQueries + tid];
      s = fmaf(v, v, s);
    }
    qn[tid] = s;
    qa[tid] = qs[(k - 1) * kQueries + tid];
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
    float dot[kRowsPerThread][kQueries];
    float nx[kRowsPerThread], xa[kRowsPerThread], sc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      nx[r] = 0.0f;
      xa[r] = 0.0f;
      sc[r] = pre_s[r];
#pragma unroll
      for (int q = 0; q < kQueries; ++q) dot[r][q] = 0.0f;
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
        const float* qc = qs + (c0 + c) * kQueries;
        const float4 qa4 = *reinterpret_cast<const float4*>(qc);
        const float4 qb4 = *reinterpret_cast<const float4*>(qc + 4);
        const float qv[kQueries] = {qa4.x, qa4.y, qa4.z, qa4.w,
                                    qb4.x, qb4.y, qb4.z, qb4.w};
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float v = xs[(tid + r * kThreads) * kXStride + c] * sc[r];
          nx[r] = fmaf(v, v, nx[r]);
#pragma unroll
          for (int q = 0; q < kQueries; ++q)
            dot[r][q] = fmaf(qv[q], v, dot[r][q]);
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
      for (int q = 0; q < kQueries; ++q) {
        if (q0 + q >= nq) continue;
        const float z2 = zen::estimate_sq(qn[q], nx[r], dot[r][q], qa[q],
                                          xa[r], mode);
        if (z2 > bound[q]) continue;
        const uint64_t key =
            zen::make_key(zen::distance(z2), id >= 0, uint32_t(id));
        if (key < best[q * w + n_out - 1]) {
          buf[q * kCap + atomicAdd(&cnt[q], 1)] = key;
        }
      }
    }
    __syncthreads();
    int most = 0;
#pragma unroll
    for (int q = 0; q < kQueries; ++q) most = max(most, cnt[q]);
    // block-uniform: every thread read the same counts. Flush only when
    // the next tile might not fit.
    if (most > kCap - kTile) flush(best, buf, cnt, bound, w, n_out, most);
  }
  int most = 0;
#pragma unroll
  for (int q = 0; q < kQueries; ++q) most = max(most, cnt[q]);
  if (most > 0) flush(best, buf, cnt, bound, w, n_out, most);

  for (int t = tid; t < kQueries * w; t += kThreads) {
    const int q = t / w, i = t - q * w;
    if (q0 + q < nq)
      partial[(int64_t(q0 + q) * gridDim.y + split) * w + i] = best[t];
  }
}

// One block per query: tree-merge the S sorted partial lists (padded with
// empty lists to a power of two) and write the first n as (distance, id).
__global__ void __launch_bounds__(kThreads)
    zen_topk_merge(const uint64_t* __restrict__ partial, int n_split,
                   int n_lists, int w, int n_out, float* __restrict__ out_d,
                   int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem);  // [n_lists][w]
  const int q = blockIdx.x;
  const uint64_t* src = partial + int64_t(q) * n_split * w;
  for (int t = threadIdx.x; t < n_lists * w; t += blockDim.x)
    lists[t] = t < n_split * w ? src[t] : zen::kEmptyKey;
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

template <typename T>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t stream,
                           const float* queries, const void* index,
                           const float* scales, int nq, int64_t n_index, int k,
                           int n_out, int w, int64_t split_rows, int mode,
                           uint64_t* partial) {
  cudaError_t err = cudaFuncSetAttribute(
      zen_topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  zen_topk_partial<T><<<grid, kThreads, smem, stream>>>(
      queries, static_cast<const T*>(index), scales, nq, n_index, k, n_out, w,
      split_rows, mode, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. scales may be null. w is a power of
// two >= n_out, and w times n_split rounded up to a power of two must fit
// pass 2's shared memory; partial holds nq * n_split * w keys.
// Returns the CUDA error code of the launches (0 on success).
int zen_topk_launch(const void* queries, const void* index, const void* scales,
                    int dtype, int nq, long long n_index, int k, int n_out,
                    int w, int n_split, long long split_rows, int mode,
                    void* partial, void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kQueries - 1) / kQueries, n_split);
  const size_t smem = partial_smem_bytes(k, w);
  const float* q = static_cast<const float*>(queries);
  const float* sc = static_cast<const float*>(scales);
  uint64_t* part = static_cast<uint64_t*>(partial);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_partial<float>(grid, smem, s, q, index, sc, nq, n_index, k,
                                  n_out, w, split_rows, mode, part);
      break;
    case 1:
      err = launch_partial<__nv_bfloat16>(grid, smem, s, q, index, sc, nq,
                                          n_index, k, n_out, w, split_rows,
                                          mode, part);
      break;
    case 2:
      err = launch_partial<int8_t>(grid, smem, s, q, index, sc, nq, n_index,
                                   k, n_out, w, split_rows, mode, part);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  int n_lists = 1;
  while (n_lists < n_split) n_lists <<= 1;
  const size_t smem2 = sizeof(uint64_t) * size_t(n_lists) * w;
  err = cudaFuncSetAttribute(zen_topk_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem2));
  if (err != cudaSuccess) return int(err);
  zen_topk_merge<<<nq, kThreads, smem2, s>>>(
      part, n_split, n_lists, w, n_out, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i));
  return int(cudaGetLastError());
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
