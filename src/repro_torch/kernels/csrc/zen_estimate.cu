// Dense Zen/Lwb/Upb estimator matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/zen.py::zen_estimate (body
// _zen_kernel): projected points X (N, k) and Y (M, k), f32 or bf16 (cast to
// f32 on load), last column the altitude -> (N, M) f32 distances
//   Zen^2 = |x|^2 + |y|^2 - 2 <x[:k-1], y[:k-1]>,  Lwb^2 / Upb^2 = Zen^2 -/+
//   2 x_alt y_alt,  d = sqrt(max(., 0)).
// The dot leaves the altitude column out on one side only, which is enough
// to drop it; at k = 1 the dot is empty and Zen is sqrt(x_alt^2 + y_alt^2).
//
// What bounds it on an H100: the (N, M) f32 output. At (4,096 x 16)^2 it is
// 67 MB written (20 us at 3.35 TB/s) against 2.1 GFLOP; at 64 x 1e6 x 16,
// 0.32 GB read and written (96 us).
//
// Design. A block stages kCols = 256 columns at a time of its 64 rows of X
// and 64 rows of Y in shared memory (transposed, each staged row padded by
// 4 words so that it stays 16-byte aligned; 2 x 256 x 68 words, 139 KB, as
// dynamic shared memory, less when k is smaller), and each of 256 threads
// scores a 4 x 4 micro-tile of 4 consecutive rows and 4 consecutive
// columns in registers, reading each column of both as one float4, and
// writes its rows as float4 where M allows. k <= 256 is one chunk; a wider
// k streams its chunks through the same registers: the dot and the full
// squared norms go on as one FMA chain over the columns in order, so every
// k rounds as one chunk would, and the altitude is taken from the chunk
// that holds column k-1. The tile of an (i, j) output reads one contiguous
// span of each operand's rows (16-byte vector loads where k and alignment
// allow), so ragged N, M and k need no padded copy. Grid y holds at most
// 65,535 column tiles, so a wider M is covered by several launches, each
// from its own first column tile. The estimator and the distance are
// scoring.cuh's
// estimate_sq and distance, the functions zen_topk and the probes score
// with, so the dense matrix and the top-k kernels cannot drift apart.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_tile.cuh"  // dense::load4
#include "scoring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // rows of X and of Y per block
constexpr int kMicro = 4;              // a thread's outputs per row, column
constexpr int kSide = kTile / kMicro;  // 16 x 16 threads
constexpr int kStride = kTile + 4;     // a staged row, 16-byte aligned
constexpr int kCols = 256;             // columns staged at a time

size_t smem_bytes(int k) {
  const size_t kc = k < kCols ? k : kCols;
  return sizeof(float) * (2 * kc * kStride + 4 * kTile);
}

// Stages rows [r0, r0 + kTile) of the (n, k) matrix src, all k columns,
// into dst[c * kStride + r], zero outside the matrix. The rows are one
// contiguous span of src, read in order; VEC: k % 4 == 0 and src aligned to
// 4 elements, so 4 consecutive elements (of one row) are one vector load.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t r0, int64_t n, int k) {
  const int64_t base = r0 * k;
  const int64_t end = n * k;
  if constexpr (VEC) {
    for (int e = 4 * threadIdx.x; e < kTile * k; e += 4 * kThreads) {
      const int r = e / k, c = e - r * k;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (base + e < end) dense::load4(src + base + e, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[(c + q) * kStride + r] = v[q];
    }
  } else {
    for (int e = threadIdx.x; e < kTile * k; e += kThreads) {
      const int r = e / k, c = e - r * k;
      dst[c * kStride + r] =
          base + e < end ? zen::to_float(src[base + e]) : 0.0f;
    }
  }
}

// The same for columns [c0, c0 + kCols) of a wider matrix (kc of them at
// the right edge): each row's span is read in order.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_cols(float* dst,
                                           const T* __restrict__ src,
                                           int64_t r0, int64_t n, int k,
                                           int c0, int kc) {
  if constexpr (VEC) {
    for (int e = 4 * threadIdx.x; e < kTile * kc; e += 4 * kThreads) {
      const int r = e / kc, c = e - r * kc;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r0 + r < n) dense::load4(src + (r0 + r) * k + c0 + c, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[(c + q) * kStride + r] = v[q];
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kc; e += kThreads) {
      const int r = e / kc, c = e - r * kc;
      dst[c * kStride + r] =
          r0 + r < n ? zen::to_float(src[(r0 + r) * k + c0 + c]) : 0.0f;
    }
  }
}

// Adds the staged columns [0, kdot) of the thread's 4 rows and 4 columns
// to its dot partials, one FMA chain per output.
__device__ __forceinline__ void add_dots(float (&dot)[kMicro][kMicro],
                                         const float* xs, const float* ys,
                                         int kdot, int tx, int ty) {
#pragma unroll 4
  for (int c = 0; c < kdot; ++c) {
    const float4 av =
        *reinterpret_cast<const float4*>(&xs[c * kStride + ty * 4]);
    const float4 bv =
        *reinterpret_cast<const float4*>(&ys[c * kStride + tx * 4]);
    const float a[kMicro] = {av.x, av.y, av.z, av.w};
    const float b[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) dot[i][j] = fmaf(a[i], b[j], dot[i][j]);
  }
}

// One block per (row tile, column tile): row tile blockIdx.x, column tile
// col0 / kTile + blockIdx.y. WIDE (k > kCols):
// the columns are streamed kCols at a time through the same partials, the
// dot and the norms going on as one FMA chain; otherwise the whole width is
// staged at once.
template <typename T, bool VEC, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    zen_estimate_tile(const T* __restrict__ x, const T* __restrict__ y,
                      int64_t n, int64_t m, int k, int mode,
                      int64_t col0, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int kcs = WIDE ? kCols : k;    // columns staged at a time
  float* xs = smem;                    // [kcs][kStride]
  float* ys = xs + kcs * kStride;      // [kcs][kStride]
  float* xn = ys + kcs * kStride;      // [kTile] full squared norms
  float* yn = xn + kTile;
  float* xa = yn + kTile;              // [kTile] altitudes
  float* ya = xa + kTile;

  const int64_t r0 = int64_t(blockIdx.x) * kTile;
  const int64_t c0 = col0 + int64_t(blockIdx.y) * kTile;
  const int t = threadIdx.x;
  const int tx = t % kSide, ty = t / kSide;
  float dot[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) dot[i][j] = 0.0f;
  if constexpr (!WIDE) {
    stage<T, VEC>(xs, x, r0, n, k);
    stage<T, VEC>(ys, y, c0, m, k);
    __syncthreads();
    if (t < 2 * kTile) {
      const float* s = t < kTile ? xs : ys;
      const int r = t % kTile;
      float sq = 0.0f;
      for (int c = 0; c < k; ++c)
        sq = fmaf(s[c * kStride + r], s[c * kStride + r], sq);
      (t < kTile ? xn : yn)[r] = sq;
      (t < kTile ? xa : ya)[r] = s[(k - 1) * kStride + r];
    }
    __syncthreads();
    add_dots(dot, xs, ys, k - 1, tx, ty);  // the altitude column left out
  } else {
    float sq = 0.0f;  // thread t < 2 kTile: the norm of one staged row
    for (int k0 = 0; k0 < k; k0 += kCols) {
      const int kc = min(kCols, k - k0);
      stage_cols<T, VEC>(xs, x, r0, n, k, k0, kc);
      stage_cols<T, VEC>(ys, y, c0, m, k, k0, kc);
      __syncthreads();
      if (t < 2 * kTile) {
        const float* s = t < kTile ? xs : ys;
        const int r = t % kTile;
        for (int c = 0; c < kc; ++c)
          sq = fmaf(s[c * kStride + r], s[c * kStride + r], sq);
        if (k0 + kc == k) {
          (t < kTile ? xn : yn)[r] = sq;
          (t < kTile ? xa : ya)[r] = s[(kc - 1) * kStride + r];
        }
      }
      __syncthreads();
      add_dots(dot, xs, ys, min(kc, k - 1 - k0), tx, ty);
      __syncthreads();  // before the next chunk's stage
    }
  }
  const int c = tx * 4;
  const bool whole = (m & 3) == 0 && c0 + c + 3 < m;  // one float4 store
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty * 4 + i;
    if (r0 + r >= n) continue;
    float o[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j)
      o[j] = zen::distance(zen::estimate_sq(xn[r], yn[c + j], dot[i][j],
                                            xa[r], ya[c + j], mode));
    float* row = out + (r0 + r) * m + c0 + c;
    if (whole) {
      *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        if (c0 + c + j < m) row[j] = o[j];
    }
  }
}

template <typename T, bool VEC, bool WIDE>
cudaError_t launch_tiles(const T* x, const T* y, long long n, long long m,
                         int k, int mode, float* out, cudaStream_t s) {
  constexpr long long kMaxGridY = 65535;
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      zen_estimate_tile<T, VEC, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long long col_tiles = (m + kTile - 1) / kTile;
  for (long long t0 = 0; t0 < col_tiles; t0 += kMaxGridY) {
    const long long nt = col_tiles - t0 < kMaxGridY ? col_tiles - t0
                                                    : kMaxGridY;
    const dim3 grid(unsigned((n + kTile - 1) / kTile), unsigned(nt));
    zen_estimate_tile<T, VEC, WIDE><<<grid, kThreads, smem, s>>>(
        x, y, n, m, k, mode, t0 * kTile, out);
  }
  return cudaGetLastError();
}

// The whole width at once when it fits one chunk.
template <typename T, bool VEC>
cudaError_t launch_width(const T* x, const T* y, long long n, long long m,
                         int k, int mode, float* out, cudaStream_t s) {
  if (k > kCols)
    return launch_tiles<T, VEC, true>(x, y, n, m, k, mode, out, s);
  return launch_tiles<T, VEC, false>(x, y, n, m, k, mode, out, s);
}

// Vector loads when k and both operands allow.
template <typename T>
cudaError_t launch(const void* x, const void* y, long long n, long long m,
                   int k, int mode, float* out, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const uintptr_t quad = 4 * sizeof(T);
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % quad == 0 &&
      reinterpret_cast<uintptr_t>(y) % quad == 0)
    return launch_width<T, true>(xp, yp, n, m, k, mode, out, s);
  return launch_width<T, false>(xp, yp, n, m, k, mode, out, s);
}

}  // namespace

extern "C" {

// x (n, k) and y (m, k) contiguous, dtype 0 float32 or 1 bfloat16, mode 0
// zen, 1 lwb, 2 upb; out (n, m) float32. Returns the CUDA error code.
int zen_estimate_launch(const void* x, const void* y, int dtype, long long n,
                        long long m, int k, int mode, void* out,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return int(launch<float>(x, y, n, m, k, mode, o, s));
    case 1:
      return int(launch<__nv_bfloat16>(x, y, n, m, k, mode, o, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
