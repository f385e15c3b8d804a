// Dense (N, m) x (K, m) -> (N, K) pairwise tile loop for Hopper, shared by
// the squared-Euclidean (pdist.cu) and the Jensen-Shannon (jsd.cu) distance
// matrices: the counterpart of the blocked grid the two TPU kernels share
// (repro/kernels/pdist.py and jsd.py: a (bn, bk) output tile per grid step,
// the feature axis streamed in chunks into an f32 accumulator).
//
// Each output is finish(row[i], col[j], sum_l pair(x[i][l], y[j][l])) with
// row[i] = sum_l self(x[i][l]) and col[j] = sum_l self(y[j][l]); an Op
// supplies pair, self and finish. Zero padding must be exact for the Op:
// pair(0, 0) = self(0) = 0.
//
// Design. The TPU grid carries the sum across its sequential m axis in VMEM
// scratch; Hopper blocks run in no order, so that axis becomes a loop inside
// the block. A block owns a BN x BK output tile; each of its 256 threads a
// 4 x 4 register micro-tile of 4 consecutive rows and 4 consecutive columns.
// Per step the block stages kChunk feature columns of its BN rows of x and
// BK rows of y in shared memory, transposed (dst[l][r]), converted to f32 on
// load and zero outside the matrix, so ragged N, K and m need no padded
// copy. Rows are read with 16-byte vector loads where m and the operands'
// alignment allow (VEC), else one element at a time. A staged row is padded
// by 4 words, which keeps it 16-byte aligned, so a thread reads its 4 rows
// and its 4 columns of one l as two float4 loads: 2 shared loads for 16
// pair updates. Threads below BN (and below BK) also sum self over their
// row of the staged chunk: the row terms come from the same staged tiles,
// in the same pass. Each chunk's sums go into a fresh register partial that
// is then added to the total, as the TPU kernel adds each chunk's block sum
// to its accumulator: the rounding error grows with the chunk count, not
// with m. BN = 256, BK = 16 serves a narrow K (the transform's 16
// references) without computing padded columns; BN = BK = 64 serves square
// tiles. Outputs go out as float4 where K allows. Nothing here uses the
// tensor cores. Grid y holds at most 65,535 column tiles, so a wider K is
// covered by several launches, each from its own first column tile.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scoring.cuh"

namespace dense {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // feature columns staged per step
constexpr int kMicro = 4;   // rows and columns of a thread's micro-tile
constexpr int kPad = 4;     // words after each staged row (16-byte aligned)

// Four consecutive elements at p (16 bytes of f32, 8 of bf16, aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// Stages columns [l0, l0 + kChunk) of rows [r0, r0 + R) of the (n, m) matrix
// src into dst[l][r], zero outside the matrix. VEC: m % 4 == 0 and src
// aligned to 4 elements, so 4 consecutive columns are one vector load.
template <typename T, int R, bool VEC>
__device__ __forceinline__ void stage(float (*dst)[R + kPad],
                                      const T* __restrict__ src, int64_t r0,
                                      int64_t n, int m, int l0) {
  if constexpr (VEC) {
    constexpr int kQuads = kChunk / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kQuads; e += kThreads) {
      const int r = e / kQuads, l = (e % kQuads) * 4;
      const int64_t gr = r0 + r;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gr < n && l0 + l < m) load4(src + gr * m + l0 + l, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[l + q][r] = v[q];
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kChunk; e += kThreads) {
      const int r = e / kChunk, l = e % kChunk;
      const int64_t gr = r0 + r;
      const int gl = l0 + l;
      dst[l][r] = (gr < n && gl < m) ? zen::to_float(src[gr * m + gl])
                                         : 0.0f;
    }
  }
}

template <class Op, typename T, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(kThreads)
    dense_tile(const T* __restrict__ x, const T* __restrict__ y, int64_t n,
               int64_t k, int m, int64_t col0, float* __restrict__ out) {
  constexpr int TX = BK / kMicro;  // threads along a tile row
  constexpr int TY = BN / kMicro;  // threads along a tile column
  static_assert(TX * TY == kThreads, "one 4 x 4 micro-tile per thread");
  static_assert(BN <= kThreads && BK <= kThreads, "one row term per thread");
  __shared__ __align__(16) float xs[kChunk][BN + kPad];
  __shared__ __align__(16) float ys[kChunk][BK + kPad];
  __shared__ float xterm[BN];
  __shared__ float yterm[BK];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int64_t r0 = int64_t(blockIdx.x) * BN;
  const int64_t c0 = col0 + int64_t(blockIdx.y) * BK;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  float xsum = 0.0f, ysum = 0.0f;  // row terms of row threadIdx.x

  for (int l0 = 0; l0 < m; l0 += kChunk) {
    stage<T, BN, VEC>(xs, x, r0, n, m, l0);
    stage<T, BK, VEC>(ys, y, c0, k, m, l0);
    __syncthreads();
    if (threadIdx.x < BN) {
      float s = 0.0f;
#pragma unroll 8
      for (int l = 0; l < kChunk; ++l) s = Op::self(xs[l][threadIdx.x], s);
      xsum = __fadd_rn(xsum, s);
    }
    if (threadIdx.x < BK) {
      float s = 0.0f;
#pragma unroll 8
      for (int l = 0; l < kChunk; ++l) s = Op::self(ys[l][threadIdx.x], s);
      ysum = __fadd_rn(ysum, s);
    }
    float part[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int l = 0; l < kChunk; ++l) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[l][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ys[l][tx * 4]);
      const float a[kMicro] = {av.x, av.y, av.z, av.w};
      const float b[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          part[i][j] = Op::pair(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    __syncthreads();
  }
  if (threadIdx.x < BN) xterm[threadIdx.x] = xsum;
  if (threadIdx.x < BK) yterm[threadIdx.x] = ysum;
  __syncthreads();
  const int c = tx * 4;
  const bool whole = (k & 3) == 0 && c0 + c + 3 < k;  // one float4 store
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty * 4 + i;
    if (r0 + r >= n) continue;
    float o[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j)
      o[j] = Op::finish(xterm[r], yterm[c + j], acc[i][j]);
    float* row = out + (r0 + r) * k + c0 + c;
    if (whole) {
      *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        if (c0 + c + j < k) row[j] = o[j];
    }
  }
}

// Grid x takes the row tiles, grid y at most kMaxGridY column tiles a
// launch; the launches go on from column tile t0 until K is covered.
constexpr long long kMaxGridY = 65535;

template <class Op, typename T, int BN, int BK, bool VEC>
void launch_grid(const T* x, const T* y, long long n, long long k, int m,
                 float* out, cudaStream_t s) {
  const long long col_tiles = (k + BK - 1) / BK;
  for (long long t0 = 0; t0 < col_tiles; t0 += kMaxGridY) {
    const long long nt = col_tiles - t0 < kMaxGridY ? col_tiles - t0
                                                    : kMaxGridY;
    const dim3 grid(unsigned((n + BN - 1) / BN), unsigned(nt));
    dense_tile<Op, T, BN, BK, VEC><<<grid, kThreads, 0, s>>>(
        x, y, n, k, m, t0 * BK, out);
  }
}

template <class Op, typename T, bool VEC>
void launch_tiles(const T* x, const T* y, long long n, long long k, int m,
                  float* out, cudaStream_t s) {
  if (k <= 16)
    launch_grid<Op, T, 256, 16, VEC>(x, y, n, k, m, out, s);
  else
    launch_grid<Op, T, 64, 64, VEC>(x, y, n, k, m, out, s);
}

// Launches the narrow tile (BN = 256, BK = 16) when K <= 16, else the square
// one, with vector row loads when m and both operands allow; returns the
// launch's CUDA error code.
template <class Op, typename T>
cudaError_t launch(const void* x, const void* y, long long n, long long k,
                   int m, float* out, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const uintptr_t quad = 4 * sizeof(T);
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % quad == 0 &&
                   reinterpret_cast<uintptr_t>(y) % quad == 0;
  if (vec)
    launch_tiles<Op, T, true>(xp, yp, n, k, m, out, s);
  else
    launch_tiles<Op, T, false>(xp, yp, n, k, m, out, s);
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.
template <class Op>
int launch_dtype(const void* x, const void* y, int dtype, long long n,
                 long long k, int m, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return int(launch<Op, float>(x, y, n, k, m, o, s));
    case 1:
      return int(launch<Op, __nv_bfloat16>(x, y, n, k, m, o, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace dense
