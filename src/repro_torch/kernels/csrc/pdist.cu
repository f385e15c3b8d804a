// Pairwise squared Euclidean distances for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pdist.py::pdist_sq (body
// _pdist_kernel): (N, m) x (K, m), f32 or bf16 (cast to f32 on load) ->
// (N, K) f32, out[i][j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0).
//
// What bounds it on an H100: at the transform's shape (N = 1e6 rows, K = 16
// references, m = 256) the bytes, 1.09 GB of rows read and distances
// written (0.33 ms at 3.35 TB/s); at the evaluation's square matrices
// (2,048^2 or 4,096^2 x 256) the products, 2 N K m operations: on the CUDA
// cores in f32 (67 TFLOP/s) 32 us at 2,048^2, in split TF32 on the tensor
// cores (three products at 495 TFLOP/s) 13 us, in bf16 (one at 989) 2 us
// against 5.6 us of bytes; at m = 16 the 16.8 MB of distances written (5
// us).
//
// Three plans; the wrapper's planner (kernels/pdist.py::pdist_plan) picks
// one and sizes it:
//   - "narrow" (K <= 16): dense_tile.cuh's 256 x 16 tile, so the
//     transform's 16 references cost no padded columns.
//   - "mma" (K > 16, rows 16-byte aligned: m % 4 == 0 in f32, m % 8 == 0 in
//     bf16, both operands on 16-byte boundaries): a persistent grid of one
//     block an SM walks the 128 x 128 output tiles through a ring of TMA
//     tensor copies (128 rows of X and 128 rows of Y, 128 bytes of each row
//     a stage, 128-byte swizzled, completing on an mbarrier a stage; the
//     hardware zero-fills past N, K and m, so ragged shapes need no padded
//     copy). Two warpgroups, 64 rows each, take the products with wgmma
//     (m64n128, A in registers, B from shared memory by descriptor): f32
//     in split TF32 (x = hi + lo, both rounded to TF32 to nearest; dot =
//     lo.hi + hi.lo + hi.hi, the dropped lo.lo below 2^-22 |x||y|), X split
//     in registers, Y split once a stage in shared memory (hi over x, lo in
//     a third tile of the stage); bf16 in one product, exact in f32. The
//     tensor cores' f32 accumulation truncates, so each stage's products
//     (32 f32 or 64 bf16 features, at most 12 wgmmas in a chain) land in a
//     fresh register partial that is added to an f32 total, as the TPU
//     kernel adds each block's partial to its accumulator: the error grows
//     with the stage count, not with m. Between a stage's k-steps (a warp's
//     wgmma issue waits for the tensor cores to take the earlier ones)
//     every thread prepares the next stage: the squares of half a row of X
//     and of Y summed on the CUDA cores in f32 (per stage, as the
//     products), Y's split, and its own A fragments. One block barrier a
//     stage; then thread 0 refills the stage. Tile and iteration counts
//     are 32-bit: a 64-bit division in thread 0's refill cost the block a
//     fifth of its time at 2,048^2 x 256. A tile's distances (finish below)
//     go to an output tile in shared memory, each warp's 16 rows into boxes
//     of its own that the warp's lane 0 stores by TMA (whole 128-byte
//     lines, clipped at N and K) while the block goes on; so the output's
//     rows must be 16-byte aligned too (K % 4 == 0). MMA row g of an m16
//     slice holds X row 2 (g & 3) + (g >> 2) of it, so that the fragment
//     loads and a half warp's 8-byte output writes hit different 16-byte
//     chunks of the swizzle.
//   - "simt" (every other shape: unaligned rows, operands or output rows):
//     dense_tile.cuh's 64 x 64 tile on the CUDA cores, elementwise loads
//     with zero fill.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_tile.cuh"
#include "hopper.cuh"

// Phase marks of the MMA plan's consumers for probes/pdist_phases.cu, which
// defines PDIST_PROBE and these macros before it includes this file.
#ifndef PDIST_PROBE
#define PDIST_PROBE_START()
#define PDIST_PROBE_MARK(phase)
#define PDIST_PROBE_END()
#endif

namespace {

struct SqEuclidean {
  __device__ __forceinline__ static float self(float v, float s) {
    return fmaf(v, v, s);
  }
  __device__ __forceinline__ static float pair(float a, float b, float s) {
    return fmaf(a, b, s);
  }
  // (|x|^2 + |y|^2) - 2 <x, y>, rounded step by step as the plain version
  // rounds it, then clamped at 0.
  __device__ __forceinline__ static float finish(float nx, float ny,
                                                 float dot) {
    return fmaxf(__fsub_rn(__fadd_rn(nx, ny), __fmul_rn(2.0f, dot)), 0.0f);
  }
};

// ---------------------------------------------------------------------------
// The MMA plan.
namespace mma {

using namespace hopper;

constexpr int kTile = 128;      // output rows and columns of a tile
constexpr int kRowBytes = 128;  // bytes of a row a stage: 32 f32, 64 bf16
constexpr int kOperandBytes = kTile * kRowBytes;
constexpr int kOutBytes = kTile * kTile * 4;  // a tile's distances
constexpr int kBoxCols = 32;    // an output box: 32 f32 columns (128 bytes)
constexpr int kBoxRows = 16;    // x a warp's 16 rows
constexpr int kBoxBytes = kBoxRows * kBoxCols * 4;
constexpr int kWarps = 8;       // two warpgroups of 64 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 4;
constexpr int kSteps = 4;       // k-steps a stage, 32 bytes of a row each

// A stage: the TMA's 128 rows of X and of Y, then (f32) the low parts of
// Y's split. Mirrored by kernels/pdist.py::mma_stage_bytes.
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return (sizeof(T) == 4 ? 3 : 2) * kOperandBytes;
}

// Dynamic shared memory of a block: 1 KB to align the ring to the
// swizzle's 1,024 bytes, the ring, the output tile, the row norms of two
// tiles, the mbarriers. Mirrored by kernels/pdist.py::mma_smem; the
// launcher refuses less.
__host__ __device__ constexpr size_t smem_bytes(int stage, int stages) {
  return 1024 + size_t(stages) * stage + kOutBytes +
         2 * 2 * kTile * sizeof(float) + 8 * kMaxStages;
}

// The staged row of MMA row g (0..7) in its group of 8: a half warp's
// 8-byte writes of the output then hit 16 different 16-byte chunks.
__device__ __forceinline__ int perm(int g) { return ((g & 3) << 1) | (g >> 2); }

__device__ __forceinline__ float sq_sum(uint4 v, float s, float) {
  s = fmaf(__uint_as_float(v.x), __uint_as_float(v.x), s);
  s = fmaf(__uint_as_float(v.y), __uint_as_float(v.y), s);
  s = fmaf(__uint_as_float(v.z), __uint_as_float(v.z), s);
  return fmaf(__uint_as_float(v.w), __uint_as_float(v.w), s);
}
__device__ __forceinline__ float sq_sum(uint4 v, float s, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s = fmaf(f.x, f.x, s);
    s = fmaf(f.y, f.y, s);
  }
  return s;
}

// Preparing a landed stage. Each thread takes half of row r = tid / 2 of
// X and of Y (the 64 bytes at 64 (tid % 2)) in four parts of 16 bytes: it
// sums their squares on the CUDA cores and, in f32, splits Y's values,
// x = hi + lo (both rounded to TF32 to nearest), writing hi over x and lo
// into the stage's third tile, in the same swizzled place. Only the bytes
// past the stage's first `valid` (zero fill) whose k-step issues no wgmma
// are skipped: a part of an issued k-step is prepared even where it is
// zero fill, so that its lo parts are written (zeros) and the wgmmas never
// read what an earlier stage or kernel left in the third tile.
template <typename T>
__device__ __forceinline__ void prepare_part(unsigned char* st, int valid,
                                             int part, float& xs, float& ys) {
  const int row = threadIdx.x >> 1, q = 4 * (threadIdx.x & 1) + part;
  if ((q >> 1) * 32 >= valid) return;  // k-step q / 2 issues nothing
  unsigned char* xb = st + row * kRowBytes;
  unsigned char* yb = xb + kOperandBytes;
  const uint32_t off = (q ^ (row & 7)) << 4;
  xs = sq_sum(*reinterpret_cast<const uint4*>(xb + off), xs, T());
  const uint4 v = *reinterpret_cast<const uint4*>(yb + off);
  ys = sq_sum(v, ys, T());
  if constexpr (sizeof(T) == 4) {
    uint4 hi, lo;
    split_tf32_rna(__uint_as_float(v.x), hi.x, lo.x);
    split_tf32_rna(__uint_as_float(v.y), hi.y, lo.y);
    split_tf32_rna(__uint_as_float(v.z), hi.z, lo.z);
    split_tf32_rna(__uint_as_float(v.w), hi.w, lo.w);
    *reinterpret_cast<uint4*>(yb + off) = hi;
    *reinterpret_cast<uint4*>(yb + kOperandBytes + off) = lo;
  }
}

// The end of a stage's preparation: the two halves' sums joined by a
// shuffle, and this lane's A fragments of the stage (raw): X rows xr and
// xr + 8 (xr mod 8 = x8), k-slots t and t + 4 (f32) or 2t, 2t + 1 and
// 2t + 8, 2t + 9 (bf16), in both the 4 bytes at 4t and at 4t + 16 of each
// k-step's 32. Returns the stage's sum of squares of the row whose norm
// this thread keeps: X row r (even threads) or Y row r (odd).
__device__ __forceinline__ float prepare_end(const unsigned char* st,
                                             float xs, float ys, int xr,
                                             int x8, int t,
                                             uint32_t (&raw)[kSteps][4]) {
  xs = __fadd_rn(xs, __shfl_xor_sync(~0u, xs, 1));
  ys = __fadd_rn(ys, __shfl_xor_sync(~0u, ys, 1));
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        raw[ks][h + 2 * u] = *reinterpret_cast<const uint32_t*>(
            st + (xr + 8 * h) * kRowBytes + (((2 * ks + u) ^ x8) << 4) +
            4 * t);
  return (threadIdx.x & 1) ? ys : xs;
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[kSteps][N]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// One stage's products into d (overwritten: the stage's partial), for this
// warpgroup's 64 rows against the tile's 128 columns, from the stage's A
// fragments (raw, from prepare_end) and Y's rows by descriptor. f32: three
// products in split TF32 (lo.hi + hi.lo + hi.hi), X's split into ahi and
// alo here (both rounded to TF32 to nearest), Y's from the preparation;
// bf16: one product from ahi (a copy of raw). Issues the wgmmas k-step by
// k-step and commits them; ahi and alo are the wgmmas' A registers until
// they complete (keep them till then). Between the k-steps it prepares the next stage (next, once its
// mbarrier's phase next_parity has completed), so that the CUDA cores work
// while the tensor cores do: a warp's wgmma issue waits for the tensor
// cores to take the earlier ones.
template <typename T>
__device__ __forceinline__ void products(
    float (&d)[64], const unsigned char* st, const uint32_t (&raw)[kSteps][4],
    uint32_t (&ahi)[kSteps][4], uint32_t (&alo)[kSteps][4], int valid,
    unsigned char* next, uint64_t* next_full, int next_parity,
    int next_valid, float& xs, float& ys) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        split_tf32_rna(__uint_as_float(raw[ks][e]), ahi[ks][e], alo[ks][e]);
      } else {
        ahi[ks][e] = raw[ks][e];
        alo[ks][e] = 0u;
      }
    }
  fence_operands(d);
  keep(ahi);
  keep(alo);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if (ks * 32 < valid) {
      const uint64_t bhi = sw128_desc(st + kOperandBytes + 32 * ks);
      if constexpr (sizeof(T) == 4) {
        const uint64_t blo = sw128_desc(st + 2 * kOperandBytes + 32 * ks);
        wgmma_tf32(d, alo[ks], bhi, ks > 0);
        wgmma_tf32(d, ahi[ks], blo, 1);
        wgmma_tf32(d, ahi[ks], bhi, 1);
      } else {
        wgmma_bf16(d, ahi[ks], bhi, ks > 0);
      }
    }
    if (next != nullptr) {
      if (ks == 0) bar_wait(next_full, next_parity);
      prepare_part<T>(next, next_valid, ks, xs, ys);
    }
  }
  wgmma_commit();
  fence_operands(d);
}

// Thread 0 issues both operands' TMA copies of iteration j of the block's
// walk: its (j / chunks)-th tile (tiles blockIdx.x, + gridDim.x, ... of the
// row-major row x col_tiles grid), stage j % chunks of it. (32-bit tile
// arithmetic: a 64-bit division costs hundreds of instructions.)
__device__ __forceinline__ void load_stage(const CUtensorMap* xmap,
                                           const CUtensorMap* ymap,
                                           unsigned char* st, uint64_t* full,
                                           int j, int chunks, int cols,
                                           uint32_t col_tiles) {
  const uint32_t tile = blockIdx.x + uint32_t(j / chunks) * gridDim.x;
  const int c = j % chunks;
  bar_expect(full, 2 * kOperandBytes);
  tensor_load_2d(st, xmap, c * cols, int(tile / col_tiles) * kTile, full);
  tensor_load_2d(st + kOperandBytes, ymap, c * cols,
                 int(tile % col_tiles) * kTile, full);
}

// The block walks tiles blockIdx.x, + gridDim.x, ... of the row_tiles x
// col_tiles output tiles (row-major), each over `chunks` stages of 128
// bytes a row, through a ring of `stages` stages: iteration it issues its
// stage's wgmmas, prepares the next stage while they run, waits for them
// and adds their partial to the tile's total, and passes one block
// barrier, after which thread 0 refills the stage. A tile's distances
// leave through the output tile in shared memory by TMA stores.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    pdist_mma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap omap, int m,
              uint32_t n_tiles, uint32_t col_tiles, int chunks, int stages) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kStage = stage_bytes<T>();
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* outs = ring + stages * kStage;
  float* norms = reinterpret_cast<float*>(outs + kOutBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(norms + 2 * 2 * kTile);
  constexpr int kCols = kRowBytes / int(sizeof(T));  // features a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_tiles = int((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int iters = my_tiles * chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < stages && j < iters; ++j)
      load_stage(&xmap, &ymap, ring + j * kStage, &full[j], j, chunks,
                 kCols, col_tiles);
  }
  __syncthreads();

  // this lane's rows of the tile: xr and xr + 8 (its warpgroup's 64 rows,
  // its warp's 16 of them); its columns 8j + 2t and + 1 of each n8 tile j
  const int g = lane >> 2, t = lane & 3;
  const int pa = perm(g);
  const int xr = (warp >> 2) * 64 + (warp & 3) * 16 + pa;
  // bytes of a row of stage j that hold features; the rest is zero fill
  auto valid_of = [&](int j) {
    return min(kCols, m - (j % chunks) * kCols) * int(sizeof(T));
  };
  PDIST_PROBE_START();
  uint32_t raw[kSteps][4], ahi[kSteps][4], alo[kSteps][4];
  float xs = 0.0f, ys = 0.0f;
  bar_wait(&full[0], 0);
#pragma unroll
  for (int part = 0; part < 4; ++part)
    prepare_part<T>(ring, valid_of(0), part, xs, ys);
  float nsum = prepare_end(ring, xs, ys, xr, pa, t, raw);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float tot[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) tot[e] = part[e] = 0.0f;
  float norm = 0.0f;
  PDIST_PROBE_MARK(0);
  for (int it = 0; it < iters; ++it) {
    const int s = it % stages, c = it % chunks;
    unsigned char* st = ring + s * kStage;
    norm = __fadd_rn(norm, nsum);
    // this stage's products, and the next stage's preparation while the
    // tensor cores work
    const int s1 = (it + 1) % stages;
    unsigned char* next = it + 1 < iters ? ring + s1 * kStage : nullptr;
    xs = ys = 0.0f;
    products<T>(part, st, raw, ahi, alo, valid_of(it), next, &full[s1],
                ((it + 1) / stages) & 1, valid_of(it + 1), xs, ys);
    PDIST_PROBE_MARK(1);
    if (next != nullptr) {
      nsum = prepare_end(next, xs, ys, xr, pa, t, raw);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    PDIST_PROBE_MARK(2);
    wgmma_wait();
    fence_operands(part);
    keep(ahi);
    keep(alo);
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] = __fadd_rn(tot[e], part[e]);
    const bool last = c == chunks - 1;
    const int tl = it / chunks;
    float* nb = norms + (tl & 1) * 2 * kTile;
    // this warp's output boxes, free once the stores of the tile before
    // have read them
    unsigned char* box = outs + warp * (kOutBytes / kWarps);
    if (last) {
      nb[(threadIdx.x & 1) * kTile + (threadIdx.x >> 1)] = norm;
      if (lane == 0 && tl > 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    PDIST_PROBE_MARK(3);
    __syncthreads();
    // every warp is done with stage s: refill it
    if (threadIdx.x == 0 && it + stages < iters)
      load_stage(&xmap, &ymap, st, &full[s], it + stages, chunks, kCols,
                 col_tiles);
    PDIST_PROBE_MARK(4);
    if (!last) continue;
    // the epilogue of tile tl
    const uint32_t tile = blockIdx.x + uint32_t(tl) * gridDim.x;
    const int r0 = int(tile / col_tiles) * kTile;
    const int c0 = int(tile % col_tiles) * kTile;
    // the norms of this lane's rows; its columns' (8j + 2t, + 1) are read
    // per j (held all at once, they would push the kernel past 255
    // registers)
    const float nx[2] = {nb[xr], nb[xr + 8]};
    // into the warp's boxes (box j / 4: 16 rows x 32 columns, 128-byte
    // swizzled as the TMA store reads it; a half warp's 8-byte writes hit
    // 16 different chunks), then the warp's TMA stores, which clip at N
    // and K
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 nc =
          *reinterpret_cast<const float2*>(&nb[kTile + 8 * j + 2 * t]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            box + (j >> 2) * kBoxBytes + (8 * h + pa) * kRowBytes +
            (((2 * (j & 3) + (t >> 1)) ^ pa) << 4) + ((t & 1) << 3)) =
            make_float2(
                SqEuclidean::finish(nx[h], nc.x, tot[4 * j + 2 * h]),
                SqEuclidean::finish(nx[h], nc.y, tot[4 * j + 2 * h + 1]));
    }
    PDIST_PROBE_MARK(5);
    // the warp's generic writes, then the TMA's reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      for (int b = 0; b < kTile / kBoxCols; ++b)
        tensor_store_2d(&omap, c0 + b * kBoxCols, r0 + xr - pa,
                        box + b * kBoxBytes);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] = 0.0f;
    norm = 0.0f;
    PDIST_PROBE_MARK(6);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  PDIST_PROBE_END();
}

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links against the runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (rows, cols) row-major matrix of `type` (`es` bytes
// an element): boxes of box_rows rows x 128 bytes, 128-byte swizzled, zero
// outside.
cudaError_t make_map(CUtensorMap* map, const void* base, long long rows,
                     long long cols, CUtensorMapDataType type, int es,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * es};
  const cuuint32_t box[2] = {cuuint32_t(kRowBytes / es),
                             cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* x, const void* y, long long n, long long k,
                   int m, int grid, int stages, int smem, float* out,
                   cudaStream_t s) {
  if (grid < 1 || stages < 2 || stages > kMaxStages || k % 4 != 0 ||
      size_t(smem) < smem_bytes(stage_bytes<T>(), stages))
    return cudaErrorInvalidValue;
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap xmap, ymap, omap;
  cudaError_t e = make_map(&xmap, x, n, m, type, int(sizeof(T)), kTile);
  if (e == cudaSuccess)
    e = make_map(&ymap, y, k, m, type, int(sizeof(T)), kTile);
  if (e == cudaSuccess)
    e = make_map(&omap, out, n, k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                 kBoxRows);
  // the opt-in holds for the current device only: set it at every launch
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pdist_mma<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  const long long col_tiles = (k + kTile - 1) / kTile;
  const long long n_tiles = (n + kTile - 1) / kTile * col_tiles;
  const int chunks = int((int64_t(m) * sizeof(T) + kRowBytes - 1) / kRowBytes);
  // tiles and a block's iterations are counted in 32 bits
  if (int64_t(grid) > n_tiles || n_tiles >= (int64_t(1) << 31) ||
      (n_tiles + grid - 1) / grid * int64_t(chunks) >= (int64_t(1) << 31))
    return cudaErrorInvalidValue;
  pdist_mma<T><<<grid, kThreads, smem, s>>>(
      xmap, ymap, omap, m, uint32_t(n_tiles), uint32_t(col_tiles), chunks,
      stages);
  return cudaGetLastError();
}

}  // namespace mma

template <typename T>
cudaError_t launch_plan(const void* x, const void* y, long long n,
                        long long k, int m, int kernel, int grid, int stages,
                        int smem, float* out, cudaStream_t s) {
  switch (kernel) {
    case 0:  // dense_tile.cuh: the narrow tile for K <= 16, else the SIMT one
      return dense::launch<SqEuclidean, T>(x, y, n, k, m, out, s);
    case 1:
      return mma::launch<T>(x, y, n, k, m, grid, stages, smem, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, m) and y (k, m) contiguous, dtype 0 float32 or 1 bfloat16; out
// (n, k) float32. The plan (kernels/pdist.py::PdistPlan): kernel 0 the
// dense tile (narrow or simt), 1 mma, with the mma plan's grid, ring
// stages and dynamic shared bytes. Returns the launch's CUDA error code (0
// on success).
int pdist_sq_launch(const void* x, const void* y, int dtype, long long n,
                    long long k, int m, int kernel, int grid, int stages,
                    int smem, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return int(launch_plan<float>(x, y, n, k, m, kernel, grid, stages,
                                    smem, o, s));
    case 1:
      return int(launch_plan<__nv_bfloat16>(x, y, n, k, m, kernel, grid,
                                            stages, smem, o, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
