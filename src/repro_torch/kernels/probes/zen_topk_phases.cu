// Probe of where zen_topk's pass 1 spends its time at the serving shape
// (Q = 64, N = 1,000,000, k = 16 f32, n = 64 and 10), and how long pass 2
// takes.
//
// This is a measurement, not a kernel of the port: it explains the design
// of csrc/zen_topk.cu (PERF.md, section 6). Two parts:
//   - The SIMT pass 1 (the design before the MMA plan, kept as its "simt"
//     plan: 8 queries a block, 512-row tiles staged through a register
//     double buffer, an FMA loop, a candidate filter with a shared
//     atomicAdd, a block-wide count scan, block-wide bitonic flushes), a
//     copy with clock64() marks at the phase boundaries read by thread 0
//     of every block: each phase ends at a __syncthreads, so thread 0's
//     clock splits the block's time. The plan is the one launch_geometry
//     gave the serving batch: 33 splits of 30,720 rows, 105,088 B, two
//     blocks an SM. It prints the mean cycles a block spends in each
//     phase, the flushes and buffered candidates a block sees, and pass 1
//     (without the marks) and pass 2 (one block a query) apart, by CUDA
//     events over 20 launches.
//   - The MMA plan, csrc/zen_topk.cu itself compiled with its phase marks:
//     lane 0 of every consumer warp splits the warp's time into waiting
//     for a stage, scoring and filtering, appending, and flushing, and
//     counts flushes and flushed keys; pass 1 alone and both passes, at n
//     = 64 with and without the bound shared across blocks, and at n = 10,
//     with the plan launch_geometry gives (131 splits of 7,680 rows, 16
//     consumer warps in two row streams, 8 stages of 128 rows).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/zen_topk_phases src/repro_torch/kernels/probes/zen_topk_phases.cu
//   build/zen_topk_phases
#include <cstdint>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>

// The MMA plan's consumers mark four phases a step (wait for the stage,
// scoring and filter, append, flushes) and count flushes and flushed keys.
#define ZEN_TOPK_PROBE
__device__ long long g_mma_probe[132 * 16 * 8][6];
#define ZEN_PROBE_START() \
  long long zp_t = clock64(), zp_acc[4] = {0, 0, 0, 0}, zp_n = 0, zp_c = 0
#define ZEN_PROBE_MARK(p)               \
  do {                                  \
    const long long zp_now = clock64(); \
    zp_acc[p] += zp_now - zp_t;         \
    zp_t = zp_now;                      \
  } while (0)
#define ZEN_PROBE_FLUSH(c) \
  do {                     \
    ++zp_n;                \
    zp_c += (c);           \
  } while (0)
#define ZEN_PROBE_END()                                                     \
  do {                                                                      \
    if (lane == 0) {                                                        \
      long long* o =                                                        \
          g_mma_probe[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + warp];    \
      for (int i = 0; i < 4; ++i) o[i] = zp_acc[i];                         \
      o[4] = zp_n;                                                          \
      o[5] = zp_c;                                                          \
    }                                                                       \
  } while (0)
#include "../csrc/zen_topk.cu"

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e = (x);                                               \
    if (e != cudaSuccess) {                                            \
      printf("ERR %s at %d: %s\n", #x, __LINE__, cudaGetErrorString(e)); \
      return 1;                                                        \
    }                                                                  \
  } while (0)

namespace simt_probe {

constexpr int kThreads = 256, kRowsPerThread = 2, kTile = 512, kCols = 16;
constexpr int kXStride = kCols + 1, kRowsPerStep = kThreads / kCols;
constexpr int kLoads = kTile / kRowsPerStep;
constexpr int KQ = 8;
constexpr int kPhases = 7;
const char* kPhaseNames[kPhases] = {
    "setup (lists, queries, first loads)",
    "global loads + shared staging store (load_chunk, xs = pre)",
    "FMA loop (dot, norms)",
    "candidate filter + shared atomicAdd",
    "block-wide count scan (most)",
    "flushes (bitonic sort + merge)",
    "final flush + write-out"};

struct Marks {
  long long t;
  long long acc[kPhases];
  __device__ void start() {
    t = clock64();
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
  }
  __device__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - t;
    t = now;
  }
};

template <bool kProbe>
__device__ __forceinline__ void flush(uint64_t* best, uint64_t* buf, int* cnt,
                                      float* bound, int w, int cap, int n_out,
                                      int most) {
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

__device__ __forceinline__ void load_chunk(float (&pre)[kLoads],
                                           const float* __restrict__ index,
                                           int64_t tile0, int64_t row_end,
                                           int k, int c0, int lc, int lr) {
  const bool col_ok = lc < min(kCols, k - c0);
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int64_t row = tile0 + lr + it * kRowsPerStep;
    pre[it] = (col_ok && row < row_end) ? index[row * k + c0 + lc] : 0.0f;
  }
}

// The SIMT pass 1 (f32, no scales, 8 queries a block, lists in shared
// memory), with phase marks when kProbe.
template <bool kProbe>
__global__ void __launch_bounds__(kThreads, 2)
    partial(const float* __restrict__ queries, const float* __restrict__ index,
            int nq, int64_t n_index, int k, int n_out, int w, int cap,
            int64_t split_rows, int n_lists, uint64_t* out,
            long long* phase_cycles, long long* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  Marks mk;
  if (kProbe) mk.start();
  const int tid = threadIdx.x, q0 = blockIdx.x * KQ, split = blockIdx.y;
  uint64_t* best = reinterpret_cast<uint64_t*>(smem);
  uint64_t* buf = best + KQ * w;
  float* qs = reinterpret_cast<float*>(buf + KQ * cap);
  for (int t = tid; t < KQ * k; t += kThreads) {
    const int q = t / k, c = t - q * k;
    qs[c * KQ + q] = (q0 + q < nq) ? queries[int64_t(q0 + q) * k + c] : 0.0f;
  }
  float* xs = qs + KQ * k;
  float* qn = xs + kTile * kXStride;
  float* qa = qn + KQ;
  float* bound = qa + KQ;
  int* cnt = reinterpret_cast<int*>(bound + KQ);
  const int64_t row_begin = int64_t(split) * split_rows;
  const int64_t row_end = min(n_index, row_begin + split_rows);
  for (int t = tid; t < KQ * w; t += kThreads) best[t] = zen::kEmptyKey;
  if (tid < KQ) cnt[tid] = 0;
  __syncthreads();
  if (tid < KQ) {
    float s = 0.0f;
    for (int c = 0; c < k; ++c) s = fmaf(qs[c * KQ + tid], qs[c * KQ + tid], s);
    qn[tid] = s;
    qa[tid] = qs[(k - 1) * KQ + tid];
    bound[tid] = __int_as_float(0x7f800000);
  }
  __syncthreads();
  long long n_flush = 0, n_cand = 0;
  const int lc = tid % kCols, lr = tid / kCols;
  float pre[kLoads];
  if (row_begin < row_end) load_chunk(pre, index, row_begin, row_end, k, 0, lc, lr);
  if (kProbe) mk.mark(0);
  for (int64_t tile0 = row_begin; tile0 < row_end; tile0 += kTile) {
    float dot[kRowsPerThread][KQ], nx[kRowsPerThread], xa[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      nx[r] = 0.0f;
      xa[r] = 0.0f;
#pragma unroll
      for (int q = 0; q < KQ; ++q) dot[r][q] = 0.0f;
    }
    for (int c0 = 0; c0 < k; c0 += kCols) {
      const int kc = min(kCols, k - c0);
#pragma unroll
      for (int it = 0; it < kLoads; ++it) xs[(lr + it * kRowsPerStep) * kXStride + lc] = pre[it];
      __syncthreads();
      if (c0 + kCols < k) {
        load_chunk(pre, index, tile0, row_end, k, c0 + kCols, lc, lr);
      } else if (tile0 + kTile < row_end) {
        load_chunk(pre, index, tile0 + kTile, row_end, k, 0, lc, lr);
      }
      if (kProbe) mk.mark(1);
      const int kdot = min(kc, k - 1 - c0);
#pragma unroll 4
      for (int c = 0; c < kdot; ++c) {
        float qv[KQ];
#pragma unroll
        for (int q = 0; q < KQ; ++q) qv[q] = qs[(c0 + c) * KQ + q];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float v = xs[(tid + r * kThreads) * kXStride + c];
          nx[r] = fmaf(v, v, nx[r]);
#pragma unroll
          for (int q = 0; q < KQ; ++q) dot[r][q] = fmaf(qv[q], v, dot[r][q]);
        }
      }
      if (kdot < kc) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          xa[r] = xs[(tid + r * kThreads) * kXStride + kdot];
          nx[r] = fmaf(xa[r], xa[r], nx[r]);
        }
      }
      __syncthreads();
      if (kProbe) mk.mark(2);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int64_t row = tile0 + tid + r * kThreads;
      const int32_t id = row < row_end ? int32_t(row) : -1;
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        if (q0 + q >= nq) continue;
        const float z2 = zen::estimate_sq(qn[q], nx[r], dot[r][q], qa[q], xa[r], zen::kZen);
        if (z2 > bound[q]) continue;
        const uint64_t key = zen::make_key(zen::distance(z2), id >= 0, uint32_t(id));
        if (key < best[q * w + n_out - 1]) buf[int64_t(q) * cap + atomicAdd(&cnt[q], 1)] = key;
      }
    }
    __syncthreads();
    if (kProbe) mk.mark(3);
    int most = 0;
#pragma unroll
    for (int q = 0; q < KQ; ++q) most = max(most, cnt[q]);
    if (kProbe) mk.mark(4);
    if (most > cap - kTile) {
      if (tid == 0) {
        ++n_flush;
        for (int q = 0; q < KQ; ++q) n_cand += cnt[q];
      }
      flush<kProbe>(best, buf, cnt, bound, w, cap, n_out, most);
      if (kProbe) mk.mark(5);
    }
  }
  int most = 0;
#pragma unroll
  for (int q = 0; q < KQ; ++q) most = max(most, cnt[q]);
  if (most > 0) {
    if (tid == 0) {
      ++n_flush;
      for (int q = 0; q < KQ; ++q) n_cand += cnt[q];
    }
    flush<kProbe>(best, buf, cnt, bound, w, cap, n_out, most);
  }
  for (int t = tid; t < KQ * w; t += kThreads) {
    const int q = t / w, i = t - q * w;
    if (q0 + q < nq) out[(int64_t(q0 + q) * n_lists + split) * w + i] = best[t];
  }
  if (kProbe) {
    mk.mark(6);
    if (tid == 0) {
      const int b = blockIdx.y * gridDim.x + blockIdx.x;
      for (int p = 0; p < kPhases; ++p) phase_cycles[b * kPhases + p] = mk.acc[p];
      counts[2 * b] = n_flush;
      counts[2 * b + 1] = n_cand;
    }
  }
}

// pass 2, as in csrc/zen_topk.cu: one block a query tree-merges its lists
__global__ void __launch_bounds__(kThreads)
    merge(uint64_t* partial, int n_split, int n_lists, int w, int n_out,
          float* out_d, int32_t* out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const uint64_t* src = partial + int64_t(q) * n_lists * w;
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem);
  for (int t = threadIdx.x; t < n_lists * w; t += blockDim.x)
    lists[t] = t < n_split * w ? src[t] : zen::kEmptyKey;
  __syncthreads();
  for (int stride = 1; stride < n_lists; stride <<= 1)
    zen::merge_sorted_segments(lists, 2 * stride * w, lists + stride * w,
                               2 * stride * w, n_lists / (2 * stride), w);
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    out_d[int64_t(q) * n_out + t] = zen::key_distance(lists[t]);
    out_i[int64_t(q) * n_out + t] = int32_t(zen::key_tie(lists[t]));
  }
}

__global__ void fill_normal(float* x, int64_t n, int k, uint32_t seed) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n * k;
       i += int64_t(gridDim.x) * blockDim.x) {
    uint32_t h = uint32_t(i) * 2654435761u ^ seed;
    float s = 0.0f;
    for (int j = 0; j < 4; ++j) {  // sum of 4 uniforms, centred
      h ^= h >> 15; h *= 2246822519u; h ^= h >> 13; h *= 3266489917u; h ^= h >> 16;
      s += float(h) * 0x1p-32f;
    }
    s = (s - 2.0f) * 1.7320508f;
    x[i] = (i % k == k - 1) ? fabsf(s) : s;
  }
}

// The MMA plan at the serving shape for n_out neighbours (list width w, as
// launch_geometry plans it): pass 1 alone, both passes, and the phases.
int run_mma(const float* q, const float* x, int nq, int64_t n_index, int k,
            int n_out, int w, int smem, int merge_smem, uint64_t* part,
            uint64_t* bests, float* out_d, int32_t* out_i) {
  const int cap = 64, tile_rows = 128, stages = 8, warps = 16,
            streams = 2;
  const int n_split = 131, n_lists = 256;
  const int64_t split_rows = 7680;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto time = [&](auto fn) {
    for (int i = 0; i < 3; ++i) fn();
    cudaEventRecord(e0);
    for (int i = 0; i < 20; ++i) fn();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms / 20;
  };
  const float t1 = time([&] {
    mma::launch<float, true>(nq, n_split, smem, 0, q, x, nullptr, n_index,
                                k, n_out, w, cap, tile_rows, stages, warps,
                                streams, split_rows, n_lists, 0, part, bests);
  });
  const float t12 = time([&] {
    zen_topk_launch(q, x, nullptr, 0, nq, n_index, k, n_out, 0, 1, w, 64, cap,
                    0, smem, n_split, split_rows, n_lists, merge_smem,
                    tile_rows, stages, warps, streams, part, bests, out_d,
                    out_i, 0);
  });
  CK(cudaDeviceSynchronize());
  static long long h[132 * 16 * 8][6];
  CK(cudaMemcpyFromSymbol(h, g_mma_probe, sizeof(h)));
  double ph[6] = {0};
  const int n_warps = n_split * warps;
  for (int i = 0; i < n_warps; ++i)
    for (int p = 0; p < 6; ++p) ph[p] += double(h[i][p]) / n_warps;
  const double tot = ph[0] + ph[1] + ph[2] + ph[3];
  const char* names[4] = {"wait for the stage (full mbarrier)",
                          "scoring + filter (loads, 3xTF32 MMA, epilogue)",
                          "append (ballot, prefix, stores)",
                          "flushes (warp sort + merge)"};
  printf("MMA plan n=%d (w=%d, cap=%d, %d B, %s bound): pass 1 %.4f ms, "
         "both %.4f ms\n", n_out, w, cap, smem,
         bests ? "shared" : "no shared", t1, t12);
  for (int p = 0; p < 4; ++p)
    printf("  phase %-52s %10.0f cycles a warp  %5.1f%%\n", names[p], ph[p],
           100 * ph[p] / tot);
  printf("  a consumer warp: %.0f cycles, %.1f flushes, %.0f flushed keys "
         "(%.1f a query)\n", tot, ph[4], ph[5], ph[5] / 8);
  return 0;
}

int run() {
  const int nq = 64, k = 16, n_out = 64, w = 64, cap = 1024;
  const int64_t n_index = 1000000, split_rows = 30720;
  const int n_split = 33, n_lists = 64;
  const size_t smem = 8 * KQ * (w + cap) + 4 * KQ * k + 4 * (kTile * kXStride + 3 * KQ) + 4 * KQ;
  int sms, clk;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  CK(cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0));
  float *q, *x, *out_d;
  int32_t* out_i;
  uint64_t* part;
  long long *cyc, *cnt;
  const int n_blocks = (nq / KQ) * n_split;
  CK(cudaMalloc(&q, nq * k * 4));
  CK(cudaMalloc(&x, n_index * k * 4));
  CK(cudaMalloc(&part, size_t(nq) * n_lists * w * 8));
  CK(cudaMalloc(&out_d, nq * n_out * 4));
  CK(cudaMalloc(&out_i, nq * n_out * 4));
  CK(cudaMalloc(&cyc, n_blocks * kPhases * 8));
  CK(cudaMalloc(&cnt, n_blocks * 2 * 8));
  fill_normal<<<1024, 256>>>(x, n_index, k, 12345u);
  fill_normal<<<4, 256>>>(q, nq, k, 777u);
  CK(cudaFuncSetAttribute(partial<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  CK(cudaFuncSetAttribute(partial<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
  CK(cudaFuncSetAttribute(merge, cudaFuncAttributeMaxDynamicSharedMemorySize, 8 * n_lists * w));
  const dim3 grid(nq / KQ, n_split);
  auto pass1 = [&](bool probe) {
    if (probe)
      partial<true><<<grid, kThreads, smem>>>(q, x, nq, n_index, k, n_out, w, cap, split_rows, n_lists, part, cyc, cnt);
    else
      partial<false><<<grid, kThreads, smem>>>(q, x, nq, n_index, k, n_out, w, cap, split_rows, n_lists, part, cyc, cnt);
  };
  auto pass2 = [&]() {
    merge<<<nq, kThreads, 8 * n_lists * w>>>(part, n_split, n_lists, w, n_out, out_d, out_i);
  };
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto time = [&](auto fn) {
    for (int i = 0; i < 3; ++i) fn();
    cudaEventRecord(e0);
    for (int i = 0; i < 20; ++i) fn();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms / 20;
  };
  const float t1 = time([&] { pass1(false); });
  CK(cudaGetLastError());
  const float t2 = time(pass2);
  CK(cudaGetLastError());
  const float t12 = time([&] { pass1(false); pass2(); });
  const float t1p = time([&] { pass1(true); });
  CK(cudaDeviceSynchronize());
  std::vector<long long> hc(n_blocks * kPhases), hn(n_blocks * 2);
  CK(cudaMemcpy(hc.data(), cyc, hc.size() * 8, cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(hn.data(), cnt, hn.size() * 8, cudaMemcpyDeviceToHost));
  printf("device %d SMs, %d kHz max SM clock; Q=%d N=%lld k=%d n=%d: %d blocks of %d threads "
         "(%d queries, %lld rows), %zu B shared, w=%d cap=%d\n",
         sms, clk, nq, (long long)n_index, k, n_out, n_blocks, kThreads, KQ,
         (long long)split_rows, smem, w, cap);
  printf("pass 1 %.4f ms, pass 2 %.4f ms, both %.4f ms; pass 1 with the marks %.4f ms\n",
         t1, t2, t12, t1p);
  double tot = 0, ph[kPhases] = {0};
  for (int b = 0; b < n_blocks; ++b)
    for (int p = 0; p < kPhases; ++p) ph[p] += double(hc[b * kPhases + p]) / n_blocks;
  for (int p = 0; p < kPhases; ++p) tot += ph[p];
  for (int p = 0; p < kPhases; ++p)
    printf("phase %-60s %10.0f cycles a block  %5.1f%%\n", kPhaseNames[p], ph[p], 100 * ph[p] / tot);
  double fl = 0, ca = 0;
  for (int b = 0; b < n_blocks; ++b) {
    fl += double(hn[2 * b]) / n_blocks;
    ca += double(hn[2 * b + 1]) / n_blocks;
  }
  printf("a block: %.0f cycles in all, %.2f flushes, %.0f buffered candidates (%.1f a query), "
         "%lld tiles\n", tot, fl, ca, ca / KQ, (long long)((split_rows + kTile - 1) / kTile));
  std::vector<float> hd(nq * n_out);
  CK(cudaMemcpy(hd.data(), out_d, hd.size() * 4, cudaMemcpyDeviceToHost));
  bool sorted = true;
  for (int i = 0; i < nq; ++i)
    for (int j = 1; j < n_out; ++j) sorted &= hd[i * n_out + j - 1] <= hd[i * n_out + j];
  printf("results ascending: %s (query 0: %.4f .. %.4f)\n", sorted ? "yes" : "NO", hd[0], hd[n_out - 1]);
  uint64_t* part2;
  CK(cudaMalloc(&part2, size_t(nq) * 256 * 64 * 8));
  uint64_t* bests;
  CK(cudaMalloc(&bests, size_t(nq) * 64 * 8));
  if (run_mma(q, x, nq, n_index, k, 64, 64, 200832, 131072, part2, bests, out_d, out_i) ||
      run_mma(q, x, nq, n_index, k, 10, 16, 151680, 32768, part2, bests, out_d, out_i) ||
      run_mma(q, x, nq, n_index, k, 64, 64, 200832, 131072, part2, nullptr, out_d, out_i))
    return 1;
  return sorted ? 0 : 1;
}

}  // namespace simt_probe

int main() { return simt_probe::run(); }
