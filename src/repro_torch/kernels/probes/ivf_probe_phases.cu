// Probe of where ivf_probe's pass 1 spends its time at the serving shape:
// Q = 64 queries, nprobe 8, clusters of T = 3 tiles of 128 rows, k = 16
// f32, n = 64.
//
// This is a measurement, not a kernel of the port: it explains the design
// of csrc/ivf_probe.cu (PERF.md, section 6). Two parts:
//   - The block plan (the whole design before the warp plan, kept for
//     lists wider than 64): a copy of its pass 1 (one 256-thread block per
//     (query, probe column), one row a thread in chunks of 256, a shared
//     atomicAdd a candidate, a barrier pair a chunk, a block-wide bitonic
//     flush and merge) with clock64() marks read by thread 0 of every
//     block at the phase boundaries, each of which ends at a __syncthreads,
//     so thread 0's clock splits the block's time:
//       0 list init (and the query's staging and norm)
//       1 row loads and scoring (the ids, the k coordinates, the estimate)
//       2 appends (the filter, the sqrt, the key and the shared atomicAdd)
//       3 the end_chunk barriers and the count
//       4 the flush's bitonic sort
//       5 the flush's merge into the list
//       6 write-out of the list
//     It prints the mean cycles a block spends in each phase and the
//     flushes and buffered candidates a block sees; then pass 1 without
//     the marks, pass 2 (the block plan's merge, one block a query) and
//     both, by CUDA events over 50 launches queued behind a spin kernel.
//   - The warp plan, csrc/ivf_probe.cu itself compiled with its phase
//     marks: lane 0 of every warp splits the warp's time into set-up, the
//     ids, loads and scoring, the appends to the candidate slots, the wait
//     at the barrier after the scan, the radix select, the gather and
//     sort, the cluster's merge and write-out (marks beside barriers may
//     land on either side: read a wait and the phase after it together),
//     and counts radix passes and candidates; first with the plan that
//     kernels/ivf_probe.py::probe_plan gives this shape (clusters of 2
//     blocks of 12 warps, 4 probe columns a block in 3 splits of 128
//     rows), then under other plans, each timed with the marks and again
//     with every probe column empty (the launch, set-up and finish alone).
// The index is synthetic: 4,000 clusters of 384 slots holding 150-350 live
// rows each (ids unique, the rest -1), coordinates uniform in [-1, 1) with
// the altitude column |.|, each query probing 8 distinct clusters drawn at
// random.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/ivf_probe_phases src/repro_torch/kernels/probes/ivf_probe_phases.cu
//   build/ivf_probe_phases
#include <cstdint>
#include <cmath>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>

// The warp plan's scalar kernel marks eight phases and counts radix
// passes and candidates.
#define IVF_PROBE_PHASES
constexpr int kWarpPhases = 8;
__device__ long long g_warp_marks[64 * 8 * 16][kWarpPhases + 2];
__device__ __forceinline__ long long clock_now() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;  // the host pass compiles no device code
#endif
}
struct PhaseMarks {
  long long t, acc[kWarpPhases], n = 0, c = 0;
  __device__ PhaseMarks() : t(clock_now()) {
    for (int i = 0; i < kWarpPhases; ++i) acc[i] = 0;
  }
  __device__ void mark(int p) {
    const long long now = clock_now();
    acc[p] += now - t;
    t = now;
  }
  __device__ void radix_pass(int count) {
    ++n;
    c += count;
  }
  __device__ void end() {
    if ((threadIdx.x & 31) != 0) return;
    long long* o = g_warp_marks[blockIdx.x * 16 + (threadIdx.x >> 5)];
    for (int i = 0; i < kWarpPhases; ++i) o[i] = acc[i];
    o[kWarpPhases] = n;
    o[kWarpPhases + 1] = c;
  }
};
#include "../csrc/ivf_probe.cu"

#define CK(x)                                                            \
  do {                                                                   \
    cudaError_t e = (x);                                                 \
    if (e != cudaSuccess) {                                              \
      printf("ERR %s at %d: %s\n", #x, __LINE__, cudaGetErrorString(e)); \
      return 1;                                                          \
    }                                                                    \
  } while (0)

namespace old_plan {

constexpr int kBlockThreads = 256;
constexpr int kPhases = 7;
constexpr int kQ = 64, kP = 8, kC = 4000, kT = 3, kRows = 128, kK = 16;
constexpr int kN = 64, kW = 64, kCap = 1024;
constexpr int64_t kClusterRows = kT * kRows;

__device__ long long g_phase[kQ * kP][kPhases + 2];

struct Marks {
  long long t, acc[kPhases], flushes, flushed;
  __device__ void start() {
    t = clock64();
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
    flushes = flushed = 0;
  }
  __device__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - t;
    t = now;
  }
};

// today's pass 1 (csrc/ivf_probe.cu, ivf_probe_partial<float>, shared
// lists), the marks compiled in with kMarks
template <bool kMarks>
__global__ void __launch_bounds__(kBlockThreads)
    partial(const float* __restrict__ queries, const float* __restrict__ tiles,
            const int32_t* __restrict__ tile_ids,
            const int32_t* __restrict__ probes, uint64_t* partial_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cnt;
  __shared__ float bound, qn_s;
  Marks mk;
  const bool lead = kMarks && threadIdx.x == 0;
  if (lead) mk.start();
  uint64_t* best = reinterpret_cast<uint64_t*>(smem);
  uint64_t* buf = best + kW;
  float* qs = reinterpret_cast<float*>(buf + kCap);
  for (int i = threadIdx.x; i < kW; i += blockDim.x) best[i] = zen::kEmptyKey;
  if (threadIdx.x == 0) {
    cnt = 0;
    bound = __int_as_float(0x7f800000);
  }
  const int q = blockIdx.x / kP, p = blockIdx.x - q * kP;
  const int c = probes[blockIdx.x];
  for (int i = threadIdx.x; i < kK; i += blockDim.x)
    qs[i] = queries[q * kK + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kK; ++i) s = fmaf(qs[i], qs[i], s);
    qn_s = s;
  }
  __syncthreads();
  if (lead) mk.mark(0);
  const float qn = qn_s, qa = qs[kK - 1];
  const int64_t base = int64_t(c) * kClusterRows;
  const uint32_t pos0 = uint32_t(p * kClusterRows);
  constexpr int kChunks = (kClusterRows + kBlockThreads - 1) / kBlockThreads;
  for (int chunk = 0; chunk <= kChunks; ++chunk) {
    const bool last = chunk == kChunks;  // the final end_chunk
    const int64_t j0 = int64_t(chunk) * kBlockThreads;
    if (!last) {
      const int64_t j = j0 + threadIdx.x;
      const int32_t id = j < kClusterRows ? tile_ids[base + j] : -1;
      float z2 = 0.0f;
      if (id >= 0) {
        const float* x = tiles + (base + j) * kK;
        float nx = 0.0f, dot = 0.0f;
        for (int i = 0; i < kK - 1; ++i) {
          const float v = __fmul_rn(x[i], 1.0f);
          nx = fmaf(v, v, nx);
          dot = fmaf(qs[i], v, dot);
        }
        const float xa = __fmul_rn(x[kK - 1], 1.0f);
        nx = fmaf(xa, xa, nx);
        z2 = zen::estimate_sq(qn, nx, dot, qa, xa, zen::kZen);
      }
      if (kMarks) __syncthreads();  // the probe's own barrier: splits 1|2
      if (lead) mk.mark(1);
      if (id >= 0 && z2 <= bound) {
        const float d = zen::distance(z2);
        const uint64_t key = zen::make_key(
            d, d < __int_as_float(0x7f800000), pos0 + uint32_t(j));
        if (key < best[kN - 1]) buf[atomicAdd(&cnt, 1)] = key;
      }
    }
    // end_chunk
    __syncthreads();
    if (lead) mk.mark(2);
    const int filled = cnt;
    __syncthreads();
    if (lead) mk.mark(3);
    if (last ? filled > 0 : filled > kCap - kBlockThreads) {
      int pw = 1;
      while (pw < filled) pw <<= 1;
      const int fill = max(pw, kW);
      for (int i = threadIdx.x; i < fill; i += blockDim.x)
        if (i >= filled) buf[i] = zen::kEmptyKey;
      __syncthreads();
      zen::bitonic_sort_segments(buf, 1, pw, kCap);
      if (lead) {
        mk.mark(4);
        ++mk.flushes;
        mk.flushed += filled;
      }
      zen::merge_sorted_segments(best, kW, buf, kCap, 1, kW);
      if (threadIdx.x == 0) {
        cnt = 0;
        bound = zen::squared_bound(zen::key_distance(best[kN - 1]));
      }
      __syncthreads();
      if (lead) mk.mark(5);
    }
  }
  for (int i = threadIdx.x; i < kW; i += blockDim.x)
    partial_out[int64_t(blockIdx.x) * kW + i] = best[i];
  __syncthreads();
  if (lead) {
    mk.mark(6);
    for (int i = 0; i < kPhases; ++i) g_phase[blockIdx.x][i] = mk.acc[i];
    g_phase[blockIdx.x][kPhases] = mk.flushes;
    g_phase[blockIdx.x][kPhases + 1] = mk.flushed;
  }
}

// today's pass 2 (csrc/ivf_probe.cu, ivf_probe_merge in shared memory,
// all 8 lists in one group)
__global__ void __launch_bounds__(kBlockThreads)
    merge(const uint64_t* __restrict__ partial_in,
          const int32_t* __restrict__ tile_ids,
          const int32_t* __restrict__ probes, float* __restrict__ out_d,
          int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  uint64_t* best = reinterpret_cast<uint64_t*>(smem);
  uint64_t* lists = best + kW;
  const uint64_t* src = partial_in + int64_t(q) * kP * kW;
  for (int i = threadIdx.x; i < kW; i += blockDim.x) best[i] = zen::kEmptyKey;
  for (int t = threadIdx.x; t < kP * kW; t += blockDim.x) lists[t] = src[t];
  __syncthreads();
  for (int stride = 1; stride < kP; stride <<= 1)
    zen::merge_sorted_segments(lists, 2 * stride * kW, lists + stride * kW,
                               2 * stride * kW, kP / (2 * stride), kW);
  zen::merge_sorted_segments(best, kW, lists, kW, 1, kW);
  for (int t = threadIdx.x; t < kN; t += blockDim.x) {
    const uint64_t key = best[t];
    float d = __int_as_float(0x7f800000);
    int32_t id = -1;
    if (key != zen::kEmptyKey) {
      const int64_t pos = zen::key_tie(key);
      const int64_t pp = pos / kClusterRows;
      const int c = probes[q * kP + pp];
      id = tile_ids[c * kClusterRows + (pos - pp * kClusterRows)];
      d = zen::key_distance(key);
    }
    out_d[q * kN + t] = d;
    out_i[q * kN + t] = id;
  }
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

uint32_t rng_state = 12345u;
uint32_t next_u32() {
  rng_state = rng_state * 1664525u + 1013904223u;
  return rng_state;
}
float next_unit() { return (next_u32() >> 8) * (2.0f / 16777216.0f) - 1.0f; }

}  // namespace old_plan

int main() {
  using namespace old_plan;
  const int64_t slots = int64_t(kC) * kClusterRows;
  std::vector<float> h_tiles(slots * kK), h_q(kQ * kK);
  std::vector<int32_t> h_ids(slots, -1), h_probes(kQ * kP);
  int32_t next_id = 0;
  for (int c = 0; c < kC; ++c) {
    const int live = 150 + int(next_u32() % 201);
    for (int j = 0; j < kClusterRows; ++j) {
      const int64_t r = int64_t(c) * kClusterRows + j;
      for (int i = 0; i < kK; ++i) h_tiles[r * kK + i] = next_unit();
      h_tiles[r * kK + kK - 1] = fabsf(h_tiles[r * kK + kK - 1]);
      if (j < live) h_ids[r] = next_id++;
    }
  }
  for (int i = 0; i < kQ * kK; ++i) h_q[i] = next_unit();
  for (int q = 0; q < kQ; ++q) {
    h_q[q * kK + kK - 1] = fabsf(h_q[q * kK + kK - 1]);
    for (int p = 0; p < kP; ++p) {
      int c;
      bool again;
      do {
        c = int(next_u32() % kC);
        again = false;
        for (int o = 0; o < p; ++o) again |= h_probes[q * kP + o] == c;
      } while (again);
      h_probes[q * kP + p] = c;
    }
  }
  float *d_tiles, *d_q, *d_out;
  int32_t *d_ids, *d_probes, *d_out_i;
  uint64_t* d_partial;
  CK(cudaMalloc(&d_tiles, h_tiles.size() * 4));
  CK(cudaMalloc(&d_q, h_q.size() * 4));
  CK(cudaMalloc(&d_ids, h_ids.size() * 4));
  CK(cudaMalloc(&d_probes, h_probes.size() * 4));
  CK(cudaMalloc(&d_partial, size_t(kQ) * kP * kW * 8));
  CK(cudaMalloc(&d_out, kQ * kN * 4));
  CK(cudaMalloc(&d_out_i, kQ * kN * 4));
  CK(cudaMemcpy(d_tiles, h_tiles.data(), h_tiles.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(d_q, h_q.data(), h_q.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(d_ids, h_ids.data(), h_ids.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(d_probes, h_probes.data(), h_probes.size() * 4,
                cudaMemcpyHostToDevice));
  int32_t* d_no_probes;
  CK(cudaMalloc(&d_no_probes, h_probes.size() * 4));
  CK(cudaMemset(d_no_probes, 0xff, h_probes.size() * 4));
  const int smem1 = 8 * (kW + kCap) + 4 * kK;
  const int smem2 = 8 * (kP + 1) * kW;
  const int blocks = kQ * kP;
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("%s, %d SMs; Q = %d, nprobe %d, T = %d x %d rows, k = %d f32, n = "
         "%d: %d pass-1 blocks of %d threads, %d B\n",
         prop.name, prop.multiProcessorCount, kQ, kP, kT, kRows, kK, kN,
         blocks, kBlockThreads, smem1);

  // the marked run: mean cycles a block in each phase
  partial<true><<<blocks, kBlockThreads, smem1>>>(d_q, d_tiles, d_ids, d_probes,
                                             d_partial);
  CK(cudaGetLastError());
  CK(cudaDeviceSynchronize());
  std::vector<long long> ph(size_t(blocks) * (kPhases + 2));
  CK(cudaMemcpyFromSymbol(ph.data(), g_phase, ph.size() * 8));
  static const char* names[kPhases] = {
      "list init + query", "row loads + scoring", "appends",
      "end_chunk barriers + count", "flush sort", "flush merge",
      "write-out"};
  double sum[kPhases + 2] = {0};
  for (int b = 0; b < blocks; ++b)
    for (int i = 0; i < kPhases + 2; ++i) sum[i] += ph[b * (kPhases + 2) + i];
  double total = 0;
  for (int i = 0; i < kPhases; ++i) total += sum[i];
  printf("pass 1 with marks, mean a block: %.0f cycles\n", total / blocks);
  for (int i = 0; i < kPhases; ++i)
    printf("  %-28s %9.0f cycles  %5.1f%%\n", names[i], sum[i] / blocks,
           100.0 * sum[i] / total);
  printf("  flushes a block %.2f, buffered candidates a block %.1f\n",
         sum[kPhases] / blocks, sum[kPhases + 1] / blocks);

  // device times, CUDA events over 50 launches each
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  // 50 launches queued behind a spin that outlasts their enqueueing, so
  // the host's launch rate is left out
  auto time_ms = [&](auto&& launch) {
    for (int i = 0; i < 5; ++i) launch();
    spin<<<1, 1>>>(4000000);
    cudaEventRecord(e0);
    for (int i = 0; i < 50; ++i) launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    return ms / 50;
  };
  auto pass1 = [&] {
    partial<false><<<blocks, kBlockThreads, smem1>>>(d_q, d_tiles, d_ids,
                                                d_probes, d_partial);
  };
  auto pass2 = [&] {
    merge<<<kQ, kBlockThreads, smem2>>>(d_partial, d_ids, d_probes, d_out,
                                   d_out_i);
  };
  const float t1 = time_ms(pass1);
  const float t2 = time_ms(pass2);
  const float t12 = time_ms([&] {
    pass1();
    pass2();
  });
  const float tm = time_ms([&] {
    partial<true><<<blocks, kBlockThreads, smem1>>>(d_q, d_tiles, d_ids, d_probes,
                                               d_partial);
  });
  CK(cudaGetLastError());
  CK(cudaDeviceSynchronize());
  printf("device time (events, 50 launches): pass 1 %.4f ms (with marks "
         "%.4f), pass 2 %.4f ms, both %.4f ms\n",
         t1, tm, t2, t12);

  // the warp plan with its marks: the plan probe_plan(64, 8, k=16, nq=64,
  // cluster_rows=384) gives, then the same kernel under other plans (four
  // blocks a query and more spill into a second wave at 128 registers a
  // thread)
  struct WarpPlan {
    int cluster, cols, warps, splits, split_rows;
  };
  const WarpPlan plans[] = {{2, 4, 12, 3, 128}, {1, 8, 16, 2, 192},
                            {2, 4, 16, 6, 64},  {2, 4, 16, 3, 128},
                            {4, 2, 12, 6, 64},  {4, 2, 6, 3, 128},
                            {8, 1, 6, 6, 64},   {8, 1, 3, 3, 128}};
  static const char* wnames[kWarpPhases] = {
      "set-up",      "ids, loads + scoring", "appends",
      "wait for the block", "radix select", "gather + sort",
      "cluster merge", "write-out"};
  for (const WarpPlan& pl : plans) {
    const int smem_w = int(warp::smem_bytes(int64_t(pl.cols) * kClusterRows,
                                            pl.cols, 0, pl.cluster));
    auto warp_launch = [&] {
      return ivf_probe_launch(d_q, d_tiles, d_ids, d_probes, nullptr, 0, kQ,
                              kP, kC, kClusterRows, kK, kN, 0, 1, kW, 64, 0,
                              smem_w, 0, 0, pl.warps, pl.splits,
                              pl.split_rows, pl.cols, pl.cluster, 1, nullptr,
                              nullptr, nullptr, d_out, d_out_i, nullptr);
    };
    CK(cudaMemset(d_out_i, 0xff, kQ * kN * 4));
    const int err = warp_launch();
    if (err != 0) {
      printf("warp plan launch failed: %s\n",
             cudaGetErrorString(cudaError_t(err)));
      return 1;
    }
    CK(cudaDeviceSynchronize());
    std::vector<int32_t> got(kQ * kN);
    CK(cudaMemcpy(got.data(), d_out_i, got.size() * 4,
                  cudaMemcpyDeviceToHost));
    int filled = 0;
    for (int32_t v : got) filled += v >= 0;
    const int n_warps = kQ * pl.cluster * pl.warps;
    std::vector<long long> wm(size_t(kQ) * 8 * 16 * (kWarpPhases + 2));
    CK(cudaMemcpyFromSymbol(wm.data(), g_warp_marks, wm.size() * 8));
    double wsum[kWarpPhases + 2] = {0};
    for (int b = 0; b < kQ * pl.cluster; ++b)
      for (int w = 0; w < pl.warps; ++w)
        for (int i = 0; i < kWarpPhases + 2; ++i)
          wsum[i] += wm[(b * 16 + w) * (kWarpPhases + 2) + i];
    double wtotal = 0;
    for (int i = 0; i < kWarpPhases; ++i) wtotal += wsum[i];
    const float tw = time_ms([&] { warp_launch(); });
    // the same launch with every probe column empty (-1): its launch,
    // set-up and finish alone
    int32_t* keep = d_probes;
    d_probes = d_no_probes;
    const float t0 = time_ms([&] { warp_launch(); });
    d_probes = keep;
    CK(cudaGetLastError());
    CK(cudaDeviceSynchronize());
    printf("warp plan: clusters of %d blocks of %d warps, %d columns a "
           "block, %d splits of %d rows: %.4f ms with marks (events, 50 "
           "launches; %.4f ms with every probe column empty), %d of %d "
           "results filled; mean a warp %.0f cycles\n",
           pl.cluster, pl.warps, pl.cols, pl.splits, pl.split_rows, tw, t0,
           filled, kQ * kN, wtotal / n_warps);
    for (int i = 0; i < kWarpPhases; ++i)
      printf("  %-28s %9.0f cycles  %5.1f%%\n", wnames[i],
             wsum[i] / n_warps, 100.0 * wsum[i] / wtotal);
    printf("  radix passes a block %.2f, candidates a block %.1f\n",
           wsum[kWarpPhases] / n_warps,
           wsum[kWarpPhases + 1] / fmax(wsum[kWarpPhases], 1.0));
  }
  return 0;
}
