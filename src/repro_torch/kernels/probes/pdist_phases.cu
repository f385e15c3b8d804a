// Probe of where pdist_sq spends its time at the shapes the paper's
// evaluation launches (2,048 x 2,048 x 256 and 2,048 x 2,048 x 16, f32).
//
// This is a measurement, not a kernel of the port: it explains the design
// of csrc/pdist.cu (PERF.md, section 6). Part 1 is the SIMT square tile
// (csrc/dense_tile.cuh, 64 x 64 outputs a block, 4 x 4 a thread, f32 FMAs,
// 32 feature columns staged a step), the design before the MMA plan and
// still the plan of unaligned operands: a copy of its kernel with clock64()
// marks at its barriers, read by lane 0 of every warp. Each step splits
// into staging (global loads and transposed shared stores), the wait at the
// barrier after it, the row-norm loops (warps 0 and 1), the 4 x 4 FMA loop,
// and the wait at the barrier after the step; then the epilogue (row terms
// through shared memory, finish, the stores). It prints the mean cycles a
// warp spends in each, and the unmarked kernel's time by CUDA events over
// 50 launches. Part 2 is the MMA plan, csrc/pdist.cu itself compiled with
// its phase marks: lane 0 of every warp splits the warp's time into the
// set-up (the first stage landed and prepared), each stage's wgmma issue
// with the next stage's row norms and split between its k-steps, the end of
// that preparation (A fragments, proxy fence), the wgmma wait and the
// total's add, the block barrier with the stage's refill, and each tile's
// epilogue (the finish into the output boxes; the proxy fence and TMA
// stores). It runs the plan pdist_plan gives in f32 (132 blocks, 3 stages,
// one output tile) and prints the mean cycles a warp and the marked
// kernel's time by events.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/pdist_phases src/repro_torch/kernels/probes/pdist_phases.cu
//   build/pdist_phases
#include <cstdint>
#include <cstdio>
#include <vector>

#include <cuda_runtime.h>

// The MMA plan's warps mark seven phases; lane 0 of each warp writes its
// sums when the block ends.
#define PDIST_PROBE
constexpr int kMmaPhases = 7;
__device__ long long g_mma_probe[132 * 8][kMmaPhases];
#define PDIST_PROBE_START()                               \
  long long pp_t = clock64(), pp_acc[kMmaPhases] = {0, 0, 0, 0, 0, 0, 0}
#define PDIST_PROBE_MARK(p)             \
  do {                                  \
    const long long pp_now = clock64(); \
    pp_acc[p] += pp_now - pp_t;         \
    pp_t = pp_now;                      \
  } while (0)
#define PDIST_PROBE_END()                                         \
  do {                                                            \
    if (lane == 0 && blockIdx.x < 132)                            \
      for (int i = 0; i < kMmaPhases; ++i)                        \
        g_mma_probe[blockIdx.x * 8 + warp][i] = pp_acc[i];        \
  } while (0)
#include "../csrc/pdist.cu"

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e = (x);                                               \
    if (e != cudaSuccess) {                                            \
      printf("ERR %s at %d: %s\n", #x, __LINE__, cudaGetErrorString(e)); \
      return 1;                                                        \
    }                                                                  \
  } while (0)

namespace simt_probe {

constexpr int kPhases = 6;
const char* kPhaseNames[kPhases] = {
    "staging (global loads + transposed shared stores)",
    "barrier after staging",
    "row-norm loops",
    "4 x 4 FMA loop + chunk add",
    "barrier after the step",
    "epilogue (row terms, finish, stores)"};

using dense::kChunk;
using dense::kMicro;
using dense::kPad;
using dense::kThreads;

// dense::dense_tile<SqEuclidean, float, 64, 64, true>, with marks.
__global__ void __launch_bounds__(kThreads)
    marked_tile(const float* __restrict__ x, const float* __restrict__ y,
                int64_t n, int64_t k, int m, float* __restrict__ out,
                long long* __restrict__ cycles) {
  constexpr int BN = 64, BK = 64;
  constexpr int TX = BK / kMicro;
  __shared__ __align__(16) float xs[kChunk][BN + kPad];
  __shared__ __align__(16) float ys[kChunk][BK + kPad];
  __shared__ float xterm[BN];
  __shared__ float yterm[BK];
  long long acc_t[kPhases] = {0, 0, 0, 0, 0, 0};
  long long t = clock64();
  auto mark = [&](int p) {
    const long long now = clock64();
    acc_t[p] += now - t;
    t = now;
  };

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int64_t r0 = int64_t(blockIdx.x) * BN;
  const int64_t c0 = int64_t(blockIdx.y) * BK;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  float xsum = 0.0f, ysum = 0.0f;

  for (int l0 = 0; l0 < m; l0 += kChunk) {
    dense::stage<float, BN, true>(xs, x, r0, n, m, l0);
    dense::stage<float, BK, true>(ys, y, c0, k, m, l0);
    mark(0);
    __syncthreads();
    mark(1);
    if (threadIdx.x < BN) {
      float s = 0.0f;
#pragma unroll 8
      for (int l = 0; l < kChunk; ++l) s = fmaf(xs[l][threadIdx.x],
                                                xs[l][threadIdx.x], s);
      xsum = __fadd_rn(xsum, s);
    }
    if (threadIdx.x < BK) {
      float s = 0.0f;
#pragma unroll 8
      for (int l = 0; l < kChunk; ++l) s = fmaf(ys[l][threadIdx.x],
                                                ys[l][threadIdx.x], s);
      ysum = __fadd_rn(ysum, s);
    }
    mark(2);
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
          part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    mark(3);
    __syncthreads();
    mark(4);
  }
  if (threadIdx.x < BN) xterm[threadIdx.x] = xsum;
  if (threadIdx.x < BK) yterm[threadIdx.x] = ysum;
  __syncthreads();
  const int c = tx * 4;
  const bool whole = (k & 3) == 0 && c0 + c + 3 < k;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = ty * 4 + i;
    if (r0 + r >= n) continue;
    float o[kMicro];
#pragma unroll
    for (int j = 0; j < kMicro; ++j)
      o[j] = SqEuclidean::finish(xterm[r], yterm[c + j], acc[i][j]);
    float* row = out + (r0 + r) * k + c0 + c;
    if (whole) {
      *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        if (c0 + c + j < k) row[j] = o[j];
    }
  }
  mark(5);
  if ((threadIdx.x & 31) == 0) {
    long long* o = cycles + ((int64_t(blockIdx.y) * gridDim.x + blockIdx.x) *
                                 (kThreads / 32) +
                             threadIdx.x / 32) *
                                kPhases;
    for (int p = 0; p < kPhases; ++p) o[p] = acc_t[p];
  }
}

// Gaussian-like values from a hash: no host generator is needed.
__global__ void fill(float* p, int64_t count, uint32_t seed) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < count;
       i += int64_t(gridDim.x) * blockDim.x) {
    uint32_t h = uint32_t(i) * 2654435761u ^ seed;
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    float s = 0.0f;
    for (int j = 0; j < 4; ++j) {
      h = h * 1664525u + 1013904223u;
      s += float(h >> 8) * (1.0f / 16777216.0f);
    }
    p[i] = (s - 2.0f) * 1.7320508f;
  }
}

int run_shape(int n, int k, int m) {
  float *x, *y, *out;
  long long* cycles;
  const dim3 grid((n + 63) / 64, (k + 63) / 64);
  const int warps = int(grid.x * grid.y) * (kThreads / 32);
  CK(cudaMalloc(&x, sizeof(float) * n * m));
  CK(cudaMalloc(&y, sizeof(float) * k * m));
  CK(cudaMalloc(&out, sizeof(float) * n * k));
  CK(cudaMalloc(&cycles, sizeof(long long) * warps * kPhases));
  fill<<<264, 256>>>(x, int64_t(n) * m, 1u);
  fill<<<264, 256>>>(y, int64_t(k) * m, 2u);
  CK(cudaDeviceSynchronize());

  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  const int iters = 50;
  float ms_plain = 0.0f, ms_marked = 0.0f;
  for (int rep = 0; rep < 2; ++rep) {
    for (int i = 0; i < 3; ++i)
      CK(cudaError_t(pdist_sq_launch(x, y, 0, n, k, m, 0, 0, 0, 0, out,
                                     nullptr)));
    CK(cudaEventRecord(a));
    for (int i = 0; i < iters; ++i)
      pdist_sq_launch(x, y, 0, n, k, m, 0, 0, 0, 0, out, nullptr);
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    CK(cudaEventElapsedTime(&ms_plain, a, b));
    CK(cudaEventRecord(a));
    for (int i = 0; i < iters; ++i)
      marked_tile<<<grid, kThreads>>>(x, y, n, k, m, out, cycles);
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    CK(cudaGetLastError());
    CK(cudaEventElapsedTime(&ms_marked, a, b));
  }
  std::vector<long long> h(size_t(warps) * kPhases);
  CK(cudaMemcpy(h.data(), cycles, sizeof(long long) * h.size(),
                cudaMemcpyDeviceToHost));
  double sum[kPhases] = {0, 0, 0, 0, 0, 0}, total = 0;
  for (int w = 0; w < warps; ++w)
    for (int p = 0; p < kPhases; ++p) sum[p] += double(h[size_t(w) * kPhases + p]);
  for (int p = 0; p < kPhases; ++p) total += sum[p];
  printf("SIMT square tile, %d x %d x %d f32: grid %u x %u blocks of %d "
         "threads, %d chunks of %d columns; kernel %.4f ms unmarked, %.4f ms "
         "marked (events, %d launches)\n",
         n, k, m, grid.x, grid.y, kThreads, (m + kChunk - 1) / kChunk, kChunk,
         ms_plain / iters, ms_marked / iters, iters);
  printf("  cycles a warp (mean over %d warps): %.0f\n", warps, total / warps);
  for (int p = 0; p < kPhases; ++p)
    printf("    %-52s %9.0f  %5.1f%%\n", kPhaseNames[p], sum[p] / warps,
           100.0 * sum[p] / total);
  CK(cudaFree(x));
  CK(cudaFree(y));
  CK(cudaFree(out));
  CK(cudaFree(cycles));
  return 0;
}

}  // namespace simt_probe

namespace mma_probe {

const char* kPhaseNames[kMmaPhases] = {
    "set-up: the first stage landed and prepared",
    "wgmma issue, the next stage's norms and split between k-steps",
    "next stage: norm shuffles, A fragments, proxy fence",
    "wgmma wait + total add (+ norms out, box free)",
    "block barrier + stage refill",
    "epilogue: finish into the output boxes",
    "epilogue: proxy fence + TMA stores"};

int run_shape(int n, int k, int m) {
  float *x, *y, *out;
  CK(cudaMalloc(&x, sizeof(float) * n * m));
  CK(cudaMalloc(&y, sizeof(float) * k * m));
  CK(cudaMalloc(&out, sizeof(float) * n * k));
  simt_probe::fill<<<264, 256>>>(x, int64_t(n) * m, 1u);
  simt_probe::fill<<<264, 256>>>(y, int64_t(k) * m, 2u);
  CK(cudaDeviceSynchronize());
  const long long tiles = ((n + 127) / 128) * ((k + 127) / 128);
  // the plan pdist_plan gives in f32: 3 stages, one output tile
  const int chunks = (m + 31) / 32;
  const int grid = int(tiles < 132 ? tiles : 132);
  const int stages = 3;
  const int smem = int(mma::smem_bytes(mma::stage_bytes<float>(), stages));
  cudaEvent_t a, b;
  CK(cudaEventCreate(&a));
  CK(cudaEventCreate(&b));
  const int iters = 50;
  float ms = 0.0f;
  for (int rep = 0; rep < 2; ++rep) {
    CK(cudaError_t(pdist_sq_launch(x, y, 0, n, k, m, 1, grid, stages, smem,
                                   out, nullptr)));
    CK(cudaEventRecord(a));
    for (int i = 0; i < iters; ++i)
      pdist_sq_launch(x, y, 0, n, k, m, 1, grid, stages, smem, out,
                      nullptr);
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    CK(cudaGetLastError());
    CK(cudaEventElapsedTime(&ms, a, b));
  }
  long long h[132 * 8][kMmaPhases];
  CK(cudaMemcpyFromSymbol(h, g_mma_probe, sizeof(h)));
  const int warps = grid * 8;
  double sum[kMmaPhases] = {0, 0, 0, 0, 0, 0, 0}, total = 0;
  for (int w = 0; w < warps; ++w)
    for (int p = 0; p < kMmaPhases; ++p) sum[p] += double(h[w][p]);
  for (int p = 0; p < kMmaPhases; ++p) total += sum[p];
  printf("MMA plan, %d x %d x %d f32: %d blocks of %d threads, %lld tiles "
         "of 128 x 128 (%.2f a block), %d stages of 32 columns a tile, %d "
         "ring stages, %d B; kernel %.4f ms marked (events, %d launches)\n",
         n, k, m, grid, mma::kThreads, tiles, double(tiles) / grid, chunks,
         stages, smem, ms / iters, iters);
  printf("  cycles a warp (mean over %d warps, last launch): %.0f\n",
         warps, total / warps);
  for (int p = 0; p < kMmaPhases; ++p)
    printf("    %-62s %9.0f  %5.1f%%\n", kPhaseNames[p], sum[p] / warps,
           100.0 * sum[p] / total);
  CK(cudaFree(x));
  CK(cudaFree(y));
  CK(cudaFree(out));
  return 0;
}

}  // namespace mma_probe

// The card's name and power limit as nvidia-smi prints them.
void print_card() {
  FILE* p = popen(
      "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader", "r");
  char line[256];
  if (p != nullptr && fgets(line, sizeof line, p) != nullptr)
    printf("%s", line);
  if (p != nullptr) pclose(p);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    printf("no CUDA device\n");
    return 1;
  }
  print_card();
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  if (simt_probe::run_shape(2048, 2048, 256)) return 1;
  if (simt_probe::run_shape(2048, 2048, 16)) return 1;
  if (mma_probe::run_shape(2048, 2048, 256)) return 1;
  if (mma_probe::run_shape(2048, 2048, 16)) return 1;
  return 0;
}
