// Probe of the host link as the SMs see it: how fast can a kernel read
// page-locked (zero-copy) host memory, against the copy engine?
//
// This is a measurement, not a kernel of the port: it explains the bound
// that csrc/tile_stage.cu (dma_copy_blocks) meets (PERF.md, section 6).
// It times, for 196,608 B (the tiered chunk's ids), 3,145,728 B (its
// coordinates) and 64 MB, a host-to-device cudaMemcpyAsync (the copy
// engine) against kernels that read the mapped host buffer: 16-byte
// ld.global.nc loads, 4 to 16 a thread, as contiguous block ranges or
// grid-stride steps, on 1 to 8 blocks an SM; the same with L2::128B and
// L2::256B fetch sizes and an L2 bulk prefetch; and 1-D TMA bulk copies
// (cp.async.bulk) through a 4-stage shared-memory ring. Every copy is
// checked byte for byte. It also times one dependent 16-byte host read.
// Each line: bytes, variant, ok/BAD, ms a copy, GB/s.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/host_reads src/repro_torch/kernels/probes/host_reads.cu
//   build/host_reads
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <vector>
#include <cuda_runtime.h>

#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("ERR %s at %d: %s\n", #x, __LINE__, cudaGetErrorString(e)); return 1; } } while (0)

template <int MODE>
__device__ __forceinline__ uint4 ld(const uint4* p) {
  uint4 v;
  if constexpr (MODE == 0)
    asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else if constexpr (MODE == 1)
    asm volatile("ld.global.nc.L2::128B.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else if constexpr (MODE == 2)
    asm volatile("ld.global.nc.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// each block a contiguous range; a warp instruction covers 512 contiguous B
template <int U>
__global__ void __launch_bounds__(256) copy_unroll(const uint4* __restrict__ src, uint4* __restrict__ dst, int64_t n_vec, int64_t per_block) {
  const int64_t b0 = int64_t(blockIdx.x) * per_block;
  const int64_t b1 = min(n_vec, b0 + per_block);
  for (int64_t base = b0; base < b1; base += int64_t(U) * 256) {
    uint4 v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int64_t j = base + i * 256 + threadIdx.x;
      if (j < b1) v[i] = ld<0>(src + j);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int64_t j = base + i * 256 + threadIdx.x;
      if (j < b1) dst[j] = v[i];
    }
  }
}

template <int U, int MODE>
__global__ void __launch_bounds__(256) copy_stride(const uint4* __restrict__ src, uint4* __restrict__ dst, int64_t n_vec) {
  const int64_t step = int64_t(gridDim.x) * 256 * U;
  for (int64_t base = int64_t(blockIdx.x) * 256 * U; base < n_vec; base += step) {
    uint4 v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) { const int64_t j = base + i * 256 + threadIdx.x; if (j < n_vec) v[i] = ld<MODE>(src + j); }
#pragma unroll
    for (int i = 0; i < U; ++i) { const int64_t j = base + i * 256 + threadIdx.x; if (j < n_vec) dst[j] = v[i]; }
  }
}

// bulk L2 prefetch of the block's next step while this one is loaded
template <int U>
__global__ void __launch_bounds__(256) copy_prefetch(const uint4* __restrict__ src, uint4* __restrict__ dst, int64_t n_vec) {
  const int64_t step = int64_t(gridDim.x) * 256 * U;
  const int64_t base0 = int64_t(blockIdx.x) * 256 * U;
  if (threadIdx.x == 0 && base0 < n_vec) {
    const int64_t nb = min(int64_t(256) * U, n_vec - base0) * 16;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" :: "l"(src + base0), "r"((int)nb) : "memory");
  }
  for (int64_t base = base0; base < n_vec; base += step) {
    if (threadIdx.x == 0 && base + step < n_vec) {
      const int64_t nb = min(int64_t(256) * U, n_vec - base - step) * 16;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" :: "l"(src + base + step), "r"((int)nb) : "memory");
    }
    uint4 v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) { const int64_t j = base + i * 256 + threadIdx.x; if (j < n_vec) v[i] = ld<0>(src + j); }
#pragma unroll
    for (int i = 0; i < U; ++i) { const int64_t j = base + i * 256 + threadIdx.x; if (j < n_vec) dst[j] = v[i]; }
  }
}

// TMA: one thread per block drives a ring of S stages of C bytes.
template <int S>
__global__ void __launch_bounds__(32) copy_tma(const unsigned char* src, unsigned char* dst, int64_t nbytes, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[S];
  if (threadIdx.x != 0) return;
  const int64_t n_chunks = (nbytes + chunk - 1) / chunk;
  for (int s = 0; s < S; ++s) {
    uint32_t a = (uint32_t)__cvta_generic_to_shared(&bar[s]);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(a));
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  int64_t c_issue = blockIdx.x, c_done = blockIdx.x;
  int phase[S];
  for (int s = 0; s < S; ++s) phase[s] = 0;
  int issued = 0, drained = 0;
  // prime
  for (int s = 0; s < S && c_issue < n_chunks; ++s, c_issue += gridDim.x, ++issued) {
    const int64_t off = c_issue * chunk;
    const int bytes = (int)(nbytes - off < chunk ? nbytes - off : chunk);
    uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[s]);
    uint32_t d = (uint32_t)__cvta_generic_to_shared(smem + s * chunk);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" :: "r"(d), "l"(src + off), "r"(bytes), "r"(b) : "memory");
  }
  while (drained < issued) {
    const int s = drained % S;
    uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[s]);
    uint32_t ok = 0;
    while (!ok) {
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }" : "=r"(ok) : "r"(b), "r"(phase[s]) : "memory");
    }
    phase[s] ^= 1;
    const int64_t off = c_done * chunk;
    const int bytes = (int)(nbytes - off < chunk ? nbytes - off : chunk);
    uint32_t sm = (uint32_t)__cvta_generic_to_shared(smem + s * chunk);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" :: "l"(dst + off), "r"(sm), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    c_done += gridDim.x; ++drained;
    if (c_issue < n_chunks) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // stage s free
      const int64_t off2 = c_issue * chunk;
      const int bytes2 = (int)(nbytes - off2 < chunk ? nbytes - off2 : chunk);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b), "r"(bytes2) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" :: "r"(sm), "l"(src + off2), "r"(bytes2), "r"(b) : "memory");
      c_issue += gridDim.x; ++issued;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void latency(const uint4* src, uint4* dst, long long* cyc, int reps) {
  uint4 acc = make_uint4(0,0,0,0);
  long long t0 = clock64();
  const uint4* p = src;
  for (int r = 0; r < reps; ++r) {
    uint4 v = ld<0>(p + (acc.x & 1) + r * 64);
    acc.x += v.x;
  }
  long long t1 = clock64();
  dst[0] = acc; cyc[0] = (t1 - t0) / reps;
}

int main() {
  int sms; CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  int clk; CK(cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0));
  const size_t maxb = 64ull << 20;
  unsigned char* h; CK(cudaHostAlloc(&h, maxb, cudaHostAllocDefault));
  for (size_t i = 0; i < maxb; ++i) h[i] = (unsigned char)(i * 2654435761u >> 13);
  unsigned char* hm; CK(cudaHostGetDevicePointer((void**)&hm, h, 0));
  unsigned char* d; CK(cudaMalloc(&d, maxb));
  std::vector<unsigned char> back(maxb);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  long long* cyc; CK(cudaMalloc(&cyc, 8));
  latency<<<1, 1>>>((const uint4*)hm, (uint4*)d, cyc, 64); CK(cudaDeviceSynchronize());
  long long c; CK(cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost));
  printf("device %d SMs at %d kHz; host %p mapped at %p\n", sms, clk, (void*)h, (void*)hm);
  printf("dependent 16 B host read: %lld cycles = %.2f us\n", c, c / (clk / 1e3));
  const size_t sizes[3] = {196608, 3145728, maxb};
  for (int pass = 0; pass < 2; ++pass) {  // TMA last: a refused address faults the context
    for (size_t nb : sizes) {
      const int64_t nv = nb / 16;
      auto run = [&](const char* name, auto fn) {
        CK(cudaMemset(d, 0, nb));
        fn(); CK(cudaGetLastError()); CK(cudaDeviceSynchronize());
        CK(cudaMemcpy(back.data(), d, nb, cudaMemcpyDeviceToHost));
        const bool same = memcmp(back.data(), h, nb) == 0;
        for (int w = 0; w < 3; ++w) fn();
        const int it = nb > 10000000 ? 5 : 50;
        cudaEventRecord(e0);
        for (int i = 0; i < it; ++i) fn();
        cudaEventRecord(e1); CK(cudaEventSynchronize(e1));
        float ms; cudaEventElapsedTime(&ms, e0, e1); ms /= it;
        printf("%9zu B %-30s %s %.4f ms %.1f GB/s\n", nb, name, same ? "ok " : "BAD", ms, nb / ms / 1e6);
        return 0;
      };
      const uint4* s = (const uint4*)hm; uint4* o = (uint4*)d;
      char nm[64];
      if (pass == 1) {
        for (int chunk : {4096, 16384}) {
          for (int grid : {sms, 2 * sms}) {
            snprintf(nm, 64, "tma S=4 chunk=%d grid=%d", chunk, grid);
            const int smem = 4 * chunk;
            cudaFuncSetAttribute(copy_tma<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            run(nm, [&] { copy_tma<4><<<grid, 32, smem>>>(hm, d, (int64_t)nb, chunk); });
          }
        }
        continue;
      }
      run("memcpyAsync", [&] { cudaMemcpyAsync(d, h, nb, cudaMemcpyHostToDevice, 0); });
      for (int mult : {1, 2, 4, 8}) {
        const int grid = sms * mult;
        const int64_t per = (nv + grid - 1) / grid;
        snprintf(nm, 64, "u8 contig grid=%d", grid); run(nm, [&] { copy_unroll<8><<<grid, 256>>>(s, o, nv, per); });
        snprintf(nm, 64, "u16 contig grid=%d", grid); run(nm, [&] { copy_unroll<16><<<grid, 256>>>(s, o, nv, per); });
        snprintf(nm, 64, "u4 stride grid=%d", grid); run(nm, [&] { copy_stride<4, 0><<<grid, 256>>>(s, o, nv); });
        snprintf(nm, 64, "u8 stride grid=%d", grid); run(nm, [&] { copy_stride<8, 0><<<grid, 256>>>(s, o, nv); });
      }
      for (int g : {2, 4}) {
        const int grid = g * sms;
        snprintf(nm, 64, "u8 L2::128B grid=%d", grid); run(nm, [&] { copy_stride<8, 1><<<grid, 256>>>(s, o, nv); });
        snprintf(nm, 64, "u8 L2::256B grid=%d", grid); run(nm, [&] { copy_stride<8, 2><<<grid, 256>>>(s, o, nv); });
        snprintf(nm, 64, "u8 noL1 L2::256B grid=%d", grid); run(nm, [&] { copy_stride<8, 3><<<grid, 256>>>(s, o, nv); });
        snprintf(nm, 64, "u8 bulk prefetch grid=%d", grid); run(nm, [&] { copy_prefetch<8><<<grid, 256>>>(s, o, nv); });
      }
    }
  }
  printf("done\n");
  return 0;
}
