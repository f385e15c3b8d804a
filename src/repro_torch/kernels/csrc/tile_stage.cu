// Host-to-device staging copy for Hopper (sm_90a): the tiered tile store's
// upload of packed inverted-list tiles.
//
// Replaces the Pallas TPU kernel repro/kernels/tile_stage.py::dma_copy_blocks
// (body _copy_kernel): a byte-for-byte copy of a (B, ...) block array from
// pinned host memory into a new device array. The TPU kernel walks the
// blocks in order with two VMEM slots and two DMA semaphores, so that block
// i+1's DMA is in flight while block i drains to the output.
//
// What bounds it on an H100: bytes over the host link. The source lives in
// page-locked host memory that the card addresses directly (zero-copy, under
// unified addressing), so every byte crosses PCIe once and is written to
// device memory once; there is no arithmetic. At the serving shape of
// chip_smoke.py (a cold chunk of 128 slots of 3 tiles of 128 rows, k = 16
// f32: 3,145,728 bytes of coordinates and 196,608 of ids, two launches)
// that is 53 us at Gen5 x16's 63 GB/s one way.
//
// What holds it back, as measured on the card (PERF.md): how fast the SMs
// read host memory is the host machine's, not the kernel's. On most
// machines measured their reads top out at 26-34 GB/s whatever keeps them
// in flight -- more blocks, 4 to 16 loads a thread, L2 fetch sizes, an L2
// bulk prefetch or 1-D TMA bulk copies into shared memory
// (probes/host_reads.cu) -- and on one they reached ~48 GB/s, while the
// copy engine reaches 41-55 GB/s on all. A dependent 16-byte host read
// takes ~1.25 us, so ~33 GB/s is ~41 KB in flight: a cap on the host
// reads outstanding from the SMs, not on what one kernel issues.
//
// Design. The (B, ...) array is one contiguous byte range in host memory
// and in the output, so the block boundaries do not change the work. Since
// a straight copy gains nothing from shared memory, each thread loads
// kUnroll 16-byte vectors straight into registers with ld.global.nc (8 in
// flight a thread, 32 KB a block), then stores them. Each load
// instruction of a warp covers 512 contiguous bytes. Blocks take steps of
// kThreads * kUnroll vectors in a grid-stride loop, and the grid is sized
// from n (one block per step, at most kBlocksPerSm per SM), so a chunk of
// any size starts on as many SMs as it has steps: a 3 MB upload is 96
// steps of 32 KB on 96 SMs, all requested at once. The bytes before the
// first 16-byte boundary of the source and after the last go through a
// byte-wise kernel; so does the whole range when source and destination
// differ in alignment mod 16 (a view at an odd offset). The launcher takes
// the device address of the source from cudaPointerGetAttributes, which
// also refuses anything but page-locked host memory: a pageable pointer is
// never copied another way. The address is not cached across launches:
// the check must run on every launch anyway (a cache keyed by the host
// address could outlive the pinned allocation it was taken from), and the
// one driver call is the whole host cost (PERF.md).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;                       // 16-byte loads a thread
constexpr int kStepVecs = kThreads * kUnroll;    // 32 KB a block step
constexpr int kBlocksPerSm = 2;

// A 16-byte load through the non-coherent path: the source is not written
// while the copy runs (the caller's contract).
__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    stage_vectors(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  int64_t n_vec) {
  const int64_t step = int64_t(gridDim.x) * kStepVecs;
  for (int64_t base = int64_t(blockIdx.x) * kStepVecs + threadIdx.x;
       base < n_vec; base += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t j = base + i * kThreads;
      if (j < n_vec) v[i] = load_nc(src + j);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t j = base + i * kThreads;
      if (j < n_vec) dst[j] = v[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    stage_bytes(const unsigned char* __restrict__ src,
                unsigned char* __restrict__ dst, int64_t n) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride)
    dst[i] = src[i];
}

int grid_limit() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms * kBlocksPerSm;
}

int blocks_for(int64_t units) {
  return static_cast<int>(units < grid_limit() ? units : grid_limit());
}

void launch_bytes(const unsigned char* src, unsigned char* dst, int64_t n,
                  cudaStream_t s) {
  if (n <= 0) return;
  stage_bytes<<<blocks_for((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      src, dst, n);
}

}  // namespace

extern "C" {

// Copies n_blocks * block_bytes bytes from `src`, which must be page-locked
// host memory the device can address (cudaHostAlloc / pinned tensors), to
// the device buffer `dst`, on `stream`. Returns the CUDA error code (0 on
// success); cudaErrorInvalidValue when `src` is not page-locked host memory.
int tile_stage_launch(const void* src, void* dst, long long block_bytes,
                      long long n_blocks, void* stream) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, src);
  if (err != cudaSuccess) return err;
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = int64_t(block_bytes) * int64_t(n_blocks);
  const unsigned char* in = static_cast<const unsigned char*>(attr.devicePointer);
  unsigned char* out = static_cast<unsigned char*>(dst);
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  if (((a ^ b) & 15) != 0) {  // no common 16-byte alignment: byte-wise
    launch_bytes(in, out, n, s);
    return cudaGetLastError();
  }
  int64_t head = static_cast<int64_t>((16 - (a & 15)) & 15);
  if (head > n) head = n;
  const int64_t n_vec = (n - head) / 16;
  const int64_t tail = head + n_vec * 16;
  launch_bytes(in, out, head, s);
  if (n_vec > 0) {
    stage_vectors<<<blocks_for((n_vec + kStepVecs - 1) / kStepVecs),
                    kThreads, 0, s>>>(
        reinterpret_cast<const uint4*>(in + head),
        reinterpret_cast<uint4*>(out + head), n_vec);
  }
  launch_bytes(in + tail, out + tail, n - tail, s);
  return cudaGetLastError();
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
