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
// chip_smoke.py (a cold chunk of 128-256 clusters of 3 tiles of 128 rows,
// k = 16 f32, 26,112 bytes a cluster with its ids) a launch moves 3-7 MB,
// ~50-110 us at Gen5 x16's ~63 GB/s one way.
//
// Design. The (B, ...) array is one contiguous byte range in host memory
// and in the output, so the block boundaries do not change the work: the
// range is cut into pieces of 16 KB (256 threads x 4 x 16 bytes), and each
// block of threads takes pieces in a grid-stride loop. A thread streams its
// own 16-byte vectors of a piece into one of two shared-memory staging
// slots with cp.async.cg, issues the next piece's loads into the other slot
// before it waits for the current one, then writes the current slot out with
// 16-byte stores: the TPU kernel's two-slot pipeline, per thread, with up to
// two pieces in flight per block and one wave of blocks over the card. A
// thread reads back only what it loaded itself, so no barrier is needed.
// The bytes before the first 16-byte boundary of the source and after the
// last go through a byte-wise kernel; so does the whole range when source
// and destination differ in alignment mod 16 (a view at an odd offset). The
// launcher takes the device address of the source with
// cudaHostGetDevicePointer after cudaPointerGetAttributes confirms that it is
// page-locked host memory: a pageable pointer is refused, never copied
// another way. More bytes in flight per SM, or a TMA bulk copy
// (cp.async.bulk) into shared memory, are later work.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                       // 16-byte vectors a thread
constexpr int kPieceVecs = kThreads * kVecs;   // 16 KB a staging slot
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group (the newest) is pending.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void issue(uint4* slot, const uint4* src,
                                      int64_t piece, int64_t n_vec) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int64_t v = piece * kPieceVecs + i * kThreads + threadIdx.x;
    if (v < n_vec) cp_async16(slot + i * kThreads + threadIdx.x, src + v);
  }
}

__global__ void __launch_bounds__(kThreads)
    stage_vectors(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  int64_t n_vec) {
  __shared__ __align__(16) uint4 slots[2][kPieceVecs];
  const int64_t n_pieces = (n_vec + kPieceVecs - 1) / kPieceVecs;
  int64_t piece = blockIdx.x;
  if (piece >= n_pieces) return;
  int s = 0;
  issue(slots[0], src, piece, n_vec);
  cp_async_commit();
  for (; piece < n_pieces; piece += gridDim.x) {
    const int64_t next = piece + gridDim.x;
    if (next < n_pieces) issue(slots[s ^ 1], src, next, n_vec);
    cp_async_commit();  // an empty group at the end keeps the count uniform
    cp_async_wait_one();
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int64_t v = piece * kPieceVecs + i * kThreads + threadIdx.x;
      if (v < n_vec) dst[v] = slots[s][i * kThreads + threadIdx.x];
    }
    s ^= 1;
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

void launch_bytes(const unsigned char* src, unsigned char* dst, int64_t n,
                  cudaStream_t s) {
  if (n <= 0) return;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < grid_limit() ? want : grid_limit());
  stage_bytes<<<grid, kThreads, 0, s>>>(src, dst, n);
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
  if (attr.type != cudaMemoryTypeHost) return cudaErrorInvalidValue;
  void* mapped = nullptr;
  err = cudaHostGetDevicePointer(&mapped, const_cast<void*>(src), 0);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = int64_t(block_bytes) * int64_t(n_blocks);
  const unsigned char* in = static_cast<const unsigned char*>(mapped);
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
    const int64_t pieces = (n_vec + kPieceVecs - 1) / kPieceVecs;
    const int grid =
        static_cast<int>(pieces < grid_limit() ? pieces : grid_limit());
    stage_vectors<<<grid, kThreads, 0, s>>>(
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
