// Fills the shared memory of every SM with one byte, for tests that a kernel
// reads no shared memory it has not written: a kernel launched next on the
// same SMs finds that byte wherever it reads before it writes (0xff makes
// every f32 word a NaN). A plain-C shared library:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/smem_fill.so
//        src/repro_torch/kernels/probes/smem_fill.cu
//
// smem_fill_launch(byte, stream) fills on the current device and returns
// the launch's CUDA error code (0 on success).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void fill(uint32_t word, int bytes) {
  extern __shared__ uint4 smem[];
  const uint32_t base = uint32_t(__cvta_generic_to_shared(smem));
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(
                     base + 16 * i),
                 "r"(word)
                 : "memory");
}

}  // namespace

extern "C" int smem_fill_launch(int byte, void* stream) {
  int dev = 0, sms = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fill, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return int(e);
  // a block takes all of an SM's shared memory: several waves of blocks
  // reach every SM
  fill<<<4 * sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
      (byte & 0xff) * 0x01010101u, bytes);
  return int(cudaGetLastError());
}
