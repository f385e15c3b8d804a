// Pairwise squared Euclidean distances for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pdist.py::pdist_sq (body
// _pdist_kernel): (N, m) x (K, m), f32 or bf16 (cast to f32 on load) ->
// (N, K) f32, out[i][j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0).
//
// What bounds it on an H100: at the transform's shape (N = 1e6 rows, K = 16
// references, m = 256) the bytes, 1.09 GB of rows read and distances
// written (0.33 ms at 3.35 TB/s) against 8.4 GFLOP (0.13 ms at 67 TFLOP/s
// f32); at a square evaluation matrix (4,096 x 4,096 x 256) the 8.6 GFLOP,
// since both operands stay in L2. Design: dense_tile.cuh, with the dot as
// an FMA chain per chunk and both squared norms summed from the same staged
// tiles. The TPU wrapper pads K up to 128; here K <= 16 takes a 256 x 16
// tile, so the transform's 16 references cost no padded columns. f32 on the
// CUDA cores throughout: TF32 would break parity with the f32 reference.
#include "dense_tile.cuh"

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

}  // namespace

extern "C" {

// x (n, m) and y (k, m) contiguous, dtype 0 float32 or 1 bfloat16; out
// (n, k) float32. Returns the launch's CUDA error code (0 on success).
int pdist_sq_launch(const void* x, const void* y, int dtype, long long n,
                    long long k, int m, void* out, void* stream) {
  return dense::launch_dtype<SqEuclidean>(x, y, dtype, n, k, m, out, stream);
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
