// Pairwise Jensen-Shannon distances for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/jsd.py::jsd_pdist (body
// _jsd_kernel): l1-normalised rows (N, m) x (K, m), f32 or bf16 (cast to
// f32 on load) -> (N, K) f32,
//   D = sqrt(clip(1 - 0.5 * sum_l [h(v_l) + h(w_l) - h(v_l + w_l)], 0, 1)),
//   h(t) = -t log2(t), h(0) = 0.
// The clip to [0, 1] is the TPU kernel's (jsd.py:62); core/metrics.py's
// jsd_pdist clamps at 0 only, and the two stay as they are.
//
// What bounds it on an H100: the cross term sum_l h(v_l + w_l) has no matmul
// form, so every (i, j, l) costs one log2 on the special-function units, 16
// a clock per SM: 4,096 x 4,096 x 256 is 4.3e9 of them, ~1 ms at the SM
// clock of 1,980 MHz. Design: dense_tile.cuh, each thread owning a 4 x 4
// micro-tile of outputs and looping over the staged chunks of both operands;
// the row entropies come from the same staged tiles. Each product is
// rounded on its own (__fmul_rn, not contracted into the sum), as the plain
// version rounds.
//
// The logarithm is __log2f, the special-function unit's lg2.approx, not the
// accurate log2f (no -use_fast_math otherwise): the accurate one costs a
// long instruction sequence per (i, j, l) on the FP32 pipe, which bounds
// the kernel instead of the units. The tolerance still holds. lg2.approx
// is within 2^-22.6 absolute of log2(t) for t in [0.5, 2] and within 2 ulp
// elsewhere; every t = v_l + w_l here lies in (0, 2], so each term
// t log2(t) is off by at most ~2^-22 t, and a sum over the m terms of two
// l1-normalised rows (sum t = 2) by at most ~5e-7: K = D^2 moves by
// < 3e-7, against the 1e-5 (repro_torch.testing.JSD_KTOL) that it is held
// to against the plain version.
#include "dense_tile.cuh"

namespace {

__device__ __forceinline__ float entropy_term(float t) {
  return t > 0.0f ? __fmul_rn(-t, __log2f(t)) : 0.0f;
}

struct JensenShannon {
  __device__ __forceinline__ static float self(float v, float s) {
    return __fadd_rn(s, entropy_term(v));
  }
  __device__ __forceinline__ static float pair(float a, float b, float s) {
    return __fadd_rn(s, entropy_term(__fadd_rn(a, b)));
  }
  // K = 1 - 0.5 * ((h(v) + h(w)) - cross), then sqrt(clip(K, 0, 1)).
  __device__ __forceinline__ static float finish(float hx, float hy,
                                                 float cross) {
    const float kk =
        __fsub_rn(1.0f, __fmul_rn(0.5f, __fsub_rn(__fadd_rn(hx, hy), cross)));
    return sqrtf(fminf(fmaxf(kk, 0.0f), 1.0f));
  }
};

}  // namespace

extern "C" {

// x (n, m) and y (k, m) contiguous l1-normalised rows, dtype 0 float32 or
// 1 bfloat16; out (n, k) float32. Returns the launch's CUDA error code.
int jsd_pdist_launch(const void* x, const void* y, int dtype, long long n,
                     long long k, int m, void* out, void* stream) {
  return dense::launch_dtype<JensenShannon>(x, y, dtype, n, k, m, out,
                                            stream);
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
