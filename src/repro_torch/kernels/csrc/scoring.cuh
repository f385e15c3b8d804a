// Shared Zen/Lwb/Upb scoring and running top-k merge for the Hopper search
// kernels: the CUDA counterpart of kernels/scoring.py (and of the JAX
// package's kernels/scoring.py). The flat scan (zen_topk.cu) and the
// clustered probe use the same estimator, the same id -1 mask and the same
// (distance, id) merge, so they cannot drift apart numerically.
//
// A candidate is one 64-bit key: the distance's float bits above a 32-bit
// tie word. Distances are >= +0.0 after sqrt(max(z2, 0)) + 0.0, and the
// bits of a non-negative float order like the float itself, so comparing
// keys as unsigned integers orders candidates ascending by (distance, tie)
// -- the order lax.top_k gives when the running best sits before newer
// candidates. The tie word is what "newer" means on each path: the row id
// in the flat scan (rows are visited in id order), the visit position
// (p * T + t) * rows + r in the clustered probe (tile ids are not sorted).
// An empty slot is (+inf, 0xffffffff), which sorts after every real row.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace zen {

enum Mode : int { kZen = 0, kLwb = 1, kUpb = 2 };

constexpr uint64_t kEmptyKey = (uint64_t(0x7f800000u) << 32) | 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

// Squared estimator from the full squared norms (altitude included), the
// dot over the first k-1 columns and the two altitudes; f32 throughout. The
// rounded intrinsics keep the compiler from contracting the expansion into
// an FMA, so each step rounds where the plain PyTorch version rounds.
__device__ __forceinline__ float estimate_sq(float nq, float nx, float dot,
                                             float qa, float xa, int mode) {
  float z2 = __fsub_rn(__fadd_rn(nq, nx), __fmul_rn(2.0f, dot));
  if (mode != kZen) {
    const float cross = __fmul_rn(__fmul_rn(2.0f, qa), xa);
    z2 = (mode == kLwb) ? __fsub_rn(z2, cross) : __fadd_rn(z2, cross);
  }
  return z2;
}

// The distance sqrt(max(z2, 0)); + 0.0f folds a -0.0 into +0.0, whose bits
// order correctly.
__device__ __forceinline__ float distance(float z2) {
  return __fadd_rn(sqrtf(fmaxf(z2, 0.0f)), 0.0f);
}

// A squared estimate above this bound cannot give a distance at or below
// d (sqrt is correctly rounded; the 2^-20 margin covers the rounding of
// d * d), so the sqrt and the key compare can be skipped.
__device__ __forceinline__ float squared_bound(float d) {
  return __fmul_rn(__fmul_rn(d, d), 1.0f + 0x1p-20f);
}

__device__ __forceinline__ int log2_pow2(int x) { return __ffs(x) - 1; }

// The key of a candidate; an invalid one (the -1 mask: padding, a
// tombstone, a row outside the range) is the empty key and never enters a
// result.
__device__ __forceinline__ uint64_t make_key(float d, bool valid,
                                             uint32_t tie) {
  if (!valid) return kEmptyKey;
  return (uint64_t(__float_as_uint(d)) << 32) | tie;
}

__device__ __forceinline__ float key_distance(uint64_t key) {
  return __uint_as_float(uint32_t(key >> 32));
}

__device__ __forceinline__ uint32_t key_tie(uint64_t key) {
  return uint32_t(key & 0xffffffffu);
}

// Sorts `nseg` segments of `p` keys each (p a power of two, segment s at
// a + s * stride) ascending with a bitonic network. Block-wide: every
// thread of the block calls it.
__device__ __forceinline__ void bitonic_sort_segments(uint64_t* a, int nseg,
                                                      int p, int stride) {
  const int half = p >> 1;
  const int shift = log2_pow2(max(half, 1));
  for (int size = 2; size <= p; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < nseg * half; t += blockDim.x) {
        const int seg = t >> shift, i = t & (half - 1);
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        uint64_t* s = a + seg * stride;
        const uint64_t x = s[lo], y = s[hi];
        const bool ascending = (lo & size) == 0;
        if ((x > y) == ascending) {
          s[lo] = y;
          s[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Merges sorted runs: for each of `nseg` segments, l (w keys, ascending)
// becomes the w smallest keys of l and b (b's first w keys, ascending).
// min(l[i], b[w-1-i]) holds those w keys as a bitonic sequence, which a
// half-cleaner cascade then sorts. Block-wide.
__device__ __forceinline__ void merge_sorted_segments(uint64_t* l,
                                                      int lstride,
                                                      const uint64_t* b,
                                                      int bstride, int nseg,
                                                      int w) {
  const int wshift = log2_pow2(w);
  for (int t = threadIdx.x; t < nseg * w; t += blockDim.x) {
    const int seg = t >> wshift, i = t & (w - 1);
    const uint64_t x = l[seg * lstride + i];
    const uint64_t y = b[seg * bstride + (w - 1 - i)];
    l[seg * lstride + i] = x < y ? x : y;
  }
  __syncthreads();
  const int half = w >> 1;
  const int hshift = log2_pow2(max(half, 1));
  for (int j = half; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < nseg * half; t += blockDim.x) {
      const int seg = t >> hshift, i = t & (half - 1);
      const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
      uint64_t* s = l + seg * lstride;
      const uint64_t x = s[lo], y = s[lo + j];
      if (x > y) {
        s[lo] = y;
        s[lo + j] = x;
      }
    }
    __syncthreads();
  }
}

// Bitonic sort of 32 keys held one a lane of one warp, by shuffles.
__device__ __forceinline__ void sort32(uint64_t& a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const uint64_t p = __shfl_xor_sync(~0u, a, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & size) == 0);
      a = keep_min ? (a < p ? a : p) : (a < p ? p : a);
    }
  }
}

// Bitonic sort of 64 keys held two a lane of one warp (elements lane and
// lane + 32), by shuffles.
__device__ __forceinline__ void sort64(uint64_t& a, uint64_t& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // elements lane and lane + 32, ascending
        const uint64_t x = a < b ? a : b, y = a < b ? b : a;
        a = x, b = y;
        continue;
      }
      const bool lower = (lane & j) == 0;
      const uint64_t pa = __shfl_xor_sync(~0u, a, j);
      const uint64_t pb = __shfl_xor_sync(~0u, b, j);
      const bool asc_a = (lane & size) == 0, asc_b = ((lane + 32) & size) == 0;
      a = (lower == asc_a) ? (a < pa ? a : pa) : (a < pa ? pa : a);
      b = (lower == asc_b) ? (b < pb ? b : pb) : (b < pb ? pb : b);
    }
  }
}

// One warp: the list (l0, l1) = elements lane and lane + 32 of w <= 64
// ascending keys (empty past w) becomes the w smallest of it and the
// ascending (b0, b1). min(l[i], b[w-1-i]) is bitonic, and a half-cleaner
// cascade of shuffles sorts it.
__device__ __forceinline__ void merge64(uint64_t& l0, uint64_t& l1,
                                        uint64_t b0, uint64_t b1, int w) {
  const int lane = threadIdx.x & 31;
  const int src = (w - 1 - lane) & 31;  // element i sits in lane i % 32
  const uint64_t r0 = __shfl_sync(~0u, b0, src);
  const uint64_t r1 = __shfl_sync(~0u, b1, src);
  if (lane < w) {
    const uint64_t y = w == 64 ? r1 : r0;  // b[w-1-lane]
    l0 = y < l0 ? y : l0;
  }
  if (lane + 32 < w && r0 < l1) l1 = r0;  // b[31-lane], w = 64
  if (w == 64 && l1 < l0) {
    const uint64_t x = l0;
    l0 = l1, l1 = x;
  }
  for (int j = min(w, 32) >> 1; j > 0; j >>= 1) {
    const bool lower = (lane & j) == 0;
    const uint64_t p0 = __shfl_xor_sync(~0u, l0, j);
    const uint64_t p1 = __shfl_xor_sync(~0u, l1, j);
    l0 = lower == (l0 < p0) ? l0 : p0;
    l1 = lower == (l1 < p1) ? l1 : p1;
  }
}

// Columns col .. col + 3 of a row in global memory, f32, through the
// read-only cache; zero past k. With kVec (k % 4 == 0 and the row on a
// boundary of 4 elements) the four are one 16-, 8- or 4-byte load.
template <typename T, bool kVec>
__device__ __forceinline__ void ldg4(const T* __restrict__ row, int col,
                                     int k, float (&v)[4]) {
  if constexpr (kVec) {
    if (col >= k) {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    } else if constexpr (sizeof(T) == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row + col));
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else if constexpr (sizeof(T) == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + col));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
      const char4 u = __ldg(reinterpret_cast<const char4*>(row + col));
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = col + j < k ? to_float(__ldg(row + col + j)) : 0.0f;
  }
}

// One warp: sorts the c <= 64 keys of buf (read as elements lane and
// lane + 32) and merges them into the list (l0, l1) of w <= 64 keys held
// as merge64 holds it.
__device__ __forceinline__ void flush64(uint64_t& l0, uint64_t& l1,
                                        const uint64_t* buf, int c, int w) {
  const int lane = threadIdx.x & 31;
  uint64_t a = lane < c ? buf[lane] : kEmptyKey;
  uint64_t b = lane + 32 < c ? buf[lane + 32] : kEmptyKey;
  if (c <= 32)
    sort32(a);  // b holds no key
  else
    sort64(a, b);
  if (__shfl_sync(~0u, l0, 0) == kEmptyKey) {  // an empty list: the keys
    l0 = lane < w ? a : kEmptyKey;
    l1 = lane + 32 < w ? b : kEmptyKey;
  } else {
    merge64(l0, l1, a, b, w);
  }
}

// Sum over the four lanes 4g .. 4g + 3 of a warp, transposed: each lane
// holds its partial sums a[0..3] of four rows, and lane 4g + c returns the
// total of row c, summed (a0 + a2) + (a1 + a3) over the lanes' partials in
// whichever lane it ends (float addition commutes), so a row's total does
// not depend on where the row lies.
__device__ __forceinline__ float sum4_transposed(const float (&a)[4]) {
  const int c = threadIdx.x & 3;
  const bool hi2 = c & 2, hi1 = c & 1;
  float s0 = hi2 ? a[2] : a[0], s1 = hi2 ? a[3] : a[1];
  const float o0 = hi2 ? a[0] : a[2], o1 = hi2 ? a[1] : a[3];
  s0 += __shfl_xor_sync(~0u, o0, 2);
  s1 += __shfl_xor_sync(~0u, o1, 2);
  const float keep = hi1 ? s1 : s0, send = hi1 ? s0 : s1;
  return keep + __shfl_xor_sync(~0u, send, 1);
}

}  // namespace zen
