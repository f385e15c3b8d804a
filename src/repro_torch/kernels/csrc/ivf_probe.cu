// Clustered (IVF) top-k probes for Hopper (sm_90a): scalar tiles and PQ codes.
//
// Replaces the Pallas TPU kernels repro/kernels/ivf_probe.py::ivf_probe
// (body _probe_kernel) and ::ivf_probe_pq (body _probe_pq_kernel). Each
// query q visits the T tiles of each cluster probes[q, p] it probes and
// keeps its n best rows, ascending by (distance, visit position), where the
// visit position of row r of tile t of probe column p is (p * T + t) * rows
// + r -- the order lax.top_k gives when the TPU kernel merges the running
// best before each new tile. A row whose id is -1 (padding or a tombstone,
// whose stale coordinates stay in place) is never a candidate; slots that
// the probed clusters cannot fill come back as (+inf, -1).
//   scalar  tiles (C*T, rows, k) f32/bf16/int8 (+ (C,) per-cluster f32
//           scales), the Zen/Lwb/Upb estimator of scoring.cuh, dequantised
//           to f32 right after the load and accumulated in f32;
//   pq      code tiles (C*T, rows, M) uint8 and one (M, 256) f32 table per
//           (query, probe column): sqrt(max(sum_m lut[m, code[m]], 0)),
//           summed over m in ascending order; the mode is in the table.
//
// What bounds it on an H100: bytes, and few of them. At the serving shape
// of chip_smoke.py (1e6 rows in 4,000 clusters of T = 3 tiles of 128 rows,
// Q = 64, P = 8, k = 16) the distinct probed clusters' ids and live rows
// are ~4 MB (~1.2 us at 3.35 TB/s; PQ: 4 code bytes a row plus 2 MB of
// tables) and the f32 operations are noise. This first version runs at
// ~5% of that bound (H100 80GB HBM3, 700 W; PERF.md): one wave of 512
// blocks, each bound by load latency, a barrier pair per 256-row chunk and
// one bitonic flush, not by bandwidth.
//
// Design. The TPU grid is (Q, P*T), one query a row, the running best
// carried in VMEM across the row's steps. Hopper blocks run in no order, and
// queries probe different clusters, so there is no shared tile to batch
// queries over. Two passes:
//   pass 1  one block per (query, probe column). The cluster's T tiles are
//           contiguous, so the block walks its T * rows rows 256 at a time,
//           one row a thread. A row whose key beats the list's n-th best
//           (as of the last flush) is appended to a buffer of `cap` keys;
//           when the next chunk might not fit, and at the end, the buffer
//           is bitonic-sorted and merged into the block's sorted list of w
//           keys. A squared-distance bound skips the sqrt for rows that
//           cannot enter. The block reads probes[q, p] itself (no scalar
//           prefetch) and, for int8, its cluster's one scale.
//   pass 2  one block per query merges its P lists, a group of lists at a
//           time (as many as fit shared memory beside the running best),
//           and writes the first n, looking the id of each visit position
//           up in tile_ids.
// Every width n and M the reference serves is served. The wrapper's
// planner (kernels/ivf_probe.py::probe_plan) gives w, cap = max(1024, w)
// (merge_sorted_segments reads w keys of the buffer), the shared bytes of
// both passes and pass 2's group. Lists too wide for shared memory (w >=
// 16,384) live in global memory: pass 1's in the partial output itself and
// the wrapper's scratch, pass 2's running best in scratch, with each list
// merged straight from partial. The PQ tables of the first m_smem
// subspaces sit in shared memory, the rest are read from the (Q, P, M,
// 256) tables in global memory (one (q, p) table is M KB, so it stays in
// L2).
// Keys carry the visit position, not the id, in their low word: ids in a
// tile are not ascending, so the id would break ties in the wrong order.
// The first version reads each row with plain loads, one row a thread;
// staging tiles through shared memory with TMA is later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scoring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 256;       // PQ table entries per subspace

// One (query, probe column) list: in shared memory, or in global memory
// when the plan says so; __syncthreads orders both for the block.
struct List {
  uint64_t* best;  // [w] ascending
  uint64_t* buf;   // [cap] unsorted candidates
  int* cnt;
  float* bound;    // squared_bound of the n-th best as of the last flush
  int w;
  int cap;
};

__device__ __forceinline__ void offer(const List& l, uint64_t key,
                                      int n_out) {
  if (key < l.best[n_out - 1]) l.buf[atomicAdd(l.cnt, 1)] = key;
}

// Sorts the `filled` buffered candidates, merges them into the list and
// empties the buffer. Block-wide; `filled` is block-uniform.
__device__ void flush(const List& l, int filled, int n_out) {
  int p = 1;
  while (p < filled) p <<= 1;
  const int fill = max(p, l.w);
  for (int i = threadIdx.x; i < fill; i += blockDim.x)
    if (i >= filled) l.buf[i] = zen::kEmptyKey;
  __syncthreads();
  zen::bitonic_sort_segments(l.buf, 1, p, l.cap);
  zen::merge_sorted_segments(l.best, l.w, l.buf, l.cap, 1, l.w);
  if (threadIdx.x == 0) {
    *l.cnt = 0;
    *l.bound = zen::squared_bound(zen::key_distance(l.best[n_out - 1]));
  }
  __syncthreads();
}

// After each chunk of rows: flush when the next chunk might not fit. The
// count is read by every thread between two barriers, so no thread
// appends again before all have read it.
__device__ __forceinline__ void end_chunk(const List& l, int n_out,
                                          bool last) {
  __syncthreads();
  const int filled = *l.cnt;
  __syncthreads();
  if (last ? filled > 0 : filled > l.cap - kThreads) flush(l, filled, n_out);
}

// The block's list: at the start of shared memory (the returned pointer
// is what follows it), or partial's slot and gscratch's row of this block
// (global_lists; the partial is then written in place).
__device__ __forceinline__ List init_list(unsigned char* smem, int w, int cap,
                                          bool global_lists,
                                          uint64_t* partial,
                                          uint64_t* gscratch,
                                          unsigned char** rest) {
  __shared__ int cnt;
  __shared__ float bound;
  List l;
  if (global_lists) {
    l.best = partial + int64_t(blockIdx.x) * w;
    l.buf = gscratch + int64_t(blockIdx.x) * cap;
    *rest = smem;
  } else {
    l.best = reinterpret_cast<uint64_t*>(smem);
    l.buf = l.best + w;
    *rest = reinterpret_cast<unsigned char*>(l.buf + cap);
  }
  l.cnt = &cnt;
  l.bound = &bound;
  l.w = w;
  l.cap = cap;
  for (int i = threadIdx.x; i < w; i += blockDim.x) l.best[i] = zen::kEmptyKey;
  if (threadIdx.x == 0) {
    cnt = 0;
    bound = __int_as_float(0x7f800000);  // +inf: every row is wanted
  }
  return l;
}

__device__ __forceinline__ void write_list(const List& l, bool global_lists,
                                           uint64_t* partial) {
  if (global_lists) return;  // the list is partial's slot already
  for (int i = threadIdx.x; i < l.w; i += blockDim.x)
    partial[int64_t(blockIdx.x) * l.w + i] = l.best[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ivf_probe_partial(const float* __restrict__ queries,
                      const T* __restrict__ tiles,
                      const int32_t* __restrict__ tile_ids,
                      const int32_t* __restrict__ probes,
                      const float* __restrict__ scales, int n_probe,
                      int n_clusters, int64_t cluster_rows, int k, int n_out,
                      int w, int cap, bool global_lists, int mode,
                      uint64_t* partial, uint64_t* gscratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const List l =
      init_list(smem, w, cap, global_lists, partial, gscratch, &rest);
  __shared__ float qn_s;
  const int q = blockIdx.x / n_probe, p = blockIdx.x - q * n_probe;
  const int c = probes[blockIdx.x];
  // the query: staged in shared memory, or read in place beside global
  // lists
  const float* qs = queries + int64_t(q) * k;
  if (!global_lists) {
    float* qsm = reinterpret_cast<float*>(rest);  // [k]
    for (int i = threadIdx.x; i < k; i += blockDim.x) qsm[i] = qs[i];
    qs = qsm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < k; ++i) s = fmaf(qs[i], qs[i], s);
    qn_s = s;
  }
  __syncthreads();
  if (c >= 0 && c < n_clusters) {  // block-uniform
    const float scale = scales != nullptr ? scales[c] : 1.0f;
    const float qn = qn_s, qa = qs[k - 1];
    const int64_t base = int64_t(c) * cluster_rows;
    const uint32_t pos0 = uint32_t(int64_t(p) * cluster_rows);
    for (int64_t j0 = 0; j0 < cluster_rows; j0 += kThreads) {
      const int64_t j = j0 + threadIdx.x;
      const int32_t id = j < cluster_rows ? tile_ids[base + j] : -1;
      if (id >= 0) {
        const T* x = tiles + (base + j) * k;
        float nx = 0.0f, dot = 0.0f;
        for (int i = 0; i < k - 1; ++i) {
          const float v = __fmul_rn(zen::to_float(x[i]), scale);
          nx = fmaf(v, v, nx);
          dot = fmaf(qs[i], v, dot);
        }
        const float xa = __fmul_rn(zen::to_float(x[k - 1]), scale);
        nx = fmaf(xa, xa, nx);
        const float z2 = zen::estimate_sq(qn, nx, dot, qa, xa, mode);
        if (z2 <= *l.bound) {
          const float d = zen::distance(z2);
          // an infinite distance never displaces an empty slot, as in
          // the reference's merge
          offer(l, zen::make_key(d, d < __int_as_float(0x7f800000),
                                 pos0 + uint32_t(j)),
                n_out);
        }
      }
      end_chunk(l, n_out, false);
    }
    end_chunk(l, n_out, true);
  }
  write_list(l, global_lists, partial);
}

__global__ void __launch_bounds__(kThreads)
    ivf_probe_pq_partial(const uint8_t* __restrict__ codes,
                         const int32_t* __restrict__ tile_ids,
                         const int32_t* __restrict__ probes,
                         const float* __restrict__ luts, int n_probe,
                         int n_clusters, int64_t cluster_rows, int m,
                         int m_smem, int n_out, int w, int cap,
                         bool global_lists, uint64_t* partial,
                         uint64_t* gscratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* rest;
  const List l =
      init_list(smem, w, cap, global_lists, partial, gscratch, &rest);
  float* lut = reinterpret_cast<float*>(rest);  // [m_smem][256]
  const int p = blockIdx.x % n_probe;
  const int c = probes[blockIdx.x];
  // the (q, p) table: luts is (Q, P, M, 256), so it is block blockIdx.x
  const float* src = luts + int64_t(blockIdx.x) * m * kEntries;
  for (int i = threadIdx.x; i < m_smem * kEntries; i += blockDim.x)
    lut[i] = src[i];
  __syncthreads();
  if (c >= 0 && c < n_clusters) {  // block-uniform
    const int64_t base = int64_t(c) * cluster_rows;
    const uint32_t pos0 = uint32_t(int64_t(p) * cluster_rows);
    for (int64_t j0 = 0; j0 < cluster_rows; j0 += kThreads) {
      const int64_t j = j0 + threadIdx.x;
      const int32_t id = j < cluster_rows ? tile_ids[base + j] : -1;
      if (id >= 0) {
        const uint8_t* code = codes + (base + j) * m;
        float z2 = 0.0f;  // summed over m in ascending order
        for (int i = 0; i < m_smem; ++i)
          z2 = __fadd_rn(z2, lut[i * kEntries + code[i]]);
        for (int i = m_smem; i < m; ++i)
          z2 = __fadd_rn(z2, __ldg(src + i * kEntries + code[i]));
        if (z2 <= *l.bound) {
          const float d = zen::distance(z2);
          offer(l, zen::make_key(d, d < __int_as_float(0x7f800000),
                                 pos0 + uint32_t(j)),
                n_out);
        }
      }
      end_chunk(l, n_out, false);
    }
    end_chunk(l, n_out, true);
  }
  write_list(l, global_lists, partial);
}

// One block per query: merge its P sorted lists into a running best and
// write the first n as (distance, id), the id looked up from the key's
// visit position. With merge_smem: `group` lists at a time in shared
// memory (a tree over the group, then into the running best). Without:
// the running best is the query's row of gscratch, and each list merges
// into it straight from partial.
__global__ void __launch_bounds__(kThreads)
    ivf_probe_merge(const uint64_t* __restrict__ partial,
                    const int32_t* __restrict__ tile_ids,
                    const int32_t* __restrict__ probes, int n_probe,
                    int64_t cluster_rows, int w, int group, bool in_smem,
                    int n_out, uint64_t* gscratch, float* __restrict__ out_d,
                    int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  uint64_t* best = in_smem ? reinterpret_cast<uint64_t*>(smem)
                           : gscratch + int64_t(q) * w;  // [w]
  uint64_t* lists = best + w;                             // [group][w]
  const uint64_t* src = partial + int64_t(q) * n_probe * w;
  const int wshift = zen::log2_pow2(w);
  for (int i = threadIdx.x; i < w; i += blockDim.x) best[i] = zen::kEmptyKey;
  __syncthreads();
  if (in_smem) {
    for (int g0 = 0; g0 < n_probe; g0 += group) {
      for (int t = threadIdx.x; t < group * w; t += blockDim.x)
        lists[t] = g0 + (t >> wshift) < n_probe ? src[int64_t(g0) * w + t]
                                                 : zen::kEmptyKey;
      __syncthreads();
      for (int stride = 1; stride < group; stride <<= 1)
        zen::merge_sorted_segments(lists, 2 * stride * w, lists + stride * w,
                                   2 * stride * w, group / (2 * stride), w);
      zen::merge_sorted_segments(best, w, lists, w, 1, w);
    }
  } else {
    for (int p = 0; p < n_probe; ++p)
      zen::merge_sorted_segments(best, w, src + int64_t(p) * w, w, 1, w);
  }
  for (int t = threadIdx.x; t < n_out; t += blockDim.x) {
    const uint64_t key = best[t];
    float d = __int_as_float(0x7f800000);
    int32_t id = -1;
    if (key != zen::kEmptyKey) {
      const int64_t pos = zen::key_tie(key);
      const int64_t pp = pos / cluster_rows;
      const int c = probes[int64_t(q) * n_probe + pp];
      id = tile_ids[int64_t(c) * cluster_rows + (pos - pp * cluster_rows)];
      d = zen::key_distance(key);
    }
    out_d[int64_t(q) * n_out + t] = d;
    out_i[int64_t(q) * n_out + t] = id;
  }
}

// The shared bytes pass 1's lists need (none when they are global).
size_t list_smem_bytes(int w, int cap, bool global_lists) {
  return global_lists ? 0 : sizeof(uint64_t) * (size_t(w) + cap);
}

cudaError_t launch_merge(const uint64_t* partial, const int32_t* tile_ids,
                         const int32_t* probes, int nq, int n_probe,
                         int64_t cluster_rows, int w, int group,
                         int merge_smem, int n_out, uint64_t* mscratch,
                         float* out_d, int32_t* out_i, cudaStream_t s) {
  const bool in_smem = merge_smem > 0;
  if (in_smem) {
    if (group < 1 ||
        size_t(merge_smem) < sizeof(uint64_t) * size_t(group + 1) * w)
      return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ivf_probe_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
        merge_smem);
    if (err != cudaSuccess) return err;
  } else if (mscratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  ivf_probe_merge<<<nq, kThreads, merge_smem, s>>>(
      partial, tile_ids, probes, n_probe, cluster_rows, w, group, in_smem,
      n_out, mscratch, out_d, out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial(int blocks, int smem, cudaStream_t s,
                           const float* queries, const void* tiles,
                           const int32_t* tile_ids, const int32_t* probes,
                           const float* scales, int n_probe, int n_clusters,
                           int64_t cluster_rows, int k, int n_out, int w,
                           int cap, bool global_lists, int mode,
                           uint64_t* partial, uint64_t* gscratch) {
  const size_t need = list_smem_bytes(w, cap, global_lists) +
                      (global_lists ? 0 : sizeof(float) * k);
  if (size_t(smem) < need || (global_lists && gscratch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_probe_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ivf_probe_partial<T><<<blocks, kThreads, smem, s>>>(
      queries, static_cast<const T*>(tiles), tile_ids, probes, scales,
      n_probe, n_clusters, cluster_rows, k, n_out, w, cap, global_lists, mode,
      partial, gscratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. scales (C,) may be null. probes is
// (nq, n_probe) int32, cluster_rows = T * rows. The plan (w, cap,
// global_lists, smem, group, merge_smem) comes from
// kernels/ivf_probe.py::probe_plan: partial holds nq * n_probe * w keys,
// gscratch (global_lists only) nq * n_probe * cap, mscratch (merge_smem 0
// only) nq * w. Returns the CUDA error code of the launches (0 on success).
int ivf_probe_launch(const void* queries, const void* tiles,
                     const void* tile_ids, const void* probes,
                     const void* scales, int dtype, int nq, int n_probe,
                     int n_clusters, long long cluster_rows, int k, int n_out,
                     int mode, int w, int cap, int global_lists, int smem,
                     int group, int merge_smem, void* partial, void* gscratch,
                     void* mscratch, void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = nq * n_probe;
  const float* q = static_cast<const float*>(queries);
  const int32_t* ids = static_cast<const int32_t*>(tile_ids);
  const int32_t* pr = static_cast<const int32_t*>(probes);
  const float* sc = static_cast<const float*>(scales);
  uint64_t* part = static_cast<uint64_t*>(partial);
  uint64_t* gs = static_cast<uint64_t*>(gscratch);
  const bool g = global_lists != 0;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_partial<float>(blocks, smem, s, q, tiles, ids, pr, sc,
                                  n_probe, n_clusters, cluster_rows, k, n_out,
                                  w, cap, g, mode, part, gs);
      break;
    case 1:
      err = launch_partial<__nv_bfloat16>(blocks, smem, s, q, tiles, ids, pr,
                                          sc, n_probe, n_clusters,
                                          cluster_rows, k, n_out, w, cap, g,
                                          mode, part, gs);
      break;
    case 2:
      err = launch_partial<int8_t>(blocks, smem, s, q, tiles, ids, pr, sc,
                                   n_probe, n_clusters, cluster_rows, k,
                                   n_out, w, cap, g, mode, part, gs);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(part, ids, pr, nq, n_probe, cluster_rows, w, group,
                          merge_smem, n_out,
                          static_cast<uint64_t*>(mscratch),
                          static_cast<float*>(out_d),
                          static_cast<int32_t*>(out_i), s));
}

// codes (C*T, rows, m) uint8, luts (nq, n_probe, m, 256) f32, the first
// m_smem subspaces' tables staged in shared memory; the rest as for
// ivf_probe_launch.
int ivf_probe_pq_launch(const void* codes, const void* tile_ids,
                        const void* probes, const void* luts, int nq,
                        int n_probe, int n_clusters, long long cluster_rows,
                        int m, int n_out, int w, int cap, int global_lists,
                        int smem, int m_smem, int group, int merge_smem,
                        void* partial, void* gscratch, void* mscratch,
                        void* out_d, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(tile_ids);
  const int32_t* pr = static_cast<const int32_t*>(probes);
  uint64_t* part = static_cast<uint64_t*>(partial);
  uint64_t* gs = static_cast<uint64_t*>(gscratch);
  const bool g = global_lists != 0;
  const size_t need = list_smem_bytes(w, cap, g) +
                      sizeof(float) * size_t(m_smem) * kEntries;
  if (m_smem < 0 || m_smem > m || size_t(smem) < need ||
      (g && gs == nullptr))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_probe_pq_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  ivf_probe_pq_partial<<<nq * n_probe, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(codes), ids, pr,
      static_cast<const float*>(luts), n_probe, n_clusters, cluster_rows, m,
      m_smem, n_out, w, cap, g, part, gs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(launch_merge(part, ids, pr, nq, n_probe, cluster_rows, w, group,
                          merge_smem, n_out,
                          static_cast<uint64_t*>(mscratch),
                          static_cast<float*>(out_d),
                          static_cast<int32_t*>(out_i), s));
}

const char* zen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
