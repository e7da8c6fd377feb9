// gather_distance: (B, d) queries, (n, d) rows stored fp32, bf16 or int8,
// (B, C) int32 ids -> (B, C) float32 distances, +inf where id < 0.
//
// Replaces the TPU kernel repro/kernels/gather_dist.py gather_distance
// (:255, pallas_call at :329) with its body _gather_dist_kernel (:230) ->
// blocked_gather_phase (:157) -> block_distance (:69), in its fp32, bf16 and
// int8 forms (the x.dtype branches at :295-310; int8 rides the gathered
// row_scale operand).
//
// Bound on an H100: bytes.  Each valid id pulls one d-element row from
// device memory for 2d flops (l2 at d = 128: 512 B fp32, 256 B bf16 or
// 128 B + a 4-byte scale int8, per 256 flops; at most 2 flop/B, far below
// the card's ~20 flop/B fp32 balance), so the least time is the gathered
// rows plus ids, norms, scales and outputs over 3.35 TB/s.  At the seed
// gather's shape (B = 4096, C = 8, d = 128) that is 2-6 us, close to what
// a launch and two dependent device-memory round trips take, so the design
// aims at as few round trips as possible; at large C (refine, the serving
// searches) it aims at enough bytes in flight to stream at the HBM rate.
//
// Design: one warp per query (or per span of a query's candidates), eight
// warps per CTA (fewer where eight queries overflow a CTA's shared memory,
// d > 7,264), no CTA barrier.  Each warp stages its own query in shared
// memory (__syncwarp only) and reduces ‖q‖² itself (warp_sq_norm).  The
// candidates go through group_row_distances (row_distance.cuh) in chunks of
// K = (32 / G) · U rows: G lanes per row (32 fp32, 16 bf16, 8 int8 at
// d = 128), U rows per group (8, 4, 2), so K = 8 at d = 128 and a seed
// gather's whole query is in flight at once.  A chunk's ids are loaded
// together, one load per row group (the first chunk's with the query), and
// each row's norm and int8 scale beside the row, so a chunk costs two round
// trips: its ids, then its rows.  (Loading the next chunk's ids before this
// chunk's rows made fp32 spill at the register cap and slowed fp32 at both
// timed shapes.)  The group's lane u writes row u's distance, K consecutive
// floats per chunk.  4 CTAs (32 warps) per SM hold all 4,096 warps of a
// seed gather on the 132 SMs at once (it caps the kernel at 64 registers a
// thread).  Where B alone gives fewer warps than the card holds, a query's
// candidates are split into spans of whole chunks, one warp each, so that
// every resident warp has rows in flight (B = 256, C = 512: 16 spans of 32
// rows a query).  The kernel is instantiated per storage type and per
// metric term (q·x, l1, chi2), so the unrolled row loops carry no metric
// test.  The layout of a launch (warps per CTA, warps the card holds) is
// worked out once per device, storage type, metric term and d and kept.
// As measured (PERF.md), at the seed gather's shape it takes about an empty
// launch at its grid (~2 us) plus its bytes plus the two round trips; at
// B = 256, C = 512, d = 256 it reaches 37-65% of the byte bound, each
// distinct row read once from device memory.
//
// Bits: every row keeps row_distance.cuh's element-to-lane split and xor
// tree, ‖q‖² keeps warp_sq_norm's order, and finish_distance and
// gathered_scale are shared, so no thread mapping changes an output bit.

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "row_distance.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 8;  // most warps per CTA, one query span each
constexpr int kGatherBlocksPerSM = 4;

// U: rows a group of lanes has in flight, 16 bytes each per lane.
template <typename T>
constexpr int kGatherRows = 2 * (int)sizeof(T);  // 8 fp32, 4 bf16, 2 int8

// Per-warp shared memory in floats: the query, rounded up to 16 bytes.
__host__ __device__ inline int gather_warp_words(int d) { return (d + 3) / 4 * 4; }

// Ids of chunk rows c0 + u·R + g (u < U) for the lanes of group g; -1 past
// `end`.  All G lanes of a group read the same id, the R groups R
// consecutive ids per load.
template <int U>
__device__ __forceinline__ void chunk_ids(const int* __restrict__ idx_row, int c0, int end,
                                          int R, int g, int (&ids)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + u * R + g;
    ids[u] = c < end ? __ldg(idx_row + c) : -1;
  }
}

template <typename T, int TERM>
__global__ void __launch_bounds__(kGatherWarps * 32, kGatherBlocksPerSM) gather_distance_kernel(
    const float* __restrict__ q, const T* __restrict__ x,
    const float* __restrict__ sq_norms, const float* __restrict__ row_scale,
    const int* __restrict__ idx, float* __restrict__ out, int B, int C, int d, int metric,
    bool vec, bool qvec, int G, int span, int splits) {
  constexpr int U = kGatherRows<T>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  const int b = w / splits;
  if (b >= B) return;  // whole warps only; no barrier follows
  const int begin = (w - b * splits) * span;
  const int end = min(C, begin + span);
  const int R = 32 / G;
  const int K = R * U;
  const int g = lane / G;
  const int gl = lane % G;
  const int* idx_row = idx + (int64_t)b * C;
  float* out_row = out + (int64_t)b * C;

  // ---- the first chunk's ids and the query, loaded together -------------
  int ids[U];
  chunk_ids<U>(idx_row, begin, end, R, g, ids);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4) + warp * gather_warp_words(d);
  if (qvec) {
    const float4* q4 = reinterpret_cast<const float4*>(q + (int64_t)b * d);
    for (int j = lane; j < d / 4; j += 32) reinterpret_cast<float4*>(qs)[j] = __ldg(q4 + j);
  } else {
    for (int j = lane; j < d; j += 32) qs[j] = q[(int64_t)b * d + j];
  }
  __syncwarp();
  const float qn = warp_sq_norm(qs, d);
  const float* qrow[U];
  float qnr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    qrow[u] = qs;
    qnr[u] = qn;
  }
  const bool needs_norm = metric == kL2 || metric == kCos;

  // ---- chunks of K rows: ids, then norms, scales and rows ----------------
  for (int c0 = begin; c0 < end; c0 += K) {
    if (c0 > begin) chunk_ids<U>(idx_row, c0, end, R, g, ids);
    float xn[U], xs[U], dist[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xn[u] = needs_norm && ids[u] >= 0 ? sq_norms[ids[u]] : 0.f;
      xs[u] = gathered_scale(row_scale, ids[u]);
    }
    group_row_distances<T, U, TERM>(metric, qrow, qnr, x, ids, d, xn, xs, vec, G, gl, dist);
    // lane gl of group g writes rows gl, gl + G, ... of its U
    for (int u0 = 0; u0 < U; u0 += G) {
      const int u = u0 + gl;
      float v = dist[0];
#pragma unroll
      for (int t = 1; t < U; ++t) v = u == t ? dist[t] : v;
      const int c = c0 + u * R + g;
      if (u < U && c < end) out_row[c] = v;
    }
  }
}

// The timing floor: an empty kernel at the gather's grid, block and shared
// memory.
__global__ void gather_floor_kernel() {}

// How a gather at width d is laid out on one device: warps per CTA, and the
// warps the card holds at once.
struct GatherPlan {
  int warps;
  int resident;
};

// The plan of gather_distance_kernel<T, TERM> at width d on the current
// device, worked out on its first launch there and kept.  Eight warps per
// CTA where eight queries fit the CTA's opt-in shared memory, fewer above
// d = 7,264, none (cudaErrorInvalidValue) where one query does not fit.
template <typename T, int TERM>
cudaError_t gather_plan(int d, GatherPlan* plan) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, GatherPlan> plans;  // (device, d)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto found = plans.find({device, d});
  if (found != plans.end()) {
    *plan = found->second;
    return cudaSuccess;
  }
  auto kernel = gather_distance_kernel<T, TERM>;
  int sms = 0, optin = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t per_warp = sizeof(float) * (size_t)gather_warp_words(d);
  const int warps = (int)std::min<size_t>(kGatherWarps, (size_t)optin / per_warp);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  // past 48 KB a launch needs the opt-in; allow all of it, so that every
  // plan kept for this device stays launchable
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (err != cudaSuccess) return err;
  *plan = {warps, sms * std::max(per_sm, 1) * warps};
  plans[{device, d}] = *plan;
  return cudaSuccess;
}

template <typename T, int TERM>
int launch(const void* q, const void* x, const void* sq_norms, const void* row_scale,
           const void* idx, void* out, int B, int C, int d, int metric, bool empty,
           cudaStream_t stream) {
  GatherPlan plan;
  cudaError_t err = gather_plan<T, TERM>(d, &plan);
  if (err != cudaSuccess) return (int)err;
  const bool vec = vec_loads<T>(x, d);
  const bool qvec = vec_loads<float>(q, d);
  const int G = row_group_lanes<T>(d, vec);
  const int K = 32 / G * kGatherRows<T>;
  const int threads = plan.warps * 32;
  const size_t smem = sizeof(float) * plan.warps * (size_t)gather_warp_words(d);
  // split each query's chunks over as many warps as it takes to give every
  // resident warp rows
  const int chunks = (C + K - 1) / K;
  int splits = B >= plan.resident ? 1 : std::min(chunks, (plan.resident + B - 1) / B);
  const int span = (chunks + splits - 1) / splits * K;
  splits = (C + span - 1) / span;
  const int64_t warps = (int64_t)B * splits;
  const int grid = (int)((warps + plan.warps - 1) / plan.warps);
  if (empty) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(gather_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    gather_floor_kernel<<<grid, threads, smem, stream>>>();
  } else {
    gather_distance_kernel<T, TERM><<<grid, threads, smem, stream>>>(
        (const float*)q, (const T*)x, (const float*)sq_norms, (const float*)row_scale,
        (const int*)idx, (float*)out, B, C, d, metric, vec, qvec, G, span, splits);
  }
  return (int)cudaSuccess;
}

int launch_any(const void* q, const void* x, const void* sq_norms, const void* row_scale,
               const void* idx, void* out, int B, int C, int d, int metric, int dtype,
               bool empty, cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
#define REPRO_GATHER_ARGS q, x, sq_norms, row_scale, idx, out, B, C, d, metric, empty, st
#define REPRO_GATHER_TERMS(T)                                               \
  switch (metric_term_kind(metric)) {                                        \
    case kTermDot: err = launch<T, kTermDot>(REPRO_GATHER_ARGS); break;      \
    case kTermL1: err = launch<T, kTermL1>(REPRO_GATHER_ARGS); break;        \
    case kTermChi2: err = launch<T, kTermChi2>(REPRO_GATHER_ARGS); break;    \
  }
  switch (dtype) {
    case kF32: REPRO_GATHER_TERMS(float) break;
    case kBF16: REPRO_GATHER_TERMS(__nv_bfloat16) break;
    case kI8: REPRO_GATHER_TERMS(int8_t) break;
  }
#undef REPRO_GATHER_TERMS
#undef REPRO_GATHER_ARGS
  return err;
}

}  // namespace repro_torch

// dtype: kF32, kBF16 or kI8 (row_distance.cuh); row_scale is the (n,) int8
// scale table, NULL for fp32 and bf16.
extern "C" int launch_gather_distance(
    const void* q, const void* x, const void* sq_norms, const void* row_scale,
    const void* idx, void* out, int B, int C, int d, int metric, int dtype, void* stream) {
  using namespace repro_torch;
  if (B > 0 && C > 0) {
    const int err = launch_any(q, x, sq_norms, dtype == kI8 ? row_scale : nullptr, idx, out,
                               B, C, d, metric, dtype, false, (cudaStream_t)stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched with the grid, block and shared memory that
// launch_gather_distance would use for these arguments.
extern "C" int launch_gather_floor(
    const void* q, const void* x, const void* sq_norms, const void* row_scale,
    const void* idx, void* out, int B, int C, int d, int metric, int dtype, void* stream) {
  using namespace repro_torch;
  if (B > 0 && C > 0) {
    const int err = launch_any(q, x, sq_norms, row_scale, idx, out, B, C, d, metric, dtype,
                               true, (cudaStream_t)stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
