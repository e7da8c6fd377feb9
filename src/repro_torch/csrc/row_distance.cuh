// Candidate-row distance shared by the gather-distance and fused-expansion
// kernels: the CUDA counterpart of repro/kernels/gather_dist.py
// block_distance (:69), which blocked_gather_phase (:157) shares between
// _gather_dist_kernel and _fused_expand_kernel.  Keeping one arithmetic keeps
// the two kernels' distances identical per comparison, as in the reference.
//
// The element-to-lane split (group_row_distances).  A row is read by a
// group of G lanes, G = the lanes the split needs rounded up to a power of
// two (row_group_lanes: 32 for fp32 at d = 128, 16 for bf16, 8 for int8), so
// a warp holds 32 / G rows at once and each lane U of them, with their
// 16-byte loads issued before any term is summed.  Lane j of a group reads
// 16-byte slices j, j + G, ... of the row (4 fp32, 8 bf16 or 16 int8
// values) where d and alignment allow, else single elements, and adds
// their terms in order, one __fadd_rn at a time; the group's partial sums
// are then reduced by an xor-shuffle tree over offsets G/2 .. 1.  The row
// may be stored fp32, bf16 or int8 (the reference's reduced-precision tiles,
// gather_dist.py:295-310); it is widened to fp32 and accumulated in fp32.
//
// The bits do not depend on G.  With G = 32 a row is one warp and the tree
// has 32 lanes; with G < 32 slice j still goes to lane j of its group, and
// the lanes a 32-lane split would add hold exact +0
// (a running sum that starts at +0 never becomes -0), so the 32-lane tree's
// first steps (offsets 16 .. G) add +0 to every lane the G-lane tree keeps,
// and its last steps are that tree's.  Both kernels read their rows this
// way, so gather_distance and fused_expand give identical distances per
// comparison, and no change of G, U or warps per row moves an output bit.
// In the expansion at chip_smoke.py's synthetic state and in the gather at
// large C, these row reads are what bounds the kernel.
//
// The formula is block_distance's:
//   l2   max(‖q‖² + ‖x‖² − 2 q·x, 0), ‖x‖² from the graph's sq_norms cache
//   ip   −q·x
//   cos  1 − q·x / max(√‖x‖², 1e-12), q normalized by the wrapper
//   dot  q·x
//   l1   Σ |x − q|
//   chi2 Σ (x − q)² / (x + q), 0 where x + q <= 1e-12
// and an id < 0 (padding) gives +inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

enum Metric : int { kL2 = 0, kIP = 1, kCos = 2, kDot = 3, kL1 = 4, kChi2 = 5 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The same tree over aligned groups of G lanes (G a power of two <= 32):
// offsets G/2 .. 1, every lane of the warp taking part.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One element's term.  The dot product's multiply and the running sum
// (group_row_distances) are rounded one by one (__fmul_rn, __fadd_rn), never
// contracted into an FMA: whether nvcc contracts depends on how it
// specializes the metric switch, and the kernels' results must not.
__device__ __forceinline__ float metric_term(int metric, float qv, float xv) {
  if (metric == kL1) return fabsf(xv - qv);
  if (metric == kChi2) {
    const float diff = xv - qv;
    const float den = xv + qv;
    return den > 1e-12f ? diff * diff / fmaxf(den, 1e-12f) : 0.f;
  }
  return __fmul_rn(qv, xv);
}

// Squared norm of the query held in shared memory; every lane of the calling
// warp gets the same value.
__device__ __forceinline__ float warp_sq_norm(const float* q, int d) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int j = lane; j < d; j += 32) acc += q[j] * q[j];
  return warp_sum(acc);
}

// Storage types of the candidate table: float, __nv_bfloat16 or int8_t,
// widened to float only through the intrinsics.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

// Elements of T in one 16-byte load: 4 float, 8 bf16, 16 int8.
template <typename T>
constexpr int kVecElems = 16 / (int)sizeof(T);

// Per-row int8 dequantization scale of row `id`: the graph's row_scale, 1
// at padding and where the scale is <= 0 (gathered_row_scales,
// gather_dist.py:144).  fp32 and bf16 tables take no scale.
__device__ __forceinline__ float gathered_scale(const float* __restrict__ row_scale, int id) {
  if (row_scale == nullptr || id < 0) return 1.f;
  const float s = row_scale[id];
  return s > 0.f ? s : 1.f;
}

// A row's distance from its reduced sum s: the int8 scale on the dot sum
// (l2/ip/cos), then the metric's formula.
template <typename T>
__device__ __forceinline__ float finish_distance(int metric, float s, float qn, float xn,
                                                 float xscale) {
  if (std::is_same<T, int8_t>::value && metric != kL1 && metric != kChi2) {
    s = __fmul_rn(s, xscale);
  }
  switch (metric) {
    // _rn intrinsics: two roundings, as the plain version, never an FMA
    case kL2: return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, s)), 0.f);
    case kIP: return -s;
    case kCos: return 1.f - s / fmaxf(sqrtf(xn), 1e-12f);
    default: return s;  // dot, l1, chi2
  }
}

// The per-element term a metric sums: q·x for l2, ip, cos and dot, or the
// l1 or chi2 term.
enum Term : int { kTermDot = 0, kTermL1 = 1, kTermChi2 = 2 };

__host__ __device__ constexpr int metric_term_kind(int metric) {
  return metric == kL1 ? kTermL1 : metric == kChi2 ? kTermChi2 : kTermDot;
}

// Distances of U rows per group of G lanes (see the header): row ids[u] of
// x (n, d) stored as T against query q[u] (shared memory, 16-byte aligned)
// with ‖q‖² qn[u] and the row's ‖x‖² xn[u].  Lane `gl` of its group takes
// slices gl, gl + G, ... of each of its rows (id < 0: no load, +inf) and
// issues the U loads of a slice before summing any of them; every lane of
// the group gets the U distances.  `vec` (d a multiple of kVecElems<T> and x
// 16-byte aligned, decided by the host launcher) selects 16-byte loads.  For
// int8, xscale[u] multiplies the row's dot sum (l2/ip/cos) or each
// dequantized element (l1/chi2), one __fmul_rn each, as block_distance does
// (gather_dist.py:97-105); other types ignore it.  TERM is
// metric_term_kind(metric).  Called by all 32 lanes of the warp with the
// same G.
template <typename T, int U, int TERM>
__device__ __forceinline__ void group_row_distances(
    int metric, const float* const (&q)[U], const float (&qn)[U], const T* __restrict__ x,
    const int (&ids)[U], int d, const float (&xn)[U], const float (&xscale)[U], bool vec,
    int G, int gl, float (&out)[U]) {
  // the per-element term as a constant, so the unrolled loops carry no test
  constexpr int kTermMetric = TERM == kTermL1 ? kL1 : TERM == kTermChi2 ? kChi2 : kL2;
  constexpr bool scale_elems = std::is_same<T, int8_t>::value && TERM != kTermDot;
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.f;
  if (vec) {
    constexpr int E = kVecElems<T>;
    for (int j = gl; j < d / E; j += G) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        raw[u] = ids[u] >= 0
                     ? __ldg(reinterpret_cast<const uint4*>(x + (int64_t)ids[u] * d) + j)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* xv = reinterpret_cast<const T*>(&raw[u]);
        const float4* q4 = reinterpret_cast<const float4*>(q[u] + j * E);
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4) {
          const float4 qq = q4[e4];
          const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = to_float(xv[e4 * 4 + e]);
            if (scale_elems) v = __fmul_rn(v, xscale[u]);
            acc[u] = __fadd_rn(acc[u], metric_term(kTermMetric, qv[e], v));
          }
        }
      }
    }
  } else {
    for (int j = gl; j < d; j += G) {
      T raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) raw[u] = ids[u] >= 0 ? x[(int64_t)ids[u] * d + j] : T{};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float v = to_float(raw[u]);
        if (scale_elems) v = __fmul_rn(v, xscale[u]);
        acc[u] = __fadd_rn(acc[u], metric_term(kTermMetric, q[u][j], v));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float s = group_sum(acc[u], G);
    out[u] = ids[u] < 0 ? INFINITY : finish_distance<T>(metric, s, qn[u], xn[u], xscale[u]);
  }
}

// Lanes per row for group_row_distances: the row's d / kVecElems<T> slices
// (or d elements), rounded up to a power of two, at most 32.
template <typename T>
inline int row_group_lanes(int d, bool vec) {
  const int used = vec ? d / kVecElems<T> : d;
  int g = 1;
  while (g < used && g < 32) g <<= 1;
  return g;
}

// Whether a table of T at `x` with row length d takes 16-byte loads.
template <typename T>
inline bool vec_loads(const void* x, int d) {
  return d % kVecElems<T> == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Storage-type codes shared by the launchers and the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace repro_torch
