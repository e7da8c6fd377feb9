// Candidate-row distance shared by the gather-distance and fused-expansion
// kernels: the CUDA counterpart of repro/kernels/gather_dist.py
// block_distance (:69), which blocked_gather_phase (:157) shares between
// _gather_dist_kernel and _fused_expand_kernel.  Keeping one routine keeps
// the two kernels' distances identical per comparison, as in the reference.
//
// One warp computes one candidate row.  Each lane reads float4 slices of the
// row (one load per lane at d = 128) and the warp reduces with xor shuffles,
// which leave the same sum in every lane.  The formula is block_distance's:
//   l2   max(‖q‖² + ‖x‖² − 2 q·x, 0), ‖x‖² from the graph's sq_norms cache
//   ip   −q·x
//   cos  1 − q·x / max(√‖x‖², 1e-12), q normalized by the wrapper
//   dot  q·x
//   l1   Σ |x − q|
//   chi2 Σ (x − q)² / (x + q), 0 where x + q <= 1e-12
// and an id < 0 (padding) gives +inf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

enum Metric : int { kL2 = 0, kIP = 1, kCos = 2, kDot = 3, kL1 = 4, kChi2 = 5 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float metric_term(int metric, float qv, float xv) {
  if (metric == kL1) return fabsf(xv - qv);
  if (metric == kChi2) {
    const float diff = xv - qv;
    const float den = xv + qv;
    return den > 1e-12f ? diff * diff / fmaxf(den, 1e-12f) : 0.f;
  }
  return qv * xv;
}

// Squared norm of the query held in shared memory; every lane of the calling
// warp gets the same value.
__device__ __forceinline__ float warp_sq_norm(const float* q, int d) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int j = lane; j < d; j += 32) acc += q[j] * q[j];
  return warp_sum(acc);
}

// Distance from the query q (shared memory, d floats, 16-byte aligned) to
// row `id` of x (n, d).  `vec4` (d % 4 == 0 and x 16-byte aligned, decided
// by the host launcher) selects the float4 loads.  Must be called by all 32
// lanes of a warp with the same arguments; returns the same value in every
// lane.
__device__ __forceinline__ float warp_row_distance(
    int metric, const float* q, float qn, const float* __restrict__ x,
    int id, int d, float xn, bool vec4) {
  if (id < 0) return INFINITY;
  const int lane = threadIdx.x & 31;
  const float* row = x + (int64_t)id * d;
  float acc = 0.f;
  if (vec4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < (d >> 2); j += 32) {
      const float4 xv = __ldg(row4 + j);
      const float4 qv = q4[j];
      acc += metric_term(metric, qv.x, xv.x);
      acc += metric_term(metric, qv.y, xv.y);
      acc += metric_term(metric, qv.z, xv.z);
      acc += metric_term(metric, qv.w, xv.w);
    }
  } else {
    for (int j = lane; j < d; j += 32) acc += metric_term(metric, q[j], __ldg(row + j));
  }
  const float s = warp_sum(acc);
  switch (metric) {
    // _rn intrinsics: two roundings, as the plain version, never an FMA
    case kL2: return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, s)), 0.f);
    case kIP: return -s;
    case kCos: return 1.f - s / fmaxf(sqrtf(xn), 1e-12f);
    default: return s;  // dot, l1, chi2
  }
}

}  // namespace repro_torch
