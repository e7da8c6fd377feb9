// pairwise_distance: (m, d) x (n, d) -> (m, n) float32.
//
// Replaces the TPU kernel repro/kernels/distance.py pairwise_distance (:147,
// pallas_call at :223) with its bodies _dist_kernel_mxu (:41),
// _dist_kernel_mxu_cached (:70) and _dist_kernel_vpu (:95).  Metrics:
//   l2    max(‖q‖² + ‖x‖² − 2 q·x, 0); ‖x‖² from the cache when given
//         (the cached variant skips the x-norm accumulation), else reduced
//         here; ‖q‖² is always reduced here
//   ip    −q·x
//   1−dot cosine on rows the wrapper has normalized (distance.py:169-173)
//   l1    Σ |q − x|
//   chi2  Σ (q − x)² / (q + x), 0 where q + x <= 1e-12
//
// Bound on an H100: operations.  2·m·n·d flops on m·d + n·d + m·n floats:
// the 4096² intra-wave tile at d = 128 is 4.3 GFLOP, 64 us at the 67 TFLOP/s
// fp32 CUDA-core peak, against 20 us for its 67 MB output.  The fp32 main
// path needs IEEE sums, so the tensor cores (TF32 keeps 10 mantissa bits)
// are not used.
//
// Design: the classic shared-memory tiled SIMT GEMM.  A CTA of 256 threads
// owns a 64x64 output tile and walks d in 16-wide slices staged in shared
// memory (stored k-major so a thread's 4 rows and 4 columns are two float4
// reads); each thread accumulates a 4x4 micro-tile in registers, so every
// shared-memory read feeds 4 FMAs.  The l1/chi2 reductions run in the same
// tiling with their own per-element term.  Threads 0-63 (and 64-127 when no
// cache is given) also reduce the tile rows' (columns') squared norms from
// the staged slices, so the l2 epilogue reads no extra device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

enum PairMetric : int { kPL2 = 0, kPIP = 1, kPOneMinusDot = 2, kPL1 = 3, kPChi2 = 4 };

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <int METRIC>
__device__ __forceinline__ float pair_term(float a, float b, float acc) {
  if (METRIC == kPL1) return acc + fabsf(a - b);
  if (METRIC == kPChi2) {
    const float diff = a - b;
    const float den = a + b;
    return acc + (den > 1e-12f ? diff * diff / fmaxf(den, 1e-12f) : 0.f);
  }
  return fmaf(a, b, acc);
}

template <int METRIC>
__global__ void __launch_bounds__(kThreads) pairwise_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const float* __restrict__ x_sq_norms, float* __restrict__ out,
    int m, int n, int d) {
  // +4 padding: the k-major stores of one row's 16 values fall in 8 banks
  // instead of 1, and each row of the slice stays 16-byte aligned
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  __shared__ float qn_s[kBM];
  __shared__ float xn_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // row group: rows ty*4 .. ty*4+3
  const int row0 = blockIdx.x * kBM;  // m on x: grid.y caps at 65535 tiles
  const int col0 = blockIdx.y * kBN;
  const bool cached = x_sq_norms != nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // thread t < 64: ‖q_t‖²; 64 <= t < 128: ‖x_{t-64}‖²

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // stage a 64x16 slice of each operand, zero-padded past m, n and d
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK;
      const int kk = idx % kBK;
      const int gk = k0 + kk;
      const int gq = row0 + r;
      const int gx = col0 + r;
      As[kk][r] = (gq < m && gk < d) ? q[(int64_t)gq * d + gk] : 0.f;
      Bs[kk][r] = (gx < n && gk < d) ? x[(int64_t)gx * d + gk] : 0.f;
    }
    __syncthreads();
    if (METRIC == kPL2) {
      if (tid < kBM) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) norm = fmaf(As[kk][tid], As[kk][tid], norm);
      } else if (tid < kBM + kBN && !cached) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) norm = fmaf(Bs[kk][tid - kBM], Bs[kk][tid - kBM], norm);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = pair_term<METRIC>(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (METRIC == kPL2) {
    if (tid < kBM) {
      qn_s[tid] = norm;
    } else if (tid < kBM + kBN) {
      const int gx = col0 + tid - kBM;
      xn_s[tid - kBM] = cached ? (gx < n ? x_sq_norms[gx] : 0.f) : norm;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int gq = row0 + r;
    if (gq >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      const int gx = col0 + c;
      if (gx >= n) continue;
      float v = acc[i][j];
      if (METRIC == kPL2) {
        v = fmaxf(__fsub_rn(__fadd_rn(qn_s[r], xn_s[c]), __fmul_rn(2.f, v)), 0.f);
      } else if (METRIC == kPIP) {
        v = -v;
      } else if (METRIC == kPOneMinusDot) {
        v = 1.f - v;
      }
      out[(int64_t)gq * n + gx] = v;
    }
  }
}

}  // namespace repro_torch

extern "C" int launch_pairwise_distance(
    const void* q, const void* x, const void* x_sq_norms, void* out,
    int m, int n, int d, int metric, void* stream) {
  using namespace repro_torch;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  if ((n + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* xf = (const float*)x;
  const float* xn = (const float*)x_sq_norms;
  float* o = (float*)out;
  if (m > 0 && n > 0) {
    switch (metric) {
      case kPL2: pairwise_kernel<kPL2><<<grid, kThreads, 0, s>>>(qf, xf, xn, o, m, n, d); break;
      case kPIP: pairwise_kernel<kPIP><<<grid, kThreads, 0, s>>>(qf, xf, xn, o, m, n, d); break;
      case kPOneMinusDot:
        pairwise_kernel<kPOneMinusDot><<<grid, kThreads, 0, s>>>(qf, xf, xn, o, m, n, d);
        break;
      case kPL1: pairwise_kernel<kPL1><<<grid, kThreads, 0, s>>>(qf, xf, xn, o, m, n, d); break;
      case kPChi2: pairwise_kernel<kPChi2><<<grid, kThreads, 0, s>>>(qf, xf, xn, o, m, n, d); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
