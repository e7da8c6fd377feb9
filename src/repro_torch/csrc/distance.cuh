// pairwise_distance: (m, d) x (n, d) -> (m, n) float32, operands float32
// or (both) bfloat16.  The kernel template, included by distance.cu (the
// fp32 entry) and distance_bf16.cu (the bf16 entry), so the two compile
// apart, in parallel.  Two bf16 operands under l2 or ip at d % 8 == 0 take
// the tensor-core form instead (distance_wgmma.cu).
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
// fp32 CUDA-core peak, against 20 us for its 67 MB output, both at
// chip_smoke.py's main shape and in the build, where every call is that
// tile.  The fp32 main path needs IEEE sums, so the tensor cores (TF32 keeps
// 10 mantissa bits, 3xTF32 other roundings) are not used.  Measured, the
// main loop (1,024 FFMA and 64 LDS.128 per slice in the SASS, no spills)
// issues at about 54% of that peak with the SM clock at its maximum: the
// rest is issue stalls of the FFMA stream (PERF.md).
//
// Bits.  Every output is one fmaf chain over k = 0 .. d-1 in order, from
// 0.f (the l1/chi2 terms likewise, one add per k), and each norm is the
// fmaf chain of its row; the l2 epilogue rounds with _rn intrinsics.  Slices
// past d are zeros, and fmaf(0, 0, acc) leaves a chain that started at +0
// unchanged, so no tiling changes a bit.  Keep that rule in any redesign of
// the fp32 kernel: the fp32 main path's graphs depend on those bits.  The
// one departure is the tensor-core form for two bf16 operands
// (distance_wgmma.cu): it keeps the norm chains and the epilogue, but the
// tensor cores sum q·x in their own order.  Every bf16 x bf16 product is
// exact in fp32, so it equals this kernel bit for bit on integer-valued rows
// (sums below 2^24) and stays within 1e-5 · (‖q‖² + ‖x‖²) of it on real
// ones; in exchange the products run at the tensor cores' rate instead of
// the FFMA loop's, and the function becomes bound by its output bytes.
//
// bf16 operands (a data_bf16 build's seed graph, intra-wave tile and brute
// force; the reference's Pallas body upcasts whatever it is given,
// distance.py:51-52, :81-82, :107-108) that the tensor-core form does not
// take (l1, chi2, d % 8 != 0, unaligned rows): the same kernel instantiated
// on the operand type.  Only the loads differ: four bf16 values (8 bytes)
// per load, widened to fp32 in registers, which is exact, so every chain,
// norm and epilogue is the fp32 kernel's and the output equals the fp32
// kernel's on the widened rows bit for bit.  Half the operand bytes; it
// runs at the fp32 kernel's speed (H100 80GB HBM3 at 700 W, PERF.md).
//
// Design: a register-blocked SIMT GEMM.  Two persistent CTAs of 256
// threads per SM walk the 128x128 output tiles; a tile walks d in 16-wide
// slices, and each thread holds an 8x8 micro-tile (rows ty*4 + {0..3,
// 64..67}, columns likewise from tx), so one k step reads four float4 from
// shared memory for 64 FMAs.  The slices are double-buffered: each thread
// fetches its float4s of the next slice of q and x (16-byte loads where
// d % 4 == 0) into registers while the current slice is multiplied, then
// stores them to the other buffer, one barrier per slice; the next tile's
// first slice is fetched during this tile's epilogue.  The loader lanes of
// a row also carry its squared norm: each adds its four k values to the
// fmaf chain and hands it to the next by a shuffle, so the norms cost no
// shared-memory reads and fall on every warp alike.  The epilogue stores
// each row's four consecutive columns as one float4 where n % 4 == 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

enum PairMetric : int { kPL2 = 0, kPIP = 1, kPOneMinusDot = 2, kPL1 = 3, kPChi2 = 4 };

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;
constexpr int kCtasPerSM = 2;
constexpr int kRowLanes = kBK / 4;  // loader threads per tile row, 4 k values each
constexpr int kLoads = kBM * kRowLanes / kThreads;  // tile rows per loader thread
// +4: each k row of a buffer stays 16-byte aligned for the float4 reads
constexpr int kPad = 4;
constexpr unsigned kFull = 0xffffffffu;

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

// Four consecutive k values of row r from k0, zeros past `rows` and d.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ a, int r, int rows, int k0,
                                        int d) {
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = a + (int64_t)r * d + k0;
  if (VEC) return k0 < d ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(k0 < d ? __ldg(p) : 0.f, k0 + 1 < d ? __ldg(p + 1) : 0.f,
                     k0 + 2 < d ? __ldg(p + 2) : 0.f, k0 + 3 < d ? __ldg(p + 3) : 0.f);
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// The same from bf16 rows, widened to fp32 (exact): VEC is one 8-byte load.
template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* __restrict__ a, int r, int rows,
                                        int k0, int d) {
  if (r >= rows || k0 >= d) return make_float4(0.f, 0.f, 0.f, 0.f);
  const __nv_bfloat16* p = a + (int64_t)r * d + k0;
  if (VEC) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(bf16_at(p), k0 + 1 < d ? bf16_at(p + 1) : 0.f,
                     k0 + 2 < d ? bf16_at(p + 2) : 0.f, k0 + 3 < d ? bf16_at(p + 3) : 0.f);
}

// The squared-norm chain of one row carried over four more k values.
__device__ __forceinline__ float norm4(float4 v, float n) {
  n = fmaf(v.x, v.x, n);
  n = fmaf(v.y, v.y, n);
  n = fmaf(v.z, v.z, n);
  return fmaf(v.w, v.w, n);
}

template <typename T, int METRIC, bool VEC>
__global__ void __launch_bounds__(kThreads, kCtasPerSM) pairwise_kernel(
    const T* __restrict__ q, const T* __restrict__ x,
    const float* __restrict__ x_sq_norms, float* __restrict__ out,
    int m, int n, int d) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  __shared__ float qn_s[kBM];
  __shared__ float xn_s[kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid % 16;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // rows ty*4 .. +3 and 64 + ty*4 .. +3
  const int sub = tid % kRowLanes;  // which 4 k values of its rows a loader holds
  const bool cached = x_sq_norms != nullptr;
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const bool vec_out = (n & 3) == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;

  // loader: load l of a thread is tile row (tid + l·kThreads) / kRowLanes,
  // k values sub·4 .. +3 of each slice, for both operands
  float4 pa[kLoads], pb[kLoads];
  auto fetch = [&](int tile, int k0) {
    const int row0 = tile / tiles_n * kBM, col0 = tile % tiles_n * kBN;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int lr = (tid + l * kThreads) / kRowLanes;
      pa[l] = load4<VEC>(q, row0 + lr, m, k0 + sub * 4, d);
      pb[l] = load4<VEC>(x, col0 + lr, n, k0 + sub * 4, d);
    }
  };

  int tile = blockIdx.x;  // persistent: the CTA walks tiles blockIdx.x + i·gridDim.x
  if (tile < tiles) fetch(tile, 0);
  for (; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / tiles_n * kBM, col0 = tile % tiles_n * kBN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // ‖q‖² and ‖x‖² of the loader's rows: each row's fmaf chain runs in k
    // order through its kRowLanes loader lanes, one shuffle per hand-over
    float qnorm[kLoads], xnorm[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) qnorm[l] = xnorm[l] = 0.f;

    auto stage = [&](int buf) {
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        const int lr = (tid + l * kThreads) / kRowLanes, lk = sub * 4;
        As[buf][lk + 0][lr] = pa[l].x;
        As[buf][lk + 1][lr] = pa[l].y;
        As[buf][lk + 2][lr] = pa[l].z;
        As[buf][lk + 3][lr] = pa[l].w;
        Bs[buf][lk + 0][lr] = pb[l].x;
        Bs[buf][lk + 1][lr] = pb[l].y;
        Bs[buf][lk + 2][lr] = pb[l].z;
        Bs[buf][lk + 3][lr] = pb[l].w;
        if (METRIC == kPL2) {
          float nq = qnorm[l], nx = xnorm[l];
#pragma unroll
          for (int s = 0; s < kRowLanes; ++s) {
            if (sub == s) {
              nq = norm4(pa[l], nq);
              if (!cached) nx = norm4(pb[l], nx);
            }
            const int src = (lane & ~(kRowLanes - 1)) | s;
            nq = __shfl_sync(kFull, nq, src);
            if (!cached) nx = __shfl_sync(kFull, nx, src);
          }
          qnorm[l] = nq;
          xnorm[l] = nx;
        }
      }
    };
    stage(0);
    __syncthreads();

    int buf = 0;
    for (int k0 = 0; k0 < d; k0 += kBK) {
      const bool more = k0 + kBK < d;
      if (more) fetch(tile, k0 + kBK);  // in flight while this slice is multiplied
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = pair_term<METRIC>(av[i], bv[j], acc[i][j]);
      }
      if (more) stage(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

    // the next tile's first slice, in flight during this tile's epilogue
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x, 0);

    if (METRIC == kPL2) {
      if (sub == 0) {
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int lr = (tid + l * kThreads) / kRowLanes;
          const int gx = col0 + lr;
          qn_s[lr] = qnorm[l];
          xn_s[lr] = cached ? (gx < n ? x_sq_norms[gx] : 0.f) : xnorm[l];
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      const int gq = row0 + r;
      if (gq >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * 64 + tx * 4;
        const int gx = col0 + c;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][h * 4 + j];
          if (METRIC == kPL2) {
            s = fmaxf(__fsub_rn(__fadd_rn(qn_s[r], xn_s[c + j]), __fmul_rn(2.f, s)), 0.f);
          } else if (METRIC == kPIP) {
            s = -s;
          } else if (METRIC == kPOneMinusDot) {
            s = 1.f - s;
          }
          v[j] = s;
        }
        float* o = out + (int64_t)gq * n + gx;
        if (vec_out && gx + 3 < n) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (gx + j < n) o[j] = v[j];
          }
        }
      }
    }
  }
}

template <typename T, int METRIC>
void launch(const T* q, const T* x, const float* xn, float* o, int m, int n, int d,
            bool vec, int grid, cudaStream_t s) {
  if (vec) {
    pairwise_kernel<T, METRIC, true><<<grid, kThreads, 0, s>>>(q, x, xn, o, m, n, d);
  } else {
    pairwise_kernel<T, METRIC, false><<<grid, kThreads, 0, s>>>(q, x, xn, o, m, n, d);
  }
}

template <typename T>
int launch_pairwise(const void* q, const void* x, const void* x_sq_norms, void* out,
                    int m, int n, int d, int metric, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (int64_t)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < (int64_t)kCtasPerSM * sms ? tiles : (int64_t)kCtasPerSM * sms);
  const cudaStream_t s = (cudaStream_t)stream;
  const T* qt = (const T*)q;
  const T* xt = (const T*)x;
  const float* xn = (const float*)x_sq_norms;
  float* o = (float*)out;
  // vector loads (four values) need every row start aligned to their width
  const uintptr_t width = 4 * sizeof(T);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(qt) % width == 0 &&
                   reinterpret_cast<uintptr_t>(xt) % width == 0;
  switch (metric) {
    case kPL2: launch<T, kPL2>(qt, xt, xn, o, m, n, d, vec, grid, s); break;
    case kPIP: launch<T, kPIP>(qt, xt, xn, o, m, n, d, vec, grid, s); break;
    case kPOneMinusDot: launch<T, kPOneMinusDot>(qt, xt, xn, o, m, n, d, vec, grid, s); break;
    case kPL1: launch<T, kPL1>(qt, xt, xn, o, m, n, d, vec, grid, s); break;
    case kPChi2: launch<T, kPChi2>(qt, xt, xn, o, m, n, d, vec, grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
