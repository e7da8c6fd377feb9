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
// rows plus ids, norms, scales and outputs over 3.35 TB/s.
//
// Design: one CTA per query, one warp per candidate row (the shared
// warp_row_distance), so a row is one coalesced read (512 bytes for fp32
// at d = 128) and the card keeps B·C independent row reads in flight.  The
// query is staged once in shared memory and its ‖q‖² is reduced once per
// CTA.  The TPU kernel's double-buffered DMA ring is not needed: the warps of
// resident CTAs overlap their loads.

#include "row_distance.cuh"

namespace repro_torch {

constexpr int kGatherThreads = 128;

template <typename T>
__global__ void gather_distance_kernel(
    const float* __restrict__ q, const T* __restrict__ x,
    const float* __restrict__ sq_norms, const float* __restrict__ row_scale,
    const int* __restrict__ idx, float* __restrict__ out, int C, int d, int metric,
    bool vec) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // d floats
  __shared__ float qn_s;
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = q[(int64_t)b * d + j];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    const float qn = warp_sq_norm(qs, d);
    if (lane == 0) qn_s = qn;
  }
  __syncthreads();
  const float qn = qn_s;
  const int nwarps = blockDim.x >> 5;
  const bool needs_norm = metric == kL2 || metric == kCos;
  for (int c = warp; c < C; c += nwarps) {
    const int id = idx[(int64_t)b * C + c];
    const float xn = (needs_norm && id >= 0) ? sq_norms[id] : 0.f;
    const float xs = gathered_scale(row_scale, id);
    const float v = warp_row_distance<T>(metric, qs, qn, x, id, d, xn, xs, vec);
    if (lane == 0) out[(int64_t)b * C + c] = v;
  }
}

template <typename T>
void launch(const void* q, const void* x, const void* sq_norms, const void* row_scale,
            const void* idx, void* out, int B, int C, int d, int metric,
            cudaStream_t stream) {
  const size_t smem = (size_t)((d + 3) / 4) * sizeof(float4);
  gather_distance_kernel<T><<<B, kGatherThreads, smem, stream>>>(
      (const float*)q, (const T*)x, (const float*)sq_norms, (const float*)row_scale,
      (const int*)idx, (float*)out, C, d, metric, vec_loads<T>(x, d));
}

}  // namespace repro_torch

// dtype: kF32, kBF16 or kI8 (row_distance.cuh); row_scale is the (n,) int8
// scale table, NULL for fp32 and bf16.
extern "C" int launch_gather_distance(
    const void* q, const void* x, const void* sq_norms, const void* row_scale,
    const void* idx, void* out, int B, int C, int d, int metric, int dtype, void* stream) {
  using namespace repro_torch;
  if (B > 0 && C > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
      case kF32: launch<float>(q, x, sq_norms, nullptr, idx, out, B, C, d, metric, st); break;
      case kBF16: launch<__nv_bfloat16>(q, x, sq_norms, nullptr, idx, out, B, C, d, metric, st); break;
      case kI8: launch<int8_t>(q, x, sq_norms, row_scale, idx, out, B, C, d, metric, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
