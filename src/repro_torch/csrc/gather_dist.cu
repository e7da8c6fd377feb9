// gather_distance: (B, d) queries, (n, d) rows, (B, C) int32 ids -> (B, C)
// float32 distances, +inf where id < 0.
//
// Replaces the TPU kernel repro/kernels/gather_dist.py gather_distance
// (:255, pallas_call at :329) with its body _gather_dist_kernel (:230) ->
// blocked_gather_phase (:157) -> block_distance (:69).
//
// Bound on an H100: bytes.  Each valid id pulls one d-float row from device
// memory for 2d flops (l2 at d = 128: 512 B per 256 flops, 0.5 flop/B, far
// below the card's ~20 flop/B fp32 balance), so the least time is the
// gathered rows plus ids, norms and outputs over 3.35 TB/s.
//
// Design: one CTA per query, one warp per candidate row (the shared
// warp_row_distance), so a row is one coalesced 512-byte read at d = 128
// and the card keeps B·C independent row reads in flight.  The query is
// staged once in shared memory and its ‖q‖² is reduced once per CTA.  The
// TPU kernel's double-buffered DMA ring is not needed: the warps of
// resident CTAs overlap their loads.

#include "row_distance.cuh"

namespace repro_torch {

constexpr int kGatherThreads = 128;

__global__ void gather_distance_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const float* __restrict__ sq_norms, const int* __restrict__ idx,
    float* __restrict__ out, int C, int d, int metric, bool vec4) {
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
    const float v = warp_row_distance(metric, qs, qn, x, id, d, xn, vec4);
    if (lane == 0) out[(int64_t)b * C + c] = v;
  }
}

}  // namespace repro_torch

extern "C" int launch_gather_distance(
    const void* q, const void* x, const void* sq_norms, const void* idx, void* out,
    int B, int C, int d, int metric, void* stream) {
  using namespace repro_torch;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const size_t smem = (size_t)((d + 3) / 4) * sizeof(float4);
  if (B > 0 && C > 0) {
    gather_distance_kernel<<<B, kGatherThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)x, (const float*)sq_norms, (const int*)idx,
        (float*)out, C, d, metric, vec4);
  }
  return (int)cudaGetLastError();
}
