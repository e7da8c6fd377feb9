// pairwise_distance with bfloat16 operands (a data_bf16 build's seed graph,
// intra-wave tile and brute force) where the tensor-core form
// (distance_wgmma.cu) does not apply: l1, chi2, d % 8 != 0, unaligned rows.
// The C entry of the kernel in distance.cuh instantiated on __nv_bfloat16,
// built as its own library so that nvcc compiles it beside the fp32 entry.

#include "distance.cuh"

extern "C" int launch_pairwise_distance_bf16(
    const void* q, const void* x, const void* x_sq_norms, void* out,
    int m, int n, int d, int metric, void* stream) {
  return repro_torch::launch_pairwise<__nv_bfloat16>(q, x, x_sq_norms, out, m, n, d, metric,
                                                     stream);
}
