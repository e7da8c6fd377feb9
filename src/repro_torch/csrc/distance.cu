// pairwise_distance with float32 operands: the C entry of the kernel in
// distance.cuh (which says what it replaces, what bounds it and how).

#include "distance.cuh"

extern "C" int launch_pairwise_distance(
    const void* q, const void* x, const void* x_sq_norms, void* out,
    int m, int n, int d, int metric, void* stream) {
  return repro_torch::launch_pairwise<float>(q, x, x_sq_norms, out, m, n, d, metric, stream);
}
