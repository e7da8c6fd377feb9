// fused_expand: one whole EHC iteration per query lane.
//
// Replaces the TPU kernel repro/kernels/expand.py fused_expand (:317,
// pallas_call at :412), in its fp32, bf16 and int8 forms (x_eng/quantized at
// :367-368, the gathered scale operand at :396-398), with its body
// _fused_expand_kernel (:252): phase 1
// blocked_gather_phase (gather_dist.py:157), phase 2 _probe_mask_record_merge
// (expand.py:139).  Steps, per lane:
//   1. classify each candidate against the visited hash (Knuth hash,
//      `probes`-deep linear probing, expand.py:76-120), all against the
//      table as it stood before this step;
//   2. distances to the fresh candidates (warp_row_distance, shared with
//      gather_distance) and comps = number of fresh candidates;
//   3. record the fresh candidates whose probe found an empty slot; when
//      several take the same slot the later one in candidate order wins, as
//      XLA's scatter resolves the reference's `.at[].set`;
//   4. beam = top-e of (beam ‖ fresh candidates) by distance in IEEE total
//      order, ties to the lower position, as lax.top_k (expand.py:175);
//   5. dedupe the beam: later copies of an id become (-1, +inf, expanded).
//
// The visited hash (B, H) is updated IN PLACE in device memory: only the
// probed slots are read and only the recorded slots written, so any H works,
// including the auto-sized H up to 65536 (search.py:147-157) whose 512 KB
// row would not fit the 227 KB of shared memory.  The TPU kernel kept the
// row in VMEM instead.
//
// Bound on an H100: bytes.  Per lane: the fresh candidate rows (d elements
// of the table's type each, plus a 4-byte scale for int8), C·P probed hash
// ids, the recorded (id, dist) pairs, the beam in and out.  At B = 4096,
// C = 60, P = 8, d = 128 about 126 MB of fp32 rows (63 MB bf16, 32 MB int8)
// plus 8 MB of probes: ~40 us at 3.35 TB/s for fp32.
//
// Design: one CTA of 128 threads per lane.  Candidate ids, flags, slots,
// distances and the (e + C)-entry merge live in shared memory; one thread per
// candidate classifies, one warp per fresh candidate reads its row (one
// coalesced 512-byte read at d = 128 for fp32), one thread per merge entry
// computes its rank by counting (O((e + C)²) compares, 10^4 at e + C =
// 100), and the
// same-slot winner is elected by an O(C²) scan.  __syncthreads() separates
// every read phase of the hash from its write phase.

#include "row_distance.cuh"

namespace repro_torch {

constexpr int kExpandThreads = 128;
constexpr uint32_t kKnuth = 2654435761u;

// IEEE total order on float32 as a signed int (-0.0 sorts before +0.0).
__device__ __forceinline__ int total_order_key(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

template <typename T>
__global__ void fused_expand_kernel(
    const float* __restrict__ q, const T* __restrict__ x,
    const float* __restrict__ sq_norms, const float* __restrict__ row_scale,
    const int* __restrict__ cands,
    const int* __restrict__ beam_ids, const float* __restrict__ beam_dist,
    const uint8_t* __restrict__ beam_exp, int* __restrict__ vis_ids,
    float* __restrict__ vis_dist, int* __restrict__ out_ids,
    float* __restrict__ out_dist, uint8_t* __restrict__ out_exp,
    int* __restrict__ comps, int C, int e, int H, int P, int d, int metric,
    bool vec) {
  const int n = e + C;
  const int d4 = (d + 3) >> 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // d4 * 4
  float* cdist = qs + d4 * 4;                    // C
  float* cat_dist = cdist + C;                   // n
  float* top_dist = cat_dist + n;                // e
  int* cid = reinterpret_cast<int*>(top_dist + e);  // C
  int* slot = cid + C;                           // C
  int* cat_ids = slot + C;                       // n
  int* cat_key = cat_ids + n;                    // n
  int* top_ids = cat_key + n;                    // e
  uint8_t* fresh = reinterpret_cast<uint8_t*>(top_ids + e);  // C
  uint8_t* do_ins = fresh + C;                   // C
  uint8_t* cat_exp = do_ins + C;                 // n
  uint8_t* top_exp = cat_exp + n;                // e
  __shared__ float qn_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nt >> 5;
  int* vis_row = vis_ids + (int64_t)b * H;
  float* vdist_row = vis_dist + (int64_t)b * H;

  for (int j = tid; j < d; j += nt) qs[j] = q[(int64_t)b * d + j];
  for (int c = tid; c < C; c += nt) cid[c] = cands[(int64_t)b * C + c];
  __syncthreads();

  // ---- 1. classify against the table as it stands (reads only) ----------
  if (warp == 0) {
    const float qn = warp_sq_norm(qs, d);
    if (lane == 0) qn_s = qn;
  }
  for (int c = tid; c < C; c += nt) {
    const int id = cid[c];
    uint8_t f = 0, ins = 0;
    int s_ins = 0;
    if (id >= 0) {
      const int h = (int)(((uint32_t)id * kKnuth) >> 16) & (H - 1);
      int first_hit = P, first_empty = P;
      for (int p = 0; p < P; ++p) {
        const int v = vis_row[(h + p) & (H - 1)];
        if (v == id && first_hit == P) first_hit = p;
        if (v == -1 && first_empty == P) first_empty = p;
      }
      f = !(first_hit < first_empty);
      ins = f && first_empty < P;
      s_ins = (h + min(first_empty, P - 1)) & (H - 1);
    }
    fresh[c] = f;
    do_ins[c] = ins;
    slot[c] = s_ins;
  }
  __syncthreads();

  // ---- 2. distances to fresh candidates (one warp per row) ---------------
  const float qn = qn_s;
  const bool needs_norm = metric == kL2 || metric == kCos;
  for (int c = warp; c < C; c += nwarps) {
    float v = INFINITY;
    if (fresh[c]) {
      const int id = cid[c];
      v = warp_row_distance<T>(metric, qs, qn, x, id, d, needs_norm ? sq_norms[id] : 0.f,
                               gathered_scale(row_scale, id), vec);
    }
    if (lane == 0) cdist[c] = v;
  }
  __syncthreads();

  // ---- 3. record (writes only; later candidate wins a shared slot) ------
  for (int c = tid; c < C; c += nt) {
    if (!do_ins[c]) continue;
    bool win = true;
    for (int c2 = c + 1; c2 < C; ++c2) {
      if (do_ins[c2] && slot[c2] == slot[c]) {
        win = false;
        break;
      }
    }
    if (win) {
      vis_row[slot[c]] = cid[c];
      vdist_row[slot[c]] = cdist[c];
    }
  }
  // merge inputs: beam ‖ fresh candidates
  for (int i = tid; i < n; i += nt) {
    int id;
    float dv;
    uint8_t ex;
    if (i < e) {
      id = beam_ids[(int64_t)b * e + i];
      dv = beam_dist[(int64_t)b * e + i];
      ex = beam_exp[(int64_t)b * e + i] != 0;
    } else {
      const int c = i - e;
      id = fresh[c] ? cid[c] : -1;
      dv = cdist[c];  // +inf unless fresh
      ex = !fresh[c];
    }
    cat_ids[i] = id;
    cat_dist[i] = dv;
    cat_key[i] = total_order_key(dv);
    cat_exp[i] = ex;
  }
  if (tid == 0) {
    int cnt = 0;
    for (int c = 0; c < C; ++c) cnt += fresh[c];
    comps[b] = cnt;
  }
  __syncthreads();

  // ---- 4. top-e by rank counting (ties to the lower position) -----------
  for (int i = tid; i < n; i += nt) {
    const int ki = cat_key[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const int kj = cat_key[j];
      r += (kj < ki) || (kj == ki && j < i);
    }
    if (r < e) {
      top_ids[r] = cat_ids[i];
      top_dist[r] = cat_dist[i];
      top_exp[r] = cat_exp[i];
    }
  }
  __syncthreads();

  // ---- 5. dedupe and write the beam --------------------------------------
  for (int i = tid; i < e; i += nt) {
    const int id = top_ids[i];
    bool dup = false;
    if (id >= 0) {
      for (int j = 0; j < i; ++j) {
        if (top_ids[j] == id) {
          dup = true;
          break;
        }
      }
    }
    out_ids[(int64_t)b * e + i] = dup ? -1 : id;
    out_dist[(int64_t)b * e + i] = dup ? INFINITY : top_dist[i];
    out_exp[(int64_t)b * e + i] = (top_exp[i] || dup) ? 1 : 0;
  }
}

template <typename T>
void launch_expand(const void* q, const void* x, const void* sq_norms, const void* row_scale,
                   const void* cands, const void* beam_ids, const void* beam_dist,
                   const void* beam_exp, void* vis_ids, void* vis_dist, void* out_ids,
                   void* out_dist, void* out_exp, void* comps, int B, int C, int e, int H,
                   int P, int d, int metric, cudaStream_t stream) {
  const int n = e + C;
  const int d4 = (d + 3) / 4;
  const size_t smem = sizeof(float) * (size_t)(d4 * 4 + C + n + e) +
                      sizeof(int) * (size_t)(2 * C + 2 * n + e) +
                      (size_t)(2 * C + n + e);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fused_expand_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  fused_expand_kernel<T><<<B, kExpandThreads, smem, stream>>>(
      (const float*)q, (const T*)x, (const float*)sq_norms, (const float*)row_scale,
      (const int*)cands, (const int*)beam_ids, (const float*)beam_dist,
      (const uint8_t*)beam_exp, (int*)vis_ids, (float*)vis_dist, (int*)out_ids,
      (float*)out_dist, (uint8_t*)out_exp, (int*)comps, C, e, H, P, d, metric,
      vec_loads<T>(x, d));
}

}  // namespace repro_torch

// dtype: kF32, kBF16 or kI8 (row_distance.cuh); row_scale is the (n,) int8
// scale table, NULL for fp32 and bf16.
extern "C" int launch_fused_expand(
    const void* q, const void* x, const void* sq_norms, const void* row_scale,
    const void* cands, const void* beam_ids, const void* beam_dist, const void* beam_exp,
    void* vis_ids, void* vis_dist, void* out_ids, void* out_dist, void* out_exp,
    void* comps, int B, int C, int e, int H, int P, int d, int metric, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B > 0) {
    cudaStream_t st = (cudaStream_t)stream;
#define REPRO_EXPAND_ARGS q, x, sq_norms, row_scale, cands, beam_ids, beam_dist, beam_exp, \
    vis_ids, vis_dist, out_ids, out_dist, out_exp, comps, B, C, e, H, P, d, metric, st
    switch (dtype) {
      case kF32: launch_expand<float>(REPRO_EXPAND_ARGS); break;
      case kBF16: launch_expand<__nv_bfloat16>(REPRO_EXPAND_ARGS); break;
      case kI8: launch_expand<int8_t>(REPRO_EXPAND_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_EXPAND_ARGS
  }
  return (int)cudaGetLastError();
}
