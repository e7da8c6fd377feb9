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
//   2. distances to the fresh candidates (group_row_distances, the row
//      arithmetic gather_distance uses too) and comps = number of fresh
//      candidates;
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
// Bound on an H100: bytes.  Per lane it moves the fresh candidate rows (d
// elements of the table's type each, plus a 4-byte scale for int8), C·P
// probed hash ids, the recorded (id, dist) pairs, the beam in and out.  At
// chip_smoke.py's synthetic state (B = 4096, C = 60, P = 8, d = 128, 79% of
// candidates fresh) that is 34 us of fp32 bytes at 3.35 TB/s (19 us bf16,
// 12 us int8).  Inside the 10^6 build only ~15% of the candidates are fresh
// and most lanes have none, so the bytes take ~10 us.  What bounds it in
// practice (clock64 phase stamps, PERF.md): at the synthetic state the row
// phase, 60-75% of a warp's time, whose random 512-byte fp32 rows stream at
// under 2 TB/s; in the build the chain of dependent round trips of the
// busiest lanes (inputs, probes, rows), plus the launch.  All warps start
// together, so their memory and compute phases do not overlap.
//
// Design: one warp per lane, eight lanes per CTA, so all 4,096 lanes of a
// launch are resident at once (32 warps per SM).  Each warp loads its
// candidates, query and beam together; loads all P probes of two candidates
// per lane (64 candidates per pass, three 16-byte loads per 8 probes)
// before comparing any; and compacts the fresh candidates with a ballot
// prefix (comps is its popcount).  One CTA barrier later, the CTA's fresh
// rows, lane by lane, are spread over all its warps in groups of G lanes
// (32 fp32, 16 bf16, 8 int8 at d = 128), U rows per group in flight, so a
// lane with many fresh rows borrows its neighbours' warps; a second barrier
// hands the distances back.  Each warp then elects same-slot winners with
// __match_any_sync, ranks only the beam and the fresh candidates (the
// non-fresh ones are identical (-1, +inf, 1) entries whose ranks are
// counted, not sorted; a beam already in order ranks its entries by
// position and the fresh ones by binary search), and dedupes the e
// outputs.  The kernel is instantiated per storage type and per metric
// term (q·x, l1, chi2), so the unrolled row loops carry no metric test.
//
// Bits: the rows' sums keep group_row_distances' element-to-lane split and
// xor tree (row_distance.cuh), with every product and sum rounded by
// __fmul_rn/__fadd_rn, and the merge keeps IEEE total order with ties to
// the lower position, so no thread mapping changes an output bit.

#include "row_distance.cuh"

namespace repro_torch {

constexpr int kExpandWarps = 8;  // query lanes per CTA, one warp each
// 4 CTAs (32 warps) per SM hold all 4,096 lanes of a main-path launch on the
// 132 SMs at once; it caps the kernel at 64 registers a thread
constexpr int kExpandBlocksPerSM = 4;
constexpr int kRowsPerGroup = 2;  // U: rows a group of lanes has in flight
constexpr int kProbeBatch = 8;  // probes of a candidate loaded before any compare
constexpr uint32_t kKnuth = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;

// IEEE total order on float32 as a signed int (-0.0 sorts before +0.0).
__device__ __forceinline__ int total_order_key(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

// Per-warp shared memory, in 4-byte words, a multiple of 4 so that every
// warp's query stays 16-byte aligned.
__host__ __device__ inline int expand_warp_words(int C, int e, int d) {
  return ((d + 3) / 4 * 4 + 3 * C + 4 * (e + C) + 3 * e + 3) / 4 * 4;
}

// The kProbeBatch hash ids at slots (h + p0 + i) & (H - 1) of a lane's row.
// With `vec` (H >= 4, row 16-byte aligned) they come from three aligned
// 16-byte loads of the 12-slot window that holds them; slots past P are 0.
// Plain loads, not __ldg: this kernel writes the hash later.
__device__ __forceinline__ void probe_batch(const int* vis_row, int h, int p0,
                                            int H, int P, bool live, bool vec,
                                            int (&v)[kProbeBatch]) {
  if (vec) {
    const int s0 = (h + p0) & (H - 1);
    const int w0 = s0 & ~3, off = s0 & 3;
    int w[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int4 piece = live ? *reinterpret_cast<const int4*>(vis_row + ((w0 + 4 * k) & (H - 1)))
                              : make_int4(0, 0, 0, 0);
      w[4 * k] = piece.x;
      w[4 * k + 1] = piece.y;
      w[4 * k + 2] = piece.z;
      w[4 * k + 3] = piece.w;
    }
#pragma unroll
    for (int i = 0; i < kProbeBatch; ++i) {
      const int a = off == 0 ? w[i] : off == 1 ? w[i + 1] : off == 2 ? w[i + 2] : w[i + 3];
      v[i] = p0 + i < P ? a : 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kProbeBatch; ++i) {
      v[i] = live && p0 + i < P ? vis_row[(h + p0 + i) & (H - 1)] : 0;
    }
  }
}

// Classify two candidates against the lane's hash row, as the table stands
// before this step: fresh (not found before the first empty probe; id < 0
// never is) and the slot it records into, -1 when its probes found no empty
// slot or it is not fresh.  Both candidates' probes of a batch are loaded
// before any is compared.
__device__ __forceinline__ void classify2(const int* vis_row, const int (&id)[2],
                                          int H, int P, bool vec, bool (&fresh)[2],
                                          int (&slot)[2]) {
  int h[2], first_hit[2], first_empty[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    h[t] = (int)(((uint32_t)id[t] * kKnuth) >> 16) & (H - 1);
    first_hit[t] = first_empty[t] = P;
  }
  for (int p0 = 0; p0 < P; p0 += kProbeBatch) {
    int v[2][kProbeBatch];
#pragma unroll
    for (int t = 0; t < 2; ++t) probe_batch(vis_row, h[t], p0, H, P, id[t] >= 0, vec, v[t]);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < kProbeBatch; ++i) {
        if (p0 + i < P) {
          if (v[t][i] == id[t] && first_hit[t] == P) first_hit[t] = p0 + i;
          if (v[t][i] == -1 && first_empty[t] == P) first_empty[t] = p0 + i;
        }
      }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    fresh[t] = id[t] >= 0 && !(first_hit[t] < first_empty[t]);
    slot[t] = fresh[t] && first_empty[t] < P ? (h[t] + first_empty[t]) & (H - 1) : -1;
  }
}

// CTA-wide fresh row k -> its id (-1 past `total`), owner lane w and the
// row's place r in the owner's compacted list.
template <int W>
__device__ __forceinline__ int cta_row(const float4* smem4, int words, const int (&start)[W],
                                       int total, int k, int d, int& w, int& r) {
  w = 0;
  int first = 0;
#pragma unroll
  for (int v = 1; v < W; ++v) {
    if (k >= start[v]) {
      w = v;
      first = start[v];
    }
  }
  r = k - first;
  const int* wfid = reinterpret_cast<const int*>(reinterpret_cast<const float*>(smem4) +
                                                 w * words + (d + 3) / 4 * 4);
  return k < total ? wfid[r] : -1;
}

template <typename T, int TERM>
__global__ void __launch_bounds__(kExpandWarps * 32, kExpandBlocksPerSM) fused_expand_kernel(
    const float* __restrict__ q, const T* __restrict__ x,
    const float* __restrict__ sq_norms, const float* __restrict__ row_scale,
    const int* __restrict__ cands,
    const int* __restrict__ beam_ids, const float* __restrict__ beam_dist,
    const uint8_t* __restrict__ beam_exp, int* __restrict__ vis_ids,
    float* __restrict__ vis_dist, int* __restrict__ out_ids,
    float* __restrict__ out_dist, uint8_t* __restrict__ out_exp,
    int* __restrict__ comps, int B, int C, int e, int H, int P, int d, int metric,
    bool vec, bool qvec, bool hvec, int G) {
  constexpr int U = kRowsPerGroup;
  constexpr int W = kExpandWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * W + warp;
  const bool live = b < B;  // a warp past B only joins the CTA's barriers
  const int words = expand_warp_words(C, e, d);

  extern __shared__ float4 smem4[];
  __shared__ int cta_nf[W];
  __shared__ float cta_qn[W];
  float* qs = reinterpret_cast<float*>(smem4) + warp * words;
  int* fid = reinterpret_cast<int*>(qs + (d + 3) / 4 * 4);  // fresh ids, compacted: C
  int* fslot = fid + C;                     // their record slots (-1: none): C
  int* fcand = fslot + C;                   // their candidate positions: C
  int* lkey = fcand + C;                    // merge entries: beam ‖ fresh, e + C
  int* lid = lkey + e + C;
  float* ldist = reinterpret_cast<float*>(lid + e + C);
  int* lexp = reinterpret_cast<int*>(ldist + e + C);
  int* tid = lexp + e + C;                  // the top-e: e
  float* tdist = reinterpret_cast<float*>(tid + e);
  int* texp = reinterpret_cast<int*>(tdist + e);

  const int* cand_row = cands + (int64_t)b * C;
  int* vis_row = vis_ids + (int64_t)b * H;
  float* vdist_row = vis_dist + (int64_t)b * H;
  const unsigned below = (1u << lane) - 1u;

  // ---- inputs: the first pass's candidates, the query, the beam ----------
  // every load of a loop is issued before its shared-memory stores
  int c_lo = live && lane < C ? cand_row[lane] : -1;
  int c_hi = live && lane + 32 < C ? cand_row[lane + 32] : -1;
  if (live && qvec) {
    const float4* q4 = reinterpret_cast<const float4*>(q + (int64_t)b * d);
    for (int j = lane; j < d / 4; j += 32) reinterpret_cast<float4*>(qs)[j] = __ldg(q4 + j);
  } else if (live) {
    for (int j = lane; j < d; j += 32) qs[j] = q[(int64_t)b * d + j];
  }
  for (int i0 = 0; live && i0 < e; i0 += 64) {
    int bid[2], bexp[2];
    float bdist[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + 32 * t + lane;
      const bool in = i < e;
      bid[t] = in ? beam_ids[(int64_t)b * e + i] : -1;
      bdist[t] = in ? beam_dist[(int64_t)b * e + i] : 0.f;
      bexp[t] = in ? beam_exp[(int64_t)b * e + i] != 0 : 0;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + 32 * t + lane;
      if (i < e) {
        lkey[i] = total_order_key(bdist[t]);
        lid[i] = bid[t];
        ldist[i] = bdist[t];
        lexp[i] = bexp[t];
        tid[i] = -1;  // top-e slots no beam or fresh entry takes: non-fresh
        tdist[i] = INFINITY;
        texp[i] = 1;
      }
    }
  }

  // ---- 1. classify (reads only) and compact the fresh candidates ---------
  int nf = 0;
  for (int c0 = 0; c0 < C; c0 += 64) {
    if (c0 > 0) {
      c_lo = live && c0 + lane < C ? cand_row[c0 + lane] : -1;
      c_hi = live && c0 + lane + 32 < C ? cand_row[c0 + lane + 32] : -1;
    }
    const int id[2] = {c_lo, c_hi};
    bool fresh[2];
    int slot[2];
    classify2(vis_row, id, H, P, hvec, fresh, slot);
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // candidate order: c0 + lane, then c0 + 32 + lane
      const unsigned m = __ballot_sync(kFull, fresh[t]);
      if (fresh[t]) {
        const int r = nf + __popc(m & below);
        fid[r] = id[t];
        fslot[r] = slot[t];
        fcand[r] = c0 + 32 * t + lane;
      }
      nf += __popc(m);
    }
  }
  __syncwarp();
  if (live && lane == 0) comps[b] = nf;
  const float qn = nf > 0 ? warp_sq_norm(qs, d) : 0.f;
  if (lane == 0) {
    cta_nf[warp] = nf;
    cta_qn[warp] = qn;
  }
  __syncthreads();

  // ---- 2. distances to the CTA's fresh rows, shared by all its warps -----
  // The W lanes' compacted rows, lane by lane, go to the W·(32/G) groups of
  // G lanes round-robin, U rows a group at a time, so a lane with many
  // fresh rows borrows its neighbours' warps.
  {
    int start[W];  // first CTA-wide row of each lane
    int total = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      start[w] = total;
      total += cta_nf[w];
    }
    const bool needs_norm = metric == kL2 || metric == kCos;
    const int R = 32 / G;
    const int groups = W * R;
    const int step = groups * U;
    const int gg = warp * R + lane / G;
    const int gl = lane % G;
    for (int k0 = 0; k0 < total; k0 += step) {
      const float* qrow[U];
      float qnr[U], xn[U], xs[U], dist[U];
      int ids[U], own[U], rr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ids[u] = cta_row(smem4, words, start, total, k0 + u * groups + gg, d, own[u], rr[u]);
        qrow[u] = reinterpret_cast<const float*>(smem4) + own[u] * words;
        qnr[u] = cta_qn[own[u]];
        xn[u] = needs_norm && ids[u] >= 0 ? sq_norms[ids[u]] : 0.f;
        xs[u] = gathered_scale(row_scale, ids[u]);
      }
      group_row_distances<T, U, TERM>(metric, qrow, qnr, x, ids, d, xn, xs, vec, G, gl, dist);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (gl == 0 && ids[u] >= 0) {
          int* wl = reinterpret_cast<int*>(smem4) + own[u] * words + (d + 3) / 4 * 4 + 3 * C;
          const int i = e + rr[u];  // merge entry of the owner's lane
          wl[i] = total_order_key(dist[u]);               // lkey
          wl[(e + C) + i] = ids[u];                       // lid
          reinterpret_cast<float*>(wl)[2 * (e + C) + i] = dist[u];  // ldist
          wl[3 * (e + C) + i] = 0;                        // lexp
        }
      }
    }
  }
  __syncthreads();
  if (!live) return;  // no barrier follows

  // ---- 3. record (writes only; the later candidate wins a shared slot) ---
  // Passes go in candidate order and each pass's winners overwrite the
  // earlier passes' (__syncwarp orders the warp's writes).
  for (int r0 = 0; r0 < nf; r0 += 32) {
    const int r = r0 + lane;
    const int s = r < nf ? fslot[r] : -1;
    const unsigned same = __match_any_sync(kFull, s >= 0 ? s : -1 - lane);
    if (s >= 0 && (same >> lane) == 1u) {
      vis_row[s] = fid[r];
      vdist_row[s] = ldist[e + r];
    }
    __syncwarp();
  }

  // ---- 4. top-e: each beam and fresh entry's rank among all e + C --------
  // rank = the entries before it in (key, position) order.  The non-fresh
  // candidates are identical (-1, +inf, 1) entries at the key of +inf: they
  // are counted, never ranked, and fill the slots no other entry takes.  A
  // beam already in order (the previous step's output, unless dedupe left a
  // hole) ranks its own entries by position and the fresh ones by binary
  // search; any other beam is ranked by counting all pairs.
  const int L = e + nf;
  const int kinf = total_order_key(INFINITY);
  bool ordered = true;
  for (int i = lane; i + 1 < e; i += 32) ordered &= lkey[i] <= lkey[i + 1];
  ordered = __all_sync(kFull, ordered);
  for (int i = lane; i < L; i += 32) {
    const int ki = lkey[i];
    int rank = 0;
    if (!ordered) {
      for (int j = 0; j < L; ++j) {
        const int kj = lkey[j];
        rank += (kj < ki) || (kj == ki && j < i);
      }
    } else if (i < e) {
      rank = i;
      for (int j = e; j < L; ++j) rank += lkey[j] < ki;
    } else {
      int lo = 0, hi = e;  // beam entries with key <= ki
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lkey[mid] <= ki) lo = mid + 1; else hi = mid;
      }
      rank = lo;
      for (int j = e; j < L; ++j) {
        const int kj = lkey[j];
        rank += (kj < ki) || (kj == ki && j < i);
      }
    }
    if (kinf < ki) {
      rank += C - nf;
    } else if (kinf == ki && i >= e) {
      rank += fcand[i - e] - (i - e);  // non-fresh candidates before this one
    }
    if (rank < e) {
      tid[rank] = lid[i];
      tdist[rank] = ldist[i];
      texp[rank] = lexp[i];
    }
  }
  __syncwarp();

  // ---- 5. dedupe and write the beam --------------------------------------
  for (int i = lane; i < e; i += 32) {
    const int id = tid[i];
    bool dup = false;
    for (int j = 0; j < i; ++j) dup |= tid[j] == id;
    dup = dup && id >= 0;
    out_ids[(int64_t)b * e + i] = dup ? -1 : id;
    out_dist[(int64_t)b * e + i] = dup ? INFINITY : tdist[i];
    out_exp[(int64_t)b * e + i] = (texp[i] || dup) ? 1 : 0;
  }
}

template <typename T, int TERM>
int launch_expand(const void* q, const void* x, const void* sq_norms, const void* row_scale,
                  const void* cands, const void* beam_ids, const void* beam_dist,
                  const void* beam_exp, void* vis_ids, void* vis_dist, void* out_ids,
                  void* out_dist, void* out_exp, void* comps, int B, int C, int e, int H,
                  int P, int d, int metric, cudaStream_t stream) {
  const bool vec = vec_loads<T>(x, d);
  const int G = row_group_lanes<T>(d, vec);
  const size_t smem = sizeof(float) * kExpandWarps * (size_t)expand_warp_words(C, e, d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_expand_kernel<T, TERM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool qvec = vec_loads<float>(q, d);
  const bool hvec = H >= 4 && reinterpret_cast<uintptr_t>(vis_ids) % 16 == 0;
  fused_expand_kernel<T, TERM><<<(B + kExpandWarps - 1) / kExpandWarps, kExpandWarps * 32,
                                 smem, stream>>>(
      (const float*)q, (const T*)x, (const float*)sq_norms, (const float*)row_scale,
      (const int*)cands, (const int*)beam_ids, (const float*)beam_dist,
      (const uint8_t*)beam_exp, (int*)vis_ids, (float*)vis_dist, (int*)out_ids,
      (float*)out_dist, (uint8_t*)out_exp, (int*)comps, B, C, e, H, P, d, metric, vec,
      qvec, hvec, G);
  return (int)cudaSuccess;
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
    int err = (int)cudaErrorInvalidValue;
#define REPRO_EXPAND_ARGS q, x, sq_norms, row_scale, cands, beam_ids, beam_dist, beam_exp, \
    vis_ids, vis_dist, out_ids, out_dist, out_exp, comps, B, C, e, H, P, d, metric, st
#define REPRO_EXPAND_TERMS(T)                                              \
    switch (metric_term_kind(metric)) {                                     \
      case kTermDot: err = launch_expand<T, kTermDot>(REPRO_EXPAND_ARGS); break; \
      case kTermL1: err = launch_expand<T, kTermL1>(REPRO_EXPAND_ARGS); break;   \
      case kTermChi2: err = launch_expand<T, kTermChi2>(REPRO_EXPAND_ARGS); break; \
    }
    switch (dtype) {
      case kF32: REPRO_EXPAND_TERMS(float) break;
      case kBF16: REPRO_EXPAND_TERMS(__nv_bfloat16) break;
      case kI8: REPRO_EXPAND_TERMS(int8_t) break;
    }
#undef REPRO_EXPAND_TERMS
#undef REPRO_EXPAND_ARGS
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
