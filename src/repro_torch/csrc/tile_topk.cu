// tile_topk: one tile of core/brute.brute_force_knn's running top-k.
// (m, T) float32 distances of a tile and the running best (m, k) -> the new
// best (m, k): for each query row, the k smallest of the k running entries
// followed by the T tile entries, ascending.
//
// Replaces no TPU kernel: the reference's running top-k is lax.top_k
// (repro/kernels/ref.py topk_smallest) over the concatenation of the best
// and the masked tile.  The port's plain version (kernels/ref.py tile_topk)
// masks the tile with torch.where, concatenates, and stable-sorts every row
// of k + T keys in full to keep k of them; on the card that pass took 93% of
// an exact 10,000 x 10^6 call (PERF.md).
//
// What it returns, bit for bit the plain version's: the concatenation's
// column c (c < k: the running best's entry c; c >= k: tile column c - k,
// id lo + c - k) is ordered by the unique 64-bit key
//   (sort_key(d) << 32) | c,   sort_key = the IEEE total order of ref.sort_key
// (-0.0 before +0.0, NaN above +inf), so ties go to the lower column as in
// the stable sort: the running best beats the tile, an earlier tile column a
// later one.  A tile column that fails the mask (id >= n_valid, not alive,
// or the row's excluded id) enters at +inf with its own id, as in the plain
// version.  A distance is never recomputed: sort_key is a bijection on the
// bits, and the output's distance is the key's high word mapped back.
//
// Bound on an H100: bytes.  The tile is read once (m * T * 4 bytes: 327.7 MB
// at 10,000 x 8,192, 0.098 ms at 3.35 TB/s); the best, the masks and the
// output are m * k sized.  Compares are one per tile entry.
//
// Design: Faiss's warp select (Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs").  One warp per query row keeps the row's
// list of the L smallest keys seen, L = the power of two >= max(k, 32)
// (a template parameter picked from k, the one input the code adapts to),
// sorted, in registers: element e = i * 32 + lane is register i of lane
// lane.  It starts from the incoming best (bitonic-sorted, so any order is
// taken), and the warp reads its row of the tile as coalesced 16-byte
// loads (4-byte loads where the row is not 16-byte aligned), applies the
// mask in registers and compares each key with the list's k-th key, held in
// registers: a rejected entry costs that compare.  After the first tile of
// a call almost every entry is rejected, and a chunk whose 32 lanes reject
// everything leaves the fast loop at once.  Accepted keys:
//   L == 32 (k <= 32): inserted one at a time, the lowest accepting lane
//   first (ballot), by a shuffle of the list one lane up from the key's
//   rank;
//   L >= 64: queued in a per-lane queue of L / 32 keys; when a lane would
//   overflow, and at the end of the row, the warp sorts the queues (bitonic)
//   and merges them with the list: the element-wise min of the list and the
//   reversed queue is a bitonic sequence holding the L smallest of both,
//   which a bitonic merge sorts (one out-of-line function, merge_queues).
// Every accepted key is re-tested against the k-th key after each insertion
// or merge, so the k smallest keys are exact whatever the order the lanes
// offer them in: the keys are unique.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;            // query rows (warps) per block
constexpr int kVec = 4;              // float4 loads in flight per lane
constexpr int kScalar = 8;           // 4-byte loads in flight per lane (unaligned rows)
constexpr long long kEmpty = 0x7fffffffffffffffLL;  // above every real key
constexpr int kInfKey = 0x7f800000;  // sort_key(+inf)

__device__ __forceinline__ int sort_key(float d) {
  const int b = __float_as_int(d);
  return b < 0 ? b ^ 0x7fffffff : b;
}

__device__ __forceinline__ float key_dist(long long key) {
  const int s = (int)(key >> 32);
  return __int_as_float(s < 0 ? s ^ 0x7fffffff : s);
}

__device__ __forceinline__ long long make_key(int sk, unsigned col) {
  return (long long)(((unsigned long long)(unsigned)sk << 32) | col);
}

__device__ __forceinline__ long long kmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long kmax(long long a, long long b) { return a < b ? b : a; }

// One compare-exchange stage of a bitonic network over the warp's L = 32 R
// elements (element e = i * 32 + lane): partner e ^ j; the pair is put in
// ascending order where (e & size) == 0 and descending elsewhere (size = L:
// all ascending).
template <int R>
__device__ __forceinline__ void bitonic_stage(long long (&v)[R], int lane, int size, int j) {
  if (j < 32) {
    const bool low = (lane & j) == 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long o = __shfl_xor_sync(kFull, v[i], j);
      const bool asc = ((i * 32 + lane) & size) == 0;
      v[i] = (low == asc) ? kmin(v[i], o) : kmax(v[i], o);
    }
  } else {
    const int jj = j >> 5;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = i ^ jj;
      if (p > i) {
        const bool asc = ((i * 32 + lane) & size) == 0;
        const long long a = v[i], b = v[p];
        v[i] = asc ? kmin(a, b) : kmax(a, b);
        v[p] = asc ? kmax(a, b) : kmin(a, b);
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void bitonic_sort(long long (&v)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= R * 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) bitonic_stage<R>(v, lane, size, j);
  }
}

// Sorts a bitonic sequence ascending.
template <int R>
__device__ __forceinline__ void bitonic_merge(long long (&v)[R], int lane) {
#pragma unroll
  for (int j = R * 16; j > 0; j >>= 1) bitonic_stage<R>(v, lane, R * 32, j);
}

template <int R>
__device__ __forceinline__ long long element(const long long (&v)[R], int e) {
  long long x = v[0];
#pragma unroll
  for (int i = 1; i < R; ++i) {
    if (i == (e >> 5)) x = v[i];
  }
  return __shfl_sync(kFull, x, e & 31);
}

// L >= 64: merges the warp's per-lane queues (R keys a lane, kEmpty where
// unused) into its sorted list of L = 32 R keys and empties them; returns
// the list's k-th key.  Kept out of line: the slow path calls it from every
// candidate slot of a chunk, and inlined copies of its sorting networks
// made the L = 1,024 instantiation too large to compile in reasonable time.
// The arrays live in local memory for the call; the fast path never reads
// them.
template <int R>
__device__ __noinline__ long long merge_queues(long long* list, long long* queue, int k,
                                               int lane) {
  long long l[R], q[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    l[i] = list[i];
    q[i] = queue[i];
  }
  bitonic_sort<R>(q, lane);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long r = __shfl_sync(kFull, q[R - 1 - i], 31 - lane);
    l[i] = kmin(l[i], r);
  }
  // the min of an ascending and a descending sequence is bitonic
  bitonic_merge<R>(l, lane);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    list[i] = l[i];
    queue[i] = kEmpty;
  }
  return element<R>(l, k - 1);
}

// The warp's sorted list of the L smallest keys seen, and (L >= 64) the
// per-lane queues of accepted keys not yet merged into it.
template <int R>
struct Select {
  long long list[R];
  long long queue[R];
  int queued;
  long long kth;  // the list's k-th key: a key is taken when below it
  int k, lane;

  // The incoming best, element e = best column e (e < k), in any order.
  __device__ __forceinline__ void start(const float* best_d) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = i * 32 + lane;
      const long long key = c < k ? make_key(sort_key(best_d[c]), (unsigned)c) : kEmpty;
      list[i] = R == 1 ? key : kEmpty;
      queue[i] = R == 1 ? kEmpty : key;
    }
    queued = 0;
    if constexpr (R == 1) {
      bitonic_sort<R>(list, lane);
      kth = element<R>(list, k - 1);
    } else {
      kth = merge_queues<R>(list, queue, k, lane);
    }
  }

  // Every lane of the warp calls this with its own candidate key.
  __device__ __forceinline__ void offer(long long key) {
    if constexpr (R == 1) {
      unsigned take = __ballot_sync(kFull, key < kth);
      while (take) {
        const int src = __ffs(take) - 1;
        const long long c = __shfl_sync(kFull, key, src);
        // c is below the k-th key, so its rank p is at most k - 1 <= 31
        const int p = __popc(__ballot_sync(kFull, list[0] < c));
        const long long up = __shfl_up_sync(kFull, list[0], 1);
        if (lane == p) list[0] = c;
        else if (lane > p) list[0] = up;
        kth = __shfl_sync(kFull, list[0], k - 1);
        take &= take - 1;
        take &= __ballot_sync(kFull, key < kth);
      }
    } else {
      bool take = key < kth;
      if (__any_sync(kFull, take && queued == R)) {
        kth = merge_queues<R>(list, queue, k, lane);
        queued = 0;
        take = key < kth;
      }
      if (take) queue[queued++] = key;
    }
  }

  __device__ __forceinline__ void finish() {
    if constexpr (R > 1) {
      if (__any_sync(kFull, queued > 0)) {
        kth = merge_queues<R>(list, queue, k, lane);
        queued = 0;
      }
    }
  }
};

struct Tile {
  const float* row;            // the row's T distances
  const unsigned char* alive;  // the tile's slice, n_alive long, or null
  long long excl;              // the row's excluded id
  bool has_excl;
  int lo, lim;                 // columns j < lim pass the n_valid test and lie in alive's slice

  // The key of tile column j, j < T (masked: +inf).
  __device__ __forceinline__ int masked_key(float d, int j) const {
    const bool ok = j < lim && (alive == nullptr || alive[j] != 0) &&
                    (!has_excl || (long long)(lo + j) != excl);
    return ok ? sort_key(d) : kInfKey;
  }
};

// Offers the N keys of one chunk; returns at once when no lane of the warp
// takes any of them.
template <int R, int N>
__device__ __forceinline__ void offer_chunk(Select<R>& sel, const int (&sk)[N],
                                            const unsigned (&col)[N]) {
  const int hi = (int)(sel.kth >> 32);
  const unsigned low = (unsigned)sel.kth;
  bool any = false;
#pragma unroll
  for (int n = 0; n < N; ++n) any |= sk[n] < hi || (sk[n] == hi && col[n] < low);
  if (!__any_sync(kFull, any)) return;
#pragma unroll
  for (int n = 0; n < N; ++n) sel.offer(make_key(sk[n], col[n]));
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32)
tile_topk_kernel(const float* __restrict__ dt, const float* __restrict__ best_d,
                 const int* __restrict__ best_i, const unsigned char* __restrict__ alive,
                 const long long* __restrict__ excl, float* __restrict__ out_d,
                 int* __restrict__ out_i, int m, int T, int k, int lo, long long n_valid,
                 int n_alive) {
  constexpr int R = L / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp: row is the warp's

  Select<R> sel;
  sel.k = k;
  sel.lane = lane;
  sel.start(best_d + (size_t)row * k);

  Tile t;
  t.row = dt + (size_t)row * T;
  t.alive = alive;
  t.has_excl = excl != nullptr;
  t.excl = t.has_excl ? excl[row] : 0;
  t.lo = lo;
  long long lim = n_valid - (long long)lo;
  lim = lim < 0 ? 0 : (lim > T ? T : lim);
  if (alive != nullptr && lim > n_alive) lim = n_alive;
  t.lim = (int)lim;

  int j0 = 0;  // first column of the scalar loop
  if ((reinterpret_cast<uintptr_t>(t.row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(t.row);
    const int n4 = T >> 2;
    for (int base = 0; base < n4; base += 32 * kVec) {
      float4 v[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int idx = base + u * 32 + lane;
        v[u] = idx < n4 ? __ldcs(row4 + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      int sk[4 * kVec];
      unsigned col[4 * kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int idx = base + u * 32 + lane;
        const float d[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * idx + c;
          const bool in = idx < n4;
          sk[4 * u + c] = in ? t.masked_key(d[c], j) : 0x7fffffff;
          col[4 * u + c] = in ? (unsigned)(k + j) : 0xffffffffu;
        }
      }
      offer_chunk<R, 4 * kVec>(sel, sk, col);
    }
    j0 = n4 << 2;
  }
  for (int base = j0; base < T; base += 32 * kScalar) {
    float v[kScalar];
#pragma unroll
    for (int s = 0; s < kScalar; ++s) {
      const int j = base + s * 32 + lane;
      v[s] = j < T ? __ldcs(t.row + j) : 0.f;
    }
    int sk[kScalar];
    unsigned col[kScalar];
#pragma unroll
    for (int s = 0; s < kScalar; ++s) {
      const int j = base + s * 32 + lane;
      sk[s] = j < T ? t.masked_key(v[s], j) : 0x7fffffff;
      col[s] = j < T ? (unsigned)(k + j) : 0xffffffffu;
    }
    offer_chunk<R, kScalar>(sel, sk, col);
  }
  sel.finish();

  const int* bi = best_i + (size_t)row * k;
  float* od = out_d + (size_t)row * k;
  int* oi = out_i + (size_t)row * k;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = i * 32 + lane;
    if (e < k) {
      const long long key = sel.list[i];
      const unsigned c = (unsigned)key;
      od[e] = key_dist(key);
      oi[e] = c < (unsigned)k ? bi[c] : lo + (int)(c - (unsigned)k);
    }
  }
}

template <int L>
cudaError_t launch(const void* dt, const void* best_d, const void* best_i, const void* alive,
                   const void* excl, void* out_d, void* out_i, int m, int T, int k, int lo,
                   long long n_valid, int n_alive, cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps), block(kWarps * 32);
  tile_topk_kernel<L><<<grid, block, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(best_d),
      static_cast<const int*>(best_i), static_cast<const unsigned char*>(alive),
      static_cast<const long long*>(excl), static_cast<float*>(out_d), static_cast<int*>(out_i),
      m, T, k, lo, n_valid, n_alive);
  return cudaGetLastError();
}

}  // namespace

// dt (m, T) float32; best_d (m, k) float32; best_i (m, k) int32; alive
// (n_alive,) bool, the tile's slice, or null; excl (m,) int64 or null;
// out_d (m, k) float32; out_i (m, k) int32.  1 <= k <= 1024, m >= 1.
extern "C" int launch_tile_topk(const void* dt, const void* best_d, const void* best_i,
                                const void* alive, const void* excl, void* out_d, void* out_i,
                                int m, int T, int k, int lo, long long n_valid, int n_alive,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch<32>(dt, best_d, best_i, alive, excl, out_d, out_i, m, T, k, lo, n_valid, n_alive, s);
  if (k <= 64) return launch<64>(dt, best_d, best_i, alive, excl, out_d, out_i, m, T, k, lo, n_valid, n_alive, s);
  if (k <= 128) return launch<128>(dt, best_d, best_i, alive, excl, out_d, out_i, m, T, k, lo, n_valid, n_alive, s);
  if (k <= 256) return launch<256>(dt, best_d, best_i, alive, excl, out_d, out_i, m, T, k, lo, n_valid, n_alive, s);
  if (k <= 512) return launch<512>(dt, best_d, best_i, alive, excl, out_d, out_i, m, T, k, lo, n_valid, n_alive, s);
  if (k <= 1024) return launch<1024>(dt, best_d, best_i, alive, excl, out_d, out_i, m, T, k, lo, n_valid, n_alive, s);
  return cudaErrorInvalidValue;
}
