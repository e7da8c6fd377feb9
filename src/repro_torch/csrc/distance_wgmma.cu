// pairwise_distance with two bfloat16 operands on Hopper's tensor cores:
// (m, d) x (n, d) bf16 -> (m, n) float32 for the product metrics
//   l2    max(‖q‖² + ‖x‖² − 2 q·x, 0); ‖x‖² from the cache when given
//   ip    −q·x
// at d % 8 == 0 with 16-byte aligned operands.  kernels/distance.py picks
// this form (bf16_form); l1, chi2 and other depths keep the SIMT form of
// distance.cuh (distance_bf16.cu), and cosine normalizes in fp32 and takes
// the fp32 kernel.
//
// Replaces, for bf16 operands, the TPU kernel repro/kernels/distance.py
// pairwise_distance (:147, pallas_call at :223), whose bodies upcast
// whatever they get and multiply on the MXU (_dist_kernel_mxu :41,
// _dist_kernel_mxu_cached :70).  Before this form the bf16 operands ran the
// fp32 SIMT kernel instantiated on bf16: 2·m·n·d FFMA on the CUDA cores,
// 0.124 ms at the 4096² intra-wave tile, d = 128 (H100 80GB HBM3 at 700 W,
// PERF.md).
//
// Bound on an H100: bytes.  The 4096² tile at d = 128 is 4.3 GFLOP of bf16
// products, 4.3 us at the tensor cores' 989 TFLOP/s, against 67 MB of fp32
// output (plus 2 MB of operands), 20.7 us at 3.35 TB/s.  So the store sets
// the time, and the design keeps the store running while the products and
// the loads of the next tile go on:
//   * persistent CTAs, one per SM, walk the 128x128 output tiles in order
//     (tile t: rows t / tiles_n, columns t % tiles_n);
//   * one producer thread streams each tile's operands through a ring of
//     four stages with TMA (cp.async.bulk.tensor, 128-byte swizzle,
//     completion on an mbarrier); a stage is 64 k values of the tile's 128
//     q rows and 128 x rows, so at d = 128 the ring holds two tiles.
//     Depths past d read TMA's out-of-bounds zeros, as do rows past m and
//     n, and every stage runs all four k steps (a wgmma on a divergent path
//     is serialized; a step on zeros adds +0 exactly);
//   * two consumer warpgroups take 64 rows each and run
//     wgmma.mma_async.m64n128k16.f32.bf16.bf16 on the swizzled K-major
//     stages (A and B from shared memory), fp32 sums in registers;
//   * the epilogue writes each warpgroup's 64x128 outputs into shared
//     memory in the 128-byte swizzle (no bank conflicts) and one thread
//     stores them as four TMA boxes (cp.async.bulk.tensor, bulk_group),
//     which clip rows and columns past m and n.  The stores run on while
//     the warpgroups multiply the next tile; a warpgroup waits for them
//     only to read its staging (bulk wait_group.read) before it reuses it.
//     Where n % 4 != 0 (rows not 16-byte aligned, which TMA needs) the
//     epilogue stores 8-byte pairs from registers instead, with 64-bit
//     offsets: a warp's store covers eight rows of 32 contiguous bytes.
// TMA tensor maps need libcuda's cuTensorMapEncodeTiled; the library
// links no libcuda, so the entry point is fetched from the runtime
// (cudaGetDriverEntryPoint[ByVersion]).
//
// Bits.  The norms keep the SIMT kernel's bits: for l2, consumer thread t
// carries the fmaf chain of stage row t (q row t; x row t − 128 where no
// cache is given) over k = 0 .. d-1 in order from 0.f on the widened
// values, reading each stage while the tensor cores multiply it.  The
// epilogue is the SIMT kernel's (_rn intrinsics).  Only q·x departs from
// distance.cuh's in-order fmaf chain: the tensor cores sum the products
// (each exact in fp32: two 8-bit significands) in their own order and
// rounding.  So on integer-valued rows whose partial sums stay integers
// below 2^24 (|v| <= 15, d <= 256) every distance equals the SIMT
// kernel's and the plain version's bit for bit; on real-valued rows each
// is within 1e-5 · (‖q‖² + ‖x‖²) of the fp32 kernel on the widened rows
// (tests/test_torch_cuda.py, chip_smoke.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace wgmma_pairwise {

enum : int { kL2 = 0, kIP = 1 };  // distance.cuh's PairMetric codes

constexpr int kBM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int kBN = 128;  // tile columns: the n of one wgmma
constexpr int kBK = 64;   // a stage's depth: 128 bytes of bf16, the swizzle span
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * 128 + 32;  // the consumers, then the producer warp
constexpr int kTileA = kBM * kBK * 2;
constexpr int kStageBytes = kTileA + kBN * kBK * 2;
constexpr int kStaging = 64 * kBN * 4;  // a warpgroup's fp32 outputs of one tile
// the stages and the staging (1024-byte aligned for the swizzle), the full
// and empty barriers, two tiles' norms, plus room to align the base
constexpr int kSmemBytes =
    kStages * kStageBytes + kConsumers * kStaging + 2 * kStages * 8 + 2 * 2 * kBM * 4 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A box of kBK k values x 128 rows from (k0, row0) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled rows: start
// address, leading offset unused (1), 1024 bytes between 8-row groups,
// layout SWIZZLE_128B.  The k-th 16-wide slice starts 32 bytes on (+2).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += A · Bᵀ for a 64x16 A slice and a 128x16 B slice (both K-major).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));  // scale-d 1: d += A · Bᵀ
}

template <int METRIC>
__device__ __forceinline__ float finish(float dot, float qn, float xn) {
  if (METRIC == kL2) return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot)), 0.f);
  return -dot;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float norm_pair(uint32_t bits, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
  return fmaf(f.y, f.y, fmaf(f.x, f.x, s));
}

// A stage row's squared-norm chain carried over its first `n16` 16-byte
// chunks (8 k values each, in k order), read through the 128-byte swizzle.
__device__ __forceinline__ float chain_row(const uint8_t* row_ptr, int row, int n16, float s) {
#pragma unroll
  for (int c = 0; c < kBK / 8; ++c) {
    if (c < n16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row_ptr + ((c ^ (row & 7)) << 4));
      s = norm_pair(v.x, s);
      s = norm_pair(v.y, s);
      s = norm_pair(v.z, s);
      s = norm_pair(v.w, s);
    }
  }
  return s;
}

// Columns c, c + 1 of row r (c even), clipped to (m, n).
__device__ __forceinline__ void store2(float* __restrict__ out, int r, int c, int m, int n,
                                       float v0, float v1) {
  if (r >= m || c >= n) return;
  float* o = out + (int64_t)r * n + c;
  if ((n & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (c + 1 < n) o[1] = v1;
  }
}

template <int METRIC>
__global__ void __launch_bounds__(kThreads, 1) pairwise_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tout, const float* __restrict__ xn,
    float* __restrict__ out, int m, int n, int d, int tma_out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = base + kStages * kStageBytes;  // kConsumers x kStaging
  const uint32_t full = staging + kConsumers * kStaging;  // full[s] at full + 8 s
  const uint32_t empty = full + kStages * 8;              // empty[s] at empty + 8 s
  // the tile's norms, by tile parity: [0, 128) its q rows, [128, 256) its x rows
  float* norm_s = reinterpret_cast<float*>(smem_raw + (empty + kStages * 8 - smem_u32(smem_raw)));
  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int chunks = (d + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / tiles_n * kBM, col0 = tile % tiles_n * kBN;
        for (int kc = 0; kc < chunks; ++kc) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh barrier passes parity 1
          const uint32_t bar = full + 8 * stage, dst = base + stage * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);
          tma_load(dst, &tq, bar, kc * kBK, row0);
          tma_load(dst + kTileA, &tx, bar, kc * kBK, col0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes tile rows wg*64 .. +63; a thread holds
  // rows r and r + 8 (r = its warp's 16 rows + lane / 4) at columns
  // 8 j + 2 (lane % 4) + {0, 1}, j = 0 .. 15 (the wgmma accumulator layout).
  // For l2, consumer thread t also carries the norm chain of stage row t
  // (q row t, then x row t - 128 where no cache is given).
  const int t = threadIdx.x, wg = warp / 4;
  const int r_wg = (warp % 4) * 16 + lane / 4;  // row within the warpgroup's 64
  const int c_in = (lane % 4) * 2;
  const bool cached = xn != nullptr;
  const bool chains = METRIC == kL2 && (t < kBM || !cached);
  const bool leader = t % 128 == 0;  // issues the warpgroup's stores
  const uint32_t stg = staging + wg * kStaging;
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];
  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int row0 = tile / tiles_n * kBM, col0 = tile % tiles_n * kBN;
    float chain = 0.f;
    if (METRIC == kL2 && cached && t >= kBM) {
      const int c = col0 + t - kBM;
      chain = c < n ? __ldg(xn + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t sa = base + stage * kStageBytes;
      const uint64_t da = sw128_desc(sa + wg * 64 * (kBK * 2)), db = sw128_desc(sa + kTileA);
      // every k step of the stage, those past d on TMA's zeros (each adds
      // +0 exactly): a wgmma on a divergent path would be serialized
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) wgmma_m64n128k16(acc, da + 2 * s, db + 2 * s);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // while the tensor cores multiply: the norm chains over this stage
      // (rows t < 128 are A's, the next 128 B's, contiguous)
      if (chains) {
        const uint8_t* row_ptr = smem_raw + (sa - smem_u32(smem_raw)) + t * (kBK * 2);
        chain = chain_row(row_ptr, t, min(kBK, d - kc * kBK) / 8, chain);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      mbar_arrive(empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    float* nrm = norm_s + (it & 1) * 2 * kBM;
    if (METRIC == kL2) {
      nrm[t] = chain;
      bar_sync(1, kConsumers * 128);
    }
    const int rl = wg * 64 + r_wg;  // tile row of acc[4j], acc[4j + 1]; +8 for the others
    const float qa = METRIC == kL2 ? nrm[rl] : 0.f, qb = METRIC == kL2 ? nrm[rl + 8] : 0.f;
    if (tma_out) {
      // stage the warpgroup's 64 x 128 outputs as four 64 x 32 boxes in the
      // 128-byte swizzle, then one thread stores them with TMA (rows and
      // columns past m and n are clipped); the previous tile's stores must
      // have read the staging first
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = j * 8 + c_in;
        const float xa = METRIC == kL2 ? nrm[kBM + c] : 0.f;
        const float xb = METRIC == kL2 ? nrm[kBM + c + 1] : 0.f;
        const uint32_t box = stg + (c / 32) * (64 * 128), chunk = (c % 32) / 4, within = (c % 4) * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_wg + 8 * h;
          const float v0 = finish<METRIC>(acc[4 * j + 2 * h], h ? qb : qa, xa);
          const float v1 = finish<METRIC>(acc[4 * j + 2 * h + 1], h ? qb : qa, xb);
          const uint32_t addr = box + r * 128 + ((chunk ^ (r & 7)) << 4) + within;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0), "f"(v1)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(2 + wg, 128);
      if (leader) {
#pragma unroll
        for (int b = 0; b < kBN / 32; ++b) {
          asm volatile(
              "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                  reinterpret_cast<uint64_t>(&tout)),
              "r"(stg + b * (64 * 128)), "r"(col0 + b * 32), "r"(row0 + wg * 64)
              : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      const int ra = row0 + rl, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = j * 8 + c_in;
        const float xa = METRIC == kL2 ? nrm[kBM + c] : 0.f;
        const float xb = METRIC == kL2 ? nrm[kBM + c + 1] : 0.f;
        store2(out, ra, col0 + c, m, n, finish<METRIC>(acc[4 * j], qa, xa),
               finish<METRIC>(acc[4 * j + 1], qa, xb));
        store2(out, rb, col0 + c, m, n, finish<METRIC>(acc[4 * j + 2], qb, xa),
               finish<METRIC>(acc[4 * j + 3], qb, xb));
      }
    }
  }
  if (tma_out && leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A row-major (rows, cols) matrix as TMA boxes of box_cols x box_rows in
// the 128-byte swizzle; loads read zeros out of bounds, stores clip there.
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
               int64_t rows, int cols, int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elems[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elems,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int METRIC>
int launch(const CUtensorMap& tq, const CUtensorMap& tx, const CUtensorMap& tout,
           const float* xn, float* out, int m, int n, int d, int tma_out, int grid,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(pairwise_wgmma_kernel<METRIC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  pairwise_wgmma_kernel<METRIC>
      <<<grid, kThreads, kSmemBytes, s>>>(tq, tx, tout, xn, out, m, n, d, tma_out);
  return (int)cudaGetLastError();
}

}  // namespace wgmma_pairwise
}  // namespace repro_torch

// q (m, d) and x (n, d) bf16, 16-byte aligned, d % 8 == 0; metric 0 (l2,
// x_sq_norms the ‖x‖² cache or NULL) or 1 (ip).  out (m, n) float32.
extern "C" int launch_pairwise_distance_wgmma(const void* q, const void* x,
                                              const void* x_sq_norms, void* out, int m, int n,
                                              int d, int metric, void* stream) {
  using namespace repro_torch::wgmma_pairwise;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if ((metric != kL2 && metric != kIP) || d <= 0 || d % 8 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (int64_t)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // TMA stores need 16-byte output rows; other widths store from registers
  const int tma_out = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap tq, tx, tout = {};
  int rc = tensor_map(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, m, d, kBK, kBM);
  if (rc == 0) rc = tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, n, d, kBK, kBN);
  if (rc == 0 && tma_out)
    rc = tensor_map(&tout, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, m, n, 32, 64);
  if (rc != 0) return rc;
  const int grid = (int)(tiles < sms ? tiles : sms);
  const float* xn = metric == kL2 ? (const float*)x_sq_norms : nullptr;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  return metric == kL2 ? launch<kL2>(tq, tx, tout, xn, o, m, n, d, tma_out, grid, s)
                       : launch<kIP>(tq, tx, tout, xn, o, m, n, d, tma_out, grid, s);
}
