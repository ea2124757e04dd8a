// The kernels of the Montgomery-product decomposition benchmarks
// (snark_tpu_torch/bench_reduce_parts.py, bench_bisect_mul.py), the
// counterparts of the Pallas kernels of scripts/bench_reduce_parts.py and
// scripts/bench_bisect_mul.py. Both work on (34, lanes) float32 digit planes
// of BN254 Fq with two extra digits, the scripts' planes, 8 reps deep (the
// scripts' REPS), with the field's device code from plane_v3.cuh. One
// thread owns one lane at a time: its digits live in registers.
//
// The scripts' TPU block width T (lanes a grid step) becomes the lanes a
// block covers: a block of 256 threads walks its T lanes, T / 256 to a
// thread (2 at T = 512, 8 at T = 2048), and K16 A loads its band fragments
// once a block for all of them. So the grid is lanes / T blocks: 256 at
// the scripts' 131,072 lanes and T = 512, 64 at T = 2048, fewer than the
// card's 132 SMs. Each C entry point returns cudaGetLastError() after its
// launch.
//
// K16 reduce_parts_chain<kind> replaces make_run(kind, T).run
//   (scripts/bench_reduce_parts.py:100, pallas_call at :101):
//   A: A <- mont_mul(A, B) with the carry column and plus_p = 2p, its two
//      constant multiplies (m = tlo N' mod R, m p) as products by the band
//      matrices M_NP (34 x 34) and M_P (68 x 34) on the tensor cores, as the
//      reference runs them on the MXU (snark_tpu/ops/pallas_field_v3.py:
//      228-231). Each warp takes its 32 lanes as the N of warp-level
//      mma.sync.m16n8k16 bf16 products with float32 sums: the lanes' digits
//      (tlo, then m) go through shared memory as bf16 pairs into B
//      fragments, k padded from 34 to 48; the band matrices are A fragments
//      (M_NP padded to 48 rows, M_P to 80), packed by the wrapper and copied
//      to shared memory once a block; the float32 C fragments come back
//      through shared memory to each lane's registers. Tiles above or below
//      the band, and M_P's row tiles below the rows that reach the carry,
//      are skipped at compile time: 24 + 32 mma a warp and rep. Every digit
//      is an integer in [0, 256] (bf16-exact), every product below 2^16 and
//      every sum below 2^22, so the products are exact in any float32
//      accumulation that keeps 23 bits; the equality with the plain version
//      and with C checks that on the card.
//   B: the script's elementwise skeleton, t = A B, then
//      A = sweep3(sweep3(sweep3(t[:34])) + 2p); not a product.
//   C: A <- mont_mul(A, B) with the constant multiplies as scalar FMAs (the
//      script's reduce_vpu, :59-75): the shared scalar-constant reduction of
//      K15, which skips the zero digits the script multiplies and the rows
//      nothing reads; the sums are exact integers, so the digits are the
//      script's.
//   Bound (H100): FP32 operations in every kind (wrapper: mul_parts.py).
//   A's 3,468 useful bf16 multiply-adds a lane and rep (34 x 34 + 68 x 34)
//   take a tenth of its FP32 instructions' time at the published dense
//   bf16 rate, so the tensor cores do not bound it; what A adds over C is
//   the staging through shared memory and the fragment loads, against the
//   scalar FMAs of the two convolutions that it saves.
// K17 bisect_chain<kind> replaces make_run(kind).run
//   (scripts/bench_bisect_mul.py:98, pallas_call at :99), T = 512:
//   conv0:   t = A B, A = t[:34] 1e-7;
//   conv1:   t = A B, A = sweep(t[:34]);
//   conv3:   t = A B, A = sweep3(t[:34]);
//   conv9:   t = A B, A = sweep3(sweep3(sweep3(t[:34])));
//   sweep9:  A = sweep^9(A) + 1, no product;
//   convreg: t[k] = sum_i A[i] B[k - i], one register sum per output digit,
//            k outermost (the script accumulates values, not scratch
//            rows), then A = sweep3(t[:34]).
//   conv3, conv9, convreg and sweep9 stay integers below 2^24 and use FMAs.
//   conv0 and conv1 leave that range (conv1 reaches 1.5e11), so their
//   product rounds each term's product and sum in the plain version's
//   order, and every kind equals its plain version bit for bit. Only
//   t[:34] is read, so the compiler drops the high half of the product.
//   Bound: FP32 operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_v3.cuh"

namespace snark {

constexpr int kPartsRows = 34;
constexpr int kPartsThreads = 256;
constexpr int kPartsWarps = kPartsThreads / 32;
constexpr int kKTiles = 3;             // k of both band products: 34 padded to 3 x 16
constexpr int kNpMTiles = 3;           // M_NP's 34 rows padded to 48
constexpr int kPMTiles = 5;            // M_P's 68 rows padded to 80
constexpr int kBandTiles = (kNpMTiles + kPMTiles) * kKTiles;  // A fragments, M_NP's first
constexpr int kPairRows = 8 * kKTiles;  // bf16 pairs of a staged lane column (k = 48)
constexpr int kBStride = 40;  // words a pair row: B fragment loads hit 32 banks
constexpr int kCStride = 40;  // floats a staged C row: float2 stores hit 32 banks
constexpr int kWarpSmem = kPairRows * kBStride * 4 + 16 * kCStride * 4;
constexpr int kPartsSmem = kBandTiles * 32 * 16 + kPartsWarps * kWarpSmem;  // 63,488 bytes

enum PartsKind { kPartsA = 0, kPartsB = 1, kPartsC = 2 };
enum BisectKind { kConv0 = 0, kConv1 = 1, kConv3 = 2, kConv9 = 3, kSweep9 = 4, kConvReg = 5 };

// Bit mt * kKTiles + kt is set where tile (mt, kt) of a padded band
// matrix (M_NP[k][i] = np(k - i) on R rows, or M_P[k][i] = p(k - i) on 2R
// rows; i < R) holds a nonzero digit on a row >= min_row.
template <class F>
__host__ __device__ constexpr unsigned band_tiles(bool p_band, int min_row) {
  const int R = F::kRows;
  const int rows = p_band ? 2 * R : R;
  unsigned mask = 0;
  for (int mt = 0; mt < (p_band ? kPMTiles : kNpMTiles); ++mt)
    for (int kt = 0; kt < kKTiles; ++kt)
      for (int k = 16 * mt; k < 16 * mt + 16 && k < rows; ++k)
        for (int i = 16 * kt; i < 16 * kt + 16 && i < R; ++i) {
          const int d = k - i;
          if (k >= min_row && d >= 0 && d < R && (p_band ? F::p(d) : F::np(d)) != 0.0f)
            mask |= 1u << (mt * kKTiles + kt);
        }
  return mask;
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b on the tensor cores, one warp: a 16 x 16 bf16 A fragment, a
// 16 x 8 B fragment, a 16 x 8 float32 C fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The warp's 32 lane columns of R digits as the B operand: word
// [k / 2][lane] of sB holds digits k and k + 1 of that lane, k + 1 in the
// high half. Pair rows R / 2 and up stay zero (set once a block).
template <int R>
__device__ __forceinline__ void stage_b(const float (&x)[R], uint32_t* sB, int lane) {
#pragma unroll
  for (int k2 = 0; k2 < R / 2; ++k2) sB[k2 * kBStride + lane] = bf16_pair(x[2 * k2], x[2 * k2 + 1]);
  __syncwarp();
}

// Rows 16 mt .. 16 mt + 15 of (band matrix) (staged B) for this lane's
// column: the live tiles of row band mt, each times the warp's 4 n tiles of
// 8 lanes. Fragment layouts (PTX ISA, m16n8k16, g = lane / 4, q = lane % 4):
// A regs hold (row g, cols 2q, 2q+1), (g + 8, 2q..), (g, 2q + 8..),
// (g + 8, 2q + 8..); B regs (k = 2q, 2q + 1; n = g), (k = 2q + 8, 2q + 9);
// C (row g, cols 2q, 2q + 1), (row g + 8, same cols).
template <unsigned kLive>
__device__ __forceinline__ void band_rows(const uint4* sA, int mt, const uint32_t* sB, float* sC,
                                          int lane, float (&col)[16]) {
  const int g = lane >> 2, q = lane & 3;
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
  }
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
    if (!((kLive >> (mt * kKTiles + kt)) & 1u)) continue;
    const uint4 a = sA[(mt * kKTiles + kt) * 32 + lane];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t b0 = sB[(8 * kt + q) * kBStride + 8 * nt + g];
      const uint32_t b1 = sB[(8 * kt + q + 4) * kBStride + 8 * nt + g];
      mma_bf16(acc[nt], a, b0, b1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(&sC[g * kCStride + 8 * nt + 2 * q]) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(&sC[(g + 8) * kCStride + 8 * nt + 2 * q]) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) col[r] = sC[r * kCStride + lane];
  __syncwarp();
}

// A = reduce(t) + 2p with the band-product backend (the reference's reduce
// with m_np, m_p given): m = sweep3(M_NP tlo), s = t + M_P m, both products
// on the tensor cores; t is clobbered. All 32 lanes of the warp call it
// together.
template <class F>
__device__ __forceinline__ void reduce_band(float (&t)[2 * F::kRows], float (&A)[F::kRows],
                                            const uint4* sA, uint32_t* sB, float* sC, int lane) {
  constexpr int R = F::kRows;
  constexpr int kLow = R - kCarryRows;  // rows of s below it are never read
  constexpr unsigned kNpLive = band_tiles<F>(false, 0);
  constexpr unsigned kPLive = band_tiles<F>(true, kLow);
  constexpr unsigned kRowBand = (1u << kKTiles) - 1u;
  float u[R];
  reduce_low<R>(t, u);  // tlo
  stage_b<R>(u, sB, lane);
#pragma unroll
  for (int mt = 0; mt < kNpMTiles; ++mt) {
    float col[16];
    band_rows<kNpLive>(sA, mt, sB, sC, lane, col);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (16 * mt + r < R) u[16 * mt + r] = col[r];
    }
  }
  sweep3<R>(u);  // m
  stage_b<R>(u, sB, lane);
#pragma unroll
  for (int mt = 0; mt < kPMTiles; ++mt) {
    if (!((kPLive >> (mt * kKTiles)) & kRowBand)) continue;
    float col[16];
    band_rows<kPLive>(sA + kNpMTiles * kKTiles * 32, mt, sB, sC, lane, col);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int k = 16 * mt + r;
      if (k >= kLow && k < 2 * R) t[k] = __fadd_rn(t[k], col[r]);
    }
  }
  reduce_out<F>(t, A);
}

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

template <int Kind>
__global__ void __launch_bounds__(kPartsThreads)
    reduce_parts_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, const uint4* __restrict__ frags,
                              int lanes, int lanes_per_block, int reps) {
  using F = Bn254Fq34;
  constexpr int R = F::kRows;
  extern __shared__ uint4 parts_smem[];
  const int lane = threadIdx.x & 31;
  uint4* sA = parts_smem;
  char* warp_smem = reinterpret_cast<char*>(sA + kBandTiles * 32) + (threadIdx.x >> 5) * kWarpSmem;
  uint32_t* sB = reinterpret_cast<uint32_t*>(warp_smem);
  float* sC = reinterpret_cast<float*>(warp_smem + kPairRows * kBStride * 4);
  if constexpr (Kind == kPartsA) {
    for (int i = threadIdx.x; i < kBandTiles * 32; i += kPartsThreads) sA[i] = frags[i];
    for (int i = R / 2 * kBStride + lane; i < kPairRows * kBStride; i += 32) sB[i] = 0u;
    __syncthreads();
  }
  const int l0 = blockIdx.x * lanes_per_block;
  for (int l = l0 + threadIdx.x; l < l0 + lanes_per_block; l += kPartsThreads) {
    float A[R], B[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      A[i] = a[(size_t)i * lanes + l];
      B[i] = b[(size_t)i * lanes + l];
    }
    for (int rep = 0; rep < reps; ++rep) {
      float t[2 * R];
      mul_acc<R, true>(A, B, t);
      if constexpr (Kind == kPartsA) {
        reduce_band<F>(t, A, sA, sB, sC, lane);
      } else if constexpr (Kind == kPartsB) {
#pragma unroll
        for (int i = 0; i < R; ++i) A[i] = t[i];
        sweep3<R>(A);
        sweep3<R>(A);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (F::p2(j) != 0.0f) A[j] = __fadd_rn(A[j], F::p2(j));
        }
        sweep3<R>(A);
      } else {
        reduce_scalar<F>(t, A);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) out[(size_t)i * lanes + l] = A[i];
  }
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

template <int Kind>
__global__ void __launch_bounds__(kPartsThreads)
    bisect_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out, int lanes, int lanes_per_block, int reps) {
  constexpr int R = kPartsRows;
  const int l0 = blockIdx.x * lanes_per_block;
  for (int l = l0 + threadIdx.x; l < l0 + lanes_per_block; l += kPartsThreads) {
    float A[R], B[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      A[i] = a[(size_t)i * lanes + l];
      B[i] = b[(size_t)i * lanes + l];
    }
    for (int rep = 0; rep < reps; ++rep) {
      if constexpr (Kind == kSweep9) {
#pragma unroll
        for (int s = 0; s < 9; ++s) sweep<R>(A);
#pragma unroll
        for (int i = 0; i < R; ++i) A[i] = __fadd_rn(A[i], 1.0f);
      } else if constexpr (Kind == kConvReg) {
        float t[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i <= k; ++i) acc = __fmaf_rn(A[i], B[k - i], acc);
          t[k] = acc;
        }
        sweep3<R>(t);
#pragma unroll
        for (int i = 0; i < R; ++i) A[i] = t[i];
      } else {
        float t[2 * R];
        mul_acc<R, (Kind != kConv0 && Kind != kConv1)>(A, B, t);
#pragma unroll
        for (int i = 0; i < R; ++i) A[i] = Kind == kConv0 ? __fmul_rn(t[i], 1e-7f) : t[i];
        if constexpr (Kind == kConv1) sweep<R>(A);
        if constexpr (Kind == kConv3 || Kind == kConv9) sweep3<R>(A);
        if constexpr (Kind == kConv9) {
          sweep3<R>(A);
          sweep3<R>(A);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) out[(size_t)i * lanes + l] = A[i];
  }
}

static bool bad_tiling(int lanes, int lanes_per_block) {
  return lanes <= 0 || lanes_per_block <= 0 || lanes_per_block % kPartsThreads != 0 ||
         lanes % lanes_per_block != 0;
}

}  // namespace snark

using namespace snark;

extern "C" int snark_reduce_parts_chain(const void* a, const void* b, void* out, const void* frags,
                                        int lanes, int kind, int lanes_per_block, int reps,
                                        void* stream) {
  if (bad_tiling(lanes, lanes_per_block) || (kind == kPartsA && frags == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(lanes / lanes_per_block);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  float* fo = (float*)out;
  const uint4* fr = (const uint4*)frags;
  switch (kind) {
    case kPartsA: {
      const cudaError_t e = cudaFuncSetAttribute(reduce_parts_chain_kernel<kPartsA>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kPartsSmem);
      if (e != cudaSuccess) return (int)e;
      reduce_parts_chain_kernel<kPartsA><<<grid, kPartsThreads, kPartsSmem, s>>>(
          fa, fb, fo, fr, lanes, lanes_per_block, reps);
      break;
    }
    case kPartsB:
      reduce_parts_chain_kernel<kPartsB><<<grid, kPartsThreads, 0, s>>>(
          fa, fb, fo, fr, lanes, lanes_per_block, reps);
      break;
    case kPartsC:
      reduce_parts_chain_kernel<kPartsC><<<grid, kPartsThreads, 0, s>>>(
          fa, fb, fo, fr, lanes, lanes_per_block, reps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int snark_bisect_chain(const void* a, const void* b, void* out, int lanes, int kind,
                                  int lanes_per_block, int reps, void* stream) {
  if (bad_tiling(lanes, lanes_per_block)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(lanes / lanes_per_block);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  float* fo = (float*)out;
#define SNARK_BISECT(K)                                                                     \
  case K:                                                                                   \
    bisect_chain_kernel<K><<<grid, kPartsThreads, 0, s>>>(fa, fb, fo, lanes, lanes_per_block, \
                                                          reps);                            \
    break;
  switch (kind) {
    SNARK_BISECT(kConv0)
    SNARK_BISECT(kConv1)
    SNARK_BISECT(kConv3)
    SNARK_BISECT(kConv9)
    SNARK_BISECT(kSweep9)
    SNARK_BISECT(kConvReg)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SNARK_BISECT
  return (int)cudaGetLastError();
}
