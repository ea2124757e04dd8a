// The kernels of the Montgomery-product decomposition benchmarks
// (snark_tpu_torch/bench_reduce_parts.py, bench_bisect_mul.py), the
// counterparts of the Pallas kernels of scripts/bench_reduce_parts.py and
// scripts/bench_bisect_mul.py. Both work on (34, lanes) float32 digit planes
// of BN254 Fq with two extra digits, the scripts' planes, 8 reps deep (the
// scripts' REPS), with the field's device code from plane_v3.cuh. One
// thread owns one lane at a time: its digits live in registers.
//
// Launch geometry. The scripts' TPU block width T sets nothing here: it
// names the line and must divide the lanes, nothing more (it set the grid
// before, lanes / T blocks of 256 threads: 64 blocks on 132 SMs at T =
// 2048). The wrapper passes the grid, block and shared memory that
// ops/mul_parts.py launch_geometry computes, and bad_tiling refuses any
// other. One lane a thread, a block a tile of lanes, whatever T, in one of
// two forms, each where it measured faster on the card:
//   walking (K16 B; K17 conv0, conv1, conv3, conv9, convreg): a grid of the
//     blocks the card keeps resident (528 on 132 SMs), block k taking tiles
//     k, k + grid, ...; each block fetches its next tile's digit rows into
//     shared memory by 16-byte cp.async copies while it computes the
//     current one, so the loads of the next lane overlap the products
//     (conv0 ran 0.056-0.057 ms against 0.060-0.064 as one block a tile);
//   one block a tile (K16 A, C; K17 sweep9): A has no shared memory left
//     for a tile buffer; C, one block an SM, ran 0.167-0.171 ms walking
//     against 0.160-0.164; sweep9, at 64 registers, keeps eight blocks an
//     SM resident without a buffer and six with one (0.0548 against
//     0.047-0.050).
// __launch_bounds__ sets the registers: every K17 kind and K16 B run
// 128-thread blocks, four an SM (16 warps, at most 128 registers a
// thread); K16 A runs 256-thread blocks, two an SM (16 warps, 128
// registers), its 8 warps sharing the band fragments; K16 C runs
// 256-thread blocks, one an SM (8 warps, 233 registers): at 16 warps and
// 128 registers it took 0.21-0.22 ms on the card against 0.16, as the
// compiler then issues its reduce_low, reduce_np and their sweeps as two
// or three chains of dependent FMAs (1,189 instructions read a result from
// less than four instructions before, against 3 at 233 registers). Each C
// entry point returns cudaGetLastError() after its launch, and
// snark_parts_occupancy gives the blocks an SM keeps resident.
//
// The sweeps' floor: every K16 kind and K17's conv3, conv9, sweep9 and
// convreg take plane_v3.cuh's round-down floor (sweep<R, true>), an FFMA
// and an FADD at the full FP32 rate in place of floorf's FRND, which
// issues at an eighth of it (16 a clock an SM, measured); conv1 keeps
// floorf (its values leave the round-down floor's range).
//
// K16 reduce_parts_chain<kind> replaces make_run(kind, T).run
//   (scripts/bench_reduce_parts.py:100, pallas_call at :101):
//   A: A <- mont_mul(A, B) with the carry column and plus_p = 2p, its two
//      constant multiplies (m = tlo N' mod R, m p) as products by the band
//      matrices M_NP (34 x 34) and M_P (68 x 34) on the tensor cores, as the
//      reference runs them on the MXU (snark_tpu/ops/pallas_field_v3.py:
//      228-231). Each warp takes its 32 lanes as the N of warp-level
//      mma.sync.m16n8k16 bf16 products with float32 sums: each lane stages
//      its digits (tlo, then m) once each as 20 bf16 pairs (k = 34..39
//      zero) in its own row of the warp's staging area, in five 16-byte
//      stores, and the B fragments are read from those rows (k = 40..47
//      are zero and never read); the band matrices are A fragments (M_NP
//      padded to 48 rows, M_P to 80), packed by the wrapper and copied to
//      shared memory once a block; the float32 C fragments come back
//      through shared memory to each lane's registers, only the rows that
//      are read. Tiles above or below the band, and M_P's row tiles below
//      the rows that reach the carry, are skipped at compile time; so are
//      the row bands with at most kScalarMacs multiply-adds (M_NP's rows
//      32-33, M_P's 64-67), which run as 68 scalar FMAs: 12 + 28 mma a
//      warp and rep, five round trips through shared memory. While the low
//      half is reduced, t's high half waits in the thread's column of
//      shared memory, which holds A at 128 registers without a spill.
//      Every digit is an integer in [0, 256] (bf16-exact), every product
//      below 2^16 and every sum below 2^22, so the products are exact in
//      any float32 accumulation that keeps 23 bits; the equality with the
//      plain version and with C checks that on the card.
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
//   bf16 rate, so the tensor cores do not bound it (the bound counts the 68
//   that run as scalar FMAs there too); what A adds over C is the staging
//   through shared memory and the fragment loads, against the scalar FMAs
//   of the two convolutions that it saves.
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
constexpr int kLaneThreads = 128;  // a block, a tile of lanes (every kind but K16 A)
constexpr int kLaneMinBlocks = 4;  // 16 warps an SM: at most 128 registers a thread
constexpr int kBandThreads = 256;  // K16 A: 8 warps share the band fragments
constexpr int kBandMinBlocks = 2;  // 16 warps an SM
constexpr int kScalarThreads = 256;  // K16 C: one block of 8 warps an SM, up to 255 registers
constexpr int kScalarMinBlocks = 1;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kKTiles = 3;             // k of both band products: 34 padded to 3 x 16
constexpr int kNpMTiles = 3;           // M_NP's 34 rows padded to 48
constexpr int kPMTiles = 5;            // M_P's 68 rows padded to 80
constexpr int kBandTiles = (kNpMTiles + kPMTiles) * kKTiles;  // A fragments, M_NP's first
constexpr int kStagedPairs = 20;  // bf16 pairs a lane stages: 17 of digits, 3 zero
constexpr int kPairStride = 20;   // words a lane's staged row: B fragment loads hit 32 banks
constexpr int kCStride = 40;      // floats a staged C row: float2 stores hit 32 banks
constexpr int kWarpStage = 32 * kPairStride * 4 + 16 * kCStride * 4;  // 5,120 bytes
constexpr int kBandFragBytes = kBandTiles * 32 * 16;                   // 12,288 bytes

enum PartsKind { kPartsA = 0, kPartsB = 1, kPartsC = 2 };
enum BisectKind { kConv0 = 0, kConv1 = 1, kConv3 = 2, kConv9 = 3, kSweep9 = 4, kConvReg = 5 };

// The tile buffer of a block that walks tiles: the 2 R digit rows of a and
// b over its Threads lanes
template <int Threads>
constexpr int kTileBytes = 2 * kPartsRows * Threads * 4;

// Whether a K17 kind's blocks walk tiles (all but sweep9, whose 64
// registers keep eight blocks an SM resident without a tile buffer, six
// with one)
template <int Kind>
constexpr bool kBisectWalks = Kind != kSweep9;

// A K16 kind's block, its minimum resident blocks an SM, whether its blocks
// walk tiles (B) or take one each (A, C), and its dynamic shared memory:
// for A its band fragments, its warps' staging areas and a column a thread
// for t's high half (88,064 bytes); for B the tile buffer.
// ops/mul_parts.py launch_geometry computes the same.
template <int Kind>
struct PartsShape {
  static constexpr int kThreads = Kind == kPartsA   ? kBandThreads
                                 : Kind == kPartsC ? kScalarThreads
                                                   : kLaneThreads;
  static constexpr int kMinBlocks = Kind == kPartsA   ? kBandMinBlocks
                                   : Kind == kPartsC ? kScalarMinBlocks
                                                     : kLaneMinBlocks;
  static constexpr bool kWalks = Kind == kPartsB;
  static constexpr int kColumnAt = kBandFragBytes + kBandWarps * kWarpStage;
  static constexpr int kSmem = Kind == kPartsA ? kColumnAt + kPartsRows * kThreads * 4
                               : kWalks        ? kTileBytes<kThreads>
                                               : 0;
};

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

// The multiply-adds of row band mt of a band matrix (as band_tiles) on the
// rows >= min_row: a band with at most kScalarMacs of them runs as scalar
// FMAs, not as a pass of tensor-core products and its round trip through
// shared memory (M_NP's rows 32-33: 67; M_P's rows 64-67: one, as p's top
// two digits are zero).
template <class F>
__host__ __device__ constexpr int band_macs(bool p_band, int mt, int min_row) {
  const int R = F::kRows;
  int n = 0;
  for (int k = 16 * mt > min_row ? 16 * mt : min_row; k < 16 * mt + 16 && k < (p_band ? 2 * R : R);
       ++k)
    for (int i = 0; i < R; ++i) {
      const int d = k - i;
      if (d >= 0 && d < R && (p_band ? F::p(d) : F::np(d)) != 0.0f) ++n;
    }
  return n;
}
constexpr int kScalarMacs = 96;

// Bit mt is set where row band mt runs as scalar FMAs
template <class F>
__host__ __device__ constexpr unsigned scalar_bands(bool p_band, int min_row) {
  unsigned mask = 0;
  for (int mt = 0; mt < (p_band ? kPMTiles : kNpMTiles); ++mt)
    if (band_macs<F>(p_band, mt, min_row) <= kScalarMacs) mask |= 1u << mt;
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

// The lane's R digits as bf16 pairs in its row of the warp's staging area:
// word [lane][k / 2] holds digits k and k + 1, k + 1 in the high half;
// pairs R / 2 .. kStagedPairs - 1 are zero. Five 16-byte stores a lane.
template <int R>
__device__ __forceinline__ void stage_b(const float (&x)[R], uint32_t* sB, int lane) {
  static_assert(R / 2 <= kStagedPairs && kStagedPairs % 4 == 0, "staged pairs");
  uint32_t p[kStagedPairs];
#pragma unroll
  for (int k2 = 0; k2 < R / 2; ++k2) p[k2] = bf16_pair(x[2 * k2], x[2 * k2 + 1]);
#pragma unroll
  for (int k2 = R / 2; k2 < kStagedPairs; ++k2) p[k2] = 0u;
  uint4* row = reinterpret_cast<uint4*>(sB + lane * kPairStride);
#pragma unroll
  for (int j = 0; j < kStagedPairs / 4; ++j)
    row[j] = make_uint4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
  __syncwarp();
}

// Rows 16 mt .. 16 mt + 15 of (band matrix) (staged B) for this lane's
// column: the live tiles of row band mt, each times the warp's 4 n tiles of
// 8 lanes. Fragment layouts (PTX ISA, m16n8k16, g = lane / 4, q = lane % 4):
// A regs hold (row g, cols 2q, 2q+1), (g + 8, 2q..), (g, 2q + 8..),
// (g + 8, 2q + 8..); B regs (k = 2q, 2q + 1; n = g), (k = 2q + 8, 2q + 9),
// read from row n of the staging area (pair rows past kStagedPairs are
// zero and not read); C (row g, cols 2q, 2q + 1), (row g + 8, same cols).
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
      const uint32_t* pairs = sB + (8 * nt + g) * kPairStride + 8 * kt + q;
      const uint32_t b0 = pairs[0];
      const uint32_t b1 = 8 * kt + 8 <= kStagedPairs ? pairs[4] : 0u;
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

// t's high half out of registers while the low half is reduced: stored to
// the thread's column (`Stride` floats apart) and, after a warp barrier,
// read back; between the two the registers hold the band products.
template <int R, int Stride>
__device__ __forceinline__ void stash_hi(const float (&t)[2 * R], float* hi) {
#pragma unroll
  for (int i = 0; i < R; ++i) hi[i * Stride] = t[R + i];
  __syncwarp();
}

template <int R, int Stride>
__device__ __forceinline__ void unstash_hi(float (&t)[2 * R], const float* hi) {
  __syncwarp();
#pragma unroll
  for (int i = 0; i < R; ++i) t[R + i] = hi[i * Stride];
}

// A = reduce(t) + 2p with the band-product backend (the reference's reduce
// with m_np, m_p given): m = sweep3(M_NP tlo), s = t + M_P m, both products
// on the tensor cores; t is clobbered. All 32 lanes of the warp call it
// together. Only the C rows that are used are read back (the compiler
// drops the rest): M_NP's rows below R, M_P's from kLow.
template <class F, int kThreads>
__device__ __forceinline__ void reduce_band(float (&t)[2 * F::kRows], float (&A)[F::kRows],
                                            const uint4* sA, uint32_t* sB, float* sC, int lane,
                                            float* hi) {
  constexpr int R = F::kRows;
  stash_hi<R, kThreads>(t, hi);
  constexpr int kLow = R - kCarryRows;  // rows of s below it are never read
  constexpr unsigned kNpLive = band_tiles<F>(false, 0);
  constexpr unsigned kPLive = band_tiles<F>(true, kLow);
  constexpr unsigned kRowBand = (1u << kKTiles) - 1u;
  constexpr unsigned kNpScalar = scalar_bands<F>(false, 0);
  constexpr unsigned kPScalar = scalar_bands<F>(true, kLow);
  float u[R];
  reduce_low<R, true>(t, u);  // tlo
  // M_NP's scalar row bands first, while u still holds tlo
  float m_top[16];
#pragma unroll
  for (int mt = 0; mt < kNpMTiles; ++mt) {
    if (!((kNpScalar >> mt) & 1u)) continue;
#pragma unroll
    for (int k = 16 * mt; k < 16 * mt + 16 && k < R; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i <= k; ++i) {
        if (F::np(i) != 0.0f) acc = __fmaf_rn(F::np(i), u[k - i], acc);
      }
      m_top[k - 16 * mt] = acc;
    }
  }
  stage_b<R>(u, sB, lane);
#pragma unroll
  for (int mt = 0; mt < kNpMTiles; ++mt) {
    float col[16];
    if (!((kNpScalar >> mt) & 1u)) {
      band_rows<kNpLive>(sA, mt, sB, sC, lane, col);
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) col[r] = m_top[r];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (16 * mt + r < R) u[16 * mt + r] = col[r];
    }
  }
  sweep3<R, true>(u);  // m
  stage_b<R>(u, sB, lane);
  unstash_hi<R, kThreads>(t, hi);
#pragma unroll
  for (int mt = 0; mt < kPMTiles; ++mt) {
    if (!((kPLive >> (mt * kKTiles)) & kRowBand)) continue;
    float col[16];
    if (!((kPScalar >> mt) & 1u)) {
      band_rows<kPLive>(sA + kNpMTiles * kKTiles * 32, mt, sB, sC, lane, col);
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int k = 16 * mt + r;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (k - i >= 0 && k - i < R && F::p(k - i) != 0.0f) acc = __fmaf_rn(F::p(k - i), u[i], acc);
        }
        col[r] = acc;
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int k = 16 * mt + r;
      if (k >= kLow && k < 2 * R) t[k] = __fadd_rn(t[k], col[r]);
    }
  }
  reduce_out<F, true>(t, A);
}

template <int R>
__device__ __forceinline__ void load_column(const float* __restrict__ p, int lanes, int l,
                                            float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = p[(size_t)i * lanes + l];
}

template <int R>
__device__ __forceinline__ void store_column(float* __restrict__ p, int lanes, int l,
                                             const float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) p[(size_t)i * lanes + l] = x[i];
}

// Tile `tile`'s digit rows of a and b (2 R rows of Threads floats) into
// `buf` by 16-byte cp.async copies, a row's 16-byte chunks to neighbouring
// threads, in one commit group. `lanes` passes through an opaque move, so
// that the compiler computes the copies' addresses here each time and does
// not keep them in registers across the tile's products. kRolled keeps the
// copy loop rolled, which holds one copy's address at a time: K17 conv0
// and conv1 (whose rounded products hold more registers) spilled 36 bytes
// with it unrolled; rolled, conv3 and K16 B ran 12-20% slower on the card.
template <int R, int Threads, bool kRolled>
__device__ __forceinline__ void fetch_tile(const float* a, const float* b, int lanes, int tile,
                                           float* buf) {
  constexpr int kChunksRow = Threads / 4;
  constexpr int kChunks = 2 * R * kChunksRow;
  int stride;
  asm volatile("mov.b32 %0, %1;" : "=r"(stride) : "r"(lanes));
  const size_t l0 = (size_t)tile * Threads;
  auto copy = [&](int c) {
    const int row = c / kChunksRow, j = c % kChunksRow;
    const float* src =
        (row < R ? a + (size_t)row * stride : b + (size_t)(row - R) * stride) + l0 + 4 * j;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(buf + row * Threads + 4 * j);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  };
  if constexpr (kRolled) {
#pragma unroll 1
    for (int c = threadIdx.x; c < kChunks; c += Threads) copy(c);
  } else {
    for (int c = threadIdx.x; c < kChunks; c += Threads) copy(c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The thread's lane of tile `tile` from A into out, its addresses computed
// here from an opaque stride, as fetch_tile's
template <int R, int Threads>
__device__ __forceinline__ void store_tile(float* out, int lanes, int tile, const float (&A)[R]) {
  int stride;
  asm volatile("mov.b32 %0, %1;" : "=r"(stride) : "r"(lanes));
  float* p = out + (size_t)tile * Threads + threadIdx.x;
#pragma unroll
  for (int i = 0; i < R; ++i) p[(size_t)i * stride] = A[i];
}

// A block that walks tiles blockIdx.x, + gridDim.x, ...: the thread's lane
// of the fetched tile into A and B, then the next tile's fetch, which runs
// while this tile's products do. All threads of the block call it.
template <int R, int Threads, bool kRolled>
__device__ __forceinline__ void take_tile(const float* a, const float* b, int lanes, int tile,
                                          float* buf, float (&A)[R], float (&B)[R]) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    A[i] = buf[i * Threads + threadIdx.x];
    B[i] = buf[(R + i) * Threads + threadIdx.x];
  }
  __syncthreads();
  if (tile + (int)gridDim.x < lanes / Threads)
    fetch_tile<R, Threads, kRolled>(a, b, lanes, tile + gridDim.x, buf);
}

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

// `reps` rounds of kind Kind on the thread's lane, A in place
template <int Kind, int kThreads>
__device__ __forceinline__ void parts_reps(float (&A)[kPartsRows], const float (&B)[kPartsRows],
                                           int reps, const uint4* sA, uint32_t* sB, float* sC,
                                           int lane, float* hi) {
  using F = Bn254Fq34;
  constexpr int R = F::kRows;
  for (int rep = reps; rep > 0; --rep) {
    float t[2 * R];
    mul_acc<R, true>(A, B, t);
    if constexpr (Kind == kPartsA) {
      reduce_band<F, kThreads>(t, A, sA, sB, sC, lane, hi);
    } else if constexpr (Kind == kPartsB) {
#pragma unroll
      for (int i = 0; i < R; ++i) A[i] = t[i];
      sweep3<R, true>(A);
      sweep3<R, true>(A);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (F::p2(j) != 0.0f) A[j] = __fadd_rn(A[j], F::p2(j));
      }
      sweep3<R, true>(A);
    } else {
      reduce_scalar<F, true>(t, A);
    }
  }
}

template <int Kind>
__global__ void __launch_bounds__(PartsShape<Kind>::kThreads, PartsShape<Kind>::kMinBlocks)
    reduce_parts_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, const uint4* __restrict__ frags,
                              int lanes, int reps) {
  using S = PartsShape<Kind>;
  constexpr int R = kPartsRows;
  constexpr int kThreads = S::kThreads;
  extern __shared__ uint4 parts_smem[];
  const int lane = threadIdx.x & 31;
  char* smem = reinterpret_cast<char*>(parts_smem);
  const uint4* sA = parts_smem;
  char* stage = smem + kBandFragBytes + (threadIdx.x >> 5) * kWarpStage;
  uint32_t* sB = reinterpret_cast<uint32_t*>(stage);
  float* sC = reinterpret_cast<float*>(stage + 32 * kPairStride * 4);
  float* hi = reinterpret_cast<float*>(smem + S::kColumnAt) + threadIdx.x;  // A's column
  float A[R], B[R];
  if constexpr (S::kWalks) {  // B: the block walks its tiles
    float* buf = reinterpret_cast<float*>(parts_smem);
    fetch_tile<R, kThreads, false>(a, b, lanes, blockIdx.x, buf);
    for (int tile = blockIdx.x; tile < lanes / kThreads; tile += gridDim.x) {
      take_tile<R, kThreads, false>(a, b, lanes, tile, buf, A, B);
      parts_reps<Kind, kThreads>(A, B, reps, sA, sB, sC, lane, hi);
      store_tile<R, kThreads>(out, lanes, tile, A);
    }
  } else {  // A, C: one tile a block
    if constexpr (Kind == kPartsA) {
      for (int i = threadIdx.x; i < kBandTiles * 32; i += kThreads) parts_smem[i] = frags[i];
      __syncthreads();
    }
    const int l = blockIdx.x * kThreads + threadIdx.x;
    load_column<R>(a, lanes, l, A);
    load_column<R>(b, lanes, l, B);
    parts_reps<Kind, kThreads>(A, B, reps, sA, sB, sC, lane, hi);
    store_column<R>(out, lanes, l, A);
  }
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

// `reps` rounds of K17 kind Kind on the thread's lane, A in place
template <int Kind>
__device__ __forceinline__ void bisect_reps(float (&A)[kPartsRows], const float (&B)[kPartsRows],
                                            int reps) {
  constexpr int R = kPartsRows;
  constexpr bool kRd = Kind != kConv1;  // conv1's values leave the round-down floor's range
  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (Kind == kSweep9) {
#pragma unroll
      for (int s = 0; s < 9; ++s) sweep<R, kRd>(A);
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
      sweep3<R, kRd>(t);
#pragma unroll
      for (int i = 0; i < R; ++i) A[i] = t[i];
    } else {
      float t[2 * R];
      mul_acc<R, (Kind != kConv0 && Kind != kConv1)>(A, B, t);
#pragma unroll
      for (int i = 0; i < R; ++i) A[i] = Kind == kConv0 ? __fmul_rn(t[i], 1e-7f) : t[i];
      if constexpr (Kind == kConv1) sweep<R, kRd>(A);
      if constexpr (Kind == kConv3 || Kind == kConv9) sweep3<R, kRd>(A);
      if constexpr (Kind == kConv9) {
        sweep3<R, kRd>(A);
        sweep3<R, kRd>(A);
      }
    }
  }
}

template <int Kind>
__global__ void __launch_bounds__(kLaneThreads, kLaneMinBlocks)
    bisect_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ out, int lanes, int reps) {
  constexpr int R = kPartsRows;
  extern __shared__ __align__(16) float tile_buf[];
  float A[R], B[R];
  constexpr bool kRolled = Kind == kConv0 || Kind == kConv1;
  if constexpr (kBisectWalks<Kind>) {
    fetch_tile<R, kLaneThreads, kRolled>(a, b, lanes, blockIdx.x, tile_buf);
    for (int tile = blockIdx.x; tile < lanes / kLaneThreads; tile += gridDim.x) {
      take_tile<R, kLaneThreads, kRolled>(a, b, lanes, tile, tile_buf, A, B);
      bisect_reps<Kind>(A, B, reps);
      store_tile<R, kLaneThreads>(out, lanes, tile, A);
    }
  } else {  // sweep9: one tile a block
    const int l = blockIdx.x * kLaneThreads + threadIdx.x;
    load_column<R>(a, lanes, l, A);
    load_column<R>(b, lanes, l, B);
    bisect_reps<Kind>(A, B, reps);
    store_column<R>(out, lanes, l, A);
  }
}

// The geometry the kernels take: the kind's block, a whole number of
// tiles, a grid of one block a tile or, for a kind that walks, of 1 to
// `tiles` blocks, at least the kind's shared memory; a and b 16-byte
// aligned for cp.async.
static bool bad_tiling(const void* a, const void* b, int lanes, int grid, int block, int smem,
                       int want_block, int want_smem, bool walks) {
  const int tiles = block > 0 ? lanes / block : 0;
  return lanes <= 0 || block != want_block || lanes % block != 0 || grid <= 0 || grid > tiles ||
         (!walks && grid != tiles) || smem < want_smem ||
         (((uintptr_t)a | (uintptr_t)b) & 15) != 0;
}

template <int Kind>
static int launch_parts(const void* a, const void* b, void* out, const void* frags, int lanes,
                        int grid, int block, int smem, int reps, cudaStream_t s) {
  using S = PartsShape<Kind>;
  if (bad_tiling(a, b, lanes, grid, block, smem, S::kThreads, S::kSmem, S::kWalks) ||
      (Kind == kPartsA && frags == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reduce_parts_chain_kernel<Kind>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  reduce_parts_chain_kernel<Kind><<<grid, block, smem, s>>>(
      (const float*)a, (const float*)b, (float*)out, (const uint4*)frags, lanes, reps);
  return (int)cudaGetLastError();
}

}  // namespace snark

using namespace snark;

extern "C" int snark_reduce_parts_chain(const void* a, const void* b, void* out, const void* frags,
                                        int lanes, int kind, int grid, int block, int smem,
                                        int reps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kPartsA:
      return launch_parts<kPartsA>(a, b, out, frags, lanes, grid, block, smem, reps, s);
    case kPartsB:
      return launch_parts<kPartsB>(a, b, out, frags, lanes, grid, block, smem, reps, s);
    case kPartsC:
      return launch_parts<kPartsC>(a, b, out, frags, lanes, grid, block, smem, reps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int snark_bisect_chain(const void* a, const void* b, void* out, int lanes, int kind,
                                  int grid, int block, int smem, int reps, void* stream) {
  const bool walks = kind != kSweep9;  // kBisectWalks
  if (bad_tiling(a, b, lanes, grid, block, smem, kLaneThreads, walks ? kTileBytes<kLaneThreads> : 0,
                 walks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* fa = (const float*)a;
  const float* fb = (const float*)b;
  float* fo = (float*)out;
#define SNARK_BISECT(K)                                                           \
  case K:                                                                         \
    bisect_chain_kernel<K><<<grid, block, smem, s>>>(fa, fb, fo, lanes, reps); \
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

// Resident blocks an SM of K16 (kernel 0) or K17 (kernel 1) kind `kind` at
// its block and `smem` bytes of dynamic shared memory, as the runtime
// computes them; a negative CUDA error code on a failure.
extern "C" int snark_parts_occupancy(int kernel, int kind, int smem) {
  int blocks = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define SNARK_OCCUPANCY(fn, threads)                                                        \
  {                                                                                         \
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);       \
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,   \
                                                                            threads, smem); \
  }
  if (kernel == 0 && kind == kPartsA)
    SNARK_OCCUPANCY(reduce_parts_chain_kernel<kPartsA>, PartsShape<kPartsA>::kThreads)
  else if (kernel == 0 && kind == kPartsB)
    SNARK_OCCUPANCY(reduce_parts_chain_kernel<kPartsB>, PartsShape<kPartsB>::kThreads)
  else if (kernel == 0 && kind == kPartsC)
    SNARK_OCCUPANCY(reduce_parts_chain_kernel<kPartsC>, PartsShape<kPartsC>::kThreads)
  else if (kernel == 1 && kind == kConv0)
    SNARK_OCCUPANCY(bisect_chain_kernel<kConv0>, kLaneThreads)
  else if (kernel == 1 && kind == kConv1)
    SNARK_OCCUPANCY(bisect_chain_kernel<kConv1>, kLaneThreads)
  else if (kernel == 1 && kind == kConv3)
    SNARK_OCCUPANCY(bisect_chain_kernel<kConv3>, kLaneThreads)
  else if (kernel == 1 && kind == kConv9)
    SNARK_OCCUPANCY(bisect_chain_kernel<kConv9>, kLaneThreads)
  else if (kernel == 1 && kind == kSweep9)
    SNARK_OCCUPANCY(bisect_chain_kernel<kSweep9>, kLaneThreads)
  else if (kernel == 1 && kind == kConvReg)
    SNARK_OCCUPANCY(bisect_chain_kernel<kConvReg>, kLaneThreads)
#undef SNARK_OCCUPANCY
  return e == cudaSuccess ? blocks : -(int)e;
}
