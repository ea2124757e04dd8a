// The curve kernels K1, K2, K5, K11 and K18 as templates over the base
// field's params, with one host launcher each. curve.cu instantiates them for
// BN254 and curve_bls.cu for BLS12-381, each in its own nvcc process.
// See curve.cu for what they replace and what bounds them.
#pragma once

#include "curve.cuh"

namespace snark {

// K1. Part (curve.cuh) picks the step's body; the default is the shipped
// one, and the other parts (madd_parts.cu) change nothing else: the
// gather, the identity skip, the sign, the loop and the store are shared.
template <class E, int Part = kMaddFull>
__global__ void bucket_madd_rows_kernel(
    const uint32_t* __restrict__ acc_in, uint32_t* __restrict__ acc_out,
    const uint8_t* __restrict__ table, int row_bytes,
    const uint32_t* __restrict__ perm, const int32_t* __restrict__ lane_base,
    const int32_t* __restrict__ start, const int32_t* __restrict__ length,
    int lanes, int i0, int k_steps) {
  constexpr int LW = 3 * Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Point<E> acc = load_point<E>(acc_in + (size_t)l * LW);
  const int len = length[l];
  const int end = len < i0 + k_steps ? len : i0 + k_steps;
  const uint32_t* run = perm + (size_t)lane_base[l] + start[l];
  constexpr int flag_at = Rows<E>::kFlag;
  for (int i = i0; i < end; ++i) {
    const uint32_t pay = run[i];
    const uint8_t* row = table + (size_t)(pay & 0x7fffffffu) * row_bytes;
    if (row[flag_at] == 0) continue;  // identity row
    if constexpr (Part == kMaddNodecode) {
      acc = madd(acc, acc.z, acc.y);  // no decode, the sign ignored
    } else {
      E qx, qy;
      decode_row(row, qx, qy);
      if (pay >> 31) qy = neg(qy);
      acc = madd_part<Part>(acc, qx, qy);
    }
  }
  store_point<E>(acc_out + (size_t)l * LW, acc);
}

template <class E>
__global__ void masked_add_kernel(const uint32_t* __restrict__ p,
                                  const uint32_t* __restrict__ q,
                                  const uint8_t* __restrict__ mask,
                                  uint32_t* __restrict__ out, int lanes) {
  constexpr int LW = 3 * Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t at = (size_t)l * LW;
  if (mask != nullptr && !mask[l]) {
    store_point<E>(out + at, load_point<E>(p + at));
  } else if constexpr (Curve<E>::K == 2) {
    // G2 reads its operands at each use (curve.cuh MemPoint); G1's fit in
    // registers, and a one-lane launch (the Horner combine) would wait on
    // each read
    store_point<E>(out + at, padd(MemPoint<E>{p + at}, MemPoint<E>{q + at}));
  } else {
    store_point<E>(out + at, padd(load_point<E>(p + at), load_point<E>(q + at)));
  }
}

// K11: mask ? p + (x2, y2) : p, q = (x2, y2) affine and not the identity
// where the mask is set (the caller's duty, as for the reference).
template <class E>
__global__ void masked_mixed_add_kernel(const uint32_t* __restrict__ p,
                                        const uint32_t* __restrict__ x2,
                                        const uint32_t* __restrict__ y2,
                                        const uint8_t* __restrict__ mask,
                                        uint32_t* __restrict__ out, int lanes) {
  constexpr int W = Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Point<E> a = load_point<E>(p + (size_t)l * 3 * W);
  if (mask[l])
    a = madd(a, Curve<E>::load(x2 + (size_t)l * W), Curve<E>::load(y2 + (size_t)l * W));
  store_point<E>(out + (size_t)l * 3 * W, a);
}

template <class E>
__global__ void point_double_kernel(const uint32_t* __restrict__ p,
                                    uint32_t* __restrict__ out, int lanes) {
  constexpr int LW = 3 * Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  store_point<E>(out + (size_t)l * LW, pdbl(load_point<E>(p + (size_t)l * LW)));
}

// ---- K18: the Horner combine of the MSM in one launch (curve.cu says what
// it replaces and what bounds it)
//
// One warp runs the whole combine. Its state is shared memory, in slots of
// one element of E: the running point X, Y, Z in slots 0-2, temporaries in
// 3-15, the base-field products of a split Fq2 level in 16-24 (two a
// slot), then the W window totals, 3 slots each. Slots kQ..kQ+2 of a level
// name the X, Y, Z of the current window's total. Each level of a formula
// runs its independent operations on lanes 0..n-1, one operation a lane,
// with the same code on every lane, then the warp meets (__syncwarp).
constexpr int kHornerTmp = 16;      // the split levels' base-field products
constexpr int kQ = 25;              // the slots before the totals
constexpr int kHornerThreads = 32;  // one warp

// the operation of a level
constexpr int kLevelAdd = 0;  // x + y, or x - y on the lanes set in Subs
constexpr int kLevelMul = 1;  // x y
constexpr int kLevelB3 = 2;   // 3b x

// One slot per lane, 8 bits a lane, lane 0 lowest.
template <class... S>
__host__ __device__ constexpr uint64_t per_lane(S... s) {
  uint64_t r = 0;
  int i = 0;
  ((r |= (uint64_t)s << (8 * i++)), ...);
  return r;
}

// The words of a as they are (a lazy value stays below 2p; no reduction)
template <class P>
__device__ __forceinline__ void put_raw(uint32_t* d, const Fp<P>& a) {
#pragma unroll
  for (int j = 0; j < P::N; ++j) d[j] = a.v[j];
}

template <class P>
__device__ __forceinline__ void put_raw(uint32_t* d, const Fp2<P>& a) {
  put_raw(d, a.c0);
  put_raw(d + P::N, a.c1);
}

template <class P>
__device__ __forceinline__ Fp<P> pick(bool c, const Fp<P>& a, const Fp<P>& b) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < P::N; ++j) r.v[j] = c ? a.v[j] : b.v[j];
  return r;
}

template <class P>
__device__ __forceinline__ Fp2<P> pick(bool c, const Fp2<P>& a, const Fp2<P>& b) {
  return {pick(c, a.c0, b.c0), pick(c, a.c1, b.c1)};
}

// The address of operation i's slot in a level's slot code (w3 = 3 w
// places the total of window w)
template <class E>
__device__ __forceinline__ uint32_t* horner_slot(uint32_t* s, int w3, uint64_t code, int i) {
  const int k = (int)((code >> (8 * i)) & 0xff);
  return s + (k + (k >= kQ ? w3 : 0)) * Curve<E>::W;
}

// A split Fq2 level: lane j < 3n takes part j % 3 of product i = j / 3,
// x_i y_i (y_i = 3b for kLevelB3): a0 b0, a1 b1 or (a0 + a1)(b0 + b1);
// then lane i < n forms (v0 - v1, s - v0 - v1), as Fq2's operator* does.
template <int Op, class P>
__device__ __forceinline__ void horner_level_split(uint32_t* s, int w3, int n, uint64_t o,
                                                   uint64_t x, uint64_t y) {
  using E = Fp2<P>;
  constexpr int N = P::N;
  uint32_t* tmp = s + kHornerTmp * Curve<E>::W;  // base-field products, N words each
  const int j = threadIdx.x;
  if (j < 3 * n) {
    const int i = j / 3, part = j % 3;
    const E a = Curve<E>::load(horner_slot<E>(s, w3, x, i));
    E b;
    if constexpr (Op == kLevelB3) {
      b = {load_fp<P>(CurveConsts<P>::b3_g2()), load_fp<P>(CurveConsts<P>::b3_g2() + N)};
    } else {
      b = Curve<E>::load(horner_slot<E>(s, w3, y, i));
    }
    const Fp<P> u = pick(part == 0, a.c0, pick(part == 1, a.c1, a.c0 + a.c1));
    const Fp<P> v = pick(part == 0, b.c0, pick(part == 1, b.c1, b.c0 + b.c1));
    put_raw(tmp + j * N, u * v);
  }
  __syncwarp();
  if (j < n) {
    const Fp<P> v0 = load_fp<P>(tmp + 3 * j * N), v1 = load_fp<P>(tmp + (3 * j + 1) * N),
                sum = load_fp<P>(tmp + (3 * j + 2) * N);
    put_raw(horner_slot<E>(s, w3, o, j), E{v0 - v1, (sum - v0) - v1});
  }
  __syncwarp();
}

// Which levels of E run split: in G2 every product, and 3b where it is a
// product (BN254). Whole on one lane, an Fq2 product is three base products
// deep; split, one and a combining level. Timed in turns on one NVIDIA H100
// 80GB HBM3 (700 W), the split combine took 0.47x (BN254 G2) and 0.48x
// (BLS12-381 G2) the time of the whole one, and G1 did not move.
template <class E>
struct HornerSplit {
  static constexpr bool kMul = false, kB3 = false;
};

template <class P>
struct HornerSplit<Fp2<P>> {
  static constexpr bool kMul = true;
  static constexpr bool kB3 = !CurveConsts<P>::kB3G2Small;
};

template <class E>
struct FieldParams;

template <class P>
struct FieldParams<Fp2<P>> {
  using type = P;
};

// A level whose operations each run whole on one lane (see horner_level)
template <int Op, unsigned Subs, class E>
__device__ __forceinline__ void horner_level_whole(uint32_t* s, int w3, int n, uint64_t o,
                                                   uint64_t x, uint64_t y) {
  const int j = threadIdx.x;
  if (j < n) {
    auto at = [&](uint64_t code) { return horner_slot<E>(s, w3, code, j); };
    const E a = Curve<E>::load(at(x));
    E r;
    if constexpr (Op == kLevelMul) {
      r = a * Curve<E>::load(at(y));
    } else if constexpr (Op == kLevelB3) {
      r = Curve<E>::mul_b3(a);
    } else if constexpr (Subs == 0) {
      r = a + Curve<E>::load(at(y));
    } else {
      const E b = Curve<E>::load(at(y));
      r = pick((Subs >> j) & 1, a - b, a + b);  // both on every lane: no branch
    }
    put_raw(at(o), r);
  }
  __syncwarp();
}

// One level: lane j < n reads slots x_j (and y_j), computes its operation
// and writes slot o_j; w3 = 3 w places the total of window w. No lane
// writes a slot that another lane of the level reads, so the level's reads
// and writes need no barrier between them.
template <int Op, unsigned Subs, class E>
__device__ __forceinline__ void horner_level(uint32_t* s, int w3, int n, uint64_t o, uint64_t x,
                                             uint64_t y = 0) {
  if constexpr ((Op == kLevelMul && HornerSplit<E>::kMul) ||
                (Op == kLevelB3 && HornerSplit<E>::kB3)) {
    horner_level_split<Op, typename FieldParams<E>::type>(s, w3, n, o, x, y);
  } else {
    horner_level_whole<Op, Subs, E>(s, w3, n, o, x, y);
  }
}

// RCB15 Alg 9 on slots 0-2 (pdbl in curve.cuh, the same values), in seven
// levels: two of products, 3b, and the additions between.
template <class E>
__device__ __forceinline__ void horner_double(uint32_t* s) {
  constexpr int X = 0, Y = 1, Z = 2, T0 = 3, T1 = 4, T2 = 5, XY = 6, Z8 = 7, U = 8, S = 9,
                X3 = 10, M = 11, XYN = 12;
  // t0 = Y^2, t1 = Y Z, t2 = Z^2, xy = X Y
  horner_level<kLevelMul, 0, E>(s, 0, 4, per_lane(T0, T1, T2, XY), per_lane(Y, Y, Z, X),
                                per_lane(Y, Z, Z, Y));
  horner_level<kLevelB3, 0, E>(s, 0, 1, per_lane(T2), per_lane(T2));  // t2 = 3b Z^2
  // 2 t0, 2 t2, t0 + t2
  horner_level<kLevelAdd, 0, E>(s, 0, 3, per_lane(Z8, U, S), per_lane(T0, T2, T0),
                                per_lane(T0, T2, T2));
  // 4 t0, 3 t2
  horner_level<kLevelAdd, 0, E>(s, 0, 2, per_lane(Z8, U), per_lane(Z8, U), per_lane(Z8, T2));
  // z8 = 8 t0, t0n = t0 - 3 t2
  horner_level<kLevelAdd, 0b10, E>(s, 0, 2, per_lane(Z8, U), per_lane(Z8, T0), per_lane(Z8, U));
  // x3 = t2 z8, Z3 = t1 z8, m = t0n (t0 + t2), xyn = t0n xy
  horner_level<kLevelMul, 0, E>(s, 0, 4, per_lane(X3, Z, M, XYN), per_lane(T2, T1, U, U),
                                per_lane(Z8, Z8, S, XY));
  // X3 = 2 xyn, Y3 = x3 + m
  horner_level<kLevelAdd, 0, E>(s, 0, 2, per_lane(X, Y), per_lane(XYN, X3), per_lane(XYN, M));
}

// RCB15 Alg 7 (padd in curve.cuh, the same values): slots 0-2 += the total
// of window w, in eight levels: two of six products, 3b, the additions.
template <class E>
__device__ __forceinline__ void horner_add(uint32_t* s, int w) {
  constexpr int X1 = 0, Y1 = 1, Z1 = 2, X2 = kQ, Y2 = kQ + 1, Z2 = kQ + 2;
  const int w3 = 3 * w;
  // X1 + Y1, Y1 + Z1, X1 + Z1, X2 + Y2, Y2 + Z2, X2 + Z2 -> 3..8
  horner_level<kLevelAdd, 0, E>(s, w3, 6, per_lane(3, 4, 5, 6, 7, 8),
                                per_lane(X1, Y1, X1, X2, Y2, X2), per_lane(Y1, Z1, Z1, Y2, Z2, Z2));
  // t0, t1, t2, m4, m5, m6 -> 9..14
  horner_level<kLevelMul, 0, E>(s, w3, 6, per_lane(9, 10, 11, 12, 13, 14),
                                per_lane(X1, Y1, Z1, 3, 4, 5), per_lane(X2, Y2, Z2, 6, 7, 8));
  // t0 + t1, t1 + t2, t0 + t2, 2 t0 -> 3..6
  horner_level<kLevelAdd, 0, E>(s, w3, 4, per_lane(3, 4, 5, 6), per_lane(9, 10, 9, 9),
                                per_lane(10, 11, 11, 9));
  // t3 = m4 - (t0 + t1), t4 = m5 - (t1 + t2), y3' = m6 - (t0 + t2), t0' = 3 t0
  horner_level<kLevelAdd, 0b0111, E>(s, w3, 4, per_lane(12, 13, 14, 6), per_lane(12, 13, 14, 6),
                                     per_lane(3, 4, 5, 9));
  // t2' = 3b t2, y3 = 3b y3'
  horner_level<kLevelB3, 0, E>(s, w3, 2, per_lane(11, 14), per_lane(11, 14));
  // z3' = t1 + t2' -> 15, t1' = t1 - t2' -> 7
  horner_level<kLevelAdd, 0b10, E>(s, w3, 2, per_lane(15, 7), per_lane(10, 10), per_lane(11, 11));
  // t3 t1', t4 y3, t1' z3', y3 t0', z3' t4, t0' t3 -> 3, 4, 5, 8, 9, 10
  horner_level<kLevelMul, 0, E>(s, w3, 6, per_lane(3, 4, 5, 8, 9, 10),
                                per_lane(12, 13, 7, 14, 15, 6), per_lane(7, 14, 15, 6, 13, 12));
  // X3, Y3, Z3
  horner_level<kLevelAdd, 0b001, E>(s, w3, 3, per_lane(X1, Y1, Z1), per_lane(3, 5, 9),
                                    per_lane(4, 8, 10));
}

// K18: Horner over the window totals sums (windows, 3, K, N), top window
// first, from the identity: acc = 2^c acc + sums[w]. out (3, K, N) is
// canonical. One block of one warp; dynamic shared memory
// (kQ + 3 windows) elements of E.
template <class E>
__global__ void __launch_bounds__(kHornerThreads, 1)
    horner_combine_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out,
                          int windows, int c) {
  extern __shared__ uint32_t horner_smem[];
  constexpr int WE = Curve<E>::W;
  uint32_t* s = horner_smem;
  const int j = threadIdx.x;
  for (int i = j; i < windows * 3 * WE; i += kHornerThreads) s[kQ * WE + i] = sums[i];
  if (j < 3) put_raw(s + j * WE, j == 1 ? Curve<E>::one() : Curve<E>::zero());
  __syncwarp();
  for (int w = windows - 1; w >= 0; --w) {
    for (int i = 0; i < c; ++i) horner_double<E>(s);
    horner_add<E>(s, w);
  }
  if (j < 3) Curve<E>::store(out + j * WE, Curve<E>::load(s + j * WE));
}

// K18's latency bound, measured (chip_smoke.py horner_bound_ms): thread 0
// of one warp runs n dependent steps between two reads of the SM clock
// and writes the cycles to cycles[0]. Mode 0: the multiply-add pair of the
// product's chains, mad.lo.cc and madc.hi.cc on one operand pair (one
// IMAD.WIDE.U32.X once ptxas fuses them), whose addends are the last
// pair's two words and its carry, kLatencyUnroll pairs an iteration; n
// counts pairs. Mode 1: the base field's product as K18's lanes run it,
// each on the last one's result. in: two elements (2N words); out: the
// last step's N words, so that nothing is dropped.
constexpr int kLatencyUnroll = 16;

template <class P>
__global__ void chain_latency_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                     long long* __restrict__ cycles, int n, int mode) {
  if (threadIdx.x != 0) return;
  constexpr int N = P::N;
  Fp<P> a = load_fp<P>(in);
  const Fp<P> b = load_fp<P>(in + N);
  long long t0, t1;
  if (mode == 0) {
    uint32_t lo = chain::add_cc(a.v[0], 0u), hi = a.v[1];  // the flag cleared
    const uint32_t x = b.v[0], y = b.v[1];
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; i += kLatencyUnroll) {
#pragma unroll
      for (int k = 0; k < kLatencyUnroll; ++k) {
        lo = chain::madc_lo_cc(x, y, lo);
        hi = chain::madc_hi_cc(x, y, hi);
      }
    }
    t1 = clock64();
    a.v[0] = lo;
    a.v[1] = hi;
  } else {
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) a = a * b;
    t1 = clock64();
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = a.v[k];
  cycles[0] = t1 - t0;
}

constexpr int kCurveBlock = 128;

inline dim3 curve_grid(int lanes) { return dim3((lanes + kCurveBlock - 1) / kCurveBlock); }

template <class P>
int launch_bucket_madd_rows(int group, const void* acc_in, void* acc_out, const void* table,
                            int row_bytes, const void* perm, const void* lane_base,
                            const void* start, const void* length, int lanes, int i0,
                            int k_steps, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint8_t*)table, row_bytes,
        (const uint32_t*)perm, (const int32_t*)lane_base, (const int32_t*)start,
        (const int32_t*)length, lanes, i0, k_steps);
  };
  if (group == 1)
    run(bucket_madd_rows_kernel<Fp<P>>);
  else
    run(bucket_madd_rows_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_masked_add(int group, const void* p, const void* q, const void* mask, void* out,
                      int lanes, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)mask, (uint32_t*)out, lanes);
  };
  if (group == 1)
    run(masked_add_kernel<Fp<P>>);
  else
    run(masked_add_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_masked_mixed_add(int group, const void* p, const void* x2, const void* y2,
                            const void* mask, void* out, int lanes, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (const uint32_t*)x2, (const uint32_t*)y2, (const uint8_t*)mask,
        (uint32_t*)out, lanes);
  };
  if (group == 1)
    run(masked_mixed_add_kernel<Fp<P>>);
  else
    run(masked_mixed_add_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_point_double(int group, const void* p, void* out, int lanes, cudaStream_t s) {
  if (group == 1)
    point_double_kernel<Fp<P>><<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (uint32_t*)out, lanes);
  else
    point_double_kernel<Fp2<P>><<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}

// Shared memory of one K18 launch: the scratch slots and the totals.
inline size_t horner_smem_bytes(int windows, int words) {
  return (size_t)(kQ + 3 * windows) * words * sizeof(uint32_t);
}

template <class P>
int launch_horner_combine(int group, const void* sums, void* out, int windows, int c,
                          cudaStream_t s) {
  auto run = [&](auto kernel, int words) {
    const size_t bytes = horner_smem_bytes(windows, words);
    if (bytes > 48 * 1024) {  // above the default, as dynamic shared memory only
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) {
        cudaGetLastError();  // not left for the next launch to report
        return (int)e;
      }
    }
    kernel<<<1, kHornerThreads, bytes, s>>>((const uint32_t*)sums, (uint32_t*)out, windows, c);
    return (int)cudaGetLastError();
  };
  if (group == 1) return run(horner_combine_kernel<Fp<P>>, P::N);
  return run(horner_combine_kernel<Fp2<P>>, 2 * P::N);
}

template <class P>
int launch_chain_latency(const void* in, void* out, void* cycles, int n, int mode,
                         cudaStream_t s) {
  chain_latency_kernel<P><<<1, 32, 0, s>>>((const uint32_t*)in, (uint32_t*)out,
                                           (long long*)cycles, n, mode);
  return (int)cudaGetLastError();
}

// The BLS12-381 launchers, defined in curve_bls.cu.
int bls_bucket_madd_rows(int group, const void* acc_in, void* acc_out, const void* table,
                         int row_bytes, const void* perm, const void* lane_base,
                         const void* start, const void* length, int lanes, int i0,
                         int k_steps, cudaStream_t s);
int bls_masked_add(int group, const void* p, const void* q, const void* mask, void* out,
                   int lanes, cudaStream_t s);
int bls_point_double(int group, const void* p, void* out, int lanes, cudaStream_t s);
int bls_masked_mixed_add(int group, const void* p, const void* x2, const void* y2,
                         const void* mask, void* out, int lanes, cudaStream_t s);
int bls_horner_combine(int group, const void* sums, void* out, int windows, int c,
                       cudaStream_t s);
int bls_chain_latency(const void* in, void* out, void* cycles, int n, int mode, cudaStream_t s);

}  // namespace snark
