// Curve arithmetic shared by the curve kernels (curve_kernels.cuh) and the
// batch-affine kernels (affine_kernels.cuh): G1 over Fq, G2 over Fq2, for
// BN254 (Fq 8 limbs) and BLS12-381 (Fq 12 limbs), from one template over
// the base field's params (field.cuh) and the per-curve constants below.
//
// Points are projective (X, Y, Z) in the port's limb format (field.cuh):
// a lane is 3 * K * N u32 words, K = 1 for G1 and 2 for G2, N the base
// field's limbs, contiguous. The formulas are the complete ones of
// Renes-Costello-Batina 2015 for a = 0 (Alg 7 projective add, Alg 8 mixed
// add, Alg 9 double), so doubling, identity and inverse inputs need no
// branches. Both curves have a = 0 and Fq2 = Fq[u] / (u^2 + 1).
//
// Rows are the reference's u8 table layout: X digits || Y digits || identity
// flag, each coordinate component D little-endian bytes of x * 2^(8 D) mod q
// (wide Montgomery, canonical; the top two bytes are zero), D = 34 for
// BN254 and 50 for BLS12-381 (2 L + 2 for L 16-bit limbs). Decoding reads
// the low 4 N bytes w and moves the value to R = 2^(32 N) with one 16-bit
// Montgomery reduction step, (w + m q) / 2^16: 8 D = 32 N + 16 on both
// curves, so the step divides by just the 2^16 the rows have over R.
// Encoding multiplies by 2^(8 D) mod q (2^272, 2^400) and writes the 4 N
// bytes of the canonical value back with two zero bytes.
//
// 3b, the constant of the formulas: 9 for BN254 G1 (b = 3), 12 for
// BLS12-381 G1 (b = 4) and 12 (1 + u) for its G2 (b = 4 (1 + u)); those
// multiply by additions (mul_b3). BN254 G2's 3b = 3 / (9 + u) is a full
// Fq2 constant and stays a product.
#pragma once

#include "field.cuh"

namespace snark {

using Fq = Fp<FqParams>;
using Fq2 = Fp2<FqParams>;
using BlsFq = Fp<BlsFqParams>;
using BlsFq2 = Fp2<BlsFqParams>;

// ---- BN254 (checked against fields/params.py by the port's tests)
// 2^272 mod q, raw: mont_mul(x * 2^256, C) = x * 2^272.
static __constant__ uint32_t kMontToRow[8] = {
    0xe1bc3b4fu, 0x2e0850a4u, 0x2f21d2d0u, 0x7d765f42u,
    0xf7c17ab8u, 0x5105616bu, 0x121feb95u, 0x0d42a313u};
// 1 in Montgomery form, 2^256 mod q
static __constant__ uint32_t kOneMont[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// 3b of G2 in Montgomery form, 3 / (9 + u)
static __constant__ uint32_t kB3G2[16] = {
    0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
    0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u,
    0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
    0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};

// ---- BLS12-381
// 2^400 mod q, raw: mont_mul(x * 2^384, C) = x * 2^400.
static __constant__ uint32_t kBlsMontToRow[12] = {
    0x480e6299u, 0x56350003u, 0x699eb128u, 0x8670deb2u,
    0xf6697c98u, 0x0983e84eu, 0xa4e6fe97u, 0xe3e8a053u,
    0x23ecf271u, 0x385c20d3u, 0x12866eb6u, 0x156da47fu};
// 1 in Montgomery form, 2^384 mod q
static __constant__ uint32_t kBlsOneMont[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// The constants of one curve, keyed by its base field's params.
template <class P>
struct CurveConsts;

// kB3G1: G1's 3b, an integer; G2's 3b is kB3G1 (1 + u) where kB3G2Small,
// else the Fq2 constant b3_g2() in Montgomery form.
template <>
struct CurveConsts<FqParams> {
  static constexpr int kRowDigits = 34;
  static constexpr int kB3G1 = 9;
  static constexpr bool kB3G2Small = false;
  static __device__ __forceinline__ const uint32_t* mont_to_row() { return kMontToRow; }
  static __device__ __forceinline__ const uint32_t* one() { return kOneMont; }
  static __device__ __forceinline__ const uint32_t* b3_g2() { return kB3G2; }
};

template <>
struct CurveConsts<BlsFqParams> {
  static constexpr int kRowDigits = 50;
  static constexpr int kB3G1 = 12;
  static constexpr bool kB3G2Small = true;
  static __device__ __forceinline__ const uint32_t* mont_to_row() { return kBlsMontToRow; }
  static __device__ __forceinline__ const uint32_t* one() { return kBlsOneMont; }
};

template <class E>
struct Curve;

// G1: E = Fp<P>
template <class P>
struct Curve<Fp<P>> {
  using E = Fp<P>;
  static constexpr int K = 1;
  static constexpr int W = P::N;  // u32 words per element
  static constexpr int kRowDigits = CurveConsts<P>::kRowDigits;
  static __device__ __forceinline__ E mul_b3(const E& a) {
    return times<CurveConsts<P>::kB3G1>(a);
  }
  static __device__ __forceinline__ E one() { return load_fp<P>(CurveConsts<P>::one()); }
  static __device__ __forceinline__ E zero() {
    E z;
#pragma unroll
    for (int j = 0; j < P::N; ++j) z.v[j] = 0;
    return z;
  }
  static __device__ __forceinline__ E load(const uint32_t* s) { return load_fp<P>(s); }
  // the same words, read anew at each call (16-byte aligned; see MemPoint)
  static __device__ __forceinline__ E load_fresh(const uint32_t* s) {
    static_assert(P::N % 4 == 0, "elements of whole 16-byte vectors");
    E r;
#pragma unroll
    for (int j = 0; j < P::N; j += 4) chain::load4_fresh(r.v + j, s + j);
    return r;
  }
  static __device__ __forceinline__ void store(uint32_t* d, const E& a) { store_fp<P>(d, a); }
  static __device__ __forceinline__ bool eq(const E& a, const E& b) {  // as field elements
    const E x = canon(a), y = canon(b);
    uint32_t d = 0;
#pragma unroll
    for (int j = 0; j < P::N; ++j) d |= x.v[j] ^ y.v[j];
    return d == 0;
  }
};

// G2: E = Fp2<P>
template <class P>
struct Curve<Fp2<P>> {
  using E = Fp2<P>;
  using F = Curve<Fp<P>>;
  static constexpr int K = 2;
  static constexpr int W = 2 * P::N;
  static constexpr int kRowDigits = CurveConsts<P>::kRowDigits;
  // 3b a: BN254 by its Fq2 constant; BLS12-381 12 (1 + u) a, with
  // (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
  static __device__ __forceinline__ E mul_b3(const E& a) {
    if constexpr (CurveConsts<P>::kB3G2Small) {
      return {F::mul_b3(a.c0 - a.c1), F::mul_b3(a.c0 + a.c1)};
    } else {
      const E b3 = {load_fp<P>(CurveConsts<P>::b3_g2()),
                    load_fp<P>(CurveConsts<P>::b3_g2() + P::N)};
      return b3 * a;
    }
  }
  static __device__ __forceinline__ E one() { return {F::one(), F::zero()}; }
  static __device__ __forceinline__ E zero() { return {F::zero(), F::zero()}; }
  static __device__ __forceinline__ E load(const uint32_t* s) {
    return {load_fp<P>(s), load_fp<P>(s + P::N)};
  }
  static __device__ __forceinline__ E load_fresh(const uint32_t* s) {
    return {F::load_fresh(s), F::load_fresh(s + P::N)};
  }
  static __device__ __forceinline__ void store(uint32_t* d, const E& a) {
    store_fp<P>(d, a.c0);
    store_fp<P>(d + P::N, a.c1);
  }
  static __device__ __forceinline__ bool eq(const E& a, const E& b) {
    return F::eq(a.c0, b.c0) && F::eq(a.c1, b.c1);
  }
};

// A row of the table (see the top): 2 K components of kRowDigits bytes,
// then the identity flag. K1 and K6-K8 take its layout from here;
// ops/curve.py row_bytes states the width for the wrappers.
template <class E>
struct Rows {
  static constexpr int kBytes = 2 * Curve<E>::K * Curve<E>::kRowDigits + 1;
  static constexpr int kFlag = kBytes - 1;
  static constexpr int kWords = kFlag / 4;  // a row is 4 kWords + 1 bytes
  static_assert(Curve<E>::kRowDigits % 4 == 2, "rows of 2 K (4 N + 2) + 1 bytes");
};

template <class E>
struct Point {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Point<E> load_point(const uint32_t* s) {
  constexpr int W = Curve<E>::W;
  return {Curve<E>::load(s), Curve<E>::load(s + W), Curve<E>::load(s + 2 * W)};
}

template <class E>
__device__ __forceinline__ void store_point(uint32_t* d, const Point<E>& p) {
  constexpr int W = Curve<E>::W;
  Curve<E>::store(d, p.x);
  Curve<E>::store(d + W, p.y);
  Curve<E>::store(d + 2 * W, p.z);
}

// A point in device memory (3 K N words, 16-byte aligned, unchanged while
// the kernel runs) whose coordinates are read at each use: K2's operands in
// G2. Held in registers, the two operands of the BLS12-381 G2 add (144
// words) spilled; read again, they come from L1.
template <class E>
struct MemPoint {
  const uint32_t* s;
};

// The coordinates of a point held in registers or read from memory
template <class E>
__device__ __forceinline__ const E& X(const Point<E>& p) { return p.x; }
template <class E>
__device__ __forceinline__ const E& Y(const Point<E>& p) { return p.y; }
template <class E>
__device__ __forceinline__ const E& Z(const Point<E>& p) { return p.z; }
template <class E>
__device__ __forceinline__ E X(const MemPoint<E>& p) { return Curve<E>::load_fresh(p.s); }
template <class E>
__device__ __forceinline__ E Y(const MemPoint<E>& p) {
  return Curve<E>::load_fresh(p.s + Curve<E>::W);
}
template <class E>
__device__ __forceinline__ E Z(const MemPoint<E>& p) {
  return Curve<E>::load_fresh(p.s + 2 * Curve<E>::W);
}

// RCB15 Alg 7 (a = 0): complete projective add of two points, each a Point
// or a MemPoint. Each coordinate of p and q has its last use by the sixth
// product; from there six elements are live.
template <class E, template <class> class A, template <class> class B>
__device__ __forceinline__ Point<E> padd(const A<E>& p, const B<E>& q) {
  using C = Curve<E>;
  E t0 = X(p) * X(q);
  E t1 = Y(p) * Y(q);
  E t3 = (X(p) + Y(p)) * (X(q) + Y(q)) - (t0 + t1);
  E t2 = Z(p) * Z(q);
  E t4 = (Y(p) + Z(p)) * (Y(q) + Z(q)) - (t1 + t2);
  E y3 = (X(p) + Z(p)) * (X(q) + Z(q)) - (t0 + t2);
  E t0p = (t0 + t0) + t0;
  E t2p = C::mul_b3(t2);
  E z3p = t1 + t2p;
  E t1p = t1 - t2p;
  y3 = C::mul_b3(y3);
  const E x3 = t3 * t1p - t4 * y3;
  const E z3 = z3p * t4 + t0p * t3;  // the last use of t3 and t4
  return {x3, t1p * z3p + y3 * t0p, z3};
}

// RCB15 Alg 8 (a = 0): complete mixed add, q affine (not the identity).
// The order ends the lives of qx, qy, X1 and Y1 before Alg 8's tail.
template <class E>
__device__ __forceinline__ Point<E> madd(const Point<E>& p, const E& qx, const E& qy) {
  using C = Curve<E>;
  const E m4 = (p.x + p.y) * (qx + qy);
  E t0 = p.x * qx;
  E t1 = p.y * qy;
  E t3 = m4 - (t0 + t1);
  E t4 = qy * p.z + p.y;
  E y3 = qx * p.z + p.x;
  E t0p = (t0 + t0) + t0;
  E t2p = C::mul_b3(p.z);
  E z3p = t1 + t2p;
  E t1p = t1 - t2p;
  y3 = C::mul_b3(y3);
  const E x3 = t3 * t1p - t4 * y3;
  const E z3 = z3p * t4 + t0p * t3;  // the last use of t3 and t4
  return {x3, t1p * z3p + y3 * t0p, z3};
}

// K1's parts (madd_parts.cu): the body of K1's step, the shipped one or one
// with a part changed. Only kMaddFull is a group law; the others compute the
// formulas of the bodies of scripts/bench_madd_parts.py, wrong by design.
constexpr int kMaddFull = 0;      // madd above
constexpr int kMaddNosub = 1;     // Alg 8's 13 products, its add/sub glue cut
constexpr int kMaddHalfmul = 2;   // 6 of Alg 8's products
constexpr int kMaddNodecode = 3;  // Alg 8 with Q = (Z1, Y1): K1 decodes no row

// nosub: with a = X1 x2, b = Y1 y2, d = y2 Z1, e = x2 Z1,
// m4 = (X1 + Y1)(x2 + y2), i = b3 Z1, j = b3 (e + X1):
// (a b - d j, b i + j a, i d + a m4).
template <class E>
__device__ __forceinline__ Point<E> madd_nosub(const Point<E>& p, const E& qx, const E& qy) {
  E a = p.x * qx;
  E b = p.y * qy;
  E d = qy * p.z;
  E e = qx * p.z;
  E m4 = (p.x + p.y) * (qx + qy);
  E i = Curve<E>::mul_b3(p.z);
  E j = Curve<E>::mul_b3(e + p.x);
  return {a * b - d * j, b * i + j * a, i * d + a * m4};
}

// halfmul: with a, b, m4, i as for nosub: (a b - m4 i, b + i, a + i).
template <class E>
__device__ __forceinline__ Point<E> madd_halfmul(const Point<E>& p, const E& qx, const E& qy) {
  E a = p.x * qx;
  E b = p.y * qy;
  E m4 = (p.x + p.y) * (qx + qy);
  E i = Curve<E>::mul_b3(p.z);
  return {a * b - m4 * i, b + i, a + i};
}

template <int Part, class E>
__device__ __forceinline__ Point<E> madd_part(const Point<E>& p, const E& qx, const E& qy) {
  if constexpr (Part == kMaddNosub)
    return madd_nosub(p, qx, qy);
  else if constexpr (Part == kMaddHalfmul)
    return madd_halfmul(p, qx, qy);
  else
    return madd(p, qx, qy);
}

// RCB15 Alg 9 (a = 0): complete projective double (9 multiplications, the
// one by 3b additions where 3b is small).
template <class E>
__device__ __forceinline__ Point<E> pdbl(const Point<E>& p) {
  E t0 = p.y * p.y;
  E z8 = t0 + t0;
  z8 = z8 + z8;
  z8 = z8 + z8;  // 8 Y^2
  E t1 = p.y * p.z;
  E t2 = Curve<E>::mul_b3(p.z * p.z);
  E x3 = t2 * z8;
  E y3 = t0 + t2;
  E z3 = t1 * z8;
  E t0n = t0 - ((t2 + t2) + t2);
  y3 = x3 + t0n * y3;
  E xy = t0n * (p.x * p.y);
  return {xy + xy, y3, z3};
}

// ---- rows

// One coordinate component of a u8 row from its low 4 N bytes w (w[N] is
// scratch): x * 2^(8 D) divided by 2^16 mod q in one Montgomery step: m =
// w n0 mod 2^16 makes w + m q a multiple of 2^16, and (w + m q) / 2^16 <
// R / 2^16 + q < 2q for any w < R (field.cuh): a lazy value, with no
// subtraction. Two chains add the low and the high halves of m q (as
// mont_mul's even and odd), and a funnel shift divides.
template <class P>
__device__ __forceinline__ Fp<P> decode_words(uint32_t (&w)[P::N + 1]) {
  constexpr int N = P::N;
  static_assert(P::kLazy, "a decoded value may lie in [q, 2q)");
  const uint32_t m = chain::mul_lo(w[0], P::kN0) & 0xffffu;
  w[0] = chain::mad_lo_cc(m, P::p(0), w[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) w[j] = chain::madc_lo_cc(m, P::p(j), w[j]);
  w[N] = chain::addc(0, 0);
  w[1] = chain::mad_hi_cc(m, P::p(0), w[1]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) w[j + 1] = chain::madc_hi_cc(m, P::p(j), w[j + 1]);
  w[N] = chain::madc_hi(m, P::p(N - 1), w[N]);  // w + m q < 2^16 (R + q)
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = __funnelshift_r(w[j], w[j + 1], 16);
  return r;
}

// A component read byte by byte from a row in device memory (K1's gather).
template <class P>
__device__ __forceinline__ Fp<P> decode_component(const uint8_t* src) {
  uint32_t w[P::N + 1];
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    w[j] = (uint32_t)src[4 * j] | ((uint32_t)src[4 * j + 1] << 8) |
           ((uint32_t)src[4 * j + 2] << 16) | ((uint32_t)src[4 * j + 3] << 24);
  }
  return decode_words<P>(w);
}

// The value a row holds for a: the canonical x * 2^(8 D) mod q, whose 4 N
// bytes and two zero bytes are the component (the inverse of decode_words).
template <class P>
__device__ __forceinline__ Fp<P> row_value(const Fp<P>& a) {
  return canon(a * load_fp<P>(CurveConsts<P>::mont_to_row()));
}

template <class P>
__device__ __forceinline__ void decode_row(const uint8_t* row, Fp<P>& x, Fp<P>& y) {
  constexpr int D = CurveConsts<P>::kRowDigits;
  x = decode_component<P>(row);
  y = decode_component<P>(row + D);
}

template <class P>
__device__ __forceinline__ void decode_row(const uint8_t* row, Fp2<P>& x, Fp2<P>& y) {
  constexpr int D = CurveConsts<P>::kRowDigits;
  x = {decode_component<P>(row), decode_component<P>(row + D)};
  y = {decode_component<P>(row + 2 * D), decode_component<P>(row + 3 * D)};
}

}  // namespace snark
