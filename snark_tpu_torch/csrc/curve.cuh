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
// the low 4 N bytes and moves the value to R = 2^(32 N) with one Montgomery
// multiply by 2^(32 N - 16): 2^240 for BN254, 2^368 for BLS12-381.
// Encoding multiplies by 2^(8 D) mod q (2^272, 2^400) and writes the 4 N
// bytes back with two zero bytes.
#pragma once

#include "field.cuh"

namespace snark {

using Fq = Fp<FqParams>;
using Fq2 = Fp2<FqParams>;
using BlsFq = Fp<BlsFqParams>;
using BlsFq2 = Fp2<BlsFqParams>;

// ---- BN254 (checked against fields/params.py by the port's tests)
// 2^240 mod q, raw (not Montgomery): mont_mul(x * 2^272, C) = x * 2^256.
static __constant__ uint32_t kRowToMont[8] = {0, 0, 0, 0, 0, 0, 0, 0x00010000u};
// 2^272 mod q, raw: mont_mul(x * 2^256, C) = x * 2^272.
static __constant__ uint32_t kMontToRow[8] = {
    0xe1bc3b4fu, 0x2e0850a4u, 0x2f21d2d0u, 0x7d765f42u,
    0xf7c17ab8u, 0x5105616bu, 0x121feb95u, 0x0d42a313u};
// 1 in Montgomery form, 2^256 mod q
static __constant__ uint32_t kOneMont[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// 3b in Montgomery form: G1 b = 3, G2 b = 3 / (9 + u)
static __constant__ uint32_t kB3G1[8] = {
    0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
    0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
static __constant__ uint32_t kB3G2[16] = {
    0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
    0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u,
    0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
    0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};

// ---- BLS12-381
// 2^368, raw: mont_mul(x * 2^400, C) = x * 2^384.
static __constant__ uint32_t kBlsRowToMont[12] = {
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000000u, 0x00010000u};
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
// 3b in Montgomery form: G1 b = 4, G2 b = 4 (1 + u)
static __constant__ uint32_t kBlsB3G1[12] = {
    0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au,
    0x4a6e8b59u, 0x6f7ee9ceu, 0xc0a95bc6u, 0xb10330b7u,
    0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u};
static __constant__ uint32_t kBlsB3G2[24] = {
    0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au,
    0x4a6e8b59u, 0x6f7ee9ceu, 0xc0a95bc6u, 0xb10330b7u,
    0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u,
    0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au,
    0x4a6e8b59u, 0x6f7ee9ceu, 0xc0a95bc6u, 0xb10330b7u,
    0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u};

// The constants of one curve, keyed by its base field's params.
template <class P>
struct CurveConsts;

template <>
struct CurveConsts<FqParams> {
  static constexpr int kRowDigits = 34;
  static __device__ __forceinline__ const uint32_t* row_to_mont() { return kRowToMont; }
  static __device__ __forceinline__ const uint32_t* mont_to_row() { return kMontToRow; }
  static __device__ __forceinline__ const uint32_t* one() { return kOneMont; }
  static __device__ __forceinline__ const uint32_t* b3_g1() { return kB3G1; }
  static __device__ __forceinline__ const uint32_t* b3_g2() { return kB3G2; }
};

template <>
struct CurveConsts<BlsFqParams> {
  static constexpr int kRowDigits = 50;
  static __device__ __forceinline__ const uint32_t* row_to_mont() { return kBlsRowToMont; }
  static __device__ __forceinline__ const uint32_t* mont_to_row() { return kBlsMontToRow; }
  static __device__ __forceinline__ const uint32_t* one() { return kBlsOneMont; }
  static __device__ __forceinline__ const uint32_t* b3_g1() { return kBlsB3G1; }
  static __device__ __forceinline__ const uint32_t* b3_g2() { return kBlsB3G2; }
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
  static __device__ __forceinline__ E b3() { return load_fp<P>(CurveConsts<P>::b3_g1()); }
  static __device__ __forceinline__ E one() { return load_fp<P>(CurveConsts<P>::one()); }
  static __device__ __forceinline__ E zero() {
    E z;
#pragma unroll
    for (int j = 0; j < P::N; ++j) z.v[j] = 0;
    return z;
  }
  static __device__ __forceinline__ E load(const uint32_t* s) { return load_fp<P>(s); }
  static __device__ __forceinline__ void store(uint32_t* d, const E& a) { store_fp<P>(d, a); }
  static __device__ __forceinline__ bool eq(const E& a, const E& b) {
    uint32_t d = 0;
#pragma unroll
    for (int j = 0; j < P::N; ++j) d |= a.v[j] ^ b.v[j];
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
  static __device__ __forceinline__ E b3() {
    return {load_fp<P>(CurveConsts<P>::b3_g2()), load_fp<P>(CurveConsts<P>::b3_g2() + P::N)};
  }
  static __device__ __forceinline__ E one() { return {F::one(), F::zero()}; }
  static __device__ __forceinline__ E zero() { return {F::zero(), F::zero()}; }
  static __device__ __forceinline__ E load(const uint32_t* s) {
    return {load_fp<P>(s), load_fp<P>(s + P::N)};
  }
  static __device__ __forceinline__ void store(uint32_t* d, const E& a) {
    store_fp<P>(d, a.c0);
    store_fp<P>(d + P::N, a.c1);
  }
  static __device__ __forceinline__ bool eq(const E& a, const E& b) {
    return F::eq(a.c0, b.c0) && F::eq(a.c1, b.c1);
  }
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

// RCB15 Alg 7 (a = 0): complete projective add.
template <class E>
__device__ __forceinline__ Point<E> padd(const Point<E>& p, const Point<E>& q) {
  const E b3 = Curve<E>::b3();
  E t0 = p.x * q.x;
  E t1 = p.y * q.y;
  E t2 = p.z * q.z;
  E t3 = (p.x + p.y) * (q.x + q.y) - (t0 + t1);
  E t4 = (p.y + p.z) * (q.y + q.z) - (t1 + t2);
  E y3 = (p.x + p.z) * (q.x + q.z) - (t0 + t2);
  E t0p = (t0 + t0) + t0;
  E t2p = b3 * t2;
  E z3p = t1 + t2p;
  E t1p = t1 - t2p;
  y3 = b3 * y3;
  return {t3 * t1p - t4 * y3, t1p * z3p + y3 * t0p, z3p * t4 + t0p * t3};
}

// RCB15 Alg 8 (a = 0): complete mixed add, q affine (not the identity).
template <class E>
__device__ __forceinline__ Point<E> madd(const Point<E>& p, const E& qx, const E& qy) {
  const E b3 = Curve<E>::b3();
  E t0 = p.x * qx;
  E t1 = p.y * qy;
  E t3 = (p.x + p.y) * (qx + qy) - (t0 + t1);
  E t4 = qy * p.z + p.y;
  E y3 = qx * p.z + p.x;
  E t0p = (t0 + t0) + t0;
  E t2p = b3 * p.z;
  E z3p = t1 + t2p;
  E t1p = t1 - t2p;
  y3 = b3 * y3;
  return {t3 * t1p - t4 * y3, t1p * z3p + y3 * t0p, z3p * t4 + t0p * t3};
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
  const E b3 = Curve<E>::b3();
  E a = p.x * qx;
  E b = p.y * qy;
  E d = qy * p.z;
  E e = qx * p.z;
  E m4 = (p.x + p.y) * (qx + qy);
  E i = b3 * p.z;
  E j = b3 * (e + p.x);
  return {a * b - d * j, b * i + j * a, i * d + a * m4};
}

// halfmul: with a, b, m4, i as for nosub: (a b - m4 i, b + i, a + i).
template <class E>
__device__ __forceinline__ Point<E> madd_halfmul(const Point<E>& p, const E& qx, const E& qy) {
  const E b3 = Curve<E>::b3();
  E a = p.x * qx;
  E b = p.y * qy;
  E m4 = (p.x + p.y) * (qx + qy);
  E i = b3 * p.z;
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

// RCB15 Alg 9 (a = 0): complete projective double (9 multiplications).
template <class E>
__device__ __forceinline__ Point<E> pdbl(const Point<E>& p) {
  const E b3 = Curve<E>::b3();
  E t0 = p.y * p.y;
  E z8 = t0 + t0;
  z8 = z8 + z8;
  z8 = z8 + z8;  // 8 Y^2
  E t1 = p.y * p.z;
  E t2 = b3 * (p.z * p.z);
  E x3 = t2 * z8;
  E y3 = t0 + t2;
  E z3 = t1 * z8;
  E t0n = t0 - ((t2 + t2) + t2);
  y3 = x3 + t0n * y3;
  E xy = t0n * (p.x * p.y);
  return {xy + xy, y3, z3};
}

// ---- rows

// One coordinate component of a u8 row: the low 4 N bytes of x * 2^(8 D).
template <class P>
__device__ __forceinline__ Fp<P> decode_component(const uint8_t* src) {
  Fp<P> w;
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    w.v[j] = (uint32_t)src[4 * j] | ((uint32_t)src[4 * j + 1] << 8) |
             ((uint32_t)src[4 * j + 2] << 16) | ((uint32_t)src[4 * j + 3] << 24);
  }
  return w * load_fp<P>(CurveConsts<P>::row_to_mont());
}

// The inverse of decode_component: D bytes of x * 2^(8 D) mod q (canonical).
template <class P>
__device__ __forceinline__ void encode_component(uint8_t* dst, const Fp<P>& a) {
  const Fp<P> w = a * load_fp<P>(CurveConsts<P>::mont_to_row());
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[4 * j + b] = (uint8_t)(w.v[j] >> (8 * b));
  }
#pragma unroll
  for (int b = 4 * P::N; b < CurveConsts<P>::kRowDigits; ++b) dst[b] = 0;
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

template <class P>
__device__ __forceinline__ void encode_row(uint8_t* row, const Fp<P>& x, const Fp<P>& y) {
  constexpr int D = CurveConsts<P>::kRowDigits;
  encode_component<P>(row, x);
  encode_component<P>(row + D, y);
}

template <class P>
__device__ __forceinline__ void encode_row(uint8_t* row, const Fp2<P>& x, const Fp2<P>& y) {
  constexpr int D = CurveConsts<P>::kRowDigits;
  encode_component<P>(row, x.c0);
  encode_component<P>(row + D, x.c1);
  encode_component<P>(row + 2 * D, y.c0);
  encode_component<P>(row + 3 * D, y.c1);
}

}  // namespace snark
