// BN254 curve arithmetic shared by the curve kernels (curve.cu) and the
// batch-affine kernels (affine.cu): G1 over Fq, G2 over Fq2.
//
// Points are projective (X, Y, Z) in the port's limb format (field.cuh):
// a lane is 3 * K * 8 u32 words, K = 1 for G1 and 2 for G2, contiguous.
// The formulas are the complete ones of Renes-Costello-Batina 2015 for
// a = 0 (Alg 7 projective add, Alg 8 mixed add, Alg 9 double), so doubling,
// identity and inverse inputs need no branches.
//
// Rows are the reference's u8 table layout: X digits || Y digits || identity
// flag, each coordinate component 34 little-endian bytes of x * 2^272 mod q
// (wide Montgomery, canonical; the top two bytes are zero). Decoding reads
// the low 32 bytes and moves the value to R = 2^256 with one Montgomery
// multiply by 2^240; encoding multiplies by 2^272 mod q and writes the 32
// bytes back with two zero bytes.
#pragma once

#include "field.cuh"

namespace snark {

using Fq = Fp<FqParams>;
using Fq2 = Fp2<FqParams>;

constexpr int kRowDigits = 34;

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

template <class E>
struct Curve;

template <>
struct Curve<Fq> {
  static constexpr int K = 1;
  static __device__ __forceinline__ Fq b3() { return load_fp<FqParams>(kB3G1); }
  static __device__ __forceinline__ Fq one() { return load_fp<FqParams>(kOneMont); }
  static __device__ __forceinline__ Fq zero() {
    Fq z;
#pragma unroll
    for (int j = 0; j < 8; ++j) z.v[j] = 0;
    return z;
  }
  static __device__ __forceinline__ Fq load(const uint32_t* s) {
    return load_fp<FqParams>(s);
  }
  static __device__ __forceinline__ void store(uint32_t* d, const Fq& a) {
    store_fp<FqParams>(d, a);
  }
  static __device__ __forceinline__ bool eq(const Fq& a, const Fq& b) {
    uint32_t d = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) d |= a.v[j] ^ b.v[j];
    return d == 0;
  }
};

template <>
struct Curve<Fq2> {
  static constexpr int K = 2;
  static __device__ __forceinline__ Fq2 b3() {
    return {load_fp<FqParams>(kB3G2), load_fp<FqParams>(kB3G2 + 8)};
  }
  static __device__ __forceinline__ Fq2 one() { return {Curve<Fq>::one(), Curve<Fq>::zero()}; }
  static __device__ __forceinline__ Fq2 zero() { return {Curve<Fq>::zero(), Curve<Fq>::zero()}; }
  static __device__ __forceinline__ Fq2 load(const uint32_t* s) {
    return {load_fp<FqParams>(s), load_fp<FqParams>(s + 8)};
  }
  static __device__ __forceinline__ void store(uint32_t* d, const Fq2& a) {
    store_fp<FqParams>(d, a.c0);
    store_fp<FqParams>(d + 8, a.c1);
  }
  static __device__ __forceinline__ bool eq(const Fq2& a, const Fq2& b) {
    return Curve<Fq>::eq(a.c0, b.c0) && Curve<Fq>::eq(a.c1, b.c1);
  }
};

template <class E>
struct Point {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Point<E> load_point(const uint32_t* s) {
  constexpr int W = 8 * Curve<E>::K;
  return {Curve<E>::load(s), Curve<E>::load(s + W), Curve<E>::load(s + 2 * W)};
}

template <class E>
__device__ __forceinline__ void store_point(uint32_t* d, const Point<E>& p) {
  constexpr int W = 8 * Curve<E>::K;
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

// One coordinate component of a u8 row: 32 little-endian bytes of x * 2^272.
__device__ __forceinline__ Fq decode_component(const uint8_t* src) {
  Fq w;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w.v[j] = (uint32_t)src[4 * j] | ((uint32_t)src[4 * j + 1] << 8) |
             ((uint32_t)src[4 * j + 2] << 16) | ((uint32_t)src[4 * j + 3] << 24);
  }
  return w * load_fp<FqParams>(kRowToMont);
}

// The inverse of decode_component: 34 bytes of x * 2^272 mod q (canonical).
__device__ __forceinline__ void encode_component(uint8_t* dst, const Fq& a) {
  const Fq w = a * load_fp<FqParams>(kMontToRow);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[4 * j + b] = (uint8_t)(w.v[j] >> (8 * b));
  }
  dst[32] = 0;
  dst[33] = 0;
}

__device__ __forceinline__ void decode_row(const uint8_t* row, Fq& x, Fq& y) {
  x = decode_component(row);
  y = decode_component(row + kRowDigits);
}

__device__ __forceinline__ void decode_row(const uint8_t* row, Fq2& x, Fq2& y) {
  x = {decode_component(row), decode_component(row + kRowDigits)};
  y = {decode_component(row + 2 * kRowDigits), decode_component(row + 3 * kRowDigits)};
}

__device__ __forceinline__ void encode_row(uint8_t* row, const Fq& x, const Fq& y) {
  encode_component(row, x);
  encode_component(row + kRowDigits, y);
}

__device__ __forceinline__ void encode_row(uint8_t* row, const Fq2& x, const Fq2& y) {
  encode_component(row, x.c0);
  encode_component(row + kRowDigits, x.c1);
  encode_component(row + 2 * kRowDigits, y.c0);
  encode_component(row + 3 * kRowDigits, y.c1);
}

}  // namespace snark
