// Field core for Hopper: N x u32 limbs, Montgomery R = 2^(32 N), CIOS.
//
// One template over a params struct, which gives the limb count N, the
// modulus p and -p^-1 mod 2^32. The instances: BN254 Fr and Fq and
// BLS12-381 Fr (N = 8, R = 2^256), BLS12-381 Fq (N = 12, R = 2^384).
//
// Replaces the field core that every TPU kernel of the JAX package inlines:
// snark_tpu/ops/pallas_field_v3.py, PlaneFieldV3.mont_mul, mont_mul_pair,
// mont_mul_x2, mul_const and reduce (and the standalone make_mont_mul_v3),
// which the reference builds for either curve from its CurveParams.
// The TPU version holds an element as base-256 digits in f32 planes with
// a "wide" R (2^272 for BN254, 2^400 for BLS12-381 Fq) and lazy bounds,
// because the TPU's vector unit has no 32-bit integer multiplier. A Hopper
// SM has one (IMAD, 64 results per clock per SM on compute capability
// 9.0), so the port uses plain 32-bit limbs.
//
// Every value leaving a function here is fully reduced (canonical, < p).
// That costs one conditional subtraction per mul/add/sub and buys exact
// bit-equality with the plain PyTorch twin (snark_tpu_torch/fields/limbs.py)
// and no value-growth ledger anywhere (the TPU's DIF renormalisation stage
// has no counterpart).
//
// The one bound the core relies on is p < R/2 (BLS12-381 Fr, 255 bits,
// meets it with nothing to spare; the others have two or more spare bits):
//   add        a, b < p, so a + b < 2p < R: no carry out of limb N-1.
//   CIOS       if t < 2p before a step, the step's t + a*b_i < 2p +
//              (2^32 - 1) p < 2^32 R fits N + 1 words, adding m*p keeps
//              it below 2^33 p < 2^32 R, and the shift by one word leaves
//              t < 2p < R: word N is 0 after every step.
//   reduce_once t < 2p < R in N words; t - p is taken only when it does
//              not borrow, so nothing leaves limb N-1.
//   sub        a - b wraps by R when it borrows; adding p back wraps by R
//              again, and the two cancel.
//
// Bound: a Montgomery mul is 2 N^2 32x32->64 products for a*b and as many
// for m*p, plus N for m: 2N^2 + 2N^2 + N = 264 32-bit integer multiply-adds
// at N = 8 and 588 at N = 12, counting the low and high halves
// separately. Everything built on it (curve adds, butterflies) is bound by
// that count, not by memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace snark {

// Curve codes of the C entry points; an entry point returns kNotPorted for
// a curve it has no instance for.
constexpr int kBn254 = 0;
constexpr int kBls12_381 = 1;
constexpr int kNotPorted = -1;

// ---- constants (checked against fields/params.py by the port's tests)
// BN254 scalar field Fr
static __constant__ uint32_t kFrP[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// BN254 base field Fq
static __constant__ uint32_t kFqP[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// BLS12-381 scalar field Fr (255 bits)
static __constant__ uint32_t kBlsFrP[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// BLS12-381 base field Fq (381 bits)
static __constant__ uint32_t kBlsFqP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// The Fermat exponents q - 2 of the two base fields (the inverse of the
// batch-affine tree, affine_kernels.cuh): BN254 Fq (254 bits)
static __constant__ uint32_t kQMinus2[8] = {
    0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// and BLS12-381 Fq (381 bits)
static __constant__ uint32_t kBlsQMinus2[12] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// kInlineMul: whether the Montgomery product is inlined at every use (see
// operator* below). The base fields also give their Fermat exponent: its
// word i (pm2) and its bit length (kPm2Bits).
struct FrParams {
  static constexpr uint32_t kN0 = 0xefffffffu;  // -p^-1 mod 2^32
  static constexpr int N = 8;
  static constexpr bool kInlineMul = true;
  static __device__ __forceinline__ uint32_t p(int i) { return kFrP[i]; }
};

struct FqParams {
  static constexpr uint32_t kN0 = 0xe4866389u;
  static constexpr int N = 8;
  static constexpr bool kInlineMul = true;
  static __device__ __forceinline__ uint32_t p(int i) { return kFqP[i]; }
  static constexpr int kPm2Bits = 254;
  static __device__ __forceinline__ uint32_t pm2(int i) { return kQMinus2[i]; }
};

struct BlsFrParams {
  static constexpr uint32_t kN0 = 0xffffffffu;
  static constexpr int N = 8;
  static constexpr bool kInlineMul = true;
  static __device__ __forceinline__ uint32_t p(int i) { return kBlsFrP[i]; }
};

struct BlsFqParams {
  static constexpr uint32_t kN0 = 0xfffcfffdu;
  static constexpr int N = 12;
  static constexpr bool kInlineMul = false;
  static __device__ __forceinline__ uint32_t p(int i) { return kBlsFqP[i]; }
  static constexpr int kPm2Bits = 381;
  static __device__ __forceinline__ uint32_t pm2(int i) { return kBlsQMinus2[i]; }
};

template <class P>
struct Fp {
  uint32_t v[P::N];
};

template <class P>
struct Fp2 {
  Fp<P> c0, c1;
};

// r = t - p if t >= p else t, for t < 2p (see the bound above)
template <class P>
__device__ __forceinline__ Fp<P> reduce_once(const uint32_t t[P::N]) {
  constexpr int N = P::N;
  Fp<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)t[j] - (uint64_t)P::p(j) - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = borrow ? t[j] : d.v[j];
  return r;
}

template <class P>
__device__ __forceinline__ Fp<P> operator+(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)a.v[j] + b.v[j] + carry;
    t[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  return reduce_once<P>(t);  // a + b < 2p < R: no carry out of limb N-1
}

template <class P>
__device__ __forceinline__ Fp<P> operator-(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  Fp<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t s = (uint64_t)a.v[j] - (uint64_t)b.v[j] - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {  // a < b: add p back
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)d.v[j] + P::p(j) + carry;
      d.v[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
  }
  return d;
}

template <class P>
__device__ __forceinline__ Fp<P> neg(const Fp<P>& a) {
  Fp<P> z;
#pragma unroll
  for (int j = 0; j < P::N; ++j) z.v[j] = 0;
  return z - a;
}

// CIOS Montgomery product a * b * R^-1 mod p, canonical in and out.
template <class P>
__device__ __forceinline__ Fp<P> mont_mul(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * P::kN0;
    s = (uint64_t)m * P::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * P::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  return reduce_once<P>(t);  // t < 2p, t[N] == 0 (see the bound above)
}

// The same product as a called function. At 12 limbs one product is about
// a thousand instructions, and the BLS12-381 G2 scan kernel (K1) has some 45 of
// them: inlined at every use, that kernel crashed nvcc. A call costs a few
// dozen cycles against the product's ~600 multiply-adds.
template <class P>
__device__ __noinline__ Fp<P> mont_mul_call(const Fp<P> a, const Fp<P> b) {
  return mont_mul<P>(a, b);
}

template <class P>
__device__ __forceinline__ Fp<P> operator*(const Fp<P>& a, const Fp<P>& b) {
  if constexpr (P::kInlineMul) {
    return mont_mul<P>(a, b);
  } else {
    return mont_mul_call<P>(a, b);
  }
}

// ---- Fq2 = Fq[u] / (u^2 + 1), on both curves
template <class P>
__device__ __forceinline__ Fp2<P> operator+(const Fp2<P>& a, const Fp2<P>& b) {
  return {a.c0 + b.c0, a.c1 + b.c1};
}

template <class P>
__device__ __forceinline__ Fp2<P> operator-(const Fp2<P>& a, const Fp2<P>& b) {
  return {a.c0 - b.c0, a.c1 - b.c1};
}

template <class P>
__device__ __forceinline__ Fp2<P> neg(const Fp2<P>& a) {
  return {neg(a.c0), neg(a.c1)};
}

// Karatsuba: 3 base muls; the canonical result equals the schoolbook one.
template <class P>
__device__ __forceinline__ Fp2<P> operator*(const Fp2<P>& a, const Fp2<P>& b) {
  Fp<P> v0 = a.c0 * b.c0;
  Fp<P> v1 = a.c1 * b.c1;
  Fp<P> s = (a.c0 + a.c1) * (b.c0 + b.c1);
  return {v0 - v1, (s - v0) - v1};
}

// ---- loads and stores of (..., N) u32 limb rows
template <class P>
__device__ __forceinline__ Fp<P> load_fp(const uint32_t* src) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < P::N; ++j) r.v[j] = src[j];
  return r;
}

template <class P>
__device__ __forceinline__ void store_fp(uint32_t* dst, const Fp<P>& a) {
#pragma unroll
  for (int j = 0; j < P::N; ++j) dst[j] = a.v[j];
}

}  // namespace snark
