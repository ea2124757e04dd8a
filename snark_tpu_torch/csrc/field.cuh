// BN254 field core for Hopper: 8 x u32 limbs, Montgomery R = 2^256, CIOS.
//
// Replaces the field core that every TPU kernel of the JAX package inlines:
// snark_tpu/ops/pallas_field_v3.py, PlaneFieldV3.mont_mul, mont_mul_pair,
// mont_mul_x2, mul_const and reduce (and the standalone make_mont_mul_v3).
// The TPU version holds an element as 34 base-256 digits in f32 planes with
// a "wide" R = 2^272 and lazy bounds, because the TPU's vector unit has no
// 32-bit integer multiplier. A Hopper SM has one (IMAD, 64 results per clock
// per SM on compute capability 9.0), so the port uses plain 32-bit limbs.
//
// Every value leaving a function here is fully reduced (canonical, < p).
// That costs one conditional subtraction per mul/add/sub and buys exact
// bit-equality with the plain PyTorch twin (snark_tpu_torch/fields/limbs.py)
// and no value-growth ledger anywhere (the TPU's DIF renormalisation stage
// has no counterpart).
//
// Bound: a Montgomery mul is 2 * 8 * 8 32x32->64 products for a*b and as
// many for m*p, plus 8 for m: 264 32-bit integer multiply-adds counting the
// low and high halves separately. Everything built on it (curve adds,
// butterflies) is bound by that count, not by memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace snark {

// ---- constants (checked against fields/params.py by tests/test_torch_field.py)
// BN254 scalar field Fr
static __constant__ uint32_t kFrP[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// BN254 base field Fq
static __constant__ uint32_t kFqP[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

struct FrParams {
  static constexpr uint32_t kN0 = 0xefffffffu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ uint32_t p(int i) { return kFrP[i]; }
};

struct FqParams {
  static constexpr uint32_t kN0 = 0xe4866389u;
  static __device__ __forceinline__ uint32_t p(int i) { return kFqP[i]; }
};

template <class P>
struct Fp {
  uint32_t v[8];
};

template <class P>
struct Fp2 {
  Fp<P> c0, c1;
};

// r = t - p if t >= p else t, for t < 2p (t < 2^255, so it fits 8 limbs)
template <class P>
__device__ __forceinline__ Fp<P> reduce_once(const uint32_t t[8]) {
  Fp<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)t[j] - (uint64_t)P::p(j) - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = borrow ? t[j] : d.v[j];
  return r;
}

template <class P>
__device__ __forceinline__ Fp<P> operator+(const Fp<P>& a, const Fp<P>& b) {
  uint32_t t[8];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)a.v[j] + b.v[j] + carry;
    t[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  return reduce_once<P>(t);  // a + b < 2p < 2^255: no carry out of limb 7
}

template <class P>
__device__ __forceinline__ Fp<P> operator-(const Fp<P>& a, const Fp<P>& b) {
  Fp<P> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t s = (uint64_t)a.v[j] - (uint64_t)b.v[j] - borrow;
    d.v[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {  // a < b: add p back
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
  for (int j = 0; j < 8; ++j) z.v[j] = 0;
  return z - a;
}

// CIOS Montgomery product a * b * 2^-256 mod p, canonical in and out.
template <class P>
__device__ __forceinline__ Fp<P> operator*(const Fp<P>& a, const Fp<P>& b) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * P::kN0;
    s = (uint64_t)m * P::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * P::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  return reduce_once<P>(t);  // t < 2p, t[8] == 0
}

// ---- Fq2 = Fq[u] / (u^2 + 1)
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

// ---- loads and stores of (..., 8) u32 limb rows
template <class P>
__device__ __forceinline__ Fp<P> load_fp(const uint32_t* src) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = src[j];
  return r;
}

template <class P>
__device__ __forceinline__ void store_fp(uint32_t* dst, const Fp<P>& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = a.v[j];
}

}  // namespace snark
