// Field core for Hopper: N x u32 limbs, Montgomery R = 2^(32 N), CIOS
// written as carry chains.
//
// One template over a params struct, which gives the limb count N, the
// modulus p, -p^-1 mod 2^32 and the field's bound (kLazy, below). The
// instances: BN254 Fr and Fq and BLS12-381 Fr (N = 8, R = 2^256),
// BLS12-381 Fq (N = 12, R = 2^384).
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
// The product. Written with 64-bit sums (s = a*b + t + c), each multiply-
// add is a wide multiply and two 64-bit adds with the carries held in
// registers: about 650 instructions a product at N = 8, most of them carry
// adds. Here every multiply-add is one PTX instruction of a carry chain
// (chain.cuh): the low halves of a_j b_i go to word j and the high halves
// to word j + 1, so the words of a at even positions feed one chain (the
// array `even`, word k of weight 2^(32 k)) and those at odd positions
// another (`odd`, word k of weight 2^(32 (k + 1))); no two products of a
// chain write the same word. One CIOS step adds a b_i to both, then m p
// with m = even[0] n0, which zeroes even[0]. The division by 2^32 that ends
// the step moves no word: the next step takes `odd` as its even array and
// `even`, read two words up, as its odd one (cios_step). The two arrays are
// merged once, after the last step. A step is 4N + 4 instructions, 4N + 1
// of them multiplies; the product is 4N^2 + 5N - 2 (294 at N = 8, 634 at
// N = 12) against 4N^2 + N multiply-adds, and a canonical field adds a
// conditional subtraction (2N + 1). tests/test_torch_mont_chain.py runs this
// exact instruction sequence on a word-level model of the carry flag, for
// all four fields, against the integers and fields/limbs.py
// mont_mul_plain: it is the product's rehearsal.
//
// Bounds. Each field keeps its values below a bound modulus M:
//   canonical (kLazy false, the scalar fields): M = p, every value in
//     [0, p). Needs p < R/2: BLS12-381 Fr (255 bits) has nothing more.
//   lazy (kLazy true, the base fields, p < R/4: BN254 Fq 254 of 256 bits,
//     BLS12-381 Fq 381 of 384): M = 2p, values in [0, 2p) between
//     operations. Only what a kernel stores or compares is reduced to [0, p):
//     store_fp, row_value (curve.cuh) and Curve::eq call canon, so
//     every stored value is canonical and equals the plain version's.
// With every operand in [0, M):
//   add        a + b < 2M <= R: nothing carries out of word N-1; M is taken
//              off when that does not borrow.
//   sub        a - b wraps by R when it borrows; adding M back wraps by R
//              again and the two cancel.
//   mont_mul   after step i, T_i = (T_{i-1} + a b_i + m_i p) / 2^32. If
//              T_{i-1} < a + p, the step's sum is below (a + p) 2^32 and
//              T_i < a + p. That sum is below 3p 2^32 < 2^32 R (lazy,
//              a < 2p) or 2p 2^32 (canonical): it fits the N + 1 words of
//              the two arrays and nothing carries out of their top word.
//              The result T_N = (a b + m p) / R < a b / R + p. Lazy:
//              a b / R < 4p^2 / R < p, so T_N < 2p = M with no subtraction.
//              Canonical: T_N < 2p, and one conditional subtraction of p.
//   decode     (curve.cuh) any w < R: (w + m p) / 2^16 < R / 2^16 + p < 2p.
//
// Bound: a Montgomery mul is 2 N^2 32x32->64 products for a*b and as many
// for m*p, plus N for m: 2N^2 + 2N^2 + N = 264 32-bit integer multiply-adds
// at N = 8 and 588 at N = 12, counting the low and high halves
// separately. Everything built on it (curve adds, butterflies) is bound by
// that count, not by memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"

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
// BN254 base field Fq, and 2q
static __constant__ uint32_t kFqP[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ uint32_t kFqP2[8] = {
    0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
    0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
// BLS12-381 scalar field Fr (255 bits)
static __constant__ uint32_t kBlsFrP[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// BLS12-381 base field Fq (381 bits), and 2q
static __constant__ uint32_t kBlsFqP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t kBlsFqP2[12] = {
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
    0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
    0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
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

// p(i): word i of p; bound(i): word i of the bound modulus M (2p where
// kLazy, else p; see the bounds above). kInlineMul: whether the field's
// product is inlined at its uses (see operator* below). The base fields
// also give their Fermat exponent: its word i (pm2) and its bit length
// (kPm2Bits).
struct FrParams {
  static constexpr uint32_t kN0 = 0xefffffffu;  // -p^-1 mod 2^32
  static constexpr int N = 8;
  static constexpr bool kLazy = false;
  static constexpr bool kInlineMul = true;
  static __device__ __forceinline__ uint32_t p(int i) { return kFrP[i]; }
  static __device__ __forceinline__ uint32_t bound(int i) { return kFrP[i]; }
};

struct FqParams {
  static constexpr uint32_t kN0 = 0xe4866389u;
  static constexpr int N = 8;
  static constexpr bool kLazy = true;
  static constexpr bool kInlineMul = true;
  static __device__ __forceinline__ uint32_t p(int i) { return kFqP[i]; }
  static __device__ __forceinline__ uint32_t bound(int i) { return kFqP2[i]; }
  static constexpr int kPm2Bits = 254;
  static __device__ __forceinline__ uint32_t pm2(int i) { return kQMinus2[i]; }
};

struct BlsFrParams {
  static constexpr uint32_t kN0 = 0xffffffffu;
  static constexpr int N = 8;
  static constexpr bool kLazy = false;
  static constexpr bool kInlineMul = true;
  static __device__ __forceinline__ uint32_t p(int i) { return kBlsFrP[i]; }
  static __device__ __forceinline__ uint32_t bound(int i) { return kBlsFrP[i]; }
};

struct BlsFqParams {
  static constexpr uint32_t kN0 = 0xfffcfffdu;
  static constexpr int N = 12;
  static constexpr bool kLazy = true;
  static constexpr bool kInlineMul = false;
  static __device__ __forceinline__ uint32_t p(int i) { return kBlsFqP[i]; }
  static __device__ __forceinline__ uint32_t bound(int i) { return kBlsFqP2[i]; }
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

// The words of p and of M as arrays for the chains below
template <class P>
struct Modulus {
  __device__ __forceinline__ uint32_t operator[](int i) const { return P::p(i); }
};

template <class P>
struct BoundModulus {
  __device__ __forceinline__ uint32_t operator[](int i) const { return P::bound(i); }
};

// r = t - m if t >= m else t, for t < 2m (m = p or M, word by word)
template <class P, class Mod>
__device__ __forceinline__ Fp<P> sub_if_ge(const uint32_t t[P::N], const Mod& m) {
  constexpr int N = P::N;
  uint32_t d[N];
  d[0] = chain::sub_cc(t[0], m[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = chain::subc_cc(t[j], m[j]);
  const uint32_t keep = chain::borrow_mask();  // t < m
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = keep ? t[j] : d[j];
  return r;
}

// r = t - p if t >= p else t, for t < 2p: the canonical value
template <class P>
__device__ __forceinline__ Fp<P> reduce_once(const uint32_t t[P::N]) {
  return sub_if_ge<P>(t, Modulus<P>{});
}

// The canonical value of a (a no-op in a canonical field)
template <class P>
__device__ __forceinline__ Fp<P> canon(const Fp<P>& a) {
  if constexpr (P::kLazy) {
    return reduce_once<P>(a.v);
  } else {
    return a;
  }
}

template <class P>
__device__ __forceinline__ Fp<P> operator+(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  uint32_t t[N];
  t[0] = chain::add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) t[j] = chain::addc_cc(a.v[j], b.v[j]);
  t[N - 1] = chain::addc(a.v[N - 1], b.v[N - 1]);  // a + b < 2M <= R
  return sub_if_ge<P>(t, BoundModulus<P>{});
}

template <class P>
__device__ __forceinline__ Fp<P> operator-(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  uint32_t d[N];
  d[0] = chain::sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = chain::subc_cc(a.v[j], b.v[j]);
  const uint32_t wrap = chain::borrow_mask();  // a < b: add M back
  Fp<P> r;
  r.v[0] = chain::add_cc(d[0], P::bound(0) & wrap);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r.v[j] = chain::addc_cc(d[j], P::bound(j) & wrap);
  r.v[N - 1] = chain::addc(d[N - 1], P::bound(N - 1) & wrap);  // the carry out cancels the borrow
  return r;
}

template <class P>
__device__ __forceinline__ Fp<P> neg(const Fp<P>& a) {
  Fp<P> z;
#pragma unroll
  for (int j = 0; j < P::N; ++j) z.v[j] = 0;
  return z - a;
}

// k a for a small constant k (9 and 12, the curves' 3b), by additions
template <int K, class P>
__device__ __forceinline__ Fp<P> times(const Fp<P>& a) {
  static_assert(K == 9 || K == 12, "3b of BN254 G1 (9) or BLS12-381 (12)");
  const Fp<P> a2 = a + a;
  const Fp<P> a4 = a2 + a2;
  const Fp<P> a8 = a4 + a4;
  if constexpr (K == 9) {
    return a8 + a;
  } else {
    return a8 + a4;
  }
}

// ---- the product
//
// The chains of one CIOS step (see the header). `A` is an array of words,
// or a Modulus; `Off` picks its even (0) or odd (1) positions.

// acc[j], acc[j+1] = lo, hi of a[j + Off] b for even j
template <int N, int Off, class A>
__device__ __forceinline__ void mul_n(uint32_t* acc, const A& a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = chain::mul_lo(a[j + Off], b);
    acc[j + 1] = chain::mul_hi(a[j + Off], b);
  }
}

// acc += a[Off + even positions] b as one chain; the carry out of acc[N-1]
// stays in the flag
template <int N, int Off, class A>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const A& a, uint32_t b) {
  acc[0] = chain::mad_lo_cc(a[Off], b, acc[0]);
  acc[1] = chain::madc_hi_cc(a[Off], b, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = chain::madc_lo_cc(a[j + Off], b, acc[j]);
    acc[j + 1] = chain::madc_hi_cc(a[j + Off], b, acc[j + 1]);
  }
}

// odd = odd >> 2 words + a[odd positions] b, taking the flag as carry in
template <int N, class A>
__device__ __forceinline__ void madc_n_rshift(uint32_t* odd, const A& a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    odd[j] = chain::madc_lo_cc(a[j + 1], b, odd[j + 2]);
    odd[j + 1] = chain::madc_hi_cc(a[j + 1], b, odd[j + 3]);
  }
  odd[N - 2] = chain::madc_lo_cc(a[N - 1], b, 0);
  odd[N - 1] = chain::madc_hi(a[N - 1], b, 0);
}

// One CIOS step on t = even + 2^32 odd: t = t / 2^32 + a b (the division
// by reading the arrays in their swapped roles, as the caller passes
// them), then t += m p with m = even[0] n0, so that even[0] = 0.
template <class P>
__device__ __forceinline__ void cios_step(uint32_t* even, uint32_t* odd, const uint32_t* a,
                                          uint32_t b, bool first) {
  constexpr int N = P::N;
  if (first) {
    mul_n<N, 1>(odd, a, b);
    mul_n<N, 0>(even, a, b);
  } else {
    even[0] = chain::add_cc(even[0], odd[1]);
    madc_n_rshift<N>(odd, a, b);
    cmad_n<N, 0>(even, a, b);
    odd[N - 1] = chain::addc(odd[N - 1], 0);
  }
  const uint32_t m = chain::mul_lo(even[0], P::kN0);
  cmad_n<N, 1>(odd, Modulus<P>{}, m);  // nothing carries out of odd (the bound)
  cmad_n<N, 0>(even, Modulus<P>{}, m);
  odd[N - 1] = chain::addc(odd[N - 1], 0);
}

// Montgomery product a * b * R^-1 mod p: in [0, 2p) for a lazy field, [0, p)
// for a canonical one (see the bounds above).
template <class P>
__device__ __forceinline__ Fp<P> mont_mul(const Fp<P>& a, const Fp<P>& b) {
  constexpr int N = P::N;
  static_assert(N % 2 == 0, "the even and odd chains pair the words");
  uint32_t even[N], odd[N];
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    cios_step<P>(even, odd, a.v, b.v[i], i == 0);
    cios_step<P>(odd, even, a.v, b.v[i + 1], false);
  }
  // t = (even + 2^32 odd) / 2^32 with even[0] = 0, the arrays in the roles
  // of the last step: odd as the even array, even as the odd one
  uint32_t t[N];
  t[0] = chain::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) t[k] = chain::addc_cc(even[k], odd[k + 1]);
  t[N - 1] = chain::addc(even[N - 1], 0);  // t < 2p < R
  if constexpr (P::kLazy) {
    Fp<P> r;
#pragma unroll
    for (int k = 0; k < N; ++k) r.v[k] = t[k];
    return r;
  } else {
    return reduce_once<P>(t);
  }
}

// The same product as a called function: the 12-limb field's (kInlineMul
// false) and the three of every Fq2 product. Inlined, a K1 step holds 11
// to 33 products, a loop body of up to 155 KB of code. Timed in turns on
// one NVIDIA H100 80GB HBM3 (700 W), K1 ran 6.5% faster with the calls in
// BLS12-381 G1 and in BN254 G2, where ptxas also spilled less (BLS12-381
// G2: 268 bytes of spill stores against 680); in BN254 G1 the calls made
// the bench's main scan 16% slower, so the 8-limb G1 kernels inline it.
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

// Karatsuba: 3 base muls, each a call; the canonical result equals the
// schoolbook one.
template <class P>
__device__ __forceinline__ Fp2<P> operator*(const Fp2<P>& a, const Fp2<P>& b) {
  Fp<P> v0 = mont_mul_call(a.c0, b.c0);
  Fp<P> v1 = mont_mul_call(a.c1, b.c1);
  Fp<P> s = mont_mul_call(a.c0 + a.c1, b.c0 + b.c1);
  return {v0 - v1, (s - v0) - v1};
}

// ---- loads and stores of (..., N) u32 limb rows; a store writes the
// canonical value
template <class P>
__device__ __forceinline__ Fp<P> load_fp(const uint32_t* src) {
  Fp<P> r;
#pragma unroll
  for (int j = 0; j < P::N; ++j) r.v[j] = src[j];
  return r;
}

template <class P>
__device__ __forceinline__ void store_fp(uint32_t* dst, const Fp<P>& a) {
  const Fp<P> c = canon(a);
#pragma unroll
  for (int j = 0; j < P::N; ++j) dst[j] = c.v[j];
}

}  // namespace snark
