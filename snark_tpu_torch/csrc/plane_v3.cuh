// Device code of the float32 digit-plane field (the port's PlaneFieldV3,
// snark_tpu_torch/ops/plane_field_v3.py) shared by the kernels that run it:
// K15 (vpu_peak.cu), K16 and K17 (mul_parts.cu). A lane's element is R
// base-256 digits held in registers, one float each; every function takes
// the digits as fixed-size arrays, so with R a template constant every loop
// unrolls and every index is a register.
//
// Lazy digits: a digit may exceed 255 or be negative while every partial
// sum stays an integer below 2^24, which float32 holds exactly; the sweeps
// scale by a power of two and floor, which is exact on such integers. So
// these functions give the plain version's digits whatever order they sum
// in, and may use FMAs. Where a caller leaves that range (K17's conv0 and
// conv1), it takes mul_acc's rounded form, which rounds as the plain
// version does.
//
// The sweeps' floor is a template flag (kRd), false by default:
//   false: floorf, which compiles to FRND, an instruction that issues at a
//          fraction of the FP32 rate on sm_90 (K13-K15, K17's conv1);
//   true:  c = __fmaf_rd(z, 2^-8, 1.5 2^23) - 1.5 2^23, an FFMA rounding
//          toward -inf and an FADD, both at the full FP32 rate. For
//          -2^30 <= z <= 2^30 the exact sum z 2^-8 + 1.5 2^23 lies in
//          [2^23, 2^24], where float32's spacing is 1, so rounding it down
//          is its floor and the FADD is exact: c = floor(z / 256). Beyond
//          that range it is not (z = 2^30 + 256 gives 2^22, not 2^22 + 1;
//          z = -2^30 - 128 gives -2^22 - 1/2). K16's kinds and K17's conv3,
//          conv9, sweep9 and convreg take it: every value they sweep is a
//          product sum of 34 digits below 2^9 and 2^8 plus a few such
//          terms, below 2^23 (tests/test_torch_mul_parts_grid.py pins the
//          largest). conv1 keeps floorf: its values reach 1.5e11.
//   The count per row stays 4 FP32 instructions either way.

#pragma once

#include <cuda_runtime.h>

namespace snark {

constexpr int kCarryRows = 12;  // rows of s_lo that reach the carry (>= 2^-73)

// BN254 Fq, R8 = 34 (extra_digits = 2): the digits of N' = -p^-1 mod 256^34,
// of p and of 2p, as the port's PlaneFieldV3 makes them (checked against it
// by the port's tests).
struct Bn254Fq34 {
  static constexpr int kRows = 34;
  __host__ __device__ static constexpr float np(int i) {
    constexpr float d[34] = {137, 99,  134, 228, 130, 7,   210, 135, 201, 106, 202, 30,
                             101, 125, 222, 158, 128, 218, 51,  24,  208, 203, 175, 216,
                             107, 140, 136, 145, 183, 34,  122, 245, 111, 44};
    return d[i];
  }
  __host__ __device__ static constexpr float p(int i) {
    constexpr float d[34] = {71,  253, 124, 216, 22, 140, 32,  60,  141, 202, 113, 104,
                             145, 106, 129, 151, 93, 88,  129, 129, 182, 69,  80,  184,
                             41,  160, 49,  225, 114, 78, 100, 48,  0,   0};
    return d[i];
  }
  __host__ __device__ static constexpr float p2(int i) {
    constexpr float d[34] = {142, 250, 249, 176, 45, 24,  65,  120, 26,  149, 227, 208,
                             34,  213, 2,   47,  187, 176, 2,   3,   109, 139, 160, 112,
                             83,  64,  99,  194, 229, 156, 200, 96,  0,   0};
    return d[i];
  }
};

// 2^(8 e) for -15 <= e <= 0, from its exponent bits: an immediate once the
// loop that calls it unrolls
__device__ __forceinline__ float pow256(int e) { return __int_as_float((127 + 8 * e) << 23); }

// One base-256 carry sweep between rows, in place (the reference's
// _sweep): c_i = floor(z_i / 256) (floor256), r_i = z_i - 256 c_i, z_i = r_i + c_{i-1};
// the carry out of the top row is dropped. 256 c_i is exact, so the FMA
// rounds z_i - 256 c_i once, as the plain version's subtraction does.
template <bool kRd>
__device__ __forceinline__ float floor256(float z) {
  if constexpr (kRd) {
    return __fadd_rn(__fmaf_rd(z, 1.0f / 256.0f, 12582912.0f), -12582912.0f);
  } else {
    return floorf(z * (1.0f / 256.0f));
  }
}

template <int R, bool kRd = false>
__device__ __forceinline__ void sweep(float (&z)[R]) {
  float carry = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float c = floor256<kRd>(z[i]);
    const float r = __fmaf_rn(-256.0f, c, z[i]);
    z[i] = i == 0 ? r : __fadd_rn(r, carry);
    carry = c;
  }
}

template <int R, bool kRd = false>
__device__ __forceinline__ void sweep3(float (&z)[R]) {
  sweep<R, kRd>(z);
  sweep<R, kRd>(z);
  sweep<R, kRd>(z);
}

// t = A B, the lazy 2R-row digit product (the reference's mul_acc): row i
// of A times B added at row offset i, over increasing i. Fused: one FMA a
// term, exact on integer digits below 2^24. Rounded: the product and the
// sum each rounded, in the plain version's order, for values beyond 2^24.
template <int R, bool kFused>
__device__ __forceinline__ void mul_acc(const float (&A)[R], const float (&B)[R],
                                        float (&t)[2 * R]) {
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) t[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      t[i + j] = kFused ? __fmaf_rn(A[i], B[j], t[i + j])
                        : __fadd_rn(t[i + j], __fmul_rn(A[i], B[j]));
    }
  }
}

// The Montgomery reduction of a lazy product t in three steps, which the
// band-product kernel (K16 A) reuses around its own m and m p:
//   u = sweep3(t mod R)                               (reduce_low)
//   m = sweep3(u N' mod R), scalar constants, in u    (reduce_np)
//   t += m p on the rows that reach the carry or the high half
//                                                     (reduce_add_mp)
//   A = sweep3(s_hi + carry + 2p)                     (reduce_out)
template <int R, bool kRd = false>
__device__ __forceinline__ void reduce_low(const float (&t)[2 * R], float (&u)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) u[i] = t[i];
  sweep3<R, kRd>(u);
}

// In place, from the top row down, as u[k] reads only rows <= k; zero
// digits of N' skipped at compile time.
template <class F, bool kRd = false>
__device__ __forceinline__ void reduce_np(float (&u)[F::kRows]) {
  constexpr int R = F::kRows;
#pragma unroll
  for (int k = R - 1; k >= 0; --k) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i <= k; ++i) {
      if (F::np(i) != 0.0f) acc = __fmaf_rn(F::np(i), u[k - i], acc);
    }
    u[k] = acc;
  }
  sweep3<R, kRd>(u);
}

// Rows below R - kCarryRows are never read after this, so they are skipped.
template <class F>
__device__ __forceinline__ void reduce_add_mp(float (&t)[2 * F::kRows], const float (&u)[F::kRows]) {
  constexpr int R = F::kRows;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (F::p(i) == 0.0f) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (i + j >= R - kCarryRows) t[i + j] = __fmaf_rn(F::p(i), u[j], t[i + j]);
    }
  }
}

// carry = value(s_lo) / R from the top kCarryRows rows, rounded; then
// A = sweep3(s_hi + carry + 2p)
template <class F, bool kRd = false>
__device__ __forceinline__ void reduce_out(const float (&t)[2 * F::kRows], float (&A)[F::kRows]) {
  constexpr int R = F::kRows;
  float c = 0.0f;
#pragma unroll
  for (int i = R - kCarryRows; i < R; ++i) c = __fmaf_rn(t[i], pow256(i - R), c);
  c = rintf(c);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float v = j == 0 ? __fadd_rn(t[R], c) : t[R + j];
    if (F::p2(j) != 0.0f) v = __fadd_rn(v, F::p2(j));
    A[j] = v;
  }
  sweep3<R, kRd>(A);
}

// A = reduce(t) + 2p with the scalar-constant backend (the reference's
// reduce with m_np, m_p None); t is clobbered
template <class F, bool kRd = false>
__device__ __forceinline__ void reduce_scalar(float (&t)[2 * F::kRows], float (&A)[F::kRows]) {
  float u[F::kRows];
  reduce_low<F::kRows, kRd>(t, u);
  reduce_np<F, kRd>(u);
  reduce_add_mp<F>(t, u);
  reduce_out<F, kRd>(t, A);
}

}  // namespace snark
