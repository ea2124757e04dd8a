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
// _sweep): c_i = floor(z_i / 256), r_i = z_i - 256 c_i, z_i = r_i + c_{i-1};
// the carry out of the top row is dropped. 256 c_i is exact, so the FMA
// rounds z_i - 256 c_i once, as the plain version's subtraction does.
template <int R>
__device__ __forceinline__ void sweep(float (&z)[R]) {
  float carry = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float c = floorf(z[i] * (1.0f / 256.0f));
    const float r = __fmaf_rn(-256.0f, c, z[i]);
    z[i] = i == 0 ? r : __fadd_rn(r, carry);
    carry = c;
  }
}

template <int R>
__device__ __forceinline__ void sweep3(float (&z)[R]) {
  sweep<R>(z);
  sweep<R>(z);
  sweep<R>(z);
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
template <int R>
__device__ __forceinline__ void reduce_low(const float (&t)[2 * R], float (&u)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) u[i] = t[i];
  sweep3<R>(u);
}

// In place, from the top row down, as u[k] reads only rows <= k; zero
// digits of N' skipped at compile time.
template <class F>
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
  sweep3<R>(u);
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
template <class F>
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
  sweep3<R>(A);
}

// A = reduce(t) + 2p with the scalar-constant backend (the reference's
// reduce with m_np, m_p None); t is clobbered
template <class F>
__device__ __forceinline__ void reduce_scalar(float (&t)[2 * F::kRows], float (&A)[F::kRows]) {
  float u[F::kRows];
  reduce_low<F::kRows>(t, u);
  reduce_np<F>(u);
  reduce_add_mp<F>(t, u);
  reduce_out<F>(t, A);
}

}  // namespace snark
