// The kernels of the roofline micro-benchmark (snark_tpu_torch/bench_vpu_peak.py),
// the counterparts of the four Pallas kernels of scripts/bench_vpu_peak.py.
// All four work on float32 digit planes (R, lanes): base-256 digits on rows,
// lanes contiguous, R = 34 (BN254 Fq with two extra digits, the script's
// planes). One thread owns one lane: its digits live in registers for the
// whole chain, a warp's read of row i is 128 contiguous bytes, and R is a
// template constant so that every digit loop unrolls. The field's device
// code (digit tables, sweeps, mul_acc, the scalar-constant reduction) is in
// plane_v3.cuh, shared with K16 and K17 (mul_parts.cu). Each C entry point
// returns cudaGetLastError() after its launch.
//
// K12 fma_chain replaces fma_run (scripts/bench_vpu_peak.py:75, pallas_call
//   at :76): acc <- acc b + a, reps times from acc = a, elementwise. Bound
//   (H100): FP32 operations, reps FMAs per element at 132 SMs x 128 lanes x
//   1.98 GHz = 33.45e12 FMA/s (256 x 34 x 131072 in 0.034 ms, against 0.016
//   ms for its 53.5 MB). Each thread runs four independent chains (one
//   float4 of each input), so the 4-cycle FMA latency is covered by
//   instruction-level parallelism as well as by the other warps. The
//   update is one explicit __fmaf_rn: one rounding, where the plain torch
//   version rounds the product and the sum.
// K13 sweep_chain replaces sweep_run (:100, pallas_call at :101):
//   z <- sweep(z) + 1, reps times. Bound: operations; per digit and sweep a
//   multiply by 1/256, a floor, z - 256 c (one FMA, exact), the carry add
//   and the +1. The floor is a rounding instruction (FRND), which may run
//   below the FP32 rate; chip_smoke.py's build line counts the kernel's
//   SASS by opcode. Every step is exact or rounds in the reference's order.
// K14 conv_chain replaces conv_run (:128, pallas_call at :129): t = A * B
//   (the 2R-row digit convolution of mul_acc), then A <- t[0:R] 1e-7, reps
//   times; the output is t. Bound: operations, R^2 FMAs + R multiplies a
//   rep. A (34), B (34) and t (68) stay in registers, the sum in the
//   reference's order (increasing row of A), each term one FMA. No -ftz:
//   values that fall below 2^-126 stay subnormal, as in the plain version.
// K15 mont_mul_chain replaces mm_run (:159, pallas_call at :160): A <-
//   mont_mul(A, B) with the carry columns and plus_p = 2p, reps times, on
//   lazy digits. The reference's reduction runs on the vector unit (its
//   scalar-constant backend, snark_tpu/ops/pallas_field_v3.py:223-227), as
//   here: the convolutions by N' and p are FMAs with compile-time immediate
//   digits, zero digits skipped at compile time, and the p convolution
//   skips the low rows that neither reach the carry nor the high half.
//   Every term is an integer below 2^24, so the digits equal the plain
//   version's exactly. Bound: operations, 3,847 FP32 instructions a product
//   (1,156 for A B, 595 for N', 835 for p, nine sweeps of 34 rows, the
//   carry); at least 136 floats are live (t, B and the low half), so
//   registers, not the FP32 rate, may set the occupancy.

#include <cuda_runtime.h>

#include "plane_v3.cuh"

namespace snark {

constexpr int kVpuRows = 34;
constexpr int kVpuMaxThreads = 256;

// ---------------------------------------------------------------------------
// K12
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kVpuMaxThreads)
    fma_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int n, int reps) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // float4 index
  const long long base = 4 * q;
  if (base + 4 <= n) {
    const float4 va = reinterpret_cast<const float4*>(a)[q];
    const float4 vb = reinterpret_cast<const float4*>(b)[q];
    float4 acc = va;
#pragma unroll 8
    for (int r = 0; r < reps; ++r) {
      acc.x = __fmaf_rn(acc.x, vb.x, va.x);
      acc.y = __fmaf_rn(acc.y, vb.y, va.y);
      acc.z = __fmaf_rn(acc.z, vb.z, va.z);
      acc.w = __fmaf_rn(acc.w, vb.w, va.w);
    }
    reinterpret_cast<float4*>(out)[q] = acc;
    return;
  }
  for (long long j = base; j < n; ++j) {  // the ragged end, n % 4 elements
    const float x = a[j], y = b[j];
    float acc = x;
    for (int r = 0; r < reps; ++r) acc = __fmaf_rn(acc, y, x);
    out[j] = acc;
  }
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kVpuMaxThreads)
    sweep_chain_kernel(const float* __restrict__ in, float* __restrict__ out, int lanes,
                       int reps) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float z[R];
#pragma unroll
  for (int i = 0; i < R; ++i) z[i] = in[(size_t)i * lanes + l];
  for (int r = 0; r < reps; ++r) {
    sweep<R>(z);
#pragma unroll
    for (int i = 0; i < R; ++i) z[i] = __fadd_rn(z[i], 1.0f);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) out[(size_t)i * lanes + l] = z[i];
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kVpuMaxThreads)
    conv_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int lanes, int reps) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float A[R], B[R], t[2 * R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    A[i] = a[(size_t)i * lanes + l];
    B[i] = b[(size_t)i * lanes + l];
  }
  for (int r = 0; r < reps; ++r) {
    mul_acc<R, true>(A, B, t);
#pragma unroll
    for (int i = 0; i < R; ++i) A[i] = __fmul_rn(t[i], 1e-7f);
  }
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) out[(size_t)k * lanes + l] = t[k];
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

template <class F>
__global__ void __launch_bounds__(kVpuMaxThreads)
    mont_mul_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ out, int lanes, int reps) {
  constexpr int R = F::kRows;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float A[R], B[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    A[i] = a[(size_t)i * lanes + l];
    B[i] = b[(size_t)i * lanes + l];
  }
  for (int rep = 0; rep < reps; ++rep) {
    float t[2 * R];
    mul_acc<R, true>(A, B, t);
    reduce_scalar<F>(t, A);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) out[(size_t)i * lanes + l] = A[i];
}

static bool bad_threads(int threads) {
  return threads <= 0 || threads > kVpuMaxThreads || threads % 32 != 0;
}

static unsigned blocks_for(long long work, int threads) {
  return (unsigned)((work + threads - 1) / threads);
}

}  // namespace snark

using namespace snark;

extern "C" int snark_fma_chain(const void* a, const void* b, void* out, int n, int reps,
                               int threads, void* stream) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  fma_chain_kernel<<<blocks_for((n + 3) / 4, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, n, reps);
  return (int)cudaGetLastError();
}

extern "C" int snark_sweep_chain(const void* in, void* out, int lanes, int reps, int threads,
                                 void* stream) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  sweep_chain_kernel<kVpuRows><<<blocks_for(lanes, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, lanes, reps);
  return (int)cudaGetLastError();
}

extern "C" int snark_conv_chain(const void* a, const void* b, void* out, int lanes, int reps,
                                int threads, void* stream) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  conv_chain_kernel<kVpuRows><<<blocks_for(lanes, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, lanes, reps);
  return (int)cudaGetLastError();
}

extern "C" int snark_mont_mul_chain(const void* a, const void* b, void* out, int lanes,
                                    int reps, int threads, void* stream) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return 0;
  mont_mul_chain_kernel<Bn254Fq34>
      <<<blocks_for(lanes, threads), threads, 0, (cudaStream_t)stream>>>(
          (const float*)a, (const float*)b, (float*)out, lanes, reps);
  return (int)cudaGetLastError();
}
