// K1's parts: BN254 G1 instances of K1 (bucket_madd_rows_kernel,
// curve_kernels.cuh) with one part of the step's body changed, and their C
// entry point, for the in-context decomposition benchmark
// snark_tpu_torch/bench_madd_parts.py. Compiled apart from curve.cu, in an
// nvcc process of its own.
//
// Replaces the variant bodies body_nosub, body_halfmul and body_nodecode of
// scripts/bench_madd_parts.py:73-100, which its build_and_time (:111)
// swaps into snark_tpu/ops/pallas_curve.py _madd_mixed_body before a fresh
// PlaneMsm rebuilds make_masked_mixed_add_rows (pallas_curve.py:754,
// pallas_call at :678) around them. Each instance differs from the shipped
// K1 (curve.cu) in that body alone: the gather, the identity skip, the sign,
// the loop and the store are the same code, which is what the script means
// by "in context". The bodies (curve.cuh), with P = (X1, Y1, Z1) the
// accumulator and Q = (x2, y2) the decoded row:
//   nosub (kMaddNosub):       Alg 8's 13 products without its add/sub
//     glue: (a b - d j, b i + j a, i d + a m4);
//   halfmul (kMaddHalfmul):   6 products: (a b - m4 i, b + i, a + i);
//   nodecode (kMaddNodecode): Alg 8 of P and Q' = (Z1, Y1); the row's flag
//     is read, its coordinates are not decoded and its sign is ignored.
// Here a = X1 x2, b = Y1 y2, d = y2 Z1, e = x2 Z1, m4 = (X1 + Y1)(x2 + y2),
// i = b3 Z1, j = b3 (e + X1). Only the shipped body is a group law; these
// compute the script's formulas value for value (its bodies run under
// SNARK_TPU_MSM_BATCHED=0; by default the reference's G1 rows kernel takes
// _madd_mixed_body_batched_g1 and never calls the swapped body).
//
// Bound (H100): operations, as K1. Montgomery products a step (each product
// by 3b is additions): nosub 11, halfmul 5, nodecode 11, each 264 32-bit
// multiply-adds, and 2 row decodes of 17 (none in nodecode), against 73
// bytes gathered a step (row and payload; nodecode reads the flag byte and
// the payload, 5).

#include "curve_kernels.cuh"

using namespace snark;

namespace {

template <int Part>
int launch_part(const void* acc_in, void* acc_out, const void* table, int row_bytes,
                const void* perm, const void* lane_base, const void* start,
                const void* length, int lanes, int i0, int k_steps, cudaStream_t s) {
  bucket_madd_rows_kernel<Fq, Part><<<curve_grid(lanes), kCurveBlock, 0, s>>>(
      (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint8_t*)table, row_bytes,
      (const uint32_t*)perm, (const int32_t*)lane_base, (const int32_t*)start,
      (const int32_t*)length, lanes, i0, k_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 with body `part` (kMaddNosub, kMaddHalfmul, kMaddNodecode), arguments
// as snark_bucket_madd_rows; kNotPorted for any curve but BN254, any group
// but G1 (group 1) and any other part.
extern "C" int snark_bucket_madd_rows_part(int curve, int group, int part, const void* acc_in,
                                           void* acc_out, const void* table, int row_bytes,
                                           const void* perm, const void* lane_base,
                                           const void* start, const void* length, int lanes,
                                           int i0, int k_steps, void* stream) {
  if (curve != kBn254 || group != 1) return kNotPorted;
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (part) {
    case kMaddNosub:
      return launch_part<kMaddNosub>(acc_in, acc_out, table, row_bytes, perm, lane_base, start,
                                     length, lanes, i0, k_steps, s);
    case kMaddHalfmul:
      return launch_part<kMaddHalfmul>(acc_in, acc_out, table, row_bytes, perm, lane_base,
                                       start, length, lanes, i0, k_steps, s);
    case kMaddNodecode:
      return launch_part<kMaddNodecode>(acc_in, acc_out, table, row_bytes, perm, lane_base,
                                        start, length, lanes, i0, k_steps, s);
    default:
      return kNotPorted;
  }
}
