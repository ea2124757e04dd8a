// The BLS12-381 instances of K1 bucket_madd_rows, K2 masked_add, K5
// point_double, K11 masked_mixed_add and K18 horner_combine (G1 over Fq, G2
// over Fq2, 12-limb Fq), compiled apart from
// curve.cu so that the two run as separate nvcc processes; curve.cu's entry
// points call these launchers for the kBls12_381 curve code. What the
// kernels replace and what bounds them is in curve.cu.

#include "curve_kernels.cuh"

namespace snark {

int bls_bucket_madd_rows(int group, const void* acc_in, void* acc_out, const void* table,
                         int row_bytes, const void* perm, const void* lane_base,
                         const void* start, const void* length, int lanes, int i0,
                         int k_steps, cudaStream_t s) {
  return launch_bucket_madd_rows<BlsFqParams>(group, acc_in, acc_out, table, row_bytes, perm,
                                              lane_base, start, length, lanes, i0, k_steps, s);
}

int bls_masked_add(int group, const void* p, const void* q, const void* mask, void* out,
                   int lanes, cudaStream_t s) {
  return launch_masked_add<BlsFqParams>(group, p, q, mask, out, lanes, s);
}

int bls_point_double(int group, const void* p, void* out, int lanes, cudaStream_t s) {
  return launch_point_double<BlsFqParams>(group, p, out, lanes, s);
}

int bls_masked_mixed_add(int group, const void* p, const void* x2, const void* y2,
                         const void* mask, void* out, int lanes, cudaStream_t s) {
  return launch_masked_mixed_add<BlsFqParams>(group, p, x2, y2, mask, out, lanes, s);
}

int bls_horner_combine(int group, const void* sums, void* out, int windows, int c,
                       cudaStream_t s) {
  return launch_horner_combine<BlsFqParams>(group, sums, out, windows, c, s);
}

int bls_chain_latency(const void* in, void* out, void* cycles, int n, int mode, cudaStream_t s) {
  return launch_chain_latency<BlsFqParams>(in, out, cycles, n, mode, s);
}

}  // namespace snark
