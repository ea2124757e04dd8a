// The BLS12-381 instances of K6 affine_phase1, K7 affine_tree_mul, K8
// affine_phase3 and K19 affine_batch_inverse (G1 over Fq, G2 over Fq2,
// 12-limb Fq), compiled apart from
// affine.cu so that the two run as separate nvcc processes; affine.cu's
// entry points call these launchers for the kBls12_381 curve code. What
// the kernels replace and what bounds them is in affine.cu.

#include "affine_kernels.cuh"

namespace snark {

int bls_affine_phase1(int group, const void* rows, int row_bytes, const void* sgn, void* den,
                      void* cls, int pairs, cudaStream_t s) {
  return launch_affine_phase1<BlsFqParams>(group, rows, row_bytes, sgn, den, cls, pairs, s);
}

int bls_affine_phase3(int group, const void* rows, int row_bytes, const void* sgn,
                      const void* dinv, const void* cls, void* out, int pairs, cudaStream_t s) {
  return launch_affine_phase3<BlsFqParams>(group, rows, row_bytes, sgn, dinv, cls, out, pairs,
                                           s);
}

int bls_affine_tree_mul(int group, int mode, const void* a, const void* b, void* out, int n,
                        cudaStream_t s) {
  return launch_affine_tree_mul<BlsFqParams>(group, mode, a, b, out, n, s);
}

int bls_affine_batch_inverse(int group, int phase, const void* den, void* out, void* ws,
                             int ws_elems, int n, cudaStream_t s) {
  return launch_affine_batch_inverse<BlsFqParams>(group, phase, den, out, ws, ws_elems, n, s);
}

}  // namespace snark
