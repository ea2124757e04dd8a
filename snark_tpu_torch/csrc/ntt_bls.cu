// The BLS12-381 Fr instances of K3 ntt_pass and K4 field_ew, compiled apart
// from ntt.cu so that the two run as separate nvcc processes; ntt.cu's
// entry points call these launchers for the kBls12_381 curve code. What the
// kernels replace and what bounds them is in ntt.cu.

#include "ntt_kernels.cuh"

namespace snark {

int bls_ntt_pass(const PassArgs& a, int n, int dif, cudaStream_t s) {
  return launch_ntt_pass<BlsFrParams>(a, n, dif, s);
}

int bls_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                 const void* d, int n, int b_bcast, cudaStream_t s) {
  return launch_field_ew<BlsFrParams>(mode, out, a, b, c, d, n, b_bcast, s);
}

}  // namespace snark
