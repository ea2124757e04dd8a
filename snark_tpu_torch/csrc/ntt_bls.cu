// The BLS12-381 Fr instances of K3 ntt_stage and K4 field_ew, compiled apart
// from ntt.cu so that the two run as separate nvcc processes; ntt.cu's
// entry points call these launchers for the kBls12_381 curve code. What the
// kernels replace and what bounds them is in ntt.cu.

#include "ntt_kernels.cuh"

namespace snark {

int bls_ntt_stage(const void* x, void* y, const void* tw, int n, int log_half, int tw_stride,
                  int dif, cudaStream_t s) {
  return launch_ntt_stage<BlsFrParams>(x, y, tw, n, log_half, tw_stride, dif, s);
}

int bls_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                 const void* d, int n, int b_bcast, cudaStream_t s) {
  return launch_field_ew<BlsFrParams>(mode, out, a, b, c, d, n, b_bcast, s);
}

}  // namespace snark
