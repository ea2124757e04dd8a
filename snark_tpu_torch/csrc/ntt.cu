// Scalar-field kernels of the h pipeline: the C entry points and the BN254
// Fr instances. The kernels are templates in ntt_kernels.cuh over the
// field's params; ntt_bls.cu compiles the BLS12-381 Fr instances in a
// process of its own, and each entry point dispatches on a curve code.
//
// K3 ntt_stage replaces snark_tpu/ops/ntt_plane.py _Kernels.dit_kernel,
//   dif_kernel and dif_norm_kernel: one radix-2 stage of a transform.
//   DIT: (lo, hi) -> (lo + hi*w, lo - hi*w); DIF: (lo + hi, (lo - hi)*w).
//   Every output here is fully reduced, so the TPU's normalising DIF
//   butterfly (dif_norm_kernel, which re-clamps the lazily reduced sum every
//   4th stage) has no counterpart: values never grow.
// K4 field_ew replaces snark_tpu/ops/ntt_plane.py _Kernels.vmul_kernel,
//   make_hadamard, remont_kernel and tostd_kernel2, and the standalone
//   snark_tpu/ops/pallas_field_v3.py make_mont_mul_v3:
//   mode 0  out = a * b             (b[0] for every element if b_bcast)
//   mode 1  out = a + b
//   mode 2  out = (a * b - c) * d[0] (the Hadamard step with 1/Z_H)
//   Conversion into Montgomery form is mode 0 with b = R^2 mod p broadcast,
//   out of it mode 0 with b = 1 (raw); they take the place of remont and
//   tostd.
//
// Layout: (n, 8) u32 limbs, Montgomery R = 2^256 (field.cuh), for both
// scalar fields (BLS12-381 Fr has 255 bits, BN254 Fr 254). The stage's
// twiddle for butterfly j is tw[j * tw_stride] of one table of powers.
//
// Bound (H100): K3 moves 64 bytes in and 64 out per butterfly plus 32 of
// twiddle, against one Montgomery mul (264 multiply-adds): about 1.7 per
// byte, below the card's 16.7e12 / 3.35e12 = 5, so K3 is bound by bytes.
// K4 in mode 0 moves 96 bytes per element for one mul (2.75 per byte):
// bytes as well. The design reads and writes each element once per stage,
// one thread per butterfly, neighbouring threads on neighbouring butterflies
// so that the 32-byte rows of a warp are contiguous. Fusing several stages
// into one pass through shared memory is later work.

#include "ntt_kernels.cuh"

using namespace snark;

extern "C" int snark_ntt_stage(int curve, const void* x, void* y, const void* tw, int n,
                               int log_half, int tw_stride, int dif, void* stream) {
  if (n / 2 <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254)
    return launch_ntt_stage<FrParams>(x, y, tw, n, log_half, tw_stride, dif, s);
  if (curve == kBls12_381) return bls_ntt_stage(x, y, tw, n, log_half, tw_stride, dif, s);
  return kNotPorted;
}

extern "C" int snark_field_ew(int curve, int mode, void* out, const void* a, const void* b,
                              const void* c, const void* d, int n, int b_bcast, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_field_ew<FrParams>(mode, out, a, b, c, d, n, b_bcast, s);
  if (curve == kBls12_381) return bls_field_ew(mode, out, a, b, c, d, n, b_bcast, s);
  return kNotPorted;
}
