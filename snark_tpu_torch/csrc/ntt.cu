// Scalar-field kernels of the h pipeline: the C entry points and the BN254
// Fr instances. The kernels are templates in ntt_kernels.cuh over the
// field's params; ntt_bls.cu compiles the BLS12-381 Fr instances in a
// process of its own, and each entry point dispatches on a curve code.
//
// K3 ntt_pass replaces snark_tpu/ops/ntt_plane.py _Kernels.dit_kernel,
//   dif_kernel and dif_norm_kernel, which PlaneNtt._dit and _dif launch
//   once a radix-2 stage: one launch runs k consecutive stages [s0, s0 + k)
//   of a transform over the whole array. DIT: (lo, hi) -> (lo + hi*w,
//   lo - hi*w); DIF: (lo + hi, (lo - hi)*w), stage s pairing the elements
//   2^s apart with twiddle tw[(i mod 2^s) << (tw_log - s)] of one table of
//   powers. Every value stays fully reduced, so the TPU's normalising DIF
//   butterfly (dif_norm_kernel, which re-clamps the lazily reduced sum every
//   4th stage) has no counterpart. One stage (k = 1) is ntt_stage.
// K4 field_ew replaces snark_tpu/ops/ntt_plane.py _Kernels.vmul_kernel,
//   make_hadamard, remont_kernel and tostd_kernel2, and the standalone
//   snark_tpu/ops/pallas_field_v3.py make_mont_mul_v3:
//   mode 0  out = a * b             (b[0] for every element if b_bcast)
//   mode 1  out = a + b
//   mode 2  out = (a * b - c) * d[0] (the Hadamard step with 1/Z_H)
//   Conversion into Montgomery form is mode 0 with b = R^2 mod p broadcast,
//   out of it mode 0 with b = 1 (raw). In the h pipeline its products run
//   inside K3's passes instead (PlaneNtt._h_impl's vmul, hadamard and the
//   unscale): the Hadamard step as the prologue of the pass that loads
//   the inverse transform's tile, the coset scale and unscale as the
//   epilogue of the pass that stores a DIF transform's last stages.
//
// Layout: (n, 8) u32 limbs, Montgomery R = 2^256 (field.cuh), for both
// scalar fields (BLS12-381 Fr has 255 bits, BN254 Fr 254); every pointer
// 16-byte aligned, an element two uint4 loads.
//
// Bound (H100). One stage is n/2 Montgomery products (264 multiply-adds
// each) against 64 bytes in and out an element: 1.1 multiply-adds a byte,
// below the card's 16.7e12 / 3.35e12 = 5, so a stage alone is bound by
// bytes; k stages in one pass are 2.1 k multiply-adds a byte, so a pass of
// 3 or more stages is bound by its products: 10 stages at 2^20 take
// 0.083 ms. K4 in mode 0 moves 96 bytes an element for one product: bytes.
//
// Design. A pass loads a tile of 2^(k + log_g) elements (at most 2^11, 64
// KB of shared memory), G = 2^log_g sub-transforms of the pass side by
// side, so that each global access is a run of G 32-byte elements (G >= 4
// in the strided passes of the plan, ops/ntt.py pass_split) read and
// written 16 bytes a thread; it runs the k stages there in rounds of
// three, each of 256 threads holding 8 elements in registers (a radix-8
// step: 12 butterflies between two barriers), and stores the tile back.
// Registers decide the blocks an SM: two for DIF, one for DIT
// (ntt_kernels.cuh). A transform of 2^20 is two passes (11 + 9 stages),
// 2^18 two (9 + 9), up to 2^11 one; the host plan picks the split and the
// tile (ops/ntt.py pass_geometry), the launcher here checks it.

#include "ntt_kernels.cuh"

using namespace snark;

extern "C" int snark_ntt_pass(int curve, const void* x, void* y, const void* tw, int n, int s0,
                              int k, int log_g, int tw_log, int dif, const void* had_b,
                              const void* had_c, const void* had_d, const void* scale,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const PassArgs a{(const uint32_t*)x,     (uint32_t*)y,           (const uint32_t*)tw,
                   (const uint32_t*)had_b, (const uint32_t*)had_c, (const uint32_t*)had_d,
                   (const uint32_t*)scale, s0, k, log_g, tw_log};
  if (curve == kBn254) return launch_ntt_pass<FrParams>(a, n, dif, s);
  if (curve == kBls12_381) return bls_ntt_pass(a, n, dif, s);
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
