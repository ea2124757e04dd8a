// The standalone Montgomery products over 16-bit limbs, the entry points of
// the field micro-benchmark (snark_tpu_torch/bench_field.py): the C entry
// points and the instances for both scalar fields, BN254 Fr and BLS12-381
// Fr (8 words, R = 2^256), in one nvcc process. Each entry point takes the
// curve code of the scalar field (kBn254, kBls12_381) and the threads per
// block; the kernels are templates in field16_kernels.cuh.
//
// K9 mont_mul16 replaces snark_tpu/ops/pallas_field.py make_mont_mul
//   (pallas_call at :266): a b 2^-256 mod p on (n, 16) u32 16-bit limbs,
//   canonical in and out. The TPU kernel splits each limb into two f32
//   base-256 digit planes and accumulates digit products, because the TPU's
//   vector unit has no 32-bit integer multiplier. K9 packs each limb pair
//   into a 32-bit word in registers and runs the core's CIOS product
//   (field.cuh mont_mul), one thread per element, reading the row-major
//   rows as they are: neighbouring threads read 64 B apart.
// K10 mont_mul16_limb_major replaces scripts/pallas_field_v2.py
//   make_mont_mul_v2 (pallas_call at :128): the same function; the TPU
//   kernel reads plane-major (digits, lanes) blocks and accumulates the
//   product in a scratch ref before it reduces. K10 reads limb-major
//   (16, n) arrays, so each of a warp's loads is 128 contiguous bytes (the
//   wrapper transposes, as the reference converts outside its kernel), and
//   computes SOS: the whole 2N-word product in registers, then
//   m = t_lo N' mod R, then (t + m p) / R, then one conditional subtract, a
//   second algorithm beside the core's CIOS.
//
// Bound (H100): bytes. One product reads two 64-byte elements and writes
// one: 192 B, against 264 32-bit multiply-adds for the CIOS product (K10's
// SOS does 2N^2 + N(N+1) + 2N^2 = 328 at N = 8): about 1.4 multiply-adds
// per byte, below the card's 16.7e12 / 3.35e12 = 5. 2^20 products move
// 201 MB, 0.060 ms at 3.35 TB/s. The designs read each element once and
// keep everything else in registers; K9's strided rows cost it the
// coalescing that K10 has.

#include "field16_kernels.cuh"

using namespace snark;

extern "C" int snark_mont_mul16(int curve, const void* a, const void* b, void* out, int n,
                                int threads, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_mont_mul16<FrParams>(a, b, out, n, threads, s);
  if (curve == kBls12_381) return launch_mont_mul16<BlsFrParams>(a, b, out, n, threads, s);
  return kNotPorted;
}

extern "C" int snark_mont_mul16_limb_major(int curve, const void* a, const void* b, void* out,
                                           int n, int threads, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_mont_mul16_limb_major<FrParams>(a, b, out, n, threads, s);
  if (curve == kBls12_381)
    return launch_mont_mul16_limb_major<BlsFrParams>(a, b, out, n, threads, s);
  return kNotPorted;
}
