// Curve kernels of the bucket MSM, for G1 (over Fq) and G2 (over Fq2): the
// C entry points, and the BN254 instances. The kernels themselves are
// templates in curve_kernels.cuh; curve_bls.cu compiles the BLS12-381
// instances of K1, K2, K5, K11 and K18 in a process of its own, and each entry point
// takes a curve code (kBn254, kBls12_381) and dispatches on it.
//
// K1 bucket_madd_rows replaces snark_tpu/ops/pallas_curve.py
//   make_masked_mixed_add_rows (bodies _madd_mixed_body and
//   _madd_mixed_body_batched_g1): the bucket scan of the MSM. Its step's
//   body is a template argument (curve.cuh); this file and curve_bls.cu
//   instantiate the shipped one, madd_parts.cu the benchmark's others.
// K2 masked_add replaces snark_tpu/ops/pallas_curve.py make_masked_add
//   (body _add_body): the replica, suffix and spill folds of the MSM. With a
//   null mask every lane adds, and K2 replaces make_point_add as well: the
//   add of the device Horner combine.
// K5 point_double replaces snark_tpu/ops/pallas_curve.py make_point_double
//   (body _double_body, RCB15 Alg 9): the doublings of the Horner combine.
// K18 horner_combine replaces the device Horner combine of
//   snark_tpu/ops/msm_plane.py PlaneMsm._combine_impl: its fori_loop over
//   the windows of c make_point_double calls and one make_point_add
//   (ops/pallas_curve.py:709, :702) becomes one launch of one warp. K5 and
//   K2 without a mask stay as the per-operation counterparts of those two
//   kernels; no path calls them any more.
// K11 masked_mixed_add replaces snark_tpu/ops/pallas_curve.py
//   make_masked_mixed_add (_make_pointwise with mixed=True, body
//   _madd_mixed_body, RCB15 Alg 8): mask ? P + (X2, Y2) : P with Q affine,
//   given as limb arrays. It is K1's step with Q read from (lanes, K, N)
//   arrays instead of decoded from gathered u8 rows, and the mask as given:
//   the caller clears it where Q is the identity (affine has no encoding
//   of it). No path of either package calls the reference; chip_smoke.py
//   drives K11 as a bucket scan run step by step, one launch a step,
//   against K1.
//
// The formulas, the point layout and the row codec are in curve.cuh.
//
// K1 gathers its rows itself. Lane l scans the run
//   perm[lane_base[l] + start[l] + i], i in [i0, min(i0 + k_steps, length[l])).
// Each payload is a table row index with the digit's sign in bit 31. A row
// whose flag is 0 (identity) leaves the lane as it is, which is adding the
// identity. A negative digit negates Y.
//
// Bound (H100): operations. A BN254 G1 mixed add is 11 Montgomery muls
// (Alg 8's 13, less the two by 3b = 9, which are additions) and 2 row
// decodes of one 16-bit reduction step each: 11 * 264 + 2 * 17 = 2,938
// 32-bit multiply-adds, against 73 bytes gathered per step (4 of payload,
// 69 of row): about 40 multiply-adds per byte, far above the card's
// 16.7e12 / 3.35e12 = 5 per byte. BN254 G2 is 39 base muls (3b = 3 / (9 +
// u) stays a product) and 4 decodes on twice the bytes. BLS12-381 G1 is
// 11 * 588 + 2 * 25 = 6,518 multiply-adds on 105 bytes, G2 33 * 588 +
// 4 * 25 on 205 (3b = 12 (1 + u): additions). K2 (12 muls on 192 bytes read
// and 96 written per BN254 G1 lane), K5 (8 muls on 96 bytes read and 96
// written) and K11 (11 muls on 96 + 64 bytes read and 96 written) are
// bound the same way.
//
// The design keeps every lane's accumulator in registers for the whole run
// (one launch runs all k_steps) and touches device memory only for the
// gathered row. The products are field.cuh's carry chains: written with
// 64-bit sums, a product is about 650 instructions, most of them carry
// adds, and K1 is bound by the integer instruction rate; as chains it is
// 4N^2 + 5N - 2 instructions (294 at N = 8, 634 at N = 12), 4N^2 + N of
// them multiply-adds. Between products the base-field values stay below
// 2q (field.cuh, lazy) and are reduced once, where they are stored; 3b
// multiplies by additions where it is small, and a row component decodes
// by one 16-bit reduction step. The BLS12-381 G2 kernels hold 72 words of
// accumulator, or two 72-word operands: K1 G2 spills past the 255-register
// cap (the build log gives the bytes), and K2 in G2 reads its operands'
// coordinates from memory at each use (curve.cuh MemPoint) instead of
// holding them. The 12-limb products and those of Fq2 are calls (field.cuh
// mont_mul_call, which says why); the BN254 G1 kernels inline theirs.
//
// K18 is bound by latency, not by a rate: Horner's c (W - 1) doublings and
// W adds form one dependent chain. With each formula's independent products
// side by side, a doubling or an add costs two products in depth (RCB15
// Alg 9: Y^2, Y Z, Z^2, X Y, then t2 z8, t1 z8, t0n (t0 + t2), t0n x y; Alg
// 7: six, then six), three where 3b is a product (BN254 G2), an Fq2
// product as deep as one base product (its three side by side); the bound
// is that depth in products times the least latency of one base product,
// measured on the card by chain_latency_kernel (the product alone on one
// lane, or its carry chain at a fused multiply-add pair's latency, the
// smaller; chip_smoke.py horner_bound_ms).
// The former combine ran each operation as a one-lane K5 or K2 launch, c + 1
// launches a window (280 at c = 13): launch latency set its time, and within
// a launch one thread ran the 8 to 13 products one after another. K18 keeps
// the running point and all W totals in shared memory (the totals read from
// device memory once, the result stored once, canonical), and runs each
// level's products on separate lanes of one warp with the same code, one
// product a lane (in G2 one base product a lane: an Fq2 product's three
// Karatsuba products side by side, then a level that combines them), the
// additions between them too, each level closed by __syncwarp. A lane
// holds one operation's operands only.

#include "curve_kernels.cuh"

using namespace snark;

extern "C" int snark_bucket_madd_rows(int curve, int group, const void* acc_in, void* acc_out,
                                      const void* table, int row_bytes,
                                      const void* perm, const void* lane_base,
                                      const void* start, const void* length,
                                      int lanes, int i0, int k_steps, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254)
    return launch_bucket_madd_rows<FqParams>(group, acc_in, acc_out, table, row_bytes, perm,
                                             lane_base, start, length, lanes, i0, k_steps, s);
  if (curve == kBls12_381)
    return bls_bucket_madd_rows(group, acc_in, acc_out, table, row_bytes, perm, lane_base,
                                start, length, lanes, i0, k_steps, s);
  return kNotPorted;
}

extern "C" int snark_masked_add(int curve, int group, const void* p, const void* q,
                                const void* mask, void* out, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_masked_add<FqParams>(group, p, q, mask, out, lanes, s);
  if (curve == kBls12_381) return bls_masked_add(group, p, q, mask, out, lanes, s);
  return kNotPorted;
}

extern "C" int snark_masked_mixed_add(int curve, int group, const void* p, const void* x2,
                                      const void* y2, const void* mask, void* out, int lanes,
                                      void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254)
    return launch_masked_mixed_add<FqParams>(group, p, x2, y2, mask, out, lanes, s);
  if (curve == kBls12_381) return bls_masked_mixed_add(group, p, x2, y2, mask, out, lanes, s);
  return kNotPorted;
}

extern "C" int snark_point_double(int curve, int group, const void* p, void* out, int lanes,
                                  void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_point_double<FqParams>(group, p, out, lanes, s);
  if (curve == kBls12_381) return bls_point_double(group, p, out, lanes, s);
  return kNotPorted;
}

extern "C" int snark_horner_combine(int curve, int group, const void* sums, void* out, int windows,
                                    int c, void* stream) {
  if (windows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_horner_combine<FqParams>(group, sums, out, windows, c, s);
  if (curve == kBls12_381) return bls_horner_combine(group, sums, out, windows, c, s);
  return kNotPorted;
}

// K18's latency probe (curve_kernels.cuh chain_latency_kernel), over the
// curve's base field: no TPU kernel's counterpart, a measurement for the
// bound of K18's row.
extern "C" int snark_chain_latency(int curve, const void* in, void* out, void* cycles, int n,
                                   int mode, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_chain_latency<FqParams>(in, out, cycles, n, mode, s);
  if (curve == kBls12_381) return bls_chain_latency(in, out, cycles, n, mode, s);
  return kNotPorted;
}
