// Batch-affine bucket accumulation kernels, for G1 (over Fq) and G2 (over
// Fq2): the C entry points, and the BN254 instances. The kernels are
// templates in affine_kernels.cuh; affine_bls.cu compiles the BLS12-381
// instances (12-limb Fq) in a process of its own, and each entry point
// takes a curve code (kBn254, kBls12_381) and dispatches on it.
//
// K6 affine_phase1 replaces snark_tpu/ops/msm_affine.py phase1_kernel
//   (_decode_pair, _preds_from_sides, _phase1_body): decode a pair of rows,
//   classify it, emit the denominator of its affine add.
// K7 affine_tree_mul replaces snark_tpu/ops/msm_affine.py tree_kernel (the
//   product-tree muls of batch_inverse_planes) in mode 0, and the width-1
//   root inverse (snark_tpu/ops/plane_affine.py _fermat_inv, and the Fq2
//   norm trick of batch_inverse_planes) in mode 1.
// K8 affine_phase3 replaces snark_tpu/ops/msm_affine.py phase3_kernel
//   (_phase3_body): the affine add itself, written back as a row.
//
// One level of the tree adds pair j = rows (2j, 2j+1) of a (2M, row_bytes)
// u8 table into row j of an (M, row_bytes) table, in the key's row format
// (curve.cuh). At level 0 a sign byte per input row negates Y (the digit's
// sign). A pair falls into one class, by exact comparison of the canonical
// coordinates:
//   0 add     both live, x1 != x2         den = x2 - x1
//   1 double  both live, (x1, y1) == (x2, y2)   den = 2 y1
//   2 dead    both identity, or x1 == x2 and y1 == -y2   den = 1
//   3 copy l  right identity               den = 1
//   4 copy r  left identity                den = 1
// A denominator of 1 for the lanes that compute nothing keeps the level's
// product tree invertible: one zero would zero every inverse of the level.
// K8 writes x3, y3 (add and double), the live side (copies), or the
// identity (flag 0, x = 0, y = 1) as a canonical row, so the rows of the
// next level compare exactly and the block partials feed the K1 scan as
// they are. y = 0 cannot occur: the groups have no 2-torsion.
//
// Layouts: den and dinv (M, K, N) u32 limbs at R = 2^(32 N) (field.cuh;
// N = 8 for BN254, 12 for BLS12-381); classes one u8 per pair; points are
// (x, y) of K-component elements.
//
// Bound (H100): per BN254 G1 pair, K6 decodes 4 row components (one
// 16-bit reduction step of 17 multiply-adds each, curve.cuh) on 140 bytes
// read and 33 written, 0.4 multiply-adds per byte; K8 does the same decode
// and 6 Montgomery muls (encode 2, the add 4, the square of a double aside)
// on 173 read and 69 written, about 7 per byte; K7 one mul on 64 bytes read
// and 32 written, 2.75 per byte. The card does 16.7e12 / 3.35e12 = 5 per
// byte, so K8 is bound by operations and K6 and K7 by bytes. BLS12-381 G1
// has 588 multiply-adds a product and 25 a decode on rows of 101 bytes and
// elements of 48: K6 0.4 and K8 10 per byte, K7 4.1 (bytes); its G2
// doubles the bytes and triples the products.
//
// K6 and K8 (affine_kernels.cuh): a block of 128 threads takes a tile of
// 128 consecutive pairs, one thread a pair. Read a pair at a time, each
// thread's rows lie 2 rb bytes from its neighbour's (rb = 69, 137, 101,
// 201), so every byte load of a warp touched 32 sectors, and K8 also wrote
// its row a byte at a time: L1 wavefronts, not multiply-adds, set their
// pace (K8 at 8-12% of its bound, K6 at 20-30%). Now the tile's 2 T rows,
// one span of device memory, and its den or dinv elements are staged in
// shared memory by 16-byte cp.async copies, neighbouring threads on
// neighbouring chunks (a span that is not 16-byte aligned, as a view of
// the rows may be, has its head and tail moved a byte a thread); each
// thread builds its row's 32-bit words from aligned shared words with
// funnel shifts; K8 writes its row's words into the shared tile (only the
// two words it shares with its neighbours a byte at a time) and the block
// stores the tile, and K6 its den tile, with 16-byte stores. The
// arithmetic stays in registers, one pair a thread, as before. Shared
// memory a block: 21.8 KB (BN254 G1) to 63.8 KB (BLS12-381 G2, above 48 KB
// by the kernel's raised limit). On the H100 K8 runs at 57-69% of its
// bound and K6 at 79-89% of its bytes bound (PERF.md, section 6).
//
// K7 is one thread per element with all arithmetic in registers (the
// 12-limb product a called function, as in K1). The root inverse runs one
// lane through the square-and-multiply chain of q - 2, one square per bit
// and one mul per set bit: 254 and 110 for BN254, 381 and 229 for
// BLS12-381. A serial chain, bound by latency.

#include "affine_kernels.cuh"

using namespace snark;

extern "C" int snark_affine_phase1(int curve, int group, const void* rows, int row_bytes,
                                   const void* sgn, void* den, void* cls, int pairs,
                                   void* stream) {
  if (pairs <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254)
    return launch_affine_phase1<FqParams>(group, rows, row_bytes, sgn, den, cls, pairs, s);
  if (curve == kBls12_381)
    return bls_affine_phase1(group, rows, row_bytes, sgn, den, cls, pairs, s);
  return kNotPorted;
}

extern "C" int snark_affine_phase3(int curve, int group, const void* rows, int row_bytes,
                                   const void* sgn, const void* dinv, const void* cls, void* out,
                                   int pairs, void* stream) {
  if (pairs <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254)
    return launch_affine_phase3<FqParams>(group, rows, row_bytes, sgn, dinv, cls, out, pairs,
                                          s);
  if (curve == kBls12_381)
    return bls_affine_phase3(group, rows, row_bytes, sgn, dinv, cls, out, pairs, s);
  return kNotPorted;
}

extern "C" int snark_affine_tree_mul(int curve, int group, int mode, const void* a,
                                     const void* b, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == kBn254) return launch_affine_tree_mul<FqParams>(group, mode, a, b, out, n, s);
  if (curve == kBls12_381) return bls_affine_tree_mul(group, mode, a, b, out, n, s);
  return kNotPorted;
}
