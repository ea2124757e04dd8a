// Batch-affine bucket accumulation kernels, for BN254 G1 (over Fq) and G2
// (over Fq2). They have no BLS12-381 instances yet: each entry point
// refuses any curve code but kBn254.
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
// Layouts: den and dinv (M, K, 8) u32 limbs at R = 2^256 (field.cuh);
// classes one u8 per pair; points are (x, y) of K-component elements.
//
// Bound (H100): per G1 pair, K6 does 4 Montgomery muls (the decode) on 140
// bytes read and 33 written, about 6 multiply-adds per byte; K8 does 10
// (decode 4, encode 2, the add 4, the square of a double aside) on 173 read
// and 69 written, about 11 per byte; K7 one mul on 64 bytes read and 32
// written, 2.75 per byte. The card does 16.7e12 / 3.35e12 = 5 per byte, so
// K6 and K8 are bound by operations and K7 by bytes. The design is one
// thread per pair with the pair's two rows read byte by byte and all
// arithmetic in registers. The root inverse runs one lane through about 254
// squarings and 130 muls: a serial chain, bound by latency.

#include "curve.cuh"

namespace snark {

// q - 2, the Fermat exponent
static __constant__ uint32_t kQMinus2[8] = {
    0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};

enum PairClass : uint8_t { kAdd = 0, kDouble = 1, kDead = 2, kCopyL = 3, kCopyR = 4 };

template <class E>
struct Pair {
  E x1, y1, x2, y2;
  bool f1, f2;
};

template <class E>
__device__ __forceinline__ Pair<E> load_pair(const uint8_t* rows, int row_bytes,
                                             const uint8_t* sgn, int j) {
  constexpr int flag_at = 2 * Curve<E>::kRowDigits * Curve<E>::K;
  const uint8_t* l = rows + (size_t)(2 * j) * row_bytes;
  const uint8_t* r = l + row_bytes;
  Pair<E> p;
  decode_row(l, p.x1, p.y1);
  decode_row(r, p.x2, p.y2);
  p.f1 = l[flag_at] != 0;
  p.f2 = r[flag_at] != 0;
  if (sgn != nullptr) {
    if (sgn[2 * j]) p.y1 = neg(p.y1);
    if (sgn[2 * j + 1]) p.y2 = neg(p.y2);
  }
  return p;
}

template <class E>
__device__ __forceinline__ uint8_t classify(const Pair<E>& p) {
  if (!p.f1) return p.f2 ? kCopyR : kDead;
  if (!p.f2) return kCopyL;
  if (!Curve<E>::eq(p.x1, p.x2)) return kAdd;
  return Curve<E>::eq(p.y1, p.y2) ? kDouble : kDead;
}

template <class E>
__global__ void affine_phase1_kernel(const uint8_t* __restrict__ rows, int row_bytes,
                                     const uint8_t* __restrict__ sgn,
                                     uint32_t* __restrict__ den, uint8_t* __restrict__ cls,
                                     int pairs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= pairs) return;
  const Pair<E> p = load_pair<E>(rows, row_bytes, sgn, j);
  const uint8_t c = classify(p);
  E d = Curve<E>::one();
  if (c == kAdd) d = p.x2 - p.x1;
  if (c == kDouble) d = p.y1 + p.y1;
  Curve<E>::store(den + (size_t)j * Curve<E>::W, d);
  cls[j] = c;
}

template <class E>
__global__ void affine_phase3_kernel(const uint8_t* __restrict__ rows, int row_bytes,
                                     const uint8_t* __restrict__ sgn,
                                     const uint32_t* __restrict__ dinv,
                                     const uint8_t* __restrict__ cls,
                                     uint8_t* __restrict__ out, int pairs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= pairs) return;
  const Pair<E> p = load_pair<E>(rows, row_bytes, sgn, j);
  const uint8_t c = cls[j];
  E x3, y3;
  if (c == kAdd || c == kDouble) {
    E num;
    if (c == kAdd) {
      num = p.y2 - p.y1;
    } else {
      const E sq = p.x1 * p.x1;
      num = (sq + sq) + sq;
    }
    const E lam = num * Curve<E>::load(dinv + (size_t)j * Curve<E>::W);
    x3 = (lam * lam - p.x1) - p.x2;
    y3 = lam * (p.x1 - x3) - p.y1;
  } else if (c == kCopyL) {
    x3 = p.x1;
    y3 = p.y1;
  } else if (c == kCopyR) {
    x3 = p.x2;
    y3 = p.y2;
  } else {
    x3 = Curve<E>::zero();
    y3 = Curve<E>::one();
  }
  uint8_t* o = out + (size_t)j * row_bytes;
  encode_row(o, x3, y3);
  o[2 * Curve<E>::kRowDigits * Curve<E>::K] = c == kDead ? 0 : 1;
}

// a^(q - 2) = a^-1 (0 for a = 0), square and multiply from the top bit.
__device__ __forceinline__ Fq fermat_inv(const Fq& a) {
  Fq acc = Curve<Fq>::one();
  for (int i = 253; i >= 0; --i) {
    acc = acc * acc;
    if ((kQMinus2[i >> 5] >> (i & 31)) & 1u) acc = acc * a;
  }
  return acc;
}

__device__ __forceinline__ Fq field_inv(const Fq& a) { return fermat_inv(a); }

// (c0 + c1 u)^-1 = (c0 - c1 u) / (c0^2 + c1^2), as u^2 = -1.
__device__ __forceinline__ Fq2 field_inv(const Fq2& a) {
  const Fq ninv = fermat_inv(a.c0 * a.c0 + a.c1 * a.c1);
  return {a.c0 * ninv, neg(a.c1 * ninv)};
}

template <class E>
__global__ void affine_tree_mul_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       uint32_t* __restrict__ out, int n, int mode) {
  constexpr int W = Curve<E>::W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E x = Curve<E>::load(a + (size_t)i * W);
  const E r = mode == 0 ? x * Curve<E>::load(b + (size_t)i * W) : field_inv(x);
  Curve<E>::store(out + (size_t)i * W, r);
}

constexpr int kAffineBlock = 128;

}  // namespace snark

using namespace snark;

extern "C" int snark_affine_phase1(int curve, int group, const void* rows, int row_bytes,
                                   const void* sgn, void* den, void* cls, int pairs,
                                   void* stream) {
  if (curve != kBn254) return kNotPorted;
  if (pairs <= 0) return 0;
  dim3 grid((pairs + kAffineBlock - 1) / kAffineBlock);
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto kernel) {
    kernel<<<grid, kAffineBlock, 0, s>>>((const uint8_t*)rows, row_bytes, (const uint8_t*)sgn,
                                         (uint32_t*)den, (uint8_t*)cls, pairs);
  };
  if (group == 1)
    run(affine_phase1_kernel<Fq>);
  else
    run(affine_phase1_kernel<Fq2>);
  return (int)cudaGetLastError();
}

extern "C" int snark_affine_phase3(int curve, int group, const void* rows, int row_bytes,
                                   const void* sgn, const void* dinv, const void* cls, void* out,
                                   int pairs, void* stream) {
  if (curve != kBn254) return kNotPorted;
  if (pairs <= 0) return 0;
  dim3 grid((pairs + kAffineBlock - 1) / kAffineBlock);
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto kernel) {
    kernel<<<grid, kAffineBlock, 0, s>>>((const uint8_t*)rows, row_bytes, (const uint8_t*)sgn,
                                         (const uint32_t*)dinv, (const uint8_t*)cls,
                                         (uint8_t*)out, pairs);
  };
  if (group == 1)
    run(affine_phase3_kernel<Fq>);
  else
    run(affine_phase3_kernel<Fq2>);
  return (int)cudaGetLastError();
}

extern "C" int snark_affine_tree_mul(int curve, int group, int mode, const void* a,
                                     const void* b, void* out, int n, void* stream) {
  if (curve != kBn254) return kNotPorted;
  if (n <= 0) return 0;
  dim3 grid((n + kAffineBlock - 1) / kAffineBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    affine_tree_mul_kernel<Fq><<<grid, kAffineBlock, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, mode);
  else
    affine_tree_mul_kernel<Fq2><<<grid, kAffineBlock, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, mode);
  return (int)cudaGetLastError();
}
