// Curve kernels of the bucket MSM, for BN254 G1 (over Fq) and G2 (over Fq2).
//
// K1 bucket_madd_rows replaces snark_tpu/ops/pallas_curve.py
//   make_masked_mixed_add_rows (bodies _madd_mixed_body and
//   _madd_mixed_body_batched_g1): the bucket scan of the MSM.
// K2 masked_add replaces snark_tpu/ops/pallas_curve.py make_masked_add
//   (body _add_body): the replica, suffix and spill folds of the MSM.
//
// Points are projective (X, Y, Z) in the port's limb format (field.cuh):
// a lane is 3 * K * 8 u32 words, K = 1 for G1 and 2 for G2, contiguous.
// Both kernels use the complete formulas of Renes-Costello-Batina 2015 for
// a = 0 (Alg 7 projective add, Alg 8 mixed add), so doubling, identity and
// inverse inputs need no branches.
//
// K1 gathers its rows itself. Lane l scans the run
//   perm[lane_base[l] + start[l] + i], i in [i0, min(i0 + k_steps, length[l])).
// Each payload is a table row index with the digit's sign in bit 31. The row
// is the reference's u8 layout: X digits || Y digits || identity flag, each
// coordinate component 34 bytes of x * 2^272 mod q (wide Montgomery,
// canonical). The kernel reads the low 32 bytes (the top two are zero for
// a canonical value) and moves the value to R = 2^256 with one Montgomery
// multiply by 2^240. A row whose flag is 0 (identity) leaves the lane as it
// is, which is adding the identity. A negative digit negates Y.
//
// Bound (H100): operations. A G1 mixed add is 13 Montgomery muls plus 2 for
// the row decode, 15 * 264 = 3,960 32-bit multiply-adds, against 73 bytes
// gathered per step (4 of payload, 69 of row): about 54 multiply-adds per
// byte, far above the card's 16.7e12 / 3.35e12 = 5 per byte. G2 is about
// 3x the multiplies on twice the bytes. K2 (14 muls on 192 bytes read and
// 96 written per G1 lane) is bound the same way. The design therefore keeps
// every lane's accumulator in registers for the whole run (one launch runs
// all k_steps), touches device memory only for the gathered row, and keeps
// the field core simple; wide-multiply scheduling and batching of the
// decode are later work.

#include "field.cuh"

namespace snark {

using Fq = Fp<FqParams>;
using Fq2 = Fp2<FqParams>;

// 2^240 mod q, raw (not Montgomery): mont_mul(x * 2^272, C) = x * 2^256.
static __constant__ uint32_t kRowToMont[8] = {0, 0, 0, 0, 0, 0, 0, 0x00010000u};
// 3b in Montgomery form: G1 b = 3, G2 b = 3 / (9 + u)
static __constant__ uint32_t kB3G1[8] = {
    0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
    0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
static __constant__ uint32_t kB3G2[16] = {
    0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
    0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u,
    0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
    0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};

template <class E>
struct Curve;

template <>
struct Curve<Fq> {
  static constexpr int K = 1;
  static __device__ __forceinline__ Fq b3() { return load_fp<FqParams>(kB3G1); }
  static __device__ __forceinline__ Fq load(const uint32_t* s) {
    return load_fp<FqParams>(s);
  }
  static __device__ __forceinline__ void store(uint32_t* d, const Fq& a) {
    store_fp<FqParams>(d, a);
  }
};

template <>
struct Curve<Fq2> {
  static constexpr int K = 2;
  static __device__ __forceinline__ Fq2 b3() {
    return {load_fp<FqParams>(kB3G2), load_fp<FqParams>(kB3G2 + 8)};
  }
  static __device__ __forceinline__ Fq2 load(const uint32_t* s) {
    return {load_fp<FqParams>(s), load_fp<FqParams>(s + 8)};
  }
  static __device__ __forceinline__ void store(uint32_t* d, const Fq2& a) {
    store_fp<FqParams>(d, a.c0);
    store_fp<FqParams>(d + 8, a.c1);
  }
};

template <class E>
struct Point {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Point<E> load_point(const uint32_t* s) {
  constexpr int W = 8 * Curve<E>::K;
  return {Curve<E>::load(s), Curve<E>::load(s + W), Curve<E>::load(s + 2 * W)};
}

template <class E>
__device__ __forceinline__ void store_point(uint32_t* d, const Point<E>& p) {
  constexpr int W = 8 * Curve<E>::K;
  Curve<E>::store(d, p.x);
  Curve<E>::store(d + W, p.y);
  Curve<E>::store(d + 2 * W, p.z);
}

// RCB15 Alg 7 (a = 0): complete projective add.
template <class E>
__device__ __forceinline__ Point<E> padd(const Point<E>& p, const Point<E>& q) {
  const E b3 = Curve<E>::b3();
  E t0 = p.x * q.x;
  E t1 = p.y * q.y;
  E t2 = p.z * q.z;
  E t3 = (p.x + p.y) * (q.x + q.y) - (t0 + t1);
  E t4 = (p.y + p.z) * (q.y + q.z) - (t1 + t2);
  E y3 = (p.x + p.z) * (q.x + q.z) - (t0 + t2);
  E t0p = (t0 + t0) + t0;
  E t2p = b3 * t2;
  E z3p = t1 + t2p;
  E t1p = t1 - t2p;
  y3 = b3 * y3;
  return {t3 * t1p - t4 * y3, t1p * z3p + y3 * t0p, z3p * t4 + t0p * t3};
}

// RCB15 Alg 8 (a = 0): complete mixed add, q affine (not the identity).
template <class E>
__device__ __forceinline__ Point<E> madd(const Point<E>& p, const E& qx, const E& qy) {
  const E b3 = Curve<E>::b3();
  E t0 = p.x * qx;
  E t1 = p.y * qy;
  E t3 = (p.x + p.y) * (qx + qy) - (t0 + t1);
  E t4 = qy * p.z + p.y;
  E y3 = qx * p.z + p.x;
  E t0p = (t0 + t0) + t0;
  E t2p = b3 * p.z;
  E z3p = t1 + t2p;
  E t1p = t1 - t2p;
  y3 = b3 * y3;
  return {t3 * t1p - t4 * y3, t1p * z3p + y3 * t0p, z3p * t4 + t0p * t3};
}

// One coordinate component of a u8 row: 32 little-endian bytes of x * 2^272.
__device__ __forceinline__ Fq decode_component(const uint8_t* src) {
  Fq w;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w.v[j] = (uint32_t)src[4 * j] | ((uint32_t)src[4 * j + 1] << 8) |
             ((uint32_t)src[4 * j + 2] << 16) | ((uint32_t)src[4 * j + 3] << 24);
  }
  return w * load_fp<FqParams>(kRowToMont);
}

__device__ __forceinline__ void decode_row(const uint8_t* row, Fq& x, Fq& y) {
  x = decode_component(row);
  y = decode_component(row + 34);
}

__device__ __forceinline__ void decode_row(const uint8_t* row, Fq2& x, Fq2& y) {
  x = {decode_component(row), decode_component(row + 34)};
  y = {decode_component(row + 68), decode_component(row + 102)};
}

template <class E>
__global__ void bucket_madd_rows_kernel(
    const uint32_t* __restrict__ acc_in, uint32_t* __restrict__ acc_out,
    const uint8_t* __restrict__ table, int row_bytes,
    const uint32_t* __restrict__ perm, const int32_t* __restrict__ lane_base,
    const int32_t* __restrict__ start, const int32_t* __restrict__ length,
    int lanes, int i0, int k_steps) {
  constexpr int LW = 3 * 8 * Curve<E>::K;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Point<E> acc = load_point<E>(acc_in + (size_t)l * LW);
  const int len = length[l];
  const int end = len < i0 + k_steps ? len : i0 + k_steps;
  const uint32_t* run = perm + (size_t)lane_base[l] + start[l];
  const int flag_at = 2 * 34 * Curve<E>::K;
  for (int i = i0; i < end; ++i) {
    const uint32_t pay = run[i];
    const uint8_t* row = table + (size_t)(pay & 0x7fffffffu) * row_bytes;
    if (row[flag_at] == 0) continue;  // identity row
    E qx, qy;
    decode_row(row, qx, qy);
    if (pay >> 31) qy = neg(qy);
    acc = madd(acc, qx, qy);
  }
  store_point<E>(acc_out + (size_t)l * LW, acc);
}

template <class E>
__global__ void masked_add_kernel(const uint32_t* __restrict__ p,
                                  const uint32_t* __restrict__ q,
                                  const uint8_t* __restrict__ mask,
                                  uint32_t* __restrict__ out, int lanes) {
  constexpr int LW = 3 * 8 * Curve<E>::K;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Point<E> a = load_point<E>(p + (size_t)l * LW);
  if (mask[l]) a = padd(a, load_point<E>(q + (size_t)l * LW));
  store_point<E>(out + (size_t)l * LW, a);
}

constexpr int kCurveBlock = 128;

}  // namespace snark

using namespace snark;

extern "C" int snark_bucket_madd_rows(int group, const void* acc_in, void* acc_out,
                                      const void* table, int row_bytes,
                                      const void* perm, const void* lane_base,
                                      const void* start, const void* length,
                                      int lanes, int i0, int k_steps, void* stream) {
  if (lanes <= 0) return 0;
  dim3 grid((lanes + kCurveBlock - 1) / kCurveBlock);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    kernel<<<grid, kCurveBlock, 0, s>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint8_t*)table, row_bytes,
        (const uint32_t*)perm, (const int32_t*)lane_base, (const int32_t*)start,
        (const int32_t*)length, lanes, i0, k_steps);
  };
  if (group == 1)
    args(bucket_madd_rows_kernel<Fq>);
  else
    args(bucket_madd_rows_kernel<Fq2>);
  return (int)cudaGetLastError();
}

extern "C" int snark_masked_add(int group, const void* p, const void* q,
                                const void* mask, void* out, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  dim3 grid((lanes + kCurveBlock - 1) / kCurveBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    masked_add_kernel<Fq><<<grid, kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)mask, (uint32_t*)out, lanes);
  else
    masked_add_kernel<Fq2><<<grid, kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)mask, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
