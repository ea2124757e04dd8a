// Curve kernels of the bucket MSM, for BN254 G1 (over Fq) and G2 (over Fq2).
//
// K1 bucket_madd_rows replaces snark_tpu/ops/pallas_curve.py
//   make_masked_mixed_add_rows (bodies _madd_mixed_body and
//   _madd_mixed_body_batched_g1): the bucket scan of the MSM.
// K2 masked_add replaces snark_tpu/ops/pallas_curve.py make_masked_add
//   (body _add_body): the replica, suffix and spill folds of the MSM. With a
//   null mask every lane adds, and K2 replaces make_point_add as well: the
//   add of the device Horner combine.
// K5 point_double replaces snark_tpu/ops/pallas_curve.py make_point_double
//   (body _double_body, RCB15 Alg 9): the doublings of the Horner combine.
//
// The formulas, the point layout and the row codec are in curve.cuh.
//
// K1 gathers its rows itself. Lane l scans the run
//   perm[lane_base[l] + start[l] + i], i in [i0, min(i0 + k_steps, length[l])).
// Each payload is a table row index with the digit's sign in bit 31. A row
// whose flag is 0 (identity) leaves the lane as it is, which is adding the
// identity. A negative digit negates Y.
//
// Bound (H100): operations. A G1 mixed add is 13 Montgomery muls plus 2 for
// the row decode, 15 * 264 = 3,960 32-bit multiply-adds, against 73 bytes
// gathered per step (4 of payload, 69 of row): about 54 multiply-adds per
// byte, far above the card's 16.7e12 / 3.35e12 = 5 per byte. G2 is about
// 3x the multiplies on twice the bytes. K2 (14 muls on 192 bytes read and
// 96 written per G1 lane) and K5 (9 muls on 96 bytes read and 96 written)
// are bound the same way. The design therefore keeps every lane's
// accumulator in registers for the whole run (one launch runs all k_steps),
// touches device memory only for the gathered row, and keeps the field core
// simple; wide-multiply scheduling and batching of the decode are later
// work. The Horner combine runs K5 and K2 on one lane, c + 1 launches per
// window: there launch latency, not arithmetic, sets the time.

#include "curve.cuh"

namespace snark {

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
  if (mask == nullptr || mask[l]) a = padd(a, load_point<E>(q + (size_t)l * LW));
  store_point<E>(out + (size_t)l * LW, a);
}

template <class E>
__global__ void point_double_kernel(const uint32_t* __restrict__ p,
                                    uint32_t* __restrict__ out, int lanes) {
  constexpr int LW = 3 * 8 * Curve<E>::K;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  store_point<E>(out + (size_t)l * LW, pdbl(load_point<E>(p + (size_t)l * LW)));
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

extern "C" int snark_point_double(int group, const void* p, void* out, int lanes,
                                  void* stream) {
  if (lanes <= 0) return 0;
  dim3 grid((lanes + kCurveBlock - 1) / kCurveBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    point_double_kernel<Fq><<<grid, kCurveBlock, 0, s>>>((const uint32_t*)p, (uint32_t*)out, lanes);
  else
    point_double_kernel<Fq2><<<grid, kCurveBlock, 0, s>>>((const uint32_t*)p, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}
