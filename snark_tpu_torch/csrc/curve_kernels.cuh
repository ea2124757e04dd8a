// The curve kernels K1, K2, K5 and K11 as templates over the base field's
// params, with one host launcher each. curve.cu instantiates them for
// BN254 and curve_bls.cu for BLS12-381, each in its own nvcc process.
// See curve.cu for what they replace and what bounds them.
#pragma once

#include "curve.cuh"

namespace snark {

// K1. Part (curve.cuh) picks the step's body; the default is the shipped
// one, and the other parts (madd_parts.cu) change nothing else: the
// gather, the identity skip, the sign, the loop and the store are shared.
template <class E, int Part = kMaddFull>
__global__ void bucket_madd_rows_kernel(
    const uint32_t* __restrict__ acc_in, uint32_t* __restrict__ acc_out,
    const uint8_t* __restrict__ table, int row_bytes,
    const uint32_t* __restrict__ perm, const int32_t* __restrict__ lane_base,
    const int32_t* __restrict__ start, const int32_t* __restrict__ length,
    int lanes, int i0, int k_steps) {
  constexpr int LW = 3 * Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Point<E> acc = load_point<E>(acc_in + (size_t)l * LW);
  const int len = length[l];
  const int end = len < i0 + k_steps ? len : i0 + k_steps;
  const uint32_t* run = perm + (size_t)lane_base[l] + start[l];
  constexpr int flag_at = 2 * Curve<E>::kRowDigits * Curve<E>::K;
  for (int i = i0; i < end; ++i) {
    const uint32_t pay = run[i];
    const uint8_t* row = table + (size_t)(pay & 0x7fffffffu) * row_bytes;
    if (row[flag_at] == 0) continue;  // identity row
    if constexpr (Part == kMaddNodecode) {
      acc = madd(acc, acc.z, acc.y);  // no decode, the sign ignored
    } else {
      E qx, qy;
      decode_row(row, qx, qy);
      if (pay >> 31) qy = neg(qy);
      acc = madd_part<Part>(acc, qx, qy);
    }
  }
  store_point<E>(acc_out + (size_t)l * LW, acc);
}

template <class E>
__global__ void masked_add_kernel(const uint32_t* __restrict__ p,
                                  const uint32_t* __restrict__ q,
                                  const uint8_t* __restrict__ mask,
                                  uint32_t* __restrict__ out, int lanes) {
  constexpr int LW = 3 * Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t at = (size_t)l * LW;
  if (mask != nullptr && !mask[l]) {
    store_point<E>(out + at, load_point<E>(p + at));
  } else if constexpr (Curve<E>::K == 2) {
    // G2 reads its operands at each use (curve.cuh MemPoint); G1's fit in
    // registers, and a one-lane launch (the Horner combine) would wait on
    // each read
    store_point<E>(out + at, padd(MemPoint<E>{p + at}, MemPoint<E>{q + at}));
  } else {
    store_point<E>(out + at, padd(load_point<E>(p + at), load_point<E>(q + at)));
  }
}

// K11: mask ? p + (x2, y2) : p, q = (x2, y2) affine and not the identity
// where the mask is set (the caller's duty, as for the reference).
template <class E>
__global__ void masked_mixed_add_kernel(const uint32_t* __restrict__ p,
                                        const uint32_t* __restrict__ x2,
                                        const uint32_t* __restrict__ y2,
                                        const uint8_t* __restrict__ mask,
                                        uint32_t* __restrict__ out, int lanes) {
  constexpr int W = Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Point<E> a = load_point<E>(p + (size_t)l * 3 * W);
  if (mask[l])
    a = madd(a, Curve<E>::load(x2 + (size_t)l * W), Curve<E>::load(y2 + (size_t)l * W));
  store_point<E>(out + (size_t)l * 3 * W, a);
}

template <class E>
__global__ void point_double_kernel(const uint32_t* __restrict__ p,
                                    uint32_t* __restrict__ out, int lanes) {
  constexpr int LW = 3 * Curve<E>::W;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  store_point<E>(out + (size_t)l * LW, pdbl(load_point<E>(p + (size_t)l * LW)));
}

constexpr int kCurveBlock = 128;

inline dim3 curve_grid(int lanes) { return dim3((lanes + kCurveBlock - 1) / kCurveBlock); }

template <class P>
int launch_bucket_madd_rows(int group, const void* acc_in, void* acc_out, const void* table,
                            int row_bytes, const void* perm, const void* lane_base,
                            const void* start, const void* length, int lanes, int i0,
                            int k_steps, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)acc_in, (uint32_t*)acc_out, (const uint8_t*)table, row_bytes,
        (const uint32_t*)perm, (const int32_t*)lane_base, (const int32_t*)start,
        (const int32_t*)length, lanes, i0, k_steps);
  };
  if (group == 1)
    run(bucket_madd_rows_kernel<Fp<P>>);
  else
    run(bucket_madd_rows_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_masked_add(int group, const void* p, const void* q, const void* mask, void* out,
                      int lanes, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (const uint32_t*)q, (const uint8_t*)mask, (uint32_t*)out, lanes);
  };
  if (group == 1)
    run(masked_add_kernel<Fp<P>>);
  else
    run(masked_add_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_masked_mixed_add(int group, const void* p, const void* x2, const void* y2,
                            const void* mask, void* out, int lanes, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (const uint32_t*)x2, (const uint32_t*)y2, (const uint8_t*)mask,
        (uint32_t*)out, lanes);
  };
  if (group == 1)
    run(masked_mixed_add_kernel<Fp<P>>);
  else
    run(masked_mixed_add_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_point_double(int group, const void* p, void* out, int lanes, cudaStream_t s) {
  if (group == 1)
    point_double_kernel<Fp<P>><<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (uint32_t*)out, lanes);
  else
    point_double_kernel<Fp2<P>><<<curve_grid(lanes), kCurveBlock, 0, s>>>(
        (const uint32_t*)p, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}

// The BLS12-381 launchers, defined in curve_bls.cu.
int bls_bucket_madd_rows(int group, const void* acc_in, void* acc_out, const void* table,
                         int row_bytes, const void* perm, const void* lane_base,
                         const void* start, const void* length, int lanes, int i0,
                         int k_steps, cudaStream_t s);
int bls_masked_add(int group, const void* p, const void* q, const void* mask, void* out,
                   int lanes, cudaStream_t s);
int bls_point_double(int group, const void* p, void* out, int lanes, cudaStream_t s);
int bls_masked_mixed_add(int group, const void* p, const void* x2, const void* y2,
                         const void* mask, void* out, int lanes, cudaStream_t s);

}  // namespace snark
