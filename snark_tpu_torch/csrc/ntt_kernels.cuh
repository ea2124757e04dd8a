// The scalar-field kernels K3 and K4 as templates over the field's params,
// with one host launcher each. ntt.cu instantiates them for BN254 Fr and
// ntt_bls.cu for BLS12-381 Fr. See ntt.cu for what they replace and what
// bounds them.
#pragma once

#include "field.cuh"

namespace snark {

template <class P>
__global__ void ntt_stage_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ tw, int half_n,
                                 int log_half, int tw_stride, int dif) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half_n) return;
  const int half = 1 << log_half;
  const int j = t & (half - 1);
  const size_t lo = ((size_t)(t >> log_half) << (log_half + 1)) + j;
  const size_t hi = lo + half;
  const Fp<P> a = load_fp<P>(x + P::N * lo);
  const Fp<P> b = load_fp<P>(x + P::N * hi);
  const Fp<P> w = load_fp<P>(tw + P::N * (size_t)j * tw_stride);
  if (dif) {
    store_fp<P>(y + P::N * lo, a + b);
    store_fp<P>(y + P::N * hi, (a - b) * w);
  } else {
    const Fp<P> v = b * w;
    store_fp<P>(y + P::N * lo, a + v);
    store_fp<P>(y + P::N * hi, a - v);
  }
}

template <class P>
__global__ void field_ew_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, const uint32_t* __restrict__ c,
                                const uint32_t* __restrict__ d, int n, int mode,
                                int b_bcast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp<P> x = load_fp<P>(a + P::N * (size_t)i);
  const Fp<P> y = load_fp<P>(b + (b_bcast ? 0 : P::N * (size_t)i));
  Fp<P> r;
  if (mode == 0) {
    r = x * y;
  } else if (mode == 1) {
    r = x + y;
  } else {
    r = (x * y - load_fp<P>(c + P::N * (size_t)i)) * load_fp<P>(d);
  }
  store_fp<P>(out + P::N * (size_t)i, r);
}

constexpr int kEwBlock = 256;

template <class P>
int launch_ntt_stage(const void* x, void* y, const void* tw, int n, int log_half,
                     int tw_stride, int dif, cudaStream_t s) {
  const int half_n = n / 2;
  ntt_stage_kernel<P><<<(half_n + kEwBlock - 1) / kEwBlock, kEwBlock, 0, s>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, half_n, log_half, tw_stride, dif);
  return (int)cudaGetLastError();
}

template <class P>
int launch_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                    const void* d, int n, int b_bcast, cudaStream_t s) {
  field_ew_kernel<P><<<(n + kEwBlock - 1) / kEwBlock, kEwBlock, 0, s>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (const uint32_t*)d, n, mode, b_bcast);
  return (int)cudaGetLastError();
}

// The BLS12-381 Fr launchers, defined in ntt_bls.cu.
int bls_ntt_stage(const void* x, void* y, const void* tw, int n, int log_half, int tw_stride,
                  int dif, cudaStream_t s);
int bls_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                 const void* d, int n, int b_bcast, cudaStream_t s);

}  // namespace snark
