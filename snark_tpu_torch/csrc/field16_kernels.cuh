// The standalone Montgomery products K9 and K10 over 16-bit limbs, as
// templates over the scalar field's params (field.cuh), with one host
// launcher each. field16.cu instantiates them for BN254 Fr and BLS12-381 Fr
// and holds the C entry points; what they replace and what bounds them is
// there.
//
// Both take and give the JAX package's element layout: L16 = 2 N 16-bit
// limbs per element, one per u32, Montgomery R = 2^(16 L16) = 2^(32 N)
// (the core's R for both scalar fields), canonical. A limb pair packs into
// one 32-bit word: w_j = limb_{2j} | limb_{2j+1} << 16.
#pragma once

#include "field.cuh"

namespace snark {

// N' = -p^-1 mod R in full (N words), for K10's SOS reduction
// (checked against fields/limbs.py by the port's tests)
static __constant__ uint32_t kFrNp[8] = {
    0xefffffffu, 0xc2e1f593u, 0x4c6911b3u, 0x6586864bu,
    0x99062391u, 0xe39a9828u, 0x0d8341b2u, 0x73f82f1du};
static __constant__ uint32_t kBlsFrNp[8] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfdu, 0x53ba5bffu,
    0x0004ec06u, 0x181b2c17u, 0xd7bf2839u, 0x3d443ab0u};

template <class P>
struct NPrime;

template <>
struct NPrime<FrParams> {
  static __device__ __forceinline__ uint32_t w(int i) { return kFrNp[i]; }
};

template <>
struct NPrime<BlsFrParams> {
  static __device__ __forceinline__ uint32_t w(int i) { return kBlsFrNp[i]; }
};

// K9: one thread per element, row-major (n, 2N) limbs, each row read as
// 16-byte vectors (64 B for N = 8: neighbouring threads 64 B apart), the
// core's CIOS product.
template <class P>
__global__ void mont_mul16_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, int n) {
  constexpr int N = P::N;
  static_assert(N % 2 == 0, "rows of 2N limbs read as uint4");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* ra = reinterpret_cast<const uint4*>(a + (size_t)i * 2 * N);
  const uint4* rb = reinterpret_cast<const uint4*>(b + (size_t)i * 2 * N);
  Fp<P> x, y;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const uint4 va = ra[k], vb = rb[k];
    x.v[2 * k] = va.x | (va.y << 16);
    x.v[2 * k + 1] = va.z | (va.w << 16);
    y.v[2 * k] = vb.x | (vb.y << 16);
    y.v[2 * k + 1] = vb.z | (vb.w << 16);
  }
  const Fp<P> r = x * y;
  uint4* ro = reinterpret_cast<uint4*>(out + (size_t)i * 2 * N);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    ro[k] = make_uint4(r.v[2 * k] & 0xffffu, r.v[2 * k] >> 16, r.v[2 * k + 1] & 0xffffu,
                       r.v[2 * k + 1] >> 16);
  }
}

// K10: one thread per element, limb-major (2N, n) limbs, so a warp's load
// of one limb is 128 contiguous bytes; SOS product:
//   t = a b (2N words), m = (t mod R) N' mod R, u = (t + m p) / R, then
//   one conditional subtraction.
// Bounds: t < p^2, m < R, so t + m p < p^2 + R p < 2 p R < R^2 (p < R/2):
// the sum fits 2N words with no carry out, and u < 2p < R fits N words.
template <class P>
__global__ void mont_mul16_limb_major_kernel(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             uint32_t* __restrict__ out, int n) {
  constexpr int N = P::N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = a[(size_t)(2 * j) * n + i] | (a[(size_t)(2 * j + 1) * n + i] << 16);
    y[j] = b[(size_t)(2 * j) * n + i] | (b[(size_t)(2 * j + 1) * n + i] << 16);
  }
  // t = x y, schoolbook: row i's last carry lands in t[i + N], still 0
  uint32_t t[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) t[k] = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)x[j] * y[r] + t[r + j] + c;
      t[r + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[r + N] = (uint32_t)c;
  }
  // m = t_lo N' mod R: the product truncated to N words
  uint32_t m[N];
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j + r < N; ++j) {
      const uint64_t s = (uint64_t)t[r] * NPrime<P>::w(j) + m[r + j] + c;
      m[r + j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  // t += m p, each row's carry rippled up to the top word
#pragma unroll
  for (int r = 0; r < N; ++r) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)m[r] * P::p(j) + t[r + j] + c;
      t[r + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int k = r + N; k < 2 * N; ++k) {
      const uint64_t s = (uint64_t)t[k] + c;
      t[k] = (uint32_t)s;
      c = s >> 32;
    }
  }
  const Fp<P> u = reduce_once<P>(t + N);  // the low N words are 0
#pragma unroll
  for (int j = 0; j < N; ++j) {
    out[(size_t)(2 * j) * n + i] = u.v[j] & 0xffffu;
    out[(size_t)(2 * j + 1) * n + i] = u.v[j] >> 16;
  }
}

inline dim3 field16_grid(int n, int threads) { return dim3((n + threads - 1) / threads); }

template <class P>
int launch_mont_mul16(const void* a, const void* b, void* out, int n, int threads,
                      cudaStream_t s) {
  mont_mul16_kernel<P><<<field16_grid(n, threads), threads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

template <class P>
int launch_mont_mul16_limb_major(const void* a, const void* b, void* out, int n, int threads,
                                 cudaStream_t s) {
  mont_mul16_limb_major_kernel<P><<<field16_grid(n, threads), threads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace snark
