// The batch-affine kernels K6, K7 and K8 as templates over the base
// field's params, with one host launcher each. affine.cu instantiates them
// for BN254 and affine_bls.cu for BLS12-381, each in its own nvcc process.
// See affine.cu for what they replace, the pair classes and what bounds
// them. Nothing here assumes a limb count or a row width: rows are read
// and written through Curve<E>::kRowDigits (34 bytes a component for
// BN254, 50 for BLS12-381) and elements through Curve<E>::W.
#pragma once

#include "curve.cuh"

namespace snark {

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

// a^(q - 2) = a^-1 (0 for a = 0), square and multiply from the top bit of
// the base field's Fermat exponent (field.cuh).
template <class P>
__device__ __forceinline__ Fp<P> fermat_inv(const Fp<P>& a) {
  Fp<P> acc = Curve<Fp<P>>::one();
  for (int i = P::kPm2Bits - 1; i >= 0; --i) {
    acc = acc * acc;
    if ((P::pm2(i >> 5) >> (i & 31)) & 1u) acc = acc * a;
  }
  return acc;
}

template <class P>
__device__ __forceinline__ Fp<P> field_inv(const Fp<P>& a) {
  return fermat_inv(a);
}

// (c0 + c1 u)^-1 = (c0 - c1 u) / (c0^2 + c1^2), as u^2 = -1 on both curves.
template <class P>
__device__ __forceinline__ Fp2<P> field_inv(const Fp2<P>& a) {
  const Fp<P> ninv = fermat_inv(a.c0 * a.c0 + a.c1 * a.c1);
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

inline dim3 affine_grid(int n) { return dim3((n + kAffineBlock - 1) / kAffineBlock); }

template <class P>
int launch_affine_phase1(int group, const void* rows, int row_bytes, const void* sgn, void* den,
                         void* cls, int pairs, cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<affine_grid(pairs), kAffineBlock, 0, s>>>((const uint8_t*)rows, row_bytes,
                                                       (const uint8_t*)sgn, (uint32_t*)den,
                                                       (uint8_t*)cls, pairs);
  };
  if (group == 1)
    run(affine_phase1_kernel<Fp<P>>);
  else
    run(affine_phase1_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_affine_phase3(int group, const void* rows, int row_bytes, const void* sgn,
                         const void* dinv, const void* cls, void* out, int pairs,
                         cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<affine_grid(pairs), kAffineBlock, 0, s>>>(
        (const uint8_t*)rows, row_bytes, (const uint8_t*)sgn, (const uint32_t*)dinv,
        (const uint8_t*)cls, (uint8_t*)out, pairs);
  };
  if (group == 1)
    run(affine_phase3_kernel<Fp<P>>);
  else
    run(affine_phase3_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

template <class P>
int launch_affine_tree_mul(int group, int mode, const void* a, const void* b, void* out, int n,
                           cudaStream_t s) {
  auto run = [&](auto kernel) {
    kernel<<<affine_grid(n), kAffineBlock, 0, s>>>((const uint32_t*)a, (const uint32_t*)b,
                                                   (uint32_t*)out, n, mode);
  };
  if (group == 1)
    run(affine_tree_mul_kernel<Fp<P>>);
  else
    run(affine_tree_mul_kernel<Fp2<P>>);
  return (int)cudaGetLastError();
}

// The BLS12-381 launchers, defined in affine_bls.cu.
int bls_affine_phase1(int group, const void* rows, int row_bytes, const void* sgn, void* den,
                      void* cls, int pairs, cudaStream_t s);
int bls_affine_phase3(int group, const void* rows, int row_bytes, const void* sgn,
                      const void* dinv, const void* cls, void* out, int pairs, cudaStream_t s);
int bls_affine_tree_mul(int group, int mode, const void* a, const void* b, void* out, int n,
                        cudaStream_t s);

}  // namespace snark
