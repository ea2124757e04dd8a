// Scalar-field kernels of the h pipeline, over BN254 Fr.
//
// K3 ntt_stage replaces snark_tpu/ops/ntt_plane.py _Kernels.dit_kernel,
//   dif_kernel and dif_norm_kernel: one radix-2 stage of a transform.
//   DIT: (lo, hi) -> (lo + hi*w, lo - hi*w); DIF: (lo + hi, (lo - hi)*w).
//   Every output here is fully reduced, so the TPU's normalising DIF
//   butterfly (dif_norm_kernel, which re-clamps the lazily reduced sum every
//   4th stage) has no counterpart: values never grow.
// K4 field_ew replaces snark_tpu/ops/ntt_plane.py _Kernels.vmul_kernel,
//   make_hadamard, remont_kernel and tostd_kernel2, and the standalone
//   snark_tpu/ops/pallas_field_v3.py make_mont_mul_v3:
//   mode 0  out = a * b             (b[0] for every element if b_bcast)
//   mode 1  out = a + b
//   mode 2  out = (a * b - c) * d[0] (the Hadamard step with 1/Z_H)
//   Conversion into Montgomery form is mode 0 with b = R^2 mod p broadcast,
//   out of it mode 0 with b = 1 (raw); they take the place of remont and
//   tostd.
//
// Layout: (n, 8) u32 limbs, Montgomery R = 2^256 (field.cuh). The stage's
// twiddle for butterfly j is tw[j * tw_stride] of one table of powers.
//
// Bound (H100): K3 moves 64 bytes in and 64 out per butterfly plus 32 of
// twiddle, against one Montgomery mul (264 multiply-adds): about 1.7 per
// byte, below the card's 16.7e12 / 3.35e12 = 5, so K3 is bound by bytes.
// K4 in mode 0 moves 96 bytes per element for one mul (2.75 per byte):
// bytes as well. The design reads and writes each element once per stage,
// one thread per butterfly, neighbouring threads on neighbouring butterflies
// so that the 32-byte rows of a warp are contiguous. Fusing several stages
// into one pass through shared memory is later work.

#include "field.cuh"

namespace snark {

using Fr = Fp<FrParams>;

__global__ void ntt_stage_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ tw, int half_n,
                                 int log_half, int tw_stride, int dif) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half_n) return;
  const int half = 1 << log_half;
  const int j = t & (half - 1);
  const size_t lo = ((size_t)(t >> log_half) << (log_half + 1)) + j;
  const size_t hi = lo + half;
  const Fr a = load_fp<FrParams>(x + 8 * lo);
  const Fr b = load_fp<FrParams>(x + 8 * hi);
  const Fr w = load_fp<FrParams>(tw + 8 * (size_t)j * tw_stride);
  if (dif) {
    store_fp<FrParams>(y + 8 * lo, a + b);
    store_fp<FrParams>(y + 8 * hi, (a - b) * w);
  } else {
    const Fr v = b * w;
    store_fp<FrParams>(y + 8 * lo, a + v);
    store_fp<FrParams>(y + 8 * hi, a - v);
  }
}

__global__ void field_ew_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, const uint32_t* __restrict__ c,
                                const uint32_t* __restrict__ d, int n, int mode,
                                int b_bcast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fr x = load_fp<FrParams>(a + 8 * (size_t)i);
  const Fr y = load_fp<FrParams>(b + (b_bcast ? 0 : 8 * (size_t)i));
  Fr r;
  if (mode == 0) {
    r = x * y;
  } else if (mode == 1) {
    r = x + y;
  } else {
    r = (x * y - load_fp<FrParams>(c + 8 * (size_t)i)) * load_fp<FrParams>(d);
  }
  store_fp<FrParams>(out + 8 * (size_t)i, r);
}

constexpr int kEwBlock = 256;

}  // namespace snark

using namespace snark;

extern "C" int snark_ntt_stage(const void* x, void* y, const void* tw, int n, int log_half,
                               int tw_stride, int dif, void* stream) {
  const int half_n = n / 2;
  if (half_n <= 0) return 0;
  ntt_stage_kernel<<<(half_n + kEwBlock - 1) / kEwBlock, kEwBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, half_n, log_half, tw_stride, dif);
  return (int)cudaGetLastError();
}

extern "C" int snark_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                              const void* d, int n, int b_bcast, void* stream) {
  if (n <= 0) return 0;
  field_ew_kernel<<<(n + kEwBlock - 1) / kEwBlock, kEwBlock, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (const uint32_t*)d, n, mode, b_bcast);
  return (int)cudaGetLastError();
}
