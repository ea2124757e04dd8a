// The scalar-field kernels K3 and K4 as templates over the field's params,
// with one host launcher each. ntt.cu instantiates them for BN254 Fr and
// ntt_bls.cu for BLS12-381 Fr. See ntt.cu for what they replace, what
// bounds them and how the pass's tile is laid out.
#pragma once

#include "field.cuh"

namespace snark {

// A pass's tile holds at most 2^kPassLogTile elements (64 KB of shared
// memory for 8 limbs), and a thread runs up to kPassRadix stages on 2^R
// elements in registers between two exchanges through shared memory.
constexpr int kPassLogTile = 11;
constexpr int kPassRadix = 3;
constexpr int kPassThreads = 1 << (kPassLogTile - kPassRadix);
constexpr int kEwBlock = 256;

// ---- 16-byte loads and stores of one 8-word element (the launchers refuse
// a pointer that is not 16-byte aligned)
template <class P>
__device__ __forceinline__ Fp<P> load_fp16(const uint32_t* src) {
  static_assert(P::N == 8, "two uint4 an element");
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(src) + 1);
  return Fp<P>{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

template <class P>
__device__ __forceinline__ void store_fp16(uint32_t* dst, const Fp<P>& a) {
  const Fp<P> c = canon(a);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(c.v[0], c.v[1], c.v[2], c.v[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(c.v[4], c.v[5], c.v[6], c.v[7]);
}

// ---- K3: k consecutive radix-2 stages [s0, s0 + k) of a transform
//
// Sub-transform (hi, lo) of the pass holds the 2^k elements
// hi 2^(s0+k) + m 2^s0 + lo, m in [0, 2^k): the pass's stages pair
// elements of one sub-transform only. A block takes G = 2^log_g of them,
// q = block G + g for g in [0, G) (lo = q mod 2^s0, hi = q >> s0), so for
// s0 >= log_g its G values of lo are consecutive and every global access
// is a run of G elements. Tile position p = m G + g.
struct PassArgs {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* tw;     // stage s, butterfly j: tw[j << (tw_log - s)]
  const uint32_t* had_b;  // prologue (x b - c) d as the tile loads; null: none
  const uint32_t* had_c;
  const uint32_t* had_d;
  const uint32_t* scale;  // epilogue y = v scale as the tile stores; null: none
  int s0, k, log_g, tw_log;
};

// The global index of tile position p in block `block` (n < 2^31: 32 bits)
__device__ __forceinline__ uint32_t pass_index(uint32_t block, uint32_t p, int s0, int k,
                                               int log_g) {
  const uint32_t q = (block << log_g) | (p & ((1u << log_g) - 1));
  return ((q >> s0) << (s0 + k)) | ((p >> log_g) << s0) | (q & ((1u << s0) - 1));
}

// Word w of tile position p sits at tile[w T + swz(p)]: words in planes, so
// that 32 threads on 32 positions meet 32 banks, and the position's bits
// 5.. XORed into its low 5 bits, so that the rounds' strided positions
// (below) spread over the banks as well.
__device__ __forceinline__ int swz(int p) { return p ^ ((p >> 5) & 31); }

template <class P>
__device__ __forceinline__ Fp<P> tile_get(const uint32_t* tile, int T, int p) {
  const int s = swz(p);
  Fp<P> r;
#pragma unroll
  for (int w = 0; w < P::N; ++w) r.v[w] = tile[w * T + s];
  return r;
}

template <class P>
__device__ __forceinline__ void tile_put(uint32_t* tile, int T, int p, const Fp<P>& a) {
  const int s = swz(p);
#pragma unroll
  for (int w = 0; w < P::N; ++w) tile[w * T + s] = a.v[w];
}

// The tile's stages run in rounds of up to R (DIT: bits 0, 1, ... of m in
// order; DIF: from bit k - 1 down). A round's stages are bits [b, b + cnt)
// of m; in the tile they are bits log_g + b.. of p, inside a window of R
// bits starting at c = min(log_g + b, log T - R). Thread u holds the 2^R
// positions u with R zero bits inserted at c, each value j of the window,
// runs the round's stages on them in registers and writes them back: no
// two threads of a round share a position, so one barrier a round.
//
// Registers (ptxas, NVIDIA H100; PERF.md §6): with its products inline
// each instance of 8 elements a thread needs more than 128 registers and
// spilled 156-220 bytes when held to two blocks an SM. The DIF butterfly's
// product as a call (mont_mul_call) fits 118-124 registers with no spill,
// and DIF keeps two blocks an SM; the DIT butterfly needs 132-136 even so,
// so DIT runs one block an SM, inline, at 180-200 registers.
template <class P, int R, bool DIF>
__global__ void __launch_bounds__(kPassThreads, DIF ? 2 : 1) ntt_pass_kernel(const PassArgs a) {
  constexpr int E = 1 << R;
  extern __shared__ uint32_t tile[];
  const int log_t = a.k + a.log_g;
  const int T = 1 << log_t;
  const uint32_t block = blockIdx.x;
  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    const size_t i = (size_t)P::N * pass_index(block, p, a.s0, a.k, a.log_g);
    Fp<P> v = load_fp16<P>(a.x + i);
    if (a.had_b) {
      v = (v * load_fp16<P>(a.had_b + i) - load_fp16<P>(a.had_c + i)) * load_fp16<P>(a.had_d);
    }
    tile_put<P>(tile, T, p, v);
  }
  __syncthreads();
  const int rounds = (a.k + R - 1) / R;
  const int u = threadIdx.x;
  for (int r = 0; r < rounds; ++r) {
    int b, cnt;
    if (DIF) {
      const int top = a.k - r * R;
      b = max(top - R, 0);
      cnt = top - b;
    } else {
      b = r * R;
      cnt = min(R, a.k - b);
    }
    const int c = min(a.log_g + b, log_t - R);
    const int w_lo = a.log_g + b - c;  // the round's first window bit
    const int base = ((u >> c) << (c + R)) | (u & ((1 << c) - 1));
    Fp<P> e[E];
#pragma unroll
    for (int j = 0; j < E; ++j) e[j] = tile_get<P>(tile, T, base | (j << c));
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int wb = DIF ? R - 1 - t : t;
      if (wb < w_lo || wb >= w_lo + cnt) continue;
      const int sb = c + wb - a.log_g;  // the stage's bit of m
      const int s = a.s0 + sb;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j & (1 << wb)) continue;
        const uint32_t p = base | (j << c);
        const uint32_t q = (block << a.log_g) | (p & ((1u << a.log_g) - 1));
        const uint32_t jt = (((p >> a.log_g) & ((1u << sb) - 1)) << a.s0) | (q & ((1u << a.s0) - 1));
        const Fp<P> w = load_fp16<P>(a.tw + (size_t)P::N * (jt << (a.tw_log - s)));
        Fp<P>& lo = e[j];
        Fp<P>& hi = e[j | (1 << wb)];
        if (DIF) {
          const Fp<P> sum = lo + hi;
          hi = mont_mul_call<P>(lo - hi, w);
          lo = sum;
        } else {
          const Fp<P> v = hi * w;
          hi = lo - v;
          lo = lo + v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) tile_put<P>(tile, T, base | (j << c), e[j]);
    __syncthreads();
  }
  for (int p = threadIdx.x; p < T; p += blockDim.x) {
    const size_t i = (size_t)P::N * pass_index(block, p, a.s0, a.k, a.log_g);
    Fp<P> v = tile_get<P>(tile, T, p);
    if (a.scale) v = v * load_fp16<P>(a.scale + i);
    store_fp16<P>(a.y + i, v);
  }
}

// ---- K4: elementwise products and sums
template <class P>
__global__ void field_ew_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, const uint32_t* __restrict__ c,
                                const uint32_t* __restrict__ d, int n, int mode,
                                int b_bcast) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp<P> x = load_fp16<P>(a + P::N * (size_t)i);
  const Fp<P> y = load_fp16<P>(b + (b_bcast ? 0 : P::N * (size_t)i));
  Fp<P> r;
  if (mode == 0) {
    r = x * y;
  } else if (mode == 1) {
    r = x + y;
  } else {
    r = (x * y - load_fp16<P>(c + P::N * (size_t)i)) * load_fp16<P>(d);
  }
  store_fp16<P>(out + P::N * (size_t)i, r);
}

__host__ inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <class P, int R, bool DIF>
int launch_pass(const PassArgs& a, int blocks, size_t smem, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ntt_pass_kernel<P, R, DIF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (P::N * 4) << kPassLogTile);
  if (attr != cudaSuccess) return (int)attr;
  ntt_pass_kernel<P, R, DIF><<<blocks, 1 << (a.k + a.log_g - R), smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Refuses (cudaErrorInvalidValue, cudaErrorMisalignedAddress) what the
// kernel does not take: n not a power of two, stages outside [0, log n), a
// tile above 2^kPassLogTile elements or larger than n, a twiddle table
// that the stages cannot index, a pointer that is not 16-byte aligned.
template <class P>
int launch_ntt_pass(const PassArgs& a, int n, int dif, cudaStream_t s) {
  if (n < 2 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  const int log_n = 31 - __builtin_clz((unsigned)n);
  const int log_t = a.k + a.log_g;
  if (a.k < 1 || a.log_g < 0 || a.s0 < 0 || a.s0 + a.k > log_n || log_t > log_n ||
      log_t > kPassLogTile || a.tw_log < a.s0 + a.k - 1)
    return (int)cudaErrorInvalidValue;
  if ((a.had_b != nullptr) != (a.had_c != nullptr) || (a.had_b != nullptr) != (a.had_d != nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)a.x, (const void*)a.y, (const void*)a.tw, (const void*)a.had_b,
                        (const void*)a.had_c, (const void*)a.had_d, (const void*)a.scale})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int blocks = n >> log_t;
  const size_t smem = (size_t)(P::N * 4) << log_t;
  if (log_t >= 3) {
    return dif ? launch_pass<P, 3, true>(a, blocks, smem, s) : launch_pass<P, 3, false>(a, blocks, smem, s);
  }
  if (log_t == 2) {
    return dif ? launch_pass<P, 2, true>(a, blocks, smem, s) : launch_pass<P, 2, false>(a, blocks, smem, s);
  }
  return dif ? launch_pass<P, 1, true>(a, blocks, smem, s) : launch_pass<P, 1, false>(a, blocks, smem, s);
}

template <class P>
int launch_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                    const void* d, int n, int b_bcast, cudaStream_t s) {
  for (const void* p : {(const void*)out, a, b, c, d})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  field_ew_kernel<P><<<(n + kEwBlock - 1) / kEwBlock, kEwBlock, 0, s>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (const uint32_t*)d, n, mode, b_bcast);
  return (int)cudaGetLastError();
}

// The BLS12-381 Fr launchers, defined in ntt_bls.cu.
int bls_ntt_pass(const PassArgs& a, int n, int dif, cudaStream_t s);
int bls_field_ew(int mode, void* out, const void* a, const void* b, const void* c,
                 const void* d, int n, int b_bcast, cudaStream_t s);

}  // namespace snark
