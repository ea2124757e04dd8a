// The batch-affine kernels K6, K7 and K8 as templates over the base
// field's params, with one host launcher each. affine.cu instantiates them
// for BN254 and affine_bls.cu for BLS12-381, each in its own nvcc process.
// See affine.cu for what they replace, the pair classes and what bounds
// them. Nothing here assumes a limb count or a row width: rows are read
// and written through Rows<E> (curve.cuh; 34 bytes a component for BN254,
// 50 for BLS12-381) and elements through Curve<E>::W.
#pragma once

#include "curve.cuh"

namespace snark {

enum PairClass : uint8_t { kAdd = 0, kDouble = 1, kDead = 2, kCopyL = 3, kCopyR = 4 };

// ---- tiles: K6 and K8 stage what a block reads and writes in shared memory

// Pairs a block, one thread a pair (a multiple of 16, so that a tile of
// den, dinv or output rows in a 16-byte aligned tensor starts aligned).
constexpr int kAffineTile = 128;
static_assert(kAffineTile % 16 == 0 && kAffineTile >= 48, "tile_load's head and tail threads");

// 16 bytes from device memory to shared memory, both 16-byte aligned,
// asynchronously and through L2 only (cp.async.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Where a span of device memory sits in its shared buffer: at the span's
// offset within its 16 bytes, so that the span's 16-byte aligned chunks
// land on 16-byte aligned shared chunks. A buffer has 32 bytes more than
// its span, for the lead and for a word read past the span's end.
__device__ __forceinline__ int tile_lead(const void* g) { return (int)((uintptr_t)g & 15); }

__host__ __device__ constexpr int tile_room(int n) { return (n + 15) / 16 * 16 + 32; }

// The n bytes at g into sm + tile_lead(g) (sm 16-byte aligned): the
// aligned body in 16-byte cp.async copies, neighbouring threads on
// neighbouring chunks; the unaligned head and tail (at most 15 bytes each)
// a byte a thread, threads 0-15 and 32-47. The caller waits
// (cp_async_wait_all) and syncs the block before it reads the buffer.
__device__ __forceinline__ void tile_load(uint8_t* sm, const uint8_t* g, int n) {
  const int lead = tile_lead(g);
  const int head = min((16 - lead) & 15, n);
  const int chunks = (n - head) >> 4;
  const int tail = head + 16 * chunks;
  uint8_t* s = sm + lead;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(s + head + 16 * i, g + head + 16 * i);
  const int t = threadIdx.x;
  if (t < head) s[t] = g[t];
  if (t >= 32 && tail + t - 32 < n) s[tail + t - 32] = g[tail + t - 32];
}

// The inverse: the n bytes at sm + tile_lead(g) out to g, in 16-byte
// stores but for the head and tail. The caller syncs the block first.
__device__ __forceinline__ void tile_store(uint8_t* g, const uint8_t* sm, int n) {
  const int lead = tile_lead(g);
  const int head = min((16 - lead) & 15, n);
  const int chunks = (n - head) >> 4;
  const int tail = head + 16 * chunks;
  const uint8_t* s = sm + lead;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    *reinterpret_cast<uint4*>(g + head + 16 * i) =
        *reinterpret_cast<const uint4*>(s + head + 16 * i);
  const int t = threadIdx.x;
  if (t < head) g[t] = s[t];
  if (t >= 32 && tail + t - 32 < n) g[tail + t - 32] = s[tail + t - 32];
}

// ---- rows in a shared tile

// A component at byte `off` of a tile (s 4-byte aligned): its N words from
// N + 1 aligned shared words, each funnel-shifted by off's place in its
// word, then decode_words. A tile's rows lie 2 rb bytes apart (rb odd), so
// a warp's 32 threads hit each bank two or three times a load.
template <class P>
__device__ __forceinline__ Fp<P> decode_tile_component(const uint8_t* s, int off) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(s) + (off >> 2);
  const uint32_t sh = 8 * (off & 3);
  uint32_t w[P::N + 1], lo = a[0];
#pragma unroll
  for (int j = 0; j < P::N; ++j) {
    const uint32_t hi = a[j + 1];
    w[j] = __funnelshift_r(lo, hi, sh);
    lo = hi;
  }
  return decode_words<P>(w);
}

template <class P>
__device__ __forceinline__ void decode_tile_row(const uint8_t* s, int off, Fp<P>& x, Fp<P>& y) {
  constexpr int D = CurveConsts<P>::kRowDigits;
  x = decode_tile_component<P>(s, off);
  y = decode_tile_component<P>(s, off + D);
}

template <class P>
__device__ __forceinline__ void decode_tile_row(const uint8_t* s, int off, Fp2<P>& x,
                                                Fp2<P>& y) {
  constexpr int D = CurveConsts<P>::kRowDigits;
  x = {decode_tile_component<P>(s, off), decode_tile_component<P>(s, off + D)};
  y = {decode_tile_component<P>(s, off + 2 * D), decode_tile_component<P>(s, off + 3 * D)};
}

template <class E>
struct Pair {
  E x1, y1, x2, y2;
  bool f1, f2;
};

// Pair j, whose rows are at byte `off` of the tile s; sgn (global, or
// null) negates y.
template <class E>
__device__ __forceinline__ Pair<E> load_tile_pair(const uint8_t* s, int off,
                                                  const uint8_t* __restrict__ sgn, size_t j) {
  constexpr int RB = Rows<E>::kBytes;
  Pair<E> p;
  decode_tile_row(s, off, p.x1, p.y1);
  decode_tile_row(s, off + RB, p.x2, p.y2);
  p.f1 = s[off + RB - 1] != 0;
  p.f2 = s[off + 2 * RB - 1] != 0;
  if (sgn != nullptr) {
    if (sgn[2 * j]) p.y1 = neg(p.y1);
    if (sgn[2 * j + 1]) p.y2 = neg(p.y2);
  }
  return p;
}

// The words of a row, little-endian from its first byte: each two
// components a, b take 2 N + 1 words (D = 4 N + 2 bytes each, so b starts
// two bytes into a word, after a's two zero bytes), then the flag's word.
template <class P, int C>
__device__ __forceinline__ void row_words(uint32_t* u, const Fp<P> (&v)[C], uint32_t flag) {
  constexpr int N = P::N;
#pragma unroll
  for (int c = 0; c < C; c += 2) {
    const Fp<P> a = row_value(v[c]), b = row_value(v[c + 1]);
    uint32_t* o = u + (c / 2) * (2 * N + 1);
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = a.v[k];
    o[N] = b.v[0] << 16;
#pragma unroll
    for (int k = 1; k < N; ++k) o[N + k] = __funnelshift_l(b.v[k - 1], b.v[k], 16);
    o[2 * N] = b.v[N - 1] >> 16;
  }
  u[C / 2 * (2 * N + 1)] = flag;
}

// Row u (4 M + 1 bytes: u[M] holds the flag alone) into the tile s at byte
// o. Aligned word i of the row's span holds its bytes [4 i - a, 4 i + 4 - a),
// a = o mod 4: words 1 to M - 1 are the row's alone and take 32-bit stores;
// words 0 and M share bytes with the neighbouring rows and take byte stores.
template <int M>
__device__ __forceinline__ void store_tile_row(uint8_t* s, int o, const uint32_t (&u)[M + 1]) {
  const int a = o & 3;
  const uint32_t sh = 8 * a;
  uint8_t* b = s + (o & ~3);
  uint32_t* w = reinterpret_cast<uint32_t*>(b);
  const uint32_t first = u[0] << sh;
  const uint32_t last = __funnelshift_l(u[M - 1], u[M], sh);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= a) b[k] = (uint8_t)(first >> (8 * k));
    if (k <= a) b[4 * M + k] = (uint8_t)(last >> (8 * k));
  }
#pragma unroll
  for (int i = 1; i < M; ++i) w[i] = __funnelshift_l(u[i - 1], u[i], sh);
}

template <class P>
__device__ __forceinline__ void point_row_words(uint32_t* u, const Fp<P>& x, const Fp<P>& y,
                                                uint32_t flag) {
  const Fp<P> v[2] = {x, y};
  row_words<P, 2>(u, v, flag);
}

template <class P>
__device__ __forceinline__ void point_row_words(uint32_t* u, const Fp2<P>& x, const Fp2<P>& y,
                                                uint32_t flag) {
  const Fp<P> v[4] = {x.c0, x.c1, y.c0, y.c1};
  row_words<P, 4>(u, v, flag);
}

template <class E>
__device__ __forceinline__ uint8_t classify(const Pair<E>& p) {
  if (!p.f1) return p.f2 ? kCopyR : kDead;
  if (!p.f2) return kCopyL;
  if (!Curve<E>::eq(p.x1, p.x2)) return kAdd;
  return Curve<E>::eq(p.y1, p.y2) ? kDouble : kDead;
}

// Shared bytes of a K6 or K8 block: the tile's input rows, then its den
// (K6) or dinv (K8) elements; K8's output rows reuse the input's room.
template <class E>
constexpr int affine_smem_bytes() {
  return tile_room(2 * kAffineTile * Rows<E>::kBytes) +
         tile_room(kAffineTile * 4 * Curve<E>::W);
}

// A block takes pairs [j0, j0 + cnt): its 2 cnt rows are one span of
// device memory, staged in shared memory by tile_load before any thread
// decodes.
template <class E>
__global__ void __launch_bounds__(kAffineTile)
    affine_phase1_kernel(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ sgn,
                         uint32_t* __restrict__ den, uint8_t* __restrict__ cls, int pairs) {
  constexpr int RB = Rows<E>::kBytes, W = Curve<E>::W;
  extern __shared__ __align__(16) uint8_t affine_smem[];
  uint8_t* s_rows = affine_smem;
  uint8_t* s_den = affine_smem + tile_room(2 * kAffineTile * RB);
  const size_t j0 = (size_t)blockIdx.x * kAffineTile;
  const int cnt = min(kAffineTile, pairs - (int)j0);
  const uint8_t* g_rows = rows + 2 * j0 * RB;
  uint32_t* g_den = den + j0 * W;
  tile_load(s_rows, g_rows, 2 * cnt * RB);
  cp_async_wait_all();
  __syncthreads();
  const int t = threadIdx.x;
  if (t < cnt) {
    const Pair<E> p = load_tile_pair<E>(s_rows, tile_lead(g_rows) + 2 * t * RB, sgn, j0 + t);
    const uint8_t c = classify(p);
    E d = Curve<E>::one();
    if (c == kAdd) d = p.x2 - p.x1;
    if (c == kDouble) d = p.y1 + p.y1;
    Curve<E>::store(reinterpret_cast<uint32_t*>(s_den + tile_lead(g_den)) + t * W, d);
    cls[j0 + t] = c;
  }
  __syncthreads();
  tile_store(reinterpret_cast<uint8_t*>(g_den), s_den, cnt * W * 4);
}

template <class E>
__global__ void __launch_bounds__(kAffineTile)
    affine_phase3_kernel(const uint8_t* __restrict__ rows, const uint8_t* __restrict__ sgn,
                         const uint32_t* __restrict__ dinv, const uint8_t* __restrict__ cls,
                         uint8_t* __restrict__ out, int pairs) {
  constexpr int RB = Rows<E>::kBytes, W = Curve<E>::W;
  extern __shared__ __align__(16) uint8_t affine_smem[];
  uint8_t* s_rows = affine_smem;
  uint8_t* s_dinv = affine_smem + tile_room(2 * kAffineTile * RB);
  const size_t j0 = (size_t)blockIdx.x * kAffineTile;
  const int cnt = min(kAffineTile, pairs - (int)j0);
  const uint8_t* g_rows = rows + 2 * j0 * RB;
  const uint32_t* g_dinv = dinv + j0 * W;
  uint8_t* g_out = out + j0 * RB;
  tile_load(s_rows, g_rows, 2 * cnt * RB);
  tile_load(s_dinv, reinterpret_cast<const uint8_t*>(g_dinv), cnt * W * 4);
  cp_async_wait_all();
  __syncthreads();
  const int t = threadIdx.x;
  uint32_t u[Rows<E>::kWords + 1];
  if (t < cnt) {
    const Pair<E> p = load_tile_pair<E>(s_rows, tile_lead(g_rows) + 2 * t * RB, sgn, j0 + t);
    const uint8_t c = cls[j0 + t];
    E x3, y3;
    if (c == kAdd || c == kDouble) {
      E num;
      if (c == kAdd) {
        num = p.y2 - p.y1;
      } else {
        const E sq = p.x1 * p.x1;
        num = (sq + sq) + sq;
      }
      const E lam =
          num * Curve<E>::load(reinterpret_cast<const uint32_t*>(s_dinv + tile_lead(g_dinv)) +
                               t * W);
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
    point_row_words(u, x3, y3, c == kDead ? 0u : 1u);
  }
  __syncthreads();  // every input row decoded: the output rows take their room
  if (t < cnt) store_tile_row<Rows<E>::kWords>(s_rows, tile_lead(g_out) + t * RB, u);
  __syncthreads();
  tile_store(g_out, s_rows, cnt * RB);
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

// K6 and K8 take their shared memory dynamically; above 48 KB (BLS12-381
// G2) the kernel's limit is raised first.
template <class E, class Kernel, class... Args>
int launch_tiled(Kernel kernel, int pairs, cudaStream_t s, Args... args) {
  constexpr int bytes = affine_smem_bytes<E>();
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((pairs + kAffineTile - 1) / kAffineTile);
  kernel<<<grid, kAffineTile, bytes, s>>>(args..., pairs);
  return (int)cudaGetLastError();
}

// A row_bytes that is not the group's row width is refused.
template <class P>
int launch_affine_phase1(int group, const void* rows, int row_bytes, const void* sgn, void* den,
                         void* cls, int pairs, cudaStream_t s) {
  auto run = [&](auto kernel, auto e) {
    using E = decltype(e);
    if (row_bytes != Rows<E>::kBytes) return (int)cudaErrorInvalidValue;
    return launch_tiled<E>(kernel, pairs, s, (const uint8_t*)rows, (const uint8_t*)sgn,
                           (uint32_t*)den, (uint8_t*)cls);
  };
  if (group == 1) return run(affine_phase1_kernel<Fp<P>>, Fp<P>{});
  return run(affine_phase1_kernel<Fp2<P>>, Fp2<P>{});
}

template <class P>
int launch_affine_phase3(int group, const void* rows, int row_bytes, const void* sgn,
                         const void* dinv, const void* cls, void* out, int pairs,
                         cudaStream_t s) {
  auto run = [&](auto kernel, auto e) {
    using E = decltype(e);
    if (row_bytes != Rows<E>::kBytes) return (int)cudaErrorInvalidValue;
    return launch_tiled<E>(kernel, pairs, s, (const uint8_t*)rows, (const uint8_t*)sgn,
                           (const uint32_t*)dinv, (const uint8_t*)cls, (uint8_t*)out);
  };
  if (group == 1) return run(affine_phase3_kernel<Fp<P>>, Fp<P>{});
  return run(affine_phase3_kernel<Fp2<P>>, Fp2<P>{});
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
