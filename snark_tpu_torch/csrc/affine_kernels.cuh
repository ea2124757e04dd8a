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

// a^(q - 2) = a^-1 (0 for a = 0) over fixed 4-bit windows of the base
// field's Fermat exponent (field.cuh), most significant first, as the
// reference's _fermat_inv: a table of a^1 .. a^15 (14 products, in local
// memory, as a window indexes it), then four squares a window and one
// product by the table a nonzero window. BN254 (64 windows, the top one
// 3): 14 + 252 + 59 = 325 products on the critical path against the binary
// ladder's 254 + 110 = 364; BLS12-381 (96 windows, the top one 1): 14 + 380
// + 91 = 485 against 381 + 229 = 610.
template <class P>
__device__ __forceinline__ uint32_t pm2_window(int k) {
  return (P::pm2(k >> 3) >> (4 * (k & 7))) & 15u;
}

template <class P>
__device__ __forceinline__ Fp<P> fermat_inv(const Fp<P>& a) {
  constexpr int kWindows = (P::kPm2Bits + 3) / 4;
  Fp<P> tbl[15];
  tbl[0] = a;
#pragma unroll 1
  for (int d = 1; d < 15; ++d) tbl[d] = tbl[d - 1] * a;
  Fp<P> acc = tbl[pm2_window<P>(kWindows - 1) - 1];  // the top window is nonzero
#pragma unroll 1
  for (int k = kWindows - 2; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = acc * acc;
    const uint32_t d = pm2_window<P>(k);
    if (d) acc = acc * tbl[d - 1];
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

// ---- K19 affine_batch_inverse: Montgomery's trick in three launches
//
// The inverses of n nonzero elements (den, (n, W) words) into out, in
// three launches whatever n:
//   up    block b of T threads takes elements [b T C, (b + 1) T C); thread
//         t of it the chunk b T C + t + i T (i < C), so that a warp's loads
//         and stores cover consecutive elements with no staging. The thread
//         runs the chunk's prefix products into out (scratch: prefix p_i in
//         element i's place, all but the last), and leaves the chunk's
//         product in a heap of 2 T nodes in shared memory (leaf T + t); the
//         block multiplies the heap up to node 1 and writes nodes 1 .. 2T - 1
//         to its row of the workspace (G rows of 2 T elements, G = ceil(n /
//         (T C))).
//   top   one block of kTop threads runs the same trick over the G block
//         products (node 1 of each row), a chunk of ceil(G / kTop) each, so
//         any G takes one launch; its prefixes go to node 0 of the rows,
//         thread 0 inverts its heap's root (field_inv), and each block
//         product's inverse replaces it in node 1.
//   down  block b loads its row (node 1 now the block's inverse) into its
//         heap, takes each node's inverse down to the leaves, and each
//         thread walks its chunk back: dinv_i = inv p_(i-1), inv = inv x_i.
// Products: the chunks 3 (n - G T) (C - 1 up, 2 (C - 1) down, a chunk), the
// heaps 3 (T - 1) a block and the top's 3 (G - 1), about 3 n, as a product
// tree's; plus the root inverse (fermat_inv) on one thread. Bytes: den read
// twice (up, down), out written twice and its prefixes read once, the
// workspace (2 n / C elements) written and read once. See affine.cu for the
// bound.

// Sizes of an instance: T threads a block of up and down and C elements a
// chunk; kTop threads in the top block. T and kTop powers of two.
template <class E>
struct InverseSizes;
template <>
struct InverseSizes<Fp<FqParams>> {
  static constexpr int T = 128, C = 32, kTop = 256;
};
template <>
struct InverseSizes<Fp2<FqParams>> {
  static constexpr int T = 128, C = 16, kTop = 256;
};
template <>
struct InverseSizes<Fp<BlsFqParams>> {
  static constexpr int T = 128, C = 32, kTop = 256;
};
template <>
struct InverseSizes<Fp2<BlsFqParams>> {
  static constexpr int T = 128, C = 16, kTop = 256;
};

// An element in 16-byte accesses (W words, a multiple of 4; s 16-byte
// aligned), stored canonical.
template <class E>
__device__ __forceinline__ E load_elem(const uint32_t* s) {
  uint32_t w[Curve<E>::W];
#pragma unroll
  for (int k = 0; k < Curve<E>::W; k += 4)
    *reinterpret_cast<uint4*>(w + k) = *reinterpret_cast<const uint4*>(s + k);
  return Curve<E>::load(w);
}

template <class E>
__device__ __forceinline__ void store_elem(uint32_t* d, const E& a) {
  uint32_t w[Curve<E>::W];
  Curve<E>::store(w, a);
#pragma unroll
  for (int k = 0; k < Curve<E>::W; k += 4)
    *reinterpret_cast<uint4*>(d + k) = *reinterpret_cast<const uint4*>(w + k);
}

// The elements of a chunk: e0 + i step for i < cnt, element e at x + e s
// (and so for p and y). Up: the prefix products p_i = x_0 ... x_i, p_i
// written to p at element i's place for i < cnt - 1; returns the chunk's
// product (one for an empty chunk).
template <class E>
__device__ __forceinline__ E chunk_up(const uint32_t* x, uint32_t* p, size_t s, size_t e0,
                                      int step, int cnt) {
  if (cnt == 0) return Curve<E>::one();
  E acc = load_elem<E>(x + e0 * s);
  for (int i = 1; i < cnt; ++i) {
    const size_t e = e0 + (size_t)i * step;
    store_elem(p + (e - step) * s, acc);
    acc = acc * load_elem<E>(x + e * s);
  }
  return acc;
}

// Down, from inv = the inverse of the chunk's product: for i = cnt - 1 down
// to 1, y_i = inv p_(i-1) and inv = inv x_i; y_0 = inv. x_i is read before
// y_i is written, so y may be x; p_(i-1) is read before y_(i-1), so y may
// be p.
template <class E>
__device__ __forceinline__ void chunk_down(const uint32_t* x, const uint32_t* p, uint32_t* y,
                                           size_t s, size_t e0, int step, int cnt, E inv) {
  for (int i = cnt - 1; i >= 1; --i) {
    const size_t e = e0 + (size_t)i * step;
    const E xi = load_elem<E>(x + e * s);
    store_elem(y + e * s, inv * load_elem<E>(p + (e - step) * s));
    inv = inv * xi;
  }
  if (cnt > 0) store_elem(y + e0 * s, inv);
}

// A heap of 2 T nodes in shared memory (node i at h + i W; children 2i and
// 2i + 1; leaves T .. 2T - 1). Up: each node the product of its children,
// a level at a time. All T threads call it.
template <class E>
__device__ __forceinline__ void heap_up(uint32_t* h, int T) {
  constexpr int W = Curve<E>::W;
  const int t = threadIdx.x;
  for (int L = T / 2; L >= 1; L >>= 1) {
    __syncthreads();
    if (t < L) {
      const int node = L + t;
      store_elem(h + node * W,
                 load_elem<E>(h + 2 * node * W) * load_elem<E>(h + (2 * node + 1) * W));
    }
  }
  __syncthreads();
}

// Down, from node 1 = the inverse of the root: each child's inverse is its
// parent's inverse times its sibling, one thread a child; the leaves end as
// the inverses of the leaves' values. All T threads call it.
template <class E>
__device__ __forceinline__ void heap_down(uint32_t* h, int T) {
  constexpr int W = Curve<E>::W;
  const int t = threadIdx.x;
  for (int L = 1; L < T; L <<= 1) {
    const bool act = t < 2 * L;
    const int child = 2 * L + t;
    E v;
    if (act) v = load_elem<E>(h + (child >> 1) * W) * load_elem<E>(h + (child ^ 1) * W);
    __syncthreads();
    if (act) store_elem(h + child * W, v);
    __syncthreads();
  }
}

// Elements of thread t's chunk: e0 = base + t, e0 + step, ... below n, at
// most cmax.
__device__ __forceinline__ int chunk_count(size_t n, size_t e0, int step, int cmax) {
  if (e0 >= n) return 0;
  const size_t c = (n - e0 + step - 1) / step;
  return c < (size_t)cmax ? (int)c : cmax;
}

template <class E>
__global__ void __launch_bounds__(InverseSizes<E>::T)
    affine_inverse_up_kernel(const uint32_t* den, uint32_t* out, uint32_t* ws, int n) {
  constexpr int W = Curve<E>::W, T = InverseSizes<E>::T, C = InverseSizes<E>::C;
  extern __shared__ __align__(16) uint32_t inv_heap[];
  const int t = threadIdx.x;
  const size_t e0 = (size_t)blockIdx.x * T * C + t;
  const int cnt = chunk_count(n, e0, T, C);
  store_elem(inv_heap + (T + t) * W, chunk_up<E>(den, out, W, e0, T, cnt));
  heap_up<E>(inv_heap, T);
  // nodes 1 .. 2T - 1 to the block's row; node 0 is the top's scratch
  uint4* row = reinterpret_cast<uint4*>(ws + (size_t)blockIdx.x * 2 * T * W);
  const uint4* h = reinterpret_cast<const uint4*>(inv_heap);
  for (int k = W / 4 + t; k < 2 * T * W / 4; k += T) row[k] = h[k];
}

template <class E>
__global__ void __launch_bounds__(InverseSizes<E>::kTop)
    affine_inverse_top_kernel(uint32_t* ws, int g) {
  constexpr int W = Curve<E>::W, T = InverseSizes<E>::T, TT = InverseSizes<E>::kTop;
  extern __shared__ __align__(16) uint32_t inv_heap[];
  const int t = threadIdx.x;
  const size_t s = 2 * T * W;  // a row: x (node 1) at ws + W, the prefixes (node 0) at ws
  const int cnt = chunk_count(g, t, TT, (g + TT - 1) / TT);
  store_elem(inv_heap + (TT + t) * W, chunk_up<E>(ws + W, ws, s, t, TT, cnt));
  heap_up<E>(inv_heap, TT);
  if (t == 0) store_elem(inv_heap + W, field_inv(load_elem<E>(inv_heap + W)));
  __syncthreads();
  heap_down<E>(inv_heap, TT);
  chunk_down<E>(ws + W, ws, ws + W, s, t, TT, cnt, load_elem<E>(inv_heap + (TT + t) * W));
}

template <class E>
__global__ void __launch_bounds__(InverseSizes<E>::T)
    affine_inverse_down_kernel(const uint32_t* den, uint32_t* out, const uint32_t* ws, int n) {
  constexpr int W = Curve<E>::W, T = InverseSizes<E>::T, C = InverseSizes<E>::C;
  extern __shared__ __align__(16) uint32_t inv_heap[];
  const int t = threadIdx.x;
  const uint4* row = reinterpret_cast<const uint4*>(ws + (size_t)blockIdx.x * 2 * T * W);
  uint4* h = reinterpret_cast<uint4*>(inv_heap);
  for (int k = W / 4 + t; k < 2 * T * W / 4; k += T) h[k] = row[k];
  __syncthreads();
  heap_down<E>(inv_heap, T);
  const size_t e0 = (size_t)blockIdx.x * T * C + t;
  chunk_down<E>(den, out, out, W, e0, T, chunk_count(n, e0, T, C),
                load_elem<E>(inv_heap + (T + t) * W));
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

// K19, one launch: phase 0 up, 1 top, 2 down (the three in this order on
// one stream). ws holds ws_elems elements, at least 2 T G; n >= 1.
template <class E>
int launch_inverse_phase(int phase, const void* den, void* out, void* ws, int ws_elems, int n,
                         cudaStream_t s) {
  using Z = InverseSizes<E>;
  constexpr int W = Curve<E>::W;
  const long long g = (n + (long long)Z::T * Z::C - 1) / ((long long)Z::T * Z::C);
  if (n <= 0 || 2 * Z::T * g > ws_elems) return (int)cudaErrorInvalidValue;
  const int heap = 2 * Z::T * W * 4, top_heap = 2 * Z::kTop * W * 4;
  if (phase == 0) {
    affine_inverse_up_kernel<E><<<(int)g, Z::T, heap, s>>>((const uint32_t*)den, (uint32_t*)out,
                                                          (uint32_t*)ws, n);
  } else if (phase == 1) {
    if (top_heap >= 48 * 1024) {  // BLS12-381 G2: 48 KB, at the default limit
      const cudaError_t e = cudaFuncSetAttribute(
          affine_inverse_top_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, top_heap);
      if (e != cudaSuccess) return (int)e;
    }
    affine_inverse_top_kernel<E><<<1, Z::kTop, top_heap, s>>>((uint32_t*)ws, (int)g);
  } else if (phase == 2) {
    affine_inverse_down_kernel<E><<<(int)g, Z::T, heap, s>>>(
        (const uint32_t*)den, (uint32_t*)out, (const uint32_t*)ws, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class P>
int launch_affine_batch_inverse(int group, int phase, const void* den, void* out, void* ws,
                                int ws_elems, int n, cudaStream_t s) {
  if (group == 1) return launch_inverse_phase<Fp<P>>(phase, den, out, ws, ws_elems, n, s);
  return launch_inverse_phase<Fp2<P>>(phase, den, out, ws, ws_elems, n, s);
}

// The BLS12-381 launchers, defined in affine_bls.cu.
int bls_affine_phase1(int group, const void* rows, int row_bytes, const void* sgn, void* den,
                      void* cls, int pairs, cudaStream_t s);
int bls_affine_phase3(int group, const void* rows, int row_bytes, const void* sgn,
                      const void* dinv, const void* cls, void* out, int pairs, cudaStream_t s);
int bls_affine_tree_mul(int group, int mode, const void* a, const void* b, void* out, int n,
                        cudaStream_t s);
int bls_affine_batch_inverse(int group, int phase, const void* den, void* out, void* ws,
                             int ws_elems, int n, cudaStream_t s);

}  // namespace snark
