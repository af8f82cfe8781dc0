// The backward of flash_attention (included by flash_attention.cu, inside
// its namespace after make_map: Mask, Strides, live_keys, the mbarrier,
// TMA and wgmma helpers are that file's).
//
// The TPU package differentiates its attention with jax.grad; there is no
// Pallas backward.  This is the FlashAttention-2 backward for the
// forward's contract: given q, k, v, the output o, the forward's
// log-sum-exp per row (lse, natural log, +inf on a row with no live key)
// and the output's gradient do, it forms
//   s  = q . k * scale, softcapped (t = tanh(s / cap), s = cap t)
//   P  = exp(s - lse) on the live keys (the forward's mask), else 0
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO o)
//   dS = P (dP - delta) (1 - t^2 with a softcap) scale
//   dQ = dS K,  dK = dS^T Q
// in f32 from f32 or bf16 operands, each gradient written once in its
// operand's type.  Three launches:
//  * bwd_delta_kernel: delta, 8 lanes a query row reading 16 bytes a
//    load where the rows allow it, so a warp reads 4 whole rows;
//  * a dK/dV kernel, one block per (key tile, kv head, batch): its K and
//    V tiles and their dK / dV accumulators stay on the SM while the
//    block walks the G query heads of the group and their query
//    tiles (the ones the mask lets see the tile), so GQA needs no
//    atomics;
//  * a dQ kernel, one block per (query tile, q head, batch), walking
//    the key tiles its rows see.
// Both recompute P from Q, K and lse (and the softcap's tanh).  No
// atomics: the same bits on every run.  P and dS enter their products
// rounded to bf16, as in FlashAttention-2; P, tanh and dS's arithmetic
// stay f32.  The caller names the body (flash_attention.py's bwd_body);
// a body that does not take the operands returns an error, never
// another body:
//  * wgmma (bf16, hd 64, or 120 / 128 in the 128 capacity, q, k, v, dO
//    on 16 bytes: bwd_dkv_wgmma_kernel, bwd_dq_wgmma_kernel): two
//    consumer warpgroups of 64 rows and a producer warp that TMA-loads
//    the block's resident tiles once (K and V of 128 keys; Q and dO of
//    128 queries) and streams the other two operands in 64-row tiles
//    through a 4-stage ring (a full and an empty mbarrier a stage; the
//    dK/dV kernel's producer lanes also stage each tile's lse and
//    delta); see Hop for the registers.  Each product is one wgmma
//    chain of the forward's layouts: S^T = K Q^T and dP^T = V dO^T (ss,
//    both K-major), then dV += P^T dO and dK += dS^T Q (rs: P^T, dS^T
//    in registers, dO, Q read MN-major); the dQ kernel S = Q K^T, dP =
//    dO V^T, dQ += dS K.  P, tanh and dS live in registers only; dK, dV
//    (dQ) accumulate in registers and are written once.  Each kind of
//    tile compiles on its own (p_ds, by_tile): tiles every pair of which
//    is live run with no per-score test and no tanh; only edge tiles
//    (diagonal, window, kv_valid, ragged Lq / Lk) test each score.
//  * mma (bf16 otherwise: hd 32 and 288, rows off 16 bytes;
//    bwd_dkv_kernel, bwd_dq_kernel): the tiles bf16 in shared memory,
//    every product mma.sync m16n8k16 from plain loads, P and dS through
//    shared memory, dK, dV, dQ accumulated in registers;
//  * f32 (the same two kernels): every product a block_mm on CUDA cores,
//    the tiles f32 in shared memory.
//
// What bounds it on an H100: operations.  Per live (query, key) pair and
// head the backward needs 5 hd multiply-adds (Q K^T, dV, dP, dQ, dK; 10
// hd FLOP); at llama3.2-1b's training shape (B=8, L=1024, 32 heads of 64,
// causal) that is 86 GFLOP a layer, 0.087 ms at the bf16 tensor-core
// rate, against 50 MB of operands.  Every body does 7 (the dQ kernel
// recomputes Q K^T and dO V^T, 14 hd FLOP a pair): a deterministic dQ
// without atomics costs that.  The wgmma body keeps the tensor cores fed
// from TMA rings (no load waits in the loop, no shared-memory round
// trips of P and dS); between its products a warpgroup runs the
// elementwise work of its 64 x 64 tile (a few instructions a score on a
// full tile), which the SM's other warpgroup overlaps with its own
// products.  At llama's shape it takes about 4.7x the bound.
#pragma once

#include "block_mm.cuh"

namespace fa_bwd {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;        // an H100 block's opt-in limit

// Tile rows (keys and queries), the head dim a product sums over (kd:
// hd, or for bf16 hd rounded up to 16 with zero columns) and the
// shared-memory pitches: ld of the f32 accumulators (hd + 1), lo of
// the operand tiles (Q, K, V, dO in the operands' type), ls of the f32
// P and tanh tiles, lp of the P / dS operand.  f32 operand pitches are
// odd (a column read across rows never hits one bank twice); bf16 ones
// are a multiple of 8 elements plus 8, so the mma fragments' 32-bit
// loads (rows g, words t) fall in 32 different banks.
struct Tiles {
  int bk, bq, kd, ld, lo, ls, lp;
};

template <typename T>
__host__ __device__ inline Tiles tiles(int hd) {
  const int t = hd > 128 ? 32 : 64;
  if (std::is_same<T, float>::value)
    return Tiles{t, t, hd, hd + 1, hd + 1, t + 1, t + 1};
  const int kd = (hd + 15) / 16 * 16;
  return Tiles{t, t, kd, hd + 1, kd + 8, t + 1, t + 8};
}

// floats of f32 tiles at the head of shared memory, rounded up to 4 so
// the operand tiles after them start on 16 bytes
__host__ __device__ inline int f32_head(int floats) {
  return (floats + 3) & ~3;
}

// bytes of shared memory of bwd_dkv_kernel: f32 P, tanh, lse and delta
// of the query rows (f32 operands: also dK and dV); the operand K, V,
// Q, dO tiles and the P / dS operand (f32 operands: P itself)
template <typename T>
__host__ __device__ inline int smem_dkv(int hd) {
  const Tiles t = tiles<T>(hd);
  const bool f32 = std::is_same<T, float>::value;
  const int head = f32_head(2 * t.bq * t.ls + 2 * t.bq +
                            (f32 ? 2 * t.bk * t.ld : 0));
  return 4 * head + (int)sizeof(T) * (2 * t.bk * t.lo + 2 * t.bq * t.lo +
                                      (f32 ? 0 : t.bq * t.lp));
}

// of bwd_dq_kernel: f32 P, tanh, lse, delta (f32 operands: dQ); the
// operand Q, dO, K, V tiles and dS
template <typename T>
__host__ __device__ inline int smem_dq(int hd) {
  const Tiles t = tiles<T>(hd);
  const bool f32 = std::is_same<T, float>::value;
  const int head = f32_head(2 * t.bq * t.ls + 2 * t.bq +
                            (f32 ? t.bq * t.ld : 0));
  return 4 * head + (int)sizeof(T) * (2 * t.bq * t.lo + 2 * t.bk * t.lo +
                                      (f32 ? 0 : t.bq * t.lp));
}

// two bf16 elements, p[0] and p[step], as one register (p[0] low): one
// 32-bit load where they are neighbours
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p,
                                            int step) {
  if (step == 1) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + step);
  return lo | (hi << 16);
}

// The tensor-core products: C = A B with bf16 A (M x K) and B (K x N) in
// shared memory, A's element (i, k) at a[i a_i + k a_k] and B's (k, j) at
// b[k b_k + j b_j] (block_mm's strides).  C is cut into strips of 16
// rows by 8 NT columns; warp w takes the strips w, w + warps, ...: for
// every 16-wide step of k it loads the strip's A fragment once and runs
// mma16816 against its NT 8-column B fragments, f32 accumulators.  M a
// multiple of 16, N of 8, K of 16 (the caller zero-pads); 32-bit loads
// need an even pitch where a stride is 1.  The sum over k runs in order:
// the same bits on every run.  The caller synchronises the block around
// each call.
template <int NT>
struct Strips {
  int sn, n;        // strips across N, in all
  __device__ __forceinline__ Strips(int M, int N)
      : sn((N + 8 * NT - 1) / (8 * NT)), n(M / 16 * sn) {}
  __device__ __forceinline__ int i0(int w) const { return w / sn * 16; }
  __device__ __forceinline__ int j0(int w) const { return w % sn * 8 * NT; }
};

// acc += the strip at (i0, j0), its first nt 8-column blocks
template <int NT>
__device__ __forceinline__ void strip_mma(int i0, int j0, int nt, int K,
                                          const __nv_bfloat16* a, int a_i,
                                          int a_k, const __nv_bfloat16* b,
                                          int b_k, int b_j,
                                          float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
  const __nv_bfloat16* ar0 = a + (i0 + g) * a_i + t2 * a_k;
  const __nv_bfloat16* ar1 = ar0 + 8 * a_i;
  const __nv_bfloat16* bc = b + t2 * b_k + (j0 + g) * b_j;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    af[0] = ld_pair(ar0 + k0 * a_k, a_k);
    af[1] = ld_pair(ar1 + k0 * a_k, a_k);
    af[2] = ld_pair(ar0 + (k0 + 8) * a_k, a_k);
    af[3] = ld_pair(ar1 + (k0 + 8) * a_k, a_k);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c < nt) {
        const __nv_bfloat16* bp = bc + k0 * b_k + 8 * c * b_j;
        mma16816(acc[c], af, ld_pair(bp, b_k), ld_pair(bp + 8 * b_k, b_k));
      }
    }
  }
}

// each accumulator of the strip at (i0, j0) to fn(i, j, value)
template <int NT, typename Fn>
__device__ __forceinline__ void strip_each(int i0, int j0, int nt,
                                           const float (&acc)[NT][4],
                                           Fn fn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    if (c < nt) {
      const int j = j0 + 8 * c + t2;
      fn(i0 + g, j, acc[c][0]);
      fn(i0 + g, j + 1, acc[c][1]);
      fn(i0 + g + 8, j, acc[c][2]);
      fn(i0 + g + 8, j + 1, acc[c][3]);
    }
  }
}

// block_mm's contract on tensor cores: each C element to epi(i, j,
// value) once, from one thread
template <int NT, typename Epi>
__device__ __forceinline__ void block_mma(int M, int N, int K,
                                          const __nv_bfloat16* a, int a_i,
                                          int a_k, const __nv_bfloat16* b,
                                          int b_k, int b_j, Epi epi) {
  const Strips<NT> st(M, N);
  for (int w = threadIdx.x >> 5; w < st.n; w += blockDim.x >> 5) {
    const int i0 = st.i0(w), j0 = st.j0(w), nt = min(NT, (N - j0) / 8);
    float acc[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
    strip_mma<NT>(i0, j0, nt, K, a, a_i, a_k, b, b_k, b_j, acc);
    strip_each<NT>(i0, j0, nt, acc, epi);
  }
}

// C += A B into registers a warp keeps across calls of the same M and
// N: acc[s] is its strip w + s warps (NT = 4; S bounds the strips a
// warp takes)
template <int S>
__device__ __forceinline__ void block_mma_acc(int M, int N, int K,
                                              const __nv_bfloat16* a,
                                              int a_i, int a_k,
                                              const __nv_bfloat16* b,
                                              int b_k, int b_j,
                                              float (&acc)[S][4][4]) {
  const Strips<4> st(M, N);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int w = (threadIdx.x >> 5) + s * (blockDim.x >> 5);
    if (w < st.n) {
      const int j0 = st.j0(w);
      strip_mma<4>(st.i0(w), j0, min(4, (N - j0) / 8), K, a, a_i, a_k, b,
                   b_k, b_j, acc[s]);
    }
  }
}

template <int S, typename Fn>
__device__ __forceinline__ void acc_each(int M, int N,
                                         const float (&acc)[S][4][4],
                                         Fn fn) {
  const Strips<4> st(M, N);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int w = (threadIdx.x >> 5) + s * (blockDim.x >> 5);
    if (w < st.n) {
      const int j0 = st.j0(w);
      strip_each<4>(st.i0(w), j0, min(4, (N - j0) / 8), acc[s], fn);
    }
  }
}

// strips a warp takes in block_mma_acc of a (rows x hd) product
__host__ __device__ inline int acc_strips(int rows, int hd) {
  return (rows / 16 * ((hd + 31) / 32) + THREADS / 32 - 1) / (THREADS / 32);
}

// one product of the backward into an epilogue: block_mm on f32 tiles;
// on bf16 ones block_mma with strips of 32 columns, or of 8 where wider
// strips would leave warps idle
template <typename Epi>
__device__ __forceinline__ void tile_mm(int M, int N, int K, const float* a,
                                        int a_i, int a_k, const float* b,
                                        int b_k, int b_j, Epi epi) {
  block_mm<4, 4>(M, N, K, a, a_i, a_k, b, b_k, b_j, epi);
}

template <typename Epi>
__device__ __forceinline__ void tile_mm(int M, int N, int K,
                                        const __nv_bfloat16* a, int a_i,
                                        int a_k, const __nv_bfloat16* b,
                                        int b_k, int b_j, Epi epi) {
  if (Strips<4>(M, N).n >= (int)(blockDim.x >> 5))
    block_mma<4>(M, N, K, a, a_i, a_k, b, b_k, b_j, epi);
  else
    block_mma<1>(M, N, K, a, a_i, a_k, b, b_k, b_j, epi);
}

// rows row0 .. row0 + rows - 1 of a (positions, hd) operand into a tile
// of its type and pitch ld, columns 0 .. width - 1; rows at or past n
// and columns at or past hd are zeros.  bf16 rows on 16 bytes move 16
// bytes a load (hd, width and ld multiples of 8, dst on 16 bytes).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long sl, int row0, int n,
                                          int rows, int hd, int width) {
  if constexpr (!std::is_same<T, float>::value) {
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (sl & 7) == 0) {
      const int cw = width / 8;
      for (int e = threadIdx.x; e < rows * cw; e += blockDim.x) {
        const int r = e / cw, c = (e - r * cw) * 8;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n && c < hd)
          x = *reinterpret_cast<const uint4*>(src + (row0 + r) * sl + c);
        *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width, c = e - r * width;
    const bool in = row0 + r < n && c < hd;
    dst[r * ld + c] = in ? src[(long long)(row0 + r) * sl + c] : T(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long sl,
                                           const float* src, int ld,
                                           int row0, int n, int rows,
                                           int hd) {
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int r = e / hd, c = e - r * hd;
    if (row0 + r < n)
      st_f32(dst + (long long)(row0 + r) * sl + c, src[r * ld + c]);
  }
}

// P and the softcap's tanh of one (query, key) pair from its dot product
__device__ __forceinline__ void prob(float dot, int iq, int ik, int live,
                                     const Mask& mk, float scale,
                                     float softcap, float lse, float* p,
                                     float* th) {
  if (!mk.ok(iq, ik, live)) {
    *p = 0.f;
    *th = 0.f;
    return;
  }
  float s = dot * scale, t = 0.f;
  if (softcap != 0.f) {
    t = tanhf(s / softcap);
    s = softcap * t;
  }
  *p = expf(s - lse);
  *th = t;
}

// dS of the raw dot product q . k
__device__ __forceinline__ float dscore(float p, float th, float dp,
                                        float delta, float scale,
                                        float softcap) {
  const float d = p * (dp - delta);
  return (softcap != 0.f ? d * (1.f - th * th) : d) * scale;
}

// the query rows' lse and delta (rows past lq: +inf and 0, so P = 0)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s,
                                               const float* lse,
                                               const float* delta,
                                               long long bh, int q0, int lq,
                                               int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool in = q0 + r < lq;
    lse_s[r] = in ? lse[bh * lq + q0 + r] : INFINITY;
    del_s[r] = in ? delta[bh * lq + q0 + r] : 0.f;
  }
}

// delta = rowsum(dO o) of each query row: 8 lanes a row, so a warp
// reads 4 rows at once; with `vec` (every row on 16 bytes) each lane
// loads 16 bytes of o and of dO a step.  The 8 partial sums meet by xor
// shuffles: a fixed order, the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Strides os, Strides dos, int lq,
                 int hd, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int sub = threadIdx.x & 7;
  const int iq = blockIdx.x * (THREADS / 8) + (threadIdx.x >> 3);
  const int h = blockIdx.y, b = blockIdx.z;
  float s = 0.f;
  if (iq < lq) {
    const T* orow = o + b * os.b + h * os.h + (long long)iq * os.l;
    const T* drow = dout + b * dos.b + h * dos.h + (long long)iq * dos.l;
    if (vec) {
      for (int c = sub * V; c < hd; c += 8 * V) {
        float x[V], y[V];
        unpack16(orow + c, x);
        unpack16(drow + c, y);
#pragma unroll
        for (int e = 0; e < V; ++e) s = fmaf(y[e], x[e], s);
      }
    } else {
      for (int c = sub; c < hd; c += 8)
        s = fmaf(ld_f32(drow[c]), ld_f32(orow[c]), s);
    }
  }
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (iq < lq && sub == 0)
    delta[((long long)b * gridDim.y + h) * lq + iq] = s;
}

// blocks an SM the bf16 kernels ask registers for: two, unless a warp
// keeps more than `most` strips of accumulators (dK and dV at hd 288)
template <typename T, int S, int most>
constexpr int min_blocks() {
  return std::is_same<T, float>::value || S > most ? 1 : 2;
}

// dK and dV of one key tile.  f32 operands: block_mm products and the
// accumulators in shared memory; bf16: block_mma products and the
// accumulators in registers, S strips a warp (acc_strips).
template <typename T, int S>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, S, 2>()))
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kv_valid, T* __restrict__ dk,
               T* __restrict__ dv, int G, Mask mk, Strides qs, Strides ks,
               Strides vs, Strides dos, Strides dks, Strides dvs, float scale,
               float softcap, int hd) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float sm[];
  const Tiles tl = tiles<T>(hd);
  const int BK = tl.bk, BQ = tl.bq, KD = tl.kd, LD = tl.ld, LO = tl.lo,
            LS = tl.ls, LP = tl.lp;
  float* Ps = sm;
  float* Ts = Ps + BQ * LS;
  float* lse_s = Ts + BQ * LS;
  float* del_s = lse_s + BQ;
  float* dKs = del_s + BQ;                 // f32 operands only
  float* dVs = dKs + BK * LD;
  T* Ks = reinterpret_cast<T*>(
      sm + f32_head(2 * BQ * LS + 2 * BQ + (F32 ? 2 * BK * LD : 0)));
  T* Vs = Ks + BK * LO;
  T* Qs = Vs + BK * LO;
  T* dOs = Qs + BQ * LO;
  // the P / dS operand: f32 operands use P's own tile
  T* Pb = F32 ? reinterpret_cast<T*>(Ps) : dOs + BQ * LO;
  float dk_acc[S][4][4], dv_acc[S][4][4];

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int Hq = G * gridDim.y;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  const int k1 = min(k0 + BK, live);    // the tile's keys a query may see
  if constexpr (F32) {
    for (int e = threadIdx.x; e < BK * LD; e += blockDim.x) {
      dKs[e] = 0.f;
      dVs[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[s][c][e] = dv_acc[s][c][e] = 0.f;
  }
  load_rows(Ks, LO, k + b * ks.b + kh * ks.h, ks.l, k0, mk.lk, BK, hd, KD);
  load_rows(Vs, LO, v + b * vs.b + kh * vs.h, vs.l, k0, mk.lk, BK, hd, KD);
  // query rows that see some key of the tile
  int qlo = 0, qhi = k1 > k0 ? mk.lq : 0;
  if (mk.causal && qhi > 0) {
    qlo = max(0, k0 - off);
    if (mk.window) qhi = min(qhi, k1 - 1 + mk.window - off);
  }
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long bh = (long long)b * Hq + h;
    for (int q0 = qlo; q0 < qhi; q0 += BQ) {
      __syncthreads();
      load_rows(Qs, LO, q + b * qs.b + h * qs.h, qs.l, q0, mk.lq, BQ, hd,
                KD);
      load_rows(dOs, LO, dout + b * dos.b + h * dos.h, dos.l, q0, mk.lq, BQ,
                hd, KD);
      load_row_stats(lse_s, del_s, lse, delta, bh, q0, mk.lq, BQ);
      __syncthreads();
      tile_mm(BQ, BK, KD, Qs, LO, 1, Ks, 1, LO, [&](int i, int j, float d) {
        prob(d, q0 + i, k0 + j, live, mk, scale, softcap, lse_s[i],
             Ps + i * LS + j, Ts + i * LS + j);
        if constexpr (!F32) st_f32(Pb + i * LP + j, Ps[i * LS + j]);
      });
      __syncthreads();
      if constexpr (F32)
        block_mm<4, 4>(BK, hd, BQ, Pb, 1, LP, dOs, LO, 1,
                       [&](int j, int d, float x) { dVs[j * LD + d] += x; });
      else
        block_mma_acc<S>(BK, hd, BQ, Pb, 1, LP, dOs, LO, 1, dv_acc);
      __syncthreads();
      tile_mm(BQ, BK, KD, dOs, LO, 1, Vs, 1, LO, [&](int i, int j, float dp) {
        st_f32(Pb + i * LP + j, dscore(Ps[i * LS + j], Ts[i * LS + j], dp,
                                       del_s[i], scale, softcap));
      });
      __syncthreads();
      if constexpr (F32)
        block_mm<4, 4>(BK, hd, BQ, Pb, 1, LP, Qs, LO, 1,
                       [&](int j, int d, float x) { dKs[j * LD + d] += x; });
      else
        block_mma_acc<S>(BK, hd, BQ, Pb, 1, LP, Qs, LO, 1, dk_acc);
    }
  }
  T* dkp = dk + b * dks.b + kh * dks.h;
  T* dvp = dv + b * dvs.b + kh * dvs.h;
  if constexpr (F32) {
    __syncthreads();
    store_rows(dkp, dks.l, dKs, LD, k0, mk.lk, BK, hd);
    store_rows(dvp, dvs.l, dVs, LD, k0, mk.lk, BK, hd);
  } else {
    acc_each<S>(BK, hd, dk_acc, [&](int j, int d, float x) {
      if (k0 + j < mk.lk) st_f32(dkp + (long long)(k0 + j) * dks.l + d, x);
    });
    acc_each<S>(BK, hd, dv_acc, [&](int j, int d, float x) {
      if (k0 + j < mk.lk) st_f32(dvp + (long long)(k0 + j) * dvs.l + d, x);
    });
  }
}

// dQ of one query tile, the same two forms as bwd_dkv_kernel.  Causal
// tiles near the end see the most keys, so the grid takes them first.
template <typename T, int S>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, S, 3>()))
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_valid, T* __restrict__ dq, int G,
              Mask mk, Strides qs, Strides ks, Strides vs, Strides dos,
              Strides dqs, float scale, float softcap, int hd) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float sm[];
  const Tiles tl = tiles<T>(hd);
  const int BK = tl.bk, BQ = tl.bq, KD = tl.kd, LD = tl.ld, LO = tl.lo,
            LS = tl.ls, LP = tl.lp;
  float* Ps = sm;
  float* Ts = Ps + BQ * LS;
  float* lse_s = Ts + BQ * LS;
  float* del_s = lse_s + BQ;
  float* dQs = del_s + BQ;                 // f32 operands only
  T* Qs = reinterpret_cast<T*>(
      sm + f32_head(2 * BQ * LS + 2 * BQ + (F32 ? BQ * LD : 0)));
  T* dOs = Qs + BQ * LO;
  T* Ks = dOs + BQ * LO;
  T* Vs = Ks + BK * LO;
  T* Pb = F32 ? reinterpret_cast<T*>(Ps) : Vs + BK * LO;
  float dq_acc[S][4][4];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y,
            b = blockIdx.z;
  const int kh = h / G;
  const long long bh = (long long)b * gridDim.y + h;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  if constexpr (F32) {
    for (int e = threadIdx.x; e < BQ * LD; e += blockDim.x) dQs[e] = 0.f;
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[s][c][e] = 0.f;
  }
  load_rows(Qs, LO, q + b * qs.b + h * qs.h, qs.l, q0, mk.lq, BQ, hd, KD);
  load_rows(dOs, LO, dout + b * dos.b + h * dos.h, dos.l, q0, mk.lq, BQ, hd,
            KD);
  load_row_stats(lse_s, del_s, lse, delta, bh, q0, mk.lq, BQ);
  // keys some row of the tile sees
  int kbeg = 0, kend = live;
  if (mk.causal) {
    kend = min(kend, min(q0 + BQ, mk.lq) + off);
    if (mk.window) kbeg = max(0, q0 + off - mk.window + 1);
  }
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();
    load_rows(Ks, LO, k + b * ks.b + kh * ks.h, ks.l, k0, mk.lk, BK, hd, KD);
    load_rows(Vs, LO, v + b * vs.b + kh * vs.h, vs.l, k0, mk.lk, BK, hd, KD);
    __syncthreads();
    tile_mm(BQ, BK, KD, Qs, LO, 1, Ks, 1, LO, [&](int i, int j, float d) {
      prob(d, q0 + i, k0 + j, live, mk, scale, softcap, lse_s[i],
           Ps + i * LS + j, Ts + i * LS + j);
    });
    __syncthreads();
    tile_mm(BQ, BK, KD, dOs, LO, 1, Vs, 1, LO, [&](int i, int j, float dp) {
      st_f32(Pb + i * LP + j, dscore(Ps[i * LS + j], Ts[i * LS + j], dp,
                                     del_s[i], scale, softcap));
    });
    __syncthreads();
    if constexpr (F32)
      block_mm<4, 4>(BQ, hd, BK, Pb, LP, 1, Ks, LO, 1,
                     [&](int i, int d, float x) { dQs[i * LD + d] += x; });
    else
      block_mma_acc<S>(BQ, hd, BK, Pb, LP, 1, Ks, LO, 1, dq_acc);
  }
  T* dqp = dq + b * dqs.b + h * dqs.h;
  if constexpr (F32) {
    __syncthreads();
    store_rows(dqp, dqs.l, dQs, LD, q0, mk.lq, BQ, hd);
  } else {
    acc_each<S>(BQ, hd, dq_acc, [&](int i, int d, float x) {
      if (q0 + i < mk.lq) st_f32(dqp + (long long)(q0 + i) * dqs.l + d, x);
    });
  }
}

// ---------------------------------------------------------------------
// bf16 at hd 64 and 128 (120 in 128) on Hopper: TMA rings and wgmma
// ---------------------------------------------------------------------

// Resident tiles hold BR = 2 x 64 rows (one 64-row slice a consumer
// warpgroup), streamed tiles BT = 64 rows; every tile is stored as the
// forward's are, [128-byte column block][row][64 columns], swizzled.
// Three warpgroups: two consumers and the producer's (one warp of it
// loads).  A block alone on its SM: the ring is 4 stages deep, so three
// tiles are in flight while the consumers compute (a step takes less
// than a load's latency), and setmaxnreg moves the producer
// warpgroup's registers to the consumers (40 and 232 a thread; dK, dV,
// S^T and dP^T alone take 192 at hd 128).  The shared memory asked for
// is at least 120 KB, so no second block shares the SM and its
// register budget.
template <int HD>
struct Hop {
  static constexpr int NB = HD / 64;               // column blocks
  static constexpr int BR = 128;                   // resident rows
  static constexpr int BT = 64;                    // streamed rows
  static constexpr int STAGES = 4;
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int R_BYTES = BR * HD * 2;      // one resident operand
  static constexpr int T_BYTES = BT * HD * 2;      // one streamed tile
  static constexpr int USED = 1024 + 2 * R_BYTES + 2 * STAGES * T_BYTES +
                              2 * STAGES * BT * 4 + 8 * (1 + 2 * STAGES);
  static constexpr int SMEM = USED > 120 * 1024 ? USED : 120 * 1024;
};

// whether some / every (query, key) pair of the 64 queries from q0 and
// the nk keys from k0 is live (keys at or past `live` are not)
__device__ __forceinline__ void pair_block(const Mask& mk, int live, int q0,
                                           int k0, bool& some, bool& every,
                                           int nk = 64) {
  const int off = mk.lk - mk.lq;
  some = q0 < mk.lq && k0 < live;
  every = q0 + 64 <= mk.lq && k0 + nk <= live;
  if (mk.causal) {
    some = some && k0 <= min(q0 + 63, mk.lq - 1) + off;
    every = every && k0 + nk - 1 <= q0 + off;
    if (mk.window) {
      some = some && min(k0 + nk - 1, live - 1) > q0 + off - mk.window;
      every = every && k0 > q0 + 63 + off - mk.window;
    }
  }
}

// Four of one thread's elements of a 64 x 64 accumulator pair (x: the raw
// q . k of the scores, dp: dP), those of its 8-column block c, turned
// into P and dS and packed into the A fragments of the products that
// take them (lse2 already times log2(e)).  MASK: an edge tile, whose
// scores are tested through ok(e) (e: the element's index in the
// block); CAP: a softcap.  Each combination compiles on its own, so a
// full tile without a softcap runs no test and no tanh.
template <bool MASK, bool CAP, typename Ok>
__device__ __forceinline__ void p_ds(const float (&x)[32],
                                     const float (&dp)[32], int c,
                                     const float (&lse2)[4],
                                     const float (&del)[4], float scale,
                                     float softcap, Ok ok,
                                     uint32_t (&pa)[4][4],
                                     uint32_t (&da)[4][4]) {
  float p[4], d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float t = 0.f, pe;
    if constexpr (CAP) {
      t = tanhf(x[4 * c + e] * scale / softcap);
      pe = ex2(fmaf(softcap * t, LOG2E, -lse2[e]));
    } else {
      pe = ex2(fmaf(x[4 * c + e], scale * LOG2E, -lse2[e]));
    }
    if constexpr (MASK) {
      if (!ok(e)) pe = 0.f;
    }
    float ds = pe * (dp[4 * c + e] - del[e]);
    if constexpr (CAP) ds *= 1.f - t * t;
    p[e] = pe;
    d[e] = ds * scale;
  }
  // the accumulator's layout is the A fragment's (see wg_consume)
  pa[c / 2][(c & 1) * 2] = pack_bf16(p[0], p[1]);
  pa[c / 2][(c & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  da[c / 2][(c & 1) * 2] = pack_bf16(d[0], d[1]);
  da[c / 2][(c & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
}

// fn(MASK, CAP) with the flags as compile-time constants, each
// combination a tile can need: a softcap always tests its scores (its
// tiles are rare), full tiles without one never do
template <typename Fn>
__device__ __forceinline__ void by_tile(bool every, float softcap, Fn fn) {
  if (softcap != 0.f)
    fn(std::true_type(), std::true_type());
  else if (every)
    fn(std::false_type(), std::false_type());
  else
    fn(std::true_type(), std::false_type());
}

// D (64 x 64) = A B^T over the head dim for one warpgroup: A's 64 rows
// at `a` (column blocks `la` bytes apart), B's 64 rows at `b` (`lb`
// apart)
template <int HD>
__device__ __forceinline__ void wg_abt(float (&d)[32], const uint8_t* a,
                                       int la, const uint8_t* b, int lb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(d, sw128_desc(a + (kk / 4) * la + (kk % 4) * 32, 16, 1024),
                 sw128_desc(b + (kk / 4) * lb + (kk % 4) * 32, 16, 1024),
                 kk > 0);
}

// d (64 x HD) += A (64 x 64, fragments a) B (64 streamed rows x HD, read
// MN-major)
template <int HD>
__device__ __forceinline__ void wg_ab(float (&d)[HD / 2],
                                      const uint32_t (&a)[4][4],
                                      const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(d, a[kk], sw128_desc(b + kk * 16 * 128, 64 * 128, 1024));
}

// one thread's rows (r, r + 8) of a 64 x HD accumulator to bf16 rows
// of `out` (row pitch sl), rows at or past n and columns at or past hd
// left out
template <int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2],
                                          __nv_bfloat16* out, long long sl,
                                          int r, int n, int hd) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int d = 8 * c + 2 * t4;
    if (d >= hd) break;                   // TMA's zero columns (120)
    if (r < n)
      *reinterpret_cast<uint32_t*>(out + r * sl + d) =
          pack_bf16(acc[4 * c], acc[4 * c + 1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (r + 8) * sl + d) =
          pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// dK and dV of 128 keys: K, V resident; the group's query tiles (Q, dO,
// their lse and delta) through the ring.  Grid (Hkv, B, key tiles): the
// causal key tiles that see the most queries come first.
template <int HD>
__global__ void __launch_bounds__(Hop<HD>::THREADS, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, TmaAxes qa,
                     TmaAxes ka, TmaAxes va, TmaAxes doa,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_valid,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int G, Mask mk,
                     Strides dks, Strides dvs, float scale, float softcap,
                     int hd) {
  using C = Hop<HD>;
  constexpr int BR = C::BR, BT = C::BT, S = C::STAGES;
  if constexpr (!PAD<HD>) hd = HD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + C::R_BYTES;
  uint8_t* qs = vs + C::R_BYTES;                  // [stage] Q tiles
  uint8_t* dos = qs + S * C::T_BYTES;             // [stage] dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + S * C::T_BYTES);
  float* del_s = lse_s + S * BT;                  // [stage][BT] each
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(del_s + S * BT);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BR;
  const int Hq = G * gridDim.x;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  const int k1 = min(k0 + BR, live);    // the tile's keys a query may see
  // query rows that see some key of the tile
  int qlo = 0, qhi = k1 > k0 ? mk.lq : 0;
  if (mk.causal && qhi > 0) {
    qlo = max(0, k0 - off);
    if (mk.window) qhi = min(qhi, k1 - 1 + mk.window - off);
  }
  const int nqt = qhi > qlo ? (qhi - qlo + BT - 1) / BT : 0;
  const int steps = G * nqt;            // (head, query tile) in that order

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 32);            // the producer warp's lanes
      mbar_init(empty + i, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                        // producer: warp 8 loads
    reg_dealloc<C::PRODUCER_REGS>();
    if (warp > 8 || steps == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * C::R_BYTES);
      for (int j = 0; j < C::NB; ++j)
        for (int r = 0; r < BR; r += 64) {
          tma_load(ks + (j * BR + r) * 128, &tk, kvbar, ka, 64 * j, k0 + r,
                   kh, b);
          tma_load(vs + (j * BR + r) * 128, &tv, kvbar, va, 64 * j, k0 + r,
                   kh, b);
        }
    }
    for (int i = 0; i < steps; ++i) {
      const int st = i % S;
      if (i >= S) mbar_wait(empty + st, (i / S - 1) & 1);
      const int h = kh * G + i / nqt, q0 = qlo + (i % nqt) * BT;
      const long long row = ((long long)b * Hq + h) * mk.lq;
      // rows past Lq: lse +inf, so P = 0
      for (int r = lane; r < BT; r += 32) {
        const bool in = q0 + r < mk.lq;
        lse_s[st * BT + r] = in ? lse[row + q0 + r] * LOG2E : CUDART_INF_F;
        del_s[st * BT + r] = in ? delta[row + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + st, 2 * C::T_BYTES);
        for (int j = 0; j < C::NB; ++j) {
          tma_load(qs + st * C::T_BYTES + j * BT * 128, &tq, full + st, qa,
                   64 * j, q0, h, b);
          tma_load(dos + st * C::T_BYTES + j * BT * 128, &tdo, full + st,
                   doa, 64 * j, q0, h, b);
        }
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg holds keys kw .. kw + 63
  reg_alloc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const int kw = k0 + 64 * wg;
  const int rA = kw + 16 * wl + g8;       // this thread's keys: rA, rA + 8
  const uint8_t* kws = ks + wg * 64 * 128;
  const uint8_t* vws = vs + wg * 64 * 128;
  // the queries [qlo_k, qhi_k) that see each of this thread's keys
  int qlo_k[2], qhi_k[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = rA + 8 * j;
    qlo_k[j] = mk.causal ? key - off : 0;
    qhi_k[j] = key >= live ? 0
               : mk.causal && mk.window ? min(mk.lq, key - off + mk.window)
                                        : mk.lq;
  }
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  if (steps > 0) mbar_wait(kvbar, 0);
  for (int i = 0; i < steps; ++i) {
    const int st = i % S, q0 = qlo + (i % nqt) * BT;
    mbar_wait(full + st, (i / S) & 1);
    bool some, every;
    pair_block(mk, live, q0, kw, some, every);
    if (some) {
      const uint8_t* qt = qs + st * C::T_BYTES;
      const uint8_t* dt = dos + st * C::T_BYTES;
      float sc[32], dp[32];
      wg_fence();
      wg_abt<HD>(sc, kws, BR * 128, qt, BT * 128);    // S^T = K Q^T
      wg_abt<HD>(dp, vws, BR * 128, dt, BT * 128);    // dP^T = V dO^T
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      reg_fence(dp);
      uint32_t pa[4][4], da[4][4];
      by_tile(every, softcap, [&](auto mask, auto cap) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int qc = 8 * c + 2 * t4;  // queries q0 + qc, + 1
          const float2 l2 = *reinterpret_cast<const float2*>(
              lse_s + st * BT + qc);
          const float2 de = *reinterpret_cast<const float2*>(
              del_s + st * BT + qc);
          const float lse2[4] = {l2.x, l2.y, l2.x, l2.y};
          const float del[4] = {de.x, de.y, de.x, de.y};
          p_ds<decltype(mask)::value, decltype(cap)::value>(
              sc, dp, c, lse2, del, scale, softcap,
              [&](int e) {
                const int iq = q0 + qc + (e & 1);
                return iq >= qlo_k[e >> 1] && iq < qhi_k[e >> 1];
              },
              pa, da);
        }
      });
      wg_fence();
      wg_ab<HD>(dva, pa, dt);         // dV += P^T dO
      wg_ab<HD>(dka, da, qt);         // dK += dS^T Q
      wg_commit();
      wg_wait0();
      reg_fence(dva);
      reg_fence(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  store_acc<HD>(dka, dk + b * dks.b + kh * dks.h, dks.l, rA, mk.lk, hd);
  store_acc<HD>(dva, dv + b * dvs.b + kh * dvs.h, dvs.l, rA, mk.lk, hd);
}

// dQ of 128 query rows: Q, dO (and each row's lse, delta in registers)
// resident; the key tiles the rows see through the ring.  Grid (Hq, B,
// query tiles), the query-tile index reversed: causal tiles near the end
// see the most keys and start first.
template <int HD>
__global__ void __launch_bounds__(Hop<HD>::THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, TmaAxes qa,
                    TmaAxes ka, TmaAxes va, TmaAxes doa,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_valid,
                    __nv_bfloat16* __restrict__ dq, int G, Mask mk,
                    Strides dqs, float scale, float softcap, int hd) {
  using C = Hop<HD>;
  constexpr int BR = C::BR, BT = C::BT, S = C::STAGES;
  if constexpr (!PAD<HD>) hd = HD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + C::R_BYTES;
  uint8_t* ks = dos + C::R_BYTES;                 // [stage] K tiles
  uint8_t* vs = ks + S * C::T_BYTES;              // [stage] V tiles
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + S * C::T_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BR, kh = h / G;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  // keys some row of the block sees
  int kbeg = 0, kend = live;
  if (mk.causal) {
    kend = min(kend, min(q0 + BR, mk.lq) + off);
    if (mk.window) kbeg = max(0, q0 + off - mk.window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BT - 1) / BT : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                        // producer: warp 8 loads
    reg_dealloc<C::PRODUCER_REGS>();
    if (warp == 8 && lane == 0 && ntiles > 0) {
      mbar_expect_tx(qbar, 2 * C::R_BYTES);
      for (int j = 0; j < C::NB; ++j)
        for (int r = 0; r < BR; r += 64) {
          tma_load(qs + (j * BR + r) * 128, &tq, qbar, qa, 64 * j, q0 + r,
                   h, b);
          tma_load(dos + (j * BR + r) * 128, &tdo, qbar, doa, 64 * j,
                   q0 + r, h, b);
        }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % S, k0 = kbeg + i * BT;
        if (i >= S) mbar_wait(empty + st, (i / S - 1) & 1);
        mbar_expect_tx(full + st, 2 * C::T_BYTES);
        for (int j = 0; j < C::NB; ++j) {
          tma_load(ks + st * C::T_BYTES + j * BT * 128, &tk, full + st, ka,
                   64 * j, k0, kh, b);
          tma_load(vs + st * C::T_BYTES + j * BT * 128, &tv, full + st, va,
                   64 * j, k0, kh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows rlo .. rlo + 63
  reg_alloc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const int rlo = q0 + 64 * wg;
  const int rA = rlo + 16 * wl + g8;      // this thread's rows: rA, rA + 8
  const long long row = ((long long)b * gridDim.x + h) * mk.lq;
  float lse2[4], del[4];                  // by the element's e: rows A, B
  int klo[2], khi[2];                     // the keys [klo, khi) a row sees
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int r = rA + 4 * e;
    const bool in = r < mk.lq;
    lse2[e] = lse2[e + 1] = in ? lse[row + r] * LOG2E : CUDART_INF_F;
    del[e] = del[e + 1] = in ? delta[row + r] : 0.f;
    klo[e / 2] = mk.causal && mk.window ? r + off - mk.window + 1 : 0;
    khi[e / 2] = !in ? 0 : mk.causal ? min(live, r + off + 1) : live;
  }
  const uint8_t* qws = qs + wg * 64 * 128;
  const uint8_t* dows = dos + wg * 64 * 128;
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % S, k0 = kbeg + i * BT;
    mbar_wait(full + st, (i / S) & 1);
    bool some, every;
    pair_block(mk, live, rlo, k0, some, every);
    if (some) {
      const uint8_t* kt = ks + st * C::T_BYTES;
      const uint8_t* vt = vs + st * C::T_BYTES;
      float sc[32], dp[32];
      wg_fence();
      wg_abt<HD>(sc, qws, BR * 128, kt, BT * 128);    // S = Q K^T
      wg_abt<HD>(dp, dows, BR * 128, vt, BT * 128);   // dP = dO V^T
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      reg_fence(dp);
      uint32_t pa[4][4], da[4][4];
      by_tile(every, softcap, [&](auto mask, auto cap) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kc = k0 + 8 * c + 2 * t4;         // keys kc, kc + 1
          p_ds<decltype(mask)::value, decltype(cap)::value>(
              sc, dp, c, lse2, del, scale, softcap,
              [&](int e) {
                const int key = kc + (e & 1);
                return key >= klo[e >> 1] && key < khi[e >> 1];
              },
              pa, da);
        }
      });
      wg_fence();
      wg_ab<HD>(dqa, da, kt);         // dQ += dS K
      wg_commit();
      wg_wait0();
      reg_fence(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  store_acc<HD>(dqa, dq + b * dqs.b + h * dqs.h, dqs.l, rA, mk.lq, hd);
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const int* kv_valid, void* dq, void* dk, void* dv,
                         const float* delta, int B, int Hq, int Hkv, Mask mk,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dqs, Strides dks, Strides dvs, float scale,
                         float softcap, int hd, cudaStream_t s) {
  using C = Hop<HD>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      bwd_dkv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      bwd_dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  // maps over the true hd: a box's columns past it (120..127) are zeros
  CUtensorMap tq, tk, tv, tdo;
  TmaAxes qa, ka, va, doa;
  cudaError_t e;
  // boxes of 64 rows: a tile of more rows is several boxes
  if ((e = make_map(&tq, &qa, q, hd, qs, mk.lq, Hq, B, 64)) ||
      (e = make_map(&tdo, &doa, dout, hd, dos, mk.lq, Hq, B, 64)) ||
      (e = make_map(&tk, &ka, k, hd, ks, mk.lk, Hkv, B, 64)) ||
      (e = make_map(&tv, &va, v, hd, vs, mk.lk, Hkv, B, 64)))
    return e;
  const int G = Hq / Hkv;
  bwd_dkv_wgmma_kernel<HD><<<dim3(Hkv, B, (mk.lk + C::BR - 1) / C::BR),
                             C::THREADS, C::SMEM, s>>>(
      tq, tk, tv, tdo, qa, ka, va, doa, lse, delta, kv_valid,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), G,
      mk, dks, dvs, scale, softcap, hd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_wgmma_kernel<HD><<<dim3(Hq, B, (mk.lq + C::BR - 1) / C::BR),
                            C::THREADS, C::SMEM, s>>>(
      tq, tk, tv, tdo, qa, ka, va, doa, lse, delta, kv_valid,
      static_cast<__nv_bfloat16*>(dq), G, mk, dqs, scale, softcap, hd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16 at hd 288 (gemma2-2b) on Hopper: TMA rings and wgmma
// ---------------------------------------------------------------------

// At 288 columns a warpgroup's 64 x 288 f32 accumulator is 144
// registers a thread: one warpgroup cannot hold both dK and dV, and
// one 64-row operand is 36 KB of shared memory.  Every operand is
// stored as the forward's hd-288 tiles are (WgWide): nine 32-column
// blocks of 64-byte rows under TMA's 64-byte swizzle, read by wgmma
// descriptors of layout type 2, each 288-column product three m64n96
// (wide_pv).  384 threads: two consumer warpgroups and the producer's
// (warp 8 loads), setmaxnreg 40 / 232 as Hop's.
//  * dK/dV (bwd_dkv_wide_kernel): 64 keys a block, K and V resident
//    (72 KB), Q and dO streamed in 64-row tiles through 2 stages (144
//    KB).  The two consumer warpgroups split the roles over the same
//    keys: warpgroup 0 holds dV and forms S^T = K Q^T, P and dV += P^T
//    dO; warpgroup 1 holds dK and forms dP^T = V dO^T, dS and dK +=
//    dS^T Q.  A thread of each holds the same (key, query) elements of
//    S^T and dP^T, so warpgroup 0 hands each thread's P (1 - t^2) scale
//    to its twin as bf16 pairs through 8 KB of shared memory (two named
//    barriers: the buffer full, the buffer free).  No product is
//    repeated: 4 hd multiply-adds a pair here, 3 in dQ.
//  * dQ (bwd_dq_wide_kernel): 128 query rows a block (64 a consumer
//    warpgroup), Q and dO resident (144 KB), K and V in 32-key tiles
//    through 2 stages (72 KB), so S and dP take 16 registers each beside
//    dQ's 144.
// The softcap's tanh on the SFU as the forward's (ex2, rcp): with r =
// 1 / (2^(2 y log2 e) + 1), t = 1 - 2 r, the capped score in the log2
// domain is c1 - c2 r (the forward's), and 1 - t^2 = 4 r (1 - r).
struct WideBwd {
  static constexpr int HD = 288;
  static constexpr int ROW = HD * 2;              // bytes of an operand row
  static constexpr int BK = 64;                   // keys of a dK/dV block
  static constexpr int BQ = 64;                   // its streamed query rows
  static constexpr int QR = 128;                  // query rows of a dQ block
  static constexpr int KT = 32;                   // its streamed keys
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int HAND = 16 * 128 * 4;       // P (1 - t^2) scale, bf16
  static constexpr int DKV_SMEM = 1024 + 2 * BK * ROW +
                                  2 * STAGES * BQ * ROW + HAND +
                                  2 * STAGES * BQ * 4 +
                                  8 * (1 + 2 * STAGES);
  static constexpr int DQ_SMEM = 1024 + 2 * QR * ROW +
                                 2 * STAGES * KT * ROW + 8 * (1 + 2 * STAGES);
  static constexpr int FULL_BAR = 1, FREE_BAR = 2;  // the hand-over's
};
static_assert(WideBwd::DKV_SMEM <= SMEM_MAX && WideBwd::DQ_SMEM <= SMEM_MAX,
              "the hd-288 backward's tiles fit a block's shared memory");

// D (64 x N) = A B^T over the 288 columns: A's 64 rows at a, B's N rows
// at b, both in 32-column blocks (la, lb bytes apart)
template <int N>
__device__ __forceinline__ void wide_abt(float (&d)[N / 2], const uint8_t* a,
                                         int la, const uint8_t* b, int lb) {
#pragma unroll
  for (int kk = 0; kk < WideBwd::HD / 16; ++kk) {
    const uint64_t da = sw64_desc(a + (kk / 2) * la + (kk % 2) * 32, 16, 512);
    const uint64_t db = sw64_desc(b + (kk / 2) * lb + (kk % 2) * 32, 16, 512);
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, kk > 0);
    else wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// The softcap's constants (log2 domain): k2 turns the raw q . k into 2 y
// log2 e, c1 - c2 r is the capped score times log2 e; mul is scale
// log2 e without one
struct Cap {
  float k2, c1, c2, mul, s4;
  __device__ __forceinline__ Cap(float scale, float softcap)
      : k2(softcap != 0.f ? 2.f * scale * LOG2E / softcap : 0.f),
        c1(softcap * LOG2E), c2(2.f * softcap * LOG2E),
        mul(scale * LOG2E), s4(4.f * scale) {}
};

// P of one score (x the raw q . k, lse2 its row's lse times log2 e) and
// f = P (1 - t^2) scale, the factor dS = f (dP - delta) takes
template <bool CAP>
__device__ __forceinline__ float wide_p(float x, float lse2, float scale,
                                        const Cap& cp, float& f) {
  if constexpr (CAP) {
    const float r = rcp(ex2(x * cp.k2) + 1.f);
    const float p = ex2(fmaf(-cp.c2, r, cp.c1) - lse2);
    f = p * cp.s4 * r * (1.f - r);
    return p;
  } else {
    const float p = ex2(fmaf(x, cp.mul, -lse2));
    f = p * scale;
    return p;
  }
}

// fn(MASK, CAP) with the flags as compile-time constants: unlike by_tile,
// full tiles with a softcap test no score (every gemma2 layer has one)
template <typename Fn>
__device__ __forceinline__ void by_tile_cap(bool every, float softcap,
                                            Fn fn) {
  if (softcap != 0.f) {
    if (every) fn(std::false_type(), std::true_type());
    else fn(std::true_type(), std::true_type());
  } else if (every) {
    fn(std::false_type(), std::false_type());
  } else {
    fn(std::true_type(), std::false_type());
  }
}

__device__ __forceinline__ void unpack_bf16(uint32_t w, float& lo,
                                            float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// one thread's rows (r, r + 8) of a 64 x 288 accumulator (three 64 x 96)
// to bf16 rows of `out` (row pitch sl), rows at or past n left out
__device__ __forceinline__ void store_wide(
    const float (&acc)[WgWide::NO][WgWide::ON / 2], __nv_bfloat16* out,
    long long sl, int r, int n) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int o = 0; o < WgWide::NO; ++o)
#pragma unroll
    for (int c = 0; c < WgWide::ON / 8; ++c) {
      const int d = WgWide::ON * o + 8 * c + 2 * t4;
      if (r < n)
        *reinterpret_cast<uint32_t*>(out + r * sl + d) =
            pack_bf16(acc[o][4 * c], acc[o][4 * c + 1]);
      if (r + 8 < n)
        *reinterpret_cast<uint32_t*>(out + (r + 8) * sl + d) =
            pack_bf16(acc[o][4 * c + 2], acc[o][4 * c + 3]);
    }
}

__device__ __forceinline__ void zero_wide(
    float (&acc)[WgWide::NO][WgWide::ON / 2]) {
#pragma unroll
  for (int o = 0; o < WgWide::NO; ++o)
#pragma unroll
    for (int i = 0; i < WgWide::ON / 2; ++i) acc[o][i] = 0.f;
}

// dK and dV of 64 keys: K, V resident; the group's query tiles (Q, dO,
// their lse and delta) through the ring.  Grid (Hkv, B, key tiles).
__global__ void __launch_bounds__(WideBwd::THREADS, 1)
bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, TmaAxes qa,
                    TmaAxes ka, TmaAxes va, TmaAxes doa,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_valid,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int G, Mask mk,
                    Strides dks, Strides dvs, float scale, float softcap) {
  using C = WideBwd;
  constexpr int BK = C::BK, BQ = C::BQ, S = C::STAGES;
  constexpr int T_BYTES = BQ * C::ROW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);              // [column block][BK][32]
  uint8_t* vs = ks + BK * C::ROW;
  uint8_t* qs = vs + BK * C::ROW;                 // [stage] Q tiles
  uint8_t* dos = qs + S * T_BYTES;                // [stage] dO tiles
  uint32_t* hand = reinterpret_cast<uint32_t*>(dos + S * T_BYTES);
  float* lse_s = reinterpret_cast<float*>(hand + C::HAND / 4);
  float* del_s = lse_s + S * BQ;                  // [stage][BQ] each
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(del_s + S * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BK;
  const int Hq = G * gridDim.x;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  const int k1 = min(k0 + BK, live);    // the tile's keys a query may see
  // query rows that see some key of the tile
  int qlo = 0, qhi = k1 > k0 ? mk.lq : 0;
  if (mk.causal && qhi > 0) {
    qlo = max(0, k0 - off);
    if (mk.window) qhi = min(qhi, k1 - 1 + mk.window - off);
  }
  const int nqt = qhi > qlo ? (qhi - qlo + BQ - 1) / BQ : 0;
  const int steps = G * nqt;            // (head, query tile) in that order

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 32);            // the producer warp's lanes
      mbar_init(empty + i, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                        // producer: warp 8 loads
    reg_dealloc<C::PRODUCER_REGS>();
    if (warp > 8 || steps == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * BK * C::ROW);
      for (int j = 0; j < WgWide::NB; ++j) {
        tma_load(ks + j * BK * 64, &tk, kvbar, ka, 32 * j, k0, kh, b);
        tma_load(vs + j * BK * 64, &tv, kvbar, va, 32 * j, k0, kh, b);
      }
    }
    for (int i = 0; i < steps; ++i) {
      const int st = i % S;
      if (i >= S) mbar_wait(empty + st, (i / S - 1) & 1);
      const int h = kh * G + i / nqt, q0 = qlo + (i % nqt) * BQ;
      const long long row = ((long long)b * Hq + h) * mk.lq;
      // rows past Lq: lse +inf, so P = 0
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < mk.lq;
        lse_s[st * BQ + r] = in ? lse[row + q0 + r] * LOG2E : CUDART_INF_F;
        del_s[st * BQ + r] = in ? delta[row + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + st, 2 * T_BYTES);
        for (int j = 0; j < WgWide::NB; ++j) {
          tma_load(qs + st * T_BYTES + j * BQ * 64, &tq, full + st, qa,
                   32 * j, q0, h, b);
          tma_load(dos + st * T_BYTES + j * BQ * 64, &tdo, full + st, doa,
                   32 * j, q0, h, b);
        }
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }

  // consumers: both warpgroups hold keys k0 .. k0 + 63; warpgroup 0 dV,
  // warpgroup 1 dK
  reg_alloc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const int tw = threadIdx.x & 127;       // the thread within its warpgroup
  const int rA = k0 + 16 * wl + g8;       // this thread's keys: rA, rA + 8
  // the queries [qlo_k, qhi_k) that see each of this thread's keys
  int qlo_k[2], qhi_k[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = rA + 8 * j;
    qlo_k[j] = mk.causal ? key - off : 0;
    qhi_k[j] = key >= live ? 0
               : mk.causal && mk.window ? min(mk.lq, key - off + mk.window)
                                        : mk.lq;
  }
  const Cap cp(scale, softcap);
  float acc[WgWide::NO][WgWide::ON / 2];  // dV (warpgroup 0) or dK (1)
  zero_wide(acc);
  if (steps > 0) mbar_wait(kvbar, 0);
  // Each role walks the steps in its own loop, every product waited for
  // inside it: no wgmma is in flight across a branch that differs
  // between the warpgroups.
  if (wg == 0) {
    for (int i = 0; i < steps; ++i) {
      const int st = i % S, q0 = qlo + (i % nqt) * BQ;
      mbar_wait(full + st, (i / S) & 1);
      bool some, every;
      pair_block(mk, live, q0, k0, some, every);
      if (some) {
        const uint8_t* qt = qs + st * T_BYTES;
        float x[32];
        wg_fence();
        wide_abt<64>(x, ks, BK * 64, qt, BQ * 64);     // S^T = K Q^T
        wg_commit();
        wg_wait0();
        reg_fence(x);
        uint32_t pa[4][4];                // P as the A fragments
        bar_sync(C::FREE_BAR, 256);       // warpgroup 1 read the last one
        by_tile_cap(every, softcap, [&](auto mask, auto cap) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int qc = 8 * c + 2 * t4;  // queries q0 + qc, + 1
            const float2 l2 = *reinterpret_cast<const float2*>(
                lse_s + st * BQ + qc);
            float p[4], f[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              p[e] = wide_p<decltype(cap)::value>(x[4 * c + e],
                                                  (e & 1) ? l2.y : l2.x,
                                                  scale, cp, f[e]);
              if constexpr (decltype(mask)::value) {
                const int iq = q0 + qc + (e & 1);
                if (!(iq >= qlo_k[e >> 1] && iq < qhi_k[e >> 1]))
                  p[e] = f[e] = 0.f;
              }
            }
            // the accumulator's layout is the A fragment's (p_ds)
            pa[c / 2][(c & 1) * 2] = pack_bf16(p[0], p[1]);
            pa[c / 2][(c & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
            hand[(2 * c) * 128 + tw] = pack_bf16(f[0], f[1]);
            hand[(2 * c + 1) * 128 + tw] = pack_bf16(f[2], f[3]);
          }
        });
        bar_arrive(C::FULL_BAR, 256);
        wg_fence();
        wide_pv<64>(acc, pa, dos + st * T_BYTES);      // dV += P^T dO
        wg_commit();
        wide_wait_o(acc);
      }
      release_stage(empty + st);
    }
    bar_sync(C::FREE_BAR, 256);           // the last hand-over was read
    store_wide(acc, dv + b * dvs.b + kh * dvs.h, dvs.l, rA, mk.lk);
    return;
  }
  bar_arrive(C::FREE_BAR, 256);           // the hand-over starts free
  for (int i = 0; i < steps; ++i) {
    const int st = i % S, q0 = qlo + (i % nqt) * BQ;
    mbar_wait(full + st, (i / S) & 1);
    bool some, every;
    pair_block(mk, live, q0, k0, some, every);
    if (some) {
      float x[32];
      wg_fence();
      wide_abt<64>(x, vs, BK * 64, dos + st * T_BYTES, BQ * 64);  // dP^T
      wg_commit();
      wg_wait0();
      reg_fence(x);
      bar_sync(C::FULL_BAR, 256);
      uint32_t fw[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) fw[j] = hand[j * 128 + tw];
      bar_arrive(C::FREE_BAR, 256);
      uint32_t da[4][4];                  // dS as the A fragments
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int qc = 8 * c + 2 * t4;
        const float2 de = *reinterpret_cast<const float2*>(
            del_s + st * BQ + qc);
        float f[4], d[4];
        unpack_bf16(fw[2 * c], f[0], f[1]);
        unpack_bf16(fw[2 * c + 1], f[2], f[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = f[e] * (x[4 * c + e] - ((e & 1) ? de.y : de.x));
        da[c / 2][(c & 1) * 2] = pack_bf16(d[0], d[1]);
        da[c / 2][(c & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
      wg_fence();
      wide_pv<64>(acc, da, qs + st * T_BYTES);        // dK += dS^T Q
      wg_commit();
      wide_wait_o(acc);
    }
    release_stage(empty + st);
  }
  store_wide(acc, dk + b * dks.b + kh * dks.h, dks.l, rA, mk.lk);
}

// dQ of 128 query rows: Q, dO (and each row's lse, delta in registers)
// resident; the 32-key tiles the rows see through the ring.  Grid (Hq,
// B, query tiles), the query-tile index reversed: causal tiles near the
// end see the most keys and start first.
__global__ void __launch_bounds__(WideBwd::THREADS, 1)
bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, TmaAxes qa,
                   TmaAxes ka, TmaAxes va, TmaAxes doa,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ kv_valid,
                   __nv_bfloat16* __restrict__ dq, int G, Mask mk,
                   Strides dqs, float scale, float softcap) {
  using C = WideBwd;
  constexpr int QR = C::QR, KT = C::KT, S = C::STAGES;
  constexpr int T_BYTES = KT * C::ROW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);              // [column block][QR][32]
  uint8_t* dos = qs + QR * C::ROW;
  uint8_t* ks = dos + QR * C::ROW;                // [stage] K tiles
  uint8_t* vs = ks + S * T_BYTES;                 // [stage] V tiles
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + S * T_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QR, kh = h / G;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  // keys some row of the block sees
  int kbeg = 0, kend = live;
  if (mk.causal) {
    kend = min(kend, min(q0 + QR, mk.lq) + off);
    if (mk.window) kbeg = max(0, q0 + off - mk.window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + KT - 1) / KT : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                        // producer: warp 8 loads
    reg_dealloc<C::PRODUCER_REGS>();
    if (warp == 8 && lane == 0 && ntiles > 0) {
      mbar_expect_tx(qbar, 2 * QR * C::ROW);
      for (int j = 0; j < WgWide::NB; ++j)
        for (int r = 0; r < QR; r += 64) {
          tma_load(qs + (j * QR + r) * 64, &tq, qbar, qa, 32 * j, q0 + r, h,
                   b);
          tma_load(dos + (j * QR + r) * 64, &tdo, qbar, doa, 32 * j, q0 + r,
                   h, b);
        }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % S, kt0 = kbeg + i * KT;
        if (i >= S) mbar_wait(empty + st, (i / S - 1) & 1);
        mbar_expect_tx(full + st, 2 * T_BYTES);
        for (int j = 0; j < WgWide::NB; ++j) {
          tma_load(ks + st * T_BYTES + j * KT * 64, &tk, full + st, ka,
                   32 * j, kt0, kh, b);
          tma_load(vs + st * T_BYTES + j * KT * 64, &tv, full + st, va,
                   32 * j, kt0, kh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows rlo .. rlo + 63
  reg_alloc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const int rlo = q0 + 64 * wg;
  const int rA = rlo + 16 * wl + g8;      // this thread's rows: rA, rA + 8
  const long long row = ((long long)b * gridDim.x + h) * mk.lq;
  float lse2[2], del[2];                  // rows rA, rA + 8
  int klo[2], khi[2];                     // the keys [klo, khi) a row sees
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rA + 8 * j;
    const bool in = r < mk.lq;
    lse2[j] = in ? lse[row + r] * LOG2E : CUDART_INF_F;
    del[j] = in ? delta[row + r] : 0.f;
    klo[j] = mk.causal && mk.window ? r + off - mk.window + 1 : 0;
    khi[j] = !in ? 0 : mk.causal ? min(live, r + off + 1) : live;
  }
  const uint8_t* qws = qs + wg * 64 * 64;
  const uint8_t* dows = dos + wg * 64 * 64;
  const Cap cp(scale, softcap);
  float dqa[WgWide::NO][WgWide::ON / 2];
  zero_wide(dqa);
  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % S, kt0 = kbeg + i * KT;
    mbar_wait(full + st, (i / S) & 1);
    bool some, every;
    pair_block(mk, live, rlo, kt0, some, every, KT);
    if (some) {
      const uint8_t* kt = ks + st * T_BYTES;
      const uint8_t* vt = vs + st * T_BYTES;
      float sc[KT / 2], dp[KT / 2];
      wg_fence();
      wide_abt<KT>(sc, qws, QR * 64, kt, KT * 64);    // S = Q K^T
      wide_abt<KT>(dp, dows, QR * 64, vt, KT * 64);   // dP = dO V^T
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      reg_fence(dp);
      uint32_t da[KT / 16][4];
      by_tile_cap(every, softcap, [&](auto mask, auto cap) {
#pragma unroll
        for (int c = 0; c < KT / 8; ++c) {
          const int kc = kt0 + 8 * c + 2 * t4;        // keys kc, kc + 1
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float f;
            wide_p<decltype(cap)::value>(sc[4 * c + e], lse2[e >> 1], scale,
                                         cp, f);
            if constexpr (decltype(mask)::value) {
              const int key = kc + (e & 1);
              if (!(key >= klo[e >> 1] && key < khi[e >> 1])) f = 0.f;
            }
            d[e] = f * (dp[4 * c + e] - del[e >> 1]);
          }
          da[c / 2][(c & 1) * 2] = pack_bf16(d[0], d[1]);
          da[c / 2][(c & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
        }
      });
      wg_fence();
      wide_pv<KT>(dqa, da, kt);           // dQ += dS K
      wg_commit();
      wide_wait_o(dqa);
    }
    release_stage(empty + st);
  }
  store_wide(dqa, dq + b * dqs.b + h * dqs.h, dqs.l, rA, mk.lq);
}

cudaError_t launch_wide_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const int* kv_valid, void* dq, void* dk,
                            void* dv, const float* delta, int B, int Hq,
                            int Hkv, Mask mk, Strides qs, Strides ks,
                            Strides vs, Strides dos, Strides dqs,
                            Strides dks, Strides dvs, float scale,
                            float softcap, cudaStream_t s) {
  using C = WideBwd;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      bwd_dkv_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::DKV_SMEM);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      bwd_dq_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::DQ_SMEM);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  // 32-column boxes under the 64-byte swizzle: Q and dO of 64 rows (the
  // dQ kernel's 128 resident rows are two boxes), K and V of 64 rows for
  // the dK/dV kernel and of 32 for the dQ kernel's tiles
  CUtensorMap tq, tdo, tk, tv, tk2, tv2;
  TmaAxes qa, doa, ka, va, ka2, va2;
  cudaError_t e;
  if ((e = make_map(&tq, &qa, q, C::HD, qs, mk.lq, Hq, B, 64, 32)) ||
      (e = make_map(&tdo, &doa, dout, C::HD, dos, mk.lq, Hq, B, 64, 32)) ||
      (e = make_map(&tk, &ka, k, C::HD, ks, mk.lk, Hkv, B, C::BK, 32)) ||
      (e = make_map(&tv, &va, v, C::HD, vs, mk.lk, Hkv, B, C::BK, 32)) ||
      (e = make_map(&tk2, &ka2, k, C::HD, ks, mk.lk, Hkv, B, C::KT, 32)) ||
      (e = make_map(&tv2, &va2, v, C::HD, vs, mk.lk, Hkv, B, C::KT, 32)))
    return e;
  const int G = Hq / Hkv;
  bwd_dkv_wide_kernel<<<dim3(Hkv, B, (mk.lk + C::BK - 1) / C::BK),
                        C::THREADS, C::DKV_SMEM, s>>>(
      tq, tk, tv, tdo, qa, ka, va, doa, lse, delta, kv_valid,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), G,
      mk, dks, dvs, scale, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_wide_kernel<<<dim3(Hq, B, (mk.lq + C::QR - 1) / C::QR),
                       C::THREADS, C::DQ_SMEM, s>>>(
      tq, tk2, tv2, tdo, qa, ka2, va2, doa, lse, delta, kv_valid,
      static_cast<__nv_bfloat16*>(dq), G, mk, dqs, scale, softcap);
  return cudaGetLastError();
}

// every row of an operand's (b, h, l) axes on 16 bytes, hd a whole
// number of 16-byte loads
template <typename T>
bool rows16(const void* p, Strides st, int hd) {
  const long long s[3] = {st.b, st.h, st.l};
  for (long long x : s)
    if ((x * (long long)sizeof(T)) % 16) return false;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (hd * (int)sizeof(T)) % 16 == 0;
}

// Bodies: 0 f32, 1 mma, 2 wgmma (flash_attention.py's BWD_BODIES).
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   const int* kv_valid, void* dq, void* dk, void* dv,
                   float* delta, int B, int Hq, int Hkv, Mask mk, Strides qs,
                   Strides ks, Strides vs, Strides os, Strides dos,
                   Strides dqs, Strides dks, Strides dvs, float scale,
                   float softcap, int hd, int body, cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const Tiles tl = tiles<T>(hd);
  const int s_dkv = smem_dkv<T>(hd), s_dq = smem_dq<T>(hd);
  // the register strips a warp takes (one for f32 operands: unused)
  const int ns = F32 ? 1 : acc_strips(tl.bk, hd);
  const bool wg = body == 2;
  if (body != (F32 ? 0 : wg ? 2 : 1) || mk.lk < 1 || hd % 8 != 0)
    return cudaErrorInvalidValue;
  if (wg) {
    // 4-byte stores of gradient pairs
    const long long st[] = {dqs.b, dqs.h, dqs.l, dks.b, dks.h, dks.l,
                            dvs.b, dvs.h, dvs.l};
    for (long long x : st)
      if (x % 2) return cudaErrorInvalidValue;
    if ((hd != 64 && hd != 120 && hd != 128 && hd != 288) ||
        !tma_ok(q, qs, mk.lq, Hq, B) || !tma_ok(k, ks, mk.lk, Hkv, B) ||
        !tma_ok(v, vs, mk.lk, Hkv, B) || !tma_ok(dout, dos, mk.lq, Hq, B) ||
        (reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
         reinterpret_cast<uintptr_t>(dv)) % 4)
      return cudaErrorInvalidValue;
  } else if (s_dkv > SMEM_MAX || s_dq > SMEM_MAX || tl.bk != tl.bq ||
             ns > 3) {
    return cudaErrorInvalidValue;
  }
  const int G = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int vec = rows16<T>(o, os, hd) && rows16<T>(dout, dos, hd);
  bwd_delta_kernel<T><<<dim3((mk.lq + THREADS / 8 - 1) / (THREADS / 8), Hq,
                             B),
                        THREADS, 0, s>>>(static_cast<const T*>(o), dop,
                                         delta, os, dos, mk.lq, hd, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (!F32) {
    if (wg && hd == 288)
      return launch_wide_bwd(q, k, v, dout, lse, kv_valid, dq, dk, dv, delta,
                             B, Hq, Hkv, mk, qs, ks, vs, dos, dqs, dks, dvs,
                             scale, softcap, s);
    if (wg)
      return hd == 64
                 ? launch_wgmma<64>(q, k, v, dout, lse, kv_valid, dq, dk, dv,
                                    delta, B, Hq, Hkv, mk, qs, ks, vs, dos,
                                    dqs, dks, dvs, scale, softcap, hd, s)
                 : launch_wgmma<128>(q, k, v, dout, lse, kv_valid, dq, dk,
                                     dv, delta, B, Hq, Hkv, mk, qs, ks, vs,
                                     dos, dqs, dks, dvs, scale, softcap, hd,
                                     s);
  }
  auto run = [&](auto strips) -> cudaError_t {
    constexpr int S = decltype(strips)::value;
    static const cudaError_t a1 = cudaFuncSetAttribute(
        bwd_dkv_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    static const cudaError_t a2 = cudaFuncSetAttribute(
        bwd_dq_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (a1 != cudaSuccess) return a1;
    if (a2 != cudaSuccess) return a2;
    bwd_dkv_kernel<T, S><<<dim3((mk.lk + tl.bk - 1) / tl.bk, Hkv, B),
                           THREADS, s_dkv, s>>>(
        qp, kp, vp, dop, lse, delta, kv_valid, static_cast<T*>(dk),
        static_cast<T*>(dv), G, mk, qs, ks, vs, dos, dks, dvs, scale,
        softcap, hd);
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    bwd_dq_kernel<T, S><<<dim3((mk.lq + tl.bq - 1) / tl.bq, Hq, B), THREADS,
                          s_dq, s>>>(qp, kp, vp, dop, lse, delta, kv_valid,
                                     static_cast<T*>(dq), G, mk, qs, ks, vs,
                                     dos, dqs, scale, softcap, hd);
    return cudaGetLastError();
  };
  if constexpr (F32) {
    return run(std::integral_constant<int, 1>());
  } else {
    if (ns == 1) return run(std::integral_constant<int, 1>());
    if (ns == 2) return run(std::integral_constant<int, 2>());
    return run(std::integral_constant<int, 3>());
  }
}

}  // namespace fa_bwd
