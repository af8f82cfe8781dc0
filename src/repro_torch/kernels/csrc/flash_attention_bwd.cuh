// The backward of flash_attention (included by flash_attention.cu, inside
// its namespace: Mask, Strides and live_keys are that file's).
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
//  * bwd_delta_kernel: delta, one thread a query row;
//  * bwd_dkv_kernel, one block per (key tile, kv head, batch): its K and
//    V tiles and their dK / dV accumulators stay on the SM while the
//    block walks the G query heads of the group and their query
//    tiles (the ones the mask lets see the tile), so GQA needs no
//    atomics;
//  * bwd_dq_kernel, one block per (query tile, q head, batch), walking
//    the key tiles its rows see.
// Both recompute P from Q, K and lse (and the softcap's tanh).  No
// atomics: the same bits on every run.  The products run by operand
// type:
//  * f32 operands: every product a block_mm on CUDA cores in f32, the
//    tiles f32 in shared memory;
//  * bf16 operands: the tiles stay bf16 in shared memory and every
//    product is block_mma, mma.sync m16n8k16 on tensor cores with f32
//    accumulators; dK, dV and dQ accumulate in registers (each warp
//    keeps the same strips of them across the loop), which leaves room
//    for two blocks an SM up to hd 128.  P and dS enter their products
//    rounded to bf16, as in FlashAttention-2; P, tanh and dS's
//    arithmetic stay f32.
//
// What bounds it on an H100: operations.  Per live (query, key) pair and
// head the backward does 5 hd multiply-adds of work (the recomputed
// Q K^T, dV, dP, dQ, dK; 10 hd FLOP); at llama3.2-1b's training shape
// (B=8, L=1024, 32 heads of 64, causal) that is 86 GFLOP a layer, 0.087
// ms at the bf16 tensor-core rate, against 50 MB of operands.  This
// kernel does 7 hd multiply-adds a pair (dQ's kernel recomputes Q K^T
// and dO V^T), loads each mma.sync operand from shared memory with
// plain loads (two 16-bit loads a register where the operand is read
// across its rows), waits on a __syncthreads between products and on
// each tile's global loads (no prefetch), so it sits well above that
// bound: a wgmma / TMA body is later work.
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Strides os, Strides dos, int lq,
                 int hd) {
  const int iq = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (iq >= lq) return;
  const T* orow = o + b * os.b + h * os.h + (long long)iq * os.l;
  const T* drow = dout + b * dos.b + h * dos.h + (long long)iq * dos.l;
  float s = 0.f;
  for (int c = 0; c < hd; ++c) s = fmaf(ld_f32(drow[c]), ld_f32(orow[c]), s);
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

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   const int* kv_valid, void* dq, void* dk, void* dv,
                   float* delta, int B, int Hq, int Hkv, Mask mk, Strides qs,
                   Strides ks, Strides vs, Strides os, Strides dos,
                   Strides dqs, Strides dks, Strides dvs, float scale,
                   float softcap, int hd, cudaStream_t s) {
  const Tiles tl = tiles<T>(hd);
  const int s_dkv = smem_dkv<T>(hd), s_dq = smem_dq<T>(hd);
  // the register strips a warp takes (one for f32 operands: unused)
  const int ns = std::is_same<T, float>::value ? 1 : acc_strips(tl.bk, hd);
  if (s_dkv > SMEM_MAX || s_dq > SMEM_MAX || mk.lk < 1 || hd % 8 != 0 ||
      tl.bk != tl.bq || ns > 3)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  bwd_delta_kernel<T><<<dim3((mk.lq + THREADS - 1) / THREADS, Hq, B),
                        THREADS, 0, s>>>(static_cast<const T*>(o), dop,
                                         delta, os, dos, mk.lq, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
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
  if constexpr (std::is_same<T, float>::value) {
    return run(std::integral_constant<int, 1>());
  } else {
    if (ns == 1) return run(std::integral_constant<int, 1>());
    if (ns == 2) return run(std::integral_constant<int, 2>());
    return run(std::integral_constant<int, 3>());
  }
}

}  // namespace fa_bwd
