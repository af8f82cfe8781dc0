// The backward of ssd_scan (included by ssd_scan.cu, inside its
// namespace: it uses the forward's mma.sync / ldmatrix / cp.async
// primitives).
//
// The TPU package differentiates its scan with jax.grad; there is no
// Pallas backward.  Given x, dt, A, B, C of the forward (no h0: training
// starts from a zero state), the output's gradient dy (Bb, L, H, P) f32
// and optionally the final state's dh (Bb, H, P, N), it forms dx, ddt,
// dA (H,), dB and dC (Bb, L, N).  The recurrence h_t = exp(dt_t A) h_{t-1}
// + dt_t x_t B_t^T, y_t = C_t . h_t is evaluated in chunks of Q = 64
// (its own chunking: any chunking is the same function), la = cumsum(dt
// A) inside a chunk, h_in / h_out the state entering / leaving it,
// dh_out the gradient of h_out, e_i = exp(la_i), q_j = exp(la_Q - la_j):
//   h_out   = exp(la_Q) h_in + s_c,      s_c = (q dt o x)^T B
//   dh_in   = exp(la_Q) dh_out + r_c,    r_c = (e o dy)^T C
//             (dh_in is dh_out of the chunk before)
//   G       = C B^T,  D_ij = exp(la_i - la_j) for j <= i, else 0
//   S1      = G o D,  M = dy x^T,  W = D o M dt_j,  S3 = S1 o M
//   dx      = dt o (S1^T dy + q o (B dh_out^T))
//   dB      = W^T C + (q dt o x) dh_out      (summed over the heads)
//   dC      = W B + (e o dy) h_in            (summed over the heads)
//   ddt_j  += sum_i S3_ij + V_j,  V_j = q_j x_j . (dh_out B_j)
//   dla_i   = sum_j S3_ij dt_j - dt_i sum_u S3_ui + e_i dy_i . (h_in C_i),
//             and exp(la_Q) <dh_out, h_in> at the chunk's last row;
//   then ddt_s += A R_s and dA += dt_s R_s with R_s = sum_{t >= s} dla_t
//   + sum_{j < s} dt_j V_j (the cumsum's transpose; h_out's own terms,
//   <dh_out, h_out> at the last row less dt_j V_j at each row j, summed
//   without the cancellation between them).
// B and C are shared by the heads, so dB, dC and G are formed once per
// group of heads: W is summed over the group before W^T C and W B, and
// the state terms of all the group's heads go into one accumulator.
//
// What bounds it on an H100: at mamba2-1.3b's training shape (Bb=8,
// L=1024, H=64, P=64, N=128, bf16 x, B, C views, no h0) the function
// reads x, B, C (bf16), dy (f32), dt and writes dx, dB, dC (bf16), ddt:
// 0.28 GB, 0.084 ms at 3.35 TB/s; its products (dy x^T, dx, dB and dC
// over each chunk's causal pairs, the six chunk x P x N products with
// the states, C B^T once for all heads) are 61.5 GFLOP, 0.062 ms at the
// bf16 tensor-core rate: bytes.  The first kernel (CUDA cores, f32) took
// 15.4 ms: both state passes carried each state through the chunks in
// order, three shared-memory loads per multiply-add; the chunk kernel
// took 216 KB of shared memory (one block of 8 warps an SM), formed C
// B^T for every head and sent each head's share of dB and dC through a
// 1.07 GB round trip.
//
// Design, four launches:
//  1. ssd_bwd_state_kernel, a block per (batch, chunk, group of heads):
//     la by a warp scan (written out for the later launches), then each
//     chunk's own contributions to the two passes, s_c and r_c, both
//     (P x chunk) . (chunk x N) tensor-core products with the weights
//     applied to the x / dy fragments in registers, into f32 scratch.
//     All chunks at once: nothing here is sequential.
//  2. ssd_bwd_pass_kernel, a thread per 4 state elements: the only
//     sequential part, elementwise, h_c = exp(la_Q) h_{c-1} + s_c forward
//     and dh_{c-1} = exp(la_Q) dh_c + r_c in reverse; writes the state
//     entering each chunk and dh_out of each chunk as split bf16 planes
//     and <dh_out, h_in> per chunk (a fixed-order block sum per 1,024
//     elements).
//  3. ssd_bwd_chunk_kernel, a block per (batch, chunk, group of up to 8
//     heads), 8 warps (4 row tiles of 16 x 2 column halves): per head
//     G and M (causal tiles only), S1, W, S3 in registers (S3's row and
//     column sums by shuffles, W summed over the group in registers), S1^T
//     dy, then dh_out's tile: B dh_out^T for dx and V, (q dt o x) dh_out
//     into the group's dB accumulator; after the group W^T C into it, and
//     dB written; then W B and, per head, h_in's tile: C h_in^T for dla,
//     (e o dy) h_in into the group's dC accumulator; last, each head's dla
//     reversed and summed by a warp scan into ddt and dA's part.  P wider
//     than the tile is taken a P slice at a time (the function is linear
//     in the slices); N up to 128 takes the fast tile, up to 352 a
//     narrower-P one.  107 KB of shared memory at mamba2's shape (bf16):
//     two blocks an SM.
//  4. ssd_bwd_reduce_kernel: dB and dC summed over the head groups, dA
//     over the batches and chunks, in a fixed order.
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by
// ldmatrix from padded bf16 rows.  A bf16 operand is used as it is; an
// f32 one (x, B, C in f32 runs; dy, the states, S1, W and the scaled
// x / dy always) is split into LV bf16 terms, hi + lo (LV = 2: ~2^-16 of
// each term kept) in bf16 runs, hi + mid + lo (LV = 3: ~2^-24, as f32)
// in f32 runs up to N = 128; a product takes the terms of order below LV
// (hi x hi, hi x lo, lo x hi for two f32 operands at LV = 2; six at 3).
// dA sums terms far larger than itself where the decay is slow: with
// two terms an f32 card test missed 1e-4 of max |dA| (1.37e-4); with
// three it keeps what f32 keeps.  No atomics in any sum: the same bits
// on every run.
// Scratch traffic kept, at mamba2's shape: s_c and r_c (f32) written and
// read, 1.07 GB; the states entering and leaving each chunk (bf16 hi / lo)
// written and read, 1.07 GB (the entering ones read once more by the
// reverse pass); the head groups' dB and dC partials, 0.13 GB.
#pragma once

namespace ssd_bwd {

constexpr int Q = 64;               // chunk of the backward
constexpr int THR = 256;            // 8 warps: 4 row tiles x 2 halves
constexpr int QP = Q + 8;           // bf16 pitch of a chunk-wide row
constexpr int XS = 64;              // P slice of the state kernel
constexpr int XSP = XS + 8;
constexpr int PASS_EL = 4;          // state elements of a pass thread
constexpr int PASS_THR = 256;
constexpr int PASS_TILE = PASS_EL * PASS_THR;
constexpr int HG = 8;               // heads of a group, at most
constexpr int WIDE_N = 352;         // the widest state the tiles take

// bf16 terms of a split f32 operand: 3 in f32 runs up to N = 128 (their
// planes fit beside the fast tile), else 2
__host__ __device__ constexpr int levels(bool lo, int N) {
  return lo && up(N, 16) <= 128 ? 3 : 2;
}

template <typename T>
struct Args {
  const T *x, *B, *C;
  const float *dt, *A, *dy, *dh;
  float *LA, *S, *R;
  bf16* hs;          // 2 LV planes: h_in's terms, then dh_out's
  float* dlaq;       // <dh_out, h_in> per (batch, head, chunk, 1,024)
  T* dx;
  float *ddt, *dbp, *dcp, *dap;
  long long xsb, xsl, dsb, dsl, bsb, bsl, csb, csl, plane;
  int L, H, P, N, N8, nb, hg, ngrp, nz;
  bool vx, vb, vc, vy;     // 16-byte rows: vector loads
};

// the chunk kernel's tiles: P slice PT, state width NT (both padded to
// 16 inside); UP / UN 16-column groups of a half-warp-row over P / N;
// NX planes of x, B, C (bf16: 1), LV of an f32 operand
template <int PT, int NT>
struct Tile {
  static constexpr int NP = NT + 8, PP = PT + 8;
  static constexpr int UP = (PT / 16 + 1) / 2, UN = (NT / 16 + 1) / 2;
  // bf16 elements of a plane of the union: a state tile or S1 / W
  __host__ __device__ static constexpr long long uplane() {
    return (long long)PT * NP > (long long)Q * QP ? (long long)PT * NP
                                                  : (long long)Q * QP;
  }
  // bytes: B, C, x (NX planes), dy (LV), the union (LV); la, dt, dla,
  // ddt's column part, dt V per head; the cross-warp partial sums
  __host__ __device__ static constexpr long long smem(int nx, int lv,
                                                      int hg) {
    return 2LL * (nx * (2LL * Q * NP + Q * PP) + lv * (Q * PP + uplane())) +
           4LL * (5LL * hg * Q + 8 * Q);
  }
};

inline long long state_smem(int nx, int lv, int N) {
  const long long np = up(N, 16) + 8;
  return 2LL * (nx * (2 * Q * np + Q * XSP) + lv * Q * XSP) + 4LL * 4 * Q;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a pair of f32 values as NL bf16 terms, each the rounding of what the
// terms before it left: o[l][r] holds term l (first value in the low half)
template <int NL>
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (&o)[NL][4], int r) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    o[l][r] = *reinterpret_cast<const uint32_t*>(&h);
    a -= f.x;
    b -= f.y;
  }
}

// the f32 value of NL terms (the smallest first)
template <int NL>
__device__ __forceinline__ float2 join(const uint32_t (&v)[NL]) {
  float2 s = unpack(v[NL - 1]);
#pragma unroll
  for (int l = NL - 2; l >= 0; --l) {
    const float2 u = unpack(v[l]);
    s.x += u.x;
    s.y += u.y;
  }
  return s;
}

// the pair at element offset o of NL planes `len` apart
template <int NL>
__device__ __forceinline__ float2 pair_at(const bf16* p, long long len,
                                          int o) {
  uint32_t v[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l)
    v[l] = *reinterpret_cast<const uint32_t*>(p + l * len + o);
  return join<NL>(v);
}

// rows [0, R) x 8-column granules [0, G) of a tile of pitch `pitch` in
// NL bf16 planes `len` apart (NL = 1 for a bf16 source): element (r, c)
// = src[r srow + c] for r < nr and c < nc, else 0.  `vec`: whole
// granules by 16-byte loads (src and srow on 16 bytes).
template <typename T, int NL>
__device__ __forceinline__ void stage(bf16* dst, long long len, int pitch,
                                      int R, int G, const T* src,
                                      long long srow, int nr, int nc,
                                      bool vec) {
#pragma unroll 4
  for (int e = threadIdx.x; e < R * G; e += blockDim.x) {
    const int r = e / G, c = 8 * (e - r * G);
    const T* s = src + r * srow + c;
    if constexpr (sizeof(T) == 2) {
      static_assert(NL == 1, "a bf16 source is one plane");
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nr) {
        if (vec && c + 8 <= nc) {
          v = *reinterpret_cast<const uint4*>(s);
        } else {
          bf16* pv = reinterpret_cast<bf16*>(&v);
          for (int k = 0; k < 8; ++k)
            if (c + k < nc) pv[k] = s[k];
        }
      }
      *reinterpret_cast<uint4*>(dst + r * pitch + c) = v;
    } else {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < nr) {
        if (vec && c + 8 <= nc) {
          const float4 u0 = *reinterpret_cast<const float4*>(s);
          const float4 u1 = *reinterpret_cast<const float4*>(s + 4);
          v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
          v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
        } else {
          for (int k = 0; k < 8; ++k)
            if (c + k < nc) v[k] = s[k];
        }
      }
      uint32_t o[NL][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_pair<NL>(v[2 * q], v[2 * q + 1], o, q);
#pragma unroll
      for (int l = 0; l < NL; ++l)
        *reinterpret_cast<uint4*>(dst + l * len + r * pitch + c) =
            make_uint4(o[l][0], o[l][1], o[l][2], o[l][3]);
    }
  }
}

// rows [0, R) x granules [0, G) of a bf16 plane tile by cp.async: row r
// < nr, granule q < ng from src + r srow + 8 q, the rest zero.  The
// caller commits and waits.
__device__ __forceinline__ void tile_cp(bf16* dst, int pitch, int R, int G,
                                        const bf16* src, long long srow,
                                        int nr, int ng) {
  for (int e = threadIdx.x; e < R * G; e += blockDim.x) {
    const int r = e / G, q = e - r * G;
    const bool in = r < nr && q < ng;
    cp16(dst + r * pitch + 8 * q, in ? src + r * srow + 8 * q : src, in);
  }
}

// fragments of NL planes `len` apart: A (lda / lda_t), B (ldb / ldb_t)
template <int NL>
__device__ __forceinline__ void lda_n(uint32_t (&a)[NL][4], const bf16* s,
                                      long long len, int pitch, int m0,
                                      int k) {
#pragma unroll
  for (int l = 0; l < NL; ++l) lda(a[l], s + l * len, pitch, m0, k);
}
template <int NL>
__device__ __forceinline__ void lda_t_n(uint32_t (&a)[NL][4], const bf16* s,
                                        long long len, int pitch, int m0,
                                        int k) {
#pragma unroll
  for (int l = 0; l < NL; ++l) lda_t(a[l], s + l * len, pitch, m0, k);
}
template <int NL>
__device__ __forceinline__ void ldb_n(uint32_t (&b)[NL][4], const bf16* s,
                                      long long len, int pitch, int n0,
                                      int k) {
#pragma unroll
  for (int l = 0; l < NL; ++l) ldb(b[l], s + l * len, pitch, n0, k);
}
template <int NL>
__device__ __forceinline__ void ldb_t_n(uint32_t (&b)[NL][4], const bf16* s,
                                        long long len, int pitch, int n0,
                                        int k) {
#pragma unroll
  for (int l = 0; l < NL; ++l) ldb_t(b[l], s + l * len, pitch, n0, k);
}

// A warp's 16-row product tile: acc[2u + s] holds the output columns
// 16 gi + 8 s .. (gi = g0 + gs u, for gi < ge) over k in [k0, k1) (steps
// of 16).  fa(a, k) gives the NA terms of the A fragment, fb(b, n0, k)
// the NB terms of the B fragments of columns n0 .. n0 + 15; the products
// of terms i x j with i + j below max(NA, NB) are summed (for two split
// operands: the terms of order under the split's).
template <int U, int NA, int NB, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[2 * U][4], int g0, int gs,
                                   int ge, int k0, int k1, FA fa, FB fb) {
  constexpr int NM = NA > NB ? NA : NB;
  for (int k = k0; k < k1; k += 16) {
    uint32_t a[NA][4];
    fa(a, k);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gi = g0 + gs * u;
      if (gi >= ge) break;
      uint32_t b[NB][4];
      fb(b, 16 * gi, k);
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (i + j < NM) {
            mma(acc[2 * u], a[i], b[j][0], b[j][1]);
            mma(acc[2 * u + 1], a[i], b[j][2], b[j][3]);
          }
    }
  }
}

// an A fragment of NI terms, joined, scaled in registers and split into
// NO: register r (rows g / g + 8 for r even / odd, keys 2t, 2t+1 for r <
// 2 and 2t+8, 2t+9 after) takes the pair of scales sc[r]
template <int NI, int NO>
__device__ __forceinline__ void rescale(const uint32_t (&in)[NI][4],
                                        uint32_t (&out)[NO][4],
                                        const float2 (&sc)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t v[NI];
#pragma unroll
    for (int l = 0; l < NI; ++l) v[l] = in[l][r];
    const float2 f = join<NI>(v);
    split_pair<NO>(f.x * sc[r].x, f.y * sc[r].y, out, r);
  }
}

// A[p][k] = w_k v[k][p] from NI planes of v (rows k, pitch `pitch`),
// split into NO terms
template <int NI, int NO>
__device__ __forceinline__ void keys_scaled(uint32_t (&o)[NO][4],
                                            const bf16* v, long long len,
                                            int pitch, int m0, int k,
                                            const float* w) {
  uint32_t in[NI][4];
  lda_t_n<NI>(in, v, len, pitch, m0, k);
  const float* wk = w + k + 2 * (threadIdx.x & 3);
  const float2 lo = make_float2(wk[0], wk[1]), hi = make_float2(wk[8], wk[9]);
  const float2 sc[4] = {lo, lo, hi, hi};
  rescale<NI, NO>(in, o, sc);
}

// the sum of a value over the 4 lanes of a fragment row (t = 0..3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------
// 1. la, and each chunk's own s_c and r_c
// ---------------------------------------------------------------------

template <typename T, int LV>
__global__ void __launch_bounds__(THR, 2)
ssd_bwd_state_kernel(const Args<T> a) {
  constexpr int NX = sizeof(T) == 4 ? LV : 1;
  extern __shared__ __align__(16) uint8_t raw[];
  const int N16 = up(a.N, 16), NPr = N16 + 8;
  const long long lb = (long long)Q * NPr, lx = (long long)Q * XSP;
  bf16* bs = reinterpret_cast<bf16*>(raw);        // NX planes each
  bf16* cs = bs + NX * lb;
  bf16* xs = cs + NX * lb;
  bf16* dys = xs + NX * lx;                       // LV planes
  float* la = reinterpret_cast<float*>(dys + LV * lx);
  float* dts = la + Q;
  float* wv = dts + Q;                            // q_j dt_j
  float* ev = wv + Q;                             // e_i

  const int grp = blockIdx.x % a.ngrp;
  const long long bc = blockIdx.x / a.ngrp;
  const int c = (int)(bc % a.nb), b = (int)(bc / a.nb);
  const int c0 = c * Q, cl = min(Q, a.L - c0), kq = up(cl, 16);
  const int h0 = grp * a.hg, nh = min(a.hg, a.H - h0);
  const int t = threadIdx.x, wp = t >> 5, ln = t & 31;
  const int g = ln >> 2, t4 = ln & 3, wr = wp & 3, hf = wp >> 2;
  const int ng = N16 / 16;
  stage<T, NX>(bs, lb, NPr, Q, N16 / 8,
               a.B + b * a.bsb + (long long)c0 * a.bsl, a.bsl, cl, a.N,
               a.vb);
  stage<T, NX>(cs, lb, NPr, Q, N16 / 8,
               a.C + b * a.csb + (long long)c0 * a.csl, a.csl, cl, a.N,
               a.vc);
  const long long PN8 = (long long)a.P * a.N8;
  for (int s = 0; s < nh; ++s) {
    const int h = h0 + s;
    const long long so = (((long long)b * a.nb + c) * a.H + h) * PN8;
    for (int p0 = 0; p0 < a.P; p0 += XS) {
      const int Pl = min(XS, a.P - p0), P16 = up(Pl, 16);
      __syncthreads();                      // the last slice is read
      stage<T, NX>(xs, lx, XSP, Q, P16 / 8,
                   a.x + b * a.xsb + (long long)c0 * a.xsl +
                       (long long)h * a.P + p0,
                   a.xsl, cl, Pl, a.vx);
      stage<float, LV>(dys, lx, XSP, Q, P16 / 8,
                       a.dy + (((long long)b * a.L + c0) * a.H + h) * a.P +
                           p0,
                       (long long)a.H * a.P, cl, Pl, a.vy);
      if (p0 == 0) {
        for (int i = t; i < Q; i += THR)
          dts[i] = i < cl ? a.dt[b * a.dsb + (long long)(c0 + i) * a.dsl + h]
                          : 0.f;
        __syncthreads();
        if (wp == 0) chunk_cumsum(la, dts, a.A[h], cl);
        __syncthreads();
        const float lq = la[cl - 1];
        const long long hr = ((long long)b * a.H + h) * a.L + c0;
        for (int i = t; i < Q; i += THR) {
          wv[i] = i < cl ? expf(lq - la[i]) * dts[i] : 0.f;
          ev[i] = i < cl ? expf(la[i]) : 0.f;
          if (i < cl) a.LA[hr + i] = la[i];
        }
      }
      __syncthreads();
      for (int rg = wr; rg < P16 / 16; rg += 4) {
        for (int cb = hf; 64 * cb < N16; cb += 2) {
          const int g0 = 4 * cb, ge = min(g0 + 4, ng);
          auto store = [&](float* out, const float (&acc)[8][4]) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int n = 16 * (g0 + u / 2) + 8 * (u & 1) + 2 * t4;
              if (g0 + u / 2 >= ge || n >= a.N8) continue;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int p = 16 * rg + g + 8 * r;
                if (p < Pl)
                  *reinterpret_cast<float2*>(out + so + (p0 + p) * a.N8 + n) =
                      make_float2(acc[u][2 * r], acc[u][2 * r + 1]);
              }
            }
          };
          // s_c, none for the last chunk: A[p][j] = q_j dt_j x[j][p],
          // B(j, n) = B[j][n]
          if (c + 1 < a.nb) {
            float acc[8][4] = {};
            mm<4, LV, NX>(
                acc, g0, 1, ge, 0, kq,
                [&](uint32_t (&o)[LV][4], int k) {
                  keys_scaled<NX, LV>(o, xs, lx, XSP, 16 * rg, k, wv);
                },
                [&](uint32_t (&f)[NX][4], int n0, int k) {
                  ldb_t_n<NX>(f, bs, lb, NPr, n0, k);
                });
            store(a.S, acc);
          }
          // r_c, none for the first: A[p][i] = e_i dy[i][p], B(i, n) =
          // C[i][n]
          if (c > 0) {
            float acc[8][4] = {};
            mm<4, LV, NX>(
                acc, g0, 1, ge, 0, kq,
                [&](uint32_t (&o)[LV][4], int k) {
                  keys_scaled<LV, LV>(o, dys, lx, XSP, 16 * rg, k, ev);
                },
                [&](uint32_t (&f)[NX][4], int n0, int k) {
                  ldb_t_n<NX>(f, cs, lb, NPr, n0, k);
                });
            store(a.R, acc);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// 2. the two passes over the chunks, elementwise
// ---------------------------------------------------------------------

template <typename T, int LV>
__global__ void __launch_bounds__(PASS_THR)
ssd_bwd_pass_kernel(const Args<T> a) {
  __shared__ float red[PASS_THR / 32];
  const long long bh = blockIdx.x / a.nz;
  const int z = blockIdx.x % a.nz;
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  const long long PN8 = (long long)a.P * a.N8;
  const long long e = (long long)z * PASS_TILE + PASS_EL * threadIdx.x;
  const bool in = e < PN8;               // PN8 is a multiple of 8
  const float* la = a.LA + bh * a.L;
  auto at = [&](int c) {
    return (((long long)b * a.nb + c) * a.H + h) * PN8 + e;
  };
  auto dec = [&](int c) { return expf(la[min(c * Q + Q, a.L) - 1]); };
  // 4 values as LV planes from plane `p0` on
  auto put4 = [&](int p0, long long o, const float (&v)[4]) {
    uint32_t s[LV][4];
    split_pair<LV>(v[0], v[1], s, 0);
    split_pair<LV>(v[2], v[3], s, 1);
#pragma unroll
    for (int l = 0; l < LV; ++l)
      *reinterpret_cast<uint2*>(a.hs + (p0 + l) * a.plane + o) =
          make_uint2(s[l][0], s[l][1]);
  };
  // forward: the state entering each chunk (none enters the first, and
  // the last chunk's s_c enters no state)
  float st[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c + 1 < a.nb; ++c) {
    if (!in) break;
    if (c > 0) put4(0, at(c), st);
    const float d = dec(c);
    const float4 s = __ldcg(reinterpret_cast<const float4*>(a.S + at(c)));
    st[0] = fmaf(st[0], d, s.x);
    st[1] = fmaf(st[1], d, s.y);
    st[2] = fmaf(st[2], d, s.z);
    st[3] = fmaf(st[3], d, s.w);
  }
  if (in && a.nb > 1) put4(0, at(a.nb - 1), st);
  // reverse: dh_out of each chunk, <dh_out, h_in>
  float gr[4] = {0.f, 0.f, 0.f, 0.f};
  if (in && a.dh != nullptr) {
    const long long p = e / a.N8;
    const int n = (int)(e - p * a.N8);
    const float* src = a.dh + (bh * a.P + p) * a.N + n;
    for (int k = 0; k < 4; ++k) gr[k] = n + k < a.N ? src[k] : 0.f;
  }
  const int wp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int c = a.nb - 1; c >= 0; --c) {
    float d = 0.f;
    if (in) {
      put4(LV, at(c), gr);
      if (c > 0) {                       // no state enters the first
        uint32_t v[2][LV];
#pragma unroll
        for (int l = 0; l < LV; ++l) {
          const uint2 u =
              *reinterpret_cast<const uint2*>(a.hs + l * a.plane + at(c));
          v[0][l] = u.x;
          v[1][l] = u.y;
        }
        const float2 h01 = join<LV>(v[0]), h23 = join<LV>(v[1]);
        d = fmaf(gr[0], h01.x, fmaf(gr[1], h01.y,
            fmaf(gr[2], h23.x, gr[3] * h23.y)));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (ln == 0) red[wp] = d;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < PASS_THR / 32; ++w) s += red[w];
      a.dlaq[(bh * a.nb + c) * a.nz + z] = s;
    }
    __syncthreads();
    if (in && c > 0) {
      const float dc = dec(c);
      const float4 r = __ldcg(reinterpret_cast<const float4*>(a.R + at(c)));
      gr[0] = fmaf(gr[0], dc, r.x);
      gr[1] = fmaf(gr[1], dc, r.y);
      gr[2] = fmaf(gr[2], dc, r.z);
      gr[3] = fmaf(gr[3], dc, r.w);
    }
  }
}

// ---------------------------------------------------------------------
// 3. each chunk's gradients, a group of heads a block
// ---------------------------------------------------------------------

template <typename T, int PT, int NT, int LV>
__global__ void __launch_bounds__(THR, NT <= 128 && LV == 2 ? 2 : 1)
ssd_bwd_chunk_kernel(const Args<T> a) {
  using K = Tile<PT, NT>;
  constexpr int NX = sizeof(T) == 4 ? LV : 1;
  constexpr int NP = K::NP, PP = K::PP, UP = K::UP, UN = K::UN;
  constexpr long long LB = (long long)Q * NP, LX = (long long)Q * PP;
  constexpr long long LU = K::uplane();
  extern __shared__ __align__(16) uint8_t raw[];
  bf16* bs = reinterpret_cast<bf16*>(raw);    // B, C, x: NX planes each
  bf16* cs = bs + NX * LB;
  bf16* xs = cs + NX * LB;
  bf16* dys = xs + NX * LX;                   // dy: LV planes
  bf16* us = dys + LV * LX;                   // the union: LV planes of a
                                              // state tile (PT x NP) or
                                              // of S1 / W (Q x QP)
  float* las = reinterpret_cast<float*>(us + LV * LU);
  float* dts = las + a.hg * Q;
  float* dla = dts + a.hg * Q;
  float* cols = dla + a.hg * Q;    // ddt's part before A R
  float* vts = cols + a.hg * Q;    // dt_j V_j
  float* rowp = vts + a.hg * Q;    // [2][Q] row sums of the halves
  float* colp = rowp + 2 * Q;      // [4][Q] column sums of the row tiles
  float* vp = colp + 4 * Q;        // [2][Q]

  const int grp = blockIdx.x % a.ngrp;
  const long long bc = blockIdx.x / a.ngrp;
  const int c = (int)(bc % a.nb), b = (int)(bc / a.nb);
  const int c0 = c * Q, cl = min(Q, a.L - c0), kq = up(cl, 16);
  const int h0 = grp * a.hg, nh = min(a.hg, a.H - h0);
  const int t = threadIdx.x, wp = t >> 5, ln = t & 31;
  const int g = ln >> 2, t4 = ln & 3, wr = wp & 3, hf = wp >> 2;
  const int m0 = 16 * wr;
  const int ia = m0 + g, ib = ia + 8;        // this thread's rows
  const int N16 = up(a.N, 16), ngn = N16 / 16;
  const bool has_h = c > 0;
  const bool has_d = c < a.nb - 1 || a.dh != nullptr;
  const long long PN8 = (long long)a.P * a.N8;

  stage<T, NX>(bs, LB, NP, Q, N16 / 8,
               a.B + b * a.bsb + (long long)c0 * a.bsl, a.bsl, cl, a.N,
               a.vb);
  stage<T, NX>(cs, LB, NP, Q, N16 / 8,
               a.C + b * a.csb + (long long)c0 * a.csl, a.csl, cl, a.N,
               a.vc);
  for (int e = t; e < nh * Q; e += THR) {
    const int s = e / Q, i = e - s * Q, h = h0 + s;
    las[e] = a.LA[((long long)b * a.H + h) * a.L + c0 + min(i, cl - 1)];
    dts[e] = i < cl ? a.dt[b * a.dsb + (long long)(c0 + i) * a.dsl + h]
                    : 0.f;
    dla[e] = 0.f;
    cols[e] = 0.f;
    vts[e] = 0.f;
  }
  __syncthreads();                     // la and dt are in
  auto stage_x = [&](int h, int p0, int Pl, int P16) {
    stage<T, NX>(xs, LX, PP, Q, P16 / 8,
                 a.x + b * a.xsb + (long long)c0 * a.xsl +
                     (long long)h * a.P + p0,
                 a.xsl, cl, Pl, a.vx);
  };
  auto stage_dy = [&](int h, int p0, int Pl, int P16) {
    stage<float, LV>(dys, LX, PP, Q, P16 / 8,
                     a.dy + (((long long)b * a.L + c0) * a.H + h) * a.P + p0,
                     (long long)a.H * a.P, cl, Pl, a.vy);
  };
  // the state tile of (b, c, h), rows p0 .. p0 + Pl, planes k0 .. k0 +
  // LV - 1 of the scratch, into the union
  auto stage_state = [&](int k0, int h, int p0, int Pl, int P16) {
    const long long so =
        (((long long)b * a.nb + c) * a.H + h) * PN8 + (long long)p0 * a.N8;
#pragma unroll
    for (int l = 0; l < LV; ++l)
      tile_cp(us + l * LU, NP, P16, N16 / 8, a.hs + (k0 + l) * a.plane + so,
              a.N8, Pl, a.N8 / 8);
    cp_commit();
  };
  // the 16-row sums of the halves -> part[hf][row]
  auto rows_out = [&](float* part, float va, float vb) {
    va = quad_sum(va);
    vb = quad_sum(vb);
    if (t4 == 0) {
      part[hf * Q + ia] = va;
      part[hf * Q + ib] = vb;
    }
  };
  // S1 / W as LV terms into the union (rows i, columns j, j + 1)
  auto put_q = [&](int i, int j, float v0, float v1) {
    uint32_t o[LV][4];
    split_pair<LV>(v0, v1, o, 0);
#pragma unroll
    for (int l = 0; l < LV; ++l)
      *reinterpret_cast<uint32_t*>(us + l * LU + i * QP + j) = o[l][0];
  };
  // fragments: B of the state tile, B(k=n, p) = h[p][n] / B(k=p, n);
  // A of S1 / W, A[j][i] = W[i][j] / A[i][j] = W[i][j]; A of a row tile
  // of B, C, x or dy scaled by row
  auto fb_state = [&](uint32_t (&f)[LV][4], int n0, int k) {
    ldb_n<LV>(f, us, LU, NP, n0, k);
  };
  auto fb_state_t = [&](uint32_t (&f)[LV][4], int n0, int k) {
    ldb_t_n<LV>(f, us, LU, NP, n0, k);
  };
  auto fa_q_t = [&](uint32_t (&f)[LV][4], int k) {
    lda_t_n<LV>(f, us, LU, QP, m0, k);
  };
  auto fa_q = [&](uint32_t (&f)[LV][4], int k) {
    lda_n<LV>(f, us, LU, QP, m0, k);
  };

  // ---- per head: S1, W, S3, dx; dh_out's terms -------------------------
  float sw[4][4] = {};                 // W summed over the group
  float dbacc[2 * UN][4] = {};         // dB: rows j, columns of N
  for (int s = 0; s < nh; ++s) {
    const int h = h0 + s;
    const float* la = las + s * Q;
    const float* dtv = dts + s * Q;
    const float laq = la[cl - 1];
    for (int p0 = 0; p0 < a.P; p0 += PT) {
      const int Pl = min(PT, a.P - p0), P16 = up(Pl, 16), ngp = P16 / 16;
      __syncthreads();                 // x, dy, the union are free
      stage_x(h, p0, Pl, P16);
      stage_dy(h, p0, Pl, P16);
      __syncthreads();
      // G = C B^T and M = dy x^T, the tiles with a key j <= row i
      float gq[4][4] = {}, mq[4][4] = {};
      mm<2, NX, NX>(
          gq, hf, 2, wr + 1, 0, N16,
          [&](uint32_t (&f)[NX][4], int k) {
            lda_n<NX>(f, cs, LB, NP, m0, k);
          },
          [&](uint32_t (&f)[NX][4], int n0, int k) {
            ldb_n<NX>(f, bs, LB, NP, n0, k);
          });
      mm<2, LV, NX>(
          mq, hf, 2, wr + 1, 0, P16,
          [&](uint32_t (&f)[LV][4], int k) {
            lda_n<LV>(f, dys, LX, PP, m0, k);
          },
          [&](uint32_t (&f)[NX][4], int n0, int k) {
            ldb_n<NX>(f, xs, LX, PP, n0, k);
          });
      float rs[2] = {0.f, 0.f}, cs_[4][2] = {};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int gi = hf + 2 * u;
        if (gi > wr) break;
#pragma unroll
        for (int s8 = 0; s8 < 2; ++s8) {
          const int n = 2 * u + s8, j = 16 * gi + 8 * s8 + 2 * t4;
          float s1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, jj = j + (e & 1);
            const float D = jj <= i && i < cl ? expf(la[i] - la[jj]) : 0.f;
            const float m = mq[n][e];
            s1[e] = gq[n][e] * D;
            const float s3 = s1[e] * m;
            sw[n][e] = fmaf(D * dtv[jj], m, sw[n][e]);
            rs[e >> 1] = fmaf(s3, dtv[jj], rs[e >> 1]);
            cs_[n][e & 1] += s3;
          }
          put_q(ia, j, s1[0], s1[1]);
          put_q(ib, j, s1[2], s1[3]);
        }
      }
      rows_out(rowp, rs[0], rs[1]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = cs_[n][q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0)
            colp[wr * Q + 16 * (hf + 2 * (n >> 1)) + 8 * (n & 1) + 2 * t4 +
                 q] = v;
        }
      __syncthreads();                 // S1 and the partial sums are in
      if (t < Q) {
        const float r_ = rowp[t] + rowp[Q + t];
        const float c_ = colp[t] + colp[Q + t] + colp[2 * Q + t] +
                         colp[3 * Q + t];
        dla[s * Q + t] += r_ - dtv[t] * c_;
        cols[s * Q + t] += c_;
      }
      // S1^T dy: rows j, the keys i >= j
      float dxa[2 * UP][4] = {};
      mm<UP, LV, LV>(dxa, hf, 2, ngp, m0, kq, fa_q_t,
                     [&](uint32_t (&f)[LV][4], int n0, int k) {
                       ldb_t_n<LV>(f, dys, LX, PP, n0, k);
                     });
      // the thread's rows j: q_j, q_j dt_j
      float qj[2], sc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = r ? ib : ia;
        qj[r] = j < cl ? expf(laq - la[j]) : 0.f;
        sc[r] = qj[r] * dtv[j];
      }
      float bd[2 * UP][4] = {};
      if (has_d) {
        __syncthreads();               // S1 is read
        stage_state(LV, h, p0, Pl, P16);
        cp_wait<0>();
        __syncthreads();
        // B dh_out^T: rows j, columns p
        mm<UP, NX, LV>(
            bd, hf, 2, ngp, 0, N16,
            [&](uint32_t (&f)[NX][4], int k) {
              lda_n<NX>(f, bs, LB, NP, m0, k);
            },
            fb_state);
      }
      // dx = dt_j (S1^T dy + q_j B dh_out^T); V's partial sums
      float vs[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < UP; ++u) {
        const int gi = hf + 2 * u;
        if (gi >= ngp) break;
#pragma unroll
        for (int s8 = 0; s8 < 2; ++s8) {
          const int n = 2 * u + s8, p = 16 * gi + 8 * s8 + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = r ? ib : ia;
            const float2 xv = pair_at<NX>(xs, LX, j * PP + p);
            const float b0 = bd[n][2 * r], b1 = bd[n][2 * r + 1];
            vs[r] = fmaf(xv.x, b0, fmaf(xv.y, b1, vs[r]));
            if (j >= cl) continue;
            const float d0 = fmaf(dtv[j], dxa[n][2 * r], sc[r] * b0);
            const float d1 = fmaf(dtv[j], dxa[n][2 * r + 1], sc[r] * b1);
            T* o = a.dx + (((long long)b * a.L + c0 + j) * a.H + h) * a.P +
                   p0 + p;
            if (p < Pl) put(o, d0);
            if (p + 1 < Pl) put(o + 1, d1);
          }
        }
      }
      if (!has_d) continue;
      rows_out(vp, vs[0], vs[1]);
      // dB += (q dt o x) dh_out: rows j, columns n
      const float2 xsc[4] = {make_float2(sc[0], sc[0]),
                             make_float2(sc[1], sc[1]),
                             make_float2(sc[0], sc[0]),
                             make_float2(sc[1], sc[1])};
      mm<UN, LV, LV>(
          dbacc, hf, 2, ngn, 0, P16,
          [&](uint32_t (&f)[LV][4], int k) {
            uint32_t in[NX][4];
            lda_n<NX>(in, xs, LX, PP, m0, k);
            rescale<NX, LV>(in, f, xsc);
          },
          fb_state_t);
      __syncthreads();                 // V's partial sums are in
      if (t < Q) {
        const float q_ = t < cl ? expf(laq - la[t]) : 0.f;
        const float V = q_ * (vp[t] + vp[Q + t]);
        cols[s * Q + t] += V;
        vts[s * Q + t] = fmaf(dtv[t], V, vts[s * Q + t]);
      }
    }
  }

  // ---- the group's W: dB += W^T C, then dC = W B -----------------------
  __syncthreads();                     // the union is free
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int gi = hf + 2 * u;
    if (gi > wr) break;
#pragma unroll
    for (int s8 = 0; s8 < 2; ++s8) {
      const int n = 2 * u + s8, j = 16 * gi + 8 * s8 + 2 * t4;
      put_q(ia, j, sw[n][0], sw[n][1]);
      put_q(ib, j, sw[n][2], sw[n][3]);
    }
  }
  __syncthreads();
  mm<UN, LV, NX>(dbacc, hf, 2, ngn, m0, kq, fa_q_t,
                 [&](uint32_t (&f)[NX][4], int n0, int k) {
                   ldb_t_n<NX>(f, cs, LB, NP, n0, k);
                 });
  // a head group's dB / dC: rows of the chunk, columns of N
  auto store_part = [&](float* part, const float (&acc)[2 * UN][4]) {
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int gi = hf + 2 * u;
      if (gi >= ngn) break;
#pragma unroll
      for (int s8 = 0; s8 < 2; ++s8) {
        const int n = 16 * gi + 8 * s8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r ? ib : ia;
          if (i >= cl) continue;
          float* o = part + (((long long)b * a.L + c0 + i) * a.ngrp + grp) *
                                a.N + n;
          if (n < a.N) o[0] = acc[2 * u + s8][2 * r];
          if (n + 1 < a.N) o[1] = acc[2 * u + s8][2 * r + 1];
        }
      }
    }
  };
  store_part(a.dbp, dbacc);
  float dcacc[2 * UN][4] = {};
  mm<UN, LV, NX>(dcacc, hf, 2, ngn, 0, min(m0 + 16, kq), fa_q,
                 [&](uint32_t (&f)[NX][4], int n0, int k) {
                   ldb_t_n<NX>(f, bs, LB, NP, n0, k);
                 });

  // ---- per head: h_in's terms ------------------------------------------
  if (has_h) {
    for (int s = 0; s < nh; ++s) {
      const int h = h0 + s;
      const float* la = las + s * Q;
      float ei[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ib : ia;
        ei[r] = i < cl ? expf(la[i]) : 0.f;
      }
      const float2 ysc[4] = {make_float2(ei[0], ei[0]),
                             make_float2(ei[1], ei[1]),
                             make_float2(ei[0], ei[0]),
                             make_float2(ei[1], ei[1])};
      for (int p0 = 0; p0 < a.P; p0 += PT) {
        const int Pl = min(PT, a.P - p0), P16 = up(Pl, 16), ngp = P16 / 16;
        __syncthreads();               // dy and the union are free
        stage_state(0, h, p0, Pl, P16);
        stage_dy(h, p0, Pl, P16);
        cp_wait<0>();
        __syncthreads();
        // C h_in^T: rows i, columns p; then dy_i . (C h_in^T)_i
        float chq[2 * UP][4] = {};
        mm<UP, NX, LV>(
            chq, hf, 2, ngp, 0, N16,
            [&](uint32_t (&f)[NX][4], int k) {
              lda_n<NX>(f, cs, LB, NP, m0, k);
            },
            fb_state);
        float ds[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < UP; ++u) {
          const int gi = hf + 2 * u;
          if (gi >= ngp) break;
#pragma unroll
          for (int s8 = 0; s8 < 2; ++s8) {
            const int n = 2 * u + s8, p = 16 * gi + 8 * s8 + 2 * t4;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = r ? ib : ia;
              const float2 yv = pair_at<LV>(dys, LX, i * PP + p);
              ds[r] = fmaf(yv.x, chq[n][2 * r],
                           fmaf(yv.y, chq[n][2 * r + 1], ds[r]));
            }
          }
        }
        rows_out(vp, ds[0], ds[1]);
        // dC += (e o dy) h_in: rows i, columns n
        mm<UN, LV, LV>(
            dcacc, hf, 2, ngn, 0, P16,
            [&](uint32_t (&f)[LV][4], int k) {
              uint32_t in[LV][4];
              lda_n<LV>(in, dys, LX, PP, m0, k);
              rescale<LV, LV>(in, f, ysc);
            },
            fb_state_t);
        __syncthreads();               // the partial sums are in
        if (t < Q)
          dla[s * Q + t] +=
              (t < cl ? expf(la[t]) : 0.f) * (vp[t] + vp[Q + t]);
      }
    }
  }
  store_part(a.dcp, dcacc);
  __syncthreads();                     // dla and ddt's column part are in

  // ---- la's gradient to dt and A: the cumsum's transpose ---------------
  for (int s = wp; s < nh; s += THR / 32) {
    const int h = h0 + s;
    const long long bhc = ((long long)b * a.H + h) * a.nb + c;
    float dq = 0.f;
    for (int z = 0; z < a.nz; ++z) dq += a.dlaq[bhc * a.nz + z];
    dq *= expf(las[s * Q + cl - 1]);
    const int i0 = 2 * ln;
    float d0 = dla[s * Q + i0], d1 = dla[s * Q + i0 + 1];
    if (i0 == cl - 1) d0 += dq;
    if (i0 + 1 == cl - 1) d1 += dq;
    const float v0 = vts[s * Q + i0], v1 = vts[s * Q + i0 + 1];
    float inc = d0 + d1, pre = v0 + v1;  // suffix sums of dla, prefix
#pragma unroll                            // sums of dt V over the lanes
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, inc, off);
      const float u = __shfl_up_sync(0xffffffffu, pre, off);
      if (ln + off < 32) inc += o;
      if (ln >= off) pre += u;
    }
    float after = __shfl_down_sync(0xffffffffu, inc, 1);
    float before = __shfl_up_sync(0xffffffffu, pre, 1);
    if (ln == 31) after = 0.f;
    if (ln == 0) before = 0.f;
    const float s1 = after + d1;
    const float R1 = s1 + (before + v0), R0 = (s1 + d0) + before;
    const float A = a.A[h];
    float* o = a.ddt + ((long long)b * a.L + c0 + i0) * a.H + h;
    if (i0 < cl) o[0] = fmaf(A, R0, cols[s * Q + i0]);
    if (i0 + 1 < cl) o[a.H] = fmaf(A, R1, cols[s * Q + i0 + 1]);
    float da = fmaf(dts[s * Q + i0], R0, dts[s * Q + i0 + 1] * R1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      da += __shfl_xor_sync(0xffffffffu, da, off);
    if (ln == 0) a.dap[((long long)b * a.nb + c) * a.H + h] = da;
  }
}

// ---------------------------------------------------------------------
// 4. dB and dC over the head groups, dA over batches and chunks
// ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128)
ssd_bwd_reduce_kernel(const float* __restrict__ dbp,
                      const float* __restrict__ dcp,
                      const float* __restrict__ dap, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ dA, int Bb,
                      int L, int H, int N, int nb, int ngrp) {
  const long long row = blockIdx.x;          // (batch, position)
  if (row == (long long)Bb * L) {            // the last block: dA
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (long long bc = 0; bc < (long long)Bb * nb; ++bc)
        s += dap[bc * H + h];
      dA[h] = s;
    }
    return;
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int gr = 0; gr < ngrp; ++gr) {
      sb += dbp[(row * ngrp + gr) * N + n];
      sc += dcp[(row * ngrp + gr) * N + n];
    }
    put(dB + row * N + n, sb);
    put(dC + row * N + n, sc);
  }
}

template <typename T, int PT, int NT, int LV>
cudaError_t run(const Args<T>& a, int Bb, T* dB, T* dC, float* dA,
                cudaStream_t s) {
  // opt in once (later launches may be under CUDA-graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_state_kernel<T, LV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, PT, NT, LV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_OPTIN);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  constexpr int NX = sizeof(T) == 4 ? LV : 1;
  const long long blocks = (long long)Bb * a.nb * a.ngrp;
  const long long pass = (long long)Bb * a.H * a.nz;
  if (blocks > 0x7fffffffLL || pass > 0x7fffffffLL ||
      (long long)Bb * a.L + 1 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  ssd_bwd_state_kernel<T, LV><<<(unsigned)blocks, THR,
                                (int)state_smem(NX, LV, a.N), s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass_kernel<T, LV><<<(unsigned)pass, PASS_THR, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, PT, NT, LV><<<
      (unsigned)blocks, THR, (int)Tile<PT, NT>::smem(NX, LV, a.hg), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((long long)Bb * a.L + 1), 128, 0,
                             s>>>(a.dbp, a.dcp, a.dap, dB, dC, dA, Bb, a.L,
                                  a.H, a.N, a.nb, a.ngrp);
  return cudaGetLastError();
}

// bytes of the larger block at head groups of hg, -1 past WIDE_N
inline long long smem(bool lo, int N, int hg) {
  const int lv = levels(lo, N), nx = lo ? lv : 1;
  const long long st = state_smem(nx, lv, N);
  const long long ch = up(N, 16) <= 128 ? Tile<64, 128>::smem(nx, lv, hg)
                       : up(N, 16) <= WIDE_N
                           ? Tile<16, WIDE_N>::smem(nx, lv, hg)
                           : -1;
  return ch < 0 ? -1 : (st > ch ? st : ch);
}

template <typename T>
cudaError_t launch(const Args<T>& a, int Bb, T* dB, T* dC, float* dA,
                   cudaStream_t s) {
  constexpr bool lo = sizeof(T) == 4;
  const long long need = smem(lo, a.N, a.hg);
  if (need < 0 || need > SMEM_OPTIN || a.hg < 1 || a.hg > HG)
    return cudaErrorInvalidValue;
  if (up(a.N, 16) > 128) return run<T, 16, WIDE_N, 2>(a, Bb, dB, dC, dA, s);
  return run<T, 64, 128, levels(lo, 128)>(a, Bb, dB, dC, dA, s);
}

}  // namespace ssd_bwd
