// Mamba2 SSD (state-space duality) chunked scan.
//
// Replaces the Pallas TPU kernel ssd_scan_pallas
// (src/repro/kernels/ssd_scan.py).  Same contract as the JAX package's
// ref.ssd_scan: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t . h_t,
// evaluated a chunk at a time -- la = cumsum(dt A) inside the chunk,
// y_i = exp(la_i) C_i . h  +  sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j,
// h' = exp(la_last) h + sum_j exp(la_last - la_j) dt_j x_j B_j^T -- with
// x (Bb, L, H, P), dt (Bb, L, H), A (H,), B / C (Bb, L, N) shared by the
// heads, h0 (Bb, H, P, N) or none; y (Bb, L, H, P) and h_final in f32.
// A ragged last chunk is cut short, which is what the TPU kernel's
// dt = 0 padding amounts to (unit decay, no input).  x, B and C may be
// f32 or bf16 and strided along (batch, position), as the model's
// split of its projection gives them.  Any P and N: the products work on
// tiles of 64 (P) x 128 (N), zero-padded inside the kernel; a larger P
// puts more blocks on the grid (the state and the outputs split over
// P), a larger N splits the state too and is summed over inside C B^T
// and C . h.  TL, a template flag, is set where P > 64, N > 128 or
// Bb x chunks > 65535: those kernels take a one-axis grid (x, up to
// 2^31 - 1 blocks), so no count of batches, chunks or heads meets the
// 65535 limit of y and z.  A shape of one tile within that limit runs
// the TL = false kernels, whose tile offsets are constants and whose
// grids put Bb (x chunks) on z.
//
// What bounds it on an H100: at the mamba2-1.3b prefill (Bb=16, L=512,
// H=64, P=64, N=128, chunk 256; bf16 x, B, C, no h0) the bytes are
// ~241 MB (x 67 MB in, y 134 MB and h_final 34 MB out), 72 us at
// 3.35 TB/s; the tensor-core products (each f32 operand with its
// split's multiple, below) are ~43 GFLOP, 44 us at 989 TFLOP/s: bytes.
// With f32 operands and an h0 the bytes are ~346 MB (103 us) and the
// products ~78 GFLOP (79 us): bytes.  Scratch traffic on top: each
// chunk's state out and back (f32), the state entering it (bf16 hi and
// lo), C B^T (8 MB, read from L2).
//
// Design: the one sequential axis is the chunk axis, and it carries only
// a (P, N) state, so the scan runs over all (batch, chunk, head) at once
// in three launches (four with f32 operands):
//  0. (f32 operands, or bf16 ones whose rows are not on 16 bytes)
//     ssd_split_kernel writes x, B and C once as contiguous bf16 planes,
//     an f32 value v as hi = bf16(v) and lo = bf16(v - hi), zero-padded
//     to a multiple of 8 columns.  The served bf16 views are used as
//     they are.
//  1. ssd_cb_kernel: G = C B^T once per (batch, chunk) -- B and C are
//     shared by the heads -- in 64 x 64 tensor-core tiles of the causal
//     triangle, into an f32 scratch that stays in L2.
//  2. ssd_state_kernel, grid H x state tiles x chunks x Bb: the chunk's
//     log-decay cumsum (a warp scan; la and dt are written out
//     head-major for launch 3) and its own state s_c = sum_j w_j x_j
//     B_j^T, w_j = exp(la_last - la_j) dt_j: a (P x chunk) . (chunk x N)
//     tensor-core product, w_j applied to the x fragments in registers
//     (then split), into an f32 scratch.  The block that finishes a
//     (batch, head, state tile) last (a ticket counter; no block waits)
//     passes that tile of the state over its chunks in order, h_c =
//     exp(la_last,c) h_{c-1} + s_c, writes the state entering each chunk
//     as bf16 hi/lo planes and h_final.
//  3. ssd_out_kernel, grid query tiles of 128 x H x P tiles x chunks x
//     Bb, 8 warps of 16 rows: the inter-chunk term exp(la_i) C_i .
//     h_in^T, then per key tile of 64 the G rows, masked and decayed in
//     registers (exp(la_i - la_j) dt_j, formed only where j <= i),
//     split, and y += S x_j.  y is written once.
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by
// ldmatrix from padded shared-memory rows that 16-byte cp.async copies
// fill; the key tiles of launches 2 and 3 are a two-deep ring, the next
// tile's copies in flight while the tensor cores work on this one.  An
// f32 operand is two bf16 products (hi, lo) against a bf16 one and three
// (hi.hi + lo.hi + hi.lo) against another f32 one: what is dropped is
// ~2^-16 of each term.  No atomics in any sum, a fixed order: the same
// bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PT = 64;           // head-dim tile (P padded)
constexpr int NT = 128;          // state tile (N padded)
constexpr int KT = 64;           // keys per tile
constexpr int QT = 128;          // query rows per output block
constexpr int ST_THR = 256;      // state kernel: 8 warps, 16 rows of P x
                                 // half of N each
constexpr int OUT_THR = 256;     // output kernel: 8 warps x 16 query rows
constexpr int PP = PT + 8;       // bf16 pitch of a PT-wide row: the 8 rows
constexpr int NP = NT + 8;       // of an ldmatrix hit distinct banks
constexpr int PASS = 16;         // state elements in flight per thread
constexpr int GP = KT + 8;       // f32 pitch of a C B^T tile row in shared
                                 // memory: a half-warp's float2 reads hit
                                 // distinct banks
constexpr int SMEM_OPTIN = 232448 - 1024;  // the card's 227 KB less room
                                            // for static shared memory

static_assert(ST_THR / 32 / 2 * 16 == PT && OUT_THR / 32 * 16 == QT,
              "a warp owns 16 rows");

__host__ __device__ constexpr int up(int n, int m) {
  return (n + m - 1) / m * m;
}

// the state kernel's key tile: B rows (KT x NP, hi [and lo]), then x
// rows (KT x PP, hi [and lo]); lo where the operands carry lo planes
__host__ __device__ constexpr int tile_bytes(bool lo) {
  return (lo ? 2 : 1) * KT * (NP + PP) * 2;
}

// the output kernel's key tile: C B^T rows (QT x GP, f32) then x rows
// (KT x PP, bf16 hi [, lo])
__host__ __device__ constexpr int gtile_bytes(bool lo) {
  return QT * GP * 4 + (lo ? 2 : 1) * KT * PP * 2;
}

// the output kernel's start: C rows (QT x NP) and h_in (PT x NP), hi
// [and lo]; then the same memory holds two key tiles
__host__ __device__ constexpr int out_region(bool lo) {
  return (lo ? 2 : 1) * QT * NP * 2 + 2 * PT * NP * 2 > 2 * gtile_bytes(lo)
             ? (lo ? 2 : 1) * QT * NP * 2 + 2 * PT * NP * 2
             : 2 * gtile_bytes(lo);
}

// dynamic shared memory, bytes: two key tiles and la, dt, w
__host__ __device__ constexpr int state_smem(bool lo, int chunk) {
  return 2 * tile_bytes(lo) + 4 * (2 * chunk + up(chunk, KT));
}

__host__ __device__ constexpr int out_smem(bool lo, int chunk) {
  return out_region(lo) + 2 * 4 * chunk;
}

// C B^T tiles of 64 x 64: C rows and B rows, hi [and lo]
__host__ __device__ constexpr int cb_smem(bool lo) {
  return (lo ? 2 : 1) * 2 * KT * NP * 2;
}

// a bf16 operand: element (b, l, [head,] col) at hi + b sb + l sl
// [+ head hs] + col; lo (null for bf16 sources) holds v - hi
struct Plane {
  const bf16* hi;
  const bf16* lo;
  long long sb, sl;
  int hs;
};

// ---------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `full` false writes 16 zero bytes
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, ROWS) x 16-byte granules [0, WG) of a tile with row pitch
// `pitch`: row r < nr, granule q < ng from src + r srow + 8 q, the rest
// zero.  Every copy is issued before any is waited for.
template <int ROWS, int WG, int NTHR>
__device__ __forceinline__ void tile_async(bf16* dst, int pitch,
                                           const bf16* src, long long srow,
                                           int nr, int ng) {
  static_assert(ROWS * WG % NTHR == 0, "whole copies per thread");
#pragma unroll
  for (int k = 0; k < ROWS * WG / NTHR; ++k) {
    const int e = threadIdx.x + k * NTHR;
    const int r = e / WG, q = e % WG;
    const bool in = r < nr && q < ng;
    cp16(dst + r * pitch + 8 * q, in ? src + r * srow + 8 * q : src, in);
  }
}

// the arrays of one state-kernel key tile (tile_bytes)
struct Tile {
  bf16 *bh, *bl, *xh, *xl;
  template <bool LO>
  __device__ static Tile at(uint8_t* p) {
    bf16* b = reinterpret_cast<bf16*>(p);
    const int cs = LO ? 2 : 1;
    return Tile{b, b + KT * NP, b + cs * KT * NP, b + cs * KT * NP + KT * PP};
  }
};

// keys [j0, j0 + nk) of B and of x's head (offsets bo, xo) into a tile
template <bool LO, int NTHR>
__device__ __forceinline__ void load_keys(Tile d, const Plane& xq,
                                          const Plane& bq, long long xo,
                                          long long bo, int j0, int nk,
                                          int P, int N8) {
  tile_async<KT, NT / 8, NTHR>(d.bh, NP, bq.hi + bo + j0 * bq.sl, bq.sl, nk,
                               N8 / 8);
  tile_async<KT, PT / 8, NTHR>(d.xh, PP, xq.hi + xo + j0 * xq.sl, xq.sl, nk,
                               (P + 7) / 8);
  if (LO) {
    tile_async<KT, NT / 8, NTHR>(d.bl, NP, bq.lo + bo + j0 * bq.sl, bq.sl,
                                 nk, N8 / 8);
    tile_async<KT, PT / 8, NTHR>(d.xl, PP, xq.lo + xo + j0 * xq.sl, xq.sl,
                                 nk, (P + 7) / 8);
  }
  cp_commit();
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).  Fragment
// layout (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8..,
// n g); d0 d1 (g, 2t..2t+1), d2 d3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of rows m0.., k0.. where A[m][k] = s[m][k]
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* s,
                                    int pitch, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(a, s + (m0 + (l & 15)) * pitch + k0 + 8 * (l >> 4));
}

// A fragment where A[m][k] = s[k][m]
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* s,
                                      int pitch, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4_t(a, s + (k0 + (l & 7) + 8 * (l >> 4)) * pitch + m0 +
                 8 * ((l >> 3) & 1));
}

// B fragments of n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at
// k0.., where B(k, n) = s[n][k]
__device__ __forceinline__ void ldb(uint32_t (&b)[4], const bf16* s,
                                    int pitch, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(b, s + (n0 + (l & 7) + 8 * (l >> 4)) * pitch + k0 +
               8 * ((l >> 3) & 1));
}

// the same where B(k, n) = s[k][n]
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], const bf16* s,
                                      int pitch, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4_t(b, s + (k0 + (l & 7) + 8 * ((l >> 3) & 1)) * pitch + n0 +
                 8 * (l >> 4));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// hi = bf16(v), lo = bf16(v - hi) of a pair, packed as a fragment
// register (first element in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// inclusive cumsum of dt * a over [0, cl), by one warp
__device__ __forceinline__ void chunk_cumsum(float* la, const float* dts,
                                             float a, int cl) {
  const int ln = threadIdx.x & 31;
  const int seg = (cl + 31) / 32;
  const int i0 = ln * seg, i1 = min(i0 + seg, cl);
  float run = 0.f;
  for (int i = i0; i < i1; ++i) {
    run += dts[i] * a;
    la[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (ln >= off) incl += o;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (ln == 0) before = 0.f;
  for (int i = i0; i < i1; ++i) la[i] += before;
}

// ---------------------------------------------------------------------
// 0. f32 (or unaligned) operands -> contiguous bf16 hi / lo planes
// ---------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// reps rows of n values (row stride rs) -> reps rows of n8 (zero-padded)
template <typename T>
__device__ __forceinline__ void split_rows(const T* src, int n, int n8,
                                           int reps, int rs, bf16* hi,
                                           bf16* lo) {
  for (int e = threadIdx.x; e < reps * n8; e += blockDim.x) {
    const int r = e / n8, c = e - r * n8;
    const float v = c < n ? to_f(src[(long long)r * rs + c]) : 0.f;
    const bf16 h = __float2bfloat16_rn(v);
    hi[e] = h;
    if (lo) lo[e] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// grid L x Bb: one (batch, position) row of x (H heads), B and C
template <typename T>
__global__ void __launch_bounds__(256)
ssd_split_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, long long xsb, long long xsl,
                 long long bsb, long long bsl, long long csb, long long csl,
                 int L, int H, int P, int N, int P8, int N8, bf16* xh,
                 bf16* xl, bf16* bh, bf16* bl, bf16* ch, bf16* cl) {
  const long long row = blockIdx.x;            // b L + l
  const int l = (int)(row % L), b = (int)(row / L);
  const long long ox = row * H * P8, on = row * N8;
  split_rows(x + b * xsb + l * xsl, P, P8, H, P, xh + ox,
             xl ? xl + ox : xl);
  split_rows(Bm + b * bsb + l * bsl, N, N8, 1, 0, bh + on,
             bl ? bl + on : bl);
  split_rows(Cm + b * csb + l * csl, N, N8, 1, 0, ch + on,
             cl ? cl + on : cl);
}

// ---------------------------------------------------------------------
// 2. each chunk's own state, then (last block of a (batch, head)) the
//    state passing
// ---------------------------------------------------------------------

template <bool LO, bool TL>
__global__ void __launch_bounds__(ST_THR, 2)
ssd_state_kernel(Plane xq, Plane bq, const float* __restrict__ dt,
                 long long dsb, long long dsl, const float* __restrict__ A,
                 const float* __restrict__ h0, float* __restrict__ LA,
                 float* __restrict__ DTT, float* __restrict__ S,
                 bf16* __restrict__ hin_hi, bf16* __restrict__ hin_lo,
                 float* __restrict__ hf, unsigned* __restrict__ tickets,
                 int L, int H, int P, int N, int chunk, int nc, int nnt,
                 int ntile) {
  extern __shared__ __align__(16) uint8_t raw[];
  const Tile t0 = Tile::at<LO>(raw);        // key tiles, even and odd
  const Tile t1 = Tile::at<LO>(raw + tile_bytes(LO));
  float* la = reinterpret_cast<float*>(raw + 2 * tile_bytes(LO));
  float* dts = la + chunk;
  float* wj = dts + chunk;                   // up(chunk, KT), zero tail
  __shared__ unsigned ticket;

  // TL: block x = ((b nc + c) ntile + tile) H + h; tile = pt nnt + nt,
  // the state's rows p0 .. p0 + 63 and columns n0 .. n0 + 127; else the
  // grid is (H, nc, Bb)
  int h, c, b, tile = 0;
  if constexpr (TL) {
    unsigned bx = blockIdx.x;
    h = bx % H;
    bx /= H;
    tile = bx % ntile;
    bx /= ntile;
    c = bx % nc;
    b = bx / nc;
  } else {
    h = blockIdx.x;
    c = blockIdx.y;
    b = blockIdx.z;
  }
  const int p0 = TL ? tile / nnt * PT : 0, n0 = TL ? tile % nnt * NT : 0;
  const int t = threadIdx.x, wp = t >> 5, ln = t & 31;
  const int g = ln >> 2, t4 = ln & 3;
  const int pr = wp & 3, nh = wp >> 2;       // rows 16 pr.., columns 64 nh..
  const int c0 = c * chunk, cl = min(chunk, L - c0);
  const int N8 = up(N, 8);
  const int Pl = TL ? min(PT, P - p0) : P, Nl = TL ? min(NT, N - n0) : N;
  const int Nl8 = TL ? min(NT, N8 - n0) : N8;  // this tile's columns
  const long long xo =
      b * xq.sb + (long long)c0 * xq.sl + (long long)h * xq.hs + p0;
  const long long bo = b * bq.sb + (long long)c0 * bq.sl + n0;
  const int ntiles = (cl + KT - 1) / KT;
  load_keys<LO, ST_THR>(t0, xq, bq, xo, bo, 0, min(KT, cl), Pl, Nl8);

  const float* dg = dt + b * dsb + (long long)c0 * dsl + h;
  for (int i = t; i < cl; i += ST_THR) dts[i] = dg[(long long)i * dsl];
  __syncthreads();
  if (wp == 0) chunk_cumsum(la, dts, A[h], cl);
  __syncthreads();
  const float lal = la[cl - 1];
  const long long hrow = ((long long)b * H + h) * L + c0;
  for (int i = t; i < up(cl, KT); i += ST_THR) {
    wj[i] = i < cl ? expf(lal - la[i]) * dts[i] : 0.f;
    if (i < cl) {
      LA[hrow + i] = la[i];
      DTT[hrow + i] = dts[i];
    }
  }

  float acc[NT / 16][4];
#pragma unroll
  for (int n = 0; n < NT / 16; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nnp = (Nl + 15) / 16;            // 16-wide state tiles in use
  const bool live = 16 * pr < Pl && 64 * nh < Nl;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * KT, nk = min(KT, cl - j0);
    __syncthreads();                         // wj written / buffer free
    if (jt + 1 < ntiles) {
      load_keys<LO, ST_THR>(jt & 1 ? t0 : t1, xq, bq, xo, bo, j0 + KT,
                            min(KT, cl - j0 - KT), Pl, Nl8);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (!live) continue;
    const Tile tl = jt & 1 ? t1 : t0;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (16 * kk >= nk) break;
      // A[p][j] = w_j x[j][p]: the x fragment scaled in registers, then
      // split; a0/a1 hold keys 2t, 2t+1, a2/a3 keys 2t+8, 2t+9
      uint32_t ah[4], al[4];
      lda_t(ah, tl.xh, PP, 16 * pr, 16 * kk);
      if (LO) lda_t(al, tl.xl, PP, 16 * pr, 16 * kk);
      const float* wk = wj + j0 + 16 * kk + 2 * t4;
      const float2 w01 = make_float2(wk[0], wk[1]);
      const float2 w89 = make_float2(wk[8], wk[9]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float2 v = unpack(ah[r]);
        if (LO) {
          const float2 u = unpack(al[r]);
          v.x += u.x;
          v.y += u.y;
        }
        const float2 w = r < 2 ? w01 : w89;
        split2(v.x * w.x, v.y * w.y, ah[r], al[r]);
      }
#pragma unroll
      for (int np = 0; np < NT / 32; ++np) {
        const int n0 = 64 * nh + 16 * np;
        if (4 * nh + np >= nnp) break;
        uint32_t f[4];
        ldb_t(f, tl.bh, NP, n0, 16 * kk);    // B(j, n) = B[j][n]
        mma(acc[2 * np], ah, f[0], f[1]);
        mma(acc[2 * np + 1], ah, f[2], f[3]);
        mma(acc[2 * np], al, f[0], f[1]);
        mma(acc[2 * np + 1], al, f[2], f[3]);
        if (LO) {
          ldb_t(f, tl.bl, NP, n0, 16 * kk);
          mma(acc[2 * np], ah, f[0], f[1]);
          mma(acc[2 * np + 1], ah, f[2], f[3]);
        }
      }
    }
  }
  const long long PN = (long long)P * N;
  float* sg = S + (((long long)b * nc + c) * H + h) * PN;
  if (live) {
#pragma unroll
    for (int n = 0; n < NT / 16; ++n) {
      const int col = 64 * nh + 8 * n + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * pr + g + 8 * r;
        if (p >= Pl) continue;
        if constexpr (TL) {
          float* sr = sg + (long long)(p0 + p) * N + n0;
          if (col < Nl) sr[col] = acc[n][2 * r];
          if (col + 1 < Nl) sr[col + 1] = acc[n][2 * r + 1];
        } else {
          if (col < N) sg[p * N + col] = acc[n][2 * r];
          if (col + 1 < N) sg[p * N + col + 1] = acc[n][2 * r + 1];
        }
      }
    }
  }

  // the last of the nc blocks of (b, h, tile) to get here passes the
  // tile's state, PASS elements per thread in flight
  __threadfence();
  __syncthreads();
  if (t == 0) {
    if constexpr (TL)
      ticket = atomicAdd(&tickets[((long long)b * H + h) * ntile + tile], 1u);
    else
      ticket = atomicAdd(&tickets[b * H + h], 1u);
  }
  __syncthreads();
  if (ticket != (unsigned)nc - 1) return;
  __threadfence();
  const long long bh_ = (long long)b * H + h;
  const int PN8 = P * N8;
  const int TN8 = Pl * Nl8;                  // this tile's elements
  for (int e0 = 0; e0 < TN8; e0 += PASS * ST_THR) {
    float st[PASS];
    int off[PASS];                           // p N + n, or -1 (padding)
    int hof[TL ? PASS : 1];                  // p N8 + n (one tile: e)
#pragma unroll
    for (int u = 0; u < PASS; ++u) {
      const int e = e0 + u * ST_THR + t;
      int p, n;
      if constexpr (TL) {
        p = p0 + e / Nl8;
        n = n0 + e % Nl8;
        hof[u] = e < TN8 ? p * N8 + n : -1;
      } else {
        p = e / N8;
        n = e - p * N8;
      }
      off[u] = e < TN8 && n < N ? p * N + n : -1;
      st[u] = off[u] >= 0 && h0 ? h0[bh_ * PN + off[u]] : 0.f;
    }
    for (int k = 0; k < nc; ++k) {
      const long long slot = ((long long)b * nc + k) * H + h;
      const float dec =
          expf(__ldcg(LA + bh_ * L + min(k * chunk + chunk, L) - 1));
      float own[PASS];
#pragma unroll
      for (int u = 0; u < PASS; ++u)
        own[u] = off[u] >= 0 ? __ldcg(S + slot * PN + off[u]) : 0.f;
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        int ho = e0 + u * ST_THR + t;        // one tile: ho = e
        bool in = ho < TN8;
        if constexpr (TL) {
          ho = hof[u];
          in = ho >= 0;
        }
        if (in && (k > 0 || h0)) {           // the state entering chunk k
          const bf16 sh = __float2bfloat16_rn(st[u]);
          hin_hi[slot * PN8 + ho] = sh;
          hin_lo[slot * PN8 + ho] =
              __float2bfloat16_rn(st[u] - __bfloat162float(sh));
        }
        st[u] = st[u] * dec + own[u];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS; ++u)
      if (off[u] >= 0) hf[bh_ * PN + off[u]] = st[u];
  }
}

// ---------------------------------------------------------------------
// 1. C B^T per (batch, chunk), shared by the heads: 64 x 64 tiles of the
//    causal triangle into an f32 scratch of row pitch gp
// ---------------------------------------------------------------------

template <bool LO, bool TL>
__global__ void __launch_bounds__(128, 4)
ssd_cb_kernel(Plane bq, Plane cq, float* __restrict__ G, int L, int N,
              int chunk, int nc, int gp) {
  // TL: block x = (z nk + rt) nk + kt, z = b nc + c, nk = gp / KT; else
  // the grid is (nk, nk, Bb nc)
  constexpr int CS = LO ? 2 : 1;
  extern __shared__ __align__(16) uint8_t raw[];
  bf16* cs = reinterpret_cast<bf16*>(raw);   // KT x NP C rows (hi [, lo])
  bf16* bs = cs + CS * KT * NP;              // KT x NP B rows (hi [, lo])
  const int nk_ = gp / KT;
  const unsigned z = TL ? blockIdx.x / (nk_ * nk_) : blockIdx.z;
  const int kt = TL ? blockIdx.x % nk_ : blockIdx.x;
  const int rt = TL ? blockIdx.x / nk_ % nk_ : blockIdx.y;
  const int b = z / nc, c = z % nc;
  const int c0 = c * chunk, cl = min(chunk, L - c0);
  const int i0 = rt * KT, j0 = kt * KT;
  if (kt > rt || i0 >= cl) return;
  const int N8 = up(N, 8);
  const long long co = b * cq.sb + (long long)(c0 + i0) * cq.sl;
  const long long bo = b * bq.sb + (long long)(c0 + j0) * bq.sl;
  const int nq = min(KT, cl - i0), nk = min(KT, cl - j0);
  const int wp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int g = ln >> 2, t4 = ln & 3;
  float acc[KT / 8][4];
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // the state axis in tiles of NT, summed over
  for (int n0 = 0; n0 < (TL ? N : 1); n0 += NT) {
    const int ng = (TL ? min(NT, N8 - n0) : N8) / 8;
    if (TL && n0 > 0) __syncthreads();       // the last tile is read
    tile_async<KT, NT / 8, 128>(cs, NP, cq.hi + co + n0, cq.sl, nq, ng);
    tile_async<KT, NT / 8, 128>(bs, NP, bq.hi + bo + n0, bq.sl, nk, ng);
    if (LO) {
      tile_async<KT, NT / 8, 128>(cs + KT * NP, NP, cq.lo + co + n0, cq.sl,
                                  nq, ng);
      tile_async<KT, NT / 8, 128>(bs + KT * NP, NP, bq.lo + bo + n0, bq.sl,
                                  nk, ng);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const int nkn = ((TL ? min(NT, N - n0) : N) + 15) / 16;
#pragma unroll
    for (int k = 0; k < NT / 16; ++k) {
      if (k >= nkn) break;
      uint32_t a[4], al[4];
      lda(a, cs, NP, 16 * wp, 16 * k);
      if (LO) lda(al, cs + KT * NP, NP, 16 * wp, 16 * k);
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        uint32_t f[4];
        ldb(f, bs, NP, 16 * np, 16 * k);       // B(n, j) = B[j][n]
        mma(acc[2 * np], a, f[0], f[1]);
        mma(acc[2 * np + 1], a, f[2], f[3]);
        if (LO) {
          mma(acc[2 * np], al, f[0], f[1]);
          mma(acc[2 * np + 1], al, f[2], f[3]);
          ldb(f, bs + KT * NP, NP, 16 * np, 16 * k);
          mma(acc[2 * np], a, f[0], f[1]);
          mma(acc[2 * np + 1], a, f[2], f[3]);
        }
      }
    }
  }
  float* gt = G + ((long long)z * gp + i0) * gp + j0;
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(gt + (16 * wp + g + 8 * r) * gp + 8 * n +
                                 2 * t4) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

// ---------------------------------------------------------------------
// 3. outputs: inter-chunk term, then the causal intra-chunk sum
// ---------------------------------------------------------------------

template <bool LO, bool TL>
__global__ void __launch_bounds__(OUT_THR, 2)
ssd_out_kernel(Plane xq, Plane cq, const float* __restrict__ G,
               const float* __restrict__ LA, const float* __restrict__ DTT,
               const bf16* __restrict__ hin_hi,
               const bf16* __restrict__ hin_lo, float* __restrict__ y,
               int L, int H, int P, int N, int chunk, int nc, int gp,
               int nqt, int npt, int has_h0) {
  constexpr int CS = LO ? 2 : 1;
  extern __shared__ __align__(16) uint8_t raw[];
  // first C rows and h_in ...
  bf16* ch = reinterpret_cast<bf16*>(raw);   // QT x NP (hi)
  bf16* cl_ = ch + QT * NP;                  //         (lo)
  bf16* hh = ch + CS * QT * NP;              // PT x NP (hi)
  bf16* hl = hh + PT * NP;                   //         (lo)
  // ... then two key tiles in the same memory: C B^T rows, x rows
  auto gsm = [&](int u) {
    return reinterpret_cast<float*>(raw + u * gtile_bytes(LO));
  };
  auto xsm = [&](int u) {
    return reinterpret_cast<bf16*>(raw + u * gtile_bytes(LO) + QT * GP * 4);
  };
  float* la = reinterpret_cast<float*>(raw + out_region(LO));
  float* dts = la + chunk;

  // TL: block x = ((z npt + pt) H + h) nqt + qt, z = b nc + c; pt: the
  // output columns p0 .. p0 + 63; else the grid is (nqt, H, Bb nc)
  int qt, h, p0 = 0;
  unsigned z;
  if constexpr (TL) {
    unsigned bx = blockIdx.x;
    qt = bx % nqt;
    bx /= nqt;
    h = bx % H;
    bx /= H;
    p0 = bx % npt * PT;
    z = bx / npt;
  } else {
    qt = blockIdx.x;
    h = blockIdx.y;
    z = blockIdx.z;
  }
  const int c = z % nc, b = z / nc;
  const int c0 = c * chunk, cl = min(chunk, L - c0);
  const int i0 = qt * QT;
  if (i0 >= cl) return;
  const int nq = min(QT, cl - i0), kend = i0 + nq;
  const int t = threadIdx.x, wp = t >> 5, ln = t & 31;
  const int g = ln >> 2, t4 = ln & 3;
  const int N8 = up(N, 8);
  const int Pl = TL ? min(PT, P - p0) : P;
  const long long xo =
      b * xq.sb + (long long)c0 * xq.sl + (long long)h * xq.hs + p0;
  const float* gb = G + ((long long)z * gp + i0) * gp;
  // keys [j0, j0 + KT): the block's C B^T rows and x's rows of head h
  auto load = [&](int u, int j0) {
    bf16* xd = xsm(u);
    // the block's rows of C B^T (rows past the chunk are the next
    // chunk's, or the scratch's tail pad: never used)
    tile_async<QT, KT / 4, OUT_THR>(reinterpret_cast<bf16*>(gsm(u)), 2 * GP,
                                    reinterpret_cast<const bf16*>(gb + j0),
                                    2LL * gp, QT, KT / 4);
    const int nk = min(KT, cl - j0);
    tile_async<KT, PT / 8, OUT_THR>(xd, PP, xq.hi + xo + j0 * xq.sl, xq.sl,
                                    nk, (Pl + 7) / 8);
    if (LO)
      tile_async<KT, PT / 8, OUT_THR>(xd + KT * PP, PP,
                                      xq.lo + xo + j0 * xq.sl, xq.sl, nk,
                                      (Pl + 7) / 8);
    cp_commit();
  };
  const long long hrow = ((long long)b * H + h) * L + c0;
  for (int i = t; i < kend; i += OUT_THR) {
    la[i] = LA[hrow + i];
    dts[i] = DTT[hrow + i];
  }
  __syncthreads();
  const int npn = (Pl + 15) / 16;            // 16-wide tiles over P
  const int ia = i0 + 16 * wp + g, ib = ia + 8;   // this thread's rows
  const int first_row = i0 + 16 * wp, last_row = first_row + 15;
  float acc[PT / 8][4];
#pragma unroll
  for (int n = 0; n < PT / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (c > 0 || has_h0) {
    // y_i = exp(la_i) C_i . h_in^T, summed over tiles of NT states
    const long long co = b * cq.sb + (long long)(c0 + i0) * cq.sl;
    const long long slot =
        (((long long)b * nc + c) * H + h) * P * N8 + (long long)p0 * N8;
    for (int n0 = 0; n0 < (TL ? N : 1); n0 += NT) {
      const int ng = (TL ? min(NT, N8 - n0) : N8) / 8;
      if (TL && n0 > 0) __syncthreads();     // the last tile is read
      tile_async<QT, NT / 8, OUT_THR>(ch, NP, cq.hi + co + n0, cq.sl, nq, ng);
      if (LO)
        tile_async<QT, NT / 8, OUT_THR>(cl_, NP, cq.lo + co + n0, cq.sl, nq,
                                        ng);
      tile_async<PT, NT / 8, OUT_THR>(hh, NP, hin_hi + slot + n0, N8, Pl, ng);
      tile_async<PT, NT / 8, OUT_THR>(hl, NP, hin_lo + slot + n0, N8, Pl, ng);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const int nkn = ((TL ? min(NT, N - n0) : N) + 15) / 16;
#pragma unroll
      for (int k = 0; k < NT / 16; ++k) {
        if (k >= nkn) break;
        uint32_t a[4], al[4];
        lda(a, ch, NP, 16 * wp, 16 * k);
        if (LO) lda(al, cl_, NP, 16 * wp, 16 * k);
#pragma unroll
        for (int np = 0; np < PT / 16; ++np) {
          if (np >= npn) break;
          uint32_t f[4], fl[4];
          ldb(f, hh, NP, 16 * np, 16 * k);     // B(n, p) = h[p][n]
          ldb(fl, hl, NP, 16 * np, 16 * k);
          mma(acc[2 * np], a, f[0], f[1]);
          mma(acc[2 * np + 1], a, f[2], f[3]);
          mma(acc[2 * np], a, fl[0], fl[1]);
          mma(acc[2 * np + 1], a, fl[2], fl[3]);
          if (LO) {
            mma(acc[2 * np], al, f[0], f[1]);
            mma(acc[2 * np + 1], al, f[2], f[3]);
          }
        }
      }
    }
    const float ea = ia < cl ? expf(la[ia]) : 0.f;
    const float eb = ib < cl ? expf(la[ib]) : 0.f;
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      acc[n][0] *= ea; acc[n][1] *= ea;
      acc[n][2] *= eb; acc[n][3] *= eb;
    }
    __syncthreads();                         // C and h_in are done with
  }

  load(0, 0);
  const float la_a = ia < cl ? la[ia] : 0.f, la_b = ib < cl ? la[ib] : 0.f;
  const int ntiles = (kend + KT - 1) / KT;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * KT, nk = min(KT, cl - j0);
    if (jt + 1 < ntiles) {
      load((jt + 1) & 1, j0 + KT);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                         // key tile jt has landed
    // keys after this warp's rows, or rows past the chunk: nothing to add
    if (j0 <= last_row && first_row < cl) {
      const float* gt = gsm(jt & 1) + (16 * wp + g) * GP + 2 * t4;
      const bf16* xh = xsm(jt & 1);
      // (C_i . B_j) exp(la_i - la_j) dt_j for j <= i, else 0: the
      // exponent is formed only where j <= i
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const float2 u = *reinterpret_cast<const float2*>(gt + 8 * n);
        const float2 v = *reinterpret_cast<const float2*>(gt + 8 * GP + 8 * n);
        const float gv[4] = {u.x, u.y, v.x, v.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          const int j = j0 + 8 * n + 2 * t4 + (e & 1);
          s[n][e] = j <= i && i < cl
                        ? gv[e] * __expf((e < 2 ? la_a : la_b) - la[j]) *
                              dts[j]
                        : 0.f;
        }
      }
      // y += S x_j, S split into hi + lo A fragments 16 keys at a time
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (16 * kk >= nk || j0 + 16 * kk > last_row) break;
        uint32_t ph[4], pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < PT / 16; ++np) {
          if (np >= npn) break;
          uint32_t f[4];
          ldb_t(f, xh, PP, 16 * np, 16 * kk);  // B(j, p) = x[j][p]
          mma(acc[2 * np], ph, f[0], f[1]);
          mma(acc[2 * np + 1], ph, f[2], f[3]);
          mma(acc[2 * np], pl, f[0], f[1]);
          mma(acc[2 * np + 1], pl, f[2], f[3]);
          if (LO) {
            ldb_t(f, xh + KT * PP, PP, 16 * np, 16 * kk);
            mma(acc[2 * np], ph, f[0], f[1]);
            mma(acc[2 * np + 1], ph, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();                         // the buffer may be refilled
  }
  // y rows ia, ib of the chunk, head h, columns p0 ..
#pragma unroll
  for (int n = 0; n < PT / 8; ++n) {
    const int p = 8 * n + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? ib : ia;
      if (i >= cl) continue;
      float* yr = y + (((long long)b * L + c0 + i) * H + h) * P + p0;
      if (p + 1 < Pl && P % 2 == 0) {
        *reinterpret_cast<float2*>(yr + p) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        if (p < Pl) yr[p] = acc[n][2 * r];
        if (p + 1 < Pl) yr[p + 1] = acc[n][2 * r + 1];
      }
    }
  }
}

template <bool LO, bool TL>
cudaError_t scan(const Plane& xq, const Plane& bq, const Plane& cq,
                 const float* dt, long long dsb, long long dsl,
                 const float* A, const float* h0, float* S, float* G,
                 float* LA, float* DTT, bf16* hin_hi, bf16* hin_lo,
                 unsigned* tickets, float* y, float* hf, int Bb, int L,
                 int H, int P, int N, int chunk, cudaStream_t s) {
  // opt in once, to the most a block may have: no attribute call on
  // later launches (those may be under CUDA-graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_state_kernel<LO, TL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_cb_kernel<LO, TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_OPTIN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_out_kernel<LO, TL>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const long long nc = (L + chunk - 1) / chunk;
  const int gp = up(chunk, KT);
  const int nk = gp / KT, nqt = (chunk + QT - 1) / QT;
  const int npt = (P + PT - 1) / PT, nnt = (N + NT - 1) / NT;
  const long long zs = nc * Bb;
  const long long grids[3] = {zs * nk * nk, zs * npt * nnt * H,
                              zs * npt * H * nqt};
  for (long long n : grids)
    if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 gcb = TL ? dim3((unsigned)grids[0]) : dim3(nk, nk, (unsigned)zs);
  const dim3 gst =
      TL ? dim3((unsigned)grids[1]) : dim3(H, (unsigned)nc, Bb);
  const dim3 gout =
      TL ? dim3((unsigned)grids[2]) : dim3(nqt, H, (unsigned)zs);
  ssd_cb_kernel<LO, TL><<<gcb, 128, cb_smem(LO), s>>>(bq, cq, G, L, N, chunk,
                                                     (int)nc, gp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_kernel<LO, TL><<<gst, ST_THR, state_smem(LO, chunk), s>>>(
          xq, bq, dt, dsb, dsl, A, h0, LA, DTT, S, hin_hi, hin_lo, hf,
          tickets, L, H, P, N, chunk, (int)nc, nnt, npt * nnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out_kernel<LO, TL><<<gout, OUT_THR, out_smem(LO, chunk), s>>>(
          xq, cq, G, LA, DTT, hin_hi, hin_lo, y, L, H, P, N, chunk, (int)nc,
          gp, nqt, npt, h0 != nullptr);
  return cudaGetLastError();
}

#include "ssd_scan_bwd.cuh"

}  // namespace

// Shared memory the larger of the scan's blocks needs, in bytes (the
// wrapper checks it against the card's limit before it launches).
extern "C" long long ssd_scan_smem(int lo, int chunk) {
  const int a = state_smem(lo, chunk), b = out_smem(lo, chunk);
  return a > b ? (a > cb_smem(lo) ? a : cb_smem(lo))
               : (b > cb_smem(lo) ? b : cb_smem(lo));
}

// x (Bb, L, H, P), B / C (Bb, L, N): dtype 0 = float32, 1 = bfloat16,
// strided along (batch, position) (strides in elements), x's head
// stride P, the last axis contiguous; dt (Bb, L, H) f32 with strides
// dsb, dsl and its last axis contiguous; A (H,), h0 (Bb, H, P, N) or
// null, y (Bb, L, H, P) and hf (Bb, H, P, N) f32 contiguous.  Any P and
// N, L >= 1, 1 <= chunk <= L.  With P8 / N8 = P / N rounded up
// to 8 and nc = ceil(L / chunk), the scratch (all from the caller, on
// 16 bytes):
//   planes:  null where x, B and C are bf16 with P and N multiples of 8,
//            strides multiples of 8 and bases on 16 bytes (used as they
//            are); else bf16 of Bb L (H P8 + 2 N8) elements, twice that
//            for f32 (hi and lo planes)
//   S:       f32 (Bb, nc, H, P, N);  LA, DTT: f32 (Bb, H, L)
//   G:       f32 Bb nc gp gp + 128 gp, gp = chunk rounded up to 64 (a
//            tail pad: the last chunk's 128-row tiles read past its gp rows)
//   hin:     bf16 2 x (Bb, nc, H, P, N8) (hi, then lo)
//   tickets: Bb H ceil(P / 64) ceil(N / 128) zeroed unsigned ints
// Returns cudaGetLastError().
extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* h0, void* planes, float* S, float* G,
    float* LA, float* DTT, void* hin, unsigned* tickets, float* y, float* hf,
    int dtype, int Bb, int L, int H, int P, int N, int chunk, long long xsb,
    long long xsl, long long dsb, long long dsl, long long bsb,
    long long bsl, long long csb, long long csl, void* stream) {
  if (Bb <= 0 || H <= 0) return cudaSuccess;
  if (P <= 0 || N <= 0 || L <= 0 || chunk <= 0 ||
      chunk > L || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (dtype == 0 && planes == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P8 = up(P, 8), N8 = up(N, 8);
  const int nc = (L + chunk - 1) / chunk;
  bf16* hin_hi = static_cast<bf16*>(hin);
  bf16* hin_lo = hin_hi + (long long)Bb * nc * H * P * N8;
  const bool lo = dtype == 0;
  Plane xq, bq, cq;
  if (planes) {
    const long long nx = (long long)Bb * L * H * P8;
    const long long nn = (long long)Bb * L * N8;
    bf16* xh = static_cast<bf16*>(planes);
    bf16* bh = xh + nx;
    bf16* ch = bh + nn;
    bf16* xl = lo ? ch + nn : nullptr;
    bf16* bl = lo ? xl + nx : nullptr;
    bf16* cl = lo ? bl + nn : nullptr;
    if ((long long)L * Bb > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    if (lo)
      ssd_split_kernel<float><<<(unsigned)(L * Bb), 256, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(Bm),
          static_cast<const float*>(Cm), xsb, xsl, bsb, bsl, csb, csl, L, H,
          P, N, P8, N8, xh, xl, bh, bl, ch, cl);
    else
      ssd_split_kernel<bf16><<<(unsigned)(L * Bb), 256, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(Bm),
          static_cast<const bf16*>(Cm), xsb, xsl, bsb, bsl, csb, csl, L, H,
          P, N, P8, N8, xh, xl, bh, bl, ch, cl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xq = Plane{xh, xl, (long long)L * H * P8, (long long)H * P8, P8};
    bq = Plane{bh, bl, (long long)L * N8, N8, 0};
    cq = Plane{ch, cl, (long long)L * N8, N8, 0};
  } else {
    xq = Plane{static_cast<const bf16*>(x), nullptr, xsb, xsl, P};
    bq = Plane{static_cast<const bf16*>(Bm), nullptr, bsb, bsl, 0};
    cq = Plane{static_cast<const bf16*>(Cm), nullptr, csb, csl, 0};
  }
  // more than one 64 x 128 tile of the state, or more batches x chunks
  // than a grid's z axis takes: the tiled kernels, on one-axis grids
  const bool tl = P > PT || N > NT ||
                  (long long)Bb * ((L + chunk - 1) / chunk) > 65535;
#define SSD_SCAN(LO_, TL_)                                                  \
  return scan<LO_, TL_>(xq, bq, cq, dt, dsb, dsl, A, h0, S, G, LA, DTT,    \
                        hin_hi, hin_lo, tickets, y, hf, Bb, L, H, P, N,    \
                        chunk, s);
  if (lo && tl) SSD_SCAN(true, true)
  if (lo) SSD_SCAN(true, false)
  if (tl) SSD_SCAN(false, true)
  SSD_SCAN(false, false)
#undef SSD_SCAN
}

// Shared memory, bytes, of the backward's larger block at head groups of
// hg (the wrapper checks it against the card's limit before it
// launches); -1 where N is wider than the backward's tiles (352).
extern "C" long long ssd_scan_bwd_smem(int lo, int N, int hg) {
  return ssd_bwd::smem(lo != 0, N, hg);
}

// bf16 terms of each split f32 operand and state of the backward: 3 for
// f32 operands up to N = 128, else 2 (the scratch holds 2 x that many
// planes of the states).
extern "C" int ssd_scan_bwd_levels(int lo, int N) {
  return ssd_bwd::levels(lo != 0, N);
}

namespace {

template <typename T>
int scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* dy, const float* dhf, void* dx,
             float* ddt, float* dA, void* dB, void* dC, float* LA,
             float* SR, void* hs, float* dlaq, float* dbp, float* dcp,
             float* dap, int Bb, int L, int H, int P, int N, int hg,
             long long xsb, long long xsl, long long dsb, long long dsl,
             long long bsb, long long bsl, long long csb, long long csl,
             cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);           // elements of 16 bytes
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  ssd_bwd::Args<T> a;
  a.x = static_cast<const T*>(x);
  a.B = static_cast<const T*>(Bm);
  a.C = static_cast<const T*>(Cm);
  a.dt = dt;
  a.A = A;
  a.dy = dy;
  a.dh = dhf;
  a.L = L;
  a.H = H;
  a.P = P;
  a.N = N;
  a.N8 = up(N, 8);
  a.nb = (L + ssd_bwd::Q - 1) / ssd_bwd::Q;
  a.hg = hg;
  a.ngrp = (H + hg - 1) / hg;
  const long long PN8 = (long long)P * a.N8;
  a.nz = (int)((PN8 + ssd_bwd::PASS_TILE - 1) / ssd_bwd::PASS_TILE);
  a.plane = (long long)Bb * a.nb * H * PN8;
  a.LA = LA;
  a.S = SR;
  a.R = SR + a.plane;
  a.hs = static_cast<bf16*>(hs);
  a.dlaq = dlaq;
  a.dx = static_cast<T*>(dx);
  a.ddt = ddt;
  a.dbp = dbp;
  a.dcp = dcp;
  a.dap = dap;
  a.xsb = xsb;
  a.xsl = xsl;
  a.dsb = dsb;
  a.dsl = dsl;
  a.bsb = bsb;
  a.bsl = bsl;
  a.csb = csb;
  a.csl = csl;
  a.vx = al(x) && xsb % E == 0 && xsl % E == 0 && P % E == 0;
  a.vb = al(Bm) && bsb % E == 0 && bsl % E == 0;
  a.vc = al(Cm) && csb % E == 0 && csl % E == 0;
  a.vy = al(dy) && P % 4 == 0;
  return ssd_bwd::launch<T>(a, Bb, static_cast<T*>(dB), static_cast<T*>(dC),
                            dA, s);
}

}  // namespace

// The backward (ssd_scan_bwd.cuh), for a scan without h0: x, B, C as the
// forward's (dtype 0 = float32, 1 = bfloat16, the same strides), dt and
// A f32; dy (Bb, L, H, P) f32 contiguous; dhf (Bb, H, P, N) f32 or null
// (no gradient on the final state).  Writes dx (Bb, L, H, P) and dB / dC
// (Bb, L, N) contiguous in `dtype`, ddt (Bb, L, H) and dA (H,) f32.
// Heads go in groups of hg (1..8).  With nb = ceil(L / 64), N8 = N
// rounded up to 8, G = ceil(H / hg), nz = ceil(P N8 / 1024) and LV =
// ssd_scan_bwd_levels(dtype == 0, N), the scratch (from the caller): LA
// f32 (Bb, H, L); SR f32 2 x (Bb, nb, H, P, N8); hs bf16 2 LV x (Bb, nb,
// H, P, N8); dlaq f32 (Bb, H, nb, nz); dbp and dcp f32 (Bb, L, G, N);
// dap f32 (Bb, nb, H).  Returns cudaGetLastError().
extern "C" int ssd_scan_bwd_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* dy, const float* dhf, void* dx, float* ddt,
    float* dA, void* dB, void* dC, float* LA, float* SR, void* hs,
    float* dlaq, float* dbp, float* dcp, float* dap, int dtype, int Bb,
    int L, int H, int P, int N, int hg, long long xsb, long long xsl,
    long long dsb, long long dsl, long long bsb, long long bsl,
    long long csb, long long csl, void* stream) {
  if (Bb <= 0 || H <= 0) return cudaSuccess;
  if (P <= 0 || N <= 0 || L <= 0 || hg <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_BWD(T_)                                                         \
  return scan_bwd<T_>(x, dt, A, Bm, Cm, dy, dhf, dx, ddt, dA, dB, dC, LA,  \
                      SR, hs, dlaq, dbp, dcp, dap, Bb, L, H, P, N, hg, xsb, \
                      xsl, dsb, dsl, bsb, bsl, csb, csl, s);
  if (dtype == 0) SSD_BWD(float)
  if (dtype == 1) SSD_BWD(bf16)
#undef SSD_BWD
  return cudaErrorInvalidValue;
}
