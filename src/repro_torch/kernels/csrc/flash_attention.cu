// Online-softmax attention with causal / sliding-window masks, a tanh
// logit softcap, GQA by index and a per-sequence live key count.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py).  Same contract: q (B, Hq, Lq,
// hd), k / v (B, Hkv, Lk, hd), kv head = q head / (Hq / Hkv);
// s = (q . k) / sqrt(hd), then softcap * tanh(s / softcap), then the
// mask (ik < Lk, ik < kv_valid[b], and with causal: ik <= row with
// row = iq + Lk - Lq, ik > row - window); softmax over the live keys,
// times v.  Scores, running max, denominator and accumulator in f32;
// the output in q's dtype; a row with no live key gives 0.  f32 and
// bf16 inputs.  Every tensor is addressed through its (batch, head,
// position) strides with the head dim contiguous, so the model's
// (B, L, H, hd) layout and its KV cache are read without a copy.
//
// What bounds it on an H100: prefill at B=16, L=512, Hq=32, hd=64 is
// 4*B*Hq*hd*(L(L+1)/2) = 17 GFLOP of products against 25 MB of q/k/v/o:
// operations, at the bf16 tensor-core rate.  Decode (Lq=1) is the
// other way round: 2*hd*kv_valid flops per query head against the live
// prefix of the cache, so bytes.
//
// Design (simple and right first; mma.sync, no wgmma/TMA yet):
//  * prefill/general, grid (ceil(Lq/64), Hq, B): a block takes 64
//    query rows of one head and walks its key tiles -- the TPU
//    kernel's sequential key axis is this loop in the block.  Key
//    tiles that the causal / window mask or kv_valid rule out for every
//    row of the block are never loaded.  Two bodies:
//    - bf16, hd 64/128: tensor cores.  4 warps of 16 rows; S = Q K^T
//      and O += P V as mma.sync m16n8k16 with f32 accumulators (K as
//      [key][dim], V transposed to [dim][key] in shared memory, rows
//      padded so fragment reads hit distinct banks); P enters the
//      second product as bf16, the row max and sum stay f32.
//    - otherwise (f32, hd 32): CUDA cores.  Each row is held by HD/32
//      threads, 32 of its dims each, in registers; key tiles stream
//      through shared memory as f32; the row's threads reduce their
//      partial dots with xor-shuffles and update (m, l, acc) per 16
//      keys.
//  * decode (Lq=1), grid (ceil(G/8), Hkv, B): a block serves up to 8
//    query heads of one KV group, so each K/V row is read once per
//    group.  Its 4 warps take 32-key slices of [0, kv_valid) in turn
//    (a lane scores one key against all the block's heads), keep a
//    warp-level (m, l, acc), and the block merges the 4 partial states
//    at the end.  Only the live prefix of the cache is read.
//  * every exp() is guarded through the mask, as the TPU kernel does:
//    a masked score never enters exp, and a row whose running max is
//    still -inf rescales by 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;       // query rows per prefill block
constexpr int SUB = 16;      // keys per online-softmax update
constexpr int DEC_WARPS = 4;
constexpr int MAXG = 8;      // query heads per decode block

struct Mask {
  int lq, lk, causal, window;
  __device__ __forceinline__ bool ok(int iq, int ik, int live) const {
    if (iq >= lq || ik >= lk || ik >= live) return false;
    if (causal) {
      const int row = iq + (lk - lq);
      if (ik > row) return false;
      if (window && ik <= row - window) return false;
    }
    return true;
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float cap(float s, float softcap) {
  return softcap != 0.f ? softcap * tanhf(s / softcap) : s;
}

struct Strides {
  long long b, h, l;
};

// ---------------------------------------------------------------------
// prefill / general launch shape
// ---------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * (HD / 32))
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_valid,
               T* __restrict__ out, int G, Mask mk, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, float softcap) {
  constexpr int TPR = HD / 32;      // threads per query row
  constexpr int NT = BQ * TPR;
  constexpr int C4 = HD / 4;        // float4 chunks per key row
  constexpr int BK = 4096 / HD;     // keys per tile: 32 KB of K+V
  __shared__ float4 kt[BK * C4];
  __shared__ float4 vt[BK * C4];

  const int t = threadIdx.x;
  const int r = t / TPR, part = t % TPR;
  const int q0 = blockIdx.x * BQ;
  const int iq = q0 + r;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int live = min(kv_valid[b], mk.lk);

  // this thread's dims: float4 chunks part, part + TPR, ... (8 of
  // them), so the row's threads read adjacent 16-byte words of a key
  float qr[32], acc[32];
  const T* qrow = q + b * qs.b + h * qs.h + (long long)min(iq, mk.lq - 1) * qs.l;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 x = load4(qrow + 4 * (TPR * i + part));
    qr[4 * i] = x.x; qr[4 * i + 1] = x.y; qr[4 * i + 2] = x.z;
    qr[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  // keys any row of this block can see
  int kbeg = 0, kend = live;
  if (mk.causal) {
    const int last = min(q0 + BQ, mk.lq) - 1 + (mk.lk - mk.lq);
    kend = min(kend, last + 1);
    if (mk.window) kbeg = max(0, q0 + (mk.lk - mk.lq) - mk.window + 1);
  }
  const T* kbase = k + b * ks.b + kh * ks.h;
  const T* vbase = v + b * vs.b + kh * vs.h;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    __syncthreads();
    for (int e = t; e < nk * C4; e += NT) {
      const int j = e / C4, c = e - j * C4;
      kt[e] = load4(kbase + (long long)(k0 + j) * ks.l + 4 * c);
      vt[e] = load4(vbase + (long long)(k0 + j) * vs.l + 4 * c);
    }
    __syncthreads();
    for (int s0 = 0; s0 < nk; s0 += SUB) {
      float sc[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        float dot = 0.f;
        if (s0 + j < nk) {
          const float4* kr = kt + (s0 + j) * C4 + part;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 x = kr[TPR * i];
            dot = fmaf(qr[4 * i], x.x, dot);
            dot = fmaf(qr[4 * i + 1], x.y, dot);
            dot = fmaf(qr[4 * i + 2], x.z, dot);
            dot = fmaf(qr[4 * i + 3], x.w, dot);
          }
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[j] = dot;
      }
      float mx = m;
      unsigned okbits = 0u;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const bool ok = s0 + j < nk && mk.ok(iq, k0 + s0 + j, live);
        if (ok) {
          sc[j] = cap(sc[j] * scale, softcap);
          mx = fmaxf(mx, sc[j]);
          okbits |= 1u << j;
        }
      }
      // a row with no live key so far keeps m = -inf: rescale by 1
      const float alpha = mx == -CUDART_INF_F ? 1.f : expf(m - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        sc[j] = (okbits >> j) & 1u ? expf(sc[j] - mx) : 0.f;
        psum += sc[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
      m = mx;
      if (okbits) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          if (s0 + j < nk) {
            const float p = sc[j];
            const float4* vr = vt + (s0 + j) * C4 + part;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 x = vr[TPR * i];
              acc[4 * i] = fmaf(p, x.x, acc[4 * i]);
              acc[4 * i + 1] = fmaf(p, x.y, acc[4 * i + 1]);
              acc[4 * i + 2] = fmaf(p, x.z, acc[4 * i + 2]);
              acc[4 * i + 3] = fmaf(p, x.w, acc[4 * i + 3]);
            }
          }
        }
      }
    }
  }
  if (iq >= mk.lq) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = out + b * os.b + h * os.h + (long long)iq * os.l;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(orow + 4 * (TPR * i + part) + e, l > 0.f ? acc[4 * i + e] * inv
                                                     : 0.f);
}

// ---------------------------------------------------------------------
// prefill / general launch shape, bf16 on the tensor cores
// ---------------------------------------------------------------------

// D = A * B + D for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16
// (col), D 16x8 f32.  Fragment layout (g = lane / 4, t = lane % 4):
// a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); d0 d1 (g, 2t..2t+1),
// d2 d3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A block of 4 warps takes 64 query rows of one head, 16 per warp; key
// tiles of 64 rows stream through shared memory (K as [key][dim], V
// transposed as [dim][key], rows padded by 8 so the fragment reads hit
// 32 distinct banks).  S = Q K^T and O += P V run as m16n8k16 MMAs
// with f32 accumulators; P is rounded to bf16 only as the second
// product's operand.
template <int HD>
__global__ void __launch_bounds__(128)
prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ kv_valid,
                   __nv_bfloat16* __restrict__ out, int G, Mask mk,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, float softcap) {
  constexpr int MBK = 64;           // keys per tile
  constexpr int KS = HD / 16;       // k-steps of S = Q K^T
  constexpr int NT = HD / 8;        // n-tiles of O
  constexpr int LDK = HD + 8;       // Ks row stride (bf16)
  constexpr int LDV = MBK + 8;      // Vt row stride (bf16)
  __shared__ __align__(16) __nv_bfloat16 kt[MBK * LDK];
  __shared__ __align__(16) __nv_bfloat16 vt[HD * LDV];

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int live = min(kv_valid[b], mk.lk);
  const int r0 = q0 + 16 * w + g, r1 = r0 + 8;   // this thread's rows

  // Q fragments, once: rows r0 / r1, dims 16 ks + 2 tq (+1, +8, +9)
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* p0 = qb + (long long)min(r0, mk.lq - 1) * qs.l;
    const __nv_bfloat16* p1 = qb + (long long)min(r1, mk.lq - 1) * qs.l;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int d = 16 * s + 2 * tq;
      qa[s][0] = *reinterpret_cast<const uint32_t*>(p0 + d);
      qa[s][1] = *reinterpret_cast<const uint32_t*>(p1 + d);
      qa[s][2] = *reinterpret_cast<const uint32_t*>(p0 + d + 8);
      qa[s][3] = *reinterpret_cast<const uint32_t*>(p1 + d + 8);
    }
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  int kbeg = 0, kend = live;
  if (mk.causal) {
    const int last = min(q0 + BQ, mk.lq) - 1 + (mk.lk - mk.lq);
    kend = min(kend, last + 1);
    if (mk.window) kbeg = max(0, q0 + (mk.lk - mk.lq) - mk.window + 1);
  }
  const __nv_bfloat16* kbase = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + kh * vs.h;

  for (int k0 = kbeg; k0 < kend; k0 += MBK) {
    const int nk = min(MBK, kend - k0);
    __syncthreads();
    // 16-byte loads: K rows as they are, V rows scattered into columns
    for (int e = t; e < MBK * (HD / 8); e += 128) {
      const int j = e / (HD / 8), c = (e - j * (HD / 8)) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (j < nk) {
        kv4 = *reinterpret_cast<const uint4*>(kbase + (long long)(k0 + j) *
                                              ks.l + c);
        vv4 = *reinterpret_cast<const uint4*>(vbase + (long long)(k0 + j) *
                                              vs.l + c);
      }
      *reinterpret_cast<uint4*>(kt + j * LDK + c) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(c + i) * LDV + j] = ve[i];
    }
    __syncthreads();

    // S = Q K^T over the tile: 8 n-tiles of 8 keys
    float s[MBK / 8][4];
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = kt + (8 * n + g) * LDK + 2 * tq;
#pragma unroll
      for (int ss = 0; ss < KS; ++ss) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * ss);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + 16 * ss + 8);
        mma16816(s[n], qa[ss], b0, b1);
      }
    }
    // scale, softcap, mask; the new running max of rows r0 / r1
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * tq + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool ok = 8 * n + 2 * tq + (e & 1) < nk && mk.ok(row, key, live);
        const float val = ok ? cap(s[n][e] * scale, softcap) : -CUDART_INF_F;
        s[n][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val);
        else mx1 = fmaxf(mx1, val);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = mx0 == -CUDART_INF_F ? 1.f : expf(m0 - mx0);
    const float al1 = mx1 == -CUDART_INF_F ? 1.f : expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mm = e < 2 ? m0 : m1;
        // masked scores are -inf: guard exp through them
        const float p = s[n][e] == -CUDART_INF_F ? 0.f : expf(s[n][e] - mm);
        s[n][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    l0 = l0 * al0 + ps0;            // per-thread partial sums of the row
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }
    // O += P V: P's accumulator layout is the A fragment of the next MMA
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vr = vt + (8 * n + g) * LDV + 16 * kk + 2 * tq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma16816(o[n], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = 8 * n + 2 * tq;
    if (r0 < mk.lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * os.l + d) =
          pack_bf16(o[n][0] * i0, o[n][1] * i0);
    if (r1 < mk.lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * os.l + d) =
          pack_bf16(o[n][2] * i1, o[n][3] * i1);
  }
}

// ---------------------------------------------------------------------
// decode launch shape (Lq = 1)
// ---------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_valid,
              T* __restrict__ out, int G, Mask mk, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, float softcap) {
  constexpr int DPL = HD / 32;      // value dims per lane
  constexpr int C4 = HD / 4;
  __shared__ float4 qsh[MAXG * C4];
  __shared__ float ps[DEC_WARPS][MAXG][32];
  __shared__ float mw[DEC_WARPS][MAXG], lw[DEC_WARPS][MAXG];
  __shared__ float aw[DEC_WARPS][MAXG][HD];

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int g0 = blockIdx.x * MAXG;
  const int ng = min(MAXG, G - g0);
  const int h0 = kh * G + g0;
  const int live = min(kv_valid[b], mk.lk);
  for (int e = t; e < ng * C4; e += DEC_WARPS * 32) {
    const int g = e / C4, c = e - g * C4;
    qsh[e] = load4(q + b * qs.b + (long long)(h0 + g) * qs.h + 4 * c);
  }
  __syncthreads();

  int kbeg = 0, kend = live;
  if (mk.causal) {                  // the one row sits at Lk - 1
    const int row = mk.lk - 1;
    kend = min(kend, row + 1);
    if (mk.window) kbeg = max(0, row - mk.window + 1);
  }
  const T* kbase = k + b * ks.b + kh * ks.h;
  const T* vbase = v + b * vs.b + kh * vs.h;

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  for (int base = kbeg + w * 32; base < kend; base += DEC_WARPS * 32) {
    const int key = base + lane;
    const bool ok = key < kend && mk.ok(0, key, live);
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (ok) {
      const T* kr = kbase + (long long)key * ks.l;
#pragma unroll 4
      for (int c = 0; c < C4; ++c) {
        const float4 x = load4(kr + 4 * c);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < ng) {
            const float4 qq = qsh[g * C4 + c];
            s[g] = fmaf(qq.x, x.x, s[g]);
            s[g] = fmaf(qq.y, x.y, s[g]);
            s[g] = fmaf(qq.z, x.z, s[g]);
            s[g] = fmaf(qq.w, x.w, s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < ng) {
        const float sg = ok ? cap(s[g] * scale, softcap) : -CUDART_INF_F;
        const float mx = fmaxf(m[g], warp_max(sg));
        const float alpha = mx == -CUDART_INF_F ? 1.f : expf(m[g] - mx);
        const float p = ok ? expf(sg - mx) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p);
        ps[w][g][lane] = p;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
        m[g] = mx;
      }
    }
    __syncwarp();
    const int nkey = min(32, kend - base);
    for (int j = 0; j < nkey; ++j) {
      const T* vr = vbase + (long long)(base + j) * vs.l;
      float vv[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) vv[d] = to_f(vr[lane + 32 * d]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < ng) {
          const float p = ps[w][g][j];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] = fmaf(p, vv[d], acc[g][d]);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < ng) {
      if (lane == 0) {
        mw[w][g] = m[g];
        lw[w][g] = l[g];
      }
#pragma unroll
      for (int d = 0; d < DPL; ++d) aw[w][g][lane + 32 * d] = acc[g][d];
    }
  }
  __syncthreads();
  for (int e = t; e < ng * HD; e += DEC_WARPS * 32) {
    const int g = e / HD, d = e - g * HD;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < DEC_WARPS; ++i) M = fmaxf(M, mw[i][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < DEC_WARPS; ++i) {
      const float f = mw[i][g] == -CUDART_INF_F ? 0.f : expf(mw[i][g] - M);
      L += lw[i][g] * f;
      A += aw[i][g][d] * f;
    }
    store(out + b * os.b + (long long)(h0 + g) * os.h + d,
          L > 0.f ? A / L : 0.f);
  }
}

// The tensor-core prefill takes bf16 with hd 64 or 128 and 16-byte
// aligned K/V rows (it loads them 16 bytes at a time); anything else
// runs the CUDA-core prefill.
template <typename T, int HD>
bool mma_ok(const void* q, const void* k, const void* v, Strides qs,
            Strides ks, Strides vs) {
  if (!std::is_same<T, __nv_bfloat16>::value || (HD != 64 && HD != 128))
    return false;
  const long long st[] = {ks.b, ks.h, ks.l, vs.b, vs.h, vs.l};
  for (long long x : st)
    if (x % 8) return false;
  return (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
             16 == 0;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_valid, void* out, int B, int Hq, int Hkv,
                   Mask mk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, float softcap, cudaStream_t s) {
  const int G = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (mk.lq == 1) {
    dim3 grid((G + MAXG - 1) / MAXG, Hkv, B);
    decode_kernel<T, HD><<<grid, DEC_WARPS * 32, 0, s>>>(
        qp, kp, vp, kv_valid, op, G, mk, qs, ks, vs, os, scale, softcap);
  } else if (mma_ok<T, HD>(q, k, v, qs, ks, vs)) {
    dim3 grid((mk.lq + BQ - 1) / BQ, Hq, B);
    prefill_mma_kernel<HD><<<grid, 128, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(qp),
        reinterpret_cast<const __nv_bfloat16*>(kp),
        reinterpret_cast<const __nv_bfloat16*>(vp), kv_valid,
        reinterpret_cast<__nv_bfloat16*>(op), G, mk, qs, ks, vs, os, scale,
        softcap);
  } else {
    dim3 grid((mk.lq + BQ - 1) / BQ, Hq, B);
    prefill_kernel<T, HD><<<grid, BQ * (HD / 32), 0, s>>>(
        qp, kp, vp, kv_valid, op, G, mk, qs, ks, vs, os, scale, softcap);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* kv_valid, void* out, int B, int Hq,
                        int Hkv, Mask mk, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, float softcap,
                        cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, kv_valid, out, B, Hq, Hkv, mk, qs, ks,
                           vs, os, scale, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, kv_valid, out, B, Hq, Hkv, mk, qs, ks,
                           vs, os, scale, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, kv_valid, out, B, Hq, Hkv, mk, qs, ks,
                            vs, os, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (batch, head, position) axes; the head dim is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_valid,
    void* out, int dtype, int B, int Hq, int Hkv, int Lq, int Lk, int hd,
    long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long osb, long long osh, long long osl, float scale,
    int causal, int window, float softcap, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Lk < 0) return cudaErrorInvalidValue;
  const Mask mk{Lq, Lk, causal, window};
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      os{osb, osh, osl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_valid, out, B, Hq, Hkv, mk,
                              qs, ks, vs, os, scale, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_valid, out, B, Hq,
                                      Hkv, mk, qs, ks, vs, os, scale,
                                      softcap, s);
  return cudaErrorInvalidValue;
}
