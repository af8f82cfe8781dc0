// Online-softmax attention with causal / sliding-window masks, a tanh
// logit softcap, GQA by index and a per-sequence live key count.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:87, body _flash_kernel :31).
// Same contract: q (B, Hq, Lq, hd), k / v (B, Hkv, Lk, hd), kv head =
// q head / (Hq / Hkv); s = (q . k) / sqrt(hd), then softcap * tanh(s /
// softcap), then the mask (ik < Lk, ik < kv_valid[b], and with causal:
// ik <= row with row = iq + Lk - Lq, ik > row - window); softmax over
// the live keys, times v.  Scores, running max, denominator and
// accumulator in f32; the output in q's dtype; a row with no live key
// gives 0.  f32 and bf16 inputs.  Every tensor is addressed through its
// (batch, head, position) strides with the head dim contiguous, so the
// model's (B, L, H, hd) layout and its KV cache are read without a copy.
// Head dims 32, 64, 120, 128 and 288.  A template's HD is a capacity: 120
// (h2o-danube-3-4b) runs in the 128 instantiations, its columns 120..127
// loaded as zeros (TMA's out-of-bounds fill, zero-filling cp.async) and
// never stored.  The decode launch also takes a window that ends at each
// sequence's live count (kv_valid[b] - local <= ik < kv_valid[b]): the
// local layers of gemma2-2b, whose cache is full length and whose
// sequences sit at different positions -- and a per-row first live slot
// (kv_first[b] <= ik): one rank's block of a cache sharded by length,
// whose live range may start inside the block or past its end.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//  * prefill, llama3.2-1b at B=16, L=512, 32/8 heads of 64, bf16,
//    causal: 4*B*Hq*hd*L(L+1)/2 = 17.2 GFLOP (0.0174 ms at the peak)
//    against q + k + v + o = 83.9 MB (0.0250 ms).  Bytes, but only
//    1.4x above the operations: the products must also run near the
//    tensor-core rate, which on Hopper only wgmma reaches.
//  * decode (Lq = 1) at the served shape, B=16, 8 KV heads of 64,
//    513-528 live keys in a 536-slot cache: 2*hd FLOP per (query head,
//    key) against the live K + V, 17.0 MB (0.0051 ms).  Bytes, in a
//    kernel so short that filling all 132 SMs matters as much as the
//    reads themselves.
//
// Design:
//  * prefill, bf16, hd 64/120/128, 16-byte aligned strides
//    (prefill_wgmma_kernel).  The producer issues TMA loads -- 4-D
//    tensor maps over hd and the (l, h, b) axes in the operands' own
//    strides, 128-byte swizzle -- into rings in dynamic shared memory
//    with a full and an empty mbarrier per stage.  S = Q K^T is wgmma
//    with Q and K from shared memory (K-major); O += P V is wgmma with P
//    in registers (the S accumulator's layout is the A operand's; P is
//    rounded to bf16 there only) and V read MN-major through the
//    transpose bit.  Softmax in the log2 domain on the SFU (ex2, with
//    scale*log2(e) folded into one fma per score); tanh only when
//    softcap != 0.  Tiles no row sees are skipped, tiles all rows see
//    in full run with no per-score mask, and only the edge tiles
//    (diagonal, window, kv_valid, ragged Lk) test each score.  TMA
//    fills rows past Lq / Lk with zeros.  Two bodies:
//    - hd 120/128 (prefill_turns): persistent, one 384-thread block an
//      SM walking the (query tile, head, batch) items longest first;
//      two consumer warpgroups of 64 rows take the producer
//      warpgroup's registers by setmaxnreg; 128-key tiles (Q K^T
//      m64n128); Q double-buffered, K and V in rings of their own.
//      The tensor cores run through the softmax: tile i's Q K^T goes
//      out with tile i - 1's P V and its scores are exponentiated while
//      P V runs, and the two warpgroups issue their products in turns
//      set by named barriers, one's softmax in the other's products.
//      O goes out through shared memory by TMA stores, which clip rows
//      past Lq and columns past hd.
//    - hd 64 (prefill_pair): grid (Hq, B, ceil(Lq / 128)), the
//      query-tile index reversed so the longest causal blocks start
//      first; two 288-thread blocks an SM (two consumer warpgroups of
//      64 rows and a producer warp), 64-key tiles in a 2-stage ring;
//      at hd 64 the softmax's ex2 keeps pace with the products, and the
//      second block fills the gaps better than turns.
//  * prefill, bf16, hd 288 (gemma2-2b; prefill_wide_kernel): the same
//    grid, 384 threads, each consumer warpgroup its own 64 rows with O
//    (144 f32 a thread) in registers given by setmaxnreg; 32-column
//    blocks under TMA's 64-byte swizzle, K and V stages filled and
//    emptied apart, the softmax beside the products: see WgWide.
//  * prefill otherwise (f32, hd 32, unaligned strides): prefill_kernel
//    on CUDA cores.  Each row is held by 1, 2, 4 or 8 threads in
//    registers (8 at hd 288: 9 float4 chunks each); key tiles stream
//    through shared memory as f32; (m, l, acc) are updated per 16
//    keys.
//  * decode (Lq = 1), split-KV: grid (n_split, Hkv, B).  The wrapper
//    picks n_split and the chunk from B, Hkv and the cache capacity
//    alone (decode_splits, wide_splits in flash_attention.py), never
//    from kv_valid, so no device value is read on the host, and names
//    the body (decode_body).  A block takes one chunk
//    of keys of one (batch, KV head) for the group's query heads, so
//    each K/V row is read once per group, and writes the chunk's
//    (m, l, acc) in f32 to scratch; a chunk with no live key writes
//    (-inf, 0) and exits.  bf16, hd <= 128, G <= 16
//    (decode_mma_kernel): the G heads are the 16 rows of m16n8k16 MMAs; all K/V rows of a
//    128-key pass are in flight at once (16-byte cp.async into padded
//    rows), B fragments come by ldmatrix (.trans for V), each of 4
//    warps keeps an online softmax over its 32 keys, and the warps
//    merge in order.  bf16, hd 288, G <= 16 (decode_wide_kernel: a
//    warp's O would not fit in its registers): S by key quarters, P
//    through shared memory, O by column quarters, the rows streamed
//    through a 2-stage ring.  Otherwise (f32, G > 16)
//    decode_split_kernel on CUDA cores: a 2-stage cp.async ring, 16
//    bytes of a key row per lane (two or three pieces a lane at hd
//    288).  A chunk wholly below a window is a chunk with no live
//    key.  decode_combine_kernel, one block per (batch, query head),
//    merges the splits in split order: no atomics, the same bits on
//    every run.  With one split (a short cache: seamless's 16 cross
//    keys) and no lse, decode_mma_kernel divides by the row sum itself
//    and writes the output: one launch, no scratch (one_launch).  Asked
//    for the rows' log-sum-exp the combine writes it beside an f32
//    output: a partial over one rank's keys.  The same body merges
//    R such partials (flash_decode_merge_launch), each (o, lse) read as
//    one split, so a cache sharded by length over R ranks decodes as
//    R local decodes, one gather of B * Hq * (hd + 1) floats a rank,
//    and one merge.
//  * decode against an int8 KV cache (flash_decode_q8_launch; the
//    values are bf16(bf16(x) * bf16(scale)), the reference's): the bytes
//    are half the bf16 cache's, but every value must be dequantized, and
//    the int-to-float and float-to-bf16 conversions run at a quarter of
//    the ALU rate or less.  bf16 queries, G <= 16: the same tensor-core
//    body, decode_mma_kernel<HD, true> at hd 64/120/128 (each warp its
//    own 2-stage cp.async ring of int8 rows, no block barrier in the
//    loop), decode_wide_kernel<288, true> at hd 288 (the bf16 cache's
//    body with an int8 stage); the values are formed with byte
//    permutes, an f32 subtract and one bf16x2 fma a pair (deq8x8).  Otherwise (f32, hd
//    32, G > 16) decode_q8_kernel on CUDA cores.  The caller names the
//    body (flash_attention.q8_body); both merge through
//    decode_combine_kernel.
//  * masked scores never enter ex2: a masked score is -inf, and a row
//    whose running max is still -inf subtracts 0 instead.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int BQ = 64;       // query rows per prefill block
constexpr int SUB = 16;      // keys per online-softmax update
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (-inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// live keys of sequence b: kv_valid[b] within Lk (all Lk without it)
__device__ __forceinline__ int live_keys(const int* kv_valid, int b,
                                         int lk) {
  return kv_valid == nullptr ? lk : min(kv_valid[b], lk);
}

// The prefill mask; `local` is the decode launch's window anchored at
// the live count and `first` (B,) its per-row first live slot (only
// Lq = 1 takes them: see the decode kernels' `lo`).
struct Mask {
  int lq, lk, causal, window, local;
  const int* first;
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

// Head dims are template capacities: 32, 64, 128 and 288.  A head dim
// below its capacity (120 in 128) is the runtime `hd`: the columns past
// it are loaded as zeros, which leave q . k unchanged, and never stored.
// Only the 128 instantiations hold one (PAD), so every other capacity
// compiles without the column tests.
template <int HD>
constexpr bool PAD = HD == 128;
template <int HD>
struct Pre {
  // threads per query row (a power of two, so the row's dot products
  // reduce by xor shuffles inside a warp) and float4 chunks per thread
  static constexpr int TPR = HD <= 32 ? 1 : HD <= 64 ? 2 : HD <= 128 ? 4 : 8;
  static constexpr int C4 = HD / 4;               // float4 chunks per row
  static constexpr int NC = (C4 + TPR - 1) / TPR;
  static constexpr int NT = BQ * TPR;
  static constexpr int BK = 4096 / HD;            // keys per tile: 32 KB
};

template <typename T, int HD>
__global__ void __launch_bounds__(Pre<HD>::NT)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_valid,
               T* __restrict__ out, int G, Mask mk, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, float softcap, int hd,
               float* __restrict__ lse) {
  using C = Pre<HD>;
  constexpr int TPR = C::TPR, NC = C::NC, NT = C::NT, C4 = C::C4;
  constexpr int BK = C::BK;
  __shared__ float4 kt[BK * C4];
  __shared__ float4 vt[BK * C4];

  const int t = threadIdx.x;
  const int r = t / TPR, part = t % TPR;
  const int q0 = blockIdx.x * BQ;
  const int iq = q0 + r;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int c4 = hd / 4;                // live chunks of a row

  // this thread's dims: float4 chunks part, part + TPR, ... (NC of
  // them), so the row's threads read adjacent 16-byte words of a key
  float qr[4 * NC], acc[4 * NC];
  const T* qrow = q + b * qs.b + h * qs.h + (long long)min(iq, mk.lq - 1) * qs.l;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = TPR * i + part;
    const float4 x = !PAD<HD> || c < c4 ? load4(qrow + 4 * c)
                                        : make_float4(0, 0, 0, 0);
    qr[4 * i] = x.x; qr[4 * i + 1] = x.y; qr[4 * i + 2] = x.z;
    qr[4 * i + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) acc[i] = 0.f;
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
      const float4 zero = make_float4(0, 0, 0, 0);
      const bool in = !PAD<HD> || c < c4;
      kt[e] = in ? load4(kbase + (long long)(k0 + j) * ks.l + 4 * c) : zero;
      vt[e] = in ? load4(vbase + (long long)(k0 + j) * vs.l + 4 * c) : zero;
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
          for (int i = 0; i < NC; ++i) {
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
      for (int i = 0; i < 4 * NC; ++i) acc[i] *= alpha;
      m = mx;
      if (okbits) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          if (s0 + j < nk) {
            const float p = sc[j];
            const float4* vr = vt + (s0 + j) * C4 + part;
#pragma unroll
            for (int i = 0; i < NC; ++i) {
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
  if (lse != nullptr && part == 0)      // natural log; +inf: no live key
    lse[((long long)b * gridDim.y + h) * mk.lq + iq] =
        l > 0.f ? m + logf(l) : CUDART_INF_F;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = out + b * os.b + h * os.h + (long long)iq * os.l;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = TPR * i + part;
    if (!PAD<HD> || c < c4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(orow + 4 * c + e, l > 0.f ? acc[4 * i + e] * inv : 0.f);
    }
  }
}

// ---------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, cp.async, wgmma
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait of more than 4 s traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if ((++spins & 1023) == 0) {
      if (t0 == 0) t0 = global_ns();
      else if (global_ns() - t0 > 4000000000ull) __trap();
    }
  }
}

// Which of the tensor map's dims 1..3 holds each of the l, h, b axes
// (the host orders them by stride).
struct TmaAxes {
  int l, h, b;
};

// The 4-D TMA box of `map` at coordinates (c0, c1, c2, c3) into shared
// memory, completing on `bar`.  The asm alone, so that the tests' CPU
// emulation (tests/cuda_emu/prims.h) can stand in for it.
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// One box (64 head-dim columns x rows along l) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, TmaAxes ax, int d,
                                         int row, int head, int batch) {
  tma_box4(dst, map, bar, d, ax.l == 1 ? row : ax.h == 1 ? head : batch,
           ax.l == 2 ? row : ax.h == 2 ? head : batch,
           ax.l == 3 ? row : ax.h == 3 ? head : batch);
}

// The 4-D TMA box of `map` at (c0, c1, c2, c3) from shared memory to
// the tensor; what falls outside the tensor is not written.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_u32(src))
      : "memory");
}

// One box from shared memory to the tensor, addressed as tma_load's.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, TmaAxes ax, int d,
                                          int row, int head, int batch) {
  tma_store4(map, src, d, ax.l == 1 ? row : ax.h == 1 ? head : batch,
             ax.l == 2 ? row : ax.h == 2 ? head : batch,
             ax.l == 3 ? row : ax.h == 3 ? head : batch);
}

// the calling thread's TMA stores so far, as one bulk group
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the calling thread's committed TMA stores have read their shared
// memory (it may be written again, or the block exit)
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads') over n threads, a
// multiple of 32: bar_sync waits until n threads have reached it,
// bar_arrive counts the caller and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// 16 bytes global -> shared; `full` false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 8 / 4 bytes global -> shared (through L1): int8 cache rows, whose
// head offset may be a multiple of 8 bytes only (hd 120), and scales
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading / stride byte offsets (16-byte units) and
// layout type 1 (SWIZZLE_128B).  Rows are 128 bytes, 8-row groups 1024
// bytes apart; buffers are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// The same for a 64-byte-swizzled operand (layout type 2): 64-byte rows,
// 8-row groups 512 bytes apart, buffers 512-byte aligned.
__device__ __forceinline__ uint64_t sw64_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// all but the most recent committed group of products done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// 1 / x on the special-function unit (+inf gives 0)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// move registers between a block's warpgroups: the calling warpgroup's
// warps take (inc) or give back (dec) registers down to N a thread
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// keep the compiler from moving accesses to accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x N, f32) += A (64 x 16) * B (16 x N), bf16.  _ss: A and B from
// shared memory, both K-major (scale_d = 0 overwrites D).  _rs: A from
// registers in the m16n8k16 fragment layout of each warp's 16 rows, B
// MN-major (transpose bit set).  The accumulator layout of warp w:
// d[4c + e] is row 16w + lane/4 + 8 (e >= 2), column 8c + 2 (lane % 4)
// + (e & 1).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---------------------------------------------------------------------
// prefill, bf16 on Hopper: TMA ring + wgmma
// ---------------------------------------------------------------------

// one arrival of the calling warp on a stage's empty barrier
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// HD 64: two blocks an SM (prefill_pair).  At hd 64 the softmax's ex2
// (16 a clock an SM) keeps pace with the tensor cores' products (about
// 17 scores a clock), so warpgroups taking turns leave little to hide;
// two 288-thread blocks (96 registers), each two consumer warpgroups of
// 64 rows walking 64-key tiles from a 2-stage TMA ring and one producer
// warp, fill the SM's gaps better: the turns body below, built at hd
// 64, measured slower at every served hd-64 shape.  Each warpgroup
// skips the tiles none of its rows sees, and its rows of O leave in
// 4-byte stores.
struct WgPair {
  static constexpr int HD = 64;
  static constexpr int BQ = 128;                  // query rows per block
  static constexpr int BK = 64;                   // keys per tile
  static constexpr int NB = 1;                    // 128-byte column blocks
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 288;             // 2 warpgroups + 1 warp
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int T_BYTES = BK * HD * 2;     // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * T_BYTES + 64;
};

// One consumer warpgroup: query rows rlo .. rlo + 63, whose Q rows start
// at qw in the Q tile; O (64 x 64) 32 accumulators a thread.  Walks the
// block's ntiles K/V tiles from kbeg, releases each stage, and stores
// its rows of O.
template <bool LSE>
__device__ __forceinline__ void pair_consume(
    const uint8_t* qw, const uint8_t* ks, const uint8_t* vs, uint64_t* qbar,
    uint64_t* full, uint64_t* empty, int ntiles, int kbeg, int rlo,
    int live, Mask mk, __nv_bfloat16* ob, Strides os, float scale,
    float softcap, float* lse) {
  using C = WgPair;
  constexpr int HD = C::HD, BK = C::BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wl = warp & 3;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int off = mk.lk - mk.lq;
  const int rA = rlo + 16 * wl + g8, rB = rA + 8;   // this thread's rows
  // keys some row of the warpgroup sees, and keys all its rows see
  int see_beg = 0, see_end = 0, all_beg = 0, all_end = 0;
  if (rlo < mk.lq) {
    const int rhi = min(rlo + 63, mk.lq - 1);
    see_end = all_end = live;
    if (mk.causal) {
      see_end = min(see_end, rhi + off + 1);
      all_end = min(all_end, rlo + off + 1);
      if (mk.window) {
        see_beg = max(0, rlo + off - mk.window + 1);
        all_beg = max(0, rhi + off - mk.window + 1);
      }
    }
  }
  const float mul = softcap != 0.f ? 1.f : scale * LOG2E;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float mA = -CUDART_INF_F, mB = -CUDART_INF_F, lA = 0.f, lB = 0.f;

  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % C::STAGES;
    const int k0 = kbeg + i * BK;
    mbar_wait(full + s, (i / C::STAGES) & 1);
    if (k0 < see_end && k0 + BK > see_beg) {
      const uint8_t* kt = ks + s * C::T_BYTES;
      const uint8_t* vt = vs + s * C::T_BYTES;
      float sc[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc,
                     sw128_desc(qw + (kk / 4) * C::BQ * 128 + (kk % 4) * 32,
                                16, 1024),
                     sw128_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                                1024),
                     kk > 0);
      wg_commit();
      wg_wait0();
      reg_fence(sc);
      // with a softcap the scores go to the log2 domain here; without
      // one, scale*log2(e) is folded into the exponent's fma (uniform)
      if (softcap != 0.f) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          sc[e] = softcap * tanhf(sc[e] * scale / softcap) * LOG2E;
      }
      if (!(k0 >= all_beg && k0 + BK <= all_end)) {      // an edge tile
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
          if (!mk.ok((e & 2) ? rB : rA, key, live)) sc[e] = -CUDART_INF_F;
        }
      }
      float xA = mA, xB = mB;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        if (e & 2) xB = fmaxf(xB, sc[e]);
        else xA = fmaxf(xA, sc[e]);
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, d));
        xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, d));
      }
      // a row with no live key so far subtracts 0: 2^-inf = 0
      const float uA = xA == -CUDART_INF_F ? 0.f : xA;
      const float uB = xB == -CUDART_INF_F ? 0.f : xB;
      const float aA = ex2((mA - uA) * mul), aB = ex2((mB - uB) * mul);
      const float nA = -uA * mul, nB = -uB * mul;
      mA = xA;
      mB = xB;
      float pA = 0.f, pB = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const float p = ex2(fmaf(sc[e], mul, (e & 2) ? nB : nA));
        sc[e] = p;
        if (e & 2) pB += p;
        else pA += p;
      }
      lA = lA * aA + pA;               // per-thread partial sums of the row
      lB = lB * aB + pB;
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= (e & 2) ? aB : aA;
      // the S accumulator's layout is the A fragment of O += P V
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n64(o, pa[kk], sw128_desc(vt + kk * 16 * 128, BK * 128,
                                           1024));
      wg_commit();
      wg_wait0();
      reg_fence(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, d);
    lB += __shfl_xor_sync(0xffffffffu, lB, d);
  }
  const float iA = lA > 0.f ? 1.f / lA : 0.f;
  const float iB = lB > 0.f ? 1.f / lB : 0.f;
  // the rows' log-sum-exp (natural log; +inf: no live key), from the
  // log2-domain max and sum: ln 2 (m mul + log2 l)
  if (LSE && t4 == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    if (rA < mk.lq)
      lse[rA] = lA > 0.f ? (mA * mul + log2f(lA)) * LN2 : CUDART_INF_F;
    if (rB < mk.lq)
      lse[rB] = lB > 0.f ? (mB * mul + log2f(lB)) * LN2 : CUDART_INF_F;
  }
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int d = 8 * c + 2 * t4;
    if (rA < mk.lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)rA * os.l + d) =
          pack_bf16(o[4 * c] * iA, o[4 * c + 1] * iA);
    if (rB < mk.lq)
      *reinterpret_cast<uint32_t*>(ob + (long long)rB * os.l + d) =
          pack_bf16(o[4 * c + 2] * iB, o[4 * c + 3] * iB);
  }
}

template <bool LSE>
__device__ __forceinline__ void prefill_pair(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    TmaAxes qa, TmaAxes ka, const int* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ out, int G, Mask mk, Strides os,
    float scale, float softcap, float* __restrict__ lse) {
  using C = WgPair;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma descriptors want 1024-byte alignment
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + C::Q_BYTES;          // [stage][column block][BK][64]
  uint8_t* vs = ks + C::STAGES * C::T_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::T_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + C::STAGES;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;   // longest first
  const int h = blockIdx.x, b = blockIdx.y, kh = h / G;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  // keys any row of this block can see
  int kbeg = 0, kend = live;
  if (mk.causal) {
    kend = min(kend, min(q0 + C::BQ, mk.lq) + off);
    if (mk.window) kbeg = max(0, q0 + off - mk.window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (t == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                        // producer
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int j = 0; j < C::NB; ++j)
        tma_load(qs + j * C::BQ * 128, &tq, qbar, qa, 64 * j, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(empty + s, (i / C::STAGES - 1) & 1);
        mbar_expect_tx(full + s, 2 * C::T_BYTES);
        const int k0 = kbeg + i * BK;
        for (int j = 0; j < C::NB; ++j) {
          tma_load(ks + s * C::T_BYTES + j * BK * 128, &tk, full + s, ka,
                   64 * j, k0, kh, b);
          tma_load(vs + s * C::T_BYTES + j * BK * 128, &tv, full + s, ka,
                   64 * j, k0, kh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows q0 + 64 wg ..
  const int wg = warp >> 2;
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
  float* lb = LSE ? lse + ((long long)b * gridDim.x + h) * mk.lq : nullptr;
  pair_consume<LSE>(qs + wg * 64 * 128, ks, vs, qbar, full, empty, ntiles,
                    kbeg, q0 + 64 * wg, live, mk, ob, os, scale, softcap, lb);
}

// HD 128 (120 in 128; prefill_turns).  Persistent: one block an SM walks
// the (query tile, head, batch) items, longest first (item t of the
// grid's stride), so one item's epilogue and the next one's loads
// overlap.  A query tile is 64 rows for each of NWG = 2 consumer
// warpgroups, each holding its rows of O (64 x HD, HD / 2 f32 a thread)
// in registers beside one S tile (64 x 128: 64 f32) and the last tile's
// P (32 bf16 pairs); a producer warpgroup keeps TMA loads in flight,
// and setmaxnreg moves its registers to the consumers (24 and 240 a
// thread).  Keys come in 128-key tiles, so Q K^T is m64n128 with both
// operands in shared memory and P V takes 8 k-steps.  Q is
// double-buffered (the next item's loads while this one computes); K
// and V fill separate rings that continue across items and empty apart
// (K's stage frees once the scores are done, V's once P V is, an
// iteration later): 3 K stages and 2 V stages beside the two Q buffers.
// The tensor cores run through the softmax two ways:
//  * within a warpgroup, tile i's Q K^T and tile i - 1's P V go out
//    together and the scores of i are exponentiated while P V runs
//    (wgmma.wait_group 1);
//  * across warpgroups, named barriers make them issue their products
//    in turn: each waits on its own barrier (SCHED_BAR + w) before it
//    issues and counts itself on the next one's once its products are
//    out, so one's softmax falls in the other's products.
// Every consumer walks all its item's tiles (a row that sees none of a
// tile masks it whole), so every branch taken while a product is in
// flight is uniform over the block, and no accumulator is read while
// its product may be in flight: ptxas serializes the products otherwise
// (C7514 / C7515 in the build log).  O leaves through shared memory:
// each warpgroup writes its rows into its own rows of the item's Q
// buffer (its Q K^T are done; the other reads only its own) in the TMA
// box layout, and one TMA store per 64-column block writes what lies
// inside the output (rows past Lq and columns past hd are clipped); the
// stores are waited for, and the buffer handed back to the producer,
// only as the next item starts.  Each of these measured faster than its
// alternative at the served hd-128 shapes (one Q buffer with a fourth K
// stage, a block an item, no turns; an item's last P V issued with the
// next item's first Q K^T made ptxas serialize the products).
template <int HD>
struct Wg {
  static constexpr int NWG = 2;                   // consumer warpgroups
  static constexpr int BQ = 64 * NWG;             // query rows per item
  static constexpr int BK = 128;                  // keys per tile
  static constexpr int NB = HD / 64;              // 128-byte column blocks
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int QBUFS = 2;                 // Q buffers
  static constexpr int Q_BYTES = BQ * HD * 2;     // one Q buffer
  static constexpr int T_BYTES = BK * HD * 2;     // one K or V tile
  static constexpr int BAR_BYTES = 256;
  // V stages, and as many K stages as fit beside them and the Q buffers
  // in 227 KB: K is needed a tile ahead of V (tile i's Q K^T goes out
  // with tile i - 1's P V)
  static constexpr int VSTAGES = 2;
  static constexpr int KSTAGES =
      (232448 - 1024 - QBUFS * Q_BYTES - VSTAGES * T_BYTES - BAR_BYTES) /
      T_BYTES;
  static constexpr int SMEM = 1024 + QBUFS * Q_BYTES +
                              (KSTAGES + VSTAGES) * T_BYTES + BAR_BYTES;
  static_assert(KSTAGES >= 2 &&
                8 * (2 * QBUFS + 2 * KSTAGES + 2 * VSTAGES) <= BAR_BYTES,
                "ring");
};

// The prefill consumers' named barriers: warpgroup w waits on
// SCHED_BAR + w for its turn to issue products, and on EPI_BAR + w for
// its rows of O in shared memory.
constexpr int SCHED_BAR = 1, EPI_BAR = 4;

template <int HD, bool LSE>
__device__ __forceinline__ void prefill_turns(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& to, TmaAxes qa, TmaAxes ka, TmaAxes oa,
    const int* __restrict__ kv_valid, int B, int Hq, int G, Mask mk,
    float scale, float softcap, float* __restrict__ lse) {
  using C = Wg<HD>;
  constexpr int BK = C::BK, SK = C::KSTAGES, SV = C::VSTAGES;
  constexpr int NWG = C::NWG, QB = C::QBUFS;
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma descriptors want 1024-byte alignment
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + QB * C::Q_BYTES;     // [stage][column block][BK][64]
  uint8_t* vs = ks + SK * C::T_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + SV * C::T_BYTES);
  uint64_t* qempty = qfull + QB;
  uint64_t* kfull = qempty + QB;
  uint64_t* kempty = kfull + SK;
  uint64_t* vfull = kempty + SK;
  uint64_t* vempty = vfull + SV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (mk.lq + C::BQ - 1) / C::BQ;
  const int n_items = nq * Hq * B;
  const int off = mk.lk - mk.lq;
  // item t: query tile nq - 1 - t / (Hq B) (the longest first: the last
  // items are the shortest), then head and batch; the keys any of its
  // rows can see, as 128-key tiles from kbeg (the same numbers in every
  // thread of the block)
  int q0, h, b, live, kbeg, ntiles;
  auto item = [&](int t) {
    const int per = Hq * B, r = t / per, hb = t - r * per;
    q0 = (nq - 1 - r) * C::BQ;
    h = hb % Hq;
    b = hb / Hq;
    live = live_keys(kv_valid, b, mk.lk);
    kbeg = 0;
    int kend = live;
    if (mk.causal) {
      kend = min(kend, min(q0 + C::BQ, mk.lq) + off);
      if (mk.window) kbeg = max(0, q0 + off - mk.window + 1);
    }
    ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, NWG);         // each warpgroup's storing thread
    }
    for (int i = 0; i < SK; ++i) {        // one arrival per consumer warp
      mbar_init(kfull + i, 1);
      mbar_init(kempty + i, 4 * NWG);
    }
    for (int i = 0; i < SV; ++i) {
      mbar_init(vfull + i, 1);
      mbar_init(vempty + i, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                  // producers: the first warp Q
    reg_dealloc<C::PRODUCER_REGS>();      // and K, the second V
    const int pw = warp - 4 * NWG;
    if (pw < 2 && lane == 0) {
      const bool kp = pw == 0;
      const int S = kp ? SK : SV;
      uint8_t* dst = kp ? ks : vs;
      uint64_t* fb = kp ? kfull : vfull;
      uint64_t* eb = kp ? kempty : vempty;
      int it = 0;                         // tiles loaded so far
      for (int t = blockIdx.x, j = 0; t < n_items; t += gridDim.x, ++j) {
        item(t);
        if (kp) {                         // the item's Q, into buffer j % QB
          const int qb = j % QB;
          if (j >= QB) mbar_wait(qempty + qb, (j / QB - 1) & 1);
          if (ntiles > 0) {
            mbar_expect_tx(qfull + qb, C::Q_BYTES);
            for (int c = 0; c < C::NB; ++c)
              tma_load(qs + qb * C::Q_BYTES + c * C::BQ * 128, &tq,
                       qfull + qb, qa, 64 * c, q0, h, b);
          } else {
            mbar_arrive(qfull + qb);      // nothing to load: the phase ends
          }
        }
        for (int i = 0; i < ntiles; ++i, ++it) {
          const int s = it % S, k0 = kbeg + i * BK;
          if (it >= S) mbar_wait(eb + s, (it / S - 1) & 1);
          mbar_expect_tx(fb + s, C::T_BYTES);
          for (int c = 0; c < C::NB; ++c) {
            uint8_t* box = dst + s * C::T_BYTES + c * BK * 128;
            if (kp) tma_load(box, &tk, fb + s, ka, 64 * c, k0, h / G, b);
            else tma_load(box, &tv, fb + s, ka, 64 * c, k0, h / G, b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows q0 + 64 wg .. + 63 of each item
  reg_alloc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  // with a softcap the scores go to the log2 domain as they are capped;
  // without one, scale*log2(e) is folded into the exponent's fma
  const float mul = softcap != 0.f ? 1.f : scale * LOG2E;
  float o[HD / 2];
  float mA, mB, lA, lB;
  int rA, rB, all_beg, all_end;
  const uint8_t* qw;
  uint32_t pa[BK / 16][4];                // P of the last tile
  // tile i's scores to probabilities, the running max and sums updated;
  // returns O's rescale factors in aA, aB
  auto softmax = [&](float (&sc)[BK / 2], int k0, float& aA, float& aB) {
    if (softcap != 0.f) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        sc[e] = softcap * tanhf(sc[e] * scale / softcap) * LOG2E;
    }
    if (!(k0 >= all_beg && k0 + BK <= all_end)) {      // an edge tile
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        if (!mk.ok((e & 2) ? rB : rA, key, live)) sc[e] = -CUDART_INF_F;
      }
    }
    float xA = mA, xB = mB;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      if (e & 2) xB = fmaxf(xB, sc[e]);
      else xA = fmaxf(xA, sc[e]);
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, d));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, d));
    }
    // a row with no live key so far subtracts 0: 2^-inf = 0
    const float uA = xA == -CUDART_INF_F ? 0.f : xA;
    const float uB = xB == -CUDART_INF_F ? 0.f : xB;
    aA = ex2((mA - uA) * mul);
    aB = ex2((mB - uB) * mul);
    const float nA = -uA * mul, nB = -uB * mul;
    mA = xA;
    mB = xB;
    float pA = 0.f, pB = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const float p = ex2(fmaf(sc[e], mul, (e & 2) ? nB : nA));
      sc[e] = p;
      if (e & 2) pB += p;
      else pA += p;
    }
    lA = lA * aA + pA;                    // per-thread partial sums of the row
    lB = lB * aB + pB;
  };
  // the S accumulator's layout is the A fragment of O += P V
  auto pack = [&](const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };
  // O to the max of the tile whose P goes out next
  auto rescale = [&](float aA, float aB) {
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= (e & 2) ? aB : aA;
  };
  // S (64 x BK) = Q K^T: Q and K K-major in 64-column blocks; issued,
  // not waited for
  auto qk = [&](float (&sc)[BK / 2], const uint8_t* kt) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n128(sc,
                    sw128_desc(qw + (kk / 4) * C::BQ * 128 + (kk % 4) * 32,
                               16, 1024),
                    sw128_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16,
                               1024),
                    kk > 0);
  };
  // O += P V, V read MN-major; issued, not waited for
  auto pv = [&](const uint8_t* vt) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<HD>(o, pa[kk], sw128_desc(vt + kk * 16 * 128, BK * 128, 1024));
  };
  // the warpgroups' turns: each round waits on its own barrier, issues,
  // then counts itself on the next one's; warpgroup 0 goes first
  const int mine = SCHED_BAR + wg, next = SCHED_BAR + (wg + 1) % NWG;
  if (wg == NWG - 1) bar_arrive(SCHED_BAR, 256);

  // item j's Q buffer back to the producer once the O stores from it
  // have read it (at the start of item j + 1, by each warpgroup's first
  // thread: the stores run beside the next item's first products)
  auto hand_back = [&](int j) {
    if ((threadIdx.x & 127) == 0) {
      tma_store_drain();
      mbar_arrive(qempty + j % QB);
    }
  };
  int it = 0;                             // tiles consumed so far
  for (int t = blockIdx.x, j = 0; t < n_items; t += gridDim.x, ++j) {
    item(t);
    if (j > 0) hand_back(j - 1);
    const int qb = j % QB;
    uint8_t* qbuf = qs + qb * C::Q_BYTES;
    qw = qbuf + wg * 64 * 128;
    rA = q0 + 64 * wg + 16 * wl + g8;     // this thread's rows
    rB = rA + 8;
    // keys every row of the item sees, from its index and the mask alone
    // (a kv_valid makes every tile an edge tile)
    all_beg = 0;
    all_end = kv_valid == nullptr ? mk.lk : 0;
    if (mk.causal) {
      all_end = min(all_end, q0 + off + 1);
      if (mk.window)
        all_beg = max(0, min(q0 + C::BQ, mk.lq) - 1 + off - mk.window + 1);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    mA = mB = -CUDART_INF_F;
    lA = lB = 0.f;
    mbar_wait(qfull + qb, (j / QB) & 1);
    if (ntiles > 0) {
      float sc[BK / 2], aA, aB;
      int sk = it % SK, sv = 0;           // the tile's K and V stages
      mbar_wait(kfull + sk, (it / SK) & 1);
      bar_sync(mine, 256);
      wg_fence();
      qk(sc, ks + sk * C::T_BYTES);
      wg_commit();
      bar_arrive(next, 256);
      wg_wait0();
      reg_fence(sc);
      release_stage(kempty + sk);
      softmax(sc, kbeg, aA, aB);
      pack(sc);
      for (int i = 1; i < ntiles; ++i) {
        // tile i's Q K^T and tile i - 1's P V go out together (O
        // rescaled to tile i - 1's max between them); the softmax of i
        // runs while P V does
        sk = (it + i) % SK;
        sv = (it + i - 1) % SV;
        mbar_wait(kfull + sk, ((it + i) / SK) & 1);
        mbar_wait(vfull + sv, ((it + i - 1) / SV) & 1);
        bar_sync(mine, 256);
        wg_fence();
        qk(sc, ks + sk * C::T_BYTES);
        wg_commit();
        rescale(aA, aB);
        wg_fence();
        pv(vs + sv * C::T_BYTES);
        wg_commit();
        bar_arrive(next, 256);
        wg_wait1();
        reg_fence(sc);
        release_stage(kempty + sk);       // the scores are done with K
        softmax(sc, kbeg + i * BK, aA, aB);
        wg_wait0();                       // O holds tile i - 1's P V
        reg_fence(o);
        release_stage(vempty + sv);
        pack(sc);
      }
      sv = (it + ntiles - 1) % SV;
      mbar_wait(vfull + sv, ((it + ntiles - 1) / SV) & 1);
      bar_sync(mine, 256);
      rescale(aA, aB);
      wg_fence();
      pv(vs + sv * C::T_BYTES);
      wg_commit();
      bar_arrive(next, 256);
      wg_wait0();
      reg_fence(o);
      release_stage(vempty + sv);
      it += ntiles;
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      lA += __shfl_xor_sync(0xffffffffu, lA, d);
      lB += __shfl_xor_sync(0xffffffffu, lB, d);
    }
    const float iA = lA > 0.f ? 1.f / lA : 0.f;
    const float iB = lB > 0.f ? 1.f / lB : 0.f;
    // the rows' log-sum-exp (natural log; +inf: no live key), from the
    // log2-domain max and sum: ln 2 (m mul + log2 l)
    if (LSE && t4 == 0) {
      constexpr float LN2 = 0.6931471805599453f;
      float* lb = lse + ((long long)b * Hq + h) * mk.lq;
      if (rA < mk.lq)
        lb[rA] = lA > 0.f ? (mA * mul + log2f(lA)) * LN2 : CUDART_INF_F;
      if (rB < mk.lq)
        lb[rB] = lB > 0.f ? (mB * mul + log2f(lB)) * LN2 : CUDART_INF_F;
    }
    // O into this warpgroup's rows of the Q buffer (its Q K^T are done;
    // the other warpgroup reads only its own) in the box layout of the
    // 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)), then
    // one thread stores the 64 rows
    uint8_t* ow = qbuf + wg * 64 * 128;
    const int ra = 16 * wl + g8;          // rows ra and ra + 8 of ow
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      uint8_t* row = ow + (c / 8) * C::BQ * 128 + ra * 128 + 4 * t4;
      const int ch = ((c & 7) ^ g8) << 4;
      *reinterpret_cast<uint32_t*>(row + ch) =
          pack_bf16(o[4 * c] * iA, o[4 * c + 1] * iA);
      *reinterpret_cast<uint32_t*>(row + 8 * 128 + ch) =
          pack_bf16(o[4 * c + 2] * iB, o[4 * c + 3] * iB);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(EPI_BAR + wg, 128);
    if ((threadIdx.x & 127) == 0 && q0 + 64 * wg < mk.lq) {
      for (int c = 0; c < C::NB; ++c)
        tma_store(&to, ow + c * C::BQ * 128, oa, 64 * c, q0 + 64 * wg, h, b);
      tma_store_commit();
    }
  }
  if (blockIdx.x < n_items) hand_back((n_items - 1 - blockIdx.x) /
                                      gridDim.x);
  if (wg == 0) bar_sync(SCHED_BAR, 256);  // the last warpgroup's last turn
}

// The launch shape of prefill_wgmma_kernel<HD>: the body and its block.
template <int HD>
struct PrefillCfg {
  static constexpr bool PAIR = HD == 64;
  static constexpr int THREADS = PAIR ? WgPair::THREADS : Wg<HD>::THREADS;
  static constexpr int MIN_BLOCKS = PAIR ? 2 : 1;   // per SM
  static constexpr int SMEM = PAIR ? WgPair::SMEM : Wg<HD>::SMEM;
  static constexpr int BQ = PAIR ? WgPair::BQ : Wg<HD>::BQ;
  static constexpr int BK = PAIR ? WgPair::BK : Wg<HD>::BK;
};

// bf16 prefill on wgmma: prefill_pair at hd 64, prefill_turns at 120
// and 128 (`to`, `oa` and B serve the latter; `out` and `os` the
// former, whose grid is (Hq, B, query tiles))
template <int HD, bool LSE>
__global__ void __launch_bounds__(PrefillCfg<HD>::THREADS,
                                  PrefillCfg<HD>::MIN_BLOCKS)
prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, TmaAxes qa,
                     TmaAxes ka, TmaAxes oa,
                     const int* __restrict__ kv_valid,
                     __nv_bfloat16* __restrict__ out, Strides os, int B,
                     int Hq, int G, Mask mk, float scale, float softcap,
                     float* __restrict__ lse) {
  if constexpr (PrefillCfg<HD>::PAIR)
    prefill_pair<LSE>(tq, tk, tv, qa, ka, kv_valid, out, G, mk, os, scale,
                      softcap, lse);
  else
    prefill_turns<HD, LSE>(tq, tk, tv, to, qa, ka, oa, kv_valid, B, Hq, G,
                           mk, scale, softcap, lse);
}

// hd 288 (gemma2-2b): each consumer warpgroup owns 64 query rows of a
// 128-row block and holds their O (64 x 288, 144 f32 a thread) in
// registers beside one S tile (32) and its P (16 bf16 pairs); 384
// threads, the producer warpgroup's registers moved to the two
// consumers by setmaxnreg (24 and 240 a thread), so Q K^T, the softcap
// and the softmax run once per score.  Shared memory binds: at 288
// columns Q is 72 KB and a 64-key K or V tile 36 KB, two stages, 217 KB
// (one block an SM).  No padding to 320: every operand is stored as 9
// column blocks of 32 (64-byte rows, TMA's 64-byte swizzle, read by the
// wgmma descriptors of layout type 2), so O's 288 columns are three
// m64n96 products.  The softmax overlaps the products: tile j's Q K^T
// and tile j-1's P V go out together, the scores of j are softcapped
// and exponentiated while P V runs (wgmma.wait_group 1), and O is
// rescaled once that group is done.  The K and V rings fill and empty
// apart (producer warps 8 and 9): K's stage is free once the scores
// are, an iteration before V's, so the next K tiles load through the
// softmax and P V (one barrier for both left the products waiting on
// the loads: 1.08 against 0.78 ms at B=4, L=4,608 on an H100 80GB HBM3
// at 700 W, tools/prefill_times.py --rows hd288).  The softcap is
// tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) on the SFU (ex2, rcp: within
// about 1e-6 of tanhf), in the log2 domain.
struct WgWide {
  static constexpr int HD = 288;
  static constexpr int BQ = 128;                  // query rows per block
  static constexpr int BK = 64;                   // keys per tile
  static constexpr int NB = HD / 32;              // 64-byte column blocks
  static constexpr int ON = 96;                   // O columns a product
  static constexpr int NO = HD / ON;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 384;             // 3 warpgroups
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int T_BYTES = BK * HD * 2;     // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * T_BYTES + 128;
};

// O (three 64 x 96 accumulators) += P (64 x BK, fragments pa) V, V's
// BK rows at vt in 32-column blocks; issued, not waited for
template <int BK>
__device__ __forceinline__ void wide_pv(float (&o)[WgWide::NO][WgWide::ON / 2],
                                        const uint32_t (&pa)[BK / 16][4],
                                        const uint8_t* vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int n = 0; n < WgWide::NO; ++n)
      wgmma_rs<WgWide::ON>(o[n], pa[kk],
                           sw64_desc(vt + (3 * n * BK + 16 * kk) * 64,
                                     BK * 64, 512));
}

// S (64 x BK) = Q K^T over the 288 columns: the warpgroup's 64 Q rows
// at qw and the tile's BK K rows at kt, both in 32-column blocks
template <int BK>
__device__ __forceinline__ void wide_qk(float (&sc)[BK / 2],
                                        const uint8_t* qw,
                                        const uint8_t* kt) {
#pragma unroll
  for (int kk = 0; kk < WgWide::HD / 16; ++kk)
    wgmma_ss_n64(sc,
                 sw64_desc(qw + (kk / 2) * WgWide::BQ * 64 + (kk % 2) * 32,
                           16, 512),
                 sw64_desc(kt + (kk / 2) * BK * 64 + (kk % 2) * 32, 16, 512),
                 kk > 0);
}

// wait for every product, then mark O's registers as written here
__device__ __forceinline__ void wide_wait_o(
    float (&o)[WgWide::NO][WgWide::ON / 2]) {
  wg_wait0();
#pragma unroll
  for (int n = 0; n < WgWide::NO; ++n) reg_fence(o[n]);
}

template <bool LSE>
__global__ void __launch_bounds__(WgWide::THREADS, 1)
prefill_wide_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, TmaAxes qa,
                    TmaAxes ka, const int* __restrict__ kv_valid,
                    __nv_bfloat16* __restrict__ out, int G, Mask mk,
                    Strides os, float scale, float softcap,
                    float* __restrict__ lse) {
  using C = WgWide;
  constexpr int BK = C::BK, S = C::STAGES, NO = C::NO;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + C::Q_BYTES;          // [stage][column block][BK][32]
  uint8_t* vs = ks + S * C::T_BYTES;
  // K and V stages fill and empty apart: K's when the scores are done,
  // V's when P V is, an iteration later
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + S * C::T_BYTES);
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + S;
  uint64_t* vfull = kempty + S;
  uint64_t* vempty = vfull + S;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;   // longest first
  const int h = blockIdx.x, b = blockIdx.y, kh = h / G;
  const int live = live_keys(kv_valid, b, mk.lk);
  const int off = mk.lk - mk.lq;
  // keys any row of this block can see
  int kbeg = 0, kend = live;
  if (mk.causal) {
    kend = min(kend, min(q0 + C::BQ, mk.lq) + off);
    if (mk.window) kbeg = max(0, q0 + off - mk.window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(kfull + i, 1);
      mbar_init(kempty + i, 256);         // every consumer thread arrives
      mbar_init(vfull + i, 1);
      mbar_init(vempty + i, 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                        // producers: warp 8 Q and K,
    reg_dealloc<C::PRODUCER_REGS>();      // warp 9 V
    if (warp < 10 && lane == 0 && ntiles > 0) {
      const bool kp = warp == 8;
      uint8_t* dst = kp ? ks : vs;
      uint64_t* fb = kp ? kfull : vfull;
      uint64_t* eb = kp ? kempty : vempty;
      if (kp) {
        mbar_expect_tx(qbar, C::Q_BYTES);
        for (int j = 0; j < C::NB; ++j)
          tma_load(qs + j * C::BQ * 64, &tq, qbar, qa, 32 * j, q0, h, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % S, k0 = kbeg + i * BK;
        if (i >= S) mbar_wait(eb + s, (i / S - 1) & 1);
        mbar_expect_tx(fb + s, C::T_BYTES);
        for (int j = 0; j < C::NB; ++j) {
          uint8_t* box = dst + s * C::T_BYTES + j * BK * 64;
          if (kp) tma_load(box, &tk, fb + s, ka, 32 * j, k0, kh, b);
          else tma_load(box, &tv, fb + s, ka, 32 * j, k0, kh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows q0 + 64 wg .. + 63.  Both walk
  // all ntiles tiles (a row that sees none of a tile masks it whole),
  // and every branch taken while a product is in flight is uniform over
  // the block, so no wgmma is serialized.
  reg_alloc<C::CONSUMER_REGS>();
  const int wg = warp >> 2, wl = warp & 3, g8 = lane >> 2, t4 = lane & 3;
  const int rA = q0 + 64 * wg + 16 * wl + g8, rB = rA + 8;   // this thread's rows
  const uint8_t* qw = qs + wg * 64 * 64;
  // keys every row of the block sees, from the block's index and the
  // mask alone (a kv_valid makes every tile an edge tile)
  int all_beg = 0, all_end = kv_valid == nullptr ? mk.lk : 0;
  if (mk.causal) {
    all_end = min(all_end, q0 + off + 1);
    if (mk.window)
      all_beg = max(0, min(q0 + C::BQ, mk.lq) - 1 + off - mk.window + 1);
  }
  // with a softcap the scores go to the log2 domain as they are capped:
  // softcap tanh(y) log2 e = c1 - c2 / (2^(x k2) + 1), y = x scale /
  // softcap; without one, scale log2 e is folded into the exponent's fma
  const float mul = softcap != 0.f ? 1.f : scale * LOG2E;
  const float k2 = softcap != 0.f ? 2.f * scale * LOG2E / softcap : 0.f;
  const float c1 = softcap * LOG2E, c2 = 2.f * softcap * LOG2E;
  float o[NO][C::ON / 2];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) o[n][i] = 0.f;
  float mA = -CUDART_INF_F, mB = -CUDART_INF_F, lA = 0.f, lB = 0.f;
  uint32_t pa[BK / 16][4];                // P of the last tile
  // tile i's scores to P (pa), the running max and sums updated; returns
  // O's rescale factors in aA, aB
  auto softmax = [&](float (&sc)[BK / 2], int k0, float& aA, float& aB) {
    if (softcap != 0.f) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        sc[e] = c1 - c2 * rcp(ex2(sc[e] * k2) + 1.f);
    }
    if (!(k0 >= all_beg && k0 + BK <= all_end)) {      // an edge tile
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        if (!mk.ok((e & 2) ? rB : rA, key, live)) sc[e] = -CUDART_INF_F;
      }
    }
    float xA = mA, xB = mB;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      if (e & 2) xB = fmaxf(xB, sc[e]);
      else xA = fmaxf(xA, sc[e]);
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      xA = fmaxf(xA, __shfl_xor_sync(0xffffffffu, xA, d));
      xB = fmaxf(xB, __shfl_xor_sync(0xffffffffu, xB, d));
    }
    // a row with no live key so far subtracts 0: 2^-inf = 0
    const float uA = xA == -CUDART_INF_F ? 0.f : xA;
    const float uB = xB == -CUDART_INF_F ? 0.f : xB;
    aA = ex2((mA - uA) * mul);
    aB = ex2((mB - uB) * mul);
    const float nA = -uA * mul, nB = -uB * mul;
    mA = xA;
    mB = xB;
    float pA = 0.f, pB = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const float p = ex2(fmaf(sc[e], mul, (e & 2) ? nB : nA));
      sc[e] = p;
      if (e & 2) pB += p;
      else pA += p;
    }
    lA = lA * aA + pA;                    // per-thread partial sums of the row
    lB = lB * aB + pB;
  };
  // the S accumulator's layout is the A fragment of O += P V
  auto pack = [&](const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  if (ntiles > 0) {
    float sc[BK / 2], aA, aB;
    mbar_wait(qbar, 0);
    mbar_wait(kfull, 0);
    wg_fence();
    wide_qk<BK>(sc, qw, ks);
    wg_commit();
    wg_wait0();
    reg_fence(sc);
    mbar_arrive(kempty);
    softmax(sc, kbeg, aA, aB);
    pack(sc);
    for (int i = 1; i < ntiles; ++i) {
      // tile i's Q K^T and tile i - 1's P V go out together; the
      // softmax of i runs while P V does
      const int s = i % S, sp = (i - 1) % S;
      mbar_wait(kfull + s, (i / S) & 1);
      mbar_wait(vfull + sp, ((i - 1) / S) & 1);
      wg_fence();
      wide_qk<BK>(sc, qw, ks + s * C::T_BYTES);
      wg_commit();
      wide_pv<BK>(o, pa, vs + sp * C::T_BYTES);
      wg_commit();
      wg_wait1();
      reg_fence(sc);
      mbar_arrive(kempty + s);            // the scores are done with K
      softmax(sc, kbeg + i * BK, aA, aB);
      wide_wait_o(o);                     // O holds tile i - 1's P V
      release_stage(vempty + sp);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < C::ON / 2; ++e) o[n][e] *= (e & 2) ? aB : aA;
      pack(sc);
    }
    const int sl = (ntiles - 1) % S;
    mbar_wait(vfull + sl, ((ntiles - 1) / S) & 1);
    wg_fence();
    wide_pv<BK>(o, pa, vs + sl * C::T_BYTES);
    wg_commit();
    wide_wait_o(o);
    release_stage(vempty + sl);
  }

#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, d);
    lB += __shfl_xor_sync(0xffffffffu, lB, d);
  }
  const float iA = lA > 0.f ? 1.f / lA : 0.f;
  const float iB = lB > 0.f ? 1.f / lB : 0.f;
  // the rows' log-sum-exp (natural log; +inf: no live key), from the
  // log2-domain max and sum: ln 2 (m mul + log2 l)
  if (LSE && t4 == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    float* lb = lse + ((long long)b * gridDim.x + h) * mk.lq;
    if (rA < mk.lq)
      lb[rA] = lA > 0.f ? (mA * mul + log2f(lA)) * LN2 : CUDART_INF_F;
    if (rB < mk.lq)
      lb[rB] = lB > 0.f ? (mB * mul + log2f(lB)) * LN2 : CUDART_INF_F;
  }
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < C::ON / 8; ++c) {
      const int d = C::ON * n + 8 * c + 2 * t4;
      if (rA < mk.lq)
        *reinterpret_cast<uint32_t*>(ob + (long long)rA * os.l + d) =
            pack_bf16(o[n][4 * c] * iA, o[n][4 * c + 1] * iA);
      if (rB < mk.lq)
        *reinterpret_cast<uint32_t*>(ob + (long long)rB * os.l + d) =
            pack_bf16(o[n][4 * c + 2] * iB, o[n][4 * c + 3] * iB);
    }
}

// ---------------------------------------------------------------------
// decode (Lq = 1): split-KV partials, then an ordered merge
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

__device__ __forceinline__ void unpack16(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

constexpr int DEC_THREADS = 128;

template <typename T, int HD>
struct Dec {
  static constexpr int VEC = 16 / sizeof(T);      // elements per 16 bytes
  static constexpr int CH = HD / VEC;             // 16-byte pieces a row
  // lanes per key row (a power of two up to 32) and pieces per lane
  static constexpr int LPR = CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int NPL = (CH + LPR - 1) / LPR;
  static constexpr int KPW = 32 / LPR;            // keys a warp scores at once
  // keys per sub-tile: 8 KB of K and 8 KB of V, 8..64 keys
  static constexpr int TK_ = 8192 / (HD * (int)sizeof(T));
  static constexpr int TK = TK_ > 64 ? 64 : TK_ < 8 ? 8 : TK_;
  static constexpr int GB = 1024 / HD;            // query heads per block
  static constexpr int NP =                       // pairs per thread
      (GB * HD / 2 + DEC_THREADS - 1) / DEC_THREADS;
};

// Block (split, kv head x head group, batch): keys [lo, hi) of chunk
// `split` for up to GB query heads of one KV group.  Writes, per head,
// acc[hd] (unnormalised) to part[((b Hq + h) n_split + split) hd] and
// (m, l) -- m in the log2 domain -- to ml at the same index times 2.
template <typename T, int HD>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_valid,
                    float* __restrict__ part, float* __restrict__ ml, int G,
                    Mask mk, Strides qs, Strides ks, Strides vs, float scale,
                    float softcap, int chunk, int hd) {
  using C = Dec<T, HD>;
  if constexpr (!PAD<HD>) hd = HD;
  constexpr int TK = C::TK, VEC = C::VEC, LPR = C::LPR, KPW = C::KPW;
  constexpr int CH = C::CH, NPL = C::NPL;
  __shared__ __align__(16) T kt[2][TK * HD];
  __shared__ __align__(16) T vt[2][TK * HD];
  __shared__ __align__(16) float qsh[C::GB * HD];
  __shared__ float sc[C::GB][TK];
  __shared__ float mrow[C::GB], lrow[C::GB], arow[C::GB];

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int ngrp = (G + C::GB - 1) / C::GB;
  const int kh = blockIdx.y / ngrp, g0 = (blockIdx.y % ngrp) * C::GB;
  const int ng = min(C::GB, G - g0);
  const int b = blockIdx.z;
  const int Hq = G * (gridDim.y / ngrp);
  const int hq0 = kh * G + g0;
  const long long slot = ((long long)b * Hq + hq0) * n_split + split;
  const int ch = hd / VEC;              // live pieces of a row

  int lo = 0, hi = live_keys(kv_valid, b, mk.lk);
  if (mk.local) lo = hi - mk.local;     // the window ends at the live count
  if (mk.causal) {                      // the one row sits at Lk - 1
    hi = min(hi, mk.lk);
    if (mk.window) lo = max(lo, mk.lk - mk.window);
  }
  if (mk.first != nullptr) lo = max(lo, mk.first[b]);
  lo = max(lo, split * chunk);
  hi = min(hi, split * chunk + chunk);
  if (lo >= hi) {                       // no live key: an empty partial
    for (int g = t; g < ng; g += DEC_THREADS) {
      ml[2 * (slot + (long long)g * n_split)] = -CUDART_INF_F;
      ml[2 * (slot + (long long)g * n_split) + 1] = 0.f;
    }
    return;
  }

  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  auto load_tile = [&](int st, int k0) {
    for (int e = t; e < TK * CH; e += DEC_THREADS) {
      const int j = e / CH, c = e - j * CH;
      const bool in = k0 + j < hi && (!PAD<HD> || c < ch);
      const long long key = k0 + j < hi ? k0 + j : lo;  // a valid address
      const int cs = PAD<HD> ? min(c, ch - 1) : c;
      cp_async16(&kt[st][j * HD + c * VEC], kb + key * ks.l + cs * VEC, in);
      cp_async16(&vt[st][j * HD + c * VEC], vb + key * vs.l + cs * VEC, in);
    }
    cp_async_commit();
  };
  load_tile(0, lo);

  for (int e = t; e < ng * HD; e += DEC_THREADS) {
    const int g = e / HD, d = e - g * HD;
    qsh[e] = !PAD<HD> || d < hd
                 ? to_f(q[b * qs.b + (long long)(hq0 + g) * qs.h + d]) * scale
                 : 0.f;
  }
  if (t < C::GB) {
    mrow[t] = -CUDART_INF_F;
    lrow[t] = 0.f;
  }
  float acc[C::NP][2];
#pragma unroll
  for (int i = 0; i < C::NP; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int ntile = (hi - lo + TK - 1) / TK;
  const int sub = lane / LPR, piece = lane % LPR;
  for (int it = 0; it < ntile; ++it) {
    const int st = it & 1, k0 = lo + it * TK;
    if (it + 1 < ntile) load_tile(st ^ 1, k0 + TK);
    else cp_async_commit();               // an empty group: wait 1 holds
    cp_async_wait1();
    __syncthreads();
    // scores: LPR lanes per key row, NPL pieces of 16 bytes each,
    // reduced by shuffles
    for (int j = w * KPW + sub; j < TK; j += 4 * KPW) {
      float kf[NPL][VEC];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int c = piece + LPR * i;
        if (c < CH) {
          unpack16(&kt[st][j * HD + c * VEC], kf[i]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[i][e] = 0.f;
        }
      }
      const bool ok = k0 + j < hi;
      for (int g = 0; g < ng; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int c = piece + LPR * i;
          if (c < CH) {
            const float* qg = qsh + g * HD + c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot = fmaf(qg[e], kf[i][e], dot);
          }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (piece == 0) {
          if (softcap != 0.f) dot = softcap * tanhf(dot / softcap);
          sc[g][j] = ok ? dot * LOG2E : -CUDART_INF_F;
        }
      }
    }
    __syncthreads();
    // online softmax per head, one warp per head
    for (int g = w; g < ng; g += DEC_THREADS / 32) {
      float mx = -CUDART_INF_F;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, sc[g][j]);
      mx = warp_max(mx);
      const float mold = mrow[g], mnew = fmaxf(mold, mx);
      const float use = mnew == -CUDART_INF_F ? 0.f : mnew;
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = ex2(sc[g][j] - use);
        sc[g][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = ex2(mold - use);
        arow[g] = a;
        lrow[g] = lrow[g] * a + sum;
        mrow[g] = mnew;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V: a thread holds NP (head, dim pair) slots
#pragma unroll
    for (int i = 0; i < C::NP; ++i) {
      const int idx = t + DEC_THREADS * i;
      const int g = idx / (HD / 2), dp = idx - g * (HD / 2);
      if (g < ng) {
        const float a = arow[g];
        float x = acc[i][0] * a, y = acc[i][1] * a;
        const T* vr = &vt[st][2 * dp];
#pragma unroll 8
        for (int j = 0; j < TK; ++j) {
          const float p = sc[g][j];
          const float2 vv = load2(vr + j * HD);
          x = fmaf(p, vv.x, x);
          y = fmaf(p, vv.y, y);
        }
        acc[i][0] = x;
        acc[i][1] = y;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < C::NP; ++i) {
    const int idx = t + DEC_THREADS * i;
    const int g = idx / (HD / 2), dp = idx - g * (HD / 2);
    if (g < ng && (!PAD<HD> || 2 * dp < hd)) {
      float* pr = part + (slot + (long long)g * n_split) * hd + 2 * dp;
      pr[0] = acc[i][0];
      pr[1] = acc[i][1];
    }
  }
  if (t < ng) {
    ml[2 * (slot + (long long)t * n_split)] = mrow[t];
    ml[2 * (slot + (long long)t * n_split) + 1] = lrow[t];
  }
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).  Fragment
// layout (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8..,
// n g); d0 d1 (g, 2t..2t+1), d2 d3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8; .trans hands out the transposes
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The reference's dequantized cache elements: bf16(bf16(x) * bf16(s)),
// two at a time.  bf16 holds every int8 exactly and the f32 product of
// two bf16 values is exact, so rounding it once to bf16 gives the same
// bits as the reference's bf16 multiply.  `sb` is bf16(s) as a float.
__device__ __forceinline__ uint32_t deq8x2(int8_t x0, int8_t x1, float sb) {
  const __nv_bfloat162 p = __floats2bfloat162_rn((float)x0 * sb,
                                                 (float)x1 * sb);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The int8 cache's staging of the tensor-core decodes: a stage holds R
// rows of K and of V (HD bytes a row, zeros past hd and past the live
// keys) and their R + R f32 scales.  NT threads (a warp or the block;
// `tid` is the caller's index among them) share a stage: q8_fetch puts
// it in flight with 8-byte and 4-byte cp.async (an int8 row's head
// offset is a multiple of 8 bytes only at hd 120); q8_dequant turns a
// landed stage into R rows of the PITCH-padded bf16 tiles the ldmatrix
// code reads, each value bf16(bf16(x) * bf16(s)) as dequantize_kv forms
// it.
template <int R, int HD>
struct Q8Stage {
  static constexpr int BYTES = 2 * R * HD + 2 * R * 4;
};

template <int R, int HD, int NT>
__device__ __forceinline__ void q8_fetch(uint8_t* st, const int8_t* kb,
                                         const int8_t* vb, const float* kscb,
                                         const float* vscb, Strides ks,
                                         Strides vs, Strides kss,
                                         Strides vss, int k0, int lo, int hi,
                                         int hd, int tid) {
  constexpr int P8 = HD / 8;              // 8-byte pieces a row
  int8_t* k8 = reinterpret_cast<int8_t*>(st);
  int8_t* v8 = k8 + R * HD;
  float* sk = reinterpret_cast<float*>(v8 + R * HD);
  float* sv = sk + R;
  static_assert(R * P8 % NT == 0 && R <= NT, "whole rounds of pieces");
  const int p8 = hd / 8;
#pragma unroll(NT == 32 ? R * P8 / NT : 1)  // a warp: all its rounds
  for (int r = 0; r < R * P8 / NT; ++r) {
    const int e = tid + r * NT, j = e / P8, c = e - j * P8;
    const bool in = k0 + j < hi && (!PAD<HD> || c < p8);
    const long long key = k0 + j < hi ? k0 + j : lo;
    const int cs = PAD<HD> ? min(c, p8 - 1) : c;
    cp_async8(k8 + j * HD + 8 * c, kb + key * ks.l + 8 * cs, in);
    cp_async8(v8 + j * HD + 8 * c, vb + key * vs.l + 8 * cs, in);
  }
  if (tid < R) {
    const bool in = k0 + tid < hi;
    const long long key = in ? k0 + tid : lo;
    cp_async4(sk + tid, kscb + key * kss.l, in);
    cp_async4(sv + tid, vscb + key * vss.l, in);
  }
  cp_async_commit();
}

// a * b for two bf16 pairs, each product rounded once to bf16 (fma with
// -0 added): the exact f32 product of two bf16 values rounded, as
// deq8x2 forms it, at the full bf16x2 rate
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// Eight int8 values (two words) times the bf16 scale pair s2, as four
// bf16 pairs, without the slow int-to-float and float-to-bf16
// conversions: a byte offset by 128 (u = x ^ 0x80) is the low byte of
// the f32 2^23 + u, and subtracting 2^23 + 128 leaves x exactly; an
// integer of at most 8 bits has zero low 16 bits in f32, so the upper
// half is its bf16; bmul2 then rounds each product once.
__device__ __forceinline__ uint4 deq8x8(uint2 w, uint32_t s2) {
  uint32_t h[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t u = (q ? w.y : w.x) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
    h[2 * q] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                           0x7632);
    h[2 * q + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]),
                               0x7632);
  }
  return make_uint4(bmul2(h[0], s2), bmul2(h[1], s2), bmul2(h[2], s2),
                    bmul2(h[3], s2));
}

// bf16(s) twice, as a bf16 pair
__device__ __forceinline__ uint32_t bf16_pair(float s) {
  const uint32_t b = __float_as_uint(bf16_round(s)) >> 16;
  return b | (b << 16);
}

// The stage's scales become bf16 pairs in place (one conversion a key,
// then a barrier of the NT threads), then each 8-byte piece of a row
// becomes 16 bytes of the tile.
template <int R, int HD, int P, int NT>
__device__ __forceinline__ void q8_dequant(uint8_t* st, __nv_bfloat16* kt,
                                           __nv_bfloat16* vt, int tid) {
  constexpr int P8 = HD / 8;
  const int8_t* k8 = reinterpret_cast<const int8_t*>(st);
  const int8_t* v8 = k8 + R * HD;
  uint32_t* sk = reinterpret_cast<uint32_t*>(st + 2 * R * HD);
  uint32_t* sv = sk + R;
  if (tid < R) {
    sk[tid] = bf16_pair(__uint_as_float(sk[tid]));
    sv[tid] = bf16_pair(__uint_as_float(sv[tid]));
  }
  if constexpr (NT == 32) __syncwarp();
  else __syncthreads();
#pragma unroll(NT == 32 ? R * P8 / NT : 1)  // a warp: all its rounds
  for (int r = 0; r < R * P8 / NT; ++r) {
    const int e = tid + r * NT, j = e / P8, c = e - j * P8;
    *reinterpret_cast<uint4*>(kt + j * P + 8 * c) =
        deq8x8(*reinterpret_cast<const uint2*>(k8 + j * HD + 8 * c), sk[j]);
    *reinterpret_cast<uint4*>(vt + j * P + 8 * c) =
        deq8x8(*reinterpret_cast<const uint2*>(v8 + j * HD + 8 * c), sv[j]);
  }
}

// Q fragments of the group's heads (the 16 rows of the A operand; rows
// past G and columns past hd are zeros), KS k-steps of 16
template <int HD, int KS>
__device__ __forceinline__ void q_frags(uint32_t (&qa)[KS][4],
                                        const __nv_bfloat16* qb, long long qh,
                                        int G, int hd) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* p0 = qb + (long long)g8 * qh;
  const __nv_bfloat16* p1 = qb + (long long)(g8 + 8) * qh;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int d = 16 * s + 2 * t4;
    const bool lo8 = !PAD<HD> || d < hd, hi8 = !PAD<HD> || d + 8 < hd;
    qa[s][0] = g8 < G && lo8 ? *reinterpret_cast<const uint32_t*>(p0 + d)
                             : 0u;
    qa[s][1] = g8 + 8 < G && lo8
                   ? *reinterpret_cast<const uint32_t*>(p1 + d) : 0u;
    qa[s][2] = g8 < G && hi8
                   ? *reinterpret_cast<const uint32_t*>(p0 + d + 8) : 0u;
    qa[s][3] = g8 + 8 < G && hi8
                   ? *reinterpret_cast<const uint32_t*>(p1 + d + 8) : 0u;
  }
}

template <int HD, bool Q8 = false>
struct DecMma {
  // keys per warp and pass (an int8 cache: 16, so a warp's passes are
  // short and its pipeline deep)
  static constexpr int WK = HD == 128 || Q8 ? 16 : 32;
  static constexpr int TK = 4 * WK;               // keys per block pass
  static constexpr int PITCH = HD + 8;            // smem row, bf16: the 8
                                                  // rows of an ldmatrix
                                                  // hit distinct banks
  static constexpr int KV_BYTES = 2 * TK * PITCH * 2;
  static constexpr int MERGE_BYTES = 4 * 16 * (HD + 2) * 4;
  static constexpr int SMEM =
      KV_BYTES > MERGE_BYTES ? KV_BYTES : MERGE_BYTES;
  // an int8 cache: the bf16 tiles, then each warp's 2-stage int8 ring
  static constexpr int Q8_SMEM = KV_BYTES + 8 * Q8Stage<WK, HD>::BYTES;
};

// G <= 16: the same partials as decode_split_kernel, on the tensor
// cores.  The G query heads of the group are the 16 rows of the A
// operand (rows past G are zero); each of the 4 warps takes WK keys of
// a pass of TK.  S = Q K^T and O += P V are m16n8k16 MMAs with B
// fragments from ldmatrix (.trans for V) on PITCH-padded bf16 tiles;
// each warp keeps its own online softmax, and the 4 warps' states merge
// in warp order.  How K and V reach the tiles is the template's Q8:
//  * false, a bf16 cache: all K/V rows of a pass are in flight at once
//    (16-byte cp.async straight into the tiles);
//  * true, an int8 cache with per-(slot, head) f32 scales (ksc / vsc
//    through kss / vss): each warp touches only its own WK keys of a
//    pass, so each runs its own pipeline with no block barrier: its
//    int8 rows and scales land in its own 2-stage ring (q8_fetch: half
//    the bf16 bytes), the next pass is put in flight as soon as one has
//    landed, and it dequantizes the landed stage into its own rows of
//    the tiles (q8_dequant), then runs the same products.
// The decode launch's window that ends at the live count (mk.local,
// gemma2's local layers), the causal window and the per-row first live
// slot (mk.first, a cache block of one rank) all set the first key.
template <int HD, bool Q8>
__global__ void __launch_bounds__(128)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const typename std::conditional<Q8, int8_t,
                                                  __nv_bfloat16>::type* k,
                  const typename std::conditional<Q8, int8_t,
                                                  __nv_bfloat16>::type* v,
                  const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ kv_valid, float* __restrict__ part,
                  float* __restrict__ ml, int G, Mask mk, Strides qs,
                  Strides ks, Strides vs, Strides kss, Strides vss,
                  float scale, float softcap, int chunk, int hd,
                  __nv_bfloat16* __restrict__ out, Strides os) {
  using C = DecMma<HD, Q8>;
  if constexpr (!PAD<HD>) hd = HD;
  constexpr int WK = C::WK, TK = C::TK, P = C::PITCH;
  constexpr int KS = HD / 16, NT = HD / 8;
  constexpr int STAGE = Q8Stage<WK, HD>::BYTES;
  extern __shared__ __align__(16) uint8_t raw[];
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(raw);
  __nv_bfloat16* vt = kt + TK * P;

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int Hq = G * gridDim.y;
  const long long slot = ((long long)b * Hq + kh * G) * n_split + split;

  int lo = 0, hi = live_keys(kv_valid, b, mk.lk);
  if (mk.local) lo = hi - mk.local;     // the window ends at the live count
  if (mk.causal && mk.window) lo = max(lo, mk.lk - mk.window);
  if (mk.first != nullptr) lo = max(lo, mk.first[b]);
  lo = max(lo, split * chunk);
  hi = min(hi, split * chunk + chunk);
  // one split: the rows go straight to `out`, normalized
  __nv_bfloat16* ob = out != nullptr ? out + b * os.b + kh * G * os.h
                                     : nullptr;
  if (lo >= hi) {                         // no live key: an empty partial
    if (ob != nullptr) {                  // (one split: rows of zeros)
      for (int e = t; e < G * hd; e += 128)
        store(ob + (e / hd) * os.h + e % hd, 0.f);
    } else if (t < G) {
      ml[2 * (slot + (long long)t * n_split)] = -CUDART_INF_F;
      ml[2 * (slot + (long long)t * n_split) + 1] = 0.f;
    }
    return;
  }
  const auto* kb = k + b * ks.b + kh * ks.h;
  const auto* vb = v + b * vs.b + kh * vs.h;
  const float* kscb = Q8 ? ksc + b * kss.b + kh * kss.h : nullptr;
  const float* vscb = Q8 ? vsc + b * vss.b + kh * vss.h : nullptr;
  const int ch = hd / 8;                  // live 16-byte pieces of a row
  // Q8: this warp's ring, and the stage of the pass at k0
  uint8_t* ring = raw + C::KV_BYTES + w * 2 * STAGE;
  auto stage = [&](int k0) { return ring + ((k0 - lo) / TK & 1) * STAGE; };
  auto load = [&](int k0) {
    if constexpr (Q8) {
      q8_fetch<WK, HD, 32>(stage(k0), kb, vb, kscb, vscb, ks, vs, kss, vss,
                           k0 + w * WK, lo, hi, hd, lane);
    } else {
      constexpr int CH = HD / 8;          // 16-byte pieces of a row
      for (int e = t; e < TK * CH; e += 128) {
        const int j = e / CH, c = e - j * CH;
        const bool in = k0 + j < hi && (!PAD<HD> || c < ch);  // zeros past hd
        const long long key = k0 + j < hi ? k0 + j : lo;
        const int cs = PAD<HD> ? min(c, ch - 1) : c;
        cp_async16(kt + j * P + 8 * c, kb + key * ks.l + 8 * cs, in);
        cp_async16(vt + j * P + 8 * c, vb + key * vs.l + 8 * cs, in);
      }
      cp_async_commit();
    }
  };
  load(lo);

  // Q fragments (rows = the group's heads), once
  uint32_t qa[KS][4];
  q_frags<HD, KS>(qa, q + b * qs.b + (long long)kh * G * qs.h, qs.h, G, hd);
  const float mul = softcap != 0.f ? LOG2E : scale * LOG2E;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int k0 = lo; k0 < hi; k0 += TK) {
    const int kw = k0 + w * WK;           // this warp's first key
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if constexpr (Q8) {
      __syncwarp();
      // the other stage was dequantized a pass ago: refill it now
      if (k0 + TK < hi) load(k0 + TK);
      if (kw < hi) {
        q8_dequant<WK, HD, P, 32>(stage(k0), kt + w * WK * P,
                                  vt + w * WK * P, lane);
        __syncwarp();
      }
    } else {
      __syncthreads();
    }
    if (kw < hi) {
      float sc[WK / 8][4];
#pragma unroll
      for (int n = 0; n < WK / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int s = 0; s < KS; s += 2) {
          // matrices: keys 8n.., dims 16s, 16s+8, 16s+16, 16s+24
          uint32_t r[4];
          const int mi = lane >> 3;
          ldsm4(r, kt + (w * WK + 8 * n + (lane & 7)) * P + 16 * s + 8 * mi);
          mma16816(sc[n], qa[s], r[0], r[1]);
          if (s + 1 < KS) mma16816(sc[n], qa[s + 1], r[2], r[3]);
        }
      }
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int n = 0; n < WK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e];
          if (softcap != 0.f) x = softcap * tanhf(x * scale / softcap);
          if (kw + 8 * n + 2 * t4 + (e & 1) >= hi) x = -CUDART_INF_F;
          sc[n][e] = x;
          if (e < 2) x0 = fmaxf(x0, x);
          else x1 = fmaxf(x1, x);
        }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, d));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, d));
      }
      const float u0 = x0 == -CUDART_INF_F ? 0.f : x0;
      const float u1 = x1 == -CUDART_INF_F ? 0.f : x1;
      const float a0 = ex2((m0 - u0) * mul), a1 = ex2((m1 - u1) * mul);
      m0 = x0;
      m1 = x1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < WK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((sc[n][e] - (e < 2 ? u0 : u1)) * mul);
          sc[n][e] = p;
          if (e < 2) ps0 += p;
          else ps1 += p;
        }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= a0; o[n][1] *= a0;
        o[n][2] *= a1; o[n][3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        // matrices: keys 16kk.. / 16kk+8.., dims 8n / 8n+8 (transposed)
        const int key = w * WK + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t r[4];
          ldsm4_t(r, vt + key * P + 8 * n + 8 * (lane >> 4));
          mma16816(o[n], pa, r[0], r[1]);
          mma16816(o[n + 1], pa, r[2], r[3]);
        }
      }
    }
    if constexpr (!Q8) {
      __syncthreads();
      if (k0 + TK < hi) load(k0 + TK);
    }
  }
  if constexpr (Q8) __syncthreads();      // the merge reuses the tiles

  // merge the 4 warps' states in warp order
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  float* mo = reinterpret_cast<float*>(raw);      // [warp][row][HD]
  float* mm = mo + 4 * 16 * HD;                   // [warp][row] m, then l
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* r0 = mo + (w * 16 + g8) * HD + 8 * n + 2 * t4;
    float* r1 = r0 + 8 * HD;
    r0[0] = o[n][0]; r0[1] = o[n][1];
    r1[0] = o[n][2]; r1[1] = o[n][3];
  }
  if (t4 == 0) {
    mm[2 * (w * 16 + g8)] = m0;
    mm[2 * (w * 16 + g8) + 1] = l0;
    mm[2 * (w * 16 + g8 + 8)] = m1;
    mm[2 * (w * 16 + g8 + 8) + 1] = l1;
  }
  __syncthreads();
  for (int e = t; e < G * hd; e += 128) {
    const int g = e / hd, d = e - g * hd;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 4; ++i) M = fmaxf(M, mm[2 * (i * 16 + g)]);
    const float use = M == -CUDART_INF_F ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = ex2((mm[2 * (i * 16 + g)] - use) * mul);
      L += mm[2 * (i * 16 + g) + 1] * f;
      A += mo[(i * 16 + g) * HD + d] * f;
    }
    if (ob != nullptr) {                  // the combine's A / L of one split
      store(ob + g * os.h + d, L > 0.f ? A / L : 0.f);
      continue;
    }
    part[(slot + (long long)g * n_split) * hd + d] = A;
    if (d == 0) {
      ml[2 * (slot + (long long)g * n_split)] = M == -CUDART_INF_F
                                                    ? -CUDART_INF_F
                                                    : M * mul;
      ml[2 * (slot + (long long)g * n_split) + 1] = L;
    }
  }
}

// hd 288 (gemma2-2b) on the tensor cores, G <= 16, a bf16 or an int8
// cache (Q8).  A warp's 16 x 288 f32 O would take 144 registers a
// thread beside Q's 72, so the block splits the work two ways within
// each pass of TK keys:
//  1. S = Q K^T: each of the 4 warps scores WK keys over all 18 k-steps;
//  2. the pass's row maxima meet in shared memory, so every warp holds
//     the same running max; each warp's P goes to shared memory as bf16
//     (its row sums stay a partial of its own keys);
//  3. O += P V: each warp owns NC = 72 of O's columns (9 n-tiles) over
//     all TK keys of the pass, P's A fragments by ldmatrix.
// Every warp rescales by the same factor, so the row sums add up across
// warps at the end.  How K and V reach the tiles:
//  * Q8, an int8 cache: one int8 stage, dequantized (q8_dequant) into
//    PITCH-padded bf16 tiles; the next pass is put in flight as soon as
//    the landed one is dequantized.  56.8 KB: three blocks an SM.
//  * a bf16 cache: a 576-byte row is twice the int8 one, so the rows
//    land straight in a 2-stage ring of bf16 tiles (16-byte cp.async),
//    the next pass in flight through the whole of this one.  Rows are
//    unpadded (73.5 KB: still three blocks an SM, 220 KB, with a pass in
//    flight in each, 110 KB) and each 16-byte piece c of row j sits at
//    piece c ^ ((j / 2) & 3) of its row: a row is 4.5 bank rows, so the
//    8 rows an ldmatrix reads fall on 8 distinct 16-byte bank groups.
template <int HD, bool Q8>
struct DecWide {
  static constexpr int TK = 32;           // keys a pass
  static constexpr int WK = TK / 4;       // keys a warp scores
  static constexpr int PITCH = Q8 ? HD + 8 : HD;  // bf16 tile row
  static constexpr int PP = TK + 8;       // P's row, bf16
  static constexpr int NC = HD / 4;       // O columns a warp owns
  static constexpr int TILE = TK * PITCH * 2;     // one K or V tile
  static constexpr int KV_BYTES = (Q8 ? 2 : 4) * TILE;
  static constexpr int P_BYTES = 16 * PP * 2;
  static constexpr int SMEM = KV_BYTES + (Q8 ? Q8Stage<TK, HD>::BYTES : 0) +
                              P_BYTES + 4 * 16 * 4;
};

// Element offset of 16-byte piece c of row j in a decode_wide tile.
template <int HD, bool Q8>
__device__ __forceinline__ int wide_at(int j, int c) {
  return j * DecWide<HD, Q8>::PITCH + 8 * (Q8 ? c : c ^ ((j >> 1) & 3));
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(128)
decode_wide_kernel(const __nv_bfloat16* __restrict__ q,
                   const typename std::conditional<Q8, int8_t,
                                                   __nv_bfloat16>::type* k,
                   const typename std::conditional<Q8, int8_t,
                                                   __nv_bfloat16>::type* v,
                   const float* __restrict__ ksc,
                   const float* __restrict__ vsc,
                   const int* __restrict__ kv_valid,
                   float* __restrict__ part, float* __restrict__ ml, int G,
                   Mask mk, Strides qs, Strides ks, Strides vs, Strides kss,
                   Strides vss, float scale, float softcap, int chunk) {
  using C = DecWide<HD, Q8>;
  constexpr int TK = C::TK, WK = C::WK, PP = C::PP;
  constexpr int NC = C::NC, NTW = NC / 8, KS = HD / 16, CH = HD / 8;
  static_assert(KS % 2 == 0 && WK == 8 && TK % 16 == 0, "tiling");
  extern __shared__ __align__(16) uint8_t raw[];
  // Q8: the tiles, then the int8 stage; bf16: [stage][K, V] tiles
  uint8_t* stage = raw + C::KV_BYTES;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(
      stage + (Q8 ? Q8Stage<TK, HD>::BYTES : 0));
  float* red = reinterpret_cast<float*>(ps + 16 * PP);  // [warp][row]

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int Hq = G * gridDim.y;
  const long long slot = ((long long)b * Hq + kh * G) * n_split + split;

  int lo = 0, hi = live_keys(kv_valid, b, mk.lk);
  if (mk.local) lo = hi - mk.local;     // the window ends at the live count
  if (mk.causal && mk.window) lo = max(lo, mk.lk - mk.window);
  if (mk.first != nullptr) lo = max(lo, mk.first[b]);
  lo = max(lo, split * chunk);
  hi = min(hi, split * chunk + chunk);
  if (lo >= hi) {                         // no live key: an empty partial
    if (t < G) {
      ml[2 * (slot + (long long)t * n_split)] = -CUDART_INF_F;
      ml[2 * (slot + (long long)t * n_split) + 1] = 0.f;
    }
    return;
  }
  const auto* kb = k + b * ks.b + kh * ks.h;
  const auto* vb = v + b * vs.b + kh * vs.h;
  const float* kscb = Q8 ? ksc + b * kss.b + kh * kss.h : nullptr;
  const float* vscb = Q8 ? vsc + b * vss.b + kh * vss.h : nullptr;
  // a bf16 cache: pass `it`'s rows k0 .. k0 + TK - 1 into stage it & 1
  auto load = [&](int it, int k0) {
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(
        raw + (it & 1) * 2 * C::TILE);
    __nv_bfloat16* vt = kt + TK * C::PITCH;
    for (int e = t; e < TK * CH; e += 128) {
      const int j = e / CH, c = e - j * CH;
      const bool in = k0 + j < hi;        // zeros past the live keys
      const long long key = in ? k0 + j : lo;
      cp_async16(kt + wide_at<HD, Q8>(j, c), kb + key * ks.l + 8 * c, in);
      cp_async16(vt + wide_at<HD, Q8>(j, c), vb + key * vs.l + 8 * c, in);
    }
    cp_async_commit();
  };
  if constexpr (Q8)
    q8_fetch<TK, HD, 128>(stage, kb, vb, kscb, vscb, ks, vs, kss, vss, lo,
                          lo, hi, HD, t);
  else
    load(0, lo);

  uint32_t qa[KS][4];
  q_frags<HD, KS>(qa, q + b * qs.b + (long long)kh * G * qs.h, qs.h, G, HD);
  const float mul = softcap != 0.f ? LOG2E : scale * LOG2E;
  float o[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int k0 = lo, it = 0; k0 < hi; k0 += TK, ++it) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                      // the last pass's P V is done
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(
        raw + (Q8 ? 0 : (it & 1) * 2 * C::TILE));
    __nv_bfloat16* vt = kt + TK * C::PITCH;
    if constexpr (Q8) {
      q8_dequant<TK, HD, C::PITCH, 128>(stage, kt, vt, t);
      __syncthreads();
      if (k0 + TK < hi)
        q8_fetch<TK, HD, 128>(stage, kb, vb, kscb, vscb, ks, vs, kss, vss,
                              k0 + TK, lo, hi, HD, t);
    } else {
      if (k0 + TK < hi) load(it + 1, k0 + TK);  // the stage read a pass ago
    }
    // 1. this warp's WK keys: one n-tile of S over the 18 k-steps
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < KS; s += 2) {
      uint32_t r[4];
      ldsm4(r, kt + wide_at<HD, Q8>(w * WK + (lane & 7), 2 * s + (lane >> 3)));
      mma16816(sc, qa[s], r[0], r[1]);
      mma16816(sc, qa[s + 1], r[2], r[3]);
    }
    float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[e];
      if (softcap != 0.f) x = softcap * tanhf(x * scale / softcap);
      if (k0 + w * WK + 2 * t4 + (e & 1) >= hi) x = -CUDART_INF_F;
      sc[e] = x;
      if (e < 2) x0 = fmaxf(x0, x);
      else x1 = fmaxf(x1, x);
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, d));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, d));
    }
    if (t4 == 0) {
      red[w * 16 + g8] = x0;
      red[w * 16 + g8 + 8] = x1;
    }
    __syncthreads();
    // 2. the pass's running max, the same in every warp; P to smem
    float M0 = m0, M1 = m1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      M0 = fmaxf(M0, red[i * 16 + g8]);
      M1 = fmaxf(M1, red[i * 16 + g8 + 8]);
    }
    const float u0 = M0 == -CUDART_INF_F ? 0.f : M0;
    const float u1 = M1 == -CUDART_INF_F ? 0.f : M1;
    const float a0 = ex2((m0 - u0) * mul), a1 = ex2((m1 - u1) * mul);
    m0 = M0;
    m1 = M1;
    const float p0 = ex2((sc[0] - u0) * mul), p1 = ex2((sc[1] - u0) * mul);
    const float p2 = ex2((sc[2] - u1) * mul), p3 = ex2((sc[3] - u1) * mul);
    l0 = l0 * a0 + (p0 + p1);
    l1 = l1 * a1 + (p2 + p3);
    *reinterpret_cast<uint32_t*>(ps + g8 * PP + w * WK + 2 * t4) =
        pack_bf16(p0, p1);
    *reinterpret_cast<uint32_t*>(ps + (g8 + 8) * PP + w * WK + 2 * t4) =
        pack_bf16(p2, p3);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      o[n][0] *= a0; o[n][1] *= a0;
      o[n][2] *= a1; o[n][3] *= a1;
    }
    __syncthreads();
    // 3. O[:, NC w ..] += P V over the pass's TK keys
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      ldsm4(pa, ps + ((lane & 7) + 8 * ((lane >> 3) & 1)) * PP + 16 * kk +
                    8 * (lane >> 4));
      const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int n = 0; n < NTW; n += 2) {
        // the odd last n-tile reads its own 8 columns twice, dropping
        // the second
        uint32_t r[4];
        ldsm4_t(r, vt + wide_at<HD, Q8>(
                        key, NTW * w + n + (n + 1 < NTW ? lane >> 4 : 0)));
        mma16816(o[n], pa, r[0], r[1]);
        if (n + 1 < NTW) mma16816(o[n + 1], pa, r[2], r[3]);
      }
    }
  }
  // the row sums: each warp's over its own keys, added in warp order
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  if (t4 == 0) {                          // red's last reader passed the
    red[w * 16 + g8] = l0;                // pass's last __syncthreads
    red[w * 16 + g8 + 8] = l1;
  }
  __syncthreads();
  float L0 = 0.f, L1 = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    L0 += red[i * 16 + g8];
    L1 += red[i * 16 + g8 + 8];
  }
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int d = NC * w + 8 * n + 2 * t4;
    if (g8 < G) {
      float* pr = part + (slot + (long long)g8 * n_split) * HD + d;
      pr[0] = o[n][0];
      pr[1] = o[n][1];
    }
    if (g8 + 8 < G) {
      float* pr = part + (slot + (long long)(g8 + 8) * n_split) * HD + d;
      pr[0] = o[n][2];
      pr[1] = o[n][3];
    }
  }
  if (w == 0 && t4 == 0) {
    if (g8 < G) {
      ml[2 * (slot + (long long)g8 * n_split)] =
          m0 == -CUDART_INF_F ? -CUDART_INF_F : m0 * mul;
      ml[2 * (slot + (long long)g8 * n_split) + 1] = L0;
    }
    if (g8 + 8 < G) {
      ml[2 * (slot + (long long)(g8 + 8) * n_split)] =
          m1 == -CUDART_INF_F ? -CUDART_INF_F : m1 * mul;
      ml[2 * (slot + (long long)(g8 + 8) * n_split) + 1] = L1;
    }
  }
}

// One block per (batch, query head): n partials (acc, m, l) merged in
// part order; a part with m = -inf holds no live key and is skipped.
// The parts are either
//  * FROM_LSE false, the n_split splits of one decode launch: acc at
//    part[(bh n + s) hd], (m, l) at ml[2 (bh n + s)], m in the log2
//    domain;
//  * FROM_LSE true, R ranks' finished (o, lse) (decode_merge): o (R, BH,
//    hd) f32 as acc, lse (R, BH) as m in the natural domain with l = 1,
//    since o = acc / l and lse = m + log l; lse = +inf marks a part with
//    no live key.  A part's weight is exp(lse - max lse), the difference
//    taken before the scale to log2, so the only rounding in a weight
//    beyond the lse's own is that of one product.
// No atomics: the same bits on every run.  lse_out (optional): the
// merged rows' log-sum-exp, (M + log2 L) ln 2, and +inf for a row with
// no live key, as flash_attention_plain(return_lse=True) gives it (the
// merge skips such a part).  TO is the output's type.
template <typename TO, int HD, bool FROM_LSE>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part,
                      const float* __restrict__ ml, TO* __restrict__ out,
                      int Hq, int n, Strides os, int hd,
                      float* __restrict__ lse_out, int BH) {
  if constexpr (!PAD<HD>) hd = HD;
  const int bh = blockIdx.x, b = bh / Hq, h = bh - b * Hq;
  const int d = threadIdx.x;
  constexpr float MUL = FROM_LSE ? LOG2E : 1.f;   // m's domain to log2
  auto at = [&](int s) -> long long {
    return FROM_LSE ? (long long)s * BH + bh : (long long)bh * n + s;
  };
  auto m_of = [&](int s) -> float {
    if constexpr (FROM_LSE) {
      const float x = ml[at(s)];
      return x == CUDART_INF_F ? -CUDART_INF_F : x;
    } else {
      return ml[2 * at(s)];
    }
  };
  float M = -CUDART_INF_F;
  for (int s = 0; s < n; ++s) M = fmaxf(M, m_of(s));
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n; ++s) {
    const float m = m_of(s);
    if (m == -CUDART_INF_F) continue;
    const float f = ex2((m - M) * MUL);
    L += (FROM_LSE ? 1.f : ml[2 * at(s) + 1]) * f;
    A += part[at(s) * hd + d] * f;
  }
  store(out + b * os.b + h * os.h + d, L > 0.f ? A / L : 0.f);
  if (lse_out != nullptr && d == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    lse_out[bh] = L > 0.f ? (M * MUL + log2f(L)) * LN2 : CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------
// decode (Lq = 1) against an int8 KV cache
// ---------------------------------------------------------------------

template <int HD>
struct DecQ8 {
  static constexpr int P8 = HD / 8;               // 8-byte int8 pieces a row
  // keys per sub-tile: 8 KB of K and 8 KB of V dequantized to bf16
  static constexpr int TK_ = 4096 / HD;
  static constexpr int TK = TK_ > 64 ? 64 : TK_ < 8 ? 8 : TK_;
  static constexpr int CH = HD / 8;               // 16-byte bf16 pieces a row
  static constexpr int LPR = CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int NPL = (CH + LPR - 1) / LPR;
  static constexpr int KPW = 32 / LPR;
  static constexpr int GB = 1024 / HD;            // query heads per block
  static constexpr int NP = (GB * HD / 2 + DEC_THREADS - 1) / DEC_THREADS;
};

// Block (split, kv head x head group, batch), as decode_split_kernel:
// keys [lo, hi) of chunk `split` for up to GB query heads of one KV
// group, the same partials (acc, then (m, l) in the log2 domain) for
// decode_combine_kernel.  Each sub-tile's int8 K/V rows are read 8
// bytes a thread with their per-(slot, head) scales into registers one
// sub-tile ahead, dequantized there and kept in shared memory as the
// bf16 values they are (16 KB a sub-tile, so many blocks share an SM);
// then scores, the online softmax and P V in f32 on CUDA cores (no
// tensor cores, no TMA).
template <typename T, int HD>
__global__ void __launch_bounds__(DEC_THREADS)
decode_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, const float* __restrict__ ksc,
                 const float* __restrict__ vsc,
                 const int* __restrict__ kv_valid, float* __restrict__ part,
                 float* __restrict__ ml, int G, int lk, int local,
                 const int* __restrict__ first, Strides qs, Strides ks,
                 Strides vs, Strides kss, Strides vss, float scale,
                 float softcap, int chunk, int hd) {
  using C = DecQ8<HD>;
  if constexpr (!PAD<HD>) hd = HD;
  constexpr int TK = C::TK, LPR = C::LPR, KPW = C::KPW, CH = C::CH;
  constexpr int NPL = C::NPL, P8 = C::P8;
  __shared__ __align__(16) __nv_bfloat16 kt[TK * HD];
  __shared__ __align__(16) __nv_bfloat16 vt[TK * HD];
  __shared__ __align__(16) float qsh[C::GB * HD];
  __shared__ float sc[C::GB][TK];
  __shared__ float mrow[C::GB], lrow[C::GB], arow[C::GB];

  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int ngrp = (G + C::GB - 1) / C::GB;
  const int kh = blockIdx.y / ngrp, g0 = (blockIdx.y % ngrp) * C::GB;
  const int ng = min(C::GB, G - g0);
  const int b = blockIdx.z;
  const int Hq = G * (gridDim.y / ngrp);
  const int hq0 = kh * G + g0;
  const long long slot = ((long long)b * Hq + hq0) * n_split + split;

  int lo = 0, hi = live_keys(kv_valid, b, lk);
  if (local) lo = hi - local;           // the window ends at the live count
  if (first != nullptr) lo = max(lo, first[b]);
  lo = max(lo, split * chunk);
  hi = min(hi, split * chunk + chunk);
  if (lo >= hi) {                       // no live key: an empty partial
    for (int g = t; g < ng; g += DEC_THREADS) {
      ml[2 * (slot + (long long)g * n_split)] = -CUDART_INF_F;
      ml[2 * (slot + (long long)g * n_split) + 1] = 0.f;
    }
    return;
  }

  const int8_t* kb = k + b * ks.b + kh * ks.h;
  const int8_t* vb = v + b * vs.b + kh * vs.h;
  const float* kscb = ksc + b * kss.b + kh * kss.h;
  const float* vscb = vsc + b * vss.b + kh * vss.h;
  // a thread's share of a sub-tile: PER 8-byte pieces of K and of V,
  // with their slots' scales; the next sub-tile's are loaded into
  // registers while the current one is scored
  constexpr int PER = (TK * P8 + DEC_THREADS - 1) / DEC_THREADS;
  uint2 rk[PER], rv[PER];
  float sk[PER], sv[PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + DEC_THREADS * i, j = e / P8, c = e - j * P8;
      rk[i] = rv[i] = make_uint2(0u, 0u);
      sk[i] = sv[i] = 0.f;
      if (e < TK * P8 && k0 + j < hi && (!PAD<HD> || c * 8 < hd)) {
        const long long key = k0 + j;
        rk[i] = *reinterpret_cast<const uint2*>(kb + key * ks.l + c * 8);
        rv[i] = *reinterpret_cast<const uint2*>(vb + key * vs.l + c * 8);
        sk[i] = bf16_round(kscb[key * kss.l]);
        sv[i] = bf16_round(vscb[key * vss.l]);
      }
    }
  };
  // dequantize the fetched pieces into the bf16 sub-tile, 16 bytes a
  // piece (zeros where nothing was fetched: 0 * 0)
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = t + DEC_THREADS * i, j = e / P8, c = e - j * P8;
      if (e < TK * P8) {
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&rk[i]);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&rv[i]);
        uint4 kx, vx;
        kx.x = deq8x2(k8[0], k8[1], sk[i]);
        kx.y = deq8x2(k8[2], k8[3], sk[i]);
        kx.z = deq8x2(k8[4], k8[5], sk[i]);
        kx.w = deq8x2(k8[6], k8[7], sk[i]);
        vx.x = deq8x2(v8[0], v8[1], sv[i]);
        vx.y = deq8x2(v8[2], v8[3], sv[i]);
        vx.z = deq8x2(v8[4], v8[5], sv[i]);
        vx.w = deq8x2(v8[6], v8[7], sv[i]);
        *reinterpret_cast<uint4*>(&kt[j * HD + c * 8]) = kx;
        *reinterpret_cast<uint4*>(&vt[j * HD + c * 8]) = vx;
      }
    }
  };
  fetch(lo);
  for (int e = t; e < ng * HD; e += DEC_THREADS) {
    const int g = e / HD, d = e - g * HD;
    qsh[e] = !PAD<HD> || d < hd
                 ? to_f(q[b * qs.b + (long long)(hq0 + g) * qs.h + d]) * scale
                 : 0.f;
  }
  if (t < C::GB) {
    mrow[t] = -CUDART_INF_F;
    lrow[t] = 0.f;
  }
  float acc[C::NP][2];
#pragma unroll
  for (int i = 0; i < C::NP; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int ntile = (hi - lo + TK - 1) / TK;
  const int sub = lane / LPR, piece = lane % LPR;
  for (int it = 0; it < ntile; ++it) {
    const int k0 = lo + it * TK;
    __syncthreads();                    // the last tile's P V is done
    stage();
    if (it + 1 < ntile) fetch(k0 + TK);
    __syncthreads();
    // scores: LPR lanes per key row, NPL 16-byte pieces each, reduced
    // by shuffles
    for (int j = w * KPW + sub; j < TK; j += 4 * KPW) {
      float kf[NPL][8];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int c = piece + LPR * i;
        if (c < CH) {
          unpack16(&kt[j * HD + c * 8], kf[i]);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) kf[i][u] = 0.f;
        }
      }
      const bool ok = k0 + j < hi;
      for (int g = 0; g < ng; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const int c = piece + LPR * i;
          if (c < CH) {
            const float* qg = qsh + g * HD + c * 8;
#pragma unroll
            for (int u = 0; u < 8; ++u) dot = fmaf(qg[u], kf[i][u], dot);
          }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (piece == 0) {
          if (softcap != 0.f) dot = softcap * tanhf(dot / softcap);
          sc[g][j] = ok ? dot * LOG2E : -CUDART_INF_F;
        }
      }
    }
    __syncthreads();
    // online softmax per head, one warp per head
    for (int g = w; g < ng; g += DEC_THREADS / 32) {
      float mx = -CUDART_INF_F;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, sc[g][j]);
      mx = warp_max(mx);
      const float mold = mrow[g], mnew = fmaxf(mold, mx);
      const float use = mnew == -CUDART_INF_F ? 0.f : mnew;
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = ex2(sc[g][j] - use);
        sc[g][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = ex2(mold - use);
        arow[g] = a;
        lrow[g] = lrow[g] * a + sum;
        mrow[g] = mnew;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V: a thread holds NP (head, dim pair) slots
#pragma unroll
    for (int i = 0; i < C::NP; ++i) {
      const int idx = t + DEC_THREADS * i;
      const int g = idx / (HD / 2), dp = idx - g * (HD / 2);
      if (g < ng) {
        const float a = arow[g];
        float x = acc[i][0] * a, y = acc[i][1] * a;
        const __nv_bfloat16* vr = &vt[2 * dp];
#pragma unroll 8
        for (int j = 0; j < TK; ++j) {
          const float p = sc[g][j];
          const float2 vv = load2(vr + j * HD);
          x = fmaf(p, vv.x, x);
          y = fmaf(p, vv.y, y);
        }
        acc[i][0] = x;
        acc[i][1] = y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < C::NP; ++i) {
    const int idx = t + DEC_THREADS * i;
    const int g = idx / (HD / 2), dp = idx - g * (HD / 2);
    if (g < ng && (!PAD<HD> || 2 * dp < hd)) {
      float* pr = part + (slot + (long long)g * n_split) * hd + 2 * dp;
      pr[0] = acc[i][0];
      pr[1] = acc[i][1];
    }
  }
  if (t < ng) {
    ml[2 * (slot + (long long)t * n_split)] = mrow[t];
    ml[2 * (slot + (long long)t * n_split) + 1] = lrow[t];
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Byte strides of the (l, h, b) axes of a bf16 operand with `n` = (L,
// H, B) positions: all that TMA needs is a 16-byte multiple on every
// axis longer than 1 and a 16-byte aligned base.
bool tma_ok(const void* p, Strides st, int L, int H, int B) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const long long s[3] = {st.l, st.h, st.b};
  const int n[3] = {L, H, B};
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (s[i] * 2) % 16) return false;
  return true;
}

// A 4-D map (hd, then the l / h / b axes by increasing stride, axes of
// length 1 last) over a bf16 operand: boxes of `cols` columns, 64 (128
// bytes, the 128-byte swizzle's span) or 32 (the 64-byte swizzle's), by
// `rows` positions along l; zeros past the ends.
cudaError_t make_map(CUtensorMap* map, TmaAxes* ax, const void* p, int hd,
                     Strides st, int L, int H, int B, int rows,
                     int cols = 64) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  struct Axis {
    long long stride;
    int n, which;
  } a[3] = {{st.l, L, 0}, {st.h, H, 1}, {st.b, B, 2}};
  long long span = 2LL * hd;
  for (const Axis& x : a)
    if (x.n > 1) span = std::max(span, x.stride * 2 * x.n);
  for (Axis& x : a)
    if (x.n == 1) x.stride = span / 2;    // never stepped: any legal value
  std::stable_sort(a, a + 3, [](const Axis& x, const Axis& y) {
    return (x.n == 1) != (y.n == 1) ? y.n == 1 : x.stride < y.stride;
  });
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)cols, 1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)a[i].n;
    strides[i] = (cuuint64_t)(a[i].stride * 2);
    slot[a[i].which] = i + 1;
    if (a[i].which == 0) box[i + 1] = (cuuint32_t)rows;
  }
  *ax = TmaAxes{slot[0], slot[1], slot[2]};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

#include "flash_attention_bwd.cuh"

// LSE: the instantiation that also writes the rows' log-sum-exp (the
// training forward); the served one compiles without that store, so its
// registers are those of the kernel before the backward existed.
template <int HD, bool LSE>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* kv_valid, void* out, int B, int Hq,
                         int Hkv, Mask mk, Strides qs, Strides ks,
                         Strides vs, Strides os, float scale, float softcap,
                         int hd, float* lse, cudaStream_t s) {
  using C = PrefillCfg<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_wgmma_kernel<HD, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  // maps over the true hd: a box's columns past it (120..127) load as
  // zeros and are not stored; at 120 and 128 O leaves by TMA stores,
  // boxes of a warpgroup's 64 rows
  CUtensorMap tq, tk, tv, to{};
  TmaAxes qa, ka, va, oa{};
  cudaError_t e;
  if ((e = make_map(&tq, &qa, q, hd, qs, mk.lq, Hq, B, C::BQ)) ||
      (e = make_map(&tk, &ka, k, hd, ks, mk.lk, Hkv, B, C::BK)) ||
      (e = make_map(&tv, &va, v, hd, vs, mk.lk, Hkv, B, C::BK)) ||
      (!C::PAIR && (e = make_map(&to, &oa, out, hd, os, mk.lq, Hq, B, 64))))
    return e;
  if (va.l != ka.l || va.h != ka.h || va.b != ka.b)
    return cudaErrorInvalidValue;         // K and V share one coordinate map
  const int nq = (mk.lq + C::BQ - 1) / C::BQ;
  dim3 grid(Hq, B, nq);
  if constexpr (!C::PAIR) {
    // persistent: a block an SM, or one an item where there are fewer
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
      return e;
    const long long items = (long long)nq * Hq * B;
    grid = dim3((int)std::min<long long>(items, sms));
  }
  prefill_wgmma_kernel<HD, LSE><<<grid, C::THREADS, C::SMEM, s>>>(
      tq, tk, tv, to, qa, ka, oa, kv_valid,
      static_cast<__nv_bfloat16*>(out), os, B, Hq, Hq / Hkv, mk, scale,
      softcap, lse);
  return cudaGetLastError();
}

// hd 288: prefill_wide_kernel over 32-column boxes
template <bool LSE>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const int* kv_valid, void* out, int B, int Hq,
                        int Hkv, Mask mk, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, float softcap, float* lse,
                        cudaStream_t s) {
  using C = WgWide;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_wide_kernel<LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  TmaAxes qa, ka, va;
  cudaError_t e;
  if ((e = make_map(&tq, &qa, q, C::HD, qs, mk.lq, Hq, B, C::BQ, 32)) ||
      (e = make_map(&tk, &ka, k, C::HD, ks, mk.lk, Hkv, B, C::BK, 32)) ||
      (e = make_map(&tv, &va, v, C::HD, vs, mk.lk, Hkv, B, C::BK, 32)))
    return e;
  if (va.l != ka.l || va.h != ka.h || va.b != ka.b)
    return cudaErrorInvalidValue;         // K and V share one coordinate map
  dim3 grid(Hq, B, (mk.lq + C::BQ - 1) / C::BQ);
  prefill_wide_kernel<LSE><<<grid, C::THREADS, C::SMEM, s>>>(
      tq, tk, tv, qa, ka, kv_valid, static_cast<__nv_bfloat16*>(out),
      Hq / Hkv, mk, os, scale, softcap, lse);
  return cudaGetLastError();
}

// Whether a decode is its body's launch alone: one split on the
// tensor cores' body 1 below hd 288 (decode_mma_kernel; the int8
// launch's body 1 at hd 288 is decode_wide_kernel, which does not) with
// no lse asked for writes its rows normalized in the output's type --
// the combine's A / L of one split -- with no scratch and no combine
// launch.  The wrapper asks flash_decode_one_launch whether to allocate
// the scratch.
bool one_launch(int n_split, bool lse, int body, int hd) {
  return n_split == 1 && !lse && body == 1 && hd != 288;
}

// The decode's merge of its n_split partials: into `out` in T, or, with
// `lse`, into an f32 `out` beside the rows' log-sum-exp (a partial over
// one rank's block of the cache, for flash_decode_merge_launch).
template <typename T, int HD>
cudaError_t launch_combine(const float* scratch, const float* ml, void* out,
                           int B, int Hq, int n_split, Strides os, int hd,
                           float* lse, cudaStream_t s) {
  if (lse != nullptr)
    decode_combine_kernel<float, HD, false><<<B * Hq, hd, 0, s>>>(
        scratch, ml, static_cast<float*>(out), Hq, n_split, os, hd, lse,
        B * Hq);
  else
    decode_combine_kernel<T, HD, false><<<B * Hq, hd, 0, s>>>(
        scratch, ml, static_cast<T*>(out), Hq, n_split, os, hd, nullptr,
        B * Hq);
  return cudaGetLastError();
}

// HD is the capacity the head dim `hd` runs in (120 runs in 128).
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_valid, void* out, float* scratch, int B,
                   int Hq, int Hkv, Mask mk, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, float softcap,
                   int n_split, int chunk, int hd, int body, float* lse,
                   cudaStream_t s) {
  const int G = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (mk.lq == 1) {
    // 16-byte copies of every K/V row; the splits cover all Lk keys
    const long long st[] = {ks.b, ks.h, ks.l, vs.b, vs.h, vs.l};
    for (long long x : st)
      if ((x * (long long)sizeof(T)) % 16) return cudaErrorInvalidValue;
    // one split on decode_mma_kernel: its rows go straight to out
    const bool direct = one_launch(n_split, lse != nullptr, body, hd);
    if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
            16 ||
        (hd * (int)sizeof(T)) % 16 || (scratch == nullptr && !direct) ||
        n_split < 1 || chunk < 1 || (long long)n_split * chunk < mk.lk)
      return cudaErrorInvalidValue;
    float* ml = direct ? nullptr : scratch + (long long)B * Hq * n_split * hd;
    const dim3 grid(n_split, Hkv, B);
    if (body == 1 || body == 2) {           // the tensor cores
      constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
      if (!BF16 || (body == 1) != (HD <= 128) || (body == 2) != (HD == 288) ||
          G > 16 || reinterpret_cast<uintptr_t>(q) % 4 || qs.b % 2 ||
          qs.h % 2)
        return cudaErrorInvalidValue;     // q read as bf16 pairs
      if constexpr (BF16 && HD <= 128) {
        decode_mma_kernel<HD, false><<<grid, 128, DecMma<HD>::SMEM, s>>>(
            qp, kp, vp, nullptr, nullptr, kv_valid, scratch, ml, G, mk, qs,
            ks, vs, Strides{}, Strides{}, scale, softcap, chunk, hd,
            direct ? reinterpret_cast<__nv_bfloat16*>(op) : nullptr, os);
      } else if constexpr (BF16 && HD == 288) {
        static const cudaError_t attr = cudaFuncSetAttribute(
            decode_wide_kernel<HD, false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            DecWide<HD, false>::SMEM);
        if (attr != cudaSuccess) return attr;
        decode_wide_kernel<HD, false><<<grid, 128, DecWide<HD, false>::SMEM,
                                        s>>>(
            qp, kp, vp, nullptr, nullptr, kv_valid, scratch, ml, G, mk, qs,
            ks, vs, Strides{}, Strides{}, scale, softcap, chunk);
      }
    } else if (body == 0) {
      const int ngrp = (G + Dec<T, HD>::GB - 1) / Dec<T, HD>::GB;
      decode_split_kernel<T, HD><<<dim3(n_split, Hkv * ngrp, B),
                                   DEC_THREADS, 0, s>>>(
          qp, kp, vp, kv_valid, scratch, ml, G, mk, qs, ks, vs, scale,
          softcap, chunk, hd);
    } else {
      return cudaErrorInvalidValue;
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || direct) return e;
    return launch_combine<T, HD>(scratch, ml, out, B, Hq, n_split, os, hd,
                                 lse, s);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD != 32) {
    // prefill_turns (hd 120, 128) stores O by TMA too
    constexpr bool TMA_OUT = HD == 128;
    if (tma_ok(q, qs, mk.lq, Hq, B) && tma_ok(k, ks, mk.lk, Hkv, B) &&
        tma_ok(v, vs, mk.lk, Hkv, B) &&
        (!TMA_OUT || tma_ok(out, os, mk.lq, Hq, B)) && (hd * 2) % 16 == 0) {
      if constexpr (HD == 288)
        return lse != nullptr
                   ? launch_wide<true>(q, k, v, kv_valid, out, B, Hq, Hkv, mk,
                                       qs, ks, vs, os, scale, softcap, lse, s)
                   : launch_wide<false>(q, k, v, kv_valid, out, B, Hq, Hkv,
                                        mk, qs, ks, vs, os, scale, softcap,
                                        lse, s);
      else
        return lse != nullptr
                   ? launch_wgmma<HD, true>(q, k, v, kv_valid, out, B, Hq,
                                            Hkv, mk, qs, ks, vs, os, scale,
                                            softcap, hd, lse, s)
                   : launch_wgmma<HD, false>(q, k, v, kv_valid, out, B, Hq,
                                             Hkv, mk, qs, ks, vs, os, scale,
                                             softcap, hd, lse, s);
    }
  }
  dim3 grid((mk.lq + BQ - 1) / BQ, Hq, B);
  prefill_kernel<T, HD><<<grid, Pre<HD>::NT, 0, s>>>(
      qp, kp, vp, kv_valid, op, G, mk, qs, ks, vs, os, scale, softcap, hd,
      lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* kv_valid, void* out, float* scratch, int B,
                        int Hq, int Hkv, Mask mk, Strides qs, Strides ks,
                        Strides vs, Strides os, float scale, float softcap,
                        int n_split, int chunk, int body, float* lse,
                        cudaStream_t s) {
#define FA_LAUNCH(CAP)                                                     \
  launch<T, CAP>(q, k, v, kv_valid, out, scratch, B, Hq, Hkv, mk, qs, ks, \
                 vs, os, scale, softcap, n_split, chunk, hd, body, lse, s)
  switch (hd) {
    case 32:
      return FA_LAUNCH(32);
    case 64:
      return FA_LAUNCH(64);
    case 120:                             // h2o-danube-3-4b, in 128
    case 128:
      return FA_LAUNCH(128);
    case 288:                             // gemma2-2b
      return FA_LAUNCH(288);
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

// The int8 decode: the partials of the body the caller names (0:
// decode_q8_kernel on CUDA cores; 1: the tensor cores,
// decode_mma_kernel<HD, true> at hd 64, 120 and 128 or
// decode_wide_kernel<288, true> at hd 288, for bf16 queries, G <= 16 and q rows
// on 4 bytes), then the shared merge.  A body that does not take the
// operands returns cudaErrorInvalidValue: no fallback.
template <typename T, int HD>
cudaError_t launch_q8(const void* q, const int8_t* k, const int8_t* v,
                      const float* ksc, const float* vsc,
                      const int* kv_valid, void* out, float* scratch, int B,
                      int Hq, int Hkv, int Lk, int local, const int* first,
                      Strides qs, Strides ks, Strides vs, Strides kss,
                      Strides vss, Strides os, float scale, float softcap,
                      int n_split, int chunk, int hd, int body, float* lse,
                      cudaStream_t s) {
  // 8-byte copies of every int8 row; the splits cover all Lk keys
  // one split on decode_mma_kernel<HD, true>: its rows go straight to out
  const bool direct = one_launch(n_split, lse != nullptr, body, hd);
  const long long st[] = {ks.b, ks.h, ks.l, vs.b, vs.h, vs.l};
  for (long long x : st)
    if (x % 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
          8 ||
      hd % 8 || (scratch == nullptr && !direct) || n_split < 1 ||
      chunk < 1 || (long long)n_split * chunk < Lk)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  float* ml = direct ? nullptr : scratch + (long long)B * Hq * n_split * hd;
  if (body == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && HD != 32) {
      if (G > 16 || reinterpret_cast<uintptr_t>(q) % 4 || qs.b % 2 ||
          qs.h % 2)
        return cudaErrorInvalidValue;     // q read as bf16 pairs
      const Mask mk{1, Lk, 0, 0, local, first};
      const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
      const dim3 grid(n_split, Hkv, B);
      if constexpr (HD == 288) {
        static const cudaError_t attr = cudaFuncSetAttribute(
            decode_wide_kernel<HD, true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            DecWide<HD, true>::SMEM);
        if (attr != cudaSuccess) return attr;
        decode_wide_kernel<HD, true><<<grid, 128, DecWide<HD, true>::SMEM,
                                       s>>>(
            qp, k, v, ksc, vsc, kv_valid, scratch, ml, G, mk, qs, ks, vs,
            kss, vss, scale, softcap, chunk);
      } else {
        static const cudaError_t attr = cudaFuncSetAttribute(
            decode_mma_kernel<HD, true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            DecMma<HD, true>::Q8_SMEM);
        if (attr != cudaSuccess) return attr;
        decode_mma_kernel<HD, true><<<grid, 128, DecMma<HD, true>::Q8_SMEM,
                                      s>>>(
            qp, k, v, ksc, vsc, kv_valid, scratch, ml, G, mk, qs, ks, vs,
            kss, vss, scale, softcap, chunk, hd,
            direct ? static_cast<__nv_bfloat16*>(out) : nullptr, os);
      }
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (body == 0) {
    const int ngrp = (G + DecQ8<HD>::GB - 1) / DecQ8<HD>::GB;
    decode_q8_kernel<T, HD><<<dim3(n_split, Hkv * ngrp, B), DEC_THREADS, 0,
                              s>>>(static_cast<const T*>(q), k, v, ksc, vsc,
                                   kv_valid, scratch, ml, G, Lk, local,
                                   first, qs, ks, vs, kss, vss, scale,
                                   softcap, chunk, hd);
  } else {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return e;
  return launch_combine<T, HD>(scratch, ml, out, B, Hq, n_split, os, hd, lse,
                               s);
}

template <typename T>
cudaError_t dispatch_q8(int hd, const void* q, const int8_t* k,
                        const int8_t* v, const float* ksc, const float* vsc,
                        const int* kv_valid, void* out, float* scratch,
                        int B, int Hq, int Hkv, int Lk, int local,
                        const int* first, Strides qs, Strides ks, Strides vs,
                        Strides kss, Strides vss, Strides os, float scale,
                        float softcap, int n_split, int chunk, int body,
                        float* lse, cudaStream_t s) {
#define Q8_LAUNCH(CAP)                                                      \
  launch_q8<T, CAP>(q, k, v, ksc, vsc, kv_valid, out, scratch, B, Hq, Hkv, \
                    Lk, local, first, qs, ks, vs, kss, vss, os, scale,     \
                    softcap, n_split, chunk, hd, body, lse, s)
  switch (hd) {
    case 32:
      return Q8_LAUNCH(32);
    case 64:
      return Q8_LAUNCH(64);
    case 120:                             // h2o-danube-3-4b, in 128
    case 128:
      return Q8_LAUNCH(128);
    case 288:                             // gemma2-2b
      return Q8_LAUNCH(288);
    default:
      return cudaErrorInvalidValue;
  }
#undef Q8_LAUNCH
}

// decode_merge: R ranks' (o, lse) through the combine body, one block
// per (batch, query head) of BH.
template <typename T>
cudaError_t launch_merge(const float* o, const float* lse, void* out, int R,
                         int BH, int Hq, int hd, Strides os, cudaStream_t s) {
  T* op = static_cast<T*>(out);
  switch (hd) {
    case 32:
      decode_combine_kernel<T, 32, true><<<BH, hd, 0, s>>>(
          o, lse, op, Hq, R, os, hd, nullptr, BH);
      break;
    case 64:
      decode_combine_kernel<T, 64, true><<<BH, hd, 0, s>>>(
          o, lse, op, Hq, R, os, hd, nullptr, BH);
      break;
    case 120:                             // h2o-danube-3-4b, in 128
    case 128:
      decode_combine_kernel<T, 128, true><<<BH, hd, 0, s>>>(
          o, lse, op, Hq, R, os, hd, nullptr, BH);
      break;
    case 288:                             // gemma2-2b
      decode_combine_kernel<T, 288, true><<<BH, hd, 0, s>>>(
          o, lse, op, Hq, R, os, hd, nullptr, BH);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// 1 where a decode of n_split splits on `body` (either launch's code) at
// head dim hd, with or without lse, is its body alone and takes no
// scratch (one_launch), else 0.
extern "C" int flash_decode_one_launch(int n_split, int lse, int body,
                                       int hd) {
  return one_launch(n_split, lse != 0, body, hd);
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (batch, head, position) axes; the head dim is contiguous.  Decode
// (Lq = 1) takes `scratch`, B * Hq * n_split * (hd + 2) floats (null
// where flash_decode_one_launch says so), and
// n_split chunks of `chunk` keys covering Lk, and `body`, the decode body
// the caller names (flash_attention.decode_body: 0 decode_split_kernel on
// CUDA cores, 1 decode_mma_kernel at hd <= 128, 2 decode_wide_kernel at
// hd 288; the tensor cores take bf16, G <= 16 and q rows on 4 bytes): one
// that does not take the operands returns cudaErrorInvalidValue, no
// fallback; prefill ignores the four.  local_window > 0 (decode only)
// keeps the keys kv_valid[b] - local_window <= ik < kv_valid[b]: a
// window that ends at each sequence's own live count, where
// causal/window end it at Lk.  kv_first (decode only, (B,)
// int32 or null) keeps the keys ik >= kv_first[b] besides: a rank's block
// of a cache sharded by length, whose live range starts inside it or past
// it.  lse (B, Hq, Lq) f32 or null: the rows' log-sum-exp; in the decode
// shape the output is then f32 (a partial for flash_decode_merge_launch).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_valid,
    void* out, int dtype, int B, int Hq, int Hkv, int Lq, int Lk, int hd,
    long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, long long osb, long long osh, long long osl, float scale,
    int causal, int window, float softcap, int local_window,
    const int* kv_first, void* scratch, int n_split, int chunk, int body,
    float* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Lk < 0 || local_window < 0 ||
      ((local_window || kv_first != nullptr) && Lq != 1))
    return cudaErrorInvalidValue;
  const Mask mk{Lq, Lk, causal, window, local_window, kv_first};
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      os{osb, osh, osl};
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_valid, out, sc, B, Hq, Hkv, mk,
                              qs, ks, vs, os, scale, softcap, n_split, chunk,
                              body, lse, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_valid, out, sc, B, Hq,
                                      Hkv, mk, qs, ks, vs, os, scale,
                                      softcap, n_split, chunk, body, lse, s);
  return cudaErrorInvalidValue;
}

// One query row against an int8 KV cache: q (B, Hq, 1, hd) in `dtype`
// (0 = float32, 1 = bfloat16); k / v (B, Hkv, Lk, hd) int8 and their
// scales k_scale / v_scale (B, Hkv, Lk, 1) float32, all through their
// (batch, head, position) strides in elements (int8 rows 8-byte
// aligned); the output in q's dtype.  kv_valid, local_window, kv_first
// and lse as the decode shape of flash_attention_launch (with lse the
// output is f32); scratch holds B * Hq * n_split * (hd + 2) floats (null
// where flash_decode_one_launch says so).
// `body` (0 CUDA cores, 1 tensor cores) is the caller's choice
// (flash_attention.q8_body); one that does not take the operands
// returns cudaErrorInvalidValue.
extern "C" int flash_decode_q8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const int* kv_valid, void* out, int dtype, int B,
    int Hq, int Hkv, int Lk, int hd, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, long long kssb,
    long long kssh, long long kssl, long long vssb, long long vssh,
    long long vssl, long long osb, long long osh, long long osl,
    float scale, float softcap, int local_window, const int* kv_first,
    void* scratch, int n_split, int chunk, int body, float* lse,
    void* stream) {
  if (B <= 0 || Hq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Lk < 0 || local_window < 0)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      kss{kssb, kssh, kssl}, vss{vssb, vssh, vssl}, os{osb, osh, osl};
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_q8<float>(hd, q, kp, vp, ksp, vsp, kv_valid, out, sc, B,
                              Hq, Hkv, Lk, local_window, kv_first, qs, ks, vs,
                              kss, vss, os, scale, softcap, n_split, chunk,
                              body, lse, s);
  if (dtype == 1)
    return dispatch_q8<__nv_bfloat16>(hd, q, kp, vp, ksp, vsp, kv_valid, out,
                                      sc, B, Hq, Hkv, Lk, local_window,
                                      kv_first, qs, ks, vs, kss, vss, os,
                                      scale, softcap, n_split, chunk, body,
                                      lse, s);
  return cudaErrorInvalidValue;
}

// R ranks' decode partials merged (decode_merge): o_parts (R, B, Hq, hd)
// and lse_parts (R, B, Hq), both f32 and contiguous, each rank's o over
// its own keys and their log-sum-exp (+inf: no live key), merged in rank
// order by decode_combine_kernel; the output in `dtype` (0 = float32, 1 =
// bfloat16) through its (batch, head) strides in elements.
extern "C" int flash_decode_merge_launch(const float* o_parts,
                                         const float* lse_parts, void* out,
                                         int dtype, int R, int B, int Hq,
                                         int hd, long long osb,
                                         long long osh, void* stream) {
  if (B <= 0 || Hq <= 0) return cudaSuccess;
  if (R < 1 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  const Strides os{osb, osh, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_merge<float>(o_parts, lse_parts, out, R, B * Hq, Hq, hd,
                               os, s);
  return launch_merge<__nv_bfloat16>(o_parts, lse_parts, out, R, B * Hq, Hq,
                                     hd, os, s);
}

// The backward (flash_attention_bwd.cuh): q, k, v, the forward's output o
// and its log-sum-exp lse (B, Hq, Lq) f32 contiguous, the output's
// gradient dout, all in `dtype` (0 = float32, 1 = bfloat16) through
// their (batch, head, position) strides in elements with the head dim
// contiguous; the mask of the forward (causal, window, softcap, kv_valid;
// no decode-shape window).  Writes dq, dk, dv in `dtype` through their
// strides; delta is (B, Hq, Lq) f32 scratch.  `body` (0 f32, 1 mma, 2
// wgmma) is the caller's choice; one that does not take the operands
// returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const int* kv_valid, void* dq,
    void* dk, void* dv, float* delta, int dtype, int B, int Hq, int Hkv,
    int Lq, int Lk, int hd, const long long* st, float scale, int causal,
    int window, float softcap, int body, void* stream) {
  if (B <= 0 || Hq <= 0 || Lq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Lk <= 0 || hd <= 0)
    return cudaErrorInvalidValue;
  const Mask mk{Lq, Lk, causal, window, 0};
  // st: the (b, h, l) strides of q, k, v, o, dout, dq, dk, dv in turn
  Strides S[8];
  for (int i = 0; i < 8; ++i) S[i] = Strides{st[3 * i], st[3 * i + 1],
                                             st[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa_bwd::launch<float>(q, k, v, o, dout, lse, kv_valid, dq, dk, dv,
                                 delta, B, Hq, Hkv, mk, S[0], S[1], S[2],
                                 S[3], S[4], S[5], S[6], S[7], scale, softcap,
                                 hd, body, s);
  if (dtype == 1)
    return fa_bwd::launch<__nv_bfloat16>(q, k, v, o, dout, lse, kv_valid, dq,
                                         dk, dv, delta, B, Hq, Hkv, mk, S[0],
                                         S[1], S[2], S[3], S[4], S[5], S[6],
                                         S[7], scale, softcap, hd, body,
                                         s);
  return cudaErrorInvalidValue;
}
