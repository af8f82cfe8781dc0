// The backward of moe_gating (included by moe_gating.cu).
//
// The TPU package differentiates its gate with jax.grad; there is no
// Pallas backward.  The forward's outputs that carry a gradient are the
// renormalised values vals (T, k) and aux.  With p = softmax(logits) per
// row, r_j = p[idx_j], S = sum_j r_j and vals_j = r_j / (S + 1e-9):
//   dr_j   = dvals_j / (S + 1e-9) - sum_l dvals_l r_l / (S + 1e-9)^2
//   dp     = daux E asum / T^2 everywhere (aux = E / T^2 sum_e psum_e
//            asum_e, and the assignment counts asum carry no gradient),
//            plus dr_j at idx_j
//   dlogits = p (dp - sum_e p_e dp_e)    (the softmax's Jacobian)
//
// What bounds it on an H100: bytes.  At qwen3-moe-30b-a3b's training
// gate (T = 8192, E = 128, k = 8, bf16) it reads 2.1 MB of logits and
// writes 2.1 MB of dlogits, 1.4 us at 3.35 TB/s.  A row is 128 values,
// far too little work for a block: the row's three reductions (max,
// sum, the p . dp dot) are what a row costs, so they must not need the
// block.
//
// Design: a row to L lanes of one warp, WARPS warps a block, no shared
// memory and no __syncthreads.  Up to E = 128 (the width of every MoE
// gate the port serves) a row takes a half warp, 8 experts a lane, which
// took fewer instructions a row than a whole warp's 4 when tuned on the
// card; past 128, up to 1024, a whole warp, 32 experts a lane.  Each
// lane holds PER of the row's experts in registers: where the rows sit
// on 16 bytes and E is a multiple of PER, a run of PER consecutive ones
// moved 16 bytes at a time; otherwise experts l, l + L, ... .
// Winner j is lane j % L's: it reads idx_j and dvals_j at the start, and
// a shuffle in winner order hands each to the lane that owns idx_j,
// which counts its experts' wins (n_e) and sums their dvals (d_e) -- all
// before the softmax, so those loads and shuffles overlap the logits'
// load.  Then every reduction is a __shfl_xor_sync butterfly over the
// row's L lanes, a fixed order that leaves each of them with the same
// bits: the row's max, then in one butterfly the three sums sum_e x_e,
// sum_e x_e n_e and sum_e x_e d_e of the unnormalised x_e = exp(logit_e
// - max) (so S and sum_j dvals_j r_j come out with the softmax's
// denominator), then the p . dp dot, with dp_e = daux scale asum_e + d_e
// / (S + 1e-9) - n_e corr.  Two divisions a row (1 / sum, 1 / (S +
// 1e-9)); the rest are products.  daux is read on the card, so no value
// comes to the host.  Two launches give the same bits.
#pragma once

#include "block_mm.cuh"

namespace gate_bwd {

constexpr int WARPS = 8;                  // warps a block

template <int L>
__device__ __forceinline__ float bfly_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float bfly_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// PER consecutive values from 16-byte aligned p, as f32, and back
template <int PER>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
  }
}

template <int PER>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p,
                                       float (&x)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; i += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      x[i + 2 * h] = f.x;
      x[i + 2 * h + 1] = f.y;
    }
  }
}

template <int PER>
__device__ __forceinline__ void st_vec(float* p, const float (&y)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
}

template <int PER>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p,
                                       const float (&y)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; i += 8) {
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(y[i + 2 * h],
                                                     y[i + 2 * h + 1]);
      w[h] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// L lanes a row, PER experts a lane: E <= L PER.  VEC: lane l holds the
// consecutive experts l PER .. l PER + PER - 1, moved 16 bytes at a time
// (rows on 16 bytes, E a multiple of PER); otherwise experts l, l + L, ...
template <typename T, int L, int PER, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
gate_bwd_kernel(const T* __restrict__ logits, long long row_stride,
                int n_tok, int E, int k, const int* __restrict__ idx,
                const float* __restrict__ dvals,
                const float* __restrict__ daux,
                const float* __restrict__ asum, float scale,
                T* __restrict__ dlogits) {
  const int lane = threadIdx.x % L;
  const long long t0 =
      ((long long)blockIdx.x * WARPS + threadIdx.x / 32) * (32 / L) +
      (threadIdx.x & 31) / L;
  if (t0 - (threadIdx.x & 31) / L >= n_tok) return;  // the whole warp
  const bool live = t0 < n_tok;           // a row past T: shuffles only
  const long long t = live ? t0 : n_tok - 1;
  const T* row = logits + t * row_stride;
  auto expert = [&](int i) { return VEC ? lane * PER + i : L * i + lane; };
  const bool span = !VEC || lane * PER < E;  // VEC: a lane's run, all in
  float x[PER], n[PER], d[PER], a[PER];
  if constexpr (VEC) {
    if (span) {
      ld_vec<PER>(row + lane * PER, x);
      ld_vec<PER>(asum + lane * PER, a);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = expert(i);
      x[i] = e < E ? ld_f32(row[e]) : -INFINITY;
      a[i] = e < E ? asum[e] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (!span) x[i] = -INFINITY, a[i] = 0.f;
    n[i] = d[i] = 0.f;
  }
  // the winners, to the lanes that own their experts, in winner order
  const int* ix = idx + t * k;
  const float* dv = dvals + t * k;
  for (int j0 = 0; j0 < k; j0 += L) {
    const int mine = j0 + lane < k ? ix[j0 + lane] : 0;
    const float dmine = j0 + lane < k ? dv[j0 + lane] : 0.f;
    const int nw = min(L, k - j0);
    for (int src = 0; src < nw; ++src) {
      const int e = __shfl_sync(0xffffffffu, mine, src, L);
      const float de = __shfl_sync(0xffffffffu, dmine, src, L);
      const bool own = (VEC ? e / PER : e % L) == lane;
      const int slot = VEC ? e % PER : e / L;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (own && i == slot) {
          n[i] += 1.f;
          d[i] += de;
        }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) m = fmaxf(m, x[i]);
  m = bfly_max<L>(m);
  float s = 0.f, sn = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    x[i] = span && expert(i) < E ? expf(x[i] - m) : 0.f;
    s += x[i];
    sn = fmaf(x[i], n[i], sn);
    sd = fmaf(x[i], d[i], sd);
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {   // one butterfly for the three
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sn += __shfl_xor_sync(0xffffffffu, sn, o);
    sd += __shfl_xor_sync(0xffffffffu, sd, o);
  }
  const float inv = 1.f / s;
  const float S = sn * inv, w = sd * inv;  // sum_j r_j, sum_j dvals_j r_j
  const float iden = 1.f / (S + 1e-9f);
  const float corr = w * iden * iden;
  const float da = daux[0] * scale;
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    x[i] *= inv;                          // p
    d[i] = da * a[i] + (d[i] * iden - n[i] * corr);
    dot = fmaf(x[i], d[i], dot);
  }
  dot = bfly_sum<L>(dot);
  if (!live || !span) return;
  T* out = dlogits + t * E;
#pragma unroll
  for (int i = 0; i < PER; ++i) x[i] *= d[i] - dot;
  if constexpr (VEC) {
    st_vec<PER>(out + lane * PER, x);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (expert(i) < E) st_f32(out + expert(i), x[i]);
  }
}

template <typename T, int L, int PER, bool VEC>
void launch_per(const T* logits, long long row_stride, int T_, int E, int k,
                const int* idx, const float* dvals, const float* daux,
                const float* asum, float scale, T* dlogits, cudaStream_t s) {
  constexpr int ROWS = WARPS * 32 / L;    // rows a block
  const unsigned blocks = (unsigned)((T_ + ROWS - 1) / ROWS);
  gate_bwd_kernel<T, L, PER, VEC><<<blocks, WARPS * 32, 0, s>>>(
      logits, row_stride, T_, E, k, idx, dvals, daux, asum, scale, dlogits);
}

template <typename T, int L, int PER>
void launch_lp(const T* logits, long long row_stride, int T_, int E, int k,
               const int* idx, const float* dvals, const float* daux,
               const float* asum, float scale, T* dlogits, cudaStream_t s) {
  // 16-byte runs: logits' rows and base, asum, dlogits (rows of E)
  const bool vec =
      E % PER == 0 &&
      (reinterpret_cast<uintptr_t>(logits) | reinterpret_cast<uintptr_t>(asum) |
       reinterpret_cast<uintptr_t>(dlogits)) % 16 == 0 &&
      (row_stride * (long long)sizeof(T)) % 16 == 0 &&
      ((long long)E * sizeof(T)) % 16 == 0;
  (vec ? &launch_per<T, L, PER, true> : &launch_per<T, L, PER, false>)(
      logits, row_stride, T_, E, k, idx, dvals, daux, asum, scale, dlogits,
      s);
}

template <typename T>
cudaError_t launch(const T* logits, long long row_stride, int T_, int E,
                   int k, const int* idx, const float* dvals,
                   const float* daux, const float* asum, float scale,
                   T* dlogits, cudaStream_t s) {
  if (T_ <= 0) return cudaSuccess;
  if (E <= 0 || E > 1024 || k <= 0 || k > E) return cudaErrorInvalidValue;
  auto* fn = E <= 128 ? &launch_lp<T, 16, 8> : &launch_lp<T, 32, 32>;
  fn(logits, row_stride, T_, E, k, idx, dvals, daux, asum, scale, dlogits, s);
  return cudaGetLastError();
}

}  // namespace gate_bwd
