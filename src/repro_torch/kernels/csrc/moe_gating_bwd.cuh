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
// One block a token (a fused per-row pass with one reduction): the row's
// max, its sum, then the dot, each a block_sum in a fixed order; the k
// winners' terms by one thread in rank order.  daux is read on the card,
// so no value comes to the host.
//
// What bounds it on an H100: bytes.  At qwen3-moe-30b-a3b's training
// gate (T = 8192, E = 128, k = 8, bf16) it reads 2.1 MB of logits and
// writes 2.1 MB of dlogits, 1.3 us at 3.35 TB/s; a block a row with its
// block-wide reductions is latency-bound well above that (later work:
// a row a warp, several rows a block).
#pragma once

#include "block_mm.cuh"

namespace gate_bwd {

constexpr int THREADS = 128;

__device__ __forceinline__ float block_max(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  if (t == 0) {
    float m = red[0];
    for (int u = 1; u < (int)blockDim.x; ++u) m = fmaxf(m, red[u]);
    red[0] = m;
  }
  __syncthreads();
  const float m = red[0];
  __syncthreads();
  return m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gate_bwd_kernel(const T* __restrict__ logits, long long row_stride, int E,
                int k, const int* __restrict__ idx,
                const float* __restrict__ dvals,
                const float* __restrict__ daux,
                const float* __restrict__ asum, float scale,
                T* __restrict__ dlogits) {
  extern __shared__ __align__(16) float sm[];
  float* p = sm;             // (E,) probabilities
  float* dp = p + E;         // (E,) their gradient
  float* red = dp + E;       // (THREADS,)
  const long long t = blockIdx.x;
  const T* row = logits + t * row_stride;
  float m = -INFINITY;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    m = fmaxf(m, ld_f32(row[e]));
  m = block_max(m, red);
  float s = 0.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    p[e] = expf(ld_f32(row[e]) - m);
    s += p[e];
  }
  s = block_sum(s, red);
  const float da = daux[0] * scale;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    p[e] = p[e] / s;
    dp[e] = da * asum[e];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* ix = idx + t * k;
    const float* dv = dvals + t * k;
    float S = 0.f, w = 0.f;
    for (int j = 0; j < k; ++j) S += p[ix[j]];
    const float den = S + 1e-9f;
    for (int j = 0; j < k; ++j) w = fmaf(dv[j], p[ix[j]], w);
    const float corr = w / (den * den);
    for (int j = 0; j < k; ++j) dp[ix[j]] += dv[j] / den - corr;
  }
  __syncthreads();
  float d = 0.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) d = fmaf(p[e], dp[e], d);
  d = block_sum(d, red);
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    st_f32(dlogits + t * E + e, p[e] * (dp[e] - d));
}

template <typename T>
cudaError_t launch(const T* logits, long long row_stride, int T_, int E,
                   int k, const int* idx, const float* dvals,
                   const float* daux, const float* asum, float scale,
                   T* dlogits, cudaStream_t s) {
  if (T_ <= 0) return cudaSuccess;
  const int smem = (2 * E + THREADS) * 4;
  if (E <= 0 || k <= 0 || k > E || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  gate_bwd_kernel<T><<<(unsigned)T_, THREADS, smem, s>>>(
      logits, row_stride, E, k, idx, dvals, daux, asum, scale, dlogits);
  return cudaGetLastError();
}

}  // namespace gate_bwd
