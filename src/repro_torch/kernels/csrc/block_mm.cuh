// Block-cooperative f32 matrix products in shared memory, on CUDA cores,
// and the small pieces the backward kernels share.
//
// block_mm<TM, TN>(M, N, K, a, a_i, a_k, b, b_k, b_j, epi) forms
// C = A B, A (M x K) with element (i, k) at a[i a_i + k a_k] and B (K x N)
// with element (k, j) at b[k b_k + j b_j], both in shared memory, and
// hands each C element to epi(i, j, value), once, from one thread.  The
// block's threads take TM x TN micro-tiles: thread t owns the rows ti +
// r tm and the columns tj + c tn (tm, tn the tile counts), so the threads
// of a warp read neighbouring columns of B (conflict-free with b_j = 1 or
// an odd row pitch) and one row of A (a broadcast).  Each K step costs
// TM + TN shared loads for TM TN fused multiply-adds.  The sum runs over
// k in order: the same bits on every run.  The caller synchronises the
// block around it.
//
// Shared-memory tiles use an odd row pitch (width + 1 floats), so a
// column read across rows never hits one bank twice.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float ld_f32(float x) { return x; }
__device__ __forceinline__ float ld_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void st_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void st_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int TM, int TN, typename Epi>
__device__ __forceinline__ void block_mm(int M, int N, int K,
                                         const float* a, int a_i, int a_k,
                                         const float* b, int b_k, int b_j,
                                         Epi epi) {
  const int tm = (M + TM - 1) / TM, tn = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int ti = t / tn, tj = t - ti * tn;
    const float* ar[TM];
    const float* bc[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = ti + r * tm;
      ar[r] = a + (long long)(i < M ? i : M - 1) * a_i;
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = tj + c * tn;
      bc[c] = b + (long long)(j < N ? j : N - 1) * b_j;
    }
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = ar[r][(long long)k * a_k];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = bc[c][(long long)k * b_k];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int i = ti + r * tm, j = tj + c * tn;
        if (i < M && j < N) epi(i, j, acc[r][c]);
      }
  }
}

// The block's sum of one float a thread, in a fixed order: each warp's
// 32 values in shared memory, summed by lane 0 of each warp in lane
// order, then the warps' sums by thread 0 in warp order.  `red` holds
// blockDim.x floats; every thread gets the sum.  Two __syncthreads.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  if ((t & 31) == 0) {
    float s = 0.f;
    const int hi = min(t + 32, (int)blockDim.x);
    for (int u = t; u < hi; ++u) s += red[u];
    red[t] = s;
  }
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)blockDim.x; w += 32) s += red[w];
  __syncthreads();
  return s;
}
