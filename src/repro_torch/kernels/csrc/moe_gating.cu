// Fused MoE gate: row softmax -> top-k -> renormalize, plus per-block
// partial sums for the load-balance aux loss.
//
// Replaces the Pallas TPU kernel moe_gating_pallas (body _gate_kernel,
// src/repro/kernels/moe_gating.py).  Same contract: logits (T, E) f32 or
// bf16 (rows strided, the expert axis contiguous); per token, in f32:
// probs = softmax(logits), then k rounds of argmax over what is left
// (ties to the lower expert index, the order jax.lax.top_k gives), then
// vals / (sum(vals) + 1e-9).  Outputs vals (T, k) f32, idx (T, k) int32,
// and per block of BLK_T tokens the sums over its tokens of probs and of
// the one-hot assignments, psum / asum (nblk, E) f32, from which the
// wrapper forms aux = E * sum_e mean_prob_e * mean_assign_e.
//
// What bounds it on an H100: bytes.  At the prefill shape of
// qwen3-moe-30b-a3b (T = 8192, E = 128, k = 8, bf16) it reads 2.1 MB of
// logits and writes 0.5 MB, about 0.8 us at 3.35 TB/s, against some
// 20 M f32 operations; at decode (T = 16) one launch costs far more than
// the work.  So the design is simple and launch-bound:
//  * one warp per token, lanes striding over E (lane l holds experts
//    l, l + 32, ...: coalesced reads), NPER = ceil(E / 32) values per
//    lane in registers, E <= 1024;
//  * the row max and sum by xor-shuffles; each lane keeps its probs;
//  * k rounds of warp argmax with the comparator "larger value, then
//    lower index"; the winning lane marks its entry -inf and counts the
//    assignment;
//  * 8 warps of 2 tokens each per block (a warp's tokens run one after
//    the other, so few per warp keep a launch's serial latency short:
//    8 per warp took 0.019 ms even at T = 16); each warp accumulates its
//    tokens' probs and assignments in registers, then the block sums
//    the 8 warp rows through shared memory in a fixed order into its
//    (E,) rows of psum / asum.  No atomics, so aux is the same bits on
//    every run; rows >= T are not counted (the TPU kernel's live mask).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 2;
constexpr int BLK_T = WARPS * ROWS_PER_WARP;   // tokens per block
constexpr int MAX_E = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (v, i) ranks before (w, j): larger value, then lower index
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <typename T, int NPER>
__global__ void __launch_bounds__(WARPS * 32)
gate_kernel(const T* __restrict__ logits, long long row_stride, int n_tok,
            int E, int k, float* __restrict__ vals, int* __restrict__ idx,
            float* __restrict__ psum, float* __restrict__ asum) {
  extern __shared__ float red[];                 // [WARPS][E]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float pacc[NPER], aacc[NPER];
#pragma unroll
  for (int i = 0; i < NPER; ++i) pacc[i] = aacc[i] = 0.f;

  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const int t = blockIdx.x * BLK_T + warp * ROWS_PER_WARP + j;
    if (t >= n_tok) break;                       // warp-uniform
    const T* row = logits + (long long)t * row_stride;
    float p[NPER];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int c = lane + 32 * i;
      p[i] = c < E ? to_f32(row[c]) : -CUDART_INF_F;
      m = fmaxf(m, p[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      p[i] = lane + 32 * i < E ? expf(p[i] - m) : 0.f;
      s += p[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      p[i] = p[i] / s;
      pacc[i] += p[i];                           // 0 beyond E
      if (lane + 32 * i >= E) p[i] = -CUDART_INF_F;
    }

    // k rounds of argmax over what is left; slot r is kept by lane r % 32
    float* vrow = vals + (long long)t * k;
    int* irow = idx + (long long)t * k;
    float vsum = 0.f;
    for (int r = 0; r < k; ++r) {
      float bv = -CUDART_INF_F;
      int bi = INT_MAX;
#pragma unroll
      for (int i = 0; i < NPER; ++i) {
        const int c = lane + 32 * i;
        if (c < E && before(p[i], c, bv, bi)) {
          bv = p[i];
          bi = c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
#pragma unroll
      for (int i = 0; i < NPER; ++i) {
        if (lane + 32 * i == bi) {
          p[i] = -CUDART_INF_F;
          aacc[i] += 1.f;
        }
      }
      if ((r & 31) == lane) {
        vrow[r] = bv;
        irow[r] = bi;
      }
      vsum += bv;
    }
    const float den = vsum + 1e-9f;
    for (int r = lane; r < k; r += 32) vrow[r] = vrow[r] / den;
  }

  // the block's partial sums: warp rows through shared memory, summed
  // over the warps in a fixed order
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int c = lane + 32 * i;
    if (c < E) red[warp * E + c] = pacc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < E; c += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += red[w * E + c];
    psum[(long long)blockIdx.x * E + c] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NPER; ++i) {
    const int c = lane + 32 * i;
    if (c < E) red[warp * E + c] = aacc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < E; c += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += red[w * E + c];
    asum[(long long)blockIdx.x * E + c] = acc;
  }
}

template <typename T, int NPER>
cudaError_t launch_n(const void* logits, long long row_stride, int n_tok,
                     int E, int k, float* vals, int* idx, float* psum,
                     float* asum, cudaStream_t s) {
  const int nblk = (n_tok + BLK_T - 1) / BLK_T;
  const size_t smem = sizeof(float) * WARPS * E;   // <= 32 KB
  gate_kernel<T, NPER><<<nblk, WARPS * 32, smem, s>>>(
      static_cast<const T*>(logits), row_stride, n_tok, E, k, vals, idx,
      psum, asum);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits, long long row_stride, int n_tok,
                   int E, int k, float* vals, int* idx, float* psum,
                   float* asum, cudaStream_t s) {
  if (E <= 32)
    return launch_n<T, 1>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                          asum, s);
  if (E <= 64)
    return launch_n<T, 2>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                          asum, s);
  if (E <= 128)
    return launch_n<T, 4>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                          asum, s);
  if (E <= 256)
    return launch_n<T, 8>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                          asum, s);
  if (E <= 512)
    return launch_n<T, 16>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                           asum, s);
  return launch_n<T, 32>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                         asum, s);
}

}  // namespace

// Tokens per block: psum / asum have ceil(T / BLK_T) rows.
extern "C" int moe_gating_block_tokens() { return BLK_T; }

// dtype: 0 = float32, 1 = bfloat16.  logits row t starts at
// t * row_stride elements; vals / idx (T, k) and psum / asum
// (ceil(T / BLK_T), E) contiguous.
extern "C" int moe_gating_launch(const void* logits, int dtype, int n_tok,
                                 int E, int k, long long row_stride,
                                 float* vals, int* idx, float* psum,
                                 float* asum, void* stream) {
  if (n_tok <= 0) return cudaSuccess;
  if (E <= 0 || E > MAX_E || k <= 0 || k > E || row_stride < E)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, row_stride, n_tok, E, k, vals, idx, psum,
                         asum, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, row_stride, n_tok, E, k, vals, idx,
                                 psum, asum, s);
  return cudaErrorInvalidValue;
}
