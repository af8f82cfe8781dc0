// Fused MoE gate: row softmax -> top-k -> renormalize, and the
// load-balance aux loss, in one launch.
//
// Replaces the Pallas TPU kernel moe_gating_pallas (body _gate_kernel,
// src/repro/kernels/moe_gating.py).  Same contract: logits (T, E) f32 or
// bf16 (rows strided, the expert axis contiguous); per token, in f32:
// probs = softmax(logits), the k largest in descending order with ties
// to the lower expert index (the order jax.lax.top_k gives), then
// vals / (sum(vals) + 1e-9).  Outputs vals (T, k) f32, idx (T, k) int32
// and aux = E * sum_e mean_t(prob_e) * mean_t(assigned_e), one f32.
//
// What bounds it on an H100: bytes, then the launch.  At the prefill
// shape of qwen3-moe-30b-a3b (T = 8192, E = 128, k = 8, bf16) it reads
// 2.1 MB of logits and writes 0.5 MB, about 0.8 us at 3.35 TB/s, against
// some 100 M f32 operations (~1.5 us at 67 TFLOP/s if spread over the
// card); at decode (T = 16) the launch costs far more than the work.  So
// the design shortens the serial chain of one token and keeps the aux in
// the same launch:
//  * a token is held by a group of LPT lanes, lane j of it owning the V
//    consecutive experts j V .. j V + V - 1 (LPT V >= E; at E = 128, 16
//    lanes of 8: one 16-byte load of bf16 or two of f32), so a warp
//    holds 32 / LPT tokens side by side and a row's max and sum are
//    log2(LPT)-level butterflies inside the group;
//  * the ranking key: a probability is >= 0, so its f32 bits order like
//    its value, and key = bits << 32 | (0xffffffff - expert) ranks
//    "larger value, then lower index" as the larger key; an expert
//    taken (or beyond E) is key 0;
//  * each lane sorts its V keys (a bitonic network in registers).  A
//    launch of one block (decode) waits on its serial chain, so where
//    k <= V (the served k = 8 of V = 8) a merge tree follows: at each of
//    log2(LPT) butterfly levels a lane takes its partner's sorted list,
//    reversed, keeps the larger key of each pair (the V best of the two,
//    as a bitonic sequence) and sorts them again, so after the last level
//    every lane of the group holds the group's V best in order -- no
//    serial rounds.  A launch of many blocks (prefill: 32 warps an SM)
//    waits on instruction issue, and there k rounds, which issue fewer
//    instructions, each take the largest of the lanes' heads (a 64-bit
//    max butterfly) and its lane pops it.  Lane 0 keeps the k winners in
//    shared memory; the group then writes vals (renormalized) and idx in
//    one store, each writing lane counting its winner's assignment (an
//    integer atomic in shared memory: the order of integer adds does not
//    change the sum);
//  * aux: each lane sums its experts' probabilities over the block's
//    tokens; the warp's groups are summed by shuffles and the warps
//    through shared memory, in a fixed order.  With one block (decode)
//    the block forms aux itself.  Otherwise each block writes its (2, E)
//    partial sums and the last block to finish (a ticket counter) adds
//    them in a fixed order, forms aux and sets the counter back to 0 for
//    the next launch (a CUDA-graph replay included).  No float atomics:
//    aux is the same bits on every run.  Tokens past T count nothing.
//  The launch shape (warps per block, blocks) comes from the wrapper's
//  plan (kernels/moe_gating.py gate_plan), a function of (T, E, k); a
//  block walks its tokens grid-stride when T needs more than the plan's
//  blocks.  One counter per process: launches on two streams at once
//  would share it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_E = 1024;
constexpr int SMEM_MAX = 48 * 1024;

using u64 = unsigned long long;

__device__ unsigned g_ticket = 0;   // blocks finished in this launch

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// experts c0 .. c0 + V - 1 of a row: 16-byte loads where `vec` (the
// row on 16 bytes, E a multiple of the values per 16 bytes, so a load is
// all inside E or all outside), else one value at a time; -inf past E
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0,
                                         int E, bool vec, float (&x)[V]) {
  constexpr int PER = 16 / sizeof(T);
  static_assert(V % PER == 0, "whole 16-byte loads per lane");
  if (vec) {
#pragma unroll
    for (int u = 0; u < V / PER; ++u) {
      const int c = c0 + u * PER;
      if (c < E) {
        const uint4 w = *reinterpret_cast<const uint4*>(row + c);
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int i = 0; i < PER; ++i) x[u * PER + i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) x[u * PER + i] = -CUDART_INF_F;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      x[i] = c0 + i < E ? to_f32(row[c0 + i]) : -CUDART_INF_F;
  }
}

// sort V keys in descending order: a bitonic network, unrolled, so the
// keys stay in registers
template <int V>
__device__ __forceinline__ void sort_desc(u64 (&key)[V]) {
#pragma unroll
  for (int size = 2; size <= V; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = i ^ stride;
        if (j > i && (key[i] < key[j]) == ((i & size) == 0)) {
          const u64 t = key[i];
          key[i] = key[j];
          key[j] = t;
        }
      }
}

// a bitonic sequence of V keys into descending order
template <int V>
__device__ __forceinline__ void merge_desc(u64 (&key)[V]) {
#pragma unroll
  for (int stride = V / 2; stride > 0; stride >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      if ((i & stride) == 0 && key[i] < key[i + stride]) {
        const u64 t = key[i];
        key[i] = key[i + stride];
        key[i + stride] = t;
      }
}

// dynamic shared memory: each group's k winners (u64), then RED rows of
// EP floats (the warps' probability sums; at least two rows), then EP
// assignment counts
__host__ __device__ constexpr int red_rows(int nw) { return nw > 2 ? nw : 2; }

__host__ __device__ constexpr int smem_bytes(int nw, int gpw, int ep, int k) {
  return 8 * nw * gpw * k + 4 * red_rows(nw) * ep + 4 * ep;
}

template <typename T, int LPT, int V, int MAXT>
__global__ void __launch_bounds__(MAXT)
gate_kernel(const T* __restrict__ logits, long long row_stride, int n_tok,
            int E, int k, int vec, float scale, float* __restrict__ vals,
            int* __restrict__ idx, float* __restrict__ part,
            float* __restrict__ aux, float* __restrict__ asum) {
  constexpr int GPW = 32 / LPT;            // tokens a warp holds at once
  constexpr int EP = LPT * V;              // experts a group covers
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ float wsum[32];
  __shared__ unsigned last;
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPT, j = lane % LPT;
  const int tpb = nw * GPW;                // tokens per block and pass
  u64* slots = reinterpret_cast<u64*>(raw) + (warp * GPW + grp) * k;
  float* red = reinterpret_cast<float*>(raw + 8 * (size_t)tpb * k);
  unsigned* cnt = reinterpret_cast<unsigned*>(red + red_rows(nw) * EP);
  const int c0 = j * V;

  for (int c = threadIdx.x; c < EP; c += blockDim.x) cnt[c] = 0u;
  __syncthreads();
  float pacc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) pacc[i] = 0.f;

  for (int base = blockIdx.x * tpb; base < n_tok; base += gridDim.x * tpb) {
    const int t = base + warp * GPW + grp;
    const bool live = t < n_tok;         // a dead group works on row T - 1
    float x[V];                          // and keeps nothing
    load_row<T, V>(logits + (long long)(live ? t : n_tok - 1) * row_stride,
                   c0, E, vec != 0, x);
    float m = x[0];
#pragma unroll
    for (int i = 1; i < V; ++i) m = fmaxf(m, x[i]);
#pragma unroll
    for (int off = LPT / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      x[i] = c0 + i < E ? expf(x[i] - m) : 0.f;
      s += x[i];
    }
#pragma unroll
    for (int off = LPT / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    u64 key[V];
    const float rs = __frcp_rn(s);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float p = x[i] * rs;          // 0 beyond E
      if (live) pacc[i] += p;
      key[i] = c0 + i < E ? (u64)__float_as_uint(p) << 32 |
                                (0xffffffffu - (unsigned)(c0 + i))
                          : 0ull;
    }
    sort_desc<V>(key);
    float vsum = 0.f;
    if (V <= 16 && k <= V && gridDim.x == 1) {   // block-uniform
      // merge tree: the V best of the lane and its partner, level by level
#pragma unroll
      for (int off = 1; off < LPT; off <<= 1) {
        u64 o[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          o[i] = __shfl_xor_sync(0xffffffffu, key[V - 1 - i], off);
#pragma unroll
        for (int i = 0; i < V; ++i) key[i] = max(key[i], o[i]);
        merge_desc<V>(key);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i < k) {
          vsum += __uint_as_float((unsigned)(key[i] >> 32));
          if (j == 0) slots[i] = key[i];
        }
      }
    } else {
      for (int r = 0; r < k; ++r) {
        // the group's largest head; its lane pops it (keys are distinct)
        u64 w = key[0];
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1)
          w = max(w, __shfl_xor_sync(0xffffffffu, w, off));
        if (key[0] == w) {
#pragma unroll
          for (int i = 0; i < V - 1; ++i) key[i] = key[i + 1];
          key[V - 1] = 0ull;
        }
        vsum += __uint_as_float((unsigned)(w >> 32));
        if (j == 0) slots[r] = w;
      }
    }
    __syncwarp();
    if (live) {
      const float den = vsum + 1e-9f;
      for (int r = j; r < k; r += LPT) {
        const u64 w = slots[r];
        const unsigned e = 0xffffffffu - (unsigned)w;
        vals[(long long)t * k + r] =
            __uint_as_float((unsigned)(w >> 32)) / den;
        idx[(long long)t * k + r] = (int)e;
        atomicAdd(&cnt[e], 1u);
      }
    }
    __syncwarp();                        // slots are reused next pass
  }

  // the block's sums: the warp's groups by shuffles, then the warps in
  // order through shared memory
#pragma unroll
  for (int off = LPT; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      pacc[i] += __shfl_xor_sync(0xffffffffu, pacc[i], off);
  if (grp == 0)
#pragma unroll
    for (int i = 0; i < V; ++i) red[warp * EP + c0 + i] = pacc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < EP; c += blockDim.x) {
    float a = red[c];
#pragma unroll 8
    for (int w = 1; w < nw; ++w) a += red[w * EP + c];
    red[c] = a;                          // column c is this thread's
  }
  __syncthreads();
  for (int c = threadIdx.x; c < EP; c += blockDim.x)
    red[EP + c] = (float)cnt[c];
  if (gridDim.x > 1) {
    // partial sums out; the last block adds every block's, in a fixed
    // order: R row ranges side by side, then the ranges in turn
    constexpr int C2 = 2 * EP;
    __syncthreads();
    for (int c = threadIdx.x; c < C2; c += blockDim.x)
      part[(size_t)blockIdx.x * C2 + c] = red[c];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    int R = (int)blockDim.x / C2;
    R = R < 1 ? 1 : R > red_rows(nw) / 2 ? red_rows(nw) / 2 : R;
    const int per = ((int)gridDim.x + R - 1) / R;
    for (int e = threadIdx.x; e < R * C2; e += blockDim.x) {
      const int g = e / C2, c = e - g * C2;
      const int b1 = min((int)gridDim.x, (g + 1) * per);
      float a = 0.f;
      for (int b0 = g * per; b0 < b1; b0 += 16) {   // 16 loads in flight
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          v[i] = b0 + i < b1 ? __ldcg(part + (size_t)(b0 + i) * C2 + c) : 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) a += v[i];
      }
      red[e] = a;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C2; c += blockDim.x) {
      float a = red[c];
      for (int g = 1; g < R; ++g) a += red[g * C2 + c];
      red[c] = a;
    }
  }
  __syncthreads();
  if (asum != nullptr)                  // the assignment counts (the
    for (int c = threadIdx.x; c < E; c += blockDim.x) {  // backward's)
      asum[c] = red[EP + c];              // and the probability sums (a
      asum[E + c] = red[c];               // token-sharded gate's aux)
    }
  // aux = scale * sum_e psum_e asum_e, by threads, warps, then in order
  float d = 0.f;
  for (int c = threadIdx.x; c < E; c += blockDim.x) d += red[c] * red[EP + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) wsum[warp] = d;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f;
#pragma unroll 8
    for (int w = 0; w < nw; ++w) a += wsum[w];
    *aux = a * scale;
    if (gridDim.x > 1) atomicExch(&g_ticket, 0u);   // for the next launch
  }
}

template <typename T, int LPT, int V>
cudaError_t launch_cfg(const T* logits, long long row_stride, int n_tok,
                       int E, int k, int vec, float scale, float* vals,
                       int* idx, float* part, float* aux, float* asum,
                       int warps, int blocks, cudaStream_t s) {
  constexpr int MAXT = V <= 8 ? 1024 : 256;
  const int smem = smem_bytes(warps, 32 / LPT, LPT * V, k);
  if (warps < 1 || warps * 32 > MAXT || blocks < 1 || smem > SMEM_MAX ||
      (blocks > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  gate_kernel<T, LPT, V, MAXT><<<blocks, warps * 32, smem, s>>>(
      logits, row_stride, n_tok, E, k, vec, scale, vals, idx, part, aux,
      asum);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* lg, long long row_stride, int n_tok, int E,
                   int k, float scale, float* vals, int* idx, float* part,
                   float* aux, float* asum, int warps, int blocks,
                   cudaStream_t s) {
  const T* logits = static_cast<const T*>(lg);
  constexpr int PER = 16 / sizeof(T);
  const int vec = reinterpret_cast<uintptr_t>(lg) % 16 == 0 &&
                  (row_stride * (long long)sizeof(T)) % 16 == 0 &&
                  E % PER == 0;
#define GATE_CASE(EMAX, LPT, V)                                             \
  if (E <= EMAX)                                                            \
    return launch_cfg<T, LPT, V>(logits, row_stride, n_tok, E, k, vec,     \
                                 scale, vals, idx, part, aux, asum, warps, \
                                 blocks, s);
  GATE_CASE(8, 1, 8)
  GATE_CASE(16, 2, 8)
  GATE_CASE(32, 4, 8)
  GATE_CASE(64, 8, 8)
  GATE_CASE(128, 16, 8)
  GATE_CASE(256, 32, 8)
  GATE_CASE(512, 32, 16)
  GATE_CASE(1024, 32, 32)
#undef GATE_CASE
  return cudaErrorInvalidValue;
}

#include "moe_gating_bwd.cuh"

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  logits row t starts at
// t * row_stride elements; vals / idx (T, k) contiguous; aux one f32.
// warps and blocks from the wrapper's plan; part: (blocks, 2, LPT V) f32
// scratch when blocks > 1 (LPT V = E rounded up as in the dispatch
// above), else null.  scale = E / T^2.  asum (2, E) f32, or null: the
// per-expert assignment counts (what the backward reads), then the
// per-expert probability sums over the T tokens.  Returns
// cudaGetLastError().
extern "C" int moe_gating_launch(const void* logits, int dtype, int n_tok,
                                 int E, int k, long long row_stride,
                                 float scale, float* vals, int* idx,
                                 float* part, float* aux, float* asum,
                                 int warps, int blocks, void* stream) {
  if (n_tok <= 0) return cudaSuccess;
  if (E <= 0 || E > MAX_E || k <= 0 || k > E || row_stride < E)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, row_stride, n_tok, E, k, scale, vals, idx,
                         part, aux, asum, warps, blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, row_stride, n_tok, E, k, scale,
                                 vals, idx, part, aux, asum, warps, blocks,
                                 s);
  return cudaErrorInvalidValue;
}

// The backward (moe_gating_bwd.cuh): logits as the forward's (row t at t *
// row_stride elements, `dtype` 0 = float32 or 1 = bfloat16), the
// forward's idx (T, k) int32 and asum (E,) f32, the gradients dvals (T,
// k) f32 and daux (one f32 on the card); scale = E / T^2.  Writes
// dlogits (T, E) contiguous in `dtype`.
extern "C" int moe_gating_bwd_launch(const void* logits, int dtype, int n_tok,
                                     int E, int k, long long row_stride,
                                     const int* idx, const float* dvals,
                                     const float* daux, const float* asum,
                                     float scale, void* dlogits,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gate_bwd::launch<float>(static_cast<const float*>(logits),
                                   row_stride, n_tok, E, k, idx, dvals, daux,
                                   asum, scale, static_cast<float*>(dlogits),
                                   s);
  if (dtype == 1)
    return gate_bwd::launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, n_tok, E, k,
        idx, dvals, daux, asum, scale, static_cast<__nv_bfloat16*>(dlogits),
        s);
  return cudaErrorInvalidValue;
}
