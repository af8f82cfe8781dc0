// Masked-cosine top-k over the routing catalog, fp32 and int8.
//
// Replaces the Pallas TPU kernels router_topk_pallas and
// router_topk_q8_pallas (src/repro/kernels/router_topk.py).  Same
// contract: score(q, n) = q . e[n] (int8: float(int32 dot) *
// (qscale[q] * escale[n])), plus bias[n] on rows the mask lets
// through, then the min_score floor; per query the k best
// (value desc, index asc) survive, empty slots come back (-inf, -1).
//
// What bounds it on an H100: the bytes of the catalog (N*D*4, or N*D
// for int8) plus the mask rows the queries read (one byte per query
// per catalog row), against ~2*Q*N*D flops.  At the route step's
// Q=256, N=100k, D=8 that is 3.2 MB of catalog and <= 25.6 MB of
// mask bytes -- memory bound.  The TPU kernel read a (Q, N) fp32
// mask; this one reads the stacked uint8 filter table (R, N) and a
// per-query row index, so the mask costs 1 byte per element and
// queries sharing a filter row hit the same lines in L2.
//
// Design (simple and right first):
//  * pass 1, grid (ceil(Q/8), S): a block of 8 warps takes 8 queries
//    and one catalog chunk.  The chunk streams through shared memory
//    in tiles of TILE rows (coalesced loads, odd row stride so the
//    lanes' reads hit distinct banks); each warp scores its query
//    against the tile, lane-strided, and every lane keeps a sorted
//    register top-KP.  A warp merge (k rounds of a shuffle argmax on
//    (value desc, index asc)) writes the chunk's top-k to scratch.
//  * pass 2: one warp per query merges the S partial lists the same
//    way.  Ties go to the lowest catalog index, as lax.top_k does.
//  * fp32 scores are computed with __fmul_rn/__fadd_rn in index order
//    (no FMA contraction), so the plain PyTorch version, which does
//    the same left-to-right sum, matches bit for bit.  int8 sums are
//    exact in int32.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 128;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <int KP>
struct TopK {
  float v[KP];
  int i[KP];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      v[j] = -CUDART_INF_F;
      i[j] = -1;
    }
  }

  // insert (x, ix) keeping (value desc, index asc) order; the
  // candidate bubbles down, swapping with every slot it beats
  __device__ __forceinline__ void push(float x, int ix) {
    if (!better(x, ix, v[KP - 1], i[KP - 1])) return;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (better(x, ix, v[j], i[j])) {
        float tv = v[j];
        int ti = i[j];
        v[j] = x;
        i[j] = ix;
        x = tv;
        ix = ti;
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < KP - 1; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[KP - 1] = -CUDART_INF_F;
    i[KP - 1] = -1;
  }
};

// k rounds: the warp's best head wins, its lane pops it.  Every finite
// (value, index) pair is held by exactly one lane, so the butterfly
// converges on one winner; empty slots come out as (-inf, -1).
template <int KP>
__device__ __forceinline__ void warp_merge(TopK<KP>& t, int k, float* out_v,
                                           int* out_i) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float bv = t.v[0];
    int bi = t.i[0];
    int bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (better(ov, oi, bv, bi) ||
          (ov == bv && oi == bi && ol < bl)) {
        bv = ov;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_v[r] = bv;
      out_i[r] = bi;
    }
    if (lane == bl) t.pop();
  }
}

template <int KP, bool Q8>
__global__ void __launch_bounds__(WARPS * 32)
topk_partial(const void* __restrict__ qv, const void* __restrict__ ev,
             const float* __restrict__ qscale,
             const float* __restrict__ escale,
             const uint8_t* __restrict__ mask_table,
             const int* __restrict__ rows, const float* __restrict__ bias,
             float min_score, int Q, int N, int D, int k, int chunk,
             float* __restrict__ pv, int* __restrict__ pi) {
  extern __shared__ float smem[];
  const int stride = D | 1;                       // odd: conflict-free
  float* tile_f = smem;                           // TILE x stride
  int* tile_i = reinterpret_cast<int*>(smem);
  float* qf = smem + TILE * stride;               // WARPS x D
  int* qi8 = reinterpret_cast<int*>(qf);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const bool active = q < Q;
  const int S = gridDim.y;
  const int n0 = blockIdx.y * chunk;
  const int n1 = min(N, n0 + chunk);

  if (active) {
    for (int d = lane; d < D; d += 32) {
      if (Q8)
        qi8[warp * D + d] =
            static_cast<const int8_t*>(qv)[(size_t)q * D + d];
      else
        qf[warp * D + d] = static_cast<const float*>(qv)[(size_t)q * D + d];
    }
  }
  const float qs = (Q8 && active) ? qscale[q] : 0.f;
  const uint8_t* mrow =
      active ? mask_table + (size_t)rows[q] * (size_t)N : nullptr;

  TopK<KP> t;
  t.init();
  for (int base = n0; base < n1; base += TILE) {
    const int rows_here = min(TILE, n1 - base);
    __syncthreads();
    for (int e = threadIdx.x; e < rows_here * D; e += blockDim.x) {
      const int r = e / D;
      const int d = e - r * D;
      const size_t g = (size_t)(base + r) * D + d;
      if (Q8)
        tile_i[r * stride + d] = static_cast<const int8_t*>(ev)[g];
      else
        tile_f[r * stride + d] = static_cast<const float*>(ev)[g];
    }
    __syncthreads();
    if (!active) continue;
    for (int r = lane; r < rows_here; r += 32) {
      const int n = base + r;
      if (!mrow[n]) continue;
      float s;
      if (Q8) {
        int acc = 0;
        for (int d = 0; d < D; ++d)
          acc += qi8[warp * D + d] * tile_i[r * stride + d];
        s = __fmul_rn(static_cast<float>(acc), __fmul_rn(qs, escale[n]));
      } else {
        float acc = 0.f;
        for (int d = 0; d < D; ++d)
          acc = __fadd_rn(acc, __fmul_rn(qf[warp * D + d],
                                         tile_f[r * stride + d]));
        s = acc;
      }
      if (bias != nullptr) s = __fadd_rn(s, bias[n]);
      if (!(s >= min_score)) continue;
      t.push(s, n);
    }
  }
  if (!active) return;
  const size_t off = ((size_t)q * S + blockIdx.y) * k;
  warp_merge<KP>(t, k, pv + off, pi + off);
}

template <int KP>
__global__ void __launch_bounds__(WARPS * 32)
topk_merge(const float* __restrict__ pv, const int* __restrict__ pi, int Q,
           int S, int k, float* __restrict__ vals, int* __restrict__ idx) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= Q) return;                   // whole warp leaves together
  TopK<KP> t;
  t.init();
  const size_t base = (size_t)q * S * k;
  for (int e = lane; e < S * k; e += 32) {
    const float v = pv[base + e];
    if (v > -CUDART_INF_F) t.push(v, pi[base + e]);
  }
  warp_merge<KP>(t, k, vals + (size_t)q * k, idx + (size_t)q * k);
}

template <int KP, bool Q8>
cudaError_t launch(const void* q, const void* e, const float* qscale,
                   const float* escale, const uint8_t* mask_table,
                   const int* rows, const float* bias, float min_score,
                   int Q, int N, int D, int k, int chunk, float* pv, int* pi,
                   float* vals, int* idx, cudaStream_t stream) {
  const int S = (N + chunk - 1) / chunk;
  const int qblocks = (Q + WARPS - 1) / WARPS;
  if (S > 0) {
    const size_t smem = sizeof(float) * ((size_t)TILE * (D | 1) + WARPS * D);
    topk_partial<KP, Q8><<<dim3(qblocks, S), WARPS * 32, smem, stream>>>(
        q, e, qscale, escale, mask_table, rows, bias, min_score, Q, N, D, k,
        chunk, pv, pi);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  topk_merge<KP><<<qblocks, WARPS * 32, 0, stream>>>(pv, pi, Q, S, k, vals,
                                                     idx);
  return cudaGetLastError();
}

template <bool Q8>
cudaError_t dispatch(const void* q, const void* e, const float* qscale,
                     const float* escale, const uint8_t* mask_table,
                     const int* rows, const float* bias, float min_score,
                     int Q, int N, int D, int k, int chunk, float* pv,
                     int* pi, float* vals, int* idx, cudaStream_t stream) {
#define RT_CASE(KP)                                                         \
  if (k <= KP)                                                              \
    return launch<KP, Q8>(q, e, qscale, escale, mask_table, rows, bias,    \
                          min_score, Q, N, D, k, chunk, pv, pi, vals, idx, \
                          stream);
  RT_CASE(1)
  RT_CASE(2)
  RT_CASE(4)
  RT_CASE(8)
  RT_CASE(16)
  RT_CASE(32)
#undef RT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (bound with ctypes).  q (Q, D) f32 or int8; e (N, D)
// f32 or int8; qscale (Q,) / escale (N,) f32 (int8 only, else NULL);
// mask_table (R, N) uint8; rows (Q,) int32 row of the table per query;
// bias (N,) f32 or NULL; pv/pi (Q, S, k) scratch with
// S = ceil(N / chunk); vals/idx (Q, k).  Returns cudaGetLastError().
extern "C" int router_topk_launch(const void* q, const void* e,
                                  const float* qscale, const float* escale,
                                  const uint8_t* mask_table, const int* rows,
                                  const float* bias, float min_score, int Q,
                                  int N, int D, int k, int chunk, int quant,
                                  float* pv, int* pi, float* vals, int* idx,
                                  void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (k < 1 || k > 32 || D < 1 || D > 64 || chunk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return dispatch<true>(q, e, qscale, escale, mask_table, rows, bias,
                          min_score, Q, N, D, k, chunk, pv, pi, vals, idx, s);
  return dispatch<false>(q, e, qscale, escale, mask_table, rows, bias,
                         min_score, Q, N, D, k, chunk, pv, pi, vals, idx, s);
}
