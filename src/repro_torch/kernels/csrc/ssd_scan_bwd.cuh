// The backward of ssd_scan (included by ssd_scan.cu).
//
// The TPU package differentiates its scan with jax.grad; there is no
// Pallas backward.  Given x, dt, A, B, C of the forward (no h0: training
// starts from a zero state), the output's gradient dy (Bb, L, H, P) f32
// and optionally the final state's dh (Bb, H, P, N), it forms dx, ddt,
// dA (H,), dB and dC (Bb, L, N).  The recurrence h_t = exp(dt_t A) h_{t-1}
// + dt_t x_t B_t^T, y_t = C_t . h_t is evaluated in chunks of Q = 64
// (its own chunking: any chunking is the same function), la = cumsum(dt
// A) inside a chunk, h_in / h_out the state entering / leaving it and
// dh_out the gradient of h_out:
//   h_out   = exp(la_Q) h_in + sum_j exp(la_Q - la_j) dt_j x_j B_j^T
//   dh_in   = exp(la_Q) dh_out + sum_i exp(la_i) dy_i C_i^T   (= dh_out of
//             the chunk before)
//   W_ij    = exp(la_i - la_j) dt_j (dy_i . x_j), j <= i
//   dx_j    = dt_j sum_i (C_i . B_j) exp(la_i - la_j) dy_i
//             + exp(la_Q - la_j) dt_j dh_out B_j
//   dB_j    = sum_i W_ij C_i + exp(la_Q - la_j) dt_j dh_out^T x_j
//   dC_i    = sum_j W_ij B_j + exp(la_i) h_in^T dy_i
//   ddt_j  += sum_i (C_i . B_j) exp(la_i - la_j) (dy_i . x_j)
//             + exp(la_Q - la_j) x_j^T dh_out B_j
//   dla, the gradient of la, then ddt_s += A R_s and dA += dt_s R_s with
//   R_s = sum_{t >= s} dla_t (the cumsum's transpose).
// B and C are shared by the heads, so their gradients are summed over H,
// in head order.  Four launches, all f32 on CUDA cores (block_mm):
//  * ssd_bwd_pass_kernel (rev false), grid (H, Bb, state tiles): one
//    block carries a tile of h_in across the chunks in order and writes
//    the state entering every chunk and the final one;
//  * ssd_bwd_pass_kernel (rev true): the same in reverse for dh_out,
//    writing dh_out of every chunk and <dh_out, h_out> (la_Q's gradient);
//  * ssd_bwd_chunk_kernel, grid (H, chunks, Bb): every chunk's dx and
//    ddt, dA's part, and this head's share of dB and dC into f32
//    scratch;
//  * ssd_bwd_reduce_kernel: dB and dC summed over the heads, dA over the
//    batches and chunks, in a fixed order.
// No atomics: the same bits on every run.
//
// What bounds it on an H100: bytes.  Per (batch, chunk, head) the
// function needs dy x^T, dx, dB and dC over the chunk's causal pairs and
// six (chunk x P x N) products with the states (the two passes, dC's and
// C h_in's with the state entering the chunk, dx's and dB's with the
// gradient leaving it), C B^T once for all heads: at mamba2-1.3b's
// training shape (Bb=8, L=1024, H=64, P=64, N=128) about 61 GFLOP a
// layer, 0.062 ms at the bf16 tensor-core rate, against 0.28 GB of
// operands and gradients, 0.084 ms at 3.35 TB/s.  On CUDA cores (67
// TFLOP/s peak) this first kernel is far from either; tensor-core
// products are later work.
#pragma once

#include "block_mm.cuh"

namespace ssd_bwd {

constexpr int Q = 64;               // chunk of the backward
constexpr int THREADS = 256;
constexpr int PER = 32;             // state values a thread carries
constexpr int TILE = THREADS * PER; // state values a pass block carries
constexpr int SMEM_MAX = 232448;

// floats of shared memory of the chunk kernel: x, dy, dx, a (Q, P) scratch;
// B, C; a (P, N) state; three (Q, Q) products; four vectors
__host__ __device__ inline long long smem_chunk(int P, int N) {
  return 4LL * Q * (P + 1) + 2LL * Q * (N + 1) + (long long)P * (N + 1) +
         3LL * Q * (Q + 1) + 4 * Q;
}

__host__ __device__ inline long long smem_pass(int P, int N) {
  return (long long)Q * (P + N) + 2 * Q + THREADS;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ dhf, const float* __restrict__ hs,
                    float* __restrict__ out, float* __restrict__ dlaq,
                    bool rev, int L, int H, int P, int N, int nb,
                    long long xsb, long long xsl, long long dsb,
                    long long dsl, long long bsb, long long bsl,
                    long long csb, long long csl) {
  extern __shared__ __align__(16) float sm[];
  float* us = sm;               // (Q, P): x or dy
  float* vs = us + Q * P;       // (Q, N): B or C
  float* ws = vs + Q * N;       // (Q,): dt, then the weights
  float* las = ws + Q;
  float* red = las + Q;
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const long long PN = (long long)P * N;
  const long long e0 = (long long)z * TILE + threadIdx.x;
  const float a = A[h];
  float st[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const long long e = e0 + (long long)r * THREADS;
    st[r] = rev && dhf != nullptr && e < PN
                ? dhf[((long long)b * H + h) * PN + e] : 0.f;
  }
  const int ns = rev ? nb : nb + 1;   // states stored a (batch, head)
  for (int ci = 0; ci < nb; ++ci) {
    const int c = rev ? nb - 1 - ci : ci;
    const int t0 = c * Q, nt = min(Q, L - t0);
    float* o = out + (((long long)b * ns + c) * H + h) * PN;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const long long e = e0 + (long long)r * THREADS;
      if (e < PN) o[e] = st[r];
    }
    if (rev) {   // <dh_out, h_out> of this tile, h_out = the next h_in
      const float* ho = hs + (((long long)b * (nb + 1) + c + 1) * H + h) * PN;
      float d = 0.f;
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const long long e = e0 + (long long)r * THREADS;
        if (e < PN) d = fmaf(st[r], ho[e], d);
      }
      d = block_sum(d, red);
      if (threadIdx.x == 0)
        dlaq[(((long long)b * H + h) * nb + c) * gridDim.z + z] = d;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
      const int r = e / P, p = e - r * P;
      const long long t = t0 + r;
      us[e] = r >= nt ? 0.f
              : rev ? dy[(((long long)b * L + t) * H + h) * P + p]
                    : ld_f32(x[b * xsb + t * xsl + (long long)h * P + p]);
    }
    for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
      const int r = e / N, n = e - r * N;
      const long long t = t0 + r;
      vs[e] = r >= nt ? 0.f
              : rev ? ld_f32(Cm[b * csb + t * csl + n])
                    : ld_f32(Bm[b * bsb + t * bsl + n]);
    }
    for (int r = threadIdx.x; r < Q; r += blockDim.x)
      ws[r] = r < nt ? dt[b * dsb + (long long)(t0 + r) * dsl + h] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int r = 0; r < Q; ++r) {
        acc += ws[r] * a;
        las[r] = acc;
      }
    }
    __syncthreads();
    const float lq = las[Q - 1];
    for (int r = threadIdx.x; r < Q; r += blockDim.x)
      ws[r] = r >= nt ? 0.f : rev ? expf(las[r]) : expf(lq - las[r]) * ws[r];
    __syncthreads();
    const float decay = expf(lq);
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const long long e = e0 + (long long)r * THREADS;
      if (e < PN) {
        const int p = (int)(e / N), n = (int)(e - (long long)p * N);
        float s = st[r] * decay;
        for (int j = 0; j < Q; ++j) s = fmaf(ws[j] * us[j * P + p], vs[j * N + n], s);
        st[r] = s;
      }
    }
    __syncthreads();
  }
  if (!rev) {
    float* o = out + (((long long)b * ns + nb) * H + h) * PN;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const long long e = e0 + (long long)r * THREADS;
      if (e < PN) o[e] = st[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ hs, const float* __restrict__ dhs,
                     const float* __restrict__ dlaq, int nz,
                     T* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dbp, float* __restrict__ dcp,
                     float* __restrict__ dap, int L, int H, int P, int N,
                     int nb, long long xsb, long long xsl, long long dsb,
                     long long dsl, long long bsb, long long bsl,
                     long long csb, long long csl) {
  extern __shared__ __align__(16) float sm[];
  const int LP = P + 1, LN = N + 1, LQ = Q + 1;
  float* xs = sm;
  float* dys = xs + Q * LP;
  float* dxs = dys + Q * LP;
  float* ys = dxs + Q * LP;
  float* bs = ys + Q * LP;
  float* cs = bs + Q * LN;
  float* hb = cs + Q * LN;          // h_in, then dh_out
  float* S1 = hb + P * LN;          // (C_i . B_j) exp(la_i - la_j), j <= i
  float* S2 = S1 + Q * LQ;          // W
  float* S3 = S2 + Q * LQ;          // S1 (dy_i . x_j)
  float* dts = S3 + Q * LQ;
  float* las = dts + Q;
  float* dla = las + Q;
  float* dds = dla + Q;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, nt = min(Q, L - t0);
  const float a = A[h];
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int r = e / P, p = e - r * P;
    const long long t = t0 + r;
    const bool in = r < nt;
    xs[r * LP + p] = in ? ld_f32(x[b * xsb + t * xsl + (long long)h * P + p])
                        : 0.f;
    dys[r * LP + p] = in ? dy[(((long long)b * L + t) * H + h) * P + p] : 0.f;
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int r = e / N, n = e - r * N;
    const long long t = t0 + r;
    const bool in = r < nt;
    bs[r * LN + n] = in ? ld_f32(Bm[b * bsb + t * bsl + n]) : 0.f;
    cs[r * LN + n] = in ? ld_f32(Cm[b * csb + t * csl + n]) : 0.f;
  }
  for (int r = threadIdx.x; r < Q; r += blockDim.x) {
    dts[r] = r < nt ? dt[b * dsb + (long long)(t0 + r) * dsl + h] : 0.f;
    dla[r] = 0.f;
    dds[r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < Q; ++r) {
      acc += dts[r] * a;
      las[r] = acc;
    }
  }
  __syncthreads();
  const float lq = las[Q - 1];
  auto head = [&](float* base, int i, int n) -> float& {
    return base[(((long long)b * L + t0 + i) * H + h) * N + n];
  };

  // the chunk's own products
  block_mm<4, 4>(Q, Q, N, cs, LN, 1, bs, 1, LN, [&](int i, int j, float v) {
    S1[i * LQ + j] = j <= i ? v * expf(las[i] - las[j]) : 0.f;
  });
  __syncthreads();
  block_mm<4, 4>(Q, Q, P, dys, LP, 1, xs, 1, LP, [&](int i, int j, float g) {
    S2[i * LQ + j] = j <= i ? expf(las[i] - las[j]) * dts[j] * g : 0.f;
    S3[i * LQ + j] = S1[i * LQ + j] * g;
  });
  __syncthreads();
  for (int r = threadIdx.x; r < Q; r += blockDim.x) {
    float col = 0.f, row = 0.f;
    for (int u = 0; u < Q; ++u) {
      col += S3[u * LQ + r];
      row = fmaf(S3[r * LQ + u], dts[u], row);
    }
    dds[r] = col;
    dla[r] = row - dts[r] * col;
  }
  block_mm<4, 4>(Q, P, Q, S1, 1, LQ, dys, LP, 1, [&](int j, int p, float v) {
    dxs[j * LP + p] = dts[j] * v;
  });
  block_mm<4, 4>(Q, N, Q, S2, 1, LQ, cs, LN, 1, [&](int j, int n, float v) {
    if (j < nt) head(dbp, j, n) = v;
  });
  block_mm<4, 4>(Q, N, Q, S2, LQ, 1, bs, LN, 1, [&](int i, int n, float v) {
    if (i < nt) head(dcp, i, n) = v;
  });
  __syncthreads();

  // the state entering the chunk
  const long long PN = (long long)P * N;
  const float* hin = hs + (((long long)b * (nb + 1) + c) * H + h) * PN;
  for (int e = threadIdx.x; e < P * N; e += blockDim.x) {
    const int p = e / N, n = e - p * N;
    hb[p * LN + n] = hin[e];
  }
  __syncthreads();
  block_mm<4, 4>(Q, N, P, dys, LP, 1, hb, LN, 1, [&](int i, int n, float v) {
    if (i < nt) head(dcp, i, n) += expf(las[i]) * v;
  });
  block_mm<4, 4>(Q, P, N, cs, LN, 1, hb, 1, LN, [&](int i, int p, float v) {
    ys[i * LP + p] = v;
  });
  __syncthreads();
  for (int r = threadIdx.x; r < Q; r += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = fmaf(dys[r * LP + p], ys[r * LP + p], s);
    dla[r] += expf(las[r]) * s;
  }
  __syncthreads();

  // the gradient of the state leaving it
  const float* dho = dhs + (((long long)b * nb + c) * H + h) * PN;
  for (int e = threadIdx.x; e < P * N; e += blockDim.x) {
    const int p = e / N, n = e - p * N;
    hb[p * LN + n] = dho[e];
  }
  __syncthreads();
  block_mm<4, 4>(Q, P, N, bs, LN, 1, hb, 1, LN, [&](int j, int p, float v) {
    ys[j * LP + p] = v;
  });
  block_mm<4, 4>(Q, N, P, xs, LP, 1, hb, LN, 1, [&](int j, int n, float v) {
    if (j < nt) head(dbp, j, n) += expf(lq - las[j]) * dts[j] * v;
  });
  __syncthreads();
  for (int r = threadIdx.x; r < Q; r += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = fmaf(xs[r * LP + p], ys[r * LP + p], s);
    const float V = expf(lq - las[r]) * s;
    dds[r] += V;
    dla[r] -= dts[r] * V;
  }
  for (int e = threadIdx.x; e < nt * P; e += blockDim.x) {
    const int j = e / P, p = e - j * P;
    st_f32(dx + (((long long)b * L + t0 + j) * H + h) * P + p,
           dxs[j * LP + p] + expf(lq - las[j]) * dts[j] * ys[j * LP + p]);
  }
  __syncthreads();

  // la's gradient to dt and A: the cumsum's transpose
  if (threadIdx.x == 0) {
    float dq = 0.f;
    for (int z = 0; z < nz; ++z)
      dq += dlaq[(((long long)b * H + h) * nb + c) * nz + z];
    dla[Q - 1] += dq;
    float R = 0.f, da = 0.f;
    for (int r = Q - 1; r >= 0; --r) {
      R += dla[r];
      dds[r] = fmaf(a, R, dds[r]);
      da = fmaf(dts[r], R, da);
    }
    dap[((long long)b * nb + c) * H + h] = da;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nt; r += blockDim.x)
    ddt[((long long)b * L + t0 + r) * H + h] = dds[r];
}

template <typename T>
__global__ void __launch_bounds__(128)
ssd_bwd_reduce_kernel(const float* __restrict__ dbp,
                      const float* __restrict__ dcp,
                      const float* __restrict__ dap, T* __restrict__ dB,
                      T* __restrict__ dC, float* __restrict__ dA, int Bb,
                      int L, int H, int N, int nb) {
  const long long row = blockIdx.x;          // (batch, position)
  if (row == (long long)Bb * L) {            // the last block: dA
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (long long bc = 0; bc < (long long)Bb * nb; ++bc) s += dap[bc * H + h];
      dA[h] = s;
    }
    return;
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += dbp[(row * H + h) * N + n];
      sc += dcp[(row * H + h) * N + n];
    }
    st_f32(dB + row * N + n, sb);
    st_f32(dC + row * N + n, sc);
  }
}

// scratch (f32): hs (Bb, nb + 1, H, P, N), dhs (Bb, nb, H, P, N), dlaq
// (Bb, H, nb, nz), dbp / dcp (Bb, L, H, N), dap (Bb, nb, H); nb = ceil(L /
// Q), nz = ceil(P N / TILE)
template <typename T>
cudaError_t launch(const T* x, const float* dt, const float* A, const T* Bm,
                   const T* Cm, const float* dy, const float* dhf, T* dx,
                   float* ddt, float* dA, T* dB, T* dC, float* hs, float* dhs,
                   float* dlaq, float* dbp, float* dcp, float* dap, int Bb,
                   int L, int H, int P, int N, long long xsb, long long xsl,
                   long long dsb, long long dsl, long long bsb, long long bsl,
                   long long csb, long long csl, cudaStream_t s) {
  const long long sc = 4 * smem_chunk(P, N), sp = 4 * smem_pass(P, N);
  if (sc > SMEM_MAX || sp > SMEM_MAX) return cudaErrorInvalidValue;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      ssd_bwd_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const int nb = (L + Q - 1) / Q;
  const int nz = (int)(((long long)P * N + TILE - 1) / TILE);
  const dim3 gp(H, Bb, nz);
  ssd_bwd_pass_kernel<T><<<gp, THREADS, (int)sp, s>>>(
      x, dy, Bm, Cm, dt, A, dhf, nullptr, hs, dlaq, false, L, H, P, N, nb,
      xsb, xsl, dsb, dsl, bsb, bsl, csb, csl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_pass_kernel<T><<<gp, THREADS, (int)sp, s>>>(
      x, dy, Bm, Cm, dt, A, dhf, hs, dhs, dlaq, true, L, H, P, N, nb, xsb,
      xsl, dsb, dsl, bsb, bsl, csb, csl);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<T><<<dim3(H, nb, Bb), THREADS, (int)sc, s>>>(
      x, dy, Bm, Cm, dt, A, hs, dhs, dlaq, nz, dx, ddt, dbp, dcp, dap, L, H,
      P, N, nb, xsb, xsl, dsb, dsl, bsb, bsl, csb, csl);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((long long)Bb * L + 1), 128, 0,
                             s>>>(dbp, dcp, dap, dB, dC, dA, Bb, L, H, N,
                                  nb);
  return cudaGetLastError();
}

}  // namespace ssd_bwd
