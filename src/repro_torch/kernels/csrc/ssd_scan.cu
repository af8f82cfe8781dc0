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
// split of its projection gives them; all arithmetic is f32.
//
// What bounds it on an H100: at the mamba2-1.3b prefill (Bb=16, L=512,
// H=64, P=64, N=128, chunk 256) the products come to ~26 GFLOP against
// ~0.34 GB of inputs and outputs, so operations: f32 operations on the
// CUDA cores in this version.
//
// Design (simple and right first, then the shared-memory reads cut):
//  * pass 1, grid (ceil(chunk/32), chunks, Bb): G = C B^T, the raw
//    intra-chunk scores, once per (batch, chunk) into an f32 scratch
//    (8 MB at the shape above, L2-resident): B and C are shared by the
//    heads, so no head recomputes the 128-deep products.
//  * pass 2, grid (H, Bb): one block per (batch, head) walks the chunks
//    in order -- the TPU kernel's sequential chunk axis becomes a loop
//    inside the block.  The (P, N) f32 state stays in shared memory
//    for the whole sequence (33 KB at P=64, N=128).
//  * the TPU kernel formed the (c, c) C B^T and decay matrices whole:
//    256 KB each at chunk 256, above the 227 KB a block can hold.  Here
//    the chunk's outputs are made 32 query rows at a time against the
//    causal key prefix, 32 keys at a time: a head's 32 x 32 score tile
//    is G times its decay, loaded elementwise, so shared memory holds
//    only 32-row tiles (~90 KB in all, two blocks per SM).
//  * every product runs through one register-tiled helper: each thread
//    a 4 x RN tile whose A operand comes as float4 (four k of a row, or
//    four rows of a k) broadcast to the warp, and whose B operand is
//    read by consecutive lanes (odd row stride where lanes walk rows),
//    so no read conflicts on shared-memory banks.
//  * the exponent is masked before exp (j > i never enters exp), as the
//    TPU kernel does; the log-decay cumsum is a warp scan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHR = 256;
constexpr int NWARP = NTHR / 32;
constexpr int TQ = 32;       // query rows per output tile
constexpr int TK = 32;       // keys per tile
constexpr int RM = TQ / NWARP;
constexpr int SS = TK + 4;   // score-tile row stride (16-byte rows)
constexpr int SMEM_OPTIN = 232448;  // dynamic shared memory a block may use

static_assert(RM == 4, "the float4 A operand covers four rows");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

// acc[r][c] += sum_k A(m, k) * B(n, k) for this thread's rows
// m = m0 + 4*warp + r and columns n = n0 + lane + 32*c; columns past Nn
// (and a row group past M) read row 0 and are dropped by the caller.
// KMAJOR: A(m, k) = A[m*lda + k], read as float4 over four k (K % 4 == 0,
// rows 16-byte aligned).  Otherwise A(m, k) = A[k*lda + m], read as
// float4 over the four rows.  B(n, k) = Bp[n*sbn + k*sbk], a scalar per
// lane.
template <bool KMAJOR, int RN>
__device__ __forceinline__ void mm(float (&acc)[4][RN], const float* A,
                                   int lda, const float* Bp, int sbn,
                                   int sbk, int K, int m0, int M, int n0,
                                   int Nn) {
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  int mb = m0 + 4 * w;
  if (mb + 3 >= M) mb = 0;
  const float* br[RN];
#pragma unroll
  for (int c = 0; c < RN; ++c) {
    const int n = n0 + ln + 32 * c;
    br[c] = Bp + (n < Nn ? n : 0) * sbn;
  }
  if (KMAJOR) {
    const float* ar = A + mb * lda;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(ar + r * lda + k);
      float b[4][RN];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < RN; ++c) b[kk][c] = br[c][(k + kk) * sbk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          acc[r][c] = fmaf(a[r].x, b[0][c], acc[r][c]);
          acc[r][c] = fmaf(a[r].y, b[1][c], acc[r][c]);
          acc[r][c] = fmaf(a[r].z, b[2][c], acc[r][c]);
          acc[r][c] = fmaf(a[r].w, b[3][c], acc[r][c]);
        }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(A + k * lda + mb);
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const float b = br[c][k * sbk];
        acc[0][c] = fmaf(a.x, b, acc[0][c]);
        acc[1][c] = fmaf(a.y, b, acc[1][c]);
        acc[2][c] = fmaf(a.z, b, acc[2][c]);
        acc[3][c] = fmaf(a.w, b, acc[3][c]);
      }
    }
  }
}

template <int RN>
__device__ __forceinline__ void zero(float (&acc)[4][RN]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
}

// rows [j0, j0 + nk) of a (., width) operand into a tile with row
// stride ld; rows past nk are zero.  scale (optional) multiplies row j.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long srow, int j0, int nk,
                                          int rows, int width,
                                          const float* scale) {
  for (int e = threadIdx.x; e < rows * width; e += NTHR) {
    const int j = e / width, n = e - j * width;
    float val = 0.f;
    if (j < nk) {
      val = to_f(src[(long long)(j0 + j) * srow + n]);
      if (scale) val *= scale[j0 + j];
    }
    dst[j * ld + n] = val;
  }
}

// ---------------------------------------------------------------------
// pass 1: G[b, chunk, i, j] = C_i . B_j for j < (end of i's row tile)
// ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NTHR)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
          float* __restrict__ G, int L, int N, int chunk, int nc,
          long long bsb, long long bsl, long long csb, long long csl) {
  extern __shared__ float sm[];
  const int i0 = blockIdx.x * TQ, ci = blockIdx.y, b = blockIdx.z;
  const int c0 = ci * chunk;
  const int cl = min(chunk, L - c0);
  if (i0 >= cl) return;
  const int nq = min(TQ, cl - i0);
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  float* cs = sm;                        // TQ x N   C rows (16-byte rows)
  float* bs = cs + TQ * N;               // TK x N+1 B rows
  const T* cb = Cm + b * csb + (long long)c0 * csl;
  const T* bb = Bm + b * bsb + (long long)c0 * bsl;
  float* g = G + ((long long)b * nc + ci) * chunk * chunk;
  load_rows(cs, N, cb, csl, i0, nq, TQ, N, (const float*)nullptr);
  for (int j0 = 0; j0 < i0 + nq; j0 += TK) {
    const int nk = min(TK, cl - j0);
    __syncthreads();
    load_rows(bs, N + 1, bb, bsl, j0, nk, TK, N, (const float*)nullptr);
    __syncthreads();
    float acc[4][1];
    zero(acc);
    mm<true, 1>(acc, cs, N, bs, N + 1, 1, N, 0, TQ, 0, TK);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * w + r;
      if (i < nq && ln < nk)
        g[(long long)(i0 + i) * chunk + j0 + ln] = acc[r][0];
    }
  }
}

// ---------------------------------------------------------------------
// pass 2: the scan, one block per (batch, head)
// ---------------------------------------------------------------------

struct Layout {
  int hs, cs, bs, xs, ss, ys, la, dts, wj, total;   // float offsets
  __host__ __device__ Layout(int P, int N, int chunk) {
    int o = 0;
    hs = o; o += up4(P * (N + 1));       // P x N+1  state
    cs = o; o += up4(TQ * N);            // TQ x N   C rows
    bs = o; o += up4(TK * N);            // TK x N   B rows (state update)
    xs = o; o += up4(TK * P);            // TK x P   x rows
    ss = o; o += up4(TQ * SS);           // TQ x SS  masked decayed scores
    ys = o; o += up4(TQ * P);            // TQ x P   output tile
    la = o; o += up4(chunk);             // log-decay cumsum
    dts = o; o += up4(chunk);            // dt
    wj = o; o += up4(chunk);             // exp(la_last - la) dt
    total = o;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHR)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           const float* __restrict__ G, float* __restrict__ y,
           float* __restrict__ hf, int L, int H, int P, int N, int chunk,
           int nc, long long xsb, long long xsl, long long dsb,
           long long dsl, long long bsb, long long bsl, long long csb,
           long long csl) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, w = t >> 5, ln = t & 31;
  const Layout lay(P, N, chunk);
  const int ldh = N + 1;                 // odd row stride for even N
  float* hs = sm + lay.hs;
  float* cs = sm + lay.cs;
  float* bs = sm + lay.bs;
  float* xs = sm + lay.xs;
  float* ss = sm + lay.ss;
  float* ys = sm + lay.ys;
  float* la = sm + lay.la;
  float* dts = sm + lay.dts;
  float* wj = sm + lay.wj;

  const long long hoff = ((long long)b * H + h) * P * N;
  for (int e = t; e < P * N; e += NTHR) {
    const int p = e / N, n = e - p * N;
    hs[p * ldh + n] = h0 ? h0[hoff + e] : 0.f;
  }
  const float a = A[h];
  const T* xb = x + b * xsb + (long long)h * P;
  const T* bb = Bm + b * bsb;
  const T* cb = Cm + b * csb;
  const float* db = dt + b * dsb + h;

  for (int c0 = 0, ci = 0; c0 < L; c0 += chunk, ++ci) {
    const int cl = min(chunk, L - c0);
    const float* g = G + ((long long)b * nc + ci) * chunk * chunk;
    __syncthreads();
    for (int i = t; i < cl; i += NTHR) dts[i] = db[(long long)(c0 + i) * dsl];
    __syncthreads();
    if (w == 0) {                         // inclusive cumsum of dt * a
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
    __syncthreads();
    const float lal = la[cl - 1];
    for (int i = t; i < cl; i += NTHR) wj[i] = expf(lal - la[i]) * dts[i];

    // ---- outputs, TQ rows at a time
    for (int i0 = 0; i0 < cl; i0 += TQ) {
      const int nq = min(TQ, cl - i0);
      __syncthreads();
      load_rows(cs, N, cb + (long long)c0 * csl, csl, i0, nq, TQ, N,
                (const float*)nullptr);
      __syncthreads();
      // inter-chunk: y_i = exp(la_i) C_i . h
      for (int p0 = 0; p0 < P; p0 += 64) {
        float acc[4][2];
        zero(acc);
        mm<true, 2>(acc, cs, N, hs, ldh, 1, N, 0, TQ, p0, P);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * w + r;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int p = p0 + ln + 32 * c;
            if (p < P) ys[i * P + p] = i < nq ? expf(la[i0 + i]) * acc[r][c]
                                              : 0.f;
          }
        }
      }
      // intra-chunk, over the causal key prefix [0, i0 + nq)
      for (int j0 = 0; j0 < i0 + nq; j0 += TK) {
        const int nk = min(TK, cl - j0);
        __syncthreads();
        load_rows(xs, P, xb + (long long)c0 * xsl, xsl, j0, nk, TK, P,
                  (const float*)nullptr);
        for (int e = t; e < TQ * TK; e += NTHR) {
          const int i = e / TK, j = e - i * TK;
          const int gi = i0 + i, gj = j0 + j;
          float s = 0.f;
          // mask the exponent before exp: j > i never enters it
          if (i < nq && j < nk && gj <= gi)
            s = g[(long long)gi * chunk + gj] * expf(la[gi] - la[gj]) *
                dts[gj];
          ss[i * SS + j] = s;
        }
        __syncthreads();
        for (int p0 = 0; p0 < P; p0 += 64) {
          float acc[4][2];
          zero(acc);
          mm<true, 2>(acc, ss, SS, xs, 1, P, TK, 0, TQ, p0, P);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 4 * w + r;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int p = p0 + ln + 32 * c;
              if (p < P) ys[i * P + p] += acc[r][c];
            }
          }
        }
      }
      __syncthreads();
      for (int e = t; e < nq * P; e += NTHR) {
        const int i = e / P, p = e - i * P;
        y[(((long long)b * L + c0 + i0 + i) * H + h) * P + p] = ys[e];
      }
    }

    // ---- state: h = exp(la_last) h + sum_j (wj_j x_j) B_j^T
    __syncthreads();
    const float decay = expf(lal);
    for (int e = t; e < P * N; e += NTHR) {
      const int p = e / N, n = e - p * N;
      hs[p * ldh + n] *= decay;
    }
    for (int j0 = 0; j0 < cl; j0 += TK) {
      const int nk = min(TK, cl - j0);
      __syncthreads();
      load_rows(bs, N, bb + (long long)c0 * bsl, bsl, j0, nk, TK, N,
                (const float*)nullptr);
      load_rows(xs, P, xb + (long long)c0 * xsl, xsl, j0, nk, TK, P, wj);
      __syncthreads();
      for (int p0 = 0; p0 < P; p0 += TQ) {
        for (int n0 = 0; n0 < N; n0 += 128) {
          float acc[4][4];
          zero(acc);
          mm<false, 4>(acc, xs, P, bs, 1, N, TK, p0, P, n0, N);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = p0 + 4 * w + r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = n0 + ln + 32 * c;
              if (p < P && n < N) hs[p * ldh + n] += acc[r][c];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = t; e < P * N; e += NTHR) {
    const int p = e / N, n = e - p * N;
    hf[hoff + e] = hs[p * ldh + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0,
                   float* G, float* y, float* hf, int Bb, int L, int H,
                   int P, int N, int chunk, long long xsb, long long xsl,
                   long long dsb, long long dsl, long long bsb,
                   long long bsl, long long csb, long long csl,
                   cudaStream_t s) {
  // opt in once, to the most a block may have: no attribute call on
  // later launches (those may be under CUDA-graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_OPTIN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_OPTIN);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const size_t smem = sizeof(float) * (size_t)Layout(P, N, chunk).total;
  const size_t cb_smem = sizeof(float) * ((size_t)TQ * N + TK * (N + 1));
  if (smem > (size_t)SMEM_OPTIN || cb_smem > (size_t)SMEM_OPTIN)
    return cudaErrorInvalidValue;
  const int nc = (L + chunk - 1) / chunk;
  const T* bp = static_cast<const T*>(Bm);
  const T* cp = static_cast<const T*>(Cm);
  if (nc > 0) {
    dim3 g1((chunk + TQ - 1) / TQ, nc, Bb);
    cb_kernel<T><<<g1, NTHR, cb_smem, s>>>(bp, cp, G, L, N, chunk, nc, bsb,
                                           bsl, csb, csl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 g2(H, Bb);
  ssd_kernel<T><<<g2, NTHR, smem, s>>>(
      static_cast<const T*>(x), dt, A, bp, cp, h0, G, y, hf, L, H, P, N,
      chunk, nc, xsb, xsl, dsb, dsl, bsb, bsl, csb, csl);
  return cudaGetLastError();
}

}  // namespace

// Shared memory the scan's block needs, in bytes (the wrapper checks it
// against the card's limit before it launches).
extern "C" long long ssd_scan_smem(int P, int N, int chunk) {
  return (long long)sizeof(float) * Layout(P, N, chunk).total;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C); dt, A, h0, y, hf are f32.
// G: f32 scratch of Bb * ceil(L / chunk) * chunk * chunk.  Strides in
// elements along (batch, position); x's head stride is P, the last axis
// of every operand is contiguous, and P, N are multiples of 4.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* A, const void* Bm,
                               const void* Cm, const float* h0, float* G,
                               float* y, float* hf, int dtype, int Bb,
                               int L, int H, int P, int N, int chunk,
                               long long xsb, long long xsl, long long dsb,
                               long long dsl, long long bsb, long long bsl,
                               long long csb, long long csl, void* stream) {
  if (Bb <= 0 || H <= 0) return cudaSuccess;
  if (P <= 0 || N <= 0 || P % 4 || N % 4 || chunk <= 0 || L < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, h0, G, y, hf, Bb, L, H, P, N,
                         chunk, xsb, xsl, dsb, dsl, bsb, bsl, csb, csl, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, G, y, hf, Bb, L, H,
                                 P, N, chunk, xsb, xsl, dsb, dsl, bsb, bsl,
                                 csb, csl, s);
  return cudaErrorInvalidValue;
}
