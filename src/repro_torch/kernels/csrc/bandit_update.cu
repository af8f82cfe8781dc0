// Batched linear-bandit posterior delta + LinUCB scores.
//
// Replaces the Pallas TPU kernel bandit_update_pallas
// (src/repro/kernels/bandit_update.py).  Same contract, with the rank-1
// structure flattened (P2 = D*D):
//   dA[n, p]  = sum_b w[b, n] * x[b, p / D] * x[b, p % D]
//   db[n, d]  = sum_b w[b, n] * (x[b, d] * r[b])
//   ucb[q, n] = xs[q] . theta[n]
//               + sqrt(max(sum_p xs[q, p/D] xs[q, p%D] * (alpha2 * Ainv[n, p]), 0))
// W is any (Bu, N) f32 matrix (the serving path's is one-hot).  The
// outer products are formed while staging, with the single rounding the
// plain PyTorch version uses; alpha^2 scales the exploration sum.
//
// What bounds it on an H100 (N=100k, Bu=Bs=256, D=9):
//  * the update half -- the serving path's only launch (Bs = 0) -- reads
//    the (Bu, N) mask and writes dA and db: 4 (Bu N + N D^2 + N D) bytes
//    plus the tiny x and r, ~138 MB, 41 us at 3.35 TB/s.  Its arithmetic
//    is 2 (D^2 + D) per non-zero of the mask: nothing.
//  * the score half reads theta, Ainv (36 MB) and writes the (Bs, N)
//    scores (102 MB), ~41 us, against 2 Bs N (D + D^2) = 4.6 GFLOP of
//    fp32 FMAs, 69 us at 67 TFLOP/s: operations.
//
// Design:
//  * update_kernel: a block owns a slab of UTN = 128 models and streams
//    the mask's rows through it, 8 warps on 8 rows at a time, each lane
//    4 models (one 16-byte load where N % 4 == 0, else 4 coalesced
//    scalar loads), UNLD = 8 rows' loads issued before any value is
//    tested.  A non-zero only sets its row's bit in its model's column
//    mask (shared memory, atomicOr: the set, not the order, is what is
//    recorded).  Then each model's thread walks its bits in row order
//    and adds that row's outer product and reward-weighted context into
//    its shared-memory dA / db row -- the same sums in the same order on
//    every run.  The slab's dA and db rows are contiguous in memory and
//    leave as 16-byte stores, zero rows included.  For a one-hot mask
//    the block does little but stream: ~0.7 non-zeros per slab.
//  * ucb_kernel: a block owns UTN = 128 models and copies their theta
//    and Ainv rows into shared memory as they lie (cp.async, every copy
//    in flight at once; odd row stride), then walks the queries UQ = 128
//    at a time, each staged feature-major as [xs | xs xs^T] (no integer
//    division in the loop).  A thread holds a 16 query x 4 model
//    register tile: per feature four broadcast 16-byte reads and four
//    conflict-free scalar reads feed 64 FMAs, so the FMA pipe, not
//    shared memory, is the limit.  One accumulator per score: the
//    exploration sum, alpha^2 times it, its square root, then the
//    mean's D terms added onto it.  Scores are stored coalesced along n.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 12;
constexpr int NTHR = 256;
constexpr int NWARP = NTHR / 32;
constexpr int UTN = 128;          // models per block, both kernels
constexpr int URT = 256;          // mask rows per pass, update kernel
constexpr int UWORDS = URT / 32;  // column-mask words per model
constexpr int UNLD = 8;           // rows in flight per thread
constexpr int UQ = 128;           // queries per pass, ucb kernel
constexpr int QPT = UQ / NWARP;   // queries per thread (16)
constexpr int MPT = UTN / 32;     // models per thread (4)
constexpr int SMEM_OPTIN = 232448;

static_assert(QPT % 4 == 0, "float4 reads cover a thread's queries");

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ size_t update_smem(int D) {
  return sizeof(float) * (size_t)(up4(UTN * D * D) + up4(UTN * D)) +
         sizeof(unsigned) * UTN * UWORDS;
}

__host__ __device__ __forceinline__ size_t ucb_smem(int D) {
  const int P = D + D * D;
  return sizeof(float) * ((size_t)up4(UTN * (P | 1)) + (size_t)P * UQ);
}

template <bool VEC>
__global__ void __launch_bounds__(NTHR)
update_kernel(const float* __restrict__ w, const float* __restrict__ x,
              const float* __restrict__ r, int Bu, int N, int D,
              float* __restrict__ dA, float* __restrict__ db) {
  extern __shared__ float sm[];
  const int P2 = D * D;
  float* sa = sm;                                  // UTN x P2, as dA rows
  float* sb = sa + up4(UTN * P2);                  // UTN x D, as db rows
  unsigned* bits = reinterpret_cast<unsigned*>(sb + up4(UTN * D));
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const int n0 = blockIdx.x * UTN;
  const int tn = min(UTN, N - n0);
  for (int e = t; e < UTN * P2; e += NTHR) sa[e] = 0.f;
  for (int e = t; e < UTN * D; e += NTHR) sb[e] = 0.f;
  // this lane's 4 models (slab-local): 4 lane .. 4 lane + 3 when
  // vectorised, else lane + 32 q
  auto col = [&](int q) { return VEC ? 4 * lane + q : lane + 32 * q; };

  for (int r0 = 0; r0 < Bu; r0 += URT) {
    const int nr = min(URT, Bu - r0);
    for (int e = t; e < UTN * UWORDS; e += NTHR) bits[e] = 0u;
    __syncthreads();
    for (int k0 = wp; k0 < nr; k0 += NWARP * UNLD) {
      float v[UNLD][4];
#pragma unroll
      for (int u = 0; u < UNLD; ++u) {
        const int rr = k0 + NWARP * u;
        const float* row = w + (size_t)(r0 + rr) * N + n0;
        if (VEC) {
          float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
          if (rr < nr && 4 * lane < tn)
            f = __ldcs(reinterpret_cast<const float4*>(row) + lane);
          v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[u][q] = rr < nr && col(q) < tn ? __ldcs(row + col(q)) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNLD; ++u) {
        const int rr = k0 + NWARP * u;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (v[u][q] != 0.f)
            atomicOr(&bits[col(q) * UWORDS + (rr >> 5)], 1u << (rr & 31));
      }
    }
    __syncthreads();
    if (t < tn) {                        // model n0 + t, rows in order
      float* ra = sa + t * P2;
      float* rb = sb + t * D;
      for (int wd = 0; wd < UWORDS; ++wd) {
        unsigned m = bits[t * UWORDS + wd];
        while (m) {
          const int b = r0 + 32 * wd + __ffs(m) - 1;
          m &= m - 1;
          const float wv = w[(size_t)b * N + n0 + t];
          const float* xb = x + (size_t)b * D;
          for (int p = 0; p < P2; ++p) ra[p] += wv * (xb[p / D] * xb[p % D]);
          const float rv = r[b];
          for (int d = 0; d < D; ++d) rb[d] += wv * (xb[d] * rv);
        }
      }
    }
    __syncthreads();
  }
  // the slab's dA rows, then its db rows: contiguous spans that start
  // on 16 bytes (n0 is a multiple of 128)
  const int na = tn * P2, nb = tn * D;
  float* ga = dA + (size_t)n0 * P2;
  float* gb = db + (size_t)n0 * D;
  for (int e = 4 * t; e + 3 < na; e += 4 * NTHR)
    __stcs(reinterpret_cast<float4*>(ga + e),
           *reinterpret_cast<const float4*>(sa + e));
  for (int e = (na & ~3) + t; e < na; e += NTHR) ga[e] = sa[e];
  for (int e = 4 * t; e + 3 < nb; e += 4 * NTHR)
    __stcs(reinterpret_cast<float4*>(gb + e),
           *reinterpret_cast<const float4*>(sb + e));
  for (int e = (nb & ~3) + t; e < nb; e += NTHR) gb[e] = sb[e];
}

// 4 bytes global -> shared; `full` false writes zeros
__device__ __forceinline__ void cp4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__global__ void __launch_bounds__(NTHR, 2)
ucb_kernel(const float* __restrict__ xs, const float* __restrict__ theta,
           const float* __restrict__ ainv, float alpha2, int Bs, int N,
           int D, float* __restrict__ ucb) {
  extern __shared__ float sm[];
  const int P2 = D * D;
  const int P = D + P2;
  const int ms_ = P | 1;                   // odd: lanes' rows on distinct banks
  float* ms = sm;                          // UTN x ms_: [theta | Ainv] rows
  float* qs = sm + up4(UTN * ms_);         // P x UQ: [xs | xs xs^T]
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const int n0 = blockIdx.x * UTN;
  const int tn = min(UTN, N - n0);
  // the block's model rows as they lie in memory (theta rows, then Ainv
  // rows, both contiguous over the block's models): every copy in flight
  // at once
  for (int e = t; e < UTN * D; e += NTHR) {
    const int nl = e / D;
    cp4(ms + nl * ms_ + (e - nl * D),
        nl < tn ? theta + (size_t)n0 * D + e : theta, nl < tn);
  }
  for (int e = t; e < UTN * P2; e += NTHR) {
    const int nl = e / P2;
    cp4(ms + nl * ms_ + D + (e - nl * P2),
        nl < tn ? ainv + (size_t)n0 * P2 + e : ainv, nl < tn);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int ql = t % UQ, grp = t / UQ;     // a query, a share of its rows
  for (int q0 = 0; q0 < Bs; q0 += UQ) {
    __syncthreads();                       // qs free
    {
      const int q = q0 + ql;
      const float* xq = xs + (size_t)min(q, Bs - 1) * D;
      const bool in = q < Bs;
      for (int a = grp; a < D; a += NTHR / UQ) {
        const float xa = in ? xq[a] : 0.f;
        qs[a * UQ + ql] = xa;
        for (int c = 0; c < D; ++c)
          qs[(D + a * D + c) * UQ + ql] = in ? xa * xq[c] : 0.f;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // a QPT query x MPT model tile: the exploration sum, alpha^2 times
    // it, its square root, then the mean's D terms added onto it
    float acc[QPT][MPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < MPT; ++j) acc[i][j] = 0.f;
    const float* qw = qs + QPT * wp;
    const float* ml = ms + lane * ms_;
#pragma unroll 3
    for (int p = D; p < P; ++p) {
      float a[QPT];
#pragma unroll
      for (int i = 0; i < QPT; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(qw + p * UQ + i);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const float m = ml[32 * j * ms_ + p];
#pragma unroll
        for (int i = 0; i < QPT; ++i) acc[i][j] = fmaf(a[i], m, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < MPT; ++j)
        acc[i][j] = sqrtf(fmaxf(alpha2 * acc[i][j], 0.f));
    for (int p = 0; p < D; ++p) {
      float a[QPT];
#pragma unroll
      for (int i = 0; i < QPT; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(qw + p * UQ + i);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const float m = ml[32 * j * ms_ + p];
#pragma unroll
        for (int i = 0; i < QPT; ++i) acc[i][j] = fmaf(a[i], m, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int q = q0 + QPT * wp + i;
      if (q >= Bs) break;
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const int nl = lane + 32 * j;
        if (nl < tn) __stcs(ucb + (size_t)q * N + n0 + nl, acc[i][j]);
      }
    }
  }
}

}  // namespace

// C entry point (bound with ctypes).  w (Bu, N), x (Bu, D), r (Bu,),
// xs (Bs, D), theta (N, D), ainv (N, D*D), all f32 contiguous, the
// outputs on 16 bytes (torch allocations); alpha2 = alpha^2.  Writes
// dA (N, D*D), db (N, D), ucb (Bs, N).  Bu = 0 gives zero deltas;
// Bs = 0 skips the scores (theta and ainv may be null).  Returns
// cudaGetLastError().
extern "C" int bandit_update_launch(const float* w, const float* x,
                                    const float* r, const float* xs,
                                    const float* theta, const float* ainv,
                                    float alpha2, int Bu, int Bs, int N,
                                    int D, float* dA, float* db, float* ucb,
                                    void* stream) {
  if (N <= 0) return cudaSuccess;
  if (D < 1 || D > MAX_D || Bu < 0 || Bs < 0) return cudaErrorInvalidValue;
  // opt in once, before any launch (later launches may be under
  // CUDA-graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        update_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_OPTIN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(update_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_OPTIN);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ucb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_OPTIN);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (N + UTN - 1) / UTN;
  // 16-byte mask loads need every row to start on 16 bytes
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    update_kernel<true><<<blocks, NTHR, update_smem(D), s>>>(w, x, r, Bu, N,
                                                             D, dA, db);
  else
    update_kernel<false><<<blocks, NTHR, update_smem(D), s>>>(w, x, r, Bu,
                                                              N, D, dA, db);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || Bs == 0) return err;
  ucb_kernel<<<blocks, NTHR, ucb_smem(D), s>>>(xs, theta, ainv, alpha2, Bs,
                                               N, D, ucb);
  return cudaGetLastError();
}
