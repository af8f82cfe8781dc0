// Batched linear-bandit posterior delta + LinUCB scores.
//
// Replaces the Pallas TPU kernel bandit_update_pallas
// (src/repro/kernels/bandit_update.py).  Same contract, with the rank-1
// structure flattened (P2 = D*D):
//   dA[n, p]  = sum_b w[b, n] * x[b, p / D] * x[b, p % D]
//   db[n, d]  = sum_b w[b, n] * (x[b, d] * r[b])
//   ucb[q, n] = xs[q] . theta[n]
//               + sqrt(max(sum_p xs[q, p/D] xs[q, p%D] * (alpha2 * Ainv[n, p]), 0))
// The outer products and alpha^2 * Ainv are formed while staging tiles,
// with the same single roundings the plain PyTorch version uses.
//
// What bounds it on an H100: the (Bu, N) choice mask and the (Bs, N)
// score matrix dominate the bytes (each 4*B*N); the UCB product does
// 2*Bs*N*(D + D*D) fp32 flops on CUDA cores, the deltas only
// 2*(D*D + D) per non-zero of the mask.  At N=100k, Bu=Bs=256, D=9
// that is ~0.28 GB (83 us at 3.35 TB/s) against ~4.6 GFLOP (69 us at
// 67 TFLOP/s): bytes bound.
//
// Design (simple and right first):
//  * update kernel: one thread per model, 64 per block.  Each thread
//    walks its column of the mask (coalesced across the block) and, for
//    the rows where it is non-zero -- one per served request with a
//    one-hot mask -- adds that row's outer product and reward-weighted
//    context into its own shared-memory row.  The block then writes its
//    64 dA rows and 64 db rows out contiguously.  Work follows the data:
//    reading the mask once, plus D*D + D multiply-adds per non-zero.
//  * ucb kernel: a block owns a (TQ queries x TN models) output tile;
//    the models' [theta | alpha^2 Ainv] rows and the queries'
//    [xs | xs xs^T] rows sit in shared memory (odd row stride); each
//    thread owns one model column and TQ/8 queries, loops over the
//    feature axis outermost so one catalog value read from shared
//    memory serves all its queries, and stores coalesced along n.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // ucb kernel
constexpr int MAX_D = 12;
constexpr int UPD_TN = 64;       // models (threads) per block, update kernel
constexpr int UTN = 32;          // models per block, ucb kernel
constexpr int UTQ = 32;          // queries per block, ucb kernel
constexpr int QSTEP = THREADS / UTN;         // rows between a thread's queries
constexpr int QPT = UTQ / QSTEP;             // queries per thread

__global__ void __launch_bounds__(UPD_TN)
update_kernel(const float* __restrict__ w, const float* __restrict__ x,
              const float* __restrict__ r, int Bu, int N, int D,
              float* __restrict__ dA, float* __restrict__ db) {
  extern __shared__ float sm[];
  const int P2 = D * D;
  const int P = P2 + D;
  const int stride = P | 1;                       // odd: conflict-free
  const int n0 = blockIdx.x * UPD_TN;
  const int tn = min(UPD_TN, N - n0);
  float* acc = sm + threadIdx.x * stride;
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  if (threadIdx.x < tn) {
    const int n = n0 + threadIdx.x;
#pragma unroll 8
    for (int b = 0; b < Bu; ++b) {
      const float wv = w[(size_t)b * N + n];
      if (wv == 0.f) continue;
      const float* xb = x + (size_t)b * D;
      for (int p = 0; p < P2; ++p) acc[p] += wv * (xb[p / D] * xb[p % D]);
      const float rb = r[b];
      for (int d = 0; d < D; ++d) acc[P2 + d] += wv * (xb[d] * rb);
    }
  }
  __syncthreads();
  // rows n0 .. n0+tn of dA and of db are contiguous in memory
  for (int e = threadIdx.x; e < tn * P2; e += UPD_TN) {
    const int nl = e / P2;
    dA[(size_t)n0 * P2 + e] = sm[nl * stride + (e - nl * P2)];
  }
  for (int e = threadIdx.x; e < tn * D; e += UPD_TN) {
    const int nl = e / D;
    db[(size_t)n0 * D + e] = sm[nl * stride + P2 + (e - nl * D)];
  }
}

__global__ void __launch_bounds__(THREADS)
ucb_kernel(const float* __restrict__ xs, const float* __restrict__ theta,
           const float* __restrict__ ainv, float alpha2, int Bs, int N,
           int D, float* __restrict__ ucb) {
  extern __shared__ float sm[];
  const int P2 = D * D;
  const int P = D + P2;
  const int stride = P | 1;
  float* ms = sm;                 // UTN x stride: [theta | alpha2*Ainv]
  float* qs = sm + UTN * stride;  // UTQ x P: [xs | xs xs^T]
  const int n0 = blockIdx.x * UTN;
  const int q0 = blockIdx.y * UTQ;
  for (int e = threadIdx.x; e < UTN * P; e += THREADS) {
    const int nl = e / P, p = e - nl * P;
    const int n = n0 + nl;
    float v = 0.f;
    if (n < N)
      v = p < D ? theta[(size_t)n * D + p]
                : alpha2 * ainv[(size_t)n * P2 + (p - D)];
    ms[nl * stride + p] = v;
  }
  for (int e = threadIdx.x; e < UTQ * P; e += THREADS) {
    const int ql = e / P, p = e - ql * P;
    const int q = q0 + ql;
    float v = 0.f;
    if (q < Bs) {
      const float* xq = xs + (size_t)q * D;
      v = p < D ? xq[p] : xq[(p - D) / D] * xq[(p - D) % D];
    }
    qs[e] = v;
  }
  __syncthreads();
  const int nl = threadIdx.x % UTN;
  const int qy = threadIdx.x / UTN;               // 0 .. THREADS/UTN-1
  const int n = n0 + nl;
  if (n >= N) return;
  const float* m = ms + nl * stride;
  const float* f = qs + qy * P;
  float mean[QPT], var[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) mean[j] = var[j] = 0.f;
  for (int p = 0; p < D; ++p) {
    const float mv = m[p];
#pragma unroll
    for (int j = 0; j < QPT; ++j) mean[j] += f[j * QSTEP * P + p] * mv;
  }
  for (int p = D; p < P; ++p) {
    const float mv = m[p];
#pragma unroll
    for (int j = 0; j < QPT; ++j) var[j] += f[j * QSTEP * P + p] * mv;
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = q0 + qy + j * QSTEP;
    if (q < Bs) ucb[(size_t)q * N + n] = mean[j] + sqrtf(fmaxf(var[j], 0.f));
  }
}

}  // namespace

// C entry point (bound with ctypes).  w (Bu, N), x (Bu, D), r (Bu,),
// xs (Bs, D), theta (N, D), ainv (N, D*D), all f32 contiguous;
// alpha2 = alpha^2.  Writes dA (N, D*D), db (N, D), ucb (Bs, N).
// Bu = 0 gives zero deltas; Bs = 0 skips the scores.
// Returns cudaGetLastError().
extern "C" int bandit_update_launch(const float* w, const float* x,
                                    const float* r, const float* xs,
                                    const float* theta, const float* ainv,
                                    float alpha2, int Bu, int Bs, int N,
                                    int D, float* dA, float* db, float* ucb,
                                    void* stream) {
  if (N <= 0) return cudaSuccess;
  if (D < 1 || D > MAX_D || Bu < 0 || Bs < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = D * D + D;
  const size_t usmem = sizeof(float) * (size_t)UPD_TN * (P | 1);
  update_kernel<<<(N + UPD_TN - 1) / UPD_TN, UPD_TN, usmem, s>>>(
      w, x, r, Bu, N, D, dA, db);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || Bs == 0) return err;
  const size_t ssmem = sizeof(float) * ((size_t)UTN * (P | 1) + UTQ * P);
  dim3 grid((N + UTN - 1) / UTN, (Bs + UTQ - 1) / UTQ);
  ucb_kernel<<<grid, THREADS, ssmem, s>>>(xs, theta, ainv, alpha2, Bs, N, D,
                                          ucb);
  return cudaGetLastError();
}
