// Masked-cosine top-k over the routing catalog, fp32 and int8, in one
// launch.
//
// Replaces the Pallas TPU kernels router_topk_pallas and
// router_topk_q8_pallas (src/repro/kernels/router_topk.py).  Same
// contract: score(q, n) = q . e[n] (int8: float(int32 dot) *
// (qscale[q] * escale[n])), plus bias[n] on rows the mask lets
// through, then the min_score floor; per query the k best
// (value desc, index asc) survive, empty slots come back (-inf, -1).
//
// What bounds it on an H100: the bytes of the catalog (N*D*4, or N*D
// for int8) plus the mask rows the queries read (one byte per query per
// catalog row), against ~2*D operations per (query, row) the mask lets
// through.  At the route step's Q=256, N=100k, D=8 that is 3.2 MB of
// catalog and <= 25.6 MB of mask bytes -- memory bound.  The TPU kernel
// read a (Q, N) fp32 mask; this one reads the stacked uint8 filter
// table (R, N) and a per-query row index, so the mask costs 1 byte per
// element and queries sharing a filter row hit the same lines in L2.
// What bounds this kernel in practice is the L1 data path: every
// (query, row) pair reads its row again, from L1, and a load whose
// lanes fall on 32 different 128-byte lines costs 32 L1 cycles where a
// coalesced one costs 4.  So rows are read coalesced and each read
// serves several queries.
//
// Design: grid (query groups, S chunks of catalog rows); a block is 8
// warps, and its warps walk the same rows of one chunk in step, so a
// row one warp reads comes from L1 for the others.
//  * D <= 8 (the route step), rows_kernel: lane l takes row base + l of
//    each 32-row step -- neighbouring lanes, neighbouring rows: fp32 two
//    16-byte loads a row, int8 one 8-byte load -- straight from global
//    memory into registers, with its scale, bias and one mask byte per
//    query (all coalesced; the next step's are in flight while this one
//    is scored), and scores it for the warp's 4 queries, whose vectors
//    stay in registers.  No shared memory.
//  * 8 < D <= 64 (the cache's D = 40), tile_kernel: a lane per row
//    would touch one line per lane, so the block copies 128-row tiles
//    into shared memory with coalesced loads (rows padded to an odd
//    number of 16-byte units: conflict-free 16-byte reads) and each warp
//    scores its query against the tile, a row per lane.
//  * fp32 scores are __fmul_rn/__fadd_rn in index order (no FMA
//    contraction), so the plain PyTorch version, which does the same
//    left-to-right sum, matches bit for bit; int8 dots are __dp4a, four
//    products an instruction, exact in int32, then the same rescale.
//  * the warp keeps one sorted top-k list per query, lane j holding the
//    j-th best (value desc, index asc), so the threshold -- the value at
//    lane k - 1 -- is the exact k-th best seen so far.  A step's scores
//    strictly below it are dropped (equal ones go on: the lower index
//    wins those); one ballot names the rest, and each is inserted in
//    turn: a ballot of the entries that rank before it gives its place,
//    the entries after it move down one lane (shfl_up).  After the first
//    steps few scores pass, so the list costs about a compare a score.
//  * the chunk's list leaves as it stands, lane j writing slot j.  With
//    one chunk that is the answer.  Otherwise it is a partial list, and
//    the block that finishes a query group's last chunk (a ticket per
//    group, set back to 0 by that block for the next launch, a
//    CUDA-graph replay included) inserts the S lists of each query into
//    a fresh list the same way, rank by rank, stopping once a rank
//    offers nothing.  Empty slots are (-inf, -1).  One
//    counter array per process: launches on two streams at once would
//    share it.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 128;                // rows of a shared-memory tile
constexpr int MAX_GROUPS = 65536;        // query groups of one launch

__device__ unsigned g_tickets[MAX_GROUPS];   // chunks done per group

constexpr int QW = 4;                    // queries a rows_kernel warp takes

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// a warp's sorted top-k list: lane j holds the j-th best (v, i); lanes
// at and past k hold what fell out of it
struct WarpList {
  float v;
  int i;

  __device__ __forceinline__ void init() {
    v = -CUDART_INF_F;
    i = -1;
  }

  // the k-th best held, -inf while fewer are held
  __device__ __forceinline__ float kth(int k) const {
    return __shfl_sync(0xffffffffu, v, k - 1);
  }

  // insert (x, ix), known to every lane, if it ranks among the k best
  __device__ __forceinline__ void insert(float x, int ix, int k) {
    const int lane = threadIdx.x & 31;
    const int pos = __popc(__ballot_sync(0xffffffffu, better(v, i, x, ix)));
    if (pos >= k) return;                           // warp-uniform
    const float vu = __shfl_up_sync(0xffffffffu, v, 1);
    const int iu = __shfl_up_sync(0xffffffffu, i, 1);
    if (lane == pos) {
      v = x;
      i = ix;
    } else if (lane > pos) {
      v = vu;
      i = iu;
    }
  }

  // offer each lane's (x, ix) where `cand`; theta follows the k-th best
  __device__ __forceinline__ void offer(bool cand, float x, int ix, int k,
                                       float& theta) {
    unsigned m = __ballot_sync(0xffffffffu, cand);
    if (!m) return;                                 // warp-uniform
    do {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(0xffffffffu, x, src),
             __shfl_sync(0xffffffffu, ix, src), k);
    } while (m);
    theta = kth(k);
  }
};

// a query or a catalog row in registers: fp32 values, or int8 packed
// four to an int; zero past D, so padded terms add nothing
template <int DB, bool Q8>
struct Operand {
  float f[Q8 ? 1 : DB];
  int p[Q8 ? DB / 4 : 1];
};

// row n (of D values) from global memory: vector loads where `vec`
// (D == DB, rows on 16 bytes for fp32, 8 for int8), else one value at a
// time
template <int DB, bool Q8>
__device__ __forceinline__ void load_op(Operand<DB, Q8>& o,
                                        const void* __restrict__ src,
                                        size_t n, int D, bool vec) {
  if constexpr (Q8) {
    const int8_t* e = static_cast<const int8_t*>(src);
    if (vec) {
      const uint2* r = reinterpret_cast<const uint2*>(e + n * DB);
#pragma unroll
      for (int u = 0; u < DB / 8; ++u) {
        const uint2 w = __ldg(r + u);
        o.p[2 * u] = (int)w.x;
        o.p[2 * u + 1] = (int)w.y;
      }
    } else {
#pragma unroll
      for (int w = 0; w < DB / 4; ++w) {
        unsigned u = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * w + b < D)
            u |= (unsigned)(uint8_t)__ldg(e + n * D + 4 * w + b) << (8 * b);
        o.p[w] = (int)u;
      }
    }
  } else {
    const float* e = static_cast<const float*>(src);
    if (vec) {
      const float4* r = reinterpret_cast<const float4*>(e + n * DB);
#pragma unroll
      for (int u = 0; u < DB / 4; ++u) {
        const float4 w = __ldg(r + u);
        o.f[4 * u] = w.x;
        o.f[4 * u + 1] = w.y;
        o.f[4 * u + 2] = w.z;
        o.f[4 * u + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < DB; ++d)
        o.f[d] = d < D ? __ldg(e + n * D + d) : 0.f;
    }
  }
}

// fp32: sum over d in order of q_d * e_d, each product and sum rounded
// (the plain version's order; padded terms are +0 and change nothing:
// the sum starts at +0 and never becomes -0); int8: the exact int32
// dot, then float(dot) * (qscale * escale)
template <int DB, bool Q8>
__device__ __forceinline__ float dot(const Operand<DB, Q8>& q,
                                     const Operand<DB, Q8>& e, float qs,
                                     float es) {
  if constexpr (Q8) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < DB / 4; ++w) acc = __dp4a(e.p[w], q.p[w], acc);
    return __fmul_rn(static_cast<float>(acc), __fmul_rn(qs, es));
  } else {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DB; ++d)
      acc = __fadd_rn(acc, __fmul_rn(q.f[d], e.f[d]));
    return acc;
  }
}

struct Args {
  const void* q;             // (Q, D) f32 or int8
  const void* e;             // (N, D)
  const float* qscale;       // (Q,) int8 only
  const float* escale;       // (N,) int8 only
  const uint8_t* mask;       // (R, N) filter table
  const int* rows;           // (Q,) table row of each query
  const float* bias;         // (N,) or null
  float min_score;
  int Q, N, D, k, chunk;
  int vec;                   // rows as vector loads (load_op)
  float* pv;                 // (Q, S, k) partial lists (S > 1)
  int* pi;
  float* vals;               // (Q, k)
  int* idx;
};

// query q in registers (zeros past Q)
template <int DB, bool Q8>
__device__ __forceinline__ void load_query(const Args& a, int q,
                                           Operand<DB, Q8>& o, float& qs) {
  load_op<DB, Q8>(o, a.q, q < a.Q ? q : 0, a.D, false);
  if (q >= a.Q) {
#pragma unroll
    for (int d = 0; d < (Q8 ? DB / 4 : DB); ++d) {
      if constexpr (Q8) o.p[d] = 0; else o.f[d] = 0.f;
    }
  }
  qs = Q8 && q < a.Q ? __ldg(a.qscale + q) : 0.f;
}

// the chunk's list for query q: the answer (one chunk) or its partial
// list, slot j from lane j
__device__ __forceinline__ void write_list(const Args& a, int q,
                                           const WarpList& t) {
  const int S = gridDim.y, lane = threadIdx.x & 31;
  if (lane >= a.k) return;
  if (S == 1) {
    a.vals[(size_t)q * a.k + lane] = t.v;
    a.idx[(size_t)q * a.k + lane] = t.i;
  } else {
    const size_t o = ((size_t)q * S + blockIdx.y) * a.k + lane;
    a.pv[o] = t.v;
    a.pi[o] = t.i;
  }
}

// after a chunk: the block that finishes the group's last chunk merges
// the S partial lists of each of its warp's queries q0 .. q0 + NQ - 1,
// the queries side by side.  Round r offers every list's r-th entry
// (lane s takes lists s, s + 32, ..); a list is sorted, so once a round
// offers a query nothing its later rounds cannot either.
template <int NQ>
__device__ __forceinline__ void finish(const Args& a, int q0) {
  __shared__ unsigned last;
  const int S = gridDim.y;
  if (S == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&g_tickets[blockIdx.x], 1u) == (unsigned)S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31;
  WarpList t[NQ];
  float theta[NQ];
  bool open[NQ];                                    // warp-uniform
#pragma unroll
  for (int u = 0; u < NQ; ++u) {
    t[u].init();
    theta[u] = -CUDART_INF_F;
    open[u] = q0 + u < a.Q;
  }
  for (int r = 0; r < a.k; ++r) {
    bool offered[NQ];
#pragma unroll
    for (int u = 0; u < NQ; ++u) offered[u] = false;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int sl = s0 + lane;
      float v[NQ];
      int ix[NQ];
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const size_t o = ((size_t)(q0 + u) * S + sl) * a.k + r;
        const bool ok = open[u] && sl < S;
        v[u] = ok ? __ldcg(a.pv + o) : -CUDART_INF_F;
        ix[u] = ok ? __ldcg(a.pi + o) : -1;
      }
#pragma unroll
      for (int u = 0; u < NQ; ++u) {
        const bool c = v[u] > -CUDART_INF_F && !(v[u] < theta[u]);
        if (__any_sync(0xffffffffu, c)) {
          offered[u] = true;
          t[u].offer(c, v[u], ix[u], a.k, theta[u]);
        }
      }
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      open[u] = open[u] && offered[u];
      any = any || open[u];
    }
    if (!any) break;
  }
#pragma unroll
  for (int u = 0; u < NQ; ++u) {
    if (q0 + u < a.Q && lane < a.k) {
      a.vals[(size_t)(q0 + u) * a.k + lane] = t[u].v;
      a.idx[(size_t)(q0 + u) * a.k + lane] = t[u].i;
    }
  }
  if (threadIdx.x == 0) atomicExch(&g_tickets[blockIdx.x], 0u);
}

// D <= 8: a row per lane, QW queries per warp, no shared memory
template <bool Q8>
__global__ void __launch_bounds__(WARPS * 32)
rows_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * WARPS + warp) * QW;
  const int n0 = blockIdx.y * a.chunk;
  const int n1 = min(a.N, n0 + a.chunk);
  if (q0 < a.Q) {                                   // warp-uniform
    Operand<8, Q8> qo[QW];
    float qs[QW], theta[QW];
    const uint8_t* mrow[QW];
    WarpList t[QW];
#pragma unroll
    for (int u = 0; u < QW; ++u) {
      load_query<8, Q8>(a, q0 + u, qo[u], qs[u]);
      // a query past Q reads row 0 of the table and keeps nothing
      mrow[u] = a.mask +
                (size_t)(q0 + u < a.Q ? __ldg(a.rows + q0 + u) : 0) *
                    (size_t)a.N;
      theta[u] = -CUDART_INF_F;
      t[u].init();
    }
    // a step's operands: row n (rows past n1 read n1 - 1 and are offered
    // to no list), its scale and bias, one mask byte per query
    Operand<8, Q8> e;
    float es, bs;
    uint8_t mb[QW];
    auto fetch = [&](int n) {
      load_op<8, Q8>(e, a.e, n, a.D, a.vec != 0);
      es = Q8 ? __ldg(a.escale + n) : 0.f;
      bs = a.bias != nullptr ? __ldg(a.bias + n) : 0.f;
#pragma unroll
      for (int u = 0; u < QW; ++u) mb[u] = __ldg(mrow[u] + n);
    };
    int nx = min(n0 + lane, n1 - 1);
    if (n0 < n1) fetch(nx);
    for (int base = n0; base < n1; base += 32) {    // warp-uniform
      const int n = nx;
      const bool in = base + lane < n1;
      const Operand<8, Q8> ec = e;
      const float esc = es, bsc = bs;
      uint8_t mbc[QW];
#pragma unroll
      for (int u = 0; u < QW; ++u) mbc[u] = mb[u];
      if (base + 32 < n1) {                         // the next step's
        nx = min(base + 32 + lane, n1 - 1);
        fetch(nx);
      }
#pragma unroll
      for (int u = 0; u < QW; ++u) {
        float s = dot<8, Q8>(qo[u], ec, qs[u], esc);
        if (a.bias != nullptr) s = __fadd_rn(s, bsc);
        t[u].offer(in && mbc[u] && q0 + u < a.Q && s >= a.min_score &&
                       !(s < theta[u]),
                   s, n, a.k, theta[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < QW; ++u)
      if (q0 + u < a.Q) write_list(a, q0 + u, t[u]);   // warp-uniform
  }
  finish<QW>(a, q0);
}

// 8 < D <= 64: 128-row tiles through shared memory, a query per warp
template <int DB, bool Q8>
__global__ void __launch_bounds__(WARPS * 32)
tile_kernel(const Args a) {
  // a tile row: DB / 4 16-byte units (fp32) or DB / 4 packed ints
  // (int8), the pitch padded to an odd count: conflict-free reads
  constexpr int W = DB / 4;
  constexpr int SP = W % 2 ? W : W + 1;
  __shared__ __align__(16) float4 tile4[Q8 ? 1 : TILE * SP];
  __shared__ int tilei[Q8 ? TILE * SP : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  const bool active = q < a.Q;                      // warp-uniform
  const int n0 = blockIdx.y * a.chunk;
  const int n1 = min(a.N, n0 + a.chunk);
  Operand<DB, Q8> qo;
  float qs;
  load_query<DB, Q8>(a, q, qo, qs);
  const uint8_t* mrow =
      a.mask + (size_t)(active ? __ldg(a.rows + q) : 0) * (size_t)a.N;
  WarpList t;
  t.init();
  float theta = -CUDART_INF_F;
  for (int base = n0; base < n1; base += TILE) {    // block-uniform
    const int nr = min(TILE, n1 - base);
    __syncthreads();                                // the tile is free
    for (int e = threadIdx.x; e < TILE * W; e += blockDim.x) {
      const int r = e / W, w = e - r * W;           // W: a constant
      const size_t n = (size_t)(base + min(r, nr - 1));
      if constexpr (Q8) {
        const int8_t* src = static_cast<const int8_t*>(a.e);
        int v = 0;
        if (a.vec) {
          v = __ldg(reinterpret_cast<const int*>(src + n * DB) + w);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (4 * w + b < a.D)
              v |= (int)((unsigned)(uint8_t)__ldg(src + n * a.D + 4 * w + b)
                         << (8 * b));
        }
        tilei[r * SP + w] = v;
      } else {
        const float* src = static_cast<const float*>(a.e);
        if (a.vec) {
          tile4[r * SP + w] =
              __ldg(reinterpret_cast<const float4*>(src + n * DB) + w);
        } else {
          float f[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            f[i] = 4 * w + i < a.D ? __ldg(src + n * a.D + 4 * w + i) : 0.f;
          tile4[r * SP + w] = make_float4(f[0], f[1], f[2], f[3]);
        }
      }
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int r0 = 0; r0 < TILE; r0 += 32) {
      const int r = r0 + lane;
      const int n = base + min(r, nr - 1);
      const bool in = r < nr;
      const uint8_t mb = __ldg(mrow + n);
      const float es = Q8 ? __ldg(a.escale + n) : 0.f;
      const float bs = a.bias != nullptr ? __ldg(a.bias + n) : 0.f;
      Operand<DB, Q8> e;
      if constexpr (Q8) {
#pragma unroll
        for (int w = 0; w < W; ++w) e.p[w] = tilei[r * SP + w];
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float4 f = tile4[r * SP + w];
          e.f[4 * w] = f.x;
          e.f[4 * w + 1] = f.y;
          e.f[4 * w + 2] = f.z;
          e.f[4 * w + 3] = f.w;
        }
      }
      float s = dot<DB, Q8>(qo, e, qs, es);
      if (a.bias != nullptr) s = __fadd_rn(s, bs);
      t.offer(in && mb && s >= a.min_score && !(s < theta), s, n, a.k,
              theta);
    }
  }
  if (active) write_list(a, q, t);
  finish<1>(a, q);
}

template <int DB, bool Q8>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int S = a.N > 0 ? (a.N + a.chunk - 1) / a.chunk : 1;
  const uintptr_t ep = reinterpret_cast<uintptr_t>(a.e);
  a.vec = a.D == DB && (Q8 ? a.D % 8 == 0 && ep % 8 == 0
                           : a.D % 4 == 0 && ep % 16 == 0);
  const int qpb = WARPS * (DB <= 8 ? QW : 1);
  // query slices of at most MAX_GROUPS groups: a slice's tickets are all
  // back at 0 when it ends, and launches on one stream run in turn
  const int Q = a.Q;
  for (int q0 = 0; q0 < Q; q0 += MAX_GROUPS * qpb) {
    Args s = a;
    s.Q = min(Q - q0, MAX_GROUPS * qpb);
    s.q = static_cast<const char*>(a.q) + (size_t)q0 * a.D * (Q8 ? 1 : 4);
    if (Q8) s.qscale = a.qscale + q0;
    s.rows = a.rows + q0;
    if (S > 1) {
      s.pv = a.pv + (size_t)q0 * S * a.k;
      s.pi = a.pi + (size_t)q0 * S * a.k;
    }
    s.vals = a.vals + (size_t)q0 * a.k;
    s.idx = a.idx + (size_t)q0 * a.k;
    const dim3 grid((s.Q + qpb - 1) / qpb, S);
    if constexpr (DB <= 8)
      rows_kernel<Q8><<<grid, WARPS * 32, 0, stream>>>(s);
    else
      tile_kernel<DB, Q8><<<grid, WARPS * 32, 0, stream>>>(s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool Q8>
cudaError_t by_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 8) return launch<8, Q8>(a, stream);
  if (a.D <= 40) return launch<40, Q8>(a, stream);
  if (a.D <= 64) return launch<64, Q8>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point (bound with ctypes).  q (Q, D) f32 or int8; e (N, D)
// f32 or int8; qscale (Q,) / escale (N,) f32 (int8 only, else NULL);
// mask_table (R, N) uint8; rows (Q,) int32 row of the table per query;
// bias (N,) f32 or NULL; chunk a multiple of 128 rows; pv/pi (Q, S, k)
// scratch with S = ceil(N / chunk) (unused, may be NULL, when S <= 1);
// vals/idx (Q, k).  A block takes 8 x 4 queries where D <= 8, else 8
// (kernels/router_topk.py queries_per_block).  Returns
// cudaGetLastError().
extern "C" int router_topk_launch(const void* q, const void* e,
                                  const float* qscale, const float* escale,
                                  const uint8_t* mask_table, const int* rows,
                                  const float* bias, float min_score, int Q,
                                  int N, int D, int k, int chunk, int quant,
                                  float* pv, int* pi, float* vals, int* idx,
                                  void* stream) {
  if (Q <= 0) return cudaSuccess;
  if (k < 1 || k > 32 || D < 1 || D > 64 || chunk < 1 || chunk % TILE ||
      N < 0 ||
      ((N + chunk - 1) / chunk > 1 && (pv == nullptr || pi == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q,    e, qscale, escale, mask_table, rows, bias, min_score,
               Q,    N, D,      k,      chunk,      0,    pv,   pi,
               vals, idx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quant ? by_d<true>(a, s) : by_d<false>(a, s);
}
