// A CPU emulation of the CUDA execution model, enough to run this
// repository's kernels on a machine without a card or nvcc (see
// tests/_cuda_emu.py).  Blocks run one at a time; each thread of a block
// is a fiber (ucontext) that gives way at __syncthreads, at every warp
// collective and while it waits on an mbarrier, so a block's threads
// interleave as they would on an SM at those points.  Dynamic shared
// memory starts as 0xFF bytes (a NaN in bf16 and f32): a read before a
// write shows.  It is 1024-byte aligned, and a shared address
// (__cvta_generic_to_shared) is the offset into it, as on the card.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static          // one block at a time: static is shared
#define __align__(n)
#define __restrict__
#define __grid_constant__
#define CUDART_INF_F INFINITY
#define CUDART_VERSION 12000

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

// bf16 with round-to-nearest-even
inline unsigned short f2bf(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return 0x7fc0;
  u += 0x7fff + ((u >> 16) & 1);
  return (unsigned short)(u >> 16);
}
inline float bf2f(unsigned short h) {
  const uint32_t u = (uint32_t)h << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
struct __nv_bfloat16 {
  unsigned short v;
  __nv_bfloat16() = default;
  explicit __nv_bfloat16(float f) : v(f2bf(f)) {}
};
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __nv_bfloat16(f); }
inline float __bfloat162float(__nv_bfloat16 h) { return bf2f(h.v); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__nv_bfloat16(a), __nv_bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {bf2f(h.x.v), bf2f(h.y.v)};
}

using std::max;
using std::min;
inline float __expf(float x) { return std::exp(x); }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline float __ldcg(const float* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned o = *p;
  *p += v;
  return o;
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
// byte n of the result: byte (s >> 4n) & 7 of the 8 bytes {y: x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  const unsigned o = *p;
  *p = v;
  return o;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9, cudaErrorNotSupported = 801 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
// an emulated card of 3 SMs: a persistent grid's blocks each take
// several items
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return 0;
}

namespace emu {

// fiber states: running, at __syncthreads, at a warp collective, done,
// spinning on an mbarrier
enum { RUN, AT_BLOCK, AT_WARP, DONE, SPIN };
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  int state = RUN;
};
inline std::vector<Fiber> fibers;
inline ucontext_t sched;
inline int cur = -1;
inline std::function<void()> body;
inline std::vector<uint8_t> smem;
inline uint8_t* smem_base() {          // dynamic shared memory, 1024-aligned
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem.data()) + 1023) & ~uintptr_t(1023));
}
// set when a fiber does something other than spin on an mbarrier that
// has not completed: a scheduling pass without it is a deadlock
inline bool progress;
inline uint64_t xch[32][32][8];      // a warp's exchange slots, per lane
// named barriers 0..15 (bar.sync / bar.arrive): threads counted in the
// current generation, and the generation
inline int nbar_count[16], nbar_gen[16];

inline void wait(int st) {
  if (st != SPIN) progress = true;
  fibers[cur].state = st;
  swapcontext(&fibers[cur].ctx, &sched);
}
inline void entry() {
  body();
  fibers[cur].state = DONE;
  swapcontext(&fibers[cur].ctx, &sched);
}

inline void run_block(unsigned nthr) {
  fibers.assign(nthr, Fiber());
  for (int i = 0; i < 16; ++i) nbar_count[i] = nbar_gen[i] = 0;
  for (unsigned i = 0; i < nthr; ++i) {
    Fiber& f = fibers[i];
    f.stack.resize(512 * 1024);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.data();
    f.ctx.uc_stack.ss_size = f.stack.size();
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, (void (*)())entry, 0);
  }
  for (;;) {
    bool ran = false;
    progress = false;
    for (unsigned i = 0; i < nthr; ++i) {
      if (fibers[i].state != RUN && fibers[i].state != SPIN) continue;
      ran = ran || fibers[i].state == RUN;
      cur = (int)i;
      threadIdx = dim3(i, 0, 0);
      swapcontext(&sched, &fibers[i].ctx);
    }
    int done = 0, at_block = 0;
    for (const Fiber& f : fibers) {
      done += f.state == DONE;
      at_block += f.state == AT_BLOCK;
    }
    if (done == (int)nthr) {
      for (int i = 0; i < 16; ++i)
        if (nbar_count[i] != 0) {     // arrivals no thread waited for
          fprintf(stderr, "emu: named barrier %d left with %d arrivals in "
                  "block (%u, %u, %u)\n", i, nbar_count[i], blockIdx.x,
                  blockIdx.y, blockIdx.z);
          abort();
        }
      return;
    }
    bool released = false;
    for (unsigned w = 0; w * 32 < nthr; ++w) {
      int n = 0;
      for (unsigned l = 0; l < 32 && w * 32 + l < nthr; ++l)
        n += fibers[w * 32 + l].state == AT_WARP;
      if (n == 32) {
        for (unsigned l = 0; l < 32; ++l) fibers[w * 32 + l].state = RUN;
        released = true;
      }
    }
    if (!released && at_block > 0 && at_block + done == (int)nthr) {
      for (Fiber& f : fibers)
        if (f.state == AT_BLOCK) f.state = RUN;
      released = true;
    }
    if (!ran && !released && !progress) {
      fprintf(stderr, "emu: deadlock in block (%u, %u, %u)\n", blockIdx.x,
              blockIdx.y, blockIdx.z);
      abort();
    }
  }
}

template <class F>
inline void launch(dim3 g, dim3 b, long long bytes, F fn) {
  gridDim = g;
  blockDim = b;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        blockIdx = dim3(x, y, z);
        smem.assign(std::max<long long>(bytes, 16) + 1024, 0xFF);
        body = fn;
        run_block(b.x * b.y * b.z);
      }
}

inline int lane() { return threadIdx.x & 31; }
inline int warp() { return threadIdx.x >> 5; }
inline void warp_sync() { wait(AT_WARP); }

template <class T>
T shfl(T v, int src) {
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  xch[warp()][lane()][0] = u;
  warp_sync();
  const uint64_t r = xch[warp()][src & 31][0];
  warp_sync();
  T o;
  memcpy(&o, &r, sizeof(T));
  return o;
}

}  // namespace emu

inline void __syncthreads() { emu::wait(emu::AT_BLOCK); }
inline void __syncwarp() { emu::warp_sync(); }
inline void __trap() { abort(); }
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const uint8_t*)p - emu::smem_base());
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return emu::shfl(v, (emu::lane() & ~(width - 1)) + (src & (width - 1)));
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  return emu::shfl(v, emu::lane() ^ m);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  const int l = emu::lane();
  return emu::shfl(v, l >= d ? l - d : l);
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, int d) {
  const int l = emu::lane();
  return emu::shfl(v, l + d < 32 ? l + d : l);
}

// Tensor maps: the host looks cuTensorMapEncodeTiled up
// through cudaGetDriverEntryPoint; here it is a stub that records the
// map (base, sizes, byte strides, box, swizzle) in the map's bytes, and
// tma_box4 (prims.h) reads it back.
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUtensorMapDataType, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill;
enum { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9, CU_TENSOR_MAP_INTERLEAVE_NONE = 0,
       CU_TENSOR_MAP_SWIZZLE_64B = 2, CU_TENSOR_MAP_SWIZZLE_128B = 3,
       CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2,
       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct alignas(64) CUtensorMap {
  const uint8_t* base;
  uint64_t dims[4], strides[4];      // strides in bytes; dim 0's the element
  uint32_t box[4];
  int swizzle;
};
static_assert(sizeof(CUtensorMap) <= 128, "a CUtensorMap is 128 bytes");
inline CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType dt,
                                 cuuint32_t rank, void* base,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle sw,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  if (dt != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank != 4 ||
      (uintptr_t)base % 16 || box[0] * 2 > 128)
    return 1;
  m->base = (const uint8_t*)base;
  m->strides[0] = 2;
  for (int i = 0; i < 4; ++i) {
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16) return 1;
      m->strides[i] = strides[i - 1];
    }
  }
  m->swizzle = sw;
  return CUDA_SUCCESS;
}
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPoint(const char*, void** fn, int,
                                           cudaDriverEntryPointQueryResult* r) {
  *fn = (void*)&emu_encode_tiled;
  *r = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}
