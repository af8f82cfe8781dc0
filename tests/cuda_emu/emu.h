// A CPU emulation of the CUDA execution model, enough to run this
// repository's kernels on a machine without a card or nvcc (see
// emulate.py).  Blocks run one at a time; each thread of a block is a
// fiber (ucontext) that gives way at __syncthreads and at every warp
// collective, so a block's threads interleave as they would on an SM at
// those points.  Shared memory starts as 0xFF bytes (a NaN in bf16 and
// f32): a read before a write shows.
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
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {f2bf(f)}; }
inline float __bfloat162float(__nv_bfloat16 h) { return bf2f(h.v); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {{f2bf(a)}, {f2bf(b)}};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {bf2f(h.x.v), bf2f(h.y.v)};
}

using std::max;
using std::min;
inline float __expf(float x) { return std::exp(x); }
inline float __ldcg(const float* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned o = *p;
  *p += v;
  return o;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }

namespace emu {

// fiber states: running, at __syncthreads, at a warp collective, done
enum { RUN, AT_BLOCK, AT_WARP, DONE };
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
inline uint64_t xch[32][32][8];      // a warp's exchange slots, per lane

inline void wait(int st) {
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
    for (unsigned i = 0; i < nthr; ++i) {
      if (fibers[i].state != RUN) continue;
      ran = true;
      cur = (int)i;
      threadIdx = dim3(i, 0, 0);
      swapcontext(&sched, &fibers[i].ctx);
    }
    int done = 0, at_block = 0;
    for (const Fiber& f : fibers) {
      done += f.state == DONE;
      at_block += f.state == AT_BLOCK;
    }
    if (done == (int)nthr) return;
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
    if (!ran && !released) {
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
        smem.assign(std::max<long long>(bytes, 16), 0xFF);
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
inline float __shfl_xor_sync(unsigned, float v, int m) {
  return emu::shfl(v, emu::lane() ^ m);
}
inline float __shfl_up_sync(unsigned, float v, int d) {
  const int l = emu::lane();
  return emu::shfl(v, l >= d ? l - d : l);
}
inline float __shfl_down_sync(unsigned, float v, int d) {
  const int l = emu::lane();
  return emu::shfl(v, l + d < 32 ? l + d : l);
}
