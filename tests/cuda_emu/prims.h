// The asm primitives of the kernels as the emulation (emu.h) runs them:
// cp.async as plain copies; ldmatrix, mma.sync m16n8k16 bf16 -> f32 and
// wgmma's register operand as warp collectives; mbarriers as fiber waits;
// TMA boxes as copies that apply the 128- or 64-byte swizzle and fill
// what lies outside the tensor with zeros, and TMA stores back to the
// tensor; wgmma m64nNk16 reading its shared operands through their
// descriptors (either swizzle); named barriers (bar.sync, bar.arrive) as
// counted fiber waits.  setmaxnreg and wgmma.wait_group are no-ops: the
// products are done when issued.  Included by tests/_cuda_emu.py in
// place of the asm definitions.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool full) {
  if (full)
    memcpy(dst, src, 16);
  else
    memset(dst, 0, 16);
}
__device__ __forceinline__ void cp_commit() {}
template <int N>
__device__ __forceinline__ void cp_wait() {}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  cp16(dst, src, full);
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool full) {
  if (full)
    memcpy(dst, src, 8);
  else
    memset(dst, 0, 8);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  if (full)
    memcpy(dst, src, 4);
  else
    memset(dst, 0, 4);
}
__device__ __forceinline__ void cp_async_commit() {}
__device__ __forceinline__ void cp_async_wait1() {}
__device__ __forceinline__ float ex2(float x) { return exp2f(x); }
__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }

// fma.rn.bf16x2 a, b, -0: each product of two bf16 values (exact in
// f32) rounded once to bf16
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  const float lo = bf2f(a & 0xffff) * bf2f(b & 0xffff);
  const float hi = bf2f(a >> 16) * bf2f(b >> 16);
  return (uint32_t)f2bf(lo) | ((uint32_t)f2bf(hi) << 16);
}

static inline uint32_t emu_pack(unsigned short a, unsigned short b) {
  return (uint32_t)a | ((uint32_t)b << 16);
}

// x4: lanes 8q .. 8q + 7 give the rows of matrix q; lane l gets the
// elements (row l / 4, columns 2 (l % 4), + 1), or with .trans (rows
// 2 (l % 4), + 1, column l / 4)
static inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  using namespace emu;
  xch[warp()][lane()][0] = (uint64_t)(uintptr_t)p;
  warp_sync();
  const int l = lane();
  auto row = [&](int q, int i) {
    return (const unsigned short*)(uintptr_t)xch[warp()][8 * q + i][0];
  };
  for (int q = 0; q < 4; ++q) {
    if (!trans)
      r[q] = emu_pack(row(q, l / 4)[2 * (l % 4)],
                      row(q, l / 4)[2 * (l % 4) + 1]);
    else
      r[q] = emu_pack(row(q, 2 * (l % 4))[l / 4],
                      row(q, 2 * (l % 4) + 1)[l / 4]);
  }
  warp_sync();
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  emu_ldsm(r, p, false);
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  emu_ldsm(r, p, true);
}

// D (16x8) += A (16x16) B (16x8) in f32 from the lanes' fragments
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  using namespace emu;
  const int l = lane(), w = warp();
  for (int i = 0; i < 4; ++i) xch[w][l][i] = a[i];
  xch[w][l][4] = b0;
  xch[w][l][5] = b1;
  warp_sync();
  float A[16][16], B[16][8];
  auto lo = [](uint64_t v) { return bf2f((unsigned short)(v & 0xffff)); };
  auto hi = [](uint64_t v) { return bf2f((unsigned short)(v >> 16)); };
  for (int n = 0; n < 32; ++n) {
    const int g = n / 4, t = n % 4;
    const uint64_t* o = xch[w][n];
    A[g][2 * t] = lo(o[0]);         A[g][2 * t + 1] = hi(o[0]);
    A[g + 8][2 * t] = lo(o[1]);     A[g + 8][2 * t + 1] = hi(o[1]);
    A[g][2 * t + 8] = lo(o[2]);     A[g][2 * t + 9] = hi(o[2]);
    A[g + 8][2 * t + 8] = lo(o[3]); A[g + 8][2 * t + 9] = hi(o[3]);
    B[2 * t][g] = lo(o[4]);         B[2 * t + 1][g] = hi(o[4]);
    B[2 * t + 8][g] = lo(o[5]);     B[2 * t + 9][g] = hi(o[5]);
  }
  warp_sync();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    d[e] = acc;
  }
}
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  mma(d, a, b0, b1);
}

// mbarrier: expected arrivals (low 15 bits) and the phase (bit 15),
// pending arrivals, pending transaction bytes.  A phase completes when
// both reach 0; waiters on the phase of parity p pass once the phase bit
// differs from p.
struct EmuBar {
  uint16_t expect, pending;
  int32_t tx;
};
static_assert(sizeof(EmuBar) == 8, "an mbarrier is 8 bytes");
static inline void emu_bar_step(uint64_t* bar, int arrivals, int bytes) {
  EmuBar* b = reinterpret_cast<EmuBar*>(bar);
  b->pending -= arrivals;
  b->tx += bytes;
  emu::progress = true;
  if (b->pending == 0 && b->tx == 0) {
    b->expect ^= 0x8000;
    b->pending = b->expect & 0x7fff;
  }
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  *reinterpret_cast<EmuBar*>(bar) = EmuBar{(uint16_t)count, (uint16_t)count,
                                           0};
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  emu_bar_step(bar, 1, (int)bytes);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  emu_bar_step(bar, 1, 0);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const EmuBar* b = reinterpret_cast<const EmuBar*>(bar);
  bool spun = false;
  while (((b->expect >> 15) & 1u) == parity) {
    emu::wait(emu::SPIN);
    spun = true;
  }
  if (spun) emu::progress = true;
}

// the 128-byte swizzle of a shared address: its 16-byte chunk (bits 4-6)
// xor its 128-byte row within 1024 bytes (bits 7-9); the 64-byte one:
// bits 4-5 xor bits 7-8
static inline uint32_t emu_sw128(uint32_t a) {
  return a ^ (((a >> 7) & 7u) << 4);
}
static inline uint32_t emu_sw64(uint32_t a) {
  return a ^ (((a >> 7) & 3u) << 4);
}

// a 4-D box at (c0 .. c3): row-major in shared memory, 128-byte rows
// swizzled, zeros where the box leaves the tensor; the bytes complete on
// `bar`
__device__ __forceinline__ void tma_box4(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  const CUtensorMap& m = *map;
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t d0 = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t row = m.box[0] * 2;
  uint32_t n = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, n += 2) {
          const long long x[4] = {c[0] + (long long)i0, c[1] + (long long)i1,
                                  c[2] + (long long)i2, c[3] + (long long)i3};
          unsigned short v = 0;
          bool in = true;
          long long off = 0;
          for (int a = 0; a < 4; ++a) {
            in = in && x[a] >= 0 && x[a] < (long long)m.dims[a];
            off += x[a] * (long long)m.strides[a];
          }
          if (in) memcpy(&v, m.base + off, 2);
          uint32_t a = d0 + n;
          if (m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B) {
            if (row != 128) abort();
            a = emu_sw128(a);
          } else if (m.swizzle == CU_TENSOR_MAP_SWIZZLE_64B) {
            if (row != 64) abort();
            a = emu_sw64(a);
          }
          memcpy(emu::smem_base() + a, &v, 2);
        }
  emu_bar_step(bar, 0, -(int)n);
}

// a 4-D box from shared memory (the layout tma_box4 writes) to the
// tensor: only the elements inside the tensor are written
__device__ __forceinline__ void tma_store4(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2, int c3) {
  const CUtensorMap& m = *map;
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(src);
  const uint32_t row = m.box[0] * 2;
  uint32_t n = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, n += 2) {
          const long long x[4] = {c[0] + (long long)i0, c[1] + (long long)i1,
                                  c[2] + (long long)i2, c[3] + (long long)i3};
          bool in = true;
          long long off = 0;
          for (int a = 0; a < 4; ++a) {
            in = in && x[a] >= 0 && x[a] < (long long)m.dims[a];
            off += x[a] * (long long)m.strides[a];
          }
          if (!in) continue;
          uint32_t a = s0 + n;
          if (m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B) {
            if (row != 128) abort();
            a = emu_sw128(a);
          } else if (m.swizzle == CU_TENSOR_MAP_SWIZZLE_64B) {
            if (row != 64) abort();
            a = emu_sw64(a);
          }
          memcpy(const_cast<uint8_t*>(m.base) + off, emu::smem_base() + a, 2);
        }
}

// named barriers: bar.sync waits (a fiber spin) until n threads of the
// block have reached barrier id in its current generation, by bar.sync
// or bar.arrive; bar.arrive counts the caller and goes on.  Which of two
// warpgroups issues its products first cannot show here (the products
// are done at once): only that the turns neither deadlock nor leave an
// arrival behind (emu.h checks each block's barriers at its end).
__device__ __forceinline__ void bar_arrive(int id, int n) {
  emu::progress = true;
  if (++emu::nbar_count[id] == n) {
    emu::nbar_count[id] = 0;
    ++emu::nbar_gen[id];
  }
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  const int gen = emu::nbar_gen[id];
  bar_arrive(id, n);
  bool spun = false;
  while (emu::nbar_gen[id] == gen) {
    emu::wait(emu::SPIN);
    spun = true;
  }
  if (spun) emu::progress = true;
}

// wgmma: asynchronous on the card, done at once here (fence, commit and
// wait are no-ops; the kernels wait before they read the results).
__device__ __forceinline__ void wg_fence() {}
__device__ __forceinline__ void wg_commit() {}
__device__ __forceinline__ void wg_wait0() {}
__device__ __forceinline__ void wg_wait1() {}
template <int N>
__device__ __forceinline__ void reg_fence(float (&)[N]) {}
template <int N>
__device__ __forceinline__ void reg_alloc() {}
template <int N>
__device__ __forceinline__ void reg_dealloc() {}

// element (r, k) of a K-major operand (r: its M or N index, k: the depth)
// or (k, n) of an MN-major one, read through a swizzled descriptor
// (layout type 1: W = 128-byte rows, type 2: 64-byte rows): start,
// leading byte offset (the next W / 2 columns of an MN-major operand),
// stride byte offset (the next 8 rows, or 8 depths)
static inline float emu_desc_at(uint64_t desc, int mn, int k, bool mn_major) {
  const int type = (int)(desc >> 62);
  if (type != 1 && type != 2) abort();
  const uint32_t w = type == 1 ? 128 : 64, cols = w / 2;
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const uint32_t a =
      mn_major ? start + (mn / cols) * lbo + (k / 8) * sbo + (k % 8) * w +
                     (mn % cols) * 2
               : start + (mn / 8) * sbo + (mn % 8) * w + k * 2;
  unsigned short v;
  memcpy(&v, emu::smem_base() + (type == 1 ? emu_sw128(a) : emu_sw64(a)), 2);
  return bf2f(v);
}

// D (64 x N) += A (64 x 16) B (16 x N) for this thread's accumulators
// (warp w of the warpgroup: rows 16 w + lane / 4, + 8; columns 8 c + 2
// (lane % 4), + 1).  A from the descriptor `da` (K-major) or from the
// warp's fragments `a`; B K-major or MN-major.
template <int N>
static inline void emu_wgmma(float* d, uint64_t da, const uint32_t* a,
                             uint64_t db, bool b_mn, int scale_d) {
  using namespace emu;
  const int l = lane(), w = warp() & 3;
  float A[2][16];
  if (a != nullptr) {
    for (int i = 0; i < 4; ++i) xch[warp()][l][i] = a[i];
    warp_sync();
    auto lo = [](uint64_t v) { return bf2f((unsigned short)(v & 0xffff)); };
    auto hi = [](uint64_t v) { return bf2f((unsigned short)(v >> 16)); };
    for (int t = 0; t < 4; ++t) {
      const uint64_t* o = xch[warp()][4 * (l / 4) + t];
      for (int h = 0; h < 2; ++h) {
        A[h][2 * t] = lo(o[h]);
        A[h][2 * t + 1] = hi(o[h]);
        A[h][2 * t + 8] = lo(o[2 + h]);
        A[h][2 * t + 9] = hi(o[2 + h]);
      }
    }
    warp_sync();
  } else {
    for (int h = 0; h < 2; ++h)
      for (int k = 0; k < 16; ++k)
        A[h][k] = emu_desc_at(da, 16 * w + l / 4 + 8 * h, k, false);
  }
  for (int c = 0; c < N / 8; ++c)
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * c + 2 * (l % 4) + (e & 1);
      float acc = scale_d ? d[4 * c + e] : 0.f;
      for (int k = 0; k < 16; ++k)
        acc += A[e >> 1][k] * (b_mn ? emu_desc_at(db, col, k, true)
                                    : emu_desc_at(db, col, k, false));
      d[4 * c + e] = acc;
    }
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  emu_wgmma<64>(d, da, nullptr, db, false, scale_d);
}
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  emu_wgmma<32>(d, da, nullptr, db, false, scale_d);
}
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  emu_wgmma<128>(d, da, nullptr, db, false, scale_d);
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  emu_wgmma<64>(d, 0, a, db, true, 1);
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  emu_wgmma<128>(d, 0, a, db, true, 1);
}
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  emu_wgmma<96>(d, 0, a, db, true, 1);
}
