// The asm primitives of the kernels (cp.async, ldmatrix, mma.sync
// m16n8k16 bf16 -> f32) as warp collectives of the emulation (emu.h).
// Included by emulate.py in place of the asm definitions.
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
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  emu_ldsm(r, p, false);
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
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
