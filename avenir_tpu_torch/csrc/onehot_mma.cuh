// Shared pieces of the one-hot gram kernels (cooc.cu, cooc_cls.cu): a block
// owns one 64×64 output tile of a symmetric gram, stages KB data rows of two
// int8 one-hot slices in shared memory, and multiplies them on the tensor
// cores with mma.sync m16n8k32 s8·s8→s32.  Four warps cover the tile 2×2,
// 32×32 each; every thread keeps a [2][4][4] int32 accumulator.
#pragma once

#include <stdint.h>

namespace onehot {

constexpr int TILE = 64;            // output tile edge
constexpr int KB = 128;             // data rows per shared-memory stage
constexpr int STRIDE = KB + 16;     // bytes per one-hot row: conflict-free fragment loads
constexpr int THREADS = 128;        // 4 warps, 2×2 over the tile, 32×32 each

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// blockIdx-style index t → the upper-triangle tile pair ti <= tj of an
// ntiles × ntiles grid, rows first.
__device__ __forceinline__ void upper_pair(int t, int ntiles, int& ti,
                                           int& tj) {
  ti = 0;
  while (t >= ntiles - ti) {
    t -= ntiles - ti;
    ++ti;
  }
  tj = ti + t;
}

__device__ __forceinline__ void zero_acc(int (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

// Zero the TILE × KB one-hot slices (xb only off the diagonal).
__device__ __forceinline__ void zero_slices(int8_t* xa, int8_t* xb,
                                            bool diag) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < TILE * (KB / 16); i += THREADS) {
    const int off = (i / (KB / 16)) * STRIDE + (i % (KB / 16)) * 16;
    *reinterpret_cast<uint4*>(xa + off) = zero;
    if (!diag) *reinterpret_cast<uint4*>(xb + off) = zero;
  }
}

// acc += xa · xbᵀ over the KB staged rows (xa, xb: TILE rows of STRIDE
// bytes; row r of the tile is the one-hot column of output index r).
__device__ __forceinline__ void tile_mma(int (&acc)[2][4][4],
                                         const int8_t* xa,
                                         const int8_t* xb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;          // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < KB; kk += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* base = xa + (wm + mi * 16 + gq) * STRIDE + kk + tq * 4;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * STRIDE);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * STRIDE + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* base = xb + (wn + ni * 8 + gq) * STRIDE + kk + tq * 4;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

// Tile coordinates of accumulator element e of fragment (mi, ni):
// row wm + mi·16 + gq + 8·(e/2), column wn + ni·8 + 2·tq + e%2.
__device__ __forceinline__ int acc_row(int mi, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp >> 1) * 32 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int acc_col(int ni, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp & 1) * 32 + ni * 8 + 2 * (lane & 3) + (e & 1);
}

}  // namespace onehot
