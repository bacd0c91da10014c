// Shared pieces of the kNN candidate kernels (knn_tourney.cu, knn_topk.cu):
// the squared distance d² = A·Bᵀ of a query tile against a reference tile,
// computed in the kernel's own body on the tensor cores with
// mma.sync.m16n8k16 bf16·bf16 → f32.  A [M, W] and B [N, W] are the packed
// bf16 operands of ops/knn.py (W a multiple of 64): their product IS d²,
// since the reference operand carries the norm expansion's −2.
//
// A block's query rows are resident in shared memory (all W columns,
// staged once) when they fit, else streamed KC columns at a time beside the
// references, so any W works; the wrapper decides (resident_fits).  Rows
// are padded by 8 bf16 (16 bytes), so the fragment loads of a warp hit 32
// distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int THREADS = 256;        // 8 warps
constexpr int BN = 128;             // reference rows per tile
constexpr int KC = 64;              // bf16 columns per staged reference chunk
constexpr int KPAD = 8;             // bf16 pad per shared-memory row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy `rows` rows of `cols` bf16 (cols a multiple of 8) from global memory
// (row stride gstride elements) into shared memory (row stride sstride),
// 16 bytes per thread and step.
__device__ __forceinline__ void stage(__nv_bfloat16* s, int sstride,
                                      const __nv_bfloat16* g, size_t gstride,
                                      int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += THREADS) {
    const int r = i / vec, c = (i % vec) * 8;
    *reinterpret_cast<uint4*>(s + r * sstride + c) =
        __ldg(reinterpret_cast<const uint4*>(g + r * gstride + c));
  }
}

// acc += As[wm : wm+16·MI, ka : ka+kc] · Bs[wn : wn+8·NI, 0 : kc]ᵀ for one
// warp: MI 16-row blocks by NI 8-column blocks.  Fragment (mi, ni) element
// e lies at tile row wm + 16·mi + gq + 8·(e/2), column wn + 8·ni + 2·tq +
// e%2, with gq = lane/4 and tq = lane%4.
template <int MI, int NI>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4],
                                         const __nv_bfloat16* As, int sa,
                                         int ka, const __nv_bfloat16* Bs,
                                         int sb, int wm, int wn, int kc) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  for (int k = 0; k < kc; k += 16) {
    uint32_t a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const __nv_bfloat16* p = As + (wm + mi * 16 + gq) * sa + ka + k + 2 * tq;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * sa);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * sa + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const __nv_bfloat16* p = Bs + (wn + ni * 8 + gq) * sb + k + 2 * tq;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// The block's query rows: `g` its first row in device memory (row stride
// w), `s` their shared-memory tile — all W columns (row stride w + KPAD)
// when resident, else the current KC columns (row stride KC + KPAD).
struct Queries {
  const __nv_bfloat16* g;
  __nv_bfloat16* s;
  int rows, w;
  bool resident;
  __device__ int stride() const { return (resident ? w : KC) + KPAD; }
};

// Shared-memory bytes of a query tile of `rows` rows.
inline size_t query_smem(int rows, int w, bool resident) {
  return (size_t)rows * ((resident ? w : KC) + KPAD) * 2;
}

// Whether a kernel whose other shared memory takes `rest` bytes keeps its
// `rows` query rows resident: when they fit the device's per-block limit.
inline bool resident_fits(int rows, int w, size_t rest) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return query_smem(rows, w, true) + rest <= (size_t)limit;
}

// Stage a resident query tile (no-op when streamed); the first tile_d2
// synchronises before it is read.
__device__ __forceinline__ void load_queries(const Queries& q) {
  if (q.resident) stage(q.s, q.stride(), q.g, q.w, q.rows, q.w);
}

// One reference tile: acc = d² of the block's queries against B rows
// [0, BN) starting at `b` (row stride w), the references — and streamed
// queries — staged KC columns at a time.  Every thread of the block must
// call it (it synchronises the block).
template <int MI, int NI>
__device__ __forceinline__ void tile_d2(float (&acc)[MI][NI][4],
                                        const Queries& q, __nv_bfloat16* Bs,
                                        const __nv_bfloat16* b, int wm,
                                        int wn) {
  constexpr int SB = KC + KPAD;
  const int w = q.w;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int kc = 0; kc < w; kc += KC) {
    __syncthreads();                    // Bs, q.s (and the caller's tiles) free
    if (!q.resident) stage(q.s, SB, q.g + kc, w, q.rows, KC);
    stage(Bs, SB, b + kc, w, BN, KC);
    __syncthreads();
    warp_mma<MI, NI>(acc, q.s, q.stride(), q.resident ? kc : 0, Bs, SB, wm,
                     wn, KC);
  }
}

}  // namespace knn
