// Shared pieces of the kNN candidate kernels (knn_tourney.cu, knn_topk.cu):
// the squared distance d² = A·Bᵀ of a query tile against a reference tile,
// computed in the kernel's own body on the tensor cores.  A [M, W] and
// B [N, W] are the packed bf16 operands of ops/knn.py (W a multiple of 64):
// their product IS d², since the reference operand carries the norm
// expansion's −2.  Columns at and past the schema's used lanes are zero in
// both operands, so a kernel may contract only the first
// wc = round_up(used, 64) of them (row stride W): the skipped terms are
// exact zeros.
//
// Operands are staged in shared memory KC columns at a time with cp.async.
// knn_topk.cu multiplies them with mma.sync.m16n8k16 bf16·bf16 → f32 from
// rows padded by 8 bf16 (16 bytes), so that the fragment loads of a warp
// hit 32 distinct banks; knn_tourney.cu with wgmma from swizzled panels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int BN = 128;             // reference rows per tile
constexpr int KC = 64;              // bf16 columns per staged chunk
constexpr int KPAD = 8;             // bf16 pad per shared-memory row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `rows` rows of `cols` bf16 (cols a multiple of 8; global
// row stride gstride elements) into shared memory of row stride sstride,
// 16 bytes per thread and step; TT threads.
template <int TT>
__device__ __forceinline__ void issue_rows(__nv_bfloat16* s, int sstride,
                                           const __nv_bfloat16* g,
                                           size_t gstride, int rows,
                                           int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += TT) {
    const int r = i / vec, c = (i % vec) * 8;
    cp_async16(s + r * sstride + c, g + r * gstride + c);
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

}  // namespace knn
