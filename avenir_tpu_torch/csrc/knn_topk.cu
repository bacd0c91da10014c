// Running top-kk: for every query row the kk ≤ 128 smallest (d², reference
// index) pairs over all references, ascending, where d² = A·Bᵀ of the
// packed operands.  Slots ≥ kk of the [m, 128] outputs hold 3e30 / −1.
//
// Replaces the TPU kernel avenir_tpu/ops/pallas_knn.py:73 (_knn_kernel,
// through _topk_pallas_traced and _topk_pallas), which keeps a per-row best
// buffer in VMEM across a sequential grid over reference blocks and merges
// each block by extract-min rounds, evicting the lowest slot among the
// worst.  That rule keeps a later index of a tie.  This kernel's rule is
// the port's: the kk smallest by (d², index), so among equal d² the lower
// index stays.  It does not copy the extract-min rounds.
//
// Bounds on an H100 SXM, e.g. 4,096 queries × 16,384 references at W = 128
// (w = 114 lanes used): 2·m·n·w ≈ 15 G multiply-adds, 0.016 ms at 989
// TFLOP/s bf16, against ~5 MB of operands, 0.0015 ms at 3.35 TB/s: bound
// by operations.  The design:
//   - the TPU's sequential grid axis becomes a loop inside the block: a
//     block owns 32 query rows (resident in shared memory where they fit,
//     else streamed with the references: knn_dot.cuh) and walks every
//     128-row reference tile, so no merge across blocks is needed;
//   - each d² tile comes from mma.sync (knn_dot.cuh) and is written to
//     shared memory; a warp then takes four rows and tests every d² of the
//     tile against the row's current worst (one compare per element);
//   - the few that pass are inserted one at a time into the row's sorted
//     list in shared memory by the whole warp: a ballot counts the entries
//     that precede the new one, and the tail shifts by one slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "knn_dot.cuh"

namespace {

constexpr int BM = 32;              // query rows per block
constexpr int SLOTS = 128;          // output slots per row
constexpr int MI = 2, NI = 2;       // warp tile 32 × 16: 8 warps over a tile
constexpr int DSTRIDE = knn::BN + 4;  // floats per d² row in shared memory
constexpr int ROWS_PER_WARP = BM / (knn::THREADS / 32);
constexpr float BIG = 3.0e30f;      // empty slot (ops/knn.py's _BIG)

__device__ __forceinline__ bool before(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// Insert (xd, xi) into the ascending list (ld, li) of kk entries, dropping
// the last; the caller has checked that it precedes the last.  Whole warp.
__device__ __forceinline__ void insert(float* ld, int* li, int kk, float xd,
                                       int xi, int lane) {
  float vd[SLOTS / 32];
  int vi[SLOTS / 32];
  int pos = 0;
#pragma unroll
  for (int j = 0; j < SLOTS / 32; ++j) {
    const int s = lane + 32 * j;
    vd[j] = s < kk ? ld[s] : INFINITY;
    vi[j] = s < kk ? li[s] : INT_MAX;
    pos += __popc(__ballot_sync(0xffffffffu,
                                s < kk && before(vd[j], vi[j], xd, xi)));
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < SLOTS / 32; ++j) {
    const int s = lane + 32 * j;
    if (s >= pos && s < kk - 1) {
      ld[s + 1] = vd[j];
      li[s + 1] = vi[j];
    }
  }
  if (lane == 0) {
    ld[pos] = xd;
    li[pos] = xi;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(knn::THREADS)
    topk_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, float* out_d, int* out_i,
                int n, int w, int kk, bool resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * BM;
  const knn::Queries q{a + (size_t)row0 * w,
                       reinterpret_cast<__nv_bfloat16*>(smem), BM, w,
                       resident};
  __nv_bfloat16* Bs = q.s + BM * q.stride();
  float* D = reinterpret_cast<float*>(Bs + knn::BN * (knn::KC + knn::KPAD));
  float* Ld = D + BM * DSTRIDE;     // [BM][SLOTS] best d², ascending
  int* Li = reinterpret_cast<int*>(Ld + BM * SLOTS);   // their indices

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp * (NI * 8);
  for (int i = threadIdx.x; i < BM * SLOTS; i += knn::THREADS) {
    Ld[i] = INFINITY;
    Li[i] = INT_MAX;
  }
  knn::load_queries(q);

  for (int c0 = 0; c0 < n; c0 += knn::BN) {
    float acc[MI][NI][4];
    knn::tile_d2<MI, NI>(acc, q, Bs, b + (size_t)c0 * w, 0, wn);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          D[(mi * 16 + gq + 8 * (e >> 1)) * DSTRIDE + wn + ni * 8 + 2 * tq +
            (e & 1)] = acc[mi][ni][e];
    __syncthreads();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      float* ld = Ld + r * SLOTS;
      int* li = Li + r * SLOTS;
      const float wd = ld[kk - 1];
      const int wi = li[kk - 1];
      unsigned mask[knn::BN / 32];
#pragma unroll
      for (int j = 0; j < knn::BN / 32; ++j) {
        const int c = lane + 32 * j;
        mask[j] = __ballot_sync(0xffffffffu,
                                before(D[r * DSTRIDE + c], c0 + c, wd, wi));
      }
#pragma unroll
      for (int j = 0; j < knn::BN / 32; ++j) {
        while (mask[j]) {
          const int c = __ffs(mask[j]) - 1 + 32 * j;
          mask[j] &= mask[j] - 1;
          const float xd = D[r * DSTRIDE + c];
          // the worst may have improved since the tile's test
          if (before(xd, c0 + c, ld[kk - 1], li[kk - 1]))
            insert(ld, li, kk, xd, c0 + c, lane);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BM * SLOTS; i += knn::THREADS) {
    const int r = i / SLOTS, s = i % SLOTS;
    const bool kept = s < kk && Li[i] != INT_MAX;
    const size_t o = (size_t)(row0 + r) * SLOTS + s;
    out_d[o] = kept ? Ld[i] : BIG;
    out_i[o] = kept ? Li[i] : -1;
  }
}

}  // namespace

// Writes out_d [m, 128] float32 and out_i [m, 128] int32 for a [m, w] and
// b [n, w] bf16 on `stream`.  Requires m % 32 == 0, n % 128 == 0,
// w % 64 == 0 and 1 ≤ kk ≤ 128.  Returns the first CUDA error that is not
// cudaSuccess, else 0.
extern "C" int knn_topk(const void* a, const void* b, float* out_d,
                        int* out_i, int m, int n, int w, int kk,
                        void* stream) {
  if (m <= 0) return 0;
  if (m % BM || n <= 0 || n % knn::BN || w <= 0 || w % knn::KC || kk < 1 ||
      kk > SLOTS)
    return cudaErrorInvalidValue;
  const size_t rest = (size_t)knn::BN * (knn::KC + knn::KPAD) * 2 +
                      (size_t)BM * DSTRIDE * sizeof(float) +
                      (size_t)BM * SLOTS * (sizeof(float) + sizeof(int));
  const bool resident = knn::resident_fits(BM, w, rest);
  const size_t smem = knn::query_smem(BM, w, resident) + rest;
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_kernel<<<m / BM, knn::THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), out_d, out_i, n, w, kk, resident);
  return static_cast<int>(cudaGetLastError());
}
