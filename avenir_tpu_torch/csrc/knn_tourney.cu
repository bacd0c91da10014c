// Segment tournament: for every query row and every 2048-row reference
// segment, the two smallest int32 keys key = (bits(max(d², 0)) & ~2047) |
// column and the third smallest, where d² = A·Bᵀ of the packed operands.
//
// Replaces the TPU kernel avenir_tpu/ops/pallas_knn.py:290
// (_knn_tourney_kernel, through _topk_tourney_traced and _search_fused),
// which forms d² for a [512, 16384] block on the MXU and reduces each
// segment by lane-halving min/max merges of sorted triples.  The key packs
// the column into the low 11 bits: a non-negative float's bits order as an
// int, so the smallest key is the argmin, and keys are unique within a
// segment, so the result does not depend on the order of reduction.
//
// Bounds on an H100 SXM at the repo's kNN batch (4,096 queries × 1M
// references, W = 128 of which w = 114 lanes are used): 2·m·n·w ≈ 0.93
// T multiply-adds, 0.94 ms at 989 TFLOP/s bf16, against the 260 MB
// reference operand read once, 0.08 ms at 3.35 TB/s.  So it is bound by
// operations; the design keeps every d² out of device memory:
//   - a block owns 128 query rows (resident in shared memory where they
//     fit, else streamed with the references: knn_dot.cuh) and one
//     segment; blocks over queries run first, so a segment's 512 KB is
//     read from device memory once and from L2 by the other query tiles;
//   - d² tiles of 128 × 128 come from mma.sync (knn_dot.cuh), and each
//     thread folds its accumulator elements straight into a sorted triple
//     (m1, m2, m3) per row it holds — a 5-op insert, no mask, no branch;
//   - the four threads of a quad hold the same rows and merge by warp
//     shuffles, the two warps over a row's columns through shared memory.
// max(d², 0) is taken as d > 0 ? d : 0, so −0.0 (and any negative rounding
// residue) becomes +0 and never orders before every other key.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_dot.cuh"

namespace {

constexpr int BM = 128;             // query rows per block
constexpr int SEG = 2048;           // reference rows per segment
constexpr int WARPS_N = 2;          // 8 warps: 4 over rows × 2 over columns
constexpr int MI = 2, NI = 8;       // warp tile 32 × 64

__device__ __forceinline__ void insert3(int (&t)[3], int x) {
  t[2] = min(t[2], max(t[1], x));
  t[1] = min(t[1], max(t[0], x));
  t[0] = min(t[0], x);
}

__global__ void __launch_bounds__(knn::THREADS)
    tourney_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b, int* k1, int* k2,
                   int* k3, int w, int nbp, bool resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * BM, seg = blockIdx.y;
  const knn::Queries q{a + (size_t)row0 * w,
                       reinterpret_cast<__nv_bfloat16*>(smem), BM, w,
                       resident};
  __nv_bfloat16* Bs = q.s + BM * q.stride();
  int* red = reinterpret_cast<int*>(Bs + knn::BN * (knn::KC + knn::KPAD));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * (NI * 8);
  knn::load_queries(q);

  int t[MI][2][3];                   // per held row: sorted triple
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) t[mi][h][0] = t[mi][h][1] = t[mi][h][2] = INT_MAX;

  const __nv_bfloat16* bseg = b + (size_t)seg * SEG * w;
  for (int ct = 0; ct < SEG / knn::BN; ++ct) {
    float acc[MI][NI][4];
    knn::tile_d2<MI, NI>(acc, q, Bs, bseg + (size_t)ct * knn::BN * w, wm,
                         wn);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = acc[mi][ni][e];
          const float pos = d > 0.f ? d : 0.f;
          const int col = ct * knn::BN + wn + ni * 8 + 2 * tq + (e & 1);
          insert3(t[mi][e >> 1], (__float_as_int(pos) & ~(SEG - 1)) | col);
        }
  }

  // the quad's four threads hold the same rows: butterfly merge
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const int o0 = __shfl_xor_sync(0xffffffffu, t[mi][h][0], off);
        const int o1 = __shfl_xor_sync(0xffffffffu, t[mi][h][1], off);
        const int o2 = __shfl_xor_sync(0xffffffffu, t[mi][h][2], off);
        insert3(t[mi][h], o0);
        insert3(t[mi][h], o1);
        insert3(t[mi][h], o2);
      }

  // the two warps over a row's columns: the right one publishes, the left
  // one merges and writes
  const bool right = (warp % WARPS_N) == 1;
  if (right && tq == 0) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + gq + 8 * h;
        red[r * 3 + 0] = t[mi][h][0];
        red[r * 3 + 1] = t[mi][h][1];
        red[r * 3 + 2] = t[mi][h][2];
      }
  }
  __syncthreads();
  if (!right && tq == 0) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + gq + 8 * h;
        insert3(t[mi][h], red[r * 3 + 0]);
        insert3(t[mi][h], red[r * 3 + 1]);
        insert3(t[mi][h], red[r * 3 + 2]);
        const size_t o = (size_t)(row0 + r) * nbp + seg;
        k1[o] = t[mi][h][0];
        k2[o] = t[mi][h][1];
        k3[o] = t[mi][h][2];
      }
  }
}

}  // namespace

// Writes k1, k2, k3 [m, nbp] int32 (lanes ≥ n / 2048 are left as the
// caller filled them) for a [m, w] and b [n, w] bf16 on `stream`.
// Requires m % 128 == 0, n % 2048 == 0, w % 64 == 0 and n / 2048 ≤ nbp.
// Returns the first CUDA error that is not cudaSuccess, else 0.
extern "C" int knn_tourney(const void* a, const void* b, int* k1, int* k2,
                           int* k3, int m, int n, int w, int nbp,
                           void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (m % BM || n % SEG || w <= 0 || w % knn::KC || n / SEG > nbp ||
      n / SEG > 65535)
    return cudaErrorInvalidValue;
  const size_t rest = (size_t)knn::BN * (knn::KC + knn::KPAD) * 2 +
                      (size_t)BM * 3 * sizeof(int);
  const bool resident = knn::resident_fits(BM, w, rest);
  const size_t smem = knn::query_smem(BM, w, resident) + rest;
  cudaError_t err = cudaFuncSetAttribute(
      tourney_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m / BM, n / SEG);
  tourney_kernel<<<grid, knn::THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), k1, k2, k3, w, nbp, resident);
  return static_cast<int>(cudaGetLastError());
}
