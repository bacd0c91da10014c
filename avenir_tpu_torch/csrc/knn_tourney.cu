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
// Bounds on an H100 SXM at the 1M-row NearestNeighbor batch (4,096 queries
// × 1,015,808 references, W = 128 of which w = 60 lanes are used):
// 2·m·n·w ≈ 0.50 T multiply-adds, 0.50 ms at 989 TFLOP/s bf16, against
// the 260 MB reference operand read once, 0.08 ms at 3.35 TB/s: bound by
// operations.  But each of its 4.16e9 keys also takes about six integer
// operations on the CUDA cores (the clamp, the bit merge, a pair sort and
// a pair merge), ~1.8 ms of their 64 lanes a clock per SM, and that is
// what bounds the kernel in practice (PERF.md: its probe variants).  So
// the design keeps every d² out of device memory, takes the MMAs off the
// warps' instruction stream and overlaps them with the fold:
//   - a block owns 128 query rows and one segment; blocks over queries run
//     first, so a segment is read from device memory once and from L2 by
//     the other query tiles;
//   - only the first wc = round_up(used lanes, 64) columns are contracted
//     (knn_dot.cuh): on the elearn path 64 of W = 128;
//   - operands are staged by cp.async as 128-byte-swizzled K-major panels
//     of 64 columns: reference chunks of 128 rows through a ring of 4
//     stages, loads 2 chunks ahead, one barrier per chunk; the query rows
//     resident where they fit beside it, else streamed through a ring of 3
//     stages with the references;
//   - each warpgroup (64 query rows) multiplies its d² tile with wgmma,
//     asynchronous; a thread keeps one accumulator (≤ 128 registers), so
//     two blocks share an SM and one block's fold runs while the other's
//     MMAs do.  Where wc = 64 and the queries are resident (the elearn
//     path) a tile is two wgmma groups of 64 columns, and a warpgroup folds
//     one half while the tensor cores multiply the other (2–5% faster
//     there, PERF.md);
//   - a thread folds its accumulator straight into sorted triples, two per
//     held row (even and odd column groups, for independent chains): the
//     two neighbouring columns of a fragment are sorted and merged into a
//     triple as a pair with sm_90's three-way minimum (__vimin3_s32), 5–7%
//     faster than two single inserts;
//   - the four threads of a quad hold the same rows and merge by warp
//     shuffles; a warp's 16 rows span the whole tile, so no block-wide
//     merge is needed.
// max(d², 0) is taken on the bits, max(bits, 0) as signed integers: equal
// to bits(d > 0 ? d : 0) for every d that is not NaN (−0.0 and negative
// rounding residues become +0), and d² of finite operands is never NaN.
//
// Variants (the template switch `V`, probes.knn_tourney_probe): DOTONLY runs
// the loads and MMAs and sums each tile into a float (a trivial output);
// DOTKEY adds the key formation and a running minimum; FULL is the kernel;
// FULL_INSERT is FULL with one insert per key (the earlier fold), for
// comparison.  Only FULL's and FULL_INSERT's outputs are the keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_dot.cuh"

namespace {

constexpr int THREADS = 256;        // two warpgroups
constexpr int BM = 128;             // query rows per block, 64 a warpgroup
constexpr int SEG = 2048;           // reference rows per segment
constexpr int TILES = SEG / knn::BN;
// reference stages of the ring, loads NS − 2 chunks ahead (a deeper ring
// measured no faster); fewer where the queries stream through it too, so
// that two blocks share an SM
constexpr int NS_RESIDENT = 4;
constexpr int NS_STREAMED = 3;
constexpr int ROW_BYTES = knn::KC * 2;    // a panel row: 64 bf16, 128 bytes
constexpr int PANEL = 128 * ROW_BYTES;    // a 128-row panel (BM = BN = 128)
constexpr int EMPTY = 0x7f7fffff;   // FLT_MAX's bits: above every key

enum Variant { DOTONLY = 0, DOTKEY = 1, FULL = 2, FULL_INSERT = 3 };

__device__ __forceinline__ void insert3(int (&t)[3], int x) {
  t[2] = min(t[2], max(t[1], x));
  t[1] = min(t[1], max(t[0], x));
  t[0] = min(t[0], x);
}

// The three smallest of the sorted triple t and a sorted pair lo ≤ hi: the
// k-th smallest of two sorted lists is the least max(t[i−1], pair[k−i−1]).
__device__ __forceinline__ void merge2(int (&t)[3], int lo, int hi) {
  const int t2 = __vimin3_s32(t[2], max(t[1], lo), max(t[0], hi));
  const int t1 = __vimin3_s32(t[1], hi, max(t[0], lo));
  t[0] = min(t[0], lo);
  t[1] = t1;
  t[2] = t2;
}

__device__ __forceinline__ int key(float d, int col) {
  return (max(__float_as_int(d), 0) & ~(SEG - 1)) | col;
}

// Start copying `rows` rows of 64 bf16 (global row stride gstride) into a
// K-major panel with the 128-byte swizzle: the 16-byte chunk q of row r
// lands at chunk q ^ (r % 8) of the row.
__device__ __forceinline__ void issue_panel(unsigned char* s,
                                            const __nv_bfloat16* g,
                                            size_t gstride, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += THREADS) {
    const int r = i >> 3, q = i & 7;
    knn::cp_async16(s + r * ROW_BYTES + ((q ^ (r & 7)) << 4),
                    g + r * gstride + q * 8);
  }
}

// wgmma matrix descriptor of a K-major, 128-byte-swizzled panel at p
// (1024-byte aligned): 8-row groups 1024 bytes apart.  Adding 2 moves it
// one k16 step (32 bytes) along K.
__device__ __forceinline__ uint64_t panel_desc(const unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3ffff) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d (+)= A·B over one k16 step for a warpgroup: A 64 × 16 and B 128 × 16
// K-major bf16 in shared memory (descriptors da, db), f32 accumulators;
// scale_d = 0 writes d instead of adding to it.  Asynchronous: the result
// is there after wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with B 64 × 16 (half a reference tile): 32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving an accumulator across an asynchronous
// wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Fold this thread's part of a 64 × (2·N) d² tile: rows h = 0, 1 (fragment
// rows lane/4 and + 8 of its warp's 16), columns cbase + 8·j and + 1 in
// acc[4j + 2h] and acc[4j + 2h + 1], into t[h][j % 2] (DOTONLY: into
// sum[h]).
template <int V, int N>
__device__ __forceinline__ void fold(int (&t)[2][2][3], float (&sum)[2],
                                     const float (&acc)[N], int cbase) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
      const int col = cbase + 8 * j;
      int(&tt)[3] = t[h][j & 1];
      if constexpr (V == DOTONLY) {
        sum[h] += d0 + d1;
      } else if constexpr (V == DOTKEY) {
        tt[0] = __vimin3_s32(tt[0], key(d0, col), key(d1, col + 1));
      } else if constexpr (V == FULL) {
        const int x = key(d0, col), y = key(d1, col + 1);
        merge2(tt, min(x, y), max(x, y));
      } else {
        insert3(tt, key(d0, col));
        insert3(tt, key(d1, col + 1));
      }
    }
}

// A thread's two triples per held row merged, then the quad's four
// threads (the same rows) by a butterfly of shuffles; a warp's 16 rows span
// the whole tile, so the quad's first thread writes the row's keys.
template <int V>
__device__ __forceinline__ void finish(int (&t)[2][2][3],
                                       const float (&sum)[2], int* k1,
                                       int* k2, int* k3, int row0, int seg,
                                       int nbp, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int(&r)[3] = t[h][0];
    if constexpr (V == DOTONLY) r[0] = __float_as_int(sum[h]);
    if constexpr (V == DOTONLY || V == DOTKEY) {
      r[0] = min(r[0], t[h][1][0]);
      r[1] = r[2] = r[0];
    } else {
      insert3(r, t[h][1][0]);
      insert3(r, t[h][1][1]);
      insert3(r, t[h][1][2]);
    }
    // the quad's four threads hold the same row: butterfly merge
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const int o0 = __shfl_xor_sync(0xffffffffu, r[0], off);
      const int o1 = __shfl_xor_sync(0xffffffffu, r[1], off);
      const int o2 = __shfl_xor_sync(0xffffffffu, r[2], off);
      insert3(r, o0);
      insert3(r, o1);
      insert3(r, o2);
    }
    if ((lane & 3) == 0) {
      const int row = row0 + threadIdx.x / 32 * 16 + lane / 4 + 8 * h;
      const size_t o = (size_t)row * nbp + seg;
      k1[o] = r[0];
      k2[o] = r[1];
      k3[o] = r[2];
    }
  }
}

// Shared-memory bytes of a block: the query panels (resident: wc / 64 of
// them; streamed: one a stage), the reference panels of the ring, and 1024
// bytes to align them.
inline size_t tourney_smem(int wc, bool resident) {
  return resident ? (size_t)(wc / knn::KC + NS_RESIDENT) * PANEL + 1024
                  : (size_t)2 * NS_STREAMED * PANEL + 1024;
}

// Whether the query rows stay resident: when they fit the device's
// per-block limit beside the ring.
inline bool tourney_resident(int wc) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return tourney_smem(wc, true) <= (size_t)limit;
}

template <int V, int NS>
__global__ void __launch_bounds__(THREADS, 2)
    tourney_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b, int* k1, int* k2,
                   int* k3, int w, int wc, int nbp, bool resident) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* Qs = smem_raw + ((1024 - (base & 1023)) & 1023);
  const int kch = wc / knn::KC;               // chunks per tile
  unsigned char* Bs = Qs + (resident ? kch : NS) * PANEL;
  const int row0 = blockIdx.x * BM, seg = blockIdx.y;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const __nv_bfloat16* ag = a + (size_t)row0 * w;
  const __nv_bfloat16* bg = b + (size_t)seg * SEG * w;
  const int nchunks = TILES * kch;
  auto issue = [&](int j) {
    const int kc = (j % kch) * knn::KC;
    issue_panel(Bs + (j % NS) * PANEL, bg + (size_t)(j / kch) * knn::BN * w + kc,
                w, knn::BN);
    if (!resident) issue_panel(Qs + (j % NS) * PANEL, ag + kc, w, BM);
  };
  // resident queries ride in the first group
  if (resident)
    for (int kq = 0; kq < kch; ++kq)
      issue_panel(Qs + kq * PANEL, ag + kq * knn::KC, w, BM);
#pragma unroll
  for (int s = 0; s < NS - 2; ++s) {
    if (s < nchunks) issue(s);
    knn::cp_async_commit();
  }

  int t[2][2][3];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p) t[h][p][0] = t[h][p][1] = t[h][p][2] = EMPTY;

  float acc[64];
  const int ccol = 2 * (lane & 3);
#pragma unroll 1
  for (int tile = 0; tile < TILES; ++tile) {
#pragma unroll 1
    for (int kq = 0; kq < kch; ++kq) {
      const int j = tile * kch + kq;
      knn::cp_async_wait<NS - 3>();      // chunk j has landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // chunk j visible to every warpgroup, and every warpgroup has waited
      // for the MMAs of chunk j − 2, whose stage chunk j + NS − 2 now takes
      __syncthreads();
      if (j + NS - 2 < nchunks) issue(j + NS - 2);
      knn::cp_async_commit();
      const uint64_t da = panel_desc(
          (resident ? Qs + kq * PANEL : Qs + (j % NS) * PANEL) +
          wg * 64 * ROW_BYTES);
      const uint64_t db = panel_desc(Bs + (j % NS) * PANEL);
      wgmma_fence();
      pin(acc);
#pragma unroll
      for (int s = 0; s < knn::KC / 16; ++s)
        wgmma_m64n128k16(acc, da + 2 * s, db + 2 * s, kq | s);
      wgmma_commit();
      pin(acc);
      wgmma_wait<1>();                   // the MMAs of chunk j − 1 are done
    }
    wgmma_wait<0>();                     // and of this tile
    pin(acc);
    fold<V, 64>(t, sum, acc, tile * knn::BN + ccol);
  }

  finish<V>(t, sum, k1, k2, k3, row0, seg, nbp, lane);
}

// HALVES: where wc = 64 and the queries are resident, a tile's 128
// columns are two wgmma groups of 64 into two accumulators of 32, so that
// a warpgroup folds one half while the tensor cores multiply the other.
template <int V, int NS>
__global__ void __launch_bounds__(THREADS, 2)
    tourney_half_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b, int* k1, int* k2,
                        int* k3, int w, int /*wc = 64*/, int nbp,
                        bool /*resident*/) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* Qs = smem_raw + ((1024 - (base & 1023)) & 1023);
  unsigned char* Bs = Qs + PANEL;
  const int row0 = blockIdx.x * BM, seg = blockIdx.y;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const __nv_bfloat16* bg = b + (size_t)seg * SEG * w;
  auto issue = [&](int j) {
    issue_panel(Bs + (j % NS) * PANEL, bg + (size_t)j * knn::BN * w, w,
                knn::BN);
  };
  issue_panel(Qs, a + (size_t)row0 * w, w, BM);   // rides in the first group
#pragma unroll
  for (int s = 0; s < NS - 2; ++s) {
    issue(s);
    knn::cp_async_commit();
  }

  int t[2][2][3];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p) t[h][p][0] = t[h][p][1] = t[h][p][2] = EMPTY;

  const uint64_t da = panel_desc(Qs + wg * 64 * ROW_BYTES);
  float lo[32], hi[32];              // columns 0–63 and 64–127 of a tile
  const int ccol = 2 * (lane & 3);
#pragma unroll 1
  for (int j = 0; j < TILES; ++j) {
    knn::cp_async_wait<NS - 3>();      // tile j has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile j visible to every warpgroup, and every warpgroup has waited
    // for both halves of tile j − 2, whose stage tile j + NS − 2 now takes
    __syncthreads();
    if (j + NS - 2 < TILES) issue(j + NS - 2);
    knn::cp_async_commit();
    const uint64_t db = panel_desc(Bs + (j % NS) * PANEL);
    wgmma_fence();
    pin(lo);
#pragma unroll
    for (int s = 0; s < knn::KC / 16; ++s)
      wgmma_m64n64k16(lo, da + 2 * s, db + 2 * s, s);
    wgmma_commit();
    pin(lo);
    if (j > 0) {
      wgmma_wait<1>();                 // tile j − 1's upper half is done
      pin(hi);
      fold<V, 32>(t, sum, hi, (j - 1) * knn::BN + 64 + ccol);
    }
    wgmma_fence();
    pin(hi);
#pragma unroll
    for (int s = 0; s < knn::KC / 16; ++s)   // rows 64–127 of the panel
      wgmma_m64n64k16(hi, da + 2 * s, db + (64 * ROW_BYTES >> 4) + 2 * s, s);
    wgmma_commit();
    pin(hi);
    wgmma_wait<1>();                   // tile j's lower half is done
    pin(lo);
    fold<V, 32>(t, sum, lo, j * knn::BN + ccol);
  }
  wgmma_wait<0>();
  pin(hi);
  fold<V, 32>(t, sum, hi, (TILES - 1) * knn::BN + 64 + ccol);
  finish<V>(t, sum, k1, k2, k3, row0, seg, nbp, lane);
}

template <int V>
int launch(const void* a, const void* b, int* k1, int* k2, int* k3, int m,
           int n, int w, int wc, int nbp, cudaStream_t st) {
  const bool resident = tourney_resident(wc);
  const size_t smem = tourney_smem(wc, resident);
  const bool halves = resident && wc == knn::KC;
  auto kernel = halves     ? tourney_half_kernel<V, NS_RESIDENT>
                : resident ? tourney_kernel<V, NS_RESIDENT>
                           : tourney_kernel<V, NS_STREAMED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(m / BM, n / SEG), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), k1, k2, k3, w, wc, nbp, resident);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Writes k1, k2, k3 [m, nbp] int32 (lanes ≥ n / 2048 are left as the
// caller filled them) for a [m, w] and b [n, w] bf16 on `stream`,
// contracting the first wc columns (those past the schema's used lanes are
// zero in both operands).  variant 2 is the kernel; 0, 1 and 3 are the
// probe's variants (see the top of this file).  Requires m % 128 == 0,
// n % 2048 == 0, w % 64 == 0, wc % 64 == 0 with 0 < wc ≤ w, and
// n / 2048 ≤ nbp.  Returns the first CUDA error that is not cudaSuccess,
// else 0.
extern "C" int knn_tourney(const void* a, const void* b, int* k1, int* k2,
                           int* k3, int m, int n, int w, int wc, int nbp,
                           int variant, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (m % BM || n % SEG || w <= 0 || w % knn::KC || wc <= 0 ||
      wc % knn::KC || wc > w || n / SEG > nbp || n / SEG > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case DOTONLY:
      return launch<DOTONLY>(a, b, k1, k2, k3, m, n, w, wc, nbp, st);
    case DOTKEY:
      return launch<DOTKEY>(a, b, k1, k2, k3, m, n, w, wc, nbp, st);
    case FULL:
      return launch<FULL>(a, b, k1, k2, k3, m, n, w, wc, nbp, st);
    case FULL_INSERT:
      return launch<FULL_INSERT>(a, b, k1, k2, k3, m, n, w, wc, nbp, st);
    default:
      return cudaErrorInvalidValue;
  }
}
