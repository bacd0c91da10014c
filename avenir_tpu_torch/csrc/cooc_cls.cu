// Per-class co-occurrence grams G[c] = X_cᵀX_c for the wide NB + MI count
// shapes and the decision tree's packed level tables.
//
// Replaces two TPU kernels of avenir_tpu/ops/pallas_hist.py, the modes `cls`
// and `clsb` of cooc_counts_cols: :333 _cooc_cls_kernel and :365
// _cooc_clsb_kernel.  Both produce G int32 [C, wp, wp] over the per-class
// index w = bin·F + f, laid out per plan()/clsb_tile()/w_index(), so
// counts_from_cooc reads it unchanged.  The modes differ only in wp (cls pads
// F·B to 128 at the end; clsb pads the bin count to a multiple of the band's
// k); the TPU's row band in clsb is a VMEM budget device that Hopper does not
// need, so one kernel serves both.
//
// A row adds only to its own class's gram.  Three launches on one stream:
//   1. class_count_kernel   counts[c] = rows whose label is c (valid labels);
//   2. class_scatter_kernel groups the rows by class (a counting sort): each
//      row gets a position inside its class's range, and its codes are
//      copied there as int16 (−1 for a code outside [0, B)), so the gram
//      pass reads each class's rows contiguously and coalesced;
//   3. cooc_cls_kernel      the gram: a block owns one upper-triangle 64×64
//      tile pair and a row range of ONE class, builds the int8 one-hots of
//      its rows in shared memory and multiplies them with mma.sync
//      (onehot_mma.cuh), then adds the tile into G[c] with atomicAdd.
// Each class's blocks walk only its own rows, so the MMA work is that of one
// gram over all n rows, not C of them.
//
// Inside the gram pass the index is feature-major, u = f·B + bin: a 64-wide
// tile of u holds about 64/B + 1 features, where a tile of w = bin·F + f
// would hold min(F, 64) of them, and every block re-reads the codes of the
// features its two tiles touch.  Each output cell (u1, u2) is written to
// G[c, w(u1), w(u2)]; the writes are element-wise atomics either way.
//
// Bounds on an H100 SXM, e.g. 20 features × 20 bins × 2 classes (wp 512)
// at 4M rows: the function needs one int8 multiply-add per row for each
// upper-triangle cell of its class's F·B used lanes, F·B·(F·B+1)·n ≈ 0.64
// TOP, 0.32 ms at 1,979 TOP/s; the codes and labels stream at 84 B a row,
// 336 MB, 0.10 ms at 3.35 TB/s.  So it is bound by operations, as B1 is.
// What limits this first version is the expansion and the 64×64 tiles,
// not the MMAs (PERF.md holds the measured times).
//
// Drop-invalid contract (pallas_hist.py:346-349, 387-390): a code outside
// [0, B) drops its cell, a label outside [0, C) drops the whole row, rows
// past n are never read, and pad rows and columns of G stay exactly 0.  The
// caller keeps n < 2^24, so int32 counts are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

using onehot::KB;
using onehot::STRIDE;
using onehot::THREADS;
using onehot::TILE;

constexpr int MAX_CLASSES = 16;     // MAX_C_CLSB in ops/hist.py
constexpr int SORT_THREADS = 256;
constexpr int SORT_ROWS = 8;        // rows per thread in the scatter pass

// counts[c] += rows of this grid-stride range whose label is c.
__global__ void __launch_bounds__(SORT_THREADS)
class_count_kernel(const int* labels, int n, int nclass, int* counts) {
  __shared__ int s[MAX_CLASSES];
  if (threadIdx.x < MAX_CLASSES) s[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // warp-uniform loop bound, so the whole warp reaches __match_any_sync
  for (int base = blockIdx.x * SORT_THREADS; base < n;
       base += gridDim.x * SORT_THREADS) {
    const int i = base + threadIdx.x;
    int y = i < n ? __ldg(labels + i) : -1;
    if (y < 0 || y >= nclass) y = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, y);
    if (y >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s[y], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < nclass && s[threadIdx.x])
    atomicAdd(counts + threadIdx.x, s[threadIdx.x]);
}

// Row i of class y goes to position off[y] + (its rank among class-y rows);
// its F codes are copied to sorted[f·n + position].  A block takes
// SORT_THREADS·SORT_ROWS consecutive rows and reserves one range per class
// with one atomicAdd on cursor[y]; the order inside a class is free, since
// the gram is an integer sum.
__global__ void __launch_bounds__(SORT_THREADS)
class_scatter_kernel(const int* codes, const int* labels, int f, int n,
                     int nbins, int nclass, const int* counts, int* cursor,
                     int16_t* sorted) {
  __shared__ int off[MAX_CLASSES];
  __shared__ int blk[MAX_CLASSES];
  if (threadIdx.x == 0) {
    int o = 0;
    for (int c = 0; c < nclass; ++c) {
      off[c] = o;
      o += counts[c];
    }
  }
  if (threadIdx.x < MAX_CLASSES) blk[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * SORT_THREADS * SORT_ROWS;
  int ys[SORT_ROWS], rank[SORT_ROWS];
#pragma unroll
  for (int r = 0; r < SORT_ROWS; ++r) {
    const int i = row0 + r * SORT_THREADS + threadIdx.x;
    int y = i < n ? __ldg(labels + i) : -1;
    if (y < 0 || y >= nclass) y = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, y);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (y >= 0 && lane == leader) base = atomicAdd(&blk[y], __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    ys[r] = y;
    rank[r] = base + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  if (threadIdx.x < nclass && blk[threadIdx.x])
    blk[threadIdx.x] = off[threadIdx.x] +
                       atomicAdd(cursor + threadIdx.x, blk[threadIdx.x]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROWS; ++r) {
    if (ys[r] < 0) continue;
    const int i = row0 + r * SORT_THREADS + threadIdx.x;
    const size_t pos = blk[ys[r]] + rank[r];
    for (int ff = 0; ff < f; ++ff) {
      const int code = __ldg(codes + (size_t)ff * n + i);
      sorted[(size_t)ff * n + pos] =
          static_cast<int16_t>(code >= 0 && code < nbins ? code : -1);
    }
  }
}

struct Params {
  const int16_t* sorted;   // [F, n] class-grouped codes, −1 = dropped cell
  const int* counts;       // [C] rows per class
  int* g;                  // [C, wp, wp] int32, zeroed by the caller
  int f, n, nbins, nclass, width, wp, ntiles, rows_per_split;
};

// Set x[u - u0][k] = 1 for every valid (feature, row) whose u = f·B + code
// falls in the tile [u0, u0 + TILE); rows at or past `end` stay 0.
__device__ __forceinline__ void expand(const Params& p, int u0, int n0,
                                       int end, int8_t* x) {
  const int fbase = u0 / p.nbins;
  const int nfeat = min(p.f - 1, (u0 + TILE - 1) / p.nbins) - fbase + 1;
  for (int idx = threadIdx.x; idx < nfeat * KB; idx += THREADS) {
    const int k = idx % KB;     // k fastest: neighbouring threads, neighbouring rows
    if (n0 + k >= end) continue;
    const int ff = fbase + idx / KB;
    const int code = __ldg(p.sorted + (size_t)ff * p.n + (n0 + k));
    if (code < 0) continue;
    const int r = ff * p.nbins + code - u0;
    if (r >= 0 && r < TILE) x[r * STRIDE + k] = 1;
  }
}

// u = f·B + bin → the per-class index w = bin·F + f of plan()'s layout.
__device__ __forceinline__ int w_of(const Params& p, int u) {
  return (u % p.nbins) * p.f + u / p.nbins;
}

__global__ void __launch_bounds__(THREADS)
cooc_cls_kernel(const Params p) {
  __shared__ __align__(16) int8_t xa[TILE * STRIDE];
  __shared__ __align__(16) int8_t xb[TILE * STRIDE];

  // blockIdx.y → (class, row range inside that class's sorted rows); the
  // grid has up to C more rows of blocks than ranges, and those exit
  int y = blockIdx.y, start = 0, cls = 0, cnt = 0;
  for (; cls < p.nclass; ++cls) {
    cnt = __ldg(p.counts + cls);
    const int nb = (cnt + p.rows_per_split - 1) / p.rows_per_split;
    if (y < nb) break;
    y -= nb;
    start += cnt;
  }
  if (cls == p.nclass) return;
  const int row_begin = start + y * p.rows_per_split;
  const int row_end = min(start + cnt, row_begin + p.rows_per_split);

  int ti, tj;
  onehot::upper_pair(blockIdx.x, p.ntiles, ti, tj);
  const int ua = ti * TILE, ub = tj * TILE;
  const bool diag = ti == tj;

  int acc[2][4][4];
  onehot::zero_acc(acc);
  for (int n0 = row_begin; n0 < row_end; n0 += KB) {
    onehot::zero_slices(xa, xb, diag);
    __syncthreads();
    expand(p, ua, n0, row_end, xa);
    if (!diag) expand(p, ub, n0, row_end, xb);
    __syncthreads();
    onehot::tile_mma(acc, xa, diag ? xa : xb);
    __syncthreads();
  }

  int* gc = p.g + (size_t)cls * p.wp * p.wp;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = acc[mi][ni][e];
        if (v == 0) continue;
        const int u1 = ua + onehot::acc_row(mi, e);
        const int u2 = ub + onehot::acc_col(ni, e);
        if (u1 >= p.width || u2 >= p.width) continue;
        const int w1 = w_of(p, u1), w2 = w_of(p, u2);
        atomicAdd(gc + (size_t)w1 * p.wp + w2, v);
        if (!diag) atomicAdd(gc + (size_t)w2 * p.wp + w1, v);
      }
}

}  // namespace

// Adds the per-class grams of n rows into g (zeroed by the caller,
// [nclass, wp, wp] int32) on `stream`.  scratch is 2·nclass int32 zeroed by
// the caller (class counts, then cursors); sorted is [f, n] int16 scratch.
// nclass ≤ 16; splits ≥ 1 is the number of row ranges the grid spreads over.
// Returns the first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int cooc_cls_gram(const int* codes, const int* labels, int* g,
                             int* scratch, int16_t* sorted, int f, int n,
                             int nbins, int nclass, int wp, int splits,
                             void* stream) {
  if (n <= 0) return 0;
  if (nclass < 1 || nclass > MAX_CLASSES) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* counts = scratch;
  int* cursor = scratch + nclass;

  const int count_blocks = min((n + SORT_THREADS - 1) / SORT_THREADS, 1024);
  class_count_kernel<<<count_blocks, SORT_THREADS, 0, st>>>(labels, n, nclass,
                                                           counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int per_block = SORT_THREADS * SORT_ROWS;
  class_scatter_kernel<<<(n + per_block - 1) / per_block, SORT_THREADS, 0,
                         st>>>(codes, labels, f, n, nbins, nclass, counts,
                               cursor, sorted);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Params p;
  p.sorted = sorted;
  p.counts = counts;
  p.g = g;
  p.f = f;
  p.n = n;
  p.nbins = nbins;
  p.nclass = nclass;
  p.width = f * nbins;
  p.wp = wp;
  p.ntiles = (p.width + TILE - 1) / TILE;
  const int chunks = (n + KB - 1) / KB;
  const int per = (chunks + splits - 1) / splits;
  p.rows_per_split = per * KB;
  // the class ranges cut at most nclass extra row ranges
  const int ysplits = (chunks + per - 1) / per + nclass;
  const dim3 grid(p.ntiles * (p.ntiles + 1) / 2, ysplits);
  cooc_cls_kernel<<<grid, THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
