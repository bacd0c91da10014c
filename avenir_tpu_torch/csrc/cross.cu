// Cross co-occurrence counts T[f, b, s] = #rows whose feature f has code b
// and whose selector is s: the decision tree's per-level table, with
// s = node·C + class.
//
// Replaces the TPU kernel avenir_tpu/ops/pallas_hist.py:484 (_cross_kernel,
// through cross_cooc_counts_cols), which computes XᵀY on the MXU with X the
// (feature, bin) one-hot and Y the selector one-hot, both expanded in VMEM.
// Each row contributes exactly one 1 to each feature's block of X and one 1
// to Y, so XᵀY is a histogram over (f, code_f, sel): each row adds F ones.
// Here no one-hot exists: a block keeps the histogram of a tile of features
// over every selector in shared memory and adds into it with shared-memory
// atomics.  Integer atomics are order-free, so T is exact and equal run to
// run.
//
// Bounds on an H100 SXM: the function reads the codes and selectors once
// and writes T once, 4·F·n + 4·n + 4·F·B·S bytes; e.g. the hospital tree's
// deepest level (F = 10, B = 13, 16 selectors) at 1M rows, 44 MB, 13 µs at
// 3.35 TB/s.  The F increments a row are shared-memory atomics, far below
// the dense XᵀY form's 2·F·B·S multiply-adds a row.  So it is bound by
// bytes.  The design (ops/hist.py cross_plan sizes it):
//   - the grid is (row blocks, tiles).  A tile holds as many features as fit
//     shared memory with every selector, so each block reads the selectors
//     and only its own features' codes: the codes stream from memory once
//     at every selector count, the selectors once per tile.  Only where one
//     feature's table cannot fit (B·S past ~100K cells) are the selectors
//     cut into tiles too.  Where 16-bit counters (two cells a word, adding
//     1 or 1 << 16) make fewer tiles, the table packs them, and a block
//     then counts at most 65,532 rows, so no counter wraps;
//   - one thread stages 1,024-row tiles of the selectors and of each
//     feature's codes into a 2-stage shared-memory ring with bulk copies
//     (cp.async.bulk) that complete on an mbarrier, so the bytes in flight
//     do not depend on the threads the occupancy leaves.  A bulk copy takes
//     a 16-byte-aligned source, and a feature row starts at any 4-byte
//     boundary (its stride is n·4 bytes; a view may start anywhere): each
//     copy takes the 16-byte granules that hold the tile's rows, and the
//     consumers skip the granule's head by the row's phase;
//   - the merge: T is zeroed on the stream, and the row blocks of a tile
//     form clusters of two (an H100 schedules its SMs by pairs, so clusters
//     of two fill every SM where larger ones leave some idle).  Each block
//     of a cluster sums one half of the cells over both tables through
//     distributed shared memory and adds the non-zero sums into T with
//     global atomics: a cell of T takes one add per cluster, not one per
//     block.
// PERF.md records what this design was measured against: per-cluster
// partials summed by the last cluster instead of atomics, clusters of one
// and four, other rings, and, for skewed rows, table copies per warp and a
// warp's lanes of one cell summed before they add.
//
// Drop-invalid contract (pallas_hist.py:499-505): a code outside [0, B)
// drops its cell, a selector outside [0, num_sel) (−1 included) drops the
// whole row, and rows past n are never counted (a copy reads at most the
// 16-byte granules that hold rows below n).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 1024;           // rows per ring stage
constexpr int SEG = ROWS + 4;        // ints per staged segment: 4 for the phase
constexpr int STAGES = 2;
constexpr int HEAD = 128;            // bytes before the ring: the mbarriers
constexpr int MAX_FEAT_TILE = 24;    // the gate: F ≤ 24 (wp ≤ 768, jcp ≥ 32)
constexpr int MAX_CLUSTER = 8;
constexpr int FEAT_BATCH = 8;
constexpr int PACKED_ROWS = 65532;   // 16-bit counters: rows a block counts

struct Params {
  const int* codes;    // [F, N] int32, row-major
  const int* sel;      // [N] int32
  int* out;            // [F, B, nsel] int32, zeroed before the launch
  int f, n, nbins, nsel, feat_tile, sel_tile, sel_tiles, rows_per_block;
  int pack;            // 1: two 16-bit counters a word, else 0
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Stage rows [r0, r0 + rows) of the selectors and of features f0 .. f0+ft−1
// into `dst` (segment k at dst + k·SEG ints): one bulk copy a segment, from
// the 16-byte granule that holds its first row, completing on `bar`.
__device__ void stage_rows(const Params& p, int* dst, uint64_t* bar, int r0,
                           int rows, int f0, int ft) {
  uint32_t total = 0;
  for (int k = 0; k <= ft; ++k) {
    const int* src = k == 0 ? p.sel + r0 : p.codes + (size_t)(f0 + k - 1) * p.n + r0;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    total += ((a & 15) + 4u * rows + 15) & ~15u;
  }
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(total) : "memory");
  for (int k = 0; k <= ft; ++k) {
    const int* src = k == 0 ? p.sel + r0 : p.codes + (size_t)(f0 + k - 1) * p.n + r0;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uint32_t len = ((a & 15) + 4u * rows + 15) & ~15u;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst + k * SEG)), "l"(a & ~uintptr_t(15)), "r"(len),
        "r"(b)
        : "memory");
  }
}

__global__ void __launch_bounds__(THREADS) cross_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int phase[MAX_FEAT_TILE + 1];     // 4-byte phase of each segment
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* ring = reinterpret_cast<int*>(smem + HEAD);
  const int segs = 1 + p.feat_tile;
  unsigned* table = reinterpret_cast<unsigned*>(ring + STAGES * segs * SEG);
  const int pk = p.pack;

  // tile (feature tile, selector tile): features f0 .. f0 + ft − 1 and
  // selectors s0 .. s0 + st − 1, a table [ft, B, sel_tile]
  const int tile = blockIdx.y;
  const int f0 = tile / p.sel_tiles * p.feat_tile;
  const int ft = min(p.feat_tile, p.f - f0);
  const int s0 = tile % p.sel_tiles * p.sel_tile;
  const int st = min(p.sel_tile, p.nsel - s0);
  const int cells = ft * p.nbins * p.sel_tile;
  const int words = (cells + pk) >> pk;        // ... in 32-bit words
  const int row_begin = blockIdx.x * p.rows_per_block;
  const int nrows = max(0, min(p.n, row_begin + p.rows_per_block) - row_begin);
  const int ntiles = (nrows + ROWS - 1) / ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a block's first row and ROWS are multiples of 4, so a segment's phase
  // is the same in every stage
  if (threadIdx.x <= ft) {
    const int* src = threadIdx.x == 0
                         ? p.sel
                         : p.codes + (size_t)(f0 + threadIdx.x - 1) * p.n;
    phase[threadIdx.x] = (reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < min(STAGES, ntiles); ++t)
      stage_rows(p, ring + t * segs * SEG, full + t, row_begin + t * ROWS,
                 min(ROWS, nrows - t * ROWS), f0, ft);
  for (int i = threadIdx.x; i < words; i += THREADS) table[i] = 0;
  __syncthreads();

  // cell c is word c >> pk, bits from (c & pk)·16 on
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    while (!mbar_try_wait(smem_addr(full + stage), (t / STAGES) & 1)) {
    }
    const int rows = min(ROWS, nrows - t * ROWS);
    const int* seg = ring + stage * segs * SEG;
    for (int j = threadIdx.x; j < rows; j += THREADS) {
      const int s = seg[phase[0] + j] - s0;
      if ((unsigned)s >= (unsigned)st) continue;
      for (int fb = 0; fb < ft; fb += FEAT_BATCH) {
        int cv[FEAT_BATCH];
#pragma unroll
        for (int k = 0; k < FEAT_BATCH; ++k)
          cv[k] = fb + k < ft ? seg[(1 + fb + k) * SEG + phase[1 + fb + k] + j]
                              : -1;
#pragma unroll
        for (int k = 0; k < FEAT_BATCH; ++k)
          if ((unsigned)cv[k] < (unsigned)p.nbins) {
            const int c = ((fb + k) * p.nbins + cv[k]) * p.sel_tile + s;
            atomicAdd(table + (c >> pk), 1u << ((c & pk) << 4));
          }
      }
    }
    __syncthreads();                     // every thread is done with `stage`
    if (threadIdx.x == 0 && t + STAGES < ntiles)
      stage_rows(p, ring + stage * segs * SEG, full + stage,
                 row_begin + (t + STAGES) * ROWS,
                 min(ROWS, nrows - (t + STAGES) * ROWS), f0, ft);
  }

  // the merge: this block's slice of the cells, summed over the cluster's
  // tables, added into T
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int per = (cells + csize - 1) / csize;
  const int c1 = min(cells, (rank + 1) * per);
  // cell c = (f − f0, b, s − s0) of the table is T[f, b, s]
  int* out = p.out + (size_t)f0 * p.nbins * p.nsel + s0;
  const unsigned mask = pk ? 0xffffu : 0xffffffffu;
  for (int c = rank * per + threadIdx.x; c < c1; c += THREADS) {
    const int sl = c % p.sel_tile;
    if (sl >= st) continue;                    // past the last selector
    int v = 0;
    for (int r = 0; r < csize; ++r)
      v += (cluster.map_shared_rank(table, r)[c >> pk] >> ((c & pk) << 4)) &
           mask;
    if (v != 0) atomicAdd(out + (size_t)(c / p.sel_tile) * p.nsel + sl, v);
  }
  cluster.sync();                      // no block leaves while peers read it
}

// Shared memory a block of this plan takes, in bytes (ops/hist.py
// cross_smem computes the same).
size_t smem_bytes(int feat_tile, int nbins, int sel_tile, int pack) {
  return HEAD + 4 * ((size_t)STAGES * (1 + feat_tile) * SEG +
                     (((size_t)feat_tile * nbins * sel_tile + pack) >> pack));
}

}  // namespace

// A launch of cross_counts, as ops/hist.py _CrossArgs lays it out.
struct CrossArgs {
  int f, n, nbins, nsel;
  int feat_tile, sel_tile, tiles, rows_per_block, row_blocks, cluster;
  int smem, pack;
};

// Once per device (the current one): lets the kernel take as much dynamic
// shared memory as the device's opt-in limit per block leaves beside its
// static shared memory.  Returns that many bytes, or minus the CUDA error.
extern "C" int cross_setup() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, cross_kernel);
  const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  return err == cudaSuccess ? limit : -static_cast<int>(err);
}

// Writes the cross counts of n rows into out ([f, nbins, nsel] int32) on
// `stream`, as the plan `a` says (its n is the row count): zeroes out, then
// launches the kernel.  Returns the first CUDA error that is not
// cudaSuccess, else 0.
extern "C" int cross_counts(const int* codes, const int* sel, int* out,
                            const CrossArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->f < 1 || a->nbins < 1 || a->nsel < 1 || a->feat_tile < 1 ||
      a->feat_tile > MAX_FEAT_TILE || a->sel_tile < 1 ||
      a->sel_tile > a->nsel ||
      a->tiles != ((a->f + a->feat_tile - 1) / a->feat_tile) *
                      ((a->nsel + a->sel_tile - 1) / a->sel_tile) ||
      a->tiles > 65535 || a->rows_per_block < 1 ||
      a->rows_per_block % 4 != 0 || a->cluster < 1 ||
      a->cluster > MAX_CLUSTER || a->row_blocks < 1 ||
      a->row_blocks % a->cluster != 0 ||
      (long long)a->row_blocks * a->rows_per_block < a->n || a->pack < 0 ||
      a->pack > 1 || (a->pack && a->rows_per_block > PACKED_ROWS) ||
      (size_t)a->smem < smem_bytes(a->feat_tile, a->nbins, a->sel_tile, a->pack))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int) * (size_t)a->f * a->nbins * a->nsel, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.codes = codes;
  p.sel = sel;
  p.out = out;
  p.f = a->f;
  p.n = a->n;
  p.nbins = a->nbins;
  p.nsel = a->nsel;
  p.feat_tile = a->feat_tile;
  p.sel_tile = a->sel_tile;
  p.sel_tiles = (a->nsel + a->sel_tile - 1) / a->sel_tile;
  p.rows_per_block = a->rows_per_block;
  p.pack = a->pack;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->row_blocks, a->tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a->smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cross_kernel, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
