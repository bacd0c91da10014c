// Cross co-occurrence counts T[f, b, s] = #rows whose feature f has code b
// and whose selector is s: the decision tree's per-level table, with
// s = node·C + class.
//
// Replaces the TPU kernel avenir_tpu/ops/pallas_hist.py:484 (_cross_kernel,
// through cross_cooc_counts_cols), which computes XᵀY on the MXU with X the
// (feature, bin) one-hot and Y the selector one-hot, both expanded in VMEM.
// Each row contributes exactly one 1 to each feature's block of X and one 1
// to Y, so XᵀY is a histogram over (f, code_f, sel): each row adds F ones.
// Here no one-hot exists at all: a block keeps the histogram of a range of
// selectors in shared memory, streams the int32 codes and selectors of its
// rows once, coalesced, adds with shared-memory atomics, and finally adds
// its non-zero cells into T with global atomics.  Integer atomics are
// order-free, so T is exact and equal run to run.
//
// Bounds on an H100 SXM, e.g. the hospital tree's third level (F = 10,
// B = 13, 54 selectors) at 1M rows: 2·F·B·S·n ≈ 14 G multiply-adds of the
// dense XᵀY form, 7 µs at 1,979 TOP/s, against 4·F·n + 4·n + 4·F·B·S
// ≈ 44 MB, 13 µs at 3.35 TB/s.  So it is bound by bytes: what matters is
// that codes stream once and no one-hot is materialised.  The design:
//   - grid.y splits the selectors into tiles whose table fits in shared
//     memory (up to 96 KB); a block reads the codes of a row only when the
//     row's selector falls in its tile, so codes are read once in all;
//   - when the table is small (few selectors: the root level has C), each
//     warp group adds into its own copy of it, so that rows of the same
//     cell do not all contend for one shared-memory word;
//   - codes are loaded eight features at a time before their atomics, so
//     several loads are in flight per thread.
//
// Drop-invalid contract (pallas_hist.py:499-505): a code outside [0, B)
// drops its cell, a selector outside [0, num_sel) (−1 included) drops the
// whole row, and rows past n are never read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FEAT_BATCH = 8;
constexpr int SMEM_BUDGET = 96 * 1024;      // bytes of table per block

struct Params {
  const int* codes;    // [F, N] int32, row-major
  const int* sel;      // [N] int32
  int* out;            // [F, B, nsel] int32, zeroed by the caller
  int f, n, nbins, nsel, sel_tile, copies, rows_per_block;
};

__global__ void __launch_bounds__(THREADS) cross_kernel(const Params p) {
  extern __shared__ int hist[];                    // copies × cells
  const int cells = p.f * p.nbins * p.sel_tile;
  const int s0 = blockIdx.y * p.sel_tile;
  const int stile = min(p.sel_tile, p.nsel - s0);
  for (int i = threadIdx.x; i < p.copies * cells; i += THREADS) hist[i] = 0;
  __syncthreads();

  int* h = hist + ((threadIdx.x / 32) % p.copies) * cells;
  const int row_begin = blockIdx.x * p.rows_per_block;
  const int row_end = min(p.n, row_begin + p.rows_per_block);
  for (int i = row_begin + threadIdx.x; i < row_end; i += THREADS) {
    const int sv = __ldg(p.sel + i);
    if (sv < s0 || sv >= s0 + stile) continue;
    const int s = sv - s0;
    for (int f0 = 0; f0 < p.f; f0 += FEAT_BATCH) {
      int cv[FEAT_BATCH];
#pragma unroll
      for (int j = 0; j < FEAT_BATCH; ++j)
        cv[j] = f0 + j < p.f ? __ldg(p.codes + (size_t)(f0 + j) * p.n + i)
                             : -1;
#pragma unroll
      for (int j = 0; j < FEAT_BATCH; ++j)
        if (cv[j] >= 0 && cv[j] < p.nbins)
          atomicAdd(h + ((f0 + j) * p.nbins + cv[j]) * p.sel_tile + s, 1);
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < cells; c += THREADS) {
    int v = 0;
    for (int k = 0; k < p.copies; ++k) v += hist[k * cells + c];
    if (v == 0) continue;
    const int s = c % p.sel_tile;             // < stile whenever v != 0
    atomicAdd(p.out + (size_t)(c / p.sel_tile) * p.nsel + s0 + s, v);
  }
}

}  // namespace

// Adds the cross counts of n rows into out (zeroed by the caller,
// [f, nbins, nsel] int32) on `stream`.  Requires f·nbins·4 ≤ 96 KB.
// Returns the first CUDA error that is not cudaSuccess, else 0.
extern "C" int cross_counts(const int* codes, const int* sel, int* out, int f,
                            int n, int nbins, int nsel, void* stream) {
  if (n <= 0 || nsel <= 0) return 0;
  const int budget = SMEM_BUDGET / 4;              // ints
  const int per_sel = f * nbins;
  if (per_sel <= 0 || per_sel > budget) return cudaErrorInvalidValue;
  Params p;
  p.codes = codes;
  p.sel = sel;
  p.out = out;
  p.f = f;
  p.n = n;
  p.nbins = nbins;
  p.nsel = nsel;
  p.sel_tile = min(nsel, budget / per_sel);
  const int cells = per_sel * p.sel_tile;
  p.copies = max(1, min(WARPS, budget / cells));
  const int tiles = (nsel + p.sel_tile - 1) / p.sel_tile;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about two blocks per SM in all; each block then merges its table once
  int blocks = max(1, (2 * sms) / tiles);
  blocks = min(blocks, (n + THREADS - 1) / THREADS);
  p.rows_per_block = ((n + blocks - 1) / blocks + THREADS - 1) / THREADS *
                     THREADS;
  blocks = (n + p.rows_per_block - 1) / p.rows_per_block;

  const size_t smem = (size_t)p.copies * cells * sizeof(int);
  err = cudaFuncSetAttribute(cross_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, tiles);
  cross_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
