// Co-occurrence gram G = XᵀX for the NB + mutual-information count path.
//
// Replaces the TPU kernel avenir_tpu/ops/pallas_hist.py:283 (_cooc_kernel,
// the fmaj and jmaj modes of cooc_counts_cols).  X is the [N, wp] one-hot of
// the joint code j = bin·C + class per feature, laid out per plan()/w_index()
// (fmaj: w = f·jcp + j; jmaj: w = j·F + f), so counts_from_cooc reads G
// unchanged.  X never reaches global memory: each block expands its own
// slices of it from the int32 codes and labels into shared memory.
//
// Bounds on an H100 SXM (hospital shape F=11, B=12, C=2 → 264 used lanes of
// wp 384, 16M rows):
//   operations  G is symmetric and pad lanes hold 0, so the work needed is
//               one int8 multiply-add per row for each of the 264·265/2
//               upper-triangle cells: 264·265·16M ≈ 1.1 TOP, about 0.57 ms
//               at the 1,979 TOP/s dense int8 rate (the whole padded square,
//               2·384²·16M ≈ 4.7 TOP, would be 2.4 ms);
//   bytes       the codes and labels stream at 48 B a row, 768 MB, about
//               0.23 ms at 3.35 TB/s.
// So the gram is bound by operations.  What this design does about it:
//   - only the upper triangle of 64×64 output tiles is computed (21 of 36 at
//     wp 384) and each off-diagonal tile is mirrored into the lower triangle,
//     since G is symmetric;
//   - the products run on the tensor cores, mma.sync m16n8k32 s8·s8→s32;
//   - the expansion is a scatter: a block zeroes its int8 one-hot slices and
//     sets one byte per (touched feature, row), instead of comparing every
//     (w, row) cell;
//   - rows are split across blocks (grid.y) so the few output tiles still
//     fill every SM; each block adds its int32 tile into G with atomicAdd,
//     which is order-free, so G is exact.
// wgmma/TMA pipelining is left for later work.
//
// Drop-invalid contract: a label outside [0, C) drops the whole row, a code
// outside [0, B) drops only its cell (codes ≥ B never land on fmaj pad lanes
// jc ≤ j < jcp), rows past n are never read, and pad rows and columns of G
// stay exactly 0.  The caller keeps n < 2^24, so int32 counts are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "onehot_mma.cuh"

namespace {

using onehot::KB;
using onehot::STRIDE;
using onehot::THREADS;
using onehot::TILE;

struct Params {
  const int* codes;    // [F, N] int32, row-major
  const int* labels;   // [N] int32
  int* g;              // [wp, wp] int32, zeroed by the caller
  int f, n, nbins, nclass, jcp, wp, fmaj, ntiles, rows_per_split;
};

// Set x[w - w0][k] = 1 for every valid (feature, row) whose w falls in the
// tile [w0, w0 + TILE).  x must be zero; lab[k] is the row's class or -1.
__device__ __forceinline__ void expand(const Params& p, int w0, int n0,
                                       const int* lab, int8_t* x) {
  int fbase, nfeat;
  if (p.fmaj) {                 // the tile holds features w0/jcp .. (w0+63)/jcp
    fbase = w0 / p.jcp;
    nfeat = min(p.f - 1, (w0 + TILE - 1) / p.jcp) - fbase + 1;
  } else {                      // w mod F runs over TILE consecutive features
    fbase = w0 % p.f;
    nfeat = min(p.f, TILE);
  }
  for (int idx = threadIdx.x; idx < nfeat * KB; idx += THREADS) {
    const int k = idx % KB;     // k fastest: neighbouring threads, neighbouring rows
    const int y = lab[k];
    if (y < 0) continue;
    const int fi = idx / KB;
    const int f = p.fmaj ? fbase + fi : (fbase + fi) % p.f;
    const int code = __ldg(p.codes + (size_t)f * p.n + (n0 + k));
    if (code < 0 || code >= p.nbins) continue;
    const int j = code * p.nclass + y;
    const int r = (p.fmaj ? f * p.jcp + j : j * p.f + f) - w0;
    if (r >= 0 && r < TILE) x[r * STRIDE + k] = 1;
  }
}

__global__ void __launch_bounds__(THREADS)
cooc_gram_kernel(const Params p) {
  __shared__ __align__(16) int8_t xa[TILE * STRIDE];
  __shared__ __align__(16) int8_t xb[TILE * STRIDE];
  __shared__ int lab[KB];

  int ti, tj;
  onehot::upper_pair(blockIdx.x, p.ntiles, ti, tj);
  const int wa = ti * TILE, wb = tj * TILE;
  const bool diag = ti == tj;

  int acc[2][4][4];
  onehot::zero_acc(acc);

  const int row_begin = blockIdx.y * p.rows_per_split;
  const int row_end = min(p.n, row_begin + p.rows_per_split);

  for (int n0 = row_begin; n0 < row_end; n0 += KB) {
    onehot::zero_slices(xa, xb, diag);
    for (int k = threadIdx.x; k < KB; k += THREADS) {
      int y = -1;
      if (n0 + k < row_end) {
        y = __ldg(p.labels + n0 + k);
        if (y < 0 || y >= p.nclass) y = -1;
      }
      lab[k] = y;
    }
    __syncthreads();
    expand(p, wa, n0, lab, xa);
    if (!diag) expand(p, wb, n0, lab, xb);
    __syncthreads();
    onehot::tile_mma(acc, xa, diag ? xa : xb);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = acc[mi][ni][e];
        if (v == 0) continue;
        const int r = wa + onehot::acc_row(mi, e);
        const int c = wb + onehot::acc_col(ni, e);
        atomicAdd(p.g + (size_t)r * p.wp + c, v);
        if (!diag) atomicAdd(p.g + (size_t)c * p.wp + r, v);
      }
}

}  // namespace

// Adds the gram of n rows into g (zeroed by the caller, [wp, wp] int32) on
// `stream`.  wp must be a multiple of 64; splits ≥ 1 is the number of row
// ranges the grid spreads over.  Returns cudaGetLastError() after the launch.
extern "C" int cooc_gram(const int* codes, const int* labels, int* g, int f,
                         int n, int nbins, int nclass, int jcp, int wp,
                         int fmaj, int splits, void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.codes = codes;
  p.labels = labels;
  p.g = g;
  p.f = f;
  p.n = n;
  p.nbins = nbins;
  p.nclass = nclass;
  p.jcp = jcp;
  p.wp = wp;
  p.fmaj = fmaj;
  p.ntiles = wp / TILE;
  const int chunks = (n + KB - 1) / KB;
  const int per = (chunks + splits - 1) / splits;
  p.rows_per_split = per * KB;
  const int ysplits = (chunks + per - 1) / per;
  const dim3 grid(p.ntiles * (p.ntiles + 1) / 2, ysplits);
  cooc_gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
