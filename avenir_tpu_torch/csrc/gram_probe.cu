// Probe kernels of the one-hot gram: the Hopper counterparts of two TPU
// probes, for timing breakdowns (avenir_tpu_torch/probes.py).  Nothing on
// a path of the system runs them.
//
// 1. The one-hot MMA gram that was B1 (the fmaj and jmaj modes of
//    cooc_counts_cols) until ops/hist.py moved every mode onto the pair
//    histogram of cooc_pair.cu.  Counterpart of
//    benchmarks/cooc_expand_sweep.py:187,214, which times variants of the
//    TPU kernel's one-hot expand.  G = XᵀX with X the [N, wp] one-hot of the
//    joint code j = bin·C + class per feature, laid out per plan() (fmaj:
//    w = f·jcp + j; jmaj: w = j·F + f).  A block owns one 64×64 tile of G's
//    upper triangle and a range of rows; it expands KB rows of its two
//    one-hot slices into shared memory (a scatter: one byte per touched
//    feature and row) and multiplies them with mma.sync m16n8k32
//    s8·s8→s32; each tile is added into G and its mirror with atomicAdd.
//    Variants: FULL (the gram, equal to the plain version) and DOTONLY
//    (the slices zeroed once and never expanded: the MMAs and the row loop
//    alone, a meaningless G).  In jmaj a tile's 64 lanes span every
//    feature, so each tile reads all F codes of every row, the cost the
//    pair histogram removes.
// 2. The same mma.sync s8 stage on an int8 matrix X that is given, no
//    expand: counterpart of benchmarks/dot_orient_probe.py:60,72, which
//    times the TPU's int8 gram with X in its two orientations.  COLS takes
//    X as [W, N] (a slice row is contiguous in memory: 16-byte loads
//    straight into the staged layout); ROWS takes X as [N, W] (each 4×4
//    block of bytes is transposed in registers with byte permutes on the
//    way in).  G = XᵀX [W, W] int32; the caller keeps the sums inside
//    int32.
//
// Bounds on an H100 SXM: the one-hot gram as B1's (codes and labels read
// once, G written once; PERF.md §3); the oriented gram at W 384 and 16M
// rows reads 6.4 GB, 1.9 ms at 3.35 TB/s, against 2.5e12 int8
// multiply-adds of the upper triangle, 1.25 ms at 1,979 TOP/s: bound by
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;            // output tile edge
constexpr int KB = 128;             // data rows per shared-memory stage
constexpr int STRIDE = KB + 16;     // bytes per slice row: conflict-free fragment loads
constexpr int THREADS = 128;        // 4 warps, 2×2 over the tile, 32×32 each

enum OnehotVariant { FULL = 0, DOTONLY = 1 };

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

// Zero the TILE × KB slices (xb only off the diagonal).
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
// bytes; row r of a slice is column r of the tile's X).  Four warps cover
// the tile 2×2, 32×32 each.
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

// Add the block's accumulators into the tile (wa, wb) of g [wp, wp] and,
// off the diagonal, its mirror.  Accumulator element e of fragment
// (mi, ni) lies at tile row wm + mi·16 + gq + 8·(e/2), column
// wn + ni·8 + 2·tq + e%2.
__device__ __forceinline__ void store_tile(const int (&acc)[2][4][4], int* g,
                                           int wp, int wa, int wb, bool diag) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = acc[mi][ni][e];
        if (v == 0) continue;
        const int r = wa + (warp >> 1) * 32 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
        const int c = wb + (warp & 1) * 32 + ni * 8 + 2 * (lane & 3) + (e & 1);
        atomicAdd(g + (size_t)r * wp + c, v);
        if (!diag) atomicAdd(g + (size_t)c * wp + r, v);
      }
}

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

template <int V>
__global__ void __launch_bounds__(THREADS) onehot_kernel(const Params p) {
  __shared__ __align__(16) int8_t xa[TILE * STRIDE];
  __shared__ __align__(16) int8_t xb[TILE * STRIDE];
  __shared__ int lab[KB];

  int ti, tj;
  upper_pair(blockIdx.x, p.ntiles, ti, tj);
  const int wa = ti * TILE, wb = tj * TILE;
  const bool diag = ti == tj;

  int acc[2][4][4] = {};
  const int row_begin = blockIdx.y * p.rows_per_split;
  const int row_end = min(p.n, row_begin + p.rows_per_split);
  if (V == DOTONLY) {
    zero_slices(xa, xb, diag);
    __syncthreads();
  }
  for (int n0 = row_begin; n0 < row_end; n0 += KB) {
    if (V == FULL) {
      zero_slices(xa, xb, diag);
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
    }
    tile_mma(acc, xa, diag ? xa : xb);
    if (V == FULL) __syncthreads();
  }
  store_tile(acc, p.g, p.wp, wa, wb, diag);
}

// 4×4 bytes: in[i] holds row i's four bytes; out[j] gets byte j of each.
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Stage the slice of X's columns [w0, w0 + TILE) over rows [n0, n0 + KB)
// into x[r][k] (r the column, k the row).
template <bool ROWS>
__device__ __forceinline__ void stage_orient(const int8_t* xg, int n, int w,
                                             int w0, int n0, int8_t* x) {
  if constexpr (!ROWS) {        // X [W, N]: each slice row is contiguous
    for (int i = threadIdx.x; i < TILE * (KB / 16); i += THREADS) {
      const int r = i / (KB / 16), k = (i % (KB / 16)) * 16;
      *reinterpret_cast<uint4*>(x + r * STRIDE + k) = __ldg(
          reinterpret_cast<const uint4*>(xg + (size_t)(w0 + r) * n + n0 + k));
    }
    return;
  }
  // X [N, W]: 4 rows × 4 columns per thread and step, transposed
  for (int i = threadIdx.x; i < (KB / 4) * (TILE / 4); i += THREADS) {
    const int k = (i / (TILE / 4)) * 4, r = (i % (TILE / 4)) * 4;
    uint32_t in[4], out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      in[q] = __ldg(reinterpret_cast<const uint32_t*>(
          xg + (size_t)(n0 + k + q) * w + w0 + r));
    transpose4(in, out);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<uint32_t*>(x + (r + q) * STRIDE + k) = out[q];
  }
}

template <bool ROWS>
__global__ void __launch_bounds__(THREADS)
    orient_kernel(const int8_t* __restrict__ xg, int* g, int n, int w,
                  int ntiles, int rows_per_split) {
  __shared__ __align__(16) int8_t xa[TILE * STRIDE];
  __shared__ __align__(16) int8_t xb[TILE * STRIDE];
  int ti, tj;
  upper_pair(blockIdx.x, ntiles, ti, tj);
  const int wa = ti * TILE, wb = tj * TILE;
  const bool diag = ti == tj;
  int acc[2][4][4] = {};
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  for (int n0 = row_begin; n0 < row_end; n0 += KB) {
    stage_orient<ROWS>(xg, n, w, wa, n0, xa);
    if (!diag) stage_orient<ROWS>(xg, n, w, wb, n0, xb);
    __syncthreads();
    tile_mma(acc, xa, diag ? xa : xb);
    __syncthreads();
  }
  store_tile(acc, g, w, wa, wb, diag);
}

// Rows per split, in whole KB stages, and the number of splits that covers
// n rows with at most `splits` of them.
void row_split(int n, int splits, int* per, int* ysplits) {
  const int chunks = (n + KB - 1) / KB;
  const int c = (chunks + splits - 1) / splits;
  *per = c * KB;
  *ysplits = (chunks + c - 1) / c;
}

}  // namespace

// Adds the one-hot gram of n rows into g (zeroed by the caller, [wp, wp]
// int32) on `stream`: variant 0 the gram (B1's former kernel), 1 the MMAs
// alone (g meaningless).  wp must be a multiple of 64; splits ≥ 1 is the
// number of row ranges the grid spreads over.  Returns cudaGetLastError()
// after the launch.
extern "C" int gram_probe_onehot(const int* codes, const int* labels, int* g,
                                 int f, int n, int nbins, int nclass, int jcp,
                                 int wp, int fmaj, int splits, int variant,
                                 void* stream) {
  if (n <= 0) return 0;
  if (wp % TILE || splits < 1 || (variant != FULL && variant != DOTONLY))
    return cudaErrorInvalidValue;
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
  int ysplits = 0;
  row_split(n, splits, &p.rows_per_split, &ysplits);
  const dim3 grid(p.ntiles * (p.ntiles + 1) / 2, ysplits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == FULL)
    onehot_kernel<FULL><<<grid, THREADS, 0, st>>>(p);
  else
    onehot_kernel<DOTONLY><<<grid, THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Adds XᵀX of an int8 matrix X into g (zeroed by the caller, [w, w] int32)
// on `stream`: X is [n, w] where rows != 0, else [w, n].  Requires
// w % 64 == 0 and n % 128 == 0.  Returns cudaGetLastError() after the
// launch.
extern "C" int gram_probe_orient(const void* x, int* g, int n, int w,
                                 int rows, int splits, void* stream) {
  if (n <= 0) return 0;
  if (w <= 0 || w % TILE || n % KB || splits < 1)
    return cudaErrorInvalidValue;
  const int ntiles = w / TILE;
  int per = 0, ysplits = 0;
  row_split(n, splits, &per, &ysplits);
  const dim3 grid(ntiles * (ntiles + 1) / 2, ysplits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xg = static_cast<const int8_t*>(x);
  if (rows)
    orient_kernel<true><<<grid, THREADS, 0, st>>>(xg, g, n, w, ntiles, per);
  else
    orient_kernel<false><<<grid, THREADS, 0, st>>>(xg, g, n, w, ntiles, per);
  return static_cast<int>(cudaGetLastError());
}
