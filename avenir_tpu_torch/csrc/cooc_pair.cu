// Co-occurrence grams as pair histograms: G = XᵀX for every layout of
// ops/hist.py plan() — the joint grams (fmaj, jmaj) of the NB + MI count
// path and the per-class grams (cls, clsb) of the wide schemas and the
// decision tree's packed level tables.
//
// Replaces three TPU kernels of avenir_tpu/ops/pallas_hist.py, the modes of
// cooc_counts_cols: :283 _cooc_kernel (fmaj, jmaj; B1), :333
// _cooc_cls_kernel (cls; B2) and :365 _cooc_clsb_kernel (clsb; B3).  X has
// exactly one 1 per feature in each row, so G is a pair histogram: a row of
// class c adds one to G at (w(f1, b1, c), w(f2, b2, c)) for every feature
// pair f1 ≤ f2, F·(F+1)/2 increments in all.  The TPU multiplies the dense
// one-hots on its MXU; here no one-hot exists.  The layouts differ only in
// where a cell lands, and every address is affine in (feature, bin) plus a
// class offset, which the wrapper passes in (ops/hist.py pair_layout):
//
//   G's matrix  c·gmat         (cls, clsb: gmat = wp², one gram per class)
//   lane        c·cs + f·fs + b·bs
//     fmaj  w = f·jcp + b·C + c     cs = 1, fs = jcp, bs = C, gmat = 0
//     jmaj  w = (b·C + c)·F + f     cs = F, fs = 1, bs = C·F, gmat = 0
//     cls   w = b·F + f             cs = 0, fs = 1, bs = F, gmat = wp²
//
// both axes of G with the same map, so G keeps the layout of plan() and
// w_index() and counts_from_cooc reads it unchanged.  Three launches on one
// stream:
//   1. class_count_kernel   counts[c] = rows whose label is c (valid labels);
//   2. class_scatter_kernel groups the rows by class (a counting sort): each
//      row gets a position inside its class's range, and its codes are
//      copied there as int16 (−1 for a code outside [0, B)), so the pair
//      pass reads each class's rows contiguously and coalesced;
//   3. pair_kernel          one block per task and row split.  A task
//      (ops/hist.py pair_plan, handed over as an int32 table) is one class,
//      one feature f1, a run of features f2 ≥ f1 and a band of f1's bins;
//      its int32 table [run, band, B] lives in dynamic shared memory.  The
//      block streams the codes of its rows once, adds one to the (bin of f1,
//      bin of f2) cell of each f2 with a shared-memory atomic, then writes
//      the table to G and its mirror: plain stores where one block owns
//      the class's whole row range, atomicAdd where rows are split.  The
//      grid runs every task of a row split before the next split, so the
//      blocks in flight read the same rows and find them in L2.
//
// Each thread takes eight consecutive rows per step, one 16-byte load of
// int16 codes per feature (sorted's rows are padded to a multiple of 8),
// all loaded before the step's atomics: an eighth of the load instructions
// of one row per thread, which measured more than twice as fast (PERF.md).
// A table row has a stride ≡ 8 (mod 32), so that the cells a warp adds
// spread over the 32 banks also where codes cluster in stripes, as the
// tree's disjoint packs do.  Skew: where the table is small, each warp
// group adds into its own copy (`copies`), as cross.cu does; combining the
// lanes that share a cell (a ballot) before the atomic measured slower on
// an H100 than plain atomics, skewed codes included (PERF.md).
//
// Bounds on an H100 SXM: the function reads the codes and labels once
// (4·F·n + 4·n bytes) and writes G once; e.g. the wide tree's K = 8 level
// (30 features × 128 joint bins × 2 classes, clsb, wp 3840) at 1M rows,
// ~242 MB, 0.072 ms at 3.35 TB/s, or a hospital MI chunk (10 × 13 × 2,
// fmaj, wp 384, 250K rows) 11.6 MB, 0.0035 ms.  The increments (465 and 55
// a row) are shared-memory atomics, far below what the dense product of
// the one-hots would cost (1.5e13 and 7.2e9 int8 operations at K = 8 and
// the chunk).  So the gram is bound by bytes; its time goes to the atomics
// and to the code reads from L2 (PERF.md).
//
// Drop-invalid contract (pallas_hist.py:346-349, 387-390, and the fmaj/jmaj
// kernel's): a code outside [0, B) drops its cell, a label outside [0, C)
// drops the whole row, rows past n are never read, and pad rows and
// columns of G (fmaj's jc ≤ j < jcp, wp's tail) stay exactly 0.  The caller
// keeps n < 2^24, so int32 counts are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CLASSES = 1024;  // C ≤ 768 in fmaj/jmaj (wp ≤ 768), ≤ 16 in cls/clsb
constexpr int SORT_THREADS = 256;
constexpr int SORT_ROWS = 8;        // rows per thread in the scatter pass

// counts[c] += rows of this grid-stride range whose label is c.
__global__ void __launch_bounds__(SORT_THREADS)
class_count_kernel(const int* labels, int n, int nclass, int* counts) {
  __shared__ int s[MAX_CLASSES];
  for (int c = threadIdx.x; c < nclass; c += SORT_THREADS) s[c] = 0;
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
  for (int c = threadIdx.x; c < nclass; c += SORT_THREADS)
    if (s[c]) atomicAdd(counts + c, s[c]);
}

// Row i of class y goes to position off[y] + (its rank among class-y rows);
// its F codes are copied to sorted[f·ns + position] (ns = n rounded up to
// 8, so that every feature's codes start 16-byte aligned).  A block takes
// SORT_THREADS·SORT_ROWS consecutive rows and reserves one range per class
// with one atomicAdd on cursor[y]; the order inside a class is free, since
// the gram is an integer sum.
__global__ void __launch_bounds__(SORT_THREADS)
class_scatter_kernel(const int* codes, const int* labels, int f, int n, int ns,
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
  for (int c = threadIdx.x; c < nclass; c += SORT_THREADS) blk[c] = 0;
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
  for (int c = threadIdx.x; c < nclass; c += SORT_THREADS)
    if (blk[c]) blk[c] = off[c] + atomicAdd(cursor + c, blk[c]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROWS; ++r) {
    if (ys[r] < 0) continue;
    const int i = row0 + r * SORT_THREADS + threadIdx.x;
    const size_t pos = blk[ys[r]] + rank[r];
    for (int ff = 0; ff < f; ++ff) {
      const int code = __ldg(codes + (size_t)ff * n + i);
      sorted[(size_t)ff * ns + pos] =
          static_cast<int16_t>(code >= 0 && code < nbins ? code : -1);
    }
  }
}

constexpr int PAIR_THREADS = 512;
constexpr int PAIR_VEC = 8;         // rows per thread and step: one 16-byte load
constexpr int PAIR_RUN = 8;         // f2 per task at most (PAIR_RUN in ops/hist.py)
constexpr int TASK_INTS = 6;        // (class, f1, f2 first, f2 count, band first, band bins)

struct Params {
  const int16_t* sorted;   // [F, ns] class-grouped codes, −1 = dropped cell
  const int* counts;       // [C] rows per class
  const int* tasks;        // [ntasks, TASK_INTS]
  int* g;                  // G int32, zeroed by the caller
  int ns, nbins, wp, splits, copies;
  int gmat, cs, fs, bs;    // the store map: matrix c·gmat, lane c·cs + f·fs + b·bs
};

__global__ void __launch_bounds__(PAIR_THREADS) pair_kernel(const Params p) {
  extern __shared__ int table[];                // copies × [run][band][bs]
  const int* t = p.tasks + (size_t)blockIdx.x * TASK_INTS;
  const int cls = t[0], f1 = t[1], f2a = t[2], nf2 = t[3], b1a = t[4],
            nb1 = t[5];
  // a row stride ≡ 8 (mod 32): consecutive bins of f1 step 8 banks, so the
  // cells of a block-diagonal pack (the tree's members) use all 32 banks
  const int bs = p.nbins + ((8 - p.nbins) & 31);
  const int cells = nf2 * nb1 * bs;
  for (int i = threadIdx.x; i < p.copies * cells; i += PAIR_THREADS)
    table[i] = 0;

  // this split's share of the class's rows in the sorted order
  int start = 0;
  for (int c = 0; c < cls; ++c) start += __ldg(p.counts + c);
  const int cnt = __ldg(p.counts + cls);
  const int per = (cnt + p.splits - 1) / p.splits;
  const int r0 = start + min(cnt, (int)blockIdx.y * per);
  const int r1 = start + min(cnt, ((int)blockIdx.y + 1) * per);
  __syncthreads();

  int* h = table + ((threadIdx.x / 32) % p.copies) * cells;
  const int16_t* c1p = p.sorted + (size_t)f1 * p.ns;
  const int16_t* c2p = p.sorted + (size_t)f2a * p.ns;
  // eight rows per thread and step: one 16-byte load of eight int16 codes
  // per feature, rows outside [r0, r1) masked
  for (int base = r0 & ~(PAIR_VEC - 1); base < r1;
       base += PAIR_THREADS * PAIR_VEC) {
    const int i8 = base + threadIdx.x * PAIR_VEC;
    if (i8 >= r1) continue;
    int b1[PAIR_VEC];
    const uint4 u1 = __ldg(reinterpret_cast<const uint4*>(c1p + i8));
    const unsigned w1[4] = {u1.x, u1.y, u1.z, u1.w};
    bool any = false;
#pragma unroll
    for (int e = 0; e < PAIR_VEC; ++e) {
      const int code = static_cast<int16_t>(w1[e / 2] >> (16 * (e % 2)));
      const int i = i8 + e;
      b1[e] = i >= r0 && i < r1 ? code - b1a : -1;   // −1 codes fall out
      if (b1[e] < 0 || b1[e] >= nb1) b1[e] = -1;
      any |= b1[e] >= 0;
    }
    if (!any) continue;
    uint4 u2[PAIR_RUN];
#pragma unroll
    for (int r = 0; r < PAIR_RUN; ++r)
      if (r < nf2)
        u2[r] = __ldg(reinterpret_cast<const uint4*>(c2p + (size_t)r * p.ns + i8));
#pragma unroll
    for (int r = 0; r < PAIR_RUN; ++r) {
      if (r >= nf2) break;
      const unsigned w2[4] = {u2[r].x, u2[r].y, u2[r].z, u2[r].w};
#pragma unroll
      for (int e = 0; e < PAIR_VEC; ++e) {
        const int code = static_cast<int16_t>(w2[e / 2] >> (16 * (e % 2)));
        if (b1[e] >= 0 && code >= 0)
          atomicAdd(h + (r * nb1 + b1[e]) * bs + code, 1);
      }
    }
  }
  __syncthreads();

  int* gc = p.g + (size_t)cls * p.gmat;
  const int lane0 = cls * p.cs;
  for (int x = threadIdx.x; x < cells; x += PAIR_THREADS) {
    int v = 0;
    for (int k = 0; k < p.copies; ++k) v += table[k * cells + x];
    if (v == 0) continue;
    const int b2 = x % bs, rest = x / bs;     // b2 < B wherever v != 0
    const int f2 = f2a + rest / nb1, b1 = b1a + rest % nb1;
    const size_t w1 = lane0 + f1 * p.fs + b1 * p.bs;
    const size_t w2 = lane0 + f2 * p.fs + b2 * p.bs;
    // the diagonal pair f1 = f2 holds only (b, b) cells, its own mirror
    if (p.splits == 1) {
      gc[w1 * p.wp + w2] = v;
      if (f2 != f1) gc[w2 * p.wp + w1] = v;
    } else {
      atomicAdd(gc + w1 * p.wp + w2, v);
      if (f2 != f1) atomicAdd(gc + w2 * p.wp + w1, v);
    }
  }
}

}  // namespace

// The per-block dynamic shared memory the pair pass may take on the current
// device (its opt-in limit), in bytes; the plan sizes its tables by it.
extern "C" int cooc_pair_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

// Adds the gram of n rows into g (zeroed by the caller) on `stream`, each
// cell (f1, b1, f2, b2) of class c at row c·gmat/wp + lane(f1, b1) and
// column lane(f2, b2) of the [wp, wp] matrix, and at its mirror, with
// lane(f, b) = c·cs + f·fs + b·bs.  scratch is 2·nclass int32 (class
// counts, then cursors), zeroed by the caller; sorted is [f, ns] int16
// scratch, ns = n rounded up to 8; tasks is the device copy of pair_plan's
// [ntasks, 6] int32 table, each task run `splits` times over a share of its
// class's rows with `copies` tables of at most `cells` ints each.
// nclass ≤ MAX_CLASSES.  Returns the first CUDA error that is not cudaSuccess,
// else 0.
extern "C" int cooc_pair_gram(const int* codes, const int* labels, int* g,
                              int* scratch, int16_t* sorted, const int* tasks,
                              int f, int n, int nbins, int nclass, int wp,
                              int ntasks, int splits, int copies, int cells,
                              int gmat, int cs, int fs, int bs, void* stream) {
  if (n <= 0) return 0;
  const long long lane_max = (long long)(nclass - 1) * cs +
                             (long long)(f - 1) * fs +
                             (long long)(nbins - 1) * bs;
  if (nclass < 1 || nclass > MAX_CLASSES || ntasks < 1 || splits < 1 ||
      splits > 65535 || copies < 1 || cells < 1 || f < 1 || nbins < 1 ||
      cs < 0 || fs < 1 || bs < 1 || lane_max >= wp ||
      (gmat != 0 && gmat < wp * wp))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* counts = scratch;
  int* cursor = scratch + nclass;

  const int count_blocks = min((n + SORT_THREADS - 1) / SORT_THREADS, 1024);
  class_count_kernel<<<count_blocks, SORT_THREADS, 0, st>>>(labels, n, nclass,
                                                           counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ns = (n + 7) / 8 * 8;   // sorted's row stride
  const int per_block = SORT_THREADS * SORT_ROWS;
  class_scatter_kernel<<<(n + per_block - 1) / per_block, SORT_THREADS, 0,
                         st>>>(codes, labels, f, n, ns, nbins, nclass,
                               counts, cursor, sorted);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Params p;
  p.sorted = sorted;
  p.counts = counts;
  p.tasks = tasks;
  p.g = g;
  p.ns = ns;
  p.nbins = nbins;
  p.wp = wp;
  p.splits = splits;
  p.copies = copies;
  p.gmat = gmat;
  p.cs = cs;
  p.fs = fs;
  p.bs = bs;
  const size_t smem = (size_t)copies * cells * sizeof(int);
  err = cudaFuncSetAttribute(pair_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_kernel<<<dim3(ntasks, splits), PAIR_THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
