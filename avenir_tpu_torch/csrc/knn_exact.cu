// Exact top-k of a few query rows against every reference: the rows whose
// certificate the kNN kernel route refuses (models/knn.py
// _nearest_neighbors_kernel), served in one pass over the reference set.
//
// Replaces no TPU kernel.  The JAX package serves such a row by its exact
// scan, written in jnp (avenir_tpu/models/knn.py, _nearest_neighbors_xla);
// the port ran the same tile scan in PyTorch, 16 tiles of 65,536
// references each with a stable sort of a 65K-wide row, hundreds of small
// launches for two or three rows.  This kernel computes the answer itself.
//
// What it computes, for each query row q and reference i: the d² of
// ops/knn.py::rerank_d2, bit for bit.  acc = (double) mismatches; for each
// continuous feature j in order, diff = q_j − r_j in float32 and
// acc += (double) diff · (double) diff in float64, with __dmul_rn and
// __dadd_rn so that nothing is contracted into a fused multiply-add;
// d² = acc rounded once to float32.  d² ≥ +0, so the key
// (bits(d²) << 32) | i orders as (d², index) and is unique: the k least
// keys are the answer whatever order they are found in, with no float32
// pre-selection, margin or re-rank.
//
// Bounds on an H100 SXM: the references are read once per 8 query rows,
// N·(F + Fc)·4 bytes — 36 MB at the elearn shape (1M × 9 continuous),
// 0.011 ms at 3.35 TB/s; the float64 work is R·N·Fc products and sums,
// nothing at a few rows (2.7e7 at R = 3) and the bound at thousands
// (R = 4,096: 7.4e10, ~2.2 ms at 34 TFLOP/s fp64, besides as many
// float32 → float64 conversions).  The design:
//   - a block takes 8 query rows (grid y; a loop where there are more
//     chunks than the grid holds) and a range of whole 256-row reference
//     tiles (grid x, `splits` ranges: ops/knn.py exact_splits sizes them
//     so that the grid fills the card at a few rows);
//   - the block's query rows are staged in shared memory; each thread
//     takes one reference of a tile, reads its features once and computes
//     its key against all 8 rows into a [8][256] key tile in shared memory;
//   - warp w then filters row w's 256 keys against the row's running k-th
//     key, held in a register; the few that pass are appended to a buffer
//     of 32·NJ keys, which, when full, is sorted by a bitonic network over
//     shuffles and merged into the row's sorted list of 32·NJ keys in the
//     warp's registers (NJ = 1, 2 or 4 by k), as knn_topk.cu merges;
//   - with one range the block writes the row's answer, unpacked to
//     (d² float32, index int64); with several it writes its k keys to a
//     scratch [R, splits, k] and merge_kernel keeps each row's k least:
//     8 warps each filter a share of the row's splits·k keys the same way,
//     then warp 0 merges their 8 lists.  Two launches at most, no host
//     synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int QC = 8;               // query rows a block takes: a warp each
constexpr int THREADS = 32 * QC;    // a block's threads
constexpr int TILE = THREADS;       // references a step: one a thread
constexpr int SLOTS = 128;          // the most k
constexpr int MAX_GRID_Y = 65535;
constexpr u64 NONE = ~0ull;         // an empty slot: above every key

// A row's sorted list lives in the registers of one warp: slot s = lane +
// 32·j in v[j], P = 32·NJ slots ascending, the P least keys seen.

// Slot s of the list (s the same in every lane), to every lane.
template <int NJ>
__device__ __forceinline__ u64 list_at(const u64 (&v)[NJ], int s) {
  const int js = s / 32;
  u64 x = v[0];
#pragma unroll
  for (int j = 1; j < NJ; ++j)
    if (j == js) x = v[j];
  return __shfl_sync(0xffffffffu, x, s % 32);
}

// Compare-exchange of element x = 32·j + lane with element x ^ s inside a
// bitonic network over P = 32·NJ elements held NJ per lane: the lower of
// the two keeps the smaller where `asc`, else the larger.
template <int NJ>
__device__ __forceinline__ void exchange(u64 (&v)[NJ], int j, int s, bool asc,
                                         int lane) {
  if (s >= 32) {                    // partner in this lane's register j ^ s/32
    const int j2 = j ^ (s >> 5);
    if (j2 > j) {
      const bool swap = asc ? v[j2] < v[j] : v[j] < v[j2];
      if (swap) {
        const u64 t = v[j];
        v[j] = v[j2];
        v[j2] = t;
      }
    }
  } else {                          // partner in lane ^ s
    const u64 o = __shfl_xor_sync(0xffffffffu, v[j], s);
    const bool takemin = ((lane & s) == 0) == asc;
    if (takemin == (o < v[j])) v[j] = o;
  }
}

// Sort P = 32·NJ keys ascending: a bitonic network.
template <int NJ>
__device__ __forceinline__ void bitonic_sort(u64 (&v)[NJ], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * NJ; k <<= 1)
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        exchange<NJ>(v, j, s, ((32 * j + lane) & k) == 0, lane);
}

// Merge the `cnt` keys buffered for a row (shared memory) into its sorted
// list, keeping the P least: sort the buffer, take the element-wise least
// of the list and the reversed buffer (a bitonic sequence of the P least),
// sort that by a bitonic merge; then refresh the row's slot k − 1.  Whole
// warp.
template <int NJ>
__device__ __forceinline__ void flush(u64 (&v)[NJ], const u64* buf, int& cnt,
                                      int k, u64& thr, int lane) {
  __syncwarp();                     // the buffer's writes are visible
  u64 c[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int x = 32 * j + lane;
    c[j] = x < cnt ? buf[x] : NONE;
  }
  __syncwarp();                     // read before the buffer is refilled
  bitonic_sort<NJ>(c, lane);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {    // buffered key P − 1 − x sits in register
    const u64 r = __shfl_sync(0xffffffffu, c[NJ - 1 - j], 31 - lane);
    if (r < v[j]) v[j] = r;         // NJ − 1 − j, lane 31 − lane
  }
#pragma unroll
  for (int s = 16 * NJ; s > 0; s >>= 1)
#pragma unroll
    for (int j = 0; j < NJ; ++j) exchange<NJ>(v, j, s, true, lane);
  thr = list_at<NJ>(v, k - 1);
  cnt = 0;
}

// Offer one key a lane to the row's list: the keys under its slot k − 1
// are appended to the buffer, which is merged first where it would
// overflow.  Whole warp.
template <int NJ>
__device__ __forceinline__ void offer(u64 key, u64 (&v)[NJ], u64* buf,
                                      int& cnt, int k, u64& thr, int lane) {
  constexpr int P = 32 * NJ;
  bool pass = key < thr;
  unsigned m = __ballot_sync(0xffffffffu, pass);
  if (cnt + __popc(m) > P) {
    flush<NJ>(v, buf, cnt, k, thr, lane);
    pass = key < thr;
    m = __ballot_sync(0xffffffffu, pass);
  }
  if (pass) buf[cnt + __popc(m & ((1u << lane) - 1u))] = key;
  cnt += __popc(m);
}

template <int NJ>
__device__ __forceinline__ void list_reset(u64 (&v)[NJ], int& cnt, u64& thr) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) v[j] = NONE;
  cnt = 0;
  thr = NONE;
}

// Slots [0, k) of the list as (d² float32, index int64) at row `row`.
template <int NJ>
__device__ __forceinline__ void write_row(const u64 (&v)[NJ], int k,
                                          size_t row, float* out_d2,
                                          long long* out_idx, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int s = lane + 32 * j;
    if (s < k) {
      out_d2[row * k + s] = __uint_as_float(static_cast<unsigned>(v[j] >> 32));
      out_idx[row * k + s] = static_cast<long long>(v[j] & 0xffffffffull);
    }
  }
}

// Shared-memory bytes of exact_kernel: the key tile, each row's buffer of
// 32·NJ keys, the staged query rows.
inline size_t exact_smem(int f, int fc, int nj) {
  return (size_t)QC * TILE * sizeof(u64) + (size_t)QC * 32 * nj * sizeof(u64) +
         (size_t)QC * (f + fc) * 4;
}

template <int NJ>
__global__ void __launch_bounds__(THREADS)
    exact_kernel(const int* __restrict__ codes_q,
                 const float* __restrict__ cont_q,
                 const int* __restrict__ codes_r,
                 const float* __restrict__ cont_r, u64* part, float* out_d2,
                 long long* out_idx, int sqc, int sqx, int r, int n, int f,
                 int fc, int k, int per) {
  constexpr int P = 32 * NJ;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* D = reinterpret_cast<u64*>(smem);            // [QC][TILE] keys
  u64* Bf = D + QC * TILE;                          // [QC][P] buffers
  int* Qc = reinterpret_cast<int*>(Bf + QC * P);    // [QC][f]
  float* Qx = reinterpret_cast<float*>(Qc + QC * f);  // [QC][fc]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.x, splits = gridDim.x;
  const long long r0 = (long long)split * per;
  const long long r1 = min((long long)n, r0 + per);
  u64 v[NJ];
  int cnt;
  u64 thr;
  for (int chunk = blockIdx.y; (long long)chunk * QC < r;
       chunk += gridDim.y) {
    const int q0 = chunk * QC;
    const int nq = min(QC, r - q0);
    __syncthreads();                // the last chunk's reads are done
    for (int i = threadIdx.x; i < QC * f; i += THREADS) {
      const int q = i / f, j = i % f;
      Qc[i] = q < nq ? codes_q[(size_t)(q0 + q) * sqc + j] : 0;
    }
    for (int i = threadIdx.x; i < QC * fc; i += THREADS) {
      const int q = i / fc, j = i % fc;
      Qx[i] = q < nq ? cont_q[(size_t)(q0 + q) * sqx + j] : 0.f;
    }
    list_reset<NJ>(v, cnt, thr);
    for (long long t0 = r0; t0 < r1; t0 += TILE) {
      // the staged rows are visible; every warp is done with the last tile
      __syncthreads();
      const long long ref = t0 + threadIdx.x;
      if (ref < r1) {
        int mism[QC];
#pragma unroll
        for (int q = 0; q < QC; ++q) mism[q] = 0;
        const int* cr = codes_r + (size_t)ref * f;
        for (int j = 0; j < f; ++j) {
          const int c = __ldg(cr + j);
#pragma unroll
          for (int q = 0; q < QC; ++q) mism[q] += Qc[q * f + j] != c;
        }
        double acc[QC];
#pragma unroll
        for (int q = 0; q < QC; ++q) acc[q] = (double)mism[q];
        const float* xr = cont_r + (size_t)ref * fc;
        for (int j = 0; j < fc; ++j) {
          const float x = __ldg(xr + j);
#pragma unroll
          for (int q = 0; q < QC; ++q)
            if (q < nq) {
              const double d = (double)__fsub_rn(Qx[q * fc + j], x);
              acc[q] = __dadd_rn(acc[q], __dmul_rn(d, d));
            }
        }
#pragma unroll
        for (int q = 0; q < QC; ++q)
          D[q * TILE + threadIdx.x] =
              ((u64)__float_as_uint(__double2float_rn(acc[q])) << 32) |
              (unsigned)ref;
      } else {
#pragma unroll
        for (int q = 0; q < QC; ++q) D[q * TILE + threadIdx.x] = NONE;
      }
      __syncthreads();
      if (warp < nq)
#pragma unroll
        for (int s = 0; s < TILE / 32; ++s)
          offer<NJ>(D[warp * TILE + 32 * s + lane], v, Bf + warp * P, cnt, k,
                    thr, lane);
    }
    if (warp < nq) {
      if (cnt) flush<NJ>(v, Bf + warp * P, cnt, k, thr, lane);
      const size_t row = (size_t)q0 + warp;
      if (splits == 1) {
        write_row<NJ>(v, k, row, out_d2, out_idx, lane);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int s = lane + 32 * j;
          if (s < k) part[(row * splits + split) * k + s] = v[j];
        }
      }
    }
  }
}

// A block a row: the k least of the row's splits·k keys [R, splits, k].
// Warp w filters keys w·32 + lane + 256·t into its own list; warp 0 then
// merges the 8 lists.
template <int NJ>
__global__ void __launch_bounds__(THREADS)
    merge_kernel(const u64* __restrict__ part, float* out_d2,
                 long long* out_idx, int r, int splits, int k) {
  constexpr int P = 32 * NJ;
  __shared__ u64 Bf[QC][P];
  __shared__ u64 L[QC * SLOTS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int total = splits * k;
  u64 v[NJ];
  int cnt;
  u64 thr;
  for (int row = blockIdx.x; row < r; row += gridDim.x) {
    const u64* src = part + (size_t)row * total;
    list_reset<NJ>(v, cnt, thr);
    for (int base = warp * 32; base < total; base += THREADS) {
      const int e = base + lane;
      offer<NJ>(e < total ? src[e] : NONE, v, Bf[warp], cnt, k, thr, lane);
    }
    if (cnt) flush<NJ>(v, Bf[warp], cnt, k, thr, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < k) L[warp * k + lane + 32 * j] = v[j];
    __syncthreads();
    if (warp == 0) {
      list_reset<NJ>(v, cnt, thr);
      for (int base = 0; base < QC * k; base += 32) {
        const int e = base + lane;
        offer<NJ>(e < QC * k ? L[e] : NONE, v, Bf[0], cnt, k, thr, lane);
      }
      if (cnt) flush<NJ>(v, Bf[0], cnt, k, thr, lane);
      write_row<NJ>(v, k, row, out_d2, out_idx, lane);
    }
    __syncthreads();                // L is read before the next row fills it
  }
}

constexpr size_t SMEM_DEFAULT = 48 * 1024;  // a launch's dynamic shared memory, unasked

// exact_kernel for these features with its shared memory set (asked for
// only above the default, which most schemas stay under); *smem its
// bytes.  Returns the CUDA error of the attribute call.
template <int NJ>
cudaError_t prepare(int f, int fc, size_t* smem) {
  *smem = exact_smem(f, fc, NJ);
  if (*smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(exact_kernel<NJ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int NJ>
int occupancy(int f, int fc) {
  size_t smem = 0;
  int blocks = 0;
  if (prepare<NJ>(f, fc, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, exact_kernel<NJ>, THREADS, smem) != cudaSuccess)
    return 0;
  return blocks;
}

template <int NJ>
int launch(const int* codes_q, const float* cont_q, const int* codes_r,
           const float* cont_r, u64* part, float* out_d2, long long* out_idx,
           int sqc, int sqx, int r, int n, int f, int fc, int k, int splits,
           int per, cudaStream_t st) {
  size_t smem = 0;
  cudaError_t err = prepare<NJ>(f, fc, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (r + QC - 1) / QC;
  exact_kernel<NJ><<<dim3(splits, chunks < MAX_GRID_Y ? chunks : MAX_GRID_Y),
                     THREADS, smem, st>>>(codes_q, cont_q, codes_r, cont_r,
                                          part, out_d2, out_idx, sqc, sqx, r,
                                          n, f, fc, k, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  merge_kernel<NJ><<<r, THREADS, 0, st>>>(part, out_d2, out_idx, r, splits,
                                          k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the exact kernel one SM holds at once for f categorical and fc
// continuous features and k slots on the current device (0 where it
// cannot tell).
extern "C" int knn_exact_blocks_per_sm(int f, int fc, int k) {
  return k <= 32 ? occupancy<1>(f, fc)
                 : k <= 64 ? occupancy<2>(f, fc) : occupancy<4>(f, fc);
}

// Writes out_d2 [r, k] float32 and out_idx [r, k] int64 on `stream`: for
// each query row the k least (d², reference index) over the n references.
// codes_q [r, f] int32 and cont_q [r, fc] float32 have row strides sqc and
// sqx (their columns contiguous); codes_r [n, f] int32 and cont_r [n, fc]
// float32 are contiguous.  The references are cut into `splits` ranges of
// `per` rows (a multiple of 256; the last may be shorter); where
// splits > 1, part is [r, splits, k] uint64 scratch for the ranges' keys,
// which a second kernel merges.  Requires 1 ≤ k ≤ min(128, n) and
// (splits − 1)·per < n ≤ splits·per.  Returns the first CUDA error that
// is not cudaSuccess, else 0.
extern "C" int knn_exact(const void* codes_q, const void* cont_q,
                         const void* codes_r, const void* cont_r, void* part,
                         void* out_d2, void* out_idx, int sqc, int sqx, int r,
                         int n, int f, int fc, int k, int splits, int per,
                         void* stream) {
  if (r <= 0) return 0;
  if (n <= 0 || f < 0 || fc < 0 || k < 1 || k > SLOTS || k > n ||
      splits < 1 || per < TILE || per % TILE ||
      (long long)(splits - 1) * per >= n || (long long)splits * per < n ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto cq = static_cast<const int*>(codes_q);
  auto xq = static_cast<const float*>(cont_q);
  auto cr = static_cast<const int*>(codes_r);
  auto xr = static_cast<const float*>(cont_r);
  auto pt = static_cast<u64*>(part);
  auto od = static_cast<float*>(out_d2);
  auto oi = static_cast<long long*>(out_idx);
  if (k <= 32)
    return launch<1>(cq, xq, cr, xr, pt, od, oi, sqc, sqx, r, n, f, fc, k,
                     splits, per, st);
  if (k <= 64)
    return launch<2>(cq, xq, cr, xr, pt, od, oi, sqc, sqx, r, n, f, fc, k,
                     splits, per, st);
  return launch<4>(cq, xq, cr, xr, pt, od, oi, sqc, sqx, r, n, f, fc, k,
                   splits, per, st);
}
