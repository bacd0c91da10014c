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
//   - the TPU's sequential grid axis becomes a loop inside the block, split
//     over a second grid axis: a block owns BM query rows and a range of
//     whole 128-row reference tiles (ops/knn.py topk_splits picks the
//     number of ranges S so that the grid fills the card);
//   - each block keeps the kk best of its range and, where S > 1, writes
//     them to a scratch [S, m, kk] pair; merge_kernel then merges the S
//     sorted lists of a row with one warp.  The indices of range s all
//     precede those of range s + 1, so the lower index of a tie stays;
//   - reference chunks (128 rows × 64 bf16) are double-buffered with
//     cp.async, so chunk t + 1 loads while chunk t runs the MMAs and, at a
//     tile's end, the filter; only the first wc columns are contracted,
//     the schema's used lanes rounded up to 64 (knn_dot.cuh);
//   - the block's query rows are resident in shared memory (BM = 32, 16
//     warps) up to W = 1024, else streamed beside each reference chunk
//     (BM = 64, 8 warps with a wider warp tile), so that more MMA work
//     rides on each staged chunk;
//   - each d² tile comes from mma.sync (knn_dot.cuh) and is written to
//     shared memory; a warp then takes BM / warps rows and tests every d²
//     of the tile against the row's slot kk − 1, kept in a register (one
//     compare per element);
//   - a row's list is P = 32·NJ slots in the warp's registers (NJ = 1, 2
//     or 4 by kk).  The candidates that pass are appended to a buffer in
//     shared memory; when it is full the warp sorts it (a bitonic network
//     over shuffles) and merges it into the list by one bitonic merge, so
//     that a row's kk·(1 + ln(n / kk)) candidates cost a sort per buffer
//     and not a ballot and a shift each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "knn_dot.cuh"

namespace {

constexpr int SLOTS = 128;          // output slots per row
// Threads of a block: 16 warps where the queries are resident (the list
// work dominates: more warps filter side by side), 8 where they are
// streamed (the MMAs dominate: a wider warp tile reads fewer fragments).
__host__ __device__ constexpr int threads_for(bool resident) {
  return resident ? 512 : 256;
}
constexpr int SB = knn::KC + knn::KPAD;   // bf16 per staged chunk row
constexpr int DSTRIDE = knn::BN + 4;      // floats per d² row in shared memory
constexpr int MERGE_THREADS = 256;  // merge_kernel: a warp per row
constexpr int MAX_SPLITS = 32;      // lists one merge warp takes (TOPK_MAX_SPLITS in ops/knn.py)
constexpr float BIG = 3.0e30f;      // empty slot (ops/knn.py's _BIG)

__device__ __forceinline__ bool before(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// A row's sorted list lives in the registers of one warp: slot s = lane +
// 32·j in (vd[j], vi[j]), P = 32·NJ slots ascending by (d², index), the P
// smallest seen; slots ≥ kk are the output's spare.

// Slot kk − 1 of the list, to every lane.
template <int NJ>
__device__ __forceinline__ void list_worst(const float (&vd)[NJ],
                                           const int (&vi)[NJ], int kk,
                                           float& wd, int& wi) {
  const int jk = (kk - 1) / 32;
  float d = vd[0];
  int i = vi[0];
#pragma unroll
  for (int j = 1; j < NJ; ++j)
    if (j == jk) {
      d = vd[j];
      i = vi[j];
    }
  wd = __shfl_sync(0xffffffffu, d, (kk - 1) % 32);
  wi = __shfl_sync(0xffffffffu, i, (kk - 1) % 32);
}

// Compare-exchange of element x = 32·j + lane with element x ^ s inside a
// bitonic network over P = 32·NJ elements held NJ per lane: the lower of
// the two keeps the smaller by (d², index) where `asc`, else the larger.
template <int NJ>
__device__ __forceinline__ void exchange(float (&d)[NJ], int (&i)[NJ], int j,
                                         int s, bool asc, int lane) {
  if (s >= 32) {                    // partner in this lane's register j ^ s/32
    const int j2 = j ^ (s >> 5);
    if (j2 > j) {
      const bool swap = asc ? before(d[j2], i[j2], d[j], i[j])
                            : before(d[j], i[j], d[j2], i[j2]);
      if (swap) {
        const float td = d[j];
        const int ti = i[j];
        d[j] = d[j2];
        i[j] = i[j2];
        d[j2] = td;
        i[j2] = ti;
      }
    }
  } else {                          // partner in lane ^ s
    const float od = __shfl_xor_sync(0xffffffffu, d[j], s);
    const int oi = __shfl_xor_sync(0xffffffffu, i[j], s);
    const bool takemin = ((lane & s) == 0) == asc;
    if (takemin == before(od, oi, d[j], i[j])) {
      d[j] = od;
      i[j] = oi;
    }
  }
}

// Sort P = 32·NJ elements ascending by (d², index): a bitonic network.
template <int NJ>
__device__ __forceinline__ void bitonic_sort(float (&d)[NJ], int (&i)[NJ],
                                             int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * NJ; k <<= 1)
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        exchange<NJ>(d, i, j, s, ((32 * j + lane) & k) == 0, lane);
}

// Merge the `cnt` candidates buffered for a row (shared memory) into its
// sorted list of P = 32·NJ entries, keeping the P smallest: sort the
// candidates, take the element-wise least of the list and the reversed
// candidates (a bitonic sequence of the P smallest), sort that by a
// bitonic merge.  Then refresh the row's slot kk − 1.  Whole warp.
template <int NJ>
__device__ __forceinline__ void flush(float (&vd)[NJ], int (&vi)[NJ],
                                      const float* bd, const int* bi,
                                      int& cnt, int kk, float& wd, int& wi,
                                      int lane) {
  __syncwarp();                     // the buffer's writes are visible
  float sd[NJ];
  int si[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int x = 32 * j + lane;
    sd[j] = x < cnt ? bd[x] : INFINITY;
    si[j] = x < cnt ? bi[x] : INT_MAX;
  }
  __syncwarp();                     // read before the buffer is refilled
  bitonic_sort<NJ>(sd, si, lane);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {    // candidate P − 1 − x sits in register
    const float rd = __shfl_sync(0xffffffffu, sd[NJ - 1 - j], 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, si[NJ - 1 - j], 31 - lane);
    if (before(rd, ri, vd[j], vi[j])) {   // NJ − 1 − j, lane 31 − lane
      vd[j] = rd;
      vi[j] = ri;
    }
  }
#pragma unroll
  for (int s = 16 * NJ; s > 0; s >>= 1)
#pragma unroll
    for (int j = 0; j < NJ; ++j) exchange<NJ>(vd, vi, j, s, true, lane);
  list_worst<NJ>(vd, vi, kk, wd, wi);
  cnt = 0;
}

constexpr int RESIDENT_MAX_W = 1024;  // widest operand whose queries stay resident
constexpr int STAGES = 2;           // reference chunks in flight

// Shared-memory bytes of a block: its query rows (resident: all W columns;
// streamed: one staged chunk per stage), one staged reference chunk per
// stage, the d² tile and each row's buffer of 32·nj candidates.
inline size_t topk_smem(int bm, bool resident, int w, int nj) {
  return (size_t)bm * (resident ? w + knn::KPAD : STAGES * SB) * 2 +
         (size_t)STAGES * knn::BN * SB * 2 +
         (size_t)bm * DSTRIDE * sizeof(float) +
         (size_t)bm * 32 * nj * (sizeof(float) + sizeof(int));
}

// Whether the query rows of a block stay resident in shared memory: up to
// RESIDENT_MAX_W columns, where they fit the device's per-block limit.
// Wider operands stream their queries beside the references, 64 rows per
// block, which stages fewer bytes per multiply than 32 resident rows.
inline bool topk_resident(int w) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return w <= RESIDENT_MAX_W &&
         topk_smem(32, true, w, SLOTS / 32) <= (size_t)limit;
}

template <int BM, bool RESIDENT, int NJ>
__global__ void __launch_bounds__(threads_for(RESIDENT), RESIDENT ? 1 : 2)
    topk_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, float* out_d, int* out_i,
                float* part_d, int* part_i, int m, int n, int w, int wc,
                int kk, int tiles_per) {
  constexpr int TT = threads_for(RESIDENT);
  constexpr int WARPS = TT / 32;
  constexpr int MI = BM / 16;
  constexpr int NI = knn::BN / (8 * WARPS);   // warp tile BM × 8·NI
  constexpr int RPW = BM / WARPS;   // rows per warp
  constexpr int NS = STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int t0 = split * tiles_per;
  const int t1 = min(n / knn::BN, t0 + tiles_per);
  const int qstride = RESIDENT ? w + knn::KPAD : SB;
  constexpr int QSTAGE = BM * SB;   // bf16 per staged query chunk
  constexpr int BSTAGE = knn::BN * SB;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = Qs + (RESIDENT ? BM * qstride : NS * QSTAGE);
  float* D = reinterpret_cast<float*>(Bs + NS * BSTAGE);
  constexpr int P = 32 * NJ;        // list slots and buffered candidates
  float* Bd = D + BM * DSTRIDE;     // [BM][P] candidates not yet merged
  int* Bi = reinterpret_cast<int*>(Bd + BM * P);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp * (NI * 8);
  const __nv_bfloat16* ag = a + (size_t)row0 * w;
  if (RESIDENT)
    for (int i = threadIdx.x; i < BM * (w / 8); i += TT) {
      const int r = i / (w / 8), c = (i % (w / 8)) * 8;
      *reinterpret_cast<uint4*>(Qs + r * qstride + c) =
          __ldg(reinterpret_cast<const uint4*>(ag + (size_t)r * w + c));
    }
  float vd[RPW][NJ];                // the warp's rows' lists, in registers
  int vi[RPW][NJ];
  float wd[RPW];                    // each row's slot kk − 1
  int wi[RPW];
  int cnt[RPW];                     // each row's buffered candidates
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    wd[rr] = INFINITY;
    wi[rr] = INT_MAX;
    cnt[rr] = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      vd[rr][j] = INFINITY;
      vi[rr][j] = INT_MAX;
    }
  }

  const int kchunks = wc / knn::KC;   // the contracted columns
  const int nchunks = (t1 - t0) * kchunks;
  auto issue = [&](int j) {
    const int t = t0 + j / kchunks, kc = (j % kchunks) * knn::KC;
    knn::issue_rows<TT>(Bs + (j % NS) * BSTAGE, SB,
                        b + (size_t)t * knn::BN * w + kc, w, knn::BN, knn::KC);
    if (!RESIDENT)
      knn::issue_rows<TT>(Qs + (j % NS) * QSTAGE, SB, ag + kc, w, BM, knn::KC);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nchunks) issue(s);
    knn::cp_async_commit();
  }
  for (int j = 0; j < nchunks; ++j) {
    knn::cp_async_wait<NS - 2>();
    // chunk j (and resident queries) visible to all; every warp is done
    // with chunk j − 1, whose stage chunk j + NS − 1 now takes
    __syncthreads();
    if (j + NS - 1 < nchunks) issue(j + NS - 1);
    knn::cp_async_commit();
    const int kc = (j % kchunks) * knn::KC;
    const __nv_bfloat16* bs = Bs + (j % NS) * BSTAGE;
    if (RESIDENT)
      knn::warp_mma<MI, NI>(acc, Qs, qstride, kc, bs, SB, 0, wn, knn::KC);
    else
      knn::warp_mma<MI, NI>(acc, Qs + (j % NS) * QSTAGE, SB, 0, bs, SB, 0, wn,
                            knn::KC);
    if (j % kchunks != kchunks - 1) continue;

    // a whole tile: d² to shared memory, then every row's filter
    const int c0 = (t0 + j / kchunks) * knn::BN;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          D[(mi * 16 + gq + 8 * (e >> 1)) * DSTRIDE + wn + ni * 8 + 2 * tq +
            (e & 1)] = acc[mi][ni][e];
          acc[mi][ni][e] = 0.f;
        }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
#pragma unroll
      for (int q = 0; q < knn::BN / 32; ++q) {
        const int c = lane + 32 * q;
        const float d = D[r * DSTRIDE + c];
        bool pass = before(d, c0 + c, wd[rr], wi[rr]);
        unsigned m = __ballot_sync(0xffffffffu, pass);
        if (cnt[rr] + __popc(m) > P) {          // the buffer is full: merge
          flush<NJ>(vd[rr], vi[rr], Bd + r * P, Bi + r * P, cnt[rr], kk,
                    wd[rr], wi[rr], lane);
          pass = before(d, c0 + c, wd[rr], wi[rr]);
          m = __ballot_sync(0xffffffffu, pass);
        }
        if (pass) {
          const int at = cnt[rr] + __popc(m & ((1u << lane) - 1u));
          Bd[r * P + at] = d;
          Bi[r * P + at] = c0 + c;
        }
        cnt[rr] += __popc(m);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
    if (cnt[rr])
      flush<NJ>(vd[rr], vi[rr], Bd + (warp * RPW + rr) * P,
                Bi + (warp * RPW + rr) * P, cnt[rr], kk, wd[rr], wi[rr], lane);

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = row0 + warp * RPW + rr;
    if (gridDim.y == 1) {
#pragma unroll
      for (int j = 0; j < SLOTS / 32; ++j) {
        const int s = lane + 32 * j;
        const bool kept = j < NJ && s < kk && vi[rr][j < NJ ? j : 0] != INT_MAX;
        const size_t o = (size_t)row * SLOTS + s;
        out_d[o] = kept ? vd[rr][j < NJ ? j : 0] : BIG;
        out_i[o] = kept ? vi[rr][j < NJ ? j : 0] : -1;
      }
    } else {
      const size_t o = ((size_t)split * m + row) * kk;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (lane + 32 * j < kk) {
          part_d[o + lane + 32 * j] = vd[rr][j];
          part_i[o + lane + 32 * j] = vi[rr][j];
        }
    }
  }
}

// One warp per query row: the kk smallest by (d², index) of the row's S
// sorted lists [S, m, kk]; lane s holds the head of list s.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* out_d, int* out_i,
                 int m, int kk, int splits) {
  const int row = blockIdx.x * (MERGE_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;                       // the whole warp together
  const size_t base = ((size_t)lane * m + row) * kk;
  int pos = 0;
  float hd = lane < splits ? part_d[base] : INFINITY;
  int hi = lane < splits ? part_i[base] : INT_MAX;
  float md[SLOTS / 32];             // slot t is kept by lane t % 32
  int mx[SLOTS / 32];
#pragma unroll
  for (int q = 0; q < SLOTS / 32; ++q) {
    md[q] = BIG;
    mx[q] = -1;
  }
  for (int t = 0; t < kk; ++t) {
    float bd = hd;
    int bi = hi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    // indices are unique across the lists: the winner's head is the least
    if (bi != INT_MAX && lane == (t & 31)) {
#pragma unroll
      for (int q = 0; q < SLOTS / 32; ++q)
        if (q == t / 32) {
          md[q] = bd;
          mx[q] = bi;
        }
    }
    if (hi == bi && hd == bd && hi != INT_MAX) {
      ++pos;
      hd = pos < kk ? part_d[base + pos] : INFINITY;
      hi = pos < kk ? part_i[base + pos] : INT_MAX;
    }
  }
#pragma unroll
  for (int q = 0; q < SLOTS / 32; ++q) {
    const size_t o = (size_t)row * SLOTS + lane + 32 * q;
    out_d[o] = md[q];
    out_i[o] = mx[q];
  }
}

// The kernel for (BM, RESIDENT, NJ) with its shared memory set; *smem its
// bytes.  Returns the CUDA error of the attribute call.
template <int BM, bool RESIDENT, int NJ>
cudaError_t prepare(int w, size_t* smem) {
  *smem = topk_smem(BM, RESIDENT, w, NJ);
  return cudaFuncSetAttribute(topk_kernel<BM, RESIDENT, NJ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// Blocks of topk_kernel that one SM holds at once for this w and kk.
template <int BM, bool RESIDENT, int NJ>
int occupancy(int w) {
  size_t smem = 0;
  int blocks = 0;
  if (prepare<BM, RESIDENT, NJ>(w, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, topk_kernel<BM, RESIDENT, NJ>, threads_for(RESIDENT),
          smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

template <int BM, bool RESIDENT, int NJ>
int launch(const void* a, const void* b, float* out_d, int* out_i,
           float* part_d, int* part_i, int m, int n, int w, int wc,
           int kk, int splits, int tiles_per, cudaStream_t st) {
  auto kernel = topk_kernel<BM, RESIDENT, NJ>;
  size_t smem = 0;
  cudaError_t err = prepare<BM, RESIDENT, NJ>(w, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(m / BM, splits), threads_for(RESIDENT), smem, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), out_d, out_i, part_d, part_i, m,
      n, w, wc, kk, tiles_per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  constexpr int ROWS = MERGE_THREADS / 32;
  merge_kernel<<<(m + ROWS - 1) / ROWS, MERGE_THREADS, 0, st>>>(
      part_d, part_i, out_d, out_i, m, kk, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool RESIDENT>
int launch_kk(const void* a, const void* b, float* out_d, int* out_i,
              float* part_d, int* part_i, int m, int n, int w, int wc,
              int kk, int splits, int tiles_per, cudaStream_t st) {
  if (m % BM) return cudaErrorInvalidValue;
  // list registers per lane: a power of two, for the bitonic network
  if (kk <= 32)
    return launch<BM, RESIDENT, 1>(a, b, out_d, out_i, part_d, part_i, m, n,
                                   w, wc, kk, splits, tiles_per, st);
  if (kk <= 64)
    return launch<BM, RESIDENT, 2>(a, b, out_d, out_i, part_d, part_i, m, n,
                                   w, wc, kk, splits, tiles_per, st);
  return launch<BM, RESIDENT, 4>(a, b, out_d, out_i, part_d, part_i, m, n, w,
                                 wc, kk, splits, tiles_per, st);
}

template <int BM, bool RESIDENT>
int occupancy_kk(int w, int kk) {
  return kk <= 32 ? occupancy<BM, RESIDENT, 1>(w)
                  : kk <= 64 ? occupancy<BM, RESIDENT, 2>(w)
                             : occupancy<BM, RESIDENT, 4>(w);
}

}  // namespace

// Query rows per block for operands of width w: 32 where the rows stay
// resident in shared memory, else 64 (streamed).
extern "C" int knn_topk_rows_per_block(int w) {
  return topk_resident(w) ? 32 : 64;
}

// Blocks of the top-kk kernel one SM holds at once for operands of width w
// and kk slots on the current device (0 where it cannot tell).
extern "C" int knn_topk_blocks_per_sm(int w, int kk) {
  return topk_resident(w) ? occupancy_kk<32, true>(w, kk)
                          : occupancy_kk<64, false>(w, kk);
}

// Writes out_d [m, 128] float32 and out_i [m, 128] int32 for a [m, w] and
// b [n, w] bf16 on `stream`, contracting the first wc columns (those past
// the schema's used lanes are zero in both operands).  The 128-row
// reference tiles are cut into `splits` ranges of tiles_per tiles (the last
// may be shorter); where splits > 1, part_d / part_i are [splits, m, kk]
// scratch for the ranges' lists, which a second kernel merges.  Requires m
// a multiple of knn_topk_rows_per_block(w), n % 128 == 0, w % 64 == 0,
// wc % 64 == 0 with 0 < wc ≤ w, 1 ≤ kk ≤ 128 and 1 ≤ splits ≤ 32 with
// (splits − 1)·tiles_per < n / 128 ≤ splits·tiles_per.  Returns the first
// CUDA error that is not cudaSuccess, else 0.
extern "C" int knn_topk(const void* a, const void* b, float* out_d,
                        int* out_i, float* part_d, int* part_i, int m, int n,
                        int w, int wc, int kk, int splits, int tiles_per,
                        void* stream) {
  if (m <= 0) return 0;
  const int tiles = n / knn::BN;
  if (n <= 0 || n % knn::BN || w <= 0 || w % knn::KC || wc <= 0 ||
      wc % knn::KC || wc > w || kk < 1 ||
      kk > SLOTS || splits < 1 || splits > MAX_SPLITS || tiles_per < 1 ||
      (long long)(splits - 1) * tiles_per >= tiles ||
      (long long)splits * tiles_per < tiles ||
      (splits > 1 && (part_d == nullptr || part_i == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (topk_resident(w))
    return launch_kk<32, true>(a, b, out_d, out_i, part_d, part_i, m, n, w,
                               wc, kk, splits, tiles_per, st);
  return launch_kk<64, false>(a, b, out_d, out_i, part_d, part_i, m, n, w,
                              wc, kk, splits, tiles_per, st);
}
