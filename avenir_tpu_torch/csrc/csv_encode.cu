// A CSV chunk split into fields and encoded on the card: the rows of one
// byte block, each field by the schema's rules, bit for bit the native
// encoder's (runtime/native/csv_encode.cpp, encode_range) on its fast
// paths; ops/csv.py's csv_encode_ref is the plain version, module
// docstring there for the rules and what refuses a chunk.
//
// Replaces no TPU kernel.  The JAX package parses a chunk on the host
// (runtime/native.py, the same C++ encoder) and the TPU receives codes.
// On an H100 host a 1M-row chunk's line read and its encode on one host
// thread took ~0.8 s while the card idled 99.9%; this kernel takes the
// parse to the card, so a chunk crosses the input layer as one byte block
// and its row offsets (jobs/base.py BlockReader).
//
// Bound by bytes on an H100 SXM: the block is read once and the codes,
// labels and continuous values written once — ~75 MB in and ~44 MB out
// for a 1M-row hospital chunk, 0.036 ms at 3.35 TB/s.  The design:
//   - a block of TILE threads takes TILE consecutive rows; it stages the
//     bytes they span (from the 16-byte word holding the first row's start
//     to the one holding the last row's end) in shared memory with
//     coalesced 16-byte loads, so each byte is read from device memory
//     once whatever a row's length;
//   - each thread then walks its own row in shared memory once, field by
//     field in step with the others (field f of every row at once, so a
//     column's encode runs converged), encoding each consumed field: a
//     vocabulary compare (the schema's tables, staged in shared memory
//     too), or the numeric fast path in float64 (num / 10^frac,
//     floor(v / width): IEEE division and floor, no fast math, so the
//     native encoder's values);
//   - the tile's codes, continuous values and labels are gathered in
//     shared memory and written out as contiguous runs, [rows, n_binned]
//     row-major being the tile's rows one after another;
//   - anything off the fast path sets one flag a chunk, which the wrapper
//     reads once; the host then encodes that chunk natively.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;           // rows a block takes, one a thread

constexpr int KIND_CATEGORICAL = 0;  // runtime/native.py KIND_*; 1 is binned
constexpr int KIND_CONTINUOUS = 2;
constexpr int KIND_LABEL = 3;

constexpr double FLOOR_MAX = 4611686018427387904.0;   // 2^62

struct Tables {
  const int32_t* col;               // [ncols] spec reading each field, or -1
  const int32_t* spec;              // [nspec][5] kind, slot, first, count, bins
  const int32_t* entry;             // [nvocab][2] byte offset, length
  const double* width;              // [nspec]
  const long long* offset;          // [nspec]
  const uint8_t* base;              // the tables' first byte
};

__device__ __forceinline__ int lookup(const Tables& t, int s,
                                      const uint8_t* f, int n) {
  const int first = t.spec[5 * s + 2];
  const int count = t.spec[5 * s + 3];
  for (int j = 0; j < count; ++j) {
    const int off = t.entry[2 * (first + j)];
    if (t.entry[2 * (first + j) + 1] != n) continue;
    const uint8_t* v = t.base + off;
    int k = 0;
    while (k < n && v[k] == f[k]) ++k;
    if (k == n) return j;
  }
  return -1;
}

// [+-]digits[.digits] with 1 to 15 digits: num and 10^frac are exact in
// double, so the one division is correctly rounded (strtod's value).
__device__ __forceinline__ bool parse_number(const uint8_t* f, int n,
                                             double* out) {
  int p = 0;
  bool neg = false;
  if (p < n && (f[p] == '-' || f[p] == '+')) {
    neg = f[p] == '-';
    ++p;
  }
  unsigned long long num = 0;
  int digits = 0, frac = 0;
  while (p < n && f[p] >= '0' && f[p] <= '9') {
    num = num * 10ull + (f[p] - '0');
    ++digits;
    ++p;
  }
  if (p < n && f[p] == '.') {
    ++p;
    while (p < n && f[p] >= '0' && f[p] <= '9') {
      num = num * 10ull + (f[p] - '0');
      ++digits;
      ++frac;
      ++p;
    }
  }
  if (p != n || digits == 0 || digits > 15) return false;
  double den = 1.0;
  for (int i = 0; i < frac; ++i) den *= 10.0;          // exact to 1e15
  const double v = __ddiv_rn(static_cast<double>(num), den);
  *out = neg ? -v : v;
  return true;
}

// Field [f, f + n) of the thread's row, read by spec sp, into the tile's
// outputs; false where the fast path refuses it.
__device__ __forceinline__ bool encode_field(
    const Tables& t, int sp, const uint8_t* f, int n, int row, int n_binned,
    int n_cont, int32_t* codes_s, float* cont_s, int32_t* labels_s) {
  const int kind = t.spec[5 * sp];
  const int slot = t.spec[5 * sp + 1];
  const int nb = t.spec[5 * sp + 4];
  if (kind == KIND_CATEGORICAL || kind == KIND_LABEL) {
    const int code = lookup(t, sp, f, n);
    if (kind == KIND_LABEL) {
      labels_s[row] = code;
      return code >= 0;
    }
    codes_s[row * n_binned + slot] = code < 0 ? nb - 1 : code;
    return true;
  }
  double v;
  if (!parse_number(f, n, &v)) return false;
  if (kind == KIND_CONTINUOUS) {
    cont_s[row * n_cont + slot] = __double2float_rn(v);
    return true;
  }
  const double fl = floor(__ddiv_rn(v, t.width[sp]));
  if (!(fl >= -FLOOR_MAX && fl <= FLOOR_MAX)) return false;
  long long b = static_cast<long long>(fl) - t.offset[sp];
  if (b < 0) b = 0;
  if (b >= nb) b = nb - 1;
  codes_s[row * n_binned + slot] = static_cast<int32_t>(b);
  return true;
}

__global__ void __launch_bounds__(TILE)
csv_encode_kernel(const uint8_t* __restrict__ bytes,
                  const long long* __restrict__ starts, long long rows,
                  const uint8_t* __restrict__ meta, int meta_bytes,
                  int ncols, int nspec, int nvocab, uint8_t delim,
                  int n_binned, int n_cont, int tile_bytes,
                  int32_t* __restrict__ codes, int32_t* __restrict__ labels,
                  float* __restrict__ cont, int32_t* __restrict__ flag) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tables = smem;
  uint8_t* tile = smem + meta_bytes;
  int32_t* codes_s = reinterpret_cast<int32_t*>(tile + tile_bytes);
  float* cont_s = reinterpret_cast<float*>(codes_s + TILE * n_binned);
  int32_t* labels_s = reinterpret_cast<int32_t*>(cont_s + TILE * n_cont);

  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * TILE;
  const int nr = static_cast<int>(rows - r0 < TILE ? rows - r0 : TILE);
  const long long a16 = starts[r0] & ~15ll;
  const long long b16 = (starts[r0 + nr] + 15) & ~15ll;
  if (b16 - a16 > tile_bytes) {     // the wrapper sized tile_bytes to fit
    if (tid == 0) *flag = 1;
    return;
  }
  for (int w = tid; w < meta_bytes / 16; w += TILE)
    reinterpret_cast<int4*>(tables)[w] =
        reinterpret_cast<const int4*>(meta)[w];
  const int words = static_cast<int>((b16 - a16) / 16);
  const int4* src = reinterpret_cast<const int4*>(bytes + a16);
  for (int w = tid; w < words; w += TILE)
    reinterpret_cast<int4*>(tile)[w] = src[w];
  __syncthreads();

  Tables t;
  t.base = tables;
  t.col = reinterpret_cast<const int32_t*>(tables);
  t.spec = t.col + ncols;
  t.entry = t.spec + 5 * nspec;
  const int dbl = ((4 * (ncols + 5 * nspec + 2 * nvocab)) + 7) & ~7;
  t.width = reinterpret_cast<const double*>(tables + dbl);
  t.offset = reinterpret_cast<const long long*>(tables + dbl + 8 * nspec);

  bool bad = false;
  if (tid < nr) {
    const int lim = static_cast<int>(starts[r0 + tid + 1] - a16);
    int p = static_cast<int>(starts[r0 + tid] - a16);
    // the fields in step across the block: field f of every row is read
    // by the same spec at once, so the kind's branches do not diverge.  A
    // field ends at the delimiter, the last one at the line's end, less
    // one carriage return there
    for (int f = 0; f < ncols && !bad; ++f) {
      int q = p;
      while (q < lim && tile[q] != delim && tile[q] != '\n') ++q;
      const bool at_delim = q < lim && tile[q] == delim;
      int e = q;
      if (f == ncols - 1) {
        bad = at_delim;             // more fields than the first row's
        if (e > p && tile[e - 1] == '\r') --e;
      } else {
        bad = !at_delim;            // fewer
      }
      if (!bad && t.col[f] >= 0)
        bad = !encode_field(t, t.col[f], tile + p, e - p, tid, n_binned,
                            n_cont, codes_s, cont_s, labels_s);
      p = q + 1;
    }
  }
  if (bad) *flag = 1;
  __syncthreads();
  // the tile's rows are contiguous in every output
  for (int i = tid; i < nr * n_binned; i += TILE)
    codes[r0 * n_binned + i] = codes_s[i];
  for (int i = tid; i < nr * n_cont; i += TILE)
    cont[r0 * n_cont + i] = cont_s[i];
  if (labels != nullptr && tid < nr) labels[r0 + tid] = labels_s[tid];
}

}  // namespace

extern "C" {

// buf holds the row offsets (int64, rows + 1, relative to the bytes) from
// byte 0 and the block's bytes from data_off (16-aligned), padded to whole
// 16-byte words and 16 bytes more; meta the tables of ops/csv.py
// CsvSpec.meta (meta_bytes a multiple of 16).  One launch on `stream`;
// returns cudaGetLastError().
int csv_encode(const uint8_t* buf, long data_off, long rows,
               const uint8_t* meta, int meta_bytes, int ncols, int nspec,
               int nvocab, int delim, int n_binned, int n_cont,
               int tile_bytes, int32_t* codes, int32_t* labels, float* cont,
               int32_t* flag, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int tile = (tile_bytes + 15) & ~15;
  const size_t smem = static_cast<size_t>(meta_bytes) + tile +
                      static_cast<size_t>(TILE) * (n_binned + n_cont + 1) * 4;
  if (smem > (48u << 10)) {         // per device: set on every launch
    cudaError_t err = cudaFuncSetAttribute(
        csv_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (rows + TILE - 1) / TILE;
  csv_encode_kernel<<<static_cast<unsigned>(blocks), TILE, smem, stream>>>(
      buf + data_off, reinterpret_cast<const long long*>(buf), rows, meta,
      meta_bytes, ncols, nspec, nvocab, static_cast<uint8_t>(delim),
      n_binned, n_cont, tile, codes, labels, cont, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
