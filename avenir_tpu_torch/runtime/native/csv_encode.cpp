// Native data plane: one-pass CSV parse + schema-driven encode.
//
// The reference's record pipeline is the JVM: Hadoop TextInputFormat splits
// lines, every mapper re-splits and re-parses each record's fields
// (e.g. bayesian/BayesianDistribution.java:137-179). Here the equivalent
// hot path — CSV bytes -> int bin codes / float features / class labels —
// is a C++ kernel invoked via ctypes, feeding fixed-shape numpy buffers that
// go straight to TPU infeed. The Python DatasetEncoder
// (core/encoding.py) remains the portable fallback and the source of truth
// for vocab/bin semantics; this kernel implements the identical rules:
//   categorical: vocab lookup, miss -> OOV slot (n_bins-1)
//   binned numeric: clip(floor(v / bucket_width) - bin_offset, 0, n_bins-1)
//   continuous: parsed as float
//   label: vocab lookup, miss -> error
//
// Build: g++ -O3 -shared -fPIC (driven by avenir_tpu/runtime/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// column kinds, mirroring FeatureField roles
enum Kind : int32_t {
  kCategorical = 0,   // binned via vocab
  kBinnedNumeric = 1, // binned via bucket width
  kContinuous = 2,    // raw float feature
  kLabel = 3,         // class attribute via vocab
  kId = 4,            // record id: emit (offset, length) into the buffer
};

// error codes (negative returns)
constexpr long kErrRagged = -1;
constexpr long kErrBadNumber = -2;
constexpr long kErrUnknownLabel = -3;
constexpr long kErrTooManyRows = -4;

// Zero-copy vocabulary lookup: open-addressing flat table keyed by an
// FNV-1a hash of the raw field bytes. Small-cardinality vocabs (the schema
// contract caps them) probe once or twice; no per-field std::string
// construction or bucket-chain pointer chase as with unordered_map.
struct VocabTable {
  struct Entry {
    uint64_t hash = 0;
    const char* key = nullptr;
    uint32_t len = 0;
    int32_t code = 0;
  };
  std::vector<Entry> entries;
  uint64_t mask = 0;
  std::string storage;  // owns key bytes; pointers stable after build()

  // Word-at-a-time mixer for the short keys vocabularies hold (overlapping
  // head/tail loads, murmur-style finalizer); FNV-1a byte loop only for
  // keys longer than 16 bytes. Used by both build() and find(), so the
  // choice of hash is invisible to callers.
  static uint64_t hash_bytes(const char* s, size_t n) {
    uint64_t a = 0, b = 0;
    if (n > 16) {
      uint64_t h = 1469598103934665603ull;
      for (size_t i = 0; i < n; ++i) {
        h ^= static_cast<unsigned char>(s[i]);
        h *= 1099511628211ull;
      }
      return h;
    }
    if (n >= 8) {
      memcpy(&a, s, 8);
      memcpy(&b, s + n - 8, 8);
    } else if (n >= 4) {
      uint32_t x, y;
      memcpy(&x, s, 4);
      memcpy(&y, s + n - 4, 4);
      a = x;
      b = y;
    } else if (n > 0) {
      a = static_cast<uint8_t>(s[0]) |
          (static_cast<uint64_t>(static_cast<uint8_t>(s[n / 2])) << 8) |
          (static_cast<uint64_t>(static_cast<uint8_t>(s[n - 1])) << 16);
    }
    uint64_t h = (a ^ (b + 0x9e3779b97f4a7c15ull)) * 0xff51afd7ed558ccdull;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ull;
    h ^= h >> 29;
    return h ^ (n * 0x9e3779b97f4a7c15ull);
  }

  void build(const std::vector<std::string>& keys) {
    size_t cap = 8;
    while (cap < keys.size() * 2) cap <<= 1;
    entries.assign(cap, Entry{});
    mask = cap - 1;
    size_t total = 0;
    for (const auto& k : keys) total += k.size();
    storage.reserve(total);
    std::vector<size_t> offs;
    offs.reserve(keys.size());
    for (const auto& k : keys) {
      offs.push_back(storage.size());
      storage += k;
    }
    for (size_t i = 0; i < keys.size(); ++i) {
      const char* k = storage.data() + offs[i];
      const size_t n = keys[i].size();
      const uint64_t h = hash_bytes(k, n);
      size_t p = h & mask;
      while (entries[p].key) p = (p + 1) & mask;
      entries[p] = Entry{h, k, static_cast<uint32_t>(n),
                         static_cast<int32_t>(i)};
    }
  }

  // code for the bytes, or -1 if absent
  int32_t find(const char* s, size_t n) const {
    const uint64_t h = hash_bytes(s, n);
    size_t p = h & mask;
    while (entries[p].key) {
      const Entry& e = entries[p];
      if (e.hash == h && e.len == n && memcmp(e.key, s, n) == 0)
        return e.code;
      p = (p + 1) & mask;
    }
    return -1;
  }
};

struct ColumnSpec {
  int32_t kind;
  int32_t ordinal;
  double bucket_width;
  int64_t bin_offset;
  int32_t n_bins;
  VocabTable vocab;
};

bool parse_double_slow(const char* s, size_t n, double* out) {
  if (n == 0) return false;
  // fields are short: stack buffer avoids a heap allocation per field
  char tmp[64];
  if (n < sizeof(tmp)) {
    memcpy(tmp, s, n);
    tmp[n] = '\0';
    char* end = nullptr;
    *out = std::strtod(tmp, &end);
    return end == tmp + n;
  }
  std::string big(s, n);
  char* end = nullptr;
  *out = std::strtod(big.c_str(), &end);
  return end == big.c_str() + big.size();
}

constexpr double kPow10[16] = {1e0, 1e1, 1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                               1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};

// Fast path for plain [-]ddd[.ddd] with <=15 total digits: numerator and
// power-of-ten denominator are both exact in double, so the single division
// is correctly rounded — bit-identical to strtod. Anything else (exponents,
// inf/nan, leading whitespace, long digit strings) falls back to strtod.
bool parse_double(const char* s, size_t n, double* out) {
  const char* p = s;
  const char* end = s + n;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  uint64_t num = 0;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    num = num * 10 + static_cast<uint64_t>(*p - '0');
    ++digits;
    ++p;
  }
  int frac_digits = 0;
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      num = num * 10 + static_cast<uint64_t>(*p - '0');
      ++digits;
      ++frac_digits;
      ++p;
    }
  }
  if (p != end || digits == 0 || digits > 15)
    return parse_double_slow(s, n, out);
  const double v = static_cast<double>(num) / kPow10[frac_digits];
  *out = neg ? -v : v;
  return true;
}

std::vector<ColumnSpec> build_specs(
    const int32_t* kinds, const int32_t* ordinals,
    const double* bucket_widths, const int64_t* bin_offsets,
    const int32_t* n_bins, int32_t nspec, const char* vocab_blob) {
  std::vector<ColumnSpec> specs(nspec);
  const char* vb = vocab_blob;
  for (int32_t i = 0; i < nspec; ++i) {
    ColumnSpec& c = specs[i];
    c.kind = kinds[i];
    c.ordinal = ordinals[i];
    c.bucket_width = bucket_widths[i];
    c.bin_offset = bin_offsets[i];
    c.n_bins = n_bins[i];
    if (c.kind == kCategorical || c.kind == kLabel) {
      std::vector<std::string> keys;
      std::string cur;
      while (*vb != '\x1e') {
        if (*vb == '\x1f') {
          keys.push_back(cur);
          cur.clear();
        } else {
          cur.push_back(*vb);
        }
        ++vb;
      }
      ++vb;  // skip column terminator
      c.vocab.build(keys);
    }
  }
  return specs;
}

std::vector<int32_t> build_slots(const std::vector<ColumnSpec>& specs) {
  std::vector<int32_t> slot(specs.size(), 0);
  int32_t bi = 0, ci = 0;
  for (size_t i = 0; i < specs.size(); ++i) {
    if (specs[i].kind == kCategorical || specs[i].kind == kBinnedNumeric)
      slot[i] = bi++;
    else if (specs[i].kind == kContinuous)
      slot[i] = ci++;
  }
  return slot;
}

// Encode records in buf[range_begin:range_end] (newline-aligned) writing
// rows starting at row_start. Returns rows encoded or a negative error code
// with *err_row set to the ABSOLUTE offending row index.
long encode_range(
    const char* buf, const char* range_begin, const char* range_end,
    char delim, int32_t ncols,
    const std::vector<ColumnSpec>& specs, const std::vector<int32_t>& slot,
    int32_t* codes_out, long n_binned, float* cont_out, long n_cont,
    int32_t* labels_out, int64_t* id_off_out, int32_t* id_len_out,
    long row_start, long max_rows, long* err_row) {
  const int32_t nspec = static_cast<int32_t>(specs.size());
  std::vector<const char*> starts(ncols);
  std::vector<size_t> lens(ncols);
  long row = row_start;
  const char* p = range_begin;
  const char* end = range_end;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* trimmed = line_end;
    if (trimmed > p && trimmed[-1] == '\r') --trimmed;
    // skip blank AND whitespace-only lines: the Python ingest path filters
    // on line.strip(), so a line of spaces/tabs must not parse as a 1-field
    // row here and fail the ragged-record check
    const char* ws = p;
    while (ws < trimmed &&
           (*ws == ' ' || *ws == '\t' || *ws == '\v' || *ws == '\f' ||
            *ws == '\r')) ++ws;
    if (ws == trimmed) {
      p = nl ? nl + 1 : end;
      continue;
    }
    if (row >= max_rows) {
      *err_row = row;
      return kErrTooManyRows;
    }
    // SWAR field split: find delimiter bytes 8 at a time (exact zero-byte
    // detect on w ^ broadcast(delim)), ~8x fewer iterations than a per-byte
    // scan on the ~76-byte rows of the north-star workload.
    // NOTE the exact formula: the cheaper (x-0x01..)&~x&0x80.. trick is
    // positionally wrong — its borrow can flag a byte equal to delim^0x01
    // right after a true delimiter (e.g. '-' after ','), splitting negative
    // numbers into phantom fields.
    int32_t f = 0;
    const char* fs = p;
    const uint64_t dbroad =
        0x0101010101010101ull * static_cast<uint8_t>(delim);
    const char* q = p;
    while (q + 8 <= trimmed) {
      uint64_t w;
      memcpy(&w, q, 8);
      const uint64_t x = w ^ dbroad;
      uint64_t hit = ~(((x & 0x7f7f7f7f7f7f7f7full) + 0x7f7f7f7f7f7f7f7full) |
                       x | 0x7f7f7f7f7f7f7f7full);
      while (hit) {
        const char* d = q + (__builtin_ctzll(hit) >> 3);
        if (f < ncols) {
          starts[f] = fs;
          lens[f] = static_cast<size_t>(d - fs);
        }
        ++f;
        fs = d + 1;
        hit &= hit - 1;
      }
      q += 8;
    }
    for (; q < trimmed; ++q) {
      if (*q == delim) {
        if (f < ncols) {
          starts[f] = fs;
          lens[f] = static_cast<size_t>(q - fs);
        }
        ++f;
        fs = q + 1;
      }
    }
    if (f < ncols) {
      starts[f] = fs;
      lens[f] = static_cast<size_t>(trimmed - fs);
    }
    ++f;
    if (f != ncols) {
      *err_row = row;
      return kErrRagged;
    }
    for (int32_t i = 0; i < nspec; ++i) {
      const ColumnSpec& c = specs[i];
      const char* s = starts[c.ordinal];
      size_t n = lens[c.ordinal];
      switch (c.kind) {
        case kCategorical: {
          const int32_t code = c.vocab.find(s, n);
          codes_out[row * n_binned + slot[i]] =
              code < 0 ? c.n_bins - 1 : code;
          break;
        }
        case kBinnedNumeric: {
          double v;
          if (!parse_double(s, n, &v)) {
            *err_row = row;
            return kErrBadNumber;
          }
          int64_t b = static_cast<int64_t>(std::floor(v / c.bucket_width)) -
                      c.bin_offset;
          if (b < 0) b = 0;
          if (b >= c.n_bins) b = c.n_bins - 1;
          codes_out[row * n_binned + slot[i]] = static_cast<int32_t>(b);
          break;
        }
        case kContinuous: {
          double v;
          if (!parse_double(s, n, &v)) {
            *err_row = row;
            return kErrBadNumber;
          }
          cont_out[row * n_cont + slot[i]] = static_cast<float>(v);
          break;
        }
        case kLabel: {
          const int32_t code = c.vocab.find(s, n);
          if (code < 0) {
            *err_row = row;
            return kErrUnknownLabel;
          }
          if (labels_out) labels_out[row] = code;
          break;
        }
        case kId: {
          if (id_off_out) {
            id_off_out[row] = static_cast<int64_t>(s - buf);
            id_len_out[row] = static_cast<int32_t>(n);
          }
          break;
        }
      }
    }
    ++row;
    p = nl ? nl + 1 : end;
  }
  return row - row_start;
}

long count_rows_range(const char* p, const char* end) {
  long rows = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* trimmed = line_end;
    if (trimmed > p && trimmed[-1] == '\r') --trimmed;
    if (trimmed > p) ++rows;
    p = nl ? nl + 1 : end;
  }
  return rows;
}

}  // namespace

extern "C" {

// Parse + encode up to max_rows CSV records from buf[0:len].
//
// Specs arrive as parallel arrays of length nspec, ordered so that all
// categorical/binned specs fill codes_out columns 0..n_binned-1 in order,
// continuous specs fill cont_out columns 0..n_cont-1 in order, and the
// label spec (at most one) fills labels_out. vocab_blob packs the
// vocabularies of vocab-bearing specs in spec order: values separated by
// '\x1f', columns terminated by '\x1e'.
//
// Returns the number of rows encoded, or a negative error code with
// *err_row set to the offending row index.
long avenir_csv_encode(
    const char* buf, long len, char delim, int32_t ncols,
    const int32_t* kinds, const int32_t* ordinals,
    const double* bucket_widths, const int64_t* bin_offsets,
    const int32_t* n_bins, int32_t nspec,
    const char* vocab_blob,
    int32_t* codes_out, long n_binned,
    float* cont_out, long n_cont,
    int32_t* labels_out,
    int64_t* id_off_out, int32_t* id_len_out,
    long max_rows, long* err_row) {
  auto specs = build_specs(kinds, ordinals, bucket_widths, bin_offsets,
                           n_bins, nspec, vocab_blob);
  auto slot = build_slots(specs);
  return encode_range(buf, buf, buf + len, delim, ncols, specs, slot,
                      codes_out, n_binned, cont_out, n_cont, labels_out,
                      id_off_out, id_len_out, 0, max_rows, err_row);
}

// Multithreaded variant: splits the buffer into newline-aligned ranges,
// prefix-sums per-range row counts, then encodes ranges in parallel into
// the shared outputs — deterministic row order identical to the
// single-threaded path (the analog of the reference's per-HDFS-split mapper
// parallelism, in one process).
long avenir_csv_encode_mt(
    const char* buf, long len, char delim, int32_t ncols,
    const int32_t* kinds, const int32_t* ordinals,
    const double* bucket_widths, const int64_t* bin_offsets,
    const int32_t* n_bins, int32_t nspec,
    const char* vocab_blob,
    int32_t* codes_out, long n_binned,
    float* cont_out, long n_cont,
    int32_t* labels_out,
    int64_t* id_off_out, int32_t* id_len_out,
    long max_rows, long* err_row, int32_t nthreads) {
  if (nthreads <= 1 || len < (1 << 20)) {
    return avenir_csv_encode(buf, len, delim, ncols, kinds, ordinals,
                             bucket_widths, bin_offsets, n_bins, nspec,
                             vocab_blob, codes_out, n_binned, cont_out,
                             n_cont, labels_out, id_off_out, id_len_out,
                             max_rows, err_row);
  }
  auto specs = build_specs(kinds, ordinals, bucket_widths, bin_offsets,
                           n_bins, nspec, vocab_blob);
  auto slot = build_slots(specs);

  // newline-aligned range boundaries
  const char* end = buf + len;
  std::vector<const char*> bounds;
  bounds.push_back(buf);
  for (int32_t t = 1; t < nthreads; ++t) {
    const char* guess = buf + (len * t) / nthreads;
    if (guess <= bounds.back()) continue;
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', static_cast<size_t>(end - guess)));
    const char* b = nl ? nl + 1 : end;
    if (b > bounds.back() && b < end) bounds.push_back(b);
  }
  bounds.push_back(end);
  const int nr = static_cast<int>(bounds.size()) - 1;

  // per-range row counts -> absolute row offsets (parallel count pass)
  std::vector<long> counts(nr, 0);
  {
    std::vector<std::thread> ts;
    for (int r = 0; r < nr; ++r)
      ts.emplace_back([&, r] { counts[r] = count_rows_range(bounds[r], bounds[r + 1]); });
    for (auto& t : ts) t.join();
  }
  std::vector<long> offsets(nr + 1, 0);
  for (int r = 0; r < nr; ++r) offsets[r + 1] = offsets[r] + counts[r];
  if (offsets[nr] > max_rows) {
    *err_row = max_rows;
    return kErrTooManyRows;
  }

  // parallel encode; first (lowest-row) error wins
  std::vector<long> errs(nr, 0);
  std::vector<long> err_rows(nr, 0);
  {
    std::vector<std::thread> ts;
    for (int r = 0; r < nr; ++r) {
      ts.emplace_back([&, r] {
        long e = 0;
        long got = encode_range(buf, bounds[r], bounds[r + 1], delim, ncols,
                                specs, slot, codes_out, n_binned, cont_out,
                                n_cont, labels_out, id_off_out, id_len_out,
                                offsets[r], max_rows, &e);
        errs[r] = got < 0 ? got : 0;
        err_rows[r] = e;
      });
    }
    for (auto& t : ts) t.join();
  }
  for (int r = 0; r < nr; ++r) {
    if (errs[r] < 0) {
      *err_row = err_rows[r];
      return errs[r];
    }
  }
  return offsets[nr];
}

// Walk buf[pos:len] line by line for a chunk reader (jobs/base.py
// BlockReader): append the offset of each non-blank line to starts[rows..]
// until max_rows offsets are held or the bytes run out, and set *pos_out
// just after the last line walked.  Blank means what bytes.strip() empties:
// every byte one of ' ' \t \v \f \r, the lines encode_range skips.  A
// line with no newline is walked only when at_eof (the file's last line);
// otherwise the walk stops at its start, for the caller to read on.
// Newlines are found 64 bytes at a time (SSE2, on every x86-64) and each
// mask's bits walked in turn: at ~76 bytes a line that is about one
// unpredictable branch a line, against a memchr call and its exits (half
// the walk's time on an H100 host); the last bytes, and other machines,
// take memchr.  Returns the new row count.
long avenir_csv_walk(const char* buf, long len, long pos, long rows,
                     long max_rows, int32_t at_eof, int64_t* starts,
                     long* pos_out) {
  long line = pos;                  // the first byte of the line to walk
  long scan = pos;                  // no newline before it is left to walk
  // the line [line, nl): recorded unless blank; false once max_rows are
  auto take = [&](long nl) {
    long q = line;
    while (q < nl && (buf[q] == ' ' || buf[q] == '\t' || buf[q] == '\v' ||
                      buf[q] == '\f' || buf[q] == '\r')) ++q;
    if (q < nl) starts[rows++] = line;
    line = nl + 1;
    return rows < max_rows;
  };
  if (rows < max_rows) {
#if defined(__SSE2__)
    const __m128i newline = _mm_set1_epi8('\n');
    for (; scan + 64 <= len; scan += 64) {
      uint64_t mask = 0;
      for (int k = 0; k < 4; ++k)
        mask |= static_cast<uint64_t>(static_cast<uint32_t>(
                    _mm_movemask_epi8(_mm_cmpeq_epi8(
                        _mm_loadu_si128(reinterpret_cast<const __m128i*>(
                            buf + scan + 16 * k)),
                        newline))))
                << (16 * k);
      for (; mask; mask &= mask - 1)
        if (!take(scan + __builtin_ctzll(mask))) goto done;
    }
#endif
    for (const char* nl;
         (nl = static_cast<const char*>(memchr(buf + scan, '\n',
                                                len - scan))) != nullptr;) {
      scan = nl - buf + 1;
      if (!take(nl - buf)) goto done;
    }
    if (at_eof && line < len) {     // the last line, with no newline
      take(len);
      line = len;
    }
  }
done:
  *pos_out = line;
  return rows;
}

// Count newline-terminated records (for buffer pre-sizing).
long avenir_csv_count_rows(const char* buf, long len) {
  return count_rows_range(buf, buf + len);
}

// Gather id byte ranges, widened to UCS4, into a null-padded [n, maxlen]
// uint32 matrix — the exact memory layout of a numpy 'U<maxlen>' array, so
// the caller just views the buffer. Replaces the numpy fancy-indexing
// gather plus astype('U') pair, whose rows*maxlen temporaries and
// per-element casts dominated encode time. Byte-for-codepoint widening is
// only correct for ASCII: returns 1 if every id byte was ASCII, else 0
// (caller must re-extract with real UTF-8 decoding).
int32_t avenir_gather_ids_u32(const char* buf, const int64_t* off,
                              const int32_t* len, long n, uint32_t* out,
                              int32_t maxlen) {
  uint8_t acc = 0;
  for (long i = 0; i < n; ++i) {
    uint32_t* dst = out + static_cast<long>(i) * maxlen;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(buf + off[i]);
    const int32_t m = len[i] < maxlen ? len[i] : maxlen;
    int32_t j = 0;
    for (; j < m; ++j) {
      acc |= src[j];
      dst[j] = src[j];
    }
    for (; j < maxlen; ++j) dst[j] = 0;
  }
  return (acc & 0x80) ? 0 : 1;
}

}  // extern "C"
