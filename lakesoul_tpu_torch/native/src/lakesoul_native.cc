// lakesoul_tpu native core: host-side hot loops.
//
// The reference implements these in Rust (rust/lakesoul-io/src/utils/hash,
// physical_plan/merge/sorted/v2/loser_tree_merger.rs, lakesoul-vector simd.rs);
// here the same roles are C++ with a plain C ABI consumed via ctypes:
//   - Spark-compatible Murmur3 (seed 42) batch hashing for fixed-width and
//     Arrow-layout string columns (bucket assignment hot path)
//   - loser-tree k-way merge over sorted int64 runs (merge-on-read hot path:
//     emits the merged take-order and group-tail flags in one pass)
//   - RaBitQ sign-bit packing
//
// Everything is pure functions over caller-owned buffers: no allocation, no
// global state, trivially thread-safe.

#include <cstdint>
#include <cstring>
#include <vector>
#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define LS_X86 1
#endif

extern "C" {

// ---------------------------------------------------------------- murmur3
static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t mix_k(uint32_t k) {
  k *= 0xcc9e2d51u;
  k = rotl32(k, 15);
  k *= 0x1b873593u;
  return k;
}

static inline uint32_t mix_h(uint32_t h, uint32_t k) {
  h ^= mix_k(k);
  h = rotl32(h, 13);
  return h * 5u + 0xe6546b64u;
}

static inline uint32_t fmix(uint32_t h, uint32_t len) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Spark variant: whole 4-byte LE words, then each tail byte as its own block.
static inline uint32_t murmur3_bytes(const uint8_t* data, int64_t len,
                                     uint32_t seed) {
  uint32_t h = seed;
  int64_t nblocks = len / 4;
  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k;
    std::memcpy(&k, data + i * 4, 4);
    h = mix_h(h, k);
  }
  for (int64_t i = nblocks * 4; i < len; i++) {
    h = mix_h(h, (uint32_t)data[i]);
  }
  return fmix(h, (uint32_t)len);
}

// hash ≤32-bit ints (sign-extended to u32, one block).  valid==nullptr means
// no nulls; null rows keep their incoming out[] value (reference semantics).
void ls_hash_i32(const int32_t* vals, const uint8_t* valid, uint32_t* out,
                 int64_t n, const uint32_t* seeds, uint32_t seed) {
  for (int64_t i = 0; i < n; i++) {
    if (valid && !valid[i]) continue;
    uint32_t s = seeds ? seeds[i] : seed;
    uint32_t h = mix_h(s, (uint32_t)vals[i]);
    out[i] = fmix(h, 4);
  }
}

void ls_hash_i64(const int64_t* vals, const uint8_t* valid, uint32_t* out,
                 int64_t n, const uint32_t* seeds, uint32_t seed) {
  for (int64_t i = 0; i < n; i++) {
    if (valid && !valid[i]) continue;
    uint32_t s = seeds ? seeds[i] : seed;
    uint64_t v = (uint64_t)vals[i];
    uint32_t h = mix_h(s, (uint32_t)(v & 0xffffffffu));
    h = mix_h(h, (uint32_t)(v >> 32));
    out[i] = fmix(h, 8);
  }
}

// Arrow string/binary layout: int32 offsets [n+1] + contiguous data buffer.
void ls_hash_bytes32(const uint8_t* data, const int32_t* offsets,
                     const uint8_t* valid, uint32_t* out, int64_t n,
                     const uint32_t* seeds, uint32_t seed) {
  for (int64_t i = 0; i < n; i++) {
    if (valid && !valid[i]) continue;
    uint32_t s = seeds ? seeds[i] : seed;
    out[i] = murmur3_bytes(data + offsets[i], offsets[i + 1] - offsets[i], s);
  }
}

void ls_hash_bytes64(const uint8_t* data, const int64_t* offsets,
                     const uint8_t* valid, uint32_t* out, int64_t n,
                     const uint32_t* seeds, uint32_t seed) {
  for (int64_t i = 0; i < n; i++) {
    if (valid && !valid[i]) continue;
    uint32_t s = seeds ? seeds[i] : seed;
    out[i] = murmur3_bytes(data + offsets[i], offsets[i + 1] - offsets[i], s);
  }
}

void ls_bucket_ids(const uint32_t* hashes, int64_t* out, int64_t n,
                   uint32_t num_buckets) {
  for (int64_t i = 0; i < n; i++) out[i] = (int64_t)(hashes[i] % num_buckets);
}

// ------------------------------------------------------------ loser tree
// Merge k sorted int64 runs (concatenated in `keys`, run r spans
// [run_offsets[r], run_offsets[r+1])) into ascending order; ties broken by
// run index (later run = newer version last).  Outputs:
//   order[n]       global row indices in merged order
//   group_tail[n]  1 where position i is the LAST row of its key group
// Returns the number of distinct keys.
int64_t ls_merge_i64(const int64_t* keys, const int64_t* run_offsets,
                     int32_t num_runs, int64_t* order, uint8_t* group_tail) {
  const int64_t n = run_offsets[num_runs];
  if (n == 0) return 0;
  // loser tree over run heads: find k2 = next pow2 ≥ num_runs
  int32_t k2 = 1;
  while (k2 < num_runs) k2 <<= 1;
  const int64_t SENTINEL = INT64_MAX;

  std::vector<int64_t> pos(num_runs);
  for (int32_t r = 0; r < num_runs; r++) pos[r] = run_offsets[r];

  auto head_key = [&](int32_t r) -> int64_t {
    if (r >= num_runs || pos[r] >= run_offsets[r + 1]) return SENTINEL;
    return keys[pos[r]];
  };

  // tree[1..k2-1] store LOSER run ids; tree[0] stores the winner.
  std::vector<int32_t> tree(2 * k2, -1);
  // initialize: bottom-up tournament
  std::vector<int32_t> winner(2 * k2, -1);
  for (int32_t i = 0; i < k2; i++) winner[k2 + i] = i;
  for (int32_t node = k2 - 1; node >= 1; node--) {
    int32_t a = winner[2 * node], b = winner[2 * node + 1];
    int64_t ka = head_key(a), kb = head_key(b);
    // smaller key wins; tie → smaller run id first (stable: older first)
    int32_t w, l;
    if (ka < kb || (ka == kb && a < b)) { w = a; l = b; } else { w = b; l = a; }
    winner[node] = w;
    tree[node] = l;
  }
  int32_t w = winner[1];

  int64_t out_i = 0;
  int64_t prev_key = 0;
  bool have_prev = false;
  int64_t groups = 0;
  while (head_key(w) != SENTINEL) {
    int64_t key = head_key(w);
    if (have_prev && key != prev_key) {
      group_tail[out_i - 1] = 1;
    }
    if (!have_prev || key != prev_key) groups++;
    prev_key = key;
    have_prev = true;
    order[out_i] = pos[w];
    group_tail[out_i] = 0;
    out_i++;
    pos[w]++;
    // replay from leaf to root
    int32_t node = (k2 + w) >> 1;
    while (node >= 1) {
      int32_t l = tree[node];
      int64_t kw = head_key(w), kl = head_key(l);
      if (kl < kw || (kl == kw && l < w)) {
        tree[node] = w;
        w = l;
      }
      node >>= 1;
    }
  }
  if (out_i > 0) group_tail[out_i - 1] = 1;
  return groups;
}

// Merge k sorted byte-string runs (Arrow layout: contiguous `data` + int64
// `offsets[n+1]`, runs spanning [run_offsets[r], run_offsets[r+1]) rows).
// Same contract as ls_merge_i64: ascending lexicographic order, ties broken
// by run index (later run last), outputs merged take-order + group tails.
// Covers string/binary primary keys — and, via caller-side memcomparable
// encoding, composite keys (reference: v2 loser tree merges any key shape).
int64_t ls_merge_bytes(const uint8_t* data, const int64_t* offsets,
                       const int64_t* run_offsets, int32_t num_runs,
                       int64_t* order, uint8_t* group_tail) {
  const int64_t n = run_offsets[num_runs];
  if (n == 0) return 0;
  int32_t k2 = 1;
  while (k2 < num_runs) k2 <<= 1;

  std::vector<int64_t> pos(num_runs);
  for (int32_t r = 0; r < num_runs; r++) pos[r] = run_offsets[r];

  auto exhausted = [&](int32_t r) -> bool {
    return r >= num_runs || pos[r] >= run_offsets[r + 1];
  };
  auto head_ptr = [&](int32_t r) -> const uint8_t* {
    return data + offsets[pos[r]];
  };
  auto head_len = [&](int32_t r) -> int64_t {
    return offsets[pos[r] + 1] - offsets[pos[r]];
  };
  auto bytes_less = [](const uint8_t* a, int64_t la, const uint8_t* b,
                       int64_t lb) -> int {
    const int64_t m = la < lb ? la : lb;
    int c = m ? std::memcmp(a, b, (size_t)m) : 0;
    if (c != 0) return c;
    return la < lb ? -1 : (la > lb ? 1 : 0);
  };
  // true when run a's head should be emitted before run b's head
  // (exhausted = +infinity key)
  auto run_before = [&](int32_t a, int32_t b) -> bool {
    const bool ea = exhausted(a), eb = exhausted(b);
    if (ea && eb) return a < b;
    if (ea) return false;
    if (eb) return true;
    const int c = bytes_less(head_ptr(a), head_len(a), head_ptr(b), head_len(b));
    if (c != 0) return c < 0;
    return a < b;  // tie → older run first (stable)
  };

  std::vector<int32_t> tree(2 * k2, -1);
  std::vector<int32_t> winner(2 * k2, -1);
  for (int32_t i = 0; i < k2; i++) winner[k2 + i] = i;
  for (int32_t node = k2 - 1; node >= 1; node--) {
    int32_t a = winner[2 * node], b = winner[2 * node + 1];
    int32_t w2, l2;
    // a,b < k2 but possibly >= num_runs (virtual exhausted runs)
    if (run_before(a, b)) { w2 = a; l2 = b; } else { w2 = b; l2 = a; }
    winner[node] = w2;
    tree[node] = l2;
  }
  int32_t w = winner[1];

  int64_t out_i = 0;
  const uint8_t* prev_p = nullptr;
  int64_t prev_l = 0;
  int64_t groups = 0;
  while (!exhausted(w)) {
    const uint8_t* p = head_ptr(w);
    const int64_t l = head_len(w);
    const bool new_group =
        prev_p == nullptr || bytes_less(p, l, prev_p, prev_l) != 0;
    if (new_group) {
      if (out_i > 0) group_tail[out_i - 1] = 1;
      groups++;
    }
    prev_p = p;
    prev_l = l;
    order[out_i] = pos[w];
    group_tail[out_i] = 0;
    out_i++;
    pos[w]++;
    int32_t node = (k2 + w) >> 1;
    while (node >= 1) {
      int32_t l2 = tree[node];
      if (run_before(l2, w)) {
        tree[node] = w;
        w = l2;
      }
      node >>= 1;
    }
  }
  if (out_i > 0) group_tail[out_i - 1] = 1;
  return groups;
}

// ----------------------------------------------------- FOR bit-packing
// Frame-of-reference bit-packing for the LSF columnar format (the role of
// Vortex's lightweight integer encodings, rust/lakesoul-io/src/file_format/
// vortex.rs): values are stored as (v - base) in `width` bits each, LSB-first
// in one contiguous bitstream.  Caller guarantees max-min < 2^63 and provides
// an output buffer padded with >= 8 spare zero bytes (the inner loop reads/
// writes whole 64-bit words).
void ls_bitpack64(const int64_t* vals, int64_t n, int64_t base, int32_t width,
                  uint8_t* out) {
  if (width <= 0) return;
  const uint64_t mask =
      width >= 64 ? ~0ull : ((1ull << width) - 1);
  int64_t bitpos = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint64_t v = ((uint64_t)vals[i] - (uint64_t)base) & mask;
    const int64_t byte = bitpos >> 3;
    const int shift = (int)(bitpos & 7);
    uint64_t cur;
    std::memcpy(&cur, out + byte, 8);
    cur |= v << shift;
    std::memcpy(out + byte, &cur, 8);
    if (shift + width > 64) {
      out[byte + 8] |= (uint8_t)(v >> (64 - shift));
    }
    bitpos += width;
  }
}

// Inverse of ls_bitpack64.  `in` must have >= 8 readable bytes past the last
// encoded bit (the encoder pads); out[i] = base + decoded delta.
void ls_bitunpack64(const uint8_t* in, int64_t n, int64_t base, int32_t width,
                    int64_t* out) {
  if (width <= 0) {
    for (int64_t i = 0; i < n; i++) out[i] = base;
    return;
  }
  const uint64_t mask =
      width >= 64 ? ~0ull : ((1ull << width) - 1);
  int64_t bitpos = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t byte = bitpos >> 3;
    const int shift = (int)(bitpos & 7);
    uint64_t lo;
    std::memcpy(&lo, in + byte, 8);
    uint64_t v = lo >> shift;
    if (shift + width > 64) {
      const uint64_t hi = in[byte + 8];
      v |= hi << (64 - shift);
    }
    out[i] = (int64_t)((uint64_t)base + (v & mask));
    bitpos += width;
  }
}

// ------------------------------------------------------- gather + fill
// MOR merge-apply hot path: after the loser tree emits a take-order, every
// value column is materialized by gathering rows at those indices.  Doing
// the gather here (one tight loop per column, width-specialized) replaces
// the Python-side Table.take + fill_null pair: a NEGATIVE index means "no
// source row" and emits a null (validity bit 0, value bytes 0) — the fill
// half of gather+fill, used by UseLastNotNull-style reductions and schema
// null-fill.  `src` is the column's value buffer; out must hold n*width
// bytes.
void ls_gather_fixed(const uint8_t* src, int64_t width, const int64_t* idx,
                     int64_t n, uint8_t* out) {
  switch (width) {
    case 1: {
      const uint8_t* s = src;
      for (int64_t i = 0; i < n; i++) out[i] = idx[i] < 0 ? 0 : s[idx[i]];
      return;
    }
    case 2: {
      const uint16_t* s = (const uint16_t*)src;
      uint16_t* o = (uint16_t*)out;
      for (int64_t i = 0; i < n; i++) o[i] = idx[i] < 0 ? 0 : s[idx[i]];
      return;
    }
    case 4: {
      const uint32_t* s = (const uint32_t*)src;
      uint32_t* o = (uint32_t*)out;
      for (int64_t i = 0; i < n; i++) o[i] = idx[i] < 0 ? 0 : s[idx[i]];
      return;
    }
    case 8: {
      const uint64_t* s = (const uint64_t*)src;
      uint64_t* o = (uint64_t*)out;
      for (int64_t i = 0; i < n; i++) o[i] = idx[i] < 0 ? 0 : s[idx[i]];
      return;
    }
    default:
      for (int64_t i = 0; i < n; i++) {
        if (idx[i] < 0) {
          std::memset(out + i * width, 0, (size_t)width);
        } else {
          std::memcpy(out + i * width, src + idx[i] * width, (size_t)width);
        }
      }
  }
}

// Whole-table gather in ONE call: every column fixed-width and null-free,
// possibly CHUNKED (the merge fast path gathers straight from the
// concatenated runs without ever combining them into one buffer — the
// per-window combine_chunks copy this replaces was the single largest
// merge-apply cost).  The caller resolves global row ids to
// (chunk_of[i], local_idx[i]) ONCE — one vectorized numpy searchsorted,
// shared by every column with the same chunking — so the per-row work here
// is a pure two-level gather.  Layout, flattened across columns:
//   chunk_addrs[sum(chunk_counts)]   value-buffer addresses (uint64)
//   chunk_counts[ncols], widths[ncols]
//   out_addrs[ncols]                 output buffer addresses (n*width bytes)
void ls_gather_multi_chunked(const uint64_t* chunk_addrs,
                             const int32_t* chunk_counts,
                             const int64_t* widths, int32_t ncols,
                             const int32_t* chunk_of, const int64_t* local_idx,
                             int64_t n, const uint64_t* out_addrs) {
  int64_t addr_base = 0;
  for (int32_t c = 0; c < ncols; c++) {
    const int32_t k = chunk_counts[c];
    const int64_t w = widths[c];
    const uint64_t* addrs = chunk_addrs + addr_base;
    uint8_t* out = (uint8_t*)(uintptr_t)out_addrs[c];
    if (k == 1) {
      ls_gather_fixed((const uint8_t*)(uintptr_t)addrs[0], w, local_idx, n, out);
    } else {
#define LS_GATHER_CHUNKED_T(T)                                          \
      {                                                                 \
        T* o = (T*)out;                                                 \
        for (int64_t i = 0; i < n; i++) {                               \
          o[i] = ((const T*)(uintptr_t)addrs[chunk_of[i]])[local_idx[i]]; \
        }                                                               \
      }
      switch (w) {
        case 1: LS_GATHER_CHUNKED_T(uint8_t); break;
        case 2: LS_GATHER_CHUNKED_T(uint16_t); break;
        case 4: LS_GATHER_CHUNKED_T(uint32_t); break;
        case 8: LS_GATHER_CHUNKED_T(uint64_t); break;
        default:
          for (int64_t i = 0; i < n; i++) {
            const uint8_t* src = (const uint8_t*)(uintptr_t)addrs[chunk_of[i]];
            std::memcpy(out + i * w, src + local_idx[i] * w, (size_t)w);
          }
      }
#undef LS_GATHER_CHUNKED_T
    }
    addr_base += k;
  }
}

// Gather an Arrow validity bitmap (LSB-first, starting at `bit_offset`) by
// row index into a fresh packed bitmap.  `bits == nullptr` means the source
// has no nulls; negative indices emit 0 (null) — the fill half.  Returns
// the output null count so the caller can build the Array header without a
// second pass.
int64_t ls_gather_valid_bits(const uint8_t* bits, int64_t bit_offset,
                             const int64_t* idx, int64_t n,
                             uint8_t* out_bits) {
  const int64_t nbytes = (n + 7) / 8;
  std::memset(out_bits, 0, (size_t)nbytes);
  int64_t nulls = 0;
  for (int64_t i = 0; i < n; i++) {
    bool valid;
    if (idx[i] < 0) {
      valid = false;
    } else if (bits == nullptr) {
      valid = true;
    } else {
      const int64_t b = bit_offset + idx[i];
      valid = (bits[b >> 3] >> (b & 7)) & 1;
    }
    if (valid) {
      out_bits[i >> 3] |= (uint8_t)(1u << (i & 7));
    } else {
      nulls++;
    }
  }
  return nulls;
}

// --------------------------------------------------------------- bit pack
// bits [n, d] {0,1} bytes → packed [n, ceil(d/8)] MSB-first (np.packbits).
// ------------------------------------------------------------- ANN plane
// Ragged estimator scan + per-query top-s for the sharded ANN plane
// (annplane/ragged.py).  The numpy host path pays a python dispatch per
// (cluster, op); at 5k probed clusters per micro-batch that overhead IS the
// latency — and it all runs under the GIL, so shard fan-out on the worker
// pool cannot scale.  This kernel does one GIL-released call per shard:
// cluster-major over the probe groups (each cluster's rows stream through
// cache once, scored against every query that probed it), estimator
//   est = b[row] + csq[pair] - h[row]*csum[pair] - a[row]*(code · query)
// fused per row, candidates kept in per-query size-s max-heaps.
// SIMD: the dot/L2 inner loops dispatch at runtime to guarded AVX2+FMA
// bodies (measured ~5x over the scalar chain, which -O3 cannot vectorize
// without FP reassociation); baseline scalar everywhere else — the .so
// travels between CPUs, so -march=native stays banned and the AVX body
// only runs behind __builtin_cpu_supports.

#ifdef LS_X86
__attribute__((target("avx2,fma")))
static float ann_dot_avx(const float* a, const float* b, int64_t d) {
  __m256 acc0 = _mm256_setzero_ps(), acc1 = _mm256_setzero_ps();
  int64_t j = 0;
  for (; j + 16 <= d; j += 16) {
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + j), _mm256_loadu_ps(b + j), acc0);
    acc1 = _mm256_fmadd_ps(
        _mm256_loadu_ps(a + j + 8), _mm256_loadu_ps(b + j + 8), acc1);
  }
  for (; j + 8 <= d; j += 8)
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + j), _mm256_loadu_ps(b + j), acc0);
  acc0 = _mm256_add_ps(acc0, acc1);
  __m128 lo = _mm_add_ps(_mm256_castps256_ps128(acc0),
                         _mm256_extractf128_ps(acc0, 1));
  lo = _mm_hadd_ps(lo, lo);
  lo = _mm_hadd_ps(lo, lo);
  float s = _mm_cvtss_f32(lo);
  for (; j < d; j++) s += a[j] * b[j];
  return s;
}

__attribute__((target("avx2,fma")))
static float ann_l2_avx(const float* a, const float* b, int64_t d) {
  __m256 acc0 = _mm256_setzero_ps(), acc1 = _mm256_setzero_ps();
  int64_t j = 0;
  for (; j + 16 <= d; j += 16) {
    __m256 d0 = _mm256_sub_ps(_mm256_loadu_ps(a + j), _mm256_loadu_ps(b + j));
    __m256 d1 = _mm256_sub_ps(_mm256_loadu_ps(a + j + 8),
                              _mm256_loadu_ps(b + j + 8));
    acc0 = _mm256_fmadd_ps(d0, d0, acc0);
    acc1 = _mm256_fmadd_ps(d1, d1, acc1);
  }
  for (; j + 8 <= d; j += 8) {
    __m256 d0 = _mm256_sub_ps(_mm256_loadu_ps(a + j), _mm256_loadu_ps(b + j));
    acc0 = _mm256_fmadd_ps(d0, d0, acc0);
  }
  acc0 = _mm256_add_ps(acc0, acc1);
  __m128 lo = _mm_add_ps(_mm256_castps256_ps128(acc0),
                         _mm256_extractf128_ps(acc0, 1));
  lo = _mm_hadd_ps(lo, lo);
  lo = _mm_hadd_ps(lo, lo);
  float s = _mm_cvtss_f32(lo);
  for (; j < d; j++) {
    const float diff = a[j] - b[j];
    s += diff * diff;
  }
  return s;
}
#endif  // LS_X86

static float ann_dot_scalar(const float* a, const float* b, int64_t d) {
  float s = 0.0f;
  for (int64_t j = 0; j < d; j++) s += a[j] * b[j];
  return s;
}

static float ann_l2_scalar(const float* a, const float* b, int64_t d) {
  float s = 0.0f;
  for (int64_t j = 0; j < d; j++) {
    const float diff = a[j] - b[j];
    s += diff * diff;
  }
  return s;
}

typedef float (*ann_vec_fn)(const float*, const float*, int64_t);

static ann_vec_fn ann_pick_dot() {
#ifdef LS_X86
  if (__builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma"))
    return ann_dot_avx;
#endif
  return ann_dot_scalar;
}

static ann_vec_fn ann_pick_l2() {
#ifdef LS_X86
  if (__builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma"))
    return ann_l2_avx;
#endif
  return ann_l2_scalar;
}

static inline void ann_heap_down(float* eh, int64_t* rh, int64_t cnt) {
  int64_t i = 0;
  for (;;) {
    int64_t l = 2 * i + 1, r = l + 1, m = i;
    if (l < cnt && eh[l] > eh[m]) m = l;
    if (r < cnt && eh[r] > eh[m]) m = r;
    if (m == i) break;
    float te = eh[i]; eh[i] = eh[m]; eh[m] = te;
    int64_t tr = rh[i]; rh[i] = rh[m]; rh[m] = tr;
    i = m;
  }
}

static inline void ann_heap_push(float* eh, int64_t* rh, int64_t s,
                                 int64_t* cnt, float est, int64_t row) {
  if (*cnt < s) {
    int64_t i = (*cnt)++;
    eh[i] = est; rh[i] = row;
    while (i > 0) {
      int64_t p = (i - 1) / 2;
      if (eh[p] >= eh[i]) break;
      float te = eh[i]; eh[i] = eh[p]; eh[p] = te;
      int64_t tr = rh[i]; rh[i] = rh[p]; rh[p] = tr;
      i = p;
    }
  } else if (est < eh[0]) {
    eh[0] = est; rh[0] = row;
    ann_heap_down(eh, rh, s);
  }
}

void ls_ann_ragged_topk(
    const float* codes, const float* a, const float* b, const float* h,
    const int64_t* row_start, const int64_t* row_count,
    const float* q_glob, int64_t m, int64_t d,
    const int32_t* grp_cluster, const int64_t* grp_off, int64_t n_groups,
    const int32_t* pair_query, const float* pair_csq, const float* pair_csum,
    int64_t s, float* out_est, int64_t* out_rows) {
  // h / pair_csum are NULL on ex-code planes (the term folds to zero)
  const ann_vec_fn dot_fn = ann_pick_dot();
  std::vector<float> eh((size_t)(m * s));
  std::vector<int64_t> rh((size_t)(m * s));
  std::vector<int64_t> cnt((size_t)m, 0);
  for (int64_t g = 0; g < n_groups; g++) {
    const int64_t c = grp_cluster[g];
    const int64_t rs = row_start[c];
    const int64_t n = row_count[c];
    const int64_t p0 = grp_off[g], p1 = grp_off[g + 1];
    for (int64_t r = 0; r < n; r++) {
      const int64_t row = rs + r;
      const float* code = codes + row * d;
      const float av = a[row], bv = b[row];
      const float hv = h ? h[row] : 0.0f;
      for (int64_t p = p0; p < p1; p++) {
        const int64_t q = pair_query[p];
        const float dot = dot_fn(code, q_glob + q * d, d);
        float est = bv + pair_csq[p] - av * dot;
        if (pair_csum) est -= hv * pair_csum[p];
        ann_heap_push(eh.data() + q * s, rh.data() + q * s, s,
                      cnt.data() + q, est, row);
      }
    }
  }
  for (int64_t q = 0; q < m; q++) {
    for (int64_t i = 0; i < cnt[q]; i++) {
      out_est[q * s + i] = eh[(size_t)(q * s + i)];
      out_rows[q * s + i] = rh[(size_t)(q * s + i)];
    }
  }
}

// Exact re-rank of shortlisted rows: out[q, i] = ||raw[rows[q,i]] - query_q||²
// (rows < 0 are holes → +inf).  One GIL-released call replaces the per-shard
// numpy gather + einsum that would otherwise serialize under the GIL.
void ls_ann_exact_rerank(const float* raw, int64_t d,
                         const int64_t* rows, int64_t m, int64_t s,
                         const float* queries, float* out) {
  const ann_vec_fn l2_fn = ann_pick_l2();
  const float inf = __builtin_inff();
  for (int64_t q = 0; q < m; q++) {
    const float* qv = queries + q * d;
    for (int64_t i = 0; i < s; i++) {
      const int64_t row = rows[q * s + i];
      out[q * s + i] = row < 0 ? inf : l2_fn(raw + row * d, qv, d);
    }
  }
}

void ls_pack_bits(const uint8_t* bits, uint8_t* out, int64_t n, int64_t d) {
  const int64_t d8 = (d + 7) / 8;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* row = bits + i * d;
    uint8_t* orow = out + i * d8;
    for (int64_t b = 0; b < d8; b++) {
      uint8_t v = 0;
      const int64_t base = b * 8;
      const int64_t lim = (d - base) < 8 ? (d - base) : 8;
      // any nonzero byte counts as a set bit (np.packbits semantics)
      for (int64_t j = 0; j < lim; j++) v |= (uint8_t)((row[base + j] != 0 ? 1u : 0u) << (7 - j));
      orow[b] = v;
    }
  }
}

}  // extern "C"
