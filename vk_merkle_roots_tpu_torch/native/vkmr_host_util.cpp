// vkmr_host_util.cpp — non-hash host utilities, compiled with the full
// native ISA (wide-vector codegen is fine here; the SHA translation unit
// vkmr_native.cpp must stay all-SSE — see the Makefile note).
//
//   * FIPS padding + big-endian word packing of a bucket of equal-block
//     leaves (role of Batch packing,
//     Batches.cpp:64-121, and the in-shader padding, SHA-256.comp:207-285 —
//     done host-side here by design)
//   * the engine's flush pass onto the compact wire: a flush of exact-bucket
//     leaves bucketed into a row table beside their raw bytes, in one call on
//     one thread (the padding is the leaf kernel's, as in the reference's
//     shader)
//   * the line split of a stream read (role of the reference's fgetc reader,
//     Inputs.cpp:75-101)
//   * a glibc-compatible rand() stream generator (role of rndm, Rndm.cpp)

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// FIPS-pad one leaf into a scratch row of `pitch_bytes`: payload, 0x80,
// zero fill, and the 64-bit big-endian bit length ending at byte `end`
// (== pitch_bytes for exact buckets; the real padded boundary for stream
// buckets, whose remaining words up to the rung capacity stay zero).
inline void pad_row(uint8_t* rb, const uint8_t* src, int64_t len, int64_t end,
                    int64_t pitch_bytes) {
  std::memcpy(rb, src, size_t(len));
  rb[size_t(len)] = 0x80;
  std::memset(rb + len + 1, 0, size_t(pitch_bytes - len - 1));
  const uint64_t bits = uint64_t(len) * 8;
  for (int i = 0; i < 8; ++i)
    rb[size_t(end - 8 + i)] = uint8_t(bits >> (56 - 8 * i));
}

// Write one 16-leaf group into the tile-major wire format: word w of group
// row j lands at out[w*1024 + j] (caller passes out pre-offset to the
// group's tile/lane base).  `rows` is 16 contiguous little-endian padded
// rows of W words.  Store-strategy history, all measured on this VM:
//   * naive per-word scatter: single u32 stores at 4 KB stride — every
//     store mapped to the SAME L1 set, thrashing the 8-way set (~10x slow);
//   * 8x8 transpose with INTERLEAVED strided NT stores (earlier): the 16
//     half-line NT stores per block, interleaved with the transpose loads,
//     keep ~8 write-combining buffers open across 4 KB-strided lines and
//     throttle to ~3.3 GB/s/core isolated, ~1.5 in situ — the NT stores,
//     not the shuffles, were the packer's real bottleneck;
//   * TWO-PHASE (current): transpose the whole group into a (W,16) u32
//     L1-resident stage, then sweep it out with one full-line NT store per
//     output line, no loads interleaved — 10.8 GB/s/core isolated, ~2.8x
//     the old in-situ packer rate (plain strided stores measured slightly
//     faster still, 12.7, but pay RFO reads and evict half of L2 per
//     batch; NT keeps the 12 MB/batch output out of the caches).
#if defined(__AVX2__)
inline void transpose8x8_stage(const uint8_t* rows, int64_t pitch, int64_t w,
                               uint32_t* stage, int jg) {
  const __m256i bswap = _mm256_setr_epi8(
      3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12,
      3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12);
  __m256i r[8];
  for (int k = 0; k < 8; ++k)
    r[k] = _mm256_shuffle_epi8(
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(
            rows + (jg + k) * pitch + w * 4)),
        bswap);
  __m256i t[8];
  for (int k = 0; k < 8; k += 2) {
    t[k] = _mm256_unpacklo_epi32(r[k], r[k + 1]);
    t[k + 1] = _mm256_unpackhi_epi32(r[k], r[k + 1]);
  }
  __m256i u[8];
  u[0] = _mm256_unpacklo_epi64(t[0], t[2]);
  u[1] = _mm256_unpackhi_epi64(t[0], t[2]);
  u[2] = _mm256_unpacklo_epi64(t[1], t[3]);
  u[3] = _mm256_unpackhi_epi64(t[1], t[3]);
  u[4] = _mm256_unpacklo_epi64(t[4], t[6]);
  u[5] = _mm256_unpackhi_epi64(t[4], t[6]);
  u[6] = _mm256_unpacklo_epi64(t[5], t[7]);
  u[7] = _mm256_unpackhi_epi64(t[5], t[7]);
  for (int k = 0; k < 4; ++k) {
    __m256i a = _mm256_permute2x128_si256(u[k], u[4 + k], 0x20);
    __m256i b = _mm256_permute2x128_si256(u[k], u[4 + k], 0x31);
    _mm256_store_si256(reinterpret_cast<__m256i*>(stage + (w + k) * 16 + jg), a);
    _mm256_store_si256(reinterpret_cast<__m256i*>(stage + (w + 4 + k) * 16 + jg), b);
  }
}
#endif

// `stage` is a 64-byte-aligned (W_max, 16) u32 thread-local scratch.
// Lines [W, W_full) are emitted as zeros (the rung tail of short stream
// rows): the packer owns the whole zero contract, so callers can hand in
// UNINITIALIZED output buffers — an np.zeros/calloc paid a full
// 12 MB read+write memset per batch before packing even started.
inline void transpose_group16(const uint8_t* rows, int64_t pitch, int64_t W,
                              int64_t W_full, uint32_t* out, uint32_t* stage) {
  int64_t w = 0;
#if defined(__AVX2__)
  for (; w + 8 <= W; w += 8) {
    transpose8x8_stage(rows, pitch, w, stage, 0);
    transpose8x8_stage(rows, pitch, w, stage, 8);
  }
#endif
  for (; w < W; ++w) {
    uint32_t* line = stage + w * 16;
    for (int j = 0; j < 16; ++j) {
      uint32_t v;
      std::memcpy(&v, rows + j * pitch + w * 4, 4);
      line[j] = __builtin_bswap32(v);
    }
  }
#if defined(__AVX2__)
  if ((reinterpret_cast<uintptr_t>(out) & 31) == 0) {
    // NT sweep: every output line written once, whole, with no loads
    // interleaved from beyond L1 (the stage is hot).
    for (int64_t v = 0; v < W; ++v) {
      __m256i a = _mm256_load_si256(reinterpret_cast<const __m256i*>(stage + v * 16));
      __m256i b = _mm256_load_si256(reinterpret_cast<const __m256i*>(stage + v * 16 + 8));
      _mm256_stream_si256(reinterpret_cast<__m256i*>(out + v * 1024), a);
      _mm256_stream_si256(reinterpret_cast<__m256i*>(out + v * 1024 + 8), b);
    }
    const __m256i z = _mm256_setzero_si256();
    for (int64_t v = W; v < W_full; ++v) {
      _mm256_stream_si256(reinterpret_cast<__m256i*>(out + v * 1024), z);
      _mm256_stream_si256(reinterpret_cast<__m256i*>(out + v * 1024 + 8), z);
    }
    return;
  }
#endif
  for (int64_t v = 0; v < W; ++v)
    std::memcpy(out + v * 1024, stage + v * 16, 64);
  for (int64_t v = W; v < W_full; ++v)
    std::memset(out + v * 1024, 0, 64);
}

// Zero the quantization tail: rows [n, total_rows) of the tile-major
// output (total_rows is a multiple of 1024).  Within the partial tile a
// row range is a contiguous column suffix of every word-plane line; whole
// trailing tiles are one block memset.  This replaces the caller-side
// calloc of the WHOLE buffer: a full bucket (the engine's steady state)
// now zeroes nothing at all.
void zero_row_tail(uint32_t* out, int64_t words_per, int64_t n,
                   int64_t total_rows) {
  int64_t tile = n >> 10;
  const int64_t col = n & 1023;
  const int64_t total_tiles = total_rows >> 10;
  if (col) {
    uint32_t* tbase = out + tile * words_per * 1024;
    for (int64_t w = 0; w < words_per; ++w)
      std::memset(tbase + w * 1024 + col, 0, size_t((1024 - col) * 4));
    ++tile;
  }
  if (tile < total_tiles)
    std::memset(out + tile * words_per * 1024, 0,
                size_t((total_tiles - tile) * words_per * 4096));
}

// Pad leaves r0 .. r0+15 (fewer at the end of the bucket) into contiguous
// scratch rows, then transpose the group into the tile-major output.  Groups
// are 16-lane-aligned so they never straddle a tile (16 | 1024).  `src(i)`
// is leaf i's first byte.  `exact` buckets place the length footer at the
// full row pitch; stream buckets at each leaf's real padded boundary.  A
// partial tail group zeroes its unused scratch rows, so its rows past n are
// written as zeros.  `len(i)` is leaf i's length.
template <class Src, class Len>
inline void pack_group16(const Src& src, const Len& len, int64_t n, int64_t r0,
                         int64_t words_per, bool exact, uint32_t* out,
                         uint8_t* scratch, uint32_t* stage) {
  const int64_t pitch_bytes = words_per * 4;
  const int cnt = int(n - r0 < 16 ? n - r0 : 16);
#if defined(__SSE2__) || defined(_M_X64)
  // The engine packs batches in bit-reversed leaf order, so offsets
  // arrive permuted and each row's source is a random ~100 B read over
  // the whole batch — DRAM-latency-bound (measured 2.3x slower than
  // sequential).  Prefetch the NEXT group's sources while padding this
  // one; the pattern is fully known from the offset array.
  if (r0 + 16 < n) {
    const int pn = int(n - r0 - 16 < 16 ? n - r0 - 16 : 16);
    for (int j = 0; j < pn; ++j) {
      const uint8_t* p = src(r0 + 16 + j);
      const int64_t l = len(r0 + 16 + j);
      // Cap per-row prefetch: long (stream-bucket) leaves read fine
      // with the hardware prefetcher; it is the SHORT permuted rows
      // whose latency needs hiding.
      const int64_t pf = l < 512 ? l : 512;
      for (int64_t o = 0; o < pf; o += 64)
        _mm_prefetch(reinterpret_cast<const char*>(p + o), _MM_HINT_T0);
      _mm_prefetch(reinterpret_cast<const char*>(p + l - 1), _MM_HINT_T0);
    }
  }
#endif
  // Stream rows shorter than the rung capacity keep their calloc-zero
  // word planes past the group's longest real row — when the caller
  // sorts the bucket by block count, groups are near-homogeneous and
  // the zero tail of the rung is never touched at all.
  int64_t group_w = exact ? words_per : 0;
  for (int j = 0; j < cnt; ++j) {
    const int64_t l = len(r0 + j);
    const int64_t end = exact ? pitch_bytes : ((l + 9 + 63) / 64) * 64;
    if (!exact && end / 4 > group_w) group_w = end / 4;
    pad_row(scratch + j * pitch_bytes, src(r0 + j), l, end, pitch_bytes);
  }
  if (cnt < 16)
    std::memset(scratch + cnt * pitch_bytes, 0,
                size_t((16 - cnt) * pitch_bytes));
  uint32_t* base = out + (r0 >> 10) * words_per * 1024 + (r0 & 1023);
  transpose_group16(scratch, pitch_bytes, group_w, words_per, base, stage);
}

// Per-thread packing scratch: 16 padded rows and the 64-byte-aligned
// (words_per, 16) u32 stage of the two-phase store.
struct PackScratch {
  std::vector<uint8_t> rows;
  std::vector<uint32_t> stagebuf;
  uint32_t* stage = nullptr;
  void fit(int64_t words_per) {
    if (rows.size() < size_t(64 * words_per)) rows.resize(size_t(64 * words_per));
    if (stagebuf.size() < size_t(words_per * 16 + 16))
      stagebuf.resize(size_t(words_per * 16 + 16));
    stage = reinterpret_cast<uint32_t*>(
        (reinterpret_cast<uintptr_t>(stagebuf.data()) + 63) & ~uintptr_t(63));
  }
};

// The loop both bucket packers share, over an OpenMP team: groups of 16
// leaves (pack_group16), then the rows of the last tile past the last group
// are zeroed (zero_row_tail), so the caller may hand in uninitialized memory.
void pack_tiles_grouped(const uint8_t* data, const int64_t* offsets,
                        const int64_t* lengths, int64_t n, int64_t words_per,
                        bool exact, uint32_t* out, int64_t total_rows) {
  const int64_t ngroups = (n + 15) / 16;
  const auto src = [&](int64_t i) { return data + offsets[i]; };
  const auto len = [&](int64_t i) { return lengths[i]; };
#pragma omp parallel
  {
    PackScratch s;
    s.fit(words_per);
#pragma omp for schedule(dynamic, 8)
    for (int64_t g = 0; g < ngroups; ++g)
      pack_group16(src, len, n, g * 16, words_per, exact, out, s.rows.data(),
                   s.stage);
#pragma omp single nowait
    zero_row_tail(out, words_per, ((n + 15) / 16) * 16, total_rows);
#if defined(__AVX2__)
    // Each thread drains its own write-combining buffers before reaching
    // the parallel region's closing barrier: SFENCE orders only the
    // executing core's non-temporal stores, so fencing on the master
    // thread alone would leave workers' NT stores ordered merely by
    // whatever the OpenMP barrier happens to do.
    _mm_sfence();
#endif
  }
}

// What the wire pass knows of one chunk after its first walk: the byte range
// its spans cover, their payload, and where its bytes start in the region.
struct WireChunk {
  int64_t lo, hi, payload, at;
  bool dense;  // the covered range is copied whole; else span by span
};

inline uint32_t group_column(int64_t p, const int64_t* rev, int32_t k) {
  const int64_t mask = (int64_t(1) << k) - 1;
  return uint32_t(((p >> k) << k) + rev[p & mask]);
}

}  // namespace

extern "C" {

// Pack a bucket of n leaves (all padding to `nblocks` 64-byte blocks) into
// the tile-major device wire format: out is (tiles, nblocks*16, 8, 128)
// uint32 big-endian words — word w of leaf r at [r/1024, w, (r%1024)/128,
// r%128] — the layout the leaf kernels consume with zero on-
// device reshuffling (the role of the reference's Batch staging buffers,
// Batches.cpp:64-121, with the word-major twist
// that a lane-per-leaf kernel wants).  `out` may be UNINITIALIZED
// (`total_rows` = tiles*1024): the packer writes every row — real rows
// with data, rows past n with zeros — so callers skip the full-buffer
// calloc that used to cost more than the packing itself (ABI 5).
void vkmr_pack_bucket_tiles(const uint8_t* data, const int64_t* offsets,
                            const int64_t* lengths, int64_t n, int32_t nblocks,
                            uint32_t* out, int64_t total_rows) {
  pack_tiles_grouped(data, offsets, lengths, n, int64_t(nblocks) * 16,
                     /*exact=*/true, out, total_rows);
}

// Pack a *stream* bucket into the same tile-major wire format: rows of
// `cap_blocks` 64-byte message blocks, each leaf's FIPS padding (0x80 +
// 64-bit big-endian bit length) at the leaf's REAL padded block boundary;
// words past it are written as zeros (the kernel predicates those blocks
// off — packing._pack_stream_tiles semantics).  `out` may be
// UNINITIALIZED, like vkmr_pack_bucket_tiles.
void vkmr_pack_stream_bucket_tiles(const uint8_t* data, const int64_t* offsets,
                                   const int64_t* lengths, int64_t n,
                                   int32_t cap_blocks, uint32_t* out,
                                   int64_t total_rows) {
  pack_tiles_grouped(data, offsets, lengths, n, int64_t(cap_blocks) * 16,
                     /*exact=*/false, out, total_rows);
}

// The engine's flush pass onto the compact wire: a whole flush of
// exact-bucket leaves written into one slot in one call on the calling
// thread, with no OpenMP team and no allocation.  The flush is read where it
// lies: chunk c holds chunk_n[c] leaves, spans (chunk_offs[c][k],
// chunk_lens[c][k]) over the chunk_size[c] bytes at chunk_data[c]; the
// chunks' leaves in turn are the natural leaves 0..n-1 of the flush.
//
// The slot holds the row table and then the bytes, so that one copy takes a
// flush to the device, where K1 pads each leaf itself:
//   [0, 4n)        u32 byte offset of row r's leaf in the byte region
//   [4n, 8n)       u32 destination column of row r's digest
//   [8n, 10n)      u16 length of row r's leaf
//   [at, at + len) the byte region, at = 10n rounded up to 16, len a
//                  multiple of 4 (the tail past the last byte is zero)
// The rows are the leaves counting-sorted by padded block count into the
// exact buckets 1..8, in natural order within a bucket, so that a bucket's
// rows rise through the bytes; layout[4 + b - 1] is bucket b's row count.
// Natural leaf j lands at column start + j, or, with a group bit reversal
// rev of 2^rev_log2 entries, at the group's base plus rev of the in-group
// index of start + j.  Each chunk's covered byte range [least offset,
// greatest end) is copied once, newlines and all, unless it is over four
// times the chunk's payload (spans scattered over a larger buffer): then its
// spans are copied one after another.
//
// layout[0..3]: the slot bytes in use, the region's start, the region's
// length, the payload bytes.  Returns 0; 1, with nothing written, when a leaf
// needs more than min(max_blocks, 8) blocks, a span lies outside its chunk,
// a column falls outside 32 bits or rev holds an entry outside the group
// (the caller's general packer takes such a flush); -1, with nothing written
// but layout, when the slot is shorter than layout[0].
int32_t vkmr_wire_flush(int32_t nchunks, const uint8_t* const* chunk_data,
                        const int64_t* chunk_size,
                        const int64_t* const* chunk_offs,
                        const int64_t* const* chunk_lens,
                        const int64_t* chunk_n, int32_t max_blocks,
                        int64_t start, const int64_t* rev, int32_t rev_log2,
                        uint8_t* slot, int64_t slot_bytes, int64_t* layout) {
  constexpr int kMaxBlocks = 8;  // packing.UNROLL_MAX_BLOCKS
  const int64_t max_len =
      int64_t(max_blocks < kMaxBlocks ? max_blocks : kMaxBlocks) * 64 - 9;
  thread_local std::vector<WireChunk> chunks;
  chunks.resize(size_t(nchunks));

  // First walk, in chunk order: check every span, take the histogram of
  // block counts and each chunk's covered range.
  int64_t hist[kMaxBlocks + 1] = {0};
  int64_t n = 0, payload = 0, region = 0;
  for (int32_t c = 0; c < nchunks; ++c) {
    const int64_t* offs = chunk_offs[c];
    const int64_t* lens = chunk_lens[c];
    WireChunk& ch = chunks[size_t(c)];
    ch = WireChunk{INT64_MAX, 0, 0, region, true};
    for (int64_t k = 0; k < chunk_n[c]; ++k) {
      const int64_t off = offs[k], len = lens[k];
      if (len < 0 || len > max_len || off < 0 || off > chunk_size[c] - len)
        return 1;
      ++hist[(len + 9 + 63) / 64];
      ch.lo = off < ch.lo ? off : ch.lo;
      ch.hi = off + len > ch.hi ? off + len : ch.hi;
      ch.payload += len;
    }
    if (chunk_n[c] == 0) ch.lo = 0;
    ch.dense = ch.hi - ch.lo <= 4 * ch.payload;
    region += ch.dense ? ch.hi - ch.lo : ch.payload;
    n += chunk_n[c];
    payload += ch.payload;
  }
  if (start < 0 || start + n > (int64_t(1) << 32) || region > UINT32_MAX) return 1;
  const int64_t at = (10 * n + 15) / 16 * 16;
  const int64_t region_len = (region + 3) / 4 * 4;
  layout[0] = at + region_len;
  layout[1] = at;
  layout[2] = region_len;
  layout[3] = payload;
  int64_t next[kMaxBlocks + 1];
  for (int b = 1, row = 0; b <= kMaxBlocks; ++b) {
    next[b] = row;
    row += hist[b];
    layout[4 + b - 1] = hist[b];
  }
  if (layout[0] > slot_bytes) return -1;
  if (rev) {
    const int64_t g = int64_t(1) << rev_log2;
    for (int64_t i = 0; i < g; ++i)
      if (rev[i] < 0 || rev[i] >= g) return 1;
  }

  // Second walk, in natural order: each leaf's row, then its chunk's bytes.
  uint32_t* row_off = reinterpret_cast<uint32_t*>(slot);
  uint32_t* row_dst = row_off + n;
  uint16_t* row_len = reinterpret_cast<uint16_t*>(slot + 8 * n);
  uint8_t* bytes = slot + at;
  int64_t j = start;
  for (int32_t c = 0; c < nchunks; ++c) {
    const int64_t* offs = chunk_offs[c];
    const int64_t* lens = chunk_lens[c];
    const uint8_t* data = chunk_data[c];
    const WireChunk& ch = chunks[size_t(c)];
    int64_t run = ch.at;
    for (int64_t k = 0; k < chunk_n[c]; ++k, ++j) {
      const int64_t off = offs[k], len = lens[k];
      const int64_t r = next[(len + 9 + 63) / 64]++;
      if (ch.dense) {
        row_off[r] = uint32_t(ch.at + off - ch.lo);
      } else {
        row_off[r] = uint32_t(run);
        std::memcpy(bytes + run, data + off, size_t(len));
        run += len;
      }
      row_len[r] = uint16_t(len);
      row_dst[r] = rev ? group_column(j, rev, rev_log2) : uint32_t(j);
    }
    if (ch.dense && ch.hi > ch.lo)
      std::memcpy(bytes + ch.at, data + ch.lo, size_t(ch.hi - ch.lo));
  }
  std::memset(bytes + region, 0, size_t(region_len - region));
  return 0;
}

// The line split of a stream read (the role of packing.split_lines, for
// ingest.iter_line_spans): the start and length of each line of data[0, n)
// that a '\n' ends, the newline left out and empty lines kept, in order,
// the first `cap` of them written to starts/lengths.  The search begins at
// `begin`: data[0, begin) is the incomplete line carried from earlier reads
// and holds no newline, so the first line starts at 0.  Returns the number
// of complete lines, which exceeds cap when the output was too short (the
// caller scans again with room for all).  No allocation, no OpenMP.
int64_t vkmr_split_lines(const uint8_t* data, int64_t begin, int64_t n,
                         int64_t* starts, int64_t* lengths, int64_t cap) {
  int64_t count = 0, start = 0, i = begin;
  auto line = [&](int64_t nl) {
    if (count < cap) {
      starts[count] = start;
      lengths[count] = nl - start;
    }
    ++count;
    start = nl + 1;
  };
#if defined(__AVX2__)
  // 64 bytes a step: one bit a byte that is '\n', taken lowest first.
  const __m256i nl = _mm256_set1_epi8('\n');
  for (; i + 64 <= n; i += 64) {
    const __m256i a = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i));
    const __m256i b = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i + 32));
    uint64_t m = uint32_t(_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, nl))) |
                 uint64_t(uint32_t(_mm256_movemask_epi8(_mm256_cmpeq_epi8(b, nl)))) << 32;
    for (; m; m &= m - 1) line(i + __builtin_ctzll(m));
  }
#endif
  while (i < n) {
    const void* hit = std::memchr(data + i, '\n', size_t(n - i));
    if (!hit) break;
    const int64_t at = static_cast<const uint8_t*>(hit) - data;
    line(at);
    i = at + 1;
  }
  return count;
}

// glibc-compatible TYPE_3 additive-feedback rand(), reimplemented from the
// published algorithm (same stream as the reference's rndm built against
// glibc).  Fills `out` with `count` newline-terminated printable strings;
// returns the number of bytes written, or -1 if `cap` would overflow.
int64_t vkmr_rndm_stream(uint32_t seed, int64_t count, int32_t maxlen,
                         uint8_t* out, int64_t cap) {
  if (maxlen < 2) return -2;
  int32_t r[344];
  if (seed == 0) seed = 1;
  r[0] = int32_t(seed);
  for (int i = 1; i < 31; ++i) {
    // 16807 * r[i-1] % 2147483647 via Schrage, C truncating division.
    const int64_t hi = r[i - 1] / 127773;
    const int64_t lo = r[i - 1] % 127773;
    int64_t word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = int32_t(word);
  }
  for (int i = 31; i < 34; ++i) r[i] = r[i - 31];
  uint32_t ring[31];
  for (int i = 0; i < 31; ++i) ring[i] = uint32_t(r[i + 3]);
  // Discard the first 310 outputs (i = 34 .. 343).
  int pos = 0;
  auto next_rand = [&]() -> uint32_t {
    const uint32_t v = ring[pos] + ring[(pos + 28) % 31];
    ring[pos] = v;
    pos = (pos + 1) % 31;
    return v >> 1;
  };
  for (int i = 34; i < 344; ++i) (void)next_rand();

  int64_t written = 0;
  for (int64_t s = 0; s < count; ++s) {
    const int32_t len = 1 + int32_t(next_rand() % uint32_t(maxlen - 1));
    if (written + len + 1 > cap) return -1;
    for (int32_t k = 0; k < len; ++k)
      out[written++] = uint8_t(32 + next_rand() % 94u);
    out[written++] = '\n';
  }
  return written;
}

}  // extern "C"
