// Leaf hashing ("mapping"): SHA-256d of every leaf of a flush's packed buckets.
//
// Replaces two Pallas kernels of vk_merkle_roots_tpu/ops/leaf_hash.py:
//   * leaf_hash_exact_kernel  <- _leaf_kernel (:61), launched by _bucket_hashes
//     (:88) and bucket_hash_append (:117): exact buckets, one block count each.
//   * leaf_hash_stream_kernel <- _stream_kernel (:129), launched by
//     _stream_bucket_hashes (:171): long leaves on rungs of cap blocks, each
//     leaf with its own block count.
//
// Bound on the H100: integer issue across the card, and for long leaves the
// chain of one leaf's dependent compressions (64 dependent rounds each, about
// 1.6 us for a lone warp) against 64 bytes loaded per block.  The TPU launches one grid per
// bucket; here one launch takes every bucket of one kind in a flush, from a
// table passed as a __grid_constant__ parameter (LeafTable, 1.3 KB of the
// 4 KB parameter space).  Buckets with the most blocks come first in the
// table and take the lowest blockIdx, so the longest chains start first.
//
//   * exact: 128-thread CTAs, one leaf per thread.  A 2^16-leaf flush of
//     1..3-block leaves is ~512 CTAs over the 132 SMs, where one launch per
//     bucket left each launch under one wave.
//   * stream: CTAs of one warp holding `leaves_per_cta` consecutive leaves of
//     one rung (the wrapper derives it from the flush's stream-leaf count
//     against 4 x the SM count: one warp per scheduler, 1..32 lanes busy).  A
//     flush's ~1000 long leaves then run on all 528 schedulers at once and
//     the flush costs about its longest chain, where a 256-thread CTA per
//     rung put each rung on one SM and the rungs ran back to back.
//
// Each thread reads the tile-major wire format that packing.pack_spans emits
// (word w of leaf r at (r/1024)*W*1024 + w*1024 + r%1024): the lanes of a warp
// hold consecutive leaves, so every load coalesces.  Block b+1's 16 words are
// in flight while block b compresses, which takes the load latency off the
// round chain: in the exact kernel as loads into a second register buffer
// (ping-pong), in the stream kernel as cp.async copies into a second
// shared-memory buffer, measured 23-27% faster than the registers on a
// long-leaf flush (PERF.md, PR 4).  Digests are stored
// word-major into an (8, ld) output at each bucket's first column, so the
// engine hashes straight into its slice buffer.  A stream leaf loops over its
// own real block count only.
//
// The compact wire (packing.WireFlush): the engine's flushes of short leaves
// reach the card as their raw bytes and a row table (u32 byte offset, u16
// length, u32 destination column), 1.5x fewer bytes than padded words for
// 1-126 B leaves, and no pad, transpose or reorder on the host.  The exact
// kernel's second overload reads it, as the reference's shader pads
// (SHA-256.comp:207-285): one leaf per thread, the bucket's block count fixed
// per CTA, rows in table order; each thread takes its row's bytes with
// aligned 4-byte loads, funnels them into big-endian words with __byte_perm,
// sets the 0x80 byte and the bit length in registers, and stores its digest
// at its row's column, which folds in the slice's group bit reversal.  Block
// b+1's aligned words are in flight while block b compresses.  Rows hold
// consecutive leaves, so a warp's loads fall on a few KB of bytes; its
// stores scatter by the bit reversal.  Both overloads keep the name
// leaf_hash_exact_kernel, which the benchmark's trace reader looks for.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kdebug.cuh"
#include "sha256.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kMaxBuckets = 32;  // ops/leaf_hash.py MAX_TABLE_BUCKETS
constexpr int kMaxWireBuckets = 8;  // the exact buckets of 1..8 blocks
constexpr int kExactThreads = 128;
constexpr int kStreamThreads = 32;

struct LeafBucket {
  const uint32_t* words;   // (tiles, nblocks*16, 8, 128) tile-major words
  const int32_t* counts;   // per-leaf real block counts (stream rungs); null for exact buckets
  long long out_col;       // output column of the bucket's first leaf
  int nblocks;             // blocks per leaf (exact) or the rung's cap blocks (stream)
  int count;               // leaves
  int cta_begin;           // first CTA of the bucket in the launch
  int pad;
};

struct LeafTable {
  uint32_t* out;           // (8, ld) int32 digest columns
  long long ld;
  int n;                   // buckets in use
  int leaves_per_cta;      // exact: kExactThreads; stream: leaves per warp, 1..32
  LeafBucket b[kMaxBuckets];
};

struct WireBucket {
  int nblocks;    // blocks per leaf
  int count;      // rows
  int row_begin;  // first row of the bucket in the row table
  int cta_begin;  // first CTA of the bucket in the launch
};

struct WireTable {
  uint32_t* out;           // (8, ld) int32 digest columns
  long long ld;
  const uint8_t* bytes;    // the byte region, 4-byte aligned
  long long nbytes;        // its length, a multiple of 4
  const uint32_t* off;     // per row: byte offset into the region
  const uint32_t* dst;     // per row: destination column
  const uint16_t* len;     // per row: leaf length
  int n;                   // buckets in use
  int pad;
  WireBucket b[kMaxWireBuckets];
};

__device__ __forceinline__ void load_block(const uint32_t* __restrict__ p, int b, uint32_t w[16]) {
#pragma unroll
  for (int t = 0; t < 16; ++t) w[t] = __ldg(p + (int64_t)(b * 16 + t) * kTile);
}

// The bucket of this CTA: the last whose first CTA is at or below blockIdx.x.
template <class Table>
__device__ __forceinline__ int bucket_of_cta(const Table& t) {
  int k = 0;
  while (k + 1 < t.n && (int)blockIdx.x >= t.b[k + 1].cta_begin) ++k;
  return k;
}

__device__ __forceinline__ const uint32_t* leaf_words(const LeafBucket& bk, int r) {
  return bk.words + (int64_t)(r / kTile) * bk.nblocks * 16 * kTile + (r % kTile);
}

__device__ __forceinline__ void store_digest(const LeafTable& t, const LeafBucket& bk, int r, const uint32_t d[8]) {
  const int64_t col = bk.out_col + r;
#pragma unroll
  for (int j = 0; j < 8; ++j) t.out[j * t.ld + col] = d[j];
}

__global__ void __launch_bounds__(kExactThreads) leaf_hash_exact_kernel(const __grid_constant__ LeafTable t) {
  const LeafBucket& bk = t.b[bucket_of_cta(t)];
  const int r = ((int)blockIdx.x - bk.cta_begin) * kExactThreads + (int)threadIdx.x;
  if (r >= bk.count) return;
  const uint32_t* p = leaf_words(bk, r);
  const int nblocks = bk.nblocks;
  uint32_t s[8], x[16], y[16];
  vkmr::initial_state(s);
  load_block(p, 0, x);
#pragma unroll 1
  for (int b = 0; b < nblocks; b += 2) {
    if (b + 1 < nblocks) load_block(p, b + 1, y);
    vkmr::compress(s, x);
    if (b + 1 >= nblocks) break;
    if (b + 2 < nblocks) load_block(p, b + 2, x);
    vkmr::compress(s, y);
  }
  vkmr::finalize_sha256d(s);
  VKMR_KDEBUG_EMIT("leaf_kernel d0[lane0]", s[0]);
  store_digest(t, bk, r, s);
}

// Aligned words q = 16b .. 16b+16 of a row whose bytes start at p (aligned
// down) and span lim bytes from there; words past the row read as zero.
__device__ __forceinline__ void load_wire_words(const uint32_t* __restrict__ p, int lim, int b, uint32_t a[17]) {
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    const int q = b * 16 + k;
    a[k] = 4 * q < lim ? __ldg(p + q) : 0u;
  }
}

// Message words of one block from its 17 aligned words: the row's bytes
// from the row's offset (sel picks them, big-endian), the 0x80 byte after
// the last, zeros after that.  left: the row's bytes from this block on.
__device__ __forceinline__ void wire_block(const uint32_t a[17], uint32_t sel, int left, uint32_t w[16]) {
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    uint32_t v = __byte_perm(a[t], a[t + 1], sel);
    const int r = left - 4 * t;  // bytes of the row from this word on
    if (r < 4) v = r < 0 ? 0u : (v & ~(0xffffffffu >> (8 * r))) | (0x80000000u >> (8 * r));
    w[t] = v;
  }
}

// The compact wire's form of K1 (see the head of this file).  A row is
// bound-checked as K4 clamps its counts: its bytes are clamped into the
// region and its bucket, and a column at or past ld is never written.
__global__ void __launch_bounds__(kExactThreads) leaf_hash_exact_kernel(const __grid_constant__ WireTable t) {
  const WireBucket& bk = t.b[bucket_of_cta(t)];
  const int i = ((int)blockIdx.x - bk.cta_begin) * kExactThreads + (int)threadIdx.x;
  if (i >= bk.count) return;
  const int row = bk.row_begin + i;
  const long long col = t.dst[row];
  if (col >= t.ld) return;
  const int nblocks = bk.nblocks;
  const long long off = min((long long)t.off[row], t.nbytes);
  const int len = (int)min(min((long long)t.len[row], t.nbytes - off), (long long)(nblocks * 64 - 9));
  const uint32_t* p = reinterpret_cast<const uint32_t*>(t.bytes + (off & ~3LL));
  const int sh = (int)(off & 3);
  const uint32_t sel = (uint32_t)((sh << 12) | ((sh + 1) << 8) | ((sh + 2) << 4) | (sh + 3));
  const int lim = sh + len;
  uint32_t s[8], a[17], w[16];
  vkmr::initial_state(s);
  load_wire_words(p, lim, 0, a);
#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
    wire_block(a, sel, len - 64 * b, w);
    if (b + 1 < nblocks) {
      load_wire_words(p, lim, b + 1, a);  // in flight while block b compresses
    } else {
      w[15] = (uint32_t)len << 3;  // the bit length; its high word (w[14]) is zero
    }
    vkmr::compress(s, w);
  }
  vkmr::finalize_sha256d(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) t.out[j * t.ld + col] = s[j];
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(smem)), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kStreamThreads) leaf_hash_stream_kernel(const __grid_constant__ LeafTable t) {
  __shared__ uint32_t buf[2][16][kStreamThreads];  // [block parity][word][lane]
  const int lane = (int)threadIdx.x;
  if (lane >= t.leaves_per_cta) return;
  const LeafBucket& bk = t.b[bucket_of_cta(t)];
  const int r = ((int)blockIdx.x - bk.cta_begin) * t.leaves_per_cta + lane;
  if (r >= bk.count) return;
  const uint32_t* p = leaf_words(bk, r);
  // The host checks stream counts before the upload; the clamp only keeps a
  // bad count from reading past its row.
  const int nblocks = min(max(bk.counts[r], 0), bk.nblocks);
  // Each lane copies and reads only its own column of buf, so no barrier.
  auto copy_block = [&](int b) {
#pragma unroll
    for (int j = 0; j < 16; ++j) cp_async4(&buf[b & 1][j][lane], p + (int64_t)(b * 16 + j) * kTile);
    cp_async_commit();
  };
  uint32_t s[8], w[16];
  vkmr::initial_state(s);
  if (nblocks > 0) copy_block(0);
#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
    if (b + 1 < nblocks) {
      copy_block(b + 1);
      cp_async_wait<1>();  // block b has landed, block b+1 is in flight
    } else {
      cp_async_wait<0>();
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = buf[b & 1][j][lane];
    vkmr::compress(s, w);
  }
  vkmr::finalize_sha256d(s);
  VKMR_KDEBUG_EMIT("stream_kernel d0[lane0]", s[0]);
  store_digest(t, bk, r, s);
}

}  // namespace

extern "C" int vkmr_leaf_table_bytes(void) { return (int)sizeof(LeafTable); }

extern "C" int vkmr_leaf_hash_exact(const void* table, int grid, void* stream) {
  leaf_hash_exact_kernel<<<grid, kExactThreads, 0, (cudaStream_t)stream>>>(*(const LeafTable*)table);
  return (int)cudaGetLastError();
}

extern "C" int vkmr_wire_table_bytes(void) { return (int)sizeof(WireTable); }

extern "C" int vkmr_leaf_hash_wire(const void* table, int grid, void* stream) {
  leaf_hash_exact_kernel<<<grid, kExactThreads, 0, (cudaStream_t)stream>>>(*(const WireTable*)table);
  return (int)cudaGetLastError();
}

// The compact wire's one copy a flush: the unit's bytes from its page-locked
// slot to the device, and the slot's event recorded after the copy, in one
// call; the pass waits on that event before it writes the slot again.
extern "C" int vkmr_wire_upload(void* dst, const void* src, long long n, void* stream, void* event) {
  cudaError_t err = cudaMemcpyAsync(dst, src, (size_t)n, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err == cudaSuccess) err = cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream);
  return (int)err;
}

// An event of the current device, for vkmr_wire_upload (null on failure).
extern "C" void* vkmr_event_new(void) {
  cudaEvent_t event = nullptr;
  return cudaEventCreateWithFlags(&event, cudaEventDisableTiming) == cudaSuccess ? (void*)event : nullptr;
}

extern "C" int vkmr_event_wait(void* event) { return (int)cudaEventSynchronize((cudaEvent_t)event); }

extern "C" int vkmr_event_free(void* event) { return (int)cudaEventDestroy((cudaEvent_t)event); }

extern "C" int vkmr_leaf_hash_stream(const void* table, int grid, void* stream) {
  leaf_hash_stream_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(*(const LeafTable*)table);
  return (int)cudaGetLastError();
}

extern "C" const char* vkmr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
