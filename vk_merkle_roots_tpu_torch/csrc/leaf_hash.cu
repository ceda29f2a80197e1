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
#include <cuda_runtime.h>
#include <stdint.h>

#include "kdebug.cuh"
#include "sha256.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kMaxBuckets = 32;  // ops/leaf_hash.py MAX_TABLE_BUCKETS
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

__device__ __forceinline__ void load_block(const uint32_t* __restrict__ p, int b, uint32_t w[16]) {
#pragma unroll
  for (int t = 0; t < 16; ++t) w[t] = __ldg(p + (int64_t)(b * 16 + t) * kTile);
}

// The bucket of this CTA: the last whose first CTA is at or below blockIdx.x.
__device__ __forceinline__ int bucket_of_cta(const LeafTable& t) {
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

extern "C" int vkmr_leaf_hash_stream(const void* table, int grid, void* stream) {
  leaf_hash_stream_kernel<<<grid, kStreamThreads, 0, (cudaStream_t)stream>>>(*(const LeafTable*)table);
  return (int)cudaGetLastError();
}

extern "C" const char* vkmr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
