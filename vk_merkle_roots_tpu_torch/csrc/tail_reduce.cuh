// K3, the tail reduction: every perfect block of <= 1024 digests of a tail to
// its Merkle root, all blocks in one launch.
//
// Replaces the Pallas _tail_kernel of vk_merkle_roots_tpu/ops/tree_reduce.py
// (:157, launched by _tail_reduce_pallas, :187), which reduces one block of
// bit-reversed digests a launch.  csrc/tree_reduce.cu launches it.
//
// Bound on the H100: the dependent chain of node hashes, one level after
// another, not the card's issue rate (a 1024-digest block is 1023 nodes, 0.2
// us of the card's ALU pipes).  A level costs one node hash on the warp that
// runs its rounds, whose instructions issue at best one every second clock.
// The design keeps every level near one node's chain:
//   * one launch for a table of blocks (TailTable, a __grid_constant__
//     parameter as LeafTable is for K1/K4): a ragged tail costs its longest
//     block's chain, not the sum of its blocks' chains and host launches;
//   * a block of more than 128 digests takes a cluster of 8 CTAs: 8
//     sub-blocks of 2^(log2n-3) digests, one a CTA, each folded in its own
//     shared memory on its own SM; rank 0 then reads the 8 sub-block roots
//     from its peers' shared memory and folds the last 3 levels.  No level of
//     a CTA has more than 64 nodes, one per lane of two round warps.  Smaller
//     blocks take one CTA each, launched without clusters when no block of
//     the table is cut (a cluster launch costs ~1-2 us more there);
//   * no gather: a CTA places each digest at the bit reversal of its index
//     within the sub-block as it loads natural-order columns, or reads
//     bit-reversed columns as they lie, and folds in place
//     (out[i] = node(s[i], s[i + half])).  Natural pairs (s[2i], s[2i+1])
//     would need a second buffer, since node i would overwrite s[i] while
//     node i/2 still reads it;
//   * warp specialisation: a CTA is two pairs of warps, a round warp and a
//     schedule warp each, on four schedulers (warp index mod 4).  The round
//     warp runs the 3 x 64 rounds of its 32 nodes; the schedule warp
//     computes the data block's and the finalization block's message
//     schedules W[16..63] + K[t] ahead of them into shared memory and hands
//     them over 16 words at a time through named barriers.  The ~960
//     schedule instructions of a node leave the chain's warp.
// Measured (PERF.md, PR 5): the warp-specialised form beat every node-per-
// thread form; a level still costs 6,500-8,400 SM clocks, ~40 a round against
// ~30 of issue, the same work slower on some SMs than on others (a level's
// ~47 KB of unrolled code is fetched from outside the SM; a 15 KB form with
// one 64-round body looped over a node's 3 blocks runs at one speed on every
// SM, with more instructions, and was 8% faster at 1024 digests but 8% slower
// at 16 roots); rank 0 of a cut block waits for its slowest peer.  The forms
// measured beside this one (plain nodes, IMAD adds, rolled 16- and 64-round
// bodies, a shorter e-chain) are in
// `git show 6ab2706:vk_merkle_roots_tpu_torch/csrc/tail_reduce.cuh`, and the
// tool that timed them, with SM-clock stamps, under
// `vk_merkle_roots_tpu_torch/tools/` of that revision.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "kdebug.cuh"
#include "sha256.cuh"

namespace vkmr_tail {

constexpr int kMaxTailBlocks = 32;  // ops/tree_reduce.py MAX_TAIL_BLOCKS
constexpr int kCluster = 8;         // CTAs a block: the portable cluster size
constexpr int kShare = 128;         // digests a CTA holds
constexpr int kSoloMaxLog2 = 7;     // blocks of <= 128 digests stay on rank 0
constexpr int kThreads = 128;       // two pairs of warps
constexpr int kMaxLog2 = 10;

struct TailBlock {
  const uint32_t* x;  // (8, ld) word-major digest columns
  long long ld;
  int log2n;          // 0..10
  int bitrev;         // 1: bit-reversed fold input; 0: natural order
  int out_row;        // row of the (B, 8) output
  int pad;
};

struct TailTable {
  uint32_t* out;  // (B, 8) int32 block roots
  int n;          // blocks in use
  int pad;
  TailBlock b[kMaxTailBlocks];
};

__device__ __forceinline__ int brev_bits(int x, int bits) {
  return bits ? (int)(__brev((unsigned)x) >> (32 - bits)) : 0;
}

__device__ __forceinline__ void cta_sync() { asm volatile("bar.sync 0;\n" ::: "memory"); }
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory"); }
// bar.arrive orders this thread's earlier shared-memory writes before the
// barrier completes for the threads that wait on it: no fence needed.
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ int cluster_ctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_nctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

struct Smem {
  uint32_t s[8][kShare];      // digest words, folded in place
  uint32_t wk[2][2][64][32];  // [pair][data, finalization][t][lane]: W[t] + K[t]
  uint32_t st[2][8][32];      // [pair][word][lane]: state after the pad block
};

// Rank 0 of a cut block, at its level log2m: the 8 sub-block roots into its
// slots 0..7 (bit-reversed over 3 bits), from the peers' shared memory.  The
// second arrive lets the peers exit once the roots are read; rank 0 waits on
// it at its end.
__device__ __forceinline__ void gather_cluster_roots(Smem& sm) {
  cluster_arrive();
  cluster_wait();
  const int tid = (int)threadIdx.x;
  if (tid < (kCluster - 1) * 8) {
    const int r = 1 + tid / 8, j = tid % 8;
    const uint32_t* peer = cooperative_groups::this_cluster().map_shared_rank(&sm.s[0][0], r);
    sm.s[j][brev_bits(r, 3)] = peer[j * kShare];
  }
  cta_sync();
  cluster_arrive();
}

__device__ __forceinline__ int level_half(int lev, int log2m, int log2n) {
  return lev < log2m ? 1 << (log2m - 1 - lev) : 1 << (log2n - 1 - lev);
}

// One round with W[t] + K[t] given.
__device__ __forceinline__ void round_wk(uint32_t v[8], uint32_t wk) {
  const uint32_t t1 = v[7] + vkmr::big_sigma1(v[4]) + vkmr::ch(v[4], v[5], v[6]) + wk;
  const uint32_t e = v[3] + t1;
  const uint32_t a = t1 + vkmr::big_sigma0(v[0]) + vkmr::maj(v[0], v[1], v[2]);
  v[7] = v[6]; v[6] = v[5]; v[5] = v[4]; v[4] = e;
  v[3] = v[2]; v[2] = v[1]; v[1] = v[0]; v[0] = a;
}

__device__ __forceinline__ void feed_forward(uint32_t out[8], const uint32_t v[8], const uint32_t in[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = in[j] + v[j];
}

// The round warp's share of one level: node i = node(s[i], s[i + half]) of
// the pair's 32 nodes, three compressions whose schedules W[16..63] + K come
// from the schedule warp through barriers bar .. bar + 6.  Lanes past the
// level's last node run along (they share the warp's barriers) but store
// nothing.
__device__ __forceinline__ void round_warp_level(Smem& sm, int p, int i, int half, int bar) {
  const int lane = (int)threadIdx.x & 31;
  uint32_t w[16], iv[8], v[8], mid[8], out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = sm.s[j][i];
    w[8 + j] = sm.s[j][i + half];
  }
  vkmr::initial_state(iv);
  // Data block.
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = iv[j];
#pragma unroll
  for (int t = 0; t < 16; ++t) round_wk(v, w[t] + vkmr::kRoundK[t]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bar_sync(bar + c);
#pragma unroll
    for (int t = 16 * c + 16; t < 16 * c + 32; ++t) round_wk(v, sm.wk[p][0][t][lane]);
  }
  feed_forward(mid, v, iv);
  // Constant pad block.
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = mid[j];
#pragma unroll
  for (int t = 0; t < 64; ++t) round_wk(v, vkmr::kPad64SchedulePlusK[t]);
  feed_forward(mid, v, mid);
#pragma unroll
  for (int j = 0; j < 8; ++j) sm.st[p][j][lane] = mid[j];
  bar_arrive(bar + 3);
  // Finalization block: the digest, 0x80000000, zeros, 256.
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = iv[j];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const uint32_t wt = t < 8 ? mid[t] : t == 8 ? 0x80000000u : t == 15 ? 256u : 0u;
    round_wk(v, wt + vkmr::kRoundK[t]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bar_sync(bar + 4 + c);
#pragma unroll
    for (int t = 16 * c + 16; t < 16 * c + 32; ++t) round_wk(v, sm.wk[p][1][t][lane]);
  }
  feed_forward(out, v, iv);
  if (i < half) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sm.s[j][i] = out[j];
  }
}

// W[16..63] + K[t] of the block in w, 16 words at a time into dst[t][lane],
// each chunk released through barrier bar + c.
__device__ __forceinline__ void schedule_block(uint32_t w[16], uint32_t (*dst)[32], int bar) {
  const int lane = (int)threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int t = 16 + 16 * c; t < 32 + 16 * c; ++t) {
      const uint32_t wt = w[t & 15] + vkmr::small_sigma0(w[(t - 15) & 15]) + w[(t - 7) & 15] +
                          vkmr::small_sigma1(w[(t - 2) & 15]);
      w[t & 15] = wt;
      dst[t][lane] = wt + vkmr::kRoundK[t];
    }
    bar_arrive(bar + c);
  }
}

// The schedule warp's share of one level, for the same nodes as its round warp.
__device__ __forceinline__ void schedule_warp_level(Smem& sm, int p, int i, int half, int bar) {
  const int lane = (int)threadIdx.x & 31;
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = sm.s[j][i];
    w[8 + j] = sm.s[j][i + half];
  }
  schedule_block(w, sm.wk[p][0], bar);
  bar_sync(bar + 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = sm.st[p][j][lane];
  w[8] = 0x80000000u;
#pragma unroll
  for (int j = 9; j < 15; ++j) w[j] = 0u;
  w[15] = 256u;
  schedule_block(w, sm.wk[p][1], bar + 4);
}

// Every perfect block of the table to its root: cluster c takes block b[c],
// its CTAs the sub-blocks.  Launched in clusters of kCluster CTAs (launch_tail)
// or, when no block has more than 128 digests, of one.
__global__ void __launch_bounds__(kThreads) tail_reduce_kernel(const __grid_constant__ TailTable t) {
  __shared__ Smem sm;
  const TailBlock& bk = t.b[blockIdx.x / cluster_nctarank()];
  const int rank = cluster_ctarank();
  const int log2n = bk.log2n;
  const bool split = log2n > kSoloMaxLog2;
  if (!split && rank != 0) return;
  const int sbits = split ? 3 : 0;
  const int log2m = log2n - sbits;
  const int tid = (int)threadIdx.x;
  if (tid < (1 << log2m)) {
    // Sub-block `rank` is digests [rank * m, rank * m + m): in bit-reversed
    // storage, every 8th column from bit-reversed `rank`, already in fold
    // order; in natural order, m consecutive columns, each placed at its
    // bit-reversed slot.
    int src, slot;
    if (bk.bitrev) {
      slot = tid;
      src = (tid << sbits) | brev_bits(rank, sbits);
    } else {
      slot = brev_bits(tid, log2m);
      src = (rank << log2m) + tid;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sm.s[j][slot] = __ldg(bk.x + j * bk.ld + src);
  }
  cta_sync();
  const int levels = rank == 0 ? log2n : log2m;
  // Warps 0, 1 run rounds; warps 2, 3 their schedules; pair p = warp % 2
  // takes nodes [32p, 32p + 32) and barriers 1 + 7p .. 7 + 7p.
  const int warp = tid >> 5, p = warp & 1, i = 32 * p + (tid & 31), bar = 1 + 7 * p;
  if (warp < 2) {
#pragma unroll 1
    for (int lev = 0; lev < levels; ++lev) {
      if (lev == log2m) gather_cluster_roots(sm);
      const int half = level_half(lev, log2m, log2n);
      if (32 * p < half) round_warp_level(sm, p, i, half, bar);
      cta_sync();
    }
  } else {
#pragma unroll 1
    for (int lev = 0; lev < levels; ++lev) {
      if (lev == log2m) gather_cluster_roots(sm);
      const int half = level_half(lev, log2m, log2n);
      if (32 * p < half) schedule_warp_level(sm, p, i, half, bar);
      cta_sync();
    }
  }
  if (split) {
    if (rank != 0) {
      // Rank 0 reads this CTA's root after the first barrier; the second
      // keeps the shared memory alive until it has.
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
    }
    cluster_wait();
  }
  if (rank == 0) {
    VKMR_KDEBUG_EMIT("tail_kernel root_word0", sm.s[0][0]);
    if (tid < 8) t.out[bk.out_row * 8 + tid] = sm.s[tid][0];
  }
}

// Launch the kernel over the table: clusters of kCluster CTAs if a block has
// more than 128 digests, else one CTA a block.  Returns the launch's error
// code.
inline cudaError_t launch_tail(const TailTable& t, cudaStream_t stream) {
  if (t.n < 1 || t.n > kMaxTailBlocks) return cudaErrorInvalidValue;
  bool split = false;
  for (int k = 0; k < t.n; ++k) {
    if (t.b[k].log2n < 0 || t.b[k].log2n > kMaxLog2) return cudaErrorInvalidValue;
    split |= t.b[k].log2n > kSoloMaxLog2;
  }
  const int csize = split ? kCluster : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(t.n * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tail_reduce_kernel, t);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace vkmr_tail
