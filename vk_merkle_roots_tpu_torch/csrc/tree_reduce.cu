// Tree reduction over bit-reversed, word-major (8, n) digest columns.
//
// Replaces two Pallas kernels of vk_merkle_roots_tpu/ops/tree_reduce.py:
//   * fold_level_kernel  <- _fold_kernel (:91), launched by _fold_level_pallas
//     (:103): one Merkle level, flat or within each of G contiguous groups.
//   * tail_reduce_kernel <- _tail_kernel (:157), launched by
//     _tail_reduce_pallas (:187): the last <= 10 levels; here every perfect
//     block of a tail in one launch (csrc/tail_reduce.cuh).
//
// fold_level_kernel is bound by integer issue: a node is three compressions
// (data block, constant pad block, finalization) for 64 B read and 32 B
// written.  One thread per output node; with bit-reversed storage a level is
// out[:, i] = node(x[:, i], x[:, i + m/2]) inside each group of m columns, so
// neighbouring threads read and write neighbouring columns and every access
// coalesces.  Unlike the JAX package, which leaves sub-tile levels to XLA,
// every level above 1024 digests runs here, whatever its size.
//
// tail_reduce_kernel is bound by the chain of its levels; its design is in
// csrc/tail_reduce.cuh, with the forms measured against it (PERF.md, PR 5).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kdebug.cuh"
#include "sha256.cuh"
#include "tail_reduce.cuh"

namespace {

constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
fold_level_kernel(const uint32_t* __restrict__ x, int64_t ld_in, uint32_t* __restrict__ out, int64_t ld_out,
                  int64_t half_total, int log2_half_group) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half_total) return;
  const int64_t half_group = (int64_t)1 << log2_half_group;
  const int64_t src = ((t >> log2_half_group) << (log2_half_group + 1)) + (t & (half_group - 1));
  uint32_t l[8], r[8], o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    l[j] = __ldg(x + j * ld_in + src);
    r[j] = __ldg(x + j * ld_in + src + half_group);
  }
  vkmr::node_hash_words(l, r, o);
  VKMR_KDEBUG_EMIT("fold_kernel d0[lane0]", o[0]);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j * ld_out + t] = o[j];
}

}  // namespace

extern "C" int vkmr_fold_level(const void* x, long long ld_in, void* out, long long ld_out, long long half_total,
                               int log2_half_group, void* stream) {
  const unsigned grid = (unsigned)((half_total + kFoldThreads - 1) / kFoldThreads);
  fold_level_kernel<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, ld_in, (uint32_t*)out, ld_out, half_total, log2_half_group);
  return (int)cudaGetLastError();
}

extern "C" int vkmr_tail_table_bytes(void) { return (int)sizeof(vkmr_tail::TailTable); }

// K3 over the table's t.n blocks: one cluster of 8 CTAs a block, or one CTA
// a block when none has more than 128 digests.
extern "C" int vkmr_tail_reduce(const void* table, void* stream) {
  return (int)vkmr_tail::launch_tail(*(const vkmr_tail::TailTable*)table, (cudaStream_t)stream);
}
