// Variants of the tail kernel K3, built only by tools/tail_variants.py, which
// times each beside the kernel the port ships on the same blocks and holds
// its roots byte for byte against it.
//
//   (a) one_cta_tail_kernel: the port's first K3, one CTA of 512 threads a
//       bit-reversed block, one launch a block, __syncthreads() between
//       levels, every node through vkmr::node_hash_words;
//   (b) tail_reduce_kernel<kTailPlain>: the table and cluster kernel of
//       csrc/tail_reduce.cuh with vkmr::node_hash_words on every level;
//   (c) tail_reduce_kernel<kTailPairs>: (b) with a schedule warp beside each
//       round warp;
//   (d) tail_reduce_kernel<kTailPairsImad>: (c) with the round's two-input
//       adds issued as IMAD by a multiplier of 1 passed at launch;
//   (f) tail_reduce_kernel<kTailPairsRolled>: (c) with one 16-round body
//       looped over a node's 12 chunks of rounds, ~6 KB of code a node where
//       (c)'s unrolled rounds are ~47 KB;
//   (g) tail_reduce_kernel<kTailPairsLooped>: (c) with one unrolled 64-round
//       body looped over a node's three blocks, ~15 KB of code;
//   (h) tail_reduce_kernel<kTailPairsShortE>: (c) with d + h + W[t] + K[t]
//       summed off the chain through e.
// Built with -DVKMRT_STAMPS, VKMR_TAIL_STAMP stamps the SM clock at the
// kernel's numbered points.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/sha256.cuh"

#ifdef VKMRT_STAMPS
// Built with -DVKMRT_STAMPS (a library of its own, so the timed library
// carries no hook): warp w of CTA b stamps point k of the kernel at
// g_stamps[(b * 4 + w) * 16 + k] (the SM clock), and point 15 with its SM,
// while vkmrt_set_stamps has set a buffer.
__device__ unsigned long long* g_stamps = nullptr;
#define VKMR_TAIL_STAMP(point)                                                          \
  do {                                                                                  \
    if (g_stamps != nullptr && (threadIdx.x & 31) == 0) {                               \
      unsigned long long* row = g_stamps + (blockIdx.x * 4 + (threadIdx.x >> 5)) * 16;  \
      row[point] = clock64();                                                           \
      unsigned smid;                                                                    \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));                                 \
      row[15] = smid;                                                                   \
    }                                                                                   \
  } while (0)
#endif

#include "../csrc/tail_reduce.cuh"

namespace {

constexpr int kOneCtaMax = 1024;
constexpr int kOneCtaThreads = 512;

__global__ void __launch_bounds__(kOneCtaThreads)
one_cta_tail_kernel(const uint32_t* __restrict__ x, int64_t ld, int log2n, uint32_t* __restrict__ out) {
  __shared__ uint32_t s[8][kOneCtaMax];
  const int n = 1 << log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][i] = x[j * ld + i];
  }
  __syncthreads();
  for (int half = n >> 1; half >= 1; half >>= 1) {
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      uint32_t l[8], r[8], o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l[j] = s[j][i];
        r[j] = s[j][i + half];
      }
      vkmr::node_hash_words(l, r, o);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][i] = o[j];
    }
    __syncthreads();
  }
  if (threadIdx.x < 8) out[threadIdx.x] = s[threadIdx.x][0];
}

}  // namespace

// Point the stamps at `buf` (or nowhere: null); -1 in a library without them.
extern "C" int vkmrt_set_stamps(void* buf) {
#ifdef VKMRT_STAMPS
  return (int)cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
#else
  return -1;
#endif
}

extern "C" int vkmrt_tail_table_bytes(void) { return (int)sizeof(vkmr_tail::TailTable); }

// (a) on one bit-reversed block of 2^log2n <= 1024 digests.
extern "C" int vkmrt_one_cta(const void* x, long long ld, int log2n, void* out, void* stream) {
  if (log2n < 0 || (1 << log2n) > kOneCtaMax) return (int)cudaErrorInvalidValue;
  one_cta_tail_kernel<<<1, kOneCtaThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)x, ld, log2n,
                                                                      (uint32_t*)out);
  return (int)cudaGetLastError();
}

// (b), (c), (d), (f), (g), (h) by their form number (vkmr_tail::kTailPlain, kTailPairs,
// kTailPairsImad, kTailPairsRolled, kTailPairsLooped, kTailPairsShortE) on a table, with `smem_pad` bytes of dynamic shared memory
// a CTA and, with force_cluster, in clusters of 8 even when no block is cut.
// Returns the launch's error code, or -1 for no such form.
extern "C" int vkmrt_launch(int form, const void* table, unsigned one, int smem_pad, int force_cluster,
                            void* stream) {
  const vkmr_tail::TailTable& t = *(const vkmr_tail::TailTable*)table;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case vkmr_tail::kTailPlain:
      return (int)vkmr_tail::launch_tail<vkmr_tail::kTailPlain>(t, one, smem_pad, force_cluster, s);
    case vkmr_tail::kTailPairs:
      return (int)vkmr_tail::launch_tail<vkmr_tail::kTailPairs>(t, one, smem_pad, force_cluster, s);
    case vkmr_tail::kTailPairsImad:
      return (int)vkmr_tail::launch_tail<vkmr_tail::kTailPairsImad>(t, one, smem_pad, force_cluster, s);
    case vkmr_tail::kTailPairsRolled:
      return (int)vkmr_tail::launch_tail<vkmr_tail::kTailPairsRolled>(t, one, smem_pad, force_cluster, s);
    case vkmr_tail::kTailPairsLooped:
      return (int)vkmr_tail::launch_tail<vkmr_tail::kTailPairsLooped>(t, one, smem_pad, force_cluster, s);
    case vkmr_tail::kTailPairsShortE:
      return (int)vkmr_tail::launch_tail<vkmr_tail::kTailPairsShortE>(t, one, smem_pad, force_cluster, s);
    default:
      return -1;
  }
}
