// vkmr_native.cpp — native host-side hot paths of the PyTorch/CUDA port (a copy
// of vk_merkle_roots_tpu/native/vkmr_native.cpp with the same C ABI).
//
// The reference implementation is entirely native C++ (SURVEY.md §2: every
// component of its src/ is C++17 or GLSL).  This translation unit
// provides the framework's native equivalents for the *host* side of that
// inventory — the device path is the CUDA kernels of csrc/:
//
//   * scalar FIPS-180-4 SHA-256 / SHA-256d       (role of SHA-256plus.cpp)
//   * bulk leaf hashing over (offset,length) spans
//   * serial Merkle tree reduction with the odd-self-pair rule
//     (role of CpuSha256D::Root, SHA-256plus.cpp:491-556)
//   * FIPS padding + big-endian word packing of a bucket of equal-block
//     leaves (role of Batch packing, Batches.cpp:64-121, and the in-shader
//     padding, SHA-256.comp:207-285 — done host-side here by design)
//   * a glibc-compatible rand() stream generator (role of rndm, Rndm.cpp)
//
// Everything is exposed as a C ABI consumed via ctypes (no pybind11 in this
// toolchain).  Implementation is written from scratch against FIPS-180-4;
// it shares no code with the reference.
//
// Build: vk_merkle_roots_tpu_torch/_build.py (build_host_library), at first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#define VKMR_X86 1
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t kInit[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};

constexpr uint32_t kRound[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

inline uint32_t rotr(uint32_t x, unsigned n) { return (x >> n) | (x << (32u - n)); }

// One compression round over a prepared 16-word (big-endian-decoded) block.
// Scalar form; dispatched against the SHA-NI form below at runtime.
void compress_block_scalar(uint32_t state[8], const uint32_t block[16]) {
  uint32_t w[16];
  std::memcpy(w, block, sizeof(w));
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (unsigned t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15u) & 15u], w2 = w[(t - 2u) & 15u];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15u] + s0 + w[(t - 7u) & 15u] + s1;
      w[t & 15u] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + S1 + ch + kRound[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t mj = (a & b) | (c & (a | b));
    const uint32_t t2 = S0 + mj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

#ifdef VKMR_X86
// Hardware SHA-256 (SHA-NI) form of the same compression.  The reference's
// CPU engine is scalar-only (SHA-256plus.cpp:99-276); this is where a
// native rebuild earns its keep on modern x86.  Register convention per the
// ISA: STATE0 holds {A,B,E,F}, STATE1 holds {C,D,G,H} (high->low lanes);
// sha256rnds2 retires two rounds per issue, alternating register halves.
// Input words are already big-endian-decoded, so lane i of a 16-byte load
// is message word 4*j+i directly — no byte shuffle needed.

__attribute__((target("sha,sse4.1,ssse3")))
inline void shani_round4(__m128i& s0, __m128i& s1, __m128i msg4, const uint32_t* k4) {
  __m128i m = _mm_add_epi32(msg4, _mm_loadu_si128(reinterpret_cast<const __m128i*>(k4)));
  s1 = _mm_sha256rnds2_epu32(s1, s0, m);
  m = _mm_shuffle_epi32(m, 0x0E);
  s0 = _mm_sha256rnds2_epu32(s0, s1, m);
}

__attribute__((target("sha,sse4.1,ssse3")))
inline __m128i shani_sched(__m128i m0, __m128i m1, __m128i m2, __m128i m3) {
  // W[t] = W[t-16] + s0(W[t-15]) + W[t-7] + s1(W[t-2]) for the next 4 t.
  m0 = _mm_sha256msg1_epu32(m0, m1);
  m0 = _mm_add_epi32(m0, _mm_alignr_epi8(m3, m2, 4));
  return _mm_sha256msg2_epu32(m0, m3);
}

__attribute__((target("sha,sse4.1,ssse3")))
void compress_block_shani(uint32_t state[8], const uint32_t block[16]) {
  // Pack (a..h) into the {ABEF},{CDGH} registers.
  __m128i abcd = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[0]));
  __m128i efgh = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[4]));
  __m128i badc = _mm_shuffle_epi32(abcd, 0xB1);
  __m128i hgfe = _mm_shuffle_epi32(efgh, 0x1B);
  __m128i s0 = _mm_alignr_epi8(badc, hgfe, 8);      // lanes (f,e,b,a) = ABEF
  __m128i s1 = _mm_blend_epi16(hgfe, badc, 0xF0);   // lanes (h,g,d,c) = CDGH
  const __m128i save0 = s0, save1 = s1;

  __m128i m0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&block[0]));
  __m128i m1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&block[4]));
  __m128i m2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&block[8]));
  __m128i m3 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&block[12]));

  shani_round4(s0, s1, m0, &kRound[0]);
  shani_round4(s0, s1, m1, &kRound[4]);
  shani_round4(s0, s1, m2, &kRound[8]);
  shani_round4(s0, s1, m3, &kRound[12]);
  for (unsigned r = 16; r < 64; r += 16) {
    m0 = shani_sched(m0, m1, m2, m3); shani_round4(s0, s1, m0, &kRound[r + 0]);
    m1 = shani_sched(m1, m2, m3, m0); shani_round4(s0, s1, m1, &kRound[r + 4]);
    m2 = shani_sched(m2, m3, m0, m1); shani_round4(s0, s1, m2, &kRound[r + 8]);
    m3 = shani_sched(m3, m0, m1, m2); shani_round4(s0, s1, m3, &kRound[r + 12]);
  }
  s0 = _mm_add_epi32(s0, save0);
  s1 = _mm_add_epi32(s1, save1);

  // Unpack back to (a..h).
  __m128i feba = _mm_shuffle_epi32(s0, 0x1B);       // lanes (a,b,e,f)
  __m128i ghcd = _mm_shuffle_epi32(s1, 0xB1);       // lanes (g,h,c,d)
  abcd = _mm_blend_epi16(feba, ghcd, 0xF0);         // lanes (a,b,c,d)
  efgh = _mm_alignr_epi8(ghcd, feba, 8);            // lanes (e,f,g,h)
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), abcd);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), efgh);
}
// Two-message interleaved form: sha256rnds2 has multi-cycle latency on a
// serial chain; two independent messages in flight roughly double per-core
// throughput for bulk work (independent leaves / independent tree pairs).
__attribute__((target("sha,sse4.1,ssse3")))
void compress_block_shani_x2(uint32_t sA[8], const uint32_t bA[16],
                             uint32_t sB[8], const uint32_t bB[16]) {
  __m128i abcdA = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sA[0]));
  __m128i efghA = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sA[4]));
  __m128i abcdB = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sB[0]));
  __m128i efghB = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sB[4]));
  __m128i badcA = _mm_shuffle_epi32(abcdA, 0xB1), hgfeA = _mm_shuffle_epi32(efghA, 0x1B);
  __m128i badcB = _mm_shuffle_epi32(abcdB, 0xB1), hgfeB = _mm_shuffle_epi32(efghB, 0x1B);
  __m128i s0A = _mm_alignr_epi8(badcA, hgfeA, 8), s1A = _mm_blend_epi16(hgfeA, badcA, 0xF0);
  __m128i s0B = _mm_alignr_epi8(badcB, hgfeB, 8), s1B = _mm_blend_epi16(hgfeB, badcB, 0xF0);
  const __m128i save0A = s0A, save1A = s1A, save0B = s0B, save1B = s1B;

  __m128i mA[4], mB[4];
  for (int i = 0; i < 4; ++i) {
    mA[i] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&bA[4 * i]));
    mB[i] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&bB[4 * i]));
  }
  auto round4x2 = [&](const __m128i& msgA, const __m128i& msgB, const uint32_t* k4) {
    const __m128i k = _mm_loadu_si128(reinterpret_cast<const __m128i*>(k4));
    __m128i tA = _mm_add_epi32(msgA, k), tB = _mm_add_epi32(msgB, k);
    s1A = _mm_sha256rnds2_epu32(s1A, s0A, tA);
    s1B = _mm_sha256rnds2_epu32(s1B, s0B, tB);
    tA = _mm_shuffle_epi32(tA, 0x0E);
    tB = _mm_shuffle_epi32(tB, 0x0E);
    s0A = _mm_sha256rnds2_epu32(s0A, s1A, tA);
    s0B = _mm_sha256rnds2_epu32(s0B, s1B, tB);
  };
  for (int i = 0; i < 4; ++i) round4x2(mA[i], mB[i], &kRound[4 * i]);
  for (unsigned r = 16; r < 64; r += 16) {
    for (int i = 0; i < 4; ++i) {
      mA[i] = shani_sched(mA[i], mA[(i + 1) & 3], mA[(i + 2) & 3], mA[(i + 3) & 3]);
      mB[i] = shani_sched(mB[i], mB[(i + 1) & 3], mB[(i + 2) & 3], mB[(i + 3) & 3]);
      round4x2(mA[i], mB[i], &kRound[r + 4 * i]);
    }
  }
  s0A = _mm_add_epi32(s0A, save0A); s1A = _mm_add_epi32(s1A, save1A);
  s0B = _mm_add_epi32(s0B, save0B); s1B = _mm_add_epi32(s1B, save1B);
  __m128i febaA = _mm_shuffle_epi32(s0A, 0x1B), ghcdA = _mm_shuffle_epi32(s1A, 0xB1);
  __m128i febaB = _mm_shuffle_epi32(s0B, 0x1B), ghcdB = _mm_shuffle_epi32(s1B, 0xB1);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sA[0]), _mm_blend_epi16(febaA, ghcdA, 0xF0));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sA[4]), _mm_alignr_epi8(ghcdA, febaA, 8));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sB[0]), _mm_blend_epi16(febaB, ghcdB, 0xF0));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sB[4]), _mm_alignr_epi8(ghcdB, febaB, 8));
}
#endif  // VKMR_X86

using CompressFn = void (*)(uint32_t[8], const uint32_t[16]);

CompressFn pick_compress() {
#ifdef VKMR_X86
  if (std::getenv("VKMR_FORCE_SCALAR") == nullptr &&
      __builtin_cpu_supports("sha") && __builtin_cpu_supports("sse4.1") &&
      __builtin_cpu_supports("ssse3")) {
    return compress_block_shani;
  }
#endif
  return compress_block_scalar;
}

const CompressFn g_compress = pick_compress();

inline void compress_block(uint32_t state[8], const uint32_t block[16]) {
  g_compress(state, block);
}

void compress_block_x2_fallback(uint32_t sA[8], const uint32_t bA[16],
                                uint32_t sB[8], const uint32_t bB[16]) {
  g_compress(sA, bA);
  g_compress(sB, bB);
}

using CompressX2Fn = void (*)(uint32_t[8], const uint32_t[16], uint32_t[8], const uint32_t[16]);

CompressX2Fn pick_compress_x2() {
#ifdef VKMR_X86
  if (g_compress != compress_block_scalar) return compress_block_shani_x2;
#endif
  return compress_block_x2_fallback;
}

const CompressX2Fn g_compress_x2 = pick_compress_x2();

inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

inline void store_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);  p[3] = uint8_t(v);
}

// SHA-256 of an arbitrary byte span into 8 state words.
void sha256_span(const uint8_t* data, uint64_t len, uint32_t out[8]) {
  uint32_t state[8];
  std::memcpy(state, kInit, sizeof(state));
  uint32_t block[16];
  uint64_t remaining = len;
  const uint8_t* p = data;
  while (remaining >= 64) {
    for (int i = 0; i < 16; ++i) block[i] = load_be32(p + 4 * i);
    compress_block(state, block);
    p += 64;
    remaining -= 64;
  }
  uint8_t tail[128] = {0};
  std::memcpy(tail, p, size_t(remaining));
  tail[remaining] = 0x80;
  const size_t tail_len = (remaining + 9 <= 64) ? 64 : 128;
  const uint64_t bits = len * 8;
  for (int i = 0; i < 8; ++i) tail[tail_len - 8 + i] = uint8_t(bits >> (56 - 8 * i));
  for (size_t off = 0; off < tail_len; off += 64) {
    for (int i = 0; i < 16; ++i) block[i] = load_be32(tail + off + 4 * i);
    compress_block(state, block);
  }
  std::memcpy(out, state, 32);
}

// Second pass of SHA-256d: SHA-256 of a 32-byte digest held as 8 words.
void sha256_of_digest(const uint32_t in[8], uint32_t out[8]) {
  uint32_t block[16] = {0};
  std::memcpy(block, in, 32);
  block[8] = 0x80000000u;
  block[15] = 256u;
  uint32_t state[8];
  std::memcpy(state, kInit, sizeof(state));
  compress_block(state, block);
  std::memcpy(out, state, 32);
}

// SHA-256d of the concatenation of two 32-byte digests (the node rule).
void node_hash(const uint32_t l[8], const uint32_t r[8], uint32_t out[8]) {
  uint32_t block[16];
  std::memcpy(block, l, 32);
  std::memcpy(block + 8, r, 32);
  uint32_t state[8];
  std::memcpy(state, kInit, sizeof(state));
  compress_block(state, block);
  uint32_t pad[16] = {0};
  pad[0] = 0x80000000u;
  pad[15] = 512u;
  compress_block(state, pad);
  sha256_of_digest(state, out);
}

// Two independent node hashes, interleaved to hide rnds2 latency.
void node_hash_x2(const uint32_t* lA, const uint32_t* rA, uint32_t* outA,
                  const uint32_t* lB, const uint32_t* rB, uint32_t* outB) {
  uint32_t blkA[16], blkB[16], stA[8], stB[8];
  std::memcpy(blkA, lA, 32); std::memcpy(blkA + 8, rA, 32);
  std::memcpy(blkB, lB, 32); std::memcpy(blkB + 8, rB, 32);
  std::memcpy(stA, kInit, 32); std::memcpy(stB, kInit, 32);
  g_compress_x2(stA, blkA, stB, blkB);
  uint32_t pad[16] = {0};
  pad[0] = 0x80000000u;
  pad[15] = 512u;
  g_compress_x2(stA, pad, stB, pad);
  uint32_t finA[16] = {0}, finB[16] = {0};
  std::memcpy(finA, stA, 32); std::memcpy(finB, stB, 32);
  finA[8] = finB[8] = 0x80000000u;
  finA[15] = finB[15] = 256u;
  std::memcpy(stA, kInit, 32); std::memcpy(stB, kInit, 32);
  g_compress_x2(stA, finA, stB, finB);
  std::memcpy(outA, stA, 32); std::memcpy(outB, stB, 32);
}

// Interleaved SHA-256d of two independent byte spans.
void sha256d_span_x2(const uint8_t* dA, uint64_t lenA, const uint8_t* dB,
                     uint64_t lenB, uint32_t outA[8], uint32_t outB[8]) {
  uint8_t tailA[128] = {0}, tailB[128] = {0};
  const auto prep_tail = [](const uint8_t* d, uint64_t len, uint8_t* tail) -> uint64_t {
    const uint64_t rem = len % 64;
    std::memcpy(tail, d + (len - rem), size_t(rem));
    tail[rem] = 0x80;
    const uint64_t tail_len = (rem + 9 <= 64) ? 64 : 128;
    const uint64_t bits = len * 8;
    for (int i = 0; i < 8; ++i) tail[tail_len - 8 + i] = uint8_t(bits >> (56 - 8 * i));
    return len / 64 + tail_len / 64;  // total block count
  };
  const uint64_t nA = prep_tail(dA, lenA, tailA), nB = prep_tail(dB, lenB, tailB);
  const auto load_blk = [](const uint8_t* d, uint64_t len, const uint8_t* tail,
                           uint64_t idx, uint32_t blk[16]) {
    const uint8_t* p = (idx < len / 64) ? d + 64 * idx : tail + 64 * (idx - len / 64);
    for (int i = 0; i < 16; ++i) blk[i] = load_be32(p + 4 * i);
  };
  uint32_t stA[8], stB[8], blkA[16], blkB[16];
  std::memcpy(stA, kInit, 32); std::memcpy(stB, kInit, 32);
  uint64_t iA = 0, iB = 0;
  while (iA < nA && iB < nB) {
    load_blk(dA, lenA, tailA, iA++, blkA);
    load_blk(dB, lenB, tailB, iB++, blkB);
    g_compress_x2(stA, blkA, stB, blkB);
  }
  while (iA < nA) { load_blk(dA, lenA, tailA, iA++, blkA); compress_block(stA, blkA); }
  while (iB < nB) { load_blk(dB, lenB, tailB, iB++, blkB); compress_block(stB, blkB); }
  // Second pass of SHA-256d, paired.
  uint32_t finA[16] = {0}, finB[16] = {0};
  std::memcpy(finA, stA, 32); std::memcpy(finB, stB, 32);
  finA[8] = finB[8] = 0x80000000u;
  finA[15] = finB[15] = 256u;
  std::memcpy(stA, kInit, 32); std::memcpy(stB, kInit, 32);
  g_compress_x2(stA, finA, stB, finB);
  std::memcpy(outA, stA, 32); std::memcpy(outB, stB, 32);
}

void digest_words_to_bytes(const uint32_t w[8], uint8_t* out) {
  for (int i = 0; i < 8; ++i) store_be32(out + 4 * i, w[i]);
}

void digest_bytes_to_words(const uint8_t* in, uint32_t w[8]) {
  for (int i = 0; i < 8; ++i) w[i] = load_be32(in + 4 * i);
}

}  // namespace

extern "C" {

// SHA-256d of every (offset,length) span; out = n * 32 bytes of digests.
// Leaves are independent: pairs interleave in-core (x2 SHA-NI streams) and
// the pair loop parallelizes across cores.
void vkmr_leaf_hashes(const uint8_t* data, const int64_t* offsets,
                      const int64_t* lengths, int64_t n, uint8_t* out) {
#pragma omp parallel for schedule(dynamic, 128)
  for (int64_t p = 0; p < n / 2; ++p) {
    const int64_t i = 2 * p;
    uint32_t dA[8], dB[8];
    sha256d_span_x2(data + offsets[i], uint64_t(lengths[i]),
                    data + offsets[i + 1], uint64_t(lengths[i + 1]), dA, dB);
    digest_words_to_bytes(dA, out + 32 * i);
    digest_words_to_bytes(dB, out + 32 * (i + 1));
  }
  if (n & 1) {
    uint32_t d1[8], d2[8];
    sha256_span(data + offsets[n - 1], uint64_t(lengths[n - 1]), d1);
    sha256_of_digest(d1, d2);
    digest_words_to_bytes(d2, out + 32 * (n - 1));
  }
}

// Merkle root (odd-self-pair rule at every level) of n 32-byte digests.
// height < 0: reduce until a single node remains (Count() levels).
// height >= 0: run exactly `height` levels (phantom full-height rule for
// ragged slices, README.md:94).  Returns 0 on success.
int vkmr_merkle_root(const uint8_t* digests, int64_t n, int32_t height,
                     uint8_t* out) {
  if (n < 1) return -1;
  std::vector<uint32_t> level(size_t(n) * 8);
  for (int64_t i = 0; i < n; ++i) digest_bytes_to_words(digests + 32 * i, &level[size_t(i) * 8]);
  int32_t levels_run = 0;
  auto one_level = [&]() {
    const int64_t count = int64_t(level.size() / 8);
    const int64_t pairs = (count + 1) / 2;
    std::vector<uint32_t> next(size_t(pairs) * 8);
#pragma omp parallel for schedule(static) if (pairs >= 2048)
    for (int64_t i = 0; i < pairs; i += 2) {
      const uint32_t* lA = &level[size_t(2 * i) * 8];
      const uint32_t* rA = (2 * i + 1 < count) ? &level[size_t(2 * i + 1) * 8] : lA;
      if (i + 1 < pairs) {
        const uint32_t* lB = &level[size_t(2 * i + 2) * 8];
        const uint32_t* rB = (2 * i + 3 < count) ? &level[size_t(2 * i + 3) * 8] : lB;
        node_hash_x2(lA, rA, &next[size_t(i) * 8], lB, rB, &next[size_t(i + 1) * 8]);
      } else {
        node_hash(lA, rA, &next[size_t(i) * 8]);
      }
    }
    level.swap(next);
    ++levels_run;
  };
  if (height < 0) {
    while (level.size() > 8) one_level();
  } else {
    if (n > (int64_t(1) << height)) return -2;
    while (levels_run < height) one_level();
    if (level.size() != 8) return -3;
  }
  digest_words_to_bytes(level.data(), out);
  return 0;
}

// ABI/version probe for the ctypes loader.  Bump whenever an exported
// symbol is added/changed so stale .so files fail the probe and the loader
// degrades to pure Python instead of raising on a missing symbol.
int32_t vkmr_native_abi(void) { return 7; }

// 1 if the hardware SHA-256 (SHA-NI) compression is in use, else 0.
// Set VKMR_FORCE_SCALAR=1 before load to pin the scalar path (used by the
// differential tests to cover both forms).
int32_t vkmr_shani_active(void) { return g_compress == compress_block_scalar ? 0 : 1; }

}  // extern "C"
