// SHA-256 mining kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tpuminter_torch/kernels/build.py).
//
// Six kernels, each replacing one Pallas kernel of
// tpuminter/kernels/sha256.py (K2, K3 and K6 in two arms), and the
// extranonce roll:
//
//   tm_sha256_batch                <- pallas_sha256_batch                (sha256.py:87)
//   tm_search_target               <- pallas_search_target               (sha256.py:257),
//                                     any template
//   tm_search_target_header        <- the same, for an 80-byte header's template
//   tm_search_candidates           <- pallas_search_candidates           (sha256.py:371),
//                                     any double-SHA template
//   tm_search_candidates_header    <- the same, for an 80-byte header's template
//   tm_search_candidates_hdr       <- pallas_search_candidates_hdr       (sha256.py:489)
//   tm_search_candidates_hdr_batch <- pallas_search_candidates_hdr_batch (sha256.py:606),
//                                     both sched arms
//   tm_min_toy                     <- pallas_min_toy                     (sha256.py:733),
//                                     any template
//   tm_min_toy_toy                 <- the same, for a toy template (data || nonce_be8)
//   tm_extranonce_roll             <- the jnp roll of tpuminter/ops/merkle.py:84
//                                     (a jitted program there, no pallas_call)
//   tm_sha256_serial_floor         <- none: the roll's yardstick, one thread's
//                                     chain of compressions with no loads
//
// What bounds the searches: 32-bit integer issue. A nonce costs one or two
// 64-round compressions (~2,400-2,700 instructions each: adds, LOP3
// logic, funnel-shift rotations) and reads or writes nothing but a few
// words per launch (K1 excepted: 80 bytes per nonce, still far below the
// issue time). Hopper issues integer work to two pipes of 64 lanes an SM
// each: the ALU pipe (IADD3, LOP3, SHF, ...) and the FMA pipe, which runs
// IMAD. Left to itself the compiler puts nearly every instruction of this
// code on the ALU pipe, which then binds alone. Design against that bound:
//   * every add of a round and of the schedule is an IMAD by an opaque
//     one (kOne), so the FMA pipe carries the adds and the ALU pipe only
//     the rotations and the logic;
//   * the message template (midstate, tail blocks, nonce byte positions)
//     is a by-value kernel argument, so one build serves every job and
//     the constants sit in the parameter bank, not in memory;
//   * rotations are single funnel shifts (__funnelshift_r), Ch and Maj
//     the two-operation forms that compile to LOP3;
//   * the message schedule is a rolling 16-word window in registers;
//   * K3-K5 run the second compression to round 60 (digest word 7) and
//     round 61 (digest word 6) only where word 7 hits, and every search
//     exits early through one device word (one per row for K5);
//   * K4/K5 take the header from device memory (the roll's output), the
//     header arms of K2 and K3 take it by value, and all keep its padding
//     words as compile-time constants, so the compiler folds the schedule
//     terms they feed; K4, K5's sched arm and the header arms also
//     compute the header's nonce-free prefix (rounds 0-2, w16, w17, most
//     of w18 and w19, and round 3 but for its nonce word) once a row or a
//     thread, outside the nonce loop;
//   * the grid-stride searches run at most 8 blocks of 256 an SM, K4 on
//     whole waves of its resident blocks (tm_sha256_occupancy reports
//     each search kernel's), so its last wave is never part-empty;
//   * K6's toy arm has the high nonce word folded into its message on
//     the host and is instantiated on the word the low one starts at, so
//     the padding's zeros are compile-time constants there too and the
//     words before it make a prefix computed once a thread;
//   * K2's header arm rejects a nonce on hash word 0 (round 60) where it
//     can neither hit the target nor lower the running minimum;
//   * reductions are per-thread, then per-block in shared memory, then
//     one small block over the per-block partials: no atomics on the
//     min path, and results do not depend on scheduling order.
//
// Every tm_* function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

// A message with a nonce-shaped hole (ops/sha256.py NonceTemplate).
// Nonce byte p is ((nonce >> pos_nshift[p]) & 0xFF) << pos_wshift[p],
// ORed into tail word pos_word[p] (block * 16 + word), nonce = hi:lo.
struct TmTemplate {
  uint32_t mid[8];
  uint32_t tail[32];
  int32_t pos_word[8];
  int32_t pos_wshift[8];
  int32_t pos_nshift[8];
  int32_t n_pos;
  int32_t n_blocks;
  int32_t dbl;
};

struct TmTarget {
  uint32_t w[8];  // msb-first hash-value words
};

// An 80-byte header (ops/sha256.py header_words): the midstate of its
// first 64 bytes and its tail words t0..t2 (Merkle word 7, time, bits).
struct TmHeader {
  uint32_t mid[8];
  uint32_t t[3];
};

// A toy message with its high nonce word fixed (ops/sha256.py ToyLaunch):
// the state before the block that holds the low word, that block's words
// (low-word bytes zero), the next block's words 0, 14 and 15 (words 1-13
// are zero), and the low word's bit offset in the word it starts in.
struct TmToy {
  uint32_t mid[8];
  uint32_t m[16];
  uint32_t m1[3];
  uint32_t shift;
};

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kNotFound = 0x7FFFFFFFu;  // first_off when nothing hit
constexpr uint32_t kCandE60 = 0u - 0x5BE0CD19u;  // -H0[7] mod 2^32: digest word 7 == 0
constexpr uint32_t kDigest6Bias = 0x1F83D9ABu;  // H0[6]

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}
__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}
__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) {
  return g ^ (e & (f ^ g));
}
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a | b));
}
__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One the compiler cannot see (a __constant__ word the host could
// rewrite). An add written as a * kOne + b stays an IMAD, which issues to
// the FMA pipe; a plain add, or an IMAD by a known 1, becomes an IADD3 on
// the ALU pipe, which the rotations and logic already fill.
__constant__ uint32_t kOne = 1u;

__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// a + b on the FMA pipe
__device__ __forceinline__ uint32_t add_f(uint32_t a, uint32_t b) { return mad(a, kOne, b); }
// b + k for a round constant k, which takes the IMAD's constant operand
__device__ __forceinline__ uint32_t add_k(uint32_t k, uint32_t b) { return mad(kOne, k, b); }

// Message schedule word w_i from w_{i-2}, w_{i-7}, w_{i-15}, w_{i-16}.
__device__ __forceinline__ uint32_t schedule(uint32_t w2, uint32_t w7, uint32_t w15,
                                             uint32_t w16) {
  return add_f(small_sigma1(w2), add_f(small_sigma0(w15), add_f(w7, w16)));
}

// One round on working variables x (a..h) with round constant k and
// schedule word w. Every add is an IMAD (FMA pipe); the rotations and the
// logic stay on the ALU pipe.
__device__ __forceinline__ void round_step(uint32_t (&x)[8], uint32_t k, uint32_t w) {
  const uint32_t t1 =
      add_f(ch(x[4], x[5], x[6]), add_f(big_sigma1(x[4]), add_f(w, add_k(k, x[7]))));
  const uint32_t a = add_f(maj(x[0], x[1], x[2]), add_f(big_sigma0(x[0]), t1));
  x[7] = x[6]; x[6] = x[5]; x[5] = x[4]; x[4] = add_f(x[3], t1);
  x[3] = x[2]; x[2] = x[1]; x[1] = x[0]; x[0] = a;
}

// Runs rounds [0, kRounds) of a compression of message m (16 words) from
// state s, leaving the working variables in v (a..h) and the rolling
// schedule window in w (w[i & 15] = w_i for the last 16 words).
template <int kRounds>
__device__ __forceinline__ void rounds(const uint32_t (&s)[8], const uint32_t* m,
                                       uint32_t (&v)[8], uint32_t (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    if (i >= 16) {
      w[i & 15] = schedule(w[(i + 14) & 15], w[(i + 9) & 15], w[(i + 1) & 15], w[i & 15]);
    }
    round_step(v, kK[i], w[i & 15]);
  }
}

__device__ __forceinline__ void compress(uint32_t (&s)[8], const uint32_t* m) {
  uint32_t v[8], w[16];
  rounds<64>(s, m, v, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = add_f(s[i], v[i]);
}

// w[g] |= x for a word index known only at run time. Every case names a
// constant index, so w stays in registers.
__device__ __forceinline__ void or_word(uint32_t (&w)[32], int g, uint32_t x) {
  switch (g) {
#define TM_CASE(k) \
  case k:          \
    w[k] |= x;     \
    break;
    TM_CASE(0) TM_CASE(1) TM_CASE(2) TM_CASE(3) TM_CASE(4) TM_CASE(5) TM_CASE(6)
    TM_CASE(7) TM_CASE(8) TM_CASE(9) TM_CASE(10) TM_CASE(11) TM_CASE(12) TM_CASE(13)
    TM_CASE(14) TM_CASE(15) TM_CASE(16) TM_CASE(17) TM_CASE(18) TM_CASE(19)
    TM_CASE(20) TM_CASE(21) TM_CASE(22) TM_CASE(23) TM_CASE(24) TM_CASE(25)
    TM_CASE(26) TM_CASE(27) TM_CASE(28) TM_CASE(29) TM_CASE(30) TM_CASE(31)
#undef TM_CASE
    default:
      break;
  }
}

// The template's first hash (midstate through every tail block).
__device__ __forceinline__ void first_hash(const TmTemplate& t, uint32_t hi,
                                           uint32_t lo, uint32_t (&s)[8]) {
  uint32_t w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = t.tail[i];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (p < t.n_pos) {
      const int ns = t.pos_nshift[p];
      const uint32_t src = ns >= 32 ? hi : lo;
      or_word(w, t.pos_word[p], ((src >> (ns & 31)) & 0xFFu) << t.pos_wshift[p]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = t.mid[i];
  compress(s, w);
  if (t.n_blocks > 1) compress(s, w + 16);
}

__device__ __forceinline__ void init_state(uint32_t (&s)[8]) {
  s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u; s[3] = 0xA54FF53Au;
  s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu; s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
}

__device__ __forceinline__ void second_block(const uint32_t (&s)[8], uint32_t (&m)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = s[i];
  m[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) m[i] = 0;
  m[15] = 256;
}

// Digest words (big-endian u32) of the template's hash of nonce hi:lo.
__device__ __forceinline__ void digest(const TmTemplate& t, uint32_t hi, uint32_t lo,
                                       uint32_t (&s)[8]) {
  first_hash(t, hi, lo, s);
  if (t.dbl) {
    uint32_t m[16];
    second_block(s, m);
    init_state(s);
    compress(s, m);
  }
}

// Whether the double hash whose first hash is `first` is a candidate:
// digest word 7 = H0[7] + e60 is 0 and digest word 6 = H0[6] + e61, read
// big-endian, is at most hw1_cap. The second compression runs rounds 0-60
// (the compiler drops the a chain past what e60 needs); round 61 runs only
// where e60 hits, on about 2^-32 of the nonces.
__device__ __forceinline__ bool second_hit(const uint32_t (&first)[8], uint32_t hw1_cap) {
  uint32_t s[8], m[16], v[8], w[16];
  second_block(first, m);
  init_state(s);
  rounds<61>(s, m, v, w);
  if (v[4] != kCandE60) return false;
  const uint32_t w61 = small_sigma1(w[11]) + w[6] + small_sigma0(w[14]) + w[13];
  const uint32_t e61 = v[3] + v[7] + big_sigma1(v[4]) + ch(v[4], v[5], v[6]) + kK[61] + w61;
  return bswap32(kDigest6Bias + e61) <= hw1_cap;
}

// ---- dynamic headers (K4, K5) -------------------------------------------
//
// An 80-byte header's second block is tail words t0..t2 (Merkle word 7,
// time, bits), the byteswapped nonce, then constant FIPS padding.

constexpr uint32_t kHdrLen = 640u;  // bit length of an 80-byte header

__device__ __forceinline__ void header_block(uint32_t t0, uint32_t t1, uint32_t t2,
                                             uint32_t nonce, uint32_t (&m)[16]) {
  m[0] = t0; m[1] = t1; m[2] = t2; m[3] = bswap32(nonce);
  m[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) m[i] = 0;
  m[15] = kHdrLen;
}

// The plain body: the whole first compression per nonce, left in x.
__device__ __forceinline__ void header_first(const uint32_t (&mid)[8], uint32_t t0, uint32_t t1,
                                             uint32_t t2, uint32_t nonce, uint32_t (&x)[8]) {
  uint32_t m[16], v[8], w[16];
  header_block(t0, t1, t2, nonce, m);
  rounds<64>(mid, m, v, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = add_f(v[i], mid[i]);
}

// What no nonce changes (ops/sha256.py prepare_hdr): the state after
// rounds 0-2, w16, w17, and w18 less sigma0(w3), w19 less w3; and round
// 3 less its nonce word w3, which enters e and a as one add each. The
// midstate is not kept: the feed-forward re-reads it (K5 from device
// memory, L1-cached; K3's header arm from the parameter bank), which
// leaves the nonce loop 8 more registers.
struct HdrPrep {
  uint32_t v[8];
  uint32_t w16, w17, p18, p19;
  uint32_t e4, a4;
};

__device__ __forceinline__ void prepare_hdr(const uint32_t (&mid)[8], uint32_t t0,
                                            uint32_t t1, uint32_t t2, HdrPrep& p) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p.v[i] = mid[i];
  round_step(p.v, kK[0], t0);
  round_step(p.v, kK[1], t1);
  round_step(p.v, kK[2], t2);
  // w9 = w10 = w11 = w12 = w14 = 0, w4 = 0x80000000, w15 = 640
  p.w16 = t0 + small_sigma0(t1);
  p.w17 = t1 + small_sigma0(t2) + small_sigma1(kHdrLen);
  p.p18 = t2 + small_sigma1(p.w16);
  p.p19 = small_sigma0(0x80000000u) + small_sigma1(p.w17);
  const uint32_t r3 = p.v[7] + big_sigma1(p.v[4]) + ch(p.v[4], p.v[5], p.v[6]) + kK[3];
  p.e4 = p.v[3] + r3;
  p.a4 = r3 + big_sigma0(p.v[0]) + maj(p.v[0], p.v[1], p.v[2]);
}

// The sched body (ops/sha256.py hash_prepared_e60_e61): rounds 3-63 of
// the first compression from a prepared header, round 3 as two adds, left
// in x; the caller adds the midstate (the feed-forward).
__device__ __forceinline__ void prepared_rounds(const HdrPrep& p, uint32_t nonce,
                                                uint32_t (&x)[8]) {
  uint32_t w[64];
  w[0] = w[1] = w[2] = 0;  // dead past round 2
  w[3] = bswap32(nonce);
  w[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) w[i] = 0;
  w[15] = kHdrLen;
  w[16] = p.w16;
  w[17] = p.w17;
  w[18] = add_f(p.p18, small_sigma0(w[3]));
  w[19] = add_f(p.p19, w[3]);
#pragma unroll
  for (int i = 20; i < 64; ++i) w[i] = schedule(w[i - 2], w[i - 7], w[i - 15], w[i - 16]);
  x[0] = add_f(p.a4, w[3]); x[1] = p.v[0]; x[2] = p.v[1]; x[3] = p.v[2];
  x[4] = add_f(p.e4, w[3]); x[5] = p.v[4]; x[6] = p.v[5]; x[7] = p.v[6];
#pragma unroll
  for (int i = 4; i < 64; ++i) round_step(x, kK[i], w[i]);
}

// Lexicographic a < b over K u32 keys.
template <int K>
__device__ __forceinline__ bool lex_less(const uint32_t (&a)[K], const uint32_t (&b)[K]) {
  bool lt = false, eq = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lt = lt || (eq && a[k] < b[k]);
    eq = eq && a[k] == b[k];
  }
  return lt;
}

// Block-wide lexicographic min of v over all threads (the last key is
// the offset, so equal values resolve to the lowest offset). The result
// is left in thread 0's v.
template <int K>
__device__ __forceinline__ void block_min(uint32_t (&v)[K]) {
  __shared__ uint32_t sh[K][kThreads];
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][tid] = v[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      uint32_t other[K];
#pragma unroll
      for (int k = 0; k < K; ++k) other[k] = sh[k][tid + stride];
      if (lex_less<K>(other, v)) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          v[k] = other[k];
          sh[k][tid] = other[k];
        }
      }
    }
    __syncthreads();
  }
}

// Writes a handle's initial words: h[i] = values[i] for i < count.
__global__ void fill_kernel(long long* h, long long v0, long long v1, int count) {
  if (threadIdx.x == 0) {
    h[0] = v0;
    if (count > 1) h[1] = v1;
  }
}

// Writes `rows` handles [v0, v1].
__global__ void fill_rows_kernel(long long* h, long long v0, long long v1, int rows) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += gridDim.x * blockDim.x) {
    h[2 * r] = v0;
    h[2 * r + 1] = v1;
  }
}

// ---- K1: digests for explicit nonces (one thread per nonce) -------------

__global__ void __launch_bounds__(kThreads)
sha256_batch_kernel(const TmTemplate t, const long long* hi, const long long* lo,
                    long long* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[8];
  digest(t, (uint32_t)hi[i], (uint32_t)lo[i], s);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[i * 8 + k] = s[k];
}

// ---- K3: first candidate offset, early exit -----------------------------
//
// Warps stride over the range 32 consecutive offsets at a time, so each
// thread's offsets ascend. A candidate does atomicMin on h[1]; before
// each step a warp reads h[1] (one broadcast load) and stops once its
// next offsets lie above it. So every offset below the final h[1] is
// evaluated, and h[1] is the lowest candidate offset in range: the
// contract CandidateSearch's remainder re-issue depends on.
__global__ void __launch_bounds__(kThreads)
search_candidates_kernel(const TmTemplate t, uint32_t base, uint32_t n,
                         uint32_t hw1_cap, unsigned long long* h) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t w0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31u); w0 < n;
       w0 += stride) {
    if (w0 > *(volatile unsigned long long*)&h[1]) break;
    const uint32_t off = w0 + lane;
    if (off < n) {
      uint32_t s[8];
      first_hash(t, 0u, base + off, s);
      if (second_hit(s, hw1_cap)) {
        atomicMin(&h[1], (unsigned long long)off);
        h[0] = 1;
      }
    }
  }
}

// ---- K3, header arm: K3 on an 80-byte header's template ------------------
//
// The template of every fixed-header job (ops/sha256.py header_template)
// is one tail block, the little-endian nonce in word 3, and the FIPS
// padding. This arm takes the header by value (midstate and t0..t2, in
// the parameter bank), so the padding folds into the schedule, and each
// thread prepares the header's nonce-free prefix once, before its nonce
// loop (K5's sched body). Same ascending warps and early exit as K3.
__global__ void __launch_bounds__(kThreads)
search_candidates_header_kernel(const TmHeader hd, uint32_t base, uint32_t n,
                                uint32_t hw1_cap, unsigned long long* h) {
  HdrPrep prep;
  prepare_hdr(hd.mid, hd.t[0], hd.t[1], hd.t[2], prep);
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t w0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31u); w0 < n;
       w0 += stride) {
    if (w0 > *(volatile unsigned long long*)&h[1]) break;
    const uint32_t off = w0 + lane;
    if (off < n) {
      uint32_t x[8];
      prepared_rounds(prep, base + off, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = add_f(x[i], hd.mid[i]);
      if (second_hit(x, hw1_cap)) {
        atomicMin(&h[1], (unsigned long long)off);
        h[0] = 1;
      }
    }
  }
}

// ---- K4: K3's test under a header read from device memory -------------
//
// The roll writes the header's midstate and tail words to device memory.
// Each thread reads the 11 words once and prepares the header's
// nonce-free prefix once, before its nonce loop (K5's sched body); each
// nonce's feed-forward re-reads the midstate (L1-resident), so no
// midstate is held across the loop. The launcher's grid is whole waves:
// the kernel's resident blocks an SM (tm_sha256_occupancy) times the SM
// count times kernels/sha256.py's HDR_WAVES. Every block sweeps the same
// share of the range, so no wave runs part-empty at the end. Same
// ascending warps and early exit as K3; a warp also stops where its next
// step would pass 2^32, so every u32 n is swept once.
__global__ void __launch_bounds__(kThreads)
search_candidates_hdr_kernel(const long long* __restrict__ mid8,
                             const long long* __restrict__ tail3, uint32_t base, uint32_t n,
                             uint32_t hw1_cap, unsigned long long* h) {
  HdrPrep prep;
  {
    uint32_t mid[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mid[i] = (uint32_t)__ldg(mid8 + i);
    prepare_hdr(mid, (uint32_t)__ldg(tail3), (uint32_t)__ldg(tail3 + 1),
                (uint32_t)__ldg(tail3 + 2), prep);
  }
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t w0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31u); w0 < n;
       w0 += stride) {
    if (w0 > *(volatile unsigned long long*)&h[1]) break;
    const uint32_t off = w0 + lane;
    if (off < n) {
      uint32_t x[8];
      prepared_rounds(prep, base + off, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = add_f(x[i], (uint32_t)__ldg(mid8 + i));
      if (second_hit(x, hw1_cap)) {
        atomicMin(&h[1], (unsigned long long)off);
        h[0] = 1;
      }
    }
    if (n - w0 <= stride) break;
  }
}

// ---- K5: K4 over B roll rows in one launch ------------------------------
//
// Row r sweeps offsets [0, min(valid_r, width)) of its own header from
// base_r and exits early on its own handle word h[2r + 1]. The grid is
// persistent and walks the flattened index row * width + off, so rows
// share every SM and a ragged or empty row (valid 0) frees its threads
// at once. Each lane's offsets ascend within a row; a lane skips the
// rest of a row once its offset passes the row's valid count or the
// row's lowest candidate so far, so every offset below the final
// h[2r + 1] is evaluated, as in K3. A lane reloads the row's header
// (and, with kSched, recomputes the row's nonce-free prefix) only when
// it moves to the next row.
template <bool kSched>
__global__ void __launch_bounds__(kThreads)
search_candidates_hdr_batch_kernel(const long long* mids, const long long* tails,
                                   const long long* bases, const long long* valids,
                                   int rows, uint32_t width, uint32_t hw1_cap,
                                   unsigned long long* h) {
  const uint32_t stride = gridDim.x * blockDim.x;
  const unsigned long long i0 = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  int row = (int)(i0 / width);
  uint32_t off = (uint32_t)(i0 - (unsigned long long)row * width);
  int loaded = -1;
  uint32_t mid[8], t0 = 0, t1 = 0, t2 = 0, base = 0, limit = 0;
  HdrPrep prep;
  while (row < rows) {
    if (row != loaded) {
#pragma unroll
      for (int i = 0; i < 8; ++i) mid[i] = (uint32_t)mids[row * 8 + i];
      t0 = (uint32_t)tails[row * 3];
      t1 = (uint32_t)tails[row * 3 + 1];
      t2 = (uint32_t)tails[row * 3 + 2];
      base = (uint32_t)bases[row];
      const long long valid = valids[row];
      limit = valid < (long long)width ? (uint32_t)(valid > 0 ? valid : 0) : width;
      if (kSched) prepare_hdr(mid, t0, t1, t2, prep);
      loaded = row;
    }
    unsigned long long* hr = h + 2 * row;
    if (off < limit && off <= *(volatile unsigned long long*)&hr[1]) {
      uint32_t x[8];
      if (kSched) {
        prepared_rounds(prep, base + off, x);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = add_f(x[i], (uint32_t)__ldg(mids + row * 8 + i));
      } else {
        header_first(mid, t0, t1, t2, base + off, x);
      }
      if (second_hit(x, hw1_cap)) {
        atomicMin(&hr[1], (unsigned long long)off);
        hr[0] = 1;
      }
      off += stride;
    } else {
      // nothing left for this lane in this row: on to its first offset
      // past the row's end
      off += ((width - 1u - off) / stride + 1u) * stride;
    }
    while (off >= width && row < rows) {
      off -= width;
      ++row;
    }
  }
}

// ---- the extranonce roll: one thread per extranonce row -----------------
//
// A row is one serial chain of about 42 compressions (the coinbase's tail
// blocks and its second hash, three compressions for each branch level,
// the header's first block), and a launch holds a few rows: one warp
// runs alone on the card, so what bounds the kernel is how fast one
// chain's instructions issue and how long each round's dependent path
// is, not pipe balance across warps. The body is built for that, apart
// from the searches' throughput form (compress, round_step):
//   * plain adds (IADD3), no IMAD by kOne: h + K + W is formed before
//     the round needs it, so the e chain is Sigma1/Ch -> one 3-input add,
//     and the a chain Sigma0/Maj -> one more. The same body with the adds
//     off both chains as IMADs read slower;
//   * constant messages fold at compile time: the Merkle pair's padding
//     block is 64 literal sums K[i] + W[i] (kPad512KW, no schedule), and
//     the second hash's words 8-15 are literals (the reference's _PAD512
//     and _PAD256);
//   * no runtime index into a message: the host resolves the extranonce's
//     byte positions into the tail word it starts in and its bit shift
//     (ops/merkle.py extranonce_place), and each word of the two blocks it
//     can touch takes its share by a select on a compile-time word index,
//     so every message stays in registers (no local memory);
//   * the job is read ahead of the chain: the header words and the
//     extranonce's words before the first round, each coinbase tail block
//     and each branch level's sibling one compression (one level) before
//     it is used, in 16-byte loads of u32 words.
//
// job (u32 words, ops/merkle.py RollJob.words): coinbase midstate [8] |
// g0, k, mask_hi, mask_lo [4]: the extranonce's first byte sits in tail
// word g0 (0-15) at bit shift k (0, 8, 16, 24 from the word's top), and
// mask_hi:mask_lo keeps its bytes of the 8-byte stream | coinbase tail
// blocks [16 * n_blocks], extranonce bytes zeroed | branch [8 * depth] |
// header words 0-8, time, bits, 0 [12]. Every section starts on a 16-byte
// boundary. Per row: the coinbase txid (double SHA), the branch fold with
// the coinbase always on the left, then the header's first block:
// midstate (8) and tail words (3).

constexpr int kRollThreads = 32;  // rows a block
constexpr int kRollJobHead = 12;  // midstate and the extranonce's placement

// K[i] + W[i] of the padding block of a 64-byte message (0x80000000, 0 x 14,
// 512): the Merkle pair's second block.
__constant__ uint32_t kPad512KW[64] = {
    0xC28A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF374u, 0x649B69C1u, 0xF0FE4786u,
    0x0FE1EDC6u, 0x240CF254u, 0x4FE9346Fu, 0x6CC984BEu, 0x61B9411Eu, 0x16F988FAu,
    0xF2C65152u, 0xA88E5A6Du, 0xB019FC65u, 0xB9D99EC7u, 0x9A1231C3u, 0xE70EEAA0u,
    0xFDB1232Bu, 0xC7353EB0u, 0x3069BAD5u, 0xCB976D5Fu, 0x5A0F118Fu, 0xDC1EEEFDu,
    0x0A35B689u, 0xDE0B7A04u, 0x58F4CA9Du, 0xE15D5B16u, 0x007F3E86u, 0x37088980u,
    0xA507EA32u, 0x6FAB9537u, 0x17406110u, 0x0D8CD6F1u, 0xCDAA3B6Du, 0xC0BBBE37u,
    0x83613BDAu, 0xDB48A363u, 0x0B02E931u, 0x6FD15CA7u, 0x521AFACAu, 0x31338431u,
    0x6ED41A95u, 0x6D437890u, 0xC39C91F2u, 0x9ECCABBDu, 0xB5C9A0E6u, 0x532FB63Cu,
    0xD2C741C6u, 0x07237EA3u, 0xA4954B68u, 0x4C191D76u};

// One round on x (a..h) given hkw = h + K[i] + W[i], which is ready
// before the round.
__device__ __forceinline__ void round_lat(uint32_t (&x)[8], uint32_t hkw) {
  const uint32_t s1 = big_sigma1(x[4]), c = ch(x[4], x[5], x[6]);
  const uint32_t e = (x[3] + hkw) + s1 + c;
  const uint32_t a = (hkw + s1 + c) + big_sigma0(x[0]) + maj(x[0], x[1], x[2]);
  x[7] = x[6]; x[6] = x[5]; x[5] = x[4]; x[4] = e;
  x[3] = x[2]; x[2] = x[1]; x[1] = x[0]; x[0] = a;
}

// s = compress(s, m), the schedule a rolling window beside the rounds.
__device__ __forceinline__ void compress_lat(uint32_t (&s)[8], const uint32_t (&m)[16]) {
  uint32_t v[8], w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      w[i & 15] = small_sigma1(w[(i + 14) & 15]) + w[(i + 9) & 15] +
                  small_sigma0(w[(i + 1) & 15]) + w[i & 15];
    }
    round_lat(v, v[7] + kK[i] + w[i & 15]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += v[i];
}

// s = compress(s, the padding block of a 64-byte message): no schedule.
__device__ __forceinline__ void compress_pad512(uint32_t (&s)[8]) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = s[i];
#pragma unroll
  for (int i = 0; i < 64; ++i) round_lat(v, v[7] + kPad512KW[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += v[i];
}

// SHA-256 of a 32-byte message d (the second hash of a double SHA), in
// place: its block's words 8-15 are literals.
__device__ __forceinline__ void hash_digest_lat(uint32_t (&d)[8]) {
  uint32_t m[16];
  second_block(d, m);
  init_state(d);
  compress_lat(d, m);
}

// Eight u32 words at p (16-byte aligned) in two 16-byte loads.
__device__ __forceinline__ void load8(const uint32_t* __restrict__ p, uint32_t* out) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ORs the extranonce's words c[0..2] into tail words g0 .. g0 + 2 of the
// block whose first tail word is 16 * b: rel = 16 * b - g0. Word i takes
// c[i + rel] where that is 0, 1 or 2; every index into m is a constant.
__device__ __forceinline__ void inject(uint32_t (&m)[16], int rel, const uint32_t (&c)[3]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = rel + i;
    m[i] |= (d == 0 ? c[0] : 0u) | (d == 1 ? c[1] : 0u) | (d == 2 ? c[2] : 0u);
  }
}

__global__ void __launch_bounds__(kRollThreads)
extranonce_roll_kernel(const uint32_t* __restrict__ job, int n_blocks, int depth,
                       const long long* __restrict__ en_hi, const long long* __restrict__ en_lo,
                       long long* __restrict__ mids, long long* __restrict__ tails, int rows) {
  const int r = blockIdx.x * kRollThreads + threadIdx.x;
  if (r >= rows) return;
  const uint32_t* tail = job + kRollJobHead;
  const uint32_t* branch = tail + 16 * n_blocks;
  const uint32_t* head = branch + 8 * depth;
  uint32_t s[8], hw[12], nxt[16], sib[8];
  load8(job, s);
  load8(head, hw);
  {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(head) + 2);
    hw[8] = q.x; hw[9] = q.y; hw[10] = q.z; hw[11] = q.w;
  }
  load8(tail, nxt);
  load8(tail + 8, nxt + 8);
  if (depth > 0) load8(branch, sib);
  // the extranonce as an 8-byte stream in message order (byte j is
  // en >> 8j), masked to its size, shifted right by k into the three
  // words it can touch
  const uint4 place = __ldg(reinterpret_cast<const uint4*>(job) + 2);
  const int g0 = (int)place.x;
  const uint32_t k = place.y;
  const uint32_t xh = bswap32((uint32_t)en_lo[r]) & place.z;
  const uint32_t xl = bswap32((uint32_t)en_hi[r]) & place.w;
  const uint32_t c[3] = {xh >> k, __funnelshift_r(xl, xh, k), __funnelshift_r(0u, xl, k)};

  for (int b = 0; b < n_blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = nxt[i];
    if (b + 1 < n_blocks) {
      load8(tail + 16 * (b + 1), nxt);
      load8(tail + 16 * (b + 1) + 8, nxt + 8);
    }
    if (b < 2) inject(m, 16 * b - g0, c);
    compress_lat(s, m);
  }
  hash_digest_lat(s);  // s = the coinbase txid's words
  for (int d = 0; d < depth; ++d) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = s[i];
      m[8 + i] = sib[i];
    }
    if (d + 1 < depth) load8(branch + 8 * (d + 1), sib);
    init_state(s);
    compress_lat(s, m);
    compress_pad512(s);
    hash_digest_lat(s);
  }
  uint32_t m[16], hs[8];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = hw[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) m[9 + i] = s[i];
  init_state(hs);
  compress_lat(hs, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) mids[8 * r + i] = hs[i];
  tails[3 * r] = s[7];
  tails[3 * r + 1] = hw[9];
  tails[3 * r + 2] = hw[10];
}

// R's serial floor: the roll's own chain for a job of n_blocks tail blocks
// and a depth-deep branch, in the roll's body, with no loads and no roll:
// each message is the last state twice over (s || s) where the roll reads
// a tail block, a sibling or the header's words, and the padding blocks
// and second hashes are the roll's. From SHA-256's initial state; out =
// the header's midstate. It times what one thread can do for a row.
__global__ void __launch_bounds__(kRollThreads)
serial_floor_kernel(int n_blocks, int depth, long long* __restrict__ out) {
  uint32_t s[8], m[16];
  init_state(s);
  // lane 0 starts at SHA-256's initial state; a start that varies by lane
  // keeps the chain on the vector pipes, as a row's is (a uniform one runs
  // on the uniform datapath)
  s[0] += threadIdx.x;
  for (int b = 0; b < n_blocks; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = m[8 + i] = s[i];
    compress_lat(s, m);
  }
  hash_digest_lat(s);
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = m[8 + i] = s[i];
    init_state(s);
    compress_lat(s, m);
    compress_pad512(s);
    hash_digest_lat(s);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = m[8 + i] = s[i];
  init_state(s);
  compress_lat(s, m);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = s[i];
  }
}

// ---- K2: full target compare + exact running minimum --------------------
//
// Same early exit as K3 on the 256-bit compare. Each thread also folds
// the lexicographic min of (hash words, offset) over what it swept; one
// partial per block goes to `partial` (9 words), and reduce_kernel<9>
// folds the partials. The min covers the whole range only when nothing
// was found (the case the caller reads it in).
//
// Both arms' result stage for one nonce's digest `s`: the 256-bit compare
// against the target (a hit lowers h[1] and sets h[0]) and the thread's
// running minimum of (hash words, offset).
__device__ __forceinline__ void target_fold(const uint32_t (&s)[8], uint32_t off,
                                            const TmTarget& tg, unsigned long long* h,
                                            uint32_t (&best)[9]) {
  uint32_t cand[9];
#pragma unroll
  for (int j = 0; j < 8; ++j) cand[j] = bswap32(s[7 - j]);
  cand[8] = off;
  bool lt = false, eq = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lt = lt || (eq && cand[j] < tg.w[j]);
    eq = eq && cand[j] == tg.w[j];
  }
  if (lt || eq) {
    atomicMin(&h[1], (unsigned long long)off);
    h[0] = 1;
  }
  if (lex_less<9>(cand, best)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) best[k] = cand[k];
  }
}

// The block's minimum of `best` to its partial (reduce_kernel<9> folds them).
__device__ __forceinline__ void write_partial(uint32_t (&best)[9], uint32_t* partial) {
  block_min<9>(best);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) partial[blockIdx.x * 9 + k] = best[k];
  }
}

__global__ void __launch_bounds__(kThreads)
search_target_kernel(const TmTemplate t, const TmTarget tg, uint32_t base,
                     uint32_t n, unsigned long long* h, uint32_t* partial) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t best[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) best[k] = 0xFFFFFFFFu;
  for (uint32_t w0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31u); w0 < n;
       w0 += stride) {
    if (w0 > *(volatile unsigned long long*)&h[1]) break;
    const uint32_t off = w0 + lane;
    if (off < n) {
      uint32_t s[8];
      digest(t, 0u, base + off, s);
      target_fold(s, off, tg, h, best);
    }
  }
  write_partial(best, partial);
}

// ---- K2, header arm: K2 on an 80-byte header's template ------------------
//
// The first hash is K3's header arm's (header by value, the prefix once a
// thread). The second compression runs to round 60, which settles hash
// word 0 = bswap(H0[7] + e60): a nonce whose word 0 lies above both the
// target's and the thread's running minimum's can neither hit nor lower
// the minimum, and past a thread's first few nonces that is nearly every
// nonce. The others (ties included) run rounds 61-63 and K2's full
// compares. Same early exit, partials and handle as K2.
__global__ void __launch_bounds__(kThreads)
search_target_header_kernel(const TmHeader hd, const TmTarget tg, uint32_t base,
                            uint32_t n, unsigned long long* h, uint32_t* partial) {
  HdrPrep prep;
  prepare_hdr(hd.mid, hd.t[0], hd.t[1], hd.t[2], prep);
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t best[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) best[k] = 0xFFFFFFFFu;
  for (uint32_t w0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31u); w0 < n;
       w0 += stride) {
    if (w0 > *(volatile unsigned long long*)&h[1]) break;
    const uint32_t off = w0 + lane;
    if (off < n) {
      uint32_t x[8];
      prepared_rounds(prep, base + off, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = add_f(x[i], hd.mid[i]);
      uint32_t s[8], m[16], v[8], w[16];
      second_block(x, m);
      init_state(s);
      rounds<61>(s, m, v, w);
      const uint32_t hw0 = bswap32(s[7] + v[4]);
      if (hw0 <= tg.w[0] || hw0 <= best[0]) {
#pragma unroll
        for (int i = 61; i < 64; ++i) {
          w[i & 15] = schedule(w[(i + 14) & 15], w[(i + 9) & 15], w[(i + 1) & 15], w[i & 15]);
          round_step(v, kK[i], w[i & 15]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] += v[j];
        target_fold(s, off, tg, h, best);
      }
    }
  }
  write_partial(best, partial);
}

// ---- K6: toy-dialect min over 64-bit nonces, no early exit --------------
__global__ void __launch_bounds__(kThreads)
min_toy_kernel(const TmTemplate t, uint32_t base_hi, uint32_t base_lo, uint32_t n,
               uint32_t* partial) {
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t best[3] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
  for (uint32_t off = blockIdx.x * blockDim.x + threadIdx.x; off < n; off += stride) {
    const uint32_t lo = base_lo + off;
    const uint32_t hi = base_hi + (lo < base_lo ? 1u : 0u);  // 64-bit carry
    uint32_t s[8];
    digest(t, hi, lo, s);
    const uint32_t cand[3] = {s[0], s[1], off};
    if (lex_less<3>(cand, best)) {
      best[0] = cand[0];
      best[1] = cand[1];
      best[2] = cand[2];
    }
  }
  block_min<3>(best);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partial[blockIdx.x * 3 + k] = best[k];
  }
}

// ---- K6, toy arm: K6 on a toy template (data || nonce_be8) ---------------
//
// A launch sweeps low words under one high word, which the host has ORed
// into the message (TmToy; a launch across a 2^32 boundary is two, one
// per high word). The low word begins at word K of its block (a template
// parameter, 0-15) and spills into word K + 1 when unaligned; the FIPS
// padding makes every later word but the length zero. So each schedule
// word's kind is known when the kernel is compiled: zero, fixed (the
// same for every nonce of the launch) or the nonce's. Zero terms vanish,
// fixed terms are summed in plain adds the compiler hoists out of the
// nonce loop, and only the nonce's terms are IMADs in it. Rounds 0..K-1
// and round K but for its word run once a thread. K >= 13 has a second
// block (the low word ends in it only at K = 15); else one.

enum : int { kZero = 0, kFixed = 1, kNonce = 2 };

// Kind of message word i (< 16) of block b for the low word at word k.
__host__ __device__ constexpr int toy_word_kind(int k, int b, int i) {
  if (b == 1) return i == 0 ? (k == 15 ? kNonce : kZero) : i >= 14 ? kFixed : kZero;
  if (i < k) return kFixed;
  if (i <= k + 1) return kNonce;
  return k <= 12 && i >= 14 ? kFixed : kZero;  // the length, in the last block
}

// Kind of schedule word i (< 64): the largest of its terms' (zero <
// fixed < nonce; sigma0 and sigma1 of zero are zero).
__host__ __device__ constexpr int toy_kind(int k, int b, int i) {
  int kind[64] = {};
  for (int j = 0; j <= i; ++j) {
    if (j < 16) {
      kind[j] = toy_word_kind(k, b, j);
      continue;
    }
    int m = kind[j - 2];
    if (kind[j - 7] > m) m = kind[j - 7];
    if (kind[j - 15] > m) m = kind[j - 15];
    if (kind[j - 16] > m) m = kind[j - 16];
    kind[j] = m;
  }
  return kind[i];
}

// s + x on the FMA pipe, or x where nothing is summed yet.
template <bool kHave>
__device__ __forceinline__ uint32_t acc_f(uint32_t s, uint32_t x) {
  if constexpr (kHave) {
    return add_f(x, s);
  } else {
    return x;
  }
}

// Schedule word I of block B: its fixed terms in plain adds, then its
// nonce terms as IMADs; a zero term adds nothing.
template <int K, int B, int I>
__device__ __forceinline__ void toy_sched(uint32_t (&w)[64]) {
  constexpr int a = toy_kind(K, B, I - 2), b = toy_kind(K, B, I - 7),
                c = toy_kind(K, B, I - 15), d = toy_kind(K, B, I - 16);
  const uint32_t ta = small_sigma1(w[I - 2]), tb = w[I - 7], tc = small_sigma0(w[I - 15]),
                 td = w[I - 16];
  uint32_t s = (a == kFixed ? ta : 0u) + (b == kFixed ? tb : 0u) + (c == kFixed ? tc : 0u) +
               (d == kFixed ? td : 0u);
  constexpr bool h0 = a == kFixed || b == kFixed || c == kFixed || d == kFixed;
  if constexpr (d == kNonce) s = acc_f<h0>(s, td);
  constexpr bool h1 = h0 || d == kNonce;
  if constexpr (b == kNonce) s = acc_f<h1>(s, tb);
  constexpr bool h2 = h1 || b == kNonce;
  if constexpr (c == kNonce) s = acc_f<h2>(s, tc);
  constexpr bool h3 = h2 || c == kNonce;
  if constexpr (a == kNonce) s = acc_f<h3>(s, ta);
  w[I] = s;
}

// round_step for a schedule word of kind kKind: a zero word adds
// nothing, a fixed one joins its round constant in a plain (hoisted) add.
template <int kKind>
__device__ __forceinline__ void toy_round(uint32_t (&x)[8], uint32_t k, uint32_t w) {
  uint32_t hk;
  if constexpr (kKind == kZero) {
    hk = add_k(k, x[7]);
  } else if constexpr (kKind == kFixed) {
    hk = add_f(k + w, x[7]);
  } else {
    hk = add_f(w, add_k(k, x[7]));
  }
  const uint32_t t1 = add_f(ch(x[4], x[5], x[6]), add_f(big_sigma1(x[4]), hk));
  const uint32_t a = add_f(maj(x[0], x[1], x[2]), add_f(big_sigma0(x[0]), t1));
  x[7] = x[6]; x[6] = x[5]; x[5] = x[4]; x[4] = add_f(x[3], t1);
  x[3] = x[2]; x[2] = x[1]; x[1] = x[0]; x[0] = a;
}

// The whole schedule of block B, then its rounds kFirst, kFirst + 1, ...
// In this order ptxas moves part of the fixed work to the uniform
// datapath and some adds to the FMA pipe; each word computed just before
// its round, in a rolling window as rounds<> does, ran slower on an H100.
template <int K, int B, int... I>
__device__ __forceinline__ void toy_schedule(uint32_t (&w)[64], std::integer_sequence<int, I...>) {
  (toy_sched<K, B, 16 + I>(w), ...);
}

template <int K, int B, int kFirst, int... I>
__device__ __forceinline__ void toy_rounds(uint32_t (&x)[8], const uint32_t (&w)[64],
                                           std::integer_sequence<int, I...>) {
  (toy_round<toy_kind(K, B, kFirst + I)>(x, kK[kFirst + I], w[kFirst + I]), ...);
}

// Four blocks an SM: ptxas then keeps a one-block body in 64 registers
// or fewer (80 left to itself), which ran faster on an H100; the
// two-block bodies (K >= 13) spill a little under it.
template <int K>
__global__ void __launch_bounds__(kThreads, 4)
min_toy_toy_kernel(const TmToy t, uint32_t lo0, uint32_t off0, uint32_t n, uint32_t* partial) {
  // the nonce-free prefix: rounds 0..K-1, and round K but for its word,
  // which enters e and a as one add each
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = t.mid[i];
#pragma unroll
  for (int i = 0; i < K; ++i) round_step(p, kK[i], t.m[i]);
  const uint32_t r = p[7] + big_sigma1(p[4]) + ch(p[4], p[5], p[6]) + kK[K];
  const uint32_t e_k = p[3] + r, a_k = r + big_sigma0(p[0]) + maj(p[0], p[1], p[2]);
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t best[3] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n; j += stride) {
    const uint32_t lo = lo0 + j;
    const uint32_t spill = __funnelshift_r(0u, lo, t.shift);  // lo << (32 - shift), or 0
    uint32_t w[64];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i] = i == K ? t.m[i] | (lo >> t.shift) : i == K + 1 ? t.m[i] | spill : t.m[i];
    }
    toy_schedule<K, 0>(w, std::make_integer_sequence<int, 48>());
    uint32_t x[8] = {add_f(a_k, w[K]), p[0], p[1], p[2], add_f(e_k, w[K]), p[4], p[5], p[6]};
    toy_rounds<K, 0, K + 1>(x, w, std::make_integer_sequence<int, 63 - K>());
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = add_f(x[i], t.mid[i]);
    if constexpr (K >= 13) {
      uint32_t v[8];
      w[0] = K == 15 ? t.m1[0] | spill : t.m1[0];
#pragma unroll
      for (int i = 1; i < 14; ++i) w[i] = 0;
      w[14] = t.m1[1];
      w[15] = t.m1[2];
      toy_schedule<K, 1>(w, std::make_integer_sequence<int, 48>());
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = x[i];
      toy_rounds<K, 1, 0>(v, w, std::make_integer_sequence<int, 64>());
      x[0] = add_f(x[0], v[0]);
      x[1] = add_f(x[1], v[1]);
    }
    const uint32_t cand[3] = {x[0], x[1], off0 + j};
    if (lex_less<3>(cand, best)) {
      best[0] = cand[0];
      best[1] = cand[1];
      best[2] = cand[2];
    }
  }
  block_min<3>(best);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partial[blockIdx.x * 3 + k] = best[k];
  }
}

using ToyKernel = void (*)(TmToy, uint32_t, uint32_t, uint32_t, uint32_t*);

template <int... K>
ToyKernel toy_kernel(int k, std::integer_sequence<int, K...>) {
  static const ToyKernel table[] = {min_toy_toy_kernel<K>...};
  return table[k];
}

// One block folds `count` partials of K words into h[first .. first+K).
template <int K>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const uint32_t* partial, int count, long long* h, int first) {
  uint32_t best[K];
#pragma unroll
  for (int k = 0; k < K; ++k) best[k] = 0xFFFFFFFFu;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    uint32_t cand[K];
#pragma unroll
    for (int k = 0; k < K; ++k) cand[k] = partial[i * K + k];
    if (lex_less<K>(cand, best)) {
#pragma unroll
      for (int k = 0; k < K; ++k) best[k] = cand[k];
    }
  }
  block_min<K>(best);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) h[first + k] = best[k];
  }
}

int finish() { return (int)cudaGetLastError(); }

}  // namespace

static_assert(sizeof(TmTemplate) == 67 * 4, "TmTemplate layout is mirrored in build.py");
static_assert(sizeof(TmHeader) == 11 * 4, "TmHeader layout is mirrored in build.py");
static_assert(sizeof(TmToy) == 28 * 4, "TmToy layout is mirrored in build.py");

extern "C" {

int tm_sha256_batch(const TmTemplate* t, const long long* hi, const long long* lo,
                    long long* out, long long n, int device, void* stream) {
  cudaSetDevice(device);
  const long long blocks = (n + kThreads - 1) / kThreads;
  sha256_batch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *t, hi, lo, out, n);
  return finish();
}

int tm_search_candidates(const TmTemplate* t, uint32_t base, uint32_t n,
                         uint32_t hw1_cap, long long* handle, int grid, int device,
                         void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  fill_kernel<<<1, 32, 0, s>>>(handle, 0, kNotFound, 2);
  search_candidates_kernel<<<grid, kThreads, 0, s>>>(
      *t, base, n, hw1_cap, (unsigned long long*)handle);
  return finish();
}

int tm_search_candidates_header(const TmHeader* hd, uint32_t base, uint32_t n,
                                uint32_t hw1_cap, long long* handle, int grid, int device,
                                void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  fill_kernel<<<1, 32, 0, s>>>(handle, 0, kNotFound, 2);
  search_candidates_header_kernel<<<grid, kThreads, 0, s>>>(
      *hd, base, n, hw1_cap, (unsigned long long*)handle);
  return finish();
}

int tm_search_target(const TmTemplate* t, const TmTarget* target, uint32_t base,
                     uint32_t n, long long* handle, uint32_t* partial, int grid,
                     int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  fill_kernel<<<1, 32, 0, s>>>(handle, 0, kNotFound, 2);
  search_target_kernel<<<grid, kThreads, 0, s>>>(
      *t, *target, base, n, (unsigned long long*)handle, partial);
  reduce_kernel<9><<<1, kThreads, 0, s>>>(partial, grid, handle, 2);
  return finish();
}

int tm_search_target_header(const TmHeader* hd, const TmTarget* target, uint32_t base,
                            uint32_t n, long long* handle, uint32_t* partial, int grid,
                            int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  fill_kernel<<<1, 32, 0, s>>>(handle, 0, kNotFound, 2);
  search_target_header_kernel<<<grid, kThreads, 0, s>>>(
      *hd, *target, base, n, (unsigned long long*)handle, partial);
  reduce_kernel<9><<<1, kThreads, 0, s>>>(partial, grid, handle, 2);
  return finish();
}

int tm_search_candidates_hdr(const long long* mid8, const long long* tail3, uint32_t base,
                             uint32_t n, uint32_t hw1_cap, long long* handle, int grid,
                             int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  fill_kernel<<<1, 32, 0, s>>>(handle, 0, kNotFound, 2);
  search_candidates_hdr_kernel<<<grid, kThreads, 0, s>>>(
      mid8, tail3, base, n, hw1_cap, (unsigned long long*)handle);
  return finish();
}

int tm_search_candidates_hdr_batch(const long long* mids, const long long* tails,
                                   const long long* bases, const long long* valids,
                                   int rows, uint32_t width, uint32_t hw1_cap, int sched,
                                   long long* handle, int grid, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  fill_rows_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      handle, 0, kNotFound, rows);
  unsigned long long* h = (unsigned long long*)handle;
  if (sched) {
    search_candidates_hdr_batch_kernel<true><<<grid, kThreads, 0, s>>>(
        mids, tails, bases, valids, rows, width, hw1_cap, h);
  } else {
    search_candidates_hdr_batch_kernel<false><<<grid, kThreads, 0, s>>>(
        mids, tails, bases, valids, rows, width, hw1_cap, h);
  }
  return finish();
}

// job: ops/merkle.py RollJob.words() as u32 words, 16-byte aligned.
int tm_extranonce_roll(const uint32_t* job, int n_blocks, int depth, const long long* en_hi,
                       const long long* en_lo, long long* mids, long long* tails, int rows,
                       int device, void* stream) {
  if (n_blocks < 1 || depth < 0 || rows < 1 || ((uintptr_t)job & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaSetDevice(device);
  extranonce_roll_kernel<<<(rows + kRollThreads - 1) / kRollThreads, kRollThreads, 0,
                           (cudaStream_t)stream>>>(job, n_blocks, depth, en_hi, en_lo, mids,
                                                   tails, rows);
  return finish();
}

// out: 8 words, serial_floor_kernel's last state for a job of n_blocks
// tail blocks and a depth-deep branch.
int tm_sha256_serial_floor(int n_blocks, int depth, long long* out, int device, void* stream) {
  if (n_blocks < 1 || depth < 0) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  serial_floor_kernel<<<1, kRollThreads, 0, (cudaStream_t)stream>>>(n_blocks, depth, out);
  return finish();
}

int tm_min_toy(const TmTemplate* t, uint32_t base_hi, uint32_t base_lo, uint32_t n,
               long long* handle, uint32_t* partial, int grid, int device,
               void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  min_toy_kernel<<<grid, kThreads, 0, s>>>(*t, base_hi, base_lo, n, partial);
  reduce_kernel<3><<<1, kThreads, 0, s>>>(partial, grid, handle, 0);
  return finish();
}

// Offsets [0, split) under t0 from low word lo0, then [split, n) under t1
// (the next high word) from low word 0, on grid0 and grid1 blocks; one
// reduce folds both launches' partials.
int tm_min_toy_toy(const TmToy* t0, const TmToy* t1, int k, uint32_t lo0, uint32_t split,
                   uint32_t n, long long* handle, uint32_t* partial, int grid0, int grid1,
                   int device, void* stream) {
  if (k < 0 || k > 15 || split == 0 || split > n) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const ToyKernel kernel = toy_kernel(k, std::make_integer_sequence<int, 16>());
  kernel<<<grid0, kThreads, 0, s>>>(*t0, lo0, 0u, split, partial);
  int count = grid0;
  if (split < n) {
    kernel<<<grid1, kThreads, 0, s>>>(*t1, 0u, split, n - split, partial + 3 * grid0);
    count += grid1;
  }
  reduce_kernel<3><<<1, kThreads, 0, s>>>(partial, count, handle, 0);
  return finish();
}

// Resident blocks of kThreads threads per SM, and registers a thread, of
// the grid-stride search kernel `which`: 0 K4, 1 K3's header arm, 2 K2's
// header arm, 3 and 4 K5 (sched off, on), 5 + k K6's toy arm <k>. A
// grid of blocks_per_sm x SMs blocks is one whole wave.
int tm_sha256_occupancy(int which, int device, int* blocks_per_sm, int* regs) {
  const void* fns[] = {
      (const void*)search_candidates_hdr_kernel, (const void*)search_candidates_header_kernel,
      (const void*)search_target_header_kernel,
      (const void*)search_candidates_hdr_batch_kernel<false>,
      (const void*)search_candidates_hdr_batch_kernel<true>};
  constexpr int kFns = sizeof(fns) / sizeof(fns[0]);
  if (which < 0 || which >= kFns + 16) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const void* fn = which < kFns
                       ? fns[which]
                       : (const void*)toy_kernel(which - kFns,
                                                 std::make_integer_sequence<int, 16>());
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, fn);
  *regs = attr.numRegs;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0);
  return finish();
}

}  // extern "C"
