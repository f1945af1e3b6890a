// SHA-256 mining kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tpuminter_torch/kernels/build.py).
//
// Four kernels, each replacing one Pallas kernel of
// tpuminter/kernels/sha256.py:
//
//   tm_sha256_batch       <- pallas_sha256_batch        (sha256.py:87)
//   tm_search_target      <- pallas_search_target       (sha256.py:257)
//   tm_search_candidates  <- pallas_search_candidates   (sha256.py:371)
//   tm_min_toy            <- pallas_min_toy             (sha256.py:733)
//
// What bounds them: 32-bit integer issue. A nonce costs one or two
// 64-round compressions (~2,000-2,400 integer instructions each: adds,
// LOP3 logic, funnel-shift rotations) and reads or writes nothing but a
// few words per launch (K1 excepted: 80 bytes per nonce, still far
// below the ALU time). Design against that bound:
//   * the message template (midstate, tail blocks, nonce byte positions)
//     is a by-value kernel argument, so one build serves every job and
//     the constants sit in the parameter bank, not in memory;
//   * rotations are single funnel shifts (__funnelshift_r), Ch and Maj
//     the two-operation forms that compile to LOP3;
//   * the message schedule is a rolling 16-word window in registers;
//   * K3 stops the second compression after round 61 (digest words 6
//     and 7 only), and every search exits early through one device word;
//   * reductions are per-thread, then per-block in shared memory, then
//     one small block over the per-block partials: no atomics on the
//     min path, and results do not depend on scheduling order.
//
// Every tm_* function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

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

// Runs rounds [0, rounds) of a compression of message m (16 words) from
// state s, leaving the working variables in v (a..h). The schedule is a
// rolling 16-word window.
template <int kRounds>
__device__ __forceinline__ void rounds(const uint32_t (&s)[8], const uint32_t* m,
                                       uint32_t (&v)[8], uint32_t* e60) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    if (i >= 16) {
      w[i & 15] += small_sigma0(w[(i + 1) & 15]) + w[(i + 9) & 15] +
                   small_sigma1(w[(i + 14) & 15]);
    }
    const uint32_t t1 = h + big_sigma1(e) + ch(e, f, g) + kK[i] + w[i & 15];
    const uint32_t t2 = big_sigma0(a) + maj(a, b, c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
    if (i == 60 && e60 != nullptr) *e60 = e;
  }
  v[0] = a; v[1] = b; v[2] = c; v[3] = d;
  v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

__device__ __forceinline__ void compress(uint32_t (&s)[8], const uint32_t* m) {
  uint32_t v[8];
  rounds<64>(s, m, v, nullptr);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += v[i];
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

// (e60, e61) of the second compression of a double-SHA template: digest
// word 7 = H0[7] + e60, digest word 6 = H0[6] + e61. Rounds 58-61 only
// extend the e chain; the compiler drops their dead a chain.
__device__ __forceinline__ void second_e60_e61(const TmTemplate& t, uint32_t lo,
                                               uint32_t& e60, uint32_t& e61) {
  uint32_t s[8], m[16], v[8];
  first_hash(t, 0u, lo, s);
  second_block(s, m);
  init_state(s);
  rounds<62>(s, m, v, &e60);
  e61 = v[4];
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
      uint32_t e60, e61;
      second_e60_e61(t, base + off, e60, e61);
      if (e60 == kCandE60 && bswap32(kDigest6Bias + e61) <= hw1_cap) {
        atomicMin(&h[1], (unsigned long long)off);
        h[0] = 1;
      }
    }
  }
}

// ---- K2: full target compare + exact running minimum --------------------
//
// Same early exit as K3 on the 256-bit compare. Each thread also folds
// the lexicographic min of (hash words, offset) over what it swept; one
// partial per block goes to `partial` (9 words), and reduce_kernel<9>
// folds the partials. The min covers the whole range only when nothing
// was found (the case the caller reads it in).
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
  }
  block_min<9>(best);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) partial[blockIdx.x * 9 + k] = best[k];
  }
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

int tm_min_toy(const TmTemplate* t, uint32_t base_hi, uint32_t base_lo, uint32_t n,
               long long* handle, uint32_t* partial, int grid, int device,
               void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  min_toy_kernel<<<grid, kThreads, 0, s>>>(*t, base_hi, base_lo, n, partial);
  reduce_kernel<3><<<1, kThreads, 0, s>>>(partial, grid, handle, 0);
  return finish();
}

}  // extern "C"
