// Scrypt (RFC 7914, N = 2^n_log2, r = 1, p = 1) kernels for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (tpuminter_torch/kernels/build.py). Self-contained: its own SHA-256.
//
//   tm_scrypt_front <- PBKDF2-in and the ROMix fill of scrypt_header_batch
//                      (tpuminter/ops/scrypt.py:241-285 and :190-194; a jnp
//                      program there, no pallas_call)
//   tm_romix_walk   <- fused_step (scripts/walk_pallas_probe.py:106, its
//                      pallas_call at :107): X <- BlockMix(X ^ V[j]), the
//                      walk of tpuminter/ops/scrypt.py:196-202
//   tm_scrypt_back  <- PBKDF2-out (tpuminter/ops/scrypt.py:289-294) and the
//                      batch fold of tpuminter/jax_worker.py _scrypt_step
//                      (jnp, no pallas_call)
//   tm_row_gather   <- build_gather_kernel (scripts/romix_pallas_probe.py:35,
//                      its pallas_call at :78): ROMix's data-dependent row
//                      read alone, as a probe (the miner never launches it)
//
// What bounds them, per hash at N = 1024 on an H100 SXM: the fill writes
// and the walk reads 128 KiB of V, 256 KiB in all, 0.078 us at 3.35 TB/s
// (12.8 MH/s); Salsa20/8 is 128 x (add, funnel shift, xor) + 16 adds =
// 400 integer operations, BlockMix 832, so the fill is 1024 x 832 and
// the walk 1024 x 864 operations, 1.74 M in all, 0.052 us at 132 SMs x
// 128 lanes x 1980 MHz (19 MH/s; 9.6 MH/s on the INT32 pipe alone).
// Device memory binds, and the integer pipe is close behind. The 17
// SHA-256 compressions of the two PBKDF2 ends (20 with the key's second
// block and the HMAC states that tm_scrypt_back recomputes) are ~3% of
// the operations.
//
// The design:
//   * S2 runs one thread per hash in one launch: its seven compressions
//     in a loop over one compression body, the key's first block from
//     the host (TmScryptKey), X staged through shared memory in
//     consecutive 16-byte loads, and the batch fold done by the last
//     block to finish;
//   * the fill (S1) and the walk (19) run four threads per hash
//     (salsa.cuh's quad form): 8 words of X a thread, the Salsa columns
//     gathered by warp shuffles, at most 64 registers, so 2^15 hashes
//     (2^17 threads) fill 31 warps an SM. One thread a hash moved a row
//     as 8 x 16-byte accesses whose warp instruction touched 32 rows 128
//     bytes apart, half a sector each, and ran 8 warps an SM at 2^15. A
//     quad's thread moves its two 16-byte quarters of the row (X words
//     4t .. 4t + 3 and 16 + 4t ..), so a quad moves its row's 128
//     contiguous bytes as four whole 32-byte sectors;
//   * V is the reference's layout, (N, S, 32) u32 for a lane stride S:
//     row j of lane b is 128 contiguous bytes at (j * S + b) * 128, so at
//     a fill step a warp's rows are one contiguous span. The walk's next
//     row depends on the BlockMix just computed (ROMix's sequential
//     memory hardness), so only the other warps in flight hide a row's
//     latency: the walk's levers on this card are warps in flight, whole
//     sectors and issue slots. Tensor cores, TMA and wgmma do not apply:
//     the work is integer Salsa and a data-dependent 128-byte gather. At
//     four threads a hash the walk issues about 1,200 warp-lane
//     instructions a hash a step (S1's loop), which at ~0.7 warp
//     instructions a clock a scheduler is ~1.7 ms of issue for 2^15
//     hashes x 1024 steps, beside the 1.29 ms bytes bound: issue and
//     memory are close, and either may bind;
//   * sizes are run-time arguments (n_log2, the ragged count, the stride,
//     the header words as a by-value struct, the target), so one build
//     serves every job and every N;
//   * the batch fold reduces per thread, per block in shared memory (the
//     first winning lane by a shared atomicMin), then in the last block
//     over the per-block partials: no scheduling order changes a result.
//
// X travels between the kernels as int64 lanes (the port's convention for
// u32 words on the torch side), (count, 32); V is the caller's scratch.
// Every tm_* function launches on the given stream, does not synchronise,
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "salsa.cuh"  // Salsa20/8 and BlockMix, shared with probes.cu

// The 76-byte header prefix as 19 big-endian words (ops/scrypt.py
// header_to_words); the nonce completes the 80 bytes.
struct TmScryptHeader {
  uint32_t w[19];
};

struct TmTarget {
  uint32_t w[8];  // msb-first hash-value words
};

// SHA-256's state after the header's first 64 bytes (ops/scrypt.py
// key_state): the first block of the key SHA256(header80), the same for
// every nonce of a job.
struct TmScryptKey {
  uint32_t w[8];
};

namespace {

constexpr int kThreads = 128;

// resident blocks a SM the fill and the walk are built for: 8 x 128
// threads at <= 64 registers, so the path's 2^15 hashes (2^17 threads)
// are one wave
constexpr int kQuadBlocksPerSm = 8;
// resident blocks a SM S2 is built for: 4 x 128 threads at <= 128
// registers, so the path's 2^16 hashes (512 blocks) are one wave
constexpr int kBackBlocksPerSm = 4;
// words of an S2 block's partial: its minimum's hash words and lane, and
// its first winning lane
constexpr int kBackPartial = 10;
constexpr uint32_t kNotFound = 0x7FFFFFFFu;  // first lane when nothing hit
constexpr uint32_t kGatherStep = 977u;       // romix_pallas_probe's pass stride

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

__constant__ uint32_t kH0[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                               0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// ---- SHA-256 and PBKDF2-HMAC-SHA256 (c = 1) --------------------------------

// One compression: s <- s + rounds(s, m), m the 16 big-endian block words.
__device__ __forceinline__ void compress(uint32_t (&s)[8], const uint32_t (&m)[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      w[i & 15] += (rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3)) + w[(i - 7) & 15] +
                   (rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10));
    }
    const uint32_t t1 =
        h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + (g ^ (e & (f ^ g))) + kK[i] + w[i & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// The inner and outer HMAC states keyed by SHA256(header80), nw the
// nonce's little-endian bytes read as a big-endian word.
__device__ __forceinline__ void hmac_states(const TmScryptHeader& hd, uint32_t nw,
                                            uint32_t (&is)[8], uint32_t (&os)[8]) {
  uint32_t key[8], m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = kH0[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = hd.w[i];
  compress(key, m);
  m[0] = hd.w[16];
  m[1] = hd.w[17];
  m[2] = hd.w[18];
  m[3] = nw;
  m[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) m[i] = 0u;
  m[15] = 640u;  // an 80-byte message
  compress(key, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = key[i] ^ 0x36363636u;
    m[8 + i] = 0x36363636u;
    is[i] = kH0[i];
  }
  compress(is, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = key[i] ^ 0x5C5C5C5Cu;
    m[8 + i] = 0x5C5C5C5Cu;
    os[i] = kH0[i];
  }
  compress(os, m);
}

// Outer hash of an HMAC: the opad state over the 32-byte inner digest.
__device__ __forceinline__ void hmac_finish(const uint32_t (&os)[8], const uint32_t (&inner)[8],
                                            uint32_t (&out)[8]) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = inner[i];
    out[i] = os[i];
  }
  m[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) m[i] = 0u;
  m[15] = 768u;  // opad (64 bytes) + digest (32 bytes)
  compress(out, m);
}

// ---- S1: PBKDF2-in and the ROMix fill, four threads a hash ---------------------
//
// The four threads of a hash (lanes 4h .. 4h + 3, t = lane & 3) each compute
// one of PBKDF2-in's four HMAC blocks, X words 8t .. 8t + 7, then hold X in
// row layout (salsa.cuh): B0's matrix row t and B1's, eight words. A fill
// step stores B0's row as X words 4t .. 4t + 3 and B1's as 16 + 4t .. 16 +
// 4t + 3, one 16-byte store each: the warp's first store covers bytes 0-63
// of its eight hashes' rows and its second bytes 64-127, whole 32-byte
// sectors, and together the eight rows' 1 KiB span. Lanes past the count
// compute a copy of the last hash (every lane takes part in the shuffles)
// and store nothing.
__global__ void __launch_bounds__(kThreads, kQuadBlocksPerSm)
scrypt_front_kernel(const TmScryptHeader hd, const long long* __restrict__ nonces,
                    long long* __restrict__ xout, uint4* __restrict__ v, int count,
                    int stride, int n_log2) {
  __shared__ uint32_t xs[kThreads / 4][33];  // X of each hash, padded a word
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = gid < 4LL * count;
  const int hash = live ? (int)(gid >> 2) : count - 1;
  const int t = threadIdx.x & 3;
  const int q = threadIdx.x >> 2;
  const uint32_t nw = bswap32((uint32_t)nonces[hash]);
  uint32_t is[8], os[8], s[8], m[16];
  hmac_states(hd, nw, is, os);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = is[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = hd.w[i];
  compress(s, m);  // the salt's first block, the same for all four HMAC blocks
  m[0] = hd.w[16];
  m[1] = hd.w[17];
  m[2] = hd.w[18];
  m[3] = nw;
  m[4] = (uint32_t)(t + 1);  // INT_BE(i): this thread's block
  m[5] = 0x80000000u;
#pragma unroll
  for (int i = 6; i < 15; ++i) m[i] = 0u;
  m[15] = 1184u;  // ipad (64) + header (80) + 4 bytes
  compress(s, m);
  uint32_t d[8];
  hmac_finish(os, s, d);
#pragma unroll
  for (int i = 0; i < 8; ++i) xs[q][8 * t + i] = bswap32(d[i]);
  __syncwarp();
  uint32_t b0[4], b1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b0[j] = xs[q][4 * t + ((t + j) & 3)];
    b1[j] = xs[q][16 + 4 * t + ((t + j) & 3)];
  }
  // fill: V[i, hash] = X, X <- BlockMix(X), for i < N
  uint4* row = v + (size_t)hash * 8 + t;
  const size_t step = (size_t)stride * 8;
  const int n = 1 << n_log2;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (live) {
      row[0] = quad_row_words(b0, t);
      row[4] = quad_row_words(b1, t);
    }
    row += step;
    block_mix_quad(b0, b1, t);
  }
  if (live) {
    long long* out = xout + (size_t)hash * 32 + 4 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[(t + j) & 3] = (long long)b0[j];
      out[16 + ((t + j) & 3)] = (long long)b1[j];
    }
  }
}

// ---- 19: the walk, four threads a hash ------------------------------------
//
// Thread t of a hash's quad holds X in S1's row layout: b0 is B0's matrix
// row t, b1 B1's. Integerify reads X word 16, which is b1[0] of the quad's
// thread 0, broadcast by one shuffle. A step's row V[j, hash] is loaded as
// this thread's two 16-byte quarters, words 4t .. 4t + 3 and 16 + 4t .., so
// the quad reads the row's 128 bytes as four whole sectors, then rotated
// into row layout (quad_words_row). A row is read once, so it is loaded
// through the non-coherent path without allocating in L1. Lanes past the
// count compute a copy of the last hash (every lane takes part in the
// shuffles) and store nothing.

// A 16-byte load through the non-coherent path that does not allocate in L1.
__device__ __forceinline__ uint4 load_row_quarter(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__global__ void __launch_bounds__(kThreads, kQuadBlocksPerSm)
romix_walk_kernel(const long long* __restrict__ xin, long long* __restrict__ xout,
                  const uint4* __restrict__ v, int count, int stride, int n_log2,
                  int steps) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = gid < 4LL * count;
  const int hash = live ? (int)(gid >> 2) : count - 1;
  const int t = threadIdx.x & 3;
  const long long* in = xin + (size_t)hash * 32 + 4 * t;
  uint32_t b0[4], b1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b0[j] = (uint32_t)in[(t + j) & 3];
    b1[j] = (uint32_t)in[16 + ((t + j) & 3)];
  }
  const uint4* base = v + (size_t)hash * 8 + t;
  const size_t step = (size_t)stride * 8;
  const uint32_t mask = (1u << n_log2) - 1u;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const uint32_t j = __shfl_sync(0xFFFFFFFFu, b1[0], 0, 4) & mask;  // Integerify
    const uint4* row = base + (size_t)j * step;
    uint32_t r0[4], r1[4];
    quad_words_row(load_row_quarter(row), t, r0);
    quad_words_row(load_row_quarter(row + 4), t, r1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      b0[k] ^= r0[k];
      b1[k] ^= r1[k];
    }
    block_mix_quad(b0, b1, t);
  }
  if (live) {
    long long* out = xout + (size_t)hash * 32 + 4 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[(t + j) & 3] = (long long)b0[j];
      out[16 + ((t + j) & 3)] = (long long)b1[j];
    }
  }
}

// ---- S2: PBKDF2-out and the batch fold, one launch ----------------------------
//
// One thread a hash, 128 hashes a block. The block first stages its
// hashes' X (one contiguous span of 256 bytes a hash) into shared memory
// with consecutive 16-byte loads, as u32 words in rows padded a word, so
// each thread then reads its own row without bank conflicts. A hash's
// PBKDF2-HMAC-SHA256(P = header80, S = X, c = 1, 32 bytes) is seven
// compressions: the key's second block (its first, the header's first 64
// bytes, is the same for every nonce: the host's TmScryptKey), the opad
// and ipad states, X's two blocks, the constant pad block (1, 0x80000000,
// zeros, 1568: its 64 schedule words fold into the round constants at
// compile time) and the outer hash. The six blocks with varying words run
// one compression body in a loop, the message and state chosen per step,
// so the kernel's code is about two compressions long (3,700 SASS
// instructions, against 10,800 for the eight unrolled ones it replaces);
// unrolled, the same loop ran 7% slower on an H100. Its adds stay plain
// (IADD3 on the ALU pipe): at 2^16 hashes a scheduler holds about four
// warps, and the FMA-pipe adds of sha256.cu read 9% slower here. The
// digests leave through the same shared rows as consecutive 16-byte
// stores. Each block writes one partial (its
// lexicographic minimum of (hash words, lane) and its first winning lane,
// by a shared atomicMin); the last block to finish (an atomic ticket
// after a fence) folds every partial into the handle, reads the first
// winner's digest, and resets the ticket for the next launch. So one
// launch computes the function, and no scheduling order changes a result.
// The ticket is one device word: the launches of one device run one at a
// time (the port launches on its current stream).

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

// Block-wide lexicographic min of (hash words, lane) over all threads,
// left in thread 0's v; the lane is the last key, so ties go to the
// lowest lane.
__device__ __forceinline__ void block_min(uint32_t (&v)[9]) {
  __shared__ uint32_t sh[9][kThreads];
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 9; ++k) sh[k][tid] = v[k];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      uint32_t other[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) other[k] = sh[k][tid + stride];
      if (lex_less<9>(other, v)) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          v[k] = other[k];
          sh[k][tid] = other[k];
        }
      }
    }
    __syncthreads();
  }
}

// The pad block's schedule word i, at compile time.
__host__ __device__ constexpr uint32_t rotr_c(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}
__host__ __device__ constexpr uint32_t pad_w(int i) {
  uint32_t w[64] = {};
  w[0] = 1u;
  w[1] = 0x80000000u;
  w[15] = 1568u;  // ipad (64) + X (128) + 4 bytes
  for (int j = 16; j <= i; ++j) {
    const uint32_t x15 = w[j - 15], x2 = w[j - 2];
    w[j] = (rotr_c(x2, 17) ^ rotr_c(x2, 19) ^ (x2 >> 10)) + w[j - 7] +
           (rotr_c(x15, 7) ^ rotr_c(x15, 18) ^ (x15 >> 3)) + w[j - 16];
  }
  return w[i];
}

// A round of the pad block: its schedule word W is a compile-time
// constant, which joins the round constant.
template <uint32_t W>
__device__ __forceinline__ void pad_round(uint32_t (&x)[8], uint32_t k) {
  const uint32_t t1 = x[7] + (rotr(x[4], 6) ^ rotr(x[4], 11) ^ rotr(x[4], 25)) +
                      (x[6] ^ (x[4] & (x[5] ^ x[6]))) + (k + W);
  const uint32_t t2 = (rotr(x[0], 2) ^ rotr(x[0], 13) ^ rotr(x[0], 22)) +
                      ((x[0] & x[1]) | (x[2] & (x[0] | x[1])));
  x[7] = x[6];
  x[6] = x[5];
  x[5] = x[4];
  x[4] = x[3] + t1;
  x[3] = x[2];
  x[2] = x[1];
  x[1] = x[0];
  x[0] = t1 + t2;
}

template <int... I>
__device__ __forceinline__ void pad_rounds(uint32_t (&x)[8], std::integer_sequence<int, I...>) {
  (pad_round<pad_w(I)>(x, kK[I]), ...);
}

// s <- s + rounds(s, the pad block).
__device__ __forceinline__ void compress_pad(uint32_t (&s)[8]) {
  uint32_t x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = s[i];
  pad_rounds(x, std::make_integer_sequence<int, 64>());
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += x[i];
}

// PBKDF2-HMAC-SHA256(P = header80, S = X, c = 1, 32 bytes) of one hash:
// nw is its nonce's little-endian bytes read as a big-endian word, xw its
// 32 X words (little-endian, in shared memory), dg the digest's
// big-endian words. Steps 0-5 run one compression body: 0 the key's
// second block, 1 the opad state, 2 the ipad state, 3 and 4 X's blocks,
// 5 the outer hash, after the pad block ends the inner hash. The loop is
// kept rolled (#pragma unroll 1): unrolled, the same code ran slower on
// an H100.
__device__ __forceinline__ void pbkdf2_out(const TmScryptHeader& hd, const TmScryptKey& key,
                                           uint32_t nw, const uint32_t* xw,
                                           uint32_t (&dg)[8]) {
  uint32_t kst[8], os[8], st[8];
#pragma unroll 1
  for (int b = 0; b < 6; ++b) {
    uint32_t s[8], m[16];
    if (b == 5) compress_pad(st);
    switch (b) {
      case 0:  // the key, SHA256(header80): its second block
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = key.w[i];
        m[0] = hd.w[16];
        m[1] = hd.w[17];
        m[2] = hd.w[18];
        m[3] = nw;
        m[4] = 0x80000000u;
#pragma unroll
        for (int i = 5; i < 15; ++i) m[i] = 0u;
        m[15] = 640u;  // an 80-byte message
        break;
      case 1:  // the outer (opad) and inner (ipad) HMAC states
      case 2: {
        const uint32_t pad = b == 1 ? 0x5C5C5C5Cu : 0x36363636u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = kH0[i];
          m[i] = kst[i] ^ pad;
          m[8 + i] = pad;
        }
        break;
      }
      case 3:  // X's two blocks, big-endian
      case 4:
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = st[i];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = bswap32(xw[((b - 3) & 1) * 16 + i]);
        break;
      default:  // the outer hash: the opad state over the inner digest
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = os[i];
          m[i] = st[i];
        }
        m[8] = 0x80000000u;
#pragma unroll
        for (int i = 9; i < 15; ++i) m[i] = 0u;
        m[15] = 768u;  // opad (64 bytes) + digest (32 bytes)
        break;
    }
    compress(s, m);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (b == 0) {
        kst[i] = s[i];
      } else if (b == 1) {
        os[i] = s[i];
      } else if (b < 5) {
        st[i] = s[i];
      } else {
        dg[i] = s[i];
      }
    }
  }
}

// blocks of S2's running launch that have written their partial; the
// last one resets it
__device__ unsigned int g_back_ticket = 0;

__global__ void __launch_bounds__(kThreads, kBackBlocksPerSm)
scrypt_back_kernel(const TmScryptHeader hd, const TmScryptKey key, const TmTarget tg,
                   const long long* __restrict__ nonces, const long long* __restrict__ x,
                   long long* __restrict__ digest, long long* __restrict__ h,
                   uint32_t* __restrict__ partial, int count) {
  __shared__ uint32_t xs[kThreads][33];  // the block's X, then its digests
  __shared__ uint32_t first_win, fold_win;
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int live = min(kThreads, count - first);  // the block's hashes
  if (tid == 0) {
    first_win = kNotFound;
    fold_win = kNotFound;
  }
  // X in: the block's rows are one span of live x 16 vectors of 16 bytes,
  // loaded by consecutive threads
  const longlong2* src = reinterpret_cast<const longlong2*>(x + (size_t)first * 32);
  for (int k = tid; k < live * 16; k += kThreads) {
    const longlong2 v = src[k];
    xs[k >> 4][(k & 15) * 2] = (uint32_t)v.x;
    xs[k >> 4][(k & 15) * 2 + 1] = (uint32_t)v.y;
  }
  __syncthreads();
  uint32_t best[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) best[k] = 0xFFFFFFFFu;
  if (tid < live) {
    const int lane = first + tid;
    uint32_t dg[8];
    pbkdf2_out(hd, key, bswap32((uint32_t)nonces[lane]), xs[tid], dg);
    // the hash value's words, msb first: word j = bswap(digest word 7 - j)
#pragma unroll
    for (int j = 0; j < 8; ++j) best[j] = bswap32(dg[7 - j]);
    best[8] = (uint32_t)lane;
    bool lt = false, eq = true;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lt = lt || (eq && best[j] < tg.w[j]);
      eq = eq && best[j] == tg.w[j];
    }
    if (lt || eq) atomicMin(&first_win, (uint32_t)lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[tid][i] = dg[i];  // its own row, which only it read
  }
  __syncthreads();
  // digests out: the block's rows are one span of live x 4 vectors
  longlong2* dst = reinterpret_cast<longlong2*>(digest + (size_t)first * 8);
  for (int k = tid; k < live * 4; k += kThreads) {
    dst[k] = make_longlong2((long long)xs[k >> 2][(k & 3) * 2],
                            (long long)xs[k >> 2][(k & 3) * 2 + 1]);
  }
  block_min(best);
  if (tid == 0) {
    uint32_t* p = partial + (size_t)blockIdx.x * kBackPartial;
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = best[k];
    p[9] = first_win;
  }
  // every thread's digests and thread 0's partial visible to the device
  // before the block takes its ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&g_back_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: fold every partial into h (found, first lane, min
  // words, min lane, the first winner's hash words or zeros)
#pragma unroll
  for (int k = 0; k < 9; ++k) best[k] = 0xFFFFFFFFu;
  uint32_t win = kNotFound;
  for (int i = tid; i < (int)gridDim.x; i += kThreads) {
    const uint32_t* p = partial + (size_t)i * kBackPartial;
    uint32_t cand[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) cand[k] = __ldcg(p + k);
    if (lex_less<9>(cand, best)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) best[k] = cand[k];
    }
    win = min(win, __ldcg(p + 9));
  }
  atomicMin(&fold_win, win);
  block_min(best);  // its barriers also order fold_win's atomics
  if (tid == 0) {
    const uint32_t w = fold_win;
    const bool found = w != kNotFound;
    h[0] = found;
    h[1] = w;
#pragma unroll
    for (int k = 0; k < 9; ++k) h[2 + k] = best[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[11 + j] = found ? (long long)bswap32((uint32_t)__ldcg(digest + (size_t)w * 8 + 7 - j))
                        : 0;
    }
    g_back_ticket = 0u;
  }
}

// ---- 11: the row-gather probe -------------------------------------------------
//
// Each lane's output is the xor of every word of rows (idx + r * 977) mod
// rows for r < reps. No pass depends on another, so the work spreads
// freely; what bounds it is HBM, one random 128-byte row a lane a pass,
// and the latency of a read no other read waits on:
//   * eight threads a row: thread q reads the row's 16-byte piece q, so a
//     warp's load reads four whole rows, each one line;
//   * a thread issues kGatherUnroll passes' loads before it folds any of
//     them;
//   * where one pass's rows leave the card short of threads, the passes
//     split into `slices` runs of `per` passes, each its own row slot:
//     slot s runs lane s % count over the passes of slice s / count, and
//     the slices' partial xors meet by atomicXor on the output, zeroed
//     first (xor is associative and commutative, so the order does not
//     matter). More slices also run more passes at once, and lanes'
//     passes meet on the same rows (~37% of the probe's reads repeat a
//     row), which L2 then serves;
//   * the row index steps by 977 mod rows with one conditional subtract,
//     not a 64-bit modulo a pass;
//   * the row's eight partials fold by __shfl_xor_sync, and its piece-0
//     thread writes.
// The host computes the launch (kernels/scrypt.py gather_geometry).

constexpr int kGatherThreads = 256;
constexpr int kGatherPieces = 8;  // threads a row, 16 bytes each
constexpr int kGatherUnroll = 8;  // passes a thread has in flight

__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const uint4* __restrict__ v, const long long* __restrict__ idx,
                  long long* __restrict__ out, int count, unsigned long long rows, int reps,
                  int slices, int per) {
  const unsigned long long t = (unsigned long long)blockIdx.x * kGatherThreads + threadIdx.x;
  const int piece = (int)(t % kGatherPieces);
  const unsigned long long slot = t / kGatherPieces;
  const int lane = (int)(slot % (unsigned)count);
  const unsigned long long slice = slot / (unsigned)count;
  const bool live = slice < (unsigned long long)slices;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    const int r0 = (int)slice * per;
    const int r1 = min(reps, r0 + per);
    const unsigned long long step = kGatherStep % rows;
    unsigned long long row =
        ((unsigned long long)idx[lane] + (unsigned long long)r0 * kGatherStep) % rows;
    const uint4* base = v + piece;
    int r = r0;
    for (; r + kGatherUnroll <= r1; r += kGatherUnroll) {
      uint4 q[kGatherUnroll];
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        q[u] = __ldg(base + row * kGatherPieces);
        row += step;
        row -= row >= rows ? rows : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        acc.x ^= q[u].x;
        acc.y ^= q[u].y;
        acc.z ^= q[u].z;
        acc.w ^= q[u].w;
      }
    }
    for (; r < r1; ++r) {
      const uint4 q = __ldg(base + row * kGatherPieces);
      acc.x ^= q.x;
      acc.y ^= q.y;
      acc.z ^= q.z;
      acc.w ^= q.w;
      row += step;
      row -= row >= rows ? rows : 0ull;
    }
  }
  // every thread of the warp reaches the shuffles, live or not
  uint32_t x = acc.x ^ acc.y ^ acc.z ^ acc.w;
#pragma unroll
  for (int o = kGatherPieces / 2; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
  if (live && piece == 0) {
    atomicXor(reinterpret_cast<unsigned long long*>(out) + lane, (unsigned long long)x);
  }
}

int blocks_for(int count) { return (count + kThreads - 1) / kThreads; }

int finish() { return (int)cudaGetLastError(); }

}  // namespace

static_assert(sizeof(TmScryptHeader) == 19 * 4, "TmScryptHeader layout is mirrored in build.py");
static_assert(sizeof(TmTarget) == 8 * 4, "TmTarget layout is mirrored in build.py");
static_assert(sizeof(TmScryptKey) == 8 * 4, "TmScryptKey layout is mirrored in build.py");

extern "C" {

int tm_scrypt_front(const TmScryptHeader* hd, const long long* nonces, long long* x,
                    void* v, int count, int stride, int n_log2, int device, void* stream) {
  cudaSetDevice(device);
  const unsigned blocks = (unsigned)((4LL * count + kThreads - 1) / kThreads);
  scrypt_front_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *hd, nonces, x, (uint4*)v, count, stride, n_log2);
  return finish();
}

int tm_romix_walk(const long long* xin, long long* xout, const void* v, int count,
                  int stride, int n_log2, int steps, int device, void* stream) {
  cudaSetDevice(device);
  const unsigned blocks = (unsigned)((4LL * count + kThreads - 1) / kThreads);
  romix_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xin, xout, (const uint4*)v, count, stride, n_log2, steps);
  return finish();
}

// x and digest 16-byte aligned; partial holds kBackPartial words a block.
int tm_scrypt_back(const TmScryptHeader* hd, const TmScryptKey* key, const TmTarget* tg,
                   const long long* nonces, const long long* x, long long* digest,
                   long long* handle, uint32_t* partial, int count, int device, void* stream) {
  cudaSetDevice(device);
  scrypt_back_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(
      *hd, *key, *tg, nonces, x, digest, handle, partial, count);
  return finish();
}

// The launch is kernels/scrypt.py gather_geometry's: `grid` blocks of
// kGatherThreads and `slices` runs of `per` passes (slices * per >= reps).
// The output is zeroed first, on the same stream.
int tm_row_gather(const void* v, long long rows, const long long* idx, long long* out,
                  int count, int reps, int slices, int per, long long grid, int device,
                  void* stream) {
  if (rows < 1 || count < 1 || reps < 0 || slices < 1 || per < 0 ||
      (long long)slices * per < reps || grid < 1 || grid > 0x7FFFFFFFLL ||
      grid * kGatherThreads < (long long)slices * count * kGatherPieces) {
    return (int)cudaErrorInvalidValue;
  }
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, sizeof(long long) * (size_t)count, s);
  row_gather_kernel<<<(unsigned)grid, kGatherThreads, 0, s>>>(
      (const uint4*)v, idx, out, count, (unsigned long long)rows, reps, slices, per);
  return finish();
}

// Resident blocks per SM, and registers a thread, of the fill (which =
// 0), the walk (1) or S2 (2) at kThreads threads a block: with the SM
// count, the hashes in flight a wave (a block of the fill or the walk
// holds kThreads / 4 hashes, of S2 kThreads).
int tm_scrypt_occupancy(int which, int device, int* blocks_per_sm, int* regs) {
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  const void* fns[] = {(const void*)scrypt_front_kernel, (const void*)romix_walk_kernel,
                       (const void*)scrypt_back_kernel};
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, fns[which]);
  *regs = attr.numRegs;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fns[which], kThreads, 0);
  return finish();
}

}  // extern "C"
