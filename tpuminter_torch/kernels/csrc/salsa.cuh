// Salsa20/8 and scryptBlockMix (r = 1), shared by scrypt.cu and probes.cu.
// Two forms, both fully unrolled with constant indices, so the words stay
// in registers:
//   * one thread a block: all 32 words in one thread (block_mix; the
//     layout probes' walk step);
//   * four threads a block (block_mix_quad; the fill and the walk): each of
//     the four threads of a hash holds one row of each 4 x 4 Salsa matrix,
//     and the column rounds gather their columns with warp shuffles.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) { return __funnelshift_l(x, x, n); }

#define TM_QR(t, a, b, n) t ^= rotl((a) + (b), n)

// b[O .. O+16) <- Salsa20/8(b[O .. O+16)) (RFC 7914 section 2).
template <int O>
__device__ __forceinline__ void salsa20_8(uint32_t (&b)[32]) {
  uint32_t x0 = b[O + 0], x1 = b[O + 1], x2 = b[O + 2], x3 = b[O + 3];
  uint32_t x4 = b[O + 4], x5 = b[O + 5], x6 = b[O + 6], x7 = b[O + 7];
  uint32_t x8 = b[O + 8], x9 = b[O + 9], x10 = b[O + 10], x11 = b[O + 11];
  uint32_t x12 = b[O + 12], x13 = b[O + 13], x14 = b[O + 14], x15 = b[O + 15];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // column round
    TM_QR(x4, x0, x12, 7);
    TM_QR(x8, x4, x0, 9);
    TM_QR(x12, x8, x4, 13);
    TM_QR(x0, x12, x8, 18);
    TM_QR(x9, x5, x1, 7);
    TM_QR(x13, x9, x5, 9);
    TM_QR(x1, x13, x9, 13);
    TM_QR(x5, x1, x13, 18);
    TM_QR(x14, x10, x6, 7);
    TM_QR(x2, x14, x10, 9);
    TM_QR(x6, x2, x14, 13);
    TM_QR(x10, x6, x2, 18);
    TM_QR(x3, x15, x11, 7);
    TM_QR(x7, x3, x15, 9);
    TM_QR(x11, x7, x3, 13);
    TM_QR(x15, x11, x7, 18);
    // row round
    TM_QR(x1, x0, x3, 7);
    TM_QR(x2, x1, x0, 9);
    TM_QR(x3, x2, x1, 13);
    TM_QR(x0, x3, x2, 18);
    TM_QR(x6, x5, x4, 7);
    TM_QR(x7, x6, x5, 9);
    TM_QR(x4, x7, x6, 13);
    TM_QR(x5, x4, x7, 18);
    TM_QR(x11, x10, x9, 7);
    TM_QR(x8, x11, x10, 9);
    TM_QR(x9, x8, x11, 13);
    TM_QR(x10, x9, x8, 18);
    TM_QR(x12, x15, x14, 7);
    TM_QR(x13, x12, x15, 9);
    TM_QR(x14, x13, x12, 13);
    TM_QR(x15, x14, x13, 18);
  }
  b[O + 0] += x0;
  b[O + 1] += x1;
  b[O + 2] += x2;
  b[O + 3] += x3;
  b[O + 4] += x4;
  b[O + 5] += x5;
  b[O + 6] += x6;
  b[O + 7] += x7;
  b[O + 8] += x8;
  b[O + 9] += x9;
  b[O + 10] += x10;
  b[O + 11] += x11;
  b[O + 12] += x12;
  b[O + 13] += x13;
  b[O + 14] += x14;
  b[O + 15] += x15;
}

#undef TM_QR

// X <- BlockMix(X) in place: Y0 = salsa(B1 ^ B0) over words 0-15, then
// Y1 = salsa(Y0 ^ B1) over words 16-31; the output is Y0 || Y1.
__device__ __forceinline__ void block_mix(uint32_t (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= x[16 + i];
  salsa20_8<0>(x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[16 + i] ^= x[i];
  salsa20_8<16>(x);
}

// ---- four threads a block ---------------------------------------------------
//
// The four threads of a hash are lanes 4h .. 4h + 3 of a warp; t = lane & 3.
// Row layout: thread t holds r[j] = B[4t + ((t + j) & 3)] of a 16-word block
// B, its matrix row t rotated so that r[0] is the diagonal word B[5t]; the
// row round's quarter-round is then the same four steps in every thread.
// Column layout, for the column round: c[k] = B[(5t + 4k) & 15], column t
// of the matrix read down from its diagonal word. Either layout reaches the
// other with three shuffles (the diagonal word stays), so a double round
// costs six and Salsa20/8 24, and its output is in row layout again.

// v of lane (t + d) & 3 of this thread's four
__device__ __forceinline__ uint32_t quad_from(uint32_t v, int t, int d) {
  return __shfl_sync(0xFFFFFFFFu, v, (t + d) & 3, 4);
}

// The quarter-round shared by the column and the row round.
__device__ __forceinline__ void quarter(uint32_t (&y)[4]) {
  y[1] ^= rotl(y[0] + y[3], 7);
  y[2] ^= rotl(y[1] + y[0], 9);
  y[3] ^= rotl(y[2] + y[1], 13);
  y[0] ^= rotl(y[3] + y[2], 18);
}

// b <- Salsa20/8(b), b one block in row layout across the four threads.
__device__ __forceinline__ void salsa20_8_quad(uint32_t (&b)[4], int t) {
  uint32_t x[4] = {b[0], b[1], b[2], b[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t c[4] = {x[0], quad_from(x[3], t, 1), quad_from(x[2], t, 2),
                     quad_from(x[1], t, 3)};  // row -> column
    quarter(c);
    x[0] = c[0];
    x[1] = quad_from(c[3], t, 1);  // column -> row
    x[2] = quad_from(c[2], t, 2);
    x[3] = quad_from(c[1], t, 3);
    quarter(x);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] += x[j];
}

// (B0, B1) <- BlockMix(B0 || B1), both blocks in row layout.
__device__ __forceinline__ void block_mix_quad(uint32_t (&b0)[4], uint32_t (&b1)[4], int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) b0[j] ^= b1[j];
  salsa20_8_quad(b0, t);
#pragma unroll
  for (int j = 0; j < 4; ++j) b1[j] ^= b0[j];
  salsa20_8_quad(b1, t);
}

// Thread t's row of a block in memory order, words 4t .. 4t + 3: word m is
// r[(m - t) & 3], a rotation by t in two select stages.
__device__ __forceinline__ uint4 quad_row_words(const uint32_t (&r)[4], int t) {
  const bool odd = (t & 1) != 0;
  const uint32_t a0 = odd ? r[3] : r[0], a1 = odd ? r[0] : r[1];
  const uint32_t a2 = odd ? r[1] : r[2], a3 = odd ? r[2] : r[3];
  return (t & 2) ? make_uint4(a2, a3, a0, a1) : make_uint4(a0, a1, a2, a3);
}

// The inverse of quad_row_words: words 4t .. 4t + 3 of a block in memory
// order (m.x is word 4t) into thread t's row, r[j] = word 4t + ((t + j) & 3),
// a rotation by t in two select stages.
__device__ __forceinline__ void quad_words_row(const uint4 m, int t, uint32_t (&r)[4]) {
  const bool half = (t & 2) != 0;
  const uint32_t a0 = half ? m.z : m.x, a1 = half ? m.w : m.y;
  const uint32_t a2 = half ? m.x : m.z, a3 = half ? m.y : m.w;
  const bool odd = (t & 1) != 0;
  r[0] = odd ? a1 : a0;
  r[1] = odd ? a2 : a1;
  r[2] = odd ? a3 : a2;
  r[3] = odd ? a0 : a3;
}

}  // namespace
