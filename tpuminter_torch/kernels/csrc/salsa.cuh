// Salsa20/8 and scryptBlockMix (r = 1) on 32 words in registers, shared by
// scrypt.cu (the fill and the walk) and probes.cu (the layout probes' walk
// step). Fully unrolled with constant indices, so the words stay in
// registers.
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

}  // namespace
