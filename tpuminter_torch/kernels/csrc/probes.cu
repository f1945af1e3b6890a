// The walk-layout, transpose and launch-overhead probes' kernels for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (tpuminter_torch/kernels/build.py). Fifteen pallas_call sites under
// scripts/ reduce to three functions:
//
//   tm_xor_const (P1)     <- out = in ^ c: copy_grid
//                            (scripts/pallas_launch_overhead_probe.py:74, its
//                            pallas_call at :78; 9), tiny_step (:93 / :94;
//                            10), copy_padded and copy_dense
//                            (scripts/transpose_micro_probe.py:83 / :84 and
//                            :97 / :99; 12, 13)
//   tm_transpose_u32 (P2) <- (R, C) -> (C, R), optionally xored into a carry:
//                            to_wm (scripts/walk_pallas_probe.py:84 / :86; 18),
//                            transpose_pad and transpose_dense
//                            (transpose_micro_probe.py:118 / :119, :138 / :140;
//                            14, 15), k_tr_only of wm_call
//                            (walk_variants_probe.py:62 / :74; 20), tr_dense_call
//                            (:144 / :145; 21), call (hlo_layout_check.py:36 /
//                            :37; 24)
//   tm_walk_step (P3)     <- one walk step on word planes, out[w] = body(xw[w],
//                            word w of vj), vj in one of four layouts:
//                            fused_xor_salsa (walk_isolate_probe.py:70 / :73;
//                            16), (walk_native_tile_probe.py:73 / :78; 17),
//                            (walk_wm2_probe.py:68 / :71; 22),
//                            (walk_wm_probe.py:73 / :76; 23), make_call's four
//                            bodies (kernel_body_probe.py:84 / :91; 8) and
//                            wm_call's xor_only, salsa_only, full and full_g1
//                            (walk_variants_probe.py:62 / :74; 20)
//
// What bounds them on an H100 SXM: P1 and P2 move bytes and do nothing else
// (2 MiB in and 2 MiB out at the probes' (16384, 32) u32: 1.25 us at
// 3.35 TB/s); P3 moves xw, vj and out, 2 MiB each at B = 16384 (1.88 us),
// and its full body does 864 integer operations a lane (0.42 us at 132 SMs
// x 128 lanes x 1980 MHz), so bytes bind. A chained step's 6 MiB fit the
// 50 MB L2, so a chain can read faster than the HBM bound. At these sizes a
// launch is a few microseconds, most of it the launch's fixed cost, so the
// designs keep every thread's instructions few and its loads in flight.
//
// The launch geometry (each kernel's grid) is computed on the Python side
// (kernels/probes.py: xor_const_geometry, transpose_geometry,
// walk_step_geometry, which also document how threads map to words) and
// passed in; the C functions only
// pick the instantiation. The TPU's BLOCK_B, BLOCK_RB and grids are VMEM
// tiling and mean nothing here. Blocks and vectors a thread are the
// fastest exact ones of a sweep on the card (PERF.md §6):
//   * P2: a 32 x 32-word tile (128 bytes a row), 256 threads, one
//     16-byte vector a thread on both sides: thread t loads words 4q ..
//     4q + 3 (q = t % 8) of tile row t / 8 into a shared tile swizzled by
//     16-byte chunk (chunk q of row r at q ^ ((r / 4) % 8)), then, after
//     one barrier, reads back 4 words of one column from 4 consecutive
//     rows and stores them as one vector of the output (xored with the
//     carry's vector, when there is one). Warp w, lane l stores column
//     4w + l / 8 of rows 4 (l % 8) .. + 3, so a warp's stores are 4 runs
//     of 128 bytes and its 4-byte reads hit 32 distinct banks, as the
//     loads' 16-byte writes do in each quarter-warp. The grid is an exact
//     cover of tiles, (rows / 32, cols / 32) rounded up; the edges are
//     masked by whole vectors. It takes rows and cols that are multiples
//     of 4 and 16-byte aligned pointers; any other call takes the scalar
//     arm, the textbook 32 x 33 padded tile with 32 x 8 threads, four
//     words each way a thread. A 64-row tile (512 threads) read slower
//     at every probe shape (PERF.md §6).
//   * P1: 512 threads a block, one 16-byte vector a thread, the grid
//     exactly the vectors' blocks (no grid-stride loop); the n % 4 tail
//     words are taken by the first block's first lanes. A pointer that is
//     not 16-byte aligned takes the scalar arm (a word a thread). 32-bit
//     indices: n < 2^31. Plain loads: out may be in.
//   * P3, the elementwise bodies (null, one_extract, xor_only): P1's shape
//     over items (plane w, lanes 4q .. 4q + 3), item i = w x B/4 + q, 256
//     threads a block, so xw and out are 16-byte vectors at word 4i and
//     vj's words of the four lanes are one vector in the grouped and
//     bitcast layouts (lanes innermost); one_extract reads word 0 of its
//     lanes as one vector. A grid-stride loop over the items keeps
//     `blocks` the grid.
//   * P3, the full body, one of two forms chosen by the layout, each a
//     block of 128 lanes and a grid-stride loop over 128-lane groups:
//       - lane (word, grouped and bitcast layouts): one thread a lane, 128
//         threads; X in 32 registers, so a thread runs four independent
//         quarter-rounds at a time and no shuffles;
//       - quad (row layout): four threads a lane on salsa.cuh's quad form
//         (block_mix_quad, as S1 and 19 run it), 512 threads, each thread
//         reading its 16 words of xw at their planes and a quad's two
//         16-byte quarters of the lane's row of vj, as 19 reads V.
//     On word planes the lane form is faster: a quad's dependent chain (24
//     shuffles and 32 quarter-round steps a Salsa) costs more than the
//     lane form's loads; on rows the lane form's 8 x 16-byte loads a lane
//     cost more (PERF.md §6).
//
// Operands are u32 words (int32 bit patterns on the torch side). Every tm_*
// function launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// geometry that is not instantiated.

#include <cuda_runtime.h>
#include <stdint.h>

#include "salsa.cuh"

namespace {

constexpr int kXorThreads = 512;  // P1's block
constexpr int kWalkThreads = 256;  // the elementwise P3's block
constexpr int kTile = 32;  // P2's tile: kTile x kTile words
constexpr int kTileRows = 8;  // the scalar arm's threads along a tile's rows; each does 4
constexpr int kChunks = kTile / 4;  // 16-byte chunks of a tile row; the vector arm's warps
constexpr int kQuadLanes = 128;  // lanes a block of the full body covers
constexpr int kQuadThreads = 4 * kQuadLanes;

__device__ __forceinline__ uint4 xor4(uint4 a, const uint4 b) {
  a.x ^= b.x;
  a.y ^= b.y;
  a.z ^= b.z;
  a.w ^= b.w;
  return a;
}

__device__ __forceinline__ uint4 xor4(const uint4 a, const uint32_t c) {
  return xor4(a, make_uint4(c, c, c, c));
}

// ---- P1: out = in ^ c -------------------------------------------------------

// Aligned: n / 4 vectors, thread t of block k takes vector k x 512 + t; the
// n % 4 tail words follow the vectors and go to threads 0 .. n % 4 - 1 of
// block 0. Scalar: the same mapping over words. Indices are unsigned: the
// last block's threads reach past n < 2^31 by less than a block. in and out
// may be the same words (each thread reads a word before it writes it), so
// they are not __restrict__ and the loads are plain, not read-only.
template <bool Aligned>
__global__ void __launch_bounds__(kXorThreads)
xor_const_kernel(const uint32_t* in, uint32_t* out, uint32_t n, uint32_t c) {
  const uint32_t k = blockIdx.x * kXorThreads + threadIdx.x;
  if (Aligned) {
    const uint32_t nv = n >> 2;
    if (k < nv) {
      reinterpret_cast<uint4*>(out)[k] = xor4(reinterpret_cast<const uint4*>(in)[k], c);
    }
    if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
      const uint32_t w = (nv << 2) + threadIdx.x;
      out[w] = in[w] ^ c;
    }
  } else if (k < n) {
    out[k] = in[k] ^ c;
  }
}

// ---- P2: (rows, cols) -> (cols, rows), optionally ^ xin ------------------------

// The vector arm (kernels/probes.py transpose_geometry, transpose_vector_map):
// rows and cols are multiples of 4 and every pointer is 16-byte aligned.
template <bool Xor>
__global__ void __launch_bounds__(kTile * kChunks)
transpose_vec_kernel(const uint4* __restrict__ in, const uint4* __restrict__ xin,
                     uint4* __restrict__ out, uint32_t rows, uint32_t cols) {
  __shared__ uint4 tile[kTile * kChunks];
  const uint32_t t = threadIdx.x;
  const uint32_t r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  {
    const uint32_t lr = t / kChunks, q = t % kChunks;
    const uint32_t r = r0 + lr, c = c0 + 4 * q;
    if (r < rows && c < cols) {
      tile[lr * kChunks + (q ^ ((lr >> 2) & 7))] = in[((size_t)r * cols + c) >> 2];
    }
  }
  __syncthreads();
  const uint32_t w = t >> 5, l = t & 31;
  const uint32_t lc = 4 * w + (l >> 3), rq = l & 7;
  const uint32_t c = c0 + lc, r = r0 + 4 * rq;
  if (c < cols && r < rows) {
    // word (4 rq + i, lc) lies in chunk w ^ rq of its row
    const uint32_t* s =
        reinterpret_cast<const uint32_t*>(tile) + 4 * rq * kTile + 4 * (w ^ rq) + (l >> 3);
    uint4 v = make_uint4(s[0], s[kTile], s[2 * kTile], s[3 * kTile]);
    const size_t o = ((size_t)c * rows + r) >> 2;
    if (Xor) v = xor4(v, xin[o]);
    out[o] = v;
  }
}

// The scalar arm: the textbook padded tile, for shapes and pointers the
// vector arm does not take.
template <bool Xor>
__global__ void __launch_bounds__(kTile * kTileRows)
transpose_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ xin,
                 uint32_t* __restrict__ out, int rows, int cols) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    const int r = r0 + k, c = c0 + tx;
    if (r < rows && c < cols) tile[k][tx] = in[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    const int c = c0 + k, r = r0 + tx;
    if (r < rows && c < cols) {
      const size_t o = (size_t)c * rows + r;
      uint32_t v = tile[tx][k];
      if (Xor) v ^= xin[o];
      out[o] = v;
    }
  }
}

// ---- P3: one walk step on word planes -----------------------------------------

enum Layout { kRow = 0, kWord = 1, kGrouped = 2, kBitcast = 3 };
enum Body { kNull = 0, kOneExtract = 1, kXorOnly = 2, kFull = 3 };

// Flat offset into vj of word w of lane b (ops/walk_layouts.py index_map):
//   row      (B, 32)                 b * 32 + w (read by rows, 16 bytes at
//                                    a time: walk_quad_row_kernel)
//   word     (32, B / 128, 128)      w * B + b
//   grouped  (4, B / 128, 8, 128)    vjg[w / 8, b / 128, w % 8, b % 128]
//   bitcast  (B, 32) read as (32, block) planes per block of lanes:
//            b = block * i + t reads (i * 32 + w) * block + t
// In every layout but row, lanes b .. b + 3 (b % 4 == 0) of a word are
// consecutive: the bitcast block is a multiple of 128. Offsets into vj are
// 32-bit (B < 2^25, so 32 B < 2^30); the full body addresses the planes of
// xw and out in 64 bits: with 32-bit plane offsets ptxas schedules the
// lane and quad forms differently (registers and load order), slower on
// the word planes (PERF.md §6).
template <int L>
__device__ __forceinline__ uint32_t vj_index(int w, int b, int batch, int block) {
  if (L == kWord) return (uint32_t)w * batch + b;
  if (L == kGrouped) {
    const uint32_t rows = batch / 128;
    return (((uint32_t)(w >> 3) * rows + (b >> 7)) * 8 + (w & 7)) * 128 + (b & 127);
  }
  const int i = b / block;
  return ((uint32_t)i * 32 + w) * block + (b - i * block);
}

// The elementwise bodies: item i = w * (B / 4) + q is lanes 4q .. 4q + 3
// of plane w, the 16-byte vector at word 4i of xw and out; thread t of
// block k takes items k x 256 + t, then a grid's threads further on.
template <int L, int Body>
__global__ void __launch_bounds__(kWalkThreads)
walk_step_kernel(const uint32_t* __restrict__ xw, const uint32_t* __restrict__ vj,
                 uint32_t* __restrict__ out, int batch, int block) {
  static_assert(Body != kFull && L != kRow, "the elementwise form reads lanes 4 at a time");
  const uint32_t quads = (uint32_t)batch >> 2;
  const uint32_t items = 32 * quads;
  const uint4* x4 = reinterpret_cast<const uint4*>(xw);
  const uint4* v4 = reinterpret_cast<const uint4*>(vj);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (uint32_t i = blockIdx.x * kWalkThreads + threadIdx.x; i < items;
       i += gridDim.x * kWalkThreads) {
    const uint4 x = __ldg(x4 + i);
    if (Body == kNull) {
      o4[i] = xor4(x, 1u);
    } else {
      const uint32_t w = i / quads;
      const int b = (int)(i - w * quads) * 4;
      o4[i] = xor4(x, __ldg(v4 + vj_index<L>(Body == kOneExtract ? 0 : (int)w, b, batch,
                                                    block) / 4));
    }
  }
}

// The full body in the row layout, four threads a lane: thread t of lane b
// holds row t of B0 and of B1 in salsa.cuh's row layout, r[j] = word 4t +
// ((t + j) & 3) (+ 16 for B1), read from xw's planes and from the two
// 16-byte quarters t and 4 + t of the lane's row of vj.
__global__ void __launch_bounds__(kQuadThreads)
walk_quad_row_kernel(const uint32_t* __restrict__ xw, const uint32_t* __restrict__ vj,
                     uint32_t* __restrict__ out, int batch) {
  const int t = threadIdx.x & 3, l = threadIdx.x >> 2;
  const int groups = batch / kQuadLanes;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int b = g * kQuadLanes + l;
    uint32_t r0[4], r1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * t + ((t + j) & 3);
      r0[j] = xw[(size_t)p * batch + b];
      r1[j] = xw[(size_t)(p + 16) * batch + b];
    }
    const uint4* row = reinterpret_cast<const uint4*>(vj) + (size_t)b * 8;
    uint32_t v0[4], v1[4];
    quad_words_row(__ldg(row + t), t, v0);
    quad_words_row(__ldg(row + 4 + t), t, v1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r0[j] ^= v0[j];
      r1[j] ^= v1[j];
    }
    block_mix_quad(r0, r1, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * t + ((t + j) & 3);
      out[(size_t)p * batch + b] = r0[j];
      out[(size_t)(p + 16) * batch + b] = r1[j];
    }
  }
}

// The full body in the other layouts, one thread a lane: X in 32
// registers, BlockMix unrolled with constant indices, so a thread runs four
// independent quarter-rounds at a time; xw's and vj's words read one plane
// at a time, a warp's 32 lanes of a plane contiguous.
template <int L>
__global__ void __launch_bounds__(kQuadLanes)
walk_lane_kernel(const uint32_t* __restrict__ xw, const uint32_t* __restrict__ vj,
                 uint32_t* __restrict__ out, int batch, int block) {
  static_assert(L != kRow, "the row layout takes the quad form");
  for (int b = blockIdx.x * kQuadLanes + threadIdx.x; b < batch; b += gridDim.x * kQuadLanes) {
    uint32_t x[32];
#pragma unroll
    for (int w = 0; w < 32; ++w) x[w] = xw[(size_t)w * batch + b];
#pragma unroll
    for (int w = 0; w < 32; ++w) x[w] ^= __ldg(vj + vj_index<L>(w, b, batch, block));
    block_mix(x);
#pragma unroll
    for (int w = 0; w < 32; ++w) out[(size_t)w * batch + b] = x[w];
  }
}

int finish() { return (int)cudaGetLastError(); }

int invalid() { return (int)cudaErrorInvalidValue; }

template <int L, int Body>
void launch_elementwise(const uint32_t* xw, const uint32_t* vj, uint32_t* out, int batch,
                        int block, int grid, cudaStream_t s) {
  walk_step_kernel<L, Body><<<grid, kWalkThreads, 0, s>>>(xw, vj, out, batch, block);
}

template <int L>
void launch_lane(const uint32_t* xw, const uint32_t* vj, uint32_t* out, int batch, int block,
                 int grid, cudaStream_t s) {
  walk_lane_kernel<L><<<grid, kQuadLanes, 0, s>>>(xw, vj, out, batch, block);
}

}  // namespace

extern "C" {

// n words, 1 <= n < 2^31; `grid` blocks from kernels/probes.py
// xor_const_geometry, enough for one 16-byte vector (or, when not
// `aligned`, one word) a thread.
int tm_xor_const(const void* in, void* out, long long n, uint32_t c, int grid, int aligned,
                 int device, void* stream) {
  if (n < 1 || n >= (1ll << 31) || grid < 1 ||
      (long long)grid * kXorThreads < (aligned ? n / 4 : n))
    return invalid();
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  if (aligned) {
    xor_const_kernel<true><<<grid, kXorThreads, 0, s>>>((const uint32_t*)in, (uint32_t*)out,
                                                        (uint32_t)n, c);
  } else {
    xor_const_kernel<false><<<grid, kXorThreads, 0, s>>>((const uint32_t*)in, (uint32_t*)out,
                                                         (uint32_t)n, c);
  }
  return finish();
}

// in (rows, cols) -> out (cols, rows); xin (cols, rows) or null; the vector
// arm when `vector`, else the scalar arm, on the (grid_x, grid_y) grid of
// 32 x 32 tiles from kernels/probes.py transpose_geometry.
int tm_transpose_u32(const void* in, const void* xin, void* out, int rows, int cols, int vector,
                     int grid_x, int grid_y, int device, void* stream) {
  if (rows < 1 || cols < 1 || grid_x < 1 || grid_y < 1 || (long long)grid_x * kTile < rows ||
      (long long)grid_y * kTile < cols ||
      (vector && (rows % 4 || cols % 4 ||
                  ((uintptr_t)in | (uintptr_t)xin | (uintptr_t)out) % 16)))
    return invalid();
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(grid_x, grid_y);
  if (vector) {
    const uint4* i4 = (const uint4*)in;
    uint4* o4 = (uint4*)out;
    if (xin) {
      transpose_vec_kernel<true><<<grid, kTile * kChunks, 0, s>>>(i4, (const uint4*)xin, o4,
                                                                  rows, cols);
    } else {
      transpose_vec_kernel<false><<<grid, kTile * kChunks, 0, s>>>(i4, nullptr, o4, rows, cols);
    }
    return finish();
  }
  const dim3 threads(kTile, kTileRows);
  if (xin) {
    transpose_kernel<true><<<grid, threads, 0, s>>>((const uint32_t*)in, (const uint32_t*)xin,
                                                   (uint32_t*)out, rows, cols);
  } else {
    transpose_kernel<false><<<grid, threads, 0, s>>>((const uint32_t*)in, nullptr,
                                                    (uint32_t*)out, rows, cols);
  }
  return finish();
}

// xw and out (32, batch) word planes, vj in `layout`; `block` is the bitcast
// layout's lanes a block; `grid` blocks from kernels/probes.py
// walk_step_geometry (256 threads a block for the elementwise bodies; for
// the full body 128 a block, one a lane, or in the row layout 512, four a
// lane).
int tm_walk_step(int layout, int body, const void* xw, const void* vj, void* out, int batch,
                 int block, int grid, int device, void* stream) {
  if (batch < kQuadLanes || batch % kQuadLanes || block % kQuadLanes || grid < 1)
    return invalid();
  cudaSetDevice(device);
  const uint32_t* x = (const uint32_t*)xw;
  const uint32_t* v = (const uint32_t*)vj;
  uint32_t* o = (uint32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (layout * 4 + body) {
    case kGrouped * 4 + kNull:
      launch_elementwise<kGrouped, kNull>(x, v, o, batch, block, grid, s);
      break;
    case kGrouped * 4 + kOneExtract:
      launch_elementwise<kGrouped, kOneExtract>(x, v, o, batch, block, grid, s);
      break;
    case kGrouped * 4 + kXorOnly:
      launch_elementwise<kGrouped, kXorOnly>(x, v, o, batch, block, grid, s);
      break;
    case kBitcast * 4 + kXorOnly:
      launch_elementwise<kBitcast, kXorOnly>(x, v, o, batch, block, grid, s);
      break;
    case kGrouped * 4 + kFull:
      launch_lane<kGrouped>(x, v, o, batch, block, grid, s);
      break;
    case kWord * 4 + kFull:
      launch_lane<kWord>(x, v, o, batch, block, grid, s);
      break;
    case kBitcast * 4 + kFull:
      launch_lane<kBitcast>(x, v, o, batch, block, grid, s);
      break;
    case kRow * 4 + kFull:
      walk_quad_row_kernel<<<grid, kQuadThreads, 0, s>>>(x, v, o, batch);
      break;
    default:
      return invalid();
  }
  return finish();
}

}  // extern "C"
