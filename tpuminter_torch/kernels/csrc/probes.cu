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
// 50 MB L2, so a chain can read faster than the HBM bound.
//
// Design, the simple one that is right first; the TPU's BLOCK_B, BLOCK_RB
// and grids are VMEM tiling and mean nothing here:
//   * P1: 16-byte vector loads and stores with a scalar tail (or scalar
//     throughout when a pointer is not 16-byte aligned), a grid-stride loop
//     over one vector a thread, at most kXorBlocksPerSm blocks an SM;
//   * P2: a 32 x 32 tile through shared memory padded to 33 columns against
//     bank conflicts, 32 x 8 threads a block, four rows a thread: a warp
//     reads 128 contiguous bytes of a row and writes 128 of a column;
//   * P3: one thread per lane, a grid-stride loop; word w of lane b is read
//     from plane w, so a warp reads 128 contiguous bytes a word; vj through
//     the layout's index map (the row layout as 8 x 16-byte loads of the
//     lane's 128-byte row); X stays in 32 registers and BlockMix is
//     unrolled with constant indices (salsa.cuh, shared with scrypt.cu).
//     Only the (layout, body) pairs the probes use are instantiated.
//
// Operands are u32 words (int32 bit patterns on the torch side). Every tm_*
// function launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "salsa.cuh"

namespace {

constexpr int kXorThreads = 256;
constexpr int kXorBlocksPerSm = 8;
constexpr int kTile = 32;
constexpr int kTileRows = 8;  // threads along a tile's rows; each does 4
constexpr int kWalkThreads = 128;

// ---- P1: out = in ^ c -------------------------------------------------------

__global__ void __launch_bounds__(kXorThreads)
xor_const_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long n,
                 uint32_t c, bool vec) {
  const long long stride = (long long)gridDim.x * kXorThreads;
  const long long first = (long long)blockIdx.x * kXorThreads + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long k = first; k < nv; k += stride) {
    uint4 q = in4[k];
    q.x ^= c;
    q.y ^= c;
    q.z ^= c;
    q.w ^= c;
    out4[k] = q;
  }
  for (long long k = nv * 4 + first; k < n; k += stride) out[k] = in[k] ^ c;
}

// ---- P2: (rows, cols) -> (cols, rows), optionally ^ xin ------------------------

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
//   row      (B, 32)                 b * 32 + w
//   word     (32, B / 128, 128)      w * B + b
//   grouped  (4, B / 128, 8, 128)    vjg[w / 8, b / 128, w % 8, b % 128]
//   bitcast  (B, 32) read as (32, block) planes per block of lanes:
//            b = block * i + t reads (i * 32 + w) * block + t
template <int L>
__device__ __forceinline__ size_t vj_index(int w, int b, int batch, int block) {
  if (L == kRow) return (size_t)b * 32 + w;
  if (L == kWord) return (size_t)w * batch + b;
  if (L == kGrouped) {
    const int rows = batch / 128;
    return (((size_t)(w >> 3) * rows + (b >> 7)) * 8 + (w & 7)) * 128 + (b & 127);
  }
  const int i = b / block;
  return ((size_t)i * 32 + w) * block + (b - i * block);
}

template <int L, int Body>
__global__ void __launch_bounds__(kWalkThreads)
walk_step_kernel(const uint32_t* __restrict__ xw, const uint32_t* __restrict__ vj,
                 uint32_t* __restrict__ out, int batch, int block) {
  for (int b = blockIdx.x * kWalkThreads + threadIdx.x; b < batch;
       b += gridDim.x * kWalkThreads) {
    uint32_t x[32];
#pragma unroll
    for (int w = 0; w < 32; ++w) x[w] = xw[(size_t)w * batch + b];
    if (Body == kNull) {
#pragma unroll
      for (int w = 0; w < 32; ++w) x[w] ^= 1u;
    } else if (Body == kOneExtract) {
      const uint32_t p = __ldg(vj + vj_index<L>(0, b, batch, block));
#pragma unroll
      for (int w = 0; w < 32; ++w) x[w] ^= p;
    } else {
      if (L == kRow) {
        const uint4* row = reinterpret_cast<const uint4*>(vj) + (size_t)b * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint4 q = __ldg(row + k);
          x[4 * k] ^= q.x;
          x[4 * k + 1] ^= q.y;
          x[4 * k + 2] ^= q.z;
          x[4 * k + 3] ^= q.w;
        }
      } else {
#pragma unroll
        for (int w = 0; w < 32; ++w) x[w] ^= __ldg(vj + vj_index<L>(w, b, batch, block));
      }
      if (Body == kFull) block_mix(x);
    }
#pragma unroll
    for (int w = 0; w < 32; ++w) out[(size_t)w * batch + b] = x[w];
  }
}

template <int L, int Body>
void launch_walk(const uint32_t* xw, const uint32_t* vj, uint32_t* out, int batch, int block,
                 int blocks, cudaStream_t s) {
  walk_step_kernel<L, Body><<<blocks, kWalkThreads, 0, s>>>(xw, vj, out, batch, block);
}

int finish() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// n words; enough blocks for one 16-byte vector a thread, capped at
// kXorBlocksPerSm a multiprocessor.
int tm_xor_const(const void* in, void* out, long long n, uint32_t c, int device, void* stream) {
  cudaSetDevice(device);
  const bool vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long items = vec ? (n + 3) / 4 : n;
  const long long want = (items + kXorThreads - 1) / kXorThreads;
  const long long cap = (long long)sms * kXorBlocksPerSm;
  const int blocks = (int)(want < 1 ? 1 : want > cap ? cap : want);
  xor_const_kernel<<<blocks, kXorThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n, c, vec);
  return finish();
}

// in (rows, cols) -> out (cols, rows); xin (cols, rows) or null.
int tm_transpose_u32(const void* in, const void* xin, void* out, int rows, int cols, int device,
                     void* stream) {
  cudaSetDevice(device);
  const dim3 grid((rows + kTile - 1) / kTile, (cols + kTile - 1) / kTile);
  const dim3 threads(kTile, kTileRows);
  const cudaStream_t s = (cudaStream_t)stream;
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
// layout's lanes a block; blocks <= 0 launches one thread a lane. Returns
// cudaErrorInvalidValue for a (layout, body) pair that is not instantiated.
int tm_walk_step(int layout, int body, const void* xw, const void* vj, void* out, int batch,
                 int block, int blocks, int device, void* stream) {
  cudaSetDevice(device);
  if (blocks <= 0) blocks = (batch + kWalkThreads - 1) / kWalkThreads;
  const uint32_t* x = (const uint32_t*)xw;
  const uint32_t* v = (const uint32_t*)vj;
  uint32_t* o = (uint32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (layout * 4 + body) {
    case kGrouped * 4 + kNull:
      launch_walk<kGrouped, kNull>(x, v, o, batch, block, blocks, s);
      break;
    case kGrouped * 4 + kOneExtract:
      launch_walk<kGrouped, kOneExtract>(x, v, o, batch, block, blocks, s);
      break;
    case kGrouped * 4 + kXorOnly:
      launch_walk<kGrouped, kXorOnly>(x, v, o, batch, block, blocks, s);
      break;
    case kGrouped * 4 + kFull:
      launch_walk<kGrouped, kFull>(x, v, o, batch, block, blocks, s);
      break;
    case kWord * 4 + kFull:
      launch_walk<kWord, kFull>(x, v, o, batch, block, blocks, s);
      break;
    case kRow * 4 + kFull:
      launch_walk<kRow, kFull>(x, v, o, batch, block, blocks, s);
      break;
    case kBitcast * 4 + kXorOnly:
      launch_walk<kBitcast, kXorOnly>(x, v, o, batch, block, blocks, s);
      break;
    case kBitcast * 4 + kFull:
      launch_walk<kBitcast, kFull>(x, v, o, batch, block, blocks, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return finish();
}

}  // extern "C"
