// splitmix64 kernel for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (tpuminter_torch/kernels/build.py).
//
//   tm_splitmix_batch <- pallas_splitmix_batch (tpuminter/kernels/splitmix.py:65)
//
// The hashcore objective: value = splitmix64(seed + (index + 1) * golden)
// for a batch of global indices, each given and returned as two u32 words
// in int64 lanes (the port's convention for u32 words on the torch side).
// The Pallas kernel builds each 64-bit product from 16-bit limbs and each
// shift from straddling 32-bit halves, because Mosaic has no 64-bit
// integers; here the arithmetic is native uint64_t, and index + 1 wraps at
// 2^64 - 1 as the reference's does.
//
// What bounds it: device memory. An index costs about 25 integer
// instructions (three 64-bit multiplies at three instructions each, three
// 64-bit xor-shifts at four, two 64-bit adds) and moves 32 bytes (two
// int64 words in, two out), so at the H100's rates the bytes take about
// ten times as long as the instructions. Design against that bound: one
// pass, each word read once and written once, neighbouring threads on
// neighbouring words (coalesced), a grid-stride loop over a grid sized to
// keep every SM full of loads in flight. The int64 lanes double the bytes
// a u32 layout would need; the torch ops around the kernel read and
// write the same lanes, which is where the window's time goes.
//
// tm_splitmix_batch launches on the given stream, does not synchronise,
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t splitmix64(uint64_t seed, uint64_t index) {
  uint64_t z = seed + (index + 1ull) * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__global__ void __launch_bounds__(kThreads)
splitmix_batch_kernel(uint64_t seed, const long long* __restrict__ idx_hi,
                      const long long* __restrict__ idx_lo, long long* __restrict__ val_hi,
                      long long* __restrict__ val_lo, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    // words are taken modulo 2^32, as the plain version takes them
    const uint64_t index = ((uint64_t)(uint32_t)idx_hi[i] << 32) | (uint32_t)idx_lo[i];
    const uint64_t v = splitmix64(seed, index);
    val_hi[i] = (long long)(v >> 32);
    val_lo[i] = (long long)(v & 0xFFFFFFFFull);
  }
}

}  // namespace

extern "C" int tm_splitmix_batch(uint64_t seed, const long long* idx_hi,
                                 const long long* idx_lo, long long* val_hi,
                                 long long* val_lo, long long n, int grid, int device,
                                 void* stream) {
  cudaSetDevice(device);
  splitmix_batch_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(seed, idx_hi, idx_lo,
                                                                      val_hi, val_lo, n);
  return (int)cudaGetLastError();
}
