// Shared helpers of the shark_tpu_torch CUDA kernels (sm_90a, plain C
// interface, loaded with ctypes by shark_tpu_torch/kernels.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

// Block-wide exclusive prefix sum of one int per thread. blockDim.x must
// be a multiple of 32 and at most 1024; `sh` is >= 33 ints of shared
// memory. Every thread gets the block total in `total`. Contains
// __syncthreads, so every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) sh[lane] = s;  // inclusive sums over warps
    if (lane == 31) sh[32] = s;       // lanes past nwarps added 0
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? sh[warp - 1] : 0);
  total = sh[32];
  __syncthreads();  // sh may be reused by the caller's next scan
  return excl;
}

// Block-wide max of one int per thread; same contract as the scan.
__device__ __forceinline__ int block_max(int v, int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? sh[lane] : INT32_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = max(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) sh[32] = s;
  }
  __syncthreads();
  const int out = sh[32];
  __syncthreads();
  return out;
}

// Grid size for `n` items at `per_block` items per block.
static inline unsigned grid_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}
