// Block-wide exclusive scan of one int64 per thread, shared by the
// kernels that lay rows out by prefix sums (compact.cu, join.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Exclusive scan of one int64 per thread across the block; also returns the
// block total. blockDim.x must be a multiple of 32 and at most 1024.
static __device__ __forceinline__ int64_t block_exclusive_scan(int64_t x,
                                                               int64_t* total) {
  __shared__ int64_t warp_sums[32];
  __shared__ int64_t block_sum;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int64_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int64_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < nwarps ? warp_sums[lane] : 0;
    int64_t wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int64_t y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < nwarps) warp_sums[lane] = wi - w;   // exclusive warp offsets
    if (lane == 31) block_sum = wi;                // block total
  }
  __syncthreads();
  const int64_t out = warp_sums[warp] + incl - x;
  *total = block_sum;
  __syncthreads();   // warp_sums and block_sum are reused by the next call
  return out;
}
