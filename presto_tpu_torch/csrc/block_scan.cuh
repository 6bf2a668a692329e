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

// Block-wide exclusive SEGMENTED scan of one (value, flag) pair per thread,
// for the window scans (seg_scan.cu). A pair is the fold of a run of rows
// under an associative operator `op`; its flag says whether a segment
// starts inside the run. Combining a run a with the run b that follows it:
//   (b.f ? b.v : op(a.v, b.v),  a.f | b.f)
// which is associative whenever op is. Returns the pair of everything
// before the thread (ident, 0 for thread 0) and the block's total.
// blockDim.x must be a multiple of 32 and at most 1024.
template <typename T, typename Op>
static __device__ __forceinline__ void block_exclusive_seg_scan(
    T v, int f, T ident, Op op, T* excl_v, int* excl_f, T* tot_v,
    int* tot_f) {
  __shared__ T warp_v[32];
  __shared__ int warp_f[32];
  __shared__ T block_v;
  __shared__ int block_f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T iv = v;
  int ifl = f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T yv = __shfl_up_sync(0xffffffffu, iv, o);
    const int yf = __shfl_up_sync(0xffffffffu, ifl, o);
    if (lane >= o) {
      if (!ifl) iv = op(yv, iv);
      ifl |= yf;
    }
  }
  // exclusive within the warp: the inclusive value of the lane before
  T ev = __shfl_up_sync(0xffffffffu, iv, 1);
  int ef = __shfl_up_sync(0xffffffffu, ifl, 1);
  if (lane == 0) {
    ev = ident;
    ef = 0;
  }
  if (lane == 31) {
    warp_v[warp] = iv;
    warp_f[warp] = ifl;
  }
  __syncthreads();
  if (warp == 0) {
    T wv = lane < nwarps ? warp_v[lane] : ident;
    int wf = lane < nwarps ? warp_f[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T yv = __shfl_up_sync(0xffffffffu, wv, o);
      const int yf = __shfl_up_sync(0xffffffffu, wf, o);
      if (lane >= o) {
        if (!wf) wv = op(yv, wv);
        wf |= yf;
      }
    }
    T xv = __shfl_up_sync(0xffffffffu, wv, 1);
    int xf = __shfl_up_sync(0xffffffffu, wf, 1);
    if (lane == 0) {
      xv = ident;
      xf = 0;
    }
    if (lane < nwarps) {            // exclusive warp prefixes
      warp_v[lane] = xv;
      warp_f[lane] = xf;
    }
    if (lane == nwarps - 1) {       // block total
      block_v = wv;
      block_f = wf;
    }
  }
  __syncthreads();
  // everything before the thread: the warp's prefix, then the lanes before
  const T pv = warp_v[warp];
  const int pf = warp_f[warp];
  *excl_v = ef ? ev : op(pv, ev);
  *excl_f = pf | ef;
  *tot_v = block_v;
  *tot_f = block_f;
  __syncthreads();   // the shared slots are reused by the next call
}
