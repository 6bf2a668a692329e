// K2 compact_indices: stable stream compaction of row indices.
//
// Replaces presto_tpu/data/column.py:compact (:760), which builds a
// distinct order key per row (survivors first) and argsorts it; the
// gathers of every column (gather_page :748) stay torch indexing.
//
// Output: perm[n] is the stable partition of 0..n-1 with the rows where
// keep[i] && i < *num_rows first, in row order, then all other rows in row
// order (the same permutation the JAX argsort gives); *count is the number
// of survivors, left on the device.
//
// Three launches on the caller's stream:
//   1. count:   one block per tile of COMPACT_TILE rows counts survivors;
//   2. scan:    one block turns the block counts into exclusive offsets and
//               writes the total;
//   3. scatter: each block rescans its tile (per-thread counts, block scan)
//               and writes survivor and non-survivor indices in order.
//
// Bound on an H100: memory. The work reads keep (1 B/row) and writes perm
// (8 B/row); the kernel reads keep twice (count and scatter), so it moves
// about 10 B/row. Nothing in it is compute-heavy: each thread handles
// ITEMS consecutive rows and a block scan costs a few shuffles per warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define CT_THREADS 256
#define CT_ITEMS 8
#define CT_TILE (CT_THREADS * CT_ITEMS)   // = native.COMPACT_TILE
#define SCAN_THREADS 1024

static __device__ __forceinline__ int64_t row_limit(int64_t n,
                                                    const int64_t* num_rows) {
  int64_t lim = n;
  if (num_rows != nullptr) {
    int64_t r = *num_rows;
    lim = r < 0 ? 0 : (r < n ? r : n);
  }
  return lim;
}

__global__ void compact_count_kernel(const uint8_t* __restrict__ keep,
                                     int64_t n, const int64_t* num_rows,
                                     int64_t* __restrict__ block_counts) {
  const int64_t lim = row_limit(n, num_rows);
  const int64_t base = (int64_t)blockIdx.x * CT_TILE
                       + (int64_t)threadIdx.x * CT_ITEMS;
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < CT_ITEMS; ++k) {
    const int64_t i = base + k;
    if (i < lim && keep[i]) ++c;
  }
  int64_t total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

// One block: block_counts (in) -> exclusive offsets (out), *count = total.
__global__ void compact_scan_kernel(int64_t* __restrict__ block_counts,
                                    int64_t nblocks, int64_t* count) {
  int64_t carry = 0;
  for (int64_t start = 0; start < nblocks; start += blockDim.x) {
    const int64_t j = start + threadIdx.x;
    const int64_t x = j < nblocks ? block_counts[j] : 0;
    int64_t chunk_total;
    const int64_t excl = block_exclusive_scan(x, &chunk_total);
    if (j < nblocks) block_counts[j] = carry + excl;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void compact_scatter_kernel(const uint8_t* __restrict__ keep,
                                       int64_t n, const int64_t* num_rows,
                                       const int64_t* __restrict__ block_offsets,
                                       const int64_t* count,
                                       int64_t* __restrict__ perm) {
  const int64_t lim = row_limit(n, num_rows);
  const int64_t base = (int64_t)blockIdx.x * CT_TILE
                       + (int64_t)threadIdx.x * CT_ITEMS;
  bool kept[CT_ITEMS];
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < CT_ITEMS; ++k) {
    const int64_t i = base + k;
    kept[k] = i < lim && keep[i];
    c += kept[k];
  }
  int64_t block_total;
  // survivors before this thread's first row
  int64_t before = block_offsets[blockIdx.x]
                   + block_exclusive_scan(c, &block_total);
  const int64_t total = *count;
#pragma unroll
  for (int k = 0; k < CT_ITEMS; ++k) {
    const int64_t i = base + k;
    if (i >= n) break;
    if (kept[k]) {
      perm[before] = i;
      ++before;
    } else {
      // non-survivors keep row order after all survivors
      perm[total + (i - before)] = i;
    }
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keep: [n] bool; num_rows: device int64 scalar or null (no limit);
// perm: [n] int64 out; count: device int64 scalar out;
// scratch: [ceil(n / CT_TILE)] int64.
int compact_indices(const void* keep, int64_t n, const void* num_rows,
                    void* perm, void* count, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nblocks = (n + CT_TILE - 1) / CT_TILE;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint8_t* k = (const uint8_t*)keep;
  const int64_t* nr = (const int64_t*)num_rows;
  int64_t* offsets = (int64_t*)scratch;
  compact_count_kernel<<<(unsigned)nblocks, CT_THREADS, 0, s>>>(k, n, nr,
                                                                offsets);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(offsets, nblocks,
                                                 (int64_t*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_scatter_kernel<<<(unsigned)nblocks, CT_THREADS, 0, s>>>(
      k, n, nr, offsets, (const int64_t*)count, (int64_t*)perm);
  return (int)cudaGetLastError();
}

}  // extern "C"
