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
// One launch (after a cudaMemsetAsync of the counters and tile status
// words), a decoupled look-back scan (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016) over tiles of
// CT_TILE rows:
//   phase 1: blocks take tiles in order from an atomic ticket, so a tile's
//     predecessors have all been taken by running blocks. Each thread
//     loads its 16 flags as one uint4 and keeps them as a 16-bit mask; a
//     block scan gives the tile's survivor count, published at once in the
//     tile's status word, then warp 0 looks back over the predecessors'
//     words, 32 at a time, to the nearest inclusive prefix and publishes
//     the tile's own. The tile's survivors are staged in shared memory
//     and written with coalesced stores; its masks go to scratch.
//   phase 2: a non-survivor's position is the survivor total plus the
//     non-survivors before it, and the total is known only when every tile
//     is through phase 1. A block waits for that once it finds no phase-1
//     tile left to take (every unfinished tile then belongs to a running
//     block, so the wait always ends), then takes tiles from a second
//     ticket, reads their masks (2 B a thread, not keep again), stages the
//     non-survivors and writes them with coalesced stores.
//
// Bound on an H100: memory. The work reads keep (1 B/row) and writes perm
// (8 B/row); the kernel also writes and reads the masks (1/8 B/row) and
// 24 B of status a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define CT_THREADS 256
#define CT_ITEMS 16
#define CT_TILE (CT_THREADS * CT_ITEMS)   // = native.COMPACT_TILE
#define CT_BLOCKS (132 * 8)
#define FULL 0xffffffffu
// tile status word: flag bits over the value (a count below 2^62)
#define ST_AGG (1ull << 62)      // the tile's own survivor count
#define ST_PREFIX (1ull << 63)   // survivors up to and including the tile
#define ST_VALUE (ST_AGG - 1)

static __device__ __forceinline__ int64_t row_limit(int64_t n,
                                                    const int64_t* num_rows) {
  int64_t lim = n;
  if (num_rows != nullptr) {
    int64_t r = *num_rows;
    lim = r < 0 ? 0 : (r < n ? r : n);
  }
  return lim;
}

// bit k: row row0 + k holds a set flag (rows past n read as unset)
static __device__ __forceinline__ unsigned load_flags(
    const uint8_t* __restrict__ keep, int64_t row0, int64_t n, bool aligned) {
  unsigned m = 0;
  if (aligned && row0 + CT_ITEMS <= n) {
    const uint4 v = *(const uint4*)(keep + row0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w[q] >> (8 * b)) & 0xffu) m |= 1u << (4 * q + b);
  } else {
#pragma unroll
    for (int k = 0; k < CT_ITEMS; ++k)
      if (row0 + k < n && keep[row0 + k]) m |= 1u << k;
  }
  return m;
}

// the low `rows` bits, rows clamped to [0, CT_ITEMS]
static __device__ __forceinline__ unsigned low_bits(int64_t rows) {
  return rows <= 0 ? 0u
                   : (rows >= CT_ITEMS ? (1u << CT_ITEMS) - 1
                                       : (1u << rows) - 1);
}

// Survivors before tile t (t > 0), by warp 0: each lane waits for the word
// of one predecessor, the nearest inclusive prefix ends the walk.
static __device__ int64_t look_back(const unsigned long long* status,
                                    unsigned t) {
  const int lane = threadIdx.x & 31;
  const volatile unsigned long long* st = status;
  int64_t prefix = 0;
  for (int64_t end = (int64_t)t - 1;; end -= 32) {
    const int64_t j = end - lane;
    unsigned long long s = ST_PREFIX;   // before tile 0: a prefix of 0
    if (j >= 0) {
      do {
        s = st[j];
      } while (!(s & (ST_AGG | ST_PREFIX)));
    }
    const unsigned pre = __ballot_sync(FULL, (s & ST_PREFIX) != 0);
    int64_t v = (int64_t)(s & ST_VALUE);
    if (pre && lane > __ffs(pre) - 1) v = 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    prefix += v;
    if (pre) return prefix;
  }
}

__global__ void compact_kernel(const uint8_t* __restrict__ keep, int64_t n,
                               const int64_t* num_rows,
                               int64_t* __restrict__ perm, int64_t* count,
                               unsigned* tickets, unsigned long long* status,
                               int64_t* tile_before, uint16_t* masks,
                               unsigned tiles, int aligned) {
  __shared__ uint16_t stage[CT_TILE];
  __shared__ unsigned tile_sh;
  __shared__ int64_t before_sh;
  const int64_t lim = row_limit(n, num_rows);
  const int tid = threadIdx.x;

  // phase 1: survivors
  for (;;) {
    if (tid == 0) tile_sh = atomicAdd(&tickets[0], 1u);
    __syncthreads();
    const unsigned t = tile_sh;
    if (t >= tiles) break;
    const int64_t row_base = (int64_t)t * CT_TILE;
    const int64_t row0 = row_base + tid * CT_ITEMS;
    const unsigned m = load_flags(keep, row0, n, aligned != 0)
                       & low_bits(lim - row0);
    int64_t tile_kept;
    int k = (int)block_exclusive_scan(__popc(m), &tile_kept);
    if (tid < 32) {
      int64_t before = 0;
      if (t == 0) {
        if (tid == 0)
          *(volatile unsigned long long*)&status[0] = ST_PREFIX | tile_kept;
      } else {
        if (tid == 0)
          *(volatile unsigned long long*)&status[t] = ST_AGG | tile_kept;
        before = look_back(status, t);
        if (tid == 0)
          *(volatile unsigned long long*)&status[t] =
              ST_PREFIX | (before + tile_kept);
      }
      if (tid == 0) {
        before_sh = before;
        tile_before[t] = before;
        if (t == tiles - 1) *count = before + tile_kept;
      }
    }
    masks[(int64_t)t * CT_THREADS + tid] = (uint16_t)m;
    for (unsigned b = m; b; b &= b - 1)
      stage[k++] = (uint16_t)(tid * CT_ITEMS + __ffs(b) - 1);
    __syncthreads();
    const int64_t before = before_sh;
    for (int j = tid; j < tile_kept; j += CT_THREADS)
      perm[before + j] = row_base + stage[j];
    __threadfence();   // this tile's masks, prefix and count, before done
    __syncthreads();
    if (tid == 0) atomicAdd(&tickets[1], 1u);
  }

  // phase 2: non-survivors, after the total
  if (tid == 0) {
    while (*(volatile unsigned*)&tickets[1] < tiles) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  const int64_t total = __ldcg((const long long*)count);
  for (;;) {
    if (tid == 0) tile_sh = atomicAdd(&tickets[2], 1u);
    __syncthreads();
    const unsigned t = tile_sh;
    if (t >= tiles) break;
    const int64_t row_base = (int64_t)t * CT_TILE;
    const int64_t row0 = row_base + tid * CT_ITEMS;
    const unsigned m = ~(unsigned)__ldcg(&masks[(int64_t)t * CT_THREADS
                                                + tid])
                       & low_bits(n - row0);
    int64_t tile_other;
    int k = (int)block_exclusive_scan(__popc(m), &tile_other);
    for (unsigned b = m; b; b &= b - 1)
      stage[k++] = (uint16_t)(tid * CT_ITEMS + __ffs(b) - 1);
    __syncthreads();
    // every row before the tile is below n: non-survivors before it
    const int64_t at = total + row_base
                       - __ldcg((const long long*)&tile_before[t]);
    for (int j = tid; j < tile_other; j += CT_THREADS)
      perm[at + j] = row_base + stage[j];
    __syncthreads();   // stage and tile_sh are reused by the next tile
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch that a call over n flags takes: two of tickets,
// then per tile its status word, the survivors before it and its threads'
// 16-bit masks.
int64_t compact_scratch_words(int64_t n) {
  const int64_t tiles = (n + CT_TILE - 1) / CT_TILE;
  return 2 + tiles * (2 + CT_THREADS * (int64_t)sizeof(uint16_t)
                              / (int64_t)sizeof(int64_t));
}

// keep: [n] bool; num_rows: device int64 scalar or null (no limit);
// perm: [n] int64 out; count: device int64 scalar out;
// scratch: compact_scratch_words(n) int64 words.
int compact_indices(const void* keep, int64_t n, const void* num_rows,
                    void* perm, void* count, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + CT_TILE - 1) / CT_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unsigned* tickets = (unsigned*)scratch;                 // 3 of 4 used
  unsigned long long* status = (unsigned long long*)scratch + 2;
  int64_t* tile_before = (int64_t*)(status + tiles);
  uint16_t* masks = (uint16_t*)(tile_before + tiles);
  cudaError_t e = cudaMemsetAsync(scratch, 0,
                                  (size_t)(2 + tiles) * sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  const int aligned = ((uintptr_t)keep & 15) == 0;
  const int64_t blocks = tiles < CT_BLOCKS ? tiles : CT_BLOCKS;
  compact_kernel<<<(unsigned)blocks, CT_THREADS, 0, s>>>(
      (const uint8_t*)keep, n, (const int64_t*)num_rows, (int64_t*)perm,
      (int64_t*)count, tickets, status, tile_before, masks,
      (unsigned)tiles, aligned);
  return (int)cudaGetLastError();
}

}  // extern "C"
