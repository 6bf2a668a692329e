// The merge-path layout of expansion slots over rows, shared by K6
// join_expand (join.cu) and K11 unnest_expand (unnest.cu).
//
// Row r owns count[r] output slots, in row order. Two launches lay them
// out without a search over the whole page:
//   1. the count pass: tiles of MP_TILE rows taken by ticket; a block scan
//      gives the tile's sum and a decoupled look-back (Merrill and Garland,
//      2016; the scheme of compact.cu) its prefix; the tile writes each
//      row's inclusive prefix sum (cum), the last tile the device total,
//      and every tile the partition (below) of the slot blocks whose first
//      merged item falls among its rows, by a binary search over its rows
//      in shared memory (publish_tile);
//   2. the slot pass, a programmatic dependent launch: the row ends (cum)
//      and the output slots 0 .. out_cap - 1 form one merged sequence (a
//      row end comes before slot j where cum <= j, so slot j's row is the
//      number of row ends before it); each block takes MP_TILE items of it,
//      rows and slots together, from the partition (slot_block), stages its
//      rows' ends in shared memory and finds each slot's row by a merge of
//      MP_ITEMS items a thread in shared memory (merge_slots). Slots at or
//      past the total come after every row end (row = cap): they are dead.
// A page of empty rows or one row of a million slots gives every block the
// same number of items. Prefix sums are int64.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define MP_THREADS 256
#define MP_ITEMS 8
#define MP_TILE (MP_THREADS * MP_ITEMS)   // rows of a count tile; merged
                                          // items of a slot block
#define MP_FULL 0xffffffffu
// tile status word: flag bits over the value (a sum below 2^62)
#define ST_AGG (1ull << 62)      // the tile's own sum
#define ST_PREFIX (1ull << 63)   // the sum up to and including the tile
#define ST_VALUE (ST_AGG - 1)

// waits until the grid this one was launched behind (a programmatic
// dependent launch) has finished and its writes are visible; PTX
// griddepcontrol, sm_90
static __device__ __forceinline__ void wait_for_prior_grid() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// Scratch of a call, in int64 words: the ticket, a status word a count
// tile, the slot blocks' partition and each row's prefix sum.
struct MergeLayout {
  int64_t tiles, nparts;
  int64_t tickets, status, part, cum, words;   // offsets in words
};

static inline MergeLayout merge_layout(int64_t cap, int64_t out_cap) {
  MergeLayout l;
  l.tiles = (cap + MP_TILE - 1) / MP_TILE;
  l.nparts = (cap + out_cap + MP_TILE - 1) / MP_TILE;
  l.tickets = 0;
  l.status = l.tickets + 1;
  l.part = l.status + l.tiles;
  l.cum = l.part + l.nparts + 1;
  l.words = l.cum + cap;
  return l;
}

// The count tile this block takes: tiles go by ticket, so every tile a
// look-back waits on was taken by a block that is running.
static __device__ __forceinline__ unsigned take_tile(unsigned* tickets) {
  __shared__ unsigned tile_sh;
  if (threadIdx.x == 0) tile_sh = atomicAdd(tickets, 1u);
  __syncthreads();
  return tile_sh;
}

// The sum before tile t (t > 0), by warp 0: each lane waits for the word
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
    const unsigned pre = __ballot_sync(MP_FULL, (s & ST_PREFIX) != 0);
    int64_t v = (int64_t)(s & ST_VALUE);
    if (pre && lane > __ffs(pre) - 1) v = 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(MP_FULL, v, o);
    prefix += v;
    if (pre) return prefix;
  }
}

// position of row a's end in the merged sequence: the rows before it and
// the slots before its end
static __device__ __forceinline__ int64_t merged_pos(int64_t a, int64_t end,
                                                     int64_t out_cap) {
  return a + (end < out_cap ? end : out_cap);
}

// The count pass's work once a thread holds its MP_ITEMS rows' counts m
// (rows of tile t, which begins at row t * MP_TILE; rows at or past cap
// count 0): cum, the total (last tile) and the partition of the slot
// blocks whose first merged item k * MP_TILE lies after the tile's first
// row end's predecessor and at or before its last row end (the last tile:
// every block after): part[k] = the row ends before it.
static __device__ void publish_tile(const int64_t (&m)[MP_ITEMS], unsigned t,
                                    unsigned tiles, int64_t cap,
                                    int64_t out_cap,
                                    unsigned long long* status,
                                    int64_t* __restrict__ part,
                                    int64_t nparts, int64_t* __restrict__ cum,
                                    int64_t* total) {
  __shared__ int64_t s_end[MP_TILE];
  __shared__ int64_t before_sh;
  const int tid = threadIdx.x;
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < MP_ITEMS; ++k) s += m[k];
  int64_t tile_total;
  const int64_t excl = block_exclusive_scan(s, &tile_total);
  if (tid < 32) {
    int64_t before = 0;
    if (t == 0) {
      if (tid == 0)
        *(volatile unsigned long long*)&status[0] = ST_PREFIX | tile_total;
    } else {
      if (tid == 0)
        *(volatile unsigned long long*)&status[t] = ST_AGG | tile_total;
      before = look_back(status, t);
      if (tid == 0)
        *(volatile unsigned long long*)&status[t] =
            ST_PREFIX | (before + tile_total);
    }
    if (tid == 0) {
      before_sh = before;
      if (t == tiles - 1) *total = before + tile_total;
    }
  }
  __syncthreads();
  const int64_t before = before_sh;
  const int64_t base = (int64_t)t * MP_TILE;
  int64_t run = before + excl;
#pragma unroll
  for (int k = 0; k < MP_ITEMS; ++k) {
    run += m[k];
    s_end[tid * MP_ITEMS + k] = run;
  }
  __syncthreads();
  const int rows = (int)(cap - base < MP_TILE ? cap - base : MP_TILE);
  for (int x = tid; x < rows; x += MP_THREADS) cum[base + x] = s_end[x];
  const int64_t pos_before = base == 0 ? -1
      : merged_pos(base - 1, before, out_cap);
  const int64_t k0 = (pos_before + MP_TILE) / MP_TILE;   // first D > pos
  const int64_t k1 = t == tiles - 1 ? nparts
      : merged_pos(base + rows - 1, s_end[rows - 1], out_cap) / MP_TILE;
  const int64_t dmax = cap + out_cap;
  for (int64_t k = k0 + tid; k <= k1; k += MP_THREADS) {
    const int64_t d = k * MP_TILE < dmax ? k * MP_TILE : dmax;
    int lo = 0, hi = rows;               // rows of the tile before d
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (merged_pos(base + mid, s_end[mid], out_cap) < d) lo = mid + 1;
      else hi = mid;
    }
    part[k] = base + lo;
  }
}

// A slot block's share of the merged sequence: rows a0 .. a0 + na - 1
// end in it, and slots b0 .. b0 + nb - 1 lie in it.
struct SlotBlock {
  int64_t a0, b0;
  int na, nb;
};

static __device__ __forceinline__ SlotBlock slot_block(
    const int64_t* __restrict__ part, int64_t cap, int64_t out_cap) {
  const int64_t d0 = (int64_t)blockIdx.x * MP_TILE;
  const int64_t d1 = d0 + MP_TILE < cap + out_cap ? d0 + MP_TILE
                                                  : cap + out_cap;
  SlotBlock sb;
  sb.a0 = __ldg(part + blockIdx.x);
  const int64_t a1 = __ldg(part + blockIdx.x + 1);
  sb.b0 = d0 - sb.a0;
  sb.na = (int)(a1 - sb.a0);
  sb.nb = (int)(d1 - a1 - sb.b0);
  return sb;
}

// The merge of this thread's MP_ITEMS items: s_cum[0] is the end before
// row a0, s_cum[1 + x] row a0 + x's end (x < na). Calls emit(bi, ai) for
// each of its slots b0 + bi, ai being the block's rows that end before it
// (so its row is a0 + ai, which ends past the block where ai = na).
template <typename Emit>
static __device__ __forceinline__ void merge_slots(const int64_t* s_cum,
                                                   const SlotBlock& sb,
                                                   Emit emit) {
  const int na = sb.na, nb = sb.nb;
  const int64_t b0 = sb.b0;
  const int dt = threadIdx.x * MP_ITEMS < na + nb ? threadIdx.x * MP_ITEMS
                                                  : na + nb;
  int lo = dt - nb > 0 ? dt - nb : 0, hi = dt < na ? dt : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_cum[1 + mid] <= b0 + (dt - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int ai = lo, bi = dt - lo;
  const int dend = dt + MP_ITEMS < na + nb ? dt + MP_ITEMS : na + nb;
  for (int d = dt; d < dend; ++d) {
    if (ai < na && (bi >= nb || s_cum[1 + ai] <= b0 + bi)) {
      ++ai;
    } else {
      emit(bi, ai);
      ++bi;
    }
  }
}
