// K11 unnest_expand: the output layout of UNNEST
// (presto_tpu_torch/ops/unnest.py).
//
// Replaces the device work of presto_tpu/ops/unnest.py:unnest_page (:27)
// before its gathers: the per-row expansion count (the largest length over
// the unnest channels, 0 for a NULL row or a row at or past num_rows), its
// cumsum, the searchsorted of every output slot for its parent row, each
// channel's element index and entry flag, and the ordinality lane (the
// slot's position within its row plus one; the position is not written
// apart from that, since unnest_page needs it only through these lanes).
//
// Four launches, K6's layout (csrc/join.cu): per-tile sums of the row
// counts, a one-block scan of the tile sums (which writes the total to the
// device, so the executor reads it in its one host sync), per-row
// inclusive prefix sums, then one thread per output slot below out_cap,
// which binary-searches the prefix sums for its parent row and writes the
// slot's lanes. A launch reads at most MAX_CH channels. With more, the
// channels past the first MAX_CH are first folded, MAX_CH at a time, into
// a per-row maximum that the count passes read beside the first MAX_CH,
// and the slot pass runs once per group of MAX_CH channels (the first
// also writing the parent, flag and ordinality lanes), so any number of
// channels gives the plain version's lanes. Prefix sums are int64: a page of 2^21 rows whose arrays
// hold 6M elements is ordinary, and the executor's capacity reaches 2^26.
// Slots at or past the total are dead: parent and eidx 0, the flags 0, the
// ordinality the BIGINT null sentinel.
//
// Bound on an H100: memory. Each live row's start, length and null flag
// are read per channel (9 B; rows at or past num_rows are never read), and
// its 8-byte prefix sum written once and read by the search (mostly from
// L2); each slot writes parent (8 B), its flag (1 B), per channel an
// element index (8 B) and a flag (1 B), and the ordinality (8 B) when
// asked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define MAX_CH 8            // = ops/unnest.MAX_CHANNELS, per launch
#define UX_THREADS 256
#define UX_ITEMS 8
#define UX_TILE (UX_THREADS * UX_ITEMS)   // = ops/unnest.EXPAND_TILE
#define SCAN_THREADS 1024
#define MAX_BLOCKS (132 * 64)             // grid-stride beyond this

struct Channels {
  const int32_t* starts[MAX_CH];
  const int32_t* lengths[MAX_CH];
  const uint8_t* nulls[MAX_CH];
  int count;
};

// the expansion count of row i: max over the channels of its length, 0
// for a NULL row of that channel and for a row past num_rows; `extra`
// (or null): the maximum over the channels past these
static __device__ __forceinline__ int64_t row_count(const Channels& ch,
                                                    int64_t i,
                                                    int64_t nrows,
                                                    const int64_t* extra) {
  if (i >= nrows) return 0;
  int64_t m = extra != nullptr ? extra[i] : 0;
  for (int c = 0; c < ch.count; ++c) {
    if (ch.nulls[c][i]) continue;
    const int64_t l = ch.lengths[c][i];
    m = l > m ? l : m;
  }
  return m;
}

// 0. (more than MAX_CH channels) the maximum row count over a group of
// channels, folded into `extra`, which the first group writes
__global__ void unnest_rowmax_kernel(Channels ch, int64_t cap,
                                     const int64_t* __restrict__ num_rows,
                                     int64_t* __restrict__ extra,
                                     int first) {
  const int64_t nrows = *num_rows;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += stride) {
    const int64_t m = row_count(ch, i, nrows, nullptr);
    extra[i] = first || m > extra[i] ? m : extra[i];
  }
}

// 1. per tile: the sum of its row counts
__global__ void unnest_count_kernel(Channels ch, int64_t cap,
                                    const int64_t* __restrict__ num_rows,
                                    const int64_t* __restrict__ extra,
                                    int64_t* __restrict__ tile_sums) {
  const int64_t nrows = *num_rows;
  const int64_t base = (int64_t)blockIdx.x * UX_TILE
                       + (int64_t)threadIdx.x * UX_ITEMS;
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < UX_ITEMS; ++k) {
    const int64_t i = base + k;
    if (i < cap) s += row_count(ch, i, nrows, extra);
  }
  int64_t total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// 2. one block: tile sums (in) -> exclusive tile offsets (out), *total
__global__ void unnest_scan_kernel(int64_t* __restrict__ tile_sums,
                                   int64_t ntiles, int64_t* total) {
  int64_t carry = 0;
  for (int64_t start = 0; start < ntiles; start += blockDim.x) {
    const int64_t j = start + threadIdx.x;
    const int64_t x = j < ntiles ? tile_sums[j] : 0;
    int64_t chunk_total;
    const int64_t excl = block_exclusive_scan(x, &chunk_total);
    if (j < ntiles) tile_sums[j] = carry + excl;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) *total = carry;
}

// 3. per tile: inclusive prefix sums of the row counts
__global__ void unnest_cum_kernel(Channels ch, int64_t cap,
                                  const int64_t* __restrict__ num_rows,
                                  const int64_t* __restrict__ extra,
                                  const int64_t* __restrict__ tile_offsets,
                                  int64_t* __restrict__ cum) {
  const int64_t nrows = *num_rows;
  const int64_t base = (int64_t)blockIdx.x * UX_TILE
                       + (int64_t)threadIdx.x * UX_ITEMS;
  int64_t c[UX_ITEMS];
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < UX_ITEMS; ++k) {
    const int64_t i = base + k;
    c[k] = i < cap ? row_count(ch, i, nrows, extra) : 0;
    s += c[k];
  }
  int64_t tile_total;
  int64_t run = tile_offsets[blockIdx.x]
                + block_exclusive_scan(s, &tile_total);
#pragma unroll
  for (int k = 0; k < UX_ITEMS; ++k) {
    const int64_t i = base + k;
    run += c[k];
    if (i < cap) cum[i] = run;
  }
}

// 4. one thread per output slot, for one group of channels (eidx and ok
// point at the group's first channel); the first group also writes the
// parent, flag and ordinality lanes
__global__ void unnest_slots_kernel(Channels ch,
                                    const int64_t* __restrict__ cum,
                                    int64_t cap, int64_t out_cap,
                                    const int64_t* total, int first,
                                    int64_t ord_sentinel,
                                    int64_t* __restrict__ parent,
                                    uint8_t* __restrict__ out_valid,
                                    int64_t* __restrict__ eidx,
                                    uint8_t* __restrict__ ok,
                                    int64_t* __restrict__ ord) {
  const int64_t t = *total;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < out_cap; j += stride) {
    if (j >= t) {
      if (first) {
        parent[j] = 0;
        out_valid[j] = 0;
        if (ord != nullptr) ord[j] = ord_sentinel;
      }
      for (int c = 0; c < ch.count; ++c) {
        eidx[c * out_cap + j] = 0;
        ok[c * out_cap + j] = 0;
      }
      continue;
    }
    int64_t a = 0, b = cap;
    while (a < b) {                      // first row with cum > j
      const int64_t m = (a + b) >> 1;
      if (cum[m] <= j) a = m + 1; else b = m;
    }
    const int64_t p = a;
    const int64_t w = j - (p > 0 ? cum[p - 1] : 0);
    if (first) {
      parent[j] = p;
      out_valid[j] = 1;
      if (ord != nullptr) ord[j] = w + 1;
    }
    for (int c = 0; c < ch.count; ++c) {
      eidx[c * out_cap + j] = (int64_t)ch.starts[c][p] + w;
      ok[c * out_cap + j] =
          (w < (int64_t)ch.lengths[c][p] && !ch.nulls[c][p]) ? 1 : 0;
    }
  }
}

static unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// channels c0 .. c0 + MAX_CH - 1 (those below nch) of ptrs
static Channels channel_group(const void* const* ptrs, int nch, int c0) {
  Channels ch;
  ch.count = nch - c0 < MAX_CH ? nch - c0 : MAX_CH;
  for (int c = 0; c < MAX_CH; ++c) {
    const bool used = c < ch.count;
    ch.starts[c] = used ? (const int32_t*)ptrs[c0 + c] : nullptr;
    ch.lengths[c] = used ? (const int32_t*)ptrs[nch + c0 + c] : nullptr;
    ch.nulls[c] = used ? (const uint8_t*)ptrs[2 * nch + c0 + c] : nullptr;
  }
  return ch;
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ptrs: host array of 3 * nch device pointers, the channels' starts
// (int32), then lengths (int32), then nulls (uint8), each [cap];
// num_rows: device int64 scalar; cum: [max(cap, 1)] int64 scratch; tiles:
// [max(ceil(cap / UX_TILE), 1)] int64 scratch; extra: [max(cap, 1)] int64
// scratch where nch > MAX_CH, else null; total: device int64 scalar out;
// parent: [out_cap] int64 out; out_valid: [out_cap] uint8 out; eidx: [nch,
// out_cap] int64 out; ok: [nch, out_cap] uint8 out; ord: [out_cap] int64
// out, or null for none.
int unnest_expand(const void* const* ptrs, int nch, int64_t cap,
                  const void* num_rows, int64_t out_cap,
                  int64_t ord_sentinel, void* cum, void* tiles, void* extra,
                  void* total, void* parent, void* out_valid, void* eidx,
                  void* ok, void* ord, void* stream) {
  if (nch < 1 || cap < 0 || out_cap < 0 || (nch > MAX_CH && !extra))
    return (int)cudaErrorInvalidValue;
  const Channels ch = channel_group(ptrs, nch, 0);
  const int64_t* ex = nch > MAX_CH ? (const int64_t*)extra : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (cap == 0) {
    e = cudaMemsetAsync(total, 0, sizeof(int64_t), s);
    if (e != cudaSuccess) return (int)e;
  } else {
    for (int c0 = MAX_CH; c0 < nch; c0 += MAX_CH) {
      unnest_rowmax_kernel<<<grid_for(cap, UX_THREADS), UX_THREADS, 0, s>>>(
          channel_group(ptrs, nch, c0), cap, (const int64_t*)num_rows,
          (int64_t*)extra, c0 == MAX_CH);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    const int64_t ntiles = (cap + UX_TILE - 1) / UX_TILE;
    if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    unnest_count_kernel<<<(unsigned)ntiles, UX_THREADS, 0, s>>>(
        ch, cap, (const int64_t*)num_rows, ex, (int64_t*)tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    unnest_scan_kernel<<<1, SCAN_THREADS, 0, s>>>((int64_t*)tiles, ntiles,
                                                  (int64_t*)total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    unnest_cum_kernel<<<(unsigned)ntiles, UX_THREADS, 0, s>>>(
        ch, cap, (const int64_t*)num_rows, ex, (const int64_t*)tiles,
        (int64_t*)cum);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (out_cap == 0) return 0;
  for (int c0 = 0; c0 < nch; c0 += MAX_CH) {
    unnest_slots_kernel<<<grid_for(out_cap, UX_THREADS), UX_THREADS, 0, s>>>(
        channel_group(ptrs, nch, c0), (const int64_t*)cum, cap, out_cap,
        (const int64_t*)total, c0 == 0, ord_sentinel, (int64_t*)parent,
        (uint8_t*)out_valid, (int64_t*)eidx + (int64_t)c0 * out_cap,
        (uint8_t*)ok + (int64_t)c0 * out_cap, (int64_t*)ord);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
