// K11 unnest_expand: the output layout of UNNEST
// (presto_tpu_torch/ops/unnest.py).
//
// Replaces the device work of presto_tpu/ops/unnest.py:unnest_page (:27)
// before its gathers: the per-row expansion count (the largest length over
// the unnest channels, 0 for a NULL row or a row at or past num_rows), its
// cumsum (:43), the searchsorted of every output slot for its parent row
// (:46), each channel's element index and entry flag, and the ordinality
// lane (the slot's position within its row plus one; the position is not
// written apart from that, since unnest_page needs it only through these
// lanes).
//
// Two launches, after a memset of the ticket and tile status words (the
// second a programmatic dependent launch); the channels' pointers come as
// a device array, so any number of channels is one pass:
//   1. counts: tiles of UX_TILE rows taken by ticket; a thread reads its
//      UX_ITEMS rows' lengths and null flags of every channel once
//      (16- and 8-byte loads where aligned), a block scan gives the tile's
//      sum, a decoupled look-back (Merrill and Garland, 2016; the scheme of
//      csrc/compact.cu) its prefix; the tile writes each row's inclusive
//      prefix sum (cum) and the last tile the device total. The tile also
//      writes the merge-path partition (below) of every slot block whose
//      start falls among its rows, by a binary search over its rows in
//      shared memory, so no search runs over the whole page.
//   2. slots, load-balanced (merge path): the row ends (cum) and the output
//      slots 0 .. out_cap - 1 form one merged sequence (a row end before a
//      slot j where cum <= j, so slot j's parent is the number of row ends
//      before it); each block takes SL_TILE items of it, rows and slots
//      together, from the partition, stages its rows' ends in shared
//      memory, finds each slot's parent and position in its row by a merge
//      of SL_ITEMS items a thread in shared memory, then writes every lane
//      of its slots with coalesced stores (16 bytes a thread for the 8-byte
//      lanes, 4 for the flags): parent, flag, ordinality, and each
//      channel's element index and entry flag. Slots at or past the total
//      come after every row end (parent = cap): they are dead, written by
//      the same pass (parent and eidx 0, the flags 0, the ordinality the
//      BIGINT null sentinel). A page of empty rows or one row of a million
//      elements gives every block the same number of items.
// Prefix sums are int64: a page of 2^21 rows whose arrays hold 6M
// elements is ordinary, and the executor's capacity reaches 2^26.
//
// Bound on an H100: memory. Each live row's length and null flag are read
// per channel (and its start, 4 B, by the slots of the row); each slot
// writes parent (8 B), its flag (1 B), per channel an element index (8 B)
// and a flag (1 B), and the ordinality (8 B) when asked. The kernel also
// writes and reads cum (8 B a row) and the partition.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define UX_THREADS 256
#define UX_ITEMS 8
#define UX_TILE (UX_THREADS * UX_ITEMS)   // rows of a count tile
#define SL_THREADS 256
#define SL_ITEMS 8
#define SL_TILE (SL_THREADS * SL_ITEMS)   // merged items (rows + slots)
#define FULL 0xffffffffu
// tile status word: flag bits over the value (a count below 2^62)
#define ST_AGG (1ull << 62)      // the tile's own sum
#define ST_PREFIX (1ull << 63)   // the sum up to and including the tile
#define ST_VALUE (ST_AGG - 1)

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
    const unsigned pre = __ballot_sync(FULL, (s & ST_PREFIX) != 0);
    int64_t v = (int64_t)(s & ST_VALUE);
    if (pre && lane > __ffs(pre) - 1) v = 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    prefix += v;
    if (pre) return prefix;
  }
}

// waits until the grid this one was launched behind (a programmatic
// dependent launch) has finished and its writes are visible; PTX
// griddepcontrol, sm_90
static __device__ __forceinline__ void wait_for_prior_grid() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// position of row a's end in the merged sequence: the rows before it and
// the slots before its end
static __device__ __forceinline__ int64_t merged_pos(int64_t a, int64_t end,
                                                     int64_t out_cap) {
  return a + (end < out_cap ? end : out_cap);
}

// channel c's lengths and null flags of rows r0 .. r0 + UX_ITEMS - 1 (16-
// and 8-byte loads where whole; rows at or past nrows read as NULL)
static __device__ __forceinline__ void load_counts(
    const void* const* __restrict__ chan, int nch, int c, int64_t r0,
    int64_t nrows, bool whole, int32_t (&l)[UX_ITEMS],
    uint8_t (&z)[UX_ITEMS]) {
  const int32_t* len = (const int32_t*)chan[nch + c];
  const uint8_t* nul = (const uint8_t*)chan[2 * nch + c];
  if (whole) {
    const int4 v0 = __ldg((const int4*)(len + r0));
    const int4 v1 = __ldg((const int4*)(len + r0) + 1);
    const uint2 zz = __ldg((const uint2*)(nul + r0));
    l[0] = v0.x; l[1] = v0.y; l[2] = v0.z; l[3] = v0.w;
    l[4] = v1.x; l[5] = v1.y; l[6] = v1.z; l[7] = v1.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      z[k] = (uint8_t)(zz.x >> (8 * k));
      z[4 + k] = (uint8_t)(zz.y >> (8 * k));
    }
  } else {
#pragma unroll
    for (int k = 0; k < UX_ITEMS; ++k) {
      const bool in = r0 + k < nrows;
      l[k] = in ? __ldg(len + r0 + k) : 0;
      z[k] = in ? __ldg(nul + r0 + k) : 1;
    }
  }
}

// 1. counts, cum, total and the slot blocks' partition
__global__ void __launch_bounds__(UX_THREADS) unnest_count_kernel(
    const void* const* __restrict__ chan, int nch, int64_t cap,
    int64_t out_cap, const int64_t* __restrict__ num_rows, int aligned,
    unsigned* tickets, unsigned long long* status,
    int64_t* __restrict__ part, int64_t nparts, int64_t* __restrict__ cum,
    int64_t* total, unsigned tiles) {
  __shared__ int64_t s_end[UX_TILE];
  __shared__ unsigned tile_sh;
  __shared__ int64_t before_sh;
  const int tid = threadIdx.x;
  if (tid == 0) tile_sh = atomicAdd(&tickets[0], 1u);
  __syncthreads();
  const unsigned t = tile_sh;
  int64_t nrows = *num_rows;
  nrows = nrows < 0 ? 0 : (nrows < cap ? nrows : cap);
  const int64_t r0 = (int64_t)t * UX_TILE + (int64_t)tid * UX_ITEMS;
  int64_t m[UX_ITEMS];
#pragma unroll
  for (int k = 0; k < UX_ITEMS; ++k) m[k] = 0;
  if (r0 < nrows) {
    const bool whole = aligned && r0 + UX_ITEMS <= nrows;
    // two channels' loads in flight at a time
    int c = 0;
    for (; c + 1 < nch; c += 2) {
      int32_t l0[UX_ITEMS], l1[UX_ITEMS];
      uint8_t z0[UX_ITEMS], z1[UX_ITEMS];
      load_counts(chan, nch, c, r0, nrows, whole, l0, z0);
      load_counts(chan, nch, c + 1, r0, nrows, whole, l1, z1);
#pragma unroll
      for (int k = 0; k < UX_ITEMS; ++k) {
        if (!z0[k] && l0[k] > m[k]) m[k] = l0[k];
        if (!z1[k] && l1[k] > m[k]) m[k] = l1[k];
      }
    }
    if (c < nch) {
      int32_t l0[UX_ITEMS];
      uint8_t z0[UX_ITEMS];
      load_counts(chan, nch, c, r0, nrows, whole, l0, z0);
#pragma unroll
      for (int k = 0; k < UX_ITEMS; ++k)
        if (!z0[k] && l0[k] > m[k]) m[k] = l0[k];
    }
  }
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < UX_ITEMS; ++k) s += m[k];
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
  const int64_t base = (int64_t)t * UX_TILE;
  int64_t run = before + excl;
#pragma unroll
  for (int k = 0; k < UX_ITEMS; ++k) {
    run += m[k];
    s_end[tid * UX_ITEMS + k] = run;
  }
  __syncthreads();
  const int rows = (int)(cap - base < UX_TILE ? cap - base : UX_TILE);
  for (int x = tid; x < rows; x += UX_THREADS) cum[base + x] = s_end[x];
  // the slot blocks whose first merged item k * SL_TILE lies after the
  // tile's first row end's predecessor and at or before its last row end
  // (the last tile: every block after): part[k] = the row ends before it
  const int64_t pos_before = base == 0 ? -1
      : merged_pos(base - 1, before, out_cap);
  const int64_t k0 = (pos_before + SL_TILE) / SL_TILE;   // first D > pos
  const int64_t k1 = t == tiles - 1 ? nparts
      : merged_pos(base + rows - 1, s_end[rows - 1], out_cap) / SL_TILE;
  const int64_t dmax = cap + out_cap;
  for (int64_t k = k0 + tid; k <= k1; k += UX_THREADS) {
    const int64_t d = k * SL_TILE < dmax ? k * SL_TILE : dmax;
    int lo = 0, hi = rows;               // rows of the tile before d
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (merged_pos(base + mid, s_end[mid], out_cap) < d) lo = mid + 1;
      else hi = mid;
    }
    part[k] = base + lo;
  }
}

// two 8-byte lanes at x (16-byte aligned where whole): both at once, or
// those in the block's range one by one
static __device__ __forceinline__ void store2(int64_t* x, int64_t a,
                                              int64_t b, const bool (&in)[2],
                                              bool whole) {
  if (whole) {
    *(longlong2*)x = make_longlong2(a, b);
  } else {
    if (in[0]) x[0] = a;
    if (in[1]) x[1] = b;
  }
}

// four flags at x (4-byte aligned where whole)
static __device__ __forceinline__ void store4(uint8_t* x, const bool (&f)[4],
                                              const bool (&in)[4],
                                              bool whole) {
  if (whole) {
    *(uint32_t*)x = (f[0] ? 1u : 0u) | (f[1] ? 1u << 8 : 0u)
                    | (f[2] ? 1u << 16 : 0u) | (f[3] ? 1u << 24 : 0u);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (in[q]) x[q] = f[q] ? 1 : 0;
  }
}

// G consecutive slots j0 .. j0 + G - 1 of a block: whether each is among
// the block's slots [b0, bend), its parent p, whether it is live, and its
// position w within its row (both from the merge, in shared memory)
template <int G>
struct Slots {
  int64_t p[G], w[G];
  bool in[G], live[G];
  __device__ __forceinline__ Slots(int64_t j0, int64_t b0, int64_t bend,
                                   int64_t a0, int64_t cap, const int* s_par,
                                   const int* s_w) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int64_t j = j0 + q;
      in[q] = j >= b0 && j < bend;
      p[q] = a0 + (in[q] ? s_par[j - b0] : 0);
      live[q] = in[q] && p[q] < cap;
      w[q] = live[q] ? s_w[j - b0] : 0;
    }
  }
};

// 2. one block a slice of SL_TILE merged items: the parent of each of its
// slots, then every lane of those slots
__global__ void __launch_bounds__(SL_THREADS) unnest_slots_kernel(
    const void* const* __restrict__ chan, int nch,
    const int64_t* __restrict__ cum, const int64_t* __restrict__ part,
    int64_t cap, int64_t out_cap, int64_t ord_sentinel,
    int64_t* __restrict__ parent, uint8_t* __restrict__ out_valid,
    int64_t* __restrict__ eidx, uint8_t* __restrict__ ok,
    int64_t* __restrict__ ord, int vec) {
  __shared__ int64_t s_cum[SL_TILE + 1];   // [0]: the end before row a0
  __shared__ int s_par[SL_TILE];            // parent of each slot, less a0
  __shared__ int s_w[SL_TILE];              // its position within the row
  const int tid = threadIdx.x;
  wait_for_prior_grid();                 // cum and the partition
  const int64_t d0 = (int64_t)blockIdx.x * SL_TILE;
  const int64_t d1 = d0 + SL_TILE < cap + out_cap ? d0 + SL_TILE
                                                  : cap + out_cap;
  const int64_t a0 = __ldg(part + blockIdx.x), a1 = __ldg(part + blockIdx.x
                                                           + 1);
  const int64_t b0 = d0 - a0;
  const int na = (int)(a1 - a0), nb = (int)(d1 - a1 - b0);
  if (tid == 0) s_cum[0] = a0 > 0 ? __ldg(cum + a0 - 1) : 0;
  for (int x = tid; x < na; x += SL_THREADS)
    s_cum[1 + x] = __ldg(cum + a0 + x);
  __syncthreads();
  // this thread's SL_ITEMS merged items: find where they start, then merge
  const int dt = tid * SL_ITEMS < na + nb ? tid * SL_ITEMS : na + nb;
  int lo = dt - nb > 0 ? dt - nb : 0, hi = dt < na ? dt : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_cum[1 + mid] <= b0 + (dt - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int ai = lo, bi = dt - lo;
  const int dend = dt + SL_ITEMS < na + nb ? dt + SL_ITEMS : na + nb;
  for (int d = dt; d < dend; ++d) {
    if (ai < na && (bi >= nb || s_cum[1 + ai] <= b0 + bi)) {
      ++ai;
    } else {
      s_par[bi] = ai;
      s_w[bi] = (int)(b0 + bi - s_cum[ai]);
      ++bi;
    }
  }
  __syncthreads();
  // every lane of the block's slots [b0, bend): the 8-byte lanes two
  // slots a thread (16-byte stores), the flags four (4-byte stores), in
  // groups aligned to the lanes (a group cut by the block's edge stores
  // its slots one by one)
  const int64_t bend = b0 + nb;
  for (int64_t j0 = (b0 & ~1LL) + 2 * tid; j0 < bend; j0 += 2 * SL_THREADS) {
    Slots<2> sl(j0, b0, bend, a0, cap, s_par, s_w);
    const bool whole = vec && sl.in[0] && sl.in[1];
    store2(parent + j0, sl.live[0] ? sl.p[0] : 0, sl.live[1] ? sl.p[1] : 0,
           sl.in, whole);
    if (ord != nullptr)
      store2(ord + j0, sl.live[0] ? sl.w[0] + 1 : ord_sentinel,
             sl.live[1] ? sl.w[1] + 1 : ord_sentinel, sl.in, whole);
    for (int c = 0; c < nch; ++c) {
      const int32_t* st = (const int32_t*)chan[c];
      int64_t e[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        e[q] = sl.live[q] ? (int64_t)__ldg(st + sl.p[q]) + sl.w[q] : 0;
      store2(eidx + c * out_cap + j0, e[0], e[1], sl.in, whole);
    }
  }
  for (int64_t j0 = (b0 & ~3LL) + 4 * tid; j0 < bend; j0 += 4 * SL_THREADS) {
    Slots<4> sl(j0, b0, bend, a0, cap, s_par, s_w);
    const bool whole = vec && sl.in[0] && sl.in[1] && sl.in[2] && sl.in[3];
    store4(out_valid + j0, sl.live, sl.in, whole);
    for (int c = 0; c < nch; ++c) {
      const int32_t* ln = (const int32_t*)chan[nch + c];
      const uint8_t* nl = (const uint8_t*)chan[2 * nch + c];
      bool f[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f[q] = sl.live[q] && sl.w[q] < (int64_t)__ldg(ln + sl.p[q])
               && !__ldg(nl + sl.p[q]);
      store4(ok + c * out_cap + j0, f, sl.in, whole);
    }
  }
}

struct Layout {
  int64_t tiles, nparts;
  int64_t tickets, status, part, cum, words;   // offsets in words
};

static Layout layout(int64_t cap, int64_t out_cap) {
  Layout l;
  l.tiles = (cap + UX_TILE - 1) / UX_TILE;
  l.nparts = (cap + out_cap + SL_TILE - 1) / SL_TILE;
  l.tickets = 0;
  l.status = l.tickets + 1;
  l.part = l.status + l.tiles;
  l.cum = l.part + l.nparts + 1;
  l.words = l.cum + cap;
  return l;
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch a call takes: the tickets, a status word a count
// tile, the slot blocks' partition and each row's prefix sum.
int64_t unnest_expand_scratch_words(int64_t cap, int64_t out_cap) {
  return layout(cap, out_cap).words;
}

// ptrs: host array of 3 * nch device pointers, the channels' starts
// (int32), then lengths (int32), then nulls (uint8), each [cap]; chan_dev:
// the same array in device memory; num_rows: device int64 scalar; scratch:
// unnest_expand_scratch_words(cap, out_cap) int64 words; total: device
// int64 scalar out; parent: [out_cap] int64 out; out_valid: [out_cap]
// uint8 out; eidx: [nch, out_cap] int64 out; ok: [nch, out_cap] uint8 out;
// ord: [out_cap] int64 out, or null for none.
int unnest_expand(const void* const* ptrs, const void* chan_dev, int nch,
                  int64_t cap, const void* num_rows, int64_t out_cap,
                  int64_t ord_sentinel, void* scratch, void* total,
                  void* parent, void* out_valid, void* eidx, void* ok,
                  void* ord, void* stream) {
  if (nch < 1 || cap < 0 || out_cap < 0 || !scratch || !chan_dev)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(cap, out_cap);
  if (l.tiles > 0x7fffffffLL || l.nparts > 0x7fffffffLL
      || cap > 0x7fffffffLL || out_cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int64_t* w = (int64_t*)scratch;
  const void* const* chan = (const void* const*)chan_dev;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (cap == 0) {
    e = cudaMemsetAsync(total, 0, sizeof(int64_t), s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(w + l.part, 0, (size_t)(l.nparts + 1) * 8, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    e = cudaMemsetAsync(w + l.tickets, 0, (size_t)(1 + l.tiles) * 8, s);
    if (e != cudaSuccess) return (int)e;
    int aligned = 1;
    for (int c = 0; c < nch; ++c)
      if (((uintptr_t)ptrs[nch + c] & 15)
          || ((uintptr_t)ptrs[2 * nch + c] & 7))
        aligned = 0;
    unnest_count_kernel<<<(unsigned)l.tiles, UX_THREADS, 0, s>>>(
        chan, nch, cap, out_cap, (const int64_t*)num_rows, aligned,
        (unsigned*)(w + l.tickets), (unsigned long long*)(w + l.status),
        w + l.part, l.nparts, w + l.cum, (int64_t*)total,
        (unsigned)l.tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (out_cap == 0) return 0;
  // 16-byte stores of the 8-byte lanes and 4-byte stores of the flags
  // where every lane's row starts aligned
  const int vec = (out_cap & 3) == 0
                  && !(((uintptr_t)parent | (uintptr_t)eidx
                        | (uintptr_t)ord) & 15)
                  && !(((uintptr_t)out_valid | (uintptr_t)ok) & 3);
  // launched behind the count pass as a programmatic dependent launch,
  // which waits for it on the card, so its launch latency is not added
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)l.nparts);
  cfg.blockDim = dim3(SL_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = cap > 0 ? 1 : 0;       // no count pass: a plain launch
  return (int)cudaLaunchKernelEx(
      &cfg, unnest_slots_kernel, (const void* const*)chan, nch,
      (const int64_t*)(w + l.cum), (const int64_t*)(w + l.part), cap,
      out_cap, ord_sentinel, (int64_t*)parent, (uint8_t*)out_valid,
      (int64_t*)eidx, (uint8_t*)ok, (int64_t*)ord, vec);
}

}  // extern "C"
