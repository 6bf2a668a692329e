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
// second a programmatic dependent launch), laid out by merge path
// (merge_path.cuh, shared with K6); the channels' pointers come as a
// device array, so any number of channels is one pass:
//   1. counts: tiles of MP_TILE rows taken by ticket; a thread reads its
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
//      before it); each block takes MP_TILE items of it, rows and slots
//      together, from the partition, stages its rows' ends in shared
//      memory, finds each slot's parent and position in its row by a merge
//      of MP_ITEMS items a thread in shared memory, then writes every lane
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

#include "merge_path.cuh"

#define UX_ITEMS MP_ITEMS        // rows a thread of the count pass
#define SL_TILE MP_TILE          // merged items (rows + slots) a slot block

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
__global__ void __launch_bounds__(MP_THREADS) unnest_count_kernel(
    const void* const* __restrict__ chan, int nch, int64_t cap,
    int64_t out_cap, const int64_t* __restrict__ num_rows, int aligned,
    unsigned* tickets, unsigned long long* status,
    int64_t* __restrict__ part, int64_t nparts, int64_t* __restrict__ cum,
    int64_t* total, unsigned tiles) {
  const unsigned t = take_tile(tickets);
  int64_t nrows = *num_rows;
  nrows = nrows < 0 ? 0 : (nrows < cap ? nrows : cap);
  const int64_t r0 = (int64_t)t * MP_TILE + (int64_t)threadIdx.x * UX_ITEMS;
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
  publish_tile(m, t, tiles, cap, out_cap, status, part, nparts, cum, total);
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
__global__ void __launch_bounds__(MP_THREADS) unnest_slots_kernel(
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
  const SlotBlock sb = slot_block(part, cap, out_cap);
  const int64_t a0 = sb.a0, b0 = sb.b0;
  if (tid == 0) s_cum[0] = a0 > 0 ? __ldg(cum + a0 - 1) : 0;
  for (int x = tid; x < sb.na; x += MP_THREADS)
    s_cum[1 + x] = __ldg(cum + a0 + x);
  __syncthreads();
  merge_slots(s_cum, sb, [&](int bi, int ai) {
    s_par[bi] = ai;
    s_w[bi] = (int)(b0 + bi - s_cum[ai]);
  });
  __syncthreads();
  // every lane of the block's slots [b0, bend): the 8-byte lanes two
  // slots a thread (16-byte stores), the flags four (4-byte stores), in
  // groups aligned to the lanes (a group cut by the block's edge stores
  // its slots one by one)
  const int64_t bend = b0 + sb.nb;
  for (int64_t j0 = (b0 & ~1LL) + 2 * tid; j0 < bend; j0 += 2 * MP_THREADS) {
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
  for (int64_t j0 = (b0 & ~3LL) + 4 * tid; j0 < bend; j0 += 4 * MP_THREADS) {
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

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch a call takes: the tickets, a status word a count
// tile, the slot blocks' partition and each row's prefix sum.
int64_t unnest_expand_scratch_words(int64_t cap, int64_t out_cap) {
  return merge_layout(cap, out_cap).words;
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
  const MergeLayout l = merge_layout(cap, out_cap);
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
    unnest_count_kernel<<<(unsigned)l.tiles, MP_THREADS, 0, s>>>(
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
  cfg.blockDim = dim3(MP_THREADS);
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
