// K3 segment_reduce: per-segment count, sum, min and max over contiguous
// [start, end) ranges of sorted rows.
//
// Replaces presto_tpu/ops/scan.py:segment_sums (:160), which takes each
// segment's sum as the difference of one running cumulative sum (cumsum
// :36), and the sort-based min/max of ops/aggregate.py:_eval_agg_sorted
// (:551). Here each segment is summed directly, so float64 sums can differ
// from the JAX package's in the last bits.
//
// A schedule by segment length, so that neither a huge segment nor many
// tiny ones leave the card idle (the pattern of K12's sorted mode,
// hll.cu):
//   pass 1 (classify), one thread a segment: a segment of at most
//     SMALL_MAX rows is reduced by its thread in row order, so adjacent
//     threads read adjacent rows; a segment of up to WARP_MAX rows is
//     listed for a warp; a longer one is cut into pieces of PIECE rows and
//     reserves a run of slots, one a piece (atomicAdd on a slot counter).
//   pass 2 (work), a fixed grid of WORK_BLOCKS blocks: block b reduces the
//     pieces in slots b, b + gridDim.x, ... (its threads stride over the
//     piece's rows, a fixed xor-shuffle tree combines the lanes, thread 0
//     the warps in warp order). A one-piece segment is written by its
//     block; a longer one leaves a partial in its slot, and the block that
//     finishes the segment's last piece (a counter per segment) combines
//     the partials, threads striding over the slots, with the same fixed
//     trees. Then each warp reduces the listed segments in turn.
// For disjoint ranges (the sorted aggregation's) every float sum is taken
// in an order fixed by the segment's length alone, whichever block takes
// which piece, so fsum is bit-identical from run to run (no float
// atomics; integer atomics only hand out list and slot positions). The
// scratch lists are sized for disjoint ranges. Overlapping ranges are
// supported but neither deterministic nor fast: a segment that finds its
// list full is reduced serially by its pass-1 thread, and which segment
// that is depends on the order of the atomics, so its fsum can differ in
// the last bits from run to run.
//
// A row contributes only where live[i] is set (or everywhere when live is
// null). Values: float64 (dtype 0), int64 (1) or int32 (2). Integer sums
// wrap in two's complement like the JAX package's int64 sums; fsum is
// always the float64 sum (the shadow sum the overflow check compares
// against). Min and max follow the JAX package's sorted path: NaN sorts
// last, so a NaN wins only where a segment holds nothing else.
//
// 128-bit sum mode (segment_sum128; the DECIMAL(38) kinds sum128/avg128 of
// presto_tpu/ops/aggregate.py:_eval_agg_sorted :612-631): per segment the
// live count and four int64 sums, one per 32-bit limb lane. The input is
// four limb lanes (DT_LIMBS) or int64/int32 values that each lane
// decomposes into limbs in registers. Limb sums are int64 (2^31 row limbs
// fit without a carry) and recombine exactly on the host, so segment sums
// stay exact past 2^127, where an __int128 accumulator would wrap. Same
// schedule as the default mode; limb partials combine by wrapping add.
//
// Merge mode (segment_merge128; the FINAL kinds sum128_merge/avg128_merge
// of presto_tpu/ops/aggregate.py:556-575, over DECIMAL(38) partial states):
// the 128-bit sum mode over four limb lanes, whose values may be any int64
// (a state's lanes are sums of up to 2^31 row limbs, and a merge over up to
// 2^31 states stays exact), plus, for avg128_merge, the wrapping int64 sum
// of the partial count column under its own live flags, in the same
// launch. The live count is the number of live states: a group with none
// is NULL.
//
// Bound on an H100: memory. Each row's value and live flag are read once
// (9 or 5 B/row; 33 B in the limb mode), each segment's start and end read
// and its results written once. The three launches (a memset of two
// counters, classify, work) cost a few microseconds on a small page.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define SR_THREADS 256
#define SR_WARPS (SR_THREADS / 32)
#define SMALL_MAX 32          // = native.SEGMENT_SMALL_MAX
#define WARP_MAX 1024         // = native.SEGMENT_WARP_MAX
#define PIECE 8192            // = native.SEGMENT_PIECE
#define WORK_BLOCKS (132 * 8)
#define PART_WORDS 7          // int64 words of one slot's partial
#define WANT_SUM 1
#define WANT_MINMAX 2
#define M32 0xFFFFFFFFll
#define FULL 0xffffffffu

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_LIMBS = 3 };

static __device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// NaN-last order: min keeps the smaller non-NaN value
static __device__ __forceinline__ double min_nan_last(double a, double b) {
  if (isnan(b)) return a;
  if (isnan(a)) return b;
  return b < a ? b : a;
}
// for max the NaN also loses unless nothing else is there
static __device__ __forceinline__ double max_nan_last(double a, double b) {
  if (isnan(b)) return a;
  if (isnan(a)) return b;
  return b > a ? b : a;
}

// The default mode: count, sums, min and max of one run of rows.
struct Acc {
  long long c, isum, imn, imx;
  double fsum, fmn, fmx;
};

struct Reduce {
  typedef Acc State;
  const void* values;
  int dtype, want;
  const uint8_t* live;
  int64_t *cnt_out, *isum_out, *min_out, *max_out;
  double* fsum_out;

  __device__ void init(Acc& a) const {
    a.c = a.isum = 0;
    a.imn = LLONG_MAX;
    a.imx = LLONG_MIN;
    a.fsum = 0.0;
    a.fmn = a.fmx = nan("");
  }
  // the value is loaded beside the live flag, not after it, so that the
  // two loads overlap
  __device__ void row(Acc& a, int64_t i) const {
    if (dtype == DT_F64) {
      const double v = ((const double*)values)[i];
      if (live != nullptr && !live[i]) return;
      ++a.c;
      if (want & WANT_SUM) a.fsum += v;
      if (want & WANT_MINMAX) {
        a.fmn = min_nan_last(a.fmn, v);
        a.fmx = max_nan_last(a.fmx, v);
      }
    } else {
      const long long v = dtype == DT_I64 ? ((const long long*)values)[i]
                                          : (long long)((const int*)values)[i];
      if (live != nullptr && !live[i]) return;
      ++a.c;
      if (want & WANT_SUM) {
        a.isum = wrap_add(a.isum, v);
        a.fsum += (double)v;
      }
      if (want & WANT_MINMAX) {
        a.imn = v < a.imn ? v : a.imn;
        a.imx = v > a.imx ? v : a.imx;
      }
    }
  }
  // a, then the rows of b
  __device__ void merge(Acc& a, const Acc& b) const {
    a.c += b.c;
    a.isum = wrap_add(a.isum, b.isum);
    a.fsum += b.fsum;
    a.imn = b.imn < a.imn ? b.imn : a.imn;
    a.imx = b.imx > a.imx ? b.imx : a.imx;
    a.fmn = min_nan_last(a.fmn, b.fmn);
    a.fmx = max_nan_last(a.fmx, b.fmx);
  }
  // one level of the xor tree; float addition commutes, so both lanes of
  // a pair hold the same result
  __device__ void shfl_merge(Acc& a, int o) const {
    Acc b;
    b.c = __shfl_xor_sync(FULL, a.c, o);
    b.isum = __shfl_xor_sync(FULL, a.isum, o);
    b.imn = __shfl_xor_sync(FULL, a.imn, o);
    b.imx = __shfl_xor_sync(FULL, a.imx, o);
    b.fsum = __shfl_xor_sync(FULL, a.fsum, o);
    b.fmn = __shfl_xor_sync(FULL, a.fmn, o);
    b.fmx = __shfl_xor_sync(FULL, a.fmx, o);
    merge(a, b);
  }
  __device__ void store(int64_t g, const Acc& a) const {
    cnt_out[g] = a.c;
    if (want & WANT_SUM) {
      fsum_out[g] = a.fsum;
      if (isum_out != nullptr) isum_out[g] = a.isum;
    }
    if (want & WANT_MINMAX) {
      if (dtype == DT_F64) {
        ((double*)min_out)[g] = a.fmn;
        ((double*)max_out)[g] = a.fmx;
      } else {
        min_out[g] = a.imn;
        max_out[g] = a.imx;
      }
    }
  }
  // a slot's partial: word k of slot j at part[k * cap + j]
  __device__ void save(long long* part, int64_t cap, int64_t j,
                       const Acc& a) const {
    part[j] = a.c;
    part[cap + j] = a.isum;
    part[2 * cap + j] = a.imn;
    part[3 * cap + j] = a.imx;
    part[4 * cap + j] = __double_as_longlong(a.fsum);
    part[5 * cap + j] = __double_as_longlong(a.fmn);
    part[6 * cap + j] = __double_as_longlong(a.fmx);
  }
  // read past L1: other blocks wrote the partials
  __device__ Acc load(const long long* part, int64_t cap, int64_t j) const {
    Acc a;
    a.c = __ldcg(part + j);
    a.isum = __ldcg(part + cap + j);
    a.imn = __ldcg(part + 2 * cap + j);
    a.imx = __ldcg(part + 3 * cap + j);
    a.fsum = __longlong_as_double(__ldcg(part + 4 * cap + j));
    a.fmn = __longlong_as_double(__ldcg(part + 5 * cap + j));
    a.fmx = __longlong_as_double(__ldcg(part + 6 * cap + j));
    return a;
  }
};

// The 128-bit sum mode: count and four wrapping limb sums; the merge mode
// (MERGE) also the count column's sum `cs`.
struct Acc128 {
  long long c, l[4], cs;
};

template <bool MERGE>
struct Reduce128 {
  typedef Acc128 State;
  const int64_t *l3, *l2, *l1, *l0;
  int dtype;
  const uint8_t* live;
  const int64_t* cval;      // MERGE: the partial count column, or null
  const uint8_t* clive;     // MERGE: where a count adds
  int64_t *cnt_out, *lsum_out, *csum_out;
  int64_t nseg;

  __device__ void init(Acc128& a) const {
    a.c = 0;
    a.cs = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) a.l[q] = 0;
  }
  __device__ void row(Acc128& a, int64_t i) const {
    if (MERGE) {
      // every load of the row is issued before any branch on a loaded
      // flag, so that they overlap (a thread takes up to SMALL_MAX rows
      // one after another)
      const long long x3 = l3[i], x2 = l2[i], x1 = l1[i], x0 = l0[i];
      const bool on = live[i];
      if (cval != nullptr) {
        const long long cv = cval[i];
        a.cs = wrap_add(a.cs, clive[i] ? cv : 0);
      }
      if (!on) return;
      ++a.c;
      a.l[0] = wrap_add(a.l[0], x3);
      a.l[1] = wrap_add(a.l[1], x2);
      a.l[2] = wrap_add(a.l[2], x1);
      a.l[3] = wrap_add(a.l[3], x0);
      return;
    }
    if (dtype == DT_LIMBS) {
      const long long x3 = l3[i], x2 = l2[i], x1 = l1[i], x0 = l0[i];
      if (live != nullptr && !live[i]) return;
      ++a.c;
      a.l[0] = wrap_add(a.l[0], x3);
      a.l[1] = wrap_add(a.l[1], x2);
      a.l[2] = wrap_add(a.l[2], x1);
      a.l[3] = wrap_add(a.l[3], x0);
    } else {
      // the limbs of a narrow value, as int128.from_int64
      const long long v = dtype == DT_I64 ? ((const long long*)l3)[i]
                                          : (long long)((const int*)l3)[i];
      if (live != nullptr && !live[i]) return;
      ++a.c;
      const long long sign = v >> 63;
      a.l[0] = wrap_add(a.l[0], sign);
      a.l[1] = wrap_add(a.l[1], sign & M32);
      a.l[2] = wrap_add(a.l[2], (v >> 32) & M32);
      a.l[3] = wrap_add(a.l[3], v & M32);
    }
  }
  __device__ void merge(Acc128& a, const Acc128& b) const {
    a.c += b.c;
#pragma unroll
    for (int q = 0; q < 4; ++q) a.l[q] = wrap_add(a.l[q], b.l[q]);
    if (MERGE) a.cs = wrap_add(a.cs, b.cs);
  }
  __device__ void shfl_merge(Acc128& a, int o) const {
    Acc128 b;
    b.c = __shfl_xor_sync(FULL, a.c, o);
#pragma unroll
    for (int q = 0; q < 4; ++q) b.l[q] = __shfl_xor_sync(FULL, a.l[q], o);
    b.cs = MERGE ? __shfl_xor_sync(FULL, a.cs, o) : 0;
    merge(a, b);
  }
  __device__ void store(int64_t g, const Acc128& a) const {
    cnt_out[g] = a.c;
#pragma unroll
    for (int q = 0; q < 4; ++q) lsum_out[q * nseg + g] = a.l[q];
    if (MERGE && csum_out != nullptr) csum_out[g] = a.cs;
  }
  // words 0..4 of a slot's partial (and 5 in the merge mode)
  __device__ void save(long long* part, int64_t cap, int64_t j,
                       const Acc128& a) const {
    part[j] = a.c;
#pragma unroll
    for (int q = 0; q < 4; ++q) part[(q + 1) * cap + j] = a.l[q];
    if (MERGE) part[5 * cap + j] = a.cs;
  }
  __device__ Acc128 load(const long long* part, int64_t cap,
                         int64_t j) const {
    Acc128 a;
    a.c = __ldcg(part + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) a.l[q] = __ldcg(part + (q + 1) * cap + j);
    a.cs = MERGE ? __ldcg(part + 5 * cap + j) : 0;
    return a;
  }
};

// The scratch lists of one call, carved from the caller's int64 words
// (segment_reduce_scratch_words of them).
struct Lists {
  unsigned long long* counts;   // [0] listed warp segments, [1] slots
  long long* slot;              // [slot_cap] segment << 32 | piece
  long long* part;              // [PART_WORDS, slot_cap] partials
  int* done;                    // [slot_cap] pieces finished, at a run's
                                // first slot
  int* warp_list;               // [warp_cap] segments for a warp
  int64_t slot_cap, warp_cap;
};

// disjoint segments: at most n / (WARP_MAX + 1) long ones, each of at most
// len / PIECE + 1 pieces; at most n / (SMALL_MAX + 1) for a warp
static void list_caps(int64_t n, int64_t nseg, int64_t* slot_cap,
                      int64_t* warp_cap) {
  *slot_cap = n / PIECE + n / (WARP_MAX + 1) + 1;
  *warp_cap = n / (SMALL_MAX + 1) + 1;
  if (*warp_cap > nseg) *warp_cap = nseg;
}

static Lists carve(void* scratch, int64_t n, int64_t nseg) {
  Lists l;
  list_caps(n, nseg, &l.slot_cap, &l.warp_cap);
  long long* w = (long long*)scratch;
  l.counts = (unsigned long long*)w;
  w += 2;
  l.slot = w;
  w += l.slot_cap;
  l.part = w;
  w += PART_WORDS * l.slot_cap;
  l.done = (int*)w;
  w += (l.slot_cap + 1) / 2;
  l.warp_list = (int*)w;
  return l;
}

static __device__ __forceinline__ void clamp_run(const int64_t* starts,
                                                 const int64_t* ends,
                                                 int64_t g, int64_t n,
                                                 int64_t* s, int64_t* e) {
  int64_t a = starts[g], b = ends[g];
  a = a < 0 ? 0 : (a > n ? n : a);
  b = b < a ? a : (b > n ? n : b);
  *s = a;
  *e = b;
}

// The block's state into thread 0: the xor tree in each warp, then warps
// 1.. merged in order. Every thread of the block calls it.
template <class R>
static __device__ void block_reduce(const R& r, typename R::State& a,
                                    typename R::State* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r.shfl_merge(a, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < SR_WARPS; ++w) r.merge(a, sh[w]);
  __syncthreads();   // sh is reused by the next call
}

template <class R>
__global__ void segment_classify_kernel(R r,
                                        const int64_t* __restrict__ starts,
                                        const int64_t* __restrict__ ends,
                                        int64_t nseg, int64_t n, Lists l) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= nseg) return;
  int64_t s, e;
  clamp_run(starts, ends, g, n, &s, &e);
  const int64_t len = e - s;
  if (len > WARP_MAX) {
    const int64_t np = (len + PIECE - 1) / PIECE;
    const int64_t base = (int64_t)atomicAdd(&l.counts[1],
                                            (unsigned long long)np);
    if (base + np <= l.slot_cap) {
      for (int64_t q = 0; q < np; ++q) l.slot[base + q] = (g << 32) | q;
      l.done[base] = 0;
      return;
    }
    for (int64_t j = base; j < l.slot_cap; ++j) l.slot[j] = -1;
  } else if (len > SMALL_MAX) {
    const int64_t k = (int64_t)atomicAdd(&l.counts[0], 1ull);
    if (k < l.warp_cap) {
      l.warp_list[k] = (int)g;
      return;
    }
  }
  typename R::State a;
  r.init(a);
  for (int64_t i = s; i < e; ++i) r.row(a, i);
  r.store(g, a);
}

template <class R>
__global__ void segment_work_kernel(R r, const int64_t* __restrict__ starts,
                                    const int64_t* __restrict__ ends,
                                    int64_t n, Lists l) {
  __shared__ typename R::State sh[SR_WARPS];
  __shared__ int last;
  const int64_t reserved = (int64_t)*(volatile unsigned long long*)&l.counts[1];
  const int64_t n_slots = reserved < l.slot_cap ? reserved : l.slot_cap;
  for (int64_t j = blockIdx.x; j < n_slots; j += gridDim.x) {
    const long long tag = l.slot[j];
    if (tag < 0) continue;
    const int64_t g = tag >> 32, q = tag & M32;
    int64_t s, e;
    clamp_run(starts, ends, g, n, &s, &e);
    const int64_t lo = s + q * PIECE;
    const int64_t hi = lo + PIECE < e ? lo + PIECE : e;
    typename R::State a;
    r.init(a);
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x; i < hi; i += SR_THREADS) r.row(a, i);
    block_reduce(r, a, sh);
    const int64_t np = (e - s + PIECE - 1) / PIECE;
    if (np == 1) {
      if (threadIdx.x == 0) r.store(g, a);
      continue;
    }
    const int64_t first = j - q;
    if (threadIdx.x == 0) {
      r.save(l.part, l.slot_cap, j, a);
      __threadfence();
      last = atomicAdd(&l.done[first], 1) == np - 1;
    }
    __syncthreads();
    if (last) {
      __threadfence();
      typename R::State b;
      r.init(b);
      for (int64_t k = threadIdx.x; k < np; k += SR_THREADS)
        r.merge(b, r.load(l.part, l.slot_cap, first + k));
      block_reduce(r, b, sh);
      if (threadIdx.x == 0) r.store(g, b);
    }
    __syncthreads();   // `last` is rewritten for the next piece
  }
  const int lane = threadIdx.x & 31;
  const int64_t listed = (int64_t)*(volatile unsigned long long*)&l.counts[0];
  const int64_t n_warp = listed < l.warp_cap ? listed : l.warp_cap;
  for (int64_t k = (int64_t)blockIdx.x * SR_WARPS + (threadIdx.x >> 5);
       k < n_warp; k += (int64_t)gridDim.x * SR_WARPS) {
    const int64_t g = l.warp_list[k];
    int64_t s, e;
    clamp_run(starts, ends, g, n, &s, &e);
    typename R::State a;
    r.init(a);
#pragma unroll 4
    for (int64_t i = s + lane; i < e; i += 32) r.row(a, i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r.shfl_merge(a, o);
    if (lane == 0) r.store(g, a);
  }
}

template <class R>
static int run(const R& r, const int64_t* starts, const int64_t* ends,
               int64_t nseg, int64_t n, void* scratch, cudaStream_t s) {
  const Lists l = carve(scratch, n, nseg);
  cudaError_t e = cudaMemsetAsync(l.counts, 0, 2 * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  segment_classify_kernel<R><<<(unsigned)((nseg + SR_THREADS - 1)
                                          / SR_THREADS),
                               SR_THREADS, 0, s>>>(r, starts, ends, nseg, n,
                                                   l);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segment_work_kernel<R><<<WORK_BLOCKS, SR_THREADS, 0, s>>>(r, starts, ends,
                                                           n, l);
  return (int)cudaGetLastError();
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch that a call over n rows and nseg segments takes
// (carve's layout): two counters; per slot its tag, a PART_WORDS partial
// and an int finish counter; the int warp list.
int64_t segment_reduce_scratch_words(int64_t n, int64_t nseg) {
  int64_t slot_cap, warp_cap;
  list_caps(n, nseg, &slot_cap, &warp_cap);
  return 2 + (1 + PART_WORDS) * slot_cap + (slot_cap + 1) / 2
         + (warp_cap + 1) / 2;
}

// want: WANT_SUM | WANT_MINMAX; values: [n] of dtype; live: [n] bool or
// null; starts/ends: [nseg] int64; outputs [nseg]: cnt int64 (always),
// fsum float64 and isum int64 (with WANT_SUM; isum may be null), min/max
// 8-byte words holding float64 for dtype 0 and int64 otherwise (with
// WANT_MINMAX); scratch: segment_reduce_scratch_words(n, nseg) int64.
int segment_reduce(const void* values, int dtype, int want, const void* live,
                   const void* starts, const void* ends, int64_t nseg,
                   int64_t n, void* cnt, void* fsum, void* isum,
                   void* mn, void* mx, void* scratch, void* stream) {
  if (nseg <= 0) return 0;
  if (dtype < DT_F64 || dtype > DT_I32 || nseg > INT_MAX || n < 0)
    return (int)cudaErrorInvalidValue;
  Reduce r;
  r.values = values;
  r.dtype = dtype;
  r.want = want;
  r.live = (const uint8_t*)live;
  r.cnt_out = (int64_t*)cnt;
  r.fsum_out = (double*)fsum;
  r.isum_out = (int64_t*)isum;
  r.min_out = (int64_t*)mn;
  r.max_out = (int64_t*)mx;
  return run(r, (const int64_t*)starts, (const int64_t*)ends, nseg, n,
             scratch, (cudaStream_t)stream);
}

// The 128-bit sum mode. dtype DT_LIMBS: l3..l0 are the four limb lanes;
// DT_I64/DT_I32: l3 holds the values and l2..l0 are unused. live: [n] bool
// or null; outputs: cnt [nseg] int64, lsum [4, nseg] int64 (limb sums
// l3..l0, wrapping); scratch as segment_reduce's.
int segment_sum128(const void* l3, const void* l2, const void* l1,
                   const void* l0, int dtype, const void* live,
                   const void* starts, const void* ends, int64_t nseg,
                   int64_t n, void* cnt, void* lsum, void* scratch,
                   void* stream) {
  if (nseg <= 0) return 0;
  if (dtype < DT_I64 || dtype > DT_LIMBS || nseg > INT_MAX || n < 0)
    return (int)cudaErrorInvalidValue;
  Reduce128<false> r;
  r.l3 = (const int64_t*)l3;
  r.l2 = (const int64_t*)l2;
  r.l1 = (const int64_t*)l1;
  r.l0 = (const int64_t*)l0;
  r.dtype = dtype;
  r.live = (const uint8_t*)live;
  r.cval = nullptr;
  r.clive = nullptr;
  r.cnt_out = (int64_t*)cnt;
  r.lsum_out = (int64_t*)lsum;
  r.csum_out = nullptr;
  r.nseg = nseg;
  return run(r, (const int64_t*)starts, (const int64_t*)ends, nseg, n,
             scratch, (cudaStream_t)stream);
}

// The merge mode. l3..l0: the partial states' limb lanes (any int64);
// live: [n] bool (a state is live where set); cval/clive: the partial
// count column and where its rows add (both null for sum128_merge);
// outputs: cnt [nseg] int64 (live states), lsum [4, nseg] int64, csum
// [nseg] int64 (with cval); scratch as segment_reduce's.
int segment_merge128(const void* l3, const void* l2, const void* l1,
                     const void* l0, const void* live, const void* cval,
                     const void* clive, const void* starts, const void* ends,
                     int64_t nseg, int64_t n, void* cnt, void* lsum,
                     void* csum, void* scratch, void* stream) {
  if (nseg <= 0) return 0;
  if (live == nullptr || (cval == nullptr) != (clive == nullptr)
      || (cval != nullptr && csum == nullptr) || nseg > INT_MAX || n < 0)
    return (int)cudaErrorInvalidValue;
  Reduce128<true> r;
  r.l3 = (const int64_t*)l3;
  r.l2 = (const int64_t*)l2;
  r.l1 = (const int64_t*)l1;
  r.l0 = (const int64_t*)l0;
  r.dtype = DT_LIMBS;
  r.live = (const uint8_t*)live;
  r.cval = (const int64_t*)cval;
  r.clive = (const uint8_t*)clive;
  r.cnt_out = (int64_t*)cnt;
  r.lsum_out = (int64_t*)lsum;
  r.csum_out = (int64_t*)csum;
  r.nseg = nseg;
  return run(r, (const int64_t*)starts, (const int64_t*)ends, nseg, n,
             scratch, (cudaStream_t)stream);
}

}  // extern "C"
