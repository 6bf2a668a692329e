// K5 join_probe and K6 join_expand: the probe and the pair expansion of
// the port's joins (presto_tpu_torch/ops/join.py).
//
// Replace presto_tpu/ops/join.py: merge_join (:45; its co-sort, forward
// fill and inverse permutation), hash_join (:237; its searchsorted probe
// windows, blocked cumsum, pair expansion and key recheck) and
// _window_any_match (:351). The build side comes sorted stably by key
// hash (torch.sort); dead and null-key rows carry negative sentinel
// hashes, so they fall in no live probe's window and the kernels need no
// null checks.
//
// K5 join_probe finds each probe row's window [lo, hi) of equal hashes
// and, by mode, walks it with an exact key recheck (NaN = NaN, float64
// subnormals = 0.0 as in ops/keys.py's values_equal, int32 codes against
// int64):
//   WINDOW  lo and the window count only (the expansion join);
//   FIRST   walk forward, stop at the first key match (semi/anti joins and
//           the merge join's duplicate count);
//   LAST    walk backward, stop at the first key match: the last match in
//           window order, which among duplicates is the build row of
//           highest index, the row the JAX merge join's forward fill
//           picks;
//   ALL     walk the whole window, keep the last match, and store 1 into
//           bflag[row] for every matching build row (FULL joins; plain
//           stores of one value, so no atomics and a repeatable result).
// Design for the H100: a radix directory instead of two binary searches
// over the whole build side (2 log2(B) dependent loads a probe). Live
// hashes are splitmix-mixed and masked to 63 bits, so they spread evenly
// over [0, 2^63); dead and null-key rows carry negative sentinels and sort
// first. One launch writes, for each of 2^k buckets of the top k bits
// (about eight live build rows a bucket, the live rows' share sampled),
// the first sorted position at or past the bucket, 2^k + 1 entries in all
// (join_probe_scratch_words); the probe kernel, launched behind it as a
// programmatic dependent launch, waits for it on the card. A probe reads
// its bucket's two entries, walks forward four rows at a time to lo and on
// to the window's end (one row without collisions), and binary-searches
// the rest of the bucket once a walk passes DIR_WALK rows; a bucket past
// DIR_WALK rows is first checked at its last and first rows, so one huge
// window (or a build side of equal hashes) costs four dependent loads,
// and is otherwise binary-searched for lo without a walk (a build side of
// a few live rows is one such bucket). A negative
// probe hash finds its lo among the sentinels ahead of entry 0, by one
// load where every build sentinel lies below it.
// Bound on an H100: memory. Each probe row reads its hash (8 B) and key
// lanes and writes 16-24 B; the directory pass reads the build hashes
// once. Without hash collisions a FIRST or LAST walk stops at its first
// slot.
//
// K6 join_expand: given per probe row its pair count (the window count,
// or at least 1 for a live row of a LEFT join), lays out the pairs in
// (probe row, sorted build position) order and writes for every pair slot
// below out_capacity the probe row, the build row and whether it is a real
// candidate whose keys equal the probe's. Replaces the expansion of
// presto_tpu/ops/join.py:hash_join: blocked_cumsum (:305-307), then the
// searchsorted, the gathers and the key recheck (:309-320). Two launches
// laid out by merge path (merge_path.cuh, shared with K11), after a memset
// of the ticket and tile status words:
//   1. counts: each count read once (16-byte loads where aligned); cum,
//      the total (unclamped: the executor watches it for an overflow) and
//      the slot blocks' partition, with a decoupled look-back;
//   2. slots, a programmatic dependent launch: a block stages its rows'
//      ends, finds each slot's row and offset k by the merge in shared
//      memory, then takes JE_PAIRS pairs of slots a thread: each slot's
//      window count and start (its row's; neighbouring slots share them),
//      then every sorted position's build row, order[lo + k] (contiguous
//      within a window), before any key gather; the key lanes are gathered
//      lane by lane across the thread's slots, one switch on the dtypes a
//      lane; the probe row, build row and flag are stored two slots at a
//      time (16- and 2-byte stores), dead slots past the total included.
// One probe row of 2^20 pairs, or a probe side whose rows nearly all own
// no pair, gives every block the same number of merged items. Prefix sums
// are int64: pair counts reach 2**26 and beyond before the executor's
// retry sees them.
// Bound on an H100: memory. Each probe row's count, window count and
// window start are read once (24 B) with its key (8 B a lane); per real
// pair its sorted position's build row and that row's key (16 B); each
// pair slot writes 17 B. The kernel also writes and reads cum (16 B a
// row). Where the build side is not in key order each pair's key gather
// takes a 32 B sector of its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "merge_path.cuh"

#define MAX_LANES 16        // = ops/keys.MAX_KEY_LANES
#define PROBE_THREADS 256
#define MAX_BLOCKS (132 * 64)             // grid-stride beyond this
#define JE_PAIRS 2          // pairs of slots a thread of K6's slot pass
#define DIR_MAX_BITS 20                   // at most 2^20 directory buckets
#define DIR_ROWS_LOG2 3   // about 2^3 build rows (of the capacity) a bucket
#define DIR_THREADS 512
#define DIR_ITEMS 8       // sorted positions a thread of the directory pass
#define DIR_SHORT 32      // a thread fills at most this many buckets itself
#define DIR_WALK 32       // rows walked before a bucket's binary search
#define DIR_SAMPLES 64    // sorted positions sampled for the live rows' share

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_BOOL = 3, DT_F32 = 4 };
enum { MODE_WINDOW = 0, MODE_FIRST = 1, MODE_LAST = 2, MODE_ALL = 3 };

// the smallest normal float64; smaller magnitudes compare as zero
#define F64_MIN_NORMAL 2.2250738585072014e-308

struct KeyLanes {
  const void* probe[MAX_LANES];
  const void* build[MAX_LANES];
  int pdt[MAX_LANES];
  int bdt[MAX_LANES];
  int count;
};

static __device__ __forceinline__ bool is_float(int dt) {
  return dt == DT_F64 || dt == DT_F32;
}

static __device__ __forceinline__ int64_t load_int(const void* v, int dt,
                                                   int64_t i) {
  switch (dt) {
    case DT_I64: return ((const int64_t*)v)[i];
    case DT_I32: return ((const int32_t*)v)[i];
    default: return ((const uint8_t*)v)[i] ? 1 : 0;
  }
}

static __device__ __forceinline__ double load_f64(const void* v, int dt,
                                                  int64_t i) {
  double x;
  if (dt == DT_F64) x = ((const double*)v)[i];
  else if (dt == DT_F32) x = (double)((const float*)v)[i];
  else return (double)load_int(v, dt, i);
  return fabs(x) < F64_MIN_NORMAL ? 0.0 : x;
}

// values_equal over every key lane: probe row pi against build row bi
static __device__ bool keys_equal(const KeyLanes& k, int64_t pi,
                                  int64_t bi) {
  for (int l = 0; l < k.count; ++l) {
    if (is_float(k.pdt[l]) || is_float(k.bdt[l])) {
      const double a = load_f64(k.probe[l], k.pdt[l], pi);
      const double b = load_f64(k.build[l], k.bdt[l], bi);
      if (!(a == b || (a != a && b != b))) return false;
    } else if (load_int(k.probe[l], k.pdt[l], pi)
               != load_int(k.build[l], k.bdt[l], bi)) {
      return false;
    }
  }
  return true;
}

static __device__ __forceinline__ int64_t bucket_of(int64_t h, int shift) {
  return h < 0 ? -1 : h >> shift;
}

// the floor of log2(x), for x >= 1
static __device__ __forceinline__ int floor_log2(int64_t x) {
  return 63 - __clzll(x);
}

// The directory, in scratch: word 0 its bits k, then dir[b] = the first
// sorted position whose hash is at or past bucket b's first hash (b < 2^k),
// dir[2^k] = nb. k follows the live rows, about eight a bucket, up to
// max_bits (the scratch's size): every block counts the live ones (non-
// negative hashes sort last) among DIR_SAMPLES evenly spaced positions, so
// a build side with few live rows among many dead ones (a filtered page)
// gets a small directory, one bucket where no sample is live, and the
// positions up to the last dead sample are not read. Position p (0 <= p <
// nb) writes the buckets after its predecessor's up to its own; a thread
// takes DIR_ITEMS consecutive positions, so one wave of blocks covers a
// build side of millions of rows. The buckets past the last row's take nb,
// written by every block in turn; a build side with no live row (its last
// hash negative) is read no further. A gap of more than DIR_SHORT buckets
// inside the rows (a sparse or skewed build side) is filled by the whole
// block, one gap a thread on the list (a thread fills any further ones
// itself).
__global__ void probe_dir_kernel(const int64_t* __restrict__ bh, int64_t nb,
                                 int max_bits,
                                 int64_t* __restrict__ scratch) {
  __shared__ int64_t gap_first[DIR_THREADS], gap_last[DIR_THREADS],
      gap_pos[DIR_THREADS];
  __shared__ int gaps;
  if (threadIdx.x == 0) gaps = 0;
  bool live = false;
  if (threadIdx.x < DIR_SAMPLES && nb > 0)
    live = bh[(threadIdx.x + 1) * nb / (DIR_SAMPLES + 1)] >= 0;
  const int sampled = __syncthreads_count(live);
  // at most about (sampled + 1) / (DIR_SAMPLES + 1) of the rows are live;
  // with no live sample (a page of a few live rows) one bucket holds
  // them all, so the pass writes two entries and the probe searches that
  // bucket alone
  const int64_t est = (sampled + 1) * nb / (DIR_SAMPLES + 1);
  int bits = sampled == 0 ? 0 : floor_log2(est > 1 ? est : 1) - DIR_ROWS_LOG2;
  bits = bits < 0 ? 0 : (bits > max_bits ? max_bits : bits);
  if (blockIdx.x == 0 && threadIdx.x == 0) scratch[0] = bits;
  int64_t* __restrict__ dir = scratch + 1;
  const int shift = 63 - bits;
  const int64_t nbk = (int64_t)1 << bits;
  const int64_t tail = nb > 0 ? bucket_of(bh[nb - 1], shift) + 1 : 0;
  for (int64_t b = tail + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       b <= nbk; b += (int64_t)gridDim.x * blockDim.x)
    dir[b] = nb;
  // every position up to the last dead sample is dead: no bucket starts
  // there, so those positions are not read
  const int64_t dead_to = (DIR_SAMPLES - sampled) * nb / (DIR_SAMPLES + 1);
  const int64_t p0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * DIR_ITEMS;
  if (p0 < nb && tail > 0 && p0 + DIR_ITEMS > dead_to) {
    int64_t h[DIR_ITEMS];
    if (p0 + DIR_ITEMS <= nb && (((uintptr_t)(bh + p0)) & 15) == 0) {
#pragma unroll
      for (int q = 0; q < DIR_ITEMS / 2; ++q) {
        const longlong2 v = ((const longlong2*)(bh + p0))[q];
        h[2 * q] = v.x;
        h[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < DIR_ITEMS; ++q)
        h[q] = p0 + q < nb ? bh[p0 + q] : 0;
    }
    int64_t prev = p0 > 0 ? bucket_of(bh[p0 - 1], shift) : -1;
    bool listed = false;
#pragma unroll
    for (int q = 0; q < DIR_ITEMS; ++q) {
      const int64_t p = p0 + q;
      if (p >= nb) break;
      const int64_t cur = bucket_of(h[q], shift);
      if (cur - prev > DIR_SHORT && !listed) {
        listed = true;
        const int g = atomicAdd(&gaps, 1);
        gap_first[g] = prev + 1;
        gap_last[g] = cur;
        gap_pos[g] = p;
      } else {
        for (int64_t b = prev + 1; b <= cur; ++b) dir[b] = p;
      }
      prev = cur;
    }
  }
  __syncthreads();
  for (int g = 0; g < gaps; ++g)        // long gaps: the block's threads
    for (int64_t b = gap_first[g] + threadIdx.x; b <= gap_last[g];
         b += blockDim.x)
      dir[b] = gap_pos[g];
}

// the first position in [a, end) whose hash is not below h (upper: not
// at or below h), walking up to `walk` rows four at a time from a, then
// by binary search
static __device__ __forceinline__ int64_t bucket_bound(
    const int64_t* __restrict__ bh, int64_t a, int64_t end, int64_t h,
    bool upper, int walk) {
  const int64_t stop = end - a < walk ? end : a + walk;
  while (a + 4 <= stop) {
    int64_t x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = bh[a + q];
    int below = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      below += (below == q) & (upper ? x[q] <= h : x[q] < h);
    a += below;
    if (below < 4) return a;
  }
  while (a < stop && (upper ? bh[a] <= h : bh[a] < h)) ++a;
  if (a < stop || a == end) return a;
  int64_t b = end;
  while (a < b) {
    const int64_t m = (a + b) >> 1;
    if (upper ? bh[m] <= h : bh[m] < h) a = m + 1; else b = m;
  }
  return a;
}

__global__ void join_probe_kernel(const int64_t* __restrict__ ph, int64_t n,
                                  const int64_t* __restrict__ bh,
                                  const int64_t* __restrict__ order,
                                  int64_t nb,
                                  const int64_t* __restrict__ scratch,
                                  KeyLanes keys, int mode,
                                  int64_t* __restrict__ lo_out,
                                  int64_t* __restrict__ cnt_out,
                                  int64_t* __restrict__ hit_out,
                                  uint8_t* __restrict__ bflag) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // launched while the directory pass may still run: wait for it
  wait_for_prior_grid();
  const int shift = 63 - (int)scratch[0];
  const int64_t* __restrict__ dir = scratch + 1;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t h = ph[i];
    int64_t lo, cnt = 0;
    if (h < 0) {
      // dead or null key: lo among the sentinels ahead of dir[0]
      int64_t a = 0, b = dir[0];
      if (b > 0 && bh[b - 1] < h) a = b;
      while (a < b) {                    // first position with bh >= h
        const int64_t m = (a + b) >> 1;
        if (bh[m] < h) a = m + 1; else b = m;
      }
      lo = a;
    } else {
      const int64_t bk = h >> shift;
      const int64_t first = dir[bk], end = dir[bk + 1];
      // a bucket past DIR_WALK rows is checked at its ends first (one hash
      // may fill it, a huge window, or the probe's may lie before or past
      // them all), then binary-searched for lo without a walk
      const bool big = end - first > DIR_WALK;
      if (big && bh[end - 1] < h) {
        lo = end;
      } else {
        lo = big && bh[first] >= h
                 ? first
                 : bucket_bound(bh, first, end, h, false, big ? 0 : DIR_WALK);
        if (lo < end && bh[lo] == h)
          cnt = (big && bh[end - 1] == h
                     ? end
                     : bucket_bound(bh, lo + 1, end, h, true, DIR_WALK)) - lo;
      }
    }
    lo_out[i] = lo;
    cnt_out[i] = cnt;
    if (mode == MODE_WINDOW) continue;
    int64_t hit = -1;
    if (mode == MODE_FIRST) {
      for (int64_t p = lo; p < lo + cnt; ++p) {
        const int64_t r = order[p];
        if (keys_equal(keys, i, r)) { hit = r; break; }
      }
    } else if (mode == MODE_LAST) {
      for (int64_t p = lo + cnt - 1; p >= lo; --p) {
        const int64_t r = order[p];
        if (keys_equal(keys, i, r)) { hit = r; break; }
      }
    } else {
      for (int64_t p = lo; p < lo + cnt; ++p) {
        const int64_t r = order[p];
        if (keys_equal(keys, i, r)) { hit = r; bflag[r] = 1; }
      }
    }
    hit_out[i] = hit;
  }
}

// key lane v (dtype dt) at rows idx[0 .. S-1], the loads together
template <int S>
static __device__ __forceinline__ void lane_int(const void* v, int dt,
                                                const int64_t (&idx)[S],
                                                int64_t (&x)[S]) {
  if (dt == DT_I64) {
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = __ldg((const int64_t*)v + idx[s]);
  } else if (dt == DT_I32) {
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = __ldg((const int32_t*)v + idx[s]);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
      x[s] = __ldg((const uint8_t*)v + idx[s]) ? 1 : 0;
  }
}

template <int S>
static __device__ __forceinline__ void lane_f64(const void* v, int dt,
                                                const int64_t (&idx)[S],
                                                double (&x)[S]) {
  if (dt == DT_F64) {
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = __ldg((const double*)v + idx[s]);
  } else if (dt == DT_F32) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      x[s] = (double)__ldg((const float*)v + idx[s]);
  } else {
    int64_t y[S];
    lane_int(v, dt, idx, y);
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = (double)y[s];
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (fabs(x[s]) < F64_MIN_NORMAL) x[s] = 0.0;
}

// K6 1. each row's pair count read once; cum, the total and the slot
// blocks' partition (merge_path.cuh)
__global__ void __launch_bounds__(MP_THREADS) expand_count_kernel(
    const int64_t* __restrict__ counts, int64_t n, int aligned,
    unsigned* tickets, unsigned long long* status,
    int64_t* __restrict__ part, int64_t nparts, int64_t out_cap,
    int64_t* __restrict__ cum, int64_t* total, unsigned tiles) {
  const unsigned t = take_tile(tickets);
  const int64_t r0 = (int64_t)t * MP_TILE + (int64_t)threadIdx.x * MP_ITEMS;
  int64_t m[MP_ITEMS];
  if (aligned && r0 + MP_ITEMS <= n) {
#pragma unroll
    for (int q = 0; q < MP_ITEMS / 2; ++q) {
      const longlong2 v = __ldg((const longlong2*)(counts + r0) + q);
      m[2 * q] = v.x;
      m[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < MP_ITEMS; ++k)
      m[k] = r0 + k < n ? __ldg(counts + r0 + k) : 0;
  }
  publish_tile(m, t, tiles, n, out_cap, status, part, nparts, cum, total);
}

// K6 2. one block a slice of MP_TILE merged items (rows and pair slots)
__global__ void __launch_bounds__(MP_THREADS) expand_slots_kernel(
    const int64_t* __restrict__ cum, const int64_t* __restrict__ part,
    const int64_t* __restrict__ wcnt, const int64_t* __restrict__ lo,
    int64_t n, const int64_t* __restrict__ order, int64_t nb, KeyLanes keys,
    int64_t out_cap, int64_t* __restrict__ pidx,
    int64_t* __restrict__ bidx, uint8_t* __restrict__ bvalid, int vec) {
  __shared__ int64_t s_cum[MP_TILE + 1];   // [0]: the end before row a0
  __shared__ int16_t s_row[MP_TILE];       // each slot's row, less a0
  const int tid = threadIdx.x;
  wait_for_prior_grid();                 // cum and the partition
  const SlotBlock sb = slot_block(part, n, out_cap);
  const int64_t a0 = sb.a0, b0 = sb.b0;
  if (tid == 0) s_cum[0] = a0 > 0 ? __ldg(cum + a0 - 1) : 0;
  for (int x = tid; x < sb.na; x += MP_THREADS)
    s_cum[1 + x] = __ldg(cum + a0 + x);
  __syncthreads();
  merge_slots(s_cum, sb, [&](int bi, int ai) { s_row[bi] = (int16_t)ai; });
  __syncthreads();
  // slots j = j00 + q * 2 * MP_THREADS + h (pair q, slot h of the pair):
  // neighbouring threads hold neighbouring pairs
  constexpr int S = 2 * JE_PAIRS;
  const int64_t bend = b0 + sb.nb;
  for (int64_t j00 = (b0 & ~1LL) + 2 * tid; j00 < bend;
       j00 += 2 * MP_THREADS * JE_PAIRS) {
    int64_t p[S], r[S];
    bool in[S], live[S], eq[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int64_t j = j00 + (s >> 1) * (2 * MP_THREADS) + (s & 1);
      in[s] = j >= b0 && j < bend;
      const int ai = in[s] ? s_row[j - b0] : 0;
      p[s] = a0 + ai;
      live[s] = in[s] && p[s] < n;       // slots past the total are dead
      const int64_t k = j - s_cum[ai];   // the slot's offset in its row
      // its row's window count and start (row 0 for a dead slot, read
      // only where there are rows); a candidate of the window or not
      const int64_t pl = live[s] ? p[s] : 0;
      eq[s] = live[s] && k < (n > 0 ? __ldg(wcnt + pl) : 0) && nb > 0;
      const int64_t pos = (n > 0 ? __ldg(lo + pl) : 0) + k;
      r[s] = pos < 0 ? 0 : (pos >= nb ? nb - 1 : pos);
    }
    if (nb > 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) r[s] = __ldg(order + r[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) r[s] = live[s] && nb > 0 ? r[s] : 0;
    // the key lanes of the candidates: per lane one switch on the dtypes,
    // then the thread's S loads together (the others read row 0, which
    // exists on both sides once one slot is a candidate)
    bool any = false;
#pragma unroll
    for (int s = 0; s < S; ++s) any |= eq[s];
    for (int l = 0; any && l < keys.count; ++l) {
      int64_t pi[S], bi[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        pi[s] = eq[s] ? p[s] : 0;
        bi[s] = eq[s] ? r[s] : 0;
      }
      if (is_float(keys.pdt[l]) || is_float(keys.bdt[l])) {
        double a[S], b[S];
        lane_f64(keys.probe[l], keys.pdt[l], pi, a);
        lane_f64(keys.build[l], keys.bdt[l], bi, b);
#pragma unroll
        for (int s = 0; s < S; ++s)
          eq[s] = eq[s] && (a[s] == b[s] || (a[s] != a[s] && b[s] != b[s]));
      } else {
        int64_t a[S], b[S];
        lane_int(keys.probe[l], keys.pdt[l], pi, a);
        lane_int(keys.build[l], keys.bdt[l], bi, b);
#pragma unroll
        for (int s = 0; s < S; ++s) eq[s] = eq[s] && a[s] == b[s];
      }
    }
#pragma unroll
    for (int q = 0; q < JE_PAIRS; ++q) {
      const int s = 2 * q;
      const int64_t j0 = j00 + q * (2 * MP_THREADS);
      const int64_t p0 = live[s] ? p[s] : 0, p1 = live[s + 1] ? p[s + 1] : 0;
      if (vec && in[s] && in[s + 1]) {
        *(longlong2*)(pidx + j0) = make_longlong2(p0, p1);
        *(longlong2*)(bidx + j0) = make_longlong2(r[s], r[s + 1]);
        *(uint16_t*)(bvalid + j0) =
            (uint16_t)((eq[s] ? 1u : 0u) | (eq[s + 1] ? 0x100u : 0u));
      } else {
        if (in[s]) {
          pidx[j0] = p0;
          bidx[j0] = r[s];
          bvalid[j0] = eq[s] ? 1 : 0;
        }
        if (in[s + 1]) {
          pidx[j0 + 1] = p1;
          bidx[j0 + 1] = r[s + 1];
          bvalid[j0 + 1] = eq[s + 1] ? 1 : 0;
        }
      }
    }
  }
}

static int fill_lanes(KeyLanes* k, const void* const* probe,
                      const int* pdt, const void* const* build,
                      const int* bdt, int count) {
  if (count < 0 || count > MAX_LANES) return 0;
  for (int l = 0; l < count; ++l) {
    if (pdt[l] < DT_F64 || pdt[l] > DT_F32 || bdt[l] < DT_F64
        || bdt[l] > DT_F32)
      return 0;
    k->probe[l] = probe[l];
    k->build[l] = build[l];
    k->pdt[l] = pdt[l];
    k->bdt[l] = bdt[l];
  }
  k->count = count;
  return 1;
}

// the directory's most bits for a build side of nb rows:
// floor(log2(nb)) - DIR_ROWS_LOG2
static int dir_bits(int64_t nb) {
  int k = 0;
  while (k < 62 && ((int64_t)2 << k) <= nb) ++k;
  k -= DIR_ROWS_LOG2;
  return k < 0 ? 0 : (k > DIR_MAX_BITS ? DIR_MAX_BITS : k);
}

static unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch join_probe takes for a build side of nb rows:
// the directory's bits and its 2^k + 1 entries, k at most dir_bits(nb)
int64_t join_probe_scratch_words(int64_t nb) {
  return ((int64_t)1 << dir_bits(nb < 0 ? 0 : nb)) + 2;
}

// ph: [n] probe hashes; bh: [nb] sorted build hashes; order: [nb] build row
// per sorted position; probe/build: host arrays of `count` device pointers
// to key lanes with dtype codes pdt/bdt; lo, cnt: [n] int64 out; hit: [n]
// int64 out (unused in WINDOW mode); bflag: [nb] uint8, zeroed by the
// caller (ALL mode only); scratch: join_probe_scratch_words(nb) int64.
int join_probe(const void* ph, int64_t n, const void* bh, const void* order,
               int64_t nb, const void* const* probe, const int* pdt,
               const void* const* build, const int* bdt, int count,
               int mode, void* lo, void* cnt, void* hit, void* bflag,
               void* scratch, void* stream) {
  KeyLanes keys;
  if (!fill_lanes(&keys, probe, pdt, build, bdt, count)
      || mode < MODE_WINDOW || mode > MODE_ALL || nb < 0
      || (mode != MODE_WINDOW && hit == nullptr)
      || (mode == MODE_ALL && nb > 0 && bflag == nullptr)
      || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t per_block = (int64_t)DIR_THREADS * DIR_ITEMS;
  probe_dir_kernel<<<(unsigned)((nb + per_block - 1) / per_block + 1),
                     DIR_THREADS, 0, s>>>((const int64_t*)bh, nb,
                                          dir_bits(nb), (int64_t*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // a programmatic dependent launch: the probe kernel is launched while
  // the directory pass runs, and waits for it on the card, so the second
  // launch's latency is not added to the first's
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_for(n, PROBE_THREADS));
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, join_probe_kernel, (const int64_t*)ph, n, (const int64_t*)bh,
      (const int64_t*)order, nb, (const int64_t*)scratch, keys, mode,
      (int64_t*)lo, (int64_t*)cnt, (int64_t*)hit, (uint8_t*)bflag);
}

// int64 words of scratch join_expand takes for n probe rows and out_cap
// pair slots (merge_path.cuh's layout)
int64_t join_expand_scratch_words(int64_t n, int64_t out_cap) {
  return merge_layout(n < 0 ? 0 : n, out_cap < 0 ? 0 : out_cap).words;
}

// counts, wcnt, lo: [n] int64 (pair counts, window counts, window starts);
// order: [nb]; key lanes as for join_probe; scratch:
// join_expand_scratch_words(n, out_cap) int64 words; total: device int64
// scalar out; pidx, bidx: [out_cap] int64 out; bvalid: [out_cap] uint8 out.
int join_expand(const void* counts, const void* wcnt, const void* lo,
                int64_t n, const void* order, int64_t nb,
                const void* const* probe, const int* pdt,
                const void* const* build, const int* bdt, int count,
                int64_t out_cap, void* scratch, void* total, void* pidx,
                void* bidx, void* bvalid, void* stream) {
  KeyLanes keys;
  if (!fill_lanes(&keys, probe, pdt, build, bdt, count) || n < 0 || nb < 0
      || out_cap < 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const MergeLayout l = merge_layout(n, out_cap);
  if (l.tiles > 0x7fffffffLL || l.nparts > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int64_t* w = (int64_t*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (n == 0) {
    e = cudaMemsetAsync(total, 0, sizeof(int64_t), s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(w + l.part, 0, (size_t)(l.nparts + 1) * 8, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    e = cudaMemsetAsync(w + l.tickets, 0, (size_t)(1 + l.tiles) * 8, s);
    if (e != cudaSuccess) return (int)e;
    expand_count_kernel<<<(unsigned)l.tiles, MP_THREADS, 0, s>>>(
        (const int64_t*)counts, n, ((uintptr_t)counts & 15) == 0,
        (unsigned*)(w + l.tickets), (unsigned long long*)(w + l.status),
        w + l.part, l.nparts, out_cap, w + l.cum, (int64_t*)total,
        (unsigned)l.tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (out_cap == 0) return 0;
  // 16-byte stores of the row lanes and 2-byte stores of the flags where
  // the lanes start aligned
  const int vec = !(((uintptr_t)pidx | (uintptr_t)bidx) & 15)
                  && !((uintptr_t)bvalid & 1);
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
  cfg.numAttrs = n > 0 ? 1 : 0;         // no count pass: a plain launch
  return (int)cudaLaunchKernelEx(
      &cfg, expand_slots_kernel, (const int64_t*)(w + l.cum),
      (const int64_t*)(w + l.part), (const int64_t*)wcnt,
      (const int64_t*)lo, n, (const int64_t*)order, nb, keys, out_cap,
      (int64_t*)pidx, (int64_t*)bidx, (uint8_t*)bvalid, vec);
}

}  // extern "C"
