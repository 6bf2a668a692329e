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
// (probe row, sorted build position) order. Four launches: per-tile sums
// of the counts, a one-block scan of the tile sums (which writes the
// total), per-row inclusive prefix sums, then one thread per pair slot
// below out_capacity, which binary-searches the prefix sums for its probe
// row and writes the probe row, the build row and whether it is a real
// candidate whose keys equal the probe's. Prefix sums are int64: pair
// counts reach 2**26 and beyond before the executor's retry sees them.
// Bound on an H100: memory. Counts are read twice and the prefix sums
// written and read once (8 B/row each); each pair slot writes 17 B.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_scan.cuh"

#define MAX_LANES 16        // = ops/keys.MAX_KEY_LANES
#define PROBE_THREADS 256
#define JE_THREADS 256
#define JE_ITEMS 8
#define JE_TILE (JE_THREADS * JE_ITEMS)   // = ops/join.EXPAND_TILE
#define SCAN_THREADS 1024
#define MAX_BLOCKS (132 * 64)             // grid-stride beyond this
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

// waits until the grid this one was launched behind (a programmatic
// dependent launch) has finished and its writes are visible; PTX
// griddepcontrol, sm_90
static __device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
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

// 1. per tile: the sum of its pair counts
__global__ void expand_count_kernel(const int64_t* __restrict__ counts,
                                    int64_t n,
                                    int64_t* __restrict__ tile_sums) {
  const int64_t base = (int64_t)blockIdx.x * JE_TILE
                       + (int64_t)threadIdx.x * JE_ITEMS;
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < JE_ITEMS; ++k) {
    const int64_t i = base + k;
    if (i < n) c += counts[i];
  }
  int64_t total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// 2. one block: tile sums (in) -> exclusive tile offsets (out), *total
__global__ void expand_scan_kernel(int64_t* __restrict__ tile_sums,
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

// 3. per tile: inclusive prefix sums of the counts
__global__ void expand_cum_kernel(const int64_t* __restrict__ counts,
                                  int64_t n,
                                  const int64_t* __restrict__ tile_offsets,
                                  int64_t* __restrict__ cum) {
  const int64_t base = (int64_t)blockIdx.x * JE_TILE
                       + (int64_t)threadIdx.x * JE_ITEMS;
  int64_t c[JE_ITEMS];
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < JE_ITEMS; ++k) {
    const int64_t i = base + k;
    c[k] = i < n ? counts[i] : 0;
    s += c[k];
  }
  int64_t tile_total;
  int64_t run = tile_offsets[blockIdx.x]
                + block_exclusive_scan(s, &tile_total);
#pragma unroll
  for (int k = 0; k < JE_ITEMS; ++k) {
    const int64_t i = base + k;
    run += c[k];
    if (i < n) cum[i] = run;
  }
}

// 4. one thread per pair slot
__global__ void expand_pairs_kernel(const int64_t* __restrict__ cum,
                                    const int64_t* __restrict__ counts,
                                    const int64_t* __restrict__ wcnt,
                                    const int64_t* __restrict__ lo,
                                    int64_t n,
                                    const int64_t* __restrict__ order,
                                    int64_t nb, KeyLanes keys,
                                    int64_t out_cap, const int64_t* total,
                                    int64_t* __restrict__ pidx,
                                    int64_t* __restrict__ bidx,
                                    uint8_t* __restrict__ bvalid) {
  const int64_t t = *total;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < out_cap; j += stride) {
    if (j >= t) {
      pidx[j] = 0;
      bidx[j] = 0;
      bvalid[j] = 0;
      continue;
    }
    int64_t a = 0, b = n;
    while (a < b) {                      // first row with cum > j
      const int64_t m = (a + b) >> 1;
      if (cum[m] <= j) a = m + 1; else b = m;
    }
    const int64_t p = a;
    const int64_t k = j - (cum[p] - counts[p]);
    const bool real = k < wcnt[p];
    int64_t pos = lo[p] + k;
    pos = pos < 0 ? 0 : (pos >= nb ? nb - 1 : pos);
    const int64_t r = nb > 0 ? order[pos] : 0;
    pidx[j] = p;
    bidx[j] = r;
    bvalid[j] = (real && keys_equal(keys, p, r)) ? 1 : 0;
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

// counts, wcnt, lo: [n] int64 (pair counts, window counts, window starts);
// order: [nb]; key lanes as for join_probe; cum: [n] int64 scratch;
// tiles: [max(ceil(n / JE_TILE), 1)] int64 scratch; total: device int64
// scalar out; pidx, bidx: [out_cap] int64 out; bvalid: [out_cap] uint8 out.
int join_expand(const void* counts, const void* wcnt, const void* lo,
                int64_t n, const void* order, int64_t nb,
                const void* const* probe, const int* pdt,
                const void* const* build, const int* bdt, int count,
                int64_t out_cap, void* cum, void* tiles, void* total,
                void* pidx, void* bidx, void* bvalid, void* stream) {
  KeyLanes keys;
  if (!fill_lanes(&keys, probe, pdt, build, bdt, count))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (n <= 0) {
    e = cudaMemsetAsync(total, 0, sizeof(int64_t), s);
    if (e != cudaSuccess) return (int)e;
  } else {
    const int64_t ntiles = (n + JE_TILE - 1) / JE_TILE;
    if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    expand_count_kernel<<<(unsigned)ntiles, JE_THREADS, 0, s>>>(
        (const int64_t*)counts, n, (int64_t*)tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    expand_scan_kernel<<<1, SCAN_THREADS, 0, s>>>((int64_t*)tiles, ntiles,
                                                  (int64_t*)total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    expand_cum_kernel<<<(unsigned)ntiles, JE_THREADS, 0, s>>>(
        (const int64_t*)counts, n, (const int64_t*)tiles, (int64_t*)cum);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (out_cap <= 0) return 0;
  expand_pairs_kernel<<<grid_for(out_cap, JE_THREADS), JE_THREADS, 0, s>>>(
      (const int64_t*)cum, (const int64_t*)counts, (const int64_t*)wcnt,
      (const int64_t*)lo, n, (const int64_t*)order, nb, keys, out_cap,
      (const int64_t*)total, (int64_t*)pidx, (int64_t*)bidx,
      (uint8_t*)bvalid);
  return (int)cudaGetLastError();
}

}  // extern "C"
