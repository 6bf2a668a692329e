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
// K5 join_probe: one thread per probe row (grid-stride) binary-searches
// its window [lo, hi) of equal hashes and, by mode, walks it with an exact
// key recheck (NaN = NaN, float64 subnormals = 0.0 as in ops/keys.py's
// values_equal, int32 codes against int64):
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
// Bound on an H100: memory. Each probe row reads its hash (8 B) and key
// lanes and writes 16-24 B; the binary search reads log2(B) hashes, most
// of them from L2 (a 2M-row build side's hashes are 16 MB). Without hash
// collisions a FIRST or LAST walk stops at its first slot.
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

__global__ void join_probe_kernel(const int64_t* __restrict__ ph, int64_t n,
                                  const int64_t* __restrict__ bh,
                                  const int64_t* __restrict__ order,
                                  int64_t nb, KeyLanes keys, int mode,
                                  int64_t* __restrict__ lo_out,
                                  int64_t* __restrict__ cnt_out,
                                  int64_t* __restrict__ hit_out,
                                  uint8_t* __restrict__ bflag) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t h = ph[i];
    int64_t a = 0, b = nb;
    while (a < b) {                      // first position with bh >= h
      const int64_t m = (a + b) >> 1;
      if (bh[m] < h) a = m + 1; else b = m;
    }
    const int64_t lo = a;
    b = nb;
    while (a < b) {                      // first position with bh > h
      const int64_t m = (a + b) >> 1;
      if (bh[m] <= h) a = m + 1; else b = m;
    }
    const int64_t cnt = h >= 0 ? a - lo : 0;
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

static unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ph: [n] probe hashes; bh: [nb] sorted build hashes; order: [nb] build row
// per sorted position; probe/build: host arrays of `count` device pointers
// to key lanes with dtype codes pdt/bdt; lo, cnt: [n] int64 out; hit: [n]
// int64 out (unused in WINDOW mode); bflag: [nb] uint8, zeroed by the
// caller (ALL mode only).
int join_probe(const void* ph, int64_t n, const void* bh, const void* order,
               int64_t nb, const void* const* probe, const int* pdt,
               const void* const* build, const int* bdt, int count,
               int mode, void* lo, void* cnt, void* hit, void* bflag,
               void* stream) {
  KeyLanes keys;
  if (!fill_lanes(&keys, probe, pdt, build, bdt, count)
      || mode < MODE_WINDOW || mode > MODE_ALL
      || (mode != MODE_WINDOW && hit == nullptr)
      || (mode == MODE_ALL && bflag == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  join_probe_kernel<<<grid_for(n, PROBE_THREADS), PROBE_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int64_t*)ph, n, (const int64_t*)bh, (const int64_t*)order, nb,
      keys, mode, (int64_t*)lo, (int64_t*)cnt, (int64_t*)hit,
      (uint8_t*)bflag);
  return (int)cudaGetLastError();
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
