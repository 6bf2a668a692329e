// K1 direct_agg: small-domain grouped aggregation in one pass over the rows.
//
// Replaces presto_tpu/ops/aggregate.py:_direct_grouped_aggregate (:145)
// together with the fused filter mask that exec/executor.py's agg_fn (:889)
// hands it, and so also serves global aggregation (one bin, no keys).
//
// Per row: the mixed-radix bin code of the key code columns (a NULL key
// takes the extra bin `domain`), validity = row < *num_rows AND the fused
// mask. Per (bin, input): the count of live rows (valid and the input not
// NULL), the float64 sum, the int64 sum (wrapping, integer inputs), and
// min/max; per bin the count of valid rows (count(*)).
//
// 128-bit sum mode (WANT_SUM128; the DECIMAL(38) kinds sum128/avg128 of
// presto_tpu/ops/aggregate.py:284-313): four int64 sums per (bin, input),
// one per 32-bit limb lane. An input is either four limb lanes (a
// DECIMAL(p>18) column, DT_LIMBS) or int64/int32 values that each thread
// decomposes into limbs in registers (v >> 63, its low 32 bits, ...), so no
// decomposed copy is written. Each limb sum is an int64 that can take 2^31
// row limbs without a carry; the exact value is recombined on the host, so
// group sums stay exact past 2^127, where one __int128 accumulator would
// wrap. With the mode on, each input's slot group grows from 5 to 9
// accumulators.
//
// No float atomics anywhere, so results repeat from run to run:
//   pass 1: each warp takes 32 consecutive rows at a time (grid-stride).
//           For each bin present among them (__ballot/__shfl over the
//           lanes) it reduces the members with fixed xor-shuffle trees and
//           lane 0 folds the results into the warp's own accumulators in
//           shared memory. The block then combines its warps in order and
//           writes one partial per block:
//           [blocks, bins, 1 + per_input * inputs].
//   pass 2: one warp per accumulator slot folds the block partials in a
//           fixed order (lane-strided, then an xor tree).
// The grid depends only on the row count, bins and inputs, so the
// summation order is fixed for given inputs.
//
// Bound on an H100: memory. Each row's key codes (4 B each), key null
// flags (1 B each), mask (1 B) and each input's value (8 B) and null flag
// (1 B) are read once; for q01 at SF1 that is about 6.0M rows x 55 B. The
// shuffle trees cost a few dozen instructions per row and input, well
// below what would make the kernel compute bound.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#define DA_MAX_KEYS 6
#define DA_MAX_INPUTS 12
#define DA_MAX_BINS 64
#define DA_MAX_GRID 528
#define DA_SMEM_BYTES 49152
#define WANT_SUM 1
#define WANT_MINMAX 2
#define WANT_SUM128 4
#define FULL 0xffffffffu
#define M32 0xFFFFFFFFll

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_LIMBS = 3 };

// Mirrored field for field by presto_tpu_torch/ops/aggregate.py
// (_DirectAggArgs).
struct DirectAggArgs {
  int64_t n;                  // rows in every column (page capacity)
  const int64_t* num_rows;    // device scalar: rows >= *num_rows are padding
  const uint8_t* mask;        // fused filter mask or null
  int32_t num_keys;
  int32_t bins;               // prod of (domain + 1)
  const int32_t* key_codes[DA_MAX_KEYS];
  const uint8_t* key_nulls[DA_MAX_KEYS];
  int32_t key_domain[DA_MAX_KEYS];
  int32_t num_inputs;
  const void* in_values[DA_MAX_INPUTS];
  const uint8_t* in_nulls[DA_MAX_INPUTS];   // null: no NULLs
  int32_t in_dtype[DA_MAX_INPUTS];
  int32_t in_want[DA_MAX_INPUTS];
  int64_t* rows;              // [bins] valid rows per bin
  int64_t* cnt;               // [inputs, bins] live rows
  double* fsum;               // [inputs, bins]
  int64_t* isum;              // [inputs, bins]
  int64_t* mn;                // [inputs, bins] float64 bits for dtype 0
  int64_t* mx;                // [inputs, bins]
  const int64_t* in_limbs[DA_MAX_INPUTS][4];   // DT_LIMBS: l3, l2, l1, l0
  int64_t* lsum;              // [inputs, 4, bins] limb sums (WANT_SUM128)
  int32_t per_input;          // accumulators per input: 5, or 9 with limbs
};

static __device__ __forceinline__ double as_f(long long w) {
  return __longlong_as_double(w);
}
static __device__ __forceinline__ long long as_w(double d) {
  return __double_as_longlong(d);
}
static __device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
// NaN-propagating min/max, as jnp.min/jnp.max over the masked bin
static __device__ __forceinline__ double fmin_prop(double a, double b) {
  if (isnan(a) || isnan(b)) return a + b;
  return b < a ? b : a;
}
static __device__ __forceinline__ double fmax_prop(double a, double b) {
  if (isnan(a) || isnan(b)) return a + b;
  return b > a ? b : a;
}

// k: position inside one bin's slot group (0 = rows, then per_input per
// input: count, fsum, isum, min, max and, with limbs, four limb sums)
static __device__ __forceinline__ long long slot_identity(
    const DirectAggArgs& a, int k) {
  if (k == 0) return 0;
  const int j = (k - 1) / a.per_input, stat = (k - 1) % a.per_input;
  const bool f = a.in_dtype[j] == DT_F64;
  if (stat == 3) return f ? as_w(INFINITY) : LLONG_MAX;
  if (stat == 4) return f ? as_w(-INFINITY) : LLONG_MIN;
  return 0;   // counts, int sums, and float sums (0.0 has all bits 0)
}

static __device__ __forceinline__ long long slot_combine(
    const DirectAggArgs& a, int k, long long x, long long y) {
  if (k == 0) return x + y;
  const int j = (k - 1) / a.per_input, stat = (k - 1) % a.per_input;
  const bool f = a.in_dtype[j] == DT_F64;
  switch (stat) {
    case 0: return x + y;
    case 1: return as_w(as_f(x) + as_f(y));
    case 3: return f ? as_w(fmin_prop(as_f(x), as_f(y))) : (y < x ? y : x);
    case 4: return f ? as_w(fmax_prop(as_f(x), as_f(y))) : (y > x ? y : x);
    default: return wrap_add(x, y);   // int64 sum, limb sums
  }
}

__global__ void direct_agg_partials(const DirectAggArgs a,
                                    long long* __restrict__ partials) {
  extern __shared__ long long smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per_bin = 1 + a.per_input * a.num_inputs;
  const int slots = a.bins * per_bin;
  long long* acc = smem + (size_t)warp * slots;
  for (int s = lane; s < slots; s += 32) acc[s] = slot_identity(a, s % per_bin);
  __syncwarp();

  int64_t lim = *a.num_rows;
  lim = lim < 0 ? 0 : (lim < a.n ? lim : a.n);
  const int64_t gw = (int64_t)blockIdx.x * nwarps + warp;
  const int64_t tw = (int64_t)gridDim.x * nwarps;
  for (int64_t base = gw * 32; base < lim; base += tw * 32) {
    const int64_t i = base + lane;
    const bool live = i < lim && (a.mask == nullptr || a.mask[i]);
    int bin = 0;
    if (live) {
      for (int k = 0; k < a.num_keys; ++k) {
        const int d = a.key_domain[k];
        int c = a.key_codes[k][i];
        c = c < 0 ? 0 : (c > d - 1 ? d - 1 : c);
        if (a.key_nulls[k][i]) c = d;          // NULL: after all codes
        bin = bin * (d + 1) + c;
      }
    }
    unsigned todo = __ballot_sync(FULL, live);
    while (todo) {                              // warp-uniform loop
      const int leader = __ffs(todo) - 1;
      const int b = __shfl_sync(FULL, bin, leader);
      const bool mine = live && bin == b;
      const unsigned m = __ballot_sync(FULL, mine);
      todo &= ~m;
      long long* slot = acc + (size_t)b * per_bin;
      if (lane == 0) slot[0] += __popc(m);
      for (int j = 0; j < a.num_inputs; ++j) {
        const bool lj = mine && (a.in_nulls[j] == nullptr || !a.in_nulls[j][i]);
        const int dt = a.in_dtype[j];
        const int want = a.in_want[j];
        double f = 0.0;
        long long v = 0;
        long long limb[4] = {0, 0, 0, 0};
        if (lj) {
          if (dt == DT_LIMBS) {
#pragma unroll
            for (int q = 0; q < 4; ++q) limb[q] = a.in_limbs[j][q][i];
          } else if (dt == DT_F64) {
            f = ((const double*)a.in_values[j])[i];
          } else {
            v = dt == DT_I64 ? ((const long long*)a.in_values[j])[i]
                             : (long long)((const int*)a.in_values[j])[i];
            f = (double)v;
            // the limbs of a narrow value, as int128.from_int64
            limb[0] = v >> 63;
            limb[1] = limb[0] & M32;
            limb[2] = (v >> 32) & M32;
            limb[3] = v & M32;
          }
        }
        const unsigned mj = __ballot_sync(FULL, lj);
        long long* st = slot + 1 + a.per_input * j;
        if (lane == 0) st[0] += __popc(mj);
        if (want & WANT_SUM) {
          double fs = lj ? f : 0.0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            fs += __shfl_xor_sync(FULL, fs, o);
          if (lane == 0) st[1] = as_w(as_f(st[1]) + fs);
          if (dt != DT_F64) {                   // int64 sum: integers only
            long long is = lj ? v : 0;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              is = wrap_add(is, __shfl_xor_sync(FULL, is, o));
            if (lane == 0) st[2] = wrap_add(st[2], is);
          }
        }
        if (want & WANT_SUM128) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            long long ls = limb[q];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              ls = wrap_add(ls, __shfl_xor_sync(FULL, ls, o));
            if (lane == 0) st[5 + q] = wrap_add(st[5 + q], ls);
          }
        }
        if (want & WANT_MINMAX) {
          if (dt == DT_F64) {
            double lo = lj ? f : INFINITY, hi = lj ? f : -INFINITY;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              lo = fmin_prop(lo, __shfl_xor_sync(FULL, lo, o));
              hi = fmax_prop(hi, __shfl_xor_sync(FULL, hi, o));
            }
            if (lane == 0) {
              st[3] = as_w(fmin_prop(as_f(st[3]), lo));
              st[4] = as_w(fmax_prop(as_f(st[4]), hi));
            }
          } else {
            long long lo = lj ? v : LLONG_MAX, hi = lj ? v : LLONG_MIN;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              const long long x = __shfl_xor_sync(FULL, lo, o);
              const long long y = __shfl_xor_sync(FULL, hi, o);
              lo = x < lo ? x : lo;
              hi = y > hi ? y : hi;
            }
            if (lane == 0) {
              st[3] = lo < st[3] ? lo : st[3];
              st[4] = hi > st[4] ? hi : st[4];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  long long* out = partials + (size_t)blockIdx.x * slots;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int k = s % per_bin;
    long long r = smem[s];
    for (int w = 1; w < nwarps; ++w)
      r = slot_combine(a, k, r, smem[(size_t)w * slots + s]);
    out[s] = r;
  }
}

// One warp per accumulator slot: lanes fold the block partials blk = lane,
// lane + 32, ... in order, then a fixed xor tree combines the lanes.
__global__ void direct_agg_final(const DirectAggArgs a,
                                 const long long* __restrict__ partials,
                                 int blocks) {
  const int per_bin = 1 + a.per_input * a.num_inputs;
  const int slots = a.bins * per_bin;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= slots) return;                       // warp-uniform
  const int k = s % per_bin, b = s / per_bin;
  long long r = slot_identity(a, k);
  for (int blk = lane; blk < blocks; blk += 32)
    r = slot_combine(a, k, r, partials[(size_t)blk * slots + s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = slot_combine(a, k, r, __shfl_xor_sync(FULL, r, o));
  if (lane != 0) return;
  if (k == 0) {
    a.rows[b] = r;
    return;
  }
  const int j = (k - 1) / a.per_input, stat = (k - 1) % a.per_input;
  const int idx = j * a.bins + b;
  switch (stat) {
    case 0: a.cnt[idx] = r; break;
    case 1: a.fsum[idx] = as_f(r); break;
    case 2: a.isum[idx] = r; break;
    case 3: a.mn[idx] = r; break;
    case 4: a.mx[idx] = r; break;
    default: a.lsum[((size_t)j * 4 + (stat - 5)) * a.bins + b] = r; break;
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// args: host pointer to the argument block; scratch: device int64 buffer
// of scratch_words words for the block partials.
int direct_agg(const void* args, void* scratch, int64_t scratch_words,
               void* stream) {
  const DirectAggArgs& a = *(const DirectAggArgs*)args;
  if (a.num_keys < 0 || a.num_keys > DA_MAX_KEYS || a.bins < 1
      || a.bins > DA_MAX_BINS || a.num_inputs < 0
      || a.num_inputs > DA_MAX_INPUTS || a.n < 0
      || (a.per_input != 5 && a.per_input != 9))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < a.num_inputs; ++j)
    if ((a.in_want[j] & WANT_SUM128) && a.per_input != 9)
      return (int)cudaErrorInvalidValue;
  const int64_t slots = (int64_t)a.bins * (1 + a.per_input * a.num_inputs);
  int warps = (int)(DA_SMEM_BYTES / (slots * 8));
  warps = warps > 8 ? 8 : warps;
  if (warps < 1 || scratch_words < slots) return (int)cudaErrorInvalidValue;
  int64_t grid = (a.n + 32 * warps - 1) / (32 * warps);
  if (grid > DA_MAX_GRID) grid = DA_MAX_GRID;
  if (grid > scratch_words / slots) grid = scratch_words / slots;
  if (grid < 1) grid = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)warps * slots * 8;
  direct_agg_partials<<<(unsigned)grid, 32 * warps, smem, s>>>(
      a, (long long*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int warps_per_block = 8;
  direct_agg_final<<<(unsigned)((slots + warps_per_block - 1)
                                / warps_per_block),
                     32 * warps_per_block, 0, s>>>(
      a, (const long long*)scratch, (int)grid);
  return (int)cudaGetLastError();
}

}  // extern "C"
