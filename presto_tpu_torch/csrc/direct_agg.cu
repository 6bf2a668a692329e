// K1 direct_agg: small-domain grouped aggregation in one pass over the rows.
//
// Replaces presto_tpu/ops/aggregate.py:_direct_grouped_aggregate (:145)
// together with the fused filter mask that exec/executor.py's agg_fn (:889)
// hands it, and so also serves global aggregation (one bin, no keys).
//
// Semantics (unchanged from the first version of this kernel):
// - per row, the mixed-radix bin code of the key code columns; a NULL key
//   takes the extra bin `domain`; validity = row < *num_rows AND the fused
//   mask;
// - per bin, `rows` counts the valid rows (count(*)); per (bin, input),
//   `cnt` counts the live rows (valid and the input not NULL);
// - per (bin, input), the float64 sum, the int64 sum (integer inputs;
//   integer sums wrap), min and max; NaN propagates through min and max,
//   as jnp.min/jnp.max over the masked bin;
// - 128-bit sum mode (WANT_SUM128; the DECIMAL(38) kinds sum128/avg128 of
//   presto_tpu/ops/aggregate.py:284-313): four int64 sums per (bin, input),
//   one per 32-bit limb lane. An input is either four limb lanes (a
//   DECIMAL(p>18) column, DT_LIMBS) or int64/int32 values that each thread
//   decomposes into limbs in registers (v >> 63, its low 32 bits, ...), so
//   no decomposed copy is written. Each limb sum is an int64 that can take
//   2^31 row limbs without a carry; the exact value is recombined on the
//   host, so group sums stay exact past 2^127, where one __int128
//   accumulator would wrap. The final merges sum128_merge/avg128_merge
//   (presto_tpu/ops/aggregate.py:197-215) take this mode as it is: their
//   input is the limb lanes of DECIMAL(38) partial states, any int64
//   values, whose per-bin `cnt` counts the live states (none: NULL), and
//   avg128_merge adds the int64 sum of its partial count column as a
//   second input of the same launch.
// Outputs a caller did not ask for hold the statistic's identity (0, or
// +-inf / INT64_MAX / INT64_MIN for min and max).
//
// Design for the H100. Each thread takes a run of DA_RUN = 16 consecutive
// rows at a time (grid-stride over runs), reads the run's mask, key codes,
// null flags and values with 16-byte vector loads (element loads where a
// column is not 16-byte aligned or at the ragged end), computes each row's
// bin once and adds the rows into its own accumulators serially, in row
// order. No cross-lane work per row; a run with no valid row reads nothing
// past its mask, an input with no live row in the run nothing past its
// null flags. An input keeps only the statistics it asks for: its count,
// and the float sum, int sum, min/max or limb sums. The accumulators are
// thread-private slices of dynamic shared memory, laid out
// [accumulator][thread], so that each lane hits its own bank whatever its
// bin; counts take 4 bytes, the rest 8. Up to 32 bins a block has 256
// threads and half an SM's shared memory (two blocks an SM: 16 warps keep
// loads in flight), past that 128 threads and all of it. Accumulators that
// do not fit are taken in groups, all in the same launch: a block's group
// is blockIdx.x % groups, so the groups of one stretch of rows run side by
// side and read its mask and keys from L2 after the first. Each block ends
// with fixed trees that combine its threads' accumulators in slot order
// into one partial; direct_agg_final then folds the block partials in a
// fixed order. No float atomics anywhere, and the grid is a function of
// the row count, the bins and the inputs alone (not of the card), so float
// sums repeat bit for bit from run to run.
//
// Bound on an H100: memory. Each row's mask (1 B) is read once, and each
// valid row's key codes (4 B each), key null flags (1 B each) and each
// input's value (8 B) and null flag (1 B); for q01 at SF1 that is about
// 5.9M valid rows x 55 B.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>
#include <string.h>

#define DA_MAX_KEYS 6
#define DA_MAX_INPUTS 12
#define DA_MAX_BINS 64
#define DA_STATS 9                 // output statistics per input
#define DA_MAX_ACC (1 + DA_MAX_INPUTS * DA_STATS)   // per bin, with rows
#define DA_MAX_GROUPS 48
#define DA_RUN 16                  // rows a thread takes at a time
#define DA_SMS 132                 // the grid's unit: the H100 SXM's SMs
#define DA_SMEM_BLOCK 232448       // shared memory of one block, in all
#define DA_SMEM_SM 233472          // shared memory of one SM
#define DA_SMEM_RESERVED 1024      // taken by the runtime from each block
#define DA_SMEM_STATIC 512         // at least the pass's static shared memory
#define WANT_SUM 1
#define WANT_MINMAX 2
#define WANT_SUM128 4
#define FULL 0xffffffffu
#define M32 0xFFFFFFFFll

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_LIMBS = 3 };
// accumulator kinds: a 4-byte count, or an 8-byte sum, min or max
enum { OP_CNT = 0, OP_FADD, OP_IADD, OP_FMIN, OP_FMAX, OP_IMIN, OP_IMAX };

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
};

// The accumulators a launch keeps, in groups: per bin, the 4-byte counts
// of a group first, then its 8-byte words. acc_k lists, group after group,
// the output slot k (0 = rows, then DA_STATS per input, as slot_op numbers
// them) of each accumulator; group g holds acc_k[start[g] .. start[g+1]),
// its first n32[g] the counts.
struct DaLaunch {
  int32_t groups;
  int32_t xblocks;            // blocks of each group
  int32_t na_max;             // accumulators per bin of the widest group
  int16_t start[DA_MAX_GROUPS + 1];
  int8_t n32[DA_MAX_GROUPS];
  int8_t acc_k[DA_MAX_ACC];
};

// one input's accumulators in a group: their index in the group, or -1
struct GroupInput {
  int8_t j, cnt, fsum, isum, mn, mx, limb[4];
};

// Where direct_agg_final finds each statistic: per output slot k of a bin
// its group and index, group -1 for a statistic no group keeps.
struct DaFinal {
  int8_t group[DA_MAX_ACC];
  int8_t idx[DA_MAX_ACC];
};

struct DaPlan {
  int threads;
  size_t smem;                // dynamic shared memory of a block
  int64_t words;              // scratch words: the block partials
  DaLaunch l;
  DaFinal f;
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

static __device__ __forceinline__ long long op_identity(int op) {
  switch (op) {
    case OP_FMIN: return as_w(INFINITY);
    case OP_FMAX: return as_w(-INFINITY);
    case OP_IMIN: return LLONG_MAX;
    case OP_IMAX: return LLONG_MIN;
    default: return 0;        // counts and sums (0.0 has all bits 0)
  }
}

static __device__ __forceinline__ long long op_combine(int op, long long x,
                                                       long long y) {
  switch (op) {
    case OP_FADD: return as_w(as_f(x) + as_f(y));
    case OP_FMIN: return as_w(fmin_prop(as_f(x), as_f(y)));
    case OP_FMAX: return as_w(fmax_prop(as_f(x), as_f(y)));
    case OP_IMIN: return y < x ? y : x;
    case OP_IMAX: return y > x ? y : x;
    default: return wrap_add(x, y);   // counts, int64 and limb sums
  }
}

// the kind of output slot k of a bin (0 = rows, then DA_STATS per input:
// count, fsum, isum, min, max and four limb sums)
static __host__ __device__ int slot_op(const DirectAggArgs& a, int k) {
  if (k == 0) return OP_CNT;
  const int j = (k - 1) / DA_STATS, stat = (k - 1) % DA_STATS;
  const bool f = a.in_dtype[j] == DT_F64;
  switch (stat) {
    case 0: return OP_CNT;
    case 1: return OP_FADD;
    case 3: return f ? OP_FMIN : OP_IMIN;
    case 4: return f ? OP_FMAX : OP_IMAX;
    default: return OP_IADD;
  }
}

// ---------------------------------------------------------------------------
// loads of one run: DA_RUN rows from r0, vector loads where VEC and the run
// lies below lim, else element loads of the rows below lim
// ---------------------------------------------------------------------------

template <bool VEC>
static __device__ __forceinline__ void load_u8(const uint8_t* p, int64_t r0,
                                               int64_t lim,
                                               uint8_t (&out)[DA_RUN]) {
  if (VEC && r0 + DA_RUN <= lim) {
    const uint4 v = __ldg((const uint4*)(p + r0));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < DA_RUN; ++r)
      out[r] = (w[r >> 2] >> (8 * (r & 3))) & 0xff;
  } else {
#pragma unroll
    for (int r = 0; r < DA_RUN; ++r) out[r] = r0 + r < lim ? p[r0 + r] : 0;
  }
}

template <bool VEC>
static __device__ __forceinline__ void load_i32(const int32_t* p, int64_t r0,
                                                int64_t lim,
                                                int32_t (&out)[DA_RUN]) {
  if (VEC && r0 + DA_RUN <= lim) {
#pragma unroll
    for (int q = 0; q < DA_RUN / 4; ++q) {
      const int4 v = __ldg((const int4*)(p + r0) + q);
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < DA_RUN; ++r) out[r] = r0 + r < lim ? p[r0 + r] : 0;
  }
}

template <bool VEC>
static __device__ __forceinline__ void load_i64(const long long* p,
                                                int64_t r0, int64_t lim,
                                                long long (&out)[DA_RUN]) {
  if (VEC && r0 + DA_RUN <= lim) {
#pragma unroll
    for (int q = 0; q < DA_RUN / 2; ++q) {
      const longlong2 v = __ldg((const longlong2*)(p + r0) + q);
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < DA_RUN; ++r) out[r] = r0 + r < lim ? p[r0 + r] : 0;
  }
}

// the run's values of input j as 8-byte words (float64 bits or int64)
template <bool VEC>
static __device__ __forceinline__ void load_values(const DirectAggArgs& a,
                                                   int j, int64_t r0,
                                                   int64_t lim,
                                                   long long (&w)[DA_RUN]) {
  if (a.in_dtype[j] == DT_I32) {
    int32_t v[DA_RUN];
    load_i32<VEC>((const int32_t*)a.in_values[j], r0, lim, v);
#pragma unroll
    for (int r = 0; r < DA_RUN; ++r) w[r] = v[r];
  } else {
    load_i64<VEC>((const long long*)a.in_values[j], r0, lim, w);
  }
}

// bit r set where byte r of the run is not 0
template <bool VEC>
static __device__ __forceinline__ uint32_t load_flags(const uint8_t* p,
                                                      int64_t r0,
                                                      int64_t lim) {
  uint8_t b[DA_RUN];
  load_u8<VEC>(p, r0, lim, b);
  uint32_t m = 0;
#pragma unroll
  for (int r = 0; r < DA_RUN; ++r) m |= (uint32_t)(b[r] != 0) << r;
  return m;
}

// ---------------------------------------------------------------------------
// the pass: blockIdx.x % groups is the block's group of accumulators; the
// groups of one stretch of rows are neighbouring blocks, so they read its
// mask and keys from L2 after the first
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(256, 2)
direct_agg_pass(const DirectAggArgs a, const DaLaunch l,
                long long* __restrict__ partials) {
  extern __shared__ long long smem[];
  __shared__ GroupInput gin[DA_MAX_INPUTS];
  __shared__ int8_t gop[DA_MAX_ACC];
  __shared__ int gnum_in, grows;
  const int T = blockDim.x, tid = threadIdx.x;
  const int grp = blockIdx.x % l.groups;
  const int xblk = blockIdx.x / l.groups;
  const int first = l.start[grp], n32 = l.n32[grp];
  const int na = l.start[grp + 1] - first, n64 = na - n32;
  if (tid == 0) {                     // the group's accumulators by input
    int num_in = 0;
    grows = -1;
    for (int idx = 0; idx < na; ++idx) {
      const int k = l.acc_k[first + idx];
      gop[idx] = (int8_t)slot_op(a, k);
      if (k == 0) {
        grows = idx;
        continue;
      }
      const int j = (k - 1) / DA_STATS, stat = (k - 1) % DA_STATS;
      int e = 0;
      while (e < num_in && gin[e].j != j) ++e;
      if (e == num_in) {
        GroupInput gi = {(int8_t)j, -1, -1, -1, -1, -1, {-1, -1, -1, -1}};
        gin[num_in++] = gi;
      }
      int8_t* slot = stat == 0 ? &gin[e].cnt : stat == 1 ? &gin[e].fsum
                   : stat == 2 ? &gin[e].isum : stat == 3 ? &gin[e].mn
                   : stat == 4 ? &gin[e].mx : &gin[e].limb[stat - 5];
      *slot = (int8_t)idx;
    }
    gnum_in = num_in;
  }
  __syncthreads();
  int64_t lim = *a.num_rows;
  lim = lim < 0 ? 0 : (lim < a.n ? lim : a.n);
  if (lim == 0) return;               // direct_agg_final writes identities
  const int bins = a.bins;
  // accumulators: [bin, n32][T] counts, then [bin, n64][T] 8-byte words
  uint32_t* s32 = (uint32_t*)smem + tid;
  long long* s64 = (long long*)((uint32_t*)smem + bins * n32 * T) + tid;
  for (int s = 0; s < bins * n32; ++s) s32[s * T] = 0;
  for (int s = 0; s < bins * n64; ++s)
    s64[s * T] = op_identity(gop[n32 + s % n64]);

  const int64_t step = (int64_t)l.xblocks * T * DA_RUN;
  for (int64_t r0 = ((int64_t)xblk * T + tid) * DA_RUN; r0 < lim;
       r0 += step) {
    uint32_t valid = (r0 + DA_RUN <= lim ? 1u << DA_RUN : 1u << (lim - r0))
                     - 1;
    if (a.mask != nullptr) valid &= load_flags<VEC>(a.mask, r0, lim);
    if (!valid) continue;             // nothing of the run is read
    int bin[DA_RUN];
#pragma unroll
    for (int r = 0; r < DA_RUN; ++r) bin[r] = 0;
    for (int k = 0; k < a.num_keys; ++k) {
      const int d = a.key_domain[k];
      int32_t c[DA_RUN];
      load_i32<VEC>(a.key_codes[k], r0, lim, c);
      const uint32_t nl = load_flags<VEC>(a.key_nulls[k], r0, lim);
#pragma unroll
      for (int r = 0; r < DA_RUN; ++r) {
        int x = c[r] < 0 ? 0 : (c[r] > d - 1 ? d - 1 : c[r]);
        if (nl >> r & 1) x = d;                // NULL: after all codes
        bin[r] = bin[r] * (d + 1) + x;
      }
    }
    if (grows >= 0) {
#pragma unroll
      for (int r = 0; r < DA_RUN; ++r)
        if (valid >> r & 1) s32[(bin[r] * n32 + grows) * T] += 1;
    }
    for (int e = 0; e < gnum_in; ++e) {
      const GroupInput gi = gin[e];
      const int j = gi.j, dt = a.in_dtype[j];
      uint32_t live = valid;
      if (a.in_nulls[j] != nullptr)
        live &= ~load_flags<VEC>(a.in_nulls[j], r0, lim);
      if (!live) continue;
      if (gi.cnt >= 0) {
#pragma unroll
        for (int r = 0; r < DA_RUN; ++r)
          if (live >> r & 1) s32[(bin[r] * n32 + gi.cnt) * T] += 1;
      }
      if (dt == DT_LIMBS) {
        for (int q = 0; q < 4; ++q) {
          if (gi.limb[q] < 0) continue;
          long long w[DA_RUN];
          load_i64<VEC>((const long long*)a.in_limbs[j][q], r0, lim, w);
          const int at = gi.limb[q] - n32;
#pragma unroll
          for (int r = 0; r < DA_RUN; ++r) {
            if (!(live >> r & 1)) continue;
            long long& s = s64[(bin[r] * n64 + at) * T];
            s = wrap_add(s, w[r]);
          }
        }
        continue;
      }
      const bool lanes = gi.limb[0] >= 0 || gi.limb[1] >= 0
                         || gi.limb[2] >= 0 || gi.limb[3] >= 0;
      if (gi.fsum < 0 && gi.isum < 0 && gi.mn < 0 && gi.mx < 0 && !lanes)
        continue;
      long long w[DA_RUN];
      load_values<VEC>(a, j, r0, lim, w);
#pragma unroll
      for (int r = 0; r < DA_RUN; ++r) {
        if (!(live >> r & 1)) continue;
        long long* row = s64 + (bin[r] * n64 - n32) * T;
        const long long v = w[r];
        if (dt == DT_F64) {
          const double f = as_f(v);
          if (gi.fsum >= 0) {
            long long& s = row[gi.fsum * T];
            s = as_w(as_f(s) + f);
          }
          if (gi.mn >= 0) {
            long long& s = row[gi.mn * T];
            s = as_w(fmin_prop(as_f(s), f));
          }
          if (gi.mx >= 0) {
            long long& s = row[gi.mx * T];
            s = as_w(fmax_prop(as_f(s), f));
          }
          continue;
        }
        if (gi.fsum >= 0) {
          long long& s = row[gi.fsum * T];
          s = as_w(as_f(s) + (double)v);
        }
        if (gi.isum >= 0) {
          long long& s = row[gi.isum * T];
          s = wrap_add(s, v);
        }
        if (gi.mn >= 0) {
          long long& s = row[gi.mn * T];
          s = v < s ? v : s;
        }
        if (gi.mx >= 0) {
          long long& s = row[gi.mx * T];
          s = v > s ? v : s;
        }
        if (lanes) {
          // the limbs of a narrow value, as int128.from_int64
          const long long hi = v >> 63;
          const long long limb[4] = {hi, hi & M32, (v >> 32) & M32,
                                     v & M32};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (gi.limb[q] < 0) continue;
            long long& s = row[gi.limb[q] * T];
            s = wrap_add(s, limb[q]);
          }
        }
      }
    }
  }
  __syncthreads();

  // one warp per accumulator slot: lanes fold threads lane, lane + 32, ...
  // in order, then a fixed xor tree combines the lanes
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  // a block's partials: [bin, na] of its group, blocks na_max apart
  const int slots = bins * na;
  long long* out = partials
                   + ((size_t)grp * l.xblocks + xblk) * bins * l.na_max;
  const uint32_t* c32 = (const uint32_t*)smem;
  const long long* c64 = (const long long*)(c32 + bins * n32 * T);
  for (int s = warp; s < slots; s += nwarps) {
    const int b = s / na, idx = s % na, op = gop[idx];
    long long r = op_identity(op);
    for (int t = lane; t < T; t += 32) {
      const long long x = idx < n32
                              ? (long long)c32[(b * n32 + idx) * T + t]
                              : c64[(b * n64 + idx - n32) * T + t];
      r = op_combine(op, r, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      r = op_combine(op, r, __shfl_xor_sync(FULL, r, o));
    if (lane == 0) out[s] = r;
  }
}

// One warp per output slot: lanes fold the block partials blk = lane,
// lane + 32, ... in order, then a fixed xor tree combines the lanes. A
// statistic no group kept, and every statistic of a page with no row (whose
// passes wrote no partial), takes its identity.
__global__ void direct_agg_final(const DirectAggArgs a, const DaLaunch l,
                                 const DaFinal f,
                                 const long long* __restrict__ partials) {
  const int per_bin = 1 + DA_STATS * a.num_inputs;
  const int slots = a.bins * per_bin;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= slots) return;                       // warp-uniform
  const int k = s % per_bin, b = s / per_bin;
  const int op = slot_op(a, k);
  long long r = op_identity(op);
  const int grp = f.group[k];
  if (grp >= 0 && *a.num_rows > 0 && a.n > 0) {
    const int na = l.start[grp + 1] - l.start[grp];
    const size_t stride = (size_t)a.bins * l.na_max;
    const long long* p = partials + (size_t)grp * l.xblocks * stride
                         + (size_t)b * na + f.idx[k];
    for (int blk = lane; blk < l.xblocks; blk += 32)
      r = op_combine(op, r, p[(size_t)blk * stride]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      r = op_combine(op, r, __shfl_xor_sync(FULL, r, o));
  }
  if (lane != 0) return;
  if (k == 0) {
    a.rows[b] = r;
    return;
  }
  const int j = (k - 1) / DA_STATS, stat = (k - 1) % DA_STATS;
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

// ---------------------------------------------------------------------------
// the plan: which accumulators each group keeps, the block size and grid
// ---------------------------------------------------------------------------

static bool valid_args(const DirectAggArgs& a) {
  if (a.num_keys < 0 || a.num_keys > DA_MAX_KEYS || a.bins < 1
      || a.bins > DA_MAX_BINS || a.num_inputs < 0
      || a.num_inputs > DA_MAX_INPUTS || a.n < 0)
    return false;
  for (int j = 0; j < a.num_inputs; ++j)
    if (a.in_dtype[j] < DT_F64 || a.in_dtype[j] > DT_LIMBS) return false;
  return true;
}

// Output slots k (as slot_op numbers them) that some group keeps, in the
// order the groups take them: rows, then per input its count and the
// statistics it asks for.
static int wanted_slots(const DirectAggArgs& a, int* ks) {
  int m = 0;
  ks[m++] = 0;
  for (int j = 0; j < a.num_inputs; ++j) {
    const int base = 1 + DA_STATS * j, dt = a.in_dtype[j];
    const int want = a.in_want[j];
    ks[m++] = base;                                       // count
    if (dt != DT_LIMBS && (want & WANT_SUM)) {
      ks[m++] = base + 1;                                 // float sum
      if (dt != DT_F64) ks[m++] = base + 2;               // int sum
    }
    if (dt != DT_LIMBS && (want & WANT_MINMAX)) {
      ks[m++] = base + 3;
      ks[m++] = base + 4;
    }
    if (dt != DT_F64 && (want & WANT_SUM128))
      for (int q = 0; q < 4; ++q) ks[m++] = base + 5 + q;
  }
  return m;
}

// Up to 32 bins: blocks of 256 threads, two an SM; past that, 128 threads,
// one an SM. A group takes, in slot order, the accumulators that fit a
// block's share of shared memory.
static bool make_plan(const DirectAggArgs& a, DaPlan* p) {
  if (!valid_args(a)) return false;
  memset(p, 0, sizeof(*p));
  const int bins = a.bins;
  const bool wide = bins > 32;
  p->threads = wide ? 128 : 256;
  const int per_sm = wide ? 1 : 2;
  const int T = p->threads;
  const int64_t block_smem =
      DA_SMEM_SM / per_sm - DA_SMEM_RESERVED - DA_SMEM_STATIC;
  const int cap = (int)(block_smem / ((int64_t)T * bins)) & ~3;
  int ks[DA_MAX_ACC];
  const int m = wanted_slots(a, ks);
  DaLaunch& l = p->l;
  for (int k = 0; k < DA_MAX_ACC; ++k) p->f.group[k] = -1;
  int start = 0, widest = 0;
  while (start < m) {
    if (l.groups == DA_MAX_GROUPS) return false;
    int bytes = 0, end = start;
    while (end < m) {
      const int sz = slot_op(a, ks[end]) == OP_CNT ? 4 : 8;
      if (bytes + sz > cap) break;
      bytes += sz;
      ++end;
    }
    // the group's counts first, then its 8-byte accumulators
    const int g = l.groups, at = start;
    int n32 = 0, pos = at;
    for (int pass = 0; pass < 2; ++pass)
      for (int e = start; e < end; ++e) {
        const int k = ks[e];
        if ((slot_op(a, k) == OP_CNT) != (pass == 0)) continue;
        p->f.group[k] = (int8_t)g;
        p->f.idx[k] = (int8_t)(pos - at);
        l.acc_k[pos++] = (int8_t)k;
        n32 += pass == 0;
      }
    l.start[g] = (int16_t)start;
    l.n32[g] = (int8_t)n32;
    if ((size_t)bytes * bins * T > p->smem) p->smem = (size_t)bytes * bins * T;
    if (end - start > widest) widest = end - start;
    ++l.groups;
    start = end;
  }
  l.start[l.groups] = (int16_t)m;
  // the grid: one wave of blocks over all groups, a function of the row
  // count, the bins and the inputs alone
  const int64_t runs = (a.n + (int64_t)T * DA_RUN - 1) / ((int64_t)T * DA_RUN);
  int64_t xb = ((int64_t)DA_SMS * per_sm + l.groups - 1) / l.groups;
  if (xb > runs) xb = runs;
  if (xb < 1) xb = 1;
  l.xblocks = (int32_t)xb;
  l.na_max = widest;
  p->words = xb * l.groups * bins * widest;
  return true;
}

static bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

// every column a pass reads at a 16-byte aligned address
static bool all_aligned(const DirectAggArgs& a) {
  bool ok = a.mask == nullptr || aligned16(a.mask);
  for (int k = 0; k < a.num_keys; ++k)
    ok = ok && aligned16(a.key_codes[k]) && aligned16(a.key_nulls[k]);
  for (int j = 0; j < a.num_inputs; ++j) {
    ok = ok && (a.in_nulls[j] == nullptr || aligned16(a.in_nulls[j]));
    if (a.in_dtype[j] == DT_LIMBS) {
      for (int q = 0; q < 4; ++q) ok = ok && aligned16(a.in_limbs[j][q]);
    } else {
      ok = ok && aligned16(a.in_values[j]);
    }
  }
  return ok;
}

// the kernels' attributes, set once per device: the passes' shared memory,
// and the final kernel's preference for the same split of shared memory
// and L1, so that the SMs are not reconfigured between the two
static cudaError_t configure() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  // a block's static and dynamic shared memory together fit 227 KB
  e = cudaFuncSetAttribute(direct_agg_pass<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DA_SMEM_BLOCK - DA_SMEM_STATIC);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(direct_agg_pass<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DA_SMEM_BLOCK - DA_SMEM_STATIC);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(direct_agg_final,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done |= bit;
  return e;
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch that direct_agg takes for these arguments (the
// block partials of every group); 0 for arguments that direct_agg refuses.
int64_t direct_agg_scratch_words(const void* args) {
  DaPlan p;
  return make_plan(*(const DirectAggArgs*)args, &p) ? p.words : 0;
}

// args: host pointer to the argument block; scratch: device int64 buffer
// of scratch_words words, at least direct_agg_scratch_words(args).
int direct_agg(const void* args, void* scratch, int64_t scratch_words,
               void* stream) {
  const DirectAggArgs& a = *(const DirectAggArgs*)args;
  DaPlan p;
  if (!make_plan(a, &p) || scratch_words < p.words)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  long long* part = (long long*)scratch;
  const unsigned grid = (unsigned)(p.l.groups * p.l.xblocks);
  if (all_aligned(a))
    direct_agg_pass<true><<<grid, p.threads, p.smem, s>>>(a, p.l, part);
  else
    direct_agg_pass<false><<<grid, p.threads, p.smem, s>>>(a, p.l, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t slots = (int64_t)a.bins * (1 + DA_STATS * a.num_inputs);
  const int warps_per_block = 8;
  direct_agg_final<<<(unsigned)((slots + warps_per_block - 1)
                                / warps_per_block),
                     32 * warps_per_block, 0, s>>>(a, p.l, p.f, part);
  return (int)cudaGetLastError();
}

}  // extern "C"
