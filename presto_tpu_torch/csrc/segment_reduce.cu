// K3 segment_reduce: per-segment count, sum, min and max over contiguous
// [start, end) ranges of sorted rows.
//
// Replaces presto_tpu/ops/scan.py:segment_sums (:160), which takes each
// segment's sum as the difference of one running cumulative sum (cumsum
// :36), and the sort-based min/max of ops/aggregate.py:_eval_agg_sorted
// (:551). Here each segment is summed directly, so float64 sums can differ
// from the JAX package's in the last bits.
//
// One warp per segment (grid-stride over segments). Lanes stride over the
// segment's rows accumulating in registers, then a fixed xor-shuffle tree
// combines the lanes, so results repeat from run to run. A row contributes
// only where live[i] is set (or everywhere when live is null).
//
// Values: float64 (dtype 0), int64 (1) or int32 (2). Integer sums wrap in
// two's complement like the JAX package's int64 sums; fsum is always the
// float64 sum (the shadow sum the overflow check compares against). Min and
// max follow the JAX package's sorted path: NaN sorts last, so a NaN wins
// only where a segment holds nothing else.
//
// Bound on an H100: memory — each row's value and live flag are read once
// (9 or 5 B/row) and each segment's results written once. Segments at SF1
// (q18 block) average 4 rows, so most lanes idle: simple, not fast.
//
// 128-bit sum mode (segment_sum128; the DECIMAL(38) kinds sum128/avg128 of
// presto_tpu/ops/aggregate.py:_eval_agg_sorted :612-631): per segment the
// live count and four int64 sums, one per 32-bit limb lane. The input is
// four limb lanes (DT_LIMBS) or int64/int32 values that each lane
// decomposes into limbs in registers. Limb sums are int64 (2^31 row limbs
// fit without a carry) and recombine exactly on the host, so segment sums
// stay exact past 2^127, where an __int128 accumulator would wrap. Same
// layout as the default mode: one warp per segment, xor-shuffle trees.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#define SR_THREADS 256
#define WANT_SUM 1
#define WANT_MINMAX 2
#define M32 0xFFFFFFFFll

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

__global__ void segment_reduce_kernel(
    const void* __restrict__ values, int dtype,
    const uint8_t* __restrict__ live,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ ends,
    int64_t nseg, int64_t n, int want,
    int64_t* __restrict__ cnt_out, double* __restrict__ fsum_out,
    int64_t* __restrict__ isum_out, int64_t* __restrict__ min_out,
    int64_t* __restrict__ max_out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t first = (int64_t)blockIdx.x * warps_per_block
                        + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * warps_per_block;
  const bool is_f = dtype == DT_F64;
  for (int64_t g = first; g < nseg; g += stride) {
    int64_t s = starts[g], e = ends[g];
    s = s < 0 ? 0 : (s > n ? n : s);
    e = e < s ? s : (e > n ? n : e);
    long long c = 0, isum = 0;
    double fsum = 0.0;
    double fmn = nan(""), fmx = nan("");
    long long imn = LLONG_MAX, imx = LLONG_MIN;
    for (int64_t i = s + lane; i < e; i += 32) {
      if (live != nullptr && !live[i]) continue;
      ++c;
      if (is_f) {
        const double v = ((const double*)values)[i];
        if (want & WANT_SUM) fsum += v;
        if (want & WANT_MINMAX) {
          fmn = min_nan_last(fmn, v);
          fmx = max_nan_last(fmx, v);
        }
      } else {
        const long long v = dtype == DT_I64
                                ? ((const long long*)values)[i]
                                : (long long)((const int*)values)[i];
        if (want & WANT_SUM) {
          isum = wrap_add(isum, v);
          fsum += (double)v;
        }
        if (want & WANT_MINMAX) {
          imn = v < imn ? v : imn;
          imx = v > imx ? v : imx;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, o);
      if (want & WANT_SUM) {
        fsum += __shfl_xor_sync(0xffffffffu, fsum, o);
        isum = wrap_add(isum, __shfl_xor_sync(0xffffffffu, isum, o));
      }
      if (want & WANT_MINMAX) {
        if (is_f) {
          fmn = min_nan_last(fmn, __shfl_xor_sync(0xffffffffu, fmn, o));
          fmx = max_nan_last(fmx, __shfl_xor_sync(0xffffffffu, fmx, o));
        } else {
          const long long a = __shfl_xor_sync(0xffffffffu, imn, o);
          const long long b = __shfl_xor_sync(0xffffffffu, imx, o);
          imn = a < imn ? a : imn;
          imx = b > imx ? b : imx;
        }
      }
    }
    if (lane == 0) {
      cnt_out[g] = c;
      if (want & WANT_SUM) {
        fsum_out[g] = fsum;
        if (isum_out != nullptr) isum_out[g] = isum;
      }
      if (want & WANT_MINMAX) {
        if (is_f) {
          ((double*)min_out)[g] = fmn;
          ((double*)max_out)[g] = fmx;
        } else {
          min_out[g] = imn;
          max_out[g] = imx;
        }
      }
    }
  }
}

__global__ void segment_sum128_kernel(
    const int64_t* __restrict__ l3, const int64_t* __restrict__ l2,
    const int64_t* __restrict__ l1, const int64_t* __restrict__ l0,
    int dtype, const uint8_t* __restrict__ live,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ ends,
    int64_t nseg, int64_t n, int64_t* __restrict__ cnt_out,
    int64_t* __restrict__ lsum_out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t first = (int64_t)blockIdx.x * warps_per_block
                        + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * warps_per_block;
  for (int64_t g = first; g < nseg; g += stride) {
    int64_t s = starts[g], e = ends[g];
    s = s < 0 ? 0 : (s > n ? n : s);
    e = e < s ? s : (e > n ? n : e);
    long long c = 0, acc[4] = {0, 0, 0, 0};
    for (int64_t i = s + lane; i < e; i += 32) {
      if (live != nullptr && !live[i]) continue;
      ++c;
      if (dtype == DT_LIMBS) {
        acc[0] = wrap_add(acc[0], l3[i]);
        acc[1] = wrap_add(acc[1], l2[i]);
        acc[2] = wrap_add(acc[2], l1[i]);
        acc[3] = wrap_add(acc[3], l0[i]);
      } else {
        // the limbs of a narrow value, as int128.from_int64
        const long long v = dtype == DT_I64
                                ? ((const long long*)l3)[i]
                                : (long long)((const int*)l3)[i];
        const long long sign = v >> 63;
        acc[0] = wrap_add(acc[0], sign);
        acc[1] = wrap_add(acc[1], sign & M32);
        acc[2] = wrap_add(acc[2], (v >> 32) & M32);
        acc[3] = wrap_add(acc[3], v & M32);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, o);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = wrap_add(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], o));
    }
    if (lane == 0) {
      cnt_out[g] = c;
#pragma unroll
      for (int q = 0; q < 4; ++q) lsum_out[q * nseg + g] = acc[q];
    }
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// want: WANT_SUM | WANT_MINMAX; values: [n] of dtype; live: [n] bool or null; starts/ends: [nseg] int64;
// outputs [nseg]: cnt int64 (always), fsum float64 and isum int64 (with
// WANT_SUM; isum may be null), min/max 8-byte words holding float64 for
// dtype 0 and int64 otherwise (with WANT_MINMAX).
int segment_reduce(const void* values, int dtype, int want, const void* live,
                   const void* starts, const void* ends, int64_t nseg,
                   int64_t n, void* cnt, void* fsum, void* isum,
                   void* mn, void* mx, void* stream) {
  if (nseg <= 0) return 0;
  if (dtype < DT_F64 || dtype > DT_I32) return (int)cudaErrorInvalidValue;
  const int64_t warps_per_block = SR_THREADS / 32;
  int64_t blocks = (nseg + warps_per_block - 1) / warps_per_block;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  segment_reduce_kernel<<<(unsigned)blocks, SR_THREADS, 0,
                          (cudaStream_t)stream>>>(
      values, dtype, (const uint8_t*)live, (const int64_t*)starts,
      (const int64_t*)ends, nseg, n, want, (int64_t*)cnt, (double*)fsum,
      (int64_t*)isum, (int64_t*)mn, (int64_t*)mx);
  return (int)cudaGetLastError();
}

// The 128-bit sum mode. dtype DT_LIMBS: l3..l0 are the four limb lanes;
// DT_I64/DT_I32: l3 holds the values and l2..l0 are unused. live: [n] bool
// or null; outputs: cnt [nseg] int64, lsum [4, nseg] int64 (limb sums
// l3..l0, wrapping).
int segment_sum128(const void* l3, const void* l2, const void* l1,
                   const void* l0, int dtype, const void* live,
                   const void* starts, const void* ends, int64_t nseg,
                   int64_t n, void* cnt, void* lsum, void* stream) {
  if (nseg <= 0) return 0;
  if (dtype < DT_I64 || dtype > DT_LIMBS) return (int)cudaErrorInvalidValue;
  const int64_t warps_per_block = SR_THREADS / 32;
  int64_t blocks = (nseg + warps_per_block - 1) / warps_per_block;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  segment_sum128_kernel<<<(unsigned)blocks, SR_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int64_t*)l3, (const int64_t*)l2, (const int64_t*)l1,
      (const int64_t*)l0, dtype, (const uint8_t*)live,
      (const int64_t*)starts, (const int64_t*)ends, nseg, n, (int64_t*)cnt,
      (int64_t*)lsum);
  return (int)cudaGetLastError();
}

}  // extern "C"
