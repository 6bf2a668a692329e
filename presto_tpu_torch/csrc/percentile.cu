// K13 segment_pick: the order statistic of approx_percentile per group.
//
// Replaces the pick of presto_tpu/ops/aggregate.py approx_percentile, direct
// (:392-414) and sorted (:737-760): over values sorted within each group
// (its non-null values first, in SQL order), group g takes the element at
// idx = start[g] + floor(p * (double)max(n[g] - 1, 0)), clipped to the
// page, computed in float64 exactly as the JAX function computes it, and
// is NULL where the group has no non-null value (n[g] == 0). The sort in
// front of it is the port's lex_perm.
//
// One thread per group. Bound on an H100: memory. Per group its start and
// count (16 B) read, one value (4-8 B) gathered, the value and its null
// flag written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PICK_THREADS 256

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2 };

template <typename T>
__global__ void segment_pick_kernel(const T* __restrict__ values,
                                    int64_t n_values,
                                    const int64_t* __restrict__ starts,
                                    const int64_t* __restrict__ counts,
                                    int64_t groups, double p,
                                    T* __restrict__ out,
                                    uint8_t* __restrict__ nulls) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const int64_t n = counts[g];
  int64_t idx = starts[g] + (int64_t)floor(p * (double)(n > 1 ? n - 1 : 0));
  idx = idx < 0 ? 0 : (idx > n_values - 1 ? n_values - 1 : idx);
  out[g] = n_values > 0 ? values[idx] : (T)0;
  nulls[g] = n == 0;
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values: [n_values] sorted within each group (dtype 0 float64, 1 int64,
// 2 int32); starts, counts: [groups] int64; out: [groups] of values'
// dtype; nulls: [groups] uint8.
int segment_pick(const void* values, int dtype, int64_t n_values,
                 const void* starts, const void* counts, int64_t groups,
                 double p, void* out, void* nulls, void* stream) {
  if (dtype < DT_F64 || dtype > DT_I32 || n_values < 0 || groups < 0)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  const unsigned blocks =
      (unsigned)((groups + PICK_THREADS - 1) / PICK_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* st = (const int64_t*)starts;
  const int64_t* ct = (const int64_t*)counts;
  uint8_t* nl = (uint8_t*)nulls;
  if (dtype == DT_F64)
    segment_pick_kernel<double><<<blocks, PICK_THREADS, 0, s>>>(
        (const double*)values, n_values, st, ct, groups, p, (double*)out, nl);
  else if (dtype == DT_I64)
    segment_pick_kernel<int64_t><<<blocks, PICK_THREADS, 0, s>>>(
        (const int64_t*)values, n_values, st, ct, groups, p, (int64_t*)out,
        nl);
  else
    segment_pick_kernel<int32_t><<<blocks, PICK_THREADS, 0, s>>>(
        (const int32_t*)values, n_values, st, ct, groups, p, (int32_t*)out,
        nl);
  return (int)cudaGetLastError();
}

}  // extern "C"
