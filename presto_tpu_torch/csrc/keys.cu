// K8 key_change: adjacent-compare boundary flags over rows taken in a
// sort permutation's order.
//
// Replaces the boundary compares of presto_tpu/ops/window.py:171-195
// (`changed`: partition starts, peer starts, the valid -> padding edge at
// :191) and the first-occurrence flags of
// presto_tpu/ops/mark_distinct.py:47-51. The JAX package gathers every key
// lane into sorted order and builds the flags with 3L+ elementwise passes
// (roll, ==, |) over L lanes; here one thread per sorted position i reads
// the rows perm[i] and perm[i - 1] of every lane and writes the flags.
//
// A key is an optional bool null lane and one or more value lanes. Key k
// is the same at rows r and q when both are null, or neither is and every
// value lane is equal: NaN equals NaN and float64 subnormals equal zero
// (values_equal in ops/keys.py, as the JAX package's key functions behave
// on the CPU, where XLA flushes subnormals). Equality is unchanged by the
// widening to int64/float64 the JAX package compares in, and by a
// descending key's order-reversing transform, so the lanes are the page's
// own columns.
//
// Modes:
//   WINDOW  out0[i] = i == 0 | a change of one of the first npart keys |
//                     i == num_rows (valid rows sort first);
//           out1[i] = out0[i] | a change of any later key;
//   FIRST   out0[i] = (i == 0 | a change of any key) & i < num_rows.
//
// Bound on an H100: memory. Each position reads perm twice (the second
// read is the neighbour thread's first: L1/L2) and each lane's row at
// perm[i] (a random 1-8 B read: a 32 B sector), and writes 1-2 B of flags.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LANES 32   // = ops/keys.MAX_CHANGE_LANES
#define MAX_KEYS 32
#define KC_THREADS 256

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_BOOL = 3, DT_F32 = 4 };
enum { MODE_WINDOW = 0, MODE_FIRST = 1 };

// the smallest normal float64; smaller magnitudes compare as zero
#define F64_MIN_NORMAL 2.2250738585072014e-308

struct ChangeKeys {
  const void* lane[MAX_LANES];
  int dt[MAX_LANES];
  int null_lane[MAX_KEYS];   // index into lane, or -1
  int first[MAX_KEYS];       // first value lane
  int count[MAX_KEYS];       // value lanes
  int nkeys;
  int npart;
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
  double x = dt == DT_F64 ? ((const double*)v)[i]
                          : (double)((const float*)v)[i];
  return fabs(x) < F64_MIN_NORMAL ? 0.0 : x;
}

static __device__ bool key_same(const ChangeKeys& k, int key, int64_t r,
                                int64_t q) {
  const int nl = k.null_lane[key];
  if (nl >= 0) {
    const bool nr = ((const uint8_t*)k.lane[nl])[r] != 0;
    const bool nq = ((const uint8_t*)k.lane[nl])[q] != 0;
    if (nr || nq) return nr && nq;
  }
  for (int l = k.first[key]; l < k.first[key] + k.count[key]; ++l) {
    if (is_float(k.dt[l])) {
      const double a = load_f64(k.lane[l], k.dt[l], r);
      const double b = load_f64(k.lane[l], k.dt[l], q);
      if (!(a == b || (a != a && b != b))) return false;
    } else if (load_int(k.lane[l], k.dt[l], r)
               != load_int(k.lane[l], k.dt[l], q)) {
      return false;
    }
  }
  return true;
}

__global__ void key_change_kernel(const int64_t* __restrict__ perm,
                                  int64_t n, const int64_t* num_rows,
                                  ChangeKeys keys, int mode,
                                  uint8_t* __restrict__ out0,
                                  uint8_t* __restrict__ out1) {
  const int64_t nr = *num_rows;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool part = i == 0;
    bool later = false;
    if (i > 0) {
      const int64_t r = perm[i];
      const int64_t q = perm[i - 1];
      for (int key = 0; key < keys.nkeys; ++key) {
        if (key < keys.npart) {
          if (!part && !key_same(keys, key, r, q)) part = true;
        } else if (!part && !later && !key_same(keys, key, r, q)) {
          later = true;
        }
      }
    }
    if (mode == MODE_WINDOW) {
      part = part || i == nr;
      out0[i] = part;
      out1[i] = part || later;
    } else {
      out0[i] = (part || later) && i < nr;
    }
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// perm: [n] int64 sort permutation; num_rows: device int64 scalar;
// lanes / dtypes: host arrays of `nlanes` device pointers ([n] each, in
// original row order) and their dtype codes; key_null / key_first /
// key_count: host arrays of `nkeys` key descriptors; out0 (and out1 in
// WINDOW mode): [n] bool.
int key_change(const void* perm, int64_t n, const void* num_rows,
               const void* const* lanes, const int* dtypes, int nlanes,
               const int* key_null, const int* key_first,
               const int* key_count, int nkeys, int npart, int mode,
               void* out0, void* out1, void* stream) {
  if (nlanes < 0 || nlanes > MAX_LANES || nkeys < 0 || nkeys > MAX_KEYS
      || npart < 0 || npart > nkeys
      || (mode != MODE_WINDOW && mode != MODE_FIRST)
      || (mode == MODE_WINDOW && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  ChangeKeys k;
  for (int l = 0; l < nlanes; ++l) {
    if (dtypes[l] < DT_F64 || dtypes[l] > DT_F32)
      return (int)cudaErrorInvalidValue;
    k.lane[l] = lanes[l];
    k.dt[l] = dtypes[l];
  }
  for (int key = 0; key < nkeys; ++key) {
    if (key_null[key] >= nlanes || key_first[key] < 0
        || key_first[key] + key_count[key] > nlanes)
      return (int)cudaErrorInvalidValue;
    k.null_lane[key] = key_null[key];
    k.first[key] = key_first[key];
    k.count[key] = key_count[key];
  }
  k.nkeys = nkeys;
  k.npart = npart;
  int64_t blocks = (n + KC_THREADS - 1) / KC_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  key_change_kernel<<<(unsigned)blocks, KC_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int64_t*)perm, n, (const int64_t*)num_rows, k, mode,
      (uint8_t*)out0, (uint8_t*)out1);
  return (int)cudaGetLastError();
}

}  // extern "C"
