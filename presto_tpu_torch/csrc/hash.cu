// K4 hash_columns: combined 64-bit hash of a row's key columns.
//
// Replaces presto_tpu/ops/keys.py:hash_columns (:211) with _mix64 (:205)
// and f64_hash_lanes (:107). For each key lane, in order:
//   v = the lane's value as uint64 (integers sign-extended, booleans 0/1,
//       floats through the exponent/mantissa split of f64_hash_lanes),
//       or the NULL tag 0x5BD1E995 where the lane is NULL;
//   h = mix64(h ^ (v + GOLDEN + (h << 6) + (h >> 2)))   (splitmix64 mix);
// and the result is h masked to a non-negative int64. The JAX function
// works in uint64 too, so integer, boolean and dictionary-coded keys give
// its exact value. The float lane takes floor(log2|v|) with CUDA's log2,
// which may differ from XLA's by an ulp at a power-of-two boundary: float
// keys are promised only to hash equal when they are equal (NaN = NaN,
// -0.0 = +0.0, subnormals = 0.0: a float64 subnormal is flushed to zero
// first, as XLA's CPU code does in the JAX function).
//
// One thread per row, grid-stride; the lane descriptors (at most
// MAX_LANES) are passed by value. Bound on an H100: memory. Each row reads
// its key values (4-8 B) and null flags (1 B) per lane and writes 8 B;
// the mix is a few integer multiplies per lane, far below the card's
// integer rate.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#define MAX_LANES 16   // = ops/keys.MAX_KEY_LANES
#define HASH_THREADS 256

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_BOOL = 3, DT_F32 = 4 };

static const uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
static const uint64_t NULL_TAG = 0x5BD1E995ull;
// the smallest normal float64; smaller magnitudes hash as zero
#define F64_MIN_NORMAL 2.2250738585072014e-308

struct Lanes {
  const void* values[MAX_LANES];
  const uint8_t* nulls[MAX_LANES];
  int dtype[MAX_LANES];
  int count;
};

static __device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

static __device__ __forceinline__ uint64_t f64_hash_lane(double v) {
  if (fabs(v) < F64_MIN_NORMAL) v = 0.0;
  const bool is_nan = isnan(v);
  const bool is_inf = isinf(v);
  const double safe = (is_nan || is_inf) ? 1.0 : v;
  const double ae = fmax(fabs(safe), 1e-300);
  const double e = floor(log2(ae));
  const double norm = ae * exp2(-e);
  const double m = fmin(fmax(norm - 1.0, 0.0), 1.0) * 4294967296.0;
  const uint64_t mant = (uint64_t)m;
  const uint64_t eb = (uint64_t)((int64_t)e + 2048);
  uint64_t h = (eb * GOLDEN) ^ mant;
  if (v < 0) h ^= 0xA5A5A5A5DEADBEEFull;
  if (v == 0.0) h = 0x5E5E0000ull;
  if (is_nan) h = 0x7FF8000000000001ull;
  if (is_inf && v > 0) h = 0x7FF0000000000000ull;
  if (is_inf && v < 0) h = 0xFFF0000000000000ull;
  return h;
}

static __device__ __forceinline__ uint64_t lane_bits(const void* values,
                                                     int dtype, int64_t i) {
  switch (dtype) {
    case DT_F64: return f64_hash_lane(((const double*)values)[i]);
    case DT_F32: return f64_hash_lane((double)((const float*)values)[i]);
    case DT_I64: return (uint64_t)((const int64_t*)values)[i];
    case DT_I32: return (uint64_t)(int64_t)((const int32_t*)values)[i];
    default: return ((const uint8_t*)values)[i] ? 1ull : 0ull;
  }
}

__global__ void hash_columns_kernel(Lanes lanes, int64_t n,
                                    int64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t h = 0;
    for (int k = 0; k < lanes.count; ++k) {
      const uint64_t v = lanes.nulls[k][i]
                             ? NULL_TAG
                             : lane_bits(lanes.values[k], lanes.dtype[k], i);
      h = mix64(h ^ (v + GOLDEN + (h << 6) + (h >> 2)));
    }
    out[i] = (int64_t)(h & 0x7FFFFFFFFFFFFFFFull);
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// values / nulls: host arrays of `count` device pointers (the key lanes and
// their bool null flags, each [n]); dtypes: host array of lane dtype codes;
// out: [n] int64.
int hash_columns(const void* const* values, const int* dtypes,
                 const void* const* nulls, int count, int64_t n, void* out,
                 void* stream) {
  if (count < 1 || count > MAX_LANES) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Lanes lanes;
  for (int k = 0; k < count; ++k) {
    if (dtypes[k] < DT_F64 || dtypes[k] > DT_F32)
      return (int)cudaErrorInvalidValue;
    lanes.values[k] = values[k];
    lanes.nulls[k] = (const uint8_t*)nulls[k];
    lanes.dtype[k] = dtypes[k];
  }
  lanes.count = count;
  int64_t blocks = (n + HASH_THREADS - 1) / HASH_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  hash_columns_kernel<<<(unsigned)blocks, HASH_THREADS, 0,
                        (cudaStream_t)stream>>>(lanes, n, (int64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
