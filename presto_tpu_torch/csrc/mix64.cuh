// The 64-bit mix and the float64 hash lane of the JAX package's key hash
// (presto_tpu/ops/keys.py `_mix64` :205 and `f64_hash_lanes` :107),
// shared by K4 (hash.cu) and K12 (hll.cu).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

static const uint64_t GOLDEN = 0x9E3779B97F4A7C15ull;
// the smallest normal float64; smaller magnitudes hash as zero
#define F64_MIN_NORMAL 2.2250738585072014e-308

// splitmix64's finalizer
static __device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// A float64's hash input: an exponent lane from floor(log2|v|) and the top
// 32 mantissa bits taken arithmetically, with fixed tags for NaN, +-inf and
// +-0 (subnormals flushed to zero first, as XLA's CPU code does). log2 may
// differ from XLA's by an ulp just below a power of two.
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
