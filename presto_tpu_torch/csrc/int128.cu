// K10 int128_op: one elementwise DECIMAL(38) operation per launch.
//
// Replaces the 128-bit limb arithmetic of presto_tpu/data/int128.py
// (:26-212) as presto_tpu/expr/compile.py composes it: `_wide_lanes` (:454,
// a rescale by 10^k: multiply with the 2^127 overflow flag, or divide
// HALF_UP), `_arith_wide` (:581, add/subtract/multiply with the 10^38-1
// bound), `_compare` (:477), negate/abs (:740-758) and `_cast_wide` (:250,
// to double and to int64 with its range check).
//
// Layout, as in the JAX package: an operand is int64 narrow values (an
// unscaled DECIMAL(<=18) or an integer) or four int64 limb lanes
// v = l3*2^96 + l2*2^64 + l1*2^32 + l0, any int64 per lane. Each thread
// loads a row, carry-normalizes it to (t3 signed int64, n2, n1, n0 in
// [0, 2^32)), and computes:
//   - rescale by 10^k, k > 0: the magnitude as unsigned __int128 times
//     10^k, flagged when the true product reaches 2^127 (the reference's
//     `mul` flags exactly that: its top limb reaching 2^31);
//   - rescale by 10^-k: limb long division by <= 10^9 chunks (64-bit
//     dividends, no 128-bit division), remainders composed in __int128,
//     rounded HALF_UP away from zero;
//   - add/subtract: lane-wise int64 then normalize, exact for any lanes;
//   - multiply: 64x64-bit partial products of the two magnitudes, flagged
//     where the product reaches 2^127;
//   - compare: lexicographic over the normalized lanes, exact for any
//     lanes.
// A value whose normalized top lane leaves int32 (magnitude >= 2^127, only
// a sum can hold one) takes the exact lane paths; multiplying or upscaling
// it flags an overflow. Results are written as normalized limbs. A row's
// flags are ORed into one device error word (atomicOr, only on a flagged
// valid row) and, if asked, written per row.
//
// Bound on an H100: memory. A multiply of two narrow operands reads 16 B
// and writes 32 B per row; of a wide and a narrow operand, 40 B read. The
// arithmetic is a few dozen 64-bit integer operations per row.

#include <cuda_runtime.h>
#include <stdint.h>

#define I128_THREADS 256
#define M32 0xFFFFFFFFll

typedef unsigned __int128 u128;

enum { OP_RESCALE = 0, OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_CMP = 4,
       OP_NEG = 5, OP_ABS = 6, OP_TO_F64 = 7, OP_TO_I64 = 8 };

// = data/int128.py ERR_DECIMAL / ERR_CAST (expr/errors.py codes)
#define ERR_DECIMAL 256
#define ERR_CAST 128

// Mirrored field for field by presto_tpu_torch/data/int128.py
// (_Int128Args).
struct Int128Args {
  int64_t n;
  const int64_t* x[4];     // nx == 1: x[0] narrow values; nx == 4: lanes
  const int64_t* y[4];
  const uint8_t* valid;    // rows whose flags count, or null: none count
  const uint8_t* zero;     // rows whose result lanes are zeroed, or null
  void* out[4];
  unsigned long long* err; // device word, flag bits ORed in
  int32_t* row_err;        // per-row flag bits, or null
  int64_t lo, hi;          // to_int64 range
  double div;              // to_double: the image is divided by this
  uint64_t x_pow[2];       // 10^|x_shift| as (low, high) 64-bit halves
  uint64_t y_pow[2];
  int32_t op;
  int32_t nx, ny;
  int32_t x_shift, y_shift;
};

// A normalized value: t3 signed, n2..n0 in [0, 2^32).
struct Wide {
  long long t3, n2, n1, n0;
};

static __device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

static __device__ __forceinline__ Wide normalize(long long l3, long long l2,
                                                 long long l1, long long l0) {
  Wide w;
  w.n0 = l0 & M32;
  const long long t1 = wadd(l1, l0 >> 32);
  w.n1 = t1 & M32;
  const long long t2 = wadd(l2, t1 >> 32);
  w.n2 = t2 & M32;
  w.t3 = wadd(l3, t2 >> 32);
  return w;
}

static __device__ __forceinline__ Wide negate(const Wide& v) {
  return normalize(-(unsigned long long)v.t3, -v.n2, -v.n1, -v.n0);
}

static __device__ __forceinline__ Wide load(const int64_t* const* p, int k,
                                            int64_t i) {
  if (k == 1) {
    const long long v = p[0][i];
    const long long s = v >> 63;
    Wide w = {s, s & M32, (v >> 32) & M32, v & M32};
    return w;
  }
  return normalize(p[0][i], p[1][i], p[2][i], p[3][i]);
}

static __device__ __forceinline__ bool is_zero(const Wide& v) {
  return (v.t3 | v.n2 | v.n1 | v.n0) == 0;
}

// |v| as normalized lanes (m3 >= 0); returns whether v < 0
static __device__ __forceinline__ bool magnitude(const Wide& v, Wide* m) {
  const bool neg = v.t3 < 0;
  *m = neg ? negate(v) : v;
  return neg;
}

// the magnitude fits unsigned 128 bits
static __device__ __forceinline__ bool fits_u128(const Wide& m) {
  return m.t3 < (1ll << 32);
}

static __device__ __forceinline__ u128 to_u128(const Wide& m) {
  return ((u128)(unsigned long long)m.t3 << 96)
         | ((u128)(unsigned long long)m.n2 << 64)
         | ((u128)(unsigned long long)m.n1 << 32)
         | (u128)(unsigned long long)m.n0;
}

// sign * r as normalized lanes, for a magnitude r < 2^128
static __device__ __forceinline__ Wide from_mag(u128 r, bool neg) {
  Wide m = {(long long)(unsigned long long)(r >> 96),
            (long long)((unsigned long long)(r >> 64) & M32),
            (long long)((unsigned long long)(r >> 32) & M32),
            (long long)((unsigned long long)r & M32)};
  return neg ? negate(m) : m;
}

// a * b for magnitudes below 2^128: the low 128 bits, and whether the
// true product reaches 2^127
static __device__ __forceinline__ u128 mul_mag(u128 a, u128 b, bool* ovf) {
  const unsigned long long al = (unsigned long long)a;
  const unsigned long long ah = (unsigned long long)(a >> 64);
  const unsigned long long bl = (unsigned long long)b;
  const unsigned long long bh = (unsigned long long)(b >> 64);
  const u128 lo = (u128)al * bl;
  // with ah and bh both nonzero the product is >= 2^128; otherwise at
  // most one cross term is nonzero and it fits 128 bits
  const u128 cross = (u128)al * bh + (u128)ah * bl;
  const u128 r = lo + (cross << 64);
  *ovf = (ah != 0 && bh != 0) || (cross >> 64) != 0 || r < lo
         || (r >> 127) != 0;
  return r;
}

static __device__ __forceinline__ u128 pow_of(const uint64_t* p) {
  return ((u128)p[1] << 64) | (u128)p[0];
}

// v * 10^k (k > 0), flagging a product whose magnitude reaches 2^127
static __device__ Wide upscale(const Wide& v, u128 p10, bool* ovf) {
  Wide m;
  const bool neg = magnitude(v, &m);
  if (!fits_u128(m)) {           // |v| >= 2^128 and 10^k > 1
    *ovf = true;
    Wide z = {0, 0, 0, 0};
    return z;
  }
  bool o = false;
  const u128 r = mul_mag(to_u128(m), p10, &o);
  *ovf = *ovf || o;
  return from_mag(r, neg);
}

// v / 10^k rounded HALF_UP away from zero (k > 0)
static __device__ Wide downscale(const Wide& v, int k, u128 p10) {
  Wide m;
  const bool neg = magnitude(v, &m);
  unsigned long long q3 = (unsigned long long)m.t3;
  unsigned long long q2 = m.n2, q1 = m.n1, q0 = m.n0;
  u128 rem = 0, mult = 1;
  for (int left = k; left > 0;) {
    const int step = left < 9 ? left : 9;
    unsigned long long d = 1;
    for (int j = 0; j < step; ++j) d *= 10;
    // q3 may exceed 32 bits; every later dividend is < d * 2^32 < 2^62
    unsigned long long r = q3 % d;
    q3 /= d;
    unsigned long long cur = (r << 32) | q2;
    q2 = cur / d;
    r = cur % d;
    cur = (r << 32) | q1;
    q1 = cur / d;
    r = cur % d;
    cur = (r << 32) | q0;
    q0 = cur / d;
    r = cur % d;
    rem += (u128)r * mult;       // floor division composes; so do remainders
    mult *= d;
    left -= step;
  }
  const long long up = (rem << 1) >= p10 ? 1 : 0;
  const Wide q = normalize((long long)q3, (long long)q2, (long long)q1,
                           (long long)q0 + up);
  return neg ? negate(q) : q;
}

static __device__ __forceinline__ Wide rescale(const Wide& v, int k,
                                               const uint64_t* pow,
                                               bool* ovf) {
  if (k > 0) return upscale(v, pow_of(pow), ovf);
  if (k < 0) return downscale(v, -k, pow_of(pow));
  return v;
}

// |v| > 10^38 - 1
static __device__ __forceinline__ bool exceeds_dec38(const Wide& v) {
  Wide m;
  magnitude(v, &m);
  if (!fits_u128(m)) return true;
  const u128 lim = ((u128)0x4B3B4CA85A86C47Aull << 64)
                   | (u128)0x098A223FFFFFFFFFull;
  return to_u128(m) > lim;
}

static __device__ __forceinline__ int compare(const Wide& a, const Wide& b) {
  if (a.t3 != b.t3) return a.t3 < b.t3 ? -1 : 1;
  if (a.n2 != b.n2) return a.n2 < b.n2 ? -1 : 1;
  if (a.n1 != b.n1) return a.n1 < b.n1 ? -1 : 1;
  if (a.n0 != b.n0) return a.n0 < b.n0 ? -1 : 1;
  return 0;
}

__global__ void int128_kernel(const Int128Args a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    bool dec = false, cast = false;
    const Wide x = load(a.x, a.nx, i);
    Wide r = {0, 0, 0, 0};
    switch (a.op) {
      case OP_RESCALE:
        r = rescale(x, a.x_shift, a.x_pow, &dec);
        break;
      case OP_ADD:
      case OP_SUB: {
        const Wide xr = rescale(x, a.x_shift, a.x_pow, &dec);
        const Wide yr = rescale(load(a.y, a.ny, i), a.y_shift, a.y_pow, &dec);
        r = a.op == OP_ADD
                ? normalize(wadd(xr.t3, yr.t3), xr.n2 + yr.n2, xr.n1 + yr.n1,
                            xr.n0 + yr.n0)
                : normalize(wadd(xr.t3, -(unsigned long long)yr.t3),
                            xr.n2 - yr.n2, xr.n1 - yr.n1, xr.n0 - yr.n0);
        dec = dec || exceeds_dec38(r);
        break;
      }
      case OP_MUL: {
        const Wide xr = rescale(x, a.x_shift, a.x_pow, &dec);
        const Wide yr = rescale(load(a.y, a.ny, i), a.y_shift, a.y_pow, &dec);
        Wide xm, ym;
        const bool neg = magnitude(xr, &xm) != magnitude(yr, &ym);
        if (!fits_u128(xm) || !fits_u128(ym)) {
          dec = dec || !(is_zero(xm) || is_zero(ym));
        } else {
          bool o = false;
          r = from_mag(mul_mag(to_u128(xm), to_u128(ym), &o), neg);
          dec = dec || o || exceeds_dec38(r);
        }
        break;
      }
      case OP_CMP: {
        const Wide xr = rescale(x, a.x_shift, a.x_pow, &dec);
        const Wide yr = rescale(load(a.y, a.ny, i), a.y_shift, a.y_pow, &dec);
        ((int8_t*)a.out[0])[i] = (int8_t)compare(xr, yr);
        break;
      }
      case OP_NEG:
        r = negate(x);
        break;
      case OP_ABS:
        r = x.t3 < 0 ? negate(x) : x;
        break;
      case OP_TO_F64: {
        // the float image of the operand's own lanes, summed in the
        // reference's order
        double img;
        if (a.nx == 1) {
          img = (double)x.t3 * 0x1p96 + (double)x.n2 * 0x1p64
                + (double)x.n1 * 0x1p32 + (double)x.n0;
        } else {
          img = (double)a.x[0][i] * 0x1p96 + (double)a.x[1][i] * 0x1p64
                + (double)a.x[2][i] * 0x1p32 + (double)a.x[3][i];
        }
        ((double*)a.out[0])[i] = img / a.div;
        break;
      }
      default: {  // OP_TO_I64
        const Wide xr = rescale(x, a.x_shift, a.x_pow, &dec);
        const long long v = (long long)(((unsigned long long)xr.n1 << 32)
                                        | (unsigned long long)xr.n0);
        const long long sign = v >> 63;
        cast = xr.t3 != sign || xr.n2 != (sign & M32) || v < a.lo
               || v > a.hi;
        ((long long*)a.out[0])[i] = v;
        break;
      }
    }
    if (a.op <= OP_MUL || a.op == OP_NEG || a.op == OP_ABS) {
      const bool z = a.zero != nullptr && a.zero[i];
      ((long long*)a.out[0])[i] = z ? 0 : r.t3;
      ((long long*)a.out[1])[i] = z ? 0 : r.n2;
      ((long long*)a.out[2])[i] = z ? 0 : r.n1;
      ((long long*)a.out[3])[i] = z ? 0 : r.n0;
    }
    const int bits = (dec ? ERR_DECIMAL : 0) | (cast ? ERR_CAST : 0);
    if (a.row_err != nullptr) a.row_err[i] = bits;
    if (bits && a.valid != nullptr && a.valid[i])
      atomicOr(a.err, (unsigned long long)bits);
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// args: host pointer to the argument block.
int int128_op(const void* args, void* stream) {
  const Int128Args& a = *(const Int128Args*)args;
  if (a.n < 0 || a.op < OP_RESCALE || a.op > OP_TO_I64
      || (a.nx != 1 && a.nx != 4))
    return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  int64_t blocks = (a.n + I128_THREADS - 1) / I128_THREADS;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  int128_kernel<<<(unsigned)blocks, I128_THREADS, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // extern "C"
