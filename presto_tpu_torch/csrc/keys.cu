// K8 key_change: adjacent-compare boundary flags over rows taken in a
// sort permutation's order.
//
// Replaces the boundary compares of presto_tpu/ops/window.py:171-195
// (`changed`: partition starts, peer starts, the valid -> padding edge at
// :191) and the first-occurrence flags of
// presto_tpu/ops/mark_distinct.py:47-51. The JAX package gathers every key
// lane into sorted order and builds the flags with 3L+ elementwise passes
// (roll, ==, |) over L lanes; here one pass reads each lane's value at
// every row perm[i] once and writes the flags.
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
// A warp takes a run of 32 * KC_RUN consecutive sorted positions, striped:
// lane l takes positions base + 32k + l, k < KC_RUN, so each load and
// store of the warp touches 32 consecutive entries, and where the rows
// come in order (a page already sorted by its keys) the gathers coalesce
// too. A thread loads its KC_RUN perm entries, then takes the key lanes
// one after another: it issues the lane's KC_RUN gathers before it
// compares any (a position's compare has no early exit, so no load waits
// on another), and a lane's value is read once: the value at the position
// before comes from lane l - 1 (lane 0: from lane 31 of the stripe
// before) by shuffle, and only the warp's first position gathers its
// predecessor once more. Each value becomes a word (64 bits for an 8-byte
// lane, else 32) whose equality is the key's (floats: every NaN one word,
// zeros and subnormals 0), so the compares take no dtype switch; the
// dtype picks only the width of the gathers and words, once a lane. Once every position of the warp's run starts
// a partition or changes a key, the later keys change no flag, and the
// warp reads none of their lanes (rows in key order whose first key
// changes at every row read half the lanes).
//
// Bound on an H100: memory. The work reads perm (8 B a position) and each
// lane's value at every row (1-8 B), and writes 1-2 B of flags. Where the
// permutation scatters the rows, each gather moves a 32 B sector from L2
// or device memory: 32 B a lane a position, 4-32 times the value's bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LANES 32   // = ops/keys.MAX_CHANGE_LANES
#define MAX_KEYS 32
#define KC_THREADS 256
#define KC_RUN 8                    // positions a thread takes, 32 apart
#define KC_WARP_RUN (32 * KC_RUN)   // positions a warp takes
#define KC_ALL ((1u << KC_RUN) - 1)
#define FULL 0xffffffffu

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_BOOL = 3, DT_F32 = 4 };
enum { MODE_WINDOW = 0, MODE_FIRST = 1 };

// a lane's role in its key
#define R_NULL 1   // the key's null lane
#define R_END 2    // the key's last lane
#define R_PART 4   // a lane of one of the first npart keys

// the smallest normal float64; smaller magnitudes compare as zero
#define F64_MIN_NORMAL 2.2250738585072014e-308

struct ChangeKeys {
  const void* lane[MAX_LANES];
  int dt[MAX_LANES];
  int role[MAX_LANES];
  int nlanes;
};

// the values at rows[0 .. KC_RUN) of a lane, raw bits zero-extended
static __device__ __forceinline__ void gather(const void* p, int dt,
                                              const int64_t* rows,
                                              uint64_t* w) {
  if (dt == DT_F64 || dt == DT_I64) {
#pragma unroll
    for (int k = 0; k < KC_RUN; ++k)
      w[k] = __ldg((const unsigned long long*)p + rows[k]);
  } else if (dt == DT_I32 || dt == DT_F32) {
#pragma unroll
    for (int k = 0; k < KC_RUN; ++k)
      w[k] = __ldg((const unsigned*)p + rows[k]);
  } else {
#pragma unroll
    for (int k = 0; k < KC_RUN; ++k)
      w[k] = __ldg((const unsigned char*)p + rows[k]);
  }
}

static __device__ __forceinline__ uint64_t gather1(const void* p, int dt,
                                                   int64_t row) {
  if (dt == DT_F64 || dt == DT_I64)
    return __ldg((const unsigned long long*)p + row);
  if (dt == DT_I32 || dt == DT_F32) return __ldg((const unsigned*)p + row);
  return __ldg((const unsigned char*)p + row);
}

// Words whose equality is the value's: integers as they are; floats with
// every NaN one word and zeros (and float64 subnormals) 0. An 8-byte lane
// takes 64-bit words, the others 32-bit ones, so that their shuffles move
// half as much.
static __device__ __forceinline__ uint64_t canon64(uint64_t w, int dt) {
  if (dt != DT_F64) return w;
  const double x = __longlong_as_double((long long)w);
  if (fabs(x) < F64_MIN_NORMAL) return 0;
  if (x != x) return 0x7ff8000000000000ull;
  return w;
}

static __device__ __forceinline__ uint32_t canon32(uint64_t w, int dt) {
  if (dt != DT_F32) return (uint32_t)w;
  const float x = __uint_as_float((unsigned)w);
  if (x == 0.0f) return 0;
  if (x != x) return 0x7fc00000u;
  return (uint32_t)w;
}

// Over a warp's striped run of one lane, words c[k] at positions
// base + 32k + lane: bit k of *d where the word differs from the one at
// the position before, of *rb where the word is not 0, of *qb where the
// word before is not 0. The word before comes from lane - 1 (lane 0:
// from lane 31 of the stripe before, which lane 31 sends in place of its
// own, or for k = 0 `before`): one shuffle a word.
template <typename W>
static __device__ __forceinline__ void compare_run(const W* c, W before,
                                                   unsigned* d, unsigned* rb,
                                                   unsigned* qb) {
  const int lane = threadIdx.x & 31;
  unsigned dd = 0, r = 0, qq = 0;
#pragma unroll
  for (int k = 0; k < KC_RUN; ++k) {
    const W send = lane == 31 && k > 0 ? c[k - 1] : c[k];
    W q = __shfl_sync(FULL, send, (lane + 31) & 31);
    if (lane == 0 && k == 0) q = before;
    dd |= (unsigned)(c[k] != q) << k;
    r |= (unsigned)(c[k] != 0) << k;
    qq |= (unsigned)(q != 0) << k;
  }
  *d = dd;
  *rb = r;
  *qb = qq;
}

__global__ void __launch_bounds__(KC_THREADS)
key_change_kernel(const int64_t* __restrict__ perm, int64_t n,
                  const int64_t* num_rows, ChangeKeys keys, int mode,
                  uint8_t* __restrict__ out0, uint8_t* __restrict__ out1) {
  const int lane = threadIdx.x & 31;
  const int64_t base = ((int64_t)blockIdx.x * (KC_THREADS / 32)
                        + (threadIdx.x >> 5)) * KC_WARP_RUN;
  // the rows at positions base + 32k + lane (row 0 past n: every lane
  // joins the shuffles), and for lane 0 the row before the warp's run
  int64_t rows[KC_RUN];
#pragma unroll
  for (int k = 0; k < KC_RUN; ++k) {
    const int64_t i = base + 32 * k + lane;
    rows[k] = i < n ? __ldg((const long long*)perm + i) : 0;
  }
  const int64_t prev = lane == 0 && base > 0 && base <= n
                       ? __ldg((const long long*)perm + base - 1) : 0;

  // bits k, one a position base + 32k + lane: the position starts a
  // partition or changes a key; where no key can change the flags (row 0,
  // past n)
  unsigned part = 0, later = 0, settled = 0;
#pragma unroll
  for (int k = 0; k < KC_RUN; ++k) {
    const int64_t i = base + 32 * k + lane;
    if (i == 0 || i >= n) settled |= 1u << k;
  }
  unsigned nul_r = 0, nul_q = 0;    // the current key's null bits at the
  unsigned diff = 0;                // rows and at the positions before;
                                    // a value lane differs
  for (int l = 0; l < keys.nlanes; ++l) {
    const int dt = keys.dt[l];
    uint64_t w[KC_RUN];
    gather(keys.lane[l], dt, rows, w);
    const uint64_t before = lane == 0 ? gather1(keys.lane[l], dt, prev) : 0;
    unsigned d, rb, qb;
    if (dt == DT_F64 || dt == DT_I64) {
      uint64_t c[KC_RUN];
#pragma unroll
      for (int k = 0; k < KC_RUN; ++k) c[k] = canon64(w[k], dt);
      compare_run(c, canon64(before, dt), &d, &rb, &qb);
    } else {
      uint32_t c[KC_RUN];
#pragma unroll
      for (int k = 0; k < KC_RUN; ++k) c[k] = canon32(w[k], dt);
      compare_run(c, canon32(before, dt), &d, &rb, &qb);
    }
    const int role = keys.role[l];
    if (role & R_NULL) {
      nul_r = rb;
      nul_q = qb;
    } else {
      diff |= d;
    }
    if (role & R_END) {
      const unsigned ch = (nul_r ^ nul_q) | (~nul_r & ~nul_q & diff);
      if (role & R_PART)
        part |= ch;
      else
        later |= ch;
      nul_r = nul_q = diff = 0;
      // once every position of the warp's run is a start or a change, the
      // keys after this one change no flag: the warp skips their lanes
      if (__all_sync(FULL, ((part | later | settled) & KC_ALL) == KC_ALL))
        break;
    }
  }

  const int64_t nr = *num_rows;
#pragma unroll
  for (int k = 0; k < KC_RUN; ++k) {
    const int64_t i = base + 32 * k + lane;
    if (i < n) {
      const bool start = i == 0 || ((part >> k) & 1u);
      const bool change = ((later >> k) & 1u) != 0;
      if (mode == MODE_WINDOW) {
        const bool p = start || i == nr;
        out0[i] = p;
        out1[i] = p || change;
      } else {
        out0[i] = (start || change) && i < nr;
      }
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
// key_count: host arrays of `nkeys` key descriptors (a key's null lane, if
// any, comes just before its value lanes; a key without lanes never
// changes); out0 (and out1 in WINDOW mode): [n] bool.
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
    k.role[l] = -1;
  }
  for (int key = 0; key < nkeys; ++key) {
    const int nl = key_null[key], first = key_first[key];
    const int count = key_count[key];
    if (count < 0 || first < 0 || first + count > nlanes
        || (nl >= 0 && nl != first - 1))
      return (int)cudaErrorInvalidValue;
    const int part = key < npart ? R_PART : 0;
    const int lo = nl >= 0 ? nl : first;
    for (int l = lo; l < first + count; ++l) {
      if (k.role[l] != -1) return (int)cudaErrorInvalidValue;
      k.role[l] = part | (l == nl ? R_NULL : 0)
                  | (l == first + count - 1 ? R_END : 0);
    }
  }
  for (int l = 0; l < nlanes; ++l)
    if (k.role[l] == -1) return (int)cudaErrorInvalidValue;
  k.nlanes = nlanes;
  const int64_t warps = (n + KC_WARP_RUN - 1) / KC_WARP_RUN;
  const int64_t blocks = (warps + KC_THREADS / 32 - 1) / (KC_THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  key_change_kernel<<<(unsigned)blocks, KC_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int64_t*)perm, n, (const int64_t*)num_rows, k, mode,
      (uint8_t*)out0, (uint8_t*)out1);
  return (int)cudaGetLastError();
}

}  // extern "C"
