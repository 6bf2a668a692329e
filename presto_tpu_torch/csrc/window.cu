// K9 window_frame: one window function evaluated for every sorted row, and
// written to the row's original position.
//
// Replaces the per-function body of presto_tpu/ops/window.py:window_page
// (:126): the frame bounds of _frame_bounds (:73-123); row_number, rank,
// dense_rank (from a prefix of peer starts), ntile with the SQL remainder
// rule (:225-240), lag/lead with offset and default, first/last/nth_value,
// framed sum/count/count_star/avg with avg's DECIMAL descale (:300-305),
// and min/max: over a frame with one unbounded side from a running
// extreme (K7), over a frame bounded on both sides by folding [lo, hi]
// (the JAX package builds a sparse table, :340-383, for the same function;
// the frames of the repo's queries span a few rows). The result goes to
// out[perm[i]], which replaces the JAX package's argsort of the inverse
// permutation (:386) and the gather after it.
//
// Inputs per sorted row i (window.py builds them): the partition start
// and end and peer start and end positions (K7 fills of K8's flags); the
// argument column in original row order, read at perm[j]; aux_i, an int64
// prefix (live counts restarting at each partition start, or the running
// count of peer starts for dense_rank); aux_v, the frame sums' prefix
// (float64 or int64, restarting at each partition start, so a frame sum
// is aux_v[hi] - aux_v[lo - 1] within one partition) or the running or
// masked min/max array.
//
// One thread per sorted row, grid-stride. Bound on an H100: memory. A row
// reads 4-5 int64 positions and, by kind, 1-2 prefix values and its
// argument (a random read through perm), and writes its value and null
// flag at perm[i] (a random write: 32 B sectors for 1-9 B). A
// both-bounded min/max reads its frame's span of values.

#include <cuda_runtime.h>
#include <stdint.h>

#define WF_THREADS 256

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2, DT_BOOL = 3, DT_F32 = 4 };
enum {
  K_ROW_NUMBER = 0, K_RANK, K_DENSE_RANK, K_NTILE, K_LAG, K_LEAD,
  K_FIRST_VALUE, K_LAST_VALUE, K_NTH_VALUE, K_SUM, K_COUNT, K_COUNT_STAR,
  K_AVG, K_MIN, K_MAX
};
enum { B_UNB_PRECEDING = 0, B_PRECEDING, B_CURRENT, B_FOLLOWING,
       B_UNB_FOLLOWING };
enum { RUN_FROM_START = 0, RUN_TO_END = 1, FOLD_FRAME = 2 };

// packed parameters: the layout of ops/window.py (I_*, D_*, P_*)
enum { I_KIND = 0, I_MODE, I_START, I_START_N, I_END, I_END_N, I_PARAM,
       I_HAS_DEFAULT, I_VAL_DT, I_AUX_DT, I_OUT_DT, I_MINMAX, I_DEFAULT,
       I_SENTINEL, I_IS_MAX, N_IPARAMS };
enum { D_DEFAULT = 0, D_SENTINEL, D_AVG_DIV, N_DPARAMS };
enum { P_PERM = 0, P_NUM_ROWS, P_PS, P_PE, P_QS, P_QE, P_VALS, P_NULLS,
       P_AUX_I, P_AUX_V, P_OUT, P_OUT_NULLS, N_PTRS };

struct Spec {
  int64_t i[N_IPARAMS];
  double d[N_DPARAMS];
};

struct Ptrs {
  const int64_t* perm;
  const int64_t* num_rows;
  const int64_t* ps;
  const int64_t* pe;
  const int64_t* qs;
  const int64_t* qe;
  const void* vals;
  const uint8_t* nulls;
  const int64_t* aux_i;
  const void* aux_v;
  void* out;
  uint8_t* out_nulls;
};

// A value of any column dtype, kept as int64 or double.
struct Val {
  int64_t l;
  double d;
  bool is_f;
};

static __device__ __forceinline__ Val load_val(const void* v, int dt,
                                               int64_t i) {
  Val x{0, 0.0, false};
  switch (dt) {
    case DT_F64: x.d = ((const double*)v)[i]; x.is_f = true; break;
    case DT_F32: x.d = (double)((const float*)v)[i]; x.is_f = true; break;
    case DT_I64: x.l = ((const int64_t*)v)[i]; break;
    case DT_I32: x.l = ((const int32_t*)v)[i]; break;
    default: x.l = ((const uint8_t*)v)[i] ? 1 : 0; break;
  }
  return x;
}

// min/max that propagate NaN, as jnp.minimum / jnp.maximum
static __device__ __forceinline__ Val fold(Val a, Val b, bool is_max) {
  if (a.is_f) {
    if (a.d != a.d) return a;
    if (b.d != b.d) return b;
    return (is_max ? b.d > a.d : b.d < a.d) ? b : a;
  }
  return (is_max ? b.l > a.l : b.l < a.l) ? b : a;
}

static __device__ __forceinline__ int64_t clampi(int64_t a, int64_t n) {
  return a < 0 ? 0 : (a > n - 1 ? n - 1 : a);
}

static __device__ __forceinline__ void store(void* out, int dt, int64_t o,
                                             Val w) {
  switch (dt) {
    case DT_F64: ((double*)out)[o] = w.is_f ? w.d : (double)w.l; break;
    case DT_F32: ((float*)out)[o] = (float)(w.is_f ? w.d : (double)w.l);
      break;
    case DT_I64: ((int64_t*)out)[o] = w.is_f ? (int64_t)w.d : w.l; break;
    case DT_I32: ((int32_t*)out)[o] = (int32_t)(w.is_f ? (int64_t)w.d : w.l);
      break;
    default: ((uint8_t*)out)[o] = (w.is_f ? w.d != 0.0 : w.l != 0) ? 1 : 0;
  }
}

__global__ void window_frame_kernel(Ptrs p, Spec s, int64_t n) {
  const int64_t nr = *p.num_rows;
  const int kind = (int)s.i[I_KIND];
  const int val_dt = (int)s.i[I_VAL_DT];
  const int aux_dt = (int)s.i[I_AUX_DT];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t ps = p.ps[i], pe = p.pe[i];
    Val w{0, 0.0, false};
    bool wn = false;
    if (kind == K_ROW_NUMBER) {
      w.l = i - ps + 1;
    } else if (kind == K_RANK) {
      w.l = p.qs[i] - ps + 1;
    } else if (kind == K_DENSE_RANK) {
      w.l = p.aux_i[i] - p.aux_i[ps] + 1;
    } else if (kind == K_NTILE) {
      // SQL remainder rule: the first (psize mod buckets) buckets get one
      // extra row
      const int64_t buckets = s.i[I_PARAM];
      const int64_t psize = pe - ps + 1;
      const int64_t rn = i - ps;
      const int64_t base = psize / buckets;
      const int64_t rem = psize - base * buckets;
      const int64_t big = rem * (base + 1);
      w.l = rn < big ? rn / (base + 1 > 1 ? base + 1 : 1) + 1
                     : rem + (rn - big) / (base > 1 ? base : 1) + 1;
    } else if (kind == K_LAG || kind == K_LEAD) {
      const int64_t k = s.i[I_PARAM];
      const int64_t j = kind == K_LAG ? i - k : i + k;
      const bool inb = j >= ps && j <= pe;
      const int64_t r = p.perm[clampi(j, n)];
      w = load_val(p.vals, val_dt, r);
      wn = p.nulls[r] || !inb;
      if (s.i[I_HAS_DEFAULT] && !inb) {
        if (w.is_f) w.d = s.d[D_DEFAULT]; else w.l = s.i[I_DEFAULT];
        wn = false;
      }
    } else {
      // frame bounds, inclusive, in sorted positions
      int64_t lo, hi;
      if (s.i[I_MODE] == 0) {                       // ROWS
        switch ((int)s.i[I_START]) {
          case B_UNB_PRECEDING: lo = ps; break;
          case B_PRECEDING: lo = i - s.i[I_START_N]; break;
          case B_CURRENT: lo = i; break;
          default: lo = i + s.i[I_START_N]; break;
        }
        switch ((int)s.i[I_END]) {
          case B_UNB_FOLLOWING: hi = pe; break;
          case B_FOLLOWING: hi = i + s.i[I_END_N]; break;
          case B_CURRENT: hi = i; break;
          default: hi = i - s.i[I_END_N]; break;
        }
        lo = lo > ps ? lo : ps;
        hi = hi < pe ? hi : pe;
      } else {                                      // RANGE
        lo = s.i[I_START] == B_UNB_PRECEDING ? ps : p.qs[i];
        hi = s.i[I_END] == B_UNB_FOLLOWING ? pe : p.qe[i];
      }
      if (kind == K_FIRST_VALUE || kind == K_LAST_VALUE
          || kind == K_NTH_VALUE) {
        const int64_t pos = kind == K_FIRST_VALUE ? lo
                          : kind == K_LAST_VALUE ? hi
                          : lo + s.i[I_PARAM] - 1;
        const bool empty = lo > hi || pos < lo || pos > hi;
        const int64_t r = p.perm[clampi(pos, n)];
        w = load_val(p.vals, val_dt, r);
        wn = p.nulls[r] || empty;
      } else {
        // live rows in the frame; the prefixes restart at ps <= lo
        const bool empty = lo > hi;
        const int64_t cnt = empty ? 0
            : p.aux_i[hi] - (lo > ps ? p.aux_i[lo - 1] : 0);
        if (kind == K_COUNT || kind == K_COUNT_STAR) {
          w.l = cnt;
        } else if (kind == K_SUM || kind == K_AVG) {
          Val total{0, 0.0, aux_dt == DT_F64};
          if (!empty) {
            const Val top = load_val(p.aux_v, aux_dt, hi);
            const Val before = lo > ps ? load_val(p.aux_v, aux_dt, lo - 1)
                                       : Val{0, 0.0, top.is_f};
            if (total.is_f) total.d = top.d - before.d;
            else total.l = (int64_t)((uint64_t)top.l - (uint64_t)before.l);
          }
          if (kind == K_SUM) {
            w = total;
          } else {
            w.is_f = true;
            w.d = total.d / (double)(cnt > 1 ? cnt : 1);
            if (s.d[D_AVG_DIV] != 1.0) w.d = w.d / s.d[D_AVG_DIV];
          }
          wn = cnt == 0;
        } else {                                    // K_MIN, K_MAX
          const int mode = (int)s.i[I_MINMAX];
          if (mode == RUN_FROM_START) {
            w = load_val(p.aux_v, aux_dt, clampi(hi, n));
          } else if (mode == RUN_TO_END) {
            w = load_val(p.aux_v, aux_dt, clampi(lo, n));
          } else {
            const bool is_max = s.i[I_IS_MAX] != 0;
            w = load_val(p.aux_v, aux_dt, clampi(lo, n));
            for (int64_t j = lo + 1; j <= hi; ++j)
              w = fold(w, load_val(p.aux_v, aux_dt, j), is_max);
          }
          wn = cnt == 0;
        }
      }
    }
    wn = wn || i >= nr;
    const int64_t o = p.perm[i];
    const int out_dt = (int)s.i[I_OUT_DT];
    if (wn) {
      Val sent{s.i[I_SENTINEL], s.d[D_SENTINEL],
               out_dt == DT_F64 || out_dt == DT_F32};
      if (out_dt == DT_BOOL) sent = Val{0, 0.0, false};
      store(p.out, out_dt, o, sent);
    } else {
      store(p.out, out_dt, o, w);
    }
    p.out_nulls[o] = wn ? 1 : 0;
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ptrs: host array of N_PTRS device pointers (P_*; null where a function
// does not read one); iparams / dparams: host arrays of the packed scalar
// parameters (I_*, D_*); n: the page capacity.
int window_frame(const void* const* ptrs, const int64_t* iparams,
                 const double* dparams, int64_t n, void* stream) {
  if (n <= 0) return 0;
  Spec s;
  for (int k = 0; k < N_IPARAMS; ++k) s.i[k] = iparams[k];
  for (int k = 0; k < N_DPARAMS; ++k) s.d[k] = dparams[k];
  const int kind = (int)s.i[I_KIND];
  if (kind < K_ROW_NUMBER || kind > K_MAX
      || s.i[I_OUT_DT] < DT_F64 || s.i[I_OUT_DT] > DT_F32)
    return (int)cudaErrorInvalidValue;
  if (kind == K_NTILE && s.i[I_PARAM] <= 0) return (int)cudaErrorInvalidValue;
  Ptrs p;
  p.perm = (const int64_t*)ptrs[P_PERM];
  p.num_rows = (const int64_t*)ptrs[P_NUM_ROWS];
  p.ps = (const int64_t*)ptrs[P_PS];
  p.pe = (const int64_t*)ptrs[P_PE];
  p.qs = (const int64_t*)ptrs[P_QS];
  p.qe = (const int64_t*)ptrs[P_QE];
  p.vals = ptrs[P_VALS];
  p.nulls = (const uint8_t*)ptrs[P_NULLS];
  p.aux_i = (const int64_t*)ptrs[P_AUX_I];
  p.aux_v = ptrs[P_AUX_V];
  p.out = (void*)ptrs[P_OUT];
  p.out_nulls = (uint8_t*)ptrs[P_OUT_NULLS];
  const bool needs_vals = kind == K_LAG || kind == K_LEAD
                          || kind == K_FIRST_VALUE || kind == K_LAST_VALUE
                          || kind == K_NTH_VALUE;
  const bool needs_aux_i = kind == K_DENSE_RANK || kind >= K_SUM;
  const bool needs_aux_v = kind == K_SUM || kind == K_AVG || kind == K_MIN
                           || kind == K_MAX;
  if (!p.perm || !p.num_rows || !p.ps || !p.pe || !p.qs || !p.qe || !p.out
      || !p.out_nulls || (needs_vals && (!p.vals || !p.nulls))
      || (needs_aux_i && !p.aux_i) || (needs_aux_v && !p.aux_v))
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + WF_THREADS - 1) / WF_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  window_frame_kernel<<<(unsigned)blocks, WF_THREADS, 0,
                        (cudaStream_t)stream>>>(p, s, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
