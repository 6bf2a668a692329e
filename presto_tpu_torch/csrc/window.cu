// K9 window_frame: one window function evaluated for every sorted row, and
// written to the row's original position.
//
// Replaces the per-function body of presto_tpu/ops/window.py:window_page
// (:126): the frame bounds of _frame_bounds (:73-123); row_number, rank,
// dense_rank (from a prefix of peer starts), ntile with the SQL remainder
// rule (:225-240), lag/lead with offset and default, first/last/nth_value,
// framed sum/count/count_star/avg with avg's DECIMAL descale (:300-305),
// and min/max: over a frame with one unbounded side from a running
// extreme (K7), over a frame bounded on both sides from shared memory or
// from a sparse table (:340-383). The result goes to out[perm[i]], which
// replaces the JAX package's argsort of the inverse permutation (:386) and
// the gather after it.
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
// Bound on an H100: memory, and the latency of loads that wait on loads.
// The design:
//   - one kernel instance per class of function and per source of each
//     frame bound (partition start or end, peer start or end, an offset
//     from the row), picked by the host from the packed parameters, so a
//     launch loads only the arrays its function reads and switches on
//     nothing per row (a dtype switch, the same for every row, sits
//     outside each loop over a thread's rows);
//   - each thread takes WF_ITEMS rows as pairs of neighbours, read with
//     16-byte loads where the arrays are aligned, and issues every row's
//     first-level loads (positions) before any second-level load
//     (aux_*[hi], vals[perm[j]]), so the dependent reads overlap;
//   - a min/max frame bounded on both sides by offsets at most
//     WF_HALO_MAX rows wide is folded from shared memory: a block stages
//     its tile of aux_v and aux_i with the frame's halo on each side.
//     Wider frames, and a RANGE frame of the current row's peers (no
//     static width), read a sparse table (level k: the extreme over
//     2^k rows from each position), built on the card level by level into
//     the wrapper's scratch, two reads a row; so no row's work grows with
//     its frame's width past WF_HALO_MAX;
//   - rows at or past num_rows load nothing but perm and get the null
//     sentinel.
// Each row still stores its value and null flag at perm[i], two scattered
// stores a row, and on rows in random order they set the kernel's time:
// chip_smoke.py times each case beside the same two scatters done by
// torch's index_copy_ and beside the identity permutation.

#include <cuda_runtime.h>
#include <stdint.h>

#define WF_THREADS 256
#define WF_PAIRS 2                         // 16-byte pairs of rows a thread
#define WF_ITEMS (2 * WF_PAIRS)            // rows a thread
#define WF_TILE (WF_THREADS * WF_ITEMS)    // rows a block
#define WF_HALO_MAX 64                     // widest frame folded in shared

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

// where a frame's low and high bounds come from
enum { LO_PS = 0, LO_QS, LO_ROW };                   // ROW: max(i + off, ps)
enum { HI_PE = 0, HI_QE, HI_ROW, HI_ROW_LE };        // ROW: min(i + off, pe);
                                                     // ROW_LE: i + off <= i
// kernel classes
enum { C_ROW_NUMBER = 0, C_NTILE, C_RANK, C_DENSE_RANK, C_OFFSET, C_VALUE,
       C_COUNT, C_SUM, C_MM_HI, C_MM_LO };
// how a min/max frame bounded on both sides is read
enum { R_ROWS = 0, R_HALO, R_TABLE };

struct Args {
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
  const void* table;        // sparse table levels 1.. (R_TABLE)
  int64_t n;
  int64_t lo_off, hi_off;   // frame offsets from the row (LO_ROW, HI_ROW*)
  int64_t param;            // lag/lead offset, ntile buckets, nth position
  int64_t idefault, isent;
  double ddefault, dsent, avg_div;
  int kind, val_dt, aux_dt, out_dt;
  int has_default, is_max;
  unsigned aligned;         // bit P_*: that array is 16-byte aligned
};

static __device__ __forceinline__ int64_t row_of(int64_t tile0, int k) {
  return tile0 + (int64_t)(k >> 1) * (2 * WF_THREADS) + 2 * threadIdx.x
         + (k & 1);
}

static __device__ __forceinline__ int64_t clampi(int64_t a, int64_t n) {
  return a < 0 ? 0 : (a > n - 1 ? n - 1 : a);
}

// out[k] = a[row k] for the thread's rows below n, by pairs (16-byte
// loads where a is aligned). The loads are marked evict-first: each line
// is read once, and it should not push the partly written sectors of the
// scattered outputs out of L2.
static __device__ __forceinline__ void load_rows(
    const int64_t* __restrict__ a, int64_t tile0, int64_t n, bool aligned,
    int64_t (&out)[WF_ITEMS]) {
#pragma unroll
  for (int q = 0; q < WF_PAIRS; ++q) {
    const int64_t r = row_of(tile0, 2 * q);
    if (aligned && r + 1 < n) {
      const longlong2 v = __ldcs((const longlong2*)(a + r));
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    } else {
      out[2 * q] = r < n ? __ldcs((const long long*)a + r) : 0;
      out[2 * q + 1] = r + 1 < n ? __ldcs((const long long*)a + r + 1) : 0;
    }
  }
}

static __device__ __forceinline__ int64_t dbits(double d) {
  return __double_as_longlong(d);
}
static __device__ __forceinline__ double bitsd(int64_t b) {
  return __longlong_as_double(b);
}

// x[k] = v[idx[k]] where use[k], as double bits for the float dtypes and
// as int64 for the others (bool 0/1); the switch is outside the loop, so
// the loads of a thread's rows are issued together
static __device__ __forceinline__ void gather_val(
    const void* v, int dt, const int64_t (&idx)[WF_ITEMS],
    const bool (&use)[WF_ITEMS], int64_t (&x)[WF_ITEMS]) {
  switch (dt) {
    case DT_F64:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        x[k] = use[k] ? dbits(__ldg((const double*)v + idx[k])) : 0;
      break;
    case DT_F32:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        x[k] = use[k] ? dbits((double)__ldg((const float*)v + idx[k])) : 0;
      break;
    case DT_I64:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        x[k] = use[k] ? __ldg((const long long*)v + idx[k]) : 0;
      break;
    case DT_I32:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        x[k] = use[k] ? (int64_t)__ldg((const int*)v + idx[k]) : 0;
      break;
    default:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        x[k] = use[k] && __ldg((const unsigned char*)v + idx[k]) ? 1 : 0;
  }
}

static __device__ __forceinline__ bool is_float_dt(int dt) {
  return dt == DT_F64 || dt == DT_F32;
}

// out[o[k]] = w[k] (double bits where src_f, else int64) converted to the
// output dtype, or the null sentinel where wn[k]; out_nulls[o[k]] = wn[k]
static __device__ __forceinline__ void store_rows(
    const Args& a, bool src_f, const int64_t (&o)[WF_ITEMS],
    const int64_t (&w)[WF_ITEMS], const bool (&wn)[WF_ITEMS],
    const bool (&st)[WF_ITEMS]) {
  switch (a.out_dt) {
    case DT_F64:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        if (st[k])
          ((double*)a.out)[o[k]] = wn[k] ? a.dsent
              : (src_f ? bitsd(w[k]) : (double)w[k]);
      break;
    case DT_F32:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        if (st[k])
          ((float*)a.out)[o[k]] = (float)(wn[k] ? a.dsent
              : (src_f ? bitsd(w[k]) : (double)w[k]));
      break;
    case DT_I64:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        if (st[k])
          ((int64_t*)a.out)[o[k]] = wn[k] ? a.isent
              : (src_f ? (int64_t)bitsd(w[k]) : w[k]);
      break;
    case DT_I32:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        if (st[k])
          ((int32_t*)a.out)[o[k]] = (int32_t)(wn[k] ? a.isent
              : (src_f ? (int64_t)bitsd(w[k]) : w[k]));
      break;
    default:
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        if (st[k])
          ((uint8_t*)a.out)[o[k]] = wn[k] ? 0
              : ((src_f ? bitsd(w[k]) != 0.0 : w[k] != 0) ? 1 : 0);
  }
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k)
    if (st[k]) a.out_nulls[o[k]] = wn[k] ? 1 : 0;
}

// min/max that propagate NaN, as jnp.minimum / jnp.maximum
static __device__ __forceinline__ double fold(double a, double b,
                                              bool is_max) {
  if (a != a) return a;
  if (b != b) return b;
  return (is_max ? b > a : b < a) ? b : a;
}
static __device__ __forceinline__ int64_t fold(int64_t a, int64_t b,
                                               bool is_max) {
  return (is_max ? b > a : b < a) ? b : a;
}

template <int CLS, int LO, int HI>
struct Reads {
  static constexpr bool framed = CLS >= C_VALUE;
  static constexpr bool ps = !(CLS == C_VALUE && LO == LO_QS);
  static constexpr bool pe = CLS == C_NTILE || CLS == C_OFFSET
                             || (framed && (HI == HI_PE || HI == HI_ROW));
  static constexpr bool qs = CLS == C_RANK || (framed && LO == LO_QS);
  static constexpr bool qe = framed && HI == HI_QE;
};

// The thread's rows' frame bounds, inclusive, in sorted positions.
template <int LO, int HI>
static __device__ __forceinline__ void frame_bounds(
    const Args& a, const int64_t (&i)[WF_ITEMS],
    const int64_t (&ps)[WF_ITEMS], const int64_t (&pe)[WF_ITEMS],
    const int64_t (&qs)[WF_ITEMS], const int64_t (&qe)[WF_ITEMS],
    int64_t (&lo)[WF_ITEMS], int64_t (&hi)[WF_ITEMS]) {
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    if (LO == LO_PS) lo[k] = ps[k];
    else if (LO == LO_QS) lo[k] = qs[k];
    else lo[k] = i[k] + a.lo_off > ps[k] ? i[k] + a.lo_off : ps[k];
    if (HI == HI_PE) hi[k] = pe[k];
    else if (HI == HI_QE) hi[k] = qe[k];
    else if (HI == HI_ROW)
      hi[k] = i[k] + a.hi_off < pe[k] ? i[k] + a.hi_off : pe[k];
    else hi[k] = i[k] + a.hi_off;
  }
}

// One thread per WF_ITEMS sorted rows; every class but the both-bounded
// min/max frames.
template <int CLS, int LO, int HI>
__global__ void __launch_bounds__(WF_THREADS) window_rows_kernel(Args a) {
  using R = Reads<CLS, LO, HI>;
  const int64_t n = a.n, nr = *a.num_rows;
  const int64_t tile0 = (int64_t)blockIdx.x * WF_TILE;
  int64_t i[WF_ITEMS];
  bool st[WF_ITEMS], use[WF_ITEMS];
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    i[k] = row_of(tile0, k);
    st[k] = i[k] < n;
    use[k] = i[k] < nr && st[k];
  }
  // first level: positions of the thread's rows
  int64_t o[WF_ITEMS], ps[WF_ITEMS], pe[WF_ITEMS], qs[WF_ITEMS],
      qe[WF_ITEMS];
  load_rows(a.perm, tile0, n, a.aligned & (1u << P_PERM), o);
  if (R::ps) load_rows(a.ps, tile0, n, a.aligned & (1u << P_PS), ps);
  if (R::pe) load_rows(a.pe, tile0, n, a.aligned & (1u << P_PE), pe);
  if (R::qs) load_rows(a.qs, tile0, n, a.aligned & (1u << P_QS), qs);
  if (R::qe) load_rows(a.qe, tile0, n, a.aligned & (1u << P_QE), qe);
  int64_t w[WF_ITEMS];
  bool wn[WF_ITEMS];
  bool src_f = false;
  if (CLS == C_ROW_NUMBER) {
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k) {
      w[k] = i[k] - ps[k] + 1;
      wn[k] = false;
    }
  } else if (CLS == C_NTILE) {
    // SQL remainder rule: the first (psize mod buckets) buckets get one
    // extra row
    const int64_t buckets = a.param;
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k) {
      const int64_t psize = pe[k] - ps[k] + 1;
      const int64_t rn = i[k] - ps[k];
      const int64_t base = psize / buckets;
      const int64_t rem = psize - base * buckets;
      const int64_t big = rem * (base + 1);
      w[k] = rn < big ? rn / (base + 1 > 1 ? base + 1 : 1) + 1
                      : rem + (rn - big) / (base > 1 ? base : 1) + 1;
      wn[k] = false;
    }
  } else if (CLS == C_RANK) {
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k) {
      w[k] = qs[k] - ps[k] + 1;
      wn[k] = false;
    }
  } else if (CLS == C_DENSE_RANK) {
    int64_t here[WF_ITEMS], at_ps[WF_ITEMS];
    load_rows(a.aux_i, tile0, n, a.aligned & (1u << P_AUX_I), here);
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k)
      at_ps[k] = use[k] ? __ldg(a.aux_i + ps[k]) : 0;
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k) {
      w[k] = here[k] - at_ps[k] + 1;
      wn[k] = false;
    }
  } else if (CLS == C_OFFSET) {
    const int64_t off = a.kind == K_LAG ? -a.param : a.param;
    int64_t r[WF_ITEMS];
    bool inb[WF_ITEMS];
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k) {
      const int64_t j = i[k] + off;
      inb[k] = j >= ps[k] && j <= pe[k];
      r[k] = use[k] ? __ldg(a.perm + clampi(j, n)) : 0;
    }
    uint8_t an[WF_ITEMS];
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k)
      an[k] = use[k] ? __ldg(a.nulls + r[k]) : 0;
    gather_val(a.vals, a.val_dt, r, use, w);
    src_f = is_float_dt(a.val_dt);
#pragma unroll
    for (int k = 0; k < WF_ITEMS; ++k) {
      wn[k] = an[k] || !inb[k];
      if (a.has_default && !inb[k]) {
        w[k] = src_f ? dbits(a.ddefault) : a.idefault;
        wn[k] = false;
      }
    }
  } else {
    int64_t lo[WF_ITEMS], hi[WF_ITEMS];
    frame_bounds<LO, HI>(a, i, ps, pe, qs, qe, lo, hi);
    if (CLS == C_VALUE) {
      int64_t r[WF_ITEMS];
      bool empty[WF_ITEMS];
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k) {
        const int64_t pos = a.kind == K_FIRST_VALUE ? lo[k]
                          : a.kind == K_LAST_VALUE ? hi[k]
                          : lo[k] + a.param - 1;
        empty[k] = lo[k] > hi[k] || pos < lo[k] || pos > hi[k];
        r[k] = use[k] ? __ldg(a.perm + clampi(pos, n)) : 0;
      }
      uint8_t an[WF_ITEMS];
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k)
        an[k] = use[k] ? __ldg(a.nulls + r[k]) : 0;
      gather_val(a.vals, a.val_dt, r, use, w);
      src_f = is_float_dt(a.val_dt);
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k) wn[k] = an[k] || empty[k];
    } else {
      // live rows in the frame; the prefixes restart at ps <= lo
      bool ne[WF_ITEMS], before[WF_ITEMS];
      int64_t c_hi[WF_ITEMS], c_lo[WF_ITEMS];
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k) {
        ne[k] = use[k] && lo[k] <= hi[k];
        before[k] = ne[k] && lo[k] > ps[k];
      }
#pragma unroll
      for (int k = 0; k < WF_ITEMS; ++k) {
        c_hi[k] = ne[k] ? __ldg(a.aux_i + hi[k]) : 0;
        c_lo[k] = before[k] ? __ldg(a.aux_i + lo[k] - 1) : 0;
      }
      if (CLS == C_SUM) {
        // aux_v: float64 or int64, 8 bytes either way
        const long long* av = (const long long*)a.aux_v;
        int64_t v_hi[WF_ITEMS], v_lo[WF_ITEMS];
#pragma unroll
        for (int k = 0; k < WF_ITEMS; ++k) {
          v_hi[k] = ne[k] ? __ldg(av + hi[k]) : 0;
          v_lo[k] = before[k] ? __ldg(av + lo[k] - 1) : 0;
        }
        const bool aux_f = a.aux_dt == DT_F64;
        const bool avg = a.kind == K_AVG;
        src_f = aux_f || avg;
#pragma unroll
        for (int k = 0; k < WF_ITEMS; ++k) {
          const int64_t cnt = c_hi[k] - c_lo[k];
          // an empty frame's total is 0 (v_hi = v_lo = 0 bits)
          const double td = bitsd(v_hi[k]) - bitsd(v_lo[k]);
          const int64_t tl = (int64_t)((uint64_t)v_hi[k] - (uint64_t)v_lo[k]);
          if (avg) {
            double d = (aux_f ? td : (double)tl)
                       / (double)(cnt > 1 ? cnt : 1);
            if (a.avg_div != 1.0) d = d / a.avg_div;
            w[k] = dbits(d);
          } else {
            w[k] = aux_f ? dbits(td) : tl;
          }
          wn[k] = cnt == 0;
        }
      } else if (CLS == C_COUNT) {
#pragma unroll
        for (int k = 0; k < WF_ITEMS; ++k) {
          w[k] = c_hi[k] - c_lo[k];
          wn[k] = false;
        }
      } else {   // C_MM_HI, C_MM_LO: a running extreme read at hi or lo
        int64_t at[WF_ITEMS];
#pragma unroll
        for (int k = 0; k < WF_ITEMS; ++k)
          at[k] = clampi(CLS == C_MM_HI ? hi[k] : lo[k], n);
        gather_val(a.aux_v, a.aux_dt, at, ne, w);
        src_f = is_float_dt(a.aux_dt);
#pragma unroll
        for (int k = 0; k < WF_ITEMS; ++k) wn[k] = c_hi[k] - c_lo[k] == 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) wn[k] = wn[k] || !use[k];
  store_rows(a, src_f, o, w, wn, st);
}

// value of aux_v (dtype dt) at x, widened to T
template <typename T>
static __device__ __forceinline__ T aux_at(const void* v, int dt, int64_t x);
template <>
__device__ __forceinline__ double aux_at<double>(const void* v, int dt,
                                                 int64_t x) {
  return __ldg((const double*)v + x);
}
template <>
__device__ __forceinline__ int64_t aux_at<int64_t>(const void* v, int dt,
                                                   int64_t x) {
  return dt == DT_I32 ? (int64_t)__ldg((const int*)v + x)
                      : (int64_t)__ldg((const long long*)v + x);
}

template <typename T>
static __device__ __forceinline__ int64_t to_bits(T v);
template <>
__device__ __forceinline__ int64_t to_bits<double>(double v) {
  return dbits(v);
}
template <>
__device__ __forceinline__ int64_t to_bits<int64_t>(int64_t v) {
  return v;
}

// Both-bounded min/max over offsets from the row at most WF_HALO_MAX wide:
// the block stages aux_v and aux_i over its tile and the frame's halo,
// then folds each row's frame in shared memory.
template <typename T, int HI>
__global__ void __launch_bounds__(WF_THREADS) window_halo_kernel(Args a) {
  __shared__ T sv[WF_TILE + WF_HALO_MAX];
  __shared__ int64_t sc[WF_TILE + WF_HALO_MAX];
  const int64_t n = a.n, nr = *a.num_rows;
  const int64_t tile0 = (int64_t)blockIdx.x * WF_TILE;
  // rows lo - 1 .. hi of every frame of the tile
  int64_t s0 = tile0 + a.lo_off - 1, s1 = tile0 + WF_TILE + a.hi_off;
  s0 = s0 < 0 ? 0 : s0;
  s1 = s1 > n ? n : s1;
  for (int64_t x = s0 + threadIdx.x; x < s1; x += WF_THREADS) {
    sv[x - s0] = aux_at<T>(a.aux_v, a.aux_dt, x);
    sc[x - s0] = __ldg(a.aux_i + x);
  }
  int64_t i[WF_ITEMS], o[WF_ITEMS], ps[WF_ITEMS], pe[WF_ITEMS];
  bool st[WF_ITEMS], use[WF_ITEMS];
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    i[k] = row_of(tile0, k);
    st[k] = i[k] < n;
    use[k] = i[k] < nr && st[k];
  }
  load_rows(a.perm, tile0, n, a.aligned & (1u << P_PERM), o);
  load_rows(a.ps, tile0, n, a.aligned & (1u << P_PS), ps);
  if (HI == HI_ROW) load_rows(a.pe, tile0, n, a.aligned & (1u << P_PE), pe);
  __syncthreads();
  const bool is_max = a.is_max != 0;
  int64_t w[WF_ITEMS];
  bool wn[WF_ITEMS];
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    const int64_t lo = i[k] + a.lo_off > ps[k] ? i[k] + a.lo_off : ps[k];
    const int64_t hi = HI == HI_ROW
        ? (i[k] + a.hi_off < pe[k] ? i[k] + a.hi_off : pe[k])
        : i[k] + a.hi_off;
    w[k] = 0;
    wn[k] = true;
    if (use[k] && lo <= hi) {
      const int64_t cnt = sc[hi - s0] - (lo > ps[k] ? sc[lo - 1 - s0] : 0);
      T v = sv[lo - s0];
      for (int64_t x = lo + 1; x <= hi; ++x) v = fold(v, sv[x - s0], is_max);
      w[k] = to_bits<T>(v);
      wn[k] = cnt == 0;
    }
  }
  store_rows(a, is_float_dt(a.aux_dt), o, w, wn, st);
}

// Sparse table level j from level j - 1 (level 0: aux_v): the extreme of
// src[p] and src[p + half], src[p] where p + half is past the end.
template <typename T>
__global__ void window_level_kernel(const void* src, int src_dt, T* dst,
                                    int64_t n, int64_t half, int is_max) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const T x = aux_at<T>(src, src_dt, p);
    dst[p] = p + half < n ? fold(x, aux_at<T>(src, src_dt, p + half),
                                 is_max != 0)
                          : x;
  }
}

// Both-bounded min/max from the sparse table: the extreme over [lo, hi] is
// that of the two 2^k-row spans from lo and ending at hi, k = floor(log2
// of the frame's length).
template <typename T, int LO, int HI>
__global__ void __launch_bounds__(WF_THREADS) window_table_kernel(Args a) {
  const int64_t n = a.n, nr = *a.num_rows;
  const int64_t tile0 = (int64_t)blockIdx.x * WF_TILE;
  int64_t i[WF_ITEMS], o[WF_ITEMS], ps[WF_ITEMS], pe[WF_ITEMS],
      qs[WF_ITEMS], qe[WF_ITEMS];
  bool st[WF_ITEMS], use[WF_ITEMS];
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    i[k] = row_of(tile0, k);
    st[k] = i[k] < n;
    use[k] = i[k] < nr && st[k];
  }
  load_rows(a.perm, tile0, n, a.aligned & (1u << P_PERM), o);
  load_rows(a.ps, tile0, n, a.aligned & (1u << P_PS), ps);
  if (HI == HI_ROW) load_rows(a.pe, tile0, n, a.aligned & (1u << P_PE), pe);
  if (LO == LO_QS) load_rows(a.qs, tile0, n, a.aligned & (1u << P_QS), qs);
  if (HI == HI_QE) load_rows(a.qe, tile0, n, a.aligned & (1u << P_QE), qe);
  int64_t lo[WF_ITEMS], hi[WF_ITEMS];
  frame_bounds<LO, HI>(a, i, ps, pe, qs, qe, lo, hi);
  bool ne[WF_ITEMS];
  int64_t c_hi[WF_ITEMS], c_lo[WF_ITEMS];
  T left[WF_ITEMS], right[WF_ITEMS];
  const T* table = (const T*)a.table;
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    ne[k] = use[k] && lo[k] <= hi[k];
    const bool before = ne[k] && lo[k] > ps[k];
    c_hi[k] = ne[k] ? __ldg(a.aux_i + hi[k]) : 0;
    c_lo[k] = before ? __ldg(a.aux_i + lo[k] - 1) : 0;
    const int64_t len = ne[k] ? hi[k] - lo[k] + 1 : 1;
    const int lv = 63 - __clzll((unsigned long long)len);
    if (!ne[k]) {
      left[k] = right[k] = T(0);
    } else if (lv == 0) {
      left[k] = right[k] = aux_at<T>(a.aux_v, a.aux_dt, lo[k]);
    } else {
      const T* level = table + (int64_t)(lv - 1) * n;
      left[k] = level[lo[k]];
      right[k] = level[hi[k] - ((int64_t)1 << lv) + 1];
    }
  }
  const bool is_max = a.is_max != 0;
  int64_t w[WF_ITEMS];
  bool wn[WF_ITEMS];
#pragma unroll
  for (int k = 0; k < WF_ITEMS; ++k) {
    w[k] = to_bits<T>(fold(left[k], right[k], is_max));
    wn[k] = !ne[k] || c_hi[k] - c_lo[k] == 0;
  }
  store_rows(a, is_float_dt(a.aux_dt), o, w, wn, st);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int cls, lo, hi, route;
  int64_t lo_off, hi_off;
  int levels;               // sparse table levels past level 0 (R_TABLE)
  bool valid;
};

static int floor_log2(int64_t x) {
  int k = 0;
  while (x > 1) { x >>= 1; ++k; }
  return k;
}

static Plan make_plan(const int64_t* ip, int64_t n) {
  Plan pl{0, LO_PS, HI_PE, R_ROWS, 0, 0, 0, true};
  const int kind = (int)ip[I_KIND];
  switch (kind) {
    case K_ROW_NUMBER: pl.cls = C_ROW_NUMBER; return pl;
    case K_NTILE: pl.cls = C_NTILE; pl.valid = ip[I_PARAM] > 0; return pl;
    case K_RANK: pl.cls = C_RANK; return pl;
    case K_DENSE_RANK: pl.cls = C_DENSE_RANK; return pl;
    case K_LAG: case K_LEAD: pl.cls = C_OFFSET; return pl;
    case K_FIRST_VALUE: case K_LAST_VALUE: case K_NTH_VALUE:
      pl.cls = C_VALUE; break;
    case K_COUNT: case K_COUNT_STAR: pl.cls = C_COUNT; break;
    case K_SUM: case K_AVG: pl.cls = C_SUM; break;
    case K_MIN: case K_MAX:
      pl.cls = ip[I_MINMAX] == RUN_FROM_START ? C_MM_HI : C_MM_LO; break;
    default: pl.valid = false; return pl;
  }
  const int64_t sn = ip[I_START_N], en = ip[I_END_N];
  if (ip[I_MODE] == 0) {                           // ROWS
    switch ((int)ip[I_START]) {
      case B_UNB_PRECEDING: pl.lo = LO_PS; break;
      case B_PRECEDING: pl.lo = LO_ROW; pl.lo_off = -sn; break;
      case B_CURRENT: pl.lo = LO_ROW; break;
      case B_FOLLOWING: pl.lo = LO_ROW; pl.lo_off = sn; break;
      default: pl.valid = false;
    }
    switch ((int)ip[I_END]) {
      case B_UNB_FOLLOWING: pl.hi = HI_PE; break;
      case B_PRECEDING: pl.hi_off = -en; break;
      case B_CURRENT: break;
      case B_FOLLOWING: pl.hi_off = en; break;
      default: pl.valid = false;
    }
    if (ip[I_END] != B_UNB_FOLLOWING)
      pl.hi = pl.hi_off > 0 ? HI_ROW : HI_ROW_LE;
  } else {                                         // RANGE
    pl.lo = ip[I_START] == B_UNB_PRECEDING ? LO_PS : LO_QS;
    pl.hi = ip[I_END] == B_UNB_FOLLOWING ? HI_PE : HI_QE;
  }
  if ((kind == K_MIN || kind == K_MAX) && ip[I_MINMAX] == FOLD_FRAME) {
    int64_t width = n;                 // a peer frame has no static width
    if (pl.lo == LO_ROW && pl.hi != HI_PE && pl.hi != HI_QE) {
      width = pl.hi_off - pl.lo_off + 1;
      if (width <= WF_HALO_MAX) {
        pl.route = R_HALO;
        return pl;
      }
    } else if (!(pl.lo == LO_QS && pl.hi == HI_QE)) {
      pl.valid = false;                // no such frame is both-bounded
      return pl;
    }
    pl.route = R_TABLE;
    pl.levels = floor_log2(width < n ? width : n);
  }
  return pl;
}

template <int CLS, int LO, int HI>
static void launch_rows(const Args& a, unsigned blocks, cudaStream_t s) {
  window_rows_kernel<CLS, LO, HI><<<blocks, WF_THREADS, 0, s>>>(a);
}

// the nine (lo, hi) sources a resolved frame can have
template <int CLS>
static bool launch_framed(const Plan& pl, const Args& a, unsigned blocks,
                          cudaStream_t s) {
  switch (pl.lo * 4 + pl.hi) {
    case LO_PS * 4 + HI_PE:
      launch_rows<CLS, LO_PS, HI_PE>(a, blocks, s); break;
    case LO_PS * 4 + HI_QE:
      launch_rows<CLS, LO_PS, HI_QE>(a, blocks, s); break;
    case LO_PS * 4 + HI_ROW:
      launch_rows<CLS, LO_PS, HI_ROW>(a, blocks, s); break;
    case LO_PS * 4 + HI_ROW_LE:
      launch_rows<CLS, LO_PS, HI_ROW_LE>(a, blocks, s); break;
    case LO_QS * 4 + HI_PE:
      launch_rows<CLS, LO_QS, HI_PE>(a, blocks, s); break;
    case LO_QS * 4 + HI_QE:
      launch_rows<CLS, LO_QS, HI_QE>(a, blocks, s); break;
    case LO_ROW * 4 + HI_PE:
      launch_rows<CLS, LO_ROW, HI_PE>(a, blocks, s); break;
    case LO_ROW * 4 + HI_ROW:
      launch_rows<CLS, LO_ROW, HI_ROW>(a, blocks, s); break;
    case LO_ROW * 4 + HI_ROW_LE:
      launch_rows<CLS, LO_ROW, HI_ROW_LE>(a, blocks, s); break;
    default: return false;
  }
  return true;
}

template <typename T>
static cudaError_t launch_fold(const Plan& pl, const Args& a,
                               unsigned blocks, cudaStream_t s) {
  if (pl.route == R_HALO) {
    if (pl.hi == HI_ROW)
      window_halo_kernel<T, HI_ROW><<<blocks, WF_THREADS, 0, s>>>(a);
    else
      window_halo_kernel<T, HI_ROW_LE><<<blocks, WF_THREADS, 0, s>>>(a);
    return cudaGetLastError();
  }
  T* table = (T*)a.table;
  int64_t lb = (a.n + WF_THREADS - 1) / WF_THREADS;
  const unsigned level_blocks = (unsigned)(lb > 132 * 16 ? 132 * 16 : lb);
  for (int j = 1; j <= pl.levels; ++j) {
    const void* src = j == 1 ? a.aux_v : (const void*)(table + (j - 2) * a.n);
    // levels past 0 hold T: float64 for a float64 column, else int64
    const int src_dt = j == 1 || a.aux_dt == DT_F64 ? a.aux_dt : DT_I64;
    window_level_kernel<T><<<level_blocks, WF_THREADS, 0, s>>>(
        src, src_dt, table + (int64_t)(j - 1) * a.n, a.n,
        (int64_t)1 << (j - 1), a.is_max);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (pl.lo == LO_QS)
    window_table_kernel<T, LO_QS, HI_QE><<<blocks, WF_THREADS, 0, s>>>(a);
  else if (pl.hi == HI_ROW)
    window_table_kernel<T, LO_ROW, HI_ROW><<<blocks, WF_THREADS, 0, s>>>(a);
  else
    window_table_kernel<T, LO_ROW, HI_ROW_LE><<<blocks, WF_THREADS, 0, s>>>(
        a);
  return cudaGetLastError();
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch a launch with these packed parameters takes over
// n rows: the sparse table's levels past level 0, n words each, where a
// min/max frame bounded on both sides reads one; else 0.
int64_t window_frame_scratch_words(const int64_t* iparams, int64_t n) {
  if (n <= 0) return 0;
  const Plan pl = make_plan(iparams, n);
  return pl.valid && pl.route == R_TABLE ? (int64_t)pl.levels * n : 0;
}

// ptrs: host array of N_PTRS device pointers (P_*; null where a function
// does not read one); iparams / dparams: host arrays of the packed scalar
// parameters (I_*, D_*); n: the page capacity; scratch: device int64
// words, window_frame_scratch_words(iparams, n) of them (null for none).
int window_frame(const void* const* ptrs, const int64_t* iparams,
                 const double* dparams, int64_t n, void* scratch,
                 void* stream) {
  if (n <= 0) return 0;
  const Plan pl = make_plan(iparams, n);
  const int kind = (int)iparams[I_KIND];
  if (!pl.valid || iparams[I_OUT_DT] < DT_F64 || iparams[I_OUT_DT] > DT_F32)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.perm = (const int64_t*)ptrs[P_PERM];
  a.num_rows = (const int64_t*)ptrs[P_NUM_ROWS];
  a.ps = (const int64_t*)ptrs[P_PS];
  a.pe = (const int64_t*)ptrs[P_PE];
  a.qs = (const int64_t*)ptrs[P_QS];
  a.qe = (const int64_t*)ptrs[P_QE];
  a.vals = ptrs[P_VALS];
  a.nulls = (const uint8_t*)ptrs[P_NULLS];
  a.aux_i = (const int64_t*)ptrs[P_AUX_I];
  a.aux_v = ptrs[P_AUX_V];
  a.out = (void*)ptrs[P_OUT];
  a.out_nulls = (uint8_t*)ptrs[P_OUT_NULLS];
  a.table = scratch;
  a.n = n;
  a.lo_off = pl.lo_off;
  a.hi_off = pl.hi_off;
  a.param = iparams[I_PARAM];
  a.idefault = iparams[I_DEFAULT];
  a.isent = iparams[I_SENTINEL];
  a.ddefault = dparams[D_DEFAULT];
  a.dsent = dparams[D_SENTINEL];
  a.avg_div = dparams[D_AVG_DIV];
  a.kind = kind;
  a.val_dt = (int)iparams[I_VAL_DT];
  a.aux_dt = (int)iparams[I_AUX_DT];
  a.out_dt = (int)iparams[I_OUT_DT];
  a.has_default = (int)iparams[I_HAS_DEFAULT];
  a.is_max = (int)iparams[I_IS_MAX];
  a.aligned = 0;
  for (int k = 0; k < N_PTRS; ++k)
    if (((uintptr_t)ptrs[k] & 15) == 0) a.aligned |= 1u << k;
  const bool needs_vals = pl.cls == C_OFFSET || pl.cls == C_VALUE;
  const bool needs_aux_i = pl.cls == C_DENSE_RANK || pl.cls >= C_COUNT;
  const bool needs_aux_v = pl.cls >= C_SUM;
  if (!a.perm || !a.num_rows || !a.ps || !a.pe || !a.qs || !a.qe || !a.out
      || !a.out_nulls || (needs_vals && (!a.vals || !a.nulls))
      || (needs_aux_i && !a.aux_i) || (needs_aux_v && !a.aux_v)
      || (pl.route == R_TABLE && pl.levels > 0 && !scratch))
    return (int)cudaErrorInvalidValue;
  if (pl.cls == C_SUM && a.aux_dt != DT_F64 && a.aux_dt != DT_I64)
    return (int)cudaErrorInvalidValue;
  if (pl.route != R_ROWS && a.aux_dt != DT_F64 && a.aux_dt != DT_I64
      && a.aux_dt != DT_I32)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + WF_TILE - 1) / WF_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)tiles;
  cudaStream_t s = (cudaStream_t)stream;
  if (pl.route != R_ROWS)
    return a.aux_dt == DT_F64 ? (int)launch_fold<double>(pl, a, blocks, s)
                              : (int)launch_fold<int64_t>(pl, a, blocks, s);
  bool ok = true;
  switch (pl.cls) {
    case C_ROW_NUMBER:
      launch_rows<C_ROW_NUMBER, LO_PS, HI_PE>(a, blocks, s); break;
    case C_NTILE: launch_rows<C_NTILE, LO_PS, HI_PE>(a, blocks, s); break;
    case C_RANK: launch_rows<C_RANK, LO_PS, HI_PE>(a, blocks, s); break;
    case C_DENSE_RANK:
      launch_rows<C_DENSE_RANK, LO_PS, HI_PE>(a, blocks, s); break;
    case C_OFFSET: launch_rows<C_OFFSET, LO_PS, HI_PE>(a, blocks, s); break;
    case C_VALUE: ok = launch_framed<C_VALUE>(pl, a, blocks, s); break;
    case C_COUNT: ok = launch_framed<C_COUNT>(pl, a, blocks, s); break;
    case C_SUM: ok = launch_framed<C_SUM>(pl, a, blocks, s); break;
    case C_MM_HI: ok = launch_framed<C_MM_HI>(pl, a, blocks, s); break;
    default: ok = launch_framed<C_MM_LO>(pl, a, blocks, s); break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
