// K7 segmented_scan: one inclusive scan, optionally segmented and
// optionally reversed, under add, min, max or "last present position";
// and window_bounds, a window's four position scans in one launch.
//
// Replaces the scan primitives of presto_tpu/ops/scan.py: cumsum (:36),
// blocked_cummax (:61), fill_forward (:84), seg_scan (:104) and
// fill_backward (:153). The JAX versions are blocked Hillis-Steele
// doublings (log2 of the row count of full passes each), a workaround for
// TPU compile times; here each is one scan:
//   cumsum          add, no segments;
//   blocked_cummax  max, no segments;
//   seg_scan        min or max with segment-start flags;
//   fill_forward    "last": per row the last present position at or before
//                   it (-1 where none), then a gather in the wrapper;
//   fill_backward   the same, reversed.
// A reverse scan reads row n-1-p at scan position p, values and segment
// flags alike: the caller passes the flags of the LAST row of each segment
// in row order (window.py's part_end), which start the segments in scan
// order. window_bounds replaces the four fills of
// presto_tpu/ops/window.py:197-204: from the partition and peer start
// flags it writes each row's partition start and end and peer start and
// end positions (forward "last" scans of the starts; reverse "last" scans
// of the ends, row i ending where row i + 1 starts, the last row always).
//
// min and max propagate NaN, as jnp.minimum and jnp.maximum do (CUDA's
// fmin/fmax would drop it), so the comparisons are written out. Integer
// sums wrap (computed in unsigned arithmetic).
//
// A block scans a tile of SS_TILE scan positions. A warp loads its 512
// rows with coalesced 16-byte loads into shared memory and each thread
// takes 16 consecutive rows from there (flags and present bytes: one
// 16-byte load a thread); the thread's fold, a block scan and the tile's
// carry-in give the inclusive results, which leave through shared memory
// as coalesced 16-byte stores. A reverse scan takes row tiles from the
// last, warp regions and threads' rows from the end, so every load and
// store stays aligned. The carry-in comes one of two ways:
//
//   exact operators (integer add, min, max, last, window_bounds): one
//   pass, a decoupled look-back (Merrill and Garland, "Single-pass
//   Parallel Prefix Scan with Decoupled Look-back", 2016). Blocks take
//   tiles in order from an atomic ticket, so a tile's predecessors have
//   all been taken by running blocks; a tile publishes its aggregate at
//   once, then warp 0 folds its predecessors' descriptors, 32 at a time,
//   back to the nearest one that hides all before it (an inclusive
//   prefix, a segment start, or for "last" a present position), and
//   publishes its inclusive prefix. A descriptor (status and value) is 16
//   bytes written and read as one access, as in CUB's single-pass scans,
//   so no fence orders a value after its status. Which predecessors are
//   folded depends on timing; the result does not, for these operators.
//
//   float64 add: two launches, so that a sum repeats bit for bit from run
//   to run (a look-back that folds whichever of a predecessor's aggregate
//   or inclusive prefix is ready would change the association). The first
//   writes each tile's aggregate; the second scans each tile from a
//   carry-in that folds the aggregates before it in a fixed order (each
//   lane eight in a row, a fixed shuffle tree across the lanes, 256 tiles
//   a round). The second launch reads the input again, from L2 where it
//   fits (8 MB for a million values).
//
// window_bounds runs forward tiles (starts) and reverse tiles (ends) as
// alternate blocks of one grid, each direction with its own tickets and
// descriptors; its values are pairs of positions (partition, peer).
//
// Bound on an H100: memory. The work reads each value (4-8 B, or 1 B of
// `present`) and its segment flag (1 B) once and writes one result
// (4-8 B); window_bounds reads 2 B a row and writes 32 B. The kernels
// read the input once (window_bounds: the flags once a direction; float64
// add: twice) and move 16 B of descriptor a tile of 4096 rows.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define SS_THREADS 256
#define SS_WARPS (SS_THREADS / 32)
#define SS_ITEMS 16                          // rows a thread scans
#define SS_WARP_ROWS (32 * SS_ITEMS)         // rows a warp stages
#define SS_TILE (SS_THREADS * SS_ITEMS)      // rows a block scans
#define SS_PER_LANE 8                        // aggregates a lane folds a
                                             // round of a fixed carry-in
#define FULL 0xffffffffu

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_LAST = 3 };
enum { CARRY_LOOKBACK = 0, CARRY_FIXED = 1 };

// Each operator: the combine, its identity, and absorbs(v): whether a
// run whose fold is v hides every run before it (then a look-back stops).
template <typename T>
struct AddOp {
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
  static __device__ __forceinline__ T ident() { return (T)0; }
  static __device__ __forceinline__ bool absorbs(T) { return false; }
};
template <>
struct AddOp<int64_t> {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return (int64_t)((uint64_t)a + (uint64_t)b);
  }
  static __device__ __forceinline__ int64_t ident() { return 0; }
  static __device__ __forceinline__ bool absorbs(int64_t) { return false; }
};
template <>
struct AddOp<int32_t> {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t ident() { return 0; }
  static __device__ __forceinline__ bool absorbs(int32_t) { return false; }
};

template <typename T>
__device__ __forceinline__ bool is_nan(T) { return false; }
template <>
__device__ __forceinline__ bool is_nan<double>(double x) { return x != x; }

template <typename T>
__device__ __forceinline__ T lowest();
template <typename T>
__device__ __forceinline__ T highest();
template <> __device__ __forceinline__ double lowest<double>() {
  return -__longlong_as_double(0x7ff0000000000000LL);
}
template <> __device__ __forceinline__ double highest<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <> __device__ __forceinline__ int64_t lowest<int64_t>() {
  return (int64_t)0x8000000000000000ULL;
}
template <> __device__ __forceinline__ int64_t highest<int64_t>() {
  return 0x7fffffffffffffffLL;
}
template <> __device__ __forceinline__ int32_t lowest<int32_t>() {
  return (int32_t)0x80000000U;
}
template <> __device__ __forceinline__ int32_t highest<int32_t>() {
  return 0x7fffffff;
}

template <typename T>
struct MinOp {
  __device__ __forceinline__ T operator()(T a, T b) const {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b < a ? b : a;
  }
  static __device__ __forceinline__ T ident() { return highest<T>(); }
  static __device__ __forceinline__ bool absorbs(T) { return false; }
};

template <typename T>
struct MaxOp {
  __device__ __forceinline__ T operator()(T a, T b) const {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b > a ? b : a;
  }
  static __device__ __forceinline__ T ident() { return lowest<T>(); }
  static __device__ __forceinline__ bool absorbs(T) { return false; }
};

// positions: the later present one wins; -1 is "none"
struct LastOp {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return b >= 0 ? b : a;
  }
  static __device__ __forceinline__ int64_t ident() { return -1; }
  static __device__ __forceinline__ bool absorbs(int64_t v) { return v >= 0; }
};

// window_bounds' value: a partition and a peer position, each under LastOp
struct Pos2 {
  long long a, b;
};
struct Last2Op {
  __device__ __forceinline__ Pos2 operator()(Pos2 x, Pos2 y) const {
    Pos2 r;
    r.a = y.a >= 0 ? y.a : x.a;
    r.b = y.b >= 0 ? y.b : x.b;
    return r;
  }
  static __device__ __forceinline__ Pos2 ident() {
    Pos2 r;
    r.a = -1;
    r.b = -1;
    return r;
  }
  static __device__ __forceinline__ bool absorbs(Pos2 v) {
    return v.a >= 0 && v.b >= 0;
  }
};

// ---------------------------------------------------------------------------
// warp and block primitives over any value type (a multiple of 4 bytes)
// ---------------------------------------------------------------------------

template <typename T>
static __device__ __forceinline__ T shfl_up_t(T v, unsigned d) {
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 4); ++k)
    w[k] = __shfl_up_sync(FULL, w[k], d);
  memcpy(&v, w, sizeof(T));
  return v;
}

template <typename T>
static __device__ __forceinline__ T shfl_down_t(T v, unsigned d) {
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 4); ++k)
    w[k] = __shfl_down_sync(FULL, w[k], d);
  memcpy(&v, w, sizeof(T));
  return v;
}

template <typename T>
static __device__ __forceinline__ T shfl_idx_t(T v, int src) {
  unsigned w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / 4); ++k)
    w[k] = __shfl_sync(FULL, w[k], src);
  memcpy(&v, w, sizeof(T));
  return v;
}

// Fold the run (bv, bf) that follows the run (v, f): a run's flag says
// whether a segment starts inside it. Associative whenever op is.
template <typename T, typename Op>
static __device__ __forceinline__ void fold(T& v, int& f, T bv, int bf,
                                            Op op) {
  v = bf ? bv : op(v, bv);
  f |= bf;
}

// Lane 0 gets the fold of the 32 lanes' runs in lane order, by a tree
// whose shape is fixed.
template <typename T, typename Op>
static __device__ __forceinline__ void warp_fold(T& v, int& f, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T ov = shfl_down_t(v, o);
    const int of = __shfl_down_sync(FULL, f, o);
    if (lane + o < 32) fold(v, f, ov, of, op);
  }
}

// Block-wide exclusive segmented scan of one run (v, f) a thread: the run
// of everything before the thread (ident, 0 for thread 0) and the block's
// total. blockDim.x is SS_THREADS.
template <typename T, typename Op>
static __device__ __forceinline__ void block_exclusive_seg_scan(
    T v, int f, Op op, T* excl_v, int* excl_f, T* tot_v, int* tot_f) {
  __shared__ T warp_v[SS_WARPS];
  __shared__ int warp_f[SS_WARPS];
  __shared__ T block_v;
  __shared__ int block_f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T iv = v;
  int ifl = f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T yv = shfl_up_t(iv, o);
    const int yf = __shfl_up_sync(FULL, ifl, o);
    if (lane >= o) {
      if (!ifl) iv = op(yv, iv);
      ifl |= yf;
    }
  }
  // exclusive within the warp: the inclusive run of the lane before
  T ev = shfl_up_t(iv, 1);
  int ef = __shfl_up_sync(FULL, ifl, 1);
  if (lane == 0) {
    ev = Op::ident();
    ef = 0;
  }
  if (lane == 31) {
    warp_v[warp] = iv;
    warp_f[warp] = ifl;
  }
  __syncthreads();
  if (warp == 0) {
    T wv = lane < SS_WARPS ? warp_v[lane] : Op::ident();
    int wf = lane < SS_WARPS ? warp_f[lane] : 0;
#pragma unroll
    for (int o = 1; o < SS_WARPS; o <<= 1) {
      const T yv = shfl_up_t(wv, o);
      const int yf = __shfl_up_sync(FULL, wf, o);
      if (lane >= o) {
        if (!wf) wv = op(yv, wv);
        wf |= yf;
      }
    }
    T xv = shfl_up_t(wv, 1);
    int xf = __shfl_up_sync(FULL, wf, 1);
    if (lane == 0) {
      xv = Op::ident();
      xf = 0;
    }
    if (lane < SS_WARPS) {            // exclusive warp prefixes
      warp_v[lane] = xv;
      warp_f[lane] = xf;
    }
    if (lane == SS_WARPS - 1) {       // block total
      block_v = wv;
      block_f = wf;
    }
  }
  __syncthreads();
  // everything before the thread: the warp's prefix, then the lanes before
  const T pv = warp_v[warp];
  const int pf = warp_f[warp];
  *excl_v = ef ? ev : op(pv, ev);
  *excl_f = pf | ef;
  *tot_v = block_v;
  *tot_f = block_f;
}

// ---------------------------------------------------------------------------
// tile descriptors
// ---------------------------------------------------------------------------

// status of a descriptor: 0 = not yet published
#define ST_AGG 1ull       // the tile's aggregate
#define ST_PREFIX 2ull    // the fold of every tile up to and including it

// A descriptor: value, segment flag and status in 16 bytes.
template <typename T>
struct Desc {
  static __device__ __forceinline__ ulonglong2 pack(T v, int f,
                                                    unsigned long long st) {
    ulonglong2 d;
    d.x = 0;
    memcpy(&d.x, &v, sizeof(T));
    d.y = st | ((unsigned long long)f << 2);
    return d;
  }
  static __device__ __forceinline__ unsigned long long status(ulonglong2 d) {
    return d.y & 3;
  }
  static __device__ __forceinline__ void unpack(ulonglong2 d, T* v, int* f) {
    memcpy(v, &d.x, sizeof(T));
    *f = (int)(d.y >> 2) & 1;
  }
};

// positions are at least -1 and below 2^61: a + 2 (with the status in its
// top bits) and b + 2 fill the 16 bytes
template <>
struct Desc<Pos2> {
  static __device__ __forceinline__ ulonglong2 pack(Pos2 v, int,
                                                    unsigned long long st) {
    ulonglong2 d;
    d.x = (unsigned long long)(v.a + 2) | (st << 62);
    d.y = (unsigned long long)(v.b + 2);
    return d;
  }
  static __device__ __forceinline__ unsigned long long status(ulonglong2 d) {
    return d.x >> 62;
  }
  static __device__ __forceinline__ void unpack(ulonglong2 d, Pos2* v,
                                                int* f) {
    v->a = (long long)(d.x & ((1ull << 62) - 1)) - 2;
    v->b = (long long)d.y - 2;
    *f = 0;
  }
};

static __device__ __forceinline__ void st_desc(ulonglong2* p, ulonglong2 d) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(p), "l"(d.x), "l"(d.y) : "memory");
}

static __device__ __forceinline__ ulonglong2 ld_desc(const ulonglong2* p) {
  ulonglong2 d;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(d.x), "=l"(d.y) : "l"(p) : "memory");
  return d;
}

// By warp 0 of tile t > 0, after it published its aggregate: the fold of
// every tile before t, on every lane. Lane l waits for tile end - l's
// descriptor; the window is folded from its nearest descriptor that hides
// all before it (an inclusive prefix, a segment start, a run the operator
// absorbs) to lane 0, and the walk ends there.
template <typename T, typename Op>
static __device__ void look_back(const ulonglong2* desc, unsigned t, Op op,
                                 T* cv, int* cf) {
  const int lane = threadIdx.x & 31;
  T acc = Op::ident();   // the tiles after the window, up to t - 1
  int accf = 0;
  for (int64_t end = (int64_t)t - 1;; end -= 32) {
    const int64_t j = end - lane;
    T v = Op::ident();
    int f = 0;
    unsigned long long st = ST_PREFIX;   // before tile 0: an empty prefix
    if (j >= 0) {
      ulonglong2 d = ld_desc(&desc[j]);
      while (Desc<T>::status(d) == 0) {
        __nanosleep(32);
        d = ld_desc(&desc[j]);
      }
      st = Desc<T>::status(d);
      Desc<T>::unpack(d, &v, &f);
    }
    const unsigned stops = __ballot_sync(
        FULL, st == ST_PREFIX || f != 0 || Op::absorbs(v));
    const int far = stops ? __ffs(stops) - 1 : 31;
    if (lane > far) {
      v = Op::ident();
      f = 0;
    }
    // lane 0: the window from lane `far` (earliest) to lane 0 (latest)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T ov = shfl_down_t(v, o);
      int of = __shfl_down_sync(FULL, f, o);
      if (lane + o < 32) {
        fold(ov, of, v, f, op);
        v = ov;
        f = of;
      }
    }
    fold(v, f, acc, accf, op);
    acc = v;
    accf = f;
    if (stops) break;
  }
  *cv = shfl_idx_t(acc, 0);
  *cf = __shfl_sync(FULL, accf, 0);
}

// By warp 0 of tile t: the fold of the aggregates of tiles 0 .. t - 1 in
// an order fixed by t, on every lane: lane l folds tiles base + 8l ..
// base + 8l + 7 in order, warp_fold joins the lanes, rounds of 256 tiles
// fold in order.
template <typename T, typename Op>
static __device__ void fixed_carry(const ulonglong2* agg, unsigned t, Op op,
                                   T* cv, int* cf) {
  const unsigned lane = threadIdx.x & 31;
  T acc = Op::ident();
  int accf = 0;
  for (unsigned base = 0; base < t; base += 32 * SS_PER_LANE) {
    const unsigned j0 = base + lane * SS_PER_LANE;
    ulonglong2 d[SS_PER_LANE];
#pragma unroll
    for (int k = 0; k < SS_PER_LANE; ++k)
      if (j0 + k < t) d[k] = __ldcg(&agg[j0 + k]);
    T v = Op::ident();
    int f = 0;
#pragma unroll
    for (int k = 0; k < SS_PER_LANE; ++k) {
      if (j0 + k < t) {
        T x;
        int xf;
        Desc<T>::unpack(d[k], &x, &xf);
        fold(v, f, x, xf, op);
      }
    }
    warp_fold(v, f, op);
    fold(acc, accf, v, f, op);     // lane 0's is the one kept
  }
  *cv = shfl_idx_t(acc, 0);
  *cf = __shfl_sync(FULL, accf, 0);
}

// ---------------------------------------------------------------------------
// staging: coalesced 16-byte loads and stores through shared memory
// ---------------------------------------------------------------------------

// A warp's stage holds its SS_WARP_ROWS rows as 32 padded rows of
// SS_ITEMS values, one a lane; the 16 bytes of padding keep both the
// striped 16-byte accesses and a lane's row conflict-free.
template <typename T>
struct Stage {
  static constexpr int PITCH = SS_ITEMS * (int)sizeof(T) + 16;
  static constexpr int BYTES = 32 * PITCH;
  static constexpr int V = 16 / (int)sizeof(T);          // values a chunk
  static constexpr int CHUNKS = SS_WARP_ROWS / V / 32;   // chunks a lane

  static __device__ __forceinline__ unsigned char* at(unsigned char* s,
                                                      int i) {
    return s + (i / SS_ITEMS) * PITCH + (i % SS_ITEMS) * (int)sizeof(T);
  }

  // rows r0 .. r0 + SS_WARP_ROWS of x, read in 16-byte chunks striped
  // over the lanes; rows at or past n read as `fill`
  static __device__ __forceinline__ void load(unsigned char* s, const T* x,
                                              int64_t r0, int64_t n, T fill,
                                              bool vec) {
    const int lane = threadIdx.x & 31;
    const int64_t lim = n - r0;
    uint4 buf[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = (k * 32 + lane) * V;
      if (vec && i + V <= lim) {
        buf[k] = __ldg((const uint4*)(x + r0 + i));
      } else {
        T tmp[V];
#pragma unroll
        for (int e = 0; e < V; ++e) tmp[e] = i + e < lim ? x[r0 + i + e]
                                                         : fill;
        memcpy(&buf[k], tmp, 16);
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
      *(uint4*)at(s, (k * 32 + lane) * V) = buf[k];
  }

  // the values of padded row `row`, in row order
  static __device__ __forceinline__ void get_row(unsigned char* s, int row,
                                                 T* items) {
    uint4 w[SS_ITEMS * sizeof(T) / 16];
#pragma unroll
    for (int q = 0; q < (int)(SS_ITEMS * sizeof(T) / 16); ++q)
      w[q] = ((const uint4*)(s + row * PITCH))[q];
    memcpy(items, w, SS_ITEMS * sizeof(T));
  }

  static __device__ __forceinline__ void put_row(unsigned char* s, int row,
                                                 const T* items) {
    uint4 w[SS_ITEMS * sizeof(T) / 16];
    memcpy(w, items, SS_ITEMS * sizeof(T));
#pragma unroll
    for (int q = 0; q < (int)(SS_ITEMS * sizeof(T) / 16); ++q)
      ((uint4*)(s + row * PITCH))[q] = w[q];
  }

  // the stage to rows r0 .. of out, rows below n only
  static __device__ __forceinline__ void store(unsigned char* s, T* out,
                                               int64_t r0, int64_t n,
                                               bool vec) {
    const int lane = threadIdx.x & 31;
    const int64_t lim = n - r0;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = (k * 32 + lane) * V;
      const uint4 w = *(const uint4*)at(s, i);
      if (vec && i + V <= lim) {
        *(uint4*)(out + r0 + i) = w;
      } else {
        T tmp[V];
        memcpy(tmp, &w, 16);
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (i + e < lim) out[r0 + i + e] = tmp[e];
      }
    }
  }
};

// bit k: the byte of row o + k is nonzero (rows at or past n read as 0)
static __device__ __forceinline__ unsigned load_mask16(const uint8_t* p,
                                                       int64_t o, int64_t n,
                                                       bool vec) {
  unsigned m = 0;
  if (vec && o + SS_ITEMS <= n) {
    const uint4 v = __ldg((const uint4*)(p + o));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w[q] >> (8 * b)) & 0xffu) m |= 1u << (4 * q + b);
  } else {
#pragma unroll
    for (int k = 0; k < SS_ITEMS; ++k)
      if (o + k < n && p[o + k]) m |= 1u << k;
  }
  return m;
}

static __device__ __forceinline__ unsigned reverse16(unsigned m) {
  return __brev(m) >> 16;
}

template <typename T>
static __device__ __forceinline__ void reverse_items(T* items) {
#pragma unroll
  for (int k = 0; k < SS_ITEMS / 2; ++k) {
    const T x = items[k];
    items[k] = items[SS_ITEMS - 1 - k];
    items[SS_ITEMS - 1 - k] = x;
  }
}

static __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Where a block's tile lies: its ticket t is its position in scan order;
// row tile, warp region and the lane's chunk of SS_ITEMS rows run from the
// end in a reverse scan.
struct TilePlace {
  int64_t r0;      // the warp's first row
  int chunk;       // the lane's padded row in the warp's stage
  int64_t o;       // the lane's first row
};

static __device__ __forceinline__ TilePlace place(unsigned t, unsigned tiles,
                                                  int reverse) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  TilePlace p;
  const int64_t tile_row = (int64_t)(reverse ? tiles - 1 - t : t) * SS_TILE;
  p.r0 = tile_row
         + (int64_t)(reverse ? SS_WARPS - 1 - warp : warp) * SS_WARP_ROWS;
  p.chunk = reverse ? 31 - lane : lane;
  p.o = p.r0 + (int64_t)p.chunk * SS_ITEMS;
  return p;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// programmatic dependent launch (sm_90): the second launch of a float64
// sum may start once every block of the first has started, and waits for
// the first's writes only where it reads them
static __device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

static __device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A thread's value k in scan order: its staged values, or for "last" the
// row's position where the present bit is set (-1 where not).
template <typename T, bool LAST>
struct Items {
  T v[LAST ? 1 : SS_ITEMS];
  unsigned present;     // LAST: bit k, in scan order
  int64_t first;        // LAST: the row of scan item 0
  int step;             // LAST: +1 forward, -1 reverse

  __device__ __forceinline__ T at(int k) const {
    if constexpr (LAST)
      return (present >> k) & 1u ? (T)(first + step * k) : (T)-1;
    else
      return v[k];
  }
};

// The thread's SS_ITEMS values and segment flags, in scan order.
template <typename T, typename Op, bool LAST>
static __device__ __forceinline__ void load_tile(
    const void* x, const uint8_t* seg, int64_t n, int reverse,
    const TilePlace& p, unsigned char* stage, Items<T, LAST>* it,
    unsigned* fm) {
  if constexpr (LAST) {
    const unsigned m = load_mask16((const uint8_t*)x, p.o, n, aligned16(x));
    it->present = reverse ? reverse16(m) : m;
    it->first = reverse ? p.o + SS_ITEMS - 1 : p.o;
    it->step = reverse ? -1 : 1;
  } else {
    Stage<T>::load(stage, (const T*)x, p.r0, n, Op::ident(), aligned16(x));
    __syncwarp();
    Stage<T>::get_row(stage, p.chunk, it->v);
    if (reverse) reverse_items(it->v);
  }
  *fm = seg != nullptr ? load_mask16(seg, p.o, n, aligned16(seg)) : 0u;
  if (reverse) *fm = reverse16(*fm);
}

// Each tile's aggregate, for the fixed carry-in (float64 add). Without
// segments the order of the fold is free as long as it is fixed: a thread
// folds its coalesced 16-byte chunks as they arrive, with no staging.
template <typename T, typename Op>
__global__ void __launch_bounds__(SS_THREADS)
ss_reduce_kernel(const void* __restrict__ x, const uint8_t* __restrict__ seg,
                 int64_t n, int reverse, ulonglong2* __restrict__ agg,
                 unsigned tiles) {
  typedef Stage<T> S;
  __shared__ __align__(16) unsigned char stage_all[SS_WARPS * S::BYTES];
  launch_dependents();
  const Op op{};
  const unsigned t = blockIdx.x;
  const TilePlace p = place(t, tiles, reverse);
  T v = Op::ident();
  int f = 0;
  const int64_t lim = n - p.r0;
  if (seg == nullptr && aligned16(x) && lim >= SS_WARP_ROWS) {
    const int lane = threadIdx.x & 31;
    uint4 buf[S::CHUNKS];
#pragma unroll
    for (int k = 0; k < S::CHUNKS; ++k)
      buf[k] = __ldg((const uint4*)((const T*)x + p.r0) + k * 32 + lane);
#pragma unroll
    for (int k = 0; k < S::CHUNKS; ++k) {
      T e[S::V];
      memcpy(e, &buf[k], 16);
#pragma unroll
      for (int j = 0; j < S::V; ++j) v = op(v, e[j]);
    }
  } else {
    Items<T, false> it;
    unsigned fm;
    load_tile<T, Op, false>(x, seg, n, reverse, p,
                            stage_all + (threadIdx.x >> 5) * S::BYTES, &it,
                            &fm);
#pragma unroll
    for (int k = 0; k < SS_ITEMS; ++k) fold(v, f, it.at(k),
                                            (int)(fm >> k) & 1, op);
  }
  T ev, tv;
  int ef, tf;
  block_exclusive_seg_scan(v, f, op, &ev, &ef, &tv, &tf);
  if (threadIdx.x == 0) agg[t] = Desc<T>::pack(tv, tf, ST_AGG);
}

template <typename T, typename Op, bool LAST, int CARRY>
__global__ void __launch_bounds__(SS_THREADS)
ss_scan_kernel(const void* __restrict__ x, const uint8_t* __restrict__ seg,
               int64_t n, int reverse, T* __restrict__ out,
               unsigned* ticket, ulonglong2* desc, unsigned tiles) {
  typedef Stage<T> S;
  __shared__ __align__(16) unsigned char stage_all[SS_WARPS * S::BYTES];
  __shared__ unsigned tile_sh;
  __shared__ T carry_v;
  const Op op{};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned t = blockIdx.x;
  if constexpr (CARRY == CARRY_LOOKBACK) {
    if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1u);
    __syncthreads();
    t = tile_sh;
  }
  const TilePlace p = place(t, tiles, reverse);
  unsigned char* stage = stage_all + warp * S::BYTES;
  Items<T, LAST> it;
  unsigned fm;
  load_tile<T, Op, LAST>(x, seg, n, reverse, p, stage, &it, &fm);
  T v = Op::ident();
  int f = 0;
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) fold(v, f, it.at(k),
                                          (int)(fm >> k) & 1, op);
  T ev, tv;
  int ef, tf;
  block_exclusive_seg_scan(v, f, op, &ev, &ef, &tv, &tf);
  if (warp == 0) {
    T cv = Op::ident();
    int cf = 0;
    if constexpr (CARRY == CARRY_FIXED) {
      wait_for_prior_grid();        // the aggregates of the first launch
      fixed_carry(desc, t, op, &cv, &cf);
    } else if (t == 0) {
      if (lane == 0) st_desc(&desc[0], Desc<T>::pack(tv, tf, ST_PREFIX));
    } else {
      if (lane == 0) st_desc(&desc[t], Desc<T>::pack(tv, tf, ST_AGG));
      look_back(desc, t, op, &cv, &cf);
      if (lane == 0) {
        T iv = cv;
        int ifl = cf;
        fold(iv, ifl, tv, tf, op);
        st_desc(&desc[t], Desc<T>::pack(iv, ifl, ST_PREFIX));
      }
    }
    if (lane == 0) carry_v = cv;
  }
  __syncthreads();
  // the fold of everything before the thread's first row: the tile's
  // carry-in (its flag is not needed), then the threads before it; each
  // result goes to the thread's row of the stage in row order
  T acc = ef ? ev : op(carry_v, ev);
  T* row = (T*)(stage + p.chunk * S::PITCH);
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) {
    acc = (fm >> k) & 1u ? it.at(k) : op(acc, it.at(k));
    row[reverse ? SS_ITEMS - 1 - k : k] = acc;
  }
  __syncwarp();
  S::store(stage, out, p.r0, n, aligned16(out));
}

// Even blocks scan forward (starts), odd blocks in reverse (ends).
__global__ void __launch_bounds__(SS_THREADS)
ss_bounds_kernel(const uint8_t* __restrict__ part,
                 const uint8_t* __restrict__ peer, int64_t n,
                 int64_t* __restrict__ ps, int64_t* __restrict__ pe,
                 int64_t* __restrict__ qs, int64_t* __restrict__ qe,
                 unsigned* tickets, ulonglong2* desc_fwd,
                 ulonglong2* desc_rev, unsigned tiles) {
  typedef Stage<int64_t> S;
  __shared__ __align__(16) unsigned char stage_all[SS_WARPS * S::BYTES];
  __shared__ unsigned tile_sh;
  __shared__ Pos2 carry_v;
  const Last2Op op{};
  const int reverse = blockIdx.x & 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) tile_sh = atomicAdd(&tickets[reverse], 1u);
  __syncthreads();
  const unsigned t = tile_sh;
  const TilePlace p = place(t, tiles, reverse);
  unsigned char* stage = stage_all + warp * S::BYTES;
  const bool vec = aligned16(part) && aligned16(peer);

  unsigned pm = load_mask16(part, p.o, n, vec);
  unsigned qm = load_mask16(peer, p.o, n, vec);
  if (reverse) {
    // row i ends its partition (peer group) where row i + 1 starts one;
    // the last row always ends one
    const int64_t nx = p.o + SS_ITEMS;
    const unsigned pn = nx < n ? part[nx] != 0 : 0u;
    const unsigned qn = nx < n ? peer[nx] != 0 : 0u;
    pm = (pm >> 1) | (pn << (SS_ITEMS - 1));
    qm = (qm >> 1) | (qn << (SS_ITEMS - 1));
    const int64_t last = n - 1 - p.o;
    if (last >= 0 && last < SS_ITEMS) {
      pm |= 1u << last;
      qm |= 1u << last;
    }
    pm = reverse16(pm);
    qm = reverse16(qm);
  }
  // scan item k is row first + step * k; a set bit is a present position
  const int64_t first = reverse ? p.o + SS_ITEMS - 1 : p.o;
  const int step = reverse ? -1 : 1;
  Pos2 v = Last2Op::ident();
  if (pm) v.a = first + step * (31 - __clz(pm));
  if (qm) v.b = first + step * (31 - __clz(qm));
  Pos2 ev, tv;
  int ef, tf;
  block_exclusive_seg_scan(v, 0, op, &ev, &ef, &tv, &tf);
  if (warp == 0) {
    ulonglong2* desc = reverse ? desc_rev : desc_fwd;
    Pos2 cv = Last2Op::ident();
    int cf = 0;
    if (t == 0) {
      if (lane == 0) st_desc(&desc[0], Desc<Pos2>::pack(tv, 0, ST_PREFIX));
    } else {
      if (lane == 0) st_desc(&desc[t], Desc<Pos2>::pack(tv, 0, ST_AGG));
      look_back(desc, t, op, &cv, &cf);
      if (lane == 0)
        st_desc(&desc[t], Desc<Pos2>::pack(op(cv, tv), 0, ST_PREFIX));
    }
    if (lane == 0) carry_v = cv;
  }
  __syncthreads();
  const Pos2 before = op(carry_v, ev);
  int64_t* row = (int64_t*)(stage + p.chunk * S::PITCH);
  // the partition positions, then the peer positions, through the stage
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const unsigned m = which == 0 ? pm : qm;
    int64_t acc = which == 0 ? before.a : before.b;
#pragma unroll
    for (int k = 0; k < SS_ITEMS; ++k) {
      if ((m >> k) & 1u) acc = first + step * k;
      row[reverse ? SS_ITEMS - 1 - k : k] = acc;
    }
    __syncwarp();
    int64_t* out = which == 0 ? (reverse ? pe : ps) : (reverse ? qe : qs);
    S::store(stage, out, p.r0, n, aligned16(out));
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Scratch: two ticket words (16 bytes), then the 16-byte descriptors of
// two directions, a tile each. The look-back clears its tickets and
// descriptors before a launch; the fixed carry-in's aggregates are
// written before they are read.
static int64_t tiles_of(int64_t n) { return (n + SS_TILE - 1) / SS_TILE; }

static ulonglong2* descriptors(void* scratch, int64_t tiles, int dir) {
  return (ulonglong2*)((char*)scratch + 16) + dir * tiles;
}

template <typename T, typename Op, bool LAST>
static int run_scan(const void* x, const uint8_t* seg, int64_t n,
                    int reverse, void* out, void* scratch, cudaStream_t s) {
  const int64_t tiles = tiles_of(n);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ulonglong2* desc = descriptors(scratch, tiles, 0);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(16 + 16 * tiles), s);
  if (e != cudaSuccess) return (int)e;
  ss_scan_kernel<T, Op, LAST, CARRY_LOOKBACK>
      <<<(unsigned)tiles, SS_THREADS, 0, s>>>(
          x, seg, n, reverse, (T*)out, (unsigned*)scratch, desc,
          (unsigned)tiles);
  return (int)cudaGetLastError();
}

// float64 add: aggregates, then the scan from a fixed carry-in
static int run_float_sum(const void* x, const uint8_t* seg, int64_t n,
                         int reverse, void* out, void* scratch,
                         cudaStream_t s) {
  const int64_t tiles = tiles_of(n);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ulonglong2* agg = descriptors(scratch, tiles, 0);
  ss_reduce_kernel<double, AddOp<double>>
      <<<(unsigned)tiles, SS_THREADS, 0, s>>>(x, seg, n, reverse, agg,
                                              (unsigned)tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // a programmatic dependent launch: the scan's blocks load and scan
  // their tiles while the first launch runs, and wait for its aggregates
  // only for the carry-in
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(SS_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, ss_scan_kernel<double, AddOp<double>, false, CARRY_FIXED>, x,
      seg, n, reverse, (double*)out, (unsigned*)nullptr, agg,
      (unsigned)tiles);
}

template <typename T>
static int dispatch_op(int op, const void* x, const uint8_t* seg, int64_t n,
                       int reverse, void* out, void* scratch,
                       cudaStream_t s) {
  switch (op) {
    case OP_ADD:
      return run_scan<T, AddOp<T>, false>(x, seg, n, reverse, out, scratch, s);
    case OP_MIN:
      return run_scan<T, MinOp<T>, false>(x, seg, n, reverse, out, scratch, s);
    case OP_MAX:
      return run_scan<T, MaxOp<T>, false>(x, seg, n, reverse, out, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch that a segmented_scan or window_bounds call over
// n rows takes.
int64_t segmented_scan_scratch_words(int64_t n) {
  return (16 + 2 * 16 * tiles_of(n)) / 8;
}

// x: [n] values of `dtype` (op add/min/max) or bool present flags (op
// last); seg: [n] bool segment starts in scan order, or null; out: [n] of
// `dtype` (int64 for last); scratch: segmented_scan_scratch_words(n).
int segmented_scan(const void* x, int dtype, int op, int reverse,
                   const void* seg, int64_t n, void* out, void* scratch,
                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sg = (const uint8_t*)seg;
  if (op == OP_LAST) {
    if (dtype != DT_I64) return (int)cudaErrorInvalidValue;
    return run_scan<int64_t, LastOp, true>(x, sg, n, reverse, out, scratch,
                                           s);
  }
  switch (dtype) {
    case DT_F64:
      if (op == OP_ADD)
        return run_float_sum(x, sg, n, reverse, out, scratch, s);
      return dispatch_op<double>(op, x, sg, n, reverse, out, scratch, s);
    case DT_I64:
      return dispatch_op<int64_t>(op, x, sg, n, reverse, out, scratch, s);
    case DT_I32:
      return dispatch_op<int32_t>(op, x, sg, n, reverse, out, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// part_start, peer_start: [n] bool; ps, pe, qs, qe: [n] int64 out (the
// last partition start at or before each row, the first partition end at
// or after it, the same for peer groups; -1 where there is none);
// scratch: segmented_scan_scratch_words(n).
int window_bounds(const void* part_start, const void* peer_start, int64_t n,
                  void* ps, void* pe, void* qs, void* qe, void* scratch,
                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = tiles_of(n);
  if (tiles > 0x3fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(16 + 32 * tiles), s);
  if (e != cudaSuccess) return (int)e;
  ss_bounds_kernel<<<(unsigned)(2 * tiles), SS_THREADS, 0, s>>>(
      (const uint8_t*)part_start, (const uint8_t*)peer_start, n,
      (int64_t*)ps, (int64_t*)pe, (int64_t*)qs, (int64_t*)qe,
      (unsigned*)scratch, descriptors(scratch, tiles, 0),
      descriptors(scratch, tiles, 1), (unsigned)tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
