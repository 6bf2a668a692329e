// K7 segmented_scan: one inclusive scan, optionally segmented and
// optionally reversed, under add, min, max or "last present position".
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
// order.
//
// min and max propagate NaN, as jnp.minimum and jnp.maximum do (CUDA's
// fmin/fmax would drop it), so the comparisons are written out. Integer
// sums wrap (computed in unsigned arithmetic).
//
// Three launches on the caller's stream, as K2 (compact.cu):
//   1. reduce: one block per tile of SS_TILE scan positions folds its
//      (value, segment flag) pairs (block_exclusive_seg_scan in
//      block_scan.cuh) into one pair per tile;
//   2. carry:  one block scans the tile pairs into each tile's exclusive
//      carry-in;
//   3. scan:   each block refolds its tile from its carry and writes the
//      inclusive results.
// Bound on an H100: memory. The work reads each value (4-8 B, or 1 B of
// `present`) and its segment flag (1 B) once and writes one result
// (4-8 B); this kernel reads the inputs twice (reduce and scan), so it
// moves about 1.6x the bytes the function must. The per-tile pairs are
// 1/2048 of the rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

#define SS_THREADS 256
#define SS_ITEMS 8
#define SS_TILE (SS_THREADS * SS_ITEMS)   // = ops/scan.SCAN_TILE
#define CARRY_THREADS 1024

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2 };
enum { OP_ADD = 0, OP_MIN = 1, OP_MAX = 2, OP_LAST = 3 };

template <typename T>
struct AddOp {
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
  static __device__ __forceinline__ T ident() { return (T)0; }
};
template <>
struct AddOp<int64_t> {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return (int64_t)((uint64_t)a + (uint64_t)b);
  }
  static __device__ __forceinline__ int64_t ident() { return 0; }
};
template <>
struct AddOp<int32_t> {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  static __device__ __forceinline__ int32_t ident() { return 0; }
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
};

template <typename T>
struct MaxOp {
  __device__ __forceinline__ T operator()(T a, T b) const {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b > a ? b : a;
  }
  static __device__ __forceinline__ T ident() { return lowest<T>(); }
};

// positions: the later present one wins; -1 is "none"
struct LastOp {
  __device__ __forceinline__ int64_t operator()(int64_t a, int64_t b) const {
    return b >= 0 ? b : a;
  }
  static __device__ __forceinline__ int64_t ident() { return -1; }
};

// The value at scan position p (row `phys`): x itself, or for "last" the
// row's position where it is present.
template <typename T, bool LAST>
static __device__ __forceinline__ T load_item(const void* x, int64_t phys) {
  if (LAST) return ((const uint8_t*)x)[phys] ? (T)phys : (T)-1;
  return ((const T*)x)[phys];
}

template <typename T, typename Op, bool LAST>
__global__ void ss_reduce_kernel(const void* __restrict__ x,
                                 const uint8_t* __restrict__ seg, int64_t n,
                                 int reverse, T* __restrict__ tile_v,
                                 uint8_t* __restrict__ tile_f) {
  const Op op{};
  const int64_t base = (int64_t)blockIdx.x * SS_TILE
                       + (int64_t)threadIdx.x * SS_ITEMS;
  T v = Op::ident();
  int f = 0;
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) {
    const int64_t p = base + k;
    if (p >= n) break;
    const int64_t phys = reverse ? n - 1 - p : p;
    const T e = load_item<T, LAST>(x, phys);
    const int ef = seg != nullptr && seg[phys];
    v = ef ? e : op(v, e);
    f |= ef;
  }
  T ev, tv;
  int ef, tf;
  block_exclusive_seg_scan(v, f, Op::ident(), op, &ev, &ef, &tv, &tf);
  if (threadIdx.x == 0) {
    tile_v[blockIdx.x] = tv;
    tile_f[blockIdx.x] = (uint8_t)tf;
  }
}

// One block: tile pairs (in) -> each tile's exclusive carry-in (out).
template <typename T, typename Op>
__global__ void ss_carry_kernel(T* __restrict__ tile_v,
                                uint8_t* __restrict__ tile_f,
                                int64_t ntiles) {
  const Op op{};
  T carry_v = Op::ident();
  int carry_f = 0;
  for (int64_t start = 0; start < ntiles; start += blockDim.x) {
    const int64_t j = start + threadIdx.x;
    const T v = j < ntiles ? tile_v[j] : Op::ident();
    const int f = j < ntiles ? tile_f[j] : 0;
    T ev, tv;
    int ef, tf;
    block_exclusive_seg_scan(v, f, Op::ident(), op, &ev, &ef, &tv, &tf);
    if (j < ntiles) {
      tile_v[j] = ef ? ev : op(carry_v, ev);
      tile_f[j] = (uint8_t)(carry_f | ef);
    }
    carry_v = tf ? tv : op(carry_v, tv);
    carry_f |= tf;
  }
}

template <typename T, typename Op, bool LAST>
__global__ void ss_scan_kernel(const void* __restrict__ x,
                               const uint8_t* __restrict__ seg, int64_t n,
                               int reverse, const T* __restrict__ tile_v,
                               T* __restrict__ out) {
  const Op op{};
  const int64_t base = (int64_t)blockIdx.x * SS_TILE
                       + (int64_t)threadIdx.x * SS_ITEMS;
  T items[SS_ITEMS];
  int flags[SS_ITEMS];
  T v = Op::ident();
  int f = 0;
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) {
    const int64_t p = base + k;
    items[k] = Op::ident();
    flags[k] = 0;
    if (p < n) {
      const int64_t phys = reverse ? n - 1 - p : p;
      items[k] = load_item<T, LAST>(x, phys);
      flags[k] = seg != nullptr && seg[phys];
    }
    v = flags[k] ? items[k] : op(v, items[k]);
    f |= flags[k];
  }
  T ev, tv;
  int ef, tf;
  block_exclusive_seg_scan(v, f, Op::ident(), op, &ev, &ef, &tv, &tf);
  // the fold of everything before this thread's first row: the tile's
  // carry-in, then the threads before it in the tile
  T acc = ef ? ev : op(tile_v[blockIdx.x], ev);
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) {
    const int64_t p = base + k;
    if (p >= n) break;
    acc = flags[k] ? items[k] : op(acc, items[k]);
    out[reverse ? n - 1 - p : p] = acc;
  }
}

template <typename T, typename Op, bool LAST>
static int run_scan(const void* x, const uint8_t* seg, int64_t n,
                    int reverse, void* out, void* carry_v, void* carry_f,
                    cudaStream_t s) {
  const int64_t ntiles = (n + SS_TILE - 1) / SS_TILE;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  T* tv = (T*)carry_v;
  uint8_t* tf = (uint8_t*)carry_f;
  ss_reduce_kernel<T, Op, LAST><<<(unsigned)ntiles, SS_THREADS, 0, s>>>(
      x, seg, n, reverse, tv, tf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ss_carry_kernel<T, Op><<<1, CARRY_THREADS, 0, s>>>(tv, tf, ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ss_scan_kernel<T, Op, LAST><<<(unsigned)ntiles, SS_THREADS, 0, s>>>(
      x, seg, n, reverse, tv, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_op(int op, const void* x, const uint8_t* seg, int64_t n,
                       int reverse, void* out, void* cv, void* cf,
                       cudaStream_t s) {
  switch (op) {
    case OP_ADD:
      return run_scan<T, AddOp<T>, false>(x, seg, n, reverse, out, cv, cf, s);
    case OP_MIN:
      return run_scan<T, MinOp<T>, false>(x, seg, n, reverse, out, cv, cf, s);
    case OP_MAX:
      return run_scan<T, MaxOp<T>, false>(x, seg, n, reverse, out, cv, cf, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: [n] values of `dtype` (op add/min/max) or bool present flags (op
// last); seg: [n] bool segment starts in scan order, or null; out: [n] of
// `dtype` (int64 for last); carry_v: [ceil(n / SS_TILE)] of out's dtype and
// carry_f: as many bytes, scratch.
int segmented_scan(const void* x, int dtype, int op, int reverse,
                   const void* seg, int64_t n, void* out, void* carry_v,
                   void* carry_f, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* sg = (const uint8_t*)seg;
  if (op == OP_LAST) {
    if (dtype != DT_I64) return (int)cudaErrorInvalidValue;
    return run_scan<int64_t, LastOp, true>(x, sg, n, reverse, out, carry_v,
                                           carry_f, s);
  }
  switch (dtype) {
    case DT_F64:
      return dispatch_op<double>(op, x, sg, n, reverse, out, carry_v,
                                 carry_f, s);
    case DT_I64:
      return dispatch_op<int64_t>(op, x, sg, n, reverse, out, carry_v,
                                  carry_f, s);
    case DT_I32:
      return dispatch_op<int32_t>(op, x, sg, n, reverse, out, carry_v,
                                  carry_f, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
