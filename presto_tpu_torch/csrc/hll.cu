// K12 hll_registers: the HyperLogLog registers of approx_distinct, per
// group, and per group the two sums the estimate needs.
//
// Replaces presto_tpu/ops/aggregate.py:_hll_reg_rank (:71) and the
// register maxima of approx_distinct's direct (:368) and sorted (:710)
// branches, which the JAX package takes with a sort by (group, register,
// -rank). Per live row: h = mix64(bits + GOLDEN) over the value's bits
// (integers sign-extended, floats through f64_hash_lane; mix64.cuh, shared
// with K4), register = the low 11 bits, and the rank from a float32 frexp
// of w = h >> 11 rounded to nearest even (__ll2float_rn: w < 2^53, so the
// signed conversion is exact in range), as the JAX function takes it: the
// rounding moves w across a power of two for about 2^-24 of the values,
// and w >= 2^53 - 2^28 rounds to 2^53 and gives rank 0. A register holds
// rank + 1 (one byte, 1..55), so 0 marks an empty register and a rank of 0
// still counts as present, as the first row of its run does in the JAX
// sort. Per group the kernel writes present = sum of 2^-rank over the
// non-empty registers (float64) and their count. Every term is a power of
// two and the sum is at most 2048, so every partial sum is a multiple of
// the smallest term below 2^11: exact in any order, and so bit for bit the
// plain version's and the same from launch to launch, while the largest
// rank stays below 42 (2^11 / 2^-42 = 2^53; a rank r has probability
// 2^-r).
//
// Registers are kept in shared memory: a byte each (2 KB a table), raised
// by a compare-and-swap on their word after reading it; or, where the
// tables fit, a 32-bit word each (8 KB a table), raised by one atomicMax
// after reading it, with no retry loop. Either way a row that does not
// raise its register (every row after the first where all rows hold one
// value) writes nothing. Tables are merged with 16-byte accesses and
// __vmaxu4 over bytes, never by an atomic per register.
//
// Direct mode (bins of the mixed-radix key code, at most 64; global
// aggregation is one bin), two launches: (1) blocks of DIRECT_THREADS
// threads, two an SM, one row a thread at a time; every bin's table in
// the block's shared memory (word tables up to WORD_BINS bins, byte tables
// past that); each block writes its tables as bytes to scratch; (2) the
// finish, a programmatic dependent launch: FSPLIT blocks a bin max-reduce
// a share of the block tables each (FB loads in flight a thread), and the
// last of them to finish (a counter the first pass clears) merges their
// partial tables, writes the registers as int32 (so the caller zeroes
// nothing) and sums the bin.
//
// Sorted mode (contiguous, disjoint group runs of a group-sorted page,
// starts and ends per group), a memset of the list heads and two
// launches, so that a group's cost follows its rows: (1) one thread a
// group; a group of at most SMALL_MAX rows is deduped in registers (a
// one-row group touches no table), a longer one is listed; (2) a
// programmatic dependent launch of 16-warp blocks: a warp takes a listed
// group of at most PIECE rows by ticket, with a 2 KB byte table of its
// own, cleared and summed with 16-byte accesses and warp shuffles, so it
// waits on no barrier of the block; then the blocks deal the pieces of the
// groups longer than PIECE rows among themselves (pieces of PIECE rows or
// more, as many as the blocks where the groups are few), a piece to a
// block with a word table; a group of several pieces has each piece's
// table written to scratch as bytes, and the block that finishes its last
// piece (a counter per group) max-reduces them and sums.
//
// Bound on an H100: memory. Each live row's value (4-8 B) and flag (1 B),
// in direct mode its bin code (4 B); per group its start and end (16 B)
// and two results (16 B); direct mode writes each bin's registers (8 KB).
// What holds it back is each row's chain of dependent steps: its flag,
// then its value and code, the hash (two 64-bit multiplies, a float
// conversion), then the register's read and raise; a thread takes its
// rows one after another, so occupancy, not bandwidth, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mix64.cuh"

#define HLL_P 11
#define HLL_M (1 << HLL_P)        // = ops/aggregate._HLL_M
#define HLL_CHUNKS (HLL_M / 16)   // 16-byte chunks of a byte table
#define SMALL_MAX 32              // = ops/aggregate.HLL_SMALL_MAX
#define PIECE 4096                // = ops/aggregate.HLL_PIECE
#define DIRECT_THREADS 1024
#define WORD_BINS 14              // word tables up to 14 bins (112 KB)
#define FSPLIT 16                 // finish blocks a bin
#define FB 8                      // loads in flight a thread in the merges
#define GROUP_THREADS 512         // sorted mode's second pass: 16 warps
#define GROUP_WARPS (GROUP_THREADS / 32)
#define GROUP_BLOCKS 3            // its blocks an SM
#define SMALL_THREADS 128
#define FULL 0xffffffffu

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2 };

// waits until the grid this one was launched behind (a programmatic
// dependent launch) has finished and its writes are visible; PTX
// griddepcontrol, sm_90
static __device__ __forceinline__ void wait_for_prior_grid() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// row i's value as 64 bits (int32 sign-extended; float64 as its bits)
static __device__ __forceinline__ uint64_t load_raw(const void* values,
                                                    int dtype, int64_t i) {
  if (dtype == DT_I32)
    return (uint64_t)(int64_t)((const int32_t*)values)[i];
  return ((const uint64_t*)values)[i];
}

// register << 8 | (rank + 1) of a value's raw bits
static __device__ __forceinline__ uint32_t hll_code(uint64_t raw,
                                                    int dtype) {
  const uint64_t bits =
      dtype == DT_F64 ? f64_hash_lane(__longlong_as_double((long long)raw))
                      : raw;
  const uint64_t h = mix64(bits + GOLDEN);
  const uint32_t reg = (uint32_t)(h & (HLL_M - 1));
  const uint64_t w = h >> HLL_P;
  int rank = 64 - HLL_P + 1;
  if (w != 0) {
    const float f = __ll2float_rn((long long)w);
    const int e = (int)((__float_as_uint(f) >> 23) & 0xffu) - 126;  // frexp
    rank = (64 - HLL_P) - (e - 1);
  }
  return (reg << 8) | (uint32_t)(rank + 1);
}

// 2^-(v - 1): a register's term, v = rank + 1 > 0
static __device__ __forceinline__ double term(uint32_t v) {
  return __longlong_as_double((long long)(1023 + 1 - (int)v) << 52);
}

// byte idx of the shared byte array at `words` raised to at least v
static __device__ __forceinline__ void byte_max(uint32_t* words, uint32_t idx,
                                                uint32_t v) {
  uint32_t* w = words + (idx >> 2);
  const uint32_t sh = (idx & 3u) * 8u;
  uint32_t old = *(volatile uint32_t*)w;
  while (((old >> sh) & 0xffu) < v) {
    const uint32_t prev =
        atomicCAS(w, old, (old & ~(0xffu << sh)) | (v << sh));
    if (prev == old) break;
    old = prev;
  }
}

// rows i, i + step, ... below end into the byte table at `reg`, two
// loads of each kind in flight
static __device__ __forceinline__ void rows_into(
    uint32_t* reg, const void* __restrict__ values, int dtype,
    const uint8_t* __restrict__ live, int64_t i, int64_t end, int step) {
  for (; i + step < end; i += 2 * (int64_t)step) {
    uint8_t lv[2];
    uint64_t raw[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lv[u] = live[i + u * step];
      raw[u] = load_raw(values, dtype, i + u * step);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!lv[u]) continue;
      const uint32_t c = hll_code(raw[u], dtype);
      byte_max(reg, c >> 8, c & 0xffu);
    }
  }
  if (i < end && live[i]) {
    const uint32_t c = hll_code(load_raw(values, dtype, i), dtype);
    byte_max(reg, c >> 8, c & 0xffu);
  }
}

// register idx of a table of one 32-bit word a register raised to at
// least v
static __device__ __forceinline__ void word_max(uint32_t* words,
                                                uint32_t idx, uint32_t v) {
  if (words[idx] < v) atomicMax(words + idx, v);
}

// registers 16 k .. 16 k + 15 of a word table as a 16-byte chunk of bytes
static __device__ __forceinline__ uint4 pack_chunk(const uint32_t* words,
                                                   int k) {
  const uint4* w = (const uint4*)words + 4 * k;
  uint32_t b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 x = w[q];
    b[q] = x.x | (x.y << 8) | (x.z << 16) | (x.w << 24);
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

static __device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

// the terms and the non-empty registers of a 16-byte chunk, added to p, c
static __device__ __forceinline__ void chunk_sums(uint4 m, double& p,
                                                  int& c) {
  const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t v = (w[k] >> (8 * b)) & 0xffu;
      if (v) {
        p += term(v);
        ++c;
      }
    }
  }
}

static __device__ __forceinline__ void warp_sums(double& p, int& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p += __shfl_xor_sync(FULL, p, o);
    c += __shfl_xor_sync(FULL, c, o);
  }
}

// The sums of one table whose chunk tid is m in threads 0 .. HLL_CHUNKS -
// 1, into group g; every thread of the block calls it.
static __device__ void table_sums(uint4 m, int64_t g,
                                  double* __restrict__ present,
                                  int64_t* __restrict__ count) {
  __shared__ double ps[HLL_CHUNKS / 32];
  __shared__ int cs[HLL_CHUNKS / 32];
  if (threadIdx.x < HLL_CHUNKS) {
    double p = 0.0;
    int c = 0;
    chunk_sums(m, p, c);
    warp_sums(p, c);
    if ((threadIdx.x & 31) == 0) {
      ps[threadIdx.x >> 5] = p;
      cs[threadIdx.x >> 5] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double p = 0.0;
    int c = 0;
    for (int k = 0; k < HLL_CHUNKS / 32; ++k) {
      p += ps[k];
      c += cs[k];
    }
    present[g] = p;
    count[g] = c;
  }
  __syncthreads();
}

// direct mode 1: every bin's registers in the block's shared memory (a
// word each where WORDS, else a byte), then the block's tables as bytes to
// tables[blockIdx.x]; block 0 clears the finish's counters
template <bool WORDS>
__global__ void __launch_bounds__(DIRECT_THREADS, 2) hll_direct_kernel(
    const void* __restrict__ values, int dtype,
    const int32_t* __restrict__ code, const uint8_t* __restrict__ live,
    int64_t n, int bins, uint4* __restrict__ tables) {
  extern __shared__ uint4 stab[];
  uint32_t* sreg = (uint32_t*)stab;
  const int chunks = bins * HLL_CHUNKS;
  for (int k = threadIdx.x; k < (WORDS ? 4 : 1) * chunks;
       k += DIRECT_THREADS)
    stab[k] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * DIRECT_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * DIRECT_THREADS + threadIdx.x; i < n;
       i += step) {
    if (!live[i]) continue;
    const uint32_t c = hll_code(load_raw(values, dtype, i), dtype);
    const uint32_t idx = (uint32_t)code[i] * HLL_M + (c >> 8);
    if (WORDS)
      word_max(sreg, idx, c & 0xffu);
    else
      byte_max(sreg, idx, c & 0xffu);
  }
  __syncthreads();
  uint4* out = tables + (int64_t)blockIdx.x * chunks;
  for (int k = threadIdx.x; k < chunks; k += DIRECT_THREADS)
    out[k] = WORDS ? pack_chunk(sreg, k) : stab[k];
  if (blockIdx.x == 0 && threadIdx.x < bins)
    ((int*)(tables + (int64_t)gridDim.x * chunks + (int64_t)bins * FSPLIT
            * HLL_CHUNKS))[threadIdx.x] = 0;
}

// direct mode 2: blocks (b, s) of bin b max-reduce the block tables s, s +
// FSPLIT, ... (half the threads each half of them) into a partial table;
// the last of a bin's blocks to finish (a counter) merges the partials,
// writes the registers as int32 and sums
__global__ void __launch_bounds__(2 * HLL_CHUNKS) hll_finish_kernel(
    const uint4* __restrict__ tables, int ntables, int bins,
    int32_t* __restrict__ regs, double* __restrict__ present,
    int64_t* __restrict__ count) {
  __shared__ uint4 s_m[2 * HLL_CHUNKS];
  __shared__ int s_last;
  wait_for_prior_grid();
  const int b = blockIdx.x / FSPLIT, sp = blockIdx.x % FSPLIT;
  const int c = threadIdx.x % HLL_CHUNKS, h = threadIdx.x / HLL_CHUNKS;
  const int64_t chunks = (int64_t)bins * HLL_CHUNKS;
  uint4* partial = (uint4*)tables + (int64_t)ntables * chunks;
  int* done = (int*)(partial + chunks * FSPLIT);
  uint4 m = make_uint4(0, 0, 0, 0);
  for (int k0 = sp + FSPLIT * h; k0 < ntables; k0 += 2 * FB * FSPLIT) {
    uint4 x[FB];
#pragma unroll
    for (int u = 0; u < FB; ++u) {
      const int k = k0 + 2 * FSPLIT * u;
      x[u] = k < ntables ? __ldcg(tables + k * chunks + b * HLL_CHUNKS + c)
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < FB; ++u) m = vmax4(m, x[u]);
  }
  s_m[threadIdx.x] = m;
  __syncthreads();
  if (h == 0)
    partial[((int64_t)b * FSPLIT + sp) * HLL_CHUNKS + c] =
        vmax4(m, s_m[c + HLL_CHUNKS]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&done[b], 1) == FSPLIT - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  m = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int q = h; q < FSPLIT; q += 2)
    m = vmax4(m, __ldcg(partial + ((int64_t)b * FSPLIT + q) * HLL_CHUNKS + c));
  s_m[threadIdx.x] = m;
  __syncthreads();
  if (h == 0) {
    m = vmax4(m, s_m[c + HLL_CHUNKS]);
    int4* out = (int4*)(regs + (int64_t)b * HLL_M + 16 * c);
    const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = make_int4(w[k] & 0xff, (w[k] >> 8) & 0xff,
                         (w[k] >> 16) & 0xff, w[k] >> 24);
  }
  table_sums(m, b, present, count);
}

static __device__ __forceinline__ void clamp_run(const int64_t* starts,
                                                 const int64_t* ends,
                                                 int64_t g, int64_t n,
                                                 int64_t* s, int64_t* e) {
  int64_t a = starts[g], b = ends[g];
  a = a < 0 ? 0 : (a > n ? n : a);
  b = b < a ? a : (b > n ? n : b);
  *s = a;
  *e = b;
}

// The sorted mode's scratch, in int64 words: the heads (int32: the warp
// list's length, the long list's length, the warp ticket) and a finished-
// piece counter per long group, which the memset zeroes; the two lists
// (int32 group numbers); the pieces' tables (2 KB each). Runs are
// disjoint, so at most n / (SMALL_MAX + 1) groups are listed for a warp,
// n / (PIECE + 1) are long, and their pieces (PIECE rows or more, a
// partial one per group) number fewer than 2 n / PIECE + 1.
struct SortedLayout {
  int64_t warp_max, long_max, pieces_max;
  int64_t done, warp_list, long_list, tables, zeroed, words;
};

static SortedLayout sorted_layout(int64_t n) {
  SortedLayout l;
  l.warp_max = n / (SMALL_MAX + 1) + 1;
  l.long_max = n / (PIECE + 1) + 1;
  l.pieces_max = 2 * n / PIECE + 1;
  l.done = 2;
  l.warp_list = l.done + (l.long_max + 1) / 2;
  l.zeroed = l.warp_list;
  l.long_list = l.warp_list + (l.warp_max + 1) / 2;
  l.tables = l.long_list + (l.long_max + 1) / 2;
  l.tables += l.tables & 1;              // 16-byte aligned
  l.words = l.tables + l.pieces_max * (HLL_M / 8);
  return l;
}

// sorted mode 1: one thread per group. A group of at most SMALL_MAX rows
// is deduped in registers; a longer one is listed for pass 2 (for a warp
// up to PIECE rows, else in pieces).
__global__ void hll_small_kernel(const void* __restrict__ values, int dtype,
                                 const uint8_t* __restrict__ live,
                                 const int64_t* __restrict__ starts,
                                 const int64_t* __restrict__ ends,
                                 int64_t groups, int64_t n,
                                 double* __restrict__ present,
                                 int64_t* __restrict__ count,
                                 int32_t* __restrict__ heads,
                                 int32_t* __restrict__ warp_list,
                                 int32_t* __restrict__ long_list) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  int64_t s, e;
  clamp_run(starts, ends, g, n, &s, &e);
  if (e - s > SMALL_MAX) {
    if (e - s > PIECE)
      long_list[atomicAdd(&heads[1], 1)] = (int32_t)g;
    else
      warp_list[atomicAdd(&heads[0], 1)] = (int32_t)g;
    return;
  }
  uint32_t seen[SMALL_MAX];   // register << 8 | (rank + 1), one per register
  int m = 0;
  for (int64_t i = s; i < e; ++i) {
    if (!live[i]) continue;
    const uint32_t c = hll_code(load_raw(values, dtype, i), dtype);
    int j = 0;
    while (j < m && (seen[j] >> 8) != (c >> 8)) ++j;
    if (j == m)
      seen[m++] = c;
    else if ((seen[j] & 0xffu) < (c & 0xffu))
      seen[j] = c;
  }
  double p = 0.0;
  for (int j = 0; j < m; ++j) p += term(seen[j] & 0xffu);
  present[g] = p;
  count[g] = m;
}

// sorted mode 2: the listed groups, a warp a group of at most PIECE rows,
// then a block a piece of the longer ones
__global__ void __launch_bounds__(GROUP_THREADS, GROUP_BLOCKS)
    hll_group_kernel(
    const void* __restrict__ values, int dtype,
    const uint8_t* __restrict__ live, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ ends, int64_t n, int32_t* heads,
    int32_t* done, const int32_t* __restrict__ warp_list,
    const int32_t* __restrict__ long_list, uint4* __restrict__ tables,
    double* __restrict__ present, int64_t* __restrict__ count) {
  __shared__ uint4 stab[GROUP_WARPS][HLL_CHUNKS];   // a table a warp
  __shared__ uint4 s_red[GROUP_THREADS];
  __shared__ int64_t s_piece;
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  wait_for_prior_grid();                 // the lists
  const int n_warp = heads[0], n_long = heads[1];
  uint4* wt = stab[warp];
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&heads[2], 1);
    i = __shfl_sync(FULL, i, 0);
    if (i >= n_warp) break;
    const int64_t g = warp_list[i];
    int64_t s, e;
    clamp_run(starts, ends, g, n, &s, &e);
#pragma unroll
    for (int k = 0; k < HLL_CHUNKS / 32; ++k)
      wt[lane + 32 * k] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    rows_into((uint32_t*)wt, values, dtype, live, s + lane, e, 32);
    __syncwarp();
    double p = 0.0;
    int c = 0;
#pragma unroll
    for (int k = 0; k < HLL_CHUNKS / 32; ++k)
      chunk_sums(wt[lane + 32 * k], p, c);
    warp_sums(p, c);
    if (lane == 0) {
      present[g] = p;
      count[g] = c;
    }
    __syncwarp();                        // read before the next clear
  }
  if (n_long == 0) return;
  // the piece length: PIECE rows, or more where the long groups' rows
  // spread over the blocks in one round (a partial piece a group)
  if (warp == 0) {
    int64_t rows = 0;
    for (int i = lane; i < n_long; i += 32) {
      int64_t s, e;
      clamp_run(starts, ends, long_list[i], n, &s, &e);
      rows += e - s;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rows += __shfl_xor_sync(FULL, rows, o);
    if (lane == 0) {
      const int64_t grid = gridDim.x;
      const int64_t slots = n_long < grid / 2 ? grid - n_long : grid;
      const int64_t even = (rows + slots - 1) / slots;
      s_piece = even > PIECE ? even : PIECE;
    }
  }
  __syncthreads();                       // and every warp's table is free
  const int64_t piece = s_piece;
  const int64_t grid = gridDim.x;
  int64_t dealt = 0;                     // pieces of the groups before
  for (int gi = 0; gi < n_long; ++gi) {
    const int64_t g = long_list[gi];
    int64_t s, e;
    clamp_run(starts, ends, g, n, &s, &e);
    const int64_t pieces = (e - s + piece - 1) / piece;
    for (int64_t q = ((int64_t)blockIdx.x - dealt % grid + grid) % grid;
         q < pieces; q += grid) {
      const int64_t lo = s + q * piece, hi = lo + piece < e ? lo + piece : e;
      // a word a register in the first 8 KB of the warp tables (the
      // previous piece's last reads of it are behind a barrier)
      ((uint4*)stab)[tid] = make_uint4(0, 0, 0, 0);
      __syncthreads();
      // two rows a thread at a time, their loads together
      int64_t i = lo + tid;
      for (; i + GROUP_THREADS < hi; i += 2 * GROUP_THREADS) {
        uint8_t lv[2];
        uint64_t raw[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          lv[u] = live[i + u * GROUP_THREADS];
          raw[u] = load_raw(values, dtype, i + u * GROUP_THREADS);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (!lv[u]) continue;
          const uint32_t c = hll_code(raw[u], dtype);
          word_max((uint32_t*)stab, c >> 8, c & 0xffu);
        }
      }
      if (i < hi && live[i]) {
        const uint32_t c = hll_code(load_raw(values, dtype, i), dtype);
        word_max((uint32_t*)stab, c >> 8, c & 0xffu);
      }
      __syncthreads();
      // the piece's registers as bytes, chunk tid by thread tid
      const uint4 piece_chunk = tid < HLL_CHUNKS
          ? pack_chunk((const uint32_t*)stab, tid) : make_uint4(0, 0, 0, 0);
      if (pieces == 1) {
        table_sums(piece_chunk, g, present, count);
        continue;
      }
      if (tid < HLL_CHUNKS)
        tables[(dealt + q) * HLL_CHUNKS + tid] = piece_chunk;
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicAdd(&done[gi], 1) == (int)pieces - 1;
      __syncthreads();
      if (!s_last) continue;
      // the group's last piece: the maxima over its pieces' tables, a
      // quarter of the block a quarter of the pieces
      __threadfence();
      const int c = tid % HLL_CHUNKS, qq = tid / HLL_CHUNKS;
      uint4 m = make_uint4(0, 0, 0, 0);
      for (int64_t k0 = dealt + qq; k0 < dealt + pieces;
           k0 += FB * (GROUP_THREADS / HLL_CHUNKS)) {
        uint4 x[FB];
#pragma unroll
        for (int u = 0; u < FB; ++u) {
          const int64_t k = k0 + u * (GROUP_THREADS / HLL_CHUNKS);
          x[u] = k < dealt + pieces ? __ldcg(tables + k * HLL_CHUNKS + c)
                                    : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < FB; ++u) m = vmax4(m, x[u]);
      }
      s_red[tid] = m;
      __syncthreads();
      if (tid < HLL_CHUNKS)
        for (int k = 1; k < GROUP_THREADS / HLL_CHUNKS; ++k)
          m = vmax4(m, s_red[tid + k * HLL_CHUNKS]);
      table_sums(m, g, present, count);
    }
    dealt += pieces;
  }
}

// direct mode's tables: a word a register up to WORD_BINS bins
static bool direct_words(int bins) { return bins <= WORD_BINS; }

static int direct_smem(int bins) {
  return bins * HLL_M * (direct_words(bins) ? 4 : 1);
}

// direct mode's grid: at least 32 rows a thread, two blocks an SM at the
// most (one where the tables take more than half an SM's shared memory)
static int64_t direct_blocks(int64_t n, int bins) {
  const int64_t most = direct_smem(bins) <= 112 * 1024 ? 2 * 132 : 132;
  const int64_t blocks =
      (n + DIRECT_THREADS * 32 - 1) / (DIRECT_THREADS * 32);
  return blocks < most ? blocks : most;
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch a call over n rows takes: in direct mode (bins >
// 0) a set of bins tables a cluster, in sorted mode (bins = 0) the
// SortedLayout.
int64_t hll_scratch_words(int64_t n, int bins) {
  if (n < 0) n = 0;
  if (bins > 0)   // block tables, partial tables, counters
    return (direct_blocks(n, bins) + FSPLIT) * bins * (HLL_M / 8) + bins;
  return sorted_layout(n).words;
}

// Direct mode. values: [n] (dtype 0 float64, 1 int64, 2 int32); code: [n]
// int32 bin of each row, in [0, bins); live: [n] uint8; scratch:
// hll_scratch_words(n, bins) int64; regs: [bins, 2048] int32 out (rank + 1
// per register, 0 if empty); present: [bins] float64 out; count: [bins]
// int64 out.
int hll_direct(const void* values, int dtype, const void* code,
               const void* live, int64_t n, int bins, void* scratch,
               void* regs, void* present, void* count, void* stream) {
  if (dtype < DT_F64 || dtype > DT_I32 || bins < 1 || bins > 64 || n < 0
      || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = direct_smem(bins);
  const int64_t blocks = direct_blocks(n, bins);
  cudaError_t e;
  if (blocks > 0) {
    const bool words = direct_words(bins);
    e = cudaFuncSetAttribute(
        words ? hll_direct_kernel<true> : hll_direct_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (words)
      hll_direct_kernel<true><<<(unsigned)blocks, DIRECT_THREADS, smem, s>>>(
          values, dtype, (const int32_t*)code, (const uint8_t*)live, n, bins,
          (uint4*)scratch);
    else
      hll_direct_kernel<false><<<(unsigned)blocks, DIRECT_THREADS, smem, s>>>(
          values, dtype, (const int32_t*)code, (const uint8_t*)live, n, bins,
          (uint4*)scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {                               // the counters the row pass clears
    e = cudaMemsetAsync((char*)scratch + (size_t)FSPLIT * bins * HLL_M, 0,
                        (size_t)bins * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  // launched behind the row pass as a programmatic dependent launch, which
  // waits for it on the card
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bins * FSPLIT));
  cfg.blockDim = dim3(2 * HLL_CHUNKS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = blocks > 0 ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, hll_finish_kernel, (const uint4*)scratch,
      (int)blocks, bins, (int32_t*)regs, (double*)present,
      (int64_t*)count);
}

// Sorted mode. values: [n]; live: [n] uint8; starts, ends: [groups] int64
// disjoint row runs (ends <= starts: an empty group); scratch:
// hll_scratch_words(n, 0) int64; present: [groups] float64 out; count:
// [groups] int64 out.
int hll_sorted(const void* values, int dtype, const void* live, int64_t n,
               const void* starts, const void* ends, int64_t groups,
               void* scratch, void* present, void* count, void* stream) {
  if (dtype < DT_F64 || dtype > DT_I32 || n < 0 || groups < 0 ||
      groups > 0x7fffffffLL || n > 0x7fffffffLL || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const SortedLayout l = sorted_layout(n);
  int64_t* w = (int64_t*)scratch;
  int32_t* heads = (int32_t*)w;
  cudaError_t e = cudaMemsetAsync(w, 0, (size_t)l.zeroed * 8, s);
  if (e != cudaSuccess) return (int)e;
  hll_small_kernel<<<(unsigned)((groups + SMALL_THREADS - 1) / SMALL_THREADS),
                     SMALL_THREADS, 0, s>>>(
      values, dtype, (const uint8_t*)live, (const int64_t*)starts,
      (const int64_t*)ends, groups, n, (double*)present, (int64_t*)count,
      heads, (int32_t*)(w + l.warp_list), (int32_t*)(w + l.long_list));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    return (int)cudaGetLastError();
  // a programmatic dependent launch behind the first pass, GROUP_BLOCKS
  // blocks an SM (the lists are read on the card)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(GROUP_BLOCKS * sms));
  cfg.blockDim = dim3(GROUP_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, hll_group_kernel, values, dtype, (const uint8_t*)live,
      (const int64_t*)starts, (const int64_t*)ends, n, heads,
      (int32_t*)(w + l.done), (const int32_t*)(w + l.warp_list),
      (const int32_t*)(w + l.long_list), (uint4*)(w + l.tables),
      (double*)present, (int64_t*)count);
}

}  // extern "C"
