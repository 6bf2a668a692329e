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
// two and the sum is at most 2048, so it is exact in any order while the
// largest rank stays below 42 (2^11 / 2^-42 = 2^53; a rank r has
// probability 2^-r): bit for bit the plain version's.
//
// Direct mode (bins of the mixed-radix key code, at most 64; global
// aggregation is one bin): each block keeps every bin's registers as bytes
// in shared memory (at most 128 KB), raises them with a compare-and-swap
// on their word, and merges its non-zero bytes into [bins, 2048] int32
// registers on the device with atomicMax; a finishing pass sums each bin.
//
// Sorted mode (contiguous group runs of a group-sorted page, starts and
// ends per group): one thread per group dedupes a group of at most 32 rows
// in registers (a one-row group touches no register table); a larger group
// goes to a list, and a block takes it in pieces of PIECE rows with its
// registers in shared memory. A group of one piece is summed by its block;
// a longer one is split across blocks that merge into its own slot of
// device registers with atomicMax, and a finishing pass sums each slot. So
// no huge group is left to one warp, and no small group clears 2048
// registers.
//
// Bound on an H100: memory. Each live row's value (4-8 B) and flag (1 B),
// in direct mode its bin code (4 B); per group its start and end (16 B)
// and two results (16 B). The hash is a few integer multiplies per row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mix64.cuh"

#define HLL_P 11
#define HLL_M (1 << HLL_P)        // = ops/aggregate._HLL_M
#define HLL_THREADS 512
#define SMALL_MAX 32              // = ops/aggregate.HLL_SMALL_MAX
#define PIECE 16384               // = ops/aggregate.HLL_PIECE
#define LARGE_BLOCKS (132 * 4)
#define SMALL_THREADS 128

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2 };

// register << 8 | (rank + 1) of row i's value
static __device__ __forceinline__ uint32_t hll_code(const void* values,
                                                    int dtype, int64_t i) {
  uint64_t bits;
  if (dtype == DT_F64)
    bits = f64_hash_lane(((const double*)values)[i]);
  else if (dtype == DT_I64)
    bits = (uint64_t)((const int64_t*)values)[i];
  else
    bits = (uint64_t)(int64_t)((const int32_t*)values)[i];
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

// the block's sums of (term, 1) over its threads' registers; every thread
// of the block calls it, thread 0 gets the totals
static __device__ void block_sums(double p, int64_t c, double* present,
                                  int64_t* count) {
  __shared__ double ps[32];
  __shared__ int64_t cs[32];
  for (int o = 16; o > 0; o >>= 1) {
    p += __shfl_down_sync(0xffffffffu, p, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ps[warp] = p;
    cs[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tp = 0.0;
    int64_t tc = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      tp += ps[k];
      tc += cs[k];
    }
    *present = tp;
    *count = tc;
  }
  __syncthreads();
}

// direct mode: registers of every bin in shared memory, merged into regs
__global__ void hll_direct_kernel(const void* __restrict__ values, int dtype,
                                  const int32_t* __restrict__ code,
                                  const uint8_t* __restrict__ live,
                                  int64_t n, int bins,
                                  int32_t* __restrict__ regs) {
  extern __shared__ uint32_t sreg[];     // bins * HLL_M bytes
  const int words = bins * (HLL_M / 4);
  for (int k = threadIdx.x; k < words; k += blockDim.x) sreg[k] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!live[i]) continue;
    const uint32_t c = hll_code(values, dtype, i);
    byte_max(sreg, (uint32_t)code[i] * HLL_M + (c >> 8), c & 0xffu);
  }
  __syncthreads();
  const uint8_t* b = (const uint8_t*)sreg;
  for (int k = threadIdx.x; k < bins * HLL_M; k += blockDim.x)
    if (b[k]) atomicMax(&regs[k], (int)b[k]);
}

// per slot s < *n_slots (all of gridDim.x when n_slots is null): the sums
// over regs[s] into group slot_group[s] (s when slot_group is null)
__global__ void hll_finish_kernel(const int32_t* __restrict__ regs,
                                  const int32_t* __restrict__ slot_group,
                                  const int32_t* __restrict__ n_slots,
                                  double* __restrict__ present,
                                  int64_t* __restrict__ count) {
  const int s = blockIdx.x;
  if (n_slots != nullptr && s >= *n_slots) return;
  const int64_t g = slot_group != nullptr ? slot_group[s] : s;
  double p = 0.0;
  int64_t c = 0;
  for (int k = threadIdx.x; k < HLL_M; k += blockDim.x) {
    const int v = regs[(int64_t)s * HLL_M + k];
    if (v) {
      p += term((uint32_t)v);
      ++c;
    }
  }
  block_sums(p, c, &present[g], &count[g]);
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

// sorted mode, pass 1: one thread per group. A group of at most SMALL_MAX
// rows is deduped in registers; a larger one is listed for pass 2 (in
// `single` when one piece holds it, else in `multi`, whose index is its
// slot of device registers). lists[0] / lists[1]: their lengths.
__global__ void hll_small_kernel(const void* __restrict__ values, int dtype,
                                 const uint8_t* __restrict__ live,
                                 const int64_t* __restrict__ starts,
                                 const int64_t* __restrict__ ends,
                                 int64_t groups, int64_t n,
                                 double* __restrict__ present,
                                 int64_t* __restrict__ count,
                                 int32_t* __restrict__ single,
                                 int32_t* __restrict__ multi,
                                 int32_t* __restrict__ lists) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  int64_t s, e;
  clamp_run(starts, ends, g, n, &s, &e);
  if (e - s > SMALL_MAX) {
    if (e - s > PIECE)
      multi[atomicAdd(&lists[1], 1)] = (int32_t)g;
    else
      single[atomicAdd(&lists[0], 1)] = (int32_t)g;
    return;
  }
  uint32_t seen[SMALL_MAX];   // register << 8 | (rank + 1), one per register
  int m = 0;
  for (int64_t i = s; i < e; ++i) {
    if (!live[i]) continue;
    const uint32_t c = hll_code(values, dtype, i);
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

// rows [lo, hi) of one group into the block's shared registers (cleared
// first)
static __device__ void piece_registers(uint32_t* sreg,
                                       const void* __restrict__ values,
                                       int dtype,
                                       const uint8_t* __restrict__ live,
                                       int64_t lo, int64_t hi) {
  for (int k = threadIdx.x; k < HLL_M / 4; k += blockDim.x) sreg[k] = 0;
  __syncthreads();
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (!live[i]) continue;
    const uint32_t c = hll_code(values, dtype, i);
    byte_max(sreg, c >> 8, c & 0xffu);
  }
  __syncthreads();
}

// sorted mode, pass 2: the listed groups. Block b sums the one-piece
// groups single[b], single[b + gridDim.x], ...; the pieces of the
// multi-piece groups are dealt to the blocks in turn, each merging into
// its group's slot of regs.
__global__ void hll_large_kernel(const void* __restrict__ values, int dtype,
                                 const uint8_t* __restrict__ live,
                                 const int64_t* __restrict__ starts,
                                 const int64_t* __restrict__ ends,
                                 int64_t n,
                                 const int32_t* __restrict__ single,
                                 const int32_t* __restrict__ multi,
                                 const int32_t* __restrict__ lists,
                                 int32_t* __restrict__ regs,
                                 double* __restrict__ present,
                                 int64_t* __restrict__ count) {
  __shared__ uint32_t sreg[HLL_M / 4];
  const uint8_t* b = (const uint8_t*)sreg;
  const int n_single = lists[0], n_multi = lists[1];
  for (int i = blockIdx.x; i < n_single; i += gridDim.x) {
    const int64_t g = single[i];
    int64_t s, e;
    clamp_run(starts, ends, g, n, &s, &e);
    piece_registers(sreg, values, dtype, live, s, e);
    double p = 0.0;
    int64_t c = 0;
    for (int k = threadIdx.x; k < HLL_M; k += blockDim.x) {
      if (b[k]) {
        p += term(b[k]);
        ++c;
      }
    }
    block_sums(p, c, &present[g], &count[g]);
  }
  int64_t dealt = 0;   // pieces of the groups before this one
  for (int slot = 0; slot < n_multi; ++slot) {
    int64_t s, e;
    clamp_run(starts, ends, multi[slot], n, &s, &e);
    const int64_t pieces = (e - s + PIECE - 1) / PIECE;
    int64_t q = ((int64_t)blockIdx.x - dealt % gridDim.x + gridDim.x)
                % gridDim.x;
    for (; q < pieces; q += gridDim.x) {
      const int64_t lo = s + q * PIECE;
      piece_registers(sreg, values, dtype, live, lo,
                      lo + PIECE < e ? lo + PIECE : e);
      for (int k = threadIdx.x; k < HLL_M; k += blockDim.x)
        if (b[k]) atomicMax(&regs[(int64_t)slot * HLL_M + k], (int)b[k]);
      __syncthreads();
    }
    dealt += pieces;
  }
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Direct mode. values: [n] (dtype 0 float64, 1 int64, 2 int32); code: [n]
// int32 bin of each row, in [0, bins); live: [n] uint8; regs: [bins, 2048]
// int32, zeroed by the caller, out (rank + 1 per register, 0 if empty);
// present: [bins] float64 out; count: [bins] int64 out.
int hll_direct(const void* values, int dtype, const void* code,
               const void* live, int64_t n, int bins, void* regs,
               void* present, void* count, void* stream) {
  if (dtype < DT_F64 || dtype > DT_I32 || bins < 1 || bins > 64 || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = bins * HLL_M;
  cudaError_t e = cudaFuncSetAttribute(
      hll_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const int per_sm = smem <= 48 * 1024 ? 4 : (smem <= 96 * 1024 ? 2 : 1);
    int64_t blocks = (n + 8191) / 8192;
    if (blocks > 132 * per_sm) blocks = 132 * per_sm;
    hll_direct_kernel<<<(unsigned)blocks, HLL_THREADS, smem, s>>>(
        values, dtype, (const int32_t*)code, (const uint8_t*)live, n, bins,
        (int32_t*)regs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  hll_finish_kernel<<<bins, 256, 0, s>>>((const int32_t*)regs, nullptr,
                                         nullptr, (double*)present,
                                         (int64_t*)count);
  return (int)cudaGetLastError();
}

// Sorted mode. values: [n]; live: [n] uint8; starts, ends: [groups] int64
// row runs (ends <= starts: an empty group); scratch: int32, zeroed by the
// caller, of (n / 33 + 1) + (n / PIECE + 1) list entries, 2 list lengths
// and (n / PIECE + 1) * 2048 registers; present: [groups] float64 out;
// count: [groups] int64 out.
int hll_sorted(const void* values, int dtype, const void* live, int64_t n,
               const void* starts, const void* ends, int64_t groups,
               void* scratch, void* present, void* count, void* stream) {
  if (dtype < DT_F64 || dtype > DT_I32 || n < 0 || groups < 0 ||
      groups > 0x7fffffffLL || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_single_max = n / (SMALL_MAX + 1) + 1;
  const int64_t n_multi_max = n / PIECE + 1;
  int32_t* single = (int32_t*)scratch;
  int32_t* multi = single + n_single_max;
  int32_t* lists = multi + n_multi_max;
  int32_t* regs = lists + 2;
  hll_small_kernel<<<(unsigned)((groups + SMALL_THREADS - 1) / SMALL_THREADS),
                     SMALL_THREADS, 0, s>>>(
      values, dtype, (const uint8_t*)live, (const int64_t*)starts,
      (const int64_t*)ends, groups, n, (double*)present, (int64_t*)count,
      single, multi, lists);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hll_large_kernel<<<LARGE_BLOCKS, HLL_THREADS, 0, s>>>(
      values, dtype, (const uint8_t*)live, (const int64_t*)starts,
      (const int64_t*)ends, n, single, multi, lists, regs, (double*)present,
      (int64_t*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hll_finish_kernel<<<(unsigned)n_multi_max, 256, 0, s>>>(
      regs, multi, lists + 1, (double*)present, (int64_t*)count);
  return (int)cudaGetLastError();
}

}  // extern "C"
