// K13 segment_select: approx_percentile's order statistic per group,
// selected from the page's unsorted values.
//
// Replaces the whole approx_percentile step of presto_tpu/ops/aggregate.py,
// direct (:392-414) and sorted (:737-760): the sort of each group's values
// (jax.lax.sort by (group, NULL last, value)) and the take of the element
// at floor(p * max(n - 1, 0)) of the group's n live values. No sort and no
// permutation gather: the kernels read the unsorted values and return, per
// group, the value of the row that a stable ascending sort by the
// orderable key puts at position k = floor(p * (double)max(n - 1, 0))
// (clipped to [0, n - 1]) among the group's live rows, and NULL where
// n == 0.
//
// Orderable key (ops/keys.py _orderable_values), as a 64-bit unsigned
// radix key: an integer with its sign bit flipped (int32 zero-extended);
// a float64 with subnormals flushed to zero, -0.0 as +0.0 (both KEY_ZERO),
// every NaN as one key above +inf (KEY_NAN), else the IEEE flip. Rows of
// one key tie; among ties the stable sort keeps page order, so the
// selection runs over the composite (key, row index), which has no ties.
// Only KEY_ZERO and KEY_NAN can tie rows of different bits; any other
// key maps back to its value (unflip), so a row index is needed only
// there.
//
// Groups are given as bin codes (direct and global paths: int32 codes in
// [0, bins), bins <= 64) or as contiguous row runs (sorted path: starts,
// ends; runs disjoint, as a group-sorted page gives them; rows of a run
// that are not live, such as padding rows, are skipped). Scheduled by
// group length:
//
// - warp tier (runs of at most WARP_MAX rows; sel_warp): a warp loads the
//   run's keys into registers (8 to 32 a lane, by the run's length) and
//   walks the binary trie of the live keys: each round splits the
//   candidates at the highest bit where they differ (the AND and OR of the
//   candidates' keys give it), counts the candidates with a 0 there and
//   keeps the side that holds rank k. A lane's candidates are a bit mask,
//   and a round costs five warp reductions; the rounds number the
//   branchings on the path to the answer, so few distinct values take few
//   rounds. Ties at KEY_ZERO or KEY_NAN walk the row indices the same way,
//   unless the tied rows' bits are all equal.
// - device-wide (sel_dw, one cooperative launch of one block an SM, grid
//   barriers between phases; every bin of the codes form, and every run
//   longer than WARP_MAX): sample select. Per iteration, (1) all blocks
//   sweep the candidates once, 8 consecutive positions a thread in 16-byte
//   loads, with no block barrier until the end: they count those below lo,
//   in [lo, hi], below mid, at mid and all (a thread's own counters where a
//   sweep has one group; where the bins' rows mix, each warp's 10-bit
//   counters in shared memory), and each warp stages those in [lo, hi]
//   (key and row) in shared memory and writes them out in runs, one
//   reservation a run; (2) a block per group reads the counts. A target at
//   mid gives the key outright (a row's value, or for KEY_ZERO and KEY_NAN
//   a walk over the tied rows' indices); a target elsewhere in [lo, hi]
//   keeps the written candidates as the source and narrows the range to
//   one side of mid (about a fifth of the set survives an iteration on
//   continuous data); a target outside [lo, hi] narrows the range and
//   reads the page again. For a group that goes on, the same block sorts
//   SAMPLE keys drawn from its candidates (bitonic, in shared memory) and
//   takes the key at the target's rank as mid and the keys DELTA ranks
//   below and above it as lo and hi (past the sample's ends, the range's
//   own bounds). Every iteration removes at least mid's rows. The codes
//   form's first sweep reads the page (value, live flag and, past one bin,
//   code), every later one only the written candidates: a bin of more than
//   BLOCK_MAX of them appends to a tagged part of a buffer shared by the
//   bins, every other group writes a region of its own. A group whose
//   candidates fit a block (BLOCK_MAX in contiguous memory) is finished
//   there with the trie walk above in registers. After MAX_ITERS a group is
//   finished by a binary search over the key space, one page pass a step
//   (never taken on the repository's inputs).
//
// Counts are integers and every decision is made on exact counts, so the
// result does not depend on the order in which blocks run: bit for bit the
// plain version's (a stable lex_perm sort, then the pick) and the same from
// launch to launch.
//
// Bound on an H100: memory. One read of each row's value (4-8 B) and live
// flag (1 B), and in the codes form with more than one bin its code (4 B;
// one bin reads no code); per group its start and end (16 B) and the two
// results. What holds it back (PERF.md): the device-wide iterations' fixed
// costs (each decision phase is one block's chain of dependent loads, a
// sort and atomics while the other blocks wait at the barrier) and, on a
// first sweep, about 70 instructions an element; the warp tier's rounds
// are instruction-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#define FULL 0xffffffffu
#define WARP_THREADS 256          // sel_warp's blocks
#define WJ 32                     // keys a lane in the warp tier
#define WARP_MAX (32 * WJ)        // = ops/aggregate.SELECT_WARP_MAX
#define DW_THREADS 512            // sel_dw's blocks, one an SM
#define BJ 16                     // keys a thread in the block finisher
#define BLOCK_MAX (DW_THREADS * BJ)  // = ops/aggregate.SELECT_BLOCK_MAX
#define DW_WARPS (DW_THREADS / 32)
#define SAMPLE 256                // sample keys a group an iteration
#define SAMPLE_SCAN 8             // positions a sampling thread looks at
#define DELTA 20                  // sample ranks each side of the target
#define U 8                       // elements a thread a sweep step
#define STAGE 256                 // candidates a warp stages
#define STEP (U * DW_THREADS)
#define MAX_BINS 64
#define MAX_ITERS 96

#define SIGN64 0x8000000000000000ull
#define KEY_ZERO SIGN64
#define KEY_NAN 0xffffffffffffffffull

static_assert(SAMPLE <= DW_THREADS && SAMPLE % 32 == 0, "sample threads");
static_assert(U == 8, "a sweep step loads 8 consecutive positions a thread");

enum { DT_F64 = 0, DT_I64 = 1, DT_I32 = 2 };
enum { SRC_PAGE = 0, SRC_MIXED = 1, SRC_REGION = 2 };
enum { DST_NONE = 0, DST_MIXED = 1, DST_REGION = 2 };
enum { NEED_PAGE = 1, NEED_MIXED = 2 };

// --- keys ------------------------------------------------------------------

template <int DT> struct Dt;

template <> struct Dt<DT_F64> {
  typedef double T;
  static __device__ __forceinline__ u64 key(double x) {
    if (isnan(x)) return KEY_NAN;
    u64 b = fabs(x) < 2.2250738585072014e-308
                ? 0ull : (u64)__double_as_longlong(x);
    return (b >> 63) ? ~b : (b | SIGN64);
  }
  static __device__ __forceinline__ u64 bits(double x) {
    return (u64)__double_as_longlong(x);
  }
  static __device__ __forceinline__ bool special(u64 k) {
    return k == KEY_ZERO || k == KEY_NAN;
  }
  static __device__ __forceinline__ u64 unflip(u64 k) {
    return (k >> 63) ? (k ^ SIGN64) : ~k;
  }
  static __device__ __forceinline__ double from_bits(u64 b) {
    return __longlong_as_double((long long)b);
  }
};

template <> struct Dt<DT_I64> {
  typedef int64_t T;
  static __device__ __forceinline__ u64 key(int64_t x) {
    return (u64)x ^ SIGN64;
  }
  static __device__ __forceinline__ u64 bits(int64_t x) { return (u64)x; }
  static __device__ __forceinline__ bool special(u64) { return false; }
  static __device__ __forceinline__ u64 unflip(u64 k) { return k ^ SIGN64; }
  static __device__ __forceinline__ int64_t from_bits(u64 b) {
    return (int64_t)b;
  }
};

template <> struct Dt<DT_I32> {
  typedef int32_t T;
  static __device__ __forceinline__ u64 key(int32_t x) {
    return (u64)((u32)x ^ 0x80000000u);
  }
  static __device__ __forceinline__ u64 bits(int32_t x) { return (u64)(u32)x; }
  static __device__ __forceinline__ bool special(u64) { return false; }
  static __device__ __forceinline__ u64 unflip(u64 k) {
    return (u64)((u32)k ^ 0x80000000u);
  }
  static __device__ __forceinline__ int32_t from_bits(u64 b) {
    return (int32_t)(u32)b;
  }
};

// k = floor(p * max(n - 1, 0)) in float64, as the JAX function computes it,
// clipped to the group
static __device__ __forceinline__ int64_t kth(double p, int64_t n) {
  int64_t k = (int64_t)floor(p * (double)(n > 1 ? n - 1 : 0));
  return k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
}

// --- team reductions --------------------------------------------------------

enum { R_ADD = 0, R_AND = 1, R_OR = 2 };

static __device__ __forceinline__ u32 warp_red(u32 v, int op) {
  if (op == R_ADD) return __reduce_add_sync(FULL, v);
  if (op == R_AND) return __reduce_and_sync(FULL, v);
  return __reduce_or_sync(FULL, v);
}

static __device__ __forceinline__ u32 red_identity(int op) {
  return op == R_AND ? 0xffffffffu : 0u;
}

// A warp: every lane ends with the reduction over the warp.
struct WarpTeam {
  template <int N>
  __device__ __forceinline__ void reduce(u32 (&v)[N], const int (&op)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = warp_red(v[i], op[i]);
  }
  __device__ __forceinline__ int rank() const { return threadIdx.x & 31; }
  __device__ __forceinline__ int size() const { return 32; }
};

// A block of DW_THREADS: warps reduce, lane 0 of each writes its warp's
// values, one barrier, then every warp reduces the warps' values. The
// buffer alternates between two halves, so one barrier a call suffices.
struct BlockTeam {
  u32 (*buf)[DW_WARPS][12];
  int par;
  template <int N>
  __device__ __forceinline__ void reduce(u32 (&v)[N], const int (&op)[N]) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = warp_red(v[i], op[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) buf[par][w][i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = warp_red(lane < DW_WARPS ? buf[par][lane][i]
                                      : red_identity(op[i]), op[i]);
    par ^= 1;
  }
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return DW_THREADS; }
};

template <class Team>
static __device__ __forceinline__ u32 team_add(Team& t, u32 x) {
  u32 v[1] = {x};
  const int op[1] = {R_ADD};
  t.reduce(v, op);
  return v[0];
}

template <class Team>
static __device__ __forceinline__ void team_andor(Team& t, u64& a, u64& o) {
  u32 v[4] = {(u32)a, (u32)(a >> 32), (u32)o, (u32)(o >> 32)};
  const int op[4] = {R_AND, R_AND, R_OR, R_OR};
  t.reduce(v, op);
  a = (u64)v[0] | ((u64)v[1] << 32);
  o = (u64)v[2] | ((u64)v[3] << 32);
}

// --- the trie walk ----------------------------------------------------------

// The r-th smallest (0-based) of the values v[j] with bit j of vm set, over
// the whole team (r and the result uniform over the team; the set holds
// more than r values). Each round splits the candidates at the highest bit
// where they differ (from the AND and OR of their values), counts those
// with a 0 there and keeps the side holding rank r; a lane's candidates
// are a bit mask, so a round costs one pass to extract the bit, one to
// take the AND and OR of the side kept, and five team reductions.
template <int J, class Team>
static __device__ u64 walk(const u64 (&v)[J], u32 vm, u64 r, Team& team) {
  u32 cm = vm;
  u64 a = ~0ull, o = 0ull;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if ((cm >> j) & 1u) { a &= v[j]; o |= v[j]; }
  team_andor(team, a, o);
  while (a < o) {               // a > o only for an empty set: stop there
    const int b = 63 - __clzll((long long)(a ^ o));
    u32 ones = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) ones |= (u32)((v[j] >> b) & 1ull) << j;
    const u32 c0 = team_add(team, (u32)__popc(cm & ~ones));
    if (r < (u64)c0) {
      cm &= ~ones;
    } else {
      r -= c0;
      cm &= ones;
    }
    a = ~0ull;
    o = 0ull;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if ((cm >> j) & 1u) { a &= v[j]; o |= v[j]; }
    team_andor(team, a, o);
  }
  return a;
}

// The raw bits of the value of the element of rank r (0-based, by (key,
// row index)) among the team's elements: keys key[j] with bit j of vm set,
// element j's row index idx(j). key[] is overwritten.
template <int DT, int J, class Team, class Idx>
static __device__ u64 select_team(u64 (&key)[J], Idx idx, u32 vm, u64 r,
                                  Team& team,
                                  const typename Dt<DT>::T* values) {
  const u64 K = walk<J>(key, vm, r, team);
  if (!Dt<DT>::special(K)) return Dt<DT>::unflip(K);
  // KEY_ZERO or KEY_NAN: the tied rows may differ in their bits
  u32 less = 0, tied = 0;
  u64 ra = ~0ull, ro = 0ull;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if ((vm >> j) & 1u) {
      if (key[j] < K) {
        ++less;
      } else if (key[j] == K) {
        tied |= 1u << j;
        const u64 b = Dt<DT>::bits(values[idx(j)]);
        ra &= b;
        ro |= b;
      }
    }
  }
  u32 x[5] = {less, (u32)ra, (u32)(ra >> 32), (u32)ro, (u32)(ro >> 32)};
  const int op[5] = {R_ADD, R_AND, R_AND, R_OR, R_OR};
  team.reduce(x, op);
  ra = (u64)x[1] | ((u64)x[2] << 32);
  ro = (u64)x[3] | ((u64)x[4] << 32);
  if (ra == ro) return ra;
#pragma unroll
  for (int j = 0; j < J; ++j) key[j] = idx(j);
  const u64 row = walk<J>(key, tied, r - x[0], team);
  return Dt<DT>::bits(values[row]);
}

template <int DT>
static __device__ __forceinline__ void store(typename Dt<DT>::T* out,
                                             uint8_t* nulls, int64_t g,
                                             u64 bits, bool null) {
  out[g] = null ? (typename Dt<DT>::T)0 : Dt<DT>::from_bits(bits);
  nulls[g] = null;
}

// --- the fallback: binary search over the key space -------------------------

// Rank k of group (rows [s, e) that are live and, with codes, of bin
// `bin`) by binary search: one pass over the rows a step, 64 steps over
// the key and, for tied KEY_ZERO/KEY_NAN rows of different bits, 32 over
// the row index. Slow and always right; taken where the faster paths
// cannot run.
template <int DT, class Team>
static __device__ void fallback_select(const typename Dt<DT>::T* values,
                                       const uint8_t* live,
                                       const int32_t* codes, int bin,
                                       int nbins, int64_t s, int64_t e,
                                       double p,
                                       Team& team, typename Dt<DT>::T* out,
                                       uint8_t* nulls, int64_t gid) {
  const int tid = team.rank(), nt = team.size();
#define FB_ROW_OK(i) (live[i] && (codes == nullptr || codes[i] == bin))
  if (codes != nullptr && bin == 0 && nbins == 1) codes = nullptr;
  u32 c = 0;
  for (int64_t i = s + tid; i < e; i += nt) c += FB_ROW_OK(i);
  const int64_t n = team_add(team, c);
  if (n == 0) {
    if (tid == 0) store<DT>(out, nulls, gid, 0, true);
    return;
  }
  const u64 k = (u64)kth(p, n);
  u64 lo = 0, hi = ~0ull;        // smallest K with #(key <= K) > k
  while (lo < hi) {
    const u64 mid = lo + (hi - lo) / 2;
    u32 cnt = 0;
    for (int64_t i = s + tid; i < e; i += nt)
      cnt += FB_ROW_OK(i) && Dt<DT>::key(values[i]) <= mid;
    if ((u64)team_add(team, cnt) > k) hi = mid; else lo = mid + 1;
  }
  const u64 K = lo;
  u64 bits = Dt<DT>::unflip(K);
  if (Dt<DT>::special(K)) {
    u32 less = 0;
    u64 ra = ~0ull, ro = 0ull;
    for (int64_t i = s + tid; i < e; i += nt) {
      if (!FB_ROW_OK(i)) continue;
      const u64 key = Dt<DT>::key(values[i]);
      if (key < K) ++less;
      else if (key == K) {
        ra &= Dt<DT>::bits(values[i]);
        ro |= Dt<DT>::bits(values[i]);
      }
    }
    const u64 r = k - team_add(team, less);
    team_andor(team, ra, ro);
    bits = ra;
    if (ra != ro) {
      int64_t ilo = s, ihi = e - 1;  // smallest row with #(tied <= row) > r
      while (ilo < ihi) {
        const int64_t mid = ilo + (ihi - ilo) / 2;
        u32 cnt = 0;
        for (int64_t i = s + tid; i <= mid; i += nt)
          cnt += FB_ROW_OK(i) && Dt<DT>::key(values[i]) == K;
        if ((u64)team_add(team, cnt) > r) ihi = mid; else ilo = mid + 1;
      }
      bits = Dt<DT>::bits(values[ilo]);
    }
  }
#undef FB_ROW_OK
  if (tid == 0) store<DT>(out, nulls, gid, bits, false);
}

// --- scratch ----------------------------------------------------------------

struct Head {                   // zeroed by the host before each call
  u32 bar;                      // grid barrier arrivals
  u32 list_count[2];            // active groups of an iteration
  u32 need[2];                  // sweeps an iteration needs: NEED_*
  u32 seg_count;                // runs listed by sel_warp for sel_dw
  u64 cursor[2];                // region reservations in each buffer
  u64 mixed_base[2];            // each buffer's tagged part: after its
  u64 mixed_count[2];           // regions, this long
};

struct Grp {                    // a device-wide group
  int64_t id;                   // output slot: bin, or run index
  int64_t s, e;                 // its rows (codes form: the page)
  u64 klo, khi;                 // the candidates: compared value in range
  u64 K;                        // phase 1: key of the tied rows
  u64 lo, mid, hi;              // this iteration's splitters: mid is the
                                // sample's key at the target's rank
  int64_t r;                    // target rank among the candidates (-1:
                                // before the first count)
  int64_t c;                    // candidates (runs before the first count:
                                // the run's length, a bound)
  int64_t src_off, src_len;     // SRC_REGION: in buffer src_buf (also
                                // SRC_MIXED's buffer)
  int64_t dst_off;              // DST_REGION this iteration
  u64 below, in, total, lt, eq; // this iteration's counts: below lo, in
                                // [lo, hi], all, below mid, at mid
  u64 dst_cursor;
  int32_t src, src_buf, dst, phase;  // phase 0: keys; 1: row indices of
                                     // the rows of key K
  int32_t active, compact;
};

// int64 words of `bytes`, rounded up to 256 bytes, so that every array of
// the scratch takes 16-byte vector loads
static __host__ __device__ __forceinline__ int64_t words(int64_t bytes) {
  return (bytes + 255) / 256 * 32;
}

struct Layout {                 // offsets in int64 words
  int64_t head, grps, lists, seglist, key0, key1, idx0, idx1, tag0, tag1;
  int64_t total;
  int64_t gcap, bufcap;
};

static __host__ __device__ Layout layout(int64_t n, int64_t groups,
                                         int bins) {
  Layout L;
  L.gcap = bins > 0 ? bins
                    : (groups < n / (WARP_MAX + 1) + 1
                           ? groups : n / (WARP_MAX + 1) + 1);
  L.bufcap = n;
  const int64_t nb = (n + 8) / 8 * 8;   // buffers hold whole runs of 8
  L.head = 0;
  L.grps = words(sizeof(Head));
  L.lists = L.grps + L.gcap * words(sizeof(Grp));
  L.seglist = L.lists + words(2 * L.gcap * 4);
  L.key0 = L.seglist + words(L.gcap * 8);
  L.key1 = L.key0 + words(nb * 8);
  L.idx0 = L.key1 + words(nb * 8);
  L.idx1 = L.idx0 + words(nb * 4);
  L.tag0 = L.idx1 + words(nb * 4);
  L.tag1 = L.tag0 + words(bins > 0 ? nb : 0);
  L.total = L.tag1 + words(bins > 0 ? nb : 0);
  return L;
}

struct Args {
  const void* values;
  const uint8_t* live;
  const int32_t* codes;         // codes form, else nullptr
  const int64_t* starts;        // runs form
  const int64_t* ends;
  int64_t n, groups;
  int32_t bins;                 // codes form: > 0
  double p;
  void* out;
  uint8_t* nulls;
  int64_t* scratch;
};

struct Ptrs {
  Head* head;
  Grp* grps;
  u32* lists[2];
  int64_t* seglist;
  u64* bkey[2];
  u32* bidx[2];
  uint8_t* tag[2];
  int64_t gcap, bufcap;
};

static __device__ __forceinline__ Ptrs ptrs(const Args& a) {
  const Layout L = layout(a.n, a.groups, a.bins);
  Ptrs P;
  P.head = (Head*)(a.scratch + L.head);
  P.grps = (Grp*)(a.scratch + L.grps);
  P.lists[0] = (u32*)(a.scratch + L.lists);
  P.lists[1] = P.lists[0] + L.gcap;
  P.seglist = a.scratch + L.seglist;
  P.bkey[0] = (u64*)(a.scratch + L.key0);
  P.bkey[1] = (u64*)(a.scratch + L.key1);
  P.bidx[0] = (u32*)(a.scratch + L.idx0);
  P.bidx[1] = (u32*)(a.scratch + L.idx1);
  P.tag[0] = (uint8_t*)(a.scratch + L.tag0);
  P.tag[1] = (uint8_t*)(a.scratch + L.tag1);
  P.gcap = L.gcap;
  P.bufcap = L.bufcap;
  return P;
}

extern __shared__ __align__(16) unsigned char dyn_smem[];

// --- warp tier --------------------------------------------------------------

// A warp's run of at most 32 * J rows [s, e): its keys in registers, J a
// lane; `null` where no row is live.
template <int DT, int J>
static __device__ u64 warp_run(const Args& a, const typename Dt<DT>::T* values,
                               int64_t s, int64_t e, WarpTeam& team,
                               bool& null) {
  const int lane = threadIdx.x & 31;
  u64 key[J];
  u32 vm = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t row = s + j * 32 + lane;
    key[j] = 0;
    if (row < e) {
      key[j] = Dt<DT>::key(values[row]);
      vm |= (u32)(a.live[row] != 0) << j;
    }
  }
  const int64_t n = team_add(team, (u32)__popc(vm));
  null = n == 0;
  if (null) return 0;
  return select_team<DT, J>(
      key, [&](int j) { return (u64)(s + j * 32 + lane); }, vm,
      (u64)kth(a.p, n), team, values);
}

template <int DT>
__global__ void __launch_bounds__(WARP_THREADS)
sel_warp(Args a) {
  typedef typename Dt<DT>::T T;
  const T* values = (const T*)a.values;
  const Ptrs P = ptrs(a);
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (WARP_THREADS / 32);
  WarpTeam team;
  for (int64_t g = ((int64_t)blockIdx.x * WARP_THREADS + threadIdx.x) >> 5;
       g < a.groups; g += warps) {
    int64_t s = a.starts[g], e = a.ends[g];
    s = s < 0 ? 0 : (s > a.n ? a.n : s);
    e = e < s ? s : (e > a.n ? a.n : e);
    const int64_t m = e - s;
    if (m > WARP_MAX) {
      u32 slot = 0;
      if (lane == 0) slot = atomicAdd(&P.head->seg_count, 1u);
      slot = __shfl_sync(FULL, slot, 0);
      if (slot < (u32)P.gcap) {
        if (lane == 0) P.seglist[slot] = g;
      } else {                  // overlapping runs beyond the list
        fallback_select<DT>(values, a.live, nullptr, 0, 0, s, e, a.p, team,
                            (T*)a.out, a.nulls, g);
      }
      continue;
    }
    bool null;
    const u64 bits = m <= 256 ? warp_run<DT, 8>(a, values, s, e, team, null)
        : m <= 512 ? warp_run<DT, 16>(a, values, s, e, team, null)
        : m <= 768 ? warp_run<DT, 24>(a, values, s, e, team, null)
                   : warp_run<DT, WJ>(a, values, s, e, team, null);
    if (lane == 0) store<DT>((T*)a.out, a.nulls, g, bits, null);
  }
}

// --- device-wide ------------------------------------------------------------

struct __align__(16) GInfo {    // a group's filter and splitters
  u64 klo, khi, lo, hi, mid, K;
  int32_t take, phase, compact, dst;
};

struct Stage {                  // a warp's candidates, written out in runs
  u64 key[STAGE];
  u32 idx[STAGE];
  uint8_t slot[STAGE];
};

enum { C_BELOW, C_IN, C_ALL, C_LT, C_EQ, NCOUNT };

struct DwSmem {
  GInfo gi[MAX_BINS];
  u32 wa[DW_WARPS][MAX_BINS];   // a warp's counts, 10 bits each: below |
  u32 wb[DW_WARPS][MAX_BINS];   // in << 10 | all << 20; lt | eq << 10
  u32 bt[NCOUNT][MAX_BINS];     // the block's counts of a sweep
  Stage st[DW_WARPS];
  u32 red[2][DW_WARPS][12];
  u64 sk[SAMPLE];
  u32 shave[SAMPLE / 32];       // which sampling threads hold a key
  u64 s_lo, s_mid, s_hi;
  int32_t flag;
};

static __device__ __forceinline__ void grid_sync(u32* bar, u32& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*(volatile u32*)bar < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

static __device__ __forceinline__ bool passes(const GInfo& f, u64 key,
                                              u64 idx, u64& cv) {
  cv = f.phase ? idx : key;
  return (f.phase == 0 || key == f.K) && cv >= f.klo && cv <= f.khi;
}

static __device__ __forceinline__ GInfo ginfo(const Grp& q, bool take) {
  GInfo f;
  f.klo = q.klo; f.khi = q.khi; f.lo = q.lo; f.hi = q.hi; f.mid = q.mid;
  f.K = q.K;
  f.take = take; f.phase = q.phase; f.compact = q.compact; f.dst = q.dst;
  return f;
}

// Writes out a warp's staged candidates: those of a single destination
// (a region of the sweep's one group, or the tagged part of buffer dstbuf)
// in one reservation; in the codes form those of a group bound for its
// own region (at most BLOCK_MAX candidates) in one reservation for each
// such group in each run of 32.
static __device__ void stage_flush(const Ptrs& P, DwSmem& sm, Stage& st,
                                   u32& staged, int dstbuf, Grp* fixed_q) {
  const int lane = threadIdx.x & 31;
  __syncwarp();                 // the lanes' staged writes are visible
  Head* H = P.head;
  u32 single = 0;
  for (u32 i0 = 0; i0 < staged; i0 += 32) {
    const u32 i = i0 + lane;
    const bool one = i < staged
        && (fixed_q != nullptr || sm.gi[st.slot[i]].dst == DST_MIXED);
    single += __popc(__ballot_sync(FULL, one));
  }
  u64 at = 0;
  if (lane == 0 && single) {
    at = fixed_q ? (u64)fixed_q->dst_off
                       + atomicAdd(&fixed_q->dst_cursor, (u64)single)
                 : H->cursor[dstbuf]
                       + atomicAdd(&H->mixed_count[dstbuf], (u64)single);
  }
  at = __shfl_sync(FULL, at, 0);
  for (u32 i0 = 0; i0 < staged; i0 += 32) {
    const u32 i = i0 + lane;
    const bool live = i < staged;
    const int s = live ? st.slot[i] : 0;
    const bool one = live && (fixed_q != nullptr || sm.gi[s].dst == DST_MIXED);
    const u32 m = __ballot_sync(FULL, one);
    if (one) {
      const u64 to = at + __popc(m & ((1u << lane) - 1u));
      P.bkey[dstbuf][to] = st.key[i];
      P.bidx[dstbuf][to] = st.idx[i];
      if (fixed_q == nullptr) P.tag[dstbuf][to] = (uint8_t)s;
    }
    at += __popc(m);
    u32 rest = __ballot_sync(FULL, live && !one);
    while (rest) {              // regions of the codes form's small groups
      const int s0 = __shfl_sync(FULL, s, __ffs(rest) - 1);
      const u32 peers = __ballot_sync(FULL, live && !one && s == s0);
      u64 base = 0;
      if (lane == __ffs(peers) - 1) {
        Grp& q = P.grps[s0];
        base = (u64)q.dst_off + atomicAdd(&q.dst_cursor, (u64)__popc(peers));
      }
      base = __shfl_sync(FULL, base, __ffs(peers) - 1);
      if ((peers >> lane) & 1u) {
        const u64 to = base + __popc(peers & ((1u << lane) - 1u));
        P.bkey[dstbuf][to] = st.key[i];
        P.bidx[dstbuf][to] = st.idx[i];
      }
      rest &= ~peers;
    }
  }
  __syncwarp();
  staged = 0;
}

// adds one element's counts (a: below | in << 10 | all << 20, b: lt | eq
// << 10) to the warp's counters of group `slot`: no atomic where the
// warp's elements are of one group
static __device__ __forceinline__ void warp_count(DwSmem& sm, int w, int slot,
                                                  u32 a, u32 b) {
  const u32 m = __ballot_sync(FULL, a != 0);
  if (m == 0) return;
  const int lead = __ffs(m) - 1;
  const int s0 = __shfl_sync(FULL, slot, lead);
  if (__all_sync(FULL, a == 0 || slot == s0)) {
    const u32 sa = __reduce_add_sync(FULL, a);
    const u32 sb = __reduce_add_sync(FULL, b);
    if ((int)(threadIdx.x & 31) == lead) {
      sm.wa[w][s0] += sa;
      sm.wb[w][s0] += sb;
    }
  } else if (a) {
    atomicAdd(&sm.wa[w][slot], a);
    if (b) atomicAdd(&sm.wb[w][slot], b);
  }
}

// moves a warp's 10-bit counters into the block's counts
static __device__ void warp_spill_counts(DwSmem& sm, int w, int nslots) {
  __syncwarp();
  for (int s = threadIdx.x & 31; s < nslots; s += 32) {
    const u32 a = sm.wa[w][s], b = sm.wb[w][s];
    if (a) {
      atomicAdd(&sm.bt[C_BELOW][s], a & 1023u);
      atomicAdd(&sm.bt[C_IN][s], (a >> 10) & 1023u);
      atomicAdd(&sm.bt[C_ALL][s], a >> 20);
      atomicAdd(&sm.bt[C_LT][s], b & 1023u);
      atomicAdd(&sm.bt[C_EQ][s], b >> 10);
      sm.wa[w][s] = 0;
      sm.wb[w][s] = 0;
    }
  }
  __syncwarp();
}

// A thread's 8 consecutive positions p0 .. p0 + 7 (p0 a multiple of 8) in
// 16-byte loads: the page's values as keys, live flags and codes, or a
// buffer's keys, rows and tags.
template <int DT>
static __device__ __forceinline__ void load8_page(const Args& a, int64_t p0,
                                                  bool codes, u64 (&key)[8],
                                                  u32& live8lo, u32& live8hi,
                                                  int (&slot)[8]) {
  typedef typename Dt<DT>::T T;
  const T* v = (const T*)a.values + p0;
  if (DT == DT_I32) {
    const int4 x = ((const int4*)v)[0], y = ((const int4*)v)[1];
    const int32_t e[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) key[j] = Dt<DT>::key((T)e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const longlong2 x = ((const longlong2*)v)[j / 2];
      key[j] = Dt<DT>::key(DT == DT_F64 ? (T)__longlong_as_double(x.x)
                                        : (T)x.x);
      key[j + 1] = Dt<DT>::key(DT == DT_F64 ? (T)__longlong_as_double(x.y)
                                            : (T)x.y);
    }
  }
  const uint2 l = *(const uint2*)(a.live + p0);
  live8lo = l.x;
  live8hi = l.y;
  if (codes) {
    const int4 x = ((const int4*)(a.codes + p0))[0];
    const int4 y = ((const int4*)(a.codes + p0))[1];
    slot[0] = x.x; slot[1] = x.y; slot[2] = x.z; slot[3] = x.w;
    slot[4] = y.x; slot[5] = y.y; slot[6] = y.z; slot[7] = y.w;
  }
}

// One sweep over positions [from, to) of a source, steps first, first +
// stride, ...: the page (rows; per-row group from the codes, or the one
// group `fixed`) or a buffer (per-element group from the tags, or the one
// group). Counts each group's candidates below lo, in [lo, hi], all,
// below mid and at mid, and stages those in [lo, hi] where the group
// compacts. No block barrier until the block's counts are added up at the
// end, one global atomic a count a group.
template <int DT, bool PAGE, bool FIXED>
static __device__ void sweep(const Args& a, const Ptrs& P, DwSmem& sm,
                             Grp* fixed, int nslots, int64_t from,
                             int64_t to, int srcbuf, int dstbuf,
                             int64_t first, int64_t stride) {
  typedef typename Dt<DT>::T T;
  const T* values = (const T*)a.values;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const bool one_group = FIXED || a.bins == 1;
  GInfo ff;                     // a run's or region's one group
  if (FIXED) ff = ginfo(*fixed, true);
  u32 cnt[NCOUNT] = {0, 0, 0, 0, 0};  // one group: this thread's counts
  Stage& st = sm.st[w];
  u32 staged = 0;
  int steps = 0;
  // a thread takes 8 consecutive positions of a step in 16-byte loads
  // where its pointers allow it, one at a time at the sources' ends
  const int64_t len_src = PAGE ? a.n : P.bufcap;
  const bool vec = !PAGE || ((((uintptr_t)a.values & 15) == 0)
      && (((uintptr_t)a.live & 7) == 0)
      && (a.codes == nullptr || ((uintptr_t)a.codes & 15) == 0));
  const bool codes_in = !FIXED && a.bins > 1;
  for (int64_t base = (from & ~(int64_t)7) + first * STEP; base < to;
       base += stride * STEP) {
    u64 key[U];
    u32 idx[U];
    int slot[U];
    bool ok[U];
    const int64_t p0 = base + (int64_t)tid * U;
#pragma unroll
    for (int u = 0; u < U; ++u) { key[u] = 0; idx[u] = (u32)(p0 + u); slot[u] = 0; }
    if (vec && p0 + U <= len_src && p0 < to) {
      if (PAGE) {
        u32 l0, l1;
        load8_page<DT>(a, p0, codes_in, key, l0, l1, slot);
#pragma unroll
        for (int u = 0; u < U; ++u)
          ok[u] = ((u < 4 ? l0 >> (8 * u) : l1 >> (8 * (u - 4))) & 0xffu) != 0;
      } else {
        const ulonglong2* kp = (const ulonglong2*)(P.bkey[srcbuf] + p0);
#pragma unroll
        for (int u = 0; u < U; u += 2) {
          const ulonglong2 x = __ldcg(kp + u / 2);
          key[u] = x.x;
          key[u + 1] = x.y;
        }
        const uint4* ip = (const uint4*)(P.bidx[srcbuf] + p0);
        const uint4 i0 = __ldcg(ip), i1 = __ldcg(ip + 1);
        idx[0] = i0.x; idx[1] = i0.y; idx[2] = i0.z; idx[3] = i0.w;
        idx[4] = i1.x; idx[5] = i1.y; idx[6] = i1.z; idx[7] = i1.w;
        if (!FIXED) {
          const uint2 t = __ldcg((const uint2*)(P.tag[srcbuf] + p0));
#pragma unroll
          for (int u = 0; u < U; ++u)
            slot[u] = (u < 4 ? t.x >> (8 * u) : t.y >> (8 * (u - 4))) & 0xffu;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) ok[u] = true;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t pos = p0 + u;
        ok[u] = ok[u] && pos >= from && pos < to;
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t pos = p0 + u;
        ok[u] = pos >= from && pos < to;
        if (ok[u]) {
          if (PAGE) {
            key[u] = Dt<DT>::key(values[pos]);
            ok[u] = a.live[pos] != 0;
            if (codes_in) slot[u] = a.codes[pos];
          } else {
            key[u] = __ldcg(&P.bkey[srcbuf][pos]);
            idx[u] = __ldcg(&P.bidx[srcbuf][pos]);
            if (!FIXED) slot[u] = __ldcg(&P.tag[srcbuf][pos]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if ((u32)slot[u] >= (u32)nslots) { slot[u] = 0; ok[u] = false; }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const GInfo& f = FIXED ? ff : sm.gi[slot[u]];
      u64 cv;
      const bool all = ok[u] && f.take && passes(f, key[u], idx[u], cv);
      const bool below = all && cv < f.lo;
      const bool in = all && !below && cv <= f.hi;
      const bool lt = all && cv < f.mid;
      const bool eq = all && cv == f.mid;
      if (one_group) {
        cnt[C_BELOW] += below; cnt[C_IN] += in; cnt[C_ALL] += all;
        cnt[C_LT] += lt; cnt[C_EQ] += eq;
      } else {
        warp_count(sm, w, slot[u], below | (in << 10) | (all << 20),
                   lt | (eq << 10));
      }
      const bool want = in && f.compact;
      const u32 m = __ballot_sync(FULL, want);
      if (m) {
        if (staged + __popc(m) > STAGE)
          stage_flush(P, sm, st, staged, dstbuf, FIXED ? fixed : nullptr);
        if (want) {
          const u32 at = staged + __popc(m & ((1u << lane) - 1u));
          st.key[at] = key[u];
          st.idx[at] = idx[u];
          st.slot[at] = (uint8_t)slot[u];
        }
        staged += __popc(m);
      }
    }
    if (!one_group && ++steps == 3) {     // 3 x 8 x 32 < 2^10 a field
      warp_spill_counts(sm, w, nslots);
      steps = 0;
    }
  }
  if (staged) stage_flush(P, sm, st, staged, dstbuf, FIXED ? fixed : nullptr);
  if (one_group) {
#pragma unroll
    for (int c = 0; c < NCOUNT; ++c) {
      const u32 v = __reduce_add_sync(FULL, cnt[c]);
      if (lane == 0 && v) atomicAdd(&sm.bt[c][0], v);
    }
  } else {
    warp_spill_counts(sm, w, nslots);
  }
  __syncthreads();
  if (tid < nslots && sm.bt[C_ALL][tid]) {
    Grp& q = FIXED ? *fixed : P.grps[tid];
    u64* to_q[NCOUNT] = {&q.below, &q.in, &q.total, &q.lt, &q.eq};
#pragma unroll
    for (int c = 0; c < NCOUNT; ++c) {
      if (sm.bt[c][tid]) atomicAdd(to_q[c], (u64)sm.bt[c][tid]);
      sm.bt[c][tid] = 0;
    }
  }
  __syncthreads();
}

// The block finisher: rank r (r < 0: unknown, counted here) among the
// candidates of group q in a contiguous source of at most BLOCK_MAX
// positions (a run of the page, or a region of a buffer).
template <int DT>
static __device__ void finish_block(const Args& a, const Ptrs& P, DwSmem& sm,
                                    const Grp& q, int64_t r) {
  typedef typename Dt<DT>::T T;
  const T* values = (const T*)a.values;
  BlockTeam team{sm.red, 0};
  const GInfo f = ginfo(q, true);
  const bool page = q.src == SRC_PAGE;
  const int64_t from = page ? q.s : q.src_off;
  const int64_t to = page ? q.e : q.src_off + q.src_len;
  u64 key[BJ];
  u32 idx[BJ];
  u32 vm = 0;
#pragma unroll
  for (int j = 0; j < BJ; ++j) {
    const int64_t pos = from + j * DW_THREADS + threadIdx.x;
    key[j] = 0; idx[j] = 0;
    bool ok = false;
    if (pos < to) {
      if (page) {
        key[j] = Dt<DT>::key(values[pos]);
        idx[j] = (u32)pos;
        ok = a.live[pos] != 0;
      } else {
        key[j] = __ldcg(&P.bkey[q.src_buf][pos]);
        idx[j] = __ldcg(&P.bidx[q.src_buf][pos]);
        ok = true;
      }
      u64 cv;
      ok = ok && passes(f, key[j], idx[j], cv);
    }
    vm |= (u32)ok << j;
  }
  if (r < 0) {
    const int64_t n = team_add(team, (u32)__popc(vm));
    if (n == 0) {
      if (threadIdx.x == 0) store<DT>((T*)a.out, a.nulls, q.id, 0, true);
      __syncthreads();
      return;
    }
    r = kth(a.p, n);
  }
  const u64 bits = select_team<DT, BJ>(
      key, [&](int j) { return (u64)idx[j]; }, vm, (u64)r, team, values);
  if (threadIdx.x == 0) store<DT>((T*)a.out, a.nulls, q.id, bits, false);
  __syncthreads();
}

// sample select's splitters for group q: SAMPLE keys drawn from the
// candidates, sorted: mid, the key at the target's rank,
// and lo and hi, the keys DELTA sample ranks below and above it (past the
// sample's ends, the range's own bounds, so that the target cannot fall
// outside them). Clears the group's counts and decides whether its sweep
// writes its candidates.
template <int DT>
static __device__ void sample_splitters(const Args& a, const Ptrs& P,
                                        DwSmem& sm, Grp& q, int gi) {
  typedef typename Dt<DT>::T T;
  const T* values = (const T*)a.values;
  const int tid = threadIdx.x;
  const GInfo f = ginfo(q, true);
  int64_t from, len;
  if (q.src == SRC_REGION) {
    from = q.src_off;
    len = q.src_len;
  } else if (q.src == SRC_MIXED) {
    from = (int64_t)P.head->mixed_base[q.src_buf];
    len = (int64_t)P.head->mixed_count[q.src_buf];
  } else {
    from = q.s; len = q.e - q.s;
    if (q.phase == 1) {         // the compared value is the row itself
      const int64_t lo = (int64_t)(q.klo < (u64)q.s ? (u64)q.s : q.klo);
      const int64_t hi = q.khi < (u64)q.e ? (int64_t)q.khi + 1 : q.e;
      from = lo; len = hi > lo ? hi - lo : 0;
    }
  }
  // thread i looks at positions i * SAMPLE_SCAN + j of SAMPLE * SAMPLE_SCAN
  // spread over the source and keeps the first candidate, so the first
  // looks cover the whole source; every look's loads are issued first
  bool have = false;
  u64 mine = 0;
  if (tid < SAMPLE) {
    const int64_t slots = (int64_t)SAMPLE * SAMPLE_SCAN;
    u64 key[SAMPLE_SCAN];
    u32 idx[SAMPLE_SCAN];
    bool ok[SAMPLE_SCAN];
#pragma unroll
    for (int j = 0; j < SAMPLE_SCAN; ++j) {
      const int64_t qd = (int64_t)tid * SAMPLE_SCAN + j;
      ok[j] = qd < len;
      key[j] = 0; idx[j] = 0;
      if (!ok[j]) continue;
      const int64_t pos = from + (len <= slots ? qd : (int64_t)(
          (double)qd * (double)len / (double)slots));
      if (q.src == SRC_REGION || q.src == SRC_MIXED) {
        key[j] = __ldcg(&P.bkey[q.src_buf][pos]);
        idx[j] = __ldcg(&P.bidx[q.src_buf][pos]);
        ok[j] = q.src == SRC_REGION || __ldcg(&P.tag[q.src_buf][pos]) == gi;
      } else {
        key[j] = Dt<DT>::key(values[pos]);
        idx[j] = (u32)pos;
        ok[j] = a.live[pos] && (a.bins <= 1 || a.codes[pos] == gi);
      }
    }
#pragma unroll
    for (int j = 0; j < SAMPLE_SCAN; ++j) {
      u64 cv;
      if (!have && ok[j] && passes(f, key[j], idx[j], cv)) {
        have = true;
        mine = cv;
      }
    }
    sm.sk[tid] = mine;
  }
  const u32 haves = __ballot_sync(FULL, have);
  if ((tid & 31) == 0 && tid < SAMPLE) sm.shave[tid >> 5] = haves;
  // a sampling thread without a key holds ~0, which sorts after every key
  // (or beside KEY_NAN, equal to it): the first cnt sorted are the sample
  if (tid < SAMPLE && !have) sm.sk[tid] = ~0ull;
  __syncthreads();
  int cnt = 0;
  for (int w = 0; w < SAMPLE / 32; ++w) cnt += __popc(sm.shave[w]);
  for (int k = 2; k <= SAMPLE; k <<= 1) {       // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (tid < SAMPLE) {
        const int o = tid ^ j;
        if (o > tid) {
          const u64 x = sm.sk[tid], y = sm.sk[o];
          if ((x > y) == ((tid & k) == 0)) { sm.sk[tid] = y; sm.sk[o] = x; }
        }
      }
      __syncthreads();
    }
  }
  if (tid == 0) {
    sm.s_lo = f.klo; sm.s_mid = f.klo; sm.s_hi = f.khi;
    if (cnt > 0) {
      const double qq = (q.r >= 0 && q.c > 1)
          ? (double)q.r / (double)(q.c - 1) : a.p;
      const double t = qq * (double)(cnt - 1);
      const int lo_r = (int)floor(t) - DELTA;      // < 0: the range's
      const int hi_r = (int)ceil(t) + DELTA;       // > cnt - 1: its end
      sm.s_mid = sm.sk[(int)rint(t)];
      if (lo_r >= 0) sm.s_lo = sm.sk[lo_r];
      if (hi_r <= cnt - 1) sm.s_hi = sm.sk[hi_r];
    }
  }
  __syncthreads();
  if (tid == 0) {
    q.lo = sm.s_lo;
    q.mid = sm.s_mid;
    q.hi = sm.s_hi;
    q.below = q.in = q.total = q.lt = q.eq = 0;
    q.dst_cursor = 0;
    q.compact = q.dst != DST_NONE
        && (q.lo < q.hi || (q.phase == 0 && Dt<DT>::special(q.lo)));
  }
  __syncthreads();
}

// The next iteration's work for a group that goes on: its destination in
// buffer `next` (the codes form's groups of more than BLOCK_MAX
// candidates append to the buffer's tagged part, every other group has a
// region sized by its candidates), its splitters, the sweeps it needs, and
// its place in the next list.
template <int DT>
static __device__ void go_on(const Args& a, const Ptrs& P, DwSmem& sm,
                             Grp& q, int gi, int next) {
  Head* H = P.head;
  if (threadIdx.x == 0) {
    if (a.codes != nullptr && q.c > BLOCK_MAX) {
      q.dst = DST_MIXED;
    } else {
      q.dst_off = (int64_t)atomicAdd(&H->cursor[next], (u64)q.c);
      q.dst = q.dst_off + q.c <= P.bufcap ? DST_REGION : DST_NONE;
    }
  }
  __syncthreads();
  sample_splitters<DT>(a, P, sm, q, gi);
  if (threadIdx.x == 0) {
    const u32 need = (a.codes != nullptr && q.src == SRC_PAGE ? NEED_PAGE : 0)
        | (q.src == SRC_MIXED ? NEED_MIXED : 0);
    if (need) atomicOr(&H->need[next], need);
    P.lists[next][atomicAdd(&H->list_count[next], 1u)] = (u32)gi;
  }
  __syncthreads();
}

// The decision after a sweep (thread 0): 0 the group goes on, 1 its result
// is written, 2 a block finishes it from its new, contiguous source.
// Inside [lo, hi] the written candidates stay the source, and a target off
// mid narrows the range to one side of it; a target outside [lo, hi] reads
// the page again.
template <int DT>
static __device__ __forceinline__ int decide_copy(
    const Args& a, Grp& q, int b, const typename Dt<DT>::T* values) {
  typedef typename Dt<DT>::T T;
  const u64 below = q.below, in = q.in, total = q.total, lt = q.lt,
            eq = q.eq;
  if (q.r < 0) {
    if (total == 0) {
      store<DT>((T*)a.out, a.nulls, q.id, 0, true);
      return 1;
    }
    q.r = kth(a.p, (int64_t)total);
    q.c = (int64_t)total;
  }
  const u64 r = (u64)q.r;
  int new_src = SRC_PAGE;
  if (r < below) {
    q.khi = q.lo - 1;
    q.c = (int64_t)below;
  } else if (r >= below + in) {
    q.r = (int64_t)(r - below - in);
    q.klo = q.hi + 1;
    q.c = (int64_t)(total - below - in);
  } else {
    if (q.compact)
      new_src = q.dst == DST_MIXED ? SRC_MIXED : SRC_REGION;
    if (r >= lt && r < lt + eq) {         // the target is at mid
      if (q.phase == 1) {
        store<DT>((T*)a.out, a.nulls, q.id, Dt<DT>::bits(values[q.mid]),
                  false);
        return 1;
      }
      if (!Dt<DT>::special(q.mid)) {
        store<DT>((T*)a.out, a.nulls, q.id, Dt<DT>::unflip(q.mid), false);
        return 1;
      }
      q.phase = 1;              // rows of one key and different bits
      q.K = q.mid;
      q.klo = 0;
      q.khi = ~0ull;
      q.r = (int64_t)(r - lt);
      q.c = (int64_t)eq;
    } else if (r < lt) {
      q.klo = q.lo;
      q.khi = q.mid - 1;
      q.r = (int64_t)(r - below);
      q.c = (int64_t)(lt - below);
    } else {
      q.klo = q.mid + 1;
      q.khi = q.hi;
      q.r = (int64_t)(r - lt - eq);
      q.c = (int64_t)(below + in - lt - eq);
    }
  }
  q.src = new_src;
  q.src_buf = b;
  if (new_src == SRC_REGION) {
    q.src_off = q.dst_off;
    q.src_len = (int64_t)q.dst_cursor;
  }
  const int64_t span = new_src == SRC_REGION ? q.src_len
      : (new_src == SRC_PAGE && a.codes == nullptr ? q.e - q.s : -1);
  return span >= 0 && span <= BLOCK_MAX ? 2 : 0;
}

template <int DT>
static __device__ int decide(const Args& a, Grp& qg, int b) {
  typedef typename Dt<DT>::T T;
  const T* values = (const T*)a.values;
  Grp q = qg;                   // one batch of loads, one of stores
  const int d = decide_copy<DT>(a, q, b, values);
  qg = q;
  return d;
}

template <int DT>
__global__ void __launch_bounds__(DW_THREADS, 1)
sel_dw(Args a) {
  typedef typename Dt<DT>::T T;
  const T* values = (const T*)a.values;
  DwSmem& sm = *reinterpret_cast<DwSmem*>(dyn_smem);
  const Ptrs P = ptrs(a);
  Head* H = P.head;
  const int tid = threadIdx.x, nb = gridDim.x;
  const bool codes = a.codes != nullptr;
  u32 bar_target = 0;

  const int64_t G = codes ? a.bins
      : ((int64_t)H->seg_count < P.gcap ? (int64_t)H->seg_count : P.gcap);
  if (G == 0) return;           // every run was a warp's (same in all blocks)
  for (int i = tid; i < DW_WARPS * MAX_BINS; i += DW_THREADS) {
    sm.wa[i / MAX_BINS][i % MAX_BINS] = 0;
    sm.wb[i / MAX_BINS][i % MAX_BINS] = 0;
  }
  for (int i = tid; i < NCOUNT * MAX_BINS; i += DW_THREADS)
    sm.bt[i / MAX_BINS][i % MAX_BINS] = 0;
  // every bin, or every listed run: its state and first splitters; a block
  // finishes a run that fits it
  for (int64_t g = blockIdx.x; g < G; g += nb) {
    Grp& q = P.grps[g];
    if (tid == 0) {
      q.id = codes ? g : P.seglist[g];
      if (codes) { q.s = 0; q.e = a.n; }
      else {
        int64_t s = a.starts[q.id], e = a.ends[q.id];
        s = s < 0 ? 0 : (s > a.n ? a.n : s);
        e = e < s ? s : (e > a.n ? a.n : e);
        q.s = s; q.e = e;
      }
      q.klo = 0; q.khi = ~0ull; q.K = 0;
      q.r = -1; q.c = q.e - q.s;
      q.src = SRC_PAGE; q.src_buf = 0; q.src_off = 0; q.src_len = 0;
      q.phase = 0; q.active = 1;
      sm.flag = !codes && q.c <= BLOCK_MAX;
    }
    __syncthreads();
    if (sm.flag) {
      finish_block<DT>(a, P, sm, q, -1);
      if (tid == 0) q.active = 0;
    } else {
      go_on<DT>(a, P, sm, q, (int)g, 1);
    }
    __syncthreads();
  }
  grid_sync(&H->bar, bar_target);

  for (int t = 1;; ++t) {
    const int b = t & 1, nxt = b ^ 1;
    const int64_t L = *(volatile u32*)&H->list_count[b];
    if (L == 0) break;
    const u32* list = P.lists[b];
    if (t > MAX_ITERS) {
      BlockTeam team{sm.red, 0};
      for (int64_t li = blockIdx.x; li < L; li += nb) {
        const Grp& q = P.grps[list[li]];
        fallback_select<DT>(values, a.live, a.codes, (int)list[li], a.bins,
                            q.s, q.e, a.p, team, (T*)a.out, a.nulls, q.id);
      }
      break;
    }
    // (1) the sweeps: the page (codes form), the tagged part of the other
    // buffer, then the contiguous sources (runs of the page, regions),
    // their steps dealt over the blocks in list order
    const u32 need = *(volatile u32*)&H->need[b];
    if (blockIdx.x == 0 && tid == 0) {
      H->mixed_base[b] = H->cursor[b];
      H->cursor[nxt] = 0;
      H->list_count[nxt] = 0;
      H->need[nxt] = 0;
    }
    for (int pass = 0; pass < 2; ++pass) {
      const int src = pass == 0 ? SRC_PAGE : SRC_MIXED;
      if (!(need & (pass == 0 ? NEED_PAGE : NEED_MIXED))) continue;
      __syncthreads();
      if (tid < a.bins) {
        const Grp& q = P.grps[tid];
        sm.gi[tid] = ginfo(q, q.active && q.src == src);
      }
      __syncthreads();
      if (src == SRC_PAGE) {
        sweep<DT, true, false>(a, P, sm, nullptr, a.bins, 0, a.n, 0, b,
                               blockIdx.x, nb);
      } else {
        const int64_t from = (int64_t)H->mixed_base[nxt];
        sweep<DT, false, false>(a, P, sm, nullptr, a.bins, from,
                                from + (int64_t)H->mixed_count[nxt], nxt, b,
                                blockIdx.x, nb);
      }
    }
    int64_t cum = 0;
    for (int64_t li = 0; li < L; ++li) {
      Grp& q = P.grps[list[li]];
      const bool region = q.src == SRC_REGION;
      if (!region && (codes || q.src != SRC_PAGE)) continue;
      const int64_t from = region ? q.src_off : q.s;
      const int64_t len = region ? q.src_len : q.e - q.s;
      // steps from the run of 8 that holds `from`
      const int64_t nst = (from + len - (from & ~(int64_t)7) + STEP - 1) / STEP;
      const int64_t first = ((int64_t)blockIdx.x - cum % nb + nb) % nb;
      cum += nst;
      if (first >= nst) continue;
      if (region)
        sweep<DT, false, true>(a, P, sm, &q, 1, from, from + len, q.src_buf,
                               b, first, nb);
      else
        sweep<DT, true, true>(a, P, sm, &q, 1, from, from + len, 0, b,
                              first, nb);
    }
    grid_sync(&H->bar, bar_target);
    // (2) each group's decision, and the next iteration's splitters
    if (blockIdx.x == 0 && tid == 0) H->mixed_count[nxt] = 0;
    for (int64_t li = blockIdx.x; li < L; li += nb) {
      Grp& q = P.grps[list[li]];
      if (tid == 0) sm.flag = decide<DT>(a, q, b);
      __syncthreads();
      const int d = sm.flag;
      if (d == 2) finish_block<DT>(a, P, sm, q, q.r);
      if (d != 0) {
        if (tid == 0) q.active = 0;
      } else {
        go_on<DT>(a, P, sm, q, (int)list[li], nxt);
      }
      __syncthreads();
    }
    grid_sync(&H->bar, bar_target);
  }
}

// --- host -------------------------------------------------------------------

template <int DT>
static int launch(const Args& a, cudaStream_t s) {
  const Layout L = layout(a.n, a.groups, a.bins);
  cudaError_t err = cudaMemsetAsync(a.scratch + L.head, 0, sizeof(Head), s);
  if (err != cudaSuccess) return (int)err;
  if (a.codes == nullptr) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int64_t blocks = (a.groups + WARP_THREADS / 32 - 1) / (WARP_THREADS / 32);
    const int64_t most = (int64_t)sms * 8;
    blocks = blocks < 1 ? 1 : (blocks > most ? most : blocks);
    sel_warp<DT><<<(unsigned)blocks, WARP_THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  static int grid = 0;          // co-resident blocks of sel_dw<DT>
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaFuncSetAttribute(sel_dw<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(DwSmem));
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sel_dw<DT>, DW_THREADS, sizeof(DwSmem));
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    grid = sms * per_sm;
  }
  Args arg = a;
  void* params[] = {&arg};
  err = cudaLaunchCooperativeKernel(sel_dw<DT>, dim3(grid), dim3(DW_THREADS),
                                    params, sizeof(DwSmem), s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int64 words of scratch segment_select takes for n rows and, in the codes
// form (bins > 0), bins groups, or in the runs form (bins == 0), `groups`
// runs.
int64_t segment_select_scratch_words(int64_t n, int64_t groups, int bins) {
  return layout(n, groups, bins).total;
}

// values: [n] (dtype 0 float64, 1 int64, 2 int32); live: [n] uint8; codes
// form: codes [n] int32 in [0, bins), 1 <= bins <= 64, starts/ends null;
// runs form: codes null, bins 0, starts/ends [groups] int64. out:
// [groups or bins] of values' dtype; nulls: same length, uint8. scratch:
// segment_select_scratch_words(n, groups, bins) int64 words. n < 2^31.
int segment_select(const void* values, int dtype, const void* live,
                   int64_t n, const void* codes, int bins,
                   const void* starts, const void* ends, int64_t groups,
                   double p, void* scratch, void* out, void* nulls,
                   void* stream) {
  if (dtype < DT_F64 || dtype > DT_I32 || n < 0 || n >= (1ll << 31)
      || groups < 0 || bins < 0 || bins > MAX_BINS
      || (codes != nullptr) != (bins > 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.values = values;
  a.live = (const uint8_t*)live;
  a.codes = (const int32_t*)codes;
  a.starts = (const int64_t*)starts;
  a.ends = (const int64_t*)ends;
  a.n = n;
  a.groups = bins > 0 ? bins : groups;
  a.bins = bins;
  a.p = p;
  a.out = out;
  a.nulls = (uint8_t*)nulls;
  a.scratch = (int64_t*)scratch;
  if (a.groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F64) return launch<DT_F64>(a, s);
  if (dtype == DT_I64) return launch<DT_I64>(a, s);
  return launch<DT_I32>(a, s);
}

}  // extern "C"
