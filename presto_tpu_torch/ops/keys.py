"""Key normalization and multi-key sort permutations.

The port's twin of presto_tpu/ops/keys.py: SortKey, group_values,
values_equal, lex_perm, sort_perm, new_group_flags, the key hash
`hash_columns` (kernel K4, csrc/hash.cu) and `key_change_flags`, the
adjacent-compare boundary flags of windows and distinct marks (kernel K8,
csrc/keys.cu). Argsorts are `torch.sort(..., stable=True)`, composed
least-significant lane first, as in the JAX package.

Float64 keys compare and hash with subnormals flushed to zero (1e-310
equals 0.0), as the JAX package's key functions do on the CPU, where
XLA's code flushes them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from presto_tpu_torch.data.column import Column, Page


@dataclasses.dataclass(frozen=True)
class SortKey:
    field: int
    ascending: bool = True
    # Presto default: nulls are "larger than any value" — last for ASC,
    # first for DESC (reference: presto-common/.../SortOrder.java).
    nulls_first: Optional[bool] = None

    @property
    def nulls_sort_first(self) -> bool:
        if self.nulls_first is not None:
            return self.nulls_first
        return not self.ascending


#: the smallest normal float64; smaller magnitudes are subnormal
F64_MIN_NORMAL = 2.2250738585072014e-308


def flush_subnormal(v: torch.Tensor) -> torch.Tensor:
    """Float64 subnormals as 0.0 (NaN and everything else unchanged)."""
    return torch.where(v.abs() < F64_MIN_NORMAL, 0.0, v)


def _orderable_values(col: Column) -> torch.Tensor:
    """Per-type tensor whose ascending order == SQL ascending order.
    Strings are already codes into a sorted dictionary; float64
    subnormals sort as 0.0, as in the JAX package on the CPU."""
    v = col.values
    if v.dtype == torch.bool:
        return v.to(torch.int32)
    if v.dtype == torch.float64:
        return flush_subnormal(v)
    return v


def _orderable_lanes(col: Column):
    """Sort-key lanes, most-significant first (presto_tpu/ops/keys.py:57).
    Without DECIMAL(38) columns in the port yet, one lane per column."""
    return [_orderable_values(col)]


def descending(v: torch.Tensor) -> torch.Tensor:
    """A lane whose ascending order is v's descending order: floats
    negated, integers and codes complemented in int64 (~v = -v - 1, which
    unlike the JAX package's negation also reverses INT64_MIN, whose
    negation wraps to itself)."""
    return -v if v.is_floating_point() else ~v.to(torch.int64)


def group_values(col: Column) -> torch.Tensor:
    """Per-type tensor where equality/order == SQL group equality/order:
    floats as float64 (NaN handled by values_equal), everything else as
    int64."""
    v = col.values
    if v.dtype in (torch.float64, torch.float32):
        return flush_subnormal(v.to(torch.float64))
    return v.to(torch.int64)


def group_values_lane(v: torch.Tensor) -> torch.Tensor:
    """A key lane as group_values would give it: float64 or int64."""
    if v.is_floating_point():
        return v.to(torch.float64)
    return v.to(torch.int64)


def values_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group-key equality over group_values outputs: NaN == NaN (SQL
    grouping semantics), subnormals equal to zero; plain equality for
    integers."""
    if a.dtype == torch.float64:
        a = flush_subnormal(a)
    if b.dtype == torch.float64:
        b = flush_subnormal(b)
    return (a == b) | ((a != a) & (b != b))


def _argsort(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    return torch.sort(v, stable=True).indices


def lex_perm(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by `lanes` (most
    significant first, each ascending), via composed stable argsorts."""
    perm = None
    for lane in reversed(list(lanes)):
        if perm is None:
            perm = _argsort(lane)
        else:
            perm = perm[_argsort(lane[perm])]
    return perm


def sort_perm(page: Page, keys: Sequence[SortKey]) -> torch.Tensor:
    """Permutation that stably sorts valid rows by `keys` with SQL null
    ordering; padding rows always sort last. Composed stable argsorts,
    least-significant key first."""
    cap = page.capacity
    dev = page.device
    perm = torch.arange(cap, dtype=torch.int64, device=dev)
    for k in reversed(list(keys)):
        col = page.columns[k.field]
        v = _orderable_values(col)[perm]
        if not k.ascending:
            v = descending(v)
        perm = perm[_argsort(v)]
        # null placement: stable second pass on the null bucket
        n = col.nulls[perm]
        null_key = (~n).to(torch.int32) if k.nulls_sort_first \
            else n.to(torch.int32)
        perm = perm[_argsort(null_key)]
    pad = (torch.arange(cap, dtype=torch.int64, device=dev)
           >= page.num_rows)[perm]
    return perm[_argsort(pad.to(torch.int32))]


def new_group_flags(sorted_page: Page,
                    fields: Sequence[int]) -> torch.Tensor:
    """On a page already gathered into key order by `fields`, True where a
    row starts a new group (row 0 is always a start). Null == null for
    grouping."""
    flags = torch.zeros(sorted_page.capacity, dtype=torch.bool,
                        device=sorted_page.device)
    for f in fields:
        col = sorted_page.columns[f]
        v = group_values(col)
        n = col.nulls
        prev_v = torch.roll(v, 1)
        prev_n = torch.roll(n, 1)
        same = (values_equal(v, prev_v) & ~n & ~prev_n) | (n & prev_n)
        flags |= ~same
    flags[0] = True
    return flags


# -- hashing ---------------------------------------------------------------
# The JAX package hashes in uint64. torch on the CPU has no uint64 shifts or
# additions, so the plain version works on the same bits in int64: additions
# and multiplications wrap identically, and a logical right shift is an
# arithmetic one with the sign-extended bits masked off.

def _i64(u: int) -> int:
    """The int64 with the bits of the uint64 constant `u`."""
    return u - (1 << 64) if u >= (1 << 63) else u


_SPLITMIX_C1 = _i64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = _i64(0x94D049BB133111EB)
_GOLDEN = _i64(0x9E3779B97F4A7C15)
NULL_TAG = 0x5BD1E995
_MASK63 = 0x7FFFFFFFFFFFFFFF

#: key lane dtypes the hash and join kernels read, by their code
LANE_DTYPES = {torch.float64: 0, torch.int64: 1, torch.int32: 2,
               torch.bool: 3, torch.float32: 4}

#: most key lanes one launch of a hash or join kernel takes
MAX_KEY_LANES = 16


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the int64 bits of `x` by k."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _SPLITMIX_C1
    x = (x ^ _srl(x, 27)) * _SPLITMIX_C2
    return x ^ _srl(x, 31)


def f64_hash_lanes(v: torch.Tensor) -> torch.Tensor:
    """The JAX package's float hash input (presto_tpu/ops/keys.py:107), as
    int64 bits: an exponent lane from floor(log2|v|) and the top 32
    mantissa bits taken arithmetically, with fixed tags for NaN, +-inf
    and +-0 (so NaN hashes equal to NaN, and -0.0 and subnormals to
    0.0)."""
    v = flush_subnormal(v.to(torch.float64))
    is_nan = torch.isnan(v)
    is_inf = torch.isinf(v)
    safe = torch.where(is_nan | is_inf, 1.0, v)
    ae = torch.clamp(safe.abs(), min=1e-300)
    e = torch.floor(torch.log2(ae))
    norm = ae * torch.exp2(-e)
    mant = (torch.clamp(norm - 1.0, 0.0, 1.0) * 2.0 ** 32).to(torch.int64)
    eb = e.to(torch.int64) + 2048
    h = (eb * _GOLDEN) ^ mant
    h = torch.where(v < 0, h ^ _i64(0xA5A5A5A5DEADBEEF), h)
    h = torch.where(v == 0.0, 0x5E5E0000, h)
    h = torch.where(is_nan, 0x7FF8000000000001, h)
    h = torch.where(is_inf & (v > 0), 0x7FF0000000000000, h)
    return torch.where(is_inf & (v < 0), _i64(0xFFF0000000000000), h)


def _hash_columns_plain(cols: Sequence[Column]) -> torch.Tensor:
    """Plain PyTorch version of the hash_columns kernel."""
    h = torch.zeros(cols[0].capacity, dtype=torch.int64,
                    device=cols[0].values.device)
    for c in cols:
        g = group_values(c)
        v = f64_hash_lanes(g) if g.is_floating_point() else g
        v = torch.where(c.nulls, NULL_TAG, v)
        h = _mix64(h ^ (v + _GOLDEN + (h << 6) + _srl(h, 2)))
    return h & _MASK63


def lane_arrays(tensors: Sequence[torch.Tensor]):
    """(pointer array, dtype code array) describing key lanes for the
    hash and join kernels, as c_void_p (each keeps its array alive);
    raises on a dtype or lane count they do not take."""
    if len(tensors) > MAX_KEY_LANES:
        raise ValueError(f"{len(tensors)} key lanes: the kernels take at "
                         f"most {MAX_KEY_LANES}")
    codes = []
    for t in tensors:
        if t.dtype not in LANE_DTYPES or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError(f"key lane {t.dtype} {tuple(t.shape)}: the "
                            f"kernels take contiguous 1-d "
                            f"{sorted(map(str, LANE_DTYPES))}")
        codes.append(LANE_DTYPES[t.dtype])
    k = max(len(tensors), 1)
    ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in tensors])
    dts = (ctypes.c_int * k)(*codes)
    return (ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(dts, ctypes.c_void_p))


def hash_columns(cols: Sequence[Column]) -> torch.Tensor:
    """Combined 64-bit hash of the key columns per row (splitmix64
    combine; presto_tpu/ops/keys.py:211), masked to non-negative int64.
    NULL hashes to a fixed tag; joins exclude null keys themselves.

    Kernel K4 (csrc/hash.cu) on CUDA tensors, the plain version on CPU
    tensors. Integer, boolean and dictionary-coded keys give the JAX
    function's exact value; float keys go through log2/exp2, which may
    differ from XLA's by an ulp, so only equality within the port is
    promised for them (equal keys hash equal, NaN = NaN, -0.0 = 0.0)."""
    if not cols:
        raise ValueError("hash_columns needs at least one key column")
    dev = cols[0].values.device
    cap = cols[0].capacity
    for c in cols:
        if c.values.device != dev or c.capacity != cap:
            raise ValueError("hash_columns: key columns differ in device "
                             "or capacity")
    if dev.type == "cpu":
        return _hash_columns_plain(cols)
    if dev.type != "cuda":
        raise RuntimeError(f"hash_columns: no kernel for {dev}")
    from presto_tpu_torch import native
    vals = [c.values.contiguous() for c in cols]
    nulls = [c.nulls.contiguous() for c in cols]
    vptr, dts = lane_arrays(vals)
    nptr, _ = lane_arrays(nulls)
    out = torch.empty(cap, dtype=torch.int64, device=dev)
    lib = native.load("hash")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hash_columns(
            vptr, dts, nptr, len(cols), cap,
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "hash_columns", "hash")
    hash_columns.launches += 1
    return out


hash_columns.launches = 0


# -- K8 key_change_flags ----------------------------------------------------

#: key_change_flags modes: partition and peer start flags of a window;
#: first-occurrence flags of a distinct mark
WINDOW_FLAGS, FIRST_FLAGS = 0, 1

#: most lanes (null lanes included) one key_change launch takes
MAX_CHANGE_LANES = 32


def _key_same_plain(nulls, lanes, r, q) -> torch.Tensor:
    """Is the key at rows r equal to the key at rows q? Null == null, a
    null never equals a value, NaN == NaN, subnormals equal zero."""
    same = torch.ones(r.shape[0], dtype=torch.bool, device=r.device)
    for lane in lanes:
        same &= values_equal(group_values_lane(lane)[r],
                             group_values_lane(lane)[q])
    if nulls is None:
        return same
    nr, nq = nulls[r], nulls[q]
    return (same & ~nr & ~nq) | (nr & nq)


def _key_change_plain(perm, keys, num_rows, n_part_keys, mode):
    """Plain PyTorch version of the key_change kernel: each key compared
    between sorted positions i and i - 1 with gathers."""
    n = perm.shape[0]
    dev = perm.device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    r = perm
    q = perm[(i - 1).clamp(min=0)]
    first = i == 0
    changed = [~_key_same_plain(nl, lanes, r, q) for nl, lanes in keys]
    part = first.clone()
    for c in changed[:n_part_keys]:
        part |= c
    if mode == FIRST_FLAGS:
        for c in changed[n_part_keys:]:
            part |= c
        return part & (i < num_rows), None
    part |= i == num_rows        # the valid -> padding edge
    peer = part.clone()
    for c in changed[n_part_keys:]:
        peer |= c
    return part, peer


def key_change_flags(perm: torch.Tensor, keys, num_rows: torch.Tensor,
                     n_part_keys: int = 0, mode: int = WINDOW_FLAGS):
    """Boundary flags over rows taken in `perm` order (kernel K8,
    csrc/keys.cu): presto_tpu/ops/window.py:171-195 and
    presto_tpu/ops/mark_distinct.py:47-51 in one pass.

    `keys` is a list of `(nulls, lanes)` in original row order: `nulls` a
    bool lane (or None: the lanes alone decide) and `lanes` the key's
    value lanes (float64, float32, int64, int32 or bool). Sorted position
    i "changes" key k when k at row perm[i] differs from k at row
    perm[i - 1]: two nulls are the same, a null and a value are not, and
    values compare by values_equal (NaN == NaN, subnormal == 0).

    - WINDOW_FLAGS: returns (part_start, peer_start). part_start[i] is
      i == 0, a change of one of the first `n_part_keys` keys, or
      i == num_rows (the edge from valid rows to padding, which sort
      last); peer_start[i] is part_start[i] or a change of a later key.
    - FIRST_FLAGS: returns (first, None). first[i] is (i == 0 or a change
      of any key) and i < num_rows: padding rows never start a mark.

    On CPU tensors the plain version; on CUDA tensors the kernel."""
    if mode not in (WINDOW_FLAGS, FIRST_FLAGS):
        raise ValueError(f"key_change_flags: unknown mode {mode}")
    dev = perm.device
    if perm.dtype != torch.int64 or perm.dim() != 1:
        raise TypeError("key_change_flags: perm must be 1-d int64")
    n = perm.shape[0]
    tensors = []
    for nulls, lanes in keys:
        for t in ([nulls] if nulls is not None else []) + list(lanes):
            if t.shape != (n,) or t.device != dev:
                raise TypeError("key_change_flags: lanes must be 1-d like "
                                "perm, on its device")
            tensors.append(t)
    if dev.type == "cpu":
        return _key_change_plain(perm, keys, num_rows, n_part_keys, mode)
    if dev.type != "cuda":
        raise RuntimeError(f"key_change_flags: no kernel for {dev}")
    if len(tensors) > MAX_CHANGE_LANES:
        raise ValueError(f"{len(tensors)} key lanes: key_change takes at "
                         f"most {MAX_CHANGE_LANES}")
    from presto_tpu_torch import native
    perm = perm.contiguous()
    lanes_c, codes, key_null, key_first, key_count = [], [], [], [], []
    for nulls, lanes in keys:
        if nulls is not None:
            key_null.append(len(lanes_c))
            lanes_c.append(nulls.contiguous())
            codes.append(LANE_DTYPES[torch.bool])
        else:
            key_null.append(-1)
        key_first.append(len(lanes_c))
        key_count.append(len(lanes))
        for lane in lanes:
            if lane.dtype not in LANE_DTYPES:
                raise TypeError(f"key_change_flags: lane dtype {lane.dtype}")
            lanes_c.append(lane.contiguous())
            codes.append(LANE_DTYPES[lane.dtype])
    k = max(len(lanes_c), 1)
    nk = max(len(keys), 1)
    ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in lanes_c])
    dts = (ctypes.c_int * k)(*codes)
    kn = (ctypes.c_int * nk)(*key_null)
    kf = (ctypes.c_int * nk)(*key_first)
    kc = (ctypes.c_int * nk)(*key_count)
    out0 = torch.empty(n, dtype=torch.bool, device=dev)
    out1 = (torch.empty(n, dtype=torch.bool, device=dev)
            if mode == WINDOW_FLAGS else None)
    num_rows = num_rows.to(device=dev, dtype=torch.int64).reshape(())
    lib = native.load("keys")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.key_change(
            ctypes.c_void_p(perm.data_ptr()), n,
            ctypes.c_void_p(num_rows.data_ptr()),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(dts, ctypes.c_void_p), len(lanes_c),
            ctypes.cast(kn, ctypes.c_void_p),
            ctypes.cast(kf, ctypes.c_void_p),
            ctypes.cast(kc, ctypes.c_void_p), len(keys), n_part_keys, mode,
            ctypes.c_void_p(out0.data_ptr()),
            ctypes.c_void_p(out1.data_ptr() if out1 is not None else 0),
            ctypes.c_void_p(stream))
    native.check(rc, "key_change_flags", "keys")
    key_change_flags.launches += 1
    return out0, out1


key_change_flags.launches = 0
