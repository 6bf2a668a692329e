"""Grouped aggregation.

The port's twin of presto_tpu/ops/aggregate.py. Two paths, chosen as in
the JAX package:

- Direct (`_direct_grouped_aggregate`): every group key has a small static
  domain (dictionary-coded strings, booleans) and the mixed-radix bin count
  is at most `direct_agg_max_bins`. One pass of the hand-written
  `direct_agg` kernel (csrc/direct_agg.cu, K1) computes each row's bin, its
  validity under the fused filter mask, and per-bin counts, sums and
  min/max. Global aggregation is the one-bin case.
- Sorted (`_sorted_grouped_aggregate`): a stable permutation by the key
  lanes, group starts by stable compaction of the new-group flags
  (`compact_indices`, K2) and per-group reductions over contiguous
  segments (`segment_reduce`, K3).

Kinds: count_star, count, sum, avg, avg_partial, avg_final, min, max,
bool_or, bool_and, and the DECIMAL(38) kinds sum128 and avg128: four int64
limb sums per group (K1's and K3's 128-bit sum modes) and a count, into a
Decimal128Column whose exact value the host recombines. Min and max over
DECIMAL(p>18) inputs are exact lexicographic reductions over the
normalized limbs, in torch ops. approx_distinct takes each group's
HyperLogLog registers with the hand-written `hll_registers` kernel
(csrc/hll.cu, K12; by bin on the direct path, by group run on the sorted
path) and the JAX package's estimate; approx_percentile selects each
group's order statistic from the unsorted values with the hand-written
`segment_select` kernel (csrc/percentile.cu, K13; by bin on the direct
path, by group run on the sorted path), with no sort. Both raise
NotImplementedError over a DECIMAL(38) input, as the JAX package does.

The final merges sum128_merge/avg128_merge (the FINAL step over
DECIMAL(38) partial states, which exec/lifespan.py and the distributed
split produce) sum each group's partial limb lanes, count its live
partial states (a group with none is NULL) and, for avg128_merge, sum the
count column into the result's `count`. They are routed as in the JAX
package (presto_tpu/ops/aggregate.py:197-215, :471-473, :556-575): a
global merge takes the one-bin direct path, where K1 sums the limb lanes
and the count column in its 128-bit mode (`WANT_MERGE128`); a grouped
merge always takes the sorted path, where K3's merge mode
(`segment_merge128`) does the same per group run in one launch.

Capacity contract as in the JAX package: the output page has capacity
`out_capacity`; the true group count is returned unclamped so the executor
can detect overflow and re-run at a larger bucket.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.data import int128 as I
from presto_tpu_torch.data.column import (
    Column, Decimal128Column, Page, torch_dtype,
)
from presto_tpu_torch.types import BIGINT, DOUBLE, Type


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: kind in {sum,count,count_star,min,max,avg,
    avg_partial,avg_final,...}. The planner rewrites kinds for
    partial/final steps; this op evaluates what it is given."""
    kind: str
    field: Optional[int]          # input column (None for count_star)
    output_type: Type
    field2: Optional[int] = None  # second state input (avg_final: count)
    mask_field: Optional[int] = None  # FILTER / mask channel (bool column)
    param: Optional[float] = None  # extra literal (approx_percentile p)


_PORTED_KINDS = {"count_star", "count", "sum", "avg", "avg_partial",
                 "avg_final", "min", "max", "bool_or", "bool_and",
                 "sum128", "avg128", "sum128_merge", "avg128_merge",
                 "approx_distinct", "approx_percentile"}
_APPROX_KINDS = ("approx_distinct", "approx_percentile")
_MERGE_KINDS = ("sum128_merge", "avg128_merge")
_WIDE_KINDS = ("sum128", "avg128", "count", "min", "max")

_DIRECT_MAX_BINS = 64

WANT_SUM = 1
WANT_MINMAX = 2
WANT_SUM128 = 4
#: a limb input of DECIMAL(38) partial states (sum128_merge/avg128_merge):
#: summed as WANT_SUM128, and counted apart in the launch counters
WANT_MERGE128 = 8


def _check_kinds(aggs: Sequence[AggSpec]) -> None:
    for a in aggs:
        if a.kind not in _PORTED_KINDS:
            raise NotImplementedError(
                f"aggregate {a.kind}: later slice of the port")


def _agg_inputs(a: AggSpec, page: Page):
    """(values, null-or-masked-out) for an aggregate input, unpermuted. A
    DECIMAL(p>18) input's values are its four limb lanes."""
    if a.field is not None:
        col = page.columns[a.field]
        if isinstance(col, Decimal128Column):
            if a.kind not in _WIDE_KINDS:
                raise NotImplementedError(f"{a.kind} over DECIMAL(38) input")
            vals = col.value_lanes
        else:
            vals = col.values
        nulls = col.nulls
    else:
        vals = torch.zeros(page.capacity, dtype=torch.int64,
                           device=page.device)
        nulls = torch.zeros(page.capacity, dtype=torch.bool,
                            device=page.device)
    if a.mask_field is not None:
        m = page.columns[a.mask_field]
        nulls = nulls | ~(~m.nulls & m.values.to(torch.bool))
    return vals, nulls


def _kernel_values(vals):
    """Values in a dtype the kernels take (float64, int64, int32); limb
    lanes as they are."""
    if isinstance(vals, tuple) or vals.dtype in (torch.float64, torch.int64,
                                                  torch.int32):
        return vals
    if vals.is_floating_point():
        return vals.to(torch.float64)
    return vals.to(torch.int32)


# ---------------------------------------------------------------------------
# K1: direct_agg
# ---------------------------------------------------------------------------

_DA_MAX_KEYS = 6
_DA_MAX_INPUTS = 12
_DTYPE_CODES = {torch.float64: 0, torch.int64: 1, torch.int32: 2}
_DT_LIMBS = 3


class _DirectAggArgs(ctypes.Structure):
    """Field for field the DirectAggArgs struct of csrc/direct_agg.cu."""
    _fields_ = [
        ("n", ctypes.c_int64),
        ("num_rows", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("num_keys", ctypes.c_int32),
        ("bins", ctypes.c_int32),
        ("key_codes", ctypes.c_void_p * _DA_MAX_KEYS),
        ("key_nulls", ctypes.c_void_p * _DA_MAX_KEYS),
        ("key_domain", ctypes.c_int32 * _DA_MAX_KEYS),
        ("num_inputs", ctypes.c_int32),
        ("in_values", ctypes.c_void_p * _DA_MAX_INPUTS),
        ("in_nulls", ctypes.c_void_p * _DA_MAX_INPUTS),
        ("in_dtype", ctypes.c_int32 * _DA_MAX_INPUTS),
        ("in_want", ctypes.c_int32 * _DA_MAX_INPUTS),
        ("rows", ctypes.c_void_p),
        ("cnt", ctypes.c_void_p),
        ("fsum", ctypes.c_void_p),
        ("isum", ctypes.c_void_p),
        ("mn", ctypes.c_void_p),
        ("mx", ctypes.c_void_p),
        ("in_limbs", (ctypes.c_void_p * 4) * _DA_MAX_INPUTS),
        ("lsum", ctypes.c_void_p),
    ]


def _bin_codes(keys, domains, cap: int, dev) -> torch.Tensor:
    """Each row's mixed-radix bin over the key codes (a NULL key takes the
    extra bin `domain`), as the direct_agg kernel computes it."""
    code = torch.zeros(cap, dtype=torch.int32, device=dev)
    for (codes, knulls), dom in zip(keys, domains):
        v = codes.clamp(0, dom - 1)
        v = torch.where(knulls, dom, v)
        code = code * (dom + 1) + v
    return code


def _direct_agg_plain(capacity, num_rows, keys, domains, inputs, mask):
    """Plain PyTorch version of the direct_agg kernel: the JAX package's
    per-bin masked whole-array reductions."""
    dev, cap = num_rows.device, capacity
    bins = 1
    for d in domains:
        bins *= d + 1
    code = _bin_codes(keys, domains, cap, dev)
    valid = torch.arange(cap, dtype=torch.int64, device=dev) < num_rows
    if mask is not None:
        valid = valid & mask
    masks = [valid & (code == b) for b in range(bins)]
    out = {"rows": torch.stack([m.sum(dtype=torch.int64) for m in masks])}
    cnt, fsum, isum, mn, mx, lsum = [], [], [], [], [], []
    zero_b = torch.zeros(bins, dtype=torch.int64, device=dev)
    for vals, nulls, want in inputs:
        live = [m & ~nulls for m in masks] if nulls is not None else masks
        cnt.append(torch.stack([lv.sum(dtype=torch.int64) for lv in live]))
        if want & WANT_SUM128:
            lanes = vals if isinstance(vals, tuple) else I.from_int64(vals)
            lsum.append(torch.stack([
                torch.stack([torch.where(lv, x, 0).sum() for lv in live])
                for x in lanes]))
        else:
            lsum.append(torch.stack([zero_b] * 4))
        if isinstance(vals, tuple):             # limb lanes: counts only
            for part in (isum, mn, mx):
                part.append(zero_b)
            fsum.append(zero_b.to(torch.float64))
            continue
        is_f = vals.dtype == torch.float64
        if want & WANT_SUM:
            f64 = vals.to(torch.float64)
            fsum.append(torch.stack([torch.where(lv, f64, 0.0).sum()
                                     for lv in live]))
            i64 = vals.to(torch.int64) if not is_f else None
            isum.append(torch.stack([torch.where(lv, i64, 0).sum()
                                     for lv in live]) if not is_f
                        else torch.zeros(bins, dtype=torch.int64,
                                         device=dev))
        else:
            fsum.append(torch.zeros(bins, dtype=torch.float64, device=dev))
            isum.append(torch.zeros(bins, dtype=torch.int64, device=dev))
        if want & WANT_MINMAX:
            if is_f:
                lo = torch.stack([torch.where(lv, vals, float("inf")).min()
                                  for lv in live])
                hi = torch.stack([torch.where(lv, vals, float("-inf")).max()
                                  for lv in live])
                mn.append(lo.view(torch.int64))
                mx.append(hi.view(torch.int64))
            else:
                big = torch.iinfo(torch.int64).max
                v64 = vals.to(torch.int64)
                mn.append(torch.stack([torch.where(lv, v64, big).min()
                                       for lv in live]))
                mx.append(torch.stack([torch.where(lv, v64, -big - 1).max()
                                       for lv in live]))
        else:
            mn.append(torch.zeros(bins, dtype=torch.int64, device=dev))
            mx.append(torch.zeros(bins, dtype=torch.int64, device=dev))
    empty = {"fsum": torch.float64}
    for name, parts in (("cnt", cnt), ("fsum", fsum), ("isum", isum),
                        ("mn", mn), ("mx", mx)):
        out[name] = torch.stack(parts) if parts else torch.empty(
            (0, bins), dtype=empty.get(name, torch.int64), device=dev)
    out["lsum"] = torch.stack(lsum) if lsum else torch.empty(
        (0, 4, bins), dtype=torch.int64, device=dev)
    return out


def direct_agg(capacity: int, num_rows: torch.Tensor,
               keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               domains: Sequence[int],
               inputs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor],
                                      int]],
               mask: Optional[torch.Tensor] = None) -> dict:
    """Direct small-domain aggregation (kernel K1, csrc/direct_agg.cu).

    capacity: rows in every column; num_rows: 0-d int64 (rows at or past
    it are padding); keys: per key (int32 codes, bool nulls); domains: per
    key the number of codes (a NULL key takes bin `domain`); inputs: per
    input (values float64/int64/int32 or four int64 limb lanes, bool nulls
    or None, want = WANT_SUM | WANT_MINMAX | WANT_SUM128; limb lanes take
    WANT_SUM128 or nothing, and WANT_MERGE128 beside WANT_SUM128 where
    they are partial states); mask: bool fused filter mask or None.

    Returns "rows" [bins] int64 (valid rows per bin) and, per input and
    bin, "cnt" (live rows), "fsum" (float64 sum), "isum" (int64 sum,
    wrapping; 0 for float inputs), "mn"/"mx" (8-byte words: float64 bits
    for float64 inputs, int64 otherwise), each [inputs, bins], and
    "lsum" [inputs, 4, bins], the wrapping int64 sums of the inputs' limb
    lanes l3..l0 (integer values decompose as int128.from_int64). On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel, once per chunk of at most 12 inputs, with int64 scratch of the
    size the library's `direct_agg_scratch_words` gives for the chunk."""
    if len(keys) != len(domains) or len(keys) > _DA_MAX_KEYS:
        raise ValueError(f"direct_agg: at most {_DA_MAX_KEYS} keys, one "
                         f"domain each")
    bins = 1
    for d in domains:
        if d < 1:
            raise ValueError("direct_agg: domains must be >= 1")
        bins *= d + 1
    if bins > _DIRECT_MAX_BINS:
        raise ValueError(f"direct_agg: {bins} bins > {_DIRECT_MAX_BINS}")
    if num_rows.dtype != torch.int64 or num_rows.numel() != 1:
        raise TypeError("direct_agg: num_rows must be a 0-d int64 tensor")
    dev = num_rows.device
    columns = [(c, torch.int32) for c, _n in keys] + [
        (n, torch.bool) for _c, n in keys] + [
        (m, torch.bool) for m in (mask,) if m is not None] + [
        (nl, torch.bool) for _v, nl, _w in inputs if nl is not None]
    for v, _nl, want in inputs:
        if want & WANT_MERGE128 and not (isinstance(v, tuple)
                                         and want & WANT_SUM128):
            raise TypeError("direct_agg: WANT_MERGE128 marks limb inputs "
                            "summed with WANT_SUM128")
        if isinstance(v, tuple):
            if len(v) != 4 or want & (WANT_SUM | WANT_MINMAX):
                raise TypeError("direct_agg: limb inputs are four lanes and "
                                "take WANT_SUM128 only")
            columns.extend((x, torch.int64) for x in v)
            continue
        if v.dtype not in _DTYPE_CODES or (
                want & WANT_SUM128 and v.dtype == torch.float64):
            raise TypeError(f"direct_agg: input dtype {v.dtype}")
        columns.append((v, v.dtype))
    for t, dt in columns:
        if t.dtype != dt or t.shape != (capacity,) or t.device != dev:
            raise TypeError(f"direct_agg: expected {dt} [{capacity}] on "
                            f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    if dev.type == "cpu":
        return _direct_agg_plain(capacity, num_rows, keys, domains, inputs,
                                 mask)
    if dev.type != "cuda":
        raise RuntimeError(f"direct_agg: no kernel for {dev}")
    from presto_tpu_torch import native
    keys = [(c.contiguous(), n.contiguous()) for c, n in keys]
    mask = mask.contiguous() if mask is not None else None
    lib = native.load("direct_agg")
    n_in = len(inputs)
    rows = torch.empty(bins, dtype=torch.int64, device=dev)
    out = {"rows": rows,
           "cnt": torch.empty((n_in, bins), dtype=torch.int64, device=dev),
           "fsum": torch.empty((n_in, bins), dtype=torch.float64,
                               device=dev),
           "isum": torch.empty((n_in, bins), dtype=torch.int64, device=dev),
           "mn": torch.empty((n_in, bins), dtype=torch.int64, device=dev),
           "mx": torch.empty((n_in, bins), dtype=torch.int64, device=dev),
           "lsum": torch.empty((n_in, 4, bins), dtype=torch.int64,
                               device=dev)}
    # a launch takes at most 12 inputs (the kernel splits their
    # accumulators into groups that fit its shared memory)
    chunks = [list(range(i, min(i + _DA_MAX_INPUTS, n_in)))
              for i in range(0, n_in, _DA_MAX_INPUTS)] or [[]]
    keep_alive = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for chunk in chunks:
            a = _DirectAggArgs()
            a.n = capacity
            a.num_rows = num_rows.data_ptr()
            a.mask = mask.data_ptr() if mask is not None else 0
            a.num_keys = len(keys)
            a.bins = bins
            for k, ((codes, knulls), dom) in enumerate(zip(keys, domains)):
                a.key_codes[k] = codes.data_ptr()
                a.key_nulls[k] = knulls.data_ptr()
                a.key_domain[k] = dom
            a.num_inputs = len(chunk)
            for slot, j in enumerate(chunk):
                vals, nulls, want = inputs[j]
                nulls = nulls.contiguous() if nulls is not None else None
                if isinstance(vals, tuple):
                    vals = tuple(x.contiguous() for x in vals)
                    for q, x in enumerate(vals):
                        a.in_limbs[slot][q] = x.data_ptr()
                    a.in_values[slot] = 0
                    a.in_dtype[slot] = _DT_LIMBS
                else:
                    vals = vals.contiguous()
                    a.in_values[slot] = vals.data_ptr()
                    a.in_dtype[slot] = _DTYPE_CODES[vals.dtype]
                keep_alive.append((vals, nulls))
                a.in_nulls[slot] = nulls.data_ptr() if nulls is not None \
                    else 0
                a.in_want[slot] = want & ~WANT_MERGE128
            # a chunk's outputs are rows j0.. of the [inputs, bins] tensors
            j0 = chunk[0] if chunk else 0
            a.rows = rows.data_ptr()
            for name in ("cnt", "fsum", "isum", "mn", "mx"):
                t = out[name]
                setattr(a, name, t.data_ptr() + j0 * bins * t.element_size())
            a.lsum = out["lsum"].data_ptr() + j0 * 4 * bins * 8
            words = lib.direct_agg_scratch_words(ctypes.byref(a))
            scratch = torch.empty(words, dtype=torch.int64, device=dev)
            rc = lib.direct_agg(ctypes.byref(a),
                                ctypes.c_void_p(scratch.data_ptr()),
                                words, ctypes.c_void_p(stream))
            native.check(rc, "direct_agg", "direct_agg")
            direct_agg.launches += 1
            if any(inputs[j][2] & WANT_SUM128 for j in chunk):
                direct_agg.sum128_launches += 1
            if any(inputs[j][2] & WANT_MERGE128 for j in chunk):
                direct_agg.merge128_launches += 1
    return out


direct_agg.launches = 0
#: launches that summed 128-bit limbs (the DECIMAL(38) mode, merges too)
direct_agg.sum128_launches = 0
#: launches that merged DECIMAL(38) partial states (sum128_merge/avg128_merge)
direct_agg.merge128_launches = 0


# ---------------------------------------------------------------------------
# K12: hll_registers (approx_distinct)
# ---------------------------------------------------------------------------

_HLL_P = 11
_HLL_M = 1 << _HLL_P
_HLL_ALPHA = 0.7213 / (1.0 + 1.079 / _HLL_M)
#: K12's sorted mode by group length (csrc/hll.cu): a group of at most
#: HLL_SMALL_MAX rows takes one thread, one of at most HLL_PIECE rows one
#: warp, a longer one a block per piece of at least HLL_PIECE rows; the
#: tests size their groups by them
HLL_SMALL_MAX = 32
HLL_PIECE = 4096


def _hll_reg_rank(vals: torch.Tensor):
    """Per-row (register id int32, rank int32), as
    presto_tpu/ops/aggregate.py:_hll_reg_rank (:71): h = mix64(bits +
    GOLDEN) over the value's bits (integers sign-extended, floats through
    f64_hash_lanes), the register its low 11 bits, and the rank
    (64 - 11) - floor(log2(w)) of w = h >> 11, taken from the exponent of
    w rounded to float32, as the JAX function takes it (the rounding
    nudges the rank of about 2^-24 of the values; w == 0 ranks 54)."""
    from presto_tpu_torch.ops.keys import (
        _GOLDEN, _mix64, _srl, f64_hash_lanes,
    )
    if vals.is_floating_point():
        bits = f64_hash_lanes(vals.to(torch.float64))
    else:
        bits = vals.to(torch.int64)
    h = _mix64(bits + _GOLDEN)
    reg = (h & (_HLL_M - 1)).to(torch.int32)
    w = _srl(h, _HLL_P)
    _mant, exp = torch.frexp(w.to(torch.float32))
    rank = torch.where(w == 0, 64 - _HLL_P + 1,
                       (64 - _HLL_P) - (exp - 1)).to(torch.int32)
    return reg, rank


def _hll_estimate(present_sum: torch.Tensor,
                  zeros: torch.Tensor) -> torch.Tensor:
    """Registers -> cardinality, as presto_tpu/ops/aggregate.py
    :_hll_estimate (:99): the raw harmonic-mean estimate with the
    linear-counting small-range correction, in the same order of
    operations."""
    m = float(_HLL_M)
    zeros_f = zeros.to(torch.float64)
    # a Python number over a tensor is a product with torch's reciprocal
    # (rounded twice): divide tensor by tensor, as XLA divides
    num = torch.full_like(zeros_f, _HLL_ALPHA * m * m)
    raw = num / torch.clamp(present_sum + zeros_f, min=1e-12)
    small = m * torch.log(torch.full_like(zeros_f, m)
                          / torch.clamp(zeros_f, min=1.0))
    use_small = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_small, small, raw)


def _pow2_neg(r: torch.Tensor) -> torch.Tensor:
    """2.0 ** -r, exactly, for integer ranks 0 <= r <= 1022."""
    return ((1023 - r.to(torch.int64)) << 52).view(torch.float64)


def _hll_registers_plain(values, live, codes, bins, starts, ends):
    """Plain PyTorch version of the hll_registers kernel: the rows' (group,
    register, rank + 1) sorted by (group, register, rank descending), as
    the JAX package sorts them, so the first of each (group, register) run
    holds its register; present and count summed over those."""
    dev = values.device
    if codes is not None:
        groups = bins
        rows = torch.arange(values.shape[0], dtype=torch.int64, device=dev)
        gid = codes.to(torch.int64)
    else:
        n, groups = values.shape[0], starts.shape[0]
        s = starts.clamp(0, n)
        lengths = torch.maximum(ends.clamp(0, n), s) - s
        gid = torch.repeat_interleave(
            torch.arange(groups, dtype=torch.int64, device=dev), lengths)
        offsets = torch.cumsum(lengths, 0) - lengths
        rows = (torch.repeat_interleave(s - offsets, lengths)
                + torch.arange(gid.shape[0], dtype=torch.int64, device=dev))
    keep = live[rows]
    rows, gid = rows[keep], gid[keep]
    reg, rank = _hll_reg_rank(values[rows])
    slot = gid * _HLL_M + reg.to(torch.int64)
    v = rank.to(torch.int64) + 1                # 0 marks an empty register
    order = torch.sort(slot * 64 + (63 - v)).indices
    slot, v = slot[order], v[order]
    first = torch.ones_like(slot, dtype=torch.bool)
    first[1:] = slot[1:] != slot[:-1]
    slot, v = slot[first], v[first]
    g = slot // _HLL_M
    present = torch.zeros(groups, dtype=torch.float64, device=dev) \
        .index_add_(0, g, _pow2_neg(v - 1))
    count = torch.zeros(groups, dtype=torch.int64, device=dev) \
        .index_add_(0, g, torch.ones_like(g))
    regs = None
    if codes is not None:
        regs = torch.zeros(bins * _HLL_M, dtype=torch.int32, device=dev)
        regs[slot] = v.to(torch.int32)
        regs = regs.view(bins, _HLL_M)
    return present, count, regs


def hll_registers(values: torch.Tensor, live: torch.Tensor, *,
                  codes: Optional[torch.Tensor] = None,
                  bins: Optional[int] = None,
                  starts: Optional[torch.Tensor] = None,
                  ends: Optional[torch.Tensor] = None):
    """Per group the HyperLogLog registers of approx_distinct over the
    rows where `live` (kernel K12, csrc/hll.cu), and the two sums the
    estimate takes: present (float64, the sum of 2^-rank over the
    non-empty registers) and count (int64, the non-empty registers).
    Values are float64, int64 or int32; each row's register and rank are
    `_hll_reg_rank`'s.

    Direct mode (`codes`, `bins`): the group of row i is its bin codes[i]
    (int32 in [0, bins), bins <= 64). Returns (present [bins], count
    [bins], registers [bins, 2048] int32 holding rank + 1, 0 if empty).
    Sorted mode (`starts`, `ends`): group g is the row run [starts[g],
    ends[g]) (empty where ends <= starts; runs disjoint, as a group-sorted
    page gives them). Returns (present [G], count
    [G], None).

    On CPU tensors the plain version; on CUDA tensors the kernel."""
    direct = codes is not None
    if direct == (starts is not None) or (direct and bins is None) or (
            not direct and ends is None):
        raise ValueError("hll_registers: codes and bins, or starts and "
                         "ends")
    if values.dim() != 1 or values.dtype not in _DTYPE_CODES:
        raise TypeError(f"hll_registers: values must be 1-d float64, int64 "
                        f"or int32, got {values.dtype}")
    n, dev = values.shape[0], values.device
    if live.dtype != torch.bool or live.shape != (n,) or live.device != dev:
        raise TypeError("hll_registers: live must be bool like values")
    if direct:
        if not 1 <= bins <= _DIRECT_MAX_BINS or codes.dtype != torch.int32 \
                or codes.shape != (n,) or codes.device != dev:
            raise TypeError(f"hll_registers: codes must be int32 like "
                            f"values, 1 <= bins <= {_DIRECT_MAX_BINS}")
    elif starts.dtype != torch.int64 or ends.dtype != torch.int64 \
            or starts.shape != ends.shape or starts.dim() != 1 \
            or starts.device != dev or ends.device != dev:
        raise TypeError("hll_registers: starts/ends must be 1-d int64 of "
                        "one length, on values' device")
    if dev.type == "cpu":
        return _hll_registers_plain(values, live, codes, bins, starts, ends)
    if dev.type != "cuda":
        raise RuntimeError(f"hll_registers: no kernel for {dev}")
    from presto_tpu_torch import native
    values, live = values.contiguous(), live.contiguous()
    groups = bins if direct else starts.shape[0]
    present = torch.empty(groups, dtype=torch.float64, device=dev)
    count = torch.empty(groups, dtype=torch.int64, device=dev)
    lib = native.load("hll")
    # the cluster tables (direct) or the group lists, counters and piece
    # tables (sorted) of csrc/hll.cu
    scratch = torch.empty(lib.hll_scratch_words(n, bins if direct else 0),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if direct:
            codes = codes.contiguous()
            regs = torch.empty((bins, _HLL_M), dtype=torch.int32, device=dev)
            rc = lib.hll_direct(
                ctypes.c_void_p(values.data_ptr()),
                _DTYPE_CODES[values.dtype], ctypes.c_void_p(codes.data_ptr()),
                ctypes.c_void_p(live.data_ptr()), n, bins,
                ctypes.c_void_p(scratch.data_ptr()),
                ctypes.c_void_p(regs.data_ptr()),
                ctypes.c_void_p(present.data_ptr()),
                ctypes.c_void_p(count.data_ptr()), stream)
        else:
            regs = None
            starts, ends = starts.contiguous(), ends.contiguous()
            rc = lib.hll_sorted(
                ctypes.c_void_p(values.data_ptr()),
                _DTYPE_CODES[values.dtype], ctypes.c_void_p(live.data_ptr()),
                n, ctypes.c_void_p(starts.data_ptr()),
                ctypes.c_void_p(ends.data_ptr()), groups,
                ctypes.c_void_p(scratch.data_ptr()),
                ctypes.c_void_p(present.data_ptr()),
                ctypes.c_void_p(count.data_ptr()), stream)
    native.check(rc, "hll_registers", "hll")
    hll_registers.launches += 1
    return present, count, regs


hll_registers.launches = 0


# ---------------------------------------------------------------------------
# K13: segment_select (approx_percentile)
# ---------------------------------------------------------------------------

#: K13's schedule by group length (csrc/percentile.cu): a group run of at
#: most SELECT_WARP_MAX rows takes one warp; a longer one, and every bin of
#: the direct path, the device-wide sample select, whose candidate sets of
#: at most SELECT_BLOCK_MAX elements a block finishes; the tests size their
#: groups by them
SELECT_WARP_MAX = 1024
SELECT_BLOCK_MAX = 8192

_I64_MAX = torch.iinfo(torch.int64).max


def _select_keys(values: torch.Tensor) -> torch.Tensor:
    """int64 lane whose ascending order is K13's key order, the order of
    `_orderable_values`: integers as they are; float64 with subnormals
    and -0.0 as 0.0 and every NaN as one key above +inf, the IEEE bits
    flipped into signed integer order (the same on the CPU and the card,
    whatever the sort does with NaN payloads and signed zeros)."""
    if values.dtype != torch.float64:
        return values.to(torch.int64)
    from presto_tpu_torch.ops.keys import flush_subnormal
    v = flush_subnormal(values)
    bits = v.view(torch.int64)
    k = torch.where(bits < 0, bits ^ _I64_MAX, bits)
    k = torch.where(v == 0, 0, k)
    return torch.where(torch.isnan(values), _I64_MAX, k)


def _segment_pick_plain(values, starts, counts, p):
    """Over `values` sorted within each group, non-null values first, group
    g takes values[starts[g] + floor(p * max(counts[g] - 1, 0))] (in
    float64, clipped to the page), as presto_tpu/ops/aggregate.py
    :392-414 and :737-760 take it. Returns (picked, counts == 0)."""
    n = values.shape[0]
    idx = starts + torch.floor(
        p * torch.clamp(counts - 1, min=0).to(torch.float64)
    ).to(torch.int64)
    idx = idx.clamp(0, max(n - 1, 0))
    picked = values[idx] if n else torch.zeros(
        starts.shape[0], dtype=values.dtype, device=values.device)
    return picked, counts == 0


def _segment_select_plain(values, live, p, codes, bins, starts, ends):
    """Plain PyTorch version of the segment_select kernel: the live rows
    sorted stably by (group, key) with `lex_perm`, then
    `_segment_pick_plain`; 0 where a group is NULL."""
    from presto_tpu_torch.ops.keys import lex_perm
    dev = values.device
    if codes is not None:
        groups = bins
        rows = torch.arange(values.shape[0], dtype=torch.int64, device=dev)
        gid = codes.to(torch.int64)
        keep = live & (gid >= 0) & (gid < bins)
    else:
        n, groups = values.shape[0], starts.shape[0]
        s = starts.clamp(0, n)
        lengths = torch.maximum(ends.clamp(0, n), s) - s
        gid = torch.repeat_interleave(
            torch.arange(groups, dtype=torch.int64, device=dev), lengths)
        offsets = torch.cumsum(lengths, 0) - lengths
        rows = (torch.repeat_interleave(s - offsets, lengths)
                + torch.arange(gid.shape[0], dtype=torch.int64, device=dev))
        keep = live[rows]
    rows, gid = rows[keep], gid[keep]
    perm = lex_perm([gid, _select_keys(values[rows])])
    counts = torch.bincount(gid, minlength=groups)
    picked, null = _segment_pick_plain(values[rows][perm],
                                       torch.cumsum(counts, 0) - counts,
                                       counts, p)
    return torch.where(null, torch.zeros_like(picked), picked), null


def segment_select(values: torch.Tensor, live: torch.Tensor, p: float, *,
                   codes: Optional[torch.Tensor] = None,
                   bins: Optional[int] = None,
                   starts: Optional[torch.Tensor] = None,
                   ends: Optional[torch.Tensor] = None):
    """approx_percentile's order statistic per group, selected from the
    unsorted `values` (kernel K13, csrc/percentile.cu), as
    presto_tpu/ops/aggregate.py :392-414 and :737-760 sort and take it: for
    a group of n rows where `live`, the value of the row that a stable
    ascending sort by the orderable key (`_select_keys`) puts at position
    floor(p * max(n - 1, 0)), p clipped to [0, 1], in float64. Values are
    float64, int64 or int32.

    Direct mode (`codes`, `bins`): the group of row i is its bin codes[i]
    (int32 in [0, bins), bins <= 64). Sorted mode (`starts`, `ends`):
    group g is the row run [starts[g], ends[g]) (empty where ends <=
    starts; runs disjoint, as a group-sorted page gives them). Returns
    (picked [G] of values' dtype, 0 where NULL; null [G] bool: n == 0).

    On CPU tensors the plain version; on CUDA tensors the kernel."""
    direct = codes is not None
    if direct == (starts is not None) or (direct and bins is None) or (
            not direct and ends is None):
        raise ValueError("segment_select: codes and bins, or starts and "
                         "ends")
    if values.dim() != 1 or values.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_select: values must be 1-d float64, int64 "
                        f"or int32, got {values.dtype}")
    n, dev = values.shape[0], values.device
    if live.dtype != torch.bool or live.shape != (n,) or live.device != dev:
        raise TypeError("segment_select: live must be bool like values")
    if direct:
        if not 1 <= bins <= _DIRECT_MAX_BINS or codes.dtype != torch.int32 \
                or codes.shape != (n,) or codes.device != dev:
            raise TypeError(f"segment_select: codes must be int32 like "
                            f"values, 1 <= bins <= {_DIRECT_MAX_BINS}")
    elif starts.dtype != torch.int64 or ends.dtype != torch.int64 \
            or starts.shape != ends.shape or starts.dim() != 1 \
            or starts.device != dev or ends.device != dev:
        raise TypeError("segment_select: starts/ends must be 1-d int64 of "
                        "one length, on values' device")
    p = min(max(float(p), 0.0), 1.0)
    if dev.type == "cpu":
        return _segment_select_plain(values, live, p, codes, bins, starts,
                                     ends)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_select: no kernel for {dev}")
    if n >= 1 << 31:
        raise ValueError(f"segment_select: {n} rows >= 2^31")
    from presto_tpu_torch import native
    values, live = values.contiguous(), live.contiguous()
    groups = bins if direct else starts.shape[0]
    picked = torch.empty(groups, dtype=values.dtype, device=dev)
    nulls = torch.empty(groups, dtype=torch.bool, device=dev)
    lib = native.load("percentile")
    # group states, lists and the two candidate buffers of csrc/percentile.cu
    scratch = torch.empty(lib.segment_select_scratch_words(
        n, groups, bins if direct else 0), dtype=torch.int64, device=dev)
    if direct:
        codes = codes.contiguous()
    else:
        starts, ends = starts.contiguous(), ends.contiguous()

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        rc = lib.segment_select(
            ptr(values), _DTYPE_CODES[values.dtype], ptr(live), n,
            ptr(codes), bins if direct else 0, ptr(starts), ptr(ends),
            groups, p, ptr(scratch), ptr(picked), ptr(nulls), stream)
    native.check(rc, "segment_select", "percentile")
    segment_select.launches += 1
    return picked, nulls


segment_select.launches = 0


# ---------------------------------------------------------------------------
# the direct (small-domain) path
# ---------------------------------------------------------------------------

def _direct_domains(page: Page, group_fields: Sequence[int],
                    max_bins: int = _DIRECT_MAX_BINS):
    """Per-key domain sizes if the direct path applies, else None."""
    domains = []
    for f in group_fields:
        c = page.columns[f]
        if c.type.is_string and c.dictionary is not None:
            domains.append(len(c.dictionary))
        elif c.values.dtype == torch.bool:
            domains.append(2)
        else:
            return None
    prod = 1
    for d in domains:
        prod *= d + 1                      # +1: per-key NULL bin
        if prod > max_bins:
            return None
    return domains, prod


def _input_plan(page: Page, aggs: Sequence[AggSpec]):
    """Distinct kernel inputs of the aggregates. Returns the input list
    [(values, nulls, want)] and per aggregate its input slot (and for
    avg_final the slot of its count column)."""
    slots: Dict[tuple, int] = {}
    inputs: List[list] = []

    def slot(key, vals, nulls, want):
        j = slots.get(key)
        if j is None:
            j = slots[key] = len(inputs)
            inputs.append([_kernel_values(vals), nulls, 0])
        inputs[j][2] |= want
        return j

    per_agg = []
    for a in aggs:
        if a.kind == "count_star":
            per_agg.append((None, None))
            continue
        if a.kind in _MERGE_KINDS:
            # the partial states' limb lanes; avg128_merge also sums the
            # partial count column (presto_tpu/ops/aggregate.py:197-215)
            pc = page.columns[a.field]
            if not isinstance(pc, Decimal128Column):
                raise TypeError(f"{a.kind} over {type(pc).__name__}")
            j = slot(("merge", a.field), pc.value_lanes, pc.nulls,
                     WANT_SUM128 | WANT_MERGE128)
            j2 = None
            if a.kind == "avg128_merge":
                cc = page.columns[a.field2]
                j2 = slot(("count", a.field2), cc.values, cc.nulls, WANT_SUM)
            per_agg.append((j, j2))
            continue
        vals, nulls = _agg_inputs(a, page)
        wide = isinstance(vals, tuple)
        if wide and a.kind in ("min", "max"):
            per_agg.append((None, None))    # torch ops, not the kernel
            continue
        want = (WANT_SUM128 if a.kind in ("sum128", "avg128") else
                WANT_MINMAX if a.kind in ("min", "max", "bool_or",
                                          "bool_and") else
                0 if a.kind in ("count",) + _APPROX_KINDS else WANT_SUM)
        j = slot(("in", a.field, a.mask_field), vals, nulls, want)
        j2 = None
        if a.kind == "avg_final":
            c2 = page.columns[a.field2]
            j2 = slot(("count", a.field2), c2.values, c2.nulls, WANT_SUM)
        per_agg.append((j, j2))
    return [tuple(x) for x in inputs], per_agg


def _wide_minmax_direct(kind, lanes, live_rows, bin_code, prod: int):
    """min/max over DECIMAL(p>18) per bin (presto_tpu/ops/aggregate.py
    :317-340): each bin's live mask narrowed lane by lane over the
    normalized limbs, most significant first. Returns (the winner's four
    lanes, each [prod], and the live rows per bin)."""
    live = [live_rows & (bin_code == b) for b in range(prod)]
    n_per = torch.stack([lv.sum(dtype=torch.int64) for lv in live])
    big = torch.iinfo(torch.int64).max
    ident = big if kind == "min" else -big - 1
    wins = []
    for lane_v in I.normalize(lanes):
        w = torch.stack([
            torch.where(m, lane_v, ident).amin() if kind == "min"
            else torch.where(m, lane_v, ident).amax()
            for m in live])
        live = [m & (lane_v == w[b]) for b, m in enumerate(live)]
        wins.append(w)
    return wins, n_per


def _direct_grouped_aggregate(page: Page, group_fields: Sequence[int],
                              aggs: Sequence[AggSpec], out_cap: int,
                              row_mask: Optional[torch.Tensor], domains,
                              prod: int, min_groups: int = 0):
    dev = page.device
    keys = []
    for f in group_fields:
        c = page.columns[f]
        keys.append((c.values.to(torch.int32), c.nulls))
    inputs, per_agg = _input_plan(page, aggs)
    r = direct_agg(page.capacity, page.num_rows, keys, domains, inputs,
                   row_mask)
    counts = r["rows"]                                       # [prod]
    nonempty = counts > 0
    num_groups = torch.clamp(nonempty.sum(dtype=torch.int64),
                             min=min_groups)

    # Compact non-empty bins to the front; raw bin order == sorted key
    # order (sorted dictionaries), nulls last per key.
    arange_b = torch.arange(prod, dtype=torch.int64, device=dev)
    order_key = torch.where(nonempty, 0, prod) + arange_b
    bin_perm = torch.sort(order_key).indices                 # [prod] tiny
    width = min(out_cap, prod)
    take = bin_perm[:width]
    out_valid_w = torch.arange(width, dtype=torch.int64,
                               device=dev) < num_groups

    def widen(bins_arr, t: Type, nulls_w, dictionary=None):
        """Place per-bin results [prod] into an out_cap column."""
        dt = torch_dtype(t)
        v = bins_arr[take].to(dt)
        nl = nulls_w | ~out_valid_w
        sent = torch.tensor(t.null_sentinel(), dtype=dt, device=dev)
        v = torch.where(nl, sent, v)
        if width < out_cap:
            pad = out_cap - width
            v = torch.cat([v, sent.expand(pad)])
            nl = torch.cat([nl, torch.ones(pad, dtype=torch.bool,
                                           device=dev)])
        return Column(v, nl, t, dictionary)

    cols = []
    # Group keys: decode the mixed-radix bin index.
    stride = prod
    for f, dom in zip(group_fields, domains):
        c = page.columns[f]
        stride //= (dom + 1)
        key_code = (arange_b // stride) % (dom + 1)
        knull = key_code == dom
        cols.append(widen(torch.where(knull, 0, key_code), c.type,
                          knull[take], c.dictionary))

    def widen_wide(lane_bins, is_null_w, count_bins=None):
        """Place per-bin limb sums [4, prod] (and counts) into an out_cap
        Decimal128Column: NULL and padding rows hold zero lanes."""
        nl = is_null_w | ~out_valid_w
        pad = out_cap - width

        def lane(bins_arr):
            v = torch.where(nl, 0, bins_arr[take])
            return torch.cat([v, v.new_zeros(pad)]) if pad > 0 else v
        nulls = torch.cat([nl, nl.new_ones(pad)]) if pad > 0 else nl
        return Decimal128Column(
            *[lane(x) for x in lane_bins], nulls, t,
            None if count_bins is None else lane(count_bins))

    false_w = torch.zeros(width, dtype=torch.bool, device=dev)
    rows_bins = []

    def row_bins():
        """(valid rows under the fused mask, each row's bin code)"""
        if not rows_bins:
            valid = page.row_valid()
            if row_mask is not None:
                valid = valid & row_mask
            rows_bins.extend((valid, _bin_codes(keys, domains, page.capacity,
                                                dev)))
        return rows_bins

    for a, (j, j2) in zip(aggs, per_agg):
        t = a.output_type
        kind = a.kind
        if kind == "count_star":
            cols.append(widen(counts, t, false_w))
            continue
        if kind in _APPROX_KINDS:
            valid, bin_code = row_bins()
            vals, nulls = _agg_inputs(a, page)
            live = valid & ~nulls
            n_per = r["cnt"][j]
            if kind == "approx_distinct":
                # presto_tpu/ops/aggregate.py:368-391: never NULL, 0 for a
                # bin without a live row
                present, regs_on, _ = hll_registers(
                    _kernel_values(vals), live, codes=bin_code, bins=prod)
                est = _hll_estimate(present, _HLL_M - regs_on)
                cols.append(widen(torch.where(n_per == 0, 0.0,
                                              torch.round(est)),
                                  t, false_w))
                continue
            # approx_percentile (:392-414): K13 selects each bin's order
            # statistic from the unsorted values
            dictionary = page.columns[a.field].dictionary if t.is_string \
                else None
            picked, pnull = segment_select(
                _kernel_values(vals), live,
                0.5 if a.param is None else a.param, codes=bin_code,
                bins=prod)
            cols.append(widen(picked, t, pnull[take], dictionary))
            continue
        if j is None:
            valid, bin_code = row_bins()
            lanes, nulls = _agg_inputs(a, page)
            wins, n_per = _wide_minmax_direct(kind, lanes, valid & ~nulls,
                                              bin_code, prod)
            cols.append(widen_wide(wins, (n_per == 0)[take]))
            continue
        n_per = r["cnt"][j]
        if kind in _MERGE_KINDS:
            # a bin without a live partial state is NULL; the count sum
            # is zero where the merge is NULL
            cols.append(widen_wide(r["lsum"][j], (n_per == 0)[take],
                                   r["isum"][j2] if kind == "avg128_merge"
                                   else None))
            continue
        if kind in ("sum128", "avg128"):
            # four limb sums per bin; the exact value recombines on the
            # host (Decimal128Column.value_at)
            cols.append(widen_wide(r["lsum"][j], (n_per == 0)[take],
                                   n_per if kind == "avg128" else None))
            continue
        in_vals = inputs[j][0]
        is_f = not isinstance(in_vals, tuple) and \
            in_vals.dtype == torch.float64
        if kind == "count":
            cols.append(widen(n_per, t, false_w))
        elif kind in ("sum", "avg", "avg_partial", "avg_final"):
            acc_f = t.is_floating or kind != "sum"
            s = r["fsum"][j] if (acc_f or is_f) else r["isum"][j]
            if not acc_f and not is_f:
                # checked SUM: an int64 total that wrapped is ~2^64 away
                # from the float64 shadow sum
                from presto_tpu_torch.expr import errors as E
                code = E.OVF_DECIMAL if t.is_decimal else E.OVF_SUM
                E.record(code, torch.any(
                    torch.abs(r["fsum"][j] - s.to(torch.float64))
                    > 2.0 ** 62))
            if kind == "avg_final":
                n2 = r["isum"][j2] if inputs[j2][0].dtype != torch.float64 \
                    else r["fsum"][j2]
                cols.append(widen(s / torch.clamp(n2, min=1), t,
                                  (n2 == 0)[take]))
            elif kind == "sum":
                cols.append(widen(s, t, (n_per == 0)[take]))
            elif kind == "avg":
                cols.append(widen(s / torch.clamp(n_per, min=1), t,
                                  (n_per == 0)[take]))
            else:  # avg_partial -> (sum double, count bigint)
                cols.append(widen(s, DOUBLE, (n_per == 0)[take]))
                cols.append(widen(n_per, BIGINT, false_w))
        else:   # min, max, bool_or, bool_and
            use_min = kind in ("min", "bool_and")
            w = r["mn"][j] if use_min else r["mx"][j]
            w = w.view(torch.float64) if is_f else w
            if kind in ("bool_or", "bool_and"):
                w = w != 0
            dictionary = (page.columns[a.field].dictionary
                          if t.is_string else None)
            cols.append(widen(w, t, (n_per == 0)[take], dictionary))

    out_rows = torch.clamp(num_groups, max=out_cap)
    return Page(tuple(cols), out_rows, ()), num_groups


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def grouped_aggregate(page: Page, group_fields: Sequence[int],
                      aggs: Sequence[AggSpec],
                      out_capacity: Optional[int] = None,
                      row_mask: Optional[torch.Tensor] = None,
                      direct_max_bins: int = _DIRECT_MAX_BINS):
    """Group `page` by `group_fields` and evaluate `aggs`. Output columns:
    group keys (in order) then one column per agg (avg_partial emits two).
    With no group fields, emits exactly one row (SQL global aggregation).
    `row_mask` pre-filters rows without a compaction pass (the fused
    ScanFilterAndProject -> Aggregation pipeline).

    Returns (page, true_group_count): true_group_count is a 0-d device
    tensor, unclamped, so the caller can detect out_capacity overflow."""
    _check_kinds(aggs)
    out_cap = out_capacity or page.capacity
    if not group_fields:
        return _direct_grouped_aggregate(page, (), aggs, out_cap, row_mask,
                                         [], 1, min_groups=1)
    # grouped merges of DECIMAL(38) partial states: sorted path only
    merge128 = any(a.kind in _MERGE_KINDS for a in aggs)
    d = None if merge128 else _direct_domains(page, group_fields,
                                              direct_max_bins)
    if d is not None:
        domains, prod = d
        return _direct_grouped_aggregate(page, group_fields, aggs, out_cap,
                                         row_mask, domains, prod)
    valid = page.row_valid()
    if row_mask is not None:
        valid = valid & row_mask
    return _sorted_grouped_aggregate(page, group_fields, aggs, out_cap,
                                     valid)


# ---------------------------------------------------------------------------
# the sorted (large-domain) path
# ---------------------------------------------------------------------------

def _wide_minmax_sorted(kind, lanes, nulls, flags, gvalid, starts, n,
                        out_valid, t) -> Decimal128Column:
    """min/max over DECIMAL(p>18) segments (presto_tpu/ops/aggregate.py
    :655-677): sort the rows by (group, NULL last, normalized limbs) and
    take each group's first row; lexicographic limb order is exact value
    order, and max sorts the negated value."""
    from presto_tpu_torch.ops.keys import lex_perm
    norm = I.normalize(lanes)
    if kind == "max":
        norm = I.normalize(I.negate(norm))
    gid = torch.cumsum((flags & gvalid).to(torch.int64), 0)
    perm = lex_perm([gid, nulls.to(torch.int8), *norm])
    idx = perm[starts.clamp(0, perm.shape[0] - 1)]
    win = [x[idx] for x in norm]
    if kind == "max":
        win = list(I.negate(tuple(win)))
    is_null = nulls[idx] | (n == 0) | ~out_valid
    return Decimal128Column(*[torch.where(is_null, 0, w) for w in win],
                            is_null, t)


def _sorted_grouped_aggregate(page: Page, group_fields: Sequence[int],
                              aggs: Sequence[AggSpec], out_cap: int,
                              valid: torch.Tensor):
    """Sort a permutation by the group key lanes, gather the page by it,
    find the group starts and reduce each contiguous group segment."""
    from presto_tpu_torch.data.column import gather_page
    from presto_tpu_torch.ops import scan as pscan
    from presto_tpu_torch.ops.keys import (
        group_values, lex_perm, new_group_flags,
    )

    cap = page.capacity
    dev = page.device

    # Sort lanes: invalid rows last, then per group field (nulls last,
    # group-canonical value). The invalid rank folds into the FIRST
    # field's null rank (invalid > null > value).
    inv_rank = (~valid).to(torch.int8)
    lanes = []
    for i, f in enumerate(group_fields):
        c = page.columns[f]
        nrank = c.nulls.to(torch.int8)
        lanes.append(inv_rank * 2 + nrank if i == 0 else nrank)
        lanes.append(group_values(c))
    perm = lex_perm(lanes)
    gvalid = valid[perm]
    sp = gather_page(page, perm)

    flags = new_group_flags(sp, group_fields)
    starts, num_groups = pscan.group_starts(flags, gvalid, out_cap)
    total_valid = gvalid.sum(dtype=torch.int64)
    g_arange = torch.arange(out_cap, dtype=torch.int64, device=dev)
    out_valid = g_arange < torch.clamp(num_groups, max=out_cap)
    nxt = torch.cat([starts[1:], torch.full((1,), cap, dtype=torch.int64,
                                            device=dev)])
    ends = torch.where(g_arange + 1 < num_groups, nxt, total_valid)
    ends = torch.where(out_valid, ends, starts)        # empty for overflow

    cols = []
    for f in group_fields:
        cols.append(sp.columns[f].gather(starts, out_valid))
    reduced: Dict[tuple, dict] = {}
    for a in aggs:
        cols.extend(_eval_agg_sorted(a, sp, gvalid, flags, starts, ends,
                                     out_valid, reduced))
    return Page(tuple(cols), torch.clamp(num_groups, max=out_cap), ()), \
        num_groups


def _eval_agg_sorted(a: AggSpec, sp: Page, gvalid, flags, starts, ends,
                     out_valid, reduced: Dict[tuple, dict]):
    """Evaluate one aggregate over contiguous sorted segments (`flags`:
    the sorted rows' new-group flags). `reduced` memoizes segment
    reductions per input within one aggregation."""
    from presto_tpu_torch.ops import scan as pscan

    t = a.output_type
    kind = a.kind
    if kind in _MERGE_KINDS:
        # presto_tpu/ops/aggregate.py:556-575: each group run's partial
        # limb lanes summed (K3's merge mode, one launch with the count
        # column's sum for avg128_merge); NULL where no state is live
        pc = sp.columns[a.field]
        if not isinstance(pc, Decimal128Column):
            raise TypeError(f"{kind} over {type(pc).__name__}")
        cvals = clive = None
        if kind == "avg128_merge":
            cc = sp.columns[a.field2]
            cvals, clive = cc.values.to(torch.int64), ~cc.nulls & gvalid
        r = pscan.segment_merge128(pc.value_lanes, ~pc.nulls & gvalid,
                                   starts, ends, cvals, clive)
        is_null = (r["cnt"] == 0) | ~out_valid
        return [Decimal128Column(
            *[torch.where(is_null, 0, x) for x in r["lsum"]], is_null, t,
            count=r.get("csum"))]
    vals, nulls = _agg_inputs(a, sp)
    nulls = nulls | ~gvalid
    dictionary = (sp.columns[a.field].dictionary
                  if a.field is not None and t.is_string else None)

    def out(values, nullmask):
        dt = torch_dtype(t)
        nl = nullmask | ~out_valid
        sent = torch.tensor(t.null_sentinel(), dtype=dt,
                            device=values.device)
        return Column(torch.where(nl, sent, values.to(dt)), nl, t,
                      dictionary)

    def seg(key, v, live, want):
        got = reduced.get(key)
        if got is None or (got["want"] & want) != want:
            want = want | (got["want"] if got else 0)
            got = pscan.segment_reduce(_kernel_values(v), live, starts,
                                       ends, want)
            got["want"] = want
            reduced[key] = got
        return got

    zeros = torch.zeros_like(out_valid)
    if kind == "count_star":
        return [out(ends - starts, zeros)]
    key = ("in", a.field, a.mask_field)
    wide = isinstance(vals, tuple)
    if kind == "count":
        return [out(seg(key, vals[3] if wide else vals, ~nulls, 0)["cnt"],
                    zeros)]
    if kind == "approx_distinct":
        # presto_tpu/ops/aggregate.py:710-735: K12 over the page's group
        # runs (no re-sort); 0 for a group without a live row (whose
        # registers are all empty: a live row fills one), never NULL
        present, regs_on, _ = hll_registers(_kernel_values(vals), ~nulls,
                                            starts=starts, ends=ends)
        est = _hll_estimate(present, _HLL_M - regs_on)
        return [out(torch.where(regs_on == 0, 0.0, torch.round(est)),
                    zeros)]
    if kind == "approx_percentile":
        # :737-760: K13 selects each group run's order statistic from the
        # unsorted values (NULL and padding rows are not live)
        picked, pnull = segment_select(
            _kernel_values(vals), ~nulls,
            0.5 if a.param is None else a.param, starts=starts, ends=ends)
        return [out(picked, pnull)]
    if kind in ("sum128", "avg128"):
        # DECIMAL(38): four limb sums per segment (K3's 128-bit mode);
        # the exact value recombines on the host
        r = seg(("in128", a.field, a.mask_field), vals, ~nulls, WANT_SUM128)
        n = r["cnt"]
        is_null = (n == 0) | ~out_valid
        return [Decimal128Column(
            *[torch.where(is_null, 0, x) for x in r["lsum"]], is_null, t,
            count=n if kind == "avg128" else None)]
    if wide:    # min/max over DECIMAL(p>18)
        return [_wide_minmax_sorted(kind, vals, nulls, flags, gvalid, starts,
                                    seg(key, vals[3], ~nulls, 0)["cnt"],
                                    out_valid, t)]
    if kind in ("sum", "avg", "avg_partial"):
        acc_f = t.is_floating or kind != "sum"
        r = seg(key, vals, ~nulls, WANT_SUM)
        n = r["cnt"]
        is_f = "isum" not in r
        s = r["fsum"] if (acc_f or is_f) else r["isum"]
        if not acc_f and not is_f:
            from presto_tpu_torch.expr import errors as E
            E.record(E.OVF_DECIMAL if t.is_decimal else E.OVF_SUM,
                     torch.any(torch.abs(r["fsum"] - s.to(torch.float64))
                               > 2.0 ** 62))
        if kind == "sum":
            return [out(s, n == 0)]
        if kind == "avg":
            return [out(s / torch.clamp(n, min=1), n == 0)]
        sum_col = Column(torch.where(n == 0, float("inf"),
                                     s.to(torch.float64)), n == 0, DOUBLE)
        cnt_col = Column(n, torch.zeros_like(n, dtype=torch.bool), BIGINT)
        return [sum_col, cnt_col]
    if kind == "avg_final":
        s = seg(key, vals, ~nulls, WANT_SUM)["fsum"]
        cnt_col = sp.columns[a.field2]
        cvals = torch.where(cnt_col.nulls | ~gvalid, 0,
                            cnt_col.values).to(torch.int64)
        n = seg(("count", a.field2), cvals, None, WANT_SUM)["isum"]
        return [out(s / torch.clamp(n, min=1), n == 0)]
    # min, max, bool_or, bool_and
    r = seg(key, vals, ~nulls, WANT_MINMAX)
    n = r["cnt"]
    use_min = kind in ("min", "bool_and")
    w = r["min"] if use_min else r["max"]
    if kind in ("bool_or", "bool_and"):
        w = w != 0
    return [out(w, n == 0)]
