"""Scan and segment primitives.

The port's twin of presto_tpu/ops/scan.py.

- `segment_sums` (:160) and `group_starts` (:177), for the aggregation
  path: the JAX package reduces contiguous segments as differences of one
  blocked running sum; here the hand-written `segment_reduce` kernel
  (csrc/segment_reduce.cu, K3) sums each segment directly, and dense group
  starts are a stable compaction of the flag positions (`compact_indices`,
  K2).
- `cumsum` (:36), `blocked_cummax` (:61), `fill_forward` (:84),
  `seg_scan` (:104) and `fill_backward` (:153), for windows, with the JAX
  functions' signatures. The JAX versions are blocked Hillis-Steele
  doublings, a workaround for TPU compile times; here each is one call of
  `segmented_scan`, an inclusive (optionally segmented, optionally
  reversed) scan that launches the hand-written kernel K7
  (csrc/seg_scan.cu) on CUDA tensors and runs its plain PyTorch version on
  CPU tensors.
- `segment_merge128`, the final merge of DECIMAL(38) partial states per
  group run (sum128_merge/avg128_merge of presto_tpu/ops/aggregate.py
  :556-575): K3's merge mode, limb sums, live states and the count
  column's sum in one launch.
- `window_bounds`, a sorted window's partition and peer start and end
  positions (the four fills of presto_tpu/ops/window.py:197-204) in one
  launch of K7's bounds kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from presto_tpu_torch.data.column import compact_indices

WANT_SUM = 1
WANT_MINMAX = 2
WANT_SUM128 = 4

_DTYPE_CODES = {torch.float64: 0, torch.int64: 1, torch.int32: 2}
_DT_LIMBS = 3


def _segment_reduce_plain(values, live, starts, ends, want):
    """Plain PyTorch version of the segment_reduce kernel: rows are
    labelled with their segment and reduced with index_add_/scatter_reduce
    in row order."""
    wide = isinstance(values, tuple)
    ref = values[0] if wide else values
    n = ref.shape[0]
    g = starts.shape[0]
    dev = ref.device
    s = starts.clamp(0, n)
    e = torch.maximum(ends.clamp(0, n), s)
    lengths = e - s
    seg = torch.repeat_interleave(
        torch.arange(g, dtype=torch.int64, device=dev), lengths)
    offsets = torch.cumsum(lengths, 0) - lengths
    rows = (torch.repeat_interleave(s, lengths)
            + torch.arange(seg.shape[0], dtype=torch.int64, device=dev)
            - torch.repeat_interleave(offsets, lengths))
    keep = (live[rows] if live is not None
            else torch.ones(rows.shape[0], dtype=torch.bool, device=dev))
    out = {"cnt": torch.zeros(g, dtype=torch.int64, device=dev)
           .index_add_(0, seg, keep.to(torch.int64))}
    if want & WANT_SUM128:
        from presto_tpu_torch.data.int128 import from_int64
        lanes = values if wide else from_int64(values)
        out["lsum"] = torch.stack([
            torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
                0, seg, torch.where(keep, x[rows], 0)) for x in lanes])
        return out
    v = values[rows]
    is_f = values.dtype == torch.float64
    if want & WANT_SUM:
        fv = torch.where(keep, v.to(torch.float64), 0.0)
        out["fsum"] = torch.zeros(g, dtype=torch.float64, device=dev) \
            .index_add_(0, seg, fv)
        if not is_f:
            out["isum"] = torch.zeros(g, dtype=torch.int64, device=dev) \
                .index_add_(0, seg, torch.where(keep, v.to(torch.int64), 0))
    if want & WANT_MINMAX:
        if is_f:
            # NaN sorts last: it wins only where nothing else is there
            nan = torch.isnan(v)
            real = keep & ~nan
            lo = torch.full((g,), float("inf"), dtype=torch.float64,
                            device=dev).scatter_reduce_(
                0, seg, torch.where(real, v, float("inf")), "amin")
            hi = torch.full((g,), float("-inf"), dtype=torch.float64,
                            device=dev).scatter_reduce_(
                0, seg, torch.where(real, v, float("-inf")), "amax")
            n_real = torch.zeros(g, dtype=torch.int64, device=dev) \
                .index_add_(0, seg, real.to(torch.int64))
            only_nan = n_real == 0
            out["min"] = torch.where(only_nan, float("nan"), lo)
            out["max"] = torch.where(only_nan, float("nan"), hi)
        else:
            big = torch.iinfo(torch.int64).max
            v64 = v.to(torch.int64)
            out["min"] = torch.full((g,), big, dtype=torch.int64,
                                    device=dev).scatter_reduce_(
                0, seg, torch.where(keep, v64, big), "amin")
            out["max"] = torch.full((g,), -big - 1, dtype=torch.int64,
                                    device=dev).scatter_reduce_(
                0, seg, torch.where(keep, v64, -big - 1), "amax")
    return out


def segment_reduce(values: torch.Tensor, live: Optional[torch.Tensor],
                   starts: torch.Tensor, ends: torch.Tensor,
                   want: int = WANT_SUM) -> dict:
    """Per-segment reductions over contiguous [starts[g], ends[g]) row
    ranges (kernel K3, csrc/segment_reduce.cu). A row counts only where
    `live` is True (every row when live is None).

    Returns a dict of [G] tensors: "cnt" (int64, live rows) always; with
    WANT_SUM "fsum" (float64 sum) and, for integer values, "isum" (int64
    sum, wrapping); with WANT_MINMAX "min"/"max" (float64 for float64
    values, else int64; NaN sorts last). Values are float64, int64 or
    int32. The 128-bit sum mode, want == WANT_SUM128, takes int64/int32
    values or four int64 limb lanes (l3, l2, l1, l0) and returns "cnt" and
    "lsum" [4, G], the wrapping int64 sums of each limb lane (integer
    values decompose as int128.from_int64). On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel. For disjoint
    ranges, as the sorted aggregation gives, the kernel's "fsum" is bit
    for bit the same from run to run; overlapping ranges are supported
    but neither deterministic nor fast (csrc/segment_reduce.cu)."""
    wide = isinstance(values, tuple)
    if want & WANT_SUM128 and want != WANT_SUM128:
        raise ValueError("segment_reduce: the 128-bit sum mode is alone")
    if wide:
        if len(values) != 4 or want != WANT_SUM128 or any(
                x.dtype != torch.int64 or x.shape != values[0].shape
                or x.dim() != 1 or x.device != values[0].device
                for x in values):
            raise TypeError("segment_reduce: limb values are four 1-d int64 "
                            "lanes, in the 128-bit sum mode")
    elif values.dim() != 1 or values.dtype not in _DTYPE_CODES or (
            want & WANT_SUM128 and values.dtype == torch.float64):
        raise TypeError(f"segment_reduce: values must be 1-d float64, int64 "
                        f"or int32, got {values.dtype}")
    ref = values[0] if wide else values
    if starts.dtype != torch.int64 or ends.dtype != torch.int64 \
            or starts.shape != ends.shape or starts.dim() != 1:
        raise TypeError("segment_reduce: starts/ends must be 1-d int64 of "
                        "one length")
    if live is not None and (live.dtype != torch.bool
                             or live.shape != ref.shape):
        raise TypeError("segment_reduce: live must be bool like values")
    dev = ref.device
    for t in (starts, ends) + ((live,) if live is not None else ()):
        if t.device != dev:
            raise ValueError("segment_reduce: tensors on different devices")
    if dev.type == "cpu":
        return _segment_reduce_plain(values, live, starts, ends, want)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_reduce: no kernel for {dev}")
    from presto_tpu_torch import native
    live = live.contiguous() if live is not None else None
    starts, ends = starts.contiguous(), ends.contiguous()
    g = starts.shape[0]
    if want == WANT_SUM128:
        return _segment_sum128(values, live, starts, ends)
    values = values.contiguous()
    is_f = values.dtype == torch.float64
    out = {"cnt": torch.empty(g, dtype=torch.int64, device=dev)}
    if want & WANT_SUM:
        out["fsum"] = torch.empty(g, dtype=torch.float64, device=dev)
        if not is_f:
            out["isum"] = torch.empty(g, dtype=torch.int64, device=dev)
    if want & WANT_MINMAX:
        mm = torch.float64 if is_f else torch.int64
        out["min"] = torch.empty(g, dtype=mm, device=dev)
        out["max"] = torch.empty(g, dtype=mm, device=dev)

    def ptr(key):
        return ctypes.c_void_p(out[key].data_ptr() if key in out else 0)

    lib = native.load("segment_reduce")
    scratch = torch.empty(
        lib.segment_reduce_scratch_words(values.shape[0], g),
        dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segment_reduce(
            ctypes.c_void_p(values.data_ptr()),
            _DTYPE_CODES[values.dtype], want,
            ctypes.c_void_p(live.data_ptr() if live is not None else 0),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(ends.data_ptr()), g, values.shape[0],
            ptr("cnt"), ptr("fsum"), ptr("isum"), ptr("min"), ptr("max"),
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "segment_reduce", "segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
#: launches of the 128-bit sum mode (the DECIMAL(38) kinds)
segment_reduce.sum128_launches = 0
#: launches of the merge mode (sum128_merge/avg128_merge, segment_merge128)
segment_reduce.merge128_launches = 0


def _segment_sum128(values, live, starts, ends) -> dict:
    """Launch K3's 128-bit sum mode (csrc/segment_reduce.cu
    segment_sum128) on CUDA tensors."""
    from presto_tpu_torch import native
    wide = isinstance(values, tuple)
    lanes = [x.contiguous() for x in values] if wide \
        else [values.contiguous()]
    dev, n, g = lanes[0].device, lanes[0].shape[0], starts.shape[0]
    out = {"cnt": torch.empty(g, dtype=torch.int64, device=dev),
           "lsum": torch.empty((4, g), dtype=torch.int64, device=dev)}
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in lanes]
    ptrs += [ctypes.c_void_p(0)] * (4 - len(ptrs))
    lib = native.load("segment_reduce")
    scratch = torch.empty(lib.segment_reduce_scratch_words(n, g),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segment_sum128(
            *ptrs, _DT_LIMBS if wide else _DTYPE_CODES[lanes[0].dtype],
            ctypes.c_void_p(live.data_ptr() if live is not None else 0),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(ends.data_ptr()), g, n,
            ctypes.c_void_p(out["cnt"].data_ptr()),
            ctypes.c_void_p(out["lsum"].data_ptr()),
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "segment_sum128", "segment_reduce")
    segment_reduce.launches += 1
    segment_reduce.sum128_launches += 1
    return out


def _segment_merge128_plain(lanes, live, starts, ends, count_values=None,
                            count_live=None) -> dict:
    """Plain PyTorch version of K3's merge mode: the JAX function's
    segment sums of the live states' lanes, of the live states and of the
    count column (presto_tpu/ops/aggregate.py:556-575)."""
    out = _segment_reduce_plain(tuple(lanes), live, starts, ends,
                                WANT_SUM128)
    if count_values is not None:
        out["csum"] = _segment_reduce_plain(
            count_values, count_live, starts, ends, WANT_SUM)["isum"]
    return out


def segment_merge128(lanes, live: torch.Tensor, starts: torch.Tensor,
                     ends: torch.Tensor,
                     count_values: Optional[torch.Tensor] = None,
                     count_live: Optional[torch.Tensor] = None) -> dict:
    """Merge DECIMAL(38) partial states over contiguous [starts[g],
    ends[g]) row runs (K3's merge mode, csrc/segment_reduce.cu
    segment_merge128). `lanes` are the states' four int64 limb lanes
    (l3, l2, l1, l0), any int64 values; a state counts where `live`.
    With `count_values` (int64, avg128_merge's partial counts) a row's
    count adds where `count_live`, apart from `live`.

    Returns "cnt" [G] (live states), "lsum" [4, G] (wrapping int64 sums of
    each lane) and, with count_values, "csum" [G] (wrapping int64 sum).
    On CPU tensors this is the plain version, as the JAX function takes
    it; on CUDA tensors it launches the kernel once."""
    if len(lanes) != 4 or any(
            x.dtype != torch.int64 or x.dim() != 1
            or x.shape != lanes[0].shape or x.device != lanes[0].device
            for x in lanes):
        raise TypeError("segment_merge128: four 1-d int64 limb lanes")
    n, dev = lanes[0].shape[0], lanes[0].device
    if live.dtype != torch.bool or live.shape != (n,):
        raise TypeError("segment_merge128: live must be bool like the lanes")
    if (count_values is None) != (count_live is None):
        raise ValueError("segment_merge128: count_values and count_live "
                         "go together")
    if count_values is not None and (
            count_values.dtype != torch.int64 or count_values.shape != (n,)
            or count_live.dtype != torch.bool or count_live.shape != (n,)):
        raise TypeError("segment_merge128: count_values int64 and "
                        "count_live bool, like the lanes")
    if starts.dtype != torch.int64 or ends.dtype != torch.int64 \
            or starts.shape != ends.shape or starts.dim() != 1:
        raise TypeError("segment_merge128: starts/ends must be 1-d int64 "
                        "of one length")
    extra = (count_values, count_live) if count_values is not None else ()
    for t in (live, starts, ends) + extra:
        if t.device != dev:
            raise ValueError("segment_merge128: tensors on different "
                             "devices")
    if dev.type == "cpu":
        return _segment_merge128_plain(lanes, live, starts, ends,
                                       count_values, count_live)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_merge128: no kernel for {dev}")
    from presto_tpu_torch import native
    g = starts.shape[0]
    lanes = [x.contiguous() for x in lanes]
    live, starts, ends = live.contiguous(), starts.contiguous(), \
        ends.contiguous()
    out = {"cnt": torch.empty(g, dtype=torch.int64, device=dev),
           "lsum": torch.empty((4, g), dtype=torch.int64, device=dev)}
    if count_values is not None:
        count_values = count_values.contiguous()
        count_live = count_live.contiguous()
        out["csum"] = torch.empty(g, dtype=torch.int64, device=dev)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = native.load("segment_reduce")
    scratch = torch.empty(lib.segment_reduce_scratch_words(n, g),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segment_merge128(
            *[ptr(x) for x in lanes], ptr(live), ptr(count_values),
            ptr(count_live), ptr(starts), ptr(ends), g, n, ptr(out["cnt"]),
            ptr(out["lsum"]), ptr(out.get("csum")), ptr(scratch),
            ctypes.c_void_p(stream))
    native.check(rc, "segment_merge128", "segment_reduce")
    segment_reduce.launches += 1
    segment_reduce.merge128_launches += 1
    return out


def segment_sums(vals: torch.Tensor, starts: torch.Tensor,
                 ends: torch.Tensor) -> torch.Tensor:
    """Per-segment sums over *contiguous* segments (rows pre-sorted by
    group); starts/ends are [G] row ranges (end exclusive). float64 for
    float values, int64 otherwise, 0 for empty segments."""
    if vals.is_floating_point():
        r = segment_reduce(vals.to(torch.float64), None, starts, ends)
        return r["fsum"]
    if vals.dtype == torch.bool or vals.dtype not in _DTYPE_CODES:
        vals = vals.to(torch.int64)
    return segment_reduce(vals, None, starts, ends)["isum"]


def group_starts(flags: torch.Tensor, gvalid: torch.Tensor, out_cap: int):
    """Given sorted new-group flags + per-row validity, return
    (starts[out_cap], groups), where starts[g] is the first row of group g
    and `groups` (0-d, on the device) counts the groups of valid rows.
    Positions past the group count hold the non-start rows in order, then
    `cap` where the page is shorter than out_cap (as in the JAX
    package)."""
    cap = flags.shape[0]
    perm, groups = compact_indices(flags & gvalid)
    starts = perm[:out_cap]
    if cap < out_cap:
        starts = torch.cat([starts, torch.full(
            (out_cap - cap,), cap, dtype=torch.int64, device=flags.device)])
    return starts, groups


# ---------------------------------------------------------------------------
# K7 segmented_scan and the window scan primitives
# ---------------------------------------------------------------------------

#: segmented_scan operators, by their code in csrc/seg_scan.cu
SCAN_OPS = {"add": 0, "min": 1, "max": 2, "last": 3}

#: value dtypes of segmented_scan, by their code in csrc/seg_scan.cu
SCAN_DTYPES = {torch.float64: 0, torch.int64: 1, torch.int32: 2}

#: segmented_scan's launch counts by kind, in this order: add, min/max,
#: last, and window_bounds (one launch for a window's four "last" scans)
SCAN_KINDS = ("add", "minmax", "last", "bounds")


def _fold(op: str):
    """The elementwise combine of a scan operator (NaN-propagating
    min/max, as jnp.minimum/jnp.maximum)."""
    if op == "add":
        return torch.add
    if op == "min":
        return torch.minimum
    if op == "max":
        return torch.maximum
    # "last": the later present position wins
    return lambda a, b: torch.where(b >= 0, b, a)


def _segmented_scan_plain(x: torch.Tensor, op: str, reverse: bool,
                          seg_start: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the segmented_scan kernel: torch.cumsum
    for an unsegmented add, torch.cummax for an unsegmented "last", and
    otherwise Hillis-Steele doubling (log2 n passes; a segmented sum
    restarts at each segment start, so an infinity stays in its segment).
    Integer results and min/max are exact; float sums may differ from the
    kernel's in the last bits (another summation order)."""
    n = x.shape[0]
    dev = x.device
    if op == "last":
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        v = torch.where(x, idx, -1)
    else:
        v = x
    flags = seg_start
    if reverse:
        v = torch.flip(v, (0,))
        flags = torch.flip(flags, (0,)) if flags is not None else None
    if flags is None and op == "add":
        out = torch.cumsum(v, 0, dtype=v.dtype)
    elif flags is None and op == "last" and not reverse:
        out = torch.cummax(v, 0).values
    else:
        fold = _fold(op)
        out = v
        f = (flags.clone() if flags is not None
             else torch.zeros(n, dtype=torch.bool, device=dev))
        has = torch.arange(n, device=dev)
        d = 1
        while d < n:
            sh_v = torch.cat([out[:d], out[:-d]])    # slots < d unused
            sh_f = torch.cat([torch.zeros(d, dtype=torch.bool, device=dev),
                              f[:-d]])
            out = torch.where(f | (has < d), out, fold(sh_v, out))
            f = f | sh_f
            d *= 2
    if reverse:
        out = torch.flip(out, (0,))
    return out


def segmented_scan(x: torch.Tensor, op: str, reverse: bool = False,
                   seg_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inclusive scan of `x` under `op` (kernel K7, csrc/seg_scan.cu).

    - op "add", "min" or "max" over float64, int64 or int32 values: out[i]
      folds x over [start of i's segment, i] in scan order, in x's dtype
      (integer sums wrap; min and max propagate NaN, as jnp.minimum);
    - op "last" over a bool `present` array: out[i] (int64) is the last
      present position at or before i in scan order (forward: the largest
      j <= i; reverse: the smallest j >= i), -1 where there is none in i's
      segment.

    `reverse` scans from the last row to the first. `seg_start` (bool, or
    None for one segment) marks the rows where a segment begins in scan
    order: for a reverse scan, the LAST row of each segment in row order.
    On CPU tensors the plain version; on CUDA tensors the kernel."""
    if op not in SCAN_OPS:
        raise ValueError(f"segmented_scan: unknown op {op!r}")
    if x.dim() != 1:
        raise TypeError("segmented_scan: x must be 1-d")
    if op == "last" and x.dtype != torch.bool:
        raise TypeError("segmented_scan: op 'last' takes a bool array")
    if op != "last" and x.dtype not in SCAN_DTYPES:
        raise TypeError(f"segmented_scan: values must be float64, int64 or "
                        f"int32, got {x.dtype}")
    dev = x.device
    if seg_start is not None and (seg_start.dtype != torch.bool
                                  or seg_start.shape != x.shape
                                  or seg_start.device != dev):
        raise TypeError("segmented_scan: seg_start must be bool like x")
    if dev.type == "cpu":
        return _segmented_scan_plain(x, op, reverse, seg_start)
    if dev.type != "cuda":
        raise RuntimeError(f"segmented_scan: no kernel for {dev}")
    from presto_tpu_torch import native
    x = x.contiguous()
    seg = seg_start.contiguous() if seg_start is not None else None
    n = x.shape[0]
    out_dtype = torch.int64 if op == "last" else x.dtype
    out = torch.empty(n, dtype=out_dtype, device=dev)
    if n == 0:
        return out
    lib = native.load("seg_scan")
    scratch = torch.empty(lib.segmented_scan_scratch_words(n),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segmented_scan(
            ctypes.c_void_p(x.data_ptr()), SCAN_DTYPES[out_dtype],
            SCAN_OPS[op], int(reverse),
            ctypes.c_void_p(seg.data_ptr() if seg is not None else 0), n,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "segmented_scan", "seg_scan")
    segmented_scan.launches += 1
    kind = "last" if op == "last" else "add" if op == "add" else "minmax"
    segmented_scan.mode_launches[SCAN_KINDS.index(kind)] += 1
    return out


segmented_scan.launches = 0
#: launches by SCAN_KINDS (window_bounds' counted too)
segmented_scan.mode_launches = [0, 0, 0, 0]


def shift_left(flags: torch.Tensor) -> torch.Tensor:
    """end[i] = start[i + 1], the last row always an end."""
    end = torch.empty_like(flags)
    end[:-1] = flags[1:]
    end[-1:] = True
    return end


def _window_bounds_plain(part_start: torch.Tensor, peer_start: torch.Tensor):
    """Plain PyTorch version of window_bounds: four "last" scans."""
    return (_segmented_scan_plain(part_start, "last", False, None),
            _segmented_scan_plain(shift_left(part_start), "last", True, None),
            _segmented_scan_plain(peer_start, "last", False, None),
            _segmented_scan_plain(shift_left(peer_start), "last", True, None))


def window_bounds(part_start: torch.Tensor, peer_start: torch.Tensor):
    """A sorted window's row positions from its partition and peer start
    flags (bool, one a sorted row): (ps, pe, qs, qe), int64, the last
    partition start at or before each row, the first partition end at or
    after it (a row ends its partition where the next row starts one; the
    last row always does), and the same for peer groups; -1 where there is
    none. These are the four fills of presto_tpu/ops/window.py:197-204 (the
    JAX package's fill gives 0 where the port gives -1; a window's first
    row always starts a partition, so neither shows).

    One launch of K7's bounds kernel (csrc/seg_scan.cu window_bounds) on
    CUDA tensors, counted as a segmented_scan launch of kind "bounds"; on
    CPU tensors the plain version, four segmented_scan scans."""
    if part_start.dtype != torch.bool or peer_start.dtype != torch.bool \
            or part_start.dim() != 1 or peer_start.shape != part_start.shape:
        raise TypeError("window_bounds: flags must be 1-d bool of one "
                        "length")
    dev = part_start.device
    if peer_start.device != dev:
        raise ValueError("window_bounds: tensors on different devices")
    if dev.type == "cpu":
        return _window_bounds_plain(part_start, peer_start)
    if dev.type != "cuda":
        raise RuntimeError(f"window_bounds: no kernel for {dev}")
    from presto_tpu_torch import native
    part_start = part_start.contiguous()
    peer_start = peer_start.contiguous()
    n = part_start.shape[0]
    outs = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(4)]
    if n == 0:
        return tuple(outs)
    lib = native.load("seg_scan")
    scratch = torch.empty(lib.segmented_scan_scratch_words(n),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_bounds(
            ctypes.c_void_p(part_start.data_ptr()),
            ctypes.c_void_p(peer_start.data_ptr()), n,
            *[ctypes.c_void_p(t.data_ptr()) for t in outs],
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "window_bounds", "seg_scan")
    segmented_scan.launches += 1
    segmented_scan.mode_launches[SCAN_KINDS.index("bounds")] += 1
    return tuple(outs)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D cumulative sum in x's dtype (presto_tpu/ops/scan.py
    :36)."""
    return segmented_scan(x, "add")


def blocked_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max (presto_tpu/ops/scan.py:61)."""
    return segmented_scan(x, "max")


def _fill(vals: torch.Tensor, present: torch.Tensor, init,
          reverse: bool) -> torch.Tensor:
    n = vals.shape[0]
    last = segmented_scan(present, "last", reverse=reverse)
    out = vals[last.clamp(0, max(n - 1, 0))]
    fill = torch.zeros((), dtype=vals.dtype, device=vals.device) \
        if init is None else torch.as_tensor(init, dtype=vals.dtype,
                                             device=vals.device)
    return torch.where(last >= 0, out, fill)


def fill_forward(vals: torch.Tensor, present: torch.Tensor, init=None):
    """Per-slot last `present` value at or before the slot; slots before
    the first present value get `init` (default the dtype's zero)
    (presto_tpu/ops/scan.py:84): the last present position (K7) and one
    gather."""
    return _fill(vals, present, init, reverse=False)


def fill_backward(vals: torch.Tensor, present: torch.Tensor, init=None):
    """Per-slot next `present` value at or after the slot
    (presto_tpu/ops/scan.py:153): a reverse K7 scan and one gather."""
    return _fill(vals, present, init, reverse=True)


def seg_scan(vals: torch.Tensor, seg_start: torch.Tensor, binop,
             ident=None) -> torch.Tensor:
    """Inclusive segmented running min or max (presto_tpu/ops/scan.py
    :104): `binop` is torch.minimum or torch.maximum; `ident`, the
    operator's identity, is kept for the JAX signature: an inclusive scan
    never shows it."""
    op = {torch.minimum: "min", torch.maximum: "max"}.get(binop)
    if op is None:
        raise ValueError(f"seg_scan: binop must be a min or max, "
                         f"got {binop!r}")
    return segmented_scan(vals, op, seg_start=seg_start)
