"""Scan and segment primitives.

The port's twin of presto_tpu/ops/scan.py for the aggregation path:
`segment_sums` (:160) and `group_starts` (:177). The JAX package reduces
contiguous segments as differences of one blocked running sum (`cumsum`
:36); here the hand-written `segment_reduce` kernel (csrc/segment_reduce.cu,
K3) sums each segment directly, and dense group starts are a stable
compaction of the flag positions (`compact_indices`, K2). The JAX
package's segmented scans and fills (seg_scan, fill_forward,
blocked_cummax, fill_backward) serve its merge join and windows; the
port's joins do without them (ops/join.py), and windows are a later
slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from presto_tpu_torch.data.column import compact_indices

WANT_SUM = 1
WANT_MINMAX = 2

_DTYPE_CODES = {torch.float64: 0, torch.int64: 1, torch.int32: 2}


def _segment_reduce_plain(values, live, starts, ends, want):
    """Plain PyTorch version of the segment_reduce kernel: rows are
    labelled with their segment and reduced with index_add_/scatter_reduce
    in row order."""
    n = values.shape[0]
    g = starts.shape[0]
    dev = values.device
    s = starts.clamp(0, n)
    e = torch.maximum(ends.clamp(0, n), s)
    lengths = e - s
    seg = torch.repeat_interleave(
        torch.arange(g, dtype=torch.int64, device=dev), lengths)
    offsets = torch.cumsum(lengths, 0) - lengths
    rows = (torch.repeat_interleave(s, lengths)
            + torch.arange(seg.shape[0], dtype=torch.int64, device=dev)
            - torch.repeat_interleave(offsets, lengths))
    v = values[rows]
    keep = (live[rows] if live is not None
            else torch.ones(rows.shape[0], dtype=torch.bool, device=dev))
    out = {"cnt": torch.zeros(g, dtype=torch.int64, device=dev)
           .index_add_(0, seg, keep.to(torch.int64))}
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
    int32. On CPU tensors this is the plain version; on CUDA tensors it
    launches the kernel."""
    if values.dim() != 1 or values.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_reduce: values must be 1-d float64, int64 "
                        f"or int32, got {values.dtype}")
    if starts.dtype != torch.int64 or ends.dtype != torch.int64 \
            or starts.shape != ends.shape or starts.dim() != 1:
        raise TypeError("segment_reduce: starts/ends must be 1-d int64 of "
                        "one length")
    if live is not None and (live.dtype != torch.bool
                             or live.shape != values.shape):
        raise TypeError("segment_reduce: live must be bool like values")
    dev = values.device
    for t in (starts, ends) + ((live,) if live is not None else ()):
        if t.device != dev:
            raise ValueError("segment_reduce: tensors on different devices")
    if dev.type == "cpu":
        return _segment_reduce_plain(values, live, starts, ends, want)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_reduce: no kernel for {dev}")
    from presto_tpu_torch import native
    values = values.contiguous()
    live = live.contiguous() if live is not None else None
    starts, ends = starts.contiguous(), ends.contiguous()
    g = starts.shape[0]
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segment_reduce(
            ctypes.c_void_p(values.data_ptr()),
            _DTYPE_CODES[values.dtype], want,
            ctypes.c_void_p(live.data_ptr() if live is not None else 0),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(ends.data_ptr()), g, values.shape[0],
            ptr("cnt"), ptr("fsum"), ptr("isum"), ptr("min"), ptr("max"),
            ctypes.c_void_p(stream))
    native.check(rc, "segment_reduce", "segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0


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
