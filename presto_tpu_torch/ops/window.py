"""Window functions: a sort permutation, boundary flags, scans and one
frame kernel per window function.

The port's twin of presto_tpu/ops/window.py (`window_page` :126,
`_frame_bounds` :73), with the same planning dataclasses and results:

1. the rows' permutation by (validity, partition keys, order keys) from
   `lex_perm` (composed stable `torch.sort`s, ops/keys.py);
2. partition and peer start flags in one pass over the keys taken in that
   order (`key_change_flags`, kernel K8, csrc/keys.cu);
3. each sorted row's partition and peer start and end positions, as
   last-present-position scans forward and backward, all four in one
   launch (`window_bounds`, kernel K7, csrc/seg_scan.cu);
4. per window function the prefix arrays it needs (K7): live counts and
   sums, restarting at each partition start (the JAX package takes
   differences of one global running sum, :279-299; a segmented sum gives
   the same frame sums with less cancellation), running min/max for frames
   with one unbounded side, a prefix of peer starts for dense_rank;
5. one call of `window_frame` (kernel K9, csrc/window.cu) per function:
   per sorted row its frame bounds and value, written straight to the
   row's original position (out[perm[i]] = w[i]), so the JAX package's
   argsort of the inverse permutation (:386) and its gather go. The
   library picks a kernel instance by the function's class and the
   sources of its frame bounds.

A min/max frame bounded on both sides by offsets at most 64 rows wide is
folded from shared memory; a wider one, or a RANGE frame of the row's
peers, reads a sparse table that the same call builds in scratch (the JAX
package's structure, :340-383).

Supported, as in the JAX package: row_number, rank, dense_rank, ntile,
lag/lead (offset + default), first_value/last_value/nth_value, and
sum/count/count_star/avg/min/max over ROWS frames of any UNBOUNDED / N
PRECEDING / CURRENT / N FOLLOWING bounds and RANGE frames of UNBOUNDED /
CURRENT bounds (the SQL default frame with and without ORDER BY).
Descending integer keys sort by their complement (ops/keys.descending),
so INT64_MIN sorts last under DESC, where the JAX package's negation
wraps and sorts it first.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from presto_tpu_torch.data.column import Column, Page, torch_dtype
from presto_tpu_torch.ops.keys import LANE_DTYPES, WINDOW_FLAGS, SortKey, \
    _orderable_lanes, descending, group_values, key_change_flags, lex_perm
from presto_tpu_torch.ops.scan import segmented_scan, shift_left, \
    window_bounds
from presto_tpu_torch.types import Type


@dataclasses.dataclass(frozen=True)
class Frame:
    """Window frame (reference: spi/plan/WindowNode.Frame). Bound types:
    unbounded_preceding | preceding | current | following |
    unbounded_following; N for the bounded types sits in start_n/end_n."""
    mode: str = "range"                   # "range" | "rows"
    start_type: str = "unbounded_preceding"
    start_n: Optional[int] = None
    end_type: str = "current"
    end_n: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One window function: kind in {row_number, rank, dense_rank, ntile,
    lag, lead, first_value, last_value, nth_value, sum, count,
    count_star, avg, min, max}. `field` is the argument column; `param`
    is the lag/lead offset, ntile bucket count or nth_value position;
    `default` the lag/lead default literal (python value)."""
    kind: str
    field: Optional[int]
    output_type: Type
    param: Optional[int] = None
    default: object = None
    frame: Optional[Frame] = None


#: window_frame kinds, by their code in csrc/window.cu
KINDS = {"row_number": 0, "rank": 1, "dense_rank": 2, "ntile": 3,
         "lag": 4, "lead": 5, "first_value": 6, "last_value": 7,
         "nth_value": 8, "sum": 9, "count": 10, "count_star": 11,
         "avg": 12, "min": 13, "max": 14}

#: frame bound types, by their code in csrc/window.cu
BOUNDS = {"unbounded_preceding": 0, "preceding": 1, "current": 2,
          "following": 3, "unbounded_following": 4}

#: how a min/max frame is read: the running extreme from the partition
#: start at hi; the reverse running extreme to the partition end at lo;
#: a fold over [lo, hi]
RUN_FROM_START, RUN_TO_END, FOLD_FRAME = 0, 1, 2

_OFFSET_KINDS = {"lag", "lead"}
_VALUE_KINDS = {"first_value", "last_value", "nth_value"}
_AGG_KINDS = {"sum", "count", "count_star", "avg", "min", "max"}

# window_frame's packed parameters (csrc/window.cu reads the same layout)
(I_KIND, I_MODE, I_START, I_START_N, I_END, I_END_N, I_PARAM,
 I_HAS_DEFAULT, I_VAL_DT, I_AUX_DT, I_OUT_DT, I_MINMAX, I_DEFAULT,
 I_SENTINEL, I_IS_MAX, N_IPARAMS) = range(16)
D_DEFAULT, D_SENTINEL, D_AVG_DIV, N_DPARAMS = range(4)
(P_PERM, P_NUM_ROWS, P_PS, P_PE, P_QS, P_QE, P_VALS, P_NULLS, P_AUX_I,
 P_AUX_V, P_OUT, P_OUT_NULLS, N_PTRS) = range(13)


def resolve_frame(frame: Optional[Frame], has_order: bool) -> Frame:
    """The SQL default frame where none is given: RANGE UNBOUNDED
    PRECEDING .. CURRENT ROW with ORDER BY, the whole partition without.
    Raises on the bounds the JAX package does not implement."""
    if frame is None:
        frame = Frame() if has_order else Frame(
            end_type="unbounded_following")
    st, en = frame.start_type, frame.end_type
    if frame.mode == "rows":
        if st == "unbounded_following":
            raise NotImplementedError(f"frame start {st}")
        if en == "unbounded_preceding":
            raise NotImplementedError(f"frame end {en}")
    else:
        if st not in ("unbounded_preceding", "current"):
            raise NotImplementedError(f"RANGE frame start {st}")
        if en not in ("unbounded_following", "current"):
            raise NotImplementedError(f"RANGE frame end {en}")
    return frame


def _frame_bounds(frame: Frame, idx, part_start_idx, part_end_idx,
                  peer_start_idx, peer_end_idx):
    """Per-row inclusive [lo, hi] frame bounds in sorted coordinates
    (presto_tpu/ops/window.py:73) of a resolved frame. Returns (lo, hi,
    start_unbounded, end_unbounded)."""
    st, en = frame.start_type, frame.end_type
    if frame.mode == "rows":
        lo = {"unbounded_preceding": lambda: part_start_idx,
              "preceding": lambda: idx - int(frame.start_n),
              "current": lambda: idx,
              "following": lambda: idx + int(frame.start_n)}[st]()
        hi = {"unbounded_following": lambda: part_end_idx,
              "following": lambda: idx + int(frame.end_n),
              "current": lambda: idx,
              "preceding": lambda: idx - int(frame.end_n)}[en]()
        lo = torch.maximum(lo, part_start_idx)
        hi = torch.minimum(hi, part_end_idx)
    else:
        lo = part_start_idx if st == "unbounded_preceding" \
            else peer_start_idx
        hi = part_end_idx if en == "unbounded_following" else peer_end_idx
    return lo, hi, st == "unbounded_preceding", en == "unbounded_following"


# ---------------------------------------------------------------------------
# K9 window_frame
# ---------------------------------------------------------------------------

def _window_frame_plain(kind: str, frame: Optional[Frame], iparams,
                        dparams, perm, num_rows, ps, pe, qs, qe, vals, nulls,
                        aux_i, aux_v, out_dtype):
    """Plain PyTorch version of the window_frame kernel: the JAX
    package's per-row formulas over the same inputs, then the scatter to
    original row positions."""
    n = perm.shape[0]
    dev = perm.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    valid = idx < num_rows
    no_null = torch.zeros(n, dtype=torch.bool, device=dev)

    def clip(a):
        return a.clamp(0, max(n - 1, 0))

    def arg(j):
        r = perm[clip(j)]
        return vals[r], nulls[r]

    if kind == "row_number":
        w, wn = idx - ps + 1, no_null
    elif kind == "rank":
        w, wn = qs - ps + 1, no_null
    elif kind == "dense_rank":
        w, wn = aux_i - aux_i[ps] + 1, no_null
    elif kind == "ntile":
        buckets = iparams[I_PARAM]
        psize = pe - ps + 1
        rn = idx - ps
        base = psize // buckets
        rem = psize - base * buckets
        big = rem * (base + 1)
        w = torch.where(rn < big, rn // (base + 1).clamp(min=1) + 1,
                        rem + (rn - big) // base.clamp(min=1) + 1)
        wn = no_null
    elif kind in _OFFSET_KINDS:
        k = iparams[I_PARAM]
        j = idx - k if kind == "lag" else idx + k
        inb = (j >= ps) & (j <= pe)
        w, an = arg(j)
        wn = an | ~inb
        if iparams[I_HAS_DEFAULT]:
            dv = dparams[D_DEFAULT] if w.is_floating_point() \
                else iparams[I_DEFAULT]
            w = torch.where(inb, w, torch.tensor(dv, dtype=w.dtype,
                                                 device=dev))
            wn = torch.where(inb, wn, False)
    else:
        lo, hi, _su, _eu = _frame_bounds(frame, idx, ps, pe, qs, qe)
        if kind in _VALUE_KINDS:
            pos = {"first_value": lo, "last_value": hi}.get(kind)
            if pos is None:
                pos = lo + iparams[I_PARAM] - 1
            empty = (lo > hi) | (pos < lo) | (pos > hi)
            w, an = arg(pos)
            wn = an | empty
        else:
            empty = lo > hi
            loc, hic = clip(lo), clip(hi)

            def frame_total(prefix):
                before = torch.where(
                    lo > ps, prefix[clip(lo - 1)],
                    torch.zeros((), dtype=prefix.dtype, device=dev))
                return torch.where(
                    empty, torch.zeros((), dtype=prefix.dtype, device=dev),
                    prefix[hic] - before)
            cnt = frame_total(aux_i)
            if kind in ("count", "count_star"):
                w, wn = cnt, no_null
            elif kind == "sum":
                w, wn = frame_total(aux_v), cnt == 0
            elif kind == "avg":
                w = frame_total(aux_v) / cnt.clamp(min=1)
                if dparams[D_AVG_DIV] != 1.0:
                    w = w / dparams[D_AVG_DIV]
                wn = cnt == 0
            else:
                mode = iparams[I_MINMAX]
                if mode == RUN_FROM_START:
                    w = aux_v[hic]
                elif mode == RUN_TO_END:
                    w = aux_v[loc]
                else:
                    fold = torch.maximum if iparams[I_IS_MAX] \
                        else torch.minimum
                    w = aux_v[loc]
                    span = int((hi - lo).max()) + 1 if n else 0
                    for d in range(1, span):
                        w = torch.where(lo + d <= hi,
                                        fold(w, aux_v[clip(lo + d)]), w)
                wn = cnt == 0
    wn = wn | ~valid
    if out_dtype.is_floating_point:
        sent = dparams[D_SENTINEL]
    elif out_dtype == torch.bool:
        sent = False
    else:
        sent = iparams[I_SENTINEL]
    wv = torch.where(wn, torch.tensor(sent, dtype=out_dtype, device=dev),
                     w.to(out_dtype))
    out = torch.empty(n, dtype=out_dtype, device=dev)
    out_nulls = torch.empty(n, dtype=torch.bool, device=dev)
    out[perm] = wv
    out_nulls[perm] = wn
    return out, out_nulls


def window_frame(kind: str, frame: Optional[Frame], iparams, dparams,
                 perm, num_rows, ps, pe, qs, qe, vals, nulls, aux_i, aux_v,
                 out_dtype):
    """Evaluate one window function for every sorted row and write it to
    the row's original position (kernel K9, csrc/window.cu).

    `kind` and `frame` are the function and its resolved frame (the
    plain version reads them; the kernel reads the same from `iparams`).
    `perm` [n] int64 is the sort permutation; `ps`, `pe`, `qs`, `qe` [n]
    int64 each sorted row's partition start and end and peer start and
    end positions; `vals`/`nulls` the argument column in original row
    order (or None); `aux_i` an int64 prefix array (live counts
    restarting at partition starts, or for dense_rank the running count of
    peer starts); `aux_v` the frame sums' prefix (int64 or float64), or
    the running or plain masked min/max array; `iparams`/`dparams` the
    packed scalar parameters (I_*, D_*). Returns the output column's
    (values, nulls) in original row order, the type's null sentinel where
    the result is null or the row is padding.

    On CPU tensors the plain version; on CUDA tensors the kernel."""
    dev = perm.device
    if dev.type == "cpu":
        return _window_frame_plain(kind, frame, iparams, dparams, perm,
                                   num_rows, ps, pe, qs, qe, vals, nulls,
                                   aux_i, aux_v, out_dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"window_frame: no kernel for {dev}")
    from presto_tpu_torch import native
    n = perm.shape[0]
    out = torch.empty(n, dtype=out_dtype, device=dev)
    out_nulls = torch.empty(n, dtype=torch.bool, device=dev)
    num_rows = num_rows.to(device=dev, dtype=torch.int64).reshape(())
    keep = [t.contiguous() if t is not None else None
            for t in (perm, num_rows, ps, pe, qs, qe, vals, nulls, aux_i,
                      aux_v)]
    for t in keep:
        if t is not None and t.device != dev:
            raise ValueError("window_frame: tensors on different devices")
    ptrs = (ctypes.c_void_p * N_PTRS)(
        *[t.data_ptr() if t is not None else 0 for t in keep],
        out.data_ptr(), out_nulls.data_ptr())
    ip = (ctypes.c_int64 * N_IPARAMS)(*[int(v) for v in iparams])
    dp = (ctypes.c_double * N_DPARAMS)(*[float(v) for v in dparams])
    lib = native.load("window")
    # a both-bounded min/max frame too wide for shared memory reads a
    # sparse table built in this scratch (its size: the library's own)
    words = lib.window_frame_scratch_words(ctypes.cast(ip, ctypes.c_void_p),
                                           n)
    scratch = (torch.empty(words, dtype=torch.int64, device=dev)
               if words > 0 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_frame(ctypes.cast(ptrs, ctypes.c_void_p),
                              ctypes.cast(ip, ctypes.c_void_p),
                              ctypes.cast(dp, ctypes.c_void_p), n,
                              ctypes.c_void_p(scratch.data_ptr()
                                              if scratch is not None else 0),
                              ctypes.c_void_p(stream))
    native.check(rc, "window_frame", "window")
    window_frame.launches += 1
    return out, out_nulls


window_frame.launches = 0


def _dtype_code(t: Optional[torch.Tensor]) -> int:
    return -1 if t is None else LANE_DTYPES[t.dtype]


@dataclasses.dataclass
class SortedWindow:
    """A page's rows in window order: the permutation, the keys compared
    between neighbours, partition and peer start flags (K8), each sorted
    row's partition and peer start and end positions (K7), and which
    sorted rows are valid."""
    perm: torch.Tensor
    keys: list
    part_start: torch.Tensor
    peer_start: torch.Tensor
    part_end: torch.Tensor
    ps: torch.Tensor
    pe: torch.Tensor
    qs: torch.Tensor
    qe: torch.Tensor
    s_valid: torch.Tensor
    has_order: bool


def sort_window(page: Page, partition_fields: Sequence[int],
                order_keys: Sequence[SortKey]) -> SortedWindow:
    """Sort lanes (validity, partition keys, order keys), the permutation
    (lex_perm), boundary flags (K8) and start/end positions (K7)."""
    # the key compares read each column's own values (equality does not
    # change under group_values' widening or a descending lane's
    # complement)
    lanes = [(~page.row_valid()).to(torch.int8)]
    keys = []
    for f in partition_fields:
        c = page.columns[f]
        lanes += [c.nulls.to(torch.int8), group_values(c)]
        keys.append((c.nulls, [c.values]))
    for k in order_keys:
        c = page.columns[k.field]
        nr = 0 if k.nulls_sort_first else 1
        lanes.append(torch.where(c.nulls, nr, 1 - nr).to(torch.int8))
        for v in _orderable_lanes(c):
            lanes.append(v if k.ascending else descending(v))
        keys.append((c.nulls, [c.values]))
    perm = lex_perm(lanes)
    part_start, peer_start = key_change_flags(
        perm, keys, page.num_rows, len(partition_fields), WINDOW_FLAGS)
    ps, pe, qs, qe = window_bounds(part_start, peer_start)
    idx = torch.arange(page.capacity, dtype=torch.int64, device=page.device)
    return SortedWindow(
        perm=perm, keys=keys, part_start=part_start, peer_start=peer_start,
        part_end=shift_left(part_start), ps=ps, pe=pe, qs=qs, qe=qe,
        s_valid=idx < page.num_rows, has_order=bool(order_keys))


@dataclasses.dataclass
class FrameInputs:
    """What one window_frame launch takes besides the sorted window."""
    frame: Optional[Frame]
    iparams: list
    dparams: list
    vals: Optional[torch.Tensor]
    nulls: Optional[torch.Tensor]
    aux_i: Optional[torch.Tensor]
    aux_v: Optional[torch.Tensor]
    out_dtype: torch.dtype


def frame_inputs(page: Page, sw: SortedWindow,
                 spec: WindowSpec) -> FrameInputs:
    """One spec's packed parameters and prefix arrays (K7)."""
    kind = spec.kind
    if kind not in KINDS:
        raise NotImplementedError(f"window function {kind}")
    dev = page.device
    t = spec.output_type
    out_dtype = torch_dtype(t)
    frame = None
    if kind in _VALUE_KINDS or kind in _AGG_KINDS:
        frame = resolve_frame(spec.frame, sw.has_order)
    arg = page.columns[spec.field] if spec.field is not None else None
    vals = arg.values if arg is not None else None
    nulls = arg.nulls if arg is not None else None
    perm = sw.perm
    ip = [0] * N_IPARAMS
    dp = [0.0] * N_DPARAMS
    dp[D_AVG_DIV] = 1.0
    ip[I_KIND] = KINDS[kind]
    if frame is not None:
        ip[I_MODE] = 0 if frame.mode == "rows" else 1
        ip[I_START] = BOUNDS[frame.start_type]
        ip[I_START_N] = int(frame.start_n or 0)
        ip[I_END] = BOUNDS[frame.end_type]
        ip[I_END_N] = int(frame.end_n or 0)
    if kind in _OFFSET_KINDS:
        ip[I_PARAM] = int(spec.param if spec.param is not None else 1)
    elif kind in ("ntile", "nth_value"):
        ip[I_PARAM] = int(spec.param)
    if kind in _OFFSET_KINDS and spec.default is not None:
        if isinstance(spec.default, str):
            raise NotImplementedError("lag/lead with a string default")
        ip[I_HAS_DEFAULT] = 1
        if vals.is_floating_point():
            dp[D_DEFAULT] = float(spec.default)
        else:
            ip[I_DEFAULT] = int(spec.default)
    sent = t.null_sentinel()
    if out_dtype.is_floating_point:
        dp[D_SENTINEL] = float(sent)
    else:
        ip[I_SENTINEL] = int(sent)

    aux_i = aux_v = None
    if kind == "dense_rank":
        aux_i = segmented_scan(sw.peer_start.to(torch.int64), "add")
    elif kind in _AGG_KINDS:
        live = sw.s_valid & ~nulls[perm] if arg is not None else sw.s_valid
        aux_i = segmented_scan(live.to(torch.int64), "add",
                               seg_start=sw.part_start)
        if kind in ("sum", "avg"):
            acc = torch.float64 if (t.is_floating or kind == "avg") \
                else torch.int64
            contrib = torch.where(live, vals[perm].to(acc),
                                  torch.zeros((), dtype=acc, device=dev))
            aux_v = segmented_scan(contrib, "add", seg_start=sw.part_start)
            if kind == "avg" and arg.type.is_decimal:
                dp[D_AVG_DIV] = float(10 ** arg.type.scale)
        elif kind in ("min", "max"):
            v = vals[perm]
            if v.dtype == torch.bool:
                v = v.to(torch.int32)
            elif v.dtype == torch.float32:
                v = v.to(torch.float64)
            # rows outside the live set hold the operator's identity
            if v.is_floating_point():
                ident = float("inf") if kind == "min" else float("-inf")
            else:
                info = torch.iinfo(v.dtype)
                ident = info.max if kind == "min" else info.min
            masked = torch.where(live, v, torch.tensor(
                ident, dtype=v.dtype, device=dev))
            ip[I_IS_MAX] = int(kind == "max")
            if frame.start_type == "unbounded_preceding":
                ip[I_MINMAX] = RUN_FROM_START
                aux_v = segmented_scan(masked, kind,
                                       seg_start=sw.part_start)
            elif frame.end_type == "unbounded_following":
                ip[I_MINMAX] = RUN_TO_END
                aux_v = segmented_scan(masked, kind, reverse=True,
                                       seg_start=sw.part_end)
            else:
                ip[I_MINMAX] = FOLD_FRAME
                aux_v = masked
    ip[I_VAL_DT] = _dtype_code(vals)
    ip[I_AUX_DT] = _dtype_code(aux_v)
    ip[I_OUT_DT] = LANE_DTYPES[out_dtype]
    return FrameInputs(frame, ip, dp, vals, nulls, aux_i, aux_v, out_dtype)


def run_frame(page: Page, sw: SortedWindow, spec: WindowSpec,
              fi: FrameInputs):
    """One window_frame launch (K9) for `spec`: (values, nulls)."""
    return window_frame(spec.kind, fi.frame, fi.iparams, fi.dparams, sw.perm,
                        page.num_rows, sw.ps, sw.pe, sw.qs, sw.qe, fi.vals,
                        fi.nulls, fi.aux_i, fi.aux_v, fi.out_dtype)


def window_page(page: Page, partition_fields: Sequence[int],
                order_keys: Sequence[SortKey],
                specs: Sequence[WindowSpec]) -> Page:
    """Append one column per spec to `page` (original row order kept)."""
    sw = sort_window(page, partition_fields, order_keys)
    cols = list(page.columns)
    for spec in specs:
        w, wn = run_frame(page, sw, spec, frame_inputs(page, sw, spec))
        # value-kind outputs over strings are dictionary codes (code
        # order == lexicographic); the output keeps the dictionary
        dictionary = (page.columns[spec.field].dictionary
                      if spec.field is not None
                      and spec.output_type.is_string else None)
        cols.append(Column(w, wn, spec.output_type, dictionary))
    return Page(tuple(cols), page.num_rows,
                page.names + tuple(f"_w{i}" for i in range(len(specs))))
