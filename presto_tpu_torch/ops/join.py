"""Joins: a build side sorted by key hash, probe windows found through a
radix directory with an exact key recheck, and a prefix-sum pair
expansion.

The port's twin of presto_tpu/ops/join.py, with the same functions,
signatures and results:

- `merge_join` (:45) for unique build keys (and semi/anti/anti_exists,
  where duplicates cannot change a match flag), returning
  `(page, dup_count, match)`;
- `hash_join` (:237), the many-to-many expansion join with a static pair
  capacity, returning `(page, total_pairs)`;
- `full_outer_append` (:209).

The TPU design of `merge_join` co-sorts build and probe rows by key and
fills build rows forward with blocked scans, because binary search over
millions of probes serialises on a TPU. On the card a search per probe
row is cheap, so both joins share one probe: the build side is sorted
stably by `hash_columns` (kernel K4), and the hand-written `join_probe`
kernel (K5, csrc/join.cu) finds each probe row's window of equal hashes
through a radix directory over the sorted hashes and walks it with an
exact key recheck. The
expansion join then lays out its (probe, build) pairs with `join_expand`
(K6). Survivors are gathered by torch indexing and compacted with
`compact_indices` (K2).

NULL join keys never match (SQL): dead and null-key rows get disjoint
sentinel hashes, -1 on the probe side and -2 on the build side, so they
fall in no live window.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.data.column import Column, Page, compact, \
    compact_indices
from presto_tpu_torch.expr.compile import align_string_columns
from presto_tpu_torch.ops.keys import group_values_lane, hash_columns, \
    lane_arrays, values_equal
from presto_tpu_torch.types import BOOLEAN

#: join_probe modes: window bounds only; plus the first key match (walking
#: forward); plus the last key match (walking backward); plus every match,
#: flagging each matched build row
WINDOW, FIRST, LAST, ALL = 0, 1, 2, 3

def _aligned_keys(probe: Page, build: Page, probe_fields, build_fields):
    """Pull key columns, aligning string dictionaries across sides."""
    pcols, bcols = [], []
    for pf, bf in zip(probe_fields, build_fields):
        pc, bc = probe.columns[pf], build.columns[bf]
        if pc.type.is_string and bc.type.is_string:
            pc, bc = align_string_columns(pc, bc)
        pcols.append(pc)
        bcols.append(bc)
    return pcols, bcols


def _any_null(cols: Sequence[Column], cap: int, dev) -> torch.Tensor:
    out = torch.zeros(cap, dtype=torch.bool, device=dev)
    for c in cols:
        out = out | c.nulls
    return out


def _keys_equal_plain(pvals, bvals, pi, bi) -> torch.Tensor:
    """values_equal over every key lane, probe rows pi against build rows
    bi (so int32 codes meet int64 and NaN meets NaN)."""
    eq = torch.ones(pi.shape[0], dtype=torch.bool, device=pi.device)
    for pv, bv in zip(pvals, bvals):
        eq &= values_equal(group_values_lane(pv)[pi],
                           group_values_lane(bv)[bi])
    return eq


# ---------------------------------------------------------------------------
# K5 join_probe
# ---------------------------------------------------------------------------

def _join_probe_plain(ph, bh_sorted, order, pvals, bvals, mode):
    """Plain PyTorch version of the join_probe kernel: torch.searchsorted
    for the windows, then the windows walked one slot at a time for all
    probe rows together, stopping once no row needs another slot."""
    dev = ph.device
    bcap = bh_sorted.shape[0]
    lo = torch.searchsorted(bh_sorted, ph, side="left")
    hi = torch.searchsorted(bh_sorted, ph, side="right")
    cnt = torch.where(ph >= 0, hi - lo, 0)
    if mode == WINDOW:
        return lo, cnt, None, None
    hit = torch.full_like(ph, -1)
    bflag = (torch.zeros(bcap, dtype=torch.bool, device=dev)
             if mode == ALL else None)
    rows = torch.arange(ph.shape[0], dtype=torch.int64, device=dev)
    k = 0
    while True:
        need = cnt > k
        if mode in (FIRST, LAST):
            need &= hit < 0
        if not bool(need.any()):
            break
        r = rows[need]
        pos = (hi[r] - 1 - k) if mode == LAST else (lo[r] + k)
        brow = order[pos]
        eq = _keys_equal_plain(pvals, bvals, r, brow)
        if mode == ALL:
            bflag[brow[eq]] = True
            # the last match in window order, as LAST finds it
            hit[r[eq]] = brow[eq]
        else:
            hit[r[eq]] = brow[eq]
        k += 1
    return lo, cnt, hit, bflag


def join_probe(ph: torch.Tensor, bh_sorted: torch.Tensor,
               order: torch.Tensor, pvals: Sequence[torch.Tensor],
               bvals: Sequence[torch.Tensor], mode: int):
    """Probe a hash-sorted build side (kernel K5, csrc/join.cu).

    `ph` [P] int64 are the probe hashes (negative: dead or null key);
    `bh_sorted` [B] the build hashes sorted stably, `order` [B] int64 the
    build row at each sorted position; `pvals`/`bvals` the key lanes in
    probe and build row order. Returns `(lo, cnt, hit, bflag)`:

    - `lo` [P]: the first sorted position whose hash is not below the
      probe's (torch.searchsorted, side="left");
    - `cnt` [P]: the window's length (equal hashes), 0 for a dead probe;
    - `hit` [P] (mode FIRST, LAST, ALL; else None): the build row of the
      first (FIRST) or last (LAST, ALL) key-equal row in window order,
      -1 where none is;
    - `bflag` [B] bool (mode ALL; else None): build rows that some probe
      row matches.

    On CPU tensors the plain version; on CUDA tensors the kernel."""
    dev = ph.device
    if mode not in (WINDOW, FIRST, LAST, ALL):
        raise ValueError(f"join_probe: unknown mode {mode}")
    for t in (ph, bh_sorted, order):
        if t.dtype != torch.int64 or t.dim() != 1 or t.device != dev:
            raise TypeError("join_probe: hashes and order must be 1-d "
                            "int64 on one device")
    if len(pvals) != len(bvals):
        raise ValueError("join_probe: probe and build key lanes differ")
    if dev.type == "cpu":
        return _join_probe_plain(ph, bh_sorted, order, pvals, bvals, mode)
    if dev.type != "cuda":
        raise RuntimeError(f"join_probe: no kernel for {dev}")
    from presto_tpu_torch import native
    ph, bh_sorted, order = (t.contiguous() for t in (ph, bh_sorted, order))
    pvals = [v.contiguous() for v in pvals]
    bvals = [v.contiguous() for v in bvals]
    pptr, pdt = lane_arrays(pvals)
    bptr, bdt = lane_arrays(bvals)
    n, bcap = ph.shape[0], bh_sorted.shape[0]
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    cnt = torch.empty(n, dtype=torch.int64, device=dev)
    hit = (torch.empty(n, dtype=torch.int64, device=dev)
           if mode != WINDOW else None)
    bflag = (torch.zeros(bcap, dtype=torch.bool, device=dev)
             if mode == ALL else None)
    lib = native.load("join")
    scratch = torch.empty(lib.join_probe_scratch_words(bcap),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.join_probe(
            ctypes.c_void_p(ph.data_ptr()), n,
            ctypes.c_void_p(bh_sorted.data_ptr()),
            ctypes.c_void_p(order.data_ptr()), bcap,
            pptr, pdt, bptr, bdt, len(pvals), mode,
            ctypes.c_void_p(lo.data_ptr()), ctypes.c_void_p(cnt.data_ptr()),
            ctypes.c_void_p(hit.data_ptr() if hit is not None else 0),
            ctypes.c_void_p(bflag.data_ptr() if bflag is not None else 0),
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "join_probe", "join")
    join_probe.launches += 1
    join_probe.mode_launches[mode] += 1
    return lo, cnt, hit, bflag


join_probe.launches = 0
#: launches by mode (WINDOW, FIRST, LAST, ALL)
join_probe.mode_launches = [0, 0, 0, 0]


# ---------------------------------------------------------------------------
# K6 join_expand
# ---------------------------------------------------------------------------

def _join_expand_plain(counts, wcnt, lo, order, pvals, bvals, out_capacity):
    """Plain PyTorch version of the join_expand kernel: the JAX function's
    formula (cumsum, searchsorted of each pair slot)."""
    dev = counts.device
    bcap = order.shape[0]
    cum = torch.cumsum(counts, 0)
    total = cum[-1] if counts.shape[0] else torch.zeros(
        (), dtype=torch.int64, device=dev)
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    valid = j < total
    p = torch.where(valid, torch.searchsorted(cum, j, right=True), 0)
    k = j - (cum[p] - counts[p])
    real = valid & (k < wcnt[p])
    bpos = (lo[p] + k).clamp(0, max(bcap - 1, 0))
    b = torch.where(valid, order[bpos], 0)
    bvalid = real & _keys_equal_plain(pvals, bvals, p, b)
    return p, b, bvalid, total


def join_expand(counts: torch.Tensor, wcnt: torch.Tensor, lo: torch.Tensor,
                order: torch.Tensor, pvals: Sequence[torch.Tensor],
                bvals: Sequence[torch.Tensor], out_capacity: int):
    """Lay out the join's (probe row, build row) pairs (kernel K6,
    csrc/join.cu).

    Probe row i owns `counts[i]` pair slots, in probe order; the first
    `wcnt[i]` of them are its window's candidates, sorted positions
    `lo[i]`, `lo[i] + 1`, ...; the rest (a LEFT join's one slot for a
    probe row without candidates) are null extensions. For every slot
    j < out_capacity returns its probe row `pidx[j]`, build row
    `bidx[j]` and `bvalid[j]`: a real candidate whose keys equal the
    probe's. Slots at or past the total hold 0, 0, False. `total` (0-d,
    on the device) is the sum of `counts`, unclamped, so the caller can
    see an overflow.

    On CPU tensors the plain version; on CUDA tensors the kernel, whose
    prefix sum and slot layout take scratch of the size its library's
    `join_expand_scratch_words` gives."""
    dev = counts.device
    for t in (counts, wcnt, lo, order):
        if t.dtype != torch.int64 or t.dim() != 1 or t.device != dev:
            raise TypeError("join_expand: counts, windows and order must "
                            "be 1-d int64 on one device")
    if dev.type == "cpu":
        return _join_expand_plain(counts, wcnt, lo, order, pvals, bvals,
                                  out_capacity)
    if dev.type != "cuda":
        raise RuntimeError(f"join_expand: no kernel for {dev}")
    from presto_tpu_torch import native
    counts, wcnt, lo, order = (t.contiguous()
                               for t in (counts, wcnt, lo, order))
    pvals = [v.contiguous() for v in pvals]
    bvals = [v.contiguous() for v in bvals]
    pptr, pdt = lane_arrays(pvals)
    bptr, bdt = lane_arrays(bvals)
    n = counts.shape[0]
    lib = native.load("join")
    scratch = torch.empty(lib.join_expand_scratch_words(n, out_capacity),
                          dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    pidx = torch.empty(out_capacity, dtype=torch.int64, device=dev)
    bidx = torch.empty(out_capacity, dtype=torch.int64, device=dev)
    bvalid = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.join_expand(
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(wcnt.data_ptr()), ctypes.c_void_p(lo.data_ptr()),
            n, ctypes.c_void_p(order.data_ptr()), order.shape[0],
            pptr, pdt, bptr, bdt, len(pvals), out_capacity,
            ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(total.data_ptr()),
            ctypes.c_void_p(pidx.data_ptr()),
            ctypes.c_void_p(bidx.data_ptr()),
            ctypes.c_void_p(bvalid.data_ptr()), ctypes.c_void_p(stream))
    native.check(rc, "join_expand", "join")
    join_expand.launches += 1
    return pidx, bidx, bvalid, total


join_expand.launches = 0


# ---------------------------------------------------------------------------
# the joins
# ---------------------------------------------------------------------------

def _sorted_build(probe: Page, build: Page, pcols, bcols,
                  p_ok: torch.Tensor, b_ok: torch.Tensor):
    """Key hashes with the dead/null sentinels, and the build side sorted
    stably by hash: (ph, bh, bh_sorted, order)."""
    if pcols:
        ph = hash_columns(pcols)
        bh = hash_columns(bcols)
    else:   # cross join: one constant key
        ph = torch.zeros(probe.capacity, dtype=torch.int64,
                         device=probe.device)
        bh = torch.zeros(build.capacity, dtype=torch.int64,
                         device=build.device)
    ph = torch.where(p_ok, ph, -1)
    bh = torch.where(b_ok, bh, -2)
    bh_sorted, order = torch.sort(bh, stable=True)
    return ph, bh, bh_sorted, order


def _dup_candidates(bh_sorted: torch.Tensor,
                    order: torch.Tensor) -> torch.Tensor:
    """Build rows (in row order) that may duplicate an earlier row's key:
    present rows whose sorted predecessor has the same hash. An earlier
    key-equal present row has an equal hash and, the sort being stable,
    an earlier position in the same window, so every duplicate is a
    candidate. Probing only the candidates against the build side (K5
    FIRST: a candidate is a duplicate where its first key-equal row is
    another row) gives the exact count, and a build side of unique keys
    has none to walk."""
    same = torch.zeros_like(bh_sorted, dtype=torch.bool)
    same[1:] = (bh_sorted[1:] == bh_sorted[:-1]) & (bh_sorted[1:] >= 0)
    cand = torch.empty_like(same)
    cand[order] = same
    return cand


def _dup_count(bh, bh_sorted, order, bvals) -> torch.Tensor:
    """Present build rows whose key equals an earlier present row's (0-d
    int64): the candidates probed against the build side."""
    cand = _dup_candidates(bh_sorted, order)
    _lo, _cnt, first, _ = join_probe(torch.where(cand, bh, -1), bh_sorted,
                                     order, bvals, bvals, FIRST)
    rows = torch.arange(bh.shape[0], dtype=torch.int64, device=bh.device)
    return (cand & (first != rows)).sum(dtype=torch.int64)


def _flag_page(probe: Page, flag: torch.Tensor) -> Page:
    col = Column(flag, torch.zeros_like(flag), BOOLEAN, None)
    return Page(probe.columns + (col,), probe.num_rows, ())


def merge_join(probe: Page, build: Page,
               probe_fields: Sequence[int], build_fields: Sequence[int],
               join_type: str = "inner",
               ) -> Tuple[Page, torch.Tensor, Optional[torch.Tensor]]:
    """Join for UNIQUE build keys (+ semi/anti/anti_exists, where
    duplicates cannot change the answer): presto_tpu/ops/join.py:45.

    Returns (page, dup_count, match). `dup_count` (0-d int64) counts the
    present build rows whose key equals an earlier present build row's:
    > 0 means inner/left/full must fall back to `hash_join`. Semi, anti
    and anti_exists return None for it: duplicates cannot change their
    flags, so nothing reads it and it is not computed. `match` is the
    per-probe-row match flag for left/full (None otherwise). Output:
    probe cols ++ build cols (inner compacted; full appends the unmatched
    build rows null-extended), or probe cols ++ match flag (semi, anti,
    anti_exists).

    Each probe row takes the LAST key-equal build row of its hash window,
    which with duplicates is the one of highest row index: the row the
    JAX function's forward fill lands on. The dup count probes the build
    side against itself (`_dup_candidates`)."""
    pcap, bcap = probe.capacity, build.capacity
    dev = probe.device
    pcols, bcols = _aligned_keys(probe, build, probe_fields, build_fields)
    p_null = _any_null(pcols, pcap, dev)
    b_null = _any_null(bcols, bcap, dev)
    b_present = build.row_valid() & ~b_null
    p_live = probe.row_valid()
    ph, bh, bh_sorted, order = _sorted_build(
        probe, build, pcols, bcols, p_live & ~p_null, b_present)
    pvals = [c.values for c in pcols]
    bvals = [c.values for c in bcols]

    mode = ALL if join_type == "full" else LAST
    _lo, _cnt, hit, bflag = join_probe(ph, bh_sorted, order, pvals, bvals,
                                       mode)
    match_p = hit >= 0

    if join_type in ("semi", "anti", "anti_exists"):
        if join_type == "semi":
            flag = match_p
        elif join_type == "anti_exists":
            flag = ~match_p & p_live
        else:
            b_has_null = (b_null & build.row_valid()).any()
            flag = ~match_p & ~p_null & ~b_has_null & p_live
        return _flag_page(probe, flag), None, None

    dup_count = _dup_count(bh, bh_sorted, order, bvals)

    bidx = torch.where(match_p, hit, 0)
    out_cols = list(probe.columns)
    for c in build.columns:
        out_cols.append(c.gather(bidx, match_p))
    page = Page(tuple(out_cols), probe.num_rows, ())
    if join_type == "left":
        return page, dup_count, match_p
    if join_type == "full":
        unmatched = build.row_valid() & ~bflag
        return full_outer_append(page, probe, build, unmatched), \
            dup_count, match_p
    return compact(page, match_p), dup_count, None


def full_outer_append(left_page: Page, probe: Page, build: Page,
                      unmatched_build: torch.Tensor) -> Page:
    """Append unmatched build rows (probe side null) to a left-join page
    (presto_tpu/ops/join.py:209). Output capacity = pcap + bcap,
    survivors compacted (K2)."""
    pcap, bcap = probe.capacity, build.capacity
    dev = probe.device
    cols = []
    for i, c in enumerate(left_page.columns):
        if i < len(probe.columns):
            t = probe.columns[i].type
            pad = torch.full((bcap,), t.null_sentinel(),
                             dtype=c.values.dtype, device=dev)
            vals = torch.cat([c.values, pad])
            nulls = torch.cat([c.nulls, torch.ones(
                bcap, dtype=torch.bool, device=dev)])
        else:
            b = build.columns[i - len(probe.columns)]
            vals = torch.cat([c.values, b.values])
            nulls = torch.cat([c.nulls, b.nulls])
        cols.append(Column(vals, nulls, c.type, c.dictionary))
    keep = torch.cat([
        torch.arange(pcap, dtype=torch.int64, device=dev)
        < left_page.num_rows, unmatched_build])
    page = Page(tuple(cols), torch.tensor(pcap + bcap, dtype=torch.int64,
                                          device=dev), ())
    return compact(page, keep)


def hash_join(probe: Page, build: Page,
              probe_fields: Sequence[int], build_fields: Sequence[int],
              out_capacity: int, join_type: str = "inner",
              ) -> Tuple[Page, torch.Tensor]:
    """Join probe x build (presto_tpu/ops/join.py:237). Output columns =
    probe columns ++ build columns (semi/anti/anti_exists: probe columns
    ++ match flag). Returns (page, total_pairs): total_pairs (0-d int64)
    > out_capacity means the page overflowed and the caller re-runs at a
    larger capacity. join_type: inner | left | semi | anti | anti_exists.

    Pairs come in (probe row, sorted build position) order, as in the JAX
    function. A LEFT join null-extends every non-matching candidate of a
    window, as the JAX function does: without a 63-bit hash collision
    that is one row per probe row without a match."""
    pcap = probe.capacity
    dev = probe.device
    if probe_fields:
        pcols, bcols = _aligned_keys(probe, build, probe_fields,
                                     build_fields)
    else:
        pcols, bcols = [], []
    p_null = _any_null(pcols, pcap, dev)
    b_null = _any_null(bcols, build.capacity, dev)
    p_live = probe.row_valid() & ~p_null
    b_live = build.row_valid() & ~b_null
    ph, _bh, bh_sorted, order = _sorted_build(probe, build, pcols, bcols,
                                              p_live, b_live)
    pvals = [c.values for c in pcols]
    bvals = [c.values for c in bcols]

    if join_type in ("semi", "anti", "anti_exists"):
        # any true key match in the window (the JAX function's
        # _window_any_match, :351): K5 walking forward to the first match
        _lo, cnt, hit, _ = join_probe(ph, bh_sorted, order, pvals, bvals,
                                      FIRST)
        matched = hit >= 0
        if join_type == "semi":
            flag = matched
        elif join_type == "anti_exists":
            flag = ~matched
        else:
            b_has_null = (b_null & build.row_valid()).any()
            flag = ~matched & ~p_null & ~b_has_null
        return _flag_page(probe, flag), cnt.sum()

    lo, cnt, _, _ = join_probe(ph, bh_sorted, order, pvals, bvals, WINDOW)
    counts = cnt
    if join_type == "left":
        # rows with no candidate still emit one null-extended pair
        counts = torch.where(probe.row_valid(), cnt.clamp(min=1), cnt)
    pidx, bidx, bvalid, total = join_expand(counts, cnt, lo, order, pvals,
                                            bvals, out_capacity)
    if join_type == "inner":
        keep = bvalid
    else:
        keep = torch.arange(out_capacity, dtype=torch.int64,
                            device=dev) < total
    perm, n = compact_indices(keep)
    valid = torch.arange(out_capacity, dtype=torch.int64, device=dev) < n
    pidx, bidx = pidx[perm], bidx[perm]
    bvalid = bvalid[perm] & valid
    out_cols: List[Column] = [c.gather(pidx, valid) for c in probe.columns]
    out_cols += [c.gather(bidx, bvalid) for c in build.columns]
    return Page(tuple(out_cols), n, ()), total
