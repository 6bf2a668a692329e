"""UNNEST: flatten ARRAY/MAP columns into rows.

The port's twin of presto_tpu/ops/unnest.py (reference semantics:
operator/unnest/UnnestOperator.java with ArrayUnnester/MapUnnester). Row i
expands to the largest length over the unnest channels (0 for a NULL row
or a row past num_rows); a shorter channel is padded with nulls; the
replicated columns repeat; WITH ORDINALITY appends the 1-based position.

The layout of the output (each slot's parent row, each channel's element
index and whether it holds an element, the ordinality) is kernel K11 `unnest_expand` (csrc/unnest.cu); the gathers of the
replicated and child columns go through each column's own `gather`
(string codes keep their dictionary, DECIMAL(38) limb lanes, nested
children), as the join path gathers after K6.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch.data.column import Column, NestedColumn, Page
from presto_tpu_torch.types import BIGINT


def _unnest_expand_plain(starts: Sequence[torch.Tensor],
                         lengths: Sequence[torch.Tensor],
                         nulls: Sequence[torch.Tensor],
                         num_rows: torch.Tensor, out_capacity: int,
                         with_ordinality: bool):
    """Plain PyTorch version of the unnest_expand kernel: the JAX
    function's arithmetic (row counts, cumsum, searchsorted of each output
    slot), with dead slots written as the kernel writes them."""
    dev = num_rows.device
    cap = lengths[0].shape[0]
    nch = len(lengths)
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    if cap == 0:
        total = torch.zeros((), dtype=torch.int64, device=dev)
        zero = torch.zeros(out_capacity, dtype=torch.int64, device=dev)
        dead = torch.zeros(out_capacity, dtype=torch.bool, device=dev)
        ordv = (torch.full((out_capacity,), BIGINT.null_sentinel(),
                           dtype=torch.int64, device=dev)
                if with_ordinality else None)
        return zero, dead, zero.repeat(nch, 1), dead.repeat(nch, 1), ordv, \
            total
    valid = torch.arange(cap, dtype=torch.int64, device=dev) < num_rows
    rowlen = torch.zeros(cap, dtype=torch.int64, device=dev)
    for ln, nl in zip(lengths, nulls):
        rowlen = torch.maximum(rowlen, torch.where(nl | ~valid, 0,
                                                   ln.long()))
    cum = torch.cumsum(rowlen, 0)
    total = cum[-1]
    out_valid = j < total
    parent = torch.where(out_valid,
                         torch.searchsorted(cum, j, right=True).clamp(
                             max=cap - 1), 0)
    prev = torch.where(parent > 0, cum[(parent - 1).clamp(min=0)], 0)
    within = torch.where(out_valid, j - prev, 0)
    eidx = torch.stack([torch.where(out_valid, st.long()[parent] + within, 0)
                        for st in starts])
    ok = torch.stack([out_valid & (within < ln.long()[parent]) & ~nl[parent]
                      for ln, nl in zip(lengths, nulls)])
    ordv = None
    if with_ordinality:
        ordv = torch.where(out_valid, within + 1, BIGINT.null_sentinel())
    return parent, out_valid, eidx, ok, ordv, total


def unnest_expand(starts: Sequence[torch.Tensor],
                  lengths: Sequence[torch.Tensor],
                  nulls: Sequence[torch.Tensor], num_rows: torch.Tensor,
                  out_capacity: int, with_ordinality: bool):
    """The output layout of UNNEST (kernel K11, csrc/unnest.cu). Per
    channel c: `starts[c]`, `lengths[c]` (int32) and
    `nulls[c]` (bool), one entry per source row; `num_rows` is the page's
    0-d int64 row count.

    Row i owns max_c(lengths[c][i], 0 where nulls[c][i] or i >= num_rows)
    output slots, in row order; slot j's position within its row is
    `within`. For every slot j < out_capacity returns `parent[j]` (its
    source row), `out_valid[j]` (j < total), per channel `eidx[c, j]` =
    starts[c] of the parent + within and `entry_ok[c, j]` (a live slot
    inside the channel's own length, on a non-NULL row), the 1-based
    ordinality within + 1 (BIGINT null sentinel on dead slots) when
    asked, else None, and `total` (0-d int64 on the device, unclamped, so
    the caller can see an overflow). Dead slots (j >= total) hold 0 and
    False.

    On CPU tensors the plain version; on CUDA tensors the kernel."""
    nch = len(lengths)
    if nch < 1 or len(starts) != nch or len(nulls) != nch:
        raise ValueError(f"unnest_expand: one or more channels of starts, "
                         f"lengths and nulls, got {len(starts)}, {nch} and "
                         f"{len(nulls)}")
    dev = num_rows.device
    cap = lengths[0].shape[0]
    for st, ln, nl in zip(starts, lengths, nulls):
        if (st.dtype != torch.int32 or ln.dtype != torch.int32
                or nl.dtype != torch.bool or st.shape != (cap,)
                or ln.shape != (cap,) or nl.shape != (cap,)
                or st.device != dev or ln.device != dev
                or nl.device != dev):
            raise TypeError("unnest_expand: starts and lengths must be "
                            "int32 and nulls bool, 1-d of one length, on "
                            "num_rows' device")
    if num_rows.dtype != torch.int64 or num_rows.numel() != 1:
        raise TypeError("unnest_expand: num_rows must be a 0-d int64 "
                        "tensor")
    if dev.type == "cpu":
        return _unnest_expand_plain(starts, lengths, nulls, num_rows,
                                    out_capacity, with_ordinality)
    if dev.type != "cuda":
        raise RuntimeError(f"unnest_expand: no kernel for {dev}")
    from presto_tpu_torch import native
    starts = [t.contiguous() for t in starts]
    lengths = [t.contiguous() for t in lengths]
    nulls = [t.contiguous() for t in nulls]
    num_rows = num_rows.reshape(()).contiguous()
    addrs = [t.data_ptr() for t in (*starts, *lengths, *nulls)]
    ptrs = (ctypes.c_void_p * (3 * nch))(*addrs)
    # the same pointers on the card, copied from pinned memory so that the
    # copy does not wait for the stream
    chan = torch.tensor(addrs, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    lib = native.load("unnest")
    # tile status, the slot blocks' partition and the rows' prefix sums
    # (the layout: the library's own)
    scratch = torch.empty(lib.unnest_expand_scratch_words(cap, out_capacity),
                          dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    parent = torch.empty(out_capacity, dtype=torch.int64, device=dev)
    out_valid = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    eidx = torch.empty((nch, out_capacity), dtype=torch.int64, device=dev)
    ok = torch.empty((nch, out_capacity), dtype=torch.bool, device=dev)
    ordv = (torch.empty(out_capacity, dtype=torch.int64, device=dev)
            if with_ordinality else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.unnest_expand(
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.c_void_p(chan.data_ptr()), nch, cap,
            ctypes.c_void_p(num_rows.data_ptr()), out_capacity,
            BIGINT.null_sentinel(),
            ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(total.data_ptr()),
            ctypes.c_void_p(parent.data_ptr()),
            ctypes.c_void_p(out_valid.data_ptr()),
            ctypes.c_void_p(eidx.data_ptr()), ctypes.c_void_p(ok.data_ptr()),
            ctypes.c_void_p(ordv.data_ptr() if ordv is not None else 0),
            ctypes.c_void_p(stream))
    native.check(rc, "unnest_expand", "unnest")
    unnest_expand.launches += 1
    return parent, out_valid, eidx, ok, ordv, total


unnest_expand.launches = 0


def unnest_page(page: Page, replicate_fields: Tuple[int, ...],
                unnest_fields: Tuple[int, ...], out_cap: int,
                with_ordinality: bool,
                out_names: Tuple[str, ...]) -> Tuple[Page, torch.Tensor]:
    """Returns (output page, true total rows needed as a 0-d int64), as
    presto_tpu/ops/unnest.py:unnest_page (:27). Output columns: the
    replicated columns, then each channel's children (ARRAY: the element;
    MAP: key and value), then the ordinality. The page holds
    min(total, out_cap) rows; a total above out_cap is an overflow, which
    the executor re-runs at a larger capacity."""
    nested = [page.columns[f] for f in unnest_fields]
    for nc in nested:
        if not isinstance(nc, NestedColumn):
            raise TypeError("UNNEST over a non-nested column")
    parent, out_valid, eidx, ok, ordv, total = unnest_expand(
        [nc.starts for nc in nested], [nc.lengths for nc in nested],
        [nc.nulls for nc in nested], page.num_rows, out_cap,
        with_ordinality)
    cols = [page.columns[f].gather(parent, valid=out_valid)
            for f in replicate_fields]
    for c, nc in enumerate(nested):
        cols += [child.gather(eidx[c], valid=ok[c]) for child in nc.children]
    if with_ordinality:
        cols.append(Column(ordv, ~out_valid, BIGINT, None))
    return (Page(tuple(cols), torch.clamp(total, max=out_cap),
                 tuple(out_names)), total)
