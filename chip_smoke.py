#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 2;
  2. build every kernel of the port from presto_tpu_torch/csrc with nvcc;
  3. generate the TPC-H SF1 tables on the host; each kernel (K1
     direct_agg, K2 compact_indices, K3 segment_reduce, K4 hash_columns,
     K5 join_probe, K6 join_expand) at the shapes TPC-H SF1 gives it on
     the main path (K1-K3 on seeded numpy data; K4-K6 on q13's join of
     customer with orders), held against its plain PyTorch version on the
     card (counts, indices, hashes, join pairs, min and max exact; float64
     sums within 1e-9 relative, since the kernels sum in another order),
     and timed with CUDA events beside the plain version, one PyTorch
     library call (none for K4) and the card's bound; K5 also in the
     merge join's modes (q18's probe of lineitem into orders, the dup
     count's self-probe), printed on a line of their own;
  4. the main path at SF1: LocalEngine(TpchConnector(1.0)) on the card runs
     TPC-H q01, q06, the q18 aggregation block (having sum > 300), q03,
     q04, q13, q18, q21 and q22, each cold and warm; the cold run's rows
     are held against the warm run's, and the warm run's against the
     same engine on the CPU and, for q01, q06, the q18 block,
     q03, q04, q13 and q18, against an independent numpy computation over
     the generated tables; every kernel must have been launched here;
  5. all 22 TPC-H queries at SF 0.01 on the card, cold and warm, the rows
     of both runs held against sqlite over the same generated tables
     (presto_tpu_torch/testing/sqlite_oracle.py);
     every kernel must have been launched here too.

The JSON kernel report is printed two lines before the end, then the
card's name and power limit, then {"ok": true, "device": {...}} as the
last line. Imports nothing of JAX or presto_tpu.
"""

from __future__ import annotations

import datetime
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def tpch_queries() -> dict:
    """The 22 TPC-H queries of tests/tpch_queries.py (number -> SQL),
    loaded by path: the name `tests` may belong to an installed
    package."""
    path = Path(__file__).resolve().parent / "tests" / "tpch_queries.py"
    spec = importlib.util.spec_from_file_location("tpch_queries", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.QUERIES

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
RTOL_SUM = 1e-9
SF = 1.0                           # TPC-H scale factor of the main path
REPEAT = 20                        # timed launches per kernel
LEAD_CYCLES = 200_000_000          # card cycles spun before a timed window
SEED = 0                           # seed of the kernels' numpy inputs

Q18_BLOCK = """
select l_orderkey, sum(l_quantity)
from lineitem
group by l_orderkey
having sum(l_quantity) > 300
"""

SQLITE_SF = 0.01                   # scale factor of the sqlite phase


def main_queries() -> dict:
    """The main path's queries: name -> (SQL, whether its rows come in a
    defined order)."""
    tpch = tpch_queries()
    return {name: (sql, "order by" in sql.lower()) for name, sql in [
        ("q01", tpch[1]), ("q06", tpch[6]), ("q18_block", Q18_BLOCK),
        ("q03", tpch[3]), ("q04", tpch[4]), ("q13", tpch[13]),
        ("q18", tpch[18]), ("q21", tpch[21]), ("q22", tpch[22])]}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_time_ms(fn, repeat: int) -> float:
    """Mean milliseconds per call over `repeat` warm calls (CUDA events).
    A spin kernel ahead of the timed window keeps the card busy while the
    host enqueues the calls, so the events see the calls' device work back
    to back and not the wrappers' host dispatch, which is as long as a
    small kernel. A call that synchronises still waits for the card."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def exact(a, b) -> bool:
    """Equal element for element, NaN equal to NaN."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def close(a, b, rtol: float) -> float:
    """Max abs difference of two tensors; fails beyond rtol relative."""
    import torch
    a = a.double().cpu()
    b = b.double().cpu()
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan, 0.0, (a - b).abs())
    same_inf = torch.isinf(a) & (a == b)
    diff = torch.where(same_inf, 0.0, diff)
    lim = rtol * torch.clamp(b.abs(), min=1.0)
    if bool((diff > lim).any()) or bool(torch.isnan(diff).any()):
        fail(f"kernel and plain version differ: max abs {diff.max()}")
    return float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_direct_agg(rng, dev, repeat):
    """K1 at q01's SF1 shape: 6.0M rows in an 8M-row page, two dictionary
    keys (3 and 2 codes), the fused filter mask, five float64 inputs."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    cap, n = 8_388_608, 6_001_215
    keys_np = [rng.integers(0, 3, cap).astype(np.int32),
               rng.integers(0, 2, cap).astype(np.int32)]
    keys = [(torch.from_numpy(k).to(dev),
             torch.zeros(cap, dtype=torch.bool, device=dev))
            for k in keys_np]
    mask = torch.from_numpy(rng.random(cap) < 0.986).to(dev)
    inputs = [(torch.from_numpy(rng.random(cap) * scale).to(dev),
               torch.zeros(cap, dtype=torch.bool, device=dev), A.WANT_SUM)
              for scale in (50.0, 1e5, 1e5, 1e5, 0.1)]
    num_rows = torch.tensor(n, dtype=torch.int64, device=dev)
    domains = [3, 2]

    def kernel():
        return A.direct_agg(cap, num_rows, keys, domains, inputs, mask)

    def plain():
        return A._direct_agg_plain(cap, num_rows, keys, domains, inputs,
                                   mask)

    k, p = kernel(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for name in ("rows", "cnt"):
        if not exact(k[name], p[name]):
            fail(f"direct_agg {name} differs from the plain version")
    err = max(err, close(k["fsum"], p["fsum"], RTOL_SUM))
    # min/max exact, on a separate call with one min/max input
    mm_in = [(inputs[0][0], inputs[0][1], A.WANT_MINMAX)]
    km = A.direct_agg(cap, num_rows, keys, domains, mm_in, mask)
    pm = A._direct_agg_plain(cap, num_rows, keys, domains, mm_in, mask)
    for name in ("mn", "mx", "cnt"):
        if not exact(km[name].view(torch.float64),
                     pm[name].view(torch.float64)):
            fail(f"direct_agg {name} differs from the plain version")
    # the library yardstick: one weighted bincount per input over a
    # precomputed bin code (the code and mask are not part of its time)
    code = (keys[0][0].long() * 3 + keys[1][0].long())
    live = mask & (torch.arange(cap, device=dev) < n)
    code = torch.where(live, code, 12)
    weights = [torch.where(live, v, 0.0) for v, _nl, _w in inputs]

    def library():
        for w in weights:
            torch.bincount(code, weights=w, minlength=13)
        torch.bincount(code, minlength=13)

    live_rows = int(live.sum())
    # bytes the function needs: keys (int32 + null flag) and the mask for
    # each valid row; each input's value and null flag for each live row
    nbytes = n * (2 * 5 + 1) + live_rows * len(inputs) * 9
    return {"name": "direct_agg", "route": "cuda",
            "source": "presto_tpu_torch/csrc/direct_agg.cu",
            "replaces": "presto_tpu/ops/aggregate.py:145",
            "max_abs_err": err,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": cuda_time_ms(library, repeat)}


def kernel_compact(rng, dev, repeat):
    """K2 at the q18 block's SF1 shape: group starts over an 8M-row
    sorted page (6.0M valid rows, 1.5M group starts); checked also at the
    HAVING filter's shape (1.5M groups in a 2M-row page)."""
    import torch
    from presto_tpu_torch.data import column as C
    cap, n = 8_388_608, 6_001_215
    lines = rng.integers(1, 8, 1_500_000)
    starts = np.concatenate([[0], np.cumsum(lines)[:-1]])
    starts = starts[starts < n]
    flags_np = np.zeros(cap, dtype=bool)
    flags_np[starts] = True
    keep = torch.from_numpy(flags_np).to(dev)

    def kernel():
        return C.compact_indices(keep)

    def plain():
        return C._compact_indices_plain(keep, None)

    (kp, kc), (pp, pc) = kernel(), plain()
    if not (exact(kp, pp) and exact(kc, pc)):
        fail("compact_indices differs from the plain version (8M flags)")
    g_cap, g_n = 2_097_152, 1_500_000
    keep2 = torch.from_numpy(rng.random(g_cap) < 0.0004).to(dev)
    nr2 = torch.tensor(g_n, dtype=torch.int64, device=dev)
    (kp2, kc2) = C.compact_indices(keep2, nr2)
    (pp2, pc2) = C._compact_indices_plain(keep2, nr2)
    if not (exact(kp2, pp2) and exact(kc2, pc2)):
        fail("compact_indices differs from the plain version (HAVING)")

    def library():
        torch.nonzero(keep)

    return {"name": "compact_indices", "route": "cuda",
            "source": "presto_tpu_torch/csrc/compact.cu",
            "replaces": "presto_tpu/data/column.py:760",
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, repeat),
            # keep read once (1 B/row), the permutation written (8 B/row)
            "bound_ms": cap * 9 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": cuda_time_ms(library, repeat)}


def kernel_segment_reduce(rng, dev, repeat):
    """K3 at the q18 block's SF1 shape: float64 l_quantity sorted by
    order key, 1.5M segments of 1-7 rows among 2M segment slots."""
    import torch
    from presto_tpu_torch.ops import scan as S
    cap, g_cap = 8_388_608, 2_097_152
    lines = rng.integers(1, 8, 1_500_000)
    ends_np = np.cumsum(lines)
    starts_np = ends_np - lines
    n = int(ends_np[-1])
    pad = g_cap - len(lines)
    starts = torch.from_numpy(np.concatenate(
        [starts_np, np.full(pad, n)])).to(dev)
    ends = torch.from_numpy(np.concatenate(
        [ends_np, np.full(pad, n)])).to(dev)
    vals = torch.from_numpy(rng.integers(1, 51, cap).astype(np.float64)
                            ).to(dev)
    live = torch.arange(cap, device=dev) < n

    def kernel():
        return S.segment_reduce(vals, live, starts, ends, S.WANT_SUM)

    def plain():
        return S._segment_reduce_plain(vals, live, starts, ends, S.WANT_SUM)

    k, p = kernel(), plain()
    if not exact(k["cnt"], p["cnt"]):
        fail("segment_reduce counts differ from the plain version")
    err = close(k["fsum"], p["fsum"], RTOL_SUM)
    km = S.segment_reduce(vals, live, starts, ends, S.WANT_MINMAX)
    pm = S._segment_reduce_plain(vals, live, starts, ends, S.WANT_MINMAX)
    for name in ("min", "max"):
        if not exact(km[name], pm[name]):
            fail(f"segment_reduce {name} differs from the plain version")
    lengths = torch.from_numpy(lines).to(dev)
    data = vals[:n]

    def library():
        torch.segment_reduce(data, "sum", lengths=lengths)

    # values and live flags of the segmented rows, starts/ends read,
    # counts and sums written
    nbytes = n * 9 + g_cap * 16 + g_cap * 16
    return {"name": "segment_reduce", "route": "cuda",
            "source": "presto_tpu_torch/csrc/segment_reduce.cu",
            "replaces": "presto_tpu/ops/scan.py:160",
            "max_abs_err": err,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": cuda_time_ms(library, repeat)}


def _q13_join_inputs(conn, dev):
    """The inputs of q13's join at SF1: customer (150,000 rows in a
    262,144-row page) probes orders on custkey (1.5M rows in a
    2,097,152-row page), as key columns on the card."""
    cust = conn.table("customer").page(["c_custkey"], device=dev)
    orders = conn.table("orders").page(["o_custkey"], device=dev)
    return cust, orders


def _sorted_build(probe, build):
    """Key hashes (K4) with the dead-row sentinels and the build side
    sorted by hash, as ops/join prepares them: (ph, bh_sorted, order)."""
    from presto_tpu_torch.ops import join as J
    ph, _bh, bh_sorted, order = J._sorted_build(
        probe, build, list(probe.columns), list(build.columns),
        probe.row_valid(), build.row_valid())
    return ph, bh_sorted, order


def kernel_hash(conn, dev, repeat):
    """K4 at q13's build shape: orders' o_custkey over a 2,097,152-row
    page (bigint keys with the page's padding NULL)."""
    from presto_tpu_torch.ops import keys as K
    _cust, orders = _q13_join_inputs(conn, dev)
    cols = list(orders.columns)

    def kernel():
        return K.hash_columns(cols)

    def plain():
        return K._hash_columns_plain(cols)

    if not exact(kernel(), plain()):
        fail("hash_columns differs from the plain version")
    cap = orders.capacity
    return {"name": "hash_columns", "route": "cuda",
            "source": "presto_tpu_torch/csrc/hash.cu",
            "replaces": "presto_tpu/ops/keys.py:211",
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, repeat),
            # key value (8 B) and null flag (1 B) read, the hash written
            "bound_ms": cap * 17 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            # no single PyTorch call computes a splitmix64 combine
            "library_ms": None}


def _probe_bytes(ph, bh_sorted, order, pvals, bvals, mode, lo, cnt,
                 hit) -> int:
    """Bytes a join_probe call must move on this run's data: each probe
    hash read and its window start and count written (24 B), its hit
    written (8 B, not in WINDOW mode); the live build hashes read once
    (at most what the binary searches read); for a walk, the key lanes
    of the probe rows with a window, and the build row and key lanes of
    every sorted position that some walk reaches: from the window's
    start to its first match (FIRST), from its end back to its last match
    (LAST), or all of it where no key matches."""
    import torch
    from presto_tpu_torch.ops import join as J
    p, b = ph.shape[0], bh_sorted.shape[0]
    nbytes = p * 24 + int((bh_sorted >= 0).sum()) * 8
    if mode == J.WINDOW:
        return nbytes
    live = cnt > 0
    nbytes += p * 8 + int(live.sum()) * sum(v.element_size() for v in pvals)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(b, dtype=torch.int64, device=order.device)
    at = pos[hit.clamp(min=0)]
    if mode == J.FIRST:
        first, last = lo, torch.where(hit >= 0, at + 1, lo + cnt)
    else:
        first, last = torch.where(hit >= 0, at, lo), lo + cnt
    edge = torch.zeros(b + 1, dtype=torch.int64, device=order.device)
    one = torch.ones(int(live.sum()), dtype=torch.int64, device=order.device)
    edge.index_add_(0, first[live], one)
    edge.index_add_(0, last[live], -one)
    walked = int((edge.cumsum(0)[:b] > 0).sum())
    return nbytes + walked * (8 + sum(v.element_size() for v in bvals))


def _probe_case(what, ph, bh_sorted, order, pvals, bvals, mode,
                repeat) -> dict:
    """One join_probe call held against its plain version (exact) and
    timed beside it and its bound."""
    from presto_tpu_torch.ops import join as J

    def kernel():
        return J.join_probe(ph, bh_sorted, order, pvals, bvals, mode)

    def plain():
        return J._join_probe_plain(ph, bh_sorted, order, pvals, bvals, mode)

    got, want = kernel(), plain()
    for g, w in zip(got, want):
        if (g is None) != (w is None) or (w is not None and not exact(g, w)):
            fail(f"join_probe ({what}) differs from the plain version")
    lo, cnt, hit, _ = got
    nbytes = _probe_bytes(ph, bh_sorted, order, pvals, bvals, mode, lo, cnt,
                          hit)
    return {"case": what, "mode": ("WINDOW", "FIRST", "LAST", "ALL")[mode],
            "probe_rows": ph.shape[0], "build_rows": bh_sorted.shape[0],
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def kernel_join_probe(conn, dev, repeat):
    """K5 at q13's shape: 262,144 customer probe rows into the 2,097,152
    hash-sorted orders rows; every mode held against the plain version.
    The kernel line's time is that WINDOW probe (the expansion join's),
    beside torch.searchsorted. The merge path's calls are timed too and
    printed on their own line: q18's LAST probe of lineitem (8,388,608
    rows) into orders on orderkey, and the dup count's FIRST self-probe
    of the build side's candidates, on orders by orderkey (unique keys:
    no candidates) and by custkey (q13's build: most rows are)."""
    import torch
    from presto_tpu_torch.ops import join as J
    cust, orders = _q13_join_inputs(conn, dev)
    ph, bh_sorted, order = _sorted_build(cust, orders)
    pvals = [cust.columns[0].values]
    bvals = [orders.columns[0].values]
    for mode in (J.FIRST, J.LAST, J.ALL):
        got = J.join_probe(ph, bh_sorted, order, pvals, bvals, mode)
        want = J._join_probe_plain(ph, bh_sorted, order, pvals, bvals, mode)
        for g, w in zip(got, want):
            if (g is None) != (w is None) or (
                    w is not None and not exact(g, w)):
                fail(f"join_probe (mode {mode}) differs from the plain "
                     f"version")
    window = _probe_case("q13 customer x orders", ph, bh_sorted, order,
                         pvals, bvals, J.WINDOW, repeat)

    def library():
        torch.searchsorted(bh_sorted, ph, side="left")
        torch.searchsorted(bh_sorted, ph, side="right")

    line = conn.table("lineitem").page(["l_orderkey"], device=dev)
    okeys = conn.table("orders").page(["o_orderkey"], device=dev)
    lph, lbh_sorted, lorder = _sorted_build(line, okeys)
    modes = [_probe_case("q18 lineitem x orders", lph, lbh_sorted, lorder,
                         [line.columns[0].values],
                         [okeys.columns[0].values], J.LAST, repeat)]
    for what, page in (("orders by orderkey", okeys),
                       ("orders by custkey", orders)):
        _ph, bh, bs, order_ = J._sorted_build(
            page, page, [page.columns[0]], [page.columns[0]],
            page.row_valid(), page.row_valid())
        cand = J._dup_candidates(bs, order_)
        vals = [page.columns[0].values]
        modes.append(_probe_case(
            f"dup count of {what} ({int(cand.sum())} candidates)",
            torch.where(cand, bh, -1), bs, order_, vals, vals, J.FIRST,
            repeat))
    print("join_probe modes on the merge path: " + json.dumps(modes),
          flush=True)
    return {"name": "join_probe", "route": "cuda",
            "source": "presto_tpu_torch/csrc/join.cu",
            "replaces": "presto_tpu/ops/join.py:45",
            "max_abs_err": 0.0,
            "ms": window["ms"],
            "plain_ms": window["plain_ms"],
            # probe hashes read, window start and count written, the live
            # build hashes read once; the build hashes (16.8 MB) stay in
            # the 50 MB L2 cache across the timed calls
            "bound_ms": window["bound_ms"],
            "bound_by": "bytes",
            "library_ms": cuda_time_ms(library, repeat)}


def kernel_join_expand(conn, dev, repeat):
    """K6 at q13's shape: the LEFT join's pairs of 150,000 customers with
    their orders (one null-extended pair for a customer without one), at
    the capacity the executor learns for them."""
    import torch
    from presto_tpu_torch.data.column import bucket_capacity
    from presto_tpu_torch.ops import join as J
    cust, orders = _q13_join_inputs(conn, dev)
    ph, bh_sorted, order = _sorted_build(cust, orders)
    pvals = [cust.columns[0].values]
    bvals = [orders.columns[0].values]
    lo, cnt, _, _ = J.join_probe(ph, bh_sorted, order, pvals, bvals,
                                 J.WINDOW)
    counts = torch.where(cust.row_valid(), cnt.clamp(min=1), cnt)
    total = int(counts.sum())
    out_cap = bucket_capacity(total)
    args = (counts, cnt, lo, order, pvals, bvals, out_cap)

    def kernel():
        return J.join_expand(*args)

    def plain():
        return J._join_expand_plain(*args)

    got, want = kernel(), plain()
    for g, w in zip(got, want):
        if not exact(g, w):
            fail("join_expand differs from the plain version")
    if int(got[3]) != total:
        fail("join_expand's total differs from the sum of the counts")
    print(f"join_expand at q13's shape: {total} pairs in a capacity of "
          f"{out_cap}", flush=True)
    probe_rows = torch.arange(counts.shape[0], device=dev)

    def library():
        torch.repeat_interleave(probe_rows, counts, output_size=total)

    p = counts.shape[0]
    # counts, windows and starts read once (24 B/row) with the probe key
    # (8 B/row); per pair the sorted position's build row and its key
    # (16 B); per pair slot the probe row, build row and flag written
    nbytes = p * 32 + total * 16 + out_cap * 17
    return {"name": "join_expand", "route": "cuda",
            "source": "presto_tpu_torch/csrc/join.cu",
            "replaces": "presto_tpu/ops/join.py:237",
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, repeat),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": cuda_time_ms(library, repeat)}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _days(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def numpy_reference(conn) -> dict:
    """q01, q06, the q18 block, q03, q04, q13 and q18 computed with numpy
    alone over the generated tables."""
    def arrays(name):
        t = conn.table(name)
        return {c: v[:t.num_rows] for c, v in t.arrays.items()}, t.dicts

    a, ldicts = arrays("lineitem")
    o, odicts = arrays("orders")
    c, cdicts = arrays("customer")
    words = {col: ldicts[col].words for col in ("l_returnflag",
                                                "l_linestatus")}
    ship, qty = a["l_shipdate"], a["l_quantity"]
    price, disc, tax = (a["l_extendedprice"], a["l_discount"], a["l_tax"])
    out = {}
    f = ship <= _days(1998, 12, 1) - 90
    rf, ls = a["l_returnflag"][f], a["l_linestatus"][f]
    code = rf.astype(np.int64) * len(words["l_linestatus"]) + ls
    uniq, inv = np.unique(code, return_inverse=True)
    disc_price = price[f] * (1 - disc[f])
    charge = disc_price * (1 + tax[f])
    cnt = np.bincount(inv)
    sums = [np.bincount(inv, weights=w) for w in
            (qty[f], price[f], disc_price, charge)]
    avgs = [np.bincount(inv, weights=w) / cnt for w in
            (qty[f], price[f], disc[f])]
    nls = len(words["l_linestatus"])
    out["q01"] = [
        (words["l_returnflag"][u // nls], words["l_linestatus"][u % nls],
         *(float(s[i]) for s in sums), *(float(v[i]) for v in avgs),
         int(cnt[i])) for i, u in enumerate(uniq)]
    m = ((ship >= _days(1994, 1, 1)) & (ship < _days(1995, 1, 1))
         & (disc >= 5 / 100) & (disc <= 7 / 100) & (qty < 24))
    out["q06"] = [(float(np.sum(price[m] * disc[m])),)]
    okeys, inv = np.unique(a["l_orderkey"], return_inverse=True)
    tot = np.bincount(inv, weights=qty)
    sel = tot > 300
    out["q18_block"] = [(int(k), float(s)) for k, s in
                        zip(okeys[sel], tot[sel])]

    def order_rows(keys):
        """row index in orders of each order key"""
        srt = np.argsort(o["o_orderkey"])
        return srt[np.searchsorted(o["o_orderkey"][srt], keys)]

    # q03
    seg = cdicts["c_mktsegment"].words.index("BUILDING")
    day = _days(1995, 3, 15)
    om = (o["o_orderdate"] < day) & np.isin(
        o["o_custkey"], c["c_custkey"][c["c_mktsegment"] == seg])
    lm = (ship > day) & np.isin(a["l_orderkey"], o["o_orderkey"][om])
    keys, inv = np.unique(a["l_orderkey"][lm], return_inverse=True)
    rev = np.bincount(inv, weights=price[lm] * (1 - disc[lm]))
    rows = order_rows(keys)
    q03 = [(int(k), float(r), int(o["o_orderdate"][i]),
            int(o["o_shippriority"][i])) for k, r, i in zip(keys, rev, rows)]
    out["q03"] = sorted(q03, key=lambda r: (-r[1], r[2]))[:10]
    # q04
    late = np.unique(a["l_orderkey"][a["l_commitdate"] < a["l_receiptdate"]])
    om = ((o["o_orderdate"] >= _days(1993, 7, 1))
          & (o["o_orderdate"] < _days(1993, 10, 1))
          & np.isin(o["o_orderkey"], late))
    codes, counts = np.unique(o["o_orderpriority"][om], return_counts=True)
    prio = odicts["o_orderpriority"].words
    out["q04"] = [(prio[k], int(n)) for k, n in zip(codes, counts)]
    # q13: dictionary codes of the comments LIKE '%special%requests%'
    special = np.array([re.search("special.*requests", w, re.S) is not None
                        for w in odicts["o_comment"].words])
    keep = ~special[o["o_comment"]]
    per_cust = np.bincount(o["o_custkey"][keep],
                           minlength=int(c["c_custkey"].max()) + 1)
    vals, dist = np.unique(per_cust[c["c_custkey"]], return_counts=True)
    out["q13"] = sorted([(int(v), int(n)) for v, n in zip(vals, dist)],
                        key=lambda r: (-r[1], -r[0]))
    # q18
    big, big_qty = okeys[sel], tot[sel]
    rows = order_rows(big)
    cust_row = np.searchsorted(c["c_custkey"], o["o_custkey"][rows])
    names = cdicts["c_name"].words
    q18 = [(names[c["c_name"][cr]], int(c["c_custkey"][cr]), int(k),
            int(o["o_orderdate"][i]), float(o["o_totalprice"][i]), float(q))
           for k, q, i, cr in zip(big, big_qty, rows, cust_row)]
    out["q18"] = sorted(q18, key=lambda r: (-r[4], r[3]))[:100]
    return out


def rows_match(actual, expected, what: str, ordered: bool,
               rtol: float = RTOL_SUM) -> None:
    if not ordered:
        actual, expected = sorted(actual), sorted(expected)
    if len(actual) != len(expected):
        fail(f"{what}: {len(actual)} rows, expected {len(expected)}")
    for i, (a, e) in enumerate(zip(actual, expected)):
        if len(a) != len(e):
            fail(f"{what}: row {i} arity {len(a)} != {len(e)}")
        for x, y in zip(a, e):
            if isinstance(x, float) or isinstance(y, float):
                if abs(float(x) - float(y)) > rtol * max(abs(float(y)), 1.0):
                    fail(f"{what}: row {i}: {a} != {e}")
            elif x != y:
                fail(f"{what}: row {i}: {a} != {e}")


def _run_queries(engine, queries, counters, what) -> tuple:
    """Each query cold then warm on the card, with the kernels' launch
    counts set to 0 just before and read just after. Returns (rows of
    the cold and the warm run, walls, launches per query and run,
    launches in all)."""
    import torch
    rows, walls, per_query = {}, {}, {}
    for k in counters:
        k.launches = 0
    for name, (sql, _ordered) in queries.items():
        walls[name], rows[name] = [], []
        for _run in range(2):           # cold (uploads, retries), warm
            before = [k.launches for k in counters]
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows[name].append(engine.execute_sql(sql))
            walls[name].append(time.perf_counter() - t)
            per_query.setdefault(name, []).append(
                [k.launches - b for k, b in zip(counters, before)])
    launches = {k.__name__: k.launches for k in counters}
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the {what}")
    return rows, walls, per_query, launches


def main_path(conn, counters) -> dict:
    from presto_tpu_torch.exec.engine import LocalEngine

    expected = numpy_reference(conn)
    gpu = LocalEngine(conn)
    if gpu.device.type != "cuda":
        fail(f"the engine chose {gpu.device}, not the card")
    queries = main_queries()
    gpu_rows, walls, per_query, launches = _run_queries(
        gpu, queries, counters, "main path")
    for name, (_sql, ordered) in queries.items():
        cold, warm = gpu_rows[name]
        rows_match(cold, warm, f"{name} card cold vs warm", ordered)
        if name in expected:
            rows_match(warm, expected[name], f"{name} card vs numpy",
                       ordered)

    cpu = LocalEngine(conn, device="cpu")
    names = [k.__name__ for k in counters]
    for name, (sql, ordered) in queries.items():
        t = time.perf_counter()
        rows = cpu.execute_sql(sql)
        cpu_s = time.perf_counter() - t
        rows_match(gpu_rows[name][1], rows, f"{name} card vs CPU",
                   ordered)
        print(f"{name}: {len(rows)} rows; card wall cold "
              f"{walls[name][0] * 1e3:.1f} ms, warm "
              f"{walls[name][1] * 1e3:.1f} ms; CPU {cpu_s:.2f} s; "
              f"launches per run {names} cold {per_query[name][0]} "
              f"warm {per_query[name][1]}", flush=True)
    return launches


def sqlite_phase(counters) -> None:
    """All 22 TPC-H queries at SQLITE_SF on the card against sqlite."""
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.testing.sqlite_oracle import compare_rows, \
        load_tpch, to_sqlite

    conn = TpchConnector(SQLITE_SF)
    t = time.perf_counter()
    db = load_tpch(conn)
    print(f"sqlite loaded with TPC-H SF{SQLITE_SF} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    engine = LocalEngine(conn)
    queries = {f"q{q:02d}": (sql, "order by" in sql.lower())
               for q, sql in sorted(tpch_queries().items())}
    rows, walls, _per_query, launches = _run_queries(
        engine, queries, counters, f"SF{SQLITE_SF} phase")
    for name, (sql, _ordered) in queries.items():
        expected = db.execute(to_sqlite(sql)).fetchall()
        types = engine.plan_sql(sql).output_types
        try:
            for run, got in zip(("cold", "warm"), rows[name]):
                compare_rows(got, types, expected,
                             f"{name} card ({run}) vs sqlite")
        except AssertionError as e:
            fail(str(e))
        print(f"{name} SF{SQLITE_SF}: {len(rows[name][1])} rows equal "
              f"sqlite's; card wall cold {walls[name][0] * 1e3:.1f} ms, "
              f"warm {walls[name][1] * 1e3:.1f} ms", flush=True)
    print(f"SF{SQLITE_SF} launches: {launches}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import native
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.data.column import compact_indices
    from presto_tpu_torch.ops.aggregate import direct_agg
    from presto_tpu_torch.ops.join import join_expand, join_probe
    from presto_tpu_torch.ops.keys import hash_columns
    from presto_tpu_torch.ops.scan import segment_reduce

    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = native.build()
    print(f"built {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in built.items():
        for line in info["report"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    conn = TpchConnector(SF)
    t0 = time.perf_counter()
    for table in ("region", "nation", "supplier", "customer", "part",
                  "partsupp", "orders", "lineitem"):
        conn.table(table)
    n_lineitem = conn.table("lineitem").num_rows
    print(f"TPC-H SF{SF}: tables generated in "
          f"{time.perf_counter() - t0:.1f} s ({n_lineitem} lineitem rows)",
          flush=True)

    rng = np.random.default_rng(SEED)
    report = [kernel_direct_agg(rng, dev, REPEAT),
              kernel_compact(rng, dev, REPEAT),
              kernel_segment_reduce(rng, dev, REPEAT),
              kernel_hash(conn, dev, REPEAT),
              kernel_join_probe(conn, dev, REPEAT),
              kernel_join_expand(conn, dev, REPEAT)]
    torch.cuda.synchronize()
    print("kernels hold against their plain versions", flush=True)

    counters = [direct_agg, compact_indices, segment_reduce, hash_columns,
                join_probe, join_expand]
    launches = main_path(conn, counters)
    for r in report:
        r["launches"] = launches[r["name"]]
    sqlite_phase(counters)
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s",
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
