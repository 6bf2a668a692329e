#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure, each printing its seconds:
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 2;
  2. build every kernel of the port from presto_tpu_torch/csrc with nvcc
     (one nvcc per source, all started together);
  3. generate the TPC-H SF1 and TPC-DS SF1 tables on the host; each
     kernel (K1 direct_agg, K2 compact_indices, K3 segment_reduce, K4
     hash_columns, K5 join_probe, K6 join_expand, K7 segmented_scan, K8
     key_change_flags, K9 window_frame) at the shapes SF1 gives it on the
     main path (K1-K3 on seeded numpy data; K4-K6 on q13's join of
     customer with orders; K7 on TPC-DS q51's largest window input and on
     orders partitioned by o_custkey; K8 and K9 on that orders page), held
     against its plain PyTorch version on the card (counts, indices,
     hashes, join pairs, flags, positions, min and max exact; float64 sums
     within 1e-9 relative, since the kernels sum in another order), and
     timed with CUDA events beside the plain version, one PyTorch library
     call where one computes the same function, and the card's bound; K5's
     merge-path modes, K7's other scans and K9's other window functions
     are printed on lines of their own;
  4. the main paths at SF1, each with the kernels' launch counts set to 0
     just before and read just after:
     a. LocalEngine(TpchConnector(1.0)) on the card runs TPC-H q01, q06,
        the q18 aggregation block (having sum > 300), q03, q04, q13, q18,
        q21 and q22, each cold and warm; the cold run's rows are held
        against the warm run's, and the warm run's against the same
        engine on the CPU and, for q01, q06, the q18 block, q03, q04, q13
        and q18, against an independent numpy computation over the
        generated tables; K1-K6 must have been launched here;
     b. the breadth path: TPC-DS q47, q51, q67, q70, q16, q75 and q97
        (LocalEngine(TpcdsConnector(1.0))) and four TPC-H SF1 queries over
        windows and a distinct mark, each cold and warm on the card, the
        warm rows held against the cold ones and against the engine on
        the CPU; K7-K9 must have been launched here;
  5. all 22 TPC-H queries at SF 0.01 and all 99 TPC-DS queries at SF
     0.002 on the card, cold and warm, and the window and grouping-set
     queries of tests/test_window_outer.py and tests/test_grouping_sets.py
     at TPC-H SF 0.01, the rows of both runs held against sqlite over the
     same generated tables (presto_tpu_torch/testing/sqlite_oracle.py);
     every kernel must have been launched here too.

The JSON kernel report is printed two lines before the end, then the
card's name and power limit, then {"ok": true, "device": {...}} as the
last line; each kernel's `launches` there is its count over the two main
paths of phase 4. Imports nothing of JAX or presto_tpu: the query lists
of the test files are read from their source with `ast`.
"""

from __future__ import annotations

import ast
import datetime
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


TESTS = Path(__file__).resolve().parent / "tests"


def _load_tests_module(name: str):
    """tests/<name>.py loaded by path: the name `tests` may belong to an
    installed package."""
    spec = importlib.util.spec_from_file_location(name, TESTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tpch_queries() -> dict:
    """The 22 TPC-H queries of tests/tpch_queries.py (number -> SQL)."""
    return _load_tests_module("tpch_queries").QUERIES


def tpcds_queries():
    """tests/tpcds_queries.py: QUERIES (number -> SQL) and the sqlite
    spellings (number -> SQL) of tests/test_tpcds.py:run_case."""
    m = _load_tests_module("tpcds_queries")
    return m.QUERIES, {22: m.Q22_SQLITE, 27: m.Q27_SQLITE,
                       **m.SQLITE_OVERRIDES}


def _literal_lists(name: str, names) -> dict:
    """Module-level list literals of tests/<name>.py, read with `ast`
    (those test modules import the JAX package, which this script may
    not)."""
    tree = ast.parse((TESTS / f"{name}.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) in names:
            out[node.targets[0].id] = ast.literal_eval(node.value)
    missing = set(names) - set(out)
    if missing:
        fail(f"tests/{name}.py has no literal {sorted(missing)}")
    return out


def breadth_sqlite_queries() -> dict:
    """name -> (SQL, sqlite SQL) of the window queries of
    tests/test_window_outer.py and the grouping-set cases of
    tests/test_grouping_sets.py (TPC-H SF 0.01)."""
    w = _literal_lists("test_window_outer", (
        "WINDOW_QUERIES", "FRAME_QUERIES", "BOUNDED_MINMAX_QUERIES"))
    g = _literal_lists("test_grouping_sets", ("CASES",))
    out = {}
    for key in ("WINDOW_QUERIES", "FRAME_QUERIES", "BOUNDED_MINMAX_QUERIES"):
        for i, sql in enumerate(w[key]):
            out[f"{key.split('_')[0].lower()}-{i}"] = (sql, sql)
    for name, sql, exp in g["CASES"]:
        out[f"grouping-{name}"] = (sql, exp)
    return out

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
TPCDS_SF = 1.0                     # TPC-DS scale factor of the breadth path
TPCDS_SQLITE_SF = 0.002            # TPC-DS scale factor of the sqlite phase
TPCDS_MAIN = (47, 51, 67, 70, 16, 75, 97)

#: TPC-H SF1 queries of the breadth path: name -> (SQL, page compared
#: column by column instead of as Python rows: millions of output rows)
TPCH_BREADTH = {
    "h_running_sum": (
        "select o_custkey, o_orderdate, o_orderkey, sum(o_totalprice) over "
        "(partition by o_custkey order by o_orderdate) from orders", True),
    "h_bounded_min": (
        "select o_orderkey, min(o_totalprice) over (order by o_orderkey "
        "rows between 3 preceding and 3 following) from orders", True),
    "h_rank": (
        "select l_orderkey, l_linenumber, rank() over (partition by "
        "l_orderkey order by l_extendedprice desc) from lineitem", True),
    "h_distinct": (
        "select l_returnflag, count(*), count(distinct l_suppkey) "
        "from lineitem group by 1", False),
}


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


def capture_windows(engine, sql: str) -> list:
    """The window_page calls (page, partition fields, order keys, specs) a
    query makes, recorded while it runs on `engine`."""
    from presto_tpu_torch.exec import executor as X
    calls = []
    orig = X.window_page

    def record(page, partition_fields, order_keys, specs):
        calls.append((page, partition_fields, order_keys, specs))
        return orig(page, partition_fields, order_keys, specs)

    X.window_page = record
    try:
        engine.execute_sql(sql)
    finally:
        X.window_page = orig
    return calls


def _orders_window(conn, dev):
    """orders at SF1 (1.5M rows in a 2,097,152-row page) partitioned by
    o_custkey and ordered by o_orderdate, as the running-sum query of the
    breadth path sorts it: (page, sorted window)."""
    from presto_tpu_torch.ops import window as W
    from presto_tpu_torch.ops.keys import SortKey
    page = conn.table("orders").page(
        ["o_custkey", "o_orderdate", "o_totalprice", "o_orderkey"],
        device=dev)
    return page, W.sort_window(page, (0,), [SortKey(1)])


def _scan_case(what, x, op, reverse, seg, repeat, library=None) -> dict:
    """One segmented_scan call held against its plain version (exact, or
    float64 sums within RTOL_SUM) and timed beside it, its bound and a
    library call where one computes the same function."""
    from presto_tpu_torch.ops import scan as S

    def kernel():
        return S.segmented_scan(x, op, reverse, seg)

    def plain():
        return S._segmented_scan_plain(x, op, reverse, seg)

    got, want = kernel(), plain()
    if op == "add" and x.dtype.is_floating_point:
        err = close(got, want, RTOL_SUM)
    else:
        if not exact(got, want):
            fail(f"segmented_scan ({what}) differs from the plain version")
        err = 0.0
    n = x.shape[0]
    # each value (or present flag) and segment flag read once, each result
    # written once
    nbytes = n * (x.element_size() + (1 if seg is not None else 0)
                  + got.element_size())
    return {"case": what, "rows": n, "max_abs_err": err,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": (cuda_time_ms(library, repeat)
                           if library is not None else None)}


def kernel_seg_scan(q51_calls, conn, dev, repeat):
    """K7 at the breadth path's SF1 shapes: the running sum and running
    max of TPC-DS q51's largest window inputs (partition by item, order by
    date, ROWS UNBOUNDED PRECEDING), the last-present-position fill of
    orders' partition starts (partition by o_custkey), and, for a library
    yardstick, the same values scanned without segments beside
    torch.cumsum and torch.cummax. The kernel line is the running sum:
    no single PyTorch call computes a segmented sum."""
    import torch
    from presto_tpu_torch.ops import window as W
    cases = []
    for kind in ("sum", "max"):
        page, pf, ok, specs = max(
            (c for c in q51_calls if any(sp.kind == kind for sp in c[3])),
            key=lambda c: int(c[0].num_rows))
        spec = next(sp for sp in specs if sp.kind == kind)
        sw = W.sort_window(page, pf, ok)
        live = sw.s_valid & ~page.columns[spec.field].nulls[sw.perm]
        v = page.columns[spec.field].values[sw.perm].to(torch.float64)
        if kind == "sum":
            x = torch.where(live, v, 0.0)
        else:
            x = torch.where(live, v, float("-inf"))
        rows = int(page.num_rows)
        cases.append(_scan_case(f"q51 running {kind} ({rows} rows)", x,
                                "add" if kind == "sum" else "max", False,
                                sw.part_start, repeat))
        if kind == "sum":
            cases.append(_scan_case(
                f"q51 {kind} values, one segment", x, "add", False, None,
                repeat, library=lambda x=x: torch.cumsum(x, 0)))
        else:
            cases.append(_scan_case(
                f"q51 {kind} values, one segment", x, "max", False, None,
                repeat, library=lambda x=x: torch.cummax(x, 0)))
    _page, sw = _orders_window(conn, dev)
    cases.append(_scan_case("orders partition starts, last present",
                            sw.part_start, "last", False, None, repeat))
    cases.append(_scan_case("orders partition ends, last present reversed",
                            sw.part_end, "last", True, None, repeat))
    print("segmented_scan cases: " + json.dumps(cases), flush=True)
    line = cases[0]
    return {"name": "segmented_scan", "route": "cuda",
            "source": "presto_tpu_torch/csrc/seg_scan.cu",
            "replaces": "presto_tpu/ops/scan.py:104",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": "bytes",
            # no single PyTorch call computes a segmented running sum
            "library_ms": None}


def kernel_key_change(conn, dev, repeat):
    """K8 at the running-sum query's SF1 shape: the partition and peer
    flags of orders (2,097,152-row page) sorted by o_custkey, o_orderdate;
    also the first flags of a distinct mark over the same keys."""
    from presto_tpu_torch.ops import keys as K
    page, sw = _orders_window(conn, dev)
    perm, keys = sw.perm, sw.keys

    def kernel():
        return K.key_change_flags(perm, keys, page.num_rows, 1,
                                  K.WINDOW_FLAGS)

    def plain():
        return K._key_change_plain(perm, keys, page.num_rows, 1,
                                   K.WINDOW_FLAGS)

    for (g, w) in zip(kernel(), plain()):
        if not exact(g, w):
            fail("key_change_flags differs from the plain version")
    first = K.key_change_flags(perm, keys, page.num_rows, 0, K.FIRST_FLAGS)
    want = K._key_change_plain(perm, keys, page.num_rows, 0, K.FIRST_FLAGS)
    if not exact(first[0], want[0]):
        fail("key_change_flags (first flags) differs from the plain version")
    cap = perm.shape[0]
    # perm read (8 B), each key's null flag and value (1 + 8 B custkey,
    # 1 + 4 B orderdate), two flags written
    nbytes = cap * (8 + 9 + 5 + 2)
    return {"name": "key_change_flags", "route": "cuda",
            "source": "presto_tpu_torch/csrc/keys.cu",
            "replaces": "presto_tpu/ops/window.py:171",
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            # no single PyTorch call compares keys across a permutation
            "library_ms": None}


def kernel_window_frame(conn, dev, repeat):
    """K9 at the running-sum query's SF1 shape, over orders partitioned by
    o_custkey and ordered by o_orderdate: rank, the running sum of
    o_totalprice (the SQL default frame, peer-aware) and the min of
    o_totalprice over ROWS 3 PRECEDING .. 3 FOLLOWING. The kernel line is
    the running sum."""
    from presto_tpu_torch.ops import window as W
    from presto_tpu_torch.types import BIGINT, DOUBLE
    page, sw = _orders_window(conn, dev)
    cap = page.capacity
    specs = [
        # (spec, int64 inputs the function reads besides perm)
        ("rank", W.WindowSpec("rank", None, BIGINT), 2),
        ("running sum", W.WindowSpec("sum", 2, DOUBLE), 4),
        ("min, 3 preceding .. 3 following",
         W.WindowSpec("min", 2, DOUBLE, frame=W.Frame(
             "rows", "preceding", 3, "following", 3)), 4),
    ]
    cases = []
    for what, spec, reads in specs:
        fi = W.frame_inputs(page, sw, spec)

        def kernel(spec=spec, fi=fi):
            return W.run_frame(page, sw, spec, fi)

        def plain(spec=spec, fi=fi):
            return W._window_frame_plain(
                spec.kind, fi.frame, fi.iparams, fi.dparams, sw.perm,
                page.num_rows, sw.ps, sw.pe, sw.qs, sw.qe, fi.vals,
                fi.nulls, fi.aux_i, fi.aux_v, fi.out_dtype)

        (gv, gn), (pv, pn) = kernel(), plain()
        if not exact(gn, pn):
            fail(f"window_frame ({what}) nulls differ from the plain version")
        err = 0.0
        if spec.kind == "sum":
            err = close(gv, pv, RTOL_SUM)
        elif not exact(gv, pv):
            fail(f"window_frame ({what}) differs from the plain version")
        # perm and `reads` int64 position or prefix arrays read (8 B
        # each), the value (8 B) and null flag written
        nbytes = cap * (8 + 8 * reads + 9)
        cases.append({"case": what, "rows": cap, "max_abs_err": err,
                      "ms": cuda_time_ms(kernel, repeat),
                      "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    print("window_frame cases: " + json.dumps(cases), flush=True)
    line = cases[1]
    return {"name": "window_frame", "route": "cuda",
            "source": "presto_tpu_torch/csrc/window.cu",
            "replaces": "presto_tpu/ops/window.py:126",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": "bytes",
            # no single PyTorch call evaluates a window frame
            "library_ms": None}


def _device_kernels(fn) -> int:
    """Device kernels one call of `fn` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type.name == "CUDA")


def _full_outer_append_row(ds_conn, repeat) -> dict:
    """full_outer_append (torch + K2) at TPC-DS q97's SF1 shape: the
    arguments of its largest call while q97 runs on the card."""
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops import join as J
    calls = []
    orig = J.full_outer_append

    def record(*args):
        calls.append(args)
        return orig(*args)

    J.full_outer_append = record
    try:
        LocalEngine(ds_conn).execute_sql(tpcds_queries()[0][97])
    finally:
        J.full_outer_append = orig
    left, probe, build, unmatched = max(
        calls, key=lambda c: c[1].capacity + c[2].capacity)

    def fn():
        return orig(left, probe, build, unmatched)

    pcap, bcap = probe.capacity, build.capacity
    width = sum(c.values.element_size() + 1 for c in left.columns)
    # the left page and the build columns read, the unmatched flags read,
    # the appended page written (values and null flags)
    nbytes = (pcap * width
              + bcap * (sum(c.values.element_size() + 1
                            for c in build.columns) + 1)
              + (pcap + bcap) * width)
    return {"stage": "full_outer_append", "shape": "q97 FULL join",
            "rows": pcap + bcap, "ms": cuda_time_ms(fn, repeat),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "device_kernels": _device_kernels(fn)}


def torch_op_rows(conn, ds_conn, dev, repeat) -> list:
    """Card times of the main path's torch-op stages that have no kernel
    of their own, at SF1 shapes, beside their bounds (bytes each input is
    read and each output written once, over HBM_BYTES_PER_S):
    - lex_perm: the window sort of the breadth path's rank over lineitem
      (8,388,608-row page: validity, l_orderkey null rank and value,
      l_extendedprice null rank and complemented value), a stable
      torch.sort per lane;
    - sort_perm: orders (2,097,152-row page) by o_totalprice desc,
      o_orderdate, the ORDER BY of q18's shape over a whole table;
    - compile_expr: q01's filter and its projections over lineitem, the
      elementwise passes its fused aggregation evaluates;
    - full_outer_append: TPC-DS q97's FULL join tail."""
    import torch
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.expr.compile import compile_expr
    from presto_tpu_torch.ops.keys import SortKey, descending, \
        group_values, lex_perm, sort_perm
    from presto_tpu_torch.plan.nodes import AggregationNode, FilterNode, \
        ProjectNode, TableScanNode
    rows = []
    li = conn.table("lineitem").page(["l_orderkey", "l_extendedprice"],
                                     device=dev)
    ok, price = li.columns
    lanes = [(~li.row_valid()).to(torch.int8), ok.nulls.to(torch.int8),
             group_values(ok), price.nulls.to(torch.int8),
             descending(price.values)]
    cap = li.capacity
    nbytes = sum(t.element_size() for t in lanes) * cap + 8 * cap
    rows.append({"stage": "lex_perm", "shape": "lineitem rank window",
                 "rows": cap, "ms": cuda_time_ms(lambda: lex_perm(lanes),
                                                 repeat),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "device_kernels": _device_kernels(lambda: lex_perm(lanes))})
    orders = conn.table("orders").page(["o_totalprice", "o_orderdate"],
                                       device=dev)
    keys = [SortKey(0, ascending=False), SortKey(1)]
    cap = orders.capacity
    # key values and null flags read, the permutation written
    nbytes = cap * ((8 + 1) + (4 + 1) + 8)
    rows.append({"stage": "sort_perm", "shape": "orders by price desc, date",
                 "rows": cap,
                 "ms": cuda_time_ms(lambda: sort_perm(orders, keys), repeat),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "device_kernels": _device_kernels(
                     lambda: sort_perm(orders, keys))})

    node = LocalEngine(conn).plan_sql(tpch_queries()[1])
    while not isinstance(node, AggregationNode):
        node = node.children()[0]
    chain, node = [], node.source      # the chain the aggregation fuses
    while not isinstance(node, TableScanNode):
        chain.append(node)
        node = node.source
    chain.reverse()
    page = conn.table(node.table).page(list(node.columns), device=dev)
    steps = [(compile_expr(n.predicate),) if isinstance(n, FilterNode)
             else tuple(compile_expr(e) for e in n.expressions)
             for n in chain]
    n_in = len(page.columns)

    def evaluate():
        p = page
        for n, fns in zip(chain, steps):
            cols = tuple(f(p) for f in fns)
            if isinstance(n, ProjectNode):
                p = type(page)(cols, p.num_rows, ())
        return p

    out = evaluate()
    cap = page.capacity
    # the scanned columns read once (values and null flags), the filter's
    # mask (1 B) and the projected columns (values and null flags)
    # written once
    nbytes = cap * (sum(c.values.element_size() + 1 for c in page.columns)
                    + 1 + sum(c.values.element_size() + 1
                              for c in out.columns[n_in:]))
    rows.append({"stage": "compile_expr", "shape": "q01 filter + project",
                 "rows": cap, "ms": cuda_time_ms(evaluate, repeat),
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "device_kernels": _device_kernels(evaluate)})
    rows.append(_full_outer_append_row(ds_conn, repeat))
    print("torch-op stages at SF1: " + json.dumps(rows), flush=True)
    return rows


class CallCounter:
    """Counts calls of the torch-op stages on the card on a main path
    (the CPU comparisons do not count): the stable key sorts of
    lex_perm/sort_perm (ops/keys._argsort, one torch.sort each), the
    evaluations of compiled expressions (exec/executor's compile_expr)
    and the FULL joins' appends (ops/join.full_outer_append)."""

    def __init__(self):
        from presto_tpu_torch.exec import executor as X
        from presto_tpu_torch.ops import keys as K
        from presto_tpu_torch.ops import join as J
        self.counts = {"key_sorts": 0, "expression_evaluations": 0,
                       "full_outer_appends": 0}
        argsort, compile_expr = K._argsort, X.compile_expr
        append = J.full_outer_append

        def counted_append(left, probe, build, unmatched):
            self.counts["full_outer_appends"] += unmatched.is_cuda
            return append(left, probe, build, unmatched)
        J.full_outer_append = counted_append

        def counted_argsort(v):
            self.counts["key_sorts"] += v.is_cuda
            return argsort(v)

        def counted_compile(expr):
            fn = compile_expr(expr)

            def run(page):
                self.counts["expression_evaluations"] += \
                    page.device.type == "cuda"
                return fn(page)
            return run

        K._argsort, X.compile_expr = counted_argsort, counted_compile

    def reset(self) -> None:
        for k in self.counts:
            self.counts[k] = 0


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


def _run_queries(engine, queries, counters, what, required=None) -> tuple:
    """Each query cold then warm on the card, with the kernels' launch
    counts set to 0 just before and read just after. Returns (rows of
    the cold and the warm run, walls, launches per query and run,
    launches in all). Fails where a kernel of `required` (names; default
    all) was not launched."""
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
        if n == 0 and (required is None or name in required):
            fail(f"kernel {name} was not launched on the {what}")
    return rows, walls, per_query, launches


def main_path(conn, counters) -> dict:
    from presto_tpu_torch.exec.engine import LocalEngine

    expected = numpy_reference(conn)
    gpu = LocalEngine(conn)
    if gpu.device.type != "cuda":
        fail(f"the engine chose {gpu.device}, not the card")
    queries = main_queries()
    required = [k.__name__ for k in counters[:6]]
    gpu_rows, walls, per_query, launches = _run_queries(
        gpu, queries, counters, "main path", required)
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


def breadth_queries(ds_engine, h_engine) -> dict:
    """The breadth path: name -> (engine, SQL, ordered, compared as a
    page)."""
    ds, _sqlite = tpcds_queries()
    out = {f"ds{q:02d}": (ds_engine, ds[q], "order by" in ds[q].lower(),
                          False) for q in TPCDS_MAIN}
    for name, (sql, as_page) in TPCH_BREADTH.items():
        out[name] = (h_engine, sql, False, as_page)
    return out


def run_query(engine, sql: str, as_page: bool):
    """A query's result: Python rows (LocalEngine.execute_sql), or for a
    query of millions of rows the executor's page, left on its device."""
    import torch
    if not as_page:
        return engine.execute_sql(sql)
    page = engine.executor.execute(engine.plan_sql(sql))
    if page.device.type == "cuda":
        torch.cuda.synchronize()
    return page


def pages_match(a, b, what: str) -> None:
    """Two pages (possibly on different devices) hold the same rows in the
    same order: nulls and integer values exact, float values within
    RTOL_SUM relative."""
    import torch
    n = int(a.num_rows)
    if n != int(b.num_rows) or len(a.columns) != len(b.columns):
        fail(f"{what}: {n} rows, expected {int(b.num_rows)}")
    for i, (ca, cb) in enumerate(zip(a.columns, b.columns)):
        na, nb = ca.nulls[:n].cpu(), cb.nulls[:n].cpu()
        if not torch.equal(na, nb):
            fail(f"{what}: nulls of column {i} differ")
        va = ca.values[:n].cpu()[~na]
        vb = cb.values[:n].cpu()[~nb]
        if va.is_floating_point():
            close(va, vb, RTOL_SUM)
        elif not torch.equal(va, vb):
            fail(f"{what}: values of column {i} differ")


def breadth_path(ds_conn, h_conn, counters) -> dict:
    """Phase 4b: TPC-DS and TPC-H SF1 queries over windows, grouping
    sets, UNION ALL and distinct marks, cold and warm on the card, held
    against the engine on the CPU."""
    import torch
    from presto_tpu_torch.exec.engine import LocalEngine

    gpu = {"ds": LocalEngine(ds_conn), "h": LocalEngine(h_conn)}
    queries = breadth_queries(gpu["ds"], gpu["h"])
    results, walls, per_query = {}, {}, {}
    for k in counters:
        k.launches = 0
    for name, (engine, sql, _ordered, as_page) in queries.items():
        results[name], walls[name] = [], []
        for _run in range(2):
            before = [k.launches for k in counters]
            torch.cuda.synchronize()
            t = time.perf_counter()
            results[name].append(run_query(engine, sql, as_page))
            walls[name].append(time.perf_counter() - t)
            per_query.setdefault(name, []).append(
                [k.launches - b for k, b in zip(counters, before)])
    launches = {k.__name__: k.launches for k in counters}
    for k in counters[6:]:
        if launches[k.__name__] == 0:
            fail(f"kernel {k.__name__} was not launched on the breadth path")

    cpu = {"ds": LocalEngine(ds_conn, device="cpu"),
           "h": LocalEngine(h_conn, device="cpu")}
    names = [k.__name__ for k in counters]
    for name, (engine, sql, ordered, as_page) in queries.items():
        cold, warm = results[name]
        which = "ds" if engine is gpu["ds"] else "h"
        if as_page:
            pages_match(cold, warm, f"{name} card cold vs warm")
        else:
            rows_match(cold, warm, f"{name} card cold vs warm", ordered)
        t = time.perf_counter()
        want = run_query(cpu[which], sql, as_page)
        cpu_s = time.perf_counter() - t
        if as_page:
            pages_match(warm, want, f"{name} card vs CPU")
            n = int(want.num_rows)
        else:
            rows_match(warm, want, f"{name} card vs CPU", ordered)
            n = len(want)
        scale = f"TPC-DS SF{TPCDS_SF}" if which == "ds" else f"TPC-H SF{SF}"
        print(f"{name}: {n} rows; card wall cold {walls[name][0] * 1e3:.1f} "
              f"ms, warm {walls[name][1] * 1e3:.1f} ms; CPU {cpu_s:.2f} s, "
              f"compared at {scale}; launches per run {names} cold "
              f"{per_query[name][0]} warm {per_query[name][1]}", flush=True)
    return launches


def sqlite_phase(counters) -> None:
    """All 22 TPC-H queries and the window and grouping-set queries of
    the test files at SQLITE_SF, and all 99 TPC-DS queries at
    TPCDS_SQLITE_SF, on the card against sqlite."""
    from presto_tpu_torch.connectors import TpcdsConnector, TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.testing.sqlite_oracle import compare_rows, \
        compare_tpcds_rows, load_tpcds, load_tpch, to_sqlite

    conn = TpchConnector(SQLITE_SF)
    t = time.perf_counter()
    db = load_tpch(conn)
    print(f"sqlite loaded with TPC-H SF{SQLITE_SF} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    engine = LocalEngine(conn)
    queries = {f"q{q:02d}": (sql, "order by" in sql.lower())
               for q, sql in sorted(tpch_queries().items())}
    breadth = breadth_sqlite_queries()
    queries.update({name: (sql, False) for name, (sql, _e) in
                    breadth.items()})
    rows, walls, _per_query, launches = _run_queries(
        engine, queries, counters, f"SF{SQLITE_SF} phase")
    for name, (sql, _ordered) in queries.items():
        if name in breadth:
            exp = breadth[name][1]
            expected = db.execute(exp if name.startswith("grouping")
                                  else to_sqlite(exp)).fetchall()
        else:
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

    ds_sql, ds_sqlite = tpcds_queries()
    conn = TpcdsConnector(TPCDS_SQLITE_SF)
    t = time.perf_counter()
    db = load_tpcds(conn)
    print(f"sqlite loaded with TPC-DS SF{TPCDS_SQLITE_SF} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    engine = LocalEngine(conn)
    queries = {f"ds{q:02d}": (sql, False) for q, sql in sorted(ds_sql.items())}
    rows, walls, _per_query, launches = _run_queries(
        engine, queries, counters, f"TPC-DS SF{TPCDS_SQLITE_SF} phase")
    for q, sql in sorted(ds_sql.items()):
        name = f"ds{q:02d}"
        expected = db.execute(to_sqlite(ds_sqlite.get(q) or sql)).fetchall()
        types = engine.plan_sql(sql).output_types
        try:
            for run, got in zip(("cold", "warm"), rows[name]):
                compare_tpcds_rows(got, types, expected,
                                   f"{name} card ({run}) vs sqlite")
        except AssertionError as e:
            fail(str(e))
    total = sum(w[1] for w in walls.values())
    print(f"TPC-DS SF{TPCDS_SQLITE_SF}: all {len(ds_sql)} queries equal "
          f"sqlite's, cold and warm on the card; warm walls sum "
          f"{total:.2f} s, slowest "
          f"{max(walls, key=lambda k: walls[k][1])} "
          f"{max(w[1] for w in walls.values()) * 1e3:.1f} ms", flush=True)
    print(f"TPC-DS SF{TPCDS_SQLITE_SF} launches: {launches}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import native
    from presto_tpu_torch.connectors import TpcdsConnector, TpchConnector
    from presto_tpu_torch.data.column import compact_indices
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops.aggregate import direct_agg
    from presto_tpu_torch.ops.join import join_expand, join_probe
    from presto_tpu_torch.ops.keys import hash_columns, key_change_flags
    from presto_tpu_torch.ops.scan import segment_reduce, segmented_scan
    from presto_tpu_torch.ops.window import window_frame

    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = native.build()
    print(f"phase 2: built {len(built)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in built.items():
        for line in info["report"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t_phase = time.perf_counter()
    conn = TpchConnector(SF)
    for table in ("region", "nation", "supplier", "customer", "part",
                  "partsupp", "orders", "lineitem"):
        conn.table(table)
    n_lineitem = conn.table("lineitem").num_rows
    print(f"TPC-H SF{SF}: tables generated in "
          f"{time.perf_counter() - t_phase:.1f} s ({n_lineitem} lineitem "
          f"rows)", flush=True)
    t0 = time.perf_counter()
    ds_conn = TpcdsConnector(TPCDS_SF)
    for table in ("store_sales", "catalog_sales", "web_sales",
                  "store_returns", "catalog_returns", "web_returns",
                  "inventory", "date_dim", "item", "customer"):
        ds_conn.table(table)
    print(f"TPC-DS SF{TPCDS_SF}: tables generated in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({ds_conn.table('store_sales').num_rows} store_sales rows)",
          flush=True)

    rng = np.random.default_rng(SEED)
    ds_sql, _ = tpcds_queries()
    q51_calls = capture_windows(LocalEngine(ds_conn), ds_sql[51])
    report = [kernel_direct_agg(rng, dev, REPEAT),
              kernel_compact(rng, dev, REPEAT),
              kernel_segment_reduce(rng, dev, REPEAT),
              kernel_hash(conn, dev, REPEAT),
              kernel_join_probe(conn, dev, REPEAT),
              kernel_join_expand(conn, dev, REPEAT),
              kernel_seg_scan(q51_calls, conn, dev, REPEAT),
              kernel_key_change(conn, dev, REPEAT),
              kernel_window_frame(conn, dev, REPEAT)]
    del q51_calls
    torch_op_rows(conn, ds_conn, dev, REPEAT)
    torch.cuda.synchronize()
    print(f"phase 3: kernels hold against their plain versions "
          f"({time.perf_counter() - t_phase:.1f} s with the tables)",
          flush=True)

    counters = [direct_agg, compact_indices, segment_reduce, hash_columns,
                join_probe, join_expand, segmented_scan, key_change_flags,
                window_frame]
    calls = CallCounter()
    t0 = time.perf_counter()
    launches = main_path(conn, counters)
    print(f"phase 4a: TPC-H main path in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}; torch-op stage calls {calls.counts}",
          flush=True)
    calls.reset()
    t0 = time.perf_counter()
    breadth = breadth_path(ds_conn, conn, counters)
    print(f"phase 4b: breadth path in {time.perf_counter() - t0:.1f} s; "
          f"launches {breadth}; torch-op stage calls {calls.counts}",
          flush=True)
    for r in report:
        r["launches"] = launches[r["name"]] + breadth[r["name"]]
    del ds_conn
    t0 = time.perf_counter()
    sqlite_phase(counters)
    print(f"phase 5: sqlite comparisons in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
