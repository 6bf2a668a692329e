#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (presto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure, each printing its seconds:
  1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 2;
  2. build every kernel of the port from presto_tpu_torch/csrc with nvcc
     (one nvcc per source, all started together);
  3. generate the TPC-H SF1 and TPC-DS SF1 tables on the host, and the
     nested orders table (1.5M orders whose arrays hold the 6.0M
     lineitems); each kernel (K1 direct_agg, K2 compact_indices, K3
     segment_reduce, K4 hash_columns, K5 join_probe, K6 join_expand, K7
     segmented_scan, K8 key_change_flags, K9 window_frame, K10 int128_op,
     the 128-bit sum modes of K1 and K3; K2 also at the HAVING
     filter's 2,097,152 flags and K3 also at a4's and n2's seven 0.86M-row
     groups and at the largest of TPC-DS q67's calls, captured while q67
     runs on the card, each on a line of its own, K3's float sums of two
     launches held bit for bit; K11 unnest_expand on the
     nested orders' l_partkeys and l_returned with the ordinality, at the
     capacity the executor gives that unnest and at one below the total,
     on 9 and 12 seeded channels and on a skewed page (one row of 2^20
     elements among rows mostly empty or NULL), K12 hll_registers in
     direct mode on a2's and a1's columns (their first values replaced by
     values whose hash has w = 2^k - 1) and on 8,388,608 rows of one
     value, and in sorted mode on 1.5M one-row groups, a3's 10,000 groups and
     a4's seven groups of 0.86M rows, K13 segment_select on phase 4e's
     unsorted lanes: a1's l_quantity (global), a2's l_extendedprice over
     its bins, a3's l_discount over 10,000 runs and a4's l_shipdate over
     seven, a1's also against torch.kthvalue; the merge modes of K1
     (global) and K3 (segment_merge128) on partial states of spec-typed
     q01's 8 x 4 shape and of 8 x 1.5M seeded rows, merge128_cases) at
     the shapes SF1 gives it on the main path
     (K1-K3 on seeded numpy data; K4-K6 on q13's join of customer with
     orders, K6 also with the build side in key order, at half its
     capacity and on a skewed probe side with one row of 2^20 pairs; K7 on TPC-DS q51's largest window input and on orders
     partitioned by o_custkey; K8 and K9 on that orders page, K9's rank,
     running sum and min over 3 rows each side also with the identity
     permutation, and its min over 1,000 rows each side; K10 and the
     128-bit modes on seeded values over the full +-(10^38-1) range with
     rows of 2 x 9.9e37, at q01's and the q18 block's shapes), held
     against its plain PyTorch version on the card (counts, indices,
     hashes, join pairs, flags, positions, min and max, limb sums and
     128-bit results and overflow flags, HyperLogLog registers, present
     sums and counts exact, order statistics bit for bit; float64 sums
     within 1e-9 relative, since the kernels sum in another order; K10's
     cast to double within 1e-15, since torch divides by a scalar
     through its reciprocal), and
     timed with CUDA events beside the plain version, one PyTorch library
     call where one computes the same function (K2: a stable descending
     torch.sort of the flags, and torch.nonzero on a line of its own; K3:
     torch.segment_reduce over the live values), and the card's bound;
     K1's and K5's cases (direct_agg_cases: q01's key skew, q06's one
     bin, 64 bins x 12 mixed inputs, an all-NULL input, num_rows 0, an
     all-false mask, NaN among min/max inputs; join_probe_cases: q13's
     probe in every mode, q18's LAST probe, the merge join's dup-count
     self-probes, an empty and a sparse build side, dead probes, one
     window of
     100,000 equal hashes, build sides of 2^20 +- 1 rows), each also
     launched twice and held bit for bit, K7's other scans and K9's
     other window functions are printed on lines of their own;
  4. the main paths at SF1, each with the kernels' launch counts set to 0
     just before and read just after:
     a. LocalEngine(TpchConnector(1.0)) on the card runs TPC-H q01, q06,
        the q18 aggregation block (having sum > 300), q03, q04, q13, q18,
        q21 and q22, each cold and warm; the cold run's rows are held
        against the warm run's, and the warm run's against the same
        engine on the CPU and, for q01, q06, the q18 block, q03, q04, q13
        and q18, against an independent numpy computation over the
        generated tables; K1-K6 must have been launched here; no warm
        run may compute a dictionary transform (expr/compile.DICT_CACHE),
        and q13's and q22's warm walls and transforms are printed;
     b. the breadth path: TPC-DS q47, q51, q67, q70, q16, q75 and q97
        (LocalEngine(TpcdsConnector(1.0))) and four TPC-H SF1 queries over
        windows and a distinct mark, each cold and warm on the card, the
        warm rows held against the cold ones and against the engine on
        the CPU; K7-K9 must have been launched here;
     c. the decimal path: TPC-H q01, q03, q06, q10, q14 and q19, q14's
        two sums (Q14_SUMS) and a
        DECIMAL(33,4) min/max (DECIMAL_MINMAX) over SF1 lineitem with its
        four money columns typed DECIMAL(12,2), as the spec types them (a
        MemoryConnector table over the generator's arrays, falling back to
        TpchConnector(1.0)), each cold and warm on the card; the rows held
        exactly (Decimal for Decimal) against the cold run, the engine on
        the CPU and, for q01, q06, q14's sums and the min/max, numpy int64
        arithmetic (q14's DOUBLE quotient within 1e-15 of the CPU's and
        of the exact quotient in Python Decimal: K10's cast to double);
        K10 and the 128-bit modes of K1 and K3 must have been launched
        here;
     d. the nested path: the four UNNEST queries of
        tests/test_torch_unnest.py (NESTED_ORDERS_QUERIES) over
        orders_nested (connectors/tpch.nested_orders at SF1, built from
        the generator's numpy arrays, in a MemoryConnector falling back to
        TpchConnector(1.0)), each cold and warm on the card; the rows held
        exactly against the cold run, the engine on the CPU, and the flat
        query over orders and lineitem on the card (numpy counts for the
        count query); K11 must have been launched here;
     e. the approx path: a1-a5 (APPROX_QUERIES: approx_distinct and
        approx_percentile on the global, direct and sorted paths) over
        TPC-H SF1, each cold and warm on the card; the rows held exactly
        against the cold run and the engine on the CPU, and against numpy
        over the generated arrays: percentiles exactly, distinct counts
        exactly against a HyperLogLog written anew in numpy (numpy_hll)
        and, as each query's root mean square relative error, within
        three standard errors of the sketch (HLL_BOUND, 6.9%) of the exact
        counts (10,000 groups of about 80 distinct values put a few
        single counts past 6.9% by chance: a3 has one at 7.5%); K12 and
        K13 must have been launched here;
     f. the statement path (statements()) over MemoryConnector(fallback=
        TpchConnector(1.0)) on the card: CREATE TABLE AS of lineitem's
        returnflag aggregate (4 rows) and of March 1995's orders, an
        INSERT ... SELECT of April's, a DELETE, a GROUP BY and a join with
        lineitem over the written table, EXPLAIN of the join, TPC-H q15
        with cte_materialization_enabled and inlined, and DROP TABLE of
        both; then the same sequence on the engine on the CPU; every
        count row and query row held against the CPU's and against numpy
        over the generated arrays, the written tables column by column
        against the CPU's, the EXPLAIN text against the CPU's, q15
        materialized against q15 inlined; K1, K2, K4 and K5 must have been
        launched here, and K3 and K10 across phases c and f;
     g. the bounded path (bounded_path): q01 and the q18 block with
        lifespan_batches=8, held against the same query run whole on the
        card and the engine on the CPU batched; spec-typed q01 and q06
        over the DECIMAL(12,2) lineitem batched in 8 lifespans and
        spilled to LZ4 frames in a temporary directory, held Decimal for
        Decimal against the run whole on the card and numpy int64
        arithmetic (the merge modes of K3 and K1 launched); q01 under a
        MemoryPool of a quarter of its footprint (at least 2 lifespans,
        rows equal, peak device memory below the run whole's, both
        printed); and GRACE_SQL under a pool that refuses it, through
        the Grace spill join (at least 2 partitions with rows, rows equal
        to the run whole; K4 and K5 launched there);
  5. all 22 TPC-H queries at SF 0.01 and all 99 TPC-DS queries at SF
     0.002 on the card, cold and warm, the window and grouping-set
     queries of tests/test_window_outer.py and tests/test_grouping_sets.py
     at TPC-H SF 0.01, and the seven engine queries of
     tests/test_unnest_nested.py over its docs table, the rows of both
     runs held against sqlite over the same generated tables
     (presto_tpu_torch/testing/sqlite_oracle.py; for the docs table, that
     file's flattened sqlite tables), and the six queries of
     tests/test_approx_aggs.py at SF 0.01 held exactly against the engine
     on the CPU (sqlite has no sketch); every kernel must have been
     launched here too.

The JSON kernel report is printed two lines before the end, then the
card's name and power limit, then {"ok": true, "device": {...}} as the
last line; each kernel's `launches` there is its count over the seven
main paths of phase 4. Imports nothing of JAX or presto_tpu: the query lists
of the test files are read from their source with `ast`.
"""

from __future__ import annotations

import ast
import datetime
import importlib.util
import json
import os
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

def nested_queries() -> dict:
    """Phase 4d's queries, name -> (SQL, its flat twin or None for the
    numpy count), from tests/test_torch_unnest.py."""
    return _literal_lists("test_torch_unnest", (
        "NESTED_ORDERS_QUERIES",))["NESTED_ORDERS_QUERIES"]


def unnest_oracle_db():
    """tests/test_unnest_nested.py's `oracle_db`: sqlite holding the
    flattened forms of its docs table (the function's source, run without
    its module, which imports the JAX package)."""
    import sqlite3
    tree = ast.parse((TESTS / "test_unnest_nested.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "oracle_db")
    fn.decorator_list = []
    ns = {"sqlite3": sqlite3}
    exec(compile(ast.Module(body=[fn], type_ignores=[]),
                 "test_unnest_nested.py", "exec"), ns)
    return ns["oracle_db"]()


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
#: TPC-H queries of the decimal path, over lineitem with DECIMAL(12,2)
#: money columns (q14: CASE over a DECIMAL(38) product, then a DOUBLE
#: quotient)
DECIMAL_MAIN = (1, 3, 6, 10, 14, 19)
RTOL_F64 = 1e-15                   # K10's to_double: torch divides by a
                                   # scalar through its reciprocal
BOUNDED_BATCHES = 8                # lifespans of the bounded path (4g)
#: phase 4g's join-rooted query, run through the Grace spill join
GRACE_SQL = ("select l_orderkey, l_extendedprice, o_orderdate "
             "from lineitem, orders where l_orderkey = o_orderkey "
             "and o_totalprice > 450000")

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


#: the approx path (phase 4e) over TPC-H SF1: name -> SQL; a1 global, a2
#: direct (dictionary keys), a3 sorted over 10,000 groups, a4 sorted over
#: seven groups of about 0.86M rows, a5 a filter mask and a VARCHAR input
APPROX_QUERIES = {
    "a1": "select approx_distinct(l_partkey), "
          "approx_distinct(l_extendedprice), "
          "approx_percentile(l_quantity, 0.5) from lineitem",
    "a2": "select l_returnflag, l_linestatus, approx_distinct(l_orderkey), "
          "approx_percentile(l_extendedprice, 0.9), count(*) from lineitem "
          "group by l_returnflag, l_linestatus",
    "a3": "select l_suppkey, approx_distinct(l_partkey), "
          "approx_percentile(l_discount, 0.25) from lineitem "
          "group by l_suppkey",
    "a4": "select l_linenumber, approx_distinct(l_partkey), "
          "approx_percentile(l_shipdate, 0.5) from lineitem "
          "group by l_linenumber",
    "a5": "select o_orderpriority, approx_distinct(o_clerk), "
          "approx_distinct(o_custkey) from orders "
          "where o_orderstatus = 'F' group by o_orderpriority",
}
#: three standard errors of a 2048-register HyperLogLog sketch (1.04 /
#: sqrt(2048) each)
HLL_BOUND = 3 * 1.04 / 2048 ** 0.5

_MASK64 = (1 << 64) - 1


def _unxorshift(y: int, k: int) -> int:
    """x with x ^ (x >> k) == y (64-bit)."""
    x = y
    for _ in range(64 // k + 1):
        x = y ^ (x >> k)
    return x


def hll_boundary_values(ks, reg: int = 5) -> np.ndarray:
    """int64 values whose approx_distinct hash, mix64(v + GOLDEN), has
    register `reg` and w = h >> 11 equal to 2^k - 1 for each k (k = 0:
    w = 0): splitmix64's finalizer inverted step by step with the
    modular inverses of its multipliers. Rounded to float32, 2^k - 1 stays
    below 2^k for k <= 24 and rounds up to it from k = 25, which moves
    the rank; k = 53 rounds to 2^53, rank 0."""
    golden = 0x9E3779B97F4A7C15
    inv1 = pow(0xBF58476D1CE4E5B9, -1, 1 << 64)
    inv2 = pow(0x94D049BB133111EB, -1, 1 << 64)
    out = []
    for k in ks:
        h = (((1 << k) - 1) << 11) | reg
        x = (_unxorshift(h, 31) * inv2) & _MASK64
        x = (_unxorshift(x, 27) * inv1) & _MASK64
        v = (_unxorshift(x, 30) - golden) & _MASK64
        out.append(v - (1 << 64) if v >> 63 else v)
    return np.array(out, dtype=np.int64)


def main_queries() -> dict:
    """The main path's queries: name -> (SQL, whether its rows come in a
    defined order)."""
    tpch = tpch_queries()
    return {name: (sql, "order by" in sql.lower()) for name, sql in [
        ("q01", tpch[1]), ("q06", tpch[6]), ("q18_block", Q18_BLOCK),
        ("q03", tpch[3]), ("q04", tpch[4]), ("q13", tpch[13]),
        ("q18", tpch[18]), ("q21", tpch[21]), ("q22", tpch[22])]}


#: the decimal path's min and max over a DECIMAL(33,4) product (the
#: DECIMAL(p>18) min/max of the direct path)
DECIMAL_MINMAX = """
select l_returnflag, l_linestatus, min(l_extendedprice * (1 - l_discount)),
       max(l_extendedprice * (1 - l_discount))
from lineitem
group by l_returnflag, l_linestatus
"""


#: spec-typed q14's two sums, exact Decimals (q14 divides them in DOUBLE)
Q14_SUMS = """
select sum(case when p_type like 'PROMO%'
                then l_extendedprice * (1 - l_discount) else 0 end),
       sum(l_extendedprice * (1 - l_discount))
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month
"""

#: decimal-path queries whose rows are DOUBLE, held within RTOL_F64
#: (K10's cast to double)
DECIMAL_FLOAT = ("q14",)


def decimal_queries() -> dict:
    """The decimal path's queries: name -> (SQL, whether its rows come in
    a defined order)."""
    tpch = tpch_queries()
    out = {f"q{q:02d}": (tpch[q], "order by" in tpch[q].lower())
           for q in DECIMAL_MAIN}
    out["q14_sums"] = (Q14_SUMS, False)
    out["minmax"] = (DECIMAL_MINMAX, False)
    return out


def decimal_connector(conn):
    """A MemoryConnector serving lineitem with DECIMAL(12,2) money
    columns, every other table from `conn` (a TpchConnector)."""
    from presto_tpu_torch.connectors import MemoryConnector
    from presto_tpu_torch.connectors.tpch import decimal_lineitem
    mem = MemoryConnector(fallback=conn)
    mem.register(decimal_lineitem(conn.scale_factor))
    return mem


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

def _da_bytes(n, keys, mask, inputs, valid) -> int:
    """Bytes a direct_agg call must move: each row below num_rows's mask
    (1 B); for each valid row (below num_rows and in the mask), its key
    codes (4 B) and key null flags (1 B), each input's null flag and,
    where the input asks for more than a count, its value (8 B, 4 B for
    int32, 32 B for limb lanes). A masked-out row adds nothing, so its
    keys are not counted."""
    nbytes = n * (mask is not None) + valid * 5 * len(keys)
    for v, nl, want in inputs:
        if nl is not None:
            nbytes += valid
        if want:
            nbytes += valid * (32 if isinstance(v, tuple)
                               else v.element_size())
    return nbytes


def _da_case(name, cap, n, keys, domains, inputs, mask, dev,
             library=None) -> dict:
    import torch
    return {"case": name, "cap": cap, "n": n, "keys": keys,
            "domains": domains, "inputs": inputs, "mask": mask,
            "num_rows": torch.tensor(n, dtype=torch.int64, device=dev),
            "library": library}


def _bits(t):
    """A tensor's elements as int64 words (float64 by their bits)."""
    import torch
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def run_direct_agg_case(c, repeat, A=None) -> dict:
    """One direct_agg call held against its plain version (rows and
    counts, int64 and limb sums, min and max exact; float64 sums within
    RTOL_SUM), launched twice (every output bit for bit), and timed
    beside the plain version, its bound and, where one exists, its
    library call. A: the module whose wrapper runs (default: this
    checkout's ops/aggregate)."""
    import torch
    if A is None:
        from presto_tpu_torch.ops import aggregate as A
    args = (c["cap"], c["num_rows"], c["keys"], c["domains"], c["inputs"],
            c["mask"])

    def kernel():
        return A.direct_agg(*args)

    def plain():
        return A._direct_agg_plain(*args)

    k, k2, p = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    what = f"direct_agg ({c['case']})"
    for name in k:
        if not torch.equal(_bits(k[name]), _bits(k2[name])):
            fail(f"{what}: two launches differ in {name}")
    for name in ("rows", "cnt"):
        if not exact(k[name], p[name]):
            fail(f"{what}: {name} differs from the plain version")
    err = 0.0
    for j, (v, _nl, want) in enumerate(c["inputs"]):
        if want & A.WANT_SUM128 and not exact(k["lsum"][j], p["lsum"][j]):
            fail(f"{what}: lsum of input {j} differs from the plain version")
        if isinstance(v, tuple):
            continue
        f64 = v.dtype == torch.float64
        if want & A.WANT_SUM:
            err = max(err, close(k["fsum"][j], p["fsum"][j], RTOL_SUM))
            if not f64 and not exact(k["isum"][j], p["isum"][j]):
                fail(f"{what}: isum of input {j} differs")
        if want & A.WANT_MINMAX:
            for name in ("mn", "mx"):
                a, b = k[name][j], p[name][j]
                if f64:
                    a, b = a.view(torch.float64), b.view(torch.float64)
                if not exact(a, b):
                    fail(f"{what}: {name} of input {j} differs")
    n = c["n"]
    valid = n if c["mask"] is None else int(c["mask"][:n].sum())
    nbytes = _da_bytes(n, c["keys"], c["mask"], c["inputs"], valid)
    lib = c["library"]
    return {"case": c["case"], "max_abs_err": err,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": cuda_time_ms(lib, repeat) if lib else None}


def _bincounts(keys, radix, mask, n, inputs, bins):
    """The library yardstick of a direct_agg case: one weighted bincount
    per input and one count over a precomputed bin code (the code and
    the masked weights are not part of its time)."""
    import torch
    dev = mask.device
    code = torch.zeros_like(keys[0][0], dtype=torch.int64)
    for (codes, _nl), r in zip(keys, radix):
        code = code * r + codes.long()
    live = mask & (torch.arange(mask.shape[0], device=dev) < n)
    code = torch.where(live, code, bins)
    weights = [torch.where(live, v, 0.0) for v, _nl, _w in inputs]

    def library():
        for w in weights:
            torch.bincount(code, weights=w, minlength=bins + 1)
        torch.bincount(code, minlength=bins + 1)
    return library


def direct_agg_cases(rng, dev) -> list:
    """Phase 3's direct_agg shapes, 6.0M live rows in an 8M-row page
    unless named otherwise. The first is the kernel line's, q01 at SF1
    with uniform keys (two dictionary keys of 3 and 2 codes, the fused
    filter mask, five float64 sums), drawn from `rng` as before; the
    others come from a generator of their own: q01's real key skew
    (returnflag x linestatus A-F/R-F/N-O/N-F at 25/25/49.5/0.5%); q06's
    one-bin global sum; 64 bins x 12 inputs of float64, int64 and int32
    with sums, min/max and NULLs (NULL keys in the last bins); an
    all-NULL input; num_rows 0; an all-false mask; NaN among min/max
    inputs."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    cap, n = 8_388_608, 6_001_215
    keys_np = [rng.integers(0, 3, cap).astype(np.int32),
               rng.integers(0, 2, cap).astype(np.int32)]
    zeros = torch.zeros(cap, dtype=torch.bool, device=dev)
    keys = [(torch_from(k, dev), zeros) for k in keys_np]
    mask = torch_from(rng.random(cap) < 0.986, dev)
    sums = [(torch_from(rng.random(cap) * scale, dev), zeros, A.WANT_SUM)
            for scale in (50.0, 1e5, 1e5, 1e5, 0.1)]
    cases = [_da_case("q01", cap, n, keys, [3, 2], sums, mask, dev,
                      _bincounts(keys, [3, 3], mask, n, sums, 12))]
    r2 = np.random.default_rng([SEED, 1])
    pair = r2.choice(4, cap, p=[0.25, 0.25, 0.495, 0.005])
    flag = np.array([0, 2, 1, 1], np.int32)[pair]     # A, R, N, N
    status = np.array([0, 0, 1, 0], np.int32)[pair]   # F, F, O, F
    skew = [(torch_from(flag, dev), zeros), (torch_from(status, dev), zeros)]
    cases.append(_da_case("q01 key skew", cap, n, skew, [3, 2], sums, mask,
                          dev, _bincounts(skew, [3, 3], mask, n, sums, 12)))
    q06 = [(torch_from(r2.random(cap) * 1e4, dev), zeros, A.WANT_SUM)]
    cases.append(_da_case("q06 global", cap, n, [], [], q06,
                          torch_from(r2.random(cap) < 0.019, dev), dev))
    wide_keys = [(torch_from(r2.integers(0, 7, cap).astype(np.int32), dev),
                  torch_from(r2.random(cap) < 0.05, dev)) for _ in range(2)]
    mixed = []
    for j in range(12):
        v = (r2.normal(0, 1e3, cap), r2.integers(-10 ** 12, 10 ** 12, cap),
             r2.integers(-10 ** 6, 10 ** 6, cap).astype(np.int32))[j % 3]
        mixed.append((torch_from(v, dev), torch_from(r2.random(cap) < 0.1,
                                                     dev),
                      A.WANT_SUM | A.WANT_MINMAX))
    cases.append(_da_case("64 bins x 12 mixed inputs", cap, n, wide_keys,
                          [7, 7], mixed, mask, dev))
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    all_null = [(sums[0][0], ones, A.WANT_SUM | A.WANT_MINMAX),
                (torch_from(r2.integers(0, 10 ** 6, cap), dev), zeros,
                 A.WANT_SUM), sums[1]]
    cases.append(_da_case("all-NULL input", cap, n, keys, [3, 2], all_null,
                          mask, dev))
    cases.append(_da_case("num_rows 0", cap, 0, keys, [3, 2], sums, mask,
                          dev))
    cases.append(_da_case("all-false mask", cap, n, keys, [3, 2], sums,
                          torch.zeros_like(mask), dev))
    nan = r2.normal(0, 1e3, cap)
    nan[::1000] = np.nan
    only_b0 = np.where(keys_np[0] + keys_np[1] == 0, np.nan, nan)
    cases.append(_da_case("NaN min/max", cap, n, keys, [3, 2], [
        (torch_from(nan, dev), zeros, A.WANT_MINMAX | A.WANT_SUM),
        (torch_from(only_b0, dev), zeros, A.WANT_MINMAX),
        (sums[0][0], zeros, A.WANT_MINMAX)], mask, dev))
    return cases


def kernel_direct_agg(rng, dev, repeat):
    """K1 at phase 3's shapes (direct_agg_cases), each held against the
    plain version; the kernel line is q01's, the other cases are printed
    on a line of their own."""
    results = [run_direct_agg_case(c, repeat)
               for c in direct_agg_cases(rng, dev)]
    print("direct_agg cases: " + json.dumps(results), flush=True)
    q01 = results[0]
    return {"name": "direct_agg", "route": "cuda",
            "source": "presto_tpu_torch/csrc/direct_agg.cu",
            "replaces": "presto_tpu/ops/aggregate.py:145",
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": q01["ms"], "plain_ms": q01["plain_ms"],
            "bound_ms": q01["bound_ms"], "bound_by": "bytes",
            "library_ms": q01["library_ms"]}


def _stable_sort(keep):
    """The library call that computes K2's permutation: a stable
    descending sort of the flags (`torch.sort`), its indices."""
    import torch
    return torch.sort(keep, descending=True, stable=True).indices


def kernel_compact(rng, dev, repeat):
    """K2 at the q18 block's SF1 shape: group starts over an 8M-row
    sorted page (6.0M valid rows, 1.5M group starts), and at the HAVING
    filter's shape (2,097,152 flags, 0.04% of the first 1.5M rows kept),
    timed on a line of its own. Library yardsticks: a stable descending
    `torch.sort` of the flags, whose indices are K2's permutation, and
    `torch.nonzero` (the survivors alone), on a line of its own."""
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
    if not exact(_stable_sort(keep), pp):
        fail("the stable sort of the flags is not K2's permutation")
    g_cap, g_n = 2_097_152, 1_500_000
    keep2 = torch.from_numpy(rng.random(g_cap) < 0.0004).to(dev)
    nr2 = torch.tensor(g_n, dtype=torch.int64, device=dev)
    (kp2, kc2) = C.compact_indices(keep2, nr2)
    (pp2, pc2) = C._compact_indices_plain(keep2, nr2)
    if not (exact(kp2, pp2) and exact(kc2, pc2)):
        fail("compact_indices differs from the plain version (HAVING)")
    # the flags below num_rows read once (1 B/row; a row past it is a
    # non-survivor whatever its flag), the permutation written (8 B/row)
    bound2 = (g_n + 8 * g_cap) / HBM_BYTES_PER_S * 1e3
    keep2_rows = keep2 & (torch.arange(g_cap, device=dev) < g_n)
    print(f"compact_indices at the HAVING shape ({g_cap} flags, "
          f"{int(kc2)} kept): "
          f"{cuda_time_ms(lambda: C.compact_indices(keep2, nr2), repeat):.4f}"
          f" ms, plain "
          f"{cuda_time_ms(lambda: C._compact_indices_plain(keep2, nr2), repeat):.4f}"
          f" ms, stable sort "
          f"{cuda_time_ms(lambda: _stable_sort(keep2_rows), repeat):.4f} ms,"
          f" nonzero "
          f"{cuda_time_ms(lambda: torch.nonzero(keep2_rows), repeat):.4f} ms,"
          f" bound {bound2:.4f} ms", flush=True)
    print(f"compact_indices at 8M flags: nonzero "
          f"{cuda_time_ms(lambda: torch.nonzero(keep), repeat):.4f} ms",
          flush=True)
    return {"name": "compact_indices", "route": "cuda",
            "source": "presto_tpu_torch/csrc/compact.cu",
            "replaces": "presto_tpu/data/column.py:760",
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, repeat),
            "bound_ms": cap * 9 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": cuda_time_ms(lambda: _stable_sort(keep), repeat)}


def _segment_bytes(values, live, starts, ends, want) -> int:
    """K3's bytes on these inputs: each row of a segment read once (its
    value or four limbs, and its live flag), each segment's start and end
    read and its results written once."""
    import torch
    from presto_tpu_torch.ops import scan as S
    lanes = values if isinstance(values, tuple) else (values,)
    n = lanes[0].shape[0]
    s = starts.clamp(0, n)
    rows = int((torch.maximum(ends.clamp(0, n), s) - s).sum())
    row = sum(x.element_size() for x in lanes) + (live is not None)
    out = 8                                              # cnt
    if want == S.WANT_SUM128:
        out += 32
    else:
        if want & S.WANT_SUM:
            out += 8 if lanes[0].dtype == torch.float64 else 16
        if want & S.WANT_MINMAX:
            out += 16
    return rows * row + starts.shape[0] * (16 + out)


def _segment_case(what, vals, live, starts, ends, want, repeat):
    """K3 on one shape against its plain version (counts, integer sums,
    min and max exact, float sums within RTOL_SUM; two launches' float
    sums bit for bit the same), timed beside it and beside one
    `torch.segment_reduce` over the same live values (segments contiguous
    from row 0), with its bound. Returns (max abs error, times)."""
    import torch
    from presto_tpu_torch.ops import scan as S
    k = S.segment_reduce(vals, live, starts, ends, want)
    p = S._segment_reduce_plain(vals, live, starts, ends, want)
    err = 0.0
    for name, got in k.items():
        if name == "fsum":
            err = max(err, close(got, p[name], RTOL_SUM))
        elif not exact(got, p[name]):
            fail(f"segment_reduce {name} differs from the plain version "
                 f"({what})")
    if "fsum" in k:
        again = S.segment_reduce(vals, live, starts, ends, want)["fsum"]
        if not torch.equal(again.view(torch.int64),
                           k["fsum"].view(torch.int64)):
            fail(f"segment_reduce float sums differ between two launches "
                 f"({what})")
    n = vals.shape[0]
    s = starts.clamp(0, n)
    lengths = torch.maximum(ends.clamp(0, n), s) - s
    total = int(lengths.sum())
    data = vals.to(torch.float64) if live is None else \
        torch.where(live, vals.to(torch.float64), 0.0)
    data = data[:total].contiguous()
    # the non-empty segments tile rows [0, total) in segment order
    s_ne, l_ne = s[lengths > 0], lengths[lengths > 0]
    contiguous = s_ne.numel() == 0 or (bool(s_ne[0] == 0) and bool(
        (s_ne[1:] == (s_ne + l_ne)[:-1]).all()))
    times = {"ms": cuda_time_ms(
                 lambda: S.segment_reduce(vals, live, starts, ends, want),
                 repeat),
             "plain_ms": cuda_time_ms(
                 lambda: S._segment_reduce_plain(vals, live, starts, ends,
                                                 want), max(repeat // 4, 2)),
             "bound_ms": _segment_bytes(vals, live, starts, ends, want)
             / HBM_BYTES_PER_S * 1e3,
             "library_ms": cuda_time_ms(
                 lambda: torch.segment_reduce(data, "sum", lengths=lengths),
                 repeat) if contiguous else None}
    return err, times


def _seven_groups(rng, dev):
    """a4's and n2's shape: lineitem's 6.0M live rows of an 8,388,608-row
    page sorted by l_linenumber, seven segments of 0.21M-1.5M rows (0.86M
    on average) among 1,024 group slots; float64 values."""
    import torch
    cap, g_cap = 8_388_608, 1024
    lines = rng.integers(1, 8, 1_500_000)
    lengths = np.array([(lines >= k).sum() for k in range(1, 8)])
    ends_np = np.cumsum(lengths)
    n = int(ends_np[-1])
    pad = g_cap - 7
    starts = torch_from(np.concatenate([ends_np - lengths,
                                        np.full(pad, n)]), dev)
    ends = torch_from(np.concatenate([ends_np, np.full(pad, n)]), dev)
    vals = torch_from(rng.integers(1, 51, cap).astype(np.float64), dev)
    live = torch.arange(cap, device=dev) < n
    return vals, live, starts, ends


def capture_segment_reduce(engine, sql: str) -> list:
    """The K3 calls (values, live, starts, ends, want) a query makes,
    recorded while it runs on `engine`. The wrapper counts its launches
    on the module's `segment_reduce`, the recorder while it stands
    there."""
    from presto_tpu_torch.ops import scan as S
    calls = []
    orig = S.segment_reduce

    def record(values, live, starts, ends, want=S.WANT_SUM):
        calls.append((values, live, starts, ends, want))
        return orig(values, live, starts, ends, want)

    record.launches = orig.launches
    record.sum128_launches = orig.sum128_launches
    S.segment_reduce = record
    try:
        engine.execute_sql(sql)
    finally:
        S.segment_reduce = orig
        orig.launches = record.launches
        orig.sum128_launches = record.sum128_launches
    return calls


def kernel_segment_reduce(rng, dev, ds_conn, repeat):
    """K3 at the q18 block's SF1 shape (the kernel line): float64
    l_quantity sorted by order key, 1.5M segments of 1-7 rows among 2M
    segment slots. On lines of their own: a4's and n2's seven 0.86M-row
    groups (_seven_groups, WANT_SUM), and the largest of TPC-DS q67's K3
    calls at SF1, captured while q67 runs on the card (each call's
    segments, rows, longest segment and segments past one piece are
    printed)."""
    import torch
    from presto_tpu_torch import native
    from presto_tpu_torch.exec.engine import LocalEngine
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
    err, q18 = _segment_case("q18 block", vals, live, starts, ends,
                             S.WANT_SUM, repeat)
    km = S.segment_reduce(vals, live, starts, ends, S.WANT_MINMAX)
    pm = S._segment_reduce_plain(vals, live, starts, ends, S.WANT_MINMAX)
    for name in ("min", "max"):
        if not exact(km[name], pm[name]):
            fail(f"segment_reduce {name} differs from the plain version")

    def line(what, t):
        lib = "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        print(f"segment_reduce at {what}: {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, torch.segment_reduce {lib}, bound "
              f"{t['bound_ms']:.4f} ms", flush=True)

    e7, seven = _segment_case("seven groups", *_seven_groups(rng, dev),
                              S.WANT_SUM, repeat)
    line("a4's and n2's seven 0.86M-row groups (float64, WANT_SUM)", seven)
    ds_sql, _ = tpcds_queries()
    calls = capture_segment_reduce(LocalEngine(ds_conn), ds_sql[67])
    shapes = []
    for values, lv, st, en, want in calls:
        m = (values[0] if isinstance(values, tuple) else values).shape[0]
        s0 = st.clamp(0, m)
        ln = torch.maximum(en.clamp(0, m), s0) - s0
        shapes.append((int(ln.max()) if ln.numel() else 0,
                       int((ln > native.SEGMENT_PIECE).sum()),
                       int(ln.sum()), st.shape[0], want))
    print("segment_reduce calls of TPC-DS q67 at SF1 (longest segment, "
          "segments past one piece, rows, segment slots, want): "
          + "; ".join(str(x) for x in shapes), flush=True)
    e67 = 0.0
    if calls:
        big = max(range(len(calls)), key=lambda i: shapes[i][:3])
        values, lv, st, en, want = calls[big]
        if isinstance(values, tuple):
            fail("q67's K3 calls are in the default mode")
        e67, t67 = _segment_case("q67", values, lv, st, en, want, repeat)
        line(f"TPC-DS q67's largest call ({values.dtype}, want {want})",
             t67)
    del calls
    return {"name": "segment_reduce", "route": "cuda",
            "source": "presto_tpu_torch/csrc/segment_reduce.cu",
            "replaces": "presto_tpu/ops/scan.py:160",
            "max_abs_err": max(err, e7, e67),
            "ms": q18["ms"], "plain_ms": q18["plain_ms"],
            "bound_ms": q18["bound_ms"], "bound_by": "bytes",
            "library_ms": q18["library_ms"]}


def _wide_values(rng, n, dev, live_rows=None):
    """Four int64 limb lanes of n values over +-(10^38-1): per row the
    magnitude keeps 1 to 4 of its limbs (random 32-bit limbs, the top one
    below 1,262,177,448 so that |v| < 10^38 about), half of them negated
    lane by lane (a valid, denormalized form). The last three of the first
    `live_rows` rows (default n) hold 2 x 9.9e37, -2 x 9.9e37 and
    2 x 9.9e37 in doubled lanes: values past 2^127."""
    m = [rng.integers(0, 2 ** 32, n) for _ in range(3)]
    m.insert(0, rng.integers(0, 1_262_177_448, n))
    keep = rng.integers(1, 5, n)
    for q in range(3):
        m[q] = np.where(keep > 3 - q, m[q], 0)
    neg = rng.random(n) < 0.5
    lanes = [np.where(neg, -x, x).astype(np.int64) for x in m]
    big = 99 * 10 ** 36
    end = n if live_rows is None else live_rows
    for i, v in ((end - 3, big), (end - 2, -big), (end - 1, big)):
        for q, shift in enumerate((96, 64, 32, 0)):
            part = v >> shift if q == 0 else (v >> shift) & 0xFFFFFFFF
            lanes[q][i] = 2 * part
    return tuple(torch_from(x, dev) for x in lanes)


def torch_from(a, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _same_lanes(k, p, what):
    """Two sets of limb lanes hold the same values (lanes normalized)."""
    import torch
    from presto_tpu_torch.data import int128 as I
    for a, b in zip(I.normalize(k), I.normalize(p)):
        if not torch.equal(a, b):
            fail(f"{what}: limb lanes differ from the plain version")


def kernel_int128(rng, dev, repeat):
    """K10 at q01's SF1 shape (8,388,608 rows): every operation on values
    over the full +-(10^38-1) range and the 2 x 9.9e37 rows, flags and
    results against the plain version; timed on q01's sum_charge product
    (DECIMAL(25,4) lanes x DECIMAL(13,2) int64 -> DECIMAL(38,6))."""
    import torch
    from presto_tpu_torch.data import int128 as I
    cap = 8_388_608
    wide_a, wide_b = _wide_values(rng, cap, dev), _wide_values(rng, cap, dev)
    narrow = torch_from(rng.integers(-2 ** 62, 2 ** 62, cap), dev)
    short = I.from_int64(torch_from(rng.integers(-10 ** 18, 10 ** 18, cap),
                                    dev))
    valid = torch_from(rng.random(cap) < 0.9, dev)
    zero = torch_from(rng.random(cap) < 0.01, dev)
    cases = [("multiply", wide_a, narrow, 0, 0),
             ("multiply", narrow, narrow.flip(0), 0, 0),
             ("multiply", wide_a, tuple(short), 0, 0),
             ("add", wide_a, wide_b, 0, 3), ("subtract", wide_a, narrow, 2, 0),
             ("rescale", wide_a, None, 5, 0), ("rescale", wide_a, None, -7, 0),
             ("rescale", narrow, None, -20, 0),
             ("compare", wide_a, wide_b, 1, 0), ("negate", wide_a, None, 0, 0),
             ("abs", wide_b, None, 0, 0), ("to_double", wide_a, None, 0, 0),
             ("to_int64", wide_a, None, -25, 0)]
    for op, x, y, xs, ys in cases:
        kw = dict(x_shift=xs, y_shift=ys, valid=valid, zero=zero, scale=6,
                  lo=-2 ** 40, hi=2 ** 40, row_flags=True)
        k_out, k_err, k_rows = I.int128_op(op, x, y, **kw)
        p_out, p_err, p_rows = I._int128_op_plain(
            op, x, y, xs, ys, valid, zero, 6, -2 ** 40, 2 ** 40, True)
        what = f"int128_op {op} (shifts {xs}, {ys})"
        if not (exact(k_rows, p_rows) and exact(k_err, p_err)):
            fail(f"{what}: overflow flags differ from the plain version")
        ok = p_rows == 0
        if isinstance(p_out, tuple):
            _same_lanes(tuple(t[ok] for t in k_out),
                        tuple(t[ok] for t in p_out), what)
        elif op == "to_double":
            print(f"int128_op to_double: max abs difference "
                  f"{close(k_out, p_out, RTOL_F64)} over values up to "
                  f"{float(p_out.abs().max()):.3g} ({RTOL_F64} relative "
                  f"allowed)", flush=True)
        elif not exact(k_out[ok], p_out[ok]):
            fail(f"{what}: results differ from the plain version")
    # the carry rows: 2 x 9.9e37 in, exact out
    back, _e = I.int128_op("rescale", wide_a, x_shift=0)
    host = [t[-3:].cpu().numpy() for t in back]
    if [I.to_python_int(host, i) for i in range(3)] != \
            [198 * 10 ** 36, -198 * 10 ** 36, 198 * 10 ** 36]:
        fail("int128_op lost the 2 x 9.9e37 rows")
    # q01's operands: cents x (100 - discount), then x (100 + tax)
    prod = I.int128_op(
        "multiply", torch_from(rng.integers(90_000, 10 ** 7, cap), dev),
        torch_from(rng.integers(90, 101, cap), dev))[0]
    tax = torch_from(rng.integers(100, 109, cap), dev)
    nulls = torch.zeros(cap, dtype=torch.bool, device=dev)

    def kernel():
        return I.int128_op("multiply", prod, tax, valid=valid, zero=nulls)

    def plain():
        return I._int128_op_plain("multiply", prod, tax, 0, 0, valid,
                                  nulls, 0, 0, 0, False)

    # four lanes and one int64 read, the valid and zero flags, four lanes
    # written
    nbytes = cap * (32 + 8 + 1 + 1 + 32)
    return {"name": "int128_op", "route": "cuda",
            "source": "presto_tpu_torch/csrc/int128.cu",
            "replaces": "presto_tpu/data/int128.py:73",
            # the timed multiply and every integer result are exact
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            # torch has no 128-bit integer type
            "library_ms": None}


def direct_agg_sum128_case(rng, dev) -> dict:
    """K1's 128-bit sum mode at q01's spec-typed SF1 shape: 6.0M rows in
    an 8M-row page, two dictionary keys, the fused filter mask; l_quantity
    and l_extendedprice as int64 cents (sum and the avg128 limb sums),
    l_discount (limb sums), the two products as limb lanes (full range,
    with the 2 x 9.9e37 rows)."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    cap, n = 8_388_608, 6_001_215
    keys = [(torch_from(rng.integers(0, k, cap).astype(np.int32), dev),
             torch.zeros(cap, dtype=torch.bool, device=dev)) for k in (3, 2)]
    mask = torch_from(rng.random(cap) < 0.986, dev)
    mask[n - 3:n] = True
    nulls = torch.zeros(cap, dtype=torch.bool, device=dev)
    both = A.WANT_SUM | A.WANT_SUM128
    inputs = [(torch_from(rng.integers(100, 5001, cap), dev), nulls, both),
              (torch_from(rng.integers(90_000, 10 ** 7, cap), dev), nulls,
               both),
              (torch_from(rng.integers(0, 11, cap), dev), nulls,
               A.WANT_SUM128),
              (_wide_values(rng, cap, dev, n), nulls, A.WANT_SUM128),
              (_wide_values(rng, cap, dev, n), nulls, A.WANT_SUM128)]
    return _da_case("q01 spec-typed, 128-bit", cap, n, keys, [3, 2], inputs,
                    mask, dev)


def kernel_direct_agg_sum128(rng, dev, repeat):
    """K1's 128-bit sum mode (direct_agg_sum128_case) held against the
    plain version; torch has no 128-bit integer type, so no library
    call."""
    r = run_direct_agg_case(direct_agg_sum128_case(rng, dev), repeat)
    print("direct_agg_sum128 case: " + json.dumps(r), flush=True)
    return {"name": "direct_agg_sum128", "route": "cuda",
            "source": "presto_tpu_torch/csrc/direct_agg.cu",
            "replaces": "presto_tpu/ops/aggregate.py:284",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def kernel_segment_sum128(rng, dev, repeat):
    """K3's 128-bit sum mode at the q18 block's SF1 shape (1.5M segments
    of 1-7 rows over 6.0M rows) on limb lanes over the full range with
    the 2 x 9.9e37 rows, and on int64 values."""
    import torch
    from presto_tpu_torch.ops import scan as S
    cap, g_cap = 8_388_608, 2_097_152
    lines = rng.integers(1, 8, 1_500_000)
    ends_np = np.cumsum(lines)
    starts_np = ends_np - lines
    n = int(ends_np[-1])
    pad = g_cap - len(lines)
    starts = torch_from(np.concatenate([starts_np, np.full(pad, n)]), dev)
    ends = torch_from(np.concatenate([ends_np, np.full(pad, n)]), dev)
    lanes = _wide_values(rng, cap, dev, n)
    live = torch.arange(cap, device=dev) < n

    def kernel():
        return S.segment_reduce(lanes, live, starts, ends, S.WANT_SUM128)

    def plain():
        return S._segment_reduce_plain(lanes, live, starts, ends,
                                       S.WANT_SUM128)

    for vals in (lanes, torch_from(rng.integers(-2 ** 62, 2 ** 62, cap),
                                   dev)):
        k = S.segment_reduce(vals, live, starts, ends, S.WANT_SUM128)
        p = S._segment_reduce_plain(vals, live, starts, ends, S.WANT_SUM128)
        if not (exact(k["cnt"], p["cnt"]) and exact(k["lsum"], p["lsum"])):
            fail("segment_reduce 128-bit mode differs from the plain version")
    # limb lanes and live flags of the segmented rows, starts/ends read,
    # counts and four limb sums written
    nbytes = n * 33 + g_cap * 16 + g_cap * 40
    return {"name": "segment_reduce_sum128", "route": "cuda",
            "source": "presto_tpu_torch/csrc/segment_reduce.cu",
            "replaces": "presto_tpu/ops/aggregate.py:612",
            "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None}


def merge128_cases(rng, dev) -> list:
    """The final merges' inputs (sum128_merge/avg128_merge over DECIMAL(38)
    partial states): the limb lanes of the states (`_wide_values`: the
    full +-(10^38-1) range and the 2 x 9.9e37 rows), NULL states, the
    partial count column with NULLs, and group runs of BOUNDED_BATCHES
    rows, one partial a lifespan. Spec-typed q01's 8 x 4 partial rows and
    8 x 1.5M seeded partial rows (the q18 block's groups), the latter
    with about 1% of its groups all NULL."""
    import torch
    out = []
    for name, groups in (("q01 spec-typed partials, 8 x 4", 4),
                         ("seeded partials, 8 x 1.5M", 1_500_000)):
        n = BOUNDED_BATCHES * groups
        cap = 256 if n <= 256 else 1 << (n - 1).bit_length()
        lanes = _wide_values(rng, cap, dev, n)
        nulls = rng.random(cap) < 0.1
        nulls[n:] = True
        nulls[n - 3:n] = False          # the 2 x 9.9e37 rows are live
        dead = rng.random(groups) < 0.01
        nulls[:n] |= np.repeat(dead, BOUNDED_BATCHES)
        counts = np.where(nulls, 0, rng.integers(1, 10 ** 6, cap))
        cnulls = rng.random(cap) < 0.02
        starts = torch_from(np.arange(groups, dtype=np.int64)
                            * BOUNDED_BATCHES, dev)
        row = torch.arange(cap, device=dev)
        out.append({
            "case": name, "cap": cap, "n": n, "lanes": lanes,
            "nulls": torch_from(nulls, dev),
            "counts": torch_from(counts, dev),
            "cnulls": torch_from(cnulls, dev), "valid": row < n,
            "starts": starts, "ends": starts + BOUNDED_BATCHES})
    return out


def run_merge128_case(c, repeat) -> dict:
    """K1's and K3's merges of one case against their plain versions:
    live states, limb sums and the count column's sum exact. K1 takes the
    case as a global merge (one bin), K3 as group runs."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    from presto_tpu_torch.ops import scan as S
    cap, n = c["cap"], c["n"]
    num_rows = torch.tensor(n, dtype=torch.int64, device=c["nulls"].device)
    inputs = [(c["lanes"], c["nulls"], A.WANT_SUM128 | A.WANT_MERGE128),
              (c["counts"], c["cnulls"], A.WANT_SUM)]
    live, clive = ~c["nulls"] & c["valid"], ~c["cnulls"] & c["valid"]

    def k1():
        return A.direct_agg(cap, num_rows, [], [], inputs)

    def k1_plain():
        return A._direct_agg_plain(cap, num_rows, [], [], inputs, None)

    def k3():
        return S.segment_merge128(c["lanes"], live, c["starts"], c["ends"],
                                  c["counts"], clive)

    def k3_plain():
        return S._segment_merge128_plain(c["lanes"], live, c["starts"],
                                         c["ends"], c["counts"], clive)

    k, p = k1(), k1_plain()
    for key in ("rows", "cnt", "isum", "lsum"):
        if not exact(k[key], p[key]):
            fail(f"direct_agg merge ({c['case']}): {key} differs from the "
                 f"plain version")
    k, p = k3(), k3_plain()
    for key in ("cnt", "lsum", "csum"):
        if not exact(k[key], p[key]):
            fail(f"segment_merge128 ({c['case']}): {key} differs from the "
                 f"plain version")
    g = c["starts"].shape[0]
    # per row four lanes, the state's null flag, the count and its null
    # flag read once; K3 also each run's start and end, and its count,
    # four limb sums and count sum written
    return {"case": c["case"], "rows": n, "groups": g, "max_abs_err": 0.0,
            "k1_ms": cuda_time_ms(k1, repeat),
            "k1_plain_ms": cuda_time_ms(k1_plain, max(repeat // 4, 2)),
            "k1_bound_ms": n * 42 / HBM_BYTES_PER_S * 1e3,
            "k3_ms": cuda_time_ms(k3, repeat),
            "k3_plain_ms": cuda_time_ms(k3_plain, max(repeat // 4, 2)),
            "k3_bound_ms": (n * 42 + g * 64) / HBM_BYTES_PER_S * 1e3}


def kernel_merge128(rng, dev, repeat) -> list:
    """The merge modes of K1 (global) and K3 (sorted) at merge128_cases'
    two shapes, each line printed; the kernel lines are the 8 x 1.5M
    shape. torch has no 128-bit integer type, so no library call."""
    lines = [run_merge128_case(c, repeat) for c in merge128_cases(rng, dev)]
    print("merge128 cases: " + json.dumps(lines), flush=True)
    big = lines[-1]
    return [{"name": "direct_agg_merge128", "route": "cuda",
             "source": "presto_tpu_torch/csrc/direct_agg.cu",
             "replaces": "presto_tpu/ops/aggregate.py:197",
             "max_abs_err": 0.0, "ms": big["k1_ms"],
             "plain_ms": big["k1_plain_ms"], "bound_ms": big["k1_bound_ms"],
             "bound_by": "bytes", "library_ms": None},
            {"name": "segment_reduce_merge128", "route": "cuda",
             "source": "presto_tpu_torch/csrc/segment_reduce.cu",
             "replaces": "presto_tpu/ops/aggregate.py:556",
             "max_abs_err": 0.0, "ms": big["k3_ms"],
             "plain_ms": big["k3_plain_ms"], "bound_ms": big["k3_bound_ms"],
             "bound_by": "bytes", "library_ms": None}]


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
    (at most what the searches read); for a walk, the key lanes of the
    probe rows with a window, and the build row and key lanes of every
    sorted position that some walk reaches: from the window's start to
    its first match (FIRST), from its end back to its last match (LAST),
    or all of it where no key matches or in ALL mode, which also writes
    a flag per build row."""
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
    elif mode == J.LAST:
        first, last = torch.where(hit >= 0, at, lo), lo + cnt
    else:
        first, last = lo, lo + cnt
        nbytes += b
    edge = torch.zeros(b + 1, dtype=torch.int64, device=order.device)
    one = torch.ones(int(live.sum()), dtype=torch.int64, device=order.device)
    edge.index_add_(0, first[live], one)
    edge.index_add_(0, last[live], -one)
    walked = int((edge.cumsum(0)[:b] > 0).sum())
    return nbytes + walked * (8 + sum(v.element_size() for v in bvals))


MODE_NAMES = ("WINDOW", "FIRST", "LAST", "ALL")


def _probe_case(what, ph, bh_sorted, order, pvals, bvals, mode) -> dict:
    return {"case": what, "mode": mode, "ph": ph, "bh_sorted": bh_sorted,
            "order": order, "pvals": pvals, "bvals": bvals}


def run_join_probe_case(c, repeat, J=None) -> dict:
    """One join_probe call held exactly against its plain version,
    launched twice (bit for bit), and timed beside the plain version,
    its bound and, in WINDOW mode, two torch.searchsorted calls. J: the
    module whose wrapper runs (default: this checkout's ops/join)."""
    import torch
    if J is None:
        from presto_tpu_torch.ops import join as J
    args = (c["ph"], c["bh_sorted"], c["order"], c["pvals"], c["bvals"],
            c["mode"])

    def kernel():
        return J.join_probe(*args)

    def plain():
        return J._join_probe_plain(*args)

    got, again, want = kernel(), kernel(), plain()
    what = f"join_probe ({c['case']}, {MODE_NAMES[c['mode']]})"
    for g, a, w in zip(got, again, want):
        if (g is None) != (w is None) or (w is not None and not (
                exact(g, w) and exact(g, a))):
            fail(f"{what} differs from the plain version or between two "
                 f"launches")
    lo, cnt, hit, _ = got
    nbytes = _probe_bytes(*args[:6], lo, cnt, hit)
    bh_sorted, ph = c["bh_sorted"], c["ph"]

    def library():
        torch.searchsorted(bh_sorted, ph, side="left")
        torch.searchsorted(bh_sorted, ph, side="right")

    window = c["mode"] == 0
    return {"case": c["case"], "mode": MODE_NAMES[c["mode"]],
            "probe_rows": ph.shape[0], "build_rows": bh_sorted.shape[0],
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": cuda_time_ms(library, repeat) if window else None}


def _hashed_keys(keys: np.ndarray, dead: np.ndarray, sentinel: int, dev):
    """K4's hashes of int64 keys, `sentinel` where dead, and the key lane."""
    import torch
    from presto_tpu_torch import types as T
    from presto_tpu_torch.data.column import Column
    from presto_tpu_torch.ops import keys as K
    col = Column.from_numpy(keys, T.BIGINT, device=dev)
    h = K.hash_columns([col])[:len(keys)]
    h = torch.where(torch_from(dead, dev), sentinel, h)
    return h, col.values[:len(keys)].contiguous()


def join_probe_cases(conn, dev) -> list:
    """Phase 3's join_probe shapes: q13's (262,144 customer probe rows into
    the 2,097,152 hash-sorted orders rows on custkey) in every mode, the
    first (WINDOW, the expansion join's) the kernel line's; q18's LAST
    probe of lineitem (8,388,608 rows) into orders on orderkey; the merge
    join's duplicate-count FIRST self-probes of the build side's
    candidates, on orders by orderkey (unique keys: no candidates) and by
    custkey; q13's probe into an empty build side (every row dead) and
    into one of about 64 live rows; q13's build probed by dead rows only;
    one window of 100,000 equal hashes with differing keys (131,072 build
    rows), probed in WINDOW mode and, with keys among the window's first
    or last 32 rows, FIRST and LAST;
    build sides of 2^20 - 1 and 2^20 + 1 rows (keys with duplicates, 2%
    dead) probed by 262,144 rows in every mode."""
    import torch
    from presto_tpu_torch.ops import join as J
    cust, orders = _q13_join_inputs(conn, dev)
    ph, bh_sorted, order = _sorted_build(cust, orders)
    pv, bv = [cust.columns[0].values], [orders.columns[0].values]
    cases = [_probe_case("q13 customer x orders", ph, bh_sorted, order, pv,
                         bv, mode)
             for mode in (J.WINDOW, J.FIRST, J.LAST, J.ALL)]
    line = conn.table("lineitem").page(["l_orderkey"], device=dev)
    okeys = conn.table("orders").page(["o_orderkey"], device=dev)
    lph, lbh_sorted, lorder = _sorted_build(line, okeys)
    cases.append(_probe_case("q18 lineitem x orders", lph, lbh_sorted,
                             lorder, [line.columns[0].values],
                             [okeys.columns[0].values], J.LAST))
    for what, page in (("orders by orderkey", okeys),
                       ("orders by custkey", orders)):
        _ph, bh, bs, order_ = J._sorted_build(
            page, page, [page.columns[0]], [page.columns[0]],
            page.row_valid(), page.row_valid())
        cand = J._dup_candidates(bs, order_)
        vals = [page.columns[0].values]
        cases.append(_probe_case(
            f"dup count of {what} ({int(cand.sum())} candidates)",
            torch.where(cand, bh, -1), bs, order_, vals, vals, J.FIRST))
    nb = bh_sorted.shape[0]
    cases.append(_probe_case(
        "empty build side", ph, torch.full_like(bh_sorted, -2),
        torch.arange(nb, dtype=torch.int64, device=dev), pv, bv, J.FIRST))
    cases.append(_probe_case("dead probes", torch.full_like(ph, -1),
                             bh_sorted, order, pv, bv, J.FIRST))
    rng = np.random.default_rng([SEED, 5])
    keep = torch_from(rng.random(nb) < 64 / nb, dev)  # a HAVING page's few
    sbs, sorder = torch.sort(torch.where(keep, bh_sorted[torch.argsort(
        order)], -2), stable=True)
    cases.append(_probe_case(f"sparse build side ({int(keep.sum())} live)",
                             ph, sbs, sorder, pv, bv, J.FIRST))
    nb, width = 131_072, 100_000
    bkeys = rng.permutation(nb).astype(np.int64) * 7919 + 13   # distinct
    bh = torch.full((nb,), 1 << 61, dtype=torch.int64, device=dev)
    bh[width:] = -2
    wbs, word = torch.sort(bh, stable=True)
    wbv = [torch_from(bkeys, dev)]
    first = bkeys[word[nb - width:nb - width + 32].cpu().numpy()]
    last = bkeys[word[nb - 32:].cpu().numpy()]
    n = 262_144
    wph = torch.full((n,), 1 << 61, dtype=torch.int64, device=dev)
    wph[::9] = -1
    for mode, pick in ((J.WINDOW, first), (J.FIRST, first), (J.LAST, last)):
        cases.append(_probe_case(
            f"one window of {width} equal hashes", wph, wbs, word,
            [torch_from(rng.choice(pick, n), dev)], wbv, mode))
    for nb in ((1 << 20) - 1, (1 << 20) + 1):
        bk = rng.integers(0, nb // 2, nb)
        bh, bvals = _hashed_keys(bk, rng.random(nb) < 0.02, -2, dev)
        pk = rng.integers(0, nb // 2, n)
        ph_, pvals = _hashed_keys(pk, rng.random(n) < 0.05, -1, dev)
        bs, order_ = torch.sort(bh, stable=True)
        cases.extend(_probe_case(f"build of {nb} rows", ph_, bs, order_,
                                 [pvals], [bvals], mode)
                     for mode in (J.WINDOW, J.FIRST, J.LAST, J.ALL))
    return cases


def kernel_join_probe(conn, dev, repeat):
    """K5 at phase 3's shapes (join_probe_cases), each held exactly against
    the plain version; the kernel line's time is q13's WINDOW probe (the
    expansion join's), beside two torch.searchsorted calls, and every case
    is printed on a line of its own."""
    results = [run_join_probe_case(c, repeat)
               for c in join_probe_cases(conn, dev)]
    print("join_probe cases: " + json.dumps(results), flush=True)
    window = results[0]
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
            "library_ms": window["library_ms"]}


def join_expand_cases(conn, dev) -> list:
    """Phase 3's K6 shapes: q13's (the LEFT join's pairs of 150,000
    customers with their orders, one null-extended pair for a customer
    without one, at the capacity the executor learns for them); the same
    with the build side in key order (the key lane permuted to sorted
    order, `order` the identity), so the key gather is coalesced; the same
    at half that capacity, below the total; and a skewed probe side of
    1,048,576 rows, one with 2^20 pairs, about 1% with 1-3 and the rest
    none, into 2,097,152 build rows in random order."""
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
    ident = torch.arange(order.shape[0], dtype=torch.int64, device=dev)
    cases = [{"case": "q13", "library": True,
              "args": (counts, cnt, lo, order, pvals, bvals, out_cap)},
             {"case": "q13, build side in key order", "library": False,
              "args": (counts, cnt, lo, ident, pvals,
                       [bvals[0][order].contiguous()], out_cap)},
             {"case": "q13, capacity below the total", "library": False,
              "args": (counts, cnt, lo, order, pvals, bvals, out_cap // 2)}]
    rng = np.random.default_rng(SEED + 12)
    n, nb = 1 << 20, 1 << 21
    some = rng.random(n) < 0.01
    wc = np.where(some, rng.integers(1, 4, n), 0)
    wc[n // 3] = 1 << 20
    los = np.where(some, rng.integers(0, nb - 4, n), 0)
    los[n // 3] = nb // 4
    cnts = np.where(rng.random(n) < 0.002, np.maximum(wc, 1), wc)  # LEFT
    keys = (torch_from(rng.integers(0, 4, n), dev),
            torch_from(rng.integers(0, 4, nb), dev))
    cases.append({"case": "skewed: one probe row of 2^20 pairs",
                  "library": False,
                  "args": (torch_from(cnts, dev), torch_from(wc, dev),
                           torch_from(los, dev),
                           torch_from(rng.permutation(nb), dev), [keys[0]],
                           [keys[1]], bucket_capacity(int(cnts.sum())))})
    return cases


def run_join_expand_case(c, repeat, J=None) -> dict:
    """One K6 case (join_expand_cases) held exactly against its plain
    version, launched twice (bit for bit), timed beside it, its bound and
    its stores alone (torch zeroing the three output lanes); q13's also
    beside torch.repeat_interleave writing the parent lane alone. J: the
    module whose wrapper runs (default: this checkout's ops/join)."""
    import torch
    from presto_tpu_torch.ops import join as mine
    if J is None:
        J = mine
    args = c["args"]
    counts, wcnt, lo, order, pvals, bvals, out_cap = args

    def kernel():
        return J.join_expand(*args)

    def plain():
        return mine._join_expand_plain(*args)

    got, again, want = kernel(), kernel(), plain()
    for g, a, w in zip(got, again, want):
        if not (exact(g, w) and exact(g, a)):
            fail(f"join_expand ({c['case']}) differs from the plain version "
                 f"or between two launches")
    total = int(got[3])
    if total != int(counts.sum()):
        fail(f"join_expand ({c['case']}): the total differs from the sum "
             f"of the counts")
    p, live = counts.shape[0], min(total, out_cap)
    # per probe row its count, window count and start (24 B) and key;
    # per live slot its sorted position's build row (8 B) and that row's
    # key; per slot the probe row, build row and flag written (17 B)
    nbytes = (p * (24 + sum(v.element_size() for v in pvals))
              + live * (8 + sum(v.element_size() for v in bvals))
              + out_cap * 17)
    outs = got[:3]

    def fill():
        for t in outs:
            t.zero_()

    library_ms = None
    if c["library"]:
        rows = torch.arange(p, device=counts.device)
        library_ms = cuda_time_ms(lambda: torch.repeat_interleave(
            rows, counts, output_size=total), repeat)
    return {"case": c["case"], "probe_rows": p, "pairs": total,
            "out_cap": out_cap, "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": library_ms, "fill_ms": cuda_time_ms(fill, repeat)}


def kernel_join_expand(conn, dev, repeat):
    """K6 at join_expand_cases' shapes, each printed; the kernel line is
    q13's, beside torch.repeat_interleave of its parent lane (not the same
    function: it writes neither the build row nor the flag)."""
    cases = [run_join_expand_case(c, repeat)
             for c in join_expand_cases(conn, dev)]
    print("join_expand cases: " + json.dumps(cases), flush=True)
    line = cases[0]
    print(f"join_expand at q13's shape: {line['pairs']} pairs in a capacity "
          f"of {line['out_cap']}: {line['ms']:.5f} ms, "
          f"torch.repeat_interleave of the parent lane "
          f"{line['library_ms']:.5f} ms", flush=True)
    return {"name": "join_expand", "route": "cuda",
            "source": "presto_tpu_torch/csrc/join.cu",
            "replaces": "presto_tpu/ops/join.py:237",
            "max_abs_err": 0.0, "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": "bytes", "library_ms": line["library_ms"]}


def nested_counts(table) -> list:
    """The count query of phase 4d in numpy: the sum over rows of the
    longer of l_partkeys and l_returned, of len(l_partkeys) and of
    len(l_returned), a NULL array counted as 0."""
    pk, ret = table.arrays["l_partkeys"], table.arrays["l_returned"]
    a = np.where(pk.nulls, 0, pk.lengths).astype(np.int64)
    b = np.where(ret.nulls, 0, ret.lengths).astype(np.int64)
    return [(int(np.maximum(a, b).sum()), int(a.sum()), int(b.sum()))]


def _seeded_channels(rng, cap, nch, dev, hi=10, p_null=0.1):
    """K11 inputs: per channel int32 lengths in [0, hi), their exclusive
    prefix as starts, and NULL flags with probability p_null."""
    import torch
    st, ln, nl = [], [], []
    for _ in range(nch):
        lengths = rng.integers(0, hi, cap).astype(np.int32)
        st.append(torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lengths)[:-1]]).astype(np.int32)).to(dev))
        ln.append(torch.from_numpy(lengths).to(dev))
        nl.append(torch.from_numpy(rng.random(cap) < p_null).to(dev))
    return st, ln, nl


def unnest_expand_cases(table, dev) -> list:
    """Phase 3's K11 shapes: phase 4d's (orders_nested's l_partkeys and
    l_returned, 1.5M rows in a 2,097,152-row page; l_returned empty where
    an order has no returned line and NULL where o_orderkey % 97 = 0, with
    the ordinality, at the capacity the executor gives that unnest, the
    bucket of 4x the page's); the same at a capacity below the total
    (4,194,304 slots: the executor's overflow); 9 and 12 seeded channels
    (lengths 0-9, about 10% NULL rows) over 1.5M of 2,097,152 rows at
    phase 4d's capacity; and a skewed page: two channels over 1.5M rows,
    about 60% NULL, 35% empty and 5% of 1-3 elements, and one row of
    2^20 elements."""
    import torch
    from presto_tpu_torch.data.column import bucket_capacity
    page = table.page(columns=["l_partkeys", "l_returned"], device=dev)
    pk, ret = page.columns
    out_cap = bucket_capacity(min(page.capacity * 4, 2**26))
    lanes = ([pk.starts, ret.starts], [pk.lengths, ret.lengths],
             [pk.nulls, ret.nulls], page.num_rows)
    cases = [{"case": "phase 4d", "args": (*lanes, out_cap, True),
              "live": int(page.num_rows), "library": True},
             {"case": "phase 4d, capacity below the total",
              "args": (*lanes, 4_194_304, True),
              "live": int(page.num_rows), "library": False}]
    rng = np.random.default_rng(SEED + 11)
    cap, n = 2_097_152, 1_500_000
    num_rows = torch.tensor(n, dtype=torch.int64, device=dev)
    for nch in (9, 12):
        cases.append({"case": f"{nch} channels",
                      "args": (*_seeded_channels(rng, cap, nch, dev),
                               num_rows, out_cap, True),
                      "live": n, "library": False})
    st, ln, nl = [], [], []
    for c in range(2):
        u = rng.random(cap)
        lengths = np.where(u < 0.95, 0, rng.integers(1, 4, cap))
        if c == 0:
            lengths[n // 3] = 2**20
        nulls = (u < 0.6) & (lengths < 2**20)
        st.append(torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lengths)[:-1]]).astype(np.int32)).to(dev))
        ln.append(torch.from_numpy(lengths.astype(np.int32)).to(dev))
        nl.append(torch.from_numpy(nulls).to(dev))
    cases.append({"case": "skewed: one row of 2^20 elements",
                  "args": (st, ln, nl, num_rows, 2**21, True), "live": n,
                  "library": False})
    return cases


def run_unnest_case(c, repeat, U=None) -> dict:
    """One K11 case (unnest_expand_cases) held exactly against its plain
    version, timed beside it, its bound and its stores alone (torch zeroing
    every output lane); phase 4d's also beside torch.repeat_interleave
    writing the parent lane alone. U: the module whose wrapper runs
    (default: this checkout's ops/unnest)."""
    import torch
    from presto_tpu_torch.ops import unnest as mine
    if U is None:
        U = mine
    args = c["args"]

    def kernel():
        return U.unnest_expand(*args)

    def plain():
        return mine._unnest_expand_plain(*args)

    got, want = kernel(), plain()
    for g, w in zip(got, want):
        if (g is None) != (w is None) or (w is not None and not exact(g, w)):
            fail(f"unnest_expand ({c['case']}) differs from the plain "
                 f"version")
    starts, lengths, nulls, _n, out_cap, ordinality = args
    nch, total = len(lengths), int(got[-1])
    # per live row and channel its start, length (4 B each) and null
    # flag read (rows past num_rows are never read); per slot its parent
    # (8 B), its flag, per channel an element index (8 B) and a flag, and
    # the ordinality (8 B) written
    nbytes = c["live"] * nch * 9 + out_cap * (8 + 1 + 9 * nch
                                              + (8 if ordinality else 0))
    outs = [t for t in got[:5] if t is not None]

    def fill():
        # the kernel's stores alone: every output lane zeroed by torch
        for t in outs:
            t.zero_()

    library_ms = None
    if c["library"]:
        rowlen = lengths[0].new_zeros(lengths[0].shape, dtype=torch.int64)
        for ln, nl in zip(lengths, nulls):
            rowlen = torch.maximum(rowlen, torch.where(nl, 0, ln).long())
        rows = torch.arange(rowlen.shape[0], device=rowlen.device)
        # the parent of each slot, the one lane a library call gives
        library_ms = cuda_time_ms(lambda: torch.repeat_interleave(
            rows, rowlen, output_size=total), repeat)
    return {"case": c["case"], "channels": nch, "slots": total,
            "out_cap": out_cap, "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": library_ms, "fill_ms": cuda_time_ms(fill, repeat)}


def kernel_unnest_expand(table, dev, repeat):
    """K11 at phase 4d's shape and the other unnest_expand_cases, each
    printed; the kernel line is phase 4d, whose total is held against
    numpy's."""
    cases = [run_unnest_case(c, repeat)
             for c in unnest_expand_cases(table, dev)]
    print("unnest_expand cases: " + json.dumps(cases), flush=True)
    line = cases[0]
    if line["slots"] != nested_counts(table)[0][0]:
        fail(f"unnest_expand's total {line['slots']} differs from numpy's")
    print(f"unnest_expand at phase 4d's shape: {line['slots']} slots in a "
          f"capacity of {line['out_cap']}: {line['ms']:.5f} ms, "
          f"torch.repeat_interleave of the parent lane "
          f"{line['library_ms']:.5f} ms", flush=True)
    return {"name": "unnest_expand", "route": "cuda",
            "source": "presto_tpu_torch/csrc/unnest.cu",
            "replaces": "presto_tpu/ops/unnest.py:27",
            "max_abs_err": 0.0, "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": "bytes", "library_ms": line["library_ms"]}


def _hll_bytes(flags: int, live: int, bins: int = 0, groups: int = 0):
    """K12's bytes: `flags` live flags read, each live row's value (8 B)
    and in direct mode its bin code (4 B); in direct mode each bin's
    registers (8 KB) written and its present and count; in sorted mode
    each group's start, end, present and count."""
    return (flags + live * (12 if bins else 8)
            + bins * (2048 * 4 + 16) + groups * 32)


def hll_registers_cases(conn, dev) -> list:
    """Phase 3's K12 shapes, over phase 4e's SF1 columns. Direct mode: a2's
    approx_distinct(l_orderkey) by l_returnflag, l_linestatus (12 bins,
    6,001,215 rows in the 8,388,608-row page), its first values replaced by
    values whose hash has w = 2^k - 1 for k in 0..53 (where the float32
    rounding moves the rank; the kernel line); a1's global l_partkey; and
    8,388,608 rows of one value (every row on one register). Sorted mode:
    1,500,000 one-row groups (a 2,097,152-row page, as orders by
    o_orderkey), a3's 10,000 groups of about 600 rows and a4's seven
    groups of about 0.86M rows, over l_partkey."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    page = conn.table("lineitem").page(
        ["l_returnflag", "l_linestatus", "l_orderkey", "l_partkey"],
        device=dev)
    rf, ls, okey, pkey = page.columns
    cap, n = page.capacity, int(page.num_rows)
    live = page.row_valid()
    live_rows = int(live.sum())
    bounds = torch.from_numpy(np.concatenate(
        [hll_boundary_values(range(54), r) for r in (0, 7, 2047)])).to(dev)
    vals = okey.values.clone()
    vals[:bounds.shape[0]] = bounds
    keys = [(rf.values.to(torch.int32), rf.nulls),
            (ls.values.to(torch.int32), ls.nulls)]
    domains = [len(rf.dictionary), len(ls.dictionary)]
    bins = (domains[0] + 1) * (domains[1] + 1)
    codes = A._bin_codes(keys, domains, cap, dev)
    zero = torch.zeros(cap, dtype=torch.int32, device=dev)
    cases = [{"case": "direct, a2", "vals": vals, "live": live,
              "mode": {"codes": codes, "bins": bins},
              "bytes": _hll_bytes(cap, live_rows, bins=bins)},
             {"case": f"global, a1 ({n} rows)", "vals": pkey.values,
              "live": live, "mode": {"codes": zero, "bins": 1},
              "bytes": _hll_bytes(cap, live_rows, bins=1)},
             {"case": f"direct, {cap} rows of one value",
              "vals": torch.full((cap,), 42, dtype=torch.int64, device=dev),
              "live": torch.ones(cap, dtype=torch.bool, device=dev),
              "mode": {"codes": zero, "bins": 1},
              "bytes": _hll_bytes(cap, cap, bins=1)}]
    rng = np.random.default_rng(SEED + 13)
    sizes = {"1,500,000 one-row groups": (
                 np.ones(1_500_000, np.int64), 2_097_152, 2_097_152),
             "a3, 10,000 groups": (
                 np.bincount(rng.integers(0, 10_000, n), minlength=10_000),
                 cap, 16_384),
             "a4, seven 0.86M-row groups": (
                 np.bincount(rng.integers(0, 7, n), minlength=7), cap, 1024)}
    for what, (lengths, rows_cap, g_cap) in sizes.items():
        ends_np = np.cumsum(lengths)
        total = int(ends_np[-1])
        pad = g_cap - len(lengths)
        ends = torch.from_numpy(np.concatenate(
            [ends_np, np.full(pad, total)])).to(dev)
        starts = torch.from_numpy(np.concatenate(
            [ends_np - lengths, np.full(pad, total)])).to(dev)
        cases.append({"case": f"sorted, {what} ({total} rows, {g_cap} group "
                              f"slots)",
                      "vals": pkey.values[:rows_cap].contiguous(),
                      "live": torch.arange(rows_cap, device=dev) < total,
                      "mode": {"starts": starts, "ends": ends},
                      "bytes": _hll_bytes(total, total, groups=g_cap)})
    return cases


def run_hll_case(c, repeat, A=None) -> dict:
    """One K12 case (hll_registers_cases): registers, present and count
    held exactly against the plain version and between two launches,
    timed beside the plain version and the bound. A: the module whose
    wrapper runs (default: this checkout's ops/aggregate)."""
    from presto_tpu_torch.ops import aggregate as mine
    if A is None:
        A = mine
    vals, live, mode = c["vals"], c["live"], c["mode"]

    def kernel():
        return A.hll_registers(vals, live, **mode)

    def plain():
        return mine._hll_registers_plain(vals, live, mode.get("codes"),
                                         mode.get("bins"),
                                         mode.get("starts"),
                                         mode.get("ends"))

    got, again, want = kernel(), kernel(), plain()
    for name, g, a, w in zip(("present", "count", "registers"), got, again,
                             want):
        if (g is None) != (w is None) or (g is not None and not (
                exact(g, w) and exact(g, a))):
            fail(f"hll_registers ({c['case']}) {name} differ from the plain "
                 f"version or between two launches")
    return {"case": c["case"], "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3}


def kernel_hll_registers(conn, dev, repeat) -> dict:
    """K12 at hll_registers_cases' shapes, each printed on a line of its
    own; the kernel line is a2's direct mode."""
    cases = [run_hll_case(c, repeat) for c in hll_registers_cases(conn, dev)]
    print("hll_registers cases: " + json.dumps(cases), flush=True)
    for r in cases:
        print(f"hll_registers {r['case']}: {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms",
              flush=True)
    line = cases[0]
    return {"name": "hll_registers", "route": "cuda",
            "source": "presto_tpu_torch/csrc/hll.cu",
            "replaces": "presto_tpu/ops/aggregate.py:71",
            "max_abs_err": 0.0, "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def same_bits(a, b) -> bool:
    """Equal bit for bit (float64 compared as int64: NaN payloads and the
    sign of zero count)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return bool(torch.equal(a, b))


def _runs_of(sorted_keys, total: int, g_cap: int):
    """starts and ends of the runs of equal keys in sorted_keys[:total],
    padded with empty runs at `total` to g_cap slots."""
    import torch
    _, counts = torch.unique_consecutive(sorted_keys[:total],
                                         return_counts=True)
    ends = torch.cumsum(counts, 0)
    pad = torch.full((g_cap - len(counts),), total, dtype=torch.int64,
                     device=sorted_keys.device)
    return torch.cat([ends - counts, pad]), torch.cat([ends, pad])


def segment_select_cases(conn, dev) -> list:
    """K13's inputs as phase 4e's queries give them at SF1, each a dict
    (case, vals, live, p, mode: the groups, bytes: what the kernel must
    read and write): a1's l_quantity, global (one bin over the
    8,388,608-row page); a2's l_extendedprice over the bins of
    (l_returnflag, l_linestatus); a3's l_discount over the 10,000 l_suppkey
    runs of the group-sorted page (16,384 group slots); a4's l_shipdate
    over the seven l_linenumber runs (1,024 slots). The runs' rows are in
    page order within each run, as the sorted path's stable sort leaves
    them."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    from presto_tpu_torch.ops.keys import lex_perm
    page = conn.table("lineitem").page(
        ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate",
         "l_returnflag", "l_linestatus", "l_suppkey", "l_linenumber"],
        device=dev)
    qty, price, disc, ship, rf, ls, supp, lno = page.columns
    cap, valid = page.capacity, page.row_valid()
    total = int(page.num_rows)
    cases = []

    def add(case, vals, live, p, mode, rows, groups):
        vals = A._kernel_values(vals)
        size = vals.element_size()
        # the codes are read where there is more than one bin
        per_row = size + 1 + (4 if mode.get("bins", 0) > 1 else 0)
        per_group = size + 1 + (16 if "starts" in mode else 0)
        cases.append({"case": case, "vals": vals, "live": live, "p": p,
                      "mode": mode,
                      "bytes": rows * per_row + groups * per_group})

    add("a1, global, l_quantity", qty.values, valid & ~qty.nulls, 0.5,
        {"codes": torch.zeros(cap, dtype=torch.int32, device=dev),
         "bins": 1}, cap, 1)
    domains, prod = A._direct_domains(page, [4, 5])
    codes = A._bin_codes([(c.values.to(torch.int32), c.nulls)
                          for c in (rf, ls)], domains, cap, dev)
    add(f"a2, direct, l_extendedprice over {prod} bins", price.values,
        valid & ~price.nulls, 0.9, {"codes": codes, "bins": prod}, cap,
        prod)
    for name, key, col, p, g_cap in (
            ("a3, sorted, l_discount over 10,000 runs", supp, disc, 0.25,
             16_384),
            ("a4, sorted, l_shipdate over 7 runs", lno, ship, 0.5, 1024)):
        perm = lex_perm([(~valid).to(torch.int8) * 2
                         + key.nulls.to(torch.int8), key.values])
        starts, ends = _runs_of(key.values[perm], total, g_cap)
        add(name, col.values[perm], (valid & ~col.nulls)[perm], p,
            {"starts": starts, "ends": ends}, total, g_cap)
    return cases


def run_select_case(c, repeat) -> dict:
    """One K13 case (segment_select_cases): two launches held bit for bit
    against each other and the plain version (lex_perm, gather, pick: the
    parent's chain, all in torch ops), timed beside it and the bound; a1's
    result also held against torch.kthvalue over its live values, whose
    time is the library call's."""
    import torch
    from presto_tpu_torch.ops import aggregate as A
    vals, live, mode, p = c["vals"], c["live"], c["mode"], c["p"]

    def kernel():
        return A.segment_select(vals, live, p, **mode)

    def plain():
        return A._segment_select_plain(vals, live, p, mode.get("codes"),
                                       mode.get("bins"), mode.get("starts"),
                                       mode.get("ends"))

    got, again, want = kernel(), kernel(), plain()
    for g, a, w in zip(got, again, want):
        if not (same_bits(g, w) and same_bits(g, a)):
            fail(f"segment_select ({c['case']}) differs from the plain "
                 f"version or between two launches")
    row = {"case": c["case"], "max_abs_err": 0.0,
           "ms": cuda_time_ms(kernel, repeat),
           "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
           "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3,
           "library_ms": None}
    if mode.get("bins") == 1:
        lv = vals[live]
        k = int(np.floor(p * (lv.shape[0] - 1))) + 1
        if float(torch.kthvalue(lv, k).values) != float(got[0][0]):
            fail(f"segment_select ({c['case']}) differs from torch.kthvalue")
        row["library_ms"] = cuda_time_ms(lambda: torch.kthvalue(lv, k),
                                         repeat)
    return row


def kernel_segment_select(conn, dev, repeat) -> dict:
    """K13 at segment_select_cases' shapes, each printed on a line of its
    own; the kernel line is a1's, with torch.kthvalue as the library
    call."""
    cases = [run_select_case(c, repeat)
             for c in segment_select_cases(conn, dev)]
    print("segment_select cases: " + json.dumps(cases), flush=True)
    for r in cases:
        print(f"segment_select {r['case']}: {r['ms']:.5f} ms, lex_perm "
              f"chain (plain) {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms", flush=True)
    line = cases[0]
    return {"name": "segment_select", "route": "cuda",
            "source": "presto_tpu_torch/csrc/percentile.cu",
            "replaces": "presto_tpu/ops/aggregate.py:392",
            "max_abs_err": 0.0, "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": "bytes", "library_ms": line["library_ms"]}


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


def seg_scan_cases(q51_calls, conn, dev) -> list:
    """Phase 3's K7 shapes: the running sum and running max of TPC-DS
    q51's largest window inputs (partition by item, order by date, ROWS
    UNBOUNDED PRECEDING), the same values scanned without segments beside
    torch.cumsum and torch.cummax (the same functions), the forward and
    reverse last-present-position scans of orders' partition starts and
    ends (partition by o_custkey), and window_bounds over orders' partition
    and peer start flags (the four such scans of one window in one
    launch)."""
    import torch
    from presto_tpu_torch.ops import scan as S
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
        op = "add" if kind == "sum" else "max"
        x = torch.where(live, v, 0.0 if kind == "sum" else float("-inf"))
        rows = int(page.num_rows)
        cases.append({"case": f"q51 running {kind} ({rows} rows)", "x": x,
                      "op": op, "reverse": False, "seg": sw.part_start,
                      "library": None})
        cases.append({"case": f"q51 {kind} values, one segment", "x": x,
                      "op": op, "reverse": False, "seg": None,
                      "library": (torch.cumsum if kind == "sum"
                                  else torch.cummax)})
    _page, sw = _orders_window(conn, dev)
    cases.append({"case": "orders partition starts, last present",
                  "x": sw.part_start, "op": "last", "reverse": False,
                  "seg": None, "library": None})
    cases.append({"case": "orders partition ends, last present reversed",
                  "x": S.shift_left(sw.part_start), "op": "last",
                  "reverse": True, "seg": None, "library": None})
    cases.append({"case": "orders window bounds", "op": "bounds",
                  "part_start": sw.part_start, "peer_start": sw.peer_start})
    return cases


def _four_scans(S, part, peer):
    """A window's four position scans as separate segmented_scan launches
    (with the two shifts), for a checkout whose ops/scan.py has no
    window_bounds."""
    from presto_tpu_torch.ops.scan import shift_left
    return (S.segmented_scan(part, "last"),
            S.segmented_scan(shift_left(part), "last", True),
            S.segmented_scan(peer, "last"),
            S.segmented_scan(shift_left(peer), "last", True))


def run_scan_case(c, repeat, S=None) -> dict:
    """One K7 case (seg_scan_cases) held against its plain version (exact;
    float64 sums within RTOL_SUM and bit for bit between two launches) and
    timed beside it, its bound and the library call where one computes the
    same function. S: the module whose wrappers run (default: this
    checkout's ops/scan); the bounds case runs as four segmented_scan
    launches where S has no window_bounds."""
    import torch
    from presto_tpu_torch.ops import scan as mine
    if S is None:
        S = mine
    if c["op"] == "bounds":
        part, peer = c["part_start"], c["peer_start"]
        if hasattr(S, "window_bounds"):
            def kernel():
                return S.window_bounds(part, peer)
        else:
            def kernel():
                return _four_scans(S, part, peer)

        def plain():
            return mine._window_bounds_plain(part, peer)

        for g, a, w in zip(kernel(), kernel(), plain()):
            if not (exact(g, w) and exact(g, a)):
                fail(f"window_bounds ({c['case']}) differs from the plain "
                     f"version or between two launches")
        n = part.shape[0]
        return {"case": c["case"], "op": "bounds", "rows": n,
                "max_abs_err": 0.0, "ms": cuda_time_ms(kernel, repeat),
                "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
                # two flags read, four int64 positions written
                "bound_ms": n * (2 + 32) / HBM_BYTES_PER_S * 1e3,
                "library_ms": None}
    x, op, reverse, seg = c["x"], c["op"], c["reverse"], c["seg"]

    def kernel():
        return S.segmented_scan(x, op, reverse, seg)

    def plain():
        return mine._segmented_scan_plain(x, op, reverse, seg)

    got, again, want = kernel(), kernel(), plain()
    what = f"segmented_scan ({c['case']})"
    if op == "add" and x.dtype.is_floating_point:
        err = close(got, want, RTOL_SUM)
        if not torch.equal(got.view(torch.int64), again.view(torch.int64)):
            fail(f"{what}: two launches differ")
    else:
        if not (exact(got, want) and exact(got, again)):
            fail(f"{what} differs from the plain version")
        err = 0.0
    n = x.shape[0]
    # each value (or present flag) and segment flag read once, each result
    # written once
    nbytes = n * (x.element_size() + (1 if seg is not None else 0)
                  + got.element_size())
    lib = c["library"]
    return {"case": c["case"], "op": op, "rows": n, "max_abs_err": err,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": (cuda_time_ms(lambda: lib(x, 0), repeat)
                           if lib is not None else None)}


def kernel_seg_scan(q51_calls, conn, dev, repeat):
    """K7 at the breadth path's SF1 shapes (seg_scan_cases), each held
    against its plain version and printed on a line of its own. The kernel
    line is the unsegmented sum over q51's values, the case that one
    PyTorch call (torch.cumsum) also computes."""
    cases = [run_scan_case(c, repeat)
             for c in seg_scan_cases(q51_calls, conn, dev)]
    print("segmented_scan cases: " + json.dumps(cases), flush=True)
    line = cases[1]
    print(f"K7 unsegmented sum over {line['rows']} float64 values: "
          f"{line['ms']:.5f} ms, torch.cumsum {line['library_ms']:.5f} ms",
          flush=True)
    return {"name": "segmented_scan", "route": "cuda",
            "source": "presto_tpu_torch/csrc/seg_scan.cu",
            "replaces": "presto_tpu/ops/scan.py:36",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": line["ms"], "plain_ms": line["plain_ms"],
            "bound_ms": line["bound_ms"], "bound_by": "bytes",
            "library_ms": line["library_ms"]}


def capture_key_changes(engine, sql: str) -> list:
    """The key_change_flags calls (perm, keys, num_rows, n_part_keys,
    mode) a query makes through the window and distinct operators,
    recorded while it runs on `engine`."""
    from presto_tpu_torch.ops import mark_distinct as M
    from presto_tpu_torch.ops import window as W
    calls = []
    orig = W.key_change_flags

    def record(perm, keys, num_rows, n_part_keys=0, mode=0):
        calls.append((perm, keys, num_rows, n_part_keys, mode))
        return orig(perm, keys, num_rows, n_part_keys, mode)

    W.key_change_flags = M.key_change_flags = record
    try:
        engine.execute_sql(sql)
    finally:
        W.key_change_flags = M.key_change_flags = orig
    return calls


def key_change_cases(conn, dev) -> list:
    """Phase 3's K8 shapes: the partition and peer flags of orders
    (2,097,152-row page) sorted by o_custkey, o_orderdate (rows scattered:
    each gather a sector of its own), and the first flags of a distinct
    mark over the same keys; the same keys taken in row order (the
    identity permutation: every gather coalesced), which shows what the
    scattered gathers cost; and the largest calls of two breadth-path
    queries, captured while they run on the card: h_rank's window over
    lineitem by l_orderkey (rows nearly in order) and h_distinct's
    distinct mark of l_returnflag, l_suppkey."""
    import torch
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops import keys as K
    page, sw = _orders_window(conn, dev)
    ident = torch.arange(sw.perm.shape[0], dtype=torch.int64, device=dev)
    cases = [{"case": f"orders by o_custkey, o_orderdate ({name})",
              "perm": perm, "keys": sw.keys, "num_rows": page.num_rows,
              "npart": npart, "mode": mode}
             for name, perm, npart, mode in (
                 ("WINDOW", sw.perm, 1, K.WINDOW_FLAGS),
                 ("FIRST", sw.perm, 0, K.FIRST_FLAGS),
                 ("WINDOW, rows in row order", ident, 1, K.WINDOW_FLAGS))]
    engine = LocalEngine(conn)
    for name in ("h_rank", "h_distinct"):
        calls = capture_key_changes(engine, TPCH_BREADTH[name][0])
        perm, keys, num_rows, npart, mode = max(
            calls, key=lambda c: c[0].shape[0])
        cases.append({"case": f"{name}'s largest call", "perm": perm,
                      "keys": keys, "num_rows": num_rows, "npart": npart,
                      "mode": mode})
    return cases


def run_key_change_case(c, repeat, K=None) -> dict:
    """One key_change_flags call held exactly against its plain version
    and timed beside it and its bound. K: the module whose wrapper runs
    (default: this checkout's ops/keys)."""
    from presto_tpu_torch.ops import keys as mine
    if K is None:
        K = mine
    args = (c["perm"], c["keys"], c["num_rows"], c["npart"], c["mode"])

    def kernel():
        return K.key_change_flags(*args)

    def plain():
        return mine._key_change_plain(*args)

    for g, w in zip(kernel(), plain()):
        if (g is None) != (w is None) or (w is not None and not exact(g, w)):
            fail(f"key_change_flags ({c['case']}) differs from the plain "
                 f"version")
    cap = c["perm"].shape[0]
    # perm read (8 B), each key's lanes at every row (null flag 1 B and
    # value, 4 or 8 B), one flag a mode's output written
    lane_bytes = sum((1 if nl is not None else 0)
                     + sum(v.element_size() for v in vs)
                     for nl, vs in c["keys"])
    nbytes = cap * (8 + lane_bytes + (2 if c["mode"] == 0 else 1))
    return {"case": c["case"], "rows": cap, "max_abs_err": 0.0,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def kernel_key_change(conn, dev, repeat):
    """K8 at the running-sum query's SF1 shape (key_change_cases); the
    kernel line is the WINDOW flags."""
    cases = [run_key_change_case(c, repeat)
             for c in key_change_cases(conn, dev)]
    print("key_change_flags cases: " + json.dumps(cases), flush=True)
    line = cases[0]
    return {"name": "key_change_flags", "route": "cuda",
            "source": "presto_tpu_torch/csrc/keys.cu",
            "replaces": "presto_tpu/ops/window.py:171",
            "max_abs_err": 0.0, "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": "bytes",
            # no single PyTorch call compares keys across a permutation
            "library_ms": None}


def window_frame_cases(conn, dev) -> list:
    """Phase 3's K9 shapes, over orders at SF1 (2,097,152-row page, 1.5M
    rows) partitioned by o_custkey and ordered by o_orderdate, as the
    running-sum query of the breadth path sorts it: rank, the running sum
    of o_totalprice (the SQL default frame, peer-aware), the min of
    o_totalprice over ROWS 3 PRECEDING .. 3 FOLLOWING (folded in shared
    memory) and over ROWS 1000 PRECEDING .. 1000 FOLLOWING (a sparse
    table); the first three again with the identity permutation (each
    row's value stored at its own position, coalesced), which shows what
    the scattered stores cost. Each case: its window_frame arguments and
    the int64 inputs the function reads besides perm."""
    import dataclasses
    import torch
    from presto_tpu_torch.ops import window as W
    from presto_tpu_torch.types import BIGINT, DOUBLE
    page, sw = _orders_window(conn, dev)
    ident = dataclasses.replace(sw, perm=torch.arange(
        sw.perm.shape[0], dtype=torch.int64, device=dev))
    specs = [
        ("rank", W.WindowSpec("rank", None, BIGINT), 2),
        ("running sum", W.WindowSpec("sum", 2, DOUBLE), 4),
        ("min, 3 preceding .. 3 following",
         W.WindowSpec("min", 2, DOUBLE, frame=W.Frame(
             "rows", "preceding", 3, "following", 3)), 4),
    ]
    wide = ("min, 1000 preceding .. 1000 following",
            W.WindowSpec("min", 2, DOUBLE, frame=W.Frame(
                "rows", "preceding", 1000, "following", 1000)), 4)
    cases = []
    for tag, s_w, chosen in (("", sw, specs + [wide]),
                             (", identity permutation", ident, specs)):
        for what, spec, reads in chosen:
            fi = W.frame_inputs(page, s_w, spec)
            cases.append({
                "case": what + tag, "kind": spec.kind, "reads": reads,
                "args": (spec.kind, fi.frame, fi.iparams, fi.dparams,
                         s_w.perm, page.num_rows, s_w.ps, s_w.pe, s_w.qs,
                         s_w.qe, fi.vals, fi.nulls, fi.aux_i, fi.aux_v,
                         fi.out_dtype)})
    return cases


def run_window_frame_case(c, repeat, W=None) -> dict:
    """One K9 case (window_frame_cases) held against its plain version
    (exact; float64 sums within RTOL_SUM) and between two launches (bit
    for bit), timed beside it, its bound and its two scattered stores
    alone (torch's index_copy_ of the value and the null flag through
    perm). W: the module whose wrapper runs (default: this checkout's
    ops/window)."""
    import torch
    from presto_tpu_torch.ops import window as mine
    if W is None:
        W = mine
    args = c["args"]

    def kernel():
        return W.window_frame(*args)

    def plain():
        return mine._window_frame_plain(*args)

    (gv, gn), (av, an), (pv, pn) = kernel(), kernel(), plain()
    what = f"window_frame ({c['case']})"
    if not exact(gn, pn):
        fail(f"{what}: nulls differ from the plain version")
    if not (exact(gn, an) and torch.equal(_bits(gv), _bits(av))):
        fail(f"{what}: two launches differ")
    err = 0.0
    if c["kind"] == "sum":
        err = close(gv, pv, RTOL_SUM)
    elif not exact(gv, pv):
        fail(f"{what} differs from the plain version")
    perm = args[4]
    cap = perm.shape[0]

    def scatter():
        # the kernel's two stores a row alone, as torch's scatter
        out_v.index_copy_(0, perm, gv)
        out_n.index_copy_(0, perm, gn)

    out_v, out_n = torch.empty_like(gv), torch.empty_like(gn)
    # perm and `reads` int64 position or prefix arrays read (8 B each),
    # the value (8 B) and null flag written
    nbytes = cap * (8 + 8 * c["reads"] + 9)
    return {"case": c["case"], "rows": cap, "max_abs_err": err,
            "ms": cuda_time_ms(kernel, repeat),
            "plain_ms": cuda_time_ms(plain, max(repeat // 4, 2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "scatter_ms": cuda_time_ms(scatter, repeat)}


def kernel_window_frame(conn, dev, repeat):
    """K9 at the running-sum query's SF1 shape (window_frame_cases), each
    case printed; the kernel line is the running sum."""
    cases = [run_window_frame_case(c, repeat)
             for c in window_frame_cases(conn, dev)]
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


def _capture(module, name: str, engine, sql: str, size):
    """(the function, the arguments of its largest call by `size`) of
    module.<name> while `sql` runs on `engine`."""
    calls = []
    orig = getattr(module, name)

    def record(*args):
        calls.append(args)
        return orig(*args)

    setattr(module, name, record)
    try:
        engine.execute_sql(sql)
    finally:
        setattr(module, name, orig)
    return orig, max(calls, key=size)


def _row_bytes(columns) -> int:
    """Bytes of one row of `columns`: each value and its null flag."""
    return sum(c.values.element_size() + 1 for c in columns)


def _stage_row(stage, shape, rows, fn, nbytes, repeat) -> dict:
    return {"stage": stage, "shape": shape, "rows": rows,
            "ms": cuda_time_ms(fn, repeat),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "device_kernels": _device_kernels(fn)}


def _full_outer_append_row(ds_conn, repeat) -> dict:
    """full_outer_append (torch + K2) at TPC-DS q97's SF1 shape: the
    arguments of its largest call while q97 runs on the card."""
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops import join as J
    orig, (left, probe, build, unmatched) = _capture(
        J, "full_outer_append", LocalEngine(ds_conn),
        tpcds_queries()[0][97], lambda c: c[1].capacity + c[2].capacity)
    pcap, bcap = probe.capacity, build.capacity
    width = _row_bytes(left.columns)
    # the left page and the build columns read, the unmatched flags read,
    # the appended page written (values and null flags)
    nbytes = (pcap * width + bcap * (_row_bytes(build.columns) + 1)
              + (pcap + bcap) * width)
    return _stage_row("full_outer_append", "q97 FULL join", pcap + bcap,
                      lambda: orig(left, probe, build, unmatched), nbytes,
                      repeat)


def _breadth_op_rows(conn, ds_conn, repeat) -> list:
    """MarkDistinct, GroupId and UNION ALL at their SF1 shapes: the
    arguments of each one's largest call while the breadth path's TPC-H
    count(distinct), TPC-DS q67's ROLLUP and q75's UNION ALL run on the
    card."""
    from presto_tpu_torch.exec import executor as X
    from presto_tpu_torch.exec.engine import LocalEngine
    ds = tpcds_queries()[0]
    orig, (page, keys, name) = _capture(
        X, "mark_distinct", LocalEngine(conn),
        TPCH_BREADTH["h_distinct"][0], lambda c: c[0].capacity)
    cap, width = page.capacity, _row_bytes(page.columns)
    # every column read and written in the new order, the flag written
    md = _stage_row("mark_distinct", "lineitem count(distinct l_suppkey)",
                    cap, lambda: orig(page, keys, name),
                    cap * (2 * width + 2), repeat)
    orig, (src, node) = _capture(X, "group_id_page", LocalEngine(ds_conn),
                                 ds[67], lambda c: c[0].capacity)
    cap, width = src.capacity, _row_bytes(src.columns)
    sets = len(node.grouping_sets)
    # the source read once, each set's copy and the set id written
    gi = _stage_row("group_id", f"q67 ROLLUP, {sets} sets", sets * cap,
                    lambda: orig(src, node), cap * width
                    + sets * cap * (width + 9), repeat)
    orig, (ps, node, merged) = _capture(
        X, "union_all_pages", LocalEngine(ds_conn), ds[75],
        lambda c: sum(p.capacity for p in c[0]))
    rows = sum(p.capacity for p in ps)
    # each branch read once, the concatenated page written once
    nbytes = sum(p.capacity * _row_bytes(p.columns) for p in ps) \
        + rows * _row_bytes(ps[0].columns)
    ua = _stage_row("union_all", f"q75, {len(ps)} branches", rows,
                    lambda: orig(ps, node, merged), nbytes, repeat)
    return [md, gi, ua]


def _wide_minmax_row(dec_conn, repeat) -> dict:
    """The DECIMAL(p>18) min/max of the direct path at its SF1 shape: the
    arguments of DECIMAL_MINMAX's min while it runs on the card over the
    DECIMAL(12,2) lineitem."""
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops import aggregate as A
    orig, args = _capture(A, "_wide_minmax_direct", LocalEngine(dec_conn),
                          DECIMAL_MINMAX, lambda c: c[0] == "min")
    cap = args[1][0].shape[0]
    # four limb lanes, the live flag and the bin code read per row
    return _stage_row("wide_minmax", f"DECIMAL(33,4) min, {args[4]} bins",
                      cap, lambda: orig(*args), cap * (4 * 8 + 1 + 4),
                      repeat)


def torch_op_rows(conn, ds_conn, dec_conn, dev, repeat) -> list:
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
    - full_outer_append: TPC-DS q97's FULL join tail;
    - mark_distinct, group_id and union_all: the breadth path's largest
      MarkDistinct, GroupId and UNION ALL calls;
    - wide_minmax: the decimal path's DECIMAL(p>18) min."""
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
    rows.extend(_breadth_op_rows(conn, ds_conn, repeat))
    rows.append(_wide_minmax_row(dec_conn, repeat))
    print("torch-op stages at SF1: " + json.dumps(rows), flush=True)
    return rows


class CallCounter:
    """Counts calls of the torch-op stages on the card on a main path
    (the CPU comparisons do not count): the stable key sorts of
    lex_perm/sort_perm (ops/keys._argsort, one torch.sort each), the
    evaluations of compiled expressions (exec/executor's compile_expr),
    the FULL joins' appends (ops/join.full_outer_append), GroupId and
    UNION ALL (exec/executor's group_id_page and union_all_pages) and the
    DECIMAL(p>18) min/max (ops/aggregate's _wide_minmax_direct and
    _wide_minmax_sorted)."""

    def __init__(self):
        from presto_tpu_torch.exec import executor as X
        from presto_tpu_torch.ops import aggregate as A
        from presto_tpu_torch.ops import keys as K
        from presto_tpu_torch.ops import join as J
        self.counts = {"key_sorts": 0, "expression_evaluations": 0,
                       "full_outer_appends": 0, "group_id_pages": 0,
                       "union_all_pages": 0, "wide_minmax": 0}
        argsort, compile_expr = K._argsort, X.compile_expr
        append = J.full_outer_append

        def counted(module, name, key, on_card):
            fn = getattr(module, name)

            def run(*args):
                self.counts[key] += on_card(*args)
                return fn(*args)
            setattr(module, name, run)

        counted(X, "group_id_page", "group_id_pages",
                lambda src, _node: src.device.type == "cuda")
        counted(X, "union_all_pages", "union_all_pages",
                lambda pages, *_: pages[0].device.type == "cuda")
        for name in ("_wide_minmax_direct", "_wide_minmax_sorted"):
            counted(A, name, "wide_minmax",
                    lambda _kind, lanes, *_: lanes[0].is_cuda)

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


def _run_queries(engine, queries, counters, what, required=None,
                 transforms=None) -> tuple:
    """Each query cold then warm on the card, with the kernels' launch
    counts set to 0 just before and read just after. Returns (rows of
    the cold and the warm run, walls, launches per query and run,
    launches in all). Fails where a kernel of `required` (names; default
    all) was not launched. With `transforms` (a dict), fills it with the
    dictionary transforms each run computed: name -> [cold, warm]."""
    import torch
    from presto_tpu_torch.expr.compile import DICT_CACHE
    rows, walls, per_query = {}, {}, {}
    for k in counters:
        k.launches = 0
    for name, (sql, _ordered) in queries.items():
        walls[name], rows[name] = [], []
        for _run in range(2):           # cold (uploads, retries), warm
            before = [k.launches for k in counters]
            computed = DICT_CACHE.computed
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows[name].append(engine.execute_sql(sql))
            walls[name].append(time.perf_counter() - t)
            per_query.setdefault(name, []).append(
                [k.launches - b for k, b in zip(counters, before)])
            if transforms is not None:
                transforms.setdefault(name, []).append(
                    DICT_CACHE.computed - computed)
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
    transforms = {}
    gpu_rows, walls, per_query, launches = _run_queries(
        gpu, queries, counters, "main path", required, transforms)
    for name, (_sql, ordered) in queries.items():
        cold, warm = gpu_rows[name]
        rows_match(cold, warm, f"{name} card cold vs warm", ordered)
        if name in expected:
            rows_match(warm, expected[name], f"{name} card vs numpy",
                       ordered)
    # the dictionary transforms (LIKE, substring, the literal merges) are
    # built once per dictionary: a warm run computes none
    for name in ("q13", "q22"):
        print(f"{name}: warm wall {walls[name][1] * 1e3:.1f} ms; dictionary "
              f"transforms computed cold {transforms[name][0]}, warm "
              f"{transforms[name][1]}", flush=True)
    for name, (cold_n, warm_n) in transforms.items():
        if warm_n:
            fail(f"{name}: its warm run computed {warm_n} dictionary "
                 f"transforms (cold {cold_n})")

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
    for name in ("segmented_scan", "segmented_scan_bounds",
                 "key_change_flags", "window_frame"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the breadth path")

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


class ModeCount:
    """A kernel mode's launch count (the wrapper's `attr`, by default
    `sum128_launches`, or with `mode` its entry of `mode_launches`), read
    and reset as a wrapper's `launches` is."""

    def __init__(self, fn, name: str, mode=None, attr="sum128_launches"):
        self.fn, self.__name__, self.mode, self.attr = fn, name, mode, attr

    @property
    def launches(self) -> int:
        if self.mode is None:
            return getattr(self.fn, self.attr)
        return self.fn.mode_launches[self.mode]

    @launches.setter
    def launches(self, v: int) -> None:
        if self.mode is None:
            setattr(self.fn, self.attr, v)
        else:
            self.fn.mode_launches[self.mode] = v


def _half_up(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def decimal_numpy_reference(table, part) -> dict:
    """q01, q06 and q14 over the DECIMAL(12,2) lineitem (`table`) and
    `part` with numpy int64 alone: sums of unscaled cents, products at
    scale 4 and 6 (q01's sum_charge per group is about 1.7e17 units of
    1e-6 at SF1, inside int64), averages HALF_UP at scale 2; q14's
    quotient of its two exact sums in Python Decimal."""
    from decimal import Decimal
    a = {c: v[:table.num_rows] for c, v in table.arrays.items()}
    words = {c: table.dicts[c].words for c in ("l_returnflag",
                                                "l_linestatus")}
    ship, qty, price = a["l_shipdate"], a["l_quantity"], a["l_extendedprice"]
    disc, tax = a["l_discount"], a["l_tax"]
    f = ship <= _days(1998, 12, 1) - 90
    nls = len(words["l_linestatus"])
    code = a["l_returnflag"][f].astype(np.int64) * nls + a["l_linestatus"][f]
    uniq, inv = np.unique(code, return_inverse=True)
    disc_price = price[f] * (100 - disc[f])
    charge = disc_price * (100 + tax[f])

    def sums(w):
        out = np.zeros(len(uniq), np.int64)
        np.add.at(out, inv, w)
        return out
    cnt = np.bincount(inv)
    s = [sums(w) for w in (qty[f], price[f], disc_price, charge)]
    avg = [sums(w) for w in (qty[f], price[f], disc[f])]
    q01 = []
    for i, u in enumerate(uniq):
        q01.append((words["l_returnflag"][u // nls],
                    words["l_linestatus"][u % nls],
                    *(Decimal(int(x[i])).scaleb(-k)
                      for x, k in zip(s, (2, 2, 4, 6))),
                    *(Decimal(_half_up(int(x[i]), int(cnt[i]))).scaleb(-2)
                      for x in avg), int(cnt[i])))
    m = ((ship >= _days(1994, 1, 1)) & (ship < _days(1995, 1, 1))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    q06 = [(Decimal(int(np.sum(price[m] * disc[m]))).scaleb(-4),)]
    code = a["l_returnflag"].astype(np.int64) * nls + a["l_linestatus"]
    prod = price * (100 - disc)
    minmax = [(words["l_returnflag"][u // nls], words["l_linestatus"][u % nls],
               Decimal(int(prod[code == u].min())).scaleb(-4),
               Decimal(int(prod[code == u].max())).scaleb(-4))
              for u in np.unique(code)]
    m = (ship >= _days(1995, 9, 1)) & (ship < _days(1995, 10, 1))
    partkey = part.arrays["p_partkey"][:part.num_rows]
    row = np.searchsorted(partkey, a["l_partkey"][m])
    if not np.array_equal(partkey[row], a["l_partkey"][m]):
        fail("q14's numpy reference: a part key is not in part")
    promo_word = np.array([w.startswith("PROMO")
                           for w in part.dicts["p_type"].words])
    promo = promo_word[part.arrays["p_type"][:part.num_rows][row]]
    rev = price[m] * (100 - disc[m])                      # scale 4
    s_promo, s_all = int(np.sum(rev[promo])), int(np.sum(rev))
    q14_sums = [(Decimal(s_promo).scaleb(-4), Decimal(s_all).scaleb(-4))]
    q14 = [(float(Decimal(100 * s_promo) / Decimal(s_all)),)]
    return {"q01": q01, "q06": q06, "minmax": minmax, "q14": q14,
            "q14_sums": q14_sums}


def decimal_path(mem, counters) -> dict:
    """Phase 4c: TPC-H q01, q03, q06, q10 and q19 and DECIMAL_MINMAX over
    lineitem with its money columns typed DECIMAL(12,2) (the spec's types;
    `mem`, a decimal_connector), cold and warm on the card, with the
    kernels' launch counts set to 0 just before and read just after; the
    warm rows held against the cold ones and against the engine on the
    CPU exactly (Decimal for Decimal), and for q01, q06 and the min/max
    against numpy int64. K10 and the 128-bit modes of K1 and K3 must have
    been launched."""
    from decimal import Decimal

    from presto_tpu_torch.exec.engine import LocalEngine

    t = time.perf_counter()
    expected = decimal_numpy_reference(mem.table("lineitem"),
                                       mem.table("part"))
    print(f"the DECIMAL(12,2) lineitem's numpy reference in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    queries = decimal_queries()
    gpu = LocalEngine(mem)
    required = [k.__name__ for k in counters[:3]]
    rows, walls, per_query, launches = _run_queries(
        gpu, queries, counters, "decimal path", required)
    cpu = LocalEngine(mem, device="cpu")
    names = [k.__name__ for k in counters]
    for name, (sql, ordered) in queries.items():
        cold, warm = rows[name]
        if cold != warm:
            fail(f"{name} decimal: card cold rows differ from warm rows")
        t = time.perf_counter()
        want = cpu.execute_sql(sql)
        cpu_s = time.perf_counter() - t
        if name in DECIMAL_FLOAT:
            # a DOUBLE quotient of exact sums: within K10's to_double
            rows_match(warm, want, f"{name} decimal card vs CPU", True,
                       RTOL_F64)
            rows_match(warm, expected[name], f"{name} decimal card vs "
                       f"numpy", True, RTOL_F64)
        else:
            if warm != want:
                fail(f"{name} decimal: card rows differ from the CPU's")
            if name in expected and warm != expected[name]:
                fail(f"{name} decimal: card rows differ from numpy's: "
                     f"{warm[:2]} != {expected[name][:2]}")
            if not any(isinstance(v, Decimal) for v in warm[0]):
                fail(f"{name} decimal: no Decimal in the rows")
        print(f"{name} decimal: {len(warm)} rows equal the CPU's"
              f"{' and numpy' if name in expected else ''}; card wall cold "
              f"{walls[name][0] * 1e3:.1f} ms, warm "
              f"{walls[name][1] * 1e3:.1f} ms; CPU {cpu_s:.2f} s; launches "
              f"per run {names} cold {per_query[name][0]} warm "
              f"{per_query[name][1]}", flush=True)
    return launches


def nested_connector(conn, table):
    """A MemoryConnector serving orders_nested (`table`), every other
    table from `conn` (a TpchConnector)."""
    from presto_tpu_torch.connectors import MemoryConnector
    mem = MemoryConnector(fallback=conn)
    mem.register(table)
    return mem


def nested_path(conn, table, counters) -> dict:
    """Phase 4d: the UNNEST queries over orders_nested at SF1, cold and
    warm on the card, with the kernels' launch counts set to 0 just before
    and read just after; the warm rows held exactly against the cold ones,
    the engine on the CPU, and the flat query on the card (numpy for the
    count query). K11 must have been launched."""
    from presto_tpu_torch.exec.engine import LocalEngine

    mem = nested_connector(conn, table)
    queries = nested_queries()
    gpu = LocalEngine(mem)
    if gpu.device.type != "cuda":
        fail(f"the engine chose {gpu.device}, not the card")
    rows, walls, per_query, launches = _run_queries(
        gpu, {name: (sql, True) for name, (sql, _f) in queries.items()},
        counters, "nested path", ["unnest_expand"])
    cpu = LocalEngine(mem, device="cpu")
    names = [k.__name__ for k in counters]
    for name, (sql, flat) in queries.items():
        cold, warm = rows[name]
        if cold != warm:
            fail(f"{name} nested: card cold rows differ from warm rows")
        t = time.perf_counter()
        want = cpu.execute_sql(sql)
        cpu_s = time.perf_counter() - t
        if warm != want:
            fail(f"{name} nested: card rows differ from the CPU's")
        twin = gpu.execute_sql(flat) if flat else nested_counts(table)
        if warm != twin or not warm:
            fail(f"{name} nested: card rows differ from the "
                 f"{'flat query' if flat else 'numpy counts'}: "
                 f"{warm[:2]} != {twin[:2]}")
        print(f"{name} nested: {len(warm)} rows equal the CPU's and the "
              f"{'flat query' if flat else 'numpy counts'}; card wall cold "
              f"{walls[name][0] * 1e3:.1f} ms, warm "
              f"{walls[name][1] * 1e3:.1f} ms; CPU {cpu_s:.2f} s; launches "
              f"per run {names} cold {per_query[name][0]} warm "
              f"{per_query[name][1]}", flush=True)
    return launches


def _np_f64_hash_lanes(v: np.ndarray) -> np.ndarray:
    """approx_distinct's hash input of float64 values, in numpy uint64:
    the exponent lane of floor(log2|v|) and the top 32 mantissa bits, by
    an exact power of two (tags for NaN, +-inf, +-0; subnormals as 0)."""
    v = np.where(np.abs(v) < 2.2250738585072014e-308, 0.0, v)
    is_nan, is_inf = np.isnan(v), np.isinf(v)
    ae = np.maximum(np.abs(np.where(is_nan | is_inf, 1.0, v)), 1e-300)
    e = np.floor(np.log2(ae))
    norm = ae * np.ldexp(1.0, (-e).astype(np.int64))
    mant = (np.clip(norm - 1.0, 0.0, 1.0) * 2.0 ** 32).astype(np.uint64)
    h = (e.astype(np.int64) + 2048).astype(np.uint64) \
        * np.uint64(0x9E3779B97F4A7C15) ^ mant
    h = np.where(v < 0, h ^ np.uint64(0xA5A5A5A5DEADBEEF), h)
    h = np.where(v == 0.0, np.uint64(0x5E5E0000), h)
    h = np.where(is_nan, np.uint64(0x7FF8000000000001), h)
    h = np.where(is_inf & (v > 0), np.uint64(0x7FF0000000000000), h)
    return np.where(is_inf & (v < 0), np.uint64(0xFFF0000000000000), h)


def numpy_hll(v: np.ndarray, gid: np.ndarray, groups: int) -> np.ndarray:
    """approx_distinct per group written anew in numpy, as an oracle for
    the engine's exact output: splitmix64 over the value's bits (+
    GOLDEN), register = the low 11 bits, rank from the float32 frexp of
    the other 53, each register's largest rank, the harmonic-mean
    estimate with the linear-counting correction, rounded; 0 for a group
    without rows."""
    with np.errstate(over="ignore"):
        bits = (_np_f64_hash_lanes(v) if v.dtype.kind == "f"
                else v.astype(np.int64).view(np.uint64))
        x = bits + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = x ^ (x >> np.uint64(31))
    w = h >> np.uint64(11)
    _m, e = np.frexp(w.astype(np.float32))
    rank = np.where(w == 0, 54, 54 - e.astype(np.int64))
    regs = np.zeros(groups * 2048, np.int64)
    np.maximum.at(regs, gid.astype(np.int64) * 2048
                  + (h & np.uint64(2047)).astype(np.int64), rank + 1)
    regs = regs.reshape(groups, 2048)
    present = np.where(regs > 0, np.ldexp(1.0, -(regs - 1)), 0.0).sum(1)
    zeros = 2048 - (regs > 0).sum(1)
    m = 2048.0
    raw = 0.7213 / (1.0 + 1.079 / m) * m * m / np.maximum(present + zeros,
                                                          1e-12)
    small = m * np.log(m / np.maximum(zeros, 1.0))
    est = np.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
    return np.where(zeros == 2048, 0, np.round(est)).astype(np.int64)


def _approx_rows(cols, keys, mask, outs) -> dict:
    """An approx query's rows over numpy arrays `cols`, keyed by their
    group key (`keys`: (column, its words or None)) over the rows where
    `mask` (None: all): per output ("distinct", c) the exact distinct count
    of c and numpy_hll's estimate, ("pct", p, c) the element
    floor(p * (n - 1)) of the group's sorted values of c, ("count",) its
    rows."""
    m = np.ones(len(next(iter(cols.values()))), bool) if mask is None \
        else mask
    kc = [cols[c][m].astype(np.int64) for c, _w in keys]
    code = np.zeros(int(m.sum()), np.int64)
    for k in kc:
        code = code * (int(k.max()) + 1) + k
    uk, inv = np.unique(code, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uk))
    starts = np.cumsum(counts) - counts
    per = []
    for o in outs:
        if o[0] == "distinct":
            _u, vi = np.unique(cols[o[1]][m], return_inverse=True)
            w = int(vi.max()) + 1
            pairs = np.unique(inv.astype(np.int64) * w + vi)
            per.append(np.stack([
                np.bincount(pairs // w, minlength=len(uk)),
                numpy_hll(cols[o[1]][m], inv, len(uk))], axis=1))
        elif o[0] == "pct":
            v = cols[o[2]][m]
            idx = starts + np.floor(o[1] * (counts - 1)).astype(np.int64)
            per.append(v[np.lexsort((v, inv))][idx])
        else:
            per.append(counts)
    first = np.zeros(len(uk), np.int64)
    first[inv[::-1]] = np.arange(len(inv))[::-1]
    rows = {}
    for g in range(len(uk)):
        key = tuple(words[k[first[g]]] if words else int(k[first[g]])
                    for (_c, words), k in zip(keys, kc))
        rows[key] = [x[g].tolist() for x in per]
    return rows


def approx_numpy_reference(conn) -> dict:
    """a1-a5 over the generated arrays: name -> (number of key columns,
    outputs, rows by key) as _approx_rows gives them."""
    li, od = conn.table("lineitem"), conn.table("orders")
    L = {c: v[:li.num_rows] for c, v in li.arrays.items()}
    O = {c: v[:od.num_rows] for c, v in od.arrays.items()}
    lw = {c: li.dicts[c].words for c in li.dicts}
    ow = {c: od.dicts[c].words for c in od.dicts}
    f = O["o_orderstatus"] == list(ow["o_orderstatus"]).index("F")
    specs = {
        "a1": (L, [], None, [("distinct", "l_partkey"),
                             ("distinct", "l_extendedprice"),
                             ("pct", 0.5, "l_quantity")]),
        "a2": (L, [("l_returnflag", lw["l_returnflag"]),
                   ("l_linestatus", lw["l_linestatus"])], None,
               [("distinct", "l_orderkey"), ("pct", 0.9, "l_extendedprice"),
                ("count",)]),
        "a3": (L, [("l_suppkey", None)], None,
               [("distinct", "l_partkey"), ("pct", 0.25, "l_discount")]),
        "a4": (L, [("l_linenumber", None)], None,
               [("distinct", "l_partkey"), ("pct", 0.5, "l_shipdate")]),
        "a5": (O, [("o_orderpriority", ow["o_orderpriority"])], f,
               [("distinct", "o_clerk"), ("distinct", "o_custkey")]),
    }
    return {name: (len(keys), outs, _approx_rows(cols, keys, mask, outs))
            for name, (cols, keys, mask, outs) in specs.items()}


def approx_check(name, rows, expected) -> np.ndarray:
    """Holds a query's card rows against numpy: keys, counts, percentiles
    and the distinct counts' sketch (numpy_hll) exact, and the root mean
    square of the distinct counts' relative errors to the exact counts
    within HLL_BOUND. Returns those relative errors."""
    n_keys, outs, want = expected
    got = {tuple(r[:n_keys]): r[n_keys:] for r in rows}
    if set(got) != set(want):
        fail(f"{name}: groups {sorted(got)[:3]} != numpy's "
             f"{sorted(want)[:3]}")
    errs = []
    for key, w in want.items():
        for o, x, y in zip(outs, got[key], w):
            if o[0] != "distinct":
                if x != y:
                    fail(f"{name} {key}: {o} {x} != numpy's {y}")
                continue
            exact_count, sketch = y
            if x != sketch:
                fail(f"{name} {key}: approx_distinct({o[1]}) {x} != "
                     f"numpy's sketch {sketch}")
            errs.append(abs(x - exact_count) / max(exact_count, 1))
    errs = np.array(errs)
    if np.sqrt(np.mean(errs ** 2)) > HLL_BOUND:
        fail(f"{name}: approx_distinct's root mean square relative error "
             f"{np.sqrt(np.mean(errs ** 2)):.4f} > {HLL_BOUND:.4f}")
    return errs


def approx_path(conn, counters) -> dict:
    """Phase 4e: a1-a5 (APPROX_QUERIES) over TPC-H SF1, cold and warm on
    the card, with the kernels' launch counts set to 0 just before and
    read just after; the warm rows held exactly against the cold ones and
    against the engine on the CPU, and against numpy: percentiles exactly,
    distinct counts exactly against numpy_hll and, as each query's root
    mean square relative error, within HLL_BOUND of the exact counts. K12
    and K13 must have been launched."""
    from presto_tpu_torch.exec.engine import LocalEngine

    t = time.perf_counter()
    expected = approx_numpy_reference(conn)
    print(f"a1-a5's numpy reference in {time.perf_counter() - t:.1f} s",
          flush=True)
    gpu = LocalEngine(conn)
    rows, walls, per_query, launches = _run_queries(
        gpu, {name: (sql, False) for name, sql in APPROX_QUERIES.items()},
        counters, "approx path", ["hll_registers", "segment_select"])
    cpu = LocalEngine(conn, device="cpu")
    names = [k.__name__ for k in counters]
    for name, sql in APPROX_QUERIES.items():
        cold, warm = rows[name]
        if sorted(cold) != sorted(warm):
            fail(f"{name} approx: card cold rows differ from warm rows")
        t = time.perf_counter()
        want = cpu.execute_sql(sql)
        cpu_s = time.perf_counter() - t
        if sorted(warm) != sorted(want):
            fail(f"{name} approx: card rows differ from the CPU's: "
                 f"{sorted(warm)[:2]} != {sorted(want)[:2]}")
        errs = approx_check(name, warm, expected[name])
        shown = (f"each {[round(float(e), 5) for e in errs]}"
                 if len(errs) <= 24 else
                 f"99th percentile {np.quantile(errs, 0.99):.5f}, "
                 f"{int((errs > HLL_BOUND).sum())} of {len(errs)} beyond "
                 f"{HLL_BOUND:.4f}")
        print(f"{name} approx: {len(warm)} rows equal the CPU's; "
              f"percentiles and sketches equal numpy's; distinct counts' "
              f"relative errors to the exact counts: root mean square "
              f"{np.sqrt(np.mean(errs ** 2)):.5f} (bound {HLL_BOUND:.4f}), "
              f"max {errs.max():.5f}, {shown}; card "
              f"wall cold {walls[name][0] * 1e3:.1f} ms, warm "
              f"{walls[name][1] * 1e3:.1f} ms; CPU {cpu_s:.2f} s; launches "
              f"per run {names} cold {per_query[name][0]} warm "
              f"{per_query[name][1]}", flush=True)
    return launches


#: phase 4f's orders columns and its join of the written table
O95_COLUMNS = ("o_orderkey, o_custkey, o_totalprice, o_orderdate, "
               "o_orderpriority")
JOIN_O95 = ("select count(*), sum(l_extendedprice) from o95 "
            "join lineitem on l_orderkey = o_orderkey")


def statements() -> dict:
    """Phase 4f's sequence: name -> (engine, SQL); the engine "mat" has
    cte_materialization_enabled, "plain" has not, both over one
    MemoryConnector(fallback=TpchConnector(SF))."""
    q15 = tpch_queries()[15]
    return {
        "ctas_rf": ("plain",
                    "create table rf as select l_returnflag, l_linestatus, "
                    "count(*) c, sum(l_quantity) q, sum(l_extendedprice) p "
                    "from lineitem group by 1, 2"),
        "select_rf": ("plain", "select * from rf "
                      "order by l_returnflag, l_linestatus"),
        "ctas_o95": ("plain",
                     f"create table o95 as select {O95_COLUMNS} from orders "
                     "where o_orderdate between date '1995-03-01' "
                     "and date '1995-03-31'"),
        "insert_o95": ("plain",
                       f"insert into o95 select {O95_COLUMNS} from orders "
                       "where o_orderdate between date '1995-04-01' "
                       "and date '1995-04-30'"),
        "delete_o95": ("plain",
                       "delete from o95 where o_totalprice < 100000"),
        "group_o95": ("plain",
                      "select o_orderpriority, count(*), sum(o_totalprice) "
                      "from o95 group by o_orderpriority "
                      "order by o_orderpriority"),
        "join_o95": ("plain", JOIN_O95),
        "explain_join": ("plain", "explain " + JOIN_O95),
        "q15_materialized": ("mat", q15),
        "q15_inlined": ("plain", q15),
        "drop_rf": ("plain", "drop table rf"),
        "drop_o95": ("plain", "drop table o95"),
    }


def statement_numpy_reference(conn) -> dict:
    """Phase 4f's count rows and query rows (but q15's and the EXPLAIN's)
    with numpy alone over the generated arrays."""
    li, od = conn.table("lineitem"), conn.table("orders")
    a = {c: v[:li.num_rows] for c, v in li.arrays.items()}
    o = {c: v[:od.num_rows] for c, v in od.arrays.items()}
    rf_w = li.dicts["l_returnflag"].words
    ls_w = li.dicts["l_linestatus"].words
    code = a["l_returnflag"].astype(np.int64) * len(ls_w) + a["l_linestatus"]
    uniq, inv = np.unique(code, return_inverse=True)
    cnt = np.bincount(inv)
    qty = np.bincount(inv, weights=a["l_quantity"])
    price = np.bincount(inv, weights=a["l_extendedprice"])
    out = {"ctas_rf": [(len(uniq),)],
           "select_rf": [(rf_w[u // len(ls_w)], ls_w[u % len(ls_w)],
                          int(cnt[i]), float(qty[i]), float(price[i]))
                         for i, u in enumerate(uniq)]}
    date = o["o_orderdate"]
    march = (date >= _days(1995, 3, 1)) & (date <= _days(1995, 3, 31))
    april = (date >= _days(1995, 4, 1)) & (date <= _days(1995, 4, 30))
    kept = (march | april) & (o["o_totalprice"] >= 100000)
    out["ctas_o95"] = [(int(march.sum()),)]
    out["insert_o95"] = [(int(april.sum()),)]
    out["delete_o95"] = [(int(((march | april) & ~kept).sum()),)]
    prio = od.dicts["o_orderpriority"].words
    codes, inv = np.unique(o["o_orderpriority"][kept], return_inverse=True)
    out["group_o95"] = [
        (prio[c], int(n), float(t)) for c, n, t in zip(
            codes, np.bincount(inv),
            np.bincount(inv, weights=o["o_totalprice"][kept]))]
    hit = np.isin(a["l_orderkey"], o["o_orderkey"][kept])
    out["join_o95"] = [(int(hit.sum()),
                        float(a["l_extendedprice"][hit].sum()))]
    out["drop_rf"] = out["drop_o95"] = [(0,)]
    return out


def tables_match(a: dict, b: dict, what: str) -> None:
    """Two connectors' written tables (name -> HostTable) hold the same
    columns: nulls, integers and dictionary words exactly, floats within
    RTOL_SUM."""
    if sorted(a) != sorted(b):
        fail(f"{what}: tables {sorted(a)} != {sorted(b)}")
    for name, ta in a.items():
        tb = b[name]
        n = ta.num_rows
        if tb.num_rows != n or ta.column_names() != tb.column_names():
            fail(f"{what}: table {name} differs in shape")
        for c in ta.column_names():
            na = np.asarray((ta.nulls or {}).get(c, np.zeros(n, bool))[:n])
            nb = np.asarray((tb.nulls or {}).get(c, np.zeros(n, bool))[:n])
            va, vb = ta.arrays[c][:n][~na], tb.arrays[c][:n][~nb]
            if not np.array_equal(na, nb):
                fail(f"{what}: {name}.{c} nulls differ")
            if ta.types[c].is_string and \
                    ta.dicts[c].words != tb.dicts[c].words:
                fail(f"{what}: {name}.{c} dictionary words differ")
            if ta.types[c].is_floating:
                if np.any(np.abs(va - vb) > RTOL_SUM * np.maximum(
                        np.abs(vb), 1.0)):
                    fail(f"{what}: {name}.{c} values differ")
            elif not np.array_equal(va, vb):
                fail(f"{what}: {name}.{c} values differ")


def statement_path(conn, counters) -> dict:
    """Phase 4f: statements() on the card, over MemoryConnector(fallback=
    conn), with the kernels' launch counts set to 0 just before and read
    just after; then the same sequence on the engine on the CPU. Every
    count row and query row held against the CPU's and numpy's
    (statement_numpy_reference), the written tables against the CPU's
    before the drops, the EXPLAIN text against the CPU's, and q15
    materialized against q15 inlined. K1, K2, K4 and K5 must have been
    launched."""
    import torch
    from presto_tpu_torch.config import Session
    from presto_tpu_torch.connectors import MemoryConnector
    from presto_tpu_torch.exec.engine import LocalEngine

    expected = statement_numpy_reference(conn)
    seq = statements()
    results, walls, tables = {}, {}, {}
    for device in ("cuda", "cpu"):
        dev = None if device == "cuda" else "cpu"
        mem = MemoryConnector(fallback=conn)
        engines = {"plain": LocalEngine(mem, device=dev),
                   "mat": LocalEngine(mem, device=dev, session=Session(
                       {"cte_materialization_enabled": "true"}))}
        if engines["plain"].device.type != device:
            fail(f"the engine chose {engines['plain'].device}, not {device}")
        if device == "cuda":
            for k in counters:
                k.launches = 0
        rows = results[device] = {}
        for name, (which, sql) in seq.items():
            if name.startswith("drop") and device not in tables:
                tables[device] = dict(mem.tables)
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows[name] = engines[which].execute_sql(sql)
            walls.setdefault(name, []).append(time.perf_counter() - t)
        if device == "cuda":
            launches = {k.__name__: k.launches for k in counters}
        if mem.tables:
            fail(f"statement path ({device}): tables left {list(mem.tables)}")
    for name in ("direct_agg", "compact_indices", "hash_columns",
                 "join_probe"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the statement path")
    tables_match(tables["cuda"], tables["cpu"], "written tables, card vs CPU")
    gpu, cpu = results["cuda"], results["cpu"]
    for name, (_which, sql) in seq.items():
        ordered = "order by" in sql.lower() or name.startswith("explain")
        rows_match(gpu[name], cpu[name], f"{name} card vs CPU", ordered)
        if name in expected:
            rows_match(gpu[name], expected[name], f"{name} card vs numpy",
                       ordered)
        print(f"{name}: {len(gpu[name])} rows, first {gpu[name][0]}; card "
              f"wall {walls[name][0] * 1e3:.1f} ms, CPU "
              f"{walls[name][1]:.2f} s", flush=True)
    if gpu["explain_join"] != cpu["explain_join"]:
        fail("EXPLAIN text differs between the card and the CPU")
    rows_match(gpu["q15_materialized"], gpu["q15_inlined"],
               "q15 materialized vs inlined, card", True)
    return launches


def _drop_device_pages(conn, tables) -> None:
    """Forget the device columns that the generated tables keep
    (HostTable.page's cache), so that the next run uploads its scans and
    a peak of device memory counts them."""
    for t in tables:
        conn.table(t).__dict__.pop("_dev_page_cache", None)


def _peak_run(engine, sql, conn, tables):
    """Rows, wall seconds, peak device bytes over the run and the bytes
    allocated before it, with the tables' device columns dropped first."""
    import torch
    _drop_device_pages(conn, tables)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rows = engine.execute_sql(sql)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t, torch.cuda.max_memory_allocated(), \
        base


def bounded_path(conn, counters) -> dict:
    """Phase 4g, memory-bounded execution over `conn` (TpchConnector(1.0)
    in the smoke), with the kernels' launch counts set to 0 just before
    and read just after:
    - q01 and the q18 block with lifespan_batches=BOUNDED_BATCHES, held
      against the same query run whole on the card (floats within 1e-9
      relative, the rest exact) and against the engine on the CPU
      batched;
    - spec-typed q01 and q06 over decimal_connector(conn), batched and
      spilled to LZ4 frames in a temporary directory, held Decimal for
      Decimal against the run whole on the card and numpy int64
      arithmetic; K3's merge mode launched for q01, K1's for q06;
    - the pool route: q01 under a MemoryPool of a quarter of its
      footprint runs in at least 2 lifespans, equal to the run whole, at
      a lower peak of device memory (the tables' device columns dropped
      before each run);
    - GRACE_SQL under a pool that refuses it: the Grace spill join, at
      least 2 partitions with rows in them, rows equal to the run whole
      (sorted); K4 and K5 launched there."""
    import tempfile

    import torch
    from presto_tpu_torch.config import Session
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.exec.memory import MemoryPool

    names = [k.__name__ for k in counters]

    def counts():
        return dict(zip(names, [k.launches for k in counters]))

    def delta(before):
        now = counts()
        return {k: now[k] - before[k] for k in names if now[k] - before[k]}

    for k in counters:
        k.launches = 0
    main = main_queries()
    batched = Session({"lifespan_batches": str(BOUNDED_BATCHES)})
    gpu_b, whole = LocalEngine(conn, session=batched), LocalEngine(conn)
    cpu_b = LocalEngine(conn, session=batched, device="cpu")
    for name in ("q01", "q18_block"):
        sql, ordered = main[name]
        before = counts()
        t = time.perf_counter()
        got = gpu_b.execute_sql(sql)
        wall = time.perf_counter() - t
        launched = delta(before)
        rows_match(got, whole.execute_sql(sql),
                   f"{name} batched vs whole on the card", ordered)
        t = time.perf_counter()
        rows_match(got, cpu_b.execute_sql(sql),
                   f"{name} batched card vs CPU", ordered)
        print(f"{name} in {BOUNDED_BATCHES} lifespans: {len(got)} rows "
              f"equal the run whole and the CPU's batched; card wall "
              f"{wall * 1e3:.1f} ms, CPU {time.perf_counter() - t:.2f} s; "
              f"stats {gpu_b.last_lifespan_stats}; launches {launched}",
              flush=True)

    mem = decimal_connector(conn)
    expected = decimal_numpy_reference(mem.table("lineitem"),
                                       mem.table("part"))
    tpch = tpch_queries()
    dec_whole = LocalEngine(mem)
    with tempfile.TemporaryDirectory(prefix="bounded_spill_") as spill:
        spilled = LocalEngine(mem, session=Session({
            "lifespan_batches": str(BOUNDED_BATCHES),
            "spill_enabled": "true", "spill_path": spill}))
        for name, mode in (("q01", "segment_reduce_merge128"),
                           ("q06", "direct_agg_merge128")):
            sql = tpch[int(name[1:])]
            before = counts()
            t = time.perf_counter()
            got = spilled.execute_sql(sql)
            wall = time.perf_counter() - t
            launched = delta(before)
            st = spilled.last_lifespan_stats
            if got != dec_whole.execute_sql(sql):
                fail(f"spec-typed {name} batched and spilled: rows differ "
                     f"from the run whole on the card")
            if got != expected[name]:
                fail(f"spec-typed {name} batched and spilled: rows differ "
                     f"from numpy's: {got[:2]} != {expected[name][:2]}")
            if not launched.get(mode):
                fail(f"spec-typed {name}: {mode} was not launched")
            if st.get("spill_files") != BOUNDED_BATCHES or os.listdir(spill):
                fail(f"spec-typed {name}: spill files {st}, left "
                     f"{os.listdir(spill)}")
            print(f"spec-typed {name} in {BOUNDED_BATCHES} lifespans, "
                  f"spilled ({st['spilled_bytes']} bytes of LZ4 frames in "
                  f"{st['spill_files']} files): {len(got)} rows equal the "
                  f"run whole and numpy, Decimal for Decimal; card wall "
                  f"{wall * 1e3:.1f} ms; launches {launched}", flush=True)
    # the DECIMAL lineitem's device columns go with its engines
    del mem, dec_whole, spilled

    q01 = main["q01"][0]
    probe = LocalEngine(conn)
    whole_rows = probe.execute_sql(q01)
    estimate = probe.executor.last_memory_estimate
    budget = estimate // 4
    pool = MemoryPool(budget)
    pooled = LocalEngine(conn, memory_pool=pool)
    w_rows, w_wall, w_peak, w_base = _peak_run(LocalEngine(conn), q01, conn,
                                               ("lineitem",))
    before = counts()
    p_rows, p_wall, p_peak, p_base = _peak_run(pooled, q01, conn,
                                               ("lineitem",))
    launched = delta(before)
    rows_match(p_rows, whole_rows, "q01 pooled vs whole", True)
    rows_match(w_rows, whole_rows, "q01 whole vs whole", True)
    batches = pooled.last_memory_fallback_batches
    if batches < 2 or pool.reserved:
        fail(f"q01 under a pool of {budget} bytes: {batches} lifespans, "
             f"{pool.reserved} bytes left reserved")
    print(f"pool route: q01's footprint {estimate} bytes, pool {budget}: "
          f"{batches} lifespans, rows equal the run whole; peak device "
          f"memory {p_peak} bytes pooled against {w_peak} whole "
          f"({p_base} and {w_base} allocated before: {p_peak - p_base} "
          f"and {w_peak - w_base} above them); walls "
          f"{p_wall * 1e3:.1f} / {w_wall * 1e3:.1f} ms; launches "
          f"{launched}", flush=True)
    if not p_peak < w_peak:
        fail(f"q01 pooled peak {p_peak} is not below the run whole's "
             f"{w_peak}")

    probe = LocalEngine(conn)
    want = sorted(probe.execute_sql(GRACE_SQL))
    budget = probe.executor.last_memory_estimate // 4
    grace = LocalEngine(conn, memory_pool=MemoryPool(budget))
    before = counts()
    t = time.perf_counter()
    got = sorted(grace.execute_sql(GRACE_SQL))
    wall = time.perf_counter() - t
    launched = delta(before)
    st = grace.last_spill_join_stats
    rows_match(got, want, "Grace join vs whole", True)
    if st is None or st["partitions"] < 2 or \
            st["spill_files"] <= st["build_batches"] + st["probe_batches"]:
        fail(f"Grace join: stats {st} (at least 2 partitions, one chunk "
             f"split across them)")
    for k in ("hash_columns", "join_probe"):
        if not launched.get(k):
            fail(f"Grace join: {k} was not launched")
    print(f"Grace join under a pool of {budget} bytes: {len(got)} rows equal "
          f"the run whole (sorted); stats {st}; card wall "
          f"{wall * 1e3:.1f} ms; launches {launched}", flush=True)
    launches = counts()
    for k in names:
        if not launches[k] and k in ("direct_agg", "compact_indices",
                                     "segment_reduce", "hash_columns",
                                     "join_probe", "direct_agg_merge128",
                                     "segment_reduce_merge128"):
            fail(f"kernel {k} was not launched on the bounded path")
    torch.cuda.synchronize()
    return launches


def approx_phase(counters) -> None:
    """The six queries of tests/test_approx_aggs.py (read from
    tests/test_torch_approx.py, APPROX_TEST_QUERIES) at SQLITE_SF on the
    card, cold and warm, against the port's CPU engine exactly: sqlite
    has no sketch."""
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine

    queries = _literal_lists("test_torch_approx", (
        "APPROX_TEST_QUERIES",))["APPROX_TEST_QUERIES"]
    conn = TpchConnector(SQLITE_SF)
    rows, walls, _per_query, launches = _run_queries(
        LocalEngine(conn), {n: (q, False) for n, q in queries.items()},
        counters, "approx phase", ["hll_registers", "segment_select"])
    cpu = LocalEngine(conn, device="cpu")
    for name, sql in queries.items():
        want = sorted(cpu.execute_sql(sql))
        for run, got in zip(("cold", "warm"), rows[name]):
            if sorted(got) != want:
                fail(f"approx {name} card ({run}): {got} != CPU's {want}")
        print(f"approx {name} SF{SQLITE_SF}: {len(want)} rows equal the "
              f"CPU's; card wall cold {walls[name][0] * 1e3:.1f} ms, warm "
              f"{walls[name][1] * 1e3:.1f} ms", flush=True)
    print(f"approx phase launches: {launches}", flush=True)


def docs_phase(counters) -> None:
    """The seven engine queries of tests/test_unnest_nested.py over its
    docs table (tests/test_torch_unnest.py DOCS_*), on the card cold and
    warm, against sqlite over that file's flattened tables; the two
    without a flat form (a constant UNNEST, the nested columns selected
    verbatim) against their literal rows."""
    from presto_tpu_torch.connectors import MemoryConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.types import parse_type

    lits = _literal_lists("test_torch_unnest", (
        "DOCS_QUERIES", "DOCS_ROWS", "DOCS_SCHEMA"))
    db = unnest_oracle_db()
    mem = MemoryConnector()
    mem.create("docs", [(c, parse_type(t)) for c, t in lits["DOCS_SCHEMA"]])
    mem.append_rows("docs", lits["DOCS_ROWS"])
    engine = LocalEngine(mem)
    queries = lits["DOCS_QUERIES"]
    rows, walls, _per_query, launches = _run_queries(
        engine, {name: (sql, True) for name, (sql, _f) in queries.items()},
        counters, "docs phase", ["unnest_expand"])
    for name, (sql, flat) in queries.items():
        if flat is not None:
            expected = [tuple(r) for r in db.execute(flat).fetchall()]
        elif name == "standalone":
            expected = [(1,), (2,), (3,)]
        else:
            expected = sorted(lits["DOCS_ROWS"], key=lambda r: r[0])
        for run, got in zip(("cold", "warm"), rows[name]):
            if got != expected:
                fail(f"docs {name} card ({run}): {got} != {expected}")
        print(f"docs {name}: {len(rows[name][1])} rows equal "
              f"{'sqlite' if flat else 'the literal rows'}; card wall cold "
              f"{walls[name][0] * 1e3:.1f} ms, warm "
              f"{walls[name][1] * 1e3:.1f} ms", flush=True)
    print(f"docs launches: {launches}", flush=True)


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
    from presto_tpu_torch.data.int128 import int128_op
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops.aggregate import direct_agg, hll_registers, \
        segment_select
    from presto_tpu_torch.ops.join import join_expand, join_probe
    from presto_tpu_torch.ops.keys import hash_columns, key_change_flags
    from presto_tpu_torch.connectors.tpch import nested_orders
    from presto_tpu_torch.ops.scan import SCAN_KINDS, segment_reduce, \
        segmented_scan
    from presto_tpu_torch.ops.unnest import unnest_expand
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
    t0 = time.perf_counter()
    nested = nested_orders(SF)
    print(f"orders_nested at SF{SF}: built in "
          f"{time.perf_counter() - t0:.1f} s ({nested.num_rows} rows, "
          f"{nested_counts(nested)[0][1]} array elements)", flush=True)
    t0 = time.perf_counter()
    dec_conn = decimal_connector(conn)
    print(f"DECIMAL(12,2) lineitem at SF{SF}: built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(SEED)
    ds_sql, _ = tpcds_queries()
    q51_calls = capture_windows(LocalEngine(ds_conn), ds_sql[51])
    report = [kernel_direct_agg(rng, dev, REPEAT),
              kernel_compact(rng, dev, REPEAT),
              kernel_segment_reduce(rng, dev, ds_conn, REPEAT),
              kernel_hash(conn, dev, REPEAT),
              kernel_join_probe(conn, dev, REPEAT),
              kernel_join_expand(conn, dev, REPEAT),
              kernel_seg_scan(q51_calls, conn, dev, REPEAT),
              kernel_key_change(conn, dev, REPEAT),
              kernel_window_frame(conn, dev, REPEAT),
              kernel_int128(rng, dev, REPEAT),
              kernel_direct_agg_sum128(rng, dev, REPEAT),
              kernel_segment_sum128(rng, dev, REPEAT),
              kernel_unnest_expand(nested, dev, REPEAT),
              kernel_hll_registers(conn, dev, REPEAT),
              kernel_segment_select(conn, dev, REPEAT),
              *kernel_merge128(rng, dev, REPEAT)]
    del q51_calls
    torch_op_rows(conn, ds_conn, dec_conn, dev, REPEAT)
    torch.cuda.synchronize()
    print(f"phase 3: kernels hold against their plain versions "
          f"({time.perf_counter() - t_phase:.1f} s with the tables)",
          flush=True)

    counters = [direct_agg, compact_indices, segment_reduce, hash_columns,
                join_probe, join_expand, segmented_scan, key_change_flags,
                window_frame]
    # join_probe's launches by mode and segmented_scan's by kind, counted
    # in the same windows as the kernels' launches of phase 4 (and not in
    # phase 5)
    mode_counts = [ModeCount(join_probe, f"join_probe_{m}", i)
                   for i, m in enumerate(MODE_NAMES)]
    mode_counts += [ModeCount(segmented_scan, f"segmented_scan_{k}", i)
                    for i, k in enumerate(SCAN_KINDS)]
    calls = CallCounter()
    t0 = time.perf_counter()
    launches = main_path(conn, counters + mode_counts)
    print(f"phase 4a: TPC-H main path in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}; torch-op stage calls {calls.counts}",
          flush=True)
    calls.reset()
    t0 = time.perf_counter()
    breadth = breadth_path(ds_conn, conn, counters + mode_counts)
    print(f"phase 4b: breadth path in {time.perf_counter() - t0:.1f} s; "
          f"launches {breadth}; torch-op stage calls {calls.counts}",
          flush=True)
    del ds_conn
    decimal_counters = [int128_op, ModeCount(direct_agg, "direct_agg_sum128"),
                        ModeCount(segment_reduce, "segment_reduce_sum128")] \
        + counters + mode_counts
    calls.reset()
    t0 = time.perf_counter()
    decimal = decimal_path(dec_conn, decimal_counters)
    print(f"phase 4c: decimal path in {time.perf_counter() - t0:.1f} s; "
          f"launches {decimal}; torch-op stage calls {calls.counts}",
          flush=True)
    nested_counters = [unnest_expand] + counters
    calls.reset()
    t0 = time.perf_counter()
    unnest = nested_path(conn, nested, nested_counters + mode_counts)
    print(f"phase 4d: nested path in {time.perf_counter() - t0:.1f} s; "
          f"launches {unnest}; torch-op stage calls {calls.counts}",
          flush=True)
    del nested, dec_conn
    approx_counters = [hll_registers, segment_select] + counters
    calls.reset()
    t0 = time.perf_counter()
    approx = approx_path(conn, approx_counters + mode_counts)
    print(f"phase 4e: approx path in {time.perf_counter() - t0:.1f} s; "
          f"launches {approx}; torch-op stage calls {calls.counts}",
          flush=True)
    calls.reset()
    t0 = time.perf_counter()
    stmts = statement_path(conn, decimal_counters)
    print(f"phase 4f: statement path in {time.perf_counter() - t0:.1f} s; "
          f"launches {stmts}; torch-op stage calls {calls.counts}",
          flush=True)
    for name in ("segment_reduce", "int128_op"):
        if decimal[name] + stmts[name] == 0:
            fail(f"kernel {name} was not launched on phases 4c and 4f")
    bounded_counters = [
        ModeCount(direct_agg, "direct_agg_merge128",
                  attr="merge128_launches"),
        ModeCount(segment_reduce, "segment_reduce_merge128",
                  attr="merge128_launches")] + decimal_counters
    calls.reset()
    t0 = time.perf_counter()
    bounded = bounded_path(conn, bounded_counters)
    print(f"phase 4g: bounded path in {time.perf_counter() - t0:.1f} s; "
          f"launches {bounded}; torch-op stage calls {calls.counts}",
          flush=True)
    paths = (launches, breadth, decimal, unnest, approx, stmts, bounded)
    for r in report:
        r["launches"] = sum(path.get(r["name"], 0) for path in paths)
    print("join_probe launches by mode on the main paths: " + json.dumps(
        {m: sum(path[f"join_probe_{m}"] for path in paths)
         for m in MODE_NAMES}), flush=True)
    print("segmented_scan launches by kind on the main paths: " + json.dumps(
        {k: sum(path[f"segmented_scan_{k}"] for path in paths)
         for k in SCAN_KINDS}), flush=True)
    t0 = time.perf_counter()
    sqlite_phase(counters)
    docs_phase(nested_counters)
    approx_phase(approx_counters)
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
