"""Memory-bounded execution of the port against the JAX package, on the CPU.

At TPC-H SF 0.01, presto_tpu_torch (device="cpu") and presto_tpu run the
same plans:

- lifespan batching (exec/lifespan.py): tests/test_lifespan.py's Q1, Q6
  and Q3ISH at 3 and 8 lifespans, the port batched against the port run
  whole and against the JAX `execute_batched`; the 1 MiB
  MemoryLimitExceeded; `execute_bounded`'s batch count and both
  estimates; the `lifespan_batches` session route;
- the DECIMAL(38) final merges: the plain sum128_merge/avg128_merge of
  ops/aggregate.py, global (one-bin direct path) and grouped (sorted
  path), exactly equal to the JAX grouped_aggregate on seeded limb-lane
  pages with NULL states and an all-NULL group; tests/test_decimal38_paths
  .py's wide sums batched and spilled, exact against a Decimal oracle and
  the JAX runner;
- spill (exec/spill.py, protocol/serde.py): frames of one page byte for
  byte the JAX package's under the none, zlib, gzip and lz4 codecs, each
  decoding in the other package to the same rows; tests/test_spill.py's
  cases; spilled partials whose lifespans hold different string keys;
- the memory pool (exec/memory.py): tests/test_memory_pool.py's cases with
  the same classes and messages, the engine's over-budget fallback and the
  killed query;
- the Grace spill join (exec/spill_join.py): rows and stats against the
  JAX package's, and the same refusals.

The JAX package learns and persists capacities per plan; every JAX run
here reads and writes a capacity store of its own, so both engines start
from the planner's hints.
"""

import os
from decimal import Decimal

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.config import Session as RefSession
from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.data import column as RC
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu.exec import lifespan as RL
from presto_tpu.exec import memory as RM
from presto_tpu.exec import spill_join as RSJ
from presto_tpu.exec.executor import MemoryLimitExceeded as RefMLE
from presto_tpu.exec.split_executor import SplitExecutor as RefSplit
from presto_tpu.ops import aggregate as RA
from presto_tpu.protocol import serde as RS
from presto_tpu_torch import types as PT
from presto_tpu_torch.config import Session
from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
from presto_tpu_torch.data import column as PC
from presto_tpu_torch.exec import lifespan as PL
from presto_tpu_torch.exec import spill_join as PSJ
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.exec.executor import MemoryLimitExceeded
from presto_tpu_torch.exec.memory import (
    ClusterMemoryManager, ExceededMemoryLimitError, MemoryPool,
)
from presto_tpu_torch.exec.spill import (
    FileSpiller, external_sort, merge_sorted_rows,
)
from presto_tpu_torch.exec.split_executor import SplitExecutor
from presto_tpu_torch.ops import aggregate as PA
from presto_tpu_torch.ops.keys import SortKey
from presto_tpu_torch.protocol import serde as PS
from presto_tpu_torch.sql.analyzer import Planner
from presto_tpu_torch.sql.parser import parse_sql
from tests.oracle import assert_rows_match
from tests.test_decimal38_paths import _fixture, _oracle_sums
from torch_threads import _one_torch_thread  # noqa: F401

SF = 0.01

Q1 = ("select l_returnflag, l_linestatus, sum(l_quantity), "
      "sum(l_extendedprice), avg(l_discount), count(*) from lineitem "
      "where l_shipdate <= date '1998-09-02' "
      "group by l_returnflag, l_linestatus order by 1, 2")
Q6 = ("select sum(l_extendedprice * l_discount) from lineitem "
      "where l_discount between 0.05 and 0.07 and l_quantity < 24")
Q3ISH = ("select o_orderpriority, count(*), sum(l_extendedprice) "
         "from lineitem, orders where l_orderkey = o_orderkey "
         "and o_totalprice > 100000 group by o_orderpriority "
         "order by 1")
LIFESPAN_QUERIES = {"q1": Q1, "q6": Q6, "q3ish": Q3ISH}
#: tests/test_memory_pool.py's over-budget query
POOL_SQL = ("select l_returnflag, count(*), sum(l_extendedprice) "
            "from lineitem group by l_returnflag")
#: tests/test_memory_chaos.py's join-rooted query, and one over numeric
#: columns of two large tables
JOIN_SQL = ("select n_name, r_name from nation, region "
            "where n_regionkey = r_regionkey order by 1, 2")
GRACE_SQL = ("select l_orderkey, l_extendedprice, o_orderdate "
             "from lineitem, orders where l_orderkey = o_orderkey "
             "and o_totalprice > 300000")


@pytest.fixture(autouse=True)
def _caps_store(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_CAPS_CACHE",
                       str(tmp_path_factory.mktemp("caps") / "caps.json"))


@pytest.fixture(scope="module")
def conns():
    return TpchConnector(SF), RefTpch(SF)


@pytest.fixture(scope="module")
def engines(conns):
    return LocalEngine(conns[0], device="cpu"), RefEngine(conns[1])


# ---------------------------------------------------------------------------
# lifespan batching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batches", [3, 8])
@pytest.mark.parametrize("name", sorted(LIFESPAN_QUERIES))
def test_batched_matches_whole_and_jax(engines, conns, name, batches):
    eng, ref = engines
    sql = LIFESPAN_QUERIES[name]
    whole = eng.execute_sql(sql)
    got = PL.execute_batched(conns[0], eng.plan_sql(sql), batches,
                             device="cpu").to_pylist()
    want = RL.execute_batched(
        conns[1], ref.executor._resolve_subqueries(ref.plan_sql(sql)),
        batches).to_pylist()
    assert_rows_match(got, whole, float_tol=1e-6)
    assert_rows_match(got, want, float_tol=1e-6)


def test_memory_limit_enforced_in_both(engines, conns):
    eng, ref = engines
    ex = SplitExecutor(conns[0], device="cpu")
    ex.memory_limit_bytes = 1 << 20          # 1 MiB: far too small
    with pytest.raises(MemoryLimitExceeded, match="limit is 1 MiB"):
        ex.execute(eng.plan_sql(Q1))
    assert ex.last_memory_estimate > 1 << 20
    rex = RefSplit(conns[1])
    rex.memory_limit_bytes = 1 << 20
    with pytest.raises(RefMLE, match="limit is 1 MiB"):
        rex.execute(rex._resolve_subqueries(ref.plan_sql(Q1)))
    assert rex.last_memory_estimate > 1 << 20


@pytest.mark.parametrize("name", ["q1", "q6"])
def test_estimates_equal_jax(engines, conns, name):
    """A fresh executor's footprint of the plan run whole: the same sum of
    capacity x row bytes in both packages (neither plan splits into the
    JAX executor's fusion islands)."""
    eng, ref = engines
    sql = LIFESPAN_QUERIES[name]
    ex = SplitExecutor(conns[0], device="cpu")
    ex.execute(eng.plan_sql(sql))
    rex = RefSplit(conns[1])
    rex.execute(rex._resolve_subqueries(ref.plan_sql(sql)))
    assert ex.last_memory_estimate == rex.last_memory_estimate > 1 << 20


def test_q3ish_estimate_is_the_whole_plan(engines, conns):
    """Q3ISH's join makes the JAX executor lower fusion islands, each
    checked against the limit on its own, and `last_memory_estimate` is
    the last island's; the port sums the whole plan (ROADMAP Queue 3)."""
    eng, ref = engines
    ex = SplitExecutor(conns[0], device="cpu")
    ex.execute(eng.plan_sql(Q3ISH))
    rex = RefSplit(conns[1])
    rex.execute(rex._resolve_subqueries(ref.plan_sql(Q3ISH)))
    assert ex.last_memory_estimate > rex.last_memory_estimate > 0


def test_bounded_batch_count_equals_jax(engines, conns):
    eng, ref = engines
    page, batches = PL.execute_bounded(conns[0], eng.plan_sql(Q1),
                                       memory_limit_bytes=6 << 20,
                                       device="cpu")
    rpage, rbatches = RL.execute_bounded(
        conns[1], ref.executor._resolve_subqueries(ref.plan_sql(Q1)),
        memory_limit_bytes=6 << 20)
    assert batches == rbatches > 1
    assert_rows_match(page.to_pylist(), rpage.to_pylist(), float_tol=1e-6)
    assert_rows_match(page.to_pylist(), eng.execute_sql(Q1),
                      float_tol=1e-6)


def test_lifespan_batches_session_route(conns):
    sql = Q3ISH
    eng = LocalEngine(conns[0], session=Session({"lifespan_batches": "4"}),
                      device="cpu")
    ref = RefEngine(conns[1], session=RefSession({"lifespan_batches": "4"}))
    got = eng.execute_sql(sql)
    assert_rows_match(got, ref.execute_sql(sql), float_tol=1e-6)
    assert_rows_match(got, LocalEngine(conns[0], device="cpu")
                      .execute_sql(sql), float_tol=1e-6)
    assert eng.last_lifespan_stats == ref.last_lifespan_stats
    assert eng.last_lifespan_stats["batches"] == 4


def test_streaming_scan_runs_equal_jax(conns):
    """lifespan_batches with streaming_scan_rows: each lifespan's split
    flows through the partial plan in scan runs (connector.scan_runs)."""
    props = {"lifespan_batches": "3", "streaming_scan_rows": "7000"}
    eng = LocalEngine(conns[0], session=Session(props), device="cpu")
    ref = RefEngine(conns[1], session=RefSession(props))
    got = eng.execute_sql(Q1)
    assert_rows_match(got, ref.execute_sql(Q1), float_tol=1e-6)
    assert_rows_match(got, LocalEngine(conns[0], device="cpu")
                      .execute_sql(Q1), float_tol=1e-6)


def test_split_executor_reads_several_splits(conns):
    """Two of three splits of a table in one scan, as the JAX
    SplitExecutor reads them."""
    sql = "select n_nationkey, n_name, n_comment from nation"
    plan = Planner(conns[0]).plan_query(parse_sql(sql))
    ex = SplitExecutor(conns[0], device="cpu")
    ex.set_splits({"nation": [(0, 3), (2, 3)]})
    rex = RefSplit(conns[1])
    rex.set_splits({"nation": [(0, 3), (2, 3)]})
    from presto_tpu.sql.analyzer import Planner as RefPlanner
    from presto_tpu.sql.parser import parse_sql as ref_parse
    got = ex.execute(plan).to_pylist()
    assert got == rex.execute(RefPlanner(conns[1]).plan_query(
        ref_parse(sql))).to_pylist()
    assert len(got) == 9 + 7          # rows 0-8 and 18-24


def test_mesh_is_a_later_slice(engines, conns):
    with pytest.raises(NotImplementedError, match="later slice"):
        PL.execute_batched(conns[0], engines[0].plan_sql(Q1), 2,
                           mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the DECIMAL(38) final merges
# ---------------------------------------------------------------------------

CAP, ROWS = 1024, 900


def _merge_pages():
    """Partial-state pages: g BIGINT (50 groups), a DECIMAL(38,2) state
    whose four lanes are any int64 values (20% NULL; group 7 all NULL),
    and its BIGINT count column (5% NULL)."""
    rng = np.random.default_rng(3)
    lanes = [rng.integers(-2 ** 62, 2 ** 62, ROWS) for _ in range(4)]
    g = rng.integers(0, 50, ROWS)
    nulls = (rng.random(ROWS) < 0.2) | (g == 7)
    cnt = np.where(nulls, 0, rng.integers(0, 1000, ROWS))
    cnull = rng.random(ROWS) < 0.05

    def pad(a, fill=0, dt=np.int64):
        out = np.full(CAP, fill, dtype=dt)
        out[:ROWS] = a
        return out
    ref = RC.Page.from_columns([
        RC.Column.from_numpy(g, RT.BIGINT, capacity=CAP),
        RC.Decimal128Column(*[pad(x) for x in lanes], pad(nulls, True, bool),
                            RT.DecimalType(38, 2)),
        RC.Column.from_numpy(cnt, RT.BIGINT, nulls=cnull, capacity=CAP)],
        ROWS)
    port = PC.Page.from_columns([
        PC.Column.from_numpy(g, PT.BIGINT, capacity=CAP, device="cpu"),
        PC.Decimal128Column(*[torch.from_numpy(pad(x)) for x in lanes],
                            torch.from_numpy(pad(nulls, True, bool)),
                            PT.DecimalType(38, 2)),
        PC.Column.from_numpy(cnt, PT.BIGINT, nulls=cnull, capacity=CAP,
                             device="cpu")], ROWS, device="cpu")
    return ref, port


@pytest.mark.parametrize("group_fields", [(), (0,)],
                         ids=["global", "grouped"])
def test_merge_kinds_equal_jax(group_fields):
    ref, port = _merge_pages()
    rt, pt = RT.DecimalType(38, 2), PT.DecimalType(38, 2)
    rp, rn = RA.grouped_aggregate(ref, group_fields, [
        RA.AggSpec("sum128_merge", 1, rt),
        RA.AggSpec("avg128_merge", 1, rt, field2=2)], 256)
    pp, pn = PA.grouped_aggregate(port, group_fields, [
        PA.AggSpec("sum128_merge", 1, pt),
        PA.AggSpec("avg128_merge", 1, pt, field2=2)], 256)
    assert int(pn) == int(rn) == (50 if group_fields else 1)
    for rc, pc in zip(rp.columns, pp.columns):
        if isinstance(rc, RC.Decimal128Column):
            for a, b in zip(rc.value_lanes, pc.value_lanes):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            np.testing.assert_array_equal(np.asarray(rc.nulls),
                                          pc.nulls.numpy())
            assert (rc.count is None) == (pc.count is None)
            if rc.count is not None:
                np.testing.assert_array_equal(np.asarray(rc.count),
                                              pc.count.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(rc.values),
                                          pc.values.numpy())
    if group_fields:                     # group 7 holds no live state
        g = pp.columns[0].values.numpy().tolist()
        assert pp.columns[1].nulls[g.index(7)]


def _wide_engines(n=800):
    ref_mem, rows = _fixture(n)
    mem = MemoryConnector()
    mem.create("t", [("g", PT.VARCHAR), ("x", PT.DecimalType(38, 2)),
                     ("y", PT.DecimalType(4, 2))])
    mem.append_rows("t", rows)
    return mem, ref_mem, rows


def _half_up_avg(tot, cnt):
    unscaled = int(tot.scaleb(2))
    q, r = divmod(abs(unscaled), cnt)
    if 2 * r >= cnt:
        q += 1
    return Decimal(-q if unscaled < 0 else q).scaleb(-2)


@pytest.mark.parametrize("spill", [False, True], ids=["host", "disk"])
def test_wide_sums_batched_and_spilled_exact(tmp_path, spill):
    mem, ref_mem, rows = _wide_engines()
    oracle = _oracle_sums(rows)
    props = {"dynamic_filtering_enabled": "false"}
    if spill:
        props.update(spill_enabled="true", spill_path=str(tmp_path))
    for sql in ("select g, sum(x), avg(x), count(x) from t group by g",
                "select sum(x), avg(x), count(x) from t"):
        plan = Planner(mem).plan_query(parse_sql(sql))
        runner = PL.BatchedRunner(mem, plan, 4, session=Session(props),
                                  device="cpu")
        assert runner.batchable
        stats = {}
        got = sorted(runner.run(stats).to_pylist())
        if spill:
            assert stats["spill_files"] == 4
        from presto_tpu.sql.analyzer import Planner as RefPlanner
        from presto_tpu.sql.parser import parse_sql as ref_parse
        rplan = RefPlanner(ref_mem).plan_query(ref_parse(sql))
        want = sorted(RL.BatchedRunner(ref_mem, rplan, 4,
                                       session=RefSession(props))
                      .run().to_pylist())
        assert got == want
        groups = oracle if "group by" in sql else {None: [
            sum(v[0] for v in oracle.values()),
            sum(v[1] for v in oracle.values())]}
        for row in got:
            g = row[0] if "group by" in sql else None
            s, a, c = row[-3:]
            tot, cnt = groups[g]
            assert (s, a, c) == (tot, _half_up_avg(tot, cnt), cnt)
    assert os.listdir(str(tmp_path)) == []


def test_spilled_partials_with_different_keys(tmp_path):
    """Lifespans that hold different string keys: a partial read back from
    a spill file carries a dictionary of its own words, so the final merge
    remaps its codes (the JAX runner merges them into the first partial's
    dictionary: ROADMAP Queue 3)."""
    mem = MemoryConnector()
    mem.create("t", [("g", PT.VARCHAR), ("x", PT.BIGINT)])
    mem.append_rows("t", [("a" if i < 500 else "b", i)
                          for i in range(1000)])
    plan = Planner(mem).plan_query(parse_sql(
        "select g, sum(x) from t group by g"))
    want = [("a", sum(range(500))), ("b", sum(range(500, 1000)))]
    for props in ({}, {"spill_path": str(tmp_path)}):
        got = PL.BatchedRunner(mem, plan, 2, session=Session(props),
                               device="cpu").run()
        assert sorted(got.to_pylist()) == want


# ---------------------------------------------------------------------------
# spill frames and files
# ---------------------------------------------------------------------------

def _frame_pages(n=3000):
    """One page in both packages: BIGINT, DOUBLE, VARCHAR (NULLs in
    each), DECIMAL(38,2), BOOLEAN, DATE and ARRAY(BIGINT)."""
    rng = np.random.default_rng(1)
    k = rng.integers(-10 ** 12, 10 ** 12, n)
    kn = rng.random(n) < 0.1
    v = rng.random(n) * 1e6
    vn = rng.random(n) < 0.05
    words = ["apple", "banana", "cherry", "date"]
    s = rng.integers(0, 4, n).astype(np.int32)
    sn = rng.random(n) < 0.07
    d = [None if i % 13 == 0 else
         int(rng.integers(-10 ** 18, 10 ** 18)) * 10 ** 15 + i
         for i in range(n)]
    b = rng.random(n) < 0.5
    dt = rng.integers(0, 9000, n).astype(np.int32)
    arr = [None if i % 17 == 0 else
           [int(x) for x in rng.integers(0, 100, i % 4)] for i in range(n)]
    ref = RC.Page.from_columns([
        RC.Column.from_numpy(k, RT.BIGINT, nulls=kn),
        RC.Column.from_numpy(v, RT.DOUBLE, nulls=vn),
        RC.Column.from_numpy(s, RT.VARCHAR, nulls=sn,
                             dictionary=RC.StringDict(words)),
        RC.Decimal128Column.from_unscaled_ints(d, RT.DecimalType(38, 2)),
        RC.Column.from_numpy(b, RT.BOOLEAN),
        RC.Column.from_numpy(dt, RT.DATE),
        RC.NestedColumn.from_pylist(arr, RT.ArrayType(RT.BIGINT))], n)
    port = PC.Page.from_columns([
        PC.Column.from_numpy(k, PT.BIGINT, nulls=kn, device="cpu"),
        PC.Column.from_numpy(v, PT.DOUBLE, nulls=vn, device="cpu"),
        PC.Column.from_numpy(s, PT.VARCHAR, nulls=sn,
                             dictionary=PC.StringDict(words), device="cpu"),
        PC.Decimal128Column.from_unscaled_ints(d, PT.DecimalType(38, 2),
                                               device="cpu"),
        PC.Column.from_numpy(b, PT.BOOLEAN, device="cpu"),
        PC.Column.from_numpy(dt, PT.DATE, device="cpu"),
        PC.NestedColumn.from_pylist(arr, PT.ArrayType(PT.BIGINT),
                                    device="cpu")], n, device="cpu")
    return ref, port


@pytest.mark.parametrize("codec", [None, "zlib", "gzip", "lz4"])
def test_frames_byte_identical_to_jax(codec):
    ref, port = _frame_pages()
    a = RS.encode_serialized_page(RS.page_to_wire_blocks(ref),
                                  compression=codec)
    b = PS.encode_serialized_page(PS.page_to_wire_blocks(port),
                                  compression=codec)
    assert a == b
    rows = port.to_pylist()
    assert rows == ref.to_pylist()
    blocks, n, end = PS.decode_serialized_page(a)
    assert end == len(a)
    back = PS.wire_blocks_to_page(blocks, [c.type for c in port.columns], n,
                                  device="cpu")
    assert back.to_pylist() == rows
    blocks, n, _ = RS.decode_serialized_page(b)
    assert RS.wire_blocks_to_page(blocks, [c.type for c in ref.columns],
                                  n).to_pylist() == rows


def test_corrupt_frame_is_refused():
    _ref, port = _frame_pages(300)
    frame = bytearray(PS.encode_serialized_page(
        PS.page_to_wire_blocks(port), compression="lz4"))
    frame[40] ^= 0xFF
    with pytest.raises(ValueError, match="checksum mismatch"):
        PS.decode_serialized_page(bytes(frame))


def test_spiller_roundtrip_all_types(tmp_path):
    _ref, port = _frame_pages(500)
    sp = FileSpiller(str(tmp_path), device="cpu")
    h = sp.spill(port)
    assert os.path.exists(h.path) and h.bytes > 0
    assert sp.read(h).to_pylist() == port.to_pylist()
    sp.close()
    assert not os.path.exists(h.path)
    own = FileSpiller(device="cpu")
    own.spill(port)
    own.close()
    assert not os.path.exists(own.directory)


def test_batched_aggregation_spills_to_disk(tmp_path, conns):
    sql = POOL_SQL
    plan = Planner(conns[0]).plan_query(parse_sql(sql))
    runner = PL.BatchedRunner(
        conns[0], plan, 4,
        session=Session({"spill_enabled": "true",
                         "spill_path": str(tmp_path),
                         "dynamic_filtering_enabled": "false"}),
        device="cpu")
    assert runner.batchable
    stats = {}
    got = runner.run(stats).to_pylist()
    assert stats["spill_files"] == 4 and stats["spilled_bytes"] > 0
    assert_rows_match(got, LocalEngine(conns[0], device="cpu")
                      .execute_sql(sql), sort=True)
    assert os.listdir(str(tmp_path)) == []


def test_external_sort_many_runs_duplicate_keys(tmp_path, conns):
    """6 sorted runs over l_linenumber (7 distinct values): the k-way
    merge resolves duplicate keys across every run head."""
    sql = ("select l_linenumber, l_orderkey from lineitem "
           "order by l_linenumber")
    sort = Planner(conns[0]).plan_query(parse_sql(sql)).source
    rows, spilled = external_sort(SplitExecutor(conns[0], device="cpu"),
                                  sort, "lineitem", 6, str(tmp_path))
    assert spilled > 0
    exp = LocalEngine(conns[0], device="cpu").execute_sql(sql)
    assert len(rows) == len(exp) > 50000
    assert [r[0] for r in rows] == [e[0] for e in exp]
    assert sorted(rows) == sorted(exp)
    assert os.listdir(str(tmp_path)) == []


def test_merge_sorted_rows_duplicates_across_runs():
    runs = [
        [(1, "a0"), (1, "a1"), (3, "a2"), (5, "a3")],
        [(1, "b0"), (2, "b1"), (3, "b2")],
        [(2, "c0"), (2, "c1"), (2, "c2"), (6, "c3")],
        [(None, "d0"), (1, "d1"), (5, "d2")],   # null sorts last ASC
    ]
    merged = list(merge_sorted_rows(
        [iter(sorted(r, key=lambda t: (t[0] is None, t[0]))) for r in runs],
        [SortKey(field=0)]))
    flat = [row for r in runs for row in r]
    assert sorted(map(str, merged)) == sorted(map(str, flat))
    keys = [k for k, _ in merged]
    non_null = [k for k in keys if k is not None]
    assert non_null == sorted(non_null) and keys[-1] is None


# ---------------------------------------------------------------------------
# the memory pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_pool_reserve_free_and_over_budget(pkg):
    Pool, Err = ((MemoryPool, ExceededMemoryLimitError) if pkg == "port"
                 else (RM.MemoryPool, RM.ExceededMemoryLimitError))
    p = Pool(1000)
    p.reserve("q1", 300)
    p.reserve("q2", 200)
    assert p.reserved == 500 and p.query_reserved("q1") == 300
    p.free("q1", 100)
    assert p.query_reserved("q1") == 200
    p.free("q1")
    assert p.reserved == 200
    p = Pool(1000, revoke_threshold=1.0)
    p.reserve("q1", 900)
    with pytest.raises(Err) as e:
        p.reserve("q2", 200)
    assert str(e.value) == ("Query q2 exceeded node memory limit: "
                            "reserved 200 bytes, budget 1000 bytes")
    assert p.query_reserved("q1") == 900 and p.query_reserved("q2") == 0


def test_pool_revocation():
    p = MemoryPool(1000, revoke_threshold=0.8)
    spilled = []

    def hook(qid, need):
        spilled.append((qid, need))
        return 400

    p.add_revoke_hook(hook)
    p.reserve("big", 600)
    p.reserve("small", 100)
    p.reserve("small", 200)       # 900 > 800: revoke the biggest first
    assert spilled[0][0] == "big"
    assert p.revocations == 1 and p.revoked_bytes == 400
    assert p.query_reserved("big") == 200 and p.reserved == 500
    q = MemoryPool(1000, revoke_threshold=0.8)
    q.add_revoke_hook(lambda qid, need: 0)
    q.reserve("q1", 700)
    with pytest.raises(ExceededMemoryLimitError):
        q.reserve("q2", 400)


def test_cluster_kills_biggest_query():
    w1 = MemoryPool(800, revoke_threshold=1.0)
    w2 = MemoryPool(800, revoke_threshold=1.0)
    mgr = ClusterMemoryManager([w1, w2], budget_bytes=1000)
    w1.reserve("qa", 400)
    w2.reserve("qa", 300)
    w1.reserve("qb", 100)
    w2.reserve("qb", 200)
    assert mgr.maybe_kill() is None           # 1000: still fine
    w1.reserve("qb", 80)
    assert mgr.maybe_kill() == "qa"
    assert w1.query_reserved("qa") == 0 == w2.query_reserved("qa")
    with pytest.raises(ExceededMemoryLimitError) as e:
        mgr.check_killed("qa")
    assert str(e.value) == ("Query qa exceeded cluster memory limit: "
                            "reserved 700 bytes, budget 1000 bytes")
    mgr.check_killed("qa")
    mgr.check_killed("qb")


def test_engine_over_budget_query_batches(conns):
    """A query whose footprint exceeds the pool's budget completes
    lifespan-batched, in as many lifespans as the JAX engine takes."""
    want = LocalEngine(conns[0], device="cpu").execute_sql(POOL_SQL)
    pool = MemoryPool(2 * 1024 * 1024, revoke_threshold=1.0)
    eng = LocalEngine(conns[0], memory_pool=pool, device="cpu")
    got = eng.execute_sql(POOL_SQL)
    assert_rows_match(got, want, float_tol=1e-9, sort=True)
    assert eng.last_memory_fallback_batches >= 2
    assert pool.reserved == 0
    ref = RefEngine(conns[1], memory_pool=RM.MemoryPool(
        2 * 1024 * 1024, revoke_threshold=1.0))
    assert_rows_match(got, ref.execute_sql(POOL_SQL), float_tol=1e-9,
                      sort=True)
    assert eng.last_memory_fallback_batches \
        == ref.last_memory_fallback_batches


def test_engine_killed_query_raises(conns):
    pool = MemoryPool(1 << 40, revoke_threshold=1.0)
    mgr = ClusterMemoryManager([pool], budget_bytes=1000)
    eng = LocalEngine(conns[0], memory_pool=pool, cluster_memory=mgr,
                      device="cpu")
    pool.reserve("small", 10)
    with pytest.raises(ExceededMemoryLimitError,
                       match="exceeded cluster memory limit"):
        eng.execute_sql("select count(*) from region")
    assert pool.query_reserved("small") == 10 and pool.reserved == 10


# ---------------------------------------------------------------------------
# the Grace spill join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql,budget", [(JOIN_SQL, 6000),
                                        (GRACE_SQL, 200_000)],
                         ids=["nation_region", "lineitem_orders"])
def test_spill_join_equals_jax(conns, sql, budget):
    """Through the engines' pool route. The stats equal the JAX package's
    but for the files: the JAX module's float64 partition ids send nearly
    every row to partition 0 (ROADMAP Queue 3), so it writes about one
    file a chunk where the port writes one a non-empty partition."""
    eng = LocalEngine(conns[0], memory_pool=MemoryPool(budget),
                      device="cpu")
    ref = RefEngine(conns[1], memory_pool=RM.MemoryPool(budget))
    got = eng.execute_sql(sql)
    want = ref.execute_sql(sql)
    assert_rows_match(got, want, sort="order by" not in sql)
    assert_rows_match(got, LocalEngine(conns[0], device="cpu")
                      .execute_sql(sql), sort="order by" not in sql)
    st, rst = eng.last_spill_join_stats, ref.last_spill_join_stats
    keys = ("partitions", "build_batches", "probe_batches")
    assert {k: st[k] for k in keys} == {k: rst[k] for k in keys}
    assert st["partitions"] >= 2
    chunks = st["build_batches"] + st["probe_batches"]
    assert rst["spill_files"] < st["spill_files"]
    assert st["spill_files"] > chunks
    assert eng.memory_pool.reserved == 0


@pytest.mark.parametrize("sql,why", [
    ("select c_name, s_name from customer, supplier "
     "where c_phone = s_phone", "string join keys"),
    ("select n_name, r_name from nation join region on "
     "n_regionkey = r_regionkey and n_nationkey > r_regionkey",
     "join carries a residual filter"),
    ("select count(*) from nation, region "
     "where n_regionkey = r_regionkey", "plan root is not an inner join")],
    ids=["string_keys", "residual_filter", "aggregation_root"])
def test_spill_join_refusals_equal_jax(engines, conns, sql, why):
    eng, ref = engines
    with pytest.raises(PSJ.SpillJoinUnsupported, match=why):
        PSJ.execute_spill_join(conns[0], eng.plan_sql(sql), 1000,
                               device="cpu")
    with pytest.raises(RSJ.SpillJoinUnsupported, match=why):
        RSJ.execute_spill_join(conns[1], ref.plan_sql(sql), 1000)
