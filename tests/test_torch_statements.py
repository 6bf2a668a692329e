"""The statement path of the port against the JAX package, on the CPU.

Over TPC-H SF 0.01 in a MemoryConnector(fallback=TpchConnector(0.01)):

- the statements of tests/test_memory_connector.py, DELETE with and
  without WHERE, INSERT with a column list, DECIMAL(12,2) and
  DECIMAL(38,2) values, CTAS of a DECIMAL(38) product and of new words
  run in the same sequence through presto_tpu's LocalEngine and
  presto_tpu_torch's LocalEngine(device="cpu"): every count row and
  query row is held with tests/oracle.assert_rows_match, and the written
  tables column by column (values, nulls and dictionary words exactly;
  DOUBLE values within the oracle's 1e-6 relative, since the engines sum
  in another order), and so are the table versions;
- the error cases raise the same exception class with the same message;
- the three queries of tests/test_cte_materialization.py and TPC-H q15,
  materialized, against the port inlined and against the JAX engine;
- a TableWriterNode root built over a scan plan, on both executors;
- EXPLAIN of every TPC-H query equals the JAX engine's `explain_sql`.

And the two repairs of the slice: q13 and q22 compute no dictionary
transform when warm and give the same rows; a new dictionary (an INSERT
of new words) misses the cache; IF, CASE and COALESCE over DECIMAL(38)
equal decimal.Decimal arithmetic, and spec-typed TPC-H q14 equals exact
arithmetic over the generator's arrays (the JAX engine raises on it:
ROADMAP Queue 3).
"""

import datetime
from decimal import Decimal, localcontext

import numpy as np
import pytest

from presto_tpu.connectors import MemoryConnector as RefMemory
from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu.plan import nodes as RP
from presto_tpu import types as RT
from presto_tpu_torch.config import Session
from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
from presto_tpu_torch.connectors.tpch import decimal_lineitem
from presto_tpu_torch.data.column import StringDict
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.expr import compile as C
from presto_tpu_torch.plan import nodes as PP
from presto_tpu_torch import types as PT
from tests.oracle import assert_rows_match
from tests.tpch_queries import QUERIES
from torch_threads import _one_torch_thread  # noqa: F401

SF = 0.01

#: statement sequences: name -> statements, run in order on both engines
SEQUENCES = {
    # tests/test_memory_connector.py
    "create_insert_select_drop": [
        "create table t1 (a bigint, b varchar, c double)",
        "insert into t1 values (1, 'x', 1.5), (2, 'y', 2.5), "
        "(3, null, null)",
        "select * from t1 order by a",
        "select b, sum(c) from t1 group by b order by b",
        "drop table t1",
    ],
    "ctas_from_tpch": [
        "create table agg as select l_returnflag, count(*) cnt, "
        "sum(l_quantity) qty from lineitem group by l_returnflag",
        "select l_returnflag, cnt, qty from agg order by l_returnflag",
        "select a.l_returnflag, a.cnt from agg a, lineitem l "
        "where a.l_returnflag = l.l_returnflag "
        "group by a.l_returnflag, a.cnt order by a.l_returnflag",
    ],
    "insert_select_and_column_subset": [
        "create table t2 (k bigint, s varchar)",
        "insert into t2 select o_orderkey, o_orderstatus from orders "
        "where o_orderkey < 40",
        "select count(*) from t2",
        "insert into t2 (k) values (99)",
        "select s from t2 where k = 99",
        "select * from t2 order by k",
    ],
    "if_not_exists": [
        "create table t3 (a bigint)",
        "create table if not exists t3 (a bigint)",
        "create table if not exists t3b as select 1 x",
        "drop table t3",
        "drop table if exists t3",
    ],
    "delete": [
        "create table o as select o_orderkey, o_custkey, o_totalprice, "
        "o_orderpriority, o_comment from orders "
        "where o_orderdate between date '1995-03-01' and date '1995-03-31'",
        "insert into o (o_orderkey, o_orderpriority) values (1, '9-NONE')",
        # a NULL predicate keeps the row (it is not TRUE)
        "delete from o where o_totalprice < 100000",
        "select count(*), sum(o_totalprice) from o",
        "select o_orderpriority, count(*) from o group by o_orderpriority "
        "order by 1",
        "delete from o where o_orderpriority = '1-URGENT'",
        "select count(*) from o",
        "delete from o",
        "select count(*) from o",
    ],
    "insert_column_list": [
        "create table c (a bigint, b varchar, d date)",
        "insert into c (b, a) values ('x', 1), ('y', 2)",
        "insert into c (d, a) values (date '1995-03-01', 3)",
        "insert into c select n_nationkey, n_name, null from nation "
        "where n_regionkey = 0",
        "select * from c order by a",
    ],
    "decimals": [
        "create table d (k bigint, p decimal(12,2), w decimal(38,2), "
        "s varchar)",
        "insert into d values "
        "(1, 12.34, 12345678901234567890123456.78, 'a'), "
        "(2, null, 0.01, null), (3, 9999999999.99, null, 'b'), "
        "(4, 0.5, 99999999999999999999999999999999.99, 'a')",
        "select * from d order by k",
        "select sum(p), sum(w), min(w), max(p) from d",
        "create table d2 as select k, p * w pw, p + 1 p1, w * 3 w3 from d",
        "select * from d2 order by k",
        "insert into d2 select k + 10, p * p, p, w from d where k < 3",
        "select k, pw, p1, w3 from d2 order by k",
    ],
    "spec_typed_ctas": [
        "create table li as select l_orderkey, l_extendedprice, "
        "l_extendedprice * (1 - l_discount) rev from lineitem "
        "where l_orderkey < 200",
        "select count(*), sum(rev), sum(l_extendedprice) from li",
        "delete from li where rev > 50000",
        "select l_orderkey, sum(rev) from li group by l_orderkey "
        "order by l_orderkey",
    ],
    "new_words": [
        "create table w as select n_name from nation where n_regionkey = 1",
        "insert into w values ('ZANZIBAR'), ('BRAZIL'), (null)",
        "select n_name, upper(n_name), length(n_name) from w "
        "order by n_name",
        "select count(*) from w join nation on w.n_name = nation.n_name",
    ],
}

#: error cases: name -> (statements run first, the failing statement)
ERRORS = {
    "create_on_tpch": (None, "create table x (a bigint)"),
    "drop_on_tpch": (None, "drop table nation"),
    "delete_on_tpch": (None, "delete from nation"),
    "delete_unknown": ([], "delete from nosuch"),
    "insert_arity": (["create table t (a bigint, b bigint)"],
                     "insert into t values (1)"),
    "insert_list_arity": (["create table t (a bigint, b bigint)"],
                          "insert into t (a) values (1, 2)"),
    "insert_unknown_column": (["create table t (a bigint)"],
                              "insert into t (zz) values (1)"),
    "insert_not_literal": (["create table t (a bigint)"],
                           "insert into t values (abs(1))"),
    # a negative number is a negation, not a literal, in both engines
    "insert_negative": (["create table t (a bigint)"],
                        "insert into t values (-1)"),
    "nested_column": ([], "create table t (a array(bigint))"),
    "bad_type": ([], "create table t (a nosuchtype)"),
    "create_twice": (["create table t (a bigint)"],
                     "create table t (a bigint)"),
    "drop_unknown": ([], "drop table nosuch"),
}


@pytest.fixture
def engines():
    """A writable JAX engine and port engine over the same tables."""
    ref = RefEngine(RefMemory(fallback=RefTpch(SF)))
    port = LocalEngine(MemoryConnector(fallback=TpchConnector(SF)),
                       device="cpu")
    return ref, port


def _nulls(t, c):
    got = (t.nulls or {}).get(c)
    return (np.zeros(t.num_rows, bool) if got is None
            else np.asarray(got[:t.num_rows], bool))


def assert_same_tables(ref_mem, port_mem):
    """Every table written in both connectors: names, types, row counts,
    nulls, values (DOUBLE within 1e-6 relative) and dictionary words."""
    assert sorted(port_mem.tables) == sorted(ref_mem.tables)
    for name, rt in ref_mem.tables.items():
        pt = port_mem.tables[name]
        n = rt.num_rows
        assert pt.num_rows == n, name
        assert pt.column_names() == rt.column_names(), name
        assert port_mem.table_version(name) == ref_mem.table_version(name)
        for c in rt.column_names():
            what = f"{name}.{c}"
            assert str(pt.types[c]) == str(rt.types[c]), what
            nulls = _nulls(rt, c)
            assert np.array_equal(_nulls(pt, c), nulls), what
            rv = list(np.asarray(rt.arrays[c][:n])[~nulls])
            pv = list(np.asarray(pt.arrays[c][:n])[~nulls])
            if rt.types[c].is_string:
                assert pt.dicts[c].words == rt.dicts[c].words, what
                assert [int(v) for v in pv] == [int(v) for v in rv], what
            elif rt.types[c].is_floating:
                assert_rows_match([tuple(pv)], [tuple(rv)], float_tol=1e-6)
            else:
                assert [int(v) for v in pv] == [int(v) for v in rv], what


def _check(port_rows, ref_rows, sql):
    assert_rows_match(port_rows, ref_rows, float_tol=1e-6,
                      sort="order by" not in sql.lower())


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_statements_match_jax_engine(engines, name):
    ref, port = engines
    for sql in SEQUENCES[name]:
        _check(port.execute_sql(sql), ref.execute_sql(sql), sql)
    assert_same_tables(ref.connector, port.connector)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_statement_errors_match_jax_engine(engines, name):
    ref, port = engines
    setup, sql = ERRORS[name]
    if setup is None:       # a connector with no writes
        ref, port = RefEngine(RefTpch(SF)), LocalEngine(TpchConnector(SF),
                                                        device="cpu")
        setup = []
    for s in setup:
        assert port.execute_sql(s) == ref.execute_sql(s)
    with pytest.raises(Exception) as r_err:
        ref.execute_sql(sql)
    with pytest.raises(Exception) as p_err:
        port.execute_sql(sql)
    assert type(p_err.value).__name__ == type(r_err.value).__name__
    assert str(p_err.value) == str(r_err.value)
    if setup:
        assert_same_tables(ref.connector, port.connector)


def test_versions_and_connector_ids(engines):
    """create and each append of rows bump a table's version; names read
    through (a dropped table's too) give the fallback's version and
    connector id; both as in the JAX package."""
    ref, port = engines
    steps = [("create table v (a bigint)", True, 1),
             ("insert into v values (1)", True, 2),
             ("insert into v select n_nationkey from nation "
              "where n_nationkey < 0", True, 2),                # no rows
             ("delete from v", True, 4),    # a drop, a create, no rows
             ("drop table v", False, 0)]
    for sql, exists, version in steps:
        assert port.execute_sql(sql) == ref.execute_sql(sql)
        for mem in (port.connector, ref.connector):
            assert (mem.exists("v"), mem.table_version("v"),
                    mem.table_version("nation")) == (exists, version, 0)
            assert mem.connector_id("v") == ("memory" if exists
                                              else "tpch")
            assert mem.connector_id("nation") == "tpch"


# ---------------------------------------------------------------------------
# materialized CTEs
# ---------------------------------------------------------------------------

Q15_STYLE = """
with revenue as (
  select l_suppkey as supplier_no, sum(l_extendedprice * l_discount)
    as total_revenue
  from lineitem group by l_suppkey
)
select count(*), sum(r1.total_revenue)
from revenue r1, revenue r2
where r1.supplier_no = r2.supplier_no
"""

CTE_QUERIES = {
    "q15_style": Q15_STYLE,
    "single_ref": """
        with big as (select * from orders where o_totalprice > 100000)
        select count(*) from big""",
    "chained": """
        with a as (select o_custkey, count(*) c from orders
                   group by o_custkey),
             b as (select * from a where c > 1)
        select (select count(*) from b), sum(x.c + y.c)
        from b x, b y where x.o_custkey = y.o_custkey""",
    "q15": QUERIES[15],
}


@pytest.fixture(scope="module")
def cte_engines():
    mat = LocalEngine(TpchConnector(SF), device="cpu", session=Session(
        {"cte_materialization_enabled": "true"}))
    return (mat, LocalEngine(TpchConnector(SF), device="cpu"),
            RefEngine(RefTpch(SF)))


@pytest.mark.parametrize("name", sorted(CTE_QUERIES))
def test_materialized_ctes_match_inlined_and_jax(cte_engines, name):
    mat, inline, ref = cte_engines
    sql = CTE_QUERIES[name]
    assert isinstance(mat.connector, MemoryConnector)
    versions = mat.connector.__dict__.setdefault("_table_versions", {})
    before = set(versions)
    got = mat.execute_sql(sql)
    _check(got, inline.execute_sql(sql), sql)
    _check(got, ref.execute_sql(sql), sql)
    # a multiply-referenced CTE made a temp table, now dropped
    made = [t for t in set(versions) - before if t.startswith("__cte_")]
    assert bool(made) == (name != "single_ref")
    assert not mat.connector.tables


def test_failed_materialization_drops_its_temps():
    mem = MemoryConnector(fallback=TpchConnector(SF))
    mat = LocalEngine(mem, device="cpu", session=Session(
        {"cte_materialization_enabled": "true"}))
    sql = """with a as (select n_nationkey k from nation),
                  b as (select no_such_column from a)
             select * from a x, a y, b u, b v"""
    with pytest.raises(Exception):
        mat.execute_sql(sql)
    assert not mem.tables


# ---------------------------------------------------------------------------
# TableWriterNode and EXPLAIN
# ---------------------------------------------------------------------------

def test_table_writer_root_matches_jax(engines):
    """A writer over a scan plan whose columns are named in another order
    than the table's, one table column left to NULL-fill."""
    ref, port = engines
    src = ("select n_name, n_nationkey from nation where n_regionkey = 1 "
           "order by n_nationkey")
    ddl = "create table dst (k bigint, name varchar, extra double)"
    assert port.execute_sql(ddl) == ref.execute_sql(ddl)
    outs = []
    for eng, P, T in ((ref, RP, RT), (port, PP, PT)):
        writer = P.TableWriterNode(("rows",), (T.BIGINT,),
                                   source=eng.plan_sql(src), table="dst",
                                   column_names=("name", "k"))
        outs.append(eng.executor.execute(writer).to_pylist())
    assert outs[1] == outs[0] == [(5,)]
    sql = "select * from dst order by k"
    _check(port.execute_sql(sql), ref.execute_sql(sql), sql)
    assert all(r[2] is None for r in port.execute_sql(sql))
    assert_same_tables(ref.connector, port.connector)


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_explain_matches_jax_engine(q):
    """EXPLAIN <query> returns one VARCHAR row per line of the JAX
    engine's plan text."""
    ref = RefEngine(RefTpch(SF))
    port = LocalEngine(TpchConnector(SF), device="cpu")
    want = ref.explain_sql(QUERIES[q])
    assert port.explain_sql(QUERIES[q]) == want
    assert port.execute_sql("explain " + QUERIES[q]) == \
        [(line,) for line in want.splitlines()]
    assert port.column_names(QUERIES[q]) == ref.column_names(QUERIES[q])


# ---------------------------------------------------------------------------
# the dictionary cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_port():
    return LocalEngine(TpchConnector(SF), device="cpu")


@pytest.mark.parametrize("q", [13, 22])
def test_warm_query_computes_no_transform(tpch_port, q):
    cold = tpch_port.execute_sql(QUERIES[q])
    before = C.DICT_CACHE.computed
    warm = tpch_port.execute_sql(QUERIES[q])
    assert C.DICT_CACHE.computed == before
    assert warm == cold
    # a second engine over the same tables shares the tables' caches
    other = LocalEngine(tpch_port.connector, device="cpu")
    assert other.execute_sql(QUERIES[q]) == cold
    assert C.DICT_CACHE.computed == before


def test_new_dictionary_misses_the_cache():
    port = LocalEngine(MemoryConnector(), device="cpu")
    port.execute_sql("create table s (w varchar)")
    port.execute_sql("insert into s values ('b'), ('a')")
    sql = "select w, upper(w), substr(w, 1, 1) from s where w like '%a%'"
    assert port.execute_sql(sql) == [("a", "A", "a")]
    before = C.DICT_CACHE.computed
    assert port.execute_sql(sql) == [("a", "A", "a")]
    assert C.DICT_CACHE.computed == before
    # no new word: the table keeps its dictionary, and the cache hits
    port.execute_sql("insert into s values ('a')")
    assert port.execute_sql(sql) == [("a", "A", "a")] * 2
    assert C.DICT_CACHE.computed == before
    # new words: a new union dictionary, whose transforms are built anew
    port.execute_sql("insert into s values ('ca'), ('d')")
    assert sorted(port.execute_sql(sql)) == \
        [("a", "A", "a")] * 2 + [("ca", "CA", "c")]
    assert C.DICT_CACHE.computed > before


def test_cache_keys_hold_arguments_and_outlive_no_dictionary():
    """Other literal arguments miss; a freed dictionary's id reused by a
    new one cannot reach the old results (the cache is on the
    dictionary)."""
    import torch
    from presto_tpu_torch.data.column import Column
    codes = torch.zeros(4, dtype=torch.int32)
    nulls = torch.zeros(4, dtype=torch.bool)
    for i in range(200):
        d = StringDict([f"word{i}"])
        col = Column(codes, nulls, PT.VARCHAR, d)
        for length in (1, 3):
            out = C._dict_transform(col, ("substr", 1, length),
                                    lambda w: w[:length])
            assert out.dictionary.words == (f"word{i}"[:length],)
        del d, col, out


# ---------------------------------------------------------------------------
# IF / CASE / COALESCE over DECIMAL(38), spec-typed q14
# ---------------------------------------------------------------------------

WIDE_ROWS = [
    (1, Decimal("12345678901234567890123456.78"), Decimal("1.25")),
    (2, None, Decimal("-7.50")),
    (3, Decimal("-99999999999999999999999999999999.99"), None),
    (4, None, None),
    (5, Decimal("0.01"), Decimal("9999999999.99")),
]


def _wide_expected(k, w, p):
    """Each query's value per row in decimal.Decimal, exact (64 digits)."""
    with localcontext() as ctx:
        ctx.prec = 64
        return _wide_values(k, w, p)


def _wide_values(k, w, p):
    return {
        "if": w if k > 2 else p,
        "case": w if k == 1 else (p if k == 2 else Decimal(7)),
        "coalesce": w if w is not None else (p if p is not None
                                             else Decimal(0)),
        "coalesce_product": (w * p if w is not None and p is not None
                             else Decimal(5)),
        "case_null": w * 3 if k > 1 and w is not None else None,
        "if_double": float(w) if k < 3 and w is not None else (
            None if k < 3 else 0.5),
    }


WIDE_QUERIES = {
    "if": "select k, case when k > 2 then w else p end from t",
    "case": "select k, case when k = 1 then w when k = 2 then p "
            "else 7 end from t",
    "coalesce": "select k, coalesce(w, p, 0) from t",
    "coalesce_product": "select k, coalesce(w * p, 5) from t",
    "case_null": "select k, case when k > 1 then w * 3 else null end "
                 "from t",
    "if_double": "select k, case when k < 3 then cast(w as double) "
                 "else 0.5e0 end from t",
}


@pytest.fixture(scope="module")
def wide_engine():
    port = LocalEngine(MemoryConnector(), device="cpu")
    port.execute_sql("create table t (k bigint, w decimal(38,2), "
                     "p decimal(12,2))")
    mem = port.connector
    mem.append_rows("t", WIDE_ROWS)
    return port


@pytest.mark.parametrize("name", sorted(WIDE_QUERIES))
def test_wide_if_case_coalesce_equal_decimal(wide_engine, name):
    got = sorted(wide_engine.execute_sql(WIDE_QUERIES[name]))
    want = [(k, _wide_expected(k, w, p)[name]) for k, w, p in WIDE_ROWS]
    assert got == want


def _spec_q14_exact():
    """q14's two sums (scale 4) and promo_revenue from the generator's
    arrays with Python ints, and its quotient in decimal.Decimal."""
    li = decimal_lineitem(SF)
    part = TpchConnector(SF).table("part")
    a = {c: v[:li.num_rows] for c, v in li.arrays.items()}
    lo = (datetime.date(1995, 9, 1) - datetime.date(1970, 1, 1)).days
    hi = (datetime.date(1995, 10, 1) - datetime.date(1970, 1, 1)).days
    m = (a["l_shipdate"] >= lo) & (a["l_shipdate"] < hi)
    promo_type = np.array([w.startswith("PROMO")
                           for w in part.dicts["p_type"].words])
    row_of = np.searchsorted(part.arrays["p_partkey"][:part.num_rows],
                             a["l_partkey"][m])
    promo = promo_type[part.arrays["p_type"][row_of]]
    rev = [int(x) * (100 - int(y)) for x, y in
           zip(a["l_extendedprice"][m], a["l_discount"][m])]
    s_promo = sum(r for r, f in zip(rev, promo) if f)
    s_all = sum(rev)
    return (Decimal(s_promo).scaleb(-4), Decimal(s_all).scaleb(-4),
            Decimal(100 * s_promo) / Decimal(s_all))


def test_spec_typed_q14_equals_exact_arithmetic():
    mem = MemoryConnector(fallback=TpchConnector(SF))
    mem.register(decimal_lineitem(SF))
    port = LocalEngine(mem, device="cpu")
    promo, total, quotient = _spec_q14_exact()
    sums = QUERIES[14].replace(
        "100.00 * sum(", "sum(").replace(
        "/ sum(l_extendedprice * (1 - l_discount)) as promo_revenue",
        ", sum(l_extendedprice * (1 - l_discount))")
    assert port.execute_sql(sums) == [(promo, total)]
    ((got,),) = port.execute_sql(QUERIES[14])
    assert abs(got - float(quotient)) <= 1e-15 * abs(float(quotient))
