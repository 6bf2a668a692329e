"""The port's engine against the JAX package's engine, on the CPU.

The same SQL runs through presto_tpu's LocalEngine and through
presto_tpu_torch's LocalEngine(device="cpu") over TPC-H SF 0.01, and the
rows are compared with tests/oracle.assert_rows_match at float_tol=1e-6
(sorted unless the query has ORDER BY). Also: the two TPC-H generators
give identical tables, the checked-arithmetic lane raises the same error,
a window query raises NotImplementedError (windows are a later slice),
and with no card the engine refuses to run unless it is given the CPU.
The join queries are in tests/test_torch_tpch.py.
"""

import numpy as np
import pytest
import torch

from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu_torch.connectors import TpchConnector
from presto_tpu_torch.exec.engine import LocalEngine
from tests.oracle import assert_rows_match
from tests.tpch_queries import QUERIES

SF = 0.01

Q18_BLOCK = """
select l_orderkey, sum(l_quantity)
from lineitem
group by l_orderkey
having sum(l_quantity) > 250
"""

SLICE = {"q01": QUERIES[1], "q06": QUERIES[6], "q18_block": Q18_BLOCK}

EXTRA = {
    "minmax_mixed": """
        select l_returnflag, min(l_shipdate), max(l_extendedprice),
               count(l_comment), avg(l_linenumber), sum(l_linenumber)
        from lineitem group by l_returnflag""",
    "sorted_topn": """
        select l_suppkey, min(l_quantity), max(l_shipmode), count(*),
               avg(l_tax), sum(l_partkey)
        from lineitem where l_shipmode like '%AIR%'
        group by l_suppkey order by l_suppkey limit 20""",
    "dates_case": """
        select year(l_shipdate), month(l_shipdate), count(*),
               sum(case when l_discount > 0.05 then 1 else 0 end)
        from lineitem group by year(l_shipdate), month(l_shipdate)
        order by 1, 2 limit 30""",
    "strings": """
        select n_name, n_regionkey, upper(n_name), length(n_comment),
               substr(n_name, 2, 3)
        from nation where n_regionkey in (1, 3) order by n_name""",
    "interval_month": """
        select o_orderpriority, count(*) from orders
        where o_orderdate >= date '1993-07-01'
          and o_orderdate < date '1993-07-01' + interval '3' month
        group by o_orderpriority order by o_orderpriority""",
    "filter_project": """
        select l_orderkey, l_linenumber, l_quantity * 2 - 1,
               l_extendedprice / l_quantity
        from lineitem where l_orderkey < 40 and l_shipmode <> 'MAIL'
        order by l_orderkey desc, l_linenumber""",
}


@pytest.fixture(scope="module")
def engines():
    return (RefEngine(RefTpch(SF)),
            LocalEngine(TpchConnector(SF), device="cpu"))


@pytest.mark.parametrize("name", list(SLICE) + list(EXTRA))
def test_query_matches_jax_engine(engines, name):
    ref, port = engines
    sql = SLICE.get(name) or EXTRA[name]
    expected = ref.execute_sql(sql)
    assert expected, "the comparison needs rows"
    assert_rows_match(port.execute_sql(sql), expected, float_tol=1e-6,
                      sort="order by" not in sql.lower())


def test_slice_plans_equal_jax_plans(engines):
    ref, port = engines
    for sql in SLICE.values():
        assert repr(port.plan_sql(sql)).replace("presto_tpu_torch.", "") \
            == repr(ref.plan_sql(sql)).replace("presto_tpu.", "")


@pytest.mark.parametrize("table", ["lineitem", "nation", "region",
                                   "supplier", "customer", "part",
                                   "partsupp", "orders"])
def test_tpch_generator_matches_jax(table):
    r = RefTpch(SF).table(table)
    p = TpchConnector(SF).table(table)
    assert p.num_rows == r.num_rows
    assert list(p.types) == list(r.types)
    for c in r.types:
        np.testing.assert_array_equal(p.arrays[c], r.arrays[c])
        if c in r.dicts:
            assert p.dicts[c].words == r.dicts[c].words


MIN_EXPR = "(l_orderkey - l_orderkey - 9223372036854775807 - 1)"

CHECKED = {
    "mul": ("select l_orderkey * 9223372036854775807 from lineitem",
            "bigint multiplication overflow"),
    "add": ("select l_orderkey + 9223372036854775807 from lineitem",
            "bigint addition overflow"),
    "sub": ("select (0 - l_orderkey) - 9223372036854775807 from lineitem",
            "bigint subtraction overflow"),
    "neg": (f"select -{MIN_EXPR} from lineitem", "bigint negation overflow"),
    "abs": (f"select abs({MIN_EXPR}) from lineitem", "bigint abs overflow"),
    "div": (f"select {MIN_EXPR} / (l_orderkey - l_orderkey - 1) "
            f"from lineitem", "bigint division overflow"),
    "cast": ("select cast(l_orderkey * 1000000 as integer) from lineitem",
             "out of range for integer cast"),
    "sum_global": ("select sum(l_orderkey + 9223372036854000000) "
                   "from lineitem", "bigint sum overflow"),
    "sum_direct": ("select l_returnflag, sum(l_orderkey + "
                   "9223372036854000000) from lineitem group by "
                   "l_returnflag", "bigint sum overflow"),
    "sum_sorted": ("select l_orderkey, sum(l_partkey + 9223372036854000000)"
                   " from lineitem group by l_orderkey",
                   "bigint sum overflow"),
    "fits": ("select max(l_orderkey + 9223372036854000000), "
             "sum(l_orderkey * 1000) from lineitem", None),
}


@pytest.mark.parametrize("case", list(CHECKED))
def test_checked_arithmetic_matches_jax(engines, case):
    """The error lane: the same overflow raises the same error in both
    engines, and values at the edge pass."""
    ref, port = engines
    sql, message = CHECKED[case]
    if message is None:
        assert port.execute_sql(sql) == ref.execute_sql(sql)
        return
    with pytest.raises(ArithmeticError) as r_err:
        ref.execute_sql(sql)
    with pytest.raises(ArithmeticError) as p_err:
        port.execute_sql(sql)
    assert str(p_err.value) == str(r_err.value) == message


def test_join_raises_not_implemented(engines):
    """Joins run since the second slice and windows since the third; a
    part still unported (approx_distinct's HyperLogLog here) raises
    NotImplementedError naming a later slice."""
    _ref, port = engines
    with pytest.raises(NotImplementedError, match="later slice"):
        port.execute_sql("select approx_distinct(n_name) from nation")


def test_engine_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalEngine(TpchConnector(SF))
    assert LocalEngine(TpchConnector(SF), device="cpu").device.type == "cpu"
