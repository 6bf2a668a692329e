"""Windows, grouping sets, distinct marks and UNION ALL through the port's
engine on the CPU, against the JAX package's engine.

At TPC-H SF 0.01, presto_tpu_torch's LocalEngine(device="cpu") and the
JAX package's LocalEngine run the queries of tests/test_window_outer.py
(WINDOW_QUERIES, FRAME_QUERIES, BOUNDED_MINMAX_QUERIES and the string
min/max query) and tests/test_grouping_sets.py (CASES), one mixed
count(x), count(distinct y) query (planned with MarkDistinct) and one
UNION ALL of two string columns with different dictionaries; rows are
compared with tests/oracle.assert_rows_match(float_tol=1e-6), sorted
where the query has no ORDER BY.
"""

import pytest
import torch

from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu_torch.connectors import TpchConnector
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.plan.nodes import MarkDistinctNode, UnionAllNode
from tests.oracle import assert_rows_match
from tests.test_grouping_sets import CASES
from tests.test_window_outer import (
    BOUNDED_MINMAX_QUERIES, FRAME_QUERIES, WINDOW_QUERIES,
)

SF = 0.01

STRING_MINMAX = (
    "select n_regionkey, min(n_name) over (partition by n_regionkey) mn, "
    "max(n_name) over (partition by n_regionkey) mx from nation")

MIXED_DISTINCT = (
    "select l_returnflag, count(l_orderkey), count(distinct l_suppkey) "
    "from lineitem group by l_returnflag")

UNION_TWO_DICTS = (
    "select n_name s from nation where n_regionkey < 2 "
    "union all select r_name from region "
    "union all select c_mktsegment from customer where c_custkey < 40")

QUERIES = ([("window", i, q) for i, q in enumerate(WINDOW_QUERIES)]
           + [("frame", i, q) for i, q in enumerate(FRAME_QUERIES)]
           + [("bounded", i, q) for i, q in enumerate(BOUNDED_MINMAX_QUERIES)]
           + [("grouping", name, sql) for name, sql, _exp in CASES]
           + [("string_minmax", 0, STRING_MINMAX),
              ("mark_distinct", 0, MIXED_DISTINCT),
              ("union_all", 0, UNION_TWO_DICTS)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU pages here are small: torch's intra-op threads do not speed
    these tests up, and under pytest-xdist they would take cores from the
    tests running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    return LocalEngine(TpchConnector(SF), device="cpu")


@pytest.fixture(scope="module")
def ref():
    return RefEngine(RefTpch(SF))


@pytest.mark.parametrize("group,i,sql", QUERIES,
                         ids=[f"{g}-{i}" for g, i, _q in QUERIES])
def test_breadth_query_matches_jax_engine(group, i, sql, port, ref):
    assert_rows_match(port.execute_sql(sql), ref.execute_sql(sql),
                      float_tol=1e-6, sort="order by" not in sql.lower())


def _nodes(plan, kind):
    out = [plan] if isinstance(plan, kind) else []
    for c in plan.children():
        out += _nodes(c, kind)
    return out


def test_mixed_distinct_plans_mark_distinct(port):
    assert _nodes(port.plan_sql(MIXED_DISTINCT), MarkDistinctNode)


def test_union_merges_dictionaries_once(port):
    """The branches' string dictionaries differ: the executor merges them
    on the first run and reuses the merged dictionary afterwards."""
    assert _nodes(port.plan_sql(UNION_TWO_DICTS), UnionAllNode)
    first = port.execute_sql(UNION_TWO_DICTS)
    merged = dict(port.executor._merged_dicts)
    assert merged
    assert port.execute_sql(UNION_TWO_DICTS) == first
    assert port.executor._merged_dicts == merged
