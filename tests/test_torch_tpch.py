"""All 22 TPC-H queries through the port on the CPU.

At SF 0.01, presto_tpu_torch's LocalEngine(device="cpu") runs every query
and its rows are held against sqlite over the same generated tables
(presto_tpu_torch/testing/sqlite_oracle.py: the dialect bridge of
tests/test_tpch_full.py, floats within 1e-6 relative). q03, q04, q13, q16,
q21 and q22 also run through the JAX package's engine and are compared
with tests/oracle.assert_rows_match(float_tol=1e-6): together they take
every join type TPC-H uses (inner, left, semi, NOT IN and NOT EXISTS
anti, residual filters), both join paths with the fallback between them,
AssignUniqueId and scalar subqueries.
"""

import pytest

from presto_tpu.config import Session as RefSession
from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu_torch.config import Session
from presto_tpu_torch.connectors import TpchConnector
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.testing import sqlite_oracle
from tests import test_tpch_full
from tests.oracle import assert_rows_match
from tests.tpch_queries import QUERIES
from torch_threads import _one_torch_thread  # noqa: F401

SF = 0.01
AGAINST_JAX = (3, 4, 13, 16, 21, 22)


@pytest.fixture(scope="module")
def port():
    return LocalEngine(TpchConnector(SF), device="cpu")


@pytest.fixture(scope="module")
def sqlite_db(port):
    return sqlite_oracle.load_tpch(port.connector)


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_query_matches_sqlite(qnum, port, sqlite_db):
    sqlite_oracle.check_query(port, QUERIES[qnum], sqlite_db, f"q{qnum:02d}")


@pytest.mark.parametrize("qnum", AGAINST_JAX)
def test_tpch_query_matches_jax_engine(qnum, port):
    sql = QUERIES[qnum]
    expected = RefEngine(RefTpch(SF)).execute_sql(sql)
    assert_rows_match(port.execute_sql(sql), expected, float_tol=1e-6,
                      sort="order by" not in sql.lower())


@pytest.mark.parametrize("qnum", [13, 21])
def test_duplicate_build_keys_fall_back_to_the_expansion_join(qnum, port):
    """q13 (LEFT join of customer with orders on custkey) and q21 (the
    lineitem self-joins) have duplicate build keys: the merge join's dup
    count, watched under the negated node id, sends them to hash_join."""
    plan = port.plan_sql(QUERIES[qnum])
    port.executor.execute(plan)
    caps = port.executor._learned[plan]
    assert any(nid < 0 and need > 0 for nid, need in caps.items())


def test_merge_join_disabled_matches_jax_engine(port):
    """merge_join_enabled=false sends q03's inner joins (unique build
    keys) straight to the expansion hash join in both engines: no merge
    join's dup count is watched, and the rows still match."""
    props = {"merge_join_enabled": "false"}
    engine = LocalEngine(port.connector, Session(props), device="cpu")
    sql = QUERIES[3]
    plan = engine.plan_sql(sql)
    got = engine.executor.execute(plan).to_pylist()
    assert not any(nid < 0 for nid in engine.executor._learned[plan])
    expected = RefEngine(RefTpch(SF), RefSession(props)).execute_sql(sql)
    assert_rows_match(got, expected, float_tol=1e-6, sort=False)


def test_sqlite_bridge_is_the_tpch_full_copy():
    for sql in QUERIES.values():
        assert sqlite_oracle.to_sqlite(sql) == test_tpch_full.to_sqlite(sql)
