"""The 99 TPC-DS queries through the port on the CPU.

- The port's TPC-DS generator (presto_tpu_torch/connectors/tpcds.py, a
  copy of the JAX package's) gives bit-identical tables at SF 0.002: all
  24 tables, their arrays, null masks and dictionary words.
- At SF 0.002 presto_tpu_torch's LocalEngine(device="cpu") runs every
  query of tests/tpcds_queries.py, and its rows are held against sqlite
  over the same generated tables with the comparison of
  tests/test_tpcds.py:run_case (presto_tpu_torch/testing/sqlite_oracle.py
  `check_tpcds_query`: rows sorted with floats rounded, NULL only against
  NULL, floats within 1e-6 relative), with the sqlite spellings of
  SQLITE_OVERRIDES, Q22_SQLITE and Q27_SQLITE.
"""

import numpy as np
import pytest
import torch

from presto_tpu.connectors import TpcdsConnector as RefTpcds
from presto_tpu_torch.connectors import TpcdsConnector
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.testing import sqlite_oracle
from tests import test_tpch_full
from tests.tpcds_queries import (
    Q22_SQLITE, Q27_SQLITE, QUERIES, SQLITE_OVERRIDES,
)

SF = 0.002
SQLITE_SPELLING = {22: Q22_SQLITE, 27: Q27_SQLITE, **SQLITE_OVERRIDES}


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
    return LocalEngine(TpcdsConnector(SF), device="cpu")


@pytest.fixture(scope="module")
def sqlite_db(port):
    return sqlite_oracle.load_tpcds(port.connector)


@pytest.mark.parametrize("table", sqlite_oracle.TPCDS_TABLES)
def test_tpcds_tables_are_bit_identical(table):
    ref = RefTpcds(SF).table(table)
    got = TpcdsConnector(SF).table(table)
    assert got.num_rows == ref.num_rows
    assert list(got.types) == list(ref.types)
    assert [str(t) for t in got.types.values()] == \
        [str(t) for t in ref.types.values()]
    for col in ref.types:
        a, b = got.arrays[col], ref.arrays[col]
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b, err_msg=col)
        ma, mb = got.null_mask(col), ref.null_mask(col)
        assert (ma is None) == (mb is None), col
        if mb is not None:
            np.testing.assert_array_equal(ma, mb, err_msg=col)
    assert set(got.dicts) == set(ref.dicts)
    for col, d in ref.dicts.items():
        assert got.dicts[col].words == d.words, col


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpcds_query_matches_sqlite(qnum, port, sqlite_db):
    sqlite_oracle.check_tpcds_query(port, QUERIES[qnum], sqlite_db,
                                    SQLITE_SPELLING.get(qnum), f"q{qnum}")


def test_wide_decimal_product_beyond_int64_raises(port):
    """bigint * 1.0 is typed DECIMAL(20,1); the port holds it in int64
    until DECIMAL(38) is ported, and a product beyond 64 bits raises
    NotImplementedError instead of wrapping."""
    rows = port.execute_sql(
        "select d_date_sk * 1.0 / 2 from date_dim where d_date_sk = 2415022")
    assert rows == [(2415022 * 1.0 / 2,)]
    with pytest.raises(NotImplementedError, match="beyond 64 bits"):
        port.execute_sql("select (d_date_sk + 922337203685477000) * 1.0 / 2 "
                         "from date_dim where d_date_sk = 2415022")


def test_sqlite_bridge_is_the_tpch_full_copy_on_tpcds():
    for qnum, sql in QUERIES.items():
        for text in (sql, SQLITE_SPELLING.get(qnum)):
            if text is not None:
                assert sqlite_oracle.to_sqlite(text) == \
                    test_tpch_full.to_sqlite(text), qnum
