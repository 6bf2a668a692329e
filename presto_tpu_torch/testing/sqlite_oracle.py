"""A sqlite oracle for TPC-H: the engine-independent answer checker.

The generated TPC-H tables are loaded into an in-memory sqlite database
straight from the connector's numpy arrays (the card's machine has no
pandas), each query is rewritten into sqlite's dialect, and the engine's
rows are held against sqlite's, sorted, with floats within 1e-6 relative.

`to_sqlite` is a copy of the dialect bridge of tests/test_tpch_full.py
(the port may import nothing of the JAX package's tests at run time);
tests/test_torch_tpch.py holds the two equal on every TPC-H query.
"""

from __future__ import annotations

import datetime
import re
import sqlite3
from decimal import Decimal
from typing import List, Sequence

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")
FLOAT_TOL = 1e-6
_EPOCH = datetime.date(1970, 1, 1)


def _iso(days: int) -> str:
    return (_EPOCH + datetime.timedelta(days=int(days))).isoformat()


def _shift(d: datetime.date, n: int, unit: str) -> datetime.date:
    if unit == "day":
        return d + datetime.timedelta(days=n)
    months = n if unit == "month" else 12 * n
    total = d.year * 12 + (d.month - 1) + months
    y, m = divmod(total, 12)
    return datetime.date(y, m + 1, d.day)


def to_sqlite(sql: str) -> str:
    """Rewrite a TPC-H query into sqlite's dialect: date literals and
    date arithmetic folded to ISO strings, extract() as strftime,
    substring as substr, stddev_samp as its sums formula, constant
    decimal arithmetic folded exactly."""
    def fold(m):
        d = datetime.date.fromisoformat(m.group(1))
        sign = -1 if m.group(2) == "-" else 1
        return "'%s'" % _shift(d, sign * int(m.group(3)), m.group(4))
    sql = re.sub(r"date\s+'(\d{4}-\d\d-\d\d)'\s*([-+])\s*interval\s+"
                 r"'(\d+)'\s+(day|month|year)", fold, sql)
    sql = re.sub(r"date\s+'(\d{4}-\d\d-\d\d)'", r"'\1'", sql)
    sql = re.sub(r"([a-zA-Z_][\w.]*)\s*([-+])\s*interval\s+'(\d+)'\s+day",
                 lambda m: "date(%s, '%s%s days')" % (
                     m.group(1), m.group(2), m.group(3)), sql)
    sql = re.sub(r"extract\s*\(\s*(year|month|day)\s+from\s+([a-z0-9_.]+)"
                 r"\s*\)",
                 lambda m: "cast(strftime('%%%s', %s) as integer)" % (
                     {"year": "Y", "month": "m", "day": "d"}[m.group(1)],
                     m.group(2)), sql)
    sql = re.sub(r"\bsubstring\s*\(", "substr(", sql)
    sql = re.sub(
        r"stddev_samp\s*\(\s*([a-z0-9_.]+)\s*\)",
        r"(case when count(\1) > 1 then sqrt((1.0*sum(\1*\1) - "
        r"1.0*sum(\1)*sum(\1)/count(\1)) / (count(\1) - 1)) end)", sql)

    def fold_arith(m):
        a, op, b = Decimal(m.group(1)), m.group(2), Decimal(m.group(3))
        r = a + b if op == "+" else a - b
        return format(r, "f")
    prev = None
    while prev != sql:
        prev = sql
        sql = re.sub(r"(\d+\.\d+)\s*([-+])\s*(\d+\.?\d*)", fold_arith, sql)
    return sql


def load_tpch(connector, tables: Sequence[str] = TABLES
              ) -> sqlite3.Connection:
    """An in-memory sqlite database holding the connector's generated
    tables: strings decoded from their dictionaries, dates as ISO
    strings, NULLs where the table has them. Every key column (`*key`)
    is indexed: sqlite runs the correlated subqueries of q19-q21 as
    nested loops, minutes each at SF 0.01 without an index."""
    db = sqlite3.connect(":memory:")
    for name in tables:
        t = connector.table(name)
        cols = []
        for col, typ in t.types.items():
            arr = t.arrays[col][:t.num_rows]
            if col in t.dicts:
                words = t.dicts[col].words
                vals = [words[i] for i in arr.tolist()]
            elif typ.name == "date":
                vals = [_iso(d) for d in arr.tolist()]
            else:
                vals = arr.tolist()
            mask = t.null_mask(col)
            if mask is not None:
                vals = [None if m else v for v, m in zip(vals, mask)]
            cols.append(vals)
        names = list(t.types)
        db.execute(f"create table {name} ({', '.join(names)})")
        db.executemany(
            f"insert into {name} values ({', '.join('?' * len(names))})",
            zip(*cols))
        for col in names:
            if col.endswith("key"):
                db.execute(f"create index {col}_idx on {name} ({col})")
    db.execute("analyze")
    db.commit()
    return db


def _row_key(row):
    return tuple((v is None, v) for v in row)


def check_query(engine, sql: str, db: sqlite3.Connection,
                what: str = "query") -> List[tuple]:
    """Run `sql` on `engine` and on sqlite; raise AssertionError unless
    the rows agree (`compare_rows`). Returns the engine's rows."""
    rows = engine.execute_sql(sql)
    compare_rows(rows, engine.plan_sql(sql).output_types,
                 db.execute(to_sqlite(sql)).fetchall(), what)
    return rows


def compare_rows(rows: Sequence[tuple], types, expected: Sequence[tuple],
                 what: str = "query") -> None:
    """Raise AssertionError unless the engine's `rows` (of output `types`)
    agree with sqlite's `expected` rows: sorted, engine dates decoded to
    ISO strings, floats within FLOAT_TOL relative."""
    got = [tuple(_iso(v) if t.name == "date" and v is not None else v
                 for v, t in zip(row, types)) for row in rows]
    got_s = sorted(got, key=_row_key)
    exp_s = sorted(expected, key=_row_key)
    if len(got_s) != len(exp_s):
        raise AssertionError(
            f"{what}: {len(got_s)} rows != {len(exp_s)}\n"
            f"got[:3]={got_s[:3]}\nexp[:3]={exp_s[:3]}")
    for i, (g, e) in enumerate(zip(got_s, exp_s)):
        if len(g) != len(e):
            raise AssertionError(f"{what} row {i}: arity")
        for j, (x, y) in enumerate(zip(g, e)):
            if x is None or y is None:
                ok = x is None and y is None
            elif isinstance(x, float) or isinstance(y, float):
                ok = abs(float(x) - float(y)) <= FLOAT_TOL * max(
                    abs(float(y)), 1.0)
            else:
                ok = x == y
            if not ok:
                raise AssertionError(
                    f"{what} row {i} col {j}: {x!r} != {y!r}")
