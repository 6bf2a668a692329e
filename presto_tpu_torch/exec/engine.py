"""LocalEngine — single-process parse -> plan -> execute entry point.

The port's twin of presto_tpu/exec/engine.py (`plan_sql` :54,
`execute_sql` :67) on one torch device. The device defaults to the card:
`LocalEngine(connector)` raises where no CUDA device is present, and runs
on the CPU only when given `device="cpu"`.

Statements other than queries go by their head word, as in the JAX
engine: EXPLAIN returns one VARCHAR row per plan line; CREATE TABLE [AS],
INSERT, DELETE and DROP TABLE write through a writable connector
(connectors/memory.py) and return the count row; with
`cte_materialization_enabled`, CTEs referenced more than once run once
into temp tables (exec/cte.py). Rows go from the device to Python and
back into the host table, as in the JAX engine.

Left out for now (they do not change the rows of a query): tracing, plugin
access checks, the memory pool, history-based statistics. EXPLAIN ANALYZE
and materialized views are later slices.
"""

from __future__ import annotations

from typing import List, Tuple

from presto_tpu_torch.data.column import resolve_device
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.plan.nodes import PlanNode, explain
from presto_tpu_torch.sql.analyzer import Planner
from presto_tpu_torch.sql.parser import parse_sql


class LocalEngine:
    def __init__(self, connector, session=None, device=None):
        from presto_tpu_torch.config import Session

        s = session or Session()
        if s["cte_materialization_enabled"]:
            # temp tables for materialized CTEs live in a memory overlay
            # over the catalog (presto_tpu/exec/engine.py:25-30)
            from presto_tpu_torch.connectors.memory import MemoryConnector
            if not hasattr(connector, "create"):
                connector = MemoryConnector(fallback=connector)
        self.device = resolve_device(device)
        self.connector = connector
        self.planner = Planner(connector)
        self.executor = Executor(connector, session=s, device=self.device)
        self._plans = {}
        self.last_join_reorders = 0

    @property
    def session(self):
        return self.executor.session

    def plan_sql(self, sql: str) -> PlanNode:
        if sql not in self._plans:
            plan = self.planner.plan_query(parse_sql(sql))
            if self.session["join_reordering_enabled"]:
                from presto_tpu_torch.plan.iterative import reorder_joins
                plan, self.last_join_reorders = reorder_joins(
                    plan, self.connector, None)
            self._plans[sql] = plan
        return self._plans[sql]

    def explain_sql(self, sql: str) -> str:
        return explain(self.plan_sql(sql))

    def column_names(self, sql: str) -> Tuple[str, ...]:
        return self.plan_sql(sql).output_names

    def execute_sql(self, sql: str) -> List[tuple]:
        head = sql.lstrip().split(None, 1)[0].lower() if sql.strip() else ""
        if head == "explain":
            # EXPLAIN <query>: one VARCHAR row per plan line
            rest = sql.lstrip()[len("explain"):].lstrip()
            if rest.lower().startswith("analyze"):
                raise NotImplementedError(
                    "EXPLAIN ANALYZE: later slice of the port")
            return [(line,) for line in self.explain_sql(rest).splitlines()]
        if head in ("create", "insert", "drop", "delete", "refresh"):
            return self._execute_statement(sql)
        if self.session["cte_materialization_enabled"]:
            q = parse_sql(sql)
            if q.ctes:
                # only WITH queries take the rewrite
                return self._execute_with_cte_materialization(q)
        page = self.executor.execute(self.plan_sql(sql))
        return page.to_pylist()

    def _execute_with_cte_materialization(self, q) -> List[tuple]:
        """Multiply-referenced CTEs execute once into memory-overlay temp
        tables (exec/cte.py); `q` is the parsed ast.Select. The temp
        tables are dropped whatever happens."""
        from presto_tpu_torch.exec.cte import materialize_ctes

        def run_select(sub_q):
            plan = self.planner.plan_query(sub_q)
            page = self.executor.execute(plan)
            return (page.to_pylist(), list(plan.output_names),
                    list(plan.output_types))

        q, temps = materialize_ctes(q, run_select, self.connector)
        try:
            page = self.executor.execute(self.planner.plan_query(q))
            return page.to_pylist()
        finally:
            for t in temps:
                self.connector.drop(t, if_exists=True)

    # ------------------------------------------------------------ DDL/DML
    def _execute_statement(self, sql: str) -> List[tuple]:
        """CREATE TABLE [AS] / INSERT / DELETE / DROP TABLE against a
        writable connector (presto_tpu/exec/engine.py:232): the inner
        query runs on the device, the write is a host-side sink fed by its
        rows, and the result is the count row."""
        from presto_tpu_torch.data.column import scale_down_decimal
        from presto_tpu_torch.expr.nodes import Literal
        from presto_tpu_torch.sql import ast as A
        from presto_tpu_torch.sql.analyzer import AnalysisError
        from presto_tpu_torch.sql.parser import parse_statement

        stmt = parse_statement(sql)
        conn = self.connector
        if isinstance(stmt, (A.CreateMaterializedView,
                             A.RefreshMaterializedView,
                             A.DropMaterializedView)):
            raise NotImplementedError(
                f"{type(stmt).__name__}: later slice of the port")
        if not hasattr(conn, "create"):
            raise AnalysisError("connector is not writable")
        if isinstance(stmt, A.DropTable):
            conn.drop(stmt.name, if_exists=stmt.if_exists)
            return [(0,)]

        if isinstance(stmt, A.Delete):
            # a row survives iff pred IS NOT TRUE; the surviving rows
            # rewrite the table, and the count row is the deleted rows
            if not conn.exists(stmt.name):
                raise AnalysisError(f"unknown table {stmt.name}")
            total = conn.table(stmt.name).num_rows
            if stmt.where is None:
                kept = []
            else:
                keep_q = A.Select(
                    items=(A.SelectItem(A.Star()),),
                    relations=(A.TableRef(stmt.name),),
                    where=A.BinaryOp("or", A.UnaryOp("not", stmt.where),
                                     A.IsNull(stmt.where)))
                kept = self.executor.execute(
                    self.planner.plan_query(keep_q)).to_pylist()
            schema = conn.schema(stmt.name)
            conn.drop(stmt.name)
            conn.create(stmt.name, schema)
            if kept:
                conn.append_rows(stmt.name, kept)
            return [(total - len(kept),)]

        if isinstance(stmt, A.CreateTable):
            if stmt.if_not_exists and conn.exists(stmt.name):
                return [(0,)]
            from presto_tpu_torch.types import (
                ArrayType, MapType, RowType, parse_type,
            )
            cols = []
            for c, sig in stmt.columns:
                try:
                    t = parse_type(sig)
                except (ValueError, NotImplementedError) as e:
                    raise AnalysisError(f"column {c!r}: {e}") from e
                if isinstance(t, (ArrayType, MapType, RowType)):
                    raise AnalysisError(
                        f"column {c!r}: type {t} is not supported for "
                        "table storage")
                cols.append((c, t))
            conn.create(stmt.name, cols)
            return [(0,)]

        if isinstance(stmt, A.CreateTableAs):
            if stmt.if_not_exists and conn.exists(stmt.name):
                return [(0,)]
            plan = self.planner.plan_query(stmt.query)
            rows = self.executor.execute(plan).to_pylist()
            conn.create(stmt.name, list(zip(plan.output_names,
                                            plan.output_types)))
            return [(conn.append_rows(stmt.name, rows),)]

        if isinstance(stmt, A.Insert):
            names = [c for c, _t in conn.schema(stmt.name)]
            if stmt.query is not None:
                rows = self.executor.execute(
                    self.planner.plan_query(stmt.query)).to_pylist()
            else:
                rows = []
                for r in stmt.rows:
                    vals = []
                    for e in r:
                        lit = self.planner.analyze(e, ())
                        if not isinstance(lit, Literal):
                            raise AnalysisError(
                                "INSERT VALUES must be literals")
                        v = lit.value
                        if v is not None and lit.type.is_decimal:
                            # exact: append_rows unscales the Decimal
                            v = scale_down_decimal(int(v), lit.type.scale)
                        vals.append(v)
                    rows.append(tuple(vals))
            if stmt.columns:
                unknown = [c for c in stmt.columns if c not in names]
                if unknown:
                    raise AnalysisError(
                        f"INSERT columns not in table: {unknown}")
                for r in rows:
                    if len(r) != len(stmt.columns):
                        raise AnalysisError(
                            f"INSERT arity {len(r)} != column list "
                            f"{len(stmt.columns)}")
                pos = {c: i for i, c in enumerate(stmt.columns)}
                rows = [tuple(r[pos[c]] if c in pos else None
                              for c in names) for r in rows]
            else:
                for r in rows:
                    if len(r) != len(names):
                        raise AnalysisError(
                            f"INSERT arity {len(r)} != table {len(names)}")
            return [(conn.append_rows(stmt.name, rows),)]

        raise AnalysisError(f"unsupported statement {type(stmt).__name__}")
