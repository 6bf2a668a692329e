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

Memory-governed execution (`presto_tpu/exec/engine.py:89-182`): with a
`memory_pool` (exec/memory.MemoryPool), a query's plan footprint is
reserved under its query id as it runs; a query over the pool's budget
(ExceededMemoryLimitError) is retried under the pool's headroom by
`exec/lifespan.execute_bounded`, in lifespans that double until the
footprint fits (`last_memory_fallback_batches`), and a join-rooted plan
that does not batch goes through the Grace spill join
(`exec/spill_join.execute_spill_join`, `last_spill_join_stats`); with a
`cluster_memory` (ClusterMemoryManager) the kill sweep runs while the
query's reservations are live, and a killed query raises. The
`lifespan_batches` session property streams the driving scan in that
many lifespans (`last_lifespan_stats`).

Left out for now (they do not change the rows of a query): tracing, plugin
access checks, history-based statistics. EXPLAIN ANALYZE and materialized
views are later slices.
"""

from __future__ import annotations

from typing import List, Tuple

from presto_tpu_torch.data.column import resolve_device
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.plan.nodes import PlanNode, explain
from presto_tpu_torch.sql.analyzer import Planner
from presto_tpu_torch.sql.parser import parse_sql


class LocalEngine:
    _qid = 0

    def __init__(self, connector, session=None, device=None,
                 memory_pool=None, cluster_memory=None):
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
        # memory-management hierarchy (exec/memory.py): reservations per
        # query, the batched and spilled fallbacks, cluster kill checks
        self.memory_pool = memory_pool
        self.cluster_memory = cluster_memory
        self.executor.memory_pool = memory_pool
        self._plans = {}
        self.last_join_reorders = 0
        self.last_memory_fallback_batches = 0
        # stats of the Grace spill join of the last query that took it
        self.last_spill_join_stats = None
        # {"batches", "skipped", ...} of the last lifespan-batched query
        self.last_lifespan_stats = None

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
        LocalEngine._qid += 1
        qid = f"local_{LocalEngine._qid}"
        if self.memory_pool is None:
            return self._execute_sql_inner(sql)
        return self._execute_under_pool(sql, qid)

    def _execute_under_pool(self, sql: str, qid: str) -> List[tuple]:
        """Memory-governed execution (presto_tpu/exec/engine.py:89-142):
        an admission failure retries lifespan-batched under the pool's
        headroom (partials leave the device between lifespans), a
        join-rooted plan through the Grace spill join, before the error
        surfaces; a cluster-level kill beats everything."""
        from presto_tpu_torch.exec.memory import ExceededMemoryLimitError
        if self.cluster_memory is not None:
            self.cluster_memory.check_killed(qid)
        self.executor.pool_query_id = qid
        try:
            try:
                out = self._execute_sql_inner(sql)
            except ExceededMemoryLimitError:
                if self.cluster_memory is not None:
                    self.cluster_memory.check_killed(qid)
                from presto_tpu_torch.exec.executor import \
                    MemoryLimitExceeded
                from presto_tpu_torch.exec.lifespan import execute_bounded
                plan = self.plan_sql(sql)
                # the aborted attempt's pages are gone: release its
                # reservations BEFORE sizing the batched retry
                self.memory_pool.free(qid)
                headroom = max(self.memory_pool.budget
                               - self.memory_pool.reserved, 1)
                try:
                    page, batches = execute_bounded(
                        self.connector, plan, headroom,
                        session=self.session, device=self.device)
                    self.last_memory_fallback_batches = batches
                except MemoryLimitExceeded as mle:
                    # join-rooted plans do not batch: partition both
                    # sides through the spiller instead
                    from presto_tpu_torch.exec.spill_join import (
                        SpillJoinUnsupported, execute_spill_join)
                    try:
                        page, sj_stats = execute_spill_join(
                            self.connector, plan, headroom,
                            session=self.session, device=self.device)
                    except SpillJoinUnsupported:
                        raise mle
                    self.last_spill_join_stats = sj_stats
                out = page.to_pylist()
            if self.cluster_memory is not None:
                # the kill sweep runs while this query's reservations are
                # live: if it is the biggest over-budget query, the kill
                # lands on it
                self.cluster_memory.maybe_kill()
                self.cluster_memory.check_killed(qid)
            return out
        finally:
            self.memory_pool.free(qid)

    def _execute_sql_inner(self, sql: str) -> List[tuple]:
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
        plan = self.plan_sql(sql)
        n = self.session["lifespan_batches"]
        if n and n > 1:
            from presto_tpu_torch.exec.lifespan import execute_batched
            self.last_lifespan_stats = {}
            page = execute_batched(
                self.connector, plan, n,
                self.session["query_max_memory_per_node"],
                session=self.session, stats=self.last_lifespan_stats,
                device=self.device)
        else:
            page = self.executor.execute(plan)
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
