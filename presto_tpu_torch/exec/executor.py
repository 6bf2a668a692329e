"""Plan executor: evaluate a plan tree eagerly with torch on one device.

The port's twin of presto_tpu/exec/executor.py. The JAX executor lowers a
whole plan into one jit-compiled XLA program (`_lower`, :759); here each
node is evaluated eagerly in the same order and with the same operators:

- TableScan reads the connector's cached device page;
- Filter compacts (data/column.compact, kernel K2);
- Project rewrites columns;
- Aggregation fuses the Filter/Project chain below it into a row mask and
  calls ops/aggregate.grouped_aggregate (kernels K1, or K2 + K3);
- Join runs ops/join.merge_join for unique build keys and semi/anti joins,
  and falls back to the expansion ops/join.hash_join where the build side
  has duplicate keys (kernels K4, K5, K6 and K2);
- AssignUniqueId appends a row id;
- GroupId replicates its source once per grouping set, set-major, with
  the keys outside each set nulled, and appends the set id;
- MarkDistinct appends a first-occurrence flag (ops/mark_distinct.py,
  kernel K8);
- UnionAll concatenates its branches, remapping string codes into a
  merged dictionary where the branches' dictionaries differ, and compacts
  (K2); the merged dictionary and its remap tables are kept per tuple of
  input dictionaries, so a warm run does no host merge;
- Window appends one column per window function (ops/window.py, kernels
  K7, K8 and K9);
- Sort / TopN / Limit / Output as in ops/sort.py.

Scalar subqueries (uncorrelated) are executed first and replaced by
literals (`_resolve_subqueries`, as the JAX executor does).

Capacities follow the JAX package: an aggregation's output capacity is a
bucket of its group-count hint and an expansion join's a bucket of its
probe capacity times its fan-out hint; the true counts, the merge joins'
duplicate counts and the checked-arithmetic error lane are read in ONE
host sync at the end of the plan, and an overflow (or a duplicate build
key under a merge join, watched under the negated node id) re-runs the
plan at larger learned capacities (kept per plan for the executor's
lifetime). Other node types (unnest, exchanges and remote sources,
table writers) raise NotImplementedError: later slices of the port. So
do the three join cases the JAX executor does not implement either (a
residual filter on a FULL join, a FULL join and a LEFT join with a
residual filter whose build keys repeat).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from presto_tpu_torch.data.column import (
    Column, Page, bucket_capacity, compact, merge_string_dicts,
    resolve_device,
)
from presto_tpu_torch.expr import errors as E
from presto_tpu_torch.expr.compile import compile_expr
from presto_tpu_torch.expr.nodes import Call, Literal, RowExpression, \
    SpecialForm
from presto_tpu_torch.ops.aggregate import grouped_aggregate
from presto_tpu_torch.ops.join import hash_join, merge_join
from presto_tpu_torch.ops.mark_distinct import mark_distinct
from presto_tpu_torch.ops.sort import limit_page, sort_page, top_n
from presto_tpu_torch.ops.window import window_page
from presto_tpu_torch.plan.nodes import (
    AggregationNode, AssignUniqueIdNode, FilterNode, GroupIdNode, JoinNode,
    JoinType, LimitNode, MarkDistinctNode, OutputNode, PlanNode,
    ProjectNode, SortNode, TableScanNode, TopNNode, UnionAllNode,
    ValuesNode, WindowNode,
)


class QueryTimeoutError(RuntimeError):
    """query_max_execution_time exceeded (checked between operators)."""


class Executor:
    """Executes a plan against a connector on one device."""

    def __init__(self, connector, session=None, device=None):
        from presto_tpu_torch.config import Session

        self.connector = connector
        self.session = session or Session()
        self.device = resolve_device(device)
        self._learned: Dict[PlanNode, Dict[int, int]] = {}
        self._deadline = None
        # UnionAll: tuple of branch dictionaries -> (merged dictionary,
        # per branch its code remap on the device, or None)
        self._merged_dicts: Dict[tuple, tuple] = {}

    def execute(self, plan: PlanNode) -> Page:
        budget = self.session["query_max_execution_time"]
        self._deadline = (time.time() + budget) if budget else None
        plan = self._resolve_subqueries(plan)
        caps = self._learned.setdefault(plan, {})
        for _attempt in range(8):
            out, watch, needed, err = self._run(plan, caps)
            # the one host sync of execution: capacity needs + error lane
            counters = torch.stack(
                [n.to(torch.int64).reshape(()) for n in needed]
                + [err]).cpu().tolist()
            grew = False
            for nid, need in zip(watch, counters[:-1]):
                if need > caps[nid]:
                    caps[nid] = bucket_capacity(need)
                    grew = True
            if not grew:
                E.raise_for_mask(counters[-1])
                return out
        raise RuntimeError("capacity retry loop did not converge")

    def _check_deadline(self):
        if self._deadline is not None and time.time() > self._deadline:
            raise QueryTimeoutError(
                f"query exceeded query_max_execution_time "
                f"({self.session['query_max_execution_time']:.0f}s)")

    def _scan_rows(self, node) -> int:
        return self.connector.table(node.table).num_rows

    def _resolve_subqueries(self, plan: PlanNode) -> PlanNode:
        """Pre-execute scalar subqueries (uncorrelated), substituting
        literals (presto_tpu/exec/executor.py:702; reference role:
        EnforceSingleRowOperator). Each one is a host sync, as in the
        JAX executor."""
        from presto_tpu_torch.sql.analyzer import Subquery

        def rewrite_expr(e: RowExpression) -> RowExpression:
            if isinstance(e, Subquery):
                rows = self.execute(e.plan).to_pylist()
                if len(rows) != 1:
                    raise RuntimeError(
                        f"scalar subquery returned {len(rows)} rows")
                v = rows[0][0]
                if e.type.is_decimal and v is not None:
                    v = int(round(v * 10 ** e.type.scale))
                return Literal(v, e.type)
            if isinstance(e, (Call, SpecialForm)):
                return dataclasses.replace(
                    e, args=tuple(rewrite_expr(a) for a in e.args))
            return e

        def has_subquery(e) -> bool:
            if isinstance(e, Subquery):
                return True
            return any(has_subquery(c) for c in e.children())

        def rewrite(node: PlanNode) -> PlanNode:
            kids = tuple(rewrite(c) for c in node.children())
            repl = {}
            if isinstance(node, FilterNode):
                repl = {"source": kids[0]}
                if has_subquery(node.predicate):
                    repl["predicate"] = rewrite_expr(node.predicate)
            elif isinstance(node, ProjectNode):
                repl = {"source": kids[0]}
                if any(has_subquery(e) for e in node.expressions):
                    repl["expressions"] = tuple(
                        rewrite_expr(e) for e in node.expressions)
            elif isinstance(node, JoinNode):
                repl = {"probe": kids[0], "build": kids[1]}
                if node.filter is not None and has_subquery(node.filter):
                    repl["filter"] = rewrite_expr(node.filter)
            elif kids:
                names = [f.name for f in dataclasses.fields(node)]
                if "sources" in names:      # UnionAllNode and friends
                    repl = {"sources": kids}
                elif "source" in names:
                    repl = {"source": kids[0]}
            return dataclasses.replace(node, **repl) if repl else node

        return rewrite(plan)

    # ------------------------------------------------------------------
    def _run(self, plan: PlanNode, caps: Dict[int, int]):
        """Evaluate `plan` once at capacities `caps`. Returns (page,
        watched node ids, their true counts, error mask); node ids are
        pre-order positions, as the JAX executor numbers them."""
        counter = [0]
        memo: Dict[int, Page] = {}
        watch: List[int] = []
        needed: List[torch.Tensor] = []
        dev = self.device

        def run(node: PlanNode) -> Page:
            key = id(node)
            if key not in memo:
                counter[0] += 1
                memo[key] = run_node(node, counter[0])
                self._check_deadline()
            return memo[key]

        def run_node(node: PlanNode, nid: int) -> Page:
            if isinstance(node, TableScanNode):
                cap = caps.get(nid) or bucket_capacity(self._scan_rows(node))
                return self.connector.table(node.table).page(
                    columns=list(node.columns), capacity=cap, device=dev)
            if isinstance(node, ValuesNode):
                n = len(node.rows)
                cols = tuple(
                    Column.from_numpy(np.array([r[i] for r in node.rows]),
                                      t, device=dev)
                    for i, t in enumerate(node.output_types))
                return Page.from_columns(cols, n, (), device=dev)
            if isinstance(node, FilterNode):
                p = run(node.source)
                c = compile_expr(node.predicate)(p)
                return compact(p, ~c.nulls & c.values.to(torch.bool))
            if isinstance(node, ProjectNode):
                p = run(node.source)
                cols = tuple(compile_expr(e)(p) for e in node.expressions)
                return Page(cols, p.num_rows, node.output_names)
            if isinstance(node, AggregationNode):
                return run_aggregation(node, nid)
            if isinstance(node, JoinNode):
                return run_join(node, nid)
            if isinstance(node, AssignUniqueIdNode):
                p = run(node.source)
                ids = torch.arange(p.capacity, dtype=torch.int64,
                                   device=p.device)
                col = Column(ids, ~p.row_valid(), node.output_types[-1],
                             None)
                return Page(p.columns + (col,), p.num_rows,
                            node.output_names)
            if isinstance(node, GroupIdNode):
                return run_group_id(node)
            if isinstance(node, MarkDistinctNode):
                out = mark_distinct(run(node.source), node.key_fields,
                                    node.output_names[-1])
                return Page(out.columns, out.num_rows, node.output_names)
            if isinstance(node, UnionAllNode):
                return run_union(node)
            if isinstance(node, WindowNode):
                out = window_page(run(node.source), node.partition_fields,
                                  node.order_keys, node.specs)
                return Page(out.columns, out.num_rows, node.output_names)
            if isinstance(node, SortNode):
                return sort_page(run(node.source), node.keys)
            if isinstance(node, TopNNode):
                return top_n(run(node.source), node.keys, node.count)
            if isinstance(node, LimitNode):
                return limit_page(run(node.source), node.count)
            if isinstance(node, OutputNode):
                p = run(node.source)
                return Page(p.columns, p.num_rows, node.output_names)
            raise NotImplementedError(
                f"lowering {type(node).__name__}: later slice of the port")

        def run_group_id(node: GroupIdNode) -> Page:
            # presto_tpu/exec/executor.py:1032-1074: set-major layout over
            # the source's row count, set s in rows [s*n, (s+1)*n)
            p = run(node.source)
            nsets = len(node.grouping_sets)
            member = torch.ones((nsets, node.arity - 1), dtype=torch.bool)
            for si, keep in enumerate(node.grouping_sets):
                for c in node.key_fields:
                    member[si, c] = c in keep
            member = member.to(dev)
            n = p.num_rows
            r = torch.arange(nsets * p.capacity, dtype=torch.int64,
                             device=dev)
            n1 = n.clamp(min=1)
            set_id = torch.clamp(r // n1, 0, nsets - 1)
            srci = (r - set_id * n1).clamp(0, p.capacity - 1)
            valid = r < nsets * n
            cols = []
            for ci, c in enumerate(p.columns):
                keep = member[:, ci][set_id] & valid
                sent = torch.tensor(c.type.null_sentinel(),
                                    dtype=c.values.dtype, device=dev)
                cols.append(Column(torch.where(keep, c.values[srci], sent),
                                   torch.where(keep, c.nulls[srci], True),
                                   c.type, c.dictionary))
            gt = node.output_types[-1]
            gid = Column(torch.where(valid, set_id, torch.tensor(
                gt.null_sentinel(), dtype=torch.int64, device=dev)),
                ~valid, gt, None)
            return Page(tuple(cols) + (gid,), nsets * n, node.output_names)

        def merged_dict(dicts: tuple):
            """The merged dictionary of a union's branches and each
            branch's code remap on the device (None: codes kept), built
            once per tuple of branch dictionaries."""
            got = self._merged_dicts.get(dicts)
            if got is None:
                union_d, remaps = merge_string_dicts(dicts)
                got = (union_d, [
                    torch.from_numpy(r).to(dev) if len(r) else None
                    for r in remaps])
                self._merged_dicts[dicts] = got
            return got

        def run_union(node: UnionAllNode) -> Page:
            # presto_tpu/exec/executor.py:1112-1151
            ps = [run(s) for s in node.sources]
            out_cap = sum(p.capacity for p in ps)
            cols = []
            for ci, t in enumerate(node.output_types):
                branch = [p.columns[ci] for p in ps]
                d0 = branch[0].dictionary
                if t.is_string and any(c.dictionary is not d0
                                       for c in branch):
                    d0, remaps = merged_dict(
                        tuple(c.dictionary for c in branch))
                    # codes remapped as the JAX take(mode="clip") does
                    vals = torch.cat([
                        r[c.values.long().clamp(0, r.shape[0] - 1)]
                        if r is not None else c.values
                        for c, r in zip(branch, remaps)])
                else:
                    vals = torch.cat([c.values for c in branch])
                nulls = torch.cat([c.nulls for c in branch])
                cols.append(Column(vals, nulls, t, d0))
            # each branch's valid rows sit at its own capacity offset:
            # declare everything in range, then compact
            keep = torch.cat([p.row_valid() for p in ps])
            out = Page(tuple(cols), torch.tensor(out_cap, dtype=torch.int64,
                                                 device=dev),
                       node.output_names)
            return compact(out, keep)

        def run_aggregation(node: AggregationNode, nid: int) -> Page:
            # Fuse the Filter/Project chain below the aggregation into it:
            # projections are row-wise column rewrites and filters become a
            # row mask consumed by the aggregation, so the pipeline never
            # compacts (the JAX executor's agg_fn, executor.py:857-906).
            steps = []
            source = node.source
            while isinstance(source, (FilterNode, ProjectNode)):
                steps.append(source)
                source = source.source
            steps.reverse()
            p = run(source)
            hint = node.group_count_hint or self.session["group_count_hint"]
            out_cap = caps.get(nid) or min(p.capacity,
                                           bucket_capacity(hint))
            if not node.group_fields:
                out_cap = 256
            caps[nid] = out_cap
            mask = None
            for step in steps:
                if isinstance(step, FilterNode):
                    c = compile_expr(step.predicate)(p)
                    m = ~c.nulls & c.values.to(torch.bool)
                    mask = m if mask is None else (mask & m)
                else:
                    cols = tuple(compile_expr(e)(p)
                                 for e in step.expressions)
                    p = Page(cols, p.num_rows, step.output_names)
            out, true_groups = grouped_aggregate(
                p, node.group_fields, node.aggs, out_cap, row_mask=mask,
                direct_max_bins=self.session["direct_agg_max_bins"])
            watch.append(nid)
            needed.append(true_groups)
            return out

        def keep_true(c: Column) -> torch.Tensor:
            return ~c.nulls & c.values.to(torch.bool)

        def run_join(node: JoinNode, nid: int) -> Page:
            # presto_tpu/exec/executor.py:908-1031
            p = run(node.probe)
            b = run(node.build)
            jt = node.join_type
            if jt in (JoinType.SEMI, JoinType.ANTI, JoinType.ANTI_EXISTS):
                # duplicates cannot change a match flag: no fallback
                out, _dup, _m = merge_join(p, b, node.probe_keys,
                                           node.build_keys, jt.value)
                if node.emit_flag:
                    return Page(out.columns, out.num_rows,
                                node.output_names)
                return compact(Page(out.columns[:-1], out.num_rows,
                                    node.output_names),
                               keep_true(out.columns[-1]))
            # Unique-build merge join first; its duplicate count is
            # watched under the negated node id, and any duplicate live
            # build key re-runs the plan onto the expansion hash join.
            use_merge = (bool(node.probe_keys)
                         and self.session["merge_join_enabled"]
                         and jt in (JoinType.INNER, JoinType.LEFT,
                                    JoinType.FULL)
                         and caps.get(-nid, 0) == 0)
            if use_merge:
                caps[-nid] = 0
                if node.filter is not None and jt == JoinType.LEFT:
                    # a failed residual demotes a match to a null
                    # extension (SQL outer-join ON clause)
                    out, dup, match = merge_join(
                        p, b, node.probe_keys, node.build_keys, "left")
                    watch.append(-nid)
                    needed.append(dup)
                    out = Page(out.columns, out.num_rows,
                               node.output_names)
                    ok = match & keep_true(compile_expr(node.filter)(out))
                    cols = list(out.columns[:len(p.columns)])
                    for bc in out.columns[len(p.columns):]:
                        sent = torch.tensor(bc.type.null_sentinel(),
                                            dtype=bc.values.dtype,
                                            device=dev)
                        cols.append(Column(
                            torch.where(ok, bc.values, sent),
                            torch.where(ok, bc.nulls, True),
                            bc.type, bc.dictionary))
                    return Page(tuple(cols), out.num_rows,
                                node.output_names)
                out, dup, _match = merge_join(
                    p, b, node.probe_keys, node.build_keys, jt.value)
                watch.append(-nid)
                needed.append(dup)
                out = Page(out.columns, out.num_rows, node.output_names)
                if node.filter is not None:
                    if jt == JoinType.FULL:
                        raise NotImplementedError(
                            "residual filter on full outer join")
                    out = compact(out, keep_true(
                        compile_expr(node.filter)(out)))
                return out

            fan = max(node.fanout_hint, 1.0)
            out_cap = caps.get(nid) or bucket_capacity(
                min(int(p.capacity * fan), 2**26))
            caps[nid] = out_cap
            if jt == JoinType.FULL:
                raise NotImplementedError(
                    "full outer join with duplicate build keys (the "
                    "expansion path has no full-outer form yet)")
            out, total = hash_join(p, b, node.probe_keys, node.build_keys,
                                   out_cap, jt.value)
            watch.append(nid)
            needed.append(total)
            out = Page(out.columns, out.num_rows, node.output_names)
            if node.filter is not None:
                c = compile_expr(node.filter)(out)
                if jt == JoinType.LEFT:
                    raise NotImplementedError(
                        "residual ON filter on a LEFT join whose "
                        "build side has duplicate keys (the "
                        "expansion fallback cannot null-extend "
                        "per probe row yet; build-side-only "
                        "conditions are pre-filtered by the "
                        "planner and never reach here)")
                out = compact(out, keep_true(c))
            return out

        try:
            with E.collecting() as coll:
                out = run(plan)
                err = coll.combined(dev)
        finally:
            # the closures above reference each other and `memo`: free the
            # intermediate pages now, not at the next cyclic collection
            memo.clear()
        return out, watch, needed, err
