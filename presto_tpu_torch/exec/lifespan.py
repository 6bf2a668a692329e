"""Lifespan-batched execution: bounded working sets for big scans.

The port's twin of presto_tpu/exec/lifespan.py (reference roles: grouped
execution over bucket lifespans, Lifespan.java and
GroupedExecutionTagger.java, and the split-streaming loop of
SqlTaskExecution.java:509). Instead of putting the whole driving table on
the device, stream K row-range lifespans of it through the plan,
accumulating PARTIAL aggregation states, and finish with one FINAL
aggregation over the concatenated partials (DECIMAL(38) sums merge with
sum128_merge/avg128_merge, ops/aggregate.py). The device holds one
lifespan's pages at a time; the executor's memory accounting
(MemoryLimitExceeded) decides when batching is needed (`execute_bounded`).

Applies to plans whose root path is Output -> [Sort|TopN|Limit|Project|
Filter]* -> Aggregation(single) -> <row-preserving pipeline over the
driving scan>: the shape of every aggregation-rooted TPC-H query. Other
plans run whole.

Partials stay on the device, or with `spill_enabled` (the default) leave
it after their lifespan: to host RAM (`_HostPartial`), or with
`spill_path` to LZ4 spill files (exec/spill.FileSpiller). The JAX
module's mesh branches (a lifespan's partial on a device mesh) come with
the multi-device slice: a `mesh` argument raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.data.column import (
    Column, Decimal128Column, Page, bucket_capacity, merge_string_dicts,
)
from presto_tpu_torch.exec.executor import MemoryLimitExceeded
from presto_tpu_torch.exec.split_executor import SplitExecutor
from presto_tpu_torch.ops.aggregate import grouped_aggregate
from presto_tpu_torch.ops.sort import limit_page, sort_page, top_n
from presto_tpu_torch.plan.nodes import (
    AggregationNode, FilterNode, JoinNode, JoinType, LimitNode, OutputNode,
    PlanNode, ProjectNode, RemoteSourceNode, SortNode, Step, TableScanNode,
    TopNNode,
)


def _root_chain(plan: PlanNode):
    """(above_chain, agg) where above_chain are the row-wise/ordering
    nodes over the root aggregation (Output, Sort, TopN, Limit, the final
    projection, HAVING filters); None if the plan has no such shape."""
    above: List[PlanNode] = []
    node = plan
    while isinstance(node, (OutputNode, SortNode, TopNNode, LimitNode,
                            ProjectNode, FilterNode)):
        above.append(node)
        node = node.source
    if isinstance(node, AggregationNode) and node.step == Step.SINGLE:
        return above, node
    return None


def _driving_scan(connector, plan: PlanNode) -> Optional[str]:
    """The largest table scanned: the one worth streaming."""
    best, best_rows = None, -1

    def walk(n):
        nonlocal best, best_rows
        if isinstance(n, TableScanNode):
            rows = connector.table(n.table).num_rows
            if rows > best_rows:
                best, best_rows = n.table, rows
        for c in n.children():
            if c is not None:
                walk(c)
    walk(plan)
    return best


def _streamable(below_agg: PlanNode, driving: str) -> bool:
    """True iff every occurrence of the driving scan reaches the root
    aggregation only through row-preserving paths: filters, projections
    and the PROBE side of inner/left/semi/anti joins. A driving scan under
    a nested aggregation, a join's build side, a window or a sort would
    make per-batch partials non-additive, so those shapes run whole."""
    return _streamable_from(
        below_agg,
        lambda n: isinstance(n, TableScanNode) and n.table == driving)


def _streamable_from(below_agg: PlanNode, is_driving) -> bool:
    """The additivity check for any streamed input marked by
    `is_driving(node)`."""

    def has_driving(n) -> bool:
        if is_driving(n):
            return True
        return any(c is not None and has_driving(c)
                   for c in n.children())

    def ok(n) -> bool:
        if is_driving(n):
            return True
        if isinstance(n, (TableScanNode, RemoteSourceNode)):
            return True
        if isinstance(n, (FilterNode, ProjectNode)):
            return ok(n.source)
        if isinstance(n, JoinNode):
            if has_driving(n.build):
                return False
            if n.join_type not in (JoinType.INNER, JoinType.LEFT,
                                   JoinType.SEMI, JoinType.ANTI,
                                   JoinType.ANTI_EXISTS):
                return False
            return ok(n.probe)
        # any other node (nested aggregation, window, sort, unique id)
        # between the driving input and the root aggregation
        return not has_driving(n)

    return ok(below_agg)


def _dynamic_filter(connector, ex: SplitExecutor, agg_source: PlanNode,
                    driving: str):
    """Build-side dynamic filter (reference: DynamicFilterSourceOperator):
    execute the topmost non-driving build subtree once, take its join-key
    [min, max], and skip whole lifespans whose driving-scan key slice
    cannot intersect it. Returns (scan column name, lo, hi, build_empty)
    or None when no eligible join exists."""
    from presto_tpu_torch.expr.nodes import InputRef

    def scans_driving(n) -> bool:
        if isinstance(n, TableScanNode):
            return n.table == driving
        return any(c is not None and scans_driving(c)
                   for c in n.children())

    def scan_column(n, channel: int):
        """`channel` of n's output as a raw driving-scan column name,
        through Filter/Project/probe-side join chains."""
        if isinstance(n, TableScanNode):
            return n.columns[channel] if n.table == driving else None
        if isinstance(n, FilterNode):
            return scan_column(n.source, channel)
        if isinstance(n, ProjectNode):
            e = n.expressions[channel]
            if isinstance(e, InputRef):
                return scan_column(n.source, e.field)
            return None
        if isinstance(n, JoinNode):
            if channel < len(n.probe.output_types):
                return scan_column(n.probe, channel)
            return None
        return None

    def find(n):
        if isinstance(n, JoinNode) \
                and n.join_type in (JoinType.INNER, JoinType.SEMI) \
                and len(n.probe_keys) >= 1 \
                and not scans_driving(n.build):
            col = scan_column(n.probe, n.probe_keys[0])
            if col is not None:
                return n, col
        for c in n.children():
            if c is not None and scans_driving(c):
                r = find(c)
                if r is not None:
                    return r
        return None

    hit = find(agg_source)
    if hit is None:
        return None
    join, col = hit
    # string keys: dictionary codes compare only within one dictionary
    if join.build.output_types[join.build_keys[0]].is_string:
        return None
    build_page = ex.execute(join.build)
    n = int(build_page.num_rows)
    if n:
        v, nl = build_page.columns[join.build_keys[0]].to_numpy(n)
        v = v[~nl]
        if len(v):
            return (col, v.min(), v.max(), False)
    return (col, 0, -1, True)


@dataclasses.dataclass
class _HostPartial:
    """A spilled partial in host RAM, as numpy lanes: the device holds
    only the lifespan in flight; accumulated partials wait on the host
    for the final merge."""
    columns: List[tuple]       # (values np, nulls np, Type, StringDict)
    num_rows: int
    names: tuple


def _dec128_host(c: Decimal128Column, n: int):
    """Exact host image of a Decimal128Column's limb lanes. Marker tuple:
    ("dec128", (l3, l2, l1, l0), count or None)."""
    lanes, nl, cnt = c._host()
    return (("dec128", tuple(np.array(x[:n]) for x in lanes),
             None if cnt is None else np.array(cnt[:n])),
            np.array(nl[:n]), c.type, None)


def _host_cols(p: Page) -> List[tuple]:
    n = int(p.num_rows)
    cols = []
    for c in p.columns:
        if isinstance(c, Decimal128Column):
            cols.append(_dec128_host(c, n))
            continue
        v, nl = c.to_numpy(n)
        cols.append((np.array(v), np.array(nl), c.type, c.dictionary))
    return cols


def _spill_to_host(p: Page) -> _HostPartial:
    return _HostPartial(_host_cols(p), int(p.num_rows), p.names)


def _part_cols(p, spiller=None):
    from presto_tpu_torch.exec.spill import SpillHandle
    if isinstance(p, SpillHandle):
        p = spiller.read(p, device="cpu")        # disk -> host page
    if isinstance(p, _HostPartial):
        return p.columns
    return _host_cols(p)


def _concat_pages(pages: List, spiller=None, device=None) -> Page:
    """Concatenation of the valid rows of several partials (device Pages,
    host-RAM _HostPartials or disk SpillHandles) with identical schemas,
    on `device`. Decimal128 limb lanes concatenate exactly. Where the
    partials' string dictionaries differ (a page read back from a spill
    file carries the dictionary of its own words), codes are remapped
    into their merged dictionary."""
    parts = [_part_cols(p, spiller) for p in pages]
    total = sum(int(p.num_rows) for p in pages)
    cap = bucket_capacity(max(total, 1))
    cols = []
    for i, (v0, _n0, t0, d0) in enumerate(parts[0]):
        nulls = np.concatenate([pc[i][1] for pc in parts])
        if isinstance(v0, tuple) and v0 and v0[0] == "dec128":
            def lane(j):
                out = np.zeros(cap, dtype=np.int64)
                out[:total] = np.concatenate([pc[i][0][1][j]
                                              for pc in parts])
                return out
            count = None
            if v0[2] is not None:
                count = np.zeros(cap, dtype=np.int64)
                count[:total] = np.concatenate([pc[i][0][2]
                                                for pc in parts])
            nl = np.ones(cap, dtype=bool)
            nl[:total] = nulls
            cols.append(Decimal128Column.from_numpy_lanes(
                [lane(j) for j in range(4)], nl, t0, count=count,
                device=device))
            continue
        dicts = [pc[i][3] for pc in parts]
        if t0.is_string and any(d is not d0 for d in dicts):
            d0, remaps = merge_string_dicts(dicts)
            vals = np.concatenate([
                remap[pc[i][0]] if len(remap) else pc[i][0]
                for pc, remap in zip(parts, remaps)])
        else:
            vals = np.concatenate([pc[i][0] for pc in parts])
        cols.append(Column.from_numpy(vals, t0, nulls=nulls, dictionary=d0,
                                      capacity=cap, device=device))
    return Page.from_columns(cols, total, pages[0].names, device=device)


class BatchedRunner:
    """Prepared lifespan-batched execution: plan analysis, the partial
    plan and the SplitExecutor are built ONCE; run() executes all
    lifespans and the final merge. Repeat run() calls reuse the
    executor's learned capacities."""

    def __init__(self, connector, plan: PlanNode, num_batches: int,
                 memory_limit_bytes: Optional[int] = None, session=None,
                 mesh=None, device=None):
        from presto_tpu_torch.plan.fragment import (
            _UNSPLITTABLE, _partial_agg_layout,
        )

        if mesh is not None:
            raise NotImplementedError(
                "lifespan batching over a device mesh: later slice of the "
                "port")
        self.connector = connector
        self.num_batches = num_batches
        self.ex = SplitExecutor(connector, session=session, device=device)
        # scalar subqueries run first, outside the limit (the JAX runner
        # resolves them on an executor of its own)
        self.ex.memory_limit_bytes = None
        plan = self.ex._resolve_subqueries(plan)
        self.ex.memory_limit_bytes = memory_limit_bytes
        self.plan = plan
        chain = _root_chain(plan)
        driving = _driving_scan(connector, plan)
        self.batchable = not (
            chain is None or driving is None or num_batches <= 1
            or not _streamable(chain[1].source, driving)
            # sketch aggregates have no column-shaped partial state
            or any(a.kind in _UNSPLITTABLE for a in chain[1].aggs))
        self.driving = driving
        if not self.batchable:
            return
        self.above, self.agg = chain
        partial_specs, final_specs, pnames, ptypes = \
            _partial_agg_layout(self.agg)
        self.final_specs = final_specs
        self.partial_plan = AggregationNode(
            pnames, ptypes, source=self.agg.source,
            group_fields=self.agg.group_fields, aggs=tuple(partial_specs),
            step=Step.PARTIAL, group_count_hint=self.agg.group_count_hint)
        self.dyn = None
        if self.ex.session["dynamic_filtering_enabled"]:
            self.dyn = _dynamic_filter(connector, self.ex,
                                       self.agg.source, driving)
        self.spill = bool(self.ex.session["spill_enabled"])
        # spill_path set -> partials revoke to disk files; empty -> host
        # RAM
        self.spill_dir = self.ex.session["spill_path"] or None
        # streaming scans: bound the rows one leaf scan puts on the
        # device, so a lifespan's working set is the run size
        self.stream_rows = int(self.ex.session["streaming_scan_rows"] or 0)

    def run(self, stats: Optional[dict] = None) -> Page:
        from presto_tpu_torch.expr import errors as E

        if not self.batchable:
            return self.ex.execute(self.plan)
        spiller = None
        if self.spill and self.spill_dir:
            from presto_tpu_torch.exec.spill import FileSpiller
            spiller = FileSpiller(self.spill_dir, device=self.ex.device)
        try:
            merged = self._run_batches(stats, spiller)
        finally:
            # a query failing mid-spill must not leak run files
            if spiller is not None:
                spiller.close()
        k = len(self.agg.group_fields)
        out_cap = bucket_capacity(max(int(merged.num_rows), 256))
        with E.collecting() as coll:
            page, _groups = grouped_aggregate(merged, tuple(range(k)),
                                              tuple(self.final_specs),
                                              out_cap)
            page = self._finish_above(
                Page(page.columns, page.num_rows, self.agg.output_names))
            err = coll.combined(page.device)
        E.raise_for_mask(int(err))
        return page

    def _run_batches(self, stats, spiller) -> Page:
        """Per-lifespan partial aggregation, spilled partials included;
        returns the concatenated partial page on the device."""
        connector, ex = self.connector, self.ex
        driving, num_batches = self.driving, self.num_batches
        skipped = 0
        partials: List = []
        for b in range(num_batches):
            if self.dyn is not None:
                col, lo, hi, empty = self.dyn
                t = connector.table(driving, part=b, num_parts=num_batches)
                if t.num_rows:
                    if empty:
                        skipped += 1
                        continue
                    sv = t.arrays[col][:t.num_rows]
                    if bool(sv.min() > hi or sv.max() < lo):
                        skipped += 1
                        continue
            for p in self._partial_pages(b):
                if self.spill:
                    p = spiller.spill(p) if spiller is not None \
                        else _spill_to_host(p)
                partials.append(p)
        if stats is not None:
            stats.update(batches=num_batches, skipped=skipped)
        if not partials:
            # every lifespan pruned: run one anyway (its join cannot
            # match, so it yields the zero-state partial; a global
            # aggregate still emits its count=0 row)
            ex.set_splits({driving: [(0, num_batches)]})
            partials.append(ex.execute(self.partial_plan))
        if stats is not None and spiller is not None:
            stats.update(spilled_bytes=spiller.total_spilled_bytes,
                         spill_files=len(spiller.handles))
        return _concat_pages(partials, spiller, device=ex.device)

    def _partial_pages(self, b: int):
        """Execute the partial plan over lifespan `b`, yielding its
        output pages: with streaming_scan_rows set, the driving split
        flows through in scan runs of at most that many rows
        (connector.scan_runs); otherwise one whole-split shot."""
        ex = self.ex
        if self.stream_rows > 0 and hasattr(self.connector, "scan_runs"):
            try:
                for run in self.connector.scan_runs(
                        self.driving, self.stream_rows, part=b,
                        num_parts=self.num_batches):
                    ex.set_split_tables({self.driving: run})
                    yield ex.execute(self.partial_plan)
            finally:
                ex.set_split_tables({})
            return
        ex.set_splits({self.driving: [(b, self.num_batches)]})
        yield ex.execute(self.partial_plan)

    def _finish_above(self, page: Page) -> Page:
        """Interpret the small chain above the aggregation."""
        from presto_tpu_torch.data.column import compact
        from presto_tpu_torch.expr.compile import compile_expr

        for node in reversed(self.above):
            if isinstance(node, SortNode):
                page = sort_page(page, node.keys)
            elif isinstance(node, TopNNode):
                page = top_n(page, node.keys, node.count)
            elif isinstance(node, LimitNode):
                page = limit_page(page, node.count)
            elif isinstance(node, ProjectNode):
                cols = tuple(compile_expr(e)(page)
                             for e in node.expressions)
                page = Page(cols, page.num_rows, node.output_names)
            elif isinstance(node, FilterNode):         # HAVING
                c = compile_expr(node.predicate)(page)
                page = compact(page, ~c.nulls & c.values.to(torch.bool))
            else:  # OutputNode
                page = Page(page.columns, page.num_rows, node.output_names)
        return page


def execute_batched(connector, plan: PlanNode, num_batches: int,
                    memory_limit_bytes: Optional[int] = None,
                    session=None, mesh=None, stats: Optional[dict] = None,
                    device=None) -> Page:
    """Execute `plan` streaming the driving scan in `num_batches`
    lifespans on `device` (None means the card). Runs the plan whole where
    its shape does not batch (no root aggregation). `stats` (if given)
    records {"batches", "skipped"} and, with spill files,
    {"spilled_bytes", "spill_files"}."""
    return BatchedRunner(connector, plan, num_batches, memory_limit_bytes,
                         session, mesh=mesh, device=device).run(stats)


def execute_bounded(connector, plan: PlanNode, memory_limit_bytes: int,
                    max_batches: int = 64, session=None,
                    device=None) -> Tuple[Page, int]:
    """Execute under a hard memory limit, doubling the lifespan count
    until the plan footprint fits. Returns (page, batches_used)."""
    chain = _root_chain(plan)
    driving = _driving_scan(connector, plan)
    batchable = (chain is not None and driving is not None
                 and _streamable(chain[1].source, driving))
    batches = 1
    while True:
        try:
            return (execute_batched(connector, plan, batches,
                                    memory_limit_bytes, session=session,
                                    device=device), batches)
        except MemoryLimitExceeded:
            if not batchable or batches >= max_batches:
                raise
            batches *= 2
