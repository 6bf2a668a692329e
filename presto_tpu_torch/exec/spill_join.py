"""Grace-style spillable hash join: both sides partitioned through
FileSpiller when the build side does not fit the memory budget.

The port's twin of presto_tpu/exec/spill_join.py (reference roles:
HashBuilderOperator's revocable build memory spilling through
GenericPartitioningSpiller, and LookupJoinOperator's spilled probe
passes). The spill format is the SerializedPage + LZ4 frame of
exec/spill.FileSpiller.

Shape handled: a plan whose root path is Output -> [Sort|TopN|Limit|
Project|Filter]* -> Join(INNER) where each join side is a Filter/Project
chain over ONE table scan. Both sides stream in row-range lifespans;
every chunk is hash-partitioned on the join keys and spilled, then the
partitions join one pair at a time: peak device memory is one lifespan
chunk, or one partition pair and its join output, never a whole build
side. String join keys are refused (dictionary codes do not compare
across sides), as is a residual filter or any other shape:
`SpillJoinUnsupported`, and the caller surfaces the memory error it
already had.

On the card each chunk is hashed by K4 (`hash_columns`) and each
partition pair joined by K5 and K6 (`hash_join`). As in the JAX module,
each chunk's hashes come to the host and every partition is compacted
from it (K2, `n_parts` launches a chunk).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.data.column import (
    Column, Page, bucket_capacity, compact,
)
from presto_tpu_torch.exec.executor import _row_bytes
from presto_tpu_torch.exec.spill import FileSpiller
from presto_tpu_torch.exec.split_executor import SplitExecutor
from presto_tpu_torch.plan.nodes import (
    FilterNode, JoinNode, JoinType, LimitNode, OutputNode, PlanNode,
    ProjectNode, SortNode, TableScanNode, TopNNode,
)


class SpillJoinUnsupported(Exception):
    """The plan does not have the partitionable join shape: the caller
    should surface its original memory error instead."""


def _root_join(plan: PlanNode):
    """(above_chain, join) for Output -> rowwise* -> Join(INNER), else
    None."""
    above: List[PlanNode] = []
    node = plan
    while isinstance(node, (OutputNode, SortNode, TopNNode, LimitNode,
                            ProjectNode, FilterNode)):
        above.append(node)
        node = node.source
    if isinstance(node, JoinNode) and node.join_type == JoinType.INNER \
            and node.probe_keys and not node.emit_flag:
        return above, node
    return None


def _single_table(n: PlanNode) -> Optional[str]:
    """The table name when `n` is a Filter/Project chain over one scan:
    the shape whose row-range splits partition its output exactly."""
    if isinstance(n, TableScanNode):
        return n.table
    if isinstance(n, (FilterNode, ProjectNode)):
        return _single_table(n.source)
    return None


def _batches_for(connector, table: str, types, limit: int) -> int:
    """Lifespans needed so one chunk's footprint stays well under the
    budget (a quarter of it, at most 64 lifespans)."""
    est = max(connector.table(table).num_rows, 1) * _row_bytes(types)
    nb = 1
    while est / nb > max(limit, 1) / 4 and nb < 64:
        nb *= 2
    return nb


def _partition_and_spill(ex, subtree: PlanNode, table: str, nb: int,
                         key_fields, n_parts: int, spiller: FileSpiller,
                         parts: Dict[int, list]) -> None:
    """Stream `subtree` in `nb` lifespans of `table`; hash-partition
    every chunk on `key_fields` and spill each non-empty partition."""
    from presto_tpu_torch.ops.keys import hash_columns

    for b in range(nb):
        ex.set_splits({table: [(b, nb)]})
        page = ex.execute(subtree)
        if not int(page.num_rows):
            continue
        h = hash_columns([page.columns[f] for f in key_fields])
        h = h.cpu().numpy()
        valid = page.row_valid().cpu().numpy()
        # hashes are masked non-negative int64, so this remainder is
        # exact (the JAX module's `h % np.uint64(n)` promotes to float64,
        # where a 63-bit hash is a multiple of 64: every row lands in
        # partition 0; ROADMAP Queue 3)
        pids = h % n_parts
        for p in range(n_parts):
            keep = valid & (pids == p)
            if not keep.any():
                continue
            part = compact(page, torch.from_numpy(keep).to(page.device))
            if int(part.num_rows):
                parts.setdefault(p, []).append(spiller.spill(part))


def _join_partition(probe: Page, build: Page, join: JoinNode) -> Page:
    """hash_join one partition pair, growing the output capacity on
    overflow (the executor's capacity-retry contract)."""
    from presto_tpu_torch.ops.join import hash_join

    p_rows, b_rows = int(probe.num_rows), int(build.num_rows)
    cap = bucket_capacity(max(p_rows + b_rows, 256))
    while True:
        page, total = hash_join(probe, build, join.probe_keys,
                                join.build_keys, cap, "inner")
        total = int(total)
        if total <= cap:
            return Page(page.columns, page.num_rows, join.output_names)
        cap = bucket_capacity(total)


def _apply_rowwise(above: List[PlanNode], page: Page) -> Page:
    """Interpret the small chain above the join (as
    lifespan.BatchedRunner._finish_above does)."""
    from presto_tpu_torch.expr.compile import compile_expr
    from presto_tpu_torch.ops.sort import limit_page, sort_page, top_n

    for node in reversed(above):
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
        elif isinstance(node, FilterNode):
            c = compile_expr(node.predicate)(page)
            page = compact(page, ~c.nulls & c.values.to(torch.bool))
        else:  # OutputNode
            page = Page(page.columns, page.num_rows, node.output_names)
    return page


def execute_spill_join(connector, plan: PlanNode,
                       memory_limit_bytes: int, session=None,
                       spill_dir: Optional[str] = None, device=None
                       ) -> Tuple[Page, dict]:
    """Execute a join-rooted plan under a memory budget by partitioning
    BOTH sides through the spiller and joining one partition at a time,
    on `device` (None means the card). Returns (page, stats): stats
    records {"partitions", "spilled_bytes", "spill_files",
    "build_batches", "probe_batches"}. Raises SpillJoinUnsupported when
    the plan shape does not partition."""
    from presto_tpu_torch.exec.lifespan import _concat_pages

    hit = _root_join(plan)
    if hit is None:
        raise SpillJoinUnsupported("plan root is not an inner join")
    above, join = hit
    if session is not None and not session["spill_enabled"]:
        raise SpillJoinUnsupported("spill_enabled is off")
    if getattr(join, "filter", None) is not None:
        raise SpillJoinUnsupported("join carries a residual filter")
    for f in join.build_keys:
        if join.build.output_types[f].is_string:
            # dictionary codes are not comparable across sides, so a
            # per-side hash partition would split matching keys apart
            raise SpillJoinUnsupported("string join keys")
    probe_table = _single_table(join.probe)
    build_table = _single_table(join.build)
    if probe_table is None or build_table is None \
            or probe_table == build_table:
        raise SpillJoinUnsupported("join sides are not single-table "
                                   "scan chains")

    ex = SplitExecutor(connector, session=session, device=device)
    # memory is bounded by this chunking, not by the limit that refused
    # the query
    ex.memory_limit_bytes = None
    build_nb = _batches_for(connector, build_table,
                            join.build.output_types, memory_limit_bytes)
    probe_nb = _batches_for(connector, probe_table,
                            join.probe.output_types, memory_limit_bytes)
    # one partition's build must fit the quarter-budget target too
    n_parts = _batches_for(connector, build_table,
                           join.build.output_types, memory_limit_bytes)
    n_parts = min(max(n_parts, 2), 64)

    build_parts: Dict[int, list] = {}
    probe_parts: Dict[int, list] = {}
    out_pages: List[Page] = []
    with FileSpiller(spill_dir, device=ex.device) as spiller:
        _partition_and_spill(ex, join.build, build_table, build_nb,
                             join.build_keys, n_parts, spiller,
                             build_parts)
        _partition_and_spill(ex, join.probe, probe_table, probe_nb,
                             join.probe_keys, n_parts, spiller,
                             probe_parts)
        stats = {"partitions": n_parts,
                 "build_batches": build_nb, "probe_batches": probe_nb,
                 "spilled_bytes": spiller.total_spilled_bytes,
                 "spill_files": len(spiller.handles)}
        for p in range(n_parts):
            # an inner join emits nothing for a partition missing either
            # side
            if p not in build_parts or p not in probe_parts:
                continue
            build_page = _concat_pages(build_parts[p], spiller,
                                       device=ex.device)
            probe_page = _concat_pages(probe_parts[p], spiller,
                                       device=ex.device)
            joined = _join_partition(probe_page, build_page, join)
            if int(joined.num_rows):
                out_pages.append(joined)
        if not out_pages:
            # an empty join result still needs a page of the join's
            # types
            cols = tuple(
                Column.from_numpy(np.zeros(0, dtype=t.dtype), t,
                                  capacity=256, device=ex.device)
                for t in join.output_types)
            merged = Page.from_columns(cols, 0, join.output_names,
                                       device=ex.device)
        else:
            merged = out_pages[0] if len(out_pages) == 1 \
                else _concat_pages(out_pages, device=ex.device)
            merged = Page(merged.columns, merged.num_rows,
                          join.output_names)
    return _apply_rowwise(above, merged), stats
