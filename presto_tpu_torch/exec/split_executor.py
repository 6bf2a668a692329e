"""SplitExecutor: scans read ASSIGNED splits (row ranges), not whole
tables.

The port's twin of presto_tpu/exec/split_executor.py (:25), the building
block of lifespan-batched execution (exec/lifespan.py). A scan of a table
with splits set reads the rows of `connector.table(t, part=p,
num_parts=n)` for each split (p, n); a table bound with
`set_split_tables` (one streaming scan run, `connector.scan_runs`) is
read as it is. Pages pulled from remote tasks (`set_remote_pages`) come
with the worker path of the port, a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from presto_tpu_torch.data.column import (
    Column, Decimal128Column, Page, merge_string_dicts,
)
from presto_tpu_torch.exec.executor import Executor


class SplitExecutor(Executor):
    def __init__(self, connector, session=None, device=None):
        super().__init__(connector, session=session, device=device)
        self.splits: Dict[str, List[Tuple[int, int]]] = {}
        # table -> host table (one streaming scan run); consulted BEFORE
        # the split ranges, so lifespan streaming can feed bounded runs
        # through an unchanged plan
        self.split_tables: Dict[str, object] = {}

    def set_splits(self, by_table: Dict[str, List[Tuple[int, int]]]):
        self.splits = by_table

    def set_split_tables(self, by_table: Dict[str, object]):
        """Bind host tables (streaming scan runs) directly to leaf scans;
        pass {} to fall back to split-range resolution."""
        self.split_tables = by_table

    def set_remote_pages(self, by_node):
        raise NotImplementedError(
            "remote pages: later slice of the port (the worker path)")

    def _scan_rows(self, node) -> int:
        t = self.split_tables.get(node.table)
        if t is not None:
            return max(1, int(t.num_rows))
        parts = self.splits.get(node.table)
        if parts is None:
            return self.connector.table(node.table).num_rows
        return max(1, sum(
            self.connector.table(node.table, part=p, num_parts=n).num_rows
            for p, n in parts))

    def _scan_page(self, node, capacity: int) -> Page:
        t = self.split_tables.get(node.table)
        if t is not None:
            return t.page(columns=list(node.columns), capacity=capacity,
                          device=self.device)
        parts = self.splits.get(node.table)
        if parts is None:
            return super()._scan_page(node, capacity)
        tables = [self.connector.table(node.table, part=p, num_parts=n)
                  for p, n in parts]
        if len(tables) == 1:
            # one split: the slice table uploads its own columns
            return tables[0].page(columns=list(node.columns),
                                  capacity=capacity, device=self.device)
        return self._concat_splits(tables, list(node.columns), capacity)

    def _concat_splits(self, tables, columns, capacity: int) -> Page:
        """Several splits of one table as one page (presto_tpu/exec/
        split_executor.py:80-139): row lanes concatenated on the host,
        string codes remapped into one union dictionary where the splits'
        dictionaries differ."""
        dev = self.device
        n_rows = sum(t.num_rows for t in tables)
        t0 = tables[0]

        def nulls_of(c):
            masks = [t.null_mask(c) for t in tables]
            if all(m is None for m in masks):
                return None
            return np.concatenate(
                [m if m is not None else np.zeros(t.num_rows, bool)
                 for m, t in zip(masks, tables)])

        cols = []
        for c in columns:
            typ = t0.types[c]
            if typ.name in ("array", "map", "row"):
                arr = t0.arrays[c][:t0.num_rows]
                for t in tables[1:]:
                    arr = arr.concat(t.arrays[c][:t.num_rows], typ)
                cols.append(arr.column(typ, capacity=capacity, device=dev))
                continue
            if typ.is_string and any(t.dicts.get(c) is not t0.dicts.get(c)
                                     for t in tables[1:]):
                union, remaps = merge_string_dicts(
                    [t.dicts.get(c) for t in tables])
                arr = np.concatenate([
                    remap[np.asarray(t.arrays[c][:t.num_rows])] if len(remap)
                    else np.asarray(t.arrays[c][:t.num_rows])
                    for t, remap in zip(tables, remaps)])
                cols.append(Column.from_numpy(
                    arr, typ, nulls=nulls_of(c), dictionary=union,
                    capacity=capacity, device=dev))
                continue
            arr = np.concatenate([t.arrays[c][:t.num_rows] for t in tables])
            if getattr(typ, "uses_int128", False):
                cols.append(Decimal128Column.from_unscaled_ints(
                    list(arr), typ, nulls=nulls_of(c), capacity=capacity,
                    device=dev))
                continue
            cols.append(Column.from_numpy(
                arr, typ, nulls=nulls_of(c), dictionary=t0.dicts.get(c),
                capacity=capacity, device=dev))
        return Page.from_columns(cols, n_rows, columns, device=dev)
