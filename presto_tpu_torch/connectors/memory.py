"""Memory connector: writable in-memory tables.

The port's twin of presto_tpu/connectors/memory.py (reference role:
presto-memory's MemoryMetadata/MemoryPagesStore). Tables live as host numpy
arrays in the HostTable shape scans use, so written tables are scannable at
once, with one sorted StringDict per string column. An optional `fallback`
connector serves the names not written here (CTAS from tpch into memory
through one engine connector).

Ported: create, drop, exists, append_rows (python rows, decimals exact),
register (a host table served as it is), the fallback reads, and the
table versions (every create, append and drop bumps the table's version;
names read through keep the fallback's versions and connector id).
DECIMAL(p>18)
columns hold python-int unscaled values and scan as Decimal128Column limb
lanes (connectors/tpch.HostTable.page). ARRAY/MAP/ROW columns take python
values (lists, dicts, tuples, None), held as numpy lanes
(data/column.NestedArrays) laid out as the JAX package's from_pylist
lays them out, and scan as NestedColumns. A table reads whole or as
split `part` of `num_parts` (row ranges, for lifespan batching). Staged
INSERT moves and the stream watermarks are later slices.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from presto_tpu_torch.connectors.base import SplitSource
from presto_tpu_torch.connectors.tpch import HostTable, _slice_rows
from presto_tpu_torch.data.column import (
    NestedArrays, StringDict, merge_string_dicts, unscale_decimal,
)
from presto_tpu_torch.types import Type


class MemoryConnector(SplitSource):
    NAME = "memory"

    def __init__(self, fallback=None):
        import threading
        self.fallback = fallback
        self.tables: Dict[str, HostTable] = {}
        self._write_lock = threading.Lock()

    def connector_id(self, table: str = None) -> str:
        if table is not None and table not in self.tables \
                and self.fallback is not None:
            return self.fallback.connector_id(table)
        return self.NAME

    def table_version(self, table: str) -> int:
        # tables written here version here; names read through keep the
        # fallback's versions
        if table not in self.tables and self.fallback is not None:
            return self.fallback.table_version(table)
        return super().table_version(table)

    # ------------------------------------------------------------- reads
    def schema(self, table: str) -> List[Tuple[str, Type]]:
        t = self.tables.get(table)
        if t is not None:
            return [(c, t.types[c]) for c in t.column_names()]
        if self.fallback is not None:
            return self.fallback.schema(table)
        raise KeyError(f"unknown table {table}")

    def row_count(self, table: str) -> int:
        t = self.tables.get(table)
        if t is not None:
            return t.num_rows
        if self.fallback is not None:
            return self.fallback.row_count(table)
        raise KeyError(f"unknown table {table}")

    def table(self, name: str, part: int = 0, num_parts: int = 1
              ) -> HostTable:
        """The whole table, or split `part` of `num_parts` as a row-range
        slice of it sharing its StringDicts (presto_tpu/connectors/
        memory.py:79)."""
        full = self.tables.get(name)
        if full is None:
            if self.fallback is not None:
                return self.fallback.table(name, part, num_parts)
            raise KeyError(f"unknown table {name}")
        if num_parts == 1:
            return full
        lo, hi = _slice_rows(full.num_rows, part, num_parts)
        arrays = {c: a[lo:hi] for c, a in full.arrays.items()}
        nulls = ({c: m[lo:hi] for c, m in full.nulls.items()}
                 if full.nulls is not None else None)
        return HostTable(name, hi - lo, arrays, full.types, full.dicts,
                         nulls)

    # ------------------------------------------------------------ writes
    def register(self, table: HostTable) -> None:
        """Serve a host table as it is, under its own name (no copy),
        in place of the fallback's table of that name."""
        self.tables[table.name] = table

    def exists(self, name: str) -> bool:
        return name in self.tables

    def create(self, name: str, schema: Sequence[Tuple[str, Type]]):
        if name in self.tables:
            raise ValueError(f"table {name} already exists")
        arrays: Dict[str, np.ndarray] = {}
        dicts: Dict[str, StringDict] = {}
        types = {}
        for c, t in schema:
            types[c] = t
            if t.name in ("array", "map", "row"):
                # numpy row lanes and children; page() builds
                # NestedColumns
                arrays[c] = NestedArrays.from_pylist([], t)
            elif t.is_decimal and t.uses_int128:
                # python-int unscaled values (exact 38-digit range);
                # page() builds Decimal128Column limb lanes
                arrays[c] = np.zeros(0, object)
            elif t.is_string:
                arrays[c] = np.zeros(0, np.int32)
                dicts[c] = StringDict([])
            else:
                arrays[c] = np.zeros(0, t.dtype)
        self.tables[name] = HostTable(name, 0, arrays, types, dicts)
        self.bump_table_version(name)

    def drop(self, name: str, if_exists: bool = False):
        if name not in self.tables and not if_exists:
            raise KeyError(f"unknown table {name}")
        if self.tables.pop(name, None) is not None:
            self.bump_table_version(name)

    def append_rows(self, name: str, rows: List[tuple]) -> int:
        """Append python rows (strings decoded, decimals as python floats
        or Decimals, None for NULL). Reference role:
        ConnectorPageSink.appendPage (MemoryPagesStore.add)."""
        with self._write_lock:
            n = self._append_rows_locked(name, rows)
            if n:
                self.bump_table_version(name)
            return n

    def _append_rows_locked(self, name: str, rows: List[tuple]) -> int:
        t = self.tables[name]
        n_new = len(rows)
        if n_new == 0:
            return 0
        new_arrays: Dict[str, np.ndarray] = {}
        new_dicts: Dict[str, StringDict] = dict(t.dicts)
        new_nulls: Dict[str, np.ndarray] = {}
        for i, c in enumerate(t.column_names()):
            typ = t.types[c]
            vals = [r[i] for r in rows]
            old_null = (t.nulls or {}).get(
                c, np.zeros(t.num_rows, dtype=bool))[:t.num_rows]
            new_nulls[c] = np.concatenate(
                [old_null, np.asarray([v is None for v in vals], bool)])
            if typ.name in ("array", "map", "row"):
                # the new rows laid out on their own, then appended with
                # their starts shifted past the old entries
                new_arrays[c] = t.arrays[c][:t.num_rows].concat(
                    NestedArrays.from_pylist(vals, typ), typ)
                continue
            if typ.is_string:
                # one table-wide sorted dictionary, existing codes remapped
                new_words, new_codes = StringDict.build(
                    ["" if v is None else v for v in vals])
                union, (remap_old, remap_new) = merge_string_dicts(
                    [t.dicts[c], new_words])
                if union.words == t.dicts[c].words:
                    union = t.dicts[c]
                old_codes = t.arrays[c][:t.num_rows]
                old_new = (remap_old[old_codes] if len(remap_old)
                           else old_codes)
                new_arrays[c] = np.concatenate(
                    [old_new, remap_new[new_codes]])
                new_dicts[c] = union
                continue
            filled = [0 if v is None else v for v in vals]
            if typ.is_decimal and typ.uses_int128:
                # python-int unscaled values in an object array: exact for
                # the full 38-digit range
                arr = np.empty(n_new, object)
                arr[:] = [int(unscale_decimal(v, typ.scale)) for v in filled]
            elif typ.is_decimal:
                arr = np.asarray(
                    [unscale_decimal(v, typ.scale) for v in filled],
                    np.int64)
            else:
                arr = np.asarray(filled, dtype=typ.dtype)
            new_arrays[c] = np.concatenate([t.arrays[c][:t.num_rows], arr])
        self.tables[name] = HostTable(name, t.num_rows + n_new, new_arrays,
                                      t.types, new_dicts, new_nulls)
        return n_new
