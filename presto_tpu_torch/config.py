"""Session properties the port reads.

A subset of presto_tpu/config.py: the same Property registry and Session
class, with only the knobs that the port's engine consumes so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes", "on")


def _parse_bytes(s: str) -> int:
    s = s.strip().upper()
    for suffix, mult in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10),
                         ("B", 1)):
        if s.endswith(suffix):
            return int(float(s[:-len(suffix)]) * mult)
    return int(s)


@dataclasses.dataclass(frozen=True)
class Property:
    name: str
    description: str
    parse: Callable[[str], Any]
    default: Any


PROPERTIES = [
    Property("query_max_memory_per_node",
             "Plan-footprint limit per query; exceeding it raises "
             "MemoryLimitExceeded (or triggers lifespan batching)",
             _parse_bytes, None),
    Property("lifespan_batches",
             "Row-range lifespans to stream the driving scan in "
             "(0 = single shot)", int, 0),
    Property("streaming_scan_rows",
             "Bound the rows a driving leaf scan materializes at once: "
             "each lifespan streams through the partial plan in scan "
             "runs of at most this many rows (0 = whole-split "
             "materialization)", int, 0),
    Property("group_count_hint",
             "Default aggregation output-capacity hint when the planner "
             "has no estimate", int, 65536),
    Property("direct_agg_max_bins",
             "Max mixed-radix bins for the small-domain direct aggregation "
             "kernel", int, 64),
    Property("cte_materialization_enabled",
             "Execute WITH subqueries referenced more than once into "
             "temp tables (not in the port yet: enabling it raises)",
             _parse_bool, False),
    Property("join_reordering_enabled",
             "Commute inner equi-joins so the smaller estimated side "
             "becomes the hash build (plan/iterative.ReorderJoins)",
             _parse_bool, True),
    Property("merge_join_enabled",
             "Run inner/left/full equi-joins as the unique-build merge "
             "join first; a duplicate build key falls back to the "
             "expansion hash join", _parse_bool, True),
    Property("spill_enabled",
             "Offload accumulated lifespan partials out of device memory: "
             "host RAM by default, disk when spill_path is set",
             _parse_bool, True),
    Property("spill_path",
             "Directory for spill files (empty = host-RAM offload only)",
             str.strip, ""),
    Property("dynamic_filtering_enabled",
             "Prune driving-scan lifespans whose join-key range cannot "
             "match the build side", _parse_bool, True),
    Property("query_max_execution_time",
             "Wall-clock budget per query in seconds (0 = unlimited); "
             "exceeded -> the query FAILS", float, 0.0),
]

_BY_NAME = {p.name: p for p in PROPERTIES}


class Session:
    """One query session: defaults overridden by string-typed properties
    (the wire form). Unknown properties are rejected."""

    def __init__(self, properties: Optional[Dict[str, str]] = None,
                 user: str = "user", catalog: str = "tpch",
                 schema: str = "default"):
        self.user = user
        self.catalog = catalog
        self.schema = schema
        self.values: Dict[str, Any] = {
            p.name: p.default for p in PROPERTIES}
        for name, raw in (properties or {}).items():
            prop = _BY_NAME.get(name)
            if prop is None:
                raise KeyError(f"unknown session property {name!r}")
            self.values[name] = prop.parse(raw)

    def __getitem__(self, name: str):
        return self.values[name]

    def get(self, name: str, default=None):
        return self.values.get(name, default)
