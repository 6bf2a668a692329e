"""The aggregate layout of presto_tpu/plan/fragment.py.

Only `_UNSPLITTABLE` (:41) and `_partial_agg_layout` (:44), which
lifespan-batched execution (exec/lifespan.py) uses to split the root
aggregation into PARTIAL and FINAL steps. AddExchanges and the
PlanFragmenter come with the multi-device slice of the port.
"""

from __future__ import annotations

from typing import List

from presto_tpu_torch.plan.nodes import AggregationNode
from presto_tpu_torch.types import BIGINT, DOUBLE

# Aggregates whose state has no fixed-width column form (sketches): they
# are not split into partial and final steps. DECIMAL(38) sum128/avg128
# split: their partial state is a Decimal128Column that the final step
# merges with sum128_merge/avg128_merge.
_UNSPLITTABLE = {"approx_distinct", "approx_percentile"}


def _partial_agg_layout(node: AggregationNode):
    """(partial_specs, final_specs, partial_names, partial_types)."""
    from presto_tpu_torch.parallel.dist import split_agg_specs

    k = len(node.group_fields)
    partial, final = split_agg_specs(node.aggs, k)
    names: List[str] = [node.source.output_names[f]
                        for f in node.group_fields]
    types = [node.source.output_types[f] for f in node.group_fields]
    for i, a in enumerate(partial):
        if a.kind == "avg_partial":
            names += [f"_p{i}_sum", f"_p{i}_cnt"]
            types += [DOUBLE, BIGINT]
        elif a.kind in ("count", "count_star"):
            names.append(f"_p{i}")
            types.append(BIGINT)
        else:
            names.append(f"_p{i}")
            types.append(a.output_type)
    return partial, final, tuple(names), tuple(types)
