"""The PARTIAL/FINAL aggregate split of presto_tpu/parallel/dist.py.

This file holds only a copy of `split_agg_specs` (:39), which the
single-device bounded path uses (plan/fragment.py `_partial_agg_layout`,
exec/lifespan.py). The rest of the JAX module, the mesh compositions
`dist_aggregate_local` (:89), `dist_hash_join_local` (:137) and
`broadcast_hash_join_local` (:203), comes with the multi-device slice of
the port.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from presto_tpu_torch.ops.aggregate import AggSpec
from presto_tpu_torch.types import BIGINT, DOUBLE


def split_agg_specs(aggs: Sequence[AggSpec], n_group: int
                    ) -> Tuple[List[AggSpec], List[AggSpec]]:
    """Rewrite SINGLE-step aggregate specs into (partial, final) pairs.

    The partial's output page is [group keys..., state columns...]; final
    specs index into it. avg carries (sum, count) state, count finalizes
    as sum; DECIMAL(38) sum128/avg128 carry limb-lane states that the
    final step merges (sum128_merge/avg128_merge)."""
    partial: List[AggSpec] = []
    final: List[AggSpec] = []
    pos = n_group
    for a in aggs:
        if a.kind == "avg":
            partial.append(AggSpec("avg_partial", a.field, DOUBLE,
                                   mask_field=a.mask_field))
            final.append(AggSpec("avg_final", pos, a.output_type,
                                 field2=pos + 1))
            pos += 2
        elif a.kind in ("count", "count_star"):
            partial.append(AggSpec(a.kind, a.field, BIGINT,
                                   mask_field=a.mask_field))
            final.append(AggSpec("sum", pos, a.output_type))
            pos += 1
        elif a.kind == "sum128":
            # DECIMAL(38) limb lanes: partial = Decimal128 sum state,
            # final sums the limbs independently (sum128_merge)
            partial.append(AggSpec("sum128", a.field, a.output_type,
                                   mask_field=a.mask_field))
            final.append(AggSpec("sum128_merge", pos, a.output_type))
            pos += 1
        elif a.kind == "avg128":
            # exact decimal avg: (limb-lane sum, count) partial state
            partial.append(AggSpec("sum128", a.field, a.output_type,
                                   mask_field=a.mask_field))
            partial.append(AggSpec("count", a.field, BIGINT,
                                   mask_field=a.mask_field))
            final.append(AggSpec("avg128_merge", pos, a.output_type,
                                 field2=pos + 1))
            pos += 2
        elif a.kind in ("sum", "min", "max", "bool_or", "bool_and"):
            partial.append(AggSpec(a.kind, a.field, a.output_type,
                                   mask_field=a.mask_field))
            final.append(AggSpec(a.kind, pos, a.output_type))
            pos += 1
        else:
            raise NotImplementedError(f"distributed aggregate {a.kind}")
    return partial, final
