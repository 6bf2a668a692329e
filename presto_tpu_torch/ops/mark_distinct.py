"""Mark-distinct: flag the first occurrence of each key combination.

The port's twin of presto_tpu/ops/mark_distinct.py (`mark_distinct`
:25). Reference: operator/MarkDistinctOperator.java; it plans MIXED
plain/DISTINCT aggregates (count(x), count(DISTINCT y) in one SELECT):
the distinct aggregate becomes a plain aggregate masked by the marker.

The rows' permutation by (validity, key nulls, key values) comes from
`lex_perm` (composed stable `torch.sort`s), the first-occurrence flags
from one pass over the keys in that order (`key_change_flags`, kernel K8,
csrc/keys.cu), and the page is gathered by the permutation, so the rows
come out in the JAX function's order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from presto_tpu_torch.data.column import Column, Page, gather_page
from presto_tpu_torch.ops.keys import FIRST_FLAGS, group_values, \
    key_change_flags, lex_perm
from presto_tpu_torch.types import BOOLEAN


def mark_distinct(page: Page, key_fields: Sequence[int],
                  marker_name: str = "_distinct") -> Page:
    """Page -> same rows (reordered) + trailing BOOLEAN marker column,
    True on the first row of each (key...) combination. Padding rows are
    ordered last and never marked. NULL keys form their own group (SQL
    DISTINCT treats NULLs as equal)."""
    lanes = [(~page.row_valid()).to(torch.int8)]
    keys = []
    for f in key_fields:
        c = page.columns[f]
        lanes += [c.nulls.to(torch.int8), group_values(c)]
        # as in the JAX function, the null flags and the values are
        # compared as two separate lanes
        keys += [(None, [c.nulls]), (None, [c.values])]
    perm = lex_perm(lanes)
    first, _ = key_change_flags(perm, keys, page.num_rows, 0, FIRST_FLAGS)
    out = gather_page(page, perm)
    marker = Column(first, torch.zeros_like(first), BOOLEAN, None)
    return Page(out.columns + (marker,), page.num_rows,
                page.names + (marker_name,))
