"""CTE materialization — WITH subqueries referenced more than once
execute ONCE into a temp table instead of being inlined per reference.

The port's copy of presto_tpu/exec/cte.py (host code over the AST), with
its imports rewritten.

Reference: sql/planner/optimizations/PhysicalCteOptimizer.java:126 (CTEs
written to temp tables and re-scanned, sequenced by
CTEMaterializationTracker). Here the temp store is the writable memory
connector (connectors/memory.py) layered over the engine's catalog; the
rewrite runs on the AST before planning:

  1. count TableRef references to each CTE across the main query and
     every nested subquery that doesn't shadow the name;
  2. for each CTE referenced >= 2 times, execute its query (CTEs may
     reference earlier CTEs — processed in declaration order) and write
     the rows to a unique temp table;
  3. rewrite references to the temp name and drop the CTE binding.

Single-reference CTEs keep the inlining path (no materialization cost),
exactly like the reference's heuristic default."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

from presto_tpu_torch.sql import ast

_ids = itertools.count()


def _count_refs(node, name: str) -> int:
    """TableRef occurrences of `name`, honoring shadowing by nested WITH."""
    if isinstance(node, ast.TableRef):
        return int(node.name == name)
    if isinstance(node, ast.Select):
        if any(n == name for n, _q in node.ctes):
            # Shadowed — but WITH bindings are sequential: definition
            # queries up to AND INCLUDING the shadowing declaration still
            # see the OUTER name (a non-recursive CTE cannot reference
            # itself). Only later definitions and the body see the inner
            # binding.
            n = 0
            for cn, cq in node.ctes:
                n += _count_refs(cq, name)
                if cn == name:
                    break
            return n
        n = 0
        for _cn, cq in node.ctes:
            n += _count_refs(cq, name)
        for f in dataclasses.fields(node):
            if f.name == "ctes":
                continue
            n += _count_refs(getattr(node, f.name), name)
        return n
    if dataclasses.is_dataclass(node):
        return sum(_count_refs(getattr(node, f.name), name)
                   for f in dataclasses.fields(node))
    if isinstance(node, tuple):
        return sum(_count_refs(x, name) for x in node)
    return 0


def _rename_refs(node, old: str, new: str):
    if isinstance(node, ast.TableRef):
        return (dataclasses.replace(node, name=new)
                if node.name == old else node)
    if isinstance(node, ast.Select) and \
            any(n == old for n, _q in node.ctes):
        # Shadowed: rename only inside definition queries up to and
        # including the shadowing declaration (sequential-WITH scoping,
        # mirroring _count_refs); the body keeps the inner binding.
        new_ctes, hit = [], False
        for cn, cq in node.ctes:
            if not hit:
                cq = _rename_refs(cq, old, new)
            new_ctes.append((cn, cq))
            if cn == old:
                hit = True
        return dataclasses.replace(node, ctes=tuple(new_ctes))
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _rename_refs(getattr(node, f.name), old, new)
            for f in dataclasses.fields(node)})
    if isinstance(node, tuple):
        return tuple(_rename_refs(x, old, new) for x in node)
    return node


def materialize_ctes(q: ast.Select, run_select, temp_store
                     ) -> Tuple[ast.Select, list]:
    """Rewrite `q`, executing multiply-referenced CTEs into temp tables.

    run_select(ast.Select) -> (rows, names, types); temp_store is a
    writable connector (create/append_rows/drop). Returns the rewritten
    query and the temp table names created (caller drops them)."""
    if not q.ctes:
        return q, []
    temps = []
    remaining = []
    bindings: Dict[str, str] = {}

    def rebind(sub_q: ast.Select) -> ast.Select:
        for old, new in bindings.items():
            sub_q = _rename_refs(sub_q, old, new)
        return sub_q

    try:
        for name, cq in q.ctes:
            body = dataclasses.replace(q, ctes=())
            later = [c for c in q.ctes if c[0] != name]
            refs = _count_refs(body, name) + sum(
                _count_refs(c[1], name) for c in later)
            if refs < 2:
                remaining.append((name, rebind(cq)))
                continue
            # Prepend the outer still-inlined bindings to the body's OWN
            # nested WITH (inner declarations win on name collision) —
            # overwriting would drop the body's nested CTEs entirely.
            bound = rebind(cq)
            inner_names = {n for n, _q in bound.ctes}
            merged = tuple(c for c in remaining
                           if c[0] not in inner_names) + tuple(bound.ctes)
            rows, names, types = run_select(
                dataclasses.replace(bound, ctes=merged))
            tmp = f"__cte_{next(_ids)}_{name}"
            temp_store.create(tmp, list(zip(names, types)))
            temp_store.append_rows(tmp, rows)
            temps.append(tmp)
            bindings[name] = tmp
    except BaseException:
        # a later CTE failed: don't leak the temps created so far
        for t in temps:
            temp_store.drop(t, if_exists=True)
        raise

    out = dataclasses.replace(q, ctes=())
    for old, new in bindings.items():
        out = _rename_refs(out, old, new)
    return dataclasses.replace(out, ctes=tuple(
        (n, c) for n, c in remaining)), temps
