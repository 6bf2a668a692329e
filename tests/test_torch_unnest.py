"""ARRAY/MAP/ROW columns and UNNEST in the port against the JAX package,
on the CPU.

- (a) The engine queries of tests/test_unnest_nested.py (:137-191) over
  the same `docs` table, built through each engine's MemoryConnector:
  rows equal the JAX engine's and the flattened sqlite oracle's (that
  file's `oracle_db`).
- (b) ops/unnest.unnest_page against presto_tpu/ops/unnest.unnest_page
  on the same pages (the JAX page's lanes handed to the port as numpy),
  exactly on the rows and the true total; kernel K11's plain version
  against the JAX function's parent / within / eidx / entry_ok on live
  slots.
- (c) NestedColumn: the pages of python values equal the JAX package's
  from_pylist lanes, and the column rides through filters, ORDER BY and
  a verbatim SELECT.
- (d) An UNNEST whose mean fan-out (32) is 8x the capacity hint: the
  first run overflows, the rerun at the learned capacity gives the rows
  of the JAX engine and of numpy.
- (e) The four nested-orders queries of chip_smoke.py's phase 4d on a
  nested TPC-H SF 0.01 orders table (connectors/tpch.nested_orders),
  against the JAX engine over the same python values and against the
  flat queries (numpy for the count query).

Rows compare exactly: integer sums, whole-number float sums, strings and
positions have one right answer.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors import MemoryConnector as RefMemory
from presto_tpu.data import column as RC
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu.ops import unnest as RU
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
from presto_tpu_torch.connectors.tpch import NESTED_ORDERS_SCHEMA, \
    nested_orders
from presto_tpu_torch.data import column as PC
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.ops import unnest as PU
from chip_smoke import nested_counts
from tests.test_unnest_nested import oracle_db  # noqa: F401 (fixture)
from torch_threads import _one_torch_thread  # noqa: F401

SF = 0.01


def _types(ref_types):
    """The port's types for the JAX package's (same names and shapes)."""
    out = []
    for t in ref_types:
        if t.name == "array":
            out.append(PT.ArrayType(_types([t.element])[0]))
        elif t.name == "map":
            k, v = _types([t.key, t.value])
            out.append(PT.MapType(k, v))
        elif t.name == "row":
            out.append(PT.RowType(t.field_names, _types(t.field_types)))
        else:
            out.append(PT.parse_type(str(t)))
    return out


def _key(v):
    """A row value made comparable with NaN equal to NaN."""
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    if isinstance(v, (list, tuple)):
        return type(v)(_key(x) for x in v)
    if isinstance(v, dict):
        return {k: _key(x) for k, x in v.items()}
    return v


def _same_rows(got, want):
    assert [_key(r) for r in got] == [_key(r) for r in want]


# ---------------------------------------------------------------------------
# (a) the engine queries of tests/test_unnest_nested.py
# ---------------------------------------------------------------------------

DOCS_ROWS = [
    (1, ["red", "blue"], {"a": 1}),
    (2, None, {"b": 2, "c": 3}),
    (3, [], None),
    (4, ["green", "red"], {}),
    (5, ["red"], {"a": 9, "d": 4}),
]

#: (query, the sqlite query over the flattened tables or None)
DOCS_QUERIES = {
    "array": (
        "SELECT id, tag FROM docs CROSS JOIN UNNEST(tags) AS t(tag) "
        "ORDER BY id, tag",
        "SELECT id, tag FROM doc_tags ORDER BY id, tag"),
    "ordinality": (
        "SELECT id, tag, ord FROM docs CROSS JOIN "
        "UNNEST(tags) WITH ORDINALITY AS t(tag, ord) ORDER BY id, ord",
        "SELECT id, tag, ord FROM doc_tags ORDER BY id, ord"),
    "map": (
        "SELECT id, k, v FROM docs CROSS JOIN "
        "UNNEST(scores) AS s(k, v) ORDER BY id, k",
        "SELECT id, k, v FROM doc_scores ORDER BY id, k"),
    "agg": (
        "SELECT tag, count(*) AS c, sum(id) AS s FROM docs "
        "CROSS JOIN UNNEST(tags) AS t(tag) "
        "GROUP BY tag ORDER BY c DESC, tag",
        "SELECT tag, count(*) AS c, sum(id) AS s FROM doc_tags "
        "GROUP BY tag ORDER BY c DESC, tag"),
    "where": (
        "SELECT id, tag FROM docs CROSS JOIN UNNEST(tags) AS t(tag) "
        "WHERE tag = 'red' AND id > 1 ORDER BY id",
        "SELECT id, tag FROM doc_tags WHERE tag = 'red' AND id > 1 "
        "ORDER BY id"),
    "standalone": (
        "SELECT x FROM UNNEST(ARRAY[3, 1, 2]) AS t(x) ORDER BY x", None),
    "verbatim": (
        "SELECT id, tags, scores FROM docs ORDER BY id", None),
}

DOCS_SCHEMA = (("id", "bigint"), ("tags", "array(varchar)"),
               ("scores", "map(varchar, bigint)"))


def _docs(memory_cls, types_mod, rows=DOCS_ROWS):
    mem = memory_cls()
    mem.create("docs", [(c, types_mod.parse_type(t)) for c, t in DOCS_SCHEMA])
    mem.append_rows("docs", rows)
    return mem


@pytest.fixture(scope="module")
def docs_engines():
    return (LocalEngine(_docs(MemoryConnector, PT), device="cpu"),
            RefEngine(_docs(RefMemory, RT)))


@pytest.mark.parametrize("name", sorted(DOCS_QUERIES))
def test_docs_query_matches_jax_and_sqlite(name, docs_engines, oracle_db):
    port, ref = docs_engines
    sql, flat = DOCS_QUERIES[name]
    got = port.execute_sql(sql)
    assert got == ref.execute_sql(sql)
    if flat is not None:
        assert [tuple(r) for r in got] == [
            tuple(r) for r in oracle_db.execute(flat).fetchall()]
    elif name == "standalone":
        assert got == [(1,), (2,), (3,)]
    else:
        assert got[0] == (1, ["red", "blue"], {"a": 1})
        assert got[1][1] is None
        assert got[2] == (3, [], None)


# ---------------------------------------------------------------------------
# (b) unnest_page and K11's plain version against the JAX function
# ---------------------------------------------------------------------------

def _np_form(col):
    """The numpy form (page_from_numpy) of a JAX column."""
    if isinstance(col, RC.NestedColumn):
        return (np.asarray(col.starts), np.asarray(col.lengths),
                np.asarray(col.nulls),
                tuple(_np_form(c) for c in col.children))
    v, n = col.to_numpy()
    return (v, n, None if col.dictionary is None
            else list(col.dictionary.words))


def _port_page(ref_page, ref_types):
    return PC.page_from_numpy(
        [_np_form(c) for c in ref_page.columns], _types(ref_types),
        ref_page.names, capacity=ref_page.capacity, device="cpu",
        num_rows=int(ref_page.num_rows))


def _rand_values(rng, kind, n):
    if kind == "bigint":
        return [int(v) for v in rng.integers(-1000, 1000, n)]
    if kind == "double":
        v = rng.normal(size=n)
        v[rng.random(n) < 0.2] = np.nan
        return [float(x) for x in v]
    return [str(w) for w in rng.choice(["ash", "birch", "cedar", "", "x y"],
                                       n)]


def _rand_arrays(rng, kind, n, max_len, null_share=0.15):
    out = []
    for _ in range(n):
        if rng.random() < null_share:
            out.append(None)
            continue
        vals = _rand_values(rng, kind, int(rng.integers(0, max_len + 1)))
        if rng.random() < 0.1 and vals:
            vals[0] = None                     # a NULL element
        out.append(vals)
    return out


def _rand_maps(rng, n, max_len):
    out = []
    for _ in range(n):
        if rng.random() < 0.15:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len + 1))
        keys = rng.choice(["a", "b", "c", "d", "e", "f", "g"], k,
                          replace=False)
        out.append({str(key): int(v) for key, v in
                    zip(keys, rng.integers(0, 99, k))})
    return out


#: name -> (channel types, with ordinality, rows, num_rows cut, out_cap)
UNNEST_CASES = {
    "array_bigint": (("array(bigint)",), False, 300, None, None),
    "array_double_nan": (("array(double)",), False, 300, None, None),
    "array_varchar": (("array(varchar)",), True, 300, None, None),
    "map_varchar_bigint": (("map(varchar, bigint)",), False, 300, None,
                           None),
    "rows_past_num_rows": (("array(bigint)",), True, 300, 170, None),
    "two_channels_unequal": (("array(bigint)", "array(varchar)"), True,
                             300, None, None),
    "array_and_map": (("array(double)", "map(varchar, bigint)"), False,
                      200, None, None),
    "out_cap_below_total": (("array(bigint)", "array(varchar)"), True,
                            300, None, 256),
}


def _unnest_inputs(name):
    chans, ordinality, n, cut, out_cap = UNNEST_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    data = {"id": list(range(n)),
            "tag": [str(s) for s in rng.choice(["p", "q", None], n)]}
    types = {"id": RT.BIGINT, "tag": RT.VARCHAR}
    for i, t in enumerate(chans):
        rt = RT.parse_type(t)
        types[f"c{i}"] = rt
        if rt.name == "map":
            data[f"c{i}"] = _rand_maps(rng, n, 6)
        else:
            data[f"c{i}"] = _rand_arrays(rng, t[6:-1], n, 7)
    data["tag"] = [None if s == "None" else s for s in data["tag"]]
    ref = RC.Page.from_pydict(data, types)
    if cut is not None:
        ref = RC.Page(ref.columns, jnp.asarray(cut, jnp.int32), ref.names)
    ref_types = list(types.values())
    unnest_fields = tuple(range(2, 2 + len(chans)))
    if out_cap is None:
        out_cap = RC.bucket_capacity(ref.capacity * 8)
    names = tuple(f"o{i}" for i in range(16))
    return ref, ref_types, unnest_fields, ordinality, out_cap, names


@pytest.mark.parametrize("name", sorted(UNNEST_CASES))
def test_unnest_page_matches_jax(name):
    ref, ref_types, fields, ordinality, out_cap, names = \
        _unnest_inputs(name)
    port = _port_page(ref, ref_types)
    rout, rtotal = RU.unnest_page(ref, (0, 1) + fields, fields, out_cap,
                                  ordinality, names)
    pout, ptotal = PU.unnest_page(port, (0, 1) + fields, fields, out_cap,
                                  ordinality, names)
    assert int(ptotal) == int(rtotal) and ptotal.dtype == torch.int64
    n = min(int(rtotal), out_cap)
    assert int(pout.num_rows) == n and pout.capacity == out_cap
    want = RC.Page(rout.columns, jnp.asarray(n, jnp.int32), rout.names)
    got = pout.to_pylist()
    _same_rows(got, want.to_pylist())
    if name == "out_cap_below_total":
        assert int(ptotal) > out_cap
    else:
        assert len(got) == int(ptotal) > 0


def _jax_layout(ref, fields, out_cap):
    """The JAX function's per-slot lanes (presto_tpu/ops/unnest.py:38-63,
    the same jnp arithmetic)."""
    cap = ref.capacity
    valid = ref.row_valid()
    nested = [ref.columns[f] for f in fields]
    rowlen = jnp.zeros(cap, jnp.int32)
    for nc in nested:
        rowlen = jnp.maximum(rowlen, jnp.where(nc.nulls | ~valid, 0,
                                               nc.lengths))
    cum = jnp.cumsum(rowlen)
    total = cum[-1]
    j = jnp.arange(out_cap, dtype=jnp.int32)
    parent = jnp.searchsorted(cum, j, side="right").astype(jnp.int32)
    parent_c = jnp.clip(parent, 0, cap - 1)
    prev = jnp.where(parent_c > 0, jnp.take(cum, parent_c - 1, mode="clip"),
                     0)
    within = j - prev
    out_valid = j < total
    eidx, ok = [], []
    for nc in nested:
        ln = jnp.take(nc.lengths, parent_c, mode="clip")
        null_row = jnp.take(nc.nulls, parent_c, mode="clip")
        ok.append(np.asarray(out_valid & (within < ln) & ~null_row))
        eidx.append(np.asarray(jnp.take(nc.starts, parent_c, mode="clip")
                               + within))
    return (int(total), np.asarray(parent_c), np.asarray(within),
            np.asarray(out_valid), eidx, ok)


@pytest.mark.parametrize("name", ["two_channels_unequal", "array_and_map",
                                  "rows_past_num_rows",
                                  "out_cap_below_total"])
def test_unnest_expand_plain_matches_jax_layout(name):
    ref, ref_types, fields, ordinality, out_cap, _ = _unnest_inputs(name)
    port = _port_page(ref, ref_types)
    nested = [port.columns[f] for f in fields]
    lanes = ([c.starts for c in nested], [c.lengths for c in nested],
             [c.nulls for c in nested], port.num_rows, out_cap)
    rtotal, rparent, rwithin, rvalid, reidx, rok = _jax_layout(
        ref, fields, out_cap)
    # the position within the row is read as the ordinality less one
    parent, out_valid, eidx, ok, ordv, total = PU.unnest_expand(*lanes, True)
    assert int(total) == rtotal
    live = rvalid
    assert np.array_equal(out_valid.numpy(), rvalid)
    assert np.array_equal(parent.numpy()[live], rparent[live])
    assert np.array_equal(ordv.numpy()[live] - 1, rwithin[live])
    for c in range(len(fields)):
        assert np.array_equal(eidx[c].numpy()[live], reidx[c][live])
        assert np.array_equal(ok[c].numpy(), rok[c])
    # dead slots hold 0 and False, the ordinality the BIGINT sentinel
    dead = ~live
    assert not parent.numpy()[dead].any() and not eidx.numpy()[:, dead].any()
    assert (ordv.numpy()[dead] == PT.BIGINT.null_sentinel()).all()
    # the case's own ordinality flag changes only the ordinality lane
    other = PU.unnest_expand(*lanes, ordinality)
    assert (other[4] is None) != ordinality
    for a, b in zip(other[:4] + other[5:], (parent, out_valid, eidx, ok,
                                             total)):
        assert torch.equal(a, b)


def _long_row_page(n=400, long_len=5000):
    """Two ARRAY(BIGINT) channels over rows that are mostly NULL (60%) or
    empty (35%), with one row of `long_len` elements in the first."""
    rng = np.random.default_rng(71)
    chans = []
    for _ in range(2):
        rows = []
        for u in rng.random(n):
            rows.append(None if u < 0.6 else [] if u < 0.95 else
                        [int(v) for v in rng.integers(0, 99,
                                                      rng.integers(1, 4))])
        chans.append(rows)
    chans[0][n // 3] = [int(v) for v in rng.integers(-50, 50, long_len)]
    types = {"id": RT.BIGINT, "xs": RT.parse_type("array(bigint)"),
             "ys": RT.parse_type("array(bigint)")}
    ref = RC.Page.from_pydict({"id": list(range(n)), "xs": chans[0],
                               "ys": chans[1]}, types)
    return ref, list(types.values())


@pytest.mark.parametrize("out_cap", [8192, 4096])
def test_unnest_page_with_one_long_row_matches_jax(out_cap):
    """One row of 5,000 elements among empty and NULL rows, at a capacity
    above and below the total, against the JAX function: rows, total and
    every lane of the layout."""
    ref, ref_types = _long_row_page()
    port = _port_page(ref, ref_types)
    names = ("id", "x", "y", "n")
    rout, rtotal = RU.unnest_page(ref, (0,), (1, 2), out_cap, True, names)
    pout, ptotal = PU.unnest_page(port, (0,), (1, 2), out_cap, True, names)
    assert int(ptotal) == int(rtotal) > 5000
    n = min(int(rtotal), out_cap)
    want = RC.Page(rout.columns, jnp.asarray(n, jnp.int32), rout.names)
    _same_rows(pout.to_pylist(), want.to_pylist())
    nested = [port.columns[f] for f in (1, 2)]
    parent, out_valid, eidx, ok, ordv, total = PU.unnest_expand(
        [c.starts for c in nested], [c.lengths for c in nested],
        [c.nulls for c in nested], port.num_rows, out_cap, True)
    rtotal, rparent, rwithin, rvalid, reidx, rok = _jax_layout(
        ref, (1, 2), out_cap)
    assert np.array_equal(out_valid.numpy(), rvalid)
    assert np.array_equal(parent.numpy()[rvalid], rparent[rvalid])
    assert np.array_equal(ordv.numpy()[rvalid] - 1, rwithin[rvalid])
    for c in range(2):
        assert np.array_equal(eidx[c].numpy()[rvalid], reidx[c][rvalid])
        assert np.array_equal(ok[c].numpy(), rok[c])


def test_unnest_expand_edges():
    """A page of capacity 0 gives total 0; all-NULL rows give no slots;
    lengths and starts of any size sum in int64; the plain version takes
    nine channels; no channel is an error."""
    z32 = torch.zeros(0, dtype=torch.int32)
    out = PU.unnest_expand([z32], [z32], [torch.zeros(0, dtype=torch.bool)],
                           torch.tensor(0), 256, True)
    assert int(out[-1]) == 0 and not out[1].any()
    ln = torch.tensor([5, 7, 0, 2], dtype=torch.int32)
    nl = torch.tensor([True, True, False, True])
    out = PU.unnest_expand([torch.zeros(4, dtype=torch.int32)], [ln], [nl],
                           torch.tensor(4), 256, False)
    assert int(out[-1]) == 0
    big = torch.full((4,), 2**30, dtype=torch.int32)
    out = PU.unnest_expand([big, big], [big, big],
                           [torch.zeros(4, dtype=torch.bool)] * 2,
                           torch.tensor(4), 16, False)
    assert int(out[-1]) == 2**32
    # the plain version takes nine channels, as the kernel does
    ln9 = [torch.tensor([c, 1, 0, 2], dtype=torch.int32) for c in range(9)]
    out = PU.unnest_expand([torch.zeros(4, dtype=torch.int32)] * 9, ln9,
                           [torch.zeros(4, dtype=torch.bool)] * 9,
                           torch.tensor(4), 16, False)
    assert int(out[-1]) == 8 + 1 + 0 + 2
    with pytest.raises(ValueError):
        PU.unnest_expand([], [], [], torch.tensor(0), 16, False)


# ---------------------------------------------------------------------------
# (c) NestedColumn
# ---------------------------------------------------------------------------

def _lanes(col):
    """Every lane of a column (JAX or port) as numpy, children included,
    and its string dictionaries' words."""
    if hasattr(col, "children"):
        out = [x.numpy() if torch.is_tensor(x) else np.asarray(x)
               for x in (col.starts, col.lengths, col.nulls)]
        for c in col.children:
            out += _lanes(c)
        return out
    v, n = col.to_numpy()
    d = col.dictionary
    return [v, n, None if d is None else list(d.words)]


def _assert_same_lanes(port_col, ref_col):
    got, want = _lanes(port_col), _lanes(ref_col)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or isinstance(w, list):
            assert g == w
        else:
            assert g.dtype == w.dtype
            assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f")


NESTED_TYPES = {
    "array_bigint": ("array(bigint)", [[1, 2], None, [], [None, 5]]),
    "array_varchar": ("array(varchar)", [["x", None], [], None, ["b", "a"]]),
    "map": ("map(varchar, double)", [{"a": 1.5}, None, {}, {"b": -2.0,
                                                            "c": None}]),
    "row": ("row(f1 bigint, f2 varchar)", [(1, "x"), None, (3, None),
                                           (None, "z")]),
    "array_of_array": ("array(array(bigint))", [[[1], [2, 3]], None, [[]],
                                                [None, [4]]]),
}


@pytest.mark.parametrize("name", sorted(NESTED_TYPES))
def test_nested_column_from_pylist_matches_jax(name):
    t, vals = NESTED_TYPES[name]
    ref = RC.NestedColumn.from_pylist(vals, RT.parse_type(t))
    port = PC.NestedColumn.from_pylist(vals, PT.parse_type(t),
                                       device="cpu")
    _assert_same_lanes(port, ref)
    assert [port.value_at(i) for i in range(len(vals))] == \
        [ref.value_at(i) for i in range(len(vals))]
    # the numpy form of the JAX lanes builds the same column
    back = PC.page_from_numpy([_np_form(ref)], [PT.parse_type(t)],
                              capacity=ref.capacity, device="cpu",
                              num_rows=len(vals))
    _assert_same_lanes(back.columns[0], ref)


def test_memory_table_pages_match_jax():
    """append_rows of python values scans as the JAX connector's page."""
    port = _docs(MemoryConnector, PT).table("docs").page(device="cpu")
    ref = _docs(RefMemory, RT).table("docs").page()
    for pc, rc in zip(port.columns, ref.columns):
        _assert_same_lanes(pc, rc)


@pytest.mark.parametrize("name", sorted(NESTED_TYPES))
def test_appended_nested_pages_match_jax(name):
    """append_rows in three batches (new string words in later ones)
    scans as the JAX connector's page, which lays out all the python
    values at once."""
    t, vals = NESTED_TYPES[name]
    batches = [vals[:2], vals[2:], vals[::-1]]
    pages = []
    for memory_cls, types_mod in ((MemoryConnector, PT), (RefMemory, RT)):
        mem = memory_cls()
        mem.create("t", [("id", types_mod.BIGINT),
                         ("x", types_mod.parse_type(t))])
        for b in batches:
            mem.append_rows("t", [(i, v) for i, v in enumerate(b)])
        pages.append(mem.table("t").page(device="cpu")
                     if memory_cls is MemoryConnector
                     else mem.table("t").page())
    port, ref = pages
    _assert_same_lanes(port.columns[1], ref.columns[1])
    assert port.to_pylist() == ref.to_pylist()


def test_nested_arrays_scan_as_python_values():
    """A table holding nested columns as numpy lanes scans as the same
    table written row by row with python values, and appends to it."""
    table = nested_orders(SF)
    mem = MemoryConnector()
    mem.create("o", NESTED_ORDERS_SCHEMA)
    names = table.column_names()
    n = 700
    cols = [table.page(columns=[c], device="cpu").columns[0]
            for c in names]
    rows = [tuple(PC._pyvalue(c, i) for c in cols) for i in range(n)]
    mem.append_rows("o", rows)
    written = mem.table("o").page(device="cpu")
    assert written.to_pylist() == rows
    for wc, c in zip(written.columns, cols):
        if isinstance(c, PC.NestedColumn):
            assert [wc.value_at(i) for i in range(n)] == \
                [c.value_at(i) for i in range(n)]
    mem.register(table)
    mem.append_rows("orders_nested", rows[:3])
    assert mem.table("orders_nested").page(device="cpu").to_pylist()[-3:] \
        == rows[:3]


NESTED_CARRY_QUERIES = [
    "SELECT id, tags FROM docs WHERE id > 2 ORDER BY id DESC",
    "SELECT id, scores, tags FROM docs WHERE id <> 4 ORDER BY id",
    "SELECT tags, id FROM docs ORDER BY id DESC LIMIT 3",
    "SELECT id, scores FROM docs WHERE id IN (1, 3, 5) ORDER BY id",
]


@pytest.mark.parametrize("sql", NESTED_CARRY_QUERIES)
def test_nested_columns_through_filter_and_order_by(sql, docs_engines):
    port, ref = docs_engines
    got = port.execute_sql(sql)
    assert got == ref.execute_sql(sql) and got


def test_compact_and_gather_keep_nested_columns():
    t = RT.parse_type("array(bigint)")
    vals = [[1], [2, 2], None, [4, 4, 4], []]
    ref = RC.Page.from_pydict({"id": [1, 2, 3, 4, 5], "a": vals},
                              {"id": RT.BIGINT, "a": t})
    port = _port_page(ref, [RT.BIGINT, t])
    keep = np.array([True, False, True, True, False]
                    + [False] * (ref.capacity - 5))
    got = PC.compact(port, torch.from_numpy(keep))
    want = RC.compact(ref, jnp.asarray(keep))
    assert got.to_pylist() == want.to_pylist() == [
        (1, [1]), (3, None), (4, [4, 4, 4])]
    perm = torch.tensor([2, 0, 1])
    gathered = PC.gather_page(got, perm, num_rows=torch.tensor(3))
    assert gathered.to_pylist() == [(4, [4, 4, 4]), (1, [1]), (3, None)]


# ---------------------------------------------------------------------------
# (d) overflow and rerun
# ---------------------------------------------------------------------------

def test_unnest_overflow_reruns_at_a_learned_capacity():
    rng = np.random.default_rng(32)
    rows = [(i, [int(v) for v in rng.integers(-50, 50,
                                              int(rng.integers(16, 49)))])
            for i in range(600)]
    schema = (("id", "bigint"), ("xs", "array(bigint)"))
    port_mem, ref_mem = MemoryConnector(), RefMemory()
    for mem, types_mod in ((port_mem, PT), (ref_mem, RT)):
        mem.create("w", [(c, types_mod.parse_type(t)) for c, t in schema])
        mem.append_rows("w", rows)
    port = LocalEngine(port_mem, device="cpu")
    sql = ("SELECT id, x, n FROM w CROSS JOIN UNNEST(xs) WITH ORDINALITY "
           "AS t(x, n) ORDER BY id, n")
    got = port.execute_sql(sql)
    want = [(i, x, k + 1) for i, xs in rows for k, x in enumerate(xs)]
    assert got == want
    assert len(want) / len(rows) > 30
    plan = port.plan_sql(sql)
    learned = port.executor._learned[plan]
    # the hint is 4 rows per row (a 1024-row page: capacity 4096); the
    # rerun learned the bucket of the true total
    assert max(learned.values()) == PC.bucket_capacity(len(want)) > 4096
    assert got == RefEngine(ref_mem).execute_sql(sql)
    agg = "SELECT count(*), sum(x) FROM w CROSS JOIN UNNEST(xs) AS t(x)"
    assert port.execute_sql(agg) == [(len(want), sum(r[1] for r in want))]


# ---------------------------------------------------------------------------
# (e) the nested TPC-H orders table
# ---------------------------------------------------------------------------

#: the queries of chip_smoke.py's phase 4d and their flat twins (None: the
#: numpy count in the test)
NESTED_ORDERS_QUERIES = {
    "n1": (
        "SELECT o_orderpriority, count(*), sum(pk) FROM orders_nested "
        "CROSS JOIN UNNEST(l_partkeys) AS t(pk) GROUP BY 1 ORDER BY 1",
        "SELECT o_orderpriority, count(*), sum(l_partkey) FROM orders "
        "JOIN lineitem ON o_orderkey = l_orderkey GROUP BY 1 ORDER BY 1"),
    "n2": (
        "SELECT ln, count(*), sum(q) FROM orders_nested "
        "CROSS JOIN UNNEST(l_qty) AS t(ln, q) GROUP BY ln ORDER BY ln",
        "SELECT l_linenumber, count(*), sum(l_quantity) FROM lineitem "
        "GROUP BY 1 ORDER BY 1"),
    "n3": (
        "SELECT p_brand, count(*), sum(pk) FROM orders_nested "
        "CROSS JOIN UNNEST(l_partkeys, l_shipmodes) WITH ORDINALITY "
        "AS t(pk, mode, n) JOIN part ON p_partkey = pk "
        "WHERE mode = 'AIR' AND n <= 3 GROUP BY p_brand ORDER BY p_brand",
        "SELECT p_brand, count(*), sum(l_partkey) FROM orders "
        "JOIN lineitem ON o_orderkey = l_orderkey "
        "JOIN part ON p_partkey = l_partkey "
        "WHERE l_shipmode = 'AIR' AND l_linenumber <= 3 "
        "GROUP BY p_brand ORDER BY p_brand"),
    "n4": (
        "SELECT count(*), count(pk), count(r) FROM orders_nested "
        "CROSS JOIN UNNEST(l_partkeys, l_returned) AS t(pk, r)", None),
}


@pytest.fixture(scope="module")
def nested_engines():
    from presto_tpu.connectors import TpchConnector as RefTpch
    table = nested_orders(SF)
    port_mem = MemoryConnector(fallback=TpchConnector(SF))
    port_mem.register(table)
    ref_mem = RefMemory(fallback=RefTpch(SF))
    ref_mem.create("orders_nested", [
        (c, RT.parse_type(str(t))) for c, t in NESTED_ORDERS_SCHEMA])
    cols = [table.page(columns=[c], device="cpu").columns[0]
            for c in table.column_names()]
    n = table.num_rows
    ref_mem.append_rows("orders_nested", [
        tuple(PC._pyvalue(c, i) for c in cols) for i in range(n)])
    return table, LocalEngine(port_mem, device="cpu"), RefEngine(ref_mem)


@pytest.mark.parametrize("name", sorted(NESTED_ORDERS_QUERIES))
def test_nested_orders_query_matches_jax_and_flat(name, nested_engines):
    table, port, ref = nested_engines
    sql, flat = NESTED_ORDERS_QUERIES[name]
    got = port.execute_sql(sql)
    assert got, name
    assert got == ref.execute_sql(sql)
    want = port.execute_sql(flat) if flat else nested_counts(table)
    assert got == want
