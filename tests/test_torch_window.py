"""The port's window primitives against the JAX package's, on the CPU.

Each test builds one set of numpy inputs from a seed, hands it to the JAX
function (presto_tpu, run eagerly on the CPU as its own tests run it) and
to its counterpart in presto_tpu_torch (whose wrappers take their plain
PyTorch versions on CPU tensors), and compares:

- ops/scan.py cumsum, blocked_cummax, fill_forward, seg_scan and
  fill_backward (kernel K7) at lengths around the JAX `_LANE` of 2048,
  with NaN, +-inf, int32 and int64 extremes and segment starts on block
  edges, and window_bounds (K7's bounds kernel) against the JAX window's
  four fills;
- ops/keys.key_change_flags (kernel K8) against the JAX window's
  `changed` logic (presto_tpu/ops/window.py:171-195) and mark_distinct's
  first flags, with nulls first and last, NaN keys and a padding tail;
- ops/window.window_page (K7, K8, K9) for every window kind and frame
  type, over pages with nulls, ties, descending and nulls-first keys,
  string arguments and a padding tail;
- ops/mark_distinct.mark_distinct (K8).

Tolerance: integers, flags, codes, orders, nulls and dictionaries exact;
float64 min/max/value outputs exact, except that a float64 subnormal in
a window output equals zero: XLA's CPU code flushes the subnormal results
of jnp.minimum/maximum to +-0.0, where the port returns the value
(ROADMAP Queue 3); float64 sums and averages within 1e-9 relative to
max(|x|, 1) (the port's frame sums restart at each partition, the JAX
package's are differences of one global running sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.data import column as RC
from presto_tpu.ops import keys as RK
from presto_tpu.ops import mark_distinct as RM
from presto_tpu.ops import scan as RS
from presto_tpu.ops import window as RW
from presto_tpu_torch import types as PT
from presto_tpu_torch.data import column as PC
from presto_tpu_torch.ops import keys as PK
from presto_tpu_torch.ops import mark_distinct as PM
from presto_tpu_torch.ops import scan as PS
from presto_tpu_torch.ops import window as PW
from torch_threads import _one_torch_thread  # noqa: F401

RTOL = 1e-9
LENGTHS = [1, 2047, 2048, 2049, 10_000]
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


def _exact(p, r, what=""):
    p = np.asarray(p)
    r = np.asarray(r)
    assert p.shape == r.shape, what
    if p.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(p), np.isnan(r), err_msg=what)
        m = ~np.isnan(r)
        np.testing.assert_array_equal(p[m], r[m], err_msg=what)
    else:
        np.testing.assert_array_equal(p, r, err_msg=what)


def _flushed(a):
    """float64 subnormals as 0.0, for the window outputs (see above)."""
    a = np.asarray(a)
    if a.dtype != np.float64:
        return a
    return np.where(np.abs(a) < np.finfo(np.float64).tiny, 0.0, a)


def _close(p, r, what=""):
    p = np.asarray(p, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(p), np.isnan(r), err_msg=what)
    np.testing.assert_array_equal(np.isinf(p), np.isinf(r), err_msg=what)
    m = np.isfinite(r)
    np.testing.assert_array_equal(p[~m & ~np.isnan(r)],
                                  r[~m & ~np.isnan(r)], err_msg=what)
    assert np.all(np.abs(p[m] - r[m]) <= RTOL * np.maximum(np.abs(r[m]),
                                                           1.0)), what


# ---------------------------------------------------------------------------
# the scan primitives (K7)
# ---------------------------------------------------------------------------

def _floats(rng, n):
    v = rng.normal(0.0, 100.0, n)
    special = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e300, -1e300]
    at = rng.integers(0, n, min(n, 12))
    v[at] = rng.choice(special, at.shape[0])
    return v


def _ints(rng, n, dtype):
    info = np.iinfo(dtype)
    v = rng.integers(-1000, 1000, n).astype(dtype)
    at = rng.integers(0, n, min(n, 8))
    v[at] = rng.choice([info.min, info.max, info.min + 1, info.max - 1],
                       at.shape[0]).astype(dtype)
    return v


def _seg_starts(rng, n):
    """Random segment starts plus every block edge of the JAX layout."""
    f = rng.random(n) < 0.01
    for edge in (0, 2047, 2048, 2049, 4095, 4096):
        if edge < n:
            f[edge] = True
    return f


@pytest.mark.parametrize("n", LENGTHS)
def test_cumsum_matches_jax(n):
    rng = np.random.default_rng(n)
    i64 = rng.integers(-2 ** 40, 2 ** 40, n)
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    _exact(PS.cumsum(torch.from_numpy(i64)), RS.cumsum(jnp.asarray(i64)))
    _exact(PS.cumsum(torch.from_numpy(i32)), RS.cumsum(jnp.asarray(i32)))
    f = rng.normal(0, 10, n)
    _close(PS.cumsum(torch.from_numpy(f)), RS.cumsum(jnp.asarray(f)))
    # int64 wraps in both
    w = np.full(n, I64.max // 2 + 7, dtype=np.int64)
    _exact(PS.cumsum(torch.from_numpy(w)), RS.cumsum(jnp.asarray(w)))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_blocked_cummax_matches_jax(n, dtype):
    rng = np.random.default_rng(n + 1)
    v = _ints(rng, n, dtype)
    _exact(PS.blocked_cummax(torch.from_numpy(v)),
           RS.blocked_cummax(jnp.asarray(v)))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_fills_match_jax(n, direction):
    rng = np.random.default_rng(n + 2)
    present = rng.random(n) < 0.05
    if n > 2049:
        present[2047:2050] = [True, False, True]
    vals = _floats(rng, n)
    ivals = _ints(rng, n, np.int32)
    pf = PS.fill_forward if direction == "forward" else PS.fill_backward
    rf = RS.fill_forward if direction == "forward" else RS.fill_backward
    _exact(pf(torch.from_numpy(vals), torch.from_numpy(present)),
           rf(jnp.asarray(vals), jnp.asarray(present)))
    _exact(pf(torch.from_numpy(ivals), torch.from_numpy(present), init=-7),
           rf(jnp.asarray(ivals), jnp.asarray(present), init=-7))
    none = np.zeros(n, bool)
    _exact(pf(torch.from_numpy(vals), torch.from_numpy(none), init=2.5),
           rf(jnp.asarray(vals), jnp.asarray(none), init=2.5))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kind", ["float64", "int64", "int32"])
def test_seg_scan_matches_jax(n, op, kind):
    rng = np.random.default_rng(n + 3)
    if kind == "float64":
        v = _floats(rng, n)
        ident = np.inf if op == "min" else -np.inf
    else:
        dt = np.int64 if kind == "int64" else np.int32
        v = _ints(rng, n, dt)
        info = np.iinfo(dt)
        ident = info.max if op == "min" else info.min
    seg = _seg_starts(rng, n)
    pbin = torch.minimum if op == "min" else torch.maximum
    rbin = jnp.minimum if op == "min" else jnp.maximum
    _exact(PS.seg_scan(torch.from_numpy(v), torch.from_numpy(seg), pbin,
                       ident),
           RS.seg_scan(jnp.asarray(v), jnp.asarray(seg), rbin, ident))
    # the reverse form window_page uses for frames unbounded to the end
    end = np.zeros(n, bool)
    end[:-1] = seg[1:]
    end[-1] = True
    got = PS.segmented_scan(torch.from_numpy(v), op, reverse=True,
                            seg_start=torch.from_numpy(end))
    want = jnp.flip(RS.seg_scan(jnp.flip(jnp.asarray(v)),
                                jnp.flip(jnp.asarray(end)), rbin, ident))
    _exact(got, want)


@pytest.mark.parametrize("n", [1, 2049, 10_000])
def test_segmented_add_restarts_at_segment_starts(n):
    """The sums window_page's frames use: per segment, the running sum."""
    rng = np.random.default_rng(n + 4)
    v = rng.integers(-50, 50, n)
    seg = _seg_starts(rng, n)
    got = PS.segmented_scan(torch.from_numpy(v), "add",
                            seg_start=torch.from_numpy(seg)).numpy()
    want = np.empty(n, np.int64)
    acc = 0
    for i in range(n):
        acc = v[i] if (seg[i] or i == 0) else acc + v[i]
        want[i] = acc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", LENGTHS)
def test_window_bounds_match_jax_fills(n):
    """window_bounds (the plain version of K7's bounds kernel) against the
    JAX window's four fills as presto_tpu/ops/window.py:197-204 composes
    them: the start positions by fill_forward, the end positions (a row
    ends where the next starts, the last row always) by fill_backward.
    Row 0 starts a partition, as every window's does."""
    rng = np.random.default_rng(n + 5)
    part = _seg_starts(rng, n)
    peer = part | (rng.random(n) < 0.2)
    idx = jnp.arange(n)

    def jax_bounds(start):
        start = jnp.asarray(start)
        end = jnp.roll(start, -1).at[-1].set(True)
        return (RS.fill_forward(jnp.where(start, idx, 0), start),
                RW._fill_backward(jnp.where(end, idx, 0), end))

    got = PS.window_bounds(torch.from_numpy(part), torch.from_numpy(peer))
    (ps, pe), (qs, qe) = jax_bounds(part), jax_bounds(peer)
    for g, w, what in zip(got, (ps, pe, qs, qe), ("ps", "pe", "qs", "qe")):
        _exact(g.numpy(), w, what)


# ---------------------------------------------------------------------------
# pages shared by both packages
# ---------------------------------------------------------------------------

CAP = 2048
N = 1500


def _pages(cols, n=N, cap=CAP):
    rcols = []
    for tname, vals, nulls, words in cols:
        d = RC.StringDict(words) if words is not None else None
        rcols.append(RC.Column.from_numpy(vals, RT.parse_type(tname),
                                          nulls=nulls, dictionary=d,
                                          capacity=cap))
    ref = RC.Page.from_columns(rcols, n)
    port = PC.page_from_numpy(
        [(vals, nulls, words) for _t, vals, nulls, words in cols],
        [PT.parse_type(t) for t, _v, _n, _w in cols], capacity=cap,
        device="cpu", num_rows=n)
    return ref, port


WORDS = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu"]
TYPES = ["bigint", "double", "double", "bigint", "varchar", "integer",
         "boolean", "decimal(12,2)", "bigint"]


def _window_cols(rng, n=N):
    """0 part bigint (NULLs); 1 order double (ties, NaN, +-inf, +-0.0,
    +-1e-310, NULLs);
    2 arg double (NULLs); 3 arg bigint (NULLs); 4 varchar (NULLs); 5
    integer with ties; 6 boolean; 7 decimal(12,2); 8 bigint near
    INT64_MIN."""
    o = rng.integers(0, 40, n).astype(np.float64) / 4
    o[rng.integers(0, n, 12)] = rng.choice([np.nan, np.inf, -np.inf], 12)
    # zeros of both signs and subnormals: one key value, peers in page order
    o[rng.integers(0, n, 12)] = rng.choice([0.0, -0.0, 1e-310, -1e-310], 12)
    near_min = I64.min + 1 + rng.integers(0, 5, n)
    return [
        ("bigint", rng.integers(0, 6, n), rng.random(n) < 0.05, None),
        ("double", o, rng.random(n) < 0.05, None),
        ("double", rng.normal(0, 100, n), rng.random(n) < 0.1, None),
        ("bigint", rng.integers(-500, 500, n), rng.random(n) < 0.1, None),
        ("varchar", rng.integers(0, 7, n).astype(np.int32),
         rng.random(n) < 0.1, WORDS),
        ("integer", rng.integers(0, 9, n).astype(np.int32),
         np.zeros(n, bool), None),
        ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.05, None),
        ("decimal(12,2)", rng.integers(-100_000, 100_000, n),
         rng.random(n) < 0.05, None),
        ("bigint", near_min, rng.random(n) < 0.02, None),
    ]


# ---------------------------------------------------------------------------
# key_change_flags (K8)
# ---------------------------------------------------------------------------

def _jax_changed(lanes_sorted, keys, cap):
    """The JAX window's `changed` (presto_tpu/ops/window.py:171-186) over
    sorted (null-flag lane, value lane) pairs."""
    ch = jnp.zeros((cap,), bool).at[0].set(True)
    for n_l, v_l in keys:
        n = lanes_sorted[n_l]
        v = lanes_sorted[v_l]
        same_v = RK.values_equal(v, jnp.roll(v, 1))
        same = (same_v & ~n & ~jnp.roll(n, 1)) | (n & jnp.roll(n, 1))
        ch = ch | ~same
    return ch.at[0].set(True)


@pytest.mark.parametrize("nulls_first", [False, True])
def test_key_change_flags_match_jax_changed(nulls_first):
    rng = np.random.default_rng(7 + nulls_first)
    ref, port = _pages(_window_cols(rng))
    pkey, okey = 0, 1
    valid = np.arange(CAP) < N
    lanes = [(~valid).astype(np.int8)]
    for f in (pkey, okey):
        c = ref.columns[f]
        nl = np.asarray(c.nulls)
        lanes.append(np.where(nl, 0 if nulls_first else 1,
                              1 if nulls_first else 0).astype(np.int8))
        lanes.append(np.asarray(c.values))
    perm = RK.lex_perm([jnp.asarray(x) for x in lanes])
    perm_t = torch.from_numpy(np.asarray(perm).astype(np.int64))
    s_nulls = [np.asarray(ref.columns[f].nulls)[np.asarray(perm)]
               for f in (pkey, okey)]
    s_vals = [np.asarray(ref.columns[f].values)[np.asarray(perm)]
              for f in (pkey, okey)]
    sorted_lanes = [jnp.asarray(s_nulls[0]), jnp.asarray(s_vals[0]),
                    jnp.asarray(s_nulls[1]), jnp.asarray(s_vals[1])]
    s_valid = valid[np.asarray(perm)]
    part_want = np.array(_jax_changed(sorted_lanes, [(0, 1)], CAP))
    part_want |= ~s_valid & np.roll(s_valid, 1)
    peer_want = part_want | np.asarray(
        _jax_changed(sorted_lanes, [(2, 3)], CAP))
    keys = [(port.columns[f].nulls, [port.columns[f].values])
            for f in (pkey, okey)]
    part, peer = PK.key_change_flags(perm_t, keys, port.num_rows, 1,
                                     PK.WINDOW_FLAGS)
    _exact(part, part_want)
    _exact(peer, peer_want)
    assert int(part.sum()) > 5 and int(peer.sum()) > int(part.sum())


def test_key_change_flags_first_match_mark_distinct():
    rng = np.random.default_rng(9)
    ref, port = _pages(_window_cols(rng))
    fields = (4, 1)
    out = RM.mark_distinct(ref, fields)
    lanes = [(~(np.arange(CAP) < N)).astype(np.int8)]
    for f in fields:
        c = ref.columns[f]
        lanes += [np.asarray(c.nulls).astype(np.int8),
                  np.asarray(RK.group_values(c))]
    perm = np.asarray(RK.lex_perm([jnp.asarray(x) for x in lanes]))
    keys = []
    for f in fields:
        c = port.columns[f]
        keys += [(None, [c.nulls]), (None, [c.values])]
    first, none = PK.key_change_flags(torch.from_numpy(perm.astype(np.int64)),
                                      keys, port.num_rows, 0,
                                      PK.FIRST_FLAGS)
    assert none is None
    _exact(first, out.columns[-1].values)


# ---------------------------------------------------------------------------
# window_page (K7, K8, K9)
# ---------------------------------------------------------------------------

def _frame(mode, st, sn, en, enn):
    return (RW.Frame(mode, st, sn, en, enn), PW.Frame(mode, st, sn, en, enn))


DEFAULT = (None, None)
F_ROWS_RUN = _frame("rows", "unbounded_preceding", None, "current", None)
F_ROWS_SLIDE = _frame("rows", "preceding", 2, "following", 1)
F_ROWS_TAIL = _frame("rows", "current", None, "unbounded_following", None)
F_ROWS_BEFORE = _frame("rows", "preceding", 3, "preceding", 1)
F_ROWS_AFTER = _frame("rows", "following", 1, "following", 3)
F_ROWS_LEAD_IN = _frame("rows", "unbounded_preceding", None, "preceding", 2)
F_ROWS_ALL = _frame("rows", "unbounded_preceding", None,
                    "unbounded_following", None)
F_RANGE_ALL = _frame("range", "unbounded_preceding", None,
                     "unbounded_following", None)
F_RANGE_TAIL = _frame("range", "current", None, "unbounded_following", None)
F_RANGE_PEERS = _frame("range", "current", None, "current", None)

# (kind, field, output type, param, default, frame)
SPECS = [
    ("row_number", None, "bigint", None, None, DEFAULT),
    ("rank", None, "bigint", None, None, DEFAULT),
    ("dense_rank", None, "bigint", None, None, DEFAULT),
    ("ntile", None, "bigint", 3, None, DEFAULT),
    ("ntile", None, "bigint", 7, None, DEFAULT),
    ("lag", 3, "bigint", 2, -1, DEFAULT),
    ("lag", 2, "double", 1, None, DEFAULT),
    ("lead", 4, "varchar", 1, None, DEFAULT),
    ("lead", 6, "boolean", 3, None, DEFAULT),
    ("first_value", 4, "varchar", None, None, DEFAULT),
    ("last_value", 2, "double", None, None, F_ROWS_ALL),
    ("nth_value", 3, "bigint", 2, None, F_ROWS_SLIDE),
    ("last_value", 3, "bigint", None, None, F_RANGE_PEERS),
    ("sum", 2, "double", None, None, DEFAULT),
    ("sum", 3, "bigint", None, None, F_ROWS_RUN),
    ("sum", 2, "double", None, None, F_ROWS_SLIDE),
    ("sum", 3, "bigint", None, None, F_ROWS_BEFORE),
    ("sum", 7, "decimal(12,2)", None, None, F_RANGE_TAIL),
    ("count", 2, "bigint", None, None, F_ROWS_AFTER),
    ("count_star", None, "bigint", None, None, F_RANGE_PEERS),
    ("avg", 2, "double", None, None, F_RANGE_ALL),
    ("avg", 7, "double", None, None, DEFAULT),
    ("avg", 3, "double", None, None, F_ROWS_TAIL),
    ("min", 2, "double", None, None, DEFAULT),
    ("max", 4, "varchar", None, None, F_ROWS_RUN),
    ("min", 6, "boolean", None, None, F_RANGE_ALL),
    ("max", 3, "bigint", None, None, F_ROWS_TAIL),
    ("min", 1, "double", None, None, F_ROWS_LEAD_IN),
    ("min", 2, "double", None, None, F_ROWS_SLIDE),
    ("max", 3, "bigint", None, None, F_ROWS_BEFORE),
    ("min", 4, "varchar", None, None, F_ROWS_AFTER),
]

_FLOAT_SUMS = {"sum", "avg"}

# (partition fields, order keys as (field, ascending, nulls_first))
LAYOUTS = {
    "part_order": ((0,), [(1, True, None)]),
    "two_parts_desc_nulls_first": ((0, 4), [(5, False, True),
                                            (1, True, True)]),
    "global_desc": ((), [(3, False, None)]),
    "part_no_order": ((4,), []),
    "near_int64_min_desc": ((0,), [(8, False, None), (5, True, None)]),
}


def _specs(pkg):
    out = []
    for kind, field, tname, param, default, frame in SPECS:
        mod, types = (RW, RT) if pkg == "jax" else (PW, PT)
        fr = frame[0] if pkg == "jax" else frame[1]
        out.append(mod.WindowSpec(kind, field, types.parse_type(tname),
                                  param, default, fr))
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_window_page_matches_jax(layout):
    rng = np.random.default_rng(11)
    ref, port = _pages(_window_cols(rng))
    parts, order = LAYOUTS[layout]
    rkeys = [RK.SortKey(f, a, nf) for f, a, nf in order]
    pkeys = [PK.SortKey(f, a, nf) for f, a, nf in order]
    r_out = RW.window_page(ref, parts, rkeys, _specs("jax"))
    p_out = PW.window_page(port, parts, pkeys, _specs("port"))
    assert int(p_out.num_rows) == int(r_out.num_rows) == N
    base = len(ref.columns)
    for i, spec in enumerate(SPECS):
        rc, pc = r_out.columns[base + i], p_out.columns[base + i]
        what = f"{layout}: {spec[:3]} frame {spec[5][0]}"
        _exact(pc.nulls, rc.nulls, what)
        if spec[0] in _FLOAT_SUMS and pc.values.dtype == torch.float64:
            _close(pc.values, rc.values, what)
        else:
            _exact(_flushed(pc.values), _flushed(rc.values), what)
        assert pc.type == PT.parse_type(spec[2]), what
        if rc.dictionary is not None:
            assert pc.dictionary.words == rc.dictionary.words, what
        else:
            assert pc.dictionary is None, what


#: a min/max frame bounded on both sides 2,001 rows wide, which the JAX
#: package answers from its sparse table (:340-383) and the port's kernel
#: from a sparse table of its own; partitions shorter and longer than it
WIDE_FRAME = _frame("rows", "preceding", 1000, "following", 1000)
WIDE_SPECS = [("min", 2, "double"), ("max", 3, "bigint"),
              ("min", 4, "varchar"), ("max", 6, "boolean")]


@pytest.mark.parametrize("layout", ["global_desc", "part_order"])
def test_wide_both_bounded_frame_matches_jax_sparse_table(layout):
    rng = np.random.default_rng(23)
    n = 4500
    ref, port = _pages(_window_cols(rng, n), n=n, cap=8192)
    parts, order = LAYOUTS[layout]
    rkeys = [RK.SortKey(f, a, nf) for f, a, nf in order]
    pkeys = [PK.SortKey(f, a, nf) for f, a, nf in order]
    r_out = RW.window_page(ref, parts, rkeys, [
        RW.WindowSpec(k, f, RT.parse_type(t), frame=WIDE_FRAME[0])
        for k, f, t in WIDE_SPECS])
    p_out = PW.window_page(port, parts, pkeys, [
        PW.WindowSpec(k, f, PT.parse_type(t), frame=WIDE_FRAME[1])
        for k, f, t in WIDE_SPECS])
    base = len(ref.columns)
    for i, spec in enumerate(WIDE_SPECS):
        rc, pc = r_out.columns[base + i], p_out.columns[base + i]
        what = f"{layout}: {spec}"
        _exact(pc.nulls, rc.nulls, what)
        _exact(_flushed(pc.values), _flushed(rc.values), what)


def test_row_number_over_ties_follows_the_stable_sort():
    """row_number among peers: rows with equal keys keep their page order
    in both packages (stable sorts)."""
    n = 300
    cols = [("bigint", np.repeat(np.arange(3), 100), np.zeros(n, bool),
             None),
            ("integer", np.zeros(n, np.int32), np.zeros(n, bool), None)]
    ref, port = _pages(cols, n=n, cap=1024)
    spec_r = [RW.WindowSpec("row_number", None, RT.BIGINT)]
    spec_p = [PW.WindowSpec("row_number", None, PT.BIGINT)]
    r = RW.window_page(ref, (0,), [RK.SortKey(1)], spec_r)
    p = PW.window_page(port, (0,), [PK.SortKey(1)], spec_p)
    _exact(p.columns[-1].values, r.columns[-1].values)
    assert p.columns[-1].values[:n].tolist() == \
        list(range(1, 101)) * 3


def test_int64_min_sorts_last_under_desc():
    """The port orders a descending BIGINT key by its complement, so
    INT64_MIN ranks last; the JAX package's negation wraps it to itself
    and ranks it first (noted in ROADMAP Queue 3)."""
    vals = np.array([I64.min, -5, 7, I64.max - 1], dtype=np.int64)
    cols = [("bigint", vals, np.zeros(4, bool), None)]
    _ref, port = _pages(cols, n=4, cap=256)
    out = PW.window_page(port, (), [PK.SortKey(0, ascending=False)],
                         [PW.WindowSpec("row_number", None, PT.BIGINT)])
    assert out.columns[-1].values[:4].tolist() == [4, 3, 2, 1]


def test_resolve_frame_rejects_value_offset_range():
    with pytest.raises(NotImplementedError):
        PW.resolve_frame(PW.Frame("range", "preceding", 2, "current", None),
                         True)


# ---------------------------------------------------------------------------
# mark_distinct (K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [(0,), (4, 1), (2, 6, 5)],
                         ids=["bigint", "varchar_double", "three_keys"])
def test_mark_distinct_matches_jax(fields):
    rng = np.random.default_rng(13)
    ref, port = _pages(_window_cols(rng))
    r = RM.mark_distinct(ref, fields)
    p = PM.mark_distinct(port, fields)
    assert int(p.num_rows) == int(r.num_rows)
    assert p.names == r.names
    for i, (pc, rc) in enumerate(zip(p.columns, r.columns)):
        _exact(pc.nulls, rc.nulls, f"nulls of col {i}")
        _exact(pc.values, rc.values, f"values of col {i}")
    assert 0 < int(p.columns[-1].values.sum()) < N


def test_window_sum_keeps_an_infinity_in_its_partition():
    """The port's frame sums restart at each partition start, so +inf in
    one partition leaves the sums of the partitions after it finite; the
    JAX package's differences of one global running sum give inf - inf =
    NaN there (ROADMAP Queue 3)."""
    n = 6
    cols = [("bigint", np.array([0, 0, 1, 1, 2, 2]), np.zeros(n, bool),
             None),
            ("double", np.array([1.0, np.inf, 2.0, 3.0, 4.0, 0.5]),
             np.zeros(n, bool), None)]
    _ref, port = _pages(cols, n=n, cap=256)
    out = PW.window_page(port, (0,), [PK.SortKey(1)],
                         [PW.WindowSpec("sum", 1, PT.DOUBLE)])
    assert out.columns[-1].values[:n].tolist() == \
        [1.0, np.inf, 2.0, 5.0, 4.5, 0.5]
