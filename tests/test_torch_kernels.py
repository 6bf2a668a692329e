"""The port's kernel modules against the JAX package's functions, on the CPU.

Each test builds one set of numpy inputs from a seed, hands it to the JAX
function (presto_tpu) and to its counterpart in presto_tpu_torch (whose
wrappers take their plain PyTorch versions on CPU tensors), and compares:

- direct aggregation (kernel K1): ops/aggregate.grouped_aggregate on
  dictionary/boolean keys, with NULL keys and values, a fused row mask, an
  empty mask, a group whose inputs are all NULL, and global aggregation;
  and at 64 bins, the kernel's largest domain, with an all-NULL input;
- sorted aggregation (K2 + K3): large-domain keys, capacity overflow;
- compaction (K2): data/column.compact and the survivor permutation, on
  one tile and across several of the kernel's tiles;
- segment reductions (K3): ops/scan.segment_sums and group_starts, and
  sums and the sorted min/max over segments longer than one of the
  kernel's pieces (native.SEGMENT_PIECE rows);
- ORDER BY / TopN: ops/sort.

Tolerance: float results within 1e-9 relative (the port sums in another
order than the JAX package); everything else exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.data import column as RC
from presto_tpu.ops import aggregate as RA
from presto_tpu.ops import keys as RK
from presto_tpu.ops import scan as RS
from presto_tpu.ops import sort as RO
from presto_tpu_torch import types as PT
from presto_tpu_torch.data import column as PC
from presto_tpu_torch.ops import aggregate as PA
from presto_tpu_torch.ops import keys as PK
from presto_tpu_torch.ops import scan as PS
from presto_tpu_torch.ops import sort as PO
from tests.oracle import assert_rows_match
from torch_threads import _one_torch_thread  # noqa: F401

TOL = 1e-9
CAP = 4096
N = 3000


def _pages(cols, n=N, cap=CAP):
    """cols: list of (type name, values, nulls, words or None) -> the same
    page for both packages."""
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


def _mixed_columns(rng, n=N):
    """Columns: 0 k1 varchar(3 words) with NULLs, 1 k2 boolean with NULLs,
    2 v double (NULL wherever k1 == 'c': an all-NULL group), 3 w bigint
    with NULLs, 4 s varchar(50 words), 5 b boolean, 6 g bigint (large
    domain) with NULLs, 7 cnt bigint (an avg_final count column)."""
    k1 = rng.integers(0, 3, n).astype(np.int32)
    k1_null = rng.random(n) < 0.1
    v_null = (k1 == 2) | (rng.random(n) < 0.1)
    words = [f"w{i:02d}" for i in range(50)]
    return [
        ("varchar", k1, k1_null, ["a", "b", "c"]),
        ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.05, None),
        ("double", rng.normal(100.0, 30.0, n), v_null, None),
        ("bigint", rng.integers(-10**6, 10**6, n), rng.random(n) < 0.2,
         None),
        ("varchar", rng.integers(0, 50, n).astype(np.int32),
         rng.random(n) < 0.1, words),
        ("boolean", rng.random(n) < 0.3, np.zeros(n, bool), None),
        ("bigint", rng.integers(0, 700, n), rng.random(n) < 0.05, None),
        ("bigint", rng.integers(1, 9, n), np.zeros(n, bool), None),
    ]


def _aggs(T, mod):
    S = mod.AggSpec
    return [
        S("count_star", None, T.BIGINT),
        S("count", 2, T.BIGINT),
        S("sum", 2, T.DOUBLE),
        S("sum", 3, T.BIGINT),
        S("avg", 2, T.DOUBLE),
        S("avg", 3, T.DOUBLE),
        S("min", 2, T.DOUBLE),
        S("max", 3, T.BIGINT),
        S("min", 4, T.VARCHAR),
        S("max", 4, T.VARCHAR),
        S("bool_or", 5, T.BOOLEAN),
        S("bool_and", 5, T.BOOLEAN),
        S("avg_partial", 2, T.DOUBLE),
        S("avg_final", 2, T.DOUBLE, field2=7),
        S("sum", 3, T.BIGINT, mask_field=5),
    ]


def _aggregate_both(cols, group_fields, mask, out_cap, n=N,
                    overflow=False):
    ref, port = _pages(cols, n)
    rmask = None if mask is None else jnp.asarray(
        np.pad(mask, (0, CAP - len(mask))))
    pmask = None if mask is None else torch.from_numpy(
        np.pad(mask, (0, CAP - len(mask))))
    r_out, r_true = RA.grouped_aggregate(ref, group_fields, _aggs(RT, RA),
                                         out_cap, row_mask=rmask)
    p_out, p_true = PA.grouped_aggregate(port, group_fields, _aggs(PT, PA),
                                         out_cap, row_mask=pmask)
    assert int(p_true) == int(r_true)
    assert p_out.capacity == r_out.capacity
    p_rows, r_rows = p_out.to_pylist(), r_out.to_pylist()
    if overflow:
        # An overflowed page is only good for its true group count: the
        # executor re-runs at a larger capacity. Its last group's segment
        # runs to the page end in both packages, and the JAX package takes
        # min/max there by a sort, so only the groups before it compare.
        assert int(r_true) > out_cap
        p_rows, r_rows = p_rows[:-1], r_rows[:-1]
    assert_rows_match(p_rows, r_rows, float_tol=TOL)
    return p_out


@pytest.mark.parametrize("case", ["mask", "no_mask", "empty_mask"])
@pytest.mark.parametrize("group_fields", [(0, 1), (0,), ()],
                         ids=["two_keys", "one_key", "global"])
def test_direct_aggregate_matches_jax(case, group_fields):
    rng = np.random.default_rng(11)
    cols = _mixed_columns(rng)
    mask = {"mask": rng.random(N) < 0.7, "no_mask": None,
            "empty_mask": np.zeros(N, bool)}[case]
    out = _aggregate_both(cols, group_fields, mask, 256)
    if case == "empty_mask" and not group_fields:
        # SQL global aggregation over nothing: one row, count 0, sum NULL
        row = out.to_pylist()[0]
        assert row[0] == 0 and row[2] is None


def test_direct_aggregate_at_64_bins_matches_jax():
    """The direct path at its largest domain: two 7-word dictionary keys
    with NULLs make 64 bins, the last of them the rows whose keys are
    both NULL; one input is NULL on every row."""
    rng = np.random.default_rng(16)
    words = [f"k{i}" for i in range(7)]
    k1n, k2n = rng.random(N) < 0.15, rng.random(N) < 0.15
    k1n[:40] = k2n[:40] = True
    cols = [("varchar", rng.integers(0, 7, N).astype(np.int32), k1n, words),
            ("varchar", rng.integers(0, 7, N).astype(np.int32), k2n, words),
            ("double", rng.normal(0.0, 1.0, N), np.ones(N, bool), None),
            ("bigint", rng.integers(-10**6, 10**6, N), rng.random(N) < 0.2,
             None),
            ("double", rng.normal(100.0, 30.0, N), rng.random(N) < 0.1, None)]
    ref, port = _pages(cols)
    assert PA._direct_domains(port, (0, 1)) == ([7, 7], 64)

    def aggs(T, mod):
        S = mod.AggSpec
        return [S("count_star", None, T.BIGINT), S("count", 2, T.BIGINT),
                S("sum", 2, T.DOUBLE), S("min", 2, T.DOUBLE),
                S("max", 2, T.DOUBLE), S("sum", 3, T.BIGINT),
                S("min", 3, T.BIGINT), S("avg", 4, T.DOUBLE),
                S("max", 4, T.DOUBLE)]

    mask = rng.random(CAP) < 0.9
    r_out, r_true = RA.grouped_aggregate(ref, (0, 1), aggs(RT, RA), 64,
                                         row_mask=jnp.asarray(mask))
    p_out, p_true = PA.grouped_aggregate(port, (0, 1), aggs(PT, PA), 64,
                                         row_mask=torch.from_numpy(mask))
    assert int(p_true) == int(r_true) == 64
    rows = p_out.to_pylist()
    assert_rows_match(rows, r_out.to_pylist(), float_tol=TOL)
    assert rows[-1][:2] == [None, None] or rows[-1][:2] == (None, None)
    assert all(r[3] == 0 and r[4] is None for r in rows)   # the NULL input


def test_direct_aggregate_takes_the_kernel_path():
    assert PA._direct_domains(
        _pages(_mixed_columns(np.random.default_rng(1)))[1], (0, 1)) \
        == ([3, 2], 12)


@pytest.mark.parametrize("out_cap", [CAP, 256], ids=["fits", "overflow"])
@pytest.mark.parametrize("case", ["mask", "no_mask"])
def test_sorted_aggregate_matches_jax(case, out_cap):
    rng = np.random.default_rng(12)
    cols = _mixed_columns(rng)
    mask = rng.random(N) < 0.6 if case == "mask" else None
    # bigint key (large domain) and a 50-word varchar key -> sorted path
    for group_fields in ((6,), (4, 6)):
        _aggregate_both(cols, group_fields, mask, out_cap,
                        overflow=out_cap < CAP)


def test_direct_agg_kernel_outputs_match_plain_formula():
    """The wrapper's contract on the CPU: per-bin counts and sums of the
    mixed-radix code, NULL keys in their own bin, padding ignored."""
    rng = np.random.default_rng(13)
    n, cap = 2500, 4096
    codes = rng.integers(0, 3, cap).astype(np.int32)
    knull = rng.random(cap) < 0.2
    vals = rng.normal(size=cap)
    vnull = rng.random(cap) < 0.3
    mask = rng.random(cap) < 0.5
    r = PA.direct_agg(cap, torch.tensor(n), [(torch.from_numpy(codes),
                                             torch.from_numpy(knull))],
                      [3], [(torch.from_numpy(vals), torch.from_numpy(vnull),
                             PA.WANT_SUM | PA.WANT_MINMAX)],
                      torch.from_numpy(mask))
    code = np.where(knull, 3, codes)[:n]
    valid = mask[:n]
    for b in range(4):
        sel = valid & (code == b)
        live = sel & ~vnull[:n]
        assert int(r["rows"][b]) == sel.sum()
        assert int(r["cnt"][0, b]) == live.sum()
        np.testing.assert_allclose(float(r["fsum"][0, b]),
                                   vals[:n][live].sum(), rtol=TOL)
        if live.any():
            assert float(r["mn"][0].view(torch.float64)[b]) \
                == vals[:n][live].min()


@pytest.mark.parametrize("case", ["random", "none", "all", "short"])
def test_compact_matches_jax(case):
    rng = np.random.default_rng(14)
    cols = _mixed_columns(rng)
    n = 1200 if case == "short" else N
    keep = {"random": rng.random(CAP) < 0.4, "none": np.zeros(CAP, bool),
            "all": np.ones(CAP, bool), "short": rng.random(CAP) < 0.5}[case]
    ref, port = _pages(cols, n)
    r = RC.compact(ref, jnp.asarray(keep))
    p = PC.compact(port, torch.from_numpy(keep))
    assert int(p.num_rows) == int(r.num_rows)
    assert_rows_match(p.to_pylist(), r.to_pylist(), float_tol=0.0)
    # padding rows past the survivors are NULL in both
    for rc, pc in zip(r.columns, p.columns):
        np.testing.assert_array_equal(pc.nulls.numpy(), np.asarray(rc.nulls))


def test_compact_indices_is_the_stable_partition():
    rng = np.random.default_rng(15)
    keep = rng.random(5000) < 0.3
    perm, count = PC.compact_indices(torch.from_numpy(keep),
                                     torch.tensor(4000))
    live = keep & (np.arange(5000) < 4000)
    expected = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])
    np.testing.assert_array_equal(perm.numpy(), expected)
    assert int(count) == live.sum()


@pytest.mark.parametrize("dtype", ["float64", "int64", "int32"])
def test_segment_sums_match_jax(dtype):
    rng = np.random.default_rng(16)
    n = 4000
    vals = (rng.normal(0, 1e3, n) if dtype == "float64"
            else rng.integers(-10**5, 10**5, n)).astype(dtype)
    cuts = np.sort(rng.choice(np.arange(1, n), 300, replace=False))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [n]])
    # empty segments too (start == end), as overflow bins give them
    starts = np.concatenate([starts, [n, 17]]).astype(np.int32)
    ends = np.concatenate([ends, [n, 17]]).astype(np.int32)
    r = np.asarray(RS.segment_sums(jnp.asarray(vals), jnp.asarray(starts),
                                   jnp.asarray(ends)))
    p = PS.segment_sums(torch.from_numpy(vals),
                        torch.from_numpy(starts.astype(np.int64)),
                        torch.from_numpy(ends.astype(np.int64))).numpy()
    if dtype == "float64":
        np.testing.assert_allclose(p, r, rtol=TOL, atol=TOL * 1e3)
    else:
        np.testing.assert_array_equal(p, r)


#: segment lengths past one of K3's pieces, with empty segments between
LONG_LENGTHS = [20_000, 0, 70_000, 45_000, 0, 33_000]


@pytest.mark.parametrize("dtype", ["float64", "int64", "int32"])
def test_segment_sums_match_jax_past_one_piece(dtype):
    rng = np.random.default_rng(20)
    lengths = np.array(LONG_LENGTHS)
    ends = np.cumsum(lengths)
    n = int(ends[-1]) + 100
    vals = (rng.normal(0, 1e3, n) if dtype == "float64"
            else rng.integers(-10**5, 10**5, n)).astype(dtype)
    # a segment clamped at the page end and an empty one past it
    starts = np.concatenate([ends - lengths, [n - 50, n]]).astype(np.int32)
    ends = np.concatenate([ends, [n, n]]).astype(np.int32)
    r = np.asarray(RS.segment_sums(jnp.asarray(vals), jnp.asarray(starts),
                                   jnp.asarray(ends)))
    p = PS.segment_sums(torch.from_numpy(vals),
                        torch.from_numpy(starts.astype(np.int64)),
                        torch.from_numpy(ends.astype(np.int64))).numpy()
    if dtype == "float64":
        np.testing.assert_allclose(p, r, rtol=TOL, atol=TOL * 1e3)
    else:
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("case", ["mask", "no_mask"])
def test_sorted_aggregate_matches_jax_past_one_piece(case):
    """Four groups of 20,000-70,000 rows (each longer than one of K3's
    pieces) through the sorted path's sums, counts and min/max, with NULL
    values, a row mask and empty overflow groups."""
    rng = np.random.default_rng(21)
    n, cap = 170_000, 262_144
    key = np.repeat([40, 7, 23, 11], [20_000, 70_000, 45_000, 35_000])
    rng.shuffle(key)
    cols = [("bigint", key, np.zeros(n, bool), None),
            ("double", rng.normal(100.0, 30.0, n), rng.random(n) < 0.1,
             None),
            ("bigint", rng.integers(-10**6, 10**6, n), rng.random(n) < 0.2,
             None)]
    ref, port = _pages(cols, n, cap)
    mask = np.pad(rng.random(n) < 0.7, (0, cap - n)) if case == "mask" \
        else None

    def aggs(T, mod):
        S = mod.AggSpec
        return [S("count_star", None, T.BIGINT), S("count", 1, T.BIGINT),
                S("sum", 1, T.DOUBLE), S("sum", 2, T.BIGINT),
                S("avg", 1, T.DOUBLE), S("min", 1, T.DOUBLE),
                S("max", 1, T.DOUBLE), S("min", 2, T.BIGINT),
                S("max", 2, T.BIGINT)]

    r_out, r_true = RA.grouped_aggregate(
        ref, (0,), aggs(RT, RA), 16,
        row_mask=None if mask is None else jnp.asarray(mask))
    p_out, p_true = PA.grouped_aggregate(
        port, (0,), aggs(PT, PA), 16,
        row_mask=None if mask is None else torch.from_numpy(mask))
    assert int(p_true) == int(r_true) == 4
    assert_rows_match(p_out.to_pylist(), r_out.to_pylist(), float_tol=TOL)


@pytest.mark.parametrize("p", [0.0004, 0.4, 1.0],
                         ids=["sparse", "random", "all"])
def test_compact_matches_jax_across_tiles(p):
    """A page of several of K2's tiles (native.COMPACT_TILE rows)."""
    rng = np.random.default_rng(22)
    n, cap = 30_001, 32_768
    ref, port = _pages(_mixed_columns(rng, n), n, cap)
    keep = rng.random(cap) < p
    r = RC.compact(ref, jnp.asarray(keep))
    q = PC.compact(port, torch.from_numpy(keep))
    assert int(q.num_rows) == int(r.num_rows)
    assert_rows_match(q.to_pylist(), r.to_pylist(), float_tol=0.0)
    for rc, pc in zip(r.columns, q.columns):
        np.testing.assert_array_equal(pc.nulls.numpy(), np.asarray(rc.nulls))


@pytest.mark.parametrize("out_cap", [64, 512, 8192],
                         ids=["overflow", "fits", "wider_than_page"])
def test_group_starts_match_jax(out_cap):
    rng = np.random.default_rng(17)
    cap = 4096
    flags = rng.random(cap) < 0.1
    flags[0] = True
    gvalid = np.arange(cap) < 3500
    rs, _rg = RS.group_starts(jnp.asarray(flags), jnp.asarray(gvalid),
                              out_cap)
    ps, groups = PS.group_starts(torch.from_numpy(flags),
                                 torch.from_numpy(gvalid), out_cap)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    assert int(groups) == int(np.sum(flags & gvalid))


def test_segment_reduce_min_max_sort_nan_last():
    vals = torch.tensor([3.0, float("nan"), 1.0, float("nan"), 5.0],
                        dtype=torch.float64)
    starts = torch.tensor([0, 3, 4, 5])
    ends = torch.tensor([3, 4, 5, 5])
    r = PS.segment_reduce(vals, None, starts, ends, PS.WANT_MINMAX)
    assert r["cnt"].tolist() == [3, 1, 1, 0]
    assert r["min"][0] == 1.0 and r["max"][0] == 3.0
    assert torch.isnan(r["min"][1]) and r["max"][2] == 5.0


@pytest.mark.parametrize("keys", [
    [(6, True, None)], [(2, False, None)], [(4, True, True), (3, False, None)],
    [(0, True, False), (2, False, True)],
], ids=["bigint_asc", "double_desc", "varchar_nulls_first", "mixed"])
def test_sort_and_top_n_match_jax(keys):
    rng = np.random.default_rng(18)
    ref, port = _pages(_mixed_columns(rng))
    rk = [RK.SortKey(f, asc, nf) for f, asc, nf in keys]
    pk = [PK.SortKey(f, asc, nf) for f, asc, nf in keys]
    assert_rows_match(PO.sort_page(port, pk).to_pylist(),
                      RO.sort_page(ref, rk).to_pylist(), float_tol=0.0)
    assert_rows_match(PO.top_n(port, pk, 37).to_pylist(),
                      RO.top_n(ref, rk, 37).to_pylist(), float_tol=0.0)
    assert PO.limit_page(port, 5).to_pylist() == \
        RO.limit_page(ref, 5).to_pylist()


def test_new_group_flags_match_jax():
    rng = np.random.default_rng(19)
    cols = _mixed_columns(rng)
    ref, port = _pages(cols)
    perm = np.argsort(np.asarray(ref.columns[6].values), kind="stable")
    for fields in ((6,), (0, 1), (2,)):
        r = RK.new_group_flags(ref, fields, jnp.asarray(perm))
        p = PK.new_group_flags(
            PC.gather_page(port, torch.from_numpy(perm)), fields)
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
