"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the engine on the card against the
engine on the CPU. Every test skips (inside the `cuda` fixture) where no
CUDA device is present. On a machine with a card:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_gpu.py

(--noconftest: tests/conftest.py pins JAX to the CPU, and the card's
machine has no JAX; this file imports none.)

Tolerances: counts, indices, hashes, join pairs and flags, scans other
than float64 sums, window outputs other than float64 sums and averages,
int64 sums, min and max exact; float64 sums within 1e-9 relative (the
kernels sum in another order than the plain versions).
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.data import column as C
from presto_tpu_torch.ops import aggregate as A
from presto_tpu_torch.ops import join as J
from presto_tpu_torch.ops import keys as K
from presto_tpu_torch.ops import scan as S
from presto_tpu_torch.ops import window as W

pytestmark = pytest.mark.gpu

RTOL = 1e-9


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.shape == b.shape and a.dtype == b.dtype
    eq = a == b
    if a.is_floating_point():
        eq |= torch.isnan(a) & torch.isnan(b)
    assert bool(eq.all()), (a, b)


def _close(a, b):
    a, b = a.cpu().double(), b.cpu().double()
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("cap,n", [(4096, 3000), (1 << 20, 1_000_003)])
def test_direct_agg_kernel_matches_plain(cuda, cap, n):
    rng = np.random.default_rng(cap)
    keys = [(torch.from_numpy(rng.integers(-1, 5, cap).astype(np.int32)),
             torch.from_numpy(rng.random(cap) < 0.1)),
            (torch.from_numpy(rng.integers(0, 2, cap).astype(np.int32)),
             torch.from_numpy(rng.random(cap) < 0.05))]
    domains = [4, 2]
    inputs = []
    for j in range(13):                  # more than one launch's worth
        kind = j % 3
        vals = (rng.normal(0, 1e3, cap) if kind == 0 else
                rng.integers(-10**9, 10**9, cap) if kind == 1 else
                rng.integers(-1000, 1000, cap).astype(np.int32))
        if kind == 0 and j == 3:
            vals[::97] = np.nan
        inputs.append((torch.from_numpy(vals),
                       torch.from_numpy(rng.random(cap) < 0.2),
                       A.WANT_SUM | A.WANT_MINMAX))
    mask = torch.from_numpy(rng.random(cap) < 0.8)
    args = (cap, torch.tensor(n), keys, domains, inputs, mask)
    plain = A.direct_agg(*args)
    gpu_args = (cap, args[1].to(cuda),
                [(c.to(cuda), nl.to(cuda)) for c, nl in keys], domains,
                [(v.to(cuda), nl.to(cuda), w) for v, nl, w in inputs],
                mask.to(cuda))
    before = A.direct_agg.launches
    got = A.direct_agg(*gpu_args)
    assert A.direct_agg.launches == before + 2
    for name in ("rows", "cnt", "isum"):
        _same(got[name], plain[name])
    for name in ("mn", "mx"):           # float64 bits for float inputs
        for j, (v, _nl, _w) in enumerate(inputs):
            g, p = got[name][j], plain[name][j]
            if v.dtype == torch.float64:
                g, p = g.view(torch.float64), p.view(torch.float64)
            _same(g, p)
    _close(got["fsum"], plain["fsum"])


@pytest.mark.parametrize("n,num_rows", [(1, None), (2047, None),
                                        (2049, 1000), (5_000_001, 4_999_999),
                                        (100_000, 0)])
def test_compact_indices_kernel_matches_plain(cuda, n, num_rows):
    rng = np.random.default_rng(n)
    keep = torch.from_numpy(rng.random(n) < 0.37)
    nr = None if num_rows is None else torch.tensor(num_rows)
    perm, count = C.compact_indices(keep, nr)
    before = C.compact_indices.launches
    kp, kc = C.compact_indices(keep.to(cuda),
                               None if nr is None else nr.to(cuda))
    assert C.compact_indices.launches == before + 1
    _same(kp, perm)
    _same(kc, count)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.int32])
def test_segment_reduce_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(7)
    n = 300_000
    vals = torch.from_numpy(rng.normal(0, 100, n)).to(dtype)
    if dtype == torch.float64:
        vals[::53] = float("nan")
    lengths = rng.integers(0, 40, 20_000)
    ends = np.minimum(np.cumsum(lengths), n)
    starts = ends - lengths
    starts = torch.from_numpy(np.maximum(starts, 0))
    ends = torch.from_numpy(ends)
    live = torch.from_numpy(rng.random(n) < 0.9)
    want = S.WANT_SUM | S.WANT_MINMAX
    plain = S.segment_reduce(vals, live, starts, ends, want)
    got = S.segment_reduce(vals.to(cuda), live.to(cuda), starts.to(cuda),
                           ends.to(cuda), want)
    for name in ("cnt", "min", "max") + (("isum",) if dtype != torch.float64
                                         else ()):
        _same(got[name], plain[name])
    if dtype == torch.float64:
        _same(torch.isnan(got["fsum"]), torch.isnan(plain["fsum"]))
        ok = ~torch.isnan(plain["fsum"])
        _close(got["fsum"].cpu()[ok], plain["fsum"][ok])
    else:
        _close(got["fsum"], plain["fsum"])


def _key_columns(rng, n):
    f = rng.normal(0, 1e3, n)
    f[:6] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
    specs = [(T.BIGINT, rng.integers(-2 ** 62, 2 ** 62, n)),
             (T.VARCHAR, rng.integers(0, 9, n).astype(np.int32)),
             (T.BOOLEAN, rng.random(n) < 0.5),
             (T.INTEGER, rng.integers(-5, 5, n).astype(np.int32)),
             (T.DOUBLE, f), (T.REAL, f.astype(np.float32))]
    return [C.Column.from_numpy(v, t, nulls=rng.random(n) < 0.1,
                                device="cpu") for t, v in specs]


def _on(col, dev):
    return C.Column(col.values.to(dev), col.nulls.to(dev), col.type,
                    col.dictionary)


@pytest.mark.parametrize("fields", [(0,), (1, 2, 3), (4,), (5, 0)])
def test_hash_columns_kernel_matches_plain(cuda, fields):
    rng = np.random.default_rng(41)
    cols = _key_columns(rng, 300_001)
    plain = K.hash_columns([cols[f] for f in fields])
    before = K.hash_columns.launches
    got = K.hash_columns([_on(cols[f], cuda) for f in fields])
    assert K.hash_columns.launches == before + 1
    _same(got, plain)


def _probe_inputs(rng, n_probe, n_build, key_range, dup):
    bk = (rng.integers(0, key_range, n_build) if dup
          else rng.permutation(key_range)[:n_build])
    pk = rng.integers(0, key_range, n_probe)
    bh = K.hash_columns([C.Column.from_numpy(bk, T.BIGINT, device="cpu")])
    ph = K.hash_columns([C.Column.from_numpy(pk, T.BIGINT, device="cpu")])
    bh = torch.where(torch.from_numpy(rng.random(bh.shape[0]) < 0.02),
                     -2, bh)
    ph = torch.where(torch.from_numpy(rng.random(ph.shape[0]) < 0.05),
                     -1, ph)
    bh_sorted, order = torch.sort(bh, stable=True)
    pvals = [C.Column.from_numpy(pk, T.BIGINT, device="cpu").values]
    bvals = [C.Column.from_numpy(bk, T.BIGINT, device="cpu").values]
    return ph, bh_sorted, order, pvals, bvals


@pytest.mark.parametrize("mode", [J.WINDOW, J.FIRST, J.LAST, J.ALL])
@pytest.mark.parametrize("dup", [False, True])
def test_join_probe_kernel_matches_plain(cuda, mode, dup):
    rng = np.random.default_rng(43)
    args = _probe_inputs(rng, 200_000, 60_000, 100_000, dup)
    plain = J.join_probe(*args, mode)
    on = [a.to(cuda) for a in args[:3]]
    before = J.join_probe.launches
    got = J.join_probe(*on, [v.to(cuda) for v in args[3]],
                       [v.to(cuda) for v in args[4]], mode)
    assert J.join_probe.launches == before + 1
    for g, p in zip(got, plain):
        assert (g is None) == (p is None)
        if p is not None:
            _same(g, p)


@pytest.mark.parametrize("out_cap", [4096, 1 << 20])
@pytest.mark.parametrize("left", [False, True])
def test_join_expand_kernel_matches_plain(cuda, out_cap, left):
    rng = np.random.default_rng(47)
    ph, bh_sorted, order, pvals, bvals = _probe_inputs(
        rng, 150_000, 120_000, 30_000, True)
    lo, cnt, _, _ = J.join_probe(ph, bh_sorted, order, pvals, bvals,
                                 J.WINDOW)
    counts = cnt.clamp(min=1) if left else cnt
    plain = J.join_expand(counts, cnt, lo, order, pvals, bvals, out_cap)
    before = J.join_expand.launches
    got = J.join_expand(counts.to(cuda), cnt.to(cuda), lo.to(cuda),
                        order.to(cuda), [v.to(cuda) for v in pvals],
                        [v.to(cuda) for v in bvals], out_cap)
    assert J.join_expand.launches == before + 1
    for g, p in zip(got, plain):
        _same(g, p)


def test_subnormal_keys_hash_and_probe_as_zero(cuda):
    v = np.array([1e-310, -1e-310, 0.0, -0.0, 2.5, 1e-300])
    col = C.Column.from_numpy(v, T.DOUBLE, device="cpu")
    h = K.hash_columns([_on(col, cuda)])
    _same(h, K.hash_columns([col]))
    assert len(set(h[:4].tolist())) == 1 and h[5] != h[0]
    ph = h[:4]
    bh_sorted, order = torch.sort(h[2:3], stable=True)
    _, _, hit, _ = J.join_probe(ph, bh_sorted, order,
                                [col.values[:4].to(cuda)],
                                [col.values[2:3].to(cuda)], J.FIRST)
    assert hit.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("n", [1, 2049, 1_000_003])
@pytest.mark.parametrize("op,dtype", [
    ("add", torch.float64), ("add", torch.int64), ("add", torch.int32),
    ("min", torch.float64), ("max", torch.float64), ("min", torch.int64),
    ("max", torch.int32), ("last", torch.bool)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("segmented", [False, True])
def test_segmented_scan_kernel_matches_plain(cuda, n, op, dtype, reverse,
                                             segmented):
    rng = np.random.default_rng(n + 7)
    if dtype == torch.bool:
        x = torch.from_numpy(rng.random(n) < 0.01)
    elif dtype == torch.float64:
        v = rng.normal(0, 100, n)
        v[rng.integers(0, n, min(n, 9))] = np.nan if op != "add" else 1.0
        v[rng.integers(0, n, min(n, 9))] = np.inf
        x = torch.from_numpy(v)
    else:
        x = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, n)).to(dtype)
        x[::1001] = torch.iinfo(dtype).max
    seg = None
    if segmented:
        f = rng.random(n) < 0.02
        f[::2048] = True
        seg = torch.from_numpy(f)
    plain = S.segmented_scan(x, op, reverse, seg)
    before = S.segmented_scan.launches
    got = S.segmented_scan(x.to(cuda), op, reverse,
                           seg.to(cuda) if seg is not None else None)
    assert S.segmented_scan.launches == before + 1
    if op == "add" and dtype == torch.float64:
        _close(got, plain)
    else:
        _same(got, plain)


@pytest.mark.parametrize("mode", [K.WINDOW_FLAGS, K.FIRST_FLAGS])
def test_key_change_kernel_matches_plain(cuda, mode):
    rng = np.random.default_rng(53)
    n = 300_001
    cols = _key_columns(rng, n)
    cols[4].values[7:11] = torch.tensor([1e-310, 0.0, -1e-310, -0.0],
                                        dtype=torch.float64)
    cap = cols[0].capacity
    perm = torch.from_numpy(rng.permutation(cap))
    keys = [(c.nulls, [c.values]) for c in cols[:3]] + \
        [(None, [cols[4].values, cols[3].values, cols[5].values])]
    num_rows = torch.tensor(n - 1000)
    plain = K.key_change_flags(perm, keys, num_rows, 2, mode)
    before = K.key_change_flags.launches
    got = K.key_change_flags(perm.to(cuda),
                             [(nl.to(cuda) if nl is not None else None,
                               [v.to(cuda) for v in vs])
                              for nl, vs in keys], num_rows.to(cuda), 2,
                             mode)
    assert K.key_change_flags.launches == before + 1
    _same(got[0], plain[0])
    if mode == K.WINDOW_FLAGS:
        _same(got[1], plain[1])
    else:
        assert got[1] is None


def _window_page(rng, n, cap):
    o = rng.integers(0, 50, n).astype(np.float64)
    o[::501] = np.nan
    specs = [(T.BIGINT, rng.integers(0, 40, n)),
             (T.DOUBLE, o),
             (T.DOUBLE, rng.normal(0, 100, n)),
             (T.BIGINT, rng.integers(-500, 500, n)),
             (T.VARCHAR, rng.integers(0, 7, n).astype(np.int32))]
    cols = [C.Column.from_numpy(v, t, nulls=rng.random(n) < 0.05,
                                dictionary=(C.StringDict(list("abcdefg"))
                                            if t == T.VARCHAR else None),
                                capacity=cap, device="cpu")
            for t, v in specs]
    return C.Page.from_columns(cols, n, device="cpu")


WINDOW_SPECS = [
    W.WindowSpec("row_number", None, T.BIGINT),
    W.WindowSpec("rank", None, T.BIGINT),
    W.WindowSpec("dense_rank", None, T.BIGINT),
    W.WindowSpec("ntile", None, T.BIGINT, 4),
    W.WindowSpec("lag", 3, T.BIGINT, 2, -1),
    W.WindowSpec("lead", 4, T.VARCHAR, 1),
    W.WindowSpec("first_value", 2, T.DOUBLE),
    W.WindowSpec("nth_value", 3, T.BIGINT, 3,
                 frame=W.Frame("rows", "preceding", 2, "following", 2)),
    W.WindowSpec("sum", 2, T.DOUBLE),
    W.WindowSpec("sum", 3, T.BIGINT,
                 frame=W.Frame("rows", "preceding", 3, "preceding", 1)),
    W.WindowSpec("count", 2, T.BIGINT,
                 frame=W.Frame("range", "current", None,
                               "unbounded_following", None)),
    W.WindowSpec("count_star", None, T.BIGINT),
    W.WindowSpec("avg", 2, T.DOUBLE,
                 frame=W.Frame("rows", "current", None, "following", 5)),
    W.WindowSpec("max", 2, T.DOUBLE),
    W.WindowSpec("min", 4, T.VARCHAR,
                 frame=W.Frame("rows", "current", None,
                               "unbounded_following", None)),
    W.WindowSpec("min", 2, T.DOUBLE,
                 frame=W.Frame("rows", "preceding", 3, "following", 3)),
    W.WindowSpec("max", 3, T.BIGINT,
                 frame=W.Frame("rows", "following", 1, "following", 4)),
]


@pytest.mark.parametrize("cap,n", [(4096, 3001), (1 << 20, 1_000_003)])
def test_window_page_on_the_card_matches_the_cpu(cuda, cap, n):
    """K7, K8 and K9 together (window_page's every launch on the card)
    against the plain versions on the CPU, spec by spec."""
    rng = np.random.default_rng(cap)
    page = _window_page(rng, n, cap)
    on = C.Page(tuple(_on(c, cuda) for c in page.columns),
                page.num_rows.to(cuda), page.names)
    keys = [K.SortKey(1), K.SortKey(3, ascending=False, nulls_first=True)]
    plain = W.window_page(page, (0,), keys, WINDOW_SPECS)
    before = W.window_frame.launches
    got = W.window_page(on, (0,), keys, WINDOW_SPECS)
    assert W.window_frame.launches == before + len(WINDOW_SPECS)
    base = len(page.columns)
    for i, spec in enumerate(WINDOW_SPECS):
        g, p = got.columns[base + i], plain.columns[base + i]
        _same(g.nulls, p.nulls)
        if spec.kind in ("sum", "avg") and spec.output_type == T.DOUBLE:
            _close(g.values, p.values)
        else:
            _same(g.values, p.values)


def test_wrappers_refuse_mixed_devices(cuda):
    with pytest.raises(ValueError):
        S.segment_reduce(torch.zeros(4, dtype=torch.float64, device=cuda),
                         None, torch.zeros(1, dtype=torch.int64),
                         torch.ones(1, dtype=torch.int64))
    with pytest.raises(TypeError):
        C.compact_indices(torch.ones(4, dtype=torch.bool, device=cuda),
                          torch.tensor(2))


def test_engine_on_the_card_matches_the_cpu(cuda):
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    conn = TpchConnector(0.01)
    gpu, cpu = LocalEngine(conn), LocalEngine(conn, device="cpu")
    assert gpu.device.type == "cuda"
    for sql, ordered in [
        ("select l_returnflag, l_linestatus, sum(l_quantity), "
         "avg(l_discount), count(*) from lineitem "
         "where l_shipdate <= date '1998-09-02' "
         "group by l_returnflag, l_linestatus "
         "order by l_returnflag, l_linestatus", True),
        ("select sum(l_extendedprice * l_discount) from lineitem "
         "where l_quantity < 24", False),
        ("select l_orderkey, sum(l_quantity) from lineitem "
         "group by l_orderkey having sum(l_quantity) > 250", False),
        ("select c_count, count(*) from (select c_custkey, "
         "count(o_orderkey) as c_count from customer left outer join "
         "orders on c_custkey = o_custkey and o_comment not like "
         "'%special%requests%' group by c_custkey) as c_orders "
         "group by c_count", False),
        ("select o_orderpriority, count(*) from orders where exists "
         "(select * from lineitem where l_orderkey = o_orderkey and "
         "l_commitdate < l_receiptdate) group by o_orderpriority", False),
        ("select o_custkey, o_orderkey, sum(o_totalprice) over (partition "
         "by o_custkey order by o_orderdate) from orders", False),
        ("select l_returnflag, l_linestatus, count(*) from lineitem "
         "group by rollup(l_returnflag, l_linestatus)", False),
        ("select l_returnflag, count(*), count(distinct l_suppkey) "
         "from lineitem group by 1", False),
        ("select n_name from nation union all select r_name from region",
         False),
    ]:
        a, b = gpu.execute_sql(sql), cpu.execute_sql(sql)
        if not ordered:
            key = lambda r: tuple((v is None, v) for v in r)  # noqa: E731
            a, b = sorted(a, key=key), sorted(b, key=key)
        assert len(a) == len(b) and a
        for ra, rb in zip(a, b):
            for x, y in zip(ra, rb):
                if isinstance(y, float):
                    assert abs(x - y) <= RTOL * max(abs(y), 1.0)
                else:
                    assert x == y
