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
int64 sums, min and max, HyperLogLog registers, present sums and counts
(sums of powers of two, exact in any order) and order statistics exact
(K13's bit for bit, NaN payloads and signed zeros included); float64 sums
within 1e-9 relative (the kernels sum in another order than the plain
versions).
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch import native
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


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _direct_agg_case(rng, case, cap, n):
    """(keys, domains, inputs, mask, num_rows) of one K1 card case."""
    none = torch.zeros(cap, dtype=torch.bool)
    f64 = [(torch.from_numpy(rng.random(cap) * s), none, A.WANT_SUM)
           for s in (50.0, 1e5, 0.1)]
    if case == "q01_skew":
        pair = rng.choice(4, cap, p=[0.25, 0.25, 0.495, 0.005])
        keys = [(torch.from_numpy(np.array([0, 2, 1, 1], np.int32)[pair]),
                 none),
                (torch.from_numpy(np.array([0, 0, 1, 0], np.int32)[pair]),
                 none)]
        return keys, [3, 2], f64, torch.from_numpy(rng.random(cap) < 0.986), n
    if case == "global":
        return [], [], f64[:1], torch.from_numpy(rng.random(cap) < 0.019), n
    keys = [(torch.from_numpy(rng.integers(0, 3, cap).astype(np.int32)),
             none),
            (torch.from_numpy(rng.integers(0, 2, cap).astype(np.int32)),
             none)]
    mask = torch.from_numpy(rng.random(cap) < 0.986)
    if case == "64x12":
        keys = [(torch.from_numpy(rng.integers(0, 7, cap).astype(np.int32)),
                 torch.from_numpy(rng.random(cap) < 0.05))
                for _ in range(2)]
        inputs = []
        for j in range(12):
            v = (rng.normal(0, 1e3, cap), rng.integers(-10**12, 10**12, cap),
                 rng.integers(-10**6, 10**6, cap).astype(np.int32))[j % 3]
            inputs.append((torch.from_numpy(v),
                           torch.from_numpy(rng.random(cap) < 0.1),
                           A.WANT_SUM | A.WANT_MINMAX))
        return keys, [7, 7], inputs, mask, n
    if case == "all_null":
        ones = torch.ones(cap, dtype=torch.bool)
        return keys, [3, 2], [(f64[0][0], ones, A.WANT_SUM | A.WANT_MINMAX),
                              (torch.from_numpy(rng.integers(0, 9, cap)),
                               ones, A.WANT_SUM)] + f64[1:], mask, n
    if case == "num_rows0":
        return keys, [3, 2], f64, mask, 0
    if case == "mask_false":
        return keys, [3, 2], f64, torch.zeros(cap, dtype=torch.bool), n
    if case == "nan_minmax":
        v = rng.normal(0, 1e3, cap)
        v[::1000] = np.nan
        w = np.where(keys[0][0].numpy() == 0, np.nan, v)
        return keys, [3, 2], [
            (torch.from_numpy(v), none, A.WANT_SUM | A.WANT_MINMAX),
            (torch.from_numpy(w), none, A.WANT_MINMAX)], mask, n
    assert case == "sum128_big"
    lanes = _wide_lanes_np(rng, n)
    lanes = tuple(torch.cat([x, torch.zeros(cap - n, dtype=torch.int64)])
                  for x in lanes)
    mask[n - 2:n] = True
    return keys, [3, 2], [
        (lanes, none, A.WANT_SUM128),
        (torch.from_numpy(rng.integers(-2**62, 2**62, cap)), none,
         A.WANT_SUM128 | A.WANT_SUM),
        (torch.from_numpy(rng.integers(0, 11, cap)), none, A.WANT_SUM128)], \
        mask, n


@pytest.mark.parametrize("case", ["q01_skew", "global", "64x12", "all_null",
                                  "num_rows0", "mask_false", "nan_minmax",
                                  "sum128_big"])
def test_direct_agg_cases_match_plain_and_repeat(cuda, case):
    """K1 at the phase-3 cases of chip_smoke.py (1M rows): counts, int64
    and limb sums, min and max exact, float sums within RTOL; two launches
    equal bit for bit."""
    rng = np.random.default_rng(21)
    cap, n = 1 << 20, 1_000_003
    keys, domains, inputs, mask, num_rows = _direct_agg_case(rng, case, cap,
                                                             n)
    args = (cap, torch.tensor(num_rows), keys, domains, inputs, mask)
    plain = A.direct_agg(*args)
    on = (cap, args[1].to(cuda), [(c.to(cuda), nl.to(cuda)) for c, nl in keys],
          domains, [(tuple(x.to(cuda) for x in v) if isinstance(v, tuple)
                     else v.to(cuda), nl.to(cuda), w) for v, nl, w in inputs],
          mask.to(cuda))
    got, again = A.direct_agg(*on), A.direct_agg(*on)
    for name in got:
        _same(_bits(got[name]), _bits(again[name]))
    for name in ("rows", "cnt"):
        _same(got[name], plain[name])
    for j, (v, _nl, want) in enumerate(inputs):
        if want & A.WANT_SUM128:
            _same(got["lsum"][j], plain["lsum"][j])
        if isinstance(v, tuple):
            continue
        if want & A.WANT_SUM:
            _close(got["fsum"][j], plain["fsum"][j])
            if v.dtype != torch.float64:
                _same(got["isum"][j], plain["isum"][j])
        if want & A.WANT_MINMAX:
            for name in ("mn", "mx"):
                g, p = got[name][j], plain[name][j]
                if v.dtype == torch.float64:
                    g, p = g.view(torch.float64), p.view(torch.float64)
                _same(g, p)


_TILE = native.COMPACT_TILE


@pytest.mark.parametrize("n,num_rows,p,offset", [
    (1, None, 0.37, 0), (2047, None, 0.37, 0), (2049, 1000, 0.37, 0),
    (5_000_001, 4_999_999, 0.37, 0), (100_000, 0, 0.37, 0),
    (300_000, None, 1.0, 0), (300_000, None, 0.0, 0),       # all, none
    (_TILE - 1, None, 0.5, 0), (_TILE, None, 0.5, 0),
    (_TILE + 1, None, 0.5, 0), (300 * _TILE - 1, None, 0.2, 0),
    (300 * _TILE + 1, 200 * _TILE + 5, 0.2, 0),
    (1_000_003, None, 0.0004, 0),                 # not a multiple of 16
    (1_000_003, None, 0.37, 3)])                  # flags not 16-aligned
def test_compact_indices_kernel_matches_plain(cuda, n, num_rows, p, offset):
    rng = np.random.default_rng(n + offset)
    keep = torch.from_numpy(rng.random(n + offset) < p)[offset:]
    nr = None if num_rows is None else torch.tensor(num_rows)
    perm, count = C.compact_indices(keep, nr)
    before = C.compact_indices.launches
    # on the card, the flags start `offset` bytes into their storage
    on_card = torch.cat([torch.zeros(offset, dtype=torch.bool),
                         keep]).to(cuda)[offset:]
    kp, kc = C.compact_indices(on_card, None if nr is None else nr.to(cuda))
    assert C.compact_indices.launches == before + 1
    _same(kp, perm)
    _same(kc, count)


_SMALL = native.SEGMENT_SMALL_MAX
_WARP = native.SEGMENT_WARP_MAX
_PIECE = native.SEGMENT_PIECE

#: segment lengths reaching each of K3's classes (a thread, a warp, pieces
#: of a block each) and their boundaries
SEGMENT_LENGTHS = {
    "classes": [0, 1, _SMALL - 1, _SMALL, _SMALL + 1, _WARP - 1, _WARP,
                _WARP + 1, _PIECE - 1, _PIECE, _PIECE + 1, 3 * _PIECE + 7],
    "860000": [860_000],
    "q18_mix": "q18",
    "short_mix": "short",
    # every range starts at row 0: more pieces and listed segments than
    # disjoint segments can make, which the scratch lists are sized for
    "overlapping": [2500] * 40,
}


def _segments(rng, case, pad=37):
    """starts/ends (int64) of the case's contiguous segments, then `pad`
    empty, clamped and past-the-end ranges; the page's row count."""
    lengths = SEGMENT_LENGTHS[case]
    if lengths == "q18":
        lengths = rng.integers(1, 8, 150_000)
    elif lengths == "short":
        lengths = rng.integers(0, 40, 20_000)
    lengths = np.asarray(lengths, dtype=np.int64)
    ends = np.cumsum(lengths)
    n = int(ends[-1]) + 13
    k = np.arange(pad)
    starts = np.concatenate([ends - lengths,
                             np.where(k % 3 == 0, n + 4, n - 9 * (k % 2))])
    ends = np.concatenate([ends, np.where(k % 3 == 1, n - 20, n + 1)])
    if case == "overlapping":
        starts[:len(lengths)] = 0
    return torch.from_numpy(starts), torch.from_numpy(ends), n


def _segment_values(rng, dtype, n):
    if dtype == torch.float64:
        vals = torch.from_numpy(rng.normal(0, 100, n))
        vals[::53] = float("nan")
    elif dtype == torch.int64:
        # near the wrap: sums of a few rows pass 2^63
        vals = torch.from_numpy(rng.integers(2 ** 62, 2 ** 63 - 1, n)
                                * rng.choice([-1, 1], n))
    else:
        vals = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n)
                                .astype(np.int32))
    return vals


@pytest.mark.parametrize("case", list(SEGMENT_LENGTHS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.int32])
def test_segment_reduce_kernel_matches_plain(cuda, dtype, case):
    rng = np.random.default_rng(7)
    starts, ends, n = _segments(rng, case)
    vals = _segment_values(rng, dtype, n)
    live = torch.from_numpy(rng.random(n) < 0.9)
    want = S.WANT_SUM | S.WANT_MINMAX
    plain = S.segment_reduce(vals, live, starts, ends, want)
    before = S.segment_reduce.launches
    got = S.segment_reduce(vals.to(cuda), live.to(cuda), starts.to(cuda),
                           ends.to(cuda), want)
    assert S.segment_reduce.launches == before + 1
    for name in ("cnt", "min", "max") + (("isum",) if dtype != torch.float64
                                         else ()):
        _same(got[name], plain[name])
    if dtype == torch.float64:
        _same(torch.isnan(got["fsum"]), torch.isnan(plain["fsum"]))
        ok = ~torch.isnan(plain["fsum"])
        _close(got["fsum"].cpu()[ok], plain["fsum"][ok])
    else:
        _close(got["fsum"], plain["fsum"])
    # no live mask: every row counts
    got = S.segment_reduce(vals.to(cuda), None, starts.to(cuda),
                           ends.to(cuda), S.WANT_SUM)
    _same(got["cnt"], S.segment_reduce(vals, None, starts, ends)["cnt"])


@pytest.mark.parametrize("case", ["classes", "860000"])
def test_segment_reduce_sums_repeat_bit_for_bit(cuda, case):
    """Two launches give the same float64 sums bit for bit, whichever
    blocks take which pieces."""
    rng = np.random.default_rng(8)
    starts, ends, n = _segments(rng, case)
    vals = torch.from_numpy(rng.normal(0, 1e6, n)).to(cuda)
    live = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    args = (vals, live, starts.to(cuda), ends.to(cuda), S.WANT_SUM)
    a = S.segment_reduce(*args)["fsum"]
    b = S.segment_reduce(*args)["fsum"]
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


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


def _probe_case(rng, case):
    """(ph, bh_sorted, order, pvals, bvals, modes) of one K5 card case."""
    if case in ("pow2_minus_1", "pow2_plus_1"):
        nb = (1 << 20) + (1 if case == "pow2_plus_1" else -1)
        args = _probe_inputs(rng, 262_144, nb, nb // 2, True)
        return args + ([J.WINDOW, J.FIRST, J.LAST, J.ALL],)
    if case in ("empty_build", "sparse_build", "sparse_build_2000",
                "dead_probes"):
        ph, bh_sorted, order, pvals, bvals = _probe_inputs(
            rng, 262_144, 200_000, 300_000, True)
        if case == "empty_build":
            bh_sorted = torch.full_like(bh_sorted, -2)
        elif case.startswith("sparse_build"):
            # 64 or 2,000 live rows, fewer than one in 65: no sampled
            # position is live, so the directory is one bucket
            live = 2_000 if case.endswith("2000") else 64
            bh = bh_sorted[torch.argsort(order)]
            keep = torch.zeros_like(bh, dtype=torch.bool)
            keep[torch.from_numpy(rng.choice(bh.shape[0], live,
                                             replace=False))] = True
            bh_sorted, order = torch.sort(torch.where(keep, bh, -2),
                                          stable=True)
        else:
            ph = torch.full_like(ph, -1)
        return ph, bh_sorted, order, pvals, bvals, [J.WINDOW, J.FIRST,
                                                    J.LAST, J.ALL]
    # one window of 100,000 equal hashes with differing keys; the probe
    # keys lie among the window's first (FIRST) or last (LAST) 32 rows
    nb, width = 131_072, 100_000
    bk = torch.from_numpy(rng.permutation(nb).astype(np.int64) * 7 + 3)
    bh = torch.full((nb,), 1 << 61, dtype=torch.int64)
    bh[width:] = -2
    bh_sorted, order = torch.sort(bh, stable=True)
    edge = order[nb - width:nb - width + 32] if case == "window_first" \
        else order[nb - 32:]
    pk = bk[edge[torch.from_numpy(rng.integers(0, 32, 65_536))]]
    ph = torch.full((65_536,), 1 << 61, dtype=torch.int64)
    ph[::9] = -1
    modes = [J.WINDOW, J.FIRST] if case == "window_first" else [J.LAST]
    return ph, bh_sorted, order, [pk], [bk], modes


@pytest.mark.parametrize("case", ["pow2_minus_1", "pow2_plus_1",
                                  "empty_build", "sparse_build",
                                  "sparse_build_2000", "dead_probes",
                                  "window_first", "window_last"])
def test_join_probe_cases_match_plain_and_repeat(cuda, case):
    """K5 at the phase-3 cases of chip_smoke.py: every output exactly the
    plain version's, two launches equal."""
    rng = np.random.default_rng(44)
    ph, bh_sorted, order, pvals, bvals, modes = _probe_case(rng, case)
    on = [t.to(cuda) for t in (ph, bh_sorted, order)]
    pv, bv = [v.to(cuda) for v in pvals], [v.to(cuda) for v in bvals]
    for mode in modes:
        plain = J.join_probe(ph, bh_sorted, order, pvals, bvals, mode)
        got = J.join_probe(*on, pv, bv, mode)
        again = J.join_probe(*on, pv, bv, mode)
        for g, a, p in zip(got, again, plain):
            assert (g is None) == (p is None)
            if p is not None:
                _same(g, p)
                _same(a, p)


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


def _expand_case(rng, case):
    """(counts, wcnt, lo, order, pvals, bvals) of one K6 card case: a
    probe side of 2^20 rows, one with 2^20 pairs and about 1% with 1-3
    (skewed) or none with any (all_zero), a few LEFT null extensions;
    or 200,000 probe rows over two key lanes, int32 codes against int64
    keys and float64 keys with NaN, +-0.0 and subnormals (mixed_lanes)."""
    if case in ("skewed", "all_zero"):
        n, nb = 1 << 20, 1 << 21
        wc, lo = np.zeros(n, np.int64), np.zeros(n, np.int64)
        if case == "skewed":
            some = rng.random(n) < 0.01
            wc = np.where(some, rng.integers(1, 4, n), 0)
            lo = np.where(some, rng.integers(0, nb - 4, n), 0)
            wc[n // 3], lo[n // 3] = 1 << 20, nb // 4
        counts = np.where(rng.random(n) < 0.002, np.maximum(wc, 1), wc)
        pvals = [torch.from_numpy(rng.integers(0, 4, n))]
        bvals = [torch.from_numpy(rng.integers(0, 4, nb))]
    else:
        n, nb = 200_000, 150_000
        wc = rng.integers(0, 6, n)
        counts = np.where(rng.random(n) < 0.1, np.maximum(wc, 1), wc)
        lo = rng.integers(-2, nb + 2, n)
        special = np.array([0.0, -0.0, 1e-310, -1e-310, np.nan, 1.5, 2.5])
        pvals = [torch.from_numpy(rng.choice(special, n)),
                 torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))]
        bvals = [torch.from_numpy(rng.choice(special, nb)),
                 torch.from_numpy(rng.integers(0, 3, nb))]
    order = rng.permutation(nb)
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (counts, wc, lo, order)) + (pvals, bvals)


@pytest.mark.parametrize("cap_vs_total", ["below", "at", "above"])
@pytest.mark.parametrize("case", ["skewed", "all_zero", "mixed_lanes"])
def test_join_expand_cases_match_plain_and_repeat(cuda, case, cap_vs_total):
    """K6 on skewed and all-zero probe sides and on mixed key lanes, at a
    capacity below, at and above the total: every output exactly the
    plain version's, two launches equal, one launch a call."""
    rng = np.random.default_rng(48)
    counts, wcnt, lo, order, pvals, bvals = _expand_case(rng, case)
    total = int(counts.sum())
    out_cap = {"below": max(total // 2, 1), "at": max(total, 1),
               "above": total + 3001}[cap_vs_total]
    plain = J.join_expand(counts, wcnt, lo, order, pvals, bvals, out_cap)
    on = [t.to(cuda) for t in (counts, wcnt, lo, order)]
    pv, bv = [v.to(cuda) for v in pvals], [v.to(cuda) for v in bvals]
    before = J.join_expand.launches
    got = J.join_expand(*on, pv, bv, out_cap)
    again = J.join_expand(*on, pv, bv, out_cap)
    assert J.join_expand.launches == before + 2
    assert int(got[3]) == total
    for g, a, p in zip(got, again, plain):
        _same(g, p)
        _same(a, p)


def test_join_expand_no_probe_rows(cuda):
    """n = 0: a total of 0 and every slot dead (0, 0, False)."""
    z = torch.zeros(0, dtype=torch.int64, device=cuda)
    order = torch.arange(300, dtype=torch.int64, device=cuda)
    pidx, bidx, bvalid, total = J.join_expand(
        z, z, z, order, [z], [order], 5000)
    torch.cuda.synchronize()
    assert int(total) == 0
    assert not bool(pidx.any()) and not bool(bidx.any())
    assert not bool(bvalid.any())


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


#: K7's sizes: one row, either side of a thread's 16 rows and of a
#: block's tile of 4096 rows, 513 tiles (more than one wave of blocks on an
#: H100), and one past 2^24
SCAN_SIZES = [1, 17, 2049, 4095, 4096, 4097, 1_000_003, 512 * 4096 + 1,
              2 ** 24 + 1]


def _scan_input(n, op, dtype, segmented):
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
    return x, seg


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("op,dtype", [
    ("add", torch.float64), ("add", torch.int64), ("add", torch.int32),
    ("min", torch.float64), ("max", torch.float64), ("min", torch.int64),
    ("max", torch.int32), ("last", torch.bool)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("segmented", [False, True])
def test_segmented_scan_kernel_matches_plain(cuda, n, op, dtype, reverse,
                                             segmented):
    x, seg = _scan_input(n, op, dtype, segmented)
    x = x.to(cuda)
    seg = seg.to(cuda) if seg is not None else None
    plain = S._segmented_scan_plain(x, op, reverse, seg)
    before = S.segmented_scan.launches
    got = S.segmented_scan(x, op, reverse, seg)
    assert S.segmented_scan.launches == before + 1
    if op == "add" and dtype == torch.float64:
        _close(got, plain)
    else:
        _same(got, plain)


@pytest.mark.parametrize("n", [4097, 1_000_003, 2 ** 24 + 1])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("segmented", [False, True])
def test_segmented_scan_float_sums_repeat_bit_for_bit(cuda, n, reverse,
                                                      segmented):
    x, seg = _scan_input(n, "add", torch.float64, segmented)
    x = x.to(cuda)
    seg = seg.to(cuda) if seg is not None else None
    a = S.segmented_scan(x, "add", reverse, seg)
    b = S.segmented_scan(x, "add", reverse, seg)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("n,flags", [
    (1, "none"), (1, "all"), (4097, "none"), (4097, "all"),
    (512 * 4096 + 1, "random"), (2_097_152, "padding"),
    (2 ** 24 + 1, "random")])
def test_window_bounds_kernel_matches_plain(cuda, n, flags):
    rng = np.random.default_rng(n + 11)
    if flags == "none":
        part = peer = np.zeros(n, bool)
    elif flags == "all":
        part = peer = np.ones(n, bool)
    else:
        part = rng.random(n) < 0.02
        peer = part | (rng.random(n) < 0.2)
        part[0] = peer[0] = True
        if flags == "padding":
            # a page of 1.5M valid rows: padding starts a partition and
            # holds no other start
            num_rows = 1_500_000
            part[num_rows] = peer[num_rows] = True
            part[num_rows + 1:] = peer[num_rows + 1:] = False
    part = torch.from_numpy(part).to(cuda)
    peer = torch.from_numpy(peer).to(cuda)
    plain = S._window_bounds_plain(part, peer)
    before = list(S.segmented_scan.mode_launches)
    got = S.window_bounds(part, peer)
    assert S.segmented_scan.mode_launches[3] == before[3] + 1
    assert S.segmented_scan.mode_launches[:3] == before[:3]
    for g, w in zip(got, plain):
        _same(g, w)


def _change_keys(rng, n, layout):
    """(keys, n_part_keys) over seeded columns: "mixed" is a null lane and
    value per key plus a three-lane key without nulls; "one" a single
    int64 lane; "wide" 32 lanes; "no nulls" two keys whose null lanes and
    a bool value lane hold no true value (lanes the kernel skips); a
    dtype name one key of that dtype."""
    m = max(n, 16)
    cols = _key_columns(rng, m)
    cols[4].values[7:11] = torch.tensor([1e-310, 0.0, -1e-310, -0.0],
                                        dtype=torch.float64)
    if layout == "mixed":
        keys = [(c.nulls, [c.values]) for c in cols[:3]] + \
            [(None, [cols[4].values, cols[3].values, cols[5].values])]
        npart = 2
    elif layout == "one":
        keys, npart = [(None, [torch.from_numpy(rng.integers(0, 3, m))])], 0
    elif layout == "wide":
        lanes = [torch.from_numpy(rng.integers(0, 2, m)) for _ in range(32)]
        keys, npart = [(None, lanes[:12]), (None, lanes[12:])], 1
    elif layout == "no nulls":
        none = torch.zeros(m, dtype=torch.bool)
        keys = [(none, [cols[3].values]), (none, [cols[1].values]),
                (None, [none])]
        npart = 1
    else:
        c = {"float64": cols[4], "float32": cols[5], "int64": cols[0],
             "int32": cols[3], "bool": cols[2]}[layout]
        keys, npart = [(c.nulls, [c.values])], 0
    return [(nl[:n] if nl is not None else None, [v[:n] for v in vs])
            for nl, vs in keys], npart


@pytest.mark.parametrize("mode", [K.WINDOW_FLAGS, K.FIRST_FLAGS])
@pytest.mark.parametrize("n,layout,order", [
    (300_001, "mixed", "random"), (1, "mixed", "random"),
    (300_001, "mixed", "identity"), (300_001, "one", "random"),
    (100_003, "wide", "random"), (300_001, "no nulls", "random"),
    (300_001, "no nulls", "sorted"), (300_001, "float64", "random"),
    (300_001, "float32", "random"), (300_001, "int64", "random"),
    (300_001, "int32", "sorted"), (300_001, "bool", "random")])
def test_key_change_kernel_matches_plain(cuda, mode, n, layout, order):
    rng = np.random.default_rng(53)
    keys, npart = _change_keys(rng, n, layout)
    if order == "identity":
        perm = torch.arange(n)
    elif order == "sorted":
        perm = K.lex_perm([v for _nl, vs in keys for v in vs])
    else:
        perm = torch.from_numpy(rng.permutation(n))
    num_rows = torch.tensor(max(n - 1000, n // 2))
    plain = K.key_change_flags(perm, keys, num_rows, npart, mode)
    before = K.key_change_flags.launches
    got = K.key_change_flags(perm.to(cuda),
                             [(nl.to(cuda) if nl is not None else None,
                               [v.to(cuda) for v in vs])
                              for nl, vs in keys], num_rows.to(cuda), npart,
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


#: K9's other routes and classes: both-bounded min/max frames folded in
#: shared memory (up to 64 rows wide) and from the sparse table (wider, or a
#: RANGE frame of the row's peers), every frame-bound source, defaults
K9_SPECS = WINDOW_SPECS + [
    W.WindowSpec("min", 2, T.DOUBLE,
                 frame=W.Frame("rows", "preceding", 31, "following", 32)),
    W.WindowSpec("max", 3, T.BIGINT,
                 frame=W.Frame("rows", "preceding", 70, "preceding", 3)),
    W.WindowSpec("min", 2, T.DOUBLE,
                 frame=W.Frame("rows", "preceding", 1000, "following", 1000)),
    W.WindowSpec("max", 4, T.VARCHAR,
                 frame=W.Frame("rows", "following", 1, "following", 100)),
    W.WindowSpec("min", 2, T.DOUBLE,
                 frame=W.Frame("range", "current", None, "current", None)),
    W.WindowSpec("max", 3, T.BIGINT,
                 frame=W.Frame("rows", "following", 2, "preceding", 2)),
    W.WindowSpec("last_value", 3, T.BIGINT,
                 frame=W.Frame("range", "current", None, "current", None)),
    W.WindowSpec("first_value", 4, T.VARCHAR,
                 frame=W.Frame("rows", "preceding", 3, "preceding", 1)),
    W.WindowSpec("count", 2, T.BIGINT,
                 frame=W.Frame("rows", "unbounded_preceding", None,
                               "following", 2)),
    W.WindowSpec("avg", 3, T.DOUBLE,
                 frame=W.Frame("range", "current", None,
                               "unbounded_following", None)),
    W.WindowSpec("sum", 3, T.BIGINT,
                 frame=W.Frame("rows", "preceding", 2, "unbounded_following",
                               None)),
    W.WindowSpec("max", 2, T.DOUBLE,
                 frame=W.Frame("rows", "unbounded_preceding", None,
                               "unbounded_following", None)),
    W.WindowSpec("lead", 2, T.DOUBLE, 3, 0.5),
    W.WindowSpec("lag", 1, T.DOUBLE, 1),
    # NaN in the frame: the extreme is NaN on both routes
    W.WindowSpec("max", 1, T.DOUBLE,
                 frame=W.Frame("rows", "preceding", 5, "following", 5)),
    W.WindowSpec("min", 1, T.DOUBLE,
                 frame=W.Frame("rows", "preceding", 100, "following", 100)),
]

#: case -> (capacity, rows, partition fields, identity permutation)
K9_CASES = {
    "random_perm": (4096, 3001, (0,), False),
    "identity_perm": (4096, 3001, (0,), True),
    "one_row_partitions": (4096, 4000, (2,), False),
    "one_partition": (8192, 6000, (), False),
    "n1": (256, 1, (0,), False),
    "large": (1 << 20, 1_000_003, (0,), False),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_window_frame_kernel_matches_plain_and_repeats(cuda, case):
    """K9 on every kind and frame-bound source, both min/max routes, with
    the sort's permutation and with the identity: exact against the plain
    version on the card (float sums and averages within RTOL), one launch
    a call, and two launches equal bit for bit."""
    import dataclasses
    cap, n, parts, ident = K9_CASES[case]
    rng = np.random.default_rng(cap + n)
    page = _window_page(rng, n, cap)
    on = C.Page(tuple(_on(c, cuda) for c in page.columns),
                page.num_rows.to(cuda), page.names)
    sw = W.sort_window(on, parts, [K.SortKey(1),
                                   K.SortKey(3, ascending=False,
                                             nulls_first=True)])
    if ident:
        sw = dataclasses.replace(sw, perm=torch.arange(
            cap, dtype=torch.int64, device=cuda))
    for spec in K9_SPECS:
        fi = W.frame_inputs(on, sw, spec)
        args = (spec.kind, fi.frame, fi.iparams, fi.dparams, sw.perm,
                on.num_rows, sw.ps, sw.pe, sw.qs, sw.qe, fi.vals, fi.nulls,
                fi.aux_i, fi.aux_v, fi.out_dtype)
        before = W.window_frame.launches
        got, again = W.window_frame(*args), W.window_frame(*args)
        torch.cuda.synchronize()
        assert W.window_frame.launches == before + 2
        plain = W._window_frame_plain(*args)
        _same(got[1], plain[1])
        _same(again[1], got[1])
        if got[0].dtype == torch.float64:
            _same(again[0].view(torch.int64), got[0].view(torch.int64))
        else:
            _same(again[0], got[0])
        if spec.kind in ("sum", "avg") and spec.output_type == T.DOUBLE:
            _close(got[0], plain[0])
        else:
            _same(got[0], plain[0])


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


# -- DECIMAL(38): K10 and the 128-bit sum modes of K1 and K3 ---------------

def _wide_lanes_np(rng, n):
    """Four int64 limb lanes of n values over +-(10^38-1) (log-uniform
    magnitudes), the edge rows first: 0, +-1, +-(10^38-1), ties and
    products around 2^127, then 2 x 9.9e37 and -2 x 9.9e37 held in
    denormalized lanes (sums past 2^127)."""
    edge = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 15, -25, 2 ** 63,
            -(2 ** 64), 10 ** 19 + 5]
    digits = rng.integers(1, 39, n)
    vals = edge + [int(rng.integers(0, 10 ** 18)) * 10 ** 20
                   + int(rng.integers(0, 10 ** 18)) for _ in
                   range(n - len(edge))]
    vals = [v % 10 ** int(d) if i >= len(edge) else v
            for i, (v, d) in enumerate(zip(vals, digits))]
    vals = [-v if s and i >= len(edge) else v for i, (v, s) in
            enumerate(zip(vals, rng.integers(0, 2, n)))]
    m = 0xFFFFFFFF
    lanes = [np.array([v >> 96 for v in vals], np.int64),
             np.array([(v >> 64) & m for v in vals], np.int64),
             np.array([(v >> 32) & m for v in vals], np.int64),
             np.array([v & m for v in vals], np.int64)]
    big = 99 * 10 ** 36
    for i, v in ((n - 2, 2 * big), (n - 1, -2 * big)):
        half = [v // 2 >> 96, (v // 2 >> 64) & m, (v // 2 >> 32) & m,
                v // 2 & m]
        for q in range(4):
            lanes[q][i] = 2 * half[q]
    return [torch.from_numpy(x) for x in lanes]


def _exact(lanes, rows=None):
    """Exact python ints of lanes (any representation)."""
    from presto_tpu_torch.data.int128 import to_python_int
    host = [x.cpu().numpy() for x in lanes]
    idx = range(len(host[0])) if rows is None else rows
    return [to_python_int(host, i) for i in idx]


@pytest.mark.parametrize("op,xw,yw,xsh,ysh", [
    ("rescale", True, None, 4, 0), ("rescale", True, None, -3, 0),
    ("rescale", False, None, 20, 0), ("rescale", True, None, -21, 0),
    ("add", True, True, 0, 2), ("subtract", True, False, 2, 0),
    ("multiply", False, False, 0, 0), ("multiply", True, False, 0, 0),
    ("multiply", True, True, 0, 0), ("compare", True, True, 0, 1),
    ("compare", False, True, 3, 0), ("negate", True, None, 0, 0),
    ("abs", True, None, 0, 0), ("to_double", True, None, 0, 0),
    ("to_int64", True, None, -2, 0)])
def test_int128_kernel_matches_plain(cuda, op, xw, yw, xsh, ysh):
    from presto_tpu_torch.data import int128 as I
    rng = np.random.default_rng(11)
    n = 200_003
    wide_x, wide_y = _wide_lanes_np(rng, n), _wide_lanes_np(rng, n)
    narrow = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
    if op == "multiply" and yw:
        # one factor of at most 19 digits: products on both sides of 2^127
        wide_y = list(I.from_int64(narrow))
    x = tuple(wide_x) if xw else narrow
    y = None if yw is None else (tuple(wide_y) if yw else narrow.flip(0))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    zero = torch.from_numpy(rng.random(n) < 0.05)
    kw = dict(x_shift=xsh, y_shift=ysh, valid=valid, zero=zero, scale=3,
              lo=-2 ** 40, hi=2 ** 40, row_flags=True)
    p_out, p_err, p_rows = I.int128_op(op, x, y, **kw)

    def on(v):
        return tuple(t.to(cuda) for t in v) if isinstance(v, tuple) \
            else v.to(cuda)
    before = I.int128_op.launches
    g_out, g_err, g_rows = I.int128_op(
        op, on(x), None if y is None else on(y), **{
            **kw, "valid": valid.to(cuda), "zero": zero.to(cuda)})
    assert I.int128_op.launches == before + 1
    _same(g_rows, p_rows)
    _same(g_err, p_err)
    ok = np.flatnonzero(p_rows.numpy() == 0)
    if isinstance(p_out, tuple):
        assert _exact(g_out, ok) == _exact(p_out, ok)
        if op in ("negate", "abs", "rescale") and g_out[0].is_cuda:
            # the kernel writes normalized limbs
            norm = I.normalize(tuple(t.cpu() for t in g_out))
            _same(torch.stack(norm), torch.stack([t.cpu() for t in g_out]))
    elif op == "to_double":
        _close(g_out, p_out)
    else:
        _same(g_out.cpu()[ok], p_out[ok])


def test_direct_agg_sum128_mode_matches_plain(cuda):
    rng = np.random.default_rng(12)
    cap, n = 1 << 20, 1_000_003
    keys = [(torch.from_numpy(rng.integers(0, 5, cap).astype(np.int32)),
             torch.from_numpy(rng.random(cap) < 0.1))]
    lanes = _wide_lanes_np(rng, cap)
    inputs = [
        (tuple(lanes), torch.from_numpy(rng.random(cap) < 0.1),
         A.WANT_SUM128),
        (torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, cap)),
         torch.from_numpy(rng.random(cap) < 0.2),
         A.WANT_SUM128 | A.WANT_SUM | A.WANT_MINMAX),
        (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, cap)
                          .astype(np.int32)), None, A.WANT_SUM128),
        (torch.from_numpy(rng.normal(0, 1, cap)), None, A.WANT_SUM)]
    inputs = inputs * 4                 # 16 inputs: more than one chunk
    mask = torch.from_numpy(rng.random(cap) < 0.8)
    args = (cap, torch.tensor(n), keys, [5], inputs, mask)
    plain = A.direct_agg(*args)
    before = (A.direct_agg.launches, A.direct_agg.sum128_launches)
    got = A.direct_agg(
        cap, args[1].to(cuda), [(c.to(cuda), nl.to(cuda)) for c, nl in keys],
        [5], [(tuple(t.to(cuda) for t in v) if isinstance(v, tuple)
               else v.to(cuda), None if nl is None else nl.to(cuda), w)
              for v, nl, w in inputs], mask.to(cuda))
    launches = A.direct_agg.launches - before[0]
    assert launches >= 2
    assert A.direct_agg.sum128_launches - before[1] == launches
    for name in ("rows", "cnt", "isum", "lsum"):
        _same(got[name], plain[name])
    _close(got["fsum"], plain["fsum"])
    # min/max only where an input asked for them
    mm = [j for j, (_v, _nl, w) in enumerate(inputs) if w & A.WANT_MINMAX]
    for name in ("mn", "mx"):
        _same(got[name][mm], plain[name][mm])


@pytest.mark.parametrize("case", list(SEGMENT_LENGTHS))
def test_segment_sum128_mode_matches_plain(cuda, case):
    rng = np.random.default_rng(13)
    starts, ends, n = _segments(rng, case)
    live = torch.from_numpy(rng.random(n) < 0.9)
    for vals in (tuple(_wide_lanes_np(rng, n)),
                 torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n)),
                 torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))):
        plain = S.segment_reduce(vals, live, starts, ends, S.WANT_SUM128)
        before = S.segment_reduce.sum128_launches
        got = S.segment_reduce(
            tuple(t.to(cuda) for t in vals) if isinstance(vals, tuple)
            else vals.to(cuda), live.to(cuda), starts.to(cuda),
            ends.to(cuda), S.WANT_SUM128)
        assert S.segment_reduce.sum128_launches == before + 1
        _same(got["cnt"], plain["cnt"])
        _same(got["lsum"], plain["lsum"])


def _merge_states(rng, n):
    """Partial states of the DECIMAL(38) merges: any-int64 limb lanes,
    NULL states, a count column with NULLs."""
    lanes = tuple(torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
                  for _ in range(4))
    nulls = torch.from_numpy(rng.random(n) < 0.2)
    counts = torch.from_numpy(rng.integers(0, 10 ** 6, n))
    cnulls = torch.from_numpy(rng.random(n) < 0.05)
    return lanes, nulls, counts, cnulls


@pytest.mark.parametrize("cap,n", [(256, 32), (1 << 20, 1_000_003)])
def test_direct_agg_merge_mode_matches_plain(cuda, cap, n):
    """sum128_merge/avg128_merge on the global path: K1's 128-bit mode
    over the states' lanes and the int64 sum of the count column, one
    launch, counted as a merge."""
    rng = np.random.default_rng(cap)
    lanes, nulls, counts, cnulls = _merge_states(rng, cap)
    inputs = [(lanes, nulls, A.WANT_SUM128 | A.WANT_MERGE128),
              (counts, cnulls, A.WANT_SUM)]
    plain = A.direct_agg(cap, torch.tensor(n), [], [], inputs)
    before = (A.direct_agg.launches, A.direct_agg.merge128_launches)
    got = A.direct_agg(
        cap, torch.tensor(n, device=cuda), [], [],
        [(tuple(t.to(cuda) for t in lanes), nulls.to(cuda), inputs[0][2]),
         (counts.to(cuda), cnulls.to(cuda), A.WANT_SUM)])
    assert A.direct_agg.launches - before[0] == 1
    assert A.direct_agg.merge128_launches - before[1] == 1
    for name in ("rows", "cnt", "isum", "lsum"):
        _same(got[name], plain[name])


@pytest.mark.parametrize("case", list(SEGMENT_LENGTHS))
@pytest.mark.parametrize("with_count", [False, True])
def test_segment_merge128_mode_matches_plain(cuda, case, with_count):
    rng = np.random.default_rng(14)
    starts, ends, n = _segments(rng, case)
    lanes, nulls, counts, cnulls = _merge_states(rng, n)
    live, clive = ~nulls, ~cnulls
    extra = (counts, clive) if with_count else (None, None)
    plain = S.segment_merge128(lanes, live, starts, ends, *extra)
    before = (S.segment_reduce.launches, S.segment_reduce.merge128_launches)
    got = S.segment_merge128(
        tuple(t.to(cuda) for t in lanes), live.to(cuda), starts.to(cuda),
        ends.to(cuda), *[None if t is None else t.to(cuda) for t in extra])
    assert S.segment_reduce.launches - before[0] == 1
    assert S.segment_reduce.merge128_launches - before[1] == 1
    assert ("csum" in got) == with_count == ("csum" in plain)
    for name in plain:
        _same(got[name], plain[name])


def test_grouped_merge_on_the_card_matches_the_cpu(cuda):
    """grouped_aggregate's merges route as in the JAX package: a grouped
    merge takes the sorted path even over dictionary keys (K3's merge
    mode), a global one the one-bin direct path (K1)."""
    rng = np.random.default_rng(15)
    cap, n = 4096, 3000
    lanes, nulls, counts, cnulls = _merge_states(rng, cap)
    t = T.DecimalType(38, 2)
    words = ["a", "b", "c"]
    codes = rng.integers(0, 3, cap).astype(np.int32)

    def page(dev):
        cols = [C.Column.from_numpy(codes[:n], T.VARCHAR,
                                    dictionary=C.StringDict(words),
                                    capacity=cap, device=dev),
                C.Decimal128Column(*[x.to(dev) for x in lanes],
                                   nulls.to(dev), t),
                C.Column.from_numpy(counts.numpy()[:n], T.BIGINT,
                                    nulls=cnulls.numpy()[:n], capacity=cap,
                                    device=dev)]
        return C.Page.from_columns(cols, n, device=dev)
    aggs = [A.AggSpec("sum128_merge", 1, t),
            A.AggSpec("avg128_merge", 1, t, field2=2)]
    for keys, counter in (((0,), S.segment_reduce), ((), A.direct_agg)):
        before = counter.merge128_launches
        got, _ = A.grouped_aggregate(page(cuda), keys, aggs, 256)
        want, _ = A.grouped_aggregate(page("cpu"), keys, aggs, 256)
        assert counter.merge128_launches > before
        assert got.to_pylist() == want.to_pylist()


def test_bounded_path_on_the_card(cuda):
    """chip_smoke.py's phase 4g at SF 0.01: batched, spilled, pooled and
    Grace-joined runs on the card against the run whole, the CPU and
    numpy (bounded_path fails on any difference); the merge modes, K4 and
    K5 launched."""
    from chip_smoke import ModeCount, bounded_path
    from presto_tpu_torch.connectors import TpchConnector
    counters = [
        ModeCount(A.direct_agg, "direct_agg_merge128",
                  attr="merge128_launches"),
        ModeCount(S.segment_reduce, "segment_reduce_merge128",
                  attr="merge128_launches"),
        A.direct_agg, C.compact_indices, S.segment_reduce, K.hash_columns,
        J.join_probe]
    launches = bounded_path(TpchConnector(0.01), counters)
    assert launches["direct_agg_merge128"] \
        and launches["segment_reduce_merge128"]


def test_spec_typed_tpch_on_the_card_matches_the_cpu(cuda):
    """TPC-H q01, q03, q06, q10 and q19 over lineitem with DECIMAL(12,2)
    money columns, and sums of 2 x 9.9e37, exactly equal on both
    devices."""
    from pathlib import Path
    from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
    from presto_tpu_torch.connectors.tpch import decimal_lineitem
    from presto_tpu_torch.exec.engine import LocalEngine
    ns: dict = {}
    exec(compile((Path(__file__).parent / "tpch_queries.py").read_text(),
                 "tpch_queries.py", "exec"), ns)
    mem = MemoryConnector(fallback=TpchConnector(0.01))
    mem.register(decimal_lineitem(0.01))
    mem.create("carry", [("g", T.BIGINT), ("x", T.DecimalType(38, 0))])
    big = 99 * 10 ** 36
    mem.append_rows("carry", [(1, big), (1, big), (2, -big), (2, -big),
                              (3, big), (3, -1)])
    gpu, cpu = LocalEngine(mem), LocalEngine(mem, device="cpu")
    sqls = [ns["QUERIES"][q] for q in (1, 3, 6, 10, 19)] + [
        "select g, sum(x), avg(x) from carry group by g order by g",
        "select sum(x * 1) from carry where g = 1"]
    for sql in sqls:
        got = gpu.execute_sql(sql)
        assert got == cpu.execute_sql(sql) and got
    assert gpu.execute_sql(sqls[5])[0][1] == 2 * big


def _unnest_channels(rng, cap, nch, dev):
    """Seeded K11 inputs: per channel int32 starts and lengths (0-9, some
    rows empty) and NULL flags (about 10%)."""
    starts, lengths, nulls = [], [], []
    for _ in range(nch):
        ln = rng.integers(0, 10, cap).astype(np.int32)
        st = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int32)
        starts.append(torch.from_numpy(st).to(dev))
        lengths.append(torch.from_numpy(ln).to(dev))
        nulls.append(torch.from_numpy(rng.random(cap) < 0.1).to(dev))
    return starts, lengths, nulls


@pytest.mark.parametrize("cap,num_rows,nch,out_cap,ordinality", [
    (4096, 3001, 1, 16384, False),
    (4096, 4096, 3, 8192, True),          # out_cap below the total
    (1 << 21, 1_500_000, 2, 1 << 23, True),
    (256, 0, 8, 256, True),               # no live rows
])
def test_unnest_expand_kernel_matches_plain(cuda, cap, num_rows, nch,
                                            out_cap, ordinality):
    from presto_tpu_torch.ops import unnest as U
    rng = np.random.default_rng(53)
    st, ln, nl = _unnest_channels(rng, cap, nch, "cpu")
    n = torch.tensor(num_rows, dtype=torch.int64)
    plain = U.unnest_expand(st, ln, nl, n, out_cap, ordinality)
    before = U.unnest_expand.launches
    got = U.unnest_expand([t.to(cuda) for t in st], [t.to(cuda) for t in ln],
                          [t.to(cuda) for t in nl], n.to(cuda), out_cap,
                          ordinality)
    torch.cuda.synchronize()
    assert U.unnest_expand.launches == before + 1
    for g, p in zip(got, plain):
        if p is None:
            assert g is None
        else:
            _same(g, p)


@pytest.mark.parametrize("nch", [9, 12])
def test_unnest_expand_kernel_beyond_eight_channels_matches_plain(cuda,
                                                                  nch):
    """More than eight channels: the count pass reads every channel and
    the slot pass writes every channel's lanes."""
    from presto_tpu_torch.ops import unnest as U
    rng = np.random.default_rng(61)
    st, ln, nl = _unnest_channels(rng, 50_000, nch, "cpu")
    n = torch.tensor(41_234, dtype=torch.int64)
    plain = U.unnest_expand(st, ln, nl, n, 1 << 19, True)
    before = U.unnest_expand.launches
    got = U.unnest_expand([t.to(cuda) for t in st], [t.to(cuda) for t in ln],
                          [t.to(cuda) for t in nl], n.to(cuda), 1 << 19,
                          True)
    torch.cuda.synchronize()
    assert U.unnest_expand.launches == before + 1
    for g, p in zip(got, plain):
        _same(g, p)


def _skewed_channels(rng, cap, dev, long_len):
    """Two channels over rows about 60% NULL, 35% empty and 5% of 1-3
    elements, the first with one row of `long_len` elements."""
    starts, lengths, nulls = [], [], []
    for c in range(2):
        u = rng.random(cap)
        ln = np.where(u < 0.95, 0, rng.integers(1, 4, cap)).astype(np.int32)
        if c == 0:
            ln[cap // 3] = long_len
        nl = (u < 0.6) & (ln < long_len)
        starts.append(torch.from_numpy(np.concatenate(
            [[0], np.cumsum(ln)[:-1]]).astype(np.int32)).to(dev))
        lengths.append(torch.from_numpy(ln).to(dev))
        nulls.append(torch.from_numpy(nl).to(dev))
    return starts, lengths, nulls


#: case -> (capacity, num_rows, channels or "skewed" / "nearly_all_null",
#: out_cap, ordinality)
K11_CASES = {
    "skewed": (1 << 18, 200_000, "skewed", 1 << 21, True),
    "skewed_below_total": (1 << 18, 200_000, "skewed", 1 << 19, True),
    "nearly_all_null": (1 << 18, 1 << 18, "nearly_all_null", 1 << 16, True),
    "nch1": (50_000, 41_234, 1, 1 << 19, False),
    "nch8": (50_000, 41_234, 8, 1 << 19, True),
    "nch9": (50_000, 41_234, 9, 1 << 19, True),
    "nch12": (50_000, 41_234, 12, 1 << 19, True),
    "nch12_below_total": (50_000, 41_234, 12, 1 << 17, True),
    "no_rows": (50_000, 0, 3, 1 << 12, True),
}


@pytest.mark.parametrize("case", sorted(K11_CASES))
def test_unnest_expand_cases_match_plain(cuda, case):
    """K11 on a skewed page (one row of 2^20 elements among rows mostly
    empty or NULL), a page nearly all NULL, 1, 8, 9 and 12 channels, no
    live rows, and capacities below the total: every lane exactly the
    plain version's, one launch a call."""
    from presto_tpu_torch.ops import unnest as U
    cap, num_rows, kind, out_cap, ordinality = K11_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    if kind == "skewed":
        st, ln, nl = _skewed_channels(rng, cap, cuda, 1 << 20)
    elif kind == "nearly_all_null":
        st, ln, nl = _unnest_channels(rng, cap, 2, cuda)
        keep = torch.from_numpy(rng.random(cap) < 0.001).to(cuda)
        nl = [~keep for _ in nl]
    else:
        st, ln, nl = _unnest_channels(rng, cap, kind, cuda)
    n = torch.tensor(num_rows, dtype=torch.int64, device=cuda)
    before = U.unnest_expand.launches
    got = U.unnest_expand(st, ln, nl, n, out_cap, ordinality)
    torch.cuda.synchronize()
    assert U.unnest_expand.launches == before + 1
    plain = U._unnest_expand_plain(st, ln, nl, n, out_cap, ordinality)
    for g, p in zip(got, plain):
        if p is None:
            assert g is None
        else:
            _same(g, p)
    if case.endswith("below_total"):
        assert int(got[-1]) > out_cap


def test_nine_column_unnest_on_the_card_matches_the_cpu(cuda):
    from presto_tpu_torch.connectors import MemoryConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    mem = MemoryConnector()
    mem.create("nine", [("id", T.BIGINT)]
               + [(f"a{i}", T.ArrayType(T.BIGINT)) for i in range(9)])
    rng = np.random.default_rng(67)
    mem.append_rows("nine", [
        (i, *[None if rng.random() < 0.1 else
              [int(v) for v in rng.integers(0, 50, rng.integers(0, 6))]
              for _ in range(9)]) for i in range(500)])
    xs = ", ".join(f"x{i}" for i in range(9))
    sql = (f"SELECT id, {xs} FROM nine CROSS JOIN UNNEST("
           + ", ".join(f"a{i}" for i in range(9)) + f") AS t({xs}) "
           f"ORDER BY id, x0, x1, x2, x3, x4, x5, x6, x7, x8")
    got = LocalEngine(mem).execute_sql(sql)
    assert got and got == LocalEngine(mem, device="cpu").execute_sql(sql)


def test_unnest_on_the_card_matches_the_cpu(cuda):
    """UNNEST over the nested TPC-H orders table (SF 0.01), with a fan-out
    above the capacity hint's (overflow and rerun), on both devices."""
    from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
    from presto_tpu_torch.connectors.tpch import nested_orders
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops import unnest as U
    mem = MemoryConnector(fallback=TpchConnector(0.01))
    mem.register(nested_orders(0.01))
    mem.create("wide", [("id", T.BIGINT), ("xs", T.ArrayType(T.BIGINT))])
    rng = np.random.default_rng(59)
    mem.append_rows("wide", [
        (i, [int(v) for v in rng.integers(0, 100, rng.integers(16, 49))])
        for i in range(300)])
    gpu, cpu = LocalEngine(mem), LocalEngine(mem, device="cpu")
    sqls = [
        "SELECT o_orderpriority, count(*), sum(pk) FROM orders_nested "
        "CROSS JOIN UNNEST(l_partkeys) AS t(pk) GROUP BY 1 ORDER BY 1",
        "SELECT count(*), count(pk), count(r) FROM orders_nested "
        "CROSS JOIN UNNEST(l_partkeys, l_returned) AS t(pk, r)",
        "SELECT id, x, n FROM wide CROSS JOIN UNNEST(xs) WITH ORDINALITY "
        "AS t(x, n) ORDER BY id, n"]
    before = U.unnest_expand.launches
    for sql in sqls:
        got = gpu.execute_sql(sql)
        assert got == cpu.execute_sql(sql) and got
    assert U.unnest_expand.launches > before


def _hll_values(rng, n, dtype):
    """Seeded K12 inputs with repeats; int64 ones include the values whose
    hash has w = 2^k - 1 (chip_smoke.hll_boundary_values), where the
    float32 rounding moves the rank."""
    from chip_smoke import hll_boundary_values
    if dtype == torch.float64:
        v = np.round(rng.random(n) * 1e5, 2)
    else:
        v = rng.integers(-10 ** 6, 10 ** 6, n)
        v[:216] = np.concatenate([hll_boundary_values(range(54), r)
                                  for r in (0, 3, 1000, 2047)])
    return torch.from_numpy(v).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float64])
@pytest.mark.parametrize("bins", [1, 12, 64])
def test_hll_registers_direct_kernel_matches_plain(cuda, dtype, bins):
    rng = np.random.default_rng(71)
    n = 1 << 20
    vals = _hll_values(rng, n, dtype)
    live = torch.from_numpy(rng.random(n) < 0.9)
    codes = torch.from_numpy(rng.integers(0, bins, n).astype(np.int32))
    plain = A.hll_registers(vals, live, codes=codes, bins=bins)
    before = A.hll_registers.launches
    got = A.hll_registers(vals.to(cuda), live.to(cuda),
                          codes=codes.to(cuda), bins=bins)
    torch.cuda.synchronize()
    assert A.hll_registers.launches == before + 1
    for g, p in zip(got, plain):
        _same(g, p)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_hll_registers_sorted_kernel_matches_plain(cuda, dtype):
    """One-row groups, groups of up to 32 rows, of hundreds, of more than
    a piece (split across blocks), an empty group and groups past the
    group count."""
    rng = np.random.default_rng(73)
    lengths = np.concatenate([
        np.ones(200_000, np.int64), rng.integers(2, 33, 20_000),
        rng.integers(33, 3000, 300), [0],
        [A.HLL_PIECE, A.HLL_PIECE + 1, 300_000, 861_000]])
    rng.shuffle(lengths)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    n = int(ends[-1]) + 1000
    pad = 5000
    starts = torch.from_numpy(np.concatenate([starts, np.full(pad, 7)]))
    ends = torch.from_numpy(np.concatenate([ends, np.full(pad, 7)]))
    vals = _hll_values(rng, n, dtype)
    live = torch.from_numpy(rng.random(n) < 0.95)
    plain = A.hll_registers(vals, live, starts=starts, ends=ends)
    before = A.hll_registers.launches
    got = A.hll_registers(vals.to(cuda), live.to(cuda),
                          starts=starts.to(cuda), ends=ends.to(cuda))
    torch.cuda.synchronize()
    assert A.hll_registers.launches == before + 1
    _same(got[0], plain[0])
    _same(got[1], plain[1])


def _hll_same_twice(cuda, vals, live, **mode):
    """K12 on the card, launched twice, against the plain version on the
    CPU: present, count and (direct mode) registers bit for bit."""
    plain = A.hll_registers(vals, live, **mode)
    on = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
          for k, v in mode.items()}
    before = A.hll_registers.launches
    got = A.hll_registers(vals.to(cuda), live.to(cuda), **on)
    again = A.hll_registers(vals.to(cuda), live.to(cuda), **on)
    torch.cuda.synchronize()
    assert A.hll_registers.launches == before + 2
    for g, a, p in zip(got, again, plain):
        assert (g is None) == (p is None)
        if p is not None:
            _same(g, p)
            _same(a, p)


@pytest.mark.parametrize("bins", [1, 12])
def test_hll_registers_direct_one_value(cuda, bins):
    """Every row one value, so every row of a bin hits one register."""
    n = 1 << 22
    vals = torch.full((n,), 123_456_789, dtype=torch.int64)
    live = torch.ones(n, dtype=torch.bool)
    codes = torch.from_numpy(
        np.random.default_rng(74).integers(0, bins, n).astype(np.int32))
    _hll_same_twice(cuda, vals, live, codes=codes, bins=bins)


def _sorted_runs(lengths, pad=100):
    """starts, ends of runs of the given lengths, then `pad` empty groups."""
    ends = np.cumsum(lengths)
    starts = ends - lengths
    return (torch.from_numpy(np.concatenate([starts, np.full(pad, 3)])),
            torch.from_numpy(np.concatenate([ends, np.full(pad, 3)])))


@pytest.mark.parametrize("edge", [1, A.HLL_SMALL_MAX, A.HLL_SMALL_MAX + 1,
                                  A.HLL_PIECE, A.HLL_PIECE + 1,
                                  2 * A.HLL_PIECE + 3])
def test_hll_registers_sorted_tier_edges(cuda, edge):
    """Groups at each edge of K12's sorted-mode tiers (a thread up to
    HLL_SMALL_MAX rows, a warp up to HLL_PIECE, block pieces past it),
    among groups of other tiers, some with no live row."""
    rng = np.random.default_rng(75 + edge)
    count = max(2_000_000 // edge, 40) if edge > 1 else 50_000
    lengths = np.concatenate([np.full(count, edge),
                              rng.integers(1, 3 * A.HLL_SMALL_MAX, 300)])
    rng.shuffle(lengths)
    starts, ends = _sorted_runs(lengths)
    n = int(lengths.sum()) + 17
    vals = _hll_values(rng, n, torch.int64)
    live = torch.from_numpy(rng.random(n) < 0.9)
    for g in rng.choice(len(lengths), 25, replace=False):  # no live row
        live[int(starts[g]):int(ends[g])] = False
    _hll_same_twice(cuda, vals, live, starts=starts, ends=ends)


@pytest.mark.parametrize("groups", [1, 7])
def test_hll_registers_sorted_huge_groups(cuda, groups):
    """a4's shape (seven groups of about 0.86M rows) and one group of 6M
    rows: pieces dealt over the blocks, merged by the last one."""
    rng = np.random.default_rng(76)
    n = 6_001_215
    lengths = np.bincount(rng.integers(0, groups, n), minlength=groups)
    starts, ends = _sorted_runs(lengths, pad=1017)
    vals = _hll_values(rng, 1 << 23, torch.int64)
    live = torch.arange(1 << 23) < n
    _hll_same_twice(cuda, vals, live, starts=starts, ends=ends)


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    assert torch.equal(a, b), (a, b)


def _select_twice(cuda, vals, live, p, **groups):
    """K13 on the card, launched twice: each launch counted once, both
    equal bit for bit to each other and to the plain version (run on the
    CPU, so that no sort on the card stands in the comparison)."""
    want = A.segment_select(vals, live, p, **groups)
    dev = {k: v.to(cuda) if torch.is_tensor(v) else v
           for k, v in groups.items()}
    for _ in range(2):
        before = A.segment_select.launches
        got = A.segment_select(vals.to(cuda), live.to(cuda), p, **dev)
        torch.cuda.synchronize()
        assert A.segment_select.launches == before + 1
        _same_bits(got[0], want[0])
        _same(got[1], want[1])


def _runs(lengths):
    ends = torch.from_numpy(np.cumsum(lengths)).to(torch.int64)
    return ends - torch.from_numpy(np.asarray(lengths)).to(torch.int64), ends


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64])
def test_segment_pick_kernel_matches_plain(cuda, p, dtype):
    """K13 (segment_select; the pick after a sort before it) on 100,000
    runs of 0-50 unsorted rows, a tenth of them dead."""
    rng = np.random.default_rng(79)
    counts = rng.integers(0, 50, 100_000)
    starts, ends = _runs(counts)
    n = int(counts.sum()) + 3
    vals = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, n)).to(dtype)
    live = torch.from_numpy(rng.random(n) < 0.9)
    _select_twice(cuda, vals, live, p, starts=starts, ends=ends)


def _tie_values(rng, n):
    """-0.0, +0.0, subnormals and NaNs of several payloads (all of which
    tie in the key) beside ordinary values."""
    nans = np.array([0x7FF8000000000000, 0x7FF8000000000123,
                     0xFFF8000000000000, 0x7FF0000000000001],
                    np.uint64).view(np.float64)
    pool = np.concatenate([[0.0, -0.0, 5e-324, -5e-324, 2.5e-310, 1.0, -1.0,
                            np.inf, -np.inf], nans])
    return torch.from_numpy(pool[rng.integers(0, len(pool), n)])


def _select_case(name, rng):
    """(values, live, groups) of one of SELECT_CASES."""
    sm, bm = A.SELECT_WARP_MAX, A.SELECT_BLOCK_MAX
    if name == "ties, 6 bins":
        n = 1 << 20
        return (_tie_values(rng, n), torch.from_numpy(rng.random(n) < 0.9),
                {"codes": torch.from_numpy(rng.integers(0, 6, n)
                                           .astype(np.int32)), "bins": 6})
    if name == "ties, runs of every tier":
        lengths = np.array([1, 31, 32, sm, sm + 1, bm, bm + 1, 300_000, 0,
                            5, 100_000])
        n = int(lengths.sum()) + 11
        starts, ends = _runs(lengths)
        return (_tie_values(rng, n), torch.from_numpy(rng.random(n) < 0.9),
                {"starts": starts, "ends": ends})
    if name == "ties at one key, 2^20 rows":
        n = 1 << 20
        v = torch.from_numpy(np.array([0.0, -0.0, 5e-324, 7.0])[
            rng.choice(4, n, p=[0.4, 0.3, 0.2, 0.1])])
        return (v, torch.ones(n, dtype=torch.bool),
                {"codes": torch.zeros(n, dtype=torch.int32), "bins": 1})
    if name == "one group of 2^23 rows, 50 values":
        n, live_n = 1 << 23, 6_001_215
        v = torch.from_numpy(rng.integers(1, 51, n).astype(np.float64))
        return (v, torch.arange(n) < live_n,
                {"codes": torch.zeros(n, dtype=torch.int32), "bins": 1})
    if name == "64 bins":
        n = 1 << 21
        v = torch.from_numpy(rng.integers(90_000, 10_500_000, n) / 100.0)
        return (v, torch.from_numpy(rng.random(n) < 0.95),
                {"codes": torch.from_numpy(rng.integers(0, 64, n)
                                           .astype(np.int32)), "bins": 64})
    if name == "one run holding the page":
        n = 1 << 22
        v = torch.from_numpy(rng.standard_normal(n))
        starts, ends = _runs([n])
        return (v, torch.from_numpy(rng.random(n) < 0.7),
                {"starts": starts, "ends": ends})
    if name == "seven runs of 0.86M dates":
        n = 6_001_215
        lengths = np.bincount(rng.integers(0, 7, n), minlength=7)
        starts, ends = _runs(lengths)
        pad = torch.full((1017,), n, dtype=torch.int64)
        v = torch.from_numpy(rng.integers(8036, 10562, 1 << 23)
                             .astype(np.int32))
        return (v, torch.arange(1 << 23) < n,
                {"starts": torch.cat([starts, pad]),
                 "ends": torch.cat([ends, pad])})
    assert name == "10,000 runs of int64, sorted runs unsorted within"
    lengths = np.bincount(rng.integers(0, 10_000, 6_000_000),
                          minlength=10_000)
    starts, ends = _runs(lengths)
    n = int(lengths.sum())
    v = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
    return v, torch.from_numpy(rng.random(n) < 0.95), {"starts": starts,
                                                        "ends": ends}


SELECT_CASES = ["ties, 6 bins", "ties, runs of every tier",
                "ties at one key, 2^20 rows",
                "one group of 2^23 rows, 50 values", "64 bins",
                "one run holding the page", "seven runs of 0.86M dates",
                "10,000 runs of int64, sorted runs unsorted within"]


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("name", SELECT_CASES)
def test_segment_select_kernel_cases(cuda, name, p):
    """K13's schedule and its ties: every tier of run lengths, bins of the
    direct path up to 64, one group of 2^23 rows of 50 values, one run of
    the whole page, rows of one key but different bits (compared bit for
    bit)."""
    rng = np.random.default_rng(80 + SELECT_CASES.index(name))
    vals, live, groups = _select_case(name, rng)
    _select_twice(cuda, vals, live, p, **groups)


def _sort_kernels(engine, sql) -> int:
    """Device kernels whose name holds "sort" in one warm run of sql."""
    from torch.profiler import ProfilerActivity, profile
    engine.execute_sql(sql)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.execute_sql(sql)
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type.name == "CUDA" and "sort" in ev.name.lower())


@pytest.mark.parametrize("name", ["a1", "a3"])
def test_approx_percentile_sorts_nothing_on_the_card(cuda, name):
    """K13 computes the whole approx_percentile step: a1 (global) and a3
    (sorted path) launch K13 and as many sort kernels as the same query
    with count() in place of the percentile (the GROUP BY's own sort)."""
    from chip_smoke import APPROX_QUERIES
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    sql = APPROX_QUERIES[name]
    twin = sql.replace("approx_percentile(l_quantity, 0.5)",
                       "count(l_quantity)").replace(
        "approx_percentile(l_discount, 0.25)", "count(l_discount)")
    assert twin != sql
    engine = LocalEngine(TpchConnector(0.01))
    before = A.segment_select.launches
    with_pct = _sort_kernels(engine, sql)
    assert A.segment_select.launches == before + 2
    assert with_pct == _sort_kernels(engine, twin)


def test_approx_queries_on_the_card_match_the_cpu(cuda):
    """chip_smoke.py's a1-a5 at SF 0.01: the card's rows equal the CPU's,
    K12 and K13 launched."""
    from chip_smoke import APPROX_QUERIES
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    conn = TpchConnector(0.01)
    gpu, cpu = LocalEngine(conn), LocalEngine(conn, device="cpu")
    before = (A.hll_registers.launches, A.segment_select.launches)
    for sql in APPROX_QUERIES.values():
        got = gpu.execute_sql(sql)
        assert got and sorted(got) == sorted(cpu.execute_sql(sql))
    assert A.hll_registers.launches > before[0]
    assert A.segment_select.launches > before[1]


def test_statement_path_on_the_card_matches_the_cpu(cuda):
    """chip_smoke.py's phase 4f at SF 0.01: CREATE TABLE AS, INSERT,
    DELETE, queries over the written table, EXPLAIN, q15 materialized and
    DROP on the card against the CPU and numpy (statement_path fails on
    any difference), K1, K2, K4 and K5 launched."""
    from chip_smoke import statement_path
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.data.int128 import int128_op
    launches = statement_path(TpchConnector(0.01), [
        A.direct_agg, C.compact_indices, K.hash_columns, J.join_probe,
        S.segment_reduce, int128_op])
    assert launches["direct_agg"] and launches["join_probe"]


def test_warm_queries_compute_no_transform_on_the_card(cuda):
    """q13's LIKE and q22's substring and literal merges are built once
    per dictionary and device: the warm runs on the card compute none and
    give the cold rows."""
    from chip_smoke import tpch_queries
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.expr.compile import DICT_CACHE
    engine = LocalEngine(TpchConnector(0.01))
    for q in (13, 22):
        cold = engine.execute_sql(tpch_queries()[q])
        before = DICT_CACHE.computed
        assert engine.execute_sql(tpch_queries()[q]) == cold
        assert DICT_CACHE.computed == before
