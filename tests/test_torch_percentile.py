"""K13 `segment_select` (approx_percentile's order statistic per group) in
the port against the JAX package, on the CPU.

On CPU tensors `segment_select` runs its plain version,
`_segment_select_plain`: the live rows sorted stably by (group, key) with
`lex_perm`, then `_segment_pick_plain`. Here it is held exactly against
the JAX function's own lines, the sort and the take of
presto_tpu/ops/aggregate.py, direct (:392-414, the sort at :405) and sorted
(:737-760, the sort at :747), over seeded numpy inputs: both forms of
groups (bin codes; contiguous runs with padding rows after them), p in {0,
0.25, 0.5, 0.9, 1}, float64, int64 and int32 values, empty, one-row and
all-dead groups, NaN and +-inf. The JAX sort is not stable
(is_stable=False), so those inputs have no ties between rows of different
bits; ties of -0.0 with +0.0, subnormals with 0.0 and NaNs of different
payloads are held against numpy's stable lexsort instead, bit for bit.
The kernel itself is held against this plain version on the card
(tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import aggregate as PA
from torch_threads import _one_torch_thread  # noqa: F401

PS = [0.0, 0.25, 0.5, 0.9, 1.0]
DTYPES = [np.float64, np.int64, np.int32]
N = 4096
BINS = 12


def _values(rng, n, dtype):
    """Few distinct values and many, NaN and +-inf among the floats; no
    two rows of different bits that tie."""
    if dtype == np.float64:
        v = np.where(rng.random(n) < 0.5, rng.integers(1, 51, n),
                     rng.standard_normal(n) * 1e3)
        v[rng.random(n) < 0.02] = np.nan
        v[rng.random(n) < 0.01] = np.inf
        v[rng.random(n) < 0.01] = -np.inf
        return v.astype(np.float64)
    return rng.integers(-1000, 1000, n).astype(dtype)


def _jax_direct(vals, live, code, bins, p):
    """presto_tpu/ops/aggregate.py:392-414 over (values, live, bin code)."""
    ov = jnp.asarray(vals)
    code_s = jnp.where(jnp.asarray(live), jnp.asarray(code), bins)
    s_ops = jax.lax.sort((code_s, ov, jnp.asarray(vals)), num_keys=2,
                         is_stable=False)
    svals = s_ops[2]
    live_counts = jnp.stack([jnp.sum(jnp.asarray(live) & (code == b))
                             for b in range(bins)])
    bin_starts = jnp.cumsum(live_counts) - live_counts
    idx = bin_starts + jnp.floor(
        p * jnp.maximum(live_counts - 1, 0)
        .astype(jnp.float64)).astype(live_counts.dtype)
    picked = jnp.take(svals, jnp.clip(idx, 0, len(vals) - 1), mode="clip")
    return np.asarray(picked), np.asarray(live_counts == 0)


def _jax_sorted(vals, nulls, gid, starts, n, p):
    """presto_tpu/ops/aggregate.py:737-760 over a group-sorted page (gid
    per row, NULL and padding rows in `nulls`) with the groups' starts and
    non-null counts."""
    s_ops = jax.lax.sort((jnp.asarray(gid), jnp.asarray(nulls)
                          .astype(jnp.int8), jnp.asarray(vals),
                          jnp.asarray(vals)), num_keys=3, is_stable=False)
    svals = s_ops[3]
    idx = jnp.asarray(starts) + jnp.floor(
        p * jnp.maximum(jnp.asarray(n) - 1, 0).astype(jnp.float64)
    ).astype(jnp.int32)
    picked = jnp.take(svals, jnp.clip(idx, 0, len(vals) - 1), mode="clip")
    return np.asarray(picked), np.asarray(n) == 0


def _port(vals, live, p, **groups):
    got, null = PA.segment_select(torch.from_numpy(vals),
                                  torch.from_numpy(live), p,
                                  **{k: torch.from_numpy(v) if isinstance(
                                      v, np.ndarray) else v
                                     for k, v in groups.items()})
    return got.numpy(), null.numpy()


def _equal(got, want):
    (g, gn), (w, wn) = got, want
    np.testing.assert_array_equal(gn, wn)
    keep = ~wn
    assert np.array_equal(g[keep], w[keep], equal_nan=g.dtype.kind == "f")
    assert np.all(g[wn] == 0)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_select_plain_matches_jax_direct(p, dtype):
    """Bin codes (the direct and global paths): bins with many rows, one
    row, only dead rows and none."""
    rng = np.random.default_rng(31)
    vals = _values(rng, N, dtype)
    code = rng.integers(0, BINS - 3, N).astype(np.int32)
    code[:5] = BINS - 3                          # a bin of one live row
    code[5:40] = BINS - 2                        # a bin of dead rows only
    live = rng.random(N) < 0.8
    live[0], live[1:5], live[5:40] = True, False, False
    # bin BINS - 1 has no row
    _equal(_port(vals, live, p, codes=code, bins=BINS),
           _jax_direct(vals, live, code, BINS, p))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_select_plain_matches_jax_sorted(p, dtype):
    """Contiguous runs of a group-sorted page (the sorted path): runs of
    0-60 rows, one-row runs, runs of NULLs only, padding rows after the
    last run (dead, with its gid) and empty overflow slots."""
    rng = np.random.default_rng(37)
    lengths = rng.integers(1, 60, 150)
    lengths[:3] = (1, 1, 2)
    total = int(lengths.sum())
    cap = total + 100                            # padding rows
    vals = _values(rng, cap, dtype)
    nulls = rng.random(cap) < 0.15
    nulls[total:] = True
    ends = np.cumsum(lengths)
    starts = ends - lengths
    for g in (3, 77):                            # only NULLs
        nulls[starts[g]:ends[g]] = True
    gid = np.repeat(np.arange(1, len(lengths) + 1), lengths)
    gid = np.concatenate([gid, np.full(cap - total, len(lengths))])
    n = np.add.reduceat(~nulls[:total], starts)
    pad = 9                                      # overflow slots: empty
    starts_all = np.concatenate([starts, np.full(pad, total)])
    ends_all = np.concatenate([ends, np.full(pad, total)])
    n_all = np.concatenate([n, np.zeros(pad, n.dtype)])
    _equal(_port(vals, ~nulls, p, starts=starts_all.astype(np.int64),
                 ends=ends_all.astype(np.int64)),
           _jax_sorted(vals, nulls, gid, starts_all, n_all, p))


def _stable_reference(vals, live, gid, groups, p):
    """numpy: each group's live rows in a stable order by (group, key), the
    key as `_select_keys` defines it (written anew here), then the pick."""
    rows = np.nonzero(live)[0]
    if vals.dtype == np.float64:
        v = np.where(np.abs(vals) < np.finfo(np.float64).tiny, 0.0, vals)
        bits = v.view(np.int64)
        key = np.where(bits < 0, bits ^ np.int64(2 ** 63 - 1), bits)
        key = np.where(v == 0, 0, key)
        key = np.where(np.isnan(vals), np.int64(2 ** 63 - 1), key)
    else:
        key = vals.astype(np.int64)
    order = rows[np.lexsort((key[rows], gid[rows]))]
    counts = np.bincount(gid[rows], minlength=groups)
    starts = np.cumsum(counts) - counts
    k = np.floor(p * np.maximum(counts - 1, 0).astype(np.float64)) \
        .astype(np.int64)
    out = np.zeros(groups, vals.dtype)
    has = counts > 0
    out[has] = vals[order[starts[has] + k[has]]]
    return out, counts == 0


@pytest.mark.parametrize("p", PS)
def test_segment_select_plain_ties_of_different_bits(p):
    """-0.0 with +0.0, subnormals with 0.0 and NaNs of several payloads tie;
    the row a stable sort puts at position k is returned, bit for bit."""
    rng = np.random.default_rng(41)
    nans = np.array([0x7FF8000000000000, 0x7FF8000000000123,
                     0xFFF8000000000000, 0x7FF0000000000001],
                    np.uint64).view(np.float64)
    pool = np.concatenate([[0.0, -0.0, 5e-324, -5e-324, 2.5e-310, 1.0,
                            -1.0, np.inf, -np.inf], nans])
    n = 3000
    vals = pool[rng.integers(0, len(pool), n)]
    live = rng.random(n) < 0.9
    code = rng.integers(0, 5, n).astype(np.int32)
    got = _port(vals, live, p, codes=code, bins=5)
    want = _stable_reference(vals, live, code.astype(np.int64), 5, p)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int64),
                                  want[0].view(np.int64))
    lengths = np.array([700, 1, 0, 1299, 1000])
    ends = np.cumsum(lengths)
    gid = np.repeat(np.arange(5), lengths)
    got = _port(vals, live, p, starts=(ends - lengths).astype(np.int64),
                ends=ends.astype(np.int64))
    want = _stable_reference(vals, live, gid, 5, p)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int64),
                                  want[0].view(np.int64))


def test_select_keys_order_the_orderable_values():
    """`_select_keys` orders floats as torch.sort orders the flushed values
    (NaN last), and integers as they are."""
    rng = np.random.default_rng(43)
    v = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -300, 300, 500), [np.inf, -np.inf, np.nan, 0.0, 1e-310]])
    t = torch.from_numpy(v)
    keys = PA._select_keys(t)
    from presto_tpu_torch.ops.keys import flush_subnormal
    want = torch.sort(flush_subnormal(t), stable=True).values
    got = flush_subnormal(t)[torch.sort(keys, stable=True).indices]
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])
    i = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, 100))
    assert torch.equal(PA._select_keys(i), i)
    assert PA._select_keys(i.to(torch.int32)).dtype == torch.int64


@pytest.mark.parametrize("bad", ["no groups", "both forms", "values 2-d",
                                 "float32 values", "live not bool",
                                 "codes int64", "65 bins",
                                 "starts int32"])
def test_segment_select_rejects_bad_arguments(bad):
    v = torch.zeros(8, dtype=torch.float64)
    live = torch.ones(8, dtype=torch.bool)
    codes = torch.zeros(8, dtype=torch.int32)
    se = torch.zeros(2, dtype=torch.int64)
    kw = {"codes": codes, "bins": 1}
    if bad == "no groups":
        kw = {}
    elif bad == "both forms":
        kw = {"codes": codes, "bins": 1, "starts": se, "ends": se}
    elif bad == "values 2-d":
        v = v.view(2, 4)
    elif bad == "float32 values":
        v = v.to(torch.float32)
    elif bad == "live not bool":
        live = live.to(torch.uint8)
    elif bad == "codes int64":
        kw = {"codes": codes.to(torch.int64), "bins": 1}
    elif bad == "65 bins":
        kw = {"codes": codes, "bins": 65}
    elif bad == "starts int32":
        kw = {"starts": se.to(torch.int32), "ends": se}
    with pytest.raises((TypeError, ValueError)):
        PA.segment_select(v, live, 0.5, **kw)
