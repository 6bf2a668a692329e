"""approx_distinct and approx_percentile in the port against the JAX
package, on the CPU.

- (a) `_hll_reg_rank` against the JAX function on seeded int64 (negatives
  and the extremes included), int32 dictionary codes and float64 values,
  and on values that invert the hash to w = 2^k - 1, where the float32
  rounding moves the rank; registers and ranks exact. The float hash
  lanes (`f64_hash_lanes`) are first shown bit-equal on the float inputs
  used.
- (b) K12's plain version (`hll_registers`, direct and sorted modes)
  against registers built with numpy from the JAX function's (register,
  rank) pairs: registers, present sums and counts exact.
- (c) `_hll_estimate` against the JAX function: exact on the raw
  estimate; on the small-range correction exact after the rounding the
  aggregate applies, at every zero count (torch's log and XLA's differ in
  the last bit at a few of them).
- (d) the pick that ends K13's plain version (`_segment_pick_plain`)
  against the JAX package's pick for p in {0, 0.25, 0.5, 0.9, 1}; the
  whole step, sort and pick, is held in tests/test_torch_percentile.py.
- (e) `grouped_aggregate` with both kinds on the direct, global and sorted
  paths, and the engine: the six queries of tests/test_approx_aggs.py,
  chip_smoke.py's a1-a5, the kinds beside sum/count/avg, NULL inputs from
  a LEFT join, empty inputs, percentiles of VARCHAR and DATE, and
  DECIMAL(38) inputs (which raise NotImplementedError in both packages):
  rows exactly equal to the JAX LocalEngine's.

One kind of input is held otherwise: approx_distinct over DOUBLE values
whose mantissa fits 32 fraction bits (TPC-H's prices). The JAX package's
`f64_hash_lanes` scales by `jnp.exp2(-e)`, which XLA computes as
exp(log(2) * -e), off by an ulp for most exponents, so its mantissa lane
of such a value is one below the exact one that the port (and K4) takes.
The test pins that difference, and holds the port's estimate over such
values exactly against the JAX estimator fed the port's hash lanes and
within the sketch's three standard errors of the exact count.
"""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors import MemoryConnector as RefMemory
from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu.ops import aggregate as RA
from presto_tpu.ops import keys as RK
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.ops import aggregate as PA
from presto_tpu_torch.ops import keys as PK
from chip_smoke import APPROX_QUERIES, HLL_BOUND, hll_boundary_values
from tests.test_torch_kernels import CAP, N, _pages
from torch_threads import _one_torch_thread  # noqa: F401

SF = 0.01
M = 2048

#: the six local queries of tests/test_approx_aggs.py (:21-65), as SQL
APPROX_TEST_QUERIES = {
    "distinct_global": "select approx_distinct(l_partkey) from lineitem",
    "distinct_grouped": "select l_returnflag, approx_distinct(l_orderkey) "
                        "from lineitem group by l_returnflag",
    "distinct_filter_mask": "select approx_distinct(o_custkey) from orders "
                            "where o_orderstatus = 'F'",
    "distinct_empty": "select approx_distinct(o_custkey) from orders "
                      "where o_orderkey < 0",
    "percentile_global": "select approx_percentile(l_quantity, 0.5) "
                         "from lineitem",
    "percentile_grouped": "select l_returnflag, "
                          "approx_percentile(l_extendedprice, 0.9) "
                          "from lineitem group by l_returnflag",
}

#: further engine cases: name -> SQL
ENGINE_CASES = {
    "direct_beside_sum_count_avg":
        "select l_returnflag, sum(l_quantity), count(*), avg(l_discount), "
        "approx_distinct(l_suppkey), approx_percentile(l_tax, 0.5) "
        "from lineitem group by l_returnflag",
    "sorted_beside_sum_count_avg":
        "select l_suppkey, sum(l_quantity), count(*), avg(l_discount), "
        "approx_distinct(l_orderkey), approx_percentile(l_quantity, 0.75) "
        "from lineitem group by l_suppkey",
    "global_beside_sum_count":
        "select count(*), sum(l_quantity), approx_distinct(l_orderkey), "
        "approx_percentile(l_orderkey, 0.1) from lineitem",
    "left_join_nulls_direct":
        "select c_mktsegment, approx_distinct(o_orderkey), "
        "approx_percentile(o_totalprice, 0.5), count(o_orderkey) "
        "from customer left join orders on c_custkey = o_custkey "
        "group by c_mktsegment",
    "left_join_nulls_sorted":
        "select c_nationkey, approx_distinct(o_orderdate), "
        "approx_percentile(o_orderdate, 0.5), count(*) "
        "from customer left join orders "
        "on c_custkey = o_custkey and o_totalprice > 300000 "
        "group by c_nationkey",
    "left_join_no_match_sorted":
        "select c_nationkey, approx_distinct(o_orderdate), "
        "approx_percentile(o_orderdate, 0.5), count(*) "
        "from customer left join orders "
        "on c_custkey = o_custkey and o_orderkey < 0 "
        "group by c_nationkey",
    "empty_global":
        "select approx_distinct(o_custkey), "
        "approx_percentile(o_totalprice, 0.5) from orders "
        "where o_orderkey < 0",
    "empty_grouped":
        "select o_orderstatus, approx_distinct(o_custkey) from orders "
        "where o_orderkey < 0 group by o_orderstatus",
    "varchar_and_date_direct":
        "select l_returnflag, approx_percentile(l_shipmode, 0.5), "
        "approx_percentile(l_shipdate, 0.9) from lineitem "
        "group by l_returnflag",
    "varchar_and_date_sorted":
        "select l_suppkey, approx_percentile(l_shipinstruct, 0.3), "
        "approx_percentile(l_receiptdate, 0.0), "
        "approx_percentile(l_commitdate, 1.0) from lineitem "
        "group by l_suppkey",
}

#: queries whose approx_distinct column (by index) takes DOUBLE prices
FLOAT_DISTINCT = {"a1": 1}
#: float sum and average columns (by index), which the port sums in
#: another order: within the repo's oracle tolerance, 1e-6 relative
FLOAT_SUMS = {"direct_beside_sum_count_avg": (1, 3),
              "sorted_beside_sum_count_avg": (1, 3),
              "global_beside_sum_count": (1,)}


@pytest.fixture(scope="module")
def engines():
    return RefEngine(RefTpch(SF)), LocalEngine(TpchConnector(SF),
                                               device="cpu")


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((v is None, v) for v in r))


# -- (a) registers and ranks ------------------------------------------------

def _ref_reg_rank(vals: np.ndarray):
    reg, rank = RA._hll_reg_rank(jnp.asarray(vals))
    return np.asarray(reg), np.asarray(rank)


def _port_reg_rank(vals: np.ndarray):
    reg, rank = PA._hll_reg_rank(torch.from_numpy(vals))
    return reg.numpy(), rank.numpy()


def _float_inputs(rng) -> np.ndarray:
    """Doubles with full 52-bit mantissas over many magnitudes and signs,
    and the values the hash tags: NaN, +-inf, +-0."""
    v = rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)
    return np.concatenate([v, [np.nan, np.inf, -np.inf, 0.0, -0.0]])


def test_f64_hash_lanes_bit_equal_on_the_float_inputs():
    v = _float_inputs(np.random.default_rng(3))
    ref = np.asarray(RK.f64_hash_lanes(jnp.asarray(v))).view(np.int64)
    port = PK.f64_hash_lanes(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_f64_hash_lanes_differ_from_jax_by_its_exp2_alone():
    """Over TPC-H's l_extendedprice (whole cents: few mantissa bits) the
    lanes differ, and only where the JAX function's exp2 (exp(log(2) x)
    in XLA) is inexact: with an exact power of two in its place, its
    lanes equal the port's everywhere."""
    t = TpchConnector(SF).table("lineitem")
    v = np.asarray(t.arrays["l_extendedprice"][:t.num_rows], np.float64)
    ref = np.asarray(RK.f64_hash_lanes(jnp.asarray(v))).view(np.int64)
    port = PK.f64_hash_lanes(torch.from_numpy(v)).numpy()
    assert (ref != port).sum() > 0
    x = jnp.asarray(v)
    e = jnp.floor(jnp.log2(jnp.abs(x)))
    norm = jnp.abs(x) * jnp.ldexp(1.0, (-e).astype(jnp.int32))
    mant = (jnp.clip(norm - 1.0, 0.0, 1.0) * 2.0 ** 32).astype(jnp.uint64)
    eb = (e.astype(jnp.int64) + 2048).astype(jnp.uint64)
    exact = np.asarray(eb * RK._GOLDEN ^ mant).view(np.int64)  # v > 0
    np.testing.assert_array_equal(port, exact)


@pytest.mark.parametrize("kind", ["int64", "int32_codes", "float64",
                                  "boundaries"])
def test_hll_reg_rank_matches_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "int64":
        vals = np.concatenate([
            rng.integers(-2 ** 62, 2 ** 62, 20000),
            [0, -1, 1, np.iinfo(np.int64).min, np.iinfo(np.int64).max]])
    elif kind == "int32_codes":
        vals = rng.integers(0, 5000, 20000).astype(np.int32)
    elif kind == "float64":
        vals = _float_inputs(rng)
    else:
        ks = list(range(54))
        vals = np.concatenate([hll_boundary_values(ks, reg)
                               for reg in (0, 5, 2047)])
    reg, rank = _port_reg_rank(vals)
    r_reg, r_rank = _ref_reg_rank(vals)
    np.testing.assert_array_equal(reg, r_reg)
    np.testing.assert_array_equal(rank, r_rank)
    if kind == "boundaries":
        # float32(2^k - 1) stays below 2^k up to k = 24 and rounds up
        # from k = 25; 2^53 - 1 rounds to 2^53, rank 0
        want = [54 if k == 0 else (54 - k if k <= 24 else 53 - k)
                for k in ks] * 3
        np.testing.assert_array_equal(rank, want)
        np.testing.assert_array_equal(reg, np.repeat([0, 5, 2047], 54))


# -- (b) K12's plain version ------------------------------------------------

def _numpy_registers(gid, reg, rank, groups):
    """[groups, M] registers holding rank + 1 (0: empty), and per group
    present = sum 2^-rank over them and their count."""
    regs = np.zeros((groups, M), np.int64)
    np.maximum.at(regs, (gid, reg), rank + 1)
    terms = np.where(regs > 0, np.ldexp(1.0, -(regs - 1)), 0.0)
    return regs, terms.sum(axis=1), (regs > 0).sum(axis=1)


def _k12_inputs(rng, n):
    """Values (int64 with repeats, and the hash boundaries), live flags."""
    v = rng.integers(-10 ** 6, 10 ** 6, n)
    v[:54] = hll_boundary_values(range(54), 17)
    v[54:108] = hll_boundary_values(range(54), 17)[::-1]
    return v, rng.random(n) < 0.9


@pytest.mark.parametrize("bins", [1, 12, 64])
def test_hll_registers_direct_plain_matches_jax_ranks(bins):
    rng = np.random.default_rng(7)
    n = 30000
    v, live = _k12_inputs(rng, n)
    codes = rng.integers(0, bins, n).astype(np.int32)
    if bins > 1:
        codes[codes == 1] = 0                 # bin 1 holds no row
    reg, rank = _ref_reg_rank(v)
    regs, present, count = _numpy_registers(codes[live], reg[live],
                                            rank[live], bins)
    p_present, p_count, p_regs = PA.hll_registers(
        torch.from_numpy(v), torch.from_numpy(live),
        codes=torch.from_numpy(codes), bins=bins)
    np.testing.assert_array_equal(p_regs.numpy(), regs)
    np.testing.assert_array_equal(p_present.numpy(), present)
    np.testing.assert_array_equal(p_count.numpy(), count)


@pytest.mark.parametrize("edge", [PA.HLL_SMALL_MAX, PA.HLL_SMALL_MAX + 1,
                                  PA.HLL_PIECE, PA.HLL_PIECE + 1])
def test_hll_registers_sorted_plain_matches_jax_ranks(edge):
    """Runs of 1 row, of up to 32 rows (one thread each in K12), of
    hundreds (a warp) and of more than a piece (K12's blocks), an empty
    run, runs past the group count (ends == starts), and three runs at an
    edge of K12's tiers."""
    rng = np.random.default_rng(9)
    lengths = np.concatenate([
        np.ones(3000, np.int64), rng.integers(2, 33, 500),
        rng.integers(33, 900, 40), [0], [PA.HLL_PIECE * 2 + 5],
        [edge] * 3])
    rng.shuffle(lengths)
    n = int(lengths.sum())
    v, live = _k12_inputs(rng, n + 100)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    pad = 37
    starts = np.concatenate([starts, np.full(pad, 5)])
    ends = np.concatenate([ends, np.full(pad, 5)])
    gid = np.repeat(np.arange(len(lengths)), lengths)
    reg, rank = _ref_reg_rank(v[:n])
    keep = live[:n]
    _regs, present, count = _numpy_registers(
        gid[keep], reg[keep], rank[keep], len(starts))
    p_present, p_count, none = PA.hll_registers(
        torch.from_numpy(v), torch.from_numpy(live),
        starts=torch.from_numpy(starts), ends=torch.from_numpy(ends))
    assert none is None
    np.testing.assert_array_equal(p_present.numpy(), present)
    np.testing.assert_array_equal(p_count.numpy(), count)


def test_hll_registers_refuses_bad_arguments():
    v = torch.zeros(8, dtype=torch.int64)
    live = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        PA.hll_registers(v, live)
    with pytest.raises(TypeError):
        PA.hll_registers(v.to(torch.int16), live,
                         codes=torch.zeros(8, dtype=torch.int32), bins=1)
    with pytest.raises(TypeError):
        PA.hll_registers(v, live, codes=torch.zeros(8, dtype=torch.int32),
                         bins=65)


# -- (c) the estimate -------------------------------------------------------

def test_hll_estimate_raw_exact():
    rng = np.random.default_rng(13)
    zeros = rng.integers(0, 400, 5000)          # raw: few empty registers
    present = rng.random(5000) * 300.0
    ref = np.asarray(RA._hll_estimate(jnp.asarray(present),
                                      jnp.asarray(zeros)))
    port = PA._hll_estimate(torch.from_numpy(present),
                            torch.from_numpy(zeros)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_hll_estimate_small_range_rounds_equal_at_every_zero_count():
    zeros = np.arange(0, M + 1)
    for present in (np.zeros(M + 1), np.full(M + 1, 3.25)):
        ref = np.asarray(RA._hll_estimate(jnp.asarray(present),
                                          jnp.asarray(zeros)))
        port = PA._hll_estimate(torch.from_numpy(present),
                                torch.from_numpy(zeros)).numpy()
        np.testing.assert_array_equal(np.round(port), np.round(ref))
        assert np.all(np.abs(port - ref) <= np.spacing(np.abs(ref)))


# -- (d) K13's plain version ------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_segment_pick_plain_matches_jax(p, dtype):
    rng = np.random.default_rng(17)
    counts = rng.integers(0, 40, 300)
    counts[:3] = (0, 1, 2)
    starts = np.cumsum(counts) - counts
    vals = np.sort(rng.integers(-1000, 1000, int(counts.sum()) + 5)
                   ).astype(dtype)
    # the JAX package's pick (presto_tpu/ops/aggregate.py:753-757)
    idx = jnp.asarray(starts) + jnp.floor(
        p * jnp.maximum(jnp.asarray(counts) - 1, 0).astype(jnp.float64)
    ).astype(jnp.int32)
    want = np.asarray(jnp.take(jnp.asarray(vals),
                               jnp.clip(idx, 0, len(vals) - 1),
                               mode="clip"))
    got, null = PA._segment_pick_plain(torch.from_numpy(vals),
                                       torch.from_numpy(starts),
                                       torch.from_numpy(counts), p)
    np.testing.assert_array_equal(null.numpy(), counts == 0)
    np.testing.assert_array_equal(got.numpy()[counts > 0],
                                  want[counts > 0])


# -- (e) grouped_aggregate and the engine ------------------------------------

def _approx_columns(rng):
    """0 k varchar(4 words) with NULLs, 1 g bigint over 900 values (the
    sorted path) with NULLs, 2 x bigint with NULLs, 3 d double (full
    mantissas) with NULLs, 4 s varchar(60 words), 5 dt date, 6 b boolean,
    7 q double (whole numbers)."""
    words = [f"w{i:02d}" for i in range(60)]
    return [
        ("varchar", rng.integers(0, 4, N).astype(np.int32),
         rng.random(N) < 0.1, ["a", "b", "c", "d"]),
        ("bigint", rng.integers(0, 900, N), rng.random(N) < 0.05, None),
        ("bigint", rng.integers(-5000, 5000, N), rng.random(N) < 0.2, None),
        ("double", rng.standard_normal(N) * 1e3, rng.random(N) < 0.1, None),
        ("varchar", rng.integers(0, 60, N).astype(np.int32),
         rng.random(N) < 0.1, words),
        ("date", rng.integers(8000, 11000, N).astype(np.int32),
         rng.random(N) < 0.1, None),
        ("boolean", rng.random(N) < 0.4, np.zeros(N, bool), None),
        ("double", rng.integers(1, 51, N).astype(np.float64),
         np.zeros(N, bool), None),
    ]


def _approx_aggs(T, mod, p):
    S = mod.AggSpec
    return [
        S("approx_distinct", 2, T.BIGINT),
        S("approx_distinct", 3, T.BIGINT),
        S("approx_distinct", 4, T.BIGINT),
        S("approx_distinct", 2, T.BIGINT, mask_field=6),
        S("count", 2, T.BIGINT),
        S("approx_percentile", 2, T.BIGINT, param=p),
        S("approx_percentile", 3, T.DOUBLE, param=p),
        S("approx_percentile", 4, T.VARCHAR, param=p),
        S("approx_percentile", 5, T.DATE, param=p),
        S("approx_percentile", 7, T.DOUBLE, param=p, mask_field=6),
    ]


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("group_fields", [(0,), (), (1,), (1, 0)],
                         ids=["direct", "global", "sorted", "sorted2"])
def test_grouped_aggregate_approx_matches_jax(group_fields, p):
    rng = np.random.default_rng(19)
    cols = _approx_columns(rng)
    mask = rng.random(N) < 0.8
    ref, port = _pages(cols)
    rmask = jnp.asarray(np.pad(mask, (0, CAP - N)))
    pmask = torch.from_numpy(np.pad(mask, (0, CAP - N)))
    r_out, r_true = RA.grouped_aggregate(ref, group_fields,
                                         _approx_aggs(RT, RA, p), CAP,
                                         row_mask=rmask)
    p_out, p_true = PA.grouped_aggregate(port, group_fields,
                                         _approx_aggs(PT, PA, p), CAP,
                                         row_mask=pmask)
    assert int(p_true) == int(r_true)
    assert p_out.to_pylist() == r_out.to_pylist()


def _check_rows(name, got, want):
    """Every column exactly equal, but a1's DOUBLE approx_distinct (held
    by the next test) and the float sums (within 1e-6 relative)."""
    got, want = _sorted(got), _sorted(want)
    assert len(got) == len(want)
    sums = FLOAT_SUMS.get(name, ())
    for g, w in zip(got, want):
        for j, (x, y) in enumerate(zip(g, w)):
            if j in sums and x is not None and y is not None:
                assert abs(x - y) <= 1e-6 * max(abs(y), 1.0), (g, w)
            elif j != FLOAT_DISTINCT.get(name):
                assert x == y, (g, w)


@pytest.mark.parametrize("name", sorted(APPROX_TEST_QUERIES)
                         + sorted(APPROX_QUERIES) + sorted(ENGINE_CASES))
def test_approx_queries_match_jax_engine(engines, name):
    ref, port = engines
    sql = {**APPROX_TEST_QUERIES, **APPROX_QUERIES, **ENGINE_CASES}[name]
    want = ref.execute_sql(sql)
    got = port.execute_sql(sql)
    _check_rows(name, got, want)
    if name.startswith("empty_global"):
        assert got == [(0, None)]
    if name == "left_join_no_match_sorted":
        assert got and all(r[1:3] == (0, None) for r in got)


def test_float_approx_distinct_matches_jax_estimator_on_port_lanes(engines):
    """a1's approx_distinct(l_extendedprice): exactly the JAX estimator
    over the port's hash lanes (fed to it as the integers they are), and
    within three standard errors of numpy's exact distinct count."""
    _ref, port = engines
    got = port.execute_sql(APPROX_QUERIES["a1"])[0][FLOAT_DISTINCT["a1"]]
    t = TpchConnector(SF).table("lineitem")
    v = np.asarray(t.arrays["l_extendedprice"][:t.num_rows], np.float64)
    lanes = PK.f64_hash_lanes(torch.from_numpy(v)).numpy()
    reg, rank = _ref_reg_rank(lanes)
    _regs, present, count = _numpy_registers(np.zeros_like(reg), reg, rank,
                                             1)
    est = np.asarray(RA._hll_estimate(jnp.asarray(present),
                                      jnp.asarray(M - count)))
    assert got == int(np.round(est[0]))
    exact = len(np.unique(v))
    assert abs(got - exact) <= HLL_BOUND * exact


@pytest.mark.parametrize("kind", ["approx_distinct(x)",
                                  "approx_percentile(x, 0.5)"])
@pytest.mark.parametrize("grouped", [False, True])
def test_decimal38_inputs_raise_in_both_packages(kind, grouped):
    """The JAX package raises NotImplementedError for either kind over a
    DECIMAL(38) input (presto_tpu/ops/aggregate.py:245 and :583, before
    its l0 lane is hashed or sorted), and so does the port."""
    rows = [(i % 3, decimal.Decimal(10) ** 30 + i) for i in range(50)]
    sql = (f"select g, {kind} from w group by g" if grouped
           else f"select {kind} from w")
    for mem, T, engine in ((RefMemory(), RT, RefEngine),
                           (MemoryConnector(), PT, LocalEngine)):
        mem.create("w", [("g", T.BIGINT), ("x", T.DecimalType(38, 0))])
        mem.append_rows("w", rows)
        eng = engine(mem) if engine is RefEngine else engine(mem,
                                                             device="cpu")
        with pytest.raises(NotImplementedError, match="DECIMAL"):
            eng.execute_sql(sql)
