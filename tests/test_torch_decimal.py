"""DECIMAL(38) in the port against the JAX package, on the CPU.

- (a) Every function of presto_tpu_torch/data/int128.py against the JAX
  function (presto_tpu/data/int128.py) on 10^4 values drawn from a numpy
  seed over the full +-(10^38-1) range, with edge rows (0, +-1,
  +-(10^38-1), HALF_UP ties at +-x.5, products around 2^127): the limb
  lanes and overflow flags must be equal bit for bit, since the plain
  version is a line-for-line copy. `int128_op`, the wrapper of kernel K10,
  is held to the JAX compiler's composition of the same functions.
- (b) ops/aggregate.grouped_aggregate's sum128/avg128 (direct, global and
  sorted paths, K1's and K3's 128-bit sum modes in their plain versions)
  and min/max over DECIMAL(38) inputs against the JAX function on the
  same pages, including a group of 2 x 9.9e37, whose sum passes 2^127, and
  a mixed-sign average that ties.
- (c) The local-engine queries of tests/test_decimal128.py and
  tests/test_decimal38_paths.py through both engines, over the same
  MemoryConnector tables: rows equal exactly, errors of the same class.
- (d) TPC-H q01, q03, q06, q10 and q19 over lineitem typed as the spec
  types it (DECIMAL(12,2) money columns, SF 0.01) through both engines:
  rows equal exactly, Decimal for Decimal.
"""

import random
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors import MemoryConnector as RefMemory
from presto_tpu.connectors import TpchConnector as RefTpch
from presto_tpu.connectors.tpch import HostTable as RefHostTable
from presto_tpu.data import column as RC
from presto_tpu.data import int128 as RI
from presto_tpu.exec import LocalEngine as RefEngine
from presto_tpu.ops import aggregate as RA
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors import MemoryConnector, TpchConnector
from presto_tpu_torch.connectors.tpch import LINEITEM_MONEY, decimal_lineitem
from presto_tpu_torch.data import column as PC
from presto_tpu_torch.data import int128 as PI
from presto_tpu_torch.exec.engine import LocalEngine
from presto_tpu_torch.ops import aggregate as PA
from tests.tpch_queries import QUERIES as TPCH
from torch_threads import _one_torch_thread  # noqa: F401

M = 0xFFFFFFFF
BOUND = 10 ** 38 - 1
N = 10_000


# ---------------------------------------------------------------------------
# (a) data/int128.py
# ---------------------------------------------------------------------------

def _wide_ints(rng, n):
    """n python ints over +-(10^38-1), log-uniform in magnitude."""
    digits = rng.integers(1, 39, n)
    out = []
    for d, sign, a, b, c in zip(digits, rng.integers(0, 2, n),
                                rng.integers(0, 10 ** 13, n),
                                rng.integers(0, 10 ** 13, n),
                                rng.integers(0, 10 ** 13, n)):
        v = (int(a) * 10 ** 26 + int(b) * 10 ** 13 + int(c)) % 10 ** int(d)
        out.append(-v if sign else v)
    return out


def _edge_ints():
    ties = [x * 10 ** k + 5 * 10 ** (k - 1) for x in (0, 1, 7, 12345)
            for k in (1, 2, 9, 10, 19)]
    big = [2 ** 63, 2 ** 64, 2 ** 63 - 1, 2 ** 126, 10 ** 19, 13 * 10 ** 18]
    vals = [0, 1, BOUND, 10 ** 37, 99 * 10 ** 36] + ties + big
    return vals + [-v for v in vals]


def _split(ints, denormalize=False):
    """Four int64 limb lanes of python ints; denormalized lanes move part
    of l0 into l1 (the same values, as a sum or a product leaves them)."""
    lanes = [np.array([v >> 96 for v in ints], np.int64),
             np.array([(v >> 64) & M for v in ints], np.int64),
             np.array([(v >> 32) & M for v in ints], np.int64),
             np.array([v & M for v in ints], np.int64)]
    if denormalize:
        k = np.arange(len(ints), dtype=np.int64) % 5 - 2
        lanes[2] = lanes[2] - k
        lanes[3] = lanes[3] + (k << 32)
    return lanes


def _both(lanes):
    return (tuple(jnp.asarray(x) for x in lanes),
            tuple(torch.from_numpy(x.copy()) for x in lanes))


def _same(ref, port, what):
    """JAX outputs (arrays or nested tuples) equal the port's bit for
    bit."""
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(port), what
        for i, (r, p) in enumerate(zip(ref, port)):
            _same(r, p, f"{what}[{i}]")
        return
    r = np.asarray(ref)
    p = port.numpy()
    assert r.shape == p.shape, what
    np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=what)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(5)
    edge = _edge_ints()
    xs = _wide_ints(rng, N - len(edge)) + edge
    ys = _wide_ints(rng, N - len(edge)) + edge[::-1]
    return xs, ys


UNARY = {
    "normalize": lambda I, a: I.normalize(a),
    "negate": lambda I, a: I.negate(a),
    "is_negative": lambda I, a: I.is_negative(a),
    "_magnitude": lambda I, a: I._magnitude(a),
    "exceeds_decimal38": lambda I, a: I.exceeds_decimal38(a),
    "mul_pow10_1": lambda I, a: I.mul_pow10(a, 1),
    "mul_pow10_2": lambda I, a: I.mul_pow10(a, 2),
    "mul_pow10_19": lambda I, a: I.mul_pow10(a, 19),
    "div_pow10_1": lambda I, a: I.div_pow10(a, 1),
    "div_pow10_2": lambda I, a: I.div_pow10(a, 2),
    "div_pow10_10": lambda I, a: I.div_pow10(a, 10),
    "div_pow10_19": lambda I, a: I.div_pow10(a, 19),
}
BINARY = {
    "add": lambda I, a, b: I.add(a, b),
    "sub": lambda I, a, b: I.sub(a, b),
    "mul": lambda I, a, b: I.mul(a, b),
    "compare": lambda I, a, b: I.compare(a, b),
}


@pytest.mark.parametrize("denormalized", [False, True])
@pytest.mark.parametrize("name", sorted(UNARY))
def test_int128_unary_matches_jax(operands, name, denormalized):
    xs, _ys = operands
    ref, port = _both(_split(xs, denormalized))
    _same(UNARY[name](RI, ref), UNARY[name](PI, port), name)


@pytest.mark.parametrize("name", sorted(BINARY))
def test_int128_binary_matches_jax(operands, name):
    xs, ys = operands
    # products of values of about 19 digits each cross 2^127 in both
    # directions; a full-range pair mostly overflows
    if name == "mul":
        xs = [v % 10 ** 19 * (1 if v >= 0 else -1) for v in xs]
    ra, pa = _both(_split(xs))
    rb, pb = _both(_split(ys, denormalize=True))
    _same(BINARY[name](RI, ra, rb), BINARY[name](PI, pa, pb), name)


def test_int128_from_int64_and_python_int_match_jax():
    rng = np.random.default_rng(6)
    v = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, N),
                        np.array([0, 1, -1, 2 ** 63 - 1, -2 ** 63])])
    _same(RI.from_int64(jnp.asarray(v)), PI.from_int64(torch.from_numpy(v)),
          "from_int64")
    for x in (0, 1, -1, BOUND, -BOUND, 2 ** 100 + 7, -(2 ** 127)):
        _same(RI.from_python_int(x, (3,)), PI.from_python_int(x, (3,)),
              f"from_python_int({x})")


def test_int128_overflow_flags_at_the_bounds():
    """mul flags a product whose magnitude reaches 2^127, mul_pow10 a
    rescale past it; exceeds_decimal38 flags 10^38 and not 10^38-1."""
    a = [2 ** 63, 2 ** 63 - 1, -(2 ** 63), 10 ** 19, 0]
    b = [2 ** 64, 2 ** 64, 2 ** 64, 10 ** 19, BOUND]
    lanes_a, lanes_b = _split(a), _split(b)
    _, ovf = PI.mul(*[tuple(torch.from_numpy(x) for x in ln)
                      for ln in (lanes_a, lanes_b)])
    assert ovf.tolist() == [True, False, True, False, False]
    big = tuple(torch.from_numpy(x) for x in _split([10 ** 37, 2 * 10 ** 37]))
    _, ovf = PI.mul_pow10(big, 1)
    assert ovf.tolist() == [False, True]
    edge = tuple(torch.from_numpy(x) for x in _split(
        [BOUND, BOUND + 1, -BOUND, -BOUND - 1]))
    assert PI.exceeds_decimal38(edge).tolist() == [False, True, False, True]


def _py(lanes, i):
    return PI.to_python_int([x.numpy() for x in lanes], i)


def _ref_op(op, xs, ys, xsh, ysh):
    """The JAX compiler's composition (presto_tpu/expr/compile.py
    _wide_lanes/_arith_wide/_compare) on the JAX functions: (values or
    outputs, per-row decimal flags)."""
    def wide(v, k):
        lanes = tuple(jnp.asarray(x) for x in _split(v))
        if k > 0:
            lanes, ovf = RI.mul_pow10(lanes, k)
            return lanes, np.asarray(ovf)
        return (RI.div_pow10(lanes, -k) if k < 0 else lanes,
                np.zeros(len(v), bool))
    xl, fx = wide(xs, xsh)
    if op == "rescale":
        return xl, fx
    yl, fy = wide(ys, ysh)
    if op == "compare":
        lt, eq = RI.compare(xl, yl)
        return np.where(lt, -1, np.where(eq, 0, 1)), fx | fy
    if op == "multiply":
        out, ovf = RI.mul(xl, yl)
        return out, fx | fy | np.asarray(ovf) | np.asarray(
            RI.exceeds_decimal38(out))
    out = RI.add(xl, yl) if op == "add" else RI.sub(xl, yl)
    return out, fx | fy | np.asarray(RI.exceeds_decimal38(out))


@pytest.mark.parametrize("op,xsh,ysh", [
    ("rescale", 3, 0), ("rescale", -1, 0), ("rescale", -20, 0),
    ("add", 2, 0), ("subtract", 0, 1), ("multiply", 0, 0),
    ("compare", 0, 4)])
def test_int128_op_matches_the_jax_composition(operands, op, xsh, ysh):
    xs, ys = operands
    if op == "multiply":
        xs = [v % 10 ** 19 * (1 if v >= 0 else -1) for v in xs]
    px = tuple(torch.from_numpy(x) for x in _split(xs))
    py = tuple(torch.from_numpy(x) for x in _split(ys))
    valid = torch.from_numpy(np.arange(N) % 7 != 0)
    out, err, rows = PI.int128_op(
        op, px, None if op == "rescale" else py, x_shift=xsh, y_shift=ysh,
        valid=valid, row_flags=True)
    ref, flags = _ref_op(op, xs, ys, xsh, ysh)
    np.testing.assert_array_equal(rows.numpy() == PI.ERR_DECIMAL, flags)
    want = PI.ERR_DECIMAL if (flags & valid.numpy()).any() else 0
    assert int(err) == want
    if op == "compare":
        np.testing.assert_array_equal(out.numpy(), ref)
        return
    ok = ~flags
    r_np = [np.asarray(x) for x in ref]
    got = [_py(out, i) for i in np.flatnonzero(ok)]
    exp = [PI.to_python_int(r_np, i) for i in np.flatnonzero(ok)]
    assert got == exp


def test_int128_op_casts_match_the_jax_composition(operands):
    """to_double is the float image of the lanes divided by 10^scale;
    to_int64 rescales and range-checks as _cast_wide does."""
    xs, _ys = operands
    lanes = _split(xs, denormalize=True)
    px = tuple(torch.from_numpy(x) for x in lanes)
    img, _ = PI.int128_op("to_double", px, scale=4)
    rl = tuple(jnp.asarray(x) for x in lanes)
    ref = (rl[0].astype(jnp.float64) * float(2 ** 96)
           + rl[1].astype(jnp.float64) * float(2 ** 64)
           + rl[2].astype(jnp.float64) * float(2 ** 32)
           + rl[3].astype(jnp.float64)) / (10 ** 4)
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref))
    v, err, rows = PI.int128_op("to_int64", px, x_shift=-19,
                                valid=torch.ones(N, dtype=torch.bool),
                                lo=-2 ** 31, hi=2 ** 31 - 1, row_flags=True)
    ref_down = [np.asarray(x) for x in RI.div_pow10(rl, 19)]
    down = [PI.to_python_int(ref_down, i) for i in range(N)]
    fits = np.array([-2 ** 31 <= d < 2 ** 31 for d in down])
    np.testing.assert_array_equal(rows.numpy() == PI.ERR_CAST, ~fits)
    assert int(err) == (PI.ERR_CAST if (~fits).any() else 0)
    np.testing.assert_array_equal(v.numpy()[fits],
                                  np.array(down, dtype=object)[fits]
                                  .astype(np.int64))


# ---------------------------------------------------------------------------
# (b) sum128 / avg128 / wide min and max in grouped_aggregate
# ---------------------------------------------------------------------------

CAP = 4096
ROWS = 3000
WIDE = (38, 2)
WORDS = ["a", "b", "c", "d"]


def _agg_columns(rng):
    """0 k varchar (4 words, NULLs), 1 g bigint (600 values), 2 x
    DECIMAL(38,2) over the full range with NULLs, 3 q DECIMAL(12,2) int64,
    4 mask boolean. Group 'a' of k and group 0 of g hold 2 x 9.9e37 and
    nothing else; group 'b' / 1 holds the tie -3, 2 (sum -0.01, avg
    -0.005 -> -0.01); x is NULL throughout group 'c'."""
    k = rng.integers(2, 4, ROWS).astype(np.int32)
    g = rng.integers(2, 600, ROWS)
    x = _wide_ints(rng, ROWS)
    for i in range(ROWS):
        if k[i] == 2:
            x[i] = None
    big = 99 * 10 ** 36
    for i, (kk, gg, v) in enumerate([(0, 0, big), (0, 0, big),
                                     (1, 1, -3), (1, 1, 2)]):
        k[i], g[i], x[i] = kk, gg, v
    for i in range(4, ROWS):
        if g[i] < 2:
            g[i] += 2
        if x[i] is not None and rng.random() < 0.1:
            x[i] = None
    return k, g, x, rng.integers(-10 ** 12, 10 ** 12, ROWS), \
        rng.random(ROWS) < 0.9


def _agg_pages(cols):
    k, g, x, q, mask = cols
    rt = RT.DecimalType(*WIDE)
    ref = RC.Page.from_columns([
        RC.Column.from_numpy(k, RT.VARCHAR, nulls=np.arange(ROWS) % 11 == 5,
                             dictionary=RC.StringDict(WORDS), capacity=CAP),
        RC.Column.from_numpy(g, RT.BIGINT, capacity=CAP),
        RC.Decimal128Column.from_unscaled_ints(x, rt, capacity=CAP),
        RC.Column.from_numpy(q, RT.DecimalType(12, 2), capacity=CAP),
        RC.Column.from_numpy(mask, RT.BOOLEAN, capacity=CAP)], ROWS)
    port = PC.page_from_numpy(
        [(k, np.arange(ROWS) % 11 == 5, WORDS),
         (g, np.zeros(ROWS, bool), None),
         (x, np.array([v is None for v in x]), None),
         (q, np.zeros(ROWS, bool), None),
         (mask, np.zeros(ROWS, bool), None)],
        [PT.VARCHAR, PT.BIGINT, PT.DecimalType(*WIDE), PT.DecimalType(12, 2),
         PT.BOOLEAN], capacity=CAP, device="cpu")
    return ref, port


def _wide_aggs(T, mod):
    S = mod.AggSpec
    w = T.DecimalType(*WIDE)
    return [S("sum128", 2, w), S("avg128", 2, w), S("count", 2, T.BIGINT),
            S("min", 2, w), S("max", 2, w), S("avg128", 3, w),
            S("sum", 3, T.DecimalType(38, 2)),
            S("sum128", 2, w, mask_field=4)]


@pytest.mark.parametrize("path,fields", [("direct", [0]), ("global", []),
                                         ("sorted", [1])])
@pytest.mark.parametrize("masked", [False, True])
def test_wide_aggregates_match_jax(path, fields, masked):
    cols = _agg_columns(np.random.default_rng(9))
    ref, port = _agg_pages(cols)
    mask = np.pad(np.arange(ROWS) % 13 != 3, (0, CAP - ROWS))
    r_out, r_true = RA.grouped_aggregate(
        ref, fields, _wide_aggs(RT, RA), 1024,
        row_mask=jnp.asarray(mask) if masked else None)
    p_out, p_true = PA.grouped_aggregate(
        port, fields, _wide_aggs(PT, PA), 1024,
        row_mask=torch.from_numpy(mask) if masked else None)
    assert int(p_true) == int(r_true)
    rows = p_out.to_pylist()
    assert rows == r_out.to_pylist()
    if not masked:
        # the 2 x 9.9e37 group sums past 2^127 exactly; the tie rounds
        # HALF_UP away from zero
        sums = {r[0]: (r[1], r[2]) for r in rows} if fields else {}
        key_big, key_tie = ("a", "b") if path == "direct" else (0, 1)
        if fields:
            assert sums[key_big][0] == Decimal(198 * 10 ** 36) / 100
            assert sums[key_tie] == (Decimal("-0.01"), Decimal("-0.01"))


# ---------------------------------------------------------------------------
# (c) the local-engine queries of test_decimal128.py / test_decimal38_paths
# ---------------------------------------------------------------------------

def _li_rows():
    rows = []
    for i in range(500):
        rows.append((
            "ANR"[i % 3], "FO"[i % 2],
            float(Decimal(i % 50 + 1)),
            float(Decimal((i * 7919) % 99999) / 100),
            float(Decimal(i % 10) / 100),
            float(Decimal(i % 8) / 100)))
    return rows


def _cents(v: int) -> Decimal:
    """v / 100, exactly (the default context would round 38 digits)."""
    return PC.scale_down_decimal(v, 2)


def _paths_rows(n, seed):
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        if i % 37 == 0:
            x = None
        else:
            mag = rng.choice([10 ** 5, 10 ** 18, 10 ** 30, 10 ** 35])
            x = _cents(rng.randint(-9 * mag, 9 * mag))
        rows.append(("gh"[i % 2], x, _cents(rng.randint(-99, 99))))
    return rows


def _arith_rows():
    rng = random.Random(11)
    rows = []
    for i in range(200):
        x = (None if i % 37 == 0 else
             _cents(rng.randint(-9 * 10 ** 32, 9 * 10 ** 32)))
        rows.append(("gh"[i % 2], x, _cents(rng.randint(-99, 99))))
    return rows


def _tables(T):
    """name -> (schema, rows) for both packages' types module T."""
    W = T.DecimalType(38, 2)
    big = 99 * 10 ** 36
    base = 10 ** 17
    return {
        "li": ([("flag", T.VARCHAR), ("status", T.VARCHAR),
                ("quantity", T.DecimalType(19, 2)),
                ("extendedprice", T.DecimalType(20, 2)),
                ("discount", T.DecimalType(4, 2)),
                ("tax", T.DecimalType(4, 2))], _li_rows()),
        "big": ([("v", T.DecimalType(19, 0))],
                [(9_000_000_000_000_000,)] * 2000),
        "neg": ([("v", T.DecimalType(20, 2))],
                [(v,) for v in (123.45, -678.90, -0.01, 999999.99,
                                -999999.99, 0.0)]),
        "dx": ([("g", T.DecimalType(3, 0)), ("v", T.DecimalType(38, 0))],
               [(1, float(base)), (1, 1.0), (2, float(base)), (2, 2.0),
                (3, float(base)), (3, 0.0)]),
        "t": ([("g", T.VARCHAR), ("x", W), ("y", T.DecimalType(4, 2))],
              _paths_rows(600, 7)),
        "ta": ([("g", T.VARCHAR), ("x", W), ("y", T.DecimalType(4, 2))],
               _arith_rows()),
        "sq": ([("x", W)], [(Decimal(10) ** 35,), (Decimal(10) ** 35,)]),
        "cx": ([("x", W)], [(Decimal("12345.67"),), (Decimal("-2.50"),)]),
        "cbig": ([("x", W)], [(Decimal(10) ** 30,)]),
        "b38": ([("x", T.DecimalType(38, 0))], [(Decimal(big),)]),
        "carry": ([("g", T.BIGINT), ("x", T.DecimalType(38, 0))],
                  [(1, big), (1, big), (2, -big), (2, -big),
                   (3, big), (3, big), (3, -1), (4, -big), (4, -big),
                   (4, 1)]),
    }


CASES = {
    "q1_shape": """
        select flag, status, sum(quantity), sum(extendedprice),
               sum(extendedprice * (1 - discount)),
               sum(extendedprice * (1 - discount) * (1 + tax)), count(*)
        from li group by flag, status order by flag, status""",
    "avg_half_up": "select flag, avg(quantity) from li group by flag "
                   "order by flag",
    "sum_beyond_int64": "select sum(v) from big",
    "negative_values": "select sum(v), count(v) from neg",
    "order_by_sum_desc": "select g, sum(v) as s from dx group by g "
                         "order by s desc",
    "order_by_sum_asc": "select g, sum(v) as s from dx group by g "
                        "order by s asc",
    "storage_roundtrip": "select x from t",
    "sum_avg_direct": "select g, sum(x), avg(x) from t group by g order by g",
    "arithmetic": "select g, sum(x * (1 - y)), sum(x + x), sum(-x) "
                  "from ta group by g order by g",
    "compare_filter": f"select count(*) from t where x > {10 ** 30}",
    "mul_overflow": "select x * x from sq",
    "divide_as_double": "select sum(x) / count(x) from t",
    "cast_bigint": "select cast(x as bigint) from cx",
    "cast_narrow": "select cast(x as decimal(10,1)) from cx",
    "cast_out_of_range": "select cast(x as bigint) from cbig",
    "min_max_grouped": "select g, min(x), max(x) from t group by g "
                       "order by g",
    "min_max_global": "select min(x), max(x) from t",
    "add_overflow_bound": "select x + x from b38",
    "literal_out_of_range": f"select count(*) from t where x > {10 ** 39}",
    "carry_past_2_127": "select g, sum(x), avg(x), min(x), max(x) "
                        "from carry group by g order by g",
    "carry_global": "select sum(x), count(x) from carry where g in (1, 4)",
}


@pytest.fixture(scope="module")
def decimal_engines():
    rmem, pmem = RefMemory(), MemoryConnector()
    for mem, T in ((rmem, RT), (pmem, PT)):
        for name, (schema, rows) in _tables(T).items():
            mem.create(name, schema)
            mem.append_rows(name, rows)
    return RefEngine(rmem), LocalEngine(pmem, device="cpu")


def _run(engine, sql):
    try:
        return engine.execute_sql(sql), None
    except Exception as e:      # the error class is the result compared
        return None, type(e).__name__


@pytest.mark.parametrize("name", sorted(CASES))
def test_decimal_queries_match_jax_engine(decimal_engines, name):
    ref, port = decimal_engines
    sql = CASES[name]
    expected, ref_err = _run(ref, sql)
    got, port_err = _run(port, sql)
    assert port_err == ref_err, (port_err, ref_err)
    if ref_err is not None:
        return
    if "order by" not in sql:
        expected, got = sorted(expected, key=repr), sorted(got, key=repr)
    assert got == expected
    if name == "carry_past_2_127":
        sums = [r[1] for r in got]
        assert sums == [198 * 10 ** 36, -198 * 10 ** 36,
                        198 * 10 ** 36 - 1, -198 * 10 ** 36 + 1]


# ---------------------------------------------------------------------------
# (d) spec-typed TPC-H q01, q03, q06, q10, q19 at SF 0.01
# ---------------------------------------------------------------------------

SF = 0.01


@pytest.fixture(scope="module")
def tpch_engines():
    table = decimal_lineitem(SF)
    port = MemoryConnector(fallback=TpchConnector(SF))
    port.register(table)
    src = RefTpch(SF).table("lineitem")
    arrays, types = dict(src.arrays), dict(src.types)
    for c in LINEITEM_MONEY:
        arrays[c] = table.arrays[c]
        types[c] = RT.DecimalType(12, 2)
    ref = RefMemory(fallback=RefTpch(SF))
    ref.tables["lineitem"] = RefHostTable("lineitem", src.num_rows, arrays,
                                          types, src.dicts)
    return RefEngine(ref), LocalEngine(port, device="cpu")


@pytest.mark.parametrize("q", [1, 3, 6, 10, 19])
def test_spec_typed_tpch_matches_jax_engine(tpch_engines, q):
    ref, port = tpch_engines
    expected = ref.execute_sql(TPCH[q])
    assert expected
    got = port.execute_sql(TPCH[q])
    assert got == expected
    assert any(isinstance(v, Decimal) for v in got[0])


def test_decimal_lineitem_rounds_as_unscale_decimal():
    table = decimal_lineitem(SF)
    src = TpchConnector(SF).table("lineitem")
    for c in LINEITEM_MONEY:
        want = [PC.unscale_decimal(float(v), 2)
                for v in src.arrays[c][:src.num_rows:97]]
        assert table.arrays[c][::97].tolist() == want, c
