"""The port's joins and key hash against the JAX package's, on the CPU.

Each test builds one set of numpy inputs from a seed, hands it to the JAX
function (presto_tpu, run eagerly on the CPU as its own tests run it) and
to its counterpart in presto_tpu_torch (whose wrappers take their plain
PyTorch versions on CPU tensors), and compares:

- ops/keys.hash_columns (kernel K4): multi-column keys with NULLs over
  int64, int32 dictionary codes, booleans and float64 (NaN, +-0, +-inf);
- ops/join.merge_join (K4 + K5): inner, left, full, semi, anti and
  anti_exists with a NULL build key, duplicate build keys, string keys
  from two dictionaries;
- ops/join.hash_join (K4 + K5 + K6): inner and left with duplicates and
  NULL keys, overflow of the pair capacity, a cross join, semi and anti;
- the kernels' plain versions against their formulas.

Tolerance: none. Hashes, pages (row for row, in order), dup counts, match
flags and pair totals are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.data import column as RC
from presto_tpu.ops import join as RJ
from presto_tpu.ops import keys as RK
from presto_tpu_torch import types as PT
from presto_tpu_torch.data import column as PC
from presto_tpu_torch.ops import join as PJ
from presto_tpu_torch.ops import keys as PK

CAP = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU pages here are small: torch's intra-op threads do not speed
    these tests up (same wall time with 1 and 8), and under pytest-xdist
    they would take cores from the tests running beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pages(cols, n, cap=CAP):
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


def _same_page(p_page, r_page):
    """Equal row count, and every column equal on the valid rows: nulls
    everywhere, values where not NULL, in order."""
    n = int(r_page.num_rows)
    assert int(p_page.num_rows) == n
    assert p_page.capacity == r_page.capacity
    assert len(p_page.columns) == len(r_page.columns)
    for i, (pc, rc) in enumerate(zip(p_page.columns, r_page.columns)):
        pv, pn = pc.to_numpy(n)
        rv, rn = (np.asarray(rc.values)[:n], np.asarray(rc.nulls)[:n])
        np.testing.assert_array_equal(pn, rn, err_msg=f"nulls of col {i}")
        np.testing.assert_array_equal(pv[~pn], rv[~rn],
                                      err_msg=f"values of col {i}")
        if rc.dictionary is not None:
            assert pc.dictionary.words == rc.dictionary.words


def _join_sides(rng, np_rows=3000, nb_rows=1200, dup=False, nulls=True,
                key_range=1500):
    """probe: k bigint (NULLs), k2 integer, v double; build: k bigint
    (NULLs; unique unless dup), k2 integer, w varchar, b boolean."""
    pk = rng.integers(0, key_range, np_rows)
    p_null = (rng.random(np_rows) < 0.05) if nulls else np.zeros(
        np_rows, bool)
    if dup:
        bk = rng.integers(0, key_range, nb_rows)
    else:
        bk = rng.permutation(key_range * 2)[:nb_rows]
    b_null = np.zeros(nb_rows, bool)
    if nulls:
        b_null[rng.integers(0, nb_rows, 3)] = True
    probe = [("bigint", pk, p_null, None),
             ("integer", (pk % 3).astype(np.int32), np.zeros(np_rows, bool),
              None),
             ("double", rng.normal(0, 10, np_rows), rng.random(np_rows) < 0.1,
              None)]
    build = [("bigint", bk, b_null, None),
             ("integer", (bk % 3).astype(np.int32), np.zeros(nb_rows, bool),
              None),
             ("varchar", rng.integers(0, 4, nb_rows).astype(np.int32),
              rng.random(nb_rows) < 0.1, ["p", "q", "r", "s"]),
             ("boolean", rng.random(nb_rows) < 0.5, np.zeros(nb_rows, bool),
              None)]
    rp, pp = _pages(probe, np_rows)
    rb, pb = _pages(build, nb_rows)
    return rp, pp, rb, pb


# ---------------------------------------------------------------------------
# hash_columns (K4)
# ---------------------------------------------------------------------------

def _hash_cols(rng, n=3000):
    f = rng.normal(0.0, 1e3, n)
    f[:7] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 5e300]
    f[7:12] = [2.0 ** 40, -(2.0 ** -40), 1.5, 1e-300, 3.0]
    return [("bigint", rng.integers(-2 ** 62, 2 ** 62, n),
             rng.random(n) < 0.1, None),
            ("varchar", rng.integers(0, 7, n).astype(np.int32),
             rng.random(n) < 0.1, [f"w{i}" for i in range(7)]),
            ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.1, None),
            ("integer", rng.integers(-9, 9, n).astype(np.int32),
             np.zeros(n, bool), None),
            ("double", f, rng.random(n) < 0.05, None)]


@pytest.mark.parametrize("fields", [(0,), (1,), (2,), (0, 1, 2, 3),
                                    (4,), (3, 4, 0)],
                         ids=["bigint", "codes", "boolean", "four_lanes",
                              "double", "mixed_double"])
def test_hash_columns_matches_jax(fields):
    rng = np.random.default_rng(5)
    ref, port = _pages(_hash_cols(rng), 3000)
    r = np.asarray(RK.hash_columns([ref.columns[f] for f in fields]))
    p = PK.hash_columns([port.columns[f] for f in fields]).numpy()
    assert p.dtype == np.int64 and (p >= 0).all()
    np.testing.assert_array_equal(p, r)


def test_hash_columns_equal_floats_hash_equal():
    v = np.array([np.nan, -np.nan, 0.0, -0.0, 1.25, 1.25, -7.5, -7.5])
    col = PC.Column.from_numpy(v, PT.DOUBLE, device="cpu")
    h = PK.hash_columns([col]).numpy()
    assert h[0] == h[1] and h[2] == h[3] and h[4] == h[5] and h[6] == h[7]
    assert len({h[0], h[2], h[4], h[6]}) == 4


def test_f64_hash_lanes_matches_jax_on_special_values():
    v = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 0.75,
                  1e300, -3e-200])
    r = np.asarray(RK.f64_hash_lanes(jnp.asarray(v))).view(np.int64)
    p = PK.f64_hash_lanes(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(p, r)


# ---------------------------------------------------------------------------
# merge_join (K4 + K5)
# ---------------------------------------------------------------------------

FLAG_JOINS = ("semi", "anti", "anti_exists")


def _merge_both(rp, pp, rb, pb, pf, bf, jt):
    """The port's merge_join against the JAX function's. Semi and anti
    joins return no dup count in the port (nothing reads it): returns
    (page, dup_count or None)."""
    r_out, r_dup, r_match = RJ.merge_join(rp, rb, pf, bf, jt)
    p_out, p_dup, p_match = PJ.merge_join(pp, pb, pf, bf, jt)
    _same_page(p_out, r_out)
    if jt in FLAG_JOINS:
        assert p_dup is None
    else:
        assert int(p_dup) == int(r_dup)
    if r_match is None:
        assert p_match is None
    else:
        np.testing.assert_array_equal(p_match.numpy(), np.asarray(r_match))
    return p_out, None if p_dup is None else int(p_dup)


@pytest.mark.parametrize("jt", ["inner", "left", "full", "semi", "anti",
                                "anti_exists"])
def test_merge_join_matches_jax(jt):
    rng = np.random.default_rng(21)
    rp, pp, rb, pb = _join_sides(rng)
    out, dup = _merge_both(rp, pp, rb, pb, (0,), (0,), jt)
    assert dup == (None if jt in FLAG_JOINS else 0)
    if jt == "anti":
        # NOT IN with a NULL on the build side: nothing survives
        assert not bool(out.columns[-1].values.any())


@pytest.mark.parametrize("jt", ["anti", "anti_exists"])
def test_merge_join_anti_without_build_nulls_matches_jax(jt):
    rng = np.random.default_rng(22)
    rp, pp, rb, pb = _join_sides(rng, nulls=False)
    out, _ = _merge_both(rp, pp, rb, pb, (0,), (0,), jt)
    assert bool(out.columns[-1].values.any())


@pytest.mark.parametrize("jt", ["inner", "left", "full", "semi"])
def test_merge_join_counts_duplicate_build_keys_like_jax(jt):
    """The dup count equals the JAX function's for the joins whose caller
    reads it; a semi join's page still matches with duplicate keys."""
    rng = np.random.default_rng(23)
    rp, pp, rb, pb = _join_sides(rng, dup=True, key_range=600)
    _out, dup = _merge_both(rp, pp, rb, pb, (0, 1), (0, 1), jt)
    assert dup is None if jt in FLAG_JOINS else dup > 0


def test_merge_join_string_keys_from_two_dictionaries():
    rng = np.random.default_rng(24)
    pw = ["apple", "fig", "kiwi", "lime", "pear"]
    bw = ["banana", "fig", "lime", "pear", "plum", "yuzu"]
    probe = [("varchar", rng.integers(0, 5, 500).astype(np.int32),
              rng.random(500) < 0.05, pw),
             ("bigint", np.arange(500), np.zeros(500, bool), None)]
    build = [("varchar", np.arange(6, dtype=np.int32), np.zeros(6, bool),
              bw),
             ("double", rng.random(6), np.zeros(6, bool), None)]
    rp, pp = _pages(probe, 500, cap=1024)
    rb, pb = _pages(build, 6, cap=256)
    for jt in ("inner", "left"):
        out, _ = _merge_both(rp, pp, rb, pb, (0,), (0,), jt)
        assert int(out.num_rows) > 0


# ---------------------------------------------------------------------------
# hash_join (K4 + K5 + K6)
# ---------------------------------------------------------------------------

def _hash_both(rp, pp, rb, pb, pf, bf, cap, jt):
    r_out, r_total = RJ.hash_join(rp, rb, pf, bf, cap, jt)
    p_out, p_total = PJ.hash_join(pp, pb, pf, bf, cap, jt)
    _same_page(p_out, r_out)
    assert int(p_total) == int(r_total)
    return p_out, int(p_total)


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_hash_join_with_duplicates_and_nulls_matches_jax(jt):
    rng = np.random.default_rng(31)
    rp, pp, rb, pb = _join_sides(rng, dup=True, key_range=700)
    out, total = _hash_both(rp, pp, rb, pb, (0, 1), (0, 1), 16384, jt)
    assert int(out.num_rows) > 3000 - 200 and total <= 16384


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_hash_join_overflow_reports_the_true_total(jt):
    rng = np.random.default_rng(32)
    rp, pp, rb, pb = _join_sides(rng, dup=True, key_range=300)
    _out, total = _hash_both(rp, pp, rb, pb, (0,), (0,), 4096, jt)
    assert total > 4096


def test_hash_join_cross_join_matches_jax():
    rng = np.random.default_rng(33)
    probe = [("bigint", rng.integers(0, 9, 40), np.zeros(40, bool), None)]
    build = [("double", rng.random(30), rng.random(30) < 0.2, None)]
    rp, pp = _pages(probe, 40, cap=256)
    rb, pb = _pages(build, 30, cap=256)
    out, total = _hash_both(rp, pp, rb, pb, (), (), 4096, "inner")
    assert total == int(out.num_rows) == 1200


@pytest.mark.parametrize("jt", ["semi", "anti", "anti_exists"])
def test_hash_join_semi_anti_matches_jax(jt):
    rng = np.random.default_rng(34)
    rp, pp, rb, pb = _join_sides(rng, dup=True, key_range=2000,
                                 nulls=(jt != "anti"))
    _hash_both(rp, pp, rb, pb, (0,), (0,), 4096, jt)


# ---------------------------------------------------------------------------
# plain versions of K5 and K6
# ---------------------------------------------------------------------------

def test_join_probe_plain_modes_on_a_collision_window():
    """Two keys share one hash window: FIRST/LAST walk past the
    non-matching row, ALL flags every match, WINDOW reports the window."""
    bh_sorted = torch.tensor([-2, 5, 5, 5, 9], dtype=torch.int64)
    order = torch.tensor([4, 0, 1, 3, 2], dtype=torch.int64)
    bkeys = torch.tensor([7, 8, 1, 7, -1], dtype=torch.int64)
    ph = torch.tensor([5, 5, -1, 9, 6], dtype=torch.int64)
    pkeys = torch.tensor([7, 8, 7, 2, 7], dtype=torch.int64)
    lo, cnt, _, _ = PJ.join_probe(ph, bh_sorted, order, [pkeys], [bkeys],
                                  PJ.WINDOW)
    assert lo.tolist() == [1, 1, 1, 4, 4] and cnt.tolist() == [3, 3, 0, 1, 0]
    _, _, first, _ = PJ.join_probe(ph, bh_sorted, order, [pkeys], [bkeys],
                                   PJ.FIRST)
    _, _, last, _ = PJ.join_probe(ph, bh_sorted, order, [pkeys], [bkeys],
                                  PJ.LAST)
    _, _, every, flag = PJ.join_probe(ph, bh_sorted, order, [pkeys],
                                      [bkeys], PJ.ALL)
    assert first.tolist() == [0, 1, -1, -1, -1]
    assert last.tolist() == [3, 1, -1, -1, -1] == every.tolist()
    assert flag.tolist() == [True, True, False, True, False]


def test_dup_count_across_a_collision_window():
    """Rows 0, 2 and 4 share hash 5 with keys 7, 8, 7: row 4 duplicates
    row 0 although its sorted neighbour (row 2) has another key; row 5
    duplicates row 1; row 3 is dead (sentinel -2)."""
    bh = torch.tensor([5, 9, 5, -2, 5, 9, 3], dtype=torch.int64)
    bkeys = torch.tensor([7, 1, 8, 0, 7, 1, 4], dtype=torch.int64)
    bh_sorted, order = torch.sort(bh, stable=True)
    cand = PJ._dup_candidates(bh_sorted, order)
    assert cand.tolist() == [False, False, True, False, True, True, False]
    assert int(PJ._dup_count(bh, bh_sorted, order, [bkeys])) == 2


def test_join_expand_plain_layout():
    counts = torch.tensor([2, 0, 1, 3], dtype=torch.int64)
    wcnt = torch.tensor([2, 0, 0, 3], dtype=torch.int64)
    lo = torch.tensor([1, 0, 0, 2], dtype=torch.int64)
    order = torch.tensor([3, 0, 1, 2, 4], dtype=torch.int64)
    pk = torch.tensor([1, 0, 0, 2], dtype=torch.int64)
    bk = torch.tensor([1, 1, 2, 9, 2], dtype=torch.int64)
    pidx, bidx, bvalid, total = PJ.join_expand(counts, wcnt, lo, order,
                                               [pk], [bk], 8)
    assert int(total) == 6
    assert pidx.tolist() == [0, 0, 2, 3, 3, 3, 0, 0]
    assert bidx.tolist() == [0, 1, 3, 1, 2, 4, 0, 0]
    assert bvalid.tolist() == [True, True, False, False, True, True,
                               False, False]


# ---------------------------------------------------------------------------
# subnormal float keys
# ---------------------------------------------------------------------------

def _subnormal_sides():
    """Probe and build double keys of +-1e-310 (subnormal), +-0.0 and a
    few normal values, each build key once (merge joins need unique build
    keys up to key equality, so the build side holds one zero class)."""
    pk = np.array([1e-310, -1e-310, 0.0, -0.0, 1.5, 2.5, 1e-310, -2.0])
    bk = np.array([-1e-310, 1.5, 3.0, -2.0])
    probe = [("double", pk, np.zeros(8, bool), None),
             ("bigint", np.arange(8), np.zeros(8, bool), None)]
    build = [("double", bk, np.zeros(4, bool), None),
             ("bigint", np.arange(100, 104), np.zeros(4, bool), None)]
    rp, pp = _pages(probe, 8, cap=256)
    rb, pb = _pages(build, 4, cap=256)
    return rp, pp, rb, pb


@pytest.mark.parametrize("jt", ["inner", "left", "full", "semi", "anti"])
def test_subnormal_keys_join_like_jax(jt):
    """The JAX key functions flush float64 subnormals to zero on the CPU,
    so 1e-310, -1e-310, 0.0 and -0.0 are one key; the port's hash, its
    equality and both joins agree page for page."""
    rp, pp, rb, pb = _subnormal_sides()
    out, _ = _merge_both(rp, pp, rb, pb, (0,), (0,), jt)
    if jt == "inner":
        # five zero-class probe rows meet the -1e-310 build row; 1.5
        # and -2.0 match too
        assert int(out.num_rows) == 7
    if jt in ("inner", "left"):
        _hash_both(rp, pp, rb, pb, (0,), (0,), 1024, jt)
    h = PK.hash_columns([pp.columns[0]]).numpy()
    assert h[0] == h[1] == h[2] == h[3] == h[6]
