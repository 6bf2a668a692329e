"""TPC-H connector: deterministic in-memory data generation.

Reference role: presto-tpch (presto-tpch/src/main/java/com/facebook/presto/
tpch/TpchConnectorFactory.java, TpchRecordSetProvider) — data generated on
the fly from split info, no external files; the standard deterministic
fixture for every engine test (SURVEY.md §4).

This generator is *spec-shaped*, not bit-identical to dbgen: row counts,
key relationships (lineitem->orders, partsupp's 4-suppliers-per-part
formula, customers without orders), value distributions and date ranges
follow the TPC-H spec so query selectivities and join fan-outs are
realistic; exact values differ from airlift's dbgen port. Correctness
testing compares against a pandas oracle over the *same* data
(tests/oracle.py), mirroring the reference's H2QueryRunner strategy
(presto-tests/.../H2QueryRunner.java).

Tables partition by primary-key row ranges (part k of n), matching the
reference's split model where tpch splits are self-describing
(TpchSplitManager). Splits are row-range slices of the cached full table
so string codes share one table-wide StringDict — the invariant every
cross-device exchange and dictionary-aligned operator relies on.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch.data.column import (
    Column, Decimal128Column, NestedArrays, Page, StringDict,
    bucket_capacity, resolve_device, unscale_array,
)
from presto_tpu_torch.expr.compile import days_from_civil
from presto_tpu_torch.types import (
    BIGINT, DATE, DOUBLE, INTEGER, VARCHAR, ArrayType, DecimalType, MapType,
    Type,
)

# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

TPCH_SCHEMA: Dict[str, List[Tuple[str, Type]]] = {
    "region": [("r_regionkey", BIGINT), ("r_name", VARCHAR),
               ("r_comment", VARCHAR)],
    "nation": [("n_nationkey", BIGINT), ("n_name", VARCHAR),
               ("n_regionkey", BIGINT), ("n_comment", VARCHAR)],
    "supplier": [("s_suppkey", BIGINT), ("s_name", VARCHAR),
                 ("s_address", VARCHAR), ("s_nationkey", BIGINT),
                 ("s_phone", VARCHAR), ("s_acctbal", DOUBLE),
                 ("s_comment", VARCHAR)],
    "customer": [("c_custkey", BIGINT), ("c_name", VARCHAR),
                 ("c_address", VARCHAR), ("c_nationkey", BIGINT),
                 ("c_phone", VARCHAR), ("c_acctbal", DOUBLE),
                 ("c_mktsegment", VARCHAR), ("c_comment", VARCHAR)],
    "part": [("p_partkey", BIGINT), ("p_name", VARCHAR), ("p_mfgr", VARCHAR),
             ("p_brand", VARCHAR), ("p_type", VARCHAR), ("p_size", INTEGER),
             ("p_container", VARCHAR), ("p_retailprice", DOUBLE),
             ("p_comment", VARCHAR)],
    "partsupp": [("ps_partkey", BIGINT), ("ps_suppkey", BIGINT),
                 ("ps_availqty", INTEGER), ("ps_supplycost", DOUBLE),
                 ("ps_comment", VARCHAR)],
    "orders": [("o_orderkey", BIGINT), ("o_custkey", BIGINT),
               ("o_orderstatus", VARCHAR), ("o_totalprice", DOUBLE),
               ("o_orderdate", DATE), ("o_orderpriority", VARCHAR),
               ("o_clerk", VARCHAR), ("o_shippriority", INTEGER),
               ("o_comment", VARCHAR)],
    "lineitem": [("l_orderkey", BIGINT), ("l_partkey", BIGINT),
                 ("l_suppkey", BIGINT), ("l_linenumber", INTEGER),
                 ("l_quantity", DOUBLE), ("l_extendedprice", DOUBLE),
                 ("l_discount", DOUBLE), ("l_tax", DOUBLE),
                 ("l_returnflag", VARCHAR), ("l_linestatus", VARCHAR),
                 ("l_shipdate", DATE), ("l_commitdate", DATE),
                 ("l_receiptdate", DATE), ("l_shipinstruct", VARCHAR),
                 ("l_shipmode", VARCHAR), ("l_comment", VARCHAR)],
}

_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCTS = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
              "TAKE BACK RETURN"]
_CONTAINERS = [f"{a} {b}" for a in
               ["SM", "LG", "MED", "JUMBO", "WRAP"] for b in
               ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]]
_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_PTYPES = [f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2
           for c in _TYPE_S3]
_PNAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "hotpink", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
_COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "final", "pending", "regular", "express", "special", "bold", "even",
    "silent", "unusual", "requests", "deposits", "packages", "accounts",
    "instructions", "theodolites", "platelets", "foxes", "ideas", "courts",
    "sleep", "wake", "nag", "haggle", "cajole", "detect", "integrate",
    "among", "across", "above", "against", "along",
]

_MIN_DATE = days_from_civil(1992, 1, 1)
_MAX_ORDER_DATE = days_from_civil(1998, 8, 2)
_CURRENT = days_from_civil(1995, 6, 17)  # dbgen CURRENTDATE analogue

_SF_BASE = {"supplier": 10_000, "customer": 150_000, "part": 200_000,
            "orders": 1_500_000}
_SUPP_PER_PART = 4
_SCHEMA_SCALES = {"tiny": 0.001, "sf0.01": 0.01, "sf0.1": 0.1, "sf1": 1.0,
                  "sf10": 10.0, "sf100": 100.0}


def _counts(sf: float) -> Dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(10, int(_SF_BASE["supplier"] * sf)),
        "customer": max(15, int(_SF_BASE["customer"] * sf)),
        "part": max(20, int(_SF_BASE["part"] * sf)),
        "orders": max(150, int(_SF_BASE["orders"] * sf)),
    }


def _comment(rng: np.random.Generator, n: int, words: int = 4) -> np.ndarray:
    w = np.asarray(_COMMENT_WORDS, dtype=object)
    idx = rng.integers(0, len(w), size=(n, words))
    out = w[idx[:, 0]]
    for k in range(1, words):
        out = out + " " + w[idx[:, k]]
    return out


def _phone(rng: np.random.Generator, nation: np.ndarray) -> np.ndarray:
    a = nation + 10
    b = rng.integers(100, 1000, size=len(nation))
    c = rng.integers(100, 1000, size=len(nation))
    d = rng.integers(1000, 10000, size=len(nation))
    return np.char.add(np.char.add(np.char.add(np.char.add(
        a.astype(str), "-"), b.astype(str)), "-"),
        np.char.add(np.char.add(c.astype(str), "-"), d.astype(str))
    ).astype(object)


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    return (90000 + ((partkey // 10) % 20001) + 100 * (partkey % 1000)) / 100.0


def _part_suppliers(partkey: np.ndarray, j: np.ndarray, num_supp: int
                    ) -> np.ndarray:
    """dbgen-style formula: the j-th supplier of part p (j in [0,4))."""
    return ((partkey - 1 + j * (num_supp // _SUPP_PER_PART + 1)) % num_supp
            ) + 1


@dataclasses.dataclass
class HostTable:
    """Host-side generated table: numeric numpy arrays (string columns
    stored as int32 codes) + shared StringDicts. `page()` uploads a
    column-pruned, bucket-padded device Page. `nulls` is optional (the
    TPC fixtures are null-free; written tables — connectors/memory.py —
    carry real null masks). An ARRAY/MAP/ROW column is held as a
    data/column.NestedArrays."""
    name: str
    num_rows: int
    arrays: Dict[str, np.ndarray]
    types: Dict[str, Type]
    dicts: Dict[str, StringDict]
    nulls: Optional[Dict[str, np.ndarray]] = None

    def column_names(self) -> List[str]:
        return list(self.types)      # schema insertion order

    def null_mask(self, c: str) -> Optional[np.ndarray]:
        if self.nulls is None:
            return None
        m = self.nulls.get(c)
        return m[:self.num_rows] if m is not None else None

    def row_slice(self, lo: int, hi: int) -> "HostTable":
        """A [lo, hi) row window as a VIEW table: numpy slices share the
        parent's buffers and StringDicts — no copy, and no entry in the
        parent's device-page cache (run tables are throwaway by design;
        streaming scans upload each run once). Column access goes
        through `arrays[c]` so lazy tables (parquet) load on demand."""
        arrays = {c: self.arrays[c][lo:hi] for c in self.column_names()}
        nulls = None
        if self.nulls is not None:
            nulls = {c: m[lo:hi] for c, m in
                     ((c, self.null_mask(c)) for c in self.column_names())
                     if m is not None}
        return HostTable(self.name, hi - lo, arrays, self.types,
                         self.dicts, nulls)

    def page(self, columns: Optional[Sequence[str]] = None,
             capacity: Optional[int] = None, device=None) -> Page:
        """The table as a Page on `device` (None means the card). Columns
        are cached per (column, capacity, device), so re-executions reuse
        resident columns instead of uploading them again; different
        column subsets share entries because caching is per column. The
        cache lives on the HostTable instance (the lru-cached whole
        tables of the engine path)."""
        dev = resolve_device(device)
        cols = list(columns) if columns is not None else self.column_names()
        cap = capacity or bucket_capacity(self.num_rows)
        cache = self.__dict__.setdefault("_dev_page_cache", {})
        out = []
        for c in cols:
            key = (c, cap, str(dev))
            col = cache.get(key)
            if col is None:
                t = self.types[c]
                if t.name in ("array", "map", "row"):
                    # data/column.NestedArrays: numpy row lanes and
                    # children
                    col = self.arrays[c][:self.num_rows].column(
                        t, capacity=cap, device=dev)
                elif getattr(t, "uses_int128", False):
                    # DECIMAL(p>18) at rest: python-int unscaled values
                    # -> four 32-bit limb lanes (exact 38-digit range)
                    col = Decimal128Column.from_unscaled_ints(
                        list(self.arrays[c][:self.num_rows]), t,
                        nulls=self.null_mask(c), capacity=cap, device=dev)
                else:
                    col = Column.from_numpy(
                        self.arrays[c][:self.num_rows], t,
                        nulls=self.null_mask(c),
                        dictionary=self.dicts.get(c), capacity=cap,
                        device=dev)
                cache[key] = col
            out.append(col)
        return Page.from_columns(out, self.num_rows, cols, device=dev)


def _dictify(values: np.ndarray) -> Tuple[np.ndarray, StringDict]:
    d, codes = StringDict.build(values)
    return codes, d


def _slice_rows(total: int, part: int, num_parts: int) -> Tuple[int, int]:
    per = (total + num_parts - 1) // num_parts
    lo = min(part * per, total)
    hi = min(lo + per, total)
    return lo, hi


def _seed(name: str, sf: float, part: int) -> int:
    """Stable across processes (python hash() is per-process randomized —
    workers on different hosts must regenerate identical splits)."""
    import zlib
    return zlib.crc32(f"{name}|{sf}|{part}".encode())


@functools.lru_cache(maxsize=64)
def _gen_table(name: str, sf: float) -> HostTable:
    # Whole-table generation only: splits are row-range slices served by
    # TpchConnector.table() so codes share one table-wide StringDict.
    part, num_parts = 0, 1
    c = _counts(sf)
    rng = np.random.default_rng(
        _seed(name if name != "lineitem" else "orders", sf, part))
    types = dict(TPCH_SCHEMA[name])
    arrays: Dict[str, np.ndarray] = {}
    dicts: Dict[str, StringDict] = {}

    def put_str(col: str, vals: np.ndarray):
        arrays[col], dicts[col] = _dictify(vals)

    if name == "region":
        lo, hi = _slice_rows(5, part, num_parts)
        arrays["r_regionkey"] = np.arange(lo, hi, dtype=np.int64)
        put_str("r_name", np.asarray(_REGIONS, dtype=object)[lo:hi])
        put_str("r_comment", _comment(rng, hi - lo))
        n = hi - lo
    elif name == "nation":
        lo, hi = _slice_rows(25, part, num_parts)
        arrays["n_nationkey"] = np.arange(lo, hi, dtype=np.int64)
        put_str("n_name", np.asarray([x[0] for x in _NATIONS],
                                     dtype=object)[lo:hi])
        arrays["n_regionkey"] = np.asarray(
            [x[1] for x in _NATIONS], dtype=np.int64)[lo:hi]
        put_str("n_comment", _comment(rng, hi - lo))
        n = hi - lo
    elif name == "supplier":
        lo, hi = _slice_rows(c["supplier"], part, num_parts)
        n = hi - lo
        key = np.arange(lo + 1, hi + 1, dtype=np.int64)
        arrays["s_suppkey"] = key
        put_str("s_name", np.char.add("Supplier#",
                np.char.zfill(key.astype(str), 9)).astype(object))
        put_str("s_address", _comment(rng, n, 2))
        nat = rng.integers(0, 25, size=n)
        arrays["s_nationkey"] = nat.astype(np.int64)
        put_str("s_phone", _phone(rng, nat))
        arrays["s_acctbal"] = np.round(
            rng.uniform(-999.99, 9999.99, size=n), 2)
        # ~5 of every 1000 suppliers complain, ~5 recommend (Q16/Q21)
        comm = _comment(rng, n)
        tag = rng.integers(0, 1000, size=n)
        comm = np.where(tag < 5, "Customer Complaints " + comm, comm)
        comm = np.where(tag >= 995, "Customer Recommends " + comm, comm)
        put_str("s_comment", comm.astype(object))
    elif name == "customer":
        lo, hi = _slice_rows(c["customer"], part, num_parts)
        n = hi - lo
        key = np.arange(lo + 1, hi + 1, dtype=np.int64)
        arrays["c_custkey"] = key
        put_str("c_name", np.char.add("Customer#",
                np.char.zfill(key.astype(str), 9)).astype(object))
        put_str("c_address", _comment(rng, n, 2))
        nat = rng.integers(0, 25, size=n)
        arrays["c_nationkey"] = nat.astype(np.int64)
        put_str("c_phone", _phone(rng, nat))
        arrays["c_acctbal"] = np.round(
            rng.uniform(-999.99, 9999.99, size=n), 2)
        put_str("c_mktsegment",
                np.asarray(_SEGMENTS, dtype=object)[
                    rng.integers(0, 5, size=n)])
        put_str("c_comment", _comment(rng, n, 6))
    elif name == "part":
        lo, hi = _slice_rows(c["part"], part, num_parts)
        n = hi - lo
        key = np.arange(lo + 1, hi + 1, dtype=np.int64)
        arrays["p_partkey"] = key
        w = np.asarray(_PNAME_WORDS, dtype=object)
        idx = rng.integers(0, len(w), size=(n, 5))
        nm = w[idx[:, 0]]
        for k in range(1, 5):
            nm = nm + " " + w[idx[:, k]]
        put_str("p_name", nm)
        mfgr = rng.integers(1, 6, size=n)
        put_str("p_mfgr", np.char.add("Manufacturer#",
                                      mfgr.astype(str)).astype(object))
        brand = mfgr * 10 + rng.integers(1, 6, size=n)
        put_str("p_brand", np.char.add("Brand#",
                                       brand.astype(str)).astype(object))
        put_str("p_type", np.asarray(_PTYPES, dtype=object)[
            rng.integers(0, len(_PTYPES), size=n)])
        arrays["p_size"] = rng.integers(1, 51, size=n).astype(np.int32)
        put_str("p_container", np.asarray(_CONTAINERS, dtype=object)[
            rng.integers(0, len(_CONTAINERS), size=n)])
        arrays["p_retailprice"] = _retailprice(key)
        put_str("p_comment", _comment(rng, n, 2))
    elif name == "partsupp":
        lo, hi = _slice_rows(c["part"], part, num_parts)
        n = (hi - lo) * _SUPP_PER_PART
        pk = np.repeat(np.arange(lo + 1, hi + 1, dtype=np.int64),
                       _SUPP_PER_PART)
        j = np.tile(np.arange(_SUPP_PER_PART, dtype=np.int64), hi - lo)
        arrays["ps_partkey"] = pk
        arrays["ps_suppkey"] = _part_suppliers(pk, j, c["supplier"])
        arrays["ps_availqty"] = rng.integers(
            1, 10000, size=n).astype(np.int32)
        arrays["ps_supplycost"] = np.round(
            rng.uniform(1.0, 1000.0, size=n), 2)
        put_str("ps_comment", _comment(rng, n, 6))
    elif name in ("orders", "lineitem"):
        return _gen_orders_lineitem(name, sf)
    else:
        raise KeyError(name)

    return HostTable(name, n, arrays, types, dicts)


@functools.lru_cache(maxsize=32)
def _gen_orders_lineitem(which: str, sf: float) -> HostTable:
    """Orders and their lineitems generate together (totalprice is the sum
    of its lines). Whole-table only — splits are slices, see table()."""
    part, num_parts = 0, 1
    c = _counts(sf)
    rng = np.random.default_rng(_seed("orders", sf, part))
    lo, hi = _slice_rows(c["orders"], part, num_parts)
    n = hi - lo
    okey = np.arange(lo + 1, hi + 1, dtype=np.int64)
    # Customers with c%3==0 never order (dbgen leaves 1/3 of customers
    # orderless — exercised by Q13/Q22).
    ck = rng.integers(1, c["customer"] + 1, size=n).astype(np.int64)
    ck = np.where(ck % 3 == 0, (ck % (c["customer"] - 1)) + 1, ck)
    ck = np.where(ck % 3 == 0, ck + 1, ck)
    odate = rng.integers(_MIN_DATE, _MAX_ORDER_DATE - 121, size=n
                         ).astype(np.int32)

    nlines = rng.integers(1, 8, size=n)
    total_lines = int(nlines.sum())
    l_okey = np.repeat(okey, nlines)
    l_odate = np.repeat(odate, nlines)
    starts = np.concatenate([[0], np.cumsum(nlines)[:-1]])
    l_lineno = (np.arange(total_lines) -
                np.repeat(starts, nlines) + 1).astype(np.int32)

    pk = rng.integers(1, c["part"] + 1, size=total_lines).astype(np.int64)
    j = rng.integers(0, _SUPP_PER_PART, size=total_lines).astype(np.int64)
    sk = _part_suppliers(pk, j, c["supplier"])
    qty = rng.integers(1, 51, size=total_lines).astype(np.float64)
    eprice = qty * _retailprice(pk)
    disc = rng.integers(0, 11, size=total_lines) / 100.0
    tax = rng.integers(0, 9, size=total_lines) / 100.0
    sdate = (l_odate + rng.integers(1, 122, size=total_lines)).astype(np.int32)
    cdate = (l_odate + rng.integers(30, 91, size=total_lines)).astype(np.int32)
    rdate = (sdate + rng.integers(1, 31, size=total_lines)).astype(np.int32)
    returned = rdate <= _CURRENT
    rflag = np.where(returned,
                     np.where(rng.random(total_lines) < 0.5, "R", "A"),
                     "N").astype(object)
    lstatus = np.where(sdate > _CURRENT, "O", "F").astype(object)

    if which == "lineitem":
        arrays: Dict[str, np.ndarray] = {
            "l_orderkey": l_okey, "l_partkey": pk, "l_suppkey": sk,
            "l_linenumber": l_lineno, "l_quantity": qty,
            "l_extendedprice": eprice, "l_discount": disc, "l_tax": tax,
            "l_shipdate": sdate, "l_commitdate": cdate,
            "l_receiptdate": rdate,
        }
        dicts: Dict[str, StringDict] = {}

        def put_str(col, vals):
            arrays[col], dicts[col] = _dictify(vals)
        put_str("l_returnflag", rflag)
        put_str("l_linestatus", lstatus)
        put_str("l_shipinstruct", np.asarray(_INSTRUCTS, dtype=object)[
            rng.integers(0, 4, size=total_lines)])
        put_str("l_shipmode", np.asarray(_SHIPMODES, dtype=object)[
            rng.integers(0, 7, size=total_lines)])
        put_str("l_comment", _comment(rng, total_lines, 3))
        return HostTable("lineitem", total_lines, arrays,
                         dict(TPCH_SCHEMA["lineitem"]), dicts)

    # orders
    line_total = eprice * (1.0 + tax) * (1.0 - disc)
    totalprice = np.add.reduceat(line_total, starts)
    any_open = np.add.reduceat((lstatus == "O").astype(np.int64), starts)
    nline_arr = nlines
    status = np.where(any_open == 0, "F",
                      np.where(any_open == nline_arr, "O", "P")
                      ).astype(object)
    arrays = {"o_orderkey": okey, "o_custkey": ck,
              "o_totalprice": np.round(totalprice, 2), "o_orderdate": odate,
              "o_shippriority": np.zeros(n, dtype=np.int32)}
    dicts = {}

    def put_str(col, vals):
        arrays[col], dicts[col] = _dictify(vals)
    put_str("o_orderstatus", status)
    put_str("o_orderpriority", np.asarray(_PRIORITIES, dtype=object)[
        rng.integers(0, 5, size=n)])
    put_str("o_clerk", np.char.add("Clerk#", np.char.zfill(
        rng.integers(1, max(2, int(1000 * sf)) + 1, size=n).astype(str), 9)
    ).astype(object))
    put_str("o_comment", _comment(rng, n, 5))
    return HostTable("orders", n, arrays, dict(TPCH_SCHEMA["orders"]), dicts)


#: lineitem's money columns, which the TPC-H spec types as exact decimals
#: (clause 1.4.1); the generator gives them as float64 cents
LINEITEM_MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def decimal_lineitem(scale_factor: float) -> HostTable:
    """The generated lineitem with its four money columns typed as the
    spec types them, DECIMAL(12,2): int64 unscaled cents, each value
    rounded as `unscale_decimal` rounds it. Other columns are shared with
    the generated table. Serve it through a MemoryConnector whose fallback
    is TpchConnector(scale_factor)."""
    src = _gen_table("lineitem", scale_factor)
    arrays, types = dict(src.arrays), dict(src.types)
    for c in LINEITEM_MONEY:
        arrays[c] = unscale_array(src.arrays[c][:src.num_rows], 2)
        types[c] = DecimalType(12, 2)
    return HostTable("lineitem", src.num_rows, arrays, types, src.dicts)


#: the nested orders table of `nested_orders`
NESTED_ORDERS_SCHEMA: List[Tuple[str, Type]] = [
    ("o_orderkey", BIGINT), ("o_orderpriority", VARCHAR),
    ("o_orderdate", DATE), ("l_partkeys", ArrayType(BIGINT)),
    ("l_shipmodes", ArrayType(VARCHAR)), ("l_qty", MapType(BIGINT, DOUBLE)),
    ("l_returned", ArrayType(BIGINT)),
]


def nested_orders(scale_factor: float) -> HostTable:
    """`orders_nested`: the generated orders with their lineitems folded
    into nested columns, built from the generator's numpy arrays (no
    python objects), in `l_linenumber` order within each order:

    - l_partkeys ARRAY(BIGINT) and l_shipmodes ARRAY(VARCHAR), one element
      per lineitem (the shipmodes keep lineitem's dictionary);
    - l_qty MAP(BIGINT, DOUBLE), linenumber to l_quantity;
    - l_returned ARRAY(BIGINT), the linenumbers whose l_returnflag is 'R':
      empty where there are none, NULL where o_orderkey % 97 = 0.

    The layout is the one from_pylist gives the same python values.
    Serve it through a MemoryConnector (`register`) whose fallback is
    TpchConnector(scale_factor)."""
    orders = _gen_table("orders", scale_factor)
    li = _gen_table("lineitem", scale_factor)
    n, m = orders.num_rows, li.num_rows
    okey = orders.arrays["o_orderkey"][:n]
    perm = np.lexsort((li.arrays["l_linenumber"][:m],
                       li.arrays["l_orderkey"][:m]))
    l_okey = li.arrays["l_orderkey"][:m][perm]
    lineno = li.arrays["l_linenumber"][:m][perm].astype(np.int64)
    starts = np.searchsorted(l_okey, okey, "left")
    lengths = np.searchsorted(l_okey, okey, "right") - starts
    not_null = np.zeros(n, dtype=bool)

    def child(values, words=None):
        return (values, np.zeros(len(values), dtype=bool), words)

    def lineitems(*children):
        return NestedArrays(starts.astype(np.int32),
                            lengths.astype(np.int32), not_null, children)
    r_code = li.dicts["l_returnflag"].words.index("R") \
        if "R" in li.dicts["l_returnflag"].words else -1
    null_ret = okey % 97 == 0
    ret = li.arrays["l_returnflag"][:m][perm] == r_code
    ret &= ~np.isin(l_okey, okey[null_ret])
    r_okey = l_okey[ret]
    r_starts = np.searchsorted(r_okey, okey, "left")
    r_lengths = np.searchsorted(r_okey, okey, "right") - r_starts
    arrays = {
        "o_orderkey": okey,
        "o_orderpriority": orders.arrays["o_orderpriority"][:n],
        "o_orderdate": orders.arrays["o_orderdate"][:n],
        "l_partkeys": lineitems(child(li.arrays["l_partkey"][:m][perm])),
        "l_shipmodes": lineitems(child(
            li.arrays["l_shipmode"][:m][perm],
            li.dicts["l_shipmode"].words)),
        "l_qty": lineitems(child(lineno),
                           child(li.arrays["l_quantity"][:m][perm])),
        "l_returned": NestedArrays(
            r_starts.astype(np.int32), r_lengths.astype(np.int32),
            null_ret, (child(lineno[ret]),)),
    }
    return HostTable("orders_nested", n, arrays,
                     dict(NESTED_ORDERS_SCHEMA),
                     {"o_orderpriority": orders.dicts["o_orderpriority"]})


from presto_tpu_torch.connectors.base import SplitSource


class TpchConnector(SplitSource):
    NAME = "tpch"
    """Connector facade: schema + partitioned table generation.

    Reference surface: ConnectorMetadata + ConnectorSplitManager +
    ConnectorPageSource (presto-spi/.../ConnectorPageSource.java), collapsed
    into the two calls an in-memory generated source actually needs."""

    def __init__(self, scale_factor: float = 0.01):
        self.scale_factor = scale_factor

    def schema(self, table: str) -> List[Tuple[str, Type]]:
        return TPCH_SCHEMA[table]

    def row_count(self, table: str) -> int:
        """Planner statistics (reference role: connector-provided
        TableStatistics feeding the CBO, cost/ package)."""
        c = _counts(self.scale_factor)
        if table in c:
            return c[table]
        if table == "partsupp":
            return c["part"] * _SUPP_PER_PART
        if table == "lineitem":
            return c["orders"] * 4
        raise KeyError(table)

    def table(self, name: str, part: int = 0, num_parts: int = 1
              ) -> HostTable:
        """Full table (cached), or split `part` of `num_parts` as a
        row-range slice of it. Slices share the full table's StringDicts,
        so codes are globally consistent — the property every cross-device
        exchange and dictionary-aligned operator relies on (reference
        analogue: TpchSplitManager handing row ranges of one logical
        table, presto-tpch/.../TpchSplitManager.java)."""
        if name not in TPCH_SCHEMA:
            raise KeyError(f"unknown tpch table {name}")
        full = _gen_table(name, self.scale_factor)  # lru_cached
        if num_parts == 1:
            return full
        lo, hi = _slice_rows(full.num_rows, part, num_parts)
        arrays = {c: a[lo:hi] for c, a in full.arrays.items()}
        return HostTable(name, hi - lo, arrays, full.types, full.dicts)
