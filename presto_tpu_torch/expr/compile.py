"""RowExpression -> torch compiler.

The port's twin of presto_tpu/expr/compile.py: `compile_expr` returns a
closure that evaluates a whole expression tree over a Page with torch
tensor ops, eagerly on the page's device. SQL three-valued logic rides as
an explicit null lane per sub-expression; string operations use the
sorted-dictionary invariant (comparisons on int32 codes; LIKE and string
transforms run on the host over the dictionary, then one device gather).
What a dictionary gives a function and its literal arguments (the output
dictionary, the device remap, predicate or null table) is built once and
kept on the dictionary (`_dict_cached`), where the JAX package builds it
once per trace: a warm query does no host work over words.

As in the JAX package, row-level division by zero yields NULL, and
checked integer/decimal overflow sets the query's error lane
(expr/errors.py).

DECIMAL(p>18) values are Decimal128Column limb lanes; every wide
operation (rescale, add, subtract, multiply, compare, negate, abs and the
casts to double and to int64) is one call of data/int128.int128_op, which
launches the hand-written kernel K10 on the card. Not ported yet (they
raise NotImplementedError): plugin and remote functions.
"""

from __future__ import annotations

import math
import re
from functools import reduce
from typing import Callable, Optional

import numpy as np
import torch

from presto_tpu_torch.data import int128 as I
from presto_tpu_torch.data.column import (
    Column, Decimal128Column, Page, StringDict, torch_dtype,
)
from presto_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, TIMESTAMP, VARCHAR, DecimalType, Type,
)
from presto_tpu_torch.expr.nodes import (
    Call, Form, InputRef, Literal, RowExpression, SpecialForm,
)

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _const_column(value, typ: Type, cap: int, device,
                  dictionary: Optional[StringDict] = None) -> Column:
    dt = torch_dtype(typ)
    if value is None:
        vals = torch.full((cap,), typ.null_sentinel(), dtype=dt,
                          device=device)
        return Column(vals, torch.ones(cap, dtype=torch.bool, device=device),
                      typ, dictionary)
    vals = torch.full((cap,), value, dtype=dt, device=device)
    return Column(vals, torch.zeros(cap, dtype=torch.bool, device=device),
                  typ, dictionary)


def _bool(values: torch.Tensor, nulls: torch.Tensor) -> Column:
    return Column(values.to(torch.bool), nulls, BOOLEAN, None)


def _table(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _take(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl[idx] with indices clamped into range (jnp.take mode="clip")."""
    return tbl[idx.long().clamp(0, max(tbl.shape[0] - 1, 0))]


class DictCacheStats:
    """`computed` grows by one each time `_dict_cached` builds a result
    from a dictionary's words (a warm query adds none)."""

    def __init__(self):
        self.computed = 0


DICT_CACHE = DictCacheStats()
_DERIVED_MAX = 256      # results kept per dictionary, oldest dropped first


def _dict_cached(d: Optional[StringDict], key: tuple, build):
    """`build()`'s result for dictionary `d` under `key` (the kind, the
    function's name, its literal arguments and the device), built once
    and kept in `d.derived`. The cache lives on the dictionary, so it is
    freed with it; a dictionary in a key is held by the entry, so no key
    can meet a recycled id. An INSERT that adds words makes a new union
    dictionary, whose cache starts empty."""
    if d is None:
        DICT_CACHE.computed += 1
        return build()
    cache = d.derived
    if cache is None:
        cache = d.derived = {}
    hit = cache.get(key)
    if hit is not None:
        return hit
    DICT_CACHE.computed += 1
    hit = build()
    if len(cache) >= _DERIVED_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = hit
    return hit


_LITERAL_DICTS: dict = {}
_LITERAL_MAX = 4096


def _literal_dict(value: Optional[str]) -> StringDict:
    """The one-word dictionary of a string literal (empty for NULL), the
    same object for the same value, so the merges with it stay cached."""
    d = _LITERAL_DICTS.get(value)
    if d is None:
        if len(_LITERAL_DICTS) >= _LITERAL_MAX:
            _LITERAL_DICTS.pop(next(iter(_LITERAL_DICTS)))
        d = _LITERAL_DICTS[value] = StringDict(
            [] if value is None else [value])
    return d


def _merge_dicts(a: StringDict, b: StringDict, device):
    """Merge two sorted dictionaries; returns (merged, map_a, map_b) where
    map_x[i] is the merged code of x's word i. Host-side, once per pair
    and device."""
    def build():
        wa = np.asarray(a.words, dtype=object)
        wb = np.asarray(b.words, dtype=object)
        merged = sorted(set(a.words) | set(b.words))
        md = StringDict(merged)
        marr = np.asarray(merged, dtype=object)
        map_a = np.searchsorted(marr.astype(str),
                                wa.astype(str)).astype(np.int32)
        map_b = np.searchsorted(marr.astype(str),
                                wb.astype(str)).astype(np.int32)
        return md, _table(map_a, device), _table(map_b, device)
    return _dict_cached(a, ("merge", b, device), build)


def align_string_columns(x: Column, y: Column):
    """Recode two VARCHAR columns onto one shared sorted dictionary."""
    if x.dictionary is y.dictionary:
        return x, y
    md, ma, mb = _merge_dicts(x.dictionary, y.dictionary, x.values.device)
    xv = (_take(ma, x.values) if len(x.dictionary)
          else torch.zeros_like(x.values))
    yv = (_take(mb, y.values) if len(y.dictionary)
          else torch.zeros_like(y.values))
    return (Column(xv, x.nulls, x.type, md),
            Column(yv, y.nulls, y.type, md))


def _civil_from_days(z: torch.Tensor):
    """days-since-epoch -> (year, month, day), vectorized integer math
    (public-domain civil_from_days algorithm), in int32 like the JAX
    package."""
    z = z.to(torch.int32) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9).to(torch.int32)
    y = y + (m <= 2).to(torch.int32)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side inverse (for date literals)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_LIKE_CACHE: dict = {}


def _like_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    key = (pattern, escape)
    if key not in _LIKE_CACHE:
        out, i = [], 0
        while i < len(pattern):
            ch = pattern[i]
            if escape and ch == escape and i + 1 < len(pattern):
                out.append(re.escape(pattern[i + 1]))
                i += 2
                continue
            if ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(re.escape(ch))
            i += 1
        _LIKE_CACHE[key] = re.compile("^" + "".join(out) + "$", re.DOTALL)
    return _LIKE_CACHE[key]


def _valid_rows(page: Page, *cols) -> torch.Tensor:
    """Rows that take part in checked-arithmetic detection: inside
    page.num_rows and non-NULL in every operand."""
    v = page.row_valid()
    for c in cols:
        v = v & ~c.nulls
    return v


def _is_int(dt: torch.dtype) -> bool:
    return dt in (torch.int8, torch.int16, torch.int32, torch.int64)


def _trunc_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C-style integer division (jax.lax.div) for y != 0; MIN / -1 gives
    MIN, as XLA defines it, instead of trapping."""
    lo = torch.iinfo(x.dtype).min
    wrap = (x == lo) & (y == -1)
    q = torch.div(torch.where(wrap, torch.zeros_like(x), x), y,
                  rounding_mode="trunc")
    return torch.where(wrap, x, q)


def _rescale_decimal(v: torch.Tensor, from_scale: int, to_scale: int,
                     valid=None):
    if to_scale == from_scale:
        return v
    if to_scale > from_scale:
        out = v * (10 ** (to_scale - from_scale))
        if valid is not None:
            from presto_tpu_torch.expr import errors as E
            f = torch.tensor(10 ** (to_scale - from_scale), dtype=v.dtype,
                             device=v.device)
            E.record(E.OVF_DECIMAL, torch.any(
                E.mul_overflows(v, f, out) & valid))
        return out
    f = 10 ** (from_scale - to_scale)  # round half away from zero
    return torch.where(v >= 0, (v + f // 2) // f, -((-v + f // 2) // f))


def _cast(col: Column, to: Type, valid=None) -> Column:
    """`valid`: rows taking part in checked range/overflow detection
    (user-facing CASTs pass it; internal coercions leave it None)."""
    from presto_tpu_torch.expr import errors as E

    frm = col.type
    if frm == to:
        return col
    if _is_wide(col) or (isinstance(to, DecimalType) and to.uses_int128):
        return _cast_wide(col, to, valid)
    tdt = torch_dtype(to)
    if frm.name == "unknown":  # typed NULL literal
        return Column(torch.full(col.values.shape, to.null_sentinel(),
                                 dtype=tdt, device=col.values.device),
                      torch.ones_like(col.nulls), to,
                      StringDict([]) if to.is_string else None)
    v, n = col.values, col.nulls

    def _check_int_range(vals, dt):
        if valid is None or not _is_int(vals.dtype):
            return
        info = torch.iinfo(dt)
        if torch.iinfo(vals.dtype).bits <= info.bits:
            return
        E.record(E.OVF_CAST, torch.any(
            ((vals < info.min) | (vals > info.max)) & valid))

    if isinstance(to, DecimalType):
        if isinstance(frm, DecimalType):
            return Column(
                _rescale_decimal(v, frm.scale, to.scale, valid), n, to)
        if frm.is_integer:
            out = v.to(torch.int64) * (10 ** to.scale)
            if valid is not None and to.scale:
                f = torch.tensor(10 ** to.scale, dtype=torch.int64,
                                 device=v.device)
                E.record(E.OVF_DECIMAL, torch.any(E.mul_overflows(
                    v.to(torch.int64), f, out) & valid))
            return Column(out, n, to)
        if frm.is_floating:
            scaled = v * (10 ** to.scale)
            if valid is not None:
                E.record(E.OVF_DECIMAL, torch.any(
                    (torch.abs(scaled) >= 2.0 ** 63) & valid))
            return Column(torch.round(scaled).to(torch.int64), n, to)
        raise NotImplementedError(f"cast {frm} -> {to}")
    if isinstance(frm, DecimalType):
        if to.is_floating:
            return Column((v.to(torch.float64) / (10 ** frm.scale))
                          .to(tdt), n, to)
        if to.is_integer:
            unscaled = _rescale_decimal(v, frm.scale, 0)
            _check_int_range(unscaled, tdt)
            return Column(unscaled.to(tdt), n, to)
        raise NotImplementedError(f"cast {frm} -> {to}")
    if to.is_floating or to.is_integer:
        if frm.is_floating and to.is_integer:
            r = torch.round(v)
            if valid is not None:
                # check the ROUNDED value against 2^(bits-1), which float64
                # holds exactly
                hi = 2.0 ** (torch.iinfo(tdt).bits - 1)
                E.record(E.OVF_CAST, torch.any(((r >= hi) | (r < -hi)) & valid))
            return Column(r.to(tdt), n, to)
        if frm.name == "boolean":
            return Column(v.to(tdt), n, to)
        if frm.is_integer or frm.is_floating or frm.is_temporal:
            if to.is_integer:
                _check_int_range(v, tdt)
            return Column(v.to(tdt), n, to)
    if to == DATE and frm.is_string:
        mapped = _dict_cached(col.dictionary, ("cast_date", v.device),
                              lambda: _table(np.array(
                                  [_parse_date_host(w)
                                   for w in col.dictionary.words],
                                  dtype=np.int32), v.device))
        return Column(_take(mapped, v), n, to)
    if to == TIMESTAMP and frm == DATE:
        return Column(v.to(torch.int64) * 86_400_000_000, n, to)
    if to == BOOLEAN and (frm.is_integer or frm.is_floating):
        return Column(v != 0, n, to)
    if to.is_string and frm.is_string:
        return Column(v, n, to, col.dictionary)
    raise NotImplementedError(f"cast {frm} -> {to}")


def _wide_operand(col):
    """(int128_op operand, decimal scale) of a wide column, a narrow
    decimal or an integer column."""
    if _is_wide(col):
        return col.value_lanes, col.type.scale
    scale = col.type.scale if isinstance(col.type, DecimalType) else 0
    return col.values.to(torch.int64), scale


def _wide_lanes(col, scale_to: int, valid=None):
    """Column -> 128-bit limb lanes at scale_to (presto_tpu/expr/
    compile.py:454; reference: UnscaledDecimal128Arithmetic.rescale).
    Upscaling records an overflow on the valid rows; downscaling rounds
    HALF_UP."""
    from presto_tpu_torch.expr import errors as E
    x, frm = _wide_operand(col)
    if _is_wide(col) and scale_to == frm:
        return x
    lanes, err = I.int128_op("rescale", x, x_shift=scale_to - frm,
                             valid=valid)
    E.record_mask(err)
    return lanes


def _cast_wide(col, to: Type, valid=None):
    """Casts touching the 128-bit limb representation
    (presto_tpu/expr/compile.py:250)."""
    from presto_tpu_torch.expr import errors as E

    frm = col.type
    dev = col.nulls.device
    if _is_wide(col):
        if to.is_floating:
            img, _err = I.int128_op("to_double", col.value_lanes,
                                    scale=frm.scale)
            return Column(img.to(torch_dtype(to)), col.nulls, to)
        if isinstance(to, DecimalType) and to.uses_int128:
            return Decimal128Column(*_wide_lanes(col, to.scale, valid),
                                    col.nulls, to)
        if to.is_integer or isinstance(to, DecimalType):
            # downscale to scale 0 (integers) or to.scale; the value must
            # then fit the narrow representation, range-checked
            target = to.scale if isinstance(to, DecimalType) else 0
            info = torch.iinfo(torch_dtype(to))
            v, err = I.int128_op("to_int64", col.value_lanes,
                                 x_shift=target - frm.scale, valid=valid,
                                 lo=info.min, hi=info.max)
            E.record_mask(err)
            return Column(v.to(torch_dtype(to)), col.nulls, to)
        raise NotImplementedError(f"cast {frm} -> {to}")
    if frm.name == "unknown":
        z = torch.zeros(col.capacity, dtype=torch.int64, device=dev)
        return Decimal128Column(z, z, z, z, torch.ones_like(col.nulls), to)
    if frm.is_floating:
        # double -> DECIMAL(38): floats carry 53 significant bits, so a
        # float-space limb decomposition is exact wherever the input was
        x = torch.round(col.values.to(torch.float64) * (10 ** to.scale))
        l3 = torch.floor(x / 2.0 ** 96)
        x = x - l3 * 2.0 ** 96
        l2 = torch.floor(x / 2.0 ** 64)
        x = x - l2 * 2.0 ** 64
        l1 = torch.floor(x / 2.0 ** 32)
        l0 = x - l1 * 2.0 ** 32
        return Decimal128Column(*[a.to(torch.int64) for a in (l3, l2, l1, l0)],
                                col.nulls, to)
    if frm.is_integer or isinstance(frm, DecimalType):
        return Decimal128Column(*_wide_lanes(col, to.scale, valid),
                                col.nulls, to)
    raise NotImplementedError(f"cast {frm} -> {to}")


def _parse_date_host(s: str) -> int:
    y, m, d = s.strip().split("-")
    return days_from_civil(int(y), int(m), int(d))


def _common_numeric(x: Column, y: Column):
    """Promote two numeric/temporal columns to a common dtype for
    comparison; decimals align by scale (exact int64 path)."""
    if isinstance(x.type, DecimalType) or isinstance(y.type, DecimalType):
        if isinstance(x.type, DecimalType) and isinstance(y.type, DecimalType):
            s = max(x.type.scale, y.type.scale)
            t = DecimalType(18, s)
            return _cast(x, t), _cast(y, t)
        t = DOUBLE if (x.type.is_floating or y.type.is_floating) else None
        if t is None:
            s = (x.type if isinstance(x.type, DecimalType) else y.type).scale
            t = DecimalType(18, s)
        return _cast(x, t), _cast(y, t)
    dt = torch.promote_types(x.values.dtype, y.values.dtype)
    return (Column(x.values.to(dt), x.nulls, x.type),
            Column(y.values.to(dt), y.nulls, y.type))


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

Compiled = Callable[[Page], Column]


def compile_expr(expr: RowExpression) -> Compiled:
    """Compile a RowExpression into fn(Page) -> Column."""

    def ev(e: RowExpression, page: Page) -> Column:
        cap = page.capacity
        if isinstance(e, InputRef):
            return page.columns[e.field]
        if isinstance(e, Literal):
            return _literal_column(e, cap, page.device)
        if isinstance(e, SpecialForm):
            return _special(e, page, ev)
        if isinstance(e, Call):
            return _call(e, page, ev)
        raise NotImplementedError(f"expression {e!r}")

    return lambda page: ev(expr, page)


def _literal_column(e: Literal, cap: int, device) -> Column:
    t = e.type
    if t.is_string:
        return _const_column(None if e.value is None else 0, t, cap, device,
                             _literal_dict(e.value))
    if isinstance(t, DecimalType) and t.uses_int128:
        # decimal literals are stored UNSCALED in the Literal
        if e.value is None:
            z = torch.zeros(cap, dtype=torch.int64, device=device)
            return Decimal128Column(z, z, z, z, torch.ones(
                cap, dtype=torch.bool, device=device), t)
        return Decimal128Column(
            *I.from_python_int(int(e.value), (cap,), device),
            torch.zeros(cap, dtype=torch.bool, device=device), t)
    return _const_column(e.value, t, cap, device)


def _truthy(c: Column) -> torch.Tensor:
    return c.values.to(torch.bool)


def _special(e: SpecialForm, page: Page, ev) -> Column:
    f = e.form
    if f == Form.AND:
        cols = [ev(a, page) for a in e.args]
        val = reduce(torch.logical_and,
                     [torch.where(c.nulls, True, _truthy(c)) for c in cols])
        any_false = reduce(torch.logical_or,
                           [~c.nulls & ~_truthy(c) for c in cols])
        any_null = reduce(torch.logical_or, [c.nulls for c in cols])
        return _bool(val, ~any_false & any_null)
    if f == Form.OR:
        cols = [ev(a, page) for a in e.args]
        val = reduce(torch.logical_or,
                     [torch.where(c.nulls, False, _truthy(c)) for c in cols])
        any_true = reduce(torch.logical_or,
                          [~c.nulls & _truthy(c) for c in cols])
        any_null = reduce(torch.logical_or, [c.nulls for c in cols])
        return _bool(val, ~any_true & any_null)
    if f == Form.IS_NULL:
        c = ev(e.args[0], page)
        return _bool(c.nulls, torch.zeros_like(c.nulls))
    if f == Form.IF:
        c = ev(e.args[0], page)
        t = ev(e.args[1], page)
        el = ev(e.args[2], page)
        take_then = ~c.nulls & _truthy(c)
        if _is_wide_type(e.type):
            return _choose_wide(e.type, page, [(t, take_then),
                                               (el, ~take_then)])
        if _is_wide(t) or _is_wide(el):
            # a DECIMAL(38) branch of a narrower result (DOUBLE): cast,
            # range-checked on the rows that take the branch
            t = _cast(t, e.type, _valid_rows(page, t) & take_then)
            el = _cast(el, e.type, _valid_rows(page, el) & ~take_then)
        if t.type.is_string and el.type.is_string:
            t, el = align_string_columns(t, el)
        elif t.type != el.type:
            t, el = _common_numeric(t, el)
        return Column(torch.where(take_then, t.values, el.values),
                      torch.where(take_then, t.nulls, el.nulls),
                      t.type, t.dictionary)
    if f == Form.COALESCE:
        cols = [ev(a, page) for a in e.args]
        if _is_wide_type(e.type):
            picks, left = [], None
            for c in cols:
                # an argument is picked where every one before it is NULL
                picks.append((c, ~c.nulls if left is None
                              else left & ~c.nulls))
                left = c.nulls if left is None else left & c.nulls
            return _choose_wide(e.type, page, picks)
        if any(_is_wide(c) for c in cols):
            cols = [_cast(c, e.type, _valid_rows(page, c)) for c in cols]
        out = cols[0]
        for c in cols[1:]:
            if out.type.is_string:
                out, c = align_string_columns(out, c)
            out = Column(torch.where(out.nulls, c.values.to(out.values.dtype),
                                     out.values),
                         out.nulls & c.nulls, out.type, out.dictionary)
        return out
    if f == Form.BETWEEN:
        v, lo, hi = (ev(a, page) for a in e.args)
        return _and2(_compare("ge", v, lo), _compare("le", v, hi))
    if f == Form.IN:
        v = ev(e.args[0], page)
        eqs = [_compare("eq", v, ev(a, page)) for a in e.args[1:]]
        val = reduce(torch.logical_or, [~c.nulls & c.values for c in eqs])
        any_null = reduce(torch.logical_or, [c.nulls for c in eqs])
        return _bool(val, ~val & (any_null | v.nulls))
    raise NotImplementedError(f"special form {f}")


def _is_wide_type(t: Type) -> bool:
    return isinstance(t, DecimalType) and t.uses_int128


def _choose_wide(rt: DecimalType, page: Page, picks) -> Decimal128Column:
    """IF, CASE and COALESCE over DECIMAL(p>18): `picks` is a list of
    (column, rows where it is chosen), the rows disjoint. Each column is
    widened to the result's type (a narrow decimal or integer through
    `_cast_wide`, K10 on the card; overflow checked only on the rows that
    choose it, as a lazy CASE would), then chosen limb lane by limb lane;
    NULL rows get zero lanes, as `_arith_wide` leaves them."""
    lanes = [None] * 4
    nulls = None
    for c, take in picks:
        w = _cast(c, rt, _valid_rows(page, c) & take)
        for i, lane in enumerate(w.value_lanes):
            lanes[i] = lane if lanes[i] is None else torch.where(
                take, lane, lanes[i])
        nulls = w.nulls if nulls is None else torch.where(take, w.nulls,
                                                          nulls)
    # a row that chooses no column (every COALESCE argument NULL) keeps
    # the first column's NULL
    return Decimal128Column(*[torch.where(nulls, 0, lane) for lane in lanes],
                            nulls, rt)


def _and2(a: Column, b: Column) -> Column:
    val = (torch.where(a.nulls, True, _truthy(a))
           & torch.where(b.nulls, True, _truthy(b)))
    any_false = (~a.nulls & ~_truthy(a)) | (~b.nulls & ~_truthy(b))
    return _bool(val, ~any_false & (a.nulls | b.nulls))


_CMP = {
    "eq": lambda x, y: x == y, "ne": lambda x, y: x != y,
    "lt": lambda x, y: x < y, "le": lambda x, y: x <= y,
    "gt": lambda x, y: x > y, "ge": lambda x, y: x >= y,
}


def _is_wide(col) -> bool:
    return isinstance(col, Decimal128Column)


def _compare(op: str, x: Column, y: Column) -> Column:
    if _is_wide(x) or _is_wide(y):
        # exact 128-bit comparison at the common scale
        xo, xs = _wide_operand(x)
        yo, ys = _wide_operand(y)
        s = max(xs, ys)
        sign, _err = I.int128_op("compare", xo, yo, x_shift=s - xs,
                                 y_shift=s - ys)
        v = {"eq": sign == 0, "ne": sign != 0, "lt": sign < 0,
             "le": sign <= 0, "gt": sign > 0, "ge": sign >= 0}[op]
        return _bool(v, x.nulls | y.nulls)
    if x.type.is_string and y.type.is_string:
        x, y = align_string_columns(x, y)
        return _bool(_CMP[op](x.values, y.values), x.nulls | y.nulls)
    # varchar <-> date coercion (Presto: cast('1998-09-02' as date) implied)
    if x.type.is_temporal and y.type.is_string:
        y = _cast(y, x.type if x.type.name == "date" else DATE)
    elif y.type.is_temporal and x.type.is_string:
        x = _cast(x, y.type if y.type.name == "date" else DATE)
    x, y = _common_numeric(x, y)
    return _bool(_CMP[op](x.values, y.values), x.nulls | y.nulls)


def _arith(op: str, e: Call, x: Column, y: Column, page: Page) -> Column:
    """Checked arithmetic (reference: BigintOperators.java:73 — the
    Math.addExact family): integer/decimal overflow on valid rows sets the
    query's error lane."""
    from presto_tpu_torch.expr import errors as E

    rt = e.type
    nulls = x.nulls | y.nulls
    # rows that take part in overflow detection; floating results are not
    # checked, so eager evaluation skips building their mask
    valid = None if rt.is_floating else _valid_rows(page, x, y)
    wide_in = _is_wide(x) or _is_wide(y)
    if isinstance(rt, DecimalType) and (rt.uses_int128 or wide_in):
        return _arith_wide(op, rt, x, y, nulls, valid)
    if wide_in:
        # a non-decimal result (decimal division is typed DOUBLE): wide
        # operands go through their float image
        x = _cast_wide(x, DOUBLE) if _is_wide(x) else x
        y = _cast_wide(y, DOUBLE) if _is_wide(y) else y
    if isinstance(rt, DecimalType):
        xs = x.type.scale if isinstance(x.type, DecimalType) else 0
        ys = y.type.scale if isinstance(y.type, DecimalType) else 0
        xv = x.values.to(torch.int64)
        yv = y.values.to(torch.int64)
        if op == "multiply":
            v = xv * yv
            E.record(E.OVF_DECIMAL,
                     torch.any(E.mul_overflows(xv, yv, v) & valid))
            return Column(
                _rescale_decimal(v, xs + ys, rt.scale, valid), nulls, rt)
        xv = _rescale_decimal(xv, xs, rt.scale, valid)
        yv = _rescale_decimal(yv, ys, rt.scale, valid)
        if op == "add":
            v = xv + yv
            E.record(E.OVF_DECIMAL,
                     torch.any(E.add_overflows(xv, yv, v) & valid))
            return Column(v, nulls, rt)
        if op == "subtract":
            v = xv - yv
            E.record(E.OVF_DECIMAL,
                     torch.any(E.sub_overflows(xv, yv, v) & valid))
            return Column(v, nulls, rt)
        raise NotImplementedError(f"decimal {op}")
    x = _cast(x, rt, valid)
    y = _cast(y, rt, valid)
    xv, yv = x.values, y.values
    checked = rt.is_integer
    if op == "add":
        v = xv + yv
        if checked:
            E.record(E.OVF_ADD, torch.any(E.add_overflows(xv, yv, v) & valid))
    elif op == "subtract":
        v = xv - yv
        if checked:
            E.record(E.OVF_SUB, torch.any(E.sub_overflows(xv, yv, v) & valid))
    elif op == "multiply":
        v = xv * yv
        if checked:
            E.record(E.OVF_MUL, torch.any(E.mul_overflows(xv, yv, v) & valid))
    elif op == "divide":
        zero = yv == 0
        if rt.is_integer:
            v = _trunc_div(xv, torch.where(zero, torch.ones_like(yv), yv))
            nulls = nulls | zero
            # the single non-representable quotient: MIN / -1
            lo = torch.iinfo(v.dtype).min
            E.record(E.OVF_DIV, torch.any((xv == lo) & (yv == -1) & valid))
        else:
            v = xv / torch.where(zero, torch.ones_like(yv), yv)
            nulls = nulls | zero
    elif op == "modulus":
        zero = yv == 0
        safe = torch.where(zero, torch.ones_like(yv), yv)
        if rt.is_integer:
            # C remainder (sign of the dividend), as jax.lax.rem
            v = xv - _trunc_div(xv, safe) * safe
        else:
            v = torch.fmod(xv, safe)
        nulls = nulls | zero
    else:
        raise NotImplementedError(op)
    return Column(v, nulls, rt)


def _arith_wide(op: str, rt, x, y, nulls, valid) -> Decimal128Column:
    """DECIMAL arithmetic on the 128-bit limb lanes
    (presto_tpu/expr/compile.py:581; reference:
    UnscaledDecimal128Arithmetic.java add/subtract/multiply). Presto's
    decimal type rules make multiply's result scale exactly xs + ys and
    add/subtract's the larger input scale, so the only rescales are
    upscales. Overflow past 2^127 or past 10^38-1 records DECIMAL
    overflow; NULL rows get zero lanes."""
    from presto_tpu_torch.expr import errors as E

    if not isinstance(rt, DecimalType):
        raise NotImplementedError(f"wide decimal {op} -> {rt}")
    xo, xs = _wide_operand(x)
    yo, ys = _wide_operand(y)
    if op == "multiply":
        if rt.scale != xs + ys:
            raise NotImplementedError(
                f"decimal multiply rescale {xs}+{ys}->{rt.scale}")
        lanes, err = I.int128_op("multiply", xo, yo, valid=valid,
                                 zero=nulls)
    elif op in ("add", "subtract"):
        lanes, err = I.int128_op(op, xo, yo, x_shift=rt.scale - xs,
                                 y_shift=rt.scale - ys, valid=valid,
                                 zero=nulls)
    else:
        raise NotImplementedError(f"DECIMAL(38) {op} (128-bit division)")
    E.record_mask(err)
    return Decimal128Column(*lanes, nulls, rt)


def _dict_transform(col: Column, key: tuple, fn) -> Column:
    """Apply a host string->string fn over the dictionary, producing a new
    sorted dictionary + device code remap (one gather). `key` names fn
    and its literal arguments: the cache key (`_dict_cached`)."""
    dev = col.values.device

    def build():
        words = [fn(w) for w in col.dictionary.words]
        if words:
            newd, codes = StringDict.build(words)
            return newd, _table(codes, dev)
        return StringDict([]), torch.zeros(1, dtype=torch.int32, device=dev)
    newd, remap = _dict_cached(col.dictionary, ("transform",) + key + (dev,),
                               build)
    return Column(_take(remap, col.values), col.nulls, col.type, newd)


def _dict_predicate(col: Column, key: tuple, fn) -> Column:
    """Host predicate over dictionary words -> device boolean via gather
    (`key` as for _dict_transform)."""
    if not col.dictionary.words:
        return _bool(torch.zeros_like(col.nulls), col.nulls)
    dev = col.values.device
    tbl = _dict_cached(col.dictionary, ("predicate",) + key + (dev,),
                       lambda: _table(np.array([bool(fn(w)) for w in
                                                col.dictionary.words]), dev))
    return _bool(_take(tbl, col.values), col.nulls)


def _as_f64(col: Column) -> torch.Tensor:
    """Column values as float64 LOGICAL values (decimals descale)."""
    v = col.values.to(torch.float64)
    if col.type.is_decimal:
        v = v / (10 ** col.type.scale)
    return v


def _dict_transform_nullable(col: Column, key: tuple, fn) -> Column:
    """Like _dict_transform, but fn may return None: those codes become
    NULL rows."""
    dev = col.values.device

    def build():
        words = col.dictionary.words if col.dictionary else ()
        out = [fn(w) for w in words]
        if not out:
            return StringDict([]), None, None
        null_tbl = np.array([o is None for o in out], dtype=bool)
        newd, codes = StringDict.build(["" if o is None else o for o in out])
        return newd, _table(codes, dev), _table(null_tbl, dev)
    newd, remap, null_tbl = _dict_cached(
        col.dictionary, ("nullable",) + key + (dev,), build)
    if remap is None:
        return Column(torch.zeros_like(col.values), col.nulls, col.type,
                      newd)
    return Column(_take(remap, col.values),
                  col.nulls | _take(null_tbl, col.values), col.type, newd)


def _dict_int(col: Column, key: tuple, fn) -> Column:
    """Host string->int fn over the dictionary -> device BIGINT gather."""
    dev = col.values.device

    def build():
        words = col.dictionary.words if col.dictionary else ()
        return _table(np.array([int(fn(w)) for w in words], np.int64)
                      if words else np.zeros(1, np.int64), dev)
    tbl = _dict_cached(col.dictionary, ("int",) + key + (dev,), build)
    return Column(_take(tbl, col.values), col.nulls, BIGINT)


def _days_from_civil_dev(y, m, d):
    """Vectorized (year, month, day) -> days-since-epoch (inverse of
    _civil_from_days)."""
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _pad_word(w: str, size: int, pad: str, left: bool) -> str:
    """Presto lpad/rpad: truncate to size, else fill with `pad`
    repeated."""
    if size <= len(w):
        return w[:size]
    fill = (pad * size)[:size - len(w)] if pad else ""
    return fill + w if left else w + fill


def _regex_cache(pattern: str):
    key = ("re", pattern)
    rx = _LIKE_CACHE.get(key)
    if rx is None:
        rx = _LIKE_CACHE[key] = re.compile(pattern)
    return rx


def _json_scalar_path(doc: str, path: str):
    """Minimal $.a.b[0] JSONPath subset for json_extract_scalar."""
    import json as _json
    try:
        v = _json.loads(doc)
    except ValueError:          # bad JSON -> NULL (Presto)
        return None
    if not path.startswith("$"):
        return None
    for tok in re.findall(r"\.([^.\[\]]+)|\[(\d+)\]", path[1:]):
        key, idx = tok
        try:
            v = v[int(idx)] if idx else v[key]
        except (KeyError, IndexError, TypeError):   # missing path -> NULL
            return None
    if v is None or isinstance(v, (dict, list)):
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _call(e: Call, page: Page, ev) -> Column:
    name = e.name
    dev = page.device
    if name in ("add", "subtract", "multiply", "divide", "modulus"):
        return _arith(name, e, ev(e.args[0], page), ev(e.args[1], page),
                      page)
    if name in _CMP:
        return _compare(name, ev(e.args[0], page), ev(e.args[1], page))
    if name == "not":
        c = ev(e.args[0], page)
        return _bool(~_truthy(c), c.nulls)
    if name == "negate":
        c = ev(e.args[0], page)
        if _is_wide(c):
            lanes, _err = I.int128_op("negate", c.value_lanes)
            return Decimal128Column(*lanes, c.nulls, c.type)
        if c.type.is_integer:   # -MIN is not representable
            from presto_tpu_torch.expr import errors as E
            lo = torch.iinfo(c.values.dtype).min
            E.record(E.OVF_NEG, torch.any(
                (c.values == lo) & _valid_rows(page, c)))
        return Column(-c.values, c.nulls, c.type)
    if name == "abs":
        c = ev(e.args[0], page)
        if _is_wide(c):
            lanes, _err = I.int128_op("abs", c.value_lanes)
            return Decimal128Column(*lanes, c.nulls, c.type)
        if c.type.is_integer:   # abs(MIN) is not representable
            from presto_tpu_torch.expr import errors as E
            lo = torch.iinfo(c.values.dtype).min
            E.record(E.OVF_ABS, torch.any(
                (c.values == lo) & _valid_rows(page, c)))
        return Column(torch.abs(c.values), c.nulls, c.type)
    if name == "cast":
        c = ev(e.args[0], page)
        return _cast(c, e.type, _valid_rows(page, c))
    if name in ("extract_year", "extract_month", "extract_day", "year",
                "month", "day"):
        c = ev(e.args[0], page)
        days = c.values if c.type == DATE else c.values // 86_400_000_000
        y, m, d = _civil_from_days(days)
        part = {"year": y, "month": m, "day": d}[name.replace("extract_", "")]
        return Column(part.to(torch.int64), c.nulls, BIGINT)
    if name == "like":
        c = ev(e.args[0], page)
        pat = e.args[1]
        if not isinstance(pat, Literal):
            raise NotImplementedError("LIKE pattern must be a literal")
        esc = e.args[2].value if len(e.args) > 2 else None
        rx = _like_regex(pat.value, esc)
        return _dict_predicate(c, ("like", pat.value, esc),
                               lambda w: rx.match(w) is not None)
    if name == "substr":
        c = ev(e.args[0], page)
        start = e.args[1].value  # 1-based, literal
        length = e.args[2].value if len(e.args) > 2 else None
        return _dict_transform(
            c, ("substr", start, length),
            lambda w: w[start - 1:] if length is None
            else w[start - 1:start - 1 + length])
    if name in ("lower", "upper", "trim", "ltrim", "rtrim"):
        c = ev(e.args[0], page)
        fn = {"lower": str.lower, "upper": str.upper, "trim": str.strip,
              "ltrim": str.lstrip, "rtrim": str.rstrip}[name]
        return _dict_transform(c, (name,), fn)
    if name == "length":
        c = ev(e.args[0], page)
        return _dict_int(c, (name,), len)
    if name == "concat":
        a, b = ev(e.args[0], page), ev(e.args[1], page)
        if isinstance(e.args[1], Literal):
            suffix = e.args[1].value
            return _dict_transform(a, ("concat_suffix", suffix),
                                   lambda w: w + suffix)
        if isinstance(e.args[0], Literal):
            prefix = e.args[0].value
            return _dict_transform(b, ("concat_prefix", prefix),
                                   lambda w: prefix + w)
        # column || column: the result dictionary is the sorted cross
        # product of both dictionaries with a host-built (ca, cb) ->
        # combined-code table; the per-row work is one gather
        aw = a.dictionary.words if a.dictionary else ("",)
        bw = b.dictionary.words if b.dictionary else ("",)
        if len(aw) * len(bw) > 1_000_000:
            raise NotImplementedError(
                f"concat dictionary product too large "
                f"({len(aw)}x{len(bw)})")

        def build():
            pairs = [x + y for x in aw for y in bw]
            union = sorted(set(pairs))
            uarr = np.asarray(union, dtype=object).astype(str)
            lut = np.searchsorted(
                uarr, np.asarray(pairs, dtype=object).astype(str)
            ).astype(np.int32)
            return StringDict(union), _table(lut, dev)
        union, lut = _dict_cached(a.dictionary,
                                  ("concat", b.dictionary, dev), build)
        ca = a.values.long().clamp(0, len(aw) - 1)
        cb = b.values.long().clamp(0, len(bw) - 1)
        v = _take(lut, ca * len(bw) + cb)
        return Column(v, a.nulls | b.nulls, VARCHAR, union)
    if name in ("sqrt", "ln", "log10", "exp", "floor", "ceil", "round"):
        c = ev(e.args[0], page)
        if name == "round" and len(e.args) > 1:
            nd = e.args[1].value
            f = 10.0 ** nd
            v = torch.round(_as_f64(c) * f) / f
            return Column(v, c.nulls, DOUBLE)
        fn = {"sqrt": torch.sqrt, "ln": torch.log, "log10": torch.log10,
              "exp": torch.exp, "floor": torch.floor, "ceil": torch.ceil,
              "round": torch.round}[name]
        v = fn(_as_f64(c))
        if name in ("floor", "ceil", "round") and c.type.is_integer:
            return Column(c.values, c.nulls, c.type)
        return Column(v, c.nulls, DOUBLE)
    if name == "date_add_days":
        c = ev(e.args[0], page)
        k = ev(e.args[1], page)
        return Column(c.values + k.values.to(c.values.dtype),
                      c.nulls | k.nulls, c.type)

    # ---- string functions over the dictionary ----------------------------
    def _litstr(i: int, what: str) -> str:
        a = e.args[i]
        if not isinstance(a, Literal):
            raise NotImplementedError(f"{name} {what} must be a literal")
        return a.value

    def _litint(i: int, what: str) -> int:
        a = e.args[i]
        if not isinstance(a, Literal):
            raise NotImplementedError(f"{name} {what} must be a literal")
        return int(a.value)

    if name == "replace":
        c = ev(e.args[0], page)
        find = _litstr(1, "search")
        repl = _litstr(2, "replacement") if len(e.args) > 2 else ""
        return _dict_transform(c, (name, find, repl),
                               lambda w: w.replace(find, repl))
    if name == "reverse":
        c = ev(e.args[0], page)
        return _dict_transform(c, (name,), lambda w: w[::-1])
    if name in ("lpad", "rpad"):
        c = ev(e.args[0], page)
        size = _litint(1, "size")
        pad = _litstr(2, "padstring") if len(e.args) > 2 else " "
        left = name == "lpad"
        return _dict_transform(c, (name, size, pad),
                               lambda w: _pad_word(w, size, pad, left))
    if name == "split_part":
        c = ev(e.args[0], page)
        delim = _litstr(1, "delimiter")
        index = _litint(2, "index")
        if index <= 0:
            raise NotImplementedError("split_part index must be > 0")

        def part(w):
            ps = w.split(delim) if delim else [w]
            return ps[index - 1] if index <= len(ps) else None
        return _dict_transform_nullable(c, (name, delim, index), part)
    if name == "strpos":
        c = ev(e.args[0], page)
        sub = _litstr(1, "substring")
        return _dict_int(c, (name, sub), lambda w: w.find(sub) + 1)
    if name == "starts_with":
        c = ev(e.args[0], page)
        pre = _litstr(1, "prefix")
        return _dict_predicate(c, (name, pre), lambda w: w.startswith(pre))
    if name == "regexp_like":
        c = ev(e.args[0], page)
        pattern = _litstr(1, "pattern")
        rx = _regex_cache(pattern)
        return _dict_predicate(c, (name, pattern),
                               lambda w: rx.search(w) is not None)
    if name == "regexp_extract":
        c = ev(e.args[0], page)
        pattern = _litstr(1, "pattern")
        rx = _regex_cache(pattern)
        group = _litint(2, "group") if len(e.args) > 2 else 0

        def extract(w):
            m = rx.search(w)
            return m.group(group) if m else None
        return _dict_transform_nullable(c, (name, pattern, group), extract)
    if name == "regexp_replace":
        c = ev(e.args[0], page)
        pattern = _litstr(1, "pattern")
        rx = _regex_cache(pattern)
        repl = _litstr(2, "replacement") if len(e.args) > 2 else ""
        # Presto capture refs are $1; python's are \1
        py_repl = re.sub(r"\$(\d+)", r"\\\1", repl)
        return _dict_transform(c, (name, pattern, repl),
                               lambda w: rx.sub(py_repl, w))
    if name == "json_extract_scalar":
        c = ev(e.args[0], page)
        path = _litstr(1, "path")
        return _dict_transform_nullable(
            c, (name, path), lambda w: _json_scalar_path(w, path))
    if name.startswith("url_extract_"):
        c = ev(e.args[0], page)
        part = name[len("url_extract_"):]
        from urllib.parse import urlparse

        def url_part(w):
            try:
                u = urlparse(w)
                v = {"host": u.hostname, "path": u.path,
                     "protocol": u.scheme, "query": u.query,
                     "fragment": u.fragment}.get(part)
            except ValueError:          # bad URL -> NULL
                return None
            return None if v in (None, "") and part != "path" else str(v)
        if part == "port":
            # NULL when absent/malformed (Presto UrlFunctions.java)
            if not (c.dictionary.words if c.dictionary else ()):
                return Column(torch.zeros_like(c.values, dtype=torch.int64),
                              torch.ones_like(c.nulls), BIGINT)

            def build():
                ports = []
                for w in c.dictionary.words:
                    try:
                        ports.append(urlparse(w).port)
                    except ValueError:      # bad port -> NULL
                        ports.append(None)
                return (_table(np.array([0 if p is None else p
                                         for p in ports], np.int64), dev),
                        _table(np.array([p is None for p in ports], bool),
                               dev))
            val_tbl, null_tbl = _dict_cached(c.dictionary, ("int", name, dev),
                                             build)
            return Column(_take(val_tbl, c.values),
                          c.nulls | _take(null_tbl, c.values), BIGINT)
        return _dict_transform_nullable(c, (name,), url_part)

    # ---- date functions (operator/scalar/DateTimeFunctions.java) ---------
    if name in ("date_trunc", "day_of_week", "day_of_year", "quarter",
                "week", "last_day_of_month"):
        di = 1 if name == "date_trunc" else 0
        c = ev(e.args[di], page)
        days = c.values if c.type == DATE \
            else c.values // 86_400_000_000
        y, m, d = _civil_from_days(days)
        if name == "date_trunc":
            unit = _litstr(0, "unit").lower()
            if unit == "day":
                out = days
            elif unit == "week":      # ISO week starts Monday
                out = days - (days + 3) % 7
            elif unit == "month":
                out = _days_from_civil_dev(y, m, torch.ones_like(d))
            elif unit == "quarter":
                qm = ((m - 1) // 3) * 3 + 1
                out = _days_from_civil_dev(y, qm, torch.ones_like(d))
            elif unit == "year":
                out = _days_from_civil_dev(y, torch.ones_like(m), torch.ones_like(d))
            else:
                raise NotImplementedError(f"date_trunc unit {unit!r}")
            if c.type != DATE:      # TIMESTAMP: back to microseconds
                out = out.to(torch.int64) * 86_400_000_000
            return Column(out.to(c.values.dtype), c.nulls, c.type)
        if name == "day_of_week":
            return Column(((days + 3) % 7 + 1).to(torch.int64), c.nulls,
                          BIGINT)
        if name == "day_of_year":
            jan1 = _days_from_civil_dev(y, torch.ones_like(m), torch.ones_like(d))
            return Column((days - jan1 + 1).to(torch.int64), c.nulls,
                          BIGINT)
        if name == "quarter":
            return Column(((m + 2) // 3).to(torch.int64), c.nulls, BIGINT)
        if name == "week":
            # ISO 8601 week of year: the week holding this date's Thursday,
            # counted within that Thursday's calendar year
            thu = days - (days + 3) % 7 + 3
            ty, _tm, _td = _civil_from_days(thu)
            jan1 = _days_from_civil_dev(ty, torch.ones_like(m), torch.ones_like(d))
            return Column(((thu - jan1) // 7 + 1).to(torch.int64), c.nulls,
                          BIGINT)
        # last_day_of_month: first day of next month - 1
        ny = y + (m == 12).to(y.dtype)
        nm = m % 12 + 1
        out = _days_from_civil_dev(ny, nm, torch.ones_like(d)) - 1
        return Column(out.to(c.values.dtype), c.nulls, DATE)
    if name == "date_diff":
        unit = _litstr(0, "unit").lower()
        a = ev(e.args[1], page)
        b = ev(e.args[2], page)
        da = a.values if a.type == DATE else a.values // 86_400_000_000
        db = b.values if b.type == DATE else b.values // 86_400_000_000
        nulls = a.nulls | b.nulls
        if unit == "day":
            return Column((db - da).to(torch.int64), nulls, BIGINT)
        if unit == "week":
            return Column(((db - da) // 7).to(torch.int64), nulls, BIGINT)
        if unit in ("month", "quarter", "year"):
            ya, ma, dda = _civil_from_days(da)
            yb, mb, ddb = _civil_from_days(db)
            months = (yb - ya) * 12 + (mb - ma)
            # complete months only, with end-of-month clamping (Joda
            # monthsBetween)
            ones = torch.ones_like(ma)

            def eom_day(yy, mm):
                ny = yy + (mm == 12).to(yy.dtype)
                nm = mm % 12 + 1
                return (_days_from_civil_dev(ny, nm, ones)
                        - _days_from_civil_dev(yy, mm, ones))
            short_fwd = (ddb < dda) & (ddb < eom_day(yb, mb))
            short_back = (ddb > dda) & (dda < eom_day(ya, ma))
            months = (months - ((db >= da) & short_fwd).to(months.dtype)
                      + ((db < da) & short_back).to(months.dtype))
            div = {"month": 1, "quarter": 3, "year": 12}[unit]
            q = torch.sign(months) * (torch.abs(months) // div)
            return Column(q.to(torch.int64), nulls, BIGINT)
        raise NotImplementedError(f"date_diff unit {unit!r}")

    # ---- math (operator/scalar/MathFunctions.java) -----------------------
    if name == "power":
        x = ev(e.args[0], page)
        p = ev(e.args[1], page)
        return Column(torch.pow(_as_f64(x), _as_f64(p)), x.nulls | p.nulls,
                      DOUBLE)
    if name == "cbrt":
        c = ev(e.args[0], page)
        v = _as_f64(c)
        return Column(torch.sign(v) * torch.pow(torch.abs(v), 1.0 / 3.0),
                      c.nulls, DOUBLE)
    if name == "log2":
        c = ev(e.args[0], page)
        return Column(torch.log2(_as_f64(c)), c.nulls, DOUBLE)
    if name == "sign":
        c = ev(e.args[0], page)
        if c.type.is_decimal:     # sign of the unscaled == sign of the value
            return Column(torch.sign(c.values).to(torch.int64), c.nulls,
                          BIGINT)
        return Column(torch.sign(c.values), c.nulls, c.type)
    if name == "truncate":
        c = ev(e.args[0], page)
        if c.type.is_integer:
            return Column(c.values, c.nulls, c.type)
        return Column(torch.trunc(_as_f64(c)), c.nulls, DOUBLE)
    if name in ("pi", "e"):
        val = math.pi if name == "pi" else math.e
        cap = page.capacity
        return Column(torch.full((cap,), val, dtype=torch.float64,
                                 device=dev),
                      torch.zeros(cap, dtype=torch.bool, device=dev), DOUBLE)
    if name in ("greatest", "least"):
        binop = torch.maximum if name == "greatest" else torch.minimum
        if e.type.is_string:
            # dictionary codes only order within ONE dictionary: align
            # pairwise, fold on aligned codes
            acc_col = ev(e.args[0], page)
            for a in e.args[1:]:
                x, y = align_string_columns(acc_col, ev(a, page))
                acc_col = Column(binop(x.values, y.values),
                                 x.nulls | y.nulls, VARCHAR, x.dictionary)
            return acc_col
        # coerce every arg to the common result type first
        cols = [_cast(ev(a, page), e.type) for a in e.args]
        acc = cols[0].values
        nulls = cols[0].nulls
        for c in cols[1:]:
            acc = binop(acc, c.values.to(acc.dtype))
            nulls = nulls | c.nulls     # Presto: any NULL arg -> NULL
        return Column(acc, nulls, e.type)
    raise NotImplementedError(
        f"function {name}: not in the port (plugin and remote functions "
        f"are a later slice)")
