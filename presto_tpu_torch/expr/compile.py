"""RowExpression -> torch compiler.

The port's twin of presto_tpu/expr/compile.py: `compile_expr` returns a
closure that evaluates a whole expression tree over a Page with torch
tensor ops, eagerly on the page's device. SQL three-valued logic rides as
an explicit null lane per sub-expression; string operations use the
sorted-dictionary invariant (comparisons on int32 codes; LIKE and string
transforms run on the host over the dictionary, then one device gather).

As in the JAX package, row-level division by zero yields NULL, and
checked integer/decimal overflow sets the query's error lane
(expr/errors.py).

Not ported yet (they raise NotImplementedError): DECIMAL(38) values
(data/int128.py limb lanes) and plugin/remote functions.
"""

from __future__ import annotations

import math
import re
from functools import reduce
from typing import Callable, Optional

import numpy as np
import torch

from presto_tpu_torch.data.column import Column, Page, StringDict, torch_dtype
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


def _merge_dicts(a: StringDict, b: StringDict, device):
    """Merge two sorted dictionaries; returns (merged, map_a, map_b) where
    map_x[i] is the merged code of x's word i. Host-side."""
    wa = np.asarray(a.words, dtype=object)
    wb = np.asarray(b.words, dtype=object)
    merged = sorted(set(a.words) | set(b.words))
    md = StringDict(merged)
    marr = np.asarray(merged, dtype=object)
    map_a = np.searchsorted(marr.astype(str), wa.astype(str)).astype(np.int32)
    map_b = np.searchsorted(marr.astype(str), wb.astype(str)).astype(np.int32)
    return md, _table(map_a, device), _table(map_b, device)


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


def _unported_wide(what: str):
    raise NotImplementedError(
        f"{what}: DECIMAL(38) (data/int128.py) is a later slice of the port")


def _cast(col: Column, to: Type, valid=None) -> Column:
    """`valid`: rows taking part in checked range/overflow detection
    (user-facing CASTs pass it; internal coercions leave it None)."""
    from presto_tpu_torch.expr import errors as E

    frm = col.type
    if frm == to:
        return col
    if isinstance(to, DecimalType) and to.uses_int128:
        _unported_wide(f"cast {frm} -> {to}")
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
        if frm.uses_int128 and not to.is_floating:
            _unported_wide(f"cast {frm} -> {to}")
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
        words = col.dictionary.words
        mapped = np.array([_parse_date_host(w) for w in words],
                          dtype=np.int32)
        return Column(_take(_table(mapped, v.device), v), n, to)
    if to == TIMESTAMP and frm == DATE:
        return Column(v.to(torch.int64) * 86_400_000_000, n, to)
    if to == BOOLEAN and (frm.is_integer or frm.is_floating):
        return Column(v != 0, n, to)
    if to.is_string and frm.is_string:
        return Column(v, n, to, col.dictionary)
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
        if e.value is None:
            return _const_column(None, t, cap, device, StringDict([]))
        return _const_column(0, t, cap, device, StringDict([e.value]))
    if isinstance(t, DecimalType) and t.uses_int128:
        _unported_wide(f"literal {t}")
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
        if t.type.is_string and el.type.is_string:
            t, el = align_string_columns(t, el)
        elif t.type != el.type:
            t, el = _common_numeric(t, el)
        take_then = ~c.nulls & _truthy(c)
        return Column(torch.where(take_then, t.values, el.values),
                      torch.where(take_then, t.nulls, el.nulls),
                      t.type, t.dictionary)
    if f == Form.COALESCE:
        cols = [ev(a, page) for a in e.args]
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
    return isinstance(col.type, DecimalType) and col.type.uses_int128


def _compare(op: str, x: Column, y: Column) -> Column:
    if _is_wide(x) or _is_wide(y):
        _unported_wide(f"comparison {x.type} {op} {y.type}")
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
    wide_out = isinstance(rt, DecimalType) and rt.uses_int128
    # Until DECIMAL(38) is ported, a product of narrow operands typed
    # DECIMAL(19..38) (bigint * 1.0 in TPC-DS q78 and q83) is held in
    # int64, and a value beyond 64 bits raises NotImplementedError; such
    # a column may only be cast to a float (a division typed DOUBLE).
    if (wide_in and not rt.is_floating) or (
            wide_out and (wide_in or op != "multiply")):
        _unported_wide(f"{op} over {x.type}, {y.type}")
    if isinstance(rt, DecimalType):
        xs = x.type.scale if isinstance(x.type, DecimalType) else 0
        ys = y.type.scale if isinstance(y.type, DecimalType) else 0
        xv = x.values.to(torch.int64)
        yv = y.values.to(torch.int64)
        if op == "multiply":
            v = xv * yv
            E.record(E.WIDE_BEYOND_INT64 if wide_out else E.OVF_DECIMAL,
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


def _dict_transform(col: Column, fn) -> Column:
    """Apply a host string->string fn over the dictionary, producing a new
    sorted dictionary + device code remap (one gather)."""
    words = [fn(w) for w in col.dictionary.words]
    dev = col.values.device
    if words:
        newd, codes = StringDict.build(words)
        remap = _table(codes, dev)
    else:
        newd = StringDict([])
        remap = torch.zeros(1, dtype=torch.int32, device=dev)
    return Column(_take(remap, col.values), col.nulls, col.type, newd)


def _dict_predicate(col: Column, fn) -> Column:
    """Host predicate over dictionary words -> device boolean via gather."""
    words = col.dictionary.words
    if not words:
        return _bool(torch.zeros_like(col.nulls), col.nulls)
    tbl = _table(np.array([bool(fn(w)) for w in words]), col.values.device)
    return _bool(_take(tbl, col.values), col.nulls)


def _as_f64(col: Column) -> torch.Tensor:
    """Column values as float64 LOGICAL values (decimals descale)."""
    v = col.values.to(torch.float64)
    if col.type.is_decimal:
        v = v / (10 ** col.type.scale)
    return v


def _dict_transform_nullable(col: Column, fn) -> Column:
    """Like _dict_transform, but fn may return None: those codes become
    NULL rows."""
    words = col.dictionary.words if col.dictionary else ()
    dev = col.values.device
    out = [fn(w) for w in words]
    null_tbl = np.array([o is None for o in out], dtype=bool)
    filled = ["" if o is None else o for o in out]
    if filled:
        newd, codes = StringDict.build(filled)
        nv = _take(_table(codes, dev), col.values)
        extra_null = _take(_table(null_tbl, dev), col.values)
    else:
        newd = StringDict([])
        nv = torch.zeros_like(col.values)
        extra_null = torch.zeros_like(col.nulls)
    return Column(nv, col.nulls | extra_null, col.type, newd)


def _dict_int(col: Column, fn) -> Column:
    """Host string->int fn over the dictionary -> device BIGINT gather."""
    words = col.dictionary.words if col.dictionary else ()
    tbl = (np.array([int(fn(w)) for w in words], np.int64)
           if words else np.zeros(1, np.int64))
    return Column(_take(_table(tbl, col.values.device), col.values),
                  col.nulls, BIGINT)


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
            _unported_wide("negate")
        if c.type.is_integer:   # -MIN is not representable
            from presto_tpu_torch.expr import errors as E
            lo = torch.iinfo(c.values.dtype).min
            E.record(E.OVF_NEG, torch.any(
                (c.values == lo) & _valid_rows(page, c)))
        return Column(-c.values, c.nulls, c.type)
    if name == "abs":
        c = ev(e.args[0], page)
        if _is_wide(c):
            _unported_wide("abs")
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
        return _dict_predicate(c, lambda w: rx.match(w) is not None)
    if name == "substr":
        c = ev(e.args[0], page)
        start = e.args[1].value  # 1-based, literal
        length = e.args[2].value if len(e.args) > 2 else None
        if length is None:
            return _dict_transform(c, lambda w: w[start - 1:])
        return _dict_transform(c, lambda w: w[start - 1:start - 1 + length])
    if name in ("lower", "upper", "trim", "ltrim", "rtrim"):
        c = ev(e.args[0], page)
        fn = {"lower": str.lower, "upper": str.upper, "trim": str.strip,
              "ltrim": str.lstrip, "rtrim": str.rstrip}[name]
        return _dict_transform(c, fn)
    if name == "length":
        c = ev(e.args[0], page)
        return _dict_int(c, len)
    if name == "concat":
        a, b = ev(e.args[0], page), ev(e.args[1], page)
        if isinstance(e.args[1], Literal):
            return _dict_transform(a, lambda w: w + e.args[1].value)
        if isinstance(e.args[0], Literal):
            return _dict_transform(b, lambda w: e.args[0].value + w)
        # column || column: the result dictionary is the sorted cross
        # product of both dictionaries with a host-built (ca, cb) ->
        # combined-code table; the per-row work is one gather
        aw = a.dictionary.words if a.dictionary else ("",)
        bw = b.dictionary.words if b.dictionary else ("",)
        if len(aw) * len(bw) > 1_000_000:
            raise NotImplementedError(
                f"concat dictionary product too large "
                f"({len(aw)}x{len(bw)})")
        pairs = [x + y for x in aw for y in bw]
        union = sorted(set(pairs))
        uarr = np.asarray(union, dtype=object).astype(str)
        lut = np.searchsorted(
            uarr, np.asarray(pairs, dtype=object).astype(str)
        ).astype(np.int32)
        ca = a.values.long().clamp(0, len(aw) - 1)
        cb = b.values.long().clamp(0, len(bw) - 1)
        v = _take(_table(lut, dev), ca * len(bw) + cb)
        return Column(v, a.nulls | b.nulls, VARCHAR, StringDict(union))
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
        return _dict_transform(c, lambda w: w.replace(find, repl))
    if name == "reverse":
        c = ev(e.args[0], page)
        return _dict_transform(c, lambda w: w[::-1])
    if name in ("lpad", "rpad"):
        c = ev(e.args[0], page)
        size = _litint(1, "size")
        pad = _litstr(2, "padstring") if len(e.args) > 2 else " "
        left = name == "lpad"
        return _dict_transform(c, lambda w: _pad_word(w, size, pad, left))
    if name == "split_part":
        c = ev(e.args[0], page)
        delim = _litstr(1, "delimiter")
        index = _litint(2, "index")
        if index <= 0:
            raise NotImplementedError("split_part index must be > 0")

        def part(w):
            ps = w.split(delim) if delim else [w]
            return ps[index - 1] if index <= len(ps) else None
        return _dict_transform_nullable(c, part)
    if name == "strpos":
        c = ev(e.args[0], page)
        sub = _litstr(1, "substring")
        return _dict_int(c, lambda w: w.find(sub) + 1)
    if name == "starts_with":
        c = ev(e.args[0], page)
        pre = _litstr(1, "prefix")
        return _dict_predicate(c, lambda w: w.startswith(pre))
    if name == "regexp_like":
        c = ev(e.args[0], page)
        rx = _regex_cache(_litstr(1, "pattern"))
        return _dict_predicate(c, lambda w: rx.search(w) is not None)
    if name == "regexp_extract":
        c = ev(e.args[0], page)
        rx = _regex_cache(_litstr(1, "pattern"))
        group = _litint(2, "group") if len(e.args) > 2 else 0

        def extract(w):
            m = rx.search(w)
            return m.group(group) if m else None
        return _dict_transform_nullable(c, extract)
    if name == "regexp_replace":
        c = ev(e.args[0], page)
        rx = _regex_cache(_litstr(1, "pattern"))
        repl = _litstr(2, "replacement") if len(e.args) > 2 else ""
        # Presto capture refs are $1; python's are \1
        py_repl = re.sub(r"\$(\d+)", r"\\\1", repl)
        return _dict_transform(c, lambda w: rx.sub(py_repl, w))
    if name == "json_extract_scalar":
        c = ev(e.args[0], page)
        path = _litstr(1, "path")
        return _dict_transform_nullable(
            c, lambda w: _json_scalar_path(w, path))
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
            words = c.dictionary.words if c.dictionary else ()
            if not words:
                return Column(torch.zeros_like(c.values, dtype=torch.int64),
                              torch.ones_like(c.nulls), BIGINT)
            ports = []
            for w in words:
                try:
                    ports.append(urlparse(w).port)
                except ValueError:      # bad port -> NULL
                    ports.append(None)
            null_tbl = np.array([p is None for p in ports], bool)
            val_tbl = np.array([0 if p is None else p for p in ports],
                               np.int64)
            v = _take(_table(val_tbl, dev), c.values)
            extra = _take(_table(null_tbl, dev), c.values)
            return Column(v, c.nulls | extra, BIGINT)
        return _dict_transform_nullable(c, url_part)

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
