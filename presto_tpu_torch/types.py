"""SQL type system.

Re-designed (not ported) from the reference's type layer
(presto-common/src/main/java/com/facebook/presto/common/type/, 86 files).
Each SQL type maps to a fixed-width device representation:

    BOOLEAN              -> bool_
    TINYINT/SMALLINT/
    INTEGER              -> int32
    BIGINT               -> int64
    REAL                 -> float32
    DOUBLE               -> float64
    DECIMAL(p<=18, s)    -> int64 scaled by 10**s (exact)
    DATE                 -> int32 days since 1970-01-01
    TIMESTAMP            -> int64 microseconds since epoch
    VARCHAR/CHAR         -> int32 codes into a *sorted* host-side dictionary
                            (sorted => code order == lexicographic order, so
                            <,>,=,group-by work directly on codes on device)

Types are immutable, hashable values so they can ride in pytree aux data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Type:
    """Base SQL type. `name` follows Presto's type-signature spelling."""

    name: str

    # ---- classification ------------------------------------------------
    @property
    def is_string(self) -> bool:
        return self.name in ("varchar", "char")

    @property
    def is_integer(self) -> bool:
        return self.name in ("tinyint", "smallint", "integer", "bigint")

    @property
    def is_floating(self) -> bool:
        return self.name in ("real", "double")

    @property
    def is_decimal(self) -> bool:
        return isinstance(self, DecimalType)

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.is_decimal

    @property
    def is_temporal(self) -> bool:
        return self.name in ("date", "timestamp")

    @property
    def is_orderable(self) -> bool:
        return True

    # ---- device representation ----------------------------------------
    @property
    def dtype(self) -> np.dtype:
        return _DTYPES[self.name]

    def null_sentinel(self):
        """Value stored in the `values` array where nulls is True. Chosen so
        padding/null rows sort *after* every real value (ascending)."""
        dt = self.dtype
        if dt == np.bool_:
            return False
        if np.issubdtype(dt, np.integer):
            return np.iinfo(dt).max
        return np.inf

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"Type({self.name})"


@dataclasses.dataclass(frozen=True, repr=False)
class DecimalType(Type):
    precision: int = 18
    scale: int = 0

    def __init__(self, precision: int = 18, scale: int = 0):
        if precision > 38:
            raise ValueError(
                f"DECIMAL({precision},{scale}): precision > 38")
        object.__setattr__(self, "name", "decimal")
        object.__setattr__(self, "precision", precision)
        object.__setattr__(self, "scale", scale)

    @property
    def uses_int128(self) -> bool:
        """p > 18 exceeds the scaled-int64 fast path; values live in
        hi/lo int64 limb lanes (reference: presto-common Decimals.java
        short/long decimal split at 18 digits,
        UnscaledDecimal128Arithmetic.java)."""
        return self.precision > 18

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.int64)

    def __str__(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __repr__(self) -> str:
        return f"DecimalType({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True, repr=False)
class ArrayType(Type):
    """ARRAY(T): offset-encoded on device (reference:
    presto-common/.../block/ArrayBlock.java)."""
    element: Type = None

    def __init__(self, element: Type):
        object.__setattr__(self, "name", "array")
        object.__setattr__(self, "element", element)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.int32)     # per-row offsets into element column

    def __str__(self) -> str:
        return f"array({self.element})"

    def __repr__(self) -> str:
        return f"ArrayType({self.element!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class MapType(Type):
    """MAP(K, V): offsets + parallel key/value columns (reference:
    presto-common/.../block/MapBlock.java; no hash index — lookups scan
    the per-row slice, which vectorizes fine at TPU batch sizes)."""
    key: Type = None
    value: Type = None

    def __init__(self, key: Type, value: Type):
        object.__setattr__(self, "name", "map")
        object.__setattr__(self, "key", key)
        object.__setattr__(self, "value", value)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.int32)

    def __str__(self) -> str:
        return f"map({self.key}, {self.value})"

    def __repr__(self) -> str:
        return f"MapType({self.key!r}, {self.value!r})"


@dataclasses.dataclass(frozen=True, repr=False)
class RowType(Type):
    """ROW(f1 T1, ...): struct-of-columns (reference:
    presto-common/.../block/RowBlock.java). field_names entries may be
    None for anonymous fields."""
    field_names: tuple = ()
    field_types: tuple = ()

    def __init__(self, field_names, field_types):
        object.__setattr__(self, "name", "row")
        object.__setattr__(self, "field_names", tuple(field_names))
        object.__setattr__(self, "field_types", tuple(field_types))

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.bool_)     # row itself carries only a null flag

    def __str__(self) -> str:
        fields = ", ".join(
            (f"{n} {t}" if n else str(t))
            for n, t in zip(self.field_names, self.field_types))
        return f"row({fields})"

    def __repr__(self) -> str:
        return f"RowType({self.field_names!r}, {self.field_types!r})"


BOOLEAN = Type("boolean")
TINYINT = Type("tinyint")
SMALLINT = Type("smallint")
INTEGER = Type("integer")
BIGINT = Type("bigint")
REAL = Type("real")
DOUBLE = Type("double")
VARCHAR = Type("varchar")
CHAR = Type("char")
DATE = Type("date")
TIMESTAMP = Type("timestamp")
UNKNOWN = Type("unknown")  # type of a bare NULL literal

_DTYPES = {
    "boolean": np.dtype(np.bool_),
    "tinyint": np.dtype(np.int32),
    "smallint": np.dtype(np.int32),
    "integer": np.dtype(np.int32),
    "bigint": np.dtype(np.int64),
    "real": np.dtype(np.float32),
    "double": np.dtype(np.float64),
    "varchar": np.dtype(np.int32),
    "char": np.dtype(np.int32),
    "date": np.dtype(np.int32),
    "timestamp": np.dtype(np.int64),
    "decimal": np.dtype(np.int64),
    "unknown": np.dtype(np.bool_),
}

_BY_NAME = {
    "boolean": BOOLEAN, "tinyint": TINYINT, "smallint": SMALLINT,
    "integer": INTEGER, "int": INTEGER, "bigint": BIGINT, "real": REAL,
    "double": DOUBLE, "varchar": VARCHAR, "char": CHAR, "date": DATE,
    "timestamp": TIMESTAMP, "unknown": UNKNOWN,
}


def _split_args(inner: str):
    """Split a parenthesized arg list on top-level commas, respecting
    double-quoted field names: 'varchar, row("a,b" bigint)' -> two."""
    parts, depth, start, quoted = [], 0, 0, False
    for i, c in enumerate(inner):
        if c == '"':
            quoted = not quoted
        elif quoted:
            continue
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(inner[start:i])
            start = i + 1
    tail = inner[start:]
    if tail.strip():
        parts.append(tail)
    return [p.strip() for p in parts]


def parse_type(signature: str) -> Type:
    """Parse a Presto type signature, e.g. 'bigint', 'decimal(12,2)',
    'varchar(25)', 'array(map(varchar, row(id bigint, d varchar)))'.
    Reference grammar: presto_cpp/main/types/TypeParser.cpp (nested
    parenthesized signatures; row fields optionally named)."""
    s = signature.strip()
    low = s.lower()
    base = low.split("(", 1)[0].strip()
    if "(" in s:
        if ")" not in s:
            raise ValueError(
                f"malformed type signature (unbalanced parens): "
                f"{signature!r}")
        inner = s[s.index("(") + 1:s.rindex(")")]
    else:
        inner = None
    if base == "decimal":
        if inner is not None:
            p, _, sc = inner.partition(",")
            return DecimalType(int(p), int(sc or 0))
        return DecimalType()
    if base == "array":
        if inner is None:
            raise ValueError(f"array signature missing element: {signature!r}")
        return ArrayType(parse_type(inner))
    if base == "map":
        kv = _split_args(inner or "")
        if len(kv) != 2:
            raise ValueError(f"map signature needs 2 args: {signature!r}")
        return MapType(parse_type(kv[0]), parse_type(kv[1]))
    if base == "row":
        names, typs = [], []
        for f in _split_args(inner or ""):
            # 'name type' | '"quoted name" type' | bare 'type'
            if f.startswith('"'):
                end = f.index('"', 1)
                names.append(f[1:end])
                typs.append(parse_type(f[end + 1:]))
                continue
            head, _, rest = f.partition(" ")
            # A leading token is a field NAME unless it is exactly a type
            # keyword (compare the token before any '(' — 'charge' or
            # 'row_id' must not prefix-match 'char'/'row').
            token = head.lower().split("(", 1)[0]
            is_type_kw = token in _BY_NAME or token in (
                "decimal", "array", "map", "row")
            if rest and not is_type_kw:
                names.append(head)
                typs.append(parse_type(rest))
            elif rest and is_type_kw:
                # ambiguous: a field NAMED like a type keyword
                # ('row(date date)') vs a multi-word bare type; prefer
                # the bare-type reading, fall back to name+type.
                try:
                    typs.append(parse_type(f))
                    names.append(None)
                except ValueError:
                    names.append(head)
                    typs.append(parse_type(rest))
            else:
                names.append(None)
                typs.append(parse_type(f))
        return RowType(names, typs)
    try:
        return _BY_NAME[base]
    except KeyError:
        raise ValueError(f"unsupported type signature: {signature!r}") from None


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Numeric/temporal coercion lattice (reference:
    presto-common/.../type/TypeManager semantics, simplified)."""
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    order = ["tinyint", "smallint", "integer", "bigint", "real", "double"]
    if a.is_decimal and b.is_decimal:
        # up to 38 digits, as Presto's decimal super type; the JAX package
        # caps it at 18 here, which truncates a DECIMAL(38) branch of a
        # CASE or COALESCE (ROADMAP Queue 3)
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return DecimalType(min(38, intd + scale), scale)
    if a.is_decimal and b.name in order:
        return DOUBLE if b.is_floating else a
    if b.is_decimal and a.name in order:
        return DOUBLE if a.is_floating else b
    if a.name in order and b.name in order:
        return _BY_NAME[order[max(order.index(a.name), order.index(b.name))]]
    if {a.name, b.name} == {"date", "timestamp"}:
        return TIMESTAMP
    if a.is_string and b.is_string:
        return VARCHAR
    return None
