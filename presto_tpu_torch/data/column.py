"""Columnar data plane: Column / Page over torch tensors.

The port's twin of presto_tpu/data/column.py, with the same model:

- A Page has a *capacity* (its tensor length) and a device-resident row
  count `num_rows` (a 0-d int64 tensor) — rows [num_rows, capacity) are
  padding. Capacities come from the same power-of-two buckets as the JAX
  package, so both engines see pages of the same shape.
- A Column is `values` (fixed width, see types.py) + `nulls` (bool mask,
  True = NULL). Null slots hold the type's sort sentinel.
- Strings are int32 codes into a host-side *sorted* StringDict: code order
  == lexicographic order.

The invariant everywhere: *valid rows are the first num_rows rows*. Filters
compact (stable partition of survivors to the front) through the
hand-written `compact_indices` kernel (csrc/compact.cu).

Device policy: every function that allocates takes a `device`; None means
the card ("cuda"), and asking for the card where there is none raises. Only
a caller that passes "cpu" gets the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import decimal as _decimal
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.types import Type, DecimalType


#: explicit wide context for every engine-side Decimal op (the default
#: context is per thread with prec=28)
DEC_CTX = _decimal.Context(prec=80)


def scale_down_decimal(unscaled: int, scale: int) -> _decimal.Decimal:
    """Unscaled int -> exact python Decimal at `scale`."""
    return DEC_CTX.scaleb(_decimal.Decimal(unscaled), -scale)


def unscale_decimal(v, scale: int) -> int:
    """Python value -> exact unscaled int at `scale`, HALF_UP."""
    if not isinstance(v, _decimal.Decimal):
        v = _decimal.Decimal(str(v))
    return int(DEC_CTX.scaleb(v, scale).to_integral_value(
        rounding=_decimal.ROUND_HALF_UP))


def unscale_array(values: np.ndarray, scale: int) -> np.ndarray:
    """Float values -> int64 unscaled at `scale`, as `unscale_decimal`
    rounds each one (HALF_UP of its decimal form), for values that carry at
    most `scale` decimals: every value must lie within 1e-6 units of an
    integer at that scale, where HALF_UP and round-to-nearest agree, else
    ValueError."""
    scaled = np.asarray(values, dtype=np.float64) * float(10 ** scale)
    out = np.rint(scaled)
    if np.any(np.abs(scaled - out) > 1e-6):
        raise ValueError(f"values with more than {scale} decimals")
    return out.astype(np.int64)


def resolve_device(device=None) -> torch.device:
    """The device policy of the port: None means the card. A CUDA device
    with no card present raises; the CPU is used only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "presto_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev


_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(t: Type) -> torch.dtype:
    """The tensor dtype of a SQL type's values lane."""
    return _TORCH_DTYPES[np.dtype(t.dtype)]


# Capacity buckets: the JAX package pads pages to these for XLA's static
# shapes; the port keeps them so both engines see identical page shapes.
_BUCKETS = [256, 1024, 4096, 16384, 65536, 262144, 1048576, 2097152,
            4194304, 8388608, 16777216]


def bucket_capacity(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    b = _BUCKETS[-1]
    return ((n + b - 1) // b) * b


class StringDict:
    """Host-side sorted string dictionary, compared by identity.

    `derived` holds what expressions build from the words (transformed
    dictionaries, predicate and remap tables; expr/compile.py
    `_dict_cached`), so it lives and dies with the dictionary: a key can
    never meet a recycled id."""

    __slots__ = ("words", "derived")

    def __init__(self, words: Sequence[str]):
        self.words: Tuple[str, ...] = tuple(words)
        self.derived: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.words)

    def __getitem__(self, i: int) -> str:
        return self.words[i]

    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other) -> bool:
        return self is other

    def __repr__(self) -> str:
        return f"StringDict(n={len(self.words)})"

    @staticmethod
    def build(strings: Iterable[str]) -> Tuple["StringDict", np.ndarray]:
        arr = np.asarray(list(strings), dtype=object)
        uniq, codes = np.unique(arr.astype(str), return_inverse=True)
        return StringDict([str(u) for u in uniq]), codes.astype(np.int32)


def _sentinel(t: Type, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(t.null_sentinel(), dtype=like.dtype,
                        device=like.device)


@dataclasses.dataclass
class Column:
    values: torch.Tensor         # [capacity], dtype per type
    nulls: torch.Tensor          # [capacity] bool, True = NULL
    type: Type
    dictionary: Optional[StringDict] = None  # strings only

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_numpy(values: np.ndarray, type: Type,
                   nulls: Optional[np.ndarray] = None,
                   dictionary: Optional[StringDict] = None,
                   capacity: Optional[int] = None,
                   device=None) -> "Column":
        dev = resolve_device(device)
        n = len(values)
        cap = capacity if capacity is not None else bucket_capacity(n)
        dt = type.dtype
        out = np.full(cap, type.null_sentinel(), dtype=dt)
        out[:n] = np.asarray(values, dtype=dt)
        nl = np.ones(cap, dtype=bool)
        if nulls is None:
            nl[:n] = False
        else:
            nl[:n] = np.asarray(nulls, dtype=bool)
            out[:n] = np.where(nl[:n], dt.type(type.null_sentinel()), out[:n])
        return Column(torch.from_numpy(out).to(dev),
                      torch.from_numpy(nl).to(dev), type, dictionary)

    # -- host access ------------------------------------------------------
    def to_numpy(self, num_rows: Optional[int] = None):
        v, n = self.values, self.nulls
        if num_rows is not None:
            v, n = v[:num_rows], n[:num_rows]
        return v.cpu().numpy(), n.cpu().numpy()

    def gather(self, idx: torch.Tensor, valid: Optional[torch.Tensor] = None
               ) -> "Column":
        """Gather rows (indices clamped into range, as the JAX package's
        take(mode="clip")); rows where valid is False become padding."""
        idx = idx.long().clamp(0, max(self.capacity - 1, 0))
        vals = self.values[idx]
        nulls = self.nulls[idx]
        if valid is not None:
            vals = torch.where(valid, vals, _sentinel(self.type, vals))
            nulls = nulls | ~valid
        return Column(vals, nulls, self.type, self.dictionary)

@dataclasses.dataclass
class Decimal128Column:
    """DECIMAL(p>18) values (table storage, partial states and final
    aggregates) as FOUR 32-bit limb lanes in int64 tensors, the JAX
    package's layout (presto_tpu/data/column.py:206):

        exact value = (l3 << 96) + (l2 << 64) + (l1 << 32) + l0

    Any int64 per lane is a valid representation; kernels write normalized
    lanes (l3 signed, l2..l0 in [0, 2^32)), the plain version the JAX
    functions' lanes. Each lane can accumulate 2^31 row limbs without a
    carry, so sums are per-lane sums and stay exact past 2^127; carries
    resolve on the host in `value_at`. With `count` set the logical value
    is the AVERAGE: the exact sum / count rounded HALF_UP at the type's
    scale."""
    l3: torch.Tensor             # [capacity] int64 (signed top limbs)
    l2: torch.Tensor             # [capacity] int64
    l1: torch.Tensor             # [capacity] int64
    l0: torch.Tensor             # [capacity] int64
    nulls: torch.Tensor          # [capacity] bool
    type: Type                   # DecimalType(p>18, s)
    count: Optional[torch.Tensor] = None   # avg denominator

    @property
    def capacity(self) -> int:
        return self.l3.shape[0]

    @property
    def dictionary(self):
        return None

    @property
    def value_lanes(self):
        return (self.l3, self.l2, self.l1, self.l0)

    # -- construction -----------------------------------------------------
    @staticmethod
    def decompose_int64(v: torch.Tensor):
        """Limb lanes of int64 unscaled values (data/int128.from_int64)."""
        from presto_tpu_torch.data import int128
        return int128.from_int64(v)

    @staticmethod
    def from_unscaled_ints(ints, type: Type, nulls=None,
                           capacity: Optional[int] = None,
                           device=None) -> "Decimal128Column":
        """Host build from python-int unscaled values (exact for the full
        38-digit range); None or a set null flag is a NULL row."""
        n = len(ints)
        cap = capacity if capacity is not None else bucket_capacity(n)
        lanes = [np.zeros(cap, np.int64) for _ in range(4)]
        nl = np.ones(cap, dtype=bool)
        for i, v in enumerate(ints):
            if v is None or (nulls is not None and nulls[i]):
                continue
            nl[i] = False
            v = int(v)
            lanes[0][i] = v >> 96
            lanes[1][i] = (v >> 64) & 0xFFFFFFFF
            lanes[2][i] = (v >> 32) & 0xFFFFFFFF
            lanes[3][i] = v & 0xFFFFFFFF
        return Decimal128Column.from_numpy_lanes(lanes, nl, type,
                                                 device=device)

    @staticmethod
    def from_numpy_lanes(lanes, nulls, type: Type, count=None,
                         device=None) -> "Decimal128Column":
        """From numpy lanes (l3, l2, l1, l0), as the JAX column holds
        them, and a null mask of the same length."""
        dev = resolve_device(device)

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
        return Decimal128Column(
            *[up(x, np.int64) for x in lanes], up(nulls, np.bool_), type,
            None if count is None else up(count, np.int64))

    # -- row-lane protocol (gathers, compaction) --------------------------
    def row_lanes(self):
        lanes = [self.l3, self.l2, self.l1, self.l0, self.nulls]
        if self.count is not None:
            lanes.append(self.count)
        return lanes

    def from_lanes(self, lanes) -> "Decimal128Column":
        return Decimal128Column(*lanes[:5], self.type,
                                lanes[5] if self.count is not None else None)

    @staticmethod
    def mask_lanes(lanes, valid):
        """Zero value/count lanes and null out rows where ~valid; lane
        order as row_lanes() (nulls at index 4)."""
        out = list(lanes)
        for j in (0, 1, 2, 3):
            out[j] = torch.where(valid, out[j], 0)
        out[4] = out[4] | ~valid
        if len(out) > 5:
            out[5] = torch.where(valid, out[5], 0)
        return out

    def gather(self, idx: torch.Tensor, valid=None) -> "Decimal128Column":
        """Gather rows (indices clamped into range); rows where valid is
        False become NULL with zero lanes."""
        idx = idx.long().clamp(0, max(self.capacity - 1, 0))
        lanes = [x[idx] for x in self.row_lanes()]
        if valid is not None:
            lanes = Decimal128Column.mask_lanes(lanes, valid)
        return self.from_lanes(lanes)

    # -- host access ------------------------------------------------------
    def to_numpy(self, num_rows: Optional[int] = None):
        """(approximate float values, nulls): ordering and debugging only;
        exact values come from value_at."""
        v = sum(x.cpu().numpy().astype(np.float64) * float(2 ** s)
                for x, s in zip(self.value_lanes, (96, 64, 32, 0)))
        n = self.nulls.cpu().numpy()
        if num_rows is not None:
            v, n = v[:num_rows], n[:num_rows]
        return v, n

    def _host(self):
        """One host transfer per lane, memoized: (lanes, nulls, count or
        None) as numpy arrays."""
        cached = getattr(self, "_host_cache", None)
        if cached is None:
            cached = (tuple(x.cpu().numpy() for x in self.value_lanes),
                      self.nulls.cpu().numpy(),
                      None if self.count is None
                      else self.count.cpu().numpy())
            object.__setattr__(self, "_host_cache", cached)
        return cached

    def unscaled_at(self, i: int) -> int:
        from presto_tpu_torch.data.int128 import to_python_int
        return to_python_int(self._host()[0], i)

    def value_at(self, i: int):
        """Exact python value of row i (a Decimal at the type's scale)."""
        _lanes, nulls, count = self._host()
        if bool(nulls[i]):
            return None
        unscaled = self.unscaled_at(i)
        if self.count is not None:
            n = int(count[i])
            if n == 0:
                return None
            # avg = sum / n rounded HALF_UP at the result scale
            sign = -1 if (unscaled < 0) != (n < 0) else 1
            q, r = divmod(abs(unscaled), abs(n))
            if 2 * r >= abs(n):
                q += 1
            unscaled = sign * q
        if self.type.scale == 0:
            return unscaled
        return scale_down_decimal(unscaled, self.type.scale)


@dataclasses.dataclass
class NestedColumn:
    """ARRAY/MAP/ROW column (presto_tpu/data/column.py:380): per row a
    (start, length) slice into flat child columns, so a row gather or a
    filter never rewrites the child buffers.

    ARRAY: children = (elements,); MAP: children = (keys, values), one
    entry pair per map entry; ROW: one child per field, aligned 1:1 with
    the parent rows (starts are the identity, lengths 1). Operators other
    than UNNEST only carry the column along (gathers, compaction,
    results)."""
    starts: torch.Tensor         # [capacity] int32 into children
    lengths: torch.Tensor        # [capacity] int32 (entries per row)
    nulls: torch.Tensor          # [capacity] bool, True = NULL row
    children: tuple              # Column / Decimal128Column / NestedColumn
    type: Type                   # ArrayType | MapType | RowType

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    @property
    def dictionary(self):
        return None

    def gather(self, idx: torch.Tensor, valid=None) -> "NestedColumn":
        """Gather rows (indices clamped into range); rows where valid is
        False become NULL with start 0 and length 0. Starts are absolute
        child positions, so the children never move."""
        idx = idx.long().clamp(0, max(self.capacity - 1, 0))
        starts = self.starts[idx]
        lengths = self.lengths[idx]
        nulls = self.nulls[idx]
        if valid is not None:
            starts = torch.where(valid, starts, 0)
            lengths = torch.where(valid, lengths, 0)
            nulls = nulls | ~valid
        return NestedColumn(starts, lengths, nulls, self.children,
                            self.type)

    def to_numpy(self, num_rows: Optional[int] = None):
        """(lengths, nulls), the shape of Column.to_numpy, for callers
        that need validity only; values come from value_at."""
        v, n = self.lengths, self.nulls
        if num_rows is not None:
            v, n = v[:num_rows], n[:num_rows]
        return v.cpu().numpy(), n.cpu().numpy()

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_pylist(vals, type: Type, capacity: Optional[int] = None,
                    device=None) -> "NestedColumn":
        """From python values: lists (ARRAY), dicts (MAP), tuples (ROW)
        or None, laid out as the JAX package's from_pylist (:439) lays
        them out."""
        return NestedArrays.from_pylist(vals, type).column(
            type, capacity=capacity, device=device)

    @staticmethod
    def from_numpy(starts, lengths, nulls, children, type: Type,
                   capacity: Optional[int] = None,
                   device=None) -> "NestedColumn":
        """From the numpy form of a nested column: row lanes `starts`,
        `lengths`, `nulls` and per child its numpy form as
        page_from_numpy takes a column, `(values, nulls, dictionary words
        or None)`, or a nested child's own `(starts, lengths, nulls,
        children)`. Rows past the lanes' length up to `capacity` are
        NULL. A child keeps its length's bucket as its capacity (a ROW's
        fields the row capacity)."""
        n = len(nulls)
        cap = capacity if capacity is not None else bucket_capacity(n)
        row = type.name == "row"

        def lane(a, fill, dt):
            out = np.array(fill, dtype=dt)
            a = np.asarray(a, dtype=dt)[:cap]
            out[:len(a)] = a
            return out
        if row:
            child_types = type.field_types
        elif type.name == "map":
            child_types = (type.key, type.value)
        else:
            child_types = (type.element,)
        cols = []
        for form, ct in zip(children, child_types):
            ccap = cap if row else bucket_capacity(max(_form_len(form), 1))
            cols.append(_column_from_numpy(form, ct, ccap, device))
        # padding rows are NULL; a ROW's keep its identity layout (start
        # i, length 1), as from_pylist gives them
        return NestedColumn._of(
            lane(starts, np.arange(cap) if row else np.zeros(cap), np.int32),
            lane(lengths, np.ones(cap) if row else np.zeros(cap), np.int32),
            lane(nulls, np.ones(cap), np.bool_), tuple(cols), type, device)

    @staticmethod
    def _of(starts, lengths, nulls, children, type, device):
        dev = resolve_device(device)
        return NestedColumn(torch.from_numpy(starts).to(dev),
                            torch.from_numpy(lengths).to(dev),
                            torch.from_numpy(nulls).to(dev), children, type)

    # -- host access ------------------------------------------------------
    def _host(self):
        """The row lanes on the host, memoized: (starts, lengths,
        nulls)."""
        cached = getattr(self, "_host_cache", None)
        if cached is None:
            cached = tuple(x.cpu().numpy()
                           for x in (self.starts, self.lengths, self.nulls))
            object.__setattr__(self, "_host_cache", cached)
        return cached

    def value_at(self, i: int):
        """Python value of row i (presto_tpu/data/column.py:479)."""
        starts, lengths, nulls = self._host()
        if bool(nulls[i]):
            return None
        s = int(starts[i])
        if self.type.name == "row":
            return tuple(_pyvalue(c, s) for c in self.children)
        ln = int(lengths[i])
        if self.type.name == "map":
            return {_pyvalue(self.children[0], j):
                    _pyvalue(self.children[1], j)
                    for j in range(s, s + ln)}
        return [_pyvalue(self.children[0], j) for j in range(s, s + ln)]


def _column_from_pylist(vals, t: Type, capacity: int, device=None):
    """Python values -> the column of type t that holds them
    (presto_tpu/data/column.py:495)."""
    return _column_from_numpy(_form_from_pylist(vals, t), t, capacity,
                              device)


def _form_from_pylist(vals, t: Type):
    """Python values -> the numpy form (see page_from_numpy) of the column
    of type t that holds them: `(values, nulls, dictionary words or
    None)`, or a nested column's `(starts, lengths, nulls, children)`.
    String values are dictionary codes; NULLs hold 0 (a DECIMAL(p>18)
    NULL holds None)."""
    if t.name in ("array", "map", "row"):
        return NestedArrays.from_pylist(vals, t).form()
    nulls = np.array([v is None for v in vals], dtype=bool)
    if t.is_string:
        d, codes = StringDict.build(["" if v is None else v for v in vals])
        return codes, nulls, list(d.words)
    if isinstance(t, DecimalType) and t.uses_int128:
        ints = np.empty(len(vals), object)
        for i, v in enumerate(vals):
            ints[i] = None if v is None else unscale_decimal(v, t.scale)
        return ints, nulls, None
    if isinstance(t, DecimalType):
        # exact unscaling: a Decimal never round-trips through float64
        filled = np.array([0 if v is None else unscale_decimal(v, t.scale)
                           for v in vals], dtype=np.int64)
    else:
        filled = np.array([0 if v is None else v for v in vals])
    return np.asarray(filled, dtype=t.dtype), nulls, None


def _form_len(form) -> int:
    """The number of entries of a column's numpy form."""
    return len(form[2] if len(form) == 4 else form[1])


def _concat_forms(a, b, t: Type):
    """Two numpy forms of type t, a's entries then b's: strings merge
    their dictionaries (codes remapped), nested forms shift b's starts."""
    if t.name in ("array", "map", "row"):
        return NestedArrays(*a).concat(NestedArrays(*b), t).form()
    (va, na, wa), (vb, nb, wb) = a, b
    if t.is_string:
        union, (ra, rb) = merge_string_dicts([StringDict(wa or []),
                                              StringDict(wb or [])])
        va = ra[va] if len(va) else np.zeros(0, np.int32)
        vb = rb[vb] if len(vb) else np.zeros(0, np.int32)
        return np.concatenate([va, vb]), np.concatenate([na, nb]), \
            list(union.words)
    return np.concatenate([va, vb]), np.concatenate([na, nb]), None


def _column_from_numpy(form, t: Type, capacity: int, device=None):
    """One column's numpy form (see page_from_numpy) -> its column."""
    if t.name in ("array", "map", "row"):
        return NestedColumn.from_numpy(*form, t, capacity=capacity,
                                       device=device)
    vals, nulls, words = form
    nulls = np.asarray(nulls, dtype=bool)
    if isinstance(t, DecimalType) and t.uses_int128:
        if isinstance(vals, tuple) and len(vals) == 4:
            pad = max(capacity - len(nulls), 0)
            return Decimal128Column.from_numpy_lanes(
                [np.pad(np.asarray(x)[:capacity], (0, pad)) for x in vals],
                np.pad(nulls[:capacity], (0, pad), constant_values=True), t,
                device=device)
        return Decimal128Column.from_unscaled_ints(
            list(vals), t, nulls=nulls, capacity=capacity, device=device)
    d = StringDict(words) if words is not None else None
    return Column.from_numpy(np.asarray(vals)[:capacity], t,
                             nulls=nulls[:capacity], dictionary=d,
                             capacity=capacity, device=device)


def _pyvalue(col, i: int):
    """One position of a child column as a python value
    (presto_tpu/data/column.py:512)."""
    if isinstance(col, (NestedColumn, Decimal128Column)):
        return col.value_at(i)
    v, nl = _host_lanes(col)
    if nl[i]:
        return None
    if col.type.is_string:
        return (col.dictionary[int(v[i])]
                if col.dictionary is not None else int(v[i]))
    if isinstance(col.type, DecimalType):
        return scale_down_decimal(int(v[i]), col.type.scale)
    if col.type.name == "boolean":
        return bool(v[i])
    if col.type.is_floating:
        return float(v[i])
    return int(v[i])


def _host_lanes(col: Column):
    """A child column's (values, nulls) on the host, memoized on the
    column: value_at reads one child position per element."""
    cached = getattr(col, "_host_cache", None)
    if cached is None:
        cached = col.to_numpy()
        object.__setattr__(col, "_host_cache", cached)
    return cached


@dataclasses.dataclass
class NestedArrays:
    """A nested table column at rest in numpy: the row lanes `starts`,
    `lengths` and `nulls`, and the children in their numpy form (see
    NestedColumn.from_numpy). Slicing selects rows and shares the
    children, as a HostTable's row slices share their buffers."""
    starts: np.ndarray
    lengths: np.ndarray
    nulls: np.ndarray
    children: tuple

    def __len__(self) -> int:
        return len(self.nulls)

    def __getitem__(self, rows: slice) -> "NestedArrays":
        return NestedArrays(self.starts[rows], self.lengths[rows],
                            self.nulls[rows], self.children)

    @staticmethod
    def from_pylist(vals, type: Type) -> "NestedArrays":
        """From python values: lists (ARRAY), dicts (MAP), tuples (ROW)
        or None, laid out as the JAX package's from_pylist (:439) lays
        them out: each row's entries follow the previous row's (a NULL
        row starts where the next would, with length 0); a ROW's fields
        align 1:1 with the rows."""
        n = len(vals)
        nulls = np.array([v is None for v in vals], dtype=bool)
        if type.name == "row":
            fields = tuple(
                _form_from_pylist([None if v is None else v[i]
                                   for v in vals], ft)
                for i, ft in enumerate(type.field_types))
            return NestedArrays(np.arange(n, dtype=np.int32),
                                np.ones(n, np.int32), nulls, fields)
        lengths = np.zeros(n, np.int32)
        starts = np.zeros(n, np.int32)
        flat: list = []
        for i, v in enumerate(vals):
            starts[i] = len(flat)
            if v is None:
                continue
            items = list(v.items()) if type.name == "map" else list(v)
            lengths[i] = len(items)
            flat.extend(items)
        if type.name == "map":
            children = (_form_from_pylist([k for k, _v in flat], type.key),
                        _form_from_pylist([v for _k, v in flat],
                                          type.value))
        else:
            children = (_form_from_pylist(flat, type.element),)
        return NestedArrays(starts, lengths, nulls, children)

    def form(self) -> tuple:
        return self.starts, self.lengths, self.nulls, self.children

    def concat(self, other: "NestedArrays", type: Type) -> "NestedArrays":
        """self's rows then other's, other's starts shifted past self's
        child entries (the children are concatenated, string
        dictionaries merged)."""
        shift = _form_len(self.children[0]) if self.children else 0
        child_types = (type.field_types if type.name == "row" else
                       (type.key, type.value) if type.name == "map" else
                       (type.element,))
        return NestedArrays(
            np.concatenate([self.starts,
                            np.asarray(other.starts, np.int64) + shift]
                           ).astype(np.int32),
            np.concatenate([self.lengths, other.lengths]).astype(np.int32),
            np.concatenate([self.nulls, other.nulls]),
            tuple(_concat_forms(a, b, ct) for a, b, ct in
                  zip(self.children, other.children, child_types)))

    def column(self, type: Type, capacity: Optional[int] = None,
               device=None) -> NestedColumn:
        return NestedColumn.from_numpy(self.starts, self.lengths,
                                       self.nulls, self.children, type,
                                       capacity=capacity, device=device)


@dataclasses.dataclass
class Page:
    columns: Tuple[Column, ...]
    num_rows: torch.Tensor       # 0-d int64 on the page's device
    names: Tuple[str, ...] = ()

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def row_valid(self) -> torch.Tensor:
        return (torch.arange(self.capacity, dtype=torch.int64,
                             device=self.device) < self.num_rows)

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_columns(columns: Sequence[Column], num_rows,
                     names: Sequence[str] = (), device=None) -> "Page":
        if device is None and columns:
            device = columns[0].nulls.device
        dev = resolve_device(device)
        n = torch.as_tensor(num_rows, dtype=torch.int64).to(dev)
        return Page(tuple(columns), n.reshape(()), tuple(names))

    # -- host access ------------------------------------------------------
    def to_pylist(self) -> List[tuple]:
        """Materialize valid rows as python tuples: the one host sync of a
        query (the row count, then each column's valid prefix)."""
        n = int(self.num_rows)
        cols = []
        for c in self.columns:
            v, nl = (None, None) if isinstance(
                c, (Decimal128Column, NestedColumn)) else c.to_numpy(n)
            cols.append((c, v, nl))
        rows: List[tuple] = []
        for i in range(n):
            row = []
            for c, v, nl in cols:
                if v is None:
                    row.append(c.value_at(i))
                elif nl[i]:
                    row.append(None)
                elif c.type.is_string:
                    row.append(c.dictionary[int(v[i])]
                               if c.dictionary is not None else int(v[i]))
                elif isinstance(c.type, DecimalType):
                    row.append(scale_down_decimal(int(v[i]),
                                                  c.type.scale))
                elif c.type.name == "boolean":
                    row.append(bool(v[i]))
                elif c.type.is_floating:
                    row.append(float(v[i]))
                else:
                    row.append(int(v[i]))
            rows.append(tuple(row))
        return rows


def page_from_numpy(columns, types: Sequence[Type], names: Sequence[str] = (),
                    capacity: Optional[int] = None, device=None,
                    num_rows: Optional[int] = None) -> Page:
    """Build a Page from the numpy form of a page: per column
    `(values, nulls, dictionary words or None)`, as the JAX package's
    `Column.to_numpy` plus `StringDict.words` give them. A DECIMAL(p>18)
    column's values are its four numpy limb lanes (l3, l2, l1, l0), as the
    JAX Decimal128Column holds them, or a sequence of python-int unscaled
    values (None for NULL). An ARRAY/MAP/ROW column is
    `(starts, lengths, nulls, children)`, the JAX NestedColumn's lanes,
    with each child in this same numpy form. `num_rows` defaults to the
    nulls' length; `capacity` to its bucket."""
    def nulls_of(form):
        return form[2] if len(form) == 4 else form[1]
    n0 = len(nulls_of(columns[0])) if columns else 0
    n = num_rows if num_rows is not None else n0
    cap = capacity if capacity is not None else bucket_capacity(max(n, n0))
    cols = [_column_from_numpy(form, t, cap, device)
            for form, t in zip(columns, types)]
    return Page.from_columns(cols, n, names, device=device)


# ---------------------------------------------------------------------------
# Core page transforms (shared by operators)
# ---------------------------------------------------------------------------

def gather_page(page: Page, idx: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                num_rows=None, names: Optional[tuple] = None) -> Page:
    """Row-wise gather of every column (rows where `valid` is False become
    padding/null)."""
    cols = tuple(c.gather(idx, valid) for c in page.columns)
    return Page(cols,
                page.num_rows if num_rows is None else num_rows,
                page.names if names is None else names)


def _compact_indices_plain(keep: torch.Tensor,
                           num_rows: Optional[torch.Tensor]):
    """Plain PyTorch version of the compact_indices kernel: the JAX
    package's formula (a distinct order key per row, survivors first,
    argsorted)."""
    n = keep.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=keep.device)
    if num_rows is not None:
        keep = keep & (idx < num_rows)
    order_key = torch.where(keep, 0, n) + idx
    perm = torch.sort(order_key).indices
    return perm, keep.sum(dtype=torch.int64)


def compact_indices(keep: torch.Tensor,
                    num_rows: Optional[torch.Tensor] = None):
    """Stable stream compaction (kernel K2, csrc/compact.cu).

    Returns `(perm, count)`: `perm` [n] int64 is the stable partition of
    row indices with the rows where `keep` holds (and index < num_rows)
    first, in order, then every other row in order; `count` is a 0-d
    int64 tensor on the device holding the number of survivors. On a CPU
    tensor this is the plain version; on a CUDA tensor it launches the
    kernel."""
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(f"compact_indices: keep must be 1-d bool, got "
                        f"{keep.dtype} {tuple(keep.shape)}")
    if num_rows is not None and (num_rows.dtype != torch.int64
                                 or num_rows.numel() != 1
                                 or num_rows.device != keep.device):
        raise TypeError("compact_indices: num_rows must be a 0-d int64 "
                        "tensor on keep's device")
    if keep.device.type == "cpu":
        return _compact_indices_plain(keep, num_rows)
    if keep.device.type != "cuda":
        raise RuntimeError(f"compact_indices: no kernel for {keep.device}")
    from presto_tpu_torch import native
    keep = keep.contiguous()
    n = keep.shape[0]
    perm = torch.empty(n, dtype=torch.int64, device=keep.device)
    count = torch.empty((), dtype=torch.int64, device=keep.device)
    if n == 0:
        count.zero_()
        return perm, count
    lib = native.load("compact")
    scratch = torch.empty(lib.compact_scratch_words(n), dtype=torch.int64,
                          device=keep.device)
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream(keep.device).cuda_stream
        rc = lib.compact_indices(
            ctypes.c_void_p(keep.data_ptr()), ctypes.c_int64(n),
            ctypes.c_void_p(num_rows.data_ptr()
                            if num_rows is not None else 0),
            ctypes.c_void_p(perm.data_ptr()),
            ctypes.c_void_p(count.data_ptr()),
            ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(stream))
    native.check(rc, "compact_indices", "compact")
    compact_indices.launches += 1
    return perm, count


compact_indices.launches = 0


def compact(page: Page, keep: torch.Tensor) -> Page:
    """Stable-partition rows where `keep` is True to the front; the
    result's num_rows is the survivor count. The engine's filter primitive
    (presto_tpu/data/column.py:compact): the survivor order comes from the
    compact_indices kernel, then every column is gathered."""
    perm, n = compact_indices(keep, page.num_rows)
    valid = torch.arange(page.capacity, dtype=torch.int64,
                         device=keep.device) < n
    cols = [c.gather(perm, valid) for c in page.columns]
    return Page(tuple(cols), n, page.names)


def merge_string_dicts(dicts: Sequence[Optional[StringDict]]
                       ) -> Tuple[StringDict, List[np.ndarray]]:
    """Union N sorted dictionaries into one sorted dictionary; returns the
    union and, per input dict, the code remap array (old code -> new
    code), empty for a missing or empty dictionary
    (presto_tpu/data/column.py:618). Host code: UnionAll of branches
    whose string columns carry different dictionaries."""
    word_lists = [list(d.words) if d is not None else [] for d in dicts]
    union = sorted(set().union(*[set(w) for w in word_lists]))
    union_arr = np.asarray(union, dtype=object).astype(str)
    out = StringDict(union)
    remaps = []
    for words in word_lists:
        if not words:
            remaps.append(np.zeros(0, np.int32))
            continue
        remaps.append(np.searchsorted(
            union_arr, np.asarray(words, dtype=object).astype(str)
        ).astype(np.int32))
    return out, remaps
