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
    """Host-side sorted string dictionary, compared by identity."""

    __slots__ = ("words",)

    def __init__(self, words: Sequence[str]):
        self.words: Tuple[str, ...] = tuple(words)

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
            device = columns[0].values.device
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
            v, nl = c.to_numpy(n)
            cols.append((c, v, nl))
        rows: List[tuple] = []
        for i in range(n):
            row = []
            for c, v, nl in cols:
                if nl[i]:
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
    `Column.to_numpy` plus `StringDict.words` give them. `num_rows`
    defaults to the arrays' length; `capacity` to its bucket."""
    cols = []
    n = num_rows if num_rows is not None else (
        len(columns[0][0]) if columns else 0)
    cap = capacity if capacity is not None else bucket_capacity(
        max(n, len(columns[0][0]) if columns else 0))
    for (vals, nulls, words), t in zip(columns, types):
        d = StringDict(words) if words is not None else None
        cols.append(Column.from_numpy(np.asarray(vals)[:cap], t,
                                      nulls=np.asarray(nulls)[:cap],
                                      dictionary=d, capacity=cap,
                                      device=device))
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
    tile = native.COMPACT_TILE
    scratch = torch.empty((n + tile - 1) // tile, dtype=torch.int64,
                          device=keep.device)
    lib = native.load("compact")
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
