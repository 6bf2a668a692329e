"""Checked-arithmetic error lane.

The port's twin of presto_tpu/expr/errors.py. Presto raises
NUMERIC_VALUE_OUT_OF_RANGE on integer overflow; a data-parallel engine
cannot raise per row, so every checked operation computes a device-side
"did any valid row overflow" flag. Inside a query the executor installs a
collector (`collecting`) that ORs the flags into one int64 bitmask on the
device; the executor reads it with its other counters in one host sync at
the end of the query and raises (`raise_for_mask`). Outside a collector
`record` checks the flag at once.

A row participates only if it is valid: within page.num_rows and non-NULL
in every operand (NULL propagation wins over overflow in Presto).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

# bit codes -> Presto-style messages
OVF_ADD = 1
OVF_SUB = 2
OVF_MUL = 4
OVF_DIV = 8
OVF_NEG = 16
OVF_ABS = 32
OVF_SUM = 64
OVF_CAST = 128
OVF_DECIMAL = 256

MESSAGES = {
    OVF_ADD: "bigint addition overflow",
    OVF_SUB: "bigint subtraction overflow",
    OVF_MUL: "bigint multiplication overflow",
    OVF_DIV: "bigint division overflow",
    OVF_NEG: "bigint negation overflow",
    OVF_ABS: "bigint abs overflow",
    OVF_SUM: "bigint sum overflow",
    OVF_CAST: "out of range for integer cast",
    OVF_DECIMAL: "DECIMAL overflow",
}

INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1


class ArithmeticOverflowError(ArithmeticError):
    """Maps to PrestoException(NUMERIC_VALUE_OUT_OF_RANGE)."""

    error_code = "NUMERIC_VALUE_OUT_OF_RANGE"


class _Collector:
    def __init__(self):
        self.flag: Optional[torch.Tensor] = None

    def record(self, code: int, any_flag: torch.Tensor) -> None:
        self.record_mask(any_flag.to(torch.int64) * code)

    def record_mask(self, mask: torch.Tensor) -> None:
        self.flag = mask if self.flag is None else (self.flag | mask)

    def combined(self, device) -> torch.Tensor:
        return (self.flag.to(device) if self.flag is not None
                else torch.zeros((), dtype=torch.int64, device=device))


_TLS = threading.local()


def _stack() -> List[_Collector]:
    """Per-thread collector stack (queries on different threads keep
    their own flags)."""
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


@contextlib.contextmanager
def collecting():
    """Install an error collector for the duration of a query."""
    c = _Collector()
    s = _stack()
    s.append(c)
    try:
        yield c
    finally:
        s.pop()


def record(code: int, any_flag) -> None:
    """`any_flag`: 0-d bool tensor. Inside a collector it joins the
    query's error lane; outside one it is checked now (a host sync)."""
    if not isinstance(any_flag, torch.Tensor):
        any_flag = torch.as_tensor(bool(any_flag))
    s = _stack()
    if s:
        s[-1].record(code, any_flag)
        return
    if bool(any_flag):
        raise_for_mask(code)


def record_mask(mask: torch.Tensor) -> None:
    """`mask`: 0-d int64 tensor of ORed codes (a kernel's error word).
    Inside a collector it joins the query's error lane; outside one it is
    checked now (a host sync)."""
    s = _stack()
    if s:
        s[-1].record_mask(mask)
        return
    raise_for_mask(int(mask))


def raise_for_mask(mask: int) -> None:
    mask = int(mask)
    if not mask:
        return
    for code, msg in MESSAGES.items():
        if mask & code:
            raise ArithmeticOverflowError(msg)
    raise ArithmeticOverflowError(f"arithmetic error (mask={mask})")


# ---- detection math (on the already-wrapped two's-complement result)
def add_overflows(x, y, s):
    """s = x + y wrapped. Overflow iff operands share a sign the sum
    lost: ((x ^ s) & (y ^ s)) < 0."""
    return ((x ^ s) & (y ^ s)) < 0


def sub_overflows(x, y, s):
    """s = x - y wrapped."""
    return ((x ^ y) & (x ^ s)) < 0


def mul_overflows(x, y, s):
    """s = x * y wrapped: recover y by truncating division and compare;
    the one non-recoverable case is MIN * -1 (at the result's width)."""
    lo = torch.iinfo(s.dtype).min
    x = torch.as_tensor(x, dtype=s.dtype, device=s.device)
    y = torch.as_tensor(y, dtype=s.dtype, device=s.device)
    safe_x = torch.where(x == 0, torch.ones_like(x), x)
    # s / -1 with s == MIN overflows the division itself; the quotient
    # check below does not need it, so divide -MIN's image safely
    q = torch.div(torch.where((s == lo) & (safe_x == -1),
                              torch.zeros_like(s), s),
                  safe_x, rounding_mode="trunc")
    q = torch.where((s == lo) & (safe_x == -1), s, q)
    bad_div = (x == -1) & (y == lo)
    return (x != 0) & ((q != y) | bad_div)
