"""128-bit limb arithmetic for DECIMAL(p>18), and its kernel K10.

The port's twin of presto_tpu/data/int128.py, with the same layout: a
value is FOUR 32-bit limb lanes held in int64 tensors,

    v = (l3 << 96) + (l2 << 64) + (l1 << 32) + l0

where the lanes are *redundant* accumulators: any int64 per lane is a valid
representation (carries resolve on `normalize` or on the host). That keeps
add/subtract/negate lane-wise and lets an int64 lane sum 2^31 row limbs
without a carry, so sums stay exact far past 2^127.

The functions below (`normalize` .. `from_python_int`) are the plain
PyTorch version, a line-for-line copy of the JAX functions: they work in
int64 with masked shifts (torch on the CPU has no uint64 arithmetic), and a
64-bit product that wraps is split into its unsigned 32-bit halves with
`p & M` / `(p >> 32) & M`.

`int128_op` is the one entry point the expression compiler calls for a
wide operation (presto_tpu/expr/compile.py `_wide_lanes` :454, `_cast_wide`
:250, `_compare` :477, `_arith_wide` :581, negate/abs :740-758). On CPU
tensors it composes the plain functions exactly as the JAX compiler does;
on CUDA tensors it launches the hand-written kernel K10
(csrc/int128.cu), which reads the operands' lanes (or int64 narrow
values), works on `__int128` in registers, writes normalized limbs and ORs
its overflow flags into a device error word.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

_M = 0xFFFFFFFF

Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
#: a wide operand: int64 narrow values (unscaled DECIMAL(<=18) or an
#: integer) or the four limb lanes of a DECIMAL(p>18) value
Operand = Union[torch.Tensor, Lanes]


def normalize(lanes):
    """Carry-normalize arbitrary int64 lanes to (t3, n2, n1, n0) with n*
    in [0, 2^32) and t3 signed. Lexicographic order of the result is
    numeric order. `x & M` is x mod 2^32 and `x >> 32` is floor(x / 2^32)
    in two's complement, so negative lanes work too."""
    l3, l2, l1, l0 = lanes
    n0 = l0 & _M
    t1 = l1 + (l0 >> 32)
    n1 = t1 & _M
    t2 = l2 + (t1 >> 32)
    n2 = t2 & _M
    t3 = l3 + (t2 >> 32)
    return (t3, n2, n1, n0)


def add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def negate(a):
    return tuple(-x for x in a)


def sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def is_negative(a):
    return normalize(a)[0] < 0


def _magnitude(a):
    """(sign_is_negative, normalized magnitude limbs m3..m0)."""
    t3, n2, n1, n0 = normalize(a)
    neg = t3 < 0
    limbs = [torch.where(neg, -x, x) for x in (t3, n2, n1, n0)]
    return neg, normalize(limbs)


def _split(p):
    """Unsigned halves of a 64-bit product that may have wrapped int64."""
    return (p >> 32) & _M, p & _M


def mul(a, b):
    """Exact product of two 128-bit lane values; returns (result_lanes,
    overflow per row). Overflow: the true product's magnitude reaches
    2^127 (Presto: DECIMAL overflow)."""
    neg_a, am = _magnitude(a)
    neg_b, bm = _magnitude(b)
    a3, a2, a1, a0 = am
    b3, b2, b1, b0 = bm

    def P(x, y):
        return _split(x * y)

    h00, l00 = P(a0, b0)
    h01, l01 = P(a0, b1)
    h10, l10 = P(a1, b0)
    h11, l11 = P(a1, b1)
    h02, l02 = P(a0, b2)
    h20, l20 = P(a2, b0)
    h03, l03 = P(a0, b3)
    h30, l30 = P(a3, b0)
    h12, l12 = P(a1, b2)
    h21, l21 = P(a2, b1)

    r0 = l00
    r1 = h00 + l01 + l10
    r2 = h01 + h10 + l11 + l02 + l20
    r3 = h11 + h02 + h20 + l03 + l30 + l12 + l21

    # any product contributing at or above bit 128 must be zero
    high = (h03 | h30 | h12 | h21
            | (a1 * b3) | (a3 * b1) | (a2 * b2)
            | (a2 * b3) | (a3 * b2) | (a3 * b3))
    overflow = high != 0
    # the magnitude must stay below 2^127 (Presto's 10^38-1 bound is
    # checked by the caller)
    t3 = normalize((r3, r2, r1, r0))[0]
    overflow = overflow | (t3 >= (1 << 31))

    neg = neg_a != neg_b
    out = tuple(torch.where(neg, -x, x) for x in (r3, r2, r1, r0))
    return out, overflow


def mul_pow10(a, k: int):
    """a * 10**k for a small non-negative exponent (decimal upscale).
    Returns (lanes, overflow)."""
    if k == 0:
        return a, torch.zeros(a[0].shape, dtype=torch.bool,
                              device=a[0].device)
    f = 10 ** k
    shaped = [torch.full_like(a[0], (f >> s) & _M) for s in (96, 64, 32, 0)]
    return mul(a, tuple(shaped))


def _div_small(mag, d: int):
    """Long division of normalized non-negative magnitude lanes by a
    scalar d <= 10^9, limb by limb. Each step's dividend r*2^32 + limb
    stays under 2^62 because r < d < 2^30, so int64 is exact; quotient
    lanes come out denormalized."""
    r = torch.zeros_like(mag[0])
    out = []
    for limb in mag:
        cur = (r << 32) | limb
        q = cur // d
        r = cur - q * d
        out.append(q)
    return tuple(out), r


def div_pow10(a, k: int):
    """a / 10**k rounded HALF_UP (away from zero; decimal downscale).
    Works on the sign-magnitude form; divisors beyond 10^9 apply in
    <= 10^9 chunks, since floor division composes."""
    if k == 0:
        return a
    neg, mag = _magnitude(a)
    q = mag
    left = k
    while left > 0:
        step = min(left, 9)
        q, _r = _div_small(normalize(q), 10 ** step)
        left -= step
    # remainder for rounding: r = |a| - q * 10^k (multiply-back, exact)
    back, _ovf = mul_pow10(q, k)
    rem = sub(mag, back)
    twice = add(rem, rem)
    d_lanes = from_python_int(10 ** k, a[0].shape, a[0].device)
    lt, eq = compare(d_lanes, twice)          # 10^k <?=? 2r
    round_up = (lt | eq).to(torch.int64)      # HALF_UP: 2r >= 10^k
    q = add(q, (0, 0, 0, round_up))
    return tuple(torch.where(neg, -x, x) for x in q)


DEC38_MAX = 10 ** 38 - 1


def exceeds_decimal38(lanes):
    """Per row |value| > 10^38-1, Presto's DECIMAL(38) range bound
    (Decimals.MAX_UNSCALED_DECIMAL)."""
    _neg, mag = _magnitude(lanes)
    lim = from_python_int(DEC38_MAX, lanes[0].shape, lanes[0].device)
    lt, _eq = compare(lim, mag)          # lim < |v|
    return lt


def compare(a, b):
    """(lt, eq) element-wise over the exact values."""
    ta = normalize(a)
    tb = normalize(b)
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(ta, tb):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt, eq


def from_int64(v):
    """Sign-extending limb decomposition of int64 values."""
    v = v.to(torch.int64)
    sign = v >> 63
    return (sign, sign & _M, (v >> 32) & _M, v & _M)


def from_python_int(v: int, shape, device=None):
    """A python int (full 128-bit range) as constant lanes: python's >>
    and & give two's-complement limbs directly (top limb signed, lower
    limbs in [0, 2^32))."""
    v = int(v)
    vals = (v >> 96, (v >> 64) & _M, (v >> 32) & _M, v & _M)
    return tuple(torch.full(shape, x, dtype=torch.int64, device=device)
                 for x in vals)


def to_python_int(lanes, i: int) -> int:
    """Exact python value of row i of host (numpy) lanes."""
    return ((int(lanes[0][i]) << 96) + (int(lanes[1][i]) << 64)
            + (int(lanes[2][i]) << 32) + int(lanes[3][i]))


# ---------------------------------------------------------------------------
# K10: int128_op
# ---------------------------------------------------------------------------

#: operations of int128_op, by their code in csrc/int128.cu
OPS = {"rescale": 0, "add": 1, "subtract": 2, "multiply": 3, "compare": 4,
       "negate": 5, "abs": 6, "to_double": 7, "to_int64": 8}
_LANES_OUT = ("rescale", "add", "subtract", "multiply", "negate", "abs")

#: error bits int128_op ORs into its error word (expr/errors.py codes)
ERR_DECIMAL = 256
ERR_CAST = 128

INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1


def _lanes(x: Operand):
    return x if isinstance(x, tuple) else from_int64(x)


def _int128_op_plain(op, x, y, x_shift, y_shift, valid, zero, scale, lo,
                     hi, row_flags):
    """Plain PyTorch version of int128_op: the JAX compiler's composition
    of the int128 functions for each operation."""
    dev = (x[0] if isinstance(x, tuple) else x).device
    n = (x[0] if isinstance(x, tuple) else x).shape[0]
    dec = torch.zeros(n, dtype=torch.bool, device=dev)
    cast = torch.zeros(n, dtype=torch.bool, device=dev)

    def wide(v, k):
        """presto_tpu/expr/compile.py:_wide_lanes."""
        nonlocal dec
        lanes = _lanes(v)
        if k > 0:
            lanes, ovf = mul_pow10(lanes, k)
            dec = dec | ovf
        elif k < 0:
            lanes = div_pow10(lanes, -k)
        return lanes

    if op == "rescale":
        out = wide(x, x_shift)
    elif op in ("add", "subtract"):
        xl, yl = wide(x, x_shift), wide(y, y_shift)
        out = add(xl, yl) if op == "add" else sub(xl, yl)
        dec = dec | exceeds_decimal38(out)
    elif op == "multiply":
        out, ovf = mul(wide(x, x_shift), wide(y, y_shift))
        dec = dec | ovf | exceeds_decimal38(out)
    elif op == "compare":
        lt, eq = compare(wide(x, x_shift), wide(y, y_shift))
        out = torch.where(lt, -1, torch.where(eq, 0, 1)).to(torch.int8)
    elif op == "negate":
        out = negate(_lanes(x))
    elif op == "abs":
        lanes = _lanes(x)
        neg = is_negative(lanes)
        out = tuple(torch.where(neg, -v, v) for v in lanes)
    elif op == "to_double":
        l3, l2, l1, l0 = _lanes(x)
        img = (l3.to(torch.float64) * float(2 ** 96)
               + l2.to(torch.float64) * float(2 ** 64)
               + l1.to(torch.float64) * float(2 ** 32)
               + l0.to(torch.float64))
        out = img / (10 ** scale)
    elif op == "to_int64":
        t3, n2, n1, n0 = normalize(wide(x, x_shift))
        out = (n1 << 32) | n0           # low 64 bits, signed image
        sign = out >> 63                # 0 or -1
        fits = (t3 == sign) & (n2 == (sign & _M))
        cast = ~fits | (out < lo) | (out > hi)
    else:
        raise ValueError(f"int128_op: unknown op {op!r}")
    if zero is not None and op in _LANES_OUT:
        out = tuple(torch.where(zero, 0, v) for v in out)
    bits = dec.to(torch.int64) * ERR_DECIMAL | cast.to(torch.int64) * ERR_CAST
    err = torch.zeros((), dtype=torch.int64, device=dev)
    if valid is not None and n:
        live = torch.where(valid, bits, 0)
        err = (live & ERR_DECIMAL).amax() | (live & ERR_CAST).amax()
    if row_flags:
        return out, err, bits.to(torch.int32)
    return out, err


class _Int128Args(ctypes.Structure):
    """Field for field the Int128Args struct of csrc/int128.cu."""
    _fields_ = [
        ("n", ctypes.c_int64),
        ("x", ctypes.c_void_p * 4),
        ("y", ctypes.c_void_p * 4),
        ("valid", ctypes.c_void_p),
        ("zero", ctypes.c_void_p),
        ("out", ctypes.c_void_p * 4),
        ("err", ctypes.c_void_p),
        ("row_err", ctypes.c_void_p),
        ("lo", ctypes.c_int64),
        ("hi", ctypes.c_int64),
        ("div", ctypes.c_double),
        ("x_pow", ctypes.c_uint64 * 2),
        ("y_pow", ctypes.c_uint64 * 2),
        ("op", ctypes.c_int32),
        ("nx", ctypes.c_int32),
        ("ny", ctypes.c_int32),
        ("x_shift", ctypes.c_int32),
        ("y_shift", ctypes.c_int32),
    ]


def _operand_tensors(v: Operand, n: int, dev, what: str):
    ts = list(v) if isinstance(v, tuple) else [v]
    if len(ts) not in (1, 4):
        raise TypeError(f"int128_op: {what} must be int64 values or four "
                        f"int64 lanes")
    for t in ts:
        if t.dtype != torch.int64 or t.shape != (n,) or t.device != dev:
            raise TypeError(f"int128_op: {what} lanes must be int64 [{n}] "
                            f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
    return [t.contiguous() for t in ts]


def int128_op(op: str, x: Operand, y: Optional[Operand] = None, *,
              x_shift: int = 0, y_shift: int = 0,
              valid: Optional[torch.Tensor] = None,
              zero: Optional[torch.Tensor] = None, scale: int = 0,
              lo: int = INT64_MIN, hi: int = INT64_MAX,
              row_flags: bool = False):
    """One elementwise 128-bit decimal operation (kernel K10,
    csrc/int128.cu).

    Operands are int64 narrow values or four int64 limb lanes, each first
    rescaled by 10^shift (a positive shift multiplies, flagging a product
    whose magnitude reaches 2^127; a negative one divides, HALF_UP).
    Operations and their result:
      rescale, add, subtract, multiply, negate, abs: four limb lanes
        (add/subtract/multiply flag a result beyond 10^38-1, multiply also
        a product past 2^127);
      compare: int8 sign of x - y;
      to_double: float64 image of x divided by 10^scale;
      to_int64: x rescaled, as int64, flagged where it lies outside
        [lo, hi] (a cast error).
    `zero` (bool) zeroes the result lanes of its rows; `valid` (bool)
    names the rows whose flags count. Returns (result, err): err is a 0-d
    int64 tensor on the device holding ERR_DECIMAL and/or ERR_CAST for
    the valid rows (0 when valid is None); with row_flags, also each
    row's flag bits (int32), whether valid or not.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel."""
    if op not in OPS:
        raise ValueError(f"int128_op: unknown op {op!r}")
    ref = x[0] if isinstance(x, tuple) else x
    n, dev = ref.shape[0], ref.device
    binary = op in ("add", "subtract", "multiply", "compare")
    if binary != (y is not None):
        raise TypeError(f"int128_op: {op} takes "
                        f"{'two operands' if binary else 'one operand'}")
    xs = _operand_tensors(x, n, dev, "x")
    ys = _operand_tensors(y, n, dev, "y") if y is not None else []
    for name, m in (("valid", valid), ("zero", zero)):
        if m is not None and (m.dtype != torch.bool or m.shape != (n,)
                              or m.device != dev):
            raise TypeError(f"int128_op: {name} must be bool [{n}] on {dev}")
    if max(abs(x_shift), abs(y_shift)) > 38 or not 0 <= scale <= 38:
        raise ValueError("int128_op: shifts and scale within 38 digits")
    if dev.type == "cpu":
        return _int128_op_plain(op, x, y, x_shift, y_shift, valid, zero,
                                scale, lo, hi, row_flags)
    if dev.type != "cuda":
        raise RuntimeError(f"int128_op: no kernel for {dev}")
    from presto_tpu_torch import native
    if op in _LANES_OUT:
        outs = [torch.empty(n, dtype=torch.int64, device=dev)
                for _ in range(4)]
    else:
        dt = {"compare": torch.int8, "to_double": torch.float64,
              "to_int64": torch.int64}[op]
        outs = [torch.empty(n, dtype=dt, device=dev)]
    err = torch.zeros((), dtype=torch.int64, device=dev)
    rows = (torch.empty(n, dtype=torch.int32, device=dev)
            if row_flags else None)
    valid = valid.contiguous() if valid is not None else None
    zero = zero.contiguous() if zero is not None else None
    a = _Int128Args()
    a.n = n
    for j, t in enumerate(xs):
        a.x[j] = t.data_ptr()
    for j, t in enumerate(ys):
        a.y[j] = t.data_ptr()
    a.valid = valid.data_ptr() if valid is not None else 0
    a.zero = zero.data_ptr() if zero is not None else 0
    for j, t in enumerate(outs):
        a.out[j] = t.data_ptr()
    a.err = err.data_ptr()
    a.row_err = rows.data_ptr() if rows is not None else 0
    a.lo, a.hi = int(lo), int(hi)
    for arr, k in ((a.x_pow, x_shift), (a.y_pow, y_shift)):
        p = 10 ** abs(k)
        arr[0], arr[1] = p & (2 ** 64 - 1), p >> 64
    a.op = OPS[op]
    a.nx, a.ny = len(xs), len(ys)
    a.x_shift, a.y_shift = x_shift, y_shift
    a.div = float(10 ** scale)
    lib = native.load("int128")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.int128_op(ctypes.byref(a), ctypes.c_void_p(stream))
    native.check(rc, f"int128_op {op}", "int128")
    int128_op.launches += 1
    out = tuple(outs) if op in _LANES_OUT else outs[0]
    if row_flags:
        return out, err, rows
    return out, err


int128_op.launches = 0
