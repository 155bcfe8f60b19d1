"""PyTorch columnar expression compiler: the device compute path.

Evaluates a ValueExpressionNode tree over whole device columns with
torch tensor ops (the counterpart of eventql_tpu/exec/jax_expr.py, and
the replacement for the reference's per-row stack VM, reference:
sql/runtime/vm.cc:107-157).

Coverage: numeric arithmetic/comparison/logic, if(), conversions,
literals, column refs, and the
null-tag semantics of SURVEY.md App. A (calls clear tags, refs
propagate). Strings participate as dictionary ids. Expressions outside
this subset make the plan ineligible for the device path and run on
the host engine instead. (jax_expr also lists date_trunc, but its
string window argument fails the string-argument gate of
expr_is_device_compatible, so no plan ever reaches it; it is not
carried over.)

Unsigned columns: torch cannot compute with its unsigned types, so a
logical UINT64 / TIMESTAMP64 column is an int64 tensor holding the same
64 bits. add/sub/mul wrap identically; order compares use the signed
order of ``x ^ (1 << 63)``; division, modulo and float conversions go
through the helpers below. A physically narrowed unsigned column
(uint16 / uint32 on the host) is the int16 / int32 tensor of the same
bits and ``_widen`` zero-extends it.

Literals and all-valid masks are 0-dim tensors that broadcast, so a
constant never costs a column of memory; ``DeviceCol.full(n)`` expands
a result to n rows where a consumer needs the column itself.

That is the PyTorch path (``compile_torch``), a pass a node. On a CUDA
device ``compile_expr`` first compiles the whole tree, once a plan, into
a program for one hand-written kernel (kernels/expr_program.py, the
section "the expression program" below), which reads each stored column
once at its stored width and writes only the result, bit for bit what
the PyTorch path gives; a tree outside its op set runs on that path.
"""

from __future__ import annotations

import collections
import struct
import threading
import weakref
from typing import List

import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.kernels import expr_program as kp
from eventql_tpu_torch.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    IfExpressionNode,
    IsNullExpressionNode,
    LiteralExpressionNode,
    ValueExpressionNode,
)
from eventql_tpu_torch.utils import trace

U = SType.UINT64
I = SType.INT64
F = SType.FLOAT64
B = SType.BOOL
S = SType.STRING
T = SType.TIMESTAMP64

_TORCH_DTYPE = {
    U: torch.int64,  # u64 bit patterns
    I: torch.int64,
    F: torch.float64,
    B: torch.bool,
    T: torch.int64,  # u64 bit patterns
    S: torch.int32,
}

_SIGN = -(1 << 63)  # int64 with only the top bit set
_TWO63 = 9223372036854775808.0


def is_unsigned(stype) -> bool:
    return stype in (U, T)


class DeviceCol:
    """A device column: (data, valid) pair of torch tensors, each either
    n rows long or 0-dim (a broadcast constant)."""

    __slots__ = ("stype", "data", "valid")

    def __init__(self, stype, data, valid):
        self.stype = stype
        self.data = data
        self.valid = valid

    def full(self, n: int) -> "DeviceCol":
        return DeviceCol(
            self.stype, self.data.expand(n), self.valid.expand(n)
        )


class UnsupportedExpression(Exception):
    """Raised at compile time when an expression has no device form;
    the plan then falls back to the host engine."""


def _widen(col: DeviceCol) -> DeviceCol:
    """Restore a physically-narrowed column (device_exec._narrow_np
    stores 64-bit columns whose values fit 32 / 16 bits as 32 / 16-bit
    arrays) to its logical dtype; unsigned payloads zero-extend."""
    want = _TORCH_DTYPE.get(col.stype)
    if want is None or col.data.dtype == want:
        return col
    data = col.data.to(want)
    if is_unsigned(col.stype) and col.data.dtype in (torch.int16, torch.int32):
        data = data & ((1 << (8 * col.data.element_size())) - 1)
    return DeviceCol(col.stype, data, col.valid)


def _fold_i64(x: int) -> int:
    return ((int(x) & 0xFFFFFFFFFFFFFFFF) ^ (1 << 63)) - (1 << 63)


def _scalar(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def _const(value, stype, device):
    if stype == S:
        raise UnsupportedExpression("string literal on device")
    payload = value.payload() if hasattr(value, "payload") else value
    if stype in (U, T, I):
        payload = _fold_i64(payload)
    data = _scalar(payload, _TORCH_DTYPE[stype], device)
    valid = _scalar(not getattr(value, "is_null", False), torch.bool, device)
    return DeviceCol(stype, data, valid)


def _all_valid(device):
    return _scalar(True, torch.bool, device)


# -- unsigned 64-bit arithmetic on int64 bit patterns -------------------------


def _ukey(x):
    """Signed key with the unsigned order of the bit pattern x."""
    return x ^ _SIGN


def _u64_to_f64(x):
    """uint64 -> float64, round to nearest even like a hardware convert."""
    half = ((x >> 1) & ~_SIGN) | (x & 1)  # logical shift, sticky low bit
    return torch.where(x >= 0, x.to(torch.float64), half.to(torch.float64) * 2.0)


def _f64_to_i64(x):
    """float64 -> int64, truncating, saturating at the type's ends and
    NaN -> 0 (what an XLA convert gives; a bare ``.to(int64)`` of an
    out-of-range value differs between the CPU and CUDA)."""
    hi = x >= _TWO63
    lo = x <= -_TWO63
    inner = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    out = inner.to(torch.int64)
    out = torch.where(hi, torch.full_like(out, ~_SIGN), out)
    return torch.where(lo, torch.full_like(out, _SIGN), out)


def _f64_to_u64(x):
    """float64 -> uint64 bit pattern, truncating, saturating to
    [0, 2^64 - 1] and NaN -> 0; exact on [0, 2^64)."""
    top = x >= 2.0 * _TWO63
    hi = (x >= _TWO63) & ~top
    pos = (x > 0) & ~top
    y = torch.where(pos, x, torch.zeros_like(x))
    low = torch.where(hi, y - _TWO63, y).to(torch.int64)
    out = torch.where(hi, low ^ _SIGN, low)
    return torch.where(top, torch.full_like(out, -1), out)


def _udivmod(a, b):
    """Unsigned 64-bit quotient and remainder of bit patterns; b != 0.
    Divisors below 2^63 use one signed division of a >> 1 and a
    correction step; larger divisors give quotient 0 or 1."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    big = b < 0  # divisor >= 2^63
    bs = torch.where(big, torch.ones_like(b), b)
    q = torch.div((a >> 1) & ~_SIGN, bs, rounding_mode="floor") << 1
    r = a - q * bs
    fix = _ukey(r) >= _ukey(bs)
    q = torch.where(fix, q + 1, q)
    r = torch.where(fix, r - bs, r)
    ge = _ukey(a) >= _ukey(b)
    q = torch.where(big, ge.to(torch.int64), q)
    r = torch.where(big, torch.where(ge, a - b, a), r)
    return q, r


def _order(a: DeviceCol, b: DeviceCol):
    """Operands under which signed compares give the logical order."""
    if is_unsigned(a.stype):
        return _ukey(a.data), _ukey(b.data)
    return a.data, b.data


_COMPARES = {
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
}
_ARITH = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
}
_NUMERIC_BINOPS = set(_COMPARES) | set(_ARITH)


def _convert(a: DeviceCol, rtype):
    """``a`` converted to the logical type ``rtype`` (astype semantics of
    the u64 / i64 / f64 / bool lattice)."""
    src, d = a.stype, a.data
    if rtype == F:
        if is_unsigned(src):
            return _u64_to_f64(d)
        return d.to(torch.float64)
    if rtype == B:
        return d.to(torch.bool)
    if rtype in (U, T, I):
        if src == F:
            return _f64_to_u64(d) if is_unsigned(rtype) else _f64_to_i64(d)
        return d.to(torch.int64)  # same bits (bool -> 0 / 1)
    raise UnsupportedExpression(f"conversion to {rtype}")


def compile_expr(
    expr: ValueExpressionNode,
    columns: List[DeviceCol],
    n: int,
    device=None,
):
    """Evaluate the expression over device columns. The result's tensors
    are n rows long or 0-dim (see DeviceCol.full).

    On a CUDA device the expression runs as one program launch where the
    program takes it (``_run_program``), else on the PyTorch path
    (``compile_torch``), which is also the CPU's path. ``columns`` is a
    list of DeviceCol, or a scan's select list over its stored input
    columns (device_exec._LazyScanCols: ``exprs`` and ``stored``), whose
    references the program reads through to the stored columns."""
    if device is None:
        device = _first_device(columns)
    out, ops = _run_program(expr, columns, n) if _takes_program(device) else (None, 0)
    trace.note("program", ops > 0, span="expr")
    trace.note("ops", ops, span="expr")
    if out is not None:
        return out
    return compile_torch(expr, columns, n, device)


def _first_device(columns):
    stored = getattr(columns, "stored", columns)
    return stored[0].data.device if len(stored) else torch.device("cpu")


def compile_torch(
    expr: ValueExpressionNode,
    columns: List[DeviceCol],
    n: int,
    device=None,
):
    """The PyTorch path: recursively evaluate the expression over device
    columns, each node its own pass."""
    if device is None:
        device = _first_device(columns)

    if isinstance(expr, LiteralExpressionNode):
        if expr.value.stype == S:
            raise UnsupportedExpression("string literal")
        return _const(expr.value, expr.value.stype, device)

    if isinstance(expr, ColumnReferenceNode):
        if expr.column_index is None:
            raise UnsupportedExpression("unresolved column ref")
        return _widen(columns[expr.column_index])

    if isinstance(expr, IsNullExpressionNode):
        arg = compile_torch(expr.arg, columns, n, device)
        return DeviceCol(B, ~arg.valid, _all_valid(device))

    if isinstance(expr, IfExpressionNode):
        c = compile_torch(expr.cond, columns, n, device)
        tv = compile_torch(expr.true_branch, columns, n, device)
        fv = compile_torch(expr.false_branch, columns, n, device)
        if tv.stype == S or fv.stype == S:
            raise UnsupportedExpression("string if-branches")
        return DeviceCol(
            tv.stype,
            torch.where(c.data, tv.data, fv.data),
            torch.where(c.data, tv.valid, fv.valid),
        )

    if isinstance(expr, CallExpressionNode):
        return _compile_call(expr, columns, n, device)

    raise UnsupportedExpression(type(expr).__name__)


def _compile_call(expr: CallExpressionNode, columns, n, device):
    fn = expr.sfunction
    name = fn.name
    rtype = fn.return_type
    ok = _all_valid(device)

    args = [compile_torch(a, columns, n, device) for a in expr.args]

    # string args: only id-based equality is device-safe
    for a in args:
        if a.stype == S and name not in ("eq", "neq", "cmp", "lt", "lte", "gt", "gte"):
            raise UnsupportedExpression(f"string arg to {name}")

    if name in _COMPARES:
        a, b = args
        x, y = (a.data, b.data) if name in ("eq", "neq") else _order(a, b)
        return DeviceCol(rtype, _COMPARES[name](x, y), ok)

    if name in _ARITH:
        a, b = args
        return DeviceCol(rtype, _ARITH[name](a.data, b.data), ok)

    if name == "div":
        a, b = args
        return DeviceCol(F, a.data / b.data, ok)

    if name == "mod":
        a, b = args
        if rtype == F:
            nan = _scalar(float("nan"), torch.float64, device)
            out = torch.where(b.data != 0, torch.fmod(a.data, b.data), nan)
        else:
            bb = torch.where(b.data == 0, torch.ones_like(b.data), b.data)
            if rtype == I:
                out = torch.fmod(a.data, bb)
            else:
                out = _udivmod(a.data, bb)[1]
        return DeviceCol(rtype, out, ok)

    if name == "pow":
        a, b = args
        out = torch.pow(_convert(a, F), _convert(b, F))
        return DeviceCol(rtype, _convert(DeviceCol(F, out, ok), rtype), ok)

    if name == "logical_and":
        a, b = args
        return DeviceCol(B, a.data & b.data, ok)
    if name == "logical_or":
        a, b = args
        return DeviceCol(B, a.data | b.data, ok)
    if name == "neg":
        (a,) = args
        if a.stype == B:
            return DeviceCol(B, ~a.data, ok)
        return DeviceCol(rtype, -_convert(a, rtype), ok)

    if name == "cmp":
        a, b = args
        x, y = _order(a, b)
        out = (x > y).to(torch.int64) - (x < y).to(torch.int64)
        return DeviceCol(I, out, ok)

    if name in ("to_int64", "to_uint64", "to_float64", "to_timestamp64",
                "to_int", "to_float", "to_timestamp", "truncate"):
        (a,) = args
        if a.stype == S:
            raise UnsupportedExpression("string cast on device")
        if name == "truncate" and a.stype == F:
            a = DeviceCol(F, torch.trunc(a.data), a.valid)
        return DeviceCol(rtype, _convert(a, rtype), ok)

    if name == "to_nil":
        return DeviceCol(
            SType.NIL,
            _scalar(0, torch.uint8, device),
            _scalar(False, torch.bool, device),
        )

    if name == "from_timestamp":
        (a,) = args
        if a.stype == F:
            out = _f64_to_u64(a.data * 1e6)
        else:
            out = a.data.to(torch.int64) * 1000000
        return DeviceCol(T, out, ok)

    raise UnsupportedExpression(name)


_DEVICE_FNS = _NUMERIC_BINOPS | {
    "div", "mod", "pow", "logical_and", "logical_or", "neg", "cmp",
    "to_int64", "to_uint64", "to_float64", "to_timestamp64", "to_int",
    "to_float", "to_timestamp", "truncate", "to_nil", "from_timestamp",
}


def expr_is_device_compatible(expr: ValueExpressionNode) -> bool:
    """Static check: can this expression run fully on device?"""
    if isinstance(expr, LiteralExpressionNode):
        return expr.value.stype != S
    if isinstance(expr, ColumnReferenceNode):
        return expr.column_index is not None
    if isinstance(expr, IsNullExpressionNode):
        return expr_is_device_compatible(expr.arg)
    if isinstance(expr, IfExpressionNode):
        return expr.rtype != S and all(
            expr_is_device_compatible(a) for a in expr.arguments()
        )
    if isinstance(expr, CallExpressionNode):
        name = expr.sfunction.name
        if name not in _DEVICE_FNS:
            return False
        if name == "mod" and expr.return_type() != SType.FLOAT64:
            # integer modulo raises "modulo by zero" per evaluated row
            # (reference: sql/expressions/math.cc:178-206); the device
            # can't raise data-dependently, so route to host unless the
            # divisor is a provably nonzero literal. Float mod is fmod
            # and permits zero (math.cc:208-212).
            div = expr.args[1] if len(expr.args) > 1 else None
            if not (
                isinstance(div, LiteralExpressionNode)
                and not div.value.is_null
                and div.value.payload() not in (0, 0.0)
            ):
                return False
        # string args only flow through comparison ops (id-preserving)
        for a in expr.args:
            if a.return_type() == S and name not in (
                "eq", "neq", "cmp", "lt", "lte", "gt", "gte",
            ):
                return False
        return all(expr_is_device_compatible(a) for a in expr.args)
    return False


# -- the expression program (CUDA devices) ------------------------------------
# One launch of kernels/expr_program.py's interpreter evaluates a whole tree:
# it reads each stored column once at its stored width and writes only the
# result, where the PyTorch path widens every reference to 8 bytes a row and
# runs a pass a node. The program reproduces the PyTorch path bit for bit on
# the subset below; any other node, dtype or shape sends the whole expression
# to that path, unchanged. The rule reads only the tree's node types and the
# stored columns' dtypes and shapes.

# expressions on a CUDA device that ran as one program launch, and those
# that went to the PyTorch path, since import
PROGRAM_LAUNCHES = 0
PROGRAM_FALLBACKS = 0

_I64, _F64, _BOOL = "i64", "f64", "bool"
_KIND_OF = {U: _I64, I: _I64, T: _I64, F: _F64, B: _BOOL}
_OUT_DTYPE = {_I64: torch.int64, _F64: torch.float64, _BOOL: torch.bool}
# a stream kind stored at a result's own dtype -> that result's kind (a
# narrowed stream, or a bool read as an integer, takes a launch)
_STORED_KIND = {"i64": _I64, "f64": _F64, "b8": _BOOL}
_MASK64 = (1 << 64) - 1
_CMP_SUFFIX = {"lt": "lt", "lte": "le", "gt": "gt", "gte": "ge", "eq": "eq", "neq": "ne"}
_CONVERSIONS = ("to_int64", "to_uint64", "to_float64", "to_timestamp64", "to_int",
                "to_float", "to_timestamp", "truncate")
# a stored column's dtype -> the kind of stream the kernel reads it as, by
# whether its logical type is unsigned
_NARROW_KIND = {
    (torch.int16, True): "u16", (torch.int16, False): "i16",
    (torch.int32, True): "u32", (torch.int32, False): "i32",
    (torch.int64, True): "i64", (torch.int64, False): "i64",
}


class _Reject(Exception):
    """The program does not take this expression: the PyTorch path runs it."""


def _takes_program(device) -> bool:
    return torch.device(device).type == "cuda"


class Program:
    """A compiled expression: ``ins`` (op name, three operands as (source,
    index), save slot, and / or / None: how the result meets the
    accumulator), ``imms`` (64-bit words), ``streams`` ((stored
    column, "data" or "valid", kernel kind) in the kernel's stream order),
    ``nslots``; the result's SQL type and dtype; ``valid`` what its
    validity is: a bool constant, ("plane", column) for a stored column's
    own plane, or "slot" for the plane the program writes (slot
    ``valid_slot``). ``identity`` names the stored column whose data the
    expression is, bit for bit and at its stored dtype (no launch: the
    PyTorch path copies nothing either); then ``ins`` is empty."""

    __slots__ = ("ins", "imms", "streams", "nslots", "stype", "dtype", "valid", "valid_slot",
                 "identity", "host")

    @property
    def ops(self) -> int:
        return len(self.ins)


def _scan_view(columns):
    """(select-list expressions or None, the stored columns)."""
    exprs = getattr(columns, "exprs", None)
    return (exprs, columns.stored) if exprs is not None else (None, columns)


class _Compiler:
    """Expression -> a DAG of tuples (equal subtrees are one node): leaves
    ("stream", column, plane, kind) and ("imm", bits), inner nodes
    (op, *children). Each value is (SQL type, kind: i64 / f64 / bool, node),
    as the PyTorch path would type its tensor."""

    def __init__(self, exprs, stored):
        self.exprs, self.stored = exprs, stored

    def data(self, e, via):
        if isinstance(e, LiteralExpressionNode):
            v = e.value
            st = v.stype
            if st not in _KIND_OF or v.is_null:
                raise _Reject("literal")
            payload = v.payload()
            if st == F:
                bits = struct.unpack("<Q", struct.pack("<d", float(payload)))[0]
            elif st == B:
                bits = int(bool(payload))
            else:
                bits = _fold_i64(payload) & _MASK64
            return st, _KIND_OF[st], ("imm", bits)
        if isinstance(e, ColumnReferenceNode):
            j = e.column_index
            if j is None:
                raise _Reject("unresolved column ref")
            if via:
                return self.data(self.exprs[j], False)
            c = self.stored[j]
            if c.stype == F and c.data.dtype == torch.float64:
                kind = "f64"
            elif c.stype == B and c.data.dtype == torch.bool:
                kind = "b8"
            elif c.stype in (U, T, I):
                kind = _NARROW_KIND.get((c.data.dtype, is_unsigned(c.stype)))
            else:
                kind = None
            if kind is None:
                raise _Reject(f"{c.stype} column stored as {c.data.dtype}")
            return c.stype, _KIND_OF[c.stype], ("stream", j, "data", kind)
        if isinstance(e, IsNullExpressionNode):
            self.data(e.arg, via)  # the PyTorch path compiles it too
            v = self.valid(e.arg, via)
            return B, _BOOL, ("imm", int(not v)) if isinstance(v, bool) else ("not", v)
        if isinstance(e, IfExpressionNode):
            c = self.data(e.cond, via)
            t = self.data(e.true_branch, via)
            f = self.data(e.false_branch, via)
            if c[1] != _BOOL or t[1] != f[1] or S in (t[0], f[0]):
                raise _Reject("if")
            return t[0], t[1], ("sel", c[2], t[2], f[2])
        if isinstance(e, CallExpressionNode):
            return self.call(e, via)
        raise _Reject(type(e).__name__)

    def call(self, e, via):
        name, rtype = e.sfunction.name, e.sfunction.return_type
        args = [self.data(a, via) for a in e.args]
        if any(a[0] == S for a in args):
            raise _Reject("string argument")
        if name in _CMP_SUFFIX:
            (sa, ka, na), (_sb, kb, nb) = args
            if ka != kb:
                raise _Reject("mixed compare")
            if ka == _F64:
                op = "f"
            elif name in ("eq", "neq"):
                op = "i"
            else:
                op = "u" if is_unsigned(sa) else "i"
            return rtype, _BOOL, (op + _CMP_SUFFIX[name], na, nb)
        if name in _ARITH:
            (_sa, ka, na), (_sb, kb, nb) = args
            if ka != kb or ka == _BOOL:
                raise _Reject("arithmetic")
            return rtype, ka, (("f" if ka == _F64 else "i") + name, na, nb)
        if name in ("logical_and", "logical_or"):
            (_sa, ka, na), (_sb, kb, nb) = args
            if ka != _BOOL or kb != _BOOL:
                raise _Reject(name)
            return B, _BOOL, (name[len("logical_"):], na, nb)
        if name == "neg":
            (a,) = args
            if a[0] == B:
                if a[1] != _BOOL:
                    raise _Reject("neg")
                return B, _BOOL, ("not", a[2])
            _st, k, nd = self.convert(a, rtype)
            if k == _BOOL:
                raise _Reject("neg")
            return rtype, k, (("f" if k == _F64 else "i") + "neg", nd)
        if name in _CONVERSIONS:
            (a,) = args
            if name == "truncate" and a[0] == F:
                a = (F, _F64, ("ftrunc", a[2]))
            return self.convert(a, rtype)
        raise _Reject(name)

    @staticmethod
    def convert(a, rtype):
        """``_convert``'s value: ``a`` as the logical type ``rtype``."""
        src, k, nd = a
        if rtype == F:
            if is_unsigned(src):
                return F, _F64, ("u2f", nd)
            return F, _F64, nd if k == _F64 else ("i2f", nd)
        if rtype in (U, T, I):
            if src == F:
                return rtype, _I64, ("f2u" if is_unsigned(rtype) else "f2i", nd)
            if k == _F64:
                raise _Reject("conversion")
            return rtype, _I64, nd  # the same bits (a bool: 0 / 1)
        raise _Reject(f"conversion to {rtype}")

    def valid(self, e, via):
        """The validity of ``e``: a bool constant or a bool node."""
        if isinstance(e, LiteralExpressionNode):
            return not e.value.is_null
        if isinstance(e, ColumnReferenceNode):
            if via:
                return self.valid(self.exprs[e.column_index], False)
            return ("stream", e.column_index, "valid", "b8")
        if isinstance(e, IfExpressionNode):
            c = self.data(e.cond, via)[2]
            t = self.valid(e.true_branch, via)
            f = self.valid(e.false_branch, via)
            if isinstance(t, bool) and isinstance(f, bool):
                return t if t == f else (c if t else ("not", c))
            t = ("imm", int(t)) if isinstance(t, bool) else t
            f = ("imm", int(f)) if isinstance(f, bool) else f
            return ("sel", c, t, f)
        return True  # calls and isnull: always valid


def _children(node):
    return () if node[0] in ("stream", "imm") else node[1:]


class _Codegen:
    """A DAG's instructions over one accumulator: an operand that is a
    leaf is read in place; of a node's children that need instructions,
    all but the last are computed first and saved to slots, the last
    stays in the accumulator; a node used more than once is saved too, and
    a slot is freed after its node's last use. An and / or whose child is
    one instruction over operands at hand folds into that instruction
    (its result ANDed / ORed into the accumulator)."""

    def __init__(self, roots):
        self.uses = collections.Counter()
        seen = set()
        todo = list(roots)
        for r in roots:
            self.uses[r] += 1
        while todo:
            node = todo.pop()
            if node in seen:
                continue
            seen.add(node)
            for c in _children(node):
                self.uses[c] += 1
                todo.append(c)
        self.left = collections.Counter(self.uses)
        self.ins, self.imms, self.streams = [], {}, {}
        self.slot_of, self.free, self.nslots = {}, [], 0
        self.acc = None

    def operand(self, node):
        if node[0] == "stream":
            return (kp.STREAM, self.streams.setdefault(node, len(self.streams)))
        if node[0] == "imm":
            return (kp.IMM, self.imms.setdefault(node[1], len(self.imms)))
        if node == self.acc:
            return (kp.ACC, 0)
        if node in self.slot_of:
            return (kp.SLOT, self.slot_of[node])
        return None

    def _slot(self, node):
        if self.free:
            slot = self.free.pop()
        else:
            slot = self.nslots
            self.nslots += 1
        self.slot_of[node] = slot
        return slot

    def _consume(self, node):
        self.left[node] -= 1
        if not self.left[node] and node in self.slot_of:
            self.free.append(self.slot_of.pop(node))

    def emit(self, op, kids, node, keep, combine=None, consumed=()):
        srcs = [self.operand(k) for k in kids]
        srcs += [(kp.NONE, 0)] * (3 - len(srcs))
        for k in (*kids, *consumed):
            self._consume(k)
        save = self._slot(node) if keep or self.left[node] > 1 else kp.NO_SLOT
        self.ins.append((op, *srcs, save, combine))
        self.acc = node

    def _folded(self, node):
        """(the child to compute first, the child whose instruction ANDs or
        ORs into it) of an and / or node, or None: the second is an op
        used once whose operands need no instruction."""
        for other, simple in (node[1:], node[:0:-1]):
            if (other != simple and simple[0] not in ("stream", "imm")
                    and self.uses[simple] == 1
                    and all(k == other or self.operand(k) not in (None, (kp.ACC, 0))
                            for k in _children(simple))):
                return other, simple
        return None

    def gen(self, node, keep):
        kids = _children(node)
        folded = self._folded(node) if node[0] in ("and", "or") else None
        if folded is not None:
            other, simple = folded
            self.result(other, False)
            self.emit(simple[0], _children(simple), node, keep, node[0], (other, simple))
            return
        todo = [k for k in dict.fromkeys(kids) if self.operand(k) is None]
        for k in todo[:-1]:
            self.gen(k, True)
        if todo and self.operand(todo[-1]) is None:
            self.gen(todo[-1], False)
        self.emit(node[0], kids, node, keep)

    def result(self, node, keep):
        """``node`` into the accumulator (and a slot where ``keep``)."""
        if self.operand(node) is None:
            self.gen(node, keep)
        elif node != self.acc or keep:
            self.emit("mov", (node,), node, keep)


def _has_stream(node) -> bool:
    return not isinstance(node, bool) and (
        node[0] == "stream" or any(_has_stream(c) for c in _children(node)))


def _build(expr, exprs, stored) -> Program:
    comp = _Compiler(exprs, stored)
    via = exprs is not None
    stype, kind, data = comp.data(expr, via)
    valid = comp.valid(expr, via)
    if not (_has_stream(data) or _has_stream(valid)):
        raise _Reject("constant")
    prog = Program()
    prog.stype, prog.dtype = stype, _OUT_DTYPE[kind]
    prog.valid, prog.valid_slot, prog.identity = valid, -1, None
    plane = not isinstance(valid, bool) and valid[0] == "stream"
    if plane:
        prog.valid = ("plane", valid[1])
    if data[0] == "stream" and _STORED_KIND.get(data[3]) == kind:
        prog.identity = data[1]
        prog.ins, prog.imms, prog.streams, prog.nslots, prog.host = [], [], [], 0, None
        return prog
    computed = not (isinstance(valid, bool) or plane)
    cg = _Codegen([valid, data] if computed else [data])
    if computed:
        # its slot outlives the program: its use as a root is never consumed
        cg.result(valid, True)
        prog.valid, prog.valid_slot = "slot", cg.slot_of[valid]
    cg.result(data, False)
    prog.ins = cg.ins
    prog.imms = list(cg.imms)
    prog.streams = [(nd[1], nd[2], nd[3]) for nd in cg.streams]
    prog.nslots = cg.nslots
    if not prog.streams:
        raise _Reject("constant")
    if (len(prog.ins) > kp.MAX_INS or len(prog.imms) > kp.MAX_IMMS
            or len(prog.streams) > kp.MAX_STREAMS or prog.nslots > kp.MAX_SLOTS):
        raise _Reject("program too long")
    host = kp.HostProgram()
    for i, bits in enumerate(prog.imms):
        host.imm[i] = bits
    for i, (op, (ak, a), (bk, b), (ck, c), save, combine) in enumerate(prog.ins):
        code = kp.OP[op] | kp.COMBINE[combine] << kp.COMBINE_SHIFT
        host.ins[i] = kp.Ins(code, ak, a, bk, b, ck, c, save)
    for i, (_j, _plane, skind) in enumerate(prog.streams):
        host.kind[i] = kp.KIND[skind]
    host.nstreams, host.nins, host.nslots = len(prog.streams), len(prog.ins), prog.nslots
    host.valid_slot, host.out_bool = prog.valid_slot, int(kind == _BOOL)
    prog.host = host
    return prog


# expression node -> {signature of the columns: Program, or None where the
# PyTorch path runs it}; a plan's nodes live as long as the plan (PlanCache),
# which concurrent queries share
_PROGRAMS = weakref.WeakKeyDictionary()
# (device, value) -> a 0-dim bool constant
_CONST_VALID = {}
_CACHE_LOCK = threading.Lock()


def program_for(expr, columns):
    """The expression's program over ``columns`` (built once for each
    expression and signature of the stored columns), or None."""
    exprs, stored = _scan_view(columns)
    sig = (exprs is not None, *((c.stype, c.data.dtype) for c in stored))
    with _CACHE_LOCK:
        cache = _PROGRAMS.get(expr)
        if cache is None:
            cache = _PROGRAMS[expr] = {}
        if sig not in cache:
            try:
                cache[sig] = _build(expr, exprs, stored)
            except _Reject:
                cache[sig] = None
        return cache[sig]


def _const_valid(value: bool, device):
    """A 0-dim bool constant on ``device``, made once (no copy a launch)."""
    key = (str(device), value)
    with _CACHE_LOCK:
        t = _CONST_VALID.get(key)
        if t is None:
            t = _CONST_VALID[key] = torch.full((), value, dtype=torch.bool, device=device)
        return t


def _bind(prog, stored, n):
    """The tensors of the program's streams, or None where one is not a
    contiguous n-row stream on the first one's device."""
    out = []
    for j, plane, _kind in prog.streams:
        t = stored[j].data if plane == "data" else stored[j].valid
        if (t.dim() != 1 or t.shape[0] != n or not t.is_contiguous()
                or (plane == "valid" and t.dtype != torch.bool)
                or (out and t.device != out[0].device)):
            return None
        out.append(t)
    return out


def _run_program(expr, columns, n):
    """(the expression as one program launch, its instruction count), or
    (None, 0) where the program does not take it (counted as a fallback).
    An expression whose data is a stored column as it is stored returns
    that column's tensor, with no launch and no count, as the PyTorch path
    does."""
    global PROGRAM_LAUNCHES, PROGRAM_FALLBACKS
    prog = program_for(expr, columns)
    _exprs, stored = _scan_view(columns)
    if prog is not None and prog.identity is not None:
        out = stored[prog.identity].data
        device, streams = out.device, ()
    else:
        streams = None if prog is None else _bind(prog, stored, n)
        if streams is None:
            PROGRAM_FALLBACKS += 1
            return None, 0
        device = streams[0].device
        out = torch.empty(n, dtype=prog.dtype, device=device)
    valid = prog.valid
    if valid == "slot":
        valid = torch.empty(n, dtype=torch.bool, device=device)
    elif isinstance(valid, bool):
        valid = _const_valid(valid, device)
    else:
        valid = stored[valid[1]].valid
    if n and streams:
        kp.launch(prog.host, streams, n, out, valid if prog.valid == "slot" else None)
        PROGRAM_LAUNCHES += 1
    return DeviceCol(prog.stype, out, valid), prog.ops
