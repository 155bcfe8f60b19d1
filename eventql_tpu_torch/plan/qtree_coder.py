"""Binary query-tree wire coder — the reference's QueryTreeCoder format.

Implements the 15 registered wire types and their exact byte layouts
(reference: sql/qtree/qtree_coder.cc:47-61; per-node encodings in each
node's encode/decode, e.g. GroupByNode.cc:153-171, SequentialScanNode
encode with constraints, CallExpressionNode lenenc name/symbol), so
shipped plan frames are reference-wire-compatible. Primitives mirror
util/BinaryMessageWriter: varuint = little-endian 7-bit groups with a
continuation bit (util/io/outputstream.cc:120-130), lenenc string =
varuint length + raw bytes, SValue = u8 type + lenenc(payload+tag)
(svalue.cc SValue::encode + sql_sizeof: fixed 8-byte LE payloads for
the 64-bit types, u32-length-prefixed bytes for STRING, one trailing
STag byte whose bit 0 is STAG_NULL — the in-memory STAG_INLINE bit is
masked off on both sides).

Wire type ids:
  1 CallExpression   2 ColumnReference  3 DescribeTable  4 GroupBy
  5 IfExpression     6 Join             7 Limit          8 Literal
  9 OrderBy         10 RegexExpression 11 SelectExpression
 12 SelectList      13 SequentialScan  14 ShowTables     15 Subquery

Deviations, documented:
  * isnull(x) has no dedicated reference node (it is a plain function
    call there); our IsNullExpressionNode encodes as wire type 1 with
    function name "isnull" and decodes back to the dedicated node.
  * our per-partition scan scoping (SequentialScanNode.keyrange)
    encodes as the reference's ScanConstraint list — one
    GREATER_THAN_OR_EQUAL_TO and/or one LESS_THAN constraint on the
    partition key column (exactly the constraints the reference's
    scheduler prunes by, server/sql/scheduler.cc:202-216) — and
    decodes back to keyrange.
  * the reference resolves the scanned table's full schema from its
    local provider at execution; the wire carries only input/output
    columns, so decode seeds table_columns from input_columns.
  * JoinType: CARTESIAN=0, INNER=1 match the reference enum
    (JoinNode.h:37); LEFT=3/RIGHT=4 are extensions (the reference
    never ships OUTER joins).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType, SValue
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    IfExpressionNode,
    IsNullExpressionNode,
    LiteralExpressionNode,
    RegexExpressionNode,
)
from eventql_tpu_torch.plan.functions import DEFAULT_REGISTRY

STAG_NULL = 1

_AGGR_WIRE = {
    qn.SequentialScanNode.NO_AGGREGATION: 0,
    qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_FLAT: 1,
    qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_DEEP: 2,
    qn.SequentialScanNode.AGGREGATE_ALL: 3,
}
_AGGR_UNWIRE = {v: k for k, v in _AGGR_WIRE.items()}

_JOIN_WIRE = {"CARTESIAN": 0, "INNER": 1, "LEFT": 3, "RIGHT": 4}
_JOIN_UNWIRE = {v: k for k, v in _JOIN_WIRE.items()}

# ScanConstraintType (SequentialScanNode.h:68-75)
_SC_GTE = 6
_SC_LT = 3


class _Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def varuint(self, v: int):
        if v < 0:
            raise RuntimeError_("varuint cannot encode negatives")
        while True:
            b = v & 0x7F
            v >>= 7
            self.buf.append(b | (0x80 if v else 0))
            if not v:
                return

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def lenenc(self, data) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8", errors="surrogateescape")
        self.varuint(len(data))
        self.buf += data


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def varuint(self) -> int:
        shift = 0
        out = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def lenenc(self) -> bytes:
        n = self.varuint()
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return bytes(out)


# -- SValue -----------------------------------------------------------------


def _encode_svalue(w: _Writer, v: SValue):
    w.u8(int(v.stype))
    tag = STAG_NULL if v.is_null else 0
    payload = v.payload()
    if v.stype == SType.NIL:
        data = bytes([tag])
    elif v.stype == SType.STRING:
        raw = payload if isinstance(payload, bytes) else (
            b"" if payload is None else str(payload).encode("utf-8")
        )
        if v.is_null:
            raw = b""
        data = struct.pack("<I", len(raw)) + raw + bytes([tag])
    elif v.stype == SType.FLOAT64:
        data = struct.pack("<d", 0.0 if v.is_null else float(payload)) + bytes(
            [tag]
        )
    elif v.stype == SType.BOOL:
        data = bytes([0 if v.is_null else int(bool(payload)), tag])
    else:  # UINT64 / INT64 / TIMESTAMP64
        p = 0 if v.is_null else int(payload)
        data = struct.pack("<Q", p & 0xFFFFFFFFFFFFFFFF) + bytes([tag])
    w.lenenc(data)


def _decode_svalue(r: _Reader) -> SValue:
    stype = SType(r.u8())
    data = r.lenenc()
    tag = data[-1] if data else 0
    is_null = bool(tag & STAG_NULL)
    if stype == SType.NIL or is_null:
        return SValue.new_null() if stype == SType.NIL else SValue(
            stype, _zero_payload(stype), True
        )
    if stype == SType.STRING:
        (n,) = struct.unpack_from("<I", data, 0)
        return SValue(stype, bytes(data[4 : 4 + n]), False)
    if stype == SType.FLOAT64:
        return SValue(stype, struct.unpack_from("<d", data, 0)[0], False)
    if stype == SType.BOOL:
        return SValue(stype, bool(data[0]), False)
    raw = struct.unpack_from("<Q", data, 0)[0]
    if stype == SType.INT64 and raw >= (1 << 63):
        raw -= 1 << 64
    return SValue(stype, raw, False)


def _zero_payload(stype: SType):
    if stype == SType.STRING:
        return b""
    if stype == SType.FLOAT64:
        return 0.0
    if stype == SType.BOOL:
        return False
    return 0


# -- encode -----------------------------------------------------------------


def _encode_node(w: _Writer, node):
    if isinstance(node, CallExpressionNode):
        if node.within_record:
            # the reference wire layout has no within_record field
            # (CallExpressionNode::encode); shipping one silently as a
            # plain call would change evaluation semantics — refuse
            # loudly (ship sites gate on NO_AGGREGATION anyway)
            raise RuntimeError_(
                "WITHIN RECORD calls are not wire-encodable"
            )
        w.varuint(1)
        w.lenenc(node.function_name)
        w.lenenc(node.sfunction.symbol)
        w.varuint(int(node.sfunction.return_type))
        w.varuint(0 if node.sfunction.aggregate else 1)  # isPure
        w.varuint(1 if node.sfunction.aggregate else 0)  # isAggregate
        w.varuint(len(node.args))
        for a in node.args:
            _encode_node(w, a)
        return
    if isinstance(node, IsNullExpressionNode):
        # reference ships isnull as a plain call (see module docstring)
        w.varuint(1)
        w.lenenc("isnull")
        w.lenenc("")
        w.varuint(int(SType.BOOL))
        w.varuint(1)
        w.varuint(0)
        w.varuint(1)
        _encode_node(w, node.arg)
        return
    if isinstance(node, ColumnReferenceNode):
        w.varuint(2)
        w.lenenc(node.column_name or "")
        w.varuint(int(node.stype))
        if node.column_index is not None:
            w.u8(1)
            w.varuint(node.column_index)
        else:
            w.u8(0)
        return
    if isinstance(node, qn.DescribeTableNode):
        w.varuint(3)
        w.lenenc(node.table_name)
        return
    if isinstance(node, qn.GroupByNode):
        w.varuint(4)
        w.varuint(len(node.select_list))
        for sl in node.select_list:
            _encode_select_list(w, sl)
        w.varuint(len(node.group_exprs))
        for g in node.group_exprs:
            _encode_node(w, g)
        _encode_node(w, node.table)
        w.u8(1 if node.is_partial else 0)
        return
    if isinstance(node, IfExpressionNode):
        w.varuint(5)
        w.varuint(int(node.rtype))
        _encode_node(w, node.cond)
        _encode_node(w, node.true_branch)
        _encode_node(w, node.false_branch)
        return
    if isinstance(node, qn.JoinNode):
        w.varuint(6)
        w.u8(_JOIN_WIRE[node.join_type])
        w.varuint(len(node.select_list))
        for sl in node.select_list:
            _encode_select_list(w, sl)
        flags = 0
        if node.where_expr is not None:
            flags |= 1  # kHasWhereExprFlag
        if node.join_cond is not None:
            flags |= 2  # kHasJoinExprFlag
        w.u8(flags)
        if node.where_expr is not None:
            _encode_node(w, node.where_expr)
        if node.join_cond is not None:
            _encode_node(w, node.join_cond)
        _encode_node(w, node.base_table)
        _encode_node(w, node.joined_table)
        return
    if isinstance(node, qn.LimitNode):
        w.varuint(7)
        w.varuint(node.limit)
        w.varuint(node.offset)
        _encode_node(w, node.table)
        return
    if isinstance(node, LiteralExpressionNode):
        w.varuint(8)
        _encode_svalue(w, node.value)
        return
    if isinstance(node, qn.OrderByNode):
        w.varuint(9)
        w.varuint(len(node.sort_specs))
        for spec in node.sort_specs:
            _encode_node(w, spec.expr)
            w.u8(1 if spec.descending else 0)
        _encode_node(w, node.table)
        return
    if isinstance(node, RegexExpressionNode):
        w.varuint(10)
        _encode_node(w, node.subject)
        w.lenenc(node.pattern)
        return
    if isinstance(node, qn.SelectExpressionNode):
        w.varuint(11)
        w.varuint(len(node.select_list))
        for sl in node.select_list:
            _encode_select_list(w, sl)
        return
    if isinstance(node, qn.SequentialScanNode):
        w.varuint(13)
        w.lenenc(node.table_name)
        w.varuint(len(node.select_list))
        for sl in node.select_list:
            _encode_select_list(w, sl)
        w.u8(_AGGR_WIRE[node.aggr_strategy])
        if node.where_expr is not None:
            w.u8(1)
            _encode_node(w, node.where_expr)
        else:
            w.u8(0)
        w.varuint(len(node.output_columns))
        for oc in node.output_columns:
            w.lenenc(oc)
        w.varuint(len(node.input_columns))
        for cname, ctype in node.input_columns:
            w.lenenc(cname)
            w.varuint(int(ctype))
        # keyrange -> ScanConstraint pair (see module docstring)
        constraints = []
        if node.keyrange is not None:
            kcol, begin, end = node.keyrange
            # "" means unbounded (operators._apply_keyrange contract);
            # truthiness would also drop a legitimate 0 boundary
            if begin != "":
                constraints.append((kcol, _SC_GTE, begin))
            if end != "":
                constraints.append((kcol, _SC_LT, end))
        w.varuint(len(constraints))
        for cname, ctype_w, val in constraints:
            w.lenenc(cname)
            w.u8(ctype_w)
            _encode_svalue(
                w,
                SValue(
                    SType.STRING,
                    val if isinstance(val, bytes) else str(val).encode(),
                    False,
                ),
            )
        return
    if isinstance(node, qn.ShowTablesNode):
        w.varuint(14)
        return
    if isinstance(node, qn.SubqueryNode):
        w.varuint(15)
        _encode_node(w, node.subquery)
        w.varuint(len(node.select_list))
        for sl in node.select_list:
            _encode_select_list(w, sl)
        if node.where_expr is not None:
            w.u8(1)
            _encode_node(w, node.where_expr)
        else:
            w.u8(0)
        return
    raise RuntimeError_(f"can't binary-encode node: {node!r}")


def _encode_select_list(w: _Writer, sl: qn.SelectListEntry):
    w.varuint(12)
    _encode_node(w, sl.expr)
    if sl.alias is not None:
        w.u8(1)
        w.lenenc(sl.alias)
    else:
        w.u8(0)


# -- decode -----------------------------------------------------------------


def _decode_select_list(r: _Reader) -> qn.SelectListEntry:
    t = r.varuint()
    if t != 12:
        raise RuntimeError_(f"expected SelectListNode(12), got {t}")
    expr = _decode_node_body(r, r_type=None)
    alias = None
    if r.u8():
        alias = r.lenenc().decode("utf-8", errors="surrogateescape")
    return qn.SelectListEntry(expr, alias)


def _decode_node_body(r: _Reader, r_type=None):
    t = r.varuint() if r_type is None else r_type
    if t == 1:
        fn_name = r.lenenc().decode()
        symbol = r.lenenc().decode()
        _rtype = r.varuint()
        _pure = r.varuint()
        _agg = r.varuint()
        nargs = r.varuint()
        args = [_decode_node_body(r) for _ in range(nargs)]
        if fn_name == "isnull" and not symbol:
            return IsNullExpressionNode(args[0])
        fn = DEFAULT_REGISTRY.by_symbol.get(symbol)
        if fn is None:
            raise RuntimeError_(f"symbol not found: {symbol}")
        return CallExpressionNode(fn_name, fn, args)
    if t == 2:
        name = r.lenenc().decode("utf-8", errors="surrogateescape")
        stype = SType(r.varuint())
        idx = r.varuint() if r.u8() else None
        return ColumnReferenceNode(name or None, stype, idx)
    if t == 3:
        return qn.DescribeTableNode(r.lenenc().decode())
    if t == 4:
        nsel = r.varuint()
        select = [_decode_select_list(r) for _ in range(nsel)]
        ngrp = r.varuint()
        groups = [_decode_node_body(r) for _ in range(ngrp)]
        table = _decode_node_body(r)
        node = qn.GroupByNode(select, groups, table)
        node.is_partial = bool(r.u8())
        return node
    if t == 5:
        rtype = SType(r.varuint())
        cond = _decode_node_body(r)
        tb = _decode_node_body(r)
        fb = _decode_node_body(r)
        return IfExpressionNode(cond, tb, fb, rtype)
    if t == 6:
        jt = _JOIN_UNWIRE[r.u8()]
        nsel = r.varuint()
        select = [_decode_select_list(r) for _ in range(nsel)]
        flags = r.u8()
        where = _decode_node_body(r) if flags & 1 else None
        cond = _decode_node_body(r) if flags & 2 else None
        base = _decode_node_body(r)
        joined = _decode_node_body(r)
        node = qn.JoinNode(jt, base, joined)
        node.select_list = select
        node.column_names = [sl.column_name() for sl in select]
        node.where_expr = where
        node.join_cond = cond
        # the wire (like the reference's) carries no input_map; a
        # decoded join is structural — executing it must re-plan, and
        # the executor refuses clearly instead of mis-binding columns
        node.input_map = None
        return node
    if t == 7:
        limit = r.varuint()
        offset = r.varuint()
        return qn.LimitNode(limit, offset, _decode_node_body(r))
    if t == 8:
        return LiteralExpressionNode(_decode_svalue(r))
    if t == 9:
        nspec = r.varuint()
        specs = []
        for _ in range(nspec):
            e = _decode_node_body(r)
            desc = bool(r.u8())
            specs.append(qn.SortSpec(e, desc))
        return qn.OrderByNode(specs, _decode_node_body(r))
    if t == 10:
        subject = _decode_node_body(r)
        pattern = r.lenenc().decode("utf-8", errors="surrogateescape")
        return RegexExpressionNode(subject, pattern)
    if t == 11:
        nsel = r.varuint()
        return qn.SelectExpressionNode(
            [_decode_select_list(r) for _ in range(nsel)]
        )
    if t == 13:
        tname = r.lenenc().decode("utf-8", errors="surrogateescape")
        nsel = r.varuint()
        select = [_decode_select_list(r) for _ in range(nsel)]
        strategy = _AGGR_UNWIRE[r.u8()]
        where = _decode_node_body(r) if r.u8() else None
        nout = r.varuint()
        out_cols = [
            r.lenenc().decode("utf-8", errors="surrogateescape")
            for _ in range(nout)
        ]
        nin = r.varuint()
        in_cols: List[Tuple[str, SType]] = []
        for _ in range(nin):
            cname = r.lenenc().decode("utf-8", errors="surrogateescape")
            in_cols.append((cname, SType(r.varuint())))
        ncon = r.varuint()
        keyrange = None
        kcol, begin, end = None, "", ""
        for _ in range(ncon):
            cname = r.lenenc().decode("utf-8", errors="surrogateescape")
            ctype_w = r.u8()
            val = _decode_svalue(r)
            sval = val.payload()
            if isinstance(sval, bytes):
                sval = sval.decode("utf-8", errors="surrogateescape")
            kcol = cname
            if ctype_w == _SC_GTE:
                begin = sval
            elif ctype_w == _SC_LT:
                end = sval
        if kcol is not None:
            keyrange = (kcol, begin, end)
        node = qn.SequentialScanNode(tname, list(in_cols))
        node.input_columns = in_cols
        node.select_list = select
        node.output_columns = out_cols
        node.where_expr = where
        node.aggr_strategy = strategy
        node.keyrange = keyrange
        return node
    if t == 14:
        return qn.ShowTablesNode()
    if t == 15:
        sub = _decode_node_body(r)
        nsel = r.varuint()
        select = [_decode_select_list(r) for _ in range(nsel)]
        where = _decode_node_body(r) if r.u8() else None
        return qn.SubqueryNode(sub, select, where)
    raise RuntimeError_(f"unknown qtree wire type: {t}")


def encode(node) -> bytes:
    w = _Writer()
    _encode_node(w, node)
    return bytes(w.buf)


def decode(data: bytes):
    return _decode_node_body(_Reader(data))
