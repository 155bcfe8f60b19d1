"""Query-plan wire serialization.

The reference ships serialized query subtrees to partition servers
(reference: sql/qtree/qtree_coder.{h,cc} — 15 registered wire types;
GroupByNode encoding GroupByNode.cc:153-171). This coder serializes
the distributable subset (SequentialScan + partial GroupBy and their
expressions) as JSON for the QUERY_PARTIALAGGR / QUERY_REMOTE ops.
"""

from __future__ import annotations

import json

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
    ValueExpressionNode,
)
from eventql_tpu_torch.plan.functions import DEFAULT_REGISTRY


# -- expressions ------------------------------------------------------------


def encode_expr(e: ValueExpressionNode) -> dict:
    if isinstance(e, LiteralExpressionNode):
        v = e.value
        payload = v.payload()
        if isinstance(payload, bytes):
            payload = payload.decode("utf-8", errors="surrogateescape")
        return {
            "t": "literal",
            "stype": int(v.stype),
            "null": v.is_null,
            "v": payload,
        }
    if isinstance(e, ColumnReferenceNode):
        return {
            "t": "colref",
            "name": e.column_name,
            "stype": int(e.stype),
            "idx": e.column_index,
        }
    if isinstance(e, CallExpressionNode):
        return {
            "t": "call",
            "fn": e.function_name,
            "symbol": e.sfunction.symbol,
            "args": [encode_expr(a) for a in e.args],
            "within": e.within_record,
        }
    if isinstance(e, IfExpressionNode):
        return {
            "t": "if",
            "args": [
                encode_expr(e.cond),
                encode_expr(e.true_branch),
                encode_expr(e.false_branch),
            ],
            "rtype": int(e.rtype),
        }
    if isinstance(e, IsNullExpressionNode):
        return {"t": "isnull", "arg": encode_expr(e.arg)}
    if isinstance(e, RegexExpressionNode):
        return {
            "t": "regex",
            "subject": encode_expr(e.subject),
            "pattern": e.pattern,
        }
    raise RuntimeError_(f"can't encode expression: {e!r}")


def decode_expr(d: dict) -> ValueExpressionNode:
    t = d["t"]
    if t == "literal":
        stype = SType(d["stype"])
        if d["null"]:
            return LiteralExpressionNode(SValue.new_null())
        v = d["v"]
        if stype == SType.STRING and isinstance(v, str):
            v = v.encode("utf-8", errors="surrogateescape")
        return LiteralExpressionNode(SValue(stype, v, False))
    if t == "colref":
        return ColumnReferenceNode(d["name"], SType(d["stype"]), d["idx"])
    if t == "call":
        fn = DEFAULT_REGISTRY.by_symbol.get(d["symbol"])
        if fn is None:
            raise RuntimeError_(f"symbol not found: {d['symbol']}")
        return CallExpressionNode(
            d["fn"],
            fn,
            [decode_expr(a) for a in d["args"]],
            d.get("within", False),
        )
    if t == "if":
        args = [decode_expr(a) for a in d["args"]]
        return IfExpressionNode(args[0], args[1], args[2], SType(d["rtype"]))
    if t == "isnull":
        return IsNullExpressionNode(decode_expr(d["arg"]))
    if t == "regex":
        return RegexExpressionNode(decode_expr(d["subject"]), d["pattern"])
    raise RuntimeError_(f"unknown expression wire type: {t}")


# -- plan nodes -------------------------------------------------------------


def encode_scan(node: qn.SequentialScanNode) -> dict:
    return {
        "t": "seqscan",
        "table": node.table_name,
        "alias": node.table_alias,
        "table_columns": [[n, int(t)] for n, t in node.table_columns],
        "input_columns": [[n, int(t)] for n, t in node.input_columns],
        "select": [
            {"expr": encode_expr(sl.expr), "alias": sl.alias}
            for sl in node.select_list
        ],
        "output_columns": node.output_columns,
        "where": encode_expr(node.where_expr) if node.where_expr else None,
        "strategy": node.aggr_strategy,
        "keyrange": list(node.keyrange) if node.keyrange else None,
    }


def decode_scan(d: dict) -> qn.SequentialScanNode:
    node = qn.SequentialScanNode(
        d["table"], [(n, SType(t)) for n, t in d["table_columns"]]
    )
    node.table_alias = d["alias"]
    node.input_columns = [(n, SType(t)) for n, t in d["input_columns"]]
    node.select_list = [
        qn.SelectListEntry(decode_expr(s["expr"]), s["alias"])
        for s in d["select"]
    ]
    node.output_columns = list(d["output_columns"])
    node.where_expr = decode_expr(d["where"]) if d["where"] else None
    node.aggr_strategy = d["strategy"]
    kr = d.get("keyrange")
    node.keyrange = tuple(kr) if kr else None
    return node


def encode_group_by(node: qn.GroupByNode) -> dict:
    if not isinstance(node.table, qn.SequentialScanNode):
        raise RuntimeError_("only GroupBy(seqscan) subtrees are shippable")
    return {
        "t": "groupby",
        "select": [
            {"expr": encode_expr(sl.expr), "alias": sl.alias}
            for sl in node.select_list
        ],
        "group": [encode_expr(g) for g in node.group_exprs],
        "table": encode_scan(node.table),
        "partial": node.is_partial,
    }


def decode_group_by(d: dict) -> qn.GroupByNode:
    node = qn.GroupByNode(
        [
            qn.SelectListEntry(decode_expr(s["expr"]), s["alias"])
            for s in d["select"]
        ],
        [decode_expr(g) for g in d["group"]],
        decode_scan(d["table"]),
    )
    node.is_partial = d.get("partial", False)
    return node


def encode_order_by(node: qn.OrderByNode) -> dict:
    return {
        "t": "orderby",
        "sort": [
            {"expr": encode_expr(sp.expr), "desc": sp.descending}
            for sp in node.sort_specs
        ],
        "table": encode_tree(node.table),
    }


def decode_order_by(d: dict) -> qn.OrderByNode:
    return qn.OrderByNode(
        [
            qn.SortSpec(decode_expr(sp["expr"]), sp["desc"])
            for sp in d["sort"]
        ],
        decode_tree(d["table"]),
    )


def encode_limit(node: qn.LimitNode) -> dict:
    return {
        "t": "limit",
        "limit": node.limit,
        "offset": node.offset,
        "table": encode_tree(node.table),
    }


def decode_limit(d: dict) -> qn.LimitNode:
    return qn.LimitNode(d["limit"], d["offset"], decode_tree(d["table"]))


def encode_tree(node) -> dict:
    if isinstance(node, qn.GroupByNode):
        return encode_group_by(node)
    if isinstance(node, qn.SequentialScanNode):
        return encode_scan(node)
    if isinstance(node, qn.OrderByNode):
        return encode_order_by(node)
    if isinstance(node, qn.LimitNode):
        return encode_limit(node)
    raise RuntimeError_(f"plan node not shippable: {node!r}")


def decode_tree(d: dict):
    t = d["t"]
    if t == "groupby":
        return decode_group_by(d)
    if t == "seqscan":
        return decode_scan(d)
    if t == "orderby":
        return decode_order_by(d)
    if t == "limit":
        return decode_limit(d)
    raise RuntimeError_(f"unknown plan wire type: {t}")


def encode_plan(node, binary: bool = True) -> bytes:
    """Serialize a shippable plan subtree. Default wire format is the
    reference's binary QueryTreeCoder (plan/qtree_coder.py — the 15
    registered wire types, reference qtree_coder.cc:47-61); JSON stays
    available as the debug encoding (binary=False)."""
    if binary:
        from eventql_tpu_torch.plan import qtree_coder

        return qtree_coder.encode(node)
    return json.dumps(encode_tree(node)).encode("utf-8")


def decode_plan(data):
    """Deserialize a shipped plan. The encoding self-describes: JSON
    documents open with '{' (0x7b); binary trees open with a varuint
    wire type id in [1, 15]."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    if data[:1] == b"{":
        return decode_tree(json.loads(data.decode("utf-8")))
    from eventql_tpu_torch.plan import qtree_coder

    return qtree_coder.decode(data)
