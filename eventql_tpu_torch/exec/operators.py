"""Relational operator execution over columnar Relations.

Whole-column re-design of the reference's pull-based operator tree
(reference: sql/table_expression.h, sql/statements/select/*.cc): each
plan node evaluates to a full Relation; expressions run vectorized
(exec.vector_eval); aggregation is a segment reduction; sorting is an
argsort. Semantics are bit-identical to the reference's row-at-a-time
loops (see SURVEY.md Appendix A).

This is the port's own copy of the host engine. It is the semantic
reference of the CUDA routes (exec/device_exec.py: GROUP BY, fact-dim
JOIN + GROUP BY, ORDER BY, ORDER BY ... LIMIT; exec/mesh_exec.py: the
same over a table sharded on a mesh) and serves every plan the routes
decline. A partitioned provider (parallel/partitioned.py) merges host
partials per partition, the query cache (exec/query_cache.py) answers a
repeated GROUP BY over an immutable table file before any route, and
nested or WITHIN RECORD scans go through columnar/nested_scan.py. A
cluster provider (parallel/cluster.py) ships a GROUP BY's partial plan
and an ORDER BY ... LIMIT to its worker servers before any other route,
and pulls the rows of every other plan from them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType, SValue
from eventql_tpu_torch.exec.relation import Column, Relation, dtype_for
from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector, _zero_invalid
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    IfExpressionNode,
    IsNullExpressionNode,
    LiteralExpressionNode,
    RegexExpressionNode,
    ValueExpressionNode,
    has_aggregate_call,
)
from eventql_tpu_torch.utils import trace


def execute_node(node: qn.QueryTreeNode, txn) -> Relation:
    sink = getattr(txn, "trace", None)
    if not trace.ON and sink is None:
        return _execute_node_inner(node, txn)
    # an op.<PlanNode> span of the transaction's query, with its rows out;
    # a traced transaction's own stage where no query.execute is open
    # (chart rendering, the native server's streamed plans)
    name = "op." + type(node).__name__
    with trace.stage(name, getattr(txn, "query_id", None), sink) as sp:
        rel = _execute_node_inner(node, txn)
        sp.set("rows", getattr(rel, "num_rows", 0))
    return rel


def _execute_node_inner(node: qn.QueryTreeNode, txn) -> Relation:
    if isinstance(node, qn.SequentialScanNode):
        return _exec_seqscan(node, txn)
    if isinstance(node, qn.SelectExpressionNode):
        return _exec_select_expression(node, txn)
    if isinstance(node, qn.SubqueryNode):
        return _exec_subquery(node, txn)
    if isinstance(node, qn.GroupByNode):
        return _exec_group_by(node, txn)
    if isinstance(node, qn.HavingNode):
        return _exec_having(node, txn)
    if isinstance(node, qn.OrderByNode):
        return _exec_order_by(node, txn)
    if isinstance(node, qn.LimitNode):
        return _exec_limit(node, txn)
    if isinstance(node, qn.JoinNode):
        return _exec_join(node, txn)
    if isinstance(node, qn.ShowTablesNode):
        return _exec_show_tables(node, txn)
    if isinstance(node, qn.DescribeTableNode):
        return _exec_describe_table(node, txn)
    if isinstance(node, qn.DescribePartitionsNode):
        return _exec_describe_partitions(node, txn)
    if isinstance(node, qn.ClusterShowServersNode):
        return _exec_cluster_show_servers(node, txn)
    if isinstance(node, qn.ChartNode):
        return _exec_chart(node, txn)
    if isinstance(node, qn.DDLNode):
        return _exec_ddl(node, txn)
    raise RuntimeError_(f"can't execute plan node: {node!r}")


def _exec_ddl(node, txn) -> Relation:
    """DDL/DML against the transaction's table service (reference:
    scheduler.cc:395-538; providers without DDL support raise like the
    base TableProvider)."""
    from eventql_tpu_torch.plan.scalar_eval import evaluate_scalar
    from eventql_tpu_torch.plan.exprs import is_constant

    svc = txn.tables

    def need(method):
        fn = getattr(svc, method, None)
        if fn is None:
            raise RuntimeError_("tables can't be modified in this context")
        return fn

    if isinstance(node, qn.CreateTableNode):
        need("create_table")(node)
    elif isinstance(node, qn.DropTableNode):
        need("drop_table")(node.table_name)
    elif isinstance(node, qn.CreateDatabaseNode):
        need("create_database")(node.database_name)
    elif isinstance(node, qn.UseDatabaseNode):
        pass  # single-namespace runtime
    elif isinstance(node, qn.AlterTableNode):
        need("alter_table")(node)
    elif isinstance(node, qn.InsertIntoNode):
        ctx = getattr(txn, "exec_ctx", None)

        def _count_insert(outcome):
            # counted AFTER the insert: errors raise past this, and a
            # stale upsert dropped at write time (insert_row → False,
            # partition_writer record_flags_skip) modified nothing
            if ctx is not None and outcome is not False:
                ctx.count_modified(1)

        if node.json_data is not None:
            _count_insert(
                need("insert_json")(node.table_name, node.json_data)
            )
        else:
            values = []
            for e in node.value_exprs:
                if not is_constant(e):
                    raise RuntimeError_(
                        "insert into expression must contain only constant"
                        " expressions"
                    )
                values.append(evaluate_scalar(e))
            columns = node.columns
            if not columns:
                info = svc.describe(node.table_name)
                if info is None:
                    raise RuntimeError_(
                        f"table not found: '{node.table_name}'"
                    )
                columns = [c[0] for c in info.columns][: len(values)]
            _count_insert(need("insert")(node.table_name, columns, values))
    else:
        raise RuntimeError_(f"can't execute plan node: {node!r}")
    return Relation([], [], 0)


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------


def _exec_seqscan(node: qn.SequentialScanNode, txn) -> Relation:
    # nested/repeated columns and WITHIN RECORD aggregation go through
    # the Dremel row-assembly path (columnar.nested_scan); flat scans
    # use the vectorized column engine below.
    reader = getattr(txn.tables, "get_reader", lambda n: None)(node.table_name)
    if _needs_nested_scan(node, reader):
        from eventql_tpu_torch.columnar.nested_scan import execute_nested_scan

        out = execute_nested_scan(node, reader)
        _count_scan(txn, reader.num_rows, 0)
        return out

    table = txn.get_table_data(node.table_name)  # Relation of ALL table cols
    return _exec_seqscan_relation(node, table)


def _needs_nested_scan(node: qn.SequentialScanNode, reader) -> bool:
    """WITHIN RECORD aggregation, or an input column below a repetition,
    on a table with a nested reader."""
    if reader is None:
        return False
    if node.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return True
    for cname, _ctype in node.input_columns:
        cfg = reader.column_config(cname)
        if cfg is not None and cfg.rlevel_max > 0:
            return True
    return False


def _on_device(node, txn) -> bool:
    """The CUDA routes may serve ``node``: the transaction has a device,
    and no scan beneath the node needs the Dremel row assembly. The
    routes read a table's flat relation, where a leaf under a repeated
    record holds one value a record, so such plans go to the host engine
    (the JAX package's device routes do not check this)."""
    if getattr(txn, "device", None) is None:
        return False
    get_reader = getattr(txn.tables, "get_reader", None)
    if get_reader is None:
        return True
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, qn.SequentialScanNode):
            if _needs_nested_scan(n, get_reader(n.table_name)):
                return False
            continue
        for attr in ("table", "base_table", "joined_table", "subquery"):
            child = getattr(n, attr, None)
            if isinstance(child, qn.QueryTreeNode):
                stack.append(child)
    return True


def _scan_bytes(node: qn.SequentialScanNode, table: Relation) -> int:
    """Bytes the scan reads: the input columns' physical buffers."""
    by_name = dict(zip(table.names, table.columns))
    total = 0
    for cname, _ctype in node.input_columns:
        c = by_name.get(cname)
        if c is not None:
            total += c.data.nbytes + c.valid.nbytes
    return total


def _count_scan(txn, rows: int, nbytes: int):
    ctx = getattr(txn, "exec_ctx", None)
    if ctx is not None:
        ctx.count_scan(rows, nbytes)


def _exec_seqscan_relation(node: qn.SequentialScanNode, table: Relation) -> Relation:
    # partition scoping: keep only rows inside the assigned keyrange
    # (reference: partition cursors bound the scan by keyrange)
    if node.keyrange is not None:
        table = _apply_keyrange(table, node.keyrange)

    # project the scan's input columns by name
    input_cols: List[Column] = []
    name_to_col = dict(zip(table.names, table.columns))
    for cname, _ctype in node.input_columns:
        if cname not in name_to_col:
            raise RuntimeError_(f"column(s) not found: '{cname}'")
        input_cols.append(name_to_col[cname])

    n = table.num_rows
    mask = None
    if node.where_expr is not None:
        ctx = EvalContext(input_cols, n)
        cond = evaluate_vector(node.where_expr, ctx)
        mask = cond.data.astype(bool)

    ctx = EvalContext(input_cols, n, mask)
    out_cols = [evaluate_vector(sl.expr, ctx) for sl in node.select_list]
    names = [sl.column_name() for sl in node.select_list]
    rel = Relation(names, out_cols, n)
    if mask is not None:
        rel = rel.gather(np.nonzero(mask)[0])
    return rel


def _apply_keyrange(table: Relation, keyrange) -> Relation:
    col_name, begin, end = keyrange
    name_to_col = dict(zip(table.names, table.columns))
    if col_name not in name_to_col:
        raise RuntimeError_(f"column(s) not found: '{col_name}'")
    col = name_to_col[col_name]
    keep = np.ones(table.num_rows, dtype=bool)
    if col.stype == SType.STRING:
        vals = col.dictionary[col.data].astype(object)
        if begin != "":
            keep &= vals >= str(begin).encode()
        if end != "":
            keep &= vals < str(end).encode()
    else:
        if begin != "":
            keep &= col.data >= np.uint64(int(begin)).astype(col.data.dtype)
        if end != "":
            keep &= col.data < np.uint64(int(end)).astype(col.data.dtype)
    if keep.all():
        return table
    return table.gather(np.nonzero(keep)[0])


def _exec_select_expression(node: qn.SelectExpressionNode, txn) -> Relation:
    # one output row of constant expressions
    # (reference: sql/statements/select/select.cc)
    ctx = EvalContext([], 1)
    cols = [evaluate_vector(sl.expr, ctx) for sl in node.select_list]
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, cols, 1)


def _exec_subquery(node: qn.SubqueryNode, txn) -> Relation:
    child = execute_node(node.subquery, txn)
    n = child.num_rows
    mask = None
    if node.where_expr is not None:
        ctx = EvalContext(child.columns, n)
        cond = evaluate_vector(node.where_expr, ctx)
        mask = cond.data.astype(bool)
    ctx = EvalContext(child.columns, n, mask)
    cols = [evaluate_vector(sl.expr, ctx) for sl in node.select_list]
    names = [sl.column_name() for sl in node.select_list]
    rel = Relation(names, cols, n)
    if mask is not None:
        rel = rel.gather(np.nonzero(mask)[0])
    return rel


# ---------------------------------------------------------------------------
# group by
# ---------------------------------------------------------------------------


def _group_key_matrix(cols: List[Column], n: int) -> np.ndarray:
    """Build an (n, 2k) uint64 key matrix: per key column its bit
    pattern and its null tag (NULL and 0 group separately, reference:
    groupby.cc:129-135 hashes the packed (value, tag) tuple)."""
    parts = []
    for c in cols:
        if c.stype == SType.STRING:
            # dictionary ids are equality-preserving within one column
            bits = c.data.astype(np.uint64)
        elif c.stype == SType.NIL:
            bits = np.zeros(n, dtype=np.uint64)
        else:
            bits = c.data.view(np.uint64) if c.data.dtype.itemsize == 8 else c.data.astype(np.uint64)
        parts.append(np.where(c.valid, bits, 0).astype(np.uint64))
        parts.append((~c.valid).astype(np.uint64))
    if not parts:
        return np.zeros((n, 1), dtype=np.uint64)
    return np.stack(parts, axis=1)


def _factorize_rows(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return (group_ids, first_occurrence_indices) with groups numbered
    in first-occurrence order.

    Successive column-wise factorization: each pass is a scalar-dtype
    `np.unique` (one machine-word sort), combining the running group id
    with the next column's code as gid*K + code. Both factors stay < n,
    so the product never overflows u64. ~10× over `np.unique(axis=0)`,
    whose void-row comparator sort dominated the host GROUP BY."""
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    variable = [
        keys[:, j]
        for j in range(keys.shape[1])
        if keys[:, j].min() != keys[:, j].max()
    ]
    if not variable:  # every key column constant: one group
        return np.zeros(n, dtype=np.int64), np.zeros(1, dtype=np.int64)
    combined = variable[0]
    for col in variable[1:]:
        _, prev = np.unique(combined, return_inverse=True)
        _, inv = np.unique(col, return_inverse=True)
        prev = prev.reshape(-1).astype(np.uint64)
        inv = inv.reshape(-1).astype(np.uint64)
        combined = prev * np.uint64(int(inv.max()) + 1) + inv
    # first-occurrence indices (stable sort → run starts are firsts)
    _, first_idx, inverse = np.unique(
        combined, return_index=True, return_inverse=True
    )
    inverse = inverse.reshape(-1)
    # renumber so group ids follow first-occurrence order
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    gids = remap[inverse]
    firsts = first_idx[order]
    return gids.astype(np.int64), firsts.astype(np.int64)


@dataclass
class _AggInstance:
    call: CallExpressionNode
    placeholder_idx: int


def _strip_aggregates(
    expr: ValueExpressionNode, out: List[CallExpressionNode]
) -> ValueExpressionNode:
    """Replace aggregate calls with placeholder column refs; collect the
    aggregate calls. Mirrors the compiler's split into method_call /
    method_accumulate entry points (reference: sql/runtime/compiler.cc)."""
    if isinstance(expr, CallExpressionNode) and expr.is_aggregate():
        idx = len(out)
        out.append(expr)
        return ColumnReferenceNode(None, expr.return_type(), idx)
    if isinstance(expr, CallExpressionNode):
        new_args = [_strip_aggregates(a, out) for a in expr.args]
        return CallExpressionNode(
            expr.function_name, expr.sfunction, new_args, expr.within_record
        )
    if isinstance(expr, IfExpressionNode):
        return IfExpressionNode(
            _strip_aggregates(expr.cond, out),
            _strip_aggregates(expr.true_branch, out),
            _strip_aggregates(expr.false_branch, out),
            expr.rtype,
        )
    if isinstance(expr, IsNullExpressionNode):
        return IsNullExpressionNode(_strip_aggregates(expr.arg, out))
    if isinstance(expr, RegexExpressionNode):
        return RegexExpressionNode(
            _strip_aggregates(expr.subject, out), expr.pattern
        )
    return expr


def _count_presence_mask(subject, ctx) -> "Optional[np.ndarray]":
    """Occurrence mask for count(subject): None = every row counts.

    The reference's count_acc increments unconditionally per
    accumulated row (aggregate.cc:35-38); what varies is WHICH rows
    accumulate — on flat scans every row, on nested Dremel scans one
    per occurrence of the expression's repetition group
    (CSTableScan.cc:441-452). Flat columns carry presence=None; nested
    row expansion marks occurrences in Column.presence. NULL-ness does
    NOT gate counting."""
    if subject is None:
        return None
    mask = None
    stack = [subject]
    while stack:
        e = stack.pop()
        if (
            isinstance(e, ColumnReferenceNode)
            and e.column_index is not None
            and e.column_index < len(ctx.columns)
        ):
            p = ctx.columns[e.column_index].presence
            if p is not None:
                mask = p if mask is None else (mask & p)
        stack.extend(e.arguments())
    return mask


def _count_subject(call: CallExpressionNode):
    """For count(expr): the un-converted argument expression whose
    nullness is counted, or None when the argument is constant (count
    then counts rows, e.g. count(1), count(*))."""
    from eventql_tpu_torch.plan.exprs import is_constant

    if not call.args:
        return None
    arg = call.args[0]
    # unwrap the planner's to_nil conversion (which strips null tags)
    if isinstance(arg, CallExpressionNode) and arg.function_name == "to_nil":
        arg = arg.args[0]
    if is_constant(arg):
        return None
    return arg


def _segment_aggregate(
    call: CallExpressionNode,
    ctx: EvalContext,
    gids: np.ndarray,
    n_groups: int,
) -> Column:
    """Vectorized accumulate+finalize of one aggregate call per group
    (reference vtable contract: sql/runtime/vm.h:68-82)."""
    spec = call.sfunction.aggregate
    kind = spec.kind
    rtype = call.sfunction.return_type

    if kind == "count":
        # count(expr) counts one per occurrence of expr's repetition
        # group — every row on flat scans (count_acc is unconditional,
        # aggregate.cc:35-38, NULLs included), one per Dremel occurrence
        # on nested scans (rep-level gating, CSTableScan.cc:441-452;
        # 704 of the 773-row expansion in Runtime_test.cc:193-210).
        pm = _count_presence_mask(_count_subject(call), ctx)
        if pm is None:
            data = np.bincount(gids, minlength=n_groups).astype(np.uint64)
        else:
            data = np.bincount(
                gids, weights=pm.astype(np.float64), minlength=n_groups
            ).astype(np.uint64)
        return Column(SType.UINT64, data, np.ones(n_groups, bool))

    arg = evaluate_vector(call.args[0], ctx)
    vals = arg.data  # zeroed-null payloads

    if kind == "count_distinct":
        pairs = np.stack([gids.astype(np.uint64), vals.astype(np.uint64)], axis=1)
        uniq = np.unique(pairs, axis=0)
        data = np.bincount(
            uniq[:, 0].astype(np.int64), minlength=n_groups
        ).astype(np.uint64)
        return Column(SType.UINT64, data, np.ones(n_groups, bool))

    dt = dtype_for(rtype)
    if kind == "sum":
        out = np.zeros(n_groups, dtype=dt)
        np.add.at(out, gids, vals.astype(dt))
        return Column(rtype, out, np.ones(n_groups, bool))

    if kind == "mean":
        sums = np.zeros(n_groups, dtype=np.float64)
        np.add.at(sums, gids, vals.astype(np.float64))
        counts = np.bincount(gids, minlength=n_groups)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = sums / counts
        return Column(SType.FLOAT64, out, np.ones(n_groups, bool))

    if kind in ("min", "max"):
        if np.issubdtype(dt, np.floating):
            init = np.inf if kind == "min" else -np.inf
        else:
            info = np.iinfo(dt)
            init = info.max if kind == "min" else info.min
        out = np.full(n_groups, init, dtype=dt)
        ufunc = np.minimum if kind == "min" else np.maximum
        ufunc.at(out, gids, vals.astype(dt))
        return Column(rtype, out, np.ones(n_groups, bool))

    raise RuntimeError_(f"unknown aggregate kind: {kind}")


# ---------------------------------------------------------------------------
# partial aggregation + merge (the GroupByMerge pipeline; reference:
# sql/statements/select/groupby.cc:231-714)
# ---------------------------------------------------------------------------


@dataclass
class GroupByPartial:
    """One shard's partial aggregation: group keys + per-entry state
    columns — the columnar analog of the reference's (sha1 key,
    serialized accumulator states) rows (groupby.cc:438-472)."""

    key_cols: List[Column]
    n_groups: int
    # per select entry: ("first", Column) or
    # ("agg", emit_expr, [(kind, state_cols...)], agg_calls)
    entries: List


def _exec_group_by_local(node: qn.GroupByNode, table: Relation) -> GroupByPartial:
    """Partial aggregation of one shard (PartialGroupByExpression)."""
    child = _exec_seqscan_relation(node.table, table)
    n = child.num_rows
    ctx = EvalContext(child.columns, n)

    key_cols_full = [evaluate_vector(e, ctx) for e in node.group_exprs]
    keys = _group_key_matrix(key_cols_full, n)
    gids, firsts = _factorize_rows(keys)
    n_groups = len(firsts)

    key_cols = [k.gather(firsts) for k in key_cols_full]

    entries = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            agg_calls: List[CallExpressionNode] = []
            emit_expr = _strip_aggregates(sl.expr, agg_calls)
            states = []
            for call in agg_calls:
                kind = call.sfunction.aggregate.kind
                if kind == "mean":
                    # decompose into mergeable (sum, count)
                    s = _segment_aggregate_kind(
                        "sum", call, ctx, gids, n_groups, SType.FLOAT64
                    )
                    c = _segment_aggregate_kind(
                        "count_rows", call, ctx, gids, n_groups, SType.UINT64
                    )
                    states.append(("mean", [s, c]))
                elif kind == "count_distinct":
                    arg = evaluate_vector(call.args[0], ctx)
                    per_group = np.empty(n_groups, dtype=object)
                    pairs = np.stack(
                        [gids.astype(np.uint64), arg.data.astype(np.uint64)],
                        axis=1,
                    )
                    uniq = np.unique(pairs, axis=0)
                    for g in range(n_groups):
                        per_group[g] = uniq[uniq[:, 0] == g][:, 1]
                    states.append(("count_distinct", [per_group]))
                else:
                    col = _segment_aggregate(call, ctx, gids, n_groups)
                    states.append((kind, [col]))
            entries.append(("agg", emit_expr, states, agg_calls))
        else:
            full = evaluate_vector(sl.expr, ctx)
            entries.append(("first", full.gather(firsts)))

    return GroupByPartial(key_cols, n_groups, entries)


def _segment_aggregate_kind(kind, call, ctx, gids, n_groups, rtype):
    """Segment aggregation with an explicit kind/return type override."""
    if kind in ("count", "count_rows"):
        # "count_rows" (mean's denominator) always counts rows so the
        # partial/merged mean equals the local mean (sum/len semantics)
        pm = (
            None
            if kind == "count_rows"
            else _count_presence_mask(_count_subject(call), ctx)
        )
        if pm is None:
            data = np.bincount(gids, minlength=n_groups).astype(np.uint64)
        else:
            data = np.bincount(
                gids, weights=pm.astype(np.float64), minlength=n_groups
            ).astype(np.uint64)
        return Column(SType.UINT64, data, np.ones(n_groups, bool))
    arg = evaluate_vector(call.args[0], ctx)
    out = np.zeros(n_groups, dtype=dtype_for(rtype))
    np.add.at(out, gids, arg.data.astype(dtype_for(rtype)))
    return Column(rtype, out, np.ones(n_groups, bool))


def _merge_partials(
    node: qn.GroupByNode, partials: List["GroupByPartial"]
) -> Relation:
    """Merge shard partials with the accumulator algebra of
    VM::mergeInstance (reference: vm.cc:274-326; merge loop
    groupby.cc:552-637)."""
    from eventql_tpu_torch.parallel.partitioned import _concat_columns

    nkeys = len(partials[0].key_cols)
    total_groups = sum(p.n_groups for p in partials)
    if total_groups == 0:
        names = [sl.column_name() for sl in node.select_list]
        return Relation(
            names,
            [
                Column(
                    sl.expr.return_type(),
                    np.zeros(0, dtype=dtype_for(sl.expr.return_type())),
                    np.zeros(0, bool),
                    np.zeros(0, object)
                    if sl.expr.return_type() == SType.STRING
                    else None,
                )
                for sl in node.select_list
            ],
            0,
        )

    merged_keys = [
        _concat_columns([p.key_cols[i] for p in partials]) for i in range(nkeys)
    ]
    keys = _group_key_matrix(merged_keys, total_groups)
    gids, firsts = _factorize_rows(keys)
    n_out = len(firsts)

    out_cols: List[Column] = []
    entry_count = len(partials[0].entries)
    for e in range(entry_count):
        kind0 = partials[0].entries[e][0]
        if kind0 == "first":
            col = _concat_columns([p.entries[e][1] for p in partials])
            out_cols.append(col.gather(firsts))
            continue

        _tag, emit_expr, states0, agg_calls = partials[0].entries[e]
        merged_agg_cols: List[Column] = []
        for si, (skind, _cols0) in enumerate(states0):
            shard_states = [p.entries[e][2][si] for p in partials]
            if skind == "mean":
                s = np.concatenate([st[1][0].data for st in shard_states])
                c = np.concatenate([st[1][1].data for st in shard_states])
                ms = np.zeros(n_out)
                mc = np.zeros(n_out)
                np.add.at(ms, gids, s)
                np.add.at(mc, gids, c.astype(np.float64))
                with np.errstate(invalid="ignore", divide="ignore"):
                    out = ms / mc
                merged_agg_cols.append(
                    Column(SType.FLOAT64, out, np.ones(n_out, bool))
                )
            elif skind == "count_distinct":
                per_group = np.empty(n_out, dtype=object)
                for g in range(n_out):
                    per_group[g] = np.zeros(0, np.uint64)
                offset = 0
                for p, st in zip(partials, shard_states):
                    for g in range(p.n_groups):
                        tgt = gids[offset + g]
                        per_group[tgt] = np.union1d(per_group[tgt], st[1][0][g])
                    offset += p.n_groups
                data = np.array(
                    [len(per_group[g]) for g in range(n_out)], dtype=np.uint64
                )
                merged_agg_cols.append(
                    Column(SType.UINT64, data, np.ones(n_out, bool))
                )
            else:
                vals = np.concatenate([st[1][0].data for st in shard_states])
                dt = vals.dtype
                if skind in ("sum", "count"):
                    out = np.zeros(n_out, dtype=dt)
                    np.add.at(out, gids, vals)
                elif skind in ("min", "max"):
                    if np.issubdtype(dt, np.floating):
                        init = np.inf if skind == "min" else -np.inf
                    else:
                        info = np.iinfo(dt)
                        init = info.max if skind == "min" else info.min
                    out = np.full(n_out, init, dtype=dt)
                    (np.minimum if skind == "min" else np.maximum).at(
                        out, gids, vals
                    )
                else:
                    raise RuntimeError_(f"unmergeable aggregate: {skind}")
                stype = (
                    SType.UINT64
                    if skind == "count"
                    else agg_calls[si].sfunction.return_type
                )
                merged_agg_cols.append(
                    Column(stype, out, np.ones(n_out, bool))
                )

        emit_ctx = EvalContext(merged_agg_cols, n_out)
        out_cols.append(evaluate_vector(emit_expr, emit_ctx))

    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, n_out)


def _group_by_fingerprint(node: qn.GroupByNode) -> str:
    """Content fingerprint of a GroupBy plan (reference: the query cache
    keys partial aggregates by scan cache key + expression fingerprint,
    groupby.cc:255-295)."""
    from eventql_tpu_torch.exec.query_cache import QueryCache

    parts = []
    scan = node.table
    if isinstance(scan, qn.SequentialScanNode):
        parts.append(scan.table_name)
        parts.extend(sl.expr.to_sql() for sl in scan.select_list)
        parts.append(scan.where_expr.to_sql() if scan.where_expr else "")
    parts.extend(e.to_sql() for e in node.group_exprs)
    parts.extend(sl.expr.to_sql() for sl in node.select_list)
    return QueryCache.fingerprint(*parts)


def _exec_group_by(node: qn.GroupByNode, txn) -> Relation:
    # on-disk query cache: only for scans over immutable table files.
    # The key is the file and the plan, never the device: every route
    # below returns the host engine's groups and values (their order is
    # fixed only by an ORDER BY), so a result stored under one device
    # answers another. A hit launches no kernel.
    cache = getattr(txn, "query_cache", None)
    cache_key = None
    if cache is not None and isinstance(node.table, qn.SequentialScanNode):
        key_fn = getattr(txn.tables, "table_cache_key", None)
        file_key = key_fn(node.table.table_name) if key_fn else None
        if file_key is not None:
            cache_key = QueryCache_fingerprint_combine(
                file_key, _group_by_fingerprint(node)
            )
            cached = cache.get(cache_key)
            if cached is not None:
                return cached

    result = _exec_group_by_impl(node, txn)
    if cache_key is not None:
        cache.store(cache_key, result)
    return result


def QueryCache_fingerprint_combine(file_key: str, plan_fp: str) -> str:
    from eventql_tpu_torch.exec.query_cache import QueryCache

    return QueryCache.fingerprint(file_key, plan_fp)


def _exec_group_by_impl(node: qn.GroupByNode, txn) -> Relation:
    from eventql_tpu_torch.parallel.partitioned import (
        PartitionedTableProvider,
        execute_partitioned_group_by,
    )

    if isinstance(txn.tables, PartitionedTableProvider):
        # host partials per partition, merged as GroupByMerge does; None
        # -> shape not distributable, the whole-table paths below serve it
        result = execute_partitioned_group_by(node, txn.tables, txn)
        if result is not None:
            return result

    from eventql_tpu_torch.parallel.cluster import ClusterTableProvider

    if isinstance(txn.tables, ClusterTableProvider):
        # cross-process fan-out: ship the partial plan to every worker
        # (QUERY_PARTIALAGGR) and merge; None -> shape not distributable,
        # the routes below run on the rows pulled from the workers
        result = txn.tables.execute_partial_aggregate(node)
        if result is not None:
            return result

    if _on_mesh(txn):
        # the mesh tier: per-shard partial aggregation and an exchange of
        # accumulator tables (exec/mesh_exec.py); None -> shape not
        # mesh-routable, the routes below or the host engine serve it
        from eventql_tpu_torch.exec.mesh_exec import (
            try_execute_mesh_groupby,
            try_execute_mesh_join_groupby,
        )

        if isinstance(node.table, qn.JoinNode):
            result = try_execute_mesh_join_groupby(node, txn)
            if result is not None:
                return result
        result = try_execute_mesh_groupby(node, txn)
        if result is not None:
            return result

    if _on_device(node, txn):
        # the CUDA routes, in the JAX package's order: the bounded string
        # / numeric-key route, the join route, then the general (hash
        # aggregate) route for every other scan-child plan its gate
        # admits; None -> not routable, the host engine below serves it
        from eventql_tpu_torch.exec.device_exec import (
            device_plan_eligible,
            execute_device_groupby,
            try_execute_device_join_groupby,
            try_execute_string_groupby,
        )

        # a route.<name> span around each route tried: its analysis and,
        # where it serves the plan, its run
        with trace.span("route.string") as sp:
            result = try_execute_string_groupby(node, txn)
            sp.set("taken", result is not None)
        if result is not None:
            return result
        with trace.span("route.join") as sp:
            result = try_execute_device_join_groupby(node, txn)
            sp.set("taken", result is not None)
        if result is not None:
            return result
        with trace.span("route.general") as sp:
            result = execute_device_groupby(node, txn) if device_plan_eligible(node) else None
            sp.set("taken", result is not None)
        if result is not None:
            return result

    child = execute_node(node.table, txn)
    n = child.num_rows
    ctx = EvalContext(child.columns, n)

    key_cols = [evaluate_vector(e, ctx) for e in node.group_exprs]
    keys = _group_key_matrix(key_cols, n)
    gids, firsts = _factorize_rows(keys)
    n_groups = len(firsts)

    out_cols: List[Column] = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            agg_calls: List[CallExpressionNode] = []
            emit_expr = _strip_aggregates(sl.expr, agg_calls)
            agg_cols = [
                _segment_aggregate(c, ctx, gids, n_groups) for c in agg_calls
            ]
            emit_ctx = EvalContext(agg_cols, n_groups)
            out_cols.append(evaluate_vector(emit_expr, emit_ctx))
        else:
            # first-row-wins (reference: groupby.cc:161-172)
            full = evaluate_vector(sl.expr, ctx)
            out_cols.append(full.gather(firsts))

    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, n_groups)


# ---------------------------------------------------------------------------
# order by / limit
# ---------------------------------------------------------------------------


def _sort_key_arrays(col: Column) -> np.ndarray:
    """Turn a column into a numpy array that sorts like the reference's
    typed cmp functions (strings: byte order via sorted dictionary).

    NULL strings sort as the literal "NULL": the reference's boxed sort
    evaluation renders null string cells through their display form
    before cmp_string (Runtime_test TestRightJoin expects the NULL row
    LAST under ORDER BY orderid ASC — "NULL" > "10443"). NULL numerics
    pop as 0 from the VM stack (cmp_uint64) and sort first."""
    if col.stype == SType.STRING:
        # order-preserving rank over dictionary entries + the NULL label
        entries = list(col.dictionary.astype(bytes))
        null_pos = len(entries)
        entries.append(b"NULL")
        order = sorted(range(len(entries)), key=lambda i: entries[i])
        ranks = np.empty(len(entries), dtype=np.int64)
        ranks[order] = np.arange(len(entries))
        keys = ranks[col.data]
        if not col.valid.all():
            keys = np.where(col.valid, keys, ranks[null_pos])
        return keys
    if not col.valid.all():
        zero = np.zeros((), dtype=col.data.dtype)
        return np.where(col.valid, col.data, zero)
    return col.data


def _exec_having(node: qn.HavingNode, txn) -> Relation:
    """Post-aggregation filter: the expression is pre-resolved against
    the child GroupBy's output columns (plan/builder.py), so this is a
    plain vectorized mask + gather over the aggregated relation. The
    reference parses HAVING but silently drops it (no planner consumer
    of T_HAVING) — implemented here for real."""
    child = execute_node(node.table, txn)
    ctx = EvalContext(child.columns, child.num_rows)
    mask_col = evaluate_vector(node.filter_expr, ctx)
    keep = np.asarray(mask_col.data, dtype=bool) & np.asarray(
        mask_col.valid, dtype=bool
    )
    # hidden __having_* / ORDER BY-appended columns ride through: the
    # final ResultList slice to get_result_columns strips them
    return child.gather(np.nonzero(keep)[0])


def _on_mesh(txn) -> bool:
    from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

    return isinstance(txn.tables, MeshTableProvider)


def _exec_order_by(node: qn.OrderByNode, txn) -> Relation:
    if _on_mesh(txn) and isinstance(node.table, qn.SequentialScanNode):
        # the mesh sorts; None -> not routable
        from eventql_tpu_torch.exec.mesh_exec import try_execute_mesh_scan_order

        result = try_execute_mesh_scan_order(node, txn)
        if result is not None:
            return result

    if isinstance(node.table, qn.SequentialScanNode) and _on_device(node, txn):
        # the device scan-order route; None -> shape not routable
        from eventql_tpu_torch.exec.device_exec import (
            try_execute_device_scan_order,
        )

        with trace.span("route.order") as sp:
            result = try_execute_device_scan_order(node, txn)
            sp.set("taken", result is not None)
        if result is not None:
            return result

    child = execute_node(node.table, txn)
    return _order_relation(child, node.sort_specs)


def _order_relation(child: Relation, sort_specs) -> Relation:
    n = child.num_rows
    ctx = EvalContext(child.columns, n)

    keys = []
    for spec in sort_specs:
        col = evaluate_vector(spec.expr, ctx)
        k = _sort_key_arrays(col)
        if spec.descending:
            if np.issubdtype(k.dtype, np.floating):
                k = -k
            elif k.dtype == np.uint64:
                k = np.iinfo(np.uint64).max - k
            else:
                # order-reversing bijection into uint64 (sign-flip then
                # complement) — plain negation wraps INT64_MIN onto
                # itself and would sort the smallest value FIRST under
                # DESC (the reference's compiled cmp sorts it last)
                u = k.astype(np.int64).astype(np.uint64) ^ np.uint64(1 << 63)
                k = ~u
        keys.append(np.asarray(k))

    if keys:
        order = np.lexsort(list(reversed(keys)))
    else:
        order = np.arange(n)
    return child.gather(order)


def _exec_limit(node: qn.LimitNode, txn) -> Relation:
    # cluster tier: push LIMIT [+ ORDER BY] to the workers — each
    # returns its top offset+limit candidates, the coordinator re-sorts
    # the merged candidates and slices (the distributed top-k)
    from eventql_tpu_torch.parallel.cluster import ClusterTableProvider

    if isinstance(txn.tables, ClusterTableProvider):
        result = txn.tables.execute_pushdown_limit(node)
        if result is not None:
            return result

    if _on_mesh(txn) and isinstance(node.table, qn.OrderByNode):
        # the mesh top-k: O(k) candidates a shard; None -> not routable
        from eventql_tpu_torch.exec.mesh_exec import try_execute_mesh_scan_topk

        result = try_execute_mesh_scan_topk(node, txn)
        if result is not None:
            return result

    if isinstance(node.table, qn.OrderByNode) and _on_device(node, txn):
        # the device top-k route; None -> shape not routable
        from eventql_tpu_torch.exec.device_exec import (
            try_execute_device_scan_topk,
        )

        with trace.span("route.topk") as sp:
            result = try_execute_device_scan_topk(node, txn)
            sp.set("taken", result is not None)
        if result is not None:
            return result

    child = execute_node(node.table, txn)
    lo = node.offset
    hi = node.offset + node.limit
    idx = np.arange(child.num_rows)[lo:hi]
    return child.gather(idx)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------


def _find_join_conjunctions(node: qn.JoinNode, expr, out: List):
    # reference: findJoinConjunctions (sql/qtree/constraints.cc:29-93)
    if not isinstance(expr, CallExpressionNode):
        return
    if expr.function_name == "logical_and":
        for a in expr.args:
            _find_join_conjunctions(node, a, out)
        return
    if expr.function_name != "eq":
        return

    def deps(e, acc):
        if isinstance(e, ColumnReferenceNode) and e.column_index is not None:
            acc.add(node.input_map[e.column_index].table_idx)
        for a in e.arguments():
            deps(a, acc)

    left_tables, right_tables = set(), set()
    deps(expr.args[0], left_tables)
    deps(expr.args[1], right_tables)
    if len(left_tables) != 1 or len(right_tables) != 1 or left_tables == right_tables:
        return
    if 0 in left_tables:
        out.append((expr.args[0], expr.args[1]))
    else:
        out.append((expr.args[1], expr.args[0]))


def _side_ctx(node: qn.JoinNode, rel: Relation, side: int) -> EvalContext:
    """Evaluation context exposing the join's input_map columns for one
    side only (the other side's refs must not be touched)."""
    cols = []
    for ref in node.input_map:
        if ref.table_idx == side:
            cols.append(rel.columns[ref.column_idx])
        else:
            cols.append(None)
    return EvalContext(cols, rel.num_rows)


def _null_column(stype: SType, n: int) -> Column:
    if stype == SType.STRING:
        return Column(
            SType.STRING,
            np.zeros(n, np.int32),
            np.zeros(n, bool),
            np.array([b""], dtype=object),
        )
    return Column(stype, np.zeros(n, dtype=dtype_for(stype)), np.zeros(n, bool))


def _paired_columns(
    node: qn.JoinNode,
    base: Relation,
    joined: Relation,
    base_idx: np.ndarray,
    joined_idx: np.ndarray,
) -> List[Column]:
    """Materialize the join input vector for given row pairings; an
    index of -1 selects a NULL row (outer joins)."""
    cols = []
    n = len(base_idx)
    for ref in node.input_map:
        src = base if ref.table_idx == 0 else joined
        idx = base_idx if ref.table_idx == 0 else joined_idx
        col = src.columns[ref.column_idx]
        has_null = (idx < 0).any()
        safe_idx = np.where(idx < 0, 0, idx)
        g = col.gather(safe_idx)
        if has_null:
            g = Column(
                g.stype,
                np.where(idx < 0, 0, g.data).astype(g.data.dtype),
                np.where(idx < 0, False, g.valid),
                g.dictionary,
            )
        cols.append(g)
    return cols


def _join_key_ids(expr_cols: List[Column], n: int) -> np.ndarray:
    keys = _group_key_matrix(expr_cols, n)
    return keys


def _exec_join(node: qn.JoinNode, txn) -> Relation:
    if node.input_map is None:
        # a binary-wire-decoded join is structural only (the wire,
        # like the reference's, carries no input_map): executing it
        # would mis-bind column refs — require a re-plan instead
        raise RuntimeError_(
            "decoded join plans are not executable; re-plan the query"
        )
    base = execute_node(node.base_table, txn)
    joined = execute_node(node.joined_table, txn)

    conjunctions = []
    if node.where_expr is not None:
        _find_join_conjunctions(node, node.where_expr, conjunctions)
    if node.join_cond is not None:
        _find_join_conjunctions(node, node.join_cond, conjunctions)

    if conjunctions:
        base_idx, joined_idx = _hash_join_pairs(node, base, joined, conjunctions)
    else:
        # cartesian pairing (nested loop); reference:
        # statements/select/nested_loop_join.cc
        base_idx = np.repeat(np.arange(base.num_rows), joined.num_rows)
        joined_idx = np.tile(np.arange(joined.num_rows), base.num_rows)

    # stage 1: join condition selects matching pairs (padded outer rows
    # — idx == -1 — always pass: they exist because nothing matched)
    pair_cols = _paired_columns(node, base, joined, base_idx, joined_idx)
    n = len(base_idx)
    ctx = EvalContext(pair_cols, n)
    if node.join_cond is not None:
        cond = evaluate_vector(node.join_cond, ctx).data.astype(bool)
        padded = (joined_idx < 0) | (base_idx < 0)
        keep = cond | padded
        if node.join_type == qn.JoinNode.LEFT:
            # base rows whose every pair failed the residual condition
            # still emit one padded row
            matched = np.zeros(base.num_rows, dtype=bool)
            matched[base_idx[keep & ~padded]] = True
            had_pairs = np.zeros(base.num_rows, dtype=bool)
            had_pairs[base_idx[~padded]] = True
            newly_unmatched = np.nonzero(had_pairs & ~matched)[0]
            base_idx = np.concatenate([base_idx[keep], newly_unmatched])
            joined_idx = np.concatenate(
                [joined_idx[keep], np.full(len(newly_unmatched), -1, np.int64)]
            )
            order = np.argsort(base_idx, kind="stable")
            base_idx, joined_idx = base_idx[order], joined_idx[order]
        elif node.join_type == qn.JoinNode.RIGHT:
            matched = np.zeros(joined.num_rows, dtype=bool)
            matched[joined_idx[keep & ~padded]] = True
            had_pairs = np.zeros(joined.num_rows, dtype=bool)
            had_pairs[joined_idx[~padded]] = True
            newly_unmatched = np.nonzero(had_pairs & ~matched)[0]
            base_idx = np.concatenate(
                [base_idx[keep], np.full(len(newly_unmatched), -1, np.int64)]
            )
            joined_idx = np.concatenate([joined_idx[keep], newly_unmatched])
        else:
            base_idx, joined_idx = base_idx[keep], joined_idx[keep]
        pair_cols = _paired_columns(node, base, joined, base_idx, joined_idx)
        ctx = EvalContext(pair_cols, len(base_idx))

    # stage 2: WHERE filters all rows, padded included (NULL payloads)
    if node.where_expr is not None:
        w = evaluate_vector(node.where_expr, ctx).data.astype(bool)
        sel = np.nonzero(w)[0]
        pair_cols = [c.gather(sel) for c in pair_cols]
        ctx = EvalContext(pair_cols, len(sel))

    out_cols = [evaluate_vector(sl.expr, ctx) for sl in node.select_list]
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ctx.num_rows)


def _hash_join_pairs(node, base, joined, conjunctions):
    """Vectorized equi-join pairing; emits pairs in base-row-major order
    like the reference's probe loop (hash_join.cc:123-201), with LEFT /
    RIGHT outer padding (joined_idx/base_idx = -1)."""
    base_key_cols = []
    joined_key_cols = []
    for base_expr, joined_expr in conjunctions:
        bctx = _side_ctx(node, base, 0)
        jctx = _side_ctx(node, joined, 1)
        bcol = evaluate_vector(base_expr, bctx)
        jcol = evaluate_vector(joined_expr, jctx)
        # unify string dictionaries across sides so ids compare equal
        if bcol.stype == SType.STRING and jcol.stype == SType.STRING:
            from eventql_tpu_torch.exec.vector_eval import _string_ids_unified

            ids_b, ids_j = _string_ids_unified(bcol, jcol)
            bcol = Column(SType.UINT64, ids_b.astype(np.uint64), bcol.valid)
            jcol = Column(SType.UINT64, ids_j.astype(np.uint64), jcol.valid)
        base_key_cols.append(bcol)
        joined_key_cols.append(jcol)

    bkeys = _group_key_matrix(base_key_cols, base.num_rows)
    jkeys = _group_key_matrix(joined_key_cols, joined.num_rows)

    # factorize over both sides together
    all_keys = np.concatenate([bkeys, jkeys], axis=0)
    _, inverse = np.unique(all_keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    b_ids = inverse[: base.num_rows]
    j_ids = inverse[base.num_rows :]

    # joined side: stable sort by key id; per base row gather the range
    j_order = np.argsort(j_ids, kind="stable")
    j_sorted = j_ids[j_order]
    starts = np.searchsorted(j_sorted, b_ids, side="left")
    ends = np.searchsorted(j_sorted, b_ids, side="right")
    counts = ends - starts

    base_idx = np.repeat(np.arange(base.num_rows), counts)
    # ranges into j_order
    if len(base_idx):
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(counts.sum()) - np.repeat(offsets, counts)
        joined_idx = j_order[np.repeat(starts, counts) + within]
    else:
        joined_idx = np.zeros(0, dtype=np.int64)

    if node.join_type == qn.JoinNode.LEFT:
        unmatched = np.nonzero(counts == 0)[0]
        base_idx = np.concatenate([base_idx, unmatched])
        joined_idx = np.concatenate(
            [joined_idx, np.full(len(unmatched), -1, dtype=np.int64)]
        )
        order = np.argsort(base_idx, kind="stable")
        base_idx, joined_idx = base_idx[order], joined_idx[order]
    elif node.join_type == qn.JoinNode.RIGHT:
        matched = np.zeros(joined.num_rows, dtype=bool)
        matched[joined_idx[joined_idx >= 0]] = True
        unmatched = np.nonzero(~matched)[0]
        base_idx = np.concatenate(
            [base_idx, np.full(len(unmatched), -1, dtype=np.int64)]
        )
        joined_idx = np.concatenate([joined_idx, unmatched])

    return base_idx.astype(np.int64), joined_idx.astype(np.int64)


# ---------------------------------------------------------------------------
# metadata statements
# ---------------------------------------------------------------------------


def _exec_show_tables(node, txn) -> Relation:
    infos = txn.tables.list_tables()
    names = Column.from_strings([t.table_name.encode() for t in infos])
    descs = Column.from_strings([b"" for _ in infos])
    return Relation(["table_name", "description"], [names, descs], len(infos))


def _exec_describe_table(node, txn) -> Relation:
    from eventql_tpu_torch.core.types import sql_typename

    info = txn.tables.describe(node.table_name)
    if info is None:
        raise RuntimeError_(f"table not found: '{node.table_name}'")
    cols = info.columns
    return Relation(
        ["column_name", "type", "nullable", "description"],
        [
            Column.from_strings([c[0].encode() for c in cols]),
            Column.from_strings([sql_typename(c[1]).encode() for c in cols]),
            Column.from_strings([b"YES" for _ in cols]),
            Column.from_strings([b"" for _ in cols]),
        ],
        len(cols),
    )


def _exec_describe_partitions(node, txn) -> Relation:
    # cluster runtimes report the real partition map (partition_id +
    # comma-joined server placements, describe_partitions.cc:31-52);
    # single-process runtimes report one partition per shard
    info = txn.tables.describe(node.table_name)
    if info is None:
        raise RuntimeError_(f"table not found: '{node.table_name}'")

    parts_fn = getattr(txn.tables, "table_partitions", None)
    if parts_fn is not None:
        parts = parts_fn(node.table_name)
        if parts is not None:
            rows = [
                [pid.encode(), ",".join(servers).encode(),
                 str(keyrange[0]).encode(), str(keyrange[1]).encode(), b""]
                for pid, servers, keyrange in parts
            ]
            cols = [
                Column.from_strings([r[i] for r in rows]) for i in range(5)
            ]
            return Relation(
                list(qn.DescribePartitionsNode.COLUMNS), cols, len(rows)
            )

    shards_fn = getattr(txn.tables, "shards", None)
    n = len(shards_fn(node.table_name)) if shards_fn else 1
    rows = [
        [f"{node.table_name}.{i}".encode(), b"localhost", b"", b"", b""]
        for i in range(n)
    ]
    cols = [Column.from_strings([r[i] for r in rows]) for i in range(5)]
    return Relation(list(qn.DescribePartitionsNode.COLUMNS), cols, len(rows))


def _exec_cluster_show_servers(node, txn) -> Relation:
    # cluster runtimes report the live worker set; standalone reports a
    # single local server row (reference: cluster_show_servers.cc)
    servers = getattr(txn.tables, "cluster_servers", None)
    if servers is not None:
        rows = [
            [name.encode(), status.encode(), addr.encode(),
             b"eventql_tpu_torch", b"0", b"0", b"0", b"0"]
            for name, status, addr in servers()
        ]
    else:
        rows = [[b"localhost", b"SERVER_UP", b"localhost", b"eventql_tpu_torch",
                 b"0", b"0", b"0", b"0"]]
    cols = [
        Column.from_strings([r[i] for r in rows]) for i in range(8)
    ]
    return Relation(list(qn.ClusterShowServersNode.COLUMNS), cols, len(rows))


def _exec_chart(node, txn) -> Relation:
    from eventql_tpu_torch.exec.chart import render_chart

    svg = render_chart(node, txn)
    return Relation(["__chart"], [Column.from_strings([svg])], 1)
