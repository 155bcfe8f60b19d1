"""Bounded-memory streaming execution for non-aggregating plans.

The reference pulls 1024-row batches through its operator tree and
streams them out, so server memory for a huge SELECT is O(batch)
(reference: sql/result_cursor.h:35-75, sql/CSTableScan.h:46, the
row loop in transport/native/ops/query.cc:136-230). This module is
the whole-column redesign of that cursor: the storage layer yields
segment/chunk-sized Relations (LSMTable.stream_chunks holds one
segment at a time), each row-local operator stage — scan filter,
projection, subquery select, LIMIT/OFFSET — applies vectorized per
chunk, and the transports format + frame rows chunk by chunk. The
vectorized chunk passes keep the TPU/numpy batch shape while the
generator chain bounds the peak footprint.

Only row-local plan shapes stream (filter/map/limit); blocking
operators (GROUP BY, ORDER BY, JOIN) need their full input and keep
the materializing path — same split as the reference, whose GroupBy
and OrderBy also buffer before their first output row.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from eventql_tpu_torch.exec.relation import Relation
from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.exprs import has_aggregate_call

# chunk granularity pulled from storage (the reference streams
# 1024-row batches, CSTableScan.h:46; whole-column evaluation amortizes
# better with larger chunks — 64K rows keeps per-chunk numpy dispatch
# overhead negligible while bounding the footprint to a few MB/column)
STREAM_CHUNK_ROWS = int(
    os.environ.get("EVENTQL_TPU_STREAM_CHUNK_ROWS", "65536")
)


def streamable(node, txn) -> bool:
    """True when `node` can execute as a bounded-memory chunk stream
    with output identical to execute_node()."""
    if isinstance(node, qn.SequentialScanNode):
        return _scan_streamable(node, txn)
    if isinstance(node, qn.LimitNode):
        # a cluster provider ships LimitNode(offset+limit) to the
        # partition owners (operators._exec_limit pushdown) — strictly
        # less transfer than streaming whole partitions to serve N
        # rows; local tables stream (the generator stops at the limit)
        if getattr(txn.tables, "execute_pushdown_limit", None) is not None:
            return False
        return streamable(node.table, txn)
    if isinstance(node, qn.SubqueryNode):
        if any(has_aggregate_call(sl.expr) for sl in node.select_list):
            return False
        return streamable(node.subquery, txn)
    return False


def _scan_streamable(node: qn.SequentialScanNode, txn) -> bool:
    if node.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return False
    provider = txn.tables
    if getattr(provider, "get_table_chunks", None) is None:
        return False
    # nested/repeated columns ride the Dremel row-assembly path
    # (columnar.nested_scan) — not chunk-streamable
    reader = getattr(provider, "get_reader", lambda n: None)(
        node.table_name
    )
    if reader is not None:
        for cname, _ctype in node.input_columns:
            cfg = reader.column_config(cname)
            if cfg is not None and cfg.rlevel_max > 0:
                return False
    return True


def stream_node(node, txn) -> Iterator[Relation]:
    """Execute `node` as a generator of Relation chunks; concatenating
    the chunks equals execute_node(node, txn) exactly."""
    if isinstance(node, qn.SequentialScanNode):
        from eventql_tpu_torch.exec.operators import (
            _count_scan,
            _exec_seqscan_relation,
            _scan_bytes,
        )

        for chunk in txn.tables.get_table_chunks(
            node.table_name, STREAM_CHUNK_ROWS
        ):
            _count_scan(txn, chunk.num_rows, _scan_bytes(node, chunk))
            out = _exec_seqscan_relation(node, chunk)
            if out.num_rows:
                yield out
        return
    if isinstance(node, qn.LimitNode):
        yield from _stream_limit(node, txn)
        return
    if isinstance(node, qn.SubqueryNode):
        for chunk in stream_node(node.subquery, txn):
            out = _apply_subquery_chunk(node, chunk)
            if out.num_rows:
                yield out
        return
    raise AssertionError(f"not streamable: {node!r}")


def _stream_limit(node: qn.LimitNode, txn) -> Iterator[Relation]:
    """OFFSET/LIMIT as a countdown over the child stream (reference:
    sql/statements/select/limit.cc skips then forwards rows)."""
    to_skip = node.offset
    remaining = node.limit
    for chunk in stream_node(node.table, txn):
        n = chunk.num_rows
        if to_skip >= n:
            to_skip -= n
            continue
        lo = to_skip
        to_skip = 0
        take = min(remaining, n - lo)
        if take <= 0:
            return
        if lo != 0 or take != n:
            chunk = chunk.gather(
                np.arange(lo, lo + take, dtype=np.int64)
            )
        remaining -= take
        yield chunk
        if remaining <= 0:
            return


def _apply_subquery_chunk(node: qn.SubqueryNode, child: Relation) -> Relation:
    """Row-local subquery stage applied to one chunk (the non-aggregate
    body of operators._exec_subquery)."""
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


class StreamingResultList:
    """ResultList-shaped view whose `rows` is a lazy generator: the
    transports' row loops (native QUERY_RESULT paging, HTTP SSE) pull
    rows as chunks execute, so no statement result is ever fully
    materialized (reference: ResultCursor pull semantics,
    sql/result_cursor.h:35-75)."""

    def __init__(self, columns: List[str], chunks: Iterator[Relation]):
        self.columns = list(columns)
        self._chunks = chunks

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def rows(self):
        ncols = len(self.columns)
        for rel in self._chunks:
            cols = rel.columns[:ncols]
            formatted = [c.format_all() for c in cols]
            for r in zip(*formatted):
                yield list(r)
