"""Nested/repeated-column scan: Dremel-style record re-assembly.

Re-implements the reference's row-assembly scan state machine
(reference: sql/CSTableScan.cc:187-520): columns are streams of
(repetition level, definition level, value); each assembly step reads
every referenced column whose next repetition level >= the current
fetch level, and the aggregation strategy decides when a row is
emitted:

  NO_AGGREGATION               one output row per assembly step (the
                               row-expansion that makes
                               count(repeated_col) count values)
  AGGREGATE_WITHIN_RECORD_FLAT accumulate per step, emit one row per
                               record (WITHIN RECORD aggregates)

This is the compatibility path for nested schemas; flat scans use the
vectorized engine (exec.operators) and the device path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType, SValue
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    has_aggregate_call,
)
from eventql_tpu_torch.plan.scalar_eval import evaluate_scalar


class _ColumnStream:
    """Sequential reader over a DecodedColumn
    (reference: io/cstable/columns/v1/ColumnReader.h)."""

    def __init__(self, dec, stype: SType):
        self.rlvls = dec.rlvls
        self.dlvls = dec.dlvls
        self.values = dec.values
        self.r_max = dec.config.rlevel_max
        self.d_max = dec.config.dlevel_max
        self.stype = stype
        self.pos = 0
        self.vpos = 0
        self.n = len(self.rlvls)

    def next_repetition_level(self) -> int:
        if self.pos >= self.n:
            return 0
        return int(self.rlvls[self.pos])

    def eof(self) -> bool:
        return self.pos >= self.n

    def read(self) -> Optional[SValue]:
        """Read next (value or None-for-null); advances the stream."""
        d = int(self.dlvls[self.pos])
        self.pos += 1
        if d < self.d_max:
            return None
        v = self.values[self.vpos]
        self.vpos += 1
        if self.stype == SType.STRING:
            return SValue.new_string(bytes(v))
        if self.stype == SType.BOOL:
            return SValue.new_bool(bool(v))
        if self.stype == SType.FLOAT64:
            return SValue.new_float64(float(v))
        if self.stype == SType.INT64:
            return SValue.new_int64(int(v))
        return SValue.new_uint64(int(v))


def _zero(stype: SType):
    return {
        SType.NIL: None,
        SType.UINT64: 0,
        SType.INT64: 0,
        SType.FLOAT64: 0.0,
        SType.BOOL: False,
        SType.STRING: b"",
        SType.TIMESTAMP64: 0,
    }[stype]


class _AggInstance:
    """Per-expression aggregate accumulator with the reference's
    accumulate/get/reset contract (reference: sql/runtime/vm.h:68-82)."""

    def __init__(self, expr):
        from eventql_tpu_torch.exec.operators import _strip_aggregates

        self.agg_calls: List[CallExpressionNode] = []
        self.emit_expr = _strip_aggregates(expr, self.agg_calls)
        self.reset()

    def reset(self):
        self.state = []
        for call in self.agg_calls:
            kind = call.sfunction.aggregate.kind
            if kind == "count":
                self.state.append(0)
            elif kind == "count_distinct":
                self.state.append(set())
            elif kind == "sum":
                self.state.append(0 if call.sfunction.return_type != SType.FLOAT64 else 0.0)
            elif kind == "min":
                self.state.append(None)
            elif kind == "max":
                self.state.append(None)
            elif kind == "mean":
                self.state.append((0.0, 0))
            else:
                raise RuntimeError_(f"unknown aggregate kind {kind}")

    def accumulate(self, row: List[SValue]):
        from eventql_tpu_torch.core.types import wrap_i64, wrap_u64

        from eventql_tpu_torch.exec.operators import _count_subject

        for i, call in enumerate(self.agg_calls):
            kind = call.sfunction.aggregate.kind
            arg = evaluate_scalar(call.args[0], row) if call.args else None
            if kind == "count":
                subject = _count_subject(call)
                if subject is not None:
                    v = evaluate_scalar(subject, row)
                    if v.is_null or v.stype == SType.NIL:
                        continue
                self.state[i] += 1
            elif kind == "count_distinct":
                self.state[i].add(arg.payload())
            elif kind == "sum":
                v = arg.payload()
                if call.sfunction.return_type == SType.UINT64:
                    self.state[i] = wrap_u64(self.state[i] + v)
                elif call.sfunction.return_type == SType.INT64:
                    self.state[i] = wrap_i64(self.state[i] + v)
                else:
                    self.state[i] += v
            elif kind == "min":
                v = arg.payload()
                self.state[i] = v if self.state[i] is None else min(self.state[i], v)
            elif kind == "max":
                v = arg.payload()
                self.state[i] = v if self.state[i] is None else max(self.state[i], v)
            elif kind == "mean":
                s, c = self.state[i]
                self.state[i] = (s + float(arg.payload()), c + 1)

    def get(self) -> SValue:
        from eventql_tpu_torch.plan.scalar_eval import _box

        vals = []
        for call, st in zip(self.agg_calls, self.state):
            kind = call.sfunction.aggregate.kind
            rt = call.sfunction.return_type
            if kind == "count":
                vals.append(SValue.new_uint64(st))
            elif kind == "count_distinct":
                vals.append(SValue.new_uint64(len(st)))
            elif kind == "sum":
                vals.append(_box(rt, st))
            elif kind in ("min", "max"):
                vals.append(_box(rt, st if st is not None else _zero(rt)))
            elif kind == "mean":
                s, c = st
                vals.append(SValue.new_float64(s / c if c else 0.0))
        return evaluate_scalar(self.emit_expr, vals)


def execute_nested_scan(node: qn.SequentialScanNode, reader) -> Relation:
    """Run the assembly state machine over a CSTableReader for a scan
    that references repeated columns or aggregates WITHIN RECORD.

    Returns the scan's output Relation (one column per select-list
    entry)."""
    # column streams for all referenced input columns
    streams: List[_ColumnStream] = []
    col_types: List[SType] = []
    for cname, ctype in node.input_columns:
        if not reader.has_column(cname):
            raise RuntimeError_(f"column(s) not found: '{cname}'")
        dec = reader.decode_column(cname)
        streams.append(_ColumnStream(dec, ctype))
        col_types.append(ctype)

    ncols = len(streams)
    num_records = reader.num_rows
    within_record = node.aggr_strategy in (
        qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_FLAT,
        qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_DEEP,
    )

    # per-select-expr state
    select_aggs: List[Optional[_AggInstance]] = []
    select_rep_levels: List[int] = []
    for sl in node.select_list:
        if within_record and has_aggregate_call(sl.expr):
            select_aggs.append(_AggInstance(sl.expr))
        else:
            select_aggs.append(None)
        # rep level of the expr = max rep level of referenced columns
        max_rep = 0

        def walk(e):
            nonlocal max_rep
            if isinstance(e, ColumnReferenceNode) and e.column_index is not None:
                max_rep = max(max_rep, streams[e.column_index].r_max)
            for a in e.arguments():
                walk(a)

        walk(sl.expr)
        select_rep_levels.append(max_rep)

    out_rows: List[List[SValue]] = []
    cur_buf: List[SValue] = [SValue(t, _zero(t), True) for t in col_types]

    cur_fetch_level = 0
    cur_select_level = 0
    cur_pos = 0

    while cur_pos < num_records:
        # read columns at the current fetch level
        next_level = 0
        for ci, st in enumerate(streams):
            if st.eof():
                continue
            if st.next_repetition_level() >= cur_fetch_level:
                v = st.read()
                if v is None:
                    ctype = col_types[ci]
                    if ctype == SType.BOOL:
                        cur_buf[ci] = SValue.new_bool(False)
                    else:
                        cur_buf[ci] = SValue(ctype, _zero(ctype), True)
                else:
                    cur_buf[ci] = v
            next_level = max(next_level, st.next_repetition_level())

        cur_fetch_level = next_level
        record_end = cur_fetch_level == 0
        if record_end:
            cur_pos += 1

        # WHERE per assembled row
        where_pred = True
        if node.where_expr is not None:
            where_pred = bool(
                evaluate_scalar(node.where_expr, cur_buf).payload()
            )

        if where_pred:
            if within_record:
                for i, sl in enumerate(node.select_list):
                    agg = select_aggs[i]
                    if agg is not None and select_rep_levels[i] >= cur_select_level:
                        agg.accumulate(cur_buf)
                # FLAT emits once per record; DEEP emits one aggregated
                # row per repeated-value step at any repetition level
                # (reference: CSTableScan.cc:455-486 — FLAT falls
                # through to DEEP's emit only when next_level == 0)
                deep = (
                    node.aggr_strategy
                    == qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_DEEP
                )
                if record_end or deep:
                    row = []
                    for i, sl in enumerate(node.select_list):
                        agg = select_aggs[i]
                        if agg is not None:
                            row.append(agg.get())
                            agg.reset()
                        else:
                            row.append(evaluate_scalar(sl.expr, cur_buf))
                    out_rows.append(row)
            else:
                out_rows.append(
                    [evaluate_scalar(sl.expr, cur_buf) for sl in node.select_list]
                )
            cur_select_level = cur_fetch_level
        else:
            cur_select_level = min(cur_select_level, cur_fetch_level)

        # clear repeated-column buffers below the select level
        for ci, st in enumerate(streams):
            if st.r_max >= cur_select_level:
                ctype = col_types[ci]
                cur_buf[ci] = SValue(ctype, _zero(ctype), True)

    # columnarize
    names = [sl.column_name() for sl in node.select_list]
    cols: List[Column] = []
    for i, sl in enumerate(node.select_list):
        stype = sl.expr.return_type()
        vals = [r[i] for r in out_rows]
        cols.append(_column_from_values(stype, vals))
    return Relation(names, cols, len(out_rows))


def _column_from_values(stype: SType, vals: List[SValue]) -> Column:
    """Columnarize expanded-row SValues. `presence` marks the rows
    where the column's repetition group occurs — count(x) accumulates
    per occurrence (reference: CSTableScan.cc:441-452 rep-level gating),
    which this expansion surfaces as defined values (an absent
    occurrence assembles as a null SValue). A null value INSIDE a
    present occurrence is indistinguishable here and is counted as
    absent — the reference's own fixtures (704/24793) don't exercise
    that corner (noted in COMPARISON.md)."""
    from eventql_tpu_torch.exec.relation import dtype_for

    n = len(vals)
    if stype == SType.STRING:
        col = Column.from_strings(
            [None if v.is_null else v.payload() for v in vals]
        )
        col.presence = col.valid.copy()
        return col
    data = np.zeros(n, dtype=dtype_for(stype))
    valid = np.zeros(n, dtype=bool)
    for i, v in enumerate(vals):
        valid[i] = not v.is_null and v.stype != SType.NIL
        if valid[i]:
            data[i] = v.payload()
    return Column(stype, data, valid, None, valid.copy())
