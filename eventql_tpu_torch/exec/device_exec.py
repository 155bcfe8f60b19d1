"""Device (CUDA) plan routing.

Routes the canonical analytics shape

    SELECT key, count(*) / sum(v) ... FROM t [WHERE ...] GROUP BY key

to the hand-written Hopper kernels of kernels/groupby_agg.py instead of
the host columnar engine (the counterpart of
eventql_tpu/exec/device_exec.py:try_execute_pallas_string_groupby), and

    SELECT ... FROM t [WHERE ...] ORDER BY ... [LIMIT k [OFFSET o]]

to the device sort / histogram top-k of kernels/sort.py (the
counterparts of try_execute_device_scan_topk / _scan_order there), and

    SELECT d.col, count(*) / sum(f.v) ... FROM f JOIN d ON f.k = d.k
    [WHERE fact-side predicate] GROUP BY d.col

to the join probe kernels of kernels/join.py feeding the same
aggregation kernels (the counterpart of try_execute_device_join_groupby
there). The host engine remains the semantic reference; plans outside
the shapes return None and fall back to it transparently.

The device is the transaction's (``txn.device``): on a CUDA device the
kernels launch, on the CPU device the same route runs through their
plain PyTorch versions.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import torch_expr
from eventql_tpu_torch.exec.relation import Column, Relation, dtype_for
from eventql_tpu_torch.kernels import groupby_agg as kernels
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    LiteralExpressionNode,
    has_aggregate_call,
)

# bucket-count cap of the route: beyond it the key is "unbounded" and
# belongs to the sort-based GROUP BY tier
K_CAP = 131072

# reentrant: _to_device_cols holds it while calling _narrow_np, which
# takes it again on a narrow-cache miss
_COLUMN_CACHE_LOCK = threading.RLock()


def _narrow_np(c: Column) -> "np.ndarray":
    """Physical column narrowing: a logical 64-bit column whose values
    fit 32 (16) bits transfers (and streams from device memory) as a
    32 (16)-bit array: half (a quarter) of the scan bytes per row. The
    expression compiler widens back to the logical dtype, and the
    kernels read the narrow streams directly, so semantics are
    unchanged while the memory-bound scan moves fewer bytes (the
    reference's planner reads column statistics the same way). Min/max
    stats cache on the Column (columns are rebuilt on mutation)."""
    cached = getattr(c, "_narrow_cache", None)
    if cached is not None:
        return cached
    with _COLUMN_CACHE_LOCK:
        cached = getattr(c, "_narrow_cache", None)
        if cached is not None:
            return cached
        return _narrow_np_build(c)


def _narrow_np_build(c: Column):
    data = c.data
    out = data
    if data.size:
        if data.dtype == np.uint64:
            mx = int(data.max())
            # true min matters: base-offset group keys (ids, years,
            # timestamps-in-days) only fit the route's bucket bound as
            # (key - min)
            c._stats_cache = (int(data.min()), mx)
            if mx < (1 << 16):
                out = data.astype(np.uint16)
            elif mx < (1 << 32):
                out = data.astype(np.uint32)
        elif data.dtype == np.int64:
            mn, mx = int(data.min()), int(data.max())
            c._stats_cache = (mn, mx)
            if -(1 << 15) <= mn and mx < (1 << 15):
                out = data.astype(np.int16)
            elif -(1 << 31) <= mn and mx < (1 << 31):
                out = data.astype(np.int32)
        elif data.dtype == np.int32 and c.stype == SType.STRING:
            # STRING dictionary ids: ids are [0, K) by construction
            # (relation.from_strings / dictionary unification), so a
            # dictionary that fits 15 bits streams as int16: half the
            # scan bytes for string-keyed filters and groupbys.
            # torch_expr._widen restores int32. The stype gate enforces
            # the dictionary-id invariant: a future non-string int32
            # physical column must NOT take this branch implicitly.
            mn, mx = int(data.min()), int(data.max())
            if -(1 << 15) <= mn and mx < (1 << 15):
                out = data.astype(np.int16)
    try:
        c._narrow_cache = out
    except AttributeError:
        pass
    return out


def _scan_inputs_present(table, scan) -> bool:
    """False when a scan references columns the materialized relation
    does not carry (nested/repeated leaves served by the Dremel scan
    path): those queries belong to the host engine."""
    names = set(table.names)
    return all(cname in names for cname, _t in scan.input_columns)


_SIGNED_VIEW = {
    np.dtype(np.uint16): np.int16,
    np.dtype(np.uint32): np.int32,
    np.dtype(np.uint64): np.int64,
}


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor of the same bits; unsigned arrays
    travel as the signed type of their width (torch cannot compute with
    its unsigned types)."""
    arr = np.ascontiguousarray(arr)
    view = _SIGNED_VIEW.get(arr.dtype)
    if view is not None:
        arr = arr.view(view)
    return torch.from_numpy(arr).to(device)


def _to_device_cols(rel_cols: List[Column], names: List[str], wanted, device):
    """Host -> device transfer of the scan's input columns. The device
    tensors cache on the Column, per device (columns are rebuilt on
    mutation, the same invalidation argument as _narrow_cache): a
    repeated query on warm columns pays zero transfer."""
    out = []
    by_name = dict(zip(names, rel_cols))
    dkey = str(device)
    for cname, _t in wanted:
        c = by_name[cname]
        cache = getattr(c, "_device_cache", None)
        dev = cache.get(dkey) if cache is not None else None
        if dev is None:
            # double-checked under the column-cache lock: two
            # concurrent queries must not duplicate a host->device
            # transfer of the same column
            with _COLUMN_CACHE_LOCK:
                cache = getattr(c, "_device_cache", None)
                if cache is None:
                    cache = c._device_cache = {}
                dev = cache.get(dkey)
                if dev is None:
                    dev = cache[dkey] = (
                        _to_tensor(_narrow_np(c), device),
                        _to_tensor(c.valid, device),
                    )
        out.append(torch_expr.DeviceCol(c.stype, dev[0], dev[1]))
    return out


# -- fused GROUP BY kernel route ----------------------------------------------
# For the canonical `SELECT key, count(*), sum(v) FROM t WHERE col CMP
# literal GROUP BY key` shape, the WHERE compare, the filtered-row drop
# and the numeric-key base subtract all run INSIDE the aggregation
# kernel (kernels/groupby_agg.groupby_agg), so the per-query device
# memory traffic is exactly the raw narrowed column streams.

_FUSED_OPS = {
    "lt": "lt",
    "lte": "le",
    "gt": "gt",
    "gte": "ge",
    "eq": "eq",
    "neq": "ne",
}
# observability: how many queries took the fused route (tests assert
# this so fused-path coverage can't silently fall back)
FUSED_GROUPBY_COUNT = 0
# multi-sum route (2+ summed columns under one pass)
MULTI_SUM_GROUPBY_COUNT = 0
# ORDER BY ... LIMIT route (try_execute_device_scan_topk) and full
# ORDER BY route (try_execute_device_scan_order)
SCAN_TOPK_COUNT = 0
SCAN_ORDER_COUNT = 0
# fact-dim JOIN + GROUP BY route (try_execute_device_join_groupby)
JOIN_GROUPBY_COUNT = 0
_FUSED_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
_I32_MIN = -(1 << 31)


def _column_all_valid(c: Column) -> bool:
    cached = getattr(c, "_all_valid_cache", None)
    if cached is None:
        cached = bool(np.all(c.valid))
        try:
            c._all_valid_cache = cached
        except AttributeError:
            pass
    return cached


def _fused_pred_eligible(host_c: Column, stype) -> bool:
    """May this column's narrowed stream serve as the in-kernel
    predicate operand? Requires payloads whose int32 representation
    preserves the logical compare: u16 (zero-extends), i16
    (sign-extends), i32 (exact), and u32 only when the narrowing pass's
    cached max stat proves every payload < 2^31 (larger payloads flip
    sign)."""
    if stype not in (SType.UINT64, SType.INT64, SType.TIMESTAMP64):
        return False
    nd = _narrow_np(host_c)
    if nd.dtype in (np.uint16, np.int16, np.int32):
        return True
    if nd.dtype == np.uint32:
        stats = getattr(host_c, "_stats_cache", None)
        return stats is not None and stats[1] < (1 << 31)
    return False


def _flatten_bool(w, fn_name, out):
    if (
        isinstance(w, CallExpressionNode)
        and w.sfunction.name == fn_name
        and len(w.args) == 2
    ):
        _flatten_bool(w.args[0], fn_name, out)
        _flatten_bool(w.args[1], fn_name, out)
    else:
        out.append(w)


def _match_fused_where(scan, name_to_col):
    """Match the WHERE clause against the kernel's in-kernel predicate
    slots. Returns (conjuncts, combine) where conjuncts is a list of 1-2
    (input_col_idx|None|'mask', op, thr) specs and combine is
    'and'|'or'; [(None, 'ge', INT32_MIN)] is the always-true form for a
    missing WHERE. Shapes beyond the two compare slots (>=3 conjuncts,
    mixed and/or trees, arithmetic predicates) return the
    ('mask', 'ge', 1) spec: the route then evaluates the WHERE with
    torch_expr into a 0/1 byte stream the kernel compares against."""
    w = scan.where_expr
    if w is None:
        return [(None, "ge", _I32_MIN)], "and"
    m = _match_simple_compare(w, scan, name_to_col)
    if m is not None:
        return [m], "and"
    for fn_name, combine in (("logical_and", "and"), ("logical_or", "or")):
        terms = []
        _flatten_bool(w, fn_name, terms)
        if len(terms) == 2:
            a = _match_simple_compare(terms[0], scan, name_to_col)
            b = _match_simple_compare(terms[1], scan, name_to_col)
            if a is not None and b is not None:
                return [a, b], combine
    # general predicate: one expression pass -> 0/1 stream into the kernel
    return [("mask", "ge", 1)], "and"


def _match_simple_compare(w, scan, name_to_col):
    if not isinstance(w, CallExpressionNode):
        return None
    op = _FUSED_OPS.get(w.sfunction.name)
    if op is None or len(w.args) != 2:
        return None

    def _unwrap(e):
        # the planner wraps mismatched literal args in to_<type> calls
        # (reference: CallExpressionNode.cc:73-88); the raw payload
        # gates below reject any case where the conversion would wrap
        if (
            isinstance(e, CallExpressionNode)
            and e.sfunction.name in ("to_uint64", "to_int64", "to_timestamp64")
            and len(e.args) == 1
            and isinstance(e.args[0], LiteralExpressionNode)
        ):
            return e.args[0]
        return e

    a, b = _unwrap(w.args[0]), _unwrap(w.args[1])
    if isinstance(a, ColumnReferenceNode) and isinstance(
        b, LiteralExpressionNode
    ):
        col, lit = a, b
    elif isinstance(b, ColumnReferenceNode) and isinstance(
        a, LiteralExpressionNode
    ):
        col, lit = b, a
        op = _FUSED_FLIP[op]
    else:
        return None
    if col.column_index is None:
        return None
    sv = lit.value
    if getattr(sv, "is_null", False):
        return None
    payload = sv.payload() if hasattr(sv, "payload") else sv
    if isinstance(payload, bool) or not isinstance(payload, int):
        return None
    idx = col.column_index
    host_c = name_to_col.get(scan.input_columns[idx][0])
    if host_c is None or not _fused_pred_eligible(host_c, col.return_type()):
        return None
    unsigned = col.return_type() in (SType.UINT64, SType.TIMESTAMP64)
    if not (_I32_MIN < payload < (1 << 31)):
        return None
    if unsigned and payload < 0:
        return None
    return (idx, op, int(payload))


def _index_add_aggregate(mask, gid, vals, kinds, num_buckets):
    """count / sum per bucket with ``index_add_`` on int64 bit patterns:
    the leftover multi-sum shapes (computed or signed sum arguments),
    which the TPU build served with its XLA one-hot aggregate, not with
    a hand-written kernel."""
    ok = mask & (gid >= 0) & (gid < num_buckets)
    idx = gid[ok].to(torch.int64)
    counts = torch.zeros(num_buckets, dtype=torch.int64, device=gid.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    outs = []
    for v, kind in zip(vals, kinds):
        if kind == "count":
            outs.append(counts)
        else:
            s = torch.zeros(num_buckets, dtype=torch.int64, device=gid.device)
            s.index_add_(0, idx, v[ok])
            outs.append(s)
    return counts, tuple(outs)


def try_execute_string_groupby(
    node: qn.GroupByNode, txn
) -> Optional[Relation]:
    """Fast route for the canonical analytics shape:

        SELECT key, agg(...), ... FROM t [WHERE ...] GROUP BY key

    where `key` is a dictionary-encoded STRING column (the dictionary
    bounds the bucket count statically) OR a NUMERIC column whose cached
    min/max stats bound its span to <= K_CAP distinct buckets (narrowed
    u16/i16/u32/i32 storage; bucket = key - min, subtracted in-kernel
    via the gid_base scalar). The whole query runs as one aggregation
    kernel (kernels/groupby_agg); count-only shapes take the
    no-value-stream form. Numeric keys require the fully-fused form
    (all-valid key column); anything else returns None and falls
    through to the host engine."""
    from eventql_tpu_torch.exec.operators import _count_subject, _strip_aggregates

    device = txn.device
    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return None
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return None
    if scan.keyrange is not None:
        return None  # partition-scoped: host path applies the range
    if len(node.group_exprs) != 1:
        return None

    # group key must resolve to a plain input column
    g = node.group_exprs[0]
    if not isinstance(g, ColumnReferenceNode) or g.column_index is None:
        return None
    key_sl = scan.select_list[g.column_index]
    if not isinstance(key_sl.expr, ColumnReferenceNode):
        return None
    key_stype = key_sl.expr.return_type()
    if key_stype not in (
        SType.STRING,
        SType.UINT64,
        SType.INT64,
        SType.TIMESTAMP64,
    ):
        return None
    key_input_idx = key_sl.expr.column_index

    if scan.where_expr is not None and not torch_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    # select entries: key passthrough or sum/count aggregates over
    # device-compatible numeric args
    entries = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if kind not in ("sum", "count"):
                    return None
                if kind == "sum":
                    arg = a.args[0]
                    if not torch_expr.expr_is_device_compatible(arg):
                        return None
                    # u64 accumulation is exact for uint64 and (via
                    # two's-complement wraparound) int64; floats are not
                    if a.sfunction.return_type not in (
                        SType.UINT64,
                        SType.INT64,
                        SType.TIMESTAMP64,
                    ):
                        return None
                if kind == "count" and _count_subject(a) is not None:
                    subj = _count_subject(a)
                    if not torch_expr.expr_is_device_compatible(subj):
                        return None
            if not torch_expr.expr_is_device_compatible(emit):
                return None
            entries.append(("agg", emit, aggs))
        else:
            e = sl.expr
            if (
                isinstance(e, ColumnReferenceNode)
                and e.column_index == g.column_index
            ):
                entries.append(("key", None, None))
            else:
                return None

    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    if not _scan_inputs_present(table, scan):
        return None
    name_to_col = dict(zip(table.names, table.columns))
    key_col = name_to_col[scan.input_columns[key_input_idx][0]]
    key_base = 0
    if key_stype == SType.STRING:
        K = len(key_col.dictionary)
        if K == 0 or K > K_CAP:
            return None
        num_buckets = K + 1  # bucket K = the NULL-key group
    else:
        # numeric key: the narrowing pass's cached min/max stats bound
        # the span; bucket = key - min (in-kernel gid_base subtract).
        # Requires the fully-fused route (checked below) and an
        # all-valid key column (no NULL bucket).
        nd = _narrow_np(key_col)
        stats = getattr(key_col, "_stats_cache", None)
        if stats is None or nd.dtype.itemsize > 4:
            return None
        mn, mx = stats
        K = mx - mn + 1
        if K <= 0 or K > K_CAP:
            return None
        if not _column_all_valid(key_col):
            return None
        key_base = mn
        num_buckets = K

    in_cols = _to_device_cols(
        table.columns, table.names, scan.input_columns, device
    )

    # static plan metadata for the host-side emit (independent of data)
    layout = []
    entries_aggs_rtypes = {}
    kinds_static = []
    for tag, emit, aggs in entries:
        if tag != "agg":
            layout.append(("key", None, None))
            continue
        idxs = []
        for a in aggs:
            kind = a.sfunction.aggregate.kind
            kinds_static.append("count" if kind == "count" else "sum")
            idxs.append(len(kinds_static) - 1)
            entries_aggs_rtypes[(id(emit), len(idxs) - 1)] = (
                a.sfunction.return_type
            )
        layout.append(("agg", emit, idxs))
    if not kinds_static:
        kinds_static = ["count"]

    # column-statistics hint: the physically-narrowed device dtype of
    # the summed source column statically bounds the value width (the
    # narrowing pass already consulted the column's min/max)
    value_bits = 64
    sum_src_idx = None  # input-column index of a plain-colref summed col
    for (tag, emit, aggs) in entries:
        if tag != "agg":
            continue
        for a in aggs:
            if a.sfunction.aggregate.kind != "sum":
                continue
            arg = a.args[0]
            if (
                isinstance(arg, ColumnReferenceNode)
                and arg.column_index is not None
            ):
                src_e = scan.select_list[arg.column_index].expr
                if (
                    isinstance(src_e, ColumnReferenceNode)
                    and src_e.column_index is not None
                ):
                    dc = in_cols[src_e.column_index]
                    if dc.stype in (SType.UINT64, SType.TIMESTAMP64):
                        value_bits = dc.data.element_size() * 8
                        sum_src_idx = src_e.column_index
    distinct_sums = sum(1 for k in kinds_static if k == "sum")

    # multi-sum plan: 2+ summed columns share ONE pass
    # (kernels/groupby_agg.groupby_multi_agg, up to MAX_SUMS streams).
    # Streams must be plain-colref
    # unsigned columns whose narrowed width fits a 32-bit word (u16 ->
    # 2 bytes, u32 -> 4; signed narrows are excluded: the kernel reads
    # the word's low bits as an unsigned payload, so negative values
    # would lose their sign extension).
    multi_cfg = None
    if distinct_sums >= 2 and set(kinds_static) <= {"sum", "count"}:
        srcs = []
        for (tag, _emit, aggs) in entries:
            if tag != "agg" or srcs is None:
                continue
            for a in aggs:
                if a.sfunction.aggregate.kind != "sum":
                    continue
                arg = a.args[0]
                src_e = None
                if (
                    isinstance(arg, ColumnReferenceNode)
                    and arg.column_index is not None
                ):
                    src_e = scan.select_list[arg.column_index].expr
                if (
                    src_e is None
                    or not isinstance(src_e, ColumnReferenceNode)
                    or src_e.column_index is None
                ):
                    srcs = None
                    break
                dc = in_cols[src_e.column_index]
                if (
                    dc.stype not in (SType.UINT64, SType.TIMESTAMP64)
                    or dc.data.element_size() > 4
                ):
                    srcs = None
                    break
                srcs.append((src_e.column_index, dc.data.element_size()))
        if srcs and len(srcs) <= kernels.MAX_SUMS:
            multi_cfg = tuple(srcs)

    # fused-kernel route: one sum (+any counts), narrowable value
    # stream, WHERE fusable as an in-kernel compare (or absent).
    fused_cfg = None
    count_only = distinct_sums == 0
    sum_fusable = (
        distinct_sums == 1 and sum_src_idx is not None and value_bits <= 32
    )
    if (sum_fusable or count_only) and set(kinds_static) <= {"sum", "count"}:
        conjuncts, fused_combine = _match_fused_where(scan, name_to_col)
        # map each conjunct's column to its kernel operand source: the
        # summed column itself rides "value" mode (no second stream); a
        # missing WHERE in a count-only query compares on the key
        # stream ("gid" mode); a general predicate ("mask") is computed
        # by torch_expr; anything else streams
        specs = []
        for pred_idx, pred_op, thr in conjuncts:
            if pred_idx == "mask":
                specs.append(("mask", pred_op, thr))
            elif pred_idx is not None and pred_idx == sum_src_idx:
                specs.append(("value", pred_op, thr))
            elif pred_idx is None and count_only:
                specs.append(("gid", pred_op, thr))
            elif pred_idx is None:
                specs.append(("value", pred_op, thr))
            else:
                specs.append((pred_idx, pred_op, thr))
        fused_cfg = (tuple(specs), fused_combine)
    if key_stype != SType.STRING and fused_cfg is None:
        return None  # numeric keys only take the fully-fused form
    key_all_valid = (
        _column_all_valid(key_col) if fused_cfg else False
    ) or key_stype != SType.STRING

    key_dev = in_cols[key_input_idx]
    if fused_cfg is not None:
        global FUSED_GROUPBY_COUNT
        FUSED_GROUPBY_COUNT += 1
        packed = _run_fused(
            fused_cfg, scan, in_cols, key_dev, key_all_valid, key_base, K,
            num_buckets, sum_src_idx, value_bits, kinds_static, n, device,
        )
    else:
        if multi_cfg is not None:
            global MULTI_SUM_GROUPBY_COUNT
            MULTI_SUM_GROUPBY_COUNT += 1
        packed = _run_masked(
            scan, in_cols, g, key_dev, _column_all_valid(key_col), entries,
            kinds_static, distinct_sums, multi_cfg, K, num_buckets,
            value_bits, n, device,
        )

    # ONE device->host copy of the packed [counts, out0, ...] stack
    packed_h = packed.cpu().numpy().view(np.uint64)
    counts_h, outs_h = packed_h[0], list(packed_h[1:])
    occupied = np.nonzero(counts_h > 0)[0]
    ng = len(occupied)

    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector

    out_cols = []
    for tag, emit, idxs in layout:
        if tag == "key":
            if key_stype == SType.STRING:
                # bucket K is the NULL group: id 0 placeholder, valid
                # False
                is_null_grp = occupied == K
                out_cols.append(
                    Column(
                        SType.STRING,
                        np.where(is_null_grp, 0, occupied).astype(np.int32),
                        ~is_null_grp,
                        key_col.dictionary,
                    )
                )
            else:
                # numeric key: bucket id -> key value (base + id); the
                # route requires all-valid keys, so no NULL group
                payload = (
                    occupied.astype(np.int64) + np.int64(key_base)
                    if key_stype == SType.INT64
                    else occupied.astype(np.uint64) + np.uint64(key_base)
                )
                out_cols.append(
                    Column(
                        key_stype,
                        payload.astype(dtype_for(key_stype)),
                        np.ones(ng, bool),
                    )
                )
        else:
            agg_cols = []
            for slot, i in enumerate(idxs):
                rtype = entries_aggs_rtypes[(id(emit), slot)]
                data = outs_h[i][occupied].astype(np.uint64)
                if rtype == SType.INT64:
                    data = data.view(np.int64)
                agg_cols.append(
                    Column(rtype, data, np.ones(ng, bool))
                )
            ctx = EvalContext(agg_cols, ng)
            out_cols.append(evaluate_vector(emit, ctx))

    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


def _run_fused(fused_cfg, scan, in_cols, key_dev, key_all_valid, key_base, K,
               num_buckets, sum_src_idx, value_bits, kinds_static, n, device):
    """Fully-fused form: WHERE compare(s) + base subtract + aggregation
    in ONE kernel pass over the raw narrowed streams. Returns the packed
    int64[1 + len(kinds), num_buckets] stack (counts first)."""
    fused_specs, fused_comb = fused_cfg
    gid = key_dev.data
    gid_unsigned = torch_expr.is_unsigned(key_dev.stype)
    if not key_all_valid:
        # NULL keys take their own bucket K (the tag participates in
        # the reference's group key, groupby.cc:129-135)
        gid = torch.where(
            key_dev.valid,
            torch_expr._widen(key_dev).data,
            torch.tensor(K, dtype=torch.int32, device=device),
        )
        gid_unsigned = False

    preds = []
    for src, op, thr in fused_specs:
        if src == "mask":
            # general predicate: evaluate the WHERE over the device
            # columns -> 0/1 byte stream; the kernel compares it >= 1
            m = torch_expr.compile_expr(scan.where_expr, in_cols, n, device)
            stream = m.data.expand(n).contiguous()
            preds.append(kernels.Pred("stream", op, thr, stream))
        elif isinstance(src, int):
            pc = in_cols[src]
            preds.append(
                kernels.Pred(
                    "stream", op, thr, pc.data, torch_expr.is_unsigned(pc.stype)
                )
            )
        else:
            preds.append(kernels.Pred(src, op, thr))

    values = in_cols[sum_src_idx].data if sum_src_idx is not None else None
    out = kernels.groupby_agg(
        gid,
        n,
        num_buckets,
        values=values,
        value_bits=value_bits,
        preds=preds,
        combine=fused_comb,
        # the kernel subtracts the base modularly in 32 bits (exact for
        # spans < 2^31 even when u32 payloads read as negative int32)
        gid_base=key_base,
        gid_unsigned=gid_unsigned,
        values_unsigned=True,
    )
    counts = out[0]
    sums = out[1] if values is not None else counts
    return torch.stack(
        [counts, *(counts if k == "count" else sums for k in kinds_static)]
    )


class _LazyScanCols:
    """The scan's select list as device columns, each evaluated when it
    is first indexed: a query reads few of them, and an eager pass would
    widen every narrowed column to 64 bits for nothing."""

    def __init__(self, scan, in_cols, n, device):
        self._scan, self._in_cols, self._n, self._device = scan, in_cols, n, device
        self._cols = {}

    def __getitem__(self, i):
        col = self._cols.get(i)
        if col is None:
            col = self._cols[i] = torch_expr.compile_expr(
                self._scan.select_list[i].expr, self._in_cols, self._n,
                self._device,
            ).full(self._n)
        return col


def _run_masked(scan, in_cols, g, key_in, key_all_valid, entries, kinds_static,
                distinct_sums, multi_cfg, K, num_buckets, value_bits, n, device):
    """Non-fused forms: the WHERE mask, the key ids and the summed
    expressions come from torch_expr; the aggregation is one kernel
    pass (single sum / count-only / multi-sum) or, for the leftover
    multi-sum shapes, index_add_. Returns the packed stack."""
    scan_cols = _LazyScanCols(scan, in_cols, n, device)
    mask = None
    if scan.where_expr is not None:
        mask = (
            torch_expr.compile_expr(scan.where_expr, in_cols, n, device)
            .data.expand(n)
            .contiguous()
        )

    # bucket = dictionary id; NULL keys get their own bucket K (NULL
    # and b"" group separately: the tag participates in the
    # reference's group key, groupby.cc:129-135 / SURVEY A.8)
    if key_all_valid:
        gid = key_in.data  # no NULL bucket needed: the narrow ids as stored
    else:
        key_dev = scan_cols[g.column_index]
        gid = torch.where(
            key_dev.valid,
            key_dev.data.to(torch.int32),
            torch.tensor(K, dtype=torch.int32, device=device),
        )

    def sum_values():
        vals = []
        for tag, _emit, aggs in entries:
            if tag != "agg":
                continue
            for a in aggs:
                if a.sfunction.aggregate.kind == "count":
                    # count(x) counts every accumulated row, NULL or
                    # not (reference: aggregate.cc:35-38)
                    vals.append(None)
                else:
                    c = torch_expr.compile_expr(a.args[0], scan_cols, n, device)
                    vals.append(c.data.expand(n).to(torch.int64).contiguous())
        return vals

    if distinct_sums <= 1:
        sum_vals = next((v for v in sum_values() if v is not None), None)
        out = kernels.groupby_agg(
            gid, n, num_buckets, values=sum_vals, value_bits=value_bits,
            mask=mask,
        )
        counts = out[0]
        outs = tuple(counts if k == "count" else out[1] for k in kinds_static)
    elif multi_cfg is not None:
        # 2+ sums in ONE pass: `sum(a), sum(b), count(*) GROUP BY k`
        streams = [in_cols[src].data for src, _nb in multi_cfg]
        out = kernels.groupby_multi_agg(
            gid, n, num_buckets, streams,
            [8 * nb for _src, nb in multi_cfg],
            mask=mask, streams_unsigned=[True] * len(streams),
        )
        counts = out[0]
        sums = iter(out[1:])
        outs = tuple(
            counts if k == "count" else next(sums) for k in kinds_static
        )
    else:
        # remaining multi-sum shapes (computed/signed sum args)
        if mask is None:
            mask = torch.ones(n, dtype=torch.bool, device=device)
        counts, outs = _index_add_aggregate(
            mask, gid, sum_values(), kinds_static, num_buckets
        )
    return torch.stack([counts, *outs])


# -- the general GROUP BY on device (hash aggregate) --------------------------
# Every scan-child GROUP BY the string route declines: min / max / mean /
# count_distinct, float sums, several or computed keys, numeric keys of
# any span. The counterpart of eventql_tpu/exec/device_exec.py:
# device_plan_eligible + execute_device_groupby; the grouping is the hash
# aggregate of kernels/hash_groupby.py on a CUDA device and its plain
# version (kernels/groupby.py) on the CPU device.

_DEVICE_AGGS = {"sum", "count", "count_distinct", "min", "max", "mean"}
# general GROUP BY route (execute_device_groupby)
GENERAL_GROUPBY_COUNT = 0


def device_plan_eligible(node) -> bool:
    """Does the general route take this GROUP BY? (The JAX route's gate,
    every clause kept.)"""
    from eventql_tpu_torch.exec.operators import _strip_aggregates

    compatible = torch_expr.expr_is_device_compatible
    if not isinstance(node, qn.GroupByNode):
        return False
    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return False
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return False
    if scan.keyrange is not None:
        # partition-scoped: the route reads whole cached columns and
        # would ignore the keyrange filter; the host path applies it
        return False
    # STRING columns flow as dictionary ids: only plain column refs
    for sl in scan.select_list:
        if not compatible(sl.expr):
            return False
        if sl.expr.return_type() == SType.STRING and not isinstance(
            sl.expr, ColumnReferenceNode
        ):
            return False
    for g in node.group_exprs:
        if g.return_type() == SType.STRING and not isinstance(
            g, ColumnReferenceNode
        ):
            return False
    if scan.where_expr is not None and not compatible(scan.where_expr):
        return False
    for g in node.group_exprs:
        if not compatible(g):
            return False
    # aggregates of device exprs; other entries are evaluated on each
    # group's first row
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if kind not in _DEVICE_AGGS:
                    return False
                if a.args and not compatible(a.args[0]):
                    return False
                if (
                    kind == "count_distinct"
                    and a.args
                    and a.args[0].return_type() == SType.FLOAT64
                ):
                    # the host truncates float payloads with uint64
                    # casts; the device would count bit patterns
                    return False
            if not compatible(emit):
                return False
        elif not compatible(sl.expr):
            return False
    return True


def _stored_input(expr, scan):
    """The input column a scan-output reference reads unchanged, or None."""
    if isinstance(expr, ColumnReferenceNode) and expr.column_index is not None:
        src = scan.select_list[expr.column_index].expr
        if isinstance(src, ColumnReferenceNode) and src.column_index is not None:
            return src.column_index
    return None


def _group_key(g, scan, in_cols, host_cols, scan_cols, n, device):
    """(key stream, validity or None where every row is valid, span) of
    one group expression: a plain column as it is stored (narrowed
    streams compare by their own bits) with its ``_stored_span``, else
    the expression's value, with no span. A NULL key's bits are 0; its
    tag goes to the tag word."""
    idx = _stored_input(g, scan)
    if idx is not None:
        dc, hc = in_cols[idx], host_cols[idx]
        if _column_all_valid(hc):
            return dc.data, None, _stored_span(hc)
        data, valid, span = dc.data, dc.valid, _stored_span(hc, nullable=True)
    else:
        c = torch_expr.compile_expr(g, scan_cols, n, device)
        data, valid, span = c.data, c.valid, None
    data = torch.where(valid, data, torch.zeros((), dtype=data.dtype, device=device))
    return data.expand(n).contiguous(), valid.expand(n), span


def _null_tags(valids, n, device):
    """One int64 word a row: bit i set where key i is NULL; and its span,
    the bits up to the highest nullable key's."""
    tags = torch.zeros(n, dtype=torch.int64, device=device)
    for i, v in valids:
        tags |= (~v).to(torch.int64) << i
    return tags, (0, 1 << (max(i for i, _v in valids) + 1), False)


def _agg_stream(expr, scan, in_cols, scan_cols, n, device):
    """(stream, unsigned) of one aggregate argument: a plain numeric
    column as it is stored (a narrowed unsigned one zero-extends in the
    kernel), else the expression's value as int64 / float64. ``unsigned``
    makes a 64-bit min / max take the unsigned order."""
    idx = _stored_input(expr, scan)
    if idx is not None and in_cols[idx].stype in (*_INT_STYPES, SType.FLOAT64):
        dc = in_cols[idx]
        return dc.data, torch_expr.is_unsigned(dc.stype)
    c = torch_expr.compile_expr(expr, scan_cols, n, device)
    data = c.data.expand(n)
    if data.dtype not in (torch.int64, torch.float64):
        data = data.to(torch.int64)
    return data.contiguous(), torch_expr.is_unsigned(c.stype)


def _aggregate_inputs(calls, scan, in_cols, host_cols, scan_cols, n, device):
    """The kernel's value and count_distinct streams for ``calls``, pairs
    of an aggregate call and the expression it reduces, the span of each
    count_distinct payload (a stored column's: ``_stored_span``; else
    None), and where each call's result lies: ("count",),
    ("agg", j, is_float) or ("distinct", j)."""
    values, kinds, unsigned, distinct, spans, where = [], [], [], [], [], []
    for a, subj in calls:
        kind = a.sfunction.aggregate.kind
        if kind == "count" or subj is None:
            # count(x) counts every row, NULL or not (aggregate.cc:35-38)
            where.append(("count",))
            continue
        stream, uns = _agg_stream(subj, scan, in_cols, scan_cols, n, device)
        if kind == "count_distinct":
            where.append(("distinct", len(distinct)))
            distinct.append(stream)
            idx = _stored_input(subj, scan)
            stored = idx is not None and stream is in_cols[idx].data
            spans.append(_stored_span(host_cols[idx]) if stored else None)
            continue
        where.append(("agg", len(values), stream.dtype == torch.float64))
        values.append(stream)
        kinds.append(kind)
        unsigned.append(uns)
    return values, kinds, unsigned, distinct, spans, where


# a span beyond this is no span: the direct tiers end far below it, and
# its size and base stay 64-bit integers
_MAX_SPAN = 1 << 62


def _stored_span(c: Column, nullable: bool = False):
    """``(base, span, unsigned)`` that every value of a stored column lies
    in, from what the column cache already knows: a STRING's dictionary
    size, a bool's two values, an integer column's min / max (cached by
    ``_narrow_np_build`` over its data, NULL filler included); None where
    nothing bounds it. ``nullable``: the route reads a NULL key as 0, so
    the span is widened to cover 0."""
    if c.stype == SType.STRING:
        lo, hi = 0, max(1, len(c.dictionary)) - 1
    elif c.stype == SType.BOOL:
        lo, hi = 0, 1
    elif c.stype in _INT_STYPES and getattr(c, "_stats_cache", None) is not None:
        lo, hi = c._stats_cache
    else:
        return None
    if nullable:
        lo, hi = min(lo, 0), max(hi, 0)
    if hi - lo + 1 > _MAX_SPAN:
        return None
    return (lo, hi - lo + 1, torch_expr.is_unsigned(c.stype))


def _grouped_to_host(res, extra=()):
    """ONE device->host copy of a Grouped (and of ``extra`` int64[G]
    rows): (first rows, counts, aggregates, distinct counts, extra rows),
    the groups in the order of their first rows; empty slots (count 0,
    from the direct tiers) dropped."""
    from eventql_tpu_torch.kernels.sort import read_host

    rows = [res.first_index, res.counts, *extra]
    rows += [a.view(torch.int64) if a.dtype == torch.float64 else a for a in res.aggregates]
    rows += list(res.distinct)
    packed = read_host(torch.stack(rows)) if res.first_index.numel() else (
        np.zeros((len(rows), 0), np.int64))
    occupied = np.nonzero(packed[1] > 0)[0]
    packed = packed[:, occupied[np.argsort(packed[0][occupied], kind="stable")]]
    ne = len(extra)
    na = len(res.aggregates)
    return (packed[0], packed[1], packed[2:2 + ne], packed[2 + ne:2 + ne + na],
            packed[2 + ne + na:])


def _agg_columns(calls, where, counts, aggs, distinct):
    """Host Columns of the aggregate calls, typed as the calls return."""
    cols = []
    ng = len(counts)
    for a, w in zip(calls, where):
        if w[0] == "count":
            arr = counts.view(np.uint64)
        elif w[0] == "distinct":
            arr = distinct[w[1]].view(np.uint64)
        else:
            arr = aggs[w[1]].view(np.float64 if w[2] else np.uint64)
        rtype = a.sfunction.return_type
        cols.append(Column(rtype, arr.astype(dtype_for(rtype)), np.ones(ng, bool)))
    return cols


def execute_device_groupby(node: qn.GroupByNode, txn) -> Optional[Relation]:
    """Scan -> WHERE -> GROUP BY as a hash aggregate on the device, for
    plans that ``device_plan_eligible`` admits.

    The WHERE, the keys and the aggregate arguments evaluate in
    torch_expr (plain stored columns go as they are, with the spans the
    column cache knows: ``_stored_span``); one ``hash_groupby`` call
    groups and aggregates, in the tier those spans allow; only
    O(groups) leaves the device, in one copy (after the group count in
    the hash tier). Groups come in the
    order of their first rows (the host engine's), and entries that are
    not aggregates are evaluated by the host evaluator on those rows.
    Returns None on empty tables (the host path builds the typed empty
    relation / ungrouped row) and on more key columns than the kernel
    takes."""
    from eventql_tpu_torch.exec.operators import _strip_aggregates
    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu_torch.kernels.hash_groupby import MAX_KEYS, hash_groupby

    scan: qn.SequentialScanNode = node.table
    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    if not _scan_inputs_present(table, scan):
        return None
    if len(node.group_exprs) >= MAX_KEYS:
        return None  # no room for the tag word: the host engine
    global GENERAL_GROUPBY_COUNT
    GENERAL_GROUPBY_COUNT += 1
    device = txn.device
    in_cols = _to_device_cols(table.columns, table.names, scan.input_columns, device)
    by_name = dict(zip(table.names, table.columns))
    host_cols = [by_name[cname] for cname, _t in scan.input_columns]
    scan_cols = _LazyScanCols(scan, in_cols, n, device)

    entries = []
    calls: List[CallExpressionNode] = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)  # refs count from 0
            entries.append(("agg", emit, len(calls)))
            calls.extend(aggs)
        else:
            entries.append(("first", sl.expr, None))

    mask = None
    if scan.where_expr is not None:
        mask = (
            torch_expr.compile_expr(scan.where_expr, in_cols, n, device)
            .data.expand(n)
            .contiguous()
        )
    keys, valids, spans = [], [], []
    for i, g in enumerate(node.group_exprs):
        data, valid, span = _group_key(g, scan, in_cols, host_cols, scan_cols, n, device)
        keys.append(data)
        spans.append(span)
        if valid is not None:
            valids.append((i, valid))
    if valids:
        tags, span = _null_tags(valids, n, device)
        keys.append(tags)
        spans.append(span)
    values, kinds, unsigned, distinct, dspans, where = _aggregate_inputs(
        [(a, a.args[0] if a.args else None) for a in calls], scan, in_cols, host_cols,
        scan_cols, n, device)
    res = hash_groupby(keys, n, mask, values, kinds, unsigned, distinct, spans, dspans)
    first, counts, _extra, aggs, dist = _grouped_to_host(res)
    ng = len(first)
    agg_cols = _agg_columns(calls, where, counts, aggs, dist)

    scan_rows = []
    if any(tag == "first" for tag, _e, _b in entries):
        # each group's first row, through the host evaluator
        ctx = EvalContext([c.gather(first) for c in host_cols], ng)
        scan_rows = [evaluate_vector(sl.expr, ctx) for sl in scan.select_list]
    out_cols: List[Column] = []
    for tag, expr, base in entries:
        if tag == "agg":
            out_cols.append(evaluate_vector(expr, EvalContext(agg_cols[base:], ng)))
        else:
            out_cols.append(evaluate_vector(expr, EvalContext(scan_rows, ng)))
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


# -- SELECT ... ORDER BY ... [LIMIT] on device (scan + sort / top-k) ----------


def _dictionary_sorted(c: Column) -> bool:
    """True when the column dictionary is in ascending byte order (the
    ingest paths build dictionaries with np.unique, which sorts), so
    dictionary ids are order-preserving ranks. Cached per Column."""
    cached = getattr(c, "_dict_sorted_cache", None)
    if cached is None:
        e = c.dictionary
        cached = all(e[i] <= e[i + 1] for i in range(len(e) - 1))
        try:
            c._dict_sorted_cache = cached
        except AttributeError:
            pass
    return cached


def _device_host_order_key(c: "torch_expr.DeviceCol", descending: bool, null_rank):
    """u64 keys (int64 bit patterns) whose ascending unsigned order
    equals the host engine's sort order for this column
    (operators._sort_key_arrays + its descending transforms):
      - NULL numerics sort as 0 of the dtype; NULL strings sort as the
        literal "NULL" among the dictionary entries (null_rank is the
        precomputed host rank of that label);
      - floats: -0.0 ties +0.0 (host compares values) and NaN sorts
        LAST in both directions (np.lexsort semantics); the key is made
        from the value's own 64 bits on the device;
      - descending is an order-reversing bijection (no INT64_MIN wrap).
    """
    from eventql_tpu_torch.kernels.groupby import sortable_u64

    if c.stype == SType.STRING:
        d = c.data.to(torch.int64)
        rank = torch.where(c.valid, d + (d >= null_rank).to(torch.int64), null_rank)
        return ~rank if descending else rank
    zero = torch.zeros((), dtype=c.data.dtype, device=c.data.device)
    x = torch.where(c.valid, c.data, zero)
    if x.dtype == torch.float64:
        x = x + 0.0  # -0.0 -> +0.0: host value-compare ties
        k = sortable_u64(x, descending=descending)
        return torch.where(torch.isnan(x), -1, k)  # all 64 bits set: last
    return sortable_u64(
        x, descending=descending, unsigned=torch_expr.is_unsigned(c.stype)
    )


def _emit_scan_rows(scan, table, cand: "np.ndarray", lo=0, hi=None) -> Relation:
    """Materialize the chosen rows through the HOST evaluator: the
    device decided only the ORDER (indices); values/formatting come
    from the exact host expression path, so no output-transport
    divergence is possible."""
    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector

    cand = cand[lo:hi]
    name_to_col = dict(zip(table.names, table.columns))
    in_rows = [name_to_col[cname].gather(cand) for cname, _t in scan.input_columns]
    ctx = EvalContext(in_rows, len(cand))
    out_cols = [evaluate_vector(sl.expr, ctx) for sl in scan.select_list]
    names = [sl.column_name() for sl in scan.select_list]
    return Relation(names, out_cols, len(cand))


_M64 = 0xFFFFFFFFFFFFFFFF
# static [lo, hi] bound of the u64 host-order key of a plain column
# reference, by the column's physically-narrowed dtype
_NARROW_BOUNDS = {
    np.dtype(np.uint16): (0, 0xFFFF),
    np.dtype(np.uint32): (0, 0xFFFFFFFF),
    np.dtype(np.int16): ((1 << 63) - (1 << 15), (1 << 63) + (1 << 15) - 1),
    np.dtype(np.int32): ((1 << 63) - (1 << 31), (1 << 63) + (1 << 31) - 1),
    np.dtype(np.bool_): (0, 1),
}


def _prep_device_scan_order(order_node: qn.OrderByNode, txn):
    """Shared front half of the device ORDER BY routes: eligibility,
    table fetch, scan/WHERE evaluation, host-order key construction.
    Returns (scan, table, mask, keys, n) or None; mask is None when the
    scan has no WHERE."""
    import bisect

    scan = order_node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return None
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return None
    if scan.keyrange is not None:
        return None  # partition-scoped: host path applies the range
    specs = order_node.sort_specs
    if not specs:
        return None
    if scan.where_expr is not None and not torch_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    # select entries referenced by the sort exprs (only those evaluate
    # on device; the full select list is materialized by the host for
    # just the winning rows)
    needed = set()
    stack = [s.expr for s in specs]
    while stack:
        e = stack.pop()
        if isinstance(e, ColumnReferenceNode):
            if e.column_index is None or e.column_index >= len(scan.select_list):
                return None
            needed.add(e.column_index)
        stack.extend(e.arguments())
    for s in specs:
        if not torch_expr.expr_is_device_compatible(s.expr):
            return None
        if s.expr.return_type() == SType.STRING and not isinstance(
            s.expr, ColumnReferenceNode
        ):
            return None
    for i in needed:
        e = scan.select_list[i].expr
        if not torch_expr.expr_is_device_compatible(e):
            return None
        if e.return_type() == SType.STRING and not isinstance(
            e, ColumnReferenceNode
        ):
            return None

    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    if not _scan_inputs_present(table, scan):
        return None
    name_to_col = dict(zip(table.names, table.columns))

    # STRING sort keys ride dictionary ids; ids are order-preserving
    # only for sorted dictionaries, and the host sorts NULL as the
    # literal "NULL" among the entries (operators._sort_key_arrays).
    null_ranks = [None] * len(specs)
    # static [lo, hi] bound on each u64 host-order key (pre-descending):
    # string ranks are bounded by the dictionary size, and plain-ref
    # numeric keys by the column's physically-narrowed dtype. A bounded
    # key downcasts to 32 bits after the descending flip: half the bytes
    # for every sort and histogram pass over it.
    bounds = [None] * len(specs)
    for si, s in enumerate(specs):
        rt = s.expr.return_type()
        if rt == SType.STRING:
            inner = scan.select_list[s.expr.column_index].expr
            src = name_to_col[scan.input_columns[inner.column_index][0]]
            if src.dictionary is None or not _dictionary_sorted(src):
                return None
            entries = list(src.dictionary.astype(bytes))
            null_ranks[si] = bisect.bisect_right(entries, b"NULL")
            bounds[si] = (0, len(entries))
        elif rt != SType.FLOAT64 and isinstance(s.expr, ColumnReferenceNode):
            inner = scan.select_list[s.expr.column_index].expr
            if isinstance(inner, ColumnReferenceNode) and (
                inner.column_index is not None
            ):
                src = name_to_col[scan.input_columns[inner.column_index][0]]
                bounds[si] = _NARROW_BOUNDS.get(_narrow_np(src).dtype)
        if bounds[si] is not None and s.descending:
            lo, hi = bounds[si]
            bounds[si] = ((~hi) & _M64, (~lo) & _M64)

    device = txn.device
    in_cols = _to_device_cols(
        table.columns, table.names, scan.input_columns, device
    )
    scan_cols = _LazyScanCols(scan, in_cols, n, device)
    mask = None
    if scan.where_expr is not None:
        mask = torch_expr.compile_expr(
            scan.where_expr, in_cols, n, device
        ).data.expand(n)
    keys = [
        _device_host_order_key(
            torch_expr.compile_expr(s.expr, scan_cols, n, device).full(n),
            s.descending,
            null_ranks[si],
        )
        for si, s in enumerate(specs)
    ]
    # downcast statically-bounded keys: (key - lo) is a strictly
    # monotonic bijection of [lo, hi] onto [0, hi - lo], a u32 held in
    # an int32 tensor; garbage values in filtered rows are harmless
    # because the leading filter-mask key sinks them and both routes
    # drop them
    for si, b in enumerate(bounds):
        if b is not None and b[1] - b[0] <= 0xFFFFFFFF:
            keys[si] = (keys[si] - torch_expr._fold_i64(b[0])).to(torch.int32)
    return scan, table, mask, keys, n


def _masked_order_rows(mask, keys, w: int) -> "np.ndarray":
    """The passing rows among the first ``w`` of the stable full sort
    whose leading key is the filter mask (passing rows first, then host
    order), as host row indices. The passing rows are a prefix of the
    permutation, so their count is read first and only that prefix
    leaves the device."""
    from eventql_tpu_torch.kernels.sort import order_permutation, read_host

    if mask is None:
        return read_host(order_permutation(keys)[:w])
    perm = order_permutation((~mask, *keys))
    n_pass = int(read_host(mask.sum()))
    return read_host(perm[: min(w, n_pass)])


def try_execute_device_scan_topk(node: qn.LimitNode, txn) -> Optional[Relation]:
    """SELECT ... FROM t [WHERE ...] ORDER BY ... LIMIT k on device.

    The scan + WHERE + sort keys evaluate on the device and the window
    comes from the histogram-threshold top-k (kernels/sort.py) for a
    single key, from the stable full sort for multi-key specs. Only the
    winning row INDICES leave the device; the host evaluator
    materializes those few rows.

    Filtered rows are excluded by forcing their top-key to 0. A passing
    row whose key is legitimately 0 (the very last value in host order,
    e.g. NaN or UINT64_MAX) can then tie with filtered rows, so the
    host verifies the window (all passing-zero rows captured) and
    reruns via the always-exact masked full sort when the rare corner
    trips. Returns None when the plan shape is not routable."""
    from eventql_tpu_torch.kernels.sort import read_host, topk_permutation

    order_node = node.table
    if not isinstance(order_node, qn.OrderByNode):
        return None
    w = node.offset + node.limit
    if w == 0:
        return None
    prep = _prep_device_scan_order(order_node, txn)
    if prep is None:
        return None
    global SCAN_TOPK_COUNT
    SCAN_TOPK_COUNT += 1
    scan, table, mask, keys, n = prep
    w = min(w, n)
    lo = node.offset
    hi = node.offset + node.limit

    if len(keys) == 1:
        # top-k fast path: host-FIRST row <-> LARGEST flipped key;
        # ties break toward the lowest row index = host stable order.
        # A statically-bounded (32-bit) key stays narrow: the histogram
        # top-k streams half the bytes (fast_topk_u32)
        k0 = keys[0]
        if mask is None:
            idx = topk_permutation(~k0, w)
            return _emit_scan_rows(scan, table, read_host(idx), lo, hi)
        ktop = torch.where(
            mask, ~k0, torch.zeros((), dtype=k0.dtype, device=k0.device)
        )
        npz = (mask & (ktop == 0)).sum()
        idx = topk_permutation(ktop, w)
        # ONE transfer: idx, window mask, window keys, zero-key count
        packed = read_host(
            torch.cat(
                [
                    idx,
                    mask[idx].to(torch.int64),
                    ktop[idx].to(torch.int64),
                    npz.reshape(1),
                ]
            )
        )
        idx_h = packed[:w]
        mask_w = packed[w : 2 * w] != 0
        kw = packed[2 * w : 3 * w]
        if bool(mask_w.all()):
            return _emit_scan_rows(scan, table, idx_h, lo, hi)
        # filtered rows in the window: exact iff every passing zero-key
        # row is inside it (rows outside then all have key 0)
        if int((mask_w & (kw == 0)).sum()) == int(packed[3 * w]):
            return _emit_scan_rows(scan, table, idx_h[mask_w], lo, hi)

    # multi-key specs / top-k corner: stable full sort with the filter
    # mask as the leading key (passing rows first, host order)
    return _emit_scan_rows(scan, table, _masked_order_rows(mask, keys, w), lo, hi)


def try_execute_device_scan_order(
    order_node: qn.OrderByNode, txn
) -> Optional[Relation]:
    """Full SELECT ... FROM t [WHERE ...] ORDER BY ... on device (no
    LIMIT above): the stable sort over order-preserving keys replaces
    the host's np.lexsort. The filter mask leads the key tuple so
    filtered rows sink; the host materializes the passing rows in
    order."""
    prep = _prep_device_scan_order(order_node, txn)
    if prep is None:
        return None
    global SCAN_ORDER_COUNT
    SCAN_ORDER_COUNT += 1
    scan, table, mask, keys, n = prep
    return _emit_scan_rows(scan, table, _masked_order_rows(mask, keys, n))


# -- SQL JOIN ... GROUP BY on device ------------------------------------------

# the join route serves every kind of _DEVICE_AGGS: integer sums and
# counts take its bounded branch (the aggregation kernels over the
# dimension buckets), the rest its general branch (the hash aggregate
# keyed by the bucket)
_INT_STYPES = (SType.UINT64, SType.INT64, SType.TIMESTAMP64)


def _join_ref(node, expr):
    """Resolve a join-input ColumnReferenceNode to its
    (table_idx, column_idx) or None."""
    if not isinstance(expr, ColumnReferenceNode):
        return None
    if expr.column_index is None:
        return None
    ref = node.input_map[expr.column_index]
    return ref.table_idx, ref.column_idx


def _rewrite_refs(expr, resolve, side: int):
    """``expr`` with every column ref replaced by the ref's column in
    one side's scan output, as ``resolve`` finds it; None if the
    expression touches the other side or anything but refs, calls and
    literals."""
    import copy

    if isinstance(expr, ColumnReferenceNode):
        r = resolve(expr)
        if r is None or r[0] != side:
            return None
        out = copy.copy(expr)
        out.column_index = r[1]
        return out
    if isinstance(expr, CallExpressionNode):
        new_args = []
        for a in expr.args:
            na = _rewrite_refs(a, resolve, side)
            if na is None:
                return None
            new_args.append(na)
        out = copy.copy(expr)
        out.args = new_args
        return out
    if isinstance(expr, LiteralExpressionNode):
        return expr
    return None


def _rewrite_join_refs(node, expr, side: int):
    """Rewrite a join-input expression to reference one side's output
    columns directly; returns None if it touches the other side."""
    return _rewrite_refs(expr, lambda e: _join_ref(node, e), side)


def _child_ref(join, expr):
    """Resolve a GroupBy-child-output ColumnReferenceNode through the
    join's select list to (table_idx, side_output_column_idx)."""
    if not isinstance(expr, ColumnReferenceNode):
        return None
    if expr.column_index is None:
        return None
    if expr.column_index >= len(join.select_list):
        return None
    jexpr = join.select_list[expr.column_index].expr
    return _join_ref(join, jexpr)


def _rewrite_child_refs(join, expr, side: int):
    """Rewrite a GroupBy-child-output expression into one side's output
    columns (two hops: child output -> join input map -> side output);
    returns None if it touches the other side or a non-ref join
    column."""
    return _rewrite_refs(expr, lambda e: _child_ref(join, e), side)


def join_groupby_analysis(node: qn.GroupByNode, txn):
    """Plan analysis of the fact-dim JOIN + GROUP BY device shape:
    eligibility, join / group column resolution, host evaluation of the
    dimension side, aggregate rewrites.

    Returns None when the plan is outside the subset (the host engine
    takes over): non-INNER joins, multi-conjunction conditions,
    joined-side WHERE, duplicate / NULL join keys, non-u64 keys,
    aggregates outside ``_DEVICE_AGGS``, count_distinct of a float,
    empty inputs. ``bounded`` says whether the bounded branch serves
    the aggregates (integer sums and counts only)."""
    from eventql_tpu_torch.exec.operators import (
        _factorize_rows,
        _find_join_conjunctions,
        _group_key_matrix,
        _strip_aggregates,
        execute_node,
    )

    join = node.table
    if not isinstance(join, qn.JoinNode):
        return None
    if join.join_type != qn.JoinNode.INNER:
        return None
    base, joined = join.base_table, join.joined_table
    for scan in (base, joined):
        if not isinstance(scan, qn.SequentialScanNode):
            return None
        if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
            return None
        if scan.keyrange is not None:
            return None  # partition-scoped: host path applies the range
    if join.join_cond is None or join.input_map is None:
        return None

    # exactly one equi conjunction of two bare column refs
    conjunctions = []
    _find_join_conjunctions(join, join.join_cond, conjunctions)
    if len(conjunctions) != 1:
        return None
    base_key_expr, joined_key_expr = conjunctions[0]
    bref = _join_ref(join, base_key_expr)
    jref = _join_ref(join, joined_key_expr)
    if bref is None or jref is None or bref[0] != 0 or jref[0] != 1:
        return None
    # the join condition must BE that single equality (no residual)
    cond = join.join_cond
    if not (isinstance(cond, CallExpressionNode) and cond.function_name == "eq"):
        return None

    # WHERE must be fact-side only
    where_base = None
    if join.where_expr is not None:
        where_base = _rewrite_join_refs(join, join.where_expr, 0)
        if where_base is None or not torch_expr.expr_is_device_compatible(
            where_base
        ):
            return None

    # single joined-side group expression (a child-output column ref)
    if len(node.group_exprs) != 1:
        return None
    gref = _child_ref(join, node.group_exprs[0])
    if gref is None or gref[0] != 1:
        return None

    # select list: aggregates over fact-side exprs, or the group column
    entries = []
    all_aggs = []
    bounded = True
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            rewritten = []
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if kind not in _DEVICE_AGGS:
                    return None
                subj = a.args[0] if a.args else None
                if kind == "count" or subj is None:
                    # counts every joined row, NULL args included
                    # (aggregate.cc:35-38)
                    rewritten.append((a, "count", None))
                    continue
                rsubj = _rewrite_child_refs(join, subj, 0)
                if rsubj is None or not torch_expr.expr_is_device_compatible(
                    rsubj
                ):
                    return None
                if kind == "count_distinct" and rsubj.return_type() == SType.FLOAT64:
                    return None  # host truncation parity (device_plan_eligible)
                # u64 accumulation is exact for uint64 and (two's
                # complement) int64: the bounded branch; anything else
                # (a float sum, min, max, mean, count_distinct) the general
                bounded = bounded and (
                    kind == "sum"
                    and a.sfunction.return_type in _INT_STYPES
                    and rsubj.return_type() in _INT_STYPES
                )
                rewritten.append((a, kind, rsubj))
            base_i = len(all_aggs)
            all_aggs.extend(rewritten)
            entries.append(("agg", emit, base_i))
        else:
            r = _child_ref(join, sl.expr)
            if r != gref:
                return None
            entries.append(("group", None, None))

    # joined side evaluates on host (dimension tables are small)
    dims = execute_node(joined, txn)
    dim_key_col = dims.columns[jref[1]]
    if dim_key_col.stype not in (SType.UINT64, SType.TIMESTAMP64):
        return None
    if not dim_key_col.valid.all():
        return None  # NULL keys join by tag in the host engine
    dim_keys_h = np.asarray(dim_key_col.data, dtype=np.uint64)
    if len(np.unique(dim_keys_h)) != len(dim_keys_h):
        return None  # duplicate dim keys fan out: host path

    # factorize the group column over dim rows -> bucket per dim row
    group_col = dims.columns[gref[1]]
    keys = _group_key_matrix([group_col], dims.num_rows)
    dim_bucket_h, firsts = _factorize_rows(keys)

    # fact side: the key scan-output expr must be a valid-everywhere
    # u64 column (NULL fact keys join by tag in the host engine)
    scan = base
    key_out_expr = scan.select_list[bref[1]].expr
    if not torch_expr.expr_is_device_compatible(key_out_expr):
        return None
    if key_out_expr.return_type() not in (SType.UINT64, SType.TIMESTAMP64):
        return None
    table = txn.get_table_data(scan.table_name)
    if table.num_rows == 0 or dims.num_rows == 0:
        return None  # empty inputs: host path builds the typed empty
    if not _scan_inputs_present(table, scan):
        return None
    if not isinstance(key_out_expr, ColumnReferenceNode):
        return None  # only plain key columns prove non-NULL cheaply
    in_name = scan.input_columns[key_out_expr.column_index][0]
    if not _column_all_valid(table.columns[table.names.index(in_name)]):
        return None

    for sl in scan.select_list:
        if not torch_expr.expr_is_device_compatible(sl.expr):
            return None
    if scan.where_expr is not None and not torch_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    return {
        "scan": scan,
        "table": table,
        "where_base": where_base,
        "key_input_idx": key_out_expr.column_index,
        "entries": entries,
        "all_aggs": all_aggs,
        "dims": dims,
        "dim_keys_h": dim_keys_h,
        "dim_bucket_h": dim_bucket_h,
        "firsts": firsts,
        "group_col": group_col,
        "bounded": bounded,
    }


def _sum_stream(rsubj, scan, in_cols, scan_cols, n, device):
    """(tensor, value_bits, unsigned) of one summed fact-side expression.
    A bare reference to a stored integer column goes to the kernel as
    its narrowed stream: an unsigned one contributes its stored bits, a
    signed one sign-extends in the kernel's load. Anything else is
    evaluated to an int64 column."""
    if isinstance(rsubj, ColumnReferenceNode):
        src = scan.select_list[rsubj.column_index].expr
        if isinstance(src, ColumnReferenceNode) and src.column_index is not None:
            dc = in_cols[src.column_index]
            if dc.stype in _INT_STYPES:
                if torch_expr.is_unsigned(dc.stype):
                    return dc.data, 8 * dc.data.element_size(), True
                return dc.data, 64, False
    c = torch_expr.compile_expr(rsubj, scan_cols, n, device)
    return c.data.expand(n).to(torch.int64).contiguous(), 64, False


# rows searched for each bucket's first surviving row before the
# result is read back; the rest only if a bucket has none among them
FIRST_ROWS_PREFIX = 1 << 22


def _first_rows(gid, mask, lo: int, hi: int, K: int, n: int) -> torch.Tensor:
    """int64[K]: per bucket the lowest row in [lo, hi) that found its
    dimension row and passed the mask, or ``n`` where there is none."""
    g = gid[lo:hi]
    ok = g >= 0
    if mask is not None:
        ok &= mask[lo:hi]
    rows = torch.nonzero(ok).flatten()
    first = torch.full((K,), n, dtype=torch.int64, device=gid.device)
    return first.scatter_reduce_(0, g[rows].to(torch.int64), rows + lo, "amin")


def try_execute_device_join_groupby(
    node: qn.GroupByNode, txn
) -> Optional[Relation]:
    """SELECT <group>, aggs(fact exprs) FROM facts JOIN dims ON
    f.k = d.k [WHERE fact-side predicate] GROUP BY <dim column> on the
    device: scan + filter in torch_expr, the join probe kernel
    (kernels/join.py: the shared-memory table up to MAX_COMPARE_DIMS
    dimension rows, a hash table in global memory above), then the
    grouped aggregate kernel over the dimension buckets. No join pair
    materialises. Returns None when the plan is outside the subset (the
    host engine takes over): see join_groupby_analysis.

    The reference executes this shape as HashJoin feeding GroupBy
    (hash_join.cc + groupby.cc), row-at-a-time."""
    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu_torch.kernels.join import join_gid
    from eventql_tpu_torch.kernels.sort import read_host

    plan = join_groupby_analysis(node, txn)
    if plan is None:
        return None
    global JOIN_GROUPBY_COUNT
    JOIN_GROUPBY_COUNT += 1
    scan, table = plan["scan"], plan["table"]
    all_aggs, firsts = plan["all_aggs"], plan["firsts"]
    device = txn.device
    n = table.num_rows
    K = len(firsts)

    in_cols = _to_device_cols(
        table.columns, table.names, scan.input_columns, device
    )
    scan_cols = _LazyScanCols(scan, in_cols, n, device)
    mask = None
    for where, cols in ((scan.where_expr, in_cols), (plan["where_base"], scan_cols)):
        if where is not None:
            m = torch_expr.compile_expr(where, cols, n, device).data.expand(n)
            mask = m if mask is None else mask & m
    if mask is not None:
        mask = mask.contiguous()

    # the probe: the fact key column as stored (narrowed streams
    # zero-extend in the kernel), the dimension side from the host
    gid = join_gid(
        in_cols[plan["key_input_idx"]].data,
        _to_tensor(plan["dim_keys_h"], device),
        _to_tensor(plan["dim_bucket_h"].astype(np.int32), device),
        n,
    )

    if not plan["bounded"]:
        return _join_general(node, plan, gid, mask, in_cols, scan_cols, n, device)

    # the aggregate: rows without a dimension match carry gid -1, which
    # lies outside [0, K), so the kernels drop them themselves. Every
    # sum has a stream of its own.
    sums = [
        _sum_stream(rsubj, scan, in_cols, scan_cols, n, device)
        for _a, kind, rsubj in all_aggs
        if kind == "sum"
    ]
    if len(sums) <= 1:
        v, bits, uns = sums[0] if sums else (None, 64, False)
        out = kernels.groupby_agg(
            gid, n, K, values=v, value_bits=bits, mask=mask, values_unsigned=uns
        )
    elif len(sums) <= kernels.MAX_SUMS:
        out = kernels.groupby_multi_agg(
            gid, n, K, [s[0] for s in sums], [s[1] for s in sums], mask=mask,
            streams_unsigned=[s[2] for s in sums],
        )
    else:
        # more sums than the kernel has streams: index_add_ on int64,
        # as the GROUP BY route sends its leftover multi-sum shapes
        wide = [
            v.to(torch.int64) & ((1 << bits) - 1) if uns and bits < 64
            else v.to(torch.int64)
            for v, bits, uns in sums
        ]
        ones = torch.ones(n, dtype=torch.bool, device=device)
        counts, outs = _index_add_aggregate(
            ones if mask is None else mask, gid, wide, ["sum"] * len(wide), K
        )
        out = torch.stack([counts, *outs])

    # presentation order: the first surviving base row of each bucket
    # (an inner join on unique dim keys pairs a fact row at most once,
    # so the host's first surviving pair is the bucket's smallest row).
    # Nearly every bucket shows up early, so only a prefix of the table
    # is searched before the readback.
    head = min(n, FIRST_ROWS_PREFIX)
    first = _first_rows(gid, mask, 0, head, K, n)

    # ONE device->host copy: counts, one row per sum, first rows
    packed_h = read_host(torch.cat([out, first[None]]))
    counts_h, first_h = packed_h[0], packed_h[-1]
    occupied = np.nonzero(counts_h > 0)[0]
    if (first_h[occupied] == n).any():
        # a bucket whose rows all lie beyond the prefix: search the rest
        # of the table too, at the price of a second readback
        first_h = np.minimum(
            first_h, read_host(_first_rows(gid, mask, head, n, K, n))
        )
    buckets = occupied[np.argsort(first_h[occupied], kind="stable")]
    ng = len(buckets)

    agg_cols: List[Column] = []
    next_sum = 1
    for a, kind, _rsubj in all_aggs:
        rtype = a.sfunction.return_type
        if kind == "count":
            data = counts_h[buckets]
        else:
            data = packed_h[next_sum][buckets]
            next_sum += 1
        agg_cols.append(
            Column(rtype, data.astype(dtype_for(rtype)), np.ones(ng, bool))
        )
    group_out = plan["group_col"].gather(firsts[buckets])

    out_cols: List[Column] = []
    for tag, expr, base_i in plan["entries"]:
        if tag == "agg":
            out_cols.append(evaluate_vector(expr, EvalContext(agg_cols[base_i:], ng)))
        else:
            out_cols.append(group_out)
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


def _join_general(node, plan, gid, mask, in_cols, scan_cols, n, device):
    """The join route's general branch (float sums, min, max, mean,
    count_distinct): the grouped aggregate keyed by the probe's bucket
    (span [0, K): a direct tier) over the rows that found their
    dimension row and pass the fact-side WHERE. Each group's first row
    is its smallest base row, which gives
    the host engine's presentation order (an inner join on unique
    dimension keys pairs a fact row at most once)."""
    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu_torch.kernels.hash_groupby import hash_groupby

    matched = gid >= 0
    keep = matched if mask is None else mask & matched
    all_aggs = plan["all_aggs"]
    calls = [a for a, _kind, _rsubj in all_aggs]
    scan, table = plan["scan"], plan["table"]
    by_name = dict(zip(table.names, table.columns))
    host_cols = [by_name[cname] for cname, _t in scan.input_columns]
    values, kinds, unsigned, distinct, dspans, where = _aggregate_inputs(
        [(a, rsubj) for a, _kind, rsubj in all_aggs], scan, in_cols, host_cols, scan_cols,
        n, device)
    res = hash_groupby([gid], n, keep, values, kinds, unsigned, distinct,
                       [(0, len(plan["firsts"]), False)], dspans)
    # an empty slot's first row is no row: gather row 0 for it (dropped)
    bucket = gid[torch.where(res.counts > 0, res.first_index, 0)].to(torch.int64)
    _first, counts, (buckets,), aggs, dist = _grouped_to_host(res, (bucket,))
    ng = len(counts)
    agg_cols = _agg_columns(calls, where, counts, aggs, dist)
    group_out = plan["group_col"].gather(plan["firsts"][buckets])
    out_cols: List[Column] = []
    for tag, expr, base_i in plan["entries"]:
        if tag == "agg":
            out_cols.append(evaluate_vector(expr, EvalContext(agg_cols[base_i:], ng)))
        else:
            out_cols.append(group_out)
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)
