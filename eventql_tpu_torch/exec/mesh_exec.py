"""SQL over a sharded table: the mesh tier's routes.

The counterpart of eventql_tpu/exec/mesh_exec.py, over the shards of a
``MeshTableProvider`` (parallel/mesh_provider.py):

* ``try_execute_mesh_groupby``: Scan -> WHERE -> GROUP BY. Each shard
  evaluates its expressions in torch_expr on its own rows and groups
  them with the hash aggregate H1 (kernels/hash_groupby.py), and keeps
  a compact partial: only the groups it has, each with its key bits and
  its first global row. The partials are gathered on the merge shard
  and H1 merges them once more (parallel/distributed.py
  ``_local_partial`` / ``_merge``: counts and sums add, min / max, the
  first row by min; mean travels as (sum, count)). count_distinct
  exchanges each shard's distinct (keys, value) pairs, which H1
  deduplicates again before a count per key.
* ``try_execute_mesh_join_groupby``: fact-dim JOIN + GROUP BY. The
  dimension side is evaluated once on the host (``join_groupby_analysis``)
  and placed on every shard's device; each shard probes with B4 / B5 and
  aggregates with B1 / B2 (integer sums and counts) or H1, and the
  compact partials merge as above.
* ``try_execute_mesh_scan_topk``: ORDER BY ... LIMIT. Each shard yields
  its first ``offset + limit`` candidates in host order (the histogram
  top-k B1 + B3 for one key, a stable sort for several), the candidates
  are gathered, and a stable sort picks the window: key order, then the
  lowest global row.
* ``try_execute_mesh_scan_order``: the full ORDER BY. One key, or
  several bounded keys packed into one u64, take the sample sort
  (``distributed_bucket_sort``: one exchange of fixed-capacity buckets);
  other key lists, and a sample sort that cannot be exact (a bucket
  overflows, a passing key is the sentinel), take the compare-split
  sort (``distributed_sort``) of each shard's passing rows. The global
  row id breaks ties, so the order is the host engine's.

The JAX routes all-gather partial tables as long as a shard, so their
exchange grows with the rows (O(rows * P)) and their merge re-sorts
P * rows entries. Here what crosses is O(groups * P) for a GROUP BY or a
join (distinct pairs for count_distinct) and O(k * P) for a top-k; the
answers are the same. Group order is that of the first global rows (the
host engine's); non-aggregate select entries are evaluated on the host
at those rows, as are the rows a sort returns. A plan these routes
decline returns None, and the host engine serves it, as in the JAX
package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec as dx
from eventql_tpu_torch.exec import torch_expr
from eventql_tpu_torch.exec.relation import Column, Relation, dtype_for
from eventql_tpu_torch.parallel.distributed import (
    _Merged,
    _local_partial,
    _merge,
    _Partial,
    _xch_all_gather,
    _xch_psum,
)
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.exprs import CallExpressionNode, has_aggregate_call

# route counters (tests and chip_smoke.py check that the mesh route ran)
MESH_GROUPBY_RUNS = 0
MESH_TOPK_RUNS = 0
MESH_JOIN_RUNS = 0
MESH_ORDER_RUNS = 0  # full ORDER BY, either sort
MESH_BUCKET_SORT_RUNS = 0  # of those, the ones the sample sort served


class _Shard(NamedTuple):
    device: torch.device
    g0: int  # global row id of its first row
    n: int  # rows it holds, padding included
    n_real: int  # rows of the table among them
    cols: list  # torch_expr.DeviceCol per scan input column


def _shards(provider, scan) -> List[_Shard]:
    shard_cols, n, n_p = provider.sharded_scan_columns(scan.table_name, scan.input_columns)
    local = n_p // provider.n_shards
    return [
        _Shard(dev, i * local, local, min(max(n - i * local, 0), local), cols)
        for i, (dev, cols) in enumerate(zip(provider.mesh.devices, shard_cols))
    ]


def _shard_mask(shard: _Shard, wheres) -> Optional[torch.Tensor]:
    """The conjunction of ``wheres`` ((expression, the columns it reads)
    pairs; None expressions skipped) with the shard's real rows: a
    padding row reads 0 everywhere and must belong to no group. None
    where every row is kept."""
    mask = None
    for expr, cols in wheres:
        if expr is not None:
            m = torch_expr.compile_expr(expr, cols, shard.n, shard.device).data.expand(shard.n)
            mask = m if mask is None else mask & m
    if shard.n_real < shard.n:
        real = torch.arange(shard.n, device=shard.device) < shard.n_real
        mask = real if mask is None else mask & real
    return None if mask is None else mask.contiguous()


# -- the merged groups on the host ----------------------------------------------


def _read_merged(m: _Merged, with_keys: bool = False):
    """ONE device -> host copy: (first rows, counts, aggregates as int64
    bit patterns, distinct counts, keys widened to int64 when
    ``with_keys``)."""
    from eventql_tpu_torch.kernels.sort import read_host

    rows = [m.first, m.counts]
    rows += [a.view(torch.int64) if a.dtype == torch.float64 else a for a in m.aggs]
    rows += list(m.distinct)
    rows += [k.to(torch.int64) for k in m.keys] if with_keys else []
    packed = read_host(torch.stack(rows))
    na, nd = len(m.aggs), len(m.distinct)
    return (packed[0], packed[1], list(packed[2:2 + na]), list(packed[2 + na:2 + na + nd]),
            list(packed[2 + na + nd:]))


def _divide_means(merged: _Merged, kinds) -> None:
    """A mean's merged sum divided by the group's row count, in place."""
    for j, kind in enumerate(kinds):
        if kind == "mean":
            merged.aggs[j] = merged.aggs[j] / merged.counts.to(torch.float64)


# -- GROUP BY -----------------------------------------------------------------


def _mesh_groupby_eligible(node: qn.GroupByNode) -> bool:
    """The general device route's gate, a scan with input columns, and
    no STRING argument of min / max / sum / mean (the JAX route's gate)."""
    from eventql_tpu_torch.exec.operators import _strip_aggregates

    if not dx.device_plan_eligible(node):
        return False
    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return False
    if not scan.input_columns:
        # SELECT count(1) FROM t: nothing to shard, the host engine
        return False
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            _strip_aggregates(sl.expr, aggs)
            for a in aggs:
                if (
                    a.sfunction.aggregate.kind in ("min", "max", "sum", "mean")
                    and a.args
                    and a.args[0].return_type() == SType.STRING
                ):
                    return False
    return True


def try_execute_mesh_groupby(node: qn.GroupByNode, txn, partial: bool = False):
    """Scan -> WHERE -> GROUP BY over the mesh; None -> the host engine.

    ``partial=True`` returns an ``operators.GroupByPartial`` (the
    mergeable accumulator states the cluster tier ships as
    QUERY_PARTIALAGGR results, mean as (sum, count)) instead of a
    Relation; a count_distinct plan then returns None, since a partial
    needs the distinct value sets."""
    from eventql_tpu_torch.exec.operators import GroupByPartial, _strip_aggregates
    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu_torch.kernels.hash_groupby import MAX_KEYS

    if not isinstance(node, qn.GroupByNode) or not _mesh_groupby_eligible(node):
        return None
    provider = txn.tables
    scan: qn.SequentialScanNode = node.table
    table = txn.get_table_data(scan.table_name)
    if table.num_rows == 0 or not dx._scan_inputs_present(table, scan):
        return None
    if len(node.group_exprs) >= MAX_KEYS:
        return None  # no room for the NULL tag word: the host engine

    entries = []
    calls: List[CallExpressionNode] = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            entries.append(("agg", emit, len(calls), len(aggs)))
            calls.extend(aggs)
        else:
            entries.append(("first", sl.expr, None, 0))
    if partial and any(a.sfunction.aggregate.kind == "count_distinct" for a in calls):
        return None

    by_name = dict(zip(table.names, table.columns))
    host_cols = [by_name[cname] for cname, _t in scan.input_columns]
    parts = []
    for shard in _shards(provider, scan):
        dev, n = shard.device, shard.n
        scan_cols = dx._LazyScanCols(scan, shard.cols, n, dev)
        mask = _shard_mask(shard, [(scan.where_expr, shard.cols)])
        keys, valids, spans = [], [], []
        for i, g in enumerate(node.group_exprs):
            data, valid, span = dx._group_key(g, scan, shard.cols, host_cols, scan_cols, n, dev)
            keys.append(data)
            spans.append(span)
            if valid is not None:
                valids.append((i, valid))
        if valids:
            tags, span = dx._null_tags(valids, n, dev)
            keys.append(tags)
            spans.append(span)
        values, kinds, unsigned, distinct, dspans, where = dx._aggregate_inputs(
            [(a, a.args[0] if a.args else None) for a in calls], scan, shard.cols,
            host_cols, scan_cols, n, dev)
        parts.append(_local_partial(keys, spans, n, mask, values, kinds, unsigned, distinct,
                                    dspans, shard.g0, dev))
        # this shard's temporaries go before the next shard's
        del scan_cols, mask, keys, valids, values, distinct
    merged = _merge(provider.mesh, parts, spans, kinds, unsigned, dspans, "sql_groupby_gather")
    del parts
    if merged is None:
        return None  # no group: the host engine builds the typed empty relation
    if not partial:
        _divide_means(merged, kinds)
    first, counts, aggs, dist, _keys = _read_merged(merged)
    ng = len(first)

    scan_rows = []
    if partial or any(tag == "first" for tag, _e, _b, _n in entries):
        # each group's first row, through the host evaluator
        ctx = EvalContext([c.gather(first) for c in host_cols], ng)
        scan_rows = [evaluate_vector(sl.expr, ctx) for sl in scan.select_list]

    global MESH_GROUPBY_RUNS
    if partial:
        ones = np.ones(ng, bool)
        key_cols = [evaluate_vector(g, EvalContext(scan_rows, ng)) for g in node.group_exprs]
        p_entries = []
        for tag, expr, base, nagg in entries:
            if tag == "first":
                p_entries.append(("first", evaluate_vector(expr, EvalContext(scan_rows, ng))))
                continue
            states = []
            for a, w in zip(calls[base:base + nagg], where[base:base + nagg]):
                kind = a.sfunction.aggregate.kind
                if w[0] == "count":
                    states.append((kind, [Column(SType.UINT64, counts.view(np.uint64), ones)]))
                elif kind == "mean":
                    states.append(("mean", [Column(SType.FLOAT64, aggs[w[1]].view(np.float64),
                                                   ones),
                                            Column(SType.UINT64, counts.view(np.uint64), ones)]))
                else:
                    rtype = a.sfunction.return_type
                    arr = aggs[w[1]].view(np.float64 if w[2] else np.uint64)
                    states.append((kind, [Column(rtype, arr.astype(dtype_for(rtype)), ones)]))
            p_entries.append(("agg", expr, states, calls[base:base + nagg]))
        MESH_GROUPBY_RUNS += 1
        return GroupByPartial(key_cols, ng, p_entries)

    agg_cols = dx._agg_columns(calls, where, counts, aggs, dist)
    out_cols: List[Column] = []
    for tag, expr, base, _n in entries:
        if tag == "agg":
            out_cols.append(evaluate_vector(expr, EvalContext(agg_cols[base:], ng)))
        else:
            out_cols.append(evaluate_vector(expr, EvalContext(scan_rows, ng)))
    MESH_GROUPBY_RUNS += 1
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


# -- JOIN + GROUP BY ----------------------------------------------------------


def _bounded_join_partial(plan, gid, mask, shard, scan_cols, K) -> _Partial:
    """One shard's integer sums and counts per bucket through B1 / B2
    (the single-card join route's bounded branch), compacted to the
    buckets it has, each with its first surviving global row."""
    from eventql_tpu_torch.kernels.hash_groupby import Grouped, compact_groups

    out = dx._join_sum_tables(plan, gid, mask, shard.cols, scan_cols, shard.n, K,
                              shard.device)
    # first rows as the single-card route finds them: in a prefix of the
    # shard, and in the rest only for a bucket with no row in the prefix
    head = min(shard.n, dx.FIRST_ROWS_PREFIX)
    slots = torch.arange(K, dtype=torch.int64, device=shard.device)
    g, _ = compact_groups(Grouped(dx._first_rows(gid, mask, 0, head, K, shard.n), out[0],
                                  (*out[1:], slots), ()), order=None)
    occ, first = g.aggregates[-1], g.first_index
    if head < shard.n and bool((first == shard.n).any()):
        first = torch.minimum(first, dx._first_rows(gid, mask, head, shard.n, K, shard.n)[occ])
    return _Partial([occ.to(torch.int32)], g.counts, list(g.aggregates[:-1]),
                    first + shard.g0, [])


def try_execute_mesh_join_groupby(node: qn.GroupByNode, txn) -> Optional[Relation]:
    """Fact-dim JOIN + GROUP BY over the mesh (a broadcast join): the
    facts stay sharded, the dimension side (host-evaluated by
    ``join_groupby_analysis``, whose gate the single-card route shares)
    is placed on every shard's device, each shard probes (B4 up to
    MAX_COMPARE_DIMS dimension rows, B5 above) and aggregates: integer
    sums and counts with B1 / B2, the other kinds with H1 keyed by the
    bucket. The compact partials merge as the GROUP BY's. Only O(groups)
    words a shard cross; no join pair materialises."""
    from eventql_tpu_torch.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu_torch.kernels.join import join_gid
    from eventql_tpu_torch.parallel.distributed import _replicas

    plan = dx.join_groupby_analysis(node, txn)
    if plan is None:
        return None
    provider = txn.tables
    mesh = provider.mesh
    scan, table = plan["scan"], plan["table"]
    all_aggs, firsts = plan["all_aggs"], plan["firsts"]
    calls = [a for a, _kind, _rsubj in all_aggs]
    K = len(firsts)
    spans = [(0, K, False)]
    by_name = dict(zip(table.names, table.columns))
    host_cols = [by_name[cname] for cname, _t in scan.input_columns]
    dim_keys = _replicas(mesh, dx._to_tensor(plan["dim_keys_h"], "cpu"))
    dim_bucket = _replicas(mesh, torch.from_numpy(plan["dim_bucket_h"].astype(np.int32)))

    parts = []
    # the bounded branch: one summed table per sum (B1 / B2 give u64 sums)
    kinds = ["sum"] * sum(kind == "sum" for _a, kind, _rsubj in all_aggs)
    unsigned, dspans, where = [False] * len(kinds), [], []
    for shard in _shards(provider, scan):
        dev, n = shard.device, shard.n
        scan_cols = dx._LazyScanCols(scan, shard.cols, n, dev)
        mask = _shard_mask(shard, [(scan.where_expr, shard.cols),
                                   (plan["where_base"], scan_cols)])
        gid = join_gid(shard.cols[plan["key_input_idx"]].data, dim_keys[dev],
                       dim_bucket[dev], n)
        if plan["bounded"]:
            parts.append(_bounded_join_partial(plan, gid, mask, shard, scan_cols, K))
        else:
            keep = gid >= 0 if mask is None else mask & (gid >= 0)
            values, kinds, unsigned, distinct, dspans, where = dx._aggregate_inputs(
                [(a, rsubj) for a, _kind, rsubj in all_aggs], scan, shard.cols, host_cols,
                scan_cols, n, dev)
            parts.append(_local_partial([gid], spans, n, keep, values, kinds, unsigned,
                                        distinct, dspans, shard.g0, dev))
            del keep, values, distinct
        del scan_cols, mask, gid
    merged = _merge(mesh, parts, spans, kinds, unsigned, dspans, "sql_join_gather")
    del parts
    if merged is None:
        return None  # no surviving pair: the host engine builds the typed empty relation
    _divide_means(merged, kinds)
    _first, counts, aggs, dist, (buckets,) = _read_merged(merged, with_keys=True)
    ng = len(counts)

    if plan["bounded"]:
        ones = np.ones(ng, bool)
        sums = iter(aggs)
        agg_cols = [
            Column(a.sfunction.return_type,
                   (counts if kind == "count" else next(sums)).astype(
                       dtype_for(a.sfunction.return_type)), ones)
            for a, kind, _rsubj in all_aggs
        ]
    else:
        agg_cols = dx._agg_columns(calls, where, counts, aggs, dist)
    group_out = plan["group_col"].gather(firsts[buckets])
    out_cols: List[Column] = []
    for tag, expr, base_i in plan["entries"]:
        if tag == "agg":
            out_cols.append(evaluate_vector(expr, EvalContext(agg_cols[base_i:], ng)))
        else:
            out_cols.append(group_out)
    global MESH_JOIN_RUNS
    MESH_JOIN_RUNS += 1
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


# -- ORDER BY ... LIMIT -------------------------------------------------------


def _mesh_order_analysis(order_node: qn.OrderByNode, txn):
    """The host half of the mesh ORDER BY routes: the single-card
    route's (``device_exec._scan_order_analysis``: eligibility, the NULL
    rank of string keys, static key bounds), and a scan with input
    columns. Float keys need no host-made key plane here (the JAX
    route's ``_mesh_sharded_hostkeys``): the card builds them from the
    value's own bits. Returns (scan, table, n, null_ranks, bounds) or
    None."""
    scan = order_node.table
    if not isinstance(scan, qn.SequentialScanNode) or not scan.input_columns:
        return None
    return dx._scan_order_analysis(order_node, txn)


def _mesh_keys_in_shard(order_node, scan, shard: _Shard, null_ranks, bounds):
    """(mask, host-order keys) of one shard: the WHERE and the padding
    rows, and each sort spec's key, as the single-card route builds them."""
    mask, keys = dx._scan_order_keys(scan, order_node.sort_specs, shard.cols, shard.n,
                                     shard.device, null_ranks, bounds)
    if shard.n_real < shard.n:
        real = torch.arange(shard.n, device=shard.device) < shard.n_real
        mask = real if mask is None else mask & real
    return mask, keys


def _sorted_candidates(mask, keys, w: int):
    """The first ``w`` rows of the stable sort whose leading key is the
    filter mask (passing rows first, then host order)."""
    from eventql_tpu_torch.kernels.sort import order_permutation

    if mask is None:
        return order_permutation(keys)[:w]
    return order_permutation((~mask, *keys))[:w]


def _topk_candidates(mask, k0, w: int):
    """One shard's first ``w`` rows by one key: (rows, their top keys,
    their mask, the count of passing rows whose top key is 0). A
    filtered row's top key is forced to 0 (the single-card route's
    convention), so a passing zero-key row can tie with it."""
    from eventql_tpu_torch.kernels.sort import topk_permutation

    ktop = ~k0 if mask is None else torch.where(mask, ~k0, torch.zeros((), dtype=k0.dtype,
                                                                       device=k0.device))
    idx = topk_permutation(ktop, w)
    if mask is None:
        zero = torch.zeros((), dtype=torch.int64, device=k0.device)
        return idx, ktop[idx], torch.ones(w, dtype=torch.bool, device=k0.device), zero
    return idx, ktop[idx], mask[idx], (mask & (ktop == 0)).sum()


def try_execute_mesh_scan_topk(node: qn.LimitNode, txn) -> Optional[Relation]:
    """SELECT ... [WHERE] ORDER BY ... LIMIT k [OFFSET o] over the mesh:
    each shard's first ``o + k`` candidates in host order, an O(k * P)
    gather, and a stable sort of the candidates: key order, ties to the
    lowest global row (the gather keeps shard order, each shard its row
    order). One key takes the histogram top-k on each shard; a window
    with a filtered row at key 0 is rechecked as the single-card route
    does (the count of passing zero-key rows travels as a psum) and,
    where a passing zero-key row might be missing, taken again through
    the stable sort on every shard. Several keys take the stable sort on
    each shard, on a mesh of a power of two shards (the JAX route's gate:
    its compare-split sort); None otherwise. Only the window's global row
    ids leave the device; the host evaluates those rows."""
    from eventql_tpu_torch.kernels.sort import order_permutation, read_host, topk_permutation

    order_node = node.table
    if not isinstance(order_node, qn.OrderByNode):
        return None
    w = node.offset + node.limit
    if w == 0:
        return None
    prep = _mesh_order_analysis(order_node, txn)
    if prep is None:
        return None
    scan, table, n, null_ranks, bounds = prep
    provider = txn.tables
    mesh = provider.mesh
    single = len(order_node.sort_specs) == 1
    if not single and mesh.size & (mesh.size - 1):
        return None
    w = min(w, n)
    lo, hi = node.offset, node.offset + node.limit

    def sorted_window():
        rows, masks, keys = [], [], []
        for shard in _shards(provider, scan):
            mask, skeys = _mesh_keys_in_shard(order_node, scan, shard, null_ranks, bounds)
            idx = _sorted_candidates(mask, skeys, min(w, shard.n))
            rows.append(idx + shard.g0)
            masks.append(torch.ones_like(idx, dtype=torch.bool) if mask is None else mask[idx])
            keys.append([k[idx] for k in skeys])
            del mask, skeys
        g = _xch_all_gather(mesh, rows, "sql_topk_gather")
        m = _xch_all_gather(mesh, masks, "sql_topk_gather")
        ks = [_xch_all_gather(mesh, [k[j] for k in keys], "sql_topk_gather")
              for j in range(len(keys[0]))]
        perm = order_permutation((~m, *ks))[:w]
        packed = read_host(torch.stack([g[perm], m[perm].to(torch.int64)]))
        return packed[0][packed[1] != 0]  # the passing rows are a prefix

    global MESH_TOPK_RUNS
    if not single:
        rows = sorted_window()
        MESH_TOPK_RUNS += 1
        return dx._emit_scan_rows(scan, table, rows, lo, hi)

    rows, vals, masks, zeros = [], [], [], []
    for shard in _shards(provider, scan):
        mask, (k0,) = _mesh_keys_in_shard(order_node, scan, shard, null_ranks, bounds)
        idx, v, m, z = _topk_candidates(mask, k0, min(w, shard.n))
        rows.append(idx + shard.g0)
        vals.append(v)
        masks.append(m)
        zeros.append(z.reshape(1))
        del mask, k0
    g = _xch_all_gather(mesh, rows, "sql_topk_gather")
    v = _xch_all_gather(mesh, vals, "sql_topk_gather")
    m = _xch_all_gather(mesh, masks, "sql_topk_gather")
    npz = _xch_psum(mesh, zeros, "topk_npz")
    top = topk_permutation(v, w)  # ties: the lowest position, i.e. global row
    packed = read_host(torch.cat([g[top], m[top].to(torch.int64),
                                  v[top].to(torch.int64), npz]))
    g_h, m_h, v_h = packed[:w], packed[w:2 * w] != 0, packed[2 * w:3 * w]
    MESH_TOPK_RUNS += 1
    if bool(m_h.all()):
        return dx._emit_scan_rows(scan, table, g_h, lo, hi)
    # filtered rows in the window: exact iff every passing zero-key row
    # is inside it (rows outside then all have key 0)
    if int((m_h & (v_h == 0)).sum()) == int(packed[3 * w]):
        return dx._emit_scan_rows(scan, table, g_h[m_h], lo, hi)
    return dx._emit_scan_rows(scan, table, sorted_window(), lo, hi)


# -- ORDER BY ------------------------------------------------------------------


def _pack_plan(bounds):
    """The field widths of a multi-key ORDER BY whose keys are all
    statically bounded and together fit 64 bits (the JAX route's rule):
    one u64 then holds the key tuple, the first key most significant.
    None otherwise."""
    if len(bounds) < 2 or any(b is None for b in bounds):
        return None
    bits = [max(1, (hi - lo).bit_length()) for lo, hi in bounds]
    return bits if sum(bits) <= 64 else None


def _bucket_key(keys, bounds, bits) -> torch.Tensor:
    """One shard's u64 bucket key: the single key as its u64 (the JAX
    route sorts the u64 key, so its sentinel rule is the same), or the
    fields of several packed into one. A bounded key arrives as ``key -
    lo`` in 32 bits (``device_exec._scan_order_keys``): that is its field."""
    from eventql_tpu_torch.parallel.distributed import _widen_u32

    if bits is None:
        (k,), (b,) = keys, bounds
        return k if b is None else _widen_u32(k, b[0])
    packed = None
    for k, nb in zip(keys, bits):
        field = _widen_u32(k, 0)
        packed = field if packed is None else (packed << nb) | field
    return packed


def _gather_rows(mesh, parts, counts) -> "np.ndarray":
    """The first ``counts[i]`` entries of shard i's tensor, in shard
    order, read to the host in one copy."""
    from eventql_tpu_torch.kernels.sort import read_host

    return read_host(torch.cat([p[:int(c)].to(mesh.root) for p, c in zip(parts, counts)]))


def _bucket_order(shards, mesh, keys_of, bounds, bits):
    """The passing rows' global ids in ORDER BY order through
    ``distributed_bucket_sort``, or None where it cannot be exact:
    splitter overflow, a passing row whose key is the sentinel (u64 max,
    NaN sorted last), or a count that differs from the passing rows'.
    ``keys_of(shard)``: the shard's (mask, keys)."""
    from eventql_tpu_torch.kernels.sort import read_host
    from eventql_tpu_torch.parallel.distributed import SENTINEL, distributed_bucket_sort

    bkeys, gids, passes, collides = [], [], [], []
    for shard in shards:
        mask, keys = keys_of(shard)
        k0 = _bucket_key(keys, bounds, bits)
        hit = k0 == SENTINEL
        if mask is None:
            passes.append(torch.full((1,), shard.n, dtype=torch.int64, device=shard.device))
        else:
            passes.append(mask.sum().reshape(1))
            hit &= mask
            k0 = torch.where(mask, k0, SENTINEL)
        collides.append(hit.sum().reshape(1))
        bkeys.append(k0)
        gids.append(torch.arange(shard.n, dtype=torch.int64, device=shard.device) + shard.g0)
        del mask, keys, hit
    collide = _xch_psum(mesh, collides, "order_collide")
    n_pass = _xch_psum(mesh, passes, "order_npass")
    _keys, rows, counts, overflow = distributed_bucket_sort(mesh, bkeys, gids)
    del bkeys, gids, _keys
    # the host's decision: one readback
    flags = read_host(torch.cat([counts, overflow.to(torch.int64).reshape(1), collide, n_pass]))
    P = mesh.size
    counts_h, n_pass_h = flags[:P], int(flags[P + 2])
    if flags[P] or flags[P + 1] or int(counts_h.sum()) != n_pass_h:
        return None
    return _gather_rows(mesh, rows, counts_h)


def _compare_split_order(shards, mesh, keys_of):
    """The passing rows' global ids in ORDER BY order through
    ``distributed_sort``, always exact. Each shard first keeps only its
    passing rows, padded to the longest shard's count (the padding sorts
    last on a leading key); the sort keys are then (padding, keys...,
    global row), the row id making the order the host engine's stable
    one. The JAX route sorts every row with the filter as leading key;
    the answer is the same, and a selective WHERE sorts a fraction.
    ``keys_of(shard)``: the shard's (mask, keys)."""
    from eventql_tpu_torch.parallel.distributed import distributed_sort

    kept = []
    for shard in shards:
        mask, keys = keys_of(shard)
        gid = torch.arange(shard.n, dtype=torch.int64, device=shard.device) + shard.g0
        if mask is None:
            kept.append((keys, gid))
        else:
            rows = torch.nonzero(mask).flatten()
            kept.append(([k[rows] for k in keys], gid[rows]))
        del mask, keys
    counts = [gid.shape[0] for _keys, gid in kept]
    L = max(counts)
    if L == 0:
        return np.zeros(0, np.int64)

    def pad(t):
        return torch.cat([t, torch.zeros(L - t.shape[0], dtype=t.dtype, device=t.device)])

    cols = [[torch.arange(L, device=gid.device) >= gid.shape[0]] + [pad(k) for k in keys]
            + [pad(gid)] for keys, gid in kept]
    del kept
    sorted_keys, _ = distributed_sort(mesh, [[c[j] for c in cols] for j in range(len(cols[0]))])
    del cols
    total = sum(counts)
    per = [min(L, max(total - i * L, 0)) for i in range(mesh.size)]
    return _gather_rows(mesh, sorted_keys[-1], per)


def try_execute_mesh_scan_order(order_node: qn.OrderByNode, txn) -> Optional[Relation]:
    """Full SELECT ... [WHERE] ORDER BY over the mesh (the JAX
    ``try_execute_mesh_scan_order``). One key, or several statically
    bounded keys whose widths sum to at most 64 bits (packed into one
    u64, the first key most significant), take the sample sort
    (``distributed_bucket_sort``): filtered rows key to the sentinel and
    drop out of the exchange, and the global row id is the payload, so
    ties keep the host engine's stable order. Where that cannot be exact
    (splitter overflow, a passing row keyed to the sentinel, a count
    that differs) and for other multi-key specs, the compare-split sort
    (``distributed_sort``) serves. Each sort builds each shard's WHERE,
    padding mask and keys in turn and keeps only what it sorts: a
    fallback builds them a second time rather than hold every shard's
    through the sample sort. None on a mesh whose size is not a power of
    two (the JAX gate) or for a plan the order analysis declines: the
    host engine sorts. Only the passing rows' global ids leave the
    device; the host evaluates those rows."""
    global MESH_ORDER_RUNS, MESH_BUCKET_SORT_RUNS

    provider = txn.tables
    mesh = provider.mesh
    if mesh.size & (mesh.size - 1):
        return None
    prep = _mesh_order_analysis(order_node, txn)
    if prep is None:
        return None
    scan, table, _n, null_ranks, bounds = prep
    shards = _shards(provider, scan)

    def keys_of(shard):
        return _mesh_keys_in_shard(order_node, scan, shard, null_ranks, bounds)

    bits = _pack_plan(bounds)
    rows = None
    if len(order_node.sort_specs) == 1 or bits is not None:
        rows = _bucket_order(shards, mesh, keys_of, bounds, bits)
        if rows is not None:
            MESH_BUCKET_SORT_RUNS += 1
    if rows is None:
        rows = _compare_split_order(shards, mesh, keys_of)
    MESH_ORDER_RUNS += 1
    return dx._emit_scan_rows(scan, table, rows)
    rows = _compare_split_order(order_node, scan, shards, mesh, null_ranks, bounds)
    MESH_ORDER_RUNS += 1
    return dx._emit_scan_rows(scan, table, rows, lo, hi)
