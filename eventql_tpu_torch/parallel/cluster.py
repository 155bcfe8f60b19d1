"""Multi-process cluster execution: plan shipping + partial-aggregate
fan-out over the native TCP protocol.

This is the process-level analog of the reference's distributed query
path (reference: server/sql/scheduler.cc:55-159 builds per-partition
partial plans; GroupByMergeExpression fans them out via TCPAsyncClient
and merges accumulator states, groupby.cc:504-637; workers execute
QUERY_PARTIALAGGR by decoding the shipped plan,
transport/native/ops/query_partialaggr.cc:41-110).

A coordinator holds the table catalog (which workers own a table's
rows); GROUP BY queries ship the encoded GroupBy(scan) subtree to every
owner, workers return serialized partials, and the coordinator merges
them with the accumulator algebra. Within one host, the same pipeline
runs as compiled mesh collectives (parallel/distributed.py) — this
module is the DCN/process tier above it.
"""

from __future__ import annotations

import concurrent.futures
import io
import struct
from typing import List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_, SQLError
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.exec.runtime import TableInfo
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.builder import TableProvider

MAX_CONCURRENT_SHARDS = 256  # reference: evqld.cc:245


# -- partial serialization --------------------------------------------------


def _save_column(arrays: dict, prefix: str, col: Column):
    arrays[f"{prefix}_data"] = col.data
    arrays[f"{prefix}_valid"] = col.valid
    arrays[f"{prefix}_stype"] = np.array(int(col.stype))
    if col.dictionary is not None:
        arrays[f"{prefix}_dict"] = col.dictionary


def _load_column(z, prefix: str) -> Column:
    dictionary = None
    if f"{prefix}_dict" in z.files:
        dictionary = z[f"{prefix}_dict"]
    return Column(
        SType(int(z[f"{prefix}_stype"])),
        z[f"{prefix}_data"],
        z[f"{prefix}_valid"],
        dictionary,
    )


def partial_to_bytes(partial, rows_scanned: int = 0) -> bytes:
    """Serialize a GroupByPartial — the analog of the reference's
    (group key, accumulator savestate) rows (groupby.cc:438-472).
    `rows_scanned` rides along so the coordinator's QUERY_PROGRESS /
    QUERY_RESULT stats aggregate true cluster-wide scan counts (the
    reference defines these wire fields but zeroes them,
    frames/query_progress.cc:63-70)."""
    arrays = {"n_groups": np.array(partial.n_groups)}
    arrays["rows_scanned"] = np.array(int(rows_scanned))
    arrays["n_keys"] = np.array(len(partial.key_cols))
    for i, k in enumerate(partial.key_cols):
        _save_column(arrays, f"key{i}", k)
    arrays["n_entries"] = np.array(len(partial.entries))
    for ei, entry in enumerate(partial.entries):
        if entry[0] == "first":
            arrays[f"e{ei}_kind"] = np.array("first")
            _save_column(arrays, f"e{ei}", entry[1])
        else:
            _tag, _emit, states, _calls = entry
            arrays[f"e{ei}_kind"] = np.array("agg")
            arrays[f"e{ei}_nstates"] = np.array(len(states))
            for si, (skind, cols) in enumerate(states):
                arrays[f"e{ei}_s{si}_kind"] = np.array(skind)
                if skind == "count_distinct":
                    arrays[f"e{ei}_s{si}_sets"] = cols[0]
                elif skind == "mean":
                    _save_column(arrays, f"e{ei}_s{si}_sum", cols[0])
                    _save_column(arrays, f"e{ei}_s{si}_cnt", cols[1])
                else:
                    _save_column(arrays, f"e{ei}_s{si}", cols[0])
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def partial_from_bytes(data: bytes, template_partial):
    """Rebuild a GroupByPartial using the coordinator's entry structure
    (emit exprs / agg calls come from the coordinator's own plan)."""
    from eventql_tpu_torch.exec.operators import GroupByPartial

    z = np.load(io.BytesIO(data), allow_pickle=True)
    n_keys = int(z["n_keys"])
    rows_scanned = int(z["rows_scanned"]) if "rows_scanned" in z else 0
    key_cols = [_load_column(z, f"key{i}") for i in range(n_keys)]
    entries = []
    for ei, tentry in enumerate(template_partial.entries):
        kind = str(z[f"e{ei}_kind"])
        if kind == "first":
            entries.append(("first", _load_column(z, f"e{ei}")))
        else:
            _tag, emit, tstates, calls = tentry
            states = []
            for si, (skind, _cols) in enumerate(tstates):
                wkind = str(z[f"e{ei}_s{si}_kind"])
                if wkind == "count_distinct":
                    states.append((wkind, [z[f"e{ei}_s{si}_sets"]]))
                elif wkind == "mean":
                    states.append(
                        (
                            wkind,
                            [
                                _load_column(z, f"e{ei}_s{si}_sum"),
                                _load_column(z, f"e{ei}_s{si}_cnt"),
                            ],
                        )
                    )
                else:
                    states.append((wkind, [_load_column(z, f"e{ei}_s{si}")]))
            entries.append(("agg", emit, states, calls))
    out = GroupByPartial(key_cols, int(z["n_groups"]), entries)
    out.rows_scanned = rows_scanned
    return out


def relation_to_bytes(rel: Relation) -> bytes:
    """Serialize a Relation for the QUERY_REMOTE streaming-scan response
    (reference: transport/native/ops/query_remote.cc row batches)."""
    arrays = {
        "n_rows": np.array(rel.num_rows),
        "n_cols": np.array(len(rel.columns)),
        "names": np.array(rel.names),
    }
    for i, col in enumerate(rel.columns):
        _save_column(arrays, f"c{i}", col)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def relation_from_bytes(data: bytes) -> Relation:
    z = np.load(io.BytesIO(data), allow_pickle=True)
    n_cols = int(z["n_cols"])
    names = [str(n) for n in z["names"]] if n_cols else []
    cols = [_load_column(z, f"c{i}") for i in range(n_cols)]
    return Relation(names, cols, int(z["n_rows"]))


# -- coordinator ------------------------------------------------------------


class ClusterTableProvider(TableProvider):
    """Routes queries to an explicit list of worker processes, each of
    which owns its local rows: every query fans to all of them
    (reference: TSDBTableProvider). The partition-metadata tier (routed
    and replicated writes, one replica per partition, failover) needs
    config/ and db/metadata_{file,service,transport}.py, which are not
    ported to eventql_tpu_torch yet."""

    def __init__(self, workers: List[Tuple[str, int]]):
        self.workers = list(workers)
        # pooled server-to-server connections, shared process-wide so
        # per-request provider instances reuse sockets across queries
        # (reference: TCPConnectionPool in db/database.cc:283-290)
        from eventql_tpu_torch.parallel.conn_pool import global_pool

        self.pool = global_pool()
        self._rr = 0  # round-robin insert cursor

    def _query(self, addr, sql: str):
        """One local-only SQL request on a pooled connection."""
        return self.pool.call(addr, lambda c: c.query(sql, local=True))

    def close(self):
        # the pool is process-shared; provider instances (one per
        # request) must not tear it down
        pass

    # table schema from the first worker that knows it
    def describe(self, table_name: str) -> Optional[TableInfo]:
        from eventql_tpu_torch.core.types import _TYPENAMES

        for addr in self.workers:
            try:
                results = self._query(addr, f"describe `{table_name}`;")
            except (OSError, ConnectionError, SQLError):
                continue
            _cols, rows = results[0]
            name_map = {v: k for k, v in _TYPENAMES.items()}
            columns = []
            for row in rows:
                columns.append((row[0], name_map.get(row[1], SType.STRING)))
            return TableInfo(table_name, columns)
        return None

    def list_tables(self):
        names = set()
        for addr in self.workers:
            try:
                results = self._query(addr, "show tables;")
                for row in results[0][1]:
                    names.add(row[0])
            except (OSError, ConnectionError, SQLError):
                continue
        return [self.describe(n) for n in sorted(names)]

    def cluster_servers(self):
        """(name, status, addr) rows for CLUSTER SHOW SERVERS."""

        rows = []
        for host, port in self.workers:
            try:
                up = self.pool.call((host, port), lambda c: c.ping())
            except (OSError, SQLError):
                up = False
            rows.append(
                (f"{host}:{port}", "SERVER_UP" if up else "SERVER_DOWN",
                 f"{host}:{port}")
            )
        return rows

    # -- DDL / DML -----------------------------------------------------
    # DDL broadcasts to every worker; an insert goes to one worker,
    # round robin.
    def create_table(self, node: qn.CreateTableNode):
        sql = create_table_sql(node)
        for addr in self.workers:
            self._query(addr, sql)

    def drop_table(self, table_name: str):
        for addr in self.workers:
            self._query(addr, f"drop table `{table_name}`;")

    def insert_json(self, table_name: str, json_data: str):
        addr = self.workers[self._rr % len(self.workers)]
        self._rr += 1
        self.pool.call(
            addr,
            lambda c: c.insert_json(table_name, [json_data], local=True),
        )

    def insert(self, table_name: str, columns, values):
        record = {}
        for cname, v in zip(columns, values):
            p = v.payload()
            if isinstance(p, bytes):
                p = p.decode("utf-8", errors="surrogateescape")
            record[cname] = None if v.is_null else p
        import json as _json

        self.insert_json(table_name, _json.dumps(record))

    def _scan_all_plan(self, table_name: str) -> str:
        """Serialized trivial select-all scan to ship to each owner."""
        from eventql_tpu_torch.plan.coder import encode_plan
        from eventql_tpu_torch.plan.exprs import ColumnReferenceNode

        info = self.describe(table_name)
        if info is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        scan = qn.SequentialScanNode(table_name, info.columns)
        for i, (cname, ctype) in enumerate(info.columns):
            scan.input_columns.append((cname, ctype))
            scan.select_list.append(
                qn.SelectListEntry(
                    ColumnReferenceNode(cname, ctype, i), cname
                )
            )
        scan.output_columns = [c[0] for c in info.columns]
        return encode_plan(scan)

    def _remote_fetch(self, addr, payload) -> Relation:
        return self.pool.call(
            addr,
            lambda c: relation_from_bytes(c.query_remote(payload)),
        )

    def get_table_data(self, table_name: str) -> Relation:
        """Pull a table's rows from every owner via QUERY_REMOTE — the
        fallback tier for plan shapes that aren't partial-aggregatable
        (reference: query_remote.cc streams the scanned rows back)."""
        from eventql_tpu_torch.parallel.partitioned import _concat_columns

        plan_data = self._scan_all_plan(table_name)
        shards = self._per_partition(
            table_name, plan_data, self._remote_fetch, scan_key="keyrange"
        )

        names = shards[0].names
        cols = [
            _concat_columns([sh.columns[i] for sh in shards])
            for i in range(len(names))
        ]
        return Relation(names, cols, sum(sh.num_rows for sh in shards))

    def get_table_chunks(self, table_name: str, chunk_rows: int):
        """Worker-at-a-time streaming source: the coordinator holds at
        most ONE worker's rows while a huge SELECT streams out
        (reference: the scheduler pulls remote partitions through a
        cursor one at a time, sql/scheduler.cc + result_cursor.h:35-75).
        Row order equals get_table_data (workers in list order)."""
        plan_data = self._scan_all_plan(table_name)
        ctx = getattr(self, "exec_ctx", None)
        if ctx is not None:
            ctx.add_tasks(len(self.workers))
        for addr in self.workers:
            shard = self._remote_fetch(addr, plan_data)
            if ctx is not None:
                ctx.complete_task()
            yield from shard.iter_chunks(chunk_rows)

    # -- worker fan-out ------------------------------------------------
    def _per_partition(self, table_name, plan_data, fetch, scan_key):
        """Run `fetch(addr, plan_data)` once per worker, concurrently."""
        ctx = getattr(self, "exec_ctx", None)
        if ctx is not None:
            ctx.add_tasks(len(self.workers))

        def one_worker(a):
            out = fetch(a, plan_data)
            if ctx is not None:
                ctx.complete_task()
            return out

        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(len(self.workers), MAX_CONCURRENT_SHARDS)
        ) as pool:
            return list(pool.map(one_worker, self.workers))

    # -- distributed execution -----------------------------------------
    def execute_pushdown_limit(self, node: qn.LimitNode):
        """Distributed top-k: ship Limit(OrderBy(scan)) / Limit(scan) to
        every partition, merge the candidate sets, re-sort, slice
        (reference: the scheduler pushes limits into the remote
        subqueries; the merge is an OrderByMerge)."""
        from eventql_tpu_torch.exec.operators import _order_relation
        from eventql_tpu_torch.parallel.partitioned import _concat_columns
        from eventql_tpu_torch.plan.coder import encode_plan

        inner = node.table
        order_specs = None
        if isinstance(inner, qn.OrderByNode):
            order_specs = inner.sort_specs
            scan = inner.table
        else:
            scan = inner
        if not isinstance(scan, qn.SequentialScanNode):
            return None
        if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
            return None

        # workers must return their top offset+limit candidates
        shipped = qn.LimitNode(node.offset + node.limit, 0, inner)
        plan_data = encode_plan(shipped)

        def fetch(addr, payload):
            return self.pool.call(
                addr,
                lambda c: relation_from_bytes(c.query_remote(payload)),
            )

        shards = self._per_partition(
            scan.table_name, plan_data, fetch, scan_key="walk"
        )
        names = shards[0].names
        cols = [
            _concat_columns([sh.columns[i] for sh in shards])
            for i in range(len(names))
        ]
        merged = Relation(names, cols, sum(sh.num_rows for sh in shards))
        if order_specs is not None:
            merged = _order_relation(merged, order_specs)
        import numpy as np

        idx = np.arange(merged.num_rows)[
            node.offset : node.offset + node.limit
        ]
        return merged.gather(idx)

    def execute_partial_aggregate(self, node: qn.GroupByNode):
        """Fan the encoded partial-aggregate plan out to all workers and
        merge their partials (GroupByMerge)."""
        from eventql_tpu_torch.exec.operators import _merge_partials
        from eventql_tpu_torch.plan.coder import encode_plan

        if not _plan_distributable(node):
            return None
        plan_data = encode_plan(node)

        # template partial: entry structure with the coordinator's
        # emit exprs/agg calls (no data)
        template = _make_template_partial(node)

        ctx = getattr(self, "exec_ctx", None)

        def fetch(addr, payload):
            raw = self.pool.call(
                addr, lambda c: c.query_partialaggr(payload)
            )
            partial = partial_from_bytes(raw, template)
            if ctx is not None:
                # cluster-wide scanned rows reported by each shard
                ctx.count_scan(getattr(partial, "rows_scanned", 0))
            return partial

        partials = self._per_partition(
            node.table.table_name, plan_data, fetch, scan_key="table"
        )
        return _merge_partials(node, partials)


_MERGEABLE = {"sum", "count", "min", "max", "mean", "count_distinct"}


def _plan_distributable(node: qn.GroupByNode) -> bool:
    """Same shape check as the in-process partitioned path
    (parallel/partitioned.py): flat scan + mergeable aggregates only."""
    from eventql_tpu_torch.plan.exprs import CallExpressionNode, has_aggregate_call

    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return False
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return False
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            stack = [sl.expr]
            while stack:
                e = stack.pop()
                if isinstance(e, CallExpressionNode) and e.is_aggregate():
                    if e.sfunction.aggregate.kind not in _MERGEABLE:
                        return False
                stack.extend(e.arguments())
    return True


def _make_template_partial(node: qn.GroupByNode):
    from eventql_tpu_torch.exec.operators import (
        GroupByPartial,
        _strip_aggregates,
    )
    from eventql_tpu_torch.plan.exprs import CallExpressionNode, has_aggregate_call

    entries = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            calls: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, calls)
            states = []
            for c in calls:
                kind = c.sfunction.aggregate.kind
                states.append((kind if kind != "mean" else "mean", None))
            entries.append(("agg", emit, states, calls))
        else:
            entries.append(("first", None))
    return GroupByPartial([], 0, entries)


def create_table_sql(node: qn.CreateTableNode) -> str:
    """Regenerate CREATE TABLE DDL from the parsed node (for broadcasting
    to workers; reference nodes receive the config via metadata ops)."""

    def col(c, indent="  "):
        if c.subcolumns is not None:
            inner = ",\n".join(col(sc, indent + "  ") for sc in c.subcolumns)
            t = f"RECORD (\n{inner}\n{indent})"
        else:
            t = c.column_type
        rep = "REPEATED " if c.repeated else ""
        nn = " NOT NULL" if c.not_null else ""
        return f"{indent}{rep}`{c.column_name}` {t}{nn}"

    parts = [col(c) for c in node.columns]
    if node.primary_key:
        pk = ", ".join(f"`{k}`" for k in node.primary_key)
        parts.append(f"  PRIMARY KEY ({pk})")
    return f"CREATE TABLE `{node.table_name}` (\n" + ",\n".join(parts) + "\n);"


def cluster_provider_from_config(config_dir_path: str) -> "ClusterTableProvider":
    """Build the coordinator's fan-out provider from the standalone
    config directory: live-worker list plus the server_id address book
    and the registry handle for partition metadata."""
    from eventql_tpu_torch.exec.operators import _not_ported

    raise _not_ported("config/")
