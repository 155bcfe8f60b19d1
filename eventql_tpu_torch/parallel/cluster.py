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
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu_torch.core.errors import RuntimeError_, SQLError
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.exec.runtime import TableInfo
from eventql_tpu_torch.plan import nodes as qn
from eventql_tpu_torch.plan.builder import TableProvider

# reference: evqld.cc:245-246 fan-out limits
MAX_CONCURRENT_SHARDS = 256  # reference: evqld.cc:245
MAX_CONCURRENT_SHARDS_PER_HOST = 6  # reference: evqld.cc:246


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
    """Routes queries to worker processes that own table shards
    (reference: TSDBTableProvider + metadata partition lookup)."""

    def __init__(
        self,
        workers: List[Tuple[str, int]],
        cdir=None,
        server_map: Optional[Dict[str, Tuple[str, int]]] = None,
        failed_shard_policy: str = "tolerate",
    ):
        self.workers = list(workers)
        # cluster registry + server_id → address book enable the
        # metadata tier: partition-routed writes with replication and
        # one-replica-per-partition reads (absent → every worker owns
        # its local rows and queries fan to all of them)
        self.cdir = cdir
        self.server_map = dict(server_map or {})
        # pooled server-to-server connections, shared process-wide so
        # per-request provider instances reuse sockets across queries
        # (reference: TCPConnectionPool in db/database.cc:283-290)
        from eventql_tpu_torch.parallel.conn_pool import global_pool

        self.pool = global_pool()
        self._rr = 0  # round-robin insert cursor
        # reference default: query_failed_shard_policy=tolerate
        # (evqld.cc:247) — queries return partial results with
        # failed-shard accounting instead of erroring
        self.failed_shard_policy = failed_shard_policy
        self.num_failed_shards = 0

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

    def table_partitions(self, table_name: str):
        """(partition_id, servers, (begin, end)) rows for DESCRIBE
        PARTITIONS (reference: describe_partitions.cc)."""
        meta = self._table_metadata(table_name)
        if meta is None:
            return None
        return [
            (e.partition_id, list(e.servers), meta.keyrange(e.partition_id))
            for e in meta.entries
        ]

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

    # -- partition metadata --------------------------------------------
    def _table_metadata(self, table_name: str):
        from eventql_tpu_torch.db.metadata import TableMetadata

        if self.cdir is None:
            return None
        cfg = self.cdir.get_table_config("default", table_name)
        if not cfg or "metadata" not in cfg:
            return None
        return TableMetadata.from_json(cfg["metadata"])

    def _replication_factor(self) -> int:
        if self.cdir is None:
            return 1
        cc = self.cdir.get_cluster_config() or {}
        return int(cc.get("replication_factor", 1))

    def _metadata_coordinator(self):
        """CAS coordinator over this provider's address book
        (reference: db/metadata_coordinator.cc)."""
        from eventql_tpu_torch.db.metadata_service import MetadataCoordinator
        from eventql_tpu_torch.db.metadata_transport import MetadataServiceProxy

        proxies: Dict[str, MetadataServiceProxy] = {}

        def factory(server_id: str):
            proxy = proxies.get(server_id)
            if proxy is None:
                addr = self._addr_of(server_id)
                if addr is None:
                    raise RuntimeError_(
                        f"unknown metadata server: {server_id}"
                    )
                proxy = MetadataServiceProxy(addr[0], addr[1])
                proxies[server_id] = proxy
            return proxy

        return MetadataCoordinator(self.cdir, remote_service_factory=factory)

    def _addr_of(self, server_id: str) -> Optional[Tuple[str, int]]:
        return self.server_map.get(server_id)

    # -- DDL / DML -----------------------------------------------------
    # DDL broadcasts to every node (the reference pushes table configs
    # through the metadata service); inserts route by partition key to
    # all replicas of the owning partition with majority confirmation
    # (reference: table_service.cc:933-1058).
    def create_table(self, node: qn.CreateTableNode):
        from eventql_tpu_torch.db.metadata import (
            KEYSPACE_STRING,
            KEYSPACE_UINT64,
            TableMetadata,
        )

        sql = create_table_sql(node)
        for addr in self.workers:
            self._query(addr, sql)

        if self.cdir is not None and node.primary_key and self.server_map:
            pk = node.primary_key[0]
            pk_type = ""
            for cd in node.columns:
                if cd.column_name == pk:
                    pk_type = cd.column_type.upper()
            keyspace = (
                KEYSPACE_STRING
                if pk_type == "STRING"
                else KEYSPACE_UINT64
            )
            sids = sorted(self.server_map)
            nrepl = min(max(1, self._replication_factor()), len(sids))
            # create the table's METADATA transaction chain on the
            # metadata servers (majority store + head pointer commit,
            # reference: db/metadata_coordinator.cc createFile +
            # doc/internals/partitioning.txt §5.1); the derived
            # partition-map view lands in the table config for routing.
            # Nodes without a metadata service (embedded test workers)
            # fall back to a direct registry write of the same view.
            from eventql_tpu_torch.db.metadata_file import MetadataFile

            mfile = MetadataFile.initial(
                keyspace, pk, node.table_name, sids[:nrepl]
            )
            try:
                self._metadata_coordinator().create_file(
                    "default", node.table_name, mfile, sids[:nrepl]
                )
            except RuntimeError_:
                meta = TableMetadata.initial(
                    keyspace, pk, node.table_name, sids[:nrepl]
                )
                self.cdir.update_table_config(
                    "default", node.table_name, {"metadata": meta.to_json()}
                )

    def drop_table(self, table_name: str):
        for addr in self.workers:
            self._query(addr, f"drop table `{table_name}`;")

    def insert_json(self, table_name: str, json_data: str):
        import json as _json

        meta = self._table_metadata(table_name)
        if meta is None:
            addr = self.workers[self._rr % len(self.workers)]
            self._rr += 1
            self.pool.call(
                addr,
                lambda c: c.insert_json(table_name, [json_data], local=True),
            )
            return

        record = _json.loads(json_data)
        key = record.get(meta.partition_key)
        if key is None:
            raise RuntimeError_(f"missing field: {meta.partition_key}")
        entry = meta.lookup(key)

        # write every replica; require majority confirmations
        # (EVQL_CLEVEL_WRITE_RELAXED semantics, table_service.cc:1036-48)
        nconf = 0
        for sid in entry.servers:
            addr = self._addr_of(sid)
            if addr is None:
                continue
            try:
                self.pool.call(
                    addr,
                    lambda c: c.insert_json(
                        table_name, [json_data], local=True
                    ),
                )
                nconf += 1
            except (OSError, SQLError, ConnectionError):
                pass
        required = (len(entry.servers) + 1) // 2
        if nconf < required:
            raise RuntimeError_(
                "couldn't perform enough replica writes for the requested"
                f" consistency level; only {nconf} out of {required}"
                " (required) writes succeeded"
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
        """Partition-at-a-time streaming source: the coordinator holds
        at most ONE partition's rows while a huge SELECT streams out
        (reference: the scheduler pulls remote partitions through a
        cursor one at a time, sql/scheduler.cc + result_cursor.h:35-75).
        Row order equals get_table_data (jobs in placement order)."""
        import numpy as np

        plan_data = self._scan_all_plan(table_name)
        ctx = getattr(self, "exec_ctx", None)
        jobs = self._partition_jobs(table_name, plan_data)
        if jobs is None:
            if ctx is not None:
                ctx.add_tasks(len(self.workers))

            def _worker_iter():
                for addr in self.workers:
                    out = self._remote_fetch(addr, plan_data)
                    if ctx is not None:
                        ctx.complete_task()
                    yield out

            shard_iter = _worker_iter()
        else:
            if ctx is not None:
                ctx.add_tasks(len(jobs))
            shard_iter = (
                self._fetch_with_failover(job, self._remote_fetch)
                for job in jobs
            )
        got_any = False
        for shard in shard_iter:
            if shard is None:  # tolerated failed shard
                continue
            got_any = True
            yield from shard.iter_chunks(chunk_rows)
        if jobs is not None and not got_any:
            raise SQLError("no live replica for any partition")

    # -- partition fan-out ---------------------------------------------
    def _partition_jobs(self, table_name, plan_data):
        """(entry, payload) jobs, one per partition with the plan's
        seqscan scoped to the partition keyrange — or None when the
        table has no partition metadata (whole-plan per worker)."""
        import copy

        from eventql_tpu_torch.plan.coder import decode_plan, encode_plan

        meta = self._table_metadata(table_name)
        if meta is None:
            return None
        # decode-patch-reencode works for BOTH wire encodings (binary
        # qtree default, JSON debug): scope the plan's seqscan to each
        # partition's keyrange like the reference's per-partition qtree
        # copies (server/sql/scheduler.cc:242-261)
        base = decode_plan(plan_data)
        jobs = []
        for entry in meta.entries:
            begin, end = meta.keyrange(entry.partition_id)
            node = copy.deepcopy(base)
            target = node
            while not isinstance(target, qn.SequentialScanNode):
                target = target.table
            target.keyrange = (meta.partition_key, begin, end)
            jobs.append((entry, encode_plan(node)))
        return jobs

    def _fetch_with_failover(self, job, fetch, host_sem=None):
        """First live replica down the placement list; tolerate policy
        returns None (reference: groupby.cc:511,622-628). Each job is
        one shard TASK for progress accounting (reference:
        execution_context.h incrementNumTasksCompleted per shard)."""
        ctx = getattr(self, "exec_ctx", None)
        entry, payload = job
        last_err = None
        for sid in entry.servers:
            addr = self._addr_of(sid)
            if addr is None:
                continue
            try:
                if host_sem is not None:
                    with host_sem(addr):
                        out = fetch(addr, payload)
                else:
                    out = fetch(addr, payload)
                if ctx is not None:
                    ctx.complete_task()
                return out
            except (OSError, ConnectionError) as e:
                last_err = e  # replica down: fail over to the next
        if self.failed_shard_policy == "tolerate":
            self.num_failed_shards += 1
            if ctx is not None:
                ctx.fail_task()
            return None
        raise SQLError(
            f"no live replica for partition {entry.partition_id}"
            + (f" ({last_err})" if last_err else "")
        )

    def _per_partition(self, table_name, plan_data, fetch, scan_key):
        """Run `fetch(addr, payload)` once per partition (keyrange-scoped
        plan, first live replica; failover down the placement list), or
        once per worker when the table has no partition metadata."""
        ctx = getattr(self, "exec_ctx", None)
        jobs = self._partition_jobs(table_name, plan_data)
        if jobs is None:
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
        if ctx is not None:
            ctx.add_tasks(len(jobs))

        # per-host in-flight cap (reference: TCPAsyncClient's
        # max_concurrent_tasks_per_host, client_tcp.h:109-231)
        import threading as _threading

        host_sems = {}
        sems_lock = _threading.Lock()

        def _host_sem(addr):
            with sems_lock:
                sem = host_sems.get(addr)
                if sem is None:
                    sem = _threading.Semaphore(
                        MAX_CONCURRENT_SHARDS_PER_HOST
                    )
                    host_sems[addr] = sem
                return sem

        def one(job):
            return self._fetch_with_failover(job, fetch, _host_sem)

        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(len(jobs), MAX_CONCURRENT_SHARDS)
        ) as pool:
            out = [r for r in pool.map(one, jobs) if r is not None]
        if not out:
            raise SQLError("no live replica for any partition")
        return out

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
    from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory

    cdir = ConfigDirectory(config_dir_path)
    server_map = {}
    for s in cdir.list_servers():
        if s.server_status == SERVER_UP and s.server_addr:
            host, _, port = s.server_addr.rpartition(":")
            server_map[s.server_id] = (host or "127.0.0.1", int(port))
    return ClusterTableProvider(
        cdir.worker_addrs(), cdir=cdir, server_map=server_map
    )
