"""Replication repair: anti-entropy catch-up for replicas that missed
writes.

The reference's ReplicationWorker pushes partition data from hosting
nodes to lagging replicas in the background
(reference: db/replication_worker.cc — per-partition repl queues,
db/partition_replication.cc computes what a replica is missing). This
is the pull-side analog suited to our synchronous-majority write path:
each node periodically diffs its primary keys against the other
replicas of every partition it hosts and pulls the records it missed.
Together with newest-wins upserts this converges replicas without
coordination.
"""

from __future__ import annotations

import json
import threading
from typing import List, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_, SQLError


class ReplicationWorker:
    def __init__(
        self,
        table_service,
        config_dir_path: str,
        server_name: str,
        interval: float = 10.0,
    ):
        self.table_service = table_service
        self.config_dir_path = config_dir_path
        self.server_name = server_name
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval + 5)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.repair_once()
            except Exception:
                pass  # transient cluster errors; retry next sweep
            try:
                self.push_once()
            except Exception:
                pass
            try:
                self.lifecycle_once()
            except Exception:
                pass

    # -- one repair sweep ------------------------------------------------
    def repair_once(self) -> int:
        """Pull missed records from peer replicas; returns the number of
        records repaired."""
        from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory
        from eventql_tpu_torch.db.metadata import TableMetadata
        from eventql_tpu_torch.server.native_tcp import NativeTCPClient

        cdir = ConfigDirectory(self.config_dir_path)
        addr_of = {}
        for s in cdir.list_servers():
            if s.server_status == SERVER_UP and s.server_addr:
                host, _, port = s.server_addr.rpartition(":")
                addr_of[s.server_id] = (host or "127.0.0.1", int(port))

        repaired = 0
        for info in self.table_service.list_tables() or []:
            table_name = info.table_name
            # nested tables reconstruct through the shredded path, which
            # the flat QUERY_REMOTE pull would lose — skip for now
            t = getattr(self.table_service, "tables", {}).get(table_name)
            if t is not None and getattr(t, "has_repeated", False):
                continue
            cfg = cdir.get_table_config("default", table_name)
            if not cfg or "metadata" not in cfg:
                continue
            meta = TableMetadata.from_json(cfg["metadata"])
            pk = meta.partition_key

            for entry in meta.entries:
                if self.server_name not in entry.servers:
                    continue
                peers = [
                    sid
                    for sid in entry.servers
                    if sid != self.server_name and sid in addr_of
                ]
                if not peers:
                    continue
                begin, end = meta.keyrange(entry.partition_id)
                local_keys = self._local_pk_set(table_name, pk, begin, end)

                for sid in peers:
                    try:
                        client = NativeTCPClient(*addr_of[sid])
                    except (OSError, ConnectionError):
                        continue
                    try:
                        repaired += self._pull_missing(
                            client, table_name, info, pk,
                            begin, end, local_keys,
                        )
                    except (OSError, SQLError, ConnectionError):
                        pass
                    finally:
                        client.close()
        return repaired

    def push_once(self) -> int:
        """Push-based anti-entropy: offer locally-held records a peer
        replica is missing via EVQL_OP_REPL_INSERT (the reference's
        ReplicationWorker is push-only — per-target segment offers with
        acked-server tracking, db/partition_replication.cc:154-455; we
        compute the per-peer diff from the peer's primary-key set and
        ship the missing rows as a ShreddedRecordList). Returns the
        number of records pushed."""
        from eventql_tpu_torch.config.config_directory import (
            SERVER_UP,
            ConfigDirectory,
        )
        from eventql_tpu_torch.db.metadata import TableMetadata
        from eventql_tpu_torch.db.shredded_record_list import from_relation
        from eventql_tpu_torch.server.native_tcp import NativeTCPClient

        cdir = ConfigDirectory(self.config_dir_path)
        addr_of = {}
        for s in cdir.list_servers():
            if s.server_status == SERVER_UP and s.server_addr:
                host, _, port = s.server_addr.rpartition(":")
                addr_of[s.server_id] = (host or "127.0.0.1", int(port))

        pushed = 0
        for info in self.table_service.list_tables() or []:
            table_name = info.table_name
            t = getattr(self.table_service, "tables", {}).get(table_name)
            if t is not None and getattr(t, "has_repeated", False):
                continue
            cfg = cdir.get_table_config("default", table_name)
            if not cfg or "metadata" not in cfg:
                continue
            meta = TableMetadata.from_json(cfg["metadata"])
            pk = meta.partition_key

            for entry in meta.entries:
                if self.server_name not in entry.servers:
                    continue
                begin, end = meta.keyrange(entry.partition_id)
                local_rel = self._local_relation_in_range(
                    table_name, pk, begin, end, meta.keyspace
                )
                if local_rel is None or not local_rel.num_rows:
                    continue
                pk_idx = local_rel.names.index(pk)
                for sid in entry.servers:
                    if sid == self.server_name or sid not in addr_of:
                        continue
                    try:
                        client = NativeTCPClient(*addr_of[sid])
                    except (OSError, ConnectionError):
                        continue
                    try:
                        peer = self._remote_relation(
                            client, table_name, info, pk, begin, end
                        )
                        peer_keys = set()
                        pcol = peer.columns[peer.names.index(pk)]
                        for i in range(peer.num_rows):
                            v = pcol.value_at(i)
                            if not v.is_null:
                                peer_keys.add(self._norm(v.payload()))
                        missing = [
                            r
                            for r in range(local_rel.num_rows)
                            if not local_rel.columns[pk_idx].value_at(r).is_null
                            and self._norm(
                                local_rel.columns[pk_idx].value_at(r).payload()
                            )
                            not in peer_keys
                        ]
                        if not missing:
                            continue
                        import numpy as _np

                        subset = local_rel.gather(
                            _np.array(missing, dtype=_np.int64)
                        )
                        records = from_relation(subset, pk_names=[pk])
                        # ship the true head version per record so the
                        # peer's write-time version check makes replays
                        # no-ops (records with no tracked version fall
                        # back to 1: newer than absent (0), equal on
                        # replay)
                        local_t = getattr(
                            self.table_service, "tables", {}
                        ).get(table_name)
                        if local_t is not None:
                            records.record_versions = [
                                max(1, local_t.head_version(rid))
                                for rid in records.record_ids
                            ]
                        client.repl_insert(
                            table_name, entry.partition_id, records
                        )
                        pushed += len(missing)
                    except (OSError, SQLError, ConnectionError):
                        pass
                    finally:
                        client.close()
        return pushed

    def _local_relation_in_range(self, table_name, pk, begin, end, keyspace):
        from eventql_tpu_torch.exec.operators import _apply_keyrange

        try:
            rel = self.table_service.get_table_data(table_name)
        except SQLError:
            return None
        if begin == "" and end == "":
            return rel
        return _apply_keyrange(rel, (pk, begin, end))

    def _local_pk_set(self, table_name, pk, begin, end, keyspace=None):
        rel = self.table_service.get_table_data(table_name)
        idx = rel.names.index(pk)
        col = rel.columns[idx]
        out = set()
        for i in range(rel.num_rows):
            v = col.value_at(i)
            if not v.is_null:
                out.add(self._norm(v.payload()))
        if keyspace is not None and (begin != "" or end != ""):
            from eventql_tpu_torch.db.metadata_file import compare_keys

            out = {
                k
                for k in out
                if (begin == "" or compare_keys(keyspace, begin, k) <= 0)
                and (end == "" or compare_keys(keyspace, k, end) < 0)
            }
        return out

    @staticmethod
    def _norm(v):
        if isinstance(v, bytes):
            return v.decode("utf-8", errors="surrogateescape")
        return v

    # -- partition lifecycle (LOAD → FINALIZE_SPLIT → UNLOAD) -------------
    def lifecycle_once(self) -> List[str]:
        """One pass of the partition-lifecycle state machine over every
        table with a METADATA transaction chain (reference:
        db/partition_discovery.cc states + partitioning.txt §4.3):

        * LOAD — this server is a split target (or joining replica):
          pull the child keyrange's rows from the parent's serving
          replicas until caught up.
        * SERVE of a splitting partition — once every split target
          holds all in-range primary keys, finalize the split with a
          CAS METAOP_FINALIZE_SPLIT (first replica wins; losers see
          'concurrent modification' and move on).
        * UNLOAD — this server appears nowhere in the partition map
          anymore: drop the local rows (schema stays; the files move
          to .trash for the GC sweep).

        Returns human-readable action lines."""
        from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory
        from eventql_tpu_torch.core.errors import RuntimeError_
        from eventql_tpu_torch.db.metadata_file import (
            METAOP_FINALIZE_SPLIT,
            MetadataOperation,
        )
        from eventql_tpu_torch.db.metadata_service import MetadataCoordinator
        from eventql_tpu_torch.db.metadata_transport import remote_factory_from_cdir
        from eventql_tpu_torch.server.native_tcp import NativeTCPClient

        cdir = ConfigDirectory(self.config_dir_path)
        addr_of = {}
        for s in cdir.list_servers():
            if s.server_status == SERVER_UP and s.server_addr:
                host, _, port = s.server_addr.rpartition(":")
                addr_of[s.server_id] = (host or "127.0.0.1", int(port))
        coord = MetadataCoordinator(
            cdir, remote_service_factory=remote_factory_from_cdir(cdir)
        )

        actions: List[str] = []
        doc = cdir._read()
        tables = doc.get("namespaces", {}).get("default", {}).get("tables", {})
        for table_name, cfg in tables.items():
            if not cfg.get("metadata_txnid"):
                continue
            info = self.table_service.describe(table_name)
            if info is None:
                continue  # schema not on this node
            try:
                head = coord.get_head_file("default", table_name)
            except RuntimeError_:
                continue
            pk = head.partition_key

            i_appear = False
            for i, e in enumerate(head.entries):
                serving = {p.server_id for p in e.servers}
                if self.server_name in e.all_server_ids():
                    i_appear = True

                children = []
                if e.splitting:
                    e_end = head.entry_end(i)
                    children = [
                        (e.begin, e.split_point,
                         {p.server_id for p in e.split_servers_low}),
                        (e.split_point, e_end,
                         {p.server_id for p in e.split_servers_high}),
                    ]
                    for (cb, ce, csids) in children:
                        if self.server_name in csids:
                            i_appear = True

                # LOAD: pull child ranges assigned to us from the
                # parent's serving replicas
                for (cb, ce, csids) in children:
                    if (
                        self.server_name not in csids
                        or self.server_name in serving
                    ):
                        continue
                    local = self._local_pk_set(
                        table_name, pk, cb, ce, head.keyspace
                    )
                    for sid in serving:
                        if sid == self.server_name or sid not in addr_of:
                            continue
                        try:
                            client = NativeTCPClient(*addr_of[sid])
                        except (OSError, ConnectionError):
                            continue
                        try:
                            n = self._pull_missing(
                                client, table_name, info, pk, cb, ce, local
                            )
                            if n:
                                actions.append(
                                    f"{table_name}/{e.partition_id}: loaded"
                                    f" {n} rows for child [{cb},{ce}) from"
                                    f" {sid}"
                                )
                        except (OSError, SQLError, ConnectionError):
                            pass
                        finally:
                            client.close()

                # SERVE of a splitting partition: finalize once every
                # split target holds all in-range primary keys
                if e.splitting and self.server_name in serving:
                    if self._split_targets_caught_up(
                        table_name, info, pk, head, children, serving, addr_of
                    ):
                        op = MetadataOperation(
                            "default",
                            table_name,
                            METAOP_FINALIZE_SPLIT,
                            {"partition_id": e.partition_id},
                            input_txnid=head.txnid,
                        )
                        try:
                            coord.perform_and_commit_operation(
                                "default", table_name, op
                            )
                            actions.append(
                                f"{table_name}/{e.partition_id}:"
                                " split finalized"
                            )
                        except RuntimeError_:
                            pass  # another replica finalized first

            # UNLOAD: the head names us nowhere — drop local rows
            if not i_appear:
                try:
                    if self.table_service.get_table_data(table_name).num_rows:
                        self.table_service.truncate_table(table_name)
                        actions.append(f"{table_name}: unloaded local rows")
                except (RuntimeError_, ValueError):
                    pass
        return actions

    def _split_targets_caught_up(
        self, table_name, info, pk, head, children, serving, addr_of
    ) -> bool:
        """True when every split target (that is not itself a serving
        replica) holds at least our in-range primary keys. Exact-set
        containment over QUERY_REMOTE; the reference tracks per-segment
        ack offsets instead (db/partition_replication.cc)."""
        from eventql_tpu_torch.server.native_tcp import NativeTCPClient

        for (cb, ce, csids) in children:
            ours = self._local_pk_set(table_name, pk, cb, ce, head.keyspace)
            for sid in csids:
                if sid in serving:
                    continue  # already holds the parent's rows
                if sid not in addr_of:
                    return False
                try:
                    client = NativeTCPClient(*addr_of[sid])
                except (OSError, ConnectionError):
                    return False
                try:
                    rel = self._remote_relation(
                        client, table_name, info, pk, cb, ce
                    )
                    pk_idx = rel.names.index(pk)
                    theirs = set()
                    for r in range(rel.num_rows):
                        v = rel.columns[pk_idx].value_at(r)
                        if not v.is_null:
                            theirs.add(self._norm(v.payload()))
                    if not ours <= theirs:
                        return False
                except (OSError, SQLError, ConnectionError):
                    return False
                finally:
                    client.close()
        return True

    def _remote_relation(self, client, table_name, info, pk, begin, end):
        """Fetch a peer's rows in this keyrange (QUERY_REMOTE ships a
        keyrange-scoped scan, like ops/query_remote.cc)."""
        from eventql_tpu_torch.parallel.cluster import relation_from_bytes
        from eventql_tpu_torch.plan import nodes as qn
        from eventql_tpu_torch.plan.coder import encode_plan
        from eventql_tpu_torch.plan.exprs import ColumnReferenceNode

        scan = qn.SequentialScanNode(table_name, info.columns)
        for i, (cname, ctype) in enumerate(info.columns):
            scan.input_columns.append((cname, ctype))
            scan.select_list.append(
                qn.SelectListEntry(ColumnReferenceNode(cname, ctype, i), cname)
            )
        scan.output_columns = [c[0] for c in info.columns]
        scan.keyrange = (pk, begin, end)
        return relation_from_bytes(client.query_remote(encode_plan(scan)))

    def _pull_missing(
        self, client, table_name, info, pk, begin, end, local_keys
    ) -> int:
        """Fetch the peer's rows in this keyrange (QUERY_REMOTE) and
        insert the ones whose primary key is absent locally."""
        rel = self._remote_relation(client, table_name, info, pk, begin, end)

        pk_idx = rel.names.index(pk)
        n_repaired = 0
        for r in range(rel.num_rows):
            kv = rel.columns[pk_idx].value_at(r)
            if kv.is_null:
                continue
            key = self._norm(kv.payload())
            if key in local_keys:
                continue
            record = {}
            for name, col in zip(rel.names, rel.columns):
                v = col.value_at(r)
                if v.is_null:
                    continue
                record[name] = self._norm(v.payload())
            self.table_service.insert_json(table_name, json.dumps(record))
            local_keys.add(key)
            n_repaired += 1
        return n_repaired
