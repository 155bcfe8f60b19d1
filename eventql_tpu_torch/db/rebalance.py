"""Cluster rebalance: repair partition placements after membership
changes.

Re-implements the decision core of the reference's Rebalance pass
(reference: db/rebalance.cc — walks every table's partition map,
removes placements on dead/removed servers, and assigns new replicas
until each partition meets the cluster's replication factor, preferring
the least-loaded servers). Data movement is not done here: the new
replicas' anti-entropy workers (db/replication.py) pull the partition's
rows once the metadata names them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory
from eventql_tpu_torch.db.metadata import TableMetadata


def rebalance(cdir: ConfigDirectory, db: str = "default") -> List[str]:
    """One rebalance pass over every table. Returns human-readable
    change lines (for evqlctl output)."""
    cluster = cdir.get_cluster_config() or {}
    rf = int(cluster.get("replication_factor", 1))
    registered = {s.server_id for s in cdir.list_servers()}
    live = {
        s.server_id
        for s in cdir.list_servers()
        if s.server_status == SERVER_UP
    }

    # current load: partitions per server
    load: Dict[str, int] = {sid: 0 for sid in registered}
    tables: List[Tuple[str, TableMetadata]] = []
    doc = cdir._read()
    for table, cfg in (
        doc["namespaces"].get(db, {}).get("tables", {}).items()
    ):
        if "metadata" not in cfg:
            continue
        meta = TableMetadata.from_json(cfg["metadata"])
        tables.append((table, meta))
        for e in meta.entries:
            for sid in e.servers:
                if sid in load:
                    load[sid] += 1

    changes: List[str] = []
    for table, meta in tables:
        dirty = False
        for e in meta.entries:
            # drop placements on servers no longer in the cluster
            kept = [sid for sid in e.servers if sid in registered]
            for sid in e.servers:
                if sid not in registered:
                    changes.append(
                        f"{table}/{e.partition_id}: removed placement on"
                        f" departed server {sid}"
                    )
                    dirty = True
            e.servers = kept

            # backfill to the replication factor from live servers,
            # least-loaded first
            want = min(rf, len(live | set(kept)))
            candidates = sorted(
                (sid for sid in live if sid not in e.servers),
                key=lambda sid: (load.get(sid, 0), sid),
            )
            while len(e.servers) < want and candidates:
                sid = candidates.pop(0)
                e.servers.append(sid)
                load[sid] = load.get(sid, 0) + 1
                changes.append(
                    f"{table}/{e.partition_id}: added replica on {sid}"
                )
                dirty = True

        if dirty:
            cdir.update_table_config(db, table, {"metadata": meta.to_json()})
    return changes
