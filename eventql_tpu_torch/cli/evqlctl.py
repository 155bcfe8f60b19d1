"""Cluster administration CLI (reference: evqlctl.cc + cli/commands/*).

Command set mirrors the reference binary:

  cluster-create          Create a new cluster.
  cluster-add-server      Add a server to an existing cluster.
  cluster-remove-server   Remove an existing server from the cluster.
  cluster-status          Display the current cluster status.
  cluster-list            List the servers in the cluster.
  database-create         Create a new database.
  table-import            Import json or csv data to a table.
  table-config-set        Set table config parameters.
  table-split             Split partition.
  table-split-finalize    Split partition (finalize split).

The reference coordinates through ZooKeeper; this implementation uses
the standalone file-backed ConfigDirectory
(config/config_directory.py) that evqld processes also register with.
"""

from __future__ import annotations

import argparse
import json
import sys

from eventql_tpu_torch.config.config_directory import (
    SERVER_DOWN,
    SERVER_UP,
    ConfigDirectory,
    ServerConfig,
)
from eventql_tpu_torch.core.errors import RuntimeError_, SQLError


def _table(headers, rows, out):
    widths = [len(h) for h in headers]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(str(c)))
    fmt = "  ".join("%%-%ds" % w for w in widths)
    out.write(fmt % tuple(headers) + "\n")
    out.write(fmt % tuple("=" * w for w in widths) + "\n")
    for r in rows:
        out.write(fmt % tuple(str(c) for c in r) + "\n")


def cmd_cluster_create(cdir, args, out):
    cdir.cluster_create(args.cluster_name, args.replication_factor)
    out.write("cluster created\n")


def cmd_cluster_add_server(cdir, args, out):
    cdir.update_server_config(
        ServerConfig(
            server_id=args.server_name,
            server_addr=args.server_addr or "",
            server_status=SERVER_DOWN,
        )
    )
    out.write(f"server added: {args.server_name}\n")


def cmd_cluster_remove_server(cdir, args, out):
    cdir.remove_server(args.server_name)
    out.write(f"server removed: {args.server_name}\n")


def cmd_cluster_list(cdir, args, out):
    rows = [
        (
            s.server_id,
            s.server_status,
            s.server_addr,
            s.buildinfo,
            s.load_partitions,
            s.load_disk_used,
        )
        for s in cdir.list_servers()
    ]
    _table(
        ["Name", "Status", "Listen-Addr", "Build", "Partitions", "Disk-Used"],
        rows,
        out,
    )


def cmd_cluster_status(cdir, args, out):
    """Ping every registered server over the native protocol
    (reference: cluster_status.cc runs a healthcheck query per node)."""
    from eventql_tpu_torch.server.native_tcp import NativeTCPClient

    rows = []
    for s in cdir.list_servers():
        status = SERVER_DOWN
        if s.server_addr:
            host, _, port = s.server_addr.rpartition(":")
            try:
                c = NativeTCPClient(host or "127.0.0.1", int(port))
                if c.ping():
                    status = SERVER_UP
                c.close()
            except (OSError, SQLError):
                status = SERVER_DOWN
        rows.append((s.server_id, status, s.server_addr))
    _table(["Name", "Status", "Listen-Addr"], rows, out)


def cmd_database_create(cdir, args, out):
    cdir.create_namespace(args.database)
    out.write(f"database created: {args.database}\n")


def cmd_table_config_set(cdir, args, out):
    cdir.update_table_config(
        args.database or "default", args.table_name, {args.param: args.value}
    )
    out.write(f"table config updated: {args.table_name}\n")


def cmd_table_split(cdir, args, out):
    """Split a partition's keyrange at split_point (the reference
    enqueues a SPLIT_PARTITION metadata op, table_split.cc:113-171; in
    the standalone registry the split applies immediately — replicas
    keep the full keyrange, so no data moves and queries scope by the
    new ranges)."""
    from eventql_tpu_torch.db.metadata import TableMetadata

    db = args.database or "default"
    cfg = cdir.get_table_config(db, args.table_name)
    if not cfg or "metadata" not in cfg:
        raise RuntimeError_(f"table not found: {args.table_name}")
    meta = TableMetadata.from_json(cfg["metadata"])
    split_point = (
        int(args.split_point)
        if meta.keyspace == "uint64"
        else args.split_point
    )
    meta.split(args.partition_id, split_point)
    cdir.update_table_config(db, args.table_name, {"metadata": meta.to_json()})
    out.write(f"split applied to partition {args.partition_id}\n")


def cmd_table_split_finalize(cdir, args, out):
    # standalone splits apply immediately; finalize is a no-op ack
    out.write(f"split finalized for partition {args.partition_id}\n")


def cmd_rebalance(cdir, args, out):
    """Repair partition placements after membership changes (reference:
    db/rebalance.cc); new replicas backfill via the anti-entropy
    workers."""
    from eventql_tpu_torch.db.rebalance import rebalance

    changes = rebalance(cdir, args.database or "default")
    for line in changes:
        out.write(line + "\n")
    out.write(f"rebalance complete: {len(changes)} change(s)\n")


def cmd_table_import(args, out):
    """Stream a json/csv file into a table over the native protocol
    (reference: table_import.cc uploads in batches via the client lib)."""
    from eventql_tpu_torch.server.native_tcp import NativeTCPClient

    records = []
    if args.format == "csv":
        import csv as _csv

        with open(args.file, newline="") as f:
            for row in _csv.DictReader(f):
                records.append(json.dumps(row))
    else:
        with open(args.file) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(line)

    c = NativeTCPClient(args.host, args.port)
    BATCH = 128  # reference: table_import.cc kBatchSize
    n = 0
    for i in range(0, len(records), BATCH):
        c.insert_json(args.table_name, records[i : i + BATCH])
        n += len(records[i : i + BATCH])
    c.close()
    out.write(f"imported {n} records into {args.table_name}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="evqlctl", description="EventQL cluster administration"
    )
    ap.add_argument("-C", "--config_dir", default="/tmp/evql-cluster.json")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("cluster-create", help="Create a new cluster.")
    p.add_argument("--cluster_name", default="default")
    p.add_argument("--replication_factor", type=int, default=1)

    p = sub.add_parser(
        "cluster-add-server", help="Add a server to an existing cluster."
    )
    p.add_argument("--server_name", required=True)
    p.add_argument("--server_addr", default="")

    p = sub.add_parser(
        "cluster-remove-server",
        help="Remove an existing server from the cluster.",
    )
    p.add_argument("--server_name", required=True)

    sub.add_parser("cluster-status", help="Display the current cluster status.")
    sub.add_parser("cluster-list", help="List the servers in the cluster.")

    p = sub.add_parser("database-create", help="Create a new database.")
    p.add_argument("--database", required=True)

    p = sub.add_parser("table-config-set", help="Set table config parameters.")
    p.add_argument("--database", default="default")
    p.add_argument("--table_name", required=True)
    p.add_argument("param")
    p.add_argument("value")

    p = sub.add_parser("table-split", help="Split partition")
    p.add_argument("--database", default="default")
    p.add_argument("--table_name", required=True)
    p.add_argument("--partition_id", required=True)
    p.add_argument("--split_point", required=True)

    p = sub.add_parser(
        "table-split-finalize", help="Split partition (finalize split)"
    )
    p.add_argument("--database", default="default")
    p.add_argument("--table_name", required=True)
    p.add_argument("--partition_id", required=True)

    p = sub.add_parser(
        "rebalance", help="Rebalance partition placements across servers."
    )
    p.add_argument("--database", default="default")

    p = sub.add_parser("table-import", help="Import json or csv data to a table.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9176)
    p.add_argument("--database", default="default")
    p.add_argument("--table_name", required=True)
    p.add_argument("--format", choices=["json", "csv"], default="json")
    p.add_argument("file")

    args = ap.parse_args(argv)
    out = sys.stdout
    try:
        if args.command == "table-import":
            cmd_table_import(args, out)
            return 0
        cdir = ConfigDirectory(args.config_dir)
        handler = {
            "cluster-create": cmd_cluster_create,
            "cluster-add-server": cmd_cluster_add_server,
            "cluster-remove-server": cmd_cluster_remove_server,
            "cluster-status": cmd_cluster_status,
            "cluster-list": cmd_cluster_list,
            "database-create": cmd_database_create,
            "table-config-set": cmd_table_config_set,
            "table-split": cmd_table_split,
            "table-split-finalize": cmd_table_split_finalize,
            "rebalance": cmd_rebalance,
        }[args.command]
        handler(cdir, args, out)
        return 0
    except (RuntimeError_, SQLError) as e:
        sys.stderr.write(f"ERROR: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
