"""Server binary (reference: evqld.cc).

Starts the HTTP API listener and the native binary-protocol listener
over a shared table service — the equivalent of `evqld --standalone`,
its queries served by the routes on ``--device`` ("cuda" by default;
"cpu" runs the kernels' plain versions). A process that serves as a
cluster worker can shard its tables over a mesh (``--mesh_shards``) for
the partial aggregates a coordinator ships to it. With
--config_dir/--server_name (or --zookeeper_addr) the process registers
itself in the cluster registry (config/config_directory.py), routes SQL
through the cluster fan-out provider and runs the cluster's workers
(replication, leader, metadata replication, monitor, autosplit), so
several evqld processes form a cluster (reference: ConfigDirectory +
the sharded execution path).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="evqld", description="eventql_tpu_torch server")
    ap.add_argument("--listen_http", default="127.0.0.1:9175")
    ap.add_argument(
        "--listen_native",
        default=None,
        help="host:port for the binary protocol (default: http port + 1)",
    )
    ap.add_argument("--datadir", default=None, help="persist tables to this directory")
    ap.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the queries' routes run: the card, or the kernels'"
        " plain versions on the CPU",
    )
    ap.add_argument(
        "--mesh_shards",
        type=int,
        default=None,
        help="shard the local tables over a mesh of this many shards on"
        " --device for shipped partial aggregates and pushdowns",
    )
    ap.add_argument(
        "--config_dir",
        default=None,
        help="cluster registry: a file path (standalone backend) or "
        "zk://host:port/cluster (ZooKeeper backend)",
    )
    ap.add_argument(
        "--zookeeper_addr",
        default=None,
        help="host:port[/cluster] of the coordination service "
        "(shorthand for --config_dir zk://...; reference config key "
        "cluster.zookeeper_hosts)",
    )
    ap.add_argument("--server_name", default=None, help="this node's cluster id")
    ap.add_argument(
        "--statsd_addr", default=None, help="push stats to this statsd host:port"
    )
    ap.add_argument(
        "--auth_secret",
        default=None,
        help="require HMAC auth tokens signed with this secret",
    )
    ap.add_argument(
        "--partition_split_threshold_rows",
        type=int,
        default=2_000_000,  # reference: db/partition_writer.cc:64-65
        help="auto-split partitions above this many local rows",
    )
    args = ap.parse_args(argv)

    if args.zookeeper_addr and not args.config_dir:
        zk = args.zookeeper_addr
        if "/" not in zk:
            zk += "/default"
        args.config_dir = f"zk://{zk}"

    host, _, port = args.listen_http.partition(":")
    host = host or "127.0.0.1"
    port = int(port or 9175)
    if args.listen_native:
        nhost, _, nport = args.listen_native.partition(":")
        nhost, nport = nhost or host, int(nport)
    else:
        nhost, nport = host, port + 1

    from eventql_tpu_torch.server.http_api import EventQLServer
    from eventql_tpu_torch.server.native_tcp import NativeTCPServer

    table_service = None
    if args.datadir:
        from eventql_tpu_torch.db.lsm import DurableTableService

        table_service = DurableTableService(args.datadir)
        table_service.start_compaction_worker()

    statsd_agent = None
    if args.statsd_addr:
        from eventql_tpu_torch.utils.stats import StatsdAgent, evqld_stats

        evqld_stats()  # register the server counter set
        shost, _, sport = args.statsd_addr.partition(":")
        statsd_agent = StatsdAgent(
            (shost or "127.0.0.1", int(sport or 8125))
        ).start()

    query_provider_factory = None
    cdir = None
    if args.config_dir:
        from eventql_tpu_torch.parallel.cluster import cluster_provider_from_config

        query_provider_factory = lambda: cluster_provider_from_config(
            args.config_dir
        )

    client_auth = None
    if args.auth_secret:
        from eventql_tpu_torch.server.auth import LegacyClientAuth

        client_auth = LegacyClientAuth(args.auth_secret)

    # metadata service: every cluster node can host METADATA file chains
    # (reference: db/database.cc:283-315 wires Metadata{Store,Service})
    metadata_service = None
    if args.datadir or (args.config_dir and args.server_name):
        import tempfile

        from eventql_tpu_torch.db.metadata_service import (
            MetadataService,
            MetadataStore,
        )

        meta_dir = args.datadir or tempfile.mkdtemp(prefix="evql_meta_")
        metadata_service = MetadataService(MetadataStore(meta_dir))

    mr_cachedir = None
    query_cache = None
    if args.datadir:
        mr_cachedir = os.path.join(args.datadir, "cache")
        from eventql_tpu_torch.exec.query_cache import QueryCache

        query_cache = QueryCache(mr_cachedir)

    server = EventQLServer(
        table_service=table_service,
        host=host,
        port=port,
        query_provider_factory=query_provider_factory,
        client_auth=client_auth,
        mr_cachedir=mr_cachedir,
        device=args.device,
    )
    # the primary port sniffs the first byte and serves BOTH protocols
    # (reference: server/listener.cc); a native-only port also listens
    server.start(bind=False)
    native = NativeTCPServer(
        server.table_service,
        host=nhost,
        port=nport,
        query_provider_factory=query_provider_factory,
        client_auth=client_auth,
        metadata_service=metadata_service,
        query_cache=query_cache,
        device=args.device,
        mesh_shards=args.mesh_shards,
    ).start()

    from eventql_tpu_torch.server.listener import Listener

    listener = Listener(server, native, host=host, port=port).start()
    server.port = listener.port

    repl_worker = None
    monitor = None
    leader = None
    autosplit = None
    meta_repl = None
    if args.config_dir and args.server_name:
        from eventql_tpu_torch.config.config_directory import (
            SERVER_UP,
            ConfigDirectory,
            ServerConfig,
        )

        cdir = ConfigDirectory(args.config_dir)
        cdir.update_server_config(
            ServerConfig(
                server_id=args.server_name,
                server_addr=f"{host}:{listener.port}",
                server_status=SERVER_UP,
            )
        )

        from eventql_tpu_torch.db.replication import ReplicationWorker

        repl_worker = ReplicationWorker(
            server.table_service, args.config_dir, args.server_name
        ).start()

        from eventql_tpu_torch.db.leader import Leader

        leader = Leader(args.config_dir, args.server_name).start()

        if metadata_service is not None:
            from eventql_tpu_torch.db.metadata_replication import MetadataReplication

            meta_repl = MetadataReplication(
                metadata_service, args.config_dir, args.server_name
            ).start()

        from eventql_tpu_torch.db.monitor import Monitor

        monitor = Monitor(
            server.table_service,
            args.config_dir,
            args.server_name,
            f"{host}:{listener.port}",
            datadir=args.datadir,
        ).start()

        from eventql_tpu_torch.db.autosplit import AutoSplitWorker

        autosplit = AutoSplitWorker(
            server.table_service,
            args.config_dir,
            leader=leader,
            threshold_rows=args.partition_split_threshold_rows,
        ).start()

    print(
        f"eventql_tpu_torch server listening on http://{host}:{server.port}"
        f" native://{nhost}:{native.port}",
        flush=True,
    )

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    if cdir is not None:
        from eventql_tpu_torch.config.config_directory import SERVER_DOWN, ServerConfig

        cdir.update_server_config(
            ServerConfig(
                server_id=args.server_name,
                server_addr=f"{host}:{listener.port}",
                server_status=SERVER_DOWN,
            )
        )
    if autosplit is not None:
        autosplit.stop()
    if meta_repl is not None:
        meta_repl.stop()
    if leader is not None:
        leader.stop()
    if monitor is not None:
        monitor.stop()
    if repl_worker is not None:
        repl_worker.stop()
    if statsd_agent is not None:
        statsd_agent.stop()
    if args.datadir:
        table_service.stop_compaction_worker()
        server.table_service.commit_all()
    listener.stop()
    native.stop()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
