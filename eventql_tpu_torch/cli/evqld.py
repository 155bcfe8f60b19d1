"""Server binary (reference: evqld.cc).

Starts the HTTP API listener and the native binary-protocol listener
over a shared table service — the equivalent of `evqld --standalone`,
its queries served by the routes on ``--device`` ("cuda" by default;
"cpu" runs the kernels' plain versions). A process that serves as a
cluster worker can shard its tables over a mesh (``--mesh_shards``) for
the partial aggregates a coordinator ships to it. The cluster registry
(--config_dir / --zookeeper_addr) and the services that run over it are
not ported to eventql_tpu_torch yet.
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
    ap.add_argument(
        "--datadir",
        default=None,
        help="persist tables to this directory (no metadata service is"
        " built over it: db/metadata_service.py is not ported yet)",
    )
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
        help="cluster registry (not ported to eventql_tpu_torch yet)",
    )
    ap.add_argument(
        "--zookeeper_addr",
        default=None,
        help="coordination service (not ported to eventql_tpu_torch yet)",
    )
    ap.add_argument(
        "--server_name",
        default=None,
        help="this node's cluster id (not ported to eventql_tpu_torch yet)",
    )
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
        default=None,
        help="auto-split partitions above this many local rows (not ported"
        " to eventql_tpu_torch yet)",
    )
    args = ap.parse_args(argv)

    cluster_flags = [
        f"--{k}"
        for k in ("config_dir", "zookeeper_addr", "server_name",
                  "partition_split_threshold_rows")
        if getattr(args, k) is not None
    ]
    if cluster_flags:
        ap.error(
            f"{', '.join(cluster_flags)}: not ported to eventql_tpu_torch yet:"
            " config/ (the cluster registry) and db/{replication,leader,"
            "metadata_replication,monitor,autosplit}.py"
        )

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

    client_auth = None
    if args.auth_secret:
        from eventql_tpu_torch.server.auth import LegacyClientAuth

        client_auth = LegacyClientAuth(args.auth_secret)

    query_cache = None
    if args.datadir:
        from eventql_tpu_torch.exec.query_cache import QueryCache

        query_cache = QueryCache(os.path.join(args.datadir, "cache"))

    server = EventQLServer(
        table_service=table_service,
        host=host,
        port=port,
        client_auth=client_auth,
        device=args.device,
    )
    # the primary port sniffs the first byte and serves BOTH protocols
    # (reference: server/listener.cc); a native-only port also listens
    server.start(bind=False)
    native = NativeTCPServer(
        server.table_service,
        host=nhost,
        port=nport,
        client_auth=client_auth,
        query_cache=query_cache,
        device=args.device,
        mesh_shards=args.mesh_shards,
    ).start()

    from eventql_tpu_torch.server.listener import Listener

    listener = Listener(server, native, host=host, port=port).start()
    server.port = listener.port

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
